"""Ensemble CV sweep over the C(18,3)=816 combinations — mirrors
`train_ensemble_cv.py` (reference), the port's counterpart of
`vit3d_ensemble_tpu/cli/train_ensemble_cv.py`.

    python -m vit3d_ensemble_tpu_torch.cli.train_ensemble_cv \
        --no-padded_compile --ensemble_conf_list 5,9,11 \
        --csv_path .../csv_files/cross_validation --data_root .../dataset \
        --output_dir <the baselines' output_dir>

The port runs the reference-faithful end-to-end mode sequentially
(`--no-padded_compile`): per combination, the members start from the
baselines `baseline_models/conf{c}/conf{c}.bin` and the full ensemble
(backbones fine-tuned, `train_ensemble_cv.py:82-83`) trains on each fold,
its best state written to `cv_ensemble_models/ensemble_{name}/cv{k}.bin`.
A resume marker a combination, in the JAX name and format, lets `--resume`
skip completed combinations.

Not ported yet, and raising NotImplementedError rather than running another
mode: the padded (combination, fold) grid of `--padded_compile`, the JAX
driver's default (ROADMAP.md, queue 1, "sweep/e2e_grid.py"; pass
`--no-padded_compile`), and `--frozen` (ROADMAP.md, queue 1,
"sweep/ensemble_sweep.py").  The grid-only flags (`--save_ensembles`,
`--e2e_chunk`, `--backfill_test`, `--state_mirror`) change nothing in the
sequential mode, as in the JAX driver; a warning says so.

Output: workbook + CSV with 'mean (std)' cells per metric over folds
(`train_ensemble_cv.py:36-49,221-230`), named 'Ensemble_CV' unless
overridden with --workbook.  Runs on the CUDA device unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from itertools import combinations as it_combinations
from typing import Dict

from vit3d_ensemble_tpu_torch.checkpoint import ensemble_ckpt_path
from vit3d_ensemble_tpu_torch.cli._common import (
    add_common_flags,
    apply_runtime_flags,
    parse_conf_list,
    setup_logging,
)
# (config, state_dict) of a baseline: its .bin under --output_dir, or a
# fresh init under --random_init_members
from vit3d_ensemble_tpu_torch.cli.train_ensemble_whole_dataset import (
    load_member as _load_member,
)
from vit3d_ensemble_tpu_torch.data import build_train_val
from vit3d_ensemble_tpu_torch.reporting import write_sweep_report
from vit3d_ensemble_tpu_torch.train.ensemble_trainer import train_ensemble

logger = logging.getLogger("train_ensemble_cv")

#: Flags of the grid mode, with the defaults under which they do nothing.
GRID_FLAGS = {"save_ensembles": False, "e2e_chunk": 0, "backfill_test": True,
              "state_mirror": None}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser, csv_subdir="cross_validation")
    parser.add_argument("--num_epochs", type=int, default=100,
                        help="Training epochs per combination.")
    parser.add_argument("--num_cv", type=int, default=5,
                        help="Number of folds in cross validation.")
    parser.add_argument("--conf", type=int, default=5,
                        help="(kept for reference CLI parity)")
    parser.add_argument("--max_configs", type=int, default=19,
                        help="Max baseline configuration number + 1.")
    parser.add_argument("--combinations", type=int, default=3,
                        help="Baselines per ensemble.")
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--frozen", action="store_true",
                        help="Screening mode on cached member logits: not "
                             "ported yet (ROADMAP.md, queue 1, "
                             "'sweep/ensemble_sweep.py'); raises.")
    parser.add_argument("--end_to_end", action="store_true",
                        help="(default) reference-faithful mode: fine-tune "
                             "backbones per combination "
                             "(train_ensemble_cv.py:82-83).  Kept as an "
                             "explicit flag for compatibility.")
    parser.add_argument("--padded_compile",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="(end-to-end) the padded (combination, fold) "
                             "grid: not ported yet (ROADMAP.md, queue 1, "
                             "'sweep/e2e_grid.py'); raises.  "
                             "--no-padded_compile runs the sequential "
                             "per-combination mode (always writes "
                             "per-ensemble checkpoints).")
    parser.add_argument("--save_ensembles",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="(grid mode) write every (combination, fold) "
                             "best-ensemble checkpoint.  The sequential "
                             "mode always saves.")
    parser.add_argument("--e2e_chunk", type=int, default=0,
                        help="(grid mode) combinations per chunk; 0 sizes "
                             "chunks from the device-memory budget.")
    parser.add_argument("--backfill_test",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="(grid mode, --resume) re-queue combinations "
                             "whose resume markers predate held-out-test "
                             "evaluation.")
    parser.add_argument("--state_mirror", default=None, metavar="PATH",
                        help="(grid mode) durable JSONL mirror of the "
                             "resume markers (sweep/state_mirror.py).")
    parser.add_argument("--ensemble_conf_list", default=None,
                        help="Train ONLY this combination (e.g. 5,9,11) "
                             "instead of the full C(max_configs-1, k) grid "
                             "— the whole-dataset driver's flag "
                             "(train_ensemble_whole_dataset.py:191-200) "
                             "honored here for single-combination CV "
                             "retrains.")
    parser.add_argument("--random_init_members", action="store_true",
                        help="Use fresh inits for missing baseline ckpts.")
    parser.add_argument("--workbook", default="Ensemble_CV",
                        help="Report file base name.")
    parser.add_argument("--output_path", default=None,
                        help="Alias of --output_dir.")
    return parser


def _selected_combos(args, default_combos):
    """--ensemble_conf_list restricts any sweep mode to one combination."""
    if getattr(args, "ensemble_conf_list", None):
        return [tuple(parse_conf_list(args.ensemble_conf_list))]
    return default_combos


def _e2e_fingerprint(args, mode_tag: str) -> str:
    return (f"{args.num_cv}cv_{args.num_epochs}ep_"
            f"{args.train_batch_size}b_{args.learning_rate}lr_"
            f"{args.seed}s{mode_tag}")


def sequential_mode(args, driver: str) -> None:
    """Raise on the modes the port has not ported (the grid of
    --padded_compile), naming the ROADMAP.md item and the flag that runs
    the sequential mode; warn about grid-only flags, which the sequential
    mode ignores as the JAX driver's does."""
    given = [f"--{name}" for name, idle in GRID_FLAGS.items()
             if getattr(args, name, idle) != idle]
    if getattr(args, "padded_compile", False):
        raise NotImplementedError(
            f"{driver}: the padded (combination, fold) grid of "
            "--padded_compile, the default, is not ported yet (ROADMAP.md, "
            "queue 1, 'sweep/e2e_grid.py'"
            + (f"; so are {', '.join(given)}" if given else "")
            + "); pass --no-padded_compile for the sequential end-to-end "
            "mode")
    if given:
        logger.warning("%s apply to the grid mode only; the sequential mode "
                       "ignores them and always writes its checkpoints",
                       ", ".join(given))


def refuse_frozen(driver: str) -> None:
    raise NotImplementedError(
        f"{driver}: --frozen (the meta-head screening on cached member "
        "logits) is not ported yet (ROADMAP.md, queue 1, "
        "'sweep/ensemble_sweep.py'); pass --no-padded_compile for the "
        "sequential end-to-end mode")


def run_end_to_end(args) -> Dict[str, Dict[str, Dict[str, float]]]:
    """The reference-faithful mode, sequential (`--no-padded_compile`): per
    combination and fold an exact-shape ensemble trained end to end, with
    per-combination resume markers (`train_ensemble_cv.py:390-448`)."""
    sequential_mode(args, "train_ensemble_cv")
    state_dir = os.path.join(args.output_dir, "sweep_state")
    os.makedirs(state_dir, exist_ok=True)
    fingerprint = _e2e_fingerprint(args, "")

    results: Dict[str, Dict[str, Dict[str, float]]] = {}
    combos = _selected_combos(
        args, it_combinations(range(1, args.max_configs), args.combinations))
    folds = None
    for comb in combos:
        name = "_".join(str(c) for c in comb)
        marker = os.path.join(state_dir, f"e2e_{name}_{fingerprint}.json")
        if getattr(args, "resume", False) and os.path.exists(marker):
            with open(marker) as f:
                results[name] = json.load(f)
            logger.info("resume: skipping completed ensemble %s", name)
            continue
        if folds is None:       # load the fold data once, lazily
            folds = [build_train_val(
                os.path.join(args.csv_path, f"training_cv{cv + 1}.csv"),
                os.path.join(args.csv_path, f"validation_cv{cv + 1}.csv"),
                args.data_root, aug_mode="none", size=args.img_size)
                for cv in range(args.num_cv)]
        loaded = [_load_member(args, c) for c in comb]
        configs = [cfg for cfg, _ in loaded]
        members = [state for _, state in loaded]
        results[name] = {}
        for cv, (t, v, _) in enumerate(folds):
            save = ensemble_ckpt_path(args.output_dir, "cv_ensemble", name,
                                      f"cv{cv + 1}")
            res = train_ensemble(configs, members, t, v,
                                 num_epochs=args.num_epochs,
                                 train_batch_size=args.train_batch_size,
                                 learning_rate=args.learning_rate,
                                 seed=args.seed, save_path=save,
                                 keep_best_params=False, device=args.device)
            results[name][f"CV {cv + 1}"] = dict(res.metrics)
            logger.info("ensemble %s cv%d AUROC %.4f", name, cv + 1,
                        res.metrics["AUROC"])
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results[name], f)
        os.replace(tmp, marker)
    return results


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    apply_runtime_flags(args)
    if args.output_path:
        args.output_dir = args.output_path
    if args.frozen and args.end_to_end:
        raise SystemExit("--frozen and --end_to_end are mutually exclusive")
    if args.frozen:
        refuse_frozen("train_ensemble_cv")
    results = run_end_to_end(args)
    report = os.path.join(args.output_dir, args.workbook)
    write_sweep_report(report, results)
    logger.info("report written to %s.xlsx / .csv", report)
    return results


def cli() -> int:
    """Console-script entry: main returns the result dict for programmatic
    use; setuptools wraps the entry point in sys.exit(), so return 0."""
    main()
    return 0


if __name__ == "__main__":
    main()

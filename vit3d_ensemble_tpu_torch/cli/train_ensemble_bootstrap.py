"""Bootstrap ensemble sweep — mirrors `train_ensemble_bootstrap.py`, the
port's counterpart of `vit3d_ensemble_tpu/cli/train_ensemble_bootstrap.py`.

    python -m vit3d_ensemble_tpu_torch.cli.train_ensemble_bootstrap \
        --no-padded_compile --max_configs 19 --num_rep 5 \
        --csv_path .../csv_files/fixed_split --data_root .../dataset \
        --output_dir <the baselines' output_dir>

Reference flow (`train_ensemble_bootstrap.py:69-265`): for each of the
C(max_configs - 1, k) combinations x num_rep bootstrap replicates —
resample training.csv with seed=rep, train the ensemble end to end
(selection on the fixed validation split), then evaluate the best state on
the held-out test split; report mean (std) validation metrics and the
test metrics to two workbooks (`Ensemble_Bootstrap`, `..._test`), and
write `bootstrap_ensemble_models/ensemble_{name}/bootstrap_{rep}.bin`.

The port runs this sequentially (`--no-padded_compile`).  The padded grid
(`--padded_compile`, the JAX driver's default; ROADMAP.md, queue 1,
"sweep/e2e_grid.py") and `--frozen` (ROADMAP.md, queue 1,
"sweep/ensemble_sweep.py") raise NotImplementedError.

NOTE: the reference's --csv_path default points at the cross_validation
folder which lacks training.csv (the script cannot run as shipped); this
driver defaults to fixed_split, where training/validation/test.csv exist.
Runs on the CUDA device unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from itertools import combinations as it_combinations

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.checkpoint import ensemble_ckpt_path
from vit3d_ensemble_tpu_torch.cli._common import (
    add_common_flags,
    apply_runtime_flags,
    setup_logging,
)
from vit3d_ensemble_tpu_torch.cli.train_ensemble_cv import (
    _load_member,
    refuse_frozen,
    sequential_mode,
)
from vit3d_ensemble_tpu_torch.data import bootstrap_resample, build_train_val, load_split
from vit3d_ensemble_tpu_torch.metrics.host import eleven_metrics
from vit3d_ensemble_tpu_torch.models import TransformerEnsemble
from vit3d_ensemble_tpu_torch.models.vit3d import resolve_device
from vit3d_ensemble_tpu_torch.reporting import write_sweep_report
from vit3d_ensemble_tpu_torch.train.ensemble_trainer import train_ensemble
from vit3d_ensemble_tpu_torch.train.steps import ensemble_eval_step

logger = logging.getLogger("train_ensemble_bootstrap")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser, csv_subdir="fixed_split")
    parser.add_argument("--num_rep", type=int, default=5,
                        help="Number of bootstrap repetitions.")
    parser.add_argument("--num_epochs", type=int, default=100)
    parser.add_argument("--max_configs", type=int, default=19)
    parser.add_argument("--combinations", type=int, default=3)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--frozen", action="store_true",
                        help="Screening mode on cached member logits: not "
                             "ported yet (ROADMAP.md, queue 1, "
                             "'sweep/ensemble_sweep.py'); raises.")
    parser.add_argument("--end_to_end", action="store_true",
                        help="(default) reference-faithful mode.")
    parser.add_argument("--padded_compile",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="(end-to-end) the padded (combination, "
                             "replicate) grid: not ported yet (ROADMAP.md, "
                             "queue 1, 'sweep/e2e_grid.py'); raises.  "
                             "--no-padded_compile runs the sequential loop "
                             "(always saves checkpoints).")
    parser.add_argument("--save_ensembles",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="(grid mode) write every (combination, "
                             "replicate) best-ensemble checkpoint.  The "
                             "sequential mode always saves.")
    parser.add_argument("--e2e_chunk", type=int, default=0,
                        help="(grid mode) combinations per chunk; 0 sizes "
                             "chunks from the device-memory budget.")
    parser.add_argument("--state_mirror", default=None, metavar="PATH",
                        help="(grid mode) durable JSONL mirror of the "
                             "resume markers (sweep/state_mirror.py).")
    parser.add_argument("--random_init_members", action="store_true")
    parser.add_argument("--workbook", default="Ensemble_Bootstrap")
    parser.add_argument("--output_path", default=None)
    return parser


def _splits_for_rep(args, rep: int):
    """Bootstrapped train + fixed val + fixed test, all normalized with the
    replicate's train mean (`train_ensemble_bootstrap.py:96-105`)."""
    train_df = bootstrap_resample(
        os.path.join(args.csv_path, "training.csv"), rep)
    train, val, mean = build_train_val(
        train_df, os.path.join(args.csv_path, "validation.csv"),
        args.data_root, aug_mode="none", size=args.img_size)
    test = load_split(os.path.join(args.csv_path, "test.csv"),
                      args.data_root, size=args.img_size)
    test = dataclasses.replace(test, volumes=test.volumes - np.float32(mean))
    return train, val, test


def _test_metrics(configs, best_params, test, device):
    """The 11 metrics of the best state on the held-out test split (the
    testing_model flow, `train_ensemble_bootstrap.py:224-254`)."""
    device = resolve_device(device)
    model = TransformerEnsemble(tuple(configs), device=device)
    model.load_state_dict(best_params)
    probs = ensemble_eval_step(
        model, torch.from_numpy(test.volumes).to(device)).cpu().numpy()
    return eleven_metrics(test.labels, (probs > 0.5).astype(np.int32), probs)


def run_end_to_end(args):
    """The reference-faithful mode, sequential (`--no-padded_compile`,
    `train_ensemble_bootstrap.py:298-341`)."""
    sequential_mode(args, "train_ensemble_bootstrap")
    val_results, test_results = {}, {}
    for comb in it_combinations(range(1, args.max_configs), args.combinations):
        name = "_".join(str(c) for c in comb)
        loaded = [_load_member(args, c) for c in comb]
        configs = [cfg for cfg, _ in loaded]
        members = [state for _, state in loaded]
        val_results[name], test_results[name] = {}, {}
        for rep in range(args.num_rep):
            train, val, test = _splits_for_rep(args, rep)
            save = ensemble_ckpt_path(args.output_dir, "bootstrap_ensemble",
                                      name, f"bootstrap_{rep}")
            res = train_ensemble(configs, members, train, val,
                                 num_epochs=args.num_epochs,
                                 train_batch_size=args.train_batch_size,
                                 learning_rate=args.learning_rate,
                                 seed=args.seed, save_path=save,
                                 keep_best_params=True, device=args.device)
            val_results[name][f"boot{rep}"] = dict(res.metrics)
            test_results[name][f"boot{rep}"] = _test_metrics(
                configs, res.best_params, test, args.device)
    return val_results, test_results


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    apply_runtime_flags(args)
    if args.output_path:
        args.output_dir = args.output_path
    if args.frozen and args.end_to_end:
        raise SystemExit("--frozen and --end_to_end are mutually exclusive")
    if args.frozen:
        refuse_frozen("train_ensemble_bootstrap")
    val_results, test_results = run_end_to_end(args)
    base = os.path.join(args.output_dir, args.workbook)
    write_sweep_report(base, val_results)
    write_sweep_report(base + "_test", test_results)
    logger.info("reports written to %s{,_test}.xlsx / .csv", base)
    return val_results, test_results


def cli() -> int:
    """Console-script entry: main returns the result dicts for programmatic
    use; setuptools wraps the entry point in sys.exit(), so return 0."""
    main()
    return 0


if __name__ == "__main__":
    main()

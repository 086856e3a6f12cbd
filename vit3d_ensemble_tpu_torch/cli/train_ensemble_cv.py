"""Ensemble CV sweep over the C(18,3)=816 combinations — mirrors
`train_ensemble_cv.py` (reference), the port's counterpart of
`vit3d_ensemble_tpu/cli/train_ensemble_cv.py`.

    python -m vit3d_ensemble_tpu_torch.cli.train_ensemble_cv \
        --csv_path .../csv_files/cross_validation --data_root .../dataset \
        --output_dir <the baselines' output_dir>

Members start from the baselines `baseline_models/conf{c}/conf{c}.bin`
under --output_dir.  Three modes:
  * default, the padded (combination, fold) grid (`--padded_compile`,
    `sweep/e2e_grid.py`): the reference-faithful end-to-end training
    (backbones fine-tuned, `train_ensemble_cv.py:82-83`) of every
    combination on every fold at once, in chunks (`--e2e_chunk`; 0 sizes
    them from the device's memory).  Each combination is also evaluated on
    the shared held-out `test.csv` (normalised with each fold's training
    mean).  Resume markers `e2e_{name}_{fingerprint}.json` with
    {"combo", "fingerprint", "val", "test"}; `--backfill_test` re-queues
    legacy val-only markers; `--state_mirror` keeps them in a JSONL mirror
    (`sweep/state_mirror.py`); `--save_ensembles` writes
    `cv_ensemble_models/ensemble_{name}/cv{k}.bin`.
  * `--no-padded_compile`: the same training, one exact-shape ensemble per
    (combination, fold) in turn, always writing its checkpoints.
  * `--frozen`: the meta-head screening on cached member logits
    (`sweep/ensemble_sweep.py`), writing each combination's heads to
    `cv_ensemble_models/ensemble_{name}/meta_heads.bin` (tensors `combo`
    and `meta_wb`, (F, 4) [w1 w2 w3 b]), which `test_cv` reads.  Its
    combination rankings do not track the end-to-end mode's (the JAX
    package's measurement, `docs/RESULTS.md`): use it for screening.

`--mesh MxN` shards the grid's and the frozen sweep's (combination, fold)
work over M·N ranks (`parallel/mesh.py`; under torchrun, e.g.
`torchrun --standalone --nproc_per_node=2 -m
vit3d_ensemble_tpu_torch.cli.train_ensemble_cv --frozen --mesh 1x2 ...`):
every rank returns the results, rank 0 alone writes.

Output: workbook + CSV with 'mean (std)' cells per metric over folds
(`train_ensemble_cv.py:36-49,221-230`), named 'Ensemble_CV' unless
overridden with --workbook, and the grid's held-out test report
('Ensemble_CV_test').  Runs on the CUDA device unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from itertools import combinations as it_combinations
from typing import Dict

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.checkpoint import ensemble_ckpt_path, save_state_dict
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
from vit3d_ensemble_tpu_torch.data import build_train_val, load_split
from vit3d_ensemble_tpu_torch.metrics import METRIC_KEYS, eleven_metrics
from vit3d_ensemble_tpu_torch.parallel.mesh import barrier, is_writer, mesh_from_spec
from vit3d_ensemble_tpu_torch.reporting import write_sweep_report
from vit3d_ensemble_tpu_torch.sweep import state_mirror
from vit3d_ensemble_tpu_torch.sweep.e2e_grid import run_e2e_grid, stack_e2e_folds
from vit3d_ensemble_tpu_torch.sweep.ensemble_sweep import (
    MetaHyper,
    all_combinations,
    compute_member_logits,
    train_meta_sweep,
)
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
                        help="Fast screening mode: train only meta-heads "
                             "on cached member logits (all 816 combos at "
                             "once).  Its combination rankings do not track "
                             "the end-to-end mode's (docs/RESULTS.md).")
    parser.add_argument("--end_to_end", action="store_true",
                        help="(default) reference-faithful mode: fine-tune "
                             "backbones per combination "
                             "(train_ensemble_cv.py:82-83).  Kept as an "
                             "explicit flag for compatibility.")
    parser.add_argument("--padded_compile",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="(end-to-end) pad members to shape-class "
                             "templates with runtime masks and train the "
                             "whole (combination, fold) grid in chunks "
                             "(sweep/e2e_grid.py); exact math, different "
                             "dropout stream.  --no-padded_compile runs the "
                             "sequential per-combination mode (always "
                             "writes per-ensemble checkpoints).")
    parser.add_argument("--save_ensembles",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="(grid mode) write every (combination, fold) "
                             "best-ensemble checkpoint, as the reference "
                             "does; for the full 816x5 sweep that is 4080 "
                             "files, so the default keeps metrics and "
                             "reports only.  The sequential mode always "
                             "saves.")
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
    """Warn about grid-only flags, which the sequential mode
    (`--no-padded_compile`) ignores as the JAX driver's does."""
    given = [f"--{name}" for name, idle in GRID_FLAGS.items()
             if getattr(args, name, idle) != idle]
    if given:
        logger.warning("%s: %s apply to the grid mode only; the sequential "
                       "mode ignores them and always writes its checkpoints",
                       driver, ", ".join(given))


def load_fold_splits(args):
    """Every fold's (train, val, train mean), without augmentation."""
    return [build_train_val(
        os.path.join(args.csv_path, f"training_cv{cv + 1}.csv"),
        os.path.join(args.csv_path, f"validation_cv{cv + 1}.csv"),
        args.data_root, aug_mode="none", size=args.img_size)
        for cv in range(args.num_cv)]


def stack_member_logits(per_split, confs):
    """(S, 18, n_max) logits, (S, n_max) labels and masks from each split's
    ({conf: logits}, labels), padded to the longest split."""
    S, n_max = len(per_split), max(len(y) for _, y in per_split)
    logits = np.zeros((S, len(confs), n_max), np.float32)
    labels = np.zeros((S, n_max), np.float32)
    mask = np.zeros((S, n_max), np.float32)
    for s, (by_conf, y) in enumerate(per_split):
        n = len(y)
        for i, c in enumerate(confs):
            logits[s, i, :n] = by_conf[c]
        labels[s, :n], mask[s, :n] = y, 1.0
    return logits, labels, mask


def frozen_members(args):
    """The 18 baselines' state_dicts and the meta sweep's hyperparameters."""
    confs = list(range(1, args.max_configs))
    members = {c: _load_member(args, c)[1] for c in confs}
    hyper = MetaHyper(num_epochs=args.num_epochs,
                      train_batch_size=args.train_batch_size,
                      learning_rate=args.learning_rate, seed=args.seed)
    return confs, members, hyper


def save_meta_heads(args, kind: str, name: str, comb, meta_wb) -> None:
    save_state_dict(ensemble_ckpt_path(args.output_dir, kind, name, "meta_heads"),
                    {"combo": torch.as_tensor(np.asarray(comb)),
                     "meta_wb": torch.as_tensor(meta_wb)})


def run_frozen(args) -> Dict[str, Dict[str, Dict[str, float]]]:
    """The meta-head screening (`vit3d_ensemble_tpu/cli/train_ensemble_cv.py:164-235`):
    the 18 baselines' logits over each fold's splits, then every
    (combination, fold) head trained at once; each combination's best
    heads go to `meta_heads.bin`, which `test_cv` reads."""
    confs, members, hyper = frozen_members(args)
    train, val = [], []
    for t, v, _ in load_fold_splits(args):
        train.append((compute_member_logits(members, t.volumes, args.img_size,
                                            device=args.device), t.labels))
        val.append((compute_member_logits(members, v.volumes, args.img_size,
                                          device=args.device), v.labels))
    TL, TY, TM = stack_member_logits(train, confs)
    VL, VY, VM = stack_member_logits(val, confs)
    combos = np.asarray(_selected_combos(
        args, all_combinations(args.max_configs, args.combinations)))
    mesh = mesh_from_spec(getattr(args, "mesh", None), args.device)
    logger.info("frozen-backbone sweep: %d combos x %d folds%s", len(combos),
                args.num_cv, "" if mesh is None else f" on mesh {mesh.shape}")
    metrics, meta = train_meta_sweep(combos, TL, TY, TM, VL, VY, VM,
                                     {c: i for i, c in enumerate(confs)}, hyper,
                                     mesh=mesh, device=args.device)
    results: Dict[str, Dict[str, Dict[str, float]]] = {}
    for ci, comb in enumerate(combos):
        name = "_".join(str(c) for c in comb)
        results[name] = {f"CV {f + 1}": {k: float(x) for k, x in
                                         zip(METRIC_KEYS, metrics[ci, f])}
                         for f in range(args.num_cv)}
        save_meta_heads(args, "cv_ensemble", name, comb, meta[ci])
    return results


def start_mirror(args, state_dir: str):
    """--state_mirror's two-way start-up sync: restore the markers a reset
    destroyed (under --resume), then fold the directory's markers into the
    mirror (rank 0; the others wait for it).  Returns the mirror's path, or
    None."""
    mirror = getattr(args, "state_mirror", None)
    if mirror:
        if is_writer():
            if getattr(args, "resume", False):
                state_mirror.restore(mirror, state_dir)
            state_mirror.snapshot(state_dir, mirror)
        barrier()
    return mirror


def write_marker(path: str, marker: dict, mirror) -> None:
    """A resume marker, written atomically, and appended to the mirror (in a
    process group, by rank 0 alone)."""
    if not is_writer():
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(marker, fh)
    os.replace(tmp, path)
    if mirror:
        state_mirror.append(mirror, os.path.basename(path), marker)


def held_out_metrics(labels, probs) -> Dict[str, float]:
    probs = np.asarray(probs)
    return {k: float(v) for k, v in eleven_metrics(
        labels, (probs > 0.5).astype(np.int32), probs).items()}


def run_end_to_end_grid(args):
    """The reference-faithful results, the whole (combination, fold) grid
    in chunks (`sweep/e2e_grid.py`; JAX `cli/train_ensemble_cv.py:244-388`).

    Each combination is also evaluated on the shared held-out test split,
    normalised per fold with that fold's training mean (`test_cv.py:46-52`):
    its probabilities under the best state come with the grid's results.
    Per-combination resume markers hold val and test metrics ({"combo",
    "fingerprint", "val", "test"}); legacy val-only markers are re-queued
    after the fresh combinations under --backfill_test.  Checkpoints are
    written only with --save_ensembles.  Returns (val, test) results."""
    state_dir = os.path.join(args.output_dir, "sweep_state")
    os.makedirs(state_dir, exist_ok=True)
    # "_grid": grid dropout streams differ from the sequential mode's, so
    # their markers must not mix
    fingerprint = _e2e_fingerprint(args, "_grid")
    mirror = start_mirror(args, state_dir)

    def marker_path(name: str) -> str:
        return os.path.join(state_dir, f"e2e_{name}_{fingerprint}.json")

    results: Dict[str, Dict[str, Dict[str, float]]] = {}
    test_results: Dict[str, Dict[str, Dict[str, float]]] = {}
    test_csv = os.path.join(args.csv_path, "test.csv")
    have_test_csv = os.path.exists(test_csv)
    todo, backfill = [], []
    for comb in _selected_combos(
            args, it_combinations(range(1, args.max_configs), args.combinations)):
        name = "_".join(str(c) for c in comb)
        if getattr(args, "resume", False) and os.path.exists(marker_path(name)):
            with open(marker_path(name)) as f:
                saved = json.load(f)
            if "val" in saved:
                results[name] = saved["val"]
                test_results[name] = saved.get("test", {})
                logger.info("resume: skipping completed ensemble %s", name)
            elif have_test_csv and getattr(args, "backfill_test", True):
                # a legacy val-only marker: keep its val metrics, re-queue it
                # after the fresh combinations to derive its test metrics
                results[name] = saved
                backfill.append(comb)
            else:
                results[name] = saved
                logger.info("resume: ensemble %s kept without test metrics "
                            "(legacy marker; --backfill_test to re-derive)", name)
        else:
            todo.append(comb)
    if backfill:
        logger.info("%d legacy markers queued for test-metric backfill after "
                    "%d fresh combinations", len(backfill), len(todo))
    todo += backfill
    if not todo:
        return results, test_results

    test_raw = None
    if have_test_csv:
        test_raw = load_split(test_csv, args.data_root, size=args.img_size)
    else:
        logger.warning("no %s — skipping held-out test evaluation", test_csv)
    fold_entries = [
        (t, v, dataclasses.replace(test_raw, volumes=test_raw.volumes - np.float32(mean))
         if test_raw is not None else None)
        for t, v, mean in load_fold_splits(args)]
    data = stack_e2e_folds(fold_entries, args.num_epochs, args.train_batch_size,
                           args.seed)
    save = getattr(args, "save_ensembles", False)

    def on_result(plan, res, extras):
        if extras["params"] is not None:        # under --save_ensembles, on rank 0
            for f, params in enumerate(extras["params"]):
                save_state_dict(ensemble_ckpt_path(
                    args.output_dir, "cv_ensemble", plan.name, f"cv{f + 1}"), params)
        marker = {"combo": list(plan.confs), "fingerprint": fingerprint, "val": res}
        if test_raw is not None:
            test_results[plan.name] = {
                f"CV {f + 1}": held_out_metrics(test_raw.labels, probs)
                for f, probs in enumerate(extras["test_probs"])}
            marker["test"] = test_results[plan.name]
        write_marker(marker_path(plan.name), marker, mirror)

    results.update(run_e2e_grid(
        todo, lambda c: _load_member(args, c), data,
        num_epochs=args.num_epochs, learning_rate=args.learning_rate,
        seed=args.seed, mesh=mesh_from_spec(getattr(args, "mesh", None), args.device),
        chunk=getattr(args, "e2e_chunk", 0), keep_payload=save,
        on_result=on_result, device=args.device))
    return results, test_results


def run_end_to_end(args):
    """The reference-faithful mode.  With --padded_compile (the default)
    the whole grid trains at once (`run_end_to_end_grid`, which returns
    (val, test) results); --no-padded_compile keeps the sequential
    per-combination exact-shape loop below, with per-combination resume
    markers (`train_ensemble_cv.py:390-448`)."""
    if getattr(args, "padded_compile", False):
        return run_end_to_end_grid(args)
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
            folds = load_fold_splits(args)
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
        if is_writer():
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
    results = run_frozen(args) if args.frozen else run_end_to_end(args)
    test_results = None
    if isinstance(results, tuple):      # grid mode: (val, held-out test)
        results, test_results = results
    report = os.path.join(args.output_dir, args.workbook)
    write_sweep_report(report, results)
    logger.info("report written to %s.xlsx / .csv", report)
    test_results = {k: v for k, v in (test_results or {}).items() if v}
    if test_results:
        write_sweep_report(report + "_test", test_results)
        logger.info("held-out test report written to %s_test.xlsx / .csv "
                    "(%d combinations)", report, len(test_results))
    barrier()
    return results


def cli() -> int:
    """Console-script entry: main returns the result dict for programmatic
    use; setuptools wraps the entry point in sys.exit(), so return 0."""
    main()
    return 0


if __name__ == "__main__":
    main()

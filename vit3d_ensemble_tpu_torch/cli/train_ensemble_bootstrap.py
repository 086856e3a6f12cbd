"""Bootstrap ensemble sweep — mirrors `train_ensemble_bootstrap.py`, the
port's counterpart of `vit3d_ensemble_tpu/cli/train_ensemble_bootstrap.py`.

    python -m vit3d_ensemble_tpu_torch.cli.train_ensemble_bootstrap \
        --max_configs 19 --num_rep 5 \
        --csv_path .../csv_files/fixed_split --data_root .../dataset \
        --output_dir <the baselines' output_dir>

Reference flow (`train_ensemble_bootstrap.py:69-265`): for each of the
C(max_configs - 1, k) combinations x num_rep bootstrap replicates —
resample training.csv with seed=rep, train the ensemble end to end
(selection on the fixed validation split), then evaluate the best state on
the held-out test split; report mean (std) validation metrics and the
test metrics to two workbooks (`Ensemble_Bootstrap`, `..._test`).

Three modes, as `train_ensemble_cv`'s:
  * default, the padded (combination, replicate) grid (`--padded_compile`,
    `sweep/e2e_grid.py`), with `boot_{name}_{fingerprint}.json` resume
    markers, `--state_mirror`, `--e2e_chunk`, and with `--save_ensembles`
    `bootstrap_ensemble_models/ensemble_{name}/bootstrap_{rep}.bin`;
  * `--no-padded_compile`: one exact-shape ensemble per (combination,
    replicate) in turn, always writing those checkpoints;
  * `--frozen`: the meta heads on cached member logits, recomputed per
    replicate (each replicate's mean shifts the inputs), each best head
    evaluated on the held-out test split; the heads go to
    `bootstrap_ensemble_models/ensemble_{name}/meta_heads.bin`.

`--mesh MxN` shards the grid's and the frozen sweep's (combination,
replicate) work over M·N ranks (`parallel/mesh.py`, under torchrun, as
`train_ensemble_cv`'s): every rank returns the results, rank 0 alone
writes.

NOTE: the reference's --csv_path default points at the cross_validation
folder which lacks training.csv (the script cannot run as shipped); this
driver defaults to fixed_split, where training/validation/test.csv exist.
Runs on the CUDA device unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from itertools import combinations as it_combinations

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.checkpoint import ensemble_ckpt_path, save_state_dict
from vit3d_ensemble_tpu_torch.cli._common import (
    add_common_flags,
    apply_runtime_flags,
    setup_logging,
)
from vit3d_ensemble_tpu_torch.cli.train_ensemble_cv import (
    _load_member,
    frozen_members,
    held_out_metrics,
    save_meta_heads,
    sequential_mode,
    stack_member_logits,
    start_mirror,
    write_marker,
)
from vit3d_ensemble_tpu_torch.data import bootstrap_resample, build_train_val, load_split
from vit3d_ensemble_tpu_torch.metrics import (
    METRIC_KEYS,
    compute_eval_metrics,
    eleven_metrics,
    metrics_vector,
)
from vit3d_ensemble_tpu_torch.models import TransformerEnsemble
from vit3d_ensemble_tpu_torch.models.vit3d import resolve_device
from vit3d_ensemble_tpu_torch.parallel.mesh import barrier, mesh_from_spec
from vit3d_ensemble_tpu_torch.reporting import write_sweep_report
from vit3d_ensemble_tpu_torch.sweep.e2e_grid import run_e2e_grid, stack_e2e_folds
from vit3d_ensemble_tpu_torch.sweep.ensemble_sweep import (
    all_combinations,
    compute_member_logits,
    train_meta_sweep,
)
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
                        help="Fast screening mode (meta-heads on cached "
                             "logits); rankings do not track end-to-end "
                             "(docs/RESULTS.md).")
    parser.add_argument("--end_to_end", action="store_true",
                        help="(default) reference-faithful mode.")
    parser.add_argument("--padded_compile",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="(end-to-end) pad members to shape-class "
                             "templates and train the whole (combination, "
                             "replicate) grid in chunks (see "
                             "train_ensemble_cv); --no-padded_compile runs "
                             "the sequential exact-shape loop (always saves "
                             "checkpoints).")
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


def run_frozen(args):
    """The meta-head screening over the replicates
    (`vit3d_ensemble_tpu/cli/train_ensemble_bootstrap.py:106-203`): each
    replicate's member logits, every (combination, replicate) head trained
    at once, each best head's 11 metrics on the held-out test split (on
    the device, `metrics.compute_eval_metrics`); the heads go to
    `meta_heads.bin`."""
    confs, members, hyper = frozen_members(args)
    train, val, test = [], [], []
    for rep in range(args.num_rep):
        for store, split in zip((train, val, test), _splits_for_rep(args, rep)):
            store.append((compute_member_logits(members, split.volumes,
                                                args.img_size, device=args.device),
                          split.labels))
    TL, TY, TM = stack_member_logits(train, confs)
    VL, VY, VM = stack_member_logits(val, confs)
    SL, SY, SM = stack_member_logits(test, confs)
    combos = all_combinations(args.max_configs, args.combinations)
    conf_index = {c: i for i, c in enumerate(confs)}
    R = args.num_rep
    mesh = mesh_from_spec(getattr(args, "mesh", None), args.device)
    logger.info("frozen bootstrap sweep: %d combos x %d reps%s", len(combos), R,
                "" if mesh is None else f" on mesh {mesh.shape}")
    metrics, meta = train_meta_sweep(combos, TL, TY, TM, VL, VY, VM,
                                     conf_index, hyper, mesh=mesh, device=args.device)

    # the held-out test metrics of each best head
    device = resolve_device(args.device)
    rows = torch.as_tensor(np.vectorize(conf_index.__getitem__)(combos),
                           dtype=torch.long, device=device)
    wb = torch.as_tensor(meta, device=device)                    # (C, R, k + 1)
    sel = torch.as_tensor(SL, device=device)[
        torch.arange(R, device=device).reshape(1, R, 1), rows.unsqueeze(1)]
    probs = torch.sigmoid(torch.einsum("crkt,crk->crt", sel, wb[..., :-1])
                          + wb[..., -1:])
    C = len(combos)
    test_metrics = torch.vmap(lambda p, y, m: metrics_vector(
        compute_eval_metrics(p, y, m)))(
        probs.reshape(C * R, -1),
        torch.as_tensor(SY, device=device).repeat(C, 1),
        torch.as_tensor(SM, device=device).repeat(C, 1)).reshape(C, R, -1).cpu().numpy()

    val_results, test_results = {}, {}
    for ci, comb in enumerate(combos):
        name = "_".join(str(c) for c in comb)
        val_results[name] = {f"boot{r}": {k: float(x) for k, x in
                                          zip(METRIC_KEYS, metrics[ci, r])}
                             for r in range(R)}
        test_results[name] = {f"boot{r}": {k: float(x) for k, x in
                                           zip(METRIC_KEYS, test_metrics[ci, r])}
                              for r in range(R)}
        save_meta_heads(args, "bootstrap_ensemble", name, comb, meta[ci])
    return val_results, test_results


def run_end_to_end_grid(args):
    """The reference-faithful results, the (combination, replicate) grid in
    chunks (`sweep/e2e_grid.py`; JAX
    `cli/train_ensemble_bootstrap.py:206-295`).  The held-out test
    probabilities under each best state come with the grid's results, so no
    parameters leave the device unless --save_ensembles."""
    state_dir = os.path.join(args.output_dir, "sweep_state")
    os.makedirs(state_dir, exist_ok=True)
    fingerprint = (f"{args.num_rep}rep_{args.num_epochs}ep_"
                   f"{args.train_batch_size}b_{args.learning_rate}lr_"
                   f"{args.seed}s_grid")

    def marker_path(name: str) -> str:
        return os.path.join(state_dir, f"boot_{name}_{fingerprint}.json")

    mirror = start_mirror(args, state_dir)
    val_results, test_results = {}, {}
    todo = []
    for comb in it_combinations(range(1, args.max_configs), args.combinations):
        name = "_".join(str(c) for c in comb)
        if getattr(args, "resume", False) and os.path.exists(marker_path(name)):
            with open(marker_path(name)) as f:
                saved = json.load(f)
            val_results[name] = saved["val"]
            test_results[name] = saved["test"]
            logger.info("resume: skipping completed ensemble %s", name)
        else:
            todo.append(comb)
    if not todo:
        return val_results, test_results

    reps = [_splits_for_rep(args, rep) for rep in range(args.num_rep)]
    data = stack_e2e_folds(reps, args.num_epochs, args.train_batch_size, args.seed)
    save = getattr(args, "save_ensembles", False)

    def on_result(plan, res, extras):
        val_results[plan.name] = res
        test_results[plan.name] = {
            f"boot{r}": held_out_metrics(reps[r][2].labels, extras["test_probs"][r])
            for r in range(args.num_rep)}
        if extras["params"] is not None:        # under --save_ensembles, on rank 0
            for r, params in enumerate(extras["params"]):
                save_state_dict(ensemble_ckpt_path(
                    args.output_dir, "bootstrap_ensemble", plan.name,
                    f"bootstrap_{r}"), params)
        write_marker(marker_path(plan.name),
                     {"combo": [int(c) for c in plan.name.split("_")],
                      "val": res, "test": test_results[plan.name]}, mirror)

    run_e2e_grid(todo, lambda c: _load_member(args, c), data,
                 num_epochs=args.num_epochs, learning_rate=args.learning_rate,
                 seed=args.seed,
                 mesh=mesh_from_spec(getattr(args, "mesh", None), args.device),
                 chunk=getattr(args, "e2e_chunk", 0),
                 keep_payload=save, fold_label=lambda r: f"boot{r}",
                 on_result=on_result, device=args.device)
    return val_results, test_results


def run_end_to_end(args):
    """The reference-faithful mode: the grid under --padded_compile (the
    default), else sequential (`train_ensemble_bootstrap.py:298-341`)."""
    if getattr(args, "padded_compile", False):
        return run_end_to_end_grid(args)
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
        val_results, test_results = run_frozen(args)
    else:
        val_results, test_results = run_end_to_end(args)
    base = os.path.join(args.output_dir, args.workbook)
    write_sweep_report(base, val_results)
    write_sweep_report(base + "_test", test_results)
    logger.info("reports written to %s{,_test}.xlsx / .csv", base)
    barrier()
    return val_results, test_results


def cli() -> int:
    """Console-script entry: main returns the result dicts for programmatic
    use; setuptools wraps the entry point in sys.exit(), so return 0."""
    main()
    return 0


if __name__ == "__main__":
    main()

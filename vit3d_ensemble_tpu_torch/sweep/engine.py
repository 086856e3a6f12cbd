"""The grouped multi-model training engine.

The counterpart of `vit3d_ensemble_tpu/sweep/engine.py`.  One eager loop
trains every (config, fold) cell of a shape-class group at once: the cells
are the leading model axis of one stacked model (`sweep/stacked.py`), so a
step issues one model's launches for all G·F cells.  This replaces the
reference's 90 (18 configs x 5 folds) sequential runs
(`train_baseline_cv.py:270-278`) with 3 groups, and its per-step host syncs
(sklearn class weights `:168-169`, `.item()` logging) with tensor
expressions: the loop never waits for the device until the run ends.

  * Each fold's batch is gathered once (`pool[row_idx[idx]] - mean`,
    `engine.py:121-122`) and serves every config of the group.
  * The loss is the sum of the cells' masked BCE, each with its own
    balanced pos_weight, so each cell's gradient is its own run's; SGD
    (momentum 0.9, coupled weight decay, the LambdaLR factor) acts
    elementwise, so each cell's update equals its own run's.
  * Evaluation is deterministic (K1 with the model axis; K2 under `auto`):
    the 11 metrics and the selection rule run per cell with a leading (P,)
    axis on the device, with no per-cell host loop.

`run_cv_sweep` is the north-star workload, the 18-config x num_cv CV
sweep from the CSVs and PNGs on disk: the pooled folds of `data/pool.py`,
stacked by `stack_folds`, trained by `run_grouped_baselines`.

Not ported yet: the mesh path (ROADMAP.md, queue 1, "`parallel/mesh.py`")
and `remat` (ROADMAP.md, "Left inside ported modules").
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from typing import Dict, List

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.checkpoint import baseline_ckpt_path, save_state_dict
from vit3d_ensemble_tpu_torch.data import EpochBatcher
from vit3d_ensemble_tpu_torch.data.pool import build_pooled_cv
from vit3d_ensemble_tpu_torch.metrics import (
    METRIC_KEYS,
    compute_eval_metrics,
    metrics_vector,
)
from vit3d_ensemble_tpu_torch.models.vit3d import resolve_device
from vit3d_ensemble_tpu_torch.sweep.stack import (
    ConfigGroup,
    group_configs,
    init_group_params,
    unpad_group_params,
)
from vit3d_ensemble_tpu_torch.sweep.stacked import stacked_forward
from vit3d_ensemble_tpu_torch.train.optim import sgd_momentum
from vit3d_ensemble_tpu_torch.train.schedules import make_factor
from vit3d_ensemble_tpu_torch.train.selection import device_consider, device_take_if
from vit3d_ensemble_tpu_torch.train.steps import (
    masked_balanced_pos_weight,
    masked_bce_with_logits,
)
from vit3d_ensemble_tpu_torch.utils.metrics_log import default_logger
from vit3d_ensemble_tpu_torch.utils.profiling import profile_to

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SweepHyper:
    num_steps: int = 100
    eval_every: int = 24
    train_batch_size: int = 4
    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    warmup_steps: int = 1000
    decay_type: str = "cosine"
    balanced_weights: bool = True
    seed: int = 42
    #: Snapshot the full train state (params + optimizer + dropout generator
    #: + best-metric state) every this many eval periods, so a preempted
    #: group resumes mid-run instead of restarting.  0 = off.
    snapshot_every: int = 0
    #: Rematerialize encoder blocks in the backward pass: not ported (it
    #: raises), see `run_group`.
    remat: bool = False


class SimulatedPreemption(RuntimeError):
    """Raised by run_group's test-only `_abort_after_segments` hook."""


@dataclasses.dataclass
class FoldData:
    """Per-fold views into a shared volume pool, padded to common sizes.

    Folds gather from one un-normalized pool and mean-center per batch, as
    the JAX engine does (`data/pool.py`).
    """

    pool: np.ndarray            # (P, H, W, Z, C) float32, un-normalized
    row_idx: np.ndarray         # (F, N) int32 rows into pool
    train_labels: np.ndarray    # (F, N) float32
    mean: np.ndarray            # (F,) float32 per-fold normalization mean
    batch_idx: np.ndarray       # (F, S, B) int32 into row_idx
    batch_mask: np.ndarray      # (F, S, B) float32
    val_idx: np.ndarray         # (F, V) int32 rows into pool
    val_labels: np.ndarray      # (F, V) float32
    val_mask: np.ndarray        # (F, V) float32

    @property
    def n_folds(self) -> int:
        return self.row_idx.shape[0]


def stack_folds(pool, folds, hyper: SweepHyper) -> FoldData:
    """Pad per-fold pool views to common sizes and precompute the batch
    schedules (`engine.py:116-152`).

    pool: an array of volumes, or any object with a `volumes` array; folds:
    [(train, val), ...], each with `row_idx`, `labels` and `mean` (the
    fields of `data/pool.py`'s `PooledSplit`).  The batch order is per
    fold, shared across the configs of a group.
    """
    F = len(folds)
    n_max = max(len(t.row_idx) for t, _ in folds)
    v_max = max(len(v.row_idx) for _, v in folds)
    B, S = hyper.train_batch_size, hyper.num_steps

    row_idx = np.zeros((F, n_max), np.int32)
    train_labels = np.zeros((F, n_max), np.float32)
    mean = np.zeros((F,), np.float32)
    batch_idx = np.zeros((F, S, B), np.int32)
    batch_mask = np.zeros((F, S, B), np.float32)
    val_idx = np.zeros((F, v_max), np.int32)
    val_labels = np.zeros((F, v_max), np.float32)
    val_mask = np.zeros((F, v_max), np.float32)

    for f, (t, v) in enumerate(folds):
        n, vn = len(t.row_idx), len(v.row_idx)
        row_idx[f, :n] = t.row_idx
        train_labels[f, :n] = t.labels
        mean[f] = t.mean
        val_idx[f, :vn] = v.row_idx
        val_labels[f, :vn] = v.labels
        val_mask[f, :vn] = 1.0
        batcher = EpochBatcher(n, B, seed=hyper.seed)
        for s, (idx, msk) in enumerate(batcher.batches(S)):
            batch_idx[f, s] = idx
            batch_mask[f, s] = msk
    pool_vols = getattr(pool, "volumes", pool)
    return FoldData(pool_vols, row_idx, train_labels, mean, batch_idx,
                    batch_mask, val_idx, val_labels, val_mask)


@dataclasses.dataclass
class GroupResult:
    group: ConfigGroup
    best_metrics: np.ndarray     # (G, F, 11)
    best_probs: np.ndarray       # (G, F, V)
    best_params: dict            # stacked padded, leading (G, F), on the
    #                              device; crop true shapes with
    #                              stack.unpad_group_params
    final_loss: np.ndarray       # (G, F)
    #: every step's loss, (S, G, F) (the JAX engine keeps only the last)
    losses: np.ndarray = None

    def metrics_dict(self, g: int, f: int) -> Dict[str, float]:
        return {k: float(v) for k, v in zip(METRIC_KEYS,
                                            self.best_metrics[g, f])}


def _cell_loss(logits, labels, mask, balanced: bool):
    """One cell's masked BCE with its own balanced pos_weight."""
    pw = masked_balanced_pos_weight(labels, mask) if balanced else 1.0
    return masked_bce_with_logits(logits, labels, mask, pw)


def _metrics(probs, labels, mask):
    return metrics_vector(compute_eval_metrics(probs, labels, mask))


def _save_carry(path: str, carry: dict) -> None:
    """`torch.save` of the carry through a temporary file and a rename, so
    a preempted write never leaves a truncated state."""
    tmp = path + ".tmp"
    torch.save(carry, tmp)
    os.replace(tmp, path)


def run_group(group: ConfigGroup, data: FoldData, hyper: SweepHyper,
              img_size: int = 128, mesh=None, state_path=None,
              resume: bool = False, fold_ids=None, n_folds_total=None,
              _abort_after_segments=None, device=None) -> GroupResult:
    """Train one group on `device` (CUDA unless the caller names another).

    With hyper.snapshot_every > 0 and a `state_path`, the carry (params, SGD
    momentum and schedule step, the dropout generator's state, the best
    state, the losses so far) is saved with `torch.save` every
    snapshot_every eval periods; `resume=True` picks up from the last
    snapshot after preemption, and gives exactly the uninterrupted run.
    `_abort_after_segments` is a test-only hook that simulates preemption by
    raising after N segments.

    Dropout draws from one generator on `device`, seeded with hyper.seed,
    one mask a site for all cells (`sweep/stacked.py`): a cell's stream
    depends on the group's shape, and `fold_ids` / `n_folds_total`, which
    the JAX engine uses to give a chunked run the unchunked run's per-cell
    keys, change nothing here (ROADMAP.md §3).
    """
    if mesh is not None:
        raise NotImplementedError(
            "run_group: the mesh path is not ported yet (ROADMAP.md, queue 1, "
            "'parallel/mesh.py')")
    if hyper.remat:
        raise NotImplementedError(
            "run_group: remat is not ported: torch.utils.checkpoint does not "
            "replay dropout drawn from an explicit generator (ROADMAP.md, "
            "'Left inside ported modules': remat)")
    del fold_ids, n_folds_total
    device = resolve_device(device)
    G, F = len(group.confs), data.n_folds
    P = G * F
    config = group.template_config(img_size)

    params = {k: v.reshape(P, *v.shape[2:]).requires_grad_()
              for k, v in init_group_params(group, F, hyper.seed, img_size,
                                            device).items()}
    # cell p = g * F + f: config g on fold f
    mlp_active = torch.tensor(group.mlp_dims, dtype=torch.int32,
                              device=device).repeat_interleave(F)
    layers_active = torch.tensor(group.num_layers, dtype=torch.int32,
                                 device=device).repeat_interleave(F)
    opt, sched = sgd_momentum(
        params.values(), hyper.learning_rate,
        make_factor(hyper.decay_type, hyper.warmup_steps, hyper.num_steps),
        momentum=0.9, weight_decay=hyper.weight_decay)
    gen = torch.Generator(device=device).manual_seed(hyper.seed)

    def on_device(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    pool = on_device(data.pool)
    row_idx = on_device(data.row_idx, torch.long)
    train_labels = on_device(data.train_labels)
    mean = on_device(data.mean).reshape(F, 1, 1, 1, 1, 1)
    batch_idx = on_device(data.batch_idx, torch.long)
    batch_mask = on_device(data.batch_mask)
    val_vols = pool[on_device(data.val_idx, torch.long)] - mean
    val_labels = on_device(data.val_labels).repeat(G, 1)
    val_mask = on_device(data.val_mask).repeat(G, 1)
    V = val_labels.shape[1]

    cell_loss = torch.vmap(lambda lg, y, m: _cell_loss(
        lg, y, m, hyper.balanced_weights))
    metrics = torch.vmap(_metrics)
    consider = torch.vmap(device_consider, in_dims=(0, 0, 0, 0, None))
    take_if = torch.vmap(device_take_if)

    def step(s: int) -> torch.Tensor:
        idx, bm = batch_idx[:, s], batch_mask[:, s]            # (F, B)
        bv = pool[torch.gather(row_idx, 1, idx)] - mean        # (F, B, ...)
        bl = torch.gather(train_labels, 1, idx)
        logits = stacked_forward(params, config, bv,
                                 layers_active=layers_active,
                                 mlp_active=mlp_active, deterministic=False,
                                 generator=gen)
        losses = cell_loss(logits.reshape(P, -1), bl.repeat(G, 1),
                           bm.repeat(G, 1))
        losses.sum().backward()
        opt.step()
        opt.zero_grad()
        sched.step()
        return losses.detach()

    @torch.no_grad()
    def evaluate():
        logits = stacked_forward(params, config, val_vols,
                                 layers_active=layers_active,
                                 mlp_active=mlp_active, deterministic=True)
        probs = torch.sigmoid(logits.reshape(P, V))
        return metrics(probs, val_labels, val_mask), probs

    def payload():
        return {k: v.detach() for k, v in params.items()}

    best = dict(auc=torch.zeros(P, device=device),
                choice=torch.zeros(P, dtype=torch.bool, device=device),
                found=torch.zeros(P, dtype=torch.bool, device=device),
                metrics=torch.zeros(P, len(METRIC_KEYS), device=device),
                probs=torch.zeros(P, V, device=device),
                payload={k: v.detach().clone() for k, v in params.items()})
    losses: List[torch.Tensor] = []

    E, S = hyper.eval_every, hyper.num_steps
    periods, rem = divmod(S, E)
    sp = hyper.snapshot_every if hyper.snapshot_every > 0 else max(periods, 1)
    bounds = list(range(0, periods, sp)) + [periods] if periods else [0, 0]
    seg_done = 0
    if resume and state_path and os.path.exists(state_path):
        try:
            carry = torch.load(state_path, map_location=device,
                               weights_only=True)
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(carry["params"][k])
            opt.load_state_dict(carry["opt"])
            sched.load_state_dict(carry["sched"])
            gen.set_state(carry["gen"].cpu())
            best, losses = carry["best"], list(carry["losses"])
            seg_done = int(carry["segments_done"])
        except Exception as exc:  # noqa: BLE001
            # a truncated or mismatched state, whatever the unpickler or the
            # copies raise on it: restart the group, as the JAX engine does
            logger.warning("resume state %s unreadable (%s); restarting the "
                           "group from scratch", state_path, exc)
            return run_group(group, data, hyper, img_size,
                             state_path=state_path, device=device,
                             _abort_after_segments=_abort_after_segments)
        logger.info("resume: group (D=%d, k=%d) continues from segment %d",
                    group.hidden_size, group.num_heads, seg_done)

    for seg in range(seg_done, len(bounds) - 1):
        for period in range(bounds[seg], bounds[seg + 1]):
            for s in range(period * E, (period + 1) * E):
                losses.append(step(s))
            mvec, probs = evaluate()
            best = consider(best, mvec, probs, payload(), False)
        if state_path and hyper.snapshot_every > 0:
            _save_carry(state_path, dict(
                params=payload(), opt=opt.state_dict(),
                sched=sched.state_dict(), gen=gen.get_state(), best=best,
                losses=losses, segments_done=seg + 1))
        if _abort_after_segments is not None and seg + 1 >= _abort_after_segments:
            raise SimulatedPreemption(f"aborted after segment {seg + 1}")

    for s in range(periods * E, S):
        losses.append(step(s))
    # If no eval ever accepted (e.g. num_steps < eval_every, or all AUROCs
    # == 0), take a final eval so results are always defined.
    mvec, probs = evaluate()
    best = take_if(best, mvec, probs, payload(), ~best["found"])
    if state_path and os.path.exists(state_path):
        os.remove(state_path)

    steps = (torch.stack(losses) if losses
             else torch.zeros(0, P, device=device))
    steps = steps.reshape(-1, G, F).cpu().numpy()
    return GroupResult(
        group=group,
        best_metrics=best["metrics"].reshape(G, F, -1).cpu().numpy(),
        best_probs=best["probs"].reshape(G, F, V).cpu().numpy(),
        best_params={k: v.reshape(G, F, *v.shape[1:])
                     for k, v in best["payload"].items()},
        final_loss=steps[-1] if len(steps) else np.zeros((G, F), np.float32),
        losses=steps,
    )


def sweep_hyper_from_args(args, balanced_weights: bool = True) -> SweepHyper:
    if getattr(args, "gradient_accumulation_steps", 1) > 1:
        logger.warning(
            "--gradient_accumulation_steps is not supported by the grouped "
            "sweep engine and will be ignored; use the single-config path "
            "for accumulation.")
    return SweepHyper(
        num_steps=args.num_steps, eval_every=args.eval_every,
        train_batch_size=args.train_batch_size,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, decay_type=args.decay_type,
        balanced_weights=balanced_weights, seed=args.seed,
        snapshot_every=getattr(args, "snapshot_every", 0),
        remat=getattr(args, "remat", False))


def sweep_aug_mode(args) -> str:
    """All three aug modes run through the pooled sweeps: 'disk' reads the
    precomputed folders, 'device' computes the same three variants on the
    device at pool-build time (`PoolBuilder.device_aug_row`; no aug folders
    needed on disk), 'none' skips augmentation."""
    return args.aug_mode


def sweep_marker_path(state_dir: str, marker_prefix: str,
                      group: ConfigGroup, n_folds: int,
                      hyper: SweepHyper) -> str:
    """Resume-marker file for one group, keyed by the full run fingerprint
    (conf set + fold count + hyperparameters), as the JAX engine keys it
    (`engine.py:489-511`), so the two name a run's markers alike.
    snapshot_every and remat are excluded: operational knobs whose results
    are identical across settings."""
    hyper_key = dataclasses.replace(hyper, snapshot_every=0, remat=False)
    fp = hashlib.sha1(repr((group.confs, n_folds, hyper_key))
                      .encode()).hexdigest()[:12]
    return os.path.join(
        state_dir,
        f"{marker_prefix}_group_{group.hidden_size}_"
        f"{group.num_heads}_{fp}.json")


def run_grouped_baselines(args, data: FoldData, hyper: SweepHyper,
                          ckpt_kind: str, fold_label, fold_tag,
                          marker_prefix: str,
                          confs=range(1, 19), fold_ids=None,
                          n_folds_total=None, device=None) -> Dict:
    """The shared 18-config group loop: train each (hidden, heads) shape
    class as one stacked model, write per-(conf, fold) checkpoints in the
    reference layout, persist per-group result markers (`args.resume`
    skips completed groups after preemption), honor `args.profile_dir`, and
    append per-conf events to the JSON-lines metrics log."""
    mesh = getattr(args, "mesh", None)
    state_dir = os.path.join(args.output_dir, "sweep_state")
    os.makedirs(state_dir, exist_ok=True)
    mlog = default_logger(args.output_dir)
    resume = getattr(args, "resume", False)

    results: Dict[int, Dict[str, Dict[str, float]]] = {}
    with profile_to(getattr(args, "profile_dir", None)):
        for group in group_configs(confs):
            marker = sweep_marker_path(state_dir, marker_prefix, group,
                                       data.n_folds, hyper)
            if resume and os.path.exists(marker):
                # this group completed in a previous (preempted) run
                with open(marker) as f:
                    saved = json.load(f)
                results.update({int(k): v for k, v in saved.items()})
                logger.info("resume: skipping completed group (D=%d, k=%d)",
                            group.hidden_size, group.num_heads)
                continue
            logger.info("training group (D=%d, k=%d): confs %s",
                        group.hidden_size, group.num_heads, group.confs)
            # mid-group state is keyed by the snapshot cadence: segment
            # bounds differ across cadences
            state_path = (marker[:-len(".json")]
                          + f"_state_s{hyper.snapshot_every}_m1x1.pt")
            res = run_group(group, data, hyper, args.img_size, mesh=mesh,
                            state_path=state_path, resume=resume,
                            fold_ids=fold_ids, n_folds_total=n_folds_total,
                            device=device)
            members = unpad_group_params(res.best_params, group, args.img_size)
            group_results: Dict[int, Dict[str, Dict[str, float]]] = {}
            for g, conf in enumerate(group.confs):
                group_results[conf] = {}
                for f in range(data.n_folds):
                    m = res.metrics_dict(g, f)
                    group_results[conf][fold_label(f)] = m
                    ckpt = baseline_ckpt_path(args.output_dir, ckpt_kind,
                                              conf, fold_tag(conf, f))
                    save_state_dict(ckpt, {k: v[f] for k, v in members[g].items()})
                    mlog.log("sweep_eval", conf=conf, fold=fold_label(f), **m)
                logger.info("conf %d median AUROC over folds: %.4f", conf,
                            float(np.median(res.best_metrics[g, :, 3])))
            with open(marker, "w") as f:
                json.dump(group_results, f)
            results.update(group_results)
    return results


def run_cv_sweep(args, device=None) -> Dict[int, Dict[str, Dict[str, float]]]:
    """The full 18-config x num_cv CV sweep (the north-star workload) on
    `device` (CUDA unless the caller names another).

    Drop-in for looping `train_baseline_cv.py` over all --config values.
    Returns {conf: {'CV 1': {metric: value}, ...}} and writes checkpoints
    in the reference layout.
    """
    hyper = sweep_hyper_from_args(args)
    pool, folds = build_pooled_cv(args.csv_path, args.data_root, args.num_cv,
                                  size=args.img_size,
                                  aug_mode=sweep_aug_mode(args), device=device)
    data = stack_folds(pool, folds, hyper)
    return run_grouped_baselines(
        args, data, hyper, ckpt_kind="cv_baseline",
        fold_label=lambda f: f"CV {f + 1}",
        fold_tag=lambda conf, f: f"cv{f + 1}",
        marker_prefix="cv", device=device)

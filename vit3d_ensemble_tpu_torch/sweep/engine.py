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

With a mesh (`parallel/mesh.py`) each rank trains its (config, fold) block
of the padded grid through the same loop and the blocks are gathered
(`run_group`); `SweepHyper.remat` recomputes the encoder blocks in the
backward pass (`ops/attention.checkpoint_block`), with the same results.
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
from vit3d_ensemble_tpu_torch.ops.attention import CellDropout
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
    #: Snapshot the full train state (params + optimizer + dropout site
    #: counter + best-metric state) every this many eval periods, so a
    #: preempted group resumes mid-run instead of restarting.  0 = off.
    snapshot_every: int = 0
    #: Rematerialize encoder blocks in the backward pass (the cells'
    #: dropout masks replayed: the same results, one block's activations
    #: held at a time; `stacked.stacked_forward`).
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


def _rank_state_path(state_path, mesh):
    """Each rank snapshots its own block: rank r's file is state_path with
    `_r{r}` before its extension."""
    if state_path is None or mesh is None:
        return state_path
    root, ext = os.path.splitext(state_path)
    return f"{root}_r{mesh.rank}{ext}"


def run_group(group: ConfigGroup, data: FoldData, hyper: SweepHyper,
              img_size: int = 128, mesh=None, state_path=None,
              resume: bool = False, fold_ids=None, n_folds_total=None,
              _abort_after_segments=None, device=None) -> GroupResult:
    """Train one group on `device` (CUDA unless the caller names another).

    With `mesh` (`parallel/mesh.Mesh`, M x N ranks) the (G, F) grid is
    padded to multiples of (M, N) by repeating config 0 and fold 0
    (`mesh.rep_pad`), and each rank trains its (model, data) block
    (`mesh.shard_group_inputs`) on the mesh's device: its configs keep the
    whole group's template widths and depth and their own `mlp_active` and
    `layers_active`, its folds their data, the pool is whole.  The blocks'
    results are gathered and the padding cropped, so every rank returns
    the whole (G, F) result (JAX `engine.py:332-430`).

    With hyper.snapshot_every > 0 and a `state_path`, the carry (params, SGD
    momentum and schedule step, the dropout site counter, the best state,
    the losses so far) is saved with `torch.save` every snapshot_every eval
    periods, by each rank for its block (`_rank_state_path`);
    `resume=True` picks up from the last snapshot after preemption, and
    gives exactly the uninterrupted run.  The ranks agree first: all resume
    from the same segment, or all restart.  `_abort_after_segments` is a
    test-only hook that simulates preemption by raising after N segments.

    Each cell draws its dropout masks from a stream of its own
    (`ops/attention.CellDropout`, seeded with hyper.seed), keyed on its
    index in the true (config, fold) grid, `g * F_total + fold_ids[f]`
    with `F_total = n_folds_total or F` and `fold_ids` `range(F)` by
    default, as the JAX engine keys it (`engine.py:369-386`); padding cells
    repeat the ids of config 0 and fold 0.  So a caller that trains a slice
    of a larger fold axis (the chunked bootstrap: replicates s..s+w-1 of
    num_rep), and a rank that trains a block, give each cell the masks of
    the unchunked, unsharded run.  `hyper.remat` recomputes each encoder
    block in the backward pass, with the same masks and results.
    """
    from vit3d_ensemble_tpu_torch.parallel.mesh import (
        all_min,
        block,
        gather_grid,
        padded,
        rep_pad,
        shard_group_inputs,
    )

    device = mesh.device if mesh is not None else resolve_device(device)
    G, F = len(group.confs), data.n_folds
    F_total = F if n_folds_total is None else int(n_folds_total)
    fold_ids = list(range(F) if fold_ids is None else fold_ids)
    if len(fold_ids) != F:
        raise ValueError(f"run_group: {len(fold_ids)} fold ids for {F} folds")
    config = group.template_config(img_size)

    ids = np.arange(G * F_total).reshape(G, F_total)[:, fold_ids]
    confs = np.arange(G)                         # the configs of this block
    params = init_group_params(group, F, hyper.seed, img_size, device)
    arrays = dict(pool=data.pool, row_idx=data.row_idx,
                  train_labels=data.train_labels, mean=data.mean,
                  batch_idx=data.batch_idx, batch_mask=data.batch_mask,
                  val_idx=data.val_idx, val_labels=data.val_labels,
                  val_mask=data.val_mask)
    if mesh is not None:
        G_pad, F_pad = padded(G, mesh.n_model), padded(F, mesh.n_data)

        def pad_grid(a):
            return rep_pad(rep_pad(a, G_pad), F_pad, axis=1)

        params, ids, arrays = shard_group_inputs(
            mesh, {k: pad_grid(v) for k, v in params.items()}, pad_grid(ids),
            {k: (v if k == "pool" else rep_pad(v, F_pad)) for k, v in arrays.items()})
        confs = rep_pad(confs, G_pad)[block(G_pad, mesh.n_model, mesh.coords[0])]
    rank_path = _rank_state_path(state_path, mesh)
    Gb, Fb = ids.shape                                    # this rank's block
    P = Gb * Fb
    params = {k: v.reshape(P, *v.shape[2:]).contiguous().requires_grad_()
              for k, v in params.items()}
    # cell p = g * Fb + f: config confs[g] on fold f of the block
    mlp_active = torch.tensor(np.asarray(group.mlp_dims)[confs], dtype=torch.int32,
                              device=device).repeat_interleave(Fb)
    layers_active = torch.tensor(np.asarray(group.num_layers)[confs],
                                 dtype=torch.int32, device=device).repeat_interleave(Fb)
    opt, sched = sgd_momentum(
        params.values(), hyper.learning_rate,
        make_factor(hyper.decay_type, hyper.warmup_steps, hyper.num_steps),
        momentum=0.9, weight_decay=hyper.weight_decay)
    cells = CellDropout(hyper.seed, ids.reshape(-1).tolist(), device)

    def on_device(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    pool = on_device(arrays["pool"])
    row_idx = on_device(arrays["row_idx"], torch.long)
    train_labels = on_device(arrays["train_labels"])
    mean = on_device(arrays["mean"]).reshape(Fb, 1, 1, 1, 1, 1)
    batch_idx = on_device(arrays["batch_idx"], torch.long)
    batch_mask = on_device(arrays["batch_mask"])
    val_vols = pool[on_device(arrays["val_idx"], torch.long)] - mean
    val_labels = on_device(arrays["val_labels"]).repeat(Gb, 1)
    val_mask = on_device(arrays["val_mask"]).repeat(Gb, 1)
    V = val_labels.shape[1]

    cell_loss = torch.vmap(lambda lg, y, m: _cell_loss(
        lg, y, m, hyper.balanced_weights))
    metrics = torch.vmap(_metrics)
    consider = torch.vmap(device_consider, in_dims=(0, 0, 0, 0, None))
    take_if = torch.vmap(device_take_if)

    def step(s: int) -> torch.Tensor:
        idx, bm = batch_idx[:, s], batch_mask[:, s]            # (Fb, B)
        bv = pool[torch.gather(row_idx, 1, idx)] - mean        # (Fb, B, ...)
        bl = torch.gather(train_labels, 1, idx)
        logits = stacked_forward(params, config, bv,
                                 layers_active=layers_active,
                                 mlp_active=mlp_active, deterministic=False,
                                 generator=cells, remat=hyper.remat)
        losses = cell_loss(logits.reshape(P, -1), bl.repeat(Gb, 1),
                           bm.repeat(Gb, 1))
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
    # 1: this rank read its snapshot, 0: it has none, -1: it could not read it
    loaded = 0
    if resume and rank_path and os.path.exists(rank_path):
        try:
            carry = torch.load(rank_path, map_location=device,
                               weights_only=True)
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(carry["params"][k])
            opt.load_state_dict(carry["opt"])
            sched.load_state_dict(carry["sched"])
            cells.site = int(carry["dropout_site"])
            best, losses = carry["best"], list(carry["losses"])
            seg_done, loaded = int(carry["segments_done"]), 1
        except Exception as exc:  # noqa: BLE001
            # a truncated or mismatched state, whatever the unpickler or the
            # copies raise on it: restart the group, as the JAX engine does
            logger.warning("resume state %s unreadable (%s); restarting the "
                           "group from scratch", rank_path, exc)
            loaded = -1
    low, neg_high, seg_low, neg_seg_high = all_min(
        mesh, [loaded, -loaded, seg_done, -seg_done])
    if (low, -neg_high) != (0, 0) and not (
            low == -neg_high == 1 and seg_low == -neg_seg_high):
        # some rank could not resume, or the ranks stand at different
        # segments: every rank restarts, none resumes alone
        if mesh is not None and loaded == 1:
            logger.warning("resume: another rank cannot continue from segment "
                           "%d; restarting the group", seg_done)
        return run_group(group, data, hyper, img_size, mesh=mesh,
                         state_path=state_path,
                         fold_ids=fold_ids, n_folds_total=n_folds_total,
                         device=device,
                         _abort_after_segments=_abort_after_segments)
    if loaded == 1:
        logger.info("resume: group (D=%d, k=%d) continues from segment %d",
                    group.hidden_size, group.num_heads, seg_done)

    for seg in range(seg_done, len(bounds) - 1):
        for period in range(bounds[seg], bounds[seg + 1]):
            for s in range(period * E, (period + 1) * E):
                losses.append(step(s))
            mvec, probs = evaluate()
            best = consider(best, mvec, probs, payload(), False)
        if rank_path and hyper.snapshot_every > 0:
            _save_carry(rank_path, dict(
                params=payload(), opt=opt.state_dict(),
                sched=sched.state_dict(), dropout_site=cells.site, best=best,
                losses=losses, segments_done=seg + 1))
        if _abort_after_segments is not None and seg + 1 >= _abort_after_segments:
            raise SimulatedPreemption(f"aborted after segment {seg + 1}")

    for s in range(periods * E, S):
        losses.append(step(s))
    # If no eval ever accepted (e.g. num_steps < eval_every, or all AUROCs
    # == 0), take a final eval so results are always defined.
    mvec, probs = evaluate()
    best = take_if(best, mvec, probs, payload(), ~best["found"])
    if rank_path and os.path.exists(rank_path):
        os.remove(rank_path)

    def grid(t: torch.Tensor) -> torch.Tensor:
        """A (P, ...) result as the whole (G, F, ...) grid."""
        t = t.reshape(Gb, Fb, *t.shape[1:])
        return t if mesh is None else gather_grid(mesh, t)[:G, :F]

    steps = (torch.stack(losses) if losses
             else torch.zeros(0, P, device=device))
    steps = grid(steps.transpose(0, 1)).permute(2, 0, 1).cpu().numpy()
    return GroupResult(
        group=group,
        best_metrics=grid(best["metrics"]).cpu().numpy(),
        best_probs=grid(best["probs"]).cpu().numpy(),
        best_params={k: grid(v) for k, v in best["payload"].items()},
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
    append per-conf events to the JSON-lines metrics log.

    `args.mesh` ('MxN', 'auto' or a `parallel/mesh.Mesh`) shards each
    group over a mesh of ranks (`run_group`); the snapshots are named for
    its shape (`_m{M}x{N}`).  Every rank returns the whole results; rank 0
    alone writes, and the others wait for it at the end of each group."""
    from vit3d_ensemble_tpu_torch.parallel.mesh import barrier, is_writer, mesh_from_spec

    mesh = mesh_from_spec(getattr(args, "mesh", None), device)
    if mesh is not None:
        logger.info("multi-rank sweep: mesh model=%d x data=%d on %s (%s)",
                    mesh.n_model, mesh.n_data, mesh.device, mesh.backend)
    mesh_tag = "1x1" if mesh is None else f"{mesh.n_model}x{mesh.n_data}"
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
            # mid-group state is keyed by the snapshot cadence and the mesh:
            # segment bounds and blocks differ across them
            state_path = (marker[:-len(".json")]
                          + f"_state_s{hyper.snapshot_every}_m{mesh_tag}.pt")
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
            if is_writer():
                with open(marker, "w") as f:
                    json.dump(group_results, f)
            barrier()
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

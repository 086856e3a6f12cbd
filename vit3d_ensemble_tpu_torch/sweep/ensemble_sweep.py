"""Frozen-backbone ensemble sweep: all C(18,3) = 816 combinations at once.

The counterpart of `vit3d_ensemble_tpu/sweep/ensemble_sweep.py`.  The
reference's ensemble CV sweep re-trains 816 x 5 full ensembles
sequentially (`train_ensemble_cv.py:56-57,66,85`).  The `frozen` mode runs
the 18 baselines' logits over each split once, in one stacked forward a
shape-class group (`compute_member_logits`), and then trains the 816 x F
Linear(3, 1) + sigmoid meta heads on the cached logits as one batched
model (`train_meta_sweep`).  The drivers' `--frozen` screening; the
reference-faithful end-to-end mode is `sweep/e2e_grid.py` and
`train/ensemble_trainer.py`.

`compute_member_logits` takes K1 with the model axis (under `auto` on a
CUDA tensor) and K2 in each group's forward.  JAX pads every chunk of
volumes to 128 so that one compiled program serves every split; the port
compiles nothing and runs the last chunk at its true size.

The meta heads' initial draw comes from `init_meta_heads`, a
`torch.Generator` seeded with the sweep's seed: JAX draws them from
`jax.random` (`ensemble_sweep.py:224-231`), which PyTorch cannot reproduce
(ROADMAP.md §3, "Known differences").  With a mesh (`parallel/mesh.py`)
the (combination, fold) grid of heads is padded and split over the ranks,
each rank trains its block, and the blocks are gathered
(`train_meta_sweep`).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.metrics import compute_eval_metrics, metrics_vector
from vit3d_ensemble_tpu_torch.models.vit3d import resolve_device
from vit3d_ensemble_tpu_torch.sweep.stack import _pad_to, _shapes, group_configs
from vit3d_ensemble_tpu_torch.sweep.stacked import stacked_forward
from vit3d_ensemble_tpu_torch.train.optim import StackedAdam
from vit3d_ensemble_tpu_torch.train.selection import device_consider, device_take_if

logger = logging.getLogger(__name__)


def all_combinations(max_configs: int = 19, k: int = 3) -> np.ndarray:
    """The reference's combination grid (`train_ensemble_cv.py:56-57`):
    combinations(range(1, max_configs), k) -> (n_combos, k) conf numbers."""
    return np.array(list(itertools.combinations(range(1, max_configs), k)),
                    dtype=np.int32)


@torch.no_grad()
def compute_member_logits(
    member_params: Mapping[int, Mapping[str, torch.Tensor]],
    volumes: np.ndarray,
    img_size: int = 128,
    batch_size: int = 128,
    device=None,
) -> Dict[int, np.ndarray]:
    """Each baseline conf's logits over `volumes`, grouped and stacked, on
    `device` (CUDA unless the caller names another).

    member_params: {conf: true-shape state_dict}.  Returns {conf: (N,)}.
    """
    device = resolve_device(device)
    out: Dict[int, np.ndarray] = {}
    for group in group_configs(sorted(member_params)):
        template = group.template_config(img_size)
        shapes = _shapes(template)
        states = [member_params[c] for c in group.confs]
        params = {k: torch.stack([_pad_to(s[k].to(device), shape) if k in s
                                  else torch.zeros(shape, device=device)
                                  for s in states])
                  for k, shape in shapes.items()}
        mlp_active = torch.tensor(group.mlp_dims, dtype=torch.int32, device=device)
        layers_active = torch.tensor(group.num_layers, dtype=torch.int32,
                                     device=device)
        chunks = []
        for s in range(0, volumes.shape[0], batch_size):
            x = torch.as_tensor(volumes[s:s + batch_size], device=device)
            logits = stacked_forward(params, template, x.unsqueeze(0),
                                     layers_active=layers_active,
                                     mlp_active=mlp_active, deterministic=True)
            chunks.append(logits.reshape(len(group.confs), -1).cpu().numpy())
        logits = np.concatenate(chunks, axis=1)             # (G, N)
        for g, c in enumerate(group.confs):
            out[c] = logits[g]
    return out


@dataclasses.dataclass(frozen=True)
class MetaHyper:
    num_epochs: int = 100
    train_batch_size: int = 4
    learning_rate: float = 1e-4
    seed: int = 42


def init_meta_heads(C: int, F: int, k: int, seed: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The (C, F, k) weights and (C, F) biases every (combination, fold)
    head starts from: torch Linear(k, 1)'s default U(±1/√k), from a
    `torch.Generator` seeded with `seed`."""
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(k)
    w = torch.empty(C, F, k).uniform_(-bound, bound, generator=g)
    b = torch.empty(C, F).uniform_(-bound, bound, generator=g)
    return w.numpy(), b.numpy()


def _batch_schedule(train_mask: np.ndarray, B: int, E: int, seed: int):
    """(F, E, steps, B) indices and masks, reshuffled per epoch per fold
    (the reference's RandomSampler every epoch); shorter folds' batches past
    their rows are fully masked.  `ensemble_sweep.py:152-165`, exactly."""
    F, N = train_mask.shape
    steps = -(-N // B)
    rng = np.random.default_rng(seed)
    batch_idx = np.zeros((F, E, steps, B), np.int32)
    batch_msk = np.zeros((F, E, steps, B), np.float32)
    for f in range(F):
        n_true = int(train_mask[f].sum())
        for e in range(E):
            order = rng.permutation(n_true)
            for s in range(steps):
                chunk = order[s * B:(s + 1) * B]
                batch_msk[f, e, s, :len(chunk)] = 1.0
                batch_idx[f, e, s, :len(chunk)] = chunk
    return batch_idx, batch_msk


def train_meta_sweep(
    combos: np.ndarray,                 # (C, k) conf numbers
    train_logits: np.ndarray,           # (F, 18, N) per-fold member logits
    train_labels: np.ndarray,           # (F, N)
    train_mask: np.ndarray,             # (F, N)
    val_logits: np.ndarray,             # (F, 18, V)
    val_labels: np.ndarray,             # (F, V)
    val_mask: np.ndarray,               # (F, V)
    conf_index: Mapping[int, int],      # conf number -> row in logits
    hyper: MetaHyper = MetaHyper(),
    mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train every (combo, fold) meta head on `device` (CUDA unless the
    caller names another); returns (best_metrics (C, F, 11),
    best_meta_params as (C, F, k + 1) [w1 .. wk b]).

    Every head is an instance of one batched model: Adam with a step count
    for each (`train/optim.StackedAdam`, whose guard holds a fold's heads
    through its fully masked padding batches), evaluation and the selection
    rule after every epoch, and the closing evaluation taken only where no
    epoch was accepted (`ensemble_sweep.py:216-221`).

    With `mesh` (`parallel/mesh.Mesh`) the initial heads are drawn over the
    true (C, F), then C and F are padded to multiples of (M, N) by
    repeating entry 0 and each rank trains its (model, data) block on the
    mesh's device; the blocks are gathered and cropped on every rank (JAX
    `ensemble_sweep.py:228-262`)."""
    from vit3d_ensemble_tpu_torch.parallel.mesh import (
        block,
        gather_grid,
        padded,
        rep_pad,
        sweep_shardings,
    )

    device = mesh.device if mesh is not None else resolve_device(device)
    combos = np.asarray(combos)
    C, k = combos.shape
    F = train_logits.shape[0]
    E, B = hyper.num_epochs, hyper.train_batch_size
    batch_idx, batch_msk = _batch_schedule(np.asarray(train_mask), B, E, hyper.seed)
    w0, b0 = init_meta_heads(C, F, k, hyper.seed)
    rows = np.vectorize(conf_index.__getitem__)(combos)              # (C, k)
    folds = dict(train_logits=train_logits, train_labels=train_labels,
                 val_logits=val_logits, val_labels=val_labels, val_mask=val_mask,
                 batch_idx=batch_idx, batch_msk=batch_msk)
    if mesh is not None:
        C_pad, F_pad = padded(C, mesh.n_model), padded(F, mesh.n_data)
        grid, fold, _ = sweep_shardings(mesh)
        w0, b0 = (grid(rep_pad(rep_pad(a, C_pad), F_pad, axis=1)) for a in (w0, b0))
        rows = rep_pad(rows, C_pad)[block(C_pad, mesh.n_model, mesh.coords[0])]
        folds = {n: fold(rep_pad(a, F_pad)) for n, a in folds.items()}
    metrics, meta = _train_meta_block(rows, w0, b0, folds, hyper, device)
    if mesh is not None:
        metrics, meta = (gather_grid(mesh, t)[:C, :F] for t in (metrics, meta))
    return metrics.cpu().numpy(), meta.cpu().numpy()


def _train_meta_block(rows: np.ndarray, w0: np.ndarray, b0: np.ndarray,
                      folds: Mapping[str, np.ndarray], hyper: MetaHyper,
                      device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`train_meta_sweep`'s loop over a (C, F) block of heads: rows (C, k)
    into the logits' member axis, the heads' initial (C, F, k) weights and
    (C, F) biases, the folds' arrays.  Returns the best metrics (C, F, 11)
    and heads (C, F, k + 1) on the device."""
    C, k = rows.shape
    F = w0.shape[1]
    E = hyper.num_epochs

    def on_device(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    rows = on_device(rows, torch.long)
    fold_ids = torch.arange(F, device=device).reshape(1, F, 1)
    # each head's member columns: (C, F, k, N) and (C, F, k, V)
    sel_t = on_device(folds["train_logits"])[fold_ids, rows.unsqueeze(1)]
    sel_v = on_device(folds["val_logits"])[fold_ids, rows.unsqueeze(1)]
    ty = on_device(folds["train_labels"])
    vy = on_device(folds["val_labels"]).repeat(C, 1)
    vmask = on_device(folds["val_mask"]).repeat(C, 1)
    batch_idx = on_device(folds["batch_idx"], torch.long)
    batch_msk = on_device(folds["batch_msk"])
    B = batch_idx.shape[-1]

    w = on_device(w0).requires_grad_()
    b = on_device(b0).requires_grad_()
    opt = StackedAdam([w, b], hyper.learning_rate, (C, F))
    metrics = torch.vmap(lambda p, y, m: metrics_vector(
        compute_eval_metrics(p, y, m)))
    consider = torch.vmap(device_consider, in_dims=(0, 0, 0, 0, None))
    take_if = torch.vmap(device_take_if)

    @torch.no_grad()
    def evaluate():
        probs = torch.sigmoid(torch.einsum("cfkv,cfk->cfv", sel_v, w)
                              + b.unsqueeze(-1)).reshape(C * F, -1)
        return metrics(probs, vy, vmask), probs

    def payload():
        return {"w": w.detach().reshape(C * F, k), "b": b.detach().reshape(C * F)}

    best = dict(auc=torch.zeros(C * F, device=device),
                choice=torch.zeros(C * F, dtype=torch.bool, device=device),
                found=torch.zeros(C * F, dtype=torch.bool, device=device),
                metrics=torch.zeros(C * F, 11, device=device),
                probs=torch.zeros(C * F, vy.shape[1], device=device),
                payload={n: v.clone() for n, v in payload().items()})
    arange_f = torch.arange(F, device=device).unsqueeze(1)
    for e in range(E):
        for s in range(batch_idx.shape[2]):
            idx, m = batch_idx[:, e, s], batch_msk[:, e, s]          # (F, B)
            cols = torch.gather(sel_t, 3, idx.reshape(1, F, 1, B)
                                .expand(C, F, k, B))                 # (C, F, k, B)
            y = ty[arange_f, idx]                                    # (F, B)
            probs = torch.sigmoid(torch.einsum("cfkb,cfk->cfb", cols, w)
                                  + b.unsqueeze(-1))
            probs = torch.clamp(probs, 1e-12, 1 - 1e-12)
            per = -(y * torch.log(probs) + (1 - y) * torch.log(1 - probs))
            loss = torch.sum(per * m, -1) / torch.clamp(torch.sum(m, -1), min=1.0)
            loss.sum().backward()
            opt.step((m.sum(-1) > 0).expand(C, F))
            opt.zero_grad()
        mvec, probs = evaluate()
        best = consider(best, mvec, probs, payload(), False)
    mvec, probs = evaluate()
    best = take_if(best, mvec, probs, payload(), ~best["found"])
    meta = torch.cat([best["payload"]["w"], best["payload"]["b"].unsqueeze(-1)],
                     dim=-1)
    return best["metrics"].reshape(C, F, -1), meta.reshape(C, F, k + 1)

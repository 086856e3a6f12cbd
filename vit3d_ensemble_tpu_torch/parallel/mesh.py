"""Meshes of torch.distributed ranks, the sweeps' sharding rules and the
data-parallel training step.

The counterpart of `vit3d_ensemble_tpu/parallel/mesh.py`.  JAX runs one
program over a `Mesh('model', 'data')` of devices and lets XLA partition
it.  The port keeps PyTorch's idiom instead:

  * a mesh is M·N ranks of a process group; rank r sits at (r // N, r % N),
    the row-major order of JAX's `reshape(n_model, n_data)` (`mesh.py:30`);
  * each rank runs its block of a (config, fold) or (combination, fold)
    grid through the one-device code (`sweep_shardings`); an axis that the
    mesh does not divide is padded by repeating entry 0 (`rep_pad`), and
    every cell keeps its global id, so its dropout masks are the unsharded
    run's;
  * the blocks are gathered (`gather_grid`) and the padding cropped, so
    every rank returns the whole result; rank 0 alone writes files
    (`is_writer`), and the others wait at a `barrier`.

The backend follows a rule, never a failure: NCCL where every rank has a
card of its own, gloo on the CPU and wherever ranks share a card (NCCL
refuses two ranks on one card).  Gloo's collectives run on CPU copies of
the tensors.  A rank's card is `cuda:(LOCAL_RANK % device_count)`.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vit3d_ensemble_tpu_torch.models.vit3d import resolve_device

#: How to start the ranks a mesh needs, quoted by the errors below.
TORCHRUN = ("torchrun --standalone --nproc_per_node={n} -m "
            "vit3d_ensemble_tpu_torch.cli.train_baseline_cv --all_configs "
            "--mesh {spec} ...")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('model', 'data') mesh of the ranks of a process group.

    'model' shards the config / ensemble-combination axis, 'data' the folds
    or replicates.  `ranks_per_device` counts the ranks that share this
    rank's device (the grid divides the card's memory among them)."""

    n_model: int
    n_data: int
    rank: int
    device: torch.device
    backend: str
    ranks_per_device: int = 1
    group: Optional[object] = None        # None: the default group

    @property
    def shape(self) -> Dict[str, int]:
        return {"model": self.n_model, "data": self.n_data}

    @property
    def size(self) -> int:
        return self.n_model * self.n_data

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (model, data) coordinate."""
        return divmod(self.rank, self.n_data)


def choose_backend(device: torch.device, ranks_on_host: int) -> str:
    """NCCL when every rank of the host has a card of its own, else gloo."""
    if device.type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device=None) -> torch.device:
    """The device this process runs on: `device` (CUDA unless named); a
    CUDA device without an index, in a process group, is card
    LOCAL_RANK % device_count (the global rank where LOCAL_RANK is unset)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def init_distributed(device=None) -> bool:
    """Join the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, MASTER_ADDR, LOCAL_RANK, LOCAL_WORLD_SIZE), with the
    backend `choose_backend` gives; a group that is already initialised is
    taken as it is.  False where there is neither: one process."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return False
    device = resolve_device(device)
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    dist.init_process_group(choose_backend(device, on_host), init_method="env://")
    return True


def make_mesh(n_model: int, n_data: int, device=None, group=None) -> Mesh:
    """A ('model', 'data') mesh over the n_model·n_data ranks of `group`
    (the default group when None), on this rank's device (`rank_device`).
    Raises ValueError where no group is initialised or its size is not
    n_model·n_data, and where NCCL would put two ranks on one card."""
    n = n_model * n_data
    if not dist.is_initialized():
        raise ValueError(
            f"a {n_model}x{n_data} mesh needs {n} ranks of a process group, and "
            f"none is initialised: start them with "
            f"`{TORCHRUN.format(n=n, spec=f'{n_model}x{n_data}')}`")
    world = dist.get_world_size(group)
    if world != n:
        raise ValueError(f"a {n_model}x{n_data} mesh needs {n} ranks, the "
                         f"process group has {world}")
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = dist.get_backend(group)
    where: List = [None] * world
    dist.all_gather_object(where, (socket.gethostname(), str(device)), group=group)
    rank = dist.get_rank(group)
    sharing = sum(w == where[rank] for w in where)
    if backend == "nccl" and (device.type != "cuda" or sharing > 1):
        raise ValueError(f"NCCL needs a card for each rank; {sharing} ranks are "
                         f"on {device}: use gloo (`choose_backend`)")
    return Mesh(n_model, n_data, rank, device, backend, sharing, group)


def mesh_from_spec(spec, device=None) -> Optional[Mesh]:
    """Parse the CLI --mesh flag into a Mesh (None for one process).

    'MxN' -> a (M, N) mesh; 'auto' -> every rank of the process group
    (model axis 2 when their number is even, else 1); None / 'none' /
    '1x1' / '1' -> None.  A Mesh is returned as it is.  Joins torchrun's
    group first (`init_distributed`); 'MxN' with M·N > 1 and no group
    raises ValueError naming the torchrun command."""
    if isinstance(spec, Mesh):
        return spec
    if spec is None or str(spec).lower() in ("", "none", "1x1", "1"):
        return None
    if str(spec).lower() == "auto":
        n = dist.get_world_size() if init_distributed(device) else 1
        if n <= 1:
            return None
        n_model = 2 if n % 2 == 0 else 1
        return make_mesh(n_model, n // n_model, device)
    try:
        m, d = (int(tok) for tok in str(spec).lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh expects 'MxN' or 'auto', got {spec!r}")
    if m <= 0 or d <= 0:
        # a typo like '0x8' must not silently degrade to one process
        raise ValueError(f"--mesh axes must be positive, got {spec!r}")
    if m * d == 1:
        return None
    if not init_distributed(device):
        raise ValueError(
            f"--mesh {spec} needs {m * d} ranks and this process is alone: "
            f"start them with `{TORCHRUN.format(n=m * d, spec=spec)}`")
    return make_mesh(m, d, device)


# --- blocks of the grids --------------------------------------------------------


def padded(n: int, parts: int) -> int:
    """n rounded up to a multiple of parts."""
    return -(-n // parts) * parts


def block(n: int, parts: int, index: int) -> slice:
    """Part `index` of `parts` equal parts of an axis of length n."""
    if n % parts:
        raise ValueError(f"an axis of {n} does not split into {parts} parts")
    width = n // parts
    return slice(index * width, (index + 1) * width)


def rep_pad(a, n: int, axis: int = 0):
    """Pad `axis` of a numpy array or tensor to length n by repeating entry
    0 (`vit3d_ensemble_tpu/sweep/engine.py:297-305`): duplicate work, cropped
    from the results, where a mesh axis does not divide the true length."""
    have = a.shape[axis]
    if have == n:
        return a
    index = np.concatenate([np.arange(have), np.zeros(n - have, np.int64)])
    if isinstance(a, torch.Tensor):
        return torch.index_select(a, axis, torch.as_tensor(index, device=a.device))
    return np.take(a, index, axis=axis)


def sweep_shardings(mesh: Mesh) -> Tuple[Callable, Callable, Callable]:
    """The sweep's sharding rules (`mesh.py:61-75`) as this rank's slicers:
    (param, fold, replicated).  `param` takes the (model, data) block of a
    stacked (G, F, ...) array, `fold` the data block of a per-fold (F, ...)
    array (every model coordinate holds the same), `replicated` the whole:
    the volume pool, which every rank reads in full."""
    m, d = mesh.coords

    def param(a):
        return a[block(a.shape[0], mesh.n_model, m), block(a.shape[1], mesh.n_data, d)]

    def fold(a):
        return a[block(a.shape[0], mesh.n_data, d)]

    def replicated(a):
        return a

    return param, fold, replicated


def shard_group_inputs(mesh: Mesh, params: Dict, cell_ids, data_arrays: Dict):
    """This rank's block of the sweep engine's inputs (`mesh.py:78-89`):
    the stacked (G, F, ...) params and (G, F) cell ids by (model, data), the
    per-fold arrays by data, the array under 'pool' whole."""
    param, fold, replicated = sweep_shardings(mesh)
    return ({k: param(v) for k, v in params.items()}, param(cell_ids),
            {k: (replicated if k == "pool" else fold)(v)
             for k, v in data_arrays.items()})


# --- collectives ----------------------------------------------------------------


def _on_wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective takes: gloo's a CPU copy."""
    return t if mesh.backend == "nccl" else t.cpu()


def gather_grid(mesh: Mesh, local: torch.Tensor, dst: Optional[int] = None):
    """Every rank's (g, f, ...) block of a (model, data) grid, assembled into
    (M·g, N·f, ...) on the block's device: on every rank, or with `dst` on
    that rank alone (None on the others)."""
    t = local.contiguous()
    wire = _on_wire(mesh, t)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    if dst is None:
        dist.all_gather(parts, wire, group=mesh.group)
    else:
        dist.gather(wire, parts if mesh.rank == dst else None, dst=dst,
                    group=mesh.group)
        if mesh.rank != dst:
            return None
    g, f = t.shape[:2]
    grid = torch.stack(parts).reshape(mesh.n_model, mesh.n_data, g, f, *t.shape[2:])
    return grid.transpose(1, 2).reshape(mesh.n_model * g, mesh.n_data * f,
                                        *t.shape[2:]).to(t.device)


def all_min(mesh: Optional[Mesh], values: Sequence[int]) -> List[int]:
    """Each value's minimum over the mesh's ranks (the values themselves
    without a mesh): how the ranks agree on a chunk or a resume."""
    if mesh is None:
        return list(values)
    t = _on_wire(mesh, torch.tensor(list(values), dtype=torch.int64,
                                    device=mesh.device))
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return t.tolist()


def is_writer() -> bool:
    """True in the process that writes files: rank 0 of the process group,
    or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the process group (nothing without one)."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


# --- data-parallel training -----------------------------------------------------


def make_dp_train_step(model, optimizer, mesh: Mesh, balanced_weights: bool = True,
                       scheduler=None):
    """One model's data-parallel training step over the WHOLE mesh
    (`mesh.py:92-127`): the batch splits over all M·N ranks ('model' and
    'data' both act as data axes), the parameters are replicated, and the
    gradients are summed, so the step equals the one-device step on the
    whole batch.

    The masked mean and `masked_balanced_pos_weight` (`train/steps.py`)
    are taken over the GLOBAL batch: the rows and positives are summed over
    the ranks before the loss, each rank's loss is its rows' sum over the
    global count, and the sum of those is the one-device loss.  Every rank
    then takes the same optimizer step from the same summed gradients, so
    the replicas stay equal bit for bit.

    Returns (step, shard): `shard(a)` is this rank's rows of a global
    batch; `step(vols, labels, mask, generator=None)` trains on this rank's
    rows and returns the global batch's loss.  Dropout draws from
    `generator` on each rank."""
    import torch.nn.functional as F

    params = [p for p in model.parameters() if p.requires_grad]

    def shard(a):
        return a[block(a.shape[0], mesh.size, mesh.rank)]

    def all_sum(t: torch.Tensor) -> torch.Tensor:
        wire = _on_wire(mesh, t)
        dist.all_reduce(wire, group=mesh.group)
        return wire.to(t.device)

    def step(vols, labels, mask, generator=None) -> torch.Tensor:
        logits = model(vols, deterministic=False, generator=generator).logits.reshape(-1)
        y = labels.reshape(-1).to(logits.dtype)
        m = mask.reshape(-1).to(logits.dtype)
        n, n_pos = all_sum(torch.stack([m.sum(), (y * m).sum()]).detach())
        if balanced_weights:
            n_neg = n - n_pos
            pw = torch.where((n_pos > 0) & (n_neg > 0),
                             n / (2.0 * torch.clamp(n_pos, min=1.0)), torch.ones_like(n))
        else:
            pw = 1.0
        per = -(pw * y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits))
        loss = torch.sum(per * m) / torch.clamp(n, min=1.0)
        optimizer.zero_grad()
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = all_sum(torch.cat([g.reshape(-1) for g in grads]))
        for p, g in zip(params, torch.split(flat, [q.numel() for q in params])):
            p.grad = g.view_as(p).clone()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return all_sum(loss.detach())

    return step, shard

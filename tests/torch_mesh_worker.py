"""Rank processes for the port's mesh tests (`tests/test_torch_parallel.py`).

`run_ranks` starts `world` processes with `torch.multiprocessing` (start
method spawn: the test process has JAX's threads, and fork is unsafe
there), each joining a gloo group through a `file://` store under the
test's directory, on one torch thread.  Each rank runs the named jobs of
`JOBS` in turn and saves what they return; the parent reads every rank's
results.  This module imports no JAX, so neither do the ranks.

A job runs inside `patched(spec)`, which makes the port draw what the JAX
run it is held to drew and narrows its configs; the parent takes its own
one-process runs inside the same context.  Its keys:
  * "grid": {conf: (patch, mlp, layers, hidden, heads)} into `configs.GRID`;
  * "dropout0": every config at dropout 0 (`ViTConfig.from_conf` and the
    sweep's groups);
  * "group_inits": {confs: stacked state (G, F_max, ...)}, the init of each
    grouped run (`engine.init_group_params`), its first F folds;
  * "template_heads": {(k, seed): (weight, bias)} for the grid's meta head;
  * "meta_heads": {(C, F, k, seed): (w, b)} for the frozen sweep's heads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: Seconds the ranks may take in all before they are stopped.
TIMEOUT = 600


@contextlib.contextmanager
def patched(spec: dict):
    """The port as `spec` describes it (see the module's docstring), put
    back as it was on exit."""
    import vit3d_ensemble_tpu_torch.configs as configs
    from vit3d_ensemble_tpu_torch.configs import ViTConfig
    from vit3d_ensemble_tpu_torch.sweep import e2e_grid, engine, ensemble_sweep

    undo = []

    def setattr_(obj, name, value):
        undo.append((obj, name, obj.__dict__.get(name) if isinstance(obj, type)
                     else getattr(obj, name)))
        setattr(obj, name, value)

    saved_grid = dict(configs.GRID)
    try:
        configs.GRID.update(spec.get("grid", {}))
        if spec.get("dropout0"):
            real = ViTConfig.from_conf
            setattr_(ViTConfig, "from_conf", classmethod(
                lambda c, conf, img_size=128, **kw: real(
                    conf, img_size=img_size, **{**kw, "dropout_rate": 0.0})))
            real_groups = engine.group_configs
            setattr_(engine, "group_configs", lambda confs: [
                dataclasses.replace(g, dropout_rate=0.0) for g in real_groups(confs)])
        inits = spec.get("group_inits")
        if inits is not None:
            setattr_(engine, "init_group_params",
                     lambda group, n_folds, seed, img_size=128, device=None: {
                         k: v[:, :n_folds].clone().to(device)
                         for k, v in inits[group.confs].items()})
        heads = spec.get("template_heads")
        if heads is not None:
            setattr_(e2e_grid, "_template_head", lambda k, nc, seed: tuple(
                torch.as_tensor(a).clone() for a in heads[(k, seed)]))
        meta = spec.get("meta_heads")
        if meta is not None:
            setattr_(ensemble_sweep, "init_meta_heads",
                     lambda C, F, k, seed: tuple(a.copy() for a in meta[(C, F, k, seed)]))
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
        configs.GRID.clear()
        configs.GRID.update(saved_grid)


# --- the jobs ---------------------------------------------------------------------


def _mesh(job):
    from vit3d_ensemble_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(*job["mesh"], device="cpu")


def job_mesh(job):
    """The mesh's shape and this rank's place; the errors of a wrong size
    and of a wrong spec; `mesh_from_spec`'s parses inside the group."""
    from vit3d_ensemble_tpu_torch.parallel.mesh import make_mesh, mesh_from_spec

    mesh = _mesh(job)
    errors = []
    for bad in ((4, 4), (1, 2)):
        try:
            make_mesh(*bad, device="cpu")
        except ValueError as exc:
            errors.append(str(exc))
    specs = {s: (None if m is None else (m.shape, m.coords, m.backend))
             for s in ("none", "1x1", "2x2", "auto")
             for m in [mesh_from_spec(s, "cpu")]}
    return dict(shape=mesh.shape, size=mesh.size, coords=mesh.coords, rank=mesh.rank,
                device=str(mesh.device), backend=mesh.backend,
                ranks_per_device=mesh.ranks_per_device, errors=errors, specs=specs)


def job_partition(job):
    """This rank's blocks of `shard_group_inputs`."""
    from vit3d_ensemble_tpu_torch.parallel.mesh import shard_group_inputs

    params, ids, arrays = shard_group_inputs(_mesh(job), job["params"], job["ids"],
                                             job["arrays"])
    return dict(params=params, ids=ids, arrays=arrays)


def job_run_group(job):
    from vit3d_ensemble_tpu_torch.sweep import engine

    res = engine.run_group(job["group"], job["data"], job["hyper"],
                           img_size=job["img"], mesh=_mesh(job), device="cpu")
    return dict(best_metrics=res.best_metrics, best_probs=res.best_probs,
                final_loss=res.final_loss, losses=res.losses,
                best_params={k: v.detach().cpu() for k, v in res.best_params.items()})


def job_run_group_resume(job):
    """A sharded run killed after its first segment and resumed, and again
    with rank 1's snapshot truncated (every rank then restarts), beside the
    uninterrupted run: each rank's losses."""
    from vit3d_ensemble_tpu_torch.sweep import engine

    mesh = _mesh(job)
    hyper = dataclasses.replace(job["hyper"], snapshot_every=1)

    def run(**kw):
        return engine.run_group(job["group"], job["data"], hyper, img_size=job["img"],
                                mesh=mesh, device="cpu", state_path=job["state"], **kw)

    def killed():
        try:
            run(_abort_after_segments=1)
        except engine.SimulatedPreemption:
            return True
        return False

    out = {"full": engine.run_group(job["group"], job["data"], hyper, img_size=job["img"],
                                    mesh=mesh, device="cpu").losses}
    out["killed"] = killed()
    out["resumed"] = run(resume=True).losses
    out["killed_again"] = killed()
    if mesh.rank == 1:
        root, ext = os.path.splitext(job["state"])
        with open(f"{root}_r1{ext}", "wb") as f:
            f.write(b"truncated")
    dist.barrier()
    out["restarted"] = run(resume=True).losses
    dist.barrier()                  # every rank has removed its snapshot
    out["left"] = sorted(os.listdir(os.path.dirname(job["state"])))
    return out


def job_driver(job):
    """A driver's `main(argv)`, every rank in the same output directory."""
    driver = importlib.import_module(f"vit3d_ensemble_tpu_torch.cli.{job['driver']}")
    return driver.main(job["argv"])


def job_meta_sweep(job):
    from vit3d_ensemble_tpu_torch.sweep import ensemble_sweep

    return ensemble_sweep.train_meta_sweep(*job["args"], job["hyper"], mesh=_mesh(job),
                                           device="cpu")


def job_dp_step(job):
    """`make_dp_train_step` for job["steps"] SGD-momentum steps of one model
    from job["state"], on this rank's rows of the global batch."""
    from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
    from vit3d_ensemble_tpu_torch.parallel import make_dp_train_step
    from vit3d_ensemble_tpu_torch.train.optim import sgd_momentum

    mesh = _mesh(job)
    model = VisionTransformer3D(job["config"], vis=False, device="cpu")
    model.load_state_dict(job["state"])
    opt, sched = sgd_momentum(model.parameters(), job["lr"], lambda step: 1.0)
    step, shard = make_dp_train_step(model, opt, mesh, scheduler=sched)
    vols, labels, mask = (shard(torch.as_tensor(job[k])) for k in ("vols", "labels", "mask"))
    losses = [float(step(vols, labels, mask)) for _ in range(job["steps"])]
    return dict(losses=losses, rows=len(vols),
                params={k: v.detach().clone() for k, v in model.state_dict().items()})


JOBS = {"mesh": job_mesh, "partition": job_partition, "run_group": job_run_group,
        "run_group_resume": job_run_group_resume, "driver": job_driver,
        "meta_sweep": job_meta_sweep, "dp_step": job_dp_step}


# --- the ranks ------------------------------------------------------------------


def _rank(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(root, "jobs.pkl"), "rb") as f:
            jobs = pickle.load(f)
        out = {}
        for name, job in jobs.items():
            try:
                with patched(job.get("patches", {})):
                    out[name] = JOBS[job["kind"]](job)
            except Exception:  # noqa: BLE001 - reported to the parent, which fails
                out[name] = {"error": traceback.format_exc()}
                raise
            finally:
                torch.save(out, os.path.join(root, f"rank{rank}.pt"))
            dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, jobs: dict, root) -> list:
    """Run `jobs` ({name: {"kind": ..., ...}}) in `world` gloo ranks, one
    after another; returns each rank's {name: result}.  A rank that fails
    fails the run, with its traceback."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "jobs.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    ctx = mp.start_processes(_rank, args=(world, root), nprocs=world, join=False,
                             start_method="spawn")
    import time

    deadline = time.monotonic() + TIMEOUT
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {world} ranks ran over {TIMEOUT} s")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def gather_equal(results: list, name: str):
    """The result every rank returned for `name`, checked equal across the
    ranks (every rank returns the whole result)."""
    first = results[0][name]
    for other in results[1:]:
        _assert_same(first, other[name], name)
    return first


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where

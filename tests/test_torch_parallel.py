"""The port's mesh path (`parallel/mesh.py`) in four gloo ranks on the CPU,
against the port's one-process runs and the JAX package's mesh runs.

The counterpart of `tests/test_parallel.py`, test for test.  The ranks are
spawned once for the module (`tests/torch_mesh_worker.py`: start method
spawn, a `file://` store, one torch thread each, no JAX) on a 2 x 2 mesh,
and run every job in turn; the parent first runs each job's JAX
counterpart on a 2 x 2 mesh of its 8 virtual CPU devices, which also gives
the port the JAX run's inits (`torch_mesh_worker.patched`).  Shapes pad
both axes: 3 folds or replicates on a data axis of 2, 3 configs, 1
combination or 9 heads on a model axis of 2.  Dropout is 0 where JAX is
compared.  Each result is held against the port's one-process run within
1e-6 and against JAX at JAX's mesh tolerances (`tests/test_parallel.py`):
rtol 1e-4, atol 1e-5 for `run_group`, the CLIs and the grid, 1e-5 / 1e-6
for the meta sweep; the data-parallel step within 1e-5 of JAX's after 3
SGD-momentum steps.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import vit3d_ensemble_tpu.configs as jax_configs
import vit3d_ensemble_tpu.sweep.e2e_grid as jax_grid
from vit3d_ensemble_tpu.cli import train_baseline_cv as jax_cv
from vit3d_ensemble_tpu.cli import train_ensemble_bootstrap as jax_ens_boot
from vit3d_ensemble_tpu.cli import train_ensemble_cv as jax_ens_cv
from vit3d_ensemble_tpu.configs import ViTConfig as JaxViTConfig
from vit3d_ensemble_tpu.models import VisionTransformer3D as JaxVisionTransformer3D
from vit3d_ensemble_tpu.parallel import make_dp_train_step as jax_dp_step
from vit3d_ensemble_tpu.parallel import make_mesh as jax_make_mesh
from vit3d_ensemble_tpu.sweep import engine as jax_engine
from vit3d_ensemble_tpu.sweep import ensemble_sweep as jax_sweep
from vit3d_ensemble_tpu.sweep import stack as jax_stack
from vit3d_ensemble_tpu.train.optim import sgd_momentum as jax_sgd
from vit3d_ensemble_tpu_torch.checkpoint import vit_state_from_flax
from vit3d_ensemble_tpu_torch.cli import train_baseline_cv as cv_driver
from vit3d_ensemble_tpu_torch.cli import train_ensemble_bootstrap as ens_boot_driver
from vit3d_ensemble_tpu_torch.cli import train_ensemble_cv as ens_cv_driver
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
from vit3d_ensemble_tpu_torch.parallel import mesh_from_spec
from vit3d_ensemble_tpu_torch.sweep import engine, ensemble_sweep, stack
from vit3d_ensemble_tpu_torch.train.optim import sgd_momentum
from vit3d_ensemble_tpu_torch.train.steps import (
    masked_balanced_pos_weight,
    masked_bce_with_logits,
)

import test_torch_ensemble_cli as ens
from test_torch_e2e_grid import _jax_heads, _port_cfg
from test_torch_sweep import _fold_data, _stacked_state
from torch_mesh_worker import gather_equal, patched, run_ranks

IMG = 32
WORLD = 4
MESH = (2, 2)
#: the mesh against the port's one-process run
ONE_ATOL = 1e-6
#: JAX's mesh tolerances (`tests/test_parallel.py:93-94,148-152,176-177`)
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5
#: the meta sweep's (`tests/test_parallel.py:209-210`)
META_RTOL, META_ATOL = 1e-5, 1e-6
#: the data-parallel step's parameters after 3 steps, against JAX's
DP_ATOL = 1e-5
HYPER = ["--num_steps", "4", "--eval_every", "2", "--warmup_steps", "2",
         "--learning_rate", "0.05", "--img_size", str(IMG)]
#: three configs of one class, of three widths and depths: the model axis
#: of 2 pads them to 4
TINY3 = {101: (16, 32, 2, 16, 4), 102: (16, 48, 3, 16, 4), 103: (16, 40, 1, 16, 4)}
#: every conf narrowed into one (16, 4) class of two widths and two depths,
#: so that each sweep compiles one JAX program
NARROW = {conf: (ps, (32, 48)[conf % 2], 1 + (conf % 4 == 0), 16, 4)
          for conf, (ps, *_) in jax_configs.GRID.items()}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's one-process runs (as the ranks)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_mesh():
    return jax_make_mesh(*MESH)


def _close(a, b, rtol, atol, where=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol, err_msg=where)


def _close_nested(a, b, rtol, atol, where=""):
    """Nested {name: {fold: {metric: value}}} dicts (or tuples of them),
    key for key."""
    if isinstance(b, dict):
        assert list(a) == list(b), where
        for k in b:
            _close_nested(a[k], b[k], rtol, atol, f"{where} {k}")
    elif isinstance(b, tuple):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close_nested(x, y, rtol, atol, f"{where} [{i}]")
    else:
        _close(a, b, rtol, atol, where)


def _jax_no_dropout(mp):
    """JAX's configs and group templates at dropout 0."""
    real = JaxViTConfig.from_conf
    mp.setattr(JaxViTConfig, "from_conf", classmethod(
        lambda c, conf, img_size=128, **kw: real(
            conf, img_size=img_size, **{**kw, "dropout_rate": 0.0})))
    real_template = jax_stack.ConfigGroup.template_config
    mp.setattr(jax_stack.ConfigGroup, "template_config",
               lambda self, img_size=128: dataclasses.replace(
                   real_template(self, img_size), dropout_rate=0.0))


def _record_group_inits(mp):
    """{confs: JAX params (G, F_pad, ...) as the port's stacked state}: each
    grouped run's init, recorded from JAX's `init_group_params`."""
    inits = {}
    real = jax_engine.init_group_params

    def record(group, n_folds, seed, img_size=128):
        params = real(group, n_folds, seed, img_size)
        inits[group.confs] = _stacked_state(
            jax.device_get(params), _port_cfg(group.template_config(img_size)),
            (len(group.confs), n_folds))
        return params

    mp.setattr(jax_engine, "init_group_params", record)
    return inits


def _record_template_heads(mp):
    """{(k, seed): (weight, bias)} of the JAX grid's template meta head."""
    heads = {}
    real = jax_grid.init_ensemble

    def record(sig_cfgs, member_params, seed):
        model, params = real(sig_cfgs, member_params, seed)
        meta = jax.device_get(params)["meta"]["classifier"]
        heads[(len(sig_cfgs), seed)] = (np.asarray(meta["kernel"]).T.copy(),
                                        np.asarray(meta["bias"]).copy())
        return model, params

    mp.setattr(jax_grid, "init_ensemble", record)
    return heads


def _paths(root, out, csv_sub):
    return ["--csv_path", str(root / "csv_files" / csv_sub),
            "--data_root", str(root / "dataset"), "--output_dir", str(out)]


# --- each job's JAX run, then the ranks --------------------------------------------


def _prepare_run_group(root, mp):
    """`run_group` alone, no JAX run: 3 configs of three widths and depths
    and 3 folds (both axes padded on the 2 x 2 mesh), with dropout 0 and
    with dropout on (each cell's stream keyed on its global id, so the mesh
    draws the one-process run's masks).  Its JAX counterpart is the group
    that `_prepare_cli_sweep` records."""
    group = stack.ConfigGroup(hidden_size=16, num_heads=4, confs=(101, 102, 103),
                              mlp_dims=(32, 48, 40), num_layers=(2, 3, 1))
    pool, folds = _fold_data(5, folds=3)
    hyper = engine.SweepHyper(num_steps=4, eval_every=2, train_batch_size=2,
                              learning_rate=0.05, warmup_steps=2, seed=0)
    job = dict(kind="run_group", mesh=MESH, img=IMG, group=group,
               data=engine.stack_folds(pool, folds, hyper), hyper=hyper,
               patches={"grid": TINY3})
    (root / "snapshots").mkdir()
    return None, {"run_group_dropout": job,
                  "run_group_no_dropout": dict(job, group=dataclasses.replace(
                      group, dropout_rate=0.0)),
                  "run_group_resume": dict(job, kind="run_group_resume",
                                           state=str(root / "snapshots" / "group.pt"))}


def _prepare_cli_sweep(root, mp):
    """JAX's `train_baseline_cv --all_configs --mesh 2x2`, with its
    `run_group` call recorded: the group of 18 narrowed configs on 3 folds,
    its data, hyperparameters, init and results, which `run_group`'s job
    takes as its JAX counterpart."""
    for conf, row in NARROW.items():
        mp.setitem(jax_configs.GRID, conf, row)
    _jax_no_dropout(mp)
    inits = _record_group_inits(mp)
    calls = []
    real = jax_engine.run_group

    def record(group, data, hyper, *a, **k):
        res = real(group, data, hyper, *a, **k)
        calls.append((group, data, hyper, res))
        return res

    mp.setattr(jax_engine, "run_group", record)
    argv = ["--all_configs", "--num_cv", "3", *HYPER]
    ref = jax_cv.main([*argv, "--mesh", "2x2",
                       *_paths(root, root / "cli_jax", "cross_validation")])
    patches = {"grid": NARROW, "dropout0": True, "group_inits": inits}
    job = dict(kind="driver", driver="train_baseline_cv",
               argv=[*argv, "--device", "cpu", "--mesh", "2x2",
                     *_paths(root, root / "cli_mesh", "cross_validation")],
               one_argv=[*argv, "--device", "cpu",
                         *_paths(root, root / "cli_one", "cross_validation")],
               patches=patches)
    (jgroup, jdata, jhyper, res), = calls
    group = stack.ConfigGroup(jgroup.hidden_size, jgroup.num_heads, jgroup.confs,
                              jgroup.mlp_dims, jgroup.num_layers, dropout_rate=0.0)
    with patched({"grid": NARROW}):
        template = group.template_config(IMG)
    rg = dict(best_metrics=np.asarray(res.best_metrics),
              best_probs=np.asarray(res.best_probs),
              final_loss=np.asarray(res.final_loss),
              best_params=_stacked_state(jax.device_get(res.best_params), template,
                                         np.asarray(res.best_metrics).shape[:2]))
    rg_job = dict(kind="run_group", mesh=MESH, img=IMG, group=group,
                  data=engine.FoldData(**{f.name: np.asarray(getattr(jdata, f.name))
                                          for f in dataclasses.fields(jdata)}),
                  hyper=engine.SweepHyper(**dataclasses.asdict(jhyper)),
                  patches=patches)
    return {"cli": ref, "run_group": rg}, {"cli_sweep": job, "run_group": rg_job}


def _ensemble_dirs(root, names, confs):
    with patched({"grid": NARROW}):
        for name in names:
            ens._baselines(root / name, confs)


def _prepare_grid(root, mp):
    for conf, row in NARROW.items():
        mp.setitem(jax_configs.GRID, conf, row)
    _jax_no_dropout(mp)
    heads = _record_template_heads(mp)
    _ensemble_dirs(root, ("grid_jax", "grid_mesh", "grid_one"), (1, 2, 3))
    argv = ["--max_configs", "4", "--num_rep", "3", "--save_ensembles", *ens.ENSEMBLE]
    ref = jax_ens_boot.main([*argv, "--mesh", "2x2",
                             *_paths(root, root / "grid_jax", "fixed_split")])
    job = dict(kind="driver", driver="train_ensemble_bootstrap",
               argv=[*argv, "--device", "cpu", "--mesh", "2x2",
                     *_paths(root, root / "grid_mesh", "fixed_split")],
               one_argv=[*argv, "--device", "cpu",
                         *_paths(root, root / "grid_one", "fixed_split")],
               patches={"grid": NARROW, "dropout0": True, "template_heads": heads})
    return ref, {"grid": job}


def _prepare_frozen(root, mp):
    for conf, row in NARROW.items():
        mp.setitem(jax_configs.GRID, conf, row)
    _jax_no_dropout(mp)
    confs = (1, 2, 3, 4, 5)
    _ensemble_dirs(root, ("frozen_jax", "frozen_mesh", "frozen_one"), confs)
    argv = ["--frozen", "--max_configs", "6", "--num_cv", "3", *ens.ENSEMBLE]
    ref = jax_ens_cv.main([*argv, "--mesh", "2x2",
                           *_paths(root, root / "frozen_jax", "cross_validation")])
    job = dict(kind="driver", driver="train_ensemble_cv",
               argv=[*argv, "--device", "cpu", "--mesh", "2x2",
                     *_paths(root, root / "frozen_mesh", "cross_validation")],
               one_argv=[*argv, "--device", "cpu",
                         *_paths(root, root / "frozen_one", "cross_validation")],
               patches={"grid": NARROW, "dropout0": True,
                        "meta_heads": {(10, 3, 3, 42): _jax_heads(10, 3, 3, 42)}})
    return ref, {"frozen": job}


def _meta_args():
    """9 combinations of 5 confs (model axis 2: padded to 10), 3 folds (data
    axis 2: padded to 4), uneven training rows."""
    rng = np.random.default_rng(7)
    n_confs, F, N, V = 5, 3, 12, 8
    labels = (rng.random((F, N)) > 0.5).astype(np.float32)
    mask = np.ones((F, N), np.float32)
    mask[2, 9:] = 0
    TL = (rng.normal(size=(F, n_confs, N)) + 2 * labels[:, None] - 1).astype(np.float32)
    VY = np.tile([0.0, 1.0], V // 2).astype(np.float32)[None].repeat(F, 0)
    VL = (rng.normal(size=(F, n_confs, V)) + VY[:, None]).astype(np.float32)
    combos = ensemble_sweep.all_combinations(n_confs + 1)[:9]
    return (combos, TL * mask[:, None], labels * mask, mask, VL, VY,
            np.ones((F, V), np.float32), {c: c - 1 for c in range(1, n_confs + 1)})


def _prepare_meta(root, mp):
    args = _meta_args()
    hyper = ensemble_sweep.MetaHyper(num_epochs=3, train_batch_size=4)
    ref = jax_sweep.train_meta_sweep(*args, jax_sweep.MetaHyper(**dataclasses.asdict(hyper)),
                                     mesh=_jax_mesh())
    job = dict(kind="meta_sweep", mesh=MESH, args=args, hyper=hyper,
               patches={"meta_heads": {(9, 3, 3, 42): _jax_heads(9, 3, 3, 42)}})
    return ref, {"meta_sweep": job}


DP_CONFIG = dict(patch_size=(16, 16, 5), hidden_size=16, num_heads=4, mlp_dim=32,
                 num_layers=2, img_size=IMG, dropout_rate=0.0)
DP_STEPS = 3
DP_LR = 1e-2


def _dp_batch():
    """A global batch of 8, 2 rows a rank, whose shards differ in label
    balance and in masked rows: an average of the ranks' losses is not the
    batch's loss."""
    rng = np.random.default_rng(1)
    vols = rng.normal(size=(8, IMG, IMG, 5, 1)).astype(np.float32)
    labels = np.array([1, 1, 0, 0, 1, 0, 0, 1], np.float32)
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32)
    return vols, labels, mask


def _prepare_dp(root, mp):
    cfg = JaxViTConfig(**DP_CONFIG)
    model = JaxVisionTransformer3D(cfg, zero_head=False, vis=False)

    @jax.jit
    def init():
        return model.init({"params": jax.random.key(0)},
                          jax.numpy.zeros((1, IMG, IMG, 5, 1)))["params"]

    params = init()
    state = vit_state_from_flax(jax.device_get(params), ViTConfig(**DP_CONFIG))
    tx = jax_sgd(lambda c: DP_LR)
    opt_state = tx.init(params)
    step, sharding = jax_dp_step(model, tx, _jax_mesh())
    vols, labels, mask = (jax.device_put(jax.numpy.asarray(a), sharding)
                          for a in _dp_batch())
    for _ in range(DP_STEPS):
        params, opt_state, _ = step(params, opt_state, vols, labels, mask,
                                    jax.random.key(2))
    ref = vit_state_from_flax(jax.device_get(params), ViTConfig(**DP_CONFIG))
    vols, labels, mask = _dp_batch()
    job = dict(kind="dp_step", mesh=MESH, config=ViTConfig(**DP_CONFIG), state=state,
               lr=DP_LR, steps=DP_STEPS, vols=vols, labels=labels, mask=mask)
    return ref, {"dp_step": job}


def _prepare_partition(root, mp):
    params = {"w": torch.arange(2 * 4 * 3 * 3, dtype=torch.float32).reshape(2, 4, 3, 3)}
    ids = np.arange(8).reshape(2, 4)
    arrays = {"pool": np.arange(10, dtype=np.float32).reshape(5, 2),
              "val_idx": np.arange(24).reshape(4, 6)}
    job = dict(kind="partition", mesh=MESH, params=params, ids=ids, arrays=arrays)
    return None, {"partition": job, "mesh": dict(kind="mesh", mesh=MESH)}


PREPARE = (_prepare_partition, _prepare_run_group, _prepare_meta, _prepare_dp,
           _prepare_cli_sweep, _prepare_grid, _prepare_frozen)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every job's JAX reference, then one run of the 4 ranks over all jobs:
    (refs by prepare function, jobs, each rank's results)."""
    from __graft_entry__ import _synth_dataset

    root = tmp_path_factory.mktemp("torch_mesh")
    _synth_dataset(str(root), img=IMG, num_cv=3, fixed_split=True)
    refs, jobs = {}, {}
    for prepare in PREPARE:
        with pytest.MonkeyPatch.context() as mp:
            ref, made = prepare(root, mp)
        refs[prepare.__name__[len("_prepare_"):]] = ref
        jobs.update(made)
    ranks = run_ranks(WORLD, jobs, root / "ranks")
    return root, refs, jobs, ranks


def _one_process(job):
    """The job's driver in this process, without a mesh."""
    driver = {"train_baseline_cv": cv_driver, "train_ensemble_bootstrap": ens_boot_driver,
              "train_ensemble_cv": ens_cv_driver}[job["driver"]]
    with patched(job["patches"]):
        return driver.main(job["one_argv"])


# --- the tests, one for each of tests/test_parallel.py's ----------------------------


def test_make_mesh_shape(world):
    """A 2 x 2 mesh of the 4 ranks, rank r at (r // 2, r % 2) on the CPU
    over gloo; a mesh of another size raises ValueError."""
    _, _, _, ranks = world
    for r, res in enumerate(ranks):
        got = res["mesh"]
        assert got["shape"] == {"model": 2, "data": 2} and got["size"] == 4
        assert got["rank"] == r and got["coords"] == (r // 2, r % 2)
        assert (got["device"], got["backend"], got["ranks_per_device"]) == ("cpu", "gloo", 4)
        assert len(got["errors"]) == 2
        assert all("needs" in e and "has 4" in e for e in got["errors"])


def test_sweep_sharded_run_group(world):
    """`run_group` on the 2 x 2 mesh: every rank returns the whole result,
    equal to the one-process run within 1e-6 (3 configs and 3 folds, both
    padded to 4, dropout 0 and on; the 18-config group of the CLI sweep)
    and to JAX's mesh run at its tolerances (that group, recorded from
    JAX's `train_baseline_cv --all_configs --mesh 2x2`)."""
    _, refs, jobs, ranks = world
    for name in ("run_group_no_dropout", "run_group_dropout", "run_group"):
        got = gather_equal(ranks, name)
        job = jobs[name]
        with patched(job["patches"]):
            one = engine.run_group(job["group"], job["data"], job["hyper"],
                                   img_size=IMG, device="cpu")
        G, F = len(job["group"].confs), job["data"].n_folds
        assert got["best_metrics"].shape == (G, F, 11)
        assert got["losses"].shape == (job["hyper"].num_steps, G, F)
        for k in ("best_metrics", "best_probs", "final_loss", "losses"):
            _close(got[k], getattr(one, k), 0, ONE_ATOL, f"{name} {k}")
        for k, v in one.best_params.items():
            assert got["best_params"][k].shape == v.shape, k
            _close(got["best_params"][k], v.detach(), 0, ONE_ATOL, f"{name} {k}")
    ref = refs["cli_sweep"]["run_group"]
    for k in ("best_metrics", "best_probs", "final_loss"):
        _close(got[k], ref[k], JAX_RTOL, JAX_ATOL, k)
    for k, v in ref["best_params"].items():
        _close(got["best_params"][k], v, JAX_RTOL, JAX_ATOL, k)


def test_sharded_run_group_resumes_on_every_rank(world):
    """Preemption under the mesh, dropout on: each rank snapshots its own
    block (`group_r{rank}.pt`); resumed, every rank gives the uninterrupted
    run's losses exactly; with one rank's snapshot truncated, every rank
    restarts (none resumes alone) and gives them again; no snapshot is
    left."""
    _, _, _, ranks = world
    for res in ranks:
        got = res["run_group_resume"]
        assert got["killed"] and got["killed_again"]
        np.testing.assert_array_equal(got["resumed"], got["full"])
        np.testing.assert_array_equal(got["restarted"], got["full"])
        assert got["left"] == []
    _close(ranks[0]["run_group_resume"]["full"],
           gather_equal(ranks, "run_group_dropout")["losses"], 0, 0)


def test_cli_sweep_with_mesh(world):
    """`train_baseline_cv --all_configs --mesh 2x2` (3 folds on a data axis
    of 2) returns the one-process run's results within 1e-6 on every rank
    and JAX's `--mesh 2x2` run's at its tolerances; rank 0 wrote every
    checkpoint and marker, under the mesh's state name."""
    root, refs, jobs, ranks = world
    got = gather_equal(ranks, "cli_sweep")
    one = _one_process(jobs["cli_sweep"])
    assert sorted(got) == sorted(one) == list(range(1, 19))
    _close_nested(got, one, 0, ONE_ATOL)
    _close_nested(got, refs["cli_sweep"]["cli"], JAX_RTOL, JAX_ATOL)
    for conf in (1, 9, 18):
        assert (root / "cli_mesh" / "cv_baseline_models" / f"conf{conf}" / "cv3.bin").exists()
    assert sorted(os.listdir(root / "cli_mesh" / "sweep_state")) == sorted(
        os.listdir(root / "cli_one" / "sweep_state"))


def test_shard_group_inputs_true_partitioning(world):
    """Each rank's block is exactly its 1/4 of the stacked params and cell
    ids and its half of the per-fold arrays, the four blocks tile the
    arrays, and the pool is whole on every rank."""
    _, _, jobs, ranks = world
    job = jobs["partition"]
    w = job["params"]["w"]
    seen = torch.zeros_like(w)
    for r, res in enumerate(ranks):
        got = res["partition"]
        m, d = divmod(r, 2)
        block = got["params"]["w"]
        assert block.shape == (1, 2, 3, 3)
        assert torch.equal(block, w[m:m + 1, 2 * d:2 * d + 2])
        seen[m:m + 1, 2 * d:2 * d + 2] += 1
        np.testing.assert_array_equal(got["ids"], job["ids"][m:m + 1, 2 * d:2 * d + 2])
        np.testing.assert_array_equal(got["arrays"]["val_idx"],
                                      job["arrays"]["val_idx"][2 * d:2 * d + 2])
        np.testing.assert_array_equal(got["arrays"]["pool"], job["arrays"]["pool"])
    assert torch.all(seen == 1)


def test_cli_bootstrap_e2e_grid_with_mesh(world):
    """`train_ensemble_bootstrap` in its grid mode under --mesh 2x2 (one
    combination on a model axis of 2, 3 replicates on a data axis of 2):
    val and held-out test metrics within 1e-6 of the one-process run's on
    every rank and at JAX's tolerances of its `--mesh 2x2` run's; rank 0
    wrote the replicates' checkpoints, equal to the one-process run's."""
    root, refs, jobs, ranks = world
    val, test = gather_equal(ranks, "grid")
    one_val, one_test = _one_process(jobs["grid"])
    ref_val, ref_test = refs["grid"]
    assert list(val) == ["1_2_3"] and list(val["1_2_3"]) == ["boot0", "boot1", "boot2"]
    _close_nested((val, test), (one_val, one_test), 0, ONE_ATOL)
    _close_nested(val, ref_val, JAX_RTOL, JAX_ATOL, "val")
    _close_nested(test, ref_test, JAX_RTOL, JAX_ATOL, "test")
    for rep in range(3):
        rel = os.path.join("bootstrap_ensemble_models", "ensemble_1_2_3",
                           f"bootstrap_{rep}.bin")
        a = torch.load(root / "grid_mesh" / rel, weights_only=True)
        b = torch.load(root / "grid_one" / rel, weights_only=True)
        assert list(a) == list(b)
        for k in b:
            _close(a[k], b[k], 0, ONE_ATOL, k)


def test_cli_frozen_sweep_with_mesh(world):
    """`train_ensemble_cv --frozen --mesh 2x2` (10 combinations, 3 folds on
    a data axis of 2): every combination's metrics within 1e-6 of the
    one-process run's and at JAX's tolerances of its mesh run's; the
    heads rank 0 wrote equal the one-process run's."""
    root, refs, jobs, ranks = world
    got = gather_equal(ranks, "frozen")
    one = _one_process(jobs["frozen"])
    assert len(got) == 10 and list(got) == list(one)
    _close_nested(got, one, 0, ONE_ATOL)
    _close_nested(got, refs["frozen"], JAX_RTOL, JAX_ATOL)
    rel = os.path.join("cv_ensemble_models", "ensemble_1_3_5", "meta_heads.bin")
    a = torch.load(root / "frozen_mesh" / rel, weights_only=True)
    b = torch.load(root / "frozen_one" / rel, weights_only=True)
    assert torch.equal(a["combo"], b["combo"]) and a["meta_wb"].shape == (3, 4)
    _close(a["meta_wb"], b["meta_wb"], 0, ONE_ATOL)


def test_meta_sweep_sharded_matches_unsharded(world):
    """`train_meta_sweep` over 9 combinations x 3 folds on the 2 x 2 mesh
    (both axes padded): the best metrics and heads of every rank within
    1e-6 of the one-process run's and within 1e-5 / 1e-6 of JAX's mesh
    run's, from JAX's initial heads."""
    _, refs, jobs, ranks = world
    metrics, meta = gather_equal(ranks, "meta_sweep")
    job = jobs["meta_sweep"]
    with patched(job["patches"]):
        one_m, one_meta = ensemble_sweep.train_meta_sweep(*job["args"], job["hyper"],
                                                          device="cpu")
    assert metrics.shape == (9, 3, 11) and meta.shape == (9, 3, 4)
    _close(metrics, one_m, 0, ONE_ATOL)
    _close(meta, one_meta, 0, ONE_ATOL)
    ref_m, ref_meta = refs["meta"]
    _close(metrics, ref_m, META_RTOL, META_ATOL)
    _close(meta, ref_meta, META_RTOL, META_ATOL)


def test_mesh_from_spec(world):
    """Without a process group: the single-process spellings give None,
    'auto' too, a typo raises, and 'MxN' raises a ValueError that names the
    torchrun command; in the 4 ranks '2x2' and 'auto' give the 2 x 2 mesh."""
    for spec in (None, "none", "1x1", "1", "auto"):
        assert mesh_from_spec(spec, "cpu") is None
    for spec in ("bogus", "0x8"):
        with pytest.raises(ValueError, match="--mesh"):
            mesh_from_spec(spec, "cpu")
    with pytest.raises(ValueError, match="torchrun --standalone --nproc_per_node=8"):
        mesh_from_spec("2x4", "cpu")
    _, _, _, ranks = world
    for r, res in enumerate(ranks):
        specs = res["mesh"]["specs"]
        assert specs["none"] is None and specs["1x1"] is None
        for spec in ("2x2", "auto"):
            assert specs[spec] == ({"model": 2, "data": 2}, (r // 2, r % 2), "gloo")


def test_dp_train_step_allreduce(world):
    """One model's data-parallel step over the 4 ranks, 2 rows each, from
    shards that differ in label balance and masked rows: after 3 SGD-momentum
    steps the replicas are equal bit for bit, within 1e-6 of the one-process
    step on the whole batch and within 1e-5 of JAX's `make_dp_train_step`."""
    _, refs, jobs, ranks = world
    got = gather_equal(ranks, "dp_step")
    assert got["rows"] == 2
    job = jobs["dp_step"]
    model = VisionTransformer3D(job["config"], vis=False, device="cpu")
    model.load_state_dict(job["state"])
    opt, _ = sgd_momentum(model.parameters(), DP_LR, lambda step: 1.0)
    vols, labels, mask = (torch.as_tensor(a) for a in _dp_batch())
    losses = []
    for _ in range(DP_STEPS):
        logits = model(vols, deterministic=False).logits
        loss = masked_bce_with_logits(logits, labels, mask,
                                      masked_balanced_pos_weight(labels, mask))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    _close(got["losses"], losses, 0, ONE_ATOL)
    # an average of the ranks' own balanced losses would not be the loss
    per_rank = [float(masked_bce_with_logits(
        torch.zeros(2), labels[2 * r:2 * r + 2], mask[2 * r:2 * r + 2],
        masked_balanced_pos_weight(labels[2 * r:2 * r + 2], mask[2 * r:2 * r + 2])))
        for r in range(WORLD)]
    whole = float(masked_bce_with_logits(torch.zeros(8), labels, mask,
                                         masked_balanced_pos_weight(labels, mask)))
    assert abs(np.mean(per_rank) - whole) > 1e-3
    for k, v in model.state_dict().items():
        _close(got["params"][k], v, 0, ONE_ATOL, k)
        _close(got["params"][k], refs["dp"][k], 0, DP_ATOL, k)

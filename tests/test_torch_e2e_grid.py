"""The port's padded (combination, fold) grid, its stacked Adam, the state
mirror and the frozen meta-head sweep against the JAX package's, on the CPU.

The grid runs on the configs of `tests/test_e2e_grid.py`'s tiny member bank
(real conf numbers, tiny widths, dropout 0) and its uneven folds (10/4 and
7/6 rows), with members the port draws, carried into JAX through JAX's
`torch_vit_to_flax` as its drivers read a port `.bin`.  Tolerances: grid metrics 2e-4
(`tests/test_e2e_grid.py:118`), member logits 2e-4
(`tests/test_model_parity.py:96-98`), ensemble probabilities 2e-5
(`:165`), chunk invariance 1e-6 (`tests/test_cli.py:127`), the stacked Adam
1e-7 against `torch.optim.Adam`, the meta sweep 1e-5.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import vit3d_ensemble_tpu.configs as jax_configs
import vit3d_ensemble_tpu.sweep.e2e_grid as jax_grid
from vit3d_ensemble_tpu.checkpoint import torch_ensemble_to_flax, torch_vit_to_flax
from vit3d_ensemble_tpu.models import TransformerEnsemble as JaxTransformerEnsemble
from vit3d_ensemble_tpu.sweep import ensemble_sweep as jax_sweep
from vit3d_ensemble_tpu.sweep import state_mirror as jax_mirror
import vit3d_ensemble_tpu_torch.configs as configs
from vit3d_ensemble_tpu_torch.checkpoint import save_state_dict
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import TransformerEnsemble, VisionTransformer3D
from vit3d_ensemble_tpu_torch.parallel import make_mesh
from vit3d_ensemble_tpu_torch.sweep import e2e_grid, ensemble_sweep, state_mirror
from vit3d_ensemble_tpu_torch.train.ensemble_trainer import (
    pad_members_to_templates,
    train_ensemble,
)
from vit3d_ensemble_tpu_torch.train.optim import StackedAdam

import test_e2e_grid
from test_e2e_grid import EPOCHS, IMG, LR, PAD, SEED, _folds, _member_bank

GRID_ATOL = 2e-4
LOGITS_ATOL = 2e-4
PROBS_ATOL = 2e-5
CHUNK_ATOL = 1e-6
ADAM_ATOL = 1e-7
META_ATOL = 1e-5
#: Device bytes an instance of the widest grid signature took under remat
#: on an H100 (`chip_smoke.py`, phase `e2e_grid_memory`, the slope of
#: chunks 1-4 at one fold).
GRID_INSTANCE_BYTES = 205_650_944
COMBOS = [(1, 2), (2, 4), (3, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's many small CPU ops: under xdist's
    six workers the default (every core in each worker) oversubscribes the
    CPU, which slows these eager loops far more than it speeds them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_cfg(jcfg) -> ViTConfig:
    return ViTConfig(**dataclasses.asdict(jcfg))


def _members(jcfgs):
    """Each conf's member drawn by the port from seed c, and the same weights
    as JAX parameters (JAX's `torch_vit_to_flax`, as its drivers read a port
    `.bin`): flax's init of a model takes seconds, the port's milliseconds."""
    cfgs = {c: _port_cfg(j) for c, j in jcfgs.items()}
    members = {c: VisionTransformer3D(cfgs[c], device="cpu",
                                      generator=torch.Generator().manual_seed(c)
                                      ).state_dict() for c in cfgs}
    jmembers = {c: torch_vit_to_flax({k: v.numpy() for k, v in members[c].items()},
                                     jcfgs[c]) for c in cfgs}
    return cfgs, members, jmembers


@pytest.fixture(scope="module")
def bank():
    """The configs of JAX's bank with members drawn by the port (`_members`)
    in both packages' forms, and the uneven folds."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_e2e_grid, "init_baseline", lambda cfg, seed: (None, None))
        jcfgs, _ = _member_bank()
    cfgs, members, jmembers = _members(jcfgs)
    folds = _folds(np.random.default_rng(42))
    return jcfgs, jmembers, cfgs, members, folds


def _grid(cfgs, members, data, **kw):
    return e2e_grid.run_e2e_grid(kw.pop("combos", COMBOS),
                                 lambda c: (cfgs[c], members[c]), data,
                                 num_epochs=EPOCHS, learning_rate=LR, seed=SEED,
                                 pad_kwargs=PAD, device="cpu", **kw)


def _max_diff(a, b):
    assert set(a) == set(b)
    return max(abs(a[n][f][k] - b[n][f][k]) for n in a for f in a[n] for k in a[n][f])


# --- plans and fold stacking ----------------------------------------------------


def test_plan_combo_and_signature_match_jax_for_every_combination():
    combos = ensemble_sweep.all_combinations()
    assert combos.shape == (816, 3)
    np.testing.assert_array_equal(combos, jax_sweep.all_combinations())
    sigs = set()
    for comb in combos:
        ours, ref = e2e_grid.plan_combo(comb), jax_grid.plan_combo(comb)
        assert (ours.confs, ours.sorted_confs, ours.perm, ours.name) == (
            ref.confs, ref.sorted_confs, ref.perm, ref.name)
        assert e2e_grid.signature_of(ours) == jax_grid.signature_of(ref)
        sigs.add(e2e_grid.signature_of(ours))
    assert len(sigs) == 10


@pytest.mark.parametrize("uneven", [True, False], ids=["uneven", "uniform"])
def test_stack_e2e_folds_matches_jax(bank, uneven):
    """Element-equal arrays, sizes and `uniform_steps`, with a test split on
    the fold axis."""
    folds = bank[4]
    if not uneven:
        folds = [folds[0], folds[0]]
    test = folds[1][1]
    folds = [(t, v, test) for t, v in folds]
    ours = e2e_grid.stack_e2e_folds(folds, 3, 4, SEED)
    ref = jax_grid.stack_e2e_folds(folds, 3, 4, SEED)
    assert ours.uniform_steps == ref.uniform_steps == (not uneven)
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


# --- the stacked Adam -----------------------------------------------------------


def _adam_case(seed=0, P=3):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(P, 5, 4, generator=g), torch.randn(P, 7, generator=g)]


def test_stacked_adam_equals_torch_adam_on_uniform_steps():
    """Every instance stepped: the same parameters and moments as
    `torch.optim.Adam` over the same tensors, within 1e-7."""
    ours = [t.clone().requires_grad_() for t in _adam_case()]
    ref = [t.clone().requires_grad_() for t in _adam_case()]
    opt = StackedAdam(ours, 1e-2, (3,))
    ref_opt = torch.optim.Adam(ref, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    g = torch.Generator().manual_seed(1)
    for _ in range(6):
        grads = [torch.randn(t.shape, generator=g) for t in ours]
        for p, q, gr in zip(ours, ref, grads):
            p.grad, q.grad = gr.clone(), gr.clone()
        opt.step()
        ref_opt.step()
    for i, (p, q) in enumerate(zip(ours, ref)):
        st = ref_opt.state[q]
        np.testing.assert_allclose(p.detach(), q.detach(), atol=ADAM_ATOL, rtol=0)
        np.testing.assert_allclose(opt.exp_avg[i], st["exp_avg"], atol=ADAM_ATOL, rtol=0)
        np.testing.assert_allclose(opt.exp_avg_sq[i], st["exp_avg_sq"],
                                   atol=ADAM_ATOL, rtol=0)
    assert opt.count.tolist() == [6, 6, 6]


def test_stacked_adam_holds_a_masked_instance_exactly():
    """Instance 1 masked at steps 2 and 3: its parameters, moments and count
    keep their bits there, and afterwards it follows the run that never had
    those steps (its own count); the others are unaffected."""
    params = [t.clone().requires_grad_() for t in _adam_case()]
    opt = StackedAdam(params, 1e-2, (3,))
    alone = [t[1:2].clone().requires_grad_() for t in _adam_case()]
    opt_alone = StackedAdam(alone, 1e-2, (1,))
    g = torch.Generator().manual_seed(2)
    for step in range(5):
        grads = [torch.randn(t.shape, generator=g) for t in params]
        for p, gr in zip(params, grads):
            p.grad = gr
        valid = torch.tensor([True, step not in (2, 3), True])
        before = ([p.detach().clone() for p in params],
                  [m.clone() for m in opt.exp_avg], [v.clone() for v in opt.exp_avg_sq],
                  opt.count.clone())
        opt.step(valid)
        if valid[1]:
            for q, gr in zip(alone, grads):
                q.grad = gr[1:2].clone()
            opt_alone.step()
        else:
            for now, was in zip([[p.detach() for p in params], opt.exp_avg,
                                 opt.exp_avg_sq], before[:3]):
                for a, b in zip(now, was):
                    assert torch.equal(a[1], b[1])
            assert opt.count[1] == before[3][1]
    assert opt.count.tolist() == [5, 3, 5]
    for p, q in zip(params, alone):
        np.testing.assert_allclose(p.detach()[1:2], q.detach(), atol=ADAM_ATOL, rtol=0)


# --- the grid -------------------------------------------------------------------


@pytest.mark.parametrize("uneven", [True, False], ids=["uneven", "uniform"])
def test_grid_matches_sequential(bank, uneven):
    """Dropout 0: every (combination, fold)'s 11 metrics equal the port's
    sequential `train_ensemble` with padded members within 2e-4, for combos
    (1,2), (2,4), (3,4) on the uneven folds (the optimizer's guard;
    measured: 2.2e-8) and for (1,2) on two folds of one size (its
    shared-count path; 3.0e-8)."""
    _, _, cfgs, members, folds = bank
    combos = COMBOS
    if not uneven:      # one training split, two validation splits
        folds = [folds[0], (folds[0][0], folds[1][1])]
        combos = COMBOS[:1]
    data = e2e_grid.stack_e2e_folds(folds, EPOCHS, 4, SEED)
    assert data.idx_all.shape[2] == 3 and data.uniform_steps == (not uneven)
    grid = _grid(cfgs, members, data, combos=combos)
    assert grid.backoffs == 0
    for comb in combos:
        name = "_".join(str(c) for c in comb)
        t_cfgs, padded, masks = pad_members_to_templates(
            [cfgs[c] for c in comb], [members[c] for c in comb], **PAD)
        for f, (t, v) in enumerate(folds):
            res = train_ensemble(t_cfgs, padded, t, v, num_epochs=EPOCHS,
                                 train_batch_size=4, learning_rate=LR, seed=SEED,
                                 keep_best_params=False, member_masks=masks,
                                 device="cpu")
            got = grid[name][f"CV {f + 1}"]
            for k, want in res.metrics.items():
                assert abs(got[k] - want) <= GRID_ATOL, (name, f, k, got[k], want)


def test_grid_matches_jax(bank, monkeypatch):
    """The same members and meta head (JAX's template head) in both grids,
    combos (1,2) and (2,4) of one signature (JAX compiles one program) on
    the uneven folds: every metric within 2e-4 (measured: 3.3e-7)."""
    jcfgs, jmembers, cfgs, members, folds = bank
    heads = {}
    real = jax_grid.init_ensemble

    def record(sig_cfgs, member_params, seed):
        model, params = real(sig_cfgs, member_params, seed)
        meta = jax.device_get(params)["meta"]["classifier"]
        heads[len(sig_cfgs)] = (np.asarray(meta["kernel"]).T, np.asarray(meta["bias"]))
        return model, params

    monkeypatch.setattr(jax_grid, "init_ensemble", record)
    combos = COMBOS[:2]
    ref = jax_grid.run_e2e_grid(combos, lambda c: (jcfgs[c], jmembers[c]),
                                jax_grid.stack_e2e_folds(folds, EPOCHS, 4, SEED),
                                num_epochs=EPOCHS, learning_rate=LR, seed=SEED,
                                pad_kwargs=PAD)
    monkeypatch.setattr(e2e_grid, "_template_head", lambda k, nc, seed: tuple(
        torch.from_numpy(a.copy()) for a in heads[k]))
    ours = _grid(cfgs, members, e2e_grid.stack_e2e_folds(folds, EPOCHS, 4, SEED),
                 combos=combos)
    assert _max_diff(ours, ref) <= GRID_ATOL


def test_grid_chunked_equals_unchunked_with_dropout(bank):
    """Dropout on: four combinations of one signature in chunks of 3 (+1)
    and in one chunk give every metric within 1e-6 (measured: 3.0e-8): a
    combination's masks do not depend on its chunk or its place in it."""
    _, _, cfgs, members, folds = bank
    cfgs = {c: dataclasses.replace(cfg, dropout_rate=0.1) for c, cfg in cfgs.items()}
    cfgs[5] = dataclasses.replace(cfgs[2], mlp_dim=32, num_layers=2)
    members = dict(members)
    members[5] = VisionTransformer3D(cfgs[5], device="cpu",
                                     generator=torch.Generator().manual_seed(5)
                                     ).state_dict()
    combos = [(1, 2), (2, 4), (1, 5), (4, 5)]
    assert len({e2e_grid.signature_of(e2e_grid.plan_combo(c)) for c in combos}) == 1
    data = e2e_grid.stack_e2e_folds(folds, EPOCHS, 4, SEED)
    one = _grid(cfgs, members, data, combos=combos)
    chunked = _grid(cfgs, members, data, combos=combos, chunk=3)
    assert list(chunked.chunks.values()) == [[3, 1]]
    assert list(one.chunks.values()) == [[4]]
    assert _max_diff(chunked, one) <= CHUNK_ATOL


def test_grid_payload_layout_and_jax_reads_it(bank, tmp_path):
    """keep_payload: per-fold best ensembles in ascending-conf slot order at
    the members' true shapes (conf 1 in slot 0 although the sort runs conf
    2 there); its `.bin`, read by JAX's `torch_ensemble_to_flax`, gives the
    port's probabilities within 2e-5."""
    jcfgs, _, cfgs, members, folds = bank
    captured = {}
    _grid(cfgs, members, e2e_grid.stack_e2e_folds(folds, EPOCHS, 4, SEED),
          combos=[(1, 2)], keep_payload=True,
          on_result=lambda plan, res, extras: captured.update({plan.name: extras}))
    best = captured["1_2"]["params"]
    assert len(best) == len(folds) and captured["1_2"]["test_probs"] is None
    want = TransformerEnsemble([cfgs[1], cfgs[2]], device="cpu").state_dict()
    assert {k: v.shape for k, v in best[0].items()} == {k: v.shape for k, v in want.items()}
    assert best[0]["transformers.0.transformer.encoder.layer.0.ffn.fc1.weight"].shape == (32, 64)
    assert best[0]["transformers.1.transformer.encoder.layer.0.ffn.fc1.weight"].shape == (48, 32)
    path = tmp_path / "cv1.bin"
    save_state_dict(str(path), best[0])
    state = torch.load(path, weights_only=True)
    vols = np.random.default_rng(5).normal(size=(3, IMG, IMG, 5, 1)).astype(np.float32)
    model = TransformerEnsemble([cfgs[1], cfgs[2]], device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        ours = model(torch.from_numpy(vols)).reshape(-1).numpy()
    jc = (jcfgs[1], jcfgs[2])
    params = torch_ensemble_to_flax({k: v.numpy() for k, v in state.items()}, jc)
    ref = np.asarray(JaxTransformerEnsemble(jc).apply(
        {"params": params}, jnp.asarray(vols), deterministic=True)).reshape(-1)
    np.testing.assert_allclose(ours, ref, atol=PROBS_ATOL, rtol=0)


def test_grid_backs_off_on_out_of_memory(bank, monkeypatch):
    """A chunk of 4 that runs out of device memory is retried as two
    chunks of 2 from their initial state and gives the unchunked results;
    at one combination the error is raised."""
    _, _, cfgs, members, folds = bank
    data = e2e_grid.stack_e2e_folds(folds, EPOCHS, 4, SEED)
    # the same two combinations twice: four plans of one signature
    combos = [(1, 2), (2, 4)] * 2
    one = _grid(cfgs, members, data, combos=combos[:2], chunk=4)
    real = e2e_grid._train_chunk

    def four_fails(plans, *a, **k):
        if len(plans) == 4:
            raise torch.cuda.OutOfMemoryError("simulated")
        return real(plans, *a, **k)

    monkeypatch.setattr(e2e_grid, "_train_chunk", four_fails)
    got = _grid(cfgs, members, data, combos=combos, chunk=4)
    assert got.backoffs == 1
    assert list(got.chunks.values()) == [[2, 2]]
    assert _max_diff(got, one) <= CHUNK_ATOL

    def always_fails(plans, *a, **k):
        raise torch.cuda.OutOfMemoryError("simulated")

    monkeypatch.setattr(e2e_grid, "_train_chunk", always_fails)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _grid(cfgs, members, data, combos=combos, chunk=2)


def test_auto_chunk_fits_the_budget():
    """The widest signature's instance at the real shapes, and the chunk the
    budget of an 80 GB card gives it, stay within that budget; the estimate
    under remat is not below the GRID_INSTANCE_BYTES an instance
    `chip_smoke.py`'s `e2e_grid_memory` measured on an H100, and a card
    that two ranks share gives each half its memory."""
    cfgs = [dataclasses.replace(ViTConfig.from_conf(1), mlp_dim=3072, num_layers=8)] * 3
    inst = e2e_grid._instance_bytes(cfgs, 4, False)
    assert inst >= GRID_INSTANCE_BYTES
    assert e2e_grid._instance_bytes(cfgs, 4, True) > inst
    budget = 80 * 2**30 - 8 * 2**30 - 2**30
    c = e2e_grid._auto_chunk(inst, 5, budget)
    assert c >= 1 and c * 5 * inst <= budget < (c + 1) * 5 * inst
    assert e2e_grid._auto_chunk(inst, 5, inst) == 1
    card = torch.device("cuda")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(e2e_grid, "_device_memory", lambda device: 80 * 2**30)
        assert e2e_grid._chunk_budget(card, 2**30) == budget
        assert e2e_grid._chunk_budget(card, 2**30, sharing=2) == 40 * 2**30 - 8 * 2**30 - 2**30


@pytest.mark.parametrize("which", ["run_e2e_grid", "train_meta_sweep"])
def test_mesh_raises(bank, which, tmp_path):
    """The mesh path (`parallel/mesh.py`, ported): in a process group of one
    rank a 2 x 2 mesh raises ValueError, and a 1 x 1 mesh gives the run
    without one, exactly (tests/test_torch_parallel.py runs 4 ranks)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_mesh(2, 2, device="cpu")
        mesh = make_mesh(1, 1, device="cpu")
        if which == "run_e2e_grid":
            _, _, cfgs, members, folds = bank
            data = e2e_grid.stack_e2e_folds(folds, EPOCHS, 4, SEED)
            combos = COMBOS[:2]
            assert (_grid(cfgs, members, data, combos=combos, mesh=mesh)
                    == _grid(cfgs, members, data, combos=combos))
        else:
            rng = np.random.default_rng(3)
            TL = rng.normal(size=(2, 4, 6)).astype(np.float32)
            TY = np.tile([0.0, 1.0], 6).reshape(2, 6).astype(np.float32)
            VL = rng.normal(size=(2, 4, 4)).astype(np.float32)
            VY = np.tile([0.0, 1.0], 4).reshape(2, 4).astype(np.float32)
            args = (ensemble_sweep.all_combinations(5), TL, TY, np.ones_like(TY),
                    VL, VY, np.ones_like(VY), {c: c - 1 for c in range(1, 5)},
                    ensemble_sweep.MetaHyper(num_epochs=2, learning_rate=0.05))
            for a, b in zip(ensemble_sweep.train_meta_sweep(*args, mesh=mesh),
                            ensemble_sweep.train_meta_sweep(*args, device="cpu")):
                np.testing.assert_array_equal(a, b)
    finally:
        dist.destroy_process_group()


# --- the state mirror -----------------------------------------------------------


def _write_marker(state_dir, name, blob):
    os.makedirs(state_dir, exist_ok=True)
    with open(os.path.join(state_dir, name), "w") as f:
        json.dump(blob, f)


def test_snapshot_restore_roundtrip(tmp_path):
    state = str(tmp_path / "sweep_state")
    mirror = str(tmp_path / "mirror.jsonl")
    m1 = {"combo": [1, 2, 3], "val": {"CV 1": {"AUROC": 0.5}}}
    m2 = {"combo": [1, 2, 4], "val": {"CV 1": {"AUROC": 0.7}}}
    _write_marker(state, "e2e_1_2_3_fp.json", m1)
    _write_marker(state, "e2e_1_2_4_fp.json", m2)
    _write_marker(state, "e2e_junk_fp.json.tmp", {"ignored": 1})
    with open(os.path.join(state, "e2e_bad_fp.json"), "w") as f:
        f.write('{"truncated": ')
    assert state_mirror.snapshot(state, mirror) == 2
    for p in os.listdir(state):
        os.remove(os.path.join(state, p))
    os.rmdir(state)
    assert state_mirror.restore(mirror, state) == 2
    with open(os.path.join(state, "e2e_1_2_3_fp.json")) as f:
        assert json.load(f) == m1
    with open(os.path.join(state, "e2e_1_2_4_fp.json")) as f:
        assert json.load(f) == m2
    assert state_mirror.restore(mirror, state) == 0


def test_append_last_wins_and_junk_lines(tmp_path):
    mirror = str(tmp_path / "mirror.jsonl")
    state_mirror.append(mirror, "e2e_a.json", {"v": 1})
    state_mirror.append(mirror, "e2e_a.json", {"v": 2})
    state_mirror.append(mirror, "e2e_b.json", {"v": 3})
    with open(mirror, "a") as f:
        f.write('{"file": "e2e_c.json", "marker"')
    assert state_mirror.read_mirror(mirror) == {"e2e_a.json": {"v": 2},
                                                "e2e_b.json": {"v": 3}}


def test_snapshot_keeps_mirror_only_entries(tmp_path):
    state = str(tmp_path / "sweep_state")
    mirror = str(tmp_path / "mirror.jsonl")
    state_mirror.append(mirror, "e2e_old.json", {"v": "survives"})
    _write_marker(state, "e2e_new.json", {"v": "fresh"})
    assert state_mirror.snapshot(state, mirror) == 2
    got = state_mirror.read_mirror(mirror)
    assert got["e2e_old.json"] == {"v": "survives"}
    assert got["e2e_new.json"] == {"v": "fresh"}


def test_restore_missing_mirror_is_noop(tmp_path):
    assert state_mirror.restore(str(tmp_path / "absent.jsonl"),
                                str(tmp_path / "state")) == 0


@pytest.mark.parametrize("writer,reader", [(jax_mirror, state_mirror),
                                           (state_mirror, jax_mirror)],
                         ids=["jax_to_port", "port_to_jax"])
def test_mirror_crosses_packages(tmp_path, writer, reader):
    """A mirror one package snapshots and appends to, the other restores to
    the same marker files."""
    state = str(tmp_path / "sweep_state")
    mirror = str(tmp_path / "mirror.jsonl")
    _write_marker(state, "e2e_1_2_3_fp.json", {"combo": [1, 2, 3], "val": {}})
    assert writer.snapshot(state, mirror) == 1
    writer.append(mirror, "boot_1_2_4_fp.json", {"combo": [1, 2, 4], "test": {}})
    restored = str(tmp_path / "restored")
    assert reader.restore(mirror, restored) == 2
    for name in ("e2e_1_2_3_fp.json", "boot_1_2_4_fp.json"):
        with open(os.path.join(restored, name)) as f:
            assert json.load(f) == reader.read_mirror(mirror)[name]
    assert reader.read_mirror(mirror) == writer.read_mirror(mirror)


# --- the frozen meta-head sweep -----------------------------------------------------

#: Confs 1-4 narrowed in both grids (patch, mlp, layers, hidden, heads), two
#: shape classes.
FROZEN_NARROW = {1: (16, 32, 2, 16, 4), 2: (16, 48, 1, 32, 8),
                 3: (16, 24, 2, 16, 4), 4: (16, 40, 2, 32, 8)}


def test_compute_member_logits_matches_jax(monkeypatch):
    """Four members in two groups over 5 volumes in chunks of 2 (the last
    one short): each conf's logits within 2e-4 of JAX's."""
    for grid in (configs.GRID, jax_configs.GRID):
        for conf, row in FROZEN_NARROW.items():
            monkeypatch.setitem(grid, conf, row)
    _, members, jmembers = _members({
        c: jax_configs.ViTConfig.from_conf(c, img_size=IMG) for c in FROZEN_NARROW})
    vols = np.random.default_rng(6).normal(size=(5, IMG, IMG, 5, 1)).astype(np.float32)
    ours = ensemble_sweep.compute_member_logits(members, vols, IMG, batch_size=2,
                                                device="cpu")
    ref = jax_sweep.compute_member_logits(jmembers, vols, IMG, batch_size=2)
    assert sorted(ours) == sorted(ref) == [1, 2, 3, 4]
    for c in ref:
        assert ours[c].shape == (5,)
        np.testing.assert_allclose(ours[c], ref[c], atol=LOGITS_ATOL, rtol=0)


def _jax_heads(C, F, k, seed):
    """JAX's initial draw (`ensemble_sweep.py:224-231`)."""
    kw, kb = jax.random.split(jax.random.key(seed))
    bound = 1.0 / np.sqrt(3.0)
    return (np.asarray(jax.random.uniform(kw, (C, F, k), minval=-bound, maxval=bound)),
            np.asarray(jax.random.uniform(kb, (C, F), minval=-bound, maxval=bound)))


@pytest.mark.parametrize("uneven", [True, False], ids=["uneven", "uniform"])
def test_train_meta_sweep_matches_jax(monkeypatch, uneven):
    """Seeded member logits for 5 confs (C(5,3) = 10 heads a fold), two
    folds (train 10 and 7 rows when uneven, val 6 and 4): the best metrics
    and [w1 w2 w3 b] within 1e-5 of JAX's from the same initial heads."""
    rng = np.random.default_rng(7)
    F, N, V, n_confs = 2, 10, 6, 5
    sizes = (10, 7) if uneven else (10, 10)
    labels = (rng.random((F, N)) > 0.5).astype(np.float32)
    train_mask = np.zeros((F, N), np.float32)
    for f, n in enumerate(sizes):
        train_mask[f, :n] = 1
    train_logits = (rng.normal(size=(F, n_confs, N)) + 2 * labels[:, None] - 1
                    ).astype(np.float32) * train_mask[:, None]
    val_labels = (rng.random((F, V)) > 0.5).astype(np.float32)
    val_mask = np.ones((F, V), np.float32)
    val_mask[1, 4:] = 0
    val_logits = (rng.normal(size=(F, n_confs, V)) + val_labels[:, None]).astype(np.float32)
    combos = ensemble_sweep.all_combinations(n_confs + 1)
    conf_index = {c: c - 1 for c in range(1, n_confs + 1)}
    hyper = ensemble_sweep.MetaHyper(num_epochs=3, train_batch_size=4,
                                     learning_rate=0.05, seed=3)
    args = (combos, train_logits, labels * train_mask, train_mask, val_logits,
            val_labels * val_mask, val_mask, conf_index)
    ref_m, ref_wb = jax_sweep.train_meta_sweep(
        *args, jax_sweep.MetaHyper(**dataclasses.asdict(hyper)))
    monkeypatch.setattr(ensemble_sweep, "init_meta_heads", _jax_heads)
    m, wb = ensemble_sweep.train_meta_sweep(*args, hyper, device="cpu")
    assert m.shape == (10, F, 11) and wb.shape == (10, F, 4)
    np.testing.assert_allclose(m, ref_m, atol=META_ATOL, rtol=0)
    np.testing.assert_allclose(wb, ref_wb, atol=META_ATOL, rtol=0)


def test_init_meta_heads_is_seeded_and_bounded():
    w, b = ensemble_sweep.init_meta_heads(4, 2, 3, 11)
    w2, b2 = ensemble_sweep.init_meta_heads(4, 2, 3, 11)
    assert w.shape == (4, 2, 3) and b.shape == (4, 2)
    assert np.array_equal(w, w2) and np.array_equal(b, b2)
    assert np.abs(w).max() <= 1 / np.sqrt(3) and np.abs(b).max() <= 1 / np.sqrt(3)
    assert not np.array_equal(w, ensemble_sweep.init_meta_heads(4, 2, 3, 12)[0])

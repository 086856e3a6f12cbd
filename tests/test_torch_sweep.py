"""The port's sweep engine and its MLP kernels' plain versions against the
JAX package's, on the CPU.

The stacked model, `run_group` and the grouped-vs-sequential equivalence are
checked on `tests/test_sweep.py`'s tiny group (D = 16, 4 heads, mlp (32, 48),
layers (2, 3), 32 px volumes); the model-axis `_plain_mlp` and K1b's and
K1c's plain versions against the JAX kernels in interpret mode.  Each test
names its tolerance.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import vit3d_ensemble_tpu.configs as jax_configs
from vit3d_ensemble_tpu.data.pool import PooledSplit
from vit3d_ensemble_tpu.models import VisionTransformer3D as JaxVisionTransformer3D
from vit3d_ensemble_tpu.ops import pallas_mlp
from vit3d_ensemble_tpu.sweep import engine as jax_engine
from vit3d_ensemble_tpu.sweep import stack as jax_stack
import vit3d_ensemble_tpu_torch.configs as configs
from vit3d_ensemble_tpu_torch.checkpoint import vit_state_from_flax
from vit3d_ensemble_tpu_torch.data import SplitArrays
from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
from vit3d_ensemble_tpu_torch.ops import attention, fused_mlp
from vit3d_ensemble_tpu_torch.ops import mlp as mlp_select
from vit3d_ensemble_tpu_torch.sweep import engine, stack
from vit3d_ensemble_tpu_torch.sweep.stacked import stacked_forward
from vit3d_ensemble_tpu_torch.train import trainer

IMG = 32
TINY = {101: (16, 32, 2, 16, 4), 102: (16, 48, 3, 16, 4)}


@pytest.fixture()
def tiny(monkeypatch):
    """The tiny group of `tests/test_sweep.py`, registered in both
    packages' config grids."""
    for grid in (configs.GRID, jax_configs.GRID):
        for conf, row in TINY.items():
            monkeypatch.setitem(grid, conf, row)
    return stack.ConfigGroup(hidden_size=16, num_heads=4, confs=(101, 102),
                             mlp_dims=(32, 48), num_layers=(2, 3))


def _jax_group(group):
    return jax_stack.ConfigGroup(group.hidden_size, group.num_heads,
                                 group.confs, group.mlp_dims, group.num_layers)


def _stacked_state(flax_params, config, lead):
    """A stacked `vit_state_from_flax`: JAX params with leading axes `lead`
    -> the port's names, each tensor with those axes in front."""
    flat = [vit_state_from_flax(jax.tree.map(lambda a, i=i: np.asarray(a)[
        np.unravel_index(i, lead)], flax_params), config)
        for i in range(int(np.prod(lead)))]
    return {k: torch.stack([m[k] for m in flat]).reshape(*lead, *flat[0][k].shape)
            for k in flat[0]}


def _fold_data(seed, pool_n=16, n_train=8, n_val=6, folds=2):
    """A shared synthetic pool and per-fold index views, positives shifted."""
    rng = np.random.default_rng(seed)
    labels = np.tile([0, 1], pool_n // 2).astype(np.float32)
    pool = rng.normal(size=(pool_n, IMG, IMG, 5, 1)).astype(np.float32)
    pool[labels == 1] += 1.0
    out = []
    for _ in range(folds):
        tr = rng.permutation(pool_n)[:n_train].astype(np.int32)
        va = rng.permutation(pool_n)[:n_val].astype(np.int32)
        m = float(pool[tr].mean())
        out.append((PooledSplit(tr, labels[tr], m), PooledSplit(va, labels[va], m)))
    return pool, out


# --- grouping -----------------------------------------------------------------


def test_group_configs_match_jax():
    ours, ref = stack.group_configs(range(1, 19)), jax_stack.group_configs(range(1, 19))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert (a.hidden_size, a.num_heads, a.confs, a.mlp_dims, a.num_layers) == (
            b.hidden_size, b.num_heads, b.confs, b.mlp_dims, b.num_layers)
        assert (a.max_mlp, a.max_layers) == (b.max_mlp, b.max_layers)
        for img in (128, 32):
            assert (dataclasses.asdict(a.template_config(img))
                    == dataclasses.asdict(b.template_config(img)))
            for i in range(len(a.confs)):
                assert (dataclasses.asdict(a.member_config(i, img))
                        == dataclasses.asdict(b.member_config(i, img)))
    with pytest.raises(ValueError, match="patch 8"):
        stack.group_configs([19])


def test_init_pads_with_zeros_and_unpads(tiny):
    """Folds share one init per config, each member's init is its own
    `init_baseline` run's, padding is zero, and cropping restores it."""
    padded = stack.init_group_params(tiny, 3, seed=5, img_size=IMG)
    fc1 = padded["transformer.encoder.layer.1.ffn.fc1.weight"]
    assert fc1.shape == (2, 3, 48, 16)
    assert torch.equal(fc1[0, 0], fc1[0, 2]) and torch.all(fc1[0, :, 32:] == 0)
    assert torch.all(padded["transformer.encoder.layer.2.ffn_norm.weight"][0] == 0)
    members = stack.unpad_group_params(padded, tiny, img_size=IMG)
    for i in range(2):
        own = trainer.init_baseline(tiny.member_config(i, IMG), 5,
                                    device="cpu").state_dict()
        assert set(members[i]) == set(own)
        for k, v in own.items():
            assert torch.equal(members[i][k][1], v), k
        one = stack.unpad_params({k: v[i, 0] for k, v in padded.items()}, tiny, i,
                                 img_size=IMG)
        assert all(torch.equal(one[k], own[k]) for k in own)


# --- the stacked model --------------------------------------------------------


@pytest.mark.parametrize("attention_impl,mlp_impl", [("auto", "auto"),
                                                     ("layer", "kernel")])
def test_stacked_model_matches_members_and_jax(tiny, attention_impl, mlp_impl):
    """JAX's stacked init, with random heads and position embeddings, in the
    port's stacked model: each cell's logits equal its own port model's
    (true shapes) within 1e-6 and JAX's vmapped `model.apply` within 2e-4.
    Measured 1.2e-7 and 2.1e-7 under both impl pairs."""
    F = 2
    template = tiny.template_config(IMG)
    params = jax_stack.init_group_params(_jax_group(tiny), F, seed=0,
                                         img_size=IMG)
    rng = np.random.default_rng(1)
    params["head"]["kernel"] = jnp.asarray(   # U(+-1/sqrt(D)), torch's Linear
        rng.uniform(-0.25, 0.25, size=params["head"]["kernel"].shape)
        .astype(np.float32))
    pos = params["embeddings"]["position_embeddings"]
    params["embeddings"]["position_embeddings"] = jnp.asarray(
        rng.normal(size=pos.shape).astype(np.float32) * 0.5)
    state = _stacked_state(jax.device_get(params), template, (2, F))
    x = rng.normal(size=(3, IMG, IMG, 5, 1)).astype(np.float32)
    mlp = torch.tensor([32, 32, 48, 48], dtype=torch.int32)
    layers = torch.tensor([2, 2, 3, 3], dtype=torch.int32)

    attention.set_default_attention_impl(attention_impl)
    mlp_select.set_default_mlp_impl(mlp_impl)
    try:
        with torch.no_grad():
            out = stacked_forward({k: v.reshape(4, *v.shape[2:]) for k, v in state.items()},
                                  template, torch.from_numpy(x)[None],
                                  layers_active=layers, mlp_active=mlp)
            own = []
            for p in range(4):
                g, f = divmod(p, F)
                model = VisionTransformer3D(tiny.member_config(g, IMG), vis=False,
                                            device="cpu")
                model.load_state_dict(stack.unpad_params(
                    {k: v[g, f] for k, v in state.items()}, tiny, g, img_size=IMG))
                own.append(model(torch.from_numpy(x)).logits)
    finally:
        attention.set_default_attention_impl("auto")
        mlp_select.set_default_mlp_impl("auto")
    assert out.shape == (4, 3, 1)
    torch.testing.assert_close(out, torch.stack(own), atol=1e-6, rtol=0)

    tmodel = JaxVisionTransformer3D(_jax_group(tiny).template_config(IMG),
                                    zero_head=True, vis=False)

    def apply(p, n_layers, width):
        return tmodel.apply({"params": p}, jnp.asarray(x), deterministic=True,
                            num_layers_active=n_layers, mlp_active=width).logits

    ref = jax.jit(jax.vmap(jax.vmap(apply)))(
        params, jnp.asarray(layers.numpy().reshape(2, F)),
        jnp.asarray(mlp.numpy().reshape(2, F)))
    np.testing.assert_allclose(out.numpy().reshape(2, F, 3, 1), np.asarray(ref),
                               atol=2e-4, rtol=0)


# --- run_group ----------------------------------------------------------------


def _zero_dropout(monkeypatch):
    """JAX's template with dropout 0 (its groups carry no dropout knob)."""
    real = jax_stack.ConfigGroup.template_config
    monkeypatch.setattr(jax_stack.ConfigGroup, "template_config",
                        lambda self, img_size=128: dataclasses.replace(
                            real(self, img_size), dropout_rate=0.0))


def test_run_group_matches_jax(tiny, monkeypatch):
    """Dropout 0, F = 2, 6 steps, an evaluation every 2, B = 2, both from
    JAX's init.  Measured: final losses within 1.5e-7, best parameters within
    6.5e-7, metrics within 2.1e-7, probabilities within 3.6e-7 (tolerances
    1e-5, 1e-4, 1e-6, 1e-5)."""
    _zero_dropout(monkeypatch)
    group = dataclasses.replace(tiny, dropout_rate=0.0)
    pool, folds = _fold_data(5)
    hyper = engine.SweepHyper(num_steps=6, eval_every=2, train_batch_size=2,
                              learning_rate=0.05, warmup_steps=2, seed=0)
    jhyper = jax_engine.SweepHyper(**dataclasses.asdict(hyper))
    template = group.template_config(IMG)
    params0 = jax_stack.init_group_params(_jax_group(group), 2, 0, IMG)
    monkeypatch.setattr(jax_engine, "init_group_params", lambda *a, **k: params0)
    state0 = _stacked_state(jax.device_get(params0), template, (2, 2))
    monkeypatch.setattr(engine, "init_group_params",
                        lambda *a, **k: {k_: v.clone() for k_, v in state0.items()})

    ref = jax_engine.run_group(_jax_group(group),
                               jax_engine.stack_folds(pool, folds, jhyper), jhyper,
                               img_size=IMG)
    out = engine.run_group(group, engine.stack_folds(pool, folds, hyper), hyper,
                           img_size=IMG, device="cpu")

    assert out.losses.shape == (6, 2, 2)
    np.testing.assert_allclose(out.final_loss, np.asarray(ref.final_loss), atol=1e-5)
    np.testing.assert_allclose(out.best_metrics, np.asarray(ref.best_metrics),
                               atol=1e-6)
    np.testing.assert_allclose(out.best_probs, np.asarray(ref.best_probs), atol=1e-5)
    best = _stacked_state(jax.device_get(ref.best_params), template, (2, 2))
    for k, v in best.items():
        np.testing.assert_allclose(out.best_params[k].detach().numpy(), v.numpy(),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_grouped_equals_sequential_train_baseline(tiny):
    """Each cell of a grouped run is its own `train_baseline` run: the same
    init, batches, SGD and selection.  Dropout 0; two cells.  Measured:
    losses within 6e-8, best parameters equal, metrics within 3e-8
    (tolerances 1e-5, 1e-4, 1e-6)."""
    group = dataclasses.replace(tiny, dropout_rate=0.0)
    pool, folds = _fold_data(6)
    hyper = engine.SweepHyper(num_steps=6, eval_every=2, train_batch_size=2,
                              learning_rate=0.05, warmup_steps=2, seed=3)
    out = engine.run_group(group, engine.stack_folds(pool, folds, hyper), hyper,
                           img_size=IMG, device="cpu")
    members = stack.unpad_group_params(out.best_params, group, img_size=IMG)

    def split(ps):
        vols = pool[ps.row_idx] - np.float32(ps.mean)
        return SplitArrays(vols, ps.labels.astype(np.int32),
                           [""] * len(vols), [""] * len(vols))

    for g, f in ((0, 0), (1, 1)):
        tr, va = folds[f]
        res = trainer.train_baseline(
            group.member_config(g, IMG), split(tr), split(va),
            num_steps=6, eval_every=2, train_batch_size=2, learning_rate=0.05,
            warmup_steps=2, seed=3, device="cpu")
        np.testing.assert_allclose(out.losses[:, g, f], res.losses, atol=1e-5)
        for k, v in res.best_params.items():
            np.testing.assert_allclose(members[g][k][f].numpy(), v.numpy(),
                                       atol=1e-4, rtol=0, err_msg=k)
        for i, k in enumerate(engine.METRIC_KEYS):
            np.testing.assert_allclose(out.best_metrics[g, f, i], res.metrics[k],
                                       atol=1e-6, err_msg=k)


def test_snapshot_kill_and_resume(tiny, tmp_path):
    """Preemption recovery, dropout on: kill a snapshotting run mid-group,
    resume from the state file, and get exactly the uninterrupted run's
    results (the dropout streams' site counter is part of the carry)."""
    pool, folds = _fold_data(5)
    # 9 steps / eval_every 2 -> 4 periods + 1 remainder step;
    # snapshot_every=2 -> 2 segments
    hyper = engine.SweepHyper(num_steps=9, eval_every=2, train_batch_size=4,
                              learning_rate=0.05, warmup_steps=2, seed=0,
                              snapshot_every=2)
    data = engine.stack_folds(pool, folds, hyper)
    full = engine.run_group(tiny, data, hyper, img_size=IMG, device="cpu")

    state = str(tmp_path / "group_state.pt")
    with pytest.raises(engine.SimulatedPreemption):
        engine.run_group(tiny, data, hyper, img_size=IMG, state_path=state,
                         _abort_after_segments=1, device="cpu")
    assert os.path.exists(state)
    resumed = engine.run_group(tiny, data, hyper, img_size=IMG, state_path=state,
                               resume=True, device="cpu")
    assert not os.path.exists(state)
    np.testing.assert_array_equal(resumed.losses, full.losses)
    np.testing.assert_array_equal(resumed.best_metrics, full.best_metrics)
    for k, v in full.best_params.items():
        assert torch.equal(resumed.best_params[k], v), k

    # a truncated state restarts the group
    with open(state, "wb") as f:
        f.write(b"truncated")
    again = engine.run_group(tiny, data, hyper, img_size=IMG, state_path=state,
                             resume=True, device="cpu")
    np.testing.assert_array_equal(again.losses, full.losses)


def test_cell_dropout_streams_are_the_cells_own():
    """A cell's masks depend on its id alone: the same in a stack of 6 and
    alone, in any place, with P or P·B leading rows; they change from site
    to site and from cell to cell, keep 1 - rate of the elements (within
    0.005 on 2^20), and the site counter is the whole state."""
    x = torch.ones(6, 4, 65, 16)
    stack6 = attention.CellDropout(7, [0, 5, 2, 9, 4, 3], "cpu")
    masks = [stack6.keep(x, 0.1) for _ in range(3)]
    for place, cell in ((1, 5), (3, 9)):
        alone = attention.CellDropout(7, [cell], "cpu")
        for m in masks:
            assert torch.equal(alone.keep(x[:1], 0.1)[0], m[place])
    rows = attention.CellDropout(7, [0, 5, 2, 9, 4, 3], "cpu")
    assert torch.equal(rows.keep(x.reshape(24, 65, 16), 0.1).reshape(x.shape),
                       masks[0])
    assert not torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0][0], masks[0][1])
    share = attention.CellDropout(0, [0], "cpu").keep(torch.ones(1, 1 << 20), 0.3)
    assert abs(share.float().mean().item() - 0.7) < 5e-3
    later = attention.CellDropout(7, [0, 5, 2, 9, 4, 3], "cpu")
    later.site = 2
    assert torch.equal(later.keep(x, 0.1), masks[2])
    with pytest.raises(ValueError, match="rows for 6 cells"):
        later.keep(torch.ones(4, 3), 0.1)


def test_fold_slice_cell_equals_the_full_run(tiny):
    """Dropout on: a group trained on fold 1 alone, as the chunked
    bootstrap trains a slice of its replicates (`fold_ids=[1]`,
    `n_folds_total=2`), gives fold 1's cells of the two-fold run: losses
    and best parameters within 1e-6."""
    pool, folds = _fold_data(8)
    hyper = engine.SweepHyper(num_steps=5, eval_every=2, train_batch_size=4,
                              learning_rate=0.05, warmup_steps=2, seed=1)
    full = engine.run_group(tiny, engine.stack_folds(pool, folds, hyper), hyper,
                            img_size=IMG, device="cpu")
    part = engine.run_group(tiny, engine.stack_folds(pool, folds[1:], hyper),
                            hyper, img_size=IMG, fold_ids=[1], n_folds_total=2,
                            device="cpu")
    np.testing.assert_allclose(part.losses[:, :, 0], full.losses[:, :, 1],
                               atol=1e-6, rtol=0)
    for k, v in full.best_params.items():
        np.testing.assert_allclose(part.best_params[k][:, 0].numpy(),
                                   v[:, 1].numpy(), atol=1e-6, rtol=0, err_msg=k)
    # the slice's other fold id draws other masks
    other = engine.run_group(tiny, engine.stack_folds(pool, folds[1:], hyper),
                             hyper, img_size=IMG, device="cpu")
    assert not np.allclose(other.losses[:, :, 0], full.losses[:, :, 1], atol=1e-6)


def test_run_grouped_baselines_writes_checkpoints_and_markers(tiny, tmp_path,
                                                              monkeypatch):
    """Markers under the JAX engine's name, one reference-layout checkpoint
    a (conf, fold) with the member's true shapes, the metrics log, a trace
    under `profile_dir`; `resume` then skips the completed group."""
    pool, folds = _fold_data(7)
    hyper = engine.SweepHyper(num_steps=2, eval_every=1, train_batch_size=4,
                              learning_rate=0.05, warmup_steps=1, seed=0)
    data = engine.stack_folds(pool, folds, hyper)
    args = types.SimpleNamespace(output_dir=str(tmp_path), img_size=IMG,
                                 resume=False,
                                 profile_dir=str(tmp_path / "trace"))
    kw = dict(ckpt_kind="cv_baseline", fold_label=lambda f: f"CV {f + 1}",
              fold_tag=lambda conf, f: f"cv{f + 1}", marker_prefix="cv",
              confs=(101, 102), device="cpu")
    results = engine.run_grouped_baselines(args, data, hyper, **kw)
    assert set(results) == {101, 102} and set(results[101]) == {"CV 1", "CV 2"}
    marker = engine.sweep_marker_path(str(tmp_path / "sweep_state"), "cv", tiny,
                                      2, hyper)
    assert marker == jax_engine.sweep_marker_path(
        str(tmp_path / "sweep_state"), "cv", _jax_group(tiny), 2,
        jax_engine.SweepHyper(**dataclasses.asdict(hyper)))
    with open(marker) as f:
        assert json.load(f)["102"]["CV 2"] == results[102]["CV 2"]
    ckpt = torch.load(tmp_path / "cv_baseline_models" / "conf101" / "cv2.bin")
    assert ckpt["transformer.encoder.layer.1.ffn.fc1.weight"].shape == (32, 16)
    assert "transformer.encoder.layer.2.ffn.fc1.weight" not in ckpt
    assert '"event": "sweep_eval"' in (tmp_path / "metrics.jsonl").read_text()
    assert os.listdir(tmp_path / "trace")

    args.resume, args.profile_dir = True, None

    def must_not_train(*a, **k):
        raise AssertionError("a completed group trained again")

    monkeypatch.setattr(engine, "run_group", must_not_train)
    assert engine.run_grouped_baselines(args, data, hyper, **kw) == results


def test_run_group_needs_a_card_unless_asked_for_cpu(tiny, monkeypatch):
    pool, folds = _fold_data(8)
    hyper = engine.SweepHyper(num_steps=1, eval_every=1, train_batch_size=2)
    data = engine.stack_folds(pool, folds, hyper)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run_group(tiny, data, hyper, img_size=IMG)
    # a mesh's ranks need their process group first; remat runs on the card
    with pytest.raises(ValueError, match="torchrun"):
        engine.run_grouped_baselines(
            types.SimpleNamespace(mesh="2x2", output_dir="unused", img_size=IMG),
            data, hyper, ckpt_kind="cv_baseline", fold_label=str, fold_tag=str,
            marker_prefix="cv", confs=(101, 102))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run_group(tiny, data, dataclasses.replace(hyper, remat=True),
                         img_size=IMG)


# --- K1's model axis, K1b and K1c: plain versions against the JAX kernels -------


def test_model_axis_plain_mlp_matches_jax_vmap():
    """`tests/test_pallas_mlp.py:81-94`'s data and actives [96, 64, 32]: the
    model-axis plain version (and the CPU dispatch of `fused_mlp`) against
    `jax.vmap(fused_mlp)` in interpret mode within 2e-5 + 1e-4 rel
    (measured 3.6e-7)."""
    rng = np.random.default_rng(42)
    D, M, P = 16, 96, 3
    x = rng.normal(size=(2, 65, D)).astype(np.float32)
    w1 = rng.normal(size=(D, M)).astype(np.float32) * 0.1
    b1 = rng.normal(size=(M,)).astype(np.float32) * 0.1
    w2 = rng.normal(size=(M, D)).astype(np.float32) * 0.1
    b2 = rng.normal(size=(D,)).astype(np.float32) * 0.1
    actives = [96, 64, 32]

    def stack_(a):
        return np.stack([a] * P)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.vmap(pallas_mlp.fused_mlp)(
            *(jnp.asarray(stack_(a)) for a in (x, w1, b1, w2, b2)),
            jnp.asarray(actives))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(stack_(a)))  # noqa: E731
    args = (t(x), t(w1).transpose(1, 2).contiguous(), t(b1),
            t(w2).transpose(1, 2).contiguous(), t(b2),
            torch.tensor(actives, dtype=torch.int32))
    for out in (fused_mlp._plain_mlp(*args), fused_mlp.fused_mlp(*args)):
        assert out.shape == (P, 2, 65, D)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("variant", ["chunked", "pipelined2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_variants_match_jax_variants(monkeypatch, variant, dtype):
    """K1b's plain version (fc2 over 512-column chunks) and K1c's
    (`_plain_mlp`) against the JAX kernels of those variants in interpret
    mode, M = 1,100 (two whole chunks and a partial one), N = 600 (K1c
    crosses a 512-row tile), the width mask at 1,030 columns; the port's
    CPU dispatch under the same variant.  f32 within 2e-5 + 1e-4 rel, bf16
    within 0.05 + 0.05 rel (the JAX bf16 kernel's polynomial GELU); measured
    3.9e-7 (f32) and 0.0039 (bf16)."""
    rng = np.random.default_rng(11)
    N, D, M, active = 600, 16, 1100, 1030
    bound = (6.0 / (D + M)) ** 0.5
    x = rng.normal(size=(N, D)).astype(np.float32)
    w1 = rng.uniform(-bound, bound, size=(D, M)).astype(np.float32)
    b1 = rng.normal(size=(M,)).astype(np.float32) * 0.1
    w2 = rng.uniform(-bound, bound, size=(M, D)).astype(np.float32)
    b2 = rng.normal(size=(D,)).astype(np.float32) * 0.1
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    monkeypatch.setattr(pallas_mlp, "_MLP_VARIANT", variant)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_mlp.fused_mlp(*(jnp.asarray(a).astype(jdt)
                                     for a in (x, w1, b1, w2, b2)), active)
    ref = np.asarray(ref, np.float32)
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(x).to(tdt), torch.from_numpy(w1.T.copy()).to(tdt),
            torch.from_numpy(b1).to(tdt), torch.from_numpy(w2.T.copy()).to(tdt),
            torch.from_numpy(b2).to(tdt))
    plain = (fused_mlp._plain_mlp_chunked if variant == "chunked"
             else fused_mlp._plain_mlp)
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
    tol = dict(atol=0.05, rtol=0.05) if dtype == "bfloat16" else dict(
        atol=2e-5, rtol=1e-4)
    for out in (plain(*args, active), fused_mlp.fused_mlp(*args, active)):
        assert out.dtype == tdt
        np.testing.assert_allclose(out.float().numpy(), ref, **tol)

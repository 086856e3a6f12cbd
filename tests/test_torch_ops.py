"""The port's ops against the JAX package's, on the CPU.

The JAX Pallas kernels run in interpret mode, as the JAX package's own tests
run them (`tests/test_pallas_mlp.py`, `tests/test_ops.py`).  On CPU tensors
the port's kernel wrappers compute their plain versions, which these tests
hold to the JAX kernels; the CUDA kernels themselves are held to the plain
versions on the card (`tests/test_torch_kernels.py`, `chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vit3d_ensemble_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention,
)
from vit3d_ensemble_tpu.ops.pallas_attention import (
    _tiny_attention_impl,
)
from vit3d_ensemble_tpu.ops.pallas_attention import (
    fused_attention as jax_fused_attention,
)
from vit3d_ensemble_tpu.ops.pallas_mlp import _poly_gelu as jax_poly_gelu
from vit3d_ensemble_tpu.ops.pallas_mlp import _reference_mlp as jax_reference_mlp
from vit3d_ensemble_tpu.ops.pallas_mlp import fused_mlp as jax_fused_mlp
from vit3d_ensemble_tpu_torch.ops import _build, attention, fused_attention
from vit3d_ensemble_tpu_torch.ops import fused_mlp as fmlp
from vit3d_ensemble_tpu_torch.ops import mlp as mlp_select


def _mlp_data(seed, D, M, scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 65, D)).astype(np.float32)
    w1 = (rng.normal(size=(D, M)) * scale).astype(np.float32)
    b1 = (rng.normal(size=(M,)) * scale).astype(np.float32)
    w2 = (rng.normal(size=(M, D)) * scale).astype(np.float32)
    b2 = (rng.normal(size=(D,)) * scale).astype(np.float32)
    return x, w1, b1, w2, b2


def _torch_mlp_args(x, w1, b1, w2, b2, dtype=torch.float32):
    """JAX (in, out) kernels -> torch.nn.Linear (out, in) weights."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    return t(x), t(w1.T), t(b1), t(w2.T), t(b2)


def _jax_fused_mlp(args, active, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        out = jax_fused_mlp(*(jnp.asarray(a).astype(dtype) for a in args),
                            active)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("D,M,active", [
    (16, 96, 96), (16, 96, 64),          # test_pallas_mlp.py's shapes
    (64, 3072, 3072), (64, 3072, 2072),  # full width, conf 4-6 class
])
def test_plain_mlp_matches_jax_fused_mlp_f32(D, M, active):
    args = _mlp_data(0, D, M)
    ref = _jax_fused_mlp(args, active)
    out = fmlp.fused_mlp(*_torch_mlp_args(*args), active)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("active", [96, 64])
def test_plain_mlp_matches_jax_fused_mlp_bf16(active):
    """Both round GELU's output to bf16 before fc2, and both take the JAX
    kernel's bf16 GELU, the polynomial within 5.73e-4 of erf GELU
    (`_poly_gelu`; the port's `poly_gelu`)."""
    args = _mlp_data(1, 16, 96)
    ref = _jax_fused_mlp(args, active, jnp.bfloat16)
    out = fmlp.fused_mlp(*_torch_mlp_args(*args, dtype=torch.bfloat16),
                         active)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.05, rtol=0.05)


@pytest.mark.parametrize("active", [3072, 2072])
def test_plain_mlp_matches_jax_fused_mlp_bf16_at_full_width(active):
    """The serving pass's widest class (D 64, M 3,072) in bf16, whole and
    masked, on 130 rows: the JAX kernel in interpret mode against the
    port's plain version, both on the polynomial GELU."""
    args = _mlp_data(12, 64, 3072)
    ref = _jax_fused_mlp(args, active, jnp.bfloat16)
    out = fmlp.fused_mlp(*_torch_mlp_args(*args, dtype=torch.bfloat16),
                         active)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.05, rtol=0.05)


def test_poly_gelu_is_the_jax_kernels_bf16_gelu():
    """The port's copy of `_poly_gelu` against JAX's on the JAX test's grid
    (`tests/test_pallas_mlp.py:54-57`), in f32: both round each product
    and sum on its own, in the same order, so they agree within 1e-6; and
    within that test's 7e-4 of exact GELU."""
    h = np.linspace(-16.0, 16.0, 40001, dtype=np.float32)
    ref = np.asarray(jax_poly_gelu(jnp.asarray(h)))
    out = fmlp.poly_gelu(torch.from_numpy(h))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(h))
    np.testing.assert_allclose(out.numpy(), exact.numpy(), rtol=0, atol=7e-4)


def test_fused_mlp_gradients_match_jax():
    args = _mlp_data(2, 16, 96)
    with pltpu.force_tpu_interpret_mode():
        g_ref = jax.grad(
            lambda *a: jnp.sum(jax_fused_mlp(*a, 64) ** 2),
            argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in args))
    t_args = [t.requires_grad_() for t in _torch_mlp_args(*args)]
    (fmlp.fused_mlp(*t_args, 64) ** 2).sum().backward()
    transposed = (False, True, False, True, False)
    for t, ref, tr in zip(t_args, g_ref, transposed):
        got = t.grad.numpy().T if tr else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(ref), atol=5e-4, rtol=1e-3)
    # masked trailing columns receive zero weight gradients
    assert np.all(t_args[1].grad.numpy()[64:] == 0)
    assert np.all(t_args[3].grad.numpy()[:, 64:] == 0)


def test_fused_mlp_bf16_gradients_are_the_exact_references():
    """In bf16 the forward takes the polynomial GELU, and the backward
    differentiates the exact-erf reference, as JAX's `_bwd` does through
    `_reference_mlp` (`pallas_mlp.py:233-255`).  For one fixed cotangent
    the port's gradients equal autograd's through `_plain_mlp(exact=True)`
    and differ from those through the polynomial forward; and they agree
    with JAX's `_reference_mlp` differentiated in f32 on the same
    bf16-rounded inputs, within the bf16 tolerance of the forward (0.05 +
    0.05 rel: the port rounds h and its gradients to bf16)."""
    args = _mlp_data(13, 16, 96)
    cot = np.random.default_rng(14).normal(size=args[0].shape)
    rounded = [jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)
               for a in (*args, cot)]
    _, vjp = jax.vjp(lambda *a: jax_reference_mlp(*a, 64), *rounded[:5])
    g_ref = vjp(rounded[5])

    def grads(fn):
        leaves = [t.requires_grad_() for t in
                  _torch_mlp_args(*args, dtype=torch.bfloat16)]
        fn(*leaves, 64).backward(torch.from_numpy(cot).bfloat16())
        return [t.grad for t in leaves]

    got = grads(fmlp.fused_mlp)
    exact = grads(lambda *a: fmlp._plain_mlp(*a, exact=True))
    poly = grads(fmlp._plain_mlp)
    assert all(torch.equal(a, b) for a, b in zip(got, exact))
    assert not all(torch.equal(a, b) for a, b in zip(got, poly))
    transposed = (False, True, False, True, False)
    for t, ref, tr in zip(got, g_ref, transposed):
        t = t.float().numpy()
        np.testing.assert_allclose(t.T if tr else t, np.asarray(ref),
                                   atol=0.05, rtol=0.05)


def test_k1_routes_each_call_to_one_body():
    """The body a K1 call takes, by type and hidden size: f32 at D <= 64 on
    the narrow 3xTF32 body, bf16 at D <= 8 on the D = 8 instance of K1c's
    pipeline, bf16 at a wide D on the `wgmma` GEMMs, f32 at a wide D on
    their 3xTF32 form, and bf16 at D 16-64 on K1c's pipeline; the bodies in
    K1c's library are counted apart."""
    for D in (1, 8, 24, 64):
        assert fmlp._k1_body(torch.float32, D) == "narrow_tf32x3"
    for D in (128, 768, 1024):
        assert fmlp._k1_body(torch.float32, D) == "wide_tf32x3"
    for D in (1, 3, 8):
        assert fmlp._k1_body(torch.bfloat16, D) == "wgmma_pipeline_d8"
    assert fmlp._k1_body(torch.bfloat16, 768) == "wide_wgmma"
    for D in (16, 32, 64):
        assert fmlp._k1_body(torch.bfloat16, D) == "wgmma_pipeline"
    assert set(fmlp.K1_BODIES) == {"wgmma_pipeline", "wgmma_pipeline_d8", "narrow_tf32x3",
                                   "wide_wgmma", "wide_tf32x3"}
    assert set(fmlp.K1_BODIES_ON_K1C) == {"wgmma_pipeline", "wgmma_pipeline_d8"}


@pytest.mark.parametrize("n,D,M,active", [
    (513, 768, 3072, 3072), (4104, 768, 3072, 3072), (513, 768, 3072, 2072),
    (4104, 768, 3072, 2072), (70, 768, 256, 200), (1, 768, 3072, 3072),
    (33, 1024, 96, 96), (40, 768, 64, 0),
    # ViT-H's widths, and hidden sizes that neither a stage nor a tile divides
    (513, 1280, 5120, 5120), (4104, 1280, 5120, 5120), (65, 200, 800, 700),
    (513, 1288, 5152, 5152), (65, 8192, 2048, 2000),
])
def test_wide_f32_plan_covers_every_output_once(n, D, M, active):
    """The wide f32 grids on an H100's 132 SMs, for one model and for three
    stacked: every block takes a unit, each phase's units cover every
    (model, row, column) tile of its output once in each of its K splits,
    and the splits cover its K stages once, in order.  The splits depend on
    (n, D, M) alone, so three stacked models split as one does.  A model's
    width (`active`) stops its fc1 column tiles and its fc2 stages.  At the
    stretch shapes the plan fills the waves: fc1 at N = 513 in 240 tiles
    (1.8 waves), fc2 there in two K splits (120 units, one wave), and at N
    = 4,104 12 and 3 whole waves.  A D that a stage (32) or a tile (64) does
    not divide ends in a ragged last one."""
    sms = 132
    bm, bn = fmlp.WIDE_F32_TILE
    stage = fmlp.WIDE_F32_STAGE_K
    one = fmlp.wide_f32_plan(n, D, M, sms)
    for models in (1, 3):
        plan = fmlp.wide_f32_plan(n, D, M, sms, models)
        phases = [(plan["fc1"], -(-M // bn) * bn, -(-D // stage)),
                  (plan["fc2"], D, -(-M // stage))]
        for phase, width, k_stages in phases:
            assert phase["k_stages"] == k_stages and phase["models"] == models
            assert phase["splits"] == one["fc1" if phase["fc1"] else "fc2"]["splits"]
            assert 1 <= phase["blocks"] <= min(sms, phase["units"])
            taken = [u for b in range(phase["blocks"])
                     for u in range(b, phase["units"], phase["blocks"])]
            assert sorted(taken) == list(range(phase["units"]))  # once each
            cover = {}
            for u in range(phase["units"]):
                p, row0, col0, k0, k1 = fmlp.wide_f32_unit(phase, u)
                assert p < models and row0 < n and col0 < width
                assert k1 - k0 >= min(k_stages, fmlp.WIDE_F32_PROMOTE_K // stage)
                cover.setdefault((p, row0, col0), []).append((k0, k1))
                clipped = fmlp.wide_f32_unit(phase, u, active)
                if phase["fc1"]:
                    assert (clipped is None) == (col0 >= active)
                else:
                    assert clipped[:4] == (p, row0, col0, k0)
                    assert clipped[4] == max(k0, min(k1, -(-active // stage)))
            assert len(cover) == models * -(-n // bm) * -(-width // bn)
            for spans in cover.values():
                spans.sort()
                assert spans[0][0] == 0 and spans[-1][1] == k_stages
                assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            if phase["splits"] > 1:
                assert phase["tiles"] < sms // 2 + 1
                assert phase["units"] <= models * sms    # one wave a model
    if (n, M) == (513, 3072):
        assert one["fc1"]["tiles"] == 240 and one["fc1"]["splits"] == 1
        assert (one["fc2"]["tiles"], one["fc2"]["splits"],
                one["fc2"]["units"]) == (60, 2, 120)
    if (n, M) == (4104, 3072):
        assert one["fc1"]["waves"] == 12 and one["fc2"]["waves"] == 3
        assert one["fc1"]["splits"] == one["fc2"]["splits"] == 1


def test_fused_mlp_accepts_tensor_width():
    args = _torch_mlp_args(*_mlp_data(3, 16, 96))
    np.testing.assert_array_equal(
        fmlp.fused_mlp(*args, torch.tensor(40)).numpy(),
        fmlp.fused_mlp(*args, 40).numpy())


ATTN_SHAPES = [
    (2, 4, 65, 16),     # conf-1 regime (B, H, S, hd)
    (3, 8, 65, 4),      # (32, 8) shape class
    (1, 16, 65, 1),     # (16, 16) shape class, head_dim 1
    (2, 4, 5, 16),      # tiny sequence (32px test volumes)
]


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_plain_attention_matches_jax_fused_attention(shape):
    q, k, v = _qkv(shape, 4)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
    out = fused_attention.fused_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)


# K2's plain version in both types, with the bf16 rounding of its
# tensor-core body at head_dim 16 (unnormalised probabilities to bf16),
# against the JAX kernel: the serving shapes, a tiny sequence, and conf
# 19-22's 257 tokens.  The JAX tolerances: 2e-5 in f32, 0.05 in bf16.
K2_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
          torch.bfloat16: dict(atol=0.05, rtol=0.05)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES + [(2, 2, 257, 4)])
def test_k2_plain_matches_jax_tiny_attention(shape, dtype):
    q, k, v = _qkv(shape, 11)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = _tiny_attention_impl(*(jnp.asarray(a).astype(jdt)
                                     for a in (q, k, v)))
    out = fused_attention._plain_attention(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)))
    assert out.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **K2_TOL[dtype])


@pytest.mark.parametrize("H,hd", [(4, 16), (8, 4), (16, 1)])
def test_k2_reads_the_models_qkv_views_in_place(monkeypatch, H, hd):
    """The serving model's q, k, v, views into its (B, T, 3, H, hd) QKV
    product, reach K2's launcher with their own addresses and strides, and
    the context comes back as a view of the (B, T, H, hd) buffer the kernel
    writes, so the merge of the heads copies nothing.  The launcher is
    faked: the CPU has no kernel."""
    calls = []
    monkeypatch.setattr(_build, "entry", lambda *a, **kw: (
        lambda *args: calls.append(args) or 0))
    monkeypatch.setattr(_build, "check", lambda name, err: None)
    monkeypatch.setattr(fused_attention, "_stream", lambda device: 0)
    monkeypatch.setattr(fused_attention, "launches", 0)
    B, T, D = 2, 65, H * hd
    x = torch.randn(B, T, D, dtype=torch.bfloat16)
    w = torch.randn(3 * D, D, dtype=torch.bfloat16)
    qkv = torch.nn.functional.linear(x, w).view(B, T, 3, H, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)        # as `models/vit3d.Attention`
    ctx = fused_attention._launch_k2(q, k, v)
    (args,) = calls
    assert fused_attention.launches == 1
    assert args[1:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[5:9] == (B, H, T, hd)
    assert args[9:18] == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    assert args[9:12] == (T * 3 * D, hd, 3 * D)
    assert args[20] == 1                    # rows may be read 16 bytes a load
    assert ctx.shape == q.shape and ctx.dtype == q.dtype
    merged = ctx.transpose(1, 2).reshape(B, T, D)
    assert merged.data_ptr() == ctx.data_ptr() == args[4]
    assert merged.is_contiguous()
    # a view 2 bytes off a 16-byte boundary is read as it lies, by element
    flat = torch.zeros(1 + B * H * T * hd, dtype=torch.bfloat16)
    odd = flat[1:].view(B, H, T, hd)
    fused_attention._launch_k2(odd, k, v)
    assert calls[-1][1] == odd.data_ptr() and calls[-1][20] == 0
    # a head_dim stride other than 1 is the one layout copied first
    if hd > 1:
        strided = q.transpose(2, 3).contiguous().transpose(2, 3)
        fused_attention._launch_k2(strided, k, v)
        assert calls[-1][1] != strided.data_ptr()
        assert calls[-1][9:12] == (H * T * hd, T * hd, hd)


@pytest.mark.parametrize("impl", ["auto", "plain", "kernel"])
@pytest.mark.parametrize("shape", ATTN_SHAPES[:3])
def test_dot_product_attention_matches_jax_einsum(shape, impl):
    q, k, v = _qkv(shape, 5)
    ref_ctx, ref_probs = jax_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="xla",
        return_probs=True)
    ctx, probs = attention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        return_probs=True, impl=impl)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ref_ctx), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs),
                               atol=1e-6, rtol=1e-5)
    _, none = attention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        impl=impl)
    assert none is None


def test_attention_dropout():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 4, 65, 4), 6))
    ctx0, p0 = attention.dot_product_attention(q, k, v, return_probs=True)
    run = lambda: attention.dot_product_attention(  # noqa: E731
        q, k, v, dropout_p=0.5, deterministic=False, return_probs=True,
        generator=torch.Generator().manual_seed(7))
    ctx1, p1 = run()
    ctx2, _ = run()
    torch.testing.assert_close(p1, p0)           # probs are pre-dropout
    assert not torch.allclose(ctx1, ctx0)        # dropout acted
    torch.testing.assert_close(ctx1, ctx2, rtol=0, atol=0)  # seeded
    # deterministic calls ignore the rate
    ctx3, _ = attention.dot_product_attention(q, k, v, dropout_p=0.5)
    torch.testing.assert_close(ctx3, ctx0, rtol=0, atol=0)


def test_dropout_keeps_expected_share():
    x = torch.ones(200_000)
    y = attention.dropout(x, 0.1, False, torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.005
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))


def test_selectors():
    try:
        attention.set_default_attention_impl("layer")
        assert attention.get_default_attention_impl() == "layer"
        for bad in ("vpu", "xla", "pallas"):
            with pytest.raises(ValueError):
                attention.set_default_attention_impl(bad)
        attention.set_default_attention_impl("plain")
        assert attention.get_default_attention_impl() == "plain"
        q = torch.randn(1, 2, 5, 4)
        # where the sublayer kernel does not apply, 'layer' runs the einsum
        ctx, _ = attention.dot_product_attention(q, q, q, impl="layer")
        ref, _ = attention.dot_product_attention(q, q, q, impl="plain")
        torch.testing.assert_close(ctx, ref, rtol=0, atol=0)
        for bad in ("xla", "pallas"):
            with pytest.raises(ValueError):
                mlp_select.set_default_mlp_impl(bad)
        mlp_select.set_default_mlp_impl("kernel")
        assert mlp_select.get_default_mlp_impl() == "kernel"
    finally:
        attention.set_default_attention_impl("auto")
        mlp_select.set_default_mlp_impl("auto")


def test_cpu_tensors_launch_no_kernel(monkeypatch):
    monkeypatch.setattr(fmlp, "launches", 0)
    monkeypatch.setattr(fused_attention, "launches", 0)
    args = _torch_mlp_args(*_mlp_data(8, 16, 96))
    fmlp.fused_mlp(*args, 64)
    q = torch.zeros(2, 4, 65, 16)
    fused_attention.fused_attention(q, q, q)
    attention.dot_product_attention(q, q, q, impl="kernel")
    assert (fmlp.launches, fused_attention.launches) == (0, 0)
    with pytest.raises(RuntimeError, match="kernel launch on cpu"):
        fmlp._launch(*args, 64)
    with pytest.raises(RuntimeError, match="kernel launch on cpu"):
        fused_attention._launch(q, q, q)


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_cpu_tensors_launch_no_kernel_at_head_dim_64(monkeypatch, impl):
    """K4's regime: on the CPU every impl computes plain math, `auto` the
    einsum and `kernel` K4's plain version, and nothing is launched."""
    monkeypatch.setattr(fused_attention, "launches", 0)
    monkeypatch.setattr(fused_attention, "launches_k4", 0)
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 3, 70, 64), 10))
    ctx, probs = attention.dot_product_attention(q, k, v, impl=impl)
    ref, _ = attention.dot_product_attention(q, k, v, impl="plain")
    assert probs is None
    torch.testing.assert_close(ctx, ref, atol=2e-5, rtol=1e-4)
    assert (fused_attention.launches, fused_attention.launches_k4) == (0, 0)
    with pytest.raises(RuntimeError, match="kernel launch on cpu"):
        fused_attention._launch(q, k, v)


def test_mlp_checks_reject_what_the_kernel_does_not_take():
    x, w1, b1, w2, b2 = _torch_mlp_args(*_mlp_data(9, 16, 96))
    fmlp._check(x, w1, b1, w2, b2)          # accepted
    with pytest.raises(TypeError):
        fmlp._check(*(t.half() for t in (x, w1, b1, w2, b2)))
    # hidden size 12, between the narrow bodies' widths, is taken (it runs
    # zero-padded at 16); so is 8,193, past the widths once refused (on the
    # wide bodies, zero-padded to 8,196 in f32)
    fmlp._check(x[..., :12].contiguous(), w1[:, :12].contiguous(), b1,
                w2[:12].contiguous(), b2[:12].contiguous())
    assert fmlp.kernel_width(12, torch.float32) == 16
    wide = _torch_mlp_args(*_mlp_data(2, 8193, 4))
    fmlp._check(*wide)
    assert fmlp.kernel_width(8193, torch.float32) == 8196
    assert fmlp._variant_body("seq", torch.float32, 8193) == "wide_tf32x3"
    with pytest.raises(ValueError, match="shape"):
        fmlp._check(x, w1, b1, w2.T.contiguous().T[:, :95], b2)
    with pytest.raises(ValueError, match="contiguous"):
        fmlp._check(x, w1, b1, w2.T.contiguous().T, b2)
    with pytest.raises(ValueError, match="bfloat16"):
        fmlp._check(x, w1.bfloat16(), b1, w2, b2)


@pytest.mark.parametrize("models", [1, 15, 30])
@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
def test_k1c_plan_fills_at_most_the_resident_slots(models, per_sm):
    """K1c's grid on 132 SMs at 1-4 resident blocks an SM: never more blocks
    than slots, no block without a tile, every tile in exactly one block's
    run (the kernel's floor(b T / B) rule), runs balanced to within one; at
    the serving shape (one model, 33,280 rows) and the sweep's evaluation
    (1,560 rows a model), in the bf16 body's 128-row and the CUDA-core
    body's 64-row tiles."""
    slots = 132 * per_sm
    for n in (33280, 1560, 1):
        for rows in (128, 64):
            plan = fmlp.k1c_plan(n, models, rows, slots)
            tiles, blocks = plan["tiles_a_model"], plan["blocks_a_model"]
            assert tiles == -(-n // rows)
            assert plan["blocks"] == blocks * models <= slots
            assert 1 <= blocks <= tiles
            runs = [(b + 1) * tiles // blocks - b * tiles // blocks
                    for b in range(blocks)]
            assert sum(runs) == tiles and min(runs) >= 1
            assert max(runs) - min(runs) <= 1
            assert (max(runs), min(runs)) == (plan["most_tiles_a_block"],
                                              plan["fewest_tiles_a_block"])
            assert plan["waves"] <= 1.0


def test_attention_checks_reject_what_the_kernel_does_not_take():
    q = torch.zeros(2, 4, 65, 16)
    fused_attention._check(q, q, q)        # accepted: K2
    big = torch.zeros(2, 12, 513, 64)
    fused_attention._check(big, big, big)  # accepted: K4
    views = [torch.zeros(2, 513, 768).view(2, 513, 12, 64).transpose(1, 2)
             for _ in range(3)]            # as the model makes them
    fused_attention._check(*views)
    # head_dim 48 is taken (K4's body for 48); so is 257, past 256 (its
    # sliced body, two slices)
    odd = torch.zeros(2, 12, 65, 48)
    fused_attention._check(odd, odd, odd)
    odd = torch.zeros(2, 2, 65, 257)
    fused_attention._check(odd, odd, odd)
    assert fused_attention.k4_slices(257) == 2
    with pytest.raises(ValueError, match="along head_dim"):
        strided = torch.zeros(2, 12, 64, 513).transpose(2, 3)
        fused_attention._check(strided, strided, strided)
    # bf16 rows are read by TMA, 16-byte aligned: a view off that alignment
    # is taken and copied first (`_k4_views`); f32 is read as it lies
    flat = torch.arange(1 + 2 * 3 * 70 * 64, dtype=torch.float32)
    odd = flat[1:].view(2, 3, 70, 64)
    fused_attention._check(odd, odd, odd)
    assert all(t is odd for t in fused_attention._k4_views(odd, odd, odd))
    odd = flat.bfloat16()[1:].view(2, 3, 70, 64)
    fused_attention._check(odd, odd, odd)
    copied = fused_attention._k4_views(odd, odd, odd)
    assert all(fused_attention._tma_rows(t) and torch.equal(t, odd)
               for t in copied)
    with pytest.raises(ValueError, match="tokens"):
        long = torch.zeros(1, 1, 1, 32).expand(1, 1, 65535 * 64 + 1, 32)
        fused_attention._check(long, long, long)
    with pytest.raises(TypeError):
        fused_attention._check(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fused_attention._check(q, q[:, :, :64], q)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("fused_mlp")
    assert _build.library_path("fused_mlp").name.startswith("libfused_mlp-")

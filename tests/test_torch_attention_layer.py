"""The port's whole-sublayer attention (K3's path) against the JAX package's,
on the CPU.

The JAX `fused_attention_layer` runs its Pallas kernel in interpret mode, as
`tests/test_ops.py` runs it; on CPU tensors the port's wrapper computes its
plain version, which these tests hold to it.  The CUDA kernel itself is held
to the plain version on the card (`tests/test_torch_kernels.py`,
`chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vit3d_ensemble_tpu.configs import ViTConfig as JaxViTConfig
from vit3d_ensemble_tpu.models import VisionTransformer3D as JaxVisionTransformer3D
from vit3d_ensemble_tpu.ops import attention as jax_attention
from vit3d_ensemble_tpu.ops.pallas_attention_layer import (
    fused_attention_layer as jax_fused_attention_layer,
)
from vit3d_ensemble_tpu_torch.checkpoint import vit_state_from_flax
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
from vit3d_ensemble_tpu_torch.ops import attention, attention_layer, fused_attention

SHAPES = [
    (3, 65, 64, 4),      # conf 1-3 class (hd 16)
    (2, 65, 32, 8),      # (32, 8) class (hd 4)
    (2, 65, 16, 16),     # (16, 16) class (hd 1)
    (2, 5, 16, 4),       # tiny sequence (32px test volumes, hd 4)
    (1, 257, 8, 8),      # conf 20/22 class (p=8: 257 tokens, hd 1)
]


def _layer_data(seed, B, T, D):
    """h and the weights in the JAX layout: wqkv (D, 3D), wout (D, D)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, T, D)).astype(np.float32)
    wqkv = (rng.normal(size=(D, 3 * D)) * 0.3).astype(np.float32)
    bqkv = (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32)
    wout = (rng.normal(size=(D, D)) * 0.3).astype(np.float32)
    bout = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return h, wqkv, bqkv, wout, bout


def _torch_args(h, wqkv, bqkv, wout, bout):
    """JAX (in, out) kernels -> torch.nn.Linear (out, in) weights."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return t(h), t(wqkv.T), t(bqkv), t(wout.T), t(bout)


@pytest.mark.parametrize("B,T,D,H", SHAPES)
def test_plain_attention_layer_matches_jax(B, T, D, H):
    """Measured max abs deviation 8.6e-6 at (3, 65, 64, 4), 3e-7 to 3.3e-6
    at the others (tolerance 2e-5)."""
    args = _layer_data(0, B, T, D)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_attention_layer(*(jnp.asarray(a) for a in args), H)
    out = attention_layer.fused_attention_layer(*_torch_args(*args), H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5), ("bfloat16", 0.05)])
def test_plain_attention_layer_matches_jax_at_head_dim_64(dtype, atol):
    """The stretch model's head_dim 64 at a scaled-down (B, T, D, H) =
    (2, 70, 128, 2), where the port's sublayer takes K4's body and so K4's
    plain version; JAX runs its `_attn_core_kernel` in interpret mode.  f32
    within 2e-5 (measured 4.3e-6); bf16 within the JAX bf16 tolerance 0.05
    + 0.05 * |ref| (measured 0.070 at outputs up to 9.8: K4 rounds the
    unnormalised probabilities, the JAX kernel the normalised ones)."""
    B, T, D, H = 2, 70, 128, 2
    args = _layer_data(7, B, T, D)
    # xavier-scaled projections, so that the scores stay near unit scale
    args = (args[0], args[1] * (32 / D) ** 0.5, args[2],
            args[3] * (32 / D) ** 0.5, args[4])
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_attention_layer(
            *(jnp.asarray(a, dtype=dtype) for a in args), H)
    torch_dtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    out = attention_layer.fused_attention_layer(
        *(t.to(torch_dtype) for t in _torch_args(*args)), H)
    assert out.dtype == torch_dtype and out.shape == (B, T, D)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=atol, rtol=atol if dtype != np.float32
                               else 1e-4)


@pytest.mark.parametrize("hd,sliced", [(32, False), (64, False), (128, False),
                                       (24, False), (48, False), (256, False),
                                       (257, True), (512, True), (1024, True)])
def test_check_takes_k4_head_dims(hd, sliced):
    """Every head_dim above 16 passes `_check` on K4's route (the QKV
    buffer's views pass K4's checks), those above 256 on its sliced
    bodies."""
    H = 2
    q, k, v = attention_layer._split(torch.zeros(2, 65, 3 * H * hd,
                                                 dtype=torch.bfloat16))
    attention_layer._check(q, k, v, H)
    assert attention_layer.on_k4(hd)
    assert (fused_attention.k4_slices(hd) > 1) == sliced


@pytest.mark.parametrize("hd", list(range(1, 17)))
def test_check_takes_every_head_dim_up_to_16(hd):
    """Every head_dim up to 16 passes `_check` on K2's route, in f32 and on
    bf16 views at any alignment (K2's body reads by element where 16-byte
    loads do not fit), as JAX's `_attn_core_kernel` takes any head_dim."""
    H = 3
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.zeros(2, 65, 3 * H * hd + 1, dtype=dtype)
        attention_layer._check(*attention_layer._split(buf[..., 1:]), H)
        attention_layer._check(*attention_layer._split(buf[..., :-1]), H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", SHAPES + [(2, 65, 16, 8), (2, 65, 64, 8)])
def test_k2_reads_the_head_views_strides(dtype, B, T, D, H):
    """K3 hands K2 its (B, T, D) views with the head count, not the (B, H,
    T, hd) views: K2's `tiny_attention_qkv_launch` reads each view's heads
    at the (volume, head, token) strides (stride(0), D / H, stride(1)).
    Those are the head views' own, on the QKV buffer and on views of a wider
    row at an odd offset, and the three views share them."""
    wide = torch.zeros(B, T, 3 * D + 3, dtype=dtype)
    for qkv in (torch.zeros(B, T, 3 * D, dtype=dtype), wide[..., 1:3 * D + 1]):
        q, k, v = attention_layer._split(qkv)
        attention_layer._check(q, k, v, H)
        for t in (q, k, v):
            heads = attention_layer._heads(t, H)
            assert tuple(heads.shape) == (B, H, T, D // H)
            assert heads.stride()[:3] == (q.stride(0), D // H, q.stride(1))
            assert heads.stride(3) == 1


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5), ("bfloat16", 0.05)])
@pytest.mark.parametrize("D,H", [(16, 8), (64, 8)])
def test_plain_attention_layer_matches_jax_at_head_dims_2_and_8(dtype, atol,
                                                               D, H):
    """head_dim 2 and 8, which no registry config has and JAX's kernel
    takes: the port's sublayer on K2's plain version (CUDA cores: scores,
    softmax and context in f32) against the JAX kernel in interpret mode,
    f32 within 2e-5, bf16 within the JAX bf16 tolerance 0.05 + 0.05 * |ref|
    (both round the projections to bf16, at other points)."""
    B, T = 2, 65
    args = _layer_data(11, B, T, D)
    # projections of standard deviation 1 / sqrt(D), so that q, k, v and the
    # output have unit scale
    args = (args[0], args[1] / (0.3 * D ** 0.5), args[2],
            args[3] / (0.3 * D ** 0.5), args[4])
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_attention_layer(
            *(jnp.asarray(a, dtype=dtype) for a in args), H)
    torch_dtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    out = attention_layer.fused_attention_layer(
        *(t.to(torch_dtype) for t in _torch_args(*args)), H)
    assert out.dtype == torch_dtype and out.shape == (B, T, D)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=atol, rtol=atol if dtype != np.float32
                               else 1e-4)


def test_check_refuses_misaligned_bf16_views_on_k4_route():
    """K4 reads bf16 rows by TMA, 16-byte aligned: a QKV buffer whose views
    are not (here one element in; likewise any head_dim that 8 does not
    divide) passes `_check`, and the launch copies the views into buffers
    whose rows are (`fused_attention._k4_views`) instead of refusing them."""
    buf = torch.arange(2 * 65 * (3 * 128 + 1), dtype=torch.float32)
    buf = buf.view(2, 65, 3 * 128 + 1).bfloat16()
    q, k, v = attention_layer._split(buf[..., 1:])
    attention_layer._check(q, k, v, 2)
    heads = [attention_layer._heads(t, 2) for t in (q, k, v)]
    assert not any(fused_attention._tma_rows(t) for t in heads)
    copied = fused_attention._k4_views(*heads)
    assert all(fused_attention._tma_rows(t) and torch.equal(t, h)
               for t, h in zip(copied, heads))


def test_attention_layer_gradients_match_jax_vjp():
    """Every input's gradient under one fixed cotangent (as
    `tests/test_ops.py:107-137` compares them), of scale 0.1 so that the
    gradients stay under 10: f32 sums of 130 rows then differ by under
    2e-5.  Measured max abs deviation 6.2e-6 at gradients up to 8.6
    (tolerance 2e-5; at unit scale the same run deviates 6.0e-5 at 86, the
    same 7e-7 relative)."""
    B, T, D, H = 2, 65, 32, 8
    args = _layer_data(1, B, T, D)
    g = (np.random.default_rng(2).normal(size=(B, T, D)) * 0.1).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: jax_fused_attention_layer(*a, H),
                         *(jnp.asarray(a) for a in args))
        ref = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in _torch_args(*args)]
    out = attention_layer.fused_attention_layer(*leaves, H)
    out.backward(torch.from_numpy(g))
    transposed = (False, True, False, True, False)
    for t, r, tr in zip(leaves, ref, transposed):
        got = t.grad.numpy().T if tr else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(r), atol=2e-5, rtol=1e-4)


def test_plain_core_reads_strided_views():
    """The core takes q, k, v as views of one (B, T, 3D) tensor, and of a
    wider buffer, and equals it on contiguous copies."""
    rng = np.random.default_rng(3)
    wide = torch.from_numpy(rng.normal(size=(2, 65, 3 * 32 + 5))
                            .astype(np.float32))
    q, k, v = attention_layer._split(wide[..., 5:])
    out = attention_layer.attention_core(q, k, v, 8)
    ref = attention_layer._plain_attention_core(
        q.contiguous(), k.contiguous(), v.contiguous(), 8)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    bf = attention_layer.attention_core(q.bfloat16(), k.bfloat16(),
                                        v.bfloat16(), 8)
    assert bf.dtype == torch.bfloat16 and bf.shape == (2, 65, 32)


_PAIR = {}


def _pair():
    """A JAX model and the port's on its converted weights: (32, 8) class
    (hd 4), 32 px volumes, attention dropout 0 and dropout 0.1."""
    if not _PAIR:
        kw = dict(patch_size=(16, 16, 5), hidden_size=32, num_heads=8,
                  mlp_dim=64, num_layers=2, img_size=32)
        jmodel = JaxVisionTransformer3D(JaxViTConfig(**kw), zero_head=False,
                                        vis=False)
        x = np.random.default_rng(4).normal(size=(2, 32, 32, 5, 1)).astype(
            np.float32)
        # jitted: flax's eager init takes seconds of op dispatch
        params = jax.device_get(jax.jit(jmodel.init)(
            {"params": jax.random.key(5)}, jnp.asarray(x))["params"])
        tmodel = VisionTransformer3D(ViTConfig(**kw), vis=False, device="cpu")
        tmodel.load_state_dict(vit_state_from_flax(params, ViTConfig(**kw)))
        _PAIR.update(jmodel=jmodel, params=params, tmodel=tmodel, x=x, kw=kw)
    return _PAIR


def test_model_under_layer_matches_jax(monkeypatch):
    """impl 'layer' in both frameworks, deterministic: logits within 2e-5
    (measured 4.8e-7), tokens within 2e-4 (measured 2.3e-6).  On CPU
    tensors the port's layer path is the plain math and launches nothing."""
    p = _pair()
    monkeypatch.setattr(attention_layer, "launches", 0)
    jax_attention.set_default_attention_impl("layer")
    attention.set_default_attention_impl("layer")
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = p["jmodel"].apply({"params": p["params"]},
                                    jnp.asarray(p["x"]), deterministic=True)
        with torch.no_grad():
            out = p["tmodel"](torch.from_numpy(p["x"]))
    finally:
        jax_attention.set_default_attention_impl("auto")
        attention.set_default_attention_impl("auto")
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.tokens.numpy(), np.asarray(ref.tokens),
                               atol=2e-4, rtol=1e-4)
    assert attention_layer.launches == 0


def test_layer_path_equals_einsum_path_in_training():
    """With attention dropout 0 the layer path draws no dropout numbers, so
    a training forward under 'layer' equals the einsum path's under the same
    generator seed (the JAX property of `tests/test_ops.py:69-104`).
    Measured deviation 0 (tolerance 2e-6)."""
    p = _pair()
    x = torch.from_numpy(p["x"])
    outs = []
    for impl in ("layer", "plain"):
        attention.set_default_attention_impl(impl)
        try:
            with torch.no_grad():
                outs.append(p["tmodel"](
                    x, deterministic=False,
                    generator=torch.Generator().manual_seed(0)).logits)
        finally:
            attention.set_default_attention_impl("auto")
    torch.testing.assert_close(outs[0], outs[1], atol=2e-6, rtol=1e-5)


def test_vis_mode_and_active_dropout_fall_to_einsum(monkeypatch):
    """Probabilities requested, or attention dropout active: the layer
    kernel does not apply, and the call runs the einsum path."""
    p = _pair()
    vis = VisionTransformer3D(ViTConfig(**p["kw"]), vis=True, device="cpu")
    vis.load_state_dict(p["tmodel"].state_dict())
    called = []
    monkeypatch.setattr(
        "vit3d_ensemble_tpu_torch.models.vit3d.fused_attention_layer",
        lambda *a: called.append(a))
    attention.set_default_attention_impl("layer")
    try:
        with torch.no_grad():
            out = vis(torch.from_numpy(p["x"]))
            drop = VisionTransformer3D(
                ViTConfig(**p["kw"], attention_dropout_rate=0.1), vis=False,
                device="cpu")
            drop(torch.from_numpy(p["x"]), deterministic=False,
                 generator=torch.Generator().manual_seed(0))
            q = torch.randn(1, 2, 5, 4)
            ctx, _ = attention.dot_product_attention(q, q, q, impl="layer")
    finally:
        attention.set_default_attention_impl("auto")
    assert called == []
    assert out.attn_weights.shape == (2, 2, 8, 5, 5)
    ref, _ = attention.dot_product_attention(q, q, q, impl="plain")
    torch.testing.assert_close(ctx, ref, rtol=0, atol=0)


def test_checks_reject_what_the_kernel_does_not_take():
    qkv = torch.zeros(2, 65, 96)
    q, k, v = attention_layer._split(qkv)
    attention_layer._check(q, k, v, 8)          # accepted: strided views
    attention_layer._check(q, k, v, 32)         # hd 1 accepted
    wide = torch.zeros(2, 65, 240)              # hd 20 accepted: K4's body
    attention_layer._check(*attention_layer._split(wide), 4)
    widest = torch.zeros(2, 65, 3 * 257)         # hd 257 accepted: K4's sliced body
    attention_layer._check(*attention_layer._split(widest), 1)
    assert attention_layer.on_k4(257) and fused_attention.k4_slices(257) == 2
    with pytest.raises(ValueError, match="do not divide"):
        attention_layer._check(q, k, v, 5)
    with pytest.raises(TypeError):
        attention_layer._check(q.half(), k.half(), v.half(), 8)
    with pytest.raises(ValueError, match="strides"):
        attention_layer._check(q, k.contiguous(), v, 8)
    with pytest.raises(ValueError, match="unit column stride"):
        t = torch.zeros(2, 65, 64)[..., ::2]
        attention_layer._check(t, t, t, 8)
    with pytest.raises(ValueError, match=r"\(B, T, D\)"):
        attention_layer._check(q[0], k[0], v[0], 8)


def test_cpu_tensors_launch_no_kernel(monkeypatch):
    monkeypatch.setattr(attention_layer, "launches", 0)
    args = _torch_args(*_layer_data(6, 2, 65, 16))
    attention_layer.fused_attention_layer(*args, 16)
    attention_layer.attention_core(*attention_layer._split(
        torch.zeros(2, 65, 48)), 16)
    assert attention_layer.launches == 0
    with pytest.raises(RuntimeError, match="kernel launch on cpu"):
        attention_layer._launch(*attention_layer._split(
            torch.zeros(2, 65, 48)), 16)

"""The port's stretch slice against the JAX package's, on the CPU: K4's and
wide K1's plain versions and the 3xTF32 arithmetic of their f32 bodies, a
scaled-down `vit_b16_128cubed` as a whole, and the weight conversion at the
full config's shapes.

Inputs and weights are made with numpy from a seed and handed to both
frameworks.  The JAX Pallas kernels run in interpret mode, as the JAX
package's own tests run them; its selectors are restored afterwards.  On CPU
tensors the port's kernel wrappers compute their plain versions; the CUDA
kernels themselves are held to those on the card
(`tests/test_torch_kernels.py`, `chip_smoke.py`).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vit3d_ensemble_tpu.configs import (
    ViTConfig as JaxViTConfig,
    vit_b16_128cubed as jax_vit_b16_128cubed,
)
from vit3d_ensemble_tpu.models import (
    VisionTransformer3D as JaxVisionTransformer3D,
)
from vit3d_ensemble_tpu.ops.attention import (
    set_default_attention_impl as jax_set_attention,
)
from vit3d_ensemble_tpu.ops.mlp import set_default_mlp_impl as jax_set_mlp
from vit3d_ensemble_tpu.ops.pallas_attention import (
    fused_attention as jax_fused_attention,
)
from vit3d_ensemble_tpu.ops.pallas_mlp import fused_mlp as jax_fused_mlp
from vit3d_ensemble_tpu_torch.checkpoint import vit_state_from_flax
from vit3d_ensemble_tpu_torch.configs import ViTConfig, vit_b16_128cubed
from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
from vit3d_ensemble_tpu_torch.ops import attention, fused_attention
from vit3d_ensemble_tpu_torch.ops import fused_mlp as fmlp
from vit3d_ensemble_tpu_torch.ops import mlp as mlp_select


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _jax_attention(q, k, v, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        out = jax_fused_attention(*(jnp.asarray(a).astype(dtype)
                                    for a in (q, k, v)))
    return np.asarray(out.astype(jnp.float32))


# (B, H, S, hd) with hd > 16: the JAX wrapper takes `_attention_kernel`.
# Then the token counts where K4's tiling on the card is most likely to
# break: S = 513 (a last key chunk of one key, a query tile of one row),
# 64 and 128 (no tail), 1 and 15 (fewer keys than the narrowest chunk),
# 200 at hd 32 and 128.
K4_SHAPES = [(2, 2, 70, 64), (1, 3, 130, 32), (2, 2, 513, 64), (2, 2, 64, 64),
             (2, 2, 128, 64), (2, 2, 1, 64), (2, 2, 15, 64), (2, 2, 200, 32),
             (2, 2, 200, 128)]


@pytest.mark.parametrize("shape", K4_SHAPES)
def test_plain_attention_k4_matches_jax_fused_attention_f32(shape):
    q, k, v = _qkv(shape, 0)
    out = fused_attention.fused_attention(*(torch.from_numpy(a)
                                            for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), _jax_attention(q, k, v),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", K4_SHAPES)
def test_plain_attention_k4_matches_jax_fused_attention_bf16(shape):
    """The JAX kernel rounds the normalised probabilities to bf16 before the
    second product, the port the unnormalised ones: both within the JAX
    package's bf16 tolerance of each other."""
    q, k, v = _qkv(shape, 1)
    out = fused_attention.fused_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               _jax_attention(q, k, v, jnp.bfloat16),
                               atol=0.05, rtol=0.05)


def _tf32(x):
    """x rounded to TF32 as `cvt.rna.tf32.f32` rounds it on the card: 10
    mantissa bits, to nearest, ties away from zero (finite x: the carry of
    adding half an ulp of TF32 to the magnitude's bits rounds it up)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32x3(a, b):
    """a @ b as K4's f32 body computes it on the tensor cores: each operand
    split into TF32 hi and lo (lo = tf32(x - hi)), and lo_a hi_b + hi_a lo_b
    + hi_a hi_b summed in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tf32x1(a, b):
    """a @ b as one TF32 product."""
    return _tf32(a) @ _tf32(b)


def _emulated_k4_f32(q, k, v, product):
    """K4's f32 function with both products taken by `product`: the
    unnormalised probabilities exp(s - max) in f32, the context divided by
    the f32 row sums once (`_plain_attention_k4`'s rounding)."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    scores = product(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return (product(e, v) / e.sum(dim=-1, keepdim=True)).numpy()


def _k4_f32_inputs(shape, seed):
    """q, k unit normal, v scaled by sqrt(S / e) so that the context's root
    mean square is 1 at every S, as the card tests make them."""
    q, k, v = _qkv(shape, seed)
    return q, k, (v * np.float32(math.sqrt(shape[2] / math.e)))


@pytest.mark.parametrize("shape", K4_SHAPES)
def test_tf32x3_emulation_matches_jax_fused_attention_f32(shape):
    """Both products of K4's f32 body in 3xTF32, emulated to the bit of the
    operand splits, hold the JAX tolerance against JAX's f32 kernel."""
    q, k, v = _k4_f32_inputs(shape, 4)
    np.testing.assert_allclose(_emulated_k4_f32(q, k, v, _tf32x3),
                               _jax_attention(q, k, v), atol=2e-5, rtol=1e-4)


def test_one_tf32_product_misses_the_jax_tolerance():
    """The same with one TF32 product a product fails it: the tolerance
    tells 3xTF32 from TF32."""
    q, k, v = _k4_f32_inputs((2, 2, 513, 64), 4)
    x = torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert _tf32(x).tolist() == [1.0, 1 + 2.0 ** -10, 1 + 2 * 2.0 ** -10,
                                 -(1 + 2.0 ** -10)]  # ties away from zero
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_emulated_k4_f32(q, k, v, _tf32x1),
                                   _jax_attention(q, k, v), atol=2e-5,
                                   rtol=1e-4)


def test_plain_attention_k4_takes_the_models_strided_views():
    """(B, H, S, hd) views of (B, S, H * hd) projections, as the model makes
    them, give what their contiguous copies give."""
    B, H, S, hd = K4_SHAPES[0]
    rng = np.random.default_rng(2)
    views = [torch.from_numpy(rng.normal(size=(B, S, H * hd)).astype(np.float32))
             .view(B, S, H, hd).transpose(1, 2) for _ in range(3)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(
        fused_attention.fused_attention(*views),
        fused_attention.fused_attention(*(t.contiguous() for t in views)),
        rtol=0, atol=0)


def test_fused_attention_k4_gradients_match_jax():
    q, k, v = _qkv(K4_SHAPES[0], 3)
    with pltpu.force_tpu_interpret_mode():
        g_ref = jax.grad(
            lambda *a: jnp.sum(jax_fused_attention(*a) ** 2),
            argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (fused_attention.fused_attention(*leaves) ** 2).sum().backward()
    for t, ref in zip(leaves, g_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-3)


def _mlp_data(seed, N, D, M):
    rng = np.random.default_rng(seed)
    bound = (6.0 / (D + M)) ** 0.5          # the model's xavier init
    x = rng.normal(size=(N, D)).astype(np.float32)
    w1 = rng.uniform(-bound, bound, size=(D, M)).astype(np.float32)
    b1 = (rng.normal(size=(M,)) * 0.1).astype(np.float32)
    w2 = rng.uniform(-bound, bound, size=(M, D)).astype(np.float32)
    b2 = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("N,D,M,active", [
    (130, 128, 512, 512), (130, 128, 512, 300),
    (18, 768, 256, 200),                    # the stretch model's width
])
def test_plain_mlp_matches_jax_fused_mlp_at_wide_d(N, D, M, active):
    x, w1, b1, w2, b2 = _mlp_data(4, N, D, M)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_mlp(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                            active)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = fmlp.fused_mlp(t(x), t(w1.T), t(b1), t(w2.T), t(b2), active)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)
    fmlp._check(t(x), t(w1.T), t(b1), t(w2.T), t(b2))   # a width K1 takes


def _rz(x):
    """f64 values rounded toward zero to f32 (kept as f64)."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y).double()


def _k1_tf32x3(a, b, promote_k=fmlp.WIDE_F32_PROMOTE_K):
    """a @ b^T as K1's wide f32 body takes it on the tensor cores: each
    operand split into TF32 hi and lo; per k-step of 8, lo_a hi_b and hi_a
    lo_b added into `small` and hi_a hi_b into `big`, each accumulator's sum
    rounded toward zero to f32 (a mild model of the tensor cores'
    truncation); both from 0 for every `promote_k` of K, then added into an
    f32 sum."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    ah, bh, al, bl = (t.double() for t in (ah, bh, al, bl))
    K = a.shape[-1]
    total = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, K, promote_k):
        big = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float64)
        small = torch.zeros_like(big)
        for k in range(k0, min(k0 + promote_k, K), 8):
            s = slice(k, k + 8)
            small = _rz(small + al[:, s] @ bh[:, s].T)
            small = _rz(small + ah[:, s] @ bl[:, s].T)
            big = _rz(big + ah[:, s] @ bh[:, s].T)
        total = total + (big.float() + small.float())
    return total


def _emulated_k1_f32(x, w1, b1, w2, b2, active, product):
    """K1's f32 function (nn.Linear layout) with both products taken by
    `product(a, b)` = a @ b^T: h = gelu(x w1^T + b1) with exact erf, columns
    at or past `active` zeroed, h unrounded (f32 is the input type), then
    h w2^T + b2."""
    h = F.gelu(product(x, w1) + b1)
    h[:, active:] = 0
    return product(h, w2) + b2


def _f64_mlp(x, w1, b1, w2, b2, active):
    """K1's function in f64 from the f32 inputs: the exact result."""
    x, w1, b1, w2, b2 = (t.double() for t in (x, w1, b1, w2, b2))
    h = x @ w1.T + b1
    h = 0.5 * h * (1 + torch.erf(h / math.sqrt(2)))
    h[:, active:] = 0
    return h @ w2.T + b2


def _wide_mlp_inputs(N, D, M, x_scale=1.0):
    """The test's inputs as numpy (JAX layout) and as the port's tensors
    (nn.Linear layout)."""
    x, w1, b1, w2, b2 = _mlp_data(4, N, D, M)
    x = x * np.float32(x_scale)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (x, w1, b1, w2, b2), (t(x), t(w1.T), t(b1), t(w2.T), t(b2))


@pytest.mark.parametrize("N,D,M,active", [(18, 768, 256, 200),
                                          (18, 768, 3072, 3072)])
def test_k1_wide_tf32x3_emulation_matches_jax_fused_mlp(N, D, M, active):
    """Both products of K1's wide f32 body in 3xTF32 with its promotion
    interval, emulated to the bit of the operand splits, hold the JAX
    tolerance against JAX's f32 kernel, at a masked width and at the
    stretch model's full width."""
    (xn, *wn), args = _wide_mlp_inputs(N, D, M)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_mlp(*(jnp.asarray(a) for a in (xn, *wn)), active)
    np.testing.assert_allclose(
        _emulated_k1_f32(*args, active, _k1_tf32x3).numpy(), np.asarray(ref),
        atol=2e-5, rtol=1e-4)


def test_k1_wide_tf32x3_with_x_four_times_larger():
    """x four times larger at the full width: the emulated body holds the
    f32 tolerance against the exact (f64) MLP.  One accumulator over all of
    K (no promotion) misses it: fc2's K = 3,072 is where the truncation
    adds up."""
    _, args = _wide_mlp_inputs(18, 768, 3072, x_scale=4.0)
    ref = _f64_mlp(*args, 3072).numpy()
    np.testing.assert_allclose(
        _emulated_k1_f32(*args, 3072, _k1_tf32x3).numpy(), ref, atol=2e-5,
        rtol=1e-4)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(
            _emulated_k1_f32(*args, 3072, lambda a, b: _k1_tf32x3(a, b, 3072))
            .numpy(), ref, atol=2e-5, rtol=1e-4)


def test_one_tf32_product_misses_the_jax_tolerance_in_k1():
    """K1's wide f32 function with one TF32 product a product fails the
    JAX tolerance against JAX's f32 kernel: the tolerance tells 3xTF32 from
    TF32."""
    (xn, *wn), args = _wide_mlp_inputs(18, 768, 256)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_mlp(*(jnp.asarray(a) for a in (xn, *wn)), 200)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(
            _emulated_k1_f32(*args, 200, lambda a, b: _tf32x1(a, b.T)).numpy(),
            np.asarray(ref), atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The slice as a whole: the stretch config's shape class at a small size
# (z-patching, D > 64 so separate q/k/v projections, head_dim 64).
# ---------------------------------------------------------------------------

_SMALL = dict(patch_size=(16, 16, 16), hidden_size=128, num_heads=2,
              mlp_dim=256, num_layers=2, img_size=32, z_size=32)
_PAIR = []


def _pair():
    """(JAX params as numpy, the port's model on the CPU)."""
    if not _PAIR:
        jmodel = JaxVisionTransformer3D(JaxViTConfig(**_SMALL),
                                        zero_head=False, vis=False)
        x = jnp.zeros((1, 32, 32, 32, 1), jnp.float32)
        params = jax.device_get(
            jax.jit(jmodel.init)(jax.random.key(0), x)["params"])
        rng = np.random.default_rng(5)
        emb = params["embeddings"]
        for name in ("position_embeddings", "cls_token"):
            emb[name] = (rng.normal(size=emb[name].shape) * 0.02).astype(
                np.float32)
        cfg = ViTConfig(**_SMALL)
        tmodel = VisionTransformer3D(cfg, zero_head=True, vis=False,
                                     device="cpu")
        tmodel.load_state_dict(vit_state_from_flax(params, cfg))
        tmodel.eval()
        _PAIR.append((params, tmodel))
    return _PAIR[0]


def _volumes(seed, B=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, 32, 32, 32, 1)).astype(np.float32)


def _jax_apply(params, x, vis):
    """The JAX model on its Pallas MLP and Pallas attention (K1 and K4)."""
    jmodel = JaxVisionTransformer3D(JaxViTConfig(**_SMALL), zero_head=False,
                                    vis=vis)
    jax_set_mlp("pallas")
    jax_set_attention("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            return jmodel.apply({"params": params}, jnp.asarray(x),
                                deterministic=True)
    finally:
        jax_set_mlp("xla")
        jax_set_attention("auto")


def _torch_apply(tmodel, x, vis, attn_impl="auto", mlp_impl="auto"):
    attention.set_default_attention_impl(attn_impl)
    mlp_select.set_default_mlp_impl(mlp_impl)
    tmodel.vis = vis
    try:
        with torch.no_grad():
            return tmodel(torch.from_numpy(x))
    finally:
        tmodel.vis = False
        attention.set_default_attention_impl("auto")
        mlp_select.set_default_mlp_impl("auto")


@pytest.mark.parametrize("attn_impl,mlp_impl", [
    ("kernel", "kernel"), ("auto", "auto"), ("layer", "auto")])
def test_small_stretch_model_matches_jax(attn_impl, mlp_impl):
    params, tmodel = _pair()
    x = _volumes(6)
    ref = _jax_apply(params, x, vis=False)
    out = _torch_apply(tmodel, x, False, attn_impl, mlp_impl)
    assert out.tokens.shape == (2, 9, 128) and out.attn_weights is None
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out.tokens.numpy(), np.asarray(ref.tokens),
                               atol=2e-4, rtol=1e-4)


def test_small_stretch_model_attention_maps_match_jax():
    params, tmodel = _pair()
    x = _volumes(7)
    ref = _jax_apply(params, x, vis=True)
    out = _torch_apply(tmodel, x, True, "kernel", "kernel")
    assert out.attn_weights.shape == (2, 2, 2, 9, 9)
    np.testing.assert_allclose(out.attn_weights.numpy(),
                               np.asarray(ref.attn_weights), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(out.tokens.numpy(), np.asarray(ref.tokens),
                               atol=2e-4, rtol=1e-4)


def test_z_patching_matmul_equals_strided_conv():
    """Patchify as reshape plus one matmul at a (2, 2, 2) grid equals
    `F.conv3d` on the z-tiled volume (`tests/test_stretch.py:37-46`)."""
    _, tmodel = _pair()
    pe = tmodel.transformer.embeddings.patch_embeddings
    x = torch.from_numpy(_volumes(8))
    conv = F.conv3d(x.permute(0, 4, 1, 2, 3), pe.weight, pe.bias,
                    stride=(16, 16, 16))
    with torch.no_grad():
        got = pe(x)
    assert got.shape == (2, 8, 128)
    torch.testing.assert_close(got, conv.flatten(2).transpose(1, 2),
                               atol=1e-4, rtol=1e-4)


def test_state_conversion_covers_the_full_stretch_config():
    """`vit_state_from_flax` on the parameter shapes of `vit_b16_128cubed`
    (separate (D, H, hd) projections at D = 768, a (16, 16, 16, 1, D) patch
    kernel), taken with `jax.eval_shape` so that no init runs; the result
    loads into the port's full-size model, names and shapes."""
    jmodel = JaxVisionTransformer3D(jax_vit_b16_128cubed(), zero_head=True,
                                    vis=False)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0),
        jax.ShapeDtypeStruct((1, 128, 128, 128, 1), jnp.float32))["params"]
    attn = shapes["encoder"]["layers"]["block"]["attn"]
    assert attn["query"]["kernel"].shape == (12, 768, 12, 64)
    assert shapes["embeddings"]["patch_embeddings"]["kernel"].shape == (
        16, 16, 16, 1, 768)
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    cfg = vit_b16_128cubed()
    state = vit_state_from_flax(zeros, cfg)
    assert state["transformer.encoder.layer.11.attn.key.weight"].shape == (
        768, 768)
    assert state["transformer.embeddings.position_embeddings"].shape == (
        1, 513, 768)
    n_params = sum(t.numel() for t in state.values())
    assert n_params == sum(int(np.prod(s.shape))
                           for s in jax.tree.leaves(shapes))
    assert 88e6 < n_params < 89e6
    tmodel = VisionTransformer3D(cfg, device="cpu")
    tmodel.load_state_dict(state)       # strict: every name, every shape

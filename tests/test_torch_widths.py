"""K1, K4 and K3 at every width the JAX kernels take, on the CPU: each
against the JAX package's Pallas kernel (interpret mode, as the JAX
package's own tests run it) at hidden sizes and head dims outside the
registry's (K1, K1b and K1c above 8,192, K4 and K3 above head_dim 256 too),
a two-layer model of ViT-H's head_dim 80 and a one-layer model of two heads
of 512 against JAX's on its Pallas impls, and the shape rules of the kernel
wrappers.

Inputs and weights are made with numpy from a seed and handed to both
frameworks.  On CPU tensors the port's wrappers compute their plain
versions; the padding the wrappers apply before a launch (K1's
`kernel_operands`, K4's zero columns up to `k4_body_hd` and its bf16 copies,
`_k4_views`) is held here to the unpadded function, and the CUDA kernels
themselves to their plain versions on the card (`tests/test_torch_kernels.py`,
`chip_smoke.py`, phase `vit_h`).

    python -m pytest tests/test_torch_widths.py -q
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vit3d_ensemble_tpu.ops import pallas_mlp

from vit3d_ensemble_tpu.configs import ViTConfig as JaxViTConfig
from vit3d_ensemble_tpu.models import VisionTransformer3D as JaxVisionTransformer3D
from vit3d_ensemble_tpu.ops.attention import (
    set_default_attention_impl as jax_set_attention,
)
from vit3d_ensemble_tpu.ops.mlp import set_default_mlp_impl as jax_set_mlp
from vit3d_ensemble_tpu.ops.pallas_attention import (
    fused_attention as jax_fused_attention,
)
from vit3d_ensemble_tpu.ops.pallas_attention_layer import (
    fused_attention_layer as jax_fused_attention_layer,
)
from vit3d_ensemble_tpu.ops.pallas_mlp import fused_mlp as jax_fused_mlp
from vit3d_ensemble_tpu_torch.checkpoint import vit_state_from_flax
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
from vit3d_ensemble_tpu_torch.ops import attention, attention_layer, fused_attention
from vit3d_ensemble_tpu_torch.ops import fused_mlp as fmlp
from vit3d_ensemble_tpu_torch.ops import mlp as mlp_select

from test_torch_attention_layer import _layer_data
from test_torch_stretch import _mlp_data, _qkv

# The JAX package's tolerances for its kernels (`tests/test_pallas_mlp.py:31,
# 47`, `tests/test_ops.py:31`); in bf16 K4's plain version rounds the
# unnormalised probabilities and JAX's kernel the normalised ones (ROADMAP
# §3), both within the bf16 tolerance of each other.
TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=0.05, rtol=0.05)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _close(out, ref, dtype):
    np.testing.assert_allclose(np.asarray(out, dtype=np.float32),
                               np.asarray(ref, dtype=np.float32), **TOL[dtype])


# --- K1 ---------------------------------------------------------------------


# hidden sizes outside the registry's {8, 16, 32, 64} and the old wide set
# (multiples of 64 up to 1,024), and ViT-H's 1,280, with M = 4 D and a width
# mask below M; token rows from 8 to 65
K1_CASES = [(24, 65), (48, 65), (96, 33), (200, 17), (1280, 8)]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("D,N", K1_CASES)
def test_k1_matches_jax_at_every_width(dtype, D, N):
    """The port's K1 (on the CPU its plain version) against JAX's
    `_mlp_kernel` in interpret mode; and the zero-padded operands the
    wrapper hands the kernel at a width it is not built for
    (`kernel_operands`), cut back to D, against the unpadded function."""
    M = 4 * D
    active = M - D // 2
    torch_dtype, jax_dtype = DTYPES[dtype]
    x, w1, b1, w2, b2 = _mlp_data(D, N, D, M)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_mlp(*(jnp.asarray(a, jax_dtype) for a in (x, w1, b1, w2, b2)),
                            active)
    args = tuple(_t(a, torch_dtype) for a in (x, w1.T, b1, w2.T, b2))
    out = fmlp.fused_mlp(*args, active)
    assert out.dtype == torch_dtype and out.shape == (N, D)
    _close(out.float(), ref.astype(jnp.float32), dtype)
    padded = fmlp.kernel_operands(*args)
    width = fmlp.kernel_width(D, torch_dtype)
    assert padded[0].shape == (N, width) and padded[3].shape == (width, M)
    assert torch.all(padded[0][:, D:] == 0) and torch.all(padded[3][D:] == 0)
    cut = fmlp._plain_mlp(*padded, active)[:, :D]
    _close(cut.float(), out.float(), dtype)


# hidden sizes above 8,192 (8,200 is a multiple of 8 but not of 64), M =
# 64, 5 token rows: K1's, K1b's and K1c's plain versions against JAX's
# kernel of the same variant
K1_WIDEST = [8200, 12288]


@pytest.mark.parametrize("variant", ["seq", "chunked", "pipelined2"])
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("D", K1_WIDEST)
def test_k1_variants_match_jax_above_8192(monkeypatch, variant, dtype, D):
    """The port's K1, K1b and K1c (on the CPU their plain versions, under
    the variant) against JAX's `_mlp_kernel`, `_chunked_mlp_kernel` and
    `_pipelined2_mlp_kernel` in interpret mode at a hidden size above 8,192,
    with a width mask below M."""
    N, M = 5, 64
    active = M - 9
    torch_dtype, jax_dtype = DTYPES[dtype]
    x, w1, b1, w2, b2 = _mlp_data(D + N, N, D, M)
    monkeypatch.setattr(pallas_mlp, "_MLP_VARIANT", variant)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_mlp(*(jnp.asarray(a, jax_dtype) for a in (x, w1, b1, w2, b2)),
                            active)
    monkeypatch.setattr(fmlp, "_MLP_VARIANT", variant)
    out = fmlp.fused_mlp(*(_t(a, torch_dtype) for a in (x, w1.T, b1, w2.T, b2)), active)
    assert out.dtype == torch_dtype and out.shape == (N, D)
    assert fmlp._variant_body(variant, torch_dtype, D).startswith("wide_")
    _close(out.float(), ref.astype(jnp.float32), dtype)


def test_k1b_f32_scratch_holds_one_wave_of_chunks():
    """K1b's wide f32 plan at D 12,288, M 49,152: fc2's K in its 96 chunks
    of 512, summed in waves of WIDE_F32_MAX_SPLITS, so the partial-sum
    scratch holds WIDE_F32_MAX_SPLITS n D f32, not (M / 512) n D (19.4 GB
    at n 4,104); and folding the chunks' partial sums wave by wave into a
    running sum gives the bits of one left fold in chunk order."""
    D, M = 12288, 49152
    for n in (5, 513, 1026, 4104):
        plan = fmlp.wide_f32_plan(n, D, M, 132, chunked=True)
        assert plan["fc2"]["splits"] == M // 512 and plan["fc1"]["splits"] == 1
        assert plan["fc2"]["split_wave"] == fmlp.WIDE_F32_MAX_SPLITS
        assert fmlp.wide_f32_scratch(plan, M) == fmlp.WIDE_F32_MAX_SPLITS * n * D
        k1 = fmlp.wide_f32_plan(n, D, M, 132)
        assert fmlp.wide_f32_scratch(k1, M) <= fmlp.WIDE_F32_MAX_SPLITS * n * D
    rng = np.random.default_rng(4)
    parts = torch.from_numpy(rng.normal(size=(19, 5, 24)).astype(np.float32))
    folded = parts[0].clone()
    for s in range(1, 19):
        folded = folded + parts[s]
    run = None
    wave = fmlp.WIDE_F32_MAX_SPLITS
    for first in range(0, 19, wave):
        v = parts[first].clone() if run is None else run + parts[first]
        for s in range(first + 1, min(first + wave, 19)):
            v = v + parts[s]
        run = v
    assert torch.equal(run, folded)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1c_wide_plan_at_the_widest_widths(dtype):
    """K1c's queue at the widest model's (n, 12,288, 49,152) and at (513,
    16,384, 65,536): a group's h (12.6 MB in bf16 at M 49,152) lets half the
    L2 hold two; the lead is at least one group and two waves of the grid
    (or every group), and every fc2 unit's fc1 units hold smaller tickets,
    so no unit waits on a ticket not yet issued."""
    for n, D, M in ((1026, 12288, 49152), (513, 12288, 49152), (513, 16384, 65536)):
        plan = fmlp.k1c_wide_plan(n, D, M, 1, dtype, 132, 50 * 2**20)
        a, b = plan["fc1_units"], plan["fc2_units"]
        assert 1 <= plan["lead"] <= plan["groups"]
        assert plan["lead"] == plan["groups"] or plan["lead"] * (a + b) >= 2 * plan["blocks"]
        last_fc1, first_fc2 = {}, {}
        for u in range(plan["units"]):
            kind, g, _ = fmlp.k1c_wide_unit(plan, u)
            if kind == "fc1":
                last_fc1[g] = u
            else:
                first_fc2.setdefault(g, u)
        assert sorted(first_fc2) == list(range(plan["groups"]))
        assert all(last_fc1[g] < first_fc2[g] for g in first_fc2)
    assert fmlp.k1c_wide_plan(1026, 12288, 49152, 1, torch.bfloat16, 132,
                              50 * 2**20)["lead"] == 2


def test_k1_narrow_width_with_a_model_axis_runs_padded():
    """Three stacked models at D = 24 (between the narrow bodies' 16 and
    32), each its own width: the padded operands at 32, cut back, equal the
    unpadded function."""
    rng = np.random.default_rng(3)
    P, N, D, M = 3, 20, 24, 96
    x = _t(rng.normal(size=(P, N, D)))
    w1, w2 = _t(rng.normal(size=(P, M, D)) * 0.2), _t(rng.normal(size=(P, D, M)) * 0.2)
    b1, b2 = _t(rng.normal(size=(P, M)) * 0.1), _t(rng.normal(size=(P, D)) * 0.1)
    widths = torch.tensor([96, 50, 7], dtype=torch.int32)
    padded = fmlp.kernel_operands(x, w1, b1, w2, b2)
    assert [t.shape for t in padded] == [(P, N, 32), (P, M, 32), (P, M),
                                         (P, 32, M), (P, 32)]
    fmlp._check(*padded)
    torch.testing.assert_close(fmlp._plain_mlp(*padded, widths)[..., :D],
                               fmlp._plain_mlp(x, w1, b1, w2, b2, widths),
                               atol=1e-6, rtol=1e-6)


# --- K4 ---------------------------------------------------------------------

K4_HEAD_DIMS = [20, 24, 48, 80, 96, 160, 256]
# above 256, on the sliced bodies: 264 (two slices, the second of 8
# columns) and 512 (two of 256)
K4_SLICED_HEAD_DIMS = [264, 512]


def _padded_k4(q, k, v):
    """K4's f32 function as its bodies compute a head_dim they are not
    built for: q and k (and v, where it has their hd columns) zero-padded to
    the body's head_dim, the scale 1 / sqrt(hd) of the true hd, the context
    cut back to hd.  A v of other columns (a slice of the sliced bodies)
    gives the context of those columns."""
    hd = q.shape[-1]
    pad = fused_attention.k4_body_hd(hd) - hd
    q, k = (F.pad(t, (0, pad)) for t in (q, k))
    if v.shape[-1] == hd:
        v = F.pad(v, (0, pad))
    e = torch.einsum("...hqd,...hkd->...hqk", q, k) / math.sqrt(hd)
    e = torch.exp(e - e.amax(dim=-1, keepdim=True))
    ctx = torch.einsum("...hqk,...hkd->...hqd", e, v) / e.sum(dim=-1, keepdim=True)
    return ctx[..., :hd]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("hd", K4_HEAD_DIMS)
def test_k4_matches_jax_at_every_head_dim(dtype, hd):
    """The port's K4 (on the CPU its plain version) against JAX's
    `_attention_kernel` in interpret mode at head dims the registry does not
    have, at a ragged S; in f32 also the padded computation of the body
    that runs hd (`k4_body_hd`) against the plain version."""
    torch_dtype, jax_dtype = DTYPES[dtype]
    q, k, v = _qkv((2, 2, 37, hd), hd)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_attention(*(jnp.asarray(a, jax_dtype) for a in (q, k, v)))
    args = [_t(a, torch_dtype) for a in (q, k, v)]
    out = fused_attention.fused_attention(*args)
    assert out.dtype == torch_dtype and out.shape == (2, 2, 37, hd)
    _close(out.float(), ref.astype(jnp.float32), dtype)
    body = fused_attention.k4_body_hd(hd)
    assert hd <= body in fused_attention.K4_BODY_HDS
    if dtype == "float32":
        torch.testing.assert_close(_padded_k4(*args), out, atol=1e-6, rtol=1e-5)
    else:
        # views TMA cannot read (hd 20: rows of 40 bytes) are copied first
        views = fused_attention._k4_views(*args)
        assert all(fused_attention._tma_rows(t) for t in views)
        assert all(t is a for t, a in zip(views, args)) == (hd % 8 == 0)
        assert all(torch.equal(t, a) for t, a in zip(views, args))


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("hd", K4_SLICED_HEAD_DIMS)
def test_k4_matches_jax_above_head_dim_256(dtype, hd):
    """The port's K4 at a head_dim of the sliced bodies (on the CPU its
    plain version) against JAX's `_attention_kernel` in interpret mode, one
    volume of two heads at S = 65; in f32 also the sliced computation: the
    scores over hd zero-padded to the 64-column boxes (`k4_body_hd`), the
    scale of the true hd, and the context put together from its slices of
    K4_SLICE columns, each from the same softmax."""
    torch_dtype, jax_dtype = DTYPES[dtype]
    q, k, v = _qkv((1, 2, 65, hd), hd)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_attention(*(jnp.asarray(a, jax_dtype) for a in (q, k, v)))
    args = [_t(a, torch_dtype) for a in (q, k, v)]
    out = fused_attention.fused_attention(*args)
    assert out.dtype == torch_dtype and out.shape == (1, 2, 65, hd)
    _close(out.float(), ref.astype(jnp.float32), dtype)
    slices = fused_attention.k4_slices(hd)
    assert slices == 2 and fused_attention.k4_body_hd(hd) % 64 == 0
    if dtype == "float32":
        width = slices * fused_attention.K4_SLICE
        v_pad = F.pad(args[2], (0, width - hd))
        sliced = [_padded_k4(args[0], args[1], v_pad[..., i:i + fused_attention.K4_SLICE])
                  for i in range(0, width, fused_attention.K4_SLICE)]
        torch.testing.assert_close(torch.cat(sliced, -1)[..., :hd], out, atol=1e-6,
                                   rtol=1e-5)


# --- K3 ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("hd", [20, 80])
def test_k3_matches_jax_at_head_dims_20_and_80(dtype, hd):
    """The sublayer on K4's body (on the CPU its plain version) against
    JAX's `_attn_core_kernel` path in interpret mode, two heads."""
    torch_dtype, jax_dtype = DTYPES[dtype]
    B, T, H = 2, 33, 2
    D = H * hd
    h, wqkv, bqkv, wout, bout = _layer_data(hd + 1, B, T, D)
    # projections of standard deviation 1 / sqrt(D): scores near unit scale
    args = (h, wqkv / (0.3 * D ** 0.5), bqkv, wout / (0.3 * D ** 0.5), bout)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_attention_layer(*(jnp.asarray(a, jax_dtype) for a in args), H)
    h, wqkv, bqkv, wout, bout = args
    out = attention_layer.fused_attention_layer(
        *(_t(a, torch_dtype) for a in (h, wqkv.T, bqkv, wout.T, bout)), H)
    assert out.dtype == torch_dtype and out.shape == (B, T, H * hd)
    _close(out.float(), ref.astype(jnp.float32), dtype)


def test_k3_matches_jax_at_head_dim_288():
    """The sublayer at head_dim 288 (K4's sliced body, two slices; on the
    CPU its plain version) against JAX's `_attn_core_kernel` path in
    interpret mode: one volume of 65 tokens, two heads, in f32 (bf16's
    plain core is K4's, held at 264 and 512 above; JAX's interpret mode
    takes 16 s a type here)."""
    dtype = "float32"
    torch_dtype, jax_dtype = DTYPES[dtype]
    B, T, H, hd = 1, 65, 2, 288
    D = H * hd
    h, wqkv, bqkv, wout, bout = _layer_data(hd + 1, B, T, D)
    args = (h, wqkv / (0.3 * D ** 0.5), bqkv, wout / (0.3 * D ** 0.5), bout)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_attention_layer(*(jnp.asarray(a, jax_dtype) for a in args), H)
    h, wqkv, bqkv, wout, bout = args
    out = attention_layer.fused_attention_layer(
        *(_t(a, torch_dtype) for a in (h, wqkv.T, bqkv, wout.T, bout)), H)
    assert out.dtype == torch_dtype and out.shape == (B, T, D)
    assert attention_layer.on_k4(hd) and fused_attention.k4_slices(hd) == 2
    _close(out.float(), ref.astype(jnp.float32), dtype)


# --- a model at ViT-H's head_dim ----------------------------------------------

# D 160 in 2 heads of 80 (ViT-H's head_dim), MLP 640, 2 layers; 32^3 volumes
# in (8, 8, 8) patches: 64 + 1 = 65 tokens.
_SMALL = dict(patch_size=(8, 8, 8), hidden_size=160, num_heads=2, mlp_dim=640,
              num_layers=2, img_size=32, z_size=32)
_PAIR = []


def _pair():
    """(JAX params as numpy, the port's model on the CPU with them, the
    volumes, JAX's output on them under its Pallas MLP and attention)."""
    if not _PAIR:
        jmodel = JaxVisionTransformer3D(JaxViTConfig(**_SMALL), zero_head=False,
                                        vis=False)
        x = jnp.zeros((1, 32, 32, 32, 1), jnp.float32)
        params = jax.device_get(jax.jit(jmodel.init)(jax.random.key(0), x)["params"])
        rng = np.random.default_rng(8)
        emb = params["embeddings"]
        for name in ("position_embeddings", "cls_token"):
            emb[name] = (rng.normal(size=emb[name].shape) * 0.02).astype(np.float32)
        cfg = ViTConfig(**_SMALL)
        tmodel = VisionTransformer3D(cfg, zero_head=True, vis=False, device="cpu")
        tmodel.load_state_dict(vit_state_from_flax(params, cfg))
        tmodel.eval()
        x = np.random.default_rng(9).normal(size=(2, 32, 32, 32, 1)).astype(np.float32)
        jax_set_mlp("pallas")
        jax_set_attention("pallas")
        try:
            with pltpu.force_tpu_interpret_mode():
                ref = jmodel.apply({"params": params}, jnp.asarray(x), deterministic=True)
        finally:
            jax_set_mlp("xla")
            jax_set_attention("auto")
        _PAIR.append((params, tmodel, x, ref))
    return _PAIR[0]


@pytest.mark.parametrize("attn_impl,mlp_impl", [
    ("auto", "auto"), ("kernel", "kernel"), ("layer", "kernel")])
def test_head_dim_80_model_matches_jax_on_its_pallas_impls(attn_impl, mlp_impl):
    """The port's model (separate projections above D = 64, K4 at head_dim
    80 and K1 at D 160 through their plain versions) with JAX's weights
    carried across by `vit_state_from_flax`, against JAX's model on its
    Pallas MLP and attention: logits and tokens within 2e-4."""
    _, tmodel, x, ref = _pair()
    attention.set_default_attention_impl(attn_impl)
    mlp_select.set_default_mlp_impl(mlp_impl)
    try:
        with torch.no_grad():
            out = tmodel(torch.from_numpy(x))
    finally:
        attention.set_default_attention_impl("auto")
        mlp_select.set_default_mlp_impl("auto")
    assert out.tokens.shape == (2, 65, 160)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out.tokens.numpy(), np.asarray(ref.tokens),
                               atol=2e-4, rtol=1e-4)


def test_weights_carry_a_head_dim_80_model_unchanged():
    """`vit_state_from_flax` on the separate-projection model: every tensor
    of JAX's tree lands, as its torch layout, in the port's state."""
    params, tmodel, _, _ = _pair()
    state = tmodel.state_dict()
    attn = params["encoder"]["layers"]["block"]["attn"]   # scanned: layer first
    D = _SMALL["hidden_size"]
    for layer in range(_SMALL["num_layers"]):
        for name in ("query", "key", "value", "out"):
            kernel = np.asarray(attn[name]["kernel"][layer]).reshape(D, D)
            bias = np.array(attn[name]["bias"][layer]).reshape(D)
            prefix = f"transformer.encoder.layer.{layer}.attn.{name}"
            torch.testing.assert_close(state[f"{prefix}.weight"],
                                       torch.from_numpy(kernel.T.copy()), rtol=0, atol=0)
            torch.testing.assert_close(state[f"{prefix}.bias"], torch.from_numpy(bias),
                                       rtol=0, atol=0)


# --- a model of two heads of 512 ---------------------------------------------

# D 1,024 in 2 heads of 512 (K4's sliced bodies), MLP 2,048, one layer; 32^3
# volumes in (16, 16, 16) patches: 8 + 1 = 9 tokens.
_WIDE_HEADS = dict(patch_size=(16, 16, 16), hidden_size=1024, num_heads=2,
                   mlp_dim=2048, num_layers=1, img_size=32, z_size=32)
_WIDE_PAIR = []


def _wide_heads_pair():
    """(the port's model on the CPU with JAX's weights, the volumes, JAX's
    output on them under its Pallas MLP and attention)."""
    if not _WIDE_PAIR:
        cfg = _WIDE_HEADS
        jmodel = JaxVisionTransformer3D(JaxViTConfig(**cfg), zero_head=False, vis=False)
        x0 = jnp.zeros((1, 32, 32, 32, 1), jnp.float32)
        params = jax.device_get(jax.jit(jmodel.init)(jax.random.key(1), x0)["params"])
        rng = np.random.default_rng(12)
        emb = params["embeddings"]
        for name in ("position_embeddings", "cls_token"):
            emb[name] = (rng.normal(size=emb[name].shape) * 0.02).astype(np.float32)
        tmodel = VisionTransformer3D(ViTConfig(**cfg), zero_head=True, vis=False,
                                     device="cpu")
        tmodel.load_state_dict(vit_state_from_flax(params, ViTConfig(**cfg)))
        tmodel.eval()
        x = rng.normal(size=(2, 32, 32, 32, 1)).astype(np.float32)
        jax_set_mlp("pallas")
        jax_set_attention("pallas")
        try:
            with pltpu.force_tpu_interpret_mode():
                ref = jmodel.apply({"params": params}, jnp.asarray(x), deterministic=True)
        finally:
            jax_set_mlp("xla")
            jax_set_attention("auto")
        _WIDE_PAIR.append((tmodel, x, ref))
    return _WIDE_PAIR[0]


@pytest.mark.parametrize("attn_impl,mlp_impl", [("kernel", "kernel"), ("layer", "kernel")])
def test_head_dim_512_model_matches_jax_on_its_pallas_impls(attn_impl, mlp_impl):
    """The port's one-layer model of two heads of 512 (K4, or K3 on K4's
    sliced body, and K1's wide body at D 1,024 through their plain versions)
    with JAX's weights carried across by `vit_state_from_flax`, against
    JAX's model on its Pallas MLP and attention: logits and tokens within
    2e-4."""
    tmodel, x, ref = _wide_heads_pair()
    attention.set_default_attention_impl(attn_impl)
    mlp_select.set_default_mlp_impl(mlp_impl)
    try:
        with torch.no_grad():
            out = tmodel(torch.from_numpy(x))
    finally:
        attention.set_default_attention_impl("auto")
        mlp_select.set_default_mlp_impl("auto")
    assert out.tokens.shape == (2, 9, 1024)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out.tokens.numpy(), np.asarray(ref.tokens),
                               atol=2e-4, rtol=1e-4)


# --- the shape rules ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_takes_every_hidden_size_up_to_8192(dtype):
    """Every D from 1 to 8,192 is taken by K1, at a kernel width that the
    bodies are built for: a narrow width at or above a narrow D, else D
    rounded up to rows of 16 bytes (at most 7 padded columns)."""
    step = 8 if dtype == torch.bfloat16 else 4
    for D in range(1, 8192 + 1):
        assert fmlp.supported_width(D)
        kd = fmlp.kernel_width(D, dtype)
        if D <= 64:
            assert kd == min(w for w in fmlp.WIDTHS if w >= D)
        else:
            assert kd % step == 0 and D <= kd < D + step
    for D in (1, 12, 24, 63, 65, 200, 1280, 1288, 8191, 8192):
        x = torch.zeros(3, D, dtype=dtype)
        fmlp._check(x, torch.zeros(8, D, dtype=dtype), torch.zeros(8, dtype=dtype),
                    torch.zeros(D, 8, dtype=dtype), torch.zeros(D, dtype=dtype))


def test_k4_and_k3_take_every_head_dim_from_17_to_256():
    """Every head_dim from 17 to 256 passes K4's and K3's checks and runs on
    the first body built at or above it."""
    for hd in range(17, 257):
        body = fused_attention.k4_body_hd(hd)
        assert body >= hd and body in fused_attention.K4_BODY_HDS
        assert all(b < hd for b in fused_attention.K4_BODY_HDS if b < body)
        q = torch.zeros(1, 1, 3, hd, dtype=torch.bfloat16)
        fused_attention._check(q, q, q)
        attention_layer._check(*attention_layer._split(
            torch.zeros(1, 3, 3 * hd, dtype=torch.bfloat16)), 1)
        assert attention_layer.on_k4(hd) and fused_attention.k4_slices(hd) == 1
    assert not any(attention_layer.on_k4(hd) for hd in attention_layer.HEAD_DIMS)


def _mlp_args(D, M=8, lead=()):
    return (torch.zeros(*lead, 3, D), torch.zeros(*lead, M, D), torch.zeros(*lead, M),
            torch.zeros(*lead, D, M), torch.zeros(*lead, D))


def test_every_width_is_taken():
    """No hidden size and no head_dim is refused: K1, K1b and K1c take every
    D up to 16,384 (with and without the model axis) on a body they name,
    the wide ones above 64; K4 and K3 every head_dim up to 2,048, those
    above 256 on the sliced bodies (ceil(hd / 256) slices, the scores over
    hd rounded up to 64)."""
    for D in (24, 64, 65, 96, 768, 1290, 8192, 8193, 8200, 12288, 16384):
        fmlp._check(*_mlp_args(D))
        fmlp._check(*_mlp_args(D, lead=(2,)))   # the model axis
    assert all(fmlp.supported_width(D) for D in range(1, 16384 + 1))
    for variant in ("seq", "chunked", "pipelined2"):
        for dtype in (torch.float32, torch.bfloat16):
            assert all(fmlp._variant_body(variant, dtype, D).startswith("wide_")
                       for D in range(65, 16384 + 1, 7))
    with pytest.raises(ValueError, match="hidden size 0"):
        fmlp._check(*_mlp_args(0))
    for hd in range(17, 2048 + 1):
        body = fused_attention.k4_body_hd(hd)
        slices = fused_attention.k4_slices(hd)
        assert hd <= body < hd + 64 or body in fused_attention.K4_BODY_HDS
        assert slices == (1 if hd <= 256 else -(-hd // fused_attention.K4_SLICE))
        assert attention_layer.on_k4(hd)
    for hd in (257, 264, 288, 512, 1000, 1024, 2048):
        q = torch.zeros(1, 1, 3, hd)
        fused_attention._check(q, q, q)
        attention_layer._check(*attention_layer._split(torch.zeros(1, 3, 3 * hd)), 1)

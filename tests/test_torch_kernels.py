"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: they need a CUDA device, `nvcc` and the kernels built from
`vit3d_ensemble_tpu_torch/csrc/`, and skip elsewhere.  Run them on the card
with `python -m pytest --noconftest -m gpu tests/test_torch_kernels.py`
(`tests/conftest.py` imports JAX, which a CUDA host need not have).

Tolerances are the JAX package's own for its kernels
(`tests/test_pallas_mlp.py:31,47`, `tests/test_ops.py:31`): kernel and plain
version accumulate in f32 and round at the same points.
"""

import ctypes
import math
import pathlib
import re
import subprocess

import pytest
import torch

from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import TransformerEnsemble, VisionTransformer3D
from vit3d_ensemble_tpu_torch.ops import (
    attention,
    attention_layer,
    fused_attention,
    fused_mlp,
)
from vit3d_ensemble_tpu_torch.ops import mlp as mlp_select
from vit3d_ensemble_tpu_torch.ops import quant

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=0.05, rtol=0.05)}


@pytest.fixture()
def cuda():
    """Skip unless a CUDA device is present; f32 products in full f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


# K4 (and K2) in bf16 on a context of root mean square 1 (`_model_views`,
# `_k2_views`): K4 read at most 0.61 of this gate on an NVIDIA H100 80GB
# HBM3, and a version that drops one key of 513 misses it on 17 % of the
# elements.
K4_BF16_TOL = dict(atol=0.02, rtol=0.02)


def _close(out, ref, dtype, tol=None):
    torch.testing.assert_close(out.float(), ref.float(), **(tol or TOL[dtype]))


def _k4_tol(dtype):
    return K4_BF16_TOL if dtype == torch.bfloat16 else None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,M,active", [
    (8, 2204, 2204), (16, 2048, 2048), (32, 3072, 1000), (64, 3072, 3072),
    (64, 3072, 0), (64, 96, 50),
    (16, 2204, 2000),   # M % 8 != 0: w2 rows are not 16-byte aligned
])
def test_fused_mlp_kernel_matches_plain(cuda, dtype, D, M, active):
    n = 3 * 65 + 7          # a ragged last tile of rows
    x = torch.randn(n, D, generator=cuda, device="cuda").to(dtype)
    w1, w2 = ((torch.randn(*s, generator=cuda, device="cuda") * 0.1).to(dtype)
              for s in ((M, D), (D, M)))
    b1 = (torch.randn(M, generator=cuda, device="cuda") * 0.1).to(dtype)
    b2 = (torch.randn(D, generator=cuda, device="cuda") * 0.1).to(dtype)
    before = fused_mlp.launches
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, active)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, fused_mlp._plain_mlp(x, w1, b1, w2, b2, active), dtype)


def _k2_views(gen, B, H, S, hd, dtype, offset=0):
    """q, k, v as the serving model hands them to K2: (B, H, S, hd) views
    into one (B, S, 3, H, hd) QKV product, `offset` elements into its
    storage (1: no view is 16-byte aligned).  v is scaled by sqrt(S / e),
    so that the context's root mean square is 1 at every S."""
    qkv = torch.randn(B, S, 3, H, hd, generator=gen, device="cuda")
    qkv[:, :, 2] *= math.sqrt(S / math.e)
    flat = torch.empty(offset + qkv.numel(), dtype=dtype, device="cuda")
    qkv = flat[offset:].view(qkv.shape).copy_(qkv)
    return list(qkv.permute(2, 0, 3, 1, 4))


def _k2_tol(dtype):
    return K4_BF16_TOL if dtype == torch.bfloat16 else None


# Every body and tiling of K2: S = 1 and 5 (one partial query tile), 64 (no
# tail), 65 (the serving shape: a 65th row alone in its tile, a 65th key
# past a 64-key tile), 257 and 300 (conf 19-22's 257 tokens: more than one
# 128-key chunk); head_dim 1, 2, 4, 8 (CUDA cores), 12 and 16 (in bf16 on
# the tensor cores, 12 zero-filled to 16).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 5, 64, 65, 257, 300])
@pytest.mark.parametrize("hd", [1, 2, 4, 8, 12, 16])
def test_tiny_attention_kernel_matches_plain(cuda, dtype, S, hd):
    B, H = 2, min(16, max(2, 32 // hd))
    q, k, v = _k2_views(cuda, B, H, S, hd, dtype)
    before = fused_attention.launches
    out = fused_attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    # the heads merge without a copy, as in `models/vit3d.Attention`
    merged = out.transpose(1, 2).reshape(B, S, H * hd)
    assert merged.data_ptr() == out.data_ptr() and merged.is_contiguous()
    ref = fused_attention._plain_attention(q, k, v)
    _close(out, ref, dtype, _k2_tol(dtype))
    if S >= 64:
        # the gate tells a context that lacks the last key from the right one
        short = fused_attention._plain_attention(q, k[:, :, :-1], v[:, :, :-1])
        with pytest.raises(AssertionError):
            _close(short, ref, dtype, _k2_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hd", [(4, 16), (8, 4), (16, 1), (2, 12)])
def test_tiny_attention_takes_strided_inputs(cuda, dtype, H, hd):
    """Views that are not 16-byte aligned (bf16 head_dim 16 then loads by
    element), contiguous (B, H, S, hd) tensors, q, k, v of unlike strides,
    a view whose head_dim stride is not 1 (copied first), 3-d and 5-d
    inputs, and an empty batch."""
    q, k, v = _k2_views(cuda, 2, H, 65, hd, dtype, offset=1)
    plain, tol = fused_attention._plain_attention, _k2_tol(dtype)
    _close(fused_attention.fused_attention(q, k, v), plain(q, k, v), dtype, tol)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    _close(fused_attention.fused_attention(qc, kc, vc), plain(qc, kc, vc),
           dtype, tol)
    _close(fused_attention.fused_attention(q, kc, v), plain(q, kc, v), dtype, tol)
    if hd > 1:
        kt = kc.transpose(2, 3).contiguous().transpose(2, 3)
        assert kt.stride(-1) != 1
        _close(fused_attention.fused_attention(q, kt, v), plain(q, kt, v),
               dtype, tol)
    _close(fused_attention.fused_attention(q[0], k[0], v[0]),
           plain(q[0], k[0], v[0]), dtype, tol)
    q5, k5, v5 = (t.view(1, *t.shape) for t in (qc, kc, vc))
    _close(fused_attention.fused_attention(q5, k5, v5), plain(q5, k5, v5),
           dtype, tol)
    before = fused_attention.launches
    assert fused_attention.fused_attention(q[:0], k[:0], v[:0]).shape == (0, H, 65, hd)
    assert fused_attention.launches == before      # nothing was launched


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_takes_unaligned_views(cuda, dtype):
    D, M = 64, 2048
    buf = torch.randn(1 + M * D + 1 + D * M, generator=cuda,
                      device="cuda").mul(0.1).to(dtype)
    w1 = buf[1:1 + M * D].view(M, D)              # 2 or 4 bytes off
    w2 = buf[2 + M * D:].view(D, M)
    x = torch.randn(1 + 130 * D, generator=cuda, device="cuda").to(dtype)[1:]
    x = x.view(130, D)
    b1, b2 = torch.zeros(M, device="cuda", dtype=dtype), torch.zeros(
        D, device="cuda", dtype=dtype)
    _close(fused_mlp.fused_mlp(x, w1, b1, w2, b2),
           fused_mlp._plain_mlp(x, w1, b1, w2, b2, M), dtype)


def test_kernels_raise_on_what_they_do_not_take(cuda):
    """What stays refused: a view strided along head_dim and float16.
    Head dims 48, 257 and 512 (the last two on the sliced bodies), hidden
    sizes 48, 96, 1,088, 8,193 and 12,288 (the last two refused before this
    port took every width) and the wide model axis launch, each held to its
    plain version."""
    for hd in (257, 512):
        q, k, v = _model_views(cuda, (1, 3, 65, hd), torch.bfloat16)
        before = fused_attention.launches_k4
        out = fused_attention.fused_attention(q, k, v)
        torch.cuda.synchronize()
        assert fused_attention.launches_k4 == before + 1
        assert fused_attention.k4_body_launched() == "bf16_sliced_wgmma"
        _close(out, fused_attention._plain_attention_k4(q, k, v), torch.bfloat16,
               K4_BF16_TOL)
    before = fused_attention.launches_k4
    hd48 = torch.zeros(1, 12, 65, 48, device="cuda")
    fused_attention.fused_attention(hd48, hd48, hd48)
    assert fused_attention.launches_k4 == before + 1
    strided = torch.zeros(1, 12, 64, 65, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError, match="along head_dim"):
        fused_attention.fused_attention(strided, strided, strided)
    for D in (48, 96, 1088, 8193, 12288):
        x, w1, b1, w2, b2 = _wide_inputs(cuda, 65, D, 128)
        before = fused_mlp.launches
        out = fused_mlp.fused_mlp(x, w1, b1, w2, b2)
        assert fused_mlp.launches == before + 1
        _close(out, fused_mlp._plain_mlp(x, w1, b1, w2, b2, 128), torch.float32)
    x = torch.zeros(2, 65, 96, device="cuda")
    w1, w2 = torch.zeros(2, 128, 96, device="cuda"), torch.zeros(2, 96, 128, device="cuda")
    before = fused_mlp.launches
    fused_mlp.fused_mlp(x, w1, torch.zeros(2, 128, device="cuda"), w2,
                        torch.zeros(2, 96, device="cuda"))
    assert fused_mlp.launches == before + 1
    x = torch.zeros(65, 16, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        fused_mlp.fused_mlp(x, *(torch.zeros(s, device="cuda",
                                             dtype=torch.float16)
                                 for s in ((128, 16), (128,), (16, 128), (16,))))


def test_gradients_recompute_through_plain(cuda):
    x = torch.randn(2, 65, 16, generator=cuda, device="cuda")
    w1 = torch.randn(2048, 16, generator=cuda, device="cuda") * 0.1
    b1 = torch.randn(2048, generator=cuda, device="cuda") * 0.1
    w2 = torch.randn(16, 2048, generator=cuda, device="cuda") * 0.1
    b2 = torch.randn(16, generator=cuda, device="cuda") * 0.1
    qkv = [torch.randn(2, 4, 65, 16, generator=cuda, device="cuda")
           for _ in range(3)]
    for kernel, plain, args in (
            (lambda *a: fused_mlp.fused_mlp(*a, 1500),
             lambda *a: fused_mlp._plain_mlp(*a, 1500), [x, w1, b1, w2, b2]),
            (fused_attention.fused_attention, fused_attention._plain_attention,
             qkv)):
        grads = []
        for fn in (kernel, plain):
            leaves = [a.clone().requires_grad_() for a in args]
            (fn(*leaves) ** 2).sum().backward()
            grads.append([t.grad for t in leaves])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("conf", [1, 2, 3, 18])
def test_model_on_kernels_matches_plain_modules(cuda, conf):
    model = VisionTransformer3D(ViTConfig.from_conf(conf), zero_head=False,
                                vis=False)
    x = torch.randn(2, 128, 128, 5, 1, generator=cuda, device="cuda")
    launches = (fused_mlp.launches, fused_attention.launches)
    with torch.no_grad():
        out = model(x)
        assert fused_mlp.launches > launches[0]
        assert fused_attention.launches > launches[1]
        mlp_select.set_default_mlp_impl("plain")
        attention.set_default_attention_impl("plain")
        try:
            ref = model(x)
        finally:
            mlp_select.set_default_mlp_impl("auto")
            attention.set_default_attention_impl("auto")
    torch.testing.assert_close(out.tokens, ref.tokens, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(out.logits, ref.logits, atol=2e-4, rtol=1e-4)


def test_ensemble_runs_on_the_card(cuda):
    ens = TransformerEnsemble([ViTConfig.from_conf(c) for c in (5, 9, 11)])
    x = torch.randn(4, 128, 128, 5, 1, generator=cuda, device="cuda")
    with torch.no_grad():
        out = ens.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert out.shape == (4, 1) and out.is_cuda
    assert bool(((out > 0) & (out < 1)).all())


# (B, T, D, H): the K3 shapes of `chip_smoke.py` (conf 1-18 at B=512,
# conf 19-22 at B=64, the stretch model at B=2), a tiny sequence, and
# hd 16 / 64 with T over several 64-key chunks.  Head dims up to 16 take
# K2's body, the hd-64 shapes (the stretch model's, and (2, 200, 128, 2))
# K4's.
K3_SHAPES = [(512, 65, 64, 4), (512, 65, 32, 8), (512, 65, 16, 16),
             (64, 257, 16, 4), (64, 257, 8, 8), (2, 513, 768, 12),
             (2, 5, 16, 4), (3, 700, 64, 4), (2, 200, 128, 2)]


def _k3_counts():
    return (attention_layer.launches, attention_layer.launches_k2,
            attention_layer.launches_k4, fused_attention.launches,
            fused_attention.launches_k4)


def _k3_launch_checked(q, k, v, H):
    """K3's core once, with its counters: one launch, on the body that
    serves the head_dim; K2's and K4's own counters do not move."""
    before = _k3_counts()
    out = attention_layer.attention_core(q, k, v, H)
    torch.cuda.synchronize()
    on_k4 = attention_layer.on_k4(q.shape[-1] // H)
    assert _k3_counts() == (before[0] + 1, before[1] + (not on_k4),
                            before[2] + on_k4, before[3], before[4])
    assert out.dtype == q.dtype and out.shape == q.shape and out.is_contiguous()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", K3_SHAPES)
def test_attention_layer_kernel_matches_plain(cuda, dtype, B, T, D, H):
    qkv = torch.randn(B, T, 3 * D, generator=cuda, device="cuda").to(dtype)
    q, k, v = attention_layer._split(qkv)
    out = _k3_launch_checked(q, k, v, H)
    _close(out, attention_layer._plain_attention_core(q, k, v, H), dtype)


def _k3_qkv(gen, lead, T, H, hd, dtype):
    """A (*lead, T, 3 H hd) QKV buffer with v scaled by sqrt(T / e), so that
    the context's root mean square is 1 (as `_k2_views`)."""
    qkv = torch.randn(*lead, T, 3 * H * hd, generator=gen, device="cuda")
    qkv[..., 2 * H * hd:] *= math.sqrt(T / math.e)
    return qkv.to(dtype)


# K3's core at every head_dim that K2's body serves, at the registry's T = 65
# and 257, on the views of the sublayer's (B, T, 3D) QKV buffer: in bf16
# the views start and step by multiples of 16 bytes, so hd 16 takes K2's
# streamed tensor-core body at T = 65, and 9-15 its block-a-head one.  The
# plain version is the body's own function: K2's gate, which must reject
# the context without the last key.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [65, 257])
@pytest.mark.parametrize("hd", list(range(1, 17)))
def test_attention_layer_on_k2_body_at_every_head_dim(cuda, dtype, T, hd):
    H = max(2, 64 // (4 * hd))
    q, k, v = attention_layer._split(_k3_qkv(cuda, (3,), T, H, hd, dtype))
    out = _k3_launch_checked(q, k, v, H)
    if dtype == torch.float32 or hd <= fused_attention.TC_HD:
        body = "simt"
    elif hd < 16:
        body = "tc_by_element"
    else:
        body = "tc_stream" if T <= 80 else "tc"
    assert fused_attention.k2_body_launched() == body
    ref = attention_layer._plain_attention_core(q, k, v, H)
    _close(out, ref, dtype, _k2_tol(dtype))
    short = attention_layer._plain_attention_core(q, k[:, :-1], v[:, :-1], H)
    with pytest.raises(AssertionError):
        _close(short, ref, dtype, _k2_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H", [(64, 4), (32, 8), (16, 16)])
def test_attention_layer_on_the_sweeps_buffer(cuda, dtype, D, H):
    """The stacked sweep model's (P·B, T, 3D) QKV output (`sweep/stacked.py`),
    a batched product's, takes the same route as the sublayer's buffer."""
    P, B, T = 3, 2, 65
    h = torch.randn(P, B * T, D, generator=cuda, device="cuda")
    w = torch.randn(P, D, 3 * D, generator=cuda, device="cuda") / math.sqrt(D)
    qkv = torch.bmm(h, w).to(dtype).reshape(P * B, T, 3 * D)
    q, k, v = attention_layer._split(qkv)
    out = _k3_launch_checked(q, k, v, H)
    if dtype == torch.bfloat16 and D // H == 16:
        assert fused_attention.k2_body_launched() == "tc_stream"
    _close(out, attention_layer._plain_attention_core(q, k, v, H), dtype,
           _k2_tol(dtype))


def test_attention_layer_reads_strided_views(cuda):
    """q, k, v of a wider row, at an odd element offset, and of a batch
    whose volumes are not adjacent."""
    wide = torch.randn(3, 65, 3 * 32 + 7, generator=cuda, device="cuda")
    for qkv in (wide[..., 7:], wide[..., 1:97], wide[::2, :, :96]):
        q, k, v = attention_layer._split(qkv)
        _close(attention_layer.attention_core(q, k, v, 8),
               attention_layer._plain_attention_core(q, k, v, 8),
               torch.float32)


def test_attention_layer_raises_on_what_it_does_not_take(cuda):
    # head_dim 257, refused before this port took every head_dim: K4's
    # sliced body, on views that TMA cannot read as they lie (copied)
    q, k, v = attention_layer._split(_k3_qkv(cuda, (2,), 65, 1, 257, torch.bfloat16))
    out = _k3_launch_checked(q, k, v, 1)
    assert fused_attention.k4_body_launched() == "bf16_sliced_wgmma"
    _close(out, attention_layer._plain_attention_core(q, k, v, 1), torch.bfloat16,
           K4_BF16_TOL)
    q, k, v = attention_layer._split(
        torch.zeros(2, 65, 48, device="cuda", dtype=torch.float16))
    with pytest.raises(TypeError):
        attention_layer.attention_core(q, k, v, 4)
    q, k, v = attention_layer._split(torch.zeros(2, 65, 48, device="cuda"))
    with pytest.raises(ValueError, match="strides"):
        attention_layer.attention_core(q, k.contiguous(), v, 4)


def test_attention_layer_gradients_recompute_through_plain(cuda):
    B, T, D, H = 2, 65, 32, 8
    args = [torch.randn(B, T, D, generator=cuda, device="cuda"),
            torch.randn(3 * D, D, generator=cuda, device="cuda") * 0.3,
            torch.randn(3 * D, generator=cuda, device="cuda") * 0.1,
            torch.randn(D, D, generator=cuda, device="cuda") * 0.3,
            torch.randn(D, generator=cuda, device="cuda") * 0.1]
    # one fixed cotangent, as `tests/test_ops.py:128-130` compares VJPs
    g = torch.randn(B, T, D, generator=cuda, device="cuda")
    grads = []
    for fn in (attention_layer.fused_attention_layer,
               attention_layer._plain_attention_layer):
        leaves = [a.clone().requires_grad_() for a in args]
        fn(*leaves, H).backward(g)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("conf", [1, 2, 3, 20])
def test_model_under_layer_matches_plain_modules(cuda, conf):
    """f32, every attention sublayer on K3 (conf 20: p=8, 257 tokens)."""
    model = VisionTransformer3D(ViTConfig.from_conf(conf), zero_head=False,
                                vis=False)
    x = torch.randn(2, 128, 128, 5, 1, generator=cuda, device="cuda")
    before = attention_layer.launches
    attention.set_default_attention_impl("layer")
    try:
        with torch.no_grad():
            out = model(x)
            assert attention_layer.launches == before + model.config.num_layers
            attention.set_default_attention_impl("plain")
            mlp_select.set_default_mlp_impl("plain")
            ref = model(x)
    finally:
        mlp_select.set_default_mlp_impl("auto")
        attention.set_default_attention_impl("auto")
    torch.testing.assert_close(out.tokens, ref.tokens, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(out.logits, ref.logits, atol=2e-4, rtol=1e-4)


# (B, H, S, hd): the stretch path's shape at B=8 and at B=2, a small ragged
# one, fewer keys than one chunk of 64, one row over a chunk, hd 128; then
# where the bf16 body's tiling is most likely to break: S = 64 and 128 (no
# tail), S = 1 and 15 (fewer keys than the narrowest chunk of 16), S = 200
# at hd 32 and 128 (a tail of 8 keys, the 64-byte swizzle and two boxes of
# hd); last, ViT-B/16's token counts: 65 (8 x 8 patches of a 128^2 slice,
# the npz-initialised model) and 321 (the R50 hybrid's 8 x 8 x 5 features),
# neither a multiple of a tile.  Each runs on the model's views; the stretch
# shape at B=2 also on K3's views into the (B, T, 3D) QKV buffer.
K4_SHAPES = [(8, 12, 513, 64), (2, 12, 513, 64), (3, 2, 70, 32), (2, 3, 40, 64),
             (1, 2, 65, 128), (2, 2, 200, 32), (2, 12, 64, 64), (2, 12, 128, 64),
             (2, 12, 1, 64), (2, 12, 15, 64), (2, 4, 200, 32), (2, 4, 200, 128),
             (2, 12, 65, 64), (2, 12, 321, 64)]
K4_CASES = [(shape, "model") for shape in K4_SHAPES] + [((2, 12, 513, 64), "qkv")]


def _model_views(gen, shape, dtype):
    """q, k, v as the model makes them: (B, H, S, hd) views of three
    (B, S, H * hd) projections.  v is scaled by sqrt(S / e), so that the
    context's root mean square is 1 at every S."""
    B, H, S, hd = shape
    scales = (1.0, 1.0, math.sqrt(S / math.e))
    return [(torch.randn(B, S, H * hd, generator=gen, device="cuda") * c)
            .to(dtype).view(B, S, H, hd).transpose(1, 2) for c in scales]


def _qkv_views(gen, shape, dtype):
    """q, k, v as K3 hands them to K4's body: (B, H, S, hd) views into one
    (B, S, 3 * H * hd) QKV buffer, v scaled as in `_model_views`."""
    B, H, S, hd = shape
    qkv = torch.randn(B, S, 3 * H * hd, generator=gen, device="cuda")
    qkv[..., 2 * H * hd:] *= math.sqrt(S / math.e)
    return [t.unflatten(-1, (H, hd)).transpose(1, 2)
            for t in attention_layer._split(qkv.to(dtype))]


def _without_last_key(q, k, v):
    """The plain version over all keys but the last; with a single key, the
    empty sum 0."""
    if k.shape[-2] == 1:
        return torch.zeros_like(q)
    return fused_attention._plain_attention_k4(q, k[:, :, :-1], v[:, :, :-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,views", K4_CASES)
def test_attention_kernel_matches_plain(cuda, dtype, shape, views):
    make = _model_views if views == "model" else _qkv_views
    q, k, v = make(cuda, shape, dtype)
    assert shape[2] == 1 or not q.is_contiguous()   # one row is contiguous
    before = (fused_attention.launches, fused_attention.launches_k4)
    out = fused_attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert (fused_attention.launches,
            fused_attention.launches_k4) == (before[0], before[1] + 1)
    assert out.dtype == dtype and out.shape == q.shape
    # the heads merge without a copy, as in `models/vit3d.Attention`
    B, H, S, hd = shape
    merged = out.transpose(1, 2).reshape(B, S, H * hd)
    assert merged.data_ptr() == out.data_ptr() and merged.is_contiguous()
    ref = fused_attention._plain_attention_k4(q, k, v)
    _close(out, ref, dtype, _k4_tol(dtype))
    # the gate tells a context that lacks the last key from the right one
    with pytest.raises(AssertionError):
        _close(_without_last_key(q, k, v), ref, dtype, _k4_tol(dtype))
    # the JAX kernel's rounding (normalised probabilities), its tolerance
    _close(out, fused_attention._plain_attention(q, k, v), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_takes_other_layouts(cuda, dtype):
    """Contiguous (B, H, S, hd), a 3-d (H, S, hd) input, q, k, v with unlike
    strides, an empty batch, and a view at an address that is not 16-byte
    aligned: read as it lies in f32, copied to an aligned buffer in bf16
    (TMA's rule, `fused_attention._k4_views`)."""
    q, k, v = ((torch.randn(2, 3, 70, 64, generator=cuda, device="cuda") * c)
               .to(dtype) for c in (1.0, 1.0, math.sqrt(70 / math.e)))
    plain = fused_attention._plain_attention_k4
    tol = _k4_tol(dtype)
    _close(fused_attention.fused_attention(q, k, v), plain(q, k, v), dtype, tol)
    _close(fused_attention.fused_attention(q[0], k[0], v[0]),
           plain(q[0], k[0], v[0]), dtype, tol)
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)
    _close(fused_attention.fused_attention(q, kt, v), plain(q, kt, v), dtype, tol)
    before = fused_attention.launches_k4
    assert fused_attention.fused_attention(q[:0], k[:0], v[:0]).shape == (0, 3, 70, 64)
    assert fused_attention.launches_k4 == before      # nothing was launched
    flat = torch.randn(1 + 2 * 3 * 70 * 64, generator=cuda, device="cuda").to(dtype)
    odd = flat[1:].view(2, 3, 70, 64)
    assert not fused_attention._tma_rows(odd)
    _close(fused_attention.fused_attention(odd, k, v), plain(odd, k, v), dtype, tol)


def _exact_attention_k4(q, k, v):
    """K4's function in f64, from the f32 inputs: the exact context that
    the f32 plain version approximates."""
    s = torch.einsum("...hqd,...hkd->...hqk", q.double(), k.double())
    s = s / math.sqrt(q.shape[-1])
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return torch.einsum("...hqk,...hkd->...hqd", e, v.double()) / e.sum(dim=-1, keepdim=True)


def test_attention_kernel_f32_with_scores_four_times_larger(cuda):
    """f32 at the stretch shape with q and k doubled: the scores are 4 times
    larger, the softmax peaks on fewer keys, and the hi * lo terms of the
    3xTF32 products weigh most.  Held to the unchanged f32 tolerance of the
    exact (f64) context: at these scores the f32 plain version's own
    rounding of the scores moves the context by about the tolerance
    (`chip_smoke.py`, phase `K4`, prints both), so it is no reference here."""
    q, k, v = _model_views(cuda, (2, 12, 513, 64), torch.float32)
    q, k = q * 2, k * 2
    out = fused_attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.k4_body_launched() == "f32_tf32x3"
    ref = _exact_attention_k4(q, k, v)
    _close(out, ref, torch.float32)
    with pytest.raises(AssertionError):
        _close(_exact_attention_k4(q, k[:, :, :-1], v[:, :, :-1]), ref, torch.float32)


@pytest.mark.parametrize("offset", [0, 1])
def test_attention_kernel_f32_copies_by_alignment(cuda, offset):
    """f32 views whose bases and strides are multiples of 16 bytes are
    copied 16 bytes at a time; a view one element into its storage takes
    the 4-byte copies, at the stretch shape, with the same result."""
    B, H, S, hd = 2, 12, 513, 64
    views = []
    for c in (1.0, 1.0, math.sqrt(S / math.e)):
        flat = torch.randn(offset + B * S * H * hd, generator=cuda, device="cuda")
        views.append(flat[offset:].mul_(c).view(B, S, H, hd).transpose(1, 2))
    out = fused_attention.fused_attention(*views)
    torch.cuda.synchronize()
    assert fused_attention.k4_body_launched() == (
        "f32_tf32x3_4byte" if offset else "f32_tf32x3")
    _close(out, fused_attention._plain_attention_k4(*views), torch.float32)


# (N, D, M, active): the stretch path's rows at B=8 and B=1 at full width
# and masked, a partial row tile, a narrower wide D, the top of the range,
# a width the chunks do not divide, M % 8 != 0 (bf16: w2 read through a
# zero-padded copy), no active column (the output is b2), one output tile
# with the width mask inside it, one row, D = 128 with M = 3072 (many
# column tiles over a thin k), and ViT-B/16's rows at B=2 for 65 and 321
# tokens (the npz-initialised model and the R50 hybrid).
WIDE_K1_CASES = [(4104, 768, 3072, 3072), (4104, 768, 3072, 2072),
                 (513, 768, 3072, 3072), (70, 768, 256, 200),
                 (70, 128, 512, 512), (33, 1024, 96, 96), (50, 192, 100, 77),
                 (40, 256, 2204, 2000), (40, 768, 64, 0), (128, 128, 128, 77),
                 (1, 768, 3072, 3072), (300, 128, 3072, 3072),
                 (130, 768, 3072, 3072), (642, 768, 3072, 3072)]


def _wide_inputs(gen, N, D, M, dtype=torch.float32):
    bound = (6.0 / (D + M)) ** 0.5          # the model's xavier init
    x = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
    w1, w2 = (((torch.rand(*s, generator=gen, device="cuda") * 2 - 1) * bound)
              .to(dtype) for s in ((M, D), (D, M)))
    b1 = (torch.randn(M, generator=gen, device="cuda") * 0.1).to(dtype)
    b2 = (torch.randn(D, generator=gen, device="cuda") * 0.1).to(dtype)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,M,active", WIDE_K1_CASES)
def test_wide_fused_mlp_kernel_matches_plain(cuda, dtype, N, D, M, active):
    x, w1, b1, w2, b2 = _wide_inputs(cuda, N, D, M, dtype)
    before = fused_mlp.launches
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, active)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert fused_mlp.k1_body_launched() == (
        "wide_tf32x3" if dtype == torch.float32 else "wide_wgmma")
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, fused_mlp._plain_mlp(x, w1, b1, w2, b2, active), dtype)


def _f64_mlp(x, w1, b1, w2, b2, active):
    """K1's function in f64 from the f32 inputs: the exact result."""
    x, w1, b1, w2, b2 = (t.double() for t in (x, w1, b1, w2, b2))
    h = x @ w1.T + b1
    h = 0.5 * h * (1 + torch.erf(h / math.sqrt(2)))
    h[:, active:] = 0
    return h @ w2.T + b2


def test_wide_f32_kernel_with_x_four_times_larger(cuda):
    """f32 at the stretch path's B=1 shape with x four times larger: the
    hidden activations and fc2's sums are larger, where the 3xTF32 products'
    truncation inside the tensor cores weighs most.  Held to the unchanged
    f32 tolerance of the exact (f64) MLP: the f32 plain version's own
    rounding moves it by about half the tolerance here (`chip_smoke.py`,
    phase `K1_f32_scaled`, prints both)."""
    x, w1, b1, w2, b2 = _wide_inputs(cuda, 513, 768, 3072)
    x = x * 4
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, 3072)
    torch.cuda.synchronize()
    assert fused_mlp.k1_body_launched() == "wide_tf32x3"
    _close(out, _f64_mlp(x, w1, b1, w2, b2, 3072), torch.float32)


@pytest.mark.parametrize("N,D,M,active", [(513, 768, 3072, 3072),
                                          (70, 768, 256, 200),
                                          (1, 768, 3072, 3072)])
def test_wide_f32_kernel_gives_the_same_bits_twice(cuda, N, D, M, active):
    """Two calls on the same inputs give equal bits: K splits (fc2's at N =
    513, fc1's at 70 rows, both phases' at 1 row) are summed in a fixed
    order."""
    args = _wide_inputs(cuda, N, D, M)
    plan = fused_mlp.wide_f32_plan(N, D, M, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert max(plan["fc1"]["splits"], plan["fc2"]["splits"]) > 1
    first = fused_mlp.fused_mlp(*args, active)
    second = fused_mlp.fused_mlp(*args, active)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_wide_f32_body_counts_one_and_raises(cuda):
    """An f32 wide call is one step of `fused_mlp.launches` and of
    `launches_own` whatever its grid launches; the entry point refuses (no
    plain fallback) a base that TMA cannot read and a plan it does not
    take."""
    N, D, M = 70, 768, 256
    x, w1, b1, w2, b2 = _wide_inputs(cuda, N, D, M)
    before = (fused_mlp.launches, fused_mlp.launches_own)
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, 200)
    torch.cuda.synchronize()
    assert (fused_mlp.launches, fused_mlp.launches_own) == (before[0] + 1,
                                                            before[1] + 1)
    _close(out, fused_mlp._plain_mlp(x, w1, b1, w2, b2, 200), torch.float32)
    odd = torch.empty(N * D + 1, device="cuda")[1:].view(N, D)
    odd.copy_(x)
    stream = torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError, match="fused_mlp launch failed"):
        fused_mlp._build.check("fused_mlp", fused_mlp._launch_wide(
            odd, w1, b1, w2, b2, torch.empty_like(x), N, 200, None, 1, "seq", stream))
    fn = fused_mlp._build.entry("fused_mlp", fused_mlp._WIDE_F32_ARGTYPES,
                                "fused_mlp_wide_f32_launch")
    h = torch.empty(N, M, device="cuda")
    # two K splits of fc2 and no partial-sum scratch
    err = fn(x.device.index, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
             w2.data_ptr(), M, b2.data_ptr(), h.data_ptr(), M, None,
             out.data_ptr(), N, D, M, 200, None, 1, 1, 1, 2, 1, stream)
    with pytest.raises(RuntimeError, match="fused_mlp launch failed"):
        fused_mlp._build.check("fused_mlp", err)
    assert fused_mlp.launches == before[0] + 1


def test_wide_bf16_body_counts_one_and_raises(cuda):
    """A bf16 wide call is two grid launches (fc1 + GELU, then fc2) and one
    step of `fused_mlp.launches`; the wrapper raises on a tensor that is
    not on the card, and the entry point refuses (no plain fallback) a base
    that TMA cannot read."""
    N, D, M = 70, 768, 256
    x = torch.randn(N, D, generator=cuda, device="cuda").bfloat16()
    w1, b1, w2, b2 = _mlp_weights(cuda, torch.bfloat16, D, M)
    before = fused_mlp.launches
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, 200)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    _close(out, fused_mlp._plain_mlp(x, w1, b1, w2, b2, 200), torch.bfloat16)
    with pytest.raises(RuntimeError, match="kernel launch on cpu"):
        fused_mlp._launch(*(t.cpu() for t in (x, w1, b1, w2, b2)), 200)
    odd = torch.empty(N * D + 1, device="cuda", dtype=torch.bfloat16)[1:].view(N, D)
    odd.copy_(x)
    with pytest.raises(RuntimeError, match="fused_mlp launch failed"):
        err = fused_mlp._launch_wide(
            odd, w1, b1, w2, b2, torch.empty_like(x), N, 200, None, 1, "seq",
            torch.cuda.current_stream().cuda_stream)
        fused_mlp._build.check("fused_mlp", err)
    assert fused_mlp.launches == before + 1


def test_wide_gradients_recompute_through_plain(cuda):
    x = torch.randn(2, 35, 128, generator=cuda, device="cuda")
    w1 = torch.randn(256, 128, generator=cuda, device="cuda") * 0.05
    b1 = torch.randn(256, generator=cuda, device="cuda") * 0.1
    w2 = torch.randn(128, 256, generator=cuda, device="cuda") * 0.05
    b2 = torch.randn(128, generator=cuda, device="cuda") * 0.1
    qkv = _model_views(cuda, (2, 2, 70, 64), torch.float32)
    for kernel, plain, args in (
            (lambda *a: fused_mlp.fused_mlp(*a, 200),
             lambda *a: fused_mlp._plain_mlp(*a, 200), [x, w1, b1, w2, b2]),
            (fused_attention.fused_attention,
             fused_attention._plain_attention_k4, qkv)):
        grads = []
        for fn in (kernel, plain):
            leaves = [a.detach().clone().requires_grad_() for a in args]
            (fn(*leaves) ** 2).sum().backward()
            grads.append([t.grad for t in leaves])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _small_stretch_config():
    """The stretch model's shape class at a small size: z-patching, separate
    q/k/v projections (D > 64), head_dim 64."""
    return ViTConfig(patch_size=(16, 16, 16), hidden_size=128, num_heads=2,
                     mlp_dim=256, num_layers=2, img_size=32, z_size=32)


@pytest.mark.parametrize("impl,counts", [("auto", (2, 0, 0, 2, 0)),
                                         ("kernel", (2, 0, 0, 2, 0)),
                                         ("layer", (2, 0, 2, 0, 2))])
def test_small_stretch_model_matches_plain_modules(cuda, impl, counts):
    """f32: K1's wide body and K4 (or K3 under `layer`, on K4's body at
    head_dim 64) in the model, with the launches the code should make:
    (K1, K2, K3, K4, K3 on K4's body)."""
    model = VisionTransformer3D(_small_stretch_config(), zero_head=False,
                                vis=False)
    x = torch.randn(3, 32, 32, 32, 1, generator=cuda, device="cuda")

    def launches():
        return (fused_mlp.launches, fused_attention.launches,
                attention_layer.launches, fused_attention.launches_k4,
                attention_layer.launches_k4)

    attention.set_default_attention_impl(impl)
    try:
        with torch.no_grad():
            before = launches()
            out = model(x)
            assert tuple(b - a for a, b in zip(before, launches())) == counts
            attention.set_default_attention_impl("plain")
            mlp_select.set_default_mlp_impl("plain")
            ref = model(x)
    finally:
        mlp_select.set_default_mlp_impl("auto")
        attention.set_default_attention_impl("auto")
    torch.testing.assert_close(out.tokens, ref.tokens, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(out.logits, ref.logits, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("impl,counts", [("auto", (2, 0, 0, 2, 0)),
                                         ("layer", (2, 0, 2, 0, 2))])
def test_small_hybrid_model_matches_plain_modules(cuda, impl, counts):
    """f32: the ResNetV2 stem (one unit a stage, 64^2 slices: 4 x 4 x 5
    features of 1,024 channels, patches of 2 x 2 x 1, 21 tokens) under
    K1's wide body and K4 (or K3 on K4's body), against the plain modules;
    launches as (K1, K2, K3, K4, K3 on K4's body)."""
    cfg = ViTConfig(hidden_size=128, num_heads=2, mlp_dim=256, num_layers=2,
                    img_size=64, hybrid_grid=(2, 2), resnet_block_units=(1, 1, 1))
    model = VisionTransformer3D(cfg, zero_head=False, vis=False)
    x = torch.randn(2, 64, 64, 5, 1, generator=cuda, device="cuda")
    attention.set_default_attention_impl(impl)
    try:
        with torch.no_grad():
            before = (fused_mlp.launches, fused_attention.launches,
                      attention_layer.launches, fused_attention.launches_k4,
                      attention_layer.launches_k4)
            out = model(x)
            after = (fused_mlp.launches, fused_attention.launches,
                     attention_layer.launches, fused_attention.launches_k4,
                     attention_layer.launches_k4)
            assert tuple(b - a for a, b in zip(before, after)) == counts
            attention.set_default_attention_impl("plain")
            mlp_select.set_default_mlp_impl("plain")
            ref = model(x)
    finally:
        mlp_select.set_default_mlp_impl("auto")
        attention.set_default_attention_impl("auto")
    assert out.tokens.shape == (2, 21, 128)
    torch.testing.assert_close(out.tokens, ref.tokens, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(out.logits, ref.logits, atol=2e-4, rtol=1e-4)


# --- K1's model axis, K1b and K1c ---------------------------------------------

VARIANTS = {"seq": "launches", "chunked": "launches_k1b",
            "pipelined2": "launches_k1c"}


def _plain_of(variant):
    return (fused_mlp._plain_mlp_chunked if variant == "chunked"
            else fused_mlp._plain_mlp)


def _mlp_weights(gen, dtype, D, M, lead=()):
    """The model's xavier-scaled weights, small biases."""
    bound = (6.0 / (D + M)) ** 0.5
    w1, w2 = (((torch.rand(*lead, *s, generator=gen, device="cuda") * 2 - 1)
               * bound).to(dtype) for s in ((M, D), (D, M)))
    b1 = (torch.randn(*lead, M, generator=gen, device="cuda") * 0.1).to(dtype)
    b2 = (torch.randn(*lead, D, generator=gen, device="cuda") * 0.1).to(dtype)
    return w1, b1, w2, b2


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,M,active", [
    (3 * 65 + 7, 8, 2204, 2204), (3 * 65 + 7, 16, 2048, 2048),
    (3 * 65 + 7, 32, 3072, 1000), (3 * 65 + 7, 64, 1100, 1100),
    (3 * 65 + 7, 64, 3072, 0), (3 * 65 + 7, 16, 2204, 2000),
    (33280, 64, 3072, 3072),   # more row tiles than K1c's persistent blocks
    (40000, 16, 600, 513)])
def test_mlp_variants_match_plain(cuda, monkeypatch, variant, dtype, N, D, M,
                                  active):
    """K1, K1b and K1c against their plain versions (K1b: fc2 summed over
    512-column chunks), one counter step a call."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
    x = torch.randn(N, D, generator=cuda, device="cuda").to(dtype)
    w1, b1, w2, b2 = _mlp_weights(cuda, dtype, D, M)
    counts = {c: getattr(fused_mlp, c) for c in VARIANTS.values()}
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, active)
    torch.cuda.synchronize()
    for c, n in counts.items():
        assert getattr(fused_mlp, c) == n + (c == VARIANTS[variant])
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, _plain_of(variant)(x, w1, b1, w2, b2, active), dtype)


@pytest.mark.parametrize("D", [8, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipelined_equals_seq_bitwise(cuda, monkeypatch, dtype, D):
    """K1c sums in K1's order, so the two agree to the bit.  In bf16 at
    D >= 16 K1 launches K1c's own kernel, so there the case holds only the
    two wrappers to one launch of it."""
    x = torch.randn(9000, D, generator=cuda, device="cuda").to(dtype)
    args = _mlp_weights(cuda, dtype, D, 2048)
    seq = fused_mlp.fused_mlp(x, *args, 1500)
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "pipelined2")
    assert torch.equal(fused_mlp.fused_mlp(x, *args, 1500), seq)


# K1's bf16 calls at D >= 16, on K1c's `wgmma` pipeline, at one row, the
# latency path's token rows (B = 1, 4, 8 volumes of 65) and the serving
# pass's, at conf 9's widths and the widest class's: against the plain
# version (the TPU kernels' polynomial GELU), one K1 launch counted on that
# body and none as K1c's.
@pytest.mark.parametrize("N", [1, 65, 260, 520, 33280])
@pytest.mark.parametrize("D,M,active", [(16, 2048, 2048), (64, 3072, 2072),
                                        (32, 3072, 3072)])
def test_k1_bf16_on_the_pipeline_matches_plain(cuda, N, D, M, active):
    x = torch.randn(N, D, generator=cuda, device="cuda").to(torch.bfloat16)
    args = _mlp_weights(cuda, torch.bfloat16, D, M)
    before = (fused_mlp.launches, fused_mlp.launches_on_k1c,
              fused_mlp.launches_own, fused_mlp.launches_k1c)
    out = fused_mlp.fused_mlp(x, *args, active)
    torch.cuda.synchronize()
    assert fused_mlp.k1_body_launched() == "wgmma_pipeline"
    assert (fused_mlp.launches, fused_mlp.launches_on_k1c,
            fused_mlp.launches_own, fused_mlp.launches_k1c) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    _close(out, fused_mlp._plain_mlp(x, *args, active), torch.bfloat16)


@pytest.mark.parametrize("N", [520, 33280])
def test_k1_bf16_gradients_are_the_exact_references(cuda, N):
    """In bf16 the forward takes the polynomial GELU and the
    backward differentiates the exact-erf reference, as JAX's does: for a
    fixed cotangent, autograd's gradients through `_plain_mlp(exact=True)`,
    to the bit."""
    x = torch.randn(N, 32, generator=cuda, device="cuda").to(torch.bfloat16)
    args = _mlp_weights(cuda, torch.bfloat16, 32, 2048)
    cot = torch.randn(N, 32, generator=cuda, device="cuda").to(torch.bfloat16)
    grads = []
    for fn in (fused_mlp.fused_mlp,
               lambda *a: fused_mlp._plain_mlp(*a, exact=True)):
        leaves = [a.clone().requires_grad_() for a in (x, *args)]
        fn(*leaves, 1500).backward(cot)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_k1_bf16_kept_tensor_maps_follow_shape_and_contents(cuda):
    """The pipeline keeps the tensor maps it encoded, by address and shape:
    one buffer read at two row counts, and one weight buffer refilled
    between calls, each against the plain version."""
    D, M = 32, 2048
    xs = torch.randn(520, D, generator=cuda, device="cuda").to(torch.bfloat16)
    w1, b1, w2, b2 = _mlp_weights(cuda, torch.bfloat16, D, M)
    for rows in (520, 65, 520, 260):
        for _ in range(2):
            x = xs[:rows]
            _close(fused_mlp.fused_mlp(x, w1, b1, w2, b2, M),
                   fused_mlp._plain_mlp(x, w1, b1, w2, b2, M), torch.bfloat16)
            for t, new in zip((w1, b1, w2, b2),
                              _mlp_weights(cuda, torch.bfloat16, D, M)):
                t.copy_(new)


def test_k1_bf16_model_axis_on_the_pipeline_matches_plain(cuda):
    """K1 in bf16 with the model axis at the sweep's evaluation shape, one
    width a model on the device, on K1c's pipeline."""
    P, N, D, M = 30, 24 * 65, 64, 3072
    x = torch.randn(P, N, D, generator=cuda, device="cuda").to(torch.bfloat16)
    args = _mlp_weights(cuda, torch.bfloat16, D, M, (P,))
    active = torch.tensor([2048] * 15 + [3072] * 15, dtype=torch.int32,
                          device="cuda")
    out = fused_mlp.fused_mlp(x, *args, active)
    assert fused_mlp.k1_body_launched() == "wgmma_pipeline"
    _close(out, fused_mlp._plain_mlp(x, *args, active), torch.bfloat16)


# K1c's row tiles: one row, a ragged tile of 63, exactly one 64-row tile,
# one and two 128-row tiles (the bf16 body's) and a row past them, and the
# serving pass's 33,280 rows; at D = 16, 32 and 64 (the bf16 body's TMA
# swizzle of 32, 64 and 128 bytes), masked inside a chunk.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 63, 64, 127, 128, 129, 33280])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_pipelined_row_tiles_match_plain(cuda, monkeypatch, dtype, N, D):
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "pipelined2")
    M, active = 2048, 1500
    x = torch.randn(N, D, generator=cuda, device="cuda").to(dtype)
    w1, b1, w2, b2 = _mlp_weights(cuda, dtype, D, M)
    before = fused_mlp.launches_k1c
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, active)
    torch.cuda.synchronize()
    assert fused_mlp.launches_k1c == before + 1
    _close(out, fused_mlp._plain_mlp(x, w1, b1, w2, b2, active), dtype)


def test_k1c_plan_fits_the_card(cuda):
    """The plan from the card's own occupancy never puts more blocks on the
    grid than the resident slots at the model counts the paths use."""
    for dtype in (torch.float32, torch.bfloat16):
        for D in fused_mlp.WIDTHS:
            shape = fused_mlp.k1c_shape(torch.device("cuda", 0), D, dtype)
            assert shape["blocks_an_sm"] >= 1
            slots = shape["sms"] * shape["blocks_an_sm"]
            for models, n in ((1, 33280), (30, 1560), (15, 260)):
                plan = fused_mlp.k1c_plan(n, models, shape["tile_rows"], slots)
                assert plan["blocks"] <= slots


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,M", [(8, 2204), (16, 1100), (32, 2048), (64, 3072)])
def test_model_axis_matches_plain(cuda, monkeypatch, variant, dtype, D, M):
    """P = 4 models in one launch, each with its own width read on the
    device (one of them 0), against the model-axis plain version and
    against each model launched alone."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
    P, N = 4, 24 * 65
    x = torch.randn(P, N, D, generator=cuda, device="cuda").to(dtype)
    w1, b1, w2, b2 = _mlp_weights(cuda, dtype, D, M, (P,))
    active = torch.tensor([M, M - 700, 0, 513], dtype=torch.int32,
                          device="cuda")
    counter = VARIANTS[variant]
    before = getattr(fused_mlp, counter)
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, active)
    torch.cuda.synchronize()
    assert getattr(fused_mlp, counter) == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, _plain_of(variant)(x, w1, b1, w2, b2, active), dtype)
    for p in range(P):
        alone = fused_mlp.fused_mlp(x[p], w1[p], b1[p], w2[p], b2[p],
                                    int(active[p]))
        assert torch.equal(out[p], alone)
    # one int for every model
    _close(fused_mlp.fused_mlp(x, w1, b1, w2, b2, 700),
           _plain_of(variant)(x, w1, b1, w2, b2, 700), dtype)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_gradients_recompute_through_plain(cuda, monkeypatch, variant):
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
    x = torch.randn(3, 130, 16, generator=cuda, device="cuda")
    w1, b1, w2, b2 = _mlp_weights(cuda, torch.float32, 16, 1100, (3,))
    active = torch.tensor([1100, 600, 30], dtype=torch.int32, device="cuda")
    grads = []
    for fn in (fused_mlp.fused_mlp, _plain_of(variant)):
        leaves = [a.clone().requires_grad_() for a in (x, w1, b1, w2, b2)]
        (fn(*leaves, active) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    # masked hidden columns get zero weight gradients
    assert torch.all(grads[0][1][1, 600:] == 0) and torch.all(grads[0][1][2, 30:] == 0)


def test_variants_raise_on_what_they_do_not_take(cuda, monkeypatch):
    """Every variant takes the wide regime (D 128, and 8,193 and 12,288,
    refused before this port took every width) and raises on a model axis
    that x lacks, a width list of the wrong length and an unknown
    variant."""
    x = torch.randn(65, 128, generator=cuda, device="cuda")
    args = _mlp_weights(cuda, torch.float32, 128, 256)
    for variant in VARIANTS:
        monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
        _close(fused_mlp.fused_mlp(x, *args), _plain_of(variant)(x, *args, 256),
               torch.float32)
        for D in (8193, 12288):
            xw = torch.randn(65, D, generator=cuda, device="cuda")
            wide = _mlp_weights(cuda, torch.float32, D, 256)
            _close(fused_mlp.fused_mlp(xw, *wide), _plain_of(variant)(xw, *wide, 256),
                   torch.float32)
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "seq")
    w1, b1, w2, b2 = (torch.zeros(s, device="cuda")
                      for s in ((2, 64, 16), (2, 64), (2, 16, 64), (2, 16)))
    with pytest.raises(ValueError, match="expected \\(2, ..., 16\\)"):
        fused_mlp.fused_mlp(torch.zeros(3, 65, 16, device="cuda"), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="3 entries for 2 models"):
        fused_mlp.fused_mlp(torch.zeros(2, 65, 16, device="cuda"), w1, b1, w2, b2,
                            torch.ones(3, dtype=torch.int32, device="cuda"))
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "fused")
    with pytest.raises(ValueError, match="unknown fused_mlp variant"):
        fused_mlp.fused_mlp(torch.zeros(2, 65, 16, device="cuda"), w1, b1, w2, b2)


# --- the bf16 body at D <= 8: the pipeline's D = 8 instance ---------------
# K1, K1b and K1c in bf16 at D 1, 3 and 8 (1 and 3 zero-padded to 8) at conf
# 22's mlp_dim of 2,204: one row, a row tile of 65, conf 22's 257 tokens,
# and B = 8 and 512 volumes of them (2,056 rows: the plan's most splits
# that fit the card in one wave; 131,584: one split on the persistent grid);
# full width, a width that ends inside a stage, and 0.
D8_M = 2204
D8_BODIES = {"seq": "wgmma_pipeline_d8", "chunked": "chunked_wgmma_d8",
             "pipelined2": "wgmma_pipeline_d8"}
D8_KERNELS = {"mlp_pipelined": "pipelined_wgmma_d8_kernel",
              "mlp_chunked": "chunked_wgmma_d8_kernel"}


@pytest.mark.parametrize("active", [D8_M, 2000, 0])
@pytest.mark.parametrize("N", [1, 65, 257, 2056, 131584])
@pytest.mark.parametrize("D", [1, 3, 8])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_d8_bf16_matches_plain(cuda, monkeypatch, variant, D, N, active):
    """One launch on the variant's counter and none on the others', the D =
    8 body named, the plain version within the bf16 gate, and the same bits
    from a second call."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
    x = torch.randn(N, D, generator=cuda, device="cuda").to(torch.bfloat16)
    args = _mlp_weights(cuda, torch.bfloat16, D, D8_M)
    counts = {c: getattr(fused_mlp, c) for c in VARIANTS.values()}
    out = fused_mlp.fused_mlp(x, *args, active)
    torch.cuda.synchronize()
    for c, n in counts.items():
        assert getattr(fused_mlp, c) == n + (c == VARIANTS[variant])
    assert _body_of(variant) == D8_BODIES[variant]
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    _close(out, _plain_of(variant)(x, *args, active), torch.bfloat16)
    assert torch.equal(fused_mlp.fused_mlp(x, *args, active), out)


@pytest.mark.parametrize("N", [257, 2056])
@pytest.mark.parametrize("D", [3, 8])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_d8_bf16_model_axis_stacked_is_alone(cuda, monkeypatch, variant, D, N):
    """Three models in one launch with widths 2,204, 2,000 and 0 read on
    the device: against the plain version, b2 alone where the width is 0,
    and each model launched alone to the bit (the plan's splits depend on
    the rows and M alone, so a model's sums do not depend on the others)."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
    P = 3
    x = torch.randn(P, N, D, generator=cuda, device="cuda").to(torch.bfloat16)
    w1, b1, w2, b2 = _mlp_weights(cuda, torch.bfloat16, D, D8_M, (P,))
    widths = torch.tensor([D8_M, 2000, 0], dtype=torch.int32, device="cuda")
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths)
    torch.cuda.synchronize()
    assert _body_of(variant) == D8_BODIES[variant]
    _close(out, _plain_of(variant)(x, w1, b1, w2, b2, widths), torch.bfloat16)
    assert torch.equal(out[2], b2[2].expand(N, D))
    for p in range(P):
        alone = fused_mlp.fused_mlp(x[p], w1[p], b1[p], w2[p], b2[p], int(widths[p]))
        assert torch.equal(out[p], alone)


def test_d8_entries_refuse_a_plan_they_do_not_take(cuda):
    """K1c's and K1b's bf16 entries at D = 8 refuse more than 16 splits, a
    split grid with fewer groups than row tiles, more groups than row tiles,
    and more than one split at D 16-64; each launches nothing, and the plan's
    grid then runs."""
    N, M = 2056, 2208          # M a multiple of 8: w2's rows as TMA reads them
    stream = torch.cuda.current_stream().cuda_stream
    for library in D8_KERNELS:
        fn = fused_mlp._build.entry(library, fused_mlp._K1C_ARGTYPES)
        for D, groups, splits in ((8, 17, 17), (8, 16, 2), (8, 18, 1), (16, 17, 2)):
            x = torch.randn(N, D, generator=cuda, device="cuda").to(torch.bfloat16)
            w1, b1, w2, b2 = _mlp_weights(cuda, torch.bfloat16, D, M)
            out = torch.full_like(x, 7.0)
            with pytest.raises(RuntimeError, match=f"{library} launch failed"):
                fused_mlp._build.check(library, fn(
                    0, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), M,
                    b2.data_ptr(), out.data_ptr(), N, D, M, M, None, 1, groups, splits, 1,
                    stream))
            torch.cuda.synchronize()
            assert torch.all(out == 7.0)
        fused_mlp._build.check(library, fn(
            0, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), M, b2.data_ptr(),
            out.data_ptr(), N, 16, M, M, None, 1, 17, 1, 1, stream))
        torch.cuda.synchronize()
        plain = (fused_mlp._plain_mlp_chunked if library == "mlp_chunked"
                 else fused_mlp._plain_mlp)
        _close(out, plain(x, w1, b1, w2, b2, M), torch.bfloat16)


def test_d8_instance_runs_on_wgmma(cuda):
    """The D = 8 instance in K1c's and K1b's libraries: HGMMA and UTMALDG
    instructions in its SASS, no spill, no wgmma that ptxas serialised
    (C7515, or C7518 for a wait on a divergent path); the card holds its
    clusters of every size up to 16, and the plan at conf 22's B = 8 fits
    them in one wave."""
    device = torch.device("cuda", 0)
    for library, kernel in D8_KERNELS.items():
        fused_mlp._build.load(library)
        path = fused_mlp._build.library_path(library)
        log = path.with_suffix(".log").read_text()
        assert not any(kernel in line and ("(C7515)" in line or "(C7518)" in line)
                       for line in log.splitlines())
        spills = re.findall(r"Function properties for (\S+)\n\s+\d+ bytes stack "
                            r"frame, (\d+) bytes spill stores", log)
        assert [n for name, n in spills if kernel in name] == ["0"]
        cuobjdump = pathlib.Path(fused_mlp._build._nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                              text=True, check=True).stdout
        fns = [f for f in sass.split("Function : ")[1:] if kernel in f.split()[0]]
        assert len(fns) == 1 and "HGMMA" in fns[0] and "UTMALDG" in fns[0]
        held = fused_mlp.k1_d8_clusters(device, library)
        assert len(held) == fused_mlp.D8_MAX_SPLITS and all(c >= 1 for c in held)
        shape = fused_mlp.k1c_shape(device, 8, torch.bfloat16, library)
        assert held[0] == shape["sms"] * shape["blocks_an_sm"]
        plan = fused_mlp.k1_d8_plan(2056, D8_M, 1, held, library == "mlp_chunked")
        assert plan["splits"] > 1 and plan["tiles"] <= held[plan["splits"] - 1]


# --- K1b's f32 body: 3xTF32 on `mma.sync` ---------------------------------


def test_k1b_f32_with_x_four_times_larger(cuda, monkeypatch):
    """K1b in f32 at the model axis's widths (D = 64, M = 3,072) with x four
    times larger, where the 3xTF32 products' truncation inside the tensor
    cores weighs most: held to the exact (f64) MLP at the f32 tolerance."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "chunked")
    x = torch.randn(1560, 64, generator=cuda, device="cuda") * 4
    w1, b1, w2, b2 = _mlp_weights(cuda, torch.float32, 64, 3072)
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, 3072)
    torch.cuda.synchronize()
    _close(out, _f64_mlp(x, w1, b1, w2, b2, 3072), torch.float32)


def test_k1b_f32_model_axis_gives_the_same_bits_twice(cuda, monkeypatch):
    """The model axis at the sweep's evaluation shape (30 models of 1,560
    rows, D = 64, widths 2,048 and 3,072): two calls give equal bits, and
    the result holds the plain version."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "chunked")
    P, N, D, M = 30, 1560, 64, 3072
    x = torch.randn(P, N, D, generator=cuda, device="cuda")
    w1, b1, w2, b2 = _mlp_weights(cuda, torch.float32, D, M, (P,))
    widths = torch.tensor([2048] * 15 + [3072] * 15, dtype=torch.int32, device="cuda")
    first = fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths)
    second = fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _close(first, fused_mlp._plain_mlp_chunked(x, w1, b1, w2, b2, widths), torch.float32)


@pytest.mark.parametrize("D", [8, 16, 32, 64])
def test_k1b_f32_model_axis_widths(cuda, monkeypatch, D):
    """Three models in one launch with widths 0, 1,030 and M = 1,100 (two
    whole 512-column chunks and a partial one, its last sub-chunk cut by the
    mask), 300 rows each (a partial row tile): against the plain version and
    each model launched alone, one K1b launch a call and no other."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "chunked")
    P, N, M = 3, 300, 1100
    x = torch.randn(P, N, D, generator=cuda, device="cuda")
    w1, b1, w2, b2 = _mlp_weights(cuda, torch.float32, D, M, (P,))
    widths = torch.tensor([0, 1030, M], dtype=torch.int32, device="cuda")
    counts = {c: getattr(fused_mlp, c) for c in VARIANTS.values()}
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths)
    torch.cuda.synchronize()
    for c, n in counts.items():
        assert getattr(fused_mlp, c) == n + (c == "launches_k1b")
    _close(out, fused_mlp._plain_mlp_chunked(x, w1, b1, w2, b2, widths), torch.float32)
    torch.testing.assert_close(out[0], b2[0].expand(N, D), atol=0, rtol=0)
    for p in range(P):
        alone = fused_mlp.fused_mlp(x[p], w1[p], b1[p], w2[p], b2[p], int(widths[p]))
        assert torch.equal(out[p], alone)


def test_k1b_f32_entry_refuses_what_it_does_not_take(cuda):
    """The f32 entry point launches its body or refuses (no plain fallback):
    a grid of no row tile or of more row tiles than the rows fill, a D it
    has no body for; the other entry takes bf16 alone."""
    N, D, M = 70, 64, 1100
    x = torch.randn(N, D, generator=cuda, device="cuda")
    w1, b1, w2, b2 = _mlp_weights(cuda, torch.float32, D, M)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    f32 = fused_mlp._build.entry("mlp_chunked", fused_mlp._K1B_F32_ARGTYPES,
                                 "mlp_chunked_f32_launch")
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, out)]
    for d, tiles in ((D, 0), (D, 2), (48, 1)):
        with pytest.raises(RuntimeError, match="mlp_chunked launch failed"):
            fused_mlp._build.check("mlp_chunked", f32(0, *ptrs, N, d, M, M, None, 1,
                                                      tiles, stream))
    fused_mlp._build.check("mlp_chunked", f32(0, *ptrs, N, D, M, M, None, 1, 1, stream))
    torch.cuda.synchronize()
    _close(out, fused_mlp._plain_mlp_chunked(x, w1, b1, w2, b2, M), torch.float32)
    bf16 = fused_mlp._build.entry("mlp_chunked", fused_mlp._K1C_ARGTYPES)
    x_, w1_, b1_, w2_, b2_, out_ = ptrs
    with pytest.raises(RuntimeError, match="mlp_chunked launch failed"):
        fused_mlp._build.check("mlp_chunked", bf16(0, x_, w1_, b1_, w2_, M, b2_, out_, N, D,
                                                   M, M, None, 1, 1, 1, 0, stream))


# --- K1b's bf16 body: K1c's `wgmma` pipeline, fc2 summed chunk by chunk ----


def _k1b_bf16_case(gen, P, N, D, M):
    x = torch.randn(*((P,) if P else ()), N, D, generator=gen, device="cuda")
    return (x.to(torch.bfloat16),
            *_mlp_weights(gen, torch.bfloat16, D, M, (P,) if P else ()))


# 200 rows: a ragged last 128-row tile; M = 1,100 masked at 1,030 (a partial
# last 512-column chunk, its last stage cut by the mask) and M = 3,072 masked
# at 2,072 (a last chunk of one partial stage); the serving shape.
@pytest.mark.parametrize("N,M,active", [(200, 1100, 1030), (200, 3072, 2072),
                                        (33280, 3072, 3072)])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_k1b_bf16_on_the_wgmma_pipeline_matches_plain(cuda, monkeypatch, D, N, M, active):
    """K1b in bf16 at D 16-64 launches its `wgmma` pipeline, one K1b launch
    and no other, and holds `_plain_mlp_chunked` within the bf16 gate."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "chunked")
    x, w1, b1, w2, b2 = _k1b_bf16_case(cuda, 0, N, D, M)
    counts = {c: getattr(fused_mlp, c) for c in VARIANTS.values()}
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, active)
    torch.cuda.synchronize()
    assert fused_mlp.k1b_body_launched() == "chunked_wgmma"
    for c, n in counts.items():
        assert getattr(fused_mlp, c) == n + (c == "launches_k1b")
    _close(out, fused_mlp._plain_mlp_chunked(x, w1, b1, w2, b2, active), torch.bfloat16)


@pytest.mark.parametrize("D", [16, 32, 64])
def test_k1b_bf16_model_axis_widths(cuda, monkeypatch, D):
    """Three models in one launch with widths 0, 1,030 and M = 1,100, 200
    rows each: against the plain version, b2 alone where the width is 0, and
    each model launched alone to the bit (a model's tiles and sums do not
    depend on the others)."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "chunked")
    P, N, M = 3, 200, 1100
    x, w1, b1, w2, b2 = _k1b_bf16_case(cuda, P, N, D, M)
    widths = torch.tensor([0, 1030, M], dtype=torch.int32, device="cuda")
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths)
    torch.cuda.synchronize()
    assert fused_mlp.k1b_body_launched() == "chunked_wgmma"
    _close(out, fused_mlp._plain_mlp_chunked(x, w1, b1, w2, b2, widths), torch.bfloat16)
    assert torch.equal(out[0], b2[0].expand(N, D))
    for p in range(P):
        alone = fused_mlp.fused_mlp(x[p], w1[p], b1[p], w2[p], b2[p], int(widths[p]))
        assert torch.equal(out[p], alone)


# M a multiple of 8: the entry reads w2's and b1's rows by TMA as they lie
@pytest.mark.parametrize("N,M,active", [(200, 1104, 1030), (4160, 3072, 2072)])
@pytest.mark.parametrize("D", [16, 64])
def test_k1b_bf16_on_one_block(cuda, monkeypatch, D, N, M, active):
    """The entry on a grid of one block a model, which walks every row tile
    in turn, gives the plan's grid's bits: a tile's sums do not depend on
    the block that takes it."""
    x, w1, b1, w2, b2 = _k1b_bf16_case(cuda, 0, N, D, M)
    stream = torch.cuda.current_stream().cuda_stream
    fn = fused_mlp._build.entry("mlp_chunked", fused_mlp._K1C_ARGTYPES)
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "chunked")
    planned = fused_mlp.fused_mlp(x, w1, b1, w2, b2, active)
    out = torch.empty_like(x)
    fused_mlp._build.check("mlp_chunked", fn(
        0, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), M, b2.data_ptr(),
        out.data_ptr(), N, D, M, active, None, 1, 1, 1, 1, stream))
    torch.cuda.synchronize()
    assert torch.equal(out, planned)
    _close(out, fused_mlp._plain_mlp_chunked(x, w1, b1, w2, b2, active), torch.bfloat16)


def test_k1b_bf16_shape_is_k1cs_pipeline(cuda):
    """K1b's bf16 body has K1c's tile and threads at every D 8-64, one
    block an SM, and K1c's shared memory and its running sums (D / 2 f32 a
    consumer thread); its shape entry refuses f32."""
    device = torch.device("cuda", 0)
    for D in (8, 16, 32, 64):
        k1b = fused_mlp.k1c_shape(device, D, torch.bfloat16, "mlp_chunked")
        k1c = fused_mlp.k1c_shape(device, D, torch.bfloat16)
        for key in ("tile_rows", "threads_a_block", "blocks_an_sm"):
            assert k1b[key] == k1c[key]
        assert k1b["smem_bytes_a_block"] == k1c["smem_bytes_a_block"] + 256 * (D // 2) * 4
        assert k1b["blocks_an_sm"] == 1
    with pytest.raises(RuntimeError, match="mlp_chunked launch failed"):
        fused_mlp.k1c_shape(device, 64, torch.float32, "mlp_chunked")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_regime_takes_no_model_axis(cuda, dtype):
    """The wide bodies of K1, K1b and K1c take the model axis and read a
    tensor width on the device: a stacked call at a wide D with one width a
    model runs without a host synchronisation (CUDA's sync debug mode
    raises on one) and matches the plain version; a single model with a
    tensor width does too."""
    P, N, D, M = 3, 70, 128, 512
    x = torch.randn(P, N, D, generator=cuda, device="cuda").to(dtype)
    w1, b1, w2, b2 = _mlp_weights(cuda, dtype, D, M, (P,))
    widths = torch.tensor([512, 200, 0], dtype=torch.int32, device="cuda")
    width = torch.tensor(200, dtype=torch.int32, device="cuda")
    for variant in VARIANTS:
        fused_mlp._MLP_VARIANT = variant
        try:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths)
                one = fused_mlp.fused_mlp(x[0], w1[0], b1[0], w2[0], b2[0], width)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        finally:
            fused_mlp._MLP_VARIANT = "seq"
        _close(out, _plain_of(variant)(x, w1, b1, w2, b2, widths), dtype)
        _close(one, _plain_of(variant)(x[0], w1[0], b1[0], w2[0], b2[0], 200), dtype)


# --- every width the TPU kernels take ----------------------------------------
# K1 at hidden sizes between the narrow bodies' (1, 12, 24, 48: zero-padded
# to the next), wide ones that a stage or tile does not divide (72, 96, 200,
# 1,288; 1,290 and 1,030 not a multiple of 8 in bf16), ViT-H's 1,280, and up
# to 8,192; M = 4 D (2,048 at 8,192), a width mask below M, ragged rows.
ODD_K1 = [(1, 64), (12, 48), (24, 96), (48, 192), (72, 288), (96, 384),
          (200, 800), (1030, 4120), (1280, 5120), (1288, 5152), (1290, 5160),
          (2048, 8192), (8192, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,M", ODD_K1)
def test_k1_at_every_width_matches_plain(cuda, dtype, D, M):
    """One launch at every hidden size, on the body `_k1_body` names, held to
    the plain version at the JAX tolerances."""
    N, active = 70, M - M // 5
    x, w1, b1, w2, b2 = _wide_inputs(cuda, N, D, M, dtype)
    before = (fused_mlp.launches, fused_mlp.launches_on_k1c + fused_mlp.launches_own)
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, active)
    torch.cuda.synchronize()
    assert (fused_mlp.launches, fused_mlp.launches_on_k1c
            + fused_mlp.launches_own) == (before[0] + 1, before[1] + 1)
    assert fused_mlp.k1_body_launched() == fused_mlp._k1_body(dtype, D)
    assert out.dtype == dtype and out.shape == (N, D)
    _close(out, fused_mlp._plain_mlp(x, w1, b1, w2, b2, active), dtype)


# K4 and K3 at head dims on every body K4 is built for, exact (80, 256) and
# padded (17, 20, 24, 33, 48, 72, 96, 100, 130, 160, 192, 200: 20 in bf16
# copied, its rows not 16 bytes apart), at S = 65 and 513.
ODD_HD = [17, 20, 24, 33, 48, 72, 80, 96, 100, 130, 160, 192, 200, 256]


@pytest.mark.parametrize("views", ["model", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [65, 513])
@pytest.mark.parametrize("hd", ODD_HD)
def test_k4_at_every_head_dim_matches_plain(cuda, hd, S, dtype, views):
    q, k, v = _model_views(cuda, (2, 3, S, hd), dtype)
    if views == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = fused_attention.launches_k4
    out = fused_attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches_k4 == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = fused_attention._plain_attention_k4(q, k, v)
    _close(out, ref, dtype, _k4_tol(dtype))
    with pytest.raises(AssertionError):
        _close(_without_last_key(q, k, v), ref, dtype, _k4_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [65, 513])
@pytest.mark.parametrize("hd", ODD_HD)
def test_k3_at_every_head_dim_matches_plain(cuda, hd, S, dtype):
    """K3's core on K4's body, on the views of a (B, T, 3D) buffer: in bf16
    at a head_dim that 8 does not divide the views are copied first."""
    H = 3
    q, k, v = attention_layer._split(_k3_qkv(cuda, (2,), S, H, hd, dtype))
    out = _k3_launch_checked(q, k, v, H)
    ref = attention_layer._plain_attention_core(q, k, v, H)
    _close(out, ref, dtype, _k4_tol(dtype))


# K4 and K3 above head_dim 256, on the sliced bodies: 257 (8 does not
# divide it: bf16 views copied), 264 (a second slice of 8 columns), 288,
# 384, 512 (two slices of 256), 1,000, 1,024 and 2,049 (f32: nine slices in
# two groups of a cluster of five, one rank without context columns).
SLICED_HD = [257, 264, 288, 384, 512, 1000, 1024, 2049]
SLICED_BODIES = {torch.bfloat16: "bf16_sliced_wgmma", torch.float32: "f32_sliced_wgmma"}


@pytest.mark.parametrize("views", ["model", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [65, 513])
@pytest.mark.parametrize("hd", SLICED_HD)
def test_k4_above_head_dim_256_matches_plain(cuda, hd, S, dtype, views):
    """One launch on the sliced body (views whose rows are not a multiple of
    16 bytes apart copied first), held to the plain version at K4's gates,
    which reject the plain version without the last key."""
    q, k, v = _model_views(cuda, (2, 3, S, hd), dtype)
    if views == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = fused_attention.launches_k4
    out = fused_attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches_k4 == before + 1
    assert fused_attention.k4_body_launched() == SLICED_BODIES[dtype]
    assert out.dtype == dtype and out.shape == q.shape
    ref = fused_attention._plain_attention_k4(q, k, v)
    _close(out, ref, dtype, _k4_tol(dtype))
    with pytest.raises(AssertionError):
        _close(_without_last_key(q, k, v), ref, dtype, _k4_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [65, 513])
@pytest.mark.parametrize("hd", SLICED_HD)
def test_k3_above_head_dim_256_matches_plain(cuda, hd, S, dtype):
    """K3's core on K4's sliced body, on the views of a (B, T, 3D) buffer."""
    H = 2
    q, k, v = attention_layer._split(_k3_qkv(cuda, (2,), S, H, hd, dtype))
    out = _k3_launch_checked(q, k, v, H)
    assert fused_attention.k4_body_launched().startswith(SLICED_BODIES[dtype])
    _close(out, attention_layer._plain_attention_core(q, k, v, H), dtype, _k4_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [65, 513])
@pytest.mark.parametrize("hd", [264, 512, 1024])
def test_k4_sliced_f32_gives_equal_bits(cuda, hd, S, dtype):
    """Two launches of a sliced body on the same views give the same bits:
    the ranks' partial scores are added in rank order, no atomics."""
    q, k, v = _model_views(cuda, (2, 3, S, hd), dtype)
    first = fused_attention.fused_attention(q, k, v)
    second = fused_attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.k4_body_launched() == SLICED_BODIES[dtype]
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [65, 513])
def test_k4_sliced_f32_copies_views_off_16_bytes(cuda, S, dtype):
    """Views at head_dim 257, one element past a 16-byte boundary with rows
    258 elements apart (1,032 bytes in f32, 516 in bf16), which TMA cannot
    read: copied into rows of a multiple of 16 bytes (260 floats, 264
    bf16), one launch, held to the plain version (v scaled as in
    `_model_views`)."""
    hd = 257
    q, k, v = ((torch.randn(2, 3, S, hd + 1, generator=cuda, device="cuda") * c).to(dtype)[..., 1:]
               for c in (1.0, 1.0, math.sqrt(S / math.e)))
    assert q.data_ptr() % 16 == q.element_size() and q.stride(2) == hd + 1
    assert not fused_attention._tma_rows(q)
    assert fused_attention._k4_views(q, k, v)[0].stride(2) == (260 if dtype == torch.float32
                                                                else 264)
    before = fused_attention.launches_k4
    out = fused_attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches_k4 == before + 1
    assert fused_attention.k4_body_launched() == SLICED_BODIES[dtype]
    ref = fused_attention._plain_attention_k4(q, k, v)
    _close(out, ref, dtype, _k4_tol(dtype))
    with pytest.raises(AssertionError):
        _close(_without_last_key(q, k, v), ref, dtype, _k4_tol(dtype))


# K1, K1b and K1c above 8,192: 8,193 (zero-padded to 8,200 in bf16, 8,196 in
# f32), 8,200, 12,288 (the `widest` model's, M 4 D) and 16,384, at 70 rows.
WIDEST_K1 = [(8193, 4096), (8200, 32800), (12288, 49152), (16384, 8192)]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,M", WIDEST_K1)
def test_k1_variants_above_8192_match_plain(cuda, monkeypatch, variant, dtype, D, M):
    """One launch of each variant on its wide body, held to its plain
    version at the JAX tolerances."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
    N, active = 70, M - M // 5
    x, w1, b1, w2, b2 = _wide_inputs(cuda, N, D, M, dtype)
    before = getattr(fused_mlp, VARIANTS[variant])
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, active)
    torch.cuda.synchronize()
    assert getattr(fused_mlp, VARIANTS[variant]) == before + 1
    assert fused_mlp._variant_body(variant, dtype, D).startswith("wide_")
    assert out.dtype == dtype and out.shape == (N, D)
    _close(out, _plain_of(variant)(x, w1, b1, w2, b2, active), dtype)


def test_k1b_f32_scratch_stays_within_its_bound(cuda, monkeypatch):
    """K1b in f32 at D 12,288, M 49,152 (96 chunks of fc2's K), 1,026 rows:
    its partial-sum scratch holds one wave of WIDE_F32_MAX_SPLITS chunks
    (`wide_f32_scratch`), not 96, and the call's peak memory beyond its
    inputs stays within h, the output and that scratch; the result is the
    plain version's, its chunks summed in order."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "chunked")
    N, D, M = 1026, 12288, 49152
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fused_mlp.wide_f32_plan(N, D, M, sms, chunked=True)
    scratch = fused_mlp.wide_f32_scratch(plan, M)
    assert plan["fc2"]["splits"] == M // 512
    assert scratch == fused_mlp.WIDE_F32_MAX_SPLITS * N * D
    x, w1, b1, w2, b2 = _wide_inputs(cuda, N, D, M)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - start
    assert grown <= 4 * (N * M + N * D + scratch) + 2 ** 24
    _close(out, fused_mlp._plain_mlp_chunked(x, w1, b1, w2, b2, M), torch.float32)


@pytest.mark.parametrize("impl,counts", [("auto", (2, 0, 0, 2, 0)),
                                         ("layer", (2, 0, 2, 0, 2))])
def test_head_dim_80_model_matches_plain_modules(cuda, impl, counts):
    """f32: a two-layer model at D 160 in 2 heads of 80 (ViT-H's head_dim),
    MLP 640, 65 tokens: K1's wide body and K4 (K3 on K4's body under
    `layer`), with the launches (K1, K2, K3, K4, K3 on K4's body)."""
    cfg = ViTConfig(patch_size=(8, 8, 8), hidden_size=160, num_heads=2,
                    mlp_dim=640, num_layers=2, img_size=32, z_size=32)
    model = VisionTransformer3D(cfg, zero_head=False, vis=False)
    x = torch.randn(2, 32, 32, 32, 1, generator=cuda, device="cuda")

    def launches():
        return (fused_mlp.launches, fused_attention.launches,
                attention_layer.launches, fused_attention.launches_k4,
                attention_layer.launches_k4)

    attention.set_default_attention_impl(impl)
    try:
        with torch.no_grad():
            before = launches()
            out = model(x)
            assert tuple(b - a for a, b in zip(before, launches())) == counts
            attention.set_default_attention_impl("plain")
            mlp_select.set_default_mlp_impl("plain")
            ref = model(x)
    finally:
        mlp_select.set_default_mlp_impl("auto")
        attention.set_default_attention_impl("auto")
    torch.testing.assert_close(out.tokens, ref.tokens, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(out.logits, ref.logits, atol=2e-4, rtol=1e-4)


# --- K1's and K1c's narrow f32 body (3xTF32 on wgmma, split across a cluster) --
# One model at every narrow D, at M of two and a few chunks of 32 (64, 100:
# a ragged last chunk) and the registry's 2,048 and 3,072, at one row, a
# volume's 65 tokens, the training path's 260 rows and 4,160.
@pytest.mark.parametrize("N", [1, 65, 260, 4160])
@pytest.mark.parametrize("M", [64, 100, 2048, 3072])
@pytest.mark.parametrize("D", [8, 16, 32, 64])
def test_k1_narrow_f32_matches_plain(cuda, D, M, N):
    """One launch on the narrow f32 body, counted as K1's own, held to the
    plain version at the f32 gate; two calls give the same bits."""
    x = torch.randn(N, D, generator=cuda, device="cuda")
    args = _mlp_weights(cuda, torch.float32, D, M)
    before = (fused_mlp.launches, fused_mlp.launches_own, fused_mlp.launches_on_k1c)
    out = fused_mlp.fused_mlp(x, *args, M)
    torch.cuda.synchronize()
    assert fused_mlp.k1_body_launched() == "narrow_tf32x3"
    assert (fused_mlp.launches, fused_mlp.launches_own, fused_mlp.launches_on_k1c) == (
        before[0] + 1, before[1] + 1, before[2])
    _close(out, fused_mlp._plain_mlp(x, *args, M), torch.float32)
    assert torch.equal(out, fused_mlp.fused_mlp(x, *args, M))


@pytest.mark.parametrize("P", [1, 2, 30])
@pytest.mark.parametrize("M", [100, 2048, 3072])
@pytest.mark.parametrize("D", [8, 16, 32, 64])
def test_k1_narrow_f32_model_axis_widths(cuda, D, M, P):
    """P models at 260 rows each with widths on the device, in turn 0, a
    partial one (inside a chunk) and M: against the plain version, each
    model launched alone with a host width (the same bits), and a second
    call (the same bits)."""
    N = 260
    x = torch.randn(P, N, D, generator=cuda, device="cuda")
    w1, b1, w2, b2 = _mlp_weights(cuda, torch.float32, D, M, (P,))
    widths = torch.tensor([(0, M // 2 + 3, M)[p % 3] for p in range(P)],
                          dtype=torch.int32, device="cuda")
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths)
    torch.cuda.synchronize()
    assert fused_mlp.k1_body_launched() == "narrow_tf32x3"
    _close(out, fused_mlp._plain_mlp(x, w1, b1, w2, b2, widths), torch.float32)
    assert torch.equal(out, fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths))
    for p in range(P):
        alone = fused_mlp.fused_mlp(x[p], w1[p], b1[p], w2[p], b2[p], int(widths[p]))
        assert torch.equal(out[p], alone)


@pytest.mark.parametrize("N,P", [(1, 1), (260, 1), (4160, 1), (1560, 30)])
@pytest.mark.parametrize("D", [8, 16, 32, 64])
def test_k1c_f32_runs_on_the_narrow_body(cuda, monkeypatch, D, N, P):
    """K1c's f32 route launches the narrow f32 body from its own library,
    counted as K1c's, on its own row-tile groups, and gives K1's bits."""
    M = 3072
    lead = (P,) if P > 1 else ()
    x = torch.randn(*lead, N, D, generator=cuda, device="cuda")
    args = _mlp_weights(cuda, torch.float32, D, M, lead)
    widths = (torch.tensor([2048] * (P // 2) + [3072] * (P - P // 2), dtype=torch.int32,
                           device="cuda") if P > 1 else 2500)
    seq = fused_mlp.fused_mlp(x, *args, widths)
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "pipelined2")
    before = (fused_mlp.launches, fused_mlp.launches_k1c)
    out = fused_mlp.fused_mlp(x, *args, widths)
    torch.cuda.synchronize()
    assert (fused_mlp.launches, fused_mlp.launches_k1c) == (before[0], before[1] + 1)
    assert fused_mlp.k1c_body_launched() == "narrow_tf32x3"
    _close(out, fused_mlp._plain_mlp(x, *args, widths), torch.float32)
    assert torch.equal(out, seq)


def test_k1_narrow_f32_with_x_four_times_larger(cuda):
    """x four times larger at the widest class's widths, where the 3xTF32
    truncation inside the tensor cores weighs most: within the f32 gate of
    the exact (f64) MLP."""
    N, D, M = 260, 64, 3072
    x = torch.randn(N, D, generator=cuda, device="cuda") * 4
    args = _mlp_weights(cuda, torch.float32, D, M)
    out = fused_mlp.fused_mlp(x, *args, M)
    _close(out, _f64_mlp(x, *args, M), torch.float32)


def test_k1_narrow_f32_entry_refuses_what_it_does_not_take(cuda):
    """The narrow f32 entry points launch the body or refuse (no plain
    fallback): no split, more than 16 splits, no group, more groups than
    row tiles, a D it has no body for."""
    N, D, M = 130, 64, 1100
    x = torch.randn(N, D, generator=cuda, device="cuda")
    w1, b1, w2, b2 = _mlp_weights(cuda, torch.float32, D, M)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, out)]
    for lib, symbol in (("fused_mlp", "fused_mlp_narrow_f32_launch"),
                        ("mlp_pipelined", "mlp_pipelined_f32_launch")):
        fn = fused_mlp._build.entry(lib, fused_mlp._NARROW_F32_ARGTYPES, symbol)
        for d, splits, groups in ((D, 0, 3), (D, 17, 3), (D, 2, 0),
                                  (D, 2, 4), (48, 2, 3)):
            with pytest.raises(RuntimeError, match=f"{lib} launch failed"):
                fused_mlp._build.check(lib, fn(0, *ptrs, N, d, M, M, None, 1, splits,
                                               groups, stream))
        fused_mlp._build.check(lib, fn(0, *ptrs, N, D, M, 900, None, 1, 16, 3, stream))
        torch.cuda.synchronize()
        _close(out, fused_mlp._plain_mlp(x, w1, b1, w2, b2, 900), torch.float32)


# --- int8 products of few rows ---------------------------------------------------
@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("M", [1, 5, 16, 17])
def test_int_mm_padded_takes_few_rows_on_the_card(cuda, M, lead):
    """`torch._int_mm` on the card takes more than 16 rows; `int_mm_padded`
    pads a product's rows and equals the int32 product (`_plain_int_mm`, on
    the CPU: the card has no int32 matmul) exactly."""
    g = torch.Generator(device="cuda").manual_seed(M)
    a = torch.randint(-127, 128, (*lead, M, 36), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (*lead, 36, 20), generator=g, device="cuda",
                      dtype=torch.int8)
    got = quant.int_mm_padded(a, b)
    assert got.dtype == torch.int32 and got.shape == (*lead, M, 20)
    assert torch.equal(got.cpu(), quant._plain_int_mm(a.cpu(), b.cpu()))


# --- the wide bodies with the model axis: K1, K1b and K1c ---------------------
# (N, D, M, one width a model) at wide hidden sizes from 72 to 8,192: the
# stacked stretch members' B=1 rows (widths full, partial, 0), one model at
# B=8's, ViT-H's widths, D that 8 does not divide (bf16 padded), and the
# widest.
WIDE_AXIS_CASES = [(70, 72, 288, [288, 100]), (513, 768, 3072, [3072, 2072, 0, 3072, 1000]),
                   (4104, 768, 3072, [3072]), (130, 1280, 5120, [5120, 4120]),
                   (65, 1290, 5160, [5160, 3000]), (40, 8192, 2048, [2048, 1000]),
                   (33, 2048, 8192, [8192])]
WIDE_BODIES = {"seq": ("wide_wgmma", "wide_tf32x3"), "chunked": ("wide_wgmma", "wide_tf32x3"),
               "pipelined2": ("wide_wgmma_queue", "wide_tf32x3_queue")}


def _body_of(variant):
    return {"seq": fused_mlp.k1_body_launched, "chunked": fused_mlp.k1b_body_launched,
            "pipelined2": fused_mlp.k1c_body_launched}[variant]()


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,M,widths", WIDE_AXIS_CASES)
def test_wide_model_axis_matches_plain_and_each_model_alone(cuda, monkeypatch, variant,
                                                            dtype, N, D, M, widths):
    """The variant's wide body with a model axis of P = 1, 2 or 5 and one
    width a model on the device: one launch, on the variant's wide body,
    against its plain version (K1b's fc2 over 512-column chunks), and each
    model's slice equal, bit for bit, to that model alone with a host
    width."""
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
    P = len(widths)
    x = torch.randn(P, N, D, generator=cuda, device="cuda").to(dtype)
    w1, b1, w2, b2 = _mlp_weights(cuda, dtype, D, M, (P,))
    wt = torch.tensor(widths, dtype=torch.int32, device="cuda")
    before = getattr(fused_mlp, VARIANTS[variant])
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, wt)
    torch.cuda.synchronize()
    assert getattr(fused_mlp, VARIANTS[variant]) == before + 1
    assert _body_of(variant) == WIDE_BODIES[variant][dtype == torch.float32]
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, _plain_of(variant)(x, w1, b1, w2, b2, wt), dtype)
    for p in range(P):
        alone = fused_mlp.fused_mlp(x[p], w1[p], b1[p], w2[p], b2[p], widths[p])
        assert torch.equal(alone, out[p])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,M,widths", WIDE_AXIS_CASES)
def test_k1c_wide_equals_k1_where_k1_splits_no_k(cuda, monkeypatch, dtype, N, D, M, widths):
    """K1c's wide queue runs K1's tiles in K1's K order: where K1's plan
    splits no K (every bf16 call; f32 where the tiles fill the SMs) the two
    give the same bits."""
    P = len(widths)
    x = torch.randn(P, N, D, generator=cuda, device="cuda").to(dtype)
    w1, b1, w2, b2 = _mlp_weights(cuda, dtype, D, M, (P,))
    wt = torch.tensor(widths, dtype=torch.int32, device="cuda")
    k1 = fused_mlp.fused_mlp(x, w1, b1, w2, b2, wt)
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "pipelined2")
    k1c = fused_mlp.fused_mlp(x, w1, b1, w2, b2, wt)
    torch.cuda.synchronize()
    plan = fused_mlp.wide_f32_plan(N, fused_mlp.kernel_width(D, dtype), M,
                                   torch.cuda.get_device_properties(0).multi_processor_count)
    if dtype == torch.bfloat16 or max(plan["fc1"]["splits"], plan["fc2"]["splits"]) == 1:
        assert torch.equal(k1, k1c)
    else:
        _close(k1c, k1, dtype)


def _k1c_wide_entry(x, w1, b1, w2, b2, out, ready, widths, lead, blocks):
    """K1c's wide bf16 or f32 entry on (P, N, D) inputs whose rows are 16
    bytes (M a multiple of 8), h a scratch of its own; returns its error
    code."""
    P, N, D = x.shape
    M = w1.shape[-2]
    f32 = x.dtype == torch.float32
    h = torch.empty(P, N, M, dtype=x.dtype, device="cuda")
    fn = fused_mlp._build.entry("mlp_pipelined", fused_mlp._K1C_WIDE_ARGTYPES,
                                f"mlp_pipelined_wide{'_f32' if f32 else ''}_launch")
    return fn(x.device.index, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), M,
              b2.data_ptr(), h.data_ptr(), M, ready, out.data_ptr(), N, D, M, 0,
              widths.data_ptr(), P, lead, blocks, torch.cuda.current_stream().cuda_stream)


def test_k1c_wide_refuses_a_grid_the_card_cannot_hold(cuda):
    """K1c's wide entry refuses a grid it cannot run: no block, a block
    without a unit (more blocks than units), a lead of no group or past the
    groups, and a missing counter buffer.  More blocks than the card holds
    at once it takes (the tickets; `test_k1c_wide_grid_past_the_resident_
    blocks_ends`).  The wrapper's grid (`k1c_wide_plan`) is one block an SM
    at most."""
    N, D, M = 513, 768, 3072
    x, w1, b1, w2, b2 = (t.unsqueeze(0) for t in _wide_inputs(cuda, N, D, M, torch.bfloat16))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fused_mlp.k1c_wide_plan(N, D, M, 1, torch.bfloat16, sms)
    assert plan["blocks"] <= plan["resident"] == sms
    out = torch.empty_like(x)
    widths = torch.tensor([M], dtype=torch.int32, device="cuda")
    ready = torch.zeros(plan["groups"] + 1, dtype=torch.int32, device="cuda")
    for ptr, lead, blocks in ((ready.data_ptr(), plan["lead"], 0),
                              (ready.data_ptr(), plan["lead"], plan["units"] + 1),
                              (ready.data_ptr(), 0, plan["blocks"]),
                              (ready.data_ptr(), plan["groups"] + 1, plan["blocks"]),
                              (None, plan["lead"], plan["blocks"])):
        err = _k1c_wide_entry(x, w1, b1, w2, b2, out, ptr, widths, lead, blocks)
        with pytest.raises(RuntimeError, match="mlp_pipelined launch failed"):
            fused_mlp._build.check("mlp_pipelined", err)
    err = _k1c_wide_entry(x, w1, b1, w2, b2, out, ready.data_ptr(), widths, plan["lead"],
                          plan["blocks"])
    fused_mlp._build.check("mlp_pipelined", err)
    torch.cuda.synchronize()
    _close(out, fused_mlp._plain_mlp(x, w1, b1, w2, b2, widths), torch.bfloat16)


# K1c's wide queue at the cases it was redesigned on: the stacked stretch
# members at B=8's and B=1's rows (P = 5) and ViT-H's widths at B=8's (P =
# 2), widths full, partial and 0 as `chip_smoke.wide_case_widths` gives.
K1C_WIDE_CASES = [(4104, 768, 3072, [3072, 3072, 2072, 2072, 0]),
                  (513, 768, 3072, [3072, 3072, 2072, 2072, 0]),
                  (4104, 1280, 5120, [5120, 4120])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,M,widths", K1C_WIDE_CASES)
def test_k1c_wide_queue_gives_k1s_bits_alone_and_stacked(cuda, monkeypatch, dtype, N, D, M,
                                                         widths):
    """K1c's wide queue (tickets, a lead of several row tiles, TMA stores)
    changes the schedule only: the same bits as K1 where K1 splits no K
    (every bf16 case; f32 at 4,104 rows), within the gate of its plain
    version everywhere, and each model alone the same bits as its slice of
    the stacked call."""
    P = len(widths)
    x = torch.randn(P, N, D, generator=cuda, device="cuda").to(dtype)
    w1, b1, w2, b2 = _mlp_weights(cuda, dtype, D, M, (P,))
    wt = torch.tensor(widths, dtype=torch.int32, device="cuda")
    k1 = fused_mlp.fused_mlp(x, w1, b1, w2, b2, wt)
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "pipelined2")
    before = fused_mlp.launches_k1c
    k1c = fused_mlp.fused_mlp(x, w1, b1, w2, b2, wt)
    torch.cuda.synchronize()
    assert fused_mlp.launches_k1c == before + 1
    assert fused_mlp.k1c_body_launched() == WIDE_BODIES["pipelined2"][dtype == torch.float32]
    _close(k1c, fused_mlp._plain_mlp(x, w1, b1, w2, b2, wt), dtype)
    plan = fused_mlp.wide_f32_plan(N, D, M, torch.cuda.get_device_properties(0)
                                   .multi_processor_count)
    if dtype == torch.bfloat16 or max(plan["fc1"]["splits"], plan["fc2"]["splits"]) == 1:
        assert torch.equal(k1, k1c)
    for p in range(P):
        alone = fused_mlp.fused_mlp(x[p], w1[p], b1[p], w2[p], b2[p], widths[p])
        assert torch.equal(alone, k1c[p])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1c_wide_grid_past_the_resident_blocks_ends(cuda, dtype):
    """Tickets let K1c's wide queue run on more blocks than the card holds at
    once (a block that is not yet resident has taken no ticket, so nothing
    waits on it): a grid of twice the SMs and one of a single block end with
    the bits of the plan's grid, and a lead of one group gives them too."""
    N, D, M, widths = 4104, 768, 3072, [3072, 2072]
    P = len(widths)
    x = torch.randn(P, N, D, generator=cuda, device="cuda").to(dtype)
    w1, b1, w2, b2 = _mlp_weights(cuda, dtype, D, M, (P,))
    wt = torch.tensor(widths, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fused_mlp.k1c_wide_plan(N, D, M, P, dtype, sms)
    assert plan["units"] >= 2 * sms
    outs = []
    for lead, blocks in ((plan["lead"], plan["blocks"]), (plan["lead"], 2 * sms),
                         (plan["lead"], 1), (1, plan["blocks"])):
        out = torch.empty_like(x)
        ready = torch.zeros(plan["groups"] + 1, dtype=torch.int32, device="cuda")
        fused_mlp._build.check("mlp_pipelined", _k1c_wide_entry(
            x, w1, b1, w2, b2, out, ready.data_ptr(), wt, lead, blocks))
        torch.cuda.synchronize()
        assert int(ready[-1]) == plan["units"] + blocks  # every block drew one past the end
        outs.append(out)
    _close(outs[0], fused_mlp._plain_mlp(x, w1, b1, w2, b2, wt), dtype)
    for out in outs[1:]:
        assert torch.equal(out, outs[0])

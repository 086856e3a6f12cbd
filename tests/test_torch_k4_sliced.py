"""K4's sliced bodies (head_dim above 256) on the CPU: the wrapper's
mirror of their cluster plans, the views they copy for TMA, and their order
of computation emulated (f32 in f32 and in 3xTF32, bf16 in bf16) against
JAX's `_attention_kernel` in interpret mode and the port's plain version.

On the card (`csrc/attention.cu`, `attention_sliced_f32_kernel` and
`attention_sliced_wgmma_kernel`) the ceil(hd / 256) slices of a (volume,
head) are the ranks of one cluster: each rank computes the chunk's partial
scores over its own run of hd's boxes (32 columns in f32, 64 in bf16), the
ranks add the partials in rank order, and each runs one online softmax over
chunks of keys (32 in f32, 64 in bf16) and its slice's p v.  The emulations
take those steps in that order; the kernels themselves are held to the
plain version on the card (`tests/test_torch_kernels.py`, marked `gpu`).

    python -m pytest tests/test_torch_k4_sliced.py -q
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vit3d_ensemble_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from vit3d_ensemble_tpu_torch.ops import fused_attention

from test_torch_stretch import _k4_f32_inputs, _tf32

# The JAX package's f32 tolerance for its attention kernel
# (`tests/test_ops.py:31`).
TOL = dict(atol=2e-5, rtol=1e-4)
KEYS = 32  # keys a chunk of the f32 body
BF16_KEYS = 64  # keys a chunk of the bf16 body (`SB_KEYS`)
# K4's bf16 gate on the card (`chip_smoke.K4_BF16_TOL`), on a context of
# root mean square 1
BF16_GATE = dict(atol=0.02, rtol=0.02)


def _f32_product(a, b):
    return a @ b


def _tf32x3_product(a, b):
    """a @ b as the body's wgmmas take it: each operand split into TF32 hi
    and lo, lo_a hi_b + hi_a lo_b (the small terms) and hi_a hi_b, f32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated_sliced(q, k, v, product):
    """K4's sliced f32 function in the body's order, both products by
    `product`: for each chunk of 32 keys every rank's partial scores, box
    by box over its boxes of `k4_sliced_split`, added in rank order;
    keys past S masked after the sum; the online softmax in base 2 with
    the scale folded in; each slice's p v added to its rescaled context;
    the context divided by the row sums once."""
    hd, S = q.shape[-1], q.shape[-2]
    split = fused_attention.k4_sliced_split(hd)
    box = fused_attention.K4_SLICED_BOX[torch.float32]
    scale_log2 = torch.tensor(math.log2(math.e) / math.sqrt(hd), dtype=torch.float32)
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros(q.shape[:-1] + (1,))
    ctx = torch.zeros_like(q)
    for key0 in range(0, S, KEYS):
        kc, vc = k[..., key0:key0 + KEYS, :], v[..., key0:key0 + KEYS, :]
        scores = None
        for b0, b1 in split["boxes"]:  # rank order
            part = None
            for x in range(b0, b1):
                cols = slice(box * x, box * (x + 1))
                s_box = product(q[..., cols], kc[..., cols].transpose(-1, -2))
                part = s_box if part is None else part + s_box
            scores = part if scores is None else scores + part
        nxt = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        corr = torch.exp2((m - nxt) * scale_log2)
        p = torch.exp2(scores * scale_log2 - nxt * scale_log2)
        m, l = nxt, l * corr + p.sum(dim=-1, keepdim=True)
        for c0 in range(0, hd, fused_attention.K4_SLICE):  # each slice's columns
            cols = slice(c0, c0 + fused_attention.K4_SLICE)
            ctx[..., cols] = ctx[..., cols] * corr + product(p, vc[..., cols])
    return ctx / l


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [257, 264, 512, 1000, 1024, 2049])
def test_sliced_f32_split_gives_every_box_to_one_rank(hd, dtype):
    """The wrapper's mirror of each sliced body's plan: ceil(hd / 256)
    slices, one a rank of a cluster of at most 8 (in as few groups as that
    allows, as even as they divide), and each group's ranks splitting hd's
    boxes (32 columns in f32, 64 in bf16) into contiguous runs that differ
    by at most one box and take every box exactly once.  Up to hd 2,048 a
    run is at most a slice's boxes: 8 in f32, and in bf16 4, the q boxes a
    rank keeps for the whole key walk."""
    split = fused_attention.k4_sliced_split(hd, dtype)
    slices = fused_attention.k4_slices(hd)
    cluster, groups = split["cluster"], split["groups"]
    assert cluster <= fused_attention.K4_MAX_CLUSTER
    assert groups == -(-slices // fused_attention.K4_MAX_CLUSTER)
    assert slices <= cluster * groups < slices + groups
    box = fused_attention.K4_SLICED_BOX[dtype]
    assert split["nbox"] == -(-hd // box)
    boxes = [x for b0, b1 in split["boxes"] for x in range(b0, b1)]
    assert boxes == list(range(split["nbox"]))
    sizes = [b1 - b0 for b0, b1 in split["boxes"]]
    assert len(sizes) == cluster and max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    if hd <= 2048:  # one group: each rank at most a slice's boxes
        assert groups == 1 and cluster == slices
        assert max(sizes) <= fused_attention.K4_SLICE // box
        if dtype == torch.bfloat16:
            assert max(sizes) <= fused_attention.K4_BF16_RUN


def test_sliced_f32_split_at_the_documented_head_dims():
    """hd 264: 9 boxes, 4 + 5; 512: 8 + 8; 1,024: four ranks of 8."""
    split = fused_attention.k4_sliced_split
    assert split(264)["boxes"] == [(0, 4), (4, 9)]
    assert split(512)["boxes"] == [(0, 8), (8, 16)]
    assert split(1024)["boxes"] == [(0, 8), (8, 16), (16, 24), (24, 32)]


def test_sliced_bf16_split_at_the_documented_head_dims():
    """bf16, boxes of 64 columns: hd 264, 5 boxes, 2 + 3; 512: 4 + 4; 1,024:
    four ranks of 4; 2,049: two groups of five ranks, runs of 6 and 7 (q
    boxes reloaded every chunk)."""
    def split(hd):
        return fused_attention.k4_sliced_split(hd, torch.bfloat16)
    assert split(264)["boxes"] == [(0, 2), (2, 5)]
    assert split(512)["boxes"] == [(0, 4), (4, 8)]
    assert split(1024)["boxes"] == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert (split(2049)["cluster"], split(2049)["groups"]) == (5, 2)
    assert [b1 - b0 for b0, b1 in split(2049)["boxes"]] == [6, 7, 6, 7, 7]


@pytest.mark.parametrize("hd", [264, 512])
def test_sliced_f32_order_matches_jax_and_plain(hd):
    """The body's order in f32 against JAX's `_attention_kernel` in
    interpret mode at the f32 tolerance, against the exact (f64) context
    within 1e-6 + 1e-5 |ref|, and against the plain version within 1e-5:
    the plain version's own f32 sums lie up to 4.1e-6 from the exact
    context here (a context of root mean square 1), the body's order 1.7e-6.
    The same order in 3xTF32 (the operand splits of the wgmmas) against JAX
    at the f32 tolerance.  One volume, two heads, S = 65 (a last chunk of
    one key)."""
    q, k, v = _k4_f32_inputs((1, 2, 65, hd), 27)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_fused_attention(*(jnp.asarray(a) for a in (q, k, v))))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    f32 = _emulated_sliced(*args, _f32_product)
    np.testing.assert_allclose(f32.numpy(), ref, **TOL)
    torch.testing.assert_close(f32, fused_attention._plain_attention_k4(*args), atol=1e-5,
                               rtol=0)
    q64, k64, v64 = (a.double() for a in args)
    exact = torch.softmax(q64 @ k64.transpose(-1, -2) / math.sqrt(hd), dim=-1) @ v64
    torch.testing.assert_close(f32.double(), exact, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_emulated_sliced(*args, _tf32x3_product).numpy(), ref, **TOL)


@pytest.mark.parametrize("hd,copied", [(257, True), (512, False)])
def test_sliced_f32_views_tma_cannot_read_are_copied(hd, copied):
    """Above head_dim 256 TMA feeds the f32 body too: a view whose rows are
    not a multiple of 16 bytes apart is copied into rows of a multiple of 4
    floats, the values unchanged; one that is is launched as it lies."""
    q, k, v = (torch.from_numpy(a) for a in _k4_f32_inputs((1, 2, 65, hd), 3))
    views = fused_attention._k4_views(q, k, v)
    assert all(fused_attention._tma_rows(t) for t in views)
    assert all(t is a for t, a in zip(views, (q, k, v))) == (not copied)
    assert all(torch.equal(t, a) for t, a in zip(views, (q, k, v)))
    if copied:
        assert views[0].stride(-2) == 260


def _emulated_sliced_bf16(q, k, v):
    """K4's sliced bf16 function in the body's order, on bf16 inputs: for
    each chunk of 64 keys every rank's partial scores over its run of
    `k4_sliced_split`'s 64-column boxes in f32, added in rank order; keys
    past S masked after the sum; the online softmax in base 2 with the
    scale folded in; p = exp(s - max) rounded to bf16 unnormalised, its f32
    sum kept; p v summed in f32 into the rescaled context of each slice;
    one division by the row sums, then one rounding to bf16."""
    hd, S = q.shape[-1], q.shape[-2]
    split = fused_attention.k4_sliced_split(hd, torch.bfloat16)
    box = fused_attention.K4_SLICED_BOX[torch.bfloat16]
    q, k, v = (t.float() for t in (q, k, v))
    scale_log2 = torch.tensor(math.log2(math.e) / math.sqrt(hd), dtype=torch.float32)
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros(q.shape[:-1] + (1,))
    ctx = torch.zeros_like(q)
    for key0 in range(0, S, BF16_KEYS):
        kc, vc = k[..., key0:key0 + BF16_KEYS, :], v[..., key0:key0 + BF16_KEYS, :]
        scores = None
        for b0, b1 in split["boxes"]:  # rank order
            cols = slice(box * b0, box * b1)
            part = q[..., cols] @ kc[..., cols].transpose(-1, -2)
            scores = part if scores is None else scores + part
        nxt = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        corr = torch.exp2((m - nxt) * scale_log2)
        p = torch.exp2(scores * scale_log2 - nxt * scale_log2)
        m, l = nxt, l * corr + p.sum(dim=-1, keepdim=True)
        pb = p.bfloat16().float()
        for c0 in range(0, hd, fused_attention.K4_SLICE):  # each slice's columns
            cols = slice(c0, c0 + fused_attention.K4_SLICE)
            ctx[..., cols] = ctx[..., cols] * corr + pb @ vc[..., cols]
    return (ctx / l).bfloat16()


@pytest.mark.parametrize("hd", [264, 512])
def test_sliced_bf16_order_matches_jax_and_plain(hd):
    """The bf16 body's order against JAX's `_attention_kernel` in interpret
    mode in bf16 within the JAX package's bf16 tolerance (JAX rounds the
    normalised probabilities, the port the unnormalised ones), and against
    the plain version within the card's bf16 gate.  One volume, two heads,
    S = 65 (a last chunk of one key), a context of root mean square 1."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _k4_f32_inputs((1, 2, 65, hd), 28))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_attention(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                                    for t in (q, k, v)))
    ref = np.asarray(ref.astype(jnp.float32))
    out = _emulated_sliced_bf16(q, k, v)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.05, rtol=0.05)
    torch.testing.assert_close(out.float(),
                               fused_attention._plain_attention_k4(q, k, v).float(), **BF16_GATE)

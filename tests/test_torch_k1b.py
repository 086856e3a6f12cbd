"""K1b's bodies (`csrc/mlp_chunked.cu`) on the CPU: the f32 body's 3xTF32
arithmetic (`chunked_tf32x3_kernel`) and the bf16 body's sums
(`chunked_wgmma_kernel`, `csrc/mlp_pipeline.cuh`) emulated against JAX's
`_chunked_mlp_kernel`, the f32 one also against the exact (f64) MLP, and
their grids (`k1b_f32_plan`; `k1c_plan` at K1b's bf16 use).

The emulation takes each operand split into TF32 hi and lo to the bit, as
the body splits it (`tests/test_torch_stretch.py:_tf32`), each k-step of 8
as three products into two accumulators rounded toward zero to f32 (a mild
model of the tensor cores' truncation, `_k1_tf32x3` there): fc1 in the
body's k order over all of D in one interval; fc2 promoted every 128 of K
into a 512-column chunk's partial, the chunks added in order.  The JAX
Pallas kernel runs in interpret mode, as the JAX package's own tests run it,
with its variant set to "chunked" for the test alone.  The CUDA body itself
is held to these on the card (`tests/test_torch_kernels.py`).

The bf16 emulation takes h = x w1^T + b1 in f32 (the tensor cores' f32 sum
of exact bf16 products), the polynomial GELU (`fused_mlp.poly_gelu`), the
width mask and h rounded to bf16 (the TPU kernel's rounding point); then
fc2 of each 512-column chunk in f32, stage by stage (64 hidden columns a
stage, added in order into an accumulator that starts from zero at the
chunk's first stage), the chunks added in order into an f32 sum, + b2,
rounded to bf16 once.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from test_torch_stretch import _f64_mlp, _k1_tf32x3, _mlp_data, _tf32x1
from vit3d_ensemble_tpu.ops import pallas_mlp
from vit3d_ensemble_tpu_torch.ops import fused_mlp

F32_TOL = dict(atol=2e-5, rtol=1e-4)   # the JAX package's f32 tolerance
BF16_TOL = dict(atol=0.05, rtol=0.05)  # its bf16 tolerance (test_pallas_mlp.py:47)
STAGE = 64                             # hidden columns of a pipeline stage
PIPELINE_TILE_ROWS = 128               # token rows of its row tile (`W_ROWS`)
SMS = 132                              # an H100's SMs: one block each


def _fc1_order(D):
    """fc1's k order in the body: within each 16 of D, k-step 2s takes d =
    16s + 4t and 16s + 4t + 1 (t < 4), k-step 2s + 1 takes d + 2 and + 3,
    so that one 16-byte read of a w1 row serves both; at D = 8 one k-step."""
    if D == 8:
        return list(range(8))
    return [16 * s + 4 * t + pair + e for s in range(D // 16)
            for pair in (0, 2) for e in (0, 1) for t in range(4)]


def _tf32x1_fc(a, b, promote_k):
    return _tf32x1(a, b.T)


def _k1b_f32(x, w1, b1, w2, b2, active, product=_k1_tf32x3):
    """K1b's f32 function (nn.Linear layout) with both products taken by
    `product(a, b, promote_k)` = a @ b^T as the body takes them: h =
    gelu(x w1^T + b1) with exact erf, fc1 over all of D in the body's k
    order, columns at or past `active` zeroed; then fc2's partial of each
    `_CHUNK_M`-column chunk, promoted every `WIDE_F32_PROMOTE_K` of K, the
    chunks added in order, + b2."""
    order = _fc1_order(x.shape[-1])
    h = F.gelu(product(x[:, order], w1[:, order], x.shape[-1]) + b1)
    h[:, active:] = 0
    acc = torch.zeros(x.shape[0], w2.shape[0])
    for c in range(0, h.shape[-1], fused_mlp._CHUNK_M):
        acc = acc + product(h[:, c:c + fused_mlp._CHUNK_M],
                            w2[:, c:c + fused_mlp._CHUNK_M],
                            fused_mlp.WIDE_F32_PROMOTE_K)
    return acc + b2


def _inputs(N, D, M, x_scale=1.0):
    """numpy in JAX's layout, and the port's tensors (nn.Linear layout)."""
    x, w1, b1, w2, b2 = _mlp_data(13, N, D, M)
    x = x * np.float32(x_scale)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (x, w1, b1, w2, b2), (t(x), t(w1.T), t(b1), t(w2.T), t(b2))


_JAX = {}


def _jax_chunked(monkeypatch, N, D, M, active, arrays=None):
    """JAX's `_chunked_mlp_kernel` in interpret mode on `_inputs` (or on
    `arrays`, numpy in JAX's layout, whose type it keeps), as f32 numpy;
    `_inputs`' results kept a shape, so each D compiles once."""
    key = (N, D, M, active)
    if arrays is not None or key not in _JAX:
        own = arrays is None
        arrays = _inputs(N, D, M)[0] if own else arrays
        monkeypatch.setattr(pallas_mlp, "_MLP_VARIANT", "chunked")
        with pltpu.force_tpu_interpret_mode():
            out = np.asarray(pallas_mlp.fused_mlp(
                *(jnp.asarray(a) for a in arrays), active).astype(jnp.float32))
        if not own:
            return out
        _JAX[key] = out
    return _JAX[key]


def test_fc1_order_is_a_permutation_of_each_16():
    for D in fused_mlp.WIDTHS:
        order = _fc1_order(D)
        assert sorted(order) == list(range(D))
        # each k-step of 8 takes columns of one 16 of D
        assert all(len({d // 16 for d in order[k:k + 8]}) == 1
                   for k in range(0, D, 8))


# M = 1,100 masked to 1,030: two whole 512-column chunks and a partial one,
# whose last 64-column sub-chunk is cut by the mask; N < 128: one unit.
@pytest.mark.parametrize("D", [8, 16, 64])
def test_k1b_tf32x3_emulation_matches_jax_chunked_kernel(monkeypatch, D):
    N, M, active = 70, 1100, 1030
    ref = _jax_chunked(monkeypatch, N, D, M, active)
    _, args = _inputs(N, D, M)
    np.testing.assert_allclose(_k1b_f32(*args, active).numpy(), ref, **F32_TOL)


def test_one_tf32_product_misses_the_jax_tolerance_in_k1b(monkeypatch):
    """The same function with one TF32 product a product fails the JAX
    tolerance: it tells 3xTF32 from TF32."""
    N, D, M, active = 70, 64, 1100, 1030
    ref = _jax_chunked(monkeypatch, N, D, M, active)
    _, args = _inputs(N, D, M)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(
            _k1b_f32(*args, active, product=_tf32x1_fc).numpy(), ref, **F32_TOL)


def test_k1b_tf32x3_with_x_four_times_larger():
    """x four times larger at the model axis's widths (D = 64, M = 3,072),
    where the truncation inside the tensor cores weighs most: the emulated
    body holds the f32 tolerance against the exact (f64) MLP."""
    _, args = _inputs(40, 64, 3072, x_scale=4.0)
    np.testing.assert_allclose(_k1b_f32(*args, 3072).numpy(),
                               _f64_mlp(*args, 3072).numpy(), **F32_TOL)


# (token rows a model, models): the model axis at the sweep's evaluation
# shape, the serving shape, one row, a tile's rows and one more, the card
# tests' partial row tile, and rows the tile divides.
@pytest.mark.parametrize("n,models", [(1560, 30), (33280, 1), (200, 3), (1, 1),
                                      (128, 1), (129, 2), (300, 3), (1000, 7),
                                      (40000, 1), (512, 4)])
def test_k1b_f32_plan_covers_every_unit_once(n, models):
    """Every (model, token row) falls in exactly one block of the grid, and
    every block takes one unit: a row tile of at least one row."""
    plan = fused_mlp.k1b_f32_plan(n, models)
    rows = plan["tile_rows"]
    tiles, grid_models = plan["grid"]
    assert grid_models == models and plan["units"] == tiles * models
    taken = np.zeros((models, n), dtype=np.int64)
    for bx in range(tiles):
        lo, hi = bx * rows, min(n, (bx + 1) * rows)
        assert hi > lo
        taken[:, lo:hi] += 1
    assert (taken == 1).all()


# --- the bf16 body: K1c's pipeline with fc2 summed chunk by chunk ---------


def _k1b_bf16(x, w1, b1, w2, b2, active):
    """The bf16 body's sums (nn.Linear layout, bf16 tensors) in f32, as the
    module note says, rounded to bf16 once."""
    xf, w1f, b1f, w2f, b2f = (t.float() for t in (x, w1, b1, w2, b2))
    h = fused_mlp.poly_gelu(xf @ w1f.T + b1f)
    h[:, active:] = 0
    h = h.bfloat16().float()
    acc = torch.zeros(x.shape[0], w2.shape[0])
    for c in range(0, h.shape[-1], fused_mlp._CHUNK_M):
        part = torch.zeros_like(acc)
        for s in range(c, min(c + fused_mlp._CHUNK_M, h.shape[-1]), STAGE):
            part = part + h[:, s:s + STAGE] @ w2f[:, s:s + STAGE].T
        acc = acc + part
    return (acc + b2f).bfloat16()


def _bf16_inputs(seed, N, D, M):
    """numpy in JAX's layout and the port's tensors (nn.Linear layout), both
    of bf16 values: the port's rounded from `_mlp_data`, JAX's the same
    values as f32 arrays cast to bf16 in JAX."""
    x, w1, b1, w2, b2 = _mlp_data(seed, N, D, M)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).bfloat16()  # noqa: E731
    port = (t(x), t(w1.T), t(b1), t(w2.T), t(b2))
    jax_arrays = tuple(a.float().numpy() for a in
                       (port[0], port[1].T, port[2], port[3].T, port[4]))
    return tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in jax_arrays), port


# 200 rows: a ragged last 128-row tile.  M = 1,100 masked at 1,030: two whole
# 512-column chunks and a partial one, its last stage cut by the mask; M =
# 3,072 masked at 2,072: four whole chunks and one of a single partial stage,
# the last chunk wholly past the mask never loaded.
@pytest.mark.parametrize("M,active", [(1100, 1030), (3072, 2072)])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_k1b_bf16_emulation_matches_jax_chunked_kernel(monkeypatch, D, M, active):
    N = 200
    arrays, args = _bf16_inputs(17, N, D, M)
    ref = _jax_chunked(monkeypatch, N, D, M, active, arrays)
    out = _k1b_bf16(*args, active)
    np.testing.assert_allclose(out.float().numpy(), ref, **BF16_TOL)
    # the wrapper's plain version on the CPU (`_plain_mlp_chunked`) too
    with torch.no_grad():
        monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "chunked")
        plain = fused_mlp.fused_mlp(*args, active)
    assert plain.dtype == torch.bfloat16
    np.testing.assert_allclose(plain.float().numpy(), ref, **BF16_TOL)


def test_k1b_bf16_emulation_with_three_models(monkeypatch):
    """Three stacked models with widths 0, 1,030 and M = 1,100, 200 rows
    each: each model's emulated sums against JAX's kernel on that model
    alone (a width of 0 gives b2 exactly), and the wrapper's plain version
    with the widths as one tensor against the same."""
    N, D, M, widths = 200, 32, 1100, (0, 1030, 1100)
    data = [_bf16_inputs(30 + p, N, D, M) for p in range(len(widths))]
    stacked = [torch.stack([port[i] for _, port in data]) for i in range(5)]
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", "chunked")
    with torch.no_grad():
        plain = fused_mlp.fused_mlp(*stacked, torch.tensor(widths, dtype=torch.int32))
    for p, ((arrays, port), width) in enumerate(zip(data, widths)):
        ref = _jax_chunked(monkeypatch, N, D, M, width, arrays)
        out = _k1b_bf16(*port, width)
        np.testing.assert_allclose(out.float().numpy(), ref, **BF16_TOL)
        np.testing.assert_allclose(plain[p].float().numpy(), ref, **BF16_TOL)
    assert torch.equal(_k1b_bf16(*data[0][1], 0), data[0][1][4].expand(N, D))


def test_k1b_routes_each_call_to_one_body():
    """K1b's body by type and hidden size: bf16 at D 9-64 (run at 16, 32 or
    64) on the `wgmma` pipeline, at D <= 8 on its D = 8 instance (the hidden
    columns split across a cluster), f32 at D <= 64 on the 3xTF32 body, and
    the wide bodies above 64."""
    for D in (9, 16, 24, 32, 48, 64):
        assert fused_mlp._variant_body("chunked", torch.bfloat16, D) == "chunked_wgmma"
    for D in (1, 8):
        assert fused_mlp._variant_body("chunked", torch.bfloat16, D) == "chunked_wgmma_d8"
    for D in (8, 64):
        assert fused_mlp._variant_body("chunked", torch.float32, D) == "tf32x3_mma_sync"
    assert fused_mlp._variant_body("chunked", torch.bfloat16, 768) == "wide_wgmma"
    assert fused_mlp._variant_body("chunked", torch.float32, 768) == "wide_tf32x3"
    assert set(fused_mlp.K1B_BODIES) == {"chunked_wgmma", "chunked_wgmma_d8",
                                         "tf32x3_mma_sync", "wide_wgmma", "wide_tf32x3"}


# (token rows a model, models): the serving shape, the sweep's evaluation
# shape at P = 30, a ragged last row tile, fewer row tiles than blocks, one
# row, and many small models.
@pytest.mark.parametrize("n,models", [(33280, 1), (520, 1), (1, 1), (1560, 3),
                                      (200, 3), (1560, 30), (65, 30), (4160, 30)])
def test_k1c_plan_at_k1b_bf16_use_covers_every_row_tile_once(n, models):
    """`k1c_plan` as K1b's bf16 calls take it (128-row tiles, one block an
    SM of an H100): every (model, row tile) falls in exactly one block, no
    block goes without a tile, the blocks' tiles differ by at most one, and
    the grid exceeds the resident blocks only where the models outnumber
    them."""
    plan = fused_mlp.k1c_plan(n, models, PIPELINE_TILE_ROWS, SMS)
    tiles, per_model = plan["tiles_a_model"], plan["blocks_a_model"]
    assert tiles == -(-n // PIPELINE_TILE_ROWS) and plan["blocks"] == per_model * models
    assert plan["blocks"] <= max(SMS, models)
    taken = np.zeros((models, tiles), dtype=np.int64)
    counts = []
    for p in range(models):
        for b in range(per_model):
            first, last = b * tiles // per_model, (b + 1) * tiles // per_model
            assert last > first
            taken[p, first:last] += 1
            counts.append(last - first)
    assert (taken == 1).all()
    assert max(counts) - min(counts) <= 1
    assert (max(counts), min(counts)) == (plan["most_tiles_a_block"],
                                          plan["fewest_tiles_a_block"])


# --- the bf16 body at D <= 8: the pipeline's D = 8 instance ---------------
#
# K1, K1b and K1c in bf16 at D <= 8 run one body (`csrc/mlp_pipeline.cuh`
# at D = 8) with the hidden columns split across the blocks of a cluster,
# on the grid `k1_d8_plan` lays out.  Its sums are emulated below in its
# order and held, with the wrapper's plain versions, to JAX's three kernels
# in interpret mode at conf 22's FFN.

#: The clusters of s = 1 .. 16 blocks of the D = 8 body that an NVIDIA H100
#: 80GB HBM3 holds at once (`fused_mlp.k1_d8_clusters` on the card, as
#: `chip_smoke.py`'s build phase prints them): the plan's one-wave rule.
H100_D8_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)
CONF22_M = 2204                        # conf 22's mlp_dim (`configs.py`)
D8_ROWS = (8 * 257, 512 * 257)         # conf 22 at B = 8 and 512


def _d8_plan(n, M, chunked, models=1):
    return fused_mlp.k1_d8_plan(n, M, models, H100_D8_CLUSTERS, chunked)


# (token rows, K1b, splits): at M = 2,204 (35 stages, 5 summation chunks)
# the most splits whose clusters, one a row tile, fit an H100 in one wave;
# K1b at most its 5 chunks; one split from 129 row tiles up.
@pytest.mark.parametrize("n,chunked,splits", [
    (1, False, 16), (257, False, 16), (1028, False, 9), (D8_ROWS[0], False, 6),
    (4112, False, 3), (8224, False, 2), (16448, False, 1), (D8_ROWS[1], False, 1),
    (1, True, 5), (D8_ROWS[0], True, 5), (4112, True, 3), (8224, True, 2),
    (D8_ROWS[1], True, 1)])
def test_k1_d8_plan_splits_by_rows_and_width(n, chunked, splits):
    """The splits depend on the rows and M alone: one and five stacked
    models split alike; with more than one split each row tile is a
    cluster's, the clusters fit the card at once and the blocks a model stay
    within the SMs times the splits; with one split the grid is
    `k1c_plan`'s."""
    plan = _d8_plan(n, CONF22_M, chunked)
    assert plan["splits"] == splits
    stacked = _d8_plan(n, CONF22_M, chunked, models=5)
    assert (stacked["splits"], stacked["bounds"]) == (plan["splits"], plan["bounds"])
    assert stacked["blocks"] == 5 * stacked["blocks_a_model"]
    tiles = -(-n // PIPELINE_TILE_ROWS)
    assert plan["tiles"] == tiles
    assert plan["blocks_a_model"] <= SMS * plan["splits"]
    if splits > 1:
        assert stacked["groups"] == plan["groups"] == tiles <= H100_D8_CLUSTERS[splits - 1]
        if splits < len(H100_D8_CLUSTERS):
            assert (tiles > H100_D8_CLUSTERS[splits] or splits == (5 if chunked else 16))
    else:
        for p in (plan, stacked):
            assert p["groups"] == fused_mlp.k1c_plan(
                n, p["models"], PIPELINE_TILE_ROWS, SMS)["blocks_a_model"]


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("M", [2204, 2048, 3072, 1100, 512, 130, 64, 1])
def test_k1_d8_plan_bounds_cover_the_hidden_columns(M, chunked):
    """The splits' hidden columns run from 0 to M in order, none empty,
    each at least `D8_MIN_SPLIT_STAGES` stages but the last (K1b: whole
    512-column chunks, each starting on a chunk boundary), at every row
    count from one tile to the card's one-split regime."""
    for n in (1, 257, D8_ROWS[0], 4112, D8_ROWS[1]):
        plan = _d8_plan(n, M, chunked)
        bounds = plan["bounds"]
        assert len(bounds) == plan["splits"] <= fused_mlp.D8_MAX_SPLITS
        assert bounds[0][0] == 0 and bounds[-1][1] == M
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(c1 > c0 for c0, c1 in bounds)
        for c0, c1 in bounds:
            if chunked:
                assert c0 % fused_mlp._CHUNK_M == 0
            elif c1 < M:
                assert c1 - c0 >= fused_mlp.D8_MIN_SPLIT_STAGES * STAGE


def _d8_sums(x, w1, b1, w2, b2, active, chunked):
    """The D = 8 body's sums (nn.Linear layout, bf16 tensors) in f32, in its
    order: h as `_k1b_bf16` takes it; for each split of `k1_d8_plan` (an
    H100's clusters), fc2 over the split's stages one after the other into
    one accumulator (K1b: restarted at each 512-column chunk, the chunks
    added into the split's running sum); the splits' partials added in rank
    order from 0, + b2, rounded to bf16 once."""
    plan = _d8_plan(x.shape[0], w1.shape[0], chunked)
    xf, w1f, b1f, w2f, b2f = (t.float() for t in (x, w1, b1, w2, b2))
    h = fused_mlp.poly_gelu(xf @ w1f.T + b1f)
    h[:, active:] = 0
    h = h.bfloat16().float()
    total = torch.zeros(x.shape[0], w2.shape[0])
    for c0, c1 in plan["bounds"]:
        part = torch.zeros_like(total)
        acc = torch.zeros_like(total)
        for s in range(c0, c1, STAGE):
            if chunked and s > c0 and s % fused_mlp._CHUNK_M == 0:
                part, acc = part + acc, torch.zeros_like(total)
            acc = acc + h[:, s:s + STAGE] @ w2f[:, s:s + STAGE].T
        total = total + (part + acc)
    return (total + b2f).bfloat16()


def _jax_variant(monkeypatch, variant, active, arrays):
    """JAX's kernel of `variant` ("seq", "chunked", "pipelined2") in
    interpret mode on numpy arrays in its layout, as f32 numpy."""
    monkeypatch.setattr(pallas_mlp, "_MLP_VARIANT", variant)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pallas_mlp.fused_mlp(
            *(jnp.asarray(a) for a in arrays), active).astype(jnp.float32))


# conf 22's FFN (D 8, M 2,204) and D 3, which the wrapper runs at 8
# zero-padded; full width and a width that ends inside a stage; 65 rows (one
# row tile, the plan's most splits).
@pytest.mark.parametrize("active", [CONF22_M, 2000])
@pytest.mark.parametrize("D", [8, 3])
@pytest.mark.parametrize("variant", ["seq", "chunked", "pipelined2"])
def test_d8_bf16_matches_jax_kernels(monkeypatch, variant, D, active):
    """K1's, K1b's and K1c's bf16 function at D <= 8: the wrapper's plain
    version on the CPU and the body's split sums emulated in its order, each
    against JAX's kernel of the variant within the bf16 gate."""
    N = 65
    arrays, args = _bf16_inputs(23 + D, N, D, CONF22_M)
    ref = _jax_variant(monkeypatch, variant, active, arrays)
    monkeypatch.setattr(fused_mlp, "_MLP_VARIANT", variant)
    with torch.no_grad():
        plain = fused_mlp.fused_mlp(*args, active)
    assert plain.dtype == torch.bfloat16 and plain.shape == (N, D)
    np.testing.assert_allclose(plain.float().numpy(), ref, **BF16_TOL)
    padded = fused_mlp.kernel_operands(*args)
    assert padded[0].shape == (N, 8)
    emulated = _d8_sums(*padded, active, variant == "chunked")[:, :D]
    np.testing.assert_allclose(emulated.float().numpy(), ref, **BF16_TOL)

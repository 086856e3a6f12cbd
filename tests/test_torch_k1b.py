"""K1b's f32 body (`chunked_tf32x3_kernel`, `csrc/mlp_chunked.cu`) on the
CPU: its 3xTF32 arithmetic emulated against JAX's `_chunked_mlp_kernel`
and against the exact (f64) MLP, and its grid plan (`k1b_f32_plan`).

The emulation takes each operand split into TF32 hi and lo to the bit, as
the body splits it (`tests/test_torch_stretch.py:_tf32`), each k-step of 8
as three products into two accumulators rounded toward zero to f32 (a mild
model of the tensor cores' truncation, `_k1_tf32x3` there): fc1 in the
body's k order over all of D in one interval; fc2 promoted every 128 of K
into a 512-column chunk's partial, the chunks added in order.  The JAX
Pallas kernel runs in interpret mode, as the JAX package's own tests run it,
with its variant set to "chunked" for the test alone.  The CUDA body itself
is held to these on the card (`tests/test_torch_kernels.py`).
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


def _jax_chunked(monkeypatch, N, D, M, active):
    """JAX's `_chunked_mlp_kernel` in interpret mode on `_inputs`, kept a
    shape, so each D compiles once."""
    key = (N, D, M, active)
    if key not in _JAX:
        arrays, _ = _inputs(N, D, M)
        monkeypatch.setattr(pallas_mlp, "_MLP_VARIANT", "chunked")
        with pltpu.force_tpu_interpret_mode():
            _JAX[key] = np.asarray(pallas_mlp.fused_mlp(
                *(jnp.asarray(a) for a in arrays), active))
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

"""K1's and K1c's narrow f32 body (`narrow_tf32x3_kernel`,
`csrc/mlp_narrow_f32.cuh`) on the CPU: its grid plan (`k1_narrow_f32_plan`)
and its arithmetic, emulated in the body's split-and-reduce order, against
JAX's `_mlp_kernel` and against the exact (f64) MLP.

The emulation takes each operand split into TF32 hi and lo to the bit, as
the body splits it, each k-step of 8 as three products into two
accumulators rounded toward zero to f32 (`test_torch_stretch._k1_tf32x3`, a
mild model of the tensor cores' truncation): fc1 over all of D in one
interval, then for each split of the plan its chunks' fc2 promoted every
chunk of 32 hidden columns, and the splits' partial sums added in rank
order from 0, then b2.  The JAX Pallas kernel runs in interpret
mode, as the JAX package's own tests run it.  The CUDA body itself is held
to the plain version on the card (`tests/test_torch_kernels.py`).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from test_torch_stretch import _f64_mlp, _k1_tf32x3, _mlp_data, _tf32x1
from vit3d_ensemble_tpu.ops.pallas_mlp import fused_mlp as jax_fused_mlp
from vit3d_ensemble_tpu_torch.ops import fused_mlp

F32_TOL = dict(atol=2e-5, rtol=1e-4)   # the JAX package's f32 tolerance
SMS = 132                              # an H100's SMs


def _tf32x1_fc(a, b, promote_k):
    return _tf32x1(a, b.T)


def _narrow_f32(x, w1, b1, w2, b2, active, product=_k1_tf32x3):
    """The narrow body's function (nn.Linear layout) in its order: for each
    row tile and split of `k1_narrow_f32_plan`, h = gelu(x w1^T + b1) over
    the split's live chunks (exact erf, columns at or past `active` zeroed),
    fc2's partial promoted every chunk; the splits' partials summed in rank
    order from 0, + b2."""
    N, D = x.shape
    M = w1.shape[0]
    plan = fused_mlp.k1_narrow_f32_plan(N, D, M, active, 1, SMS)
    splits, ch, rows = plan["splits"], plan["chunk"], plan["tile_rows"]
    promote = fused_mlp.NARROW_F32_CHUNK
    out = torch.zeros(N, D)
    for r0 in range(0, N, rows):
        xt = x[r0:r0 + rows]
        total = torch.zeros(xt.shape[0], D)
        for s in range(splits):
            c0 = s * plan["chunks"] // splits * ch
            c1 = min((s + 1) * plan["chunks"] // splits * ch, -(-active // ch) * ch)
            part = torch.zeros(xt.shape[0], D)
            if c1 > c0:
                h = F.gelu(product(xt, w1[c0:c1], D) + b1[c0:c1])
                h[:, max(active - c0, 0):] = 0
                part = product(h, w2[:, c0:c1], promote)
            total = total + part
        out[r0:r0 + rows] = total + b2
    return out


def _inputs(N, D, M, x_scale=1.0):
    """numpy in JAX's layout, and the port's tensors (nn.Linear layout)."""
    x, w1, b1, w2, b2 = _mlp_data(21, N, D, M)
    x = x * np.float32(x_scale)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (x, w1, b1, w2, b2), (t(x), t(w1.T), t(b1), t(w2.T), t(b2))


_JAX = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the emulation's many small products (under
    xdist's six workers the default oversubscribes the CPU), restored after
    the module so that later files on the same worker run as they would
    alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_mlp(N, D, M, active):
    """JAX's `fused_mlp` (`_mlp_kernel`) in interpret mode on `_inputs`, kept
    a shape."""
    key = (N, D, M, active)
    if key not in _JAX:
        arrays, _ = _inputs(N, D, M)
        with pltpu.force_tpu_interpret_mode():
            _JAX[key] = np.asarray(jax_fused_mlp(*(jnp.asarray(a) for a in arrays),
                                                 active))
    return _JAX[key]


# 130 rows: three row tiles, the last of two rows; M = 1,100 in 35 chunks
# of 32, masked at 900: the plan's last splits lie wholly past the width.
@pytest.mark.parametrize("D", [16, 64])
def test_narrow_tf32x3_emulation_matches_jax_mlp_kernel(D):
    N, M, active = 130, 1100, 900
    plan = fused_mlp.k1_narrow_f32_plan(N, D, M, active, 1, SMS)
    assert plan["splits"] > 1 and plan["skipped_units"] > 0
    _, args = _inputs(N, D, M)
    np.testing.assert_allclose(_narrow_f32(*args, active).numpy(),
                               _jax_mlp(N, D, M, active), **F32_TOL)


def test_one_tf32_product_misses_the_jax_tolerance_in_the_narrow_body():
    """The same order with one TF32 product a product fails the JAX
    tolerance: the test tells 3xTF32 from TF32."""
    N, D, M, active = 130, 64, 1100, 900
    _, args = _inputs(N, D, M)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(
            _narrow_f32(*args, active, product=_tf32x1_fc).numpy(),
            _jax_mlp(N, D, M, active), **F32_TOL)


def test_narrow_tf32x3_with_x_four_times_larger():
    """x four times larger at the widest class's widths (D = 64, M =
    3,072), where the truncation inside the tensor cores weighs most: the
    emulated body holds the f32 tolerance against the exact (f64) MLP."""
    _, args = _inputs(70, 64, 3072, x_scale=4.0)
    np.testing.assert_allclose(_narrow_f32(*args, 3072).numpy(),
                               _f64_mlp(*args, 3072).numpy(), **F32_TOL)


# (rows a model, D, M, widths): the training path's 260 rows, one row, a
# tile and one more, the sweep's model axis, the drivers' evaluation rows,
# widths of 0, partial and full, and M that 32 does not divide.
@pytest.mark.parametrize("n,D,M,active", [
    (260, 64, 2048, 2048), (1, 16, 2048, 2048), (65, 8, 2204, [2204, 1000, 0]),
    (1560, 64, 3072, [2048] * 15 + [3072] * 15), (585, 32, 3072, [2048, 3072]),
    (4160, 16, 100, 77), (64, 64, 64, [0, 31, 64, 33]), (33280, 64, 3072, 3072)])
def test_k1_narrow_f32_plan_covers_every_unit_once(n, D, M, active):
    """Every (model, token row, live hidden column) falls in exactly one
    unit, every unit holds a row, a split wholly past a model's width
    computes no column, and the splits depend on n and M alone."""
    models = len(active) if isinstance(active, list) else 1
    plan = fused_mlp.k1_narrow_f32_plan(n, D, M, active, models, SMS)
    assert 1 <= plan["splits"] <= fused_mlp.NARROW_F32_MAX_SPLITS
    assert plan["units"] == plan["tiles"] * plan["splits"] * models
    assert plan["blocks"] == plan["units"] and plan["groups"] == plan["tiles"]
    widths = active if isinstance(active, list) else [active] * models
    taken = [np.zeros((n, M), dtype=np.int64) for _ in range(models)]
    skipped = 0
    for u in range(plan["units"]):
        p, r0, r1, c0, c1 = fused_mlp.k1_narrow_f32_unit(plan, u, active)
        assert r1 > r0
        taken[p][r0:r1, c0:c1] += 1
        skipped += c1 == c0
    for p, w in enumerate(widths):
        assert (taken[p][:, :w] == 1).all() and (taken[p][:, w:] == 0).all()
    # the units that compute no column are the plan's skipped ones
    assert skipped == plan["skipped_units"]
    alone = fused_mlp.k1_narrow_f32_plan(n, D, M, M, 1, SMS)
    assert alone["splits"] == plan["splits"]


@pytest.mark.parametrize("M", [2048, 3072])
@pytest.mark.parametrize("D", [16, 64])
def test_k1_narrow_f32_plan_fills_half_the_card_at_260_rows(D, M):
    """One model at the training path's 260 rows (5 row tiles) gets at
    least half of an H100's 132 SMs in units; K1c's groups walk several
    row tiles each."""
    plan = fused_mlp.k1_narrow_f32_plan(260, D, M, M, 1, SMS)
    assert plan["units"] >= SMS // 2
    assert plan["blocks"] == plan["units"] and plan["skipped_units"] == 0
    k1c = fused_mlp.k1_narrow_f32_plan(260, D, M, M, 1, SMS, groups=2)
    assert k1c["blocks"] == 2 * k1c["splits"] and k1c["units"] == plan["units"]

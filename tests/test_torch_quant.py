"""The port's int8 (W8A8) route against the JAX package's, on the CPU.

`ops/quant.int8_dense` is held to JAX's bit for bit (the int32 sums are
exact and every float step is the same f32 operation), the padded product
that the card's `torch._int_mm` takes to the unpadded int32 product
exactly, and the models to `tests/test_quant.py`'s accuracy contract.  The
port's int8 model against JAX's int8 model on the same weights differs
where an activation sits within an ulp of a .5 boundary of its int8 grid
in one framework and not the other: one step of that grid then moves the
logit.  Measured on confs 1, 3, 9 and 17 at 32 px, B=8, three inits each:
at most 7.7e-3 (int8) and 6.2e-3 (int8_attn), against 1.3e-6 without
quantization; most logits agree within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit3d_ensemble_tpu.configs import ViTConfig as JaxViTConfig
from vit3d_ensemble_tpu.models import VisionTransformer3D as JaxVisionTransformer3D
from vit3d_ensemble_tpu.ops import quant as jax_quant
from vit3d_ensemble_tpu_torch.checkpoint import vit_state_from_flax
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
from vit3d_ensemble_tpu_torch.ops import attention, quant
from vit3d_ensemble_tpu_torch.sweep.stacked import stacked_forward

IMG = 32
#: `tests/test_quant.py`'s bound on int8 logits against exact ones.
LOGIT_DEV = 0.15
#: Port int8 against JAX int8: the largest logit difference (a rounding
#: flip; worst seen 7.7e-3) and the median one (no flip; seen <= 6e-7).
INT8_PARITY_MAX = 0.02
INT8_PARITY_MEDIAN = 2e-4
#: The stacked int8 forward against single-model ones, same flip rule.
STACKED_MAX = 0.02
STACKED_MEDIAN = 1e-5


@pytest.fixture(autouse=True)
def quant_reset():
    yield
    quant.set_default_quant_impl("none")
    jax_quant.set_default_quant_impl("none")
    attention.set_default_attention_impl("auto")


def _operands(seed, x_shape, K, N, zero=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*x_shape, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(N,)) * 0.01).astype(np.float32)
    if zero:
        x[:], w[:], b[:] = 0.0, 0.0, 0.0
    return x, w, b


# --- the op -----------------------------------------------------------------------


def test_selector_validates():
    quant.set_default_quant_impl("int8")
    assert quant.get_default_quant_impl() == "int8"
    quant.set_default_quant_impl("int8_attn")
    assert quant.get_default_quant_impl() == "int8_attn"
    with pytest.raises(ValueError):
        quant.set_default_quant_impl("int4")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_shape,K,N,zero", [
    ((6, 65), 64, 192, False),      # tests/test_quant.py:35-37
    ((4,), 8, 16, True),            # zero rows and weights (:51-53)
    ((2, 257), 16, 2204, False),    # conf 19's fc1: N not a multiple of 8
    ((130,), 2204, 16, False),      # and its fc2: K not a multiple of 8
])
def test_int8_dense_equals_jax(x_shape, K, N, zero, dtype):
    """Bit for bit, in f32 and with bf16 activations."""
    x, w, b = _operands(K + N, x_shape, K, N, zero)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    ref = np.asarray(jax_quant.int8_dense(jx, jnp.asarray(w), jnp.asarray(b))
                     .astype(jnp.float32))
    got = quant.int8_dense(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == tx.dtype and got.shape == (*x_shape, N)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    if zero:
        assert not quant.int8_dense(tx, torch.from_numpy(w)).float().abs().max()
    for ours, theirs, arg in ((quant.quantize_rowwise, jax_quant.quantize_rowwise, x),
                              (quant.quantize_colwise, jax_quant.quantize_colwise, w)):
        q, s = ours(torch.from_numpy(arg))
        rq, rs = theirs(jnp.asarray(arg))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_int8_dense_model_axis_is_each_model_alone():
    """With a leading model axis each model gets its own scales: equal to
    P one-model products."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(3, 2, 65, 24)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 24, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
    got = quant.int8_dense(x, w, b)
    for p in range(3):
        assert torch.equal(got[p], quant.int8_dense(x[p], w[p], b[p]))


@pytest.mark.parametrize("M,K,N,models", [
    (130, 16, 2204, 0), (130, 2204, 16, 0), (520, 64, 3072, 0),
    (65, 36, 20, 3),
])
def test_padded_int_mm_is_the_int32_product(M, K, N, models):
    """The card's route (`int_mm_padded`: K and N zero-padded to multiples
    of 8, `torch._int_mm`, sliced back), run here on the CPU's
    `torch._int_mm`, equals the unpadded int32 product exactly."""
    g = torch.Generator().manual_seed(M + K + N)
    lead = (models,) if models else ()
    a = torch.randint(-127, 128, (*lead, M, K), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (*lead, K, N), generator=g, dtype=torch.int8)
    ap, bp = quant.padded_operands(a, b)
    assert ap.shape[-1] % 8 == 0 and bp.shape[-2:] == (ap.shape[-1], N + (-N % 8))
    # cuBLASLt's int8 GEMM takes a row-major and b column-major
    assert ap.is_contiguous() and bp.transpose(-1, -2).is_contiguous()
    got = quant.int_mm_padded(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, quant._plain_int_mm(a, b))
    assert torch.equal(got, a.to(torch.int64).matmul(b.to(torch.int64)).to(torch.int32))


def test_int_mm_padded_refuses_few_rows():
    """A product of 16 rows or fewer, which `torch._int_mm` on the card
    refuses, runs with its rows zero-padded to 17 and sliced back: the
    int32 product exactly, at 1, 5 and 16 rows, with and without a model
    axis (it raised before, where JAX's `int8_dense` takes any row count)."""
    g = torch.Generator().manual_seed(16)
    for M in (1, 5, 16):
        for lead in ((), (3,)):
            a = torch.randint(-127, 128, (*lead, M, 36), generator=g, dtype=torch.int8)
            b = torch.randint(-127, 128, (*lead, 36, 20), generator=g, dtype=torch.int8)
            got = quant.int_mm_padded(a, b)
            assert got.dtype == torch.int32 and got.shape == (*lead, M, 20)
            assert torch.equal(got, quant._plain_int_mm(a, b))


# --- the models ---------------------------------------------------------------------


_MODELS = {}


def _models(conf):
    """(JAX model, its params, the port's model with the same weights)."""
    if conf not in _MODELS:
        jcfg = JaxViTConfig.from_conf(conf, img_size=IMG)
        jm = JaxVisionTransformer3D(jcfg, zero_head=False, vis=False)
        params = jax.device_get(jax.jit(lambda k: jm.init(
            {"params": k}, jnp.zeros((1, IMG, IMG, 5, 1)))["params"])(jax.random.key(0)))
        cfg = ViTConfig.from_conf(conf, img_size=IMG)
        tm = VisionTransformer3D(cfg, vis=False, device="cpu")
        tm.load_state_dict(vit_state_from_flax(params, cfg))
        _MODELS[conf] = (jm, params, tm)
    return _MODELS[conf]


def _volumes(seed, B=8):
    return np.random.default_rng(seed).normal(size=(B, IMG, IMG, 5, 1)).astype(np.float32)


@torch.no_grad()
def _logits(model, x, **kw):
    return model(torch.from_numpy(x), **kw).logits


@pytest.mark.parametrize("conf", [1, 9])
def test_model_logits_deviation_bounded(conf):
    """`tests/test_quant.py::test_model_logits_deviation_bounded` for the
    port: int8 logits within 0.15 of exact, finite, and not equal."""
    _, _, model = _models(conf)
    x = _volumes(conf * 10 + 1)
    exact = _logits(model, x)
    for impl in ("int8", "int8_attn"):
        quant.set_default_quant_impl(impl)
        got = _logits(model, x)
        dev = float((got - exact).abs().max())
        assert torch.isfinite(got).all()
        assert 0.0 < dev < LOGIT_DEV, (impl, dev)


@pytest.mark.parametrize("conf", [1, 9])
def test_int8_model_matches_jax(conf):
    """The port's int8 and int8_attn models against JAX's on the same
    weights and volumes (see the module docstring for the flip rule)."""
    jm, params, model = _models(conf)
    x = _volumes(conf * 10)
    for impl in ("int8", "int8_attn"):
        quant.set_default_quant_impl(impl)
        jax_quant.set_default_quant_impl(impl)
        ref = np.asarray(jax.jit(lambda p, v: jm.apply(
            {"params": p}, v, deterministic=True).logits)(params, jnp.asarray(x)))
        diff = np.abs(_logits(model, x).numpy() - ref)
        assert diff.max() <= INT8_PARITY_MAX, (impl, diff.max())
        assert np.median(diff) <= INT8_PARITY_MEDIAN, (impl, np.median(diff))


def test_training_path_ignores_quant():
    """A dropout-active forward takes no int8 product
    (`tests/test_quant.py::test_training_path_ignores_quant`)."""
    _, _, model = _models(9)
    x = _volumes(0, B=4)

    def train_forward():
        return _logits(model, x, deterministic=False,
                       generator=torch.Generator().manual_seed(7))

    ref = train_forward()
    quant.set_default_quant_impl("int8")
    assert torch.equal(train_forward(), ref)


def test_layer_route_ignores_quant():
    """Under `layer` the whole sublayer runs on K3's path before the
    selector is read (`vit3d.py:150-163`): int8 changes only the MLP, and
    int8_attn nothing."""
    _, _, model = _models(9)
    x = _volumes(2, B=4)
    attention.set_default_attention_impl("layer")
    ref = _logits(model, x)
    quant.set_default_quant_impl("int8_attn")
    assert torch.equal(_logits(model, x), ref)
    quant.set_default_quant_impl("int8")
    assert not torch.equal(_logits(model, x), ref)
    attention.set_default_attention_impl("auto")
    quant.set_default_quant_impl("int8_attn")
    assert not torch.equal(_logits(model, x), _logits_none(model, x))


def _logits_none(model, x):
    impl = quant.get_default_quant_impl()
    quant.set_default_quant_impl("none")
    try:
        return _logits(model, x)
    finally:
        quant.set_default_quant_impl(impl)


def test_masked_mlp_stays_exact_under_int8():
    """With `mlp_active` given, as the sweeps give it, the MLP keeps its
    exact path: int8 and int8_attn agree."""
    _, _, model = _models(1)
    x = _volumes(4, B=4)
    active = model.config.mlp_dim
    quant.set_default_quant_impl("int8_attn")
    ref = _logits(model, x, mlp_active=active)
    quant.set_default_quant_impl("int8")
    assert torch.equal(_logits(model, x, mlp_active=active), ref)


@pytest.mark.parametrize("impl", ["int8", "int8_attn"])
def test_stacked_int8_matches_single_models(impl):
    """The stacked model's int8 forward (each model's own scales) against
    P single-model int8 forwards with `mlp_active` set, as the stacked
    model always runs its MLP exact."""
    cfg = ViTConfig.from_conf(1, img_size=IMG)
    models = [VisionTransformer3D(cfg, zero_head=False, vis=False, device="cpu",
                                  generator=torch.Generator().manual_seed(s))
              for s in range(3)]
    params = {k: torch.stack([m.state_dict()[k] for m in models])
              for k in models[0].state_dict()}
    x = _volumes(5, B=4)
    quant.set_default_quant_impl(impl)
    with torch.no_grad():
        got = stacked_forward(params, cfg, torch.from_numpy(x).unsqueeze(0),
                              layers_active=torch.full((3,), cfg.num_layers),
                              mlp_active=torch.full((3,), cfg.mlp_dim))
    want = torch.stack([_logits(m, x, mlp_active=cfg.mlp_dim) for m in models])
    diff = (got - want).abs()
    assert diff.max() <= STACKED_MAX and diff.median() <= STACKED_MEDIAN, diff
    quant.set_default_quant_impl("none")
    with torch.no_grad():
        exact = stacked_forward(params, cfg, torch.from_numpy(x).unsqueeze(0),
                                layers_active=torch.full((3,), cfg.num_layers),
                                mlp_active=torch.full((3,), cfg.mlp_dim))
    assert not torch.equal(got, exact)

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
    fused_attention as jax_fused_attention,
)
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
    """Both round GELU's output to bf16 before fc2; the JAX kernel's bf16
    GELU is a polynomial within 5.73e-4 of erf GELU, the port's is erf."""
    args = _mlp_data(1, 16, 96)
    ref = _jax_fused_mlp(args, active, jnp.bfloat16)
    out = fmlp.fused_mlp(*_torch_mlp_args(*args, dtype=torch.bfloat16),
                         active)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.05, rtol=0.05)


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


def test_mlp_checks_reject_what_the_kernel_does_not_take():
    x, w1, b1, w2, b2 = _torch_mlp_args(*_mlp_data(9, 16, 96))
    fmlp._check(x, w1, b1, w2, b2)          # accepted
    with pytest.raises(TypeError):
        fmlp._check(*(t.half() for t in (x, w1, b1, w2, b2)))
    with pytest.raises(ValueError, match="hidden size"):
        fmlp._check(x[..., :12].contiguous(), w1[:, :12].contiguous(), b1,
                    w2[:12].contiguous(), b2[:12].contiguous())
    with pytest.raises(ValueError, match="shape"):
        fmlp._check(x, w1, b1, w2.T.contiguous().T[:, :95], b2)
    with pytest.raises(ValueError, match="contiguous"):
        fmlp._check(x, w1, b1, w2.T.contiguous().T, b2)
    with pytest.raises(ValueError, match="bfloat16"):
        fmlp._check(x, w1.bfloat16(), b1, w2, b2)


def test_attention_checks_reject_what_the_kernel_does_not_take():
    q = torch.zeros(2, 4, 65, 16)
    fused_attention._check(q, q, q)        # accepted
    with pytest.raises(NotImplementedError, match="K4"):
        big = torch.zeros(2, 12, 513, 64)
        fused_attention._check(big, big, big)
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

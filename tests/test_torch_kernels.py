"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: they need a CUDA device, `nvcc` and the kernels built from
`vit3d_ensemble_tpu_torch/csrc/`, and skip elsewhere.  Run them on the card
with `python -m pytest --noconftest -m gpu tests/test_torch_kernels.py`
(`tests/conftest.py` imports JAX, which a CUDA host need not have).

Tolerances are the JAX package's own for its kernels
(`tests/test_pallas_mlp.py:31,47`, `tests/test_ops.py:31`): kernel and plain
version accumulate in f32 and round at the same points.
"""

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


def _close(out, ref, dtype):
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 4, 65, 16), (3, 8, 65, 4), (1, 16, 65, 1), (2, 4, 5, 16),
    (2, 2, 300, 8),     # more keys than one shared-memory pass
])
def test_tiny_attention_kernel_matches_plain(cuda, dtype, shape):
    q, k, v = (torch.randn(*shape, generator=cuda, device="cuda").to(dtype)
               for _ in range(3))
    before = fused_attention.launches
    out = fused_attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, fused_attention._plain_attention(q, k, v), dtype)


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


def test_tiny_attention_takes_strided_inputs(cuda):
    qkv = torch.randn(2, 65, 3, 4, 16, generator=cuda, device="cuda")
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    _close(fused_attention.fused_attention(q, k, v),
           fused_attention._plain_attention(q, k, v), torch.float32)


def test_kernels_raise_on_what_they_do_not_take(cuda):
    big = torch.zeros(1, 12, 65, 64, device="cuda")
    with pytest.raises(NotImplementedError, match="K4"):
        fused_attention.fused_attention(big, big, big)
    x = torch.zeros(65, 48, device="cuda")
    w1, w2 = torch.zeros(128, 48, device="cuda"), torch.zeros(48, 128, device="cuda")
    with pytest.raises(ValueError, match="hidden size"):
        fused_mlp.fused_mlp(x, w1, torch.zeros(128, device="cuda"), w2,
                            torch.zeros(48, device="cuda"))
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
# hd 16 / 64 with T over 4 and 5 shared-memory chunks of keys.
K3_SHAPES = [(512, 65, 64, 4), (512, 65, 32, 8), (512, 65, 16, 16),
             (64, 257, 16, 4), (64, 257, 8, 8), (2, 513, 768, 12),
             (2, 5, 16, 4), (3, 700, 64, 4), (2, 200, 128, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", K3_SHAPES)
def test_attention_layer_kernel_matches_plain(cuda, dtype, B, T, D, H):
    qkv = torch.randn(B, T, 3 * D, generator=cuda, device="cuda").to(dtype)
    q, k, v = attention_layer._split(qkv)
    before = attention_layer.launches
    out = attention_layer.attention_core(q, k, v, H)
    torch.cuda.synchronize()
    assert attention_layer.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, T, D) and out.is_contiguous()
    _close(out, attention_layer._plain_attention_core(q, k, v, H), dtype)


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
    q, k, v = attention_layer._split(torch.zeros(2, 65, 36, device="cuda"))
    with pytest.raises(ValueError, match="head_dim 3"):
        attention_layer.attention_core(q, k, v, 4)
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

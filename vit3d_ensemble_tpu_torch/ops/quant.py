"""Int8 (W8A8) products for deterministic forwards, the counterpart of
`vit3d_ensemble_tpu/ops/quant.py`.

The recipe is JAX's (`quant.py:39-91`), on tensors:
  * weights: symmetric scales for each output column, absmax/127 over the
    input axis, quantized at every call;
  * activations: symmetric scales for each token, absmax/127 over the
    feature axis, recomputed at every call;
  * both in f32, with the absmax floored at `_EPS`, rounded half to even,
    clipped to ±127 and cast to int8;
  * an int8 × int8 product with int32 accumulation, dequantized as
    `acc * sx * sw` in f32, then `+ b`, then cast back to the input's type.

The int32 sums are exact, so the card and the CPU agree bit for bit on the
same inputs.  On a CUDA tensor the product is `torch._int_mm` (cuBLASLt's
int8 GEMM, as JAX leaves its `lax.dot_general` to XLA: no hand-written
kernel).  It takes more than 16 rows and K and N that are multiples of 8;
K and N are padded with zeros to the next multiple of 8, which adds
nothing to an integer sum (`mlp_dim` 2,204 of confs 19-22 is 4 short), the
rows of a product with 16 or fewer to 17, and the result is sliced back.
On a CPU tensor it is the plain int32 product.

Scope, as in JAX: the Q/K/V and out projections (`int8` and `int8_attn`)
and the MLP's fc1/fc2 (`int8` only), on deterministic forwards only; the
attention core, patchify and the head stay in the ambient dtype
(`models/vit3d.py`, `sweep/stacked.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_DEFAULT_QUANT_IMPL = "none"

#: absmax floor: an all-zero row or column would otherwise divide by zero.
_EPS = 1e-8

#: The card's int8 products (`torch._int_mm` calls), for the smoke run.
int8_products = 0


def set_default_quant_impl(impl: str) -> None:
    """'none' | 'int8' (attention projections and MLP) | 'int8_attn'
    (attention projections only; the MLP keeps the fused kernel)."""
    global _DEFAULT_QUANT_IMPL
    if impl not in ("none", "int8", "int8_attn"):
        raise ValueError(f"unknown quant impl: {impl!r}")
    _DEFAULT_QUANT_IMPL = impl


def get_default_quant_impl() -> str:
    return _DEFAULT_QUANT_IMPL


def _quantize(x: torch.Tensor, dim: int):
    xf = x.float()
    # 127 as a tensor on x's device: divided by a Python number, a CUDA
    # tensor is multiplied by its reciprocal, which is an ulp off the
    # quotient that the CPU and JAX take
    d = torch.full((), 127.0, device=x.device)
    scale = torch.clamp(xf.abs().amax(dim, keepdim=True), min=_EPS) / d
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_rowwise(x: torch.Tensor):
    """Symmetric int8 with a scale for each row: absmax over the last axis."""
    return _quantize(x, -1)


def quantize_colwise(w: torch.Tensor):
    """Symmetric int8 with a scale for each output column of a (K, N)
    weight, or of each model's (K, N) under a leading model axis: absmax
    over the input axis K."""
    return _quantize(w, -2)


def padded_operands(a: torch.Tensor, b: torch.Tensor):
    """a (..., M, K) and b (..., K, N) with K and N zero-padded to multiples
    of 8, in the layouts cuBLASLt's int8 GEMM takes: a row-major, b
    column-major (each model's (K, N) the transpose of a contiguous (N, K))."""
    k8, n8 = -b.shape[-2] % 8, -b.shape[-1] % 8
    if k8:
        a = F.pad(a, (0, k8))
        b = F.pad(b, (0, 0, 0, k8))
    if n8:
        b = F.pad(b, (0, n8))
    return a.contiguous(), b.transpose(-1, -2).contiguous().transpose(-1, -2)


#: `torch._int_mm` on a CUDA tensor takes more rows than this.
_INT_MM_MIN_ROWS = 16


def int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The card's product: int8 a (M, K) or (P, M, K) by int8 b (K, N) or
    (P, K, N) -> int32, through `torch._int_mm` on the padded operands, a
    model at a time.  `torch._int_mm` on the card takes more than 16 rows,
    so a product of fewer runs with a's rows zero-padded to 17 and is sliced
    back: zero rows add nothing, so the result is exact at any row count,
    as JAX's `int8_dense` is."""
    M, N = a.shape[-2], b.shape[-1]
    ap, bp = padded_operands(a, b)
    if M <= _INT_MM_MIN_ROWS:
        ap = F.pad(ap, (0, 0, 0, _INT_MM_MIN_ROWS + 1 - M))
    if a.dim() == 2:
        return torch._int_mm(ap, bp)[:M, :N]
    return torch.stack([torch._int_mm(ap[p], bp[p])[:M, :N]
                        for p in range(ap.shape[0])])


def _plain_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: an int32 product, exact for K·127² < 2³¹."""
    return torch.matmul(a.to(torch.int32), b.to(torch.int32))


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a by int8 b with int32 sums: `torch._int_mm` on a CUDA tensor,
    the plain int32 product on a CPU tensor."""
    global int8_products
    if a.is_cuda:
        out = int_mm_padded(a, b)
        int8_products += 1 if a.dim() == 2 else a.shape[0]
        return out
    return _plain_int_mm(a, b)


def int8_dense(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """y = x @ w (+ b) through dynamic W8A8 int8, in x's dtype.

    x (..., K), w (K, N), b (N,) -> (..., N); or with a leading model axis
    x (P, ..., K), w (P, K, N), b (P, N), each model with its own scales.
    """
    K, N = w.shape[-2:]
    xq, sx = quantize_rowwise(x)
    wq, sw = quantize_colwise(w)
    if w.dim() == 2:
        acc = int8_matmul(xq.reshape(-1, K), wq)
    else:
        P = w.shape[0]
        acc = int8_matmul(xq.reshape(P, -1, K), wq)
        lead = (P,) + (1,) * (x.dim() - 2)
        sw = sw.reshape(*lead, N)
        b = None if b is None else b.reshape(*lead, N)
    y = acc.reshape(*x.shape[:-1], N).float() * sx * sw
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)

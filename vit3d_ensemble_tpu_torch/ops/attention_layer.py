"""K3, the whole-sublayer attention: QKV projection -> per-head softmax
attention -> out projection, with the attention core as a CUDA kernel.

Counterpart of `vit3d_ensemble_tpu/ops/pallas_attention_layer.py`.  The two
projections stay `F.linear`, as the JAX package leaves them to XLA; the
kernel (`csrc/attention_layer.cu`) reads q, k and v in place from the
(B, T, 3D) QKV output and writes the (B, T, D) context for the out
projection.  Its source note says what bounds it on the H100.

Weights use the torch.nn.Linear layout: wqkv (3D, D) is the query, key and
value weights stacked in that order, bqkv (3D,), wout (D, D), bout (D,).

On a CPU tensor `fused_attention_layer` computes `_plain_attention_layer`;
on a CUDA tensor it launches the kernel or raises.  Backward recomputes
through `_plain_attention_layer`, as the JAX custom VJP does
(`pallas_attention_layer.py:178-183`), so the (B, H, T, T) probabilities are
never kept between the passes.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from vit3d_ensemble_tpu_torch.ops import _build, fused_attention

#: K3 launches in this process; the wrapper adds one per kernel launch.
launches = 0

#: head dims the kernel is instantiated for: every D / H of the registry.
HEAD_DIMS = (1, 4, 16, 64)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _split(qkv: torch.Tensor):
    """(B, T, 3D) -> the q, k, v views (B, T, D), no copy."""
    D = qkv.shape[-1] // 3
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]


def _plain_attention_core(q, k, v, n_heads):
    """The kernel's function in plain PyTorch: q, k, v (B, T, D) ->
    ctx (B, T, D), K2's plain version on the per-head views (scores,
    softmax and context in f32, the output rounded once, as the kernel
    does)."""
    B, T, D = q.shape

    def heads(a):
        return a.unflatten(-1, (n_heads, D // n_heads)).transpose(1, 2)

    ctx = fused_attention._plain_attention(heads(q), heads(k), heads(v))
    return ctx.transpose(1, 2).reshape(B, T, D)


def _plain_attention_layer(h, wqkv, bqkv, wout, bout, n_heads):
    """`_reference_attention_layer` (`pallas_attention_layer.py:136-150`),
    rounding where the kernel path rounds: the projections in the input
    type, the attention core in f32 with its output rounded once.  For f32
    inputs it is `_reference_attention_layer` exactly."""
    ctx = _plain_attention_core(*_split(F.linear(h, wqkv, bqkv)), n_heads)
    return F.linear(ctx, wout, bout)


def _check(q, k, v, n_heads) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 3:
        raise ValueError(f"attention_layer: q has shape {tuple(q.shape)}, "
                         "expected (B, T, D)")
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention_layer: dtype {q.dtype} is not float32 or "
                        "bfloat16")
    for name, t in (("k", k), ("v", v)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride() != q.stride()):
            raise ValueError(
                f"attention_layer: {name} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device} with strides {t.stride()}, q is "
                f"{tuple(q.shape)} {q.dtype} on {q.device} with strides "
                f"{q.stride()}")
    B, T, D = q.shape
    if n_heads <= 0 or D % n_heads:
        raise ValueError(f"attention_layer: {n_heads} heads do not divide "
                         f"hidden size {D}")
    if D // n_heads not in HEAD_DIMS:
        raise ValueError(f"attention_layer: head_dim {D // n_heads} is not one "
                         f"of {HEAD_DIMS}")
    if q.stride(2) != 1:
        raise ValueError("attention_layer: q, k, v need unit column stride")
    if B >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError("attention_layer: more than 2**31 - 1 volumes or tokens")


def _launch(q, k, v, n_heads):
    global launches
    if q.device.type != "cuda":
        raise RuntimeError(f"attention_layer: kernel launch on {q.device}")
    _check(q, k, v, n_heads)
    fn = _build.entry("attention_layer",
                      [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                      + [ctypes.c_longlong] * 2
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    B, T, D = q.shape
    hd = D // n_heads
    out = torch.empty(B, T, D, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), B, T, n_heads, hd, q.stride(1), q.stride(0),
             1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    _build.check("attention_layer", err)
    launches += 1
    return out


def attention_core(q, k, v, n_heads):
    """softmax(q k^T / sqrt(hd)) v per head; q, k, v: (B, T, D) views that
    share their strides (the slices of one QKV output), ctx (B, T, D).  No
    autograd: `fused_attention_layer` is the differentiable entry."""
    if q.device.type == "cpu":
        return _plain_attention_core(q, k, v, n_heads)
    return _launch(q, k, v, n_heads)


class _FusedAttentionLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, wqkv, bqkv, wout, bout, n_heads):
        ctx.save_for_backward(h, wqkv, bqkv, wout, bout)
        ctx.n_heads = n_heads
        context = _launch(*_split(F.linear(h, wqkv, bqkv)), n_heads)
        return F.linear(context, wout, bout)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = _plain_attention_layer(*inputs, ctx.n_heads)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None)


def fused_attention_layer(h, wqkv, bqkv, wout, bout, n_heads: int):
    """The attention sublayer without its LayerNorm and residual: h (B, T, D)
    LN-normed tokens -> (B, T, D).  The caller adds the residual."""
    if h.device.type == "cpu":
        return _plain_attention_layer(h, wqkv, bqkv, wout, bout, n_heads)
    return _FusedAttentionLayer.apply(h, wqkv, bqkv, wout, bout, n_heads)

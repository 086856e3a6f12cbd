"""K3, the whole-sublayer attention: QKV projection -> per-head softmax
attention -> out projection, with the attention core as a CUDA kernel.

Counterpart of `vit3d_ensemble_tpu/ops/pallas_attention_layer.py`.  The two
projections stay `F.linear`, as the JAX package leaves them to XLA; the
attention core reads q, k and v in place from the (B, T, 3D) QKV output and
writes the (B, T, D) context for the out projection.  Two bodies serve it,
by head_dim:

  * hd in `HEAD_DIMS` (1, 4, 16; every D / H of the 22 registry configs):
    K3's own CUDA-core body, `csrc/attention_layer.cu`;
  * hd in `HEAD_DIMS_K4` (32, 64, 128; the stretch model's 64): K4's
    tensor-core body, `csrc/attention.cu`, on the (B, H, T, hd) views of the
    QKV buffer, writing (B, T, H, hd), which is the (B, T, D) context, so no
    copy surrounds it.  Its plain version is K4's, `_plain_attention_k4`,
    which rounds where that kernel rounds.

Each source note says what bounds its kernel on the H100.

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

#: Attention-core launches of the sublayer in this process, on either body;
#: the wrapper adds one per kernel launch.
launches = 0
#: Those of them that took K4's body (head_dim in HEAD_DIMS_K4).
launches_k4 = 0

#: head dims K3's own body is instantiated for: every D / H of the registry.
HEAD_DIMS = (1, 4, 16)
#: head dims served by K4's tensor-core body.
HEAD_DIMS_K4 = fused_attention.HEAD_DIMS_K4

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _split(qkv: torch.Tensor):
    """(B, T, 3D) -> the q, k, v views (B, T, D), no copy."""
    D = qkv.shape[-1] // 3
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]


def _heads(a, n_heads):
    """(B, T, D) -> the (B, H, T, hd) view, no copy."""
    return a.unflatten(-1, (n_heads, a.shape[-1] // n_heads)).transpose(1, 2)


def _plain_attention_core(q, k, v, n_heads):
    """The kernels' function in plain PyTorch: q, k, v (B, T, D) ->
    ctx (B, T, D), the plain version of the body that serves the head_dim
    (`fused_attention._plain`) on the per-head views.  At head_dim <= 16,
    K2's (scores, softmax and context in f32, the output rounded once, as
    K3's body does); above, K4's (in bf16 the unnormalised probabilities
    are rounded before the second product, as K4's body does; in f32 the
    same function)."""
    B, T, D = q.shape
    ctx = fused_attention._plain(*(_heads(t, n_heads) for t in (q, k, v)))
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
    hd = D // n_heads
    if hd not in HEAD_DIMS + HEAD_DIMS_K4:
        raise ValueError(f"attention_layer: head_dim {hd} is not one of "
                         f"{HEAD_DIMS} (K3's body) or {HEAD_DIMS_K4} (K4's)")
    if q.stride(2) != 1:
        raise ValueError("attention_layer: q, k, v need unit column stride")
    if B >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError("attention_layer: more than 2**31 - 1 volumes or tokens")
    if hd in HEAD_DIMS_K4:
        # K4's own checks on the per-head views: in bf16 16-byte aligned
        # addresses and strides, at most MAX_TOKENS_K4 tokens
        fused_attention._check(*(_heads(t, n_heads) for t in (q, k, v)))


def _launch(q, k, v, n_heads):
    global launches, launches_k4
    if q.device.type != "cuda":
        raise RuntimeError(f"attention_layer: kernel launch on {q.device}")
    _check(q, k, v, n_heads)
    B, T, D = q.shape
    if D // n_heads in HEAD_DIMS_K4:
        # K4 writes (B, T, H, hd): the (B, T, D) context itself
        out = torch.empty(B, T, D, dtype=q.dtype, device=q.device)
        if B * T:
            fused_attention.k4_into(*(_heads(t, n_heads) for t in (q, k, v)),
                                    out.view(B, T, n_heads, D // n_heads))
            launches += 1
            launches_k4 += 1
        return out
    fn = _build.entry("attention_layer",
                      [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                      + [ctypes.c_longlong] * 2
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    hd = D // n_heads
    out = torch.empty(B, T, D, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), B, T, n_heads, hd, q.stride(1), q.stride(0),
             1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    _build.check("attention_layer", err)
    launches += 1
    return out


class _AttentionCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_heads):
        ctx.save_for_backward(q, k, v)
        ctx.n_heads = n_heads
        return _launch(q, k, v, n_heads)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = _plain_attention_core(*inputs, ctx.n_heads)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None)


def attention_core(q, k, v, n_heads):
    """softmax(q k^T / sqrt(hd)) v per head; q, k, v: (B, T, D) views that
    share their strides (the slices of one QKV output), ctx (B, T, D).  The
    backward recomputes through `_plain_attention_core`, as the sublayer's
    does; the stacked sweep model (`sweep/stacked.py`), whose projections
    carry a model axis, trains through it."""
    if q.device.type == "cpu":
        return _plain_attention_core(q, k, v, n_heads)
    return _AttentionCore.apply(q, k, v, n_heads)


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

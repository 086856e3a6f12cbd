"""K3, the whole-sublayer attention: QKV projection -> per-head softmax
attention -> out projection, with the attention core as a CUDA kernel.

Counterpart of `vit3d_ensemble_tpu/ops/pallas_attention_layer.py`.  The two
projections stay `F.linear`, as the JAX package leaves them to XLA; the
attention core reads q, k and v in place from the (B, T, 3D) QKV output, as
(B, H, T, hd) views of it, and writes the (B, T, D) context for the out
projection.  The core runs on the body of the fused attention kernel that
serves its head_dim (`ops/fused_attention.py`), so no copy surrounds it:

  * hd in `HEAD_DIMS` (1 to 16; the registry's 1, 4 and 16): K2's body,
    `csrc/tiny_attention.cu`, through `fused_attention.k2_into` (in bf16 at
    hd 9-16 the tensor cores, streamed at T <= 80, since the views of the
    QKV buffer start and step by multiples of 16 bytes; else the CUDA
    cores), counted in `launches_k2`;
  * every hd above 16 (the stretch model's 64, ViT-H's 80), as JAX's
    `_attn_core_kernel` takes any head_dim: K4's tensor-core bodies,
    `csrc/attention.cu` (above 256 their sliced forms), through
    `fused_attention.k4_into`, counted in `launches_k4`.  In bf16 the
    body loads by TMA, which needs 16-byte aligned views and strides: a
    head's view into the (B, T, 3D) buffer starts at h * hd * 2 bytes, so
    where 8 does not divide hd the wrapper copies the views into buffers
    whose rows are padded to a multiple of 8 (`fused_attention._k4_views`),
    a copy of the input and never a fall to the plain version; in f32 the
    body reads the views as they are.

Both write (B, T, H, hd), which is the (B, T, D) context.  The plain
version of the core is that body's own (`fused_attention._plain`), which
rounds where the kernel rounds.  Each source note says what bounds its
kernel on the H100.

Weights use the torch.nn.Linear layout: wqkv (3D, D) is the query, key and
value weights stacked in that order, bqkv (3D,), wout (D, D), bout (D,).

On a CPU tensor `fused_attention_layer` computes `_plain_attention_layer`;
on a CUDA tensor it launches the kernel or raises.  Backward recomputes
through `_plain_attention_layer`, as the JAX custom VJP does
(`pallas_attention_layer.py:178-183`), so the (B, H, T, T) probabilities are
never kept between the passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit3d_ensemble_tpu_torch.ops import fused_attention

#: Attention-core launches of the sublayer in this process, on either body;
#: the wrapper adds one per kernel launch.
launches = 0
#: Those of them that took K2's body (head_dim in HEAD_DIMS).
launches_k2 = 0
#: Those of them that took K4's body (head_dim above HEAD_DIMS[-1]).
launches_k4 = 0

#: head dims served by K2's body: every head_dim up to 16, as JAX's
#: `_attn_core_kernel` takes any; every one above takes K4's (`on_k4`).
HEAD_DIMS = tuple(range(1, fused_attention.TINY_HD + 1))


def on_k4(hd: int) -> bool:
    """Whether the core at head_dim `hd` runs on K4's body (else K2's)."""
    return hd > fused_attention.TINY_HD

_DTYPES = (torch.float32, torch.bfloat16)


def _split(qkv: torch.Tensor):
    """(B, T, 3D) -> the q, k, v views (B, T, D), no copy."""
    D = qkv.shape[-1] // 3
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]


def _heads(a, n_heads):
    """(B, T, D) -> the (B, H, T, hd) view, no copy."""
    return a.unflatten(-1, (n_heads, a.shape[-1] // n_heads)).transpose(1, 2)


def _plain_attention_core(q, k, v, n_heads):
    """The kernel's function in plain PyTorch: q, k, v (B, T, D) ->
    ctx (B, T, D), the plain version of the body that serves the head_dim
    (`fused_attention._plain`) on the per-head views, which is that body's
    own function.  Scores, softmax and context in f32, the output rounded
    once; in bf16 where the body runs on the tensor cores (K2's at head_dim
    9-16, K4's) the unnormalised probabilities are rounded to bf16 before
    the second product, as those bodies round them."""
    B, T, D = q.shape
    ctx = fused_attention._plain(*(_heads(t, n_heads) for t in (q, k, v)))
    return ctx.transpose(1, 2).reshape(B, T, D)


def _plain_attention_layer(h, wqkv, bqkv, wout, bout, n_heads):
    """`_reference_attention_layer` (`pallas_attention_layer.py:136-150`),
    rounding where the kernel path rounds: the projections in the input
    type, the attention core as `_plain_attention_core`.  For f32 inputs it
    is `_reference_attention_layer` exactly."""
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
    if q.stride(2) != 1:
        raise ValueError("attention_layer: q, k, v need unit column stride")
    if B >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError("attention_layer: more than 2**31 - 1 volumes or tokens")
    if on_k4(hd):
        # K4's own checks on the per-head views: at most MAX_TOKENS_K4 tokens
        fused_attention._check(*(_heads(t, n_heads) for t in (q, k, v)))


def _launch(q, k, v, n_heads):
    global launches, launches_k2, launches_k4
    if q.device.type != "cuda":
        raise RuntimeError(f"attention_layer: kernel launch on {q.device}")
    _check(q, k, v, n_heads)
    B, T, D = q.shape
    hd = D // n_heads
    # both bodies write (B, T, H, hd): the (B, T, D) context itself
    out = torch.empty(B, T, D, dtype=q.dtype, device=q.device)
    if B * T == 0:              # nothing to compute, nothing launched
        return out
    if on_k4(hd):
        views = fused_attention._k4_views(*(_heads(t, n_heads)
                                            for t in (q, k, v)))
        fused_attention.k4_into(*views, out.view(B, T, n_heads, hd))
        launches_k4 += 1
    else:
        # the (B, T, D) views and the head count, without making the head
        # views: the training path is bound by the host's time a call
        fused_attention.k2_into(q, k, v, out, n_heads)
        launches_k2 += 1
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

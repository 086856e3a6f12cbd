"""Multi-head dot-product attention for the tiny-head 3D-ViT regime.

Counterpart of `vit3d_ensemble_tpu/ops/attention.py` (the reference's
`models/modeling.py:55-99`): scores = QK^T / sqrt(head_dim) -> softmax ->
context.  Implementations:

  * ``plain``  — the einsum formulation (`_xla_attention`), with attention
                 dropout and the probabilities it returns;
  * ``kernel`` — the K2 kernel (`ops/fused_attention.py`) when dropout is
                 inactive;
  * ``auto``   — K2 on a CUDA tensor when head_dim <= 16, no probabilities
                 are asked for and dropout is inactive; ``plain`` otherwise;
  * ``layer``  — the whole-sublayer kernel K3 (`ops/attention_layer.py`),
                 which `models/vit3d.Attention` takes on probs-free paths
                 with attention dropout inactive, training included.  Where
                 it does not apply (vis mode, active attention dropout) the
                 call reaches this function and runs ``plain``, as the JAX
                 package degrades to its einsum (`attention.py:131-134`).

``auto`` differs from the JAX package on purpose: its choice of the einsum
path rests on TPU v5e measurements (`attention.py:136-144`), which say
nothing of the H100.  The JAX ``vpu`` impl is the einsum's math on another
TPU unit and has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from vit3d_ensemble_tpu_torch.ops.fused_attention import (
    TINY_HD,
    fused_attention,
)

_IMPLS = ("auto", "plain", "kernel", "layer")
_DEFAULT_IMPL = "auto"


def set_default_attention_impl(impl: str) -> None:
    """Select the process-wide default attention implementation."""
    global _DEFAULT_IMPL
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl: {impl!r}")
    _DEFAULT_IMPL = impl


def get_default_attention_impl() -> str:
    return _DEFAULT_IMPL


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout as flax's nn.Dropout: keep with probability
    1 - rate and scale by 1 / (1 - rate).  The generator must live on x's
    device."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _plain_attention(q, k, v, dropout_rate, deterministic, generator):
    """Einsum path (`_xla_attention`, `attention.py:75-104`).
    q, k, v: (..., heads, seq, head_dim)."""
    scores = torch.einsum("...hqd,...hkd->...hqk", q, k)
    scores = scores / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores, dim=-1)
    dropped = dropout(probs, dropout_rate, deterministic, generator)
    context = torch.einsum("...hqk,...hkd->...hqd", dropped, v)
    return context, probs


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    dropout_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    return_probs: bool = False,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Multi-head attention.

    Args:
      q, k, v: (..., num_heads, seq, head_dim) tensors.
      return_probs: also return post-softmax attention probabilities
        (pre-dropout), matching `modeling.py:89-90`.
      impl: 'auto' | 'plain' | 'kernel' | 'layer' | None (process default).

    Returns:
      (context, probs) with context (..., num_heads, seq, head_dim) and
      probs (..., num_heads, seq, seq) or None.
    """
    impl = impl or _DEFAULT_IMPL
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl: {impl!r}")
    if impl == "layer":
        # the sublayer kernel did not apply at the call site
        impl = "plain"
    dropout_off = deterministic or dropout_p == 0.0
    if impl == "auto":
        impl = ("kernel" if q.is_cuda and q.shape[-1] <= TINY_HD
                and not return_probs and dropout_off else "plain")
    if impl == "kernel" and dropout_off:
        context = fused_attention(q, k, v)
        probs = None
        if return_probs:
            # probabilities only on request (vis mode), from the einsum path
            _, probs = _plain_attention(q, k, v, 0.0, True, None)
        return context, probs

    context, probs = _plain_attention(q, k, v, dropout_p, deterministic,
                                      generator)
    return context, (probs if return_probs else None)

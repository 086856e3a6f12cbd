"""Multi-head dot-product attention of the 3D ViTs.

Counterpart of `vit3d_ensemble_tpu/ops/attention.py` (the reference's
`models/modeling.py:55-99`): scores = QK^T / sqrt(head_dim) -> softmax ->
context.  Implementations:

  * ``plain``  — the einsum formulation (`_xla_attention`), with attention
                 dropout and the probabilities it returns;
  * ``kernel`` — the fused kernels behind `ops/fused_attention.py` when
                 dropout is inactive: K2 at head_dim <= 16, K4 above (the
                 stretch model's 64); a head_dim neither takes raises;
  * ``auto``   — ``kernel`` on a CUDA tensor when no probabilities are asked
                 for and dropout is inactive; ``plain`` otherwise;
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
from typing import Optional, Tuple, Union

import torch

from vit3d_ensemble_tpu_torch.ops.fused_attention import fused_attention

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


_M32 = 0xFFFFFFFF
#: The multiplier of the 32-bit integer hash (`_mix32`).  Below 2^27, so a
#: product with a 32-bit value stays inside int64.
_MUL = 0x45D9F3B
_SITES_A_BLOCK = 1024


def _round32(x: torch.Tensor) -> torch.Tensor:
    """One xorshift-multiply round on 32-bit values held in int64, in place."""
    x ^= x >> 16
    x *= _MUL
    x &= _M32
    return x


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (two rounds and a final xorshift) of values in
    [0, 2^32) held in int64: no product leaves int64, so the CPU and the
    card compute the same bits."""
    x = _round32(_round32(x & _M32))
    return x ^ (x >> 16)


class CellDropout:
    """Dropout masks for a stacked model, a stream for each cell.

    The counterpart of the JAX sweep engine's per-cell dropout keys
    (`vit3d_ensemble_tpu/sweep/engine.py:369-386`).  Element e of cell c at
    dropout site s is kept when a counter-based hash of (seed, the cell's
    id, s, e) is at least rate·2^32, so a cell's masks depend on its id
    alone: not on how many cells share the stack, nor on where it sits.
    The site counter lives on the host and is the stream's whole state.

    A site costs six elementwise launches on the (P, n) mask (one round of
    `_mix32` and the comparison): each cell's keys for a block of sites and
    the hash of every element index are computed once and kept.
    """

    def __init__(self, seed: int, cell_ids, device):
        self.site = 0
        ids = torch.as_tensor(list(cell_ids), dtype=torch.int64, device=device)
        self.cells = len(ids)
        self._cell_key = _mix32(_mix32(ids + 0x9E3779B9) ^ (seed & _M32))
        self._block = (-1, None)             # (block number, (sites, P) keys)
        self._elements = {}                  # n -> (1, n) hashed indices

    def _site_keys(self, site: int) -> torch.Tensor:
        number, keys = self._block
        if number != site // _SITES_A_BLOCK:
            number = site // _SITES_A_BLOCK
            sites = torch.arange(number * _SITES_A_BLOCK,
                                 (number + 1) * _SITES_A_BLOCK,
                                 device=self._cell_key.device)
            keys = _mix32(_mix32(sites + 0x7F4A7C15)[:, None]
                          ^ self._cell_key[None, :])
            self._block = (number, keys)
        return keys[site % _SITES_A_BLOCK][:, None]

    def keep(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """The mask of the next site for x, whose leading axis is the cells'
        (P) or P·B with each cell's rows together."""
        if x.shape[0] % self.cells:
            raise ValueError(f"dropout: {x.shape[0]} rows for {self.cells} cells")
        n = x.numel() // self.cells
        elements = self._elements.get(n)
        if elements is None:
            elements = self._elements[n] = _mix32(
                torch.arange(n, device=x.device) + 0x632BE5AB)[None, :]
        bits = _round32(elements ^ self._site_keys(self.site))
        self.site += 1
        return (bits >= math.ceil(rate * 2.0 ** 32)).reshape(x.shape)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[Union[torch.Generator, CellDropout]] = None
            ) -> torch.Tensor:
    """Inverted dropout as flax's nn.Dropout: keep with probability
    1 - rate and scale by 1 / (1 - rate).  The masks come from `generator`,
    a `torch.Generator` on x's device, or a stacked model's `CellDropout`."""
    if deterministic or rate == 0.0:
        return x
    if isinstance(generator, CellDropout):
        keep = generator.keep(x, rate)
    else:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _stream_state(generator):
    if isinstance(generator, CellDropout):
        return generator.site
    if isinstance(generator, torch.Generator):
        return generator.get_state()
    return None


def _set_stream_state(generator, state) -> None:
    if isinstance(generator, CellDropout):
        generator.site = state
    elif isinstance(generator, torch.Generator):
        generator.set_state(state)


def checkpoint_block(fn, generator, *args):
    """fn(*args) with its activations recomputed in the backward pass
    (`torch.utils.checkpoint`, non-reentrant): the counterpart of JAX's
    `nn.remat` of an encoder block (`vit3d.py:468-469`).

    The checkpoint restores the global RNGs for the recompute, not an
    explicit dropout stream.  So the stream's state at the forward (a
    `CellDropout`'s site counter, a `torch.Generator`'s state) is kept
    here and restored for the recompute, and the state the forward left is
    put back after it: the recompute draws the forward's masks, and the
    draws after the backward continue where the forward's ended."""
    from torch.utils.checkpoint import checkpoint

    start, ran = _stream_state(generator), []

    def run(*inputs):
        if not ran:
            ran.append(True)
            return fn(*inputs)
        end = _stream_state(generator)
        _set_stream_state(generator, start)
        try:
            return fn(*inputs)
        finally:
            _set_stream_state(generator, end)

    return checkpoint(run, *args, use_reentrant=False)


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
    generator: Optional[Union[torch.Generator, CellDropout]] = None,
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
        impl = ("kernel" if q.is_cuda and not return_probs and dropout_off
                else "plain")
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

"""K1, the fused FFN (fc1 -> GELU -> fc2) as a CUDA kernel for Hopper.

Counterpart of `vit3d_ensemble_tpu/ops/pallas_mlp.py`.  The kernel
(`csrc/fused_mlp.cu`) keeps the (tokens, mlp_dim) intermediate on chip;
its source note says what bounds it on the H100 and how it is laid out.

Weights use the torch.nn.Linear layout: w1 (M, D), b1 (M,), w2 (D, M),
b2 (D,).  `mlp_active` masks hidden columns at or past it to exact zero,
the runtime width mask of the sweep.

On a CPU tensor `fused_mlp` computes `_plain_mlp`; on a CUDA tensor it
launches the kernel or raises.  Backward recomputes through `_plain_mlp`, as
the JAX custom VJP does (`pallas_mlp.py:250-255`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vit3d_ensemble_tpu_torch.ops import _build

#: K1 launches in this process; the wrapper adds one per kernel launch.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: hidden sizes of the narrow regime (every D of the 22 registry configs).
WIDTHS = (8, 16, 32, 64)
#: the wide regime: every multiple of WIDE_STEP above it up to WIDE_MAX
#: (the stretch model's D = 768), on the kernel's wide bodies.
WIDE_STEP, WIDE_MAX = 64, 1024


def supported_width(D: int) -> bool:
    """Whether the kernel takes hidden size D."""
    return D in WIDTHS or (WIDE_STEP < D <= WIDE_MAX and D % WIDE_STEP == 0)


def _plain_mlp(x, w1, b1, w2, b2, mlp_active):
    """The kernel's function in plain PyTorch (`_reference_mlp`,
    `pallas_mlp.py:233-237`), accumulating in f32 and rounding where the
    kernel does: GELU's output to the input type before fc2, and the result.
    For f32 inputs it is `_reference_mlp` exactly."""
    dtype = x.dtype
    h = F.gelu(F.linear(x.float(), w1.float(), b1.float()))
    cols = torch.arange(h.shape[-1], device=h.device)
    h = h * (cols < mlp_active).to(h.dtype)
    h = h.to(dtype).float()
    return F.linear(h, w2.float(), b2.float()).to(dtype)


def _check(x, w1, b1, w2, b2) -> None:
    """Raise on anything the kernel does not take."""
    D = x.shape[-1]
    M = w1.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_mlp: dtype {x.dtype} is not float32 or bfloat16")
    if not supported_width(D):
        raise ValueError(
            f"fused_mlp: hidden size {D} is not one of {WIDTHS} nor a "
            f"multiple of {WIDE_STEP} up to {WIDE_MAX}")
    shapes = {"w1": (w1, (M, D)), "b1": (b1, (M,)), "w2": (w2, (D, M)),
              "b2": (b2, (D,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_mlp: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"fused_mlp: {name} is {t.dtype} on {t.device}, "
                             f"x is {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_mlp: {name} is not contiguous")
    if x.numel() // D >= 2 ** 31:
        raise ValueError("fused_mlp: more than 2**31 - 1 token rows")


def _launch(x, w1, b1, w2, b2, active: int):
    global launches
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_mlp: kernel launch on {x.device}")
    _check(x, w1, b1, w2, b2)
    fn = _build.entry("fused_mlp", [ctypes.c_int] + [ctypes.c_void_p] * 6
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    # the kernel copies weights in 16-byte pieces: realign an odd view
    x, w1, b1, w2, b2 = (t if t.data_ptr() % 16 == 0 else t.clone()
                         for t in (x, w1, b1, w2, b2))
    D, M = x.shape[-1], w1.shape[0]
    out = torch.empty_like(x)
    n = x.numel() // D
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.device.index, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
             w2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, D, M,
             min(max(active, 0), M), _DTYPES[x.dtype], stream)
    _build.check("fused_mlp", err)
    launches += 1
    return out


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, active):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.active = active
        return _launch(x, w1, b1, w2, b2, active)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = _plain_mlp(*inputs, ctx.active)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None)


def fused_mlp(x, w1, b1, w2, b2, mlp_active=None):
    """gelu(x @ w1.T + b1), hidden columns >= mlp_active zeroed, @ w2.T + b2.

    x: (..., D).  `mlp_active` is an int or a 0-d tensor (None: all M
    columns); the kernel takes it as a host int.
    """
    M = w1.shape[0]
    active = M if mlp_active is None else mlp_active
    if x.device.type == "cpu":
        return _plain_mlp(x, w1, b1, w2, b2, active)
    return _FusedMlp.apply(x, w1, b1, w2, b2, int(active))

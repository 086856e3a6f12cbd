"""K1, the fused FFN (fc1 -> GELU -> fc2) as a CUDA kernel for Hopper, and
its variants K1b and K1c.

Counterpart of `vit3d_ensemble_tpu/ops/pallas_mlp.py`.  The kernels keep
the (tokens, mlp_dim) intermediate on chip; each source note says what
bounds it on the H100 and how it is laid out:

  * K1, `csrc/fused_mlp.cu` (`_mlp_kernel`, variant "seq");
  * K1b, `csrc/mlp_chunked.cu` (`_chunked_mlp_kernel`, "chunked"): fc2
    summed in f32 over chunks of `_CHUNK_M` hidden columns; in bf16 on
    K1c's `wgmma` pipeline (`csrc/mlp_pipeline.cuh`, on `k1c_plan`'s grid,
    at D <= 8 on `k1_d8_plan`'s) with fc2's accumulator restarted at each
    chunk and added into an f32 sum, in f32 on producer and consumer warps
    with both products in 3xTF32 on `mma.sync` (on the grid `k1b_f32_plan`
    lays out);
    at a wide D K1's wide bodies with fc2 summed chunk by chunk (in f32 its
    chunks are fc2's K splits);
  * K1c, `csrc/mlp_pipelined.cu` (`_pipelined2_mlp_kernel`, "pipelined2"):
    K1's function, software-pipelined in a persistent block (in bf16 a
    warp-specialised `wgmma` pipeline fed by TMA) on the grid that
    `k1c_plan` lays out (at D <= 8 `k1_d8_plan`, which splits the hidden
    columns across a cluster where the row tiles are few); in f32 K1's
    narrow body on K1c's row-tile groups;
    at a wide D K1's two GEMM phases in one persistent launch, fc1 of row
    tile i + L queued ahead of fc2 of row tile i and taken by ticket
    (`k1c_wide_plan`).

`_MLP_VARIANT`, a module constant as in the JAX package, says which one
`fused_mlp` launches; it is read at each call.  All three take every hidden
size from 1 up and the model axis.

Hidden sizes: K1, K1b and K1c take every D from 1 up (`supported_width`),
as the JAX kernels take any D.  The narrow bodies are built for D in
`WIDTHS` (8, 16, 32, 64, every registry config's); a narrow D between them
runs zero-padded to the next (`kernel_width`), not on the wide bodies: the
narrow bodies keep the (tokens, M) intermediate on chip where M / D is
large.  The wide bodies (D above 64, `csrc/mlp_wide.cuh`) take D whose rows
are a multiple of 16 bytes, so a D that 8 (bf16) or 4 (f32) does not divide
runs zero-padded to the next such D.
Padding is exact: zero columns of x and w1 add nothing to the hidden
activations, and the zero rows of w2 and b2 give output columns that the
wrapper drops; it costs a copy of x and the weights a call, at no registry
width.

Weights use the torch.nn.Linear layout: w1 (M, D), b1 (M,), w2 (D, M), b2
(D,).  With a leading model axis, w1 (P, M, D), b1 (P, M), w2 (P, D, M), b2
(P, D), x is (P, ..., D): one weight set per model, the sweep's stacked
(config, fold) cells, at every D.  `mlp_active` masks hidden columns at or
past it to exact zero, the runtime width mask of the sweep: an int for
every model, or an int tensor with one entry per model (or one for all),
which every body reads on the device, so a call never waits for the host.

The GELU follows the JAX kernels' rule (`pallas_mlp.py:179`): exact erf
in f32, and in bf16 their clamped odd polynomial (`poly_gelu`, at most
5.73e-4 from exact GELU), in the kernels and in the plain versions alike.

The wide calls (D above 64) of all three run on two GEMM phases on
`wgmma` fed by TMA, h through an L2-resident scratch, in f32 with both
products in 3xTF32 on the tensor cores (`wide_f32_plan` lays out K1's and
K1b's f32 grids, `k1c_wide_plan` K1c's queue); a model's tiles and K order
depend on (n, D, M) alone, so a model gives the same bits alone and in a
stacked call.

K1's narrow f32 calls (D up to 64) run on one body with K1c's f32 route
(`csrc/mlp_narrow_f32.cuh`, included by both libraries): both products in
3xTF32 on `wgmma`, the hidden columns split across the blocks of a
thread-block cluster on the grid `k1_narrow_f32_plan` lays out.

K1's narrow bf16 calls run on K1c's warp-specialised `wgmma` pipeline
(`csrc/mlp_pipelined.cu`), whatever their token rows: on an H100 it took
less device time than the `mma.sync` body of 64-row blocks that served
them before, at every row count from 1 to 33,280 (PERF.md); at D <= 8 on
its D = 8 instance, with the hidden columns split across a thread-block
cluster (`k1_d8_plan`).  A launch there counts as K1's (`launches`);
`launches_on_k1c` and `launches_own` split K1's launches by library
(`k1_body_launched` names the last body; `k1b_body_launched` and
`k1c_body_launched` K1b's and K1c's).

On a CPU tensor `fused_mlp` computes the variant's plain version
(`_plain_mlp`, or `_plain_mlp_chunked` for K1b); on a CUDA tensor it
launches the kernel or raises.  Backward, on either, differentiates the
exact-erf reference (`_plain_mlp` with `exact=True`), as the JAX custom VJP
does through `_reference_mlp` (`pallas_mlp.py:233-255`), whatever GELU the
forward took.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vit3d_ensemble_tpu_torch.ops import _build

#: Launches in this process of K1, K1b and K1c; each wrapper adds one per
#: kernel launch.
launches = 0
launches_k1b = 0
launches_k1c = 0
#: K1's launches by library: on K1c's (`K1_BODIES_ON_K1C`), and on its own
#: bodies in `csrc/fused_mlp.cu`; the two add up to `launches`.
launches_on_k1c = 0
launches_own = 0

#: The kernel `fused_mlp` launches (`pallas_mlp.py:122`).
_MLP_VARIANT = "seq"  # "seq" | "chunked" | "pipelined2"
#: K1b's summation chunk of hidden columns (`pallas_mlp.py:123`).
_CHUNK_M = 512

#: variant -> (the library in `csrc/`, its launch counter in this module)
_KERNELS = {"seq": ("fused_mlp", "launches"),
            "chunked": ("mlp_chunked", "launches_k1b"),
            "pipelined2": ("mlp_pipelined", "launches_k1c")}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: hidden sizes the narrow bodies are built for (every D of the 22 registry
#: configs); a narrow D between them runs on the next, zero-padded, and
#: every D above the last on K1's wide bodies (the stretch model's D = 768,
#: ViT-H's 1,280).
WIDTHS = (8, 16, 32, 64)
#: K1's bodies, as `k1_body_launched` names them; the first two run in
#: K1c's library (`launches_on_k1c`), the others in K1's (`launches_own`).
K1_BODIES = ("wgmma_pipeline", "wgmma_pipeline_d8", "narrow_tf32x3", "wide_wgmma",
             "wide_tf32x3")
K1_BODIES_ON_K1C = K1_BODIES[:2]
#: K1b's and K1c's bodies, as `k1b_body_launched` and `k1c_body_launched`
#: name them: bf16 at D 16-64, at D <= 8, f32 at D <= 64, and the wide bf16
#: and f32 bodies.
K1B_BODIES = ("chunked_wgmma", "chunked_wgmma_d8", "tf32x3_mma_sync", "wide_wgmma",
              "wide_tf32x3")
K1C_BODIES = ("wgmma_pipeline", "wgmma_pipeline_d8", "narrow_tf32x3", "wide_wgmma_queue",
              "wide_tf32x3_queue")
#: The bf16 body at D <= 8 (the D = 8 instance of `csrc/mlp_pipeline.cuh`,
#: K1's, K1b's and K1c's): token rows of a row tile, hidden columns of a
#: stage, the most splits of the hidden columns (blocks of a cluster; above
#: 8 a non-portable size), and the fewest stages a split of K1's and K1c's
#: (K1b's splits take whole `_CHUNK_M`-column chunks).
D8_TILE_ROWS = 128
D8_STAGE = 64
D8_MAX_SPLITS = 16
D8_MIN_SPLIT_STAGES = 2
#: The narrow f32 body of K1 and K1c (`narrow_tf32x3_kernel`,
#: `csrc/mlp_narrow_f32.cuh`): token rows of a row tile, hidden columns of a
#: chunk (fc2's K between the promotions of its 3xTF32 accumulators into an
#: f32 sum), and the most splits of the hidden columns (blocks of a cluster)
#: and the fewest chunks a split.
NARROW_F32_TILE_ROWS = 64
NARROW_F32_CHUNK = 32
NARROW_F32_MAX_SPLITS = 16
NARROW_F32_MIN_SPLIT_CHUNKS = 2
#: K1c's order on that body: row tiles a group walks in turn.
K1C_NARROW_F32_TILES = 2
#: K1's wide f32 body (`wide_tf32x3_kernel`): (rows, columns) of an output
#: tile, k of a pipeline stage, k between the promotions of its 3xTF32
#: accumulators into an f32 sum, and the most K splits of K1's phases, also
#: the most of a wave of K1b's fc2 splits (the partial sums its scratch
#: holds).
WIDE_F32_TILE = (128, 64)
WIDE_F32_STAGE_K = 32
WIDE_F32_PROMOTE_K = 128
WIDE_F32_MAX_SPLITS = 8
#: K1b's wide f32 fc2: stages of its summation chunk, each chunk a K split.
WIDE_F32_CHUNK_STAGES = 512 // WIDE_F32_STAGE_K
#: The wide bf16 bodies: token rows of a tile, fc1's tile columns, and fc2's
#: tile columns where one model's tiles fill the SMs (K1's and K1c's) or not.
WIDE_TILE_ROWS = 128
WIDE_FC1_COLS = 128
WIDE_FC2_COLS = (192, 64)
#: The H100's L2 cache, the bytes K1c's wide queue plans for where the card
#: does not say (the CPU tests): h of its lead fills at most half of it.
WIDE_L2_BYTES = 50 * 2**20
_last_body = None
_last_k1b_body = None
_last_k1c_body = None
#: K1b's f32 body (`chunked_tf32x3_kernel`): token rows of a block's unit
#: (one model's row tile, `k1b_f32_plan`).
K1B_F32_TILE_ROWS = 128

#: The TPU kernels' bf16 GELU (`pallas_mlp.py:_BF16_GELU_A`,
#: `_BF16_GELU_COEFS`): h * (0.5 + y * Q(y^2)), y = clamp(h, -A, A), Q's
#: coefficients from the constant term up.
_BF16_GELU_A = 3.6
_BF16_GELU_COEFS = (
    3.961523962e-01, -6.220111867e-02, 7.701753005e-03,
    -5.935066324e-04, 2.512920360e-05, -4.423316663e-07,
)


def supported_width(D: int) -> bool:
    """Whether the kernels (K1, K1b and K1c alike) take hidden size D:
    every D from 1 up."""
    return D >= 1


def kernel_width(D: int, dtype) -> int:
    """The hidden size the kernel runs hidden size D at: the next narrow
    width at or above a narrow D, else D rounded up to rows of a multiple
    of 16 bytes (8 bf16 values, 4 f32)."""
    if D <= WIDTHS[-1]:
        return next(w for w in WIDTHS if D <= w)
    step = 16 // (2 if dtype == torch.bfloat16 else 4)
    return -(-D // step) * step


def kernel_operands(x, w1, b1, w2, b2) -> tuple:
    """x and the weights at the kernel's width (`kernel_width`): where it
    is not D, zero-padded copies of x and w1 (columns) and of w2 and b2
    (rows), whose output columns past D the caller drops; else the tensors
    themselves.  With or without a model axis."""
    D = x.shape[-1]
    pad = kernel_width(D, x.dtype) - D
    if not pad:
        return x, w1, b1, w2, b2
    return (F.pad(x, (0, pad)), F.pad(w1, (0, pad)), b1,
            F.pad(w2, (0, 0, 0, pad)), F.pad(b2, (0, pad)))


def _active_bound(mlp_active, w1, device):
    """The width mask's bound, shaped to broadcast over the hidden
    activations: per-model widths become (P, 1, 1)."""
    if isinstance(mlp_active, torch.Tensor):
        mlp_active = mlp_active.to(device)
        if w1.dim() == 3 and mlp_active.dim() == 1:
            return mlp_active[:, None, None]
    return mlp_active


def poly_gelu(h):
    """The TPU kernels' bf16 GELU (`pallas_mlp.py:_poly_gelu`) on an f32
    tensor, in JAX's order of operations, each rounded to f32: Q by Horner's
    rule from its last coefficient.  No exponential; at most 5.73e-4 from
    exact GELU."""
    y = h.clamp(-_BF16_GELU_A, _BF16_GELU_A)
    v = y * y
    acc = torch.full_like(v, _BF16_GELU_COEFS[-1])
    for c in _BF16_GELU_COEFS[-2::-1]:
        acc = acc * v + c
    return h * (0.5 + y * acc)


def _hidden(x, w1, b1, mlp_active, exact: bool = False):
    """gelu(x @ w1^T + b1) in f32, masked, rounded to the input type (where
    every kernel rounds, `pallas_mlp.py:93`) and back to f32.  x is (..., D)
    or, with a model axis, (P, N, D).  The GELU is the kernels': `poly_gelu`
    for bf16 inputs, exact erf otherwise, or exact erf in every type with
    `exact`."""
    if w1.dim() == 3:
        h = torch.baddbmm(b1.float().unsqueeze(1), x.float(),
                          w1.float().transpose(1, 2))
    else:
        h = F.linear(x.float(), w1.float(), b1.float())
    h = poly_gelu(h) if x.dtype == torch.bfloat16 and not exact else F.gelu(h)
    cols = torch.arange(h.shape[-1], device=h.device)
    h = h * (cols < _active_bound(mlp_active, w1, h.device)).to(h.dtype)
    return h.to(x.dtype).float()


def _by_model(plain):
    """Run `plain` on x (P, ..., D) as (P, N, D) when the weights carry a
    model axis."""
    def run(x, w1, b1, w2, b2, mlp_active, **kw):
        if w1.dim() == 3:
            out = plain(x.reshape(w1.shape[0], -1, x.shape[-1]), w1, b1, w2,
                        b2, mlp_active, **kw)
            return out.reshape(x.shape)
        return plain(x, w1, b1, w2, b2, mlp_active, **kw)

    run.__doc__ = plain.__doc__
    return run


@_by_model
def _plain_mlp(x, w1, b1, w2, b2, mlp_active, exact: bool = False):
    """The kernels' function in plain PyTorch (`_mlp_kernel`,
    `pallas_mlp.py:87-94`), accumulating in f32 and rounding where the
    kernels do: GELU's output to the input type before fc2, and the result.
    For f32 inputs it is `_reference_mlp` (`:233-237`) exactly; bf16 takes
    the kernels' polynomial GELU.  K1's and K1c's plain version.  With
    `exact`, exact erf GELU in every type: the function the backward
    differentiates, as JAX's does `_reference_mlp`."""
    h = _hidden(x, w1, b1, mlp_active, exact)
    if w1.dim() == 3:
        out = torch.baddbmm(b2.float().unsqueeze(1), h,
                            w2.float().transpose(1, 2))
    else:
        out = F.linear(h, w2.float(), b2.float())
    return out.to(x.dtype)


@_by_model
def _plain_mlp_chunked(x, w1, b1, w2, b2, mlp_active):
    """K1b's plain version (`_chunked_mlp_kernel`, `pallas_mlp.py:126-139`):
    `_plain_mlp` with fc2's partial products summed in f32 chunk by chunk,
    `_CHUNK_M` hidden columns each, in the kernel's order."""
    h = _hidden(x, w1, b1, mlp_active)
    w2t = w2.float().transpose(-1, -2)
    acc = None
    for c in range(0, h.shape[-1], _CHUNK_M):
        part = h[..., c:c + _CHUNK_M] @ w2t[..., c:c + _CHUNK_M, :]
        acc = part if acc is None else acc + part
    return (acc + b2.float().unsqueeze(-2)).to(x.dtype)


def _check(x, w1, b1, w2, b2) -> None:
    """Raise on anything the kernels do not take."""
    D = x.shape[-1]
    M = w1.shape[-2]
    lead = tuple(w1.shape[:1]) if w1.dim() == 3 else ()
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_mlp: dtype {x.dtype} is not float32 or bfloat16")
    if not supported_width(D):
        raise ValueError(f"fused_mlp: hidden size {D}; K1, K1b and K1c take "
                         "every hidden size from 1 up")
    if lead and (x.dim() < 2 or x.shape[0] != lead[0]):
        raise ValueError(f"fused_mlp: x has shape {tuple(x.shape)}, expected "
                         f"({lead[0]}, ..., {D}) for {lead[0]} models")
    shapes = {"w1": (w1, lead + (M, D)), "b1": (b1, lead + (M,)),
              "w2": (w2, lead + (D, M)), "b2": (b2, lead + (D,))}
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
    if x.numel() // (D * (lead[0] if lead else 1)) >= 2 ** 31:
        raise ValueError("fused_mlp: more than 2**31 - 1 token rows a model")


def _active_arg(mlp_active, models: int, M: int, device):
    """(the width for every model, or 0 with an int32 tensor of one width
    per model on `device`).  A tensor width is never read on the host: every
    body reads it on the device."""
    if not isinstance(mlp_active, torch.Tensor):
        return min(max(int(mlp_active), 0), M), None
    per_model = mlp_active.to(device=device, dtype=torch.int32).reshape(-1)
    if per_model.numel() == 1:
        per_model = per_model.expand(models)
    if per_model.numel() != models:
        raise ValueError(f"fused_mlp: mlp_active has {per_model.numel()} "
                         f"entries for {models} models")
    return 0, per_model.contiguous()


def _wide_f32_phase(rows: int, col_tiles: int, k_stages: int, models: int,
                    sms: int, fc1: bool, M: int, chunk_stages: int = 0) -> dict:
    """One phase of `wide_f32_plan`."""
    tiles = rows * col_tiles
    if chunk_stages:
        splits = -(-k_stages // chunk_stages)
    else:
        splits = max(1, min(WIDE_F32_MAX_SPLITS, sms // max(tiles, 1),
                            k_stages * WIDE_F32_STAGE_K // WIDE_F32_PROMOTE_K))
    units = models * tiles * splits
    blocks = min(units, sms)
    return {"fc1": fc1, "M": M, "models": models, "tiles": tiles,
            "col_tiles": col_tiles, "k_stages": k_stages, "splits": splits,
            "split_stages": chunk_stages, "units": units, "blocks": blocks,
            "waves": units / sms,
            "split_wave": min(splits, WIDE_F32_MAX_SPLITS) if splits > 1 else 0}


def wide_f32_plan(n: int, D: int, M: int, sms: int, models: int = 1,
                  chunked: bool = False) -> dict:
    """The grids of the wide f32 body (K1's; K1b's with `chunked`) on a card
    of `sms` SMs, for `models` stacked models of n token rows: fc1 over each
    model's (n, M) in tiles of `WIDE_F32_TILE` (M rounded up to 64), K = D
    (rounded up to a stage, whose columns past D load as zeros); fc2 over
    (n, D) (D rounded up to a tile, whose columns past D are not stored), K
    = M.  Each phase is `units` units on `blocks` persistent blocks, at most
    one an SM: block b takes units b, b + blocks, ...  A phase whose tiles
    fill fewer than half the SMs splits its K into `splits` runs of stages
    (`wide_f32_unit`), at most `WIDE_F32_MAX_SPLITS` and never below
    `WIDE_F32_PROMOTE_K` of K each, whose partial sums a second launch adds
    in split order; K1b's fc2 splits its K into its 512-column chunks
    (`WIDE_F32_CHUNK_STAGES`), so the chunks are summed in order.  A phase
    runs its splits in waves of `split_wave` (at most
    `WIDE_F32_MAX_SPLITS`), each wave's partial sums added into a running
    sum in the output, so its scratch holds one wave (`wide_f32_scratch`)
    and the sum is one left fold in split order.  The splits depend on (n,
    D, M) alone, not on the models or their widths, so a model gives the
    same bits alone and stacked: a model's width stops its fc1 column tiles
    and its fc2 K stages (`wide_f32_unit`)."""
    bm, bn = WIDE_F32_TILE
    rows = -(-n // bm)
    fc1 = _wide_f32_phase(rows, -(-M // bn), -(-D // WIDE_F32_STAGE_K), models,
                          sms, True, M)
    fc2 = _wide_f32_phase(rows, -(-D // bn), -(-M // WIDE_F32_STAGE_K), models,
                          sms, False, M, WIDE_F32_CHUNK_STAGES if chunked else 0)
    return {"n": n, "D": D, "M": M, "models": models, "sms": sms,
            "row_tiles": rows, "fc1": fc1, "fc2": fc2}


def wide_f32_scratch(plan: dict, ld: int) -> int:
    """The f32 values of the wide f32 body's partial-sum scratch at
    `wide_f32_plan`'s plan, h's rows `ld` apart: one wave of the split
    phase's partial sums, fc1's (P, n, ld) or fc2's (P, n, D) each, the
    larger where both split; 0 where neither does.  fc2's is at most
    WIDE_F32_MAX_SPLITS P n D; fc1 splits only where its tiles fill fewer
    than half the SMs."""
    rows = plan["models"] * plan["n"]
    return max(plan["fc1"]["split_wave"] * ld, plan["fc2"]["split_wave"] * plan["D"]) * rows


def wide_f32_unit(phase: dict, u: int, active=None):
    """Unit u of a phase of `wide_f32_plan`, as the kernel takes it
    (`work_of` in `csrc/mlp_wide.cuh`): u = (split * models + model) *
    tiles + tile.  Returns (model, first row, first column, first stage,
    stage past the last).  With `active` (one int, or one a model) the
    model's width applies: an fc1 tile at or past it computes nothing
    (None), and fc2's stages stop at it."""
    tiles, models = phase["tiles"], phase["models"]
    t, ps = u % tiles, u // tiles
    p, s = ps % models, ps // models
    k, splits, step = phase["k_stages"], phase["splits"], phase["split_stages"]
    bm, bn = WIDE_F32_TILE
    row0, col0 = (t // phase["col_tiles"]) * bm, (t % phase["col_tiles"]) * bn
    k0, k1 = ((s * step, min((s + 1) * step, k)) if step
              else (s * k // splits, (s + 1) * k // splits))
    if active is not None:
        width = active[p] if isinstance(active, (list, tuple)) else active
        width = min(max(int(width), 0), phase["M"])
        if phase["fc1"] and col0 >= width:
            return None
        if not phase["fc1"]:
            k1 = max(k0, min(k1, -(-width // WIDE_F32_STAGE_K)))
    return p, row0, col0, k0, k1


def k1c_wide_plan(n: int, D: int, M: int, models: int, dtype, sms: int,
                  l2_bytes: int = WIDE_L2_BYTES) -> dict:
    """K1c's wide queue (`Queue` in `csrc/mlp_wide.cuh`) on a card of `sms`
    SMs: the (model, row tile) groups g = p * row_tiles + r in order, each
    with `fc1_units` units (column tiles of h: 128 wide in bf16, 64 in f32)
    and `fc2_units` (column tiles of out: K1's fc2 tiles, 192 or 64 wide in
    bf16 from (n, D) alone, 64 in f32), queued with a lead of `lead` groups:
    fc1 of groups 0 .. lead - 1, then for each g fc1(g + lead) and fc2(g)
    (`k1c_wide_unit`).  The lead is as many groups as half of the card's L2
    (`l2_bytes`) holds of h (128 rows of M rounded up to 16 bytes a group),
    at least two waves of the grid (L (fc1_units + fc2_units) >= 2 blocks)
    and at most the groups: an fc2 unit's fc1 units were queued long before
    it and have mostly ended when a block reaches it, and the h they wrote
    is still in L2.  `blocks` persistent blocks, one an
    SM (`resident`: the body's shared memory holds one block an SM), take the
    queue's units by ticket (a ticket a unit), each block the next one when
    its ring has room; an fc2 unit waits only on fc1 units of smaller
    tickets, so no wait can deadlock on any grid.  The schedule follows
    `blocks` and `models`; a unit's tile and K order do not, so a model
    gives the same bits alone and stacked."""
    rows = -(-n // WIDE_TILE_ROWS)
    if dtype == torch.bfloat16:
        fc1_cols = WIDE_FC1_COLS
        wide = rows * -(-D // WIDE_FC2_COLS[0]) >= sms
        fc2_cols = WIDE_FC2_COLS[0] if wide else WIDE_FC2_COLS[1]
    else:
        fc1_cols = fc2_cols = WIDE_F32_TILE[1]
    a, b = -(-M // fc1_cols), -(-D // fc2_cols)
    groups = models * rows
    units = groups * (a + b)
    blocks = min(units, sms)
    elt = 2 if dtype == torch.bfloat16 else 4
    group_bytes = WIDE_TILE_ROWS * -(-M * elt // 16) * 16   # a group's rows of h
    lead = min(groups, max(-(-2 * blocks // (a + b)), l2_bytes // 2 // group_bytes))
    return {"n": n, "D": D, "M": M, "models": models, "row_tiles": rows,
            "groups": groups, "fc1_units": a, "fc2_units": b,
            "fc1_cols": fc1_cols, "fc2_cols": fc2_cols, "units": units,
            "lead": lead, "blocks": blocks, "resident": sms,
            "waves": units / blocks}


def k1c_wide_unit(plan: dict, u: int) -> tuple:
    """Unit u of `k1c_wide_plan`'s queue, the unit of ticket u, as the kernel
    takes it (`queue_unit`): ("fc1" or "fc2", group, column tile)."""
    a, b, groups, lead = (plan["fc1_units"], plan["fc2_units"], plan["groups"],
                          plan["lead"])
    head, both = lead * a, (groups - lead) * (a + b)
    if u < head:
        return "fc1", u // a, u % a
    if u - head < both:
        i, r = divmod(u - head, a + b)
        return ("fc1", i + lead, r) if r < a else ("fc2", i, r - a)
    i, r = divmod(u - head - both, b)
    return "fc2", groups - lead + i, r


#: The wide entries' arguments, as ctypes types: K1's and K1b's bf16
#: (`*_wide_launch`), their f32 (`*_wide_f32_launch`), and K1c's (both).
_WIDE_BF16_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_void_p])
_WIDE_F32_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_K1C_WIDE_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _launch_wide(x, w1, b1, w2, b2, out, n: int, active: int, per_model,
                 models: int, variant: str, stream) -> int:
    """The variant's wide body (`csrc/mlp_wide.cuh`, through its library's
    `*_wide_launch` or `*_wide_f32_launch`): h through a (models, n, M')
    scratch, M' = M rounded up to rows of 16 bytes; a wave of K1's and K1b's
    f32 split phases' partial sums through a second scratch
    (`wide_f32_scratch`); K1c's
    ready counters, one a (model, row tile), and its ticket counter after
    them, all from 0.  Returns the entry point's CUDA error code."""
    D, M = x.shape[-1], w1.shape[-2]
    f32 = x.dtype == torch.float32
    step = 4 if f32 else 8
    ld = -(-M // step) * step
    if ld != M:
        # TMA reads rows whose stride is a multiple of 16 bytes: w2's rows
        # of M values are not, so the kernel reads a zero-padded copy
        w2 = F.pad(w2, (0, ld - M))
    h = torch.empty(models, n, ld, dtype=x.dtype, device=x.device)
    library = _KERNELS[variant][0]
    card = torch.cuda.get_device_properties(x.device)
    sms = card.multi_processor_count
    operands = (x.device.index, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), ld, b2.data_ptr(), h.data_ptr(), ld)
    shape = (n, D, M, active, None if per_model is None else per_model.data_ptr(),
             models)
    if variant == "pipelined2":
        plan = k1c_wide_plan(n, D, M, models, x.dtype, sms, card.L2_cache_size)
        ready = torch.zeros(plan["groups"] + 1, dtype=torch.int32, device=x.device)
        fn = _build.entry(library, _K1C_WIDE_ARGTYPES,
                          f"{library}_wide{'_f32' if f32 else ''}_launch")
        return fn(*operands, ready.data_ptr(), out.data_ptr(), *shape,
                  plan["lead"], plan["blocks"], stream)
    if not f32:
        fn = _build.entry(library, _WIDE_BF16_ARGTYPES, f"{library}_wide_launch")
        return fn(*operands, out.data_ptr(), *shape, stream)
    plan = wide_f32_plan(n, D, M, sms, models, chunked=variant == "chunked")
    fc1, fc2 = plan["fc1"], plan["fc2"]
    # a wave of a split phase's partial sums, one phase after the other in
    # one scratch
    size = wide_f32_scratch(plan, ld)
    part = torch.empty(size, dtype=x.dtype, device=x.device) if size else None
    fn = _build.entry(library, _WIDE_F32_ARGTYPES, f"{library}_wide_f32_launch")
    return fn(*operands, None if part is None else part.data_ptr(), out.data_ptr(),
              *shape, fc1["splits"], fc1["blocks"], fc2["splits"], fc2["blocks"],
              stream)


#: K1c's body (or K1b's bf16 pipeline) at (library, device, D, dtype): its
#: `<library>_shape`, asked once.
_K1C_SHAPES: dict = {}
K1C_SHAPE_KEYS = ("tile_rows", "threads_a_block", "smem_bytes_a_block",
                  "registers_at_entry", "blocks_an_sm", "sms")


def k1c_shape(device, D: int, dtype, library: str = "mlp_pipelined") -> dict:
    """K1c's body for (D, dtype) on `device`, or with `library`
    "mlp_chunked" K1b's bf16 pipeline (D 8-64): its row tile, threads,
    shared memory, registers, and the blocks an SM and SMs the runtime
    reports."""
    key = (library, device.index, D, dtype)
    if key not in _K1C_SHAPES:
        out = (ctypes.c_int * len(K1C_SHAPE_KEYS))()
        fn = _build.entry(library, [ctypes.c_int] * 3 + [ctypes.c_void_p],
                          f"{library}_shape")
        _build.check(library, fn(device.index, D, _DTYPES[dtype], out))
        _K1C_SHAPES[key] = dict(zip(K1C_SHAPE_KEYS, out))
    return _K1C_SHAPES[key]


def _blocks_a_model(n: int, models: int, tile_rows: int, slots: int) -> int:
    """`k1c_plan`'s blocks a model, alone: what a launch needs."""
    return max(1, min(-(-n // tile_rows), slots // models))


def k1c_plan(n: int, models: int, tile_rows: int, slots: int) -> dict:
    """K1c's persistent grid: grid y the models, grid x `blocks_a_model`
    blocks of each, as many as the resident `slots` (SMs times blocks an
    SM) hold when shared among the models, and never more than a model's row
    tiles; block b of B takes the tiles floor(b T / B) .. floor((b + 1) T / B),
    so the blocks' tiles differ by at most one.  Only where the models
    outnumber the slots does the grid exceed them: a block a model."""
    tiles = -(-n // tile_rows)
    per_model = _blocks_a_model(n, models, tile_rows, slots)
    return {"tile_rows": tile_rows, "tiles_a_model": tiles,
            "blocks_a_model": per_model, "blocks": per_model * models,
            "slots": slots, "waves": per_model * models / slots,
            "most_tiles_a_block": -(-tiles // per_model),
            "fewest_tiles_a_block": tiles // per_model}


def k1_d8_plan(n: int, M: int, models: int, clusters, chunked: bool = False) -> dict:
    """The grid of the bf16 body at D <= 8 (K1's and K1c's; K1b's with
    `chunked`) on a card that holds `clusters[s - 1]` clusters of s blocks
    of it at once (`k1_d8_clusters`; s = 1 .. `D8_MAX_SPLITS`, so
    `clusters[0]` is its resident blocks): a unit is (row tile of
    `D8_TILE_ROWS`, split of the hidden columns, model), the splits of a row
    tile the blocks of one thread-block cluster.  Split s of S takes the
    stages (`D8_STAGE` columns) [s C / S, (s + 1) C / S) of the C =
    ceil(M / 64), K1b's the same of its ceil(M / 512) summation chunks, so
    that its splits start on `_CHUNK_M`-column boundaries (`bounds`: each
    split's hidden columns).  S is the most splits, up to `D8_MAX_SPLITS`
    with at least `D8_MIN_SPLIT_STAGES` stages a split (K1b: a chunk), at
    which one cluster a row tile fits the card in one wave.  On an H100 that
    took the least time at every row count from 257 to 16,448 (PERF.md).
    S depends on n, M and the card alone, not on the models or their
    widths, so a model gives the same bits alone and in a stacked call; the
    kernel cuts a split at the model's width, and a split wholly past it
    joins the sum with zeros.
    With S > 1 each cluster takes one row tile (`groups` = the row tiles);
    with S = 1 the grid is `k1c_plan`'s on the resident blocks.  The grid
    is (S x groups, models) blocks."""
    tiles = -(-n // D8_TILE_ROWS)
    stages = -(-M // D8_STAGE)
    step = _CHUNK_M // D8_STAGE if chunked else 1
    units = -(-stages // step)
    most = min(D8_MAX_SPLITS, units if chunked else stages // D8_MIN_SPLIT_STAGES)
    splits = max([1] + [s for s in range(2, most + 1) if tiles <= clusters[s - 1]])
    groups = (tiles if splits > 1
              else _blocks_a_model(n, models, D8_TILE_ROWS, clusters[0]))
    bounds = [(step * (s * units // splits) * D8_STAGE,
               min(step * ((s + 1) * units // splits) * D8_STAGE, M))
              for s in range(splits)]
    return {"n": n, "M": M, "models": models, "chunked": chunked,
            "tile_rows": D8_TILE_ROWS, "tiles": tiles, "stages": stages,
            "splits": splits, "groups": groups, "bounds": bounds,
            "blocks_a_model": splits * groups, "blocks": splits * groups * models,
            "waves": splits * groups * models / clusters[0]}


#: The bf16 D = 8 body's cluster capacity at (library, device): its
#: `<library>_d8_clusters` at every split count, asked once.
_D8_CLUSTERS: dict = {}


def k1_d8_clusters(device, library: str = "mlp_pipelined") -> tuple:
    """The clusters of s blocks (s = 1 .. `D8_MAX_SPLITS`) of the bf16 D = 8
    body in `library` that `device` holds at once, as the runtime reports
    them (`cudaOccupancyMaxActiveClusters`): entry s - 1."""
    key = (library, device.index)
    if key not in _D8_CLUSTERS:
        fn = _build.entry(library, [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                          f"{library}_d8_clusters")
        held = []
        for s in range(1, D8_MAX_SPLITS + 1):
            out = ctypes.c_int(0)
            _build.check(library, fn(device.index, s, ctypes.byref(out)))
            held.append(out.value)
        _D8_CLUSTERS[key] = tuple(held)
    return _D8_CLUSTERS[key]


#: `mlp_pipelined_launch`'s and `mlp_chunked_launch`'s arguments, as ctypes
#: types.
_K1C_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _launch_k1c(x, w1, b1, w2, b2, out, n: int, active: int, per_model,
                models: int, stream, library: str = "mlp_pipelined") -> int:
    """K1c in bf16 (`mlp_pipelined_launch`) on `k1c_plan`'s grid (at D = 8
    `k1_d8_plan`'s), or with `library` "mlp_chunked" K1b in bf16
    (`mlp_chunked_launch`: the same pipeline with fc2 summed chunk by chunk,
    on the same grids).  Returns the entry point's CUDA error code."""
    D, M = x.shape[-1], w1.shape[-2]
    m8 = -(-M // 8) * 8
    # the wgmma body reads w2 and b1 by TMA, whose rows must start on 16
    # bytes: zero-padded copies where M is not a multiple of 8 (confs 19-22's
    # 2,204), a copy of a b1 view off that alignment
    if m8 != M:
        w2, b1 = F.pad(w2, (0, m8 - M)), F.pad(b1, (0, m8 - M))
    elif b1.data_ptr() % 16:
        b1 = b1.clone()
    if D == 8:
        plan = k1_d8_plan(n, M, models, k1_d8_clusters(x.device, library),
                          library == "mlp_chunked")
        blocks, splits = plan["groups"], plan["splits"]
    else:
        shape = k1c_shape(x.device, D, x.dtype, library)
        blocks = _blocks_a_model(n, models, shape["tile_rows"],
                                 shape["sms"] * shape["blocks_an_sm"])
        splits = 1
    fn = _build.entry(library, _K1C_ARGTYPES)
    return fn(x.device.index, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
              w2.data_ptr(), w2.shape[-1], b2.data_ptr(), out.data_ptr(), n, D,
              M, active, None if per_model is None else per_model.data_ptr(),
              models, blocks, splits, _DTYPES[x.dtype], stream)


def k1_narrow_f32_plan(n: int, D: int, M: int, active, models: int,
                       sms: int, groups: int = 0) -> dict:
    """The grid of the narrow f32 body (K1's, and K1c's with its `groups`)
    on a card of `sms` SMs: a unit is (row tile of `NARROW_F32_TILE_ROWS`,
    split of the M / `NARROW_F32_CHUNK` chunks, model).  The splits of a row
    tile are the blocks of one cluster, each a contiguous run of chunks:
    split s takes chunks [s C / S, (s + 1) C / S).  S grows until the tiles
    times the splits fill the SMs, up to `NARROW_F32_MAX_SPLITS`, with at
    least `NARROW_F32_MIN_SPLIT_CHUNKS` chunks a split.  S depends on n and
    M alone, not on the models or the widths, so a model gives the same bits
    alone and in a stacked call.  A split whose chunks all lie at or past a
    model's width (`active`: one int, or one a model) skips its products and
    joins the sum with zeros.  The grid is (S x groups, models) blocks: K1
    gives each row tile a group (`groups` 0), K1c fewer, each walking a
    contiguous run of row tiles."""
    tiles = -(-n // NARROW_F32_TILE_ROWS)
    chunks = -(-M // NARROW_F32_CHUNK)
    splits = max(1, min(NARROW_F32_MAX_SPLITS,
                        chunks // NARROW_F32_MIN_SPLIT_CHUNKS, -(-sms // tiles)))
    groups = groups or tiles
    widths = list(active) if isinstance(active, (list, tuple)) else [active] * models
    live = [-(-min(max(int(a), 0), M) // NARROW_F32_CHUNK) for a in widths]
    bounds = [(s * chunks // splits, (s + 1) * chunks // splits)
              for s in range(splits)]
    skipped = sum(k0 >= c for c in live for k0, _ in bounds)
    return {"n": n, "D": D, "M": M, "models": models, "sms": sms,
            "tile_rows": NARROW_F32_TILE_ROWS, "chunk": NARROW_F32_CHUNK,
            "tiles": tiles, "chunks": chunks, "splits": splits, "groups": groups,
            "units": tiles * splits * models, "skipped_units": skipped * tiles,
            "blocks": splits * groups * models,
            "waves": splits * groups * models / sms}


def k1_narrow_f32_unit(plan: dict, u: int, active) -> tuple:
    """Unit u of `k1_narrow_f32_plan` (u = ((model * tiles) + tile) * splits
    + split): (model, first row, row past the last, first hidden column,
    column past the last it computes).  The columns stop at the model's
    width (`active`: one int, or one a model), so a split past it computes
    none."""
    splits, tiles = plan["splits"], plan["tiles"]
    s, tile, p = u % splits, (u // splits) % tiles, u // (splits * tiles)
    width = active[p] if isinstance(active, (list, tuple)) else active
    live = -(-min(max(int(width), 0), plan["M"]) // plan["chunk"])
    k0 = s * plan["chunks"] // splits
    k1 = min((s + 1) * plan["chunks"] // splits, live)
    c0 = k0 * plan["chunk"]
    c1 = max(min(k1 * plan["chunk"], int(width), plan["M"]), c0)
    return (p, tile * plan["tile_rows"], min(plan["n"], (tile + 1) * plan["tile_rows"]),
            c0, c1)


#: `fused_mlp_narrow_f32_launch`'s and `mlp_pipelined_f32_launch`'s
#: arguments, as ctypes types.
_NARROW_F32_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                        + [ctypes.c_int] * 4
                        + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def k1c_narrow_f32_groups(n: int) -> int:
    """K1c's row-tile groups a model on the narrow f32 body: each walks
    `K1C_NARROW_F32_TILES` consecutive row tiles (the last group what is
    left), where K1 gives each row tile a group of its own."""
    tiles = -(-n // NARROW_F32_TILE_ROWS)
    return -(-tiles // K1C_NARROW_F32_TILES)


def _launch_narrow_f32(x, w1, b1, w2, b2, out, n: int, active: int, per_model,
                       models: int, stream, k1c: bool = False) -> int:
    """The narrow f32 body on `k1_narrow_f32_plan`'s grid, through K1's
    library (`fused_mlp_narrow_f32_launch`) or K1c's
    (`mlp_pipelined_f32_launch`, on K1c's row-tile groups).  Returns the
    entry point's CUDA error code."""
    D, M = x.shape[-1], w1.shape[-2]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = k1_narrow_f32_plan(n, D, M, M if per_model is not None else active,
                              models, sms)
    groups = k1c_narrow_f32_groups(n) if k1c else plan["tiles"]
    fn = (_build.entry("mlp_pipelined", _NARROW_F32_ARGTYPES, "mlp_pipelined_f32_launch")
          if k1c else _build.entry("fused_mlp", _NARROW_F32_ARGTYPES,
                                   "fused_mlp_narrow_f32_launch"))
    return fn(x.device.index, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
              w2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, D, M, active,
              None if per_model is None else per_model.data_ptr(), models,
              plan["splits"], groups, stream)


def k1b_f32_plan(n: int, models: int) -> dict:
    """K1b's f32 grid: one block a unit (row tile of `K1B_F32_TILE_ROWS`,
    model), grid x the row tiles, grid y the models."""
    tiles = -(-n // K1B_F32_TILE_ROWS)
    return {"tile_rows": K1B_F32_TILE_ROWS, "grid": (tiles, models),
            "units": tiles * models}


#: `mlp_chunked_f32_launch`'s arguments, as ctypes types.
_K1B_F32_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                     + [ctypes.c_int] * 4
                     + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _launch_k1b_f32(x, w1, b1, w2, b2, out, n: int, active: int, per_model,
                    models: int, stream) -> int:
    """K1b's f32 body (`mlp_chunked_f32_launch`, on `k1b_f32_plan`'s grid).
    Returns the entry point's CUDA error code."""
    D, M = x.shape[-1], w1.shape[-2]
    tiles, _ = k1b_f32_plan(n, models)["grid"]
    fn = _build.entry("mlp_chunked", _K1B_F32_ARGTYPES, "mlp_chunked_f32_launch")
    return fn(x.device.index, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
              w2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, D, M, active,
              None if per_model is None else per_model.data_ptr(), models, tiles,
              stream)


def _k1_body(dtype, D: int) -> str:
    """The body a K1 call at hidden size D takes: at a wide D, the `wgmma`
    GEMMs (in f32 their 3xTF32 form); in f32 at D <= 64, the narrow 3xTF32
    body; in bf16 at D 9-64, K1c's pipeline, and at D <= 8 its D = 8
    instance, the hidden columns split across a cluster."""
    D = kernel_width(D, dtype)
    if D not in WIDTHS:
        return "wide_wgmma" if dtype == torch.bfloat16 else "wide_tf32x3"
    if dtype != torch.bfloat16:
        return "narrow_tf32x3"
    return "wgmma_pipeline_d8" if D == 8 else "wgmma_pipeline"


def _variant_body(variant: str, dtype, D: int) -> str:
    """The body a call of the variant at hidden size D takes: K1's
    (`_k1_body`), or one of K1B_BODIES or K1C_BODIES, in that order: bf16 at
    D 16-64, bf16 at D <= 8, f32 at D <= 64, wide bf16, wide f32."""
    if variant == "seq":
        return _k1_body(dtype, D)
    D = kernel_width(D, dtype)
    bodies = K1B_BODIES if variant == "chunked" else K1C_BODIES
    f32 = dtype != torch.bfloat16
    if D not in WIDTHS:
        return bodies[4 if f32 else 3]
    return bodies[2] if f32 else bodies[1] if D == 8 else bodies[0]


def k1_body_launched() -> str:
    """The body that this process's last K1 launch took (one of
    K1_BODIES)."""
    if _last_body is None:
        raise RuntimeError("fused_mlp: K1 has not been launched")
    return _last_body


def k1b_body_launched() -> str:
    """The body that this process's last K1b launch took (one of
    K1B_BODIES)."""
    if _last_k1b_body is None:
        raise RuntimeError("fused_mlp: K1b has not been launched")
    return _last_k1b_body


def k1c_body_launched() -> str:
    """The body that this process's last K1c launch took (one of
    K1C_BODIES): K1's narrow f32 body in f32 at D <= 64 ("narrow_tf32x3"),
    "wgmma_pipeline" or, at D <= 8, "wgmma_pipeline_d8" in bf16, and at a
    wide D the queued wide bodies."""
    if _last_k1c_body is None:
        raise RuntimeError("fused_mlp: K1c has not been launched")
    return _last_k1c_body


def _launch(x, w1, b1, w2, b2, mlp_active, variant: str = "seq"):
    global _last_body, _last_k1b_body, _last_k1c_body, launches_on_k1c, launches_own
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_mlp: kernel launch on {x.device}")
    _check(x, w1, b1, w2, b2)
    name, counter = _KERNELS[variant]
    width = x.shape[-1]
    # zero-padded copies where the kernel runs at another width (see the
    # module note)
    x, w1, b1, w2, b2 = kernel_operands(x, w1, b1, w2, b2)
    # the kernels copy x and the weights in 16-byte pieces: realign an odd
    # view.  A model's slice of a contiguous stacked buffer starts 16-byte
    # aligned (D is a multiple of 8), so a stacked buffer is never copied;
    # the biases are read by element and never need it.
    x, w1, w2 = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x, w1, w2))
    models = w1.shape[0] if w1.dim() == 3 else 1
    D, M = x.shape[-1], w1.shape[-2]
    active, per_model = _active_arg(mlp_active, models, M, x.device)
    out = torch.empty_like(x)
    n = x.numel() // (D * models)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    body = _variant_body(variant, x.dtype, D)
    f32 = x.dtype == torch.float32
    if D not in WIDTHS:
        err = _launch_wide(x, w1, b1, w2, b2, out, n, active, per_model, models,
                           variant, stream)
    elif variant == "chunked" and f32:
        err = _launch_k1b_f32(x, w1, b1, w2, b2, out, n, active, per_model,
                              models, stream)
    elif body == "narrow_tf32x3":
        # K1's narrow f32 body, from K1's library or K1c's
        err = _launch_narrow_f32(x, w1, b1, w2, b2, out, n, active, per_model,
                                 models, stream, k1c=variant == "pipelined2")
    elif variant == "pipelined2" or body in K1_BODIES_ON_K1C:
        # K1c's library; on K1's routed calls, counted as K1's launch
        err = _launch_k1c(x, w1, b1, w2, b2, out, n, active, per_model,
                          models, stream)
        name = "mlp_pipelined"
    else:  # K1b in bf16
        err = _launch_k1c(x, w1, b1, w2, b2, out, n, active, per_model,
                          models, stream, library=name)
    _build.check(name, err)
    globals()[counter] += 1
    if variant == "chunked":
        _last_k1b_body = body
    elif variant == "pipelined2":
        _last_k1c_body = body
    else:
        _last_body = body
        if body in K1_BODIES_ON_K1C:
            launches_on_k1c += 1
        else:
            launches_own += 1
    return out if D == width else out[..., :width]


class _FusedMlp(torch.autograd.Function):
    """The variant's kernel on a CUDA tensor, its plain version on a CPU
    one; the backward of the exact-erf reference on both."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, mlp_active, variant):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.mlp_active = mlp_active
        if x.device.type == "cpu":
            plain = _plain_mlp_chunked if variant == "chunked" else _plain_mlp
            return plain(x, w1, b1, w2, b2, mlp_active)
        return _launch(x, w1, b1, w2, b2, mlp_active, variant)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = _plain_mlp(*inputs, ctx.mlp_active, exact=True)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None)


def fused_mlp(x, w1, b1, w2, b2, mlp_active=None):
    """gelu(x @ w1.T + b1), hidden columns >= mlp_active zeroed, @ w2.T + b2,
    on the kernel `_MLP_VARIANT` names.

    x: (..., D), or (P, ..., D) with weights stacked over P models.
    `mlp_active`: None (all M columns), an int, or an int tensor of one
    width for every model or one per model.
    """
    variant = _MLP_VARIANT
    if variant not in _KERNELS:
        raise ValueError(f"unknown fused_mlp variant: {variant!r}")
    active = w1.shape[-2] if mlp_active is None else mlp_active
    return _FusedMlp.apply(x, w1, b1, w2, b2, active, variant)

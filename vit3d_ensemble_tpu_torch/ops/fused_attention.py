"""K2 and K4, the fused attention kernels, as CUDA kernels for Hopper.

Counterpart of `vit3d_ensemble_tpu/ops/pallas_attention.py`: ctx =
softmax(q k^T / sqrt(hd)) v, dispatched by head_dim as the JAX wrapper does.

  * K2 (`csrc/tiny_attention.cu`), head_dim <= 16.  In bf16 at head_dim
    9-16 (the registry's 16) a warp runs a 16-row query tile of one head on
    the tensor cores (`mma.sync`; the probabilities stay in registers,
    rounded to bf16 unnormalised, as K4 rounds them); at the serving shape
    a persistent block streams (volume, head) items, loading the next by
    cp.async while it computes this one.  In f32, and in bf16 at head_dim
    <= 8 (the registry's 4 and 1), a thread takes R query rows of one head,
    the heads of a group sharing a warp, on CUDA cores with one `ex2` a
    score.  It reads q, k, v through their strides (unit stride along
    head_dim: a view without it is copied first) and writes the context
    (B, S, H, hd), as K4 does.  K3's core at head_dim <= 16 runs on this
    body too, on the views of its (B, T, 3D) QKV buffer (`k2_into`).
  * K4 (`csrc/attention.cu`), every head_dim above 16, as the JAX kernel
    takes any (the stretch model's 64 and ViT-H's 80 at 513 tokens): the
    keys are walked in chunks with an online softmax, so no S x S tile is
    stored.  Its bodies are built for the head dims `K4_BODY_HDS`; a
    head_dim up to the last runs on the first at or above it, its columns
    past hd zero in shared memory and the scale 1 / sqrt(hd) of the true hd
    (`k4_body_hd`).  Above the last, the sliced bodies: a block computes
    `K4_SLICE` columns of the context.  In bf16 (every head_dim) a block
    takes one (volume, head) and 128 query rows: a producer warp loads q and
    a ring of (k, v) chunks of 64 keys by TMA, and two consumer warpgroups
    of 64 rows run both products on `wgmma` (the probabilities stay in
    registers, rounded to bf16 unnormalised; a last chunk of at most 16
    live keys runs 16 wide).  In f32 up to head_dim 256 a block of 4 warps takes
    one (volume, head) and 64 query rows, 16 a warp, and runs both products
    on the tensor cores in 3xTF32 (`mma.sync` m16n8k8: each operand split
    into TF32 hi and lo, each product lo*hi + hi*lo + hi*hi in f32, which
    holds the JAX tolerance where one TF32 product does not), with (k, v)
    stages of 32 keys coming by cp.async and the scores and softmax in
    registers.  Above 256 the slices of a (volume, head) and 128 query rows
    are the blocks of one cluster (`k4_sliced_split`): each computes the
    partial scores over its own run of hd's boxes (32 columns in f32, 64 in
    bf16), the ranks add them in rank order through distributed shared
    memory, and each runs the softmax and its slice's p v on `wgmma` fed by
    TMA, in f32 both products in 3xTF32; in bf16 each rank loads its q
    boxes once.  It reads q, k, v through their strides (unit
    stride along head_dim; where TMA reads them, in bf16 and in f32 above
    256, a 16-byte aligned address and strides that are multiples of 16
    bytes, so the wrapper copies a view that is not into a buffer whose
    rows of hd values are padded to 16 bytes, `_k4_views`; the unsliced
    f32 body takes any, with 16-byte copies where the views allow them:
    `k4_body_launched`), as the model's
    `lin(x).view(B, T, H, hd).transpose(1, 2)` and K3's views into its QKV
    buffer give them, and writes the context
    (B, S, H, hd), returned as its (B, H, S, hd) view, so that the model's
    merge of the heads copies nothing (K2 likewise, from the model's views
    into its (B, T, 3, H, hd) QKV product).  K3's core at these head dims
    runs on this body (`k4_into`).

Each source note says what bounds its kernel on the H100.

q, k, v: (..., H, S, hd), the JAX package's public layout.  On a CPU tensor
`fused_attention` computes the kernel's plain version (`_plain_attention`
for K2, `_plain_attention_k4` for K4); on a CUDA tensor it launches the
kernel or raises.  Backward recomputes through the plain version, as the JAX
custom VJP does through its einsum (`pallas_attention.py:203-206`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from vit3d_ensemble_tpu_torch.ops import _build

#: K2 launches in this process; the wrapper adds one per kernel launch.
launches = 0
#: K4 launches in this process, counted likewise.
launches_k4 = 0

#: head_dim at or below which K2 serves.
TINY_HD = 16
#: head_dim above which K2's bf16 body runs on the tensor cores.
TC_HD = 8
#: head dims K4's unsliced bodies are built for (`csrc/attention.cu`,
#: `K4_HDS`); K4 takes every head_dim above TINY_HD, those above the last on
#: the sliced bodies, whose blocks compute K4_SLICE context columns each.
K4_BODY_HDS = (32, 64, 80, 128, 256)
K4_SLICE = 256
#: the sliced bodies' clusters hold at most this many slices (a portable
#: cluster), and their ranks split the scores' K loop in boxes of
#: K4_SLICED_BOX[dtype] columns of hd (`k4_sliced_split`); a rank of the
#: bf16 body keeps the q boxes of at most K4_BF16_RUN of them
K4_MAX_CLUSTER = 8
K4_SLICED_BOX = {torch.float32: 32, torch.bfloat16: 64}
K4_BF16_RUN = 4
#: most tokens K4 takes: the grid's second axis holds 65,535 row blocks, of
#: 64 query rows in f32 (4 warps of 16) and 128 in bf16.
MAX_TOKENS_K4 = 65535 * 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _plain_attention(q, k, v):
    """K2's function in plain PyTorch (`_reference_attention`,
    `pallas_attention.py:187-191`): scores, softmax and context in f32, the
    output rounded to the input type once, as the kernel does.  In bf16 at
    TC_HD < head_dim <= TINY_HD, where the kernel runs on the tensor cores,
    it rounds where they round: the unnormalised probabilities to bf16
    (`_plain_attention_k4`)."""
    hd = q.shape[-1]
    if q.dtype == torch.bfloat16 and TC_HD < hd <= TINY_HD:
        return _plain_attention_k4(q, k, v)
    scores = torch.einsum("...hqd,...hkd->...hqk", q.float(), k.float())
    probs = torch.softmax(scores / math.sqrt(hd), dim=-1)
    return torch.einsum("...hqk,...hkd->...hqd", probs, v.float()).to(q.dtype)


def _plain_attention_k4(q, k, v):
    """K4's function in plain PyTorch, f32 sums, rounding where the kernel
    rounds: the unnormalised probabilities exp(s - max) go to the input type
    before the second product, the row sums stay f32, and the context is
    divided by them and rounded once.  The JAX kernel rounds the normalised
    probabilities instead (`pallas_attention.py:133`); for f32 inputs both are
    `_reference_attention` up to the order of the sums."""
    hd = q.shape[-1]
    scores = torch.einsum("...hqd,...hkd->...hqk", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    # a softmax ignores a shift of all scores: the max carries no gradient
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True).detach())
    ctx = torch.einsum("...hqk,...hkd->...hqd", e.to(q.dtype).float(),
                       v.float())
    return (ctx / e.sum(dim=-1, keepdim=True)).to(q.dtype)


def _plain(q, k, v):
    """The plain version of the kernel that serves q's head_dim."""
    if q.shape[-1] <= TINY_HD:
        return _plain_attention(q, k, v)
    return _plain_attention_k4(q, k, v)


def k4_body_hd(hd: int) -> int:
    """The head_dim K4's body computes at head_dim `hd` (above 16), its
    columns past hd zero: the first of K4_BODY_HDS at or above hd, and
    above the last, hd rounded up to the sliced bodies' 64-column boxes."""
    if hd > K4_BODY_HDS[-1]:
        return -(-hd // 64) * 64
    return next(b for b in K4_BODY_HDS if hd <= b)


def k4_slices(hd: int) -> int:
    """Blocks of K4 a (volume, head) and row block: 1 on the unsliced
    bodies, ceil(hd / K4_SLICE) on the sliced ones."""
    return 1 if hd <= K4_BODY_HDS[-1] else -(-hd // K4_SLICE)


def k4_sliced_split(hd: int, dtype=torch.float32) -> dict:
    """The sliced body's cluster for `dtype` at head_dim `hd` (above
    K4_BODY_HDS[-1]), as `csrc/attention.cu` lays it out: the k4_slices(hd)
    slices in `groups` groups of `cluster` ranks (as even as they divide),
    rank r computing the context columns of slice group * cluster + r and
    the partial scores over boxes [b0, b1) of hd's
    K4_SLICED_BOX[dtype]-column boxes, `boxes[r]`."""
    slices = k4_slices(hd)
    groups = -(-slices // K4_MAX_CLUSTER)
    cluster = -(-slices // groups)
    nbox = -(-hd // K4_SLICED_BOX[dtype])
    return {"cluster": cluster, "groups": groups, "nbox": nbox,
            "boxes": [(r * nbox // cluster, (r + 1) * nbox // cluster)
                      for r in range(cluster)]}


def _check(q, k, v) -> None:
    """Raise on anything the kernels do not take."""
    if q.dim() < 2:
        raise ValueError(f"fused_attention: q has shape {tuple(q.shape)}")
    hd = q.shape[-1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"fused_attention: dtype {q.dtype} is not float32 "
                        "or bfloat16")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"fused_attention: {name} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, q is {tuple(q.shape)} {q.dtype} on {q.device}")
    if hd > TINY_HD:
        # K4 reads through the strides (by TMA in bf16 and in f32 above
        # head_dim 256, from a copy where they are not TMA's, `_k4_views`);
        # K2's wrapper copies a view whose head_dim stride is not 1
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(-1) != 1:
                raise ValueError(
                    f"fused_attention: {name} has stride {t.stride(-1)} "
                    "along head_dim, K4 needs 1")
        # the grid's second axis holds 65,535 row blocks: 64 rows in f32
        if q.shape[-2] > MAX_TOKENS_K4:
            raise ValueError(f"fused_attention: {q.shape[-2]} tokens, K4 "
                             f"takes {MAX_TOKENS_K4}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _k2_plan(q, k, v):
    """What K2 is launched on: the (B, H, S, hd) views of q, k, v that the
    kernel reads through their strides (a view whose head_dim stride is not
    1 is copied first, the only copy) and the (B, S, H, hd) buffer it
    writes."""
    views = []
    for t in (q, k, v):
        t = _as_bhsd(t)
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            t = t.contiguous()
        views.append(t)
    B, H, S, hd = views[0].shape
    out = torch.empty(B, S, H, hd, dtype=q.dtype, device=q.device)
    return views, out


#: the bodies of `csrc/tiny_attention.cu`, by the code its dispatch reports
K2_BODIES = ("simt", "tc_by_element", "tc", "tc_stream")

_K2_ARGS = {
    # (B, H, S, hd) views and their (volume, head, token) strides
    "tiny_attention_launch": [ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    # (B, T, D) views of a QKV buffer and their volume and token strides
    "tiny_attention_qkv_launch": [ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
    + [ctypes.c_int, ctypes.c_void_p],
}


def k2_into(q, k, v, out, n_heads: int = 0) -> None:
    """Launch K2's kernel on q, k, v, writing the context into `out`, a
    contiguous (B, S, H, hd) tensor (B * H * S > 0): q, k, v are (B, H, S,
    hd) views with unit stride along head_dim, or, given `n_heads`, (B, S,
    D) views that share their strides (K3's views of its QKV buffer), read
    as their `n_heads` heads of D / n_heads without making the head views.
    The kernel picks its body from the dtype, head_dim, tokens and the
    views' alignment (`k2_body_launched` reports it): whether every view's
    base is 16-byte aligned and its volume and token strides multiples of
    16 bytes, so that rows may be read 16 bytes at a time where its layout
    allows (K3's entry works that out itself).  Counts nothing: each caller
    counts its own launches (this module's `launches`, and K3's wrapper,
    whose head dims up to 16 take this kernel)."""
    if n_heads:
        B, S, D = q.shape
        symbol = "tiny_attention_qkv_launch"
        err = _build.entry("tiny_attention", _K2_ARGS[symbol], symbol)(
            q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, D, n_heads, q.stride(0), q.stride(1),
            _DTYPES[q.dtype], _stream(q.device))
    else:
        B, H, S, hd = q.shape
        if B * H >= 2 ** 31:
            raise ValueError("fused_attention: more than 2**31 - 1 batch-heads")
        elt = q.element_size()
        aligned = all(t.data_ptr() % 16 == 0 and t.stride(0) * elt % 16 == 0
                      and t.stride(2) * elt % 16 == 0 for t in (q, k, v))
        symbol = "tiny_attention_launch"
        err = _build.entry("tiny_attention", _K2_ARGS[symbol], symbol)(
            q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, H, S, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
            int(aligned), _stream(q.device))
    _build.check("tiny_attention", err)


def k2_body_launched() -> str:
    """The body of `csrc/tiny_attention.cu` that this process's last K2
    launch took, as the kernel's dispatch reports it (one of K2_BODIES)."""
    body = _build.entry("tiny_attention", [], "tiny_attention_last_body")()
    if body < 0:
        raise RuntimeError("fused_attention: K2 has not been launched")
    return K2_BODIES[body]


def _launch_k2(q, k, v):
    global launches
    shape = q.shape
    (q, k, v), out = _k2_plan(q, k, v)
    B, H, S, hd = q.shape
    if B * H * S:               # else nothing to compute, nothing launched
        k2_into(q, k, v, out)
        launches += 1
    return out.transpose(1, 2).reshape(shape)


def _as_bhsd(t):
    """(..., H, S, hd) -> (B, H, S, hd): leading axes fold into one, as a
    view where the strides allow it."""
    if t.dim() == 4:
        return t
    if t.dim() < 4:
        return t[(None,) * (4 - t.dim())]
    return t.flatten(0, t.dim() - 4)


def _tma_rows(t) -> bool:
    """Whether TMA reads the view `t` as it is: a 16-byte aligned address
    and strides that are multiples of 16 bytes."""
    per16 = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per16 == 0 for s in t.stride()[:-1])


def _k4_views(q, k, v) -> list:
    """The (B, H, S, hd) views K4 is launched on.  Where TMA feeds the body
    (bf16; f32 above K4_BODY_HDS[-1]), a view that TMA cannot read
    (`_tma_rows`: at a head_dim whose rows are not a multiple of 16 bytes,
    or off 16-byte alignment) is copied into a buffer whose rows of hd
    values lie a multiple of 16 bytes apart, the kernel reading its first
    hd columns: a copy of the input, never a fall to the plain version.  The
    unsliced f32 body reads its views as they are."""
    if q.dtype != torch.bfloat16 and q.shape[-1] <= K4_BODY_HDS[-1]:
        return [q, k, v]
    per16 = 16 // q.element_size()
    views = []
    for t in (q, k, v):
        if not _tma_rows(t):
            hd = t.shape[-1]
            buf = torch.empty(*t.shape[:-1], -(-hd // per16) * per16, dtype=t.dtype,
                              device=t.device)
            t = buf[..., :hd].copy_(t)
        views.append(t)
    return views


def k4_into(q, k, v, out) -> None:
    """Launch K4's kernel on (B, H, S, hd) views q, k, v (checked by
    `_check`, in bf16 readable by TMA, `_k4_views`; B * H * S > 0), writing
    the context into `out`, a contiguous (B, S, H, hd) tensor.  Counts
    nothing: each caller counts its own launches (this module's
    `launches_k4`, and K3's wrapper, whose head dims above 16 take this
    body)."""
    B, H, S, hd = q.shape
    if B * H * k4_slices(hd) >= 2 ** 31:
        raise ValueError("fused_attention: more than 2**31 - 1 batch-heads "
                         "(times the slices of a head)")
    fn = _build.entry("attention",
                      [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                      + [ctypes.c_longlong] * 9
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), B, H, S, hd, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
             _stream(q.device))
    _build.check("attention", err)


#: the bodies of `csrc/attention.cu`, by the code its dispatch reports: bf16
#: on `wgmma`, f32 in 3xTF32 on `mma.sync` with 16-byte copies, and with
#: 4-byte copies (a view whose base or strides are not multiples of 16
#: bytes); then above K4_BODY_HDS[-1] the sliced bf16 body and the sliced
#: f32 one (3xTF32), both on `wgmma` in a cluster of the slices
K4_BODIES = ("bf16_wgmma", "f32_tf32x3", "f32_tf32x3_4byte",
             "bf16_sliced_wgmma", "f32_sliced_wgmma")


def k4_body_launched() -> str:
    """The body of `csrc/attention.cu` that this process's last K4 launch
    (K3's above head_dim 16 included) took, as the kernel's dispatch
    reports it (one of K4_BODIES)."""
    body = _build.entry("attention", [], "attention_last_body")()
    if body < 0:
        raise RuntimeError("fused_attention: K4 has not been launched")
    return K4_BODIES[body]


def _launch_k4(q, k, v):
    global launches_k4
    shape = q.shape
    q, k, v = (_as_bhsd(t) for t in (q, k, v))
    B, H, S, hd = q.shape
    if B * H * S == 0:          # nothing to compute, nothing launched
        return q.new_empty(shape)
    out = torch.empty(B, S, H, hd, dtype=q.dtype, device=q.device)
    k4_into(*_k4_views(q, k, v), out)
    launches_k4 += 1
    return out.transpose(1, 2).reshape(shape)


def _launch(q, k, v):
    if q.device.type != "cuda":
        raise RuntimeError(f"fused_attention: kernel launch on {q.device}")
    _check(q, k, v)
    if q.shape[-1] <= TINY_HD:
        return _launch_k2(q, k, v)
    return _launch_k4(q, k, v)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = _plain(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_attention(q, k, v):
    """softmax(q k^T / sqrt(hd)) v; q, k, v: (..., H, S, hd), hd <= 16 (K2)
    or above (K4)."""
    if q.device.type == "cpu":
        return _plain(q, k, v)
    return _FusedAttention.apply(q, k, v)

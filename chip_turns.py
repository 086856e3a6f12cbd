#!/usr/bin/env python3
"""One turn of a parent/change comparison of the port on one NVIDIA GPU.

    python3 chip_turns.py ROOT TURN [--repeats R]

Measures the `vit3d_ensemble_tpu_torch` package of the checkout at ROOT
(this checkout, or an older commit unpacked with `git archive` into a
directory that `.gitignore` lists) with this checkout's yardsticks, the
helpers of the `chip_smoke.py` beside this script (`device_time`,
`time_ms`, `host_ms`, `latency`, `timed_passes`), so that two checkouts are
timed alike:

  * K1 in bf16 at the latency path's calls (B = 1, 4 and 8 volumes of 65
    tokens at conf 9's (D, M) = (16, 2,048)) and at the serving pass's
    (33,280 rows, M = 3,072, D = 16, 32 and 64): ms by CUDA events, device
    ms under the profiler (10 calls), host ms to make a call;
  * K1 in f32 at the stretch path's wide shapes, (4,104, 513 and 70 rows,
    768, 3,072) at full width and masked to 2,072, and at the other wide
    shapes of the card tests (`tests/test_torch_kernels.py`,
    `WIDE_K1_CASES`): the same, with the device ms of the f32 chain
    F.linear -> F.gelu -> F.linear (width-masked) beside, and the largest
    error over the f32 gate against ROOT's plain version;
  * K1 and K1c (variant "pipelined2") in f32 at the narrow widths (phase
    `k1_f32_narrow`): the training path's 260 rows at (D, M) = (16, 2,048)
    and (64, 3,072), 4,160 rows at both, one model at three of the
    drivers' evaluation shapes, and the sweep's model axis (30 models of
    1,560 rows, D = 64, widths 2,048 and 3,072): device ms under the
    profiler (10 calls), ms by CUDA events, the device ms of the library
    chain, the body K1 took and the largest error over the f32 gate
    against ROOT's `_plain_mlp`;
  * where the narrow f32 body's time goes (phase `k1_f32_narrow_parts`, with
    ROOT this checkout, on its `csrc/mlp_narrow_f32.cuh`): copies of
    the header with one part taken out each (`NARROW_PARTS`: the GELU,
    fc1's or fc2's wgmmas, the hi/lo split of the weights, the staging of
    chunks after the first two, b1), built side by side into
    `build/narrow_parts/` and timed by CUDA events (20 launches) against the
    whole body at four of `K1_NARROW_F32_CASES`' shapes; a part's share is
    the whole's time less the copy's (the compiler may then drop what fed
    the part, and registers move), and no copy's output is right;
  * K1b in f32 (variant "chunked") at the sweep's model-axis shape (30
    models of 1,560 rows, D = 64, widths 2,048 and 3,072), the serving
    shape (33,280, 64, 3,072) and the f32 shapes of the card tests
    (`tests/test_torch_kernels.py`): device ms under the profiler (10
    calls), ms by CUDA events, the device ms of the library chain (F.linear
    -> F.gelu -> F.linear, or `baddbmm` -> F.gelu -> `baddbmm` with the
    widths folded into w2, as `chip_smoke.k1_case` times it) and the largest
    error over the f32 gate against ROOT's `_plain_mlp_chunked`;
  * K1b in bf16 (variant "chunked", phase `k1b_bf16`) at the serving
    shape (33,280 rows, M = 3,072) at D = 64, 32 and 16, masked to 2,072 at
    D = 64, and at 4,160 rows: device ms under the profiler (10 calls), ms
    by CUDA events, the body it took, the largest error over the bf16 gate
    against ROOT's `_plain_mlp_chunked`, beside K1's device ms on the same
    inputs and the device ms of the chain F.linear -> F.gelu -> F.linear
    (width-masked);
  * K1c's wide queue (variant "pipelined2") beside K1 (phase `k1c_wide`) at
    the stacked stretch members' and ViT-H's wide cases, bf16 and f32:
    (4,104 and 513 rows, 768, 3,072) with five models of widths 3,072,
    3,072, 2,072, 2,072 and 0, and (4,104, 1,280, 5,120) with two of 5,120
    and 4,120: device ms of each under the profiler (10 calls), ms by CUDA
    events, the largest error over the gate against ROOT's `_plain_mlp`,
    whether K1c gave K1's bits, and the device ms of the `baddbmm` chain
    (the widths folded into w2);
  * K1c's wide queue at several leads (phase `k1c_wide_leads`; ROOT's
    entries must take a lead, as this checkout's do) at those cases and
    at one model of each: 1, two waves of the grid, the plan's and every
    group, each by CUDA events over 20 launches through the entry (a
    zeroed counter buffer each, made before the timed run), whether each
    gave K1's bits where K1 splits no K, beside K1's device ms;
  * K1b's wide bodies' bits (phase `k1b_wide_bits`): K1b's output at every
    case of `chip_smoke.wide_cases` (the inputs `chip_smoke.wide_case`
    draws) and the logits and tokens of the stacked stretch members' pass
    of `chip_smoke.phase_wide_axis` under K1b, bf16 and f32, each as the
    SHA-256 of its bytes: two checkouts that print the same digests gave
    the same bits;
  * the bf16 D <= 8 bodies (phase `d8`): K1, K1b and K1c at conf 22's FFN
    (D 8, M 2,204) at 2,056 and 131,584 rows (B = 8 and 512 volumes of
    257 tokens), and beside them K1 in bf16 at (33,280, 64, 3,072),
    (4,160, 64, 3,072) and (520, 16, 2,048) (the D 16-64 pipeline): device
    ms under the profiler (10 calls), ms by CUDA events, the body each
    took, the largest error over the bf16 gate against ROOT's plain
    version and the SHA-256 of each output (the inputs are drawn from a
    generator of the phase's own, so two checkouts that print the same
    digest gave the same bits), with the chain's device ms at D 8;
  * the bf16 D = 8 body at several splits (phase `d8_splits`; ROOT's
    entries must take a split count, as this checkout's do): K1c's and
    K1b's entries at conf 22's FFN at 257 to 16,448 rows (3 to 129 row
    tiles), each at 1-8 and 16 splits (one cluster a row tile; one split on
    `k1c_plan`'s grid), by CUDA events over 100 launches, three rounds in
    turns, beside the clusters of each size the card holds at once
    (`k1_d8_clusters`) and the split count `k1_d8_plan` takes;
  * the wgmma pipeline's D 16-64 instantiations in ROOT's K1c and K1b
    libraries (phase `pipeline_sass`): each one's SASS lines, and the
    SHA-256 of its SASS with addresses and mangled names taken out, so two
    checkouts that print the same digest compiled the same code;
  * K4's sliced f32 body (phase `k4_sliced`) at (1, 24, 513, 512), (1, 8,
    513, 264), (1, 8, 513, 1,024) and (1, 24, 65, 512) on the model's
    views: device ms under the profiler (10 calls), the body it took, the
    SHA-256 of its output (inputs from a generator of the shape's own), the
    largest error over the f32 gate against ROOT's plain version, SDPA's
    device ms and backend on the same views, the 3xTF32 bound (three TF32
    products at the TF32 peak, or the bytes) and, where ROOT's library has
    `attention_sliced_f32_plan`, the cluster plan and its waves; then the
    `widest` model's f32 pass at B = 1 under `auto` and `layer` (K4's
    device ms, its share of the busy ms, the busy ms);
  * where the sliced f32 body's time goes (phase `k4_sliced_parts`, with
    ROOT this checkout, on its `csrc/attention.cu`): copies of the source
    with one part taken out each (`K4_SLICED_PARTS`: the hand-over between
    the ranks, or only its waits, or its reads of the other ranks' slots
    (each rank adding its own partial `cluster` times), the splitters'
    hi/lo splits, q's split in registers, the scores' or p v's wgmmas),
    built side by side into
    `build/k4_sliced_parts/` and timed by CUDA events (20 launches) against
    the whole body at the four shapes; as with the narrow body's parts, no
    copy's output is right;
  * K4's sliced bf16 body (phase `k4_sliced_bf16`) at (2, 24, 513, 512),
    (2, 8, 513, 264), (2, 8, 513, 1,024) and (2, 24, 65, 512), as phase
    `k4_sliced` times the f32 body, with the bound of the bytes or of the
    two products at the bf16 peak, the bf16 gate, and, where ROOT's library
    has `attention_sliced_bf16_plan`, its cluster plan and waves; then the
    `widest` model's bf16 pass at B = 2 under `auto` and `layer`;
  * where the sliced bf16 body's time goes, and its other forms (phase
    `k4_sliced_bf16_parts`, with ROOT this checkout), as `k4_sliced_parts`
    does for f32 (`K4_SLICED_BF16_PARTS`: whole bodies at other keys a
    chunk and lags (64 keys at lag 0; 32 keys at lags 1-3, their rings
    deeper) and producer / consumer register splits, each held to the bf16
    gate; copies without the hand-over, the other ranks' reads, the
    scores' or p v's wgmmas); a copy at a time over the four shapes, its
    line emitted before the next runs;
  * the SASS of every K4 body but the sliced bf16 one (phase `k4_sass`):
    each instantiation's SASS lines and the SHA-256 of its SASS with the
    addresses and mangled names taken out, as `pipeline_sass` does;
  * the 18-model bf16 pass at B=512: device time of one pass under `auto`
    and under `layer`, and wall ms a pass (three runs of 20 passes);
  * latency: conf 9 and the {5,9,11} ensemble at B = 1, 4 and 8, ms a
    batch over R rounds (each round every model and batch once), and conf
    9's device time a batch at B = 1;
  * the stretch model `vit_b16_128cubed` in f32 at B = 1: device time of
    one pass under `auto` (K4) and `layer` (K3's core on K4's body), with
    the group of K4's kernels, and K4 in f32 alone at the stretch shape
    (8, 12, 513, 64) and as K3 runs it at B = 1 (1, 513, 768, 12), device
    ms under the profiler (10 calls).

Prints one JSON line a measurement, tagged with TURN.  Run it in turns
(parent, change, change, parent, ...) in one call and compare like lines.
`--phases k1_f32_narrow,pass` runs only those phases (all by default:
`PHASES`).  Exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import pathlib
import statistics
import sys
import zlib

K1_SHAPES = ((65, 16, 2048), (260, 16, 2048), (520, 16, 2048),
             (33280, 16, 3072), (33280, 32, 3072), (33280, 64, 3072))
# (N, D, M, active)
K1_F32_SHAPES = ((4104, 768, 3072, 3072), (4104, 768, 3072, 2072),
                 (513, 768, 3072, 3072), (513, 768, 3072, 2072),
                 (70, 768, 3072, 3072), (70, 768, 3072, 2072),
                 (70, 768, 256, 200), (70, 128, 512, 512), (33, 1024, 96, 96),
                 (50, 192, 100, 77), (40, 256, 2204, 2000), (40, 768, 64, 0),
                 (128, 128, 128, 77), (1, 768, 3072, 3072), (300, 128, 3072, 3072))
# K1b's f32 cases: (N, D, M, width, models), the width a list of one a
# model with the model axis
K1B_F32_CASES = ((1560, 64, 3072, [2048] * 15 + [3072] * 15, 30),
                 (33280, 64, 3072, 3072, 0), (33280, 64, 3072, 2072, 0),
                 (202, 8, 2204, 2204, 0), (202, 16, 2048, 2048, 0),
                 (202, 32, 3072, 1000, 0), (202, 64, 1100, 1100, 0),
                 (202, 64, 3072, 0, 0), (202, 16, 2204, 2000, 0),
                 (40000, 16, 600, 513, 0), (1560, 64, 3072, 3072, 0),
                 (1560, 8, 2204, [2204, 1504, 0, 513], 4),
                 (1560, 16, 1100, [1100, 400, 0, 513], 4),
                 (1560, 32, 2048, [2048, 1348, 0, 513], 4),
                 (1560, 64, 3072, [3072, 2372, 0, 513], 4),
                 (300, 64, 1100, [0, 1030, 1100], 3))
# K1b's bf16 cases: (N, D, M, width)
K1B_BF16_CASES = ((33280, 64, 3072, 3072), (33280, 32, 3072, 3072),
                  (33280, 16, 3072, 3072), (33280, 64, 3072, 2072),
                  (4160, 64, 3072, 3072))
# K1's and K1c's narrow f32 cases: (N, D, M, width, models), the width a
# list of one a model with the model axis
K1_NARROW_F32_CASES = ((260, 16, 2048, 2048, 0), (260, 64, 3072, 3072, 0),
                       (4160, 16, 2048, 2048, 0), (4160, 64, 3072, 3072, 0),
                       (585, 16, 2048, 2048, 0), (585, 64, 2048, 2048, 0),
                       (1430, 32, 2048, 2048, 0),
                       (1560, 64, 3072, [2048] * 15 + [3072] * 15, 30))
BUILD = ["fused_mlp", "mlp_chunked", "mlp_pipelined", "tiny_attention",
         "attention"]
# K1c's wide cases: (dtype name, N, D, M, one width a model)
K1C_WIDE_CASES = tuple((dtype, N, D, M, widths) for dtype in ("bfloat16", "float32")
                       for N, D, M, widths in (
                           (4104, 768, 3072, [3072, 3072, 2072, 2072, 0]),
                           (513, 768, 3072, [3072, 3072, 2072, 2072, 0]),
                           (4104, 1280, 5120, [5120, 4120])))
# Phase `d8`: (variant, N, D, M) at D 8 (conf 22's FFN), then K1 at D 16-64
D8_CASES = tuple((v, N, 8, 2204) for v in ("seq", "chunked", "pipelined2")
                 for N in (2056, 131584))
D16_64_CASES = (("seq", 33280, 64, 3072), ("seq", 4160, 64, 3072), ("seq", 520, 16, 2048))
K1C_LEAD_CASES = K1C_WIDE_CASES + (("bfloat16", 4104, 768, 3072, [3072]),
                                    ("bfloat16", 4104, 1280, 5120, [5120]),
                                    ("float32", 4104, 768, 3072, [3072]))
PHASES = ("k1", "k1_f32", "k1_f32_narrow", "k1_f32_narrow_parts", "k1b_f32",
          "k1b_bf16", "k1c_wide", "k1c_wide_leads", "k1b_wide_bits", "d8", "d8_splits",
          "pipeline_sass", "k4_sliced", "k4_sliced_parts", "k4_sliced_bf16",
          "k4_sliced_bf16_parts", "k4_sass", "pass", "latency", "stretch_f32")
# Phases `k4_sliced` and `k4_sliced_bf16`: (B, H, S, hd) of K4's sliced
# bodies, by dtype name
K4_SLICED_SHAPES = {
    "float32": ((1, 24, 513, 512), (1, 8, 513, 264), (1, 8, 513, 1024), (1, 24, 65, 512)),
    "bfloat16": ((2, 24, 513, 512), (2, 8, 513, 264), (2, 8, 513, 1024), (2, 24, 65, 512))}


def _drop_lines(text: str, marker: str) -> str:
    if marker not in text:
        raise RuntimeError(f"no line holds {marker!r}")
    return "\n".join(ln for ln in text.split("\n") if marker not in ln)


def _sub(text: str, *pairs) -> str:
    """`text` with each (old, new) of `pairs` replaced; raises where an old
    text is missing, so that a part never measures the whole by mistake."""
    for old, new in zip(pairs[::2], pairs[1::2]):
        if old not in text:
            raise RuntimeError(f"no {old!r} to take out")
        text = text.replace(old, new)
    return text


# The sliced f32 body with one part taken out: (name, text of
# `csrc/attention.cu` -> text of the copy)
K4_SLICED_PARTS = (
    ("whole", lambda s: s),
    ("no_exchange", lambda s: _sub(
        s, "mbar_wait_cluster(sw_bar(w.ring, xf + slot), (u / SW_SLOTS) & 1);", "",
        "mbar_wait_cluster(sw_bar(w.ring, xf + (ch - 1) % SW_SLOTS), "
        "((ch - 1) / SW_SLOTS) & 1);", "(void)0;",
        "for (int r = 0; r < cluster; ++r) mbar_arrive_rank(",
        "for (int r = 0; r < 0; ++r) mbar_arrive_rank(",
        "for (int r = 0; r < cluster; ++r) {", "for (int r = 0; r < 1; ++r) {")),
    ("no_exchange_waits", lambda s: _sub(
        s, "mbar_wait_cluster(sw_bar(w.ring, xf + slot), (u / SW_SLOTS) & 1);", "",
        "mbar_wait_cluster(sw_bar(w.ring, xf + (ch - 1) % SW_SLOTS), "
        "((ch - 1) / SW_SLOTS) & 1);", "(void)0;")),
    ("own_partial_only", lambda s: _sub(
        s, "const uint32_t at = cluster_addr(sw_slot(w.ring, c, slot), r) + 16 * tid;",
        "const uint32_t at = smem_u32(sw_slot(w.ring, c, slot)) + 16 * tid;",
        "const float4 v = ld_cluster_f4(at + 16 * 128 * j);",
        "const float4 v = *reinterpret_cast<const float4*>(sw_slot(w.ring, c, slot) + 4 * tid "
        "+ 512 * j);")),
    ("no_splitters", lambda s: _sub(s, "split_k_box(dst, tid - 32);", "(void)0;",
                                    "split_v_pass(dst, tid - 32);", "(void)0;")),
    ("no_q_split", lambda s: _sub(s, "split_tf32(raw[r], a[kk][r], a[kk][4 + r]);",
                                  "a[kk][r] = a[kk][4 + r] = raw[r];")),
    ("no_score_wgmma", lambda s: _drop_lines(s, "wgmma_tf32_rs<SW_KEYS>(")),
    ("no_pv_wgmma", lambda s: _drop_lines(s, "wgmma_tf32_rs<SW_PASS>(")))
# The sliced bf16 body at other keys a chunk and lags, with other register
# splits, and with one part taken out: (name, text of `csrc/attention.cu` ->
# text of the copy)
def _bf16_keys_lag(keys: int, lag: int):
    return lambda s: _sub(s, "constexpr int SB_KEYS = 64;", f"constexpr int SB_KEYS = {keys};",
                          "constexpr int SB_LAG = 1;", f"constexpr int SB_LAG = {lag};")


def _bf16_regs(producer: int, consumer: int):
    return lambda s: _sub(
        s, 'setmaxnreg.dec.sync.aligned.u32 40;\\n" ::: "memory");\n    if (tid == 0)\n'
        '      sliced_bf16_produce(',
        f'setmaxnreg.dec.sync.aligned.u32 {producer};\\n" ::: "memory");\n    if (tid == 0)\n'
        '      sliced_bf16_produce(',
        'setmaxnreg.inc.sync.aligned.u32 232;\\n" ::: "memory");\n    const int c = wg - 1;\n'
        '    if (c < w.live)  // a query row of this warpgroup lies below s\n'
        '      sliced_bf16_consume(',
        f'setmaxnreg.inc.sync.aligned.u32 {consumer};\\n" ::: "memory");\n    const int c = wg - 1;\n'
        '    if (c < w.live)  // a query row of this warpgroup lies below s\n'
        '      sliced_bf16_consume(')


K4_SLICED_BF16_PARTS = (
    ("whole", lambda s: s),
    ("regs56", _bf16_regs(56, 224)),
    ("regs24", _bf16_regs(24, 240)),
    ("no_exchange", lambda s: _sub(
        s, "mbar_wait_cluster(sb_bar(base, SB_XFULL + xs + slot), (u / SB_SLOTS) & 1);", "",
        "mbar_wait_cluster(sb_bar(base, SB_XFULL + xs + (ch - 1) % SB_SLOTS),", "(void)(",
        "else if (tid % 32 == 0 && tid / 32 <= w.live)", "else if (false)",
        "      for (int r = 0; r < cluster; ++r) {\n        const uint32_t at = cluster_addr(sb_slot(",
        "      for (int r = 0; r < 1; ++r) {\n        const uint32_t at = cluster_addr(sb_slot(")),
    ("own_partial_only", lambda s: _sub(
        s, "const uint32_t at = cluster_addr(sb_slot(base, c, slot), r) + 16 * tid;",
        "const uint32_t at = smem_u32(sb_slot(base, c, slot)) + 16 * tid;")),
    ("no_score_wgmma", lambda s: _drop_lines(s, "wgmma<SB_KEYS>(sc,")),
    ("no_pv_wgmma", lambda s: _drop_lines(s, "wgmma_rs_tb<SLICE>(o, pa[kk]")),
    ("keys64_lag0", _bf16_keys_lag(64, 0)),
    ("keys32_lag1", _bf16_keys_lag(32, 1)),
    ("keys32_lag2", _bf16_keys_lag(32, 2)),
    ("keys32_lag3", _bf16_keys_lag(32, 3)))
# The narrow f32 body with one part taken out: (name, text of the header ->
# text of the copy)
NARROW_PARTS = (
    ("whole", lambda s: s),
    ("no_gelu", lambda s: s.replace("mlp::gelu_erf(", "(")),
    ("no_fc1_wgmma", lambda s: "\n".join(
        ln for ln in s.split("\n") if "tf32x3::wgmma_tf32_ss_n32(" not in ln)),
    ("no_fc2_wgmma", lambda s: "\n".join(
        ln for ln in s.split("\n") if "tf32x3::wgmma_tf32_rs<NP2>(" not in ln)),
    ("no_weight_split", lambda s: s.replace("split_store(w1_hi,", "if (0) split_store(w1_hi,")
     .replace("split_store(w2_hi,", "if (0) split_store(w2_hi,")),
    ("no_staging", lambda s: s.replace("stage<D>(buf, md, m, c + 2, md.active);",
                                       "mlp::cp_async_commit();")),
    ("no_b1", lambda s: s.replace("const float bias = b1c[2 * j + e];",
                                  "const float bias = 0.f;")))
NARROW_PARTS_CASES = ((260, 64, 3072, 0), (4160, 64, 3072, 0), (1560, 64, 3072, 30),
                      (260, 16, 2048, 0))


def load_smoke(root: pathlib.Path):
    """This checkout's `chip_smoke` module, importing ROOT's package."""
    sys.path.insert(0, str(root))
    import vit3d_ensemble_tpu_torch as pkg
    found = pathlib.Path(pkg.__file__).resolve().parents[1]
    if found != root:
        raise RuntimeError(f"imported the package from {found}, not {root}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def narrow_parts(cs, emit, fused_mlp, _build) -> None:
    """Phase `k1_f32_narrow_parts` (see the module note)."""
    import ctypes
    import re
    import subprocess
    import torch
    here = pathlib.Path(__file__).resolve().parent
    csrc = here / "vit3d_ensemble_tpu_torch" / "csrc"
    header = (csrc / "mlp_narrow_f32.cuh").read_text()
    entry = ('#include "mlp_narrow_f32.cuh"\n'
             'extern "C" int narrow_part(int dev, const float* x, const float* w1, '
             'const float* b1, const float* w2, const float* b2, float* out, int n, int d, '
             'int m, int active, const int* ap, int models, int splits, int groups, void* s) {'
             ' return (int)narrow_f32::launch(dev, x, w1, b1, w2, b2, out, n, d, m, active, ap,'
             ' models, splits, groups, (cudaStream_t)s); }\n')
    jobs = {}
    for name, edit in NARROW_PARTS:
        d = here / "build" / "narrow_parts" / name
        d.mkdir(parents=True, exist_ok=True)
        for f in csrc.glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        (d / "mlp_narrow_f32.cuh").write_text(edit(header))
        (d / "part.cu").write_text(entry)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "part.so"), str(d / "part.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, regs = {}, {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"narrow part {name}: nvcc failed:\n{log}")
        regs[name] = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        fn = ctypes.CDLL(str(here / "build" / "narrow_parts" / name / "part.so")).narrow_part
        fn.argtypes = fused_mlp._NARROW_F32_ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for N, D, M, P in NARROW_PARTS_CASES:
        lead = (P,) if P else ()
        x = torch.randn(*lead, N, D, generator=gen, device="cuda")
        w1, b1, w2, b2 = cs.mlp_weights(gen, torch.float32, D, M, lead)
        out = torch.empty_like(x)
        widths = (torch.tensor([2048] * (P // 2) + [3072] * (P - P // 2), dtype=torch.int32,
                               device="cuda") if P else None)
        plan = fused_mlp.k1_narrow_f32_plan(N, D, M, M, max(P, 1), sms)
        ms = {}
        for name, fn in fns.items():
            def call(fn=fn):
                _build.check("fused_mlp", fn(
                    0, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    b2.data_ptr(), out.data_ptr(), N, D, M, M,
                    None if widths is None else widths.data_ptr(), max(P, 1),
                    plan["splits"], plan["tiles"], stream))
            ms[name] = cs.time_ms(call, 20)
        emit({"phase": "k1_f32_narrow_parts", "N": N, "D": D, "M": M, "models": P,
              "splits": plan["splits"], "ms": ms,
              "registers": {k: sorted(v) for k, v in regs.items()}})


def k1c_leads(cs, emit, fused_mlp, gen, reps: int = 20) -> None:
    """Phase `k1c_wide_leads`: K1c's wide entry at K1C_LEAD_CASES under
    several leads, by CUDA events, beside K1's device ms."""
    import torch
    card = torch.cuda.get_device_properties(0)
    for name, N, D, M, width in K1C_LEAD_CASES:
        dtype, P = getattr(torch, name), len(width)
        x = torch.randn(P, N, D, generator=gen, device="cuda").to(dtype)
        w1, b1, w2, b2 = cs.mlp_weights(gen, dtype, D, M, (P,))
        widths = torch.tensor(width, dtype=torch.int32, device="cuda")
        plan = fused_mlp.k1c_wide_plan(N, D, M, P, dtype, card.multi_processor_count,
                                       card.L2_cache_size)
        h, out = torch.empty(P, N, M, dtype=dtype, device="cuda"), torch.empty_like(x)
        f32 = dtype == torch.float32
        fn = fused_mlp._build.entry("mlp_pipelined", fused_mlp._K1C_WIDE_ARGTYPES,
                                    f"mlp_pipelined_wide{'_f32' if f32 else ''}_launch")
        stream = torch.cuda.current_stream().cuda_stream
        k1 = fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths)
        k1_plan = fused_mlp.wide_f32_plan(N, D, M, card.multi_processor_count)
        k1_splits = f32 and max(k1_plan["fc1"]["splits"], k1_plan["fc2"]["splits"]) > 1
        groups, a_b = plan["groups"], plan["fc1_units"] + plan["fc2_units"]
        leads = sorted({1, min(groups, -(-2 * plan["blocks"] // a_b)), plan["lead"], groups})
        line = {"phase": "k1c_wide_leads", "dtype": name, "N": N, "D": D, "M": M,
                "width": width, "models": P, "groups": groups, "plan_lead": plan["lead"],
                "k1_device_ms": cs.mlp_device_ms(
                    lambda: fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths))}
        for lead in leads:
            ready = torch.zeros(reps + 1, groups + 1, dtype=torch.int32, device="cuda")

            def launch(i):
                return fn(x.device.index, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                          w2.data_ptr(), M, b2.data_ptr(), h.data_ptr(), M, ready[i].data_ptr(),
                          out.data_ptr(), N, D, M, 0, widths.data_ptr(), P, lead,
                          plan["blocks"], stream)

            fused_mlp._build.check("mlp_pipelined", launch(reps))
            torch.cuda.synchronize()
            k1_bits = None if k1_splits else bool(torch.equal(out, k1))
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for i in range(reps):
                launch(i)
            end.record()
            torch.cuda.synchronize()
            line[f"lead_{lead}"] = {"ms": start.elapsed_time(end) / reps, "k1_bits": k1_bits}
        emit(line)


# Phase `d8_splits`: token rows (3 to 129 row tiles of 128) and split counts
D8_SPLIT_ROWS = (257, 1028, 2056, 4112, 8224, 16448)
D8_SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 16)


def d8_splits(cs, emit, fused_mlp, gen, rounds: int = 3, reps: int = 100) -> None:
    """Phase `d8_splits`: the bf16 D = 8 entries of K1c and K1b at conf 22's
    FFN (M 2,204, w2 and b1 padded to 2,208 as the wrapper pads them) at
    D8_SPLIT_ROWS and D8_SPLITS, by CUDA events over `reps` launches, the
    cases in turns `rounds` times; with each one's largest error over the
    bf16 gate against ROOT's plain version."""
    import torch
    import torch.nn.functional as F
    M, D = 2204, 8
    w1, b1, w2, b2 = cs.mlp_weights(gen, torch.bfloat16, D, M)
    w2p, b1p = F.pad(w2, (0, 4)), F.pad(b1, (0, 4))
    stream = torch.cuda.current_stream().cuda_stream
    device = torch.device("cuda", 0)
    for library in ("mlp_pipelined", "mlp_chunked"):
        fn = fused_mlp._build.entry(library, fused_mlp._K1C_ARGTYPES)
        held = fused_mlp.k1_d8_clusters(device, library)
        plain = (fused_mlp._plain_mlp_chunked if library == "mlp_chunked"
                 else fused_mlp._plain_mlp)
        for N in D8_SPLIT_ROWS:
            x = torch.randn(N, D, generator=gen, device="cuda").to(torch.bfloat16)
            out = torch.empty_like(x)
            tiles = -(-N // 128)
            ref = plain(x, w1, b1, w2, b2, M)
            ms, over = {s: [] for s in D8_SPLITS}, {}
            for _ in range(rounds):
                for s in D8_SPLITS:
                    groups = tiles if s > 1 else min(tiles, held[0])

                    def call(s=s, groups=groups):
                        return fn(0, x.data_ptr(), w1.data_ptr(), b1p.data_ptr(),
                                  w2p.data_ptr(), M + 4, b2.data_ptr(), out.data_ptr(), N, D,
                                  M, M, None, 1, groups, s, 1, stream)

                    fused_mlp._build.check(library, call())
                    torch.cuda.synchronize()
                    over[s] = cs.over_gate(out, ref, cs.TOL[torch.bfloat16])[1]
                    ms[s].append(cs.time_ms(call, reps))
            emit({"phase": "d8_splits", "library": library, "N": N, "tiles": tiles,
                  "clusters": held, "plan_splits": fused_mlp.k1_d8_plan(
                      N, M, 1, held, library == "mlp_chunked")["splits"],
                  "ms": {s: v for s, v in ms.items()},
                  "median_ms": {s: statistics.median(v) for s, v in ms.items()},
                  "max_err_over_gate": max(over.values())})


def pipeline_sass(cs, emit, _build) -> None:
    """Phase `pipeline_sass`: each D 16-64 instantiation of the wgmma
    pipeline in ROOT's K1c and K1b libraries, its SASS lines and the SHA-256
    of its SASS with the addresses and mangled names taken out."""
    import re
    _build.build(["mlp_pipelined", "mlp_chunked"])
    for library in ("mlp_pipelined", "mlp_chunked"):
        for fn in cs.sass_of(_build.library_path(library)).split("Function : ")[1:]:
            found = re.search(r"(pipelined|chunked)_wgmma_kernelILi(\d+)E", fn.split()[0])
            if not found:
                continue
            body = [re.sub(r"_ZN\w+", "SYM", re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)).strip()
                    for line in fn.splitlines()[1:]]
            body = [line for line in body if line and not line.startswith(".")]
            emit({"phase": "pipeline_sass", "library": library,
                  "kernel": f"{found.group(1)}_wgmma_kernel<{found.group(2)}>",
                  "lines": len(body),
                  "sha256": hashlib.sha256("\n".join(body).encode()).hexdigest()})


def k4_sliced(cs, emit, fused_attention, _build, dtype_name: str = "float32") -> None:
    """Phases `k4_sliced` and `k4_sliced_bf16` (see the module note)."""
    import ctypes
    import torch
    import torch.nn.functional as F
    dtype = getattr(torch, dtype_name)
    bf16 = dtype == torch.bfloat16
    phase = "k4_sliced_bf16" if bf16 else "k4_sliced"
    plan_fn = None
    try:
        plan_fn = _build.entry("attention", [ctypes.c_int] * 5 + [ctypes.c_void_p],
                               "attention_sliced_bf16_plan" if bf16
                               else "attention_sliced_f32_plan")
    except AttributeError:  # an older library: no cluster plan
        pass
    with torch.no_grad():
        for shape in K4_SLICED_SHAPES[dtype_name]:
            own = torch.Generator(device="cuda").manual_seed(zlib.crc32(repr(shape).encode()))
            q, k, v = cs.model_views(own, shape, dtype)
            out = fused_attention.fused_attention(q, k, v)
            body = fused_attention.k4_body_launched()
            ref = fused_attention._plain_attention_k4(q, k, v)
            _, groups, _, _ = cs.device_time(
                lambda: [fused_attention.fused_attention(q, k, v) for _ in range(10)],
                host_ops=False)
            lib = cs.device_time(lambda: [F.scaled_dot_product_attention(q, k, v)
                                          for _ in range(10)], host_ops=False)[0]
            B, H, S, hd = shape
            # two products of 2 S^2 hd a head, in f32 three TF32 ones each
            ops = (4.0 * B * H * S * S * hd / cs.PEAK_FLOPS[dtype] if bf16
                   else 3 * 4.0 * B * H * S * S * hd / cs.PEAK_TF32)
            nbytes = 4.0 * B * H * S * hd * q.element_size() / cs.PEAK_BYTES
            line = {"phase": phase, "shape": list(shape), "body": body,
                    "device_ms": groups.get("K4", 0.0) / 10, "library_device_ms": lib / 10,
                    **cs.sdpa_backend(q, k, v), "bound_ms": max(ops, nbytes) * 1e3,
                    "bound_by": "operations" if ops >= nbytes else "bytes",
                    "max_err_over_gate": cs.over_gate(
                        out, ref, cs.K4_BF16_TOL if bf16 else cs.TOL[dtype])[1],
                    "sha256": digest(out)}
            if plan_fn is not None and hasattr(fused_attention, "k4_sliced_split"):
                line["plan"] = cs.k4_sliced_plan(*shape, dtype)
            emit(line)


def widest_pass(cs, emit, bf16: bool = False) -> None:
    """The `widest` model's f32 pass at B = 1 (bf16: at B = 2) under `auto`
    and `layer` (K4's or K3's sliced body at head_dim 512, twice a pass),
    the model made as `chip_smoke.phase_widest` makes it: K4's device ms
    (its trace group, K3's launches included), its share of the busy ms,
    the busy ms."""
    import torch
    from vit3d_ensemble_tpu_torch.configs import ViTConfig
    from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
    cfg = ViTConfig(patch_size=(16, 16, 16), img_size=128, z_size=128, **cs.WIDEST_WIDTHS)
    with torch.device("meta"):
        model = VisionTransformer3D(cfg, zero_head=False, vis=False, device="meta")
    model.to_empty(device="cuda")
    model.reset_parameters(False, torch.Generator(device="cuda").manual_seed(cs.SEED + 12))
    model.eval()
    B = cs.WIDEST_B if bf16 else 1
    x = torch.randn(B, 128, 128, 128, 1, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(cs.SEED + 13))
    if bf16:
        model.to(torch.bfloat16)
        x = x.to(torch.bfloat16)
    line = {"phase": "widest_bf16" if bf16 else "widest_f32", "B": B}
    with torch.no_grad():
        for impl in ("auto", "layer"):
            cs.set_impls(impl)
            try:
                model(x)
                busy, groups, kernels, _ = cs.device_time(lambda: model(x))
            finally:
                cs.set_impls("auto")
            k4 = groups.get("K4", 0.0)
            line[impl] = {"device_busy_ms": busy, "k4_device_ms": k4, "k4_share": k4 / busy,
                          "kernels": kernels}
    emit(line)
    del model
    torch.cuda.empty_cache()


def k4_sliced_parts(cs, emit, _build, bf16: bool = False) -> None:
    """Phases `k4_sliced_parts` and `k4_sliced_bf16_parts` (see the module
    note)."""
    import ctypes
    from vit3d_ensemble_tpu_torch.ops import fused_attention
    import math
    import subprocess
    import torch
    here = pathlib.Path(__file__).resolve().parent
    csrc = here / "vit3d_ensemble_tpu_torch" / "csrc"
    source = (csrc / "attention.cu").read_text()
    jobs = {}
    phase = "k4_sliced_bf16_parts" if bf16 else "k4_sliced_parts"
    for name, edit in K4_SLICED_BF16_PARTS if bf16 else K4_SLICED_PARTS:
        d = here / "build" / phase / name
        d.mkdir(parents=True, exist_ok=True)
        for f in csrc.glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        copy = edit(source)
        if name != "whole" and copy == source:
            raise RuntimeError(f"K4 sliced part {name}: the edit changed nothing")
        (d / "attention.cu").write_text(copy)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "part.so"),
             str(d / "attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"K4 sliced part {name}: nvcc failed:\n{log}")
        kernel = "attention_sliced_wgmma_kernel" if bf16 else "attention_sliced_f32_kernel"
        emit({"phase": phase + "_ptxas", "part": name, "notes": cs.ptxas_notes(log, kernel),
              "spilling": [e for e in cs.ptxas_summary(log)["spilling_entries"] if kernel in e]})
        fn = ctypes.CDLL(str(here / "build" / phase / name / "part.so")
                         ).attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_int,
                                                    ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    stream = torch.cuda.current_stream().cuda_stream
    dtype = torch.bfloat16 if bf16 else torch.float32
    cases = []
    for shape in K4_SLICED_SHAPES[str(dtype).split(".")[1]]:
        own = torch.Generator(device="cuda").manual_seed(zlib.crc32(repr(shape).encode()))
        q, k, v = cs.model_views(own, shape, dtype)
        B, H, S, hd = shape
        cases.append((shape, q, k, v, torch.empty(B, S, H, hd, device="cuda", dtype=dtype),
                      fused_attention._plain_attention_k4(q, k, v)))
    # a copy at a time over every shape, its line emitted before the next
    # copy runs (a copy that faults ends the phase with the lines before it)
    for name, fn in fns.items():
        line = {"phase": phase, "part": name, "ms": {}, "max_err_over_gate": {}}
        for shape, q, k, v, out, ref in cases:
            B, H, S, hd = shape

            def call(fn=fn):
                _build.check("attention", fn(
                    0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, S, hd,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(hd),
                    int(bf16), stream))
            key = "x".join(map(str, shape))
            line["ms"][key] = cs.time_ms(call, 20)
            call()
            torch.cuda.synchronize()
            # whole bodies (no part taken out) must hold the gate
            line["max_err_over_gate"][key] = cs.over_gate(
                out.transpose(1, 2), ref, cs.K4_BF16_TOL if bf16 else cs.TOL[dtype])[1]
        emit(line)


def k4_sass(cs, emit, _build) -> None:
    """Phase `k4_sass`: every K4 body in ROOT's library but the sliced bf16
    one, its SASS lines and the SHA-256 of its SASS with the addresses and
    mangled names taken out."""
    import re
    _build.build(["attention"])
    for fn in cs.sass_of(_build.library_path("attention")).split("Function : ")[1:]:
        name = fn.split()[0]
        found = re.search(r"(attention_\w+?_kernel)(I\w+?E)?E", name)
        if not found or "sliced_wgmma" in name:
            continue
        body = [re.sub(r"_ZN\w+", "SYM", re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)).strip()
                for line in fn.splitlines()[1:]]
        body = [line for line in body if line and not line.startswith(".")]
        emit({"phase": "k4_sass", "kernel": found.group(1) + (found.group(2) or ""),
              "lines": len(body), "sha256": hashlib.sha256("\n".join(body).encode()).hexdigest()})


def digest(t) -> str:
    """SHA-256 of a tensor's bytes."""
    import torch
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def k1b_wide_bits(cs, emit, fused_mlp) -> None:
    """Phase `k1b_wide_bits` (see the module note)."""
    import torch
    from vit3d_ensemble_tpu_torch.configs import vit_b16_128cubed
    from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
    from vit3d_ensemble_tpu_torch.sweep import stacked as stacked_module
    with torch.no_grad(), cs.mlp_variant("chunked"):
        for dtype in (torch.bfloat16, torch.float32):
            for N, D, M, models in cs.WIDE_CASE_SHAPES:
                for P in models:
                    for widths in cs.wide_case_widths(M, P):
                        key = (str(dtype), N, D, M, tuple(widths))
                        own = torch.Generator(device="cuda").manual_seed(
                            zlib.crc32(repr(key).encode()))
                        x = torch.randn(P, N, D, generator=own, device="cuda").to(dtype)
                        w1, b1, w2, b2 = cs.mlp_weights(own, dtype, D, M, (P,))
                        wt = torch.tensor(widths, dtype=torch.int32, device="cuda")
                        out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, wt)
                        emit({"phase": "k1b_wide_bits", "case": "wide_cases",
                              "dtype": str(dtype).split(".")[1], "N": N, "D": D, "M": M,
                              "widths": widths, "body": fused_mlp.k1b_body_launched(),
                              "sha256": digest(out)})
        # the stacked members of `chip_smoke.phase_wide_axis`, drawn as it
        # draws them
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
        cfg = vit_b16_128cubed()
        model = VisionTransformer3D(cfg, zero_head=False, vis=False,
                                    generator=torch.Generator().manual_seed(cs.SEED + 11))
        emb = model.transformer.embeddings
        emb.position_embeddings.normal_(0.0, 0.02, generator=gen)
        emb.cls_token.normal_(0.0, 0.02, generator=gen)
        params = cs.stacked_members(model, gen)
        del model
        P = len(cs.WIDE_AXIS_MLP)
        mlp = torch.tensor(cs.WIDE_AXIS_MLP, dtype=torch.int32, device="cuda")
        layers = torch.tensor(cs.WIDE_AXIS_LAYERS, dtype=torch.int32, device="cuda")
        for dtype, B in ((torch.float32, 1), (torch.bfloat16, cs.STRETCH_B)):
            stacked = {k: v.to(dtype) for k, v in params.items()}
            x = torch.randn(P, B, cfg.img_size, cfg.img_size, cfg.z_size, 1, generator=gen,
                            device="cuda").to(dtype)
            out = stacked_module.stacked_forward(stacked, cfg, x, layers_active=layers,
                                                 mlp_active=mlp)
            emit({"phase": "k1b_wide_bits", "case": "wide_axis",
                  "dtype": str(dtype).split(".")[1], "B": B, "sha256": digest(out)})
            del stacked, x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", type=pathlib.Path)
    ap.add_argument("turn")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}; known {PHASES}")
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_turns: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = load_smoke(args.root.resolve())
    from vit3d_ensemble_tpu_torch.configs import (BASELINE_CONFS, BEST_ENSEMBLE,
                                                  ViTConfig, vit_b16_128cubed)
    from vit3d_ensemble_tpu_torch.models import (TransformerEnsemble,
                                                 VisionTransformer3D)
    from vit3d_ensemble_tpu_torch.ops import (_build, attention_layer,
                                              fused_attention, fused_mlp)
    cs.card = cs.smi("name,power.limit")

    def emit(obj):
        cs.emit({"turn": args.turn, **obj})

    _build.build(BUILD)
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def mlp_case(g, N, D, M, width, P):
        """f32 inputs, the weights' widths and the library chain, as
        `chip_smoke.k1_case` makes them (the widths folded into w2 with the
        model axis)."""
        lead = (P,) if P else ()
        x = torch.randn(*lead, N, D, generator=g, device="cuda")
        w1, b1, w2, b2 = cs.mlp_weights(g, torch.float32, D, M, lead)
        if P:
            widths = torch.tensor(width, dtype=torch.int32, device="cuda")
            w2m = w2 * (torch.arange(M, device="cuda") < widths[:, None, None])
            b1u, b2u = b1.unsqueeze(1), b2.unsqueeze(1)
            w1t, w2t = w1.transpose(1, 2), w2m.transpose(1, 2)

            def chain():
                return torch.baddbmm(b2u, F.gelu(torch.baddbmm(b1u, x, w1t)), w2t)
        else:
            widths = width
            w1a, b1a, w2a = w1[:width], b1[:width], w2[:, :width].contiguous()

            def chain():
                return F.linear(F.gelu(F.linear(x, w1a, b1a)), w2a, b2)
        return (x, w1, b1, w2, b2), widths, chain

    def chain_device_ms(chain):
        chain()
        return cs.device_time(lambda: [chain() for _ in range(10)], host_ops=False)[0] / 10

    with torch.no_grad():
        for N, D, M in K1_SHAPES if "k1" in phases else ():
            x = torch.randn(N, D, generator=gen, device="cuda").to(bf16)
            weights = cs.mlp_weights(gen, bf16, D, M)

            def call():
                return fused_mlp.fused_mlp(x, *weights)

            call()
            body = getattr(fused_mlp, "k1_body_launched", lambda: None)()
            emit({"phase": "k1", "N": N, "D": D, "M": M, "body": body,
                  "ms": cs.time_ms(call, 20), "device_ms": cs.mlp_device_ms(call),
                  "host_ms": cs.host_ms(call)})
        for N, D, M, active in K1_F32_SHAPES if "k1_f32" in phases else ():
            x = torch.randn(N, D, generator=gen, device="cuda")
            weights = cs.mlp_weights(gen, torch.float32, D, M)
            w1, b1, w2, b2 = weights
            w1a, b1a, w2a = w1[:active], b1[:active], w2[:, :active].contiguous()

            def call():
                return fused_mlp.fused_mlp(x, *weights, active)

            def chain():
                return F.linear(F.gelu(F.linear(x, w1a, b1a)), w2a, b2)

            over = cs.over_gate(call(), fused_mlp._plain_mlp(x, *weights, active),
                                cs.TOL[torch.float32])[1]
            body = getattr(fused_mlp, "k1_body_launched", lambda: None)()
            emit({"phase": "k1_f32", "N": N, "D": D, "M": M, "active": active,
                  "body": body, "max_err_over_gate": over, "ms": cs.time_ms(call, 10),
                  "device_ms": cs.mlp_device_ms(call),
                  "host_ms": cs.host_ms(call, iters=10),
                  "chain_device_ms": chain_device_ms(chain)})

        # generators of their own, so the phases after draw what they drew
        own = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
        for N, D, M, width, P in K1_NARROW_F32_CASES if "k1_f32_narrow" in phases else ():
            args_, widths, chain = mlp_case(own, N, D, M, width, P)

            def call():
                return fused_mlp.fused_mlp(*args_, widths)

            ref = fused_mlp._plain_mlp(*args_, widths)
            line = {"phase": "k1_f32_narrow", "N": N, "D": D, "M": M,
                    "width": width, "models": P,
                    "chain_device_ms": chain_device_ms(chain)}
            for variant in ("seq", "pipelined2"):
                with cs.mlp_variant(variant):
                    out = call()
                    body = (getattr(fused_mlp, "k1_body_launched", lambda: None)()
                            if variant == "seq" else None)
                    line[variant] = {
                        "body": body,
                        "max_err_over_gate": cs.over_gate(out, ref, cs.TOL[torch.float32])[1],
                        "same_bits_twice": bool(torch.equal(out, call())),
                        "ms": cs.time_ms(call, 10), "device_ms": cs.mlp_device_ms(call)}
            emit(line)

        if "k1_f32_narrow_parts" in phases:
            narrow_parts(cs, emit, fused_mlp, _build)

        own = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
        for N, D, M, width, P in K1B_F32_CASES if "k1b_f32" in phases else ():
            args_, widths, chain = mlp_case(own, N, D, M, width, P)

            def call():
                return fused_mlp.fused_mlp(*args_, widths)

            with cs.mlp_variant("chunked"):
                over = cs.over_gate(call(), fused_mlp._plain_mlp_chunked(*args_, widths),
                                    cs.TOL[torch.float32])[1]
                line = {"phase": "k1b_f32", "N": N, "D": D, "M": M, "width": width,
                        "models": P, "max_err_over_gate": over,
                        "ms": cs.time_ms(call, 10), "device_ms": cs.mlp_device_ms(call)}
            line["chain_device_ms"] = chain_device_ms(chain)
            emit(line)

        own = torch.Generator(device="cuda").manual_seed(cs.SEED + 29)
        for N, D, M, width in K1B_BF16_CASES if "k1b_bf16" in phases else ():
            x = torch.randn(N, D, generator=own, device="cuda").to(bf16)
            weights = cs.mlp_weights(own, bf16, D, M)
            w1, b1, w2, b2 = weights
            w1a, b1a, w2a = w1[:width], b1[:width], w2[:, :width].contiguous()

            def call():
                return fused_mlp.fused_mlp(x, *weights, width)

            def chain():
                return F.linear(F.gelu(F.linear(x, w1a, b1a)), w2a, b2)

            with cs.mlp_variant("chunked"):
                out = call()
                line = {"phase": "k1b_bf16", "N": N, "D": D, "M": M, "width": width,
                        "body": getattr(fused_mlp, "k1b_body_launched", lambda: None)(),
                        "max_err_over_gate": cs.over_gate(
                            out, fused_mlp._plain_mlp_chunked(x, *weights, width),
                            cs.TOL[bf16])[1],
                        "ms": cs.time_ms(call, 20), "device_ms": cs.mlp_device_ms(call)}
            with cs.mlp_variant("seq"):
                line["k1_device_ms"] = cs.mlp_device_ms(call)
            line["chain_device_ms"] = chain_device_ms(chain)
            emit(line)

        own = torch.Generator(device="cuda").manual_seed(cs.SEED + 23)
        for name, N, D, M, width in K1C_WIDE_CASES if "k1c_wide" in phases else ():
            dtype, P = getattr(torch, name), len(width)
            x = torch.randn(P, N, D, generator=own, device="cuda").to(dtype)
            w1, b1, w2, b2 = cs.mlp_weights(own, dtype, D, M, (P,))
            widths = torch.tensor(width, dtype=torch.int32, device="cuda")
            w2t = (w2 * (torch.arange(M, device="cuda") < widths[:, None, None]).to(dtype)
                   ).transpose(1, 2)
            b1u, b2u, w1t = b1.unsqueeze(1), b2.unsqueeze(1), w1.transpose(1, 2)

            def call():
                return fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths)

            def chain():
                return torch.baddbmm(b2u, F.gelu(torch.baddbmm(b1u, x, w1t)), w2t)

            ref = fused_mlp._plain_mlp(x, w1, b1, w2, b2, widths)
            line = {"phase": "k1c_wide", "dtype": name, "N": N, "D": D, "M": M,
                    "width": width, "models": P}
            outs = {}
            for variant in ("seq", "pipelined2"):
                with cs.mlp_variant(variant):
                    outs[variant] = call()
                    line[variant] = {
                        "max_err_over_gate": cs.over_gate(outs[variant], ref, cs.TOL[dtype])[1],
                        "ms": cs.time_ms(call, 10), "device_ms": cs.mlp_device_ms(call)}
            line["k1c_equal_to_k1"] = bool(torch.equal(outs["seq"], outs["pipelined2"]))
            line["chain_device_ms"] = chain_device_ms(chain)
            emit(line)
            del x, w1, b1, w2, b2, w2t, w1t, ref, outs

        if "k1c_wide_leads" in phases:
            k1c_leads(cs, emit, fused_mlp, torch.Generator(device="cuda").manual_seed(cs.SEED + 29))

        if "k1b_wide_bits" in phases:
            k1b_wide_bits(cs, emit, fused_mlp)

        if "d8" in phases:
            own = torch.Generator(device="cuda").manual_seed(cs.SEED + 26)
            for variant, N, D, M in D8_CASES + D16_64_CASES:
                x = torch.randn(N, D, generator=own, device="cuda").to(bf16)
                weights = cs.mlp_weights(own, bf16, D, M)

                def call():
                    return fused_mlp.fused_mlp(x, *weights, M)

                plain = (fused_mlp._plain_mlp_chunked if variant == "chunked"
                         else fused_mlp._plain_mlp)
                with cs.mlp_variant(variant):
                    out = call()
                    body = {"seq": fused_mlp.k1_body_launched,
                            "chunked": fused_mlp.k1b_body_launched,
                            "pipelined2": fused_mlp.k1c_body_launched}[variant]()
                    line = {"phase": "d8", "variant": variant, "N": N, "D": D, "M": M,
                            "body": body, "sha256": digest(out),
                            "max_err_over_gate": cs.over_gate(
                                out, plain(x, *weights, M), cs.TOL[bf16])[1],
                            "ms": cs.time_ms(call, 20), "device_ms": cs.mlp_device_ms(call)}
                if D == 8:
                    w1, b1, w2, b2 = weights
                    line["chain_device_ms"] = chain_device_ms(
                        lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2))
                emit(line)
            del x, weights

        if "d8_splits" in phases:
            d8_splits(cs, emit, fused_mlp, torch.Generator(device="cuda").manual_seed(cs.SEED + 27))

        if "pipeline_sass" in phases:
            pipeline_sass(cs, emit, _build)
        if "k4_sliced" in phases:
            k4_sliced(cs, emit, fused_attention, _build)
            widest_pass(cs, emit)
        if "k4_sliced_bf16" in phases:
            k4_sliced(cs, emit, fused_attention, _build, "bfloat16")
            widest_pass(cs, emit, bf16=True)
        if "k4_sliced_parts" in phases:
            k4_sliced_parts(cs, emit, _build)
        if "k4_sliced_bf16_parts" in phases:
            k4_sliced_parts(cs, emit, _build, bf16=True)
        if "k4_sass" in phases:
            k4_sass(cs, emit, _build)

        if "pass" in phases:
            x = torch.randn(cs.B, 128, 128, 5, 1, generator=gen,
                            device="cuda").to(bf16)
            models = [VisionTransformer3D(ViTConfig.from_conf(c), zero_head=False,
                                          vis=False,
                                          generator=torch.Generator().manual_seed(c))
                      .to(bf16).eval() for c in BASELINE_CONFS]

            def one_pass():
                for model in models:
                    model(x)

            one_pass()
            torch.cuda.synchronize()
            walls = [cs.timed_passes(models, x)[0] / cs.ITERS * 1e3 for _ in range(3)]
            line = {"phase": "pass", "B": cs.B, "wall_ms": walls}
            for impl in ("auto", "layer"):
                cs.set_impls(impl)
                try:
                    one_pass()
                    busy, groups, kernels, _ = cs.device_time(one_pass)
                finally:
                    cs.set_impls("auto")
                line[impl] = {"device_busy_ms": busy, "kernels": kernels,
                              "by_group_ms": groups}
            emit(line)
            del models, x

        if "latency" in phases:
            xl = torch.randn(max(cs.LATENCY_BATCHES), 128, 128, 5, 1, generator=gen,
                             device="cuda").to(bf16)
            single = VisionTransformer3D(ViTConfig.from_conf(9), zero_head=False,
                                         vis=False,
                                         generator=torch.Generator().manual_seed(9))
            ensemble = TransformerEnsemble(
                [ViTConfig.from_conf(c) for c in BEST_ENSEMBLE], zero_head=False,
                generator=torch.Generator().manual_seed(cs.SEED))
            served = {"conf9": single.to(bf16).eval(),
                      "ensemble_5_9_11": ensemble.to(bf16).eval()}
            runs = {(name, b): [] for name in served for b in cs.LATENCY_BATCHES}
            for _ in range(args.repeats):
                for name, model in served.items():
                    for batch in cs.LATENCY_BATCHES:
                        res, _ = cs.latency(model, xl, batch)
                        runs[name, batch].append(res["ms_per_batch"])
            for (name, batch), ms in runs.items():
                emit({"phase": "latency", "model": name, "B": batch,
                      "ms_per_batch": ms, "median_ms": statistics.median(ms)})
            xb = xl[:1].contiguous()
            busy, groups, kernels, _ = cs.device_time(lambda: served["conf9"](xb))
            emit({"phase": "latency_device", "model": "conf9", "B": 1,
                  "device_busy_ms": busy, "kernels": kernels, "by_group_ms": groups})
            del served, single, ensemble, xl, xb

        if "stretch_f32" in phases:
            f32 = torch.float32
            stretch = VisionTransformer3D(vit_b16_128cubed(), zero_head=False,
                                          vis=False,
                                          generator=torch.Generator().manual_seed(cs.SEED))
            stretch.eval()
            x1 = torch.randn(1, 128, 128, 128, 1, generator=gen, device="cuda")
            line = {"phase": "stretch_f32", "B": 1}
            for impl in ("auto", "layer"):
                cs.set_impls(impl)
                try:
                    stretch(x1)
                    busy, groups, kernels, _ = cs.device_time(lambda: stretch(x1))
                finally:
                    cs.set_impls("auto")
                line[impl] = {"device_busy_ms": busy, "kernels": kernels,
                              "k4_body_ms": groups.get("K4", 0.0),
                              "by_group_ms": groups}
            emit(line)
            del stretch, x1

            q, k, v = cs.model_views(gen, (8, 12, 513, 64), f32)
            fused_attention.fused_attention(q, k, v)
            _, groups, _, _ = cs.device_time(
                lambda: [fused_attention.fused_attention(q, k, v) for _ in range(10)],
                host_ops=False)
            emit({"phase": "k4_f32", "shape": [8, 12, 513, 64],
                  "device_ms": groups.get("K4", 0.0) / 10})
            qkv = torch.randn(1, 513, 3 * 768, generator=gen, device="cuda")
            q, k, v = attention_layer._split(qkv)
            attention_layer.attention_core(q, k, v, 12)
            _, groups, _, _ = cs.device_time(
                lambda: [attention_layer.attention_core(q, k, v, 12) for _ in range(10)],
                host_ops=False)
            emit({"phase": "k3_f32", "B": 1, "T": 513, "D": 768, "H": 12,
                  "device_ms": groups.get("K4", 0.0) / 10})
    print(json.dumps({"turn": args.turn, "ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

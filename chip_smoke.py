#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `vit3d_ensemble_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, and drives the port's
paths, each with the kernels' launch counters set to 0 just before it and
read just after:

  * serving: all 18 baseline ViTs in bf16 at B=512, then batch-1..8 latency
    of conf 9 and of the {5,9,11} stacking ensemble (K1, K2; K2 reads q, k,
    v in place from the QKV product and writes the context for the head
    merge, so the pass holds no copies around it; K1's bf16 calls run on
    K1c's `wgmma` pipeline: counters `K1_on_K1c` and `K1_own`);
  * training, in f32: `train_baseline` on conf 9 at full width and depth
    under the attention impls `auto` (K2, K1 in evaluation) and `layer`
    (K3), and `train_ensemble` on {5,9,11} under `layer`; with dropout off,
    each kernel run is held to the same run on the plain modules;
  * the stretch model, `vit_b16_128cubed` (128^3 volumes, 513 tokens,
    D=768, 12 layers) at full width and depth: in f32 at B=1 against the
    plain modules, then served in bf16 at B=8 under `auto` (K4, K1's wide
    body) and under `layer` (K3's sublayer, whose head_dim-64 core runs on
    K4's body: counter `K3_on_K4`);
  * the 18-model pass under `layer` too (K3's core at head_dim <= 16 on
    K2's body: counter `K3_on_K2`), by device time beside `auto`'s;
  * the sweep engine (`run_group`) on the three groups of conf 1-18;
  * the baseline drivers (`cli/train_baseline_cv`,
    `cli/train_baseline_whole_dataset`), conf 9 and all 18 configs, from a
    synthetic 99-patient dataset of PNGs and CSVs that the script writes
    (K1 in evaluation, K2).

Every line it prints is a JSON object.  The last is
`{"ok": true, "device": {...}}`; it is printed only when every check
passed.  The script exits non-zero, printing no result, when no CUDA device
is present or any check fails.  It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import ctypes
import dataclasses
import json
import logging
import math
import pathlib
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from vit3d_ensemble_tpu_torch.configs import (
    BASELINE_CONFS,
    BEST_ENSEMBLE,
    ViTConfig,
    vit_b16_128cubed,
)
from vit3d_ensemble_tpu_torch.cli import train_baseline_cv, train_baseline_whole_dataset
from vit3d_ensemble_tpu_torch.data import SplitArrays, native_loader
from vit3d_ensemble_tpu_torch.data import pool as data_pool
from vit3d_ensemble_tpu_torch.models import TransformerEnsemble, VisionTransformer3D
from vit3d_ensemble_tpu_torch.models import vit3d as vit3d_module
from vit3d_ensemble_tpu_torch.ops import (
    _build,
    attention,
    attention_layer,
    fused_attention,
    fused_mlp,
)
from vit3d_ensemble_tpu_torch.ops import mlp as mlp_select
from vit3d_ensemble_tpu_torch.sweep import engine, stack
from vit3d_ensemble_tpu_torch.sweep import stacked as stacked_module
from vit3d_ensemble_tpu_torch.train.ensemble_trainer import train_ensemble
from vit3d_ensemble_tpu_torch.train.trainer import init_baseline, train_baseline

SEED = 0
B = 512                     # volumes per step (`bench.py:201`)
ITERS = 20                  # iterations of the 18-model pass (`bench.py:208`)
REPEATS = 3                 # timed runs of the pass; only the first is counted
LATENCY_ITERS = 50
LATENCY_BATCHES = (1, 4, 8)

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# The TF32 tensor-core peak: K4's f32 body takes each f32 product as three
# TF32 ones (3xTF32), so its operations are 3x the product's at this rate.
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# Exponentials an SM issues a clock (MUFU.EX2, Hopper); the rate a second
# is this times the SMs times the SM clock nvidia-smi reports, set by main().
EX2_PER_SM_CLOCK = 16
exp_rate = 0.0
# FP32 instructions an SM issues a clock (4 schedulers of 32 lanes); a GELU
# costs the FP32 instructions and exponentials counted in its SASS by
# `phase_build`, so the card runs `gelu_rate[dtype]` GELUs of the kernels'
# type a second (set by main() and phase_build): the JAX kernels' rule,
# exact erf in f32 and the polynomial in bf16 (`GELU_OF`).
FP32_PER_SM_CLOCK = 128
fp32_rate = 0.0
GELU_OF = {torch.float32: "erf", torch.bfloat16: "poly"}
gelu_rate: dict = {}

# Kernel against plain version: the JAX package's own tolerances
# (`tests/test_pallas_mlp.py:31,47`, `tests/test_ops.py:31`).  Both sides
# accumulate in f32 and round at the same points, so they differ by the
# order of f32 sums and by bf16 rounding flips that order causes.
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (0.05, 0.05)}
# K4 in bf16 has a tighter gate of its own, and K2 is held to it too.  Its
# inputs are made so that the context has a root mean square of 1 at every
# S (see `model_views`, `k2_views`), where K4's largest error read 0.031 at
# |ctx| = 16 and at most 0.61 of this gate anywhere (NVIDIA H100 80GB HBM3),
# while a version that drops the last key misses it on 17 % of the elements
# at S = 513, by up to 89 times (phases `K4` and `K2` print both:
# `max_err_over_gate`, `dropped_key_*`).
K4_BF16_TOL = (0.02, 0.02)
# The serving path in bf16, kernels against the plain modules: the plain
# MLP and einsum attention round to bf16 after every op, the kernels only
# at the JAX kernels' points; over up to 8 pre-LN layers (12 in the stretch
# model, which read 0.094) that leaves a few bf16 ulps (0.03 at |t| = 4) on
# the normalised tokens.
TOKENS_BF16_ATOL = 0.25
# The same model in f32, kernels against plain modules (`test_model_parity`).
TOKENS_F32_ATOL = 2e-4
# Training in f32 with dropout off, kernels against plain modules: the
# kernels' forwards differ from the plain ones by f32 sum order (<= 2e-5 a
# layer), which 40 SGD steps carry into the losses.
TRAIN_LOSS_ATOL = 1e-4
# The best evaluation's 11 metrics, kernels against plain modules: the
# counts must agree exactly; Brier scores and AUROC move with the same f32
# noise in the probabilities.
TRAIN_METRICS_ATOL = 1e-4
# Gradients of a squared loss, kernel against plain version: each input's
# largest difference over its largest gradient.  The forwards' f32 sum
# order gave at most 5.0e-7 of it (K1; K3 2.4e-4 at gradients of ~1,000).
GRAD_RTOL = 1e-4

# The stretch path (`benchmarks/stretch_vitb.py:28,47`): volumes a batch and
# passes of a timed run.
STRETCH_B = 8
STRETCH_ITERS = 20

#: Each kernel's launch counter: the wrapper module and the attribute that
#: its wrapper adds one to per launch.
KERNELS = {"K1": (fused_mlp, "launches"),
           # K1's launches on K1c's `wgmma` pipeline (bf16, D 16-64) and on
           # its own bodies
           "K1_on_K1c": (fused_mlp, "launches_on_k1c"),
           "K1_own": (fused_mlp, "launches_own"),
           "K2": (fused_attention, "launches"),
           "K3": (attention_layer, "launches"),
           # K3's core launches that took K2's body (head_dim <= 16) and
           # K4's (head_dim 32/64/128)
           "K3_on_K2": (attention_layer, "launches_k2"),
           "K3_on_K4": (attention_layer, "launches_k4"),
           "K4": (fused_attention, "launches_k4"),
           "K1b": (fused_mlp, "launches_k1b"), "K1c": (fused_mlp, "launches_k1c")}
#: The fused-FFN kernels by `fused_mlp._MLP_VARIANT`.
VARIANT_KERNELS = {"seq": "K1", "chunked": "K1b", "pipelined2": "K1c"}

failures: list = []
#: the card's name and power limit, as nvidia-smi gives them, set by main()
card = ""


T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line, stamped with the card's name and power limit
    once known, and the seconds since the start."""
    stamp = {"card": card} if card else {}
    print(json.dumps({**obj, **stamp, "t": round(time.perf_counter() - T0, 3)}),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)


def time_ms(fn, iters: int) -> float:
    """Mean device ms per call over `iters` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype, exps: float = 0.0,
          gelus: float = 0.0, peak: float = 0.0) -> tuple:
    """The least ms the card could take: the largest of the operations over
    the peak rate for their type (the products' at the tensor cores' or
    FP32 peak, or at `peak` where given, and the GELUs of the type's form,
    `GELU_OF`, at their FP32 instructions' and exponentials' rate,
    whichever is longer), the bytes over the memory rate and the
    exponentials over the card's exponential rate; and which one it is."""
    ops = max(flops / (peak or PEAK_FLOPS[dtype]),
              gelus / gelu_rate[dtype] if gelus else 0.0)
    times = {"operations": ops, "bytes": nbytes / PEAK_BYTES,
             "exponentials": exps / exp_rate}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def compare(out, ref, dtype, tol=None) -> tuple:
    atol, rtol = tol or TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()), ok, atol, rtol


def counts_of(**nonzero) -> dict:
    """Launch counts of every kernel: 0 but for those named."""
    return {name: nonzero.get(name, 0) for name in KERNELS}


def k1_split(n: int, dtype, D: int) -> dict:
    """`n` K1 launches at hidden size D, by the body `fused_mlp` routes
    them to: counts_of's arguments for K1 and its body counter."""
    body = fused_mlp._k1_body(dtype, D)
    return {"K1": n, "K1_on_K1c" if body == "wgmma_pipeline" else "K1_own": n}


def reset_launches() -> None:
    for module, counter in KERNELS.values():
        setattr(module, counter, 0)


def launches() -> dict:
    return {name: getattr(module, counter)
            for name, (module, counter) in KERNELS.items()}


def smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """Each library's entries, most registers, spilled bytes, the (mangled)
    entries that spill, and ptxas's notes that it serialised wgmmas
    (C7515; C7518: for a wait it put in a divergent path) or waited on one
    itself (C7517)."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    entries = re.findall(r"Function properties for (\S+)\n\s+\d+ bytes stack "
                         r"frame, (\d+) bytes spill stores", log)
    return {"entries": len(regs), "max_registers": max(regs, default=None),
            "spill_store_bytes": sum(int(n) for _, n in entries),
            "spilling_entries": [name for name, n in entries if int(n)],
            "wgmma_serialized": log.count("(C7515)"),
            "wgmma_serialized_divergent": log.count("(C7518)"),
            "wgmma_wait_injected": log.count("(C7517)")}


def sass_of(path) -> str:
    """`cuobjdump -sass` of a library or cubin (the toolkit's cuobjdump,
    beside its nvcc)."""
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def sass_count(name: str, opcode: str) -> int:
    """Lines of the SASS of `csrc/<name>.cu`'s library that hold the opcode."""
    return sum(opcode in line for line in sass_of(_build.library_path(name)).splitlines())


# The fused FFNs' two GELUs (`mlp_common.cuh`: exact erf, the f32 bodies';
# the TPU kernels' polynomial, the bf16 bodies'), each alone in a kernel
# beside the same kernel without it, compiled with the kernels' flags into
# a library of its own: the difference of their SASS is a GELU's
# instructions, and the library's entry runs either on the card.
GELU_PROBE = """
#include "mlp_common.cuh"
extern "C" __global__ void gelu_erf_probe(float* x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = mlp::gelu_erf(x[i]);
}
extern "C" __global__ void gelu_poly_probe(float* x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = mlp::gelu_poly(x[i]);
}
extern "C" __global__ void copy_probe(float* x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = __int_as_float(__float_as_int(x[i]) ^ 0x80000000);
}
// which: 0 exact erf, 1 the polynomial; in place on x[0:n]
extern "C" int gelu_probe_launch(int which, float* x, int n, void* stream) {
  auto* k = which == 0 ? gelu_erf_probe : gelu_poly_probe;
  k<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, n);
  return (int)cudaGetLastError();
}
// mma.sync m16n8k8 in TF32 (K4's f32 body's instruction): each warp runs
// `iters` rounds of 8 independent products
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a, uint32_t b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a), "r"(a + 1), "r"(a + 2), "r"(a + 3), "r"(b), "r"(b + 1));
}
extern "C" __global__ void mma_tf32_probe(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a = threadIdx.x, b = 3 * threadIdx.x;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(c[j], a, b + j);
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_tf32_probe_launch(float* out, int blocks, int iters, void* stream) {
  mma_tf32_probe<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}
// whether mma.sync in TF32 overlaps FP32 work: each warp runs `iters` rounds
// of MMA products (8 independent accumulators) and FMA rounds of 8
// independent FFMAs; `which` 0 the products alone, 1 the FFMAs alone, 2 both
template <int MMA, int FMA>
__global__ void overlap_probe(float* out, int iters) {
  float c[8][4] = {};
  float f[8];
  for (int j = 0; j < 8; ++j) f[j] = threadIdx.x * 0.001f + j;
  const uint32_t a = threadIdx.x, b = 3 * threadIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < MMA; ++k) mma_tf32(c[k % 8], a, b + k);
#pragma unroll
    for (int k = 0; k < FMA; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = fmaf(f[j], 1.0001f, 0.5f);
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += f[j] + c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int overlap_probe_launch(int which, float* out, int blocks, int iters, void* stream) {
  auto* k = which == 0 ? overlap_probe<16, 0> : which == 1 ? overlap_probe<0, 64>
                                                            : overlap_probe<16, 64>;
  k<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
SASS_LINE = re.compile(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
GELU_PROBE_LIB = "libgelu_probe.so"
# The device GELUs on 2**20 points of [-8, 8] against their plain versions,
# F.gelu and `fused_mlp.poly_gelu`: both sides round the same f32
# operations in the same order (and take erff from CUDA's math library).
GELU_PROBE_POINTS = 2 ** 20
GELU_PROBE_ATOL = 1e-6


def start_gelu_probe():
    """Write the probe's source and start its nvcc; returns the process."""
    out = _build.BUILD_DIR / "gelu_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(GELU_PROBE)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", str(out / GELU_PROBE_LIB), str(out / "probe.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


# The TF32 rate that `mma.sync` reaches: 8 blocks of 4 warps an SM, each
# warp 4,096 rounds of 8 independent m16n8k8 products (2,048 operations
# each).  Set by `phase_build`; K4's f32 cases give their bound at it too.
MMA_PROBE_ITERS = 4096
mma_tf32_rate = 0.0


def mma_tf32_probe() -> dict:
    """TFLOP/s of `mma.sync` m16n8k8 in TF32 on every SM, by CUDA events
    (the probe library's `mma_tf32_probe`, built beside the GELU probes)."""
    global mma_tf32_rate
    launch = ctypes.CDLL(str(_build.BUILD_DIR / "gelu_probe" / GELU_PROBE_LIB)
                         ).mma_tf32_probe_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    errors = []
    ms = time_ms(lambda: errors.append(launch(out.data_ptr(), blocks,
                                              MMA_PROBE_ITERS, stream)), 5)
    mma_tf32_rate = blocks * 4 * MMA_PROBE_ITERS * 8 * 2048 / (ms * 1e-3)
    return {"tflops": mma_tf32_rate / 1e12, "ms": ms, "blocks": blocks,
            "launch_errors": sum(e != 0 for e in errors)}


OVERLAP_PROBE_ITERS = 4096


def overlap_probe() -> dict:
    """ms of the probe library's `overlap_probe` on one block of 4 warps an
    SM (a warp an SM sub-partition), by CUDA events: 16 `mma.sync` m16n8k8
    TF32 products a round alone, 512 FFMAs a round alone, and both in one
    round, with the share of the two alone that both take (1: no overlap)."""
    launch = ctypes.CDLL(str(_build.BUILD_DIR / "gelu_probe" / GELU_PROBE_LIB)
                         ).overlap_probe_launch
    launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    errors = []
    ms = [time_ms(lambda: errors.append(launch(which, out.data_ptr(), blocks,
                                               OVERLAP_PROBE_ITERS, stream)), 3)
          for which in range(3)]
    return {"mma_ms": ms[0], "ffma_ms": ms[1], "both_ms": ms[2],
            "both_over_sum": ms[2] / (ms[0] + ms[1]),
            "launch_errors": sum(e != 0 for e in errors)}


def gelu_probe(proc) -> dict:
    """Each GELU's SASS instructions by pipe, `fp32` (F* opcodes: FFMA, FMUL,
    FADD, FMNMX, FSEL...), `mufu` (the exponential unit) and `other`, from
    its probe kernel less the copy kernel, constants materialised in
    registers (MOV, HFMA2.MMA, IMAD.MOV: hoisted out of a kernel's loops)
    left out; and its largest difference from its plain version on the
    card."""
    log, _ = proc.communicate(timeout=300)
    if proc.returncode:
        raise RuntimeError(f"GELU probe build failed:\n{log}")
    lib = _build.BUILD_DIR / "gelu_probe" / GELU_PROBE_LIB
    counts = {}
    for fn in sass_of(lib).split("Function : ")[1:]:
        name = fn.split()[0]
        ops = [m.group(2) for m in SASS_LINE.finditer(fn)]
        ops = [o for o in ops if o not in ("NOP", "MOV", "HFMA2.MMA", "IMAD.MOV.U32")]
        counts[name] = collections.Counter(
            "mufu" if o.startswith("MUFU") else "fp32" if o[0] == "F" else "other"
            for o in ops)
    launch = ctypes.CDLL(str(lib)).gelu_probe_launch
    launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    h = torch.linspace(-8.0, 8.0, GELU_PROBE_POINTS, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for which, (form, plain) in enumerate((("erf", F.gelu),
                                           ("poly", fused_mlp.poly_gelu))):
        y = h.clone()
        err = launch(which, y.data_ptr(), y.numel(), stream)
        torch.cuda.synchronize()
        probe, copy = counts[f"gelu_{form}_probe"], counts["copy_probe"]
        out[form] = {**{k: probe[k] - copy[k] for k in ("fp32", "mufu", "other")},
                     "launch_error": err,
                     "max_abs_err_vs_plain": float((y - plain(h)).abs().max())}
    return out


def host_libraries() -> dict:
    """Which of PIL, pandas, sklearn and cv2 the host's Python could
    import (neither the port nor this script imports them), with their
    versions, and the libpng shared objects there: the one the dynamic
    loader finds and those Pillow bundles (no header comes with them)."""
    import ctypes.util
    import importlib.metadata
    import importlib.util
    out = {}
    for module, dist in (("PIL", "pillow"), ("pandas", "pandas"),
                         ("sklearn", "scikit-learn"), ("cv2", None)):
        spec = importlib.util.find_spec(module)
        try:
            version = importlib.metadata.version(dist) if dist and spec else None
        except importlib.metadata.PackageNotFoundError:
            version = None
        out[module] = {"importable": spec is not None, "version": version}
        if module == "PIL" and spec is not None and spec.origin:
            libs = pathlib.Path(spec.origin).parent.parent / "pillow.libs"
            out["pillow_bundled_libpng"] = sorted(p.name for p in libs.glob("libpng*"))
    out["libpng_loader_finds"] = (ctypes.util.find_library("png16")
                                  or ctypes.util.find_library("png"))
    return out


def phase_build() -> None:
    # the PNG decoder of the `cli` phase: `native/volume_loader.cpp` built
    # with g++ against libpng, or the stdlib fallback where that fails
    t0 = time.perf_counter()
    decoder = native_loader.status()
    emit({"phase": "build_native_decoder", "seconds": time.perf_counter() - t0,
          "libpng_linked": decoder["decoder"] == "native", **decoder,
          "host_libraries": host_libraries()})
    t0 = time.perf_counter()
    probe = start_gelu_probe()
    logs = _build.build(["fused_mlp", "mlp_chunked", "mlp_pipelined",
                         "tiny_attention", "attention"])
    seconds = time.perf_counter() - t0
    # a library built before this run: the compiler's report saved beside it
    logs = {name: log or _build.library_path(name).with_suffix(".log").read_text()
            for name, log in logs.items()}
    # K1's bf16 wide body, K1c's bf16 body and K4's bf16 body run on wgmma
    # fed by TMA: their SASS holds HGMMA and UTMALDG instructions; K2's bf16
    # body at head_dim 16 runs on mma.sync (HMMA), and both its bodies on
    # MUFU.EX2; K4's f32 body on mma.sync in TF32, in every instantiation
    sass = {f"{name}_sass_{op.lower()}": sass_count(name, op)
            for name in ("fused_mlp", "mlp_pipelined", "attention")
            for op in ("HGMMA", "UTMALDG")}
    sass.update({f"tiny_attention_sass_{op.lower().replace('.', '_')}":
                 sass_count("tiny_attention", op) for op in ("HMMA", "MUFU.EX2")})
    tf32 = k4_f32_sass()
    k1_tf32 = k1_f32_sass()
    k1b_tf32 = k1b_f32_sass()
    k1b_ptxas = ptxas_summary(logs["mlp_chunked"])
    attention_ptxas = ptxas_summary(logs["attention"])
    mlp_ptxas = ptxas_summary(logs["fused_mlp"])
    gelu = gelu_probe(probe)
    mma = mma_tf32_probe()
    overlap = overlap_probe()
    # each GELU's FP32 instructions at the FP32 pipes' issue rate, its
    # exponentials (one a GELU at most) at the exponential unit's
    for dtype, form in GELU_OF.items():
        g = gelu[form]
        gelu_rate[dtype] = min(fp32_rate / max(g["fp32"], 1),
                               exp_rate / g["mufu"] if g["mufu"] else math.inf)
    emit({"phase": "build", "seconds": seconds,
          "nvcc_flags": " ".join(_build.NVCC_FLAGS),
          "ptxas": {name: ptxas_summary(log) for name, log in logs.items()},
          **sass, "attention_f32_sass_hmma_tf32": tf32,
          "fused_mlp_f32_sass_hgmma_tf32": k1_tf32,
          "mlp_chunked_f32_sass_hmma_tf32": k1b_tf32,
          "k1_f32_plan": [k1_f32_plan(*case) for case in K1_F32_PLAN_CASES],
          "k1b_f32_plan": [fused_mlp.k1b_f32_plan(*case) for case in K1B_F32_PLAN_CASES],
          "k4_plan": [k4_plan(*shape, dtype) for dtype in (torch.bfloat16, torch.float32)
                      for shape in K4_PLAN_SHAPES],
          "k1c_plan": [k1c_plan(*case) for case in K1C_PLAN_CASES],
          "gelu_instructions": gelu, "gelu_probe_points": GELU_PROBE_POINTS,
          "gelu_probe_atol": GELU_PROBE_ATOL, "mma_sync_tf32": mma,
          "mma_sync_tf32_ffma_overlap": overlap,
          "gelus_per_s": {GELU_OF[d]: r for d, r in gelu_rate.items()}})
    for name, n in sass.items():
        check(n > 0, f"{name}: the library holds no such instruction")
    check(len(tf32) == 6 and all(n > 0 for n in tf32.values()),
          f"K4's f32 instantiations' TF32 HMMAs: {tf32}")
    check(mma["launch_errors"] == 0 and mma["tflops"] > 0,
          f"mma.sync TF32 probe: {mma}")
    check(overlap["launch_errors"] == 0 and overlap["both_ms"] > 0,
          f"mma.sync / FFMA overlap probe: {overlap}")
    check(not any("tf32x3" in e for e in attention_ptxas["spilling_entries"]),
          f"K4's f32 body spills: {attention_ptxas['spilling_entries']}")
    check(len(k1_tf32) == 3 and all(n > 0 for n in k1_tf32.values()),
          f"K1's wide f32 instantiations' TF32 HGMMAs: {k1_tf32}")
    check(not any("tf32x3" in e or "split_sum" in e
                  for e in mlp_ptxas["spilling_entries"]),
          f"K1's wide f32 body spills: {mlp_ptxas['spilling_entries']}")
    check(mlp_ptxas["wgmma_serialized"] == mlp_ptxas["wgmma_serialized_divergent"] == 0,
          "ptxas serialised K1's wgmmas")
    check(len(k1b_tf32) == len(fused_mlp.WIDTHS) and all(n > 0 for n in k1b_tf32.values()),
          f"K1b's f32 instantiations' TF32 HMMAs: {k1b_tf32}")
    check(not any("tf32x3" in e for e in k1b_ptxas["spilling_entries"]),
          f"K1b's f32 body spills: {k1b_ptxas['spilling_entries']}")
    for form, g in gelu.items():
        check(g["fp32"] > 0 and g["launch_error"] == 0
              and g["max_abs_err_vs_plain"] <= GELU_PROBE_ATOL,
              f"GELU probe {form}: {g}")
    check(gelu["poly"]["mufu"] == 0, f"the polynomial GELU takes exponentials: {gelu}")
    check(ptxas_summary(logs["mlp_pipelined"])["wgmma_serialized"] == 0,
          "ptxas serialised K1c's wgmmas")


# K1c's grid at the shapes of its phase: the bf16 serving pass (one model)
# and the sweep's evaluation with the model axis in f32 and bf16.
K1C_PLAN_CASES = ((torch.bfloat16, 64, B * 65, 1), (torch.float32, 64, 24 * 65, 30),
                  (torch.bfloat16, 64, 24 * 65, 30))


def k1c_plan(dtype, D: int, n: int, models: int) -> dict:
    """`fused_mlp.k1c_plan` at one shape from the card's occupancy, with the
    body's registers and shared memory."""
    shape = fused_mlp.k1c_shape(torch.device("cuda", torch.cuda.current_device()),
                                D, dtype)
    plan = fused_mlp.k1c_plan(n, models, shape["tile_rows"],
                              shape["sms"] * shape["blocks_an_sm"])
    check(plan["blocks"] <= plan["slots"], f"K1c plan {plan} exceeds the slots")
    return {"dtype": str(dtype).split(".")[1], "D": D, "n": n, "models": models,
            **shape, **plan}


def k1b_f32_sass() -> dict:
    """Lines of TF32 HMMA in each instantiation of K1b's f32 body (one a D),
    by its mangled name in the library's SASS."""
    return {fn.split()[0]: sum("HMMA" in line and "TF32" in line
                               for line in fn.splitlines())
            for fn in sass_of(_build.library_path("mlp_chunked")).split("Function : ")[1:]
            if "chunked_tf32x3_kernel" in fn.split()[0]}


# K1b's f32 grids at its timed shapes: the model axis (30 models of 1,560
# rows) and the serving shape.
K1B_F32_PLAN_CASES = ((24 * 65, 30), (B * 65, 1))


def k1_f32_sass() -> dict:
    """Lines of TF32 HGMMA in each instantiation of K1's wide f32 body (its
    three epilogues), by its mangled name in the library's SASS."""
    return {fn.split()[0]: sum("HGMMA" in line and "TF32" in line
                               for line in fn.splitlines())
            for fn in sass_of(_build.library_path("fused_mlp")).split("Function : ")[1:]
            if "wide_tf32x3_kernel" in fn.split()[0]}


# K1's wide f32 grids at the K1 phase's stretch shapes (D = 768, M = 3,072).
K1_F32_PLAN_CASES = tuple((N, 768, 3072, active) for N in (STRETCH_B * 513, 513, 70)
                          for active in (3072, 2072))


def k1_f32_plan(N: int, D: int, M: int, active: int) -> dict:
    """`fused_mlp.wide_f32_plan` at one shape on this card."""
    return fused_mlp.wide_f32_plan(N, D, M, active,
                                   torch.cuda.get_device_properties(0).multi_processor_count)


def k4_f32_sass() -> dict:
    """Lines of TF32 HMMA in each instantiation of K4's f32 body (head_dim,
    16- or 4-byte copies), by its mangled name in the library's SASS."""
    return {fn.split()[0]: sum("HMMA" in line and "TF32" in line
                               for line in fn.splitlines())
            for fn in sass_of(_build.library_path("attention")).split("Function : ")[1:]
            if "attention_tf32x3_kernel" in fn.split()[0]}


# K4's bodies at the stretch path's shape (and K3's on them, the same), and
# at head_dim 128 and 32 on the card tests' S = 200.
K4_PLAN_SHAPES = ((STRETCH_B, 12, 513, 64), (2, 4, 200, 128), (2, 4, 200, 32))
# `attention_plan`'s report: in bf16 the query tiles are a consumer
# warpgroup's 64 rows and a key step 16 keys, the registers those at entry
# (before setmaxnreg); in f32 a warp's 16 rows and 8 keys
K4_PLAN_KEYS = {
    torch.bfloat16: ("rows_a_block", "threads_a_block", "smem_bytes_a_block",
                     "registers_at_entry", "blocks_an_sm", "sms", "blocks",
                     "warpgroup_tiles", "one_tile_blocks", "key_steps_a_tile",
                     "tiles_on_busiest_sm"),
    torch.float32: ("rows_a_block", "threads_a_block", "smem_bytes_a_block",
                    "registers", "blocks_an_sm", "sms", "blocks", "warp_tiles",
                    "blocks_with_an_idle_warp", "key_steps_a_tile",
                    "tiles_on_busiest_sm")}


def k4_plan(nb: int, H: int, S: int, hd: int, dtype=torch.bfloat16) -> dict:
    """K4's tiles and waves at one shape for the body of `dtype`, as
    `attention_plan` reckons them from the runtime's occupancy, with the
    waves of blocks and the query tiles an SM on average beside the busiest
    SM's."""
    keys = K4_PLAN_KEYS[dtype]
    out = (ctypes.c_int * len(keys))()
    fn = _build.entry("attention", [ctypes.c_int] * 6 + [ctypes.c_void_p],
                      "attention_plan")
    _build.check("attention", fn(torch.cuda.current_device(), nb, H, S, hd,
                                 fused_attention._DTYPES[dtype], out))
    plan = dict(zip(keys, out))
    return {"dtype": str(dtype).split(".")[1], "shape": [nb, H, S, hd], **plan,
            "waves": plan["blocks"] / (plan["sms"] * plan["blocks_an_sm"]),
            "tiles_an_sm_mean": plan[keys[7]] / plan["sms"]}


# The training path's shapes, in f32: token rows of a batch of 4 volumes
# (260, the train forwards with dropout off) and of the 24 validation
# volumes (1,560, every evaluation); both leave a partial last row tile.
TRAIN_ROWS = (4 * 65, 24 * 65)
# (D, M) of the trained configs: conf 9 (16, 2048), conf 5 (32, 2048),
# conf 11 (32, 3072); training runs every column (no width mask).
K1_TRAIN_WIDTHS = ((16, 2048), (32, 2048), (32, 3072))


@contextlib.contextmanager
def mlp_variant(variant: str):
    """`fused_mlp._MLP_VARIANT` set to `variant` inside the block."""
    before = fused_mlp._MLP_VARIANT
    fused_mlp._MLP_VARIANT = variant
    try:
        yield
    finally:
        fused_mlp._MLP_VARIANT = before


def mlp_weights(gen, dtype, D: int, M: int, lead=()) -> list:
    """xavier-scaled weights (the model's init) and small biases."""
    bound_w = (6.0 / (D + M)) ** 0.5

    def uniform(*shape):
        return ((torch.rand(*lead, *shape, generator=gen, device="cuda") * 2 - 1)
                * bound_w).to(dtype)

    def small(n):
        return (torch.randn(*lead, n, generator=gen, device="cuda") * 0.02).to(dtype)

    w1 = uniform(M, D)
    b1 = small(M)
    w2 = uniform(D, M)
    return [w1, b1, w2, small(D)]


#: The trace groups of the fused-FFN kernels (KERNEL_GROUPS); the calls of
#: a K1, K1b or K1c case launch nothing else.
MLP_GROUPS = ("K1", "K1b", "K1c")


def mlp_device_ms(fn, calls: int = 10) -> float:
    """Device ms a call of the fused-FFN kernels under the profiler, over
    `calls` calls of `fn`."""
    _, groups, _, _ = device_time(lambda: [fn() for _ in range(calls)],
                               host_ops=False)
    return sum(groups.get(g, 0.0) for g in MLP_GROUPS) / calls


def host_ms(fn, iters: int = 50, repeats: int = 5) -> float:
    """Host ms to make a call, synchronising before and after each run of
    `iters` calls but not between them: what a call costs the host while
    the card works.  The median of `repeats` runs, as the host is shared."""
    runs = []
    for _ in range(repeats):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(runs) / iters * 1e3


def k1_case(gen, dtype, N: int, D: int, M: int, active, path: str,
            variant: str = "seq", models: int = 0, device: bool = False) -> dict:
    """A fused-FFN kernel (K1, or the variant's K1b or K1c) against its
    plain version on one shape, timed.  With `models` > 0 the weights carry
    that leading model axis and `active` is a list of one width a model,
    given to the kernel as a device tensor; the library chain is then
    `baddbmm` -> `F.gelu` -> `baddbmm` with the width mask folded into w2,
    as the JAX wrapper folds it (`pallas_mlp.py:172-176`).  The chain
    computes exact erf GELU in every type: it is the yardstick of time, and
    the kernels are held to their plain versions.  With `device`, the
    kernel's and the chain's device time under the profiler too: the
    events' `ms` is no less than the host's time to make a call."""
    lead = (models,) if models else ()
    x = torch.randn(*lead, N, D, generator=gen, device="cuda").to(dtype)
    w1, b1, w2, b2 = mlp_weights(gen, dtype, D, M, lead)
    plain = (fused_mlp._plain_mlp_chunked if variant == "chunked"
             else fused_mlp._plain_mlp)
    if models:
        widths = torch.tensor(active, dtype=torch.int32, device="cuda")
        w2m = w2 * (torch.arange(M, device="cuda") < widths[:, None, None]).to(dtype)
        b1u, b2u = b1.unsqueeze(1), b2.unsqueeze(1)
        w1t, w2t = w1.transpose(1, 2), w2m.transpose(1, 2)

        def library():
            return torch.baddbmm(b2u, F.gelu(torch.baddbmm(b1u, x, w1t)), w2t)
        live = sum(active)
    else:
        widths = active
        w1a, b1a = w1[:active], b1[:active]
        w2a = w2[:, :active].contiguous()

        def library():
            return F.linear(F.gelu(F.linear(x, w1a, b1a)), w2a, b2)
        live = active

    def call():
        return fused_mlp.fused_mlp(x, w1, b1, w2, b2, widths)

    with torch.no_grad(), mlp_variant(variant):
        out = call()
        body = fused_mlp.k1_body_launched() if variant == "seq" else None
        ref = plain(x, w1, b1, w2, b2, widths)
        err, ok, atol, rtol = compare(out, ref, dtype)
        over_gate_ratio = over_gate(out, ref, (atol, rtol))[1]
        ms = time_ms(call, 20)
        call_host_ms = host_ms(call)
        plain_ms = time_ms(lambda: plain(x, w1, b1, w2, b2, widths), 5)
        library_ms = time_ms(library, 20)
        device_ms = library_device_ms = None
        if device:
            device_ms = mlp_device_ms(call)
            check(device_ms > 0, f"{VARIANT_KERNELS[variant]} device time {device_ms}")
            library_device_ms = device_time(
                lambda: [library() for _ in range(10)], host_ops=False)[0] / 10
    elt = x.element_size()
    P = max(models, 1)
    flops = 4.0 * N * D * live
    nbytes = (elt * (2 * P * N * D + 2 * D * live + live + P * D)
              + (4 * P if models else 0))
    bound_ms, bound_by = bound(flops, nbytes, dtype, gelus=N * live)
    tf32 = {}
    if body == "wide_tf32x3" or (variant == "chunked" and dtype == torch.float32):
        # the products in 3xTF32: three times the operations at the TF32
        # peak, beside the same products on CUDA cores at the FP32 peak and
        # the three at the rate `mma.sync` reaches in TF32 on this card
        bound_ms, bound_by = bound(3 * flops, nbytes, dtype, gelus=N * live,
                                   peak=PEAK_TF32)
        tf32 = {"bound_ms_cuda_cores": bound(flops, nbytes, dtype, gelus=N * live)[0],
                "bound_ms_mma_sync": bound(3 * flops, nbytes, dtype, gelus=N * live,
                                           peak=mma_tf32_rate)[0]}
    case = {"phase": VARIANT_KERNELS[variant], "card": card, "path": path,
            "dtype": str(dtype).split(".")[1], "N": N, "D": D, "M": M,
            "active": active, "models": models, "body": body,
            "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": ok,
            "max_err_over_gate": over_gate_ratio,
            "ms": ms, "host_ms": call_host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_gelu": "erf",
            "bound_ms": bound_ms, "bound_by": bound_by, **tf32,
            # the bound's terms: the products at the peak for their type,
            # the GELUs of the kernels' form (`GELU_OF`) at their rate
            "products_ms": 4.0 * N * D * live / PEAK_FLOPS[dtype] * 1e3,
            "gelu": GELU_OF[dtype], "gelus_ms": N * live / gelu_rate[dtype] * 1e3}
    if device:
        case.update(device_ms=device_ms, library_device_ms=library_device_ms)
    emit(case)
    check(ok, f"{case['phase']} {case}")
    return case


# The stretch path's K1 shapes: D=768, M=3072, the token rows of B=8 and of
# B=1 (both leave a partial row tile), and a few rows alone.
STRETCH_ROWS = (STRETCH_B * 513, 513, 70)
# K1's bf16 calls on the latency path: B = 1, 4 and 8 volumes of 65 tokens
# at conf 9's widths, each by device time.
LATENCY_ROWS = tuple(b * 65 for b in LATENCY_BATCHES)
LATENCY_WIDTHS = (16, 2048)


def phase_k1(gen) -> tuple:
    """K1 against its plain version at the serving path's shapes (in bf16
    at M = 3,072 and at conf 9's widths by device time too), at the latency
    path's (LATENCY_ROWS), at the training path's, then at the stretch
    path's (the wide bodies).  Returns the serving and the stretch path's
    largest bf16 cases, and the latency path's cases."""
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        for D in (16, 32, 64):
            for M in (2048, 3072):
                for active in (M, M - 1000):
                    timed = dtype == torch.bfloat16 and active == M and (
                        M == 3072 or (D, M) == LATENCY_WIDTHS)
                    case = k1_case(gen, dtype, B * 65, D, M, active, "serve",
                                   device=timed)
                    if (dtype, D, M, active) == (torch.bfloat16, 64, 3072, 3072):
                        main = case
    # a generator of their own, so the phases that follow draw what they drew
    own = torch.Generator(device="cuda").manual_seed(SEED + 2)
    small = [k1_case(own, torch.bfloat16, N, *LATENCY_WIDTHS, LATENCY_WIDTHS[1],
                     "latency", device=True) for N in LATENCY_ROWS]
    for N in TRAIN_ROWS:
        for D, M in K1_TRAIN_WIDTHS:
            k1_case(gen, torch.float32, N, D, M, M, "train")
    wide, wide_f32 = None, []
    for dtype in (torch.bfloat16, torch.float32):
        for N in STRETCH_ROWS:
            for active in (3072, 2072):
                # device time too at B=8 and B=1, where the events' ms is the
                # host's cost of a call
                case = k1_case(gen, dtype, N, 768, 3072, active, "stretch",
                               device=N in STRETCH_ROWS[:2])
                if (dtype, N, active) == (torch.bfloat16, STRETCH_ROWS[0], 3072):
                    wide = case
                if dtype == torch.float32:
                    check(case["body"] == "wide_tf32x3", f"K1 f32 wide body {case}")
                    if N in STRETCH_ROWS[:2] and active == 3072:
                        wide_f32.append(case)
    return main, wide, small, wide_f32


def phase_f32_scaled(variant: str, N: int, D: int, seed: int) -> dict:
    """K1's wide f32 body (variant "seq", D = 768) or K1b's f32 body
    ("chunked") with x four times larger, where the 3xTF32 products'
    truncation inside the tensor cores weighs most, held to the exact (f64)
    MLP at the f32 tolerance at M = 3,072; the f32 plain version's own
    distance from it is printed beside.  Its inputs come from a generator
    of its own (`seed`), so the phases that follow draw what they drew."""
    own = torch.Generator(device="cuda").manual_seed(seed)
    M, kernel = 3072, VARIANT_KERNELS[variant]
    x = torch.randn(N, D, generator=own, device="cuda") * 4
    w1, b1, w2, b2 = mlp_weights(own, torch.float32, D, M)
    plain = fused_mlp._plain_mlp_chunked if variant == "chunked" else fused_mlp._plain_mlp
    with torch.no_grad(), mlp_variant(variant):
        before = launches()[kernel]
        out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, M)
        launched = launches()[kernel] - before
        body = fused_mlp.k1_body_launched() if variant == "seq" else None
        ref = exact_mlp(x, w1, b1, w2, b2)
        over, ratio = over_gate(out, ref, TOL[torch.float32])
        plain_over, plain_ratio = over_gate(plain(x, w1, b1, w2, b2, M), ref,
                                            TOL[torch.float32])
    case = {"phase": f"{kernel}_f32_scaled", "shape": [N, D, M], "x_scale": 4.0,
            "body": body, "launches": launched, "reference": "f64",
            "over_gate": over, "max_err_over_gate": ratio, "plain_over_gate": plain_over,
            "plain_max_err_over_gate": plain_ratio,
            "ok": over == 0 and launched == 1 and body in (None, "wide_tf32x3")}
    emit(case)
    check(case["ok"], f"{kernel} f32 scaled {case}")
    return case


def exact_mlp(x, w1, b1, w2, b2):
    """K1's function at full width in f64 from the inputs as they are (exact
    erf GELU): the exact result, against which an f32 plain version and
    the f32 kernel are both approximations."""
    x, w1, b1, w2, b2 = (t.double() for t in (x, w1, b1, w2, b2))
    return F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)


# (H, hd) of the trained configs: conf 9 (16, 1), conf 5 and 11 (8, 4).
K2_TRAIN_HEADS = ((16, 1), (8, 4))
# (B, H, S, hd) of the serving pass (conf 1-18's three classes at B=512)
# and of conf 19-22's 257 tokens at B=64.
K2_SERVE_SHAPES = ((B, 4, 65, 16), (B, 8, 65, 4), (B, 16, 65, 1))
K2_T257_SHAPES = ((64, 4, 257, 4), (64, 8, 257, 1))


def k2_views(gen, shape, dtype, offset: int = 0) -> list:
    """q, k, v as the serving model hands them to K2: (B, H, S, hd) views
    into one (B, S, 3, H, hd) QKV product, `offset` elements into its
    storage (1: no view is 16-byte aligned).  v is scaled by sqrt(S / e),
    so that the context's root mean square is 1 at every S (see
    `model_views`)."""
    nb, H, S, hd = shape
    qkv = torch.randn(nb, S, 3, H, hd, generator=gen, device="cuda")
    qkv[:, :, 2] *= math.sqrt(S / math.e)
    flat = torch.empty(offset + qkv.numel(), dtype=dtype, device="cuda")
    qkv = flat[offset:].view(qkv.shape).copy_(qkv)
    return list(qkv.permute(2, 0, 3, 1, 4))


def k2_case(gen, dtype, shape, path: str, offset: int = 0,
            device: bool = True) -> dict:
    """K2 against its plain version on the model's QKV views, timed; SDPA
    on the same views, and on contiguous copies of them, is the library
    yardstick (the port never calls it).  bf16 has K4's gate on a context
    of rms 1, f32 the JAX tolerance; at S >= 64 the gate must reject the
    plain version without the last key (at S = 65 the key past a 64-key
    tile).  With `device`, the device times under the profiler: `device_ms`
    K2's kernel alone, `call_device_ms` every kernel of a call."""
    nb, H, S, hd = shape
    q, k, v = k2_views(gen, shape, dtype, offset)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    tol = K4_BF16_TOL if dtype == torch.bfloat16 else None
    plain = fused_attention._plain_attention
    with torch.no_grad():
        before = fused_attention.launches
        out = fused_attention.fused_attention(q, k, v)
        torch.cuda.synchronize()
        one_launch = fused_attention.launches == before + 1
        ref = plain(q, k, v)
        err, ok, atol, rtol = compare(out, ref, dtype, tol)
        gate = atol + rtol * ref.float().abs()
        dropped = (plain(q, k[:, :, :-1], v[:, :, :-1]).float()
                   - ref.float()).abs() / gate
        dropped_share = float((dropped > 1).float().mean())
        gate_ok = S < 64 or dropped_share > 0
        merged = out.transpose(1, 2).reshape(nb, S, H * hd)
        view_ok = merged.data_ptr() == out.data_ptr() and merged.is_contiguous()
        ms = time_ms(lambda: fused_attention.fused_attention(q, k, v), 50)
        plain_ms = time_ms(lambda: plain(q, k, v), 10)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 50)
        # at these shapes the events' ms is mostly the host's; the kernels'
        # own times are their device times under the profiler
        timed = {}
        if device:
            busy, groups, _, _ = device_time(
                lambda: [fused_attention.fused_attention(q, k, v)
                         for _ in range(10)], host_ops=False)
            timed = {
                "device_ms": groups.get("K2", 0.0) / 10,
                "call_device_ms": busy / 10,
                "library_device_ms": device_time(
                    lambda: [F.scaled_dot_product_attention(q, k, v)
                             for _ in range(10)], host_ops=False)[0] / 10,
                "library_contiguous_device_ms": device_time(
                    lambda: [F.scaled_dot_product_attention(qc, kc, vc)
                             for _ in range(10)], host_ops=False)[0] / 10}
    bh = nb * H
    bound_ms, bound_by = bound(4.0 * bh * S * S * hd,
                               4.0 * bh * S * hd * q.element_size(), dtype,
                               exps=bh * S * S)
    case = {"phase": "K2", "path": path, "dtype": str(dtype).split(".")[1],
            "B": nb, "H": H, "S": S, "hd": hd, "views": "qkv",
            "offset_elements": offset, "max_abs_err": err, "atol": atol,
            "rtol": rtol, "ok": ok, "ctx_rms": float(ref.float().square().mean().sqrt()),
            "max_err_over_gate": float(((out.float() - ref.float()).abs() / gate).max()),
            "gate_rejects_dropped_key": gate_ok,
            "dropped_key_share_over_gate": dropped_share,
            "dropped_key_max_over_gate": float(dropped.max()),
            "heads_merge_as_view": view_ok, "one_launch": one_launch,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **timed,
            "bound_ms": bound_ms, "bound_by": bound_by}
    emit(case)
    check(ok and gate_ok and view_ok and one_launch
          and timed.get("device_ms", 1.0) > 0, f"K2 {case}")
    return case


def phase_k2(gen) -> dict:
    """K2 against its plain version on the model's QKV views: the serving
    pass's shapes in bf16 and f32, bf16 once more on views that are not
    16-byte aligned, conf 19-22's shapes at T=257 in bf16, then the training
    path's in f32 (a batch of 4, the 24 validation volumes).  Returns the
    serving cases in bf16 by head_dim, and the training cases."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in K2_SERVE_SHAPES:
            case = k2_case(gen, dtype, shape, "serve",
                           device=dtype == torch.bfloat16)
            if dtype == torch.bfloat16:
                out[shape[-1]] = case
    out["unaligned"] = k2_case(gen, torch.bfloat16, K2_SERVE_SHAPES[0],
                               "serve", offset=1)
    out["t257"] = [k2_case(gen, torch.bfloat16, shape, "serve_t257")
                   for shape in K2_T257_SHAPES]
    out["train"] = [k2_case(gen, torch.float32, (nb, H, 65, hd), "train")
                    for nb in (4, 24) for H, hd in K2_TRAIN_HEADS]
    return out


# K3 at (B, T, D, H): conf 1-18's (D, H) classes at B=512, conf 19-22's at
# B=64 (p=8: 257 tokens), the stretch model at B=2, and head_dim 2 and 8
# (no registry config: K2's body takes every head_dim up to 16); then the
# training path's own shapes in f32: conf 9 (D=16, H=16) at the batch of 4
# and at the 24 validation volumes, and conf 5/11's class at 4; then the
# stretch path's under `layer`: bf16 at its batch, f32 at B=1.
K3_CASES = ((512, 65, 64, 4), (512, 65, 32, 8), (512, 65, 16, 16),
            (64, 257, 16, 4), (64, 257, 8, 8), (2, 513, 768, 12),
            (512, 65, 16, 8), (512, 65, 64, 8))
K3_TRAIN_CASES = ((4, 65, 16, 16), (24, 65, 16, 16), (4, 65, 32, 8),
                  (24, 65, 32, 8))
K3_STRETCH_CASES = ((torch.bfloat16, (STRETCH_B, 513, 768, 12)),
                    (torch.float32, (1, 513, 768, 12)))
# K3's core also timed on the device (the events' ms is mostly the host's),
# beside SDPA's on the same views: the three serving classes in bf16, conf
# 19-22's (16, 4) class at T=257, the f32 training shape, and the stretch
# path's
K3_DEVICE_TIMED = ((torch.bfloat16, K3_CASES[0]), (torch.bfloat16, K3_CASES[1]),
                   (torch.bfloat16, K3_CASES[2]), (torch.bfloat16, K3_CASES[3]),
                   (torch.float32, K3_TRAIN_CASES[0])) + K3_STRETCH_CASES


def phase_k3(gen) -> tuple:
    """K3 against its plain version; SDPA on the same q, k, v views is the
    library yardstick (the port never calls it).  The core runs on the body
    of the fused attention kernel that serves its head_dim: K2's up to 16
    (counter `K3_on_K2`; each case names the body K2's dispatch reports it
    launched, `fused_attention.k2_body_launched`), K4's at 64 (`K3_on_K4`).  Each case is held as phases `K2` and
    `K4` hold those bodies: v in the QKV buffer is scaled so that the
    context's root mean square is 1 (see `model_views`), bf16 has K4's gate,
    and at T >= 64 the plain version without the last key must fail it.
    The cases of K3_DEVICE_TIMED also take both device times under the
    profiler.  Returns the training path's main case, the stretch path's
    cases by dtype and the serving cases timed on the device."""
    main, stretch = None, {}
    serve = []
    cases = [(dtype, shape) for dtype in (torch.bfloat16, torch.float32)
             for shape in K3_CASES]
    cases += [(torch.float32, shape) for shape in K3_TRAIN_CASES]
    cases += K3_STRETCH_CASES
    for dtype, (nb, T, D, H) in cases:
        hd = D // H
        on_k4 = hd in attention_layer.HEAD_DIMS_K4
        qkv = torch.randn(nb, T, 3 * D, generator=gen, device="cuda")
        qkv[..., 2 * D:] *= math.sqrt(T / math.e)
        qkv = qkv.to(dtype)
        q, k, v = attention_layer._split(qkv)
        heads = [t.unflatten(-1, (H, hd)).transpose(1, 2) for t in (q, k, v)]
        tol = K4_BF16_TOL if dtype == torch.bfloat16 else None
        timed = (dtype, (nb, T, D, H)) in K3_DEVICE_TIMED
        with torch.no_grad():
            before = launches()
            out = attention_layer.attention_core(q, k, v, H)
            counts = {name: n - before[name] for name, n in launches().items()}
            body = (f"K4:{fused_attention.k4_body_launched()}" if on_k4
                    else f"K2:{fused_attention.k2_body_launched()}")
            ref = attention_layer._plain_attention_core(q, k, v, H)
            err, ok, atol, rtol = compare(out, ref, dtype, tol)
            gate = atol + rtol * ref.float().abs()
            short = attention_layer._plain_attention_core(q, k[:, :-1], v[:, :-1], H)
            dropped = (short.float() - ref.float()).abs() / gate
            gate_check = {
                "ctx_rms": float(ref.float().square().mean().sqrt()),
                "max_err_over_gate":
                    float(((out.float() - ref.float()).abs() / gate).max()),
                "dropped_key_share_over_gate": float((dropped > 1).float().mean()),
                "dropped_key_max_over_gate": float(dropped.max())}
            gate_check["gate_rejects_dropped_key"] = (
                T < 64 or gate_check["dropped_key_share_over_gate"] > 0)
            ms = time_ms(lambda: attention_layer.attention_core(q, k, v, H), 50)
            plain_ms = time_ms(
                lambda: attention_layer._plain_attention_core(q, k, v, H), 10)
            library_ms = time_ms(
                lambda: F.scaled_dot_product_attention(*heads), 50)
            device_ms = library_device_ms = None
            if timed:
                # only the core's kernel runs in the call
                device_ms = device_time(
                    lambda: [attention_layer.attention_core(q, k, v, H)
                             for _ in range(10)], host_ops=False)[0] / 10
                library_device_ms = device_time(
                    lambda: [F.scaled_dot_product_attention(*heads)
                             for _ in range(10)], host_ops=False)[0] / 10
        want = counts_of(K3=1, **{"K3_on_K4" if on_k4 else "K3_on_K2": 1})
        if on_k4:
            bounds = attention_bound(dtype, nb * H, T, hd, qkv.element_size())
        else:
            bound_ms, bound_by = bound(4.0 * nb * T * T * D,
                                       4.0 * nb * T * D * qkv.element_size(),
                                       dtype, exps=nb * H * T * T)
            bounds = {"bound_ms": bound_ms, "bound_by": bound_by}
        case = {"phase": "K3", "dtype": str(dtype).split(".")[1], "B": nb,
                "T": T, "D": D, "H": H, "hd": hd, "body": body,
                "launches": counts, "max_abs_err": err, "atol": atol,
                "rtol": rtol, "ok": ok, **gate_check,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                **bounds}
        if timed:
            case.update(device_ms=device_ms, library_device_ms=library_device_ms)
        emit(case)
        check(ok and counts == want and device_ms != 0.0
              and gate_check["gate_rejects_dropped_key"],
              f"K3 {case}, expected launches {want}")
        if (dtype, (nb, T, D, H)) == (torch.float32, K3_TRAIN_CASES[0]):
            main = case
        if (dtype, (nb, T, D, H)) in K3_STRETCH_CASES:
            stretch[dtype] = case
        if timed and (dtype, (nb, T, D, H)) not in K3_STRETCH_CASES:
            serve.append(case)
    return main, stretch, serve


# K4 at (B, H, S, hd) on the model's views: the stretch path's shape, the
# same at B=2, a small ragged one, and fewer keys than one chunk of 64; then
# where the bf16 body's tiling is most likely to break: S = 64 and 128 (no
# tail), S = 1 and 15 (fewer keys than the narrowest chunk of 16), S = 200
# at hd 32 and 128.  Last, the stretch shape at B=2 on K3's views into the
# (B, T, 3D) QKV buffer.
K4_CASES = tuple((shape, "model") for shape in (
    (STRETCH_B, 12, 513, 64), (2, 12, 513, 64), (3, 2, 70, 32), (2, 3, 40, 64),
    (2, 12, 64, 64), (2, 12, 128, 64), (2, 12, 1, 64), (2, 12, 15, 64),
    (2, 4, 200, 32), (2, 4, 200, 128))) + (((2, 12, 513, 64), "qkv"),)


def model_views(gen, shape, dtype) -> list:
    """q, k, v as `models/vit3d.Attention` makes them above D=64: the
    (B, H, S, hd) views of three (B, S, H * hd) projections.  q and k are
    unit normal, so a row's softmax spreads over about S / e keys; v is
    scaled by sqrt(S / e), so that the context's root mean square is 1
    whatever S is, and an absolute tolerance means the same at every shape."""
    nb, H, S, hd = shape
    scales = (1.0, 1.0, math.sqrt(S / math.e))
    return [(torch.randn(nb, S, H * hd, generator=gen, device="cuda") * c)
            .to(dtype).view(nb, S, H, hd).transpose(1, 2) for c in scales]


def qkv_views(gen, shape, dtype) -> list:
    """q, k, v as K3 hands them to K4's body: (B, H, S, hd) views into one
    (B, S, 3 * H * hd) QKV buffer, v scaled as in `model_views`."""
    nb, H, S, hd = shape
    qkv = torch.randn(nb, S, 3 * H * hd, generator=gen, device="cuda")
    qkv[..., 2 * H * hd:] *= math.sqrt(S / math.e)
    return [t.unflatten(-1, (H, hd)).transpose(1, 2)
            for t in attention_layer._split(qkv.to(dtype))]


def exact_attention_k4(q, k, v):
    """K4's function in f64 from the inputs as they are: the exact context,
    against which an f32 plain version and the f32 kernel are both
    approximations."""
    s = torch.einsum("...hqd,...hkd->...hqk", q.double(), k.double())
    s = s / math.sqrt(q.shape[-1])
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return torch.einsum("...hqk,...hkd->...hqd", e, v.double()) / e.sum(dim=-1, keepdim=True)


def over_gate(out, ref, tol) -> tuple:
    """The elements of out further from ref than atol + rtol |ref|, and the
    largest distance over that gate."""
    atol, rtol = tol
    ratio = (out.double() - ref.double()).abs() / (atol + rtol * ref.double().abs())
    return int((ratio > 1).sum()), float(ratio.max())


# K4 in f32 with q and k doubled at the stretch shape: scores 4 times
# larger, where the 3xTF32 products' hi * lo terms weigh most.  The kernel
# is held to the exact (f64) context at the f32 tolerance; the f32 plain
# version's distance from it is printed beside.
K4_F32_SCALED_SHAPE = (2, 12, 513, 64)


def without_last_key(q, k, v):
    """K4's plain version over all keys but the last; with a single key, the
    empty sum 0."""
    if k.shape[-2] == 1:
        return torch.zeros_like(q)
    return fused_attention._plain_attention_k4(q, k[:, :, :-1], v[:, :, :-1])


def attention_bound(dtype, bh: int, S: int, hd: int, elt: int) -> dict:
    """The bound of K4's function (K3's on K4's body the same) at (B * H, S,
    hd): q, k, v read and the context written once, 4 bh S^2 hd operations
    and bh S^2 exponentials.  The f32 body runs its products in 3xTF32:
    three times the operations at the TF32 peak, beside the bound of the
    same products on CUDA cores at the FP32 peak (`bound_ms_cuda_cores`) and
    of the three at the rate `mma.sync` reaches in TF32 on this card
    (`bound_ms_mma_sync`, `mma_tf32_probe`)."""
    flops, nbytes, exps = 4.0 * bh * S * S * hd, 4.0 * bh * S * hd * elt, bh * S * S
    if dtype != torch.float32:
        ms, by = bound(flops, nbytes, dtype, exps=exps)
        return {"bound_ms": ms, "bound_by": by}
    ms, by = bound(3 * flops, nbytes, dtype, exps=exps, peak=PEAK_TF32)
    return {"bound_ms": ms, "bound_by": by,
            "bound_ms_cuda_cores": bound(flops, nbytes, dtype, exps=exps)[0],
            "bound_ms_mma_sync": bound(3 * flops, nbytes, dtype, exps=exps,
                                       peak=mma_tf32_rate)[0]}


def phase_k4(gen) -> dict:
    """K4 against its plain version on the model's strided views; SDPA on
    the same views is the library yardstick (the port never calls it).  The
    gate is tried on a known fault in every case: the plain version without
    the last key (at S = 513 a key chunk's single live column) must fail it.
    The JAX kernel's own rounding (`_plain_attention`, normalised
    probabilities) is held to the JAX tolerance beside it.  Each case names
    the body the dispatch launched (`fused_attention.k4_body_launched`).
    Returns the stretch path's case in bf16 and in f32."""
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = K4_BF16_TOL if dtype == torch.bfloat16 else None
        for shape, views in K4_CASES:
            nb, H, S, hd = shape
            make = model_views if views == "model" else qkv_views
            q, k, v = make(gen, shape, dtype)
            with torch.no_grad():
                out = fused_attention.fused_attention(q, k, v)
                body = fused_attention.k4_body_launched()
                ref = fused_attention._plain_attention_k4(q, k, v)
                err, ok, atol, rtol = compare(out, ref, dtype, tol)
                short = without_last_key(q, k, v)
                gate = atol + rtol * ref.float().abs()
                over_gate_ratio = float(((out.float() - ref.float()).abs() / gate).max())
                dropped = (short.float() - ref.float()).abs() / gate
                dropped_share = float((dropped > 1).float().mean())
                gate_ok = dropped_share > 0
                jax_err, jax_ok, _, _ = compare(
                    out, fused_attention._plain_attention(q, k, v), dtype)
                rms = float(ref.float().square().mean().sqrt())
                exact = {}
                if dtype == torch.float32:
                    ref64 = exact_attention_k4(q, k, v)
                    exact = {"max_err_over_gate_exact":
                             over_gate(out, ref64, TOL[dtype])[1],
                             "plain_max_err_over_gate_exact":
                             over_gate(ref, ref64, TOL[dtype])[1]}
                    del ref64
                merged = out.transpose(1, 2).reshape(nb, S, H * hd)
                view_ok = merged.data_ptr() == out.data_ptr()
                ms = time_ms(lambda: fused_attention.fused_attention(q, k, v), 50)
                plain_ms = time_ms(
                    lambda: fused_attention._plain_attention_k4(q, k, v), 10)
                library_ms = time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v), 50)
                # `ms` is no less than the host's time to make one call; the
                # kernel's own time is its device time under the profiler
                device_ms = library_device_ms = None
                if S == 513:
                    _, groups, _, _ = device_time(
                        lambda: [fused_attention.fused_attention(q, k, v)
                                 for _ in range(10)], host_ops=False)
                    device_ms = groups.get("K4", 0.0) / 10
                    library_device_ms = device_time(
                        lambda: [F.scaled_dot_product_attention(q, k, v)
                                 for _ in range(10)], host_ops=False)[0] / 10
            case = {"phase": "K4", "dtype": str(dtype).split(".")[1], "B": nb,
                    "H": H, "S": S, "hd": hd, "views": views, "body": body,
                    "max_abs_err": err, "atol": atol,
                    "rtol": rtol, "ok": ok, "ctx_rms": rms,
                    "max_err_over_gate": over_gate_ratio, **exact,
                    "gate_rejects_dropped_key": gate_ok,
                    "dropped_key_share_over_gate": dropped_share,
                    "dropped_key_max_over_gate": float(dropped.max()),
                    "max_abs_err_normalised_rounding": jax_err,
                    "ok_normalised_rounding": jax_ok,
                    "heads_merge_as_view": view_ok,
                    "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "library_device_ms": library_device_ms,
                    **attention_bound(dtype, nb * H, S, hd, q.element_size())}
            emit(case)
            body_ok = body == ("bf16_wgmma" if dtype == torch.bfloat16
                               else "f32_tf32x3")
            check(ok and gate_ok and jax_ok and view_ok and body_ok
                  and device_ms != 0.0, f"K4 {case}")
            if (shape, views) == K4_CASES[0]:
                main[dtype] = case
    # drawn from a generator of its own, so the phases that follow draw what
    # they drew before this case
    own = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v = model_views(own, K4_F32_SCALED_SHAPE, torch.float32)
    q, k = q * 2, k * 2
    with torch.no_grad():
        out = fused_attention.fused_attention(q, k, v)
        body = fused_attention.k4_body_launched()
        ref = exact_attention_k4(q, k, v)
        over, ratio = over_gate(out, ref, TOL[torch.float32])
        plain_over, plain_ratio = over_gate(
            fused_attention._plain_attention_k4(q, k, v), ref, TOL[torch.float32])
        dropped_over, _ = over_gate(exact_attention_k4(q, k[:, :, :-1], v[:, :, :-1]),
                                    ref, TOL[torch.float32])
    case = {"phase": "K4_f32_scaled", "shape": list(K4_F32_SCALED_SHAPE),
            "qk_scale": 2.0, "body": body, "reference": "f64",
            "over_gate": over, "max_err_over_gate": ratio,
            "plain_over_gate": plain_over, "plain_max_err_over_gate": plain_ratio,
            "gate_rejects_dropped_key": dropped_over > 0,
            "ok": over == 0 and dropped_over > 0 and body == "f32_tf32x3"}
    emit(case)
    check(case["ok"], f"K4 f32 scaled {case}")
    return main


def phase_gradients(gen) -> None:
    """Each kernel's autograd Function against autograd through its plain
    version, in f32 at a small shape, two ways.

    `wiring`: one fixed cotangent (`tests/test_ops.py:128-130`).  The
    backwards recompute through the plain versions from the saved inputs,
    so this compares the same arithmetic: it catches inputs saved or
    gradients returned in the wrong order, or a missing gradient, and
    nothing of the kernel's forward.

    `forward`: the squared loss sum(out**2), whose cotangent 2*out is the
    kernel's own output.  A forward that is off by e relative to the
    output's scale moves the gradients by about e relative to theirs, so
    each input's gradient is held to GRAD_RTOL of its largest entry."""
    x = torch.randn(2, 65, 16, generator=gen, device="cuda")
    w1 = torch.randn(2048, 16, generator=gen, device="cuda") * 0.1
    b1 = torch.randn(2048, generator=gen, device="cuda") * 0.1
    w2 = torch.randn(16, 2048, generator=gen, device="cuda") * 0.1
    b2 = torch.randn(16, generator=gen, device="cuda") * 0.1
    qkv = [torch.randn(2, 4, 65, 16, generator=gen, device="cuda")
           for _ in range(3)]
    wide = [torch.randn(2, 35, 128, generator=gen, device="cuda"),
            torch.randn(256, 128, generator=gen, device="cuda") * 0.05,
            torch.randn(256, generator=gen, device="cuda") * 0.1,
            torch.randn(128, 256, generator=gen, device="cuda") * 0.05,
            torch.randn(128, generator=gen, device="cuda") * 0.1]
    layer = [torch.randn(2, 65, 32, generator=gen, device="cuda"),
             torch.randn(96, 32, generator=gen, device="cuda") * 0.3,
             torch.randn(96, generator=gen, device="cuda") * 0.1,
             torch.randn(32, 32, generator=gen, device="cuda") * 0.3,
             torch.randn(32, generator=gen, device="cuda") * 0.1]
    cases = {
        "K1": (lambda *a: fused_mlp.fused_mlp(*a, 1500),
               lambda *a: fused_mlp._plain_mlp(*a, 1500), [x, w1, b1, w2, b2]),
        "K2": (fused_attention.fused_attention,
               fused_attention._plain_attention, qkv),
        "K3": (lambda *a: attention_layer.fused_attention_layer(*a, 8),
               lambda *a: attention_layer._plain_attention_layer(*a, 8), layer),
        "K1 wide": (lambda *a: fused_mlp.fused_mlp(*a, 200),
                    lambda *a: fused_mlp._plain_mlp(*a, 200), wide),
        "K4": (fused_attention.fused_attention,
               fused_attention._plain_attention_k4,
               model_views(gen, (2, 2, 70, 64), torch.float32)),
    }
    # three models of one launch, each its own width (K1's model axis, K1b,
    # K1c), from a generator of their own, so the draws above stay as they were
    own = torch.Generator(device="cuda").manual_seed(SEED + 1)
    stacked = [torch.randn(3, 130, 16, generator=own, device="cuda"),
               *mlp_weights(own, torch.float32, 16, 1100, (3,))]
    widths = torch.tensor([1100, 600, 30], dtype=torch.int32, device="cuda")

    def in_variant(variant):
        def run(*a):
            with mlp_variant(variant):
                return fused_mlp.fused_mlp(*a, widths)
        return run

    # the sublayer at head_dim 64, its core on K4's body
    layer64 = [torch.randn(2, 70, 128, generator=own, device="cuda"),
               torch.randn(384, 128, generator=own, device="cuda") * 0.1,
               torch.randn(384, generator=own, device="cuda") * 0.1,
               torch.randn(128, 128, generator=own, device="cuda") * 0.1,
               torch.randn(128, generator=own, device="cuda") * 0.1]
    cases.update({
        "K1 model axis": (in_variant("seq"),
                          lambda *a: fused_mlp._plain_mlp(*a, widths), stacked),
        "K1b": (in_variant("chunked"),
                lambda *a: fused_mlp._plain_mlp_chunked(*a, widths), stacked),
        "K1c": (in_variant("pipelined2"),
                lambda *a: fused_mlp._plain_mlp(*a, widths), stacked),
        "K3 on K4's body": (
            lambda *a: attention_layer.fused_attention_layer(*a, 2),
            lambda *a: attention_layer._plain_attention_layer(*a, 2), layer64),
    })
    for name, (kernel, plain, args) in cases.items():
        grads, cotangent = [], None
        for fn in (kernel, plain):
            leaves = [a.detach().clone().requires_grad_() for a in args]
            out = fn(*leaves)
            if cotangent is None:
                mine = args is stacked or args is layer64
                cotangent = torch.randn(out.shape, device="cuda",
                                        generator=own if mine else gen)
            out.backward(cotangent)
            grads.append([t.grad for t in leaves])
        err = max(float((a - b).abs().max()) for a, b in zip(*grads))
        ok = all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                 for a, b in zip(*grads))
        emit({"phase": "gradient", "kernel": name, "check": "wiring",
              "max_abs_err": err, "atol": 1e-4, "rtol": 1e-4, "ok": ok})
        check(ok, f"{name} gradient wiring, max abs err {err}")

        grads = []
        for fn in (kernel, plain):
            leaves = [a.detach().clone().requires_grad_() for a in args]
            fn(*leaves).square().sum().backward()
            grads.append([t.grad for t in leaves])
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(*grads))
        err = max(float((a - b).abs().max()) for a, b in zip(*grads))
        ok = rel <= GRAD_RTOL
        emit({"phase": "gradient", "kernel": name, "check": "forward",
              "max_abs_err": err, "max_err_over_scale": rel,
              "rtol_of_scale": GRAD_RTOL, "ok": ok})
        check(ok, f"{name} gradient of the squared loss, max err {rel} of "
                  f"the gradient's scale")


def set_impls(attention_impl: str) -> None:
    """Set the attention impl, and the MLP impl to match: `plain` with
    `plain` attention, `auto` otherwise."""
    attention.set_default_attention_impl(attention_impl)
    mlp_select.set_default_mlp_impl(
        "plain" if attention_impl == "plain" else "auto")


def phase_f32_model(gen) -> None:
    """One model per (D, H) class in f32 at B=2: kernels against the plain
    modules, with the tolerance of the JAX parity tests."""
    for conf in (1, 2, 3):
        model = VisionTransformer3D(ViTConfig.from_conf(conf), zero_head=False,
                                    vis=False,
                                    generator=torch.Generator().manual_seed(conf))
        with torch.no_grad():
            emb = model.transformer.embeddings
            emb.position_embeddings.normal_(0.0, 0.02, generator=gen)
            emb.cls_token.normal_(0.0, 0.02, generator=gen)
            x = torch.randn(2, 128, 128, 5, 1, generator=gen, device="cuda")
            out = model(x)
            set_impls("plain")
            ref = model(x)
            set_impls("auto")
        err = max(float((out.tokens - ref.tokens).abs().max()),
                  float((out.logits - ref.logits).abs().max()))
        ok = err <= TOKENS_F32_ATOL
        emit({"phase": "f32_model", "conf": conf, "max_abs_err": err,
              "atol": TOKENS_F32_ATOL, "ok": ok})
        check(ok, f"f32 conf {conf}: max abs err {err}")


def timed_passes(models, x, iters: int = ITERS) -> tuple:
    """`iters` calls of each model in turn: host seconds around the whole
    run, ending in a synchronize, and device ms per call of each model."""
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(models) + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i, model in enumerate(models):
        for _ in range(iters):
            model(x)
        events[i + 1].record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    per_model = {c: events[i].elapsed_time(events[i + 1]) / iters
                 for i, c in enumerate(BASELINE_CONFS)}
    return seconds, per_model


def phase_main_path(gen) -> dict:
    """All 18 baselines in bf16 at exact shapes, B volumes, ITERS passes."""
    x = torch.randn(B, 128, 128, 5, 1, generator=gen,
                    device="cuda").to(torch.bfloat16)
    models = [VisionTransformer3D(ViTConfig.from_conf(c), zero_head=False,
                                  vis=False,
                                  generator=torch.Generator().manual_seed(c))
              .to(torch.bfloat16).eval() for c in BASELINE_CONFS]
    with torch.no_grad():
        for model in models:        # warm-up: allocator, cuBLAS handles
            model(x)
        torch.cuda.synchronize()
        reset_launches()
        seconds, per_model = timed_passes(models, x)
        counts = launches()
        clocks = smi("clocks.sm,power.draw,temperature.gpu")
        # the same run again, for its spread (not counted above)
        repeats = [seconds] + [timed_passes(models, x)[0]
                               for _ in range(REPEATS - 1)]
        layers = sum(ViTConfig.from_conf(c).num_layers for c in BASELINE_CONFS)
        expected = layers * ITERS
        # K1 and K2 once a layer, K1 on the body of B volumes of 65 tokens
        # (every conf of 1-18 has D in 16..64); K1b, K1c never
        want = counts_of(K2=expected,
                         **k1_split(expected, torch.bfloat16, 64))
        emit({"phase": "main_path", "card": card, "B": B, "iters": ITERS,
              "seconds": seconds, "volumes_per_s": B * ITERS / seconds,
              "volumes_per_s_repeats": [B * ITERS / s for s in repeats],
              "launches": counts, "expected_launches": want,
              "ms_per_pass_by_conf": per_model, "after_run": clocks})
        check(counts == want, f"main path launched {counts}, expected {want}")

        for conf, model in zip(BASELINE_CONFS, models):
            out = model(x)
            set_impls("plain")
            ref = model(x)
            set_impls("auto")
            cfg = ViTConfig.from_conf(conf)
            shape_ok = (tuple(out.tokens.shape) == (B, cfg.seq_len, cfg.hidden_size)
                        and tuple(out.logits.shape) == (B, cfg.num_classes))
            finite = bool(torch.isfinite(out.tokens).all()
                          and torch.isfinite(out.logits).all())
            err = float((out.tokens.float() - ref.tokens.float()).abs().max())
            mean_err = float((out.tokens.float() - ref.tokens.float()).abs().mean())
            ok =shape_ok and finite and err <= TOKENS_BF16_ATOL
            emit({"phase": "main_path_check", "conf": conf,
                  "tokens_max_abs_err": err, "tokens_mean_abs_err": mean_err,
                  "atol": TOKENS_BF16_ATOL, "shape_ok": shape_ok,
                  "finite": finite, "ok": ok})
            check(ok, f"main path conf {conf}: err {err}, shape {shape_ok}, "
                      f"finite {finite}")
    return {"launches": counts, "models": models, "x": x,
            "ms_per_pass": statistics.median(repeats) / ITERS * 1e3}


# Kernel names -> the layers of PERF.md's breakdown, first match wins.
# `pipelined_wgmma_kernel` is K1's bf16 body at D 16-64 and K1c's: every
# path but the `variants` phase's K1c turns launches it as K1, so it is
# K1's group.
KERNEL_GROUPS = (("K1", "fused_mlp"), ("K1", "wide_gemm"), ("K1", "wide_tf32x3"),
                 ("K1", "split_sum"), ("K1b", "chunked_"),
                 ("K1", "pipelined_wgmma"), ("K1c", "pipelined_core"),
                 # every kernel of `attention.cu` (its bf16 and f32 bodies,
                 # and an older checkout's, as `chip_turns.py` times them)
                 ("K2", "tiny_attention"), ("K4", "attention_"),
                 ("layer_norm", "layer_norm"), ("cat", "CatArray"),
                 ("gemm", "nvjet"), ("gemm", "gemm"), ("gemm", "cutlass"),
                 ("optimizer", "multi_tensor"), ("softmax", "softmax"),
                 ("reduce", "reduce_kernel"), ("elementwise", "elementwise"))


PROFILE_TRIES = 4


def device_time(fn, host_ops: bool = True) -> tuple:
    """Kernel time on the device (ms) of one call of `fn` under
    torch.profiler, in total and by group, the number of kernels it ran,
    and that number by group.  Kernels of one stream do not overlap, so
    their sum is the time the device was busy.  `host_ops=False` records
    the device's kernels alone, which costs the host far less on a run of
    many small steps.  A trace can lack device events: on an H100 one held
    none in a run where the same case traced before and after, and one held
    3 of a case's 10 launches, and in one run four traces in a row of one
    case held none.  So the call is traced until two traces hold the same
    number of kernels, the most any held, up to PROFILE_TRIES times (twice
    that while every trace is empty), and the trace with the most is taken;
    `fn` runs once a try."""
    best = None
    for i in range(2 * PROFILE_TRIES):
        if i >= PROFILE_TRIES and best[2]:
            break
        busy, groups, kernels, counts, _ = traced(fn, host_ops)
        if best is not None and kernels and kernels == best[2]:
            break
        if best is None or kernels > best[2]:
            best = (busy, groups, kernels, counts)
    return best


def traced(fn, host_ops: bool = False) -> tuple:
    """One call of `fn` under torch.profiler: the device's busy ms, by
    group, its kernels, by group, and the host ms of the call inside the
    trace (from before `fn` to the end of a synchronize after it)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    counts: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = next((g for g, pat in KERNEL_GROUPS if pat in e.key), "other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
        counts[group] = counts.get(group, 0) + e.count
    return sum(groups.values()), groups, sum(counts.values()), counts, wall_ms


def phase_profile(main_path: dict, gen) -> float:
    """Device busy share of the main path and of B=1 serving: device time of
    one call under the profiler over the wall time of the same work measured
    without it (the profiler slows the host, not the kernels).  Returns the
    main path's device busy ms a pass."""
    models, x = main_path["models"], main_path["x"]

    def one_pass():
        for model in models:
            model(x)

    with torch.no_grad():
        busy, groups, kernels, by_group = device_time(one_pass)
    wall = main_path["ms_per_pass"]
    emit({"phase": "profile", "card": card, "work": "18-model pass, B=512",
          "device_busy_ms": busy, "wall_ms": wall,
          "device_idle_share": 1.0 - busy / wall, "kernels": kernels,
          "by_group_ms": groups, "kernels_by_group": by_group})
    check(busy > 0, "profiler saw no device time on the main path")
    auto_busy = busy
    xb = torch.randn(1, 128, 128, 5, 1, generator=gen,
                     device="cuda").to(torch.bfloat16)
    model = models[BASELINE_CONFS.index(9)]
    with torch.no_grad():
        res, _ = latency(model, xb, 1)
        busy, groups, kernels, by_group = device_time(lambda: model(xb))
    emit({"phase": "profile", "card": card, "work": "conf 9, B=1",
          "device_busy_ms": busy, "wall_ms": res["ms_per_batch"],
          "device_idle_share": 1.0 - busy / res["ms_per_batch"],
          "kernels": kernels, "by_group_ms": groups,
          "kernels_by_group": by_group})
    return auto_busy


def phase_layer_pass(main_path: dict, auto_busy: float) -> dict:
    """The 18-model bf16 pass at B=512 under `layer`: K3's sublayer in every
    layer, its core at head_dim 16, 4 and 1 on K2's body.  The device time
    of one pass under the profiler, taken as `profile` takes `auto`'s,
    beside that; the launch counts of one pass; and each model's tokens
    against the same model under `auto` (the same kernels on the same
    values but for the sublayer's projections)."""
    models, x = main_path["models"], main_path["x"]
    layers = sum(ViTConfig.from_conf(c).num_layers for c in BASELINE_CONFS)

    def one_pass():
        return [model(x).tokens for model in models]

    with torch.no_grad():
        ref = one_pass()
        set_impls("layer")
        try:
            one_pass()                  # warm-up
            reset_launches()
            out = one_pass()
            counts = launches()
            busy, groups, kernels, by_group = device_time(one_pass)
        finally:
            set_impls("auto")
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(out, ref))
    want = counts_of(K3=layers, K3_on_K2=layers,
                     **k1_split(layers, torch.bfloat16, 64))
    ok = counts == want and busy > 0 and err <= TOKENS_BF16_ATOL
    emit({"phase": "layer_pass", "card": card, "work": "18-model pass, B=512",
          "impl": "layer", "device_busy_ms": busy,
          "auto_device_busy_ms": auto_busy, "kernels": kernels,
          "by_group_ms": groups, "kernels_by_group": by_group,
          "launches": counts, "expected_launches": want,
          "tokens_max_abs_err_vs_auto": err, "atol": TOKENS_BF16_ATOL, "ok": ok})
    check(ok, f"layer pass: launched {counts} of {want}, busy {busy}, err {err}")
    return {"launches": counts, "device_busy_ms": busy}


def latency(model, x, batch: int):
    """Mean ms per batch over LATENCY_ITERS sequential calls, and one call
    alone, each ending in a synchronize; also the last output."""
    xb = x[:batch].contiguous()
    with torch.no_grad():
        for _ in range(3):
            model(xb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LATENCY_ITERS):
            model(xb)
        torch.cuda.synchronize()
        per_batch = (time.perf_counter() - t0) / LATENCY_ITERS * 1e3
        t0 = time.perf_counter()
        out = model(xb)
        torch.cuda.synchronize()
        one_shot = (time.perf_counter() - t0) * 1e3
    return {"ms_per_batch": per_batch, "one_shot_ms": one_shot}, out


def phase_latency(gen) -> None:
    """Serving latency through conf 9 and the {5,9,11} ensemble
    (`bench.py:105-127`), host clock around calls ending in a synchronize."""
    x = torch.randn(max(LATENCY_BATCHES), 128, 128, 5, 1, generator=gen,
                    device="cuda").to(torch.bfloat16)
    single = VisionTransformer3D(ViTConfig.from_conf(9), zero_head=False,
                                 vis=False,
                                 generator=torch.Generator().manual_seed(9))
    ensemble = TransformerEnsemble(
        [ViTConfig.from_conf(c) for c in BEST_ENSEMBLE], zero_head=False,
        generator=torch.Generator().manual_seed(SEED))
    for name, model in (("conf9", single), ("ensemble_5_9_11", ensemble)):
        model = model.to(torch.bfloat16).eval()
        for batch in LATENCY_BATCHES:
            reset_launches()
            res, out = latency(model, x, batch)
            counts = launches()
            out = out.logits if name == "conf9" else out
            # every K1 call of the batch on K1c's pipeline (conf 5, 9 and
            # 11 have D 32, 16 and 32)
            body = k1_split(counts["K1"], torch.bfloat16, 16)
            ok = (tuple(out.shape) == (batch, 1) and bool(torch.isfinite(out).all())
                  and all(counts[k] == n for k, n in body.items()))
            emit({"phase": "latency", "card": card, "model": name,
                  "B": batch, **res, "launches": counts,
                  "k1_body": fused_mlp.k1_body_launched(), "ok": ok})
            check(ok, f"latency {name} B={batch}: output {tuple(out.shape)}, "
                      f"launched {counts}")


def phase_stretch(gen) -> dict:
    """`vit_b16_128cubed` at full width and depth on seeded weights: in f32
    at B=1 against the plain modules, then served in bf16 at B=8 as
    `benchmarks/stretch_vitb.py` serves it, under `auto` (K4 and K1 a
    layer) and under `layer` (K3 and K1 a layer)."""
    cfg = vit_b16_128cubed()
    model = VisionTransformer3D(cfg, zero_head=False, vis=False,
                                generator=torch.Generator().manual_seed(SEED))
    model.eval()
    layers = cfg.num_layers
    # under `layer`, K3's head_dim-64 core runs on K4's body
    expect = {"auto": counts_of(K1=layers, K1_own=layers, K4=layers),
              "layer": counts_of(K1=layers, K1_own=layers, K3=layers,
                                 K3_on_K4=layers)}

    def run_plain(x):
        set_impls("plain")
        try:
            return model(x)
        finally:
            set_impls("auto")

    def passes(x) -> float:
        """Host seconds of STRETCH_ITERS passes, ending in a synchronize."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STRETCH_ITERS):
            model(x)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with torch.no_grad():
        emb = model.transformer.embeddings
        emb.position_embeddings.normal_(0.0, 0.02, generator=gen)
        emb.cls_token.normal_(0.0, 0.02, generator=gen)
        x = torch.randn(STRETCH_B, 128, 128, 128, 1, generator=gen,
                        device="cuda")

        ref = run_plain(x[:1])
        result = {}
        for impl in expect:
            set_impls(impl)
            reset_launches()
            try:
                out = model(x[:1])
                counts = launches()
                # a pass's device time; K4's body (`attention_tf32x3`) is
                # K4's under `auto` and K3's core under `layer`, K1's wide
                # f32 body (`wide_tf32x3`) K1's under both
                busy, groups, _, _ = device_time(lambda: model(x[:1]))
            finally:
                set_impls("auto")
            err = max(float((out.tokens - ref.tokens).abs().max()),
                      float((out.logits - ref.logits).abs().max()))
            ok = err <= TOKENS_F32_ATOL and counts == expect[impl] and busy > 0
            emit({"phase": "stretch_f32", "impl": impl, "B": 1,
                  "max_abs_err": err, "atol": TOKENS_F32_ATOL,
                  "launches": counts, "expected_launches": expect[impl],
                  "device_busy_ms": busy, "k1_ms": groups.get("K1", 0.0),
                  "k1_share": groups.get("K1", 0.0) / busy if busy else None,
                  "k4_body_ms": groups.get("K4", 0.0),
                  "k4_body_share": groups.get("K4", 0.0) / busy if busy else None,
                  "by_group_ms": groups, "ok": ok})
            check(ok, f"stretch f32 {impl}: max abs err {err}, launched "
                      f"{counts}, busy {busy}")
            result[f"f32_{impl}"] = {"launches": counts, "device_busy_ms": busy,
                                     "k1_ms": groups.get("K1", 0.0),
                                     "k4_body_ms": groups.get("K4", 0.0)}

        model.to(torch.bfloat16)
        x = x.to(torch.bfloat16)
        ref = run_plain(x)
        for impl in expect:
            set_impls(impl)
            try:
                model(x)                    # warm-up
                reset_launches()
                seconds = passes(x)
                counts = launches()
                clocks = smi("clocks.sm,power.draw,temperature.gpu")
                # the same run again, for its spread (not counted above)
                repeats = [seconds] + [passes(x) for _ in range(REPEATS - 1)]
                out = model(x)
                busy, groups, _, _ = device_time(lambda: model(x))
            finally:
                set_impls("auto")
            want = {k: n * STRETCH_ITERS for k, n in expect[impl].items()}
            wall = statistics.median(repeats) / STRETCH_ITERS * 1e3
            volumes = STRETCH_B * STRETCH_ITERS
            diff = (out.tokens.float() - ref.tokens.float()).abs()
            err = float(diff.max())
            shape_ok = (tuple(out.tokens.shape)
                        == (STRETCH_B, cfg.seq_len, cfg.hidden_size)
                        and tuple(out.logits.shape)
                        == (STRETCH_B, cfg.num_classes))
            finite = bool(torch.isfinite(out.tokens).all()
                          and torch.isfinite(out.logits).all())
            ok = (shape_ok and finite and err <= TOKENS_BF16_ATOL
                  and counts == want and busy > 0)
            emit({"phase": "stretch", "card": card, "impl": impl,
                  "config": "vit_b16_128cubed", "dtype": "bfloat16",
                  "B": STRETCH_B, "layers": layers, "iters": STRETCH_ITERS,
                  "seconds": seconds, "volumes_per_s": volumes / seconds,
                  "volumes_per_s_repeats": [volumes / r for r in repeats],
                  "ms_per_batch": wall, "launches": counts,
                  "expected_launches": want, "tokens_max_abs_err": err,
                  "tokens_mean_abs_err": float(diff.mean()),
                  "atol": TOKENS_BF16_ATOL, "shape_ok": shape_ok,
                  "finite": finite, "device_busy_ms": busy,
                  "device_idle_share": 1.0 - busy / wall,
                  "by_group_ms": groups, "after_run": clocks, "ok": ok})
            check(ok, f"stretch {impl}: err {err}, shape {shape_ok}, finite "
                      f"{finite}, launched {counts} of {want}, busy {busy}")
            result[impl] = {"launches": counts, "ms_per_batch": wall,
                            "volumes_per_s": volumes / seconds,
                            "device_busy_ms": busy}
    return result


# The training phases (`_common.py:69`'s batch of 4).  Data: synthetic
# volumes made from the seed, balanced labels, the positives shifted by 0.5.
TRAIN_N, VAL_N = 64, 24
TRAIN_STEPS, EVAL_EVERY = 40, 10
# SGD at the reference's default lr 1e-4 and warmup 1000 (defect D17) barely
# moves the weights in 40 steps; 1e-2 with a 10-step warmup trains, so the
# kernel-against-plain comparison covers weights that change.
BASELINE_HYPER = dict(num_steps=TRAIN_STEPS, eval_every=EVAL_EVERY,
                      train_batch_size=4, learning_rate=1e-2,
                      warmup_steps=10, seed=SEED)
ENSEMBLE_EPOCHS = 2
ENSEMBLE_HYPER = dict(num_epochs=ENSEMBLE_EPOCHS, train_batch_size=4,
                      learning_rate=1e-4, seed=SEED)


def synthetic_split(n: int, seed: int) -> SplitArrays:
    rng = np.random.default_rng(seed)
    labels = np.tile([0, 1], n // 2).astype(np.int32)
    volumes = rng.normal(size=(n, 128, 128, 5, 1)).astype(np.float32)
    volumes[labels == 1] += 0.5
    return SplitArrays(volumes, labels, [f"p{i}" for i in range(n)],
                       ["PZ"] * n)


def training_runs(name: str, run, steps: int, layers: int, evals: int,
                  impls, short_steps: int) -> dict:
    """Drive one trainer under each kernel impl in `impls`, dropout on and
    off, and under `plain` with dropout off, with the launch counters read
    around each run; check finite losses, the launch counts, and with
    dropout off each kernel run against the plain run.  Then time each impl
    (in turns: a, b, b, a) and take its device busy time."""
    forwards = steps + evals + 1           # + the end-of-run evaluation
    # with dropout on, K1 serves only the deterministic (evaluation)
    # forwards; with it off, every forward
    k1 = {True: layers * (evals + 1), False: layers * forwards}
    # under `layer` K3's core runs on K2's body (the trained configs' head
    # dims are at most 16)
    attn = {"auto": ("K2",), "layer": ("K3", "K3_on_K2")}
    expect = {(impl, dropout): counts_of(K1=k1[dropout], K1_own=k1[dropout], **{
        kernel: layers * forwards for kernel in attn[impl]})
              for impl in impls for dropout in (True, False)}
    expect[("plain", False)] = counts_of()
    results = {}
    counts = {}
    for impl, dropout in expect:
        set_impls(impl)
        reset_launches()
        try:
            res = run(dropout)
        finally:
            counts[(impl, dropout)] = launches()
            set_impls("auto")
        results[(impl, dropout)] = res
        tag = f"{impl}, dropout {'on' if dropout else 'off'}"
        finite = len(res.losses) == steps and all(map(math.isfinite, res.losses))
        got, want = counts[(impl, dropout)], expect[(impl, dropout)]
        emit({"phase": name, "impl": impl, "dropout": dropout,
              "launches": got, "expected_launches": want,
              "finite_losses": finite, "first_loss": res.losses[0],
              "last_loss": res.losses[-1], "best": res.metrics})
        check(finite, f"{name} {tag}: losses {res.losses}")
        check(got == want, f"{name} {tag}: launched {got}, expected {want}")
    plain = results[("plain", False)]
    for impl in impls:
        res = results[(impl, False)]
        loss_err = max(abs(a - b) for a, b in zip(res.losses, plain.losses))
        metric_err = max(abs(res.metrics[k] - plain.metrics[k])
                         for k in plain.metrics)
        ok = loss_err <= TRAIN_LOSS_ATOL and metric_err <= TRAIN_METRICS_ATOL
        emit({"phase": f"{name}_parity", "impl": impl, "against": "plain",
              "dropout": False, "max_loss_err": loss_err,
              "loss_atol": TRAIN_LOSS_ATOL, "max_metric_err": metric_err,
              "metric_atol": TRAIN_METRICS_ATOL, "ok": ok})
        check(ok, f"{name} {impl} vs plain: loss err {loss_err}, "
                  f"metric err {metric_err}")

    walls = {impl: [] for impl in impls}
    for impl in list(impls) + list(reversed(impls)):
        set_impls(impl)
        try:
            walls[impl].append(wall_time_ms(lambda: run(True)))
        finally:
            set_impls("auto")
    timing = {}
    for impl in impls:
        set_impls(impl)
        try:
            # the profiler's cost grows with the events it records: take
            # the busy share on the short run (its first evaluation period)
            short_ms = wall_time_ms(lambda: run(True, short=True))
            busy, groups, kernels, _ = device_time(
                lambda: run(True, short=True), host_ops=False)
        finally:
            set_impls("auto")
        check(busy > 0, f"{name} {impl}: the profiler saw no device time")
        timing[impl] = {"ms_per_step": [w / steps for w in walls[impl]],
                        "short_run_wall_ms": short_ms,
                        "short_run_device_busy_ms": busy,
                        "device_idle_share": 1.0 - busy / short_ms,
                        "kernels_per_step_short_run": kernels / short_steps}
        emit({"phase": f"{name}_time", "card": card, "impl": impl,
              "steps": steps, "evals": evals + 1, **timing[impl],
              "by_group_ms": groups})
    return {"launches": counts[(impls[-1], True)], "timing": timing}


def wall_time_ms(fn) -> float:
    """Host ms around one call of `fn`, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_train() -> dict:
    """`train_baseline` on conf 9 at full width and depth, f32."""
    cfg = ViTConfig.from_conf(9)
    train, val = synthetic_split(TRAIN_N, SEED), synthetic_split(VAL_N, SEED + 1)

    def run(dropout: bool, short: bool = False):
        config = cfg if dropout else dataclasses.replace(cfg, dropout_rate=0.0)
        hyper = dict(BASELINE_HYPER, **({"num_steps": EVAL_EVERY} if short
                                          else {}))
        return train_baseline(config, train, val, **hyper)

    return training_runs("train", run, TRAIN_STEPS, cfg.num_layers,
                         TRAIN_STEPS // EVAL_EVERY, ("auto", "layer"),
                         short_steps=EVAL_EVERY)


def phase_train_ensemble() -> dict:
    """`train_ensemble` on {5, 9, 11} at full width and depth, f32, members
    from seeded random weights."""
    cfgs = [ViTConfig.from_conf(c) for c in BEST_ENSEMBLE]
    members = [init_baseline(c, seed=n, device="cuda").state_dict()
               for n, c in zip(BEST_ENSEMBLE, cfgs)]
    train, val = synthetic_split(TRAIN_N, SEED), synthetic_split(VAL_N, SEED + 1)

    def run(dropout: bool, short: bool = False):
        configs = cfgs if dropout else [
            dataclasses.replace(c, dropout_rate=0.0) for c in cfgs]
        hyper = dict(ENSEMBLE_HYPER, **({"num_epochs": 1} if short else {}))
        return train_ensemble(configs, members, train, val, **hyper)

    steps = ENSEMBLE_EPOCHS * TRAIN_N // 4
    return training_runs("train_ensemble", run, steps,
                         sum(c.num_layers for c in cfgs), ENSEMBLE_EPOCHS,
                         ("layer",), short_steps=TRAIN_N // 4)

# K1 with the model axis at the sweep's evaluation shape (`run_group` on the
# (64, 4) group): 30 cells (6 confs x 5 folds) of 24 validation volumes x 65
# tokens, each cell its own width (confs 1, 4, 7: 2048; 10, 13, 16: 3072).
MODEL_AXIS_ROWS = VAL_N * 65
MODEL_AXIS_WIDTHS = [2048] * 15 + [3072] * 15


def phase_model_axis(gen) -> dict:
    """K1 with the model axis against its plain version, in f32 (the
    sweep's type) and bf16.  Returns the f32 case."""
    cases = {dtype: k1_case(gen, dtype, MODEL_AXIS_ROWS, 64, 3072,
                            MODEL_AXIS_WIDTHS, "sweep_eval",
                            models=len(MODEL_AXIS_WIDTHS))
             for dtype in (torch.float32, torch.bfloat16)}
    return cases[torch.float32]


def phase_mlp_variants(gen) -> dict:
    """K1b and K1c against their plain versions at K1's narrow serving
    shapes, masked and unmasked, and at the model-axis shape; by device time
    beside the library chain's: K1c's serving case at (bf16, D=64, M=3072),
    K1b's f32 serving case at (D=64, M=3072) (its 3xTF32 body) and both
    variants' model-axis cases in f32.  Returns each variant's serving case
    at (bf16, D=64, M=3072) and its model-axis case in f32, and K1b's f32
    serving case."""
    out = {}
    for variant in ("chunked", "pipelined2"):
        for dtype in (torch.bfloat16, torch.float32):
            for D in (16, 32, 64):
                for M in (2048, 3072):
                    for active in (M, M - 1000):
                        main = (dtype, D, M, active) == (torch.bfloat16, 64, 3072, 3072)
                        f32_main = (variant, dtype, D, M, active) == (
                            "chunked", torch.float32, 64, 3072, 3072)
                        case = k1_case(gen, dtype, B * 65, D, M, active, "serve", variant,
                                       device=(main and variant == "pipelined2") or f32_main)
                        if main:
                            out[variant] = case
                        if f32_main:
                            out["chunked_f32"] = case
            case = k1_case(gen, dtype, MODEL_AXIS_ROWS, 64, 3072,
                           MODEL_AXIS_WIDTHS, "sweep_eval", variant,
                           models=len(MODEL_AXIS_WIDTHS),
                           device=dtype == torch.float32)
            if dtype == torch.float32:
                out[f"{variant}_model_axis"] = case
    return out


# The 18-model pass timed under each variant in turns, as
# `benchmarks/kernel_variants.py:108-112` does; passes a turn.
VARIANT_TURNS = ("seq", "chunked", "pipelined2", "pipelined2", "chunked", "seq")
VARIANT_ITERS = 10


def phase_variants(main_path: dict) -> dict:
    """The 18-model bf16 pass at B=512 on K1, K1b and K1c in turns, with the
    launch counts that show which kernel ran, and each variant's tokens of
    conf 1 against K1's."""
    models, x = main_path["models"], main_path["x"]
    layers = sum(ViTConfig.from_conf(c).num_layers for c in BASELINE_CONFS)
    result = {v: {"volumes_per_s": []} for v in VARIANT_KERNELS}
    with torch.no_grad():
        ref = models[0](x).tokens.float()
        for variant in VARIANT_TURNS:
            kernel = VARIANT_KERNELS[variant]
            with mlp_variant(variant):
                for model in models:        # warm-up
                    model(x)
                reset_launches()
                seconds, _ = timed_passes(models, x, VARIANT_ITERS)
                counts = launches()
                err = float((models[0](x).tokens.float() - ref).abs().max())
            n = layers * VARIANT_ITERS
            want = counts_of(K2=n, **(k1_split(n, torch.bfloat16, 64)
                                      if kernel == "K1" else {kernel: n}))
            rate = B * VARIANT_ITERS / seconds
            ok = counts == want and err <= TOKENS_BF16_ATOL
            emit({"phase": "variants", "card": card, "variant": variant,
                  "kernel": kernel, "B": B, "iters": VARIANT_ITERS,
                  "seconds": seconds, "volumes_per_s": rate,
                  "launches": counts, "expected_launches": want,
                  "conf1_tokens_max_abs_err_vs_seq": err,
                  "atol": TOKENS_BF16_ATOL, "ok": ok})
            check(ok, f"variants {variant}: launched {counts} of {want}, "
                      f"tokens err {err}")
            result[variant]["volumes_per_s"].append(rate)
            result[variant].setdefault("launches", counts)
    return result


# The sweep: `run_group` over the three groups of confs 1-18 at full width
# and depth, f32, on F synthetic folds shaped like the training phases' data
# (TRAIN_N volumes to train, VAL_N to validate, drawn from one pool), with
# the training phases' hyperparameters; dropout as configured.
SWEEP_FOLDS = 5
SWEEP_POOL = 120
SWEEP_HYPER = dict(num_steps=20, eval_every=10, train_batch_size=4,
                   learning_rate=1e-2, warmup_steps=10, seed=SEED)
# A grouped run against `train_baseline` on the same cell, dropout 0: both
# run K1 and K2 on the same values, but the grouped linears are batched
# products (`torch.baddbmm`), whose f32 sums run in another order than
# `F.linear`'s; 20 SGD steps carry that into the parameters.
SWEEP_LOSS_ATOL = 1e-5
SWEEP_PARAM_ATOL = 1e-4
PooledSplit = collections.namedtuple("PooledSplit", "row_idx labels mean")


def sweep_data(hyper):
    """A balanced pool of volumes (positives shifted by 0.5) and SWEEP_FOLDS
    folds of disjoint train and validation rows."""
    rng = np.random.default_rng(SEED)
    labels = np.tile([0, 1], SWEEP_POOL // 2).astype(np.float32)
    pool = rng.normal(size=(SWEEP_POOL, 128, 128, 5, 1)).astype(np.float32)
    pool[labels == 1] += 0.5
    folds = []
    for _ in range(SWEEP_FOLDS):
        order = rng.permutation(SWEEP_POOL).astype(np.int32)
        tr, va = order[:TRAIN_N], order[TRAIN_N:TRAIN_N + VAL_N]
        mean = float(pool[tr].mean())
        folds.append((PooledSplit(tr, labels[tr], mean),
                      PooledSplit(va, labels[va], mean)))
    return pool, folds, engine.stack_folds(pool, folds, hyper)


def phase_sweep() -> dict:
    """`run_group` on each group: ms a step and cell-steps/s (host clock,
    set-up included, and with the set-up measured alone subtracted), the
    device's idle share and kernels a step on the first evaluation period,
    and the launch counts, K1's being its model-axis launches."""
    hyper = engine.SweepHyper(**SWEEP_HYPER)
    pool, folds, data = sweep_data(hyper)
    steps, evals = hyper.num_steps, hyper.num_steps // hyper.eval_every
    short = dataclasses.replace(hyper, num_steps=hyper.eval_every)
    result = {"groups": {}, "launches": counts_of()}
    for group in stack.group_configs(BASELINE_CONFS):
        G, L = len(group.confs), group.max_layers
        P = G * SWEEP_FOLDS
        runs = []
        reset_launches()
        wall = wall_time_ms(lambda: runs.append(engine.run_group(group, data, hyper)))
        counts = launches()
        res = runs[0]
        setup = wall_time_ms(lambda: stack.init_group_params(
            group, SWEEP_FOLDS, hyper.seed, device="cuda"))
        short_ms = wall_time_ms(lambda: engine.run_group(group, data, short))
        busy, groups, kernels, _ = device_time(
            lambda: engine.run_group(group, data, short), host_ops=False)
        # dropout on: K1 serves the evaluations (deterministic) alone, K2
        # every forward (attention dropout is 0)
        want = counts_of(K1=L * (evals + 1), K1_own=L * (evals + 1),
                         K2=L * (steps + evals + 1))
        finite = bool(np.isfinite(res.losses).all())
        shapes = (res.losses.shape == (steps, G, SWEEP_FOLDS)
                  and res.best_metrics.shape == (G, SWEEP_FOLDS, 11)
                  and res.best_probs.shape == (G, SWEEP_FOLDS, VAL_N))
        ok = counts == want and finite and shapes and busy > 0
        key = f"{group.hidden_size}x{group.num_heads}"
        line = {"phase": "sweep", "card": card, "group": key,
                "confs": list(group.confs), "cells": P, "steps": steps,
                "evals": evals + 1, "B": hyper.train_batch_size,
                "wall_ms": wall, "setup_ms": setup,
                "ms_per_step": wall / steps,
                "ms_per_step_after_setup": (wall - setup) / steps,
                "cell_steps_per_s": P * steps / (wall / 1e3),
                "cell_steps_per_s_after_setup": P * steps / ((wall - setup) / 1e3),
                "short_run_steps": short.num_steps,
                "short_run_wall_ms": short_ms,
                "short_run_device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / short_ms,
                "device_idle_share_after_setup":
                    1.0 - busy / (short_ms - setup),
                "kernels_per_step_short_run": kernels / short.num_steps,
                "launches": counts, "expected_launches": want,
                "launches_per_step": {k: n / steps for k, n in counts.items()},
                "k1_model_axis_launches": counts["K1"],
                "k1_models_per_launch": P,
                "first_loss": float(res.losses[0].mean()),
                "last_loss": float(res.losses[-1].mean()),
                "median_best_auroc": float(np.median(res.best_metrics[..., 3])),
                "finite_losses": finite, "shapes_ok": shapes,
                "by_group_ms": groups, "ok": ok}
        emit(line)
        check(ok, f"sweep {key}: launched {counts} of {want}, finite {finite}, "
                  f"shapes {shapes}, busy {busy}")
        result["groups"][key] = {k: line[k] for k in (
            "cells", "ms_per_step", "ms_per_step_after_setup",
            "cell_steps_per_s", "cell_steps_per_s_after_setup",
            "device_idle_share", "device_idle_share_after_setup",
            "kernels_per_step_short_run",
            "k1_model_axis_launches")}
        for k, n in counts.items():
            result["launches"][k] += n
    phase_sweep_parity(pool, folds, data, hyper)
    return result


def phase_sweep_parity(pool, folds, data, hyper) -> None:
    """With dropout 0, the (16, 16) group's grouped run against
    `train_baseline` run alone on two of its cells (its first conf on the
    first fold, its last on the last)."""
    group = next(g for g in stack.group_configs(BASELINE_CONFS)
                 if g.hidden_size == 16)
    group = dataclasses.replace(group, dropout_rate=0.0)
    res = engine.run_group(group, data, hyper)
    members = stack.unpad_group_params(res.best_params, group)

    def split(ps):
        vols = pool[ps.row_idx] - np.float32(ps.mean)
        return SplitArrays(vols, ps.labels.astype(np.int32),
                           [""] * len(vols), [""] * len(vols))

    for g, f in ((0, 0), (len(group.confs) - 1, SWEEP_FOLDS - 1)):
        train, val = folds[f]
        alone = train_baseline(group.member_config(g), split(train),
                               split(val), **SWEEP_HYPER)
        loss_err = float(np.abs(res.losses[:, g, f] - np.asarray(alone.losses)).max())
        param_err = max(float((members[g][k][f] - v).abs().max())
                        for k, v in alone.best_params.items())
        metric_err = max(abs(float(res.best_metrics[g, f, i]) - alone.metrics[k])
                         for i, k in enumerate(engine.METRIC_KEYS))
        ok = loss_err <= SWEEP_LOSS_ATOL and param_err <= SWEEP_PARAM_ATOL
        emit({"phase": "sweep_parity", "card": card, "conf": group.confs[g],
              "fold": f, "against": "train_baseline", "dropout": False,
              "max_loss_err": loss_err, "loss_atol": SWEEP_LOSS_ATOL,
              "max_param_err": param_err, "param_atol": SWEEP_PARAM_ATOL,
              "max_metric_err": metric_err, "ok": ok})
        check(ok, f"sweep parity conf {group.confs[g]} fold {f}: loss err "
                  f"{loss_err}, param err {param_err}")



# --- the `cli` phase: the baseline drivers from CSVs and PNGs on disk -------
# A synthetic dataset at the real one's scale (SURVEY.md:321,439): 99
# patients (one of them ProstateX-0179, whose slices are not reversed) of
# 18-25 slices, 128 x 128 uint8 PNGs in the four folders, 112 lesion rows
# (about a third HG), the CV manifests (72 / 18 x 5, a 22-row test.csv)
# and the fixed split (81 / 9 / 22).  The script imports no PIL, as the
# port does not, so the PNGs are written here with zlib, each row filtered
# by one of the five PNG filter types in turn.
CLI_PATIENTS, CLI_ROWS, CLI_TEST, CLI_FOLDS, CLI_FIXED_VAL = 99, 112, 22, 5, 9
CLI_SLICES = (18, 25)
CLI_STEPS, CLI_EVAL_EVERY = 24, 12
# Rotated pool rows, card against the CPU: at most this share of a row's
# pixels may differ (a source coordinate at an exact .5 can round the other
# way when cos, sin or an FMA differ by an ulp), the bound of
# `tests/test_torch_data.py`.
CLI_ROTATION_MAX_SHARE = 1e-3
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, img: np.ndarray, filters=None, interlace: int = 0) -> None:
    """An (H, W) uint8 image as an 8-bit grayscale PNG, row y filtered by
    `filters[y]` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth; by default the
    five in turn)."""
    H, W = img.shape
    filters = np.arange(H) % 5 if filters is None else np.asarray(filters)
    x = np.zeros((H + 1, W + 1), np.int16)      # a zero row above, column left
    x[1:, 1:] = img
    rows = np.empty((H, W + 1), np.uint8)
    rows[:, 0] = filters
    for f in range(5):
        y = np.flatnonzero(filters == f) + 1
        cur, left, up, up_left = x[y, 1:], x[y, :-1], x[y - 1, 1:], x[y - 1, :-1]
        if f == 4:
            p = left + up - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, up_left))
        else:
            pred = (0, left, up, (left + up) // 2)[f]
        rows[y - 1, 1:] = (cur - pred) & 0xFF
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0,
                                                 interlace))
                + png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + png_chunk(b"IEND", b""))


def rotate_nearest(stack: np.ndarray, angle_deg: float) -> np.ndarray:
    """Every slice of an (n, H, W) stack rotated about its centre, nearest
    neighbour, 0 outside: the dataset's 'rotation' folder."""
    _, H, W = stack.shape
    t = math.radians(angle_deg)
    yy, xx = np.mgrid[:H, :W].astype(np.float64)
    yy, xx = yy - (H - 1) / 2, xx - (W - 1) / 2
    sy = np.rint(math.cos(t) * yy - math.sin(t) * xx + (H - 1) / 2).astype(int)
    sx = np.rint(math.sin(t) * yy + math.cos(t) * xx + (W - 1) / 2).astype(int)
    ok = (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
    return np.where(ok, stack[:, sy.clip(0, H - 1), sx.clip(0, W - 1)], 0).astype(np.uint8)


def write_manifest(path, rows) -> None:
    with open(path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(("Patient", "Label", "Zone", "GG", "z0", "Lesion"))
        out.writerows(rows)


def synth_dataset(root, img: int = 128, patients: int = CLI_PATIENTS,
                  rows: int = CLI_ROWS, test: int = CLI_TEST,
                  folds: int = CLI_FOLDS, fixed_val: int = CLI_FIXED_VAL,
                  seed: int = SEED) -> dict:
    """Write the dataset under `root` in the reference layout
    (`dataset/<patient>/<folder>/1-%02d.png`, `csv_files/cross_validation/`,
    `csv_files/fixed_split/`); return its paths and sizes.  Lesion rows are
    stratified over the folds, so every validation fold holds both classes;
    a seventh of them sit at z0 = 1 and another at the last slice, where the
    window runs off either end of the stack."""
    root = pathlib.Path(root)
    rng = np.random.default_rng(seed)
    ids = [i for i in range(204) if i != 179]
    names = [f"ProstateX-{i:04d}" for i in sorted(
        [179, *rng.choice(ids, patients - 1, replace=False)])]
    unreversed = "ProstateX-0179"
    n_slices = {}
    grid = np.add.outer(np.arange(img), np.arange(img)) * (96.0 / img)
    for p, name in enumerate(names):
        n = int(rng.integers(CLI_SLICES[0], CLI_SLICES[1] + 1))
        n_slices[name] = n
        base = (grid[None] + 40 * np.sin(np.arange(n)[:, None, None] + p)
                + rng.integers(0, 90, size=(n, img, img)))
        base = np.clip(base, 0, 255).astype(np.uint8)
        folders = {"original": base, "vertical_flip": base[:, ::-1],
                   "horizontal_flip": base[:, :, ::-1],
                   "rotation": rotate_nearest(base, float(rng.uniform(-30, 30)))}
        for folder, stack_ in folders.items():
            d = root / "dataset" / name / folder
            d.mkdir(parents=True)
            for j in range(n):
                write_png(d / f"1-{j + 1:02d}.png", np.ascontiguousarray(stack_[j]))
    # every patient has a lesion; ProstateX-0179 three, at both ends
    owners = (names + [str(n) for n in rng.choice(names, rows - patients - 2)]
              + [unreversed] * 2)
    lesions = collections.Counter()
    table = []
    hg = set(rng.choice(rows, rows // 3, replace=False).tolist())
    for r, name in enumerate(owners):
        n = n_slices[name]
        lesions[name] += 1
        end = name == unreversed and lesions[name] > 1
        z0 = (1 if r % 7 == 0 or (end and lesions[name] == 2)
              else n if r % 7 == 1 or end
              else int(rng.integers(1, n + 1)))
        gg = int(rng.integers(2, 6)) if r in hg else 1
        table.append((name, "HG" if gg > 1 else "LG",
                      ("PZ", "TZ", "AS")[int(rng.integers(3))], gg, z0,
                      lesions[name]))
    # stratified: each class shuffled, then dealt to test, folds, in turns
    order = [i for cls in ("HG", "LG")
             for i in rng.permutation([i for i, t in enumerate(table) if t[1] == cls])]
    test_rows = order[::len(order) // test][:test]
    rest = [i for i in order if i not in set(test_rows)]
    cv_dir = root / "csv_files" / "cross_validation"
    fixed_dir = root / "csv_files" / "fixed_split"
    cv_dir.mkdir(parents=True)
    fixed_dir.mkdir(parents=True)
    val_of = [rest[k::folds] for k in range(folds)]
    for k in range(folds):
        val = set(val_of[k])
        write_manifest(cv_dir / f"training_cv{k + 1}.csv",
                       [table[i] for i in rest if i not in val])
        write_manifest(cv_dir / f"validation_cv{k + 1}.csv",
                       [table[i] for i in sorted(val)])
    fixed_val_rows = set(rest[::len(rest) // fixed_val][:fixed_val])
    write_manifest(fixed_dir / "training.csv",
                   [table[i] for i in rest if i not in fixed_val_rows])
    write_manifest(fixed_dir / "validation.csv",
                   [table[i] for i in sorted(fixed_val_rows)])
    for d in (cv_dir, fixed_dir):
        write_manifest(d / "test.csv", [table[i] for i in sorted(test_rows)])
    return {"data_root": str(root / "dataset"), "cv_csv": str(cv_dir),
            "fixed_csv": str(fixed_dir), "patients": len(names),
            "slices": sum(n_slices.values()), "rows": len(table),
            "hg_rows": len(hg), "pngs": 4 * sum(n_slices.values())}


def pool_rotation_check(ds: dict) -> dict:
    """The 'device' augmentation's pool built on the card and on the CPU:
    every row equal but the rotated ones, each of those within
    CLI_ROTATION_MAX_SHARE differing pixels."""
    pools = {dev: data_pool.build_pooled_cv(ds["cv_csv"], ds["data_root"], CLI_FOLDS,
                                       aug_mode="device", device=dev)
             for dev in ("cuda", "cpu")}
    (gpu, gpu_folds), (cpu, cpu_folds) = pools["cuda"], pools["cpu"]
    rot = sorted(r for k, r in gpu.key_to_row.items() if k[3] == "device_rotation")
    other = np.setdiff1d(np.arange(len(gpu)), rot)
    same_rest = bool(np.array_equal(gpu.volumes[other], cpu.volumes[other]))
    shares = [float((gpu.volumes[r] != cpu.volumes[r]).mean()) for r in rot]
    means = [abs(a.mean - b.mean) for (a, _), (b, _) in zip(gpu_folds, cpu_folds)]
    ok = (gpu.key_to_row == cpu.key_to_row and same_rest and len(rot) > 0
          and max(shares) <= CLI_ROTATION_MAX_SHARE)
    line = {"phase": "cli_rotation", "card": card, "rows": len(gpu),
            "rotation_rows": len(rot), "other_rows_equal": same_rest,
            "max_differing_share": max(shares, default=0.0),
            "rows_with_differences": sum(s > 0 for s in shares),
            "bound_share": CLI_ROTATION_MAX_SHARE,
            "max_fold_mean_diff": max(means), "ok": ok}
    emit(line)
    check(ok, f"cli: device rotation rows on the card against the CPU: {line}")
    return line


def checkpoint_layout(out: pathlib.Path, kind: str, confs, tags_of) -> dict:
    """Every (conf, tag) checkpoint at `out/<kind>_models/conf<c>/<tag>.bin`
    with exactly the member's state_dict names and shapes."""
    missing, wrong = [], []
    for conf in confs:
        want = {k: tuple(v.shape) for k, v in VisionTransformer3D(
            ViTConfig.from_conf(conf), device="cpu").state_dict().items()}
        for tag in tags_of(conf):
            path = out / f"{kind}_models" / f"conf{conf}" / f"{tag}.bin"
            if not path.exists():
                missing.append(str(path.relative_to(out)))
                continue
            got = {k: tuple(v.shape) for k, v in torch.load(
                path, map_location="cpu", weights_only=True).items()}
            if got != want:
                wrong.append(str(path.relative_to(out)))
    return {"files": sum(len(tags_of(c)) for c in confs), "missing": missing,
            "wrong_shapes": wrong}


@contextlib.contextmanager
def kernel_calls(into: dict):
    """Record in `into` every call the models make to K1's wrapper (one
    model, `models/vit3d.py`; the model axis, `sweep/stacked.py`) and to the
    attention wrapper (`ops/attention.py`) inside the block: K1's as
    (dtype, N, D, M, models) with its widths, the attention's as (dtype,
    (B, H, S, hd)) and whether q, k, v are views into one (B, S, 3, H, hd)
    QKV product, as `k2_views` makes them.  The calls go through unchanged."""
    sites = ((vit3d_module, "fused_mlp"), (stacked_module, "fused_mlp"),
             (attention, "fused_attention"))
    before = [getattr(module, name) for module, name in sites]

    def mlp(x, w1, b1, w2, b2, mlp_active=None):
        M, D = w1.shape[-2:]
        models = w1.shape[0] if w1.dim() == 3 else 0
        active = M if mlp_active is None else mlp_active
        into.setdefault("K1", []).append(
            (x.dtype, x.numel() // (D * max(models, 1)), D, M, models,
             active.detach().clone() if torch.is_tensor(active) else active))
        return fused_mlp.fused_mlp(x, w1, b1, w2, b2, mlp_active)

    def attend(q, k, v):
        nb, H, S, hd = q.shape
        step = H * hd * q.element_size()
        qkv = (q.stride() == (S * 3 * H * hd, hd, 3 * H * hd, 1)
               and k.stride() == v.stride() == q.stride()
               and k.data_ptr() - q.data_ptr() == step
               and v.data_ptr() - k.data_ptr() == step)
        into.setdefault("K2", []).append((q.dtype, (nb, H, S, hd), qkv))
        return fused_attention.fused_attention(q, k, v)

    for (module, name), wrapper in zip(sites, (mlp, mlp, attend)):
        setattr(module, name, wrapper)
    try:
        yield into
    finally:
        for (module, name), fn in zip(sites, before):
            setattr(module, name, fn)


def cli_kernel_cases(calls: dict) -> dict:
    """K1 and K2 against their plain versions at every shape the `cli` runs
    gave them (`kernel_calls`), each shape once, on inputs from a generator
    of their own: K1's model axis with the widths of that call."""
    own = torch.Generator(device="cuda").manual_seed(SEED + 5)
    k1_shapes = {}
    for dtype, N, D, M, models, active in calls.get("K1", []):
        widths = torch.as_tensor(active).reshape(-1).tolist()
        widths = tuple(widths * models if len(widths) == 1 else widths) if models \
            else int(widths[0])
        k1_shapes.setdefault((dtype, N, D, M, models, widths), None)
    k2_shapes = sorted({(dtype, shape) for dtype, shape, _ in calls.get("K2", [])},
                       key=lambda s: (str(s[0]), s[1]))
    layouts = {qkv for _, _, qkv in calls.get("K2", [])}
    check(layouts == {True}, "cli: the attention was called on q, k, v that are "
                             "not views into one QKV product, as no K2 case makes them")
    k1_cases = [k1_case(own, dtype, N, D, M, list(w) if models else w, "cli",
                        models=models)
                for dtype, N, D, M, models, w in sorted(
                    k1_shapes, key=lambda s: (str(s[0]), s[1:5]))]
    k2_cases = [k2_case(own, dtype, shape, "cli", device=False)
                for dtype, shape in k2_shapes if shape[-1] <= 16]
    return {"K1": k1_cases, "K2": k2_cases}


def cli_idle(fn) -> dict:
    """The device idle share of one call of `fn`: its busy time and its
    wall time from one trace.  A trace can lack device events (see
    `device_time`), so the call is traced again, up to PROFILE_TRIES times,
    until the trace holds every K1 and K2 launch their counters saw in it."""
    for tries in range(1, PROFILE_TRIES + 1):
        before = launches()
        busy, groups, kernels, counts, wall_ms = traced(fn)
        after = launches()
        complete = all(counts.get(k, 0) >= after[k] - before[k] for k in ("K1", "K2"))
        if complete and kernels:
            break
    return {"short_run_wall_ms_traced": wall_ms, "short_run_device_busy_ms": busy,
            "short_run_kernels": kernels, "short_run_traces": tries,
            "short_run_trace_complete": complete,
            "device_idle_share": 1.0 - busy / wall_ms, "by_group_ms": groups}


def phase_cli() -> dict:
    """The baseline drivers, through `main(argv)`, from CSVs and PNGs that
    this phase writes: `train_baseline_cv` (conf 9, 5 folds; --all_configs,
    the 18 x 5 sweep in three groups of 30 cells; the same with --resume,
    which must return the same dict and launch nothing; --all_configs with
    --aug_mode device) and `train_baseline_whole_dataset` (conf 9;
    --all_configs), 24 steps each, dropout on, on the card.  Each run's
    seconds, ms a step and K1/K2 launches (counted, and each launch's shape
    recorded by `kernel_calls`), its device idle share (busy time over
    wall time of one traced short run of the same driver: 12 steps, one
    fold where the folds run in turn; `cli_idle`), its results (finite,
    for every conf and fold) and its checkpoints (the reference layout,
    the members' shapes).  Then K1 and K2 against their plain versions at
    every shape the runs gave them (`cli_kernel_cases`)."""
    # the drivers log at INFO through `setup_logging`; keep stderr short
    logging.basicConfig(level=logging.WARNING)
    work = pathlib.Path(__file__).resolve().parent / "build" / "cli_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        return _phase_cli(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase_cli(work: pathlib.Path) -> dict:
    t0 = time.perf_counter()
    ds = synth_dataset(work / "data")
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold_pool, cold_folds = data_pool.build_pooled_cv(ds["cv_csv"], ds["data_root"],
                                                 CLI_FOLDS, device="cuda")
    pool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data_pool.build_pooled_cv(ds["cv_csv"], ds["data_root"], CLI_FOLDS, device="cuda")
    warm_s = time.perf_counter() - t0
    emit({"phase": "cli_data", "card": card, **ds, "write_seconds": written,
          "decoder": native_loader.decoder(), "decoder_status": native_loader.status(),
          "pool_build_seconds_cold": pool_s, "pool_build_seconds_warm": warm_s,
          "pool_unique_volumes": len(cold_pool),
          "pool_bytes": int(cold_pool.volumes.nbytes),
          "fold_train_rows": [len(t.row_idx) for t, _ in cold_folds],
          "fold_val_rows": [len(v.row_idx) for _, v in cold_folds]})
    check(ds["rows"] == CLI_ROWS and len(cold_folds) == CLI_FOLDS
          and all(len(v.row_idx) == 18 for _, v in cold_folds),
          f"cli: the synthetic dataset's manifests: {ds}")
    pool_rotation_check(ds)

    cv = ["--csv_path", ds["cv_csv"], "--data_root", ds["data_root"],
          "--num_steps", str(CLI_STEPS), "--eval_every", str(CLI_EVAL_EVERY),
          "--num_cv", str(CLI_FOLDS)]
    whole = ["--csv_path", ds["fixed_csv"], "--data_root", ds["data_root"],
             "--num_steps", str(CLI_STEPS)]
    L = ViTConfig.from_conf(9).num_layers            # every group's depth too
    groups = len(stack.group_configs(BASELINE_CONFS))
    cv_evals = CLI_STEPS // CLI_EVAL_EVERY + 1       # + the closing evaluation
    whole_evals = CLI_STEPS // 31 + 1                # --eval_every 31 (default)
    # dropout on: K1 serves the evaluations, K2 every forward
    runs = [  # name, driver, argv, steps, expected K1, K2
        ("cv_single", train_baseline_cv, ["--config", "9", *cv],
         CLI_FOLDS * CLI_STEPS, CLI_FOLDS * L * cv_evals,
         CLI_FOLDS * L * (CLI_STEPS + cv_evals)),
        ("cv_all", train_baseline_cv, ["--all_configs", *cv], groups * CLI_STEPS,
         groups * L * cv_evals, groups * L * (CLI_STEPS + cv_evals)),
        ("cv_all_resume", train_baseline_cv, ["--all_configs", "--resume", *cv],
         0, 0, 0),
        ("cv_all_device_aug", train_baseline_cv,
         ["--all_configs", "--aug_mode", "device", *cv], groups * CLI_STEPS,
         groups * L * cv_evals, groups * L * (CLI_STEPS + cv_evals)),
        ("whole_single", train_baseline_whole_dataset, ["--config", "9", *whole],
         CLI_STEPS, L * whole_evals, L * (CLI_STEPS + whole_evals)),
        ("whole_all", train_baseline_whole_dataset, ["--all_configs", *whole],
         groups * CLI_STEPS, groups * L * whole_evals,
         groups * L * (CLI_STEPS + whole_evals)),
    ]
    results, totals, summary, calls = {}, counts_of(), {}, {}
    for name, driver, argv, steps, k1, k2 in runs:
        out = work / ("cv_all" if name == "cv_all_resume" else name)
        run = lambda o=out: driver.main([*argv, "--output_dir", str(o)])  # noqa: E731
        reset_launches()
        got, seen = [], {}
        with kernel_calls(seen):
            seconds = wall_time_ms(lambda: got.append(run())) / 1e3
        counts = launches()
        for kernel, recorded in seen.items():
            calls.setdefault(kernel, []).extend(recorded)
        res = results[name] = got[0]
        want = counts_of(K1=k1, K1_own=k1, K2=k2)
        line = {"phase": "cli", "card": card, "run": name,
                "driver": driver.__name__.rsplit(".", 1)[1], "argv": argv,
                "seconds": seconds, "steps": steps,
                "ms_per_step": seconds * 1e3 / steps if steps else None,
                "launches": counts, "expected_launches": want,
                "k1_launches": counts["K1"], "k2_launches": counts["K2"],
                # every launch went through a call `kernel_calls` recorded
                "recorded_calls": {k: len(seen.get(k, [])) for k in ("K1", "K2")}}
        ok = counts == want and all(len(seen.get(k, [])) == counts[k]
                                    for k in ("K1", "K2"))
        if name == "cv_all_resume":
            ok = ok and res == results["cv_all"]
            line["same_results_as_cv_all"] = res == results["cv_all"]
        elif name == "cv_all_device_aug":
            # the same engine on the same shapes as cv_all: its busy share
            # is cv_all's (the pool's rotation rows are one batched call)
            line["device_idle_share"] = None
        else:
            # the busy share on a short run of the same driver (its first
            # evaluation period, one fold where the folds run in turn), in
            # a fresh directory: the profiler's cost grows with the events
            # it records.  Its wall time is the traced run's
            short_argv = [*argv, "--num_steps", str(CLI_EVAL_EVERY),
                          *(["--num_cv", "1"] if name == "cv_single" else [])]
            idle = cli_idle(lambda: driver.main(
                [*short_argv, "--output_dir", str(work / "short")]))
            shutil.rmtree(work / "short", ignore_errors=True)
            line.update(short_run_argv=short_argv[len(argv):], **idle)
            ok = ok and idle["short_run_device_busy_ms"] > 0
        # results: {'CV f': metrics} (cv_single), {conf: {'CV f': metrics}}
        # (cv_all*), {conf: metrics} (whole_*)
        folds = [f"CV {f + 1}" for f in range(CLI_FOLDS)]
        confs = [9] if "single" in name else list(BASELINE_CONFS)
        if name == "cv_single":
            cells = [res[f] for f in folds]
        elif name.startswith("cv"):
            cells = [res[c][f] for c in confs for f in folds]
        else:
            cells = [res[c] for c in confs]
        finite = (len(cells) == len(confs) * (CLI_FOLDS if name.startswith("cv") else 1)
                  and all(math.isfinite(v) for m in cells for v in m.values()))
        line.update(cells=len(cells), finite_metrics=finite,
                    median_auroc=float(np.median([m["AUROC"] for m in cells])))
        ok = ok and finite
        if name != "cv_all_resume":
            kind = "cv_baseline" if name.startswith("cv") else "baseline"
            tags = ((lambda c: [f"cv{f + 1}" for f in range(CLI_FOLDS)])
                    if kind == "cv_baseline" else (lambda c: [f"conf{c}"]))
            layout = checkpoint_layout(out, kind, confs, tags)
            line["checkpoints"] = layout
            ok = ok and not layout["missing"] and not layout["wrong_shapes"]
        line["ok"] = ok
        emit(line)
        check(ok, f"cli {name}: {line}")
        summary[name] = {k: line.get(k) for k in (
            "seconds", "ms_per_step", "device_idle_share", "k1_launches",
            "k2_launches")}
        for k, n in counts.items():
            totals[k] += n
    # the kernels at the shapes these runs gave them (launches not counted)
    cases = cli_kernel_cases(calls)
    return {"launches": totals, "runs": summary, "cases": cases}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    global card, exp_rate, fp32_rate
    card = smi("name,power.limit")
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_rate = EX2_PER_SM_CLOCK * sms * sm_clock_mhz * 1e6
    fp32_rate = FP32_PER_SM_CLOCK * sms * sm_clock_mhz * 1e6
    emit({"phase": "device", "nvidia_smi": card, "sms": sms,
          "sm_clock_max_mhz": sm_clock_mhz, "exponentials_per_s": exp_rate,
          "fp32_instructions_per_s": fp32_rate,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1, k1_wide, k1_latency, k1_wide_f32 = phase_k1(gen)
    k1_scaled = phase_f32_scaled("seq", STRETCH_ROWS[1], 768, SEED + 3)
    # the phases of the fused-FFN variants and the model axis draw from a
    # generator of their own, so the phases that follow draw what they drew
    own = torch.Generator(device="cuda").manual_seed(SEED + 1)
    k1_models = phase_model_axis(own)
    k1_variants = phase_mlp_variants(own)
    k1b_scaled = phase_f32_scaled("chunked", MODEL_AXIS_ROWS, 64, SEED + 4)
    k2 = phase_k2(gen)
    k3, k3_stretch, k3_serve = phase_k3(gen)
    k4 = phase_k4(gen)
    phase_gradients(gen)
    phase_f32_model(gen)
    main_path = phase_main_path(gen)
    auto_busy = phase_profile(main_path, gen)
    layer_pass = phase_layer_pass(main_path, auto_busy)
    variants = phase_variants(main_path)
    phase_latency(gen)
    stretch = phase_stretch(gen)
    train = phase_train()
    train_ens = phase_train_ensemble()
    sweep = phase_sweep()
    cli = phase_cli()
    by_path = {name: {"serve": main_path["launches"][name],
                      "serve_layer": layer_pass["launches"][name],
                      "variants_chunked": variants["chunked"]["launches"][name],
                      "variants_pipelined2":
                          variants["pipelined2"]["launches"][name],
                      "train_layer": train["launches"][name],
                      "train_ensemble_layer": train_ens["launches"][name],
                      "stretch": stretch["auto"]["launches"][name],
                      "stretch_layer": stretch["layer"]["launches"][name],
                      "stretch_f32": stretch["f32_auto"]["launches"][name],
                      "stretch_f32_layer":
                          stretch["f32_layer"]["launches"][name],
                      "sweep": sweep["launches"][name],
                      "cli": cli["launches"][name]}
               for name in KERNELS}
    shape_keys = ("dtype", "N", "D", "M", "active", "models", "B", "H", "S",
                  "T", "hd", "path", "offset_elements")
    number_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms", "device_ms", "library_device_ms",
                   "library_contiguous_device_ms", "call_device_ms")
    # K4, K1's wide case, K1c's and K3's timed cases also carry their device
    # time under the profiler (see phase_k4)
    for path in by_path["K1"]:
        on_bodies = by_path["K1_on_K1c"][path] + by_path["K1_own"][path]
        check(on_bodies == by_path["K1"][path],
              f"K1 on {path}: {by_path['K1'][path]} launches, {on_bodies} "
              "on K1c's pipeline and its own bodies")
    for path in by_path["K3"]:
        on_bodies = by_path["K3_on_K2"][path] + by_path["K3_on_K4"][path]
        check(on_bodies == by_path["K3"][path],
              f"K3 on {path}: {by_path['K3'][path]} launches, {on_bodies} "
              "on K2's and K4's bodies")

    def row(name, source, replaces, case, path, **more):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": by_path[name][path],
                "path": path, "launches_by_path": by_path[name],
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"], "library_ms": case["library_ms"],
                "shape": {k: case[k] for k in case if k in shape_keys},
                **more}

    def case_of(case, path=None):
        """A case's shape and numbers, with its path's launches."""
        out = {k: case[k] for k in case if k in shape_keys + number_keys}
        return {**out, "launches": by_path[VARIANT_KERNELS["seq"]][path]} if path else out

    def k1b_f32_case(case):
        """A K1b f32 case with its error over the gate and its other bounds."""
        return {**case_of(case), "max_err_over_gate": case["max_err_over_gate"],
                "bound_ms_cuda_cores": case["bound_ms_cuda_cores"],
                "bound_ms_mma_sync": case["bound_ms_mma_sync"]}

    emit({"kernels": [
        # K1's serving calls run on K1c's wgmma pipeline (bf16, D 16-64),
        # f32 and the wide regime on its own bodies
        row("K1", "vit3d_ensemble_tpu_torch/csrc/mlp_pipelined.cu",
            "vit3d_ensemble_tpu/ops/pallas_mlp.py:87", k1, "serve",
            sources={"bf16, D 16-64":
                     "vit3d_ensemble_tpu_torch/csrc/mlp_pipelined.cu",
                     "otherwise": "vit3d_ensemble_tpu_torch/csrc/fused_mlp.cu"},
            body=k1["body"], device_ms=k1["device_ms"],
            library_device_ms=k1["library_device_ms"],
            launches_on_k1c_body=by_path["K1_on_K1c"]["serve"],
            # the latency path's calls (B = 1, 4, 8 at conf 9's widths)
            latency_cases=[case_of(c) for c in k1_latency],
            # the same kernel's wide body at the stretch path's shape, and
            # its model axis at the sweep's evaluation shape (f32)
            stretch_case=case_of(k1_wide),
            # its wide f32 body (3xTF32 on wgmma) at the stretch path's B=8
            # and B=1 shapes, with its launches on the f32 stretch pass, and
            # with x four times larger against the f64 MLP
            stretch_f32_cases=[{**case_of(c, "stretch_f32"), "body": c["body"],
                                "max_err_over_gate": c["max_err_over_gate"],
                                "bound_ms_cuda_cores": c["bound_ms_cuda_cores"],
                                "bound_ms_mma_sync": c["bound_ms_mma_sync"]}
                               for c in k1_wide_f32],
            f32_scaled_max_err_over_gate=k1_scaled["max_err_over_gate"],
            model_axis_case=case_of(k1_models, "sweep"),
            # f32 at every shape the baseline drivers gave it
            cli_cases=[case_of(c) for c in cli["cases"]["K1"]]),
        row("K1b", "vit3d_ensemble_tpu_torch/csrc/mlp_chunked.cu",
            "vit3d_ensemble_tpu/ops/pallas_mlp.py:126", k1_variants["chunked"],
            "variants_chunked",
            # its f32 body (3xTF32 on mma.sync) at the model axis and at the
            # serving shape, with the three bounds, and with x four times
            # larger against the f64 MLP
            model_axis_case=k1b_f32_case(k1_variants["chunked_model_axis"]),
            f32_case=k1b_f32_case(k1_variants["chunked_f32"]),
            f32_scaled_max_err_over_gate=k1b_scaled["max_err_over_gate"]),
        row("K1c", "vit3d_ensemble_tpu_torch/csrc/mlp_pipelined.cu",
            "vit3d_ensemble_tpu/ops/pallas_mlp.py:142", k1_variants["pipelined2"],
            "variants_pipelined2",
            device_ms=k1_variants["pipelined2"]["device_ms"],
            library_device_ms=k1_variants["pipelined2"]["library_device_ms"],
            plan=k1c_plan(*K1C_PLAN_CASES[0]),
            model_axis_case={**case_of(k1_variants["pipelined2_model_axis"]),
                             "plan": k1c_plan(*K1C_PLAN_CASES[1])}),
        row("K2", "vit3d_ensemble_tpu_torch/csrc/tiny_attention.cu",
            "vit3d_ensemble_tpu/ops/pallas_attention.py:46", k2[16], "serve",
            device_ms=k2[16]["device_ms"],
            library_device_ms=k2[16]["library_device_ms"],
            # the serving pass's other head dims (CUDA-core body), conf
            # 19-22's T=257, and the training path's f32 shapes
            other_cases=[case_of(c) for c in
                         [k2[4], k2[1], k2["unaligned"], *k2["t257"],
                          *k2["train"]]],
            # f32 at every shape the baseline drivers gave it
            cli_cases=[case_of(c) for c in cli["cases"]["K2"]]),
        # K3's core runs on K2's body at head_dim <= 16 (the training
        # path's conf 9: head_dim 1) and on K4's at 32-128
        row("K3", "vit3d_ensemble_tpu_torch/csrc/tiny_attention.cu",
            "vit3d_ensemble_tpu/ops/pallas_attention_layer.py:69", k3,
            "train_layer",
            sources={"head_dim <= 16": "vit3d_ensemble_tpu_torch/csrc/tiny_attention.cu",
                     "head_dim >= 32": "vit3d_ensemble_tpu_torch/csrc/attention.cu"},
            body=k3["body"],
            launches_on_k2_body=by_path["K3_on_K2"]["train_layer"],
            # bf16 at the serving pass's three classes and conf 19-22's
            # (16, 4) class, f32 at the training shape, each with its device
            # time beside SDPA's
            serve_cases=[{**case_of(c), "body": c["body"]} for c in k3_serve],
            # head_dim 64 at T=513 on K4's body, as the stretch path under
            # `layer` runs it
            stretch_case={**case_of(k3_stretch[torch.bfloat16]),
                          "body": k3_stretch[torch.bfloat16]["body"],
                          "launches": by_path["K3"]["stretch_layer"],
                          "launches_on_k4_body":
                              by_path["K3_on_K4"]["stretch_layer"]},
            # the same in f32 at B=1, on K4's 3xTF32 body
            stretch_f32_case={**case_of(k3_stretch[torch.float32]),
                              "body": k3_stretch[torch.float32]["body"],
                              "bound_ms_cuda_cores":
                                  k3_stretch[torch.float32]["bound_ms_cuda_cores"],
                              "bound_ms_mma_sync":
                                  k3_stretch[torch.float32]["bound_ms_mma_sync"],
                              "launches": by_path["K3"]["stretch_f32_layer"],
                              "launches_on_k4_body":
                                  by_path["K3_on_K4"]["stretch_f32_layer"]}),
        row("K4", "vit3d_ensemble_tpu_torch/csrc/attention.cu",
            "vit3d_ensemble_tpu/ops/pallas_attention.py:118",
            k4[torch.bfloat16], "stretch",
            device_ms=k4[torch.bfloat16]["device_ms"],
            library_device_ms=k4[torch.bfloat16]["library_device_ms"],
            # f32 (the B=1 stretch forward's, 3xTF32 on the tensor cores)
            # at the stretch shape, with its launches on the f32 paths
            f32_case={**case_of(k4[torch.float32]),
                      "body": k4[torch.float32]["body"],
                      "bound_ms_cuda_cores": k4[torch.float32]["bound_ms_cuda_cores"],
                      "bound_ms_mma_sync": k4[torch.float32]["bound_ms_mma_sync"],
                      "launches": by_path["K4"]["stretch_f32"],
                      "launches_k3_on_k4_body_layer":
                          by_path["K3_on_K4"]["stretch_f32_layer"]}),
    ], "variants_volumes_per_s": {v: r["volumes_per_s"]
                                  for v, r in variants.items()},
        "training": {"train": train["timing"],
                     "train_ensemble": train_ens["timing"]},
        "sweep": sweep["groups"],
        "cli": cli["runs"],
        "stretch": {impl: {k: v for k, v in res.items() if k != "launches"}
                    for impl, res in stretch.items()},
        "seconds": time.perf_counter() - t_start})
    if failures:
        for what in failures:
            print(f"chip_smoke: FAILED {what}", file=sys.stderr)
        return 1
    # the last line, exactly this object
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

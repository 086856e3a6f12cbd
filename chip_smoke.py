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
    K1c's `wgmma` pipeline: counters `K1_on_K1c` and `K1_own`); and conf
    22 (D 8, 257 tokens) in bf16 at B=8 and B=512 (phase `conf22`: K1 on
    the pipeline's D = 8 instance, the hidden columns split across a
    cluster where the row tiles are few);
  * training, in f32: `train_baseline` on conf 9 at full width and depth
    under the attention impls `auto` (K2, K1 in evaluation) and `layer`
    (K3), and `train_ensemble` on {5,9,11} under `layer`; with dropout off,
    each kernel run is held to the same run on the plain modules;
  * the stretch model, `vit_b16_128cubed` (128^3 volumes, 513 tokens,
    D=768, 12 layers) at full width and depth: in f32 at B=1 against the
    plain modules, then served in bf16 at B=8 under `auto` (K4, K1's wide
    body) and under `layer` (K3's sublayer, whose head_dim-64 core runs on
    K4's body: counter `K3_on_K4`);
  * ViT-B/16 at full width and depth at 128 x 128 x 5, two ways: loaded
    from a Google-ViT npz that the script writes (`pretrained.py`, 65
    tokens; phase `pretrained`) and as the R50+ViT-B/16 hybrid (the
    ResNetV2 stem of `models/resnet_hybrid.py` on every slice, 321 tokens;
    phase `hybrid`, with one f32 forward and backward against the plain
    modules): f32 at B=1, then bf16 at B=8 under `auto` (K4, K1's wide
    body) and `layer` (K3 on K4's body), and the kernels at their shapes;
  * a model of ViT-H's widths at full width and depth (32 layers, D
    1,280, MLP 5,120, 16 heads of 80) on 128^3 volumes in (16, 16, 16)
    patches, 513 tokens (phase `vit_h`): f32 at B=1 against the plain
    modules, bf16 at B=8 under `auto` (K4 at head_dim 80, K1's wide body at
    D 1,280) and `layer` (K3 on K4's body), the kernels at its shapes, and a
    sweep of K1 over hidden sizes from 24 to 8,192 and of K4 and K3 over
    head dims from 20 to 256 against their plain versions (phase `widths`:
    K1b and K1c at those hidden sizes too, and K1 with a model axis);
  * five stacked members of the stretch model at full width (phase
    `wide_axis`): `sweep/stacked.stacked_forward`, as the sweep evaluates
    a config's folds in one forward, with per-member MLP widths and depths,
    in bf16 at B=8 and in f32 at B=1 against the plain modules, under each
    fused-FFN variant (K1, K1b and K1c at D 768 with the model axis), and
    the single stretch and ViT-H-width models under K1b and K1c;
  * the 18-model pass under `layer` too (K3's core at head_dim <= 16 on
    K2's body: counter `K3_on_K2`), by device time beside `auto`'s;
  * the sweep engine (`run_group`) on the three groups of conf 1-18, and
    on the widest with and without remat (phase `remat`: equal results,
    each run's peak bytes and ms a step; K2 twice a training block);
  * the int8 route (`ops/quant.py`): `int8_dense` against the CPU's at the
    models' shapes, conf 9 and 19 under `int8` and `int8_attn` against
    exact, and the stretch model in bf16 under `none`, `int8_attn` and
    `int8` (phase `quant`);
  * the baseline drivers (`cli/train_baseline_cv`,
    `cli/train_baseline_whole_dataset`), conf 9 and all 18 configs, from a
    synthetic 99-patient dataset of PNGs and CSVs that the script writes
    (K1 in evaluation, K2), then the ensemble drivers, and `cli/test_cv`
    on what they wrote (its baselines, every ensemble source,
    `--all_ensembles`, `--ood`, `--quant_impl`; phase `cli_test_cv`);
  * the mesh path (`parallel/mesh.py`, phase `mesh`): two ranks on the one
    card over gloo, spawned by the script, each on cuda:0, run
    `train_baseline_cv --all_configs --mesh 1x2`, the bootstrap grid under
    `--mesh 2x1` and `train_ensemble_cv --frozen --mesh 1x2` against the
    `cli` phase's one-process runs, and `make_dp_train_step` on conf 9
    against one process; each rank's launches are gathered to rank 0.

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
import functools
import itertools
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
from vit3d_ensemble_tpu_torch import pretrained
from vit3d_ensemble_tpu_torch.cli import (
    test_cv,
    train_baseline_bootstrap,
    train_baseline_cv,
    train_baseline_whole_dataset,
    train_ensemble_bootstrap,
    train_ensemble_cv,
    train_ensemble_whole_dataset,
)
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
    quant,
)
from vit3d_ensemble_tpu_torch.ops import mlp as mlp_select
from vit3d_ensemble_tpu_torch.sweep import e2e_grid, engine, stack
from vit3d_ensemble_tpu_torch.sweep import stacked as stacked_module
from vit3d_ensemble_tpu_torch.train.ensemble_trainer import train_ensemble
from vit3d_ensemble_tpu_torch.train.optim import sgd_momentum
from vit3d_ensemble_tpu_torch.train.steps import (
    masked_balanced_pos_weight,
    masked_bce_with_logits,
)
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
           # K1's launches in K1c's library (bf16: the `wgmma` pipeline, its
           # D = 8 instance at D <= 8) and in its own (f32 at D <= 64, the
           # wide bodies)
           "K1_on_K1c": (fused_mlp, "launches_on_k1c"),
           "K1_own": (fused_mlp, "launches_own"),
           "K2": (fused_attention, "launches"),
           "K3": (attention_layer, "launches"),
           # K3's core launches that took K2's body (head_dim <= 16) and
           # K4's (head_dim 17-256)
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
    return {"K1": n, "K1_on_K1c" if body in fused_mlp.K1_BODIES_ON_K1C else "K1_own": n}


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


@functools.lru_cache(maxsize=None)
def sass_of(path) -> str:
    """`cuobjdump -sass` of a library or cubin (the toolkit's cuobjdump,
    beside its nvcc), once a file: `build` reads each library's SASS for
    several counts."""
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
    import (neither the port nor this script imports them), and scipy and
    matplotlib (`metrics/stats.py` imports them in its functions), with their
    versions, and the libpng shared objects there: the one the dynamic
    loader finds and those Pillow bundles (no header comes with them)."""
    import ctypes.util
    import importlib.metadata
    import importlib.util
    out = {}
    for module, dist in (("PIL", "pillow"), ("pandas", "pandas"),
                         ("sklearn", "scikit-learn"), ("cv2", None),
                         ("scipy", "scipy"), ("matplotlib", "matplotlib")):
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
            for name in ("fused_mlp", "mlp_chunked", "mlp_pipelined", "attention")
            for op in ("HGMMA", "UTMALDG")}
    sass.update({f"tiny_attention_sass_{op.lower().replace('.', '_')}":
                 sass_count("tiny_attention", op) for op in ("HMMA", "MUFU.EX2")})
    tf32 = k4_f32_sass()
    sliced = k4_sliced_sass()
    sliced_notes = {kernel: ptxas_notes(logs["attention"], kernel)
                    for kernel in ("attention_sliced_f32_kernel", "attention_sliced_wgmma_kernel")}
    k1_tf32 = k1_f32_sass()
    k1b_tf32 = k1b_f32_sass()
    narrow_tf32 = {name: narrow_f32_sass(name) for name in ("fused_mlp", "mlp_pipelined")}
    wide = {name: wide_sass(name) for name in MLP_LIBRARIES}
    pipelines = {name: pipeline_sass(name, kernel) for name, kernel in PIPELINE_KERNELS.items()}
    pipelines_d8 = {name: pipeline_sass(name, kernel)
                    for name, kernel in PIPELINE_D8_KERNELS.items()}
    d8_notes = {name: ptxas_notes(logs[name], kernel)
                for name, kernel in PIPELINE_D8_KERNELS.items()}
    device = torch.device("cuda", torch.cuda.current_device())
    d8_clusters = {name: fused_mlp.k1_d8_clusters(device, name) for name in PIPELINE_D8_KERNELS}
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
          "attention_sliced_sass": sliced, "attention_sliced_ptxas_notes": sliced_notes,
          "k4_sliced_f32_plan": [k4_sliced_plan(*shape, torch.float32)
                                 for shape in K4_SLICED_F32_PLAN_SHAPES],
          "k4_sliced_bf16_plan": [k4_sliced_plan(*shape, torch.bfloat16)
                                  for shape in K4_SLICED_BF16_PLAN_SHAPES],
          "fused_mlp_f32_sass_hgmma_tf32": k1_tf32,
          "mlp_chunked_f32_sass_hmma_tf32": k1b_tf32,
          "narrow_f32_sass_hgmma_tf32": narrow_tf32,
          "wide_sass_hgmma": wide,
          "pipeline_sass": pipelines, "pipeline_d8_sass": pipelines_d8,
          "pipeline_d8_ptxas_notes": d8_notes, "k1_d8_clusters": d8_clusters,
          "k1_d8_plan": [k1_d8_plan(n, v) for v in VARIANT_KERNELS for n in D8_ROWS],
          "k1c_wide_plan": [k1c_wide_plan(*case) for case in K1C_WIDE_PLAN_CASES],
          "k1_narrow_f32_plan": [narrow_plan(*case) for case in K1_NARROW_F32_PLAN_CASES],
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
    check(len(tf32) == 2 * len(fused_attention.K4_BODY_HDS)
          and all(n > 0 for n in tf32.values()),
          f"K4's f32 instantiations' TF32 HMMAs: {tf32}")
    check(mma["launch_errors"] == 0 and mma["tflops"] > 0,
          f"mma.sync TF32 probe: {mma}")
    check(overlap["launch_errors"] == 0 and overlap["both_ms"] > 0,
          f"mma.sync / FFMA overlap probe: {overlap}")
    check(not any("tf32x3" in e for e in attention_ptxas["spilling_entries"]),
          f"K4's f32 body spills: {attention_ptxas['spilling_entries']}")
    # K4's sliced bodies (head_dim above 256): bf16 on wgmma fed by TMA, f32
    # in TF32 on wgmma fed by TMA (no mma.sync), neither spilling nor either
    # serialising its wgmmas
    check(len(sliced) == 2 and all(n > 0 for c in sliced.values() for op, n in c.items()
                                   if op != "HMMA_TF32")
          and all(c.get("HMMA_TF32", 0) == 0 for c in sliced.values()),
          f"K4's sliced bodies' SASS: {sliced}")
    check(not any("sliced" in e for e in attention_ptxas["spilling_entries"]),
          f"K4's sliced bodies spill: {attention_ptxas['spilling_entries']}")
    check(all(n["C7515"] == n["C7518"] == 0 for n in sliced_notes.values()),
          f"ptxas serialised a sliced body's wgmmas: {sliced_notes}")
    check(len(k1_tf32) == 3 and all(n > 0 for n in k1_tf32.values()),
          f"K1's wide f32 instantiations' TF32 HGMMAs: {k1_tf32}")
    check(not any("tf32x3" in e or "split_sum" in e
                  for e in mlp_ptxas["spilling_entries"]),
          f"K1's wide f32 body spills: {mlp_ptxas['spilling_entries']}")
    check(mlp_ptxas["wgmma_serialized"] == mlp_ptxas["wgmma_serialized_divergent"] == 0,
          "ptxas serialised K1's wgmmas")
    for name, counts in narrow_tf32.items():
        check(len(counts) == len(fused_mlp.WIDTHS) and all(n > 0 for n in counts.values()),
              f"the narrow f32 body's TF32 HGMMAs in {name}: {counts}")
        check(not any("narrow_tf32x3" in e
                      for e in ptxas_summary(logs[name])["spilling_entries"]),
              f"the narrow f32 body spills in {name}")
    check(len(k1b_tf32) == len(fused_mlp.WIDTHS) and all(n > 0 for n in k1b_tf32.values()),
          f"K1b's f32 instantiations' TF32 HMMAs: {k1b_tf32}")
    check(not any("tf32x3" in e for e in k1b_ptxas["spilling_entries"]),
          f"K1b's f32 body spills: {k1b_ptxas['spilling_entries']}")
    # the bf16 wgmma pipeline (`mlp_pipeline.cuh`) in K1b's and K1c's
    # libraries: wgmmas fed by TMA in each instantiation, no spill (ptxas's
    # serialisation notes are checked for every library below)
    for name, counts in pipelines.items():
        check(len(counts) == 3 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                                       for c in counts.values()),
              f"the wgmma pipeline's HGMMA / UTMALDG in {name}: {counts}")
        check(not any(PIPELINE_KERNELS[name] in e
                      for e in ptxas_summary(logs[name])["spilling_entries"]),
              f"the wgmma pipeline spills in {name}")
    # its D = 8 instance: wgmmas fed by TMA, no spill, no wgmma serialised
    for name, counts in pipelines_d8.items():
        check(len(counts) == 1 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                                       for c in counts.values()),
              f"the wgmma pipeline's D = 8 HGMMA / UTMALDG in {name}: {counts}")
        check(not any(PIPELINE_D8_KERNELS[name] in e
                      for e in ptxas_summary(logs[name])["spilling_entries"]),
              f"the wgmma pipeline's D = 8 instance spills in {name}")
        check(d8_notes[name]["C7515"] == d8_notes[name]["C7518"] == 0,
              f"ptxas serialised the D = 8 instance's wgmmas in {name}: {d8_notes[name]}")
    for form, g in gelu.items():
        check(g["fp32"] > 0 and g["launch_error"] == 0
              and g["max_abs_err_vs_plain"] <= GELU_PROBE_ATOL,
              f"GELU probe {form}: {g}")
    check(gelu["poly"]["mufu"] == 0, f"the polynomial GELU takes exponentials: {gelu}")
    check(ptxas_summary(logs["mlp_pipelined"])["wgmma_serialized"] == 0,
          "ptxas serialised K1c's wgmmas")
    # the wide bodies (`mlp_wide.cuh`), in each library that runs them
    for name in MLP_LIBRARIES:
        ptxas = ptxas_summary(logs[name])
        check(wide[name] and all(n > 0 for n in wide[name].values()),
              f"the wide bodies' HGMMAs in {name}: {wide[name]}")
        check(not any("wide_" in e or "split_sum" in e for e in ptxas["spilling_entries"]),
              f"the wide bodies spill in {name}: {ptxas['spilling_entries']}")
        check(ptxas["wgmma_serialized"] == ptxas["wgmma_serialized_divergent"] == 0,
              f"ptxas serialised wgmmas in {name}")


# K1c's bf16 grid at the shapes of its phase: the serving pass (one model)
# and the sweep's evaluation with the model axis (its f32 grid, K1's narrow
# body's: `K1_NARROW_F32_PLAN_CASES`).
K1C_PLAN_CASES = ((torch.bfloat16, 64, B * 65, 1), (torch.bfloat16, 64, 24 * 65, 30))


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


#: The libraries of K1, K1b and K1c, each of which includes the wide bodies.
MLP_LIBRARIES = ("fused_mlp", "mlp_chunked", "mlp_pipelined")
#: The bf16 wgmma pipeline's kernel (`csrc/mlp_pipeline.cuh`) in K1b's
#: library (fc2 summed chunk by chunk) and in K1c's, at D 16-64, and its D =
#: 8 instance (the hidden columns split across a cluster).
PIPELINE_KERNELS = {"mlp_chunked": "chunked_wgmma_kernel",
                    "mlp_pipelined": "pipelined_wgmma_kernel"}
PIPELINE_D8_KERNELS = {"mlp_chunked": "chunked_wgmma_d8_kernel",
                       "mlp_pipelined": "pipelined_wgmma_d8_kernel"}


def ptxas_notes(log: str, kernel: str) -> dict:
    """ptxas's wgmma notes (C7515, C7517, C7518) on the entries whose
    mangled names hold `kernel`."""
    notes = [line for line in log.splitlines() if kernel in line and "(C75" in line]
    return {code: sum(f"({code})" in line for line in notes)
            for code in ("C7515", "C7517", "C7518")}


def pipeline_sass(name: str, kernel: str) -> dict:
    """Lines of HGMMA and of UTMALDG in each instantiation (one a D) of the
    bf16 pipeline's `kernel` in `csrc/<name>.cu`'s library, by its mangled
    name."""
    return {fn.split()[0]: {op: sum(op in line for line in fn.splitlines())
                            for op in ("HGMMA", "UTMALDG")}
            for fn in sass_of(_build.library_path(name)).split("Function : ")[1:]
            if kernel in fn.split()[0]}


def wide_sass(name: str) -> dict:
    """Lines of HGMMA (bf16 or TF32) in each instantiation of the wide
    bodies (`csrc/mlp_wide.cuh`: the two-launch GEMMs and K1c's queue) in
    `csrc/<name>.cu`'s library, by its mangled name."""
    return {fn.split()[0]: sum("HGMMA" in line for line in fn.splitlines())
            for fn in sass_of(_build.library_path(name)).split("Function : ")[1:]
            if re.search(r"wide_(gemm|tf32x3|queue)", fn.split()[0])}


# K1c's wide queue at the `wide_axis` phase's shapes: five stacked members
# in bf16 at B=8 and in f32 at B=1, and one ViT-H-width model at B=8.
K1C_WIDE_PLAN_CASES = ((STRETCH_B * 513, 768, 3072, 5, torch.bfloat16),
                       (513, 768, 3072, 5, torch.float32),
                       (STRETCH_B * 513, 1280, 5120, 1, torch.bfloat16))


def k1c_wide_plan(n: int, D: int, M: int, models: int, dtype) -> dict:
    """`fused_mlp.k1c_wide_plan` at one shape on this card, with its ticket
    count (one a unit)."""
    card_ = torch.cuda.get_device_properties(0)
    plan = fused_mlp.k1c_wide_plan(n, D, M, models, dtype, card_.multi_processor_count,
                                   card_.L2_cache_size)
    check(1 <= plan["lead"] <= plan["groups"] and plan["blocks"] <= plan["resident"],
          f"K1c wide plan {plan}: a lead past the groups, or more blocks than the SMs")
    return {"dtype": str(dtype).split(".")[1], **plan, "tickets": plan["units"]}


def k1b_f32_sass() -> dict:
    """Lines of TF32 HMMA in each instantiation of K1b's f32 body (one a D),
    by its mangled name in the library's SASS."""
    return {fn.split()[0]: sum("HMMA" in line and "TF32" in line
                               for line in fn.splitlines())
            for fn in sass_of(_build.library_path("mlp_chunked")).split("Function : ")[1:]
            if "chunked_tf32x3_kernel" in fn.split()[0]}


def narrow_f32_sass(name: str) -> dict:
    """Lines of TF32 HGMMA in each instantiation of K1's narrow f32 body
    (one a D) in `csrc/<name>.cu`'s library, by its mangled name."""
    return {fn.split()[0]: sum("HGMMA" in line and "TF32" in line
                               for line in fn.splitlines())
            for fn in sass_of(_build.library_path(name)).split("Function : ")[1:]
            if "narrow_tf32x3_kernel" in fn.split()[0]}


# The narrow f32 body's grids (`narrow_plan`): K1 at the training path's
# 260 rows at (D, M) = (16, 2,048) and (64, 3,072), at 4,160 rows, and at
# the sweep's model axis; K1c at the model axis.
K1_NARROW_F32_PLAN_CASES = ((260, 16, 2048, 2048, 0, "seq"), (260, 64, 3072, 3072, 0, "seq"),
                            (4160, 64, 3072, 3072, 0, "seq"),
                            (24 * 65, 64, 3072, [2048] * 15 + [3072] * 15, 30, "seq"),
                            (24 * 65, 64, 3072, [2048] * 15 + [3072] * 15, 30, "pipelined2"))


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


# K1's wide f32 grids at the K1 phase's stretch shapes (D = 768, M = 3,072),
# and K1's and K1b's at the `wide_axis` phase's five stacked members at B=1.
K1_F32_PLAN_CASES = ((STRETCH_B * 513, 768, 3072, 1, False), (513, 768, 3072, 1, False),
                     (70, 768, 3072, 1, False), (513, 768, 3072, 5, False),
                     (513, 768, 3072, 5, True))


def k1_f32_plan(N: int, D: int, M: int, models: int, chunked: bool) -> dict:
    """`fused_mlp.wide_f32_plan` at one shape on this card (K1b's with
    `chunked`)."""
    return fused_mlp.wide_f32_plan(N, D, M,
                                   torch.cuda.get_device_properties(0).multi_processor_count,
                                   models, chunked)


def k4_f32_sass() -> dict:
    """Lines of TF32 HMMA in each instantiation of K4's f32 body (head_dim,
    16- or 4-byte copies), by its mangled name in the library's SASS."""
    return {fn.split()[0]: sum("HMMA" in line and "TF32" in line
                               for line in fn.splitlines())
            for fn in sass_of(_build.library_path("attention")).split("Function : ")[1:]
            if "attention_tf32x3_kernel" in fn.split()[0]}


def k4_sliced_sass() -> dict:
    """Lines of HGMMA and UTMALDG in K4's sliced bf16 body, and of TF32
    HGMMA, UTMALDG and TF32 HMMA in its sliced f32 body, by mangled name."""
    out = {}
    for fn in sass_of(_build.library_path("attention")).split("Function : ")[1:]:
        name, lines = fn.split()[0], fn.splitlines()
        if "attention_sliced_wgmma_kernel" in name:
            out[name] = {op: sum(op in line for line in lines) for op in ("HGMMA", "UTMALDG")}
        elif "attention_sliced_f32_kernel" in name:
            out[name] = {"HGMMA_TF32": sum("HGMMA" in line and "TF32" in line for line in lines),
                         "UTMALDG": sum("UTMALDG" in line for line in lines),
                         "HMMA_TF32": sum("HMMA" in line and "TF32" in line
                                          for line in lines)}
    return out


# The sliced bodies' cluster plans (`attention_sliced_f32_plan`,
# `attention_sliced_bf16_plan`) at the `widest` model's shape (f32 at B = 1,
# bf16 at B = 2) and at the shapes `chip_turns.py` times them: hd 512 at 513
# and 65 tokens, 264 (f32 boxes 4 + 5, bf16 2 + 3), 1,024 (four ranks).
K4_SLICED_F32_PLAN_SHAPES = ((1, 24, 513, 512), (1, 8, 513, 264), (1, 8, 513, 1024),
                             (1, 24, 65, 512))
K4_SLICED_BF16_PLAN_SHAPES = ((2, 24, 513, 512), (2, 8, 513, 264), (2, 8, 513, 1024),
                              (2, 24, 65, 512))
K4_SLICED_PLAN_KEYS = ("cluster", "groups", "rows_a_block", "keys_a_chunk", "stages",
                       "boxes_busiest_rank", "boxes_idlest_rank", "clusters",
                       "clusters_resident", "blocks", "smem_bytes_a_block",
                       "registers_at_entry")


def k4_sliced_plan(nb: int, H: int, S: int, hd: int, dtype=torch.float32) -> dict:
    """The sliced body's cluster plan for `dtype` at one shape on this card,
    with its waves (clusters over the clusters the card holds at once),
    checked against `fused_attention.k4_sliced_split`, the wrapper's
    mirror; in bf16 every rank's run at most K4_BF16_RUN boxes (its q boxes
    loaded once a block) up to head_dim 2,048."""
    out = (ctypes.c_int * len(K4_SLICED_PLAN_KEYS))()
    symbol = "attention_sliced_bf16_plan" if dtype == torch.bfloat16 else "attention_sliced_f32_plan"
    fn = _build.entry("attention", [ctypes.c_int] * 5 + [ctypes.c_void_p], symbol)
    _build.check("attention", fn(torch.cuda.current_device(), nb, H, S, hd, out))
    plan = dict(zip(K4_SLICED_PLAN_KEYS, out))
    split = fused_attention.k4_sliced_split(hd, dtype)
    sizes = [b1 - b0 for b0, b1 in split["boxes"]]
    check(plan["cluster"] == split["cluster"] and plan["groups"] == split["groups"]
          and plan["boxes_busiest_rank"] == max(sizes)
          and plan["boxes_idlest_rank"] == min(sizes) and plan["clusters_resident"] > 0
          and (dtype != torch.bfloat16 or hd > 2048
               or max(sizes) <= fused_attention.K4_BF16_RUN),
          f"K4's sliced {dtype} plan {plan} against the wrapper's split {split}")
    return {"shape": [nb, H, S, hd], **plan, "boxes": split["boxes"],
            "waves": plan["clusters"] / plan["clusters_resident"]}


# K4's bodies at the stretch path's shape (and K3's on them, the same), and
# at head_dim 128 and 32 on the card tests' S = 200; then at ViT-H's head_dim
# 80 at B=8 (phase `vit_h`), and the sliced bodies at the `widest` model's
# head_dim 512 at B=2.
K4_PLAN_SHAPES = ((STRETCH_B, 12, 513, 64), (2, 4, 200, 128), (2, 4, 200, 32),
                  (STRETCH_B, 16, 513, 80), (2, 24, 513, 512))
# `attention_plan`'s report: in bf16 the query tiles are a consumer
# warpgroup's 64 rows and a key step 16 keys, the registers those at entry
# (before setmaxnreg); in f32 a warp's 16 rows and 8 keys, but above head_dim
# 256, where the f32 body's blocks are the bf16 body's (key steps of 8)
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
    # above 256 both sliced bodies take the bf16 body's blocks
    keys = K4_PLAN_KEYS[torch.bfloat16 if fused_attention.k4_slices(hd) > 1 else dtype]
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
# K1's narrow f32 body by device time beside the chain's: one model at the
# training path's 260 rows and at 4,160, at the narrowest and the widest
# class's (D, M).
K1_NARROW_F32_TIMED = tuple((N, D, M) for N in (TRAIN_ROWS[0], 64 * 65)
                            for D, M in ((16, 2048), (64, 3072)))


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
            variant: str = "seq", models: int = 0, device: bool = False,
            k1_device: bool = False) -> dict:
    """A fused-FFN kernel (K1, or the variant's K1b or K1c) against its
    plain version on one shape, timed.  With `models` > 0 the weights carry
    that leading model axis and `active` is a list of one width a model,
    given to the kernel as a device tensor; the library chain is then
    `baddbmm` -> `F.gelu` -> `baddbmm` with the width mask folded into w2,
    as the JAX wrapper folds it (`pallas_mlp.py:172-176`).  The chain
    computes exact erf GELU in every type: it is the yardstick of time, and
    the kernels are held to their plain versions.  With `device`, the
    kernel's and the chain's device time under the profiler too: the
    events' `ms` is no less than the host's time to make a call.  With
    `k1_device`, K1's device time on the same inputs beside them."""
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

    # K1's and K1c's narrow f32 body: its plan, and the same bits twice
    narrow = dtype == torch.float32 and D <= fused_mlp.WIDTHS[-1] and variant != "chunked"
    with torch.no_grad(), mlp_variant(variant):
        out = call()
        body = {"seq": fused_mlp.k1_body_launched, "chunked": fused_mlp.k1b_body_launched,
                "pipelined2": fused_mlp.k1c_body_launched}[variant]()
        check(body == fused_mlp._variant_body(variant, dtype, D),
              f"{VARIANT_KERNELS[variant]} at ({dtype}, D {D}) launched body {body}")
        narrow_case = {}
        if narrow:
            k1c_body = fused_mlp.k1c_body_launched() if variant == "pipelined2" else body
            narrow_case = {"k1c_body": k1c_body if variant == "pipelined2" else None,
                           "same_bits_twice": bool(torch.equal(out, call())),
                           "plan": narrow_plan(N, D, M, active, models, variant)}
            check(k1c_body == "narrow_tf32x3" and narrow_case["same_bits_twice"],
                  f"{VARIANT_KERNELS[variant]} f32 at D {D}: body {k1c_body}, "
                  f"the same bits twice: {narrow_case['same_bits_twice']}")
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
    k1_device_ms = None
    if k1_device:
        with torch.no_grad(), mlp_variant("seq"):
            k1_device_ms = mlp_device_ms(call)
    elt = x.element_size()
    P = max(models, 1)
    flops = 4.0 * N * D * live
    nbytes = (elt * (2 * P * N * D + 2 * D * live + live + P * D)
              + (4 * P if models else 0))
    bound_ms, bound_by = bound(flops, nbytes, dtype, gelus=N * live)
    tf32 = {}
    if body == "wide_tf32x3" or (variant != "seq" and dtype == torch.float32) or narrow:
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
            "bound_ms": bound_ms, "bound_by": bound_by, **tf32, **narrow_case,
            # the bound's terms: the products at the peak for their type,
            # the GELUs of the kernels' form (`GELU_OF`) at their rate
            "products_ms": 4.0 * N * D * live / PEAK_FLOPS[dtype] * 1e3,
            "gelu": GELU_OF[dtype], "gelus_ms": N * live / gelu_rate[dtype] * 1e3}
    if device:
        case.update(device_ms=device_ms, library_device_ms=library_device_ms)
    if k1_device:
        case.update(k1_device_ms=k1_device_ms)
    emit(case)
    check(ok, f"{case['phase']} {case}")
    return case


def narrow_plan(N: int, D: int, M: int, active, models: int, variant: str) -> dict:
    """`fused_mlp.k1_narrow_f32_plan` of a K1 or K1c f32 call on this card
    (K1c's row-tile groups), with the body's occupancy and the clusters of
    its splits the card holds at once (`fused_mlp_narrow_f32_shape`)."""
    device = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    P, Dk = max(models, 1), fused_mlp.kernel_width(D, torch.float32)
    plan = fused_mlp.k1_narrow_f32_plan(N, Dk, M, active, P, sms)
    if variant == "pipelined2":
        plan = fused_mlp.k1_narrow_f32_plan(N, Dk, M, active, P, sms,
                                            fused_mlp.k1c_narrow_f32_groups(N))
    keys = ("tile_rows", "threads_a_block", "smem_bytes_a_block", "registers",
            "blocks_an_sm", "sms", "clusters_at_once")
    out = (ctypes.c_int * len(keys))()
    fn = _build.entry("fused_mlp", [ctypes.c_int] * 3 + [ctypes.c_void_p],
                      "fused_mlp_narrow_f32_shape")
    _build.check("fused_mlp", fn(device.index, Dk, plan["splits"], out))
    return {k: plan[k] for k in ("tiles", "chunks", "splits", "groups", "units",
                                 "skipped_units", "blocks", "waves")} | dict(zip(keys, out))


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
    largest bf16 cases, the latency path's cases, the stretch path's f32
    cases and the narrow f32 body's timed cases (`K1_NARROW_F32_TIMED`)."""
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
    narrow = [k1_case(own, torch.float32, N, D, M, M, "train", device=True)
              for N, D, M in K1_NARROW_F32_TIMED]
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
    return main, wide, small, wide_f32, narrow


def phase_f32_scaled(variant: str, N: int, D: int, seed: int) -> dict:
    """K1's wide f32 body (variant "seq", D = 768) or narrow one (D <= 64),
    K1b's f32 body ("chunked") or K1c's ("pipelined2", K1's narrow body)
    with x four times larger, where the 3xTF32 products'
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
        body = (fused_mlp.k1_body_launched() if variant == "seq" else
                fused_mlp.k1c_body_launched() if variant == "pipelined2" else None)
        ref = exact_mlp(x, w1, b1, w2, b2)
        over, ratio = over_gate(out, ref, TOL[torch.float32])
        plain_over, plain_ratio = over_gate(plain(x, w1, b1, w2, b2, M), ref,
                                            TOL[torch.float32])
    case = {"phase": f"{kernel}_f32_scaled", "shape": [N, D, M], "x_scale": 4.0,
            "body": body, "launches": launched, "reference": "f64",
            "over_gate": over, "max_err_over_gate": ratio, "plain_over_gate": plain_over,
            "plain_max_err_over_gate": plain_ratio,
            "ok": over == 0 and launched == 1
            and body in (None, "wide_tf32x3", "narrow_tf32x3")}
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


def k3_case(gen, dtype, shape, timed: bool) -> dict:
    """K3's core against its plain version at (B, T, D, H), as `phase_k3`
    holds it; with `timed`, both device times under the profiler too."""
    nb, T, D, H = shape
    hd = D // H
    on_k4 = attention_layer.on_k4(hd)
    qkv = torch.randn(nb, T, 3 * D, generator=gen, device="cuda")
    qkv[..., 2 * D:] *= math.sqrt(T / math.e)
    qkv = qkv.to(dtype)
    q, k, v = attention_layer._split(qkv)
    heads = [t.unflatten(-1, (H, hd)).transpose(1, 2) for t in (q, k, v)]
    tol = K4_BF16_TOL if dtype == torch.bfloat16 else None
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
    return case


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
    for dtype, shape in cases:
        timed = (dtype, shape) in K3_DEVICE_TIMED
        case = k3_case(gen, dtype, shape, timed)
        if (dtype, shape) == (torch.float32, K3_TRAIN_CASES[0]):
            main = case
        if (dtype, shape) in K3_STRETCH_CASES:
            stretch[dtype] = case
        if timed and (dtype, shape) not in K3_STRETCH_CASES:
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


def k4_case(gen, dtype, shape, views: str, device: bool) -> dict:
    """K4 against its plain version at (B, H, S, hd) on the model's views
    (`views` "model") or K3's ("qkv"), as `phase_k4` holds it; with
    `device`, its and SDPA's device time under the profiler too."""
    tol = K4_BF16_TOL if dtype == torch.bfloat16 else None
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
        # the backend SDPA takes, beside the timed cases
        library = sdpa_backend(q, k, v) if device else {}
        # `ms` is no less than the host's time to make one call; the
        # kernel's own time is its device time under the profiler
        device_ms = library_device_ms = None
        if device:
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
            "library_device_ms": library_device_ms, **library,
            **attention_bound(dtype, nb * H, S, hd, q.element_size())}
    emit(case)
    body_ok = body == k4_body_of(dtype, hd)
    check(ok and gate_ok and jax_ok and view_ok and body_ok
          and device_ms != 0.0, f"K4 {case}")
    return case


def k4_body_of(dtype, hd: int) -> str:
    """The K4 body a call on 16-byte views at head_dim `hd` takes: the
    unsliced bf16 or f32 body, above 256 its sliced form."""
    sliced = fused_attention.k4_slices(hd) > 1
    return fused_attention.K4_BODIES[(0 if dtype == torch.bfloat16 else 1)
                                     + (3 if sliced else 0)]


def sdpa_backend(q, k, v) -> dict:
    """The backend `F.scaled_dot_product_attention` takes on q, k, v, as its
    dispatch chooses it (`torch._fused_sdp_choice`; its flash backend takes
    no head_dim above 256)."""
    from torch.nn.attention import SDPBackend
    return {"library_backend": SDPBackend(torch._fused_sdp_choice(q, k, v)).name}


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
        for shape, views in K4_CASES:
            case = k4_case(gen, dtype, shape, views, shape[2] == 513)
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
    # the cases above drew their cotangents from `gen`, or from `own`
    cotangent_gens = {name: own for name in ("K1 model axis", "K1b", "K1c",
                                             "K3 on K4's body")}
    # K1's wide body at ViT-H's D 1,280 (M 5,120) and K4 at its head_dim 80,
    # from a generator of their own, so every draw above stays as it was
    vit_h = torch.Generator(device="cuda").manual_seed(SEED + 8)
    cases.update({
        "K1 at D 1,280": (lambda *a: fused_mlp.fused_mlp(*a, 4600),
                          lambda *a: fused_mlp._plain_mlp(*a, 4600),
                          [torch.randn(2, 9, 1280, generator=vit_h, device="cuda"),
                           *mlp_weights(vit_h, torch.float32, 1280, 5120)]),
        "K4 at head_dim 80": (fused_attention.fused_attention,
                              fused_attention._plain_attention_k4,
                              model_views(vit_h, (2, 2, 70, 80), torch.float32)),
    })
    cotangent_gens.update({"K1 at D 1,280": vit_h, "K4 at head_dim 80": vit_h})
    for name, (kernel, plain, args) in cases.items():
        grads, cotangent = [], None
        for fn in (kernel, plain):
            leaves = [a.detach().clone().requires_grad_() for a in args]
            out = fn(*leaves)
            if cotangent is None:
                cotangent = torch.randn(out.shape, device="cuda",
                                        generator=cotangent_gens.get(name, gen))
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
# `pipelined_wgmma_kernel` is K1's bf16 body at D 16-64 and K1c's
# (`pipelined_wgmma_d8_kernel` at D <= 8), and `narrow_tf32x3_kernel` their
# f32 body: every path but the `variants` phase's K1c turns launches them as
# K1, so they are K1's group.
KERNEL_GROUPS = (("K1", "fused_mlp"), ("K1", "wide_gemm"), ("K1", "wide_tf32x3"),
                 # K1c's wide queue; K1b's wide calls run K1's wide kernels
                 # (`wide_gemm`, `wide_tf32x3`, `split_sum`: group K1)
                 ("K1c", "wide_queue"),
                 # K1's narrow f32 body, K1c's f32 route too
                 ("K1", "narrow_tf32x3"),
                 ("K1", "split_sum"), ("K1b", "chunked_"),
                 ("K1", "pipelined_wgmma"),
                 # an older checkout's bf16 D = 8 body, as `chip_turns.py`
                 # times it (its K1b body is "chunked_core")
                 ("K1", "pipelined_core"),
                 # every kernel of `attention.cu` (its bf16 and f32 bodies,
                 # and an older checkout's, as `chip_turns.py` times them)
                 ("K2", "tiny_attention"), ("K4", "attention_"),
                 # the hybrid stem's library kernels (cuDNN's convs, the
                 # layout changes around them, torch's GroupNorm), ahead of
                 # "gemm" and "elementwise", which their names also hold
                 ("pool", "max_pool"), ("group_norm", "GroupNorm"),
                 ("group_norm", "RowwiseMoments"),
                 ("group_norm", "ComputeFusedParams"), ("conv", "fprop"),
                 ("conv", "dgrad"), ("conv", "wgrad"), ("conv", "onvolve"),
                 ("conv", "conv2d"), ("conv", "nchwToNhwc"),
                 ("conv", "nhwcToNchw"),
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
    # the same model under K1b and K1c (their wide bodies at D 768)
    result.update(variant_passes("stretch", model, x, ref, layers))
    return result


# --- the `pretrained` and `hybrid` phases: ViT-B/16 at 65 and 321 tokens ----
# ViT-B/16's widths (the reference's ViT-B_16) at full depth.
VIT_B16 = dict(hidden_size=768, mlp_dim=3072, num_heads=12, num_layers=12)
# Google's ViT-B/16 npz: 224^2 images in 16^2 patches, a 14 x 14 grid + CLS.
NPZ_GRID = 14
# The hybrid's f32 forward and backward: volumes, and the parameters whose
# gradients are held (the stem's root conv, the conv2 of stage 2's first
# unit, which has the stride, and the patch embedding over its features).
HYBRID_GRAD_B = 2
HYBRID_GRAD_PARAMS = ("transformer.embeddings.hybrid_model.root.conv.weight",
                      "transformer.embeddings.hybrid_model.body.block2.unit1.conv2.weight",
                      "transformer.embeddings.patch_embeddings.weight")


def vit_b16_npz(path, seed: int) -> None:
    """A ViT-B/16 npz in the `vision_transformer` repo's names and published
    shapes (12 blocks of 12 heads of 64, MLP 3,072, a 197-token position
    table, a 1-class head), but with a one-channel (16, 16, 1, 768)
    embedding kernel, as `tests/test_pretrained_and_hybrid.py` builds it;
    values from `seed` by numpy at a trained model's scale (kernels of
    variance 1 / fan_in, norms' scales near 1)."""
    rng = np.random.default_rng(seed)
    D, H, M = VIT_B16["hidden_size"], VIT_B16["num_heads"], VIT_B16["mlp_dim"]

    def n(*shape, std=0.02, mean=0.0):
        return mean + rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    w = {"embedding/kernel": n(16, 16, 1, D, std=1 / 16), "embedding/bias": n(D),
         "cls": n(1, 1, D),
         "Transformer/posembed_input/pos_embedding": n(1, NPZ_GRID ** 2 + 1, D),
         "Transformer/encoder_norm/scale": n(D, std=0.05, mean=1.0),
         "Transformer/encoder_norm/bias": n(D),
         "head/kernel": n(D, 1, std=D ** -0.5), "head/bias": n(1)}
    for i in range(VIT_B16["num_layers"]):
        r = f"Transformer/encoderblock_{i}"
        for key in (pretrained.ATTENTION_Q, pretrained.ATTENTION_K,
                    pretrained.ATTENTION_V):
            w[f"{r}/{key}/kernel"] = n(D, H, D // H, std=D ** -0.5)
            w[f"{r}/{key}/bias"] = n(H, D // H)
        w[f"{r}/{pretrained.ATTENTION_OUT}/kernel"] = n(H, D // H, D, std=D ** -0.5)
        w[f"{r}/{pretrained.ATTENTION_OUT}/bias"] = n(D)
        w[f"{r}/{pretrained.FC_0}/kernel"] = n(D, M, std=D ** -0.5)
        w[f"{r}/{pretrained.FC_0}/bias"] = n(M)
        w[f"{r}/{pretrained.FC_1}/kernel"] = n(M, D, std=M ** -0.5)
        w[f"{r}/{pretrained.FC_1}/bias"] = n(D)
        for key in (pretrained.ATTENTION_NORM, pretrained.MLP_NORM):
            w[f"{r}/{key}/scale"] = n(D, std=0.05, mean=1.0)
            w[f"{r}/{key}/bias"] = n(D)
    np.savez(path, **w)


def top_kernels(fn, n: int = 12) -> list:
    """The `n` kernels that took the most device time in one traced call of
    `fn`: name (cut to 120 characters), ms, launches and group."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return [{"name": k[:120], "ms": ms, "count": c,
             "group": next((g for g, pat in KERNEL_GROUPS if pat in k), "other")}
            for k, ms, c in rows[:n]]


def vit_b16_kernel_cases(gen, tokens: int, path: str, widths=None) -> dict:
    """K1's wide bodies, K4 and K3 (on K4's body) against their plain
    versions at the shapes ViT-B/16 (or the model of `widths`) gives them at
    `tokens` tokens: bf16 at B = STRETCH_B, f32 at B = 1; each with its
    device time, bound and library time (the F.linear -> F.gelu -> F.linear
    chain, SDPA)."""
    widths = widths or VIT_B16
    D, M, H = widths["hidden_size"], widths["mlp_dim"], widths["num_heads"]
    cases = {"K1": [], "K4": [], "K3": []}
    for dtype, nb in ((torch.bfloat16, STRETCH_B), (torch.float32, 1)):
        case = k1_case(gen, dtype, nb * tokens, D, M, M, path, device=True)
        want = "wide_wgmma" if dtype == torch.bfloat16 else "wide_tf32x3"
        check(case["body"] == want, f"K1 {path} body {case['body']}, not {want}")
        cases["K1"].append(case)
        cases["K4"].append(k4_case(gen, dtype, (nb, H, tokens, D // H), "model",
                                   True))
    cases["K3"].append(k3_case(gen, torch.bfloat16, (STRETCH_B, tokens, D, H), True))
    return cases


def serve_vit_b16(name: str, model, x, expect: dict) -> dict:
    """One ViT-B/16 model in bf16 at B = STRETCH_B against the plain modules
    in bf16, under `auto` and `layer` in turn, as `phase_stretch` serves its
    model: STRETCH_ITERS passes × REPEATS by the host clock (ms a batch,
    volumes/s), launch counts of the first run held exactly, tokens within
    TOKENS_BF16_ATOL, then one traced pass: device busy ms, kernels, both by
    group, and the idle share.  `model` and `x` are converted in place."""
    model.to(torch.bfloat16)
    x = x.to(torch.bfloat16)

    def passes() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STRETCH_ITERS):
            model(x)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    result = {}
    with torch.no_grad():
        set_impls("plain")
        try:
            ref = model(x)
        finally:
            set_impls("auto")
        for impl in expect:
            set_impls(impl)
            try:
                model(x)                    # warm-up
                reset_launches()
                seconds = passes()
                counts = launches()
                clocks = smi("clocks.sm,power.draw,temperature.gpu")
                repeats = [seconds] + [passes() for _ in range(REPEATS - 1)]
                out = model(x)
                busy, groups, kernels, by_group = device_time(lambda: model(x))
            finally:
                set_impls("auto")
            want = {k: n * STRETCH_ITERS for k, n in expect[impl].items()}
            wall = statistics.median(repeats) / STRETCH_ITERS * 1e3
            volumes = x.shape[0] * STRETCH_ITERS
            diff = (out.tokens.float() - ref.tokens.float()).abs()
            T = model.transformer.embeddings.position_embeddings.shape[1]
            shape_ok = (tuple(out.tokens.shape) == (x.shape[0], T, model.config.hidden_size)
                        and tuple(out.logits.shape) == (x.shape[0], 1))
            finite = bool(torch.isfinite(out.tokens).all()
                          and torch.isfinite(out.logits).all())
            err = float(diff.max())
            ok = (shape_ok and finite and err <= TOKENS_BF16_ATOL
                  and counts == want and busy > 0)
            res = {"phase": name, "card": card, "impl": impl, "dtype": "bfloat16",
                   "B": x.shape[0], "tokens": T, "iters": STRETCH_ITERS,
                   "seconds": seconds, "ms_per_batch": wall,
                   "volumes_per_s": volumes / seconds,
                   "volumes_per_s_repeats": [volumes / r for r in repeats],
                   "launches": counts, "expected_launches": want,
                   "tokens_max_abs_err": err,
                   "tokens_mean_abs_err": float(diff.mean()),
                   "atol": TOKENS_BF16_ATOL, "shape_ok": shape_ok,
                   "finite": finite, "device_busy_ms": busy,
                   "device_idle_share": 1.0 - busy / wall,
                   "kernels": kernels, "by_group_ms": groups,
                   "kernels_by_group": by_group, "after_run": clocks, "ok": ok}
            emit(res)
            check(ok, f"{name} {impl}: err {err}, shape {shape_ok}, finite "
                      f"{finite}, launched {counts} of {want}, busy {busy}")
            result[impl] = res
    return result


def f32_against_plain(name: str, model, x, expect: dict, impl: str = "auto",
                      ref=None) -> dict:
    """The f32 model at B = x.shape[0] under `impl` against the plain
    modules (TOKENS_F32_ATOL; their output `ref` where given), with the
    launches of the pass held exactly and its device time; under an impl
    other than `auto` also a pass's wall ms (host clock) and the idle share."""
    with torch.no_grad():
        if ref is None:
            set_impls("plain")
            try:
                ref = model(x)
            finally:
                set_impls("auto")
        set_impls(impl)
        try:
            reset_launches()
            out = model(x)
            counts = launches()
            busy, groups, kernels, _ = device_time(lambda: model(x))
            wall = {}
            if impl != "auto":
                ms = time_ms(lambda: model(x), 3)
                wall = {"wall_ms": ms, "device_idle_share": 1.0 - busy / ms}
        finally:
            set_impls("auto")
    err = max(float((out.tokens - ref.tokens).abs().max()),
              float((out.logits - ref.logits).abs().max()))
    ok = err <= TOKENS_F32_ATOL and counts == expect and busy > 0
    res = {"phase": f"{name}_f32" + ("" if impl == "auto" else f"_{impl}"), "impl": impl,
           "B": x.shape[0], "max_abs_err": err, "atol": TOKENS_F32_ATOL,
           "launches": counts, "expected_launches": expect, "device_busy_ms": busy,
           **wall, "kernels": kernels, "by_group_ms": groups, "ok": ok}
    emit(res)
    check(ok, f"{name} f32 {impl}: max abs err {err}, launched {counts}, busy {busy}")
    return res


def vit_b16_expect(layers: int = VIT_B16["num_layers"]) -> dict:
    """A pass's launches: K1 on its own (wide) bodies and K4 a layer under
    `auto`; K1 and K3, its core on K4's body (head_dim 64; ViT-H's 80),
    under `layer`."""
    L = layers
    return {"auto": counts_of(K1=L, K1_own=L, K4=L),
            "layer": counts_of(K1=L, K1_own=L, K3=L, K3_on_K4=L)}


def phase_pretrained(gen) -> dict:
    """ViT-B/16 initialised from a Google npz (`pretrained.load_from_npz`):
    a synthetic npz (`vit_b16_npz`) written to `build/pretrained_smoke/`,
    read back with `np.load` into a 128 x 128 x 5 model with patches of
    (16, 16, 5): 65 tokens.  The loaded tensors against the npz; f32 at B=1
    under `auto` against the plain modules; bf16 at B = STRETCH_B under
    `auto` and `layer` (`serve_vit_b16`); K1, K4 and K3 at its shapes."""
    cfg = ViTConfig(patch_size=(16, 16, 5), **VIT_B16)
    work = pathlib.Path(__file__).resolve().parent / "build" / "pretrained_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        vit_b16_npz(work / "ViT-B_16.npz", SEED)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with np.load(work / "ViT-B_16.npz") as npz:
            weights = {k: npz[k] for k in npz.files}
        state = pretrained.load_from_npz(weights, cfg, zero_head=False)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emb = "transformer.embeddings"
    pos, patch = state[f"{emb}.position_embeddings"], state[f"{emb}.patch_embeddings.weight"]
    D = VIT_B16["hidden_size"]
    q0 = weights[f"Transformer/encoderblock_0/{pretrained.ATTENTION_Q}/kernel"]
    out0 = weights[f"Transformer/encoderblock_0/{pretrained.ATTENTION_OUT}/kernel"]
    loaded = {
        "pos_shape": list(pos.shape),
        "pos_cls_kept": bool(torch.equal(pos[:, 0], torch.from_numpy(
            weights["Transformer/posembed_input/pos_embedding"][:, 0]))),
        "patch_only_at_z2": bool(torch.all(patch[..., [0, 1, 3, 4]] == 0)
                                 and torch.equal(patch[..., 2], torch.from_numpy(
                                     weights["embedding/kernel"].transpose(3, 2, 0, 1)))),
        "query_0": bool(torch.equal(state["transformer.encoder.layer.0.attn.query.weight"],
                                    torch.from_numpy(q0.reshape(D, D).T.copy()))),
        "out_0": bool(torch.equal(state["transformer.encoder.layer.0.attn.out.weight"],
                                  torch.from_numpy(out0.reshape(D, D).T.copy()))),
        "head": bool(torch.equal(state["head.weight"], torch.from_numpy(
            weights["head/kernel"].T.copy())))}
    ok = loaded["pos_shape"] == [1, 65, D] and all(
        v for k, v in loaded.items() if k != "pos_shape")
    emit({"phase": "pretrained_load", "npz_tensors": len(weights),
          "npz_parameters": int(sum(a.size for a in weights.values())),
          "npz_write_s": write_s, "npz_load_s": load_s, **loaded, "ok": ok})
    check(ok, f"pretrained load {loaded}")

    model = VisionTransformer3D(cfg, zero_head=False, vis=False,
                                generator=torch.Generator().manual_seed(SEED))
    model.load_state_dict(state)
    model.eval()
    del weights, state
    x = torch.randn(STRETCH_B, 128, 128, 5, 1, generator=gen, device="cuda")
    expect = vit_b16_expect()
    f32 = f32_against_plain("pretrained", model, x[:1], expect["auto"])
    served = serve_vit_b16("pretrained", model, x, expect)
    cases = vit_b16_kernel_cases(gen, 65, "pretrained")
    return {"f32": f32, **served, "cases": cases}


def phase_hybrid(gen) -> dict:
    """The R50+ViT-B/16 hybrid (the JAX defaults' ResNetV2 stem: units
    (3, 4, 9), width factor 1, under ViT-B/16, grid (8, 8)) at 128 x 128 x 5:
    8 x 8 x 5 features of 1,024 channels, 321 tokens.  f32 at B=1 under
    `auto` against the plain modules; one f32 forward and backward at
    B = HYBRID_GRAD_B of the BCE loss, the gradients of HYBRID_GRAD_PARAMS
    held to GRAD_RTOL of each one's largest entry; bf16 at B = STRETCH_B
    under `auto` and `layer` (`serve_vit_b16`), with the stem's own device
    time and the kernels that take the most; K1, K4 and K3 at its shapes."""
    cfg = ViTConfig(hybrid_grid=(8, 8), **VIT_B16)
    model = VisionTransformer3D(cfg, zero_head=False, vis=False,
                                generator=torch.Generator().manual_seed(SEED))
    model.eval()
    emb = model.transformer.embeddings
    with torch.no_grad():
        emb.position_embeddings.normal_(0.0, 0.02, generator=gen)
        emb.cls_token.normal_(0.0, 0.02, generator=gen)
    stem_params = sum(p.numel() for p in emb.hybrid_model.parameters())
    convs = sum(isinstance(m, torch.nn.Conv2d) for m in emb.hybrid_model.modules())
    # the stem's conv operations a 128^2 slice, 2 * out * in * kh * kw each,
    # from the shapes one slice gives them; the encoder's at 321 tokens
    conv_flops = []
    hooks = [m.register_forward_hook(lambda m, i, o: conv_flops.append(
        2 * o.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1]))
        for m in emb.hybrid_model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        emb.hybrid_model(torch.zeros(1, 128, 128, 1, 1, device="cuda"))
    for h in hooks:
        h.remove()
    T, D, M = 321, VIT_B16["hidden_size"], VIT_B16["mlp_dim"]
    encoder_flops = VIT_B16["num_layers"] * (8 * T * D * D + 4 * T * T * D
                                             + 4 * T * D * M)
    norms = sum(isinstance(m, torch.nn.GroupNorm) for m in emb.hybrid_model.modules())
    geometry_ok = (tuple(emb.position_embeddings.shape) == (1, 321, D)
                   and tuple(emb.patch_embeddings.weight.shape) == (D, 1024, 1, 1, 1))
    emit({"phase": "hybrid_model", "stem_parameters": stem_params,
          "parameters": sum(p.numel() for p in model.parameters()),
          "stem_convs": convs, "stem_group_norms": norms,
          "stem_gflop_a_slice": sum(conv_flops) / 1e9,
          "stem_gflop_a_batch": sum(conv_flops) * 5 * STRETCH_B / 1e9,
          "encoder_gflop_a_batch": encoder_flops * STRETCH_B / 1e9,
          "position_table": list(emb.position_embeddings.shape),
          "patch_weight": list(emb.patch_embeddings.weight.shape),
          "ok": geometry_ok})
    check(geometry_ok and convs == 52 and norms == 52,
          f"hybrid geometry: {convs} convs, {norms} norms")
    x = torch.randn(STRETCH_B, 128, 128, 5, 1, generator=gen, device="cuda")
    expect = vit_b16_expect()
    f32 = f32_against_plain("hybrid", model, x[:1], expect["auto"])

    # the f32 forward and backward under `auto` (K1, K4; their backwards
    # recompute through the plain versions) and under `plain`
    xg = x[:HYBRID_GRAD_B]
    y = torch.tensor([[1.0], [0.0]], device="cuda")
    params = dict(model.named_parameters())
    grads, counts = {}, None
    for impl in ("auto", "plain"):
        set_impls(impl)
        model.zero_grad(set_to_none=True)
        try:
            reset_launches()
            logits = model(xg).logits
            F.binary_cross_entropy_with_logits(logits, y).backward()
            if impl == "auto":
                counts = launches()
        finally:
            set_impls("auto")
        grads[impl] = {k: params[k].grad.detach().clone() for k in HYBRID_GRAD_PARAMS}
    model.zero_grad(set_to_none=True)
    rel = {k: float((grads["auto"][k] - grads["plain"][k]).abs().max()
                    / grads["plain"][k].abs().max()) for k in HYBRID_GRAD_PARAMS}
    ok = all(r <= GRAD_RTOL for r in rel.values()) and counts == expect["auto"]
    emit({"phase": "hybrid_gradients", "B": HYBRID_GRAD_B, "dtype": "float32",
          "loss": "bce", "max_err_over_scale": rel, "rtol_of_scale": GRAD_RTOL,
          "launches": counts, "expected_launches": expect["auto"], "ok": ok})
    check(ok, f"hybrid gradients {rel}, launched {counts}")
    grad_launches = counts

    served = serve_vit_b16("hybrid", model, x, expect)
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        stem_busy, stem_groups, stem_kernels, _ = device_time(
            lambda: emb.hybrid_model(xb))
        top = top_kernels(lambda: model(xb))
    busy = served["auto"]["device_busy_ms"]
    emit({"phase": "hybrid_stem", "card": card, "B": STRETCH_B,
          "dtype": "bfloat16", "stem_device_busy_ms": stem_busy,
          "stem_share_of_auto_pass": stem_busy / busy if busy else None,
          "stem_kernels": stem_kernels, "stem_by_group_ms": stem_groups,
          "top_kernels_auto_pass": top})
    check(stem_busy > 0, "hybrid stem: no device time")
    cases = vit_b16_kernel_cases(gen, 321, "hybrid")
    return {"f32": f32, **served, "grad_launches": grad_launches,
            "stem_device_busy_ms": stem_busy, "cases": cases}


# --- the `vit_h` phase: ViT-H's widths at full width and depth --------------
# ViT-Huge (Dosovitskiy et al., "An Image is Worth 16x16 Words", ICLR 2021,
# Table 1): 32 layers, hidden 1,280, MLP 5,120, 16 heads (head_dim 80), the
# widths and depth that K1 (D above 1,024) and K4 (head_dim 80) took no
# body for before.  A 14-voxel patch does not tile 128, so the patch is the
# stretch model's (16, 16, 16) on 128^3 volumes (`vit_b16_128cubed`): 512
# patches and CLS, 513 tokens; the only change from the published model.
VIT_H = dict(hidden_size=1280, mlp_dim=5120, num_heads=16, num_layers=32)
VIT_H_TOKENS = 513


def phase_vit_h(gen) -> dict:
    """The ViT-H-width model on seeded weights: f32 at B=1 under `auto`
    against the plain modules (`f32_against_plain`, the stretch phase's f32
    gate), bf16 at B = STRETCH_B under `auto` (K4 at head_dim 80, K1's wide
    body at D 1,280) and `layer` (K3 on K4's body), STRETCH_ITERS passes x
    REPEATS (`serve_vit_b16`), launches exact; then K1, K4 and K3 at its
    shapes against their plain versions, timed with bounds and library
    times (`vit_b16_kernel_cases`)."""
    cfg = ViTConfig(patch_size=(16, 16, 16), img_size=128, z_size=128, **VIT_H)
    t0 = time.perf_counter()
    model = VisionTransformer3D(cfg, zero_head=False, vis=False,
                                generator=torch.Generator().manual_seed(SEED))
    model.eval()
    init_s = time.perf_counter() - t0
    params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        emb = model.transformer.embeddings
        emb.position_embeddings.normal_(0.0, 0.02, generator=gen)
        emb.cls_token.normal_(0.0, 0.02, generator=gen)
    x = torch.randn(STRETCH_B, 128, 128, 128, 1, generator=gen, device="cuda")
    ok = cfg.seq_len == VIT_H_TOKENS and cfg.hidden_size // cfg.num_heads == 80
    emit({"phase": "vit_h_model", "source": "Dosovitskiy et al., ICLR 2021, "
          "Table 1, ViT-Huge; patch (16, 16, 16) on 128^3 in place of 14^2",
          **VIT_H, "head_dim": cfg.hidden_size // cfg.num_heads,
          "patch_size": list(cfg.patch_size), "tokens": cfg.seq_len,
          "parameters": params, "init_s": init_s, "ok": ok})
    check(ok, f"vit_h config {cfg}")
    expect = vit_b16_expect(cfg.num_layers)
    f32 = f32_against_plain("vit_h", model, x[:1], expect["auto"])
    served = serve_vit_b16("vit_h", model, x, expect)
    # the same model under K1b and K1c (their wide bodies at D 1,280)
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        set_impls("plain")
        try:
            ref = model(xb)
        finally:
            set_impls("auto")
    served.update(variant_passes("vit_h", model, xb, ref, cfg.num_layers))
    del model, xb, ref
    cases = vit_b16_kernel_cases(gen, VIT_H_TOKENS, "vit_h", VIT_H)
    return {"f32": f32, **served, "cases": cases, "parameters": params}


# --- the `widest` phase: a gate model above the published widths -----------
# No published ViT has a hidden size above 8,192 or a head_dim above 256,
# so this model is a gate, as phase `widths` is, and no published
# configuration: hidden size 12,288 in 24 heads of 512 (K4's sliced bodies,
# K3's core on them) and MLP 49,152 (K1's, K1b's and K1c's wide bodies
# above 8,192), 2 layers, (16, 16, 16) patches on 128^3 volumes (513
# tokens), seeded weights: 3.6e9 parameters in its layers, 7.2 GB in bf16.
WIDEST_WIDTHS = dict(hidden_size=12288, mlp_dim=49152, num_heads=24, num_layers=2)
WIDEST_TOKENS = 513
WIDEST_B = 2


def phase_widest(gen) -> dict:
    """The widest model, made on the card from a seeded CUDA generator (the
    model's own inits, `reset_parameters`): f32 at B=1 under `auto` (K4's
    sliced f32 body at head_dim 512, K1's wide f32 body at D 12,288) and
    `layer` (K3 on K4's sliced body) against the plain modules
    (`f32_against_plain`), bf16 at B = WIDEST_B under `auto` and `layer`
    (`serve_vit_b16`: launches exact, tokens against the plain modules'
    within TOKENS_BF16_ATOL, ms a batch, device busy ms, kernels, idle
    share) and under K1b and K1c (`variant_passes`); then K1, K4 and K3 at
    its shapes against their plain versions, with device times, bounds,
    the library's times and SDPA's backend (`widest_kernel_cases`)."""
    cfg = ViTConfig(patch_size=(16, 16, 16), img_size=128, z_size=128, **WIDEST_WIDTHS)
    t0 = time.perf_counter()
    # every tensor made on the meta device (no host init of 3.6e9 values),
    # then storage on the card and the model's own inits there
    with torch.device("meta"):
        model = VisionTransformer3D(cfg, zero_head=False, vis=False, device="meta")
    model.to_empty(device="cuda")
    model.reset_parameters(False, torch.Generator(device="cuda").manual_seed(SEED + 12))
    model.eval()
    with torch.no_grad():
        emb = model.transformer.embeddings
        emb.position_embeddings.normal_(0.0, 0.02, generator=gen)
        emb.cls_token.normal_(0.0, 0.02, generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = sum(p.numel() for p in model.parameters())
    layer_params = sum(p.numel() for p in model.transformer.encoder.layer.parameters())
    x = torch.randn(WIDEST_B, 128, 128, 128, 1, generator=gen, device="cuda")
    hd = cfg.hidden_size // cfg.num_heads
    ok = (cfg.seq_len == WIDEST_TOKENS and hd == 512 and not list(model.buffers())
          and fused_attention.k4_slices(hd) == 2)
    emit({"phase": "widest_model", "source": "a gate model: no published "
          "configuration has these widths", **WIDEST_WIDTHS, "head_dim": hd,
          "patch_size": list(cfg.patch_size), "tokens": cfg.seq_len,
          "parameters": params, "layer_parameters": layer_params,
          "bytes_bf16": 2 * params, "init_s": init_s, "ok": ok})
    check(ok, f"widest config {cfg}")
    L = cfg.num_layers
    expect = vit_b16_expect(L)
    with torch.no_grad():
        set_impls("plain")
        try:
            ref = model(x[:1])
        finally:
            set_impls("auto")
    f32 = {impl: f32_against_plain("widest", model, x[:1], expect[impl], impl, ref)
           for impl in ("auto", "layer")}
    del ref
    served = serve_vit_b16("widest", model, x, expect)
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        set_impls("plain")
        try:
            ref = model(xb)
        finally:
            set_impls("auto")
    served.update(variant_passes("widest", model, xb, ref, L))
    del model, xb, ref
    torch.cuda.empty_cache()
    cases = widest_kernel_cases(gen)
    return {"f32": f32["auto"], "f32_layer": f32["layer"], **served, "cases": cases,
            "parameters": params}


def widest_kernel_cases(gen) -> dict:
    """K1's wide bodies, K4's sliced bodies and K3 on them against their
    plain versions at the widest model's shapes: bf16 at B = WIDEST_B, f32 at
    B = 1; each with its device time, bound and library time (the F.linear
    -> F.gelu -> F.linear chain; SDPA, its backend named)."""
    D, M, H = (WIDEST_WIDTHS[k] for k in ("hidden_size", "mlp_dim", "num_heads"))
    cases = {"K1": [], "K4": [], "K3": []}
    for dtype, nb in ((torch.bfloat16, WIDEST_B), (torch.float32, 1)):
        case = k1_case(gen, dtype, nb * WIDEST_TOKENS, D, M, M, "widest", device=True)
        want = "wide_wgmma" if dtype == torch.bfloat16 else "wide_tf32x3"
        check(case["body"] == want, f"K1 widest body {case['body']}, not {want}")
        cases["K1"].append(case)
        cases["K4"].append(k4_case(gen, dtype, (nb, H, WIDEST_TOKENS, D // H), "model",
                                   True))
    cases["K3"].append(k3_case(gen, torch.bfloat16, (WIDEST_B, WIDEST_TOKENS, D, H), True))
    return cases


# --- the `wide_axis` phase: five stacked members of the stretch model -------
# The five CV folds of one `vit_b16_128cubed` config evaluated as one stacked
# forward (`sweep/stacked.stacked_forward`, the sweep engine's vmapped model),
# with the masked widths and depths the sweep's padded templates give its
# members: each member's MLP width and its layers.
WIDE_AXIS_MLP = (3072, 3072, 2048, 1000, 3072)
WIDE_AXIS_LAYERS = (12, 12, 12, 8, 12)
# passes of a timed run (host clock), and of a variant's run on one model
WIDE_AXIS_ITERS = 10
VARIANT_PASS_ITERS = 3


def stacked_members(model, gen) -> dict:
    """The stacked parameters (P, ...) of len(WIDE_AXIS_MLP) members on the
    card, in f32: member 0 is `model`, each other one its tensors plus noise
    of 5 % of their mean magnitude; the MLP weights and biases past a
    member's width are zero, as in the sweep's padded templates."""
    P = len(WIDE_AXIS_MLP)
    params = {}
    for k, v in model.state_dict().items():
        v = v.detach().to("cuda", torch.float32)
        noise = torch.randn((P - 1,) + tuple(v.shape), generator=gen, device="cuda")
        params[k] = torch.cat([v[None], v + noise * (0.05 * v.abs().mean())]).contiguous()
    for i in range(model.config.num_layers):
        pre = f"transformer.encoder.layer.{i}.ffn"
        for p, width in enumerate(WIDE_AXIS_MLP):
            params[f"{pre}.fc1.weight"][p, width:] = 0
            params[f"{pre}.fc1.bias"][p, width:] = 0
            params[f"{pre}.fc2.weight"][p, :, width:] = 0
    return params


def phase_wide_axis(gen) -> dict:
    """Five stacked members of `vit_b16_128cubed` at full width and depth
    (D 768, MLP 3,072, 12 layers of 12 heads of 64, 513 tokens), widths
    WIDE_AXIS_MLP and depths WIDE_AXIS_LAYERS, through
    `stacked_forward`: in f32 at B=1 a member and in bf16 at B=8 a member
    (20,520 token rows a fused-FFN call), each against the same stacked
    forward on the plain modules (f32: TOKENS_F32_ATOL, the stretch phase's
    f32 gate; bf16: TOKENS_BF16_ATOL) under each fused-FFN variant in turn,
    so K1, K1b and K1c run their wide bodies with the model axis at D 768:
    launches exact (one fused-FFN and one K4 launch a layer), a pass's wall
    ms (WIDE_AXIS_ITERS passes by the host clock), its device busy ms,
    kernels and idle share."""
    cfg = vit_b16_128cubed()
    model = VisionTransformer3D(cfg, zero_head=False, vis=False,
                                generator=torch.Generator().manual_seed(SEED + 11))
    with torch.no_grad():
        emb = model.transformer.embeddings
        emb.position_embeddings.normal_(0.0, 0.02, generator=gen)
        emb.cls_token.normal_(0.0, 0.02, generator=gen)
        params = stacked_members(model, gen)
    del model
    P, L = len(WIDE_AXIS_MLP), cfg.num_layers
    mlp = torch.tensor(WIDE_AXIS_MLP, dtype=torch.int32, device="cuda")
    layers = torch.tensor(WIDE_AXIS_LAYERS, dtype=torch.int32, device="cuda")
    emit({"phase": "wide_axis_model", "config": "vit_b16_128cubed", "members": P,
          "mlp_active": list(WIDE_AXIS_MLP), "layers_active": list(WIDE_AXIS_LAYERS),
          "parameters": int(sum(v.numel() for v in params.values())),
          "bytes_f32": int(sum(v.numel() * 4 for v in params.values()))})
    result = {}
    for dtype, B in ((torch.float32, 1), (torch.bfloat16, STRETCH_B)):
        name = str(dtype).split(".")[1]
        stacked = {k: v.to(dtype) for k, v in params.items()}
        x = torch.randn(P, B, cfg.img_size, cfg.img_size, cfg.z_size, 1, generator=gen,
                        device="cuda").to(dtype)

        def run():
            return stacked_module.stacked_forward(stacked, cfg, x, layers_active=layers,
                                                  mlp_active=mlp)

        with torch.no_grad():
            set_impls("plain")
            try:
                ref = run()
            finally:
                set_impls("auto")
            for variant, kernel in VARIANT_KERNELS.items():
                with mlp_variant(variant):
                    run()                       # warm-up
                    reset_launches()
                    out = run()
                    counts = launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(WIDE_AXIS_ITERS):
                        run()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) / WIDE_AXIS_ITERS * 1e3
                    busy, groups, kernels, by_group = device_time(run)
                    body = {"seq": fused_mlp.k1_body_launched,
                            "chunked": fused_mlp.k1b_body_launched,
                            "pipelined2": fused_mlp.k1c_body_launched}[variant]()
                want = counts_of(K4=L, **(k1_split(L, dtype, cfg.hidden_size)
                                          if kernel == "K1" else {kernel: L}))
                err = float((out.float() - ref.float()).abs().max())
                atol = TOKENS_F32_ATOL if dtype == torch.float32 else TOKENS_BF16_ATOL
                finite = bool(torch.isfinite(out).all())
                shape_ok = tuple(out.shape) == (P, B, cfg.num_classes)
                mlp_ms = sum(groups.get(g, 0.0) for g in MLP_GROUPS)
                ok = (err <= atol and finite and shape_ok and counts == want
                      and busy > 0 and body.startswith("wide_"))
                more = {}
                if variant == "pipelined2":
                    # K1c's queue at the pass's fused-FFN call, and its FFN
                    # time beside K1's in the same pass
                    queue = k1c_wide_plan(B * cfg.seq_len, cfg.hidden_size, cfg.mlp_dim, P,
                                          dtype)
                    more = {"queue": {k: queue[k] for k in ("lead", "tickets", "resident",
                                                            "blocks")},
                            "k1_mlp_device_ms": result[f"{name}_seq"]["mlp_device_ms"]}
                res = {"phase": "wide_axis", "card": card, "variant": variant,
                       "kernel": kernel, "body": body, "dtype": name, "models": P,
                       "B": B, "token_rows_a_call": B * cfg.seq_len,
                       "logits_max_abs_err": err, "atol": atol, "finite": finite,
                       "shape_ok": shape_ok, "launches": counts,
                       "expected_launches": want, "wall_ms": wall,
                       "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
                       "mlp_device_ms": mlp_ms, **more, "kernels": kernels,
                       "by_group_ms": groups, "kernels_by_group": by_group, "ok": ok}
                emit(res)
                check(ok, f"wide_axis {name} {variant}: err {err}, launched {counts} "
                          f"of {want}, body {body}, busy {busy}")
                result[f"{name}_{variant}"] = res
        del stacked, x
    return result


def variant_passes(name: str, model, x, ref, layers: int) -> dict:
    """The bf16 model at B = x.shape[0] under K1b and K1c in turn (`auto`
    attention, so K4 a layer): VARIANT_PASS_ITERS passes by the host clock
    after a warm-up, launches exact (one fused-FFN launch a layer, on its
    wide body), tokens against the plain modules' (`ref`) within
    TOKENS_BF16_ATOL, and one traced pass's device busy ms."""
    result = {}
    with torch.no_grad():
        for variant in ("chunked", "pipelined2"):
            kernel = VARIANT_KERNELS[variant]
            with mlp_variant(variant):
                model(x)
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(VARIANT_PASS_ITERS):
                    out = model(x)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / VARIANT_PASS_ITERS * 1e3
                counts = launches()
                busy, groups, kernels, _ = device_time(lambda: model(x))
                body = (fused_mlp.k1b_body_launched() if variant == "chunked"
                        else fused_mlp.k1c_body_launched())
            n = layers * VARIANT_PASS_ITERS
            want = counts_of(K4=n, **{kernel: n})
            err = float((out.tokens.float() - ref.tokens.float()).abs().max())
            finite = bool(torch.isfinite(out.tokens).all())
            ok = (counts == want and err <= TOKENS_BF16_ATOL and finite and busy > 0
                  and body == fused_mlp._variant_body(variant, x.dtype,
                                                      model.config.hidden_size))
            res = {"phase": f"{name}_variants", "card": card, "variant": variant,
                   "kernel": kernel, "body": body, "dtype": "bfloat16",
                   "B": x.shape[0], "iters": VARIANT_PASS_ITERS, "launches": counts,
                   "expected_launches": want, "tokens_max_abs_err": err,
                   "atol": TOKENS_BF16_ATOL, "finite": finite, "ms_per_batch": wall,
                   "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
                   "kernels": kernels, "by_group_ms": groups, "ok": ok}
            emit(res)
            check(ok, f"{name} under {variant}: err {err}, launched {counts} of {want}")
            result[variant] = res
    return result


# The width sweep (phase `widths`), gates only: K1 at hidden sizes between
# and beyond the bodies' (M = 4 D, but 2,048 at D = 8,192, the one case cut;
# a width mask below M), at 65 and 513 rows, 1,290 a wide D that 8 does not
# divide (its operands zero-padded), and above 8,192: 8,200, the `widest`
# model's 12,288 and 16,384 (M 65,536); K4 and K3 at head dims from 20 to
# 1,024 at 65 and 513 tokens, each body of `fused_attention.K4_BODY_HDS`
# but 64 and 128 (phases K4, K3 and stretch) padded from below, 80 and 256
# exact, and above 256 the sliced bodies (264: a second slice of 8
# columns; 288, 384, 512, 1,024), on contiguous tensors and on the model's
# views (K3: the views of its (B, T, 3D) QKV buffer and contiguous (B, T,
# D) tensors), two volumes of three heads.
WIDTH_SWEEP_D = (24, 48, 96, 200, 1288, 1290, 2048, 8192, 8200, 12288, 16384)
WIDTH_SWEEP_ROWS = (65, 513)
WIDTH_SWEEP_HD = (20, 24, 48, 72, 80, 96, 160, 200, 256, 264, 288, 384, 512, 1024)
WIDTH_SWEEP_S = (65, 513)


def sweep_gate(out, ref, dtype, tol, dropped=None) -> dict:
    """One sweep case against its plain version: its largest error, its
    error over the gate, and whether the gate rejects the plain version
    without the last key (attention)."""
    err, ok, atol, rtol = compare(out, ref, dtype, tol)
    res = {"max_abs_err": err, "max_err_over_gate": over_gate(out, ref, (atol, rtol))[1],
           "ok": ok}
    if dropped is not None:
        res["gate_rejects_dropped_key"] = not compare(dropped, ref, dtype, tol)[1]
        res["ok"] = ok and res["gate_rejects_dropped_key"]
    return res


def width_sweep_case(gen, variant: str, x, weights, active) -> dict:
    """One K1 (with `active` a list: stacked over len(active) models, the
    second model's weights drawn here), K1b or K1c call of the width sweep,
    its launch and body held exactly, against its plain version at the JAX
    tolerances."""
    w1, b1, w2, b2 = weights
    D, M = x.shape[-1], w1.shape[0]
    if isinstance(active, list):
        more = mlp_weights(gen, x.dtype, D, M, (len(active) - 1,))
        w1, b1, w2, b2 = (torch.cat([t[None], m]) for t, m in zip(weights, more))
        x = torch.stack([x] + [torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
                               for _ in active[1:]])
        active = torch.tensor(active, dtype=torch.int32, device="cuda")
    kernel = VARIANT_KERNELS[variant]
    plain = fused_mlp._plain_mlp_chunked if variant == "chunked" else fused_mlp._plain_mlp
    with mlp_variant(variant):
        before = launches()
        out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, active)
        counts = {k: n - before[k] for k, n in launches().items()}
    body = {"seq": fused_mlp.k1_body_launched, "chunked": fused_mlp.k1b_body_launched,
            "pipelined2": fused_mlp.k1c_body_launched}[variant]()
    want = (counts_of(**k1_split(1, x.dtype, D)) if kernel == "K1"
            else counts_of(**{kernel: 1}))
    res = sweep_gate(out, plain(x, w1, b1, w2, b2, active), x.dtype, None)
    res["ok"] = (res["ok"] and counts == want
                 and body == fused_mlp._variant_body(variant, x.dtype, D))
    models = w1.shape[0] if w1.dim() == 3 else 0
    return {"dtype": str(x.dtype).split(".")[1], "N": x.shape[-2], "D": D, "M": M,
            "active": active.tolist() if models else active, "models": models,
            "body": body, **res}


def phase_widths(gen) -> dict:
    """K1, K1b, K1c, K4 and K3 over the widths of `WIDTH_SWEEP_*`, each
    launch counted (one launch a call, on the body the wrapper names) and
    held to its plain version: K1 (alone, and with a model axis of two
    models), K1b and K1c at the JAX tolerances, K4 and K3 at K4's gate in bf16 on a
    context of rms 1 (`model_views`) with the dropped-key check, f32 at
    the JAX tolerance.  Prints one line a kernel and fails on any case."""
    cases = {"K1": [], "K1b": [], "K1c": [], "K4": [], "K3": []}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            for D in WIDTH_SWEEP_D:
                M = 2048 if D == 8192 else 4 * D
                active = M - M // 8
                w1, b1, w2, b2 = mlp_weights(gen, dtype, D, M)
                for N in WIDTH_SWEEP_ROWS:
                    x = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
                    for variant, kernel in VARIANT_KERNELS.items():
                        cases[kernel].append(width_sweep_case(
                            gen, variant, x, (w1, b1, w2, b2), active))
                    cases["K1"].append(width_sweep_case(
                        gen, "seq", x, (w1, b1, w2, b2), [active, M // 2]))
            tol = K4_BF16_TOL if dtype == torch.bfloat16 else None
            for hd in WIDTH_SWEEP_HD:
                for S in WIDTH_SWEEP_S:
                    for views in ("model", "contiguous"):
                        q, k, v = model_views(gen, (2, 3, S, hd), dtype)
                        if views == "contiguous":
                            q, k, v = (t.contiguous() for t in (q, k, v))
                        before = launches()
                        out = fused_attention.fused_attention(q, k, v)
                        counts = {k_: n - before[k_] for k_, n in launches().items()}
                        body = fused_attention.k4_body_launched()
                        res = sweep_gate(out, fused_attention._plain_attention_k4(q, k, v),
                                         dtype, tol, without_last_key(q, k, v))
                        res["ok"] = (res["ok"] and counts == counts_of(K4=1)
                                     and body.startswith(k4_body_of(dtype, hd)))
                        cases["K4"].append({"dtype": name, "B": 2, "H": 3, "S": S,
                                            "hd": hd, "views": views, "body": body,
                                            "body_hd": fused_attention.k4_body_hd(hd),
                                            **res})
                    for views in ("qkv", "contiguous"):
                        H = 3
                        qkv = torch.randn(2, S, 3 * H * hd, generator=gen, device="cuda")
                        qkv[..., 2 * H * hd:] *= math.sqrt(S / math.e)
                        q, k, v = attention_layer._split(qkv.to(dtype))
                        if views == "contiguous":
                            q, k, v = (t.contiguous() for t in (q, k, v))
                        before = launches()
                        out = attention_layer.attention_core(q, k, v, H)
                        counts = {k_: n - before[k_] for k_, n in launches().items()}
                        body = fused_attention.k4_body_launched()
                        ref = attention_layer._plain_attention_core(q, k, v, H)
                        short = attention_layer._plain_attention_core(q, k[:, :-1], v[:, :-1], H)
                        res = sweep_gate(out, ref, dtype, tol, short)
                        res["ok"] = (res["ok"] and counts == counts_of(K3=1, K3_on_K4=1)
                                     and body.startswith(k4_body_of(dtype, hd)))
                        cases["K3"].append({"dtype": name, "B": 2, "T": S, "H": H,
                                            "hd": hd, "views": views, "body": body, **res})
    result = {}
    for kernel, rows in cases.items():
        bad = [c for c in rows if not c["ok"]]
        summary = {"phase": "widths", "kernel": kernel, "cases": len(rows),
                   "failed": len(bad),
                   "max_err_over_gate": max(c["max_err_over_gate"] for c in rows),
                   "bodies": sorted({c["body"] for c in rows}), "rows": rows,
                   "ok": not bad}
        emit(summary)
        check(not bad, f"widths {kernel}: {len(bad)} cases off their gate: {bad[:4]}")
        result[kernel] = {k: v for k, v in summary.items() if k not in ("phase", "rows")}
    return result


# --- the `quant` phase: the int8 route (`ops/quant.py`) on the card ---------
# int8_dense, card against the CPU on the same inputs, at the products the
# models give it at B=8: conf 9's fused QKV (65 tokens, D 16 -> 48) and a
# (64, 3,072) FFN both ways; conf 20's and 19's FFN at mlp_dim 2,204 (257
# tokens, D 8 and 16), whose N (fc1) and K (fc2) are padded to multiples
# of 8; the stretch model's projections and FFN (513 tokens, D 768) in
# bf16.  The int32 sums are exact and every float step is the same IEEE
# operation, so the two should be equal; the gate is 1e-6 of the largest.
QUANT_SHAPES = ((65 * 8, 16, 48, torch.float32), (65 * 8, 64, 3072, torch.float32),
                (65 * 8, 3072, 64, torch.float32), (257 * 8, 8, 2204, torch.float32),
                (257 * 8, 2204, 8, torch.float32), (257 * 8, 16, 2204, torch.float32),
                (257 * 8, 2204, 16, torch.float32),
                (513 * 8, 768, 768, torch.bfloat16), (513 * 8, 768, 3072, torch.bfloat16),
                (513 * 8, 3072, 768, torch.bfloat16))
QUANT_RTOL = 1e-6
QUANT_ITERS = 20
# int8 logits against exact ones (`tests/test_quant.py:75`), conf 9 and 19
# in f32 at B=8
QUANT_LOGIT_DEV = 0.15
QUANT_B = 8
# int8 products a layer: the fused QKV or three projections, the out
# projection, and under `int8` fc1 and fc2
QUANT_PRODUCTS = {"int8": {"fused": 4, "separate": 6},
                  "int8_attn": {"fused": 2, "separate": 4}}
QUANT_TURNS = ("none", "int8_attn", "int8", "int8", "int8_attn", "none")


@contextlib.contextmanager
def quant_impl(impl: str):
    quant.set_default_quant_impl(impl)
    try:
        yield
    finally:
        quant.set_default_quant_impl("none")


def quant_launches(impl: str, cfg, passes: int = 1) -> dict:
    """A forward's kernel launches under `impl`: K2 (head_dim <= 16) or K4
    a layer, K1 a layer unless `int8` takes the FFN; f32 and the stretch
    model's D 768 take K1's own bodies."""
    L = cfg.num_layers * passes
    attend = {"K2": L} if cfg.hidden_size // cfg.num_heads <= 16 else {"K4": L}
    ffn = {} if impl == "int8" else {"K1": L, "K1_own": L}
    return counts_of(**attend, **ffn)


def quant_products(impl: str, cfg, passes: int = 1) -> int:
    if impl == "none":
        return 0
    kind = "fused" if cfg.hidden_size <= 64 else "separate"
    return QUANT_PRODUCTS[impl][kind] * cfg.num_layers * passes


def phase_quant(gen) -> dict:
    """The int8 route on the card: `int8_dense` against the CPU's at
    QUANT_SHAPES (with its ms, `torch._int_mm`'s alone and the product in
    the input's type); conf 9 and 19 in f32 at B=8 under `int8` and
    `int8_attn` against the exact forward; and the stretch model in bf16
    at B=8 under `none`, `int8_attn` and `int8` in turns: ms a batch,
    device time, launches and the logits' deviation from `none`."""
    out = {"dense": [], "models": {}, "stretch": {}}
    for M, K, N, dtype in QUANT_SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)).to(dtype)
        b = (torch.randn(N, generator=gen, device="cuda") * 0.01).to(dtype)
        before = quant.int8_products
        got = quant.int8_dense(x, w, b)
        products = quant.int8_products - before
        ref = quant.int8_dense(x.cpu(), w.cpu(), b.cpu())
        err = float((got.cpu().float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        exact = torch.addmm(b.float(), x.float(), w.float())
        xq, _ = quant.quantize_rowwise(x)
        wq, _ = quant.quantize_colwise(w)
        ok = err <= QUANT_RTOL * scale and products == 1 and got.dtype == dtype
        line = {"phase": "quant_dense", "card": card, "M": M, "K": K, "N": N,
                "dtype": str(dtype).split(".")[-1], "padded": bool(K % 8 or N % 8),
                "max_abs_err_vs_cpu": err, "max_abs": scale, "rtol": QUANT_RTOL,
                "int8_max_abs_dev_vs_exact": float((got.float() - exact).abs().max()),
                "ms": time_ms(lambda: quant.int8_dense(x, w, b), QUANT_ITERS),
                "int_mm_ms": time_ms(lambda: quant.int_mm_padded(xq, wq), QUANT_ITERS),
                "library_ms": time_ms(lambda: torch.addmm(b, x, w), QUANT_ITERS),
                "ok": ok}
        emit(line)
        check(ok, f"quant: int8_dense on the card against the CPU: {line}")
        out["dense"].append(line)

    with torch.no_grad():
        for conf in (9, 19):
            cfg = ViTConfig.from_conf(conf)
            model = VisionTransformer3D(cfg, zero_head=False, vis=False,
                                        generator=torch.Generator().manual_seed(SEED + conf))
            x = torch.randn(QUANT_B, 128, 128, 5, 1, generator=gen, device="cuda")
            exact = model(x).logits
            for impl in ("int8", "int8_attn"):
                with quant_impl(impl):
                    reset_launches()
                    before = quant.int8_products
                    got = model(x).logits
                    counts = launches()
                    products = quant.int8_products - before
                dev = float((got - exact).abs().max())
                finite = bool(torch.isfinite(got).all())
                want = quant_launches(impl, cfg)
                ok = (finite and 0.0 < dev < QUANT_LOGIT_DEV and counts == want
                      and products == quant_products(impl, cfg))
                line = {"phase": "quant_model", "card": card, "conf": conf,
                        "impl": impl, "dtype": "float32", "B": QUANT_B,
                        "logits_max_abs_dev_vs_exact": dev, "bound": QUANT_LOGIT_DEV,
                        "finite": finite, "launches": counts, "expected_launches": want,
                        "int8_products": products, "ok": ok}
                emit(line)
                check(ok, f"quant: conf {conf} under {impl}: {line}")
                out["models"][f"conf{conf}_{impl}"] = dev

        cfg = vit_b16_128cubed()
        model = VisionTransformer3D(cfg, zero_head=False, vis=False,
                                    generator=torch.Generator().manual_seed(SEED))
        emb = model.transformer.embeddings
        emb.position_embeddings.normal_(0.0, 0.02, generator=gen)
        emb.cls_token.normal_(0.0, 0.02, generator=gen)
        model.to(torch.bfloat16)
        x = torch.randn(STRETCH_B, 128, 128, 128, 1, generator=gen,
                        device="cuda").to(torch.bfloat16)
        logits, turns = {}, {impl: [] for impl in QUANT_TURNS}
        for impl in QUANT_TURNS:
            with quant_impl(impl):
                model(x)                        # warm-up
                turns[impl].append(time_ms(lambda: model(x), STRETCH_ITERS))
                if impl in logits:
                    continue
                reset_launches()
                before = quant.int8_products
                logits[impl] = model(x).logits.float()
                counts = launches()
                products = quant.int8_products - before
                busy, groups, kernels, _ = device_time(lambda: model(x))
            want = quant_launches(impl, cfg)
            out["stretch"][impl] = {"launches": counts, "expected_launches": want,
                                    "int8_products": products,
                                    "expected_int8_products": quant_products(impl, cfg),
                                    "device_busy_ms": busy, "kernels": kernels,
                                    "by_group_ms": groups}
        for impl, res in out["stretch"].items():
            dev = float((logits[impl] - logits["none"]).abs().max())
            finite = bool(torch.isfinite(logits[impl]).all())
            ms = statistics.median(turns[impl])
            ok = (finite and res["launches"] == res["expected_launches"]
                  and res["int8_products"] == res["expected_int8_products"]
                  and res["device_busy_ms"] > 0 and (impl == "none") == (dev == 0.0))
            res.update(ms_per_batch=ms, ms_per_batch_turns=turns[impl],
                       volumes_per_s=STRETCH_B / ms * 1e3,
                       device_idle_share=1.0 - res["device_busy_ms"] / ms,
                       logits_max_abs_dev_vs_none=dev,
                       logits_max_abs=float(logits["none"].abs().max()), finite=finite)
            emit({"phase": "quant_stretch", "card": card, "config": "vit_b16_128cubed",
                  "dtype": "bfloat16", "B": STRETCH_B, "impl": impl, **res, "ok": ok})
            check(ok, f"quant: stretch under {impl}: {res}")
    return out


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


# The wide model-axis cases of K1, K1b and K1c (phases `model_axis` and
# `mlp_variants`): (N, D, M, the models of its cases): the stretch model's
# (D, M) at B=8's and B=1's token rows with P = 1 and 5 models, and ViT-H's
# with P = 2; widths full, partial (M - 1,000) and 0 (`wide_case_widths`).
WIDE_CASE_SHAPES = ((STRETCH_B * 513, 768, 3072, (1, 5)), (513, 768, 3072, (1, 5)),
                    (STRETCH_B * 513, 1280, 5120, (2,)), (513, 1280, 5120, (2,)))


def wide_case_widths(M: int, models: int) -> list:
    """The width lists (one width a model) of the wide cases of `models`
    models at hidden size M."""
    return {1: [[M], [M - 1000], [0]], 2: [[M, M - 1000]],
            5: [[M, M, M - 1000, M - 1000, 0]]}[models]


#: the library chain's device ms a call, by wide case inputs: the same for
#: every variant
_chain_device_ms: dict = {}
#: K1's device ms a call, by wide case inputs (`wide_cases("seq")` runs
#: before K1c's), beside which K1c's cases print theirs
_k1_device_ms: dict = {}


def wide_case(dtype, N: int, D: int, M: int, widths: list, variant: str) -> dict:
    """A wide fused-FFN kernel (K1's, K1b's or K1c's wide body) with the
    model axis (P = len(widths), one width a model as a device tensor)
    against its plain version, on inputs drawn from a generator seeded by
    the case (so every variant sees the same): its error over the JAX gate,
    whether each model's slice equals that model alone (no model axis, a
    host width) bit for bit, for K1c whether it equals K1 bit for bit (K1's
    f32 plan splits K at some shapes, then their sums differ in order), K1's
    device ms on the same inputs and its queue's plan (lead, tickets,
    resident blocks), its ms (events) and device ms (profiler) beside the
    library chain's
    (`baddbmm` -> `F.gelu` -> `baddbmm`, the width mask folded into w2) and
    the bound: the products at the type's tensor-core peak (3xTF32 for
    f32), the bytes, the GELUs."""
    P = len(widths)
    key = (str(dtype), N, D, M, tuple(widths))
    own = torch.Generator(device="cuda").manual_seed(zlib.crc32(repr(key).encode()))
    x = torch.randn(P, N, D, generator=own, device="cuda").to(dtype)
    w1, b1, w2, b2 = mlp_weights(own, dtype, D, M, (P,))
    wt = torch.tensor(widths, dtype=torch.int32, device="cuda")
    plain = (fused_mlp._plain_mlp_chunked if variant == "chunked"
             else fused_mlp._plain_mlp)
    kernel = VARIANT_KERNELS[variant]

    def call(v=variant):
        with mlp_variant(v):
            return fused_mlp.fused_mlp(x, w1, b1, w2, b2, wt)

    with torch.no_grad():
        before = launches()[kernel]
        out = call()
        launched = launches()[kernel] - before
        body = {"seq": fused_mlp.k1_body_launched, "chunked": fused_mlp.k1b_body_launched,
                "pipelined2": fused_mlp.k1c_body_launched}[variant]()
        with mlp_variant(variant):
            alone = all(torch.equal(fused_mlp.fused_mlp(
                x[p], w1[p], b1[p], w2[p], b2[p], widths[p]), out[p]) for p in range(P))
        ref = plain(x, w1, b1, w2, b2, wt)
        err, ok, atol, rtol = compare(out, ref, dtype)
        over_gate_ratio = over_gate(out, ref, (atol, rtol))[1]
        k1 = {}
        if variant == "pipelined2":
            plan = fused_mlp.wide_f32_plan(
                N, D, M, torch.cuda.get_device_properties(0).multi_processor_count)
            splits = dtype == torch.float32 and max(plan["fc1"]["splits"],
                                                    plan["fc2"]["splits"]) > 1
            if key not in _k1_device_ms:
                _k1_device_ms[key] = mlp_device_ms(lambda: call("seq"), 5)
            queue = k1c_wide_plan(N, fused_mlp.kernel_width(D, dtype), M, P, dtype)
            k1 = {"equal_to_k1": bool(torch.equal(out, call("seq"))),
                  "k1_splits_k": splits, "k1_device_ms": _k1_device_ms[key],
                  "queue": {k: queue[k] for k in ("lead", "tickets", "resident", "blocks")}}
        ms = time_ms(call, 10)
        plain_ms = time_ms(lambda: plain(x, w1, b1, w2, b2, wt), 3)
        device_ms = mlp_device_ms(call, 5)
        if variant == "seq":
            _k1_device_ms[key] = device_ms
        w2m = w2 * (torch.arange(M, device="cuda") < wt[:, None, None]).to(dtype)
        b1u, b2u = b1.unsqueeze(1), b2.unsqueeze(1)
        w1t, w2t = w1.transpose(1, 2), w2m.transpose(1, 2)

        def library():
            return torch.baddbmm(b2u, F.gelu(torch.baddbmm(b1u, x, w1t)), w2t)
        library_ms = time_ms(library, 10)
        if key not in _chain_device_ms:
            _chain_device_ms[key] = device_time(
                lambda: [library() for _ in range(5)], host_ops=False)[0] / 5
    live = sum(min(max(w, 0), M) for w in widths)
    elt = x.element_size()
    flops = 4.0 * N * D * live
    nbytes = elt * (2 * P * N * D + 2 * D * live + live + P * D) + 4 * P
    f32 = dtype == torch.float32
    bound_ms, bound_by = bound(3 * flops if f32 else flops, nbytes, dtype,
                               gelus=N * live, peak=PEAK_TF32 if f32 else 0.0)
    case = {"phase": kernel, "card": card, "path": "wide_axis",
            "dtype": str(dtype).split(".")[1], "N": N, "D": D, "M": M,
            "active": widths, "models": P, "body": body, "launched": launched,
            "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": ok,
            "max_err_over_gate": over_gate_ratio, "alone_equal": alone, **k1,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": _chain_device_ms[key],
            "library_gelu": "erf", "bound_ms": bound_ms, "bound_by": bound_by}
    emit(case)
    check(ok and alone and launched == 1 and device_ms > 0
          and (variant != "pipelined2" or k1["equal_to_k1"] or k1["k1_splits_k"]),
          f"{kernel} wide case {case}")
    return case


def wide_cases(variant: str) -> list:
    """`wide_case` at every shape and width list of WIDE_CASE_SHAPES, in bf16
    and f32."""
    return [wide_case(dtype, N, D, M, widths, variant)
            for dtype in (torch.bfloat16, torch.float32)
            for N, D, M, models in WIDE_CASE_SHAPES
            for P in models
            for widths in wide_case_widths(M, P)]


def phase_model_axis(gen) -> tuple:
    """K1 with the model axis against its plain version, in f32 (the
    sweep's type) and bf16 at the narrow sweep shape, then its wide bodies'
    cases (`wide_cases`).  Returns the f32 narrow case and the wide cases."""
    cases = {dtype: k1_case(gen, dtype, MODEL_AXIS_ROWS, 64, 3072,
                            MODEL_AXIS_WIDTHS, "sweep_eval",
                            models=len(MODEL_AXIS_WIDTHS),
                            device=dtype == torch.float32)
             for dtype in (torch.float32, torch.bfloat16)}
    return cases[torch.float32], wide_cases("seq")


def phase_mlp_variants(gen) -> dict:
    """K1b and K1c against their plain versions at K1's narrow serving
    shapes, masked and unmasked, and at the model-axis shape; by device time
    beside the library chain's: both variants' serving cases at (bf16, D=64,
    M=3072) (K1b's with K1's device time on the same inputs), K1b's f32
    serving case at (D=64, M=3072) (its 3xTF32 body) and both variants'
    model-axis cases in f32; then each variant's wide bodies with the model
    axis (`wide_cases`).  Returns each variant's serving case at (bf16,
    D=64, M=3072), its model-axis case in f32 and its wide cases
    (`<variant>_wide`), and K1b's f32 serving case."""
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
                                       device=main or f32_main,
                                       k1_device=main and variant == "chunked")
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
        out[f"{variant}_wide"] = wide_cases(variant)
    return out


# The bf16 bodies at D <= 8 (the D = 8 instance of the wgmma pipeline,
# `csrc/mlp_pipeline.cuh`: K1's and K1c's in `mlp_pipelined.cu`, K1b's in
# `mlp_chunked.cu`) at conf 20's and 22's FFN (D 8, mlp_dim 2,204, 257
# tokens, `configs.py`) at B = 8 and B = 512.
D8_ROWS = (8 * 257, 512 * 257)
D8_M = 2204


def k1_d8_plan(n: int, variant: str) -> dict:
    """`fused_mlp.k1_d8_plan` of one model's call of the variant at D 8 on
    this card (K1b's: `chunked`), less its splits' hidden columns."""
    library = "mlp_chunked" if variant == "chunked" else "mlp_pipelined"
    device = torch.device("cuda", torch.cuda.current_device())
    plan = fused_mlp.k1_d8_plan(n, D8_M, 1, fused_mlp.k1_d8_clusters(device, library),
                                variant == "chunked")
    return {k: v for k, v in plan.items() if k != "bounds"}


def phase_k1_d8(gen) -> dict:
    """K1, K1b and K1c in bf16 at D 8 (the pipeline's D = 8 instance, the
    hidden columns split across a cluster where the row tiles are few)
    against their plain versions at D8_ROWS, each with its device time, the
    bound, the F.linear -> F.gelu -> F.linear chain's device time and its
    plan."""
    out = {}
    for variant in VARIANT_KERNELS:
        out[variant] = []
        for N in D8_ROWS:
            case = k1_case(gen, torch.bfloat16, N, 8, D8_M, D8_M, "d8", variant, device=True)
            case["plan"] = k1_d8_plan(N, variant)
            emit({"phase": "k1_d8_plan", "variant": variant, "N": N, **case["plan"]})
            out[variant].append(case)
    return out


# Conf 22 (`configs.py`: patch 8, 257 tokens, D 8 in eight heads of 1,
# mlp_dim 2,204, 6 layers) served in bf16 under `auto` on seeded weights:
# its FFN on the bf16 D = 8 body, its attention on K2 at head_dim 1.
CONF22 = 22
CONF22_BATCHES = ((8, 20), (512, 5))   # (B, passes a timed run)


def phase_conf22(gen) -> dict:
    """Conf 22's model in bf16 under `auto` at B = 8 and 512: passes timed
    by the host clock (REPEATS runs; ms a batch), launches of the first run
    exact (K1 and K2 once a layer, K1 on K1c's library), the body K1 took,
    tokens against the plain modules within TOKENS_BF16_ATOL, then one
    traced pass: device busy ms, by group, K1's share and the idle share."""
    cfg = ViTConfig.from_conf(CONF22)
    model = (VisionTransformer3D(cfg, zero_head=False, vis=False,
                                 generator=torch.Generator().manual_seed(CONF22))
             .to(torch.bfloat16).eval())
    L = cfg.num_layers
    result = {}
    with torch.no_grad():
        emb = model.transformer.embeddings
        emb.position_embeddings.normal_(0.0, 0.02, generator=gen)
        emb.cls_token.normal_(0.0, 0.02, generator=gen)
        for batch, iters in CONF22_BATCHES:
            x = torch.randn(batch, 128, 128, 5, 1, generator=gen,
                            device="cuda").to(torch.bfloat16)

            def passes() -> float:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    model(x)
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            model(x)                        # warm-up
            reset_launches()
            seconds = passes()
            counts = launches()
            body = fused_mlp.k1_body_launched()
            repeats = [seconds] + [passes() for _ in range(REPEATS - 1)]
            out = model(x)
            busy, groups, kernels, by_group = device_time(lambda: model(x))
            set_impls("plain")
            try:
                ref = model(x)
            finally:
                set_impls("auto")
            want = counts_of(K2=L * iters, **k1_split(L * iters, torch.bfloat16, cfg.hidden_size))
            wall = statistics.median(repeats) / iters * 1e3
            diff = (out.tokens.float() - ref.tokens.float()).abs()
            shape_ok = (tuple(out.tokens.shape) == (batch, cfg.seq_len, cfg.hidden_size)
                        and tuple(out.logits.shape) == (batch, cfg.num_classes))
            finite = bool(torch.isfinite(out.tokens).all() and torch.isfinite(out.logits).all())
            err = float(diff.max())
            ok = (shape_ok and finite and err <= TOKENS_BF16_ATOL and counts == want
                  and body == fused_mlp.K1_BODIES[1] and busy > 0)
            res = {"phase": "conf22", "card": card, "conf": CONF22, "dtype": "bfloat16",
                   "B": batch, "tokens": cfg.seq_len, "D": cfg.hidden_size,
                   "mlp_dim": cfg.mlp_dim, "layers": L, "iters": iters,
                   "ms_per_batch": wall, "ms_per_batch_repeats": [r / iters * 1e3 for r in repeats],
                   "volumes_per_s": batch / wall * 1e3,
                   "launches": counts, "expected_launches": want,
                   "k1_launches_a_pass": counts["K1"] / iters, "k1_body": body,
                   "k1_plan": k1_d8_plan(batch * cfg.seq_len, "seq"),
                   "tokens_max_abs_err": err, "tokens_mean_abs_err": float(diff.mean()),
                   "atol": TOKENS_BF16_ATOL, "shape_ok": shape_ok, "finite": finite,
                   "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
                   "k1_device_ms": groups.get("K1", 0.0),
                   "k1_share_of_busy": groups.get("K1", 0.0) / busy if busy else None,
                   "kernels": kernels, "by_group_ms": groups, "kernels_by_group": by_group,
                   "ok": ok}
            emit(res)
            check(ok, f"conf22 B={batch}: err {err}, shape {shape_ok}, finite {finite}, "
                      f"launched {counts} of {want}, body {body}, busy {busy}")
            result[batch] = res
    return result


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
# The grouped step's launches a dropout site, per-cell streams over one
# generator: at most this many more.
SWEEP_DROPOUT_EXTRA_PER_SITE = 8
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
    result["dropout"] = phase_sweep_dropout(data, hyper)
    return result


def phase_sweep_dropout(data, hyper) -> dict:
    """Kernels of one grouped training step's forward and backward on the
    (16, 16) group (30 cells), with the dropout masks drawn as `run_group`
    drew them before each cell had a stream of its own (one
    `torch.Generator`, one mask a site for the whole stack) and from the
    cells' streams (`attention.CellDropout`, as `run_group` draws them
    now), and the difference a dropout site.  The rest of a step (the loss,
    the optimizer) does not depend on where the masks come from."""
    group = next(g for g in stack.group_configs(BASELINE_CONFS)
                 if g.hidden_size == 16)
    G, F = len(group.confs), data.n_folds
    P, config = G * F, group.template_config()
    params = {k: v.reshape(P, *v.shape[2:]).requires_grad_()
              for k, v in stack.init_group_params(group, F, hyper.seed,
                                                  device="cuda").items()}
    mlp_active = torch.tensor(group.mlp_dims, dtype=torch.int32,
                              device="cuda").repeat_interleave(F)
    layers_active = torch.tensor(group.num_layers, dtype=torch.int32,
                                 device="cuda").repeat_interleave(F)
    pool = torch.as_tensor(data.pool, device="cuda")
    rows = torch.as_tensor(data.row_idx[:, :hyper.train_batch_size], device="cuda",
                           dtype=torch.long)
    volumes = pool[rows] - torch.as_tensor(data.mean, device="cuda").reshape(
        F, 1, 1, 1, 1, 1)

    def step(masks):
        stacked_module.stacked_forward(
            params, config, volumes, layers_active=layers_active,
            mlp_active=mlp_active, deterministic=False, generator=masks).sum().backward()

    sources = {"one_generator": torch.Generator(device="cuda").manual_seed(hyper.seed),
               "cell_streams": attention.CellDropout(hyper.seed, range(P), "cuda")}
    kernels = {}
    for name, masks in sources.items():
        step(masks)                 # the streams' keys and index hashes, once
        kernels[name] = device_time(lambda m=masks: step(m), host_ops=False)[2]
    streams = sources["cell_streams"]
    before = streams.site
    step(streams)
    sites = streams.site - before
    extra = (kernels["cell_streams"] - kernels["one_generator"]) / sites
    line = {"phase": "sweep_dropout", "card": card,
            "group": f"{group.hidden_size}x{group.num_heads}", "cells": P,
            "dropout_sites_per_step": sites,
            "kernels_forward_backward": kernels,
            "extra_kernels_per_site": extra,
            "limit_per_site": SWEEP_DROPOUT_EXTRA_PER_SITE,
            "ok": 0 <= extra <= SWEEP_DROPOUT_EXTRA_PER_SITE}
    emit(line)
    check(line["ok"], f"sweep dropout: {line}")
    return {k: line[k] for k in ("dropout_sites_per_step", "kernels_forward_backward",
                                 "extra_kernels_per_site")}


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
# The ensembles' epochs; the bootstrap runs' replicates (conf 9, in chunks
# of 2 and 4) and combinations (--max_configs 4: confs 1-3); the metrics of
# the two chunkings must agree within the JAX driver's bound
# (`tests/test_cli.py:127`).
CLI_EPOCHS, CLI_BOOT_REPS, CLI_BOOT_MAX_CONFIGS = 2, 4, 4
CLI_BOOT_CHUNK_ATOL = 1e-6
# The ensemble sweeps' padded grid: --max_configs 5 (confs 1-4, four
# combinations in three class signatures) over the 5 folds; its metrics at
# --e2e_chunk 1 and at the auto chunk must agree within the same bound.
CLI_GRID_MAX_CONFIGS = 5
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


def ensemble_layout(out: pathlib.Path, kind: str, confs, tags) -> dict:
    """Every ensemble checkpoint at
    `out/<kind>_models/ensemble_<name>/<tag>.bin` with exactly the names
    and shapes of the `confs` ensemble's state_dict."""
    name = "_".join(str(c) for c in confs)
    want = {k: tuple(v.shape) for k, v in TransformerEnsemble(
        [ViTConfig.from_conf(c) for c in confs], device="cpu").state_dict().items()}
    missing, wrong = [], []
    for tag in tags:
        path = out / f"{kind}_models" / f"ensemble_{name}" / f"{tag}.bin"
        if not path.exists():
            missing.append(str(path.relative_to(out)))
            continue
        got = {k: tuple(v.shape) for k, v in torch.load(
            path, map_location="cpu", weights_only=True).items()}
        if got != want:
            wrong.append(str(path.relative_to(out)))
    return {"files": len(tags), "missing": missing, "wrong_shapes": wrong}


def cli_run(name, driver, argv, steps, k1, k2, *, cells, layout=None, out=None,
            short=None, same_as=None, prep=None, chunks=None, verify=None) -> dict:
    """One run of the `cli` phase: `driver.main(argv)` with --output_dir
    `out` (its name by default), its optimizer steps (grouped steps of the
    sweeps), its exact K1 and K2 launches, `cells(result)` the metric dicts
    that must be finite, `layout(out)` its checkpoints' check, `short` the
    arguments that cut it to the traced run of `cli_idle` (None: no trace),
    `same_as` the run whose result it must return, `prep(out)` what its
    directory needs first, `chunks` the combinations of each chunk its
    padded grid must run, in order (the ensemble grids; no back-off),
    `verify(result, out)` a dict of its own checks, `checks_ok` among them."""
    return dict(name=name, driver=driver, argv=argv, steps=steps, k1=k1, k2=k2,
                cells=cells, layout=layout, out=out, short=short, same_as=same_as,
                prep=prep, chunks=chunks, verify=verify)


@contextlib.contextmanager
def grid_runs(into: list):
    """Record in `into` the `GridResults` of every padded-grid run the two
    ensemble drivers make inside the block: its chunk widths and back-offs."""
    drivers = (train_ensemble_cv, train_ensemble_bootstrap)
    before = [d.run_e2e_grid for d in drivers]

    def run(*args, **kwargs):
        res = e2e_grid.run_e2e_grid(*args, **kwargs)
        into.append(res)
        return res

    for d in drivers:
        d.run_e2e_grid = run
    try:
        yield into
    finally:
        for d, fn in zip(drivers, before):
            d.run_e2e_grid = fn


@contextlib.contextmanager
def all_ensembles_results(into: list):
    """Record in `into` what every `test_cv --all_ensembles` inside the
    block returns: ({combination: {fold: metrics}}, ranking)."""
    before = test_cv.test_all_ensembles

    def run(args):
        res = before(args)
        into.append(res)
        return res

    test_cv.test_all_ensembles = run
    try:
        yield into
    finally:
        test_cv.test_all_ensembles = before


def report_rows(out: pathlib.Path, rows: int) -> dict:
    """`test_cv --all_ensembles`' workbook and CSV under `out`: the CSV one
    row a combination after its header, each cell 'mean (std)' of finite
    numbers."""
    path = out / "Test_All_Ensembles.csv"
    if not path.exists() or not (out / "Test_All_Ensembles.xlsx").exists():
        return {"files": 2, "missing": [path.name], "wrong_shapes": []}
    with open(path, newline="") as f:
        body = list(csv.reader(f))[1:]
    cells = [c for row in body for c in row[1:]]
    finite = all(math.isfinite(float(v)) for c in cells
                 for v in c.replace("(", " ").replace(")", " ").split())
    return {"files": 2, "missing": [], "rows": len(body),
            "wrong_shapes": [] if len(body) == rows and finite and cells
            else [f"{path.name}: {len(body)} rows of {rows}, finite {finite}"]}


def stats_checks(res, out) -> dict:
    """A `test_cv` run's statistics: the four tests present."""
    keys = sorted((res[2] or {}).keys())
    want = sorted(["shapiro base", "shapiro ens", "median", "mann_whitney"])
    return {"statistics": keys, "checks_ok": keys == want}


def ensembles_layout(out: pathlib.Path, kind: str, combos, tags) -> dict:
    """`ensemble_layout` for every combination of `combos`."""
    parts = [ensemble_layout(out, kind, c, tags) for c in combos]
    return {"files": sum(p["files"] for p in parts),
            "missing": [m for p in parts for m in p["missing"]],
            "wrong_shapes": [w for p in parts for w in p["wrong_shapes"]]}


def meta_heads_layout(out: pathlib.Path, kind: str, combos, folds: int) -> dict:
    """Every combination's `<kind>_models/ensemble_<name>/meta_heads.bin`
    with its `combo` and the (folds, k + 1) `meta_wb` of finite heads."""
    missing, wrong = [], []
    for comb in combos:
        name = "_".join(str(c) for c in comb)
        path = out / f"{kind}_models" / f"ensemble_{name}" / "meta_heads.bin"
        if not path.exists():
            missing.append(str(path.relative_to(out)))
            continue
        got = torch.load(path, map_location="cpu", weights_only=True)
        wb = got.get("meta_wb")
        if (sorted(got) != ["combo", "meta_wb"] or got["combo"].tolist() != list(comb)
                or tuple(wb.shape) != (folds, len(comb) + 1)
                or not bool(torch.isfinite(wb).all())):
            wrong.append(str(path.relative_to(out)))
    return {"files": len(combos), "missing": missing, "wrong_shapes": wrong}


def markers_restored(out: pathlib.Path, names) -> dict:
    """The grid's resume markers of `names`, as `--state_mirror` restored
    them under `out/sweep_state/`, each with its val and test metrics."""
    got = grid_test_metrics(out)
    missing = [n for n in names if n not in got]
    return {"files": len(names), "missing": missing,
            "wrong_shapes": [n for n in names if n in got and not got[n]]}


def grid_test_metrics(out: pathlib.Path) -> dict:
    """{combination: its markers' held-out test metrics} of a grid run."""
    state = out / "sweep_state"
    return {"_".join(map(str, m["combo"])): m.get("test", {})
            for m in (json.loads(p.read_text()) for p in sorted(state.glob("*.json")))}


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
    of their own: K1's model axis with the widths of that call; each by
    device time beside the library's."""
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
                        models=models, device=True)
                for dtype, N, D, M, models, w in sorted(
                    k1_shapes, key=lambda s: (str(s[0]), s[1:5]))]
    k2_cases = [k2_case(own, dtype, shape, "cli", device=True)
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


# test_cv on the card against what the drivers recorded: the frozen
# --all_ensembles fold metrics of the {5,9,11} heads against --ensemble
# 5,9,11 on the same heads (other member groupings, device metrics against
# host ones), and --ensemble on a grid combination's cv{k}.bin against the
# held-out test metrics its markers hold (the grid's padded stacked forward
# against the exact-shape ensemble).
TCV_FROZEN_ATOL = 1e-6
TCV_MARKERS_ATOL = 1e-5


def cli_test_cv_consistency(work, results, ranked, best_name, grid_confs, folds) -> dict:
    """The two consistency checks of test_cv's runs (`cli_test_cv`)."""
    grid_name = "_".join(map(str, grid_confs))
    frozen_all = ranked[0][0][best_name]
    frozen_one = results["tcv_frozen"][1]
    markers = grid_test_metrics(work / "ens_grid_cv")[grid_name]
    grid_ckpt = results["tcv_grid"][1]

    def max_diff(a, b):
        keys = [k for k in a[folds[0]] if k in b[folds[0]]]
        return (max(abs(a[f][k] - b[f][k]) for f in folds for k in keys), len(keys))

    frozen_diff, frozen_keys = max_diff(frozen_all, frozen_one)
    markers_diff, markers_keys = max_diff(grid_ckpt, markers)
    ok = (frozen_diff <= TCV_FROZEN_ATOL and markers_diff <= TCV_MARKERS_ATOL
          and frozen_keys == markers_keys == 11 and len(ranked) == 2
          and len(ranked[0][0]) == 816)
    line = {"phase": "cli_test_cv", "card": card,
            "frozen_all_vs_ensemble": {"combination": best_name, "metrics": frozen_keys,
                                       "max_abs_diff": frozen_diff,
                                       "atol": TCV_FROZEN_ATOL},
            "ckpt_vs_markers": {"combination": grid_name, "metrics": markers_keys,
                                "max_abs_diff": markers_diff, "atol": TCV_MARKERS_ATOL},
            "ranked_combinations": [len(r[0]) for r in ranked],
            "best_frozen": ranked[0][1][0], "best_markers": ranked[1][1][0], "ok": ok}
    emit(line)
    check(ok, f"cli: test_cv's consistency checks: {line}")
    return {"frozen_max_abs_diff": frozen_diff, "markers_max_abs_diff": markers_diff}


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
    boot = ["--csv_path", ds["fixed_csv"], "--data_root", ds["data_root"],
            "--num_steps", str(CLI_STEPS), "--eval_every", str(CLI_EVAL_EVERY)]
    epochs = ["--num_epochs", str(CLI_EPOCHS)]
    L = ViTConfig.from_conf(9).num_layers            # every group's depth too
    groups = len(stack.group_configs(BASELINE_CONFS))
    cv_evals = CLI_STEPS // CLI_EVAL_EVERY + 1       # + the closing evaluation
    whole_evals = CLI_STEPS // 31 + 1                # --eval_every 31 (default)
    folds = [f"CV {f + 1}" for f in range(CLI_FOLDS)]
    confs = list(BASELINE_CONFS)
    # the ensembles: an evaluation after each epoch and a closing one
    cv_train = CLI_ROWS - CLI_TEST - (CLI_ROWS - CLI_TEST) // CLI_FOLDS
    fixed_train = CLI_ROWS - CLI_TEST - CLI_FIXED_VAL
    ens_evals = CLI_EPOCHS + 1
    ens_layers = sum(ViTConfig.from_conf(c).num_layers for c in BEST_ENSEMBLE)
    boot_confs = tuple(range(1, CLI_BOOT_MAX_CONFIGS))
    boot_layers = sum(ViTConfig.from_conf(c).num_layers for c in boot_confs)
    cv_steps, fixed_steps = (CLI_EPOCHS * -(-n // 4) for n in (cv_train, fixed_train))
    best = ",".join(str(c) for c in BEST_ENSEMBLE)
    best_name = "_".join(str(c) for c in BEST_ENSEMBLE)
    # the padded grid: the combinations of confs 1-4 by class signature, in
    # the order the grid runs them, one chunk each at the auto width; every
    # slot at the template's depth, k slots a forward; an evaluation's
    # validation and test forwards after each epoch and once more at the end
    grid_combos = list(itertools.combinations(range(1, CLI_GRID_MAX_CONFIGS), 3))
    grid_names = ["_".join(map(str, c)) for c in grid_combos]
    by_sig = {}
    for comb in grid_combos:
        sig = e2e_grid.signature_of(e2e_grid.plan_combo(comb))
        by_sig[sig] = by_sig.get(sig, 0) + 1
    grid_chunks = list(by_sig.values())
    template_depth = max(ViTConfig.from_conf(c).num_layers for c in BASELINE_CONFS)
    grid_slots = template_depth * 3
    grid_k1 = grid_slots * (CLI_EPOCHS + 1) * 2

    def grid_k2(steps_per_epoch):
        """A training step's forward and, under the grid's remat, its
        recompute in the backward pass; two evaluations' forwards an epoch
        and at the end."""
        return grid_slots * (2 * CLI_EPOCHS * steps_per_epoch + (CLI_EPOCHS + 1) * 2)

    cv_S, fixed_S = -(-cv_train // 4), -(-fixed_train // 4)
    all_combos = list(itertools.combinations(BASELINE_CONFS, 3))
    all_names = ["_".join(map(str, c)) for c in all_combos]
    mirror = work / "mirror" / "ens_grid_cv.jsonl"

    def baselines(out):
        """The whole_all run's 18 baseline checkpoints, which the ensemble
        drivers read from `baseline_models/` under their --output_dir."""
        shutil.copytree(work / "whole_all" / "baseline_models",
                        out / "baseline_models", dirs_exist_ok=True)

    def baseline_ckpts(kind, cs, tags):
        return lambda o: checkpoint_layout(o, kind, cs, lambda c: tags)

    # test_cv's runs: the folds' conf 9 baselines of cv_single, the grid's
    # first combination (its cv{k}.bin and markers in ens_grid_cv), the
    # frozen heads and baselines of ens_frozen_cv
    tcv = ["--csv_path", ds["cv_csv"], "--data_root", ds["data_root"],
           "--cv", str(CLI_FOLDS),
           "--base_path", str(work / "cv_single" / "cv_baseline_models")]
    grid_pick_confs = grid_combos[0]
    grid_pick = ",".join(map(str, grid_pick_confs))
    grid_pick_layers = sum(ViTConfig.from_conf(c).num_layers for c in grid_pick_confs)

    def frozen_layers(cs):
        """compute_member_logits' layers: a stacked forward a group."""
        return sum(g.template_config().num_layers for g in stack.group_configs(cs))

    def tcv_cells(r):
        return [r[0][f] for f in folds] + [r[1][f] for f in folds]

    def int8_checks(impl, single, frozen=()):
        """The int8 products a test_cv run must make: each fold's forward
        of every single model, and of the frozen members' stacked groups
        (one product a model for each stacked projection)."""
        products = CLI_FOLDS * (
            sum(quant_products(impl, ViTConfig.from_conf(c)) for c in single)
            + sum(quant_products(impl, g.template_config()) * len(g.confs)
                  for g in stack.group_configs(frozen) if frozen))
        before = {"n": 0}

        def prep(out):
            before["n"] = quant.int8_products

        def verify(res, out):
            made = quant.int8_products - before["n"]
            got = stats_checks(res, out)
            return {**got, "int8_products": made, "expected_int8_products": products,
                    "checks_ok": got["checks_ok"] and made == products}

        return {"prep": prep, "verify": verify}

    # dropout on: K1 serves the evaluations, K2 every forward
    runs = [
        cli_run("cv_single", train_baseline_cv, ["--config", "9", *cv],
                CLI_FOLDS * CLI_STEPS, CLI_FOLDS * L * cv_evals,
                CLI_FOLDS * L * (CLI_STEPS + cv_evals),
                cells=lambda r: [r[f] for f in folds],
                layout=baseline_ckpts("cv_baseline", [9],
                                      [f"cv{f + 1}" for f in range(CLI_FOLDS)]),
                short=["--num_cv", "1"]),
        cli_run("cv_all", train_baseline_cv, ["--all_configs", *cv],
                groups * CLI_STEPS, groups * L * cv_evals,
                groups * L * (CLI_STEPS + cv_evals),
                cells=lambda r: [r[c][f] for c in confs for f in folds],
                layout=baseline_ckpts("cv_baseline", confs,
                                      [f"cv{f + 1}" for f in range(CLI_FOLDS)]),
                short=[]),
        cli_run("cv_all_resume", train_baseline_cv, ["--all_configs", "--resume", *cv],
                0, 0, 0, cells=lambda r: [r[c][f] for c in confs for f in folds],
                out="cv_all", same_as="cv_all"),
        # the same engine on the same shapes as cv_all: its busy share is
        # cv_all's (the pool's rotation rows are one batched call)
        cli_run("cv_all_device_aug", train_baseline_cv,
                ["--all_configs", "--aug_mode", "device", *cv], groups * CLI_STEPS,
                groups * L * cv_evals, groups * L * (CLI_STEPS + cv_evals),
                cells=lambda r: [r[c][f] for c in confs for f in folds],
                layout=baseline_ckpts("cv_baseline", confs,
                                      [f"cv{f + 1}" for f in range(CLI_FOLDS)])),
        cli_run("whole_single", train_baseline_whole_dataset, ["--config", "9", *whole],
                CLI_STEPS, L * whole_evals, L * (CLI_STEPS + whole_evals),
                cells=lambda r: [r[9]],
                layout=baseline_ckpts("baseline", [9], ["conf9"]), short=[]),
        cli_run("whole_all", train_baseline_whole_dataset, ["--all_configs", *whole],
                groups * CLI_STEPS, groups * L * whole_evals,
                groups * L * (CLI_STEPS + whole_evals),
                cells=lambda r: [r[c] for c in confs],
                layout=lambda o: checkpoint_layout(o, "baseline", confs,
                                                   lambda c: [f"conf{c}"]),
                short=[]),
        # the bootstrap replicates of conf 9 in chunks of 2 and in one
        # chunk of 4, whose metrics must agree (`cli_boot_chunk`)
        *[cli_run(f"boot_chunk{chunk}", train_baseline_bootstrap,
                  ["--config", "9", "--num_rep", str(CLI_BOOT_REPS),
                   "--boot_chunk", str(chunk), *boot],
                  CLI_BOOT_REPS // chunk * CLI_STEPS,
                  CLI_BOOT_REPS // chunk * L * cv_evals,
                  CLI_BOOT_REPS // chunk * L * (CLI_STEPS + cv_evals),
                  cells=lambda r: [r["conf9"][f"boot{k}"] for k in range(CLI_BOOT_REPS)],
                  layout=baseline_ckpts("boot_baseline", [9], [
                      f"boot{k}" for k in range(CLI_BOOT_REPS)]),
                  short=["--num_rep", str(chunk)])
          for chunk in (2, CLI_BOOT_REPS)],
        cli_run("boot_all", train_baseline_bootstrap,
                ["--all_configs", "--num_rep", "2", *boot], groups * CLI_STEPS,
                groups * L * cv_evals, groups * L * (CLI_STEPS + cv_evals),
                cells=lambda r: [r[f"conf{c}"][f"boot{k}"] for c in confs
                                 for k in range(2)],
                layout=baseline_ckpts("boot_baseline", confs, ["boot0", "boot1"]),
                short=[]),
        # the {5,9,11} stack from whole_all's baselines, then over the CV
        # folds (sequential mode) and again with --resume, then the one
        # combination of confs 1-3 over two bootstrap replicates with its
        # held-out test evaluation (one more K1/K2 forward a replicate)
        cli_run("ens_whole", train_ensemble_whole_dataset,
                ["--ensemble_conf_list", best, *epochs, *whole[:4]], fixed_steps,
                ens_layers * ens_evals, ens_layers * (fixed_steps + ens_evals),
                cells=lambda r: [r],
                layout=lambda o: ensemble_layout(o, "best_ensemble", BEST_ENSEMBLE,
                                                 ["best_ensemble_model"]),
                short=["--num_epochs", "1"], prep=baselines),
        cli_run("ens_cv", train_ensemble_cv,
                ["--no-padded_compile", "--ensemble_conf_list", best, *epochs, *cv[:4],
                 "--num_cv", str(CLI_FOLDS)], CLI_FOLDS * cv_steps,
                CLI_FOLDS * ens_layers * ens_evals,
                CLI_FOLDS * ens_layers * (cv_steps + ens_evals),
                cells=lambda r: [r[best_name][f] for f in folds],
                layout=lambda o: ensemble_layout(o, "cv_ensemble", BEST_ENSEMBLE, [
                    f"cv{f + 1}" for f in range(CLI_FOLDS)]),
                short=["--num_epochs", "1", "--num_cv", "1"], prep=baselines),
        cli_run("ens_cv_resume", train_ensemble_cv,
                ["--no-padded_compile", "--ensemble_conf_list", best, *epochs, *cv[:4],
                 "--num_cv", str(CLI_FOLDS), "--resume"], 0, 0, 0,
                cells=lambda r: [r[best_name][f] for f in folds],
                out="ens_cv", same_as="ens_cv"),
        cli_run("ens_boot", train_ensemble_bootstrap,
                ["--no-padded_compile", "--max_configs", str(CLI_BOOT_MAX_CONFIGS),
                 "--num_rep", "2", *epochs, *whole[:4]], 2 * fixed_steps,
                2 * boot_layers * (ens_evals + 1),
                2 * boot_layers * (fixed_steps + ens_evals + 1),
                cells=lambda r: [part["1_2_3"][f"boot{k}"] for part in r
                                 for k in range(2)],
                layout=lambda o: ensemble_layout(o, "bootstrap_ensemble", boot_confs,
                                                 ["bootstrap_0", "bootstrap_1"]),
                short=["--num_epochs", "1", "--num_rep", "1"], prep=baselines),
        # the two ensemble sweeps in their default mode, the padded
        # (combination, fold) grid: every slot a stacked model at the
        # template's depth over P = c·F instances, K2 in every forward, K1
        # with the model axis in each evaluation's validation and test
        # forwards (after every epoch and once more at the end)
        cli_run("ens_grid_cv", train_ensemble_cv,
                ["--max_configs", str(CLI_GRID_MAX_CONFIGS), "--save_ensembles",
                 *epochs, *cv[:4], "--num_cv", str(CLI_FOLDS)],
                len(grid_chunks) * CLI_EPOCHS * cv_S,
                len(grid_chunks) * grid_k1, len(grid_chunks) * grid_k2(cv_S),
                cells=lambda r: [r[n][f] for n in grid_names for f in folds],
                layout=lambda o: ensembles_layout(o, "cv_ensemble", grid_combos, [
                    f"cv{f + 1}" for f in range(CLI_FOLDS)]),
                short=["--num_epochs", "1", "--max_configs", "4"], prep=baselines,
                chunks=grid_chunks),
        cli_run("ens_grid_cv_chunk1", train_ensemble_cv,
                ["--max_configs", str(CLI_GRID_MAX_CONFIGS), "--e2e_chunk", "1",
                 *epochs, *cv[:4], "--num_cv", str(CLI_FOLDS)],
                len(grid_combos) * CLI_EPOCHS * cv_S,
                len(grid_combos) * grid_k1, len(grid_combos) * grid_k2(cv_S),
                cells=lambda r: [r[n][f] for n in grid_names for f in folds],
                prep=baselines, chunks=[1] * len(grid_combos)),
        cli_run("ens_grid_cv_resume", train_ensemble_cv,
                ["--max_configs", str(CLI_GRID_MAX_CONFIGS), "--save_ensembles",
                 *epochs, *cv[:4], "--num_cv", str(CLI_FOLDS), "--resume"], 0, 0, 0,
                cells=lambda r: [r[n][f] for n in grid_names for f in folds],
                out="ens_grid_cv", same_as="ens_grid_cv"),
        # --state_mirror: the first run folds the markers into the mirror,
        # the second restores them after sweep_state/ is deleted
        cli_run("ens_grid_cv_mirror", train_ensemble_cv,
                ["--max_configs", str(CLI_GRID_MAX_CONFIGS), "--save_ensembles",
                 *epochs, *cv[:4], "--num_cv", str(CLI_FOLDS), "--resume",
                 "--state_mirror", str(mirror)], 0, 0, 0,
                cells=lambda r: [r[n][f] for n in grid_names for f in folds],
                out="ens_grid_cv", same_as="ens_grid_cv"),
        cli_run("ens_grid_cv_mirror_restore", train_ensemble_cv,
                ["--max_configs", str(CLI_GRID_MAX_CONFIGS), "--save_ensembles",
                 *epochs, *cv[:4], "--num_cv", str(CLI_FOLDS), "--resume",
                 "--state_mirror", str(mirror)], 0, 0, 0,
                cells=lambda r: [r[n][f] for n in grid_names for f in folds],
                layout=lambda o: markers_restored(o, grid_names),
                out="ens_grid_cv", same_as="ens_grid_cv",
                prep=lambda o: shutil.rmtree(o / "sweep_state")),
        cli_run("ens_grid_boot", train_ensemble_bootstrap,
                ["--max_configs", str(CLI_BOOT_MAX_CONFIGS), "--num_rep", "2",
                 "--save_ensembles", *epochs, *whole[:4]],
                CLI_EPOCHS * fixed_S, grid_k1, grid_k2(fixed_S),
                cells=lambda r: [part["1_2_3"][f"boot{k}"] for part in r
                                 for k in range(2)],
                layout=lambda o: ensemble_layout(o, "bootstrap_ensemble", boot_confs,
                                                 ["bootstrap_0", "bootstrap_1"]),
                short=["--num_epochs", "1", "--num_rep", "1"], prep=baselines,
                chunks=[1]),
        # --frozen: the 18 baselines' logits (three groups, K1 and K2 at the
        # group's depth) over each fold's train and val splits, or each
        # replicate's train, val and test, then the 816 x F meta heads
        cli_run("ens_frozen_cv", train_ensemble_cv,
                ["--frozen", *epochs, *cv[:4], "--num_cv", str(CLI_FOLDS)],
                CLI_EPOCHS * cv_S, groups * L * 2 * CLI_FOLDS,
                groups * L * 2 * CLI_FOLDS,
                cells=lambda r: [r[n][f] for n in all_names for f in folds],
                layout=lambda o: meta_heads_layout(o, "cv_ensemble", all_combos,
                                                   CLI_FOLDS),
                short=["--num_epochs", "1", "--num_cv", "1"], prep=baselines),
        cli_run("ens_frozen_boot", train_ensemble_bootstrap,
                ["--frozen", "--num_rep", "2", *epochs, *whole[:4]],
                CLI_EPOCHS * fixed_S, groups * L * 3 * 2, groups * L * 3 * 2,
                cells=lambda r: [part[n][f"boot{k}"] for part in r for n in all_names
                                 for k in range(2)],
                layout=lambda o: meta_heads_layout(o, "bootstrap_ensemble",
                                                   all_combos, 2),
                short=["--num_epochs", "1", "--num_rep", "1"], prep=baselines),
        # test_cv on what the runs above wrote: one forward a fold over the
        # 22-row test split, each model's layers (a shape-class group's
        # template depth for the frozen members' logits); no training
        cli_run("tcv_baseline", test_cv, ["--baseline", "--conf", "9", *tcv],
                0, CLI_FOLDS * L, CLI_FOLDS * L,
                cells=lambda r: [r[0][f] for f in folds]),
        cli_run("tcv_grid", test_cv,
                ["--baseline", "--ensemble", "--conf", "9",
                 "--ensemble_conf_list", grid_pick, *tcv], 0,
                CLI_FOLDS * (L + grid_pick_layers), CLI_FOLDS * (L + grid_pick_layers),
                cells=tcv_cells, out="ens_grid_cv", verify=stats_checks),
        cli_run("tcv_frozen", test_cv,
                ["--baseline", "--ensemble", "--conf", "9",
                 "--ensemble_conf_list", best, *tcv], 0,
                CLI_FOLDS * (L + frozen_layers(BEST_ENSEMBLE)),
                CLI_FOLDS * (L + frozen_layers(BEST_ENSEMBLE)),
                cells=tcv_cells, out="ens_frozen_cv", verify=stats_checks),
        cli_run("tcv_all_frozen", test_cv, ["--all_ensembles", *tcv], 0,
                CLI_FOLDS * frozen_layers(BASELINE_CONFS),
                CLI_FOLDS * frozen_layers(BASELINE_CONFS),
                cells=lambda r: [r[1][f] for f in folds],
                layout=lambda o: report_rows(o, len(all_combos)), out="ens_frozen_cv"),
        cli_run("tcv_all_markers", test_cv, ["--all_ensembles", *tcv], 0, 0, 0,
                cells=lambda r: [r[1][f] for f in folds],
                layout=lambda o: report_rows(o, len(grid_combos)), out="ens_grid_cv"),
        cli_run("tcv_ood", test_cv,
                ["--ensemble", "--ensemble_conf_list", grid_pick, "--ood", *tcv], 0,
                CLI_FOLDS * grid_pick_layers, CLI_FOLDS * grid_pick_layers,
                cells=lambda r: [r[1][f] for f in folds], out="ens_grid_cv"),
        # int8: the FFN too (no K1), the e2e ensemble's members included;
        # int8_attn: the projections only, the frozen members' stacked ones
        # with each model's scales
        cli_run("tcv_int8", test_cv,
                ["--baseline", "--ensemble", "--conf", "9", "--ensemble_conf_list",
                 grid_pick, "--quant_impl", "int8", *tcv], 0, 0,
                CLI_FOLDS * (L + grid_pick_layers), cells=tcv_cells, out="ens_grid_cv",
                **int8_checks("int8", [9, *grid_pick_confs])),
        cli_run("tcv_int8_attn", test_cv,
                ["--baseline", "--ensemble", "--conf", "9", "--ensemble_conf_list",
                 best, "--quant_impl", "int8_attn", *tcv], 0,
                CLI_FOLDS * (L + frozen_layers(BEST_ENSEMBLE)),
                CLI_FOLDS * (L + frozen_layers(BEST_ENSEMBLE)),
                cells=tcv_cells, out="ens_frozen_cv",
                **int8_checks("int8_attn", [9], BEST_ENSEMBLE)),
    ]
    results, totals, summary, calls, ranked = {}, counts_of(), {}, {}, []
    for run in runs:
        name, driver, argv = run["name"], run["driver"], run["argv"]
        out = work / (run["out"] or name)
        if run["prep"]:
            out.mkdir(parents=True, exist_ok=True)
            run["prep"](out)
        go = lambda o=out: driver.main([*argv, "--output_dir", str(o)])  # noqa: E731
        reset_launches()
        got, seen, grids = [], {}, []
        with kernel_calls(seen), grid_runs(grids), all_ensembles_results(ranked):
            seconds = wall_time_ms(lambda: got.append(go())) / 1e3
        counts = launches()
        for kernel, recorded in seen.items():
            calls.setdefault(kernel, []).extend(recorded)
        res = results[name] = got[0]
        want = counts_of(K1=run["k1"], K1_own=run["k1"], K2=run["k2"])
        steps = run["steps"]
        line = {"phase": "cli", "card": card, "run": name,
                "driver": driver.__name__.rsplit(".", 1)[1], "argv": argv,
                "seconds": seconds, "steps": steps,
                "ms_per_step": seconds * 1e3 / steps if steps else None,
                "launches": counts, "expected_launches": want,
                "k1_launches": counts["K1"], "k2_launches": counts["K2"],
                # every launch went through a call `kernel_calls` recorded
                "recorded_calls": {k: len(seen.get(k, [])) for k in ("K1", "K2")},
                "device_idle_share": None}
        ok = counts == want and all(len(seen.get(k, [])) == counts[k]
                                    for k in ("K1", "K2"))
        if run["chunks"] is not None:
            # the grid ran each chunk at the width the launches assume, and
            # no chunk backed off
            widths = [w for g in grids for ws in g.chunks.values() for w in ws]
            backoffs = sum(g.backoffs for g in grids)
            line.update(grid_chunks=widths, grid_backoffs=backoffs)
            ok = ok and widths == run["chunks"] and backoffs == 0
        if run["same_as"]:
            same = res == results[run["same_as"]]
            line[f"same_results_as_{run['same_as']}"] = same
            ok = ok and same
        if run["short"] is not None:
            # the busy share on a short run of the same driver (its first
            # evaluation period or epoch, one fold or replicate where they
            # run in turn), in a fresh directory: the profiler's cost grows
            # with the events it records.  Its wall time is the traced run's
            short_argv = [*argv, *run["short"]]
            if "--num_steps" in argv:
                short_argv += ["--num_steps", str(CLI_EVAL_EVERY)]
            short_out = work / "short"
            if run["prep"]:
                short_out.mkdir(parents=True, exist_ok=True)
                run["prep"](short_out)
            idle = cli_idle(lambda: driver.main(
                [*short_argv, "--output_dir", str(short_out)]))
            shutil.rmtree(short_out, ignore_errors=True)
            line.update(short_run_argv=short_argv[len(argv):], **idle)
            ok = ok and idle["short_run_device_busy_ms"] > 0
        cells = run["cells"](res)
        finite = bool(cells) and all(math.isfinite(v) for m in cells for v in m.values())
        line.update(cells=len(cells), finite_metrics=finite,
                    median_auroc=float(np.median([m["AUROC"] for m in cells])))
        ok = ok and finite
        if run["layout"]:
            layout = line["checkpoints"] = run["layout"](out)
            ok = ok and not layout["missing"] and not layout["wrong_shapes"]
        if run["verify"]:
            line.update(run["verify"](res, out))
            ok = ok and line["checks_ok"]
        line["ok"] = ok
        emit(line)
        check(ok, f"cli {name}: {line}")
        summary[name] = {k: line.get(k) for k in (
            "seconds", "ms_per_step", "device_idle_share", "k1_launches",
            "k2_launches")}
        for k, n in counts.items():
            totals[k] += n
    # --boot_chunk changes which cells share a grouped run, not their metrics
    chunked = [f"boot_chunk{chunk}" for chunk in (2, CLI_BOOT_REPS)]
    cells_of = {run["name"]: run["cells"] for run in runs}
    pairs = [(a[k], b[k]) for a, b in zip(*(cells_of[n](results[n]) for n in chunked))
             for k in a]
    diff = max(abs(a - b) for a, b in pairs)
    line = {"phase": "cli_boot_chunk", "card": card, "runs": chunked,
            "values": len(pairs), "max_abs_diff": diff,
            "atol": CLI_BOOT_CHUNK_ATOL, "ok": diff <= CLI_BOOT_CHUNK_ATOL}
    emit(line)
    check(line["ok"], f"cli: --boot_chunk 2 against {CLI_BOOT_REPS}: {line}")
    summary["boot_chunk_max_abs_diff"] = diff
    # --e2e_chunk changes which combinations share a chunk, not their
    # metrics: the val results and the markers' held-out test metrics
    pair = ("ens_grid_cv", "ens_grid_cv_chunk1")
    tests = [grid_test_metrics(work / name) for name in pair]
    pairs = [(a[k], b[k]) for a, b in zip(*(cells_of[n](results[n]) for n in pair))
             for k in a]
    pairs += [(tests[0][n][f][k], tests[1][n][f][k]) for n in grid_names
              for f in folds for k in tests[0][n][f]]
    diff = max(abs(a - b) for a, b in pairs)
    line = {"phase": "cli_grid_chunk", "card": card, "runs": list(pair),
            "values": len(pairs), "max_abs_diff": diff,
            "atol": CLI_BOOT_CHUNK_ATOL, "ok": diff <= CLI_BOOT_CHUNK_ATOL}
    emit(line)
    check(line["ok"] and len(pairs) == 2 * len(grid_names) * CLI_FOLDS * 11,
          f"cli: --e2e_chunk 1 against the auto chunk: {line}")
    summary["grid_chunk_max_abs_diff"] = diff
    summary["test_cv"] = cli_test_cv_consistency(work, results, ranked, best_name,
                                                 grid_pick_confs, folds)
    # test_cv leaves its --quant_impl set; the phases after this one run exact
    quant.set_default_quant_impl("none")
    # the kernels at the shapes these runs gave them (launches not counted)
    cases = cli_kernel_cases(calls)
    mesh = phase_mesh(work, {run["name"]: run for run in runs}, results, baselines)
    return {"launches": totals, "runs": summary, "cases": cases, "mesh": mesh}


# --- the `mesh` phase: the sweeps and data-parallel training over ranks --------
# Two ranks on the one card, over gloo by `parallel/mesh.choose_backend`'s
# rule (NCCL refuses two ranks on one card), each holding its device:
# cuda:0.  They run three of phase `cli`'s runs again with a mesh (5 folds
# padded to 6 on a data axis of 2; one combination padded to 2 on a model
# axis of 2), held to those runs' one-process results at the JAX package's
# mesh tolerances (`tests/test_parallel.py:93-94,148-152,176-177`): the
# ranks' blocks run other batched-GEMM shapes than one process, so f32 sums
# may round apart; then `make_dp_train_step` on conf 9.
MESH_RANKS = 2
MESH_RTOL, MESH_ATOL = 1e-4, 1e-5
MESH_RUNS = (("mesh_cv_all", "cv_all", "1x2"),
             ("mesh_grid_boot", "ens_grid_boot", "2x1"),
             ("mesh_frozen_cv", "ens_frozen_cv", "1x2"))
#: the data-parallel step: conf 9 at full width, f32, dropout 0, a global
#: batch of 8 (4 rows a rank), 3 SGD-momentum steps at lr 1e-2
DP_CONF, DP_BATCH, DP_STEPS, DP_LR = 9, 8, 3, 1e-2
#: the ranks' whole run, their start included
MESH_TIMEOUT_S = 600


def dp_model():
    config = dataclasses.replace(ViTConfig.from_conf(DP_CONF), dropout_rate=0.0)
    model = VisionTransformer3D(config, vis=False, zero_head=False, device="cuda",
                                generator=torch.Generator().manual_seed(SEED))
    opt, sched = sgd_momentum(model.parameters(), DP_LR, lambda step: 1.0)
    return model, opt, sched


def dp_batch():
    """A global batch whose two halves differ in label balance and masked
    rows, so an average of the ranks' own losses is not the batch's."""
    rng = np.random.default_rng(SEED + 7)
    vols = rng.normal(size=(DP_BATCH, 128, 128, 5, 1)).astype(np.float32)
    labels = np.array([1, 1, 1, 0, 0, 1, 0, 0], np.float32)
    mask = np.array([1, 1, 1, 1, 1, 0, 1, 0], np.float32)
    return [torch.as_tensor(a, device="cuda") for a in (vols, labels, mask)]


def _mesh_rank(rank: int, world: int, root: str, jobs: list) -> None:
    """One rank of phase `mesh`: join the gloo group, run each job with the
    launch counters set to 0 just before and read just after, and gather
    every rank's results to rank 0, which saves them under `root`."""
    import os

    import torch.distributed as dist

    from vit3d_ensemble_tpu_torch.parallel import make_dp_train_step, make_mesh
    from vit3d_ensemble_tpu_torch.parallel.mesh import choose_backend, rank_device

    os.environ["LOCAL_RANK"] = str(rank)
    logging.basicConfig(level=logging.WARNING)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = choose_backend(torch.device("cuda"), world)
    dist.init_process_group(backend, init_method=f"file://{root}/store", rank=rank,
                            world_size=world)
    try:
        out = {"backend": backend, "device": str(rank_device("cuda")),
               "current_device": torch.cuda.current_device(), "runs": {}}
        drivers = {d.__name__.rsplit(".", 1)[1]: d
                   for d in (train_baseline_cv, train_ensemble_bootstrap, train_ensemble_cv)}
        for name, driver, argv in jobs:
            dist.barrier()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            if driver is None:              # make_dp_train_step on conf 9
                model, opt, sched = dp_model()
                mesh = make_mesh(1, world, device="cuda")
                step, shard = make_dp_train_step(model, opt, mesh, scheduler=sched)
                vols, labels, mask = (shard(a) for a in dp_batch())
                losses = [float(step(vols, labels, mask)) for _ in range(DP_STEPS)]
                result = {"losses": losses, "rows": len(vols),
                          "params": {k: v.detach().cpu() for k, v in
                                     model.state_dict().items()},
                          "mesh_device": str(mesh.device), "mesh_backend": mesh.backend}
            else:
                result = drivers[driver].main(argv)
            torch.cuda.synchronize()
            out["runs"][name] = {"result": result, "launches": launches(),
                                 "seconds": time.perf_counter() - t0}
        gathered = [None] * world
        dist.all_gather_object(gathered, out)
        if rank == 0:
            torch.save(gathered, pathlib.Path(root) / "ranks.pt")
    finally:
        dist.destroy_process_group()


def nested_close(a, b, rtol: float, atol: float) -> tuple:
    """(largest |a - b|, every value within atol + rtol·|b|) over nested
    dicts, lists and tuples of numbers with the same keys."""
    if isinstance(b, dict):
        if list(a) != list(b):
            return math.inf, False
        parts = [nested_close(a[k], b[k], rtol, atol) for k in b]
    elif isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return math.inf, False
        parts = [nested_close(x, y, rtol, atol) for x, y in zip(a, b)]
    else:
        d = abs(float(a) - float(b))
        return d, d <= atol + rtol * abs(float(b))
    return max((p[0] for p in parts), default=0.0), all(p[1] for p in parts)


def phase_mesh(work: pathlib.Path, runs: dict, results: dict, baselines) -> dict:
    """Phase `cli`'s `train_baseline_cv --all_configs` under --mesh 1x2,
    `train_ensemble_bootstrap`'s grid under --mesh 2x1 and
    `train_ensemble_cv --frozen` under --mesh 1x2, then `make_dp_train_step`
    on conf 9, in MESH_RANKS ranks on the card (`_mesh_rank`, processes
    started by spawn).  Each run: every rank on cuda:0 over gloo, the
    results equal on both ranks and within the mesh tolerances of the
    one-process run's, each rank's exact K1/K2 launches, its seconds; the
    data-parallel step's replicas equal bit for bit and within the
    tolerances of one process's steps on the whole batch."""
    import torch.multiprocessing as mp

    L = ViTConfig.from_conf(DP_CONF).num_layers
    root = work / "mesh"
    root.mkdir(parents=True, exist_ok=True)
    jobs, want = [], {}
    for name, base, spec in MESH_RUNS:
        run = runs[base]
        out = work / name
        if run["prep"]:
            out.mkdir(parents=True, exist_ok=True)
            run["prep"](out)
        driver = run["driver"].__name__.rsplit(".", 1)[1]
        jobs.append((name, driver, [*run["argv"], "--mesh", spec, "--output_dir", str(out)]))
        # every rank runs every step and evaluation of its block: the
        # one-process run's launches, each on fewer models
        want[name] = counts_of(K1=run["k1"], K1_own=run["k1"], K2=run["k2"])
    jobs.append(("mesh_dp", None, None))
    want["mesh_dp"] = counts_of(K2=L * DP_STEPS, **k1_split(L * DP_STEPS, torch.float32,
                                                            ViTConfig.from_conf(DP_CONF).hidden_size))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ctx = mp.start_processes(_mesh_rank, args=(MESH_RANKS, str(root), jobs),
                                 nprocs=MESH_RANKS, join=False, start_method="spawn")
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the ranks ran over {MESH_TIMEOUT_S} s")
        ranks = torch.load(root / "ranks.pt", weights_only=False)
    except Exception as exc:  # noqa: BLE001 - a rank that fails fails the run
        emit({"phase": "mesh", "card": card, "error": repr(exc), "ok": False})
        check(False, f"mesh: the ranks failed: {exc!r}")
        return {"launches": counts_of(), "runs": {}}
    seconds = time.perf_counter() - t0
    totals = counts_of()
    summary = {"backend": ranks[0]["backend"], "ranks": MESH_RANKS,
               "seconds_with_start": seconds, "runs": {}}
    on_card = all(r["device"] == "cuda:0" and r["current_device"] == 0 for r in ranks)
    for name, _, argv in jobs:
        got = [r["runs"][name] for r in ranks]
        counts = [g["launches"] for g in got]
        for c in counts:
            for k, n in c.items():
                totals[k] += n
        line = {"phase": "mesh", "card": card, "run": name,
                "argv": argv and argv[argv.index("--mesh"):argv.index("--mesh") + 2],
                "backend": ranks[0]["backend"],
                "devices": [r["device"] for r in ranks],
                "seconds_by_rank": [g["seconds"] for g in got],
                "launches_by_rank": counts, "expected_launches_each": want[name]}
        ok = on_card and all(c == want[name] for c in counts)
        if name == "mesh_dp":
            res = got[0]["result"]
            same = all(g["result"]["losses"] == res["losses"] and all(
                torch.equal(g["result"]["params"][k], v) for k, v in res["params"].items())
                for g in got)
            model, opt, _ = dp_model()
            vols, labels, mask = dp_batch()
            losses = []
            for _ in range(DP_STEPS):
                logits = model(vols, deterministic=False).logits
                loss = masked_bce_with_logits(logits, labels, mask,
                                              masked_balanced_pos_weight(labels, mask))
                opt.zero_grad()
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
            loss_diff, loss_ok = nested_close(res["losses"], losses, MESH_RTOL, MESH_ATOL)
            one = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            param_diff = max(float((res["params"][k] - v).abs().max()) for k, v in one.items())
            param_ok = list(res["params"]) == list(one) and all(
                torch.allclose(res["params"][k], v, rtol=MESH_RTOL, atol=MESH_ATOL)
                for k, v in one.items())
            line.update(rows_per_rank=res["rows"], mesh_device=res["mesh_device"],
                        losses=res["losses"], one_process_losses=losses,
                        loss_max_abs_diff=loss_diff, param_max_abs_diff=param_diff,
                        replicas_bitwise_equal=same,
                        ms_per_step=[g["seconds"] * 1e3 / DP_STEPS for g in got])
            ok = ok and same and loss_ok and param_ok and res["mesh_device"] == "cuda:0"
        else:
            base = dict((n, b) for n, b, _ in MESH_RUNS)[name]
            res = got[0]["result"]
            same = all(g["result"] == res for g in got)
            diff, close = nested_close(res, results[base], MESH_RTOL, MESH_ATOL)
            cells = runs[base]["cells"](res)
            finite = bool(cells) and all(math.isfinite(v) for m in cells for v in m.values())
            steps = runs[base]["steps"]
            line.update(one_process_run=base, ranks_equal=same,
                        max_abs_diff_vs_one_process=diff, within_tolerance=close,
                        rtol=MESH_RTOL, atol=MESH_ATOL, cells=len(cells),
                        finite_metrics=finite,
                        ms_per_step=[g["seconds"] * 1e3 / steps for g in got])
            ok = ok and same and close and finite
            if runs[base]["layout"]:
                layout = line["checkpoints"] = runs[base]["layout"](work / name)
                ok = ok and not layout["missing"] and not layout["wrong_shapes"]
        line["ok"] = ok
        emit(line)
        check(ok, f"mesh {name}: {line}")
        summary["runs"][name] = {k: line.get(k) for k in (
            "seconds_by_rank", "ms_per_step", "launches_by_rank",
            "max_abs_diff_vs_one_process", "param_max_abs_diff")}
    emit({"phase": "mesh_summary", "card": card, **summary, "launches": totals})
    return {"launches": totals, **summary}


# --- the `remat` phase ----------------------------------------------------------


def phase_remat() -> dict:
    """`run_group` on the widest group ((64, 4): M 3,072, 8 layers, 6
    configs x 5 folds) with and without `SweepHyper.remat`, dropout on:
    equal results (each block recomputed with its cells' masks replayed),
    both runs' peak device bytes and ms a step, and the remat run's exact
    launches (K2 twice a training step's block: the forward and its
    recompute).  The grid's instance bytes and auto chunk under remat are
    phase `e2e_grid_memory`'s."""
    hyper = engine.SweepHyper(**SWEEP_HYPER)
    _, _, data = sweep_data(hyper)
    group = max(stack.group_configs(BASELINE_CONFS), key=lambda g: g.hidden_size)
    L, steps = group.max_layers, hyper.num_steps
    evals = steps // hyper.eval_every
    runs = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        got = []
        wall = wall_time_ms(lambda: got.append(engine.run_group(
            group, data, dataclasses.replace(hyper, remat=remat))))
        runs[remat] = {"result": got[0], "wall_ms": wall, "launches": launches(),
                       "peak_bytes": torch.cuda.max_memory_allocated() - base}
    off, on = runs[False]["result"], runs[True]["result"]
    diffs = {k: float(np.abs(getattr(on, k) - getattr(off, k)).max())
             for k in ("losses", "best_metrics", "best_probs")}
    diffs["best_params"] = max(float((on.best_params[k] - v).abs().max())
                               for k, v in off.best_params.items())
    bitwise = (all(d == 0.0 for d in diffs.values()))
    want = counts_of(K1=L * (evals + 1), K1_own=L * (evals + 1),
                     K2=L * (2 * steps + evals + 1))
    line = {"phase": "remat", "card": card,
            "group": f"{group.hidden_size}x{group.num_heads}",
            "cells": len(group.confs) * SWEEP_FOLDS, "steps": steps,
            "peak_bytes": {"no_remat": runs[False]["peak_bytes"],
                           "remat": runs[True]["peak_bytes"]},
            "ms_per_step": {"no_remat": runs[False]["wall_ms"] / steps,
                            "remat": runs[True]["wall_ms"] / steps},
            "max_abs_diff": diffs, "bitwise_equal": bitwise,
            "atol": SWEEP_LOSS_ATOL, "launches": runs[True]["launches"],
            "expected_launches": want,
            "launches_no_remat": runs[False]["launches"]}
    line["ok"] = (runs[True]["launches"] == want
                  and all(d <= SWEEP_LOSS_ATOL for d in diffs.values()))
    emit(line)
    check(line["ok"], f"remat: {line}")
    return {"launches": runs[True]["launches"],
            **{k: line[k] for k in ("peak_bytes", "ms_per_step", "max_abs_diff",
                                    "bitwise_equal")}}


# --- the `e2e_grid_memory` phase: the grid's chunk sizing on the card -------
# The widest class signature, three (64, 4) members, at full width and the
# template's depth; 72 training rows a fold (a CV fold's), 18 validation and
# 22 test rows, B = 4, dropout on, f32.
GRID_MEM_CHUNKS = (1, 2, 4)
GRID_MEM_STEPS = 3
GRID_MEM_ROWS = (72, 18, 22)


def grid_memory_data(folds: int, steps: int) -> e2e_grid.E2EFoldData:
    """`folds` synthetic folds of GRID_MEM_ROWS, one epoch cut to `steps`."""
    n, v, t = GRID_MEM_ROWS
    data = e2e_grid.stack_e2e_folds(
        [(synthetic_split(n, SEED + f), synthetic_split(v, SEED + 10 + f),
          synthetic_split(t, SEED + 20)) for f in range(folds)], 1, 4, SEED)
    return dataclasses.replace(data, idx_all=data.idx_all[:, :, :steps],
                               msk_all=data.msk_all[:, :, :steps])


def grid_memory_run(plans, loader, data, chunk: int) -> dict:
    """One `run_e2e_grid` call: its peak device bytes over what was
    allocated before it, its wall time, its chunks and back-offs."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = []
    ms = wall_time_ms(lambda: res.append(e2e_grid.run_e2e_grid(
        plans, loader, data, num_epochs=1, seed=SEED, chunk=chunk, device="cuda")))
    return {"peak_bytes": torch.cuda.max_memory_allocated() - base,
            "wall_ms": ms, "chunks": [w for ws in res[0].chunks.values() for w in ws],
            "backoffs": res[0].backoffs, "results": res[0]}


def phase_e2e_grid_memory() -> dict:
    """The padded grid's memory on the card: the widest signature at chunks
    of 1, 2 and 4 combinations on one fold (GRID_MEM_STEPS steps and an
    evaluation), the bytes an instance from their slope; the auto chunk of
    each of the 10 signatures at 5 folds; then the widest signature at its
    auto chunk x 5 folds, which must not back off, its peak, and its ms a
    step from a run of twice the steps (the difference, so set-up and the
    evaluation drop out)."""
    cls = (64, 4)
    confs = [c for c in BASELINE_CONFS if e2e_grid._conf_class(c) == cls]
    members = {c: (ViTConfig.from_conf(c), VisionTransformer3D(
        ViTConfig.from_conf(c), device="cpu",
        generator=torch.Generator().manual_seed(c)).state_dict()) for c in confs}
    combos = list(itertools.combinations(confs, 3))
    one_fold = grid_memory_data(1, GRID_MEM_STEPS)
    by_chunk = {}
    for c in GRID_MEM_CHUNKS:
        run = grid_memory_run(combos[:c], members.__getitem__, one_fold, c)
        by_chunk[c] = run
        emit({"phase": "e2e_grid_memory", "card": card, "signature": [cls] * 3,
              "folds": 1, "chunk": c, "instances": c, "steps": GRID_MEM_STEPS,
              "peak_bytes": run["peak_bytes"], "wall_ms": run["wall_ms"],
              "backoffs": run["backoffs"]})
        check(run["backoffs"] == 0 and run["chunks"] == [c],
              f"e2e_grid_memory: chunk {c} ran as {run['chunks']}")
    lo, hi = GRID_MEM_CHUNKS[0], GRID_MEM_CHUNKS[-1]
    per_instance = (by_chunk[hi]["peak_bytes"] - by_chunk[lo]["peak_bytes"]) / (hi - lo)

    five = grid_memory_data(CLI_FOLDS, GRID_MEM_STEPS)
    five_long = grid_memory_data(CLI_FOLDS, 2 * GRID_MEM_STEPS)
    # as `run_e2e_grid` holds them on the device (the indices as int64)
    data_bytes = sum(a.nbytes for a in (five.vols, five.labels, five.val_vols,
                                        five.val_labels, five.val_mask, five.test_vols,
                                        five.msk_all)) + 2 * five.idx_all.nbytes
    budget = e2e_grid._chunk_budget(torch.device("cuda"), data_bytes)
    template = {k: dataclasses.replace(ViTConfig.from_conf(c), mlp_dim=3072,
                                       num_layers=8)
                for c in BASELINE_CONFS for k in [e2e_grid._conf_class(c)]}
    sigs = collections.Counter(e2e_grid.signature_of(e2e_grid.plan_combo(c))
                               for c in itertools.combinations(BASELINE_CONFS, 3))
    autos = {}
    for sig, n in sigs.items():
        inst = e2e_grid._instance_bytes([template[k] for k in sig], 4, False)
        autos[sig] = e2e_grid._auto_chunk(inst, CLI_FOLDS, budget)
        emit({"phase": "e2e_grid_auto_chunk", "card": card, "signature": sig,
              "combinations": n, "instance_bytes_estimate": inst,
              "auto_chunk": autos[sig], "chunks": -(-n // autos[sig]),
              "budget_bytes": budget})
    widest = (cls,) * 3
    plans = [combos[i % len(combos)] for i in range(autos[widest])]
    run = grid_memory_run(plans, members.__getitem__, five, 0)
    long = grid_memory_run(plans, members.__getitem__, five_long, 0)
    total = torch.cuda.get_device_properties(0).total_memory
    steps_ms = (long["wall_ms"] - run["wall_ms"]) / GRID_MEM_STEPS
    instances = autos[widest] * CLI_FOLDS
    line = {"phase": "e2e_grid_memory_auto", "card": card, "signature": widest,
            "auto_chunk": autos[widest], "folds": CLI_FOLDS, "instances": instances,
            "peak_bytes": run["peak_bytes"], "peak_bytes_long": long["peak_bytes"],
            "device_bytes": total, "budget_bytes": budget,
            "measured_bytes_per_instance_one_fold": per_instance,
            "estimated_bytes_per_instance": e2e_grid._instance_bytes(
                [template[cls]] * 3, 4, False),
            "wall_ms": [run["wall_ms"], long["wall_ms"]],
            "ms_per_step": steps_ms, "instance_steps_per_s": instances * 1e3 / steps_ms,
            # an extrapolation: the 816 x 5 x 100-epoch grid (18 steps an
            # epoch at 72 rows) at this rate, evaluations and set-up left out
            "full_grid_hours_extrapolated": 816 * CLI_FOLDS * 100 * 18
            / (instances * 1e3 / steps_ms) / 3600,
            "chunks": [run["chunks"], long["chunks"]],
            "backoffs": run["backoffs"] + long["backoffs"],
            "finite": all(math.isfinite(v) for r in run["results"].values()
                          for m in r.values() for v in m.values())}
    emit(line)
    check(line["backoffs"] == 0 and run["chunks"] == long["chunks"] == [autos[widest]]
          and line["finite"], f"e2e_grid_memory: the auto chunk: {line}")
    return {"per_instance_bytes": per_instance, "auto": line,
            "auto_chunks": {"_".join(f"{h}.{k}" for h, k in sig): a
                            for sig, a in autos.items()}}


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
    k1, k1_wide, k1_latency, k1_wide_f32, k1_narrow = phase_k1(gen)
    k1_scaled = phase_f32_scaled("seq", STRETCH_ROWS[1], 768, SEED + 3)
    # the narrow f32 body, K1's and K1c's, at the training path's 260 rows
    k1_narrow_scaled = phase_f32_scaled("seq", TRAIN_ROWS[0], 64, SEED + 8)
    k1c_scaled = phase_f32_scaled("pipelined2", TRAIN_ROWS[0], 64, SEED + 10)
    # the phases of the fused-FFN variants and the model axis draw from a
    # generator of their own, so the phases that follow draw what they drew
    own = torch.Generator(device="cuda").manual_seed(SEED + 1)
    k1_models, k1_wide_axis = phase_model_axis(own)
    k1_variants = phase_mlp_variants(own)
    k1_d8 = phase_k1_d8(torch.Generator(device="cuda").manual_seed(SEED + 14))
    conf22 = phase_conf22(torch.Generator(device="cuda").manual_seed(SEED + 15))
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
    # each from a generator of its own, so the phases that follow draw what
    # they drew before these
    vit_pre = phase_pretrained(torch.Generator(device="cuda").manual_seed(SEED + 5))
    hybrid = phase_hybrid(torch.Generator(device="cuda").manual_seed(SEED + 6))
    vit_h = phase_vit_h(torch.Generator(device="cuda").manual_seed(SEED + 7))
    wide_axis = phase_wide_axis(torch.Generator(device="cuda").manual_seed(SEED + 11))
    widths = phase_widths(torch.Generator(device="cuda").manual_seed(SEED + 9))
    torch.cuda.empty_cache()
    widest = phase_widest(torch.Generator(device="cuda").manual_seed(SEED + 13))
    quant_res = phase_quant(gen)
    train = phase_train()
    train_ens = phase_train_ensemble()
    sweep = phase_sweep()
    remat = phase_remat()
    cli = phase_cli()
    grid_memory = phase_e2e_grid_memory()
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
                      "pretrained": vit_pre["auto"]["launches"][name],
                      "pretrained_layer": vit_pre["layer"]["launches"][name],
                      "pretrained_f32": vit_pre["f32"]["launches"][name],
                      "hybrid": hybrid["auto"]["launches"][name],
                      "hybrid_layer": hybrid["layer"]["launches"][name],
                      "hybrid_f32": hybrid["f32"]["launches"][name],
                      "hybrid_f32_backward": hybrid["grad_launches"][name],
                      "vit_h": vit_h["auto"]["launches"][name],
                      "vit_h_layer": vit_h["layer"]["launches"][name],
                      "vit_h_f32": vit_h["f32"]["launches"][name],
                      # the widest gate model: bf16 at B=2, f32 at B=1
                      "widest": widest["auto"]["launches"][name],
                      "widest_layer": widest["layer"]["launches"][name],
                      "widest_f32": widest["f32"]["launches"][name],
                      "widest_f32_layer": widest["f32_layer"]["launches"][name],
                      # the stacked stretch members under each variant, and
                      # the single stretch and ViT-H-width models under K1b
                      # and K1c
                      **{f"wide_axis_{dt}{v}": wide_axis[f"{dtn}_{v}"]["launches"][name]
                         for v in VARIANT_KERNELS
                         for dt, dtn in (("", "bfloat16"), ("f32_", "float32"))},
                      **{f"{model}_{v}": res[v]["launches"][name]
                         for model, res in (("stretch", stretch), ("vit_h", vit_h),
                                            ("widest", widest))
                         for v in ("chunked", "pipelined2")},
                      # conf 22's bf16 pass (D 8) at B = 8 and 512
                      **{f"conf22_b{b}": conf22[b]["launches"][name] for b in conf22},
                      "sweep": sweep["launches"][name],
                      "remat": remat["launches"][name],
                      "cli": cli["launches"][name],
                      # every rank's, summed (`mesh_launches_by_rank` below)
                      "mesh": cli["mesh"]["launches"][name]}
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

    def vit_b16_case(case, path, name="K1"):
        """A case at ViT-B/16's (or ViT-H's) shapes, with the launches of its
        model's bf16 path (f32: the B=1 forward's) and the body it ran on."""
        if case["dtype"] == "float32":
            path = path.removesuffix("_layer") + "_f32"
        return {**case_of(case), "body": case["body"],
                "launches": by_path[name][path], "launches_path": path}

    def k1b_f32_case(case):
        """A K1b f32 case with its error over the gate and its other bounds."""
        return {**case_of(case), "max_err_over_gate": case["max_err_over_gate"],
                "bound_ms_cuda_cores": case["bound_ms_cuda_cores"],
                "bound_ms_mma_sync": case["bound_ms_mma_sync"]}

    def wide_axis_of(variant):
        """The stacked pass's numbers under one variant, both types."""
        return {dt: {k: wide_axis[f"{dt}_{variant}"][k] for k in (
            "body", "B", "logits_max_abs_err", "wall_ms", "device_busy_ms",
            "device_idle_share", "mlp_device_ms", "k1_mlp_device_ms", "queue", "kernels",
            "launches") if k in wide_axis[f"{dt}_{variant}"]}
            for dt in ("bfloat16", "float32")}

    def narrow_case(case, path=None):
        """A case of the narrow f32 body (K1's or K1c's): its bounds, body,
        plan and whether two calls gave the same bits."""
        return {**k1b_f32_case(case), **({"launches": by_path["K1"][path]} if path else {}),
                **{k: case[k] for k in ("body", "k1c_body", "plan", "same_bits_twice")}}

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
            # its narrow f32 body (3xTF32 on wgmma, the hidden columns split
            # across a cluster) by device time beside the chain's, at the
            # training path's 260 rows and at 4,160, and with x four times
            # larger against the f64 MLP
            narrow_f32_cases=[narrow_case(c) for c in k1_narrow],
            narrow_f32_scaled_max_err_over_gate=k1_narrow_scaled["max_err_over_gate"],
            model_axis_case=narrow_case(k1_models, "sweep"),
            # f32 at every shape the baseline drivers gave it, by device time
            cli_cases=[narrow_case(c) for c in cli["cases"]["K1"]],
            # its wide bodies at ViT-B/16's 65 tokens (the npz-initialised
            # model) and 321 (the R50 hybrid): bf16 at B=8, f32 at B=1
            pretrained_cases=[vit_b16_case(c, "pretrained") for c in vit_pre["cases"]["K1"]],
            hybrid_cases=[vit_b16_case(c, "hybrid") for c in hybrid["cases"]["K1"]],
            # its wide bodies at ViT-H's D 1,280, M 5,120, 513 tokens: bf16
            # at B=8, f32 at B=1; and the sweep over hidden sizes 24-8,192
            vit_h_cases=[vit_b16_case(c, "vit_h") for c in vit_h["cases"]["K1"]],
            width_sweep=widths["K1"],
            # its wide bodies at the widest gate model's D 12,288, M 49,152,
            # 513 tokens: bf16 at B=2, f32 at B=1
            widest_cases=[vit_b16_case(c, "widest") for c in widest["cases"]["K1"]],
            # bf16 at D 8 (the pipeline's D = 8 instance, the hidden columns
            # split across a cluster) at conf 22's FFN, and conf 22's pass
            d8_cases=[{**case_of(c), "body": c["body"], "plan": c["plan"]}
                      for c in k1_d8["seq"]],
            conf22={b: {k: r[k] for k in (
                "k1_launches_a_pass", "k1_body", "ms_per_batch", "device_busy_ms",
                "k1_device_ms", "k1_share_of_busy", "device_idle_share",
                "tokens_max_abs_err")} for b, r in conf22.items()},
            # its wide bodies with the model axis: the cases of
            # `wide_cases`, and the five stacked stretch members' pass
            model_axis_wide_cases=k1_wide_axis, wide_axis=wide_axis_of("seq")),
        row("K1b", "vit3d_ensemble_tpu_torch/csrc/mlp_chunked.cu",
            "vit3d_ensemble_tpu/ops/pallas_mlp.py:126", k1_variants["chunked"],
            "variants_chunked",
            # bf16 at D 16-64 on K1c's wgmma pipeline (`mlp_pipeline.cuh`),
            # fc2 summed chunk by chunk: device time at the serving shape
            # beside K1's on the same inputs and the chain's
            body=k1_variants["chunked"]["body"],
            device_ms=k1_variants["chunked"]["device_ms"],
            k1_device_ms=k1_variants["chunked"]["k1_device_ms"],
            library_device_ms=k1_variants["chunked"]["library_device_ms"],
            # its f32 body (3xTF32 on mma.sync) at the model axis and at the
            # serving shape, with the three bounds, and with x four times
            # larger against the f64 MLP
            model_axis_case=k1b_f32_case(k1_variants["chunked_model_axis"]),
            f32_case=k1b_f32_case(k1_variants["chunked_f32"]),
            f32_scaled_max_err_over_gate=k1b_scaled["max_err_over_gate"],
            # its wide bodies (K1's, fc2 summed chunk by chunk) with the
            # model axis, over the sweep of hidden sizes, on the stacked
            # stretch members and the single stretch and ViT-H-width models
            wide_cases=k1_variants["chunked_wide"], width_sweep=widths["K1b"],
            wide_axis=wide_axis_of("chunked"),
            # the widest gate model's pass under K1b (D 12,288)
            widest_launches=by_path["K1b"]["widest_chunked"],
            d8_cases=[{**case_of(c), "body": c["body"], "plan": c["plan"]}
                      for c in k1_d8["chunked"]]),
        row("K1c", "vit3d_ensemble_tpu_torch/csrc/mlp_pipelined.cu",
            "vit3d_ensemble_tpu/ops/pallas_mlp.py:142", k1_variants["pipelined2"],
            "variants_pipelined2",
            device_ms=k1_variants["pipelined2"]["device_ms"],
            library_device_ms=k1_variants["pipelined2"]["library_device_ms"],
            plan=k1c_plan(*K1C_PLAN_CASES[0]),
            # f32 on K1's narrow body, on K1c's row-tile groups
            model_axis_case=narrow_case(k1_variants["pipelined2_model_axis"]),
            f32_scaled_max_err_over_gate=k1c_scaled["max_err_over_gate"],
            # its wide queue (fc1 of row tile i + L ahead of fc2 of row
            # tile i, taken by ticket, one launch) with the model axis, over
            # the sweep of hidden sizes, and on the stacked stretch members
            wide_cases=k1_variants["pipelined2_wide"], width_sweep=widths["K1c"],
            wide_plan=k1c_wide_plan(*K1C_WIDE_PLAN_CASES[0]),
            wide_axis=wide_axis_of("pipelined2"),
            widest_launches=by_path["K1c"]["widest_pipelined2"],
            d8_cases=[{**case_of(c), "body": c["body"], "plan": c["plan"]}
                      for c in k1_d8["pipelined2"]],
            widest_plan=k1c_wide_plan(WIDEST_B * WIDEST_TOKENS, WIDEST_WIDTHS["hidden_size"],
                                      WIDEST_WIDTHS["mlp_dim"], 1, torch.bfloat16)),
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
        # path's conf 9: head_dim 1) and on K4's above (its sliced bodies
        # above 256)
        row("K3", "vit3d_ensemble_tpu_torch/csrc/tiny_attention.cu",
            "vit3d_ensemble_tpu/ops/pallas_attention_layer.py:69", k3,
            "train_layer",
            sources={"head_dim <= 16": "vit3d_ensemble_tpu_torch/csrc/tiny_attention.cu",
                     "head_dim above 16": "vit3d_ensemble_tpu_torch/csrc/attention.cu"},
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
                                  by_path["K3_on_K4"]["stretch_f32_layer"]},
            # bf16 at B=8 at ViT-B/16's 65 and 321 tokens, on K4's body
            pretrained_cases=[vit_b16_case(c, "pretrained_layer", "K3")
                              for c in vit_pre["cases"]["K3"]],
            hybrid_cases=[vit_b16_case(c, "hybrid_layer", "K3")
                          for c in hybrid["cases"]["K3"]],
            # bf16 at B=8 at ViT-H's head_dim 80 on K4's body; the sweep
            # over head dims 20-256
            vit_h_cases=[vit_b16_case(c, "vit_h_layer", "K3")
                         for c in vit_h["cases"]["K3"]],
            width_sweep=widths["K3"],
            # bf16 at B=2 at the widest gate model's head_dim 512, on K4's
            # sliced body
            widest_cases=[vit_b16_case(c, "widest_layer", "K3")
                          for c in widest["cases"]["K3"]]),
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
                          by_path["K3_on_K4"]["stretch_f32_layer"]},
            # at ViT-B/16's 65 and 321 tokens: bf16 at B=8, f32 at B=1
            pretrained_cases=[vit_b16_case(c, "pretrained", "K4")
                              for c in vit_pre["cases"]["K4"]],
            hybrid_cases=[vit_b16_case(c, "hybrid", "K4")
                          for c in hybrid["cases"]["K4"]],
            # at ViT-H's head_dim 80, 513 tokens: bf16 at B=8, f32 at B=1;
            # the sweep over head dims 20-256
            vit_h_cases=[vit_b16_case(c, "vit_h", "K4")
                         for c in vit_h["cases"]["K4"]],
            width_sweep=widths["K4"],
            # its bodies: the unsliced bf16 and f32 ones (head_dim 17-256) and
            # their sliced forms (above 256), at the widest gate model's head
            # dim 512, 513 tokens: bf16 at B=2, f32 at B=1, with SDPA's
            # backend there
            bodies=list(fused_attention.K4_BODIES),
            widest_cases=[{**vit_b16_case(c, "widest", "K4"),
                           "library_backend": c["library_backend"]}
                          for c in widest["cases"]["K4"]]),
    ], "variants_volumes_per_s": {v: r["volumes_per_s"]
                                  for v, r in variants.items()},
        "training": {"train": train["timing"],
                     "train_ensemble": train_ens["timing"]},
        "sweep": {**sweep["groups"], "dropout": sweep["dropout"]},
        "remat": {k: v for k, v in remat.items() if k != "launches"},
        "cli": cli["runs"],
        "mesh": {k: v for k, v in cli["mesh"].items() if k != "launches"},
        "quant": {"models_logits_max_abs_dev": quant_res["models"],
                  "stretch": {impl: {k: r[k] for k in (
                      "ms_per_batch", "volumes_per_s", "device_busy_ms",
                      "logits_max_abs_dev_vs_none", "int8_products")}
                      for impl, r in quant_res["stretch"].items()}},
        "e2e_grid_memory": {k: v for k, v in grid_memory.items() if k != "auto"},
        "stretch": {impl: {k: v for k, v in res.items() if k != "launches"}
                    for impl, res in stretch.items()},
        "vit_b16": {model: {impl: {k: res[impl][k] for k in (
            "ms_per_batch", "volumes_per_s", "device_busy_ms", "device_idle_share",
            "kernels")} for impl in ("auto", "layer")}
            for model, res in (("pretrained", vit_pre), ("hybrid", hybrid))},
        "wide_axis": {k: {m: r[m] for m in ("wall_ms", "device_busy_ms",
                                             "device_idle_share", "kernels")}
                      for k, r in wide_axis.items()},
        "widest": {"parameters": widest["parameters"],
                   **{f"f32_{impl}": {k: widest[key][k] for k in (
                       "device_busy_ms", "wall_ms", "device_idle_share", "kernels",
                       "max_abs_err") if k in widest[key]}
                      for impl, key in (("auto", "f32"), ("layer", "f32_layer"))},
                   **{impl: {k: widest[impl][k] for k in (
                       "ms_per_batch", "volumes_per_s", "device_busy_ms",
                       "device_idle_share", "kernels", "tokens_max_abs_err")}
                      for impl in ("auto", "layer")},
                   **{v: {k: widest[v][k] for k in (
                       "ms_per_batch", "device_busy_ms", "device_idle_share", "kernels",
                       "tokens_max_abs_err")} for v in ("chunked", "pipelined2")}},
        "vit_h": {"parameters": vit_h["parameters"],
                  "f32_device_busy_ms": vit_h["f32"]["device_busy_ms"],
                  **{impl: {k: vit_h[impl][k] for k in (
                      "ms_per_batch", "volumes_per_s", "device_busy_ms",
                      "device_idle_share", "kernels", "tokens_max_abs_err")}
                     for impl in ("auto", "layer")}},
        "hybrid_stem_device_busy_ms": hybrid["stem_device_busy_ms"],
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

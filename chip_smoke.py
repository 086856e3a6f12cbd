#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `vit3d_ensemble_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, and drives the port's
two paths, each with the kernels' launch counters set to 0 just before it
and read just after:

  * serving: all 18 baseline ViTs in bf16 at B=512, then batch-1..8 latency
    of conf 9 and of the {5,9,11} stacking ensemble (K1, K2);
  * training, in f32: `train_baseline` on conf 9 at full width and depth
    under the attention impls `auto` (K2, K1 in evaluation) and `layer`
    (K3), and `train_ensemble` on {5,9,11} under `layer`; with dropout off,
    each kernel run is held to the same run on the plain modules.

Every line it prints is a JSON object.  The last is
`{"ok": true, "device": {...}}`; it is printed only when every check
passed.  The script exits non-zero, printing no result, when no CUDA device
is present or any check fails.  It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vit3d_ensemble_tpu_torch.configs import BASELINE_CONFS, BEST_ENSEMBLE, ViTConfig
from vit3d_ensemble_tpu_torch.data import SplitArrays
from vit3d_ensemble_tpu_torch.models import TransformerEnsemble, VisionTransformer3D
from vit3d_ensemble_tpu_torch.ops import (
    _build,
    attention,
    attention_layer,
    fused_attention,
    fused_mlp,
)
from vit3d_ensemble_tpu_torch.ops import mlp as mlp_select
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
PEAK_BYTES = 3.35e12

# Kernel against plain version: the JAX package's own tolerances
# (`tests/test_pallas_mlp.py:31,47`, `tests/test_ops.py:31`).  Both sides
# accumulate in f32 and round at the same points, so they differ by the
# order of f32 sums and by bf16 rounding flips that order causes.
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (0.05, 0.05)}
# The serving path in bf16, kernels against the plain modules: the plain
# MLP and einsum attention round to bf16 after every op, the kernels only
# at the JAX kernels' points; over up to 8 pre-LN layers that leaves a few
# bf16 ulps (0.03 at |t| = 4) on the normalised tokens.
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

#: Each kernel's wrapper module, whose `launches` counts its launches.
KERNELS = {"K1": fused_mlp, "K2": fused_attention, "K3": attention_layer}

failures: list = []
#: the card's name and power limit, as nvidia-smi gives them, set by main()
card = ""


T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line, stamped with the seconds since the start."""
    print(json.dumps({**obj, "t": round(time.perf_counter() - T0, 3)}),
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


def bound(flops: float, nbytes: float, dtype) -> tuple:
    by_ops = flops / PEAK_FLOPS[dtype]
    by_bytes = nbytes / PEAK_BYTES
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def compare(out, ref, dtype) -> tuple:
    atol, rtol = TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()), ok, atol, rtol


def reset_launches() -> None:
    for module in KERNELS.values():
        module.launches = 0


def launches() -> dict:
    return {name: module.launches for name, module in KERNELS.items()}


def smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    return {"entries": len(regs), "max_registers": max(regs, default=None),
            "spill_store_bytes": sum(spills)}


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build(["fused_mlp", "tiny_attention", "attention_layer"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_flags": " ".join(_build.NVCC_FLAGS),
          "ptxas": {name: ptxas_summary(log) for name, log in logs.items()}})


# The training path's shapes, in f32: token rows of a batch of 4 volumes
# (260, the train forwards with dropout off) and of the 24 validation
# volumes (1,560, every evaluation); both leave a partial last row tile.
TRAIN_ROWS = (4 * 65, 24 * 65)
# (D, M) of the trained configs: conf 9 (16, 2048), conf 5 (32, 2048),
# conf 11 (32, 3072); training runs every column (no width mask).
K1_TRAIN_WIDTHS = ((16, 2048), (32, 2048), (32, 3072))


def k1_case(gen, dtype, N: int, D: int, M: int, active: int,
            path: str) -> dict:
    """K1 against its plain version on one shape, timed."""
    bound_w = (6.0 / (D + M)) ** 0.5
    x = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
    w1 = ((torch.rand(M, D, generator=gen, device="cuda") * 2 - 1)
          * bound_w).to(dtype)
    b1 = (torch.randn(M, generator=gen, device="cuda") * 0.02).to(dtype)
    w2 = ((torch.rand(D, M, generator=gen, device="cuda") * 2 - 1)
          * bound_w).to(dtype)
    b2 = (torch.randn(D, generator=gen, device="cuda") * 0.02).to(dtype)
    w1a, b1a = w1[:active], b1[:active]
    w2a = w2[:, :active].contiguous()
    with torch.no_grad():
        out = fused_mlp.fused_mlp(x, w1, b1, w2, b2, active)
        ref = fused_mlp._plain_mlp(x, w1, b1, w2, b2, active)
        err, ok, atol, rtol = compare(out, ref, dtype)
        ms = time_ms(lambda: fused_mlp.fused_mlp(x, w1, b1, w2, b2, active), 20)
        plain_ms = time_ms(lambda: fused_mlp._plain_mlp(
            x, w1, b1, w2, b2, active), 5)
        library_ms = time_ms(lambda: F.linear(
            F.gelu(F.linear(x, w1a, b1a)), w2a, b2), 20)
    elt = x.element_size()
    bound_ms, bound_by = bound(
        4.0 * N * D * active,
        elt * (2 * N * D + 2 * D * active + active + D), dtype)
    case = {"phase": "K1", "path": path, "dtype": str(dtype).split(".")[1],
            "N": N, "D": D, "M": M, "active": active,
            "max_abs_err": err, "atol": atol, "rtol": rtol,
            "ok": ok, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
    emit(case)
    check(ok, f"K1 {case}")
    return case


def phase_k1(gen) -> dict:
    """K1 against its plain version at the serving path's shapes, then at
    the training path's."""
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        for D in (16, 32, 64):
            for M in (2048, 3072):
                for active in (M, M - 1000):
                    case = k1_case(gen, dtype, B * 65, D, M, active, "serve")
                    if (dtype, D, M, active) == (torch.bfloat16, 64, 3072, 3072):
                        main = case
    for N in TRAIN_ROWS:
        for D, M in K1_TRAIN_WIDTHS:
            k1_case(gen, torch.float32, N, D, M, M, "train")
    return main


# (H, hd) of the trained configs: conf 9 (16, 1), conf 5 and 11 (8, 4).
K2_TRAIN_HEADS = ((16, 1), (8, 4))


def k2_case(gen, dtype, nb: int, H: int, hd: int, path: str) -> dict:
    """K2 against its plain version on one shape, timed."""
    S = 65
    q, k, v = (torch.randn(nb, H, S, hd, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    with torch.no_grad():
        out = fused_attention.fused_attention(q, k, v)
        ref = fused_attention._plain_attention(q, k, v)
        err, ok, atol, rtol = compare(out, ref, dtype)
        ms = time_ms(lambda: fused_attention.fused_attention(q, k, v), 50)
        plain_ms = time_ms(lambda: fused_attention._plain_attention(q, k, v), 10)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 50)
    bh = nb * H
    bound_ms, bound_by = bound(4.0 * bh * S * S * hd,
                               4.0 * bh * S * hd * q.element_size(), dtype)
    case = {"phase": "K2", "path": path, "dtype": str(dtype).split(".")[1],
            "B": nb, "H": H, "S": S, "hd": hd, "max_abs_err": err,
            "atol": atol, "rtol": rtol, "ok": ok, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}
    emit(case)
    check(ok, f"K2 {case}")
    return case


def phase_k2(gen) -> dict:
    """K2 against its plain version at the serving path's shapes, then at
    the training path's (a batch of 4, the 24 validation volumes)."""
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        for H, hd in ((4, 16), (8, 4), (16, 1)):
            case = k2_case(gen, dtype, B, H, hd, "serve")
            if (dtype, hd) == (torch.bfloat16, 16):
                main = case
    for nb in (4, 24):
        for H, hd in K2_TRAIN_HEADS:
            k2_case(gen, torch.float32, nb, H, hd, "train")
    return main


# K3 at (B, T, D, H): conf 1-18's (D, H) classes at B=512, conf 19-22's at
# B=64 (p=8: 257 tokens), the stretch model at B=2; then the training
# path's own shapes in f32: conf 9 (D=16, H=16) at the batch of 4 and at
# the 24 validation volumes, and conf 5/11's class at 4.
K3_CASES = ((512, 65, 64, 4), (512, 65, 32, 8), (512, 65, 16, 16),
            (64, 257, 16, 4), (64, 257, 8, 8), (2, 513, 768, 12))
K3_TRAIN_CASES = ((4, 65, 16, 16), (24, 65, 16, 16), (4, 65, 32, 8),
                  (24, 65, 32, 8))


def phase_k3(gen) -> dict:
    """K3 against its plain version; SDPA on the same q, k, v views is the
    library yardstick (the port never calls it)."""
    main = None
    cases = [(dtype, shape) for dtype in (torch.bfloat16, torch.float32)
             for shape in K3_CASES]
    cases += [(torch.float32, shape) for shape in K3_TRAIN_CASES]
    for dtype, (nb, T, D, H) in cases:
        qkv = torch.randn(nb, T, 3 * D, generator=gen, device="cuda").to(dtype)
        q, k, v = attention_layer._split(qkv)
        heads = [t.unflatten(-1, (H, D // H)).transpose(1, 2) for t in (q, k, v)]
        with torch.no_grad():
            out = attention_layer.attention_core(q, k, v, H)
            ref = attention_layer._plain_attention_core(q, k, v, H)
            err, ok, atol, rtol = compare(out, ref, dtype)
            ms = time_ms(lambda: attention_layer.attention_core(q, k, v, H), 50)
            plain_ms = time_ms(
                lambda: attention_layer._plain_attention_core(q, k, v, H), 10)
            library_ms = time_ms(
                lambda: F.scaled_dot_product_attention(*heads), 50)
        bound_ms, bound_by = bound(4.0 * nb * T * T * D,
                                   4.0 * nb * T * D * qkv.element_size(), dtype)
        case = {"phase": "K3", "dtype": str(dtype).split(".")[1], "B": nb,
                "T": T, "D": D, "H": H, "hd": D // H, "max_abs_err": err,
                "atol": atol, "rtol": rtol, "ok": ok, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
        emit(case)
        check(ok, f"K3 {case}")
        if (dtype, (nb, T, D, H)) == (torch.float32, K3_TRAIN_CASES[0]):
            main = case
    return main


def k4_yardstick(gen) -> dict:
    """K4 is not ported: its bound and SDPA's time at its shape, the
    stretch model's attention (B=2, H=12, S=513, hd=64) in bf16."""
    nb, H, S, hd = 2, 12, 513, 64
    q, k, v = (torch.randn(nb, H, S, hd, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 50)
    bound_ms, bound_by = bound(4.0 * nb * H * S * S * hd,
                               4.0 * nb * H * S * hd * q.element_size(),
                               torch.bfloat16)
    case = {"phase": "K4_yardstick", "dtype": "bfloat16", "B": nb, "H": H,
            "S": S, "hd": hd, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
    emit(case)
    return case


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
    }
    for name, (kernel, plain, args) in cases.items():
        grads, cotangent = [], None
        for fn in (kernel, plain):
            leaves = [a.detach().clone().requires_grad_() for a in args]
            out = fn(*leaves)
            if cotangent is None:
                cotangent = torch.randn(out.shape, generator=gen,
                                        device="cuda")
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


def timed_passes(models, x) -> tuple:
    """ITERS calls of each model in turn: host seconds around the whole run,
    ending in a synchronize, and device ms per call of each model."""
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(models) + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i, model in enumerate(models):
        for _ in range(ITERS):
            model(x)
        events[i + 1].record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    per_model = {c: events[i].elapsed_time(events[i + 1]) / ITERS
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
        emit({"phase": "main_path", "card": card, "B": B, "iters": ITERS,
              "seconds": seconds, "volumes_per_s": B * ITERS / seconds,
              "volumes_per_s_repeats": [B * ITERS / s for s in repeats],
              "launches": counts, "expected_launches": expected,
              "ms_per_pass_by_conf": per_model, "after_run": clocks})
        for name, n in counts.items():
            want = 0 if name == "K3" else expected
            check(n == want, f"{name} launched {n} times, expected {want}")

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
KERNEL_GROUPS = (("K1", "fused_mlp"), ("K2", "tiny_attention"),
                 ("K3", "attention_layer"),
                 ("layer_norm", "layer_norm"), ("cat", "CatArray"),
                 ("gemm", "nvjet"), ("gemm", "gemm"), ("gemm", "cutlass"),
                 ("optimizer", "multi_tensor"), ("softmax", "softmax"),
                 ("reduce", "reduce_kernel"), ("elementwise", "elementwise"))


def device_time(fn, host_ops: bool = True) -> tuple:
    """Kernel time on the device (ms) of one call of `fn` under
    torch.profiler, in total and by group.  Kernels of one stream do not
    overlap, so their sum is the time the device was busy.  `host_ops=False`
    records the device's kernels alone, which costs the host far less on a
    run of many small steps."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    groups: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = next((g for g, pat in KERNEL_GROUPS if pat in e.key), "other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    return sum(groups.values()), groups


def phase_profile(main_path: dict, gen) -> None:
    """Device busy share of the main path and of B=1 serving: device time of
    one call under the profiler over the wall time of the same work measured
    without it (the profiler slows the host, not the kernels)."""
    models, x = main_path["models"], main_path["x"]

    def one_pass():
        for model in models:
            model(x)

    with torch.no_grad():
        busy, groups = device_time(one_pass)
    wall = main_path["ms_per_pass"]
    emit({"phase": "profile", "card": card, "work": "18-model pass, B=512",
          "device_busy_ms": busy, "wall_ms": wall,
          "device_idle_share": 1.0 - busy / wall, "by_group_ms": groups})
    check(busy > 0, "profiler saw no device time on the main path")
    xb = torch.randn(1, 128, 128, 5, 1, generator=gen,
                     device="cuda").to(torch.bfloat16)
    model = models[BASELINE_CONFS.index(9)]
    with torch.no_grad():
        res, _ = latency(model, xb, 1)
        busy, groups = device_time(lambda: model(xb))
    emit({"phase": "profile", "card": card, "work": "conf 9, B=1",
          "device_busy_ms": busy, "wall_ms": res["ms_per_batch"],
          "device_idle_share": 1.0 - busy / res["ms_per_batch"],
          "by_group_ms": groups})


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
            res, out = latency(model, x, batch)
            out = out.logits if name == "conf9" else out
            ok = tuple(out.shape) == (batch, 1) and bool(torch.isfinite(out).all())
            emit({"phase": "latency", "card": card, "model": name,
                  "B": batch, **res, "ok": ok})
            check(ok, f"latency {name} B={batch}: output {tuple(out.shape)}")


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
                  impls) -> dict:
    """Drive one trainer under each kernel impl in `impls`, dropout on and
    off, and under `plain` with dropout off, with the launch counters read
    around each run; check finite losses, the launch counts, and with
    dropout off each kernel run against the plain run.  Then time each impl
    (in turns: a, b, b, a) and take its device busy time."""
    forwards = steps + evals + 1           # + the end-of-run evaluation
    # with dropout on, K1 serves only the deterministic (evaluation)
    # forwards; with it off, every forward
    k1 = {True: layers * (evals + 1), False: layers * forwards}
    attn = {"auto": "K2", "layer": "K3"}
    expect = {(impl, dropout): {"K1": k1[dropout], "K2": 0, "K3": 0,
                                attn[impl]: layers * forwards}
              for impl in impls for dropout in (True, False)}
    expect[("plain", False)] = {"K1": 0, "K2": 0, "K3": 0}
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
            busy, groups = device_time(lambda: run(True, short=True),
                                       host_ops=False)
        finally:
            set_impls("auto")
        check(busy > 0, f"{name} {impl}: the profiler saw no device time")
        timing[impl] = {"ms_per_step": [w / steps for w in walls[impl]],
                        "short_run_wall_ms": short_ms,
                        "short_run_device_busy_ms": busy,
                        "device_idle_share": 1.0 - busy / short_ms}
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
                         TRAIN_STEPS // EVAL_EVERY, ("auto", "layer"))


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
                         ("layer",))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    global card
    card = smi("name,power.limit")
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1 = phase_k1(gen)
    k2 = phase_k2(gen)
    k3 = phase_k3(gen)
    k4 = k4_yardstick(gen)
    phase_gradients(gen)
    phase_f32_model(gen)
    main_path = phase_main_path(gen)
    phase_profile(main_path, gen)
    phase_latency(gen)
    train = phase_train()
    train_ens = phase_train_ensemble()
    by_path = {name: {"serve": main_path["launches"][name],
                      "train_layer": train["launches"][name],
                      "train_ensemble_layer": train_ens["launches"][name]}
               for name in KERNELS}

    def row(name, source, replaces, case, path):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": by_path[name][path],
                "path": path, "launches_by_path": by_path[name],
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"], "library_ms": case["library_ms"],
                "shape": {k: case[k] for k in case
                          if k in ("dtype", "N", "D", "M", "active", "B", "H",
                                   "S", "T", "hd")}}

    emit({"kernels": [
        row("K1", "vit3d_ensemble_tpu_torch/csrc/fused_mlp.cu",
            "vit3d_ensemble_tpu/ops/pallas_mlp.py:87", k1, "serve"),
        row("K2", "vit3d_ensemble_tpu_torch/csrc/tiny_attention.cu",
            "vit3d_ensemble_tpu/ops/pallas_attention.py:46", k2, "serve"),
        row("K3", "vit3d_ensemble_tpu_torch/csrc/attention_layer.cu",
            "vit3d_ensemble_tpu/ops/pallas_attention_layer.py:69", k3,
            "train_layer"),
    ], "not_ported": [
        # K1b and K1c compute K1's function: K1's bound and library time
        {"name": "K1b", "replaces": "vit3d_ensemble_tpu/ops/pallas_mlp.py:126",
         **{k: k1[k] for k in ("bound_ms", "bound_by", "library_ms")}},
        {"name": "K1c", "replaces": "vit3d_ensemble_tpu/ops/pallas_mlp.py:142",
         **{k: k1[k] for k in ("bound_ms", "bound_by", "library_ms")}},
        {"name": "K4", "replaces": "vit3d_ensemble_tpu/ops/pallas_attention.py:118",
         **{k: k4[k] for k in ("bound_ms", "bound_by", "library_ms")}},
    ], "training": {"train": train["timing"],
                    "train_ensemble": train_ens["timing"]},
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

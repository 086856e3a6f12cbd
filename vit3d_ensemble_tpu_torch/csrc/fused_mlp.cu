// K1: fused FFN, out = gelu(x @ w1^T + b1)[:, :active] @ w2[:, :active]^T + b2.
//
// Replaces the TPU kernel `vit3d_ensemble_tpu/ops/pallas_mlp.py:_mlp_kernel`
// (reached through `fused_mlp` -> `_fused_mlp_impl`, variant "seq").
//
// The narrow regime, D in {8, 16, 32, 64} (every registry config's), in
// f32: the body in `mlp_narrow_f32.cuh` (`narrow_tf32x3`), shared with K1c:
// both products in 3xTF32 on `wgmma`, the hidden columns split across the
// blocks of a thread-block cluster whose partial sums meet in distributed
// shared memory; its note says what bounds it and how it is laid out.  It
// replaced a CUDA-core body (64-row blocks each walking all of M on FFMAs),
// which lost to F.linear -> F.gelu -> F.linear at the drivers' one-model
// shapes (PERF.md).  bf16 in the narrow regime is not here: the wrapper
// (`ops/fused_mlp.py`) sends those calls to K1c's library
// (`mlp_pipelined.cu`), which computes this function: its warp-specialised
// wgmma pipeline at D 16-64 (an earlier mma.sync body of 64-row blocks lost
// to it at every row count timed, 1 to 33,280, and was removed), at D = 8
// its D = 8 instance with the hidden columns split across a cluster.  A
// narrow D outside that set runs zero-padded to the next of them
// (`kernel_width`).
//
// The wide regime, every D above 64 (the stretch model's D = 768, M =
// 3072; ViT-H's D = 1,280, M = 5,120), as the TPU kernel takes any D,
// with the model axis: the bodies in `mlp_wide.cuh`, shared with K1b and
// K1c, whose note says what bounds them and how they are laid out: two GEMM
// phases with h through an L2-resident scratch, in bf16 on `wgmma`
// (`wide_gemm_kernel`), in f32 in 3xTF32 on `wgmma` (`wide_tf32x3_kernel`).
// An earlier body kept the (rows, D) f32 accumulator on chip by cutting the
// tile to 32 rows, so every block streamed both 4.7 MB weight matrices out
// of L2 (~1.2 GB a call), unhidden, on mma.sync: 0.47 ms on an H100 against
// 0.09 for the library's linear -> gelu -> linear; a CUDA-core f32 body of
// 16-row tiles lost to the 3xTF32 one at every wide f32 shape of the card
// tests and the stretch path, from 1 to 4,104 rows (`chip_turns.py`,
// PERF.md).  Both are gone.
//
// Layouts follow torch.nn.Linear: x (n, D), w1 (m, D), b1 (m), w2 (D, m),
// b2 (D), out (n, D), all contiguous.  f32 or bf16, f32 accumulation.  The
// narrow bodies take D in {8, 16, 32, 64}; the wrapper runs a narrow D
// outside that set zero-padded to the next of them, as above.
//
// The model axis (the sweep's stacked (config, fold) cells), in both
// regimes: the bodies take P weight sets stacked along a leading axis, each
// model with its own width mask read from device memory (`mlp_common.cuh`,
// `Model`, and `mlp_wide.cuh`).

#include "mlp_narrow_f32.cuh"
#include "mlp_wide.cuh"

// K1's narrow f32 body (`mlp_narrow_f32.cuh`): n token rows a model,
// `models` weight sets (P >= 1), active_p the width mask of each model on the
// device or null for `active` in all, on `splits` x `groups` clusters a
// model (`fused_mlp.k1_narrow_f32_plan`; groups = ceil(n / 64), a row tile
// each).  d in {8, 16, 32, 64}.  Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for a shape or plan the body does
// not take (nothing launched).  n == 0 launches nothing.
extern "C" int fused_mlp_narrow_f32_launch(int device, const float* x, const float* w1,
                                           const float* b1, const float* w2, const float* b2,
                                           float* out, int n, int d, int m, int active,
                                           const int* active_p, int models, int splits,
                                           int groups, void* stream) {
  return (int)narrow_f32::launch(device, x, w1, b1, w2, b2, out, n, d, m, active, active_p,
                                 models, splits, groups, static_cast<cudaStream_t>(stream));
}

// The narrow f32 body's shape at hidden size d and `splits` blocks a
// cluster, as `narrow_f32::describe` lists it (7 ints).
extern "C" int fused_mlp_narrow_f32_shape(int device, int d, int splits, int* out) {
  return (int)narrow_f32::describe(device, d, splits, out);
}

// The bf16 wide regime (d > 64, a multiple of 8), with the model
// axis (`mlp_wide.cuh`): x (P, n, d), w1 (P, m, d), b1 (P, m), w2 (P, d,
// ld_w2) with ld_w2 m, or m rounded up to 8 for a zero-padded copy (TMA needs
// 16-byte row strides), b2 (P, d), h (P, n, ld_h) the scratch for gelu(fc1)
// with ld_h = m rounded up to 8, out (P, n, d); every base 16-byte aligned;
// active_p the width of each model on the device, or null for `active` in
// all.  Two launches on `stream`: fc1 + GELU into h, then fc2 + b2 from it.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a shape or layout it does not take (nothing launched).  n == 0
// launches nothing.
extern "C" int fused_mlp_wide_launch(int device, const void* x, const void* w1, const void* b1,
                                     const void* w2, int ld_w2, const void* b2, void* h,
                                     int ld_h, void* out, int n, int d, int m, int active,
                                     const int* active_p, int models, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide::wide_shape_ok(n, d, m, ld_w2, ld_h, models, 8)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return (int)wide::run_bf16<0>(device, x, w1, b1, w2, ld_w2, b2, h, ld_h, out, n, d, m, active,
                                active_p, models, static_cast<cudaStream_t>(stream));
}

// The f32 wide regime (d > 64, a multiple of 4), with the model
// axis: the operands of `fused_mlp_wide_launch` with ld_w2 and ld_h
// multiples of 4, and part, the scratch of the split phases' partial sums
// (max(min(splits1, 8) * ld_h, min(splits2, 8) * d) * P * n floats, the
// ones of a phase that splits; may be null when neither does).  fc1 + GELU
// into h on blocks1 blocks in splits1 K splits, then fc2 + b2 on blocks2
// blocks in splits2 K splits (`fused_mlp.wide_f32_plan` lays both out); a
// split phase runs in waves of at most 8 splits, each a launch and a
// second launch that adds its splits, in order, into the running sum.  Returns cudaGetLastError() after
// the launches, or cudaErrorInvalidValue for a shape, layout or plan it does
// not take (nothing launched).  n == 0 launches nothing.
extern "C" int fused_mlp_wide_f32_launch(int device, const void* x, const void* w1,
                                         const void* b1, const void* w2, int ld_w2,
                                         const void* b2, void* h, int ld_h, void* part,
                                         void* out, int n, int d, int m, int active,
                                         const int* active_p, int models, int splits1,
                                         int blocks1, int splits2, int blocks2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide::wide_shape_ok(n, d, m, ld_w2, ld_h, models, 4)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return (int)wide::run_f32(device, x, w1, b1, w2, ld_w2, b2, h, ld_h, part, out, n, d, m,
                            active, active_p, models, splits1, blocks1, splits2, blocks2, 0,
                            static_cast<cudaStream_t>(stream));
}

extern "C" const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

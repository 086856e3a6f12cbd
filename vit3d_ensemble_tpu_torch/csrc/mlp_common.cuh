// Device helpers shared by the fused-FFN kernels K1 (`fused_mlp.cu`), K1b
// (`mlp_chunked.cu`) and K1c (`mlp_pipelined.cu`).
//
// The model axis (K1's narrow bodies, K1b and K1c): a launch takes `models`
// weight sets stacked along a leading axis (x (P, n, D), w1 (P, m, D),
// b1 (P, m), w2 (P, D, m), b2 (P, D), out (P, n, D), all contiguous) and runs
// them on grid dimension y.  Each block offsets its pointers by its model
// and reads that model's width mask from device memory (`Model`), so a
// caller with a per-model `mlp_active` on the device never copies it to the
// host.  A single model is P = 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mlp {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Exact GELU, erf form, in f32 (torch's F.gelu and the JAX kernels' f32
// path): the f32 bodies' GELU.
__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752440f));
}

// The TPU kernels' bf16 GELU (`pallas_mlp.py:_poly_gelu`, chosen there for
// every bf16 input): h * (0.5 + y * Q(y^2)), y = h clamped to +-3.6, Q of
// degree 5 fitted to GELU itself; at most 5.73e-4 from exact GELU, no
// exponential.  The bf16 bodies' GELU.  Its constants and its order of
// operations are JAX's, and each product and sum is rounded on its own, as
// there and in the plain version (`fused_mlp.poly_gelu`): Q's terms cancel
// near |h| = 3.5, where fused multiply-adds would move the result by up to
// 2.1e-6.  16 FP32 instructions.
__device__ __forceinline__ float gelu_poly(float h) {
  const float y = fminf(fmaxf(h, -3.6f), 3.6f);
  const float v = __fmul_rn(y, y);
  float acc = -4.423316663e-07f;
  acc = __fadd_rn(__fmul_rn(acc, v), 2.512920360e-05f);
  acc = __fadd_rn(__fmul_rn(acc, v), -5.935066324e-04f);
  acc = __fadd_rn(__fmul_rn(acc, v), 7.701753005e-03f);
  acc = __fadd_rn(__fmul_rn(acc, v), -6.220111867e-02f);
  acc = __fadd_rn(__fmul_rn(acc, v), 3.961523962e-01f);
  return __fmul_rn(h, __fadd_rn(0.5f, __fmul_rn(y, acc)));
}

// The GELU of a body computing in T: the JAX kernels' rule,
// `fast_gelu = x.dtype == bfloat16` (`pallas_mlp.py:179`).
template <typename T> __device__ __forceinline__ float gelu(float h);
template <> __device__ __forceinline__ float gelu<float>(float h) { return gelu_erf(h); }
template <> __device__ __forceinline__ float gelu<__nv_bfloat16>(float h) { return gelu_poly(h); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte global -> shared copy; bytes past src_bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Named barriers (ids 1..15; 0 is __syncthreads).  `bar_sync` waits until
// `count` threads have arrived at `id`, itself included; `bar_arrive` counts
// the calling thread and goes on.  Both order the caller's earlier shared-
// memory accesses before the barrier completes.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// This block's model: its pointers offset to model blockIdx.y, and its width
// mask, clamped to [0, m]: `active_p[p]` when the caller gave one per model,
// else `active_all`.
template <typename T>
struct Model {
  const T* x;
  const T* w1;
  const T* b1;
  const T* w2;
  const T* b2;
  T* out;
  int active;

  __device__ __forceinline__ Model(const T* x_, const T* w1_, const T* b1_, const T* w2_,
                                   const T* b2_, T* out_, const int* active_p, int active_all,
                                   int n, int d, int m) {
    const size_t p = blockIdx.y;
    x = x_ + p * n * d;
    out = out_ + p * n * d;
    w1 = w1_ + p * m * d;
    b1 = b1_ + p * m;
    w2 = w2_ + p * d * m;
    b2 = b2_ + p * d;
    const int a = active_p != nullptr ? active_p[p] : active_all;
    active = min(max(a, 0), m);
  }
};

}  // namespace mlp

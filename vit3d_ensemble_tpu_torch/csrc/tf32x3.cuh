// 3xTF32 on Hopper's tensor cores, shared by K4's f32 body (`attention.cu`,
// `mma.sync`), K1's wide f32 body (`fused_mlp.cu`, `wgmma`) and K1b's f32
// body (`mlp_chunked.cu`, `mma.sync`: `mma_tf32x3` and `promote` below).
//
// One TF32 product (10 mantissa bits) misses the JAX tolerance of 2e-5 +
// 1e-4 |ref| (`tests/test_torch_stretch.py` emulates both kernels); three
// hold it: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded
// to nearest, and a * b = lo_a hi_b + hi_a lo_b + hi_a hi_b with f32 sums,
// the dropped lo_a lo_b below 2^-22 |a b|.  The tensor cores truncate inside
// an `mma`: its terms and the sum they join are aligned at the largest and
// cut below its f32 ulp.  So the callers keep the hi * hi terms and the
// small ones in two accumulators started from 0 and add them in f32 every
// few k-steps, never a small term into a long sum inside an `mma`.

#pragma once

#include <cstdint>

#include "sm90_common.cuh"

namespace tf32x3 {

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero), as
// f32 bits: what cvt.rna.tf32.f32 gives for finite x, in 2 instructions
// where ptxas makes cvt.rna 4 (it guards against infinities and NaNs; these
// operands are finite).  Half a TF32 ulp added to the magnitude's bits
// carries into the kept ones at or past a tie.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32: the operands of 3xTF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The same for f32 bits, as ldmatrix gives them.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  split_tf32(__uint_as_float(x), hi, lo);
}

// c += a * b for one 16x8x8 tile, TF32 in, f32 accumulate (A row-major,
// B column-major).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of a 3xTF32 product on m16n8k8 tiles: lo_a hi_b and hi_a lo_b
// into `small`, hi_a hi_b into `big`, the two accumulators of the rule
// above.  a: the A fragment split into TF32 hi and lo; b: the B fragment's
// two registers, each split.
__device__ __forceinline__ void mma_tf32x3(float (&big)[4], float (&small)[4],
                                           const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                           uint32_t b_hi0, uint32_t b_hi1, uint32_t b_lo0,
                                           uint32_t b_lo1) {
  mma_tf32(small, a_lo, b_hi0, b_hi1);
  mma_tf32(small, a_hi, b_lo0, b_lo1);
  mma_tf32(big, a_hi, b_hi0, b_hi1);
}

// The promotion of one tile's two accumulators: sum += big + small in f32,
// both accumulators back to 0 for the next interval of k-steps.
__device__ __forceinline__ void promote(float4& sum, float (&big)[4], float (&small)[4]) {
  sum = make_float4(sum.x + (big[0] + small[0]), sum.y + (big[1] + small[1]),
                    sum.z + (big[2] + small[2]), sum.w + (big[3] + small[3]));
#pragma unroll
  for (int e = 0; e < 4; ++e) big[e] = small[e] = 0.f;
}

// Four 8x4 f32 tiles from shared memory, one a register: lanes 8i .. 8i + 7
// give the rows of tile i (16 bytes each), and a thread gets row lane / 4,
// column lane % 4 of each (ldmatrix's 8x8 b16 tiles, a column pair taken as
// one f32).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_u32(row)));
}

// d (64 x N, f32) = a (64 x 8, TF32 in registers) * b (N x 8, TF32,
// K-major in shared memory behind the descriptor) + d; with `accumulate` 0,
// d's old value is not read.  Register i of a warp's A holds row lane / 4 +
// 8 (i % 2) of the warp's 16, column lane % 4 + 4 (i / 2): the m16n8k8 A
// fragment.  Accumulator register 4j + 2i + e holds row 16 * warp + lane / 4
// + 8i, column 8j + 2 (lane % 4) + e.  N: 8, 16, 32 (K1's narrow f32 body's
// fc2 at D = N) and 64 (its fc2 at D = 64, K1's wide f32 body).
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t b,
                                              int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<8>(float (&d)[4], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<16>(float (&d)[8], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// d (64 x 32, f32) = a (64 x 8, TF32, K-major in shared memory) * b (32 x
// 8, the same) + d, both behind descriptors; with `accumulate` 0, d's old
// value is not read.  Accumulators as `wgmma_tf32_rs`.  K1's narrow f32
// body's fc1.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

}  // namespace tf32x3

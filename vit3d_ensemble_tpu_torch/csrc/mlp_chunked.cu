// K1b: the fused FFN with fc2 summed in f32 over chunks of 512 hidden
// columns, out = b2 + sum_c gelu(x @ w1c^T + b1c) @ w2c^T, columns at or past
// the model's `active` zeroed.
//
// Replaces the TPU kernel `vit3d_ensemble_tpu/ops/pallas_mlp.py:
// _chunked_mlp_kernel` (variant "chunked", `_CHUNK_M` = 512).  There the
// unrolled chunk loop let GELU of chunk c proceed independently of fc2's
// product for chunk c - 1, which bought nothing: Mosaic issues MXU and VPU
// work in order (`pallas_mlp.py:105-121`).  On Hopper the tensor cores and
// the FP32 pipes run concurrently for different warps, so this kernel gives
// the two kinds of work to different warps.
//
// What bounds it on the H100: as K1 (`fused_mlp.cu`), operations: 4*n*D*M
// multiply-adds and n*M GELUs, the GELUs on the FP32 pipes (`gelu<T>`:
// exact erf in f32, the TPU kernels' polynomial in bf16, `mlp_common.cuh`).
// In f32 the products run in 3xTF32, three TF32 products for each f32 one.
//
// bf16 with D in {16, 32, 64} (`chunked_wgmma_kernel`): the persistent,
// warp-specialised `wgmma` pipeline that K1c runs (`mlp_pipeline.cuh`, on
// `k1c_plan`'s grid): a producer warpgroup feeds x row tiles and 64-column
// stages of w1, b1 and w2 by TMA; two consumer warpgroups of 64 rows each
// issue fc1 of the next stage as an SS wgmma while they run the GELU of this
// one, round it to bf16 in registers (the TPU kernel's rounding point) and
// issue fc2 as an RS wgmma.  fc2 is summed in the TPU kernel's order: its
// accumulator restarts from zero at the first of each 512-column chunk's
// eight stages, and each finished chunk is added into an f32 running sum in
// registers, in chunk order; + b2 and the bf16 store once a tile.  It
// replaced a body of `mma.sync` m16n8k16 with `cp.async` staging, producer
// and consumer warps handing h over through shared memory at named
// barriers, which on an H100 reached 27 % of the GELU bound at the serving
// shape where K1c's pipeline reached 42 % (PERF.md).
//
// bf16 at D = 8 (`chunked_wgmma_d8_kernel`, every bf16 D from 1 to 8): the
// same pipeline at fc1's K of 16 and fc2 on wgmma m64n8k16, with the hidden
// columns split across the blocks of a cluster on 512-column boundaries where
// the row tiles are few (`mlp_pipeline.cuh`: each block keeps its chunks'
// running sum, and the cluster adds the blocks' sums in rank order), on the
// grid `fused_mlp.k1_d8_plan` lays out.  It replaced a CUDA-core tiling of
// producer and consumer warps, one block a 64-row tile, which on an H100 took
// 4.4 times the library chain's time at 2,056 rows (PERF.md).
//
// f32 at every D (`chunked_tf32x3_kernel`): both products on the tensor
// cores in 3xTF32 (mma.sync m16n8k8, `tf32x3.cuh`), 128-row units of
// producer and consumer warps that hand hidden columns over in sub-chunks of
// 64 through two buffers of h in shared memory (named barriers: a producer
// arrives at FULL[b] when h[b] is written and waits at EMPTY[b] before
// writing it again), the consumers adding each 512-column chunk's partial
// into the f32 sum at its end; see its note below.  A 512-column chunk of
// both weight slabs is 256 KB in f32 at D = 64, more than a block's 227 KB
// next to the h buffers: sub-chunks of 64 columns keep every buffer small,
// and the hand-over unit and the summation chunk are separate, so the sums
// keep the TPU kernel's order.
//
// The wide regime, every D above 64, with the model axis: K1's
// wide bodies (`mlp_wide.cuh`, whose note says what bounds them and how they
// are laid out), fc1 + GELU into an L2-resident scratch and fc2 from it,
// with fc2 summed over the 512-column chunks in f32 in chunk order: in bf16
// fc2's wgmma accumulators start from 0 at every chunk and are added into an
// f32 running sum in registers at its end; in f32 fc2's K splits are its
// chunks, whose partial sums a second launch adds in chunk order.

#include <atomic>

#include "mlp_common.cuh"
#include "mlp_pipeline.cuh"
#include "mlp_wide.cuh"
#include "sm90_common.cuh"
#include "tf32x3.cuh"

namespace {

using namespace mlp;
using namespace tf32x3;
using bf16 = __nv_bfloat16;

constexpr int CHUNK_M = 512;       // fc2's summation chunk (`pallas_mlp.py:123`)
constexpr int SUB = 64;            // hidden columns per hand-over
constexpr int SUBS_PER_CHUNK = CHUNK_M / SUB;

// named barrier ids; FULL0 + b and EMPTY0 + b for buffer b
constexpr int FULL0 = 1, EMPTY0 = 3, PRODUCERS = 5, CONSUMERS = 6;

__device__ __forceinline__ bool chunk_ends(int j, int subs) {
  return j % SUBS_PER_CHUNK == SUBS_PER_CHUNK - 1 || j == subs - 1;
}

// ---------------------------------------------------------------------------
// bf16, D in {16, 32, 64}: the wgmma pipeline of `mlp_pipeline.cuh`, fc2
// summed over 512-column chunks.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(pipeline::W_THREADS, 1)
chunked_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w1,
                     const __grid_constant__ CUtensorMap map_w2,
                     const __grid_constant__ CUtensorMap map_b1, const bf16* __restrict__ b2,
                     bf16* __restrict__ out, int n, int m, const int* __restrict__ active_p,
                     int active_all) {
  static_assert(pipeline::SUM_STAGES * pipeline::CHUNK == CHUNK_M,
                "eight stages make fc2's summation chunk");
  pipeline::pipeline_body<D, true>(map_x, map_w1, map_w2, map_b1, b2, out, n, m, active_p,
                                   active_all);
}

// bf16 at D = 8: the same pipeline, the hidden columns split across a
// cluster of `splits` blocks on 512-column boundaries.
__global__ void __launch_bounds__(pipeline::W_THREADS, 1)
chunked_wgmma_d8_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_w1,
                        const __grid_constant__ CUtensorMap map_w2,
                        const __grid_constant__ CUtensorMap map_b1, const bf16* __restrict__ b2,
                        bf16* __restrict__ out, int n, int m, const int* __restrict__ active_p,
                        int active_all, int splits) {
  pipeline::pipeline_body<8, true>(map_x, map_w1, map_w2, map_b1, b2, out, n, m, active_p,
                                   active_all, splits);
}

// ---------------------------------------------------------------------------
// 3xTF32 body: f32 at D in {8, 16, 32, 64}, both products on the tensor
// cores (mma.sync m16n8k8 in TF32, `tf32x3.cuh`).
//
// One TF32 product misses the JAX tolerance; three hold it: each operand is
// split into TF32 hi and lo as its fragment loads (`split_tf32`), and each
// product is taken as lo*hi + hi*lo + hi*hi, the hi*hi terms and the small
// ones in two accumulators from 0 (`mma_tf32x3`): the tensor cores truncate
// inside an `mma`, so no small term meets a long sum there.  fc1's K = D <=
// 64 is one interval: big + small once, then + b1 and the exact-erf GELU.
// fc2 promotes its two accumulators into the chunk's f32 partial every 128
// of K (PROMOTE_SUBS sub-chunks, K1's `WIDE_F32_PROMOTE_K`) and adds the
// partial into the output's f32 sum at the end of each 512-column chunk, in
// order.  Both sums live in shared memory, a consumer lane's own entries,
// so a consumer holds only the two accumulators of its tiles.
//
// A block owns a unit of 128 token rows (F_TILE_N) of one model; its
// producer and consumer warps each own WARP_MT m-tiles of 16 rows, the same
// rows in both roles.  3xTF32 makes each multiply-add three and each operand
// two, so what feeds `mma.sync` weighs as much as the products: a warp
// splits every B fragment it reads and uses it for all its m-tiles.  At D =
// 64 a warp takes 32 rows (4 + 4 warps, fc1's n-tiles two at a time to fit
// the registers), below it 16 rows (8 + 8 warps): on an H100 each took the
// least time at its D among 16- and 32-row warp tiles, 64-row units and a
// split of the weights once a block into fragments in shared memory (PERF.md,
// section 6).  What holds it there: on an H100 `mma.sync` in TF32 does not
// overlap FP32 work on its SM sub-partition (`chip_smoke.py`'s build phase,
// `mma_sync_tf32_ffma_overlap`), so the body takes about the sum of its
// products, its GELUs and its loads and splits; `wgmma`, asynchronous, is
// the way past that.
//   * fc1: a producer loads its x rows once a unit, straight into registers
//     as A fragments, already split.  fc1's k order within 16 of D is
//     permuted so that one 16-byte read of a w1 row (d = 16s + 4t .. + 3)
//     gives the B fragments of two k-steps: k-step 2s takes d = 16s + 4t
//     and + 1 at k = t and t + 4, k-step 2s + 1 d + 2 and + 3 (x the same
//     way).  At D = 8 one 8-byte read at d = 2t.
//   * h: an accumulator holds columns 2t and 2t + 1 of its n-tile where
//     fc2's A fragment wants k = t and t + 4, so fc2's k-step j takes the
//     hidden columns of fc1's n-tile j in the order 0, 2, 4, 6, 1, 3, 5, 7:
//     a producer lane's four values are the consumer lane's A fragment, one
//     16-byte store and load (h[b][m-tile][k-step][lane]), split where read.
//   * fc2: B is w2[o][2t], [2t + 1] of the k-step, one 8-byte read.
// Rows of w1 are padded to 16 mod 32 floats (80 at D = 64), of w2 to 8 mod
// 32 (72): a quarter-warp's 16-byte reads (rows g, g + 1) or a half-warp's
// 8-byte reads (rows g < 4) fall on 32 distinct banks.
//
// Staging: w1, b1 and w2 arrive by cp.async (16-byte copies, 4-byte ones for
// b1 and for w2 when m % 4 != 0) into each role's two slots, a sub-chunk
// ahead, zero-filled at or past `active`: h is gelu(0) = 0 there and meets
// zero rows of w2.
//
// The grid is (row tiles, models), one block a unit (`fused_mlp.k1b_f32_plan`).
// ---------------------------------------------------------------------------

constexpr int F_TILE_N = 128;            // token rows of a unit
constexpr int F_MT = F_TILE_N / 16;      // m-tiles of a unit
constexpr int PROMOTE_SUBS = 128 / SUB;  // fc2's promotion interval

template <int D>
struct Tf32Smem {
  static constexpr int ROLE_WARPS = D == 64 ? 4 : 8;  // warps of each role
  static constexpr int ROLE = 32 * ROLE_WARPS;        // threads of each role
  static constexpr int THREADS = 2 * ROLE;
  static constexpr int WARP_MT = F_MT / ROLE_WARPS;   // m-tiles a warp
  static constexpr int NG = D == 64 ? 2 : 4;          // fc1's n-tiles at once
  static constexpr int LD1 = D == 8 ? 8 : D + 16 - D % 32;  // w1 rows (hidden columns)
  static constexpr int LD2 = SUB + 8;                         // w2 rows (outputs)
  float w1[2][SUB * LD1];
  float b1[2][SUB];
  float w2[2][D * LD2];
  float4 h[2][F_MT][SUB / 8][32];  // a consumer lane's A fragment of each k-step
  float4 part[F_MT][D / 8][32];    // the chunk's f32 partial, a consumer lane's own
  float4 acc[F_MT][D / 8][32];     // the output's f32 sum, the same
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 4 : 0));
}

// Producers stage w1[c0:c0+SUB, :] and b1[c0:c0+SUB] into slot s.
template <int D>
__device__ __forceinline__ void f_stage_w1(Tf32Smem<D>& sm, int s, const float* w1,
                                           const float* b1, int c0, int active, int rt) {
  constexpr int LD1 = Tf32Smem<D>::LD1, PIECES = D / 4;
  for (int i = rt; i < SUB * PIECES; i += Tf32Smem<D>::ROLE) {
    const int c = i / PIECES, q = i % PIECES;
    const bool live = c0 + c < active;
    cp_async16(sm.w1[s] + c * LD1 + 4 * q, live ? w1 + (size_t)(c0 + c) * D + 4 * q : w1,
               live ? 16 : 0);
  }
  if (rt < SUB) cp_async4(&sm.b1[s][rt], b1 + (c0 + rt < active ? c0 + rt : 0), c0 + rt < active);
}

// Consumers stage w2[:, c0:c0+SUB] into slot s: 16-byte copies when m % 4 ==
// 0 (every piece then starts 16-byte aligned), else 4-byte ones.
template <int D>
__device__ __forceinline__ void f_stage_w2(Tf32Smem<D>& sm, int s, const float* w2, int m,
                                           int c0, int active, int rt) {
  constexpr int LD2 = Tf32Smem<D>::LD2, ROLE = Tf32Smem<D>::ROLE;
  if (m % 4 == 0) {
    for (int i = rt; i < D * (SUB / 4); i += ROLE) {
      const int o = i / (SUB / 4), col = c0 + (i % (SUB / 4)) * 4;
      const int live = min(max(active - col, 0), 4);
      cp_async16(sm.w2[s] + o * LD2 + col - c0, live ? w2 + (size_t)o * m + col : w2, 4 * live);
    }
  } else {
    for (int i = rt; i < D * SUB; i += ROLE) {
      const int o = i / SUB, c = i % SUB;
      const bool live = c0 + c < active;
      cp_async4(sm.w2[s] + o * LD2 + c, live ? w2 + (size_t)o * m + c0 + c : w2, live);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tf32Smem<D>::THREADS, 1)
chunked_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, float* __restrict__ out, int n, int m,
                      const int* __restrict__ active_p, int active_all) {
  using S = Tf32Smem<D>;
  constexpr int LD1 = S::LD1, LD2 = S::LD2, ROLE = S::ROLE, THREADS_ = S::THREADS;
  constexpr int WARP_MT = S::WARP_MT, NG = S::NG;
  constexpr int KS = D / 8;             // fc1's k-steps
  constexpr int KP = D == 8 ? 1 : 2;    // fc1's k-steps a w1 read
  constexpr int NT = SUB / 8;           // fc1's n-tiles a sub-chunk, fc2's k-steps
  constexpr int NO = D / 8;             // fc2's n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = threadIdx.x % ROLE;
  const int mt0 = (warp % S::ROLE_WARPS) * WARP_MT;  // this warp's first m-tile
  const size_t p = blockIdx.y;
  const int row0 = blockIdx.x * F_TILE_N;
  const int active = min(max(active_p != nullptr ? active_p[p] : active_all, 0), m);
  const int subs = (active + SUB - 1) / SUB;  // sub-chunks handed over

  if (threadIdx.x < ROLE) {
    // ---- producers: h = gelu(x @ w1s^T + b1s) ----
    if (subs == 0) return;
    const float* xp = x + p * n * D;
    const float* w1p = w1 + p * m * D;
    const float* b1p = b1 + p * m;
    // rows r, r + 8 of each m-tile as A fragments, split; zero past n
    uint32_t xh[WARP_MT][KS][4], xl[WARP_MT][KS][4];
#pragma unroll
    for (int i = 0; i < WARP_MT; ++i) {
      const int r_lo = row0 + 16 * (mt0 + i) + g, r_hi = r_lo + 8;
#pragma unroll
      for (int kp = 0; kp < KS / KP; ++kp) {
        if constexpr (KP == 2) {
          const int c = 16 * kp + 4 * t;
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 lo =
              r_lo < n ? *reinterpret_cast<const float4*>(xp + (size_t)r_lo * D + c) : zero;
          const float4 hi =
              r_hi < n ? *reinterpret_cast<const float4*>(xp + (size_t)r_hi * D + c) : zero;
          const float v[2][4] = {{lo.x, hi.x, lo.y, hi.y}, {lo.z, hi.z, lo.w, hi.w}};
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_tf32(v[k][e], xh[i][2 * kp + k][e], xl[i][2 * kp + k][e]);
        } else {
          const float2 zero = make_float2(0.f, 0.f);
          const float2 lo =
              r_lo < n ? *reinterpret_cast<const float2*>(xp + (size_t)r_lo * D + 2 * t) : zero;
          const float2 hi =
              r_hi < n ? *reinterpret_cast<const float2*>(xp + (size_t)r_hi * D + 2 * t) : zero;
          const float v[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(v[e], xh[i][0][e], xl[i][0][e]);
        }
      }
    }
    f_stage_w1<D>(sm, 0, w1p, b1p, 0, active, rt);
    cp_async_commit();
    for (int j = 0; j < subs; ++j) {
      cp_async_wait<0>();         // this thread's copies of sub-chunk j landed
      bar_sync(PRODUCERS, ROLE);  // everyone's have, and j - 1 is read
      if (j + 1 < subs) f_stage_w1<D>(sm, (j + 1) % 2, w1p, b1p, (j + 1) * SUB, active, rt);
      cp_async_commit();
      const int s = j % 2, b = j % 2;
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += NG) {
        float big[WARP_MT][NG][4], small[WARP_MT][NG][4];
#pragma unroll
        for (int i = 0; i < WARP_MT; ++i)
#pragma unroll
          for (int jt = 0; jt < NG; ++jt)
#pragma unroll
            for (int e = 0; e < 4; ++e) big[i][jt][e] = small[i][jt][e] = 0.f;
#pragma unroll
        for (int kp = 0; kp < KS / KP; ++kp)
#pragma unroll
          for (int jt = 0; jt < NG; ++jt) {
            const float* wp = sm.w1[s] + (8 * (j0 + jt) + g) * LD1;
            if constexpr (KP == 2) {
              const float4 w = *reinterpret_cast<const float4*>(wp + 16 * kp + 4 * t);
              uint32_t bh[4], bl[4];
              split_tf32(w.x, bh[0], bl[0]);
              split_tf32(w.y, bh[1], bl[1]);
              split_tf32(w.z, bh[2], bl[2]);
              split_tf32(w.w, bh[3], bl[3]);
#pragma unroll
              for (int i = 0; i < WARP_MT; ++i) {
                mma_tf32x3(big[i][jt], small[i][jt], xh[i][2 * kp], xl[i][2 * kp], bh[0], bh[1],
                           bl[0], bl[1]);
                mma_tf32x3(big[i][jt], small[i][jt], xh[i][2 * kp + 1], xl[i][2 * kp + 1],
                           bh[2], bh[3], bl[2], bl[3]);
              }
            } else {
              const float2 w = *reinterpret_cast<const float2*>(wp + 2 * t);
              uint32_t bh[2], bl[2];
              split_tf32(w.x, bh[0], bl[0]);
              split_tf32(w.y, bh[1], bl[1]);
#pragma unroll
              for (int i = 0; i < WARP_MT; ++i)
                mma_tf32x3(big[i][jt], small[i][jt], xh[i][0], xl[i][0], bh[0], bh[1], bl[0],
                           bl[1]);
            }
          }
        // h = gelu((big + small) + b1), as the consumer lane's A fragment:
        // rows g, g + 8 at column 2t, then at 2t + 1
        float4 hv[WARP_MT][NG];
#pragma unroll
        for (int jt = 0; jt < NG; ++jt) {
          const float2 bb = *reinterpret_cast<const float2*>(&sm.b1[s][8 * (j0 + jt) + 2 * t]);
#pragma unroll
          for (int i = 0; i < WARP_MT; ++i)
            hv[i][jt] = make_float4(gelu_erf((big[i][jt][0] + small[i][jt][0]) + bb.x),
                                    gelu_erf((big[i][jt][2] + small[i][jt][2]) + bb.x),
                                    gelu_erf((big[i][jt][1] + small[i][jt][1]) + bb.y),
                                    gelu_erf((big[i][jt][3] + small[i][jt][3]) + bb.y));
        }
        // the consumers have read h[b] (hand-over j - 2)
        if (j0 == 0 && j >= 2) bar_sync(EMPTY0 + b, THREADS_);
#pragma unroll
        for (int i = 0; i < WARP_MT; ++i)
#pragma unroll
          for (int jt = 0; jt < NG; ++jt) sm.h[b][mt0 + i][j0 + jt][lane] = hv[i][jt];
      }
      bar_arrive(FULL0 + b, THREADS_);
    }
    cp_async_wait<0>();
    return;
  }

  // ---- consumers: out = b2 + sum over chunks of h @ w2s^T ----
  const float* w2p = w2 + p * D * m;
  float big[WARP_MT][NO][4], small[WARP_MT][NO][4];
#pragma unroll
  for (int i = 0; i < WARP_MT; ++i)
#pragma unroll
    for (int jo = 0; jo < NO; ++jo) {
#pragma unroll
      for (int e = 0; e < 4; ++e) big[i][jo][e] = small[i][jo][e] = 0.f;
      sm.part[mt0 + i][jo][lane] = sm.acc[mt0 + i][jo][lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  if (subs > 0) f_stage_w2<D>(sm, 0, w2p, m, 0, active, rt);
  cp_async_commit();
  for (int j = 0; j < subs; ++j) {
    cp_async_wait<0>();
    bar_sync(CONSUMERS, ROLE);
    if (j + 1 < subs) f_stage_w2<D>(sm, (j + 1) % 2, w2p, m, (j + 1) * SUB, active, rt);
    cp_async_commit();
    const int s = j % 2, b = j % 2;
    bar_sync(FULL0 + b, THREADS_);  // the producers have written h[b]

#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ah[WARP_MT][4], al[WARP_MT][4];
#pragma unroll
      for (int i = 0; i < WARP_MT; ++i) {
        const float4 hv = sm.h[b][mt0 + i][kk][lane];
        split_tf32(hv.x, ah[i][0], al[i][0]);
        split_tf32(hv.y, ah[i][1], al[i][1]);
        split_tf32(hv.z, ah[i][2], al[i][2]);
        split_tf32(hv.w, ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int jo = 0; jo < NO; ++jo) {
        const float2 w =
            *reinterpret_cast<const float2*>(sm.w2[s] + (8 * jo + g) * LD2 + 8 * kk + 2 * t);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(w.x, bh0, bl0);
        split_tf32(w.y, bh1, bl1);
#pragma unroll
        for (int i = 0; i < WARP_MT; ++i)
          mma_tf32x3(big[i][jo], small[i][jo], ah[i], al[i], bh0, bh1, bl0, bl1);
      }
    }
    if (j + 2 < subs) bar_arrive(EMPTY0 + b, THREADS_);  // a producer will wait for it
    const bool chunk_end = chunk_ends(j, subs);
    if (chunk_end || j % PROMOTE_SUBS == PROMOTE_SUBS - 1) {
      // part += big + small; at a chunk's end acc += part, part = 0
#pragma unroll
      for (int i = 0; i < WARP_MT; ++i)
#pragma unroll
        for (int jo = 0; jo < NO; ++jo) {
          float4& q = sm.part[mt0 + i][jo][lane];
          promote(q, big[i][jo], small[i][jo]);
          if (chunk_end) {
            float4& a = sm.acc[mt0 + i][jo][lane];
            a = make_float4(a.x + q.x, a.y + q.y, a.z + q.z, a.w + q.w);
            q = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
    }
  }

  float* op = out + p * n * D;
  const float* b2p = b2 + p * D;
#pragma unroll
  for (int i = 0; i < WARP_MT; ++i) {
    const int r_lo = row0 + 16 * (mt0 + i) + g, r_hi = r_lo + 8;
#pragma unroll
    for (int jo = 0; jo < NO; ++jo) {
      const int o = 8 * jo + 2 * t;
      const float bb0 = b2p[o], bb1 = b2p[o + 1];
      const float4 a = sm.acc[mt0 + i][jo][lane];
      if (r_lo < n)
        *reinterpret_cast<float2*>(op + (size_t)r_lo * D + o) = make_float2(a.x + bb0, a.y + bb1);
      if (r_hi < n)
        *reinterpret_cast<float2*>(op + (size_t)r_hi * D + o) = make_float2(a.z + bb0, a.w + bb1);
    }
  }
  cp_async_wait<0>();
}

template <int D>
cudaError_t launch_tf32x3(int device, const float* x, const float* w1, const float* b1,
                          const float* w2, const float* b2, float* out, int n, int m,
                          const int* active_p, int active, int tiles, int models,
                          cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = sm90::raise_smem_limit_once(
      (const void*)chunked_tf32x3_kernel<D>, (int)sizeof(Tf32Smem<D>), device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, models);
  chunked_tf32x3_kernel<D><<<grid, Tf32Smem<D>::THREADS, sizeof(Tf32Smem<D>), stream>>>(
      x, w1, b1, w2, b2, out, n, m, active_p, active);
  return cudaGetLastError();
}

}  // namespace

// The arguments of `mlp_pipelined_launch` (`mlp_pipelined.cu`): n token
// rows per model, `models` weight sets, active_p the per-model width mask
// on the device or null for `active` in all; dtype 1 = bfloat16 (f32 takes
// `mlp_chunked_f32_launch`); ld2, the row length of w2 and of b1 in
// elements (m, or m rounded up to 8 in zero-padded copies: TMA reads them,
// and their row strides must be multiples of 16 bytes); blocks, the grid's
// row-tile groups a model (`k1c_plan`, `k1_d8_plan` with `chunked`); splits,
// the blocks of a group's cluster (D = 8; 1 at D 16-64).  D in {8, 16, 32,
// 64}; anything else returns cudaErrorInvalidValue.
extern "C" int mlp_chunked_launch(int device, const void* x, const void* w1, const void* b1,
                                  const void* w2, int ld2, const void* b2, void* out, int n,
                                  int d, int m, int active, const int* active_p, int models,
                                  int blocks, int splits, int dtype, void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || models == 0) return 0;
  if (blocks < 1 || models > 65535 || (d != 8 && splits != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
#define WGMMA_LAUNCH(D)                                                                     \
  (int)pipeline::launch<D, true>(chunked_wgmma_kernel<D>, device, x, w1, b1, w2, ld2, b2, out, \
                                 n, m, active, active_p, models, blocks, stream)
  if (dtype == 1) {
    switch (d) {
      case 8:
        return (int)pipeline::launch_split<true>(chunked_wgmma_d8_kernel, device, x, w1, b1, w2,
                                                 ld2, b2, out, n, m, active, active_p, models,
                                                 blocks, splits, stream);
      case 16: return WGMMA_LAUNCH(16);
      case 32: return WGMMA_LAUNCH(32);
      case 64: return WGMMA_LAUNCH(64);
    }
  }
#undef WGMMA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The bf16 body at d in {8, 16, 32, 64} and its occupancy, as
// `mlp_pipelined_shape` lists K1c's, for `k1c_plan` and `k1_d8_plan`; f32
// returns cudaErrorInvalidValue.
extern "C" int mlp_chunked_shape(int device, int d, int dtype, int* out) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1) {
    switch (d) {
      case 8: return (int)pipeline::shape<8, true>(chunked_wgmma_d8_kernel, device, out);
      case 16: return (int)pipeline::shape<16, true>(chunked_wgmma_kernel<16>, device, out);
      case 32: return (int)pipeline::shape<32, true>(chunked_wgmma_kernel<32>, device, out);
      case 64: return (int)pipeline::shape<64, true>(chunked_wgmma_kernel<64>, device, out);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 body at D = 8: the clusters of `splits` blocks (1-16) the card
// holds at once, into *out.
extern "C" int mlp_chunked_d8_clusters(int device, int splits, int* out) {
  const cudaError_t err = cudaSetDevice(device);
  return err != cudaSuccess
             ? (int)err
             : (int)pipeline::clusters<true>(chunked_wgmma_d8_kernel, device, splits, out);
}

// K1b in f32 on the 3xTF32 body: the arguments of `mlp_chunked_launch` less
// ld2, blocks and the dtype, on a grid of (tiles, models) blocks (`fused_mlp.k1b_f32_plan`);
// tiles must be ceil(n / 128), the body's row tiles.  D in {8, 16, 32, 64};
// anything else returns cudaErrorInvalidValue.
extern "C" int mlp_chunked_f32_launch(int device, const float* x, const float* w1,
                                      const float* b1, const float* w2, const float* b2,
                                      float* out, int n, int d, int m, int active,
                                      const int* active_p, int models, int tiles,
                                      void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || models == 0) return 0;
  if (tiles != (n + F_TILE_N - 1) / F_TILE_N) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
#define F32_ARGS device, x, w1, b1, w2, b2, out, n, m, active_p, active, tiles, models, stream
  switch (d) {
    case 8: return (int)launch_tf32x3<8>(F32_ARGS);
    case 16: return (int)launch_tf32x3<16>(F32_ARGS);
    case 32: return (int)launch_tf32x3<32>(F32_ARGS);
    case 64: return (int)launch_tf32x3<64>(F32_ARGS);
  }
#undef F32_ARGS
  return (int)cudaErrorInvalidValue;
}

// K1b's wide regime in bf16 (d > 64, a multiple of 8), with the
// model axis: the operands of `fused_mlp_wide_launch` (`fused_mlp.cu`).  Two
// launches: fc1 + GELU into h, then fc2 + b2 summed over the chunks.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a shape
// or layout it does not take (nothing launched).  n == 0 launches nothing.
extern "C" int mlp_chunked_wide_launch(int device, const void* x, const void* w1, const void* b1,
                                       const void* w2, int ld_w2, const void* b2, void* h,
                                       int ld_h, void* out, int n, int d, int m, int active,
                                       const int* active_p, int models, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide::wide_shape_ok(n, d, m, ld_w2, ld_h, models, 8)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return (int)wide::run_bf16<wide::CHUNK_STEPS>(device, x, w1, b1, w2, ld_w2, b2, h, ld_h, out,
                                                n, d, m, active, active_p, models,
                                                static_cast<cudaStream_t>(stream));
}

// K1b's wide regime in f32 (d > 64, a multiple of 4), with the
// model axis: the arguments of `fused_mlp_wide_f32_launch`, on
// `fused_mlp.wide_f32_plan(..., chunked=True)`: splits2 must be fc2's chunks,
// ceil(m / 512).  Returns as that entry does.
extern "C" int mlp_chunked_wide_f32_launch(int device, const void* x, const void* w1,
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
                            active, active_p, models, splits1, blocks1, splits2, blocks2,
                            wide::T_CHUNK_STAGES, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mlp_chunked_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1's and K1c's narrow f32 body: out = gelu(x @ w1^T + b1)[:, :active]
// @ w2[:, :active]^T + b2 in f32 at D in {8, 16, 32, 64}, with the model axis.
//
// Replaces the TPU kernels `vit3d_ensemble_tpu/ops/pallas_mlp.py:_mlp_kernel`
// (K1, `fused_mlp.cu` includes this file) and `_pipelined2_mlp_kernel` (K1c,
// `mlp_pipelined.cu`) in f32: every evaluation forward of the drivers, the
// trainers, the grouped sweep and the ensemble grid at the registry's widths.
//
// What bounds it on the H100: operations.  4 n D M multiply-adds, taken in
// 3xTF32 on the tensor cores (three TF32 products an f32 one, `tf32x3.cuh`:
// one TF32 product misses the JAX tolerance), and n M exact-erf GELUs on the
// FP32 pipes; the weights and x are a few MB.  At one model and the drivers'
// 260 rows there is little of either: (260, 64, 3,072) is 204 MFLOP, ~1.2 us
// at the TF32 peak, so what the body must do there is spread the work over
// the card.  The CUDA-core body that served these calls before gave each
// model ceil(n / 64) blocks that each walked all of M alone, on FFMAs: 5
// blocks on 132 SMs at 260 rows.
//
// Design.  A unit of work is (64-row tile, split of the hidden columns,
// model); a block of one warpgroup (128 threads) takes one unit at a time.
// The grid (`fused_mlp.k1_narrow_f32_plan`) is (splits x groups, models):
// the splits of a row tile are the blocks of one thread-block cluster, each
// taking a contiguous run of the M / 32 chunks of 32 hidden columns; a group
// walks a contiguous run of row tiles (one each for K1; two for K1c, its
// own row-tile order).  The plan splits M
// until the units fill the SMs, up to 16 ways (a non-portable cluster size
// above 8), from n and M alone: a model's result does not depend on how
// many models share the launch, nor on K1 or K1c, to the bit.
//   * Staging.  A chunk's w1 rows (32 x D), w2 columns (D x 32) and b1 load
//     by cp.async in 16-byte pieces (4-byte ones for b1, and for w2 when M %
//     4 != 0) into one of two buffers, two chunks ahead, zero-filled at or
//     past the model's width (read from the device, `Model`).  The block then splits
//     each value into TF32 hi and lo (`split_tf32`) into wgmma's K-major
//     tiles: rows of 32 f32 (128 bytes) in the 128-byte swizzle, 8-row atoms
//     1,024 bytes apart.  x's tile (64 x D) is split once a row tile.
//   * fc1: h (64 x 32) = x w1_c^T on `wgmma` m64n32k8, both operands from
//     shared memory: lo_x hi_w and hi_x lo_w into `small`, hi_x hi_w into
//     `big`, both from 0; K = D <= 64 is one interval, so h = big + small,
//     + b1, the exact-erf GELU (`gelu_erf`), columns at or past the width
//     written as 0.
//   * fc2: out (64 x D) += h w2_c^T on `wgmma` m64nNk8 (N = D, in passes
//     of 32 output columns at D = 64) with h from registers, split there:
//     the accumulator's columns 2t and 2t + 1 are the A fragment's k = t and
//     t + 4, so w1's tile rows are stored in the order 0, 4, 1, 5, 2, 6, 3,
//     7 within each 8 and the accumulator register pair of k-step j holds
//     hidden columns 8j + t and 8j + t + 4; w2's tile keeps the hidden
//     columns in order.  A pass's `big` and `small` start from 0 every chunk
//     (32 of K) and are added into an f32 sum in registers, so no small term
//     meets a long sum inside the tensor cores, which truncate there, and
//     the two live only while their pass runs, so at D = 64 no register
//     holds a pass's sums across the GELUs.
//   * The splits' sums: each block writes its (64 x D) partial into its own
//     shared memory; after a cluster barrier, block r of S adds the
//     partials of its S-th of the tile's elements in rank order through
//     distributed shared memory, adds b2 once and stores; a second barrier
//     keeps every block's shared memory until all have read it.  One launch
//     a call, no float atomics, the same bits every run.  A split whose
//     chunks all lie at or past the width skips its products and joins the
//     sum with zeros.
// A block runs its wgmmas to completion before it touches their
// accumulators; the GELUs of one block overlap the products of another on
// the same SM (two blocks an SM at D = 32 and 64, three at D = 8 and 16).  Why
// `wgmma` and not `mma.sync` (K1b's f32 body): on an H100 `mma.sync`
// in TF32 does not overlap FP32 work on its SM sub-partition
// (`chip_smoke.py`'s `mma_sync_tf32_ffma_overlap`), and its fragments are
// split by every warp that loads them; `wgmma` reads the split tiles from
// shared memory once for the warpgroup and runs asynchronously.  What holds
// it at many units (the sweep's 30 models): each block stages and splits
// every chunk for its own 64 rows and runs its parts one after another, so
// at two blocks an SM (D = 64) the staging, the split, the GELUs and the
// products add up (`chip_turns.py`, phase `k1_f32_narrow_parts`).  A form
// with a producer warpgroup staging and splitting for one or two consumer
// warpgroups was built and timed on an H100: it gave the same bits and won
// at 4,160 and 33,280 rows, but lost at 30 models at D = 16, where this
// form holds three blocks an SM, and its two-consumer form spilled (three
// warpgroups cap a thread at 168 registers), so it was not kept.
//
// Layouts follow torch.nn.Linear: x (P, n, D), w1 (P, m, D), b1 (P, m),
// w2 (P, D, m), b2 (P, D), out (P, n, D), all contiguous f32, x and w1
// 16-byte aligned.

#pragma once

#include <cooperative_groups.h>

#include <atomic>

#include "mlp_common.cuh"
#include "sm90_common.cuh"
#include "tf32x3.cuh"

// Internal linkage: each library that includes this file keeps its own
// kernels and its own once-a-device flags.  (A static local of a template
// with external linkage is one object across every library loaded in the
// process, so one library's flag would stand for the other's kernel.)
namespace narrow_f32 {
namespace {

constexpr int ROWS = 64;          // token rows of a tile: the warpgroup's wgmma m64
constexpr int CH = 32;            // hidden columns of a chunk: fc1's N
constexpr int THREADS = 128;      // one warpgroup
constexpr int NP = 32;            // output columns of an fc2 pass: wgmma's N at D = 64
constexpr int MAX_SPLITS = 16;    // blocks of a cluster; above 8 non-portable

// Shared memory, each swizzled tile 1,024-byte aligned: x's hi and lo
// tiles (64 rows, KX slices of 32 columns), a chunk's w1 hi and lo tiles (32
// rows, KX slices), w2 hi and lo tiles (D rows of the chunk's 32 columns),
// then two staging buffers of a chunk's w1 (32 x D), w2 (D x 32) and b1 (32)
// as they load, which the reduction's (64 x D) partial reuses.
template <int D>
struct Shape {
  static constexpr int KX = (D + 31) / 32;
  static constexpr int X_TILE = ROWS * 128 * KX;
  static constexpr int W1_TILE = CH * 128 * KX;
  static constexpr int W2_TILE = D * 128;
  static constexpr int RAW = 2 * CH * D + CH;  // floats of a staging buffer
  static constexpr int STAGE_BYTES =
      (2 * RAW > ROWS * D ? 2 * RAW : ROWS * D) * (int)sizeof(float);
  static constexpr size_t SMEM =
      1024 + 2 * X_TILE + 2 * W1_TILE + 2 * W2_TILE + (size_t)STAGE_BYTES;
  static_assert(W2_TILE % 1024 == 0, "every tile starts on a 1,024-byte swizzle atom");
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 4 : 0));
}

// Chunk c's w1 rows, w2 columns and b1 into the staging buffer `raw`, zero
// at or past `active`; one cp.async group, committed.
template <int D>
__device__ __forceinline__ void stage(float* raw, const mlp::Model<float>& md, int m, int c,
                                      int active) {
  float* rw1 = raw;           // [CH][D]
  float* rw2 = raw + CH * D;  // [D][CH]
  float* rb1 = rw2 + D * CH;  // [CH]
  if (threadIdx.x < CH) {
    const int h = c * CH + threadIdx.x;
    cp_async4(rb1 + threadIdx.x, h < active ? md.b1 + h : md.b1, h < active);
  }
  for (int i = threadIdx.x; i < CH * D / 4; i += THREADS) {
    const int r = i / (D / 4), q = i % (D / 4), h = c * CH + r;
    const bool live = h < active;
    mlp::cp_async16(rw1 + r * D + 4 * q, live ? md.w1 + (size_t)h * D + 4 * q : md.w1,
                    live ? 16 : 0);
  }
  if (m % 4 == 0) {  // every 4-column piece of a w2 row starts 16-byte aligned
    for (int i = threadIdx.x; i < D * CH / 4; i += THREADS) {
      const int o = i / (CH / 4), col = c * CH + 4 * (i % (CH / 4));
      const int live = min(max(active - col, 0), 4);
      mlp::cp_async16(rw2 + o * CH + col - c * CH, live ? md.w2 + (size_t)o * m + col : md.w2,
                      4 * live);
    }
  } else {
    for (int i = threadIdx.x; i < D * CH; i += THREADS) {
      const int o = i / CH, col = c * CH + i % CH;
      const bool live = col < active;
      cp_async4(rw2 + i, live ? md.w2 + (size_t)o * m + col : md.w2, live);
    }
  }
  mlp::cp_async_commit();
}

// v split into TF32 hi and lo, stored at `off` of the hi and lo tiles.
__device__ __forceinline__ void split_store(unsigned char* hi, unsigned char* lo, int off,
                                            float4 v) {
  uint4 h, l;
  tf32x3::split_tf32(v.x, h.x, l.x);
  tf32x3::split_tf32(v.y, h.y, l.y);
  tf32x3::split_tf32(v.z, h.z, l.z);
  tf32x3::split_tf32(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// Byte offset of 16-byte piece q (4 f32 of k) of row r in a K-major tile of
// `rows` rows: slice q / 8 of 32 columns, the 128-byte swizzle (piece q of
// a row lies at q ^ (r % 8)).
__device__ __forceinline__ int swizzled(int rows, int r, int q) {
  return (q / 8) * rows * 128 + r * 128 + (((q % 8) ^ (r % 8)) << 4);
}

// A descriptor of k-step kk (8 f32 of k) of a K-major tile of `rows` rows.
__device__ __forceinline__ uint64_t kstep_desc(const unsigned char* tile, int rows, int kk) {
  return sm90::smem_desc(tile + (kk / 4) * rows * 128 + 32 * (kk % 4), 16, 1024, 1);
}

// Grid: (splits x groups, models), clusters of (splits, 1, 1).  Block b
// takes split b % splits, the chunks [s C / S, (s + 1) C / S) of the C =
// ceil(m / 32), for the row tiles [g T / G, (g + 1) T / G) of group g = b /
// splits in turn.
template <int D>
__global__ void __launch_bounds__(THREADS)
narrow_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out, int n, int m,
                     const int* __restrict__ active_p, int active_all, int splits) {
  using S = Shape<D>;
  constexpr int KS = D / 8;  // fc1's k-steps
  constexpr int NO = D / 8;  // fc2's n-tiles of 8 output columns
  constexpr int NP2 = D < NP ? D : NP;  // output columns of an fc2 pass
  const mlp::Model<float> md(x, w1, b1, w2, b2, out, active_p, active_all, n, D, m);
  extern __shared__ __align__(16) unsigned char narrow_smem[];
  unsigned char* x_hi =
      narrow_smem + ((1024 - (sm90::smem_u32(narrow_smem) & 1023)) & 1023);
  unsigned char* x_lo = x_hi + S::X_TILE;
  unsigned char* w1_hi = x_lo + S::X_TILE;
  unsigned char* w1_lo = w1_hi + S::W1_TILE;
  unsigned char* w2_hi = w1_lo + S::W1_TILE;
  unsigned char* w2_lo = w2_hi + S::W2_TILE;
  float* raw = reinterpret_cast<float*>(w2_lo + S::W2_TILE);  // [2][RAW]
  float* red = raw;  // the partial (64 x D), once the chunks are done

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int split = blockIdx.x % splits, group = blockIdx.x / splits;
  const int groups = gridDim.x / splits, tiles = (n + ROWS - 1) / ROWS;
  const int chunks = (m + CH - 1) / CH, live = (md.active + CH - 1) / CH;
  const int k0 = (int)((long long)split * chunks / splits);
  const int mine = max(min((int)((long long)(split + 1) * chunks / splits), live) - k0, 0);
  const int first = (int)((long long)group * tiles / groups);
  const int last = (int)((long long)(group + 1) * tiles / groups);

  for (int tile = first; tile < last; ++tile) {
    const int row0 = tile * ROWS;
    float total[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) total[i] = 0.f;
    __syncthreads();  // the last tile's reads of x's tiles and the partial are done
    if (mine > 0) {
      stage<D>(raw, md, m, k0, md.active);
      if (mine > 1) {
        stage<D>(raw + S::RAW, md, m, k0 + 1, md.active);
      } else {
        mlp::cp_async_commit();  // an empty group keeps wait<1> counting chunks
      }
      // x's tile, split once: rows past n as zeros
      for (int i = tid; i < ROWS * D / 4; i += THREADS) {
        const int r = i / (D / 4), q = i % (D / 4);
        const float4 v = row0 + r < n
                             ? *reinterpret_cast<const float4*>(md.x + (size_t)(row0 + r) * D + 4 * q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        split_store(x_hi, x_lo, swizzled(ROWS, r, q), v);
      }
    }
    for (int i = 0; i < mine; ++i) {
      const int c = k0 + i;
      float* buf = raw + (i % 2) * S::RAW;
      mlp::cp_async_wait<1>();  // chunk i's copies (this thread's) landed
      __syncthreads();          // everyone's have, and the last chunk's wgmmas are done
      // this thread's b1 of the chunk, hidden columns 8j + t + 4e
      float b1c[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) b1c[k] = buf[2 * CH * D + 8 * (k / 2) + t + 4 * (k % 2)];
      {
        const float* rw1 = buf;
        const float* rw2 = buf + CH * D;
        // w1 row r at tile row 8 (r / 8) + 2 (r % 4) + (r % 8) / 4
        for (int j = tid; j < CH * D / 4; j += THREADS) {
          const int r = j / (D / 4), q = j % (D / 4);
          const int pos = (r & ~7) | ((r & 3) << 1) | ((r >> 2) & 1);
          split_store(w1_hi, w1_lo, swizzled(CH, pos, q),
                      *reinterpret_cast<const float4*>(rw1 + r * D + 4 * q));
        }
        for (int j = tid; j < D * CH / 4; j += THREADS) {
          const int o = j / (CH / 4), q = j % (CH / 4);
          split_store(w2_hi, w2_lo, swizzled(D, o, q),
                      *reinterpret_cast<const float4*>(rw2 + o * CH + 4 * q));
        }
      }
      // these generic-proxy writes (and x's), visible to the wgmmas
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // the tiles are written, the buffer read
      if (i + 2 < mine) {
        stage<D>(buf, md, m, c + 2, md.active);
      } else {
        mlp::cp_async_commit();  // an empty group keeps wait<1> counting chunks
      }

      // fc1: h = x w1_c^T in 3xTF32, K = D in one interval
      float big[16], small[16];
      sm90::fence_regs(big);
      sm90::fence_regs(small);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t xh = kstep_desc(x_hi, ROWS, kk), xl = kstep_desc(x_lo, ROWS, kk);
        const uint64_t wh = kstep_desc(w1_hi, CH, kk), wl = kstep_desc(w1_lo, CH, kk);
        tf32x3::wgmma_tf32_ss_n32(small, xl, wh, kk > 0);
        tf32x3::wgmma_tf32_ss_n32(small, xh, wl, 1);
        tf32x3::wgmma_tf32_ss_n32(big, xh, wh, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(big);
      sm90::fence_regs(small);

      // + b1, GELU, the width mask; fc2's A fragments, split.  Register 4j
      // + 2r + e of h: row g + 8r, hidden column 8j + t + 4e of the chunk.
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c * CH + 8 * j + t + 4 * e;
          const bool keep = col < md.active;
          const float bias = b1c[2 * j + e];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float h = keep ? mlp::gelu_erf((big[4 * j + 2 * r + e] +
                                                   small[4 * j + 2 * r + e]) + bias)
                                 : 0.f;
            // A register 2e + r: row g + 8r, k = t + 4e
            tf32x3::split_tf32(h, ah[j][2 * e + r], al[j][2 * e + r]);
          }
        }

      // fc2: out += h w2_c^T in 3xTF32, in passes of NP output columns
      // (rows of w2's tile), each pass's two accumulators from 0 and added
      // into the f32 sum when it retires: K = 32 an interval
#pragma unroll
      for (int p = 0; p < D / NP2; ++p) {
        float big2[NP2 / 2], small2[NP2 / 2];
        sm90::fence_regs(big2);
        sm90::fence_regs(small2);
        sm90::fence_regs(ah);
        sm90::fence_regs(al);
        sm90::wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint64_t wh = kstep_desc(w2_hi + p * NP2 * 128, D, j);
          const uint64_t wl = kstep_desc(w2_lo + p * NP2 * 128, D, j);
          tf32x3::wgmma_tf32_rs<NP2>(small2, al[j][0], al[j][1], al[j][2], al[j][3], wh, j > 0);
          tf32x3::wgmma_tf32_rs<NP2>(small2, ah[j][0], ah[j][1], ah[j][2], ah[j][3], wl, 1);
          tf32x3::wgmma_tf32_rs<NP2>(big2, ah[j][0], ah[j][1], ah[j][2], ah[j][3], wh, j > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(big2);
        sm90::fence_regs(small2);
#pragma unroll
        for (int k = 0; k < NP2 / 2; ++k) total[p * NP2 / 2 + k] += big2[k] + small2[k];
      }
    }
    mlp::cp_async_wait<0>();

    // Accumulator register 4jo + 2r + e: row 16 warp + g + 8r of the tile,
    // output column 8jo + 2t + e.
    const int rl = 16 * warp + g;
    if (splits == 1) {
#pragma unroll
      for (int jo = 0; jo < NO; ++jo) {
        const int o = 8 * jo + 2 * t;
        const float bb0 = md.b2[o], bb1 = md.b2[o + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row0 + rl + 8 * r < n)
            *reinterpret_cast<float2*>(md.out + (size_t)(row0 + rl + 8 * r) * D + o) =
                make_float2(total[4 * jo + 2 * r] + bb0, total[4 * jo + 2 * r + 1] + bb1);
      }
      continue;
    }
    __syncthreads();  // every thread's reads of the staging buffers are done
#pragma unroll
    for (int jo = 0; jo < NO; ++jo)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(red + (rl + 8 * r) * D + 8 * jo + 2 * t) =
            make_float2(total[4 * jo + 2 * r], total[4 * jo + 2 * r + 1]);
    namespace cg = cooperative_groups;
    const cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every split's partial is written
    const int lo = split * (ROWS * D) / splits, hi = (split + 1) * (ROWS * D) / splits;
    for (int e = lo + tid; e < hi; e += THREADS) {
      if (row0 + e / D >= n) continue;
      float sum = 0.f;
      for (int s = 0; s < splits; ++s) sum += cluster.map_shared_rank(red, s)[e];
      md.out[(size_t)row0 * D + e] = sum + md.b2[e % D];
    }
    cluster.sync();  // every block has read the others' partials
  }
}

// The kernel's settings, once a device: the shared-memory limit raised and
// clusters of more than 8 blocks allowed.
template <int D>
cudaError_t ready(int device) {
  static std::atomic<unsigned long long> done{0};  // one bit a device
  const unsigned long long bit =
      device >= 0 && device < sm90::MAX_DEVICES ? 1ull << device : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  const void* kernel = (const void*)narrow_tf32x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Shape<D>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int D>
cudaError_t launch_d(int device, const float* x, const float* w1, const float* b1,
                     const float* w2, const float* b2, float* out, int n, int m, int active,
                     const int* active_p, int models, int splits, int groups,
                     cudaStream_t stream) {
  cudaError_t err = ready<D>(device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * groups, models);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Shape<D>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, narrow_tf32x3_kernel<D>, x, w1, b1, w2, b2, out, n, m,
                           active_p, active, splits);
  // the runtime keeps a refused launch's error as its last one, which the
  // next launch in this thread would read back: clear it
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// One launch at hidden size d on `splits` x `groups` clusters a model (see
// the kernel), or cudaErrorInvalidValue for a width, model count or plan the
// body does not take (nothing launched).  n == 0 launches nothing.
inline cudaError_t launch(int device, const float* x, const float* w1, const float* b1,
                          const float* w2, const float* b2, float* out, int n, int d, int m,
                          int active, const int* active_p, int models, int splits, int groups,
                          cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0 || models == 0) return cudaSuccess;
  const int tiles = (n + ROWS - 1) / ROWS, chunks = (m + CH - 1) / CH;
  if (m < 1 || models > 65535 || splits < 1 || splits > MAX_SPLITS || splits > chunks ||
      groups < 1 || groups > tiles || (long long)splits * groups > 0x7fffffffLL)
    return cudaErrorInvalidValue;
#define NARROW_ARGS device, x, w1, b1, w2, b2, out, n, m, active, active_p, models, splits, \
                    groups, stream
  switch (d) {
    case 8: return launch_d<8>(NARROW_ARGS);
    case 16: return launch_d<16>(NARROW_ARGS);
    case 32: return launch_d<32>(NARROW_ARGS);
    case 64: return launch_d<64>(NARROW_ARGS);
  }
#undef NARROW_ARGS
  return cudaErrorInvalidValue;
}

// The body's shape at hidden size d: out[0] token rows a tile, [1] threads
// a block, [2] dynamic shared memory a block, [3] registers a thread, [4]
// resident blocks an SM, [5] SMs, [6] clusters of `splits` blocks the card
// holds at once.
template <int D>
cudaError_t describe_d(int device, int splits, int* out) {
  cudaError_t err = ready<D>(device);
  int per_sm = 0, sms = 0, clusters = 0;
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, narrow_tf32x3_kernel<D>,
                                                        THREADS, Shape<D>::SMEM);
  if (err == cudaSuccess) err = sm90::sm_count(device, &sms);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, narrow_tf32x3_kernel<D>);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = Shape<D>::SMEM;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = splits;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters, narrow_tf32x3_kernel<D>, &cfg);
  }
  if (err != cudaSuccess) return err;
  out[0] = ROWS;
  out[1] = THREADS;
  out[2] = (int)Shape<D>::SMEM;
  out[3] = attr.numRegs;
  out[4] = per_sm;
  out[5] = sms;
  out[6] = clusters;
  return cudaSuccess;
}

inline cudaError_t describe(int device, int d, int splits, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (splits < 1 || splits > MAX_SPLITS) return cudaErrorInvalidValue;
  switch (d) {
    case 8: return describe_d<8>(device, splits, out);
    case 16: return describe_d<16>(device, splits, out);
    case 32: return describe_d<32>(device, splits, out);
    case 64: return describe_d<64>(device, splits, out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace narrow_f32

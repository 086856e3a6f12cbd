// K1: fused FFN, out = gelu(x @ w1^T + b1)[:, :active] @ w2[:, :active]^T + b2.
//
// Replaces the TPU kernel `vit3d_ensemble_tpu/ops/pallas_mlp.py:_mlp_kernel`
// (reached through `fused_mlp` -> `_fused_mlp_impl`, variant "seq").
//
// What bounds it on the H100: at the reference widths (D in {16, 32, 64},
// M in {2048, 3072}) the (tokens, M) intermediate is M/D = 32..192 times
// larger than the input, so a plain fc1 -> GELU -> fc2 chain is bound by the
// bytes of that intermediate going to device memory and back.  Inside this
// kernel the intermediate never leaves the SM; what is left is operations:
// 4*N*D*M multiply-adds and N*M GELUs.  The GELUs run on CUDA cores in f32
// whatever the matmul units, so they, not the tensor cores, set the floor.
//
// Design: one block takes a tile of 64 token rows.  The x tile and an f32
// accumulator of (64, D) stay on chip for the whole block.  The block walks
// the hidden width in chunks of 64 columns; per chunk it stages
// w1[c0:c0+64, :] and w2[:, c0:c0+64] in shared memory, computes
// h = x @ w1c^T + b1c in f32, applies exact erf GELU in f32, rounds it to the
// input type (the rounding point of pallas_mlp.py:93), and adds h @ w2c^T into
// the accumulator.  The loop stops at `active`, and columns past it in the
// last chunk are zeroed, which is the runtime width mask of the sweep (the
// JAX wrapper folds it into w2's rows instead).  The last row tile is masked,
// so no padding is needed.  Two bodies share that plan:
//   * bf16 with D in {16, 32, 64} (the serving path): both products on the
//     tensor cores (mma.sync, f32 accumulation), h kept in registers between
//     them, weight chunks double-buffered with cp.async (see below).
//   * f32, and D = 8: CUDA-core FMAs, each thread a 4x4 register tile of h,
//     h staged through shared memory between the two products.
//
// The wide regime, D a multiple of 64 from 128 to 1024 (the stretch model's
// D = 768, M = 3072).  What bounds it there: operations.  M / D is 4, so the
// intermediate is no longer the larger part of the bytes, and 4*N*D*M
// multiply-adds at the tensor-core peak (39 us at N = 4,104 in bf16) exceed
// the time of every byte.  The plan above does not carry over: a (64, D) f32
// accumulator is 196 KB at D = 768, three quarters of an SM's registers, and
// the x tile no longer fits registers either.  Of the plans that do fit, a
// block per (row tile, slab of output columns) computes fc1 once per slab, a
// multiple of the operations that bound the kernel, and a cluster of blocks
// that shares h through distributed shared memory is a larger design than a
// first version needs.  So the wide bodies shorten the row tile until the
// full-D accumulator fits the registers, and pay for it by streaming both
// weight matrices through every block (out of L2, which holds them):
//   * bf16: a tile of 32 rows, 8 warps, chunks of 32 hidden columns.  The x
//     tile stays in shared memory; fc1 loops over D with all 8 warps on one
//     (32, 32) chunk of h (2 row groups x 4 column tiles), which passes
//     through shared memory as bf16 (K1's rounding point) to fc2, where a
//     warp owns 16 rows and a quarter of the D output columns: 96 f32
//     accumulators a thread at D = 768.  w1's chunk streams in under fc2 and
//     w2's under fc1 (cp.async, one group each).
//   * f32: a tile of 16 rows, 256 threads, chunks of 16 hidden columns, CUDA
//     cores with 16-byte shared-memory reads; a thread owns one h entry in
//     fc1 and one row by D / 16 columns in fc2.  The chunks are staged with
//     cp.async too, but not ahead of their use.
//
// Layouts follow torch.nn.Linear: x (n, D), w1 (m, D), b1 (m), w2 (D, m),
// b2 (D), out (n, D), all contiguous.  f32 or bf16, f32 accumulation.
//
// The model axis (the sweep's stacked (config, fold) cells), narrow regime
// only: the narrow bodies take P weight sets stacked along a leading axis
// and run model p on blockIdx.y, with its own width mask read from device
// memory (`mlp_common.cuh`, `Model`).  They are compiled twice, with and
// without the axis (AXIS), so a single model with a host width runs the
// code it ran before the axis existed.  The wide bodies have no model
// axis: on an H100, in one call against the bodies without it, the offsets
// and the width held in registers cost them registers and time beyond the
// grid dimension, so a stacked call at a wide D is refused.

#include "mlp_common.cuh"

namespace {

using namespace mlp;

constexpr int TILE_N = 64;    // token rows per block
constexpr int CHUNK = 64;     // hidden columns per step
constexpr int THREADS = 256;  // CUDA-core body: a 16 x 16 grid of threads

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(TILE_N * (D + 1) + CHUNK * (D + 1) +
                                  TILE_N * (CHUNK + 1) + D * (CHUNK + 1));
}

template <typename T, int D, bool AXIS>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ b2, T* __restrict__ out, int n, int m,
                 const int* __restrict__ active_p, int active_all) {
  int active = active_all;
  if constexpr (AXIS) {
    const Model<T> md(x, w1, b1, w2, b2, out, active_p, active_all, n, D, m);
    x = md.x, w1 = md.w1, b1 = md.b1, w2 = md.w2, b2 = md.b2, out = md.out;
    active = md.active;
  }
  constexpr int DP = D + 1;          // padded rows: odd strides, no bank conflicts
  constexpr int CP = CHUNK + 1;
  constexpr int OJ = (D + 15) / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* xs = smem;               // [TILE_N][DP]
  float* w1s = xs + TILE_N * DP;  // [CHUNK][DP]
  float* hs = w1s + CHUNK * DP;   // [TILE_N][CP]
  float* w2s = hs + TILE_N * CP;  // [D][CP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * TILE_N;

  for (int i = tid; i < TILE_N * D; i += THREADS) {
    const int r = i / D, d = i % D;
    xs[r * DP + d] = row0 + r < n ? to_f32(x[(size_t)(row0 + r) * D + d]) : 0.f;
  }

  // Rows ty + 16*i and output columns tx + 16*j of the tile belong to this thread.
  float acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < active; c0 += CHUNK) {
    __syncthreads();  // the previous chunk's reads of w1s, hs and w2s are done
    for (int i = tid; i < CHUNK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      w1s[c * DP + d] = c0 + c < active ? to_f32(w1[(size_t)(c0 + c) * D + d]) : 0.f;
    }
    for (int i = tid; i < D * CHUNK; i += THREADS) {
      const int o = i / CHUNK, c = i % CHUNK;
      w2s[o * CP + c] = c0 + c < active ? to_f32(w2[(size_t)o * m + c0 + c]) : 0.f;
    }
    __syncthreads();

    float h[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w1s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) h[i][j] = fmaf(xv[i], wv[j], h[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      const bool keep = col < active;
      const float bias = keep ? to_f32(b1[col]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // gelu(h) rounded to the input type before fc2, as the TPU kernel does
        const float g = to_f32(from_f32<T>(gelu_erf(h[i][j] + bias)));
        hs[(ty + 16 * i) * CP + tx + 16 * j] = keep ? g : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < CHUNK; ++c) {
      float gv[4], wv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = hs[(ty + 16 * i) * CP + c];
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const int o = tx + 16 * j;
        wv[j] = o < D ? w2s[o * CP + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) acc[i][j] = fmaf(gv[i], wv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < OJ; ++j) {
    const int o = tx + 16 * j;
    if (o >= D) continue;
    const float bias = to_f32(b2[o]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r < n) out[(size_t)r * D + o] = from_f32<T>(acc[i][j] + bias);
    }
  }
}

// Tensor-core body for bf16, D in {16, 32, 64}.  Four warps, each owning 16
// of the tile's 64 rows, run mma.sync m16n8k16 (bf16 in, f32 accumulate).
// A warp keeps its x rows as A fragments in registers for the whole kernel.
// Per chunk, fc1 leaves h in accumulator registers laid out exactly as the
// A fragments of fc2 (row g = lane/4 holds columns 2*(lane%4)+{0,1} of every
// 8-column tile), so bias, GELU and the bf16 rounding happen in registers
// and h is never stored anywhere.  Only the weight chunks go through shared
// memory, double-buffered with cp.async so the next chunk streams in while
// this one computes.
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;

template <int D>
struct TcStage {  // one buffer of a weight chunk in shared memory
  static constexpr int XP = D + 8;       // w1 rows: D values + 16 bytes of pad
  static constexpr int CP = CHUNK + 8;   // w2 rows: CHUNK values + 16 bytes of pad
  __nv_bfloat16 w1[CHUNK * XP];          // w1[c0 + c, :] at w1[c * XP]
  __nv_bfloat16 w2[D * CP];              // w2[o, c0:c0+CHUNK] at w2[o * CP]
  float b1[CHUNK];
};

// Stage w1[c0:c0+CHUNK, :], w2[:, c0:c0+CHUNK] and b1[c0:c0+CHUNK], zero past
// `active`.  w2 rows go by 16-byte copies when m % 8 == 0 (every piece then
// starts 16-byte aligned), else element by element.
template <int D>
__device__ __forceinline__ void tc_stage(TcStage<D>& st, const __nv_bfloat16* w1,
                                         const __nv_bfloat16* b1,
                                         const __nv_bfloat16* w2, int m, int c0,
                                         int active) {
  constexpr int XP = TcStage<D>::XP, CP = TcStage<D>::CP;
  for (int i = threadIdx.x; i < CHUNK * (D / 8); i += TC_THREADS) {
    const int c = i / (D / 8), p = i % (D / 8);
    const bool live = c0 + c < active;
    cp_async16(st.w1 + c * XP + p * 8, live ? w1 + (size_t)(c0 + c) * D + p * 8 : w1,
               live ? 16 : 0);
  }
  if (m % 8 == 0) {
    for (int i = threadIdx.x; i < D * (CHUNK / 8); i += TC_THREADS) {
      const int o = i / (CHUNK / 8), col = c0 + (i % (CHUNK / 8)) * 8;
      const int live = min(max(active - col, 0), 8);
      cp_async16(st.w2 + o * CP + col - c0, live ? w2 + (size_t)o * m + col : w2, 2 * live);
    }
  } else {
    for (int i = threadIdx.x; i < D * CHUNK; i += TC_THREADS) {
      const int o = i / CHUNK, c = i % CHUNK;
      st.w2[o * CP + c] =
          c0 + c < active ? w2[(size_t)o * m + c0 + c] : __float2bfloat16(0.f);
    }
  }
  for (int c = threadIdx.x; c < CHUNK; c += TC_THREADS)
    st.b1[c] = c0 + c < active ? __bfloat162float(b1[c0 + c]) : 0.f;
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int D, bool AXIS>
__global__ void __launch_bounds__(TC_THREADS)
fused_mlp_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w1,
                    const __nv_bfloat16* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ w2,
                    const __nv_bfloat16* __restrict__ b2,
                    __nv_bfloat16* __restrict__ out, int n, int m,
                    const int* __restrict__ active_p, int active_all) {
  int active = active_all;
  if constexpr (AXIS) {
    const Model<__nv_bfloat16> md(x, w1, b1, w2, b2, out, active_p, active_all, n, D, m);
    x = md.x, w1 = md.w1, b1 = md.b1, w2 = md.w2, b2 = md.b2, out = md.out;
    active = md.active;
  }
  constexpr int XP = TcStage<D>::XP, CP = TcStage<D>::CP;
  constexpr int KX = D / 16;  // fc1 k-steps
  constexpr int NO = D / 8;   // fc2 output tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcStage<D>* stage = reinterpret_cast<TcStage<D>*>(smem_raw);  // [2]

  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_lo = blockIdx.x * TILE_N + (threadIdx.x / 32) * 16 + g;
  const int r_hi = r_lo + 8;

  // x rows r_lo and r_hi as fc1's A fragments, zero past the last row
  uint32_t xa[KX][4];
#pragma unroll
  for (int s = 0; s < KX; ++s) {
    const int k = 16 * s + 2 * t;
    xa[s][0] = r_lo < n ? *reinterpret_cast<const uint32_t*>(x + (size_t)r_lo * D + k) : 0u;
    xa[s][1] = r_hi < n ? *reinterpret_cast<const uint32_t*>(x + (size_t)r_hi * D + k) : 0u;
    xa[s][2] = r_lo < n ? *reinterpret_cast<const uint32_t*>(x + (size_t)r_lo * D + k + 8) : 0u;
    xa[s][3] = r_hi < n ? *reinterpret_cast<const uint32_t*>(x + (size_t)r_hi * D + k + 8) : 0u;
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (active > 0) tc_stage<D>(stage[0], w1, b1, w2, m, 0, active);
  for (int c0 = 0, buf = 0; c0 < active; c0 += CHUNK, buf ^= 1) {
    if (c0 + CHUNK < active) {
      tc_stage<D>(stage[buf ^ 1], w1, b1, w2, m, c0 + CHUNK, active);
      asm volatile("cp.async.wait_group 1;\n" ::);  // this chunk's copies landed
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const TcStage<D>& st = stage[buf];

    // h = x @ w1c^T, 8 tiles of 8 hidden columns.  Columns past `active`
    // have zero weights and bias, so h = 0 there and gelu(0) = 0.
    float h[CHUNK / 8][4];
#pragma unroll
    for (int j = 0; j < CHUNK / 8; ++j) {
      h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
      const __nv_bfloat16* wp = st.w1 + (8 * j + g) * XP + 2 * t;
#pragma unroll
      for (int s = 0; s < KX; ++s) mma_bf16(h[j], xa[s], lds32(wp + 16 * s), lds32(wp + 16 * s + 8));
    }

    // + b1, GELU in f32, rounded to bf16 (pallas_mlp.py:93), straight into
    // fc2's A fragments; then acc += gelu(h) @ w2c^T
#pragma unroll
    for (int s = 0; s < CHUNK / 16; ++s) {
      uint32_t ha[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * s + half;
        const float bb0 = st.b1[8 * j + 2 * t], bb1 = st.b1[8 * j + 2 * t + 1];
        ha[2 * half] = pack_bf16(gelu_erf(h[j][0] + bb0), gelu_erf(h[j][1] + bb1));
        ha[2 * half + 1] = pack_bf16(gelu_erf(h[j][2] + bb0), gelu_erf(h[j][3] + bb1));
      }
#pragma unroll
      for (int jo = 0; jo < NO; ++jo) {
        const __nv_bfloat16* wp = st.w2 + (8 * jo + g) * CP + 16 * s + 2 * t;
        mma_bf16(acc[jo], ha, lds32(wp), lds32(wp + 8));
      }
    }
    __syncthreads();  // every warp is done with stage[buf] before it is refilled
  }

#pragma unroll
  for (int jo = 0; jo < NO; ++jo) {
    const int o = 8 * jo + 2 * t;
    const float bb0 = __bfloat162float(b2[o]), bb1 = __bfloat162float(b2[o + 1]);
    if (r_lo < n)
      *reinterpret_cast<uint32_t*>(out + (size_t)r_lo * D + o) =
          pack_bf16(acc[jo][0] + bb0, acc[jo][1] + bb1);
    if (r_hi < n)
      *reinterpret_cast<uint32_t*>(out + (size_t)r_hi * D + o) =
          pack_bf16(acc[jo][2] + bb0, acc[jo][3] + bb1);
  }
}

// ---------------------------------------------------------------------------
// The wide regime: D a multiple of 64, 128 <= D <= 1024 (see the note above).
// ---------------------------------------------------------------------------

constexpr int W_ROWS = 32;     // token rows per block
constexpr int W_CHUNK = 32;    // hidden columns per step
constexpr int W_THREADS = 256; // 8 warps: 2 row groups x 4 column groups
constexpr int W_CP = W_CHUNK + 8;  // w2 and h rows: 16 bytes of pad

constexpr size_t wide_tc_smem_bytes(int d) {
  return sizeof(__nv_bfloat16) * (size_t)(2 * W_ROWS * (d + 8) + d * W_CP + W_ROWS * W_CP) +
         sizeof(float) * W_CHUNK;
}

// Stage w1[c0:c0+W_CHUNK, :] and b1[c0:c0+W_CHUNK], zero past `active`.
__device__ __forceinline__ void wide_stage_w1(__nv_bfloat16* w1s, float* b1s,
                                              const __nv_bfloat16* w1,
                                              const __nv_bfloat16* b1, int d, int c0,
                                              int active) {
  const int xp = d + 8, pieces = d / 8;
  for (int i = threadIdx.x; i < W_CHUNK * pieces; i += W_THREADS) {
    const int c = i / pieces, p = i % pieces;
    const bool live = c0 + c < active;
    cp_async16(w1s + c * xp + p * 8, live ? w1 + (size_t)(c0 + c) * d + p * 8 : w1,
               live ? 16 : 0);
  }
  for (int c = threadIdx.x; c < W_CHUNK; c += W_THREADS)
    b1s[c] = c0 + c < active ? __bfloat162float(b1[c0 + c]) : 0.f;
}

// Stage w2[:, c0:c0+W_CHUNK], zero past `active`: 16-byte copies when
// m % 8 == 0 (every piece then starts 16-byte aligned), else by element.
__device__ __forceinline__ void wide_stage_w2(__nv_bfloat16* w2s, const __nv_bfloat16* w2,
                                              int d, int m, int c0, int active) {
  if (m % 8 == 0) {
    for (int i = threadIdx.x; i < d * (W_CHUNK / 8); i += W_THREADS) {
      const int o = i / (W_CHUNK / 8), col = c0 + (i % (W_CHUNK / 8)) * 8;
      const int live = min(max(active - col, 0), 8);
      cp_async16(w2s + o * W_CP + col - c0, live ? w2 + (size_t)o * m + col : w2, 2 * live);
    }
  } else {
    for (int i = threadIdx.x; i < d * W_CHUNK; i += W_THREADS) {
      const int o = i / W_CHUNK, c = i % W_CHUNK;
      w2s[o * W_CP + c] =
          c0 + c < active ? w2[(size_t)o * m + c0 + c] : __float2bfloat16(0.f);
    }
  }
}

// NT: the output tiles of 8 columns a warp may own, so D <= 32 * NT.
template <int NT>
__global__ void __launch_bounds__(W_THREADS)
fused_mlp_wide_tc_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w1,
                         const __nv_bfloat16* __restrict__ b1,
                         const __nv_bfloat16* __restrict__ w2,
                         const __nv_bfloat16* __restrict__ b2,
                         __nv_bfloat16* __restrict__ out, int n, int d, int m, int active) {
  const int xp = d + 8;  // x and w1 rows: D values + 16 bytes of pad
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [W_ROWS][xp]
  __nv_bfloat16* w1s = xs + W_ROWS * xp;                           // [W_CHUNK][xp]
  __nv_bfloat16* w2s = w1s + W_CHUNK * xp;                         // [d][W_CP]
  __nv_bfloat16* hs = w2s + d * W_CP;                              // [W_ROWS][W_CP]
  float* b1s = reinterpret_cast<float*>(hs + W_ROWS * W_CP);       // [W_CHUNK]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / 4, cg = warp % 4;  // row group of 16, column group
  const int row0 = blockIdx.x * W_ROWS;
  const int nt = d / 32;        // this warp's output tiles: columns o0 + 8*j
  const int o0 = cg * (d / 4);

  // the x tile, zero past the last row; it lands with w1's first chunk
  for (int i = threadIdx.x; i < W_ROWS * (d / 8); i += W_THREADS) {
    const int r = i / (d / 8), p = i % (d / 8);
    const bool live = row0 + r < n;
    cp_async16(xs + r * xp + p * 8, live ? x + (size_t)(row0 + r) * d + p * 8 : x,
               live ? 16 : 0);
  }
  wide_stage_w1(w1s, b1s, w1, b1, d, 0, active);
  asm volatile("cp.async.commit_group;\n" ::);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const __nv_bfloat16* xr = xs + (16 * rg + g) * xp + 2 * t;   // x rows g, g + 8
  const __nv_bfloat16* w1r = w1s + (8 * cg + g) * xp + 2 * t;  // hidden column g
  __nv_bfloat16* hw = hs + (16 * rg + g) * W_CP + 8 * cg + 2 * t;
  const __nv_bfloat16* hr = hs + (16 * rg + g) * W_CP + 2 * t;

  for (int c0 = 0; c0 < active; c0 += W_CHUNK) {
    wide_stage_w2(w2s, w2, d, m, c0, active);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // w1's chunk (and x) landed
    __syncthreads();

    // fc1: this warp's (16, 8) tile of h = x @ w1c^T.  Columns past `active`
    // have zero weights and bias, so h = 0 there and gelu(0) = 0.
    // Four partial sums over interleaved k-steps, so that one mma need not
    // wait for the one before it (D is a multiple of 64).
    float hp[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) hp[u][0] = hp[u][1] = hp[u][2] = hp[u][3] = 0.f;
    for (int k0 = 0; k0 < d; k0 += 64) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + 16 * u;
        const uint32_t a[4] = {lds32(xr + k), lds32(xr + 8 * xp + k), lds32(xr + k + 8),
                               lds32(xr + 8 * xp + k + 8)};
        mma_bf16(hp[u], a, lds32(w1r + k), lds32(w1r + k + 8));
      }
    }
    float h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = (hp[0][e] + hp[1][e]) + (hp[2][e] + hp[3][e]);
    // + b1, GELU in f32, rounded to bf16 (pallas_mlp.py:93), to shared memory
    const float bb0 = b1s[8 * cg + 2 * t], bb1 = b1s[8 * cg + 2 * t + 1];
    *reinterpret_cast<uint32_t*>(hw) = pack_bf16(gelu_erf(h[0] + bb0), gelu_erf(h[1] + bb1));
    *reinterpret_cast<uint32_t*>(hw + 8 * W_CP) =
        pack_bf16(gelu_erf(h[2] + bb0), gelu_erf(h[3] + bb1));
    __syncthreads();  // h is whole; every warp is done with w1s and b1s

    if (c0 + W_CHUNK < active) wide_stage_w1(w1s, b1s, w1, b1, d, c0 + W_CHUNK, active);
    asm volatile("cp.async.commit_group;\n" ::);  // an empty group after the last chunk
    asm volatile("cp.async.wait_group 1;\n" ::);  // w2's chunk landed
    __syncthreads();

    // fc2: acc += gelu(h) @ w2c^T over this warp's 16 rows and nt column tiles
#pragma unroll
    for (int s = 0; s < W_CHUNK / 16; ++s) {
      const uint32_t ha[4] = {lds32(hr + 16 * s), lds32(hr + 8 * W_CP + 16 * s),
                              lds32(hr + 16 * s + 8), lds32(hr + 8 * W_CP + 16 * s + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          const __nv_bfloat16* wp = w2s + (o0 + 8 * j + g) * W_CP + 16 * s + 2 * t;
          mma_bf16(acc[j], ha, lds32(wp), lds32(wp + 8));
        }
      }
    }
    __syncthreads();  // every warp is done with w2s and hs before they are refilled
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  const int r_lo = row0 + 16 * rg + g, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int o = o0 + 8 * j + 2 * t;
      const float bb0 = __bfloat162float(b2[o]), bb1 = __bfloat162float(b2[o + 1]);
      if (r_lo < n)
        *reinterpret_cast<uint32_t*>(out + (size_t)r_lo * d + o) =
            pack_bf16(acc[j][0] + bb0, acc[j][1] + bb1);
      if (r_hi < n)
        *reinterpret_cast<uint32_t*>(out + (size_t)r_hi * d + o) =
            pack_bf16(acc[j][2] + bb0, acc[j][3] + bb1);
    }
  }
}

constexpr int F_ROWS = 16;   // token rows per block
constexpr int F_CHUNK = 16;  // hidden columns per step
constexpr int F_CP = F_CHUNK + 4;  // w2 and h rows: 16 bytes of pad

constexpr size_t wide_f32_smem_bytes(int d) {
  return sizeof(float) * (size_t)((F_ROWS + F_CHUNK) * (d + 4) + d * F_CP + F_ROWS * F_CP);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// JMAX: the output columns a thread may own, so D <= 16 * JMAX.
template <int JMAX>
__global__ void __launch_bounds__(THREADS)
fused_mlp_wide_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                          const float* __restrict__ b1, const float* __restrict__ w2,
                          const float* __restrict__ b2, float* __restrict__ out, int n, int d,
                          int m, int active) {
  const int xp = d + 4;  // rows stay 16-byte aligned and start 4 banks apart
  extern __shared__ __align__(16) float wide_smem[];
  float* xs = wide_smem;          // [F_ROWS][xp]
  float* w1s = xs + F_ROWS * xp;  // [F_CHUNK][xp]
  float* w2s = w1s + F_CHUNK * xp;  // [d][F_CP]
  float* hs = w2s + d * F_CP;     // [F_ROWS][F_CP]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // row ty; h column tx, output columns tx + 16*j
  const int row0 = blockIdx.x * F_ROWS;
  const int nj = d / 16;

  // the x tile, zero past the last row; it lands with the first weight chunks
  for (int i = tid; i < F_ROWS * (d / 4); i += THREADS) {
    const int r = i / (d / 4), p = i % (d / 4);
    const bool live = row0 + r < n;
    cp_async16(xs + r * xp + p * 4, live ? x + (size_t)(row0 + r) * d + p * 4 : x,
               live ? 16 : 0);
  }

  float acc[JMAX];
#pragma unroll
  for (int j = 0; j < JMAX; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < active; c0 += F_CHUNK) {
    __syncthreads();  // the previous chunk's reads of w1s, hs and w2s are done
    // both weight chunks by 16-byte copies, zero past `active`; w2's rows by
    // element when m % 4 != 0 (its pieces are then not 16-byte aligned)
    for (int i = tid; i < F_CHUNK * (d / 4); i += THREADS) {
      const int c = i / (d / 4), p = i % (d / 4);
      const bool live = c0 + c < active;
      cp_async16(w1s + c * xp + p * 4, live ? w1 + (size_t)(c0 + c) * d + p * 4 : w1,
                 live ? 16 : 0);
    }
    if (m % 4 == 0) {
      for (int i = tid; i < d * (F_CHUNK / 4); i += THREADS) {
        const int o = i / (F_CHUNK / 4), col = c0 + (i % (F_CHUNK / 4)) * 4;
        const int live = min(max(active - col, 0), 4);
        cp_async16(w2s + o * F_CP + col - c0, live ? w2 + (size_t)o * m + col : w2, 4 * live);
      }
    } else {
      for (int i = tid; i < d * F_CHUNK; i += THREADS) {
        const int o = i / F_CHUNK, c = i % F_CHUNK;
        w2s[o * F_CP + c] = c0 + c < active ? w2[(size_t)o * m + c0 + c] : 0.f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    float h = 0.f;
    const float4* xr = reinterpret_cast<const float4*>(xs + ty * xp);
    const float4* wr = reinterpret_cast<const float4*>(w1s + tx * xp);
#pragma unroll 4
    for (int k = 0; k < d / 4; ++k) h = dot4(xr[k], wr[k], h);
    const int col = c0 + tx;
    hs[ty * F_CP + tx] = col < active ? gelu_erf(h + b1[col]) : 0.f;
    __syncthreads();

    const float4* hr = reinterpret_cast<const float4*>(hs + ty * F_CP);
#pragma unroll
    for (int c = 0; c < F_CHUNK / 4; ++c) {
      const float4 hv = hr[c];
#pragma unroll
      for (int j = 0; j < JMAX; ++j) {
        if (j < nj)
          acc[j] = dot4(hv, *reinterpret_cast<const float4*>(w2s + (tx + 16 * j) * F_CP + 4 * c),
                        acc[j]);
      }
    }
  }

  asm volatile("cp.async.wait_all;\n" ::);  // the x tile, when no chunk ran
  const int r = row0 + ty;
  if (r >= n) return;
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    if (j < nj) out[(size_t)r * d + tx + 16 * j] = acc[j] + b2[tx + 16 * j];
  }
}

template <typename T, int D, bool AXIS>
cudaError_t launch_axis(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, int n, int m, const int* active_p,
                        int active, int models, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T, D, AXIS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE_N - 1) / TILE_N, models);
  fused_mlp_kernel<T, D, AXIS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), n, m,
      active_p, active);
  return cudaGetLastError();
}

// The model axis when there is one: more than one model, or a width on the
// device.
template <typename T, int D>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int n, int m, const int* active_p,
                   int active, int models, cudaStream_t stream) {
  return models > 1 || active_p != nullptr
             ? launch_axis<T, D, true>(x, w1, b1, w2, b2, out, n, m, active_p, active,
                                       models, stream)
             : launch_axis<T, D, false>(x, w1, b1, w2, b2, out, n, m, active_p, active,
                                        models, stream);
}

template <int D, bool AXIS>
cudaError_t launch_tc_axis(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, int n, int m, const int* active_p,
                           int active, int models, cudaStream_t stream) {
  constexpr size_t smem = 2 * sizeof(TcStage<D>);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_tc_kernel<D, AXIS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  const dim3 grid((n + TILE_N - 1) / TILE_N, models);
  fused_mlp_tc_kernel<D, AXIS><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(out), n,
      m, active_p, active);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* out, int n, int m, const int* active_p,
                      int active, int models, cudaStream_t stream) {
  return models > 1 || active_p != nullptr
             ? launch_tc_axis<D, true>(x, w1, b1, w2, b2, out, n, m, active_p, active,
                                       models, stream)
             : launch_tc_axis<D, false>(x, w1, b1, w2, b2, out, n, m, active_p, active,
                                        models, stream);
}

template <int NT>
cudaError_t launch_wide_tc(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, int n, int d, int m, int active,
                           cudaStream_t stream) {
  const size_t smem = wide_tc_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_wide_tc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  const dim3 grid((n + W_ROWS - 1) / W_ROWS);
  fused_mlp_wide_tc_kernel<NT><<<grid, W_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(out), n,
      d, m, active);
  return cudaGetLastError();
}

template <int JMAX>
cudaError_t launch_wide_f32(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int n, int d, int m, int active,
                            cudaStream_t stream) {
  const size_t smem = wide_f32_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_wide_f32_kernel<JMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + F_ROWS - 1) / F_ROWS);
  fused_mlp_wide_f32_kernel<JMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), n,
      d, m, active);
  return cudaGetLastError();
}

// The wide regime's kernels are instantiated per quarter of its range: the
// accumulators of a thread are sized for D up to 256, 512, 768 and 1024.
bool is_wide(int d) { return d > 64 && d <= 1024 && d % 64 == 0; }

cudaError_t dispatch_wide(int dtype, const void* x, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* out, int n, int d, int m,
                          int active, cudaStream_t stream) {
#define CASE(Q)                                                                            \
  case Q:                                                                                  \
    return dtype == 1                                                                      \
               ? launch_wide_tc<8 * Q>(x, w1, b1, w2, b2, out, n, d, m, active, stream)    \
               : launch_wide_f32<16 * Q>(x, w1, b1, w2, b2, out, n, d, m, active, stream);
  switch ((d + 255) / 256) {
    CASE(1) CASE(2) CASE(3) CASE(4)
    default: return cudaErrorInvalidValue;
  }
#undef CASE
}

#define MLP_ARGS x, w1, b1, w2, b2, out, n, m, active_p, active, models, stream

cudaError_t dispatch_bf16(int d, const void* x, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* out, int n, int m,
                          const int* active_p, int active, int models, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<__nv_bfloat16, 8>(MLP_ARGS);
    case 16: return launch_tc<16>(MLP_ARGS);
    case 32: return launch_tc<32>(MLP_ARGS);
    case 64: return launch_tc<64>(MLP_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32(int d, const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out, int n, int m,
                         const int* active_p, int active, int models, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<float, 8>(MLP_ARGS);
    case 16: return launch<float, 16>(MLP_ARGS);
    case 32: return launch<float, 32>(MLP_ARGS);
    case 64: return launch<float, 64>(MLP_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// n token rows per model, `models` weight sets (P >= 1).  active_p: the
// width mask of each model on the device, or null for `active` in all; the
// wide regime takes one model and a host width only.  dtype: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError() after the launch (0 on
// success).  n == 0 launches nothing.
extern "C" int fused_mlp_launch(int device, const void* x, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                void* out, int n, int d, int m, int active,
                                const int* active_p, int models, int dtype,
                                void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || models == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if ((dtype == 0 || dtype == 1) && is_wide(d)) {
    if (models != 1 || active_p != nullptr) return (int)cudaErrorInvalidValue;
    return (int)dispatch_wide(dtype, x, w1, b1, w2, b2, out, n, d, m, active, stream);
  }
  if (dtype == 0) return (int)dispatch_f32(d, MLP_ARGS);
  if (dtype == 1) return (int)dispatch_bf16(d, MLP_ARGS);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

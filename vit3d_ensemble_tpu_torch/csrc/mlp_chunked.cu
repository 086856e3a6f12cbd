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
//
// Design: a block owns 64 token rows of one model (blockIdx.y, as K1) and
// runs 8 warps in two roles that hand hidden columns over in sub-chunks of
// 64 through two buffers of h in shared memory:
//   * 4 producer warps compute h = gelu(x @ w1s^T + b1s), rounded to the
//     input type (the TPU kernel's rounding point), for sub-chunk j into
//     h[j % 2];
//   * 4 consumer warps add h[(j - 1) % 2] @ w2s^T of sub-chunk j - 1 into a
//     partial sum, and fold the partial into the f32 accumulator at the end
//     of every 512-column chunk, which is the TPU kernel's order of sums.
// Named barriers hand the buffers over: a producer arrives at FULL[b] when
// h[b] is written and waits at EMPTY[b] before writing it again; a consumer
// waits at FULL[b] and arrives at EMPTY[b] when it has read h[b].  Each role
// stages its own weights: the producers w1's and b1's sub-chunk, the
// consumers w2's, each double-buffered.
//
// The budget: a 512-column chunk of both weight slabs is 128 KB in bf16 at
// D = 64 (256 KB in f32), more than a block's 227 KB next to the h buffers.
// Sub-chunks of 64 columns keep every buffer at 9 KB (bf16) or 17 KB (f32):
// 55 KB a block in bf16, 117 KB in f32 at D = 64.  The hand-over unit and
// the summation chunk are separate, so the sums keep the TPU kernel's order.
//
// Two bodies share that plan:
//   * bf16 with D in {16, 32, 64}: both products on the tensor cores
//     (mma.sync m16n8k16, f32 accumulation); weights staged with cp.async
//     one sub-chunk ahead; h passes through shared memory in bf16;
//   * f32, and D = 8: CUDA-core FMAs; each role's thread owns 8 rows by 4
//     columns of h (producers) or by D / 16 output columns (consumers).

#include "mlp_common.cuh"

namespace {

using namespace mlp;
using bf16 = __nv_bfloat16;

constexpr int TILE_N = 64;         // token rows per block
constexpr int CHUNK_M = 512;       // fc2's summation chunk (`pallas_mlp.py:123`)
constexpr int SUB = 64;            // hidden columns per hand-over
constexpr int SUBS_PER_CHUNK = CHUNK_M / SUB;
constexpr int ROLE_THREADS = 128;  // 4 warps a role
constexpr int THREADS = 2 * ROLE_THREADS;

// named barrier ids; FULL0 + b and EMPTY0 + b for buffer b
constexpr int FULL0 = 1, EMPTY0 = 3, PRODUCERS = 5, CONSUMERS = 6;

__device__ __forceinline__ bool chunk_ends(int j, int subs) {
  return j % SUBS_PER_CHUNK == SUBS_PER_CHUNK - 1 || j == subs - 1;
}

// ---------------------------------------------------------------------------
// Tensor-core body: bf16, D in {16, 32, 64}.
// ---------------------------------------------------------------------------

template <int D>
struct TcSmem {
  static constexpr int XP = D + 8;    // w1 rows: D values + 16 bytes of pad
  static constexpr int SP = SUB + 8;  // w2 and h rows: SUB values + 16 bytes
  bf16 w1[2][SUB * XP];               // w1[c0 + c, :] at w1[b][c * XP]
  float b1[2][SUB];
  bf16 w2[2][D * SP];                 // w2[o, c0:c0+SUB] at w2[b][o * SP]
  bf16 h[2][TILE_N * SP];             // h[r, c0 + c] at h[b][r * SP + c]
};

// Producers stage w1[c0:c0+SUB, :] and b1[c0:c0+SUB], zero past `active`.
template <int D>
__device__ __forceinline__ void tc_stage_w1(TcSmem<D>& s, int b, const bf16* w1,
                                            const bf16* b1, int c0, int active, int rt) {
  constexpr int XP = TcSmem<D>::XP;
  for (int i = rt; i < SUB * (D / 8); i += ROLE_THREADS) {
    const int c = i / (D / 8), p = i % (D / 8);
    const bool live = c0 + c < active;
    cp_async16(s.w1[b] + c * XP + p * 8, live ? w1 + (size_t)(c0 + c) * D + p * 8 : w1,
               live ? 16 : 0);
  }
  for (int c = rt; c < SUB; c += ROLE_THREADS)
    s.b1[b][c] = c0 + c < active ? __bfloat162float(b1[c0 + c]) : 0.f;
  cp_async_commit();
}

// Consumers stage w2[:, c0:c0+SUB], zero past `active`: 16-byte copies when
// m % 8 == 0 (every piece then starts 16-byte aligned), else by element.
template <int D>
__device__ __forceinline__ void tc_stage_w2(TcSmem<D>& s, int b, const bf16* w2, int m,
                                            int c0, int active, int rt) {
  constexpr int SP = TcSmem<D>::SP;
  if (m % 8 == 0) {
    for (int i = rt; i < D * (SUB / 8); i += ROLE_THREADS) {
      const int o = i / (SUB / 8), col = c0 + (i % (SUB / 8)) * 8;
      const int live = min(max(active - col, 0), 8);
      cp_async16(s.w2[b] + o * SP + col - c0, live ? w2 + (size_t)o * m + col : w2, 2 * live);
    }
  } else {
    for (int i = rt; i < D * SUB; i += ROLE_THREADS) {
      const int o = i / SUB, c = i % SUB;
      s.w2[b][o * SP + c] = c0 + c < active ? w2[(size_t)o * m + c0 + c] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
chunked_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ b2, bf16* __restrict__ out, int n, int m,
                  const int* __restrict__ active_p, int active_all) {
  const Model<bf16> md(x, w1, b1, w2, b2, out, active_p, active_all, n, D, m);
  constexpr int XP = TcSmem<D>::XP, SP = TcSmem<D>::SP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcSmem<D>& s = *reinterpret_cast<TcSmem<D>*>(smem_raw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = threadIdx.x % ROLE_THREADS;  // thread index within its role
  const int rows = (warp % 4) * 16;           // this warp's 16 rows of the tile
  const int r_lo = blockIdx.x * TILE_N + rows + g, r_hi = r_lo + 8;
  const int active = md.active;
  const int subs = (active + SUB - 1) / SUB;

  if (warp < 4) {
    // ---- producers: h = gelu(x @ w1s^T + b1s) ----
    constexpr int KX = D / 16;
    uint32_t xa[KX][4];  // x rows r_lo, r_hi as fc1's A fragments, zero past n
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const int c = 16 * k + 2 * t;
      const bf16* lo = md.x + (size_t)r_lo * D + c;
      const bf16* hi = md.x + (size_t)r_hi * D + c;
      xa[k][0] = r_lo < n ? *reinterpret_cast<const uint32_t*>(lo) : 0u;
      xa[k][1] = r_hi < n ? *reinterpret_cast<const uint32_t*>(hi) : 0u;
      xa[k][2] = r_lo < n ? *reinterpret_cast<const uint32_t*>(lo + 8) : 0u;
      xa[k][3] = r_hi < n ? *reinterpret_cast<const uint32_t*>(hi + 8) : 0u;
    }
    if (subs > 0) tc_stage_w1<D>(s, 0, md.w1, md.b1, 0, active, rt);
    for (int j = 0; j < subs; ++j) {
      const int b = j & 1;
      if (j + 1 < subs) {
        tc_stage_w1<D>(s, b ^ 1, md.w1, md.b1, (j + 1) * SUB, active, rt);
        cp_async_wait<1>();  // sub-chunk j landed
      } else {
        cp_async_wait<0>();
      }
      bar_sync(PRODUCERS, ROLE_THREADS);

      // 8 tiles of 8 hidden columns; past `active` the weights and bias are
      // zero, so h = 0 there and gelu(0) = 0
      uint32_t hv[SUB / 8][2];
#pragma unroll
      for (int jt = 0; jt < SUB / 8; ++jt) {
        float h[4] = {0.f, 0.f, 0.f, 0.f};
        const bf16* wp = s.w1[b] + (8 * jt + g) * XP + 2 * t;
#pragma unroll
        for (int k = 0; k < KX; ++k) mma_bf16(h, xa[k], lds32(wp + 16 * k), lds32(wp + 16 * k + 8));
        const float bb0 = s.b1[b][8 * jt + 2 * t], bb1 = s.b1[b][8 * jt + 2 * t + 1];
        hv[jt][0] = pack_bf16(gelu_poly(h[0] + bb0), gelu_poly(h[1] + bb1));
        hv[jt][1] = pack_bf16(gelu_poly(h[2] + bb0), gelu_poly(h[3] + bb1));
      }
      bar_sync(PRODUCERS, ROLE_THREADS);  // every producer is done with w1[b], b1[b]

      if (j >= 2) bar_sync(EMPTY0 + b, THREADS);  // the consumers have read h[b]
      bf16* hw = s.h[b] + (rows + g) * SP + 2 * t;
#pragma unroll
      for (int jt = 0; jt < SUB / 8; ++jt) {
        *reinterpret_cast<uint32_t*>(hw + 8 * jt) = hv[jt][0];
        *reinterpret_cast<uint32_t*>(hw + 8 * SP + 8 * jt) = hv[jt][1];
      }
      bar_arrive(FULL0 + b, THREADS);
    }
    return;
  }

  // ---- consumers: acc += h @ w2s^T, summed per 512-column chunk ----
  constexpr int NO = D / 8;  // output tiles of 8 columns
  float acc[NO][4], part[NO][4];
#pragma unroll
  for (int jo = 0; jo < NO; ++jo)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jo][e] = part[jo][e] = 0.f;

  if (subs > 0) tc_stage_w2<D>(s, 0, md.w2, m, 0, active, rt);
  for (int j = 0; j < subs; ++j) {
    const int b = j & 1;
    if (j + 1 < subs) {
      tc_stage_w2<D>(s, b ^ 1, md.w2, m, (j + 1) * SUB, active, rt);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    bar_sync(CONSUMERS, ROLE_THREADS);
    bar_sync(FULL0 + b, THREADS);  // the producers have written h[b]

    const bf16* hr = s.h[b] + (rows + g) * SP + 2 * t;
#pragma unroll
    for (int k = 0; k < SUB / 16; ++k) {
      const uint32_t a[4] = {lds32(hr + 16 * k), lds32(hr + 8 * SP + 16 * k),
                             lds32(hr + 16 * k + 8), lds32(hr + 8 * SP + 16 * k + 8)};
#pragma unroll
      for (int jo = 0; jo < NO; ++jo) {
        const bf16* wp = s.w2[b] + (8 * jo + g) * SP + 16 * k + 2 * t;
        mma_bf16(part[jo], a, lds32(wp), lds32(wp + 8));
      }
    }
    if (j + 2 < subs) bar_arrive(EMPTY0 + b, THREADS);  // a producer will wait for it
    if (chunk_ends(j, subs)) {
#pragma unroll
      for (int jo = 0; jo < NO; ++jo)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[jo][e] += part[jo][e];
          part[jo][e] = 0.f;
        }
    }
    bar_sync(CONSUMERS, ROLE_THREADS);  // every consumer is done with w2[b]
  }

#pragma unroll
  for (int jo = 0; jo < NO; ++jo) {
    const int o = 8 * jo + 2 * t;
    const float bb0 = __bfloat162float(md.b2[o]), bb1 = __bfloat162float(md.b2[o + 1]);
    if (r_lo < n)
      *reinterpret_cast<uint32_t*>(md.out + (size_t)r_lo * D + o) =
          pack_bf16(acc[jo][0] + bb0, acc[jo][1] + bb1);
    if (r_hi < n)
      *reinterpret_cast<uint32_t*>(md.out + (size_t)r_hi * D + o) =
          pack_bf16(acc[jo][2] + bb0, acc[jo][3] + bb1);
  }
}

// ---------------------------------------------------------------------------
// CUDA-core body: f32 at D in {8, 16, 32, 64}, and bf16 at D = 8.  A role's
// thread (ty, tx) = (rt / 16, rt % 16) owns rows ty + 8 i (i < 8).
// ---------------------------------------------------------------------------

template <int D>
struct CoreSmem {
  static constexpr int DP = D + 1;    // padded rows: odd strides, no bank conflicts
  static constexpr int SP = SUB + 1;
  float x[TILE_N * DP];
  float w1[2][SUB * DP];
  float b1[2][SUB];
  float w2[2][D * SP];
  float h[2][TILE_N * SP];
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
chunked_core_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const T* __restrict__ b1, const T* __restrict__ w2,
                    const T* __restrict__ b2, T* __restrict__ out, int n, int m,
                    const int* __restrict__ active_p, int active_all) {
  const Model<T> md(x, w1, b1, w2, b2, out, active_p, active_all, n, D, m);
  constexpr int DP = CoreSmem<D>::DP, SP = CoreSmem<D>::SP;
  constexpr int OJ = (D + 15) / 16;  // output columns per consumer thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CoreSmem<D>& s = *reinterpret_cast<CoreSmem<D>*>(smem_raw);

  const int rt = threadIdx.x % ROLE_THREADS;
  const int tx = rt % 16, ty = rt / 16;
  const int row0 = blockIdx.x * TILE_N;
  const int active = md.active;
  const int subs = (active + SUB - 1) / SUB;

  if (threadIdx.x < ROLE_THREADS) {
    // ---- producers ----
    for (int i = rt; i < TILE_N * D; i += ROLE_THREADS) {
      const int r = i / D, d = i % D;
      s.x[r * DP + d] = row0 + r < n ? to_f32(md.x[(size_t)(row0 + r) * D + d]) : 0.f;
    }
    for (int j = 0; j < subs; ++j) {
      const int b = j & 1, c0 = j * SUB;
      // buffer b was last read in sub-chunk j - 2, before the barrier of j - 1
      for (int i = rt; i < SUB * D; i += ROLE_THREADS) {
        const int c = i / D, d = i % D;
        s.w1[b][c * DP + d] = c0 + c < active ? to_f32(md.w1[(size_t)(c0 + c) * D + d]) : 0.f;
      }
      for (int c = rt; c < SUB; c += ROLE_THREADS)
        s.b1[b][c] = c0 + c < active ? to_f32(md.b1[c0 + c]) : 0.f;
      bar_sync(PRODUCERS, ROLE_THREADS);

      float h[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) h[i][jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float xv[8], wv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[i] = s.x[(ty + 8 * i) * DP + d];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) wv[jj] = s.w1[b][(tx + 16 * jj) * DP + d];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) h[i][jj] = fmaf(xv[i], wv[jj], h[i][jj]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const bool keep = c0 + c < active;
        const float bias = s.b1[b][c];
#pragma unroll
        for (int i = 0; i < 8; ++i)  // rounded to the input type before fc2
          h[i][jj] = keep ? to_f32(from_f32<T>(gelu<T>(h[i][jj] + bias))) : 0.f;
      }

      if (j >= 2) bar_sync(EMPTY0 + b, THREADS);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s.h[b][(ty + 8 * i) * SP + tx + 16 * jj] = h[i][jj];
      bar_arrive(FULL0 + b, THREADS);
    }
    return;
  }

  // ---- consumers ----
  float acc[8][OJ], part[8][OJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < OJ; ++jj) acc[i][jj] = part[i][jj] = 0.f;

  for (int j = 0; j < subs; ++j) {
    const int b = j & 1, c0 = j * SUB;
    for (int i = rt; i < D * SUB; i += ROLE_THREADS) {
      const int o = i / SUB, c = i % SUB;
      s.w2[b][o * SP + c] = c0 + c < active ? to_f32(md.w2[(size_t)o * m + c0 + c]) : 0.f;
    }
    bar_sync(CONSUMERS, ROLE_THREADS);
    bar_sync(FULL0 + b, THREADS);

#pragma unroll 4
    for (int c = 0; c < SUB; ++c) {
      float gv[8], wv[OJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) gv[i] = s.h[b][(ty + 8 * i) * SP + c];
#pragma unroll
      for (int jj = 0; jj < OJ; ++jj) {
        const int o = tx + 16 * jj;
        wv[jj] = o < D ? s.w2[b][o * SP + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < OJ; ++jj) part[i][jj] = fmaf(gv[i], wv[jj], part[i][jj]);
    }
    if (j + 2 < subs) bar_arrive(EMPTY0 + b, THREADS);
    if (chunk_ends(j, subs)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < OJ; ++jj) {
          acc[i][jj] += part[i][jj];
          part[i][jj] = 0.f;
        }
    }
  }

#pragma unroll
  for (int jj = 0; jj < OJ; ++jj) {
    const int o = tx + 16 * jj;
    if (o >= D) continue;
    const float bias = to_f32(md.b2[o]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + ty + 8 * i;
      if (r < n) md.out[(size_t)r * D + o] = from_f32<T>(acc[i][jj] + bias);
    }
  }
}

template <typename T, typename S, typename K>
cudaError_t launch_body(K kernel, const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* out, int n, int m,
                        const int* active_p, int active, int models, cudaStream_t stream) {
  constexpr size_t smem = sizeof(S);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE_N - 1) / TILE_N, models);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), n, m,
      active_p, active);
  return cudaGetLastError();
}

#define MLP_ARGS x, w1, b1, w2, b2, out, n, m, active_p, active, models, stream

template <int D>
cudaError_t launch_tc(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* out, int n, int m, const int* active_p,
                      int active, int models, cudaStream_t stream) {
  return launch_body<bf16, TcSmem<D>>(chunked_tc_kernel<D>, MLP_ARGS);
}

template <typename T, int D>
cudaError_t launch_core(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, int n, int m, const int* active_p,
                        int active, int models, cudaStream_t stream) {
  return launch_body<T, CoreSmem<D>>(chunked_core_kernel<T, D>, MLP_ARGS);
}

}  // namespace

// The arguments of `fused_mlp_launch` (`fused_mlp.cu`): n token rows per
// model, `models` weight sets, active_p the per-model width mask on the
// device or null for `active` in all; dtype 0 = float32, 1 = bfloat16.  D in
// {8, 16, 32, 64}; anything else returns cudaErrorInvalidValue.
extern "C" int mlp_chunked_launch(int device, const void* x, const void* w1,
                                  const void* b1, const void* w2, const void* b2,
                                  void* out, int n, int d, int m, int active,
                                  const int* active_p, int models, int dtype,
                                  void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || models == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (dtype == 1) {
    switch (d) {
      case 8: return (int)launch_core<bf16, 8>(MLP_ARGS);
      case 16: return (int)launch_tc<16>(MLP_ARGS);
      case 32: return (int)launch_tc<32>(MLP_ARGS);
      case 64: return (int)launch_tc<64>(MLP_ARGS);
    }
  } else if (dtype == 0) {
    switch (d) {
      case 8: return (int)launch_core<float, 8>(MLP_ARGS);
      case 16: return (int)launch_core<float, 16>(MLP_ARGS);
      case 32: return (int)launch_core<float, 32>(MLP_ARGS);
      case 64: return (int)launch_core<float, 64>(MLP_ARGS);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mlp_chunked_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

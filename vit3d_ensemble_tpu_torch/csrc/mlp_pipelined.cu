// K1c: the fused FFN, software-pipelined: out = gelu(x @ w1^T + b1)[:, :active]
// @ w2[:, :active]^T + b2, K1's function.
//
// Replaces the TPU kernel `vit3d_ensemble_tpu/ops/pallas_mlp.py:
// _pipelined2_mlp_kernel` (variant "pipelined2").  That kernel runs
// n_tiles + 1 grid steps over a (2, 512, M) f32 scratch: step i computes fc1
// of row tile i and GELU + fc2 of tile i - 1, so that each product's consumer
// sits a grid step away; its step 0 reads uninitialised scratch and its
// output is overwritten in step 1 (`pallas_mlp.py:146-151`).  Hopper runs
// blocks in parallel and carries nothing from one block to the next, so the
// pipeline lives inside a persistent block instead, and nothing is read
// before it is written.
//
// What bounds it on the H100: as K1 (`fused_mlp.cu`), operations: 4*n*D*M
// multiply-adds and n*M exact-erf GELUs on the FP32 pipes.
//
// Design: a persistent grid, one block per (SM slot, model) as the occupancy
// allows, each block walking its row tiles of 64 rows (tiles b, b + gridDim.x,
// ...).  The block's work is one flat sequence of items (tile, hidden chunk of
// 64 columns); item i issues fc1 of its chunk, then GELU + fc2 of item i - 1,
// so the GELU of one chunk and the products of the next are independent
// instructions in flight together (the TPU kernel's stage A / stage B split,
// a chunk apart instead of a grid step).  A prologue issues fc1 of item 0
// alone and an epilogue GELU + fc2 of the last item alone.  h is double-
// buffered: two sets of accumulator registers in the tensor-core body, two
// shared-memory tiles in the CUDA-core body.  The copies run one item ahead
// with cp.async: the next item's weight chunk, and with the first chunk of a
// tile that tile's x rows, so the next tile's x lands while the current
// tile's last chunk computes.  The sums run in K1's order, so in bf16 the
// two kernels agree to the bit, as the TPU kernel did with "seq".
//
// Two bodies share that plan:
//   * bf16 with D in {16, 32, 64}: 4 warps, both products on the tensor
//     cores (mma.sync m16n8k16), h kept in registers as fc2's A fragments
//     (K1's layout); weight chunks in a ring of three cp.async stages (item
//     i's w1, item i - 1's w2 and b1, item i + 1 in flight);
//   * f32, and D = 8: 256 threads on CUDA-core FMAs, a thread a 4 x 4 tile of
//     h and 4 rows by D / 16 output columns; weight chunks loaded into two
//     shared-memory buffers, x prefetched with cp.async.

#include "mlp_common.cuh"

namespace {

using namespace mlp;
using bf16 = __nv_bfloat16;

constexpr int TILE_N = 64;  // token rows per tile
constexpr int CHUNK = 64;   // hidden columns per item

// The block's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
__device__ __forceinline__ int my_tiles(int tiles) {
  return blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
}

__device__ __forceinline__ int tile_of(int k) { return blockIdx.x + k * gridDim.x; }

// ---------------------------------------------------------------------------
// Tensor-core body: bf16, D in {16, 32, 64}.
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;

template <int D>
struct PipeStage {
  static constexpr int XP = D + 8;      // w1 and x rows: D values + 16 bytes of pad
  static constexpr int CP = CHUNK + 8;  // w2 rows: CHUNK values + 16 bytes of pad
  bf16 w1[CHUNK * XP];
  bf16 w2[D * CP];
  float b1[CHUNK];
};

template <int D>
struct PipeSmem {
  PipeStage<D> stage[3];
  bf16 x[2][TILE_N * PipeStage<D>::XP];
};

// Stage item `it`'s weight chunk c0 into `st`, zero past `active`, and with
// the first chunk of a tile that tile's x rows, zero past n.
template <int D>
__device__ __forceinline__ void tc_stage(PipeStage<D>& st, bf16* xs, const Model<bf16>& md,
                                         int n, int m, int c0, int tile) {
  constexpr int XP = PipeStage<D>::XP, CP = PipeStage<D>::CP;
  const int active = md.active;
  for (int i = threadIdx.x; i < CHUNK * (D / 8); i += TC_THREADS) {
    const int c = i / (D / 8), p = i % (D / 8);
    const bool live = c0 + c < active;
    cp_async16(st.w1 + c * XP + p * 8, live ? md.w1 + (size_t)(c0 + c) * D + p * 8 : md.w1,
               live ? 16 : 0);
  }
  if (m % 8 == 0) {
    for (int i = threadIdx.x; i < D * (CHUNK / 8); i += TC_THREADS) {
      const int o = i / (CHUNK / 8), col = c0 + (i % (CHUNK / 8)) * 8;
      const int live = min(max(active - col, 0), 8);
      cp_async16(st.w2 + o * CP + col - c0, live ? md.w2 + (size_t)o * m + col : md.w2,
                 2 * live);
    }
  } else {
    for (int i = threadIdx.x; i < D * CHUNK; i += TC_THREADS) {
      const int o = i / CHUNK, c = i % CHUNK;
      st.w2[o * CP + c] =
          c0 + c < active ? md.w2[(size_t)o * m + c0 + c] : __float2bfloat16(0.f);
    }
  }
  for (int c = threadIdx.x; c < CHUNK; c += TC_THREADS)
    st.b1[c] = c0 + c < active ? __bfloat162float(md.b1[c0 + c]) : 0.f;
  if (c0 == 0) {
    for (int i = threadIdx.x; i < TILE_N * (D / 8); i += TC_THREADS) {
      const int r = i / (D / 8), p = i % (D / 8);
      const int row = tile * TILE_N + r;
      const bool live = row < n;
      cp_async16(xs + r * XP + p * 8, live ? md.x + (size_t)row * D + p * 8 : md.x,
                 live ? 16 : 0);
    }
  }
  cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
pipelined_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, bf16* __restrict__ out, int n, int m,
                    const int* __restrict__ active_p, int active_all) {
  const Model<bf16> md(x, w1, b1, w2, b2, out, active_p, active_all, n, D, m);
  constexpr int XP = PipeStage<D>::XP, CP = PipeStage<D>::CP;
  constexpr int KX = D / 16;       // fc1 k-steps
  constexpr int NO = D / 8;        // fc2 output tiles of 8 columns
  constexpr int NH = CHUNK / 8;    // h tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PipeSmem<D>& s = *reinterpret_cast<PipeSmem<D>*>(smem_raw);

  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rows = (threadIdx.x / 32) * 16 + g;  // this thread's rows: rows, rows + 8
  const int mine = my_tiles((n + TILE_N - 1) / TILE_N);
  const int chunks = (md.active + CHUNK - 1) / CHUNK;

  if (chunks == 0) {  // no live column: out = b2
    for (int k = 0; k < mine; ++k) {
      const int r_lo = tile_of(k) * TILE_N + rows, r_hi = r_lo + 8;
#pragma unroll
      for (int jo = 0; jo < NO; ++jo) {
        const int o = 8 * jo + 2 * t;
        const uint32_t v = pack_bf16(__bfloat162float(md.b2[o]), __bfloat162float(md.b2[o + 1]));
        if (r_lo < n) *reinterpret_cast<uint32_t*>(md.out + (size_t)r_lo * D + o) = v;
        if (r_hi < n) *reinterpret_cast<uint32_t*>(md.out + (size_t)r_hi * D + o) = v;
      }
    }
    return;
  }

  const int items = mine * chunks;
  uint32_t xa[KX][4];
  float hn[NH][4], hc[NH][4];  // h of item i (fc1 just issued) and of item i - 1
  float acc[NO][4];
#pragma unroll
  for (int jo = 0; jo < NO; ++jo) acc[jo][0] = acc[jo][1] = acc[jo][2] = acc[jo][3] = 0.f;

  if (items > 0) tc_stage<D>(s.stage[0], s.x[0], md, n, m, 0, tile_of(0));
  for (int it = 0; it <= items; ++it) {
    if (it + 1 < items) {
      const int k1 = (it + 1) / chunks, c1 = (it + 1) % chunks;
      tc_stage<D>(s.stage[(it + 1) % 3], s.x[k1 & 1], md, n, m, c1 * CHUNK, tile_of(k1));
      cp_async_wait<1>();  // item it's copies landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // stage A: fc1 of item it into hn
    if (it < items) {
      const int k = it / chunks, c = it % chunks;
      if (c == 0) {  // a new tile: its x rows as fc1's A fragments
        const bf16* xr = s.x[k & 1] + rows * XP + 2 * t;
#pragma unroll
        for (int ks = 0; ks < KX; ++ks) {
          xa[ks][0] = lds32(xr + 16 * ks);
          xa[ks][1] = lds32(xr + 8 * XP + 16 * ks);
          xa[ks][2] = lds32(xr + 16 * ks + 8);
          xa[ks][3] = lds32(xr + 8 * XP + 16 * ks + 8);
        }
      }
      const PipeStage<D>& st = s.stage[it % 3];
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        hn[j][0] = hn[j][1] = hn[j][2] = hn[j][3] = 0.f;
        const bf16* wp = st.w1 + (8 * j + g) * XP + 2 * t;
#pragma unroll
        for (int ks = 0; ks < KX; ++ks)
          mma_bf16(hn[j], xa[ks], lds32(wp + 16 * ks), lds32(wp + 16 * ks + 8));
      }
    }

    // stage B: + b1, GELU in f32, rounded to bf16, and fc2 of item it - 1
    if (it > 0) {
      const int p = it - 1;
      const PipeStage<D>& st = s.stage[p % 3];
#pragma unroll
      for (int ks = 0; ks < CHUNK / 16; ++ks) {
        uint32_t ha[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * ks + half;
          const float bb0 = st.b1[8 * j + 2 * t], bb1 = st.b1[8 * j + 2 * t + 1];
          ha[2 * half] = pack_bf16(gelu_erf(hc[j][0] + bb0), gelu_erf(hc[j][1] + bb1));
          ha[2 * half + 1] = pack_bf16(gelu_erf(hc[j][2] + bb0), gelu_erf(hc[j][3] + bb1));
        }
#pragma unroll
        for (int jo = 0; jo < NO; ++jo) {
          const bf16* wp = st.w2 + (8 * jo + g) * CP + 16 * ks + 2 * t;
          mma_bf16(acc[jo], ha, lds32(wp), lds32(wp + 8));
        }
      }
      if (p % chunks == chunks - 1) {  // item p ended its tile: write it out
        const int r_lo = tile_of(p / chunks) * TILE_N + rows, r_hi = r_lo + 8;
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
          acc[jo][0] = acc[jo][1] = acc[jo][2] = acc[jo][3] = 0.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hc[j][e] = hn[j][e];
    __syncthreads();  // every warp is done with the stage item it + 2 refills
  }
}

// ---------------------------------------------------------------------------
// CUDA-core body: f32 at D in {8, 16, 32, 64}, and bf16 at D = 8.
// ---------------------------------------------------------------------------

constexpr int CORE_THREADS = 256;  // a 16 x 16 grid of threads

template <typename T, int D>
struct CoreSmem {
  static constexpr int XP = D + 16 / sizeof(T);  // x rows: 16 bytes of pad
  static constexpr int DP = D + 1;                // padded rows: no bank conflicts
  static constexpr int CP = CHUNK + 1;
  T x[2][TILE_N * XP];
  float w1[2][CHUNK * DP];
  float b1[2][CHUNK];
  float w2[2][D * CP];
  float h[2][TILE_N * CP];
};

// The x rows of `tile` into xs by 16-byte copies, zero past n.
template <typename T, int D>
__device__ __forceinline__ void core_stage_x(T* xs, const T* x, int n, int tile) {
  constexpr int XP = CoreSmem<T, D>::XP, PIECE = 16 / sizeof(T);
  for (int i = threadIdx.x; i < TILE_N * (D / PIECE); i += CORE_THREADS) {
    const int r = i / (D / PIECE), p = i % (D / PIECE);
    const int row = tile * TILE_N + r;
    const bool live = row < n;
    cp_async16(xs + r * XP + p * PIECE, live ? x + (size_t)row * D + p * PIECE : x,
               live ? 16 : 0);
  }
  cp_async_commit();
}

template <typename T, int D>
__global__ void __launch_bounds__(CORE_THREADS)
pipelined_core_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const T* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ b2, T* __restrict__ out, int n, int m,
                      const int* __restrict__ active_p, int active_all) {
  const Model<T> md(x, w1, b1, w2, b2, out, active_p, active_all, n, D, m);
  using S = CoreSmem<T, D>;
  constexpr int XP = S::XP, DP = S::DP, CP = S::CP;
  constexpr int OJ = (D + 15) / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& s = *reinterpret_cast<S*>(smem_raw);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // rows ty + 16 i
  const int active = md.active;
  const int mine = my_tiles((n + TILE_N - 1) / TILE_N);
  const int chunks = (active + CHUNK - 1) / CHUNK;
  const int items = mine * chunks;

  float acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;

  if (items > 0) core_stage_x<T, D>(s.x[0], md.x, n, tile_of(0));
  for (int it = 0; it <= items; ++it) {
    const int k = it / max(chunks, 1), c = it % max(chunks, 1);
    const int b = it & 1;
    if (it < items) {
      // weights of item it into buffer b, last read by stage B of item it - 2
      // before the barrier that ended item it - 1
      const int c0 = c * CHUNK;
      for (int i = threadIdx.x; i < CHUNK * D; i += CORE_THREADS) {
        const int cc = i / D, d = i % D;
        s.w1[b][cc * DP + d] = c0 + cc < active ? to_f32(md.w1[(size_t)(c0 + cc) * D + d]) : 0.f;
      }
      for (int i = threadIdx.x; i < D * CHUNK; i += CORE_THREADS) {
        const int o = i / CHUNK, cc = i % CHUNK;
        s.w2[b][o * CP + cc] = c0 + cc < active ? to_f32(md.w2[(size_t)o * m + c0 + cc]) : 0.f;
      }
      for (int cc = threadIdx.x; cc < CHUNK; cc += CORE_THREADS)
        s.b1[b][cc] = c0 + cc < active ? to_f32(md.b1[c0 + cc]) : 0.f;
      if (c == 0 && k + 1 < mine) {  // the next tile's x rows, a tile ahead
        core_stage_x<T, D>(s.x[(k + 1) & 1], md.x, n, tile_of(k + 1));
        cp_async_wait<1>();  // this tile's x rows landed
      } else {
        cp_async_wait<0>();
      }
    }
    __syncthreads();

    // stage A: fc1 of item it, + b1, GELU, rounded to the input type, into h[b]
    if (it < items) {
      const T* xs = s.x[k & 1];
      float h[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) h[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = to_f32(xs[(ty + 16 * i) * XP + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = s.w1[b][(tx + 16 * j) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) h[i][j] = fmaf(xv[i], wv[j], h[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c * CHUNK + tx + 16 * j;
        const bool keep = col < active;
        const float bias = s.b1[b][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s.h[b][(ty + 16 * i) * CP + tx + 16 * j] =
              keep ? to_f32(from_f32<T>(gelu_erf(h[i][j] + bias))) : 0.f;
      }
    }

    // stage B: fc2 of item it - 1 out of h[b ^ 1]
    if (it > 0) {
      const int p = it - 1, pb = b ^ 1;
#pragma unroll 8
      for (int cc = 0; cc < CHUNK; ++cc) {
        float gv[4], wv[OJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = s.h[pb][(ty + 16 * i) * CP + cc];
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          const int o = tx + 16 * j;
          wv[j] = o < D ? s.w2[pb][o * CP + cc] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < OJ; ++j) acc[i][j] = fmaf(gv[i], wv[j], acc[i][j]);
      }
      if (p % chunks == chunks - 1) {  // item p ended its tile: write it out
        const int row0 = tile_of(p / chunks) * TILE_N;
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          const int o = tx + 16 * j;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = row0 + ty + 16 * i;
            if (o < D && r < n) md.out[(size_t)r * D + o] = from_f32<T>(acc[i][j] + to_f32(md.b2[o]));
            acc[i][j] = 0.f;
          }
        }
      }
    }
    __syncthreads();
  }

  if (chunks == 0) {  // no live column: out = b2
    for (int k = 0; k < mine; ++k)
      for (int i = threadIdx.x; i < TILE_N * D; i += CORE_THREADS) {
        const int r = tile_of(k) * TILE_N + i / D, o = i % D;
        if (r < n) md.out[(size_t)r * D + o] = md.b2[o];
      }
  }
}

// One block per SM slot the occupancy gives, shared among the models, and
// never more blocks of a model than it has row tiles.
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, size_t smem, int n, int models, dim3* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + TILE_N - 1) / TILE_N;
  const int slots = max(sms * per_sm, 1);
  *grid = dim3(max(1, min(tiles, (slots + models - 1) / models)), models);
  return cudaSuccess;
}

template <typename T, typename K>
cudaError_t launch_body(K kernel, int threads, size_t smem, const void* x, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* out, int n,
                        int m, const int* active_p, int active, int models,
                        cudaStream_t stream) {
  dim3 grid;
  cudaError_t err = persistent_grid(kernel, threads, smem, n, models, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(
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
  return launch_body<bf16>(pipelined_tc_kernel<D>, TC_THREADS, sizeof(PipeSmem<D>), MLP_ARGS);
}

template <typename T, int D>
cudaError_t launch_core(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, int n, int m, const int* active_p,
                        int active, int models, cudaStream_t stream) {
  return launch_body<T>(pipelined_core_kernel<T, D>, CORE_THREADS, sizeof(CoreSmem<T, D>),
                        MLP_ARGS);
}

}  // namespace

// The arguments of `fused_mlp_launch` (`fused_mlp.cu`): n token rows per
// model, `models` weight sets, active_p the per-model width mask on the
// device or null for `active` in all; dtype 0 = float32, 1 = bfloat16.  D in
// {8, 16, 32, 64}; anything else returns cudaErrorInvalidValue.
extern "C" int mlp_pipelined_launch(int device, const void* x, const void* w1,
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

extern "C" const char* mlp_pipelined_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

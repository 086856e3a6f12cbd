// K1c: the fused FFN, software-pipelined: out = gelu(x @ w1^T + b1)[:, :active]
// @ w2[:, :active]^T + b2, K1's function.
//
// Replaces the TPU kernel `vit3d_ensemble_tpu/ops/pallas_mlp.py:
// _pipelined2_mlp_kernel` (variant "pipelined2").  That kernel runs
// n_tiles + 1 grid steps over a (2, 512, M) f32 scratch: step i computes fc1
// of row tile i (stage A) and GELU + fc2 of tile i - 1 (stage B), so that
// each product's consumer sits a grid step away and the TPU's matrix unit
// and vector unit work side by side; its step 0 reads uninitialised scratch
// and its output is overwritten in step 1 (`pallas_mlp.py:146-151`).
// Hopper runs blocks in parallel and carries nothing from one block to the
// next, so the pipeline lives inside a block, a hidden chunk apart instead
// of a grid step, and nothing is read before it is written.
//
// What bounds it on the H100: as K1 (`fused_mlp.cu`), the n*M GELUs on the
// FP32 pipes, not the 4*n*D*M multiply-adds.  At the serving shape (n =
// 33,280, D = 64, M = 3,072, bf16) the products take 26.5 us at the tensor
// cores' peak; the 102 M GELUs, in bf16 the TPU kernels' polynomial
// (`gelu_poly`, 16 FP32 instructions each; the f32 bodies keep exact erf,
// 23 and an exponential), about 0.05 ms at 128 lanes an SM.  So the
// design's aim is that the tensor cores and the loads hide under the GELUs,
// which run on every SM all the time.  This body also serves every K1 bf16
// call at D >= 16 (counted as K1's launches there), the serving pass and
// the latency path included.
//
// Design, bf16 with D in {16, 32, 64} (`pipelined_wgmma_kernel`): a
// persistent, warp-specialised block of three warpgroups, one block an SM.
//   * Warpgroup 0 gives up registers (`setmaxnreg`) and one of its threads
//     keeps shared memory full by TMA: the x row tile (128 rows, double-
//     buffered across the block's tiles) and a ring of stages, each a chunk
//     of 64 hidden columns of w1 (64 x D, K-major), w2 (D x 64, K-major
//     along M) and b1, all on mbarriers.  x and w1 rows are D * 2 bytes, loaded
//     with the swizzle of that width (32, 64 or 128 bytes) that the wgmma
//     descriptors name; w2's rows are 128 bytes.  TMA zero-fills the ragged
//     last row tile; its stores are masked.
//   * Warpgroups 1 and 2 own 64 rows of the tile each.  For the item (tile,
//     chunk c) a consumer issues fc1 of the next item as an SS wgmma
//     (m64n64, D / 16 k-steps) into one of two accumulators, and while the
//     tensor cores run it adds b1 and runs the GELU of item c on the
//     other accumulator, rounds it to bf16 in place as fc2's A fragments
//     (register A, as K4 passes p), and issues fc2 of item c as an RS wgmma
//     (m64nD, 4 k-steps, B straight from w2's stage).  `wgmma.wait_group 1`
//     then leaves fc2 in flight while the next item's GELU starts: the TPU
//     kernel's stage A / stage B, one chunk apart, with the tensor cores'
//     work hidden under the CUDA cores'.  A stage goes back to the producer
//     when the fc2 that read it has retired.
//   * The width mask: chunks wholly past `active` are never loaded, and in
//     a partial last chunk the columns past it are zeroed after the GELU.
//   * The grid (`k1c_plan` in `ops/fused_mlp.py`): grid y is the model (its
//     pointers and width mask from `Model`'s rule), grid x the blocks of a
//     model, never more than the resident slots divided among the models,
//     each block taking a contiguous run of row tiles, balanced to within
//     one.  The parent's grid gave each model ceil(slots / models) blocks,
//     which at 30 models left a second, nearly empty wave.
// fc2's chunks are summed in the chunks' order, k-step by k-step.
//
// bf16 at D = 8 (`pipelined_core_kernel`): CUDA-core FMAs in 64-row tiles
// (256 threads, a thread a 4 x 4 tile of h and 4 rows by D / 16 output
// columns, h and the weight chunk through shared memory, three blocks an
// SM) on the same persistent, balanced grid; K1's bf16 calls at D = 8 run it
// too.  The parent's body (two shared-memory buffers of every operand, 134
// KB at D = 64: one block an SM) lost most of its time to its grid's second
// wave; loading each chunk's weights into registers an item ahead cost more
// than it hid (spills at three blocks an SM, two blocks an SM without them:
// slower in one call on an H100 each, see PERF.md).
//
// f32 at D in {8, 16, 32, 64}: K1's narrow f32 body (`mlp_narrow_f32.cuh`,
// 3xTF32 on `wgmma`, the hidden columns split across a cluster), through
// this library's own entry (`mlp_pipelined_f32_launch`) in K1c's row-tile
// order: half as many row-tile groups as K1's, each walking two consecutive
// row tiles (`fused_mlp.k1c_narrow_f32_groups`).  A tile's sums run as K1's,
// so the two agree to the bit.  It replaced a copy of K1's CUDA-core f32
// tiling on this library's persistent grid.
//
// The wide regime, every D from 65 to 8,192, with the model axis
// (`mlp_wide.cuh`, whose note says what bounds it): K1's two GEMM phases in
// one persistent launch (`wide_queue_kernel` in bf16 on `wgmma`,
// `wide_queue_tf32x3_kernel` in f32 in 3xTF32), the TPU kernel's pipeline
// across row tiles: the unit queue puts fc1 of row tile i + L ahead of fc2 of
// row tile i, each block takes the queue's next unit by ticket, and an fc2
// unit waits on a per-row-tile counter in global memory until every live fc1
// column tile of its row tile is stored.  Its tiles and K order are K1's
// where K1 does not split K, so there it gives K1's bits.
//
// Layouts follow torch.nn.Linear: x (P, n, D), w1 (P, m, D), b1 (P, m) and
// w2 (P, D, m) with rows `ld2` elements apart (the wrapper pads them to a
// multiple of 8 columns where TMA needs it), b2 (P, D), out (P, n, D).

#include <algorithm>
#include <atomic>

#include "mlp_common.cuh"
#include "mlp_narrow_f32.cuh"
#include "mlp_wide.cuh"
#include "sm90_common.cuh"

namespace {

using namespace mlp;
using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int CHUNK = 64;  // hidden columns per item

// This block's row tiles of its model, [first, last): block b of the grid's
// gridDim.x takes tiles floor(b T / B) .. floor((b + 1) T / B), so every
// block holds floor(T / B) or ceil(T / B) of them.
__device__ __forceinline__ void my_tiles(int tiles, int* first, int* last) {
  *first = (int)((long long)blockIdx.x * tiles / gridDim.x);
  *last = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
}

__device__ __forceinline__ int active_of(const int* active_p, int active_all, int m) {
  const int a = active_p != nullptr ? active_p[blockIdx.y] : active_all;
  return min(max(a, 0), m);
}

// ---------------------------------------------------------------------------
// bf16, D in {16, 32, 64}: wgmma fed by TMA.
// ---------------------------------------------------------------------------

constexpr int W_ROWS = 128;     // token rows a tile: two consumer warpgroups of 64
constexpr int W_THREADS = 384;  // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int W_STAGES = 8;

template <int D>
struct WShape {
  static constexpr int SW = 2 * D;  // bytes of an x or w1 row, and their swizzle
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // the descriptors' code
  static constexpr int X_BYTES = W_ROWS * SW;
  static constexpr int W1_BYTES = CHUNK * SW;
  static constexpr int W2_BYTES = D * CHUNK * 2;  // D rows of 128 bytes
  static constexpr int B1_BYTES = CHUNK * 2;
  static constexpr int TX_BYTES = W1_BYTES + W2_BYTES + B1_BYTES;  // a stage's loads
  // b1's 128 bytes take the stage's last 1,024, so the next stage's tiles
  // start on a swizzle atom too
  static constexpr int STAGE_BYTES = W1_BYTES + W2_BYTES + 1024;
  static constexpr size_t SMEM =
      1024 + 2 * X_BYTES + (size_t)W_STAGES * STAGE_BYTES + (4 + 2 * W_STAGES) * sizeof(uint64_t);
  static_assert(X_BYTES % 1024 == 0 && W1_BYTES % 1024 == 0 && W2_BYTES % 1024 == 0,
                "every tile starts on a 1,024-byte swizzle atom");
};

// What a consumer warpgroup needs of the block.
struct Pipe {
  const unsigned char* x_st;
  const unsigned char* w_st;
  uint64_t* x_full;
  uint64_t* x_empty;
  uint64_t* w_full;
  uint64_t* w_empty;
  const bf16* b2;
  bf16* out;
  int n, active, chunks, items, first, cw, tid;
};

// fc1 of item i: h = x_tile(i)[this warpgroup's 64 rows] @ w1_chunk(i)^T,
// issued and committed, not waited for.
template <int D>
__device__ __forceinline__ void issue_fc1(const Pipe& pp, int i, float (&h)[32]) {
  using S = WShape<D>;
  const int k = i / pp.chunks, s = i % W_STAGES;
  if (i % pp.chunks == 0) mbar_wait(&pp.x_full[k & 1], (k >> 1) & 1);
  mbar_wait(&pp.w_full[s], (i / W_STAGES) & 1);
  const uint64_t da =
      smem_desc(pp.x_st + (k & 1) * S::X_BYTES + pp.cw * 64 * S::SW, 16, 8 * S::SW, S::LAYOUT);
  const uint64_t db = smem_desc(pp.w_st + s * S::STAGE_BYTES, 16, 8 * S::SW, S::LAYOUT);
  fence_regs(h);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma<64>(h, da + 2 * kk, db + 2 * kk, kk > 0);
  wgmma_commit();
}

// One item of the consumer's pipeline, parity P: fc1 of item i + 1 into
// h[1 - P]; + b1, GELU and the width mask on item i's h[P], rounded to bf16
// as fc2's A fragments; fc2 of item i into o; at the end of a tile the
// epilogue.  On entry item i's fc1 has retired.
template <int D, int P>
__device__ __forceinline__ void pipe_item(const Pipe& pp, int i, float (&h)[2][32],
                                          uint32_t (&a)[2][4][4], float (&o)[D / 2]) {
  using S = WShape<D>;
  constexpr int Q = 1 - P;
  const int c = i % pp.chunks, s = i % W_STAGES;
  // b1 of the chunk at this thread's columns 8j + 2t + {0, 1}, bf16 pairs
  const uint32_t* b1s =
      reinterpret_cast<const uint32_t*>(pp.w_st + s * S::STAGE_BYTES + S::W1_BYTES + S::W2_BYTES);
  uint32_t b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = b1s[4 * j + threadIdx.x % 4];
  if (i + 1 < pp.items) issue_fc1<D>(pp, i + 1, h[Q]);

  // + b1, the bf16 GELU (`gelu_poly`) in f32, rounded to bf16
  // (pallas_mlp.py:93) as fc2's A fragments.  Register r of k-step kk of
  // that A holds row lane / 4 + 8 (r % 2), columns 16 kk + 8 (r / 2) + 2t +
  // {0, 1}: the h registers
  // 8 kk + 2r and 8 kk + 2r + 1 (register 4j + 2r' + e of h holds row
  // lane / 4 + 8r', column 8j + 2t + e).  h itself is only read: a register
  // of a wgmma's accumulator written by another instruction while one is in
  // flight makes ptxas serialise every wgmma of the kernel.
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t bias = b[2 * kk + r / 2];
      a[P][kk][r] = pack_bf16(gelu_poly(h[P][8 * kk + 2 * r] + __uint_as_float(bias << 16)),
                              gelu_poly(h[P][8 * kk + 2 * r + 1] +
                                       __uint_as_float(bias & 0xffff0000u)));
    }
  if ((c + 1) * CHUNK > pp.active) {  // the last, partial chunk: columns past the mask are 0
    const int lim = pp.active - c * CHUNK - 2 * (threadIdx.x % 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = 16 * kk + 8 * (r / 2);  // less this thread's 2t
        a[P][kk][r] &= (col < lim ? 0x0000ffffu : 0u) | (col + 1 < lim ? 0xffff0000u : 0u);
      }
  }

  // fc2: o += gelu(h) @ w2_chunk^T, w2's stage K-major along the chunk; a
  // tile's first chunk starts o afresh
  const uint64_t dw2 = smem_desc(pp.w_st + s * S::STAGE_BYTES + S::W1_BYTES, 16, 1024, 1);
  fence_regs(o);
  fence_regs(a[P]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, a[P][kk], dw2 + 2 * kk, c > 0 || kk > 0);
  wgmma_commit();

  const bool tile_end = c == pp.chunks - 1;
  if (!tile_end) {
    wgmma_wait<1>();  // fc1 of item i + 1 and fc2 of item i - 1 have retired
    fence_regs(h[Q]);
    if (c > 0 && pp.tid == 0) mbar_arrive(&pp.w_empty[(i - 1) % W_STAGES]);
    return;
  }
  wgmma_wait<0>();
  fence_regs(h[Q]);
  fence_regs(o);
  if (pp.tid == 0) {
    if (c > 0) mbar_arrive(&pp.w_empty[(i - 1) % W_STAGES]);
    mbar_arrive(&pp.w_empty[s]);
    mbar_arrive(&pp.x_empty[(i / pp.chunks) & 1]);  // every fc1 of the tile has retired
  }
  // epilogue: + b2, rounded once; accumulator register 4j + 2r + e holds row
  // 16 * warp + lane / 4 + 8r, column 8j + 2t + e
  const int lane = pp.tid % 32, t = lane % 4;
  const int row = (pp.first + i / pp.chunks) * W_ROWS + pp.cw * 64 + 16 * (pp.tid / 32) + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r < pp.n) {
      bf16* dst = pp.out + (size_t)(row + 8 * r) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float b0 = __bfloat162float(pp.b2[8 * j + 2 * t]);
        const float b1 = __bfloat162float(pp.b2[8 * j + 2 * t + 1]);
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] + b0, o[4 * j + 2 * r + 1] + b1);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
pipelined_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w1,
                       const __grid_constant__ CUtensorMap map_w2,
                       const __grid_constant__ CUtensorMap map_b1, const bf16* __restrict__ b2,
                       bf16* __restrict__ out, int n, int m,
                       const int* __restrict__ active_p, int active_all) {
  using S = WShape<D>;
  extern __shared__ __align__(16) unsigned char pipe_smem[];
  // the swizzle atoms must start 1,024-byte aligned
  unsigned char* smem = pipe_smem + ((1024 - (smem_u32(pipe_smem) & 1023)) & 1023);
  unsigned char* x_st = smem;                     // [2][128 rows][D]
  unsigned char* w_st = x_st + 2 * S::X_BYTES;    // [STAGES][w1: 64 x D | w2: D x 64 | b1]
  uint64_t* bars = reinterpret_cast<uint64_t*>(w_st + W_STAGES * S::STAGE_BYTES);

  const int p = blockIdx.y;
  const int active = active_of(active_p, active_all, m);
  const int chunks = (active + CHUNK - 1) / CHUNK;
  int first, last;
  my_tiles((n + W_ROWS - 1) / W_ROWS, &first, &last);
  if (first == last) return;  // more blocks than tiles: no plan makes this
  b2 += (size_t)p * D;
  out += (size_t)p * n * D;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (chunks == 0) {  // no live column: out = b2
    for (int i = threadIdx.x; i < (last - first) * W_ROWS * D; i += W_THREADS) {
      const int row = first * W_ROWS + i / D;
      if (row < n) out[(size_t)row * D + i % D] = b2[i % D];
    }
    return;
  }
  const Pipe pp{x_st, w_st, bars, bars + 2, bars + 4, bars + 4 + W_STAGES, b2, out, n, active, chunks,
                (last - first) * chunks, first, wg - 1, tid};

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&pp.x_full[i], 1);
      mbar_init(&pp.x_empty[i], 2);  // one arrival from each consumer warpgroup
    }
    for (int i = 0; i < W_STAGES; ++i) {
      mbar_init(&pp.w_full[i], 1);
      mbar_init(&pp.w_empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      for (int i = 0; i < pp.items; ++i) {
        const int k = i / chunks, c = i % chunks, s = i % W_STAGES;
        if (c == 0) {  // the tile's x rows, a tile ahead where the buffer is free
          mbar_wait(&pp.x_empty[k & 1], ((k >> 1) & 1) ^ 1);  // at once on the first lap
          mbar_expect_tx(&pp.x_full[k & 1], S::X_BYTES);
          tma_load_3d(x_st + (k & 1) * S::X_BYTES, &map_x, &pp.x_full[k & 1], 0,
                      (first + k) * W_ROWS, p);
        }
        mbar_wait(&pp.w_empty[s], ((i / W_STAGES) & 1) ^ 1);
        mbar_expect_tx(&pp.w_full[s], S::TX_BYTES);
        unsigned char* st = w_st + s * S::STAGE_BYTES;
        tma_load_3d(st, &map_w1, &pp.w_full[s], 0, c * CHUNK, p);
        tma_load_3d(st + S::W1_BYTES, &map_w2, &pp.w_full[s], c * CHUNK, 0, p);
        tma_load_3d(st + S::W1_BYTES + S::W2_BYTES, &map_b1, &pp.w_full[s], c * CHUNK, 0, p);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  float h[2][32];
  uint32_t a[2][4][4];
  float o[D / 2];  // written first by the scale-free k-step of a tile's first fc2
  issue_fc1<D>(pp, 0, h[0]);
  wgmma_wait<0>();
  fence_regs(h[0]);
  for (int i = 0; i < pp.items; i += 2) {
    pipe_item<D, 0>(pp, i, h, a, o);
    if (i + 1 < pp.items) pipe_item<D, 1>(pp, i + 1, h, a, o);
  }
}

template <int D>
cudaError_t wgmma_ready(int device) {
  static std::atomic<unsigned long long> smem_set{0};  // one bit a device
  return raise_smem_limit_once((const void*)pipelined_wgmma_kernel<D>, (int)WShape<D>::SMEM,
                               device, smem_set);
}

template <int D>
cudaError_t launch_wgmma(int device, const void* x, const void* w1, const void* b1,
                         const void* w2, int ld2, const void* b2, void* out, int n, int m,
                         int active, const int* active_p, int models, int blocks,
                         cudaStream_t stream) {
  using S = WShape<D>;
  CUtensorMap map_x, map_w1, map_w2, map_b1;
  if (!encode_map_3d(&map_x, x, models, n, D, D, D, W_ROWS, S::SW) ||
      !encode_map_3d(&map_w1, w1, models, m, D, D, D, CHUNK, S::SW) ||
      !encode_map_3d(&map_w2, w2, models, D, m, ld2, CHUNK, D, 128) ||
      !encode_map_3d(&map_b1, b1, models, 1, m, ld2, CHUNK, 1, 0))
    return cudaErrorInvalidValue;
  const cudaError_t err = wgmma_ready<D>(device);
  if (err != cudaSuccess) return err;
  pipelined_wgmma_kernel<D><<<dim3(blocks, models), W_THREADS, S::SMEM, stream>>>(
      map_x, map_w1, map_w2, map_b1, static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), n, m, active_p, active);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at D = 8: CUDA cores.
// ---------------------------------------------------------------------------

constexpr int TILE_N = 64;         // token rows a tile
constexpr int CORE_THREADS = 256;  // a 16 x 16 grid of threads
// three blocks an SM: the registers must allow them (85 a thread at D = 64
// in f32, when this tiling served f32 too)
constexpr int CORE_BLOCKS_AN_SM = 3;

template <int D>
struct CoreSmem {  // padded f32 rows, no bank conflicts
  static constexpr int DP = D + 1, CP = CHUNK + 1;
  float x[TILE_N * DP];
  float w1[CHUNK * DP];
  float h[TILE_N * CP];
  float w2[D * CP];
};

template <typename T, int D>
__global__ void __launch_bounds__(CORE_THREADS, CORE_BLOCKS_AN_SM)
pipelined_core_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const T* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ b2, T* __restrict__ out, int n, int m,
                      const int* __restrict__ active_p, int active_all) {
  const Model<T> md(x, w1, b1, w2, b2, out, active_p, active_all, n, D, m);
  using S = CoreSmem<D>;
  constexpr int DP = S::DP, CP = S::CP;
  constexpr int OJ = (D + 15) / 16;  // output columns a thread
  extern __shared__ __align__(16) unsigned char core_smem[];
  S& s = *reinterpret_cast<S*>(core_smem);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;  // rows ty + 16 i
  const int active = md.active;
  const int chunks = (active + CHUNK - 1) / CHUNK;
  int first, last;
  my_tiles((n + TILE_N - 1) / TILE_N, &first, &last);
  const int items = (last - first) * chunks;

  if (chunks == 0) {  // no live column: out = b2
    for (int i = tid; i < (last - first) * TILE_N * D; i += CORE_THREADS) {
      const int row = first * TILE_N + i / D;
      if (row < n) md.out[(size_t)row * D + i % D] = md.b2[i % D];
    }
    return;
  }

  float acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < items; ++it) {
    const int k = it / chunks, c = it % chunks, c0 = c * CHUNK;
    const int row0 = (first + k) * TILE_N;
    __syncthreads();  // the last item's reads of x, w1, h and w2 are done
    if (c == 0)
      for (int i = tid; i < TILE_N * D; i += CORE_THREADS) {
        const int r = i / D, d = i % D;
        s.x[r * DP + d] = row0 + r < n ? to_f32(md.x[(size_t)(row0 + r) * D + d]) : 0.f;
      }
    // the item's weight chunk, zero past `active`
    for (int i = tid; i < CHUNK * D; i += CORE_THREADS) {
      const int cc = i / D, d = i % D;
      s.w1[cc * DP + d] = c0 + cc < active ? to_f32(md.w1[(size_t)(c0 + cc) * D + d]) : 0.f;
    }
    for (int i = tid; i < D * CHUNK; i += CORE_THREADS) {
      const int o = i / CHUNK, cc = i % CHUNK;
      s.w2[o * CP + cc] = c0 + cc < active ? to_f32(md.w2[(size_t)o * m + c0 + cc]) : 0.f;
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
      for (int i = 0; i < 4; ++i) xv[i] = s.x[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = s.w1[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) h[i][j] = fmaf(xv[i], wv[j], h[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      const bool keep = col < active;
      const float bias = keep ? to_f32(md.b1[col]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // gelu(h) rounded to the input type before fc2, as the TPU kernel does
        const float g = to_f32(from_f32<T>(gelu<T>(h[i][j] + bias)));
        s.h[(ty + 16 * i) * CP + tx + 16 * j] = keep ? g : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int cc = 0; cc < CHUNK; ++cc) {
      float gv[4], wv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = s.h[(ty + 16 * i) * CP + cc];
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const int o = tx + 16 * j;
        wv[j] = o < D ? s.w2[o * CP + cc] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) acc[i][j] = fmaf(gv[i], wv[j], acc[i][j]);
    }
    if (c == chunks - 1) {  // the tile's last chunk: write it out
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
}

template <typename T, int D>
cudaError_t core_ready(int device) {
  static std::atomic<unsigned long long> smem_set{0};
  return raise_smem_limit_once((const void*)pipelined_core_kernel<T, D>,
                               (int)sizeof(CoreSmem<D>), device, smem_set);
}

template <typename T, int D>
cudaError_t launch_core(int device, const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* out, int n, int m, int active,
                        const int* active_p, int models, int blocks, cudaStream_t stream) {
  const cudaError_t err = core_ready<T, D>(device);
  if (err != cudaSuccess) return err;
  pipelined_core_kernel<T, D><<<dim3(blocks, models), CORE_THREADS, sizeof(CoreSmem<D>), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), n, m,
      active_p, active);
  return cudaGetLastError();
}

// The body's shape and occupancy: out[0] token rows a tile, [1] threads a
// block, [2] dynamic shared memory a block, [3] registers a thread at entry,
// [4] resident blocks an SM, [5] SMs.
template <typename K>
cudaError_t describe(int device, K kernel, int rows, int threads, int smem, int* out) {
  int per_sm = 0, sms = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, (size_t)smem);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = rows;
  out[1] = threads;
  out[2] = smem;
  out[3] = attr.numRegs;
  out[4] = per_sm;
  out[5] = sms;
  return cudaSuccess;
}

}  // namespace

// n token rows per model, `models` weight sets (P >= 1), active_p the
// per-model width mask on the device or null for `active` in all; dtype 1 =
// bfloat16 (f32 takes `mlp_pipelined_f32_launch`).  D in {8, 16, 32, 64};
// anything else returns cudaErrorInvalidValue.  Besides: ld2, the row length
// of w2 and of b1 in elements (m, or m rounded up to 8 in zero-padded copies:
// at D >= 16 TMA reads them, and their row strides must be multiples of 16
// bytes), and blocks, the grid's blocks a model (`k1c_plan`).
extern "C" int mlp_pipelined_launch(int device, const void* x, const void* w1,
                                    const void* b1, const void* w2, int ld2, const void* b2,
                                    void* out, int n, int d, int m, int active,
                                    const int* active_p, int models, int blocks, int dtype,
                                    void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || models == 0) return 0;
  if (blocks < 1 || models > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
#define CORE_ARGS device, x, w1, b1, w2, b2, out, n, m, active, active_p, models, blocks, stream
#define WGMMA_ARGS device, x, w1, b1, w2, ld2, b2, out, n, m, active, active_p, models, blocks, stream
  if (dtype == 1) {
    switch (d) {
      case 8: return (int)launch_core<bf16, 8>(CORE_ARGS);
      case 16: return (int)launch_wgmma<16>(WGMMA_ARGS);
      case 32: return (int)launch_wgmma<32>(WGMMA_ARGS);
      case 64: return (int)launch_wgmma<64>(WGMMA_ARGS);
    }
  }
#undef CORE_ARGS
#undef WGMMA_ARGS
  return (int)cudaErrorInvalidValue;
}

// K1c in f32 on K1's narrow f32 body (`mlp_narrow_f32.cuh`): the arguments
// of `mlp_pipelined_launch` less ld2, blocks and the dtype, on `splits` x
// `groups` clusters a model (`fused_mlp.k1_narrow_f32_plan`,
// `k1c_narrow_f32_groups`).  d in {8, 16, 32, 64}; anything else, or a plan
// the body does not take, returns cudaErrorInvalidValue.
extern "C" int mlp_pipelined_f32_launch(int device, const float* x, const float* w1,
                                        const float* b1, const float* w2, const float* b2,
                                        float* out, int n, int d, int m, int active,
                                        const int* active_p, int models, int splits,
                                        int groups, void* stream) {
  return (int)narrow_f32::launch(device, x, w1, b1, w2, b2, out, n, d, m, active, active_p,
                                 models, splits, groups, static_cast<cudaStream_t>(stream));
}

// The body that serves (dtype, d) and its occupancy, as `describe` lists
// them, for `k1c_plan` (in f32 the narrow f32 body's, one block a cluster).
extern "C" int mlp_pipelined_shape(int device, int d, int dtype, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
#define WGMMA_SHAPE(D)                                                                      \
  (err = wgmma_ready<D>(device)) != cudaSuccess                                            \
      ? (int)err                                                                           \
      : (int)describe(device, pipelined_wgmma_kernel<D>, W_ROWS, W_THREADS,                \
                      (int)WShape<D>::SMEM, out)
#define CORE_SHAPE(T, D)                                                                    \
  (err = core_ready<T, D>(device)) != cudaSuccess                                          \
      ? (int)err                                                                           \
      : (int)describe(device, pipelined_core_kernel<T, D>, TILE_N, CORE_THREADS,           \
                      (int)sizeof(CoreSmem<D>), out)
  if (dtype == 1) {
    switch (d) {
      case 8: return CORE_SHAPE(bf16, 8);
      case 16: return WGMMA_SHAPE(16);
      case 32: return WGMMA_SHAPE(32);
      case 64: return WGMMA_SHAPE(64);
    }
  } else if (dtype == 0) {
    int shape[7];
    err = narrow_f32::describe(device, d, 1, shape);
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < 6; ++i) out[i] = shape[i];
    return 0;
  }
#undef WGMMA_SHAPE
#undef CORE_SHAPE
  return (int)cudaErrorInvalidValue;
}

// K1c's wide regime in bf16 (64 < d <= 8,192, d a multiple of 8), with the
// model axis: the operands of `fused_mlp_wide_launch` (`fused_mlp.cu`), and
// ready, models * ceil(n / 128) + 1 int32 counters, all 0 (one a (model, row
// tile), then the tickets), with a lead of `lead` row-tile groups on `blocks`
// persistent blocks (`fused_mlp.k1c_wide_plan`; 1 <= lead <= the groups, 1
// <= blocks <= the units).  One launch.  Returns cudaGetLastError() after it,
// or cudaErrorInvalidValue for a shape, layout or grid it does not take
// (nothing launched).  n == 0 launches nothing.
extern "C" int mlp_pipelined_wide_launch(int device, const void* x, const void* w1,
                                         const void* b1, const void* w2, int ld_w2,
                                         const void* b2, void* h, int ld_h, int* ready,
                                         void* out, int n, int d, int m, int active,
                                         const int* active_p, int models, int lead,
                                         int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide::wide_shape_ok(d, m, ld_w2, ld_h, models, 8) || ready == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return (int)wide::run_queue_bf16(device, x, w1, b1, w2, ld_w2, b2, h, ld_h, ready, out, n, d,
                                   m, active, active_p, models, lead, blocks,
                                   static_cast<cudaStream_t>(stream));
}

// K1c's wide regime in f32 (64 < d <= 8,192, d a multiple of 4): the
// arguments of `mlp_pipelined_wide_launch`, ld_w2 and ld_h multiples of 4.
extern "C" int mlp_pipelined_wide_f32_launch(int device, const void* x, const void* w1,
                                             const void* b1, const void* w2, int ld_w2,
                                             const void* b2, void* h, int ld_h, int* ready,
                                             void* out, int n, int d, int m, int active,
                                             const int* active_p, int models, int lead,
                                             int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide::wide_shape_ok(d, m, ld_w2, ld_h, models, 4) || ready == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return (int)wide::run_queue_f32(device, x, w1, b1, w2, ld_w2, b2, h, ld_h, ready, out, n, d,
                                  m, active, active_p, models, lead, blocks,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* mlp_pipelined_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

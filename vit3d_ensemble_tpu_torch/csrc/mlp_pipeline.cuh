// The bf16 fused FFN at D in {8, 16, 32, 64} as a warp-specialised `wgmma`
// pipeline fed by TMA: out = gelu(x @ w1^T + b1)[:, :active] @ w2[:, :active]^T
// + b2, with the model axis.  One body, two sums of fc2:
//   * K1c (`mlp_pipelined.cu`, `pipelined_wgmma_kernel` at D 16-64 and
//     `pipelined_wgmma_d8_kernel` at D 8; also every K1 bf16 call at D <=
//     64): fc2 summed in one accumulator over all of M, the function of
//     `vit3d_ensemble_tpu/ops/pallas_mlp.py:_mlp_kernel` and
//     `_pipelined2_mlp_kernel`;
//   * K1b (`mlp_chunked.cu`, `chunked_wgmma_kernel` and
//     `chunked_wgmma_d8_kernel`, CHUNKED): fc2 summed in f32 over chunks of
//     512 hidden columns, one chunk after the other, the order of
//     `_chunked_mlp_kernel` (`pallas_mlp.py:126-139`).
// Each library includes this file and declares its own kernel around
// `pipeline_body`, so the two keep their names; the code here has internal
// linkage (an unnamed namespace): a static local of a template with
// external linkage is one object across every library loaded in the
// process, and one library's once-a-device flag would stand for another's
// kernel.
//
// What bounds it on the H100: the n*M GELUs on the FP32 pipes, not the
// 4*n*D*M multiply-adds.  At the serving shape (n = 33,280, D = 64, M =
// 3,072) the products take 26.5 us at the tensor cores' peak; the 102 M
// GELUs, the TPU kernels' polynomial (`gelu_poly`, 16 FP32 instructions
// each), about 0.05 ms at 128 lanes an SM.  So the design's aim is that the
// tensor cores and the loads hide under the GELUs, which run on every SM all
// the time.
//
// Design: a persistent, warp-specialised block of three warpgroups, one
// block an SM.
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
//   * The grid (`k1c_plan` in `ops/fused_mlp.py`, for both): grid y is the
//     model, grid x the blocks of a model, never more than the resident
//     slots divided among the models, each block taking a contiguous run of
//     row tiles, balanced to within one.
// K1c sums fc2's chunks in the chunks' order, k-step by k-step, in one
// accumulator from a tile's first chunk to its last.
//
// K1b's sum (CHUNKED): eight stages make one 512-column summation chunk.
// fc2's accumulator starts from zero (scale-d off) at each sum chunk's
// first stage, and the finished chunk is added into an f32 running sum, in
// chunk order; + b2 and the bf16 store once, at the tile's end.  The
// running sum lives in shared memory, each consumer thread's own D / 2
// floats (32 KB a block at D = 64): held in registers, 32 more a consumer
// thread at D = 64, it cost 5 % more time at the serving shape on an H100
// (PERF.md).  A partial last chunk (M not a multiple of 512, or the width
// mask) ends where the stages end.  The promotion stalls nothing: at a sum
// chunk's first stage c, after the GELU of c and before fc2 of c is issued,
// `wgmma.wait_group 1` retires fc2 of c - 1 (the chunk's last, issued
// before that GELU began, so long done) and leaves fc1 of c + 1 in flight;
// the accumulator is then read with no wgmma in flight on it, which keeps
// ptxas from serialising the wgmmas (C7515).  Every item commits its fc1
// group, an empty one past the block's last item, so that one wait count
// holds everywhere.  Two accumulators alternating by chunk would need the
// chunk's parity at compile time: the tile's chunk count is the width's, so
// choosing one would put a branch around the wgmmas, which ptxas cannot
// prove uniform (C7518).
//
// D = 8 (every bf16 D from 1 to 8, zero-padded to 8 by the wrapper), the
// instance SPLIT.  wgmma takes bf16 in k-steps of 16, so x's row tile and
// w1's stages keep the D = 16 instance's layout (32-byte rows, the 32-byte
// swizzle and its descriptors): their tensor maps have a global width of 8
// and a box 16 columns wide, and TMA zero-fills columns 8-15 (its
// transaction counts them too).  fc2 is an RS wgmma m64n8k16 reading w2's
// stage of 8 rows of 128 bytes.  At D = 8 a row's 4 D M multiply-adds are
// as many as its GELUs' 16 M FP32 instructions, and on the tensor cores take
// a small part of their time, so the GELUs bound it; what held the CUDA-core
// bodies before was latency: few row tiles, each block walking all of M
// alone.  So the hidden columns are split across the blocks of a
// thread-block cluster (the narrow f32 body's design, `mlp_narrow_f32.cuh`):
// a unit is (row tile, split, model), the plan (`fused_mlp.k1_d8_plan`)
// takes, from n, M and the card alone, the most splits at which one cluster
// a row tile fits the card in one wave (the card holds fewer clusters of
// each size than the SMs / the size, `clusters` below: 15 of 8 blocks on an
// H100), and split s of S takes the contiguous stages [s C / S, (s + 1) C /
// S) of the C = ceil(m / 64), cut at the model's width (K1b: of the C / 8
// summation chunks, so that a split starts on a 512-column boundary and
// keeps its chunks' running sum as above).  With S > 1 each cluster takes
// one row tile: each block's fc2 partial (128 x 8 f32) goes to its own
// shared memory, and after a cluster barrier the blocks add the partials in
// rank order through distributed shared memory, add b2 once and store bf16;
// a second barrier keeps every block's shared memory until all have read
// it.  No float atomics, the same bits every run; a split wholly past a
// model's width joins the sum with zeros.  The splits' order differs from
// one left fold over M only in where the splits fall (K1b: in that its
// chunks are summed a split at a time), within the bf16 gate (0.05 + 0.05
// |ref|).  With S = 1 the grid is the persistent one above.  The D 16-64
// instances take none of this: it is compiled only where SPLIT is set.

#pragma once

#include <cooperative_groups.h>

#include <atomic>

#include "mlp_common.cuh"
#include "sm90_common.cuh"

namespace pipeline {
namespace {

using namespace mlp;
using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int CHUNK = 64;        // hidden columns per item (a stage)
constexpr int SUM_STAGES = 8;    // K1b: stages of fc2's 512-column summation chunk
constexpr int W_ROWS = 128;      // token rows a tile: two consumer warpgroups of 64
constexpr int W_THREADS = 384;   // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int W_STAGES = 8;
constexpr int SUM_STRIDE = 256;  // K1b's running sums: [D / 2][a consumer thread]
constexpr int MAX_SPLITS = 16;   // D = 8: blocks of a cluster; above 8 non-portable

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

template <int D>
struct WShape {
  static constexpr bool SPLIT = D < 16;  // D = 8: the hidden columns split across a cluster
  static constexpr int KD = SPLIT ? 16 : D;  // fc1's K: D = 8 zero-filled to 16 by TMA
  static constexpr int SW = 2 * KD;  // bytes of an x or w1 row, and their swizzle
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
  static constexpr size_t RED_BYTES = SPLIT ? W_ROWS * D * sizeof(float) : 0;  // fc2's partial
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
  int k0;      // SPLIT: the first stage of this block's split (0 without)
  float* red;  // SPLIT with splits > 1: this block's fc2 partial of its row tile
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
  for (int kk = 0; kk < S::KD / 16; ++kk) wgmma<64>(h, da + 2 * kk, db + 2 * kk, kk > 0);
  wgmma_commit();
}

// The dynamic shared memory of the pipeline: K1b's adds the running sums,
// D = 8's the partial its cluster adds.
template <int D, bool CHUNKED>
constexpr size_t smem_bytes() {
  return WShape<D>::SMEM + (CHUNKED ? (size_t)SUM_STRIDE * (D / 2) * sizeof(float) : 0) +
         WShape<D>::RED_BYTES;
}

// One item of the consumer's pipeline, parity P: fc1 of item i + 1 into
// h[1 - P]; + b1, GELU and the width mask on item i's h[P], rounded to bf16
// as fc2's A fragments; fc2 of item i into o; at the end of a tile the
// epilogue.  On entry item i's fc1 has retired.  With CHUNKED, `acc` is
// this thread's first entry of the tile's f32 sum of its finished
// 512-column chunks (K1b), its others SUM_STRIDE apart.
template <int D, int P, bool CHUNKED>
__device__ __forceinline__ void pipe_item(const Pipe& pp, int i, float (&h)[2][32],
                                          uint32_t (&a)[2][4][4], float (&o)[D / 2],
                                          float* acc) {
  using S = WShape<D>;
  constexpr int Q = 1 - P;
  // the item's stage of the tile's run, and (SPLIT) of the model's hidden
  // columns
  const int cl = i % pp.chunks, s = i % W_STAGES;
  const int c = S::SPLIT ? pp.k0 + cl : cl;
  // b1 of the chunk at this thread's columns 8j + 2t + {0, 1}, bf16 pairs
  const uint32_t* b1s =
      reinterpret_cast<const uint32_t*>(pp.w_st + s * S::STAGE_BYTES + S::W1_BYTES + S::W2_BYTES);
  uint32_t b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = b1s[4 * j + threadIdx.x % 4];
  if (i + 1 < pp.items) {
    issue_fc1<D>(pp, i + 1, h[Q]);
  } else if constexpr (CHUNKED) {
    wgmma_commit();  // an empty group: the wait count below holds here too
  }

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

  // K1b: the first stage of a sum chunk after the tile's first; fc2 of
  // item i - 1, that chunk's last, retires (fc1 of item i + 1 stays in
  // flight), and the finished chunk joins the running sum
  bool restart = cl == 0;
  if constexpr (CHUNKED) {
    restart = c % SUM_STAGES == 0;
    if (restart && cl > 0) {
      wgmma_wait<1>();
      fence_regs(o);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[SUM_STRIDE * j] += o[j];
    }
  }

  // fc2: o += gelu(h) @ w2_chunk^T, w2's stage K-major along the chunk; a
  // tile's first chunk (K1b: a sum chunk's first stage) starts o afresh
  const uint64_t dw2 = smem_desc(pp.w_st + s * S::STAGE_BYTES + S::W1_BYTES, 16, 1024, 1);
  fence_regs(o);
  fence_regs(a[P]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, a[P][kk], dw2 + 2 * kk, !restart || kk > 0);
  wgmma_commit();

  const bool tile_end = cl == pp.chunks - 1;
  if (!tile_end) {
    wgmma_wait<1>();  // fc1 of item i + 1 and fc2 of item i - 1 have retired
    fence_regs(h[Q]);
    if (cl > 0 && pp.tid == 0) mbar_arrive(&pp.w_empty[(i - 1) % W_STAGES]);
    return;
  }
  wgmma_wait<0>();
  fence_regs(h[Q]);
  fence_regs(o);
  if (pp.tid == 0) {
    if (cl > 0) mbar_arrive(&pp.w_empty[(i - 1) % W_STAGES]);
    mbar_arrive(&pp.w_empty[s]);
    mbar_arrive(&pp.x_empty[(i / pp.chunks) & 1]);  // every fc1 of the tile has retired
  }
  // the tile's sum; K1b's: its finished chunks and the last one, the
  // running sum then set back to zero for the next tile
  float sum[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) {
    if constexpr (CHUNKED) {
      sum[j] = acc[SUM_STRIDE * j] + o[j];
      acc[SUM_STRIDE * j] = 0.f;
    } else {
      sum[j] = o[j];
    }
  }
  // epilogue: + b2, rounded once; accumulator register 4j + 2r + e holds row
  // 16 * warp + lane / 4 + 8r, column 8j + 2t + e
  const int lane = pp.tid % 32, t = lane % 4;
  if constexpr (S::SPLIT) {
    if (pp.red != nullptr) {  // the partial, which the cluster adds (pipeline_body)
      const int rl = pp.cw * 64 + 16 * (pp.tid / 32) + lane / 4;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(pp.red + (rl + 8 * r) * D + 8 * j + 2 * t) =
              make_float2(sum[4 * j + 2 * r], sum[4 * j + 2 * r + 1]);
      return;
    }
  }
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
            pack_bf16(sum[4 * j + 2 * r] + b0, sum[4 * j + 2 * r + 1] + b1);
      }
    }
  }
}

// SPLIT with splits > 1: the blocks of the cluster add their fc2 partials
// (`red`, [128 rows][D] f32 each) of the row tile `tile` in rank order, add
// b2 and round to bf16 once; block r of S stores the r-th S-th of the tile's
// elements.  Every thread of every block of the cluster calls it.
template <int D>
__device__ __forceinline__ void cluster_add(float* red, const bf16* b2, bf16* out, int n,
                                            int tile, int split, int splits) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is written
  if (threadIdx.x >= 128) {  // the consumers: the producer gave up its registers
    const int row0 = tile * W_ROWS;
    const int lo = split * (W_ROWS * D) / splits, hi = (split + 1) * (W_ROWS * D) / splits;
    for (int e = lo + (int)threadIdx.x - 128; e < hi && row0 + e / D < n; e += W_THREADS - 128) {
      float sum = 0.f;
      for (int r = 0; r < splits; ++r) sum += cluster.map_shared_rank(red, r)[e];
      out[(size_t)row0 * D + e] = __float2bfloat16_rn(sum + __bfloat162float(b2[e % D]));
    }
  }
  cluster.sync();  // every block has read the others' partials
}

// The body of a kernel of the pipeline: its parameters are the kernel's
// (the tensor maps by reference to the kernel's __grid_constant__ ones);
// `splits`, read at D = 8 alone, the blocks of a cluster.
template <int D, bool CHUNKED>
__device__ __forceinline__ void pipeline_body(const CUtensorMap& map_x, const CUtensorMap& map_w1,
                                              const CUtensorMap& map_w2,
                                              const CUtensorMap& map_b1, const bf16* b2,
                                              bf16* out, int n, int m, const int* active_p,
                                              int active_all, int splits = 1) {
  using S = WShape<D>;
  extern __shared__ __align__(16) unsigned char pipe_smem[];
  // the swizzle atoms must start 1,024-byte aligned
  unsigned char* smem = pipe_smem + ((1024 - (smem_u32(pipe_smem) & 1023)) & 1023);
  unsigned char* x_st = smem;                     // [2][128 rows][D]
  unsigned char* w_st = x_st + 2 * S::X_BYTES;    // [STAGES][w1: 64 x D | w2: D x 64 | b1]
  uint64_t* bars = reinterpret_cast<uint64_t*>(w_st + W_STAGES * S::STAGE_BYTES);
  float* sums = reinterpret_cast<float*>(bars + 4 + 2 * W_STAGES);  // K1b: [D / 2][256]
  float* red = sums + (CHUNKED ? SUM_STRIDE * (D / 2) : 0);  // D = 8: [128 rows][D]

  const int p = blockIdx.y;
  const int active = active_of(active_p, active_all, m);
  int chunks = (active + CHUNK - 1) / CHUNK;
  int first, last, k0 = 0, split = 0;
  if constexpr (S::SPLIT) {
    // split s of the cluster: the stages [k0, k1) of the model's ceil(m /
    // 64) (K1b's in whole summation chunks), cut at the width; its group:
    // the row tiles [g T / G, (g + 1) T / G)
    constexpr int STEP = CHUNKED ? SUM_STAGES : 1;
    const int all = (m + CHUNK - 1) / CHUNK, units = (all + STEP - 1) / STEP;
    split = blockIdx.x % splits;
    k0 = STEP * (int)((long long)split * units / splits);
    const int k1 = min(STEP * (int)((long long)(split + 1) * units / splits), all);
    chunks = max(min(k1, chunks) - k0, 0);
    const int tiles = (n + W_ROWS - 1) / W_ROWS, group = blockIdx.x / splits;
    const int groups = gridDim.x / splits;
    first = (int)((long long)group * tiles / groups);
    last = (int)((long long)(group + 1) * tiles / groups);
  } else {
    my_tiles((n + W_ROWS - 1) / W_ROWS, &first, &last);
  }
  if (first == last) return;  // more blocks than tiles: no plan makes this
  b2 += (size_t)p * D;
  out += (size_t)p * n * D;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  // SPLIT with more than one split: one row tile a cluster, whose blocks'
  // partials `cluster_add` sums
  const bool reduce = S::SPLIT && splits > 1;

  if (chunks == 0 && !reduce) {  // no live column: out = b2
    for (int i = threadIdx.x; i < (last - first) * W_ROWS * D; i += W_THREADS) {
      const int row = first * W_ROWS + i / D;
      if (row < n) out[(size_t)row * D + i % D] = b2[i % D];
    }
    return;
  }
  if constexpr (S::SPLIT) {
    if (chunks == 0) {  // a split wholly past the width joins the sum with zeros
      for (int i = threadIdx.x; i < W_ROWS * D; i += W_THREADS) red[i] = 0.f;
      cluster_add<D>(red, b2, out, n, first, split, splits);
      return;
    }
  }
  const Pipe pp{x_st, w_st, bars, bars + 2, bars + 4, bars + 4 + W_STAGES, b2, out, n, active, chunks,
                (last - first) * chunks, first, wg - 1, tid, k0, reduce ? red : nullptr};

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
        const int col = (k0 + c) * CHUNK;
        tma_load_3d(st, &map_w1, &pp.w_full[s], 0, col, p);
        tma_load_3d(st + S::W1_BYTES, &map_w2, &pp.w_full[s], col, 0, p);
        tma_load_3d(st + S::W1_BYTES + S::W2_BYTES, &map_b1, &pp.w_full[s], col, 0, p);
      }
    }
    if constexpr (S::SPLIT) {
      if (reduce) {
        __syncwarp();
        cluster_add<D>(red, b2, out, n, first, split, splits);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  float h[2][32];
  uint32_t a[2][4][4];
  float o[D / 2];  // written first by the scale-free k-step of a tile's first fc2
  float* acc = nullptr;
  if constexpr (CHUNKED) {
    acc = sums + (threadIdx.x - 128);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[SUM_STRIDE * j] = 0.f;
  }
  issue_fc1<D>(pp, 0, h[0]);
  wgmma_wait<0>();
  fence_regs(h[0]);
  for (int i = 0; i < pp.items; i += 2) {
    pipe_item<D, 0, CHUNKED>(pp, i, h, a, o, acc);
    if (i + 1 < pp.items) pipe_item<D, 1, CHUNKED>(pp, i + 1, h, a, o, acc);
  }
  if constexpr (S::SPLIT) {
    if (reduce) cluster_add<D>(red, b2, out, n, first, split, splits);
  }
}

// A kernel of the pipeline, as each library declares it: at D 16-64, and
// at D = 8 with the blocks of a cluster last.
using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, const bf16*, bf16*,
                        int, int, const int*, int);
using SplitKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, const bf16*,
                             bf16*, int, int, const int*, int, int);

// Raise the kernel's shared-memory limit once a device, and at D = 8 allow
// clusters of more than 8 blocks.  The flag is this library's own (internal
// linkage), one an instantiation.
template <int D, bool CHUNKED, typename K>
cudaError_t ready(K kernel, int device) {
  static std::atomic<unsigned long long> smem_set{0};  // one bit a device
  if constexpr (WShape<D>::SPLIT) {
    const unsigned long long bit = device >= 0 && device < MAX_DEVICES ? 1ull << device : 0;
    if (bit != 0 && (smem_set.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes<D, CHUNKED>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute((const void*)kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) smem_set.fetch_or(bit, std::memory_order_relaxed);
    return err;
  } else {
    return raise_smem_limit_once((const void*)kernel, (int)smem_bytes<D, CHUNKED>(), device,
                                 smem_set);
  }
}

// The tensor maps of one launch.  x's and w1's boxes are fc1's K wide (16
// at D = 8, whose columns past 8 TMA zero-fills).
template <int D>
bool encode_maps(CUtensorMap (&maps)[4], const void* x, const void* w1, const void* b1,
                 const void* w2, int ld2, int n, int m, int models) {
  using S = WShape<D>;
  return encode_map_3d(&maps[0], x, models, n, D, D, S::KD, W_ROWS, S::SW) &&
         encode_map_3d(&maps[1], w1, models, m, D, D, S::KD, CHUNK, S::SW) &&
         encode_map_3d(&maps[2], w2, models, D, m, ld2, CHUNK, D, 128) &&
         encode_map_3d(&maps[3], b1, models, 1, m, ld2, CHUNK, 1, 0);
}

// The tensor maps and one launch on (blocks, models) blocks.
template <int D, bool CHUNKED>
cudaError_t launch(Kernel kernel, int device, const void* x, const void* w1, const void* b1,
                   const void* w2, int ld2, const void* b2, void* out, int n, int m, int active,
                   const int* active_p, int models, int blocks, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!encode_maps<D>(maps, x, w1, b1, w2, ld2, n, m, models)) return cudaErrorInvalidValue;
  const cudaError_t err = ready<D, CHUNKED>(kernel, device);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, models), W_THREADS, smem_bytes<D, CHUNKED>(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(b2), static_cast<bf16*>(out),
      n, m, active_p, active);
  return cudaGetLastError();
}

// D = 8: the tensor maps and one launch on (splits x blocks, models) blocks
// in clusters of `splits` (`fused_mlp.k1_d8_plan`): `blocks` row-tile groups
// a model, each the blocks of one cluster; with splits > 1 a group a row
// tile.  A plan the body does not take returns cudaErrorInvalidValue
// (nothing launched).
template <bool CHUNKED>
cudaError_t launch_split(SplitKernel kernel, int device, const void* x, const void* w1,
                         const void* b1, const void* w2, int ld2, const void* b2, void* out,
                         int n, int m, int active, const int* active_p, int models, int blocks,
                         int splits, cudaStream_t stream) {
  constexpr int D = 8;
  const int tiles = (n + W_ROWS - 1) / W_ROWS;
  if (splits < 1 || splits > MAX_SPLITS || blocks > tiles || (splits > 1 && blocks != tiles))
    return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!encode_maps<D>(maps, x, w1, b1, w2, ld2, n, m, models)) return cudaErrorInvalidValue;
  cudaError_t err = ready<D, CHUNKED>(kernel, device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * blocks, models);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = smem_bytes<D, CHUNKED>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3],
                           static_cast<const bf16*>(b2), static_cast<bf16*>(out), n, m, active_p,
                           active, splits);
  // the runtime keeps a refused launch's error as its last one, which the
  // next launch in this thread would read back: clear it
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// D = 8: the clusters of `splits` blocks the card holds at once.
template <bool CHUNKED>
cudaError_t clusters(SplitKernel kernel, int device, int splits, int* out) {
  if (splits < 1 || splits > MAX_SPLITS) return cudaErrorInvalidValue;
  cudaError_t err = ready<8, CHUNKED>(kernel, device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = smem_bytes<8, CHUNKED>();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

// A body's shape and occupancy: out[0] token rows a tile, [1] threads a
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

// The pipeline's shape for `describe`, raising its shared-memory limit first.
template <int D, bool CHUNKED, typename K>
cudaError_t shape(K kernel, int device, int* out) {
  const cudaError_t err = ready<D, CHUNKED>(kernel, device);
  return err != cudaSuccess
             ? err
             : describe(device, kernel, W_ROWS, W_THREADS, (int)smem_bytes<D, CHUNKED>(), out);
}

}  // namespace
}  // namespace pipeline

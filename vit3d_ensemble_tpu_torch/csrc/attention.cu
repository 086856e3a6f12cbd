// K4: tiled attention for head_dim > 16, ctx = softmax(q k^T / sqrt(hd)) v
// for every head of every volume.
//
// Replaces the TPU kernel
// `vit3d_ensemble_tpu/ops/pallas_attention.py:_attention_kernel` (reached
// through `fused_attention` -> `_fused_attention_impl` for head_dim > 16).
// The TPU kernel pads the batch-heads to blocks of up to 16 and keeps a whole
// (S, S) f32 score tile per head in VMEM.  At the stretch model's S = 513
// that tile is 1 MB a head and fits no SM, so this kernel never forms it: it
// walks the keys in chunks with an online softmax, and nothing is padded.
//
// What bounds it on the H100: the function reads q, k, v and writes ctx,
// 4 * BH * S * hd values, against 4 * BH * S * S * hd operations: S / 2
// operations a byte in bf16, 256 at S = 513, just below the card's ratio of
// 295.  At the stretch shape (BH = 96, S = 513, hd = 64, bf16) the bytes
// (25.2 MB) take 7.5 us at 3.35 TB/s and the operations (6.47 GFLOP) 6.5 us
// at the 989 TFLOP/s tensor-core peak, so the two bounds nearly meet, and
// only Hopper's full tensor-core rate (wgmma) comes near either.  In f32 the
// products run in 3xTF32 (below), three TF32 products for each f32 one:
// 19.4 GFLOP at the 495 TFLOP/s TF32 peak, 39 us, against 15 us for the
// bytes (50.4 MB); on CUDA cores they would take 97 us at the 67 TFLOP/s
// FP32 peak.
//
// Which body takes which input: bf16 runs the `wgmma` body below, f32 the
// `mma.sync` 3xTF32 body after it, at every head_dim from 17 to 256; above
// 256 their sliced forms (`attention_sliced_wgmma_kernel`,
// `attention_sliced_tf32x3_kernel`: blocks of 256 context columns, the
// scores' K loop over hd's 64-column boxes; see their note), as the TPU
// kernel takes any head_dim above 16.  Each unsliced body is built for the head dims
// K4_HDS (32, 64, 80, 128, 256), and a head_dim runs on the first at or
// above it: the columns from hd up to that HD are zero in shared memory
// (TMA's zero fill past the tensor map's hd columns in bf16, zero-filled
// cp.async copies in f32), so q k^T is exact and the context's extra
// columns, zero, are never stored.  The scale stays 1 / sqrt(hd) of the true
// hd, as `pallas_attention.py:144` keeps it while padding hd to MIN_HD.  At
// 32, 64 and 128 the bodies are the ones these head dims ran before any
// other was taken; 80 is ViT-H's head_dim and 256 the cap.  A head_dim
// between two bodies does the larger one's work: hd 48 runs as 64, 96 as
// 128, 200 as 256.
//
// One TF32 product (10 mantissa bits) misses the JAX tolerance
// of 2e-5 + 1e-4 |ref| (`tests/test_torch_stretch.py` emulates both); three
// hold it: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest, and a * b = lo_a hi_b + hi_a lo_b + hi_a hi_b with
// f32 sums, the dropped lo_a lo_b below 2^-22 |a b|: as close to an f64
// reference as plain f32 is.
//
// The bf16 body, one block of three warpgroups per (volume, head) and 128
// query rows:
//   * Warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//     one of its threads loads by TMA, first the block's q rows (64 a
//     consumer), then a ring of STAGES (k, v) stages of 64 keys each,
//     completion on `full` mbarriers, reuse on `empty` ones.  The three
//     tensor maps are 4-d over the strided (B, H, S, hd) storage, outer
//     dimensions ordered by stride, so the model's
//     `lin(x).view(B, S, H, hd).transpose(1, 2)` views and K3's views into
//     the (B, T, 3D) QKV buffer load without a copy.  Rows past S load as
//     zeros (TMA's zero fill), so a masked key meets a 0, never a NaN.
//   * Warpgroups 1 and 2 are the consumers, 64 query rows each, sharing every
//     (k, v) stage.  Per chunk: the scores S = q k^T by wgmma m64nNk16 with q
//     and k from 128-byte-swizzled shared memory (64-byte at hd 32); keys
//     past S masked to -inf; the running max and sum of each row updated and
//     the context rescaled; exp(s - max) rounded to bf16 in registers, where
//     the score accumulators already lie as wgmma's A fragments, so the
//     probabilities never leave the SM; then ctx += p v by wgmma with p from
//     registers and v through a transposed (N-major) descriptor on its
//     row-major stage.  Both products accumulate in f32.
//   * The ragged tail of keys: a chunk of 64 holds 64 keys but for the last,
//     which holds S - 64 * (chunks - 1).  When that is 16 or fewer (S = 513:
//     one key), the last chunk runs on 16 keys, wgmma m64n16k16 for its
//     scores and one 16-key step of p v, not a chunk of 64: 8.25 chunk-steps
//     a query tile at S = 513, not 9.
//   * Rounding, as before: the unnormalised probabilities exp(s - max) go to
//     bf16 before the second product, the row sums stay f32, and the context
//     is divided by them and rounded once.  The TPU kernel rounds the
//     normalised probabilities instead, which an online softmax does not
//     have; `_plain_attention_k4` rounds where this kernel does.
//   * Every chunk holds at least one live key, so a row's running max is
//     finite from the first chunk on and its final sum is at least 1.
//
// Tiles and waves at the stretch shape (BH = 96, S = 513, hd 64): 513 =
// 8 * 64 + 1, so a head has 9 query tiles of 64 rows, 8 full and one with a
// single live row: 864 warpgroup tiles.  wgmma's M is 64, so the single row
// costs a whole tile (1/9 of the work); the key tail costs a quarter chunk.
// Blocks of 128 rows give 5 a head, 480 in all: 384 with two tiles and 96
// (the last of each head) with one, whose second warpgroup has no row and
// leaves at once.  A block takes 83 KB of shared memory (two q tiles and 4
// stages of 16 KB) and 384 threads at 80 registers (consumers 104 after
// setmaxnreg), so two are resident an SM: 264 at once on 132 SMs.  864 tiles
// do not divide among 132 SMs (6.55 an SM), so no tiling fills whole waves;
// what this one does: the one-tile blocks come last in the grid's order
// (grid y = row block, dispatched after every head's earlier row blocks),
// so they fill the second wave's gaps: 264 two-tile blocks, then 120
// two-tile and 96 one-tile blocks on 264 slots, about 7 tiles on the
// busiest SM against 6.55 on average.  Each head's k and v (131 KB) are
// read from L2 by 5 blocks, not 9 (63 MB in all, not 113).  `attention_plan`
// returns this reckoning for any shape, with the occupancy the runtime
// reports; `chip_smoke.py` prints it in its `build` phase.  hd 128 takes
// one block an SM (165 KB of shared memory; consumers at 232 registers for
// 64 + 32 accumulators); hd 32 two.
//
// The f32 body, one block of 4 warps per (volume, head) and 64 query rows,
// 16 a warp, on `mma.sync` m16n8k8 in TF32 (`wgmma` takes TF32 only with
// both operands K-major, and v's (keys, hd) stage is N-major for p v; the
// threads load `mma.sync` fragments in any layout):
//   * The block's q rows, then a ring of (k, v) stages of 32 keys (3 stages,
//     2 at hd 128), come by cp.async into rows padded by 4 floats, so that
//     each warp's fragment reads fall on 32 distinct banks; 16-byte copies
//     where every base and stride is a multiple of 16 bytes, 4-byte copies
//     otherwise (a second instantiation; `attention_last_body` says which
//     ran).  Rows past S are zero-filled.  One __syncthreads a chunk: the
//     stage it frees is refilled while the warps compute on the others.
//   * Every operand is split into TF32 hi and lo as its fragment loads
//     (rounded to nearest, ties away, as cvt.rna, in two integer
//     instructions), and each 16x8x8 product runs as lo*hi, hi*lo and
//     hi*hi.  The tensor cores truncate inside an `mma`: every term and the
//     sum it is added to are aligned at the largest and cut below its f32
//     ulp.  So a small term never meets a long sum inside one: the scores'
//     hi*hi terms and small terms go into two accumulators from 0 for 4
//     k-steps (32 of hd) and are added in f32, and a chunk's p v starts
//     from 0 and is added to the rescaled context in f32.  One accumulator
//     for all three terms over all of hd, as CUTLASS's 3xTF32 GEMMs keep,
//     missed the f32 tolerance with q and k doubled (scores 4 times larger).
//   * The scores stay in the `mma` accumulators, with the online softmax in
//     registers (exp2 with the scale folded in, as the bf16 body).  An
//     accumulator holds keys 2t and 2t + 1 of an 8-key step where the A
//     fragment of p v wants t and t + 4, so each step's keys are taken in
//     the order 0, 2, 4, 6, 1, 3, 5, 7: p is split where it lies, and B
//     reads v's rows 2t and 2t + 1.
//   * A last chunk of at most 8 live keys runs one 8-key step (S = 513: 16
//     chunks of 32 and one step, not 17 chunks); keys past S are masked to
//     -inf.  The context is divided by the f32 row sums once, at the end.
//
// Above hd 64 the bf16 body takes one block an SM (the consumers' HD / 2
// context accumulators need 232 registers), and its (k, v) ring holds 4
// stages where 227 KB of shared memory hold them beside the q tiles, 2 at
// HD 256; the f32 body keeps 3 stages below HD 128 and 2 from there (one
// block an SM at 256).  Swizzle: 128 bytes where 64 divides HD, 64 at HD 32,
// 32 at HD 80 (boxes of 16 columns).
//
// Layout: q, k, v are (B, H, S, hd) views with unit stride along hd and any
// strides (in elements) along B, H and S; for bf16 the base pointers and
// strides are multiples of 16 bytes (TMA's rule: the wrapper copies a view
// that is not into a buffer whose rows are).  ctx is written (B, S, H, hd)
// contiguous, so that the model's merge of the heads is a view.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <vector>

#include "sm90_common.cuh"
#include "tf32x3.cuh"

namespace {

using namespace sm90;
using namespace tf32x3;

constexpr int ROWS = 64;  // query rows of a tile (wgmma's M)
constexpr int KEYS = 64;  // keys per chunk
constexpr int TAIL = 16;  // the narrow last chunk: wgmma N for its scores, one k-step of p v

struct Strides {  // of a (B, H, S, hd) view, in elements
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// bf16 on wgmma, fed by TMA
// ---------------------------------------------------------------------------

constexpr int CONSUMERS = 2;                  // warpgroups of 64 query rows
constexpr int BLOCK_ROWS = CONSUMERS * ROWS;  // query rows of a block
constexpr int WG_THREADS = 128 * (1 + CONSUMERS);
constexpr int SMEM_MAX = 232448;              // shared-memory bytes a block may use

// The shared-memory tiles of one body's head_dim HD (a head dim rounded up
// to one of K4_HDS below): 64 rows of HD bf16, stored as boxes of one
// swizzle row's width, each 64 rows deep: 64 values with the 128-byte
// swizzle where 64 divides HD, 32 with the 64-byte one at HD 32, 16 with
// the 32-byte one at HD 80.
template <int HD>
struct Tile {
  // bytes of a swizzle row
  static constexpr int SW = HD % 64 == 0 ? 128 : HD == 32 ? 64 : 32;
  static constexpr int BOX_COLS = SW / 2;
  static constexpr int BOXES = HD / BOX_COLS;
  static constexpr int BOX_BYTES = ROWS * SW;
  static constexpr int BYTES = BOXES * BOX_BYTES;  // 64 rows of HD
  static constexpr uint32_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // wgmma's swizzle
  // (k, v) stages in the ring: four, or as many as the shared memory holds
  // beside the q tiles (2 at HD 256)
  static constexpr int STAGES_FIT =
      (SMEM_MAX - 1024 - CONSUMERS * BYTES - 256) / (2 * BYTES);
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static_assert(STAGES >= 2, "the ring needs two stages");
  // Two blocks an SM where the registers allow: above hd 64 the consumers
  // need HD / 2 context and 32 score accumulators (at hd 128 64 + 32, at
  // 256 128 + 32) and take one block an SM.
  static constexpr int BLOCKS_PER_SM = HD <= 64 ? 2 : 1;
  // setmaxnreg: the producer's and the consumers' registers.  A block enters
  // with 65,536 / (384 * BLOCKS_PER_SM) rounded down to 8 (168 or 80); what
  // the producer gives up covers what the two consumers take.
  static constexpr int PRODUCER_REGS = BLOCKS_PER_SM == 1 ? 40 : 24;
  static constexpr int CONSUMER_REGS = BLOCKS_PER_SM == 1 ? 232 : 104;
  static constexpr size_t SMEM =
      1024 + (size_t)(CONSUMERS + 2 * STAGES) * BYTES + (1 + 2 * STAGES) * sizeof(uint64_t);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The position (1..3) of the row, head and batch coordinates in a tensor
// map's dimensions, packed 2 bits each (see `encode_view`).
__device__ __forceinline__ int coord(int order, int pos, int row, int head, int batch) {
  return (order & 3) == pos ? row : ((order >> 2) & 3) == pos ? head : batch;
}

// One box of rows row .. row + 63 of one head, at column col, by TMA into
// `dst`.
__device__ __forceinline__ void load_box(unsigned char* dst, const CUtensorMap* map, int order,
                                         uint64_t* bar, int col, int row, int head, int batch) {
  tma_load_4d(dst, map, bar, col, coord(order, 1, row, head, batch),
              coord(order, 2, row, head, batch), coord(order, 3, row, head, batch));
}

// Rows row .. row + 63 of one head, all hd columns, by TMA into `dst`.
template <int HD>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map, int order,
                                          uint64_t* bar, int row, int head, int batch) {
  using T = Tile<HD>;
#pragma unroll
  for (int x = 0; x < T::BOXES; ++x)
    load_box(dst + x * T::BOX_BYTES, map, order, bar, x * T::BOX_COLS, row, head, batch);
}

// The online softmax of one chunk of NC keys (key0 ..) for this
// warpgroup's 64 query rows, from its scores `sc`, then ctx += p v, v's
// stage in Tile<HD>'s layout.  Accumulator register 4j + 2i + e of
// m64nNk16 holds row 16 * warp + lane / 4 + 8i, column 8j + 2 * (lane % 4)
// + e; this thread's two rows are i = 0, 1.  `last`: keys at or past s are
// masked.
template <int HD, int NC>
__device__ __forceinline__ void softmax_pv(float (&o)[HD / 2], float (&m)[2], float (&l)[2],
                                           float (&sc)[NC / 2], const unsigned char* v_st,
                                           int key0, int s, bool last, float scale_log2) {
  using T = Tile<HD>;
  const int t = threadIdx.x % 4;
  if (last) {
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (key0 + 8 * j + 2 * t + e >= s) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[i] = fmaxf(mx[i], fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
  float corr[2], mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the four lanes of a quad share a row
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // the chunk holds a live key, so the new max is finite; the first
    // chunk's correction is exp(-inf) = 0 on sums that are 0
    const float next = fmaxf(m[i], mx[i]);
    corr[i] = exp2f((m[i] - next) * scale_log2);
    m[i] = next;
    mb[i] = next * scale_log2;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= corr[i];
      o[4 * j + 2 * i + 1] *= corr[i];
    }
  // exp(s / sqrt(hd) - max) = exp2(s * scale_log2 - max * scale_log2)
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + 2 * i + e], scale_log2, -mb[i]));
        sc[4 * j + 2 * i + e] = p;
        l[i] += p;
      }
  // the probabilities as A fragments of the 16-key steps of p v: register r
  // of step kk holds row i = r % 2, keys 16 kk + 8 (r / 2) + 2t + {0, 1},
  // which are score registers 8 kk + 2r and 8 kk + 2r + 1
  uint32_t pa[NC / 16][4];
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

  // ctx += p v: v's stage is row-major (keys, hd), N-major for wgmma: k-steps
  // of 16 keys are 16 swizzle rows apart, 8-key groups SBO apart, and hd's
  // boxes LBO apart
  const uint64_t dv = smem_desc(v_st, T::BOX_BYTES, 8 * T::SW, T::LAYOUT);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) wgmma_rs_tb<HD>(o, pa[kk], dv + ((kk * 16 * T::SW) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// One chunk of NC keys (key0 ..) for this warpgroup's 64 query rows: the
// scores q k^T, then `softmax_pv`.
template <int HD, int NC>
__device__ __forceinline__ void chunk(float (&o)[HD / 2], float (&m)[2], float (&l)[2],
                                      const unsigned char* q_st, const unsigned char* k_st,
                                      const unsigned char* v_st, int key0, int s, bool last,
                                      float scale_log2) {
  using T = Tile<HD>;
  // scores: hd / 16 k-steps of 32 bytes, a box further every BOX_COLS values
  float sc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) sc[i] = 0.f;
  const uint64_t dq = smem_desc(q_st, 16, 8 * T::SW, T::LAYOUT);
  const uint64_t dk = smem_desc(k_st, 16, 8 * T::SW, T::LAYOUT);
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk * 16 / T::BOX_COLS) * T::BOX_BYTES + (kk * 16 % T::BOX_COLS) * 2;
    wgmma<NC>(sc, dq + (off >> 4), dk + (off >> 4));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_pv<HD, NC>(o, m, l, sc, v_st, key0, s, last, scale_log2);
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, Tile<HD>::BLOCKS_PER_SM)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                       int s, int h, int hd, int orders, float scale_log2) {
  using T = Tile<HD>;
  extern __shared__ __align__(16) unsigned char att_smem[];
  // the swizzle atoms (8 rows of 128 bytes) must start 1024-byte aligned
  unsigned char* smem = att_smem + ((1024 - (smem_u32(att_smem) & 1023)) & 1023);
  unsigned char* q_st = smem;                           // [CONSUMERS][BYTES]
  unsigned char* k_st = q_st + CONSUMERS * T::BYTES;    // [STAGES][BYTES]
  unsigned char* v_st = k_st + T::STAGES * T::BYTES;    // [STAGES][BYTES]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_st + T::STAGES * T::BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + T::STAGES;

  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const int row0 = blockIdx.y * BLOCK_ROWS;
  // consumers with a row below s; the last row block of S = 513 has one
  const int live = min(CONSUMERS, (s - row0 + ROWS - 1) / ROWS);
  const int chunks = (s + KEYS - 1) / KEYS;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < T::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], live);  // one arrival from each live consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::PRODUCER_REGS) : "memory");
    if (tid == 0) {
      const int oq = orders & 63, ok = (orders >> 6) & 63, ov = (orders >> 12) & 63;
      mbar_expect_tx(q_full, live * T::BYTES);
      for (int c = 0; c < live; ++c)
        load_rows<HD>(q_st + c * T::BYTES, &map_q, oq, q_full, row0 + c * ROWS, hh, b);
      for (int i = 0; i < chunks; ++i) {
        const int st = i % T::STAGES;
        mbar_wait(&empty[st], ((i / T::STAGES) & 1) ^ 1);  // at once on the first lap
        mbar_expect_tx(&full[st], 2 * T::BYTES);
        load_rows<HD>(k_st + st * T::BYTES, &map_k, ok, &full[st], i * KEYS, hh, b);
        load_rows<HD>(v_st + st * T::BYTES, &map_v, ov, &full[st], i * KEYS, hh, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS) : "memory");
  const int c = wg - 1;
  if (c >= live) return;  // no query row of this warpgroup lies below s
  const int warp = tid / 32, lane = tid % 32;
  const unsigned char* q_mine = q_st + c * T::BYTES;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows i = 0, 1 (raw scores)
  float l[2] = {0.f, 0.f};              // this thread's share of their sums
  mbar_wait(q_full, 0);
  for (int i = 0; i < chunks; ++i) {
    const int st = i % T::STAGES;
    mbar_wait(&full[st], (i / T::STAGES) & 1);
    const unsigned char* kc = k_st + st * T::BYTES;
    const unsigned char* vc = v_st + st * T::BYTES;
    const int key0 = i * KEYS;
    if (i + 1 < chunks)
      chunk<HD, KEYS>(acc, m, l, q_mine, kc, vc, key0, s, false, scale_log2);
    else if (s - key0 <= TAIL)
      chunk<HD, TAIL>(acc, m, l, q_mine, kc, vc, key0, s, true, scale_log2);
    else
      chunk<HD, KEYS>(acc, m, l, q_mine, kc, vc, key0, s, true, scale_log2);
    if (tid == 0) mbar_arrive(&empty[st]);  // both products that read it have retired
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + c * ROWS + 16 * warp + g + 8 * i;
    if (r >= s) continue;
    const float inv = 1.f / l[i];  // each sum holds its max's exp(0) = 1
    // rows of hd values; the columns from hd to HD hold zeros and stay here
    __nv_bfloat16* out = o + (((long long)b * s + r) * h + hh) * hd + 2 * t;
    if (hd % 2 == 0) {  // every column pair lies on 4 bytes
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        if (8 * j + 2 * t < hd)
          *reinterpret_cast<uint32_t*>(out + 8 * j) =
              pack_bf16(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    } else {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * t + e < hd)
            out[8 * j + e] = __float2bfloat16_rn(acc[4 * j + 2 * i + e] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores in 3xTF32
// ---------------------------------------------------------------------------

constexpr int F_WARPS = 4;                 // warps a block, 16 query rows each
constexpr int F_ROWS = 16 * F_WARPS;       // query rows of a block
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int F_KEYS = 32;                 // keys a stage
constexpr int F_TAIL = 8;                  // the narrow last chunk: one n-tile of scores

template <int HD>
struct F32Tile {
  // Rows padded by 4 floats: 16-byte aligned for cp.async, and every
  // fragment read of a warp (q and k at rows g, columns t; v at rows 2t,
  // columns g) falls on 32 distinct banks.
  static constexpr int LD = HD + 4;
  static constexpr int STAGES = HD >= 128 ? 2 : 3;  // (k, v) stages in the ring
  // blocks an SM that the registers must allow: as many as the shared
  // memory does at hd 64 (3 of 70 KB), 2 at hd 80 and 128 (86 and 101 KB),
  // 1 at 256 (200 KB)
  static constexpr int MIN_BLOCKS = HD <= 64 ? 3 : HD <= 128 ? 2 : 1;
  static constexpr int Q_FLOATS = F_ROWS * LD;
  static constexpr int KV_FLOATS = F_KEYS * LD;     // one operand of a stage
  static constexpr size_t SMEM = sizeof(float) * (size_t)(Q_FLOATS + 2 * STAGES * KV_FLOATS);
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + n - 1, columns col0 .. col0 + COLS - 1 of one head's
// (S, hd) view (row r at src + r * ss) into a tile of rows LD floats apart,
// by cp.async (the caller commits and waits); rows at or past s and columns
// at or past hd are zero-filled.  VEC: 16-byte copies (base, row stride, hd
// and col0 multiples of 16 bytes), else 4-byte ones.
template <int LD, int COLS, bool VEC>
__device__ __forceinline__ void load_box_f32(float* tile, const float* __restrict__ src,
                                             long long ss, int row0, int n, int s, int col0,
                                             int hd) {
  constexpr int W = VEC ? 4 : 1;  // floats a copy
#pragma unroll 4
  for (int i = threadIdx.x; i < n * (COLS / W); i += F_THREADS) {
    const int r = i / (COLS / W), c = i % (COLS / W) * W;
    const bool live = row0 + r < s && col0 + c < hd;
    const float* from = live ? src + (row0 + r) * ss + col0 + c : src;
    if constexpr (VEC)
      cp_async16(smem_u32(tile + r * LD + c), from, live);
    else
      cp_async4(smem_u32(tile + r * LD + c), from, live);
  }
}

// All hd columns of rows row0 .. row0 + n - 1 into a padded tile of HD
// columns (`load_box_f32`).
template <int HD, bool VEC>
__device__ __forceinline__ void load_rows_f32(float* tile, const float* __restrict__ src,
                                              long long ss, int row0, int n, int s, int hd) {
  load_box_f32<F32Tile<HD>::LD, HD, VEC>(tile, src, ss, row0, n, s, 0, hd);
}

// The scores of KSTEPS 8-column k-steps for this warp's 16 query rows (q_w,
// its rows of the q tile) against NC keys (kc), both tiles' rows LD floats
// apart, in 3xTF32: each operand split into TF32 hi and lo, and each 16x8x8
// product taken as lo*hi + hi*lo + hi*hi.  An `mma` aligns its terms and
// the sum it adds them to at the largest and drops the bits below that
// one's f32 ulp (truncating), so no `mma` adds into a long sum: the hi*hi
// and small terms go into two accumulators from 0 for every KQ k-steps,
// added into `sc` in f32 (`first`: the first of them sets it).  Accumulator
// register 2i + e of n-tile j holds row g + 8i (g = lane / 4), column 8j +
// 2t + e (t = lane % 4).
template <int LD, int KSTEPS, int NC>
__device__ __forceinline__ void scores_tf32x3(float (&sc)[NC / 8][4], const float* q_w,
                                              const float* kc, bool first) {
  const int lane = threadIdx.x % 32;
  // A = q rows g, g + 8 at columns t, t + 4 of the 8-column k-step; B = k
  // row (key) g at the same columns; both by ldmatrix, A's four tiles rows
  // 0-7 and 8-15 at columns 0-3 and 4-7 of the step, B's two keys' tiles of
  // n-tiles j and j + 1
  const int r8 = lane % 8, tile = lane / 8;
  const float* q_row = q_w + (r8 + 8 * (tile % 2)) * LD + 4 * (tile / 2);
  const float* k_row = kc + (r8 + 8 * (tile / 2)) * LD + 4 * (tile % 2);
  // KQ k-steps at a time, the hi*hi terms into `big` and the lo*hi and
  // hi*lo ones into `small`, both from 0: no small term meets a large sum
  // inside an `mma`, and the scores take one f32 rounding a KQ k-steps (4,
  // or 2 where 4 do not divide KSTEPS: hd 80)
  constexpr int KQ = KSTEPS % 4 == 0 ? 4 : 2;
#pragma unroll 1
  for (int kq = 0; kq < KSTEPS; kq += KQ) {
    float big[NC / 8][4], small[NC / 8][4];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[j][e] = small[j][e] = 0.f;
#pragma unroll
    for (int kk = kq; kk < kq + KQ; ++kk) {
      uint32_t qa[4], ah[4], al[4];
      ldmatrix_x4(qa, q_row + 8 * kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(qa[i], ah[i], al[i]);
      uint32_t bh[NC / 8][2], bl[NC / 8][2];
#pragma unroll
      for (int j = 0; j < NC / 8; j += 2) {
        uint32_t kb[4];
        if (j + 1 < NC / 8) {
          ldmatrix_x4(kb, k_row + 8 * j * LD + 8 * kk);
        } else {  // the one n-tile of the narrow tail: its two tiles, twice
          ldmatrix_x4(kb, kc + (r8 + 8 * j) * LD + 4 * (tile % 2) + 8 * kk);
        }
#pragma unroll
        for (int i = 0; i < 4 && j + i / 2 < NC / 8; ++i)
          split_tf32(kb[i], bh[j + i / 2][i % 2], bl[j + i / 2][i % 2]);
      }
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) mma_tf32(small[j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) mma_tf32(small[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) mma_tf32(big[j], ah, bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = first && kq == 0 ? big[j][e] + small[j][e]
                                    : sc[j][e] + (big[j][e] + small[j][e]);
  }
}

// The online softmax of one chunk of NC keys (key0 ..) for this warp's 16
// query rows, from its scores `sc`, then ctx += p v in 3xTF32, v's stage
// rows F32Tile<HD>::LD floats apart: each chunk's p v (lo*hi, hi*lo, hi*hi
// a k-step) starts from 0 and is added to the rescaled context in f32 (one
// FMA).  `last`: keys at or past s are masked.
template <int HD, int NC>
__device__ __forceinline__ void softmax_pv_tf32x3(float (&o)[HD / 8][4], float (&m)[2],
                                                  float (&l)[2], float (&sc)[NC / 8][4],
                                                  const float* vc, int key0, int s, bool last,
                                                  float scale_log2) {
  constexpr int LD = F32Tile<HD>::LD;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if (last) {
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (key0 + 8 * j + 2 * t + e >= s) sc[j][e] = sc[j][2 + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[i] = fmaxf(mx[i], fmaxf(sc[j][2 * i], sc[j][2 * i + 1]));
  float corr[2], mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the four lanes of a quad share a row
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // the chunk holds a live key, so the new max is finite; the first
    // chunk's correction is exp(-inf) = 0 on sums that are 0
    const float next = fmaxf(m[i], mx[i]);
    corr[i] = exp2f((m[i] - next) * scale_log2);
    m[i] = next;
    mb[i] = next * scale_log2;
    l[i] *= corr[i];
  }
  // exp(s / sqrt(hd) - max) = exp2(s * scale_log2 - max * scale_log2)
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(sc[j][e], scale_log2, -mb[e / 2]));
      sc[j][e] = p;
      l[e / 2] += p;
    }

  // pv = p v, 8 keys a k-step.  The A fragment wants columns t and t + 4 of
  // the step where the scores' accumulators hold keys 2t and 2t + 1, so the
  // step's keys are taken in the order 0, 2, 4, 6, 1, 3, 5, 7: p stays in
  // the registers it was computed in, and B reads v's rows 2t and 2t + 1
  // (column g of each 8-column n-tile).
  // in column groups of PVN n-tiles, so that pv and the context (HD / 2
  // registers) fit beside the rest from hd 128 (at 256, 128 context
  // registers, two n-tiles a group: four spilled 8 bytes)
  constexpr int PVN = HD >= 256 ? 2 : HD >= 128 ? 4 : HD / 8;
#pragma unroll
  for (int n0 = 0; n0 < HD / 8; n0 += PVN) {
    float pv[PVN][4];
#pragma unroll
    for (int n = 0; n < PVN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NC / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(sc[kk][0], ah[0], al[0]);
      split_tf32(sc[kk][2], ah[1], al[1]);
      split_tf32(sc[kk][1], ah[2], al[2]);
      split_tf32(sc[kk][3], ah[3], al[3]);
      const float* vb = vc + (8 * kk + 2 * t) * LD + 8 * n0 + g;
      // n-tiles whose B fragments are held at once: 2 where 4 do not divide
      // PVN (hd 80, 256)
      constexpr int G = PVN % 4 == 0 ? 4 : 2;
#pragma unroll
      for (int n1 = 0; n1 < PVN; n1 += G) {
        uint32_t bh[G][2], bl[G][2];
#pragma unroll
        for (int n = 0; n < G; ++n) {
          split_tf32(vb[8 * (n1 + n)], bh[n][0], bl[n][0]);
          split_tf32(vb[LD + 8 * (n1 + n)], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < G; ++n) mma_tf32(pv[n1 + n], al, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < G; ++n) mma_tf32(pv[n1 + n], ah, bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < G; ++n) mma_tf32(pv[n1 + n], ah, bh[n][0], bh[n][1]);
      }
    }
    // ctx = ctx * corr + p v
#pragma unroll
    for (int n = 0; n < PVN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n0 + n][e] = fmaf(o[n0 + n][e], corr[e / 2], pv[n][e]);
  }
}

// One chunk of NC keys (key0 ..) for this warp's 16 query rows (q_w, its
// rows of the q tile): the scores over all of HD (`scores_tf32x3`), then
// `softmax_pv_tf32x3`.
template <int HD, int NC>
__device__ __forceinline__ void chunk_tf32x3(float (&o)[HD / 8][4], float (&m)[2], float (&l)[2],
                                             const float* q_w, const float* kc, const float* vc,
                                             int key0, int s, bool last, float scale_log2) {
  float sc[NC / 8][4];
  scores_tf32x3<F32Tile<HD>::LD, HD / 8, NC>(sc, q_w, kc, true);
  softmax_pv_tf32x3<HD, NC>(o, m, l, sc, vc, key0, s, last, scale_log2);
}

template <int HD, bool VEC>
__global__ void __launch_bounds__(F_THREADS, F32Tile<HD>::MIN_BLOCKS)
attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, int s, int h, int hd,
                        Strides qs, Strides ks, Strides vs, float scale_log2) {
  using T = F32Tile<HD>;
  extern __shared__ __align__(16) float f32_smem[];
  float* q_st = f32_smem;                        // [F_ROWS][LD]
  float* k_st = q_st + T::Q_FLOATS;              // [STAGES][F_KEYS][LD]
  float* v_st = k_st + T::STAGES * T::KV_FLOATS; // [STAGES][F_KEYS][LD]

  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const int row0 = blockIdx.y * F_ROWS;
  const int chunks = (s + F_KEYS - 1) / F_KEYS;
  q += b * qs.b + hh * qs.h;
  k += b * ks.b + hh * ks.h;
  v += b * vs.b + hh * vs.h;

  // the ring: q with the first stage in one group, then one group a stage,
  // committed even when empty so that group i is always stage i's
  load_rows_f32<HD, VEC>(q_st, q, qs.s, row0, F_ROWS, s, hd);
#pragma unroll
  for (int i = 0; i < T::STAGES - 1; ++i) {
    if (i < chunks) {
      load_rows_f32<HD, VEC>(k_st + i * T::KV_FLOATS, k, ks.s, i * F_KEYS, F_KEYS, s, hd);
      load_rows_f32<HD, VEC>(v_st + i * T::KV_FLOATS, v, vs.s, i * F_KEYS, F_KEYS, s, hd);
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool live = row0 + 16 * warp < s;  // a query row of this warp lies below s
  const float* q_w = q_st + 16 * warp * T::LD;
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (raw scores)
  float l[2] = {0.f, 0.f};              // this thread's share of their sums

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<T::STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();                 // everyone's have, and chunk c - 1 is done with
    const int next = c + T::STAGES - 1, nst = next % T::STAGES;
    if (next < chunks) {
      load_rows_f32<HD, VEC>(k_st + nst * T::KV_FLOATS, k, ks.s, next * F_KEYS, F_KEYS, s, hd);
      load_rows_f32<HD, VEC>(v_st + nst * T::KV_FLOATS, v, vs.s, next * F_KEYS, F_KEYS, s, hd);
    }
    cp_async_commit();
    if (!live) continue;
    const float* kc = k_st + (c % T::STAGES) * T::KV_FLOATS;
    const float* vc = v_st + (c % T::STAGES) * T::KV_FLOATS;
    const int key0 = c * F_KEYS;
    if (c + 1 < chunks)
      chunk_tf32x3<HD, F_KEYS>(acc, m, l, q_w, kc, vc, key0, s, false, scale_log2);
    else if (s - key0 <= F_TAIL)
      chunk_tf32x3<HD, F_TAIL>(acc, m, l, q_w, kc, vc, key0, s, true, scale_log2);
    else
      chunk_tf32x3<HD, F_KEYS>(acc, m, l, q_w, kc, vc, key0, s, true, scale_log2);
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (!live) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * warp + g + 8 * i;
    if (r >= s) continue;
    const float inv = 1.f / l[i];  // each sum holds its max's exp(0) = 1
    // rows of hd values; the columns from hd to HD hold zeros and stay here
    float* out = o + (((long long)b * s + r) * h + hh) * hd + 2 * t;
    if (hd % 2 == 0) {  // every column pair lies on 8 bytes
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        if (8 * n + 2 * t < hd)
          *reinterpret_cast<float2*>(out + 8 * n) =
              make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    } else {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * n + 2 * t + e < hd) out[8 * n + e] = acc[n][2 * i + e] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// Above head_dim 256: the context's columns in slices
// ---------------------------------------------------------------------------
//
// A head_dim above 256 (K4_HDS' last) runs on the sliced bodies: the grid
// gives each (volume, head) ceil(hd / 256) blocks a row block, one a slice
// of 256 context columns, so that a consumer's context stays at the 128
// accumulators a thread of the 256 body (wgmma's widest N), and no q tile
// is held whole (at hd 512 a 64-row tile is 64 KB in bf16, 128 KB in f32).
// Every slice walks the same chunks of keys and computes the whole scores
// q k^T of each chunk, their 64-column boxes of hd staged one after another
// in the ring (q's and k's boxes together), then the online softmax and
// its slice's p v: the slices compute the same scores and softmax in the
// same order, so their columns agree, and each recomputes the scores (at
// hd 512, 2 slices: the first product twice; 3 products of S^2 hd where an
// unsliced body would take 2).  Columns past hd load as zeros (TMA's zero
// fill, zero-filled cp.async copies), so they add nothing to q k^T; the
// scale is 1 / sqrt(hd) of the true hd.  The last chunk's keys past S are
// masked, as in the unsliced bodies; no narrow tail chunk.
constexpr int SLICE = 256;  // context columns a block of the sliced bodies computes

// bf16: the wgmma body's three warpgroups (a producer, two consumers of 64
// query rows) on one ring of 32 KB stages: a chunk's `boxes` = ceil(hd / 64)
// score stages, each q's 64 x 64 box of both consumers and k's, then one v
// stage, its slice's four 64 x 64 boxes (Tile<256>'s layout, the ones that
// hold a column below hd loaded).  128-byte swizzle throughout.
constexpr int SL_BOX = ROWS * 128;                 // a 64 x 64 bf16 box
constexpr int SL_STAGE = (SLICE / 64) * SL_BOX;    // 32 KB
constexpr int SL_STAGES = (SMEM_MAX - 1024 - 256) / SL_STAGE;
constexpr size_t SL_SMEM = 1024 + (size_t)SL_STAGES * SL_STAGE + 2 * SL_STAGES * sizeof(uint64_t);
static_assert(SL_STAGES >= 2 && (CONSUMERS + 1) * SL_BOX <= SL_STAGE && SL_SMEM <= SMEM_MAX,
              "the sliced ring");

__global__ void __launch_bounds__(WG_THREADS, 1)
attention_sliced_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              __nv_bfloat16* __restrict__ o, int s, int h, int hd, int slices,
                              int orders, float scale_log2) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  unsigned char* ring = att_smem + ((1024 - (smem_u32(att_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + SL_STAGES * SL_STAGE);
  uint64_t* empty = full + SL_STAGES;

  const int bh = blockIdx.x / slices, col0 = blockIdx.x % slices * SLICE;
  const int b = bh / h, hh = bh % h;
  const int row0 = blockIdx.y * BLOCK_ROWS;
  const int live = min(CONSUMERS, (s - row0 + ROWS - 1) / ROWS);
  const int chunks = (s + KEYS - 1) / KEYS;
  const int boxes = (hd + 63) / 64;                        // score stages a chunk
  const int v_boxes = min(SLICE / 64, (hd - col0 + 63) / 64);  // v's boxes below hd
  const int stages = chunks * (boxes + 1);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < SL_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], live);  // one arrival from each live consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const int oq = orders & 63, ok = (orders >> 6) & 63, ov = (orders >> 12) & 63;
      for (int i = 0; i < stages; ++i) {
        const int st = i % SL_STAGES, c = i / (boxes + 1), x = i % (boxes + 1);
        unsigned char* dst = ring + st * SL_STAGE;
        mbar_wait(&empty[st], ((i / SL_STAGES) & 1) ^ 1);  // at once on the first lap
        if (x < boxes) {
          mbar_expect_tx(&full[st], (live + 1) * SL_BOX);
          for (int q = 0; q < live; ++q)
            load_box(dst + q * SL_BOX, &map_q, oq, &full[st], 64 * x, row0 + q * ROWS, hh, b);
          load_box(dst + CONSUMERS * SL_BOX, &map_k, ok, &full[st], 64 * x, c * KEYS, hh, b);
        } else {
          mbar_expect_tx(&full[st], v_boxes * SL_BOX);
          for (int j = 0; j < v_boxes; ++j)
            load_box(dst + j * SL_BOX, &map_v, ov, &full[st], col0 + 64 * j, c * KEYS, hh, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;
  if (c >= live) return;  // no query row of this warpgroup lies below s
  const int warp = tid / 32, lane = tid % 32;
  float acc[SLICE / 2];
#pragma unroll
  for (int i = 0; i < SLICE / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int ch = 0, i = 0; ch < chunks; ++ch) {
    float sc[KEYS / 2];
#pragma unroll
    for (int j = 0; j < KEYS / 2; ++j) sc[j] = 0.f;
    for (int x = 0; x < boxes; ++x, ++i) {
      const int st = i % SL_STAGES;
      mbar_wait(&full[st], (i / SL_STAGES) & 1);
      const unsigned char* stage = ring + st * SL_STAGE;
      const uint64_t dq = smem_desc(stage + c * SL_BOX, 16, 1024, 1);
      const uint64_t dk = smem_desc(stage + CONSUMERS * SL_BOX, 16, 1024, 1);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma<KEYS>(sc, dq + 2 * kk, dk + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (tid == 0) mbar_arrive(&empty[st]);
    }
    const int st = i % SL_STAGES;
    mbar_wait(&full[st], (i / SL_STAGES) & 1);
    softmax_pv<SLICE, KEYS>(acc, m, l, sc, ring + st * SL_STAGE, ch * KEYS, s, ch + 1 == chunks,
                            scale_log2);
    if (tid == 0) mbar_arrive(&empty[st]);
    ++i;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + c * ROWS + 16 * warp + g + 8 * i;
    if (r >= s) continue;
    const float inv = 1.f / l[i];
    // this slice's columns below hd
    __nv_bfloat16* out = o + (((long long)b * s + r) * h + hh) * hd + col0 + 2 * t;
    if (hd % 2 == 0) {
#pragma unroll
      for (int j = 0; j < SLICE / 8; ++j)
        if (col0 + 8 * j + 2 * t < hd)
          *reinterpret_cast<uint32_t*>(out + 8 * j) =
              pack_bf16(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    } else {
#pragma unroll
      for (int j = 0; j < SLICE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col0 + 8 * j + 2 * t + e < hd)
            out[8 * j + e] = __float2bfloat16_rn(acc[4 * j + 2 * i + e] * inv);
    }
  }
}

// f32: the 3xTF32 body's four warps of 16 query rows on a cp.async ring of
// SF_STAGES stages: a chunk's `boxes` score stages, each q's 64 x 64 box and
// k's 32 x 64, rows padded by 4 floats, then one v stage, its slice's 32 x
// 256 (F32Tile<256>'s rows).  One __syncthreads a stage.  Three stages (100
// KB) let two blocks share an SM (255 registers a thread): with four (133
// KB, one block an SM) the body took 1.28 ms at (1, 24, 513, 512), with
// three 0.61, SDPA (its efficient backend) 0.36-0.52 (`chip_smoke.py`
// phase `widest`, NVIDIA H100 80GB HBM3 at 700 W).
constexpr int SF_LD = 64 + 4;  // a score box's rows
constexpr int SF_Q = F_ROWS * SF_LD;
constexpr int SF_K = F_KEYS * SF_LD;
constexpr int SF_V = F_KEYS * F32Tile<SLICE>::LD;
constexpr int SF_STAGE = SF_Q + SF_K > SF_V ? SF_Q + SF_K : SF_V;  // floats
constexpr int SF_STAGES = 3;
constexpr size_t SF_SMEM = sizeof(float) * (size_t)SF_STAGES * SF_STAGE;

template <bool VEC>
__global__ void __launch_bounds__(F_THREADS, 2)
attention_sliced_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ o, int s, int h,
                               int hd, int slices, Strides qs, Strides ks, Strides vs,
                               float scale_log2) {
  extern __shared__ __align__(16) float f32_smem[];
  const int bh = blockIdx.x / slices, col0 = blockIdx.x % slices * SLICE;
  const int b = bh / h, hh = bh % h;
  const int row0 = blockIdx.y * F_ROWS;
  const int chunks = (s + F_KEYS - 1) / F_KEYS;
  const int boxes = (hd + 63) / 64;
  const int stages = chunks * (boxes + 1);
  q += b * qs.b + hh * qs.h;
  k += b * ks.b + hh * ks.h;
  v += b * vs.b + hh * vs.h;

  // stage i's copies, one commit group a stage (committed even when empty,
  // so that group i is always stage i's)
  const auto load = [&](int i) {
    float* st = f32_smem + i % SF_STAGES * SF_STAGE;
    const int c = i / (boxes + 1), x = i % (boxes + 1);
    if (x < boxes) {
      load_box_f32<SF_LD, 64, VEC>(st, q, qs.s, row0, F_ROWS, s, 64 * x, hd);
      load_box_f32<SF_LD, 64, VEC>(st + SF_Q, k, ks.s, c * F_KEYS, F_KEYS, s, 64 * x, hd);
    } else {
      load_box_f32<F32Tile<SLICE>::LD, SLICE, VEC>(st, v, vs.s, c * F_KEYS, F_KEYS, s, col0, hd);
    }
  };
#pragma unroll 1
  for (int i = 0; i < SF_STAGES - 1; ++i) {
    if (i < stages) load(i);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool live = row0 + 16 * warp < s;  // a query row of this warp lies below s
  float acc[SLICE / 8][4];
#pragma unroll
  for (int n = 0; n < SLICE / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float sc[F_KEYS / 8][4];

  for (int i = 0; i < stages; ++i) {
    cp_async_wait<SF_STAGES - 2>();  // this thread's copies of stage i have landed
    __syncthreads();                 // everyone's have, and stage i - 1 is done with
    if (i + SF_STAGES - 1 < stages) load(i + SF_STAGES - 1);
    cp_async_commit();
    if (!live) continue;
    const float* st = f32_smem + i % SF_STAGES * SF_STAGE;
    const int c = i / (boxes + 1), x = i % (boxes + 1);
    if (x < boxes)
      scores_tf32x3<SF_LD, 8, F_KEYS>(sc, st + 16 * warp * SF_LD, st + SF_Q, x == 0);
    else
      softmax_pv_tf32x3<SLICE, F_KEYS>(acc, m, l, sc, st, c * F_KEYS, s, c + 1 == chunks,
                                       scale_log2);
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (!live) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * warp + g + 8 * i;
    if (r >= s) continue;
    const float inv = 1.f / l[i];
    float* out = o + (((long long)b * s + r) * h + hh) * hd + col0 + 2 * t;
    if (hd % 2 == 0) {
#pragma unroll
      for (int n = 0; n < SLICE / 8; ++n)
        if (col0 + 8 * n + 2 * t < hd)
          *reinterpret_cast<float2*>(out + 8 * n) =
              make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    } else {
#pragma unroll
      for (int n = 0; n < SLICE / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col0 + 8 * n + 2 * t + e < hd) out[8 * n + e] = acc[n][2 * i + e] * inv;
    }
  }
}

// The map of one (B, H, S, hd) bf16 view: hd innermost, then S, H and B in
// the order of their strides (smallest first), boxes of one swizzle row's
// width by 64 rows of S; rows past S, and the columns from hd to the body's
// HD, load as zeros, so that the padded columns add nothing to q k^T and
// give context columns that are never stored.  `order` gets the positions of
// the row, head and batch coordinates (see `coord`).  TMA needs a 16-byte
// aligned base and strides that are multiples of 16 bytes.
template <int HD>
bool encode_view(CUtensorMap* map, int* order, const void* base, int b, int h, int s, int hd,
                 Strides st) {
  using T = Tile<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  struct Dim {
    long long size, stride;
    int which;  // 0 row, 1 head, 2 batch
  } d[3] = {{s, st.s, 0}, {h, st.h, 1}, {b, st.b, 2}};
  for (int i = 1; i < 3; ++i)  // by stride, ascending
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim x = d[j];
      d[j] = d[j - 1];
      d[j - 1] = x;
    }
  cuuint64_t dims[4] = {(cuuint64_t)hd, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)T::BOX_COLS, 1, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  *order = 0;
  for (int i = 0; i < 3; ++i) {
    if (d[i].stride < 0 || d[i].stride % 8 != 0) return false;
    dims[i + 1] = (cuuint64_t)d[i].size;
    strides[i] = (cuuint64_t)d[i].stride * 2;
    if (d[i].which == 0) box[i + 1] = ROWS;
    *order |= (i + 1) << (2 * d[i].which);
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bodies of this file, by the code `attention_last_body` reports.
enum Body {
  BF16_WGMMA = 0,
  F32_TF32X3 = 1,
  F32_TF32X3_4BYTE = 2,
  BF16_SLICED_WGMMA = 3,
  F32_SLICED_TF32X3 = 4,
  F32_SLICED_TF32X3_4BYTE = 5
};
std::atomic<int> last_body{-1};

// The bf16 body's shared-memory limit, raised once a device.
template <int HD>
cudaError_t wgmma_ready(int device) {
  static std::atomic<unsigned long long> smem_set{0};  // one bit a device
  return raise_smem_limit_once((const void*)attention_wgmma_kernel<HD>, (int)Tile<HD>::SMEM,
                               device, smem_set);
}

template <int HD>
cudaError_t launch_wgmma(int device, const void* q, const void* k, const void* v, void* o,
                         int b, int h, int s, int hd, Strides qs, Strides ks, Strides vs,
                         float scale, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  int oq, ok, ov;
  if (!encode_view<HD>(&map_q, &oq, q, b, h, s, hd, qs) ||
      !encode_view<HD>(&map_k, &ok, k, b, h, s, hd, ks) ||
      !encode_view<HD>(&map_v, &ov, v, b, h, s, hd, vs))
    return cudaErrorInvalidValue;
  const cudaError_t err = wgmma_ready<HD>(device);
  if (err != cudaSuccess) return err;
  last_body.store(BF16_WGMMA, std::memory_order_relaxed);
  const dim3 grid(b * h, (s + BLOCK_ROWS - 1) / BLOCK_ROWS);
  attention_wgmma_kernel<HD><<<grid, WG_THREADS, Tile<HD>::SMEM, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), s, h, hd,
      oq | (ok << 6) | (ov << 12), scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The f32 body's shared-memory limit, raised once a device.
template <int HD, bool VEC>
cudaError_t tf32x3_ready(int device) {
  static std::atomic<unsigned long long> smem_set{0};  // one bit a device
  return raise_smem_limit_once((const void*)attention_tf32x3_kernel<HD, VEC>,
                               (int)F32Tile<HD>::SMEM, device, smem_set);
}

template <int HD, bool VEC>
cudaError_t launch_tf32x3_as(int device, const void* q, const void* k, const void* v, void* o,
                             int b, int h, int s, int hd, Strides qs, Strides ks, Strides vs,
                             float scale, cudaStream_t stream) {
  const cudaError_t err = tf32x3_ready<HD, VEC>(device);
  if (err != cudaSuccess) return err;
  last_body.store(VEC ? F32_TF32X3 : F32_TF32X3_4BYTE, std::memory_order_relaxed);
  const dim3 grid(b * h, (s + F_ROWS - 1) / F_ROWS);
  attention_tf32x3_kernel<HD, VEC><<<grid, F_THREADS, F32Tile<HD>::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, h, hd, qs, ks, vs, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// A view whose rows of hd values cp.async may copy 16 bytes at a time.
bool rows_16b(const void* base, int hd, Strides st) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && hd % 4 == 0 && st.b % 4 == 0 &&
         st.h % 4 == 0 && st.s % 4 == 0;
}

template <int HD>
cudaError_t launch_tf32x3(int device, const void* q, const void* k, const void* v, void* o,
                          int b, int h, int s, int hd, Strides qs, Strides ks, Strides vs,
                          float scale, cudaStream_t stream) {
  if (rows_16b(q, hd, qs) && rows_16b(k, hd, ks) && rows_16b(v, hd, vs))
    return launch_tf32x3_as<HD, true>(device, q, k, v, o, b, h, s, hd, qs, ks, vs, scale,
                                      stream);
  return launch_tf32x3_as<HD, false>(device, q, k, v, o, b, h, s, hd, qs, ks, vs, scale, stream);
}

// The sliced bodies' blocks of one (volume, head) and row block.
int slices_of(int hd) { return (hd + SLICE - 1) / SLICE; }

// The sliced bodies' shared-memory limits, raised once a device.
cudaError_t sliced_wgmma_ready(int device) {
  static std::atomic<unsigned long long> smem_set{0};  // one bit a device
  return raise_smem_limit_once((const void*)attention_sliced_wgmma_kernel, (int)SL_SMEM, device,
                               smem_set);
}

template <bool VEC>
cudaError_t sliced_tf32x3_ready(int device) {
  static std::atomic<unsigned long long> smem_set{0};  // one bit a device
  return raise_smem_limit_once((const void*)attention_sliced_tf32x3_kernel<VEC>, (int)SF_SMEM,
                               device, smem_set);
}

// The sliced bf16 body: the maps of the wgmma body's HD 256 (boxes of 64
// columns by 64 rows, 128-byte swizzle), a block a (volume, head, slice) and
// 128 query rows.
cudaError_t launch_sliced_wgmma(int device, const void* q, const void* k, const void* v, void* o,
                                int b, int h, int s, int hd, Strides qs, Strides ks, Strides vs,
                                float scale, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  int oq, ok, ov;
  if (!encode_view<SLICE>(&map_q, &oq, q, b, h, s, hd, qs) ||
      !encode_view<SLICE>(&map_k, &ok, k, b, h, s, hd, ks) ||
      !encode_view<SLICE>(&map_v, &ov, v, b, h, s, hd, vs))
    return cudaErrorInvalidValue;
  const cudaError_t err = sliced_wgmma_ready(device);
  if (err != cudaSuccess) return err;
  last_body.store(BF16_SLICED_WGMMA, std::memory_order_relaxed);
  const int slices = slices_of(hd);
  const dim3 grid(b * h * slices, (s + BLOCK_ROWS - 1) / BLOCK_ROWS);
  attention_sliced_wgmma_kernel<<<grid, WG_THREADS, SL_SMEM, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), s, h, hd, slices,
      oq | (ok << 6) | (ov << 12), scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The sliced f32 body: a block a (volume, head, slice) and 64 query rows,
// 16-byte copies where the views allow them.
cudaError_t launch_sliced_tf32x3(int device, const void* q, const void* k, const void* v, void* o,
                                 int b, int h, int s, int hd, Strides qs, Strides ks, Strides vs,
                                 float scale, cudaStream_t stream) {
  const bool vec = rows_16b(q, hd, qs) && rows_16b(k, hd, ks) && rows_16b(v, hd, vs);
  const cudaError_t err = vec ? sliced_tf32x3_ready<true>(device) : sliced_tf32x3_ready<false>(device);
  if (err != cudaSuccess) return err;
  last_body.store(vec ? F32_SLICED_TF32X3 : F32_SLICED_TF32X3_4BYTE, std::memory_order_relaxed);
  const int slices = slices_of(hd);
  const dim3 grid(b * h * slices, (s + F_ROWS - 1) / F_ROWS);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (vec)
    attention_sliced_tf32x3_kernel<true><<<grid, F_THREADS, SF_SMEM, stream>>>(
        qf, kf, vf, of, s, h, hd, slices, qs, ks, vs, scale_log2);
  else
    attention_sliced_tf32x3_kernel<false><<<grid, F_THREADS, SF_SMEM, stream>>>(
        qf, kf, vf, of, s, h, hd, slices, qs, ks, vs, scale_log2);
  return cudaGetLastError();
}

// The head dims the unsliced bodies are built for: a head_dim from 17 to 256
// runs on the first at or above it, its columns past hd zero in shared
// memory; every head_dim above 256 on the sliced bodies.
constexpr int K4_HDS[] = {32, 64, 80, 128, 256};
constexpr int MAX_UNSLICED_HD = 256;

// The unsliced body's HD for head_dim hd, or 0 outside 17 .. 256.
int body_hd(int hd) {
  if (hd <= 16) return 0;
  for (const int b : K4_HDS)
    if (hd <= b) return b;
  return 0;
}

// Query tiles on the busiest SM if every tile takes as long: blocks in the
// grid's order (x the head, y the row block, so every head's last row block,
// fuller or not, comes last), each wave of `slots` blocks one a slot, slot i
// on SM i % sms; a block holds `full` tiles but a head's last, which holds
// `last`.
int busiest_sm(long long bh, int row_blocks, int full, int last, long long slots, int sms) {
  std::vector<int> load(sms > 0 ? sms : 1, 0);
  for (long long i = 0; i < bh * row_blocks && slots > 0; ++i)
    load[(i % slots) % sms] += i / bh < row_blocks - 1 ? full : last;
  return *std::max_element(load.begin(), load.end());
}

// The bf16 body's tiles and waves at one shape (see the note at the top).
template <int HD>
cudaError_t plan_bf16(int device, int b, int h, int s, int* out) {
  using T = Tile<HD>;
  cudaError_t err = wgmma_ready<HD>(device);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attention_wgmma_kernel<HD>,
                                                      WG_THREADS, T::SMEM);
  if (err != cudaSuccess) return err;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, attention_wgmma_kernel<HD>);
  if (err != cudaSuccess) return err;
  const long long bh = (long long)b * h;
  const int row_blocks = (s + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int tiles = (s + ROWS - 1) / ROWS;  // warpgroup tiles a head
  const int chunks = (s + KEYS - 1) / KEYS;
  const int last = s - (chunks - 1) * KEYS;
  out[0] = BLOCK_ROWS;
  out[1] = WG_THREADS;
  out[2] = (int)T::SMEM;
  out[3] = attr.numRegs;
  out[4] = per_sm;
  out[5] = sms;
  out[6] = (int)(bh * row_blocks);             // blocks
  out[7] = (int)(bh * tiles);                  // warpgroup tiles
  out[8] = (int)(bh * (tiles % CONSUMERS ? 1 : 0));  // blocks with one live tile
  out[9] = 4 * (chunks - 1) + (last <= TAIL ? 1 : 4);  // 16-key steps a tile
  out[10] = busiest_sm(bh, row_blocks, CONSUMERS, tiles - (row_blocks - 1) * CONSUMERS,
                       (long long)per_sm * sms, sms);
  return cudaSuccess;
}

// The sliced bodies' tiles and waves: the unsliced bodies' reckoning with a
// block a (volume, head, slice) and row block, and key steps a tile over
// the scores' boxes and v's slice.
cudaError_t plan_sliced(int device, int b, int h, int s, int hd, int dtype, int* out) {
  const bool bf16 = dtype == 1;
  const void* kernel = bf16 ? (const void*)attention_sliced_wgmma_kernel
                            : (const void*)attention_sliced_tf32x3_kernel<true>;
  const int threads = bf16 ? WG_THREADS : F_THREADS;
  const size_t smem = bf16 ? SL_SMEM : SF_SMEM;
  cudaError_t err = bf16 ? sliced_wgmma_ready(device) : sliced_tf32x3_ready<true>(device);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const long long units = (long long)b * h * slices_of(hd);  // grid x
  const int rows = bf16 ? BLOCK_ROWS : F_ROWS, tile = bf16 ? ROWS : 16;
  const int per_block = rows / tile, keys = bf16 ? KEYS : F_KEYS, step = bf16 ? 16 : 8;
  const int row_blocks = (s + rows - 1) / rows;
  const int tiles = (s + tile - 1) / tile;
  const int chunks = (s + keys - 1) / keys;
  out[0] = rows;
  out[1] = threads;
  out[2] = (int)smem;
  out[3] = attr.numRegs;
  out[4] = per_sm;
  out[5] = sms;
  out[6] = (int)(units * row_blocks);
  out[7] = (int)(units * tiles);
  out[8] = (int)(units * (tiles % per_block ? 1 : 0));
  // a chunk's key steps in each box of the scores and in the slice's p v
  out[9] = chunks * (keys / step) * ((hd + 63) / 64 + 1);
  out[10] = busiest_sm(units, row_blocks, per_block, tiles - (row_blocks - 1) * per_block,
                       (long long)per_sm * sms, sms);
  return cudaSuccess;
}

// The f32 body's: warp tiles of 16 query rows, F_WARPS a block.
template <int HD>
cudaError_t plan_f32(int device, int b, int h, int s, int* out) {
  using T = F32Tile<HD>;
  cudaError_t err = tf32x3_ready<HD, true>(device);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, attention_tf32x3_kernel<HD, true>, F_THREADS, T::SMEM);
  if (err != cudaSuccess) return err;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, attention_tf32x3_kernel<HD, true>);
  if (err != cudaSuccess) return err;
  const long long bh = (long long)b * h;
  const int row_blocks = (s + F_ROWS - 1) / F_ROWS;
  const int tiles = (s + 15) / 16;  // warp tiles a head
  const int chunks = (s + F_KEYS - 1) / F_KEYS;
  const int last = s - (chunks - 1) * F_KEYS;
  out[0] = F_ROWS;
  out[1] = F_THREADS;
  out[2] = (int)T::SMEM;
  out[3] = attr.numRegs;
  out[4] = per_sm;
  out[5] = sms;
  out[6] = (int)(bh * row_blocks);             // blocks
  out[7] = (int)(bh * tiles);                  // warp tiles
  out[8] = (int)(bh * (tiles % F_WARPS ? 1 : 0));  // blocks with an idle warp
  out[9] = F_KEYS / 8 * (chunks - 1) + (last <= F_TAIL ? 1 : F_KEYS / 8);  // 8-key steps a tile
  out[10] = busiest_sm(bh, row_blocks, F_WARPS, tiles - (row_blocks - 1) * F_WARPS,
                       (long long)per_sm * sms, sms);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v: (b, h, s, hd) views with unit
// stride along hd (17 <= hd <= 256 on the body of `body_hd(hd)`, any hd
// above on the sliced bodies) and the given strides (elements) along b, h
// and s; o is (b, s, h, hd) contiguous.  Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for a head_dim below
// 17, a layout the bf16 bodies' tensor maps refuse, or a grid of 2^31
// blocks along x (nothing launched).  b * h == 0 or s == 0 launches
// nothing.
extern "C" int attention_launch(int device, const void* q, const void* k, const void* v,
                                void* o, int b, int h, int s, int hd, long long q_b,
                                long long q_h, long long q_s, long long k_b, long long k_h,
                                long long k_s, long long v_b, long long v_h, long long v_s,
                                float scale, int dtype, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b == 0 || h == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_b, q_h, q_s}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s};
#define CASE(HD)                                                                              \
  case HD:                                                                                    \
    return (int)(dtype == 1                                                                   \
                     ? launch_wgmma<HD>(device, q, k, v, o, b, h, s, hd, qs, ks, vs, scale,   \
                                        st)                                                   \
                     : launch_tf32x3<HD>(device, q, k, v, o, b, h, s, hd, qs, ks, vs, scale,  \
                                         st));
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (hd > MAX_UNSLICED_HD) {
    if ((long long)b * h * slices_of(hd) >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    return (int)(dtype == 1
                     ? launch_sliced_wgmma(device, q, k, v, o, b, h, s, hd, qs, ks, vs, scale, st)
                     : launch_sliced_tf32x3(device, q, k, v, o, b, h, s, hd, qs, ks, vs, scale,
                                            st));
  }
  switch (body_hd(hd)) {
    CASE(32) CASE(64) CASE(80) CASE(128) CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// The plan of the body that takes dtype (as in attention_launch) at (b, h,
// s, hd), into out[11]: rows a block, threads a block, shared-memory bytes a
// block, registers a thread (bf16: at entry, before setmaxnreg), blocks
// resident an SM, SMs, blocks, query tiles (bf16: warpgroup tiles of 64
// rows; f32: warp tiles of 16), blocks with an idle tile, key steps a tile
// (bf16: 16 keys; f32: 8), query tiles on the busiest SM.  Returns a
// cudaError_t.
extern "C" int attention_plan(int device, int b, int h, int s, int hd, int dtype, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
#define CASE(HD)                                                                              \
  case HD:                                                                                    \
    return (int)(dtype == 1 ? plan_bf16<HD>(device, b, h, s, out)                             \
                            : plan_f32<HD>(device, b, h, s, out));
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (hd > MAX_UNSLICED_HD) return (int)plan_sliced(device, b, h, s, hd, dtype, out);
  switch (body_hd(hd)) {
    CASE(32) CASE(64) CASE(80) CASE(128) CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// The body this process's last launch took (enum Body), -1 before any.
extern "C" int attention_last_body() { return last_body.load(std::memory_order_relaxed); }

extern "C" const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// 256 the sliced bodies (`attention_sliced_wgmma_kernel`, bf16, and
// `attention_sliced_f32_kernel`, 3xTF32, both on `wgmma` fed by TMA, the
// scores computed once across a cluster of the head's slices: blocks of 256
// context columns; see their note), as the TPU kernel takes any head_dim
// above 16.  Each unsliced body is built for the head dims
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
// A head_dim above 256 (K4_HDS' last) runs on the sliced bodies: the
// ceil(hd / 256) slices of a (volume, head) and 128 query rows are the
// blocks (ranks) of one thread-block cluster, each rank computing 256
// context columns, so that a consumer's context stays at the 128
// accumulators a thread of the 256 body (wgmma's widest N), and no q tile
// is held whole (at hd 512 a 64-row tile is 64 KB in bf16, 128 KB in f32).
// The ranks split the scores' K loop: rank r computes a chunk's partial
// scores over its own run of hd's boxes, and every rank adds all ranks'
// partials in rank order through distributed shared memory, so the card
// takes the 2 products of an unsliced body and every rank holds the same
// bits of the scores: one online softmax, one normaliser for all slices.
// Columns past hd load as zeros (TMA's zero fill), so they add nothing to
// q k^T; the scale is 1 / sqrt(hd) of the true hd.  The last chunk's keys
// past S are masked after the sum, as in the unsliced bodies; no narrow
// tail chunk.  The f32 body's note gives the cluster, the hand-over and
// its traps; the bf16 body's note (after it) what bf16 does otherwise.
constexpr int SLICE = 256;  // context columns a block of the sliced bodies computes

// f32: both products in 3xTF32 on wgmma fed by TMA, the scores of a chunk
// computed once across a thread-block cluster of the head's slices.
//
// A cluster is `cluster` blocks (ranks r) of one (volume, head, row block of
// 128 query rows); rank r computes the 256 context columns of slice
// group * cluster + r, and the chunk's partial scores over its own run of
// hd's 32-column boxes, boxes [r nbox / cluster, (r + 1) nbox / cluster) of
// nbox = ceil(hd / 32): a K split of q k^T, as even as the boxes allow (hd
// 512: 8 + 8; 264: 4 + 5; 1,024: 8 a rank of 4).  The slices go in groups
// of at most 8 (a portable cluster), so up to hd 2,048 one group computes
// the scores once; above it each group computes them.  A block is three
// warpgroups:
//   * Warpgroup 0, the producer (registers given up by setmaxnreg): thread
//     0 loads a ring of SW_STAGES stages by TMA (4-d maps over the strided
//     views, as the bf16 bodies'); warps 1-3 split each landed stage's B
//     operand into TF32 hi and lo tiles (`split_tf32`) and arrive on its
//     `ready` mbarrier after `fence.proxy.async`.
//   * Warpgroups 1 and 2, the consumers, 64 query rows each, both reading
//     every stage.
//   * A chunk is 32 keys.  Its score stages, one a box of the rank's run:
//     q's 64 x 32 box of each live consumer and k's 32 x 32 box, both in the
//     128-byte swizzle; the splitters split k's box where it lies.  Its v
//     stages, one a pass of 64 of the slice's columns (4 a slice, fewer
//     where the slice ends at hd): v's 32 keys x 64 columns as loaded, which
//     the splitters transpose into hi and lo tiles of 64 rows of 32 keys
//     (K-major, 128-byte swizzle): `wgmma` takes TF32 only K-major (its
//     transpose bits are for 16-bit types), so the bf16 bodies' N-major
//     read of v's rows is not open here.
//   * Scores: q's fragments by ldmatrix from its swizzled box, split in
//     registers, A of three wgmma m64n32k8 a k-step (lo_q hi_k and hi_q lo_k
//     into `small`, hi_q hi_k into `big`, both from 0 a box) added in f32 a
//     box into the chunk's partial, which lies in the consumer's exchange
//     slot in shared memory (16 values a thread), not in registers beside
//     the context: the tensor cores truncate inside a wgmma, so no small
//     term meets a long sum there.
//   * The hand-over, in SW_SLOTS slots of 8 KB a consumer: once every
//     thread of the consumer has summed its partial into the slot (a named
//     barrier of its 128 threads), one thread arrives (release, cluster
//     scope) on the slot's `xfull` mbarrier in every rank; once its own
//     `xfull` completes each thread reads the 16 values at its place in
//     every rank's slot, through distributed shared memory, and adds them
//     in rank order.  Every rank thus holds the same bits of the chunk's
//     scores, and the same running max and sum: one normaliser for all
//     slices, as the unsliced body has.  No float atomics, one order: a
//     launch gives the same bits every time.
//   * The order of the ring: the score stages of chunk c + SW_LAG come
//     before the v stages of chunk c, so that a consumer hands over its
//     partials SW_LAG chunks before it waits for the others'.  A rank reads
//     chunk c's partials before it hands over chunk c + SW_LAG + 1 (the
//     named barrier orders its threads' reads before that release), so a
//     slot, SW_SLOTS = SW_LAG + 2 chunks back, is free once the chunk
//     before the one to be written is handed over everywhere: one barrier
//     a slot, none for its reads.
//   * Why this exchange (`chip_turns.py`, phases `k4_sliced` in turns and
//     `k4_sliced_parts`, on an H100, at (1, 24, 513, 512)): a release
//     arrival at cluster scope is dear, so the consumer's threads meet at
//     a named barrier and one of them arrives, not one a warp (0.386-0.391
//     ms against 0.402-0.404) or one a thread, and the slots need no
//     barrier of their own for the reads (0.360-0.361 against
//     0.387-0.388); the hand-over then costs 8 % of the body (its waits 2,
//     the other ranks' reads 4); a lag of two chunks and four slots against
//     one and three moved the time by 1-2 %.  Hardware cluster barriers
//     (barrier.cluster) would take the producer's threads into every
//     chunk's barrier as well.
//   * Softmax and p v: keys past S are masked to -inf after the sum (every
//     chunk holds a live key); p = exp(s - max), split into TF32 hi and lo
//     where the score accumulators hold it: the A fragment of an 8-key step
//     wants keys t and t + 4 where the accumulators hold 2t and 2t + 1, so
//     the splitters store each 8 keys of v's tiles in the order 0, 2, 4, 6,
//     1, 3, 5, 7.  A pass's p v runs as three wgmma m64n64k8 a k-step into
//     one accumulator from 0 and is added to the rescaled context in f32,
//     as the unsliced f32 body adds each chunk's.
//   * Rows past S: every rank has the same row block and so the same live
//     consumers; a consumer with no live row computes nothing, is not
//     counted by the ring's `empty` barriers, and touches no exchange slot.
//     Every thread of every rank joins the cluster barrier after the
//     barriers' initialisation and the one before it exits (no block leaves
//     while another may read its slots or arrive on its barriers).
//
// Budget (227 KB of shared memory, 65,536 registers, one block an SM): a
// stage is 28 KB (two q boxes of 8 KB, k's box raw, hi and lo at 4 KB; a v
// stage's raw, hi and lo tiles take 24 KB of it), five stages 140 KB, the
// exchange slots 64 KB: 205 KB.  A consumer thread holds its slice's
// context (64 rows x 256 columns: 128 registers), a box's two accumulators
// (32) and q's fragments (32), or p's split fragments (32) and a pass's
// accumulator (32), under setmaxnreg's 232; the producer keeps 40 (the
// block enters with 168 a thread, and 40 + 2 x 232 is the most the
// block's own registers give: 48 left the consumers' setmaxnreg waiting
// for ever).  Holding the partial in registers, or splitting q in the
// producer's warps for wgmmas with A in shared memory (with two buffers of
// accumulators), spilled and ran slower; a third accumulator (hi_q lo_k
// apart from lo_q hi_k) spilled too.  Rows a block: 128 (two consumers
// sharing each k and v stage) at one block an SM gives (1, 24, 513, 512)
// 120 clusters of 2 on the 66 the card holds at once
// (`cudaOccupancyMaxActiveClusters`), 1.8 waves, the last row block of a
// head with one live row; 64 rows would give 216 clusters, 3.3 waves, each
// stage split for half the rows.
constexpr int SW_KEYS = 32;                       // keys a chunk
constexpr int SW_BOX = 32;                        // hd columns of a score box: 128 bytes of f32
constexpr int SW_PASS = 64;                       // context columns of a v pass (wgmma's N)
constexpr int SW_PASSES = SLICE / SW_PASS;
constexpr int SW_CONSUMERS = CONSUMERS;           // warpgroups of 64 query rows
constexpr int SW_ROWS = BLOCK_ROWS;               // query rows of a block
constexpr int SW_THREADS = WG_THREADS;
constexpr int SW_SPLITTERS = 96;                  // warps 1-3 of the producer's warpgroup
constexpr int SW_MAX_CLUSTER = 8;                 // ranks of a cluster: portable
constexpr int SW_Q = ROWS * SW_BOX * 4;           // a consumer's q box, 8 KB
constexpr int SW_K = SW_KEYS * SW_BOX * 4;        // k's box (raw, hi or lo), 4 KB
constexpr int SW_V = SW_KEYS * SW_PASS * 4;       // a v pass (raw, hi or lo), 8 KB
constexpr int SW_STAGE = SW_CONSUMERS * SW_Q + 3 * SW_K;
constexpr int SW_STAGES = 5;
constexpr int SW_SLOT = ROWS * SW_KEYS * 4;       // a consumer's partial scores, 8 KB
// chunks by which a consumer's scores run ahead of its softmax and p v, and
// the exchange slots that takes (see "The order of the ring" above)
constexpr int SW_LAG = 2;
constexpr int SW_SLOTS = SW_LAG + 2;
constexpr size_t SW_SMEM = 1024 + (size_t)SW_STAGES * SW_STAGE +
                           (size_t)SW_SLOTS * SW_CONSUMERS * SW_SLOT +
                           (3 * SW_STAGES + SW_SLOTS * SW_CONSUMERS) * sizeof(uint64_t);
static_assert(3 * SW_V <= SW_STAGE && SW_STAGE % 1024 == 0 && SW_SMEM <= SMEM_MAX &&
                  SW_SLOTS >= SW_LAG + 2,
              "the sliced f32 ring");
// Past the ring (1,024-byte aligned): the consumers' exchange slots
// [consumer][slot], then the mbarriers, all at fixed offsets from the ring's
// start, so that a thread holds one address for all of them.
constexpr int SW_SLOTS_AT = SW_STAGES * SW_STAGE;
constexpr int SW_BARS_AT = SW_SLOTS_AT + SW_SLOTS * SW_CONSUMERS * SW_SLOT;
// the mbarriers: full, ready and empty of each stage, then xfull of each
// consumer's slots
constexpr int SW_FULL = 0, SW_READY = SW_STAGES, SW_EMPTY = 2 * SW_STAGES;
constexpr int SW_XFULL = 3 * SW_STAGES;

__device__ __forceinline__ uint64_t* sw_bar(unsigned char* ring, int i) {
  return reinterpret_cast<uint64_t*>(ring + SW_BARS_AT) + i;
}
__device__ __forceinline__ float* sw_slot(unsigned char* ring, int c, int slot) {
  return reinterpret_cast<float*>(ring + SW_SLOTS_AT + (SW_SLOTS * c + slot) * SW_SLOT);
}

// This block's rank in its cluster, and the cluster's size.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}

// The address of `p`, in this block's shared memory, in block `rank`'s.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// One arrival on the mbarrier `bar` of block `rank`, releasing this
// thread's earlier reads and writes of shared memory to the cluster.
__device__ __forceinline__ void mbar_arrive_rank(uint64_t* bar, int rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_addr(bar, rank))
               : "memory");
}

// `mbar_wait` acquiring at cluster scope: what the other blocks released
// with their arrivals is visible after it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}

// 16 bytes of a block's shared memory at a cluster address.
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The 128 threads of consumer warpgroup c (named barrier 1 + c; 0 is
// __syncthreads'), ordering their shared-memory accesses before what
// follows in any of them.
__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// Every thread of every block of the cluster, each once.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// Splitter i (0 .. SW_SPLITTERS - 1) on a score stage: k's landed box into
// TF32 hi and lo boxes of its layout, 16 bytes at a time.
__device__ __forceinline__ void split_k_box(unsigned char* st, int i) {
  const float4* raw = reinterpret_cast<const float4*>(st + SW_CONSUMERS * SW_Q);
  uint4* hi = reinterpret_cast<uint4*>(st + SW_CONSUMERS * SW_Q + SW_K);
  uint4* lo = hi + SW_K / 16;
  for (int j = i; j < SW_K / 16; j += SW_SPLITTERS) {
    const float4 x = raw[j];
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    hi[j] = h;
    lo[j] = l;
  }
}

// Splitter i on a v stage: v's landed pass (two boxes of 32 keys x 32
// columns, row-major, unswizzled) transposed into hi and lo tiles of 64 rows
// (the pass's columns) of 32 keys, the 128-byte swizzle (16-byte chunk q of
// row n at q ^ (n % 8)), each 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7.
// Item j: column j % 64 and chunk ch = j / 64 of its row, keys 8 (ch / 2) +
// ch % 2 + {0, 2, 4, 6}; a warp's items are 32 columns of one chunk, so its
// reads fall on 32 banks and each 8 of its 16-byte writes on distinct ones.
__device__ __forceinline__ void split_v_pass(unsigned char* st, int i) {
  const float* raw = reinterpret_cast<const float*>(st);
  unsigned char* hi = st + SW_V;
  unsigned char* lo = st + 2 * SW_V;
  for (int j = i; j < SW_PASS * SW_KEYS / 4; j += SW_SPLITTERS) {
    const int col = j % SW_PASS, ch = j / SW_PASS;
    const float* src = raw + (col / SW_BOX) * (SW_KEYS * SW_BOX) +
                       (4 * (ch & ~1) + (ch & 1)) * SW_BOX + col % SW_BOX;
    uint4 h, l;
    split_tf32(src[0], h.x, l.x);
    split_tf32(src[2 * SW_BOX], h.y, l.y);
    split_tf32(src[4 * SW_BOX], h.z, l.z);
    split_tf32(src[6 * SW_BOX], h.w, l.w);
    const int off = col * 128 + ((ch ^ (col & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// Consumer c's partial scores of one score stage into `part`, this thread's
// four float4 of its exchange slot (`first`: set them, else add): q's
// fragments (register i of k-step kk: row 16 warp + g + 8 (i % 2), column
// 8 kk + t + 4 (i / 2) of the box) by ldmatrix from the swizzled box and
// split in registers; 3 wgmma m64n32k8 a k-step with k's hi and lo boxes as
// B; `big` and `small` from 0, added in f32.  Accumulator register 4j + 2i
// + e: row 16 warp + g + 8i, key 8j + 2t + e; float4 j holds 4j .. 4j + 3.
// The partial lies in shared memory, not in registers beside the context.
__device__ __forceinline__ void sliced_scores_box(float4* part, const unsigned char* st, int c,
                                                  bool first) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const unsigned char* qb = st + c * SW_Q;
  // ldmatrix's tiles: rows 0-7 / 8-15 of the warp's 16 at columns 0-3 / 4-7
  // of a k-step (tiles 0, 1, 2, 3), before the swizzle
  const int a_row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_chunk = lane >> 4;
  const uint64_t dh = smem_desc(st + SW_CONSUMERS * SW_Q + SW_K, 16, 1024, 1);
  const uint64_t dl = smem_desc(st + SW_CONSUMERS * SW_Q + 2 * SW_K, 16, 1024, 1);
  float big[SW_KEYS / 2], small[SW_KEYS / 2];
  uint32_t a[4][8];  // [k-step][hi 0-3, lo 4-7]
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t raw[4];
    ldmatrix_x4(raw, qb + a_row * 128 + (((2 * kk + a_chunk) ^ (lane & 7)) << 4));
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32(raw[r], a[kk][r], a[kk][4 + r]);
  }
  fence_regs(big);
  fence_regs(small);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t* f = a[kk];
    wgmma_tf32_rs<SW_KEYS>(small, f[4], f[5], f[6], f[7], dh + 2 * kk, kk > 0);
    wgmma_tf32_rs<SW_KEYS>(small, f[0], f[1], f[2], f[3], dl + 2 * kk, 1);
    wgmma_tf32_rs<SW_KEYS>(big, f[0], f[1], f[2], f[3], dh + 2 * kk, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(big);
  fence_regs(small);
#pragma unroll
  for (int j = 0; j < SW_KEYS / 8; ++j) {
    float4 v = make_float4(big[4 * j] + small[4 * j], big[4 * j + 1] + small[4 * j + 1],
                           big[4 * j + 2] + small[4 * j + 2], big[4 * j + 3] + small[4 * j + 3]);
    if (!first) {
      const float4 p = part[128 * j];
      v = make_float4(p.x + v.x, p.y + v.y, p.z + v.z, p.w + v.w);
    }
    part[128 * j] = v;
  }
}

// The online softmax of one chunk (key0 ..) of this consumer's 64 rows from
// its summed scores `sc` (`sliced_scores_box`'s layout): keys at or past s
// masked (`last`), the running max m and this thread's share l of the sums
// updated, `corr` the context's rescale; then p split into TF32 hi and lo as
// the A fragments of the chunk's four 8-key steps of p v: register r (hi,
// r + 4 lo) of step kk holds row g + 8 (r % 2), key 8 kk + 2t + r / 2 (A's
// column t + 4 (r / 2), see `split_v_pass`).
__device__ __forceinline__ void sliced_softmax(uint32_t (&pf)[SW_KEYS / 8][8], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               float (&sc)[SW_KEYS / 2], int key0, int s,
                                               bool last, float scale_log2) {
  const int t = threadIdx.x % 4;
  if (last) {
#pragma unroll
    for (int j = 0; j < SW_KEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (key0 + 8 * j + 2 * t + e >= s) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < SW_KEYS / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mx[i] = fmaxf(mx[i], fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
  float mb[2];
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
  for (int j = 0; j < SW_KEYS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -mb[e / 2]));
      sc[4 * j + e] = p;
      l[e / 2] += p;
    }
#pragma unroll
  for (int kk = 0; kk < SW_KEYS / 8; ++kk) {
    split_tf32(sc[4 * kk], pf[kk][0], pf[kk][4]);
    split_tf32(sc[4 * kk + 2], pf[kk][1], pf[kk][5]);
    split_tf32(sc[4 * kk + 1], pf[kk][2], pf[kk][6]);
    split_tf32(sc[4 * kk + 3], pf[kk][3], pf[kk][7]);
  }
}

// ctx's columns 64 p .. 64 p + 63 of the slice = ctx * corr + p v of one v
// stage: 3 wgmma m64n64k8 a k-step (lo_p hi_v, hi_p lo_v, hi_p hi_v) into
// one accumulator from 0, added in f32 (one FMA).  The caller's loop over p
// is unrolled, so that ctx's registers are named at compile time.
__device__ __forceinline__ void sliced_pv_pass(float (&ctx)[SW_PASSES * SW_PASS / 2], int p,
                                               uint32_t (&pf)[SW_KEYS / 8][8],
                                               const float (&corr)[2], const unsigned char* st) {
  const uint64_t dh = smem_desc(st + SW_V, 16, 1024, 1);
  const uint64_t dl = smem_desc(st + 2 * SW_V, 16, 1024, 1);
  float pv[SW_PASS / 2];
  fence_regs(pv);
  fence_regs(pf);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SW_KEYS / 8; ++kk) {
    const uint32_t* f = pf[kk];
    wgmma_tf32_rs<SW_PASS>(pv, f[4], f[5], f[6], f[7], dh + 2 * kk, kk > 0);
    wgmma_tf32_rs<SW_PASS>(pv, f[0], f[1], f[2], f[3], dl + 2 * kk, 1);
    wgmma_tf32_rs<SW_PASS>(pv, f[0], f[1], f[2], f[3], dh + 2 * kk, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(pv);
#pragma unroll
  for (int j = 0; j < SW_PASS / 2; ++j)
    ctx[p * SW_PASS / 2 + j] = fmaf(ctx[p * SW_PASS / 2 + j], corr[(j >> 1) & 1], pv[j]);
}

// The ring's shared state and one rank's work, as the producer and the
// consumers walk it in the same order (see the note above SW_KEYS).
struct SlicedWork {
  unsigned char* ring;  // the ring, then the slots and the mbarriers (SW_SLOTS_AT, SW_BARS_AT)
  int b, hh, row0, live, chunks, b0, b1, col0, passes;
};

// Consumer c (live): the chunks' scores, the hand-over, the softmax and the
// slice's p v; then the context divided by the row sums into o.
__device__ __forceinline__ void sliced_f32_consume(const SlicedWork& w, float* __restrict__ o,
                                                   int s, int h, int hd, int c, int cluster,
                                                   float scale_log2) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  float ctx[SW_PASSES * SW_PASS / 2];
#pragma unroll
  for (int i = 0; i < SW_PASSES * SW_PASS / 2; ++i) ctx[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (raw scores)
  float l[2] = {0.f, 0.f};              // this thread's share of their sums
  int it = 0;                           // stages of the ring taken
  const int xf = SW_XFULL + SW_SLOTS * c;  // this consumer's slots' barriers
  for (int ch = 0; ch < w.chunks + SW_LAG; ++ch) {
    if (ch < w.chunks) {  // chunk ch's partial scores, summed in its slot, handed over
      const int slot = ch % SW_SLOTS;
      // every rank has read what this slot held SW_SLOTS chunks ago: it
      // did so before it handed over chunk ch - 1 (SW_SLOTS >= SW_LAG + 2)
      if (ch >= SW_SLOTS)
        mbar_wait_cluster(sw_bar(w.ring, xf + (ch - 1) % SW_SLOTS), ((ch - 1) / SW_SLOTS) & 1);
      float4* mine = reinterpret_cast<float4*>(sw_slot(w.ring, c, slot)) + tid;
      for (int x = w.b0; x < w.b1; ++x, ++it) {
        const int st = it % SW_STAGES;
        const uint32_t phase = (it / SW_STAGES) & 1;
        mbar_wait(sw_bar(w.ring, SW_FULL + st), phase);
        mbar_wait(sw_bar(w.ring, SW_READY + st), phase);
        sliced_scores_box(mine, w.ring + st * SW_STAGE, c, x == w.b0);
        if (tid == 0) mbar_arrive(sw_bar(w.ring, SW_EMPTY + st));
      }
      // the warpgroup's writes, released by its first thread to every rank
      consumer_sync(c);
      if (tid == 0)
        for (int r = 0; r < cluster; ++r) mbar_arrive_rank(sw_bar(w.ring, xf + slot), r);
    }
    if (ch >= SW_LAG) {  // chunk ch - SW_LAG: the scores summed in rank order, softmax, p v
      const int u = ch - SW_LAG, slot = u % SW_SLOTS;
      mbar_wait_cluster(sw_bar(w.ring, xf + slot), (u / SW_SLOTS) & 1);
      float sc[SW_KEYS / 2];
      for (int r = 0; r < cluster; ++r) {
        const uint32_t at = cluster_addr(sw_slot(w.ring, c, slot), r) + 16 * tid;
#pragma unroll
        for (int j = 0; j < SW_KEYS / 8; ++j) {
          const float4 v = ld_cluster_f4(at + 16 * 128 * j);
          sc[4 * j] = r == 0 ? v.x : sc[4 * j] + v.x;
          sc[4 * j + 1] = r == 0 ? v.y : sc[4 * j + 1] + v.y;
          sc[4 * j + 2] = r == 0 ? v.z : sc[4 * j + 2] + v.z;
          sc[4 * j + 3] = r == 0 ? v.w : sc[4 * j + 3] + v.w;
        }
      }
      uint32_t pf[SW_KEYS / 8][8];
      float corr[2];
      sliced_softmax(pf, m, l, corr, sc, u * SW_KEYS, s, u + 1 == w.chunks, scale_log2);
#pragma unroll
      for (int p = 0; p < SW_PASSES; ++p) {
        if (p >= w.passes) break;
        const int st = it % SW_STAGES;
        const uint32_t phase = (it / SW_STAGES) & 1;
        mbar_wait(sw_bar(w.ring, SW_FULL + st), phase);
        mbar_wait(sw_bar(w.ring, SW_READY + st), phase);
        sliced_pv_pass(ctx, p, pf, corr, w.ring + st * SW_STAGE);
        if (tid == 0) mbar_arrive(sw_bar(w.ring, SW_EMPTY + st));
        ++it;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w.row0 + c * ROWS + 16 * warp + g + 8 * i;
    if (r >= s) continue;
    const float inv = 1.f / l[i];  // each sum holds its max's exp(0) = 1
    // this slice's columns below hd; register 4n + 2i + e holds column 8n + 2t + e
    float* out = o + (((long long)w.b * s + r) * h + w.hh) * hd + w.col0 + 2 * t;
    if (hd % 2 == 0) {
#pragma unroll
      for (int n = 0; n < SLICE / 8; ++n)
        if (w.col0 + 8 * n + 2 * t < hd)
          *reinterpret_cast<float2*>(out + 8 * n) =
              make_float2(ctx[4 * n + 2 * i] * inv, ctx[4 * n + 2 * i + 1] * inv);
    } else {
#pragma unroll
      for (int n = 0; n < SLICE / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (w.col0 + 8 * n + 2 * t + e < hd) out[8 * n + e] = ctx[4 * n + 2 * i + e] * inv;
    }
  }
}

// The producer: thread 0's loads, warps 1-3's splits, stage by stage in the
// consumers' order.
__device__ __forceinline__ void sliced_f32_produce(const SlicedWork& w, const CUtensorMap* map_q,
                                                   const CUtensorMap* map_k,
                                                   const CUtensorMap* map_v, int orders,
                                                   int tid) {
  const int oq = orders & 63, ok = (orders >> 6) & 63, ov = (orders >> 12) & 63;
  int it = 0;
  for (int ch = 0; ch < w.chunks + SW_LAG; ++ch) {
    const int n_score = ch < w.chunks ? w.b1 - w.b0 : 0;
    const int n_v = ch >= SW_LAG ? w.passes : 0;
    for (int j = 0; j < n_score + n_v; ++j, ++it) {
      const int st = it % SW_STAGES;
      const uint32_t phase = (it / SW_STAGES) & 1;
      unsigned char* dst = w.ring + st * SW_STAGE;
      uint64_t* full = sw_bar(w.ring, SW_FULL + st);
      const bool score = j < n_score;
      if (tid == 0) {
        mbar_wait(sw_bar(w.ring, SW_EMPTY + st), phase ^ 1);  // at once on the first lap
        if (score) {
          const int col = SW_BOX * (w.b0 + j);
          mbar_expect_tx(full, w.live * SW_Q + SW_K);
          for (int q = 0; q < w.live; ++q)
            load_box(dst + q * SW_Q, map_q, oq, full, col, w.row0 + q * ROWS, w.hh, w.b);
          load_box(dst + SW_CONSUMERS * SW_Q, map_k, ok, full, col, ch * SW_KEYS, w.hh, w.b);
        } else {
          const int col = w.col0 + SW_PASS * (j - n_score), key = (ch - SW_LAG) * SW_KEYS;
          mbar_expect_tx(full, SW_V);
          load_box(dst, map_v, ov, full, col, key, w.hh, w.b);
          load_box(dst + SW_V / 2, map_v, ov, full, col + SW_BOX, key, w.hh, w.b);
        }
      } else if (tid >= 32) {
        mbar_wait(full, phase);
        if (score)
          split_k_box(dst, tid - 32);
        else
          split_v_pass(dst, tid - 32);
        // these generic-proxy writes, visible to the consumers' wgmmas
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(sw_bar(w.ring, SW_READY + st));
      }
    }
  }
}

// grid: x = (volume, head, group, rank), clusters of `cluster` blocks along
// x; y = row block of SW_ROWS query rows.  The maps: q in boxes of 32
// columns x 64 rows, k in 32 x 32, both 128-byte swizzled; v in 32 x 32,
// unswizzled.
__global__ void __launch_bounds__(SW_THREADS, 1)
attention_sliced_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, float* __restrict__ o,
                            int s, int h, int hd, int groups, int orders, float scale_log2) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  // the swizzle atoms (8 rows of 128 bytes) must start 1024-byte aligned
  unsigned char* ring = att_smem + ((1024 - (smem_u32(att_smem) & 1023)) & 1023);

  const int cluster = cluster_size(), rank = cluster_rank();
  const int unit = blockIdx.x / cluster;
  const int bh = unit / groups, group = unit % groups;
  SlicedWork w;
  w.ring = ring;
  w.b = bh / h;
  w.hh = bh % h;
  w.row0 = blockIdx.y * SW_ROWS;
  w.live = min(SW_CONSUMERS, (s - w.row0 + ROWS - 1) / ROWS);
  w.chunks = (s + SW_KEYS - 1) / SW_KEYS;
  const int nbox = (hd + SW_BOX - 1) / SW_BOX;
  w.b0 = rank * nbox / cluster;
  w.b1 = (rank + 1) * nbox / cluster;
  w.col0 = (group * cluster + rank) * SLICE;
  w.passes = w.col0 < hd ? min(SW_PASSES, (hd - w.col0 + SW_PASS - 1) / SW_PASS) : 0;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < SW_STAGES; ++i) {
      mbar_init(sw_bar(ring, SW_FULL + i), 1);
      mbar_init(sw_bar(ring, SW_READY + i), SW_SPLITTERS);
      mbar_init(sw_bar(ring, SW_EMPTY + i), w.live);  // one arrival from each live consumer
    }
    for (int i = 0; i < SW_SLOTS * SW_CONSUMERS; ++i) {
      // one arrival from the consumer in every rank
      mbar_init(sw_bar(ring, SW_XFULL + i), cluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // every rank's barriers are set before any rank arrives on them
  cluster_sync_all();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    sliced_f32_produce(w, &map_q, &map_k, &map_v, orders, tid);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    if (c < w.live)  // a query row of this warpgroup lies below s
      sliced_f32_consume(w, o, s, h, hd, c, cluster, scale_log2);
  }
  // no block leaves while another may read its slots or arrive on its barriers
  cluster_sync_all();
}

// bf16: both products on wgmma fed by TMA, the scores of a chunk computed
// once across the f32 body's cluster (`sliced_cluster`: the slices in groups
// of at most 8 ranks, several groups above hd 2,048, each group computing
// the scores).  Rank r computes the 256 context columns of slice group *
// cluster + r and the chunk's partial scores over its run of hd's 64-column
// boxes, [r nbox / cluster, (r + 1) nbox / cluster) of nbox = ceil(hd / 64):
// 2 + 3 at hd 264, 4 + 4 at 512, four ranks of 4 at 1,024.  Where it
// differs from the f32 body:
//   * q is loaded once a block.  nbox <= 4 slices, so up to hd 2,048 (one
//     group) a run is at most SB_RUN = 4 boxes: each live consumer's q boxes
//     of the run (64 rows x 64 columns, 8 KB each) come by TMA at the
//     block's start and stay for the whole key walk.  Above hd 2,048 a run
//     can be longer; there it goes in sub-runs of at most 4 boxes, each
//     sub-run's q boxes reloaded into the same space every chunk
//     (`q_empty`), which only those head dims pay.
//   * One ring of SB_STAGES equal stages carries k and v in the consumers'
//     order: a chunk's k boxes of the run (SB_KEYS keys x 64 columns each),
//     or its keys of v's slice (four such boxes, those holding a column
//     below hd loaded), all in the 128-byte swizzle.  The producer's thread
//     0 only loads: v is read through the N-major descriptor
//     (`wgmma_rs_tb<256>`), so nothing is split or transposed.
//   * Scores: a consumer waits for the chunk's k stage once, issues the
//     wgmmas of every box of its run (m64n`SB_KEYS`k16, q and k from shared
//     memory) into one accumulator in registers, commits once, waits once,
//     then releases the stage.
//   * The hand-over: the partial (64 rows x SB_KEYS keys in f32) stored into
//     the consumer's exchange slot, then every consumer thread arrives on a
//     block-local `xwritten`; a helper (lane 0 of the producer's warp 1 +
//     c) waits for it and makes the release arrivals at cluster scope on
//     the slot's `xfull` in every rank, off the consumer's path (a release
//     at cluster scope waits for the writes to be performed there).  The
//     scores run SB_LAG chunks ahead of the softmax in SB_LAG + 2 slots, a
//     slot reused once the chunk before the one to be written has been
//     handed over everywhere, as in the f32 body; every rank reads every
//     rank's slot through distributed shared memory and adds them in rank
//     order (no float atomics: a launch gives the same bits every time),
//     then masks the keys past S to -inf.
//   * Softmax and p v as the unsliced body's (`softmax_pv`, forked for the
//     stage's box stride): exp(s - max) by exp2 with the scale folded in,
//     rounded to bf16 unnormalised in registers, p v by `wgmma_rs_tb<256>`
//     on v's stage, the context divided by the f32 row sums once.  A rank
//     whose slice holds no column below hd (above hd 2,048) loads no v and
//     runs no p v.
//
// Budget (227 KB of shared memory, one block an SM), by keys a chunk:
//
//   item                                    64 keys       32 keys
//   resident q, <= 4 boxes, 2 consumers     64 KB         64 KB
//   exchange slot of a consumer             16 KB         8 KB
//   slots: 2 consumers x (SB_LAG + 2)       96 KB (lag 1) 64 KB (lag 2)
//   a ring stage (k's run or v's slice)     32 KB         16 KB
//   stages that fit beside them             2             6
//
// Registers: a consumer at setmaxnreg's 232 holds the slice's context
// (128), the scores (SB_KEYS / 2) and p's bf16 fragments (SB_KEYS / 4); the
// block enters at 168 a thread (384 threads, one block an SM), so the
// producer keeps 40: 40 + 2 x 232 is the most the block's registers give
// (48 for the producer left the f32 body's consumers waiting for ever).
// The bound at (2, 24, 513, 512): 0.0301 ms for the bytes (q, k, v read
// once, ctx written once at 3.35 TB/s) against 0.0262 ms for the two
// products at 989 TFLOP/s.  Why this form (`chip_turns.py --phases
// k4_sliced_bf16_parts`, copies of this file in turns on an H100 at 700 W,
// at that shape): 64 keys a chunk at lag 1 0.16-0.17 ms; 32 keys (lag 1-3,
// 6-8 stages) 0.19-0.25, twice the hand-overs; 64 keys at lag 0 (3 stages)
// 0.21, the hand-over's wait exposed; the consumers' own release arrivals
// after a named barrier, as the f32 body makes them, 0.205-0.207 against
// 0.165 through the helpers; two slots and a third stage, the reads of
// every rank signalled back by the helpers, 0.18; the scores' wgmmas
// issued under the previous chunk's softmax, 0.22-0.24 (it spills); a head's
// row blocks run together in the grid, no change.  Where the time goes
// (copies with one part taken out): the hand-over 0.03 ms (the reads of the
// other ranks' slots 0.014; at hd 1,024, three other ranks, 0.06), the
// scores' wgmmas 0.026, p v's 0.018.
// Traps kept from the f32 body: every thread of every rank joins the
// cluster barrier after the barriers' initialisation and again before
// exit; a consumer with no live row computes nothing, is not counted by
// the ring's `empty` barriers and touches no slot, the same on every rank
// (all ranks share the row block); the TMA swizzle is the wgmma
// descriptors' (128 bytes, SBO 1,024).
constexpr int SB_KEYS = 64;                  // keys a chunk
constexpr int SB_LAG = 1;                    // chunks the scores run ahead of the softmax
constexpr int SB_SLOTS = SB_LAG + 2;         // exchange slots a consumer
constexpr int SB_BOX = 64;                   // hd columns of a box: 128 bytes of bf16
constexpr int SB_RUN = 4;                    // q boxes a consumer keeps
constexpr int SB_Q = ROWS * 128;             // a q box, 8 KB
constexpr int SB_K = SB_KEYS * 128;          // a k or v box of a chunk's keys
// a stage: the chunk's k boxes of a (sub-)run, or its keys of v's slice
// (four boxes): the same bytes
constexpr int SB_STAGE = SB_RUN * SB_K;
constexpr int SB_SLOT = ROWS * SB_KEYS * 4;  // a consumer's partial scores
constexpr int SB_Q_BYTES = CONSUMERS * SB_RUN * SB_Q;
constexpr int SB_SLOT_BYTES = SB_SLOTS * CONSUMERS * SB_SLOT;
constexpr int SB_BAR_BYTES = 256;
constexpr int SB_STAGES =
    (SMEM_MAX - 1024 - SB_BAR_BYTES - SB_Q_BYTES - SB_SLOT_BYTES) / SB_STAGE;
// From the 1,024-byte aligned base: q [consumer][box], the ring, the slots
// [consumer][slot], the mbarriers: q's full and empty, full and empty of
// each stage, then of each consumer's slots: xfull (written in every rank)
// and xwritten (written here: for the helper).
constexpr int SB_RING_AT = SB_Q_BYTES;
constexpr int SB_SLOTS_AT = SB_RING_AT + SB_STAGES * SB_STAGE;
constexpr int SB_BARS_AT = SB_SLOTS_AT + SB_SLOT_BYTES;
constexpr int SB_QFULL = 0, SB_QEMPTY = 1, SB_FULL = 2, SB_EMPTY = SB_FULL + SB_STAGES,
              SB_XFULL = SB_EMPTY + SB_STAGES, SB_XWRITTEN = SB_XFULL + SB_SLOTS * CONSUMERS,
              SB_BARS = SB_XWRITTEN + SB_SLOTS * CONSUMERS;
constexpr size_t SB_SMEM = 1024 + (size_t)SB_BARS_AT + SB_BARS * sizeof(uint64_t);
static_assert(SLICE / SB_BOX == SB_RUN && SB_STAGES >= 2 &&
                  SB_BARS * sizeof(uint64_t) <= SB_BAR_BYTES && SB_SMEM <= SMEM_MAX &&
                  SB_KEYS % 16 == 0 && SB_SLOTS == SB_LAG + 2,
              "the sliced bf16 body's shared memory");

__device__ __forceinline__ uint64_t* sb_bar(unsigned char* base, int i) {
  return reinterpret_cast<uint64_t*>(base + SB_BARS_AT) + i;
}
__device__ __forceinline__ float* sb_slot(unsigned char* base, int c, int slot) {
  return reinterpret_cast<float*>(base + SB_SLOTS_AT + (SB_SLOTS * c + slot) * SB_SLOT);
}

// One rank's work, as the producer and the consumers walk it in the same
// order: hd's boxes [b0, b1) of the scores, v's boxes of the slice at col0.
struct SlicedBf16Work {
  unsigned char* base;
  int b, hh, row0, live, chunks, b0, b1, col0, v_boxes;
};

// The partial scores of N boxes (q's at `q`, k's at `k`, SB_Q and SB_K
// apart) added into `sc`: every box's 4 k-steps issued, one commit, one
// wait.  Register 4j + 2i + e: row 16 warp + lane / 4 + 8i, key 8j +
// 2 (lane % 4) + e.
template <int N>
__device__ __forceinline__ void sb_scores(float (&sc)[SB_KEYS / 2], const unsigned char* q,
                                          const unsigned char* k) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const uint64_t dq = smem_desc(q + x * SB_Q, 16, 1024, 1);
    const uint64_t dk = smem_desc(k + x * SB_K, 16, 1024, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma<SB_KEYS>(sc, dq + 2 * kk, dk + 2 * kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
}

// The online softmax of one chunk (key0 ..) of this consumer's 64 rows from
// its summed scores `sc`, keys at or past s masked (`last`), then ctx += p
// v from v's stage `v_st` once `v_full` completes its phase (null: the
// slice holds no column below hd, no p v).  `softmax_pv` with v's boxes
// SB_K apart (the unsliced one's are 64 keys deep).
__device__ __forceinline__ void sb_softmax_pv(float (&o)[SLICE / 2], float (&m)[2], float (&l)[2],
                                              float (&sc)[SB_KEYS / 2], const unsigned char* v_st,
                                              uint64_t* v_full, uint32_t v_phase, int key0, int s,
                                              bool last, float scale_log2) {
  const int t = threadIdx.x % 4;
  if (last) {
#pragma unroll
    for (int j = 0; j < SB_KEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (key0 + 8 * j + 2 * t + e >= s) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < SB_KEYS / 8; ++j)
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
  // exp(s / sqrt(hd) - max) = exp2(s * scale_log2 - max * scale_log2)
#pragma unroll
  for (int j = 0; j < SB_KEYS / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + 2 * i + e], scale_log2, -mb[i]));
        sc[4 * j + 2 * i + e] = p;
        l[i] += p;
      }
  if (v_st == nullptr) return;
#pragma unroll
  for (int j = 0; j < SLICE / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= corr[i];
      o[4 * j + 2 * i + 1] *= corr[i];
    }
  // the probabilities as A fragments of the 16-key steps of p v (see
  // `softmax_pv`)
  uint32_t pa[SB_KEYS / 16][4];
#pragma unroll
  for (int kk = 0; kk < SB_KEYS / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  // v's stage is row-major (keys, 64-column boxes SB_K apart), N-major for
  // wgmma: k-steps of 16 keys 16 swizzle rows apart, 8-key groups 1,024
  // bytes apart, the boxes SB_K apart
  const uint64_t dv = smem_desc(v_st, SB_K, 1024, 1);
  mbar_wait(v_full, v_phase);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SB_KEYS / 16; ++kk)
    wgmma_rs_tb<SLICE>(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// Consumer c (live): each chunk's partial scores, the hand-over, the sum in
// rank order, the softmax and the slice's p v; then the context divided by
// the row sums into o.
__device__ __forceinline__ void sliced_bf16_consume(const SlicedBf16Work& w,
                                                    __nv_bfloat16* __restrict__ o, int s, int h,
                                                    int hd, int c, int cluster, float scale_log2) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int run = w.b1 - w.b0, subs = (run + SB_RUN - 1) / SB_RUN;
  unsigned char* const base = w.base;
  const unsigned char* q_mine = base + c * SB_RUN * SB_Q;
  float ctx[SLICE / 2];
#pragma unroll
  for (int i = 0; i < SLICE / 2; ++i) ctx[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows i = 0, 1 (raw scores)
  float l[2] = {0.f, 0.f};              // this thread's share of their sums
  int qi = 0, it = 0;                   // q loads and stages of the ring taken
  const int xs = SB_SLOTS * c;          // this consumer's slots' barriers, from each kind's first
  if (subs == 1) mbar_wait(sb_bar(base, SB_QFULL), 0);  // q, once a block
  for (int ch = 0; ch < w.chunks + SB_LAG; ++ch) {
    if (ch < w.chunks) {  // chunk ch's partial scores into its slot, handed over
      float sc[SB_KEYS / 2];
#pragma unroll
      for (int j = 0; j < SB_KEYS / 2; ++j) sc[j] = 0.f;
      for (int j = 0; j < subs; ++j, ++it) {
        const int n = min(SB_RUN, run - SB_RUN * j);
        if (subs > 1) mbar_wait(sb_bar(base, SB_QFULL), qi & 1);
        const int st = it % SB_STAGES;
        mbar_wait(sb_bar(base, SB_FULL + st), (it / SB_STAGES) & 1);
        const unsigned char* k_st = base + SB_RING_AT + st * SB_STAGE;
        switch (n) {
          case 1: sb_scores<1>(sc, q_mine, k_st); break;
          case 2: sb_scores<2>(sc, q_mine, k_st); break;
          case 3: sb_scores<3>(sc, q_mine, k_st); break;
          default: sb_scores<4>(sc, q_mine, k_st); break;
        }
        if (tid == 0) mbar_arrive(sb_bar(base, SB_EMPTY + st));
        if (subs > 1) {
          if (tid == 0) mbar_arrive(sb_bar(base, SB_QEMPTY));
          ++qi;
        }
      }
      const int slot = ch % SB_SLOTS;
      // every rank has read what this slot held SB_SLOTS chunks ago: it did
      // so before its helper handed over chunk ch - 1 (SB_SLOTS = SB_LAG + 2)
      if (ch >= SB_SLOTS)
        mbar_wait_cluster(sb_bar(base, SB_XFULL + xs + (ch - 1) % SB_SLOTS),
                          ((ch - 1) / SB_SLOTS) & 1);
      float4* mine = reinterpret_cast<float4*>(sb_slot(base, c, slot)) + tid;
#pragma unroll
      for (int j = 0; j < SB_KEYS / 8; ++j)
        mine[128 * j] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
      // this thread's writes, to the helper that releases them to every rank
      mbar_arrive(sb_bar(base, SB_XWRITTEN + xs + slot));
    }
    if (ch >= SB_LAG) {  // chunk ch - SB_LAG: the scores summed in rank order, softmax, p v
      const int u = ch - SB_LAG, slot = u % SB_SLOTS;
      mbar_wait_cluster(sb_bar(base, SB_XFULL + xs + slot), (u / SB_SLOTS) & 1);
      float sc[SB_KEYS / 2];
      for (int r = 0; r < cluster; ++r) {
        const uint32_t at = cluster_addr(sb_slot(base, c, slot), r) + 16 * tid;
#pragma unroll
        for (int j = 0; j < SB_KEYS / 8; ++j) {
          const float4 v = ld_cluster_f4(at + 16 * 128 * j);
          sc[4 * j] = r == 0 ? v.x : sc[4 * j] + v.x;
          sc[4 * j + 1] = r == 0 ? v.y : sc[4 * j + 1] + v.y;
          sc[4 * j + 2] = r == 0 ? v.z : sc[4 * j + 2] + v.z;
          sc[4 * j + 3] = r == 0 ? v.w : sc[4 * j + 3] + v.w;
        }
      }
      const int st = it % SB_STAGES;
      const bool pv = w.v_boxes > 0;
      sb_softmax_pv(ctx, m, l, sc, pv ? base + SB_RING_AT + st * SB_STAGE : nullptr,
                    sb_bar(base, SB_FULL + st), (it / SB_STAGES) & 1, u * SB_KEYS, s,
                    u + 1 == w.chunks, scale_log2);
      if (pv) {
        if (tid == 0) mbar_arrive(sb_bar(base, SB_EMPTY + st));
        ++it;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w.row0 + c * ROWS + 16 * warp + g + 8 * i;
    if (r >= s) continue;
    const float inv = 1.f / l[i];  // each sum holds its max's exp(0) = 1
    // this slice's columns below hd
    __nv_bfloat16* out = o + (((long long)w.b * s + r) * h + w.hh) * hd + w.col0 + 2 * t;
    if (hd % 2 == 0) {
#pragma unroll
      for (int j = 0; j < SLICE / 8; ++j)
        if (w.col0 + 8 * j + 2 * t < hd)
          *reinterpret_cast<uint32_t*>(out + 8 * j) =
              pack_bf16(ctx[4 * j + 2 * i] * inv, ctx[4 * j + 2 * i + 1] * inv);
    } else {
#pragma unroll
      for (int j = 0; j < SLICE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (w.col0 + 8 * j + 2 * t + e < hd)
            out[8 * j + e] = __float2bfloat16_rn(ctx[4 * j + 2 * i + e] * inv);
    }
  }
}

// The helper of consumer c (a thread of the producer's warpgroup): once
// every thread of the consumer has written chunk ch's partial into its slot
// (`xwritten`, release and acquire within the block), one arrival on the
// slot's `xfull` in every rank, releasing those writes (and the reads the
// consumer made before them) to the cluster.  Off the consumer's path: a
// release at cluster scope waits for the memory operations before it to be
// performed there.
__device__ __forceinline__ void sb_hand_over(const SlicedBf16Work& w, int c, int cluster) {
  const int xs = SB_SLOTS * c;
  for (int ch = 0; ch < w.chunks; ++ch) {
    const int slot = ch % SB_SLOTS;
    mbar_wait(sb_bar(w.base, SB_XWRITTEN + xs + slot), (ch / SB_SLOTS) & 1);
    for (int r = 0; r < cluster; ++r) mbar_arrive_rank(sb_bar(w.base, SB_XFULL + xs + slot), r);
  }
}

// q's boxes x0 .. x0 + n - 1 of every live consumer into its resident
// space, on q's `full` barrier.
__device__ __forceinline__ void sb_load_q(const SlicedBf16Work& w, const CUtensorMap* map_q,
                                          int oq, int x0, int n) {
  uint64_t* full = sb_bar(w.base, SB_QFULL);
  mbar_expect_tx(full, w.live * n * SB_Q);
  for (int c = 0; c < w.live; ++c)
    for (int x = 0; x < n; ++x)
      load_box(w.base + (c * SB_RUN + x) * SB_Q, map_q, oq, full, SB_BOX * (x0 + x),
               w.row0 + c * ROWS, w.hh, w.b);
}

// The producer's thread 0: q, then the k and v stages in the consumers'
// order.
__device__ __forceinline__ void sliced_bf16_produce(const SlicedBf16Work& w,
                                                    const CUtensorMap* map_q,
                                                    const CUtensorMap* map_k,
                                                    const CUtensorMap* map_v, int orders) {
  const int oq = orders & 63, ok = (orders >> 6) & 63, ov = (orders >> 12) & 63;
  const int run = w.b1 - w.b0, subs = (run + SB_RUN - 1) / SB_RUN;
  if (subs == 1) sb_load_q(w, map_q, oq, w.b0, run);
  int qi = 0, it = 0;
  for (int ch = 0; ch < w.chunks + SB_LAG; ++ch) {
    // the chunk's k stages (one a sub-run), then the v stage of chunk
    // ch - SB_LAG
    const int n_k = ch < w.chunks ? subs : 0;
    const int n_v = ch >= SB_LAG && w.v_boxes > 0 ? 1 : 0;
    for (int j = 0; j < n_k + n_v; ++j, ++it) {
      const bool is_k = j < n_k;
      const int x0 = w.b0 + SB_RUN * j, n = is_k ? min(SB_RUN, w.b1 - x0) : w.v_boxes;
      if (is_k && subs > 1) {  // this sub-run's q boxes, once the last one's are done with
        mbar_wait(sb_bar(w.base, SB_QEMPTY), (qi & 1) ^ 1);  // at once the first time
        sb_load_q(w, map_q, oq, x0, n);
        ++qi;
      }
      const int st = it % SB_STAGES;
      unsigned char* dst = w.base + SB_RING_AT + st * SB_STAGE;
      uint64_t* full = sb_bar(w.base, SB_FULL + st);
      mbar_wait(sb_bar(w.base, SB_EMPTY + st), ((it / SB_STAGES) & 1) ^ 1);  // at once on the first lap
      mbar_expect_tx(full, n * SB_K);
      for (int x = 0; x < n; ++x) {
        if (is_k)
          load_box(dst + x * SB_K, map_k, ok, full, SB_BOX * (x0 + x), ch * SB_KEYS, w.hh, w.b);
        else
          load_box(dst + x * SB_K, map_v, ov, full, w.col0 + SB_BOX * x,
                   (ch - SB_LAG) * SB_KEYS, w.hh, w.b);
      }
    }
  }
}

// grid: x = (volume, head, group, rank), clusters of `cluster` blocks along
// x; y = row block of BLOCK_ROWS query rows.  The maps: boxes of 64 columns
// by 64 rows (q) or SB_KEYS rows (k, v), 128-byte swizzle.
__global__ void __launch_bounds__(WG_THREADS, 1)
attention_sliced_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              __nv_bfloat16* __restrict__ o, int s, int h, int hd, int groups,
                              int orders, float scale_log2) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  // the swizzle atoms (8 rows of 128 bytes) must start 1024-byte aligned
  unsigned char* base = att_smem + ((1024 - (smem_u32(att_smem) & 1023)) & 1023);

  const int cluster = cluster_size(), rank = cluster_rank();
  const int unit = blockIdx.x / cluster;
  const int bh = unit / groups, group = unit % groups;
  SlicedBf16Work w;
  w.base = base;
  w.b = bh / h;
  w.hh = bh % h;
  w.row0 = blockIdx.y * BLOCK_ROWS;
  w.live = min(CONSUMERS, (s - w.row0 + ROWS - 1) / ROWS);
  w.chunks = (s + SB_KEYS - 1) / SB_KEYS;
  const int nbox = (hd + SB_BOX - 1) / SB_BOX;
  w.b0 = rank * nbox / cluster;
  w.b1 = (rank + 1) * nbox / cluster;
  w.col0 = (group * cluster + rank) * SLICE;
  w.v_boxes = w.col0 < hd ? min(SLICE / SB_BOX, (hd - w.col0 + SB_BOX - 1) / SB_BOX) : 0;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(sb_bar(base, SB_QFULL), 1);
    mbar_init(sb_bar(base, SB_QEMPTY), w.live);
    for (int i = 0; i < SB_STAGES; ++i) {
      mbar_init(sb_bar(base, SB_FULL + i), 1);
      mbar_init(sb_bar(base, SB_EMPTY + i), w.live);  // one arrival from each live consumer
    }
    for (int i = 0; i < SB_SLOTS * CONSUMERS; ++i) {
      mbar_init(sb_bar(base, SB_XFULL + i), cluster);  // from the consumer's helper in every rank
      mbar_init(sb_bar(base, SB_XWRITTEN + i), 128);   // from each thread of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // every rank's barriers are set before any rank arrives on them
  cluster_sync_all();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0)
      sliced_bf16_produce(w, &map_q, &map_k, &map_v, orders);
    else if (tid % 32 == 0 && tid / 32 <= w.live)  // warp 1 + c: consumer c's helper
      sb_hand_over(w, tid / 32 - 1, cluster);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    if (c < w.live)  // a query row of this warpgroup lies below s
      sliced_bf16_consume(w, o, s, h, hd, c, cluster, scale_log2);
  }
  // no block leaves while another may read its slots or arrive on its barriers
  cluster_sync_all();
}

// The map of one (B, H, S, hd) view of `elt`-byte elements of `type`: hd
// innermost, then S, H and B in the order of their strides (smallest
// first), boxes of `box_cols` columns by `box_rows` rows of S, with the
// swizzle of `swizzle` bytes (0: none); rows past S, and columns past hd,
// load as zeros.  `order` gets the positions of the row, head and batch
// coordinates (see `coord`).  TMA needs a 16-byte aligned base and strides
// that are multiples of 16 bytes.
bool encode_view_as(CUtensorMap* map, int* order, const void* base, int b, int h, int s, int hd,
                    Strides st, CUtensorMapDataType type, int elt, int box_cols, int box_rows,
                    int swizzle) {
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
  cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  *order = 0;
  for (int i = 0; i < 3; ++i) {
    if (d[i].stride < 0 || d[i].stride * elt % 16 != 0) return false;
    dims[i + 1] = (cuuint64_t)d[i].size;
    strides[i] = (cuuint64_t)d[i].stride * elt;
    if (d[i].which == 0) box[i + 1] = box_rows;
    *order |= (i + 1) << (2 * d[i].which);
  }
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                : swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 bodies' map of a view: boxes of one swizzle row's width of the
// body's HD (Tile<HD>) by 64 rows of S; the columns from hd to HD load as
// zeros, so that the padded columns add nothing to q k^T and give context
// columns that are never stored.
template <int HD>
bool encode_view(CUtensorMap* map, int* order, const void* base, int b, int h, int s, int hd,
                 Strides st) {
  using T = Tile<HD>;
  return encode_view_as(map, order, base, b, h, s, hd, st, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        T::BOX_COLS, ROWS, T::SW);
}

// The bodies of this file, by the code `attention_last_body` reports.
enum Body {
  BF16_WGMMA = 0,
  F32_TF32X3 = 1,
  F32_TF32X3_4BYTE = 2,
  BF16_SLICED_WGMMA = 3,
  F32_SLICED_WGMMA = 4
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
  return raise_smem_limit_once((const void*)attention_sliced_wgmma_kernel, (int)SB_SMEM, device,
                               smem_set);
}

// The sliced bodies' cluster at head_dim hd: the slices in `groups` groups
// of `cluster` ranks (at most SW_MAX_CLUSTER), as even as they divide.
void sliced_cluster(int hd, int* cluster, int* groups) {
  const int slices = slices_of(hd);
  *groups = (slices + SW_MAX_CLUSTER - 1) / SW_MAX_CLUSTER;
  *cluster = (slices + *groups - 1) / *groups;
}

cudaError_t sliced_f32_ready(int device) {
  static std::atomic<unsigned long long> smem_set{0};  // one bit a device
  return raise_smem_limit_once((const void*)attention_sliced_f32_kernel, (int)SW_SMEM, device,
                               smem_set);
}

// A launch of a sliced body: clusters of `cluster` blocks along x, the
// runtime's error of a refused launch cleared.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int cluster, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  // the runtime keeps a refused launch's error as its last one, which the
  // next launch in this thread would read back: clear it
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The sliced bf16 body: its cluster of a (volume, head)'s slices and 128
// query rows (see its note); maps of 64-column boxes, 64 rows of q and
// SB_KEYS rows of k and v, 128-byte swizzle.
cudaError_t launch_sliced_wgmma(int device, const void* q, const void* k, const void* v, void* o,
                                int b, int h, int s, int hd, Strides qs, Strides ks, Strides vs,
                                float scale, cudaStream_t stream) {
  int cluster = 0, groups = 0;
  sliced_cluster(hd, &cluster, &groups);
  if ((long long)b * h * groups * cluster >= (1ll << 31)) return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  int oq, ok, ov;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_view_as(&map_q, &oq, q, b, h, s, hd, qs, BF16, 2, SB_BOX, ROWS, 128) ||
      !encode_view_as(&map_k, &ok, k, b, h, s, hd, ks, BF16, 2, SB_BOX, SB_KEYS, 128) ||
      !encode_view_as(&map_v, &ov, v, b, h, s, hd, vs, BF16, 2, SB_BOX, SB_KEYS, 128))
    return cudaErrorInvalidValue;
  const cudaError_t err = sliced_wgmma_ready(device);
  if (err != cudaSuccess) return err;
  last_body.store(BF16_SLICED_WGMMA, std::memory_order_relaxed);
  return launch_cluster(attention_sliced_wgmma_kernel,
                        dim3(b * h * groups * cluster, (s + BLOCK_ROWS - 1) / BLOCK_ROWS),
                        cluster, SB_SMEM, stream, map_q, map_k, map_v,
                        static_cast<__nv_bfloat16*>(o), s, h, hd, groups,
                        oq | (ok << 6) | (ov << 12), scale * 1.4426950408889634f);
}

// The sliced f32 body: its cluster of a (volume, head)'s slices and 128
// query rows (see its note); the views TMA reads as they are (the wrapper
// copies one that is not into rows of a multiple of 4 floats).
cudaError_t launch_sliced_f32(int device, const void* q, const void* k, const void* v, void* o,
                              int b, int h, int s, int hd, Strides qs, Strides ks, Strides vs,
                              float scale, cudaStream_t stream) {
  int cluster = 0, groups = 0;
  sliced_cluster(hd, &cluster, &groups);
  if ((long long)b * h * groups * cluster >= (1ll << 31)) return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  int oq, ok, ov;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!encode_view_as(&map_q, &oq, q, b, h, s, hd, qs, F32, 4, SW_BOX, ROWS, 128) ||
      !encode_view_as(&map_k, &ok, k, b, h, s, hd, ks, F32, 4, SW_BOX, SW_KEYS, 128) ||
      !encode_view_as(&map_v, &ov, v, b, h, s, hd, vs, F32, 4, SW_BOX, SW_KEYS, 0))
    return cudaErrorInvalidValue;
  const cudaError_t err = sliced_f32_ready(device);
  if (err != cudaSuccess) return err;
  last_body.store(F32_SLICED_WGMMA, std::memory_order_relaxed);
  return launch_cluster(attention_sliced_f32_kernel,
                        dim3(b * h * groups * cluster, (s + SW_ROWS - 1) / SW_ROWS), cluster,
                        SW_SMEM, stream, map_q, map_k, map_v, static_cast<float*>(o), s, h, hd,
                        groups, oq | (ok << 6) | (ov << 12), scale * 1.4426950408889634f);
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
// block a (volume, head, group, rank) and row block, and key steps a tile
// over the busiest rank's score boxes and v's slice.
cudaError_t plan_sliced(int device, int b, int h, int s, int hd, int dtype, int* out) {
  const bool bf16 = dtype == 1;
  const void* kernel = bf16 ? (const void*)attention_sliced_wgmma_kernel
                            : (const void*)attention_sliced_f32_kernel;
  const size_t smem = bf16 ? SB_SMEM : SW_SMEM;
  cudaError_t err = bf16 ? sliced_wgmma_ready(device) : sliced_f32_ready(device);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WG_THREADS, smem);
  if (err != cudaSuccess) return err;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int cluster = 0, groups = 0;
  sliced_cluster(hd, &cluster, &groups);
  const long long units = (long long)b * h * groups * cluster;  // grid x
  const int keys = bf16 ? SB_KEYS : SW_KEYS, step = bf16 ? 16 : 8;
  const int row_blocks = (s + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int tiles = (s + ROWS - 1) / ROWS;
  const int chunks = (s + keys - 1) / keys;
  out[0] = BLOCK_ROWS;
  out[1] = WG_THREADS;
  out[2] = (int)smem;
  out[3] = attr.numRegs;
  out[4] = per_sm;
  out[5] = sms;
  out[6] = (int)(units * row_blocks);
  out[7] = (int)(units * tiles);
  out[8] = (int)(units * (tiles % CONSUMERS ? 1 : 0));
  // a chunk's key steps in each of the busiest rank's score boxes and in
  // the slice's p v (bf16: one wgmma of the slice's 256 columns a step; f32:
  // one a 64-column pass)
  const int nbox = (hd + (bf16 ? SB_BOX : SW_BOX) - 1) / (bf16 ? SB_BOX : SW_BOX);
  out[9] = chunks * (keys / step) * ((nbox + cluster - 1) / cluster + (bf16 ? 1 : SW_PASSES));
  out[10] = busiest_sm(units, row_blocks, CONSUMERS, tiles - (row_blocks - 1) * CONSUMERS,
                       (long long)per_sm * sms, sms);
  return cudaSuccess;
}

// A sliced body's cluster plan at (b, h, s, hd), into out[12]: ranks a
// cluster, groups a (volume, head), query rows a block, keys a chunk, ring
// stages (bf16: of the k ring and of the v ring each), score boxes (f32 32
// columns, bf16 64) of the busiest and the idlest rank, clusters in the
// grid, clusters the card holds at once (cudaOccupancyMaxActiveClusters),
// blocks, shared-memory bytes a block, registers a thread at entry (before
// setmaxnreg).
cudaError_t plan_sliced_cluster(int device, int b, int h, int s, int hd, bool bf16, int* out) {
  const void* kernel = bf16 ? (const void*)attention_sliced_wgmma_kernel
                            : (const void*)attention_sliced_f32_kernel;
  const size_t smem = bf16 ? SB_SMEM : SW_SMEM;
  cudaError_t err = bf16 ? sliced_wgmma_ready(device) : sliced_f32_ready(device);
  if (err != cudaSuccess) return err;
  int cluster = 0, groups = 0;
  sliced_cluster(hd, &cluster, &groups);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const int box = bf16 ? SB_BOX : SW_BOX;
  const int nbox = (hd + box - 1) / box;
  const long long clusters = (long long)b * h * groups * ((s + BLOCK_ROWS - 1) / BLOCK_ROWS);
  out[0] = cluster;
  out[1] = groups;
  out[2] = BLOCK_ROWS;
  out[3] = bf16 ? SB_KEYS : SW_KEYS;
  out[4] = bf16 ? SB_STAGES : SW_STAGES;
  out[5] = (nbox + cluster - 1) / cluster;
  out[6] = nbox / cluster;
  out[7] = (int)clusters;
  out[8] = resident;
  out[9] = (int)(clusters * cluster);
  out[10] = (int)smem;
  out[11] = fa.numRegs;
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
                     : launch_sliced_f32(device, q, k, v, o, b, h, s, hd, qs, ks, vs, scale, st));
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

// The sliced f32 and bf16 bodies' cluster plans at (b, h, s, hd > 256)
// into out[12] (see `plan_sliced_cluster`).  Return a cudaError_t.
extern "C" int attention_sliced_f32_plan(int device, int b, int h, int s, int hd, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd <= MAX_UNSLICED_HD) return (int)cudaErrorInvalidValue;
  return (int)plan_sliced_cluster(device, b, h, s, hd, false, out);
}

extern "C" int attention_sliced_bf16_plan(int device, int b, int h, int s, int hd, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd <= MAX_UNSLICED_HD) return (int)cudaErrorInvalidValue;
  return (int)plan_sliced_cluster(device, b, h, s, hd, true, out);
}

// The body this process's last launch took (enum Body), -1 before any.
extern "C" int attention_last_body() { return last_body.load(std::memory_order_relaxed); }

extern "C" const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

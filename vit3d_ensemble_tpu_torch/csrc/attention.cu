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
// operations on CUDA cores bound it (97 us at the 67 TFLOP/s peak).
//
// Which body takes which input: bf16 at head_dim 32, 64 and 128 runs the
// Hopper body below; f32 at every head_dim runs the CUDA-core body at the
// end (the JAX tolerance of 2e-5 rules out TF32 tensor cores).
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
// Layout: q, k, v are (B, H, S, hd) views with unit stride along hd and any
// strides (in elements) along B, H and S; for bf16 the base pointers and
// strides are multiples of 16 bytes (TMA's rule).  ctx is written (B, S, H,
// hd) contiguous, so that the model's merge of the heads is a view.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <vector>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int ROWS = 64;  // query rows of a tile (wgmma's M; the f32 body's block)
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
constexpr int STAGES = 4;                     // (k, v) stages in the ring

// The shared-memory tiles of one head_dim: 64 rows of hd bf16, stored as
// boxes of one swizzle row's width (64 values with the 128-byte swizzle, 32
// with the 64-byte one at hd 32), each 64 rows deep.
template <int HD>
struct Tile {
  static constexpr int SW = HD >= 64 ? 128 : 64;  // bytes of a swizzle row
  static constexpr int BOX_COLS = SW / 2;
  static constexpr int BOXES = HD / BOX_COLS;
  static constexpr int BOX_BYTES = ROWS * SW;
  static constexpr int BYTES = BOXES * BOX_BYTES;  // 64 rows of hd
  static constexpr uint32_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma's swizzle mode
  // Two blocks an SM where the registers allow: at hd 128 the consumers
  // need 64 context and 32 score accumulators and take one block an SM.
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

// Rows row .. row + 63 of one head, all hd columns, by TMA into `dst`.
template <int HD>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map, int order,
                                          uint64_t* bar, int row, int head, int batch) {
  using T = Tile<HD>;
  const int c1 = coord(order, 1, row, head, batch), c2 = coord(order, 2, row, head, batch),
            c3 = coord(order, 3, row, head, batch);
#pragma unroll
  for (int x = 0; x < T::BOXES; ++x)
    tma_load_4d(dst + x * T::BOX_BYTES, map, bar, x * T::BOX_COLS, c1, c2, c3);
}

// One chunk of NC keys (key0 ..) for this warpgroup's 64 query rows: scores,
// online softmax, ctx += p v.  Accumulator register 4j + 2i + e of
// m64nNk16 holds row 16 * warp + lane / 4 + 8i, column 8j + 2 * (lane % 4)
// + e; this thread's two rows are i = 0, 1.  `last`: keys at or past s are
// masked.
template <int HD, int NC>
__device__ __forceinline__ void chunk(float (&o)[HD / 2], float (&m)[2], float (&l)[2],
                                      const unsigned char* q_st, const unsigned char* k_st,
                                      const unsigned char* v_st, int key0, int s, bool last,
                                      float scale_log2) {
  using T = Tile<HD>;
  const int t = threadIdx.x % 4;

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

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, Tile<HD>::BLOCKS_PER_SM)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                       int s, int h, int orders, float scale_log2) {
  using T = Tile<HD>;
  extern __shared__ __align__(16) unsigned char att_smem[];
  // the swizzle atoms (8 rows of 128 bytes) must start 1024-byte aligned
  unsigned char* smem = att_smem + ((1024 - (smem_u32(att_smem) & 1023)) & 1023);
  unsigned char* q_st = smem;                           // [CONSUMERS][BYTES]
  unsigned char* k_st = q_st + CONSUMERS * T::BYTES;    // [STAGES][BYTES]
  unsigned char* v_st = k_st + STAGES * T::BYTES;       // [STAGES][BYTES]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_st + STAGES * T::BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const int row0 = blockIdx.y * BLOCK_ROWS;
  // consumers with a row below s; the last row block of S = 513 has one
  const int live = min(CONSUMERS, (s - row0 + ROWS - 1) / ROWS);
  const int chunks = (s + KEYS - 1) / KEYS;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
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
        const int st = i % STAGES;
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);  // at once on the first lap
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
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
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
    __nv_bfloat16* out = o + (((long long)b * s + r) * h + hh) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// f32 on CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;  // a 16 x 16 grid of threads

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (size_t)(ROWS * (HD + 1) + KEYS * (HD + 1) + KEYS * HD +
                                  ROWS * (KEYS + 1));
}

template <int HD>
__global__ void __launch_bounds__(F_THREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int s, int h,
                     Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int HP = HD + 1;    // padded rows: odd strides, no bank conflicts
  constexpr int PP = KEYS + 1;
  constexpr int OJ = HD / 16;   // context columns per thread
  extern __shared__ float smem[];
  float* qt = smem;             // [ROWS][HP]
  float* kt = qt + ROWS * HP;   // [KEYS][HP]
  float* vt = kt + KEYS * HP;   // [KEYS][HD]
  float* pt = vt + KEYS * HD;   // [ROWS][PP]

  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const int row0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  q += b * qs.b + hh * qs.h;
  k += b * ks.b + hh * ks.h;
  v += b * vs.b + hh * vs.h;

  for (int i = tid; i < ROWS * HD; i += F_THREADS) {
    const int r = i / HD, d = i % HD;
    qt[r * HP + d] = row0 + r < s ? q[(row0 + r) * qs.s + d] : 0.f;
  }

  // Rows ty + 16*i of the tile belong to this thread, with keys tx + 16*j of
  // a chunk in the first product and context columns tx + 16*j in the second.
  float acc[4][OJ];
  float mx[4], sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx[i] = -INFINITY;
    sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;
  }

  for (int j0 = 0; j0 < s; j0 += KEYS) {
    __syncthreads();  // the previous chunk's reads of kt, vt and pt are done
    for (int i = tid; i < KEYS * HD; i += F_THREADS) {
      const int j = i / HD, d = i % HD;
      const bool live = j0 + j < s;
      kt[j * HP + d] = live ? k[(j0 + j) * ks.s + d] : 0.f;
      vt[j * HD + d] = live ? v[(j0 + j) * vs.s + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qt[(ty + 16 * i) * HP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[(tx + 16 * j) * HP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // scale, mask the keys past s, and take the row's max over the chunk:
      // the 16 threads of a row are one half of a warp
      float top = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = j0 + tx + 16 * j < s ? sc[i][j] * scale : -INFINITY;
        top = fmaxf(top, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
      // the chunk holds a live key, so the new max is finite
      const float next = fmaxf(mx[i], top);
      const float corr = expf(mx[i] - next);  // 0 at the first chunk
      mx[i] = next;
      sum[i] *= corr;
#pragma unroll
      for (int j = 0; j < OJ; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - next);
        sum[i] += p;
        pt[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < KEYS; ++c) {
      float pv[4], vv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = pt[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < OJ; ++j) vv[j] = vt[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float total = sum[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
    const int r = row0 + ty + 16 * i;
    if (r >= s) continue;
    const float inv = 1.f / total;  // the sum holds its max's exp(0) = 1
    float* out = o + (((long long)b * s + r) * h + hh) * HD;
#pragma unroll
    for (int j = 0; j < OJ; ++j) out[tx + 16 * j] = acc[i][j] * inv;
  }
}
// The map of one (B, H, S, hd) bf16 view: hd innermost, then S, H and B in
// the order of their strides (smallest first), boxes of one swizzle row's
// width by 64 rows of S; rows past S load as zeros.  `order` gets the
// positions of the row, head and batch coordinates (see `coord`).  TMA needs
// a 16-byte aligned base and strides that are multiples of 16 bytes.
template <int HD>
bool encode_view(CUtensorMap* map, int* order, const void* base, int b, int h, int s,
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
  cuuint64_t dims[4] = {(cuuint64_t)HD, 0, 0, 0};
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
                T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 body's shared-memory limit, raised once a device.
template <int HD>
cudaError_t wgmma_ready(int device) {
  static std::atomic<unsigned long long> smem_set{0};  // one bit a device
  return raise_smem_limit_once((const void*)attention_wgmma_kernel<HD>, (int)Tile<HD>::SMEM,
                               device, smem_set);
}

template <int HD>
cudaError_t launch_wgmma(int device, const void* q, const void* k, const void* v, void* o,
                         int b, int h, int s, Strides qs, Strides ks, Strides vs, float scale,
                         cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  int oq, ok, ov;
  if (!encode_view<HD>(&map_q, &oq, q, b, h, s, qs) ||
      !encode_view<HD>(&map_k, &ok, k, b, h, s, ks) ||
      !encode_view<HD>(&map_v, &ov, v, b, h, s, vs))
    return cudaErrorInvalidValue;
  const cudaError_t err = wgmma_ready<HD>(device);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (s + BLOCK_ROWS - 1) / BLOCK_ROWS);
  attention_wgmma_kernel<HD><<<grid, WG_THREADS, Tile<HD>::SMEM, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), s, h, oq | (ok << 6) | (ov << 12),
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(int device, const void* q, const void* k, const void* v, void* o, int b,
                       int h, int s, Strides qs, Strides ks, Strides vs, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<HD>();
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err =
      raise_smem_limit_once((const void*)attention_f32_kernel<HD>, (int)smem, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (s + ROWS - 1) / ROWS);
  attention_f32_kernel<HD><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, h, qs, ks, vs, scale);
  return cudaGetLastError();
}

// The bf16 body's tiles and waves at one shape (see the note at the top).
template <int HD>
cudaError_t plan(int device, int b, int h, int s, int* out) {
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
  // Tiles on the busiest SM if every tile takes as long: blocks in the
  // grid's order (x the head, y the row block, so every head's last, fuller
  // or not, comes last), each wave of per_sm * sms blocks one a slot, slot i
  // on SM i % sms.
  const int last_tiles = tiles - (row_blocks - 1) * CONSUMERS;
  const long long slots = (long long)per_sm * sms;
  std::vector<int> load(sms > 0 ? sms : 1, 0);
  for (long long i = 0; i < bh * row_blocks && slots > 0; ++i)
    load[(i % slots) % sms] += i / bh < row_blocks - 1 ? CONSUMERS : last_tiles;
  out[10] = *std::max_element(load.begin(), load.end());
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v: (b, h, s, hd) views with unit
// stride along hd and the given strides (elements) along b, h and s; o is
// (b, s, h, hd) contiguous.  Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for a layout the bf16 body's tensor
// maps refuse (nothing launched).  b * h == 0 or s == 0 launches nothing.
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
                     ? launch_wgmma<HD>(device, q, k, v, o, b, h, s, qs, ks, vs, scale, st)   \
                     : launch_f32<HD>(device, q, k, v, o, b, h, s, qs, ks, vs, scale, st));
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (hd) {
    CASE(32) CASE(64) CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// The bf16 body's plan at (b, h, s, hd), into out[11]: rows a block, threads
// a block, shared-memory bytes a block, registers a thread (at entry, before
// setmaxnreg), blocks resident an SM, SMs, blocks, warpgroup tiles, blocks
// with a single live tile, 16-key steps a tile, warpgroup tiles on the
// busiest SM.  Returns a cudaError_t.
extern "C" int attention_plan(int device, int b, int h, int s, int hd, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (hd) {
    case 32: return (int)plan<32>(device, b, h, s, out);
    case 64: return (int)plan<64>(device, b, h, s, out);
    case 128: return (int)plan<128>(device, b, h, s, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

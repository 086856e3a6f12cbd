// The wide bodies of K1, K1b and K1c: out = gelu(x @ w1^T + b1)[:, :active]
// @ w2[:, :active]^T + b2 at every hidden size D above 64, with the model
// axis, in bf16 and f32.
//
// Replaces, at those widths, the TPU kernels `vit3d_ensemble_tpu/ops/
// pallas_mlp.py:_mlp_kernel` (K1, `fused_mlp.cu`), `_chunked_mlp_kernel`
// (K1b, `mlp_chunked.cu`) and `_pipelined2_mlp_kernel` (K1c,
// `mlp_pipelined.cu`); each library includes this file and has entries of
// its own.
//
// What bounds them on the H100: operations.  M / D is 4 in every published
// ViT, so 4 n D M multiply-adds at the tensor cores' peak (39 us at n =
// 4,104, D = 768 in bf16) exceed the time of every byte, and the (n, M)
// intermediate can no longer stay on chip: a full-D f32 accumulator is 196
// KB for 64 rows at D = 768.  So each body is two GEMM phases with h going
// through an (n, M) scratch that L2 mostly holds between them (25 MB at n =
// 4,104, D = 768 in bf16; the 50 MB L2 holds one model's, not five):
//   * fc1: h = gelu(x @ w1^T + b1), rounded once to the input type (the
//     rounding point of pallas_mlp.py:93), columns at or past the model's
//     width written as 0, over the column tiles that start below the width;
//   * fc2: out = h @ w2^T + b2, its K loop stopped at the model's width
//     rounded up to a stage (the scratch holds zeros past the width).
// The bf16 phases are warp-specialised GEMMs on `wgmma` m64nBNk16 (one
// producer thread keeps a ring of shared-memory stages loading with TMA,
// 128-byte swizzle, completion on mbarriers, zero fill past the edges; two
// consumer warpgroups of 64 rows each; `setmaxnreg` moves registers from the
// producer's warpgroup to theirs; the block is persistent).  The f32 phases
// run both products in 3xTF32 on `wgmma` m64n64k8 (`tf32x3.cuh`): the
// producer's warpgroup splits each B tile into TF32 hi and lo tiles, the
// consumers split A as it loads (ldmatrix) and promote their hi*hi and
// small-term accumulators into an f32 sum every 128 of K, since the tensor
// cores truncate inside a wgmma (`tests/test_torch_stretch.py` models it).
//
// The model axis.  Every launch takes `models` weight sets stacked along a
// leading axis: x (P, n, D), w1 (P, M, D), b1 (P, M), w2 (P, D, ld_w2), b2
// (P, D), h (P, n, ld_h), out (P, n, D), all contiguous.  The model is part
// of the unit index of the persistent grid, so one launch covers P times the
// tiles, and the operands are read and written through 3-D tensor maps whose
// outer dimension is the model (a box never crosses into the next model).
// Each model's width is read on the device (`widths`, one int32 a model) or
// given by the host for all (`width`), so a stacked call never waits for the
// host.  A model's tiles, K order and splits depend on (n, D, M) alone, never
// on P or the widths, so a model gives the same bits alone and stacked.
//
// The three kernels' forms:
//   * K1 (`wide_gemm_kernel`, `wide_tf32x3_kernel`): the two phases as two
//     launches.  bf16 fc2 tiles are 128 x 192 where one model's tiles fill
//     every SM (n = 4,104, D = 768: 132 tiles), else 128 x 64.  f32 phases
//     whose tiles fill fewer than half the SMs split their K (up to 8 ways,
//     never below 128 of K a split; `fused_mlp.wide_f32_plan`), the splits'
//     partial sums added in split order by `split_sum_kernel`: no float
//     atomics, the same bits every run.
//   * K1b: K1's form with fc2 summed in f32 over chunks of 512 hidden
//     columns, in chunk order (`_chunked_mlp_kernel`).  bf16: fc2's
//     accumulators start from 0 at every chunk and are added into an f32
//     running sum in registers at its end (128-column tiles: 64 + 64
//     registers).  f32: fc2's K splits are its chunks, each a split, so the
//     split sum adds the chunks in order (`WIDE_F32_CHUNK_STAGES`).  The
//     splits run in waves of at most T_MAX_WAVE (`launch_tf32x3`): each
//     wave's partial sums are added, in order, into a running sum kept in
//     the output, so the scratch holds T_MAX_WAVE partials, not M / 512
//     (19.4 GB at D 12,288, M 49,152, n 4,104), and the sum is the same
//     left fold in chunk order.
//   * K1c (`wide_queue_kernel`, `wide_queue_tf32x3_kernel`): one persistent
//     launch, the TPU kernel's pipeline across row tiles.  Its unit queue
//     (`Queue`) walks the (model, row tile) groups in order and puts the fc1
//     units of group g + L ahead of the fc2 units of group g: a lead of L
//     groups (`fused_mlp.k1c_wide_plan`: as many as half the L2 holds of h,
//     at least two waves of units, at most the groups), so an fc2 unit's h
//     was begun long before it and is still in L2.
//     Tickets: a block's producer thread takes its next unit with one
//     atomicAdd on a counter beside the ready counters (the ticket is the
//     unit's place in the queue) when its ring has room, and hands it to the
//     block's other threads through shared memory and an mbarrier.  A bf16
//     fc1 unit's GELU tile goes through a shared-memory staging tile and TMA
//     stores, which a storer thread of the producer's warpgroup issues; once
//     they have completed (`cp.async.bulk.wait_group 0`, not `.read`), a
//     `fence.proxy.async.global` orders them before `red.release.gpu`, which
//     adds one to the group's ready counter in global memory.  (f32 stores h
//     from registers, as K1's f32 body does, then `__threadfence` and the
//     same release.)  The producer of an fc2 unit spins on one thread until
//     the counter holds the group's live fc1 tiles (`ld.acquire.gpu`, then
//     `fence.proxy.async.global` before its TMA reads of h).  The waits
//     cannot deadlock on any grid: only a running block takes a ticket, an
//     fc2 unit waits only on fc1 units of smaller tickets, and the unit of
//     the smallest ticket not yet done always runs (its block's earlier
//     units are done, and it waits on nothing later).  bf16 fc1 and fc2
//     stages each take their own bytes in one ring (`RingPos`: stages are
//     placed one after another, wrapping to the start, and the producer
//     waits on the latest stage whose bytes a new one reuses).  Only the
//     schedule differs from K1: its tiles and K order are K1's where K1 does
//     not split K, so there it gives K1's bits, alone or stacked.
//
// Sizes: no upper bound on D or M.  Every element offset into x, h, out
// and the partial sums is taken in 64 bits (a model's n M passes 2^31 at D
// 16,384; P n D of a stack passes it too); tile, unit, stage and ticket
// counts stay 32-bit, and a launch whose units would not fit is refused
// (`units_fit`): at most n M / 16,384 fc1 units a model, far below 2^31 for
// any h the card holds.  Tensor-map coordinates are 32-bit per dimension
// (a row or column, never a product).
//
// TMA needs 16-byte rows: D is a multiple of 8 (bf16) or 4 (f32), and
// ld_h, ld_w2 are M rounded up to 8 or 4 (the wrapper, `ops/fused_mlp.py`,
// hands any other D over zero-padded, and w2 as a zero-padded copy where M is
// not a multiple).

#pragma once

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "mlp_common.cuh"
#include "sm90_common.cuh"
#include "tf32x3.cuh"

// Internal linkage: each library that includes this file keeps its own
// kernels and once-a-device flags (see `mlp_narrow_f32.cuh`).
namespace wide {
namespace {

using namespace mlp;
using namespace sm90;
using namespace tf32x3;
using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The wide regime's hidden sizes: above 64, rows of a multiple of 16 bytes
// (`align` elements).
inline bool is_wide(int d, int align) { return d > 64 && d % align == 0; }

// One GEMM phase over `models` stacked weight sets: per model, row_tiles x
// col_tiles output tiles of bm x bn, K in k_steps stages of bk, in `splits`
// K splits (split s takes stages [s K / S, (s + 1) K / S), or with
// split_steps > 0 [s split_steps, (s + 1) split_steps)), of which a launch
// runs `wave` from `split0` on (all of them, but in K1b's f32 fc2).  fc1: a
// model's width bounds its output columns; fc2: its K.  Widths: widths[p]
// on the device, or `width` for every model when widths is null; clamped to
// [0, m].
struct Phase {
  int n, models, row_tiles, col_tiles, k_steps, splits, split_steps, fc1, m, width;
  const int* widths;
  int bm, bn, bk;
  int split0, wave;
};

// A unit of a phase: its model, first row and column, stages [k0, k1), its
// K split's place in the launch's wave (its partial sums' slot), the
// model's width, and whether it computes anything (an fc1 tile at or past
// the width does not).
struct Work {
  int p, row0, col0, k0, k1, split, width;
  bool live;
};

__device__ __forceinline__ Work work_at(const Phase& ph, int p, int row_tile, int col_tile,
                                        int s) {
  Work w;
  w.p = p;
  w.split = s;
  w.row0 = row_tile * ph.bm;
  w.col0 = col_tile * ph.bn;
  const int ks = ph.split0 + s;  // the K split
  if (ph.split_steps > 0) {
    w.k0 = ks * ph.split_steps;
    w.k1 = min(w.k0 + ph.split_steps, ph.k_steps);
  } else {
    w.k0 = (int)((long long)ks * ph.k_steps / ph.splits);
    w.k1 = (int)((long long)(ks + 1) * ph.k_steps / ph.splits);
  }
  w.width = min(max(ph.widths != nullptr ? ph.widths[p] : ph.width, 0), ph.m);
  w.live = !ph.fc1 || w.col0 < w.width;
  if (!ph.fc1) w.k1 = max(w.k0, min(w.k1, cdiv(w.width, ph.bk)));
  return w;
}

// Unit u of a phase's launch (`fused_mlp.wide_f32_unit` at split0 0): u =
// (s * P + p) * tiles + t, s the split's place in the wave, tile t at row
// tile t / col_tiles and column tile t % col_tiles.
__device__ __forceinline__ Work work_of(const Phase& ph, int u) {
  const int tiles = ph.row_tiles * ph.col_tiles;
  const int t = u % tiles, ps = u / tiles;
  return work_at(ph, ps % ph.models, t / ph.col_tiles, t % ph.col_tiles, ps / ph.models);
}

__host__ __device__ __forceinline__ int units_of(const Phase& ph) { return ph.models * ph.row_tiles * ph.col_tiles * ph.wave; }

// Whether a launch over x (models, n, d) and h (models, n, m) numbers its
// units, tiles and tickets in 32 bits: both phases' units at the most K
// splits a wave (fc2's tiles on the narrowest, 64-column, tiles).
inline bool units_fit(int n, int d, int m, int models) {
  const long long tiles = (long long)models * cdiv(n, 64) * (cdiv(m, 64) + cdiv(d, 64));
  return tiles * 8 < (1ll << 31);
}

// K1c's unit queue (`fused_mlp.k1c_wide_unit`) over `groups` (model, row
// tile) groups g = p * row_tiles + r, each with `a` fc1 units (column tiles of
// h) and `b` fc2 units (column tiles of out), with a lead of `lead` groups (1
// <= lead <= groups): fc1(0), ..., fc1(lead - 1), then for each g, fc1(g +
// lead) (while there is one) and fc2(g).  `ready[g]` counts g's fc1 units
// stored, `ready[groups]` the tickets taken; all start at 0.
struct Queue {
  int groups, a, b, lead;
  int* ready;
};

__device__ __forceinline__ void queue_unit(const Queue& q, int u, bool* fc1, int* g, int* tile) {
  const int head = q.lead * q.a, both = (q.groups - q.lead) * (q.a + q.b);
  if (u < head) {
    *fc1 = true, *g = u / q.a, *tile = u % q.a;
  } else if (u - head < both) {
    const int i = (u - head) / (q.a + q.b), r = (u - head) % (q.a + q.b);
    *fc1 = r < q.a, *g = r < q.a ? i + q.lead : i, *tile = r < q.a ? r : r - q.a;
  } else {
    const int v = u - head - both;
    *fc1 = false, *g = q.groups - q.lead + v / q.b, *tile = v % q.b;
  }
}

// Units the producer thread may hand the block's other threads ahead of them.
constexpr int HAND_SLOTS = 4;

// The hand-off of tickets inside a block: slot k % HAND_SLOTS holds the
// block's k-th ticket; `full` takes the producer's arrival, `empty` one from
// each thread that reads it.
struct Handoff {
  uint64_t full[HAND_SLOTS], empty[HAND_SLOTS];
  int unit[HAND_SLOTS];
};

__device__ __forceinline__ void init_handoff(Handoff* hand, int readers) {
  for (int s = 0; s < HAND_SLOTS; ++s) {
    mbar_init(&hand->full[s], 1);
    mbar_init(&hand->empty[s], readers);
  }
}

// The producer thread's k-th ticket, handed on: the queue's next unit.
__device__ __forceinline__ int take_ticket(const Queue& q, Handoff* hand, int k) {
  const int u = atomicAdd(q.ready + q.groups, 1);
  const int s = k % HAND_SLOTS;
  mbar_wait(&hand->empty[s], ((k / HAND_SLOTS) & 1) ^ 1);  // at once on the first lap
  hand->unit[s] = u;
  mbar_arrive(&hand->full[s]);
  return u;
}

// The block's k-th ticket, as a reading thread receives it.
__device__ __forceinline__ int next_ticket(Handoff* hand, int k) {
  const int s = k % HAND_SLOTS;
  mbar_wait(&hand->full[s], (k / HAND_SLOTS) & 1);
  const int u = *reinterpret_cast<volatile int*>(&hand->unit[s]);
  mbar_arrive(&hand->empty[s]);
  return u;
}

// An fc1 unit's h tile is written (f32: plain stores, then __threadfence):
// its writes, visible to every proxy at the device's scope, then one more
// for its group (CUTLASS's semaphore release).
__device__ __forceinline__ void signal_ready(int* ready) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(ready), "r"(1) : "memory");
}

// The issuing thread's TMA stores have completed: their writes are done, not
// only their reads of shared memory.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Wait until `ready` holds `target` (acquire), then order this thread's TMA
// reads after it.  A wait of 2^35 clocks (~20 s) traps, as `mbar_wait` does.
__device__ __forceinline__ void wait_ready(const int* ready, int target) {
  long long start = 0;
  while (true) {
    int v;
    asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(ready) : "memory");
    if (v >= target) break;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
    __nanosleep(64);
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Barriers of a ring of `stages` stages: `full` (one arrival and the bytes),
// `ready` (`ready_count` arrivals; none when null) and `empty` (one arrival
// from each consumer warpgroup).
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* ready, uint64_t* empty,
                                          int stages, int ready_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      if (ready != nullptr) mbar_init(&ready[s], ready_count);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised GEMMs on wgmma, fed by TMA.
// ---------------------------------------------------------------------------

constexpr int G_BK = 64;       // k of a stage: 64 bf16 = one 128-byte swizzle row
constexpr int G_BM = 128;      // rows of a tile
constexpr int G_THREADS = 384; // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int FC1_BN = 128;    // fc1's tile: 128 x 128 of h
// fc2's tile: 128 x 192 of the output where one model's tiles fill every SM
// (the stretch model's n = 4,104 at D = 768: 132 tiles), else 128 x 64 (n =
// 513: 60 tiles, where 128 x 192 would leave 112 of 132 SMs idle); K1b's
// 128 x 128 (its running sum doubles the accumulators' registers) or 64
constexpr int FC2_BN_WIDE = 192, FC2_BN_NARROW = 64, K1B_BN_WIDE = 128;
constexpr int CHUNK_STEPS = 512 / G_BK;  // K1b's summation chunk in k-steps

// The stages fill the shared memory left after the epilogue's staging tile
// (TMA stores) and its barriers.
template <int BN>
struct GemmShape {
  static constexpr int A_BYTES = G_BM * G_BK * 2;
  static constexpr int B_BYTES = BN * G_BK * 2;
  static constexpr int C_BYTES = G_BM * BN * 2;
  static constexpr int STAGES_FIT = (225 * 1024 - 2048 - C_BYTES - 256) / (A_BYTES + B_BYTES);
  static constexpr int STAGES = STAGES_FIT < 8 ? STAGES_FIT : 8;
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * (A_BYTES + B_BYTES) + C_BYTES + 2 * STAGES * sizeof(uint64_t);
  static_assert(STAGES >= 2, "the ring needs two stages");
};

// The producer's loads of one unit: stages [w.k0, w.k1) of A (rows w.row0..)
// and B (rows w.col0..: `b_rows` of them) of model w.p into the ring.
template <class S>
__device__ __forceinline__ void load_unit(const Work& w, const CUtensorMap* map_a,
                                          const CUtensorMap* map_b, int b_rows,
                                          unsigned char* a_st, unsigned char* b_st,
                                          uint64_t* full, uint64_t* empty, int& it) {
  for (int kt = w.k0; kt < w.k1; ++kt, ++it) {
    const int s = it % S::STAGES;
    mbar_wait(&empty[s], ((it / S::STAGES) & 1) ^ 1);  // at once on the first lap
    mbar_expect_tx(&full[s], S::A_BYTES + b_rows * G_BK * 2);
    tma_load_3d(a_st + s * S::A_BYTES, map_a, &full[s], kt * G_BK, w.row0, w.p);
    tma_load_3d(b_st + s * S::B_BYTES, map_b, &full[s], kt * G_BK, w.col0, w.p);
  }
}

// Consumer warpgroup c's k-steps [k0, k1) of one unit, on rows 64c .. 64c +
// 63 of the tile: acc = A B^T, one k-step's wgmmas in flight behind the
// next; a stage goes back to the producer once the wgmma that read it has
// retired.  With CHUNK, acc ends as the f32 sum, in order, of each chunk's
// A B^T (k-steps [CHUNK i, CHUNK (i + 1))), each chunk's wgmmas started
// from 0.
template <int BN, int CHUNK, class S>
__device__ __forceinline__ void gemm_steps(float (&acc)[BN / 2], const unsigned char* a_st,
                                           const unsigned char* b_st, uint64_t* full,
                                           uint64_t* empty, int k0, int k1, int& it, int c,
                                           int tid) {
  float sum[CHUNK ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if constexpr (CHUNK > 0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
  }
  fence_regs(acc);
  int pending = -1;  // the stage of the k-step still in flight
  for (int kt = k0; kt < k1; ++kt, ++it) {
    const int s = it % S::STAGES;
    mbar_wait(&full[s], (it / S::STAGES) & 1);
    const uint64_t da = smem_desc(a_st + s * S::A_BYTES + c * 8192, 16, 1024, 1);
    const uint64_t db = smem_desc(b_st + s * S::B_BYTES, 16, 1024, 1);
    const bool fresh = CHUNK > 0 && kt % (CHUNK > 0 ? CHUNK : 1) == 0;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G_BK / 16; ++kk)
      wgmma<BN>(acc, da + 2 * kk, db + 2 * kk, !(fresh && kk == 0));
    wgmma_commit();
    if (CHUNK > 0 && (kt % (CHUNK > 0 ? CHUNK : 1) == CHUNK - 1 || kt == k1 - 1)) {
      wgmma_wait<0>();  // the chunk's last k-step: promote its sum
      fence_regs(acc);
      if (tid == 0) {
        if (pending >= 0) mbar_arrive(&empty[pending]);
        mbar_arrive(&empty[s]);
      }
      pending = -1;
      if constexpr (CHUNK > 0) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
      }
    } else {
      wgmma_wait<1>();  // the k-step before this one has been read
      fence_regs(acc);
      if (tid == 0 && pending >= 0) mbar_arrive(&empty[pending]);
      pending = s;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (tid == 0 && pending >= 0) mbar_arrive(&empty[pending]);
  if constexpr (CHUNK > 0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i];
  }
}

// + bias[col] (zero at and past `cols`); GELU: then the bf16 GELU
// (`gelu_poly`), and columns at or past `cols` written as 0.  Register
// 4j + 2i + e of m64nBNk16's accumulator holds row 16 * warp + lane / 4 +
// 8i, column 8j + 2 * (lane % 4) + e; `emit(j, i, col, v0, v1)` takes the
// pair at column col.
template <int BN, bool GELU, class Emit>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], const bf16* bias, int cols,
                                         int col0, int lane, Emit emit) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * (lane % 4);
    const float bb0 = col < cols ? __bfloat162float(bias[col]) : 0.f;
    const float bb1 = col + 1 < cols ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = acc[4 * j + 2 * i] + bb0, v1 = acc[4 * j + 2 * i + 1] + bb1;
      if constexpr (GELU) {
        // the bf16 GELU in f32, rounded once to bf16 (pallas_mlp.py:93);
        // columns past the width mask are exact zeros
        v0 = col < cols ? gelu_poly(v0) : 0.f;
        v1 = col + 1 < cols ? gelu_poly(v1) : 0.f;
      }
      emit(j, i, col, v0, v1);
    }
  }
}

// out = epilogue(A @ B^T) over a phase's (128, BN) tiles of every model,
// both operands K-major bf16 behind 3-D TMA maps (model outermost), the
// result out in bf16, one rounding, through a 128-byte-swizzled staging
// tile and TMA stores (clipped at the edges).  Persistent: block b takes
// units b, b + gridDim.x, ...; warpgroup 0's thread 0 keeps the ring loading
// across the block's units, so the next unit's loads run under this one's
// epilogue.  bias: b1 (GELU: fc1, bound by the model's width) or b2 (fc2,
// bound by `bias_cols`), `bias_ld` apart between models.
template <int BN, bool GELU, int CHUNK>
__global__ void __launch_bounds__(G_THREADS, 1)
wide_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out, const bf16* __restrict__ bias,
                 int bias_ld, int bias_cols, const Phase ph) {
  using S = GemmShape<BN>;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  // the swizzle atoms (8 rows of 128 bytes) must start 1024-byte aligned
  unsigned char* smem = gemm_smem + ((1024 - (smem_u32(gemm_smem) & 1023)) & 1023);
  unsigned char* a_st = smem;                        // [STAGES][128][64]
  unsigned char* b_st = a_st + S::STAGES * S::A_BYTES;  // [STAGES][BN][64]
  unsigned char* c_st = b_st + S::STAGES * S::B_BYTES;  // [2][BN/64][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(c_st + S::C_BYTES);
  uint64_t* empty = full + S::STAGES;
  const int units = units_of(ph);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  init_ring(full, nullptr, empty, S::STAGES, 0);

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Work w = work_of(ph, u);
        if (w.live) load_unit<S>(w, &map_a, &map_b, BN, a_st, b_st, full, empty, it);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, lane = tid % 32, warp = tid / 32;
  unsigned char* stage_c = c_st + c * (BN / 64) * 8192;  // this warpgroup's 64 rows
  float acc[BN / 2];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Work w = work_of(ph, u);
    if (!w.live) continue;
    gemm_steps<BN, CHUNK, S>(acc, a_st, b_st, full, empty, w.k0, w.k1, it, c, tid);
    // the last unit's stores have read the staging tile
    if (tid == 0) tma_store_wait_read();
    bar_sync(1 + c, 128);
    epilogue<BN, GELU>(acc, bias + (size_t)w.p * bias_ld, GELU ? w.width : bias_cols, w.col0,
                       lane, [&](int j, int i, int, float v0, float v1) {
                         // the staging tile of 64 columns is swizzled as TMA's
                         // 128-byte mode expects: 16-byte chunk q of row r lies
                         // at chunk q ^ (r % 8)
                         const int r = 16 * warp + lane / 4 + 8 * i;
                         const int chunk = (j % 8) ^ (r % 8);
                         *reinterpret_cast<uint32_t*>(stage_c + (j / 8) * 8192 + r * 128 +
                                                      chunk * 16 + (lane % 4) * 4) =
                             pack_bf16(v0, v1);
                       });
    // the generic-proxy writes above, visible to TMA; then one thread stores
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + c, 128);
    if (tid == 0) {
#pragma unroll
      for (int q = 0; q < BN / 64; ++q)
        tma_store_3d(&map_out, stage_c + q * 8192, w.col0 + 64 * q, w.row0 + 64 * c, w.p);
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait_read();  // before the block's shared memory goes
}

// K1c's bf16 shared memory: a ring of stages, each A (128 x 64) then B
// (fc1: 128 x 64 of w1, fc2: BN2 x 64 of w2), every stage of its own unit's
// size (`RingPos`); the epilogue's staging tile (two 64-row halves of the
// wider of the two tiles, in boxes of 64 columns); the barriers, the
// tickets' hand-off and the store descriptor.
template <int BN2>
struct QueueShape {
  static constexpr int BNS = BN2 > FC1_BN ? BN2 : FC1_BN;
  static constexpr int A_BYTES = G_BM * G_BK * 2;
  static constexpr int FC1_STAGE = A_BYTES + FC1_BN * G_BK * 2;
  static constexpr int FC2_STAGE = A_BYTES + BN2 * G_BK * 2;
  static constexpr int C_BYTES = G_BM * BNS * 2;
  static constexpr int SLOTS = 8;     // barriers of the ring: stages in flight at most
  static constexpr int CONTROL = 512;  // barriers, hand-off, store descriptor
  // all of the 227 KB a block may have, but the alignment's slack
  static constexpr int RING = (232448 - 1024 - C_BYTES - CONTROL) / 1024 * 1024;
  static constexpr size_t SMEM = 1024 + (size_t)RING + C_BYTES + CONTROL;
  static_assert(RING >= 2 * FC1_STAGE && RING >= 2 * FC2_STAGE, "the ring needs two stages");
  static_assert(RING / FC1_STAGE <= SLOTS && RING / FC2_STAGE <= SLOTS,
                "a stage in flight a barrier");
  static_assert(FC1_STAGE % 1024 == 0 && FC2_STAGE % 1024 == 0 && RING / 1024 < 256,
                "stages start on swizzle atoms; the producer keeps their bounds in KB, 8 bits");
};

// A stage's place in K1c's ring: the next stage starts where the last one
// ended, or at 0 where it would run past the end.  Producer and consumers
// place the same stages in the same order, so they agree on every offset.
struct RingPos {
  int it = 0, off = 0;  // stages placed; where the next one may start
  __device__ __forceinline__ int place(int bytes, int cap) {
    if (off + bytes > cap) off = 0;
    const int at = off;
    off += bytes;
    ++it;
    return at;
  }
};

// Before the producer fills stage `it` at bytes [at, end): the consumers
// must have read the latest earlier stage whose bytes it overlaps, and the
// stage that last used its barriers (it - SLOTS).  They free stages in
// order, so that one stage suffices.  starts / ends keep the last SLOTS
// stages' bounds in KB, 8 bits a stage.
template <int SLOTS>
__device__ __forceinline__ void ring_wait(uint64_t* empty, uint64_t& starts, uint64_t& ends,
                                          int it, int at, int end) {
  int wait_for = it - SLOTS;
  const int lo = at >> 10, hi = end >> 10;
#pragma unroll
  for (int back = 1; back < SLOTS; ++back) {
    const int j = it - back, shift = 8 * (j % SLOTS);
    if (j < 0) break;
    if ((int)((starts >> shift) & 255) < hi && lo < (int)((ends >> shift) & 255)) {
      wait_for = j;
      break;
    }
  }
  if (wait_for >= 0) mbar_wait(&empty[wait_for % SLOTS], (wait_for / SLOTS) & 1);
  const int shift = 8 * (it % SLOTS);
  starts = (starts & ~(255ull << shift)) | ((uint64_t)lo << shift);
  ends = (ends & ~(255ull << shift)) | ((uint64_t)hi << shift);
}

// Consumer warpgroup c's k-steps [k0, k1) of one unit from K1c's ring, rows
// 64c .. 64c + 63 of the tile: gemm_steps's wgmmas in its order (so K1's
// bits), each stage at the place `pos` gives it.
template <int BN, class S>
__device__ __forceinline__ void ring_steps(float (&acc)[BN / 2], const unsigned char* ring,
                                           RingPos& pos, uint64_t* full, uint64_t* empty, int k0,
                                           int k1, int c, int tid) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  int pending = -1;  // the stage of the k-step still in flight
  for (int kt = k0; kt < k1; ++kt) {
    const int at = pos.place(S::A_BYTES + BN * G_BK * 2, S::RING), it = pos.it - 1;
    const int s = it % S::SLOTS;
    mbar_wait(&full[s], (it / S::SLOTS) & 1);
    const uint64_t da = smem_desc(ring + at + c * 8192, 16, 1024, 1);
    const uint64_t db = smem_desc(ring + at + S::A_BYTES, 16, 1024, 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G_BK / 16; ++kk) wgmma<BN>(acc, da + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<1>();  // the k-step before this one has been read
    fence_regs(acc);
    if (tid == 0 && pending >= 0) mbar_arrive(&empty[pending]);
    pending = s;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (tid == 0 && pending >= 0) mbar_arrive(&empty[pending]);
}

// K1c's bf16 body: fc1 (128 x 128 tiles of h, bf16 GELU) and fc2 (128 x BN2
// tiles of out) units in `Queue`'s order, taken by ticket, in one persistent
// launch on any grid.  Warpgroup 0: thread 0 takes the tickets and loads the
// ring, thread 32 stores each staged tile by TMA (map_h_out, map_out: boxes
// of 64 x 64) and releases fc1's group once the stores have completed;
// warpgroups 1 and 2 take 64 rows each and stage the epilogue's tile.
template <int BN2>
__global__ void __launch_bounds__(G_THREADS, 1)
wide_queue_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w1,
                  const __grid_constant__ CUtensorMap map_h,
                  const __grid_constant__ CUtensorMap map_w2,
                  const __grid_constant__ CUtensorMap map_h_out,
                  const __grid_constant__ CUtensorMap map_out, const bf16* __restrict__ b1,
                  const bf16* __restrict__ b2, int d, const Phase ph1, const Phase ph2,
                  const Queue q) {
  using S = QueueShape<BN2>;
  extern __shared__ __align__(16) unsigned char queue_smem[];
  unsigned char* ring = queue_smem + ((1024 - (smem_u32(queue_smem) & 1023)) & 1023);
  unsigned char* c_st = ring + S::RING;  // [2][BNS/64][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(c_st + S::C_BYTES);
  uint64_t* empty = full + S::SLOTS;
  uint64_t* staged = empty + S::SLOTS;  // both warpgroups' halves are staged
  uint64_t* staging_free = staged + 1;  // the storer has read them
  Handoff* hand = reinterpret_cast<Handoff*>(staging_free + 1);
  // the staged tile: model (< 0: no more), first row, first column, and the
  // fc1 group to release (< 0: an fc2 tile)
  volatile int* desc = reinterpret_cast<volatile int*>(hand + 1);
  const int units = q.groups * (q.a + q.b);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(staged, 2);
    mbar_init(staging_free, 1);
    init_handoff(hand, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {  // the tickets and the loads
      RingPos pos;
      uint64_t starts = 0, ends = 0;
      for (int k = 0;; ++k) {
        const int u = take_ticket(q, hand, k);
        if (u >= units) break;
        bool fc1;
        int g, tile;
        queue_unit(q, u, &fc1, &g, &tile);
        const Work w = work_at(fc1 ? ph1 : ph2, g / ph1.row_tiles, g % ph1.row_tiles, tile, 0);
        if (!w.live) continue;
        if (!fc1 && w.k1 > w.k0) wait_ready(q.ready + g, cdiv(w.width, FC1_BN));
        const int b_rows = fc1 ? FC1_BN : BN2, bytes = S::A_BYTES + b_rows * G_BK * 2;
        for (int kt = w.k0; kt < w.k1; ++kt) {
          const int at = pos.place(bytes, S::RING), it = pos.it - 1, s = it % S::SLOTS;
          ring_wait<S::SLOTS>(empty, starts, ends, it, at, at + bytes);
          mbar_expect_tx(&full[s], bytes);
          tma_load_3d(ring + at, fc1 ? &map_x : &map_h, &full[s], kt * G_BK, w.row0, w.p);
          tma_load_3d(ring + at + S::A_BYTES, fc1 ? &map_w1 : &map_w2, &full[s], kt * G_BK,
                      w.col0, w.p);
        }
      }
    } else if (tid == 32) {  // the stores
      for (int e = 0;; ++e) {
        mbar_wait(staged, e & 1);
        const int p = desc[0], row0 = desc[1], col0 = desc[2], g = desc[3];
        if (p < 0) break;
        const int boxes = (g >= 0 ? FC1_BN : BN2) / 64;
        for (int half = 0; half < 2; ++half)
          for (int b = 0; b < boxes; ++b)
            tma_store_3d(g >= 0 ? &map_h_out : &map_out,
                         c_st + (half * (S::BNS / 64) + b) * 8192, col0 + 64 * b,
                         row0 + 64 * half, p);
        tma_store_commit();
        tma_store_wait_read();
        mbar_arrive(staging_free);
        if (g >= 0) {
          tma_store_wait_all();
          signal_ready(q.ready + g);
        }
      }
      tma_store_wait_all();  // before the block's shared memory goes
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, lane = tid % 32, warp = tid / 32;
  unsigned char* stage_c = c_st + c * (S::BNS / 64) * 8192;  // this warpgroup's 64 rows
  RingPos pos;
  int staged_tiles = 0;
  // the staging tile is free once the storer has read the last one
  const auto wait_staging = [&] {
    if (staged_tiles > 0) mbar_wait(staging_free, (staged_tiles - 1) & 1);
  };
  // this warpgroup's half is written: visible to TMA, then the storer's,
  // with the tile's descriptor
  const auto hand_staged = [&](int p, int row0, int col0, int g) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + c, 128);
    if (tid == 0) {
      if (c == 0) desc[0] = p, desc[1] = row0, desc[2] = col0, desc[3] = g;
      mbar_arrive(staged);
    }
    ++staged_tiles;
  };
  // the staging tile of 64 columns a box is swizzled as TMA's 128-byte mode
  // expects: 16-byte chunk q of row r lies at chunk q ^ (r % 8)
  const auto emit = [&](int j, int i, int, float v0, float v1) {
    const int r = 16 * warp + lane / 4 + 8 * i;
    *reinterpret_cast<uint32_t*>(stage_c + (j / 8) * 8192 + r * 128 +
                                 (((j % 8) ^ (r % 8)) * 16) + (lane % 4) * 4) = pack_bf16(v0, v1);
  };
  for (int k = 0;; ++k) {
    const int u = next_ticket(hand, k);
    if (u >= units) break;
    bool fc1;
    int g, tile;
    queue_unit(q, u, &fc1, &g, &tile);
    const Work w = work_at(fc1 ? ph1 : ph2, g / ph1.row_tiles, g % ph1.row_tiles, tile, 0);
    if (!w.live) continue;  // an fc1 tile at or past the width: its group waits on none
    if (fc1) {
      float acc[FC1_BN / 2];
      ring_steps<FC1_BN, S>(acc, ring, pos, full, empty, w.k0, w.k1, c, tid);
      wait_staging();
      epilogue<FC1_BN, true>(acc, b1 + (size_t)w.p * ph1.m, w.width, w.col0, lane, emit);
    } else {
      float acc[BN2 / 2];
      ring_steps<BN2, S>(acc, ring, pos, full, empty, w.k0, w.k1, c, tid);
      wait_staging();
      epilogue<BN2, false>(acc, b2 + (size_t)w.p * d, d, w.col0, lane, emit);
    }
    hand_staged(w.p, w.row0, w.col0, fc1 ? g : -1);
  }
  wait_staging();
  hand_staged(-1, 0, 0, -1);  // no more tiles: the storer ends
}

// The maps of a bf16 GEMM's operands: (models, rows, cols) with rows `ld`
// apart, read in boxes of 64 columns by `box_rows` rows, 128-byte swizzle.
inline bool bf16_map(CUtensorMap* map, const void* base, int models, int rows, int cols, int ld,
                     int box_rows) {
  return encode_map_3d(map, base, models, rows, cols, ld, G_BK, box_rows, 128, 2);
}

// One bf16 phase of K1's or K1b's form on a persistent grid of at most one
// block an SM.
template <int BN, bool GELU, int CHUNK>
cudaError_t launch_gemm(int device, const CUtensorMap& map_a, const CUtensorMap& map_b,
                        const CUtensorMap& map_out, const void* bias, int bias_ld,
                        int bias_cols, const Phase& ph, int sms, cudaStream_t stream) {
  using S = GemmShape<BN>;
  auto* kernel = wide_gemm_kernel<BN, GELU, CHUNK>;
  static std::atomic<unsigned long long> smem_set{0};  // one bit a device
  const cudaError_t err =
      raise_smem_limit_once((const void*)kernel, (int)S::SMEM, device, smem_set);
  if (err != cudaSuccess) return err;
  const int units = units_of(ph);
  kernel<<<std::min(units, sms), G_THREADS, S::SMEM, stream>>>(
      map_a, map_b, map_out, static_cast<const bf16*>(bias), bias_ld, bias_cols, ph);
  return cudaGetLastError();
}

// A phase's description from its shape (one split).
inline Phase bf16_phase(int n, int models, int col_tiles, int k_steps, bool fc1, int m,
                        int width, const int* widths, int bn) {
  return {n, models, cdiv(n, G_BM), col_tiles, k_steps, 1, 0, fc1 ? 1 : 0, m, width, widths,
          G_BM, bn, G_BK, 0, 1};
}

// The arguments of a wide launch's operands, checked: x (P, n, d), w1 (P,
// m, d), b1 (P, m), w2 (P, d, ld_w2), b2 (P, d), h (P, n, ld_h), out (P, n, d),
// every base 16-byte aligned; `align` elements a 16-byte row.
inline bool wide_shape_ok(int n, int d, int m, int ld_w2, int ld_h, int models, int align) {
  return is_wide(d, align) && m >= 1 && ld_w2 >= m && ld_w2 % align == 0 && ld_h >= m &&
         ld_h % align == 0 && models >= 1 && n >= 0 && units_fit(n, d, m, models);
}

// K1's (CHUNK 0) or K1b's (CHUNK_STEPS) bf16 form: fc1 + GELU into h, then
// fc2 + b2 from it.  fc2's tile: K1's 192 or K1b's 128 columns where one
// model's tiles fill every SM, else 64; from (n, d) alone.
template <int CHUNK>
cudaError_t run_bf16(int device, const void* x, const void* w1, const void* b1, const void* w2,
                     int ld_w2, const void* b2, void* h, int ld_h, void* out, int n, int d,
                     int m, int width, const int* widths, int models, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int rows = cdiv(n, G_BM);
  CUtensorMap mx, mw1, mh_out, mh_in, mw2, mout;
  constexpr int WIDE = CHUNK > 0 ? K1B_BN_WIDE : FC2_BN_WIDE;
  const bool wide_tiles = rows * cdiv(d, WIDE) >= sms;
  const int bn2 = wide_tiles ? WIDE : FC2_BN_NARROW;
  if (!bf16_map(&mx, x, models, n, d, d, G_BM) || !bf16_map(&mw1, w1, models, m, d, d, FC1_BN) ||
      !bf16_map(&mh_out, h, models, n, ld_h, ld_h, 64) ||
      !bf16_map(&mh_in, h, models, n, ld_h, ld_h, G_BM) ||
      !bf16_map(&mw2, w2, models, d, m, ld_w2, bn2) ||
      !bf16_map(&mout, out, models, n, d, d, 64))
    return cudaErrorInvalidValue;
  const Phase fc1 = bf16_phase(n, models, cdiv(m, FC1_BN), cdiv(d, G_BK), true, m, width,
                               widths, FC1_BN);
  err = launch_gemm<FC1_BN, true, 0>(device, mx, mw1, mh_out, b1, m, 0, fc1, sms, stream);
  if (err != cudaSuccess) return err;
  const Phase fc2 =
      bf16_phase(n, models, cdiv(d, bn2), cdiv(m, G_BK), false, m, width, widths, bn2);
  if (wide_tiles)
    return launch_gemm<WIDE, false, CHUNK>(device, mh_in, mw2, mout, b2, d, d, fc2, sms, stream);
  return launch_gemm<FC2_BN_NARROW, false, CHUNK>(device, mh_in, mw2, mout, b2, d, d, fc2, sms,
                                                  stream);
}

// K1c's queue over `groups` groups of a + b units, with a lead the grid's
// kernel takes: 1 <= lead <= groups, and a block for at least one unit.
inline bool queue_ok(const Queue& q, int blocks) {
  return q.lead >= 1 && q.lead <= q.groups && blocks >= 1 && blocks <= q.groups * (q.a + q.b);
}

// K1c's bf16 form on `blocks` persistent blocks (any number: the tickets
// need no block to be resident beside another) with a lead of `lead` groups.
// ready: groups + 1 = models * ceil(n / 128) + 1 int32, all 0.
template <int BN2>
cudaError_t launch_queue_bf16(int device, const void* x, const void* w1, const void* b1,
                              const void* w2, int ld_w2, const void* b2, void* h, int ld_h,
                              int* ready, void* out, int n, int d, int m, int width,
                              const int* widths, int models, int lead, int blocks,
                              cudaStream_t stream) {
  using S = QueueShape<BN2>;
  auto* kernel = wide_queue_kernel<BN2>;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err =
      raise_smem_limit_once((const void*)kernel, (int)S::SMEM, device, smem_set);
  if (err != cudaSuccess) return err;
  const Phase fc1 = bf16_phase(n, models, cdiv(m, FC1_BN), cdiv(d, G_BK), true, m, width,
                               widths, FC1_BN);
  const Phase fc2 =
      bf16_phase(n, models, cdiv(d, BN2), cdiv(m, G_BK), false, m, width, widths, BN2);
  const Queue q{models * fc1.row_tiles, fc1.col_tiles, fc2.col_tiles, lead, ready};
  if (!queue_ok(q, blocks)) return cudaErrorInvalidValue;
  CUtensorMap mx, mw1, mh, mw2, mh_out, mout;
  if (!bf16_map(&mx, x, models, n, d, d, G_BM) || !bf16_map(&mw1, w1, models, m, d, d, FC1_BN) ||
      !bf16_map(&mh, h, models, n, ld_h, ld_h, G_BM) ||
      !bf16_map(&mw2, w2, models, d, m, ld_w2, BN2) ||
      !bf16_map(&mh_out, h, models, n, ld_h, ld_h, 64) ||
      !bf16_map(&mout, out, models, n, d, d, 64))
    return cudaErrorInvalidValue;
  kernel<<<blocks, G_THREADS, S::SMEM, stream>>>(mx, mw1, mh, mw2, mh_out, mout,
                                                 static_cast<const bf16*>(b1),
                                                 static_cast<const bf16*>(b2), d, fc1, fc2, q);
  return cudaGetLastError();
}

// K1c's bf16 form, fc2's tile chosen as K1's (from n and d alone), so that
// its tiles and K order are K1's.
inline cudaError_t run_queue_bf16(int device, const void* x, const void* w1, const void* b1,
                                  const void* w2, int ld_w2, const void* b2, void* h, int ld_h,
                                  int* ready, void* out, int n, int d, int m, int width,
                                  const int* widths, int models, int lead, int blocks,
                                  cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  if (cdiv(n, G_BM) * cdiv(d, FC2_BN_WIDE) >= sms)
    return launch_queue_bf16<FC2_BN_WIDE>(device, x, w1, b1, w2, ld_w2, b2, h, ld_h, ready, out,
                                          n, d, m, width, widths, models, lead, blocks, stream);
  return launch_queue_bf16<FC2_BN_NARROW>(device, x, w1, b1, w2, ld_w2, b2, h, ld_h, ready, out,
                                          n, d, m, width, widths, models, lead, blocks, stream);
}

// ---------------------------------------------------------------------------
// f32: the two GEMM phases in 3xTF32 on wgmma, fed by TMA.
// ---------------------------------------------------------------------------

constexpr int T_BK = 32;        // k of a stage: 32 f32 = one 128-byte swizzle row
constexpr int T_BM = 128;       // rows of a tile: 64 for each consumer warpgroup
constexpr int T_BN = 64;        // columns of a tile: wgmma's N
constexpr int T_STAGES = 5;
constexpr int T_PROMOTE = 4;    // stages between promotions: 128 of k
constexpr int T_SPLITTERS = 96; // warps 1-3 of the producer's warpgroup
constexpr int T_A_BYTES = T_BM * T_BK * 4;
constexpr int T_B_BYTES = T_BN * T_BK * 4;
// a stage: A as loaded, B as loaded, and B's TF32 hi and lo
constexpr int T_STAGE_BYTES = T_A_BYTES + 3 * T_B_BYTES;
constexpr size_t T_SMEM = 1024 + (size_t)T_STAGES * T_STAGE_BYTES + 3 * T_STAGES * sizeof(uint64_t);
// K1b's summation chunk in stages: fc2's K split of K1b
constexpr int T_CHUNK_STAGES = 512 / T_BK;
static_assert(T_A_BYTES % 1024 == 0 && T_B_BYTES % 1024 == 0,
              "every tile starts on a 1,024-byte swizzle atom");

// What a unit's epilogue does with its (128, 64) tile of sums: fc1's GELU
// (+ bias, the exact-erf GELU, columns at or past `cols` written as 0),
// fc2's bias, or a K split's partial sums as they are.
enum Epilogue { T_GELU = 0, T_BIAS = 1, T_PART = 2 };

// The producer warpgroup's part of one unit: thread 0 loads each stage's A
// tile (128 x 32) and B tile (64 x 32) by TMA on `full`; warps 1-3 split
// each landed B tile into TF32 hi and lo tiles of the same swizzled layout
// (`split_tf32`) and arrive on the stage's `ready`.
__device__ __forceinline__ void tf32_load_unit(const Work& w, const CUtensorMap* map_a,
                                               const CUtensorMap* map_b, unsigned char* smem,
                                               uint64_t* full, uint64_t* ready, uint64_t* empty,
                                               int& it, int tid) {
  for (int kt = w.k0; kt < w.k1; ++kt, ++it) {
    const int s = it % T_STAGES;
    unsigned char* st = smem + s * T_STAGE_BYTES;
    if (tid == 0) {  // the loads
      mbar_wait(&empty[s], ((it / T_STAGES) & 1) ^ 1);  // at once on the first lap
      mbar_expect_tx(&full[s], T_A_BYTES + T_B_BYTES);
      tma_load_3d(st, map_a, &full[s], kt * T_BK, w.row0, w.p);
      tma_load_3d(st + T_A_BYTES, map_b, &full[s], kt * T_BK, w.col0, w.p);
    } else if (tid >= 32) {  // the splits of B, 16 bytes a thread at a time
      mbar_wait(&full[s], (it / T_STAGES) & 1);
      const float4* raw = reinterpret_cast<const float4*>(st + T_A_BYTES);
      uint4* hi = reinterpret_cast<uint4*>(st + T_A_BYTES + T_B_BYTES);
      uint4* lo = hi + T_B_BYTES / 16;
      for (int i = tid - 32; i < T_B_BYTES / 16; i += T_SPLITTERS) {
        const float4 v = raw[i];
        uint4 hv, lv;
        split_tf32(v.x, hv.x, lv.x);
        split_tf32(v.y, hv.y, lv.y);
        split_tf32(v.z, hv.z, lv.z);
        split_tf32(v.w, hv.w, lv.w);
        hi[i] = hv;
        lo[i] = lv;
      }
      // these generic-proxy writes, visible to the consumers' wgmmas
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&ready[s]);
    }
  }
}

// Consumer warpgroup c's stages [k0, k1) of one unit into `total`, rows 64c
// .. 64c + 63 of the tile: per stage, for each k-step of 8 it loads its A
// fragment from the landed tile by ldmatrix, splits it in registers, and
// issues three wgmma m64n64k8 with A from registers: lo_A hi_B and hi_A lo_B
// into `small`, hi_A hi_B into `big`.  Both start from 0 every T_PROMOTE
// stages (the first k-step's wgmmas do not read them) and are then added
// into `total` in f32.  The A fragments are double-buffered by stage
// parity: one stage's wgmmas stay in flight while the next stage's load.
// A stage goes back to the producer once the wgmmas that read it retired.
__device__ __forceinline__ void tf32_steps(float (&total)[32], const Work& w,
                                           const unsigned char* smem, uint64_t* full,
                                           uint64_t* ready, uint64_t* empty, int& it, int c,
                                           int tid) {
  const int warp = tid / 32, lane = tid % 32;
  // this lane's ldmatrix row of the A tile (rows 0-7 and 8-15 of the warp's
  // 16 for tiles 0, 2 and 1, 3) and its column chunk's offset (columns 0-3
  // and 4-7 of a k-step for tiles 0, 1 and 2, 3), before the swizzle
  const int a_row = 64 * c + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_chunk = lane >> 4;
  float big[32], small[32];
  uint32_t a[2][4][8];  // [stage parity][k-step][hi 0-3, lo 4-7]
  const int nst = w.k1 - w.k0;
#pragma unroll
  for (int i = 0; i < 32; ++i) total[i] = 0.f;

  auto stage = [&](auto parity, int j) {
    constexpr int P = decltype(parity)::value;
    const int s = it % T_STAGES;
    const uint32_t phase = (it / T_STAGES) & 1;
    mbar_wait(&full[s], phase);
    mbar_wait(&ready[s], phase);
    const unsigned char* st = smem + s * T_STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // the 128-byte swizzle: 16-byte chunk q of row r lies at q ^ (r % 8)
      uint32_t raw[4];
      ldmatrix_x4(raw, st + a_row * 128 + (((2 * kk + a_chunk) ^ (lane & 7)) << 4));
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(raw[r], a[P][kk][r], a[P][kk][4 + r]);
    }
    const uint64_t dh = smem_desc(st + T_A_BYTES + T_B_BYTES, 16, 1024, 1);
    const uint64_t dl = smem_desc(st + T_A_BYTES + 2 * T_B_BYTES, 16, 1024, 1);
    fence_regs(big);
    fence_regs(small);
    fence_regs(a[P]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t* f = a[P][kk];
      const int acc = j > 0 || kk > 0;  // the interval's first k-step starts from 0
      wgmma_tf32_rs<64>(small, f[4], f[5], f[6], f[7], dh + 2 * kk, acc);
      wgmma_tf32_rs<64>(small, f[0], f[1], f[2], f[3], dl + 2 * kk, 1);
      wgmma_tf32_rs<64>(big, f[0], f[1], f[2], f[3], dh + 2 * kk, acc);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the stage before this one has been read
    fence_regs(big);
    fence_regs(small);
    if (j > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % T_STAGES]);
    ++it;
  };
  // Every consumer runs every stage, also one whose rows all lie past n
  // (TMA zero-fills them): a branch around the wgmmas that the compiler
  // cannot prove uniform makes ptxas serialise them (C7518).
  for (int i0 = 0; i0 < nst; i0 += T_PROMOTE) {
    const int span = min(T_PROMOTE, nst - i0);
    for (int j = 0; j < span; j += 2) {
      stage(std::integral_constant<int, 0>(), j);
      if (j + 1 < span) stage(std::integral_constant<int, 1>(), j + 1);
    }
    wgmma_wait<0>();
    fence_regs(big);
    fence_regs(small);
    if (tid == 0) mbar_arrive(&empty[(it - 1) % T_STAGES]);
#pragma unroll
    for (int i = 0; i < 32; ++i) total[i] += big[i] + small[i];
  }
}

// The epilogue of a unit's (128, 64) tile: consumer warpgroup c's 64 rows of
// `total`, EPI applied (bias[col] zero at and past `cols`), written as f32
// pairs into dst (rows `ld_out` apart; row < n, column < out_cols, which is
// even).  Accumulator register 4jj + 2i + e holds row 16 * warp + lane / 4 +
// 8i of the warpgroup's 64, column 8jj + 2 (lane % 4) + e.
template <int EPI>
__device__ __forceinline__ void tf32_store(const float (&total)[32], const Work& w, float* dst,
                                           int ld_out, int n, int out_cols, const float* bias,
                                           int cols, int c, int tid) {
  if (w.row0 + 64 * c >= n) return;  // no live row
  const int lane = tid % 32;
  const int row = w.row0 + 64 * c + 16 * (tid / 32) + lane / 4;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = w.col0 + 8 * jj + 2 * (lane % 4);
    if (col >= out_cols) continue;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (EPI != T_PART) {
      b0 = col < cols ? bias[col] : 0.f;
      b1 = col + 1 < cols ? bias[col + 1] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row + 8 * i >= n) continue;
      float v0 = total[4 * jj + 2 * i] + b0, v1 = total[4 * jj + 2 * i + 1] + b1;
      if constexpr (EPI == T_GELU) {
        v0 = col < cols ? gelu_erf(v0) : 0.f;
        v1 = col + 1 < cols ? gelu_erf(v1) : 0.f;
      }
      *reinterpret_cast<float2*>(dst + (size_t)(row + 8 * i) * ld_out + col) =
          make_float2(v0, v1);
    }
  }
}

// out = epilogue(A @ B^T) over a phase's (128, 64) tiles of every model, both
// operands f32 and K-major behind 3-D TMA maps (boxes of 32 columns,
// 128-byte swizzle), on a persistent grid: block b takes units b, b +
// gridDim.x, ...  Warpgroup 0 gives up registers and loads and splits;
// warpgroups 1 and 2 take 64 rows each.  out is (P, n, ld_out), or for
// T_PART the splits' partials (splits, P, n, ld_out).
template <int EPI>
__global__ void __launch_bounds__(G_THREADS, 1)
wide_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const float* __restrict__ bias,
                   int bias_ld, int bias_cols, float* __restrict__ out, int ld_out, int out_cols,
                   const Phase ph) {
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  // the swizzle atoms (8 rows of 128 bytes) must start 1024-byte aligned
  unsigned char* smem = tf32_smem + ((1024 - (smem_u32(tf32_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T_STAGES * T_STAGE_BYTES);
  uint64_t* ready = full + T_STAGES;
  uint64_t* empty = ready + T_STAGES;
  const int units = units_of(ph), n = ph.n;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  init_ring(full, ready, empty, T_STAGES, T_SPLITTERS);

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Work w = work_of(ph, u);
      if (w.live) tf32_load_unit(w, &map_a, &map_b, smem, full, ready, empty, it, tid);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;
  float total[32];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Work w = work_of(ph, u);
    if (!w.live) continue;
    tf32_steps(total, w, smem, full, ready, empty, it, c, tid);
    const size_t model = (size_t)w.p * n * ld_out;
    float* dst = out + model + (EPI == T_PART ? (size_t)w.split * ph.models * n * ld_out : 0);
    tf32_store<EPI>(total, w, dst, ld_out, n, out_cols, bias + (size_t)w.p * bias_ld,
                    EPI == T_GELU ? w.width : bias_cols, c, tid);
  }
}

// A wave of a split phase: out[p, r, col] = part[0, p] + part[1, p] + ... +
// part[wave - 1, p] for rows r < n and columns col < width (a multiple of
// 4), summed in that order after out's running sum where `accumulate`
// (the earlier waves' splits), then, where `finish` (the last wave), +
// bias[col] (zero at and past the bound: with GELU model p's width, else
// `cols`), and with GELU the exact-erf GELU, columns at or past the width
// written as 0.  Over the waves the splits are one left fold in split
// order.  part is (wave, P, n, ld) f32, out (P, n, ld).
template <bool GELU>
__global__ void split_sum_kernel(const float* __restrict__ part, const float* __restrict__ bias,
                                 int bias_ld, float* __restrict__ out, int n, int ld, int width,
                                 int cols, const Phase ph, int accumulate, int finish) {
  const long long per_model = (long long)n * (width / 4);
  const long long quads = per_model * ph.models;
  const long long split_stride = (long long)ph.models * n * ld;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < quads;
       q += (long long)gridDim.x * blockDim.x) {
    const int p = (int)(q / per_model);
    const long long rem = q % per_model;
    const long long r = rem / (width / 4);
    const int col = (int)(rem % (width / 4)) * 4;
    const long long at = ((long long)p * n + r) * ld + col;
    const int bound =
        GELU ? min(max(ph.widths != nullptr ? ph.widths[p] : ph.width, 0), ph.m) : cols;
    float4 v = *reinterpret_cast<const float4*>((accumulate ? out : part) + at);
    for (int s = accumulate ? 0 : 1; s < ph.wave; ++s) {
      const float4 pv = *reinterpret_cast<const float4*>(part + s * split_stride + at);
      v.x += pv.x, v.y += pv.y, v.z += pv.z, v.w += pv.w;
    }
    if (!finish) {
      *reinterpret_cast<float4*>(out + at) = v;
      continue;
    }
    const float* b = bias + (size_t)p * bias_ld;
    float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool keep = col + k < bound;
      e[k] += keep ? b[col + k] : 0.f;
      if (GELU) e[k] = keep ? gelu_erf(e[k]) : 0.f;
    }
    *reinterpret_cast<float4*>(out + at) = make_float4(e[0], e[1], e[2], e[3]);
  }
}

constexpr int SUM_THREADS = 256;
// K splits a wave of a split phase: the partial sums the scratch holds
// (`fused_mlp.WIDE_F32_MAX_SPLITS`, the most splits of K1's phases).
constexpr int T_MAX_WAVE = 8;

// One f32 phase on `blocks` persistent blocks into out (P, n, ld_out); with
// splits > 1, in waves of at most T_MAX_WAVE splits: partial sums into part
// (T_MAX_WAVE, P, n, ld_out), each wave's added into out in split order.
template <bool GELU>
cudaError_t launch_tf32x3(int device, const CUtensorMap& map_a, const CUtensorMap& map_b,
                          const float* bias, int bias_ld, int bias_cols, float* part,
                          float* out, int ld_out, const Phase& ph, int blocks, int sms,
                          cudaStream_t stream) {
  constexpr int EPI = GELU ? T_GELU : T_BIAS;
  // columns a tile writes, and a split's sum reads: ld_out is a multiple of
  // 4, col_tiles * 64 of 64
  const int width = std::min(ld_out, ph.col_tiles * T_BN);
  static std::atomic<unsigned long long> smem_set[2]{};  // one bit a device
  auto* direct = wide_tf32x3_kernel<EPI>;
  auto* split = wide_tf32x3_kernel<T_PART>;
  auto* kernel = ph.splits == 1 ? direct : split;
  cudaError_t err =
      raise_smem_limit_once((const void*)kernel, (int)T_SMEM, device, smem_set[ph.splits > 1]);
  if (err != cudaSuccess) return err;
  if (ph.splits == 1) {
    kernel<<<blocks, G_THREADS, T_SMEM, stream>>>(map_a, map_b, bias, bias_ld, bias_cols, out,
                                                  ld_out, width, ph);
    return cudaGetLastError();
  }
  const long long quads = (long long)ph.models * ph.n * (width / 4);
  const int grid = (int)std::min<long long>((quads + SUM_THREADS - 1) / SUM_THREADS, 8LL * sms);
  for (int first = 0; first < ph.splits; first += T_MAX_WAVE) {
    Phase wave = ph;
    wave.split0 = first;
    wave.wave = std::min(T_MAX_WAVE, ph.splits - first);
    kernel<<<std::min(blocks, units_of(wave)), G_THREADS, T_SMEM, stream>>>(
        map_a, map_b, bias, bias_ld, bias_cols, part, ld_out, width, wave);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    split_sum_kernel<GELU><<<grid, SUM_THREADS, 0, stream>>>(
        part, bias, bias_ld, out, ph.n, ld_out, width, bias_cols, wave, first > 0,
        first + wave.wave == ph.splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

inline bool f32_map(CUtensorMap* map, const void* base, int models, int rows, int cols, int ld,
                    int box_rows) {
  return encode_map_3d(map, base, models, rows, cols, ld, T_BK, box_rows, 128, 4);
}

inline Phase f32_phase(int n, int models, int col_tiles, int k_steps, int splits,
                       int split_steps, bool fc1, int m, int width, const int* widths) {
  return {n, models, cdiv(n, T_BM), col_tiles, k_steps, splits, split_steps, fc1 ? 1 : 0, m,
          width, widths, T_BM, T_BN, T_BK, 0, splits};
}

// K1's (chunk_stages 0) or K1b's (T_CHUNK_STAGES: fc2's splits are its
// chunks) f32 form on the plan's grids (`fused_mlp.wide_f32_plan`): fc1 +
// GELU into h on blocks1 blocks in splits1 K splits, then fc2 + b2 from it
// on blocks2 blocks in splits2, each in waves of at most T_MAX_WAVE splits;
// part holds a wave's partials (max(min(splits1, T_MAX_WAVE) * ld_h,
// min(splits2, T_MAX_WAVE) * d) * P * n floats, the ones of a phase that
// splits; may be null when neither does).  A plan the kernels do not take
// returns cudaErrorInvalidValue.
inline cudaError_t run_f32(int device, const void* x, const void* w1, const void* b1,
                           const void* w2, int ld_w2, const void* b2, void* h, int ld_h,
                           void* part, void* out, int n, int d, int m, int width,
                           const int* widths, int models, int splits1, int blocks1,
                           int splits2, int blocks2, int chunk_stages, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int k1 = cdiv(d, T_BK), k2 = cdiv(m, T_BK);
  const Phase fc1 = f32_phase(n, models, cdiv(m, T_BN), k1, splits1, 0, true, m, width, widths);
  const Phase fc2 =
      f32_phase(n, models, cdiv(d, T_BN), k2, splits2, chunk_stages, false, m, width, widths);
  // a plan the kernels take: every split holds a stage, every block a unit;
  // K1b's fc2 splits are its chunks
  const auto bad = [](const Phase& ph, int blocks) {
    return ph.splits < 1 || ph.splits > std::max(ph.k_steps, 1) || blocks < 1 ||
           blocks > units_of(ph);
  };
  if (bad(fc1, blocks1) || bad(fc2, blocks2) ||
      (chunk_stages > 0 && splits2 != cdiv(k2, chunk_stages)) ||
      ((splits1 > 1 || splits2 > 1) && part == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mw1, mh, mw2;
  if (!f32_map(&mx, x, models, n, d, d, T_BM) || !f32_map(&mw1, w1, models, m, d, d, T_BN) ||
      !f32_map(&mh, h, models, n, ld_h, ld_h, T_BM) ||
      !f32_map(&mw2, w2, models, d, ld_w2, ld_w2, T_BN))
    return cudaErrorInvalidValue;
  float* scratch = static_cast<float*>(part);
  err = launch_tf32x3<true>(device, mx, mw1, static_cast<const float*>(b1), m, 0, scratch,
                            static_cast<float*>(h), ld_h, fc1, blocks1, sms, stream);
  if (err != cudaSuccess) return err;
  return launch_tf32x3<false>(device, mh, mw2, static_cast<const float*>(b2), d, d, scratch,
                              static_cast<float*>(out), d, fc2, blocks2, sms, stream);
}

// K1c's f32 shared memory: K1's f32 ring, then the tickets' hand-off.
constexpr size_t T_QUEUE_SMEM = T_SMEM + sizeof(Handoff);

// K1c's f32 body: fc1 (128 x 64 tiles of h, exact-erf GELU) and fc2 (128 x
// 64 tiles of out) units in `Queue`'s order, taken by ticket, in one
// persistent launch on any grid, K unsplit.  Warpgroup 0: thread 0 takes
// the tickets and loads, warps 1-3 split B; both epilogues store from
// registers, as K1's f32 body does (a staging tile would cost one of the
// ring's five stages).
__global__ void __launch_bounds__(G_THREADS, 1)
wide_queue_tf32x3_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w1,
                         const __grid_constant__ CUtensorMap map_h,
                         const __grid_constant__ CUtensorMap map_w2, const float* __restrict__ b1,
                         const float* __restrict__ b2, float* __restrict__ h, int ld_h,
                         float* __restrict__ out, int d, const Phase ph1, const Phase ph2,
                         const Queue q) {
  extern __shared__ __align__(16) unsigned char queue_smem[];
  unsigned char* smem = queue_smem + ((1024 - (smem_u32(queue_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T_STAGES * T_STAGE_BYTES);
  uint64_t* ready = full + T_STAGES;
  uint64_t* empty = ready + T_STAGES;
  Handoff* hand = reinterpret_cast<Handoff*>(empty + T_STAGES);
  const int units = q.groups * (q.a + q.b), n = ph1.n;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) init_handoff(hand, 256 + T_SPLITTERS);
  init_ring(full, ready, empty, T_STAGES, T_SPLITTERS);

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid > 0 && tid < 32) return;
    int it = 0;
    for (int k = 0;; ++k) {
      const int u = tid == 0 ? take_ticket(q, hand, k) : next_ticket(hand, k);
      if (u >= units) break;
      bool fc1;
      int g, tile;
      queue_unit(q, u, &fc1, &g, &tile);
      const Work w = work_at(fc1 ? ph1 : ph2, g / ph1.row_tiles, g % ph1.row_tiles, tile, 0);
      if (!w.live) continue;
      if (!fc1 && tid == 0 && w.k1 > w.k0) wait_ready(q.ready + g, cdiv(w.width, T_BN));
      tf32_load_unit(w, fc1 ? &map_x : &map_h, fc1 ? &map_w1 : &map_w2, smem, full, ready, empty,
                     it, tid);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;
  float total[32];
  int it = 0;
  for (int k = 0;; ++k) {
    const int u = next_ticket(hand, k);
    if (u >= units) break;
    bool fc1;
    int g, tile;
    queue_unit(q, u, &fc1, &g, &tile);
    const int p = g / ph1.row_tiles;
    const Work w = work_at(fc1 ? ph1 : ph2, p, g % ph1.row_tiles, tile, 0);
    if (!w.live) continue;  // an fc1 tile at or past the width: its group waits on none
    // one k-loop for both kinds of unit (two would each hold their
    // accumulators and fragments, and spill)
    tf32_steps(total, w, smem, full, ready, empty, it, c, tid);
    if (fc1) {
      tf32_store<T_GELU>(total, w, h + (size_t)p * n * ld_h, ld_h, n, ld_h,
                         b1 + (size_t)p * ph1.m, w.width, c, tid);
      __threadfence();
      bar_sync(1, 256);  // both consumer warpgroups' rows are written
      if (threadIdx.x == 128) signal_ready(q.ready + g);
    } else {
      tf32_store<T_BIAS>(total, w, out + (size_t)p * n * d, d, n, d, b2 + (size_t)p * d, d, c,
                         tid);
    }
  }
}

// K1c's f32 form on `blocks` persistent blocks (any number) with a lead of
// `lead` groups.  ready: models * ceil(n / 128) + 1 int32, all 0.
inline cudaError_t run_queue_f32(int device, const void* x, const void* w1, const void* b1,
                                 const void* w2, int ld_w2, const void* b2, void* h, int ld_h,
                                 int* ready, void* out, int n, int d, int m, int width,
                                 const int* widths, int models, int lead, int blocks,
                                 cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = raise_smem_limit_once((const void*)wide_queue_tf32x3_kernel,
                                                (int)T_QUEUE_SMEM, device, smem_set);
  if (err != cudaSuccess) return err;
  const Phase fc1 =
      f32_phase(n, models, cdiv(m, T_BN), cdiv(d, T_BK), 1, 0, true, m, width, widths);
  const Phase fc2 =
      f32_phase(n, models, cdiv(d, T_BN), cdiv(m, T_BK), 1, 0, false, m, width, widths);
  const Queue q{models * fc1.row_tiles, fc1.col_tiles, fc2.col_tiles, lead, ready};
  if (!queue_ok(q, blocks)) return cudaErrorInvalidValue;
  CUtensorMap mx, mw1, mh, mw2;
  if (!f32_map(&mx, x, models, n, d, d, T_BM) || !f32_map(&mw1, w1, models, m, d, d, T_BN) ||
      !f32_map(&mh, h, models, n, ld_h, ld_h, T_BM) ||
      !f32_map(&mw2, w2, models, d, ld_w2, ld_w2, T_BN))
    return cudaErrorInvalidValue;
  wide_queue_tf32x3_kernel<<<blocks, G_THREADS, T_QUEUE_SMEM, stream>>>(
      mx, mw1, mh, mw2, static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<float*>(h), ld_h, static_cast<float*>(out), d, fc1, fc2, q);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wide

// K1: fused FFN, out = gelu(x @ w1^T + b1)[:, :active] @ w2[:, :active]^T + b2.
//
// Replaces the TPU kernel `vit3d_ensemble_tpu/ops/pallas_mlp.py:_mlp_kernel`
// (reached through `fused_mlp` -> `_fused_mlp_impl`, variant "seq").
//
// The narrow regime, D in {8, 16, 32, 64} (every registry config's), in
// f32: the body in `mlp_narrow_f32.cuh` (`narrow_tf32x3`), shared with K1c:
// both products in 3xTF32 on `wgmma`, the hidden columns split across the
// blocks of a thread-block cluster whose partial sums meet in distributed
// shared memory; its note says what bounds it and how it is laid out.  It
// replaced a CUDA-core body (64-row blocks each walking all of M on FFMAs),
// which lost to F.linear -> F.gelu -> F.linear at the drivers' one-model
// shapes (PERF.md).  bf16 in the narrow regime is not here: the wrapper
// (`ops/fused_mlp.py`) sends those calls to K1c's library
// (`mlp_pipelined.cu`), which computes this function: its warp-specialised
// wgmma pipeline at D 16-64 (an earlier mma.sync body of 64-row blocks lost
// to it at every row count timed, 1 to 33,280, and was removed) and its
// CUDA-core tiling at D = 8.  A narrow D outside that set runs zero-padded
// to the next of them (`kernel_width`).
//
// The wide regime, every D from 65 to 8,192 (the stretch model's D = 768,
// M = 3072; ViT-H's D = 1,280, M = 5,120), as the TPU kernel takes any D.
// The bodies stage K in 64 (bf16) or 32 (f32) columns and tile fc2's N = D
// in 192 or 64 columns, so a D that these do not divide ends in a ragged
// last K stage, which TMA zero-fills past D in both operands (adding
// nothing), and a ragged last column tile, whose stores TMA clips (bf16) or
// the epilogue masks (f32).  TMA needs rows of a multiple of 16 bytes, so D
// is a multiple of 8 in bf16 and of 4 in f32: the wrapper
// (`ops/fused_mlp.py`) hands any other D over as zero-padded copies of x,
// w1, w2 and b2 (zero columns of x and w1 add nothing to h, zero rows of w2
// and b2 give output columns it drops).  What bounds it there: operations.  M / D is 4, so the
// intermediate is no longer the larger part of the bytes, and 4*N*D*M
// multiply-adds at the tensor-core peak (39 us at N = 4,104 in bf16) exceed
// the time of every byte.  The narrow plan does not carry over: a full-D f32
// accumulator is 196 KB for 64 rows at D = 768, three quarters of an SM's
// registers.  An earlier body of this kernel kept it by cutting the tile to
// 32 rows, so every block streamed both 4.7 MB weight matrices out of L2
// (~1.2 GB a call), unhidden, on mma.sync: 0.47 ms on an H100 against 0.09
// for the library's linear -> gelu -> linear.
//   * bf16 (`wide_gemm_kernel`): two GEMM phases, with h going through L2.
//     Phase 1, fc1 + bias + the bf16 GELU (`gelu_poly`), rounded once to
//     bf16 (the rounding point of pallas_mlp.py:93), columns at or past `active`
//     written as 0, into an (N, M8) scratch that the wrapper allocates (M8:
//     M rounded up to 8), over the first ceil(active / 128) column tiles of
//     128 x 128.  Phase 2, fc2 + b2 from that scratch, on 128 x 192 tiles
//     where those fill every SM (one wave on 132 SMs at N = 4,104, D = 768)
//     and 128 x 64 where they do not (N = 513), its k-loop stopped at
//     `active` rounded up to 64 (the scratch holds zeros past `active`).
//     Why h goes through L2: keeping it on chip needs a (rows, D) f32
//     accumulator, so 32-row tiles again, or fc1 recomputed for every slab
//     of output columns, and 64-row tiles would still leave 67 of 132 SMs
//     idle at N = 4,104; the scratch is 25 MB there, which the 50 MB L2
//     holds between the phases, and its write and read are ~2 % of the
//     operations' time.  Each phase is a warp-specialised Hopper GEMM: one
//     producer thread keeps a ring of shared-memory stages loading with TMA
//     (128-byte swizzle, completion on mbarriers, zero fill past the edges,
//     so ragged N needs no masking), two consumer warpgroups run
//     wgmma.mma_async m64nBNk16 straight from those stages, each on 64 of the
//     tile's rows, `setmaxnreg` moves registers from the producer's
//     warpgroup to theirs, the block is persistent (the next tile's loads
//     run under this one's epilogue), and the epilogue writes bf16 through a
//     swizzled staging tile with TMA stores (clipped at the edges).  fc2's
//     tile widths come from an ablation on an H100 at the stretch shape:
//     wider tiles need fewer k-steps and loads an operation, until they no
//     longer fill the SMs.  M % 8 != 0:
//     w2's row stride is then not a multiple of 16 bytes, which TMA refuses,
//     so the wrapper hands the kernel a zero-padded (D, M8) copy of w2, made
//     only for such M (no registry config has one).
//   * f32 (`wide_tf32x3_kernel`): the same two phases with h through L2,
//     f32 this time (the rounding point of pallas_mlp.py:93 is the input
//     type): an (N, M4) scratch, M rounded up to 4, 6.3 MB at N = 513 and
//     50.4 MB at N = 4,104, the whole L2, so there part of h goes to device
//     memory and back (~0.03 ms of bytes at most, beside ~0.25 ms of
//     products).  Both products run on the tensor cores in 3xTF32
//     (`tf32x3.cuh`): 4.84 GFLOP of f32 products at (513, 768, 3,072) take
//     72 us on CUDA cores at the 67 TFLOP/s FP32 peak and 29 us as three
//     TF32 products at the 495 TFLOP/s TF32 peak.  Both GEMMs have both
//     operands K-major in the nn.Linear layout (x and w1 along D, h and w2
//     along M), so `wgmma` m64n64k8 in TF32 is legal, with B (the weights)
//     from shared memory and A from registers.  Why `wgmma` and not K4's
//     `mma.sync` m16n8k8: `mma.sync` reaches 64 % of the TF32 peak on an
//     H100 (`chip_smoke.py`'s `mma_sync_tf32` probe), which would bound the
//     call at 0.046 ms at (513, 768, 3,072), and every operand element of
//     its fragments is split in registers by each warp that loads it; with
//     `wgmma` B is split once a stage for both consumer warpgroups and only
//     A in registers.  The `mma.sync` form was not built to compare.
//     A stage loads an A tile
//     (128 x 32) and a B tile (64 x 32) by TMA; three warps of the
//     producer's warpgroup split the B tile into TF32 hi and lo tiles of
//     the same 128-byte-swizzled layout; each consumer warpgroup splits its
//     A fragments as it loads them (ldmatrix) and runs lo_A hi_B and hi_A
//     lo_B into one accumulator and hi_A hi_B into another, both from 0 for
//     every 128 of K and then added into an f32 sum in registers (the
//     promotion of Hopper's FP8 GEMMs).  The tensor cores truncate inside a
//     wgmma; with x four times larger, one accumulator over all of fc2's
//     K = 3,072 missed the f32 tolerance in a CPU model of that truncation
//     (`tests/test_torch_stretch.py`), and the weights are never split in a
//     pass of their own (~57 MB of bytes a call) nor kept split across
//     calls.  Tiles of 128 x 64 (three accumulators of m64n64 and two
//     buffers of A fragments fit a consumer's 232 registers; m64n128 would
//     not).  Filling the SMs (`fused_mlp.wide_f32_plan`): fc1 at N = 513
//     has 5 x 48 = 240 tiles, 1.8 waves on 132 SMs, and N = 4,104 1,584, 12
//     waves; fc2's (N, 768) output has 60 tiles at N = 513, so the plan
//     splits its K in two (120 units, one wave), and 396 at N = 4,104 (3
//     waves).  A phase with fewer tiles than half the SMs splits its K,
//     fc1's too, up to 8 ways and never below 128 of K a split; the splits'
//     partial sums go to a scratch and a second launch adds them in split
//     order (then the bias, and for fc1 the GELU and the mask): no float
//     atomics, so a call gives the same bits every run.  M % 4 != 0: the
//     wrapper hands the kernel a zero-padded (D, M4) copy of w2.  On an
//     H100 this body took less device time than the CUDA-core body it
//     replaced (16-row tiles streaming both weight matrices from L2 for
//     every block) at every wide f32 shape of the card tests and the
//     stretch path, from 1 to 4,104 rows (`chip_turns.py`, PERF.md), so
//     that body is gone.
//
// Layouts follow torch.nn.Linear: x (n, D), w1 (m, D), b1 (m), w2 (D, m),
// b2 (D), out (n, D), all contiguous.  f32 or bf16, f32 accumulation.  The
// narrow bodies take D in {8, 16, 32, 64}; the wrapper runs a narrow D
// outside that set zero-padded to the next of them, as above.
//
// The model axis (the sweep's stacked (config, fold) cells), narrow regime
// only: the narrow body takes P weight sets stacked along a leading axis
// and runs model p on blockIdx.y, with its own width mask read from device
// memory (`mlp_common.cuh`, `Model`).  The wide bodies have no model
// axis: on an H100, in one call against the bodies without it, the offsets
// and the width held in registers cost them registers and time beyond the
// grid dimension, so a stacked call at a wide D is refused.

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "mlp_common.cuh"
#include "mlp_narrow_f32.cuh"
#include "sm90_common.cuh"
#include "tf32x3.cuh"

namespace {

using namespace mlp;
using namespace sm90;
using namespace tf32x3;

// ---------------------------------------------------------------------------
// The wide regime: 64 < D <= 8,192 (see the note above).
// bf16: two warp-specialised GEMM phases on wgmma, fed by TMA.
// ---------------------------------------------------------------------------

constexpr int G_BK = 64;       // k of a stage: 64 bf16 = one 128-byte swizzle row
constexpr int G_BM = 128;      // rows of a tile
constexpr int G_THREADS = 384; // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int FC1_BN = 128;    // fc1's tile: 128 x 128 of h
// fc2's tile: 128 x 192 of the output where those tiles fill every SM (the
// stretch model's N = 4,104 at D = 768: 132 tiles), else 128 x 64 (N = 513:
// 60 tiles, where 128 x 192 would leave 112 of 132 SMs idle)
constexpr int FC2_BN_WIDE = 192, FC2_BN_NARROW = 64;

// The stages fill the shared memory left after the epilogue's staging tile.
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

// out = epilogue(A @ B^T) over (128, BN) tiles, both operands K-major bf16
// behind TMA maps, k = 64 * k_tiles, a tile index t at row tile t / col_tiles
// and column tile t % col_tiles.  Epilogue: + bias[col] (zero at and past
// `cols`); GELU: then the bf16 GELU (`gelu_poly`), and columns at or past
// `cols` written as 0 (fc1: `cols` = the width mask); else (fc2) bias only.
// The result goes out in bf16, one rounding, through a 128-byte-swizzled
// staging tile and TMA stores.
//
// Persistent: block b takes tiles b, b + gridDim.x, ...  Warpgroup 0 gives
// up registers (setmaxnreg) and one of its threads keeps a ring of STAGES
// (A, B) stages loading with TMA across the block's tiles, k-step `it` of
// the block's sequence into stage it % STAGES, each stage tracked by a
// `full` mbarrier (its bytes arrived) and an `empty` one (both consumers are
// done with it), so the next tile's loads run under this tile's epilogue.
// Consumer warpgroup c takes the extra registers and runs wgmma on rows
// 64c .. 64c+63 of the tile, one k-step's batch in flight behind the next: a
// stage is released once the wgmma that read it has retired.
template <int BN, bool GELU>
__global__ void __launch_bounds__(G_THREADS, 1)
wide_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out,
                 const __nv_bfloat16* __restrict__ bias, int cols, int k_tiles, int tiles,
                 int col_tiles) {
  using S = GemmShape<BN>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  // the swizzle atoms (8 rows of 128 bytes) must start 1024-byte aligned
  unsigned char* smem = gemm_smem + ((1024 - (smem_u32(gemm_smem) & 1023)) & 1023);
  unsigned char* a_st = smem;                        // [STAGES][128][64]
  unsigned char* b_st = a_st + STAGES * S::A_BYTES;  // [STAGES][BN][64]
  unsigned char* c_st = b_st + STAGES * S::B_BYTES;  // [2][BN/64][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(c_st + S::C_BYTES);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = (t / col_tiles) * G_BM, col0 = (t % col_tiles) * BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // at once on the first lap
          mbar_expect_tx(&full[s], S::A_BYTES + S::B_BYTES);
          tma_load(a_st + s * S::A_BYTES, &map_a, &full[s], kt * G_BK, row0);
          tma_load(b_st + s * S::B_BYTES, &map_b, &full[s], kt * G_BK, col0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int warp = tid / 32, lane = tid % 32;
    unsigned char* stage_c = c_st + c * (BN / 64) * 8192;  // this warpgroup's 64 rows
    float acc[BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int row0 = (t / col_tiles) * G_BM, col0 = (t % col_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint64_t da = smem_desc(a_st + s * S::A_BYTES + c * 8192, 16, 1024, 1);
        const uint64_t db = smem_desc(b_st + s * S::B_BYTES, 16, 1024, 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G_BK / 16; ++kk) wgmma<BN>(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the k-step before this one has been read
        fence_regs(acc);
        if (kt > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (k_tiles > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      // Epilogue.  The last tile's stores have read the staging tile.
      if (tid == 0) tma_store_wait_read();
      bar_sync(1 + c, 128);
      // Accumulator layout of m64nBNk16: register 4j + 2i + e holds row
      // 16 * warp + lane / 4 + 8i, column 8j + 2 * (lane % 4) + e.
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
          // the staging tile of 64 columns is swizzled as TMA's 128-byte
          // mode expects: 16-byte chunk q of row r lies at chunk q ^ (r % 8)
          const int r = 16 * warp + lane / 4 + 8 * i;
          const int chunk = (j % 8) ^ (r % 8);
          *reinterpret_cast<uint32_t*>(stage_c + (j / 8) * 8192 + r * 128 + chunk * 16 +
                                       (lane % 4) * 4) = pack_bf16(v0, v1);
        }
      }
      // the generic-proxy writes above, visible to TMA; then one thread stores
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + c, 128);
      if (tid == 0) {
#pragma unroll
        for (int u = 0; u < BN / 64; ++u)
          tma_store(&map_out, stage_c + u * 8192, col0 + 64 * u, row0 + 64 * c);
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_wait_read();  // before the block's shared memory goes
  }
}

// out (rows, out_cols) = epilogue(A @ B^T) over k_tiles of 64, on a
// persistent grid of at most one block an SM.
template <int BN, bool GELU>
cudaError_t launch_gemm(int device, const void* a, int a_cols, int a_ld, const void* b,
                        int b_rows, int b_cols, int b_ld, void* out, int out_cols, int out_ld,
                        const void* bias, int cols, int rows, int k_tiles, int col_tiles,
                        int sms, cudaStream_t stream) {
  using S = GemmShape<BN>;
  CUtensorMap map_a, map_b, map_out;
  if (!encode_map(&map_a, a, rows, a_cols, a_ld, G_BM) ||
      !encode_map(&map_b, b, b_rows, b_cols, b_ld, BN) ||
      !encode_map(&map_out, out, rows, out_cols, out_ld, 64))
    return cudaErrorInvalidValue;
  auto* kernel = wide_gemm_kernel<BN, GELU>;
  static std::atomic<unsigned long long> smem_set{0};  // one bit a device
  const cudaError_t err =
      raise_smem_limit_once((const void*)kernel, (int)S::SMEM, device, smem_set);
  if (err != cudaSuccess) return err;
  const int tiles = col_tiles * ((rows + G_BM - 1) / G_BM);
  kernel<<<std::min(tiles, sms), G_THREADS, S::SMEM, stream>>>(
      map_a, map_b, map_out, static_cast<const __nv_bfloat16*>(bias), cols, k_tiles, tiles,
      col_tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide regime in f32: two GEMM phases in 3xTF32 on wgmma, fed by TMA.
// ---------------------------------------------------------------------------

constexpr int T_BK = 32;        // k of a stage: 32 f32 = one 128-byte swizzle row
constexpr int T_BM = 128;       // rows of a tile: 64 for each consumer warpgroup
constexpr int T_BN = 64;        // columns of a tile: wgmma's N
constexpr int T_STAGES = 5;
constexpr int T_PROMOTE = 4;    // stages between promotions: 128 of k
constexpr int T_THREADS = 384;  // warpgroup 0: loads (warp 0) and splits; 1 and 2 consume
constexpr int T_SPLITTERS = 96; // warps 1-3
constexpr int T_A_BYTES = T_BM * T_BK * 4;
constexpr int T_B_BYTES = T_BN * T_BK * 4;
// a stage: A as loaded, B as loaded, and B's TF32 hi and lo
constexpr int T_STAGE_BYTES = T_A_BYTES + 3 * T_B_BYTES;
constexpr size_t T_SMEM = 1024 + (size_t)T_STAGES * T_STAGE_BYTES + 3 * T_STAGES * sizeof(uint64_t);
static_assert(T_A_BYTES % 1024 == 0 && T_B_BYTES % 1024 == 0,
              "every tile starts on a 1,024-byte swizzle atom");

// What a unit's epilogue does with its (128, 64) tile of sums: fc1's GELU
// (+ bias, the exact-erf GELU, columns at or past `cols` written as 0),
// fc2's bias, or a K split's partial sums as they are.
enum Epilogue { T_GELU = 0, T_BIAS = 1, T_PART = 2 };

struct Unit {
  int row0, col0, k0, k1, split;
};

// Unit u of a phase: tile t = u % tiles, at row tile t / col_tiles and
// column tile t % col_tiles, and K split s = u / tiles, which takes the
// stages [s K / S, (s + 1) K / S) of the K stages (`fused_mlp.wide_f32_plan`).
__device__ __forceinline__ Unit unit_of(int u, int tiles, int col_tiles, int splits,
                                        int k_stages) {
  const int t = u % tiles, s = u / tiles;
  return {(t / col_tiles) * T_BM, (t % col_tiles) * T_BN,
          (int)((long long)s * k_stages / splits), (int)((long long)(s + 1) * k_stages / splits),
          s};
}

// out = epilogue(A @ B^T) over (128, 64) tiles, both operands f32 and
// K-major behind TMA maps (boxes of 32 columns, 128-byte swizzle), on a
// persistent grid: block b takes units b, b + gridDim.x, ...
//
// Warpgroup 0 gives up registers.  Its thread 0 keeps a ring of T_STAGES
// stages loading by TMA, each an A tile (128 x 32) and a B tile (64 x 32),
// on a `full` mbarrier; warps 1-3 split each landed B tile into TF32 hi
// and lo tiles of the same swizzled layout (`split_tf32`) and arrive on the
// stage's `ready` mbarrier.  Consumer warpgroup c takes rows 64c .. 64c + 63
// of the tile: per stage, for each k-step of 8 it loads its A fragment from
// the landed tile by ldmatrix, splits it in registers, and issues three
// wgmma m64n64k8 with A from registers: lo_A hi_B and hi_A lo_B into
// `small`, hi_A hi_B into `big`.  Both start from 0 every T_PROMOTE stages
// (the first k-step's wgmmas do not read them) and are then added into the
// f32 sum `total` in registers, so no small term meets a long sum inside
// the tensor cores, which truncate there.  The A fragments are double-
// buffered by stage parity: one stage's wgmmas stay in flight while the
// next stage's fragments load.  A stage goes back to the producer once the
// wgmmas that read it have retired.  The epilogue writes f32 pairs straight
// from the accumulator registers (row < n, column < out_cols).
template <int EPI>
__global__ void __launch_bounds__(T_THREADS, 1)
wide_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const float* __restrict__ bias,
                   float* __restrict__ out, int ld_out, int n, int out_cols, int cols,
                   int k_stages, int tiles, int col_tiles, int splits) {
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  // the swizzle atoms (8 rows of 128 bytes) must start 1024-byte aligned
  unsigned char* smem = tf32_smem + ((1024 - (smem_u32(tf32_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T_STAGES * T_STAGE_BYTES);
  uint64_t* ready = full + T_STAGES;
  uint64_t* empty = ready + T_STAGES;
  const int units = tiles * splits;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], T_SPLITTERS);
      mbar_init(&empty[s], 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(u, tiles, col_tiles, splits, k_stages);
      for (int kt = w.k0; kt < w.k1; ++kt, ++it) {
        const int s = it % T_STAGES;
        unsigned char* st = smem + s * T_STAGE_BYTES;
        if (tid == 0) {  // the loads
          mbar_wait(&empty[s], ((it / T_STAGES) & 1) ^ 1);  // at once on the first lap
          mbar_expect_tx(&full[s], T_A_BYTES + T_B_BYTES);
          tma_load_3d(st, &map_a, &full[s], kt * T_BK, w.row0, 0);
          tma_load_3d(st + T_A_BYTES, &map_b, &full[s], kt * T_BK, w.col0, 0);
        } else if (tid >= 32) {  // the splits of B, 16 bytes a thread at a time
          mbar_wait(&full[s], (it / T_STAGES) & 1);
          const float4* raw = reinterpret_cast<const float4*>(st + T_A_BYTES);
          uint4* hi = reinterpret_cast<uint4*>(st + T_A_BYTES + T_B_BYTES);
          uint4* lo = hi + T_B_BYTES / 16;
          for (int i = tid - 32; i < T_B_BYTES / 16; i += T_SPLITTERS) {
            const float4 v = raw[i];
            uint4 h, l;
            split_tf32(v.x, h.x, l.x);
            split_tf32(v.y, h.y, l.y);
            split_tf32(v.z, h.z, l.z);
            split_tf32(v.w, h.w, l.w);
            hi[i] = h;
            lo[i] = l;
          }
          // these generic-proxy writes, visible to the consumers' wgmmas
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(&ready[s]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, warp = tid / 32, lane = tid % 32;
  // this lane's ldmatrix row of the A tile (rows 0-7 and 8-15 of the warp's
  // 16 for tiles 0, 2 and 1, 3) and its column chunk's offset (columns 0-3
  // and 4-7 of a k-step for tiles 0, 1 and 2, 3), before the swizzle
  const int a_row = 64 * c + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_chunk = lane >> 4;
  float total[32], big[32], small[32];
  uint32_t a[2][4][8];  // [stage parity][k-step][hi 0-3, lo 4-7]
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(u, tiles, col_tiles, splits, k_stages);
    const int nst = w.k1 - w.k0;
#pragma unroll
    for (int i = 0; i < 32; ++i) total[i] = 0.f;

    // Stage j of a promotion interval, its A fragments in a[P]: its
    // wgmmas are issued behind the previous stage's, which then retire,
    // and that stage goes back to the producer.
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

    if (w.row0 + 64 * c >= n) continue;  // no live row
    // Accumulator register 4jj + 2i + e holds row 16 * warp + lane / 4 + 8i
    // of this warpgroup's 64, column 8jj + 2 (lane % 4) + e.
    const int row = w.row0 + 64 * c + 16 * warp + lane / 4;
    float* dst = out + (EPI == T_PART ? (size_t)w.split * n * ld_out : 0);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = w.col0 + 8 * jj + 2 * (lane % 4);
      if (col >= out_cols) continue;  // out_cols is even, so col + 1 < out_cols too
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
}

// A split phase's result: out[r, col] = epilogue(part[0] + part[1] + ...
// + part[splits - 1]) for rows r < n and columns col < width (a multiple of
// 4), summed in that order, then + bias[col] (zero at and past `cols`), and
// with GELU the exact-erf GELU, columns at or past `cols` written as 0.
// part is (splits, n, ld) f32, out (n, ld).
template <bool GELU>
__global__ void split_sum_kernel(const float* __restrict__ part, const float* __restrict__ bias,
                                 float* __restrict__ out, int n, int ld, int width, int cols,
                                 int splits) {
  const long long quads = (long long)n * (width / 4);
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < quads;
       q += (long long)gridDim.x * blockDim.x) {
    const long long r = q / (width / 4);
    const int col = (int)(q % (width / 4)) * 4;
    const long long at = r * ld + col;
    float4 v = *reinterpret_cast<const float4*>(part + at);
    for (int s = 1; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(part + (long long)s * n * ld + at);
      v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
    }
    float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool keep = col + k < cols;
      e[k] += keep ? bias[col + k] : 0.f;
      if (GELU) e[k] = keep ? gelu_erf(e[k]) : 0.f;
    }
    *reinterpret_cast<float4*>(out + at) = make_float4(e[0], e[1], e[2], e[3]);
  }
}

constexpr int SUM_THREADS = 256;

// One phase on `blocks` persistent blocks: A (rows, k) @ B (b_rows, k)^T
// over k_stages stages of 32, into (rows, ld_out) tiles of col_tiles x 64
// columns; with splits > 1, partial sums into part (splits, rows, ld_out)
// and their sum into out.  `cols`: the bias's (and the GELU's mask's) bound.
template <bool GELU>
cudaError_t launch_tf32x3(int device, const CUtensorMap& map_a, const CUtensorMap& map_b,
                          const float* bias, float* part, float* out, int ld_out, int rows,
                          int cols, int k_stages, int col_tiles, int splits, int blocks,
                          int sms, cudaStream_t stream) {
  constexpr int EPI = GELU ? T_GELU : T_BIAS;
  const int tiles = ((rows + T_BM - 1) / T_BM) * col_tiles;
  // columns a tile writes, and a split's sum reads: ld_out is a multiple of
  // 4, col_tiles * 64 of 64
  const int width = std::min(ld_out, col_tiles * T_BN);
  static std::atomic<unsigned long long> smem_set[2]{};  // one bit a device
  auto* direct = wide_tf32x3_kernel<EPI>;
  auto* split = wide_tf32x3_kernel<T_PART>;
  auto* kernel = splits == 1 ? direct : split;
  cudaError_t err =
      raise_smem_limit_once((const void*)kernel, (int)T_SMEM, device, smem_set[splits > 1]);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, T_THREADS, T_SMEM, stream>>>(map_a, map_b, bias, splits == 1 ? out : part,
                                                ld_out, rows, width, cols, k_stages, tiles,
                                                col_tiles, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long quads = (long long)rows * (width / 4);
  const int grid = (int)std::min<long long>((quads + SUM_THREADS - 1) / SUM_THREADS, 8LL * sms);
  split_sum_kernel<GELU><<<grid, SUM_THREADS, 0, stream>>>(part, bias, out, rows, ld_out, width,
                                                           cols, splits);
  return cudaGetLastError();
}

// The wide regime's hidden sizes: above 64 and at most 8,192, rows of a
// multiple of 16 bytes (`align` elements).
bool is_wide(int d, int align) { return d > 64 && d <= 8192 && d % align == 0; }

}  // namespace

// K1's narrow f32 body (`mlp_narrow_f32.cuh`): n token rows a model,
// `models` weight sets (P >= 1), active_p the width mask of each model on the
// device or null for `active` in all, on `splits` x `groups` clusters a
// model (`fused_mlp.k1_narrow_f32_plan`; groups = ceil(n / 64), a row tile
// each).  d in {8, 16, 32, 64}.  Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for a shape or plan the body does
// not take (nothing launched).  n == 0 launches nothing.
extern "C" int fused_mlp_narrow_f32_launch(int device, const float* x, const float* w1,
                                           const float* b1, const float* w2, const float* b2,
                                           float* out, int n, int d, int m, int active,
                                           const int* active_p, int models, int splits,
                                           int groups, void* stream) {
  return (int)narrow_f32::launch(device, x, w1, b1, w2, b2, out, n, d, m, active, active_p,
                                 models, splits, groups, static_cast<cudaStream_t>(stream));
}

// The narrow f32 body's shape at hidden size d and `splits` blocks a
// cluster, as `narrow_f32::describe` lists it (7 ints).
extern "C" int fused_mlp_narrow_f32_shape(int device, int d, int splits, int* out) {
  return (int)narrow_f32::describe(device, d, splits, out);
}

// The bf16 wide regime (64 < d <= 8,192, d a multiple of 8): one model, a
// host width.  x (n, d), w1 (m, d), b1
// (m), w2 (d, m) with row stride ld_w2 (m, or m rounded up to 8 for a
// zero-padded copy: TMA needs 16-byte row strides), b2 (d), h (n, ld_h) the
// scratch for gelu(fc1) with ld_h = m rounded up to 8, out (n, d); every
// base 16-byte aligned.  Two launches on `stream`: fc1 + GELU into h over the
// first ceil(active / 128) column tiles (ceil(d / 64) k-tiles), then fc2 +
// b2 over ceil(active / 64) k-tiles of h.  Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a shape or layout it does not take
// (nothing launched).  n == 0 launches nothing.
extern "C" int fused_mlp_wide_launch(int device, const void* x, const void* w1, const void* b1,
                                     const void* w2, int ld_w2, const void* b2, void* h,
                                     int ld_h, void* out, int n, int d, int m, int active,
                                     void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!is_wide(d, 8) || m < 1 || ld_w2 < m || ld_h < m || ld_h % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return (int)err;
  active = std::min(std::max(active, 0), m);
  if (active > 0) {
    err = launch_gemm<FC1_BN, true>(device, x, d, d, w1, m, d, d, h, ld_h, ld_h, b1, active,
                                    n, (d + G_BK - 1) / G_BK, (active + FC1_BN - 1) / FC1_BN,
                                    sms, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int k_tiles = (active + G_BK - 1) / G_BK;
  const int row_tiles = (n + G_BM - 1) / G_BM;
  const int wide_cols = (d + FC2_BN_WIDE - 1) / FC2_BN_WIDE;
  if (row_tiles * wide_cols >= sms)
    return (int)launch_gemm<FC2_BN_WIDE, false>(device, h, ld_h, ld_h, w2, d, m, ld_w2, out, d,
                                                d, b2, d, n, k_tiles, wide_cols, sms, stream);
  return (int)launch_gemm<FC2_BN_NARROW, false>(device, h, ld_h, ld_h, w2, d, m, ld_w2, out, d,
                                                d, b2, d, n, k_tiles,
                                                (d + FC2_BN_NARROW - 1) / FC2_BN_NARROW, sms,
                                                stream);
}

// The f32 wide regime (64 < d <= 8,192, d a multiple of 4): one model, a
// host width.  x (n, d), w1 (m, d), b1
// (m), w2 (d, m) with row stride ld_w2 (m, or m rounded up to 4 for a
// zero-padded copy: TMA needs 16-byte row strides), b2 (d), h (n, ld_h)
// the scratch for gelu(fc1) with ld_h = m rounded up to 4, part the
// scratch of the split phases' partial sums (max(splits1 * ld_h, splits2 *
// d) * n floats; unused, and may be null, when both are 1), out (n, d);
// every base 16-byte aligned.  fc1 + GELU into h over the first
// ceil(active / 64) column tiles on blocks1 blocks in splits1 K splits, then
// fc2 + b2 over ceil(active / 32) k-stages of h on blocks2 blocks in
// splits2 K splits (`fused_mlp.wide_f32_plan` lays both out); a split phase
// is a second launch that sums its splits in order.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape, layout or plan it does not take (nothing launched).  n == 0
// launches nothing.
extern "C" int fused_mlp_wide_f32_launch(int device, const void* x, const void* w1,
                                         const void* b1, const void* w2, int ld_w2,
                                         const void* b2, void* h, int ld_h, void* part,
                                         void* out, int n, int d, int m, int active,
                                         int splits1, int blocks1, int splits2, int blocks2,
                                         void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!is_wide(d, 4) || m < 1 || ld_w2 < m || ld_w2 % 4 != 0 || ld_h < m || ld_h % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return (int)err;
  active = std::min(std::max(active, 0), m);
  const int row_tiles = (n + T_BM - 1) / T_BM;
  const int cols1 = (active + T_BN - 1) / T_BN, k1 = (d + T_BK - 1) / T_BK;
  const int cols2 = (d + T_BN - 1) / T_BN, k2 = (active + T_BK - 1) / T_BK;
  // a plan the kernels take: every split holds a stage, every block a unit
  const auto bad = [](int splits, int blocks, int tiles, int k) {
    return splits < 1 || splits > std::max(k, 1) || blocks < 1 || blocks > tiles * splits;
  };
  if ((active > 0 && bad(splits1, blocks1, row_tiles * cols1, k1)) ||
      bad(splits2, blocks2, row_tiles * cols2, k2) ||
      (((active > 0 && splits1 > 1) || splits2 > 1) && part == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w1, map_h, map_w2;
  if (!encode_map_3d(&map_x, x, 1, n, d, d, T_BK, T_BM, 128, 4) ||
      !encode_map_3d(&map_w1, w1, 1, m, d, d, T_BK, T_BN, 128, 4) ||
      !encode_map_3d(&map_h, h, 1, n, ld_h, ld_h, T_BK, T_BM, 128, 4) ||
      !encode_map_3d(&map_w2, w2, 1, d, ld_w2, ld_w2, T_BK, T_BN, 128, 4))
    return (int)cudaErrorInvalidValue;
  float* scratch = static_cast<float*>(part);
  if (active > 0) {
    err = launch_tf32x3<true>(device, map_x, map_w1, static_cast<const float*>(b1), scratch,
                              static_cast<float*>(h), ld_h, n, active, k1, cols1, splits1,
                              blocks1, sms, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_tf32x3<false>(device, map_h, map_w2, static_cast<const float*>(b2), scratch,
                                   static_cast<float*>(out), d, n, d, k2, cols2, splits2, blocks2,
                                   sms, stream);
}

extern "C" const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

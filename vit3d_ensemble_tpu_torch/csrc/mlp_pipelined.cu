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
// FP32 pipes, not the 4*n*D*M multiply-adds (`mlp_pipeline.cuh` gives the
// serving shape's figures).
//
// bf16 with D in {16, 32, 64} (`pipelined_wgmma_kernel`): the persistent,
// warp-specialised `wgmma` pipeline of `mlp_pipeline.cuh` (a producer
// warpgroup feeding x row tiles and 64-column stages of w1, w2 and b1 by
// TMA; two consumer warpgroups issuing fc1 of the next item while they run
// the GELU of this one), fc2 summed in one accumulator over all of M; on
// `k1c_plan`'s grid.  K1b runs the same pipeline with fc2 summed chunk by
// chunk.  This body also serves every K1 bf16 call at D >= 16 (counted as
// K1's launches there), the serving pass and the latency path included.
// The grid: the parent's gave each model ceil(slots / models) blocks, which
// at 30 models left a second, nearly empty wave; `k1c_plan` balances the
// row tiles over at most the resident slots.
//
// bf16 at D = 8 (`pipelined_wgmma_d8_kernel`, every bf16 D from 1 to 8):
// the same pipeline at fc1's K of 16 (TMA zero-fills x's and w1's columns
// 8-15) and fc2 on wgmma m64n8k16, with the hidden columns split across the
// blocks of a cluster where the row tiles are few (`mlp_pipeline.cuh`), on
// the grid `fused_mlp.k1_d8_plan` lays out; K1's bf16 calls at D <= 8 run it
// too.  It replaced a CUDA-core tiling (64-row tiles, both products on FFMAs
// beside the GELUs, each block walking all of M alone), which on an H100 took
// 4.4 times the library chain's time at 2,056 rows (PERF.md).
//
// f32 at D in {8, 16, 32, 64}: K1's narrow f32 body (`mlp_narrow_f32.cuh`,
// 3xTF32 on `wgmma`, the hidden columns split across a cluster), through
// this library's own entry (`mlp_pipelined_f32_launch`) in K1c's row-tile
// order: half as many row-tile groups as K1's, each walking two consecutive
// row tiles (`fused_mlp.k1c_narrow_f32_groups`).  A tile's sums run as K1's,
// so the two agree to the bit.  It replaced a copy of K1's CUDA-core f32
// tiling on this library's persistent grid.
//
// The wide regime, every D above 64, with the model axis
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

#include "mlp_common.cuh"
#include "mlp_narrow_f32.cuh"
#include "mlp_pipeline.cuh"
#include "mlp_wide.cuh"
#include "sm90_common.cuh"

namespace {

using namespace mlp;
using namespace sm90;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16, D in {16, 32, 64}: the wgmma pipeline of `mlp_pipeline.cuh`, fc2
// summed over all of M in one accumulator.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(pipeline::W_THREADS, 1)
pipelined_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w1,
                       const __grid_constant__ CUtensorMap map_w2,
                       const __grid_constant__ CUtensorMap map_b1, const bf16* __restrict__ b2,
                       bf16* __restrict__ out, int n, int m,
                       const int* __restrict__ active_p, int active_all) {
  pipeline::pipeline_body<D, false>(map_x, map_w1, map_w2, map_b1, b2, out, n, m, active_p,
                                    active_all);
}

// ---------------------------------------------------------------------------
// bf16 at D = 8: the same pipeline, the hidden columns split across a
// cluster of `splits` blocks.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(pipeline::W_THREADS, 1)
pipelined_wgmma_d8_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w1,
                          const __grid_constant__ CUtensorMap map_w2,
                          const __grid_constant__ CUtensorMap map_b1,
                          const bf16* __restrict__ b2, bf16* __restrict__ out, int n, int m,
                          const int* __restrict__ active_p, int active_all, int splits) {
  pipeline::pipeline_body<8, false>(map_x, map_w1, map_w2, map_b1, b2, out, n, m, active_p,
                                    active_all, splits);
}

}  // namespace

// n token rows per model, `models` weight sets (P >= 1), active_p the
// per-model width mask on the device or null for `active` in all; dtype 1 =
// bfloat16 (f32 takes `mlp_pipelined_f32_launch`).  D in {8, 16, 32, 64};
// anything else returns cudaErrorInvalidValue.  Besides: ld2, the row length
// of w2 and of b1 in elements (m, or m rounded up to 8 in zero-padded copies:
// TMA reads them, and their row strides must be multiples of 16 bytes);
// blocks, the grid's row-tile groups a model (`k1c_plan`, `k1_d8_plan`); and
// splits, the blocks of a group's cluster (D = 8, `k1_d8_plan`: with splits
// > 1 blocks must be the row tiles; 1 at D 16-64).
extern "C" int mlp_pipelined_launch(int device, const void* x, const void* w1,
                                    const void* b1, const void* w2, int ld2, const void* b2,
                                    void* out, int n, int d, int m, int active,
                                    const int* active_p, int models, int blocks, int splits,
                                    int dtype, void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || models == 0) return 0;
  if (blocks < 1 || models > 65535 || (d != 8 && splits != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
#define WGMMA_LAUNCH(D)                                                                     \
  (int)pipeline::launch<D, false>(pipelined_wgmma_kernel<D>, device, x, w1, b1, w2, ld2, b2,  \
                                  out, n, m, active, active_p, models, blocks, stream)
  if (dtype == 1) {
    switch (d) {
      case 8:
        return (int)pipeline::launch_split<false>(pipelined_wgmma_d8_kernel, device, x, w1, b1,
                                                  w2, ld2, b2, out, n, m, active, active_p,
                                                  models, blocks, splits, stream);
      case 16: return WGMMA_LAUNCH(16);
      case 32: return WGMMA_LAUNCH(32);
      case 64: return WGMMA_LAUNCH(64);
    }
  }
#undef WGMMA_LAUNCH
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
#define WGMMA_SHAPE(D) (int)pipeline::shape<D, false>(pipelined_wgmma_kernel<D>, device, out)
  if (dtype == 1) {
    switch (d) {
      case 8: return (int)pipeline::shape<8, false>(pipelined_wgmma_d8_kernel, device, out);
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
  return (int)cudaErrorInvalidValue;
}

// The bf16 body at D = 8: the clusters of `splits` blocks (1-16) the card
// holds at once, into *out.
extern "C" int mlp_pipelined_d8_clusters(int device, int splits, int* out) {
  const cudaError_t err = cudaSetDevice(device);
  return err != cudaSuccess
             ? (int)err
             : (int)pipeline::clusters<false>(pipelined_wgmma_d8_kernel, device, splits, out);
}

// K1c's wide regime in bf16 (d > 64, a multiple of 8), with the
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
  if (!wide::wide_shape_ok(n, d, m, ld_w2, ld_h, models, 8) || ready == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return (int)wide::run_queue_bf16(device, x, w1, b1, w2, ld_w2, b2, h, ld_h, ready, out, n, d,
                                   m, active, active_p, models, lead, blocks,
                                   static_cast<cudaStream_t>(stream));
}

// K1c's wide regime in f32 (d > 64, a multiple of 4): the
// arguments of `mlp_pipelined_wide_launch`, ld_w2 and ld_h multiples of 4.
extern "C" int mlp_pipelined_wide_f32_launch(int device, const void* x, const void* w1,
                                             const void* b1, const void* w2, int ld_w2,
                                             const void* b2, void* h, int ld_h, int* ready,
                                             void* out, int n, int d, int m, int active,
                                             const int* active_p, int models, int lead,
                                             int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wide::wide_shape_ok(n, d, m, ld_w2, ld_h, models, 4) || ready == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return (int)wide::run_queue_f32(device, x, w1, b1, w2, ld_w2, b2, h, ld_h, ready, out, n, d,
                                  m, active, active_p, models, lead, blocks,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* mlp_pipelined_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

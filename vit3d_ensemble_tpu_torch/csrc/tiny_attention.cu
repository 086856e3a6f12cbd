// K2: tiny-head attention, o = softmax(q k^T / sqrt(hd)) v for every head of
// every volume, hd <= 16.
//
// Replaces the TPU kernel
// `vit3d_ensemble_tpu/ops/pallas_attention.py:_tiny_attention_kernel`
// (reached through `fused_attention` -> `_tiny_attention_impl`, hd <= 16).
//
// Layout: q, k, v are (B, H, S, hd) views with unit stride along hd and any
// other strides, in elements: the serving model hands over the (B, T, 3, H,
// hd) QKV product permuted, so a token's q|k|v for all heads is one
// contiguous row and nothing is copied first; the attention sublayer's core
// (K3) hands over the (B, T, D) views of its (B, T, 3D) QKV buffer, read as
// their heads (`tiny_attention_qkv_launch`).  o is written (B, S, H, hd)
// contiguous, so the model's merge of the heads is a view.  f32 or bf16.
//
// What bounds it on the H100, at the serving shapes (B = 512, S = 65, bf16):
//   * hd 16 (4 heads): bytes.  q, k, v and o are 17 MB, 5.1 us at 3.35 TB/s.
//     The 4 S^2 hd multiply-adds would take ~8 us on CUDA cores in f32; on
//     the tensor cores they take well under 1 us.
//   * hd 4 and 1 (8 and 16 heads): the S^2 exponentials, 17.3 M and 34.6 M,
//     4.1 and 8.3 us at 16 a clock an SM, above the bytes (2.5 and 1.3 us).
//     There every instruction spent on a score besides its exponential
//     competes for the same issue slots.
//
// Two bodies, by what bounds each regime:
//
// `tiny_attention_tc_*`, bf16 at 8 < hd <= 16: tensor cores through
// mma.sync m16n8k16 (bf16 in, f32 accumulate).  One warp takes a 16-row
// query tile of one (volume, head); S = 65 is five warps, the fifth with one
// live row, which costs a fifth more exponentials but no extra pass.  q, k
// and v rows sit in shared memory as 32-byte rows whose halves are swizzled,
// so ldmatrix is conflict-free (hd < 16 zero-filled).  S k^T is one k-step a
// tile of 8 keys; the scores of up to 80 keys (128 past S = 80) stay in
// registers, so the row max is taken first and nothing is rescaled; longer
// S walks chunks with the online softmax.  The score accumulators turn into
// P's A fragments in place (FlashAttention-2): exp(s - max) is rounded to
// bf16 unnormalised, as K4 rounds it; the row sums stay f32 and the context
// is divided and rounded once.  At S <= 80 with hd = 16 and 16-byte aligned
// rows (the serving pass), `tiny_attention_tc_stream_kernel` keeps as many
// blocks as fit on the card, each walking (volume, head) items and loading
// the next item's rows by cp.async into a second buffer while it computes
// this one: a block per item left the loads' latency exposed (0.0214 ms at
// (512, 4, 65, 16) against 0.0142 streamed, NVIDIA H100 80GB HBM3, 700 W).
// Elsewhere `tiny_attention_tc_kernel` takes a block per (volume, head).
//
// `tiny_attention_simt_kernel`, f32 at every hd and bf16 at hd <= 8: CUDA
// cores.  A block owns one volume, a group of heads and a tile of query
// rows; a thread takes one head and R rows of it (4 at hd <= 4, 2 above, 1
// where threads would be scarce, as in training's 4-volume batches), so each
// staged key's k and v are read once for R scores.  The heads of a group
// fill the lanes, so the 65th row shares its warp with other heads instead
// of idling 31 lanes.  The block stages the group's k and v of a chunk of
// keys as f32: a chunk is a contiguous run of each token's row, read 16
// bytes a load where the heads are adjacent and aligned, so the reads are
// coalesced at any hd, and a warp's loads of one key touch at most 32
// distinct words.  The softmax is built around the exponentials: the scale
// and log2 e are folded into one FMA before a single `ex2.approx.ftz.f32` a
// score.  At hd 1 a row's max is exact in closed form (q max_j k_j or
// q min_j k_j), taken in a pass over the keys shared by all R rows, and a
// score then costs one FMA, one ex2, one add and one FMA.  Above, the
// running max moves once every 8 keys, without a branch, at one more
// exponential and hd + 1 multiplies per 8 keys; a separate max pass would
// cost hd + 2 instructions a score.  In f32 that keeps the JAX tolerance,
// 2e-5; the output is rounded to the input type once.
//
// Both bodies walk any S >= 1 and take hd = 1..16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // elements between volumes, heads, tokens
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// bf16, 8 < hd <= 16: tensor cores.

constexpr int TC_MAX_WARPS = 8;  // 16-row query tiles a pass

// Byte offset of (row, 16-byte half) in a tile of 32-byte rows; the halves
// swap every 4 rows, so the 8 rows of an ldmatrix cover all 32 banks.
__device__ __forceinline__ uint32_t swz(int row, int half) {
  return row * 32 + ((half ^ ((row >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b for one 16x8x16 tile (A row-major, B column-major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !live.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0));
}

// Rows [0, total) of a swizzled tile from `src` (row r at src + r * ss);
// rows at or past `live` and columns at or past hd are zero.  VEC: hd = 16
// and 16-byte aligned rows, copied by cp.async (the caller waits); else by
// element through registers.
template <bool VEC>
__device__ __forceinline__ void stage_rows(char* tile, const __nv_bfloat16* __restrict__ src,
                                           long long ss, int live, int total, int hd) {
  if constexpr (VEC) {
    for (int c = threadIdx.x; c < total * 2; c += blockDim.x) {
      const int r = c >> 1, half = c & 1;
      cp_async16(smem_u32(tile) + swz(r, half), src + (r < live ? r * ss + half * 8 : 0),
                 r < live);
    }
  } else {
    for (int e = threadIdx.x; e < total * 16; e += blockDim.x) {
      const int r = e >> 4, d = e & 15;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (r < live && d < hd) val = src[r * ss + d];
      *reinterpret_cast<__nv_bfloat16*>(tile + swz(r, d >> 3) + (d & 7) * 2) = val;
    }
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp's 16 query rows (A fragments qa) against nk <= 16 * PAIRS keys
// staged in ks and vs, folded into the rows' running max (raw scores), sum
// and context (rows g and g + 8 of the tile, g = lane / 4).
template <int PAIRS>
__device__ __forceinline__ void tc_chunk(const uint32_t (&qa)[4], const char* ks,
                                         const char* vs, int nk, bool first, float c,
                                         float (&mx)[2], float (&sum)[2], float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int pairs = (nk + 15) / 16;
  // scores: two 8-key tiles a 16-key step, one mma each
  float s[2 * PAIRS][4];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    if (p < pairs) {
      uint32_t kb[4];
      ldmatrix_x4(kb, smem_u32(ks) + swz(p * 16 + (lane & 7) + ((lane >> 4) << 3),
                                         (lane >> 3) & 1));
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * p][e] = s[2 * p + 1][e] = 0.f;
      mma_bf16(s[2 * p], qa, kb[0], kb[1]);
      mma_bf16(s[2 * p + 1], qa, kb[2], kb[3]);
    }
  }
  // keys past the chunk score -inf; the row max of the chunk
  float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2 * PAIRS; ++n) {
    if (n < 2 * pairs) {
      if (n * 8 + 8 > nk) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n * 8 + 2 * t + (e & 1) >= nk) s[n][e] = -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[n][e]);
    }
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
    cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
    const float m = fmaxf(mx[r], cm[r]);
    if (!first) {  // a later chunk: rescale what was summed so far
      const float corr = ex2((mx[r] - m) * c);
      sum[r] *= corr;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }
    mx[r] = m;
    mc[r] = m * c;
  }
  // p = 2^(s c - max c), unnormalised, summed in f32 and rounded to bf16 as
  // the A fragment of p v, 16 keys a step
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    if (p < pairs) {
      float e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = ex2(fmaf(s[2 * p + (i >> 2)][i & 3], c, -mc[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += e[i];
      }
      const uint32_t pa[4] = {pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]),
                              pack_bf16(e[4], e[5]), pack_bf16(e[6], e[7])};
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, smem_u32(vs) + swz(p * 16 + (lane & 15), lane >> 4));
      mma_bf16(acc[0], pa, vb[0], vb[1]);
      mma_bf16(acc[1], pa, vb[2], vb[3]);
    }
  }
}

// The context of a warp's tile, divided by the row sums and rounded once,
// into o (B, S, H, hd) at (volume b, head h, tile mt).
__device__ __forceinline__ void tc_store(__nv_bfloat16* __restrict__ o, int b, int h, int H,
                                         int S, int hd, int mt, const float (&sum)[2],
                                         const float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float total = sum[r];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const float inv = 1.f / total;
    const int row = mt * 16 + g + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + (((long long)b * S + row) * H + h) * hd;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int d = n * 8 + 2 * t;
      const float lo = acc[n][2 * r] * inv, hi = acc[n][2 * r + 1] * inv;
      if (d + 1 < hd && hd % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(lo, hi);
      } else {
        if (d < hd) orow[d] = __float2bfloat16(lo);
        if (d + 1 < hd) orow[d + 1] = __float2bfloat16(hi);
      }
    }
  }
}

// Any S: a block per (volume, head), a warp per 16-row query tile, passes of
// up to TC_MAX_WARPS tiles, chunks of 16 * PAIRS keys.  PAIRS: 5 (80 keys)
// where S <= 80, else 8.
template <bool VEC, int PAIRS>
__global__ void __launch_bounds__(TC_MAX_WARPS * 32, 2)
tiny_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         int H, int S, int hd, Strides sq, Strides sk, Strides sv, float c) {
  constexpr int KEYS = PAIRS * 16;
  __shared__ __align__(128) char qs[TC_MAX_WARPS * 16 * 32];
  __shared__ __align__(128) char ks[KEYS * 32];
  __shared__ __align__(128) char vs[KEYS * 32];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mtiles = (S + 15) / 16;
  const int chunks = (S + KEYS - 1) / KEYS;

  for (int m0 = 0; m0 < mtiles; m0 += warps) {
    __syncthreads();  // the previous pass's reads of qs are done
    stage_rows<VEC>(qs, q + m0 * 16 * sq.s, sq.s, S - m0 * 16, warps * 16, hd);
    if (chunks == 1 && m0 == 0) {  // one chunk: staged once for every pass
      stage_rows<VEC>(ks, k, sk.s, S, (S + 15) & ~15, hd);
      stage_rows<VEC>(vs, v, sv.s, S, (S + 15) & ~15, hd);
    }
    if (VEC) {
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const int mt = m0 + warp;
    const bool live = mt < mtiles;
    uint32_t qa[4];
    if (live) ldmatrix_x4(qa, smem_u32(qs) + swz(warp * 16 + (lane & 15), lane >> 4));
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, acc[2][4] = {};
    for (int ch = 0; ch < chunks; ++ch) {
      const int j0 = ch * KEYS, nk = min(KEYS, S - j0);
      if (chunks > 1) {
        __syncthreads();  // every warp is done with the previous chunk
        stage_rows<VEC>(ks, k + j0 * sk.s, sk.s, nk, (nk + 15) & ~15, hd);
        stage_rows<VEC>(vs, v + j0 * sv.s, sv.s, nk, (nk + 15) & ~15, hd);
        if (VEC) {
          cp_async_commit();
          cp_async_wait<0>();
        }
        __syncthreads();
      }
      if (live) tc_chunk<PAIRS>(qa, ks, vs, nk, ch == 0, c, mx, sum, acc);
    }
    if (live) tc_store(o, b, h, H, S, hd, mt, sum, acc);
  }
}

// S <= 80 with 16-byte rows (the serving shape, S = 65): one warp a 16-row
// tile, all keys in one chunk, and a persistent block that walks (volume,
// head) items gridDim.x apart, loading the next item's q, k and v by
// cp.async into the other of two buffers while it computes this one, so
// the loads' latency hides behind the exponentials.
__global__ void __launch_bounds__(5 * 32, 4)
tiny_attention_tc_stream_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o, int H, int S, int hd,
                                Strides sq, Strides sk, Strides sv, float c, int items) {
  constexpr int ROWS = 80;  // q, k, v rows a buffer
  __shared__ __align__(128) char buf[2][3][ROWS * 32];
  const int rows = (S + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto stage = [&](int item, int slot) {
    const int b = item / H, h = item % H;
    stage_rows<true>(buf[slot][0], q + b * sq.b + h * sq.h, sq.s, S, rows, hd);
    stage_rows<true>(buf[slot][1], k + b * sk.b + h * sk.h, sk.s, S, rows, hd);
    stage_rows<true>(buf[slot][2], v + b * sv.b + h * sv.h, sv.s, S, rows, hd);
  };
  int item = blockIdx.x;
  stage(item, 0);
  cp_async_commit();
  for (int it = 0; item < items; ++it, item += gridDim.x) {
    if (item + (int)gridDim.x < items) stage(item + gridDim.x, (it + 1) & 1);
    cp_async_commit();  // one group an item, empty past the last
    cp_async_wait<1>();  // this item's group has landed
    __syncthreads();
    const char(&cur)[3][ROWS * 32] = buf[it & 1];
    uint32_t qa[4];
    ldmatrix_x4(qa, smem_u32(cur[0]) + swz(warp * 16 + (lane & 15), lane >> 4));
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, acc[2][4] = {};
    tc_chunk<5>(qa, cur[1], cur[2], S, true, c, mx, sum, acc);
    tc_store(o, item / H, item % H, H, S, hd, warp, sum, acc);
    __syncthreads();  // every warp is done with this buffer before it refills
  }
}

template <bool VEC>
void launch_tc(int B, int H, int S, int hd, const void* q, const void* k, const void* v,
               void* o, const Strides& sq, const Strides& sk, const Strides& sv, float c,
               cudaStream_t st) {
  const int warps = std::min(TC_MAX_WARPS, (S + 15) / 16);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  if (S <= 80)
    tiny_attention_tc_kernel<VEC, 5>
        <<<B * H, warps * 32, 0, st>>>(qb, kb, vb, ob, H, S, hd, sq, sk, sv, c);
  else
    tiny_attention_tc_kernel<VEC, 8>
        <<<B * H, warps * 32, 0, st>>>(qb, kb, vb, ob, H, S, hd, sq, sk, sv, c);
}

// The streaming kernel's grid: as many blocks as fit on the card at once,
// no more than there are items.
cudaError_t launch_tc_stream(int device, int B, int H, int S, int hd, const void* q,
                             const void* k, const void* v, void* o, const Strides& sq,
                             const Strides& sk, const Strides& sv, float c, int sms,
                             cudaStream_t st) {
  static int per_sm[64];  // blocks an SM for 1..5 warps, by device
  const int warps = (S + 15) / 16;
  int& fit = per_sm[device & 63];
  if (fit == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, tiny_attention_tc_stream_kernel, 5 * 32, 0);
    if (err != cudaSuccess) return err;
  }
  const int items = B * H;
  const int blocks = (int)std::min<long long>(items, (long long)fit * sms);
  tiny_attention_tc_stream_kernel<<<blocks, warps * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, S, hd, sq, sk,
      sv, c, items);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32, and bf16 at hd <= 8: CUDA cores.

constexpr int SIMT_THREADS = 256;     // most threads a block
constexpr int SIMT_SMEM = 24 * 1024;  // staged k and v of a chunk, bytes
constexpr int STEP = 8;               // keys between two moves of the max

// One head's hd values of a staged key, 16 bytes a load where hd allows.
template <int HD>
__device__ __forceinline__ void load_row(float (&x)[HD], const float* p) {
  if constexpr (HD % 4 == 0) {
#pragma unroll
    for (int d = 0; d < HD / 4; ++d) {
      const float4 f = reinterpret_cast<const float4*>(p)[d];
      x[4 * d] = f.x;
      x[4 * d + 1] = f.y;
      x[4 * d + 2] = f.z;
      x[4 * d + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) x[d] = p[d];
  }
}

// N keys (k, v rows `stride` floats apart) for the thread's R query rows:
// their scores, one move of each running max `mx` (raw scores), then
// 2^(s c - mx c) into sum and acc.  Each key's k and v are read once for
// all R rows.
template <int N, int HD, int R>
__device__ __forceinline__ void keys(const float (&q)[R][HD], float (&acc)[R][HD],
                                     float (&mx)[R], float (&sum)[R], const float* k,
                                     const float* v, int stride, float c) {
  float s[R][N], m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = mx[r];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    float kf[HD];
    load_row<HD>(kf, k + u * stride);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(q[r][d], kf[d], dot);
      s[r][u] = dot;
      m[r] = fmaxf(m[r], dot);
    }
  }
  float mc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float corr = ex2((mx[r] - m[r]) * c);  // 0 before the first key
    sum[r] *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[r][d] *= corr;
    mx[r] = m[r];
    mc[r] = m[r] * c;
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    float vf[HD];
    load_row<HD>(vf, v + u * stride);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = ex2(fmaf(s[r][u], c, -mc[r]));
      sum[r] += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[r][d] = fmaf(p, vf[d], acc[r][d]);
    }
  }
}

// hd = 1: all nk keys for the thread's R rows in two passes.  q k_j is
// monotonic in k_j, so a row's max score is q max_j k_j or q min_j k_j: the
// first pass takes max and min over the keys, once for all R rows, and the
// second spends one FMA, one ex2, one add and one FMA a score, with no
// rescale inside the chunk.
template <int R>
__device__ __forceinline__ void keys_hd1(const float (&q)[R][1], float (&acc)[R][1],
                                         float (&mx)[R], float (&sum)[R], const float* k,
                                         const float* v, int stride, int nk, float c) {
  float kmax = -INFINITY, kmin = INFINITY;
#pragma unroll 8
  for (int j = 0; j < nk; ++j) {
    const float x = k[j * stride];
    kmax = fmaxf(kmax, x);
    kmin = fminf(kmin, x);
  }
  float qc[R], mc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float m = fmaxf(mx[r], q[r][0] >= 0.f ? q[r][0] * kmax : q[r][0] * kmin);
    const float corr = ex2((mx[r] - m) * c);  // 0 before the first chunk
    sum[r] *= corr;
    acc[r][0] *= corr;
    mx[r] = m;
    qc[r] = q[r][0] * c;
    mc[r] = m * c;
  }
#pragma unroll 8
  for (int j = 0; j < nk; ++j) {
    const float x = k[j * stride], y = v[j * stride];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = ex2(fmaf(x, qc[r], -mc[r]));
      sum[r] += p;
      acc[r][0] = fmaf(p, y, acc[r][0]);
    }
  }
}

// k and v of keys [0, nk) of the block's heads into ks, vs as f32, key j at
// j * stride; each key's run of per_key = heads * HD elements is contiguous
// in shared memory.  A thread keeps one column of the run and walks keys.
// VEC: the run is contiguous and 16-byte aligned in device memory too, and
// is read 16 bytes a load.
template <typename T, int HD>
__device__ __forceinline__ void stage_kv(float* ks, float* vs, const T* __restrict__ k,
                                         const T* __restrict__ v, const Strides& sk,
                                         const Strides& sv, int nk, int per_key, int stride,
                                         bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements a load
    const int loads = per_key / E;     // loads a key
    const int x = threadIdx.x % loads, step = blockDim.x / loads;
    for (int j = threadIdx.x / loads; j < nk && threadIdx.x < step * loads; j += step) {
      const uint4 kr = *reinterpret_cast<const uint4*>(k + j * sk.s + x * E);
      const uint4 vr = *reinterpret_cast<const uint4*>(v + j * sv.s + x * E);
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        ks[j * stride + x * E + e] = to_f32(ke[e]);
        vs[j * stride + x * E + e] = to_f32(ve[e]);
      }
    }
  } else {
    const int x = threadIdx.x % per_key, step = blockDim.x / per_key;
    const int hh = x / HD, d = x % HD;
#pragma unroll 4
    for (int j = threadIdx.x / per_key; j < nk && threadIdx.x < step * per_key; j += step) {
      ks[j * stride + x] = to_f32(k[hh * sk.h + j * sk.s + d]);
      vs[j * stride + x] = to_f32(v[hh * sv.h + j * sv.s + d]);
    }
  }
}

// The grid: blockIdx.x = (volume, head group, row tile), the tile fastest.
// A thread takes head `hl` of the group and R rows of the tile, `slot`,
// slot + slots, ...: rows of one head share each staged key's loads.
struct SimtPlan {
  int r;      // query rows a thread: r_wide(hd), or 1 where threads are scarce
  int hg;     // heads a group
  int rows;   // query rows a tile
  int tiles;  // tiles a volume's group
  int kc;     // keys a staged chunk
  int threads;
  long long blocks;
};

template <typename T, int HD, int R>
__global__ void __launch_bounds__(SIMT_THREADS)
tiny_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H, int S,
                           Strides sq, Strides sk, Strides sv, float c, int hg, int rows,
                           int tiles, int kc, bool vec) {
  __shared__ __align__(16) float kv[SIMT_SMEM / 4];
  float* ks = kv;
  float* vs = kv + kc * hg * HD;
  const int groups = (H + hg - 1) / hg;
  const int tile = blockIdx.x % tiles;
  const int grp = (blockIdx.x / tiles) % groups;
  const int b = blockIdx.x / tiles / groups;
  const int h0 = grp * hg, ng = min(hg, H - h0);
  const int i0 = tile * rows, nr = min(rows, S - i0);
  const int slots = (rows + R - 1) / R;
  const int slot = threadIdx.x / ng, hl = threadIdx.x - slot * ng;
  const bool live = slot < slots && slot < nr;
  q += b * sq.b + (h0 + hl) * sq.h + i0 * sq.s;
  k += b * sk.b + h0 * sk.h;
  v += b * sv.b + h0 * sv.h;

  float qr[R][HD], acc[R][HD], mx[R], sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = slot + r * slots;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[r][d] = live && row < nr ? to_f32(q[row * sq.s + d]) : 0.f;
      acc[r][d] = 0.f;
    }
    mx[r] = -INFINITY;
    sum[r] = 0.f;
  }
  const int stride = hg * HD;
  for (int j0 = 0; j0 < S; j0 += kc) {
    const int nk = min(kc, S - j0);
    __syncthreads();  // the previous chunk's reads of ks and vs are done
    stage_kv<T, HD>(ks, vs, k + j0 * sk.s, v + j0 * sv.s, sk, sv, nk, ng * HD, stride, vec);
    __syncthreads();
    if (!live) continue;
    const float* kr = ks + hl * HD;
    const float* vr = vs + hl * HD;
    if constexpr (HD == 1) {
      keys_hd1<R>(qr, acc, mx, sum, kr, vr, stride, nk, c);
    } else {
      int j = 0;
      for (; j + STEP <= nk; j += STEP)
        keys<STEP, HD, R>(qr, acc, mx, sum, kr + j * stride, vr + j * stride, stride, c);
      for (; j < nk; ++j)
        keys<1, HD, R>(qr, acc, mx, sum, kr + j * stride, vr + j * stride, stride, c);
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = slot + r * slots;
    if (row >= nr) continue;
    const float inv = 1.f / sum[r];
    T* orow = o + (((long long)b * S + i0 + row) * H + h0 + hl) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) orow[d] = from_f32<T>(acc[r][d] * inv);
  }
}

// Rows a thread where threads are plentiful: 4 at hd <= 4, 2 above (q and
// the sums of R rows stay in registers).
constexpr int r_wide(int hd) { return hd <= 4 ? 4 : 2; }

SimtPlan simt_plan(int B, int H, int S, int hd, int sms) {
  SimtPlan p{};
  // R rows a thread where that still leaves 128 threads an SM
  p.r = (long long)B * H * S >= 128LL * sms * r_wide(hd) ? r_wide(hd) : 1;
  p.hg = std::min(H, std::max(1, 32 / hd));  // a key's k of a group: <= 32 words
  for (;;) {
    const int most_rows = std::max(1, SIMT_THREADS / p.hg) * p.r;
    p.tiles = (S + most_rows - 1) / most_rows;
    p.rows = (S + p.tiles - 1) / p.tiles;  // near-equal tiles
    p.blocks = (long long)B * ((H + p.hg - 1) / p.hg) * p.tiles;
    // small batches (training: 4 volumes) spread over more, narrower blocks
    if (p.hg == 1 || p.blocks >= 2LL * sms) break;
    p.hg = (p.hg + 1) / 2;
  }
  p.kc = std::min(S, SIMT_SMEM / (8 * p.hg * hd));
  p.threads = (p.hg * ((p.rows + p.r - 1) / p.r) + 31) / 32 * 32;
  return p;
}

template <typename T, int HD>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int S, const Strides& sq, const Strides& sk, const Strides& sv, float c,
                        bool aligned, int sms, cudaStream_t stream) {
  const SimtPlan p = simt_plan(B, H, S, HD, sms);
  if (p.blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  // 16-byte staging loads: each group's run of heads contiguous (head
  // stride hd) and 16-byte aligned where every group starts and ends
  constexpr int bytes = HD * (int)sizeof(T);
  const bool vec = aligned && sk.h == HD && sv.h == HD && (p.hg * bytes) % 16 == 0 &&
                   (H * bytes) % 16 == 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (p.r == 1)
    tiny_attention_simt_kernel<T, HD, 1><<<(unsigned)p.blocks, p.threads, 0, stream>>>(
        qt, kt, vt, ot, H, S, sq, sk, sv, c, p.hg, p.rows, p.tiles, p.kc, vec);
  else
    tiny_attention_simt_kernel<T, HD, r_wide(HD)><<<(unsigned)p.blocks, p.threads, 0, stream>>>(
        qt, kt, vt, ot, H, S, sq, sk, sv, c, p.hg, p.rows, p.tiles, p.kc, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_simt(int hd, const void* q, const void* k, const void* v, void* o, int B,
                          int H, int S, const Strides& sq, const Strides& sk, const Strides& sv,
                          float c, bool aligned, int sms, cudaStream_t stream) {
#define CASE(HD) \
  case HD: return launch_simt<T, HD>(q, k, v, o, B, H, S, sq, sk, sv, c, aligned, sms, stream);
  switch (hd) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    default: break;
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16 above 8: tensor cores
    switch (hd) {
      CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
      default: break;
    }
  }
#undef CASE
  return cudaErrorInvalidValue;
}

// The bodies a launch can take, in the order `tiny_attention_last_body`
// reports them.
enum Body : int { SIMT = 0, TC_BY_ELEMENT = 1, TC = 2, TC_STREAM = 3 };

// The body of this process's last successful launch (-1: none yet).
int last_body = -1;

int sm_count(int device) {  // cached: the attribute costs the host a call
  static int sms[64];
  int& n = sms[device & 63];
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    n = 0;
  return n;
}

// Whether rows may be read 16 bytes at a time where a body's layout allows
// it: the base is 16-byte aligned and the volume and token strides are
// multiples of 16 bytes.
bool aligned16(const void* p, const Strides& s, int elt) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b * elt % 16 == 0 && s.s * elt % 16 == 0;
}

int launch(int device, const void* q, const void* k, const void* v, void* o, int B, int H, int S,
           int hd, const Strides& sq, const Strides& sk, const Strides& sv, float scale,
           int dtype, bool aligned, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * H * S == 0) return 0;
  if (hd < 1 || hd > 16 || (long long)B * H >= (1LL << 31) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float c = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = sm_count(device);
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  Body body = SIMT;
  if (dtype == 1 && hd > 8) {
    const bool vec = aligned && hd == 16 && sq.h % 8 == 0 && sk.h % 8 == 0 && sv.h % 8 == 0;
    if (vec && S <= 80) {
      body = TC_STREAM;
      err = launch_tc_stream(device, B, H, S, hd, q, k, v, o, sq, sk, sv, c, sms, st);
    } else {
      body = vec ? TC : TC_BY_ELEMENT;
      if (vec)
        launch_tc<true>(B, H, S, hd, q, k, v, o, sq, sk, sv, c, st);
      else
        launch_tc<false>(B, H, S, hd, q, k, v, o, sq, sk, sv, c, st);
      err = cudaGetLastError();
    }
  } else if (dtype == 0) {
    err = dispatch_simt<float>(hd, q, k, v, o, B, H, S, sq, sk, sv, c, aligned, sms, st);
  } else {
    err = dispatch_simt<__nv_bfloat16>(hd, q, k, v, o, B, H, S, sq, sk, sv, c, aligned, sms, st);
  }
  if (err == cudaSuccess) last_body = body;
  return (int)err;
}

}  // namespace

// q, k, v: (B, H, S, hd) views, strides in elements (unit along hd); o:
// (B, S, H, hd) contiguous.  dtype: 0 = float32, 1 = bfloat16.  aligned:
// every base is 16-byte aligned and every volume and token stride a
// multiple of 16 bytes, so rows may be read 16 bytes at a time where the
// body's layout allows it (the tensor-core body at hd = 16 with a head
// stride of a multiple of 16 bytes; the CUDA-core body where a group's heads
// are adjacent).  Returns cudaGetLastError() after the launch (0 on
// success); B * H * S == 0 launches nothing.
extern "C" int tiny_attention_launch(int device, const void* q, const void* k, const void* v,
                                     void* o, int B, int H, int S, int hd, long long sqb,
                                     long long sqh, long long sqs, long long skb, long long skh,
                                     long long sks, long long svb, long long svh, long long svs,
                                     float scale, int dtype, int aligned, void* stream) {
  return launch(device, q, k, v, o, B, H, S, hd, Strides{sqb, sqh, sqs}, Strides{skb, skh, sks},
                Strides{svb, svh, svs}, scale, dtype, aligned != 0, stream);
}

// The same on the (B, T, D) views q, k, v of a (B, T, 3D) QKV buffer, read
// as H heads of D / H: each view's (volume, head, token) strides are
// (volume_stride, D / H, token_stride).  The scale 1 / sqrt(hd) and the
// alignment are worked out here, so the attention sublayer's core (K3)
// passes the fewest arguments the host must convert a call.  o: (B, T, D)
// contiguous.
extern "C" int tiny_attention_qkv_launch(int device, const void* q, const void* k, const void* v,
                                         void* o, int B, int T, int D, int H,
                                         long long volume_stride, long long token_stride,
                                         int dtype, void* stream) {
  if (H <= 0 || D % H) return (int)cudaErrorInvalidValue;
  const int hd = D / H, elt = dtype == 1 ? 2 : 4;
  const Strides s{volume_stride, hd, token_stride};
  // the three views step alike: only their bases differ
  const bool aligned = aligned16(q, s, elt) && aligned16(k, s, elt) && aligned16(v, s, elt);
  return launch(device, q, k, v, o, B, H, T, hd, s, s, s, (float)(1.0 / sqrt((double)hd)),
                dtype, aligned, stream);
}

// The body this process's last successful launch took: 0 the CUDA cores
// (`tiny_attention_simt_kernel`), 1 the tensor cores reading by element and
// 2 by 16 bytes (`tiny_attention_tc_kernel`), 3 the streamed tensor-core
// body (`tiny_attention_tc_stream_kernel`); -1 before any launch.
extern "C" int tiny_attention_last_body() { return last_body; }

extern "C" const char* tiny_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// operations a byte in bf16, 256 at S = 513, which is just below the card's
// ratio of 295.  At the stretch shape (BH = 96, S = 513, hd = 64, bf16) the
// bytes take 7.5 us and the operations 6.5 us at the tensor-core peak, so the
// two bounds nearly meet, and only tensor cores come near either.  In f32 the
// operations on CUDA cores bound it (97 us at the 67 TFLOP/s peak).
//
// Design: a block owns one (volume, head) and a tile of 64 query rows, and
// walks the keys in chunks of 64, staged with their values in shared memory.
// Per chunk it computes the (64, 64) scores, masks keys past S to -inf before
// the row max, updates the running max and sum of each row, rescales the
// context sums when the max rose, and adds exp(s - max) @ v.  Every chunk
// holds at least one live key, so the running max is finite from the first
// chunk on and the final sum is at least 1: no division by zero.  Query rows
// past S are computed on zeros and not written.  Two bodies share that plan:
//   * bf16: four warps, 16 rows each, both products on the tensor cores
//     (mma.sync m16n8k16, f32 accumulation).  A warp keeps its q rows as A
//     fragments in registers.  The score accumulators are laid out exactly as
//     the A fragments of the second product, so the probabilities go from one
//     product to the next in registers, rounded to bf16 there (unnormalised:
//     the TPU kernel rounds the normalised ones, which an online softmax
//     does not have; `_plain_attention_k4` rounds where this kernel does).
//     v's B fragments come from its row-major chunk through ldmatrix.trans.
//     The chunks are double-buffered with cp.async.
//   * f32: 256 threads as a 16 x 16 grid on CUDA cores, each a 4 x 4 register
//     tile of the scores; the probabilities pass through shared memory to the
//     second product, where a thread owns 4 rows and hd / 16 columns.
//
// Layout: q, k, v are (B, H, S, hd) views with unit stride along hd and any
// strides (in elements) along B, H and S, as the model's
// `lin(x).view(B, T, H, hd).transpose(1, 2)` gives them; for bf16 the base
// pointers and strides are multiples of 16 bytes.  ctx is written (B, S, H,
// hd) contiguous, so that the model's merge of the heads is a view.
// f32 or bf16; hd in {32, 64, 128}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int ROWS = 64;  // query rows per block
constexpr int KEYS = 64;  // keys per chunk

struct Strides {  // of a (B, H, S, hd) view, in elements
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one 16x8x16 tile: a in the m16n8k16 A layout (row-major),
// b in the B layout (column-major), c in the accumulator layout.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment of a 16 (k) x 8 (n) tile stored row-major in shared memory,
// k along the rows: lane l < 16 passes the address of row l, 8 values wide.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(a));
}

// 16-byte global -> shared copy; bytes past src_bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// Stage keys j0 .. j0 + KEYS - 1 of one head and their values, rows of
// HD + 8 values (16 bytes of pad: fragment reads hit distinct banks); keys
// past s are zero-filled, so a masked probability of 0 meets a 0, never a NaN.
template <int HD>
__device__ __forceinline__ void tc_stage(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                         const __nv_bfloat16* k, const __nv_bfloat16* v,
                                         long long k_row, long long v_row, int j0, int s) {
  constexpr int KP = HD + 8;
  for (int i = threadIdx.x; i < KEYS * (HD / 8); i += TC_THREADS) {
    const int j = i / (HD / 8), p = i % (HD / 8);
    const bool live = j0 + j < s;
    cp_async16(ks + j * KP + p * 8, live ? k + (j0 + j) * k_row + p * 8 : k, live ? 16 : 0);
    cp_async16(vs + j * KP + p * 8, live ? v + (j0 + j) * v_row + p * 8 : v, live ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int HD>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * 2 * 2 * KEYS * (HD + 8);  // 2 buffers of k | v
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int s,
                    int h, Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int KP = HD + 8;
  constexpr int KS = HD / 16;  // k-steps of q k^T
  constexpr int NO = HD / 8;   // context tiles of 8 columns
  constexpr int NJ = KEYS / 8; // score tiles of 8 keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][k | v][KEYS * KP]

  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.y * ROWS + warp * 16;  // this warp's first row
  const int r_lo = row0 + g, r_hi = r_lo + 8;
  const bool warp_live = row0 < s;
  q += b * qs.b + hh * qs.h;
  k += b * ks.b + hh * ks.h;
  v += b * vs.b + hh * vs.h;

  // q rows r_lo and r_hi as the first product's A fragments, zero past s
  uint32_t qa[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int c = 16 * i + 2 * t;
    qa[i][0] = r_lo < s ? ld32(q + r_lo * qs.s + c) : 0u;
    qa[i][1] = r_hi < s ? ld32(q + r_hi * qs.s + c) : 0u;
    qa[i][2] = r_lo < s ? ld32(q + r_lo * qs.s + c + 8) : 0u;
    qa[i][3] = r_hi < s ? ld32(q + r_hi * qs.s + c + 8) : 0u;
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of rows r_lo, r_hi
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of their sums

  const int chunks = (s + KEYS - 1) / KEYS;
  tc_stage<HD>(stage, stage + KEYS * KP, k, v, ks.s, vs.s, 0, s);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) {
      __nv_bfloat16* next = stage + (buf ^ 1) * 2 * KEYS * KP;
      tc_stage<HD>(next, next + KEYS * KP, k, v, ks.s, vs.s, (c + 1) * KEYS, s);
      asm volatile("cp.async.wait_group 1;\n" ::);  // this chunk's copies landed
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* kc = stage + buf * 2 * KEYS * KP;
    const __nv_bfloat16* vc = kc + KEYS * KP;

    if (warp_live) {
      // scores of 16 rows against the chunk's 64 keys
      float sc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
        const __nv_bfloat16* kp = kc + (8 * j + g) * KP + 2 * t;
#pragma unroll
        for (int i = 0; i < KS; ++i) mma_bf16(sc[j], qa[i], ld32(kp + 16 * i), ld32(kp + 16 * i + 8));
      }

      // scale, mask the keys past s, and take each row's max over the chunk
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int key = c * KEYS + 8 * j + 2 * t;
        sc[j][0] = key < s ? sc[j][0] * scale : -INFINITY;
        sc[j][1] = key + 1 < s ? sc[j][1] * scale : -INFINITY;
        sc[j][2] = key < s ? sc[j][2] * scale : -INFINITY;
        sc[j][3] = key + 1 < s ? sc[j][3] * scale : -INFINITY;
        mx_lo = fmaxf(mx_lo, fmaxf(sc[j][0], sc[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {  // the four lanes that share a row
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      // the chunk holds a live key, so the new max is finite; the first
      // chunk's correction is exp(-inf) = 0 on sums that are 0
      const float n_lo = fmaxf(m_lo, mx_lo), n_hi = fmaxf(m_hi, mx_hi);
      const float c_lo = __expf(m_lo - n_lo), c_hi = __expf(m_hi - n_hi);
      m_lo = n_lo;
      m_hi = n_hi;
      l_lo *= c_lo;
      l_hi *= c_hi;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= c_lo;
        acc[j][1] *= c_lo;
        acc[j][2] *= c_hi;
        acc[j][3] *= c_hi;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        sc[j][0] = __expf(sc[j][0] - n_lo);
        sc[j][1] = __expf(sc[j][1] - n_lo);
        sc[j][2] = __expf(sc[j][2] - n_hi);
        sc[j][3] = __expf(sc[j][3] - n_hi);
        l_lo += sc[j][0] + sc[j][1];
        l_hi += sc[j][2] + sc[j][3];
      }

      // acc += p @ v: the probabilities, rounded to bf16, are already in the
      // A layout; v's B fragments come transposed out of its row-major chunk
#pragma unroll
      for (int i = 0; i < KEYS / 16; ++i) {
        uint32_t pa[4];
        pa[0] = pack_bf16(sc[2 * i][0], sc[2 * i][1]);
        pa[1] = pack_bf16(sc[2 * i][2], sc[2 * i][3]);
        pa[2] = pack_bf16(sc[2 * i + 1][0], sc[2 * i + 1][1]);
        pa[3] = pack_bf16(sc[2 * i + 1][2], sc[2 * i + 1][3]);
        const __nv_bfloat16* vp = vc + (16 * i + lane % 16) * KP;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vp + 8 * j);
          mma_bf16(acc[j], pa, b0, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  if (!warp_live) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float i_lo = 1.f / l_lo, i_hi = 1.f / l_hi;  // each sum holds its max's exp(0) = 1
  __nv_bfloat16* o_lo = o + (((long long)b * s + r_lo) * h + hh) * HD + 2 * t;
  __nv_bfloat16* o_hi = o + (((long long)b * s + r_hi) * h + hh) * HD + 2 * t;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (r_lo < s)
      *reinterpret_cast<uint32_t*>(o_lo + 8 * j) = pack_bf16(acc[j][0] * i_lo, acc[j][1] * i_lo);
    if (r_hi < s)
      *reinterpret_cast<uint32_t*>(o_hi + 8 * j) = pack_bf16(acc[j][2] * i_hi, acc[j][3] * i_hi);
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

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int b, int h,
                      int s, Strides qs, Strides ks, Strides vs, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  const dim3 grid(b * h, (s + ROWS - 1) / ROWS);
  attention_tc_kernel<HD><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), s, h, qs, ks, vs, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int h,
                       int s, Strides qs, Strides ks, Strides vs, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (s + ROWS - 1) / ROWS);
  attention_f32_kernel<HD><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, h, qs, ks, vs, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v: (b, h, s, hd) views with unit
// stride along hd and the given strides (elements) along b, h and s; o is
// (b, s, h, hd) contiguous.  Returns cudaGetLastError() after the launch (0
// on success).  b * h == 0 or s == 0 launches nothing.
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
#define CASE(HD)                                                                         \
  case HD:                                                                               \
    return (int)(dtype == 1 ? launch_tc<HD>(q, k, v, o, b, h, s, qs, ks, vs, scale, st)  \
                            : launch_f32<HD>(q, k, v, o, b, h, s, qs, ks, vs, scale, st));
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (hd) {
    CASE(32) CASE(64) CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

extern "C" const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

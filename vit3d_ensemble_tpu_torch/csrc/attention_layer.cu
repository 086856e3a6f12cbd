// K3: the attention core of the whole-sublayer path, ctx = softmax(q k^T /
// sqrt(hd)) v for every head of every volume, read in place from the fused
// QKV product.
//
// Replaces the TPU kernel
// `vit3d_ensemble_tpu/ops/pallas_attention_layer.py:_attn_core_kernel`
// (reached through `fused_attention_layer` -> `_attention_core`).  The TPU
// kernel takes q (B, T, D) and kvT (B, 2D, T) and writes ctx^T (B, D, T):
// transposes that suit its VMEM tiling.  Here q, k and v are read where the
// QKV matmul left them, as three (B, T, D) views of one (B, T, 3D) tensor
// whose rows are `ld` elements apart, and ctx is written (B, T, D) row-major,
// ready for the out projection.
//
// Which body serves which head_dim: this one serves hd in {1, 4, 16}, every
// D / H of the 22 registry configs, at T = 65 and 257.  hd in {32, 64, 128}
// (the stretch model's 64 at T = 513) goes to K4's tensor-core body in
// `attention.cu`, which takes the same (B, H, T, hd) views of the QKV buffer
// through their strides and writes (B, T, H, hd), the (B, T, D) layout this
// kernel writes (`ops/attention_layer.py` routes it).  Why: at T = 513 and
// hd = 64 this CUDA-core body took 0.56 ms a layer on an H100 (B = 8, 12
// heads) against K4's 0.053 ms of device time; at T = 65 and hd <= 16 it
// beats the library's fused attention (0.043 ms against 0.144 at hd = 1).
//
// What bounds it on the H100: bytes at the model's shapes.  The function
// reads q, k, v and writes ctx, 4*T*D values a volume, against 4*T*T*D
// operations: T/2 operations per byte in bf16, far below the card's ratio
// at T = 65 and 257.  hd in {1, 4} is too thin for tensor cores, so this
// body runs on CUDA cores.
//
// Design: a block owns one volume, a group of G heads and a tile of R query
// rows, one thread per (head, row).  R splits T into near-equal tiles of at
// most 128 rows, and G (a divisor of H) packs heads until the block holds up
// to 256 threads, so the thin heads (hd = 1 with H = 16) fill warps with
// rows of several heads instead of idling lanes.  The block stages the
// group's k and v columns of a chunk of keys in shared memory as f32; a
// chunk is a contiguous run of each token's row, so the staging reads are
// coalesced whatever hd is.  Each thread keeps its q row and hd context
// sums in registers and runs K2's online softmax over the keys: a running
// max, with the sums rescaled only when a key raises it, so no T x T tile
// is stored and any T works (65, 257, 513).  Where hd is a multiple of 4
// the thread reads k and v rows from shared memory 16 bytes at a time,
// since one load feeds one FMA otherwise and the loads, not the FMAs, set
// the pace.  Scores, softmax and context are f32; the output is rounded to
// the input type once, as the TPU kernel does.
//
// Layout: q, k, v point at (B, T, D) views with row stride `ld` and batch
// stride `bs` (elements) and unit column stride; o is (B, T, D) contiguous.
// f32 or bf16; hd in {1, 4, 16}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int MAX_ROWS = 128;     // query rows per tile
constexpr int MAX_THREADS = 256;  // threads per block
constexpr int SMEM_BYTES = 48 * 1024;  // staged k and v, per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// q . k over one head, k in shared memory; 16-byte loads where hd allows.
template <int HD>
__device__ __forceinline__ float dot(const float (&q)[HD], const float* k) {
  float s = 0.f;
  if constexpr (HD % 4 == 0) {
    const float4* k4 = reinterpret_cast<const float4*>(k);
#pragma unroll
    for (int d = 0; d < HD / 4; ++d) {
      const float4 kv = k4[d];
      s = fmaf(q[4 * d], kv.x, s);
      s = fmaf(q[4 * d + 1], kv.y, s);
      s = fmaf(q[4 * d + 2], kv.z, s);
      s = fmaf(q[4 * d + 3], kv.w, s);
    }
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(q[d], k[d], s);
  }
  return s;
}

// acc += p * v over one head, v in shared memory.
template <int HD>
__device__ __forceinline__ void axpy(float (&acc)[HD], float p, const float* v) {
  if constexpr (HD % 4 == 0) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll
    for (int d = 0; d < HD / 4; ++d) {
      const float4 vv = v4[d];
      acc[4 * d] = fmaf(p, vv.x, acc[4 * d]);
      acc[4 * d + 1] = fmaf(p, vv.y, acc[4 * d + 1]);
      acc[4 * d + 2] = fmaf(p, vv.z, acc[4 * d + 2]);
      acc[4 * d + 3] = fmaf(p, vv.w, acc[4 * d + 3]);
    }
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, v[d], acc[d]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(MAX_THREADS)
attention_layer_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int t, int h,
                       long long ld, long long bs, int rows, int heads, int tiles,
                       int keys, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int h0 = (blockIdx.y / tiles) * heads;       // first head of the group
  const int row = (blockIdx.y % tiles) * rows + threadIdx.x % rows;
  const int g = threadIdx.x / rows;                  // head within the group
  const bool live = g < heads && row < t;
  const int width = heads * HD;                      // staged columns a key
  float* ks = smem;
  float* vs = smem + keys * width;
  const long long base = (long long)b * bs + (long long)h0 * HD;

  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = live ? to_f32(q[base + row * ld + g * HD + d]) : 0.f;
    acc[d] = 0.f;
  }
  float mx = -INFINITY;
  float sum = 0.f;

  for (int j0 = 0; j0 < t; j0 += keys) {
    const int nk = min(keys, t - j0);
    __syncthreads();  // the previous chunk's reads of ks and vs are done
    for (int i = threadIdx.x; i < nk * width; i += blockDim.x) {
      const int j = i / width, c = i - j * width;
      const long long at = base + (j0 + j) * ld + c;
      ks[i] = to_f32(k[at]);
      vs[i] = to_f32(v[at]);
    }
    __syncthreads();
    if (!live) continue;
    const float* kh = ks + g * HD;
    const float* vh = vs + g * HD;
    for (int j = 0; j < nk; ++j) {
      const float sc = dot<HD>(qr, kh + j * width) * scale;
      if (sc > mx) {  // a new running max: rescale what was summed so far
        const float corr = expf(mx - sc);  // 0 at the first key
        sum *= corr;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= corr;
        mx = sc;
      }
      const float p = expf(sc - mx);
      sum += p;
      axpy<HD>(acc, p, vh + j * width);
    }
  }
  if (live) {
    const float inv = 1.f / sum;
    T* out = o + ((long long)b * t + row) * ((long long)h * HD) + (h0 + g) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) out[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int t,
                   int h, long long ld, long long bs, float scale, cudaStream_t stream) {
  const int tiles = (t + MAX_ROWS - 1) / MAX_ROWS;
  const int rows = (t + tiles - 1) / tiles;
  int heads = 1;  // the largest divisor of h that keeps the block <= 256 threads
  for (int g = h; g >= 1; --g) {
    if (h % g == 0 && g * rows <= MAX_THREADS) { heads = g; break; }
  }
  const int threads = (heads * rows + 31) / 32 * 32;
  const int per_key = 2 * heads * HD * (int)sizeof(float);
  const int keys = std::min({t, SMEM_BYTES / per_key, 4 * MAX_ROWS});
  const dim3 grid(b, (h / heads) * tiles);
  attention_layer_kernel<T, HD><<<grid, threads, keys * per_key, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), t, h, ld, bs, rows, heads, tiles, keys, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o, int b,
                     int t, int h, long long ld, long long bs, float scale,
                     cudaStream_t stream) {
  switch (hd) {
#define CASE(HD) \
  case HD: return launch<T, HD>(q, k, v, o, b, t, h, ld, bs, scale, stream);
    CASE(1) CASE(4) CASE(16)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  b == 0 or t == 0 launches nothing.
extern "C" int attention_layer_launch(int device, const void* q, const void* k,
                                      const void* v, void* o, int b, int t, int h,
                                      int hd, long long ld, long long bs, float scale,
                                      int dtype, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b == 0 || t == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(hd, q, k, v, o, b, t, h, ld, bs, scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(hd, q, k, v, o, b, t, h, ld, bs, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* attention_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

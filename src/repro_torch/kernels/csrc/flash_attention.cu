// Flash-attention forward for Hopper (sm_90a): streaming softmax with GQA,
// causal and sliding-window masks.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_fwd (the Pallas
// kernel _flash_kernel), for the inputs the tensor-core kernel
// (flash_attention_sm90.cu) does not take: f32 at every head dim, held to
// 2e-5, which no bf16 or TF32 product meets, and bf16 at a head dim in
// (128, 256].  kernels/flash_attention.py, route(), chooses before the launch.
//
// Bound on the H100: at the serve path's prefill shape (B=4, H=40, Kh=8,
// S=512, D=128, causal, bf16) the bytes (q, k, v read once, o written once,
// about 50 MB) take longer at 3.35 TB/s than the causal product (about
// 10.8 GFLOP) at the 989 TFLOP/s bf16 tensor-core peak; at longer sequences
// the operations bound it, since they grow with S^2 and the bytes with S.
//
// Design: this first kernel is plain and exact, not fast.  It does its math
// on the CUDA cores in f32 (no tensor cores, no TMA), so the operations are
// what limits it in practice; wgmma and TMA are left to a later change.
//  * One block per (batch*head, tile of kBQ query rows).  The TPU kernel's
//    sequential kv grid axis becomes a loop inside the block over kv tiles of
//    kBK = 32 rows staged in shared memory (as f32), read once per tile by all
//    kBQ query rows of the block.
//  * Each warp owns kRowsPerWarp query rows.  For a kv tile, lane j computes
//    the scores of key j against the warp's rows (the K tile is padded to
//    D + 1 columns so the 32 lanes hit 32 banks); the row max and sum are warp
//    shuffles; each lane keeps D / 32 columns of each row's f32 accumulator and
//    broadcasts p_j with a shuffle for the PV update.
//  * Online softmax in f32: running max m, sum l, accumulator.  Masked scores
//    give p = 0 exactly, so a row with no visible key keeps l = 0 and is
//    written as zeros, as repro/kernels/ref.py defines (the Pallas kernel
//    returns the mean of v there).
//  * GQA: q head h reads kv head h / (H / Kh).  Positions are global: query i
//    at q_offset + i, key j at j.  Ragged Sq and Skv are masked, so no shape
//    needs to divide a tile, and kv tiles wholly outside the causal/window
//    band of the query tile are skipped.
//  * Any D that is a multiple of 16 up to 256 (template on D / 32 rounded up).
//  * Optionally the row's log-sum-exp of the scaled scores, lse = m + log(l)
//    in natural-log units, f32 (B, H, Sq), as _flash_fwd saves it for the
//    backward (repro/models/attention.py); +inf for a row with no visible
//    key, so that the backward's p = exp(s - lse) is 0 there.  Lane 0 of the
//    warp that owns the row writes it, once; a null pointer skips it.
//
// C interface (loaded with ctypes): flash_attention_fwd returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // kv rows per tile: one per lane
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D);
}

// kCols = ceil(D / 32): accumulator columns per lane.
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Kh, int Sq, int Skv,
                 int D, int causal, int window, long long q_offset, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                  // kBQ x D
  float* sK = sQ + kBQ * D;          // kBK x (D + 1)
  float* sV = sK + kBK * (D + 1);    // kBK x D
  const int ldk = D + 1;

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = b * Kh + h / (H / Kh);
  const int q0 = blockIdx.y * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + (size_t)kvh * Skv * D;
  const T* vp = v + (size_t)kvh * Skv * D;
  T* op = o + (size_t)bh * Sq * D;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    sQ[i] = (q0 + r < Sq) ? to_float(qp[(size_t)(q0 + r) * D + c]) : 0.f;
  }

  // The kv band any row of this tile can see.
  const int q_last = min(q0 + kBQ, Sq) - 1;
  long long kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min((long long)Skv, q_offset + q_last + 1);
  if (window > 0) kv_begin = max(0LL, q_offset + q0 - window + 1);
  kv_begin = (kv_begin / kBK) * kBK;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (long long j0 = kv_begin; j0 < kv_end; j0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and sQ written, first time)
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const long long j = j0 + r;
      const bool in = j < Skv;
      sK[r * ldk + c] = in ? to_float(kp[(size_t)j * D + c]) : 0.f;
      sV[r * D + c] = in ? to_float(vp[(size_t)j * D + c]) : 0.f;
    }
    __syncthreads();

    // Scores of key (j0 + lane) against this warp's rows.
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = sK + lane * ldk;
    const float* qrows = sQ + (warp * kRowsPerWarp) * D;
    for (int c = 0; c < D; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] = fmaf(qrows[i * D + c], kc, s[i]);
    }

    const long long kpos = j0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const long long qpos = q_offset + q0 + r;
      bool valid = (q0 + r < Sq) && (kpos < Skv);
      if (causal) valid = valid && (kpos <= qpos);
      if (window > 0) valid = valid && (qpos - kpos < window);
      const float si = s[i] * scale;
      const float m_new = fmaxf(m[i], warp_max(valid ? si : -INFINITY));
      if (m_new == -INFINITY) {  // nothing visible yet in this row (warp-uniform)
        p[i] = 0.f;
        continue;
      }
      const float corr = expf(m[i] - m_new);  // 0 when m[i] is still -inf
      p[i] = valid ? expf(si - m_new) : 0.f;
      l[i] = l[i] * corr + warp_sum(p[i]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }

#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        vv[c] = col < D ? sV[jj * D + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], jj);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = q0 + warp * kRowsPerWarp + i;
    if (r >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * Sq + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) op[(size_t)r * D + col] = from_float<T>(l[i] > 0.f ? acc[i][c] * inv : 0.f);
    }
  }
}

template <typename T, int kCols>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Kh,
           int Sq, int Skv, int D, int causal, int window, long long q_offset, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, kCols>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, kCols><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Kh, Sq, Skv, D, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Kh,
             int Sq, int Skv, int D, int causal, int window, long long q_offset, float scale,
             cudaStream_t s) {
  switch ((D + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, lse, B, H, Kh, Sq, Skv, D, causal, window, q_offset, scale, s);
    case 2: return launch<T, 2>(q, k, v, o, lse, B, H, Kh, Sq, Skv, D, causal, window, q_offset, scale, s);
    case 3: return launch<T, 3>(q, k, v, o, lse, B, H, Kh, Sq, Skv, D, causal, window, q_offset, scale, s);
    case 4: return launch<T, 4>(q, k, v, o, lse, B, H, Kh, Sq, Skv, D, causal, window, q_offset, scale, s);
    case 5: return launch<T, 5>(q, k, v, o, lse, B, H, Kh, Sq, Skv, D, causal, window, q_offset, scale, s);
    case 6: return launch<T, 6>(q, k, v, o, lse, B, H, Kh, Sq, Skv, D, causal, window, q_offset, scale, s);
    case 7: return launch<T, 7>(q, k, v, o, lse, B, H, Kh, Sq, Skv, D, causal, window, q_offset, scale, s);
    case 8: return launch<T, 8>(q, k, v, o, lse, B, H, Kh, Sq, Skv, D, causal, window, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Kh, Skv, D), o (B, H, Sq, D), all contiguous and
// of one type; lse null or f32 (B, H, Sq).  dtype codes: 0 = float32,
// 1 = bfloat16.  The wrapper has checked shapes, types, H % Kh == 0,
// D % 16 == 0, D <= 256 and grid limits.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                   int B, int H, int Kh, int Sq, int Skv, int D, int causal,
                                   int window, long long q_offset, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  if (dtype == 0) return dispatch<float>(q, k, v, o, l, B, H, Kh, Sq, Skv, D, causal, window, q_offset, scale, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, l, B, H, Kh, Sq, Skv, D, causal, window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

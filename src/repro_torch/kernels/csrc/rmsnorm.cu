// Fused RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + w).
//
// Replaces: repro/kernels/rmsnorm.py, rmsnorm (the Pallas kernel _rmsnorm_kernel).
//
// Bound on the H100: bytes.  Each element is read, squared and scaled, a few
// operations per 4 or 8 bytes moved, far below the ~295 operations per byte at
// which the tensor cores would become the limit.  The least time is one read of
// x, one write of y and one read of w at 3.35 TB/s.
//
// Design: rows are independent, so one row is reduced by one warp (d <= 1024,
// the per-head qk-norm at d = 128 and other narrow rows) or by one block of
// 256 threads (wide rows such as d = 5120), so that the card sees tens of
// thousands of warps on the prefill shapes.  The sum of squares is taken in
// f32 and reduced with warp shuffles (and, for a block, through shared memory),
// then a second pass over the same row scales it; that second read of a row of
// at most a few tens of KB is served from L1/L2, so device memory sees x once.
// Any d is taken: the strided loops mask the tail.  Inputs are f32 or bf16, w
// in its own type; the output is written in x's type.
//
// C interface (loaded with ctypes): rmsnorm_fwd returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRowsMaxD = 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename TX, typename TW>
__device__ __forceinline__ void scale_row(const TX* xr, const TW* w, TX* yr, int d, float r,
                                          int lane, int stride) {
  for (int c = lane; c < d; c += stride) {
    const float y = to_float(xr[c]) * r * (1.0f + to_float(w[c]));
    yr[c] = from_float<TX>(y);
  }
}

// One warp per row; kThreads / 32 rows per block.
template <typename TX, typename TW>
__global__ void rmsnorm_warp_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                                    TX* __restrict__ y, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + row * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_float(xr[c]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);
  scale_row(xr, w, y + row * d, d, r, lane, 32);
}

// One block of kThreads per row.
template <typename TX, typename TW>
__global__ void rmsnorm_block_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                                     TX* __restrict__ y, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  const long long row = blockIdx.x;
  const TX* xr = x + row * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float v = to_float(xr[c]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? partial[lane] : 0.f;
    ss = warp_sum(ss);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / (float)d + eps);
  scale_row(xr, w, y + row * d, d, r, threadIdx.x, kThreads);
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* y, long long rows, int d, float eps,
            cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  if (d <= kWarpRowsMaxD) {
    const long long per_block = kThreads / 32;
    const unsigned blocks = (unsigned)((rows + per_block - 1) / per_block);
    rmsnorm_warp_kernel<TX, TW><<<blocks, kThreads, 0, stream>>>(xp, wp, yp, rows, d, eps);
  } else {
    rmsnorm_block_kernel<TX, TW><<<(unsigned)rows, kThreads, 0, stream>>>(xp, wp, yp, d, eps);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  The wrapper has checked shapes,
// types, contiguity and that rows fits the grid.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, long long rows, int d,
                           float eps, int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (x_dtype == 0 && w_dtype == 0) launch<float, float>(x, w, y, rows, d, eps, s);
    else if (x_dtype == 0 && w_dtype == 1) launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, s);
    else if (x_dtype == 1 && w_dtype == 0) launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, s);
    else if (x_dtype == 1 && w_dtype == 1)
      launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, s);
    else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Chunk accumulate for Hopper (sm_90a): the hop of the Hoplite reduce chains.
//
//   chunk_reduce_fwd: out = dst + alpha * src
//   dequant_add_fwd:  out = dst + float(q) * scale[i / qblock]
//
// Replaces: repro/kernels/chunk_reduce.py, chunk_reduce (the Pallas kernel
// _acc_kernel) and dequant_add (_dequant_add_kernel).
//
// Bound on the H100: bytes.  One multiply and one add per element against 6 to
// 12 bytes moved (dst and src read, out written; for dequant_add an int8 and a
// share of a scale in place of src), so the least time is those bytes at
// 3.35 TB/s, and nothing is kept that could save a pass.
//
// Design: a grid-stride loop, one element per thread per iteration, over at
// most kMaxBlocks blocks of kThreads; any n is taken, the loop bound masks the
// tail, so no padding copy is made.  The sum is taken in f32 with
// __fmul_rn/__fadd_rn, which the compiler may not contract into an FMA: the
// result is then the plain version's bit for bit (f32 product, rounded, then
// f32 sum, rounded, then one rounding to the output type).  `out` may alias
// `dst` (each element is read and then written by the same thread), which is
// how a chain hop accumulates in place into a chunk of its buffer; `src`, `q`
// and `scale` must not overlap `out`.  16-byte vector loads are the first step
// towards the bound.
//
// C interface (loaded with ctypes): each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks of 256 threads on each of 132 SMs

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T>
__global__ void chunk_reduce_kernel(const T* dst, const T* __restrict__ src, T* out, long long n,
                                    float alpha) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float d = to_float(dst[i]);
    const float s = to_float(src[i]);
    out[i] = from_float<T>(__fadd_rn(d, __fmul_rn(alpha, s)));
  }
}

template <typename T>
__global__ void dequant_add_kernel(const T* dst, const signed char* __restrict__ q,
                                   const float* __restrict__ scale, T* out, long long n,
                                   int qblock) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float d = to_float(dst[i]);
    const float deq = __fmul_rn((float)q[i], scale[i / qblock]);
    out[i] = from_float<T>(__fadd_rn(d, deq));
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for dst, src and out alike.  The
// wrapper has checked devices, types, sizes and contiguity.
extern "C" int chunk_reduce_fwd(const void* dst, const void* src, void* out, long long n,
                                float alpha, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (dtype == 0)
      chunk_reduce_kernel<float><<<grid_for(n), kThreads, 0, s>>>(
          static_cast<const float*>(dst), static_cast<const float*>(src),
          static_cast<float*>(out), n, alpha);
    else if (dtype == 1)
      chunk_reduce_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(dst), static_cast<const __nv_bfloat16*>(src),
          static_cast<__nv_bfloat16*>(out), n, alpha);
    else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// q: int8, at least n elements; scale: f32, one per qblock elements of q.
extern "C" int dequant_add_fwd(const void* dst, const void* q, const void* scale, void* out,
                               long long n, int qblock, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qblock <= 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const signed char* qp = static_cast<const signed char*>(q);
    const float* sp = static_cast<const float*>(scale);
    if (dtype == 0)
      dequant_add_kernel<float><<<grid_for(n), kThreads, 0, s>>>(
          static_cast<const float*>(dst), qp, sp, static_cast<float*>(out), n, qblock);
    else if (dtype == 1)
      dequant_add_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(dst), qp, sp, static_cast<__nv_bfloat16*>(out), n,
          qblock);
    else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

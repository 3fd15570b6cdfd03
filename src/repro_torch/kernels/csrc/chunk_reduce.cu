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
// Design of chunk_reduce: 16-byte loads and stores, on any alignment.  A chain
// hop accumulates into row k of a (C, chunk) buffer: with an odd chunk of bf16
// the row starts 2-byte aligned on every odd k, while src is a fresh, aligned
// tensor, so the three pointers are aligned independently.  The kernel aligns
// on `out`: a scalar head brings `out` to a 16-byte boundary, then each thread
// of a grid-stride loop (at most kMaxBlocks blocks of kThreads) writes
// 16 aligned bytes of `out` per step (8 bf16 or 4 f32).  dst and src are read
// with aligned 16-byte loads of the window that covers those bytes, one load
// where the pointer shares `out`'s alignment and two otherwise, and realigned
// in registers with __funnelshift_r.  A scalar tail takes the rest, so any n
// is taken and no padding copy is made.  The sum is taken in f32 with
// __fmul_rn/__fadd_rn, which the compiler may not contract into an FMA: the
// result is then the plain version's bit for bit (f32 product, rounded, then
// f32 sum, rounded, then one rounding to the output type).  `out` may alias
// `dst` (the same pointer: each element is read and then written by the same
// thread), which is how a chain hop accumulates in place into a chunk of its
// buffer; otherwise out must not overlap dst, and src must not overlap out.
//
// dequant_add is still a grid-stride loop of one element per thread per
// iteration.
//
// C interface (loaded with ctypes): each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void unpack(uint4 w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x); f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z); f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(uint4 w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high half of the f32 bits
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // round to nearest even
    u[i] = *reinterpret_cast<uint32_t*>(&v);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// The 16 bytes at byte `shift` (0..15, a multiple of the element size) of the
// 32 bytes w0:w1, little-endian.
__device__ __forceinline__ uint4 realign(uint4 w0, uint4 w1, int shift) {
  const int sh = (shift & 3) * 8;
  uint32_t a0, a1, a2, a3, a4;
  switch (shift >> 2) {  // uniform over the kernel
    case 0: a0 = w0.x; a1 = w0.y; a2 = w0.z; a3 = w0.w; a4 = w1.x; break;
    case 1: a0 = w0.y; a1 = w0.z; a2 = w0.w; a3 = w1.x; a4 = w1.y; break;
    case 2: a0 = w0.z; a1 = w0.w; a2 = w1.x; a3 = w1.y; a4 = w1.z; break;
    default: a0 = w0.w; a1 = w1.x; a2 = w1.y; a3 = w1.z; a4 = w1.w; break;
  }
  return make_uint4(__funnelshift_r(a0, a1, sh), __funnelshift_r(a1, a2, sh),
                    __funnelshift_r(a2, a3, sh), __funnelshift_r(a3, a4, sh));
}

// 16 bytes starting `shift` bytes into the aligned word p[0].
__device__ __forceinline__ uint4 load16(const uint4* p, int shift) {
  const uint4 w0 = p[0];
  return shift == 0 ? w0 : realign(w0, p[1], shift);
}

template <typename T>
__device__ __forceinline__ void reduce_one(const T* dst, const T* src, T* out, long long i, float alpha) {
  out[i] = from_float<T>(__fadd_rn(to_float(dst[i]), __fmul_rn(alpha, to_float(src[i]))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_reduce_kernel(const T* dst, const T* __restrict__ src, T* out, long long n, float alpha) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16 bytes
  const long long head = min(n, (long long)(((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / sizeof(T)));
  const long long nvec = (n - head) / kVec;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = first; i < head; i += stride) reduce_one(dst, src, out, i, alpha);
  for (long long i = head + nvec * kVec + first; i < n; i += stride) reduce_one(dst, src, out, i, alpha);

  const char* dp = reinterpret_cast<const char*>(dst + head);
  const char* sp = reinterpret_cast<const char*>(src + head);
  const int dshift = (int)(reinterpret_cast<uintptr_t>(dp) & 15);
  const int sshift = (int)(reinterpret_cast<uintptr_t>(sp) & 15);
  const uint4* d4 = reinterpret_cast<const uint4*>(dp - dshift);
  const uint4* s4 = reinterpret_cast<const uint4*>(sp - sshift);
  uint4* o4 = reinterpret_cast<uint4*>(out + head);
  for (long long v = first; v < nvec; v += stride) {
    float d[kVec], s[kVec];
    unpack(load16(d4 + v, dshift), d);
    unpack(load16(s4 + v, sshift), s);
#pragma unroll
    for (int e = 0; e < kVec; ++e) d[e] = __fadd_rn(d[e], __fmul_rn(alpha, s[e]));
    o4[v] = pack(d);
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

// chunk_reduce: a thread per 16 bytes of out, at least one block for the
// head and tail.
template <typename T>
unsigned grid_for_vec(long long n) {
  return grid_for(n / (16 / (long long)sizeof(T)) + 1);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for dst, src and out alike.  The
// wrapper has checked devices, types, sizes and contiguity.
extern "C" int chunk_reduce_fwd(const void* dst, const void* src, void* out, long long n,
                                float alpha, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (dtype == 0)
      chunk_reduce_kernel<float><<<grid_for_vec<float>(n), kThreads, 0, s>>>(
          static_cast<const float*>(dst), static_cast<const float*>(src),
          static_cast<float*>(out), n, alpha);
    else if (dtype == 1)
      chunk_reduce_kernel<__nv_bfloat16><<<grid_for_vec<__nv_bfloat16>(n), kThreads, 0, s>>>(
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

// Fused RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + w).
//
// Replaces: repro/kernels/rmsnorm.py:25, rmsnorm (the Pallas kernel _rmsnorm_kernel).
//
// Bound on the H100: bytes.  Each element is read, squared and scaled, a few
// operations per 4 or 8 bytes moved, far below the ~295 operations per byte at
// which the tensor cores would become the limit.  The least time is one read of
// x, one write of y and one read of w at 3.35 TB/s, so the design spends
// nothing on arithmetic and everything on moving those bytes once, in wide
// accesses, with enough of them in flight to cover the latency of HBM.
//
// Design.  Where a row starts 16-byte aligned (d times the element size a
// multiple of 16, x and y 16-byte aligned), it is read from device memory
// once: the threads that take it hold VPT 16-byte accesses of it each (8 bf16
// or 4 f32), in registers (static arrays: VPT is a compile-time constant of a
// template instance), from the sum of squares to the scale.  The host picks
// the instance from the accesses a row needs (nv):
//   nv <= 128       a group of 16 or 32 lanes a row (d = 128: 16 lanes of one
//                   16-byte vector in bf16, 32 in f32), 8 or 16 rows a block
//                   of 256 and, at one access a lane, two rows a thread at
//                   once; the group sums with __shfl_xor_sync over its lanes;
//   nv <= 2048      a block a row, of kWideVpt (2) accesses a thread and as
//                   many threads as that needs (320 at d = 5120 bf16), warp
//                   shuffles and then one shared-memory step for the sum
//                   across warps.
// Other rows, misaligned or wider (the scalar path, chosen on the host from d
// and the pointers), take the generic kernel: one block of 256 threads a row,
// scalar accesses, which reads the row twice, the second time from L1/L2.  No
// main path gives it a row: each x there is a fresh tensor at a width that is
// a multiple of 8.
// The grid is sized to the card (resident blocks per SM times SMs) and walks
// the rows, so each thread loads its slice of (1 + w) once, into registers,
// and keeps it for every row it takes.  Each block has the loads of its next
// rows in flight while it sums, scales and stores the current ones, and its
// first rows' loads in flight while it reads w.  Fewer accesses a thread on
// more threads a row beat 4-8 accesses on fewer threads (kernel_turns.py on
// an NVIDIA H100 80GB HBM3 at 700 W, (2048, 5120) bf16): 2 accesses on 320
// threads took 0.0170 ms, 1 on 640 0.0191, 4 on 160 0.0182.
//
// Numerics: the sum of squares in f32, r = rsqrtf(ss / d + eps), y = x * r *
// (1 + w) in f32, then one rounding to x's type, to nearest even.  A row's
// result depends only on its values, d, the types and the path (the instance
// follows from d and the path): never on the number of rows, the row's index
// or the grid, so rows normed alone equal the same rows normed in a batch, bit
// for bit.  Inputs are f32 or bf16, w in either type; the output is written
// in x's type.
//
// C interface (loaded with ctypes): rmsnorm_fwd returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroupBlock = 256;     // threads a block of narrow rows' groups
constexpr int kRowThreadsMax = 1024; // threads a block of one wide row, at most
constexpr int kWideVpt = 2;          // accesses a thread of a wide row

// W elements of T that one thread moves with one 16-byte load or store, held
// as raw 32-bit words.
template <typename T, int W>
struct Access {
  static_assert(W * sizeof(T) == 16, "an access is 16 bytes");
  unsigned int word[4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) word[i] = 0u;
  }
  __device__ __forceinline__ void load(const T* p) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    word[0] = q.x; word[1] = q.y; word[2] = q.z; word[3] = q.w;
  }
  __device__ __forceinline__ void store(T* p) const {
    *reinterpret_cast<uint4*>(p) = make_uint4(word[0], word[1], word[2], word[3]);
  }
  // Element j as a float (a bf16's bits are a float's upper half).
  __device__ __forceinline__ float get(int j) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(word[j]);
    else return __uint_as_float(j % 2 ? word[j / 2] & 0xffff0000u : word[j / 2] << 16);
  }
  // Element j from a float, rounded to nearest even; j ascending from 0.
  __device__ __forceinline__ void set(int j, float v) {
    if constexpr (sizeof(T) == 4) {
      word[j] = __float_as_uint(v);
    } else {
      const unsigned int b = __bfloat16_as_ushort(__float2bfloat16(v));
      word[j / 2] = j % 2 ? word[j / 2] | (b << 16) : b;
    }
  }
};

// Sum over the lanes of a group of G (a power of two up to 32) aligned lanes.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Threads of a group a row: TPR lanes of a warp (narrow rows), or, with TPR
// = 0, the whole block, of as many threads as the host launches.  VPT
// accesses of W elements a thread; R rows a thread at once (one for a block).
template <typename TX, int W, int TPR, int VPT, int R>
__global__ void __launch_bounds__(TPR == 0 ? kRowThreadsMax : kGroupBlock, TPR == 0 ? 1 : 2)
rmsnorm_rows_kernel(const TX* __restrict__ x, const void* __restrict__ w, int w_bf16, TX* __restrict__ y,
                    long long rows, int d, float eps) {
  static_assert(TPR == 0 ? R == 1 : 32 % TPR == 0, "a row's group is part of a warp, or the whole block");
  constexpr bool kBlockRow = TPR == 0;
  constexpr int kGroups = kBlockRow ? 1 : kGroupBlock / TPR;  // rows a block takes at once, per R
  __shared__ float partial[2][kRowThreadsMax / 32];
  const int tpr = kBlockRow ? blockDim.x : TPR;
  const int lane = threadIdx.x % tpr;
  const int group = threadIdx.x / tpr;
  const int nv = d / W;

  // Loads rows b + group + k * kGroups of x into dst, zeros past the last row.
  auto load_rows = [&](Access<TX, W> (&dst)[R][VPT], long long b) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long row = b + group + (long long)k * kGroups;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = lane + i * tpr;
        if (row < rows && v < nv) dst[k][i].load(x + row * d + (long long)v * W);
        else dst[k][i].zero();
      }
    }
  };
  const long long stride = (long long)gridDim.x * kGroups * R;
  long long base = (long long)blockIdx.x * kGroups * R;
  Access<TX, W> a[R][VPT];
  load_rows(a, base);  // the first rows are in flight while w is read

  float wp1[VPT][W];  // (1 + w) at this thread's columns, the same for every row it takes
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = lane + i * tpr;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      float wv = 0.f;
      if (v < nv) {
        const int c = v * W + j;
        wv = w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[c]) : static_cast<const float*>(w)[c];
      }
      wp1[i][j] = 1.0f + wv;
    }
  }

  int parity = 0;
  for (; base < rows; base += stride) {
    Access<TX, W> next[R][VPT];
    load_rows(next, base + stride);  // in flight while these rows are summed, scaled and stored
    float ss[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float f = a[k][i].get(j);
          s = fmaf(f, f, s);
        }
      }
      ss[k] = group_sum<(kBlockRow ? 32 : TPR)>(s);
    }
    if constexpr (kBlockRow) {  // the warps' sums, in warp order
      if (threadIdx.x % 32 == 0) partial[parity][threadIdx.x / 32] = ss[0];
      __syncthreads();  // the other buffer is free: its readers passed this barrier
      float s = 0.f;
      for (int k = 0; k < tpr / 32; ++k) s += partial[parity][k];
      ss[0] = s;
      parity ^= 1;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long row = base + group + (long long)k * kGroups;
      if (row >= rows) continue;
      const float r = rsqrtf(ss[k] / (float)d + eps);
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = lane + i * tpr;
        if (v >= nv) continue;
        Access<TX, W> o;
#pragma unroll
        for (int j = 0; j < W; ++j) o.set(j, a[k][i].get(j) * r * wp1[i][j]);
        o.store(y + row * d + (long long)v * W);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int i = 0; i < VPT; ++i) a[k][i] = next[k][i];
  }
}

// The generic path, for rows that are misaligned or wider than any instance
// above: one block of kGenericThreads a row, which reads the row a second
// time to scale it.
constexpr int kGenericThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kGenericThreads, 1)
rmsnorm_generic_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ y, int d, float eps) {
  __shared__ float partial[kGenericThreads / 32];
  const long long row = blockIdx.x;
  const TX* xr = x + row * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kGenericThreads) {
    const float v = to_float(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = group_sum<32>(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int k = 0; k < kGenericThreads / 32; ++k) ss += partial[k];
  const float r = rsqrtf(ss / (float)d + eps);
  TX* yr = y + row * d;
  for (int c = threadIdx.x; c < d; c += kGenericThreads)
    yr[c] = from_float<TX>(to_float(xr[c]) * r * (1.0f + to_float(w[c])));
}

struct Args {
  const void* x;
  const void* w;
  int w_bf16;
  void* y;
  long long rows;
  int d;
  float eps;
  cudaStream_t stream;
};

// Blocks of this instance that fit a multiprocessor, at `threads` a block;
// asked once for each block size.
template <typename TX, int W, int TPR, int VPT, int R>
int blocks_per_sm(int threads) {
  static int known[kRowThreadsMax / 32 + 1];
  int& n = known[threads / 32];
  if (n == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rmsnorm_rows_kernel<TX, W, TPR, VPT, R>, threads, 0);
    if (n <= 0) n = 1;
  }
  return n;
}

// The card's multiprocessors, asked once: the port runs on one card a process.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// A grid of as many blocks as the card holds at once, or fewer where the
// rows run out: each block walks the rows a grid's stride apart.
template <typename TX, int W, int TPR, int VPT>
bool launch_rows(const Args& a, int threads) {
  constexpr int R = TPR != 0 && VPT == 1 ? 2 : 1;
  const long long per_block = TPR == 0 ? 1 : (long long)(threads / TPR) * R;
  const long long steps = (a.rows + per_block - 1) / per_block;
  const long long card = (long long)blocks_per_sm<TX, W, TPR, VPT, R>(threads) * sm_count();
  const unsigned blocks = (unsigned)(steps < card ? steps : card);
  rmsnorm_rows_kernel<TX, W, TPR, VPT, R><<<blocks, threads, 0, a.stream>>>(
      static_cast<const TX*>(a.x), a.w, a.w_bf16, static_cast<TX*>(a.y), a.rows, a.d, a.eps);
  return true;
}

// Launches the instance for aligned rows of nv 16-byte accesses; false where
// a row is wider than every instance (d > 16384 in bf16, 8192 in f32).  Rows
// of up to 128 accesses take a group of 16 or 32 lanes; wider rows a block of
// kWideVpt accesses a thread, as many threads as that needs (a multiple of
// 32, at most kRowThreadsMax).
template <typename TX, int W>
bool launch_path(const Args& a) {
  const int nv = a.d / W;
  if (nv <= 16) return launch_rows<TX, W, 16, 1>(a, kGroupBlock);
  if (nv <= 32) return launch_rows<TX, W, 32, 1>(a, kGroupBlock);
  if (nv <= 64) return launch_rows<TX, W, 32, 2>(a, kGroupBlock);
  if (nv <= 128) return launch_rows<TX, W, 32, 4>(a, kGroupBlock);
  if (nv <= kWideVpt * kRowThreadsMax)
    return launch_rows<TX, W, 0, kWideVpt>(a, 32 * ((nv + 32 * kWideVpt - 1) / (32 * kWideVpt)));
  return false;
}

template <typename TX, typename TW>
void launch_generic(const Args& a) {
  rmsnorm_generic_kernel<TX, TW><<<(unsigned)a.rows, kGenericThreads, 0, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TW*>(a.w), static_cast<TX*>(a.y), a.d, a.eps);
}

template <typename TX>
void launch(const Args& a) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool aligned = ((long long)a.d * sizeof(TX)) % 16 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  if (aligned && launch_path<TX, kVec>(a)) return;
  if (a.w_bf16) launch_generic<TX, __nv_bfloat16>(a);
  else launch_generic<TX, float>(a);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  The wrapper has checked shapes,
// types, contiguity and that rows fits the grid.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, long long rows, int d,
                           float eps, int x_dtype, int w_dtype, void* stream) {
  if ((x_dtype != 0 && x_dtype != 1) || (w_dtype != 0 && w_dtype != 1)) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    const Args a{x, w, w_dtype, y, rows, d, eps, static_cast<cudaStream_t>(stream)};
    if (x_dtype == 0) launch<float>(a);
    else launch<__nv_bfloat16>(a);
  }
  return (int)cudaGetLastError();
}

// Flash-attention forward for f32 on Hopper's tensor cores (sm_90a): three
// TF32 products per matrix product, GQA, causal and sliding-window masks.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_fwd (the Pallas
// kernel _flash_kernel), for f32 inputs at every head dim D that is a multiple
// of 16 from 16 to 256, held to 2e-5.  bf16 inputs take
// flash_attention_sm90.cu; kernels/flash_attention.py, route(), chooses from
// the dtype before the launch.
//
// Numerics.  One TF32 product keeps 11 significant bits of each operand,
// about 1e-3 of relative error: far outside 2e-5.  Here every operand x is
// split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x - hi is
// exact in f32), and each product A.B is computed as lo_A.hi_B + hi_A.lo_B +
// hi_A.hi_B with f32 accumulators: the dropped lo_A.lo_B term and the
// rounding of lo leave about 2^-22 of relative error per product, f32's own
// order (tests/test_torch_flash_f32.py holds a model of this arithmetic to
// the JAX kernel at 2e-5, and one product alone must miss it).  The tensor
// cores' f32 sums do not round to nearest, so no chain of them is left long:
// Q K^T sums its two small products apart from hi.hi (D / 8 sums carry S's
// magnitude), and each kv tile's P V is summed from zero and added into O on
// the CUDA cores (on an H100, one accumulator carried over all 64 tiles of
// 4096 keys missed 2e-5 threefold).  The softmax (running max, sum and
// rescale) is f32, in the order of _flash_kernel:73-82.
//
// Bound on the H100: at the serve path's f32 prefill shape (B=4, H=40, Kh=8,
// S=512, D=128, causal) the causal products are 10.76 GFLOP, which three
// times over at the 495 TFLOP/s TF32 tensor-core peak take 0.0652 ms, longer
// than the bytes (q, k, v read once, o written once: 101 MB) at 3.35 TB/s,
// 0.0300 ms.  On the CUDA cores (67 TFLOP/s) the same products would take
// 0.1606 ms; the kernel this one replaced ran there at 0.86 ms.
//
// Design (one warpgroup a block, no warp specialisation):
//  * A block is a tile of kBQ = 64 query rows (wgmma's M) of one (batch,
//    head); blocks are numbered heaviest first (under a causal mask the last
//    q tiles of every head).  Its 128 threads split, multiply and run the
//    softmax in turn; one thread issues the TMA loads.
//  * Shared tiles are f32 in boxes of 32 columns (128 bytes) in the 128-byte
//    swizzle, so a tf32 k8 step is 32 bytes, as a bf16 k16 step is in
//    flash_attention_sm90.cu; a head dim D is held as DP = D rounded up to a
//    multiple of 32 (TMA fills the columns past D with zeros; Q K^T runs D / 8
//    k-steps and never reads them).
//  * Q arrives by TMA once and is split in place: hi over the raw tile, lo
//    beside it.  Each kv tile's K arrives by TMA and is split in place the
//    same way.  TF32 wgmma takes only K-major operands, and V as stored is
//    MN-major for P V, so V arrives in a raw buffer and the split pass writes
//    V^T's hi and lo, kv-contiguous.  The next tile's V is loaded as soon as
//    the split has read this one's, the next K as soon as Q K^T has read this
//    one's, so each load overlaps the products and the softmax.
//  * Q K^T is wgmma m64n{kBKV}k8, both operands in shared memory.
//  * P V is wgmma with P as the A operand from registers.  The f32
//    accumulator fragment of S holds columns 2t and 2t+1 of each k8 step in
//    thread t of a quad, while the tf32 A fragment wants columns t and t+4:
//    instead of moving P between threads, the split pass permutes V^T's kv
//    order within each group of 8 (logical k < 4 is kv row 2k, k >= 4 is row
//    2(k - 4) + 1), so P is split into hi and lo where it lies.  The product
//    runs over DP columns in pieces of 64 (and 32), each summed from zero
//    and then added into O as O * corr + P V.
//  * Shared memory sets the kv tile (Layout): Q's hi and lo (64 x DP each),
//    K's hi and lo, the raw V and V^T's hi and lo (kBKV x DP each):
//      DP <= 128: kBKV = 64 (224 KB at DP = 128);
//      DP <= 192: kBKV = 32 (216 KB at DP = 192);
//      DP  > 192: kBKV = 16 (208 KB at DP = 256), V^T's rows of 16 kv (64
//                 bytes) in the 64-byte swizzle.
//  * Masks come from global positions, query i at q_offset + i and key j at
//    j.  kv tiles outside the causal or window band are skipped; the element
//    mask is applied only on tiles that cross the band's edge or the end of
//    Skv.  Masked scores are -inf, so p = 0 exactly, and a row with no visible
//    key keeps l = 0 and is written as zeros, as repro/kernels/ref.py defines.
//    A block none of whose rows sees a key loads nothing.
//  * O is written from the accumulator fragment straight to device memory
//    (rows past Sq and columns past D are not written).
//  * Optionally the row's log-sum-exp of the scaled scores, lse = m * scale +
//    log(l) in natural-log units, f32 (B, H, Sq), as _flash_fwd saves it for
//    the backward (repro/models/attention.py); +inf for a row with no visible
//    key, so that the backward's p = exp(s - lse) is 0 there.  The quad's
//    first thread writes it, once; a null pointer skips it.
//
// C interface (loaded with ctypes): flash_attention_fwd returns 0 or the
// cudaError of the launch, -1 if the driver's cuTensorMapEncodeTiled cannot be
// had, and -(1000 + CUresult) if it refuses a tensor map.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block: one warpgroup, wgmma's M
constexpr int kThreads = 128;
constexpr int kBoxCols = 32;    // f32 columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;

// Shared memory for head dim D, held as kPad columns, from a base aligned to
// 1024 bytes (the swizzle's period); what fits the 227 KB (see the header).
template <int D>
struct Layout {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dims 16, 32, ..., 256");
  static constexpr int kPad = (D + kBoxCols - 1) / kBoxCols * kBoxCols;
  static constexpr int kBKV = kPad <= 128 ? 64 : kPad <= 192 ? 32 : 16;  // kv rows per tile
  static constexpr int kBoxes = kPad / kBoxCols;
  static constexpr int kQBytes = kBQ * kPad * 4;      // one of Q's parts
  static constexpr int kTileBytes = kBKV * kPad * 4;  // one part of K, the raw V, one part of V^T
  // V^T: kPad rows of kBKV kv; a row of a box is 128 bytes (32 kv), or 64
  // (the whole 16-kv row, 64-byte swizzle) at kBKV = 16.
  static constexpr int kVtRowBytes = kBKV >= 32 ? kRowBytes : kBKV * 4;
  static constexpr int kQhi = 0, kQlo = kQhi + kQBytes;
  static constexpr int kKhi = kQlo + kQBytes, kKlo = kKhi + kTileBytes;
  static constexpr int kV = kKlo + kTileBytes, kVThi = kV + kTileBytes, kVTlo = kVThi + kTileBytes;
  static constexpr int kBar = kVTlo + kTileBytes;  // Q's, K's and V's "full" barriers
  static constexpr int kBytes = kBar + 3 * 8;
  static constexpr int kLaunchBytes = kBytes + 1024;  // room to align the base
  static_assert(kLaunchBytes <= 232448, "more shared memory than a block may use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (c0 = column, c1 = row, c2 = batch*head) into
// shared memory; the bytes are counted on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Every box of one tile (kBoxes boxes of 32 columns x `rows` rows) into `dst`.
template <int kBoxes>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int rows,
                                         int row0, int head) {
#pragma unroll
  for (int box = 0; box < kBoxes; ++box)
    tma_load_3d(dst + box * rows * kRowBytes, map, bar, box * kBoxCols, row0, head);
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (in 16-byte units), layout type 1 (128-byte swizzle) or 2 (64-byte).
template <int kSwizzleBytes>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo) {
  constexpr uint64_t layout = kSwizzleBytes == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from touching accumulator registers across an async wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// x = hi + lo + O(2^-22 |x|): both TF32 (the low 13 bits zero), rounded to
// nearest, ties away.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(float4 x, uint4& hi, uint4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

// d (64 x 16, f32) += A (64 x 8, tf32, shared) * B (16 x 8, tf32, shared)^T, both K-major.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32, f32) += A (64 x 8, tf32, shared) * B (32 x 8, tf32, shared)^T, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 8, tf32, shared) * B (64 x 8, tf32, shared)^T, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32, f32) = (scale_d ? d : 0) + A (64 x 8, tf32 in registers) * B (32 x 8, tf32, shared,
// K-major)^T.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A (64 x 8, tf32 in registers) * B (64 x 8, tf32, shared,
// K-major)^T.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// S (64 x N) += A (64 x 8, shared) * B (N x 8, shared)^T: one k8 step of Q K^T.
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&s)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 16) wgmma_ss_n16(s, a, b, scale_d);
  if constexpr (N == 32) wgmma_ss_n32(s, a, b, scale_d);
  if constexpr (N == 64) wgmma_ss_n64(s, a, b, scale_d);
}

// O's columns [N0, N0 + N) (N = 32 or 64) = O * corr + this tile's P V.  The
// tile's product is summed on the tensor cores in `t`, from zero: each k8
// step of P V as P_lo V_hi + P_hi V_lo + P_hi V_hi; a k8 step is 32 bytes on
// within a row of V^T, 8 steps (4 at kBKV = 16) to a box.  Then it is added
// into O on the CUDA cores, in f32 rounded to nearest: the tensor cores'
// f32 sums do not round to nearest, and carried over a long sequence their
// error grows with the number of kv tiles (6.8e-5 at 4096 keys on an H100),
// where one tile's chain stays far under 2e-5.
template <int D, int N0, int N>
__device__ __forceinline__ void pv_piece(float (&acc)[Layout<D>::kPad / 2],
                                         const uint32_t (&ph)[Layout<D>::kBKV / 8][4],
                                         const uint32_t (&pl)[Layout<D>::kBKV / 8][4],
                                         const float (&corr)[2], uint32_t vt_hi, uint32_t vt_lo) {
  using L = Layout<D>;
  constexpr int DP = L::kPad, kBKV = L::kBKV, kRB = L::kVtRowBytes;
  constexpr uint32_t kSbo = 8 * kRB;  // one 8-row group of the swizzle atom
  float t[N / 2];
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kBKV / 8; ++k) {
    const uint32_t vo = (32 * k / kRB) * DP * kRB + (32 * k) % kRB + N0 * kRB;
    const uint64_t hi = desc<kRB>(vt_hi + vo, kSbo), lo = desc<kRB>(vt_lo + vo, kSbo);
    if constexpr (N == 64) {
      wgmma_rs_n64(t, pl[k], hi, k > 0);
      wgmma_rs_n64(t, ph[k], lo, 1);
      wgmma_rs_n64(t, ph[k], hi, 1);
    } else {
      wgmma_rs_n32(t, pl[k], hi, k > 0);
      wgmma_rs_n32(t, ph[k], lo, 1);
      wgmma_rs_n32(t, ph[k], hi, 1);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(t);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)  // element i's row is (i / 2) % 2, as in the whole tile's fragment
    acc[N0 / 2 + i] = fmaf(acc[N0 / 2 + i], corr[(i >> 1) & 1], t[i]);
}

// O = O * corr + P V over all DP columns, in pieces of 64 and then 32.
template <int D, int N0 = 0>
__device__ __forceinline__ void pv(float (&acc)[Layout<D>::kPad / 2],
                                   const uint32_t (&ph)[Layout<D>::kBKV / 8][4],
                                   const uint32_t (&pl)[Layout<D>::kBKV / 8][4], const float (&corr)[2],
                                   uint32_t vt_hi, uint32_t vt_lo) {
  constexpr int DP = Layout<D>::kPad;
  if constexpr (DP - N0 >= 64) {
    pv_piece<D, N0, 64>(acc, ph, pl, corr, vt_hi, vt_lo);
    pv<D, N0 + 64>(acc, ph, pl, corr, vt_hi, vt_lo);
  } else if constexpr (DP - N0 >= 32) {
    pv_piece<D, N0, 32>(acc, ph, pl, corr, vt_hi, vt_lo);
  }
}

// Every float of [buf, buf + 16 n) becomes its TF32 high part; the low part
// goes to the same offset from `lo`.  Each thread reads and writes only its
// own 16-byte words, so the swizzled layout is kept and nothing races.
__device__ __forceinline__ void split_in_place(unsigned char* buf, unsigned char* lo, int n) {
  float4* b4 = reinterpret_cast<float4*>(buf);
  uint4* l4 = reinterpret_cast<uint4*>(lo);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    uint4 h, l;
    split4(b4[i], h, l);
    reinterpret_cast<uint4*>(b4)[i] = h;
    l4[i] = l;
  }
}

// Byte offset of V^T's logical kv k (a multiple of 4) in row d: boxes of kRB
// bytes a row (32 kv in the 128-byte swizzle, or 16 in the 64-byte one),
// DP rows a box.
template <int DP, int kRB>
__device__ __forceinline__ int vt_offset(int d, int k) {
  const int swz = kRB == 128 ? (d & 7) : ((d >> 1) & 3);
  return (4 * k / kRB) * DP * kRB + d * kRB + ((((4 * k) % kRB / 16) ^ swz) << 4);
}

// The raw V tile (kBKV rows of DP columns, 32-column boxes in the 128-byte
// swizzle) into V^T's hi and lo (DP rows of kBKV kv), each group of 8 kv in
// the order 0 2 4 6 1 3 5 7 (see the header).  A unit is one column d and one
// group of 8 kv rows; a warp takes 32 consecutive d of one group, so each of
// its loads reads one 128-byte row and its 16-byte stores, 8 rows a phase,
// fall on 8 distinct bank groups.
template <int D>
__device__ __forceinline__ void split_v(const unsigned char* v, unsigned char* vt_hi,
                                        unsigned char* vt_lo) {
  using L = Layout<D>;
  constexpr int DP = L::kPad, kBKV = L::kBKV, kRB = L::kVtRowBytes;
  for (int u = threadIdx.x; u < DP * (kBKV / 8); u += kThreads) {
    const int d = u % DP, t = u / DP;
    const unsigned char* col = v + (d / kBoxCols) * kBKV * kRowBytes + (d & 3) * 4;
    const int chunk = (d % kBoxCols) >> 2;
    float x[8];
#pragma unroll
    for (int p = 0; p < 8; ++p)  // kv row 8t + p, whose swizzle is p
      x[p] = *reinterpret_cast<const float*>(col + (8 * t + p) * kRowBytes + ((chunk ^ p) << 4));
    uint4 h, l;
    split4(make_float4(x[0], x[2], x[4], x[6]), h, l);  // logical kv 8t .. 8t+3
    int off = vt_offset<DP, kRB>(d, 8 * t);
    *reinterpret_cast<uint4*>(vt_hi + off) = h;
    *reinterpret_cast<uint4*>(vt_lo + off) = l;
    split4(make_float4(x[1], x[3], x[5], x[7]), h, l);  // logical kv 8t+4 .. 8t+7
    off = vt_offset<DP, kRB>(d, 8 * t + 4);
    *reinterpret_cast<uint4*>(vt_hi + off) = h;
    *reinterpret_cast<uint4*>(vt_lo + off) = l;
  }
}

// A block's tile: kBQ query rows of one (batch, head), and the kv tiles its
// rows can see.  Blocks are numbered heaviest first: under a causal mask the
// last q tiles, of every head, come first.
struct Item {
  int bh, q0, kvh, n_tiles;
  long long q_first, q_last, kv_begin;
};

template <int kBKV>
__device__ __forceinline__ Item item_of(int w, int BH, int nq, int H, int Kh, int Sq, int Skv,
                                        int causal, int window, long long q_offset) {
  Item it;
  it.bh = w % BH;
  it.q0 = (nq - 1 - w / BH) * kBQ;
  const int b = it.bh / H, h = it.bh % H;
  it.kvh = b * Kh + h / (H / Kh);
  it.q_first = q_offset + it.q0;
  it.q_last = q_offset + min(it.q0 + kBQ, Sq) - 1;
  long long kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min((long long)Skv, it.q_last + 1);
  if (window > 0) kv_begin = max(0LL, it.q_first - window + 1);
  it.kv_begin = (kv_begin / kBKV) * kBKV;
  it.n_tiles = kv_end > it.kv_begin ? (int)((kv_end - it.kv_begin + kBKV - 1) / kBKV) : 0;
  return it;
}

// Thread tid owns rows r0 = warp*16 + lane/4 and r0 + 8 of the tile.
// Accumulator fragment of a 64 x N wgmma tile: element i of a thread lies in
// row r0 + 8*((i/2) % 2) and column 8*(i/4) + 2*(lane%4) + i%2.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
                     float* __restrict__ lse, int BH, int nq, int H, int Kh, int Sq, int Skv,
                     int causal, int window, long long q_offset, float scale, float scale_log2) {
  using L = Layout<D>;
  constexpr int DP = L::kPad, kBKV = L::kBKV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t sb = smem_u32(base);
  const uint32_t bar_q = sb + L::kBar, bar_k = bar_q + 8, bar_v = bar_q + 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Item item = item_of<kBKV>(blockIdx.x, BH, nq, H, Kh, Sq, Skv, causal, window, q_offset);
  const int q0 = item.q0, n_tiles = item.n_tiles;
  const long long q_first = item.q_first, q_last = item.q_last, kv_begin = item.kv_begin;
  float* op = o + (size_t)item.bh * Sq * D;

  if (n_tiles == 0) {  // no row of the tile sees a key: zeros, and an lse of +inf
    for (int i = tid; i < kBQ * D; i += kThreads)
      if (q0 + i / D < Sq) op[(size_t)(q0 + i / D) * D + i % D] = 0.f;
    if (lse != nullptr && q0 + tid < Sq && tid < kBQ) lse[(size_t)item.bh * Sq + q0 + tid] = INFINITY;
    return;
  }
  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
    tma_tile<L::kBoxes>(sb + L::kQhi, &q_map, bar_q, kBQ, q0, item.bh);
    mbar_expect_tx(bar_k, L::kTileBytes);
    tma_tile<L::kBoxes>(sb + L::kKhi, &k_map, bar_k, kBKV, (int)kv_begin, item.kvh);
    mbar_expect_tx(bar_v, L::kTileBytes);
    tma_tile<L::kBoxes>(sb + L::kV, &v_map, bar_v, kBKV, (int)kv_begin, item.kvh);
  }

  const int r0 = warp * 16 + (lane >> 2);
  const long long qpos[2] = {q_offset + q0 + r0, q_offset + q0 + r0 + 8};
  const int col0 = 2 * (lane & 3);
  float acc[DP / 2];  // O's DP columns; those past D stay P x 0
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in raw score units

  mbar_wait(bar_q, 0);
  split_in_place(base + L::kQhi, base + L::kQlo, L::kQBytes / 16);

  for (int it = 0; it < n_tiles; ++it) {
    const long long j0 = kv_begin + (long long)it * kBKV;
    const uint32_t parity = it & 1;
    __syncthreads();  // the last tile's P V has read V^T
    mbar_wait(bar_v, parity);
    split_v<D>(base + L::kV, base + L::kVThi, base + L::kVTlo);
    mbar_wait(bar_k, parity);
    split_in_place(base + L::kKhi, base + L::kKlo, L::kTileBytes / 16);
    // wgmma (the async proxy) must see the split's stores, all 128 threads'.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && it + 1 < n_tiles) {  // the raw V is read: the next tile's may land
      mbar_expect_tx(bar_v, L::kTileBytes);
      tma_tile<L::kBoxes>(sb + L::kV, &v_map, bar_v, kBKV, (int)(j0 + kBKV), item.kvh);
    }

    // S = Q K^T: D / 8 steps of k8 (the zero-filled columns past D are not
    // read), each as Q_hi K_lo + Q_lo K_hi, summed in `small`, and Q_hi K_hi,
    // summed in `s`, so that the chain of tensor-core sums that carries S's
    // full magnitude is D / 8 long, not 3 D / 8; the two meet in f32 after.
    // Within a 128-byte swizzled row a k8 step is 32 bytes further on; the
    // next 32 columns are the next box.
    float s[kBKV / 2], small[kBKV / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qo = (kk / 4) * kBQ * kRowBytes + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * kBKV * kRowBytes + (kk % 4) * 32;
      const uint64_t qhi = desc<128>(sb + L::kQhi + qo, 1024), qlo = desc<128>(sb + L::kQlo + qo, 1024);
      const uint64_t khi = desc<128>(sb + L::kKhi + ko, 1024), klo = desc<128>(sb + L::kKlo + ko, 1024);
      wgmma_qk<kBKV>(small, qhi, klo, kk > 0);
      wgmma_qk<kBKV>(small, qlo, khi, 1);
      wgmma_qk<kBKV>(s, qhi, khi, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(small);
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) s[i] += small[i];
    __syncthreads();  // every warp's Q K^T has read K
    if (tid == 0 && it + 1 < n_tiles) {
      mbar_expect_tx(bar_k, L::kTileBytes);
      tma_tile<L::kBoxes>(sb + L::kKhi, &k_map, bar_k, kBKV, (int)(j0 + kBKV), item.kvh);
    }

    // Masked scores become -inf, only on tiles that cross an edge of the
    // band: column c of the tile is visible to row r iff lo[r] <= c < hi[r].
    const bool edge = j0 + kBKV > Skv || (causal && j0 + kBKV - 1 > q_first) ||
                      (window > 0 && q_last - j0 >= window);
    float mx[2] = {m[0], m[1]};
    if (edge) {
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        long long h64 = Skv - j0, l64 = 0;
        if (causal) h64 = min(h64, qpos[r] - j0 + 1);
        if (window > 0) l64 = qpos[r] - j0 - window + 1;
        hi[r] = (int)max(-1LL, min(h64, (long long)kBKV));
        lo[r] = (int)max(0LL, min(l64, (long long)kBKV));
      }
#pragma unroll
      for (int i = 0; i < kBKV / 2; ++i) {
        const int r = (i >> 1) & 1, c = 8 * (i >> 2) + col0 + (i & 1);
        if (c < lo[r] || c >= hi[r]) s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float mus[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mu = mx[r] == -INFINITY ? 0.f : mx[r];  // nothing visible yet: p = 0, no NaN
      corr[r] = exp2f((m[r] - mu) * scale_log2);          // 0 while m[r] is -inf
      mus[r] = mu * scale_log2;
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2f(fmaf(s[i], scale_log2, -mus[r]));
      rs[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];  // this thread's columns

    // P as tf32 A fragments, hi and lo: k8 step t covers S columns 8t..8t+7,
    // the thread's elements 4t..4t+3; the A fragment's registers are (row r0,
    // k), (r0 + 8, k), (r0, k + 4), (r0 + 8, k + 4) for k = lane % 4, which
    // with V^T's kv order are elements 4t, 4t+2, 4t+1 and 4t+3.
    uint32_t ph[kBKV / 8][4], pl[kBKV / 8][4];
#pragma unroll
    for (int t = 0; t < kBKV / 8; ++t) {
      split(s[4 * t + 0], ph[t][0], pl[t][0]);
      split(s[4 * t + 2], ph[t][1], pl[t][1]);
      split(s[4 * t + 1], ph[t][2], pl[t][2]);
      split(s[4 * t + 3], ph[t][3], pl[t][3]);
    }
    // O = O * corr + P V (pv_piece).
    pv<D>(acc, ph, pl, corr, sb + L::kVThi, sb + L::kVTlo);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no visible key: zeros
    const int row = q0 + r0 + 8 * r;
    if (row >= Sq) continue;
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)item.bh * Sq + row] = l[r] > 0.f ? fmaf(m[r], scale, logf(l[r])) : INFINITY;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col0;
      if (c < D)
        *reinterpret_cast<float2*>(op + (size_t)row * D + c) =
            make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is in the driver (libcuda), which this library does
// not link: the runtime hands out its entry point.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (heads, S, D) f32 tensor, read in boxes of 32 columns x `rows` rows of one
// head, 128-byte swizzle; a box's columns past D and rows past S load as zeros.
int make_map(CUtensorMap* map, const void* ptr, int heads, int S, int D, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)S * D * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxCols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(1000 + (int)r);
}

// Every element of p[0, n) set to v: the lse of rows that have no key at all.
__global__ void fill_kernel(float* __restrict__ p, long long n, float v) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    p[i] = v;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Kh,
           int Sq, int Skv, int causal, int window, long long q_offset, float scale,
           cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, B * H, Sq, D, kBQ);
  if (err == 0) err = make_map(&km, k, B * Kh, Skv, D, Layout<D>::kBKV);
  if (err == 0) err = make_map(&vm, v, B * Kh, Skv, D, Layout<D>::kBKV);
  if (err != 0) return err;
  constexpr int smem = Layout<D>::kLaunchBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nq = (Sq + kBQ - 1) / kBQ;
  flash_fwd_f32_kernel<D><<<(unsigned)((long long)B * H * nq), kThreads, smem, stream>>>(
      qm, km, vm, static_cast<float*>(o), lse, B * H, nq, H, Kh, Sq, Skv, causal, window, q_offset,
      scale, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Kh, Skv, D), o (B, H, Sq, D): contiguous f32,
// base addresses 16-byte aligned (TMA), D a multiple of 16 up to 256; lse null
// or f32 (B, H, Sq).  The wrapper has checked shapes, types, alignment,
// H % Kh == 0 and grid limits.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                   int B, int H, int Kh, int Sq, int Skv, int D, int causal,
                                   int window, long long q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  if (Skv == 0) {  // no key for any row: zeros (a tensor map cannot have an empty dim)
    cudaError_t e = cudaMemsetAsync(o, 0, (size_t)B * H * Sq * D * 4, s);
    if (e == cudaSuccess && l != nullptr) {
      fill_kernel<<<256, 256, 0, s>>>(l, (long long)B * H * Sq, INFINITY);
      e = cudaGetLastError();
    }
    return (int)e;
  }
  switch (D) {
#define FLASH_F32_CASE(d) \
  case d:                 \
    return launch<d>(q, k, v, o, l, B, H, Kh, Sq, Skv, causal, window, q_offset, scale, s);
    FLASH_F32_CASE(16) FLASH_F32_CASE(32) FLASH_F32_CASE(48) FLASH_F32_CASE(64)
    FLASH_F32_CASE(80) FLASH_F32_CASE(96) FLASH_F32_CASE(112) FLASH_F32_CASE(128)
    FLASH_F32_CASE(144) FLASH_F32_CASE(160) FLASH_F32_CASE(176) FLASH_F32_CASE(192)
    FLASH_F32_CASE(208) FLASH_F32_CASE(224) FLASH_F32_CASE(240) FLASH_F32_CASE(256)
#undef FLASH_F32_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Flash-attention forward on Hopper's tensor cores (sm_90a): bf16 q, k, v with
// a head dim D that is a multiple of 16 from 16 to 256.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_fwd (the Pallas
// kernel _flash_kernel), for bf16 inputs with D in {16, 32, ..., 256}.  f32
// inputs, which must meet 2e-5, take flash_attention.cu, where each product
// is three TF32 products.  The wrapper (kernels/flash_attention.py, route())
// chooses from the dtype before the launch.
//
// Bound on the H100: at the serve path's prefill shapes (qwen3: B=4, H=40,
// Kh=8, S=512, D=128; stablelm: B=4, H=Kh=32, S=512, D=80; causal, bf16) the
// bytes (q, k, v read once, o written once: about 50 and 42 MB) take longer
// at 3.35 TB/s than the causal products (about 10.8 and 5.4 GFLOP) at the
// 989 TFLOP/s bf16 tensor-core peak.  The previous kernel did its products on
// the CUDA cores and was 66x (D = 128) and 44.5x (D = 80) that bound; the
// products go to the tensor cores here, through wgmma, fed by TMA.
//
// Head dims (design (a): pad in shared memory only).  Every tile is built of
// 64-column boxes in the 128-byte swizzle, so a head dim D is held in shared
// memory as DP = D rounded up to a multiple of 64 (64, 128, 192 or 256).  The
// tensor maps have the global dim D and a 64-column box,
// so TMA reads only D columns from device memory and fills the columns past D
// with zeros (the mbarrier still counts the whole box); the store of O drops
// them.  S = Q K^T runs D / 16 k-steps, never DP / 16, and O += P V runs at
// N = DP, whose columns past D are P times zeros and are never stored: at
// D = 80 that is 128 columns of PV work for 80.  D stays a template argument,
// one instance per head dim.  The other design, a 64-column box beside a
// narrower one with a 32- or 64-byte swizzle and exact-width products, was not
// built: the route is bound by bytes at the serve shapes, and the padding
// costs no device-memory traffic, only tensor-core time and shared memory.
//
// Design (no clusters; no ping-pong scheduling between the warpgroups and no
// overlap of one tile's softmax with the next tile's products: both were
// tried and were slower here):
//  * A work item is a tile of kBQ = 128 query rows of one (batch, head).
//    Items are numbered heaviest first (under a causal mask the last q tiles
//    of every head), and the kernel is persistent: one block per SM walks
//    items blockIdx.x, blockIdx.x + gridDim.x, ...  A block has two consumer
//    warpgroups, each owning 64 query rows (wgmma's M), and a producer
//    warpgroup, which gives its registers to them (setmaxnreg: 240 and 24).
//  * The producer's one thread loads by TMA each item's Q into one of two Q
//    buffers, so the next item's Q lands while this one's O is stored from
//    the other, and K and V tiles of kBKV rows through a ring of stages,
//    across items.  What fits the 227 KB depends on DP (Layout):
//      DP =  64: kBKV = 128, 2 Q buffers of 16 KB, 3 stages of 2 x 16 KB;
//      DP = 128: kBKV = 128, 2 Q buffers of 32 KB, 2 stages of 2 x 32 KB;
//      DP = 192: kBKV =  64, 2 Q buffers of 48 KB, 2 stages of 2 x 24 KB;
//      DP = 256: kBKV =  64, 1 Q buffer  of 64 KB, 2 stages of 2 x 32 KB.
//    With one Q buffer the next item's Q waits until both warpgroups' O
//    stores have read it (the same "empty" barrier orders the two).  Past
//    DP = 128 the kv tile is halved rather than the stages: a consumer holds
//    O's DP / 2 f32 columns a thread (128 at DP = 256) beside kBKV / 2 scores
//    and kBKV / 8 words of P, which at kBKV = 128 would not fit the 240
//    registers without spilling.  Each buffer and stage has a "full" mbarrier
//    (the TMA's bytes have landed) and an "empty" one (the consumers are done
//    with it), so nothing waits on a block-wide barrier.  The tensor maps are
//    3-D, (batch*heads, S, D), so rows past S come back as zeros and never as
//    the next head's rows.
//  * Shared tiles use the 128-byte swizzle, whose rows are 64 bf16: a DP = 128
//    tile is two 64-column boxes, and the wgmma descriptors say so.
//  * S = Q K^T is wgmma m64n{kBKV}k16, bf16 in, f32 out, both operands
//    K-major in shared memory.
//  * Online softmax in f32 on the accumulator fragment.  A thread holds two
//    rows, kBKV / 4 columns each; row max and row sum combine the quad's four
//    threads with __shfl_xor_sync 1 and 2; exp2f with scale * log2(e) folded
//    into the scores; running max, sum and rescale as _flash_kernel:73-82.
//  * O += P V is wgmma with P as the A operand from registers: the f32
//    fragment of S has the layout of the bf16 A fragment, so P is rounded to
//    bf16 where it lies, as the JAX model's flash_ref rounds P before PV (the
//    row sum keeps the f32 P, as flash_ref's does).  V is an MN-major B
//    operand (the transpose bit).  The product runs at N = DP up to 128, and
//    past it as N = 128 on O's first two boxes and N = DP - 128 on the rest
//    (the fragment of a 64 x N tile is the first N / 2 registers of a wider
//    one's, so O's registers split at 64: wgmma_rs_m64n128<64>).
//  * Masks come from global positions, query i at q_offset + i and key j at
//    j.  kv tiles outside the causal or window band are skipped; the element
//    mask is applied only on tiles that cross the band's edge or the end of
//    Skv.  Masked scores are -inf, so p = 0 exactly, and a row with no visible
//    key keeps l = 0 and is written as zeros, as repro/kernels/ref.py defines.
//  * O is staged, in the swizzled layout, in the warpgroup's own rows of the
//    item's Q buffer and written by a TMA store per box (rows past Sq and
//    columns past D are dropped by the store).
//  * Optionally the row's log-sum-exp, f32 (B, H, Sq), for the backward
//    (_flash_fwd in repro/models/attention.py saves m + log(l)): in natural
//    log units of the scaled scores, m * scale + log(l), with m in raw units
//    as kept here; +inf for a row with no visible key, so that the
//    backward's p = exp(s - lse) is 0 there.  The quad's first thread writes
//    it, once per row, where 1 / l is formed; a null pointer skips it (the
//    serve path's prefill).
//
// C interface (loaded with ctypes): flash_attention_fwd_sm90 returns 0 or the
// cudaError of the launch, -1 if the driver's cuTensorMapEncodeTiled cannot be
// had, and -(1000 + CUresult) if it refuses a tensor map.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;       // query rows per work item
constexpr int kConsumers = 256;  // two warpgroups of 64 query rows each
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// Registers per thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 65536.
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kBoxCols = 64;   // bf16 columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory for head dim D, held as kPad columns (D rounded up to whole
// 64-column boxes), from a base aligned to 1024 bytes (the swizzle's period):
// kQBufs Q tiles (with two, the next work item's Q loads while this one's O
// is stored from the other), then the K/V ring of kStages stages of kBKV
// rows; what fits the 227 KB (see the header).
template <int D>
struct Layout {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dims 16, 32, ..., 256");
  static constexpr int kPad = (D + kBoxCols - 1) / kBoxCols * kBoxCols;
  static constexpr int kBKV = kPad <= 128 ? 128 : 64;  // kv rows per tile
  static constexpr int kQBufs = kPad <= 192 ? 2 : 1;
  static constexpr int kStages = kPad == 64 ? 3 : 2;
  static constexpr int kBoxes = kPad / kBoxCols;
  static constexpr int kQBytes = kBQ * kPad * 2;
  static constexpr int kTileBytes = kBKV * kPad * 2;  // one K or one V tile
  static constexpr int kQ = 0;                     // kQBufs Q tiles
  static constexpr int kK = kQ + kQBufs * kQBytes;  // kStages K tiles
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;  // 2 per Q buffer, 2 per stage
  static constexpr int kBytes = kBar + 8 * (2 * kQBufs + 2 * kStages);
  static constexpr int kLaunchBytes = kBytes + 1024;  // room to align the base
  static_assert(kLaunchBytes <= 232448, "more shared memory than a block may use");
};

// A work item: one tile of kBQ query rows of one (batch, head), and the kv
// tiles its rows can see.  Items are numbered heaviest first: under a causal
// mask the last q tiles, of every head, come first.
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// One box of shared memory into a 3-D tensor map; rows past the map's end
// are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, f32) += A (64 x 16, shared) * B (16 x 128, shared), both K-major.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, shared) * B (16 x 64, shared), both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[O, O + 64) (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, shared,
// MN-major): the fragment of a 64 x 128 tile is a wider one's from register O
// on (O = 64 for its columns 128 on).
template <int O = 0, int N>
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[N], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 64 <= N, "registers 64 from O");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]), "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]), "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]), "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]), "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]), "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
        "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]), "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[O, O + 32) (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, shared, MN-major).
template <int O = 0, int N>
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[N], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 32 <= N, "registers 32 from O");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]), "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]), "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S (64 x N) = A (64 x 16, shared) * B (16 x N, shared), summed over k-steps.
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&s)[N / 2], uint64_t a, uint64_t b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&s)[32], uint64_t a, uint64_t b, int scale_d) {
  wgmma_ss_m64n64(s, a, b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&s)[64], uint64_t a, uint64_t b, int scale_d) {
  wgmma_ss_m64n128(s, a, b, scale_d);
}

// O (64 x DP) += P (64 x 16, bf16 in registers) * V (16 x DP), V's k-step at
// `bv` in shared memory, MN-major, `lbo` bytes from one 64-column box to the
// next.  Past N = 128 as two products: boxes 0-1, then the rest.
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4], uint32_t bv,
                                         uint32_t lbo) {
  static_assert(DP == 64 || DP == 128 || DP == 192 || DP == 256, "whole 64-column boxes");
  const uint64_t b = sw128_desc(bv, lbo, 1024);
  if constexpr (DP == 64) {
    wgmma_rs_m64n64(o, a, b);
  } else {
    wgmma_rs_m64n128(o, a, b);
    const uint64_t b2 = sw128_desc(bv + 2 * lbo, lbo, 1024);  // box 2 on
    if constexpr (DP == 192) wgmma_rs_m64n64<64>(o, a, b2);
    if constexpr (DP == 256) wgmma_rs_m64n128<64>(o, a, b2);
  }
}

// One work item on the two consumer warpgroups: thread tid of 256 owns two
// rows of the 128.  `tile` counts the kv tiles this block has consumed, over
// all its items: it names the ring's stage and phase.
//
// Accumulator fragment of a 64 x N wgmma tile (per warp 16 rows): element i
// of a thread lies in row warp*16 + lane/4 + 8*((i/2) % 2) and column
// 8*(i/4) + 2*(lane%4) + i%2.
template <int D>
__device__ __forceinline__ void attend(const Item& item, const CUtensorMap* o_map, float* lse,
                                       uint32_t sQ, uint32_t sK, uint32_t sV, uint32_t bar_full,
                                       uint32_t bar_empty, int& tile, int Sq, int Skv,
                                       int causal, int window, long long q_offset,
                                       float scale_log2) {
  using L = Layout<D>;
  constexpr int kStages = L::kStages, DP = L::kPad, kBKV = L::kBKV;
  const int tid = threadIdx.x;
  const int q0 = item.q0;
  const long long q_first = item.q_first, q_last = item.q_last, kv_begin = item.kv_begin;
  const int n_tiles = item.n_tiles;
  // This thread's warpgroup, and its two rows as positions in the sequence.
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  const long long qpos[2] = {q_offset + q0 + r0, q_offset + q0 + r0 + 8};
  const int col0 = 2 * (lane & 3);

  float acc[DP / 2];  // O's DP columns; those past D stay P x 0
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in raw score units

  for (int it = 0; it < n_tiles; ++it, ++tile) {
    const int stage = tile % kStages;
    const long long j0 = kv_begin + (long long)it * kBKV;
    mbar_wait(bar_full + 8 * stage, (tile / kStages) & 1);

    // S = Q K^T for this warpgroup's 64 rows: D / 16 steps of k16 (the
    // zero-filled columns past D are not read).  Within a 128-byte swizzled
    // row a k16 step is 32 bytes further on; the next 64 columns are the
    // next box.
    float s[kBKV / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t k_off = (kk % 4) * 32;
      const uint32_t a = sQ + (kk / 4) * kBQ * kRowBytes + wg * 64 * kRowBytes + k_off;
      const uint32_t bk = sK + stage * L::kTileBytes + (kk / 4) * kBKV * kRowBytes + k_off;
      wgmma_qk<kBKV>(s, sw128_desc(a, 16, 1024), sw128_desc(bk, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

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
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // P as bf16 A fragments: k16 step t covers S columns 16t..16t+15, which
    // are the thread's elements 8t..8t+7.
    uint32_t pa[kBKV / 16][4];
#pragma unroll
    for (int t = 0; t < kBKV / 16; ++t) {
      pa[t][0] = pack_bf16(s[8 * t + 0], s[8 * t + 1]);
      pa[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
      pa[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
      pa[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
    }
    // O += P V at N = DP: V is MN-major; a k16 step is 16 kv rows (2048
    // bytes) on, the next 64 columns the next box (the leading byte offset).
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kBKV / 16; ++t) {
      const uint32_t bv = sV + stage * L::kTileBytes + t * 16 * kRowBytes;
      wgmma_pv<DP>(acc, pa[t], bv, kBKV * kRowBytes);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * stage);  // this thread is done with the stage
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no visible key: zeros
    const int row = q0 + r0 + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && row < Sq)
      lse[(size_t)item.bh * Sq + row] = l[r] > 0.f ? fmaf(m[r], scale_log2, log2f(l[r])) * kLn2 : INFINITY;
  }
  // Stage this warpgroup's 64 rows of O (its first D columns) in its own rows
  // of the Q tile (its products are done), in the 128-byte swizzle, then a
  // TMA store per box (rows past Sq and columns past D are not written).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wg * 64 + warp * 16 + (lane >> 2) + 8 * r;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * r;
      const uint32_t addr = sQ + (c / 8) * kBQ * kRowBytes + row * kRowBytes +
                            (((c % 8) ^ (row & 7)) << 4) + col0 * 2;
      const uint32_t v = pack_bf16(acc[i] * inv[r], acc[i + 1] * inv[r]);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
    }
  }
  // The TMA (the async proxy) must see these stores, and all 128 threads'
  // (named barrier 1 + wg: 0 is __syncthreads').
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if ((tid & 127) == 0) {
#pragma unroll
    for (int box = 0; box < L::kBoxes; ++box)
      tma_store_3d(o_map, sQ + box * kBQ * kRowBytes + wg * 64 * kRowBytes, box * kBoxCols,
                   q0 + wg * 64, item.bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the tile may be reused
  }
}

// Persistent: a block per SM walks the work items w = blockIdx.x,
// blockIdx.x + gridDim.x, ...; its producer loads the next item's Q and K/V
// while the consumers finish this one.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse, int BH,
                      int nq, int H, int Kh, int Sq, int Skv, int causal, int window,
                      long long q_offset, float scale_log2) {
  using L = Layout<D>;
  constexpr int kStages = L::kStages, kQBufs = L::kQBufs, kBKV = L::kBKV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  // Barriers, 8 bytes each: per Q buffer a "full" one (its TMA bytes have
  // landed) and an "empty" one (both warpgroups' O stores have read it), then
  // the same pair per stage of the ring.
  const uint32_t bar_qfull = base + L::kBar, bar_qempty = bar_qfull + 8 * kQBufs;
  const uint32_t bar_full = bar_qempty + 8 * kQBufs, bar_empty = bar_full + 8 * kStages;
  const int tid = threadIdx.x;
  const int items = BH * nq;

  if (tid == 0) {
#pragma unroll
    for (int qb = 0; qb < kQBufs; ++qb) {
      mbar_init(bar_qfull + 8 * qb, 1);
      mbar_init(bar_qempty + 8 * qb, 2);  // one arrival per consumer warpgroup
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warpgroup gives its registers to the consumers; one thread
    // keeps the Q buffers and the ring full, each as soon as it is released.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      int tile = 0, k = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++k) {
        const Item item = item_of<kBKV>(w, BH, nq, H, Kh, Sq, Skv, causal, window, q_offset);
        const int qb = k % kQBufs;
        if (k >= kQBufs) mbar_wait(bar_qempty + 8 * qb, (k / kQBufs - 1) & 1);
        mbar_expect_tx(bar_qfull + 8 * qb, L::kQBytes);
#pragma unroll
        for (int box = 0; box < L::kBoxes; ++box)
          tma_load_3d(sQ + qb * L::kQBytes + box * kBQ * kRowBytes, &q_map, bar_qfull + 8 * qb,
                      box * kBoxCols, item.q0, item.bh);
        for (int t = 0; t < item.n_tiles; ++t, ++tile) {
          const int stage = tile % kStages;
          if (tile >= kStages) mbar_wait(bar_empty + 8 * stage, (tile / kStages - 1) & 1);
          const uint32_t bar = bar_full + 8 * stage;
          const int j0 = (int)(item.kv_begin + (long long)t * kBKV);
          mbar_expect_tx(bar, 2 * L::kTileBytes);
#pragma unroll
          for (int box = 0; box < L::kBoxes; ++box) {
            const uint32_t off = stage * L::kTileBytes + box * kBKV * kRowBytes;
            tma_load_3d(sK + off, &k_map, bar, box * kBoxCols, j0, item.kvh);
            tma_load_3d(sV + off, &v_map, bar, box * kBoxCols, j0, item.kvh);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    int tile = 0, k = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x, ++k) {
      const Item item = item_of<kBKV>(w, BH, nq, H, Kh, Sq, Skv, causal, window, q_offset);
      const int qb = k % kQBufs;
      mbar_wait(bar_qfull + 8 * qb, (k / kQBufs) & 1);
      attend<D>(item, &o_map, lse, sQ + qb * L::kQBytes, sK, sV, bar_full, bar_empty, tile, Sq,
                Skv, causal, window, q_offset, scale_log2);
      if ((tid & 127) == 0) mbar_arrive(bar_qempty + 8 * qb);  // after its store read the tile
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

// A (heads, S, D) bf16 tensor, read in boxes of 64 columns x `rows` rows of one
// head; a box's columns past D (and rows past S) load as zeros and are not stored.
int make_map(CUtensorMap* map, const void* ptr, int heads, int S, int D, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxCols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
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
  CUtensorMap qm, km, vm, om;
  int err = make_map(&qm, q, B * H, Sq, D, kBQ);
  if (err == 0) err = make_map(&om, o, B * H, Sq, D, 64);
  if (err == 0) err = make_map(&km, k, B * Kh, Skv, D, Layout<D>::kBKV);
  if (err == 0) err = make_map(&vm, v, B * Kh, Skv, D, Layout<D>::kBKV);
  if (err != 0) return err;
  constexpr int smem = Layout<D>::kLaunchBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int nq = (Sq + kBQ - 1) / kBQ;
  const long long items = (long long)B * H * nq;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, om, lse, B * H, nq, H, Kh, Sq, Skv, causal, window, q_offset,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, D), k and v (B, Kh, Skv, D), o (B, H, Sq, D): contiguous bf16,
// base addresses 16-byte aligned (TMA), D a multiple of 16 up to 256; lse null or f32
// (B, H, Sq).  The wrapper has checked shapes, types, alignment, H % Kh == 0
// and grid limits.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int H, int Kh, int Sq, int Skv, int D,
                                        int causal, int window, long long q_offset, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  if (Skv == 0) {  // no key for any row: zeros (a tensor map cannot have an empty dim)
    cudaError_t e = cudaMemsetAsync(o, 0, (size_t)B * H * Sq * D * 2, s);
    if (e == cudaSuccess && l != nullptr) {
      fill_kernel<<<256, 256, 0, s>>>(l, (long long)B * H * Sq, INFINITY);
      e = cudaGetLastError();
    }
    return (int)e;
  }
  switch (D) {
#define FLASH_SM90_CASE(d) \
  case d:                  \
    return launch<d>(q, k, v, o, l, B, H, Kh, Sq, Skv, causal, window, q_offset, scale, s);
    FLASH_SM90_CASE(16) FLASH_SM90_CASE(32) FLASH_SM90_CASE(48) FLASH_SM90_CASE(64)
    FLASH_SM90_CASE(80) FLASH_SM90_CASE(96) FLASH_SM90_CASE(112) FLASH_SM90_CASE(128)
    FLASH_SM90_CASE(144) FLASH_SM90_CASE(160) FLASH_SM90_CASE(176) FLASH_SM90_CASE(192)
    FLASH_SM90_CASE(208) FLASH_SM90_CASE(224) FLASH_SM90_CASE(240) FLASH_SM90_CASE(256)
#undef FLASH_SM90_CASE
  }
  return (int)cudaErrorInvalidValue;
}

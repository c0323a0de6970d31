// Building blocks for attention bodies on Hopper (sm_90a) that stage tiles
// with the Tensor Memory Accelerator (TMA) and multiply with warpgroup MMA
// (wgmma): mbarrier waits and arrivals, 4-D TMA loads and the host-side
// tensor maps they read, wgmma shared-memory descriptors for the 128-, 64-
// and 32-byte swizzled layouts, the wgmma instructions, register
// reallocation (setmaxnreg) between a producer and its consumer warpgroups,
// and the attention pipeline built from them (attention_block: a producer
// warpgroup keeping a ring of K/V tiles in flight, two consumer warpgroups
// taking turns on the tensor cores), which a source instantiates with its
// own walk over the key tiles. Used by stale_kv_attention.cu (K1, K2, K4,
// K5: key runs of one source each) and flash_attention.cu (K6: the causal /
// window / prefix walk). Everything sits in an anonymous namespace: each
// source that includes this file gets its own copy.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskedScore = -1e30f;  // finite: -1e30 - -1e30 is 0, not NaN

struct Strides {  // element strides of a [B, S, H, hd] view; hd is contiguous
  int64_t b, s, h;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Split each of two fp32 values x into two bf16 terms, x = big + small to
// about 16 mantissa bits: `big` packs the rounded values (a in the low
// half), `small` packs what that rounding lost.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& big, uint32_t& small) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  const float2 r = __bfloat1622float2(v);
  big = *reinterpret_cast<uint32_t*>(&v);
  small = pack_bf16(a - r.x, b - r.y);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a pipeline fault) traps after about 2^31 polls, so the launch fails
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == 0x80000000u) __trap();
  }
}

// --- TMA ------------------------------------------------------------------

// Copy one box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory at `dst`; completion is counted in bytes on `bar`. Elements
// outside the map's extents (negative coordinates included) land as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle of a row of `row_bytes` bytes
// (128: layout 1, 64: layout 2, 32: layout 3). The tile must sit at an
// address aligned to its 8-row swizzle atom (8 * row_bytes), so the base
// offset field stays 0.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
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

// Tie registers to this point of the instruction stream, so the compiler
// neither reads a wgmma accumulator before the wait that completes it nor
// writes one while a wgmma may still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_regs(r[i]);
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= A (smem, K-major) * B (smem; K-major), m64n128k16, bf16 in, fp32 accumulate;
// accumulate = false overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                   bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(int(accumulate)));
}

// d (+)= A (smem, K-major) * B (smem; K-major), m64n64k16, bf16 in, fp32 accumulate;
// accumulate = false overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                  bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(int(accumulate)));
}

// S (+)= Q K^T for a key tile of N rows (both operands K-major in shared
// memory).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         bool accumulate) {
  if constexpr (N == 128) wgmma_m64n128k16_ss(d, desc_a, desc_b, accumulate);
  else {
    static_assert(N == 64, "wgmma_ss is instantiated for N = 64 and 128");
    wgmma_m64n64k16_ss(d, desc_a, desc_b, accumulate);
  }
}

// d += A (registers: the 16x16 bf16 fragment of each warp) * B (smem,
// MN-major), m64n64k16, fp32 accumulate.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A (registers: the 16x16 bf16 fragment of each warp) * B (smem,
// MN-major), m64n32k16, fp32 accumulate.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A (registers: the 16x16 bf16 fragment of each warp) * B (smem,
// MN-major), m64n16k16, fp32 accumulate.
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A (registers) * B (smem, MN-major) for the output widths the
// stale-KV body uses.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 64) wgmma_m64n64k16_rs(d, a, desc_b);
  else if constexpr (N == 32) wgmma_m64n32k16_rs(d, a, desc_b);
  else {
    static_assert(N == 16, "wgmma_rs is instantiated for N = 16, 32 and 64");
    wgmma_m64n16k16_rs(d, a, desc_b);
  }
}

// --- named barriers and fast math ----------------------------------------

// Block on barrier `id` until `count` threads have arrived or synced on it.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Arrive on barrier `id` without waiting.
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 2^x in one MUFU instruction (relative error about 2^-22; results below
// 2^-126 flush to 0, where a probability weighs nothing anyway).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- register reallocation between warpgroups -----------------------------

template <int R>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_acquire() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// --- host: tensor maps -----------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda function), looked up through the runtime
// so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// --- the attention pipeline ------------------------------------------------
//
// One block owns kBQ query rows of one (batch row, head) and walks key tiles
// of HeadTiles<HD>::BK rows (kBK, or 64 at head dims above 128). A head
// dim is split into boxes of 64 columns (128-byte swizzle) and at most one
// tail box of 16 (hd 72 and 80). Warpgroup 0 is the producer: one thread
// keeps a ring of HeadTiles<HD>::kStages K/V stages full with 4-D TMA
// loads; each stage has a full barrier
// (the producer's expect_tx arrival plus the bytes) and an empty barrier
// (one arrival per consumer warp). setmaxnreg gives the producer 40
// registers and each consumer 232. Warpgroups 1 and 2 each own 64 of the
// query rows (the Q tile stays in shared memory): S = Q K^T runs as
// wgmma.m64n{BK}k16 over each box's k16 slices, both operands K-major in
// shared memory; P V (one wgmma.m64n64k16 a box and k16 slice) takes P
// from registers (the S accumulator's layout is the A fragment's) and V
// from shared memory as an MN-major B operand, P as two bf16 terms (its
// rounding and the remainder), so P V keeps P to about 16 bits as an fp32
// p @ v does. The two consumer warpgroups take turns on the tensor cores
// (named barriers 1 and 2): a turn is P V of tile t - 1 then Q K^T of tile
// t, and while one warpgroup's turn runs the other computes its softmax.
// P V completes before Q K^T is issued, so the P fragments and the scores
// are never live at once.
//
// The source supplies the walk, an object with
//   int count() const;                 the key tiles the block visits
//   Cursor begin() const; void next(Cursor&) const;  the tiles in order
//   const CUtensorMap* k_map(const Cursor&) const;   K and V maps of the
//   const CUtensorMap* v_map(const Cursor&) const;   tile (2 boxes each)
//   int row(const Cursor&) const;      the tile's first key row in the map
//   void mask(float (&s)[BK / 2], const Cursor&, int row_lo, int row_hi,
//             int lane) const;         raw score -> kMaskedScore where the
//                                      key is hidden from the row
// Scores keep their raw value, the running max is kept on raw scores, and
// p = 2^(s * scale * log2(e) - m') is one FFMA and one MUFU ex2. A row whose
// visited keys so far are all hidden keeps m at kMaskedScore and weighs its
// hidden keys 0 (the offset is then 0, not m): its first real key rescales
// nothing that counts.

constexpr int kBQ = 128;          // query rows per block: 2 consumer warpgroups x 64
constexpr int kBK = 128;          // keys per tile up to head dim 128
constexpr int kThreads = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory a block may have

// Column split of a head dim onto swizzled boxes, the key tile and the
// ring's depth. Registers of a consumer thread: HD / 2 fp32 of O, BK / 2 of
// S and BK / 4 of P's two bf16 terms; at HD 256 a 128-key tile would not
// fit the 232 that setmaxnreg gives, so the tile has 64 keys there, and
// Q (64 KB) plus two 64 KB stages fill the shared memory.
template <int HD>
struct HeadTiles {
  static constexpr int HDP = (HD + 15) / 16 * 16;  // padded to the wgmma depth
  static constexpr int W0 = HD >= 64 ? 64 : HDP;   // columns of each full box
  static constexpr int NB = HD >= 64 ? HDP / 64 : 1;  // full boxes
  static constexpr int W1 = HDP - NB * W0;         // columns in the tail box (0 or 16)
  static constexpr int RB0 = 2 * W0, RB1 = 2 * W1; // bytes a row: the swizzle width
  static_assert(W0 == 64 || W0 == 32, "a full box must fill a 128- or 64-byte swizzle row");
  static_assert(W1 == 0 || W1 == 16, "the tail box must be empty or one 32-byte row");
  static constexpr int BK = HD > 128 ? 64 : kBK;   // keys per tile
  static constexpr int kStages = HD > 128 ? 2 : 3; // K/V tiles in flight
  static constexpr int kQBox = kBQ * RB0;          // bytes of one Q box
  static constexpr int kTile0 = BK * RB0, kTile1 = BK * RB1;  // bytes of one K or V box
  static constexpr int kQBytes = kBQ * (NB * RB0 + RB1);
  static constexpr int kStageBytes = 2 * (NB * kTile0 + kTile1);  // K and V
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kSmemBytes = kBarOffset + 8 * (2 * kStages + 1) + 1024;  // + alignment
  static_assert(kSmemBytes <= kMaxSmemBytes, "the pipeline does not fit shared memory");
};

// Map of a bf16 [B, S, H, hd] view (hd contiguous, element strides `st`)
// read in boxes of `width` columns x `rows` rows of one head and batch row,
// under the swizzle of a `width`-column row. A dimension of extent 1 gets
// a dense stride (its coordinate is always 0, whatever the view's stride).
// Rows outside [0, S) land in shared memory as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, Strides st, int B, int S, int H, int hd,
                int width, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const int64_t elem[3] = {st.h, st.s, st.b};
  cuuint64_t strides[3];
  cuuint64_t dense = 2 * (cuuint64_t)hd;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? dense : 2 * (cuuint64_t)elem[i];
    dense = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)width, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of a head dim read in boxes of `rows` rows: maps[0] reads every
// full box (at column offsets 0, W0, ...), maps[1] the tail box (only when
// HeadTiles<HD>::W1 > 0). Q is read in kBQ rows, K and V in BK.
template <int HD>
bool encode_maps(CUtensorMap (&maps)[2], const void* ptr, Strides st, int B, int S, int H,
                 int rows = HeadTiles<HD>::BK) {
  using T = HeadTiles<HD>;
  return encode_map(&maps[0], ptr, st, B, S, H, HD, T::W0, rows) &&
         (T::W1 == 0 || encode_map(&maps[1], ptr, st, B, S, H, HD, T::W1, rows));
}

// Natural-log LSE of a row from its running max m (log2 domain) and sum l
// of exp2(score - m); an empty row (no key visited, l == 0) gets the
// masked sentinel.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m * 0.6931471805599453f + logf(l) : kMaskedScore;
}

// The block's attention: query rows [q0, q0 + kBQ) of batch row b and head
// h (Q read through q_maps at head h, K and V at kv_head), over the keys of
// `walk`; rows below n_rows are stored to out (bf16) and, when lse is not
// null, their fp32 log-sum-exp to lse. Runs on all kThreads threads of a
// block launched with HeadTiles<HD>::kSmemBytes of dynamic shared memory.
template <int HD, class Walk>
__device__ __forceinline__ void attention_block(const CUtensorMap* q_maps, const Walk& walk,
                                                int b, int h, int kv_head, int q0, int n_rows,
                                                __nv_bfloat16* __restrict__ out, Strides so,
                                                float* __restrict__ lse, Strides sl,
                                                float scale_log2) {
  using T = HeadTiles<HD>;
  using Cursor = decltype(walk.begin());
  constexpr int W0 = T::W0, W1 = T::W1, NB = T::NB, RB0 = T::RB0, RB1 = T::RB1;
  constexpr int BK = T::BK, kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled boxes need 1024-byte aligned addresses
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto qbox = [&](int j) { return base + j * T::kQBox; };  // j == NB: the tail box
  // stage st: K's full boxes, K's tail box, V's full boxes, V's tail box
  auto kbox = [&](int st, int j) { return base + T::kQBytes + st * T::kStageBytes + j * T::kTile0; };
  auto vbox = [&](int st, int j) { return kbox(st, NB) + T::kTile1 + j * T::kTile0; };
  const uint32_t bars = base + T::kBarOffset;
  auto full_bar = [&](int st) { return bars + 8 * st; };
  auto empty_bar = [&](int st) { return bars + 8 * (kStages + st); };
  const uint32_t q_bar = bars + 8 * (2 * kStages);
  const int n_tiles = walk.count();

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    regs_release<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_bar, T::kQBytes);
#pragma unroll
      for (int j = 0; j < NB; ++j) tma_load_4d(qbox(j), &q_maps[0], q_bar, j * W0, h, q0, b);
      if constexpr (W1 > 0) tma_load_4d(qbox(NB), &q_maps[1], q_bar, NB * W0, h, q0, b);
      int st = 0, phase = 0;
      Cursor cur = walk.begin();
      for (int t = 0; t < n_tiles; ++t, walk.next(cur)) {
        const CUtensorMap* km = walk.k_map(cur);
        const CUtensorMap* vm = walk.v_map(cur);
        const int c = walk.row(cur);
        mbar_wait(empty_bar(st), phase ^ 1);
        mbar_arrive_expect_tx(full_bar(st), T::kStageBytes);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(kbox(st, j), km, full_bar(st), j * W0, kv_head, c, b);
          tma_load_4d(vbox(st, j), vm, full_bar(st), j * W0, kv_head, c, b);
        }
        if constexpr (W1 > 0) {
          tma_load_4d(kbox(st, NB), km + 1, full_bar(st), NB * W0, kv_head, c, b);
          tma_load_4d(vbox(st, NB), vm + 1, full_bar(st), NB * W0, kv_head, c, b);
        }
        if (++st == kStages) st = 0, phase ^= 1;
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    regs_acquire<232>();
    const int ct = threadIdx.x - 128;
    const int wg = ct / 128;  // which consumer warpgroup
    const int warp = (ct % 128) / 32;
    const int lane = ct % 32;
    // this warpgroup's 64 rows of Q box j (j == NB: the tail box)
    auto qa = [&](int j) { return qbox(j) + wg * 64 * (j < NB ? RB0 : RB1); };
    const int row_lo = q0 + wg * 64 + warp * 16 + lane / 4;  // rows of s[i], i % 4 < 2
    const int row_hi = row_lo + 8;                            // ... and i % 4 >= 2

    float o0[NB][W0 / 2];  // O's columns of each full box
    float o1[W1 > 0 ? W1 / 2 : 1];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < W0 / 2; ++i) o0[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (W1 > 0 ? W1 / 2 : 1); ++i) o1[i] = 0.f;
    float m_lo = kMaskedScore, m_hi = kMaskedScore;  // raw max of rows row_lo, row_hi
    float l_lo = 0.f, l_hi = 0.f;                    // this thread's partial sums

    // Q K^T of the stage's key tile into s (64 rows x BK keys; K-major
    // operands in shared memory), box by box
    auto issue_qk = [&](float (&s)[BK / 2], int st) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int kk = 0; kk < W0 / 16; ++kk)
          wgmma_ss<BK>(s, wgmma_desc(qa(j) + 32 * kk, 16, 8 * RB0, RB0),
                       wgmma_desc(kbox(st, j) + 32 * kk, 16, 8 * RB0, RB0), j > 0 || kk > 0);
      if constexpr (W1 > 0)
        wgmma_ss<BK>(s, wgmma_desc(qa(NB), 16, 8 * RB1, RB1),
                     wgmma_desc(kbox(st, NB), 16, 8 * RB1, RB1), true);
    };
    // O += P V over the stage's value tile. The accumulators of keys
    // 16kk .. 16kk+15 are exactly the A fragment of k-step kk. V is
    // MN-major: the descriptor's stride steps between 8-key groups; its
    // leading offset (between column groups) is unused at these widths.
    auto issue_pv = [&](const uint32_t (&pa)[BK / 16][4], const uint32_t (&pr)[BK / 16][4],
                        int st) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint32_t(&a)[4] = t == 0 ? pa[kk] : pr[kk];
#pragma unroll
          for (int j = 0; j < NB; ++j)
            wgmma_rs<W0>(o0[j], a, wgmma_desc(vbox(st, j) + kk * 16 * RB0, 8 * RB0, 8 * RB0, RB0));
          if constexpr (W1 > 0)
            wgmma_rs<W1>(o1, a, wgmma_desc(vbox(st, NB) + kk * 16 * RB1, 8 * RB1, 8 * RB1, RB1));
        }
    };
    // Online softmax over one tile of raw scores, in place: the walk masks
    // the hidden keys, s becomes the probabilities exp2(s * scale_log2 - m),
    // m (raw) and l move on, and alpha is the factor O must still be scaled
    // by. s[4j + e]: key 8j + 2(lane%4) + e%2 of row row_lo (e < 2) or
    // row_hi (e >= 2); a row's scores live in one lane quad.
    auto softmax = [&](float (&s)[BK / 2], const Cursor& cur, float& alpha_lo,
                       float& alpha_hi) {
      walk.mask(s, cur, row_lo, row_hi, lane);
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int i = 0; i < BK / 2; i += 4) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[i], s[i + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[i + 2], s[i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      alpha_lo = fast_exp2((m_lo - mx_lo) * scale_log2);
      alpha_hi = fast_exp2((m_hi - mx_hi) * scale_log2);
      const float off_lo = mx_lo == kMaskedScore ? 0.f : mx_lo * scale_log2;
      const float off_hi = mx_hi == kMaskedScore ? 0.f : mx_hi * scale_log2;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; i += 4) {
        s[i] = fast_exp2(fmaf(s[i], scale_log2, -off_lo));
        s[i + 1] = fast_exp2(fmaf(s[i + 1], scale_log2, -off_lo));
        s[i + 2] = fast_exp2(fmaf(s[i + 2], scale_log2, -off_hi));
        s[i + 3] = fast_exp2(fmaf(s[i + 3], scale_log2, -off_hi));
        sum_lo += s[i] + s[i + 1];
        sum_hi += s[i + 2] + s[i + 3];
      }
      l_lo = l_lo * alpha_lo + sum_lo;
      l_hi = l_hi * alpha_hi + sum_hi;
      m_lo = mx_lo;
      m_hi = mx_hi;
    };
    auto rescale = [&](float alpha_lo, float alpha_hi) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < W0 / 2; ++i) o0[j][i] *= (i % 4) < 2 ? alpha_lo : alpha_hi;
      if constexpr (W1 > 0) {
#pragma unroll
        for (int i = 0; i < W1 / 2; ++i) o1[i] *= (i % 4) < 2 ? alpha_lo : alpha_hi;
      }
    };
    auto to_bf16 = [&](const float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4],
                       uint32_t (&pr)[BK / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], pa[kk][j], pr[kk][j]);
    };
    auto release = [&](int st) {  // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));
    };

    // The tiles of the walk in order. The tensor work comes in turns: Q K^T
    // of tile 0; then P V of tile t - 1 and Q K^T of tile t; then P V of
    // the last tile. The two consumer warpgroups take turns (named barriers
    // 1 and 2, warpgroup 0 first), so one's turn runs on the tensor cores
    // while the other computes its softmax. Within a turn P V completes
    // before Q K^T is issued, so the P fragments and the scores are never
    // live at once.
    mbar_wait(q_bar, 0);
    if (n_tiles > 0) {
      const int my_turn = 1 + wg, other_turn = 2 - wg;
      if (wg == 1) named_bar_arrive(1, 256);  // warpgroup 0 issues first
      float s[BK / 2];
      uint32_t pa[BK / 16][4], pr[BK / 16][4];
      float alpha_lo, alpha_hi;
      Cursor cur = walk.begin();
      int st = 0, phase = 0, prev = 0;  // this tile's stage, and that of tile t - 1
      auto next_tile = [&]() {
        walk.next(cur);
        prev = st;
        if (++st == kStages) st = 0, phase ^= 1;
      };

      mbar_wait(full_bar(st), phase);
      named_bar_sync(my_turn, 256);
      wgmma_fence();
      issue_qk(s, st);
      wgmma_commit();
      named_bar_arrive(other_turn, 256);
      wgmma_wait_all();
      fence_regs(s);
      softmax(s, cur, alpha_lo, alpha_hi);  // O is still zero: no rescale
      to_bf16(s, pa, pr);
      next_tile();
      for (int t = 1; t < n_tiles; ++t) {
        mbar_wait(full_bar(st), phase);
        named_bar_sync(my_turn, 256);
        wgmma_fence();
        issue_pv(pa, pr, prev);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o0);
        fence_regs(o1);
        fence_regs(pa);
        fence_regs(pr);
        release(prev);
        wgmma_fence();
        issue_qk(s, st);
        wgmma_commit();
        named_bar_arrive(other_turn, 256);
        wgmma_wait_all();
        fence_regs(s);
        softmax(s, cur, alpha_lo, alpha_hi);
        rescale(alpha_lo, alpha_hi);
        to_bf16(s, pa, pr);
        next_tile();
      }
      named_bar_sync(my_turn, 256);
      wgmma_fence();
      issue_pv(pa, pr, prev);
      wgmma_commit();
      if (wg == 0) named_bar_arrive(other_turn, 256);  // warpgroup 1 has the last turn
      wgmma_wait_all();
      fence_regs(o0);
      fence_regs(o1);
      fence_regs(pa);
      fence_regs(pr);
      release(prev);
    }

#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    __nv_bfloat16* out_lo = out + b * so.b + (int64_t)row_lo * so.s + h * so.h;
    __nv_bfloat16* out_hi = out_lo + 8 * so.s;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < W0 / 2; i += 4) {
        const int col = j * W0 + 2 * i + 2 * (lane % 4);  // + 8 * (i / 4) + 2 * (lane % 4)
        if (col >= HD) continue;
        if (row_lo < n_rows)
          *reinterpret_cast<uint32_t*>(out_lo + col) =
              pack_bf16(o0[j][i] * inv_lo, o0[j][i + 1] * inv_lo);
        if (row_hi < n_rows)
          *reinterpret_cast<uint32_t*>(out_hi + col) =
              pack_bf16(o0[j][i + 2] * inv_hi, o0[j][i + 3] * inv_hi);
      }
    if constexpr (W1 > 0) {
#pragma unroll
      for (int i = 0; i < W1 / 2; i += 4) {
        const int col = NB * W0 + 2 * i + 2 * (lane % 4);
        if (col >= HD) continue;
        if (row_lo < n_rows)
          *reinterpret_cast<uint32_t*>(out_lo + col) =
              pack_bf16(o1[i] * inv_lo, o1[i + 1] * inv_lo);
        if (row_hi < n_rows)
          *reinterpret_cast<uint32_t*>(out_hi + col) =
              pack_bf16(o1[i + 2] * inv_hi, o1[i + 3] * inv_hi);
      }
    }
    if (lse != nullptr && lane % 4 == 0) {  // one lane of the quad owns the row
      if (row_lo < n_rows)
        lse[b * sl.b + (int64_t)row_lo * sl.s + h * sl.h] = row_lse(m_lo * scale_log2, l_lo);
      if (row_hi < n_rows)
        lse[b * sl.b + (int64_t)row_hi * sl.s + h * sl.h] = row_lse(m_hi * scale_log2, l_hi);
    }
  }
}

// Set a kernel's dynamic shared memory limit once per device.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int device = 0;
  cudaGetDevice(&device);
  if (device < 64 && !done[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

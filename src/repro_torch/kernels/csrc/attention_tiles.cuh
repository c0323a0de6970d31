// Building blocks shared by the port's attention kernels on Hopper (sm_90a):
// stale_kv_attention.cu (K1, K2, K4, K5) and flash_attention.cu (K6). The
// tensor-core helpers wrap mma.sync m16n8k16 (bf16 in, fp32 accumulate),
// ldmatrix and cp.async; a block of kMmaThreads = 4 warps owns kMmaBQ query
// rows (16 per warp) and walks the keys in shared-memory tiles of kMmaBK
// rows. Everything sits in an anonymous namespace: each source that includes
// this file gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskedScore = -1e30f;  // finite: -1e30 - -1e30 is 0, not NaN

struct Strides {  // element strides of a [B, S, H, hd] view; hd is contiguous
  int64_t b, s, h;
};

constexpr int kMmaBQ = 64;       // query rows per block: 4 warps x 16 rows
constexpr int kMmaBK = 64;       // key rows per shared-memory tile
constexpr int kMmaThreads = 128;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = fill ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying `rows` rows of a [B, S, H, hd] tensor into shared memory as
// [rows][SROW] bf16 (cp.async, no registers), zero-filling the padded dims
// and every row whose `src_row(r)` is nullptr. `any` is a valid global
// address for the zero-filling copies, which read nothing.
template <int HD, int SROW, typename RowFn>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int rows,
                                           const __nv_bfloat16* any, RowFn src_row) {
  constexpr int kChunks = (HD + 15) / 16 * 2;  // 16-byte chunks per padded row
  constexpr int kReal = HD / 8;                // chunks that hold data
  for (int i = threadIdx.x; i < rows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const __nv_bfloat16* p = c < kReal ? src_row(r) : nullptr;
    cp_async_16(dst + r * SROW + c * 8, p != nullptr ? p + c * 8 : any, p != nullptr);
  }
}

}  // namespace

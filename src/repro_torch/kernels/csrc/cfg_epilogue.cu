// Classifier-free-guidance epilogue (kernel K3) on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cfg_epilogue.py, function
// cfg_epilogue_2d (body _cfg_kernel). It computes the same function, in one
// elementwise pass over the two guidance branches of eps:
//
//   delta = f32(eps_c) - f32(eps_u)                 (written as fp32)
//   out   = eps_dtype(f32(eps_u) + w * delta)       (written in eps's dtype)
//
// with w a runtime scalar, so one build serves every guidance scale. The TPU
// kernel works on [M, 128] tiles of the padded, flattened eps; this one works
// on the flat element count n with no padding.
//
// What bounds it on this card: memory. Each element reads eps_c and eps_u
// once and writes out and delta once (10 bytes in bf16, 16 in fp32) for
// three floating-point operations. At the main path's sizes (sdxl-dit eps of
// 28,672 to 65,536 elements per branch) that is at most 0.66 MB, under a
// microsecond at the card's memory rate, so a launch is bound by its own
// overhead.
//
// What the design does about that, kept simple: a grid-stride loop of
// 16-byte vector loads and stores (8 bf16 or 4 fp32 elements a thread)
// where every pointer is 16-byte aligned, and a scalar loop for the tail and
// for unaligned pointers. The arithmetic is written with the _rn intrinsics,
// so nvcc cannot contract w * delta + eps_u into an FMA: the result is
// bitwise equal to PyTorch's eager eu + w * d (two kernels, each rounded to
// nearest), and the bf16 output is rounded to nearest even once, as
// PyTorch's cast rounds it. A null delta pointer skips the delta output.
// The kernel allocates nothing and runs on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one element: returns the combine in T, stores delta in d
template <typename T>
__device__ __forceinline__ T cfg_one(T ec, T eu, float w, float& d) {
  const float u = to_f32(eu);
  d = __fsub_rn(to_f32(ec), u);
  return from_f32<T>(__fadd_rn(u, __fmul_rn(w, d)));
}

template <typename T>
__global__ void cfg_epilogue_kernel(const T* __restrict__ ec, const T* __restrict__ eu,
                                    T* __restrict__ out, float* __restrict__ delta, int64_t n,
                                    float w, int vectorized) {
  constexpr int kVec = 16 / sizeof(T);  // elements in one 16-byte load
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t tail = 0;
  if (vectorized) {
    const int64_t n_vec = n / kVec;
    for (int64_t i = tid; i < n_vec; i += stride) {
      alignas(16) T a[kVec];
      alignas(16) T b[kVec];
      alignas(16) T o[kVec];
      alignas(16) float d[kVec];
      *reinterpret_cast<uint4*>(a) = reinterpret_cast<const uint4*>(ec)[i];
      *reinterpret_cast<uint4*>(b) = reinterpret_cast<const uint4*>(eu)[i];
#pragma unroll
      for (int j = 0; j < kVec; ++j) o[j] = cfg_one(a[j], b[j], w, d[j]);
      reinterpret_cast<uint4*>(out)[i] = *reinterpret_cast<const uint4*>(o);
      if (delta != nullptr) {
        float4* dst = reinterpret_cast<float4*>(delta + i * kVec);
#pragma unroll
        for (int j = 0; j < kVec / 4; ++j) dst[j] = reinterpret_cast<const float4*>(d)[j];
      }
    }
    tail = n_vec * kVec;
  }
  for (int64_t i = tail + tid; i < n; i += stride) {
    float d;
    out[i] = cfg_one(ec[i], eu[i], w, d);
    if (delta != nullptr) delta[i] = d;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks of 256 threads per SM

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* ec, const void* eu, void* out, void* delta, int64_t n, float w,
           cudaStream_t stream) {
  const int vectorized = aligned16(ec) && aligned16(eu) && aligned16(out) && aligned16(delta);
  const int64_t items = vectorized ? n / (16 / sizeof(T)) + n % (16 / sizeof(T)) : n;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  cfg_epilogue_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(ec), static_cast<const T*>(eu), static_cast<T*>(out),
      static_cast<float*>(delta), n, w, vectorized);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (eps_c, eps_u and out); delta is float32
// or null. All arrays are contiguous with n elements. Returns the CUDA error
// of the launch (0 = launched).
extern "C" int cfg_epilogue_launch(int dtype, const void* eps_c, const void* eps_u, void* out,
                                   void* delta, int64_t n, float w, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(eps_c, eps_u, out, delta, n, w, s);
    case 1: return launch<__nv_bfloat16>(eps_c, eps_u, out, delta, n, w, s);
    default: return cudaErrorInvalidValue;
  }
}

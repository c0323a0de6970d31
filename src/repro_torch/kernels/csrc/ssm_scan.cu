// Selective-SSM (Mamba) scan on Hopper (sm_90a): kernel K7 of the port.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py, ssm_scan_chunked
// (body _ssm_kernel). It computes the same recurrence in fp32,
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t^T     h: [Di, N] per batch row
//   y_t = <h_t, C_t> + D * x_t
//
// for x, dt [B, S, Di], B_t, C_t [B, S, N], A [Di, N], D [Di], with y in x's
// dtype. Beyond the TPU kernel, the state can start from h0 [B, Di, N] (zeros
// when null) and the final state can be written to h_final [B, Di, N], both
// fp32: with neither it is the TPU kernel's function, with both it is
// repro.models.mamba.ssm_scan_ref, which Mamba's prefill (its final state
// becomes the cache) and decode (S = 1, the state carried) need.
//
// What bounds it on this card: bytes. At Hymba-1.5B's prefill (B 1, S 2048,
// Di 1600, N 16, fp32) one launch reads x and dt (26.2 MB) and writes y
// (13.1 MB), about 39.6 MB with B_t, C_t, A, D and the states, for some
// 10 operations per (t, d, n): about 12 us at the memory rate. The
// recurrence is sequential in t, so the parallelism is B * Di * N lanes.
//
// What the design does about that, kept simple before it is made fast:
//   * One thread per (b, d, n): a block of 128 threads owns 8 channels of
//     one batch row, 16 lanes a channel, each lane one state h[d, n] in a
//     register for the whole sequence (the TPU kernel's VMEM scratch, carried
//     across its sequential chunk axis, becomes a register carried across
//     the loop). y_t = <h_t, C_t> is a 16-lane butterfly of shuffles.
//   * The block stages 64 time steps of x, dt (its 8 channels), B_t and C_t
//     (all 16 states) in shared memory, converted to fp32; the next chunk's
//     loads are issued into registers before this chunk's steps run, so
//     they are in flight meanwhile. y is gathered in shared memory and
//     written a chunk at a time.
//   * The channel axis is bounded by Di and the time loop by S: nothing is
//     padded (the TPU wrapper padded Di to 128 lanes and S to its chunk).
// 1,600 channels x 16 states fill 800 warps, about 6 an SM: a scan across
// chunks (a second pass) would add parallelism; that is later work.
// The kernel allocates nothing and runs on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;                   // the state size instantiated (Hymba: 16)
constexpr int kThreads = 128;
constexpr int kChannels = kThreads / kN;  // channels per block
constexpr int kChunk = 64;               // time steps staged per pass
constexpr int kXPer = kChunk * kChannels / kThreads;  // x (and dt, y) elements a thread moves
constexpr int kBPer = kChunk * kN / kThreads;         // B_t (and C_t) elements a thread moves

struct Strides2 {  // element strides (b, s) of a [B, S, C] view; C is contiguous
  int64_t b, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bt,
                const T* __restrict__ ct, const float* __restrict__ a,
                const float* __restrict__ dskip, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_final, Strides2 sx, Strides2 sdt,
                Strides2 sb, Strides2 sc, Strides2 sy, int S, int Di) {
  __shared__ float xs[kChunk][kChannels];
  __shared__ float dts[kChunk][kChannels];
  __shared__ float bs[kChunk][kN];
  __shared__ float cs[kChunk][kN];
  __shared__ float ys[kChunk][kChannels];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int dl = tid / kN;  // this lane's channel in the block
  const int n = tid % kN;   // ... and its state
  const int d = d0 + dl;
  const bool live = d < Di;
  const float a_dn = live ? a[d * kN + n] : 0.f;
  const float d_dn = live ? dskip[d] : 0.f;
  const int64_t hidx = ((int64_t)b * Di + d) * kN + n;
  float h = (live && h0 != nullptr) ? h0[hidx] : 0.f;

  // the next chunk's inputs, in flight in registers while a chunk is scanned
  float rx[kXPer], rdt[kXPer], rb[kBPer], rc[kBPer];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int e = tid + j * kThreads, t = t0 + e / kChannels, dd = d0 + e % kChannels;
      const bool ok = t < S && dd < Di;
      rx[j] = ok ? to_f32(x[b * sx.b + t * sx.s + dd]) : 0.f;
      rdt[j] = ok ? to_f32(dt[b * sdt.b + t * sdt.s + dd]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int e = tid + j * kThreads, t = t0 + e / kN, nn = e % kN;
      rb[j] = t < S ? to_f32(bt[b * sb.b + t * sb.s + nn]) : 0.f;
      rc[j] = t < S ? to_f32(ct[b * sc.b + t * sc.s + nn]) : 0.f;
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    __syncthreads();  // the last chunk's staging and ys are no longer read
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int e = tid + j * kThreads;
      xs[e / kChannels][e % kChannels] = rx[j];
      dts[e / kChannels][e % kChannels] = rdt[j];
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int e = tid + j * kThreads;
      bs[e / kN][e % kN] = rb[j];
      cs[e / kN][e % kN] = rc[j];
    }
    __syncthreads();
    if (t0 + kChunk < S) fetch(t0 + kChunk);

    const int steps = min(kChunk, S - t0);
#pragma unroll 8
    for (int r = 0; r < steps; ++r) {
      const float dtv = dts[r][dl], xv = xs[r][dl];
      h = expf(dtv * a_dn) * h + (dtv * xv) * bs[r][n];
      float p = h * cs[r][n];
#pragma unroll
      for (int off = kN / 2; off > 0; off /= 2) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) ys[r][dl] = p + d_dn * xv;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int e = tid + j * kThreads, r = e / kChannels, dd = d0 + e % kChannels;
      if (r < steps && dd < Di) store(y + b * sy.b + (t0 + r) * sy.s + dd, ys[r][e % kChannels]);
    }
  }
  if (live && h_final != nullptr) h_final[hidx] = h;
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* bt, const void* ct, const float* a,
                   const float* dskip, const float* h0, void* y, float* h_final,
                   const Strides2* st, int B, int S, int Di, cudaStream_t stream) {
  const dim3 grid((Di + kChannels - 1) / kChannels, B);
  ssm_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(bt),
      static_cast<const T*>(ct), a, dskip, h0, static_cast<T*>(y), h_final, st[0], st[1], st[2],
      st[3], st[4], S, Di);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   dtype: 0 = float32, 1 = bfloat16: x, dt, b_t, c_t and y share it; a,
//          d_skip, h0 and h_final are float32 and contiguous
//   n_state: N; 16 is instantiated (Hymba-1.5B and its reduced form)
//   strides: 10 int64 element strides, (b, s) for x, dt, b_t, c_t, y in that
//            order; the last axis must be contiguous
//   h0, h_final: [B, Di, N], either may be null (zeros in, nothing out)
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ssm_scan_launch(int dtype, int n_state, const void* x, const void* dt,
                               const void* b_t, const void* c_t, const float* a,
                               const float* d_skip, const float* h0, void* y, float* h_final,
                               const int64_t* strides, int B, int S, int Di, void* stream) {
  if (n_state != kN || B <= 0 || S <= 0 || Di <= 0) return cudaErrorInvalidValue;
  Strides2 st[5];
  for (int i = 0; i < 5; ++i) st[i] = {strides[2 * i], strides[2 * i + 1]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, b_t, c_t, a, d_skip, h0, y, h_final, st, B, S, Di, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, b_t, c_t, a, d_skip, h0, y, h_final, st, B, S, Di, s);
  return cudaErrorInvalidValue;
}

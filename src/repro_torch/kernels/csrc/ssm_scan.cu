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
// (13.1 MB), about 39.9 MB with B_t, C_t, A, D and the states: 11.9 us at
// the memory rate. Its 52 M (t, d, n) steps each take an exp and a few
// FMAs, some 30 us of issue at the card's fp32 rate, so in practice the
// instruction issue bounds it, and the recurrence is sequential in t.
//
// The scan body (S > kSeqMaxS): parallel over time. The step is an affine
// map h -> a h + b with a = exp(dt A) (computed per step with expf, as the
// reference does) and b = dt x B, and maps compose associatively:
// (a2, b2) o (a1, b1) = (a2 a1, a2 b1 + b2). A block owns kScanChannels = 8
// channels of one batch row, a warp per channel, and walks the sequence in
// chunks of kScanChunk = 128 steps; lane p of a warp owns the kItems = 4
// consecutive steps 4p .. 4p+3 of a chunk. Per state n (all 16 unrolled,
// so the compiler overlaps them), a lane composes its steps' maps in order
// (keeping each prefix), the warp combines the lanes' composites with a
// 5-step shuffle scan (Hillis-Steele), each lane applies the composite of
// the lanes before it to the chunk's carry-in state to get the state
// before its first step, and each step's state is then prefix_a *
// h_before + prefix_b; y_t accumulates h_t C_t over n in registers. Lane
// 31's last state, shuffled to every lane, is the carry into the next
// chunk, so the chunks run in order inside the block with no second pass
// and no second read of x. ref.ssm_scan_chunked_ref is the same
// decomposition in PyTorch.
//   * Layout: the port keeps the reference's [B, S, Di] (time strided), so a
//     chunk's [128 x 8] tiles of x and dt and [128 x 16] tiles of B_t and
//     C_t (read in place from their strided halves) are staged through
//     shared memory transposed, channel- (state-) major with a padded row,
//     by coalesced row reads (cp.async for fp32, double-buffered, so the
//     next chunk loads while this one is scanned); a lane then reads its
//     steps as a float4. y goes back through the x tile and is written as
//     coalesced rows.
//   * 200 blocks of 256 threads at Hymba's Di, at most two an SM (128
//     registers a thread, 51 KB of shared memory a block). 4 steps a lane
//     rather than 8 keep the registers under 128 without spills (8 spilled
//     and ran 7 % slower, PERF.md section 6).
// The sequential body (S <= kSeqMaxS, decode's S = 1): one thread per
// (b, d, n), a block of 128 threads owns 8 channels of one batch row, each
// lane one state h[d, n] in a register for the whole sequence; y_t =
// <h_t, C_t> is a 16-lane butterfly of shuffles, 64 time steps staged in
// shared memory at a time.
// The kernels allocate nothing and run on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;  // the state size instantiated (Hymba: 16)

struct Strides2 {  // element strides (b, s) of a [B, S, C] view; C is contiguous
  int64_t b, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// ---------------------------------------------------------------------------
// the scan body: chunks of 128 steps, a warp per channel, a lane per 4 steps
// ---------------------------------------------------------------------------

constexpr int kScanChannels = 8;                  // channels per block: a warp each
constexpr int kItems = 4;                         // consecutive steps a lane owns
constexpr int kScanChunk = 32 * kItems;           // steps per chunk
constexpr int kScanThreads = 32 * kScanChannels;
constexpr int kRow = kScanChunk + 4;              // padded shared row (floats): conflict-free
                                                  // transposing stores, 16-byte aligned rows
constexpr int kStageFloats = (2 * kScanChannels + 2 * kN) * kRow;  // x, dt, B_t, C_t
constexpr int kScanSmemBytes = (2 * kStageFloats + kScanChannels * kN) * 4;

__device__ __forceinline__ void cp_async_4(float* smem, const float* gmem, bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(fill ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One element to `dst` from `src`, or a zero where `ok` is false (src then
// names any valid address). fp32 goes by cp.async (in flight until the
// caller waits), bf16 by a load and a store.
template <typename T>
__device__ __forceinline__ void stage_one(float* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) == 4) {
    cp_async_4(dst, reinterpret_cast<const float*>(src), ok);
  } else {
    *dst = ok ? to_f32(*src) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kScanThreads, 2)
ssm_scan_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ bt, const T* __restrict__ ct,
                      const float* __restrict__ a, const float* __restrict__ dskip,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ h_final, Strides2 sx, Strides2 sdt, Strides2 sb,
                      Strides2 sc, Strides2 sy, int S, int Di) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem + 2 * kStageFloats;         // [channel][n]: A
  auto xs = [&](int st) { return smem + st * kStageFloats; };  // [channel][kRow]
  auto dts = [&](int st) { return xs(st) + kScanChannels * kRow; };
  auto bs = [&](int st) { return dts(st) + kScanChannels * kRow; };  // [n][kRow]
  auto cs = [&](int st) { return bs(st) + kN * kRow; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kScanChannels;
  const int d = d0 + warp;
  const bool live = d < Di;
  const float d_skip = live ? dskip[d] : 0.f;
  const T* xb = x + b * sx.b;
  const T* dtb = dt + b * sdt.b;
  const T* bb = bt + b * sb.b;
  const T* cb = ct + b * sc.b;

  // the state entering the chunk, in every lane of the channel's warp
  float carry[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n)
    carry[n] = (live && h0 != nullptr) ? h0[((int64_t)b * Di + d) * kN + n] : 0.f;
  if (lane < kN) a_s[warp * kN + lane] = live ? a[d * kN + lane] : 0.f;

  // stage chunk t0's tiles into stage st: x and dt rows of the block's
  // channels, B_t and C_t rows of all N states, each element to its
  // transposed place. A thread copies rows r, r + kRowStep, ... of one
  // column, walking one source pointer down them.
  auto stage = [&](int t0, int st) {
    {
      constexpr int kRowStep = kScanThreads / kScanChannels;
      const int r = tid / kScanChannels, c = tid % kScanChannels;
      const bool c_ok = d0 + c < Di;
      float* xd = xs(st) + c * kRow + r;
      float* dd = dts(st) + c * kRow + r;
      const T* xp = xb + (int64_t)(t0 + r) * sx.s + d0 + c;
      const T* dp = dtb + (int64_t)(t0 + r) * sdt.s + d0 + c;
#pragma unroll 2
      for (int j = 0; j < kScanChunk / kRowStep; ++j) {
        const bool ok = c_ok && t0 + r + j * kRowStep < S;
        stage_one(xd + j * kRowStep, ok ? xp : xb, ok);
        stage_one(dd + j * kRowStep, ok ? dp : dtb, ok);
        xp += kRowStep * sx.s;
        dp += kRowStep * sdt.s;
      }
    }
    {
      constexpr int kRowStep = kScanThreads / kN;
      const int r = tid / kN, n = tid % kN;
      float* bd = bs(st) + n * kRow + r;
      float* cd = cs(st) + n * kRow + r;
      const T* bp = bb + (int64_t)(t0 + r) * sb.s + n;
      const T* cp = cb + (int64_t)(t0 + r) * sc.s + n;
#pragma unroll 2
      for (int j = 0; j < kScanChunk / kRowStep; ++j) {
        const bool ok = t0 + r + j * kRowStep < S;
        stage_one(bd + j * kRowStep, ok ? bp : bb, ok);
        stage_one(cd + j * kRowStep, ok ? cp : cb, ok);
        bp += kRowStep * sb.s;
        cp += kRowStep * sc.s;
      }
    }
    cp_async_commit();
  };

  const int n_chunks = (S + kScanChunk - 1) / kScanChunk;
  stage(0, 0);
  for (int k = 0; k < n_chunks; ++k) {
    const int st = k & 1, t0 = k * kScanChunk;
    if (k + 1 < n_chunks) {
      stage(t0 + kScanChunk, st ^ 1);
      cp_async_wait<1>();  // this thread's copies of chunk k have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... and everyone's; A is written

    // this lane's steps: t0 + 8 lane .. t0 + 8 lane + 7 of channel d
    float* xrow = xs(st) + warp * kRow + kItems * lane;
    const float* dtrow = dts(st) + warp * kRow + kItems * lane;
    float dtv[kItems], dtx[kItems], yv[kItems];
#pragma unroll
    for (int i = 0; i < kItems; i += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xrow + i);
      const float4 dv = *reinterpret_cast<const float4*>(dtrow + i);
      dtv[i] = dv.x, dtv[i + 1] = dv.y, dtv[i + 2] = dv.z, dtv[i + 3] = dv.w;
      dtx[i] = dv.x * xv.x, dtx[i + 1] = dv.y * xv.y;
      dtx[i + 2] = dv.z * xv.z, dtx[i + 3] = dv.w * xv.w;
      yv[i] = d_skip * xv.x, yv[i + 1] = d_skip * xv.y;
      yv[i + 2] = d_skip * xv.z, yv[i + 3] = d_skip * xv.w;
    }

#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float an = a_s[warp * kN + n];
      const float* brow = bs(st) + n * kRow + kItems * lane;
      const float* crow = cs(st) + n * kRow + kItems * lane;
      float bv[kItems], cv[kItems];
#pragma unroll
      for (int i = 0; i < kItems; i += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(brow + i);
        const float4 c4 = *reinterpret_cast<const float4*>(crow + i);
        bv[i] = b4.x, bv[i + 1] = b4.y, bv[i + 2] = b4.z, bv[i + 3] = b4.w;
        cv[i] = c4.x, cv[i + 1] = c4.y, cv[i + 2] = c4.z, cv[i + 3] = c4.w;
      }
      // the prefixes of this lane's maps: step i maps h_{i-1} to
      // pa[i] * h_before + pb[i]
      float pa[kItems], pb[kItems];
      pa[0] = expf(dtv[0] * an);
      pb[0] = dtx[0] * bv[0];
#pragma unroll
      for (int i = 1; i < kItems; ++i) {
        const float ai = expf(dtv[i] * an);
        pa[i] = ai * pa[i - 1];
        pb[i] = fmaf(ai, pb[i - 1], dtx[i] * bv[i]);
      }
      // inclusive scan of the lanes' composites, earlier lanes first
      float sa = pa[kItems - 1], sb = pb[kItems - 1];
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float ua = __shfl_up_sync(0xffffffffu, sa, off);
        const float ub = __shfl_up_sync(0xffffffffu, sb, off);
        if (lane >= off) {
          sb = fmaf(sa, ub, sb);
          sa *= ua;
        }
      }
      // the composite of the lanes before this one, applied to the carry
      float ea = __shfl_up_sync(0xffffffffu, sa, 1);
      float eb = __shfl_up_sync(0xffffffffu, sb, 1);
      if (lane == 0) ea = 1.f, eb = 0.f;
      const float h_before = fmaf(ea, carry[n], eb);
      float h = 0.f;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        h = fmaf(pa[i], h_before, pb[i]);
        yv[i] = fmaf(h, cv[i], yv[i]);
      }
      carry[n] = __shfl_sync(0xffffffffu, h, 31);  // the chunk's last state
    }

    // y through the x tile (this lane's own places), then coalesced rows
#pragma unroll
    for (int i = 0; i < kItems; i += 4)
      *reinterpret_cast<float4*>(xrow + i) = make_float4(yv[i], yv[i + 1], yv[i + 2], yv[i + 3]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScanChunk * kScanChannels / kScanThreads; ++j) {
      const int e = tid + j * kScanThreads, r = e / kScanChannels, c = e % kScanChannels;
      if (t0 + r < S && d0 + c < Di)
        store(y + b * sy.b + (int64_t)(t0 + r) * sy.s + d0 + c, xs(st)[c * kRow + r]);
    }
    __syncthreads();  // the stage is free for chunk k + 2
  }
  if (live && h_final != nullptr) {
    float hf = 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      if (lane == n) hf = carry[n];
    if (lane < kN) h_final[((int64_t)b * Di + d) * kN + lane] = hf;
  }
}

// ---------------------------------------------------------------------------
// the sequential body: a lane per (b, d, n), for short sequences
// ---------------------------------------------------------------------------

constexpr int kSeqMaxS = 16;             // longest sequence the sequential body takes
constexpr int kThreads = 128;
constexpr int kChannels = kThreads / kN;  // channels per block
constexpr int kChunk = 64;               // time steps staged per pass
constexpr int kXPer = kChunk * kChannels / kThreads;  // x (and dt, y) elements a thread moves
constexpr int kBPer = kChunk * kN / kThreads;         // B_t (and C_t) elements a thread moves

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_seq_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ bt, const T* __restrict__ ct,
                    const float* __restrict__ a, const float* __restrict__ dskip,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ h_final, Strides2 sx, Strides2 sdt, Strides2 sb,
                    Strides2 sc, Strides2 sy, int S, int Di) {
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
  const T *xp = static_cast<const T*>(x), *dtp = static_cast<const T*>(dt);
  const T *bp = static_cast<const T*>(bt), *cp = static_cast<const T*>(ct);
  T* yp = static_cast<T*>(y);
  if (S <= kSeqMaxS) {
    const dim3 grid((Di + kChannels - 1) / kChannels, B);
    ssm_scan_seq_kernel<T><<<grid, kThreads, 0, stream>>>(xp, dtp, bp, cp, a, dskip, h0, yp,
                                                           h_final, st[0], st[1], st[2], st[3],
                                                           st[4], S, Di);
    return cudaGetLastError();
  }
  static bool smem_set[64] = {};  // per device; one entry per instantiation
  int device = 0;
  cudaGetDevice(&device);
  if (device < 64 && !smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kScanSmemBytes);
    if (err != cudaSuccess) return err;
    smem_set[device] = true;
  }
  const dim3 grid((Di + kScanChannels - 1) / kScanChannels, B);
  ssm_scan_chunk_kernel<T><<<grid, kScanThreads, kScanSmemBytes, stream>>>(
      xp, dtp, bp, cp, a, dskip, h0, yp, h_final, st[0], st[1], st[2], st[3], st[4], S, Di);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes.
//
// ssm_scan_launch:
//   dtype: 0 = float32, 1 = bfloat16: x, dt, b_t, c_t and y share it; a,
//          d_skip, h0 and h_final are float32 and contiguous
//   n_state: N; 16 is instantiated (Hymba-1.5B and its reduced form)
//   strides: 10 int64 element strides, (b, s) for x, dt, b_t, c_t, y in that
//            order; the last axis must be contiguous
//   h0, h_final: [B, Di, N], either may be null (zeros in, nothing out)
// S <= ssm_scan_shape(0) runs the sequential body, longer sequences the
// chunked scan. Returns cudaGetLastError() after the launch (0 = launched).
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

// The scan's shape: which = 0 gives the longest S the sequential body
// takes, 1 the chunk of the scan body, 2 the steps a lane owns.
extern "C" int ssm_scan_shape(int which) {
  return which == 0 ? kSeqMaxS : which == 1 ? kScanChunk : kItems;
}

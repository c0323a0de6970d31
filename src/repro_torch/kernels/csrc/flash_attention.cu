// Causal / sliding-window flash attention on Hopper (sm_90a): kernel K6 of
// the port.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention_bhsd (body _flash_kernel): q [B, S, H, hd] against k, v
// [B, T, K, hd], query row i at position i and key j at position j; key j is
// visible to row i when
//   (!causal || j <= i) && (window <= 0 || j > i - window || j < prefix_len),
// scores scaled by `scale`, masked at -1e30, an fp32 online softmax, and the
// output divided by max(l, 1e-30), in q's dtype. Beyond the TPU kernel:
//   * GQA in place: query head h reads KV head h / (H / K); the TPU wrapper
//     (repro.kernels.ops.flash_attention) materialized the repeated K/V.
//   * prefix_len: the leading prefix_len keys stay visible outside the
//     window (Hymba's meta tokens; the mask of repro.models.layers.
//     self_attention and repro.models.attention.chunked_attend). 0 is the
//     TPU kernel's function.
//   * No padding: the key loop ends at T and the last query block is
//     ragged, so the wrapper pads nothing.
//
// What bounds it on this card: at Hymba-1.5B's prefill (B 1, H 25, K 5,
// hd 64, S = T = 2048 with 128 meta tokens, window 1024) one launch does
// 4 * hd * 25 * (1.70 M visible (q, k) pairs per head) = 10.9 GFLOP against
// about 15.7 MB of bf16 q, k, v and output: bound by operations.
//
// What the design does about that, kept simple before it is made fast:
//   * bf16 runs K1's tensor-core body (attention_tiles.cuh): a block of 4
//     warps owns 64 query rows, walks the key tiles of 64 rows staged with
//     cp.async into two shared-memory stages, keeps the online-softmax
//     state and the output in registers, and feeds P to P V as two bf16
//     terms, so P keeps about 16 bits as the reference's fp32 p @ v.
//   * fp32 runs K1's CUDA-core FMA body (one thread a query row), which
//     holds the reference to 5e-5.
//   * Key tiles the mask hides from every row of the block are not visited:
//     tiles past the block's last row (causal), and tiles wholly before the
//     first row's window that hold no prefix key. A block visits the prefix
//     tiles, then the window's tiles up to its diagonal; inside a tile each
//     score is masked per element. This computes the same function.
//   * Causal blocks differ in work (a late block visits more tiles), so the
//     grid hands out the last query blocks first.
// Neither body uses wgmma or TMA yet. The kernels allocate nothing and run
// on the caller's stream.

#include "attention_tiles.cuh"

namespace {

struct MaskArgs {
  int T, causal, window, prefix;
};

__device__ __forceinline__ bool visible(const MaskArgs& m, int i, int j) {
  return j < m.T && (!m.causal || j <= i) &&
         (m.window <= 0 || j > i - m.window || j < m.prefix);
}

// The key tiles (of bk rows) that query rows [q0, q1) can see: the tiles
// holding prefix keys, then the window's tiles up to the diagonal. Tile i
// of the walk is i for i < n_prefix, else first + (i - n_prefix).
struct TileWalk {
  int n_prefix, first, n;
  __device__ __forceinline__ int tile(int i) const { return i < n_prefix ? i : first + i - n_prefix; }
};

__device__ __forceinline__ TileWalk tile_walk(const MaskArgs& m, int q0, int q1, int bk) {
  const int nt = (m.T + bk - 1) / bk;
  const int end = m.causal ? min(nt, (q1 - 1) / bk + 1) : nt;
  if (m.window <= 0) return {0, 0, end};
  const int n_prefix = min((m.prefix + bk - 1) / bk, end);
  const int first = max(max(0, q0 - m.window + 1) / bk, n_prefix);
  return {n_prefix, first, n_prefix + max(0, end - first)};
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           Strides sq, Strides sk, Strides sv, Strides so, int H, int group,
                           int S, MaskArgs mask, float scale_log2) {
  static_assert(HD % 16 == 0, "the tensor-core body takes head dims that are multiples of 16");
  constexpr int SROW = HD + 8;        // +16 bytes: conflict-free ldmatrix
  constexpr int KSTEPS = HD / 16;     // mma k-steps over hd
  constexpr int DTILES = HD / 8;      // 8-wide output tiles over hd
  constexpr int NTILES = kMmaBK / 8;  // 8-wide score tiles over a key tile
  static_assert(kMmaBQ == kMmaBK, "Q is staged in a K/V tile buffer");
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kMmaBK * SROW];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kMmaBK * SROW];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;  // the longest walks first
  const TileWalk walk = tile_walk(mask, q0, min(q0 + kMmaBQ, S), kMmaBK);
  const __nv_bfloat16* kb = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kvh * sv.h;

  auto stage_kv = [&](int k0, int st) {
    stage_rows<HD, SROW>(k_s[st], kMmaBK, q, [&](int r) -> const __nv_bfloat16* {
      return k0 + r < mask.T ? kb + (int64_t)(k0 + r) * sk.s : nullptr;
    });
    stage_rows<HD, SROW>(v_s[st], kMmaBK, q, [&](int r) -> const __nv_bfloat16* {
      return k0 + r < mask.T ? vb + (int64_t)(k0 + r) * sv.s : nullptr;
    });
  };

  stage_kv(walk.tile(0) * kMmaBK, 0);
  stage_rows<HD, SROW>(k_s[1], kMmaBQ, q, [&](int r) -> const __nv_bfloat16* {
    const int row = q0 + r;
    return row < S ? q + b * sq.b + (int64_t)row * sq.s + h * sq.h : nullptr;
  });
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[KSTEPS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qa[kk], k_s[1] + (warp * 16 + lane % 16) * SROW + kk * 16 + (lane / 16) * 8);

  float o[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_lo = kMaskedScore, m_hi = kMaskedScore;  // rows lane/4 and lane/4 + 8
  float l_lo = 0.f, l_hi = 0.f;                    // this thread's partial sums
  const int mat = lane / 8, mrow = lane % 8;       // ldmatrix.x4 addressing
  const int row_lo = q0 + warp * 16 + lane / 4;
  const int row_hi = row_lo + 8;

  for (int i = 0, st = 0; i < walk.n; ++i, st ^= 1) {
    const int k0 = walk.tile(i) * kMmaBK;
    if (i > 0) cp_async_wait_all();  // this tile has landed
    // ... and is visible to all warps, which are done with the other stage
    __syncthreads();
    if (i + 1 < walk.n) {
      stage_kv(walk.tile(i + 1) * kMmaBK, st ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* kt = k_s[st];
    const __nv_bfloat16* vt = v_s[st];

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NTILES][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < NTILES; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (8 * (j + mat / 2) + mrow) * SROW + kk * 16 + 8 * (mat % 2));
        mma_16816(s[j], qa[kk], kf[0], kf[1]);
        mma_16816(s[j + 1], qa[kk], kf[2], kf[3]);
      }
    }

    // mask, then the online softmax (log2 domain); a row's 64 scores live
    // in one lane quad
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * (lane % 4) + e;
        s[j][e] = visible(mask, row_lo, key) ? s[j][e] * scale_log2 : kMaskedScore;
        s[j][2 + e] = visible(mask, row_hi, key) ? s[j][2 + e] * scale_log2 : kMaskedScore;
        mx_lo = fmaxf(mx_lo, s[j][e]);
        mx_hi = fmaxf(mx_hi, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float alpha_lo = exp2f(m_lo - mx_lo), alpha_hi = exp2f(m_hi - mx_hi);
    l_lo *= alpha_lo;
    l_hi *= alpha_hi;
#pragma unroll
    for (int d = 0; d < DTILES; ++d) {
      o[d][0] *= alpha_lo;
      o[d][1] *= alpha_lo;
      o[d][2] *= alpha_hi;
      o[d][3] *= alpha_hi;
    }
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - mx_lo);
        s[j][2 + e] = exp2f(s[j][2 + e] - mx_hi);
        l_lo += s[j][e];
        l_hi += s[j][2 + e];
      }
    }
    m_lo = mx_lo;
    m_hi = mx_hi;

    // O += P V, P as two bf16 terms (its rounding and the remainder)
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t pa[4], pr[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], pa[0], pr[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], pa[1], pr[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pr[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pr[3]);
#pragma unroll
      for (int d = 0; d < DTILES; d += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (16 * kk + 8 * (mat % 2) + mrow) * SROW + 8 * (d + mat / 2));
        mma_16816(o[d], pa, vf[0], vf[1]);
        mma_16816(o[d + 1], pa, vf[2], vf[3]);
        mma_16816(o[d], pr, vf[0], vf[1]);
        mma_16816(o[d + 1], pr, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int d = 0; d < DTILES; ++d) {
    const int col = 8 * d + 2 * (lane % 4);
    if (row_lo < S)
      *reinterpret_cast<uint32_t*>(out + b * so.b + (int64_t)row_lo * so.s + h * so.h + col) =
          pack_bf16(o[d][0] * inv_lo, o[d][1] * inv_lo);
    if (row_hi < S)
      *reinterpret_cast<uint32_t*>(out + b * so.b + (int64_t)row_hi * so.s + h * so.h + col) =
          pack_bf16(o[d][2] * inv_hi, o[d][3] * inv_hi);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int kFmaBQ = 64;  // query rows per block (= threads per block)
constexpr int kFmaBK = 32;  // key rows per shared-memory tile

template <int HD>
__global__ void __launch_bounds__(kFmaBQ)
flash_attention_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, Strides sq,
                           Strides sk, Strides sv, Strides so, int H, int group, int S,
                           MaskArgs mask, float scale_log2) {
  static_assert(HD % 4 == 0, "head dim must be a multiple of 4 for 16-byte shared loads");
  __shared__ __align__(16) float k_tile[kFmaBK][HD];
  __shared__ __align__(16) float v_tile[kFmaBK][HD];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFmaBQ;  // the longest walks first
  const int row = q0 + threadIdx.x;
  const bool valid = row < S;
  const TileWalk walk = tile_walk(mask, q0, min(q0 + kFmaBQ, S), kFmaBK);
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  float qr[HD];
  float acc[HD];
  const float* qp = q + b * sq.b + (int64_t)(valid ? row : 0) * sq.s + h * sq.h;
#pragma unroll
  for (int d = 0; d < HD; ++d) qr[d] = valid ? qp[d] * scale_log2 : 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = kMaskedScore;  // running max (log2 domain)
  float l = 0.f;           // running sum of exp2(score - m)

  for (int i = 0; i < walk.n; ++i) {
    const int k0 = walk.tile(i) * kFmaBK;
    __syncthreads();  // the previous tile is no longer read
#pragma unroll 4
    for (int e = threadIdx.x; e < kFmaBK * HD; e += kFmaBQ) {
      const int j = e / HD;
      const int d = e - j * HD;
      const int t = k0 + j;
      k_tile[j][d] = t < mask.T ? kb[(int64_t)t * sk.s + d] : 0.f;
      v_tile[j][d] = t < mask.T ? vb[(int64_t)t * sv.s + d] : 0.f;
    }
    __syncthreads();

    float s[kFmaBK];
#pragma unroll
    for (int j = 0; j < kFmaBK; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
#pragma unroll
      for (int j = 0; j < kFmaBK; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_tile[j][d]);
        s[j] = fmaf(qr[d], kk.x, s[j]);
        s[j] = fmaf(qr[d + 1], kk.y, s[j]);
        s[j] = fmaf(qr[d + 2], kk.z, s[j]);
        s[j] = fmaf(qr[d + 3], kk.w, s[j]);
      }
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kFmaBK; ++j) {
      if (!visible(mask, row, k0 + j)) s[j] = kMaskedScore;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kFmaBK; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (valid) {
    float* op = out + b * so.b + (int64_t)row * so.s + h * so.h;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = acc[d] * inv;
  }
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out,
                   const Strides* st, int B, int H, int group, int S, MaskArgs mask,
                   float scale_log2, cudaStream_t stream) {
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    const dim3 grid((S + kMmaBQ - 1) / kMmaBQ, B * H);
    flash_attention_mma_kernel<HD><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<bf*>(out), st[0], st[1], st[2], st[3], H, group, S, mask, scale_log2);
  } else {
    const dim3 grid((S + kFmaBQ - 1) / kFmaBQ, B * H);
    flash_attention_fma_kernel<HD><<<grid, kFmaBQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), st[0], st[1], st[2], st[3], H,
        group, S, mask, scale_log2);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (tensor-core body);
//          q, k, v and out share it. The bf16 body reads 16-byte row chunks:
//          pointers 16-byte aligned, strides multiples of 8 elements.
//   hd: the head dim; 64 is instantiated (Hymba-1.5B and its reduced form)
//   strides: 12 int64 element strides, (b, s, h) for q, k, v, out in that
//            order; hd must be contiguous
//   q and out [B, S, H, hd]; k and v [B, T, K, hd] with K | H
//   causal, window, prefix_len: the mask (window 0 = no window)
//   scale: the softmax scale (hd ** -0.5)
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(int dtype, int hd, const void* q, const void* k,
                                      const void* v, void* out, const int64_t* strides, int B,
                                      int H, int K, int S, int T, int causal, int window,
                                      int prefix_len, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || K <= 0 || H % K != 0 || S <= 0 || T <= 0)
    return cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const MaskArgs mask{T, causal, window, prefix_len};
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(dtype, q, k, v, out, st, B, H, H / K, S, mask, scale_log2, s);
    default: return cudaErrorInvalidValue;
  }
}

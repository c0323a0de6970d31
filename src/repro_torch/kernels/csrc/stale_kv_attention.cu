// Stale-KV patch attention on Hopper (sm_90a): kernels K1, K2, K4 and K5 of
// the port, one body with four entry points.
//
// Replaces the TPU kernels of src/repro/kernels/stale_kv_attention.py:
//   K1 stale_kv_attention_bhsd (body _stale_kernel, update
//      _online_softmax_update): bidirectional attention of a local patch's
//      queries over the whole-image context, where key t comes from the
//      fresh local K/V when 0 <= t - tok_start < Nl and from the stale
//      full-image buffer otherwise; online softmax in fp32, output in the
//      input dtype.
//   K2 stale_kv_attention_padded_bhsd (body _padded_kernel): the multi-rank
//      form. The slab has Nl_max rows of which the first valid_tokens are
//      real; key t is fresh when 0 <= t - tok_start < valid_tokens, stale
//      otherwise, and keys t >= n_tokens (the buffer's scratch tail) are
//      masked. Query rows >= valid_tokens are scratch: computed, and dropped
//      by the caller. tok_start and valid_tokens are launch arguments, so
//      one build serves every rank's layout (the TPU form carried them as
//      scalar prefetch).
//   K5 stale_kv_attention_guided_bhsd (body _guided_kernel): K2 with a
//      leading guidance-branch axis of 2, folded into the batch; branch 1
//      (unconditional) is fresh over valid_tokens * uncond_fresh rows.
//   K4 lse_attention_bhsd (body _lse_kernel): attention over ONE ring
//      segment of the sequence-parallel executor, whose first valid_len keys
//      are real. Every key row comes from one source (no fresh rows), the
//      key loop ends at the run-time valid_len, and the epilogue also
//      writes the fp32 log-sum-exp, lse = m + log(l), that the ring's
//      cross-hop merge weighs the normalized partial output by. An empty
//      segment (valid_len = 0) writes out = 0 and lse = -1e30 (the finite
//      masked sentinel, so the merge's exp(lse - M) is exactly 0 and no
//      -inf - -inf NaN can arise); the TPU kernel's out there is the mean of
//      V, which the merge also weighs by 0.
// The body takes the count N of keys it visits (K1: the context length;
// K2, K5: n_tokens, so the scratch keys are never visited, which masks them
// exactly; K4: valid_len), a fresh-row count per batch row (valid_lo for
// batch rows below b_split, valid_hi from there on; 0 for K4) and an
// optional fp32 LSE output (K4 only).
//
// What bounds it on this card: at the main-path shapes of sdxl-dit (B=1,
// H=16, hd=72, N=4096, Nl=2304) one launch does 4*H*Nl*N*hd = 43.5 GFLOP
// against about 30 MB of bf16 inputs and output, so it is bound by
// operations, not by bytes (about 1400 operations per byte). K4 at the
// spmd_seq path's hops (8 heads, 4608 query rows, valid_len 3200 or 896)
// does 34 or 9.5 GFLOP against about 18 or 12 MB: operations again.
//
// What the design does about that, kept simple before it is made fast:
//   * bf16 (the main path's dtype) runs both products on the tensor cores
//     with mma.sync m16n8k16 (bf16 in, fp32 accumulate), FlashAttention-2
//     style: a block of 4 warps owns 64 query rows (16 per warp, its Q
//     fragments in registers), walks the keys in tiles of 64 staged in
//     shared memory, and keeps the softmax state and the output accumulator
//     in registers. hd is zero-padded to a multiple of 16 (72 -> 80) in
//     shared memory only; the padded lanes contribute exact zeros.
//     Q K^T is exact products of bf16 inputs summed in fp32. The
//     probabilities P are fp32; mma.sync takes bf16, so P V runs as two
//     products, bf16(P) V + bf16(P - bf16(P)) V, which carries P to about 16
//     mantissa bits (the reference keeps p @ v in fp32). That costs half as
//     many tensor-core operations again as one bf16 P V; the one rounding
//     to bf16 left is that of the output.
//   * fp32 runs every product as fp32 FMA on the CUDA cores, so it holds the
//     reference to 5e-5 (tensor-core TF32 would not): one thread owns one
//     query row, its scaled q row and accumulator in registers.
//   * The loop over key tiles inside the block replaces the TPU grid's
//     sequential key axis and its VMEM scratch.
//   * The fresh/stale choice is made per key row, on the source POINTER,
//     while the tile is staged: the stale row that the fresh patch covers is
//     never read, and any tok_start is correct (no tile alignment needed).
//   * Scores are kept in the log2 domain so the exponentials are exp2f.
//   * The bf16 body stages tiles with cp.async into two shared-memory
//     stages, so the next key tile is in flight while this one is read.
// Neither body uses wgmma or TMA yet.
// The kernels allocate nothing and run on the caller's stream.

#include "attention_tiles.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// Natural-log LSE of a row from its running max m (log2 domain) and sum l
// of exp2(score - m); an empty row (no key visited, l == 0) gets the
// masked sentinel.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m * kLn2 + logf(l) : kMaskedScore;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16; the tiles of attention_tiles.cuh)
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
stale_kv_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k_fresh,
                              const __nv_bfloat16* __restrict__ v_fresh,
                              const __nv_bfloat16* __restrict__ k_stale,
                              const __nv_bfloat16* __restrict__ v_stale,
                              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                              Strides sq, Strides skf, Strides svf, Strides sks, Strides svs,
                              Strides so, Strides sl, int H, int Nl, int N, int tok_start,
                              int valid_lo, int valid_hi, int b_split, float scale_log2) {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8 (16-byte rows)");
  constexpr int HDP = (HD + 15) / 16 * 16;  // padded to the mma depth
  constexpr int SROW = HDP + 8;             // +16 bytes: conflict-free ldmatrix
  constexpr int KSTEPS = HDP / 16;          // mma k-steps over hd
  constexpr int DTILES = HDP / 8;           // 8-wide output tiles over hd
  constexpr int NTILES = kMmaBK / 8;        // 8-wide score tiles over a key tile
  static_assert(kMmaBQ == kMmaBK, "Q is staged in a K/V tile buffer");
  // two stages of K/V tiles: tile t+1 is in flight while tile t is read
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kMmaBK * SROW];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kMmaBK * SROW];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int q0 = blockIdx.x * kMmaBQ;
  const int valid = b < b_split ? valid_lo : valid_hi;  // fresh rows of this batch row

  // key row t of the context: fresh if the patch's valid rows cover it,
  // else stale; keys t >= N are never staged
  auto stage_kv = [&](int k0, int st) {
    stage_rows<HD, SROW>(k_s[st], kMmaBK, q, [&](int r) -> const __nv_bfloat16* {
      const int t = k0 + r;
      if (t >= N) return nullptr;
      const int tl = t - tok_start;
      return (tl >= 0 && tl < valid) ? k_fresh + b * skf.b + (int64_t)tl * skf.s + h * skf.h
                                     : k_stale + b * sks.b + (int64_t)t * sks.s + h * sks.h;
    });
    stage_rows<HD, SROW>(v_s[st], kMmaBK, q, [&](int r) -> const __nv_bfloat16* {
      const int t = k0 + r;
      if (t >= N) return nullptr;
      const int tl = t - tok_start;
      return (tl >= 0 && tl < valid) ? v_fresh + b * svf.b + (int64_t)tl * svf.s + h * svf.h
                                     : v_stale + b * svs.b + (int64_t)t * svs.s + h * svs.h;
    });
  };

  stage_kv(0, 0);
  stage_rows<HD, SROW>(k_s[1], kMmaBQ, q, [&](int r) -> const __nv_bfloat16* {
    const int row = q0 + r;
    return row < Nl ? q + b * sq.b + (int64_t)row * sq.s + h * sq.h : nullptr;
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

  for (int k0 = 0, st = 0; k0 < N; k0 += kMmaBK, st ^= 1) {
    if (k0 > 0) cp_async_wait_all();  // this tile has landed
    // ... and is visible to all warps, which are done with the other stage
    __syncthreads();
    if (k0 + kMmaBK < N) {
      stage_kv(k0 + kMmaBK, st ^ 1);
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
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (8 * (j + mat / 2) + mrow) * SROW + kk * 16 + 8 * (mat % 2));
        mma_16816(s[j], qa[kk], kb[0], kb[1]);
        mma_16816(s[j + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // online softmax (log2 domain); a row's 64 scores live in one lane quad
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + 8 * j + 2 * (lane % 4) + e < N;
        s[j][e] = valid ? s[j][e] * scale_log2 : kMaskedScore;
        s[j][2 + e] = valid ? s[j][2 + e] * scale_log2 : kMaskedScore;
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

    // O += P V: the score accumulators of two adjacent key tiles are exactly
    // the A fragment of one 16-key k-step. P is fed as two bf16 terms (its
    // rounding and the remainder), so P V keeps P to about 16 bits, as the
    // reference's fp32 p @ v does, instead of bf16's 8.
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t pa[4], pr[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], pa[0], pr[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], pa[1], pr[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pr[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pr[3]);
#pragma unroll
      for (int d = 0; d < DTILES; d += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (16 * kk + 8 * (mat % 2) + mrow) * SROW + 8 * (d + mat / 2));
        mma_16816(o[d], pa, vb[0], vb[1]);
        mma_16816(o[d + 1], pa, vb[2], vb[3]);
        mma_16816(o[d], pr, vb[0], vb[1]);
        mma_16816(o[d + 1], pr, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const int row_lo = q0 + warp * 16 + lane / 4;
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int d = 0; d < DTILES; ++d) {
    const int col = 8 * d + 2 * (lane % 4);
    if (col >= HD) continue;
    if (row_lo < Nl)
      *reinterpret_cast<uint32_t*>(out + b * so.b + (int64_t)row_lo * so.s + h * so.h + col) =
          pack_bf16(o[d][0] * inv_lo, o[d][1] * inv_lo);
    if (row_hi < Nl)
      *reinterpret_cast<uint32_t*>(out + b * so.b + (int64_t)row_hi * so.s + h * so.h + col) =
          pack_bf16(o[d][2] * inv_hi, o[d][3] * inv_hi);
  }
  if (lse != nullptr && lane % 4 == 0) {  // one lane of the quad owns the row
    if (row_lo < Nl) lse[b * sl.b + (int64_t)row_lo * sl.s + h * sl.h] = row_lse(m_lo, l_lo);
    if (row_hi < Nl) lse[b * sl.b + (int64_t)row_hi * sl.s + h * sl.h] = row_lse(m_hi, l_hi);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int kFmaBQ = 64;  // query rows per block (= threads per block)
constexpr int kFmaBK = 32;  // key rows per shared-memory tile

template <int HD>
__global__ void __launch_bounds__(kFmaBQ)
stale_kv_attention_fma_kernel(const float* __restrict__ q, const float* __restrict__ k_fresh,
                              const float* __restrict__ v_fresh,
                              const float* __restrict__ k_stale,
                              const float* __restrict__ v_stale, float* __restrict__ out,
                              float* __restrict__ lse, Strides sq, Strides skf, Strides svf,
                              Strides sks, Strides svs, Strides so, Strides sl, int H, int Nl,
                              int N, int tok_start, int valid_lo, int valid_hi, int b_split,
                              float scale_log2) {
  static_assert(HD % 4 == 0, "head dim must be a multiple of 4 for 16-byte shared loads");
  __shared__ __align__(16) float k_tile[kFmaBK][HD];
  __shared__ __align__(16) float v_tile[kFmaBK][HD];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int row = blockIdx.x * kFmaBQ + threadIdx.x;
  const bool valid = row < Nl;
  const int fresh_rows = b < b_split ? valid_lo : valid_hi;

  float qr[HD];
  float acc[HD];
  const float* qp = q + b * sq.b + (int64_t)(valid ? row : 0) * sq.s + h * sq.h;
#pragma unroll
  for (int d = 0; d < HD; ++d) qr[d] = valid ? qp[d] * scale_log2 : 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = kMaskedScore;  // running max (log2 domain)
  float l = 0.f;           // running sum of exp2(score - m)

  for (int k0 = 0; k0 < N; k0 += kFmaBK) {
    __syncthreads();  // the previous tile is no longer read
#pragma unroll 4
    for (int i = threadIdx.x; i < kFmaBK * HD; i += kFmaBQ) {
      const int j = i / HD;
      const int d = i - j * HD;
      const int t = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < N) {
        const int tl = t - tok_start;
        if (tl >= 0 && tl < fresh_rows) {
          kx = k_fresh[b * skf.b + (int64_t)tl * skf.s + h * skf.h + d];
          vx = v_fresh[b * svf.b + (int64_t)tl * svf.s + h * svf.h + d];
        } else {
          kx = k_stale[b * sks.b + (int64_t)t * sks.s + h * sks.h + d];
          vx = v_stale[b * svs.b + (int64_t)t * svs.s + h * svs.h + d];
        }
      }
      k_tile[j][d] = kx;
      v_tile[j][d] = vx;
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
      if (k0 + j >= N) s[j] = kMaskedScore;  // ragged last tile
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
    if (lse != nullptr) lse[b * sl.b + (int64_t)row * sl.s + h * sl.h] = row_lse(m, l);
  }
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* kf, const void* vf, const void* ks,
                   const void* vs, void* out, float* lse, const Strides* st, int B, int H,
                   int Nl, int N, int tok_start, int valid_lo, int valid_hi, int b_split,
                   float scale_log2, cudaStream_t stream) {
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    const dim3 grid((Nl + kMmaBQ - 1) / kMmaBQ, B * H);
    stale_kv_attention_mma_kernel<HD><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(kf), static_cast<const bf*>(vf),
        static_cast<const bf*>(ks), static_cast<const bf*>(vs), static_cast<bf*>(out), lse,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], H, Nl, N, tok_start, valid_lo,
        valid_hi, b_split, scale_log2);
  } else {
    const dim3 grid((Nl + kFmaBQ - 1) / kFmaBQ, B * H);
    stale_kv_attention_fma_kernel<HD><<<grid, kFmaBQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(kf),
        static_cast<const float*>(vf), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<float*>(out), lse, st[0], st[1], st[2],
        st[3], st[4], st[5], st[6], H, Nl, N, tok_start, valid_lo, valid_hi, b_split,
        scale_log2);
  }
  return cudaGetLastError();
}

// Dispatch on the dtype and the head dim. st: the (b, s, h) strides of q,
// k_fresh, v_fresh, k_stale, v_stale, out and lse (unused without lse).
int dispatch(int dtype, int hd, const void* q, const void* kf, const void* vf, const void* ks,
             const void* vs, void* out, float* lse, const Strides* st, int B, int H, int Nl,
             int N, int tok_start, int valid_lo, int valid_hi, int b_split, float scale,
             void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(dtype, q, kf, vf, ks, vs, out, lse, st, B, H, Nl, N, tok_start, valid_lo, valid_hi, b_split, scale_log2, s);
    case 72: return launch<72>(dtype, q, kf, vf, ks, vs, out, lse, st, B, H, Nl, N, tok_start, valid_lo, valid_hi, b_split, scale_log2, s);
    default: return cudaErrorInvalidValue;
  }
}

// The strides of K1, K2 and K5's six tensors, 18 int64 in (b, s, h) order;
// the seventh (lse) slot is unused.
int dispatch6(int dtype, int hd, const void* q, const void* kf, const void* vf, const void* ks,
              const void* vs, void* out, const int64_t* strides, int B, int H, int Nl, int N,
              int tok_start, int valid_lo, int valid_hi, int b_split, float scale,
              void* stream) {
  Strides st[7] = {};
  for (int i = 0; i < 6; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return dispatch(dtype, hd, q, kf, vf, ks, vs, out, nullptr, st, B, H, Nl, N, tok_start,
                  valid_lo, valid_hi, b_split, scale, stream);
}

}  // namespace

// Plain C entry points, bound with ctypes. Common arguments:
//   dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (tensor-core body);
//          all six tensors share it. The bf16 body reads 16-byte row chunks:
//          pointers 16-byte aligned, strides multiples of 8 elements.
//   strides: 18 int64 element strides, (b, s, h) for q, k_fresh, v_fresh,
//            k_stale, v_stale, out in that order; hd must be contiguous
//   Nl: query rows (and rows of the fresh K/V)
//   scale: the softmax scale (hd ** -0.5 for the DiT)
// Each returns cudaGetLastError() after the launch (0 = launched).

// K1: N context keys; the Nl fresh rows sit at tok_start.
extern "C" int stale_kv_attention_launch(int dtype, int hd, const void* q, const void* k_fresh,
                                         const void* v_fresh, const void* k_stale,
                                         const void* v_stale, void* out, const int64_t* strides,
                                         int B, int H, int Nl, int N, int tok_start, float scale,
                                         void* stream) {
  return dispatch6(dtype, hd, q, k_fresh, v_fresh, k_stale, v_stale, out, strides, B, H, Nl, N,
                   tok_start, Nl, Nl, B, scale, stream);
}

// K2: the slab's first valid_tokens rows are fresh at tok_start; the stale
// buffer's keys from n_tokens on are scratch and masked.
extern "C" int stale_kv_attention_padded_launch(int dtype, int hd, const void* q,
                                                const void* k_fresh, const void* v_fresh,
                                                const void* k_stale, const void* v_stale,
                                                void* out, const int64_t* strides, int B, int H,
                                                int Nl, int n_tokens, int tok_start,
                                                int valid_tokens, float scale, void* stream) {
  return dispatch6(dtype, hd, q, k_fresh, v_fresh, k_stale, v_stale, out, strides, B, H, Nl,
                   n_tokens, tok_start, valid_tokens, valid_tokens, B, scale, stream);
}

// K5: 2 * B batch rows, the conditional branch (rows < B) then the
// unconditional one, whose fresh rows are valid_tokens * uncond_fresh.
extern "C" int stale_kv_attention_guided_launch(int dtype, int hd, const void* q,
                                                const void* k_fresh, const void* v_fresh,
                                                const void* k_stale, const void* v_stale,
                                                void* out, const int64_t* strides, int B, int H,
                                                int Nl, int n_tokens, int tok_start,
                                                int valid_tokens, int uncond_fresh, float scale,
                                                void* stream) {
  return dispatch6(dtype, hd, q, k_fresh, v_fresh, k_stale, v_stale, out, strides, 2 * B, H, Nl,
                   n_tokens, tok_start, valid_tokens, uncond_fresh ? valid_tokens : 0, B, scale,
                   stream);
}

// K4: q and out [B, Sq, H, hd], k and v [B, T, H, hd] with their first
// valid_len keys real (the key loop ends there), lse [B, Sq, H] fp32.
// strides: 15 int64, (b, s, h) for q, k, v, out, lse in that order. Every
// key comes from k/v (no fresh rows), so they fill both source slots.
extern "C" int lse_attention_launch(int dtype, int hd, const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    const int64_t* strides, int B, int H, int Sq, int valid_len,
                                    float scale, void* stream) {
  const int order[7] = {0, 1, 2, 1, 2, 3, 4};  // q, kf, vf, ks, vs, out, lse
  Strides st[7];
  for (int i = 0; i < 7; ++i)
    st[i] = {strides[3 * order[i]], strides[3 * order[i] + 1], strides[3 * order[i] + 2]};
  return dispatch(dtype, hd, q, k, v, k, v, out, lse, st, B, H, Sq, valid_len, 0, 0, 0, B,
                  scale, stream);
}

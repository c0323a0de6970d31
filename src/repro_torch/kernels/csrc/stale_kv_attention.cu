// Stale-KV patch attention on Hopper (sm_90a): kernels K1, K2, K4 and K5 of
// the port, one body per dtype with four entry points.
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
//
// What bounds it on this card: at the main-path shapes of sdxl-dit (B=1,
// H=16, hd=72, N=4096, Nl=2304) one launch does 4*H*Nl*N*hd = 43.5 GFLOP
// against about 30 MB of bf16 inputs and output, so it is bound by
// operations, not by bytes (about 1400 operations per byte). K4 at the
// spmd_seq path's hops (8 heads, 4608 query rows, valid_len 3200 or 896)
// does 34 or 9.5 GFLOP against about 18 or 12 MB: operations again.
//
// The bf16 body (the main path's dtype) is built for Hopper's tensor path:
//   * Key runs, not key rows. Attention without a causal mask does not
//     depend on the order of its keys, so the keys a block visits are at
//     most three runs, each read from ONE source: stale [0, tok_start),
//     fresh [0, valid), stale [tok_start + valid, N) (K4: one stale run
//     [0, valid_len)). The host computes the runs (key_runs in
//     stale_kv_attention.py) and passes them per batch-row class (K5's two
//     branches differ). Each run is walked in 128-key tiles; a run that
//     starts at key 0 is tiled back from its end, every other run forward
//     from its start, so the ragged part of a run's partial tile always
//     lies outside its source's extent (a negative row, or a row >= the
//     map's N): TMA fills it with zeros, the stale rows under the fresh
//     patch are never read, and any tok_start is correct. Keys outside the
//     run are masked by key index (RunWalk, the walk this source gives the
//     pipeline).
//   * The pipeline is attention_block in hopper_tiles.cuh, which K6 runs
//     with its own walk. TMA and mbarriers: warpgroup 0 is the producer: one thread keeps a
//     ring of kStages K/V stages full with 4-D TMA loads (tensor maps over
//     the callers' strided [B, S, H, hd] views, built on the host with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so
//     the library needs no -lcuda, passed as __grid_constant__). Each
//     stage has a full barrier (the producer's expect_tx arrival plus the
//     bytes) and an empty barrier (one arrival per consumer warp).
//     setmaxnreg gives the producer 40 registers and each consumer 232.
//   * wgmma. Warpgroups 1 and 2 each own 64 query rows of the block's 128
//     (the Q tile stays in shared memory). S = Q K^T runs as
//     wgmma.m64n128k16 over the 128-key tile with both operands K-major in
//     shared memory; P V takes P from registers (the S accumulator's
//     layout is the A fragment's, so no shuffle) and V from shared memory
//     as an MN-major B operand. Each K/V tile is read once per warpgroup,
//     not once per warp as mma.sync's ldmatrix did.
//   * Turns. The two consumer warpgroups take turns on the tensor cores
//     (named barriers): a turn is P V of tile t - 1 then Q K^T of tile t,
//     and while one warpgroup's turn runs the other computes its softmax.
//     Run in lockstep, the two computed their softmax at the same time and
//     left the tensor cores idle for it (0.25 against 0.20 ms at K1's main
//     shape, PERF.md section 6). P V completes before Q K^T is issued, so the
//     P fragments and the scores are never live at once: issuing both
//     together (FlashAttention-3's overlap inside a warpgroup) ran out of
//     registers and ptxas serialized the wgmmas.
//   * hd 72 on Hopper's tiles. wgmma's depth is 16 bf16, so Q K^T pads hd to
//     80, and TMA's 128-byte swizzle takes at most 64 bf16 a row. A tile is
//     therefore two boxes: columns 0-63 under the 128-byte swizzle and
//     columns 64-79 under the 32-byte swizzle, whose map has an inner
//     extent of 72, so TMA zero-fills columns 72-79: they add exact zeros
//     to Q K^T, and P V's outputs there are never stored. The other choice,
//     no swizzle with hd split into 9 chunks of 8 by a 5-D map, would
//     give up the swizzles that keep TMA's writes and wgmma's reads of a
//     tile free of bank conflicts. P V runs as an n64 and an n16 product.
//     hd 32 is one box under the 64-byte swizzle.
//   * A grid of 128-row blocks, one an SM (144 KB of shared memory with 3
//     stages, 384 threads). PERF.md section 6 has the wave arithmetic at
//     the path shapes; 64-row blocks would read every K/V tile from L2 twice
//     as often, which at K1's rate nears L2's bandwidth.
//   * Precision: Q K^T is exact products of bf16 inputs summed in fp32; the
//     probabilities P are fp32 and P V runs as two products,
//     bf16(P) V + bf16(P - bf16(P)) V, which carries P to about 16 mantissa
//     bits, as the reference's fp32 p @ v keeps it; the one rounding to
//     bf16 left is that of the output. One bf16 term would do 1.11x the
//     useful tensor work instead of 1.67x, but fails the elementwise bar
//     (PERF.md section 6). The running max is kept on raw scores, and
//     p = 2^(s * scale * log2(e) - m') is one FFMA and one MUFU ex2.
// The fp32 body runs every product as fp32 FMA on the CUDA cores, so it
// holds the reference to 5e-5 (tensor-core TF32 would not): one thread owns
// one query row, its scaled q row and accumulator in registers; it chooses
// the fresh or stale source per key row on the pointer.
// The kernels allocate nothing and run on the caller's stream.

#include "hopper_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: the TMA + wgmma pipeline of hopper_tiles.cuh over key runs
// ---------------------------------------------------------------------------

constexpr int kMaxRuns = 3;

// One run of keys: `length` rows of one source starting at row `first`,
// walked in kBK-key tiles from row `origin` (origin <= first; the tiles'
// rows outside [first, first + length) are masked).
struct KeyRun {
  int source;  // 0 stale, 1 fresh
  int first, length, origin;
};
struct KeyRuns {  // per batch-row class: rows b < b_split, then the rest
  int count[2];
  KeyRun run[2][kMaxRuns];
};

// Two boxes per tensor: [0] columns 0..W0-1, [1] columns W0..HDP-1.
struct TmaMaps {
  CUtensorMap q[2], kf[2], vf[2], ks[2], vs[2];
};

// The walk of attention_block over one batch-row class's runs: each run's
// tiles in order, read from the run's source; keys outside the run are
// masked by key index, whatever the query row.
struct RunWalk {
  const TmaMaps* maps;
  const KeyRun* run;
  int n_runs;

  struct Cursor {
    int r, c;  // run r, tile origin c
  };
  __device__ __forceinline__ int count() const {
    int n = 0;
    for (int r = 0; r < n_runs; ++r)
      n += (run[r].first + run[r].length - run[r].origin + kBK - 1) / kBK;
    return n;
  }
  __device__ __forceinline__ Cursor begin() const { return {0, run[0].origin}; }
  __device__ __forceinline__ void next(Cursor& cur) const {
    cur.c += kBK;
    if (cur.c >= run[cur.r].first + run[cur.r].length && ++cur.r < n_runs)
      cur.c = run[cur.r].origin;
  }
  __device__ __forceinline__ const CUtensorMap* k_map(const Cursor& cur) const {
    return run[cur.r].source ? maps->kf : maps->ks;
  }
  __device__ __forceinline__ const CUtensorMap* v_map(const Cursor& cur) const {
    return run[cur.r].source ? maps->vf : maps->vs;
  }
  __device__ __forceinline__ int row(const Cursor& cur) const { return cur.c; }
  __device__ __forceinline__ void mask(float (&s)[kBK / 2], const Cursor& cur, int, int,
                                       int lane) const {
    const int lo = run[cur.r].first, hi = lo + run[cur.r].length;
    if (cur.c >= lo && cur.c + kBK <= hi) return;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int key = cur.c + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      if (key < lo || key >= hi) s[i] = kMaskedScore;
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
stale_kv_attention_wgmma_kernel(__grid_constant__ const TmaMaps maps,
                                __grid_constant__ const KeyRuns runs,
                                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                Strides so, Strides sl, int H, int Nl, int b_split,
                                float scale_log2) {
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int cls = b < b_split ? 0 : 1;
  const RunWalk walk{&maps, runs.run[cls], runs.count[cls]};
  attention_block<HD>(maps.q, walk, b, h, h, blockIdx.x * kBQ, Nl, out, so, lse, sl,
                      scale_log2);
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
    // two-level sums: the tile's 32 terms first, then one update of the
    // running sums a tile, so a row's rounding grows with 32 + N / 32 terms,
    // not N (an 8192-key context otherwise drifts past the 5e-5 bar)
    const float alpha = exp2f(m - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < kFmaBK; ++j) {
      s[j] = exp2f(s[j] - m_new);  // s now holds the probabilities
      l_tile += s[j];
    }
    l = fmaf(l, alpha, l_tile);
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll
      for (int j = 0; j < kFmaBK; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[j][d]);
        t0 = fmaf(s[j], vv.x, t0);
        t1 = fmaf(s[j], vv.y, t1);
        t2 = fmaf(s[j], vv.z, t2);
        t3 = fmaf(s[j], vv.w, t3);
      }
      acc[d] = fmaf(acc[d], alpha, t0);
      acc[d + 1] = fmaf(acc[d + 1], alpha, t1);
      acc[d + 2] = fmaf(acc[d + 2], alpha, t2);
      acc[d + 3] = fmaf(acc[d + 3], alpha, t3);
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

// ---------------------------------------------------------------------------
// host: launches
// ---------------------------------------------------------------------------

// What a launch needs to know of its operands besides the pointers.
struct Layout {
  int B, H, Nl;
  int n_fresh;  // rows of the fresh K/V maps (Nl; K4, which has none: n_keys)
  int n_keys;   // rows of the stale K/V maps: keys visited (K1 N, K2/K5 n_tokens, K4 valid_len)
  int tok_start, valid_lo, valid_hi, b_split;  // the fp32 body's key layout
};

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* kf, const void* vf, const void* ks,
                         const void* vs, void* out, float* lse, const Strides* st,
                         const Layout& L, const KeyRuns& runs, float scale_log2,
                         cudaStream_t stream) {
  TmaMaps maps;
  const void* src[5] = {q, kf, vf, ks, vs};
  CUtensorMap(*dst[5])[2] = {&maps.q, &maps.kf, &maps.vf, &maps.ks, &maps.vs};
  const int rows[5] = {L.Nl, L.n_fresh, L.n_fresh, L.n_keys, L.n_keys};
  for (int i = 0; i < 5; ++i) {
    const int S = rows[i] > 0 ? rows[i] : 1;  // a map needs an extent; no tile reads it
    if (!encode_maps<HD>(*dst[i], src[i], st[i], L.B, S, L.H)) return cudaErrorInvalidValue;
  }
  static bool smem_set[64] = {};  // per device; one entry per instantiation
  const int smem = HeadTiles<HD>::kSmemBytes;
  const cudaError_t err = allow_smem(stale_kv_attention_wgmma_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((L.Nl + kBQ - 1) / kBQ, L.B * L.H);
  stale_kv_attention_wgmma_kernel<HD><<<grid, kThreads, smem, stream>>>(
      maps, runs, static_cast<__nv_bfloat16*>(out), lse, st[5], st[6], L.H, L.Nl, L.b_split,
      scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* kf, const void* vf, const void* ks,
                   const void* vs, void* out, float* lse, const Strides* st, const Layout& L,
                   const KeyRuns& runs, float scale_log2, cudaStream_t stream) {
  if (dtype == 1)
    return launch_wgmma<HD>(q, kf, vf, ks, vs, out, lse, st, L, runs, scale_log2, stream);
  const dim3 grid((L.Nl + kFmaBQ - 1) / kFmaBQ, L.B * L.H);
  stale_kv_attention_fma_kernel<HD><<<grid, kFmaBQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kf), static_cast<const float*>(vf),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<float*>(out), lse,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], L.H, L.Nl, L.n_keys, L.tok_start,
      L.valid_lo, L.valid_hi, L.b_split, scale_log2);
  return cudaGetLastError();
}

// Dispatch on the dtype and the head dim. st: the (b, s, h) strides of q,
// k_fresh, v_fresh, k_stale, v_stale, out and lse (unused without lse).
// runs: 2 classes x 13 int, each a run count then 3 runs of (source, first,
// length, origin).
int dispatch(int dtype, int hd, const void* q, const void* kf, const void* vf, const void* ks,
             const void* vs, void* out, float* lse, const Strides* st, const Layout& L,
             const int* runs, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  KeyRuns kr = {};
  for (int c = 0; c < 2; ++c) {
    const int* r = runs + 13 * c;
    if (r[0] < 0 || r[0] > kMaxRuns) return cudaErrorInvalidValue;
    kr.count[c] = r[0];
    for (int i = 0; i < r[0]; ++i)
      kr.run[c][i] = {r[1 + 4 * i], r[2 + 4 * i], r[3 + 4 * i], r[4 + 4 * i]};
  }
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(dtype, q, kf, vf, ks, vs, out, lse, st, L, kr, scale_log2, s);
    case 72: return launch<72>(dtype, q, kf, vf, ks, vs, out, lse, st, L, kr, scale_log2, s);
    default: return cudaErrorInvalidValue;
  }
}

// The strides of K1, K2 and K5's six tensors, 18 int64 in (b, s, h) order;
// the seventh (lse) slot is unused.
int dispatch6(int dtype, int hd, const void* q, const void* kf, const void* vf, const void* ks,
              const void* vs, void* out, const int64_t* strides, const Layout& L,
              const int* runs, float scale, void* stream) {
  Strides st[7] = {};
  for (int i = 0; i < 6; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return dispatch(dtype, hd, q, kf, vf, ks, vs, out, nullptr, st, L, runs, scale, stream);
}

}  // namespace

// Plain C entry points, bound with ctypes. Common arguments:
//   dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (TMA + wgmma body);
//          all six tensors share it. The bf16 body reads its operands
//          through TMA: pointers 16-byte aligned, strides multiples of 8
//          elements.
//   strides: 18 int64 element strides, (b, s, h) for q, k_fresh, v_fresh,
//            k_stale, v_stale, out in that order; hd must be contiguous
//   Nl: query rows (and rows of the fresh K/V)
//   runs: the key runs of the bf16 body, 26 int: for batch rows below
//         b_split, then for the rest, a run count (at most 3) and per run
//         (source 0 stale / 1 fresh, first row, length, tile origin), as
//         repro_torch.kernels.stale_kv_attention.key_runs lays them out;
//         the fp32 body reads the layout arguments instead
//   scale: the softmax scale (hd ** -0.5 for the DiT)
// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue if a tensor map cannot be built.

// The key-tile width the runs' tile origins must be computed for.
extern "C" int stale_kv_attention_key_tile() { return kBK; }

// K1: N context keys; the Nl fresh rows sit at tok_start.
extern "C" int stale_kv_attention_launch(int dtype, int hd, const void* q, const void* k_fresh,
                                         const void* v_fresh, const void* k_stale,
                                         const void* v_stale, void* out, const int64_t* strides,
                                         const int* runs, int B, int H, int Nl, int N,
                                         int tok_start, float scale, void* stream) {
  const Layout L = {B, H, Nl, Nl, N, tok_start, Nl, Nl, B};
  return dispatch6(dtype, hd, q, k_fresh, v_fresh, k_stale, v_stale, out, strides, L, runs,
                   scale, stream);
}

// K2: the slab's first valid_tokens rows are fresh at tok_start; the stale
// buffer's keys from n_tokens on are scratch and masked.
extern "C" int stale_kv_attention_padded_launch(int dtype, int hd, const void* q,
                                                const void* k_fresh, const void* v_fresh,
                                                const void* k_stale, const void* v_stale,
                                                void* out, const int64_t* strides,
                                                const int* runs, int B, int H, int Nl,
                                                int n_tokens, int tok_start, int valid_tokens,
                                                float scale, void* stream) {
  const Layout L = {B, H, Nl, Nl, n_tokens, tok_start, valid_tokens, valid_tokens, B};
  return dispatch6(dtype, hd, q, k_fresh, v_fresh, k_stale, v_stale, out, strides, L, runs,
                   scale, stream);
}

// K5: 2 * B batch rows, the conditional branch (rows < B) then the
// unconditional one, whose fresh rows are valid_tokens * uncond_fresh.
extern "C" int stale_kv_attention_guided_launch(int dtype, int hd, const void* q,
                                                const void* k_fresh, const void* v_fresh,
                                                const void* k_stale, const void* v_stale,
                                                void* out, const int64_t* strides,
                                                const int* runs, int B, int H, int Nl,
                                                int n_tokens, int tok_start, int valid_tokens,
                                                int uncond_fresh, float scale, void* stream) {
  const Layout L = {2 * B, H, Nl, Nl, n_tokens, tok_start, valid_tokens,
                    uncond_fresh ? valid_tokens : 0, B};
  return dispatch6(dtype, hd, q, k_fresh, v_fresh, k_stale, v_stale, out, strides, L, runs,
                   scale, stream);
}

// K4: q and out [B, Sq, H, hd], k and v [B, T, H, hd] with their first
// valid_len keys real (the key loop ends there), lse [B, Sq, H] fp32.
// strides: 15 int64, (b, s, h) for q, k, v, out, lse in that order. Every
// key comes from k/v (no fresh rows), so they fill both source slots.
extern "C" int lse_attention_launch(int dtype, int hd, const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    const int64_t* strides, const int* runs, int B, int H,
                                    int Sq, int valid_len, float scale, void* stream) {
  const int order[7] = {0, 1, 2, 1, 2, 3, 4};  // q, kf, vf, ks, vs, out, lse
  Strides st[7];
  for (int i = 0; i < 7; ++i)
    st[i] = {strides[3 * order[i]], strides[3 * order[i] + 1], strides[3 * order[i] + 2]};
  const Layout L = {B, H, Sq, valid_len, valid_len, 0, 0, 0, B};
  return dispatch(dtype, hd, q, k, v, k, v, out, lse, st, L, runs, scale, stream);
}

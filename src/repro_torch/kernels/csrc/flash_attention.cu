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
// about 15.7 MB of bf16 q, k, v and output: bound by operations. So are the
// dense decoders' causal prefills at S = T = 2048 (2.10 M visible pairs a
// head): gemma-2b (H 8, K 1, hd 256) and olmoe-1b-7b (H = K = 16, hd 128)
// do 17.2 GFLOP each against 18.9 and 33.6 MB.
//
// What the design does about that:
//   * bf16 runs the TMA + wgmma pipeline of hopper_tiles.cuh
//     (attention_block, K1's body): 128 query rows a block, a producer
//     warpgroup keeping 128-key K and V tiles in flight through an mbarrier
//     ring, two consumer warpgroups of 64 rows running Q K^T and P V (P as
//     two bf16 terms) on wgmma and taking turns, setmaxnreg between them.
//     At hd 64 a K/V row is exactly one 128-byte-swizzled box; hd 128 and
//     256 are two and four such boxes (Q K^T walks their k16 slices, P V
//     writes each box's 64 output columns). hd 256 takes 64-key tiles and a
//     two-stage ring (hopper_tiles.cuh's HeadTiles): a consumer thread holds
//     128 fp32 of O there.
//   * The walk (tile_walk, tile_full; mirrored by flash_attention.py's
//     tile_classes and held to the mask on the CPU): the keys a query tile
//     [q0, q1) sees are at most two runs, the prefix [0, prefix) and the
//     window [max(prefix, q0 - window + 1), min(q1, T)), so the block visits
//     the tiles holding prefix keys and then the window's tiles up to its
//     diagonal, and skips the rest. A visited tile in which every (row, key)
//     pair of the block is visible takes no mask; only the tiles that cross
//     the diagonal, the window's lower edge, the prefix/window seam or the
//     end of the keys apply the per-element visible() test (2 of a late
//     block's 10 tiles at Hymba's mask).
//   * GQA: the KV head is a TMA coordinate (h / group), so no repeated K/V
//     is read. Ragged S and T: TMA zero-fills rows past the maps' extents,
//     keys >= T are masked, no row >= S is stored.
//   * Blocks differ in work (a late query tile visits up to 10 key tiles,
//     the first one 1): the grid's slow axis is the query tile, last tile
//     first, so every head's heaviest blocks are handed out first.
//   * fp32 runs a CUDA-core FMA body (every tile masked per element), which
//     holds the reference to 5e-5: a query row a thread at hd 64; at hd 128
//     and 256 a row's head dim is split over hd / 32 neighbouring lanes (32
//     columns each, in interleaved 16-byte chunks so a warp's shared loads
//     do not conflict) that sum their partial dot products with shuffles,
//     and 16-key tiles at hd 256 keep the K/V tiles in 32 KB of shared
//     memory.
// The kernels allocate nothing and run on the caller's stream.

#include "hopper_tiles.cuh"

namespace {

struct MaskArgs {
  int T, causal, window, prefix;
};

// min and max for the functions the host also runs (flash_attention_tile_class)
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ __forceinline__ bool visible(const MaskArgs& m, int i, int j) {
  return j < m.T && (!m.causal || j <= i) &&
         (m.window <= 0 || j > i - m.window || j < m.prefix);
}

// The key tiles (of bk rows) that query rows [q0, q1) can see: the tiles
// holding prefix keys, then the window's tiles up to the diagonal. Tile i
// of the walk is i for i < n_prefix, else first + (i - n_prefix).
struct TileWalk {
  int n_prefix, first, n;
  __host__ __device__ __forceinline__ int tile(int i) const {
    return i < n_prefix ? i : first + i - n_prefix;
  }
};

__host__ __device__ __forceinline__ TileWalk tile_walk(const MaskArgs& m, int q0, int q1, int bk) {
  const int nt = (m.T + bk - 1) / bk;
  const int end = m.causal ? imin(nt, (q1 - 1) / bk + 1) : nt;
  if (m.window <= 0) return {0, 0, end};
  const int n_prefix = imin((m.prefix + bk - 1) / bk, end);
  const int first = imax(imax(0, q0 - m.window + 1) / bk, n_prefix);
  return {n_prefix, first, n_prefix + imax(0, end - first)};
}

// Whether every pair of a row in [q0, q1) and a key in [c0, c0 + bk) is
// visible, so the tile takes no per-element mask: no key at or past T, no
// key after the first row (causal), and every non-prefix key inside the
// last row's window.
__host__ __device__ __forceinline__ bool tile_full(const MaskArgs& m, int q0, int q1, int c0,
                                                   int bk) {
  if (c0 + bk > m.T) return false;
  if (m.causal && c0 + bk - 1 > q0) return false;
  const int lo = imax(c0, m.prefix);  // the tile's first non-prefix key
  return m.window <= 0 || lo >= c0 + bk || lo > q1 - 1 - m.window;
}

// ---------------------------------------------------------------------------
// bf16: the TMA + wgmma pipeline of hopper_tiles.cuh
// ---------------------------------------------------------------------------

// The walk of attention_block over a query tile's visible key tiles of BK
// keys; the K/V head is the caller's.
template <int BK>
struct FlashWalk {
  const CUtensorMap* k;
  const CUtensorMap* v;
  MaskArgs m;
  int q0, q1;
  TileWalk w;

  __device__ __forceinline__ int count() const { return w.n; }
  __device__ __forceinline__ int begin() const { return 0; }
  __device__ __forceinline__ void next(int& i) const { ++i; }
  __device__ __forceinline__ const CUtensorMap* k_map(int) const { return k; }
  __device__ __forceinline__ const CUtensorMap* v_map(int) const { return v; }
  __device__ __forceinline__ int row(int i) const { return w.tile(i) * BK; }
  __device__ __forceinline__ void mask(float (&s)[BK / 2], int i, int row_lo, int row_hi,
                                       int lane) const {
    const int c0 = row(i);
    if (tile_full(m, q0, q1, c0, BK)) return;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int key = c0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
      if (!visible(m, (e % 4) < 2 ? row_lo : row_hi, key)) s[e] = kMaskedScore;
    }
  }
};

struct FlashMaps {
  CUtensorMap q[2], k[2], v[2];
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(__grid_constant__ const FlashMaps maps,
                             __nv_bfloat16* __restrict__ out, Strides so, int H, int group,
                             int S, MaskArgs mask, float scale_log2) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // every head's longest walks first
  const int q1 = min(q0 + kBQ, S);
  constexpr int BK = HeadTiles<HD>::BK;
  const FlashWalk<BK> walk{maps.k, maps.v, mask, q0, q1, tile_walk(mask, q0, q1, BK)};
  attention_block<HD>(maps.q, walk, b, h, h / group, q0, S, out, so, nullptr, Strides{},
                      scale_log2);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int kFmaBQ = 64;  // query rows per block

// The fp32 body's split of a head dim: G lanes a query row, each holding
// HD / G columns of q and of the output, and BK keys a shared tile.
template <int HD>
struct FmaTiles {
  static constexpr int G = HD > 64 ? HD / 32 : 1;
  static constexpr int DT = HD / G;               // columns a lane holds
  static constexpr int BK = HD > 128 ? 16 : 32;   // key rows per shared-memory tile
  static constexpr int kThreads = kFmaBQ * G;
  static_assert(HD % (4 * G) == 0 && 32 % G == 0, "a lane holds whole 16-byte chunks");
};

template <int HD>
__global__ void __launch_bounds__(FmaTiles<HD>::kThreads)
flash_attention_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, Strides sq,
                           Strides sk, Strides sv, Strides so, int H, int group, int S,
                           MaskArgs mask, float scale_log2) {
  using F = FmaTiles<HD>;
  constexpr int G = F::G, DT = F::DT, BK = F::BK;
  __shared__ __align__(16) float k_tile[BK][HD];
  __shared__ __align__(16) float v_tile[BK][HD];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFmaBQ;  // the longest walks first
  const int g = threadIdx.x % G;                         // this lane's part of the row
  const int row = q0 + threadIdx.x / G;
  const bool valid = row < S;
  const TileWalk walk = tile_walk(mask, q0, min(q0 + kFmaBQ, S), BK);
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  // column of this lane's element c: chunk c / 4 of the lane is the row's
  // chunk g + G * (c / 4), so the G lanes of a row read neighbouring chunks
  auto col = [&](int c) { return 4 * (g + G * (c / 4)) + c % 4; };

  float qr[DT];
  float acc[DT];
  const float* qp = q + b * sq.b + (int64_t)(valid ? row : 0) * sq.s + h * sq.h;
#pragma unroll
  for (int c = 0; c < DT; ++c) qr[c] = valid ? qp[col(c)] * scale_log2 : 0.f;
#pragma unroll
  for (int c = 0; c < DT; ++c) acc[c] = 0.f;
  float m = kMaskedScore;  // running max (log2 domain)
  float l = 0.f;           // running sum of exp2(score - m)

  for (int i = 0; i < walk.n; ++i) {
    const int k0 = walk.tile(i) * BK;
    __syncthreads();  // the previous tile is no longer read
#pragma unroll 4
    for (int e = threadIdx.x; e < BK * HD; e += F::kThreads) {
      const int j = e / HD;
      const int d = e - j * HD;
      const int t = k0 + j;
      k_tile[j][d] = t < mask.T ? kb[(int64_t)t * sk.s + d] : 0.f;
      v_tile[j][d] = t < mask.T ? vb[(int64_t)t * sv.s + d] : 0.f;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) s[j] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; c += 4) {
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_tile[j][col(c)]);
        s[j] = fmaf(qr[c], kk.x, s[j]);
        s[j] = fmaf(qr[c + 1], kk.y, s[j]);
        s[j] = fmaf(qr[c + 2], kk.z, s[j]);
        s[j] = fmaf(qr[c + 3], kk.w, s[j]);
      }
    }
#pragma unroll
    for (int off = 1; off < G; off *= 2)  // the row's G partial dot products
#pragma unroll
      for (int j = 0; j < BK; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      if (!visible(mask, row, k0 + j)) s[j] = kMaskedScore;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < DT; c += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[j][col(c)]);
        acc[c] = fmaf(p, vv.x, acc[c]);
        acc[c + 1] = fmaf(p, vv.y, acc[c + 1]);
        acc[c + 2] = fmaf(p, vv.z, acc[c + 2]);
        acc[c + 3] = fmaf(p, vv.w, acc[c + 3]);
      }
    }
    m = m_new;
  }

  if (valid) {
    float* op = out + b * so.b + (int64_t)row * so.s + h * so.h;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < DT; ++c) op[col(c)] = acc[c] * inv;
  }
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out,
                         const Strides* st, int B, int H, int K, int S, MaskArgs mask,
                         float scale_log2, cudaStream_t stream) {
  FlashMaps maps;
  if (!encode_maps<HD>(maps.q, q, st[0], B, S, H, kBQ) ||
      !encode_maps<HD>(maps.k, k, st[1], B, mask.T, K) ||
      !encode_maps<HD>(maps.v, v, st[2], B, mask.T, K))
    return cudaErrorInvalidValue;
  static bool smem_set[64] = {};  // per device; one entry per instantiation
  const int smem = HeadTiles<HD>::kSmemBytes;
  const cudaError_t err = allow_smem(flash_attention_wgmma_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_attention_wgmma_kernel<HD><<<grid, kThreads, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(out), st[3], H, H / K, S, mask, scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out,
                   const Strides* st, int B, int H, int K, int S, MaskArgs mask,
                   float scale_log2, cudaStream_t stream) {
  if (dtype == 1)
    return launch_wgmma<HD>(q, k, v, out, st, B, H, K, S, mask, scale_log2, stream);
  const dim3 grid((S + kFmaBQ - 1) / kFmaBQ, B * H);
  flash_attention_fma_kernel<HD><<<grid, FmaTiles<HD>::kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), st[0], st[1], st[2], st[3], H, H / K, S, mask, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes.
//
// flash_attention_launch:
//   dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (TMA + wgmma body);
//          q, k, v and out share it. The bf16 body reads its operands
//          through TMA: pointers 16-byte aligned, strides multiples of 8
//          elements.
//   hd: the head dim; 64 (Hymba-1.5B and every reduced LM), 128 (yi-9b,
//       minitron-8b, llama3-405b, internvl2-76b, olmoe-1b-7b,
//       deepseek-moe-16b) and 256 (gemma-2b) are instantiated
//   strides: 12 int64 element strides, (b, s, h) for q, k, v, out in that
//            order; hd must be contiguous
//   q and out [B, S, H, hd]; k and v [B, T, K, hd] with K | H
//   causal, window, prefix_len: the mask (window 0 = no window)
//   scale: the softmax scale (hd ** -0.5)
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue if a tensor map cannot be built.
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
    case 64: return launch<64>(dtype, q, k, v, out, st, B, H, K, S, mask, scale_log2, s);
    case 128: return launch<128>(dtype, q, k, v, out, st, B, H, K, S, mask, scale_log2, s);
    case 256: return launch<256>(dtype, q, k, v, out, st, B, H, K, S, mask, scale_log2, s);
    default: return cudaErrorInvalidValue;
  }
}

// The keys of a bf16 tile at head dim hd (0 for a head dim not built).
static int key_tile(int hd) {
  switch (hd) {
    case 64: return HeadTiles<64>::BK;
    case 128: return HeadTiles<128>::BK;
    case 256: return HeadTiles<256>::BK;
    default: return 0;
  }
}

// The bf16 body's tiles at head dim hd: which = 0 gives the query rows of a
// block, 1 the keys of a tile; 0 for a head dim not built.
extern "C" int flash_attention_tile(int hd, int which) {
  const int bk = key_tile(hd);
  return bk == 0 ? 0 : which == 0 ? kBQ : bk;
}

// How the bf16 body at head dim hd treats key tile kt (keys [kt * BK,
// (kt + 1) * BK)) in the block of query tile qt (rows [qt * kBQ, min((qt +
// 1) * kBQ, S))): 0 not visited, 1 visited without a mask, 2 visited with
// the per-element mask, -1 for a head dim not built. The same functions
// the kernel runs; flash_attention.py's tile_classes is their Python
// mirror.
extern "C" int flash_attention_tile_class(int hd, int S, int T, int causal, int window,
                                          int prefix_len, int qt, int kt) {
  const int bk = key_tile(hd);
  if (bk == 0) return -1;
  const MaskArgs m{T, causal, window, prefix_len};
  const int q0 = qt * kBQ, q1 = imin(q0 + kBQ, S);
  const TileWalk w = tile_walk(m, q0, q1, bk);
  const bool visited = kt < w.n_prefix || (kt >= w.first && kt < w.first + w.n - w.n_prefix);
  if (!visited) return 0;
  return tile_full(m, q0, q1, kt * bk, bk) ? 1 : 2;
}

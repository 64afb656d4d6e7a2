// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_heads.cu, flash_ring.cu): the head width, the
// operand and output addressing, the mask and the tile ranges it leaves
// live (the one visibility rule of every loop), the row map of K9's
// packed tiles, the arguments every C entry shares, and the 16-byte
// bf16 helpers of K1's rope pre-pass and K2. K1, K9 and K12 run the
// wgmma/TMA forward of flash_fwd_sm90.cuh (K1 at head_dim 64 that of
// flash_fwd_sm90_d64.cuh); K3, K4, K10, K11, K13 and K14
// the wgmma/TMA backward of flash_bwd_sm90.cuh.
//
// Head width: D is a template parameter of every loop and helper that
// depends on it (sm90_common.cuh's Row<D>), instantiated for 64 and 128.
// K1-K4 take both; the fused-heads kernels K9-K11 and the ring kernels
// K12-K14 are built for 128 only.
//
// Layout: q/k/v/do are bf16 operands addressed as [B, heads, S, D] through
// batch, head and row strides (elements). That covers the [B, H, S, D]
// tensors of flash_attention and the [B, S, H*D] tensors of
// flash_attention_bshd (head stride D, row stride H*D) alike. Each row of
// D values is contiguous and 16-byte aligned (the Python wrapper checks).
// Outputs are written through strides as well, in bf16 or, for the
// ring's K13 and K14, f32. Rope tables are [B, S, D] bf16, contiguous,
// full width (the first-half values repeated in the second half). lse
// and delta are f32 [B, H, S].
//
// Row maps: a 128-row query tile of the forward loop holds 2^shift
// consecutive positions of 128 >> shift heads; row r is position
// pos0 + r % 2^shift of head head0 + r / 2^shift. The per-head kernels
// take one head per tile (shift 7); K9 packs the q heads of one GQA group
// into the tile, so one staged k/v tile serves the group.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fa {

typedef __nv_bfloat16 bf16;

constexpr int NWARPS = 8;        // K2's block: one warp per row
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

// One [B, heads, S, D] operand: base pointer and element strides.
struct Operand {
  const bf16* ptr;
  long long sb, sh, ss;
};

// One [B, heads, S, D] output, addressed the same way; its element type
// (bf16 or f32) is the writing epilogue's.
struct Out {
  void* ptr;
  long long sb, sh, ss;
};

// The visibility rule of every kernel, from the JAX kernels' _block_mask:
// (causal & in-window) | in-prefix, where causal means query row r sees
// the keys up to r + off. K1-K4 and K9-K11 align the ends (off = kv_len -
// q_len); the ring kernels K12-K14 compare global positions (off =
// q_start - k_start, the rule of the TPU ring's _dyn_mask) with no window
// and no prefix. Positions past q_len or kv_len are never visible.
// window <= 0 means no sliding window, prefix <= 0 no prefix; both act
// only under causality (the wrapper refuses them otherwise). The loops
// test it as a range per query row (Keys) or per key (Rows), set up once
// for the row or key a thread holds across a tile, so the offset costs
// nothing per element.
struct Mask {
  int q_len, kv_len, causal, window, prefix, off;
};

// The keys query `row` sees: [lo, hi] (the causal band, cut below by the
// window) and [0, pre) (the prefix); none when row is past q_len.
struct Keys {
  int lo, hi, pre;
  __device__ __forceinline__ bool has(int col) const {
    return (col >= lo && col <= hi) || col < pre;
  }
};

__device__ __forceinline__ Keys keys_of(const Mask& m, int row) {
  if (row >= m.q_len) return Keys{1, 0, 0};
  if (!m.causal) return Keys{0, m.kv_len - 1, 0};
  const int last = row + m.off;  // the newest key row sees
  return Keys{m.window > 0 ? last - m.window + 1 : 0, min(last, m.kv_len - 1),
              min(m.prefix, m.kv_len)};
}

// The queries [lo, hi] that see some key of [k_lo, k_hi] (none when
// lo > hi): every query when a key lies in the prefix, else those whose
// band covers one of the keys. For one key this is exactly the set that
// sees it.
struct Rows {
  int lo, hi;
  __device__ __forceinline__ bool has(int row) const { return row >= lo && row <= hi; }
};

__device__ __forceinline__ Rows rows_of(const Mask& m, int k_lo, int k_hi) {
  if (k_lo >= m.kv_len) return Rows{1, 0};
  if (!m.causal || k_lo < m.prefix) return Rows{0, m.q_len - 1};
  return Rows{max(0, k_lo - m.off),
              m.window > 0 ? min(m.q_len - 1, k_hi - m.off + m.window - 1) : m.q_len - 1};
}

// Whether every query of [r_lo, r_hi] sees every key of [k0, k0 + n):
// the tiles on which the wgmma loops (flash_fwd_sm90.cuh,
// flash_bwd_sm90.cuh) skip the per-element mask. Rows past q_len are not
// asked about: their outputs are never written, and the backward gives
// them lse = +inf, so their P is 0.
__device__ __forceinline__ bool sees_all(const Mask& m, int r_lo, int r_hi, int k0, int n) {
  const int k1 = k0 + n - 1;
  if (k1 >= m.kv_len) return false;
  if (!m.causal || k1 < m.prefix) return true;
  return r_lo + m.off >= k1 && (m.window <= 0 || r_hi + m.off - m.window + 1 <= k0);
}

// Whether rows up to r_hi see the keys k0.. of a live tile only up to
// each row's last (no window start or prefix end inside the tile): the
// D = 64 loops then mask a key with one comparison.
__device__ __forceinline__ bool band_only(const Mask& m, int r_hi, int k0) {
  return (m.window <= 0 || r_hi + m.off - m.window + 1 <= k0) && m.prefix <= k0;
}

// The live kv tiles (TK keys each) of query rows [r_lo, r_hi], as
// _tile_meta_impl's live(i, j) keeps them: tiles [0, pre) hold the
// prefix, tiles [lo, hi) the causal band, bounded below by the window. A
// tile in neither has no visible (row, col) pair and is never loaded; a
// ring block wholly in the future of its q shard has none at all. Walk t
// in [0, count()), tile(t) in increasing order.
struct TileRange {
  int pre, lo, hi;
  __device__ __forceinline__ int count() const { return pre + max(0, hi - max(lo, pre)); }
  __device__ __forceinline__ int tile(int t) const {
    return t < pre ? t : max(lo, pre) + t - pre;
  }
};

template <int TK>
__device__ __forceinline__ TileRange kv_tiles(const Mask& m, int r_lo, int r_hi) {
  const int nk = (m.kv_len + TK - 1) / TK;
  if (!m.causal) return TileRange{0, 0, nk};
  const int last = min(m.kv_len - 1, r_hi + m.off);
  TileRange t{m.prefix > 0 ? min(nk, (m.prefix + TK - 1) / TK) : 0, 0, 0};
  if (last >= 0) {
    t.lo = m.window > 0 ? max(0, r_lo + m.off - m.window + 1) / TK : 0;
    t.hi = last / TK + 1;
  }
  return t;
}

// Which position and head each of a tile's 128 rows holds (see the top).
struct RowMap {
  int pos0, shift, head0;
  __device__ __forceinline__ int pos(int r) const { return pos0 + (r & ((1 << shift) - 1)); }
  __device__ __forceinline__ int head(int r) const { return head0 + (r >> shift); }
};

// Everything a kernel reads: operands, rope tables (nullptr: no rope),
// the backward's lse and delta, the outputs, and the mask.
struct AttnArgs {
  Operand q, k, v, dout;
  const bf16* cos;
  const bf16* sin;
  const float* lse_in;
  const float* delta;
  Out o, dq, dk, dv;
  float* lse;
  int H, group, shift;  // shift: log2 of the query positions per tile (K9)
  Mask mask;
  float scale;
};

__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Store 8 f32 values as bf16 (one 16-byte store).
__device__ __forceinline__ void store8(bf16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack8(f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This batch's [S, D] rope table, or nullptr without rope.
template <int D>
__device__ __forceinline__ const bf16* table(const bf16* t, int b, int S) {
  return t ? t + (long long)b * S * D : nullptr;
}

// ---------------------------------------------------------- host side
// The arguments every C entry shares. `st` holds the (batch, head, row)
// strides of q, k, v and, when dout is given (the backward, with lse and
// delta), do.
inline AttnArgs attn_args(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, const long long* st, int H,
                          int KVH, int q_len, int kv_len, int causal, int window,
                          int prefix, float scale) {
  AttnArgs a = {};
  a.q = Operand{static_cast<const bf16*>(q), st[0], st[1], st[2]};
  a.k = Operand{static_cast<const bf16*>(k), st[3], st[4], st[5]};
  a.v = Operand{static_cast<const bf16*>(v), st[6], st[7], st[8]};
  if (dout != nullptr) a.dout = Operand{static_cast<const bf16*>(dout), st[9], st[10], st[11]};
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.H = H;
  a.group = H / KVH;
  a.mask = Mask{q_len, kv_len, causal, causal ? window : 0, causal ? prefix : 0,
                kv_len - q_len};
  a.scale = scale;
  return a;
}

// Strides (elements) of a contiguous [B, heads, S, D] and [B, S, heads *
// D] output.
template <int D>
inline Out out_bhsd(void* p, int heads, int S) {
  return Out{p, (long long)heads * S * D, (long long)S * D, D};
}

template <int D>
inline Out out_bshd(void* p, int heads, int S) {
  return Out{p, (long long)S * heads * D, D, (long long)heads * D};
}

// The C entries of K1-K4 take the head width at run time: f(the width
// as std::integral_constant) for 64 and 128, cudaErrorInvalidValue for
// any other (the Python wrappers raise first).
template <typename F>
inline int by_head_dim(int head_dim, F&& f) {
  if (head_dim == 64) return f(std::integral_constant<int, 64>());
  if (head_dim == 128) return f(std::integral_constant<int, 128>());
  return (int)cudaErrorInvalidValue;
}

// log2 of the query positions per 128-row tile when `group` q heads
// share it (128 / group), or -1 when group is not a power of two up to
// 64 (K9's packing; the wrapper checks the same).
inline int pack_shift(int group) {
  int shift = 7;
  for (int g = group; g > 1; g >>= 1) {
    if (g & 1) return -1;
    --shift;
  }
  return shift > 0 ? shift : -1;
}

}  // namespace fa

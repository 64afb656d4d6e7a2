// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_heads.cu, flash_ring.cu): tile geometry, the mask
// and the tile ranges it leaves live (the one visibility rule of every
// loop, the wgmma/TMA loops of flash_fwd_sm90.cuh and flash_bwd_sm90.cuh
// included), and the last WMMA tile loop, K10's dq (`dq_tile`), with its
// tile loads, WMMA products and row writes. K10 passes no rope tables,
// so the rope branches of `load_rows` and `write_rows` run in no kernel;
// they go with `dq_tile` when K10 leaves it. K1, K9 and K12 run the
// wgmma/TMA forward of flash_fwd_sm90.cuh; K3, K4, K11, K13 and K14 the
// wgmma/TMA backward of flash_bwd_sm90.cuh.
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
// `dq_tile`'s tiles: 64 rows x D=128 columns, staged in shared memory;
// the products run on the tensor cores through WMMA (bf16 in, f32
// accumulate, 16x16x16 fragments). Eight warps per block; warp w owns the
// 16-row group (w & 3) and the column half (w >> 2) of every product it
// computes.
//
// Row maps: a 64-row query tile holds 2^shift consecutive positions of
// 64 >> shift heads; row r is position pos0 + r % 2^shift of head
// head0 + r / 2^shift. The per-head loops take one head per tile (shift
// 6; 7 for the 128-row tiles of the wgmma loops); the fused-heads
// kernels (K9, K10) pack the q heads of one GQA group into the tile, so
// one staged k/v tile serves the group.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace fa {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int D = 128;           // head_dim (the only one built)
constexpr int HALF = D / 2;
constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // key rows per tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
// Padded row strides (elements) of the shared-memory tiles: the padding
// staggers rows across banks, and keeps every 16-row fragment origin
// 32-byte aligned as WMMA requires.
constexpr int LD_H = D + 8;      // bf16 [64, D]
constexpr int LD_P = BK + 8;     // bf16 [64, 64]
constexpr int LD_S = BK + 4;     // f32  [64, 64]
constexpr int LD_O = D + 4;      // f32  [64, D]
constexpr int TILE_H = 64 * LD_H;   // elements
constexpr int TILE_P = 64 * LD_P;
constexpr int TILE_S = 64 * LD_S;
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

template <int TK = BK>
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

// Which position and head each of a tile's 64 rows holds (see the top).
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
  int H, group, shift;  // shift: log2 of the query positions per tile
  Mask mask;
  float scale;
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

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

// Stage the 64 rows of `map` into dst [64][LD_H]: row r is read at
// src + head(r) * sh + pos(r) * ss (src = this batch's base); positions
// at or past `len` become zeros. With rope tables (cos/sin = this batch's
// [S, D] base) the tile is stored roped: rope(x) = x * C +
// rotate_half(x) * S with rotate_half(x) = [-x2, x1], computed in f32 and
// rounded once to bf16.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long sh,
                                          long long ss, RowMap map, int len,
                                          const bf16* cos, const bf16* sin) {
  if (cos == nullptr) {
    for (int idx = threadIdx.x; idx < 64 * (D / 8); idx += NTHREADS) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const int pos = map.pos(r);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (pos < len) val = ld16(src + map.head(r) * sh + pos * ss + c);
      *reinterpret_cast<uint4*>(dst + r * LD_H + c) = val;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < 64 * (HALF / 8); idx += NTHREADS) {
    const int r = idx / (HALF / 8), c = (idx % (HALF / 8)) * 8;
    const int pos = map.pos(r);
    float o1[8], o2[8];
    if (pos < len) {
      float x1[8], x2[8], c1[8], c2[8], s1[8], s2[8];
      const bf16* x = src + map.head(r) * sh + pos * ss;
      const long long t = (long long)pos * D;
      unpack8(ld16(x + c), x1);
      unpack8(ld16(x + c + HALF), x2);
      unpack8(ld16(cos + t + c), c1);
      unpack8(ld16(cos + t + c + HALF), c2);
      unpack8(ld16(sin + t + c), s1);
      unpack8(ld16(sin + t + c + HALF), s2);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o1[e] = x1[e] * c1[e] - x2[e] * s1[e];
        o2[e] = x2[e] * c2[e] + x1[e] * s2[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) o1[e] = o2[e] = 0.f;
    }
    *reinterpret_cast<uint4*>(dst + r * LD_H + c) = pack8(o1);
    *reinterpret_cast<uint4*>(dst + r * LD_H + c + HALF) = pack8(o2);
  }
}

// out[64][LD_S] (f32) = A[64][D] . B[64][D]^T, both bf16 [64][LD_H].
// Warp w writes rows 16*(w&3).., columns 32*(w>>2)..+32.
__device__ __forceinline__ void mm_abt(float* out, const bf16* A, const bf16* B) {
  const int warp = threadIdx.x / 32, rg = warp & 3, ch = warp >> 2;
  FragC acc[2];
#pragma unroll
  for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + rg * 16 * LD_H + kk, LD_H);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      FragBCol b;
      wmma::load_matrix_sync(b, B + (ch * 32 + n * 16) * LD_H + kk, LD_H);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
    wmma::store_matrix_sync(out + rg * 16 * LD_S + ch * 32 + n * 16, acc[n], LD_S,
                            wmma::mem_row_major);
}

// acc += P[64][64] . V[64][D]: P bf16 [64][LD_P], V bf16 [64][LD_H].
// acc holds this warp's rows 16*(w&3).., columns 64*(w>>2)..+64.
__device__ __forceinline__ void mm_ab_acc(FragC (&acc)[4], const bf16* P, const bf16* V) {
  const int warp = threadIdx.x / 32, rg = warp & 3, ch = warp >> 2;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, P + rg * 16 * LD_P + kk, LD_P);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragBRow b;
      wmma::load_matrix_sync(b, V + kk * LD_H + ch * 64 + n * 16, LD_H);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

// Move the [64][D] accumulator fragments to f32 shared memory.
__device__ __forceinline__ void store_acc(float* dst, FragC (&acc)[4]) {
  const int warp = threadIdx.x / 32, rg = warp & 3, ch = warp >> 2;
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(dst + rg * 16 * LD_O + ch * 64 + n * 16, acc[n], LD_O,
                            wmma::mem_row_major);
}

// Write a [64][LD_O] f32 tile times `scale` as bf16 to the rows of `map`
// (dst = this batch's base, head stride sh, row stride ss), positions
// below `len` only, un-roping first when tables are given:
// unrope(g) = [g1*c1 + g2*s2, g2*c2 - g1*s1], the transpose of rope.
__device__ __forceinline__ void write_rows(bf16* dst, long long sh, long long ss,
                                           const float* src, float scale, RowMap map,
                                           int len, const bf16* cos, const bf16* sin) {
  for (int idx = threadIdx.x; idx < 64 * (HALF / 8); idx += NTHREADS) {
    const int r = idx / (HALF / 8), c = (idx % (HALF / 8)) * 8;
    const int pos = map.pos(r);
    if (pos >= len) continue;
    float g1[8], g2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g1[e] = src[r * LD_O + c + e] * scale;
      g2[e] = src[r * LD_O + c + HALF + e] * scale;
    }
    if (cos != nullptr) {
      float c1[8], c2[8], s1[8], s2[8];
      const long long t = (long long)pos * D;
      unpack8(ld16(cos + t + c), c1);
      unpack8(ld16(cos + t + c + HALF), c2);
      unpack8(ld16(sin + t + c), s1);
      unpack8(ld16(sin + t + c + HALF), s2);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float a = g1[e], b = g2[e];
        g1[e] = a * c1[e] + b * s2[e];
        g2[e] = b * c2[e] - a * s1[e];
      }
    }
    bf16* out = dst + map.head(r) * sh + pos * ss;
    store8(out + c, g1);
    store8(out + c + HALF, g2);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This batch's [S, D] rope table, or nullptr without rope.
__device__ __forceinline__ const bf16* table(const bf16* t, int b, int S) {
  return t ? t + (long long)b * S * D : nullptr;
}

// ------------------------------------------------------------------ dq
constexpr size_t DQ_SMEM = (4 * TILE_H + TILE_P) * sizeof(bf16) +
                           (2 * TILE_S + 2 * 64) * sizeof(float);

// dq of one 64-row query tile (rows by `map`, batch b) against kv head
// kvh: recompute S = Q K^T and dP = dO V^T per live kv tile, form
// dS = P * (dP - delta) and accumulate dQ += dS K in registers; the
// epilogue scales, un-ropes (with tables) and writes the rows in bf16.
__device__ __forceinline__ void dq_tile(unsigned char* smem, const AttnArgs& a,
                                        RowMap map, int kvh, int b) {
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + TILE_H;
  bf16* sK = sdO + TILE_H;
  bf16* sV = sK + TILE_H;
  float* sS = reinterpret_cast<float*>(sV + TILE_H);
  float* sdP = sS + TILE_S;
  float* sLse = sdP + TILE_S;
  float* sDelta = sLse + 64;
  bf16* sdS = reinterpret_cast<bf16*>(sDelta + 64);

  const Mask& m = a.mask;
  const bf16* k = a.k.ptr + b * a.k.sb + kvh * a.k.sh;
  const bf16* v = a.v.ptr + b * a.v.sb + kvh * a.v.sh;
  const bf16* cos = table(a.cos, b, m.q_len);
  const bf16* sin = table(a.sin, b, m.q_len);

  load_rows(sQ, a.q.ptr + b * a.q.sb, a.q.sh, a.q.ss, map, m.q_len, cos, sin);
  load_rows(sdO, a.dout.ptr + b * a.dout.sb, a.dout.sh, a.dout.ss, map, m.q_len, nullptr,
            nullptr);
  if (threadIdx.x < 64) {
    const int r = threadIdx.x, pos = map.pos(r);
    const long long i = ((long long)b * a.H + map.head(r)) * m.q_len + pos;
    sLse[r] = pos < m.q_len ? a.lse_in[i] : 0.f;
    sDelta[r] = pos < m.q_len ? a.delta[i] : 0.f;
  }

  FragC acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);

  const TileRange tiles =
      kv_tiles(m, map.pos0, min(map.pos0 + (1 << map.shift), m.q_len) - 1);
  const int n = tiles.count();
  for (int t = 0; t < n; ++t) {
    const int k0 = tiles.tile(t) * BK;
    __syncthreads();
    load_rows(sK, k, 0, a.k.ss, RowMap{k0, 6, 0}, m.kv_len, cos, sin);
    load_rows(sV, v, 0, a.v.ss, RowMap{k0, 6, 0}, m.kv_len, nullptr, nullptr);
    __syncthreads();
    mm_abt(sS, sQ, sK);    // S  = Q K^T
    mm_abt(sdP, sdO, sV);  // dP = dO V^T
    __syncthreads();
    // this thread's key column is the same at every step of the loop
    const Rows rows = rows_of(m, k0 + threadIdx.x % BK, k0 + threadIdx.x % BK);
    for (int idx = threadIdx.x; idx < BQ * BK; idx += NTHREADS) {
      const int r = idx / BK, c = idx % BK;
      float ds = 0.f;
      if (rows.has(map.pos(r))) {
        const float p = __expf(sS[r * LD_S + c] * a.scale - sLse[r]);
        ds = p * (sdP[r * LD_S + c] - sDelta[r]);
      }
      sdS[r * LD_P + c] = __float2bfloat16(ds);
    }
    __syncthreads();
    mm_ab_acc(acc, sdS, sK);  // dQ += dS K
  }
  __syncthreads();
  float* sOut = reinterpret_cast<float*>(smem);  // reuses sQ + sdO
  store_acc(sOut, acc);
  __syncthreads();
  write_rows(static_cast<bf16*>(a.dq.ptr) + b * a.dq.sb, a.dq.sh, a.dq.ss, sOut, a.scale, map,
             m.q_len, cos, sin);
}

// ---------------------------------------------------------- host side
typedef void (*AttnKernel)(AttnArgs);

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
  a.shift = 6;
  a.mask = Mask{q_len, kv_len, causal, causal ? window : 0, causal ? prefix : 0,
                kv_len - q_len};
  a.scale = scale;
  return a;
}

// Strides (elements) of a contiguous [B, heads, S, D] and [B, S, heads *
// D] output.
inline Out out_bhsd(void* p, int heads, int S) {
  return Out{p, (long long)heads * S * D, (long long)S * D, D};
}

inline Out out_bshd(void* p, int heads, int S) {
  return Out{p, (long long)S * heads * D, D, (long long)heads * D};
}

// log2 of the query positions per tile when `group` q heads share a
// tile (64 / group), or -1 when group is not a power of two up to 64.
inline int pack_shift(int group) {
  int shift = 6;
  for (int g = group; g > 1; g >>= 1) {
    if (g & 1) return -1;
    --shift;
  }
  return shift;
}

// Raise the kernel's dynamic shared-memory limit, launch it on `stream`
// and return the launch's error (0 when it was accepted).
inline int launch(AttnKernel kernel, dim3 grid, size_t smem, void* stream,
                  const AttnArgs& a) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace fa

// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): tile geometry, tile loads with in-kernel rope, and the
// two warp-level products every kernel is built from.
//
// Layout: q/k/v/do are [B, heads, S, D] bf16 addressed through batch,
// head and row strides (elements); each row of D values is contiguous and
// 16-byte aligned (the Python wrapper checks). Rope tables are [B, S, D]
// bf16, contiguous, full width (the first-half values repeated in the
// second half). lse and delta are f32 [B, H, S].
//
// Tiles: 64 rows x D=128 columns, staged in shared memory; the products
// run on the tensor cores through WMMA (bf16 in, f32 accumulate, 16x16x16
// fragments). Eight warps per block; warp w owns the 16-row group
// (w & 3) and the column half (w >> 2) of every product it computes.
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
constexpr int TILE_O = 64 * LD_O;
constexpr float NEG_INF = -1e30f;

// One [B, heads, S, D] operand: base pointer and element strides.
struct Operand {
  const bf16* ptr;
  long long sb, sh, ss;
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

// Copy rows [row0, row0 + 64) of one head (src = head base, row stride
// ss) into dst [64][LD_H]; rows at or past `len` become zeros. With rope
// tables (cos/sin = this batch's [S, D] base) the tile is stored roped:
// rope(x) = x * C + rotate_half(x) * S with rotate_half(x) = [-x2, x1],
// computed in f32 and rounded once to bf16.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ss,
                                          int row0, int len, const bf16* cos,
                                          const bf16* sin) {
  if (cos == nullptr) {
    for (int idx = threadIdx.x; idx < 64 * (D / 8); idx += NTHREADS) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const int row = row0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < len) val = ld16(src + row * ss + c);
      *reinterpret_cast<uint4*>(dst + r * LD_H + c) = val;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < 64 * (HALF / 8); idx += NTHREADS) {
    const int r = idx / (HALF / 8), c = (idx % (HALF / 8)) * 8;
    const int row = row0 + r;
    float o1[8], o2[8];
    if (row < len) {
      float x1[8], x2[8], c1[8], c2[8], s1[8], s2[8];
      const bf16* x = src + row * ss;
      const long long t = (long long)row * D;
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

// Move the [64][D] accumulator fragments to or from f32 shared memory.
__device__ __forceinline__ void store_acc(float* dst, FragC (&acc)[4]) {
  const int warp = threadIdx.x / 32, rg = warp & 3, ch = warp >> 2;
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(dst + rg * 16 * LD_O + ch * 64 + n * 16, acc[n], LD_O,
                            wmma::mem_row_major);
}

__device__ __forceinline__ void load_acc(FragC (&acc)[4], const float* src) {
  const int warp = threadIdx.x / 32, rg = warp & 3, ch = warp >> 2;
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::load_matrix_sync(acc[n], src + rg * 16 * LD_O + ch * 64 + n * 16, LD_O,
                           wmma::mem_row_major);
}

// Whether key position `col` is visible from query position `row`.
// Causality is end-aligned (offset = kv_len - q_len), as in the JAX
// kernels' _block_mask; columns past kv_len are never visible.
__device__ __forceinline__ bool visible(int row, int col, int q_len, int kv_len,
                                        int causal) {
  return col < kv_len && row < q_len && (!causal || col <= row + kv_len - q_len);
}

// Write a [64][LD_O] f32 tile scaled by `scale` to dst rows [row0, len)
// (contiguous [S, D] head base), un-roping first when tables are given:
// unrope(g) = [g1*c1 + g2*s2, g2*c2 - g1*s1], the transpose of rope.
__device__ __forceinline__ void write_rows(bf16* dst, const float* src, float scale,
                                           int row0, int len, const bf16* cos,
                                           const bf16* sin) {
  for (int idx = threadIdx.x; idx < 64 * (HALF / 8); idx += NTHREADS) {
    const int r = idx / (HALF / 8), c = (idx % (HALF / 8)) * 8;
    const int row = row0 + r;
    if (row >= len) continue;
    float g1[8], g2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g1[e] = src[r * LD_O + c + e] * scale;
      g2[e] = src[r * LD_O + c + HALF + e] * scale;
    }
    if (cos != nullptr) {
      float c1[8], c2[8], s1[8], s2[8];
      const long long t = (long long)row * D;
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
    *reinterpret_cast<uint4*>(dst + (long long)row * D + c) = pack8(g1);
    *reinterpret_cast<uint4*>(dst + (long long)row * D + c + HALF) = pack8(g2);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace fa

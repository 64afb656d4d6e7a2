// The backward tile loops of K3 (flash_bwd_dq) and K4 (flash_bwd_dkv) for
// Hopper: TMA loads, wgmma products, and P and dS formed in registers.
// The ring's K13 and K14 (flash_ring.cu) run K3's and K4's loops with
// the ring's mask and an f32 epilogue; K10 and K11 (flash_heads.cu) run
// them on [B, S, heads*D] views, with K3's and K4's bf16 epilogues. The
// visibility rule (Mask, keys_of, rows_of, kv_tiles, sees_all) is
// flash_common.cuh's, shared by every loop.
//
// What bounds them on the H100: tensor-core operations. At the slice's
// shape (B8 H8 S2048 D128, causal) K3's three products are 103 GFLOP
// (0.10 ms at 989 TFLOP/s) and K4's four 137 GFLOP (0.14 ms), against
// ~50 MB of operands. The first WMMA loops reached 6-7% of that:
// synchronous staging through registers with rope applied per element on
// every tile visit (K4 re-roped each q tile once per kv block that sees
// it), S, dP, P and dS through shared memory, and WMMA fragments
// reloaded from shared memory on every 16-wide step.
//
// What these loops do about it:
// - Warp specialisation, as the forward (flash_fwd_sm90.cuh). A block
//   owns 128 rows, 64 per consumer warpgroup: K3 128 query rows of one q
//   head, K4 128 key rows of one kv head. The rows' two operands (K3: q
//   and do; K4: k and v) are loaded once by TMA and stay in shared
//   memory. A producer warpgroup (setmaxnreg low) streams the other two
//   operands in 64-row tiles through a ring of STAGES slots guarded by
//   full/empty mbarriers: K3 the live k/v tiles of its kv head, K4 the
//   (q, do) tiles of every q head of its GQA group over the query rows
//   that see the block, with each tile's lse (log2 units) and delta,
//   which a second producer warp loads into the slot beside it.
// - Products on wgmma. The score tiles (K3: S = Q K^T and dP = dO V^T;
//   K4: S^T = K Q^T and dP^T = V dO^T) are m64n64k16 with both operands
//   K-major in shared memory, so no transposed copy is made. P and dS
//   are formed in registers from the f32 accumulators, rounded to bf16
//   pairs, and that is already the register layout of wgmma's A operand:
//   dQ += dS K, dV += P^T dO and dK += dS^T Q are m64n128k16 with A in
//   registers and the streamed tile read MN-major through the B
//   operand's transpose flag. No S, P or dS tile goes to shared memory.
// - Accumulators stay in registers across the loop: K3's dQ (64 f32 a
//   thread), K4's dK and dV (64 + 64), where the sum over the GQA group
//   happens, so dk/dv come out at kv-head width. Each output element is
//   written by one block: deterministic, no atomics.
// - Overlap. K3 starts tile t's S, tile t-1's dQ product and tile t's
//   dP back to back and forms P while the last two run; tile 0 is
//   peeled off so that the loop body is the same on every pass (with the
//   overlap behind branches ptxas serialises every wgmma, warning
//   C7514). K4, short of registers for that (dK, dV, S^T, dP^T live
//   together), forms P while dP^T runs.
// - Masks: only the tiles the mask leaves live are loaded (kv_tiles for
//   K3, rows_of for K4), and the per-element mask runs only on tiles
//   that some row or key does not wholly see (sees_all). A row that sees
//   no key gets dq = 0; a key that no row sees gets dk = dv = 0. Rows
//   past q_len take lse = +inf, so their P is 0.
// - Order: chunks of CHUNK (batch, head) pairs, so a chunk's operands
//   stay in L2; within a chunk the longest blocks start first (under
//   causality K3's last q tiles and K4's first kv tiles).
// - Rope: q and k arrive roped, from the pre-pass flash_fwd_rope_k run
//   once per call (TMA cannot rope on the fly); the epilogues apply the
//   transpose of rope to dq and dk with the same tables, scale them, and
//   stage each consumer's rows through its own rows of the resident tile
//   for 16-byte row stores.
// - The ring's f32 outputs, K13's dq and K14's dk and dv (the ring sums
//   up to n of them per shard), leave the accumulators as float2 pairs,
//   with no staging and no consumer sync: each warp-wide store covers 32
//   whole bytes of 8 rows. Staging K14's one at a time through the
//   consumer's rows of the resident tiles for 16-byte row stores
//   measured 3-9% slower at the ring's block shape (H100 80GB HBM3,
//   700 W; kernel_ab.py). Both loops are templated on the output type,
//   so K3's and K4's bf16 epilogues are unchanged.
// - K10 and K11 read [B, S, heads*D] operands through the same 4-D tensor
//   maps as K3 and K4 read [B, H, S, D] ones: the maps take (batch, head,
//   row) strides, here (S*heads*D, D, heads*D), so the loops are K3's and
//   K4's unchanged.
#pragma once

#include <type_traits>

#include "sm90_common.cuh"

namespace fa {
namespace sm90 {
namespace bwd {

constexpr int BM = 128;       // rows a block owns: q (K3), kv (K4); 64 per consumer
constexpr int BN = 64;        // rows of a streamed tile: kv (K3), q (K4)
constexpr int STAGES = 3;     // streamed tiles in flight
constexpr int THREADS = 384;  // producer warpgroup + two consumers
constexpr int OWN_BOX = BM * BOX_COLS * 2;     // 16 KB: 128 rows x 64 columns
constexpr int OWN_BYTES = 2 * OWN_BOX;         // 32 KB: 128 rows x D
constexpr int STREAM_BOX = BN * BOX_COLS * 2;  // 8 KB: 64 rows x 64 columns
constexpr int STREAM_BYTES = 2 * STREAM_BOX;   // 16 KB: 64 rows x D
constexpr int CHUNK = 16;     // (batch, head) pairs per chunk of the order
constexpr size_t SMEM = 1024 + 2 * OWN_BYTES + 2 * STAGES * STREAM_BYTES +
                        2 * STAGES * BN * sizeof(float) + (1 + 2 * STAGES) * 8;

// The tensor maps of q, k, v and do and the shared arguments; passed as a
// __grid_constant__ kernel parameter, where TMA reads the maps.
struct BwdParams {
  CUtensorMap q, k, v, dout;
  AttnArgs a;
  int n_bh;  // (batch, head) pairs of the grid: B * H (K3), B * KVH (K4)
  int nt;    // 128-row tiles per pair: of q (K3), of kv (K4)
};

// The block's shared memory: the two resident 128-row tiles (K3: Q, dO;
// K4: K, V), STAGES slots of the two streamed 64-row tiles (K3: K, V;
// K4: Q, dO), K4's per-slot lse and delta rows, and the barriers (the
// resident tiles'; full and empty per slot).
struct Smem {
  unsigned char* own[2];
  unsigned char* str[2];
  float* lse;
  float* delta;
  uint64_t *bar_own, *full, *empty;

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    own[0] = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    own[1] = own[0] + OWN_BYTES;
    str[0] = own[1] + OWN_BYTES;
    str[1] = str[0] + STAGES * STREAM_BYTES;
    lse = reinterpret_cast<float*>(str[1] + STAGES * STREAM_BYTES);
    delta = lse + STAGES * BN;
    bar_own = reinterpret_cast<uint64_t*>(delta + STAGES * BN);
    full = bar_own + 1;
    empty = full + STAGES;
  }
};

// The block's (batch, head) pair and 128-row tile (see "Order" at the
// top): tiles from the last to the first (K3) or the first to the last
// (K4).
__device__ __forceinline__ void block_tile(const BwdParams& p, bool last_first, int& bh,
                                           int& ti) {
  const int per = CHUNK * p.nt;
  const int chunk = blockIdx.x / per, r = blockIdx.x % per;
  const int width = min(CHUNK, p.n_bh - chunk * CHUNK);
  bh = chunk * CHUNK + r % width;
  ti = last_first ? p.nt - 1 - r / width : r / width;
}

// d[64 x 64] = A[64 x D] . B[64 x D]^T: A a consumer's 64 rows of a
// resident tile, B a streamed tile, both K-major: 8 steps of 16 columns,
// 4 in each 64-column box (32 bytes apart in the swizzled rows).
__device__ __forceinline__ void mma_scores(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss64(d, desc(a + (kk / 4) * OWN_BOX + col, 16, 1024),
               desc(b + (kk / 4) * STREAM_BOX + col, 16, 1024), kk > 0);
  }
}

// acc[64 x D] += A[64 x 64] . B[64 x D]: A in registers (a score tile's
// f32 layout in bf16 pairs; step kk is a[4kk..4kk+3]), B a streamed tile
// read MN-major: 4 steps of 16 rows (2048 bytes), LBO from its first
// 64-column box to the second, SBO between groups of 8 rows.
__device__ __forceinline__ void mma_acc(float (&acc)[64], const uint32_t (&a)[16], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs(acc, a + 4 * kk, desc(b + kk * 2048, STREAM_BOX, 1024));
}

// A score tile's layout: s[4j + e] is row 16 * warp + lane / 4 + 8 * (e >>
// 1) against column 8j + 2 * quad + (e & 1).

// K3's P = exp(S * scale - lse) in place, in log2 units (sl2 = scale *
// log2 e, lse2 = lse * log2 e per row half), with the keys a row does not
// see masked to 0 first (only when `masked`).
__device__ __forceinline__ void probs_by_row(float (&s)[32], const Keys (&keys)[2], int k0,
                                             int quad, bool masked, float sl2,
                                             const float (&lse2)[2]) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!keys[e >> 1].has(k0 + 8 * j + 2 * quad + (e & 1))) s[4 * j + e] = -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], sl2, -lse2[(i >> 1) & 1]));
}

// K3's dS = P * (dP - delta) as wgmma's A operand (bf16 pairs).
__device__ __forceinline__ void dscores_by_row(uint32_t (&ds)[16], const float (&p)[32],
                                               const float (&dp)[32], const float (&dlt)[2]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    ds[i] = pack_bf16(p[2 * i] * (dp[2 * i] - dlt[i & 1]),
                      p[2 * i + 1] * (dp[2 * i + 1] - dlt[i & 1]));
}

// Scale a consumer's 64 x D accumulator, un-rope it with the tables
// (cos/sin: this batch's [S, D] bases, or nullptr) at positions below
// `len`, round it to bf16 and stage it in rows `row0` and `row0 + 8` of a
// resident tile, in the swizzled layout TMA wrote there. Columns j and
// j + 64 of a row are in the same thread (accumulator steps j and j + 8):
// unrope(g) = [g1*c1 + g2*s2, g2*c2 - g1*s1], the transpose of rope.
__device__ __forceinline__ void stage_rows(unsigned char* tile, const float (&acc)[64],
                                           float scale, int row0, int pos0, int len,
                                           const bf16* cos, const bf16* sin, int quad) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh, pos = pos0 + r;
    const bool rope = cos != nullptr && pos < len;
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      float g1[2], g2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        g1[e] = acc[4 * j + 2 * hh + e] * scale;
        g2[e] = acc[4 * (j + HALF / 8) + 2 * hh + e] * scale;
      }
      if (rope) {
        const long long t = (long long)pos * D + 8 * j + 2 * quad;
        const float2 c1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cos + t));
        const float2 c2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cos + t + HALF));
        const float2 s1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sin + t));
        const float2 s2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sin + t + HALF));
        const float a0 = g1[0], a1 = g1[1], b0 = g2[0], b1 = g2[1];
        g1[0] = a0 * c1.x + b0 * s2.x;
        g1[1] = a1 * c1.y + b1 * s2.y;
        g2[0] = b0 * c2.x - a0 * s1.x;
        g2[1] = b1 * c2.y - a1 * s1.y;
      }
      *reinterpret_cast<uint32_t*>(tile + swz(r, j) + 4 * quad) = pack_bf16(g1[0], g1[1]);
      *reinterpret_cast<uint32_t*>(tile + OWN_BOX + swz(r, j) + 4 * quad) =
          pack_bf16(g2[0], g2[1]);
    }
  }
}

// Write consumer c's 64 staged rows of `tile` to out (this (batch,
// head)'s base, row stride ss) as 16-byte row stores, positions below
// `len` only.
__device__ __forceinline__ void store_rows(bf16* out, long long ss, const unsigned char* tile,
                                           int c, int pos0, int len, int tid) {
  for (int i = tid; i < 64 * 16; i += 128) {
    const int r = 64 * c + i / 16, chunk = i % 16, pos = pos0 + r;
    if (pos >= len) continue;
    *reinterpret_cast<uint4*>(out + pos * ss + chunk * 8) =
        *reinterpret_cast<const uint4*>(tile + (chunk / 8) * OWN_BOX + swz(r, chunk % 8));
  }
}

// Write a consumer's 64 x D f32 accumulator times `scale` to out (this
// (batch, head)'s base, row stride ss) in f32, positions below `len`
// only: float2 pairs straight from the registers, columns 8j + 2 quad
// and + 1 of rows row0 and row0 + 8.
__device__ __forceinline__ void store_pairs(float* out, long long ss, const float (&acc)[64],
                                            float scale, int row0, int pos0, int len,
                                            int quad) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = pos0 + row0 + 8 * hh;
    if (pos >= len) continue;
    float* row = out + pos * ss + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
  }
}

// ------------------------------------------------------------------ K3
// Consumer c of a dq block: query rows pos0 + 64c .. + 63 of head h
// (batch b) against the live kv tiles. Tile t's S, tile t-1's dQ product
// and tile t's dP go out together; P is formed while the last two run.
// dq is written as T: bf16 (K3) or f32 (K13).
template <typename T>
__device__ __forceinline__ void dq_consume(const Smem& sm, const AttnArgs& a, int h, int b,
                                           int pos0, const TileRange& tiles, int c) {
  const Mask& m = a.mask;
  const int n = tiles.count();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row0 = 64 * c + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int r_lo = pos0 + 64 * c, r_hi = r_lo + 63;
  Keys keys[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = pos0 + row0 + 8 * hh;
    const long long i = ((long long)b * a.H + h) * m.q_len + pos;
    keys[hh] = keys_of(m, pos);
    lse2[hh] = pos < m.q_len ? a.lse_in[i] * LOG2E : INFINITY;
    dlt[hh] = pos < m.q_len ? a.delta[i] : 0.f;
  }
  const float sl2 = a.scale * LOG2E;
  const uint32_t q_addr = smem_u32(sm.own[0]) + c * 64 * 128;
  const uint32_t do_addr = smem_u32(sm.own[1]) + c * 64 * 128;
  const uint32_t k_addr = smem_u32(sm.str[0]), v_addr = smem_u32(sm.str[1]);

  float acc[64], s[32], dp[32];
  uint32_t ds[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(sm.bar_own, 0);

  if (n > 0) {  // tile 0: S, dP and dS
    const int k0 = tiles.tile(0) * BN;
    mbar_wait(sm.full, 0);
    wg_fence();
    mma_scores(s, q_addr, k_addr);
    wg_commit();
    mma_scores(dp, do_addr, v_addr);
    wg_commit();
    wg_wait<1>();
    reg_fence(s);
    probs_by_row(s, keys, k0, quad, !sees_all(m, r_lo, r_hi, k0, BN), sl2, lse2);
    wg_wait<0>();
    reg_fence(dp);
    dscores_by_row(ds, s, dp, dlt);
  }
  for (int t = 1; t < n; ++t) {
    const int st = t % STAGES, pst = (t - 1) % STAGES;
    const int k0 = tiles.tile(t) * BN;
    mbar_wait(sm.full + st, (t / STAGES) & 1);
    wg_fence();
    mma_scores(s, q_addr, k_addr + st * STREAM_BYTES);
    wg_commit();
    mma_acc(acc, ds, k_addr + pst * STREAM_BYTES);  // dQ += dS K of tile t-1
    wg_commit();
    mma_scores(dp, do_addr, v_addr + st * STREAM_BYTES);
    wg_commit();
    wg_wait<2>();  // S done
    reg_fence(s);
    probs_by_row(s, keys, k0, quad, !sees_all(m, r_lo, r_hi, k0, BN), sl2, lse2);
    wg_wait<0>();  // tile t-1's dQ product and dP done
    reg_fence(acc);
    reg_fence(dp);
    if (tid == 0) mbar_arrive(sm.empty + pst);
    dscores_by_row(ds, s, dp, dlt);
  }
  if (n > 0) {  // the last tile's dQ product
    const int pst = (n - 1) % STAGES;
    wg_fence();
    mma_acc(acc, ds, k_addr + pst * STREAM_BYTES);
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    if (tid == 0) mbar_arrive(sm.empty + pst);
  }

  if constexpr (std::is_same<T, float>::value) {
    // f32 epilogue (K13, no rope): dq = scale * dQ from registers
    store_pairs(static_cast<float*>(a.dq.ptr) + b * a.dq.sb + h * a.dq.sh, a.dq.ss, acc,
                a.scale, row0, pos0, m.q_len, quad);
  } else {
    // epilogue: dq = scale * unrope(acc) through this consumer's rows of
    // the Q tile
    consumer_sync(c);
    stage_rows(sm.own[0], acc, a.scale, row0, pos0, m.q_len, table(a.cos, b, m.q_len),
               table(a.sin, b, m.q_len), quad);
    consumer_sync(c);
    store_rows(static_cast<bf16*>(a.dq.ptr) + b * a.dq.sb + h * a.dq.sh, a.dq.ss, sm.own[0],
               c, pos0, m.q_len, tid);
  }
}

// dq of one block: 128 query rows of one q head, written as T. Every
// thread calls it.
template <typename T>
__device__ __forceinline__ void dq_block(unsigned char* smem, const BwdParams& p) {
  const AttnArgs& a = p.a;
  int bh, qi;
  block_tile(p, true, bh, qi);
  const int h = bh % a.H, b = bh / a.H, kvh = h / a.group, pos0 = qi * BM;
  const Smem sm(smem);
  const TileRange tiles = kv_tiles<BN>(a.mask, pos0, min(pos0 + BM, a.mask.q_len) - 1);

  if (threadIdx.x == 0) {
    mbar_init(sm.bar_own, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(sm.full + i, 1);
      mbar_init(sm.empty + i, 2);  // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.bar_own, 2 * OWN_BYTES);
      for (int x = 0; x < 2; ++x) {
        tma_load(sm.own[0] + x * OWN_BOX, &p.q, sm.bar_own, x * BOX_COLS, pos0, h, b);
        tma_load(sm.own[1] + x * OWN_BOX, &p.dout, sm.bar_own, x * BOX_COLS, pos0, h, b);
      }
      const int n = tiles.count();
      for (int t = 0; t < n; ++t) {
        const int st = t % STAGES, k0 = tiles.tile(t) * BN;
        mbar_wait(sm.empty + st, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(sm.full + st, 2 * STREAM_BYTES);
        for (int x = 0; x < 2; ++x) {
          const int off = st * STREAM_BYTES + x * STREAM_BOX;
          tma_load(sm.str[0] + off, &p.k, sm.full + st, x * BOX_COLS, k0, kvh, b);
          tma_load(sm.str[1] + off, &p.v, sm.full + st, x * BOX_COLS, k0, kvh, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    dq_consume<T>(sm, a, h, b, pos0, tiles, threadIdx.x / 128 - 1);
  }
}

// ------------------------------------------------------------------ K4
// Consumer c of a dk/dv block: key rows k0 + 64c .. + 63 of kv head kvh
// (batch b) against the n = group * nq streamed (q, do) tiles. P is formed
// while dP^T runs; P^T and dS are packed together once it is done, so
// that S^T, dP^T and the accumulators fit the registers without the
// P^T operand of an earlier product still held. dk and dv are written
// as T: bf16 (K4) or f32 (K14).
template <typename T>
__device__ __forceinline__ void dkv_consume(const Smem& sm, const AttnArgs& a, int kvh, int b,
                                            int k0, int i0, int nq, int c) {
  const Mask& m = a.mask;
  const int n = a.group * nq;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row0 = 64 * c + 16 * warp + lane / 4;  // this thread's keys: row0, row0 + 8
  const int kc0 = k0 + 64 * c;
  // the queries that see each of this thread's keys, fixed for the loop
  const Rows rows[2] = {rows_of(m, k0 + row0, k0 + row0), rows_of(m, k0 + row0 + 8,
                                                                  k0 + row0 + 8)};
  const float sl2 = a.scale * LOG2E;
  const uint32_t k_addr = smem_u32(sm.own[0]) + c * 64 * 128;
  const uint32_t v_addr = smem_u32(sm.own[1]) + c * 64 * 128;
  const uint32_t q_addr = smem_u32(sm.str[0]), do_addr = smem_u32(sm.str[1]);

  float dk[64], dv[64], s[32], dp[32];
  uint32_t pt[16], ds[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(sm.bar_own, 0);

  for (int t = 0; t < n; ++t) {
    const int st = t % STAGES, q0 = (i0 + t % nq) * BN;
    const uint32_t qs = q_addr + st * STREAM_BYTES, dos = do_addr + st * STREAM_BYTES;
    // this thread's query columns' lse (log2 units) and delta: j-th pair
    // at 8j + 2 quad
    const float2* lse2 = reinterpret_cast<const float2*>(sm.lse + st * BN + 2 * quad);
    const float2* dlt = reinterpret_cast<const float2*>(sm.delta + st * BN + 2 * quad);
    mbar_wait(sm.full + st, (t / STAGES) & 1);
    wg_fence();
    mma_scores(s, k_addr, qs);  // S^T = K Q^T   [keys, queries]
    wg_commit();
    mma_scores(dp, v_addr, dos);  // dP^T = V dO^T
    wg_commit();
    wg_wait<1>();
    reg_fence(s);
    if (!sees_all(m, q0, q0 + BN - 1, kc0, 64)) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!rows[e >> 1].has(q0 + 8 * j + 2 * quad + (e & 1))) s[4 * j + e] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 l = lse2[4 * j];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, (e & 1) ? -l.y : -l.x));
    }
    wg_wait<0>();  // dP^T done
    reg_fence(dp);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 d = dlt[4 * (i / 2)];
      pt[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      ds[i] = pack_bf16(s[2 * i] * (dp[2 * i] - d.x), s[2 * i + 1] * (dp[2 * i + 1] - d.y));
    }
    wg_fence();
    mma_acc(dv, pt, dos);  // dV += P^T dO
    mma_acc(dk, ds, qs);   // dK += dS^T Q
    wg_commit();
    wg_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    if (tid == 0) mbar_arrive(sm.empty + st);
  }

  if constexpr (std::is_same<T, float>::value) {
    // f32 epilogue (K14, no rope): dk = scale * dK, dv = dV from registers
    store_pairs(static_cast<float*>(a.dk.ptr) + b * a.dk.sb + kvh * a.dk.sh, a.dk.ss, dk,
                a.scale, row0, k0, m.kv_len, quad);
    store_pairs(static_cast<float*>(a.dv.ptr) + b * a.dv.sb + kvh * a.dv.sh, a.dv.ss, dv, 1.f,
                row0, k0, m.kv_len, quad);
  } else {
    // epilogue: dk = scale * unrope(dK), dv = dV, through this consumer's
    // rows of the K and V tiles
    consumer_sync(c);
    stage_rows(sm.own[0], dk, a.scale, row0, k0, m.kv_len, table(a.cos, b, m.q_len),
               table(a.sin, b, m.q_len), quad);
    stage_rows(sm.own[1], dv, 1.f, row0, k0, m.kv_len, nullptr, nullptr, quad);
    consumer_sync(c);
    store_rows(static_cast<bf16*>(a.dk.ptr) + b * a.dk.sb + kvh * a.dk.sh, a.dk.ss, sm.own[0],
               c, k0, m.kv_len, tid);
    store_rows(static_cast<bf16*>(a.dv.ptr) + b * a.dv.sb + kvh * a.dv.sh, a.dv.ss, sm.own[1],
               c, k0, m.kv_len, tid);
  }
}

// dk and dv of one block: 128 key rows of one kv head, written as T.
// Every thread calls it.
template <typename T>
__device__ __forceinline__ void dkv_block(unsigned char* smem, const BwdParams& p) {
  const AttnArgs& a = p.a;
  const Mask& m = a.mask;
  int bh, ki;
  block_tile(p, false, bh, ki);
  const int KVH = a.H / a.group, kvh = bh % KVH, b = bh / KVH, k0 = ki * BM;
  const Smem sm(smem);
  // the 64-row q tiles [i0, i0 + nq) that see some key of the block
  const Rows live = rows_of(m, k0, min(k0 + BM, m.kv_len) - 1);
  const int i0 = live.lo / BN, nq = live.lo <= live.hi ? live.hi / BN + 1 - i0 : 0;
  const int n = a.group * nq;

  if (threadIdx.x == 0) {
    mbar_init(sm.bar_own, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(sm.full + i, 1 + 32);  // the TMA thread and the lse/delta warp
      mbar_init(sm.empty + i, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: thread 0 starts every TMA load; warp 1 copies each tile's
    // lse (in log2 units, +inf past q_len) and delta into its slot
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.bar_own, 2 * OWN_BYTES);
      for (int x = 0; x < 2; ++x) {
        tma_load(sm.own[0] + x * OWN_BOX, &p.k, sm.bar_own, x * BOX_COLS, k0, kvh, b);
        tma_load(sm.own[1] + x * OWN_BOX, &p.v, sm.bar_own, x * BOX_COLS, k0, kvh, b);
      }
      for (int t = 0; t < n; ++t) {
        const int st = t % STAGES, g = t / nq, q0 = (i0 + t - g * nq) * BN;
        const int h = kvh * a.group + g;
        mbar_wait(sm.empty + st, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(sm.full + st, 2 * STREAM_BYTES);
        for (int x = 0; x < 2; ++x) {
          const int off = st * STREAM_BYTES + x * STREAM_BOX;
          tma_load(sm.str[0] + off, &p.q, sm.full + st, x * BOX_COLS, q0, h, b);
          tma_load(sm.str[1] + off, &p.dout, sm.full + st, x * BOX_COLS, q0, h, b);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      for (int t = 0; t < n; ++t) {
        const int st = t % STAGES, g = t / nq, q0 = (i0 + t - g * nq) * BN;
        const long long base = ((long long)b * a.H + kvh * a.group + g) * m.q_len;
        mbar_wait(sm.empty + st, ((t / STAGES) & 1) ^ 1);
        for (int r = lane; r < BN; r += 32) {
          const int q = q0 + r;
          sm.lse[st * BN + r] = q < m.q_len ? a.lse_in[base + q] * LOG2E : INFINITY;
          sm.delta[st * BN + r] = q < m.q_len ? a.delta[base + q] : 0.f;
        }
        mbar_arrive(sm.full + st);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    dkv_consume<T>(sm, a, kvh, b, k0, i0, nq, threadIdx.x / 128 - 1);
  }
}

// ------------------------------------------------------------ host side
// Build the maps of p.a's q, do (boxes of 64 rows for K4, 128 for K3) and
// k, v (128 rows for K4, 64 for K3), raise the kernel's shared-memory
// limit and launch it over n_bh * nt blocks; `kv_major` picks K4's grid
// (B * KVH pairs, kv tiles) over K3's (B * H, q tiles). Returns the
// launch's error, or cudaErrorInvalidValue when a map is refused.
inline int launch_bwd(void (*kernel)(BwdParams), BwdParams& p, int B, int KVH, bool kv_major,
                      void* stream) {
  const AttnArgs& a = p.a;
  const int q_rows = kv_major ? BN : BM, kv_rows = kv_major ? BM : BN;
  const int q_len = a.mask.q_len, kv_len = a.mask.kv_len;
  if (!tile_map(&p.q, a.q.ptr, B, a.H, q_len, a.q.sb, a.q.sh, a.q.ss, q_rows, 1) ||
      !tile_map(&p.dout, a.dout.ptr, B, a.H, q_len, a.dout.sb, a.dout.sh, a.dout.ss, q_rows,
                1) ||
      !tile_map(&p.k, a.k.ptr, B, KVH, kv_len, a.k.sb, a.k.sh, a.k.ss, kv_rows, 1) ||
      !tile_map(&p.v, a.v.ptr, B, KVH, kv_len, a.v.sb, a.v.sh, a.v.ss, kv_rows, 1))
    return (int)cudaErrorInvalidValue;
  p.nt = ((kv_major ? kv_len : q_len) + BM - 1) / BM;
  p.n_bh = B * (kv_major ? KVH : a.H);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.n_bh * p.nt, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace sm90
}  // namespace fa

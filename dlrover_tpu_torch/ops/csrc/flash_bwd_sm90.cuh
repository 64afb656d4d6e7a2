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
//   C7514). K4 at D = 128, short of registers for that (dK, dV, S^T,
//   dP^T live together), forms P while dP^T runs; at D = 64, where dK
//   and dV take half the registers, it runs K3's overlap
//   (dkv_consume_d64), its two consumers taking turns at the tensor
//   cores.
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
// - Head width: the tile bytes and TMA boxes, the score products' D / 16
//   steps, the accumulators (m64nDk16: D / 2 floats a thread each) and the
//   epilogues are templated on D (64 or 128); the score tiles (m64n64),
//   P and dS do not depend on it. K3 and K4 are built for both, K10, K11,
//   K13 and K14 for D = 128. K3's and K4's D = 64 builds run loops of
//   their own (dq_blocks_d64, dkv_blocks_d64: persistent blocks, consumer
//   turns); K10, K11, K13 and K14 run dq_block and dkv_block at D = 128
//   only.
// - K10 and K11 read [B, S, heads*D] operands through the same 4-D tensor
//   maps as K3 and K4 read [B, H, S, D] ones: the maps take (batch, head,
//   row) strides, here (S*heads*D, D, heads*D), so the loops are K3's and
//   K4's unchanged.
#pragma once

#include <atomic>
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
constexpr int STREAM_BOX = BN * BOX_COLS * 2;  // 8 KB: 64 rows x 64 columns
constexpr int CHUNK = 16;     // (batch, head) pairs per chunk of the order

// The sizes that follow the head width.
template <int D>
struct Bwd {
  static constexpr int OWN_BYTES = Row<D>::BOXES * OWN_BOX;        // 128 rows x D
  static constexpr int STREAM_BYTES = Row<D>::BOXES * STREAM_BOX;  // 64 rows x D
  static constexpr size_t SMEM = 1024 + 2 * OWN_BYTES + 2 * STAGES * STREAM_BYTES +
                                 2 * STAGES * BN * sizeof(float) + (1 + 2 * STAGES) * 8;
};

// The tensor maps of q, k, v and do and the shared arguments; passed as a
// __grid_constant__ kernel parameter, where TMA reads the maps.
struct BwdParams {
  CUtensorMap q, k, v, dout;
  AttnArgs a;
  int n_bh;  // (batch, head) pairs of the grid: B * H (K3), B * KVH (K4)
  int nt;    // 128-row tiles per pair: of q (K3), of kv (K4)
  int slot;  // K3 and K4 at D = 64: the launch's work counter (next_work)
  CUtensorMap dq;  // K3 at D = 64: dq's map, for its TMA stores
};

// The block's shared memory: the two resident 128-row tiles (K3: Q, dO;
// K4: K, V), STAGES slots of the two streamed 64-row tiles (K3: K, V;
// K4: Q, dO), K4's per-slot lse and delta rows, and the barriers (the
// resident tiles'; full and empty per slot).
template <int D>
struct Smem {
  unsigned char* own[2];
  unsigned char* str[2];
  float* lse;
  float* delta;
  uint64_t *bar_own, *full, *empty;

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    own[0] = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    own[1] = own[0] + Bwd<D>::OWN_BYTES;
    str[0] = own[1] + Bwd<D>::OWN_BYTES;
    str[1] = str[0] + STAGES * Bwd<D>::STREAM_BYTES;
    lse = reinterpret_cast<float*>(str[1] + STAGES * Bwd<D>::STREAM_BYTES);
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
// resident tile, B a streamed tile, both K-major: D / 16 steps of 16
// columns, 4 in each 64-column box (32 bytes apart in the swizzled rows).
template <int D>
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
// 64-column box to the second (D = 128), SBO between groups of 8 rows.
template <int D>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 2], const uint32_t (&a)[16],
                                        uint32_t b) {
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
// resident tile, in the swizzled layout TMA wrote there. Columns c and
// c + D / 2 of a row are in the same thread (accumulator steps j and
// j + D / 16): unrope(g) = [g1*c1 + g2*s2, g2*c2 - g1*s1], the transpose
// of rope.
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char* tile, const float (&acc)[D / 2],
                                           float scale, int row0, int pos0, int len,
                                           const bf16* cos, const bf16* sin, int quad) {
  constexpr int HALF = Row<D>::HALF;
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
      // column 8 j + 2 quad of the first half and its partner D / 2 on:
      // chunk j of the second box (D = 128), chunk j + 4 of the one (D = 64)
      *reinterpret_cast<uint32_t*>(tile + swz(r, j) + 4 * quad) = pack_bf16(g1[0], g1[1]);
      *reinterpret_cast<uint32_t*>(tile + (HALF / BOX_COLS) * OWN_BOX +
                                   swz(r, j + (HALF / 8) % 8) + 4 * quad) =
          pack_bf16(g2[0], g2[1]);
    }
  }
}

// Write consumer c's 64 staged rows of `tile` to out (this (batch,
// head)'s base, row stride ss) as 16-byte row stores, positions below
// `len` only.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long ss, const unsigned char* tile,
                                           int c, int pos0, int len, int tid) {
  for (int i = tid; i < 64 * (D / 8); i += 128) {
    const int r = 64 * c + i / (D / 8), chunk = i % (D / 8), pos = pos0 + r;
    if (pos >= len) continue;
    *reinterpret_cast<uint4*>(out + pos * ss + chunk * 8) =
        *reinterpret_cast<const uint4*>(tile + (chunk / 8) * OWN_BOX + swz(r, chunk % 8));
  }
}

// Write a consumer's 64 x D f32 accumulator times `scale` to out (this
// (batch, head)'s base, row stride ss) in f32, positions below `len`
// only: float2 pairs straight from the registers, columns 8j + 2 quad
// and + 1 of rows row0 and row0 + 8.
template <int D>
__device__ __forceinline__ void store_pairs(float* out, long long ss, const float (&acc)[D / 2],
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
template <typename T, int D>
__device__ __forceinline__ void dq_consume(const Smem<D>& sm, const AttnArgs& a, int h, int b,
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

  constexpr int STREAM_BYTES = Bwd<D>::STREAM_BYTES;
  float acc[D / 2], s[32], dp[32];
  uint32_t ds[16];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(sm.bar_own, 0);

  if (n > 0) {  // tile 0: S, dP and dS
    const int k0 = tiles.tile(0) * BN;
    mbar_wait(sm.full, 0);
    wg_fence();
    mma_scores<D>(s, q_addr, k_addr);
    wg_commit();
    mma_scores<D>(dp, do_addr, v_addr);
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
    mma_scores<D>(s, q_addr, k_addr + st * STREAM_BYTES);
    wg_commit();
    mma_acc<D>(acc, ds, k_addr + pst * STREAM_BYTES);  // dQ += dS K of tile t-1
    wg_commit();
    mma_scores<D>(dp, do_addr, v_addr + st * STREAM_BYTES);
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
    mma_acc<D>(acc, ds, k_addr + pst * STREAM_BYTES);
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    if (tid == 0) mbar_arrive(sm.empty + pst);
  }

  if constexpr (std::is_same<T, float>::value) {
    // f32 epilogue (K13, no rope): dq = scale * dQ from registers
    store_pairs<D>(static_cast<float*>(a.dq.ptr) + b * a.dq.sb + h * a.dq.sh, a.dq.ss, acc,
                a.scale, row0, pos0, m.q_len, quad);
  } else {
    // epilogue: dq = scale * unrope(acc) through this consumer's rows of
    // the Q tile
    consumer_sync(c);
    stage_rows<D>(sm.own[0], acc, a.scale, row0, pos0, m.q_len, table<D>(a.cos, b, m.q_len),
                  table<D>(a.sin, b, m.q_len), quad);
    consumer_sync(c);
    store_rows<D>(static_cast<bf16*>(a.dq.ptr) + b * a.dq.sb + h * a.dq.sh, a.dq.ss, sm.own[0],
               c, pos0, m.q_len, tid);
  }
}

// dq of one block: 128 query rows of one q head, written as T. Every
// thread calls it.
template <typename T, int D>
__device__ __forceinline__ void dq_block(unsigned char* smem, const BwdParams& p) {
  constexpr int OWN_BYTES = Bwd<D>::OWN_BYTES, STREAM_BYTES = Bwd<D>::STREAM_BYTES;
  const AttnArgs& a = p.a;
  int bh, qi;
  block_tile(p, true, bh, qi);
  const int h = bh % a.H, b = bh / a.H, kvh = h / a.group, pos0 = qi * BM;
  const Smem<D> sm(smem);
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
      for (int x = 0; x < Row<D>::BOXES; ++x) {
        tma_load(sm.own[0] + x * OWN_BOX, &p.q, sm.bar_own, x * BOX_COLS, pos0, h, b);
        tma_load(sm.own[1] + x * OWN_BOX, &p.dout, sm.bar_own, x * BOX_COLS, pos0, h, b);
      }
      const int n = tiles.count();
      for (int t = 0; t < n; ++t) {
        const int st = t % STAGES, k0 = tiles.tile(t) * BN;
        mbar_wait(sm.empty + st, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(sm.full + st, 2 * STREAM_BYTES);
        for (int x = 0; x < Row<D>::BOXES; ++x) {
          const int off = st * STREAM_BYTES + x * STREAM_BOX;
          tma_load(sm.str[0] + off, &p.k, sm.full + st, x * BOX_COLS, k0, kvh, b);
          tma_load(sm.str[1] + off, &p.v, sm.full + st, x * BOX_COLS, k0, kvh, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    dq_consume<T, D>(sm, a, h, b, pos0, tiles, threadIdx.x / 128 - 1);
  }
}

// ------------------------------------------------------------------ K4
// Consumer c of a dk/dv block: key rows k0 + 64c .. + 63 of kv head kvh
// (batch b) against the n = group * nq streamed (q, do) tiles. P is formed
// while dP^T runs; P^T and dS are packed together once it is done, so
// that S^T, dP^T and the accumulators fit the registers without the
// P^T operand of an earlier product still held. dk and dv are written
// as T: bf16 (K4) or f32 (K14).
template <typename T, int D>
__device__ __forceinline__ void dkv_consume(const Smem<D>& sm, const AttnArgs& a, int kvh, int b,
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

  constexpr int STREAM_BYTES = Bwd<D>::STREAM_BYTES;
  float dk[D / 2], dv[D / 2], s[32], dp[32];
  uint32_t pt[16], ds[16];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
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
    mma_scores<D>(s, k_addr, qs);  // S^T = K Q^T   [keys, queries]
    wg_commit();
    mma_scores<D>(dp, v_addr, dos);  // dP^T = V dO^T
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
    mma_acc<D>(dv, pt, dos);  // dV += P^T dO
    mma_acc<D>(dk, ds, qs);   // dK += dS^T Q
    wg_commit();
    wg_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    if (tid == 0) mbar_arrive(sm.empty + st);
  }

  if constexpr (std::is_same<T, float>::value) {
    // f32 epilogue (K14, no rope): dk = scale * dK, dv = dV from registers
    store_pairs<D>(static_cast<float*>(a.dk.ptr) + b * a.dk.sb + kvh * a.dk.sh, a.dk.ss, dk,
                   a.scale, row0, k0, m.kv_len, quad);
    store_pairs<D>(static_cast<float*>(a.dv.ptr) + b * a.dv.sb + kvh * a.dv.sh, a.dv.ss, dv,
                   1.f, row0, k0, m.kv_len, quad);
  } else {
    // epilogue: dk = scale * unrope(dK), dv = dV, through this consumer's
    // rows of the K and V tiles
    consumer_sync(c);
    stage_rows<D>(sm.own[0], dk, a.scale, row0, k0, m.kv_len, table<D>(a.cos, b, m.q_len),
                  table<D>(a.sin, b, m.q_len), quad);
    stage_rows<D>(sm.own[1], dv, 1.f, row0, k0, m.kv_len, nullptr, nullptr, quad);
    consumer_sync(c);
    store_rows<D>(static_cast<bf16*>(a.dk.ptr) + b * a.dk.sb + kvh * a.dk.sh, a.dk.ss,
                  sm.own[0], c, k0, m.kv_len, tid);
    store_rows<D>(static_cast<bf16*>(a.dv.ptr) + b * a.dv.sb + kvh * a.dv.sh, a.dv.ss,
                  sm.own[1], c, k0, m.kv_len, tid);
  }
}

// K4's P^T = exp(S^T * scale - lse) in place for the streamed tile of
// queries q0.., with the queries a key does not see masked to 0 first
// (only when `masked`: each query's offset c = 8j + (e & 1), a constant,
// against the key's bounds less q0 + 2 quad, with no branch); `lse` is
// the tile's lse row, the j-th pair of this thread's query columns at
// 8j + 2 quad.
__device__ __forceinline__ void probs_by_col(float (&s)[32], const Rows (&rows)[2], int q0,
                                             int quad, bool masked, float sl2,
                                             const float* lse) {
  if (masked) {
    const int base = q0 + 2 * quad;
    const int lo[2] = {rows[0].lo - base, rows[1].lo - base};
    const int hi[2] = {rows[0].hi - base, rows[1].hi - base};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + (e & 1), h = e >> 1;
        s[4 * j + e] = (c >= lo[h]) & (c <= hi[h]) ? s[4 * j + e] : -INFINITY;
      }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 l = reinterpret_cast<const float2*>(lse + 2 * quad)[4 * j];
    const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -l2[e & 1]));
  }
}

// K4's P^T and dS^T = P^T * (dP^T - delta) as wgmma's A operand (bf16
// pairs); `delta` is the tile's delta row.
__device__ __forceinline__ void operands_by_col(uint32_t (&pt)[16], uint32_t (&ds)[16],
                                                const float (&p)[32], const float (&dp)[32],
                                                const float* delta, int quad) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 d = reinterpret_cast<const float2*>(delta + 2 * quad)[4 * (i / 2)];
    pt[i] = pack_bf16(p[2 * i], p[2 * i + 1]);
    ds[i] = pack_bf16(p[2 * i] * (dp[2 * i] - d.x), p[2 * i + 1] * (dp[2 * i + 1] - d.y));
  }
}

// 4 bytes from global to shared memory, asynchronously, or 4 zero bytes
// when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed;
// the arrival is one of the barrier's expected ones.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// The two consumers' turns at the tensor cores in K4's D = 64 loop:
// consumer c waits on named barrier TURN_BAR + c and passes the turn on
// to the other's (barriers of both warpgroups, 256 threads).
constexpr int TURN_BAR = 3;  // after consumer_sync's 1 and 2

__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;" ::"r"(TURN_BAR + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;" ::"r"(TURN_BAR + 1 - c) : "memory");
}

// K4's loop at head_dim 64 (dkv_blocks_d64, dkv_consume_d64), where dK
// and dV take 32 + 32 registers and leave room for K3's cross-tile
// overlap: tile t's S^T, tile t-1's dV and dK products and tile t's dP^T
// go out together, and P^T is formed while the last three run; tile 0
// and the last products are peeled off, so the loop body is the same on
// every pass. The two consumers take turns at the tensor cores (named
// barriers TURN_BAR + c, as the D = 64 forward's ping-pong), so one's
// exponentials and packing run while the other's products do. Blocks are
// persistent, one per SM, taking work tiles (a 128-key kv tile of one kv
// head) from a counter in the order of dkv_block; the next pair of K and
// V tiles and its first (q, do) tiles load while this one runs. The lse
// and delta rows of each streamed tile come by cp.async, so the warp that
// copies them runs ahead as the TMA thread does (its synchronous loads
// held the loop back by 13%). Masks are branch-free (probs_by_col).
// Epilogues as dkv_consume's.

// K4's shared memory at D = 64: two resident (K, V) pairs (work tile j
// in pair j % 2, so the next one loads while this one runs), STAGES slots
// of the streamed (Q, dO) tiles with their lse and delta rows, and the
// barriers (full and empty per pair and per slot).
struct SmemKV64 {
  static constexpr int OWN_BYTES = Bwd<64>::OWN_BYTES, STREAM_BYTES = Bwd<64>::STREAM_BYTES;
  static constexpr size_t SMEM = 1024 + 4 * OWN_BYTES + 2 * STAGES * STREAM_BYTES +
                                 2 * STAGES * BN * sizeof(float) + (4 + 2 * STAGES) * 8 + 8;
  unsigned char* own;  // pair i's K at own + 2i * OWN_BYTES, its V one OWN_BYTES on
  unsigned char* str[2];
  float* lse;
  float* delta;
  int* tile;  // the work tile index of each pair
  uint64_t *full_own, *empty_own, *full, *empty;

  __device__ __forceinline__ explicit SmemKV64(unsigned char* raw) {
    own = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    str[0] = own + 4 * OWN_BYTES;
    str[1] = str[0] + STAGES * STREAM_BYTES;
    lse = reinterpret_cast<float*>(str[1] + STAGES * STREAM_BYTES);
    delta = lse + STAGES * BN;
    full_own = reinterpret_cast<uint64_t*>(delta + STAGES * BN);
    empty_own = full_own + 2;
    full = empty_own + 2;
    empty = full + STAGES;
    tile = reinterpret_cast<int*>(empty + STAGES);
  }
};

// The work tiles of the D = 64 loops (K4's dkv_blocks_d64, K3's
// dq_blocks_d64) are handed out as the hardware hands out blocks, in
// index order to whichever block is free: block i takes tile i first,
// then gridDim.x + the next count of its launch's counter (one of SLOTS,
// p.slot, taken in turn on the host by both kernels' launches, so
// launches on concurrent streams do not share one). atomicInc wraps the
// counter to 0 after the launch's last fetch (one after each of its
// n_bh * nt tiles), so every launch, a graph's replays included, finds
// it at 0.
constexpr int SLOTS = 256;
__device__ unsigned int work_counter[SLOTS];

__device__ __forceinline__ int next_work(const BwdParams& p, int total) {
  return gridDim.x + (int)atomicInc(work_counter + p.slot, (unsigned)total - 1);
}

// One K4 work tile: kv tile k0.. of kv head kvh (batch b) and the 64-row
// q tiles [i0, i0 + nq) that see some key of it, in block_tile's order
// (first kv tiles first).
struct WorkKV {
  int kvh, b, k0, i0, nq;
};

__device__ __forceinline__ WorkKV kv_work(const BwdParams& p, int w) {
  const Mask& m = p.a.mask;
  const int per = CHUNK * p.nt;
  const int chunk = w / per, r = w % per;
  const int width = min(CHUNK, p.n_bh - chunk * CHUNK);
  const int bh = chunk * CHUNK + r % width, KVH = p.a.H / p.a.group;
  WorkKV wk;
  wk.kvh = bh % KVH;
  wk.b = bh / KVH;
  wk.k0 = (r / width) * BM;
  const Rows live = rows_of(m, wk.k0, min(wk.k0 + BM, m.kv_len) - 1);
  wk.i0 = live.lo / BN;
  wk.nq = live.lo <= live.hi ? live.hi / BN + 1 - wk.i0 : 0;
  return wk;
}

// Consumer c's part of work tile j, its pair landed: key rows k0 + 64c
// .. + 63 against
// the n = group * nq streamed (q, do) tiles; `ring` counts the streamed
// tiles of the block's earlier work tiles (tile t is in slot (ring + t)
// % STAGES).
template <typename T, int D>
__device__ __forceinline__ void dkv_consume_d64(const SmemKV64& sm, const AttnArgs& a,
                                                const WorkKV& wk, int j, int ring, int c) {
  static_assert(D == 64 && std::is_same<T, bf16>::value,
                "K4's bf16 loop at D = 64: its accumulators leave room for the overlap");
  const Mask& m = a.mask;
  const int kvh = wk.kvh, b = wk.b, k0 = wk.k0, i0 = wk.i0, nq = wk.nq;
  const int n = a.group * nq;
  unsigned char* const kt = sm.own + (j & 1) * 2 * SmemKV64::OWN_BYTES;
  unsigned char* const vt = kt + SmemKV64::OWN_BYTES;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row0 = 64 * c + 16 * warp + lane / 4;  // this thread's keys: row0, row0 + 8
  const int kc0 = k0 + 64 * c;
  // the queries that see each of this thread's keys, fixed for the loop
  const Rows rows[2] = {rows_of(m, k0 + row0, k0 + row0), rows_of(m, k0 + row0 + 8,
                                                                  k0 + row0 + 8)};
  const float sl2 = a.scale * LOG2E;
  const uint32_t k_addr = smem_u32(kt) + c * 64 * 128;
  const uint32_t v_addr = smem_u32(vt) + c * 64 * 128;
  const uint32_t q_addr = smem_u32(sm.str[0]), do_addr = smem_u32(sm.str[1]);

  constexpr int STREAM_BYTES = Bwd<D>::STREAM_BYTES;
  float dk[D / 2], dv[D / 2], s[32], dp[32];
  uint32_t pt[16], ds[16];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n > 0) {  // tile 0: S^T, dP^T, P^T and dS^T
    const int st = ring % STAGES;
    const uint32_t qs = q_addr + st * STREAM_BYTES, dos = do_addr + st * STREAM_BYTES;
    mbar_wait(sm.full + st, (ring / STAGES) & 1);
    turn_wait(c);
    wg_fence();
    mma_scores<D>(s, k_addr, qs);  // S^T = K Q^T   [keys, queries]
    wg_commit();
    mma_scores<D>(dp, v_addr, dos);  // dP^T = V dO^T
    wg_commit();
    turn_pass(c);
    wg_wait<1>();
    reg_fence(s);
    probs_by_col(s, rows, i0 * BN, quad,
                 !sees_all(m, i0 * BN, i0 * BN + BN - 1, kc0, 64) || (i0 + 1) * BN > m.q_len,
                 sl2, sm.lse + st * BN);
    wg_wait<0>();
    reg_fence(dp);
    operands_by_col(pt, ds, s, dp, sm.delta + st * BN, quad);
  }
  for (int t = 1; t < n; ++t) {
    const int st = (ring + t) % STAGES, pst = (ring + t - 1) % STAGES;
    const int q0 = (i0 + t % nq) * BN;
    const uint32_t qs = q_addr + st * STREAM_BYTES, dos = do_addr + st * STREAM_BYTES;
    mbar_wait(sm.full + st, ((ring + t) / STAGES) & 1);
    turn_wait(c);
    wg_fence();
    mma_scores<D>(s, k_addr, qs);
    wg_commit();
    mma_acc<D>(dv, pt, do_addr + pst * STREAM_BYTES);  // dV += P^T dO of tile t-1
    mma_acc<D>(dk, ds, q_addr + pst * STREAM_BYTES);   // dK += dS^T Q of tile t-1
    wg_commit();
    mma_scores<D>(dp, v_addr, dos);
    wg_commit();
    turn_pass(c);
    wg_wait<2>();  // S^T done
    reg_fence(s);
    probs_by_col(s, rows, q0, quad, !sees_all(m, q0, q0 + BN - 1, kc0, 64) || q0 + BN > m.q_len,
                 sl2, sm.lse + st * BN);
    wg_wait<0>();  // tile t-1's products and dP^T done
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(dp);
    if (tid == 0) mbar_arrive(sm.empty + pst);
    operands_by_col(pt, ds, s, dp, sm.delta + st * BN, quad);
  }
  if (n > 0) {  // the last tile's dV and dK products
    const int pst = (ring + n - 1) % STAGES;
    turn_wait(c);
    wg_fence();
    mma_acc<D>(dv, pt, do_addr + pst * STREAM_BYTES);
    mma_acc<D>(dk, ds, q_addr + pst * STREAM_BYTES);
    wg_commit();
    turn_pass(c);
    wg_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    if (tid == 0) mbar_arrive(sm.empty + pst);
  }

  // epilogue: dk = scale * unrope(dK), dv = dV, through this consumer's
  // rows of the K and V tiles (staged for 16-byte row stores: measured
  // faster here than bf16 pairs straight from the registers)
  consumer_sync(c);
  stage_rows<D>(kt, dk, a.scale, row0, k0, m.kv_len, table<D>(a.cos, b, m.q_len),
                table<D>(a.sin, b, m.q_len), quad);
  stage_rows<D>(vt, dv, 1.f, row0, k0, m.kv_len, nullptr, nullptr, quad);
  consumer_sync(c);
  store_rows<D>(static_cast<bf16*>(a.dk.ptr) + b * a.dk.sb + kvh * a.dk.sh, a.dk.ss, kt, c, k0,
                m.kv_len, tid);
  store_rows<D>(static_cast<bf16*>(a.dv.ptr) + b * a.dv.sb + kvh * a.dv.sh, a.dv.ss, vt, c, k0,
                m.kv_len, tid);
  fence_async_smem();  // the staging writes before the next TMA load's
  consumer_sync(c);    // every thread has read its rows of the pair
  if (tid == 0) mbar_arrive(sm.empty_own + (j & 1));
}

// dk and dv of K4 at D = 64 in one persistent block, over the work tiles
// it is handed (see next_work; 128 key rows of one kv head each).
// Every thread calls it. The producer runs ahead across work tiles and
// writes each pair's work tile index beside it, n_bh * nt when there is
// none left; the consumers' turns pass round without a break from one
// work tile to the next, consumer 0 giving itself the first and taking
// back the last.
__device__ __forceinline__ void dkv_blocks_d64(unsigned char* smem, const BwdParams& p) {
  constexpr int OWN_BYTES = SmemKV64::OWN_BYTES, STREAM_BYTES = SmemKV64::STREAM_BYTES;
  const AttnArgs& a = p.a;
  const Mask& m = a.mask;
  const SmemKV64 sm(smem);
  const int total = p.n_bh * p.nt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(sm.full_own + i, 1);
      mbar_init(sm.empty_own + i, 2);  // one arrival per consumer
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(sm.full + i, 1 + 32);  // the TMA thread and the lse/delta warp
      mbar_init(sm.empty + i, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: thread 0 starts every TMA load; warp 1 copies each tile's
    // lse and delta rows into its slot with cp.async (zeros past q_len,
    // where the consumers mask every query), so it runs ahead as the TMA
    // thread does
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int ring = 0, w = blockIdx.x;
      for (int j = 0;; ++j) {
        const int pr = j & 1;
        mbar_wait(sm.empty_own + pr, ((j >> 1) & 1) ^ 1);
        sm.tile[pr] = w;
        if (w >= total) {
          mbar_arrive(sm.full_own + pr);  // no work tile left
          break;
        }
        const WorkKV wk = kv_work(p, w);
        unsigned char* const kt = sm.own + pr * 2 * OWN_BYTES;
        mbar_expect_tx(sm.full_own + pr, 2 * OWN_BYTES);
        tma_load(kt, &p.k, sm.full_own + pr, 0, wk.k0, wk.kvh, wk.b);
        tma_load(kt + OWN_BYTES, &p.v, sm.full_own + pr, 0, wk.k0, wk.kvh, wk.b);
        const int n = a.group * wk.nq;
        for (int t = 0; t < n; ++t, ++ring) {
          const int st = ring % STAGES, g = t / wk.nq, q0 = (wk.i0 + t - g * wk.nq) * BN;
          const int h = wk.kvh * a.group + g;
          mbar_wait(sm.empty + st, ((ring / STAGES) & 1) ^ 1);
          mbar_expect_tx(sm.full + st, 2 * STREAM_BYTES);
          tma_load(sm.str[0] + st * STREAM_BYTES, &p.q, sm.full + st, 0, q0, h, wk.b);
          tma_load(sm.str[1] + st * STREAM_BYTES, &p.dout, sm.full + st, 0, q0, h, wk.b);
        }
        // the next work tile, taken once this one's last loads are out
        w = next_work(p, total);
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      int ring = 0;
      for (int j = 0;; ++j) {
        mbar_wait(sm.full_own + (j & 1), (j >> 1) & 1);  // the pair's tile index
        const int w = sm.tile[j & 1];
        if (w >= total) break;
        const WorkKV wk = kv_work(p, w);
        const int n = a.group * wk.nq;
        for (int t = 0; t < n; ++t, ++ring) {
          const int st = ring % STAGES, g = t / wk.nq, q0 = (wk.i0 + t - g * wk.nq) * BN;
          const long long base = ((long long)wk.b * a.H + wk.kvh * a.group + g) * m.q_len;
          mbar_wait(sm.empty + st, ((ring / STAGES) & 1) ^ 1);
          for (int r = lane; r < BN; r += 32) {
            const int q = q0 + r;
            const long long i = base + (q < m.q_len ? q : 0);
            cp_async4(sm.lse + st * BN + r, a.lse_in + i, q < m.q_len);
            cp_async4(sm.delta + st * BN + r, a.delta + i, q < m.q_len);
          }
          cp_async_arrive(sm.full + st);  // without waiting: on to the next slot
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = threadIdx.x / 128 - 1;
    if (c == 0) turn_pass(1);  // consumer 0 takes the first turn
    int ring = 0;
    for (int j = 0;; ++j) {
      mbar_wait(sm.full_own + (j & 1), (j >> 1) & 1);
      const int w = sm.tile[j & 1];
      if (w >= total) break;
      const WorkKV wk = kv_work(p, w);
      dkv_consume_d64<bf16, 64>(sm, a, wk, j, ring, c);
      ring += a.group * wk.nq;
    }
    if (c == 0) turn_wait(0);  // and takes back the last
  }
}

// dk and dv of one block: 128 key rows of one kv head, written as T.
// Every thread calls it.
template <typename T, int D>
__device__ __forceinline__ void dkv_block(unsigned char* smem, const BwdParams& p) {
  constexpr int OWN_BYTES = Bwd<D>::OWN_BYTES, STREAM_BYTES = Bwd<D>::STREAM_BYTES;
  const AttnArgs& a = p.a;
  const Mask& m = a.mask;
  int bh, ki;
  block_tile(p, false, bh, ki);
  const int KVH = a.H / a.group, kvh = bh % KVH, b = bh / KVH, k0 = ki * BM;
  const Smem<D> sm(smem);
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
      for (int x = 0; x < Row<D>::BOXES; ++x) {
        tma_load(sm.own[0] + x * OWN_BOX, &p.k, sm.bar_own, x * BOX_COLS, k0, kvh, b);
        tma_load(sm.own[1] + x * OWN_BOX, &p.v, sm.bar_own, x * BOX_COLS, k0, kvh, b);
      }
      for (int t = 0; t < n; ++t) {
        const int st = t % STAGES, g = t / nq, q0 = (i0 + t - g * nq) * BN;
        const int h = kvh * a.group + g;
        mbar_wait(sm.empty + st, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(sm.full + st, 2 * STREAM_BYTES);
        for (int x = 0; x < Row<D>::BOXES; ++x) {
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
    dkv_consume<T, D>(sm, a, kvh, b, k0, i0, nq, threadIdx.x / 128 - 1);
  }
}

// ------------------------------------------------------------- K3 at D = 64
// K3's loop at head_dim 64 (dq_blocks_d64, dq_consume_d64), K4's D = 64
// design carried over to dq. At gpt2-1.5b's attention the templated D =
// 128 loop (dq_block) reached 32% of its bound: 1600 blocks, each alone
// with its prologue (barrier init, the Q/dO loads, four scalar global
// loads of lse and delta a thread) and its epilogue, and two consumers
// issuing their products without order. Here (PERF.md, PR 20, gives
// each step's time):
// - Persistent blocks, one per SM, taking work tiles (128 query rows of
//   one q head) from the launch's counter (next_work) in dq_block's
//   order, the longest causal tiles first. Two resident (Q, dO) pairs
//   (work tile j in pair j % 2): the next tile's pair and its first K/V
//   tiles load while this one runs; the ring of K/V slots runs on from
//   one work tile to the next. One block a work tile measured 15%
//   slower.
// - 128-key K/V tiles (m64n128 score products, 8 steps of dQ += dS K),
//   which K3's one accumulator leaves the registers for (K4's two do
//   not): 64-key tiles measured 18% slower. DQ64_STAGES = 4 slots (3:
//   2% slower, 2: 12%).
// - Each work tile's 128 lse and delta rows come beside its pair by
//   cp.async from the producer warp (zeros past q_len: those rows' Q and
//   dO arrive as zeros, their dS is 0 and their dq is not stored), so no
//   consumer waits on a global load at a tile's start.
// - The consumers take turns at the tensor cores (turn_wait/turn_pass,
//   as dkv_consume_d64): tile t's S, tile t-1's dQ product and tile t's
//   dP go out in one turn, P and dS form while the other's products run
//   (1-2% faster than without turns).
// - Masks are branch-free (probs_rows_d64), one comparison a key on the
//   band's tiles (band_only).
// - The epilogue stages dq = scale * unrope(dQ) in a tile of its own and
//   stores each consumer's 64 rows with one TMA store, which clips rows
//   past q_len, and the consumer goes on to its next work tile at once:
//   2% faster than bf16 pairs stored from the registers, which were 2%
//   faster than rows staged through the Q tile.
constexpr int DQ64_KN = 128;     // keys per streamed K/V tile
constexpr int DQ64_STAGES = 4;   // K/V tiles in flight

// K3's shared memory at D = 64: two resident (Q, dO) pairs with their lse
// and delta rows, DQ64_STAGES slots of the streamed K and V tiles, dq's
// staging tile, and the barriers (full and empty per pair and per slot).
struct SmemQ64 {
  static constexpr int OWN_BYTES = Bwd<64>::OWN_BYTES;   // 128 rows x 64
  static constexpr int STREAM_BYTES = DQ64_KN * 128;     // DQ64_KN rows x 64
  static constexpr size_t SMEM = 1024 + 5 * OWN_BYTES + 2 * DQ64_STAGES * STREAM_BYTES +
                                 2 * 2 * BM * sizeof(float) + (4 + 2 * DQ64_STAGES) * 8 + 8;
  unsigned char* own;  // pair i's Q at own + 2i * OWN_BYTES, its dO one OWN_BYTES on
  unsigned char* str[2];
  unsigned char* out;  // dq's 128 rows, staged for the TMA stores
  float* lse;    // pair i's rows at lse + i * BM
  float* delta;  // and at delta + i * BM
  int* tile;     // the work tile index of each pair
  uint64_t *full_own, *empty_own, *full, *empty;

  __device__ __forceinline__ explicit SmemQ64(unsigned char* raw) {
    own = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    str[0] = own + 4 * OWN_BYTES;
    str[1] = str[0] + DQ64_STAGES * STREAM_BYTES;
    out = str[1] + DQ64_STAGES * STREAM_BYTES;
    lse = reinterpret_cast<float*>(out + OWN_BYTES);
    delta = lse + 2 * BM;
    full_own = reinterpret_cast<uint64_t*>(delta + 2 * BM);
    empty_own = full_own + 2;
    full = empty_own + 2;
    empty = full + DQ64_STAGES;
    tile = reinterpret_cast<int*>(empty + DQ64_STAGES);
  }
};

// One K3 work tile: query rows pos0.. of q head h (batch b), kv head kvh,
// and its live kv tiles of DQ64_KN keys; in dq_block's order.
struct WorkQ {
  int h, b, kvh, pos0;
  TileRange tiles;
};

__device__ __forceinline__ WorkQ q_work(const BwdParams& p, int w) {
  const Mask& m = p.a.mask;
  const int per = CHUNK * p.nt;
  const int chunk = w / per, r = w % per;
  const int width = min(CHUNK, p.n_bh - chunk * CHUNK);
  const int bh = chunk * CHUNK + r % width;
  WorkQ wk;
  wk.h = bh % p.a.H;
  wk.b = bh / p.a.H;
  wk.kvh = wk.h / p.a.group;
  wk.pos0 = (p.nt - 1 - r / width) * BM;
  wk.tiles = kv_tiles<DQ64_KN>(m, wk.pos0, min(wk.pos0 + BM, m.q_len) - 1);
  return wk;
}

// d[64 x 128] = A[64 x 64] . B[128 x 64]^T at D = 64: a consumer's rows
// of a resident tile against a streamed tile, both K-major in one box.
__device__ __forceinline__ void mma_scores_d64(float (&d)[DQ64_KN / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(d, desc(a + kk * 32, 16, 1024), desc(b + kk * 32, 16, 1024), kk > 0);
}

// acc[64 x 64] += A[64 x 128] . B[128 x 64] at D = 64: A in registers
// (dS), B the streamed K tile read MN-major, 8 steps of 16 rows.
__device__ __forceinline__ void mma_acc_d64(float (&acc)[32], const uint32_t (&a)[DQ64_KN / 4],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DQ64_KN / 16; ++kk)
    wgmma_rs(acc, a + 4 * kk, desc(b + kk * 2048, SmemQ64::STREAM_BYTES, 1024));
}

// K3's P = exp(S * scale - lse) in place over a DQ64_KN-key tile (s[4j +
// e]: row h = e >> 1 of this thread's two against key k0 + 8j + 2 quad +
// (e & 1)), the keys a row does not see masked to 0 first when `masked`:
// each key's offset c = 8j + (e & 1), a constant, against the row's
// bounds less k0 + 2 quad, with no branch; on the band's tiles (`band`)
// against the row's last key alone.
__device__ __forceinline__ void probs_rows_d64(float (&s)[DQ64_KN / 2], const Keys (&keys)[2],
                                               int k0, int quad, bool masked, bool band,
                                               float sl2, const float (&lse2)[2]) {
  if (masked) {
    const int base = k0 + 2 * quad;
    const int hi[2] = {keys[0].hi - base, keys[1].hi - base};
    if (band) {
#pragma unroll
      for (int j = 0; j < DQ64_KN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = 8 * j + (e & 1) <= hi[e >> 1] ? s[4 * j + e] : -INFINITY;
    } else {
      const int lo[2] = {keys[0].lo - base, keys[1].lo - base};
      const int pre[2] = {keys[0].pre - base, keys[1].pre - base};
#pragma unroll
      for (int j = 0; j < DQ64_KN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + (e & 1), h = e >> 1;
          s[4 * j + e] = ((c >= lo[h]) & (c <= hi[h])) | (c < pre[h]) ? s[4 * j + e] : -INFINITY;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < DQ64_KN / 2; ++i) s[i] = ex2(fmaf(s[i], sl2, -lse2[(i >> 1) & 1]));
}

// K3's dS = P * (dP - delta) as wgmma's A operand (bf16 pairs).
__device__ __forceinline__ void dscores_rows_d64(uint32_t (&ds)[DQ64_KN / 4],
                                                 const float (&p)[DQ64_KN / 2],
                                                 const float (&dp)[DQ64_KN / 2],
                                                 const float (&dlt)[2]) {
#pragma unroll
  for (int i = 0; i < DQ64_KN / 4; ++i)
    ds[i] = pack_bf16(p[2 * i] * (dp[2 * i] - dlt[i & 1]),
                      p[2 * i + 1] * (dp[2 * i + 1] - dlt[i & 1]));
}

// Consumer c's part of work tile j, its pair landed: query rows pos0 +
// 64c .. + 63 against the live kv tiles; `ring` counts the streamed tiles
// of the block's earlier work tiles (tile t is in slot (ring + t) %
// DQ64_STAGES). Tile 0 and the last dQ product are peeled off, so the
// loop body is the same on every pass.
__device__ __forceinline__ void dq_consume_d64(const SmemQ64& sm, const BwdParams& p,
                                               const WorkQ& wk, int j, int ring, int c) {
  constexpr int D = 64, KN = DQ64_KN, STAGES_ = DQ64_STAGES;
  constexpr int STREAM_BYTES = SmemQ64::STREAM_BYTES;
  const AttnArgs& a = p.a;
  const Mask& m = a.mask;
  const int pos0 = wk.pos0, b = wk.b;
  const TileRange& tiles = wk.tiles;
  const int n = tiles.count();
  unsigned char* const qt = sm.own + (j & 1) * 2 * SmemQ64::OWN_BYTES;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row0 = 64 * c + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int r_lo = pos0 + 64 * c, r_hi = r_lo + 63;
  Keys keys[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = pos0 + row0 + 8 * hh, r = (j & 1) * BM + row0 + 8 * hh;
    // a row past q_len sees no key (hi = -1: none by either test)
    keys[hh] = pos < m.q_len ? keys_of(m, pos) : Keys{1, -1, 0};
    lse2[hh] = sm.lse[r] * LOG2E;
    dlt[hh] = sm.delta[r];
  }
  const float sl2 = a.scale * LOG2E;
  const uint32_t q_addr = smem_u32(qt) + c * 64 * 128;
  const uint32_t do_addr = q_addr + SmemQ64::OWN_BYTES;
  const uint32_t k_addr = smem_u32(sm.str[0]), v_addr = smem_u32(sm.str[1]);

  float acc[D / 2], s[KN / 2], dp[KN / 2];
  uint32_t ds[KN / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (n > 0) {  // tile 0: S, dP and dS
    const int st = ring % STAGES_, k0 = tiles.tile(0) * KN;
    mbar_wait(sm.full + st, (ring / STAGES_) & 1);
    turn_wait(c);
    wg_fence();
    mma_scores_d64(s, q_addr, k_addr + st * STREAM_BYTES);
    wg_commit();
    mma_scores_d64(dp, do_addr, v_addr + st * STREAM_BYTES);
    wg_commit();
    turn_pass(c);
    wg_wait<1>();
    reg_fence(s);
    probs_rows_d64(s, keys, k0, quad, !sees_all(m, r_lo, r_hi, k0, KN), band_only(m, r_hi, k0),
                   sl2, lse2);
    wg_wait<0>();
    reg_fence(dp);
    dscores_rows_d64(ds, s, dp, dlt);
  }
  for (int t = 1; t < n; ++t) {
    const int st = (ring + t) % STAGES_, pst = (ring + t - 1) % STAGES_;
    const int k0 = tiles.tile(t) * KN;
    mbar_wait(sm.full + st, ((ring + t) / STAGES_) & 1);
    turn_wait(c);
    wg_fence();
    mma_scores_d64(s, q_addr, k_addr + st * STREAM_BYTES);
    wg_commit();
    mma_acc_d64(acc, ds, k_addr + pst * STREAM_BYTES);  // dQ += dS K of tile t-1
    wg_commit();
    mma_scores_d64(dp, do_addr, v_addr + st * STREAM_BYTES);
    wg_commit();
    turn_pass(c);
    wg_wait<2>();  // S done
    reg_fence(s);
    probs_rows_d64(s, keys, k0, quad, !sees_all(m, r_lo, r_hi, k0, KN), band_only(m, r_hi, k0),
                   sl2, lse2);
    wg_wait<0>();  // tile t-1's dQ product and dP done
    reg_fence(acc);
    reg_fence(dp);
    if (tid == 0) mbar_arrive(sm.empty + pst);
    dscores_rows_d64(ds, s, dp, dlt);
  }
  if (n > 0) {  // the last tile's dQ product
    const int pst = (ring + n - 1) % STAGES_;
    turn_wait(c);
    wg_fence();
    mma_acc_d64(acc, ds, k_addr + pst * STREAM_BYTES);
    wg_commit();
    turn_pass(c);
    wg_wait<0>();
    reg_fence(acc);
    if (tid == 0) mbar_arrive(sm.empty + pst);
  }

  // epilogue: dq = scale * unrope(dQ) staged in this consumer's rows of
  // the staging tile, once its previous TMA store has read them; then
  // the pair is released and one TMA store writes the 64 rows
  if (tid == 0) tma_store_wait_read();
  consumer_sync(c);
  stage_rows<D>(sm.out, acc, a.scale, row0, pos0, m.q_len, table<D>(a.cos, b, m.q_len),
                table<D>(a.sin, b, m.q_len), quad);
  fence_async_smem();  // the staging writes before the TMA store's reads
  consumer_sync(c);    // every thread is done with the pair and has staged
  if (tid == 0) {
    mbar_arrive(sm.empty_own + (j & 1));
    tma_store(&p.dq, sm.out + c * 64 * 128, 0, pos0 + 64 * c, wk.h, b);
    tma_store_commit();
  }
}

// dq of K3 at D = 64 in one persistent block, over the work tiles it is
// handed (see next_work). Every thread calls it. The producer warp runs
// ahead across work tiles: its lane 0 starts every TMA load and writes
// each pair's work tile index beside it (n_bh * nt when there is none
// left), and all 32 lanes copy the pair's lse and delta rows. The
// consumers' turns pass round without a break from one work tile to the
// next, consumer 0 giving itself the first and taking back the last.
__device__ __forceinline__ void dq_blocks_d64(unsigned char* smem, const BwdParams& p) {
  constexpr int OWN_BYTES = SmemQ64::OWN_BYTES, STREAM_BYTES = SmemQ64::STREAM_BYTES;
  constexpr int STAGES_ = DQ64_STAGES;
  const AttnArgs& a = p.a;
  const Mask& m = a.mask;
  const SmemQ64 sm(smem);
  const int total = p.n_bh * p.nt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(sm.full_own + i, 1 + 32);  // lane 0's TMA and the warp's cp.async
      mbar_init(sm.empty_own + i, 2);      // one arrival per consumer
    }
    for (int i = 0; i < STAGES_; ++i) {
      mbar_init(sm.full + i, 1);
      mbar_init(sm.empty + i, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int ring = 0, w = blockIdx.x;
      for (int j = 0;; ++j) {
        const int pr = j & 1;
        mbar_wait(sm.empty_own + pr, ((j >> 1) & 1) ^ 1);
        if (w >= total) {  // no work tile left
          if (lane == 0) {
            sm.tile[pr] = w;
            mbar_arrive(sm.full_own + pr);
          }
          mbar_arrive(sm.full_own + pr);
          break;
        }
        const WorkQ wk = q_work(p, w);
        unsigned char* const qt = sm.own + pr * 2 * OWN_BYTES;
        if (lane == 0) {
          sm.tile[pr] = w;
          mbar_expect_tx(sm.full_own + pr, 2 * OWN_BYTES);
          tma_load(qt, &p.q, sm.full_own + pr, 0, wk.pos0, wk.h, wk.b);
          tma_load(qt + OWN_BYTES, &p.dout, sm.full_own + pr, 0, wk.pos0, wk.h, wk.b);
        }
        const long long base = ((long long)wk.b * a.H + wk.h) * m.q_len;
        for (int r = lane; r < BM; r += 32) {
          const int q = wk.pos0 + r;
          const long long i = base + (q < m.q_len ? q : 0);
          cp_async4(sm.lse + pr * BM + r, a.lse_in + i, q < m.q_len);
          cp_async4(sm.delta + pr * BM + r, a.delta + i, q < m.q_len);
        }
        cp_async_arrive(sm.full_own + pr);  // without waiting: on to the K/V tiles
        const int n = wk.tiles.count();
        for (int t = 0; t < n; ++t, ++ring) {
          const int st = ring % STAGES_, k0 = wk.tiles.tile(t) * DQ64_KN;
          mbar_wait(sm.empty + st, ((ring / STAGES_) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(sm.full + st, 2 * STREAM_BYTES);
            tma_load(sm.str[0] + st * STREAM_BYTES, &p.k, sm.full + st, 0, k0, wk.kvh, wk.b);
            tma_load(sm.str[1] + st * STREAM_BYTES, &p.v, sm.full + st, 0, k0, wk.kvh, wk.b);
          }
        }
        // the next work tile, taken once this one's last loads are out
        int next = 0;
        if (lane == 0) next = next_work(p, total);
        w = __shfl_sync(0xffffffffu, next, 0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = threadIdx.x / 128 - 1;
    if (c == 0) turn_pass(1);  // consumer 0 takes the first turn
    int ring = 0;
    for (int j = 0;; ++j) {
      mbar_wait(sm.full_own + (j & 1), (j >> 1) & 1);
      const int w = sm.tile[j & 1];
      if (w >= total) break;
      const WorkQ wk = q_work(p, w);
      dq_consume_d64(sm, p, wk, j, ring, c);
      ring += wk.tiles.count();
    }
    if (c == 0) turn_wait(0);  // and takes back the last
    if (threadIdx.x % 128 == 0) tma_store_wait_read();  // the last store has read its rows
  }
}

// ------------------------------------------------------------ host side
// Build the maps of p.a's q, do (boxes of `streamed` rows for K4, 128 for
// K3) and k, v (128 rows for K4, `streamed` for K3), raise the kernel's
// shared-memory limit to SMEM and launch it over n_bh * nt blocks, or,
// `persistent`, over one block per SM that walks them (K3 and K4 at D =
// 64); `kv_major` picks K4's tiles (B * KVH pairs, kv tiles) over K3's
// (B * H, q tiles). Returns the launch's error, or cudaErrorInvalidValue
// when a map is refused.
template <int D>
inline int launch_bwd(void (*kernel)(BwdParams), BwdParams& p, int B, int KVH, bool kv_major,
                      void* stream, size_t SMEM = Bwd<D>::SMEM, bool persistent = false,
                      int streamed = BN) {
  const AttnArgs& a = p.a;
  const int q_rows = kv_major ? streamed : BM, kv_rows = kv_major ? BM : streamed;
  const int q_len = a.mask.q_len, kv_len = a.mask.kv_len;
  if (!tile_map<D>(&p.q, a.q.ptr, B, a.H, q_len, a.q.sb, a.q.sh, a.q.ss, q_rows, 1) ||
      !tile_map<D>(&p.dout, a.dout.ptr, B, a.H, q_len, a.dout.sb, a.dout.sh, a.dout.ss, q_rows,
                1) ||
      !tile_map<D>(&p.k, a.k.ptr, B, KVH, kv_len, a.k.sb, a.k.sh, a.k.ss, kv_rows, 1) ||
      !tile_map<D>(&p.v, a.v.ptr, B, KVH, kv_len, a.v.sb, a.v.sh, a.v.ss, kv_rows, 1))
    return (int)cudaErrorInvalidValue;
  p.nt = ((kv_major ? kv_len : q_len) + BM - 1) / BM;
  p.n_bh = B * (kv_major ? KVH : a.H);
  int blocks = p.n_bh * p.nt, device = 0, sms = 0;
  cudaError_t err = cudaSuccess;
  if (persistent) {  // one block per SM, or one per work tile when there are fewer
    static std::atomic<unsigned> launches{0};
    p.slot = (int)(launches++ % SLOTS);
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    blocks = min(blocks, sms);
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace sm90
}  // namespace fa

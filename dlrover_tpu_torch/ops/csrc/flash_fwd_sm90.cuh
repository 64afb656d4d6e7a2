// The forward tile loop of K1 (flash_fwd.cu), K9 (flash_heads.cu) and the
// ring block K12 (flash_ring.cu) for Hopper: TMA loads, wgmma products
// and an online softmax held in registers. The visibility rule (Mask,
// keys_of, kv_tiles, sees_all) is flash_common.cuh's, shared by every
// loop; K12 gives it the ring's global offset. The PTX pieces
// (mbarriers, TMA, wgmma, descriptors) and the tensor maps are in
// sm90_common.cuh, shared with the backward loop of flash_bwd_sm90.cuh.
//
// What bounds the forward on the H100: tensor-core operations. At the
// slice's shape (B8 H8 S2048 D128, causal) the two products are 69 GFLOP
// against 34 MB of q/k/v/o, ~2000 operations per byte: 0.07 ms at
// 989 TFLOP/s. The first WMMA loop reached ~5% of that: its products
// reloaded both operands from shared memory on every 16-wide step, the
// running output and the score tile went through shared memory on every
// kv tile, copies were synchronous, and one warp walked the softmax rows
// one after another.
//
// What this loop does about it:
// - Warp specialisation. A block holds 128 query rows and runs three
//   warpgroups: a producer (24 registers after setmaxnreg) whose one
//   thread keeps TMA loads of the k and v tiles in flight in a ring of
//   STAGES slots guarded by full/empty mbarriers (one pair per k slot and
//   one per v slot, so a k slot is refilled as soon as its QK^T is done),
//   and two consumers (240 registers), each owning 64 of the rows.
// - TMA. Each operand is one 4-D tensor map (D, S, heads, B) with the
//   operand's byte strides, so one map covers [B, H, S, D] (K1) and the
//   [B, S, H*D] views (K9). A 128-column row is two 64-column boxes in
//   128-byte swizzle, the layout wgmma reads. For K9's packed GQA rows a
//   q box spans (64 columns, 128/g positions, g heads), which puts the
//   rows in RowMap's order (head-major, then position). Positions past
//   q_len / kv_len arrive as zeros (TMA's out-of-bounds fill).
// - wgmma for both products: S = Q K^T with Q and K in shared memory
//   (both K-major), O += P V with P in registers (the f32 score
//   accumulator, rounded to bf16, already has the register layout of
//   wgmma's A operand) and V read in its [keys, D] layout through the
//   B operand's transpose flag. Within a consumer, tile t's QK^T and
//   tile t-1's PV are in flight together while tile t's softmax runs;
//   only the rescale of O waits for PV. The first tile is peeled off so
//   that the loop body is the same on every pass: with the overlap
//   behind branches, ptxas serialised every wgmma (warning C7514).
// - The online softmax stays in registers: each thread holds two rows'
//   running max and partial sum and their 64-column slice of O across
//   all kv tiles; no S, P or O tile goes to shared memory. The mask is
//   applied per element only on tiles that some row does not wholly
//   see (diagonal, window edge, prefix boundary, ragged end).
// - Order. Blocks run roughly in index order; chunks of CHUNK (batch,
//   head) pairs take their q tiles from the last to the first, so under
//   causality the longest tiles start first and the tail is short, while
//   a chunk's k/v stay in L2.
// - Epilogue: o = acc / l goes through the consumer's own rows of the Q
//   tile in shared memory and out as 16-byte row stores; lse = m + log l
//   per row. A row that sees no key gets o = 0 and lse = -1e30, and so
//   does every row of a block with no live tile (a ring block wholly in
//   the future of its q shard), which loads only its Q tile.
//
// K1's rope: q is roped once, in shared memory, after its TMA load; k
// is roped by a pre-pass kernel (flash_fwd.cu) into a [B, KVH, S, D]
// buffer that this loop loads, so no k tile is roped again per q tile.
#pragma once

#include "sm90_common.cuh"

namespace fa {
namespace sm90 {

constexpr int BQ = 128;      // query rows per block, 64 per consumer
constexpr int BKV = 128;     // key rows per kv tile
constexpr int STAGES = 2;    // k/v tiles in flight (3 measured no faster)
constexpr int THREADS = 384; // producer warpgroup + two consumers
constexpr int BOX_BYTES = 128 * BOX_COLS * 2;  // 16 KB: 128 rows x 64 columns
constexpr int TILE_BYTES = 2 * BOX_BYTES;      // 32 KB: 128 rows x D
constexpr int CHUNK = 16;    // (batch, head) pairs per causal-order chunk
constexpr size_t SMEM = 1024 + (1 + 2 * STAGES) * TILE_BYTES + (1 + 4 * STAGES) * 8;

// The tensor maps of q, k and v and the shared arguments; passed as a
// __grid_constant__ kernel parameter, where TMA reads the maps.
struct FwdParams {
  CUtensorMap q, k, v;
  AttnArgs a;
  int n_bh;  // (batch, head) pairs of the grid: B * H (K1), B * KVH (K9)
  int nq;    // q tiles per pair
};

// The block's (batch, head) pair and q tile (see "Order" at the top).
__device__ __forceinline__ void block_tile(const FwdParams& p, int& bh, int& qi) {
  const int per = CHUNK * p.nq;
  const int chunk = blockIdx.x / per, r = blockIdx.x % per;
  const int width = min(CHUNK, p.n_bh - chunk * CHUNK);
  bh = chunk * CHUNK + r % width;
  qi = p.nq - 1 - r / width;
}

// --------------------------------------------------------------- the loop
// The block's shared memory: the Q tile, STAGES k and v tiles, and the
// barriers (Q; full and empty per k and per v slot).
struct Smem {
  unsigned char* q;
  unsigned char* k;
  unsigned char* v;
  uint64_t *bar_q, *full_k, *full_v, *empty_k, *empty_v;

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    q = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    k = q + TILE_BYTES;
    v = k + STAGES * TILE_BYTES;
    bar_q = reinterpret_cast<uint64_t*>(v + STAGES * TILE_BYTES);
    full_k = bar_q + 1;
    full_v = full_k + STAGES;
    empty_k = full_v + STAGES;
    empty_v = empty_k + STAGES;
  }
};

// S = Q K^T for one consumer: 8 steps of 16 columns, 4 in each 64-column
// box (32 bytes apart in the swizzled rows). Both operands K-major: 1024
// bytes between groups of 8 rows (SBO); LBO is unused in this swizzle.
__device__ __forceinline__ void mma_qk(float (&s)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss(s, desc(q_addr + off, 16, 1024), desc(k_addr + off, 16, 1024), kk > 0);
  }
}

// O += P V: 8 steps of 16 keys (2048 bytes of V each); P's step kk is
// p[4kk..4kk+3]. V is MN-major (D contiguous): LBO steps from the first
// 64-column box to the second, SBO between groups of 8 keys.
__device__ __forceinline__ void mma_pv(float (&o)[64], const uint32_t (&p)[32],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_rs(o, p + 4 * kk, desc(v_addr + kk * 2048, BOX_BYTES, 1024));
}

// One online-softmax step over this thread's share of a score tile:
// s[4j + e] is row row0 (e < 2) or row0 + 8 against key k0 + 8j + 2*quad
// + (e & 1). Masks the keys a row does not see (only when `masked`),
// folds the tile's row maxima into mrow (scaled, log2 units) and turns s
// into exp2(s * sl2 - m) in place; alpha is the factor for the earlier
// sums and output, sum this thread's part of the tile's row sums.
__device__ __forceinline__ void softmax_step(float (&s)[64], const Keys (&keys)[2], int k0,
                                             int quad, bool masked, float sl2,
                                             float (&mrow)[2], float (&alpha)[2],
                                             float (&sum)[2]) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!keys[e >> 1].has(k0 + 8 * j + 2 * quad + (e & 1))) s[4 * j + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY}, use[2];
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(mrow[h], mx[h] * sl2);
    use[h] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
    alpha[h] = ex2(mrow[h] - use[h]);
    mrow[h] = m_new;
    sum[h] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = ex2(fmaf(s[i], sl2, -use[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
}

// Consumer c (0 or 1) of the block: rows 64c..64c+63 of `map`. Tile t's
// QK^T goes out with tile t-1's PV behind it; tile t's softmax runs
// while PV is in flight, and only the rescale of O waits for it.
__device__ __forceinline__ void consume(const Smem& sm, const AttnArgs& a, RowMap map, int b,
                                        const TileRange& tiles, int c) {
  const Mask& m = a.mask;
  const int n = tiles.count();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row0 = 64 * c + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const Keys keys[2] = {keys_of(m, map.pos(row0)), keys_of(m, map.pos(row0 + 8))};
  const int r_lo = map.pos(64 * c), r_hi = map.pos(64 * c + 63);

  mbar_wait(sm.bar_q, 0);
  if (a.cos != nullptr) {
    // rope this consumer's rows in place: rope(x) = x * C +
    // rotate_half(x) * S in f32, rounded once to bf16 (the pre-pass's math);
    // columns j and j + 64 sit at the same offset of the two boxes
    const bf16* cos = table(a.cos, b, m.q_len);
    const bf16* sin = table(a.sin, b, m.q_len);
    for (int i = tid; i < 64 * 8; i += 128) {
      const int r = 64 * c + i / 8, ch = i % 8, pos = map.pos(r);
      if (pos >= m.q_len) continue;
      uint4* p1 = reinterpret_cast<uint4*>(sm.q + swz(r, ch));
      uint4* p2 = reinterpret_cast<uint4*>(sm.q + BOX_BYTES + swz(r, ch));
      float x1[8], x2[8], c1[8], c2[8], s1[8], s2[8], o1[8], o2[8];
      const long long t = (long long)pos * D + ch * 8;
      unpack8(*p1, x1);
      unpack8(*p2, x2);
      unpack8(ld16(cos + t), c1);
      unpack8(ld16(cos + t + HALF), c2);
      unpack8(ld16(sin + t), s1);
      unpack8(ld16(sin + t + HALF), s2);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o1[e] = x1[e] * c1[e] - x2[e] * s1[e];
        o2[e] = x2[e] * c2[e] + x1[e] * s2[e];
      }
      *p1 = pack8(o1);
      *p2 = pack8(o2);
    }
    fence_async_smem();
    consumer_sync(c);
  }

  float o[64], s[64];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  // running max (scaled, log2 units) and this thread's partial row sums
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f}, alpha[2], sum[2];
  const float sl2 = a.scale * LOG2E;
  const uint32_t q_addr = smem_u32(sm.q) + c * 64 * 128;
  const uint32_t k_addr = smem_u32(sm.k), v_addr = smem_u32(sm.v);

  if (n > 0) {  // tile 0: QK^T and its softmax
    mbar_wait(sm.full_k, 0);
    wg_fence();
    mma_qk(s, q_addr, k_addr);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    if (tid == 0) mbar_arrive(sm.empty_k);
    const int k0 = tiles.tile(0) * BKV;
    softmax_step(s, keys, k0, quad, !sees_all(m, r_lo, r_hi, k0, BKV), sl2, mrow, alpha, sum);
    lrow[0] = sum[0];
    lrow[1] = sum[1];
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  }
  for (int t = 1; t < n; ++t) {
    const int st = t % STAGES, pst = (t - 1) % STAGES;
    const int k0 = tiles.tile(t) * BKV;
    mbar_wait(sm.full_k + st, (t / STAGES) & 1);
    mbar_wait(sm.full_v + pst, ((t - 1) / STAGES) & 1);
    wg_fence();
    mma_qk(s, q_addr, k_addr + st * TILE_BYTES);
    wg_commit();
    mma_pv(o, p, v_addr + pst * TILE_BYTES);
    wg_commit();
    wg_wait<1>();  // QK^T done
    reg_fence(s);
    if (tid == 0) mbar_arrive(sm.empty_k + st);
    softmax_step(s, keys, k0, quad, !sees_all(m, r_lo, r_hi, k0, BKV), sl2, mrow, alpha, sum);
    wg_wait<0>();  // PV done
    reg_fence(o);
    if (tid == 0) mbar_arrive(sm.empty_v + pst);
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
    lrow[0] = lrow[0] * alpha[0] + sum[0];
    lrow[1] = lrow[1] * alpha[1] + sum[1];
    // P as wgmma's A operand: the f32 accumulator's layout, in bf16 pairs
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  }
  if (n > 0) {  // the last tile's PV
    const int pst = (n - 1) % STAGES;
    mbar_wait(sm.full_v + pst, ((n - 1) / STAGES) & 1);
    wg_fence();
    mma_pv(o, p, v_addr + pst * TILE_BYTES);
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
  }

  // epilogue: l over the row's four threads; o = acc / l through this
  // consumer's rows of the Q tile, then out as 16-byte row stores
  float inv[2], lse[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lrow[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = l == 0.f ? 0.f : 1.f / l;
    lse[h] = l == 0.f ? NEG_INF : mrow[h] * LN2 + logf(l);
  }
  consumer_sync(c);  // every warp's products have read the Q tile
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int off = (j / 8) * BOX_BYTES + 4 * quad;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      *reinterpret_cast<uint32_t*>(sm.q + off + swz(r, j % 8)) =
          pack_bf16(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
    }
  }
  consumer_sync(c);
  bf16* out = static_cast<bf16*>(a.o.ptr) + b * a.o.sb;
  for (int i = tid; i < 64 * 16; i += 128) {
    const int r = 64 * c + i / 16, chunk = i % 16, pos = map.pos(r);
    if (pos >= m.q_len) continue;
    *reinterpret_cast<uint4*>(out + map.head(r) * a.o.sh + pos * a.o.ss + chunk * 8) =
        *reinterpret_cast<const uint4*>(sm.q + (chunk / 8) * BOX_BYTES + swz(r, chunk % 8));
  }
  if (quad == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h, pos = map.pos(r);
      if (pos < m.q_len)
        a.lse[((long long)b * a.H + map.head(r)) * m.q_len + pos] = lse[h];
    }
  }
}

// Forward of one block: 128 query rows by `map` (batch b) against kv
// head kvh. Every thread of the block calls it.
__device__ __forceinline__ void fwd_block(unsigned char* smem, const FwdParams& p, RowMap map,
                                          int kvh, int b) {
  const Smem sm(smem);
  const TileRange tiles =
      kv_tiles<BKV>(p.a.mask, map.pos0, min(map.pos0 + (1 << map.shift), p.a.mask.q_len) - 1);

  if (threadIdx.x == 0) {
    mbar_init(sm.bar_q, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(sm.full_k + i, 1);
      mbar_init(sm.full_v + i, 1);
      mbar_init(sm.empty_k + i, 2);  // one arrival per consumer
      mbar_init(sm.empty_v + i, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread starts every load, k ahead of v
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.bar_q, TILE_BYTES);
      for (int h = 0; h < 2; ++h)
        tma_load(sm.q + h * BOX_BYTES, &p.q, sm.bar_q, h * BOX_COLS, map.pos0, map.head0, b);
      const int n = tiles.count();
      for (int t = 0; t < n; ++t) {
        const int st = t % STAGES, phase = (t / STAGES) & 1;
        const int k0 = tiles.tile(t) * BKV;
        mbar_wait(sm.empty_k + st, phase ^ 1);
        mbar_expect_tx(sm.full_k + st, TILE_BYTES);
        for (int h = 0; h < 2; ++h)
          tma_load(sm.k + st * TILE_BYTES + h * BOX_BYTES, &p.k, sm.full_k + st,
                   h * BOX_COLS, k0, kvh, b);
        mbar_wait(sm.empty_v + st, phase ^ 1);
        mbar_expect_tx(sm.full_v + st, TILE_BYTES);
        for (int h = 0; h < 2; ++h)
          tma_load(sm.v + st * TILE_BYTES + h * BOX_BYTES, &p.v, sm.full_v + st,
                   h * BOX_COLS, k0, kvh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    consume(sm, p.a, map, b, tiles, threadIdx.x / 128 - 1);
  }
}

// ------------------------------------------------------------ host side
// Build the maps of p.a's q, k and v (q boxes of 2^shift positions x
// 128 >> shift heads; k/v boxes of BKV rows of one head), raise the
// kernel's shared-memory limit and launch it over n_bh * nq blocks.
// Returns the launch's error, or cudaErrorInvalidValue when a map is
// refused.
inline int launch_fwd(void (*kernel)(FwdParams), FwdParams& p, int B, int KVH, int shift,
                      void* stream) {
  const AttnArgs& a = p.a;
  const int per_tile = 1 << shift;
  if (!tile_map(&p.q, a.q.ptr, B, a.H, a.mask.q_len, a.q.sb, a.q.sh, a.q.ss, per_tile,
                BQ >> shift) ||
      !tile_map(&p.k, a.k.ptr, B, KVH, a.mask.kv_len, a.k.sb, a.k.sh, a.k.ss, BKV, 1) ||
      !tile_map(&p.v, a.v.ptr, B, KVH, a.mask.kv_len, a.v.sb, a.v.sh, a.v.ss, BKV, 1))
    return (int)cudaErrorInvalidValue;
  p.nq = (a.mask.q_len + per_tile - 1) / per_tile;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.n_bh * p.nq, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace fa

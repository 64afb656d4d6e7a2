// K1's forward loop at head_dim 64 (flash_fwd.cu's flash_fwd_kernel<64>),
// a Hopper design of its own; D = 128 and the loops of K9 and K12 stay
// in flash_fwd_sm90.cuh.
//
// What bounds it on the H100: at gpt2-1.5b's attention (B8 H25 S1024
// D64, causal) the bytes (q, k, v, o: 105 MB, 0.032 ms at 3.35 TB/s) and
// the two products (26.8 GFLOP, 0.027 ms at 989 TFLOP/s) are matched by
// the softmax's exponentials: ~105 M ex2 at 16 a clock per SM is ~0.03
// ms on 132 SMs. At D = 64 a 64 x 128 score tile costs a consumer as many
// cycles of ex2 as of tensor-core products, and a q tile sees only 4.5 kv
// tiles on average, so what each work tile costs besides its steps (its
// block's start, its first QK^T and softmax, its last PV and epilogue)
// weighs as much as the steps' overlap. The D = 128 loop, templated to
// D = 64, reached 26% of the bound.
//
// What this loop does about it (PERF.md, PR 19, gives each step's time):
// - Persistent blocks. One block per SM walks work tiles (q tile, head,
//   batch) in the D = 128 loop's order (chunks of CHUNK (batch, head)
//   pairs, the longest q tiles first), taking the next one from a
//   counter as the hardware would hand out blocks (next_tile). The
//   producer runs ahead across work tiles: the next Q tile (two Q
//   buffers) and its first kv tiles load while this one's last tiles and
//   epilogue run. Launched one block per work tile instead, the same
//   loop measured 14% slower.
// - Consumer ping-pong. NC consumer warpgroups take turns at the tensor
//   cores: consumer c waits on named barrier PP_BAR + c, issues its
//   products for the step (QK^T of kv tile t and PV of t-1, as the D =
//   128 loop overlaps them within a warpgroup) and arrives on the next
//   consumer's barrier, then runs its softmax while the next one's
//   products run. The turns pass round without a break from one work
//   tile to the next; consumer 0 gives itself the first turn and takes
//   back the last, so every barrier ends balanced.
// - Tiles: NC = 2 consumers of 64 query rows (BQ = 128), m64n128 score
//   tiles (BKV = 128), setmaxnreg 24/240. Three consumers (BQ = 192,
//   setmaxnreg 32/160) measured 2-3% slower at gpt2-1.5b's shape, and two
//   with a 192-key tile (m64n192) 6% slower (PERF.md).
// - q tiles are aligned to the end of the sequence: tile qi holds
//   positions q_len - (nq - qi) BQ .. + BQ - 1, so when BQ does not
//   divide q_len the ragged tile is the first, which under causality
//   sees the fewest keys. Its rows before position 0 arrive as zeros
//   (TMA fills out-of-bounds boxes, negative coordinates included), see
//   no key and are not written.
// - The mask is branch-free on the tiles that need it: each key's offset
//   in the tile, a constant, against the row's bounds; on tiles that no
//   window start or prefix end crosses, against the row's last key only.
// - o and lse leave straight from the registers as bf16 pairs: no
//   staging through shared memory, so no sync and no proxy fence stand
//   between a work tile's last PV and the next load of its Q buffer.
// - The rest is the D = 128 loop's: the online softmax in registers, q
//   roped in shared memory after its load (k by flash_fwd.cu's
//   pre-pass), GQA through the k/v maps, lse = -1e30 for a row that sees
//   no key. Each work tile's first QK^T is peeled off, so the loop body is
//   the same on every pass (ptxas would serialise wgmma otherwise,
//   warning C7514).
#pragma once

#include <atomic>

#include "flash_fwd_sm90.cuh"

namespace fa {
namespace sm90 {
namespace fwd64 {

constexpr int D = 64;
constexpr int NC = 2;                 // consumer warpgroups, 64 query rows each
constexpr int BKV = 128;              // key rows per kv tile (m64n128 score tiles)
constexpr int BQ = 64 * NC;           // query rows per block
constexpr int STAGES = 2;             // k/v tiles in flight
constexpr int THREADS = 128 * (1 + NC);
constexpr int Q_BYTES = BQ * 128;     // BQ rows of 64 bf16 columns, one swizzle box
constexpr int KV_BYTES = BKV * 128;
constexpr size_t SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + (4 + 4 * STAGES) * 8 + 8;
// setmaxnreg: the producer's and each consumer's registers, within the
// 64K of the SM
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int PP_BAR = 1 + NC;        // ping-pong barriers: after consumer_sync's 1..NC
static_assert(128 * PRODUCER_REGS + 128 * NC * CONSUMER_REGS <= 65536, "registers");

// The block's shared memory: two Q tiles (work tile j in Q tile j % 2,
// so the next one loads while this one runs) and the index of the work
// tile each holds, STAGES k and v tiles, and the barriers (full and
// empty per Q tile, per k and per v slot).
struct Smem {
  unsigned char* q;  // Q tile i at q + i * Q_BYTES
  unsigned char* k;
  unsigned char* v;
  int* tile;
  uint64_t *full_q, *empty_q, *full_k, *full_v, *empty_k, *empty_v;

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    q = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    k = q + 2 * Q_BYTES;
    v = k + STAGES * KV_BYTES;
    full_q = reinterpret_cast<uint64_t*>(v + STAGES * KV_BYTES);
    empty_q = full_q + 2;
    full_k = empty_q + 2;
    full_v = full_k + STAGES;
    empty_k = full_v + STAGES;
    empty_v = empty_k + STAGES;
    tile = reinterpret_cast<int*>(empty_v + STAGES);
  }
};

// Work tiles are handed out as the hardware hands out blocks, in index
// order to whichever block is free: block i takes tile i first, then
// gridDim.x + the next count of its launch's counter. The counters are
// SLOTS words of the module, and each launch takes the next one (p.slot,
// set on the host), so launches on concurrent streams do not share one.
// atomicInc wraps a counter to 0 after its launch's last fetch (each of
// the n_bh * nq tiles is followed by one fetch), so every launch finds
// its counter at 0.
constexpr int SLOTS = 256;
__device__ unsigned int tile_counter[SLOTS];

__device__ __forceinline__ int next_tile(const FwdParams& p, int total) {
  return gridDim.x + (int)atomicInc(tile_counter + p.slot, (unsigned)total - 1);
}

// One work tile: q tile qi (in the end-aligned tiling) of head h, batch
// b, against kv head kvh, and its live kv tiles. Work tiles are walked in
// flash_fwd_sm90.cuh's block order (chunks of CHUNK (batch, head) pairs,
// the longest q tiles first).
struct Work {
  int h, b, kvh, pos0;
  TileRange tiles;
};

__device__ __forceinline__ Work work_of(const FwdParams& p, int w) {
  const Mask& m = p.a.mask;
  const int per = CHUNK * p.nq;
  const int chunk = w / per, r = w % per;
  const int width = min(CHUNK, p.n_bh - chunk * CHUNK);
  const int bh = chunk * CHUNK + r % width, qi = p.nq - 1 - r / width;
  Work wk;
  wk.h = bh % p.a.H;
  wk.b = bh / p.a.H;
  wk.kvh = wk.h / p.a.group;
  wk.pos0 = m.q_len - (p.nq - qi) * BQ;
  wk.tiles = kv_tiles<BKV>(m, max(wk.pos0, 0), min(wk.pos0 + BQ, m.q_len) - 1);
  return wk;
}

// Consumer c's turn at the tensor cores: wait for it, then pass it on to
// the next consumer (both named barriers of two warpgroups).
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;" ::"r"(PP_BAR + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;" ::"r"(PP_BAR + (c + 1 == NC ? 0 : c + 1)) : "memory");
}

// S = Q K^T for one consumer: 4 steps of 16 columns in the one 64-column
// box (32 bytes apart in the swizzled rows), both operands K-major.
__device__ __forceinline__ void mma_qk(float (&s)[BKV / 2], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, desc(q_addr + kk * 32, 16, 1024), desc(k_addr + kk * 32, 16, 1024), kk > 0);
}

// O += P V: BKV / 16 steps of 16 keys (2048 bytes of V each), P's step kk
// p[4kk..4kk+3], V MN-major (its 64 columns contiguous).
__device__ __forceinline__ void mma_pv(float (&o)[D / 2], const uint32_t (&p)[BKV / 4],
                                       uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_rs(o, p + 4 * kk, desc(v_addr + kk * 2048, BOX_BYTES, 1024));
}

// flash_fwd_sm90.cuh's softmax_step over a BKV-key tile: s[4j + e] is
// row row0 (e < 2) or row0 + 8 against key k0 + 8j + 2 quad + (e & 1).
// The mask compares each key's offset c = 8j + (e & 1), a constant, with
// the row's bounds less k0 + 2 quad, with no branch: `band` (band_only)
// tests c against the last key alone.
__device__ __forceinline__ void softmax_step(float (&s)[BKV / 2], const Keys (&keys)[2],
                                             int k0, int quad, bool masked, bool band,
                                             float sl2, float (&mrow)[2], float (&alpha)[2],
                                             float (&sum)[2]) {
  if (masked) {
    const int base = k0 + 2 * quad;
    const int hi[2] = {keys[0].hi - base, keys[1].hi - base};
    if (band) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = 8 * j + (e & 1) <= hi[e >> 1] ? s[4 * j + e] : -INFINITY;
    } else {
      const int lo[2] = {keys[0].lo - base, keys[1].lo - base};
      const int pre[2] = {keys[0].pre - base, keys[1].pre - base};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + (e & 1), h = e >> 1;
          s[4 * j + e] = ((c >= lo[h]) & (c <= hi[h])) | (c < pre[h]) ? s[4 * j + e] : -INFINITY;
        }
    }
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
  for (int i = 0; i < BKV / 2; ++i) {
    s[i] = ex2(fmaf(s[i], sl2, -use[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
}

// Consumer c's part of work tile j, its Q tile landed: query rows pos0 +
// 64c .. + 63 of head h (batch b) in Q tile j % 2; rows before position 0 or from
// q_len on are computed on zeros, see no key and are not written. `kv`
// counts the kv tiles of the block's earlier work tiles: tile t of this
// one is in ring slot (kv + t) % STAGES.
__device__ __forceinline__ void consume(const Smem& sm, const AttnArgs& a, const Work& wk,
                                        int j, int kv, int c) {
  constexpr int HALF = D / 2, HC = HALF / 8;  // 16-byte chunks per half row
  const Mask& m = a.mask;
  const int pos0 = wk.pos0, h = wk.h, b = wk.b;
  const TileRange& tiles = wk.tiles;
  const int n = tiles.count();
  unsigned char* const qt = sm.q + (j & 1) * Q_BYTES;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row0 = 64 * c + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int p0 = pos0 + row0, p1 = p0 + 8;
  // rows outside [0, q_len) see no key (hi = -1: none by either test)
  const Keys keys[2] = {p0 < 0 || p0 >= m.q_len ? Keys{1, -1, 0} : keys_of(m, p0),
                        p1 < 0 || p1 >= m.q_len ? Keys{1, -1, 0} : keys_of(m, p1)};
  const int r_lo = pos0 + 64 * c, r_hi = r_lo + 63;

  if (a.cos != nullptr) {
    // rope this consumer's rows in place, as flash_fwd_sm90.cuh's loop:
    // column 8 ch and its partner 8 ch + 32, chunks ch and ch + 4
    const bf16* cos = table<D>(a.cos, b, m.q_len);
    const bf16* sin = table<D>(a.sin, b, m.q_len);
    for (int i = tid; i < 64 * HC; i += 128) {
      const int r = 64 * c + i / HC, ch = i % HC, pos = pos0 + r;
      if (pos < 0 || pos >= m.q_len) continue;
      uint4* p1 = reinterpret_cast<uint4*>(qt + swz(r, ch));
      uint4* p2 = reinterpret_cast<uint4*>(qt + swz(r, ch + HC));
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

  float o[D / 2], s[BKV / 2];
  uint32_t p[BKV / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max (scaled, log2 units) and this thread's partial row sums
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f}, alpha[2], sum[2];
  const float sl2 = a.scale * LOG2E;
  const uint32_t q_addr = smem_u32(qt) + c * 64 * 128;
  const uint32_t k_addr = smem_u32(sm.k), v_addr = smem_u32(sm.v);

  if (n > 0) {  // tile 0: QK^T and its softmax
    const int st = kv % STAGES;
    mbar_wait(sm.full_k + st, (kv / STAGES) & 1);
    turn_wait(c);
    wg_fence();
    mma_qk(s, q_addr, k_addr + st * KV_BYTES);
    wg_commit();
    turn_pass(c);
    wg_wait<0>();
    reg_fence(s);
    if (tid == 0) mbar_arrive(sm.empty_k + st);
    const int k0 = tiles.tile(0) * BKV;
    softmax_step(s, keys, k0, quad, !sees_all(m, r_lo, r_hi, k0, BKV), band_only(m, r_hi, k0),
                 sl2, mrow, alpha, sum);
    lrow[0] = sum[0];
    lrow[1] = sum[1];
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  }
  for (int t = 1; t < n; ++t) {
    const int st = (kv + t) % STAGES, pst = (kv + t - 1) % STAGES;
    const int k0 = tiles.tile(t) * BKV;
    mbar_wait(sm.full_k + st, ((kv + t) / STAGES) & 1);
    mbar_wait(sm.full_v + pst, ((kv + t - 1) / STAGES) & 1);
    turn_wait(c);
    wg_fence();
    mma_qk(s, q_addr, k_addr + st * KV_BYTES);
    wg_commit();
    mma_pv(o, p, v_addr + pst * KV_BYTES);
    wg_commit();
    turn_pass(c);
    wg_wait<1>();  // QK^T done
    reg_fence(s);
    if (tid == 0) mbar_arrive(sm.empty_k + st);
    softmax_step(s, keys, k0, quad, !sees_all(m, r_lo, r_hi, k0, BKV), band_only(m, r_hi, k0),
                 sl2, mrow, alpha, sum);
    wg_wait<0>();  // PV done
    reg_fence(o);
    if (tid == 0) mbar_arrive(sm.empty_v + pst);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    lrow[0] = lrow[0] * alpha[0] + sum[0];
    lrow[1] = lrow[1] * alpha[1] + sum[1];
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  }
  if (n > 0) {  // the last tile's PV
    const int pst = (kv + n - 1) % STAGES;
    mbar_wait(sm.full_v + pst, ((kv + n - 1) / STAGES) & 1);
    turn_wait(c);
    wg_fence();
    mma_pv(o, p, v_addr + pst * KV_BYTES);
    wg_commit();
    turn_pass(c);
    wg_wait<0>();
    reg_fence(o);
    if (tid == 0) mbar_arrive(sm.empty_v + pst);
  }

  // epilogue: l over the row's four threads; o = acc / l straight from
  // the registers (bf16 pairs: columns 8 jj + 2 quad, + 1 of rows row0
  // and row0 + 8; with no staging there is no sync and no proxy fence
  // before the Q tile is loaded again)
  bf16* out = static_cast<bf16*>(a.o.ptr) + b * a.o.sb + h * a.o.sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = lrow[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l == 0.f ? 0.f : 1.f / l;
    const int pos = pos0 + row0 + 8 * hh;
    if (pos < 0 || pos >= m.q_len) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(out + pos * a.o.ss + 2 * quad);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      row[4 * jj] = pack_bf16(o[4 * jj + 2 * hh] * inv, o[4 * jj + 2 * hh + 1] * inv);
    if (quad == 0)
      a.lse[((long long)b * a.H + h) * m.q_len + pos] =
          l == 0.f ? NEG_INF : mrow[hh] * LN2 + logf(l);
  }
  consumer_sync(c);  // every warp's products have read the Q tile
  if (tid == 0) mbar_arrive(sm.empty_q + (j & 1));
}

// The forward of one persistent block, over the work tiles it is handed
// (see next_tile). Every thread calls it. The producer runs ahead across
// work tiles (the next Q tile and the first kv tiles load while this
// one's last tiles and epilogue run) and writes each Q tile's work tile
// index beside it, n_bh * nq when there is none left; the consumers'
// turns pass round without a break from one work tile to the next,
// consumer 0 giving itself the first and taking back the last.
__device__ __forceinline__ void fwd_blocks(unsigned char* smem, const FwdParams& p) {
  const Smem sm(smem);
  const int total = p.n_bh * p.nq;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(sm.full_q + i, 1);
      mbar_init(sm.empty_q + i, NC);  // one arrival per consumer
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(sm.full_k + i, 1);
      mbar_init(sm.full_v + i, 1);
      mbar_init(sm.empty_k + i, NC);
      mbar_init(sm.empty_v + i, NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread starts every load, Q ahead of its k/v tiles,
    // k ahead of v
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int kv = 0, w = blockIdx.x;
      for (int j = 0;; ++j) {
        const int qs = j & 1;
        mbar_wait(sm.empty_q + qs, ((j >> 1) & 1) ^ 1);
        sm.tile[qs] = w;
        if (w >= total) {
          mbar_arrive(sm.full_q + qs);  // no work tile left
          break;
        }
        const Work wk = work_of(p, w);
        mbar_expect_tx(sm.full_q + qs, Q_BYTES);
        tma_load(sm.q + qs * Q_BYTES, &p.q, sm.full_q + qs, 0, wk.pos0, wk.h, wk.b);
        const int n = wk.tiles.count();
        for (int t = 0; t < n; ++t, ++kv) {
          const int st = kv % STAGES, phase = (kv / STAGES) & 1;
          const int k0 = wk.tiles.tile(t) * BKV;
          mbar_wait(sm.empty_k + st, phase ^ 1);
          mbar_expect_tx(sm.full_k + st, KV_BYTES);
          tma_load(sm.k + st * KV_BYTES, &p.k, sm.full_k + st, 0, k0, wk.kvh, wk.b);
          mbar_wait(sm.empty_v + st, phase ^ 1);
          mbar_expect_tx(sm.full_v + st, KV_BYTES);
          tma_load(sm.v + st * KV_BYTES, &p.v, sm.full_v + st, 0, k0, wk.kvh, wk.b);
        }
        // the next work tile, taken once this one's last loads are out
        // (STAGES kv tiles before its end): taken at its start, it would
        // go to a block that is busy while others idle
        w = next_tile(p, total);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int c = threadIdx.x / 128 - 1;
    if (c == 0) turn_pass(NC - 1);  // consumer 0 takes the first turn
    int kv = 0;
    for (int j = 0;; ++j) {
      mbar_wait(sm.full_q + (j & 1), (j >> 1) & 1);
      const int w = sm.tile[j & 1];
      if (w >= total) break;
      const Work wk = work_of(p, w);
      consume(sm, p.a, wk, j, kv, c);
      kv += wk.tiles.count();
    }
    if (c == 0) turn_wait(0);  // and takes back the last
  }
}

// ------------------------------------------------------------ host side
// Build the maps of p.a's q (boxes of BQ positions of one head) and k, v
// (BKV rows), take the launch's counter slot, raise the kernel's
// shared-memory limit and launch one block per SM, or one per work tile
// when there are fewer. Returns the launch's error, or
// cudaErrorInvalidValue when a map is refused.
inline int launch(void (*kernel)(FwdParams), FwdParams& p, int B, int KVH, void* stream) {
  static std::atomic<unsigned> launches{0};
  const AttnArgs& a = p.a;
  if (!tile_map<D>(&p.q, a.q.ptr, B, a.H, a.mask.q_len, a.q.sb, a.q.sh, a.q.ss, BQ, 1) ||
      !tile_map<D>(&p.k, a.k.ptr, B, KVH, a.mask.kv_len, a.k.sb, a.k.sh, a.k.ss, BKV, 1) ||
      !tile_map<D>(&p.v, a.v.ptr, B, KVH, a.mask.kv_len, a.v.sb, a.v.sh, a.v.ss, BKV, 1))
    return (int)cudaErrorInvalidValue;
  p.nq = (a.mask.q_len + BQ - 1) / BQ;
  p.slot = (int)(launches++ % SLOTS);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<min(p.n_bh * p.nq, sms), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace fwd64
}  // namespace sm90
}  // namespace fa

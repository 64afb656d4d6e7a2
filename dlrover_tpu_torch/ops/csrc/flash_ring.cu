// K12 flash_ring_fwd, K13 flash_ring_dq and K14 flash_ring_dkv: one block
// of ring attention (parallel/sequence.py's causal ring) for Hopper
// (sm_90a): a q shard against one visiting kv shard, with causality at
// global positions.
//
// Replaces, in dlrover_tpu/ops/attention.py, the ring-block calls:
//   K12 `ring_fwd_block` -> `_fwd_kernel` with dyn_mask (Pallas row 9);
//   K13 `ring_dq_block` -> `_bwd_dq_kernel` with dyn_mask (row 10);
//   K14 `ring_dkv_block` -> `_bwd_dkv_kernel` with dyn_mask, and the
//       group sum after it (row 11).
//
// What they compute. Row r of the q shard (global position q_start + r)
// sees key c of the kv shard (k_start + c) iff q_start + r >= k_start + c:
// the shared loops' causal rule with the offset off = q_start - k_start
// in place of kv_len - q_len, no window and no prefix. The TPU kernels
// test it per element from offsets in SMEM (`_dyn_mask`); here it sets
// each row's key range, each key's row range and the live kv tiles, so a
// block wholly in the future of its q shard loads no tile and its
// epilogue writes o = 0, lse = -1e30 and zero dq/dk/dv. K12 returns the
// block's normalized o (bf16) and its lse, which the ring merges. K13
// and K14 take the lse and delta of the whole ring, so exp(s - lse) is
// already each row's final softmax weight and the blocks' parts add up:
// dq, dk and dv are written in f32, because the ring sums n of them and
// rounding each to bf16 would round the gradient once per tick
// (`ring_dq_block`'s note). K14 sums the GQA group in registers, as K4.
//
// What bounds them on the H100: at the slice's block shape (B8 H8 KVH8,
// 512-row shards, D128) bytes, not operations. A wholly visible block is
// 4, 6 and 8 * D operations per (q, k) pair: 8.6, 12.9 and 17.2 GFLOP,
// 8.7, 13.0 and 17.4 us at 989 TFLOP/s; against 33.7, 50.6 and 67.4 MB of
// inputs read once and outputs written once (the f32 gradients double
// the output bytes), 10.1, 15.1 and 20.1 us at 3.35 TB/s. A diagonal
// block does half the operations on the same bytes.
//
// What the designs do about that. K12, K13 and K14 run the Hopper loops
// of K1, K3 and K4 (flash_fwd_sm90.cuh, flash_bwd_sm90.cuh): a TMA
// producer warpgroup and two wgmma consumer warpgroups per 128-row block,
// the score tiles and P (K13: S, P, dP and dS; K14: S^T, P and dS) in
// registers, accumulators in registers, each k/v tile (K12, K13) or q/do
// tile (K14) loaded by TMA once per 128-row block, and only live tiles
// loaded. The offset enters through Mask.off, so a wholly visible block
// takes no per-element mask and the diagonal masks only its diagonal
// tiles; a block wholly in the future has no live tile, so its producer
// loads only the resident tiles and its consumers skip the loop. The
// tensor maps span the shard (its length, its strides), so rows past a
// ragged shard's end arrive as TMA's zeros, never as the next shard's
// rows, and take lse = +inf (P = 0). K13 and K14 write their f32
// gradients straight from the accumulators as float2 pairs.
// Every output element is written once, by one block (no atomics, no f32
// scratch in device memory). No rope: the ring path ropes q/k before
// attention, at global positions, as the JAX model does. Not yet done:
// fusing the ring's merge and accumulation into the epilogues (each
// block's o, dq, dk and dv now make one trip through device memory that
// the merge or the sum reads back).
//
// Outputs: o bf16 [B, H, Sq, D] and lse f32 [B, H, Sq]; dq f32
// [B, H, Sq, D]; dk and dv f32 [B, KVH, Sk, D]; all contiguous.
#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace fa {

// K12: one block per (q tile of 128 positions, q head, batch), in sm90's
// order.
__global__ void __launch_bounds__(sm90::THREADS, 1)
    flash_ring_fwd_kernel(const __grid_constant__ sm90::FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  int bh, qi;
  sm90::block_tile(p, bh, qi);
  const int h = bh % p.a.H;
  sm90::fwd_block<128>(smem, p, RowMap{qi * sm90::BQ, 7, h}, h / p.a.group, bh / p.a.H);
}

// K13: one block per (q tile of 128 positions, q head, batch), in
// sm90's order; dq in f32.
__global__ void __launch_bounds__(sm90::bwd::THREADS, 1)
    flash_ring_dq_kernel(const __grid_constant__ sm90::bwd::BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  sm90::bwd::dq_block<float, 128>(smem, p);
}

// K14: one block per (kv tile of 128 positions, kv head, batch), in
// sm90's order; dk and dv in f32.
__global__ void __launch_bounds__(sm90::bwd::THREADS, 1)
    flash_ring_dkv_kernel(const __grid_constant__ sm90::bwd::BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  sm90::bwd::dkv_block<float, 128>(smem, p);
}

// The shared arguments with the ring's mask: causal at global positions.
static AttnArgs ring_args(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, const long long* strides,
                          int H, int KVH, int q_len, int kv_len, int q_start, int k_start,
                          float scale) {
  AttnArgs a = attn_args(q, k, v, dout, lse, delta, strides, H, KVH, q_len, kv_len, 1, 0, 0,
                         scale);
  a.mask.off = q_start - k_start;
  return a;
}

}  // namespace fa

using namespace fa;

// C entries, bound with ctypes. Each returns cudaGetLastError() after its
// launch (or the error of the attribute call that precedes it).
// `strides` holds the (batch, head, row) strides of q, k, v and, for the
// backward, do; q_start and k_start are the shards' global positions.
extern "C" int flash_ring_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int KVH, int q_len, int kv_len,
                              const long long* strides, int q_start, int k_start,
                              float scale, void* stream) {
  sm90::FwdParams p = {};
  p.a = ring_args(q, k, v, nullptr, nullptr, nullptr, strides, H, KVH, q_len, kv_len, q_start,
                  k_start, scale);
  p.a.o = out_bhsd<128>(o, H, q_len);
  p.a.lse = static_cast<float*>(lse);
  p.n_bh = B * H;
  return sm90::launch_fwd<128>(flash_ring_fwd_kernel, p, B, KVH, 7, stream);
}

extern "C" int flash_ring_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, int B, int H,
                             int KVH, int q_len, int kv_len, const long long* strides,
                             int q_start, int k_start, float scale, void* stream) {
  sm90::bwd::BwdParams p = {};
  p.a = ring_args(q, k, v, dout, lse, delta, strides, H, KVH, q_len, kv_len, q_start, k_start,
                  scale);
  p.a.dq = out_bhsd<128>(dq, H, q_len);
  return sm90::bwd::launch_bwd<128>(flash_ring_dq_kernel, p, B, KVH, false, stream);
}

extern "C" int flash_ring_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk, void* dv, int B,
                              int H, int KVH, int q_len, int kv_len, const long long* strides,
                              int q_start, int k_start, float scale, void* stream) {
  sm90::bwd::BwdParams p = {};
  p.a = ring_args(q, k, v, dout, lse, delta, strides, H, KVH, q_len, kv_len, q_start, k_start,
                  scale);
  p.a.dk = out_bhsd<128>(dk, KVH, kv_len);
  p.a.dv = out_bhsd<128>(dv, KVH, kv_len);
  return sm90::bwd::launch_bwd<128>(flash_ring_dkv_kernel, p, B, KVH, true, stream);
}

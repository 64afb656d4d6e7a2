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
// What the design does about that: little yet. The tile loops are K1's,
// K3's and K4's (flash_common.cuh) with the global offset: every output
// element is written once, by one block, with 16-byte stores (no
// atomics, no f32 scratch in device memory), and only live tiles are
// staged, but each q tile stages its head's k/v tiles again (from the
// 50 MB L2 mostly), and the WMMA loops run far from either bound, as
// K1-K4 do. No rope: the ring path ropes q/k before attention, at
// global positions, as the JAX model does. Not yet done: wgmma, TMA,
// double buffering, and fusing the ring's merge and accumulation into
// the epilogues (each block's o, dq, dk and dv now make one trip
// through device memory that the merge or the sum reads back).
//
// Outputs: o bf16 [B, H, Sq, D] and lse f32 [B, H, Sq]; dq f32
// [B, H, Sq, D]; dk and dv f32 [B, KVH, Sk, D]; all contiguous.
#include "flash_common.cuh"

namespace fa {

// One block per (q tile, q head, batch).
__global__ void __launch_bounds__(NTHREADS) flash_ring_fwd_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y;
  fwd_tile(smem, a, RowMap{(int)blockIdx.x * BQ, 6, h}, h / a.group, blockIdx.z);
}

__global__ void __launch_bounds__(NTHREADS) flash_ring_dq_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y;
  dq_tile<float>(smem, a, RowMap{(int)blockIdx.x * BQ, 6, h}, h / a.group, blockIdx.z);
}

// One block per (kv tile, kv head, batch).
__global__ void __launch_bounds__(NTHREADS) flash_ring_dkv_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  dkv_tile<float>(smem, a, blockIdx.x * BK, blockIdx.y, blockIdx.z);
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
  AttnArgs a = ring_args(q, k, v, nullptr, nullptr, nullptr, strides, H, KVH, q_len, kv_len,
                         q_start, k_start, scale);
  a.o = out_bhsd(o, H, q_len);
  a.lse = static_cast<float*>(lse);
  return launch(flash_ring_fwd_kernel, dim3((q_len + BQ - 1) / BQ, H, B), FWD_SMEM, stream,
                a);
}

extern "C" int flash_ring_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, int B, int H,
                             int KVH, int q_len, int kv_len, const long long* strides,
                             int q_start, int k_start, float scale, void* stream) {
  AttnArgs a = ring_args(q, k, v, dout, lse, delta, strides, H, KVH, q_len, kv_len, q_start,
                         k_start, scale);
  a.dq = out_bhsd(dq, H, q_len);
  return launch(flash_ring_dq_kernel, dim3((q_len + BQ - 1) / BQ, H, B), DQ_SMEM, stream, a);
}

extern "C" int flash_ring_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk, void* dv, int B,
                              int H, int KVH, int q_len, int kv_len, const long long* strides,
                              int q_start, int k_start, float scale, void* stream) {
  AttnArgs a = ring_args(q, k, v, dout, lse, delta, strides, H, KVH, q_len, kv_len, q_start,
                         k_start, scale);
  a.dk = out_bhsd(dk, KVH, kv_len);
  a.dv = out_bhsd(dv, KVH, kv_len);
  return launch(flash_ring_dkv_kernel, dim3((kv_len + BK - 1) / BK, KVH, B), DKV_SMEM, stream,
                a);
}

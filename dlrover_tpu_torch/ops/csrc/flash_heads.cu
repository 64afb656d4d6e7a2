// K9 flash_fwd_heads, K10 flash_bwd_dq_heads and K11 flash_bwd_dkv_heads:
// flash attention on the model-native [B, S, H*D] layout
// (flash_attention_bshd, LlamaConfig.attn_impl="bshd") for Hopper (sm_90a).
//
// Replaces, in dlrover_tpu/ops/attention.py, the fused-heads ("bshdf")
// Pallas family:
//   K9  `_fwd_fused` -> `_fwdf_kernel`;
//   K10 `_bwd_fused` -> `_bwdf_dq_kernel`;
//   K11 `_bwd_fused` -> `_bwdf_dkv_kernel`.
// The delta the TPU backward computes in XLA comes from K2 here.
//
// What the TPU design buys, and what stands for it here: a TPU program
// spans every head of a row block, so one kv block read from HBM feeds all
// q heads. On Hopper all heads of a row tile do not fit one block's
// 227 KB of shared memory. The reuse that survives is within a GQA
// group, whose q heads share one kv head. K9 packs the group's g = H /
// KVH q heads as the rows of one tile (positions x g heads, head-major),
// so each k/v tile is staged in shared memory once per group where K1
// stages it once per q head. K10 packs none: each block owns 128 rows of
// one q head, as K3's do, and a group's blocks run next to one another
// (chunks of (batch, head) pairs), so the repeated k/v reads come from
// L2; packing would end every block on a masked diagonal tile. K11 is
// kv-major, as K4: one block holds its k/v tile while the group's q
// heads stream past, and sums dk/dv over the group in registers, so they
// come out at kv-head width with no group-sum pass.
//
// What bounds them on the H100: tensor-core operations, as K1/K3/K4: 4, 6
// and 8 * D operations per visible (q, k) pair, at B8 H8 S2048 D128
// causal 0.07, 0.10 and 0.14 ms at 989 TFLOP/s. Every loop visits only
// the tiles the mask leaves live (causal diagonal, sliding window,
// prefix), as `_tile_meta_impl` does on the TPU. No rope: the bshd route
// ropes q/k before attention, as the JAX model does.
//
// What the designs do about it. K9 runs K1's Hopper loop
// (flash_fwd_sm90.cuh: TMA producer warpgroup, two wgmma consumer
// warpgroups, online softmax in registers) on 128-row tiles of 128 / g
// positions x g heads; its q tensor map's box spans (64 columns, 128 / g
// positions, g heads) of the [B, S, H*D] view, which lands the rows in
// that order. K10 and K11 run K3's and K4's Hopper loops
// (flash_bwd_sm90.cuh `dq_block` and `dkv_block`: 128 own rows resident,
// the other two operands streamed in 64-row tiles through a 3-slot TMA
// ring, S, P and dS in registers, dQ or dK and dV accumulated in
// registers) with their bf16 epilogues and no rope tables; their tensor
// maps read the [B, S, heads*D] operands through the (batch, head, row)
// strides (S*heads*D, D, heads*D), so any group size works.
//
// Outputs: o and dq [B, S, H*D], dk and dv [B, S, KVH*D], contiguous; lse
// f32 [B, H, S]. A row that sees no key gets o = 0 and lse = -1e30.
#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace fa {

// One block per (128 / group query positions, kv head, batch), in sm90's
// causal order: its 128 rows are the group's q heads at those positions.
__global__ void __launch_bounds__(sm90::THREADS, 1)
    flash_fwd_heads_kernel(const __grid_constant__ sm90::FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  int bh, qi;
  sm90::block_tile(p, bh, qi);
  const int kvh = bh % (p.a.H / p.a.group), shift = p.a.shift;
  sm90::fwd_block<128>(smem, p, RowMap{qi << shift, shift, kvh * p.a.group}, kvh,
                  bh / (p.a.H / p.a.group));
}

// One block per (q tile of 128 positions, q head, batch), in sm90's
// order, last tiles first.
__global__ void __launch_bounds__(sm90::bwd::THREADS, 1)
    flash_bwd_dq_heads_kernel(const __grid_constant__ sm90::bwd::BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  sm90::bwd::dq_block<bf16, 128>(smem, p);
}

// One block per (kv tile of 128 positions, kv head, batch), in sm90's
// order.
__global__ void __launch_bounds__(sm90::bwd::THREADS, 1)
    flash_bwd_dkv_heads_kernel(const __grid_constant__ sm90::bwd::BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  sm90::bwd::dkv_block<bf16, 128>(smem, p);
}

}  // namespace fa

using namespace fa;

// C entries, bound with ctypes. Each returns cudaGetLastError() after its
// launch, or cudaErrorInvalidValue when a tensor map is refused or, for
// K9, H / KVH is not a power of two up to 64 (its packed row maps need
// one). `strides` holds the (batch, head, row) strides of q, k, v and,
// for the backward, do, each viewed as [B, heads, S, D].
extern "C" int flash_fwd_heads(const void* q, const void* k, const void* v, void* o,
                               void* lse, int B, int H, int KVH, int q_len, int kv_len,
                               const long long* strides, int causal, int window,
                               int prefix, float scale, void* stream) {
  const int shift = pack_shift(H / KVH);
  if (shift < 0) return (int)cudaErrorInvalidValue;
  sm90::FwdParams p = {};
  p.a = attn_args(q, k, v, nullptr, nullptr, nullptr, strides, H, KVH, q_len, kv_len, causal,
                  window, prefix, scale);
  p.a.shift = shift;
  p.a.o = out_bshd<128>(o, H, q_len);
  p.a.lse = static_cast<float*>(lse);
  p.n_bh = B * KVH;
  return sm90::launch_fwd<128>(flash_fwd_heads_kernel, p, B, KVH, shift, stream);
}

extern "C" int flash_bwd_dq_heads(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dq, int B, int H, int KVH, int q_len, int kv_len,
                                  const long long* strides, int causal, int window,
                                  int prefix, float scale, void* stream) {
  sm90::bwd::BwdParams p = {};
  p.a = attn_args(q, k, v, dout, lse, delta, strides, H, KVH, q_len, kv_len, causal, window,
                  prefix, scale);
  p.a.dq = out_bshd<128>(dq, H, q_len);
  return sm90::bwd::launch_bwd<128>(flash_bwd_dq_heads_kernel, p, B, KVH, false, stream);
}

extern "C" int flash_bwd_dkv_heads(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int KVH, int q_len,
                                   int kv_len, const long long* strides, int causal,
                                   int window, int prefix, float scale, void* stream) {
  sm90::bwd::BwdParams p = {};
  p.a = attn_args(q, k, v, dout, lse, delta, strides, H, KVH, q_len, kv_len, causal, window,
                  prefix, scale);
  p.a.dk = out_bshd<128>(dk, KVH, kv_len);
  p.a.dv = out_bshd<128>(dv, KVH, kv_len);
  return sm90::bwd::launch_bwd<128>(flash_bwd_dkv_heads_kernel, p, B, KVH, true, stream);
}

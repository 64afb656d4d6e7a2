// K2 flash_bwd_preprocess, K3 flash_bwd_dq and K4 flash_bwd_dkv: the
// FlashAttention-2 backward for Hopper (sm_90a), split in three.
//
// Why split: the TPU's one-pass backward (`_bwd_onepass_kernel`) adds
// every kv tile's dq contribution into one scratch row block, which is
// only correct because a TPU grid runs its steps in order. Hopper blocks
// run in no fixed order, so a fused kernel would need atomics for dq,
// whose order changes from run to run. Here dq is produced q-major (one
// block owns a q tile and loops over kv tiles) and dk/dv kv-major (one
// block owns a kv tile and loops over q tiles and the group's q heads):
// each output element is written by exactly one block, the result is
// deterministic, and no atomics are used. GQA dk/dv are summed inside
// the block, so they come out at KVH heads directly.
//
// Replaces, in dlrover_tpu/ops/attention.py:
//   K2 `_delta_bhsd` -> `_delta_kernel` (and the in-kernel delta of
//      `_bwd_onepass_kernel`);
//   K3 `_bwd` -> `_bwd_dq_kernel`, and the dq half of `_bwd_onepass`;
//   K4 `_bwd` -> `_bwd_dkv_kernel` (+ `_group_kv`), and the dk/dv half of
//      `_bwd_onepass`; both with `_unrope_tile`.
//
// What bounds them on the H100:
//   K2 reads do and o once and writes one f32 per row: memory bandwidth
//      (B8 H8 S2048 D128: 67 MB, 0.02 ms at 3.35 TB/s). One warp per row,
//      16-byte loads; the row sum is a warp shuffle reduction.
//   K3 recomputes S = QK^T and dP = dO V^T and forms dQ = dS K: three
//      products over the causal half, 6*B*H*S^2*D/2 = 103 GFLOP (0.10 ms
//      at 989 TFLOP/s): tensor-core bound.
//   K4 recomputes S^T and dP^T and forms dV = P^T dO and dK = dS^T Q: four
//      products, 137 GFLOP (0.14 ms): tensor-core bound.
// What the design does about that: K3 and K4 run the Hopper loops of
// flash_bwd_sm90.cuh (a TMA producer warpgroup streaming 64-row tiles,
// two wgmma consumer warpgroups of 64 rows each, P and dS formed in
// registers and fed back to wgmma as its register operand, accumulators
// in registers), visiting only the tiles the mask leaves live (causal
// diagonal, sliding window, prefix), longest blocks first. Rope: TMA
// cannot rope a tile as it lands, so the wrappers rope q and k once per
// call with K1's pre-pass `flash_fwd_rope_k` (flash_fwd.cu) and pass the
// roped buffers as q and k; the tables still come in, for the transpose
// of rope that the epilogues apply to dq and dk. The ring's K13 and K14
// (flash_ring.cu) run K3's and K4's loops with an f32 epilogue, K10 and
// K11 (flash_heads.cu) run them on [B, S, heads*D] views.
#include "flash_bwd_sm90.cuh"

namespace fa {

// ---------------------------------------------------------------- K2
// delta[b, h, s] = sum_d do[b, h, s, d] * o[b, h, s, d]; one warp per row.
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_preprocess_kernel(Operand dout, Operand o, float* delta, int H, int S) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * NWARPS + warp, h = blockIdx.y, b = blockIdx.z;
  if (s >= S) return;
  const bf16* pd = dout.ptr + b * dout.sb + h * dout.sh + s * dout.ss;
  const bf16* po = o.ptr + b * o.sb + h * o.sh + s * o.ss;
  float acc = 0.f;
  // D = 128: 16 chunks of 8 values, lanes 0..15 take one chunk each
  if (lane < D / 8) {
    float x[8], y[8];
    unpack8(ld16(pd + lane * 8), x);
    unpack8(ld16(po + lane * 8), y);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += x[e] * y[e];
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[((long long)b * H + h) * S + s] = acc;
}

// ---------------------------------------------------------------- K3
// One block per (q tile of 128 positions, q head, batch), last tiles
// first.
__global__ void __launch_bounds__(sm90::bwd::THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ sm90::bwd::BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  sm90::bwd::dq_block<bf16>(smem, p);
}

// ---------------------------------------------------------------- K4
// One block per (kv tile of 128 positions, kv head, batch), first tiles
// first.
__global__ void __launch_bounds__(sm90::bwd::THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ sm90::bwd::BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  sm90::bwd::dkv_block<bf16>(smem, p);
}

}  // namespace fa

using namespace fa;

// C entries, bound with ctypes. Each returns cudaGetLastError() after its
// launch (or the error of the attribute call that precedes it).
extern "C" int flash_bwd_preprocess(const void* dout, const void* o, void* delta, int B,
                                    int H, int S, long long do_sb, long long do_sh,
                                    long long do_ss, long long o_sb, long long o_sh,
                                    long long o_ss, void* stream) {
  Operand d{static_cast<const bf16*>(dout), do_sb, do_sh, do_ss};
  Operand out{static_cast<const bf16*>(o), o_sb, o_sh, o_ss};
  dim3 grid((S + NWARPS - 1) / NWARPS, H, B);
  flash_bwd_preprocess_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      d, out, static_cast<float*>(delta), H, S);
  return (int)cudaGetLastError();
}

// flash_bwd_dq / flash_bwd_dkv: `strides` holds 12 values, the (batch,
// head, row) strides of q, k, v and do. With rope tables, q and k must
// come roped already, from flash_fwd_rope_k on the same tables; the
// tables un-rope dq and dk.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* cos,
                            const void* sin, void* dq, int B, int H, int KVH, int q_len,
                            int kv_len, const long long* strides, int causal, int window,
                            int prefix, float scale, void* stream) {
  sm90::bwd::BwdParams p = {};
  p.a = attn_args(q, k, v, dout, lse, delta, strides, H, KVH, q_len, kv_len, causal, window,
                  prefix, scale);
  p.a.cos = static_cast<const bf16*>(cos);
  p.a.sin = static_cast<const bf16*>(sin);
  p.a.dq = out_bhsd(dq, H, q_len);
  return sm90::bwd::launch_bwd(flash_bwd_dq_kernel, p, B, KVH, false, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* cos,
                             const void* sin, void* dk, void* dv, int B, int H, int KVH,
                             int q_len, int kv_len, const long long* strides, int causal,
                             int window, int prefix, float scale, void* stream) {
  sm90::bwd::BwdParams p = {};
  p.a = attn_args(q, k, v, dout, lse, delta, strides, H, KVH, q_len, kv_len, causal, window,
                  prefix, scale);
  p.a.cos = static_cast<const bf16*>(cos);
  p.a.sin = static_cast<const bf16*>(sin);
  p.a.dk = out_bhsd(dk, KVH, kv_len);
  p.a.dv = out_bhsd(dv, KVH, kv_len);
  return sm90::bwd::launch_bwd(flash_bwd_dkv_kernel, p, B, KVH, true, stream);
}

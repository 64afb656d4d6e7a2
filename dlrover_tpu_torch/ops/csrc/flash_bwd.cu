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
//      16-byte loads; the row sum is a warp shuffle reduction. At D = 64
//      an 8-lane group per row, several rows a group (below).
//   K3 recomputes S = QK^T and dP = dO V^T and forms dQ = dS K: three
//      products over the causal half, 6*B*H*S^2*D/2 = 103 GFLOP (0.10 ms
//      at 989 TFLOP/s): tensor-core bound.
//   K4 recomputes S^T and dP^T and forms dV = P^T dO and dK = dS^T Q: four
//      products, 137 GFLOP (0.14 ms): tensor-core bound.
// Head width: D = 64 or 128, each its own instantiation of K2, K3 and
// K4; the C entries take the width and pick one. At D = 64 each has a
// loop of its own: K2 below, K3's dq_blocks_d64 and K4's dkv_blocks_d64
// (persistent blocks, consumer turns, lse/delta by cp.async).
//
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
// delta[b, h, s] = sum_d do[b, h, s, d] * o[b, h, s, d]. At D = 128 one
// warp per row (16 lanes load). At D = 64 a row is 8 chunks of 16 bytes,
// so an 8-lane group takes a row and a warp four side by side (four
// whole 128-byte lines a load, at any row stride), and each group
// DELTA64_ROWS rows, so that each thread has 2 * DELTA64_ROWS 16-byte
// loads in flight before its group reduces each row in three shuffles:
// the one-warp-a-row loop left 24 of 32 lanes idle and one load a tensor
// in flight, at 48% of the bound. Two rows a group measured as fast as
// one and 12% faster than four (whose 80 registers a thread cut the
// blocks an SM holds).
constexpr int DELTA64_ROWS = 2;                                // rows per group
constexpr int DELTA64_BLOCK_ROWS = NWARPS * 4 * DELTA64_ROWS;  // rows per block

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_preprocess_kernel(Operand dout, Operand o, float* delta, int H, int S) {
  if constexpr (D == 64) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int chunk = lane % 8, h = blockIdx.y, b = blockIdx.z;
    // group lane / 8 takes rows s0, s0 + 4, ...: at each step the warp's
    // four groups read four consecutive rows
    const int s0 = blockIdx.x * DELTA64_BLOCK_ROWS + warp * 4 * DELTA64_ROWS + lane / 8;
    const bf16* pd = dout.ptr + b * dout.sb + h * dout.sh + chunk * 8;
    const bf16* po = o.ptr + b * o.sb + h * o.sh + chunk * 8;
    uint4 x[DELTA64_ROWS], y[DELTA64_ROWS];
#pragma unroll
    for (int i = 0; i < DELTA64_ROWS; ++i) {
      const int s = s0 + 4 * i;
      x[i] = y[i] = make_uint4(0, 0, 0, 0);
      if (s < S) {
        x[i] = ld16(pd + s * dout.ss);
        y[i] = ld16(po + s * o.ss);
      }
    }
    float* out = delta + ((long long)b * H + h) * S;
#pragma unroll
    for (int i = 0; i < DELTA64_ROWS; ++i) {
      const int s = s0 + 4 * i;
      float fx[8], fy[8], acc = 0.f;
      unpack8(x[i], fx);
      unpack8(y[i], fy);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += fx[e] * fy[e];
#pragma unroll
      for (int m = 4; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
      if (chunk == 0 && s < S) out[s] = acc;
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int s = blockIdx.x * NWARPS + warp, h = blockIdx.y, b = blockIdx.z;
    if (s >= S) return;
    const bf16* pd = dout.ptr + b * dout.sb + h * dout.sh + s * dout.ss;
    const bf16* po = o.ptr + b * o.sb + h * o.sh + s * o.ss;
    float acc = 0.f;
    // D / 8 = 16 chunks of 8 values, one a lane
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
}

// ---------------------------------------------------------------- K3
// One block per (q tile of 128 positions, q head, batch), last tiles
// first; at D = 64 one persistent block per SM walks them in that order.
template <int D>
__global__ void __launch_bounds__(sm90::bwd::THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ sm90::bwd::BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (D == 64)
    sm90::bwd::dq_blocks_d64(smem, p);
  else
    sm90::bwd::dq_block<bf16, D>(smem, p);
}

// ---------------------------------------------------------------- K4
// One block per (kv tile of 128 positions, kv head, batch), first tiles
// first; at D = 64 one persistent block per SM walks them in that order.
template <int D>
__global__ void __launch_bounds__(sm90::bwd::THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ sm90::bwd::BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (D == 64)
    sm90::bwd::dkv_blocks_d64(smem, p);
  else
    sm90::bwd::dkv_block<bf16, D>(smem, p);
}

}  // namespace fa

using namespace fa;

// C entries, bound with ctypes. Each takes the head width first (64 or
// 128; cudaErrorInvalidValue otherwise) and returns cudaGetLastError()
// after its launch (or the error of the attribute call that precedes it).
extern "C" int flash_bwd_preprocess(int head_dim, const void* dout, const void* o, void* delta,
                                    int B, int H, int S, long long do_sb, long long do_sh,
                                    long long do_ss, long long o_sb, long long o_sh,
                                    long long o_ss, void* stream) {
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    Operand dd{static_cast<const bf16*>(dout), do_sb, do_sh, do_ss};
    Operand out{static_cast<const bf16*>(o), o_sb, o_sh, o_ss};
    const int rows = D == 64 ? DELTA64_BLOCK_ROWS : NWARPS;  // per block
    dim3 grid((S + rows - 1) / rows, H, B);
    flash_bwd_preprocess_kernel<D><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        dd, out, static_cast<float*>(delta), H, S);
    return (int)cudaGetLastError();
  });
}

// flash_bwd_dq / flash_bwd_dkv: `strides` holds 12 values, the (batch,
// head, row) strides of q, k, v and do. With rope tables, q and k must
// come roped already, from flash_fwd_rope_k on the same tables; the
// tables un-rope dq and dk.
extern "C" int flash_bwd_dq(int head_dim, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            const void* cos, const void* sin, void* dq, int B, int H, int KVH,
                            int q_len, int kv_len, const long long* strides, int causal,
                            int window, int prefix, float scale, void* stream) {
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    sm90::bwd::BwdParams p = {};
    p.a = attn_args(q, k, v, dout, lse, delta, strides, H, KVH, q_len, kv_len, causal, window,
                    prefix, scale);
    p.a.cos = static_cast<const bf16*>(cos);
    p.a.sin = static_cast<const bf16*>(sin);
    p.a.dq = out_bhsd<D>(dq, H, q_len);
    if constexpr (D == 64) {
      // dq leaves by TMA stores of each consumer's 64 rows
      if (!sm90::tile_map<D>(&p.dq, dq, B, H, q_len, p.a.dq.sb, p.a.dq.sh, p.a.dq.ss, 64, 1))
        return (int)cudaErrorInvalidValue;
      return sm90::bwd::launch_bwd<D>(flash_bwd_dq_kernel<D>, p, B, KVH, false, stream,
                                      sm90::bwd::SmemQ64::SMEM, true, sm90::bwd::DQ64_KN);
    } else
      return sm90::bwd::launch_bwd<D>(flash_bwd_dq_kernel<D>, p, B, KVH, false, stream);
  });
}

extern "C" int flash_bwd_dkv(int head_dim, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             const void* cos, const void* sin, void* dk, void* dv, int B, int H,
                             int KVH, int q_len, int kv_len, const long long* strides,
                             int causal, int window, int prefix, float scale, void* stream) {
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    sm90::bwd::BwdParams p = {};
    p.a = attn_args(q, k, v, dout, lse, delta, strides, H, KVH, q_len, kv_len, causal, window,
                    prefix, scale);
    p.a.cos = static_cast<const bf16*>(cos);
    p.a.sin = static_cast<const bf16*>(sin);
    p.a.dk = out_bhsd<D>(dk, KVH, kv_len);
    p.a.dv = out_bhsd<D>(dv, KVH, kv_len);
    if constexpr (D == 64)
      return sm90::bwd::launch_bwd<D>(flash_bwd_dkv_kernel<D>, p, B, KVH, true, stream,
                                      sm90::bwd::SmemKV64::SMEM, true);
    else
      return sm90::bwd::launch_bwd<D>(flash_bwd_dkv_kernel<D>, p, B, KVH, true, stream);
  });
}

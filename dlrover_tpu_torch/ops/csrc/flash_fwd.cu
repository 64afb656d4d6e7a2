// K1 flash_fwd: FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces: dlrover_tpu/ops/attention.py `_fwd` -> `_fwd_kernel` (with
// `_rope_tile`), the Pallas TPU forward.
//
// What bounds it on the H100: tensor-core operations. At the training
// slice's shape (B8 H8 S2048 D128, causal) the two products cost
// 4*B*H*S^2*D/2 = 69 GFLOP against 34 MB of q/k/v/o traffic, about 2000
// operations per byte, far above the ~295 at which the card stops being
// bandwidth bound; the floor is 69 GFLOP / 989 TFLOP/s = 0.07 ms.
//
// What the design does about that: both products run on the tensor cores
// (WMMA bf16 -> f32); one block per (q tile, head, batch) walks only the
// kv tiles the mask leaves live (up to the causal diagonal, down to the
// sliding window's edge, plus the prefix), so dead tiles are never loaded
// or multiplied (the TPU kernel's packed grid does the same by enumerating
// live tiles); rope is applied once to the q tile and to each k tile as it
// is staged, so roped q/k never exist in device memory; GQA reads kv head
// h / group through strides and never materialises the repeat. The online
// softmax runs in f32 with the running output kept in shared memory
// (`fwd_tile` in flash_common.cuh, shared with K9). Not yet done (later
// work): wgmma, TMA loads, double buffering and warp specialisation.
//
// Output: o (bf16 [B, H, S, D], contiguous) and lse (f32 [B, H, S]). The
// TPU kernel's 128-lane lse padding is a TPU layout artifact and is
// dropped. A row that sees no key gets o = 0 and lse = -1e30, as there.
#include "flash_common.cuh"

namespace fa {

__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y;
  fwd_tile(smem, a, RowMap{(int)blockIdx.x * BQ, 6, h}, h / a.group, blockIdx.z);
}

}  // namespace fa

using namespace fa;

// C entry, bound with ctypes. Returns cudaGetLastError() after the launch.
// `strides` holds the (batch, head, row) strides of q, k and v.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* cos,
                         const void* sin, void* o, void* lse, int B, int H, int KVH,
                         int q_len, int kv_len, const long long* strides, int causal,
                         int window, int prefix, float scale, void* stream) {
  AttnArgs a = attn_args(q, k, v, nullptr, nullptr, nullptr, strides, H, KVH, q_len, kv_len,
                         causal, window, prefix, scale);
  a.cos = static_cast<const bf16*>(cos);
  a.sin = static_cast<const bf16*>(sin);
  a.o = out_bhsd(o, H, q_len);
  a.lse = static_cast<float*>(lse);
  return launch(flash_fwd_kernel, dim3((q_len + BQ - 1) / BQ, H, B), FWD_SMEM, stream, a);
}

// K1 flash_fwd: FlashAttention forward for Hopper (sm_90a), with rope.
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
// What the design does about that: the Hopper loop of
// flash_fwd_sm90.cuh (warp-specialised TMA producer, two wgmma consumer
// warpgroups of 64 query rows each, online softmax in registers), one
// block per 128 query rows of one head, walking only the kv tiles the
// mask leaves live (causal diagonal, sliding window, prefix), longest
// tiles first. At head_dim 64, where the softmax costs as much as the
// products, the loop of flash_fwd_sm90_d64.cuh: persistent blocks whose
// two consumers take turns at the tensor cores. GQA reads kv head h / group through the k/v tensor maps
// and never materialises the repeat. Rope: q is roped once per block as
// its tile lands in shared memory; k is roped once per call by
// `flash_fwd_rope_k_kernel` (below) into a [B, KVH, S, D] buffer the
// wrapper allocates, which the loop then loads through TMA, so no k tile
// is roped again for every q tile that visits it. The pre-pass is bound
// by bytes: k read, k written and the cos/sin tables read once, ~23 us
// at the slice's shape at 3.35 TB/s. Both round roped values to bf16
// once, from f32.
//
// Head width: D = 64 or 128, each its own instantiation of the loop and
// of the pre-pass; the C entries take the width and pick one.
//
// Output: o (bf16 [B, H, S, D], contiguous) and lse (f32 [B, H, S]). The
// TPU kernel's 128-lane lse padding is a TPU layout artifact and is
// dropped. A row that sees no key gets o = 0 and lse = -1e30, as there.
#include "flash_fwd_sm90_d64.cuh"

namespace fa {

// At D = 128 one block per (q tile of 128 positions, head, batch), in
// sm90's causal order; at D = 64 one persistent block per SM walking the
// (q tile of BQ positions, head, batch) tiles in that order
// (flash_fwd_sm90_d64.cuh).
template <int D>
__global__ void __launch_bounds__(D == 64 ? sm90::fwd64::THREADS : sm90::THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ sm90::FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (D == 64) {
    sm90::fwd64::fwd_blocks(smem, p);
  } else {
    int bh, qi;
    sm90::block_tile(p, bh, qi);
    const int h = bh % p.a.H;
    sm90::fwd_block<D>(smem, p, RowMap{qi * sm90::BQ, 7, h}, h / p.a.group, bh / p.a.H);
  }
}

// Rope of k, out = rope(k) as contiguous [B, KVH, S, D] bf16: one thread
// per 8 columns of the first half and their partners in the second.
template <int D>
__global__ void flash_fwd_rope_k_kernel(const bf16* k, long long sb, long long sh,
                                        long long ss, const bf16* cos, const bf16* sin,
                                        bf16* out, int KVH, int S, long long n) {
  constexpr int HALF = sm90::Row<D>::HALF;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int c = (int)(idx % (HALF / 8)) * 8;
  const long long row = idx / (HALF / 8);
  const int pos = (int)(row % S);
  const long long bh = row / S;
  const long long b = bh / KVH;
  const bf16* x = k + b * sb + (bh % KVH) * sh + pos * ss;
  const long long t = (b * S + pos) * D + c;
  float x1[8], x2[8], c1[8], c2[8], s1[8], s2[8], o1[8], o2[8];
  unpack8(ld16(x + c), x1);
  unpack8(ld16(x + c + HALF), x2);
  unpack8(ld16(cos + t), c1);
  unpack8(ld16(cos + t + HALF), c2);
  unpack8(ld16(sin + t), s1);
  unpack8(ld16(sin + t + HALF), s2);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    o1[e] = x1[e] * c1[e] - x2[e] * s1[e];
    o2[e] = x2[e] * c2[e] + x1[e] * s2[e];
  }
  store8(out + row * D + c, o1);
  store8(out + row * D + c + HALF, o2);
}

}  // namespace fa

using namespace fa;

// C entries, bound with ctypes. Each takes the head width first (64 or
// 128; cudaErrorInvalidValue otherwise) and returns cudaGetLastError()
// after its launch.
//
// flash_fwd: `strides` holds the (batch, head, row) strides of q, k and
// v. With rope tables, q is roped in the kernel and k must come roped
// already, from flash_fwd_rope_k on the same tables.
extern "C" int flash_fwd(int head_dim, const void* q, const void* k, const void* v,
                         const void* cos, const void* sin, void* o, void* lse, int B, int H,
                         int KVH, int q_len, int kv_len, const long long* strides, int causal,
                         int window, int prefix, float scale, void* stream) {
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    sm90::FwdParams p = {};
    p.a = attn_args(q, k, v, nullptr, nullptr, nullptr, strides, H, KVH, q_len, kv_len,
                    causal, window, prefix, scale);
    p.a.cos = static_cast<const bf16*>(cos);
    p.a.sin = static_cast<const bf16*>(sin);
    p.a.o = out_bhsd<D>(o, H, q_len);
    p.a.lse = static_cast<float*>(lse);
    p.n_bh = B * H;
    if constexpr (D == 64)
      return sm90::fwd64::launch(flash_fwd_kernel<D>, p, B, KVH, stream);
    else
      return sm90::launch_fwd<D>(flash_fwd_kernel<D>, p, B, KVH, 7, stream);
  });
}

// K1's pre-pass: out (contiguous [B, KVH, S, D]) = rope(k), k read
// through its (batch, head, row) strides, tables [B, S, D].
extern "C" int flash_fwd_rope_k(int head_dim, const void* k, const void* cos, const void* sin,
                                void* out, int B, int KVH, int S, long long sb, long long sh,
                                long long ss, void* stream) {
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const long long n = (long long)B * KVH * S * (D / 16);
    const int threads = 256;
    flash_fwd_rope_k_kernel<D><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(k), sb, sh, ss, static_cast<const bf16*>(cos),
        static_cast<const bf16*>(sin), static_cast<bf16*>(out), KVH, S, n);
    return (int)cudaGetLastError();
  });
}

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
// (WMMA bf16 -> f32); one block per (q tile, head, batch) walks the kv
// tiles only up to the causal diagonal, so the dead upper triangle is
// never loaded or multiplied (the TPU kernel's packed grid does the same
// by enumerating live tiles); rope is applied once to the q tile and to
// each k tile as it is staged, so roped q/k never exist in device memory;
// GQA reads kv head h / group through strides and never materialises the
// repeat. The online softmax runs in f32 with the running output kept in
// shared memory. Not yet done (later work): wgmma, TMA loads, double
// buffering and warp specialisation.
//
// Output: o (bf16 [B, H, S, D], contiguous) and lse (f32 [B, H, S]). The
// TPU kernel's 128-lane lse padding is a TPU layout artifact and is
// dropped. A row that sees no key gets o = 0 and lse = -1e30, as there.
#include "flash_common.cuh"

namespace fa {

struct FwdArgs {
  Operand q, k, v;
  const bf16* cos;
  const bf16* sin;
  bf16* o;
  float* lse;
  int H, group, q_len, kv_len, causal;
  float scale;
};

constexpr size_t FWD_SMEM =
    (3 * TILE_H + TILE_P) * sizeof(bf16) + (TILE_S + TILE_O + 2 * 64) * sizeof(float);

__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TILE_H;
  bf16* sV = sK + TILE_H;
  float* sS = reinterpret_cast<float*>(sV + TILE_H);
  float* sO = sS + TILE_S;
  float* sM = sO + TILE_O;
  float* sL = sM + 64;
  bf16* sP = reinterpret_cast<bf16*>(sL + 64);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* q = a.q.ptr + b * a.q.sb + h * a.q.sh;
  const bf16* k = a.k.ptr + b * a.k.sb + kvh * a.k.sh;
  const bf16* v = a.v.ptr + b * a.v.sb + kvh * a.v.sh;
  const bf16* cos = a.cos ? a.cos + (long long)b * a.q_len * D : nullptr;
  const bf16* sin = a.sin ? a.sin + (long long)b * a.q_len * D : nullptr;

  load_tile(sQ, q, a.q.ss, q0, a.q_len, cos, sin);
  for (int i = threadIdx.x; i < TILE_O; i += NTHREADS) sO[i] = 0.f;
  if (threadIdx.x < 64) {
    sM[threadIdx.x] = NEG_INF;
    sL[threadIdx.x] = 0.f;
  }

  int nk = (a.kv_len + BK - 1) / BK;
  if (a.causal) {
    const int last_col = min(q0 + BQ, a.q_len) - 1 + a.kv_len - a.q_len;
    nk = last_col < 0 ? 0 : min(nk, last_col / BK + 1);
  }

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers of sK/sV/sP are done
    load_tile(sK, k, a.k.ss, k0, a.kv_len, cos, sin);
    load_tile(sV, v, a.v.ss, k0, a.kv_len, nullptr, nullptr);
    __syncthreads();
    mm_abt(sS, sQ, sK);
    __syncthreads();

    // online softmax: warp w owns rows 8w..8w+7, two columns per lane
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr, row = q0 + r;
      float s[2];
      bool ok[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        ok[t] = visible(row, k0 + c, a.q_len, a.kv_len, a.causal);
        s[t] = ok[t] ? sS[r * LD_S + c] * a.scale : NEG_INF;
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      float p[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        p[t] = ok[t] ? __expf(s[t] - m_new) : 0.f;
        sP[r * LD_P + lane + 32 * t] = __float2bfloat16(p[t]);
      }
      const float sum = warp_sum(p[0] + p[1]);
      const float alpha = __expf(m_old - m_new);
      for (int c = lane; c < D; c += 32) sO[r * LD_O + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncthreads();

    FragC acc[4];
    load_acc(acc, sO);
    mm_ab_acc(acc, sP, sV);
    store_acc(sO, acc);
  }
  __syncthreads();

  // epilogue: o = acc / l, lse = m + log(l); l == 0 (no visible key) -> 1
  if (threadIdx.x < 64) {
    const float l = sL[threadIdx.x];
    sL[threadIdx.x] = l == 0.f ? 1.f : l;
  }
  __syncthreads();
  bf16* o = a.o + ((long long)b * a.H + h) * a.q_len * D;
  for (int idx = threadIdx.x; idx < 64 * (D / 8); idx += NTHREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int row = q0 + r;
    if (row >= a.q_len) continue;
    const float inv = 1.f / sL[r];
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = sO[r * LD_O + c + e] * inv;
    *reinterpret_cast<uint4*>(o + (long long)row * D + c) = pack8(f);
  }
  if (threadIdx.x < 64 && q0 + threadIdx.x < a.q_len) {
    const int r = threadIdx.x;
    a.lse[((long long)b * a.H + h) * a.q_len + q0 + r] = sM[r] + logf(sL[r]);
  }
}

}  // namespace fa

using namespace fa;

// C entry, bound with ctypes. Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* cos,
                         const void* sin, void* o, void* lse, int B, int H, int KVH,
                         int q_len, int kv_len, long long q_sb, long long q_sh,
                         long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss, int causal,
                         float scale, void* stream) {
  FwdArgs a;
  a.q = Operand{static_cast<const bf16*>(q), q_sb, q_sh, q_ss};
  a.k = Operand{static_cast<const bf16*>(k), k_sb, k_sh, k_ss};
  a.v = Operand{static_cast<const bf16*>(v), v_sb, v_sh, v_ss};
  a.cos = static_cast<const bf16*>(cos);
  a.sin = static_cast<const bf16*>(sin);
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.group = H / KVH;
  a.q_len = q_len;
  a.kv_len = kv_len;
  a.causal = causal;
  a.scale = scale;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((q_len + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, NTHREADS, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

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
// What the design does about that: every product runs on the tensor cores
// (WMMA bf16 -> f32); the loops stop at the causal diagonal; S^T and dP^T
// are formed directly (K4 multiplies K Q^T, not a transposed copy); rope
// is applied to tiles as they are staged and the transpose of rope is
// applied to dq/dk in the epilogue, so roped tensors never reach device
// memory. Accumulators stay in registers across the loop. Not yet done:
// wgmma, TMA, double buffering.
#include "flash_common.cuh"

namespace fa {

struct BwdArgs {
  Operand q, k, v, dout;
  const float* lse;
  const float* delta;
  const bf16* cos;
  const bf16* sin;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int H, KVH, group, q_len, kv_len, causal;
  float scale;
};

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
constexpr size_t DQ_SMEM = (4 * TILE_H + TILE_P) * sizeof(bf16) +
                           (2 * TILE_S + 2 * 64) * sizeof(float);

__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + TILE_H;
  bf16* sK = sdO + TILE_H;
  bf16* sV = sK + TILE_H;
  float* sS = reinterpret_cast<float*>(sV + TILE_H);
  float* sdP = sS + TILE_S;
  float* sLse = sdP + TILE_S;
  float* sDelta = sLse + 64;
  bf16* sdS = reinterpret_cast<bf16*>(sDelta + 64);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const bf16* q = a.q.ptr + b * a.q.sb + h * a.q.sh;
  const bf16* dout = a.dout.ptr + b * a.dout.sb + h * a.dout.sh;
  const bf16* k = a.k.ptr + b * a.k.sb + kvh * a.k.sh;
  const bf16* v = a.v.ptr + b * a.v.sb + kvh * a.v.sh;
  const bf16* cos = a.cos ? a.cos + (long long)b * a.q_len * D : nullptr;
  const bf16* sin = a.sin ? a.sin + (long long)b * a.q_len * D : nullptr;
  const long long row_base = ((long long)b * a.H + h) * a.q_len;

  load_tile(sQ, q, a.q.ss, q0, a.q_len, cos, sin);
  load_tile(sdO, dout, a.dout.ss, q0, a.q_len, nullptr, nullptr);
  if (threadIdx.x < 64) {
    const int row = q0 + threadIdx.x;
    sLse[threadIdx.x] = row < a.q_len ? a.lse[row_base + row] : 0.f;
    sDelta[threadIdx.x] = row < a.q_len ? a.delta[row_base + row] : 0.f;
  }

  int nk = (a.kv_len + BK - 1) / BK;
  if (a.causal) {
    const int last_col = min(q0 + BQ, a.q_len) - 1 + a.kv_len - a.q_len;
    nk = last_col < 0 ? 0 : min(nk, last_col / BK + 1);
  }

  FragC acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile(sK, k, a.k.ss, k0, a.kv_len, cos, sin);
    load_tile(sV, v, a.v.ss, k0, a.kv_len, nullptr, nullptr);
    __syncthreads();
    mm_abt(sS, sQ, sK);    // S  = Q K^T
    mm_abt(sdP, sdO, sV);  // dP = dO V^T
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += NTHREADS) {
      const int r = idx / BK, c = idx % BK;
      float ds = 0.f;
      if (visible(q0 + r, k0 + c, a.q_len, a.kv_len, a.causal)) {
        const float p = __expf(sS[r * LD_S + c] * a.scale - sLse[r]);
        ds = p * (sdP[r * LD_S + c] - sDelta[r]);
      }
      sdS[r * LD_P + c] = __float2bfloat16(ds);
    }
    __syncthreads();
    mm_ab_acc(acc, sdS, sK);  // dQ += dS K
  }
  __syncthreads();
  float* sOut = reinterpret_cast<float*>(smem);  // reuses sQ + sdO
  store_acc(sOut, acc);
  __syncthreads();
  write_rows(a.dq + row_base * D, sOut, a.scale, q0, a.q_len, cos, sin);
}

// ---------------------------------------------------------------- K4
constexpr size_t DKV_SMEM = (4 * TILE_H + 2 * TILE_P) * sizeof(bf16) +
                            (2 * TILE_S + 2 * 64) * sizeof(float);

__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + TILE_H;
  float* sS = reinterpret_cast<float*>(sdO + TILE_H);
  float* sdP = sS + TILE_S;
  bf16* sK = reinterpret_cast<bf16*>(sdP + TILE_S);
  bf16* sV = sK + TILE_H;
  bf16* sP = sV + TILE_H;
  bf16* sdS = sP + TILE_P;
  float* sLse = reinterpret_cast<float*>(sdS + TILE_P);
  float* sDelta = sLse + 64;

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const bf16* k = a.k.ptr + b * a.k.sb + kvh * a.k.sh;
  const bf16* v = a.v.ptr + b * a.v.sb + kvh * a.v.sh;
  const bf16* cos = a.cos ? a.cos + (long long)b * a.q_len * D : nullptr;
  const bf16* sin = a.sin ? a.sin + (long long)b * a.q_len * D : nullptr;

  load_tile(sK, k, a.k.ss, k0, a.kv_len, cos, sin);
  load_tile(sV, v, a.v.ss, k0, a.kv_len, nullptr, nullptr);

  // first q tile that can see key k0: row >= k0 - (kv_len - q_len)
  const int nq = (a.q_len + BQ - 1) / BQ;
  int i0 = 0;
  if (a.causal) {
    const int first_row = k0 - (a.kv_len - a.q_len);
    i0 = first_row <= 0 ? 0 : min(nq, first_row / BQ);
  }

  FragC dk[4], dv[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }

  for (int g = 0; g < a.group; ++g) {
    const int h = kvh * a.group + g;
    const bf16* q = a.q.ptr + b * a.q.sb + h * a.q.sh;
    const bf16* dout = a.dout.ptr + b * a.dout.sb + h * a.dout.sh;
    const long long row_base = ((long long)b * a.H + h) * a.q_len;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();
      load_tile(sQ, q, a.q.ss, q0, a.q_len, cos, sin);
      load_tile(sdO, dout, a.dout.ss, q0, a.q_len, nullptr, nullptr);
      if (threadIdx.x < 64) {
        const int row = q0 + threadIdx.x;
        sLse[threadIdx.x] = row < a.q_len ? a.lse[row_base + row] : 0.f;
        sDelta[threadIdx.x] = row < a.q_len ? a.delta[row_base + row] : 0.f;
      }
      __syncthreads();
      mm_abt(sS, sK, sQ);    // S^T  = K Q^T   [kv, q]
      mm_abt(sdP, sV, sdO);  // dP^T = V dO^T  [kv, q]
      __syncthreads();
      for (int idx = threadIdx.x; idx < BK * BQ; idx += NTHREADS) {
        const int r = idx / BQ, c = idx % BQ;  // r: key row, c: query row
        float p = 0.f, ds = 0.f;
        if (visible(q0 + c, k0 + r, a.q_len, a.kv_len, a.causal)) {
          p = __expf(sS[r * LD_S + c] * a.scale - sLse[c]);
          ds = p * (sdP[r * LD_S + c] - sDelta[c]);
        }
        sP[r * LD_P + c] = __float2bfloat16(p);
        sdS[r * LD_P + c] = __float2bfloat16(ds);
      }
      __syncthreads();
      mm_ab_acc(dv, sP, sdO);  // dV += P^T dO
      mm_ab_acc(dk, sdS, sQ);  // dK += dS^T Q
    }
  }
  __syncthreads();
  float* sOutK = reinterpret_cast<float*>(sQ);  // reuses sQ + sdO
  float* sOutV = sS;                            // reuses sS + sdP
  store_acc(sOutK, dk);
  store_acc(sOutV, dv);
  __syncthreads();
  const long long kv_base = ((long long)b * a.KVH + kvh) * a.kv_len * D;
  write_rows(a.dk + kv_base, sOutK, a.scale, k0, a.kv_len, cos, sin);
  write_rows(a.dv + kv_base, sOutV, 1.f, k0, a.kv_len, nullptr, nullptr);
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

static BwdArgs make_bwd_args(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* cos,
                             const void* sin, int H, int KVH, int q_len, int kv_len,
                             const long long* st, int causal, float scale) {
  BwdArgs a;
  a.q = Operand{static_cast<const bf16*>(q), st[0], st[1], st[2]};
  a.k = Operand{static_cast<const bf16*>(k), st[3], st[4], st[5]};
  a.v = Operand{static_cast<const bf16*>(v), st[6], st[7], st[8]};
  a.dout = Operand{static_cast<const bf16*>(dout), st[9], st[10], st[11]};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.cos = static_cast<const bf16*>(cos);
  a.sin = static_cast<const bf16*>(sin);
  a.dq = a.dk = a.dv = nullptr;
  a.H = H;
  a.KVH = KVH;
  a.group = H / KVH;
  a.q_len = q_len;
  a.kv_len = kv_len;
  a.causal = causal;
  a.scale = scale;
  return a;
}

// `strides` holds 12 values: (batch, head, row) strides of q, k, v, do.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* cos,
                            const void* sin, void* dq, int B, int H, int KVH, int q_len,
                            int kv_len, const long long* strides, int causal, float scale,
                            void* stream) {
  BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, cos, sin, H, KVH, q_len, kv_len,
                            strides, causal, scale);
  a.dq = static_cast<bf16*>(dq);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((q_len + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<<<grid, NTHREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* cos,
                             const void* sin, void* dk, void* dv, int B, int H, int KVH,
                             int q_len, int kv_len, const long long* strides, int causal,
                             float scale, void* stream) {
  BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, cos, sin, H, KVH, q_len, kv_len,
                            strides, causal, scale);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((kv_len + BK - 1) / BK, KVH, B);
  flash_bwd_dkv_kernel<<<grid, NTHREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

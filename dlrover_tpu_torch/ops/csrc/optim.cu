// Optimizer-state kernels for sm_90a (H100): blockwise int8 quantization
// (K5), its inverse (K6), and the one-pass AdamW step over every leaf with
// f32 moments (K7) or 8-bit moments (K8).
//
// Replaces the Pallas TPU kernels
//   K5 dlrover_tpu/ops/quantization.py  quantize_int8 -> _quant_kernel
//   K6 dlrover_tpu/ops/quantization.py  dequantize_int8 -> _dequant_kernel
//   K7 dlrover_tpu/ops/fused_optim.py   fused_adamw(bits=32) -> _fused_adam_kernel
//   K8 dlrover_tpu/ops/fused_optim.py   fused_adamw(bits=8) -> _fused_adam8bit_kernel
//
// Bound on this card: all four do a few f32 operations per byte they
// move, far below the H100's ~20 f32 operations per byte of HBM3
// (67 TFLOP/s over 3.35 TB/s), so each is bound by device-memory bytes:
//   K5  9 B/element + 4 B/row   (x, u read; q written; scale written)
//   K6  5 B/element + 4 B/row   (q read; out written; scale read)
//   K7 28 B/element             (g, p, mu, nu read; p, mu, nu written)
//   K8 20 B/element + 16 B/row  (g, p, u, 2 codes read; p, 2 codes
//                                written; 2 scales read and written)
// At nano-350m's tree (271,090,688 elements, 1,058,948 rows) that is
// 7.59 GB, 2.27 ms for K7 and 5.44 GB, 1.62 ms for K8.
//
// Design for that bound: every byte is touched once. One warp owns one
// 256-element row (the quantization block), so the two row reductions of
// K5/K8 (absmax of mu, max of nu) are warp shuffles in registers and no
// reduction crosses blocks. A lane holds 8 elements, at columns
// lane*4 + {0..3} and 128 + lane*4 + {0..3}, so each of a warp's loads is
// one contiguous 512-byte run (two 16-byte loads a lane for f32, two
// 4-byte loads for codes). K7/K8 read each grad and write each param in
// place through a leaf table (pointer, grad pointer, numel, first row per
// leaf) instead of copying the leaves into a flat buffer and back, as the
// TPU step does to save dispatches: the copy would double the bytes. The
// moments stay flat in [rows, 256] with each leaf starting at a row edge,
// the JAX package's layout. One launch covers every leaf; elements past
// a leaf's numel read as 0, as JAX's zero padding gives.
//
// Numerics mirror the Pallas kernels' op order as XLA compiles them:
// products and sums are __fmul_rn / __fadd_rn so that nvcc does not
// contract them into FMAs; a division by a constant (absmax / 127, the
// log step) is a product with the constant's f32 reciprocal, as XLA's
// algebraic simplifier rewrites it; other divisions and the square root
// are the IEEE ones (no --use_fast_math); round is rintf (half to even,
// as jnp.round); values are clamped before the conversion to int8/uint8.

#include <cuda_runtime.h>
#include <stdint.h>

#define QBLOCK 256
#define ROWS_PER_CTA 8  // one warp per row
#define THREADS (32 * ROWS_PER_CTA)

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A lane's j-th element sits at column (j / 4) * 128 + lane * 4 + j % 4
// of its row.

// 8 f32 values of a leaf, from element `start` of its row on; 0 past n or
// when ptr is null (a leaf without a grad)
__device__ __forceinline__ void load_leaf(const float* ptr, long long start,
                                          long long n, int lane, float v[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    long long e = start + h * 128 + lane * 4;
    if (ptr != nullptr && e + 4 <= n &&
        (reinterpret_cast<uintptr_t>(ptr + e) & 15) == 0) {
      float4 x = *reinterpret_cast<const float4*>(ptr + e);
      v[4 * h] = x.x; v[4 * h + 1] = x.y; v[4 * h + 2] = x.z; v[4 * h + 3] = x.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[4 * h + k] = (ptr != nullptr && e + k < n) ? ptr[e + k] : 0.f;
    }
  }
}

__device__ __forceinline__ void store_leaf(float* ptr, long long start,
                                           long long n, int lane,
                                           const float v[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    long long e = start + h * 128 + lane * 4;
    if (e + 4 <= n && (reinterpret_cast<uintptr_t>(ptr + e) & 15) == 0) {
      *reinterpret_cast<float4*>(ptr + e) =
          make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (e + k < n) ptr[e + k] = v[4 * h + k];
    }
  }
}

// a full row of a flat [rows, 256] f32 array (16-byte aligned)
__device__ __forceinline__ void load_row(const float* row, int lane, float v[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float4 x = *reinterpret_cast<const float4*>(row + h * 128 + lane * 4);
    v[4 * h] = x.x; v[4 * h + 1] = x.y; v[4 * h + 2] = x.z; v[4 * h + 3] = x.w;
  }
}

__device__ __forceinline__ void store_row(float* row, int lane, const float v[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<float4*>(row + h * 128 + lane * 4) =
        make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
}

// 8 byte codes of a row (4-byte aligned words), unpacked / packed
__device__ __forceinline__ void load_codes(const uint8_t* row, int lane, int c[8],
                                           bool is_signed) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w = *reinterpret_cast<const uint32_t*>(row + h * 128 + lane * 4);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t b = (w >> (8 * k)) & 0xffu;
      c[4 * h + k] = is_signed ? static_cast<int>(static_cast<int8_t>(b))
                               : static_cast<int>(b);
    }
  }
}

__device__ __forceinline__ void store_codes(uint8_t* row, int lane, const int c[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w |= (static_cast<uint32_t>(c[4 * h + k]) & 0xffu) << (8 * k);
    *reinterpret_cast<uint32_t*>(row + h * 128 + lane * 4) = w;
  }
}

// int8 absmax scale with the zero-row guard (quantization._symmetric_scale)
__device__ __forceinline__ float symmetric_scale(float absmax) {
  return absmax == 0.f ? 1.f : __fmul_rn(absmax, 1.f / 127.f);
}

// mu re-encode: clip(floor(x / scale + u), -127, 127) or, without u,
// clip(round_half_even(x / scale), -127, 127)
__device__ __forceinline__ int encode_int8(float x, float scale, const float* u, int j) {
  float s = __fdiv_rn(x, scale);
  float r = u != nullptr ? floorf(__fadd_rn(s, u[j])) : rintf(s);
  return static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
}

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, clip;
  int has_wd, has_clip;
};

// the leaf that holds flat row `row`: the last with first_row <= row.
// table is int64 [n_leaves, 4]: param ptr, grad ptr (0: none), numel,
// first row
__device__ __forceinline__ int find_leaf(const long long* table, int n_leaves,
                                         long long row) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (table[4 * mid + 3] <= row) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// optax.clip_by_global_norm: select(norm < max, g, g / norm * max)
__device__ __forceinline__ float clip_grad(float g, float gnorm, const Hyper& h) {
  if (h.has_clip && !(gnorm < h.clip)) return __fmul_rn(__fdiv_rn(g, gnorm), h.clip);
  return g;
}

// bias-corrected Adam direction, + wd * p, scaled by -lr
__device__ __forceinline__ float adam_update(float mu, float nu, float p,
                                             float neg_lr, float bc1, float bc2,
                                             const Hyper& h) {
  float mu_hat = __fdiv_rn(mu, bc1);
  float nu_hat = __fdiv_rn(nu, bc2);
  float upd = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), h.eps));
  if (h.has_wd) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  return __fmul_rn(upd, neg_lr);
}

// ---------------------------------------------------------------------------
// K5: blockwise absmax int8 quantization of x (n elements, read as
// [rows, 256] with zeros past n)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
quantize_int8_kernel(const float* __restrict__ x, long long n, long long rows,
                     const float* __restrict__ u, int8_t* __restrict__ q,
                     float* __restrict__ scales) {
  long long row = static_cast<long long>(blockIdx.x) * ROWS_PER_CTA + threadIdx.x / 32;
  if (row >= rows) return;
  int lane = threadIdx.x & 31;
  float v[8];
  load_leaf(x, row * QBLOCK, n, lane, v);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  float scale = symmetric_scale(warp_max(amax));
  float uu[8];
  if (u != nullptr) load_row(u + row * QBLOCK, lane, uu);
  int c[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] = encode_int8(v[j], scale, u != nullptr ? uu : nullptr, j);
  store_codes(reinterpret_cast<uint8_t*>(q + row * QBLOCK), lane, c);
  if (lane == 0) scales[row] = scale;
}

// ---------------------------------------------------------------------------
// K6: out[:n] = (q * scale[row]) flattened
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
dequantize_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                       long long rows, long long n, float* __restrict__ out) {
  long long row = static_cast<long long>(blockIdx.x) * ROWS_PER_CTA + threadIdx.x / 32;
  if (row >= rows) return;
  int lane = threadIdx.x & 31;
  float s = scales[row];
  int c[8];
  load_codes(reinterpret_cast<const uint8_t*>(q + row * QBLOCK), lane, c, true);
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(static_cast<float>(c[j]), s);
  store_leaf(out, row * QBLOCK, n, lane, v);
}

// ---------------------------------------------------------------------------
// K7: AdamW with f32 moments over every leaf. sc = [-lr, bc1, bc2, gnorm]
// on the device.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
fused_adamw32_kernel(const long long* __restrict__ table, int n_leaves,
                     long long rows, float* __restrict__ mu, float* __restrict__ nu,
                     const float* __restrict__ sc, Hyper h) {
  long long row = static_cast<long long>(blockIdx.x) * ROWS_PER_CTA + threadIdx.x / 32;
  if (row >= rows) return;
  int lane = threadIdx.x & 31;
  int leaf = find_leaf(table, n_leaves, row);
  float* p = reinterpret_cast<float*>(table[4 * leaf]);
  const float* g = reinterpret_cast<const float*>(table[4 * leaf + 1]);
  long long numel = table[4 * leaf + 2];
  long long start = (row - table[4 * leaf + 3]) * QBLOCK;
  float neg_lr = sc[0], bc1 = sc[1], bc2 = sc[2], gnorm = sc[3];

  float gv[8], pv[8], m[8], v[8];
  load_leaf(g, start, numel, lane, gv);
  load_leaf(p, start, numel, lane, pv);
  load_row(mu + row * QBLOCK, lane, m);
  load_row(nu + row * QBLOCK, lane, v);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float gg = clip_grad(gv[j], gnorm, h);
    // _adam_math: (1-b1)*g + b1*mu ; (1-b2)*(g*g) + b2*nu
    m[j] = __fadd_rn(__fmul_rn(h.omb1, gg), __fmul_rn(h.b1, m[j]));
    v[j] = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(gg, gg)), __fmul_rn(h.b2, v[j]));
    pv[j] = __fadd_rn(pv[j], adam_update(m[j], v[j], pv[j], neg_lr, bc1, bc2, h));
  }
  store_row(mu + row * QBLOCK, lane, m);
  store_row(nu + row * QBLOCK, lane, v);
  store_leaf(p, start, numel, lane, pv);
}

// ---------------------------------------------------------------------------
// K8: AdamW with 8-bit moments over every leaf: decode, EMA, update,
// re-encode (mu int8 linear with stochastic rounding from u, nu uint8 on
// the log codebook).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
fused_adamw8_kernel(const long long* __restrict__ table, int n_leaves,
                    long long rows, int8_t* __restrict__ mu_q,
                    float* __restrict__ mu_scale, uint8_t* __restrict__ nu_q,
                    float* __restrict__ nu_scale, const float* __restrict__ u,
                    const float* __restrict__ sc, Hyper h, float log_lo,
                    float log_step, float inv_log_step) {
  long long row = static_cast<long long>(blockIdx.x) * ROWS_PER_CTA + threadIdx.x / 32;
  if (row >= rows) return;
  int lane = threadIdx.x & 31;
  int leaf = find_leaf(table, n_leaves, row);
  float* p = reinterpret_cast<float*>(table[4 * leaf]);
  const float* g = reinterpret_cast<const float*>(table[4 * leaf + 1]);
  long long numel = table[4 * leaf + 2];
  long long start = (row - table[4 * leaf + 3]) * QBLOCK;
  float neg_lr = sc[0], bc1 = sc[1], bc2 = sc[2], gnorm = sc[3];

  float gv[8], pv[8], uu[8];
  int mc[8], nc[8];
  load_leaf(g, start, numel, lane, gv);
  load_leaf(p, start, numel, lane, pv);
  load_row(u + row * QBLOCK, lane, uu);
  uint8_t* mrow = reinterpret_cast<uint8_t*>(mu_q + row * QBLOCK);
  uint8_t* nrow = nu_q + row * QBLOCK;
  load_codes(mrow, lane, mc, true);
  load_codes(nrow, lane, nc, false);
  float ms = mu_scale[row], ns = nu_scale[row];

  float m[8], v[8];
  float amax = 0.f, vmax = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float gg = clip_grad(gv[j], gnorm, h);
    float mu = __fmul_rn(static_cast<float>(mc[j]), ms);
    // log-codebook decode: code 0 is exact zero, 1..255 geometric
    float code = nc[j] == 0 ? 0.f
        : expf(__fadd_rn(log_lo, __fmul_rn(static_cast<float>(nc[j] - 1), log_step)));
    float nu = __fmul_rn(code, ns);
    // low_bit.py order: b1*mu + (1-b1)*g ; b2*nu + (1-b2)*g*g
    m[j] = __fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.omb1, gg));
    v[j] = __fadd_rn(__fmul_rn(h.b2, nu), __fmul_rn(__fmul_rn(h.omb2, gg), gg));
    pv[j] = __fadd_rn(pv[j], adam_update(m[j], v[j], pv[j], neg_lr, bc1, bc2, h));
    amax = fmaxf(amax, fabsf(m[j]));
    vmax = fmaxf(vmax, v[j]);
  }
  store_leaf(p, start, numel, lane, pv);

  float scale = symmetric_scale(warp_max(amax));
  vmax = warp_max(vmax);
  float vscale = vmax == 0.f ? 1.f : vmax;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mc[j] = encode_int8(m[j], scale, uu, j);
    float rel = __fdiv_rn(v[j], vscale);
    float lr = logf(fmaxf(rel, 1e-12f));  // LOG_FLOOR
    float idx = __fadd_rn(rintf(__fmul_rn(__fadd_rn(lr, -log_lo), inv_log_step)), 1.f);
    idx = fminf(fmaxf(idx, 1.f), 255.f);
    nc[j] = rel > 0.f ? static_cast<int>(idx) : 0;
  }
  store_codes(mrow, lane, mc);
  store_codes(nrow, lane, nc);
  if (lane == 0) {
    mu_scale[row] = scale;
    nu_scale[row] = vscale;
  }
}

inline unsigned grid_for(long long rows) {
  return static_cast<unsigned>((rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entries: each launches on `stream` and returns cudaGetLastError()
// ---------------------------------------------------------------------------
extern "C" {

int quantize_int8(const void* x, long long n, long long rows, const void* u,
                  void* q, void* scales, void* stream) {
  if (rows > 0)
    quantize_int8_kernel<<<grid_for(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, rows, static_cast<const float*>(u),
        static_cast<int8_t*>(q), static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

int dequantize_int8(const void* q, const void* scales, long long rows, long long n,
                    void* out, void* stream) {
  if (rows > 0)
    dequantize_int8_kernel<<<grid_for(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales), rows, n,
        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int fused_adamw32(const void* table, int n_leaves, long long rows, void* mu, void* nu,
                  const void* sc, float b1, float omb1, float b2, float omb2, float eps,
                  float wd, int has_wd, float clip, int has_clip, void* stream) {
  Hyper h{b1, omb1, b2, omb2, eps, wd, clip, has_wd, has_clip};
  if (rows > 0)
    fused_adamw32_kernel<<<grid_for(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(table), n_leaves, rows, static_cast<float*>(mu),
        static_cast<float*>(nu), static_cast<const float*>(sc), h);
  return static_cast<int>(cudaGetLastError());
}

int fused_adamw8(const void* table, int n_leaves, long long rows, void* mu_q,
                 void* mu_scale, void* nu_q, void* nu_scale, const void* u,
                 const void* sc, float b1, float omb1, float b2, float omb2, float eps,
                 float wd, int has_wd, float clip, int has_clip, float log_lo,
                 float log_step, float inv_log_step, void* stream) {
  Hyper h{b1, omb1, b2, omb2, eps, wd, clip, has_wd, has_clip};
  if (rows > 0)
    fused_adamw8_kernel<<<grid_for(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(table), n_leaves, rows, static_cast<int8_t*>(mu_q),
        static_cast<float*>(mu_scale), static_cast<uint8_t*>(nu_q),
        static_cast<float*>(nu_scale), static_cast<const float*>(u),
        static_cast<const float*>(sc), h, log_lo, log_step, inv_log_step);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

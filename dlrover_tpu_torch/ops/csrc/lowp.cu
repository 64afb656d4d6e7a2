// Low-precision compute kernels for sm_90a (H100): the quantize steps
// around the fp8 and int8 GEMMs of ops/fp8.py and ops/quantization.py.
//
//   K15 quantize_fp8            per-tensor amax, then x / scale cast to
//                               e4m3 or e5m2, in two launches
//   K16 quantize_int8_channels  symmetric int8 per channel (per row of an
//                               activation, per column of a weight)
//   K17 dequantize_int32        the int8 GEMM's epilogue: int32 x the two
//                               per-channel scales, cast to bf16 or f32
//
// They replace no TPU kernel. The JAX package writes these steps as plain
// jnp around its dots (dlrover_tpu/ops/fp8.py quantize_e4m3/_fp8_dot_impl,
// dlrover_tpu/ops/quantization.py _per_channel_q/_int8_dot_impl), and XLA
// fuses each chain into the dot's operand read or epilogue. Eager PyTorch
// would run each chain as 4-6 launches that re-read the operand; these
// kernels read it once or twice and write the codes once.
//
// Bound on this card: a few operations per element, so all three are bound
// by device-memory bytes (3.35 TB/s):
//   K15  sizeof(x) + 1 B/element (+1 B for the transposed copy)
//   K16  sizeof(x) + 1 B/element + 4 B/channel
//   K17  4 B read + sizeof(out) B written/element + 4 B/row and column
// Design for that bound: 16-byte loads and stores where the rows allow,
// the transposed writes staged through a shared-memory tile so that both
// the reads and the writes are contiguous runs. K15's amax is a grid-wide
// reduction: each block writes its partial, and the last block to finish
// (a self-resetting ticket, so a launch needs no memset and CUDA-graph
// replays are safe) reduces the partials and writes the scale to device
// memory; the quantize launch reads it there, so no host sync happens.
// K16's rows mode keeps a row's reduction inside one block, which reads
// the row twice (the second time mostly from L1/L2); its columns mode is
// K15's shape on strips of 64 columns: partial maxima over 256-row chunks,
// the last block of a strip (a ticket per strip) writing the strip's
// scales, then a quantize launch of 64 x 64 tiles.
//
// Numerics follow the JAX code as XLA compiles it under jit: the division
// by the format's max (or by 127) is a product with the f32 reciprocal
// (XLA's algebraic simplifier rewrites a division by a constant), the
// division by the scale is an IEEE one (__fdiv_rn), the max propagates
// NaN (jnp.max), rounding to int8 is rintf (half to even, jnp.round) then
// a clamp to +-127, and the fp8 casts do not saturate (__NV_NOSAT): e4m3
// overflows to NaN and e5m2 to inf, as ml_dtypes' casts do.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int AMAX_BLOCKS = 1024;
constexpr int TILE = 64;       // K15's quantize tile: 64 x 64 elements
// a staged tile's row of TILE codes, padded to 68 bytes: the 8 column
// groups that a warp writes land in 4 banks (80 bytes put all in one)
constexpr int TILE_PITCH = TILE + 4;
constexpr int COL_STRIP = 64;   // K16 columns mode: columns per block
constexpr int CHUNK_ROWS = 256; // K16 columns mode: rows per amax block
constexpr int MAX_STRIPS = 4096;  // K16 columns mode: C up to 262144
constexpr float INV_127 = 1.0f / 127.0f;

__device__ unsigned int amax_ticket;  // K15's last-block ticket
__device__ unsigned int col_tickets[MAX_STRIPS];  // K16's, one a strip

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// max that propagates NaN, as jnp.max does
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_nmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the block's max of v (every thread gets it)
__device__ __forceinline__ float block_nmax(float v) {
  __shared__ float part[THREADS / 32];
  __shared__ float total;
  v = warp_nmax(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < THREADS / 32 ? part[threadIdx.x] : 0.f;
    w = warp_nmax(w);
    if (threadIdx.x == 0) total = w;
  }
  __syncthreads();
  float out = total;
  __syncthreads();
  return out;
}

// VEC elements of T in one 16-byte load
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float v[4]) {
    float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float v[8]) {
    uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x; v[2 * i + 1] = f.y;
    }
  }
};

template <bool E5M2>
__device__ __forceinline__ uint8_t to_fp8(float y) {
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(
      y, __NV_NOSAT, E5M2 ? __NV_E5M2 : __NV_E4M3));
}

// 4 or 8 one-byte codes packed little-endian for one vector store
__device__ __forceinline__ uint32_t pack4(const uint8_t* c) {
  return (uint32_t)c[0] | ((uint32_t)c[1] << 8) | ((uint32_t)c[2] << 16) |
         ((uint32_t)c[3] << 24);
}

// 16 staged codes from a 4-byte-aligned row of a padded tile
__device__ __forceinline__ uint4 load16(const void* p) {
  const uint32_t* w = static_cast<const uint32_t*>(p);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int8_t to_int8(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// ---------------------------------------------------------------------------
// K15: per-tensor amax, then quantize
// ---------------------------------------------------------------------------

// Launch 1: amax(|x|) over n elements; the last block writes
// scale = max(amax, 1e-12) * (1 / fmax) to scale_out[0].
template <typename T>
__global__ void __launch_bounds__(THREADS)
fp8_amax_kernel(const T* __restrict__ x, long long n, int vec_ok,
                float* __restrict__ partial, float inv_fmax,
                float* __restrict__ scale_out) {
  constexpr int V = Vec<T>::N;
  float m = 0.f;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec_ok) {
    const long long nv = n / V;
#pragma unroll 4
    for (long long i = tid; i < nv; i += stride) {
      float v[V];
      Vec<T>::load(x + i * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) m = nmax(m, fabsf(v[j]));
    }
    done = nv * V;
  }
  for (long long i = done + tid; i < n; i += stride) m = nmax(m, fabsf(to_f(x[i])));
  m = block_nmax(m);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = m;
    __threadfence();
    last = atomicInc(&amax_ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float t = 0.f;
  for (int i = threadIdx.x; i < gridDim.x; i += THREADS)
    t = nmax(t, reinterpret_cast<volatile float*>(partial)[i]);
  t = block_nmax(t);
  if (threadIdx.x == 0) scale_out[0] = __fmul_rn(nmax(t, 1e-12f), inv_fmax);
}

// Launch 2: q = fp8(x / scale) for x viewed as [R, C] row-major; q in the
// same layout (if q) and/or transposed, qt [C, R] (if qt). One 64 x 64
// tile a block; the transposed codes go through shared memory.
template <typename T, bool E5M2>
__global__ void __launch_bounds__(THREADS)
fp8_quant_kernel(const T* __restrict__ x, long long R, long long C, int vec_ok,
                 const float* __restrict__ scale_ptr, uint8_t* __restrict__ q,
                 uint8_t* __restrict__ qt) {
  __shared__ __align__(16) uint8_t tile[TILE][TILE_PITCH];  // [col][row]
  const float scale = *scale_ptr;
  const long long r0 = (long long)blockIdx.y * TILE;
  const long long c0 = (long long)blockIdx.x * TILE;
  const bool full = vec_ok && r0 + TILE <= R && c0 + TILE <= C;
  if (full) {
    // 8 elements a thread a pass: 8 threads cover a row of the tile
    constexpr int PER = 8;
    const int tc = (threadIdx.x % (TILE / PER)) * PER;
#pragma unroll
    for (int tr = threadIdx.x / (TILE / PER); tr < TILE; tr += THREADS / (TILE / PER)) {
      const T* src = x + (r0 + tr) * C + c0 + tc;
      float v[PER];
      if constexpr (Vec<T>::N == 8) {
        Vec<T>::load(src, v);
      } else {
        Vec<T>::load(src, v);
        Vec<T>::load(src + 4, v + 4);
      }
      uint8_t code[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        code[j] = to_fp8<E5M2>(__fdiv_rn(v[j], scale));
        tile[tc + j][tr] = code[j];
      }
      if (q != nullptr)
        *reinterpret_cast<uint2*>(q + (r0 + tr) * C + c0 + tc) =
            make_uint2(pack4(code), pack4(code + 4));
    }
    if (qt == nullptr) return;
    __syncthreads();
    // qt rows c0..c0+63, 64 bytes each: 4 threads a row, 16 bytes each
    const int row = threadIdx.x / 4, part = (threadIdx.x % 4) * 16;
    *reinterpret_cast<uint4*>(qt + (c0 + row) * R + r0 + part) = load16(&tile[row][part]);
    return;
  }
  // ragged or unaligned tile: one element a thread a pass
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const long long r = r0 + i / TILE, c = c0 + i % TILE;
    if (r >= R || c >= C) continue;
    const uint8_t code = to_fp8<E5M2>(__fdiv_rn(to_f(x[r * C + c]), scale));
    if (q != nullptr) q[r * C + c] = code;
    if (qt != nullptr) qt[c * R + r] = code;
  }
}

// ---------------------------------------------------------------------------
// K16: int8 per channel
// ---------------------------------------------------------------------------

// Rows mode: the amax over each row of x [R, C]; q [R, C], scale [R].
// One block a row (grid-stride over rows); the second read of the row
// (the quantize) mostly hits L1/L2.
template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_rows_kernel(const T* __restrict__ x, long long R, long long C, int vec_ok,
                 int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int V = Vec<T>::N;
  for (long long r = blockIdx.x; r < R; r += gridDim.x) {
    const T* row = x + r * C;
    int8_t* out = q + r * C;
    const long long nv = vec_ok ? C / V : 0;
    float m = 0.f;
    for (long long i = threadIdx.x; i < nv; i += THREADS) {
      float v[V];
      Vec<T>::load(row + i * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) m = nmax(m, fabsf(v[j]));
    }
    for (long long i = nv * V + threadIdx.x; i < C; i += THREADS)
      m = nmax(m, fabsf(to_f(row[i])));
    m = block_nmax(m);
    const float s = m == 0.f ? 1.f : __fmul_rn(m, INV_127);
    if (threadIdx.x == 0) scale[r] = s;
    for (long long i = threadIdx.x; i < nv; i += THREADS) {
      float v[V];
      Vec<T>::load(row + i * V, v);
      uint8_t code[V];
#pragma unroll
      for (int j = 0; j < V; ++j) code[j] = static_cast<uint8_t>(to_int8(v[j], s));
      if constexpr (V == 8)
        *reinterpret_cast<uint2*>(out + i * V) = make_uint2(pack4(code), pack4(code + 4));
      else
        *reinterpret_cast<uint32_t*>(out + i * V) = pack4(code);
    }
    for (long long i = nv * V + threadIdx.x; i < C; i += THREADS)
      out[i] = to_int8(to_f(row[i]), s);
  }
}

// Columns mode, in two launches so that the grid fills the card whatever
// the number of columns: the amax over each column of x [R, C], then the
// codes written transposed, qt [C, R] (the contracted dim contiguous, as
// the int8 GEMM takes its second operand), scale [C]. Both launches cut x
// into strips of 64 columns: a thread reads 8 neighbouring columns of a
// row in one 16-byte load, 8 threads a row, 32 rows at a time.

// 8 columns of row r from column c (zeros past C)
template <typename T>
__device__ __forceinline__ void load8(const T* x, long long r, long long C,
                                      long long c, bool vec, float v[8]) {
  const T* p = x + r * C + c;
  if (vec) {
    if constexpr (Vec<T>::N == 8) {
      Vec<T>::load(p, v);
    } else {
      Vec<T>::load(p, v);
      Vec<T>::load(p + 4, v + 4);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c + j < C ? to_f(p[j]) : 0.f;
  }
}

// Launch 1: block (strip, chunk) takes the max over CHUNK_ROWS rows of
// its 64 columns into partial[chunk][c]; the last block of a strip to
// finish (a self-resetting ticket per strip) reduces the strip's partials
// and writes its scales.
template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_cols_amax_kernel(const T* __restrict__ x, long long R, long long C, int vec_ok,
                      float* __restrict__ partial, float* __restrict__ scale) {
  __shared__ float red[THREADS / 8][COL_STRIP + 1];
  __shared__ bool last;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const long long c = (long long)blockIdx.x * COL_STRIP + tx * 8;
  const long long r0 = (long long)blockIdx.y * CHUNK_ROWS;
  const bool vec = vec_ok && c + 8 <= C;
  float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c < C) {
#pragma unroll 4
    for (int i = ty; i < CHUNK_ROWS; i += THREADS / 8) {
      if (r0 + i >= R) break;
      float v[8];
      load8(x, r0 + i, C, c, vec, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = nmax(m[j], fabsf(v[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[ty][tx * 8 + j] = m[j];
  __syncthreads();
  const long long col = (long long)blockIdx.x * COL_STRIP + threadIdx.x;
  if (threadIdx.x < COL_STRIP) {
    float t = red[0][threadIdx.x];
    for (int w = 1; w < THREADS / 8; ++w) t = nmax(t, red[w][threadIdx.x]);
    if (col < C) partial[blockIdx.y * C + col] = t;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(&col_tickets[blockIdx.x], gridDim.y - 1) == gridDim.y - 1;
  __syncthreads();
  if (!last || threadIdx.x >= COL_STRIP || col >= C) return;
  float t = 0.f;
  for (int k = 0; k < gridDim.y; ++k)
    t = nmax(t, reinterpret_cast<volatile float*>(partial)[k * C + col]);
  scale[col] = t == 0.f ? 1.f : __fmul_rn(t, INV_127);
}

// Launch 2: block (strip, tile) quantizes 64 rows of its 64 columns and
// stages the codes as [column][row], so that each column's 64 codes go
// out as one 64-byte run.
template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_cols_quant_kernel(const T* __restrict__ x, long long R, long long C, int vec_ok,
                       const float* __restrict__ scale, int8_t* __restrict__ qt) {
  __shared__ __align__(16) int8_t tile[COL_STRIP][TILE_PITCH];
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const long long c = (long long)blockIdx.x * COL_STRIP + tx * 8;
  const long long r0 = (long long)blockIdx.y * TILE;
  const bool vec = vec_ok && c + 8 <= C;
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = c + j < C ? scale[c + j] : 1.f;
#pragma unroll
  for (int i = ty; i < TILE; i += THREADS / 8) {
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (c < C && r0 + i < R) load8(x, r0 + i, C, c, vec, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) tile[tx * 8 + j][i] = to_int8(v[j], s[j]);
  }
  __syncthreads();
  const bool full = vec_ok && R % 16 == 0 && r0 + TILE <= R &&
                    (long long)blockIdx.x * COL_STRIP + COL_STRIP <= C;
  if (full) {
    // 64 columns x 64 codes: 4 threads a column, 16 bytes each
    const int cc = threadIdx.x / 4, part = (threadIdx.x % 4) * 16;
    *reinterpret_cast<uint4*>(qt + ((long long)blockIdx.x * COL_STRIP + cc) * R + r0 + part) =
        load16(&tile[cc][part]);
    return;
  }
  for (int i = threadIdx.x; i < COL_STRIP * TILE; i += THREADS) {
    const int cc = i / TILE, tr = i % TILE;
    const long long col = (long long)blockIdx.x * COL_STRIP + cc, r = r0 + tr;
    if (col < C && r < R) qt[col * R + r] = tile[cc][tr];
  }
}

// ---------------------------------------------------------------------------
// K17: the int8 GEMM's epilogue
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store(float* p, int n, const float* v) {
  if (n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < n; ++j) p[j] = v[j];
  }
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int n, const float* v) {
  if (n == 4) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                           __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  } else {
    for (int j = 0; j < n; ++j) p[j] = __float2bfloat16_rn(v[j]);
  }
}

// out[m, n] = float(acc[m, n]) * sa[m] * sb[n] (int8_dot's order), or
// float(acc) * (sa[m] * sb[n]) (int8_einsum's: the scales' product first).
// A block a row (grid-stride over rows), 4 columns a thread a step: no
// index division.
template <typename O>
__global__ void __launch_bounds__(THREADS)
dequant_kernel(const int32_t* __restrict__ acc, long long M, long long N, int vec_ok,
               const float* __restrict__ sa, const float* __restrict__ sb,
               int product_first, O* __restrict__ out) {
  const int W = vec_ok ? 4 : 1;
  for (long long m = blockIdx.x; m < M; m += gridDim.x) {
    const int32_t* row = acc + m * N;
    O* dst = out + m * N;
    const float s = sa[m];
    for (long long n = (long long)threadIdx.x * W; n < N; n += (long long)THREADS * W) {
      int32_t a[4];
      if (W == 4) {
        int4 v = *reinterpret_cast<const int4*>(row + n);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      } else {
        a[0] = row[n];
      }
      float r[4];
      for (int j = 0; j < W; ++j) {
        const float f = __int2float_rn(a[j]);
        r[j] = product_first ? __fmul_rn(f, __fmul_rn(s, sb[n + j]))
                             : __fmul_rn(__fmul_rn(f, s), sb[n + j]);
      }
      store(dst + n, W, r);
    }
  }
}

}  // namespace

extern "C" {

// K15. x [R, C] (bf16 if in_bf16, else f32), contiguous. With
// given_scale null, launch 1 writes the scale to scale_out; the quantize
// launch reads given_scale or scale_out. q [R, C] and qt [C, R] are
// written where not null. partial: AMAX_BLOCKS floats of scratch.
int quantize_fp8(const void* x, int in_bf16, long long R, long long C, int e5m2,
                 float inv_fmax, const void* given_scale, void* partial,
                 void* scale_out, void* q, void* qt, int vec_ok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = R * C;
  const float* scale = static_cast<const float*>(given_scale);
  if (scale == nullptr) {
    const int per_block = THREADS * (in_bf16 ? 8 : 4);
    long long g = (n + per_block - 1) / per_block;
    const int grid = static_cast<int>(g > AMAX_BLOCKS ? AMAX_BLOCKS : (g < 1 ? 1 : g));
    if (in_bf16)
      fp8_amax_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), n, vec_ok,
          static_cast<float*>(partial), inv_fmax, static_cast<float*>(scale_out));
    else
      fp8_amax_kernel<float><<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(x), n, vec_ok, static_cast<float*>(partial),
          inv_fmax, static_cast<float*>(scale_out));
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    scale = static_cast<const float*>(scale_out);
  }
  dim3 grid((C + TILE - 1) / TILE, (R + TILE - 1) / TILE);
  uint8_t* qo = static_cast<uint8_t*>(q);
  uint8_t* qto = static_cast<uint8_t*>(qt);
#define DLR_FP8_QUANT(T, E) \
  fp8_quant_kernel<T, E><<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), R, C, vec_ok, scale, qo, qto)
  if (in_bf16) {
    if (e5m2) {
      DLR_FP8_QUANT(__nv_bfloat16, true);
    } else {
      DLR_FP8_QUANT(__nv_bfloat16, false);
    }
  } else {
    if (e5m2) {
      DLR_FP8_QUANT(float, true);
    } else {
      DLR_FP8_QUANT(float, false);
    }
  }
#undef DLR_FP8_QUANT
  return static_cast<int>(cudaGetLastError());
}

// K16. x [R, C] contiguous. cols == 0: scale per row, q [R, C];
// cols == 1: scale per column, q transposed [C, R], partial: scratch of
// ceil(R / 256) x C floats (null for rows).
int quantize_int8_channels(const void* x, int in_bf16, long long R, long long C,
                           int cols, void* q, void* scale, void* partial,
                           int vec_ok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0) return 0;
  if (cols) {
    const long long strips = (C + COL_STRIP - 1) / COL_STRIP;
    if (strips > MAX_STRIPS) return static_cast<int>(cudaErrorInvalidValue);
    dim3 amax_grid(strips, (R + CHUNK_ROWS - 1) / CHUNK_ROWS);
    dim3 quant_grid(strips, (R + TILE - 1) / TILE);
#define DLR_INT8_COLS(T)                                                            \
  do {                                                                              \
    int8_cols_amax_kernel<T><<<amax_grid, THREADS, 0, st>>>(                        \
        static_cast<const T*>(x), R, C, vec_ok, static_cast<float*>(partial),       \
        static_cast<float*>(scale));                                                \
    if (cudaPeekAtLastError() == cudaSuccess)                                       \
      int8_cols_quant_kernel<T><<<quant_grid, THREADS, 0, st>>>(                    \
          static_cast<const T*>(x), R, C, vec_ok, static_cast<const float*>(scale), \
          static_cast<int8_t*>(q));                                                 \
  } while (0)
    if (in_bf16) {
      DLR_INT8_COLS(__nv_bfloat16);
    } else {
      DLR_INT8_COLS(float);
    }
#undef DLR_INT8_COLS
  } else {
    const int grid = static_cast<int>(R < 132LL * 16 ? R : 132LL * 16);
    if (in_bf16)
      int8_rows_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), R, C, vec_ok,
          static_cast<int8_t*>(q), static_cast<float*>(scale));
    else
      int8_rows_kernel<float><<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(x), R, C, vec_ok, static_cast<int8_t*>(q),
          static_cast<float*>(scale));
  }
  return static_cast<int>(cudaGetLastError());
}

// K17. acc [M, N] int32 contiguous, sa [M], sb [N] f32; out [M, N] bf16 if
// out_bf16, else f32.
int dequantize_int32(const void* acc, long long M, long long N, const void* sa,
                     const void* sb, int product_first, int out_bf16, void* out,
                     int vec_ok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M * N == 0) return 0;
  const int grid = static_cast<int>(M < 132LL * 16 ? M : 132LL * 16);
  if (out_bf16)
    dequant_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const int32_t*>(acc), M, N, vec_ok, static_cast<const float*>(sa),
        static_cast<const float*>(sb), product_first, static_cast<__nv_bfloat16*>(out));
  else
    dequant_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const int32_t*>(acc), M, N, vec_ok, static_cast<const float*>(sa),
        static_cast<const float*>(sb), product_first, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

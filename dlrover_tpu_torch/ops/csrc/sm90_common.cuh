// Hopper (sm_90a) building blocks shared by the wgmma/TMA attention loops:
// the forward of flash_fwd_sm90.cuh (K1, K9, K12) and the backward of
// flash_bwd_sm90.cuh (K3, K4, K10, K11, K13, K14). mbarriers, TMA loads
// and stores, the warpgroup's named barriers and wgmma fences, shared-memory matrix
// descriptors and the 128-byte swizzle TMA writes, the wgmma products
// (m64n128k16 and m64n64k16 with both operands in shared memory,
// m64n128k16 and m64n64k16 with A in registers), and on the host the 4-D tensor maps,
// built through cudaGetDriverEntryPoint so that no library links against
// libcuda.
#pragma once

#include <cuda.h>
#include <math.h>

#include "flash_common.cuh"

namespace fa {
namespace sm90 {

constexpr int BOX_COLS = 64; // one 128-byte swizzle row of bf16

// A head row of D bf16 values: D / 64 swizzle boxes side by side (one at
// D = 64, two at D = 128); rope pairs column c with c + D / 2.
template <int D>
struct Row {
  static_assert(D == 64 || D == 128, "the loops are built for head_dim 64 and 128");
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr int HALF = D / 2;
};
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------------ PTX pieces
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of `map` at coordinates (c0, c1, c2, c3) into dst; its
// bytes complete on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// TMA stores from shared memory: one box of `map` at (c0, c1, c2, c3)
// from src (rows outside the tensor are not written), the commit of this
// thread's stores into a group, and the wait until every group has read
// its source.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Named barrier over the 128 threads of consumer c (id 0 is
// __syncthreads').
__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
}

// Make this thread's shared-memory writes visible to wgmma (the async
// proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator
// registers across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define FA_ACC8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_ACC64                                                                      \
  FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24), FA_ACC8(32), FA_ACC8(40),         \
      FA_ACC8(48), FA_ACC8(56)
#define FA_REGS64                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared
// memory. `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (four bf16
// pairs a thread), B MN-major in shared memory (transpose flag set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define FA_ACC32 FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)
#define FA_REGS32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] += A[64 x 16] . B[16 x 64]: wgmma_rs at half the width, the
// output products of the D = 64 loops (B one 64-column box).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared
// memory: wgmma_ss at half the width, for the backward's score tiles.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC32
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef FA_ACC8
#undef FA_ACC32
#undef FA_ACC64
#undef FA_REGS32
#undef FA_REGS64

// Byte offset of the 16-byte chunk `ch` (0..7) of row r in a 128-byte
// swizzled box (1024-byte aligned): the pattern TMA writes.
__device__ __forceinline__ int swz(int r, int ch) { return r * 128 + ((ch ^ (r & 7)) << 4); }

// ------------------------------------------------------------ host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, found through the runtime (no
// -lcuda), or nullptr.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map (D, S, heads, B) over a bf16 operand with element strides
// (sb, sh, ss): boxes of 64 columns x `rows` positions x `heads_per_box`
// heads, 128-byte swizzle, zeros out of bounds. False on failure.
template <int D>
inline bool tile_map(CUtensorMap* map, const void* ptr, int B, int heads, int S, long long sb,
                     long long sh, long long ss, int rows, int heads_per_box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX_COLS, (cuuint32_t)rows, (cuuint32_t)heads_per_box,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace fa

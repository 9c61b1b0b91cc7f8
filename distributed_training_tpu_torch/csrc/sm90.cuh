// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu): 128-byte-swizzled bf16 tiles in
// shared memory, filled by cp.async with zero fill past the end of a
// matrix; wgmma matrix descriptors for them; bf16 wgmma products with f32
// accumulators in registers (both operands from shared memory, or A from
// registers); and the fences between them.
//
// Tile layout. A tile of R rows and D bf16 columns is stored as D / 64
// column blocks of R rows x 128 bytes; in each group of 8 rows (1024 bytes)
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8), the pattern of
// TMA's CU_TENSOR_MAP_SWIZZLE_128B and wgmma's 128B-swizzle layout. Tiles
// start on 1024-byte boundaries, so the swizzle's base offset is 0. The
// same storage serves wgmma in both orientations: K-major when the tile's
// columns are the product's reduction dimension (Q and K in S = Q K^T),
// MN-major when its rows are (V in O += P V).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dtt {
namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) in a swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// 16 (or 4) bytes global -> shared, asynchronously; src_valid false
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool src_valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool src_valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's shared-memory writes (st.shared, cp.async) before
// later reads by wgmma, which reads shared memory through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

// Rows [r0, r0 + ROWS) of a row-major (nrows, D) bf16 matrix into a
// swizzled tile; rows at or past nrows become zeros. Every thread of the
// block takes a share of the 16-byte chunks, neighbours on neighbouring
// chunks of a row.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int r0,
                                          int nrows) {
  constexpr int kRowChunks = D / 8;
  static_assert(ROWS * kRowChunks % THREADS == 0, "tile chunks must split evenly");
#pragma unroll
  for (int n = 0; n < ROWS * kRowChunks / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int r = i / kRowChunks;
    const int c = (i % kRowChunks) * 8;
    const bool valid = r0 + r < nrows;
    cp_async16(dst + swz(ROWS, r, c), src + (size_t)(valid ? r0 + r : 0) * D + c, valid);
  }
}

// wgmma matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (1ull << 62);
}

// K-major operand: the tile's columns are the reduction dimension; k-step
// kk takes columns [16 kk, 16 kk + 16), 32 bytes into a 128-byte row
// (the hardware applies the swizzle to the advanced address). 8-row
// groups are 1024 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  return make_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: the tile's rows are the reduction dimension; k-step
// kk takes rows [16 kk, 16 kk + 16). 8-row groups are 1024 bytes apart;
// 64-column blocks are rows * 128 bytes apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return make_desc(tile + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the
// wgmma_wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Accumulator layout of an m64nN f32 product over the warpgroup's 128
// threads (warp w, lane l): d[4 i + j] holds row 16 w + l / 4 + 8 (j / 2),
// column 8 i + 2 (l % 4) + j % 2. A fragment of A (m64 x k16, bf16) in
// registers holds the same rows and columns 16 kk .. 16 kk + 15 as
// a[j] = (d[8 kk + 2 j], d[8 kk + 2 j + 1]) of an accumulator: a product's
// output feeds the next product's A without moving.

#define DTT_F8(i)                                                                      \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define DTT_R32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define DTT_R64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "     \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D (m64 x N, f32) += A (m64 x k16) B (k16 x N), bf16 operands. ss: A and B
// by descriptor; rs: A from registers (K-major by definition). TA / TB: 1 =
// the operand is MN-major (transposed), 0 = K-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DTT_R32
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : DTT_F8(0), DTT_F8(8), DTT_F8(16), DTT_F8(24)
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DTT_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : DTT_F8(0), DTT_F8(8), DTT_F8(16), DTT_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DTT_R64
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : DTT_F8(0), DTT_F8(8), DTT_F8(16), DTT_F8(24), DTT_F8(32), DTT_F8(40), DTT_F8(48),
          DTT_F8(56)
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DTT_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : DTT_F8(0), DTT_F8(8), DTT_F8(16), DTT_F8(24), DTT_F8(32), DTT_F8(40), DTT_F8(48),
          DTT_F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

#undef DTT_F8
#undef DTT_R32
#undef DTT_R64

// The accumulator's values as A fragments: BF16 pairs, k-step by k-step.
template <int KSTEPS>
__device__ __forceinline__ void to_a_frags(const float (&d)[KSTEPS * 8],
                                           uint32_t (&a)[KSTEPS][4]) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
}

}  // namespace sm90
}  // namespace dtt

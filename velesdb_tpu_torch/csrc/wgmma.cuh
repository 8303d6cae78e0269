// wgmma.cuh — the Hopper tensor-core building blocks shared by the wgmma
// kernels (dense_bucket_tc.cu: #2b and #3; fused_topk.cu: #8).
//
// - wgmma.mma_async m64nNk16 (N = 8 .. 128) on bf16 or f16 operands, both
//   K-major in shared memory, fp32 accumulators in registers;
// - the shared-memory matrix descriptor of the 128-byte-swizzled K-major
//   layout (8-row groups 1024 bytes apart) and the swizzle itself;
// - 16-byte cp.async with zero fill, its groups, and the proxy fence that
//   makes generic shared-memory writes visible to wgmma.
//
// The kernel libraries are built one source at a time; _cuda.py hashes this
// header into the name of every library whose source includes it.

#pragma once

#include <cstdint>

namespace {

// -- wgmma m64nNk16, f32 accumulators, A and B K-major in shared memory -------

#define VDB_WGMMA_N8(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n8k16.f32." TY "." TY " "    \
               "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"               \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])              \
               : "l"(da), "l"(db), "r"(scale_d))

#define VDB_WGMMA_N16(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "   \
               "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n" \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
                 "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])              \
               : "l"(da), "l"(db), "r"(scale_d))

#define VDB_WGMMA_N32(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "   \
               "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
               "%8, %9, %10, %11, %12, %13, %14, %15}, "                     \
               "%16, %17, p, 1, 1, 0, 0;\n}\n"                               \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
                 "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])          \
               : "l"(da), "l"(db), "r"(scale_d))

#define VDB_WGMMA_N64(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "   \
               "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
               "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
               "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
               "%24, %25, %26, %27, %28, %29, %30, %31}, "                   \
               "%32, %33, p, 1, 1, 0, 0;\n}\n"                               \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
                 "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
                 "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
                 "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])          \
               : "l"(da), "l"(db), "r"(scale_d))

#define VDB_WGMMA_N128(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
               "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
               "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
               "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
               "%24, %25, %26, %27, %28, %29, %30, %31, "                    \
               "%32, %33, %34, %35, %36, %37, %38, %39, "                    \
               "%40, %41, %42, %43, %44, %45, %46, %47, "                    \
               "%48, %49, %50, %51, %52, %53, %54, %55, "                    \
               "%56, %57, %58, %59, %60, %61, %62, %63}, "                   \
               "%64, %65, p, 1, 1, 0, 0;\n}\n"                               \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
                 "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
                 "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
                 "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
                 "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),         \
                 "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
                 "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
                 "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])          \
               : "l"(da), "l"(db), "r"(scale_d))

template <int NQ, bool kBf16>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NQ == 8) {
    if constexpr (kBf16) VDB_WGMMA_N8("bf16"); else VDB_WGMMA_N8("f16");
  } else if constexpr (NQ == 16) {
    if constexpr (kBf16) VDB_WGMMA_N16("bf16"); else VDB_WGMMA_N16("f16");
  } else if constexpr (NQ == 32) {
    if constexpr (kBf16) VDB_WGMMA_N32("bf16"); else VDB_WGMMA_N32("f16");
  } else if constexpr (NQ == 64) {
    if constexpr (kBf16) VDB_WGMMA_N64("bf16"); else VDB_WGMMA_N64("f16");
  } else {
    static_assert(NQ == 128, "query tile of 8, 16, 32, 64 or 128");
    if constexpr (kBf16) VDB_WGMMA_N128("bf16"); else VDB_WGMMA_N128("f16");
  }
}

// Keeps the compiler from moving accumulator reads across wgmma.wait_group.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (every operand region starts 1024-byte aligned).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of 16-byte chunk ``c`` (0..7) of row ``r`` in a 128-byte-swizzled
// region: the chunk index XOR the row's place in its 8-row group.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace

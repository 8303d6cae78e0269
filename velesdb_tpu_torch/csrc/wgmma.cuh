// wgmma.cuh — the Hopper tensor-core building blocks shared by the wgmma
// kernels (dense_bucket_tc.cu: #2b, #3, #2 on f32 rows and #6; fused_topk.cu:
// #8).
//
// - wgmma.mma_async m64nNk16 (N = 8 .. 128) on bf16 or f16 operands, both
//   K-major in shared memory, fp32 accumulators in registers;
// - the shared-memory matrix descriptor of the 128-byte-swizzled K-major
//   layout (8-row groups 1024 bytes apart) and the swizzle itself;
// - 16-byte cp.async with zero fill, its groups, and the proxy fence that
//   makes generic shared-memory writes visible to wgmma;
// - register staging, for rows that need a conversion before the tensor
//   cores read them (f32 rows split into bf16 (hi, lo) pairs, SQ8 words
//   unpacked to bf16 codes): a 128-row tile of one 64-dim K block comes from
//   device memory into registers as 16-byte vectors (stage_load), and is
//   converted into the swizzled bf16 layout (store_split_f32, store_codes,
//   split_bf16) while the tensor cores run the block before.
//
// The kernel libraries are built one source at a time; _cuda.py hashes this
// header into the name of every library whose source includes it.

#pragma once

#include <cuda_bf16.h>
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

// -- register staging -----------------------------------------------------------

// Vector j of this thread's share of one tile: x = tid + j * kThreads covers
// bytes col0 + 16 (x % kGroups) .. + 15 of tile row x / kGroups, the row
// starting at ``base + row * stride``. Zero past ``rows`` rows and past
// ``row_bytes`` bytes of a row. A vector that its row ends inside, or any
// vector when ``vec`` is false (a row stride that is not a multiple of 16
// bytes), is read as 4-byte words: every staged row holds whole 4-byte values.
template <int kGroups, int kLoads, int kThreads>
__device__ __forceinline__ void stage_load(uint4 (&pre)[kLoads], const unsigned char* base,
                                           long long stride, int rows, int col0, int row_bytes,
                                           bool vec, int tid) {
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int x = tid + j * kThreads;
    const int r = x / kGroups;
    const int c = col0 + (x % kGroups) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && c < row_bytes) {
      const unsigned char* p = base + r * stride + c;
      if (vec && c + 16 <= row_bytes) {
        v = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
        v.x = __ldg(w);
        if (c + 4 < row_bytes) v.y = __ldg(w + 1);
        if (c + 8 < row_bytes) v.z = __ldg(w + 2);
        if (c + 12 < row_bytes) v.w = __ldg(w + 3);
      }
    }
    pre[j] = v;
  }
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x));
}

// hi = bf16(x), lo = bf16(x - hi) of kVals f32 values, packed two a word in
// order (the first value in the low half).
template <int kVals>
__device__ __forceinline__ void split_bf16(const float* f, uint32_t* hw, uint32_t* lw) {
#pragma unroll
  for (int v = 0; v < kVals / 2; ++v) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(f[2 * v]);
    const __nv_bfloat16 h1 = __float2bfloat16_rn(f[2 * v + 1]);
    const __nv_bfloat16 l0 = __float2bfloat16_rn(f[2 * v] - __bfloat162float(h0));
    const __nv_bfloat16 l1 = __float2bfloat16_rn(f[2 * v + 1] - __bfloat162float(h1));
    hw[v] = bf16_bits(h0) | (bf16_bits(h1) << 16);
    lw[v] = bf16_bits(l0) | (bf16_bits(l1) << 16);
  }
}

// Vector g of row r of a 64-dim K block of f32 values (dims 4g .. 4g + 3)
// split into (hi, lo) and stored into the swizzled hi and lo tiles: half a
// 16-byte chunk of each.
__device__ __forceinline__ void store_split_f32(unsigned char* hi, unsigned char* lo, int r, int g,
                                                const uint4& v) {
  const float f[4] = {__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                      __uint_as_float(v.w)};
  uint32_t hw[2], lw[2];
  split_bf16<4>(f, hw, lw);
  const uint32_t o = swz(r, g / 2) + (g % 2) * 8;
  *reinterpret_cast<uint2*>(hi + o) = make_uint2(hw[0], hw[1]);
  *reinterpret_cast<uint2*>(lo + o) = make_uint2(lw[0], lw[1]);
}

// Vector g of row r of a K block of SQ8 words (word i of the vector, byte j:
// K position 16g + 4i + j) unpacked into 16 bf16 codes, two swizzled 16-byte
// chunks. Each code 0..255 is exact: 2^23 + code is exact in fp32, so is the
// difference, and 8 significant bits fit bf16's significand.
__device__ __forceinline__ void store_codes(unsigned char* tile, int r, int g, const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // byte j of the word under the exponent byte 0x4B: the float 2^23 + code
      c[j] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440u | j)) - 8388608.0f;
    }
    out[2 * i] = bf16_bits(__float2bfloat16_rn(c[0])) | (bf16_bits(__float2bfloat16_rn(c[1])) << 16);
    out[2 * i + 1] =
        bf16_bits(__float2bfloat16_rn(c[2])) | (bf16_bits(__float2bfloat16_rn(c[3])) << 16);
  }
  *reinterpret_cast<uint4*>(tile + swz(r, 2 * g)) = make_uint4(out[0], out[1], out[2], out[3]);
  *reinterpret_cast<uint4*>(tile + swz(r, 2 * g + 1)) = make_uint4(out[4], out[5], out[6], out[7]);
}

}  // namespace

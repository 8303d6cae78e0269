// wgmma.cuh — the Hopper tensor-core building blocks shared by the wgmma
// kernels (dense_bucket_tc.cu: #2b, #3, #2 on f32 rows and #6; fused_topk.cu:
// #8; sq8i_bucket.cu: #7, #12 and #5; hamming_bucket.cu: #4).
//
// - wgmma.mma_async m64nNk16 (N = 8 .. 128) on bf16 or f16 operands and
//   m64nNk32 on s8 operands, both K-major in shared memory, fp32 or s32
//   accumulators in registers, and m64nNk32 on s8 with A in registers; the
//   byte packing of the bucket select;
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

// -- wgmma m64nNk16 (bf16, f16) and m64nNk32 (s8), A and B K-major in shared
// memory, accumulators in registers ------------------------------------------
//
// One macro per width N: INSTR is the instruction with its shape and types, C
// the accumulators' constraint ("+f" for f32, "+r" for s32), TAIL the operands
// after scale-d. The float forms take imm-scale-a/b and the two transposes
// ("p, 1, 1, 0, 0"); the integer form takes none ("p"), and its 8-bit operands
// must both be K-major.

#define VDB_WGMMA_N8(INSTR, C, TAIL)                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n" INSTR " "         \
               "{%0, %1, %2, %3}, %4, %5, " TAIL ";\n}\n"                    \
               : C(d[0]), C(d[1]), C(d[2]), C(d[3])                          \
               : "l"(da), "l"(db), "r"(scale_d))

#define VDB_WGMMA_N16(INSTR, C, TAIL)                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n" INSTR " "        \
               "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, " TAIL ";\n}\n"    \
               : C(d[0]), C(d[1]), C(d[2]), C(d[3]),                         \
                 C(d[4]), C(d[5]), C(d[6]), C(d[7])                          \
               : "l"(da), "l"(db), "r"(scale_d))

#define VDB_WGMMA_N32(INSTR, C, TAIL)                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" INSTR " "        \
               "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
               "%8, %9, %10, %11, %12, %13, %14, %15}, "                     \
               "%16, %17, " TAIL ";\n}\n"                                    \
               : C(d[0]), C(d[1]), C(d[2]), C(d[3]),                         \
                 C(d[4]), C(d[5]), C(d[6]), C(d[7]),                         \
                 C(d[8]), C(d[9]), C(d[10]), C(d[11]),                       \
                 C(d[12]), C(d[13]), C(d[14]), C(d[15])                      \
               : "l"(da), "l"(db), "r"(scale_d))

#define VDB_WGMMA_N64(INSTR, C, TAIL)                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" INSTR " "        \
               "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
               "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
               "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
               "%24, %25, %26, %27, %28, %29, %30, %31}, "                   \
               "%32, %33, " TAIL ";\n}\n"                                    \
               : C(d[0]), C(d[1]), C(d[2]), C(d[3]),                         \
                 C(d[4]), C(d[5]), C(d[6]), C(d[7]),                         \
                 C(d[8]), C(d[9]), C(d[10]), C(d[11]),                       \
                 C(d[12]), C(d[13]), C(d[14]), C(d[15]),                     \
                 C(d[16]), C(d[17]), C(d[18]), C(d[19]),                     \
                 C(d[20]), C(d[21]), C(d[22]), C(d[23]),                     \
                 C(d[24]), C(d[25]), C(d[26]), C(d[27]),                     \
                 C(d[28]), C(d[29]), C(d[30]), C(d[31])                      \
               : "l"(da), "l"(db), "r"(scale_d))

#define VDB_WGMMA_N128(INSTR, C, TAIL)                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" INSTR " "        \
               "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
               "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
               "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
               "%24, %25, %26, %27, %28, %29, %30, %31, "                    \
               "%32, %33, %34, %35, %36, %37, %38, %39, "                    \
               "%40, %41, %42, %43, %44, %45, %46, %47, "                    \
               "%48, %49, %50, %51, %52, %53, %54, %55, "                    \
               "%56, %57, %58, %59, %60, %61, %62, %63}, "                   \
               "%64, %65, " TAIL ";\n}\n"                                    \
               : C(d[0]), C(d[1]), C(d[2]), C(d[3]),                         \
                 C(d[4]), C(d[5]), C(d[6]), C(d[7]),                         \
                 C(d[8]), C(d[9]), C(d[10]), C(d[11]),                       \
                 C(d[12]), C(d[13]), C(d[14]), C(d[15]),                     \
                 C(d[16]), C(d[17]), C(d[18]), C(d[19]),                     \
                 C(d[20]), C(d[21]), C(d[22]), C(d[23]),                     \
                 C(d[24]), C(d[25]), C(d[26]), C(d[27]),                     \
                 C(d[28]), C(d[29]), C(d[30]), C(d[31]),                     \
                 C(d[32]), C(d[33]), C(d[34]), C(d[35]),                     \
                 C(d[36]), C(d[37]), C(d[38]), C(d[39]),                     \
                 C(d[40]), C(d[41]), C(d[42]), C(d[43]),                     \
                 C(d[44]), C(d[45]), C(d[46]), C(d[47]),                     \
                 C(d[48]), C(d[49]), C(d[50]), C(d[51]),                     \
                 C(d[52]), C(d[53]), C(d[54]), C(d[55]),                     \
                 C(d[56]), C(d[57]), C(d[58]), C(d[59]),                     \
                 C(d[60]), C(d[61]), C(d[62]), C(d[63])                      \
               : "l"(da), "l"(db), "r"(scale_d))

// The float forms' instruction: m64nNk16, f32 accumulators, TY operands.
#define VDB_HALF(N, TY) "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY
#define VDB_HALF_TAIL "p, 1, 1, 0, 0"

// d += A . B^T over one K step of 16 (scale_d = 0: d = A . B^T), bf16 or f16.
template <int NQ, bool kBf16>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NQ == 8) {
    if constexpr (kBf16) VDB_WGMMA_N8(VDB_HALF(8, "bf16"), "+f", VDB_HALF_TAIL);
    else VDB_WGMMA_N8(VDB_HALF(8, "f16"), "+f", VDB_HALF_TAIL);
  } else if constexpr (NQ == 16) {
    if constexpr (kBf16) VDB_WGMMA_N16(VDB_HALF(16, "bf16"), "+f", VDB_HALF_TAIL);
    else VDB_WGMMA_N16(VDB_HALF(16, "f16"), "+f", VDB_HALF_TAIL);
  } else if constexpr (NQ == 32) {
    if constexpr (kBf16) VDB_WGMMA_N32(VDB_HALF(32, "bf16"), "+f", VDB_HALF_TAIL);
    else VDB_WGMMA_N32(VDB_HALF(32, "f16"), "+f", VDB_HALF_TAIL);
  } else if constexpr (NQ == 64) {
    if constexpr (kBf16) VDB_WGMMA_N64(VDB_HALF(64, "bf16"), "+f", VDB_HALF_TAIL);
    else VDB_WGMMA_N64(VDB_HALF(64, "f16"), "+f", VDB_HALF_TAIL);
  } else {
    static_assert(NQ == 128, "query tile of 8, 16, 32, 64 or 128");
    if constexpr (kBf16) VDB_WGMMA_N128(VDB_HALF(128, "bf16"), "+f", VDB_HALF_TAIL);
    else VDB_WGMMA_N128(VDB_HALF(128, "f16"), "+f", VDB_HALF_TAIL);
  }
}

// The integer form: m64nNk32, s32 accumulators, s8 operands. Every product
// and sum is exact (no saturation is asked for; the callers keep the sums
// inside int32).
#define VDB_S8(N) "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8"

// d += A . B^T over one K step of 32 int8 (scale_d = 0: d = A . B^T).
template <int NQ>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NQ == 8) {
    VDB_WGMMA_N8(VDB_S8(8), "+r", "p");
  } else if constexpr (NQ == 16) {
    VDB_WGMMA_N16(VDB_S8(16), "+r", "p");
  } else if constexpr (NQ == 32) {
    VDB_WGMMA_N32(VDB_S8(32), "+r", "p");
  } else if constexpr (NQ == 64) {
    VDB_WGMMA_N64(VDB_S8(64), "+r", "p");
  } else {
    static_assert(NQ == 128, "query tile of 8, 16, 32, 64 or 128");
    VDB_WGMMA_N128(VDB_S8(128), "+r", "p");
  }
}

// The integer form with A in registers (hamming_bucket.cu): four b32 a
// thread, each four int8 of the A tile, laid out as mma.m16n8k32's A
// fragment a warp (warp w: rows 16 w .. 16 w + 15; lane l: a[0] row l / 4,
// K 4 (l % 4) .. + 3; a[1] row l / 4 + 8; a[2] and a[3] the same rows at K
// 16 + 4 (l % 4) .. + 3). The registers are read asynchronously: they keep
// their values until the group's wgmma.wait_group.
#define VDB_WGMMA_RS_N8(INSTR)                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n" INSTR " "         \
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"             \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define VDB_WGMMA_RS_N16(INSTR)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" INSTR " "        \
               "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n" \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),             \
                 "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define VDB_WGMMA_RS_N32(INSTR)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" INSTR " "        \
               "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
               "%8, %9, %10, %11, %12, %13, %14, %15}, "                     \
               "{%16, %17, %18, %19}, %20, p;\n}\n"                          \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),             \
                 "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),             \
                 "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),           \
                 "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])          \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define VDB_WGMMA_RS_N64(INSTR)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" INSTR " "        \
               "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
               "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
               "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
               "%24, %25, %26, %27, %28, %29, %30, %31}, "                   \
               "{%32, %33, %34, %35}, %36, p;\n}\n"                          \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),             \
                 "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),             \
                 "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),           \
                 "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),         \
                 "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),         \
                 "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),         \
                 "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),         \
                 "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])          \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// d += A . B^T over one K step of 32 int8, A from the registers ``a``.
template <int NQ>
__device__ __forceinline__ void wgmma_s8_rs(int* d, const uint32_t* a, uint64_t db,
                                            int scale_d) {
  if constexpr (NQ == 8) {
    VDB_WGMMA_RS_N8(VDB_S8(8));
  } else if constexpr (NQ == 16) {
    VDB_WGMMA_RS_N16(VDB_S8(16));
  } else if constexpr (NQ == 32) {
    VDB_WGMMA_RS_N32(VDB_S8(32));
  } else {
    static_assert(NQ == 64, "query tile of 8, 16, 32 or 64");
    VDB_WGMMA_RS_N64(VDB_S8(64));
  }
}

// Keeps the compiler from moving accumulator reads across wgmma.wait_group.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The bucket scans' running (max, slice) select keeps each accumulator's
// slice index in one byte. Byte-selector that puts the low byte of the second
// __byte_perm operand at byte ``p`` of the first: the slice index of
// accumulator ``4i + p`` lives in byte ``p`` of word ``i``.
__device__ __forceinline__ unsigned put_byte_sel(int p) {
  return p == 0 ? 0x3214u : p == 1 ? 0x3240u : p == 2 ? 0x3410u : 0x4210u;
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

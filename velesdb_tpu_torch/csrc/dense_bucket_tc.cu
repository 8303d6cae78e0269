// dense_bucket_tc.cu — half-precision bucket scan on Hopper's tensor cores.
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_kernel (the Pallas kernel
// launched by _bucket_call from bucket_topk_entry) for f16 and bf16 rows: the
// ``bucket-f32`` serve core of F16/BF16 storage below D 512. f32 rows keep
// dense_bucket.cu. The contract is dense_bucket.cu's:
//
//   inputs   q     T     [B_pad, D_pad]  queries in the row type T (f16/bf16;
//                                        cosine: normalized; euclidean: 2q)
//            rows  T     [N, D_pad]      corpus rows
//            cc    f32   [N]             |c|^2 (euclidean) or 0, +inf on
//                                        knocked-out rows
//   output   gm  f32   [B_pad, (N / chunk) * 128]
//            gi  int32 [B_pad, (N / chunk) * 128]
//   s[b, r]  = sum over d of float(q[b, d]) * float(rows[r, d]), minus cc[r]
//   gm[b, c*128 + j] = max over slices i of s[b, c*chunk + i*128 + j], gi its
//   row; ties go to the smallest slice, so a bucket of -inf scores returns
//   its slice-0 row.
//
// It is held to dense_bucket_ref (the fixed-order fp32 sum) within a stated
// tolerance, not bit for bit: the products of two half values are exact in
// fp32, and wgmma adds them in its own order (bucket_kernel.py,
// half_scan_tolerance).
//
// What bounds it on this card. 2 * B_pad * N * D_pad operations at 989 TFLOP/s
// (dense f16/bf16) against N * D_pad * 2 bytes of rows at 3.35 TB/s: the row
// read bounds it below ~295 queries a pass (0.080 ms at N 1,048,576, D_pad
// 128), so the design keeps the rows streaming and does the products where
// they cost nothing, on the tensor cores.
//
// What the design does about that:
// - one block per (corpus chunk, query tile of NQ = 8 .. 128 queries), the
//   query tiles of a chunk numbered together so the chunk comes from device
//   memory once and from L2 after; 256 threads, two warpgroups;
// - the query tile sits in shared memory for the whole chunk, the B operand
//   of every wgmma (K-major, N = NQ: b 16 wastes nothing);
// - the chunk's rows stream through a ring of S stages, each one 128-row
//   slice by 64 dims (16 KB), copied with 16-byte cp.async into the
//   128-byte-swizzled layout wgmma reads; dims past D_pad are zero-filled up
//   to the K step;
// - warpgroup w multiplies rows 64w .. 64w + 63 of the slice (the A operand,
//   M = 64) by the query tile with wgmma.m64nNk16, fp32 accumulators;
// - the epilogue stays in registers: it subtracts cc and keeps a running
//   (max, slice) per (row lane, query), the slice packed one byte each, and
//   writes gm/gi once per chunk, so the [B, N] score tile never exists.
//
// What it leaves on the table: every thread issues its own copies, and each
// step waits for its wgmma group (wait_group 0) before the epilogue, so the
// tensor cores and the epilogue never overlap; at B_pad 256 the kernel runs
// at about a third of its bound. TMA tiles (the tensor map taken through
// cudaGetDriverEntryPoint, so no new link) into an mbarrier ring, with one
// wgmma group kept in flight across the epilogue, is its next step
// (ROADMAP.md, kernels to redesign).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;        // two warpgroups
constexpr int kLanes = 128;          // bucket lanes = rows of a slice
constexpr int kKBlock = 64;          // dims of a stage: one 128-byte swizzle row
constexpr int kStageBytes = kLanes * 128;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;

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

// Byte-selector that puts the low byte of the second __byte_perm operand at
// byte ``p`` of the first: the slice index of accumulator ``4i + p`` lives in
// byte ``p`` of word ``i``.
__device__ __forceinline__ unsigned put_byte_sel(int p) {
  return p == 0 ? 0x3214u : p == 1 ? 0x3240u : p == 2 ? 0x3410u : 0x4210u;
}

template <typename T, int NQ, int S>
__global__ void __launch_bounds__(kThreads, 1)
dense_tc_kernel(const T* __restrict__ q, const T* __restrict__ rows,
                const float* __restrict__ cc, float* __restrict__ gm, int32_t* __restrict__ gi,
                int b_pad, int d_pad, int chunk, int n_qtiles, long long n_buckets) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int R = NQ / 2;   // accumulators per thread: two rows x NQ/4 queries
  constexpr int W = NQ / 8;   // packed slice-index words per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // every operand region starts 1024-byte aligned in the shared window (the
  // swizzle's repeat), so the launch asks for 1 KB more than it uses
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024u - (raw_addr & 1023u)) & 1023u);
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  unsigned char* s_q = smem;                              // kb_count x [NQ][128 B]
  unsigned char* s_rows = smem + kb_count * NQ * 128;     // S x [128][128 B]
  const uint32_t q_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_q));
  const uint32_t rows_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_rows));

  const int tid = threadIdx.x;
  const int wg = tid / 128;                 // rows 64 wg .. 64 wg + 63 of each slice
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int tile = blockIdx.x % n_qtiles;
  const long long c = blockIdx.x / n_qtiles;
  const int q0 = tile * NQ;
  const int slices = chunk / kLanes;
  const int steps = slices * kb_count;
  const long long row0 = c * chunk;

  // The query tile, zero past B_pad and D_pad, swizzled as wgmma's B.
  for (int x = tid; x < kb_count * NQ * 8; x += kThreads) {
    const int kb = x / (NQ * 8);
    const int r = (x / 8) % NQ;
    const int ch = x % 8;
    const int col = kb * kKBlock + ch * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < b_pad && col < d_pad) {
      v = *reinterpret_cast<const uint4*>(q + static_cast<long long>(q0 + r) * d_pad + col);
    }
    *reinterpret_cast<uint4*>(s_q + kb * NQ * 128 + swz(r, ch)) = v;
  }

  // Step t loads dims kb*64 .. kb*64+63 of slice s = t / kb_count into stage
  // t % S: 1024 chunks of 16 bytes, four a thread, a warp on four whole rows.
  auto load_step = [&](int t) {
    const int s = t / kb_count;
    const int kb = t - s * kb_count;
    const uint32_t dst = rows_addr + static_cast<uint32_t>((t % S) * kStageBytes);
    const T* base = rows + (row0 + static_cast<long long>(s) * kLanes) * d_pad + kb * kKBlock;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = tid + j * kThreads;
      const int r = x / 8;
      const int ch = x % 8;
      const bool ok = kb * kKBlock + ch * 8 < d_pad;
      cp_async16(dst + swz(r, ch), ok ? static_cast<const void*>(base + r * d_pad + ch * 8)
                                      : static_cast<const void*>(rows),
                 ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < steps) load_step(t);
    cp_async_commit();
  }

  float acc[R];
  float mx[R];
  unsigned mi[W];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    acc[i] = 0.0f;
    mx[i] = -__int_as_float(0x7f800000);  // -inf
  }
#pragma unroll
  for (int i = 0; i < W; ++i) mi[i] = 0u;

  // this thread's two rows of each slice (accumulator rows lr and lr + 8)
  const int lr = 64 * wg + 16 * warp + lane / 4;
  float cc_lo = __ldg(cc + row0 + lr);
  float cc_hi = __ldg(cc + row0 + lr + 8);

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<S - 2>();
    fence_async_smem();
    __syncthreads();  // stage t landed for every thread; stage t-1 is free
    if (t + S - 1 < steps) load_step(t + S - 1);
    cp_async_commit();

    const int s = t / kb_count;
    const int kb = t - s * kb_count;
    const int k16 = (min(kKBlock, d_pad - kb * kKBlock) + 15) / 16;  // K steps, zero-padded
    const uint32_t a0 = rows_addr + static_cast<uint32_t>((t % S) * kStageBytes + wg * 64 * 128);
    const uint32_t b0 = q_addr + static_cast<uint32_t>(kb * NQ * 128);
    fence_regs<R>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kKBlock / 16; ++k) {
      if (k < k16) {
        wgmma<NQ, kBf16>(acc, smem_desc(a0 + 32 * k), smem_desc(b0 + 32 * k),
                         (kb > 0 || k > 0) ? 1 : 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs<R>(acc);

    if (kb == kb_count - 1) {
      // acc[4i + 2h + e]: row lr + 8h, query 8i + 2 (lane % 4) + e
      const unsigned sb = static_cast<unsigned>(s);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float v = __fsub_rn(acc[i], (i & 2) ? cc_hi : cc_lo);
        if (v > mx[i]) {
          mx[i] = v;
          mi[i / 4] = __byte_perm(mi[i / 4], sb, put_byte_sel(i % 4));
        }
      }
      if (s + 1 < slices) {
        const long long nxt = row0 + static_cast<long long>(s + 1) * kLanes + lr;
        cc_lo = __ldg(cc + nxt);
        cc_hi = __ldg(cc + nxt + 8);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
    const int lane_row = lr + ((i & 2) ? 8 : 0);
    if (q0 + col < b_pad) {
      const long long o = static_cast<long long>(q0 + col) * n_buckets + c * kLanes + lane_row;
      const int slice = static_cast<int>((mi[i / 4] >> (8 * (i % 4))) & 0xFFu);
      gm[o] = mx[i];
      gi[o] = static_cast<int32_t>(row0 + slice * kLanes + lane_row);
    }
  }
}

template <typename T, int NQ, int S>
cudaError_t launch(const void* q, const void* rows, const float* cc, float* gm, int32_t* gi,
                   int b_pad, long long n, int d_pad, int chunk, cudaStream_t stream) {
  const int n_qtiles = (b_pad + NQ - 1) / NQ;
  const long long n_chunks = n / chunk;
  const long long blocks = n_chunks * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  const size_t smem = 1024 + static_cast<size_t>(kb_count) * NQ * 128 +
                      static_cast<size_t>(S) * kStageBytes;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  // The shared-memory limit is raised once per device (and again only for a
  // larger tile), not on every launch: cudaFuncSetAttribute is a driver call
  // that every search would otherwise pay.
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return cudaErrorInvalidDevice;
  }
  if (smem > allowed[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(dense_tc_kernel<T, NQ, S>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    allowed[dev] = smem;
  }
  dense_tc_kernel<T, NQ, S><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(rows), cc, gm, gi, b_pad, d_pad, chunk,
      n_qtiles, n_chunks * kLanes);
  return cudaGetLastError();
}

// The query tile: the smallest of 8 .. 128 that holds the batch, then the
// largest whose tile and two stages fit the shared memory; the ring takes
// as many 16 KB stages as then fit, up to 8.
template <typename T, int NQ>
cudaError_t launch_stages(const void* q, const void* rows, const float* cc, float* gm,
                          int32_t* gi, int b_pad, long long n, int d_pad, int chunk,
                          cudaStream_t stream) {
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  const long long free_bytes = kSmemLimit - 1024 - static_cast<long long>(kb_count) * NQ * 128;
  const long long s = free_bytes / kStageBytes;
  if (s >= 8) return launch<T, NQ, 8>(q, rows, cc, gm, gi, b_pad, n, d_pad, chunk, stream);
  if (s >= 4) return launch<T, NQ, 4>(q, rows, cc, gm, gi, b_pad, n, d_pad, chunk, stream);
  return launch<T, NQ, 2>(q, rows, cc, gm, gi, b_pad, n, d_pad, chunk, stream);
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* rows, const float* cc, float* gm,
                         int32_t* gi, int b_pad, long long n, int d_pad, int chunk,
                         cudaStream_t stream) {
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  const long long room = (kSmemLimit - 1024 - 2LL * kStageBytes) / (kb_count * 128LL);
  int nq = b_pad <= 8 ? 8 : b_pad <= 16 ? 16 : b_pad <= 32 ? 32 : b_pad <= 64 ? 64 : 128;
  while (nq > 8 && nq > room) nq /= 2;
  switch (nq) {
    case 8: return launch_stages<T, 8>(q, rows, cc, gm, gi, b_pad, n, d_pad, chunk, stream);
    case 16: return launch_stages<T, 16>(q, rows, cc, gm, gi, b_pad, n, d_pad, chunk, stream);
    case 32: return launch_stages<T, 32>(q, rows, cc, gm, gi, b_pad, n, d_pad, chunk, stream);
    case 64: return launch_stages<T, 64>(q, rows, cc, gm, gi, b_pad, n, d_pad, chunk, stream);
    default: return launch_stages<T, 128>(q, rows, cc, gm, gi, b_pad, n, d_pad, chunk, stream);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. ``dtype``: 1 f16, 2 bf16 (the codes
// of bucket_kernel.py's _FLOAT_CODES). Launches on ``stream`` without synchronizing and
// returns the launch's CUDA error code.
extern "C" int dense_bucket_tc_launch(const void* q, const void* rows, const void* cc, void* gm,
                                      void* gi, int b_pad, long long n, int d_pad, int chunk,
                                      int dtype, void* stream) {
  // d_pad <= 3072: an 8-query tile (48 KB) and two stages always fit
  if (b_pad <= 0 || b_pad % 8 != 0 || n <= 0 || d_pad <= 0 || d_pad % 8 != 0 ||
      d_pad > 3072 || chunk <= 0 || chunk % kLanes != 0 || chunk > 8192 || n % chunk != 0 ||
      n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* p = static_cast<const float*>(cc);
  auto* m = static_cast<float*>(gm);
  auto* g = static_cast<int32_t*>(gi);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 1: err = launch_typed<__half>(q, rows, p, m, g, b_pad, n, d_pad, chunk, s); break;
    case 2: err = launch_typed<__nv_bfloat16>(q, rows, p, m, g, b_pad, n, d_pad, chunk, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

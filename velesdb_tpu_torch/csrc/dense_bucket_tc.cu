// dense_bucket_tc.cu — half-precision and split-bf16 bucket scans on
// Hopper's tensor cores (#2b and #3).
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
//
// Split mode (#3). Replaces velesdb_tpu/ops/bucket_kernel.py::_kernel_hl
// (the Pallas kernel launched by bucket_topk_hl): the FULL-storage
// ``split-bf16`` serve core, f32 rows stored as a (hi, lo) bf16 pair,
// hi = bf16(x), lo = bf16(x - hi), and the queries split the same way:
//
//   inputs   qhi, qlo  bf16 [B_pad, D_pad]   split queries
//            hi, lo    bf16 [N, D_pad]       split corpus rows
//            cc        f32  [N]              additive penalty, +inf knocked out
//   s[b, r]  = sum over d of qhi*hi + qhi*lo + qlo*hi, minus cc[r]
//   (the reference's two MXU products qhi.hi and [qhi|qlo].[lo|hi]; the
//   qlo*lo term, ~2^-16 relative, is dropped as the reference drops it), and
//   gm/gi as above. The products of two bf16 values are exact in fp32, so it
//   is held to hl_bucket_ref (the fixed-order sums a = qhi.hi, e = qhi.lo
//   then qlo.hi, (a + e) - cc) within split_scan_tolerance.
//
// The same kernel with a template flag: both query halves stay resident as
// two B operands; each ring stage carries the hi and the lo tile of one
// 64-dim K block (2 x 16 KB); each K step issues three wgmma into one set of
// accumulators (hi.qhi, lo.qhi, hi.qlo); the epilogue is #2b's. Bound: 3 x
// 2 * B_pad * N * D_pad bf16 operations at 989 TFLOP/s (0.209 ms at B_pad
// 256, N 1,048,576, D_pad 128) against 4 * N * D_pad bytes of rows (0.160
// ms). The query tile is the largest whose two halves and two stages fit:
// NQ 128 up to D_pad 320, NQ 16 at D_pad 1536 (the reference's cap).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;        // two warpgroups
constexpr int kLanes = 128;          // bucket lanes = rows of a slice
constexpr int kKBlock = 64;          // dims of a stage: one 128-byte swizzle row
constexpr int kStageBytes = kLanes * 128;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;

// Byte-selector that puts the low byte of the second __byte_perm operand at
// byte ``p`` of the first: the slice index of accumulator ``4i + p`` lives in
// byte ``p`` of word ``i``.
__device__ __forceinline__ unsigned put_byte_sel(int p) {
  return p == 0 ? 0x3214u : p == 1 ? 0x3240u : p == 2 ? 0x3410u : 0x4210u;
}

// Shared-memory bytes of one ring stage: the slice's tile of one K block, or
// in split mode its hi and lo tiles.
template <bool kSplit>
__host__ __device__ constexpr int stage_bytes() {
  return kSplit ? 2 * kStageBytes : kStageBytes;
}

// ``q2`` and ``rows2`` are the second halves (qlo, lo) in split mode, unused
// otherwise.
template <typename T, int NQ, int S, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
dense_tc_kernel(const T* __restrict__ q, const T* __restrict__ q2, const T* __restrict__ rows,
                const T* __restrict__ rows2, const float* __restrict__ cc,
                float* __restrict__ gm, int32_t* __restrict__ gi,
                int b_pad, int d_pad, int chunk, int n_qtiles, long long n_buckets) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kHalves = kSplit ? 2 : 1;
  constexpr int kStage = stage_bytes<kSplit>();
  constexpr int R = NQ / 2;   // accumulators per thread: two rows x NQ/4 queries
  constexpr int W = NQ / 8;   // packed slice-index words per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // every operand region starts 1024-byte aligned in the shared window (the
  // swizzle's repeat), so the launch asks for 1 KB more than it uses
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024u - (raw_addr & 1023u)) & 1023u);
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  // kHalves x kb_count x [NQ][128 B] (split: the qhi tiles, then qlo's)
  unsigned char* s_q = smem;
  // S x kHalves x [128][128 B] (split: a stage's hi tile, then its lo tile)
  unsigned char* s_rows = smem + kHalves * kb_count * NQ * 128;
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

  // The query tile (split: both halves), zero past B_pad and D_pad, swizzled
  // as wgmma's B.
  for (int x = tid; x < kHalves * kb_count * NQ * 8; x += kThreads) {
    const int h = x / (kb_count * NQ * 8);
    const int kb = (x / (NQ * 8)) % kb_count;
    const int r = (x / 8) % NQ;
    const int ch = x % 8;
    const int col = kb * kKBlock + ch * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < b_pad && col < d_pad) {
      v = *reinterpret_cast<const uint4*>((h ? q2 : q) + static_cast<long long>(q0 + r) * d_pad +
                                          col);
    }
    *reinterpret_cast<uint4*>(s_q + (h * kb_count + kb) * NQ * 128 + swz(r, ch)) = v;
  }

  // Step t loads dims kb*64 .. kb*64+63 of slice s = t / kb_count into stage
  // t % S: 1024 chunks of 16 bytes a tile, four a thread, a warp on four
  // whole rows (split: the hi tile, then the lo tile).
  auto load_step = [&](int t) {
    const int s = t / kb_count;
    const int kb = t - s * kb_count;
    const long long off = (row0 + static_cast<long long>(s) * kLanes) * d_pad + kb * kKBlock;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const uint32_t dst =
          rows_addr + static_cast<uint32_t>((t % S) * kStage + h * kStageBytes);
      const T* base = (h ? rows2 : rows) + off;
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
    const uint32_t a0 = rows_addr + static_cast<uint32_t>((t % S) * kStage + wg * 64 * 128);
    const uint32_t b0 = q_addr + static_cast<uint32_t>(kb * NQ * 128);
    fence_regs<R>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kKBlock / 16; ++k) {
      if (k < k16) {
        wgmma<NQ, kBf16>(acc, smem_desc(a0 + 32 * k), smem_desc(b0 + 32 * k),
                         (kb > 0 || k > 0) ? 1 : 0);
        if constexpr (kSplit) {
          // lo . qhi, then hi . qlo, into the same accumulators
          const uint32_t qlo = b0 + static_cast<uint32_t>(kb_count * NQ * 128);
          wgmma<NQ, kBf16>(acc, smem_desc(a0 + kStageBytes + 32 * k), smem_desc(b0 + 32 * k), 1);
          wgmma<NQ, kBf16>(acc, smem_desc(a0 + 32 * k), smem_desc(qlo + 32 * k), 1);
        }
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

// The operands of one launch: q and rows, and in split mode qlo and lo.
struct Operands {
  const void* q;
  const void* q2;
  const void* rows;
  const void* rows2;
  const float* cc;
  float* gm;
  int32_t* gi;
};

template <typename T, int NQ, int S, bool kSplit>
cudaError_t launch(const Operands& o, int b_pad, long long n, int d_pad, int chunk,
                   cudaStream_t stream) {
  constexpr int kHalves = kSplit ? 2 : 1;
  const int n_qtiles = (b_pad + NQ - 1) / NQ;
  const long long n_chunks = n / chunk;
  const long long blocks = n_chunks * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  const size_t smem = 1024 + static_cast<size_t>(kHalves) * kb_count * NQ * 128 +
                      static_cast<size_t>(S) * stage_bytes<kSplit>();
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
    const cudaError_t e = cudaFuncSetAttribute(dense_tc_kernel<T, NQ, S, kSplit>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    allowed[dev] = smem;
  }
  dense_tc_kernel<T, NQ, S, kSplit><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(o.q), static_cast<const T*>(o.q2), static_cast<const T*>(o.rows),
      static_cast<const T*>(o.rows2), o.cc, o.gm, o.gi, b_pad, d_pad, chunk, n_qtiles,
      n_chunks * kLanes);
  return cudaGetLastError();
}

// The query tile: the smallest of 8 .. 128 that holds the batch, then the
// largest whose tile (split: both halves) and two stages fit the shared
// memory; the ring takes as many stages as then fit, up to 8 (16 KB each,
// split 32 KB).
template <typename T, int NQ, bool kSplit>
cudaError_t launch_stages(const Operands& o, int b_pad, long long n, int d_pad, int chunk,
                          cudaStream_t stream) {
  constexpr int kHalves = kSplit ? 2 : 1;
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  const long long free_bytes =
      kSmemLimit - 1024 - static_cast<long long>(kHalves) * kb_count * NQ * 128;
  const long long s = free_bytes / stage_bytes<kSplit>();
  if (s >= 8) return launch<T, NQ, 8, kSplit>(o, b_pad, n, d_pad, chunk, stream);
  if (s >= 4) return launch<T, NQ, 4, kSplit>(o, b_pad, n, d_pad, chunk, stream);
  return launch<T, NQ, 2, kSplit>(o, b_pad, n, d_pad, chunk, stream);
}

template <typename T, bool kSplit>
cudaError_t launch_typed(const Operands& o, int b_pad, long long n, int d_pad, int chunk,
                         cudaStream_t stream) {
  constexpr int kHalves = kSplit ? 2 : 1;
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  const long long room =
      (kSmemLimit - 1024 - 2LL * stage_bytes<kSplit>()) / (kHalves * kb_count * 128LL);
  int nq = b_pad <= 8 ? 8 : b_pad <= 16 ? 16 : b_pad <= 32 ? 32 : b_pad <= 64 ? 64 : 128;
  while (nq > 8 && nq > room) nq /= 2;
  switch (nq) {
    case 8: return launch_stages<T, 8, kSplit>(o, b_pad, n, d_pad, chunk, stream);
    case 16: return launch_stages<T, 16, kSplit>(o, b_pad, n, d_pad, chunk, stream);
    case 32: return launch_stages<T, 32, kSplit>(o, b_pad, n, d_pad, chunk, stream);
    case 64: return launch_stages<T, 64, kSplit>(o, b_pad, n, d_pad, chunk, stream);
    default: return launch_stages<T, 128, kSplit>(o, b_pad, n, d_pad, chunk, stream);
  }
}

bool bad_shape(int b_pad, long long n, int d_pad, int chunk, int max_dpad) {
  return b_pad <= 0 || b_pad % 8 != 0 || n <= 0 || d_pad <= 0 || d_pad % 8 != 0 ||
         d_pad > max_dpad || chunk <= 0 || chunk % kLanes != 0 || chunk > 8192 ||
         n % chunk != 0 || n > INT_MAX;
}

}  // namespace

// Plain C entry point, loaded with ctypes. ``dtype``: 1 f16, 2 bf16 (the codes
// of bucket_kernel.py's _FLOAT_CODES). Launches on ``stream`` without synchronizing and
// returns the launch's CUDA error code.
extern "C" int dense_bucket_tc_launch(const void* q, const void* rows, const void* cc, void* gm,
                                      void* gi, int b_pad, long long n, int d_pad, int chunk,
                                      int dtype, void* stream) {
  // d_pad <= 3072: an 8-query tile (48 KB) and two stages always fit
  if (bad_shape(b_pad, n, d_pad, chunk, 3072)) return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{q, nullptr, rows, nullptr, static_cast<const float*>(cc),
                   static_cast<float*>(gm), static_cast<int32_t*>(gi)};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 1: err = launch_typed<__half, false>(o, b_pad, n, d_pad, chunk, s); break;
    case 2: err = launch_typed<__nv_bfloat16, false>(o, b_pad, n, d_pad, chunk, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Split mode (#3), bf16 halves: the bucket winners of qhi.hi + qhi.lo +
// qlo.hi - cc. Launches on ``stream`` without synchronizing and returns the
// launch's CUDA error code.
extern "C" int hl_bucket_launch(const void* qhi, const void* qlo, const void* hi, const void* lo,
                                const void* cc, void* gm, void* gi, int b_pad, long long n,
                                int d_pad, int chunk, void* stream) {
  // d_pad <= 1536: two 8-query halves (48 KB) and two 32 KB stages always fit
  if (bad_shape(b_pad, n, d_pad, chunk, 1536)) return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{qhi, qlo, hi, lo, static_cast<const float*>(cc), static_cast<float*>(gm),
                   static_cast<int32_t*>(gi)};
  return static_cast<int>(launch_typed<__nv_bfloat16, true>(o, b_pad, n, d_pad, chunk,
                                                             static_cast<cudaStream_t>(stream)));
}

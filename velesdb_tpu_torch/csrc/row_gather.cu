// row_gather.cu — scored row gather for Hopper.
//
// Replaces benchmarks/exp_gather_kernel.py::kern and ::kern_db (the Pallas
// kernels that copy each gathered corpus row to VMEM with its own DMA, G in
// flight, then score the gathered block against 8 queries): one function,
// two depths of copies in flight. Bit for bit against the plain torch
// version velesdb_tpu_torch/experiments/kernels.py::row_gather_scores_ref:
//
//   inputs   q       f32   [8, D]   resident queries
//            corpus  f32   [N, D]   rows, D a multiple of 4, 16-byte aligned
//            idx     int32 [R]      row ids in [0, N); repeats allowed
//   output   out     f32   [8, R]
//   out[j, r] = sum over d = 0 .. D-1, in that order, of q[j, d] *
//               corpus[idx[r], d], each product and partial sum rounded to
//               fp32 (__fmul_rn / __fadd_rn). An id outside [0, N) reads
//               nothing and scores NaN.
//
// DEPTH 1 is ``kern``: a block issues the copies of one group of ``group``
// rows, waits for all of them, scores them, and only then issues the next
// group. DEPTH 2 is ``kern_db``: a ring of two stages, the next group's copies
// issued before the block waits on this one. ``group`` is the rows a stage
// holds, 1 to kMaxGroup.
//
// What bounds it on this card. The function moves R * D * 4 bytes of rows
// (each distinct row once), R * 4 of ids and 8 * R * 4 of scores: 4.5 MB at
// R 8,192, D 128 (1.3 us at 3.35 TB/s), 128 MB at R 262,144 (0.038 ms; ids
// drawn from 1M rows repeat). Each row is one scattered read of D * 4 bytes,
// so the rows arrive only as fast as enough of them are in flight: at ~1 us a
// DRAM round trip, 3.35 TB/s asks for some 3 MB in flight across the card,
// ~25 KB an SM. The scoring is 2 * 8 * R * D fp32 instructions in a fixed
// order (no FMA, no tree: bit for bit) and their shared-memory reads: a
// 128-bit shared load costs a warp four wavefronts, so three loads for eight
// terms a thread make ~0.05 ms of wavefronts at R 262,144, D 128, about what
// the copies take there (PERF.md: each part timed alone).
//
// What the design does about that:
// - rows are dealt to blocks in tiles of kTileRows consecutive ids, tile t to
//   block t mod grid; the grid is as many blocks as fit on the card at once
//   (the occupancy of this stage size), capped by the tile count. At R 8,192
//   that is 512 blocks of one tile, about four an SM, every row of the card in
//   flight at once; at R 262,144 each resident block walks ~8 tiles, with
//   ``group`` rows in flight a stage, and loads the queries once;
// - one bulk copy a row (cp.async.bulk, D * 4 bytes, global to shared), issued
//   by one lane of warp 0 (two for groups over 32), completing on the stage's
//   mbarrier, whose expected bytes count only the ids in range: an id outside
//   [0, N) issues no copy and adds no bytes. The queries come in the same way,
//   8 copies on a barrier of their own, waited on before the first score.
//   (16-byte cp.async by a warp a row, completing on the same barrier, moved
//   the rows no faster and cost more in all: PERF.md, tools/int8_tc_timing.py
//   --gather-parts);
// - warp 0 loads the next group's ids into registers right after it issues a
//   group, so the id load overlaps the wait and the scoring, not the next
//   round trip;
// - four threads score a row, two queries each: thread (row, p) sums queries
//   p and p + 4 in dimension order from shared memory, float4 at a time, the
//   next kAhead float4 loaded ahead. A warp reads 8 rows and 4 query chunks a
//   step: rows and queries lie D + 4 floats apart when D % 8 == 0 (else D), an
//   odd number of 16-byte units, so each quarter warp's 8 loads fall in
//   distinct banks.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 64;    // two warps; warp 0 also issues the copies
constexpr int kQueries = 8;
constexpr int kTileRows = 16;   // consecutive ids dealt to a block at a time
constexpr int kMaxGroup = 64;   // rows a stage holds at most: two a lane of warp 0
constexpr int kPartsPerRow = 4;  // scoring threads a row, two queries each
constexpr int kRowsPerPass = kThreads / kPartsPerRow;
constexpr int kAhead = 2;       // float4 words of a row loaded ahead of the arithmetic
constexpr int kSmemMax = 232448;  // 227 KB: the most dynamic shared memory a block takes

// floats between two rows (and two queries) in shared memory: D rounded to an
// odd number of 16-byte units, so consecutive rows start in different banks
__host__ __device__ constexpr int row_stride(int d) { return d % 8 == 0 ? d + 4 : d; }

// shared memory: S + 1 mbarriers (32 bytes), S * group ids (rounded to 16
// bytes), the queries [8, rs], the stages [S, group, rs]
__host__ __device__ constexpr int ids_offset() { return 32; }
__host__ __device__ constexpr int q_offset(int stages, int group) {
  return ids_offset() + (4 * stages * group + 15) / 16 * 16;
}
__host__ __device__ constexpr long long smem_bytes(int stages, int group, int d) {
  return q_offset(stages, group) + 4LL * row_stride(d) * (kQueries + stages * group);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one bulk copy of ``bytes`` (a multiple of 16; both ends 16-byte aligned)
// from device memory to this block's shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// four terms of two sums, in dimension order: a0 += u . v, a1 += w . v
__device__ __forceinline__ void terms4(float& a0, float& a1, float4 v, float4 u, float4 w) {
  a0 = __fadd_rn(a0, __fmul_rn(u.x, v.x));
  a1 = __fadd_rn(a1, __fmul_rn(w.x, v.x));
  a0 = __fadd_rn(a0, __fmul_rn(u.y, v.y));
  a1 = __fadd_rn(a1, __fmul_rn(w.y, v.y));
  a0 = __fadd_rn(a0, __fmul_rn(u.z, v.z));
  a1 = __fadd_rn(a1, __fmul_rn(w.z, v.z));
  a0 = __fadd_rn(a0, __fmul_rn(u.w, v.w));
  a1 = __fadd_rn(a1, __fmul_rn(w.w, v.w));
}

// row x against queries q0 and q1 (``words`` float4 each, shared memory),
// added to a0 and a1 in dimension order. The loads of the next kAhead words
// are issued before the arithmetic of these, so the sums' chains, not the
// loads' latency, set the pace when few warps share the SM (D 960).
__device__ __forceinline__ void score_row(const float4* x, const float4* q0, const float4* q1,
                                          int words, float& a0, float& a1) {
  float4 v[kAhead], u[kAhead], w[kAhead];
  const int full = words / kAhead * kAhead;
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      v[i] = x[i];
      u[i] = q0[i];
      w[i] = q1[i];
    }
  }
  for (int k = 0; k < full; k += kAhead) {
    const int next = k + kAhead < full ? k + kAhead : k;  // the last block reloads its own
    float4 vn[kAhead], un[kAhead], wn[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      vn[i] = x[next + i];
      un[i] = q0[next + i];
      wn[i] = q1[next + i];
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) terms4(a0, a1, v[i], u[i], w[i]);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      v[i] = vn[i];
      u[i] = un[i];
      w[i] = wn[i];
    }
  }
  for (int k = full; k < words; ++k) terms4(a0, a1, x[k], q0[k], q1[k]);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ q, const float* __restrict__ corpus,
                  const int32_t* __restrict__ idx, float* __restrict__ out, long long n,
                  int d, int r_total, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [0, S): the stages; [S]: the queries
  int* s_id = reinterpret_cast<int*>(smem + ids_offset());
  const int rs = row_stride(d);
  float* s_q = reinterpret_cast<float*>(smem + q_offset(S, group));
  float* s_rows = s_q + kQueries * rs;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool issuer = tid < 32;
  const uint32_t row_bytes = 4u * static_cast<uint32_t>(d);

  // this block's rows: tiles blockIdx.x, blockIdx.x + gridDim.x, ..., each
  // kTileRows consecutive ids; only the last tile of all may be short
  const int tiles = (r_total + kTileRows - 1) / kTileRows;
  const int my_tiles = (tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int last = blockIdx.x + (my_tiles - 1) * gridDim.x;
  const int len = (my_tiles - 1) * kTileRows + min(kTileRows, r_total - last * kTileRows);
  const int n_groups = (len + group - 1) / group;
  auto row_of = [&](int s) {  // the id position of the block's s-th row
    return (static_cast<int>(blockIdx.x) + s / kTileRows * static_cast<int>(gridDim.x)) *
               kTileRows + s % kTileRows;
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar + s, 32);  // warp 0 arrives once a group
    mbar_init(bar + S, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp 0: ids of the next group to issue, rows lane and lane + 32 of it
  long long ida = -1, idb = -1;
  auto fetch = [&](int g) {
    const int first = g * group, count = min(group, len - first);
    ida = lane < count ? idx[row_of(first + lane)] : -1;
    idb = lane + 32 < count ? idx[row_of(first + lane + 32)] : -1;
  };
  // warp 0: issue group g into stage g % S, then fetch the ids of group g + 1
  auto issue = [&](int g) {
    const int st = g % S, first = g * group, count = min(group, len - first);
    int* ids = s_id + st * group;
    float* buf = s_rows + static_cast<long long>(st) * group * rs;
    const bool va = lane < count && ida >= 0 && ida < n;
    const bool vb = lane + 32 < count && idb >= 0 && idb < n;
    if (lane < count) ids[lane] = static_cast<int>(ida);
    if (lane + 32 < count) ids[lane + 32] = static_cast<int>(idb);
    // the stage's last reads (generic proxy) come before these copies' writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive_expect_tx(bar + st, (static_cast<uint32_t>(va) + vb) * row_bytes);
    if (va) bulk_copy(buf + lane * rs, corpus + ida * d, row_bytes, bar + st);
    if (vb) bulk_copy(buf + (lane + 32) * rs, corpus + idb * d, row_bytes, bar + st);
    if (g + 1 < n_groups) fetch(g + 1);
  };

  if (issuer) {
    if (tid == 0) {
      mbar_arrive_expect_tx(bar + S, kQueries * row_bytes);
      for (int j = 0; j < kQueries; ++j)
        bulk_copy(s_q + j * rs, q + static_cast<long long>(j) * d, row_bytes, bar + S);
    }
    fetch(0);
    issue(0);
  }
  mbar_wait(bar + S, 0);

  const int part = tid % kPartsPerRow;  // this thread sums queries part and part + 4
  const float4* q0 = reinterpret_cast<const float4*>(s_q + part * rs);
  const float4* q1 = reinterpret_cast<const float4*>(s_q + (part + 4) * rs);
  const int words = d >> 2;
  for (int g = 0; g < n_groups; ++g) {
    if (S == 2 && issuer && g + 1 < n_groups) issue(g + 1);
    const int st = g % S, first = g * group, count = min(group, len - first);
    mbar_wait(bar + st, static_cast<uint32_t>(g / S) & 1u);
    const int* ids = s_id + st * group;
    const float* buf = s_rows + static_cast<long long>(st) * group * rs;
    for (int j = tid / kPartsPerRow; j < count; j += kRowsPerPass) {
      const long long id = ids[j];
      float a0 = __int_as_float(0x7fc00000), a1 = a0;  // NaN: no row was read
      if (id >= 0 && id < n) {
        a0 = 0.0f;
        a1 = 0.0f;
        score_row(reinterpret_cast<const float4*>(buf + j * rs), q0, q1, words, a0, a1);
      }
      const long long r = row_of(first + j);
      out[static_cast<long long>(part) * r_total + r] = a0;
      out[static_cast<long long>(part + 4) * r_total + r] = a1;
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
    if (S == 1 && issuer && g + 1 < n_groups) issue(g + 1);
  }
}

template <int S>
cudaError_t launch(const float* q, const float* corpus, const int32_t* idx, float* out,
                   long long n, int d, int r_total, int group, cudaStream_t stream) {
  const long long smem = smem_bytes(S, group, d);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(row_gather_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_gather_kernel<S>, kThreads,
                                                    static_cast<size_t>(smem));
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (r_total + kTileRows - 1) / kTileRows;
  const int blocks = static_cast<int>(tiles < 1LL * per_sm * sms ? tiles : 1LL * per_sm * sms);
  row_gather_kernel<S><<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
      q, corpus, idx, out, n, d, r_total, group);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on ``stream`` without
// synchronizing and returns the launch's CUDA error code. ``depth`` is 1
// (``kern``) or 2 (``kern_db``); ``group`` rows a stage. Refuses (without a
// launch) a shape the kernel does not take: D not a multiple of 4, a corpus or
// query base off 16 bytes, a group outside [1, kMaxGroup], stages that do not
// fit in shared memory.
extern "C" int row_gather_launch(const void* q, const void* corpus, const void* idx, void* out,
                                 long long n, int d, int r_total, int group, int depth,
                                 void* stream) {
  if (n <= 0 || d <= 0 || d % 4 != 0 || r_total <= 0 || group <= 0 || group > kMaxGroup ||
      (depth != 1 && depth != 2) || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(corpus) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qq = static_cast<const float*>(q);
  const auto* c = static_cast<const float*>(corpus);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = depth == 1 ? launch<1>(qq, c, ix, o, n, d, r_total, group, s)
                                     : launch<2>(qq, c, ix, o, n, d, r_total, group, s);
  return static_cast<int>(err);
}

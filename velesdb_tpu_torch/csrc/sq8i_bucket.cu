// sq8i_bucket.cu — the int8 bucket scans on Hopper's int8 tensor cores: the
// per-row SQ8 scan with four epilogues, the bit-plane Hamming scan, and the
// per-dimension "enc-select" scan.
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_sq8i_kernel (the Pallas kernel
// launched by sq8i_bucket_topk), the three epilogue experiments over the
// same int8 scan in benchmarks/exp_sq8i_v2.py (_k_v2, _k_v2h, _k_v3),
// velesdb_tpu/ops/bucket_kernel.py::_hamming_mxu_kernel (launched by
// hamming_mxu_topk) and velesdb_tpu/ops/bucket_kernel.py::_sq8pd_kernel
// (launched by sq8pd_candidates; also benchmarks/exp_sq8i_v2.py's _k_v5 and
// benchmarks/exp_hamming_mxu.py's _k_hme). Every epilogue is bit for bit
// against its plain torch version (sq8i_bucket_ref, hamming_mxu_ref,
// sq8pd_bucket_gm_ref, and velesdb_tpu_torch/experiments/kernels.py's
// sq8i_v2_bucket_ref):
//
//   inputs   qi     int8  [B_pad, D_pad]  per-query symmetric int8 queries
//                                         (#5: 2 * query sign bits, 0 or 2)
//            rows   int8  [N, D_pad]      SQ8 codes - 128 (#5: sign bits,
//                                         0 or 1)
//   doti[b, r] = qi[b] . rows[r]  (int32, exact in any order)
//   output   gm  f32   [B_pad, (N / chunk) * 128]
//            gi  int32 [B_pad, (N / chunk) * 128]
//   gm[b, c*128 + j] = max over slices i of s[b, c*chunk + i*128 + j], gi its
//   row; ties go to the smallest slice (the reference's _bucket_select), so a
//   bucket of -inf scores (pen = +inf) returns its slice-0 row.
//   #1 (sq8pd_bucket_launch) has no gi: its gm is int32, see PdEnc below.
//
// The epilogues, s[b, r] from doti:
//   #7  (sq8i_bucket_launch): scale, am, pen f32 [N]; sqi, invqs f32 [B_pad]
//        s = (float(doti) * scale[r] + sqi[b] * am[r]) - invqs[b] * pen[r]
//   v2  (sq8i_v2_bucket_launch, variant 0): aux f32 [>=3, N], rows 0/1/2 =
//        scale / am / pen; qaux f32 [B_pad, >=3], columns 1/2 = sqi / -1/qs
//        corr = sqi[b] * am[r] + (-1/qs[b]) * pen[r]
//        s    = float(doti) * scale[r] + corr
//   v2h (variant 1): aux and qaux bf16; every step of v2 rounded to bf16:
//        d = bf16(doti); corr = bf16(sqi * am + (-1/qs) * pen);
//        s = bf16(bf16(d * scale) + corr); the select runs on those bf16
//        values, gm is their exact f32
//   v3  (variant 2): no aux; s = doti (exact in fp32 up to D_pad 1024:
//        |doti| <= 127^2 * 1024 < 2^24), a lower bound, wrong for euclidean
//        by design
//   #5  (hamming_mxu_launch): aux int32 [N] = |c| + 2^20 * knocked_out
//        s = float(doti - aux[r])  (= |q| - hamming(q, c) - knockout), exact:
//        |s| <= 2^20 + 2 * D_pad < 2^24. The strict > of the running max
//        keeps the smallest slice of a tie, as the integer select does.
//   #1  (sq8pd_bucket_launch, PdEnc): qi, rows the per-dimension int8 shadow
//        in [-127, 127]; ptile int32 [N] = -64 * pen_int + in-chunk slice
//        index; s = doti * 64 + ptile[r] in int32, and
//        gm int32 [B_pad, (N / chunk) * 128] = max over slices of s. The
//        slice index sits in the low 6 bits of every score, so no two
//        slices of a bucket tie and the integer max needs no order; the
//        decode (sq8pd_candidates) reads the row back from those bits.
// The epilogue's trait (Select) says what the select keeps: Score = float
// with kSlice (a running float max and its slice, one byte each, gm f32 +
// gi), or Score = int32_t without it (PdEnc: an int32 running max, no slice
// bytes, gm int32 only). |enc| reaches 2^31, more than a float holds exactly.
// Every product and sum is written with __fmul_rn / __fadd_rn / __fsub_rn in
// the plain version's order: nvcc would otherwise contract a*b + c into an
// FMA, which PyTorch's one-op-per-kernel arithmetic never does. A bf16 step
// is an fp32 operation rounded to nearest even, as PyTorch computes bf16
// tensor arithmetic; the product of two bf16 values is exact in fp32.
//
// int32 headroom at the caps: #7's rows are code - 128 in [-128, 127] and its
// queries in [-127, 127], so every partial sum is at most 128 * 127 * 12,288
// = 199,753,728 < 2^31 at D_pad 12,288; #5's dot is at most 2 * 6,144.
// #1 (D_pad <= 512): |doti| <= 127^2 * 512 = 8,258,048, so |doti * 64| <
// 2^29; the largest penalty, _pd_invalid_pen(512) = 2 * 8,258,048 + 2^22 =
// 20,710,400 of a knocked-out row, gives |64 * pen_int| < 1.33e9, so every
// score s lies in (-1.86e9, 5.3e8], inside int32 with no wrap. An s32
// wgmma accumulation is exact in any order.
//
// What bounds it on this card. 2 * B_pad * N * D_pad int8 operations at
// 1,979 TOPS (0.035 ms at B_pad 256, N 1,048,576, D_pad 128) against N *
// D_pad bytes of rows, 12 bytes of epilogue values a row (#5 and #1: 4) and
// the gm/gi writes (0.054 ms; #1 writes gm alone: 0.046 ms); the epilogue
// adds 5 to 6 fp32 operations and a compare per (query, row), none but the
// select for v3, one subtraction for #5 and one integer multiply-add for #1
// (0.024 ms at the fp32 rate for #7).
//
// What the design does about that: #2b's pipeline (dense_bucket_tc.cu, mode
// 1) on int8 operands with s32 accumulators.
// - one block per (corpus chunk, query tile of NQ = 8 .. 128 queries), the
//   query tiles of a chunk numbered together so the chunk comes from device
//   memory once and from L2 after; 256 threads, two warpgroups;
// - the query tile sits in shared memory for the whole chunk, the B operand
//   of every wgmma (K-major, N = NQ), with the two per-query epilogue values;
// - the chunk's rows stream through a ring of S stages, each one 128-row
//   slice by 128 dims (16 KB: one 128-byte swizzle row a row), copied with
//   16-byte cp.async into the 128-byte-swizzled layout wgmma reads; they
//   need no conversion, so no register staging; dims past D_pad are
//   zero-filled up to the next K step of 32;
// - warpgroup w multiplies rows 64w .. 64w + 63 of the slice (the A operand,
//   M = 64) by the query tile with wgmma.m64nNk32.s32.s8.s8, one per 32 dims;
// - the epilogue is a template parameter and stays in registers: each
//   functor reads only the per-row and per-query values it uses, turns the
//   exact s32 dot into the score and keeps a running (max, slice) per (row
//   lane, query), the slice packed one byte each (#1: an int32 max alone),
//   and gm/gi are written once per chunk, so the [B, N] score tile never
//   exists.
// The query tile is the largest whose NQ x D_pad bytes fit beside two
// stages: NQ 128 up to D_pad 1,536, NQ 16 at #7's cap of 12,288, NQ 32 at
// #5's cap of 6,144. The ring takes as many stages as fit beside it, up to 8
// (#1, D_pad <= 512: always 8).
//
// What it leaves on the table: as in #2b, each step waits for its wgmma
// group before the epilogue, so the tensor cores and the epilogue never
// overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;              // two warpgroups
constexpr int kLanes = 128;                // bucket lanes = rows of a slice
constexpr int kKBlock = 128;               // int8 dims of a stage: one swizzle row
constexpr int kStageBytes = kLanes * 128;  // 16 KB
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;

// #7: the reference's per-row affine, three f32 row vectors.
struct Affine {
  const float *scale, *am, *pen, *sqi, *invqs;
  struct Row {
    float sc, a, p;
  };
  __device__ float qa(int b) const { return sqi[b]; }
  __device__ float qb(int b) const { return invqs[b]; }
  __device__ Row row(long long r) const {
    return {__ldg(scale + r), __ldg(am + r), __ldg(pen + r)};
  }
  __device__ float score(int acc, float sq, float iq, const Row& w) const {
    const float t = __fadd_rn(__fmul_rn(__int2float_rn(acc), w.sc), __fmul_rn(sq, w.a));
    return __fsub_rn(t, __fmul_rn(iq, w.p));
  }
};

// v2: the rank-1 corrections summed first, then added to the scaled dot.
struct Folded {
  const float *aux, *qaux;
  long long n;
  int qstride;
  struct Row {
    float sc, a, p;
  };
  __device__ float qa(int b) const { return qaux[static_cast<long long>(b) * qstride + 1]; }
  __device__ float qb(int b) const { return qaux[static_cast<long long>(b) * qstride + 2]; }
  __device__ Row row(long long r) const {
    return {__ldg(aux + r), __ldg(aux + n + r), __ldg(aux + 2 * n + r)};
  }
  __device__ float score(int acc, float sq, float niq, const Row& w) const {
    const float corr = __fadd_rn(__fmul_rn(sq, w.a), __fmul_rn(niq, w.p));
    return __fadd_rn(__fmul_rn(__int2float_rn(acc), w.sc), corr);
  }
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// v2h: v2 in bf16, each step rounded.
struct FoldedBf16 {
  const __nv_bfloat16 *aux, *qaux;
  long long n;
  int qstride;
  struct Row {
    float sc, a, p;
  };
  __device__ float qa(int b) const {
    return __bfloat162float(qaux[static_cast<long long>(b) * qstride + 1]);
  }
  __device__ float qb(int b) const {
    return __bfloat162float(qaux[static_cast<long long>(b) * qstride + 2]);
  }
  __device__ Row row(long long r) const {
    return {__bfloat162float(aux[r]), __bfloat162float(aux[n + r]),
            __bfloat162float(aux[2 * n + r])};
  }
  __device__ float score(int acc, float sq, float niq, const Row& w) const {
    const float corr = bf16r(__fadd_rn(__fmul_rn(sq, w.a), __fmul_rn(niq, w.p)));
    const float t = bf16r(__fmul_rn(bf16r(__int2float_rn(acc)), w.sc));
    return bf16r(__fadd_rn(t, corr));
  }
};

// v3: the raw dot.
struct RawDot {
  struct Row {};
  __device__ float qa(int) const { return 0.0f; }
  __device__ float qb(int) const { return 0.0f; }
  __device__ Row row(long long) const { return {}; }
  __device__ float score(int acc, float, float, const Row&) const { return __int2float_rn(acc); }
};

// #5: the dot less |c| and the knockout, exact in fp32.
struct Hamming {
  const int32_t* aux;
  struct Row {
    int a;
  };
  __device__ float qa(int) const { return 0.0f; }
  __device__ float qb(int) const { return 0.0f; }
  __device__ Row row(long long r) const { return {__ldg(aux + r)}; }
  __device__ float score(int acc, float, float, const Row& w) const {
    return __int2float_rn(acc - w.a);
  }
};

// #1: the encoded score doti * 64 + ptile[r], an int32 whose low 6 bits are
// the slice: the select is an integer max and the output has no gi.
struct PdEnc {
  const int32_t* ptile;
  struct Row {
    int pt;
  };
  __device__ float qa(int) const { return 0.0f; }
  __device__ float qb(int) const { return 0.0f; }
  __device__ Row row(long long r) const { return {__ldg(ptile + r)}; }
  __device__ int32_t score(int acc, float, float, const Row& w) const { return acc * 64 + w.pt; }
};

// What the select keeps: a float score and its slice (gm f32 + gi), or, for
// a score that carries its slice in its low bits, the score alone (gm of
// Score, no gi).
template <class Epi>
struct Select {
  using Score = float;
  static constexpr bool kSlice = true;
};
template <>
struct Select<PdEnc> {
  using Score = int32_t;
  static constexpr bool kSlice = false;
};

template <int NQ, int S, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
sq8i_tc_kernel(const int8_t* __restrict__ qi, const int8_t* __restrict__ rows, const Epi epi,
               typename Select<Epi>::Score* __restrict__ gm, int32_t* __restrict__ gi,
               int b_pad, int d_pad, int chunk, int n_qtiles, long long n_buckets) {
  using Score = typename Select<Epi>::Score;
  constexpr int R = NQ / 2;  // accumulators per thread: two rows x NQ/4 queries
  constexpr int W = Select<Epi>::kSlice ? NQ / 8 : 1;  // packed slice-index words per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // every operand region starts 1024-byte aligned in the shared window (the
  // swizzle's repeat), so the launch asks for 1 KB more than it uses
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024u - (raw_addr & 1023u)) & 1023u);
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  // kb_count x [NQ][128 B] query blocks, then S x [128][128 B] row stages,
  // then the per-query epilogue values
  unsigned char* s_q = smem;
  unsigned char* s_rows = smem + kb_count * NQ * 128;
  float* s_qa = reinterpret_cast<float*>(s_rows + S * kStageBytes);
  float* s_qb = s_qa + NQ;
  const uint32_t q_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_q));
  const uint32_t rows_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_rows));

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // rows 64 wg .. 64 wg + 63 of each slice
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
    const int col = kb * kKBlock + ch * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < b_pad && col < d_pad) {
      v = *reinterpret_cast<const uint4*>(qi + static_cast<long long>(q0 + r) * d_pad + col);
    }
    *reinterpret_cast<uint4*>(s_q + kb * NQ * 128 + swz(r, ch)) = v;
  }
  for (int j = tid; j < NQ; j += kThreads) {
    s_qa[j] = q0 + j < b_pad ? epi.qa(q0 + j) : 0.0f;
    s_qb[j] = q0 + j < b_pad ? epi.qb(q0 + j) : 0.0f;
  }

  // Step t loads dims kb*128 .. kb*128+127 of slice s = t / kb_count into
  // stage t % S: 1024 chunks of 16 bytes, four a thread, a warp on four
  // whole rows; chunks past D_pad are zero-filled (source size 0).
  auto load_step = [&](int t) {
    const int s = t / kb_count;
    const int kb = t - s * kb_count;
    const int8_t* base = rows + (row0 + static_cast<long long>(s) * kLanes) * d_pad + kb * kKBlock;
    const uint32_t dst = rows_addr + static_cast<uint32_t>((t % S) * kStageBytes);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = tid + j * kThreads;
      const int r = x / 8;
      const int ch = x % 8;
      const bool ok = kb * kKBlock + ch * 16 < d_pad;
      cp_async16(dst + swz(r, ch),
                 ok ? static_cast<const void*>(base + static_cast<long long>(r) * d_pad + ch * 16)
                    : static_cast<const void*>(rows),
                 ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < steps) load_step(t);
    cp_async_commit();
  }

  int acc[R];
  Score mx[R];
  unsigned mi[W];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    acc[i] = 0;
    if constexpr (Select<Epi>::kSlice) {
      mx[i] = -__int_as_float(0x7f800000);  // -inf
    } else {
      mx[i] = INT_MIN;
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) mi[i] = 0u;

  // this thread's two rows of each slice (accumulator rows lr and lr + 8)
  const int lr = 64 * wg + 16 * warp + lane / 4;
  typename Epi::Row w_lo = epi.row(row0 + lr);
  typename Epi::Row w_hi = epi.row(row0 + lr + 8);

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<S - 2>();
    fence_async_smem();
    __syncthreads();  // stage t landed for every thread; stage t-1 is free
    if (t + S - 1 < steps) load_step(t + S - 1);
    cp_async_commit();

    const int s = t / kb_count;
    const int kb = t - s * kb_count;
    const int k32 = (min(kKBlock, d_pad - kb * kKBlock) + 31) / 32;  // K steps, zero-padded
    const uint32_t a0 = rows_addr + static_cast<uint32_t>((t % S) * kStageBytes + wg * 64 * 128);
    const uint32_t b0 = q_addr + static_cast<uint32_t>(kb * NQ * 128);
    fence_regs<R>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kKBlock / 32; ++k) {
      if (k < k32) {
        wgmma_s8<NQ>(acc, smem_desc(a0 + 32 * k), smem_desc(b0 + 32 * k),
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
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const Score v = epi.score(acc[i], s_qa[col], s_qb[col], (i & 2) ? w_hi : w_lo);
        if constexpr (Select<Epi>::kSlice) {
          if (v > mx[i]) {
            mx[i] = v;
            mi[i / 4] = __byte_perm(mi[i / 4], sb, put_byte_sel(i % 4));
          }
        } else {
          mx[i] = max(mx[i], v);  // the slice is in the score's low bits
        }
      }
      if (s + 1 < slices) {
        const long long nxt = row0 + static_cast<long long>(s + 1) * kLanes + lr;
        w_lo = epi.row(nxt);
        w_hi = epi.row(nxt + 8);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
    const int lane_row = lr + ((i & 2) ? 8 : 0);
    if (q0 + col < b_pad) {
      const long long off = static_cast<long long>(q0 + col) * n_buckets + c * kLanes + lane_row;
      gm[off] = mx[i];
      if constexpr (Select<Epi>::kSlice) {
        const int slice = static_cast<int>((mi[i / 4] >> (8 * (i % 4))) & 0xFFu);
        gi[off] = static_cast<int32_t>(row0 + slice * kLanes + lane_row);
      }
    }
  }
}

size_t smem_bytes(int nq, int s, int d_pad) {
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  return 1024 + static_cast<size_t>(kb_count) * nq * 128 + static_cast<size_t>(s) * kStageBytes +
         2 * sizeof(float) * nq;
}

template <int NQ, int S, class Epi>
cudaError_t launch(const int8_t* qi, const int8_t* rows, const Epi& epi,
                   typename Select<Epi>::Score* gm, int32_t* gi, int b_pad, long long n,
                   int d_pad, int chunk, cudaStream_t stream) {
  const int n_qtiles = (b_pad + NQ - 1) / NQ;
  const long long n_chunks = n / chunk;
  const long long blocks = n_chunks * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(NQ, S, d_pad);
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
    const cudaError_t e = cudaFuncSetAttribute(sq8i_tc_kernel<NQ, S, Epi>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    allowed[dev] = smem;
  }
  sq8i_tc_kernel<NQ, S, Epi><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      qi, rows, epi, gm, gi, b_pad, d_pad, chunk, n_qtiles, n_chunks * kLanes);
  return cudaGetLastError();
}

// The ring takes as many stages as fit beside the query tile, up to 8. #1's
// D_pad cap of 512 always leaves room for 8 (a 64 KB tile at NQ 128), so it
// builds that ring alone.
template <int NQ, class Epi>
cudaError_t launch_stages(const int8_t* qi, const int8_t* rows, const Epi& epi,
                          typename Select<Epi>::Score* gm, int32_t* gi, int b_pad, long long n,
                          int d_pad, int chunk, cudaStream_t stream) {
  if constexpr (!Select<Epi>::kSlice) {
    return launch<NQ, 8>(qi, rows, epi, gm, gi, b_pad, n, d_pad, chunk, stream);
  } else {
    const long long free_bytes = kSmemLimit - static_cast<long long>(smem_bytes(NQ, 0, d_pad));
    const long long s = free_bytes / kStageBytes;
    if (s >= 8) return launch<NQ, 8>(qi, rows, epi, gm, gi, b_pad, n, d_pad, chunk, stream);
    if (s >= 4) return launch<NQ, 4>(qi, rows, epi, gm, gi, b_pad, n, d_pad, chunk, stream);
    return launch<NQ, 2>(qi, rows, epi, gm, gi, b_pad, n, d_pad, chunk, stream);
  }
}

// The query tile: the smallest of 8 .. 128 that holds the batch, then the
// largest whose bytes and two stages fit the shared memory.
template <class Epi>
int dispatch(const void* qi, const void* rows, const Epi& epi, void* gm, void* gi, int b_pad,
             long long n, int d_pad, int chunk, void* stream) {
  const auto* q = static_cast<const int8_t*>(qi);
  const auto* r = static_cast<const int8_t*>(rows);
  auto* m = static_cast<typename Select<Epi>::Score*>(gm);
  auto* g = static_cast<int32_t*>(gi);
  auto s = static_cast<cudaStream_t>(stream);
  int nq = b_pad <= 8 ? 8 : b_pad <= 16 ? 16 : b_pad <= 32 ? 32 : b_pad <= 64 ? 64 : 128;
  while (nq > 8 && smem_bytes(nq, 2, d_pad) > kSmemLimit) nq /= 2;
  cudaError_t err;
  switch (nq) {
    case 8: err = launch_stages<8>(q, r, epi, m, g, b_pad, n, d_pad, chunk, s); break;
    case 16: err = launch_stages<16>(q, r, epi, m, g, b_pad, n, d_pad, chunk, s); break;
    case 32: err = launch_stages<32>(q, r, epi, m, g, b_pad, n, d_pad, chunk, s); break;
    case 64: err = launch_stages<64>(q, r, epi, m, g, b_pad, n, d_pad, chunk, s); break;
    default: err = launch_stages<128>(q, r, epi, m, g, b_pad, n, d_pad, chunk, s);
  }
  return static_cast<int>(err);
}

bool bad_shape(int b_pad, long long n, int d_pad, int chunk, int max_dpad) {
  return b_pad <= 0 || n <= 0 || d_pad <= 0 || d_pad % 16 != 0 || d_pad > max_dpad ||
         chunk <= 0 || chunk % kLanes != 0 || chunk > 8192 || n % chunk != 0 || n > INT_MAX;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on ``stream``
// without synchronizing and returns the launch's CUDA error code.

// #7, the per-row affine of the serve path.
extern "C" int sq8i_bucket_launch(const void* qi, const void* rows, const void* scale,
                                  const void* am, const void* pen, const void* sqi,
                                  const void* invqs, void* gm, void* gi, int b_pad,
                                  long long n, int d_pad, int chunk, void* stream) {
  if (bad_shape(b_pad, n, d_pad, chunk, 12288)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Affine epi{static_cast<const float*>(scale), static_cast<const float*>(am),
                   static_cast<const float*>(pen), static_cast<const float*>(sqi),
                   static_cast<const float*>(invqs)};
  return dispatch(qi, rows, epi, gm, gi, b_pad, n, d_pad, chunk, stream);
}

// The epilogue experiments: variant 0 = v2, 1 = v2h, 2 = v3. ``aux`` is
// [>=3, N] (row stride N), ``qaux`` [B_pad, qstride >= 3]; v3 reads neither.
extern "C" int sq8i_v2_bucket_launch(const void* qi, const void* rows, const void* aux,
                                     const void* qaux, void* gm, void* gi, int b_pad,
                                     long long n, int d_pad, int chunk, int qstride,
                                     int variant, void* stream) {
  if (bad_shape(b_pad, n, d_pad, chunk, 1024) || variant < 0 || variant > 2 ||
      (variant < 2 && (aux == nullptr || qaux == nullptr || qstride < 3))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant == 0) {
    const Folded epi{static_cast<const float*>(aux), static_cast<const float*>(qaux), n,
                     qstride};
    return dispatch(qi, rows, epi, gm, gi, b_pad, n, d_pad, chunk, stream);
  }
  if (variant == 1) {
    const FoldedBf16 epi{static_cast<const __nv_bfloat16*>(aux),
                         static_cast<const __nv_bfloat16*>(qaux), n, qstride};
    return dispatch(qi, rows, epi, gm, gi, b_pad, n, d_pad, chunk, stream);
  }
  return dispatch(qi, rows, RawDot{}, gm, gi, b_pad, n, d_pad, chunk, stream);
}

// #5, the bit-plane Hamming scan: ``qi`` 2 * query bits, ``bits`` the 0/1
// shadow, ``aux`` int32 |c| + 2^20 * knocked_out.
extern "C" int hamming_mxu_launch(const void* qi, const void* bits, const void* aux,
                                  void* gm, void* gi, int b_pad, long long n, int d_pad,
                                  int chunk, void* stream) {
  if (bad_shape(b_pad, n, d_pad, chunk, 6144)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hamming epi{static_cast<const int32_t*>(aux)};
  return dispatch(qi, bits, epi, gm, gi, b_pad, n, d_pad, chunk, stream);
}

// #1, the per-dimension enc-select scan: ``ptile`` int32 [N], ``gm`` int32
// [B_pad, N / chunk * 128], no gi.
extern "C" int sq8pd_bucket_launch(const void* qi, const void* rows, const void* ptile,
                                   void* gm, int b_pad, long long n, int d_pad, int chunk,
                                   void* stream) {
  if (bad_shape(b_pad, n, d_pad, chunk, 512)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PdEnc epi{static_cast<const int32_t*>(ptile)};
  return dispatch(qi, rows, epi, gm, nullptr, b_pad, n, d_pad, chunk, stream);
}

// dense_bucket_tc.cu — the float-score bucket scans on Hopper's tensor
// cores, in four modes of one kernel: #2b and #2 (f16/bf16 and f32 rows),
// #3 (split-bf16 rows) and #6 (SQ8 words).
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_kernel (the Pallas kernel
// launched by _bucket_call from bucket_topk_entry): the ``bucket-f32`` serve
// core and bucket_topk's contract. Mode 1 (#2b) takes f16 and bf16 rows,
// mode 3 (#2) f32 rows:
//
//   inputs   q     T     [B_pad, D_pad]  queries in the row type T (f16/bf16;
//                                        cosine: normalized; euclidean: 2q);
//                                        f32 rows: the f32 queries split by
//                                        the wrapper, qhi = bf16(q),
//                                        qlo = bf16(q - qhi)
//            rows  T     [N, D_pad]      corpus rows (f16, bf16 or f32)
//            cc    f32   [N]             |c|^2 (euclidean) or 0, +inf on
//                                        knocked-out rows
//   output   gm  f32   [B_pad, (N / chunk) * 128]
//            gi  int32 [B_pad, (N / chunk) * 128]
//   s[b, r]  = sum over d of q[b, d] * rows[r, d], minus cc[r]
//   gm[b, c*128 + j] = max over slices i of s[b, c*chunk + i*128 + j], gi its
//   row; ties go to the smallest slice, so a bucket of -inf scores returns
//   its slice-0 row.
//
// It is held to dense_bucket_ref (the fixed-order fp32 sum) within a stated
// tolerance, not bit for bit: the products of two half values are exact in
// fp32, and wgmma adds them in its own order (bucket_kernel.py,
// half_scan_tolerance); f32 rows within f32_scan_tolerance (below).
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
// Mode 2, split (#3). Replaces velesdb_tpu/ops/bucket_kernel.py::_kernel_hl
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
// Both query halves stay resident as two B operands; each ring stage carries
// the hi and the lo tile of one 64-dim K block (2 x 16 KB); each K step
// issues three wgmma into one set of accumulators (hi.qhi, lo.qhi, hi.qlo);
// the epilogue is #2b's. Bound: 3 x 2 * B_pad * N * D_pad bf16 operations at
// 989 TFLOP/s (0.209 ms at B_pad 256, N 1,048,576, D_pad 128) against
// 4 * N * D_pad bytes of rows (0.160 ms). The query tile is the largest whose
// two halves and two stages fit: NQ 128 up to D_pad 320, NQ 16 at D_pad 1536
// (the reference's cap).
//
// Mode 3, f32 rows (#2). #3's arithmetic on rows that arrive in f32 (#8's
// split, fused_topk.cu): the wrapper splits the queries once, the kernel
// splits each row as it is staged, hi = bf16(x), lo = bf16(x - hi), and each
// K step issues hi.qhi, lo.qhi and hi.qlo. The rows cannot go through
// cp.async, which does not convert: they come into registers two K blocks
// ahead (16-byte loads, wgmma.cuh's register staging) and are split into the
// one of two operand buffers (hi and lo tiles, 2 x 16 KB each) that the
// tensor cores are not reading, while they run the other. It drops the terms
// of q.x beyond the three products (qlo*lo, qhi*(x - hi - lo), (q - qhi -
// qlo)*hi, each under 2^-16 |q_d x_d|) and sums in the tensor cores' order:
// it is held to dense_bucket_ref within f32_scan_tolerance. Bound: the same
// three bf16 products (0.209 ms at B_pad 256, N 1,048,576, D_pad 128)
// against 4 * N * D_pad bytes (0.160 ms). The query tile is the largest
// whose two halves fit beside the two buffers: NQ 128 up to D_pad 320, NQ 8
// at D_pad 3072 (the contract's cap).
//
// Mode 4, SQ8 words (#6). Replaces velesdb_tpu/ops/bucket_kernel.py::
// _sq8_kernel with the f32 unpack (launched by sq8_bucket_topk): the
// ``sq8-bucket`` serve core of SQ8 storage at or above _SQ8I_MAX_DIM:
//
//   inputs   qhi, qmid, qlo  bf16 [B_pad, K]  the f32 queries, their columns
//                                        permuted to the words' order
//                                        (q'[:, 4w + j] = q[:, j W + w]) and
//                                        split exactly: qhi = bf16(q'),
//                                        qmid = bf16(q' - qhi), qlo =
//                                        bf16(q' - qhi - qmid); K = 4 W
//                                        rounded up to a multiple of 8
//            words  int32 [N, W]          codes from sq8_pack_blocked: byte
//                                        j of word w holds dim j * W + w
//            scale, minv, pen  f32 [N]    per-row affine and additive
//                                        penalty (+inf knocked out)
//            qsum   f32   [B_pad]         sum(q), summed once by the wrapper
//   s[b, r]  = (dot * scale[r] + qsum[b] * minv[r]) - pen[r], each product
//              and sum rounded to fp32 in that order, dot = q . codes
//   gm/gi as above.
// Codes 0..255 are exact in bf16 and so are the three query parts (three
// 8-bit significands cover f32's 24; bf16 has f32's exponent range), so
// every product part * code is exact in fp32 and the kernel departs from
// the plain version only in the order of its fp32 sums: it is held to
// sq8_bucket_ref within sq8_scan_tolerance. A dot product does not care
// about the order of its dims, so word w unpacks into K positions 4w ..
// 4w + 3 and one 16-byte load gives 16 consecutive K values; the words come
// through registers like mode 3's rows, unpacked into one bf16 tile; each K
// step issues codes.qhi, codes.qmid, codes.qlo into one accumulator set; the
// epilogue applies the affine per row lane (scale, minv and pen read like
// cc, qsum from shared memory) before the running (max, slice) select.
// Bound: three bf16 products, 6 * B_pad * N * K operations at 989 TFLOP/s
// (0.209 ms at B_pad 256, N 1,048,576, K 128), against N * K + 12 * N bytes
// (0.044 ms). The three query parts stay resident: NQ 128 up to K 256, NQ 32
// at K 768, NQ 8 at K 3072.
//
// What modes 3 and 4 leave on the table: at D 768 and above the resident
// query parts shrink the tile (each chunk's rows are then converted once per
// query tile), where streaming the query parts by K block, as fused_topk.cu
// does, would keep NQ 128.

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

// The four modes: what the rows are, how they reach shared memory, and how
// many query parts the products take.
enum Mode : int {
  kHalf = 1,   // #2b: f16/bf16 rows and queries, cp.async ring
  kSplit = 2,  // #3: (hi, lo) bf16 rows and query halves, cp.async ring
  kF32 = 3,    // #2: f32 rows split in registers, query halves
  kSq8 = 4,    // #6: SQ8 words unpacked in registers, three query parts
};

// Query parts resident as B operands.
__host__ __device__ constexpr int q_parts(int m) { return m == kHalf ? 1 : m == kSq8 ? 3 : 2; }
// bf16 A tiles of one stage: the rows' tile, or their hi and lo tiles.
__host__ __device__ constexpr int a_tiles(int m) { return m == kSplit || m == kF32 ? 2 : 1; }
// Rows staged through registers (converted), into two operand buffers.
__host__ __device__ constexpr bool staged(int m) { return m == kF32 || m == kSq8; }
// Shared-memory bytes of one ring stage or operand buffer.
__host__ __device__ constexpr int stage_bytes(int m) { return a_tiles(m) * kStageBytes; }
// Shared-memory bytes past the query tile and the stages: qsum in mode 4.
__host__ __device__ constexpr int extra_bytes(int m, int nq) { return m == kSq8 ? nq * 4 : 0; }

// The operands of one launch. ``q`` .. ``q3`` are the query parts (mode 1:
// q; 2, 3: qhi, qlo; 4: qhi, qmid, qlo), ``rows`` the rows (mode 2: hi; 3:
// f32; 4: int32 words), ``rows2`` mode 2's lo; ``cc`` the additive penalty
// (mode 4: pen); ``scale``, ``minv``, ``qsum`` mode 4's affine.
struct Operands {
  const void* q;
  const void* q2;
  const void* q3;
  const void* rows;
  const void* rows2;
  const float* cc;
  const float* scale;
  const float* minv;
  const float* qsum;
  float* gm;
  int32_t* gi;
};

// T is the type of the operands the tensor cores read (f16 or bf16); ``w``
// is mode 4's words a row.
template <typename T, int NQ, int S, int M>
__global__ void __launch_bounds__(kThreads, 1)
dense_tc_kernel(const Operands o, int b_pad, int d_pad, int w, int chunk, int n_qtiles,
                long long n_buckets) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kParts = q_parts(M);
  constexpr int kStage = stage_bytes(M);
  constexpr bool kStaged = staged(M);
  static_assert(!kStaged || S == 2, "the staged modes take two operand buffers");
  constexpr int R = NQ / 2;   // accumulators per thread: two rows x NQ/4 queries
  constexpr int W = NQ / 8;   // packed slice-index words per thread
  // staged: 16-byte vectors a row of a K block (64 f32, or 16 words), and a
  // thread's share of a 128-row tile
  constexpr int kGroups = M == kF32 ? 16 : 4;
  constexpr int kLoads = kStaged ? kLanes * kGroups / kThreads : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // every operand region starts 1024-byte aligned in the shared window (the
  // swizzle's repeat), so the launch asks for 1 KB more than it uses
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024u - (raw_addr & 1023u)) & 1023u);
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  const int part_bytes = kb_count * NQ * 128;
  // kParts x kb_count x [NQ][128 B] (the parts one after another)
  unsigned char* s_q = smem;
  // S x a_tiles x [128][128 B] (split and f32: a stage's hi tile, then its lo)
  unsigned char* s_rows = smem + kParts * part_bytes;
  float* s_qsum = reinterpret_cast<float*>(s_rows + S * kStage);  // mode 4: [NQ]
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

  // The query tile (every part), zero past B_pad and D_pad, swizzled as
  // wgmma's B.
  for (int x = tid; x < kParts * kb_count * NQ * 8; x += kThreads) {
    const int h = x / (kb_count * NQ * 8);
    const int kb = (x / (NQ * 8)) % kb_count;
    const int r = (x / 8) % NQ;
    const int ch = x % 8;
    const int col = kb * kKBlock + ch * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < b_pad && col < d_pad) {
      const T* part = static_cast<const T*>(h == 0 ? o.q : h == 1 ? o.q2 : o.q3);
      v = *reinterpret_cast<const uint4*>(part + static_cast<long long>(q0 + r) * d_pad + col);
    }
    *reinterpret_cast<uint4*>(s_q + (h * kb_count + kb) * NQ * 128 + swz(r, ch)) = v;
  }
  if constexpr (M == kSq8) {
    for (int j = tid; j < NQ; j += kThreads) s_qsum[j] = q0 + j < b_pad ? o.qsum[q0 + j] : 0.0f;
  }

  // Ring modes: step t loads dims kb*64 .. kb*64+63 of slice s = t / kb_count
  // into stage t % S: 1024 chunks of 16 bytes a tile, four a thread, a warp
  // on four whole rows (split: the hi tile, then the lo tile).
  auto load_step = [&](int t) {
    const int s = t / kb_count;
    const int kb = t - s * kb_count;
    const long long off = (row0 + static_cast<long long>(s) * kLanes) * d_pad + kb * kKBlock;
#pragma unroll
    for (int h = 0; h < a_tiles(M); ++h) {
      const uint32_t dst =
          rows_addr + static_cast<uint32_t>((t % S) * kStage + h * kStageBytes);
      const T* base = static_cast<const T*>(h ? o.rows2 : o.rows) + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = tid + j * kThreads;
        const int r = x / 8;
        const int ch = x % 8;
        const bool ok = kb * kKBlock + ch * 8 < d_pad;
        cp_async16(dst + swz(r, ch), ok ? static_cast<const void*>(base + r * d_pad + ch * 8)
                                        : o.rows,
                   ok ? 16 : 0);
      }
    }
  };

  // Staged modes: step t's rows (f32: dims kb*64 .. kb*64+63; SQ8: words
  // kb*16 .. kb*16+15) come into registers two steps ahead and are converted
  // into operand buffer t % 2 one step ahead.
  uint4 pre[kLoads];
  const long long row_stride = M == kSq8 ? 4LL * w : 4LL * d_pad;  // bytes
  const int row_bytes = static_cast<int>(row_stride);
  const bool vec = row_stride % 16 == 0;
  auto stage_rows = [&](int t) {
    const int s = t / kb_count;
    const int kb = t - s * kb_count;
    const long long r0 = row0 + static_cast<long long>(s) * kLanes;
    stage_load<kGroups, kLoads, kThreads>(
        pre, static_cast<const unsigned char*>(o.rows) + r0 * row_stride, row_stride, kLanes,
        kb * kGroups * 16, row_bytes, vec, tid);
  };
  auto convert = [&](int buf) {
    unsigned char* a = s_rows + buf * kStage;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int x = tid + j * kThreads;
      if constexpr (M == kF32) {
        store_split_f32(a, a + kStageBytes, x / kGroups, x % kGroups, pre[j]);
      } else {
        store_codes(a, x / kGroups, x % kGroups, pre[j]);
      }
    }
  };

  if constexpr (kStaged) {
    stage_rows(0);
    convert(0);
    if (steps > 1) stage_rows(1);
    fence_async_smem();
    __syncthreads();  // the query tile and step 0's operands, for every thread
  } else {
#pragma unroll
    for (int t = 0; t < S - 1; ++t) {
      if (t < steps) load_step(t);
      cp_async_commit();
    }
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

  // this thread's two rows of each slice (accumulator rows lr and lr + 8):
  // the penalty, and mode 4's affine
  const int lr = 64 * wg + 16 * warp + lane / 4;
  float cc_lo = __ldg(o.cc + row0 + lr);
  float cc_hi = __ldg(o.cc + row0 + lr + 8);
  float sc_lo = 0.0f, sc_hi = 0.0f, mn_lo = 0.0f, mn_hi = 0.0f;
  if constexpr (M == kSq8) {
    sc_lo = __ldg(o.scale + row0 + lr);
    sc_hi = __ldg(o.scale + row0 + lr + 8);
    mn_lo = __ldg(o.minv + row0 + lr);
    mn_hi = __ldg(o.minv + row0 + lr + 8);
  }

  for (int t = 0; t < steps; ++t) {
    if constexpr (!kStaged) {
      cp_async_wait<S - 2>();
      fence_async_smem();
      __syncthreads();  // stage t landed for every thread; stage t-1 is free
      if (t + S - 1 < steps) load_step(t + S - 1);
      cp_async_commit();
    }

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
        if constexpr (M == kSplit || M == kF32) {
          // lo . qhi, then hi . qlo, into the same accumulators
          const uint32_t qlo = b0 + static_cast<uint32_t>(part_bytes);
          wgmma<NQ, kBf16>(acc, smem_desc(a0 + kStageBytes + 32 * k), smem_desc(b0 + 32 * k), 1);
          wgmma<NQ, kBf16>(acc, smem_desc(a0 + 32 * k), smem_desc(qlo + 32 * k), 1);
        } else if constexpr (M == kSq8) {
          // codes . qmid, then codes . qlo
          const uint32_t qmid = b0 + static_cast<uint32_t>(part_bytes);
          const uint32_t qlo = qmid + static_cast<uint32_t>(part_bytes);
          wgmma<NQ, kBf16>(acc, smem_desc(a0 + 32 * k), smem_desc(qmid + 32 * k), 1);
          wgmma<NQ, kBf16>(acc, smem_desc(a0 + 32 * k), smem_desc(qlo + 32 * k), 1);
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if constexpr (kStaged) {
      // meanwhile: convert step t + 1's rows into the other buffer (the
      // products of step t - 1 read it, and every warpgroup waited for
      // them), then load step t + 2's
      if (t + 1 < steps) convert((t + 1) % 2);
      if (t + 2 < steps) stage_rows(t + 2);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs<R>(acc);

    if (kb == kb_count - 1) {
      // acc[4i + 2h + e]: row lr + 8h, query 8i + 2 (lane % 4) + e
      const unsigned sb = static_cast<unsigned>(s);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float v;
        if constexpr (M == kSq8) {
          const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          const float t1 = __fadd_rn(__fmul_rn(acc[i], (i & 2) ? sc_hi : sc_lo),
                                     __fmul_rn(s_qsum[col], (i & 2) ? mn_hi : mn_lo));
          v = __fsub_rn(t1, (i & 2) ? cc_hi : cc_lo);
        } else {
          v = __fsub_rn(acc[i], (i & 2) ? cc_hi : cc_lo);
        }
        if (v > mx[i]) {
          mx[i] = v;
          mi[i / 4] = __byte_perm(mi[i / 4], sb, put_byte_sel(i % 4));
        }
      }
      if (s + 1 < slices) {
        const long long nxt = row0 + static_cast<long long>(s + 1) * kLanes + lr;
        cc_lo = __ldg(o.cc + nxt);
        cc_hi = __ldg(o.cc + nxt + 8);
        if constexpr (M == kSq8) {
          sc_lo = __ldg(o.scale + nxt);
          sc_hi = __ldg(o.scale + nxt + 8);
          mn_lo = __ldg(o.minv + nxt);
          mn_hi = __ldg(o.minv + nxt + 8);
        }
      }
    }
    if constexpr (kStaged) {
      fence_async_smem();  // step t + 1's operands, visible to the tensor cores
      __syncthreads();     // every warpgroup is done with buffer t % 2
    }
  }
  if constexpr (!kStaged) cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
    const int lane_row = lr + ((i & 2) ? 8 : 0);
    if (q0 + col < b_pad) {
      const long long off = static_cast<long long>(q0 + col) * n_buckets + c * kLanes + lane_row;
      const int slice = static_cast<int>((mi[i / 4] >> (8 * (i % 4))) & 0xFFu);
      o.gm[off] = mx[i];
      o.gi[off] = static_cast<int32_t>(row0 + slice * kLanes + lane_row);
    }
  }
}

template <int M>
size_t smem_bytes(int nq, int s, int d_pad) {
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  return 1024 + static_cast<size_t>(q_parts(M)) * kb_count * nq * 128 +
         static_cast<size_t>(s) * stage_bytes(M) + extra_bytes(M, nq);
}

template <typename T, int NQ, int S, int M>
cudaError_t launch(const Operands& o, int b_pad, long long n, int d_pad, int w, int chunk,
                   cudaStream_t stream) {
  const int n_qtiles = (b_pad + NQ - 1) / NQ;
  const long long n_chunks = n / chunk;
  const long long blocks = n_chunks * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes<M>(NQ, S, d_pad);
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
    const cudaError_t e = cudaFuncSetAttribute(dense_tc_kernel<T, NQ, S, M>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    allowed[dev] = smem;
  }
  dense_tc_kernel<T, NQ, S, M><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      o, b_pad, d_pad, w, chunk, n_qtiles, n_chunks * kLanes);
  return cudaGetLastError();
}

// The ring takes as many stages as fit beside the query tile, up to 8 (16 KB
// each, split 32 KB); the staged modes take their two operand buffers.
template <typename T, int NQ, int M>
cudaError_t launch_stages(const Operands& o, int b_pad, long long n, int d_pad, int w, int chunk,
                          cudaStream_t stream) {
  if constexpr (staged(M)) {
    return launch<T, NQ, 2, M>(o, b_pad, n, d_pad, w, chunk, stream);
  } else {
    const long long free_bytes = kSmemLimit - static_cast<long long>(smem_bytes<M>(NQ, 0, d_pad));
    const long long s = free_bytes / stage_bytes(M);
    if (s >= 8) return launch<T, NQ, 8, M>(o, b_pad, n, d_pad, w, chunk, stream);
    if (s >= 4) return launch<T, NQ, 4, M>(o, b_pad, n, d_pad, w, chunk, stream);
    return launch<T, NQ, 2, M>(o, b_pad, n, d_pad, w, chunk, stream);
  }
}

// The query tile: the smallest of 8 .. 128 that holds the batch, then the
// largest whose parts and two stages fit the shared memory.
template <typename T, int M>
cudaError_t launch_typed(const Operands& o, int b_pad, long long n, int d_pad, int w, int chunk,
                         cudaStream_t stream) {
  int nq = b_pad <= 8 ? 8 : b_pad <= 16 ? 16 : b_pad <= 32 ? 32 : b_pad <= 64 ? 64 : 128;
  while (nq > 8 && smem_bytes<M>(nq, 2, d_pad) > kSmemLimit) nq /= 2;
  switch (nq) {
    case 8: return launch_stages<T, 8, M>(o, b_pad, n, d_pad, w, chunk, stream);
    case 16: return launch_stages<T, 16, M>(o, b_pad, n, d_pad, w, chunk, stream);
    case 32: return launch_stages<T, 32, M>(o, b_pad, n, d_pad, w, chunk, stream);
    case 64: return launch_stages<T, 64, M>(o, b_pad, n, d_pad, w, chunk, stream);
    default: return launch_stages<T, 128, M>(o, b_pad, n, d_pad, w, chunk, stream);
  }
}

bool bad_shape(int b_pad, long long n, int d_pad, int chunk, int max_dpad) {
  return b_pad <= 0 || b_pad % 8 != 0 || n <= 0 || d_pad <= 0 || d_pad % 8 != 0 ||
         d_pad > max_dpad || chunk <= 0 || chunk % kLanes != 0 || chunk > 8192 ||
         n % chunk != 0 || n > INT_MAX;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on ``stream``
// without synchronizing and returns the launch's CUDA error code.

// Mode 1 (#2b). ``dtype``: 1 f16, 2 bf16 (the codes of bucket_kernel.py's
// _FLOAT_CODES).
extern "C" int dense_bucket_tc_launch(const void* q, const void* rows, const void* cc, void* gm,
                                      void* gi, int b_pad, long long n, int d_pad, int chunk,
                                      int dtype, void* stream) {
  // d_pad <= 3072: an 8-query tile (48 KB) and two stages always fit
  if (bad_shape(b_pad, n, d_pad, chunk, 3072)) return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{q, nullptr, nullptr, rows, nullptr, static_cast<const float*>(cc),
                   nullptr, nullptr, nullptr, static_cast<float*>(gm), static_cast<int32_t*>(gi)};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 1: err = launch_typed<__half, kHalf>(o, b_pad, n, d_pad, 0, chunk, s); break;
    case 2: err = launch_typed<__nv_bfloat16, kHalf>(o, b_pad, n, d_pad, 0, chunk, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Mode 2 (#3), bf16 halves: the bucket winners of qhi.hi + qhi.lo + qlo.hi -
// cc.
extern "C" int hl_bucket_launch(const void* qhi, const void* qlo, const void* hi, const void* lo,
                                const void* cc, void* gm, void* gi, int b_pad, long long n,
                                int d_pad, int chunk, void* stream) {
  // d_pad <= 1536: two 8-query halves (48 KB) and two 32 KB stages always fit
  if (bad_shape(b_pad, n, d_pad, chunk, 1536)) return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{qhi, qlo, nullptr, hi, lo, static_cast<const float*>(cc), nullptr, nullptr,
                   nullptr, static_cast<float*>(gm), static_cast<int32_t*>(gi)};
  return static_cast<int>(launch_typed<__nv_bfloat16, kSplit>(
      o, b_pad, n, d_pad, 0, chunk, static_cast<cudaStream_t>(stream)));
}

// Mode 3 (#2 on f32 rows): bf16 query halves, f32 rows split in the kernel.
extern "C" int dense_bucket_f32_launch(const void* qhi, const void* qlo, const void* rows,
                                       const void* cc, void* gm, void* gi, int b_pad, long long n,
                                       int d_pad, int chunk, void* stream) {
  // d_pad <= 3072: two 8-query halves (96 KB) and two 32 KB buffers always fit
  if (bad_shape(b_pad, n, d_pad, chunk, 3072)) return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{qhi, qlo, nullptr, rows, nullptr, static_cast<const float*>(cc), nullptr,
                   nullptr, nullptr, static_cast<float*>(gm), static_cast<int32_t*>(gi)};
  return static_cast<int>(launch_typed<__nv_bfloat16, kF32>(
      o, b_pad, n, d_pad, 0, chunk, static_cast<cudaStream_t>(stream)));
}

// Mode 4 (#6): three bf16 query parts of width ``d_pad`` (4 ``w`` rounded up
// to a multiple of 8), ``w`` int32 words a row.
extern "C" int sq8_bucket_tc_launch(const void* qhi, const void* qmid, const void* qlo,
                                    const void* words, const void* scale, const void* minv,
                                    const void* pen, const void* qsum, void* gm, void* gi,
                                    int b_pad, long long n, int d_pad, int w, int chunk,
                                    void* stream) {
  // d_pad <= 3072: three 8-query parts (144 KB) and two 16 KB buffers always fit
  if (bad_shape(b_pad, n, d_pad, chunk, 3072) || w <= 0 || d_pad != (4 * w + 7) / 8 * 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operands o{qhi, qmid, qlo, words, nullptr, static_cast<const float*>(pen),
                   static_cast<const float*>(scale), static_cast<const float*>(minv),
                   static_cast<const float*>(qsum), static_cast<float*>(gm),
                   static_cast<int32_t*>(gi)};
  return static_cast<int>(launch_typed<__nv_bfloat16, kSq8>(
      o, b_pad, n, d_pad, w, chunk, static_cast<cudaStream_t>(stream)));
}

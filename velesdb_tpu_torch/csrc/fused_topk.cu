// fused_topk.cu — fused distance + top-k for Hopper, scored on the tensor
// cores, in two passes.
//
// Replaces velesdb_tpu/ops/pallas_kernels.py::_fused_kernel (the Pallas
// kernel launched by _fused_topk_padded / fused_topk). The contract:
//
//   inputs   qhi, qlo  bf16 [B, D_pad]  the f32 queries (cosine: normalized)
//                                       split by the wrapper: qhi = bf16(q),
//                                       qlo = bf16(q - qhi)
//            rows   T    [N, D_pad]     corpus rows, T = f32, f16 or bf16
//            valid  bool [N]
//            aux    f32  [N]            cosine: 1/|c| (0 for |c|^2 <= 1e-30);
//                                       euclidean: |c|^2; dot: unused
//            qq     f32  [B]            |q|^2 (euclidean)
//   output   vals   f32   [B, k]        the k best scores, best first, in the
//                                       maximize orientation (euclidean: -d^2),
//                                       -inf where fewer than k rows are valid
//            idx    int64 [B, k]        their rows, -1 for empties
//   scratch  cand   int64 [B, ceil(N / 1024), k]   pass-one candidates
//   dot[b, r] = sum over d of qhi*hi + qhi*lo + qlo*hi, each row split as it
//               enters shared memory, hi = bf16(x), lo = bf16(x - hi)
//               (f16 rows split exactly; bf16 rows have lo = 0), summed in
//               fp32 in the tensor cores' order
//   score     = dot (dot); dot * aux[r] (cosine);
//               -max((qq[b] + aux[r]) - 2 dot, 0) (euclidean); -inf invalid
//   Equal scores go to the smallest row, the first-occurrence rule of the
//   reference's _merge_topk (:98-101).
// It is held to fused_topk_ref (the fixed-order fp32 dot of the unsplit
// values) within fused_topk_tolerance: the split drops the ~2^-16-relative
// terms qlo*lo and x - hi - lo, and the sums leave the fixed order.
//
// The TPU kernel walks the corpus in order on one core and carries a running
// top-k between grid steps. Hopper blocks run in no order and carry nothing,
// so this is two kernels. Every score becomes one int64 key, the score's
// order-preserving bits above the reversed row (as _final_select keys its
// bucket winners), so keys are unique and the best k keys are the answer:
//   pass one: one block per (query tile of NQ, range of 1,024 rows) keeps
//     each query's k best keys of the range and writes them;
//   pass two: one block per query radix-selects the k-th largest of its
//     ceil(N / 1024) * k candidates (eight 8-bit digit passes), gathers the k
//     keys at or above it, sorts them and decodes values and rows.
// k is capped at 1,024, the rows of one pass-one range.
//
// What bounds it on this card: the scoring, three bf16 products of
// 2 * B * N * D_pad operations at 989 TFLOP/s (0.119 ms at B 256, N 100,000,
// D 768), against N * D_pad * sizeof(T) bytes of rows (0.092 ms in f32).
//
// What the design does about that (pass one):
// - 256 threads, two warpgroups; the range is walked in tiles of 128 rows,
//   warpgroup w scoring rows 64w .. 64w + 63 of a tile (wgmma's M = 64)
//   against the NQ queries (N = NQ) with wgmma.m64nNk16 bf16 -> fp32;
// - both operands stream by 64-dim K block (two split queries of D 768 take
//   3 KB, so no tile of them stays resident): the query halves, split once
//   by the wrapper, by cp.async into two buffers in the 128-byte-swizzled
//   layout wgmma reads; the rows by 16-byte loads into registers two K
//   blocks ahead (wgmma.cuh's register staging, shared with the f32 and SQ8
//   modes of dense_bucket_tc.cu);
// - each thread splits its rows of the next K block into (hi, lo) bf16 in
//   the other of two swizzled operand buffers while the tensor cores run
//   this one's three products, hi.qhi, lo.qhi and hi.qlo, into one set of
//   accumulators (bf16 rows: two), so the split costs no tensor-core time;
// - query tiles of one range are numbered together, so the range comes from
//   device memory once and from L2 after;
// - selection without a sort: the tile's scores (metric applied) go to
//   shared memory, and each warp keeps a pool of keys per query, appending
//   only keys above the query's running threshold (the k-th best key kept so
//   far); when the pool cannot take another tile, the warp radix-selects its
//   k-th largest key (the digit histogram of pass two, per warp), keeps the k
//   keys at or above it and raises the threshold to it. After the first
//   tiles few keys pass. NQ is 64 up to k 32, then 32, 16, 8 as the pools
//   (k + 128 keys a query at least) need the shared memory.
//
// What it leaves on the table (measured on an H100, PERF.md): at B 256,
// N 100,000, D 768 pass one is bound by its loads, not its products: each
// range's rows are read once per query tile and each K block of the query
// halves once per 128-row tile (~1.8 GB through L2 at k 10), and pass one
// with neither its products nor its select takes about half its time. A
// larger query tile (the pools in device memory) or rows shared across a
// range's query tiles would cut that traffic.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;     // rows a tile: 64 per warpgroup
constexpr int kRows = 1024;    // rows per pass-one range, and the k cap
constexpr int kKBlock = 64;    // dims of a stage: one 128-byte swizzle row of bf16
constexpr int kOpBytes = kTile * 128;  // one bf16 operand tile [128 rows][64 dims]
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned long long kFlip = 0x8000000000000000ull;  // signed -> unsigned order

__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// (score bits, order-preserving) << 32 | (2^32 - 1 - row); -0.0 keys as +0.0
__device__ __forceinline__ long long make_key(float s, long long row) {
  const int bits = __float_as_int(__fadd_rn(s, 0.0f));
  const int hi = bits >= 0 ? bits : (bits ^ 0x7FFFFFFF);
  const unsigned long long u = (static_cast<unsigned long long>(static_cast<unsigned>(hi)) << 32) |
                               (0xFFFFFFFFull - static_cast<unsigned long long>(row));
  return static_cast<long long>(u);
}

// Bitonic sort, descending, of ``count`` arrays of ``len`` (a power of two)
// keys laid out one after another; every thread of the block takes part.
__device__ void bitonic_desc(long long* keys, int count, int len) {
  const int half = len / 2;
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < count * half; t += blockDim.x) {
        long long* kq = keys + (t / half) * len;
        const int p = t % half;
        const int lo = 2 * stride * (p / stride) + (p % stride);
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const long long x = kq[lo], y = kq[hi];
        if ((x < y) == desc) {
          kq[lo] = y;
          kq[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// One warp cuts the pool ``p`` of ``c`` unique keys to its ``k`` largest, in
// place, and returns the k-th largest: a radix select, 8 bits at a time from
// the top, on the warp's own 256-bin histogram. It stops at the first digit
// whose bin holds exactly the keys still needed: the k-th largest is then
// the least key under that prefix (most cuts end after two or three digits).
__device__ long long warp_cut(long long* p, int c, int k, int* hist, int lane) {
  unsigned long long prefix = 0, mask = 0;
  int need = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = lane; i < 256; i += 32) hist[i] = 0;
    __syncwarp();
    for (int i = lane; i < c; i += 32) {
      const unsigned long long u = static_cast<unsigned long long>(p[i]) ^ kFlip;
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 0xFF], 1);
    }
    __syncwarp();
    // lane l holds digits 255 - 8l down to 248 - 8l; an inclusive scan over
    // the lanes counts the keys at or above each lane's lowest digit
    int local[8], sum = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      local[t] = hist[255 - 8 * lane - t];
      sum += local[t];
    }
    int inc = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, inc, off);
      if (lane >= off) inc += y;
    }
    const int src = __ffs(__ballot_sync(0xFFFFFFFFu, inc >= need)) - 1;
    int digit = 0, rest = 0, bin = 0;
    if (lane == src) {
      int cum = inc - sum;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (cum + local[t] >= need) {
          digit = 255 - 8 * lane - t;
          rest = need - cum;
          bin = local[t];
          break;
        }
        cum += local[t];
      }
    }
    digit = __shfl_sync(0xFFFFFFFFu, digit, src);
    need = __shfl_sync(0xFFFFFFFFu, rest, src);
    bin = __shfl_sync(0xFFFFFFFFu, bin, src);
    prefix |= static_cast<unsigned long long>(digit) << shift;
    mask |= 0xFFull << shift;
    __syncwarp();
    if (bin == need) break;  // warp-uniform; at the last digit the bin is one key
  }
  unsigned long long least = ~0ull;
  for (int i = lane; i < c; i += 32) {
    const unsigned long long u = static_cast<unsigned long long>(p[i]) ^ kFlip;
    if ((u & mask) == prefix && u < least) least = u;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, least, off);
    least = o < least ? o : least;
  }
  const long long kth = static_cast<long long>(least ^ kFlip);
  // keys are unique, so exactly k are at or above the k-th largest; the
  // writes of a 32-key group land at or below the group, after its reads
  int out = 0;
  for (int base = 0; base < c; base += 32) {
    const int i = base + lane;
    const long long key = i < c ? p[i] : LLONG_MIN;
    const bool keep = i < c && key >= kth;
    const unsigned ball = __ballot_sync(0xFFFFFFFFu, keep);
    __syncwarp();
    if (keep) p[out + __popc(ball & ((1u << lane) - 1u))] = key;
    out += __popc(ball);
    __syncwarp();
  }
  return kth;
}

// Shared memory of pass one, in bytes from the 1024-aligned base: two
// buffers of a K block of both query halves (cp.async), two of the rows'
// hi and lo tiles (split from registers), the [NQ][128] f32 score tile, the
// warps' histograms, per-query threshold / count / |q|^2, the key pools.
__host__ __device__ constexpr int q_bytes(int nq) { return 2 * nq * 128; }
__host__ __device__ constexpr int fixed_bytes(int nq) {
  return 1024 + 2 * q_bytes(nq) + 4 * kOpBytes + nq * kTile * 4 + kWarps * 256 * 4 + nq * 16;
}
// Keys a query's pool holds: what the shared memory leaves, in warp groups.
__host__ __device__ constexpr int pool_keys(int nq) {
  return (kSmemLimit - fixed_bytes(nq)) / (nq * 8) / 32 * 32;
}

template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
fused_pass1(const __nv_bfloat16* __restrict__ qhi, const __nv_bfloat16* __restrict__ qlo,
            const T* __restrict__ rows, const uint8_t* __restrict__ valid,
            const float* __restrict__ aux, const float* __restrict__ qq,
            long long* __restrict__ cand, int b, long long n, int d_pad, int k, int metric,
            int n_qtiles, int n_blk, int pool) {
  constexpr bool kBf16Rows = std::is_same<T, __nv_bfloat16>::value;  // lo = 0
  constexpr int R = NQ / 2;  // accumulators per thread: two rows x NQ/4 queries
  constexpr int kVals = 16 / static_cast<int>(sizeof(T));  // values a 16-byte load
  constexpr int kGroups = kKBlock / kVals;                   // loads a row of a K block
  constexpr int kLoads = kTile * kGroups / kThreads;         // loads a thread a step
  constexpr int kQBytes = q_bytes(NQ);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024u - (raw_addr & 1023u)) & 1023u);
  unsigned char* qbuf = smem;                    // 2 x [qhi tile, qlo tile]
  unsigned char* ops = smem + 2 * kQBytes;       // 2 x [hi tile, lo tile]
  float* sc = reinterpret_cast<float*>(ops + 4 * kOpBytes);  // [NQ][kTile]
  int* hist = reinterpret_cast<int*>(sc + NQ * kTile);
  long long* thr = reinterpret_cast<long long*>(hist + kWarps * 256);
  int* cnt = reinterpret_cast<int*>(thr + NQ);
  float* s_qq = reinterpret_cast<float*>(cnt + NQ);
  long long* pools = reinterpret_cast<long long*>(s_qq + NQ);
  const uint32_t q_addr = static_cast<uint32_t>(__cvta_generic_to_shared(qbuf));
  const uint32_t ops_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ops));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int gwarp = tid / 32;
  const int lane = tid % 32;
  const int tile = blockIdx.x % n_qtiles;
  const long long blk = blockIdx.x / n_qtiles;
  const int q0 = tile * NQ;
  const long long range0 = blk * kRows;
  const int kb_count = (d_pad + kKBlock - 1) / kKBlock;
  const int steps = (kRows / kTile) * kb_count;

  for (int j = tid; j < NQ; j += kThreads) {
    thr[j] = LLONG_MIN;
    cnt[j] = 0;
    s_qq[j] = q0 + j < b ? qq[q0 + j] : 0.0f;
  }

  // Step t is K block kb = t % kb_count of tile t / kb_count. Its rows come
  // into registers two steps ahead (16-byte loads, a warp on whole rows,
  // zero past N and D_pad) and are split into the operand buffer t % 2 one
  // step ahead, while the tensor cores run the step before; its query
  // halves are copied with cp.async into query buffer t % 2, swizzled as
  // wgmma's B (zero past B and D_pad).
  uint4 pre[kLoads];
  const long long row_stride = static_cast<long long>(d_pad) * sizeof(T);
  auto load_rows = [&](int t) {
    const int tt = t / kb_count;
    const int kb = t - tt * kb_count;
    const long long row0 = range0 + static_cast<long long>(tt) * kTile;
    const long long left = n - row0;
    stage_load<kGroups, kLoads, kThreads>(
        pre, reinterpret_cast<const unsigned char*>(rows) + row0 * row_stride, row_stride,
        static_cast<int>(left < kTile ? left : kTile), kb * kKBlock * static_cast<int>(sizeof(T)),
        static_cast<int>(row_stride), true, tid);
  };
  auto split_rows = [&](int buf) {
    unsigned char* hi = ops + buf * 2 * kOpBytes;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int x = tid + j * kThreads;
      const int r = x / kGroups;
      const int g = x % kGroups;
      if constexpr (sizeof(T) == 4) {  // f32: half a 16-byte chunk of bf16
        store_split_f32(hi, hi + kOpBytes, r, g, pre[j]);
      } else {
        const T* h = reinterpret_cast<const T*>(&pre[j]);
        float f[kVals];
#pragma unroll
        for (int v = 0; v < kVals; ++v) f[v] = to_f32(h[v]);
        uint32_t hw[kVals / 2], lw[kVals / 2];
        split_bf16<kVals>(f, hw, lw);
        const uint32_t o = swz(r, g);
        *reinterpret_cast<uint4*>(hi + o) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
        if constexpr (!kBf16Rows) {
          *reinterpret_cast<uint4*>(hi + kOpBytes + o) = make_uint4(lw[0], lw[1], lw[2], lw[3]);
        }
      }
    }
  };
  auto load_q = [&](int t) {
    const int kb = t % kb_count;
    const uint32_t dst = q_addr + static_cast<uint32_t>((t % 2) * kQBytes);
    for (int x = tid; x < 2 * NQ * 8; x += kThreads) {
      const int h = x / (NQ * 8);
      const int r = (x / 8) % NQ;
      const int ch = x % 8;
      const int col = kb * kKBlock + ch * 8;
      const bool ok = q0 + r < b && col < d_pad;
      cp_async16(dst + static_cast<uint32_t>(h * NQ * 128) + swz(r, ch),
                 ok ? static_cast<const void*>((h ? qlo : qhi) +
                                               static_cast<long long>(q0 + r) * d_pad + col)
                    : static_cast<const void*>(qhi),
                 ok ? 16 : 0);
    }
  };

  load_rows(0);
  load_q(0);
  cp_async_commit();
  split_rows(0);
  if (steps > 1) {
    load_rows(1);
    load_q(1);
  }
  cp_async_commit();
  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  const int lr = 64 * wg + 16 * warp + lane / 4;  // this thread's rows lr, lr + 8 of a tile
  const float neg_inf = -__int_as_float(0x7f800000);
  int* my_hist = hist + gwarp * 256;

  for (int t = 0; t < steps; ++t) {
    const int tt = t / kb_count;
    const int kb = t - tt * kb_count;
    const int buf = t & 1;

    // step t's three products, issued without waiting
    const int k16 = (min(kKBlock, d_pad - kb * kKBlock) + 15) / 16;  // K steps, zero-padded
    const uint32_t a0 = ops_addr + static_cast<uint32_t>(buf * 2 * kOpBytes + wg * 64 * 128);
    const uint32_t b0 = q_addr + static_cast<uint32_t>(buf * kQBytes);
    fence_regs<R>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kKBlock / 16; ++kk) {
      if (kk < k16) {
        wgmma<NQ, true>(acc, smem_desc(a0 + 32 * kk), smem_desc(b0 + 32 * kk),
                        (kb > 0 || kk > 0) ? 1 : 0);
        if constexpr (!kBf16Rows) {
          wgmma<NQ, true>(acc, smem_desc(a0 + kOpBytes + 32 * kk), smem_desc(b0 + 32 * kk), 1);
        }
        wgmma<NQ, true>(acc, smem_desc(a0 + 32 * kk), smem_desc(b0 + NQ * 128 + 32 * kk), 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // meanwhile: split step t + 1's rows into the other buffer (the products
    // of step t - 1 read it, and every warpgroup waited for them), then load
    // step t + 2's
    if (t + 1 < steps) split_rows(buf ^ 1);
    if (t + 2 < steps) load_rows(t + 2);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs<R>(acc);

    if (kb == kb_count - 1) {
      // the tile's scores, metric applied, into the score tile
      const long long row0 = range0 + static_cast<long long>(tt) * kTile;
      bool ok[2];
      float ax[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row0 + lr + 8 * h;
        ok[h] = r < n && valid[r] != 0;
        ax[h] = r < n ? __ldg(aux + r) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        // acc[4i' + 2h + e]: row lr + 8h, query 8i' + 2 (lane % 4) + e
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const int h = (i & 2) ? 1 : 0;
        float s;
        if (metric == 0) {
          s = acc[i];
        } else if (metric == 1) {
          s = __fmul_rn(acc[i], ax[h]);
        } else {
          const float d2 = __fsub_rn(__fadd_rn(s_qq[col], ax[h]), __fmul_rn(2.0f, acc[i]));
          s = -fmaxf(d2, 0.0f);
        }
        sc[col * kTile + lr + 8 * h] = ok[h] ? s : neg_inf;
      }
      __syncthreads();
      // each warp appends its queries' keys above their thresholds
      for (int j = gwarp; j < NQ; j += kWarps) {
        long long* pj = pools + static_cast<long long>(j) * pool;
        if (cnt[j] + kTile > pool) {  // warp-uniform
          const long long kth = warp_cut(pj, cnt[j], k, my_hist, lane);
          __syncwarp();
          if (lane == 0) {
            thr[j] = kth;
            cnt[j] = k;
          }
          __syncwarp();
        }
        const long long tj = thr[j];
        int c = cnt[j];
#pragma unroll
        for (int u = 0; u < kTile / 32; ++u) {
          const int rr = lane + 32 * u;
          const long long key = make_key(sc[j * kTile + rr], row0 + rr);
          const bool pass = key > tj;
          const unsigned ball = __ballot_sync(0xFFFFFFFFu, pass);
          if (pass) pj[c + __popc(ball & ((1u << lane) - 1u))] = key;
          c += __popc(ball);
        }
        __syncwarp();
        if (lane == 0) cnt[j] = c;
        __syncwarp();
      }
    }
    cp_async_wait<0>();  // step t + 1's query halves
    fence_async_smem();  // and its split rows, visible to the tensor cores
    __syncthreads();     // every warpgroup is done with buffer t % 2 and the score tile
    if (t + 2 < steps) load_q(t + 2);
    cp_async_commit();
  }

  // each query's k best keys of the range (every range holds 1,024 keys, so
  // a pool never holds fewer than k)
  for (int j = gwarp; j < NQ; j += kWarps) {
    long long* pj = pools + static_cast<long long>(j) * pool;
    if (cnt[j] > k) warp_cut(pj, cnt[j], k, my_hist, lane);
    __syncwarp();
    if (q0 + j < b) {
      long long* out = cand + (static_cast<long long>(q0 + j) * n_blk + blk) * k;
      for (int i = lane; i < k; i += 32) out[i] = pj[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_pass2(const long long* __restrict__ cand, float* __restrict__ vals,
            int64_t* __restrict__ idx, long long m, int k, int k_pow2) {
  __shared__ int hist[256];
  __shared__ unsigned long long s_prefix, s_mask;
  __shared__ int s_need, s_count;
  __shared__ long long sel[kRows];
  const int tid = threadIdx.x;
  const long long* c = cand + static_cast<long long>(blockIdx.x) * m;
  if (tid == 0) {
    s_prefix = 0;
    s_mask = 0;
    s_need = k;
    s_count = 0;
  }
  // radix select of the k-th largest key, 8 bits at a time from the top
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    const unsigned long long prefix = s_prefix, mask = s_mask;
    for (long long i = tid; i < m; i += kThreads) {
      const unsigned long long u = static_cast<unsigned long long>(c[i]) ^ kFlip;
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 0xFF], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int need = s_need, cum = 0, digit = 255;
      while (cum + hist[digit] < need) cum += hist[digit--];
      s_need = need - cum;
      s_prefix = prefix | (static_cast<unsigned long long>(digit) << shift);
      s_mask = mask | (0xFFull << shift);
    }
    __syncthreads();
  }
  // keys are unique, so exactly k are at or above the k-th largest
  const unsigned long long kth = s_prefix;
  for (long long i = tid; i < m; i += kThreads) {
    const long long key = c[i];
    if ((static_cast<unsigned long long>(key) ^ kFlip) >= kth) {
      const int p = atomicAdd(&s_count, 1);
      if (p < k) sel[p] = key;
    }
  }
  for (int i = k + tid; i < k_pow2; i += kThreads) sel[i] = LLONG_MIN;
  __syncthreads();
  bitonic_desc(sel, 1, k_pow2);
  for (int j = tid; j < k; j += kThreads) {
    const long long key = sel[j];
    const int hi = static_cast<int>(key >> 32);
    const float s = __int_as_float(hi >= 0 ? hi : (hi ^ 0x7FFFFFFF));
    const long long row = 0xFFFFFFFFll - (key & 0xFFFFFFFFll);
    const bool empty = s == -__int_as_float(0x7f800000);
    const long long o = static_cast<long long>(blockIdx.x) * k + j;
    vals[o] = s;
    idx[o] = empty ? -1 : row;
  }
}

struct Args {
  const __nv_bfloat16* qhi;
  const __nv_bfloat16* qlo;
  const void* rows;
  const uint8_t* valid;
  const float* aux;
  const float* qq;
  long long* cand;
  int b;
  long long n;
  int d_pad, k, metric;
};

template <typename T, int NQ>
cudaError_t launch_pass1(const Args& a, cudaStream_t stream) {
  const int n_qtiles = (a.b + NQ - 1) / NQ;
  const long long n_blk = (a.n + kRows - 1) / kRows;
  const long long blocks = n_blk * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int pool = pool_keys(NQ);
  if (pool < a.k + kTile) return cudaErrorInvalidValue;
  const int smem = fixed_bytes(NQ) + NQ * pool * 8;
  // raised once per device, not on every launch (a driver call)
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return cudaErrorInvalidDevice;
  }
  if (!allowed[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_pass1<T, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed[dev] = true;
  }
  fused_pass1<T, NQ><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      a.qhi, a.qlo, static_cast<const T*>(a.rows), a.valid, a.aux, a.qq, a.cand, a.b, a.n,
      a.d_pad, a.k, a.metric, n_qtiles, static_cast<int>(n_blk), pool);
  return cudaGetLastError();
}

// The query tile: the smallest of 8 .. 64 that holds the batch, halved
// until a query's pool takes k keys and one more tile.
template <typename T>
cudaError_t launch(const Args& a, float* vals, int64_t* idx, cudaStream_t stream) {
  int nq = a.b <= 8 ? 8 : a.b <= 16 ? 16 : a.b <= 32 ? 32 : 64;
  while (nq > 8 && pool_keys(nq) < a.k + kTile) nq /= 2;
  cudaError_t e;
  switch (nq) {
    case 8: e = launch_pass1<T, 8>(a, stream); break;
    case 16: e = launch_pass1<T, 16>(a, stream); break;
    case 32: e = launch_pass1<T, 32>(a, stream); break;
    default: e = launch_pass1<T, 64>(a, stream);
  }
  if (e != cudaSuccess) return e;
  const long long n_blk = (a.n + kRows - 1) / kRows;
  int k_pow2 = 1;
  while (k_pow2 < a.k) k_pow2 <<= 1;
  fused_pass2<<<static_cast<unsigned>(a.b), kThreads, 0, stream>>>(a.cand, vals, idx,
                                                                   n_blk * a.k, a.k, k_pow2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. ``dtype``: 0 f32, 1 f16, 2 bf16
// (the rows); ``metric``: 0 dot, 1 cosine, 2 euclidean. Launches both passes
// on ``stream`` without synchronizing and returns the first CUDA error code.
extern "C" int fused_topk_launch(const void* qhi, const void* qlo, const void* rows,
                                 const void* valid, const void* aux, const void* qq, void* vals,
                                 void* idx, void* cand, int b, long long n, int d_pad, int k,
                                 int dtype, int metric, void* stream) {
  if (b <= 0 || n <= 0 || n > INT_MAX - kRows || d_pad <= 0 || d_pad % 8 != 0 ||
      d_pad > 4096 || k <= 0 || k > kRows || metric < 0 || metric > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const __nv_bfloat16*>(qhi), static_cast<const __nv_bfloat16*>(qlo),
               rows, static_cast<const uint8_t*>(valid), static_cast<const float*>(aux),
               static_cast<const float*>(qq), static_cast<long long*>(cand), b, n, d_pad, k,
               metric};
  auto* v = static_cast<float*>(vals);
  auto* ix = static_cast<int64_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(a, v, ix, s); break;
    case 1: err = launch<__half>(a, v, ix, s); break;
    case 2: err = launch<__nv_bfloat16>(a, v, ix, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// hamming_topk.cu — exact packed-Hamming top-k for Hopper, split across the
// card.
//
// Replaces velesdb_tpu/ops/pallas_kernels.py::_hamming_kernel (the Pallas
// kernel launched by _hamming_topk_entry / hamming_topk). Same result, bit
// for bit against the plain torch version hamming_topk_ref (a stable sort):
//
//   inputs   q        int32 [B, W]   packed query sign bits (uint32 words)
//            packed   int32 [N, W]   packed corpus sign bits
//            valid    bool  [N]      1 <= k <= N, W <= 256
//   output   dist     f32   [B, k]   the k smallest distances, ascending,
//                                    +inf where fewer than k rows are valid
//            idx      int64 [B, k]   their rows, -1 for empties; equal
//                                    distances in row order (the reference's
//                                    first-occurrence _merge_topk rule)
//   scratch  keys     int64 [B, k]   (distance << 32 | row) of the rows
//                                    below the threshold, in no order
//            ints     int32 [B * (32 W + 5 + 18 * ceil(N / chunk))]: per
//                     query its histogram of 32 W + 1 bins, a key counter,
//                     the threshold (T, lt, need), and per (query, chunk)
//                     the count of rows at T, its exclusive scan and up to
//                     16 (kSegRows) of those rows
// Both are wrapper-owned (torch.empty); the kernels allocate nothing. This
// file owns the layout: the wrapper sizes ints by hamming_topk_scratch_ints,
// and the launch refuses a shorter one. The
// scratch is 4 B (32 W + 5 + 18 ceil(N / chunk)) + 8 B k bytes: 2.7 MB at
// B 256, N 106,496, W 4, k 320, chunk 1,024. k <= N bounds the keys by the
// outputs' own size, and chunk >= 256 bounds the per-chunk part by B N / 3.5
// bytes (under the [B, N] bytes of a distance scratch), so the scratch stays
// bounded at any k up to N.
//
// The TPU kernel walks the corpus in order on one core and carries a running
// top-k between grid steps. Hopper blocks run in no order and carry nothing.
// Distances are integers in [0, 32 W], so the k-th smallest is found by
// counting: T is the smallest distance whose cumulative count of valid rows
// reaches k; every row below T is in the result (lt < k of them), then the
// first need = k - lt rows at exactly T, in row order. Five kernels on the
// stream, after one memset of the counters:
//   1. count: one block per (chunk of rows, tile of 32 queries) computes the
//      distances with __popc and builds the tile's 32 histograms in shared
//      memory, then adds their nonzero bins into the global [B, 32 W + 1];
//   2. threshold: one warp per query scans its histogram for T, lt, need;
//   3. collect: every (chunk, query tile) block recomputes its distances
//      (cheaper than a [B, N] scratch); a row below T takes a slot of the
//      query's key list through one global counter (order does not matter),
//      a row at T adds to the (query, chunk) count in shared memory and the
//      first 16 to arrive are kept, in no order;
//   4. finish: one block per query scans its per-chunk counts at T into
//      offsets, rank-sorts its lt keys into slots 0 .. lt - 1 (O(lt^2 / 256)
//      a thread, in shared memory up to 4,096 keys) and writes the +inf / -1
//      empties;
//   5. place: one warp per (query, chunk); where the chunk holds some of
//      the query's first need rows at T, the warp ranks the kept rows by row
//      number (16 or fewer: all of them were kept), or else walks the chunk
//      again in row order, 32 rows a step (a ballot ranks the rows at T),
//      and writes them to slots lt + offset + rank; the other warps leave
//      after three loads.
//
// The layout of a block: 256 threads, lane l of every warp serves query
// q0 + l of the tile, its words in registers (W = 4) or in shared memory
// word-major (conflict-free), and the block walks its chunk in tiles of 256
// rows, warp w taking rows 32 w .. 32 w + 31 of a tile. A row's words are
// one address for the whole warp (a broadcast load), and the 32 lanes'
// histogram updates go to 32 different histograms, whose 32 W + 1 bins a
// row spread them over the banks. Past W 48 the 32 histograms outgrow the
// shared memory and the count goes straight to the global histograms.
// The place pass has lanes on rows instead, one warp per (query, chunk), so
// it touches only the chunks each query needs: with a lane a query, a block
// walks its chunk in full while any of its 32 queries still needs rows at T
// there, which on an H100 cost as much as a whole pass at B 256. A walk
// reads the chunk for one query alone, so the rows at T that collect keeps
// spare most walks: on 100k-binary's data at k 320 a chunk of 1,024 rows
// holds a few rows at T, and a query needs them from tens of chunks.
//
// The chunk (ops/pallas_kernels.py, _topk_chunk) is the largest of 256 ..
// 8,192 rows that still gives 512 blocks, so a query's work spreads over
// every SM: at B 256, N 106,496 a chunk of 1,024 rows (832 blocks), at B 16
// or 1 one of 256 (416 blocks).
//
// What bounds it on this card: __popc issue, B N W popcounts a pass at 16 a
// SM a clock (0.025 ms at B 256, N 106,496, W 4), for passes 1 and 3 and the
// chunks 5 walks, plus one shared-memory atomic a (row, query) in pass 1;
// the packed corpus (4 W bytes a row) stays in the 50 MB L2. On an H100
// each of passes 1 and 3 takes 0.044-0.049 ms there (torch.profiler,
// PERF.md), about half the popcount rate; collect is held to 32 registers
// (eight blocks an SM), which took it from 0.053-0.059 ms to that.
//
// Two forks, each measured against its single path on an H100 80GB HBM3 at
// 700 W (B 256, N 106,496, W 4; tools/int8_tc_timing.py --topk, PERF.md):
// count and collect hold the query words in registers at W = 4 (0.048 and
// 0.044 ms, against 0.089 and 0.089 with the words in shared memory: four
// shared loads a row and lane beside four popcounts; place, a warp a query,
// reads its words from global memory and gained nothing from the fork), and
// finish sorts up to 4,096 keys from a shared copy (0.011 ms at k 320,
// against 0.018 with the keys read through L1).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 32;                // queries of a block, one a lane
constexpr int kTile = kThreads;        // rows of a walk step, 32 a warp
constexpr int kSharedHistMaxW = 48;    // 32 histograms of 1,537 bins: 197 KB
constexpr int kSortKeys = 4096;        // keys the finish sorts in shared memory
constexpr int kSegRows = 16;           // rows at T collect keeps per (query, chunk)
constexpr unsigned kAll = 0xffffffffu;

// A lane's query words: in registers at W = 4 (WT = 4: D 97 to 128, the
// width the 100k-binary cell runs), else read from shared memory, stored
// word-major ([W][32]: conflict-free) (WT = 0).
template <int WT>
struct Query {
  uint32_t v[WT > 0 ? WT : 1];
  const uint32_t* s;

  __device__ int dist(const uint32_t* __restrict__ row, int w, int lane) const {
    int d = 0;
    if constexpr (WT > 0) {
#pragma unroll
      for (int i = 0; i < WT; ++i) d += __popc(v[i] ^ __ldg(row + i));
    } else {
      for (int i = 0; i < w; ++i) d += __popc(s[i * 32 + lane] ^ __ldg(row + i));
    }
    return d;
  }
};

// The lane's query, zero past B. With WT = 0 the words go to ``s_qw``; the
// caller synchronizes before the first distance.
template <int WT>
__device__ Query<WT> load_query(const uint32_t* __restrict__ q, int b, int w, int q0,
                                uint32_t* s_qw) {
  Query<WT> qw;
  const int lane = threadIdx.x & 31;
  if constexpr (WT > 0) {
#pragma unroll
    for (int i = 0; i < WT; ++i) {
      qw.v[i] = q0 + lane < b ? q[static_cast<long long>(q0 + lane) * WT + i] : 0u;
    }
  } else {
    for (int t = threadIdx.x; t < 32 * w; t += kThreads) {
      const int l = t % 32;
      s_qw[t] = q0 + l < b ? q[static_cast<long long>(q0 + l) * w + t / 32] : 0u;
    }
    qw.s = s_qw;
  }
  return qw;
}

// 1. count
template <int WT>
__global__ void __launch_bounds__(kThreads)
count_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ packed,
             const uint8_t* __restrict__ valid, int* __restrict__ hist, int b, int n, int w,
             int chunk, int n_qtiles, bool shared_hist) {
  extern __shared__ int smem[];  // [32 w] query words (WT = 0), then [32][nbins]
  const int nbins = 32 * w + 1;
  int* s_hist = smem + (WT == 0 ? 32 * w : 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (blockIdx.x % n_qtiles) * kQT;
  const int c = blockIdx.x / n_qtiles;
  const int nq = min(kQT, b - q0);
  const bool active = lane < nq;
  const Query<WT> qw = load_query<WT>(q, b, w, q0, reinterpret_cast<uint32_t*>(smem));
  if (shared_hist) {
    for (int t = tid; t < nq * nbins; t += kThreads) s_hist[t] = 0;
  }
  __syncthreads();
  int* h = shared_hist ? s_hist + lane * nbins : hist + static_cast<long long>(q0 + lane) * nbins;
  const int r1 = c * chunk + min(chunk, n - c * chunk);
  for (int s0 = c * chunk + 32 * warp; s0 < r1; s0 += kTile) {
    const int len = min(32, r1 - s0);
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const int r = s0 + j;
      if (valid[r]) {
        const int d = qw.dist(packed + static_cast<long long>(r) * w, w, lane);
        if (active) atomicAdd(h + d, 1);
      }
    }
  }
  if (shared_hist) {
    __syncthreads();
    for (int t = tid; t < nq * nbins; t += kThreads) {
      const int v = s_hist[t];
      if (v) atomicAdd(hist + static_cast<long long>(q0) * nbins + t, v);
    }
  }
}

// 2. threshold: thr = [T][B], [lt][B], [need][B]; T = nbins when fewer than
// k rows are valid (all of them below T, need 0)
__global__ void __launch_bounds__(kThreads)
threshold_kernel(const int* __restrict__ hist, int* __restrict__ thr, int b, int w, int k) {
  const int lane = threadIdx.x & 31;
  const int qid = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qid >= b) return;
  const int nbins = 32 * w + 1;
  const int* h = hist + static_cast<long long>(qid) * nbins;
  int cum = 0, t_at = nbins, lt = 0;
  for (int base = 0; base < nbins; base += 32) {
    const int v = base + lane < nbins ? h[base + lane] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += x;
    }
    const unsigned hit = __ballot_sync(kAll, cum + incl >= k);
    if (hit) {
      const int t = __ffs(hit) - 1;
      t_at = base + t;
      lt = cum + __shfl_sync(kAll, incl - v, t);
      break;
    }
    cum += __shfl_sync(kAll, incl, 31);
  }
  if (t_at == nbins) lt = cum;
  if (lane == 0) {
    thr[qid] = t_at;
    thr[b + qid] = lt;
    thr[2 * b + qid] = t_at < nbins ? k - lt : 0;
  }
}

// 3. collect, held to eight blocks an SM (at most 32 registers)
template <int WT>
__global__ void __launch_bounds__(kThreads, 8)
collect_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ packed,
               const uint8_t* __restrict__ valid, const int* __restrict__ thr,
               int* __restrict__ found, long long* __restrict__ keys, int* __restrict__ seg_cnt,
               int* __restrict__ seg_rows, int b, int n, int w, int k, int chunk, int n_qtiles,
               int n_chunks) {
  extern __shared__ int smem[];  // [32 w] query words (WT = 0)
  __shared__ int s_eq[kQT];      // rows at T in this chunk, per query
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (blockIdx.x % n_qtiles) * kQT;
  const int c = blockIdx.x / n_qtiles;
  const int qid = q0 + lane;
  const bool active = qid < b;
  const long long seg = static_cast<long long>(qid) * n_chunks + c;
  const Query<WT> qw = load_query<WT>(q, b, w, q0, reinterpret_cast<uint32_t*>(smem));
  const int t_at = active ? thr[qid] : -1;  // distances are >= 0
  if (tid < kQT) s_eq[tid] = 0;
  __syncthreads();
  const int r1 = c * chunk + min(chunk, n - c * chunk);
  for (int s0 = c * chunk + 32 * warp; s0 < r1; s0 += kTile) {
    const int len = min(32, r1 - s0);
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const int r = s0 + j;
      if (valid[r]) {
        const int d = qw.dist(packed + static_cast<long long>(r) * w, w, lane);
        if (d < t_at) {
          const int p = atomicAdd(found + qid, 1);
          keys[static_cast<long long>(qid) * k + p] = (static_cast<long long>(d) << 32) | r;
        } else if (d == t_at) {
          const int p = atomicAdd(s_eq + lane, 1);
          if (p < kSegRows) seg_rows[seg * kSegRows + p] = r;
        }
      }
    }
  }
  __syncthreads();
  if (tid < kQT && q0 + tid < b) {
    seg_cnt[static_cast<long long>(q0 + tid) * n_chunks + c] = s_eq[tid];
  }
}

// 4. finish: the offsets of the rows at T, the rows below T sorted, empties
__global__ void __launch_bounds__(kThreads)
finish_kernel(const int* __restrict__ thr, const long long* __restrict__ keys,
              const int* __restrict__ seg_cnt, int* __restrict__ seg_off,
              float* __restrict__ dist, int64_t* __restrict__ idx, int b, int w, int k,
              int n_chunks) {
  __shared__ long long s_keys[kSortKeys];
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qid = blockIdx.x;
  const int nbins = 32 * w + 1;
  const int t_at = thr[qid], lt = thr[b + qid];
  const int* cnt = seg_cnt + static_cast<long long>(qid) * n_chunks;
  int* off = seg_off + static_cast<long long>(qid) * n_chunks;
  int carry = 0;
  for (int base = 0; base < n_chunks; base += kThreads) {
    const int i = base + tid;
    const int v = i < n_chunks ? cnt[i] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = carry, total = carry;
    for (int j = 0; j < kWarps; ++j) {
      if (j < warp) before += s_warp[j];
      total += s_warp[j];
    }
    if (i < n_chunks) off[i] = before + incl - v;
    carry = total;
    __syncthreads();
  }

  const long long* src = keys + static_cast<long long>(qid) * k;
  if (lt <= kSortKeys) {
    for (int i = tid; i < lt; i += kThreads) s_keys[i] = src[i];
    __syncthreads();
    src = s_keys;
  }
  float* out_d = dist + static_cast<long long>(qid) * k;
  int64_t* out_i = idx + static_cast<long long>(qid) * k;
  for (int i = tid; i < lt; i += kThreads) {
    const long long key = src[i];
    int pos = 0;
    for (int j = 0; j < lt; ++j) pos += (src[j] < key);
    out_d[pos] = static_cast<float>(key >> 32);
    out_i[pos] = key & 0xffffffffLL;
  }
  const int filled = t_at < nbins ? k : lt;
  for (int i = filled + tid; i < k; i += kThreads) {
    out_d[i] = __int_as_float(0x7f800000);  // +inf
    out_i[i] = -1;
  }
}

// 5. place: one warp per (query, chunk)
__global__ void __launch_bounds__(kThreads)
place_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ packed,
             const uint8_t* __restrict__ valid, const int* __restrict__ thr,
             const int* __restrict__ seg_cnt, const int* __restrict__ seg_off,
             const int* __restrict__ seg_rows, float* __restrict__ dist,
             int64_t* __restrict__ idx, int b, int n, int w, int k, int chunk, int n_chunks) {
  const long long pair = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pair >= static_cast<long long>(b) * n_chunks) return;
  const int qid = static_cast<int>(pair / n_chunks);
  const int c = static_cast<int>(pair % n_chunks);
  const int left = thr[2 * b + qid] - seg_off[pair];  // rows at T still to place
  const int cnt = seg_cnt[pair];
  if (left <= 0 || cnt == 0) return;
  const int take = min(left, cnt);
  const int t_at = thr[qid];
  const long long slot0 = static_cast<long long>(qid) * k + thr[b + qid] + seg_off[pair];
  const int lane = threadIdx.x & 31;
  if (cnt <= kSegRows) {  // collect kept them all, in no order: rank them
    const int r = lane < cnt ? seg_rows[pair * kSegRows + lane] : INT_MAX;
    int rank = 0;
    for (int i = 0; i < cnt; ++i) rank += __shfl_sync(kAll, r, i) < r;
    if (lane < cnt && rank < take) {
      dist[slot0 + rank] = static_cast<float>(t_at);
      idx[slot0 + rank] = r;
    }
    return;
  }
  // else walk the chunk in row order, 32 rows a step, a ballot ranking them
  const uint32_t* qrow = q + static_cast<long long>(qid) * w;
  const int r1 = c * chunk + min(chunk, n - c * chunk);
  for (int r0 = c * chunk, rank = 0; r0 < r1 && rank < take; r0 += 32) {
    const int r = r0 + lane;
    bool eq = false;
    if (r < r1 && valid[r]) {
      const uint32_t* row = packed + static_cast<long long>(r) * w;
      int d = 0;
      for (int i = 0; i < w; ++i) d += __popc(__ldg(qrow + i) ^ __ldg(row + i));
      eq = d == t_at;
    }
    const unsigned ball = __ballot_sync(kAll, eq);
    const int pos = rank + __popc(ball & ((1u << lane) - 1u));
    if (eq && pos < take) {
      dist[slot0 + pos] = static_cast<float>(t_at);
      idx[slot0 + pos] = r;
    }
    rank += __popc(ball);
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int WT>
cudaError_t run(const uint32_t* q, const uint32_t* packed, const uint8_t* valid, float* dist,
                int64_t* idx, long long* keys, int* ints, int b, int n, int w, int k, int chunk,
                cudaStream_t stream) {
  const int nbins = 32 * w + 1;
  const int n_chunks = (n + chunk - 1) / chunk;
  const int n_qtiles = (b + kQT - 1) / kQT;
  const long long blocks = static_cast<long long>(n_chunks) * n_qtiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const long long segs = static_cast<long long>(b) * n_chunks;
  int* hist = ints;                                       // [b][nbins], zeroed
  int* found = hist + static_cast<long long>(b) * nbins;  // [b], zeroed
  int* thr = found + b;                                   // [3][b]
  int* seg_cnt = thr + 3 * b;                             // [b][n_chunks]
  int* seg_off = seg_cnt + segs;                          // [b][n_chunks]
  int* seg_rows = seg_off + segs;                         // [b][n_chunks][kSegRows]
  cudaError_t e = cudaMemsetAsync(ints, 0, static_cast<size_t>(b) * (nbins + 1) * sizeof(int),
                                  stream);
  if (e != cudaSuccess) return e;

  const bool shared_hist = w <= kSharedHistMaxW;
  const size_t qbytes = WT == 0 ? 32 * sizeof(uint32_t) * w : 0;
  const size_t smem = qbytes + (shared_hist ? sizeof(int) * kQT * nbins : 0);
  if ((e = allow_smem(count_kernel<WT>, smem)) != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>(blocks);
  count_kernel<WT><<<grid, kThreads, smem, stream>>>(q, packed, valid, hist, b, n, w, chunk,
                                                     n_qtiles, shared_hist);
  threshold_kernel<<<(b + kWarps - 1) / kWarps, kThreads, 0, stream>>>(hist, thr, b, w, k);
  collect_kernel<WT><<<grid, kThreads, qbytes, stream>>>(q, packed, valid, thr, found, keys,
                                                         seg_cnt, seg_rows, b, n, w, k, chunk,
                                                         n_qtiles, n_chunks);
  finish_kernel<<<b, kThreads, 0, stream>>>(thr, keys, seg_cnt, seg_off, dist, idx, b, w, k,
                                            n_chunks);
  place_kernel<<<static_cast<unsigned>((segs + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      q, packed, valid, thr, seg_cnt, seg_off, seg_rows, dist, idx, b, n, w, k, chunk, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// The int32 scratch ``ints`` of one launch, in elements: per query the
// histogram, the key counter and the threshold, and per (query, chunk) the
// count at T, its offset and kSegRows rows (the carving in ``run``).
extern "C" long long hamming_topk_scratch_ints(int b, long long n, int w, int chunk) {
  const long long n_chunks = (n + chunk - 1) / chunk;
  return static_cast<long long>(b) * (32LL * w + 5 + (2 + kSegRows) * n_chunks);
}

// Plain C entry point, loaded with ctypes. Launches on ``stream`` without
// synchronizing and returns the first CUDA error code. ``keys`` is int64
// [b, k]; ``ints`` int32 of ``n_ints`` >= hamming_topk_scratch_ints elements;
// ``chunk`` a multiple of 256.
extern "C" int hamming_topk_launch(const void* q, const void* packed, const void* valid,
                                   void* dist, void* idx, void* keys, void* ints,
                                   long long n_ints, int b, long long n, int w, int k, int chunk,
                                   void* stream) {
  if (b <= 0 || n <= 0 || n > INT_MAX || w <= 0 || w > 256 || k <= 0 || k > n ||
      chunk <= 0 || chunk % kTile != 0 || n_ints < hamming_topk_scratch_ints(b, n, w, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qq = static_cast<const uint32_t*>(q);
  const auto* pp = static_cast<const uint32_t*>(packed);
  const auto* vv = static_cast<const uint8_t*>(valid);
  auto* dd = static_cast<float*>(dist);
  auto* ii = static_cast<int64_t*>(idx);
  auto* kk = static_cast<long long*>(keys);
  auto* sc = static_cast<int*>(ints);
  auto s = static_cast<cudaStream_t>(stream);
  const int nn = static_cast<int>(n);
  return static_cast<int>(w == 4 ? run<4>(qq, pp, vv, dd, ii, kk, sc, b, nn, w, k, chunk, s)
                                 : run<0>(qq, pp, vv, dd, ii, kk, sc, b, nn, w, k, chunk, s));
}

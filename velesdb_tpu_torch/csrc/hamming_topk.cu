// hamming_topk.cu — exact packed-Hamming top-k for Hopper.
//
// Replaces velesdb_tpu/ops/pallas_kernels.py::_hamming_kernel (the Pallas
// kernel launched by _hamming_topk_entry / hamming_topk). Same result, bit
// for bit against the plain torch version hamming_topk_ref (a stable sort):
//
//   inputs   q        int32 [B, W]   packed query sign bits (uint32 words)
//            packed   int32 [N, W]   packed corpus sign bits
//            valid    bool  [N]
//   output   dist     f32   [B, k]   the k smallest distances, ascending,
//                                    +inf where fewer than k rows are valid
//            idx      int64 [B, k]   their rows, -1 for empties; equal
//                                    distances in row order (the reference's
//                                    first-occurrence _merge_topk rule)
//   scratch  int64 [B, k]            (distance << 32 | row) keys, wrapper-owned
//
// The TPU kernel walks the corpus in order on one core and carries a running
// top-k between grid steps (k max-extraction passes per chunk). Hopper blocks
// run in no order and carry nothing, so this is a different design. Distances
// are integers in [0, 32 W]; one block per query:
//   1. builds a histogram of the valid rows' distances in shared memory;
//   2. finds the threshold T, the smallest distance whose cumulative count
//      reaches k: every row below T is in the result (fewer than k of them),
//      plus the first k - count(< T) rows at exactly T, in row order;
//   3. walks the rows again in tiles of 256 in row order: rows below T go to
//      the scratch list, rows at T get their in-order rank from a block-wide
//      ballot prefix and are written straight to their output slot; the walk
//      stops once both sets are complete;
//   4. sorts the short below-T list by (distance, row) with a rank sort
//      (O(count^2), count < k) and writes it in front.
//
// What bounds it on this card: __popc issue for the two passes, 2 B N W
// popcounts (the packed corpus, 4 W bytes a row, stays in the 50 MB L2), plus
// shared-memory atomics for the histogram. The rank sort is O(k^2) per query,
// negligible at the k this core serves (small N or large k, k << N).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int row_distance(const uint32_t* __restrict__ qs,
                                            const uint32_t* __restrict__ row, int w) {
  int d = 0;
  for (int i = 0; i < w; ++i) d += __popc(qs[i] ^ __ldg(row + i));
  return d;
}

__global__ void __launch_bounds__(kThreads)
hamming_topk_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ packed,
                    const uint8_t* __restrict__ valid, float* __restrict__ dist,
                    int64_t* __restrict__ idx, int64_t* __restrict__ scratch, long long n,
                    int w, int k) {
  extern __shared__ uint32_t smem[];  // w query words, then 32 w + 1 bins
  uint32_t* qs = smem;
  int* hist = reinterpret_cast<int*>(smem + w);
  __shared__ int s_warp[kWarps];
  __shared__ int s_t, s_lt, s_need, s_lt_found, s_eq_base, s_done;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const int nbins = 32 * w + 1;
  float* out_d = dist + b * k;
  int64_t* out_i = idx + b * k;
  int64_t* keys = scratch + b * k;

  for (int t = tid; t < w; t += kThreads) qs[t] = q[b * w + t];
  for (int t = tid; t < nbins; t += kThreads) hist[t] = 0;
  __syncthreads();

  // 1. histogram of the valid rows' distances
  for (long long r = tid; r < n; r += kThreads) {
    if (valid[r]) atomicAdd(&hist[row_distance(qs, packed + r * w, w)], 1);
  }
  __syncthreads();

  // 2. threshold: T = nbins means fewer than k valid rows, all below T
  if (tid == 0) {
    int cum = 0, t = 0;
    while (t < nbins && cum + hist[t] < k) cum += hist[t++];
    s_t = t;
    s_lt = cum;
    s_need = (t < nbins) ? k - cum : 0;
    s_lt_found = 0;
    s_eq_base = 0;
    s_done = (s_need == 0 && cum == 0);
  }
  __syncthreads();
  const int T = s_t, lt = s_lt, need = s_need;

  // 3. ordered collection
  const int lane = tid & 31, warp = tid >> 5;
  for (long long r0 = 0; r0 < n && !s_done; r0 += kThreads) {
    const long long r = r0 + tid;
    const int d = (r < n && valid[r]) ? row_distance(qs, packed + r * w, w) : INT_MAX;
    if (d < T) {
      const int p = atomicAdd(&s_lt_found, 1);
      keys[p] = (static_cast<int64_t>(d) << 32) | r;
    }
    const bool eq = (d == T);
    const unsigned ball = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    int rank = s_eq_base;
    for (int i = 0; i < warp; ++i) rank += s_warp[i];
    rank += __popc(ball & ((1u << lane) - 1u));
    if (eq && rank < need) {
      out_d[lt + rank] = static_cast<float>(T);
      out_i[lt + rank] = r;
    }
    __syncthreads();
    if (tid == 0) {
      int tot = 0;
      for (int i = 0; i < kWarps; ++i) tot += s_warp[i];
      s_eq_base += tot;
      s_done = (s_eq_base >= need && s_lt_found == lt);
    }
    __syncthreads();
  }

  // 4. rank-sort the rows below T into the front slots; empties at the back
  for (int i = tid; i < lt; i += kThreads) {
    const int64_t key = keys[i];
    int pos = 0;
    for (int j = 0; j < lt; ++j) pos += (keys[j] < key);
    out_d[pos] = static_cast<float>(key >> 32);
    out_i[pos] = key & 0xffffffffLL;
  }
  const int filled = (T < nbins) ? k : lt;
  for (int i = filled + tid; i < k; i += kThreads) {
    out_d[i] = __int_as_float(0x7f800000);  // +inf
    out_i[i] = -1;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on ``stream`` without
// synchronizing and returns the launch's CUDA error code.
extern "C" int hamming_topk_launch(const void* q, const void* packed, const void* valid,
                                   void* dist, void* idx, void* scratch, int b, long long n,
                                   int w, int k, void* stream) {
  // w <= 256: 8,193 histogram bins + the query words stay under 48 KB
  if (b <= 0 || n <= 0 || n > INT_MAX || w <= 0 || w > 256 || k <= 0 || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(w + 32 * w + 1) * sizeof(uint32_t);
  hamming_topk_kernel<<<static_cast<unsigned>(b), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(packed),
      static_cast<const uint8_t*>(valid), static_cast<float*>(dist),
      static_cast<int64_t*>(idx), static_cast<int64_t*>(scratch), n, w, k);
  return static_cast<int>(cudaGetLastError());
}

// fused_topk.cu — exact fused distance + top-k for Hopper, in two passes.
//
// Replaces velesdb_tpu/ops/pallas_kernels.py::_fused_kernel (the Pallas
// kernel launched by _fused_topk_padded / fused_topk). Same result, bit for
// bit against the plain torch version fused_topk_ref:
//
//   inputs   q      f32  [B, D_pad]   queries (cosine: normalized)
//            rows   T    [N, D_pad]   corpus rows, T = f32, f16 or bf16,
//                                     upcast to fp32 as the reference does
//            valid  bool [N]
//            aux    f32  [N]          cosine: 1/|c| (0 for |c|^2 <= 1e-30);
//                                     euclidean: |c|^2; dot: unused
//            qq     f32  [B]          |q|^2 (euclidean)
//   output   vals   f32   [B, k]      the k best scores, best first, in the
//                                     maximize orientation (euclidean: -d^2),
//                                     -inf where fewer than k rows are valid
//            idx    int64 [B, k]      their rows, -1 for empties
//   scratch  cand   int64 [B, ceil(N / 1024), k]   pass-one candidates
//   dot[b, r] = sum over d = 0 .. D_pad-1, in order, of q[b, d] * rows[r, d],
//               each product and partial sum rounded to fp32
//   score     = dot (dot); dot * aux[r] (cosine);
//               -max((qq[b] + aux[r]) - 2 dot, 0) (euclidean); -inf invalid
//   Equal scores go to the smallest row, the first-occurrence rule of the
//   reference's _merge_topk (:98-101).
//
// The TPU kernel walks the corpus in order on one core and carries a running
// top-k between grid steps. Hopper blocks run in no order and carry nothing,
// so this is two kernels. Every score becomes one int64 key, the score's
// order-preserving bits above the reversed row (as _final_select keys its
// bucket winners), so keys are unique and the best k keys are the answer:
//   pass one: one block per (query tile of 8, range of 1,024 rows) scores its
//     rows into shared-memory keys (rows past N score -inf), sorts each
//     query's 1,024 keys with a bitonic network and writes its best k;
//   pass two: one block per query radix-selects the k-th largest of its
//     ceil(N / 1024) * k candidates (eight 8-bit digit passes), gathers the k
//     keys at or above it, sorts them and decodes values and rows.
// k is capped at 1,024, the rows of one pass-one range.
//
// What bounds it on this card: the scoring, 2 * B * N * D_pad fp32
// CUDA-core operations, at 67 TFLOP/s; the corpus read (N * D_pad *
// sizeof(T)) is far below, and the selection is O(B * N * log^2 1024)
// compare-exchanges in shared memory. Query tiles of one row range are
// numbered together, so the range comes from HBM once, then from L2.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 1024;  // rows per pass-one block, and the k cap
constexpr int kQT = 8;       // queries per pass-one block

__device__ __forceinline__ float to_f32(float x) { return x; }
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_pass1(const float* __restrict__ q, const T* __restrict__ rows,
            const uint8_t* __restrict__ valid, const float* __restrict__ aux,
            const float* __restrict__ qq, long long* __restrict__ cand, int b, long long n,
            int d_pad, int k, int metric, int n_tiles, int n_blk) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ long long smem[];
  long long* keys = smem;                                    // kQT * kRows
  float* qs = reinterpret_cast<float*>(smem + kQT * kRows);  // kQT * d_pad
  __shared__ float s_qq[kQT];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x % n_tiles;
  const long long blk = blockIdx.x / n_tiles;
  const int q0 = tile * kQT;

  for (int t = tid; t < kQT * d_pad; t += kThreads) {
    const int qi = t / d_pad;
    qs[t] = (q0 + qi < b) ? q[static_cast<long long>(q0 + qi) * d_pad + (t - qi * d_pad)] : 0.0f;
  }
  if (tid < kQT) s_qq[tid] = (q0 + tid < b) ? qq[q0 + tid] : 0.0f;
  __syncthreads();

  const float neg_inf = -__int_as_float(0x7f800000);
  const int nv = d_pad / V;
  for (int i = tid; i < kRows; i += kThreads) {
    const long long r = blk * kRows + i;
    float acc[kQT];
#pragma unroll
    for (int j = 0; j < kQT; ++j) acc[j] = 0.0f;
    bool ok = false;
    float a = 0.0f;
    if (r < n) {
      ok = valid[r] != 0;
      a = __ldg(aux + r);
      const int4* rp = reinterpret_cast<const int4*>(rows + r * d_pad);
      for (int w = 0; w < nv; ++w) {
        const int4 raw = __ldg(rp + w);
        const T* x = reinterpret_cast<const T*>(&raw);
        float xf[V];
#pragma unroll
        for (int v = 0; v < V; ++v) xf[v] = to_f32(x[v]);
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          const float* qj = qs + j * d_pad + w * V;
#pragma unroll
          for (int v = 0; v < V; ++v) acc[j] = __fadd_rn(acc[j], __fmul_rn(qj[v], xf[v]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      float s;
      if (metric == 0) {
        s = acc[j];
      } else if (metric == 1) {
        s = __fmul_rn(acc[j], a);
      } else {
        const float d2 = __fsub_rn(__fadd_rn(s_qq[j], a), __fmul_rn(2.0f, acc[j]));
        s = -fmaxf(d2, 0.0f);
      }
      keys[j * kRows + i] = make_key(ok ? s : neg_inf, r);
    }
  }
  __syncthreads();
  bitonic_desc(keys, kQT, kRows);
  for (int t = tid; t < kQT * k; t += kThreads) {
    const int qi = t / k;
    if (q0 + qi < b) {
      cand[(static_cast<long long>(q0 + qi) * n_blk + blk) * k + (t - qi * k)] =
          keys[qi * kRows + (t - qi * k)];
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
  constexpr unsigned long long kFlip = 0x8000000000000000ull;  // signed -> unsigned order
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

template <typename T>
cudaError_t launch(const float* q, const void* rows, const uint8_t* valid, const float* aux,
                   const float* qq, float* vals, int64_t* idx, long long* cand, int b,
                   long long n, int d_pad, int k, int metric, cudaStream_t stream) {
  const int n_tiles = (b + kQT - 1) / kQT;
  const long long n_blk = (n + kRows - 1) / kRows;
  const long long blocks = n_blk * n_tiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(kQT) * kRows * sizeof(long long) +
                      static_cast<size_t>(kQT) * d_pad * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fused_pass1<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  fused_pass1<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, static_cast<const T*>(rows), valid, aux, qq, cand, b, n, d_pad, k, metric, n_tiles,
      static_cast<int>(n_blk));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int k_pow2 = 1;
  while (k_pow2 < k) k_pow2 <<= 1;
  fused_pass2<<<static_cast<unsigned>(b), kThreads, 0, stream>>>(cand, vals, idx, n_blk * k, k,
                                                                 k_pow2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. ``dtype``: 0 f32, 1 f16, 2 bf16;
// ``metric``: 0 dot, 1 cosine, 2 euclidean. Launches both passes on
// ``stream`` without synchronizing and returns the first CUDA error code.
extern "C" int fused_topk_launch(const void* q, const void* rows, const void* valid,
                                 const void* aux, const void* qq, void* vals, void* idx,
                                 void* cand, int b, long long n, int d_pad, int k, int dtype,
                                 int metric, void* stream) {
  // d_pad <= 4096: 64 KB of keys + 8 queries x d_pad floats (192 KB)
  if (b <= 0 || n <= 0 || n > INT_MAX - kRows || d_pad <= 0 || d_pad % 8 != 0 ||
      d_pad > 4096 || k <= 0 || k > kRows || metric < 0 || metric > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* vd = static_cast<const uint8_t*>(valid);
  const auto* ax = static_cast<const float*>(aux);
  const auto* qn = static_cast<const float*>(qq);
  auto* v = static_cast<float*>(vals);
  auto* ix = static_cast<int64_t*>(idx);
  auto* cd = static_cast<long long*>(cand);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(qf, rows, vd, ax, qn, v, ix, cd, b, n, d_pad, k, metric, s); break;
    case 1: err = launch<__half>(qf, rows, vd, ax, qn, v, ix, cd, b, n, d_pad, k, metric, s); break;
    case 2:
      err = launch<__nv_bfloat16>(qf, rows, vd, ax, qn, v, ix, cd, b, n, d_pad, k, metric, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

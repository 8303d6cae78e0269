// hl_bucket.cu — split-bf16 bucket scan for Hopper.
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_kernel_hl (the Pallas kernel
// launched by bucket_topk_hl): the FULL-storage ``split-bf16`` serve core,
// which scores f32 rows stored as a (hi, lo) bf16 pair, hi = bf16(x) and
// lo = bf16(x - hi). Same contract, bit for bit against the plain torch
// version hl_bucket_ref:
//
//   inputs   qhi, qlo  bf16 [B_pad, D_pad]  split queries (cosine: normalized;
//                                           euclidean: 2q)
//            hi, lo    bf16 [N, D_pad]      split corpus rows
//            cc        f32  [N]             additive penalty, +inf knocked out
//   output   gm  f32   [B_pad, (N / chunk) * 128]
//            gi  int32 [B_pad, (N / chunk) * 128]
//   a[b, r] = sum over d of qhi[b, d] * hi[r, d]
//   e[b, r] = sum over d of qhi[b, d] * lo[r, d], continued over d with
//             qlo[b, d] * hi[r, d]   (the reference's [qhi|qlo].[lo|hi])
//   s[b, r] = (a + e) - cc[r]
//   every sum in d order from 0, each partial sum rounded to fp32
//   (__fadd_rn); the products of two bf16 values are exact in fp32. The
//   qlo * lo term (~2^-16 relative) is dropped, as in the reference.
//   gm/gi: one (max, row) winner per 128-lane bucket of each chunk, ties to
//   the smallest slice.
//
// What bounds it on this card: 6 * B_pad * N * D_pad fp32 CUDA-core
// operations (three products and three sums per element), bound at the
// 67 TFLOP/s FMA rate; the rows are 4 bytes a dim (N * D_pad * 4 bytes), far
// below. The reference's two bf16 matmuls would run on the tensor cores
// (989 TFLOP/s dense bf16) in a later wgmma design.
//
// What the design does about that (the geometry of dense_bucket.cu): one
// block per (query tile of QT <= 16, chunk), the split query tile in shared
// memory as fp32, 128 threads one per bucket lane each owning one row per
// slice, a running (max, slice) pair per query in registers. Each row is
// read twice: the first sweep feeds a and the first half of e (hi and lo),
// the second sweep the second half of e (hi again, from L1), which keeps
// e's summation order with two accumulators per query.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int V = 8;  // bf16 values per 16-byte load

template <int QT>
__global__ void __launch_bounds__(kLanes)
hl_bucket_kernel(const __nv_bfloat16* __restrict__ qhi, const __nv_bfloat16* __restrict__ qlo,
                 const __nv_bfloat16* __restrict__ hi, const __nv_bfloat16* __restrict__ lo,
                 const float* __restrict__ cc, float* __restrict__ gm, int32_t* __restrict__ gi,
                 int b_pad, int d_pad, int chunk, int n_tiles, long long n_buckets) {
  extern __shared__ float smem[];  // QT * d_pad hi floats, then QT * d_pad lo floats
  float* sh = smem;
  float* sl = smem + QT * d_pad;
  const int lane = threadIdx.x;
  const int tile = blockIdx.x % n_tiles;
  const long long c = blockIdx.x / n_tiles;
  const int q0 = tile * QT;

  for (int t = lane; t < QT * d_pad; t += kLanes) {
    const int qq = t / d_pad;
    const bool in = q0 + qq < b_pad;
    const long long o = static_cast<long long>(q0 + qq) * d_pad + (t - qq * d_pad);
    sh[t] = in ? __bfloat162float(qhi[o]) : 0.0f;
    sl[t] = in ? __bfloat162float(qlo[o]) : 0.0f;
  }
  __syncthreads();

  float mx[QT];
  int mi[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    mx[j] = -__int_as_float(0x7f800000);  // -inf
    mi[j] = 0;
  }

  const int slices = chunk / kLanes;
  const int nv = d_pad / V;
  for (int s = 0; s < slices; ++s) {
    const long long r = c * chunk + static_cast<long long>(s) * kLanes + lane;
    float a[QT], e[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) a[j] = e[j] = 0.0f;
    const int4* hp = reinterpret_cast<const int4*>(hi + r * d_pad);
    const int4* lp = reinterpret_cast<const int4*>(lo + r * d_pad);
    for (int w = 0; w < nv; ++w) {  // a, and e's qhi . lo half
      const int4 rh = __ldg(hp + w);
      const int4 rl = __ldg(lp + w);
      const __nv_bfloat16* xh = reinterpret_cast<const __nv_bfloat16*>(&rh);
      const __nv_bfloat16* xl = reinterpret_cast<const __nv_bfloat16*>(&rl);
      float fh[V], fl[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        fh[v] = __bfloat162float(xh[v]);
        fl[v] = __bfloat162float(xl[v]);
      }
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const float* qs = sh + j * d_pad + w * V;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          a[j] = __fadd_rn(a[j], __fmul_rn(qs[v], fh[v]));
          e[j] = __fadd_rn(e[j], __fmul_rn(qs[v], fl[v]));
        }
      }
    }
    for (int w = 0; w < nv; ++w) {  // e's qlo . hi half
      const int4 rh = __ldg(hp + w);
      const __nv_bfloat16* xh = reinterpret_cast<const __nv_bfloat16*>(&rh);
      float fh[V];
#pragma unroll
      for (int v = 0; v < V; ++v) fh[v] = __bfloat162float(xh[v]);
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const float* qs = sl + j * d_pad + w * V;
#pragma unroll
        for (int v = 0; v < V; ++v) e[j] = __fadd_rn(e[j], __fmul_rn(qs[v], fh[v]));
      }
    }
    const float p = __ldg(cc + r);
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const float v = __fsub_rn(__fadd_rn(a[j], e[j]), p);
      if (v > mx[j]) {
        mx[j] = v;
        mi[j] = s;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < QT; ++j) {
    if (q0 + j < b_pad) {
      const long long o = static_cast<long long>(q0 + j) * n_buckets + c * kLanes + lane;
      gm[o] = mx[j];
      gi[o] = static_cast<int32_t>(c * chunk + mi[j] * kLanes + lane);
    }
  }
}

template <int QT>
cudaError_t launch(const __nv_bfloat16* qhi, const __nv_bfloat16* qlo, const __nv_bfloat16* hi,
                   const __nv_bfloat16* lo, const float* cc, float* gm, int32_t* gi, int b_pad,
                   long long n, int d_pad, int chunk, cudaStream_t stream) {
  const int n_tiles = (b_pad + QT - 1) / QT;
  const long long n_chunks = n / chunk;
  const long long blocks = n_chunks * n_tiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = 2 * static_cast<size_t>(QT) * d_pad * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hl_bucket_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  hl_bucket_kernel<QT><<<static_cast<unsigned>(blocks), kLanes, smem, stream>>>(
      qhi, qlo, hi, lo, cc, gm, gi, b_pad, d_pad, chunk, n_tiles, n_chunks * kLanes);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on ``stream`` without
// synchronizing and returns the launch's CUDA error code.
extern "C" int hl_bucket_launch(const void* qhi, const void* qlo, const void* hi,
                                const void* lo, const void* cc, void* gm, void* gi, int b_pad,
                                long long n, int d_pad, int chunk, void* stream) {
  // d_pad <= 1536: 2 x 16 queries x d_pad floats of shared memory (192 KB)
  if (b_pad <= 0 || b_pad % 8 != 0 || n <= 0 || d_pad <= 0 || d_pad % V != 0 ||
      d_pad > 1536 || chunk <= 0 || chunk % kLanes != 0 || chunk > 8192 || n % chunk != 0 ||
      n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qh = static_cast<const __nv_bfloat16*>(qhi);
  const auto* ql = static_cast<const __nv_bfloat16*>(qlo);
  const auto* h = static_cast<const __nv_bfloat16*>(hi);
  const auto* l = static_cast<const __nv_bfloat16*>(lo);
  const auto* p = static_cast<const float*>(cc);
  auto* m = static_cast<float*>(gm);
  auto* g = static_cast<int32_t*>(gi);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = (b_pad % 16 == 0)
      ? launch<16>(qh, ql, h, l, p, m, g, b_pad, n, d_pad, chunk, s)
      : launch<8>(qh, ql, h, l, p, m, g, b_pad, n, d_pad, chunk, s);
  return static_cast<int>(err);
}

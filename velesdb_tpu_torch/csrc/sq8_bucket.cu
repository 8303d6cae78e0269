// sq8_bucket.cu — staged SQ8 bucket scan over block-packed words for Hopper.
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_sq8_kernel (the Pallas kernel
// launched by sq8_bucket_topk, f32 unpack): the ``sq8-bucket`` serve core of
// SQ8 storage at or above _SQ8I_MAX_DIM. Same contract, bit for bit against
// the plain torch version sq8_bucket_ref:
//
//   inputs   q      f32   [B_pad, D_pad]   queries (cosine: normalized;
//                                          euclidean: 2q), D_pad = 4 W
//            words  int32 [N, W]           codes from sq8_pack_blocked: byte
//                                          j of word w holds dim j * W + w
//            scale, minv, pen  f32 [N]     per-row affine and additive
//                                          penalty (+inf knocked out)
//            qsum   f32   [B_pad]          sum(q), summed once by the wrapper
//   output   gm  f32   [B_pad, (N / chunk) * 128]
//            gi  int32 [B_pad, (N / chunk) * 128]
//   dot[b, r] = sum over dims 0 .. D_pad-1, in dim order, of q[b, d] *
//               code[r, d], each product and partial sum rounded to fp32
//   s[b, r]   = (dot * scale[r] + qsum[b] * minv[r]) - pen[r]
//   gm/gi: one (max, row) winner per 128-lane bucket of each chunk, ties to
//   the smallest slice.
//
// What bounds it on this card: 2 * B_pad * N * D_pad fp32 CUDA-core
// operations for the dot (an f32 query times a code rounds, so the sum is
// not a tensor-core int8 product), bound at 67 TFLOP/s; the packed codes are
// one byte a dim (N * D_pad bytes + 12 bytes a row), far below. The
// reference's int8 sibling (#7, sq8i_bucket.cu) is what serves by default.
//
// What the design does about that (the geometry of sq8i_bucket.cu): one
// block per (query tile of QT <= 16, chunk), the query tile and qsum in
// shared memory, 128 threads one per bucket lane each owning one row per
// slice, a running (max, slice) pair per query in registers. A thread walks
// its row's byte planes in turn (plane j is dims j*W .. j*W + W-1), so the
// dims come in order and each word is read four times, from L1 after the
// first.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 128;

template <int QT>
__global__ void __launch_bounds__(kLanes)
sq8_bucket_kernel(const float* __restrict__ q, const int32_t* __restrict__ words,
                  const float* __restrict__ scale, const float* __restrict__ minv,
                  const float* __restrict__ pen, const float* __restrict__ qsum,
                  float* __restrict__ gm, int32_t* __restrict__ gi, int b_pad, int w,
                  int chunk, int n_tiles, long long n_buckets) {
  extern __shared__ float smem_q[];  // QT * 4w floats
  __shared__ float s_qsum[QT];
  const int d_pad = 4 * w;
  const int lane = threadIdx.x;
  const int tile = blockIdx.x % n_tiles;
  const long long c = blockIdx.x / n_tiles;
  const int q0 = tile * QT;

  for (int t = lane; t < QT * d_pad; t += kLanes) {
    const int qq = t / d_pad;
    smem_q[t] = (q0 + qq < b_pad) ? q[static_cast<long long>(q0 + qq) * d_pad + (t - qq * d_pad)]
                                  : 0.0f;
  }
  if (lane < QT) s_qsum[lane] = (q0 + lane < b_pad) ? qsum[q0 + lane] : 0.0f;
  __syncthreads();

  float mx[QT];
  int mi[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    mx[j] = -__int_as_float(0x7f800000);  // -inf
    mi[j] = 0;
  }

  const int slices = chunk / kLanes;
  for (int s = 0; s < slices; ++s) {
    const long long r = c * chunk + static_cast<long long>(s) * kLanes + lane;
    float acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0.0f;
    const int32_t* rp = words + r * w;
#pragma unroll
    for (int plane = 0; plane < 4; ++plane) {
      const float* qp = smem_q + plane * w;
      for (int k = 0; k < w; ++k) {
        const float code = static_cast<float>((__ldg(rp + k) >> (8 * plane)) & 0xFF);
#pragma unroll
        for (int j = 0; j < QT; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(qp[j * d_pad + k], code));
      }
    }
    const float sc = __ldg(scale + r);
    const float mn = __ldg(minv + r);
    const float p = __ldg(pen + r);
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const float t = __fadd_rn(__fmul_rn(acc[j], sc), __fmul_rn(s_qsum[j], mn));
      const float v = __fsub_rn(t, p);
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
cudaError_t launch(const float* q, const int32_t* words, const float* scale, const float* minv,
                   const float* pen, const float* qsum, float* gm, int32_t* gi, int b_pad,
                   long long n, int w, int chunk, cudaStream_t stream) {
  const int n_tiles = (b_pad + QT - 1) / QT;
  const long long n_chunks = n / chunk;
  const long long blocks = n_chunks * n_tiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(QT) * 4 * w * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sq8_bucket_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sq8_bucket_kernel<QT><<<static_cast<unsigned>(blocks), kLanes, smem, stream>>>(
      q, words, scale, minv, pen, qsum, gm, gi, b_pad, w, chunk, n_tiles, n_chunks * kLanes);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. ``w`` is the words per row
// (D_pad / 4). Launches on ``stream`` without synchronizing and returns the
// launch's CUDA error code.
extern "C" int sq8_bucket_launch(const void* q, const void* words, const void* scale,
                                 const void* minv, const void* pen, const void* qsum, void* gm,
                                 void* gi, int b_pad, long long n, int w, int chunk,
                                 void* stream) {
  // 4 w <= 3072: 16 queries x 4 w floats of shared memory (192 KB)
  if (b_pad <= 0 || b_pad % 8 != 0 || n <= 0 || w <= 0 || 4 * w > 3072 || chunk <= 0 ||
      chunk % kLanes != 0 || chunk > 8192 || n % chunk != 0 || n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* wd = static_cast<const int32_t*>(words);
  const auto* sc = static_cast<const float*>(scale);
  const auto* mn = static_cast<const float*>(minv);
  const auto* p = static_cast<const float*>(pen);
  const auto* qs = static_cast<const float*>(qsum);
  auto* m = static_cast<float*>(gm);
  auto* g = static_cast<int32_t*>(gi);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = (b_pad % 16 == 0)
      ? launch<16>(qf, wd, sc, mn, p, qs, m, g, b_pad, n, w, chunk, s)
      : launch<8>(qf, wd, sc, mn, p, qs, m, g, b_pad, n, w, chunk, s);
  return static_cast<int>(err);
}

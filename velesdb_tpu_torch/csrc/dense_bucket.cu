// dense_bucket.cu — f32 bucket scan for Hopper.
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_kernel (the Pallas kernel
// launched by _bucket_call from bucket_topk_entry): the ``bucket-f32`` serve
// core of F16/BF16 storage below D 512, and bucket_topk's contract, on f32
// rows; f16 and bf16 rows go to the tensor cores (dense_bucket_tc.cu). Same
// contract, bit for bit against the plain torch version dense_bucket_ref:
//
//   inputs   q     f32   [B_pad, D_pad]  queries (cosine: normalized;
//                                        euclidean: 2q)
//            rows  f32   [N, D_pad]      corpus rows (cosine: pre-normalized)
//            cc    f32   [N]             additive penalty: |c|^2 (euclidean)
//                                        or 0, +inf on knocked-out rows
//   output   gm  f32   [B_pad, (N / chunk) * 128]
//            gi  int32 [B_pad, (N / chunk) * 128]
//   dot[b, r] = sum over d = 0 .. D_pad-1, in that order, of
//               q[b, d] * rows[r, d], each product and each partial sum
//               rounded to fp32 (__fmul_rn / __fadd_rn)
//   s[b, r]   = dot - cc[r]
//   gm[b, c*128 + j] = max over slices i of s[b, c*chunk + i*128 + j], gi its
//   row; ties go to the smallest slice (the reference's _bucket_select), so a
//   bucket of -inf scores returns its slice-0 row.
//
// Each product and each sum rounds once, in both versions alike: the
// explicit intrinsics keep nvcc from contracting a*b + c into an FMA, which
// PyTorch's one-op-per-kernel arithmetic never does.
//
// What bounds it on this card. It sums with fp32 CUDA-core multiplies and
// adds, 2 * B_pad * N * D_pad operations, bound at 67 TFLOP/s (the FMA rate;
// separate multiply and add issue at half of it), far above the corpus read
// (N * D_pad * 4 bytes). The tensor cores cannot compute this fp32
// function exactly; this kernel keeps the fixed summation order that makes
// it equal its plain version.
//
// What the design does about that (the geometry of sq8i_bucket.cu):
// - one block per (query tile of QT <= 16 queries, corpus chunk); the query
//   tile sits in shared memory and every read is a warp-wide
//   broadcast;
// - 128 threads, one per bucket lane: thread j owns rows c*chunk + i*128 + j,
//   reads its row in 16-byte vectors, and keeps a running (max, slice) pair
//   per query in registers, so the [B, N] score tile never exists;
// - blocks are numbered query tile first, so all query tiles of one chunk run
//   together and the chunk comes from HBM once, then from L2.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 128;

template <int QT>
__global__ void __launch_bounds__(kLanes)
dense_bucket_kernel(const float* __restrict__ q, const float* __restrict__ rows,
                    const float* __restrict__ cc, float* __restrict__ gm,
                    int32_t* __restrict__ gi, int b_pad, int d_pad, int chunk, int n_tiles,
                    long long n_buckets) {
  extern __shared__ float smem_q[];  // QT * d_pad floats
  const int lane = threadIdx.x;
  const int tile = blockIdx.x % n_tiles;
  const long long c = blockIdx.x / n_tiles;
  const int q0 = tile * QT;

  for (int t = lane; t < QT * d_pad; t += kLanes) {
    const int qq = t / d_pad;
    smem_q[t] = (q0 + qq < b_pad)
                    ? q[static_cast<long long>(q0 + qq) * d_pad + (t - qq * d_pad)]
                    : 0.0f;
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
  const int nv = d_pad / 4;  // 16-byte loads a row
  for (int s = 0; s < slices; ++s) {
    const long long r = c * chunk + static_cast<long long>(s) * kLanes + lane;
    float acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0.0f;
    const float4* rp = reinterpret_cast<const float4*>(rows + r * d_pad);
    for (int w = 0; w < nv; ++w) {
      const float4 raw = __ldg(rp + w);
      const float xf[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const float* qs = smem_q + j * d_pad + w * 4;
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j] = __fadd_rn(acc[j], __fmul_rn(qs[v], xf[v]));
      }
    }
    const float p = __ldg(cc + r);
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const float v = __fsub_rn(acc[j], p);
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
cudaError_t launch(const float* q, const float* rows, const float* cc, float* gm, int32_t* gi,
                   int b_pad, long long n, int d_pad, int chunk, cudaStream_t stream) {
  const int n_tiles = (b_pad + QT - 1) / QT;
  const long long n_chunks = n / chunk;
  const long long blocks = n_chunks * n_tiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(QT) * d_pad * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_bucket_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dense_bucket_kernel<QT><<<static_cast<unsigned>(blocks), kLanes, smem, stream>>>(
      q, rows, cc, gm, gi, b_pad, d_pad, chunk, n_tiles, n_chunks * kLanes);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes: f32 ``q``, ``rows`` and ``cc``.
// Launches on ``stream`` without synchronizing and returns the launch's CUDA
// error code.
extern "C" int dense_bucket_launch(const void* q, const void* rows, const void* cc, void* gm,
                                   void* gi, int b_pad, long long n, int d_pad, int chunk,
                                   void* stream) {
  // d_pad <= 3072: 16 queries x d_pad floats of shared memory (192 KB)
  if (b_pad <= 0 || b_pad % 8 != 0 || n <= 0 || d_pad <= 0 || d_pad % 8 != 0 ||
      d_pad > 3072 || chunk <= 0 || chunk % kLanes != 0 || chunk > 8192 || n % chunk != 0 ||
      n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* rf = static_cast<const float*>(rows);
  const auto* p = static_cast<const float*>(cc);
  auto* m = static_cast<float*>(gm);
  auto* g = static_cast<int32_t*>(gi);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = b_pad % 16 == 0
                              ? launch<16>(qf, rf, p, m, g, b_pad, n, d_pad, chunk, s)
                              : launch<8>(qf, rf, p, m, g, b_pad, n, d_pad, chunk, s);
  return static_cast<int>(err);
}

// hamming_mxu_bucket.cu — bit-plane Hamming bucket scan for Hopper.
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_hamming_mxu_kernel (the Pallas
// kernel launched by hamming_mxu_topk). Same contract, bit for bit against
// the plain torch version hamming_mxu_ref:
//
//   inputs   qi    int8  [B_pad, D_pad]  2 * query sign bits (0 or 2)
//            bits  int8  [N, D_pad]      corpus sign bits (0 or 1)
//            aux   int32 [N]             |c| + 2^20 * knocked_out
//   output   gm  f32   [B_pad, (N / chunk) * 128]   (exact: |s| < 2^24)
//            gi  int32 [B_pad, (N / chunk) * 128]
//   s[b, r]  = qi[b] . bits[r] - aux[r]   (= |q| - hamming(q, c) - knockout)
//   gm[b, c*128 + j] = max over slices i of s[b, c*chunk + i*128 + j], gi its
//   row; ties go to the smallest slice.
//
// Integer scores make the bucket select one max: enc = s * 64 + (63 - slice)
// carries the score in the high bits and the slice, inverted so that the
// smallest slice wins a tie, in the low 6 (chunk <= 8192 = 64 slices). |s| <=
// 2^20 + 2 * D_pad, so |enc| < 2^31 for every D_pad the wrapper accepts.
//
// What bounds it on this card: __dp4a issue, B_pad * N * D_pad / 4 per call,
// as in sq8pd_bucket.cu (the TPU kernel's int8 matmul). The shadow costs one
// byte per bit, eight times the packed words that hamming_bucket.cu reads;
// whether that trade pays on Hopper, where __popc on the packed words is
// cheap, is an open question for a later PR (ROADMAP.md).
//
// What the design does about that: the sq8pd_bucket.cu skeleton — one block
// per (query tile of QT <= 32, chunk), the query tile in shared memory read
// as broadcasts, 128 threads each owning one bucket lane and reading its row
// in 16-byte vectors, one running int32 max per query in registers, blocks
// numbered query tile first so each chunk is read from HBM once.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 128;

template <int QT>
__global__ void __launch_bounds__(kLanes)
hamming_mxu_kernel(const int8_t* __restrict__ qi, const int8_t* __restrict__ bits,
                   const int32_t* __restrict__ aux, float* __restrict__ gm,
                   int32_t* __restrict__ gi, int b_pad, int d_pad, int chunk,
                   int n_tiles, long long n_buckets) {
  extern __shared__ int4 smem_q4[];  // QT * d_pad bytes
  const int lane = threadIdx.x;
  const int tile = blockIdx.x % n_tiles;
  const long long c = blockIdx.x / n_tiles;
  const int q0 = tile * QT;
  const int w4 = d_pad >> 4;

  const int4* qv = reinterpret_cast<const int4*>(qi);
  for (int t = lane; t < QT * w4; t += kLanes) {
    const int q = t / w4;
    smem_q4[t] = (q0 + q < b_pad) ? qv[static_cast<long long>(q0 + q) * w4 + (t - q * w4)]
                                  : make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  int mx[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) mx[q] = INT_MIN;

  const int slices = chunk / kLanes;
  for (int s = 0; s < slices; ++s) {
    const long long r = c * chunk + static_cast<long long>(s) * kLanes + lane;
    const int low = 63 - s - __ldg(aux + r) * 64;  // enc = doti * 64 + low
    int acc[QT];
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[q] = 0;
    const int4* rp = reinterpret_cast<const int4*>(bits + r * d_pad);
#pragma unroll 2
    for (int w = 0; w < w4; ++w) {
      const int4 x = __ldg(rp + w);
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const int4 y = smem_q4[q * w4 + w];
        int v = acc[q];
        v = __dp4a(x.x, y.x, v);
        v = __dp4a(x.y, y.y, v);
        v = __dp4a(x.z, y.z, v);
        v = __dp4a(x.w, y.w, v);
        acc[q] = v;
      }
    }
#pragma unroll
    for (int q = 0; q < QT; ++q) mx[q] = max(mx[q], acc[q] * 64 + low);
  }

#pragma unroll
  for (int q = 0; q < QT; ++q) {
    if (q0 + q < b_pad) {
      const long long o = static_cast<long long>(q0 + q) * n_buckets + c * kLanes + lane;
      const int slice = 63 - (mx[q] & 63);
      gm[o] = __int2float_rn(mx[q] >> 6);  // arithmetic shift: exact floor
      gi[o] = static_cast<int32_t>(c * chunk + slice * kLanes + lane);
    }
  }
}

template <int QT>
cudaError_t launch(const int8_t* qi, const int8_t* bits, const int32_t* aux, float* gm,
                   int32_t* gi, int b_pad, long long n, int d_pad, int chunk,
                   cudaStream_t stream) {
  const int n_tiles = (b_pad + QT - 1) / QT;
  const long long n_chunks = n / chunk;
  const long long blocks = n_chunks * n_tiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(QT) * d_pad;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hamming_mxu_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  hamming_mxu_kernel<QT><<<static_cast<unsigned>(blocks), kLanes, smem, stream>>>(
      qi, bits, aux, gm, gi, b_pad, d_pad, chunk, n_tiles, n_chunks * kLanes);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on ``stream`` without
// synchronizing and returns the launch's CUDA error code.
extern "C" int hamming_mxu_launch(const void* qi, const void* bits, const void* aux,
                                  void* gm, void* gi, int b_pad, long long n, int d_pad,
                                  int chunk, void* stream) {
  if (b_pad <= 0 || n <= 0 || d_pad <= 0 || d_pad % 16 != 0 || d_pad > 6144 ||
      chunk <= 0 || chunk % kLanes != 0 || chunk > 8192 || n % chunk != 0 ||
      n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* q = static_cast<const int8_t*>(qi);
  const auto* b = static_cast<const int8_t*>(bits);
  const auto* a = static_cast<const int32_t*>(aux);
  auto* m = static_cast<float*>(gm);
  auto* g = static_cast<int32_t*>(gi);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (b_pad % 32 == 0) {
    err = launch<32>(q, b, a, m, g, b_pad, n, d_pad, chunk, s);
  } else if (b_pad % 16 == 0) {
    err = launch<16>(q, b, a, m, g, b_pad, n, d_pad, chunk, s);
  } else {
    err = launch<8>(q, b, a, m, g, b_pad, n, d_pad, chunk, s);
  }
  return static_cast<int>(err);
}

// hamming_bucket.cu — packed XOR + popcount bucket scan for Hopper.
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_hamming_kernel (the Pallas
// kernel launched by hamming_bucket_topk). Same contract, bit for bit against
// the plain torch version hamming_bucket_ref:
//
//   inputs   q       int32 [B_pad, W]  packed query sign bits (uint32 words)
//            packed  int32 [N, W]      packed corpus sign bits
//            pen     f32   [N]         0 on valid rows, +inf on knocked-out
//   output   gm  f32   [B_pad, (N / chunk) * 128]
//            gi  int32 [B_pad, (N / chunk) * 128]
//   s[b, r]  = -float(popc(q[b] ^ packed[r])) - pen[r]
//   gm[b, c*128 + j] = max over slices i of s[b, c*chunk + i*128 + j], gi its
//   row; ties go to the smallest slice, a bucket of -inf returns slice 0.
//
// The reference pads W to 128 words for the TPU's lanes; this kernel reads the
// true W = ceil(D/32) words (4 at 100 dims).
//
// What bounds it on this card: __popc issue. Each (query, row) pair costs W
// XOR + W POPC + W IADD, B_pad * N * W popcounts per call, while the packed
// corpus is only 4 * W bytes a row (21 MB at 1.3M x 100 dims), read once per
// chunk from HBM and then from L2.
//
// What the design does about that: one block per (query tile of QT <= 32,
// chunk of 2048 rows); the query tile sits in shared memory and every read is
// a broadcast; 128 threads each own one bucket lane, hold their row's words
// in registers one at a time, and keep a running (max, slice) pair per query,
// so the [B, N] distance tile never exists; blocks are numbered query tile
// first so all tiles of one chunk run together.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 128;

template <int QT>
__global__ void __launch_bounds__(kLanes)
hamming_bucket_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ packed,
                      const float* __restrict__ pen, float* __restrict__ gm,
                      int32_t* __restrict__ gi, int b_pad, int w, int chunk, int n_tiles,
                      long long n_buckets) {
  extern __shared__ uint32_t smem_q[];  // QT * w words
  const int lane = threadIdx.x;
  const int tile = blockIdx.x % n_tiles;
  const long long c = blockIdx.x / n_tiles;
  const int q0 = tile * QT;

  for (int t = lane; t < QT * w; t += kLanes) {
    const int qq = t / w;
    smem_q[t] = (q0 + qq < b_pad) ? q[static_cast<long long>(q0 + qq) * w + (t - qq * w)] : 0u;
  }
  __syncthreads();

  float mx[QT];
  int mi[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    mx[i] = -__int_as_float(0x7f800000);  // -inf
    mi[i] = 0;
  }

  const int slices = chunk / kLanes;
  for (int s = 0; s < slices; ++s) {
    const long long r = c * chunk + static_cast<long long>(s) * kLanes + lane;
    const float p = __ldg(pen + r);
    const uint32_t* rp = packed + r * w;
    int acc[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) acc[i] = 0;
#pragma unroll 4
    for (int k = 0; k < w; ++k) {
      const uint32_t x = __ldg(rp + k);
#pragma unroll
      for (int i = 0; i < QT; ++i) acc[i] += __popc(x ^ smem_q[i * w + k]);
    }
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const float v = __fsub_rn(-__int2float_rn(acc[i]), p);
      if (v > mx[i]) {
        mx[i] = v;
        mi[i] = s;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < QT; ++i) {
    if (q0 + i < b_pad) {
      const long long o = static_cast<long long>(q0 + i) * n_buckets + c * kLanes + lane;
      gm[o] = mx[i];
      gi[o] = static_cast<int32_t>(c * chunk + mi[i] * kLanes + lane);
    }
  }
}

template <int QT>
cudaError_t launch(const uint32_t* q, const uint32_t* packed, const float* pen, float* gm,
                   int32_t* gi, int b_pad, long long n, int w, int chunk,
                   cudaStream_t stream) {
  const int n_tiles = (b_pad + QT - 1) / QT;
  const long long n_chunks = n / chunk;
  const long long blocks = n_chunks * n_tiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(QT) * w * sizeof(uint32_t);
  hamming_bucket_kernel<QT><<<static_cast<unsigned>(blocks), kLanes, smem, stream>>>(
      q, packed, pen, gm, gi, b_pad, w, chunk, n_tiles, n_chunks * kLanes);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on ``stream`` without
// synchronizing and returns the launch's CUDA error code.
extern "C" int hamming_bucket_launch(const void* q, const void* packed, const void* pen,
                                     void* gm, void* gi, int b_pad, long long n, int w,
                                     int chunk, void* stream) {
  // w <= 256: at most 32 KB of query words in shared memory
  if (b_pad <= 0 || n <= 0 || w <= 0 || w > 256 || chunk <= 0 || chunk % kLanes != 0 ||
      chunk > 8192 || n % chunk != 0 || n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qw = static_cast<const uint32_t*>(q);
  const auto* cw = static_cast<const uint32_t*>(packed);
  const auto* p = static_cast<const float*>(pen);
  auto* m = static_cast<float*>(gm);
  auto* g = static_cast<int32_t*>(gi);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (b_pad % 32 == 0) {
    err = launch<32>(qw, cw, p, m, g, b_pad, n, w, chunk, s);
  } else if (b_pad % 16 == 0) {
    err = launch<16>(qw, cw, p, m, g, b_pad, n, w, chunk, s);
  } else {
    err = launch<8>(qw, cw, p, m, g, b_pad, n, w, chunk, s);
  }
  return static_cast<int>(err);
}

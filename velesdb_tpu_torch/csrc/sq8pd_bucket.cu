// sq8pd_bucket.cu — per-dimension int8 "enc-select" bucket scan for Hopper.
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_sq8pd_kernel (the Pallas kernel
// launched by sq8pd_candidates). Same contract, bit for bit:
//
//   inputs   qi      int8  [B_pad, D_pad]   per-dim quantized queries
//            rows    int8  [N, D_pad]       per-dim quantized corpus shadow
//            ptile   int32 [N]              -64 * pen_int + in-chunk slice index
//   output   gm      int32 [B_pad, (N / chunk) * 128]
//            gm[b, c*128 + j] = max over slices i of
//                doti[b, c*chunk + i*128 + j] * 64 + ptile[c*chunk + i*128 + j]
//
// The int32 budget makes the encoding exact: |doti| <= 127^2 * D_pad, the
// invalid-row penalty is bounded by _pd_invalid_pen, so |enc| < 2^31 for every
// D_pad <= 512 (the wrapper refuses anything wider).
//
// What bounds it on this card. The H100's int8 tensor cores reach 1,979 TOPS,
// but this first version computes the dot with __dp4a on the integer ALUs
// (4 int8 multiply-adds per instruction), so it is bound by integer issue
// rate: B_pad * N * D_pad / 4 dp4a per call. The shadow read is N * D_pad
// bytes per query tile, plus 4 bytes of ptile per row.
//
// What the design does about that:
// - one block per (query tile of QT <= 32 queries, corpus chunk); the query
//   tile sits in shared memory and every read of it is a warp-wide broadcast;
// - 128 threads, one per bucket lane: thread j owns rows c*chunk + i*128 + j,
//   reads its own row in 16-byte vectors, and keeps one running max per query
//   in registers, so the [B, N] score tile never exists in device memory;
// - blocks are numbered query tile first, so all query tiles of one chunk run
//   at the same time and the chunk is read from HBM once and then from L2.
// wgmma s8 and TMA are later work.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 128;

template <int QT, bool VEC16>
__global__ void __launch_bounds__(kLanes)
sq8pd_bucket_kernel(const int8_t* __restrict__ qi,
                    const int8_t* __restrict__ rows,
                    const int32_t* __restrict__ ptile,
                    int32_t* __restrict__ gm,
                    int b_pad, int d_pad, int chunk, int n_tiles,
                    long long n_buckets) {
  extern __shared__ int4 smem_q4[];  // QT * d_pad bytes
  int* smem_q = reinterpret_cast<int*>(smem_q4);
  const int lane = threadIdx.x;
  const int tile = blockIdx.x % n_tiles;
  const long long c = blockIdx.x / n_tiles;
  const int q0 = tile * QT;
  const int words = d_pad >> 2;

  // stage the query tile; queries past b_pad are zero and never written
  const int* qw = reinterpret_cast<const int*>(qi);
  for (int t = lane; t < QT * words; t += kLanes) {
    const int q = t / words;
    smem_q[t] = (q0 + q < b_pad)
                    ? qw[static_cast<long long>(q0 + q) * words + (t - q * words)]
                    : 0;
  }
  __syncthreads();

  int mx[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) mx[q] = INT_MIN;

  const int slices = chunk / kLanes;
  for (int s = 0; s < slices; ++s) {
    const long long r = c * chunk + static_cast<long long>(s) * kLanes + lane;
    const int pt = __ldg(ptile + r);
    int acc[QT];
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[q] = 0;
    if (VEC16) {
      const int w4 = words >> 2;
      const int4* rp = reinterpret_cast<const int4*>(rows + r * d_pad);
#pragma unroll 2
      for (int w = 0; w < w4; ++w) {
        const int4 x = __ldg(rp + w);
#pragma unroll
        for (int q = 0; q < QT; ++q) {
          const int4 y = smem_q4[q * w4 + w];
          int a = acc[q];
          a = __dp4a(x.x, y.x, a);
          a = __dp4a(x.y, y.y, a);
          a = __dp4a(x.z, y.z, a);
          a = __dp4a(x.w, y.w, a);
          acc[q] = a;
        }
      }
    } else {
      const int* rp = reinterpret_cast<const int*>(rows + r * d_pad);
#pragma unroll 4
      for (int w = 0; w < words; ++w) {
        const int x = __ldg(rp + w);
#pragma unroll
        for (int q = 0; q < QT; ++q) acc[q] = __dp4a(x, smem_q[q * words + w], acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < QT; ++q) mx[q] = max(mx[q], acc[q] * 64 + pt);
  }

#pragma unroll
  for (int q = 0; q < QT; ++q) {
    if (q0 + q < b_pad) {
      gm[static_cast<long long>(q0 + q) * n_buckets + c * kLanes + lane] = mx[q];
    }
  }
}

template <int QT>
cudaError_t launch(const int8_t* qi, const int8_t* rows, const int32_t* ptile,
                   int32_t* gm, int b_pad, long long n, int d_pad, int chunk,
                   cudaStream_t stream) {
  const int n_tiles = (b_pad + QT - 1) / QT;
  const long long n_chunks = n / chunk;
  const long long n_buckets = n_chunks * kLanes;
  const long long blocks = n_chunks * n_tiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(QT) * d_pad;
  const bool vec16 = (d_pad % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(rows) % 16 == 0);
  if (vec16) {
    sq8pd_bucket_kernel<QT, true><<<static_cast<unsigned>(blocks), kLanes, smem, stream>>>(
        qi, rows, ptile, gm, b_pad, d_pad, chunk, n_tiles, n_buckets);
  } else {
    sq8pd_bucket_kernel<QT, false><<<static_cast<unsigned>(blocks), kLanes, smem, stream>>>(
        qi, rows, ptile, gm, b_pad, d_pad, chunk, n_tiles, n_buckets);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on ``stream`` without
// synchronizing and returns the launch's cudaGetLastError() code.
extern "C" int sq8pd_bucket_launch(const void* qi, const void* rows,
                                   const void* ptile, void* gm, int b_pad,
                                   long long n, int d_pad, int chunk,
                                   void* stream) {
  if (b_pad <= 0 || n <= 0 || d_pad <= 0 || d_pad % 4 != 0 || d_pad > 512 ||
      chunk <= 0 || chunk % kLanes != 0 || chunk > 8192 || n % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* q = static_cast<const int8_t*>(qi);
  const auto* r = static_cast<const int8_t*>(rows);
  const auto* p = static_cast<const int32_t*>(ptile);
  auto* g = static_cast<int32_t*>(gm);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (b_pad % 32 == 0) {
    err = launch<32>(q, r, p, g, b_pad, n, d_pad, chunk, s);
  } else if (b_pad % 16 == 0) {
    err = launch<16>(q, r, p, g, b_pad, n, d_pad, chunk, s);
  } else {
    err = launch<8>(q, r, p, g, b_pad, n, d_pad, chunk, s);
  }
  return static_cast<int>(err);
}

// sq8i_bucket.cu — per-row SQ8 int8 bucket scan for Hopper.
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_sq8i_kernel (the Pallas kernel
// launched by sq8i_bucket_topk). Same contract, bit for bit against the plain
// torch version sq8i_bucket_ref:
//
//   inputs   qi     int8  [B_pad, D_pad]  per-query symmetric int8 queries
//            rows   int8  [N, D_pad]      SQ8 codes - 128
//            scale, am, pen  f32 [N]      per-row affine (am = 128*scale + minv)
//            sqi, invqs      f32 [B_pad]  sum(qi) and 1/qs per query
//   output   gm  f32   [B_pad, (N / chunk) * 128]
//            gi  int32 [B_pad, (N / chunk) * 128]
//   s[b, r]  = float(doti) * scale[r] + sqi[b] * am[r] - invqs[b] * pen[r]
//   gm[b, c*128 + j] = max over slices i of s[b, c*chunk + i*128 + j], gi its
//   row; ties go to the smallest slice (the reference's _bucket_select), so a
//   bucket of -inf scores (pen = +inf) returns its slice-0 row.
//
// The epilogue is written with __fmul_rn / __fadd_rn / __fsub_rn in the plain
// version's order: nvcc would otherwise contract a*b + c into an FMA, which
// PyTorch's one-op-per-kernel arithmetic never does, and the two would differ
// in the last bit.
//
// What bounds it on this card. Like sq8pd_bucket.cu it computes the dot with
// __dp4a on the integer ALUs: B_pad * N * D_pad / 4 dp4a per call, so it is
// bound by integer issue, not by the 1-byte-per-dim shadow read (N * D_pad
// bytes + 12 bytes of scale/am/pen per row per query tile) and not by the
// tensor cores it does not use. The f32 epilogue adds 6 flops and a compare
// per (query, row).
//
// What the design does about that:
// - one block per (query tile of QT <= 16 queries, corpus chunk); the query
//   tile, sqi and invqs sit in shared memory and every read is a warp-wide
//   broadcast;
// - 128 threads, one per bucket lane: thread j owns rows c*chunk + i*128 + j,
//   reads its row in 16-byte vectors, and keeps a running (max, slice) pair
//   per query in registers, so the [B, N] score tile never exists;
// - QT is 16, half of sq8pd_bucket's 32, because each query now holds a float
//   max and a slice index beside its int32 accumulator;
// - blocks are numbered query tile first, so all query tiles of one chunk run
//   together and the chunk comes from HBM once, then from L2.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 128;

template <int QT>
__global__ void __launch_bounds__(kLanes)
sq8i_bucket_kernel(const int8_t* __restrict__ qi, const int8_t* __restrict__ rows,
                   const float* __restrict__ scale, const float* __restrict__ am,
                   const float* __restrict__ pen, const float* __restrict__ sqi,
                   const float* __restrict__ invqs, float* __restrict__ gm,
                   int32_t* __restrict__ gi, int b_pad, int d_pad, int chunk,
                   int n_tiles, long long n_buckets) {
  extern __shared__ int4 smem_q4[];  // QT * d_pad bytes
  __shared__ float s_sqi[QT];
  __shared__ float s_iq[QT];
  const int lane = threadIdx.x;
  const int tile = blockIdx.x % n_tiles;
  const long long c = blockIdx.x / n_tiles;
  const int q0 = tile * QT;
  const int w4 = d_pad >> 4;  // 16-byte words per row

  const int4* qv = reinterpret_cast<const int4*>(qi);
  for (int t = lane; t < QT * w4; t += kLanes) {
    const int q = t / w4;
    smem_q4[t] = (q0 + q < b_pad) ? qv[static_cast<long long>(q0 + q) * w4 + (t - q * w4)]
                                  : make_int4(0, 0, 0, 0);
  }
  if (lane < QT) {
    s_sqi[lane] = (q0 + lane < b_pad) ? sqi[q0 + lane] : 0.0f;
    s_iq[lane] = (q0 + lane < b_pad) ? invqs[q0 + lane] : 0.0f;
  }
  __syncthreads();

  float mx[QT];
  int mi[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    mx[q] = -__int_as_float(0x7f800000);  // -inf
    mi[q] = 0;
  }

  const int slices = chunk / kLanes;
  for (int s = 0; s < slices; ++s) {
    const long long r = c * chunk + static_cast<long long>(s) * kLanes + lane;
    const float sc = __ldg(scale + r);
    const float a = __ldg(am + r);
    const float p = __ldg(pen + r);
    int acc[QT];
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[q] = 0;
    const int4* rp = reinterpret_cast<const int4*>(rows + r * d_pad);
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
    for (int q = 0; q < QT; ++q) {
      const float t = __fadd_rn(__fmul_rn(__int2float_rn(acc[q]), sc), __fmul_rn(s_sqi[q], a));
      const float v = __fsub_rn(t, __fmul_rn(s_iq[q], p));
      if (v > mx[q]) {
        mx[q] = v;
        mi[q] = s;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < QT; ++q) {
    if (q0 + q < b_pad) {
      const long long o = static_cast<long long>(q0 + q) * n_buckets + c * kLanes + lane;
      gm[o] = mx[q];
      gi[o] = static_cast<int32_t>(c * chunk + mi[q] * kLanes + lane);
    }
  }
}

template <int QT>
cudaError_t launch(const int8_t* qi, const int8_t* rows, const float* scale,
                   const float* am, const float* pen, const float* sqi,
                   const float* invqs, float* gm, int32_t* gi, int b_pad, long long n,
                   int d_pad, int chunk, cudaStream_t stream) {
  const int n_tiles = (b_pad + QT - 1) / QT;
  const long long n_chunks = n / chunk;
  const long long blocks = n_chunks * n_tiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(QT) * d_pad;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sq8i_bucket_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sq8i_bucket_kernel<QT><<<static_cast<unsigned>(blocks), kLanes, smem, stream>>>(
      qi, rows, scale, am, pen, sqi, invqs, gm, gi, b_pad, d_pad, chunk, n_tiles,
      n_chunks * kLanes);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on ``stream`` without
// synchronizing and returns the launch's CUDA error code.
extern "C" int sq8i_bucket_launch(const void* qi, const void* rows, const void* scale,
                                  const void* am, const void* pen, const void* sqi,
                                  const void* invqs, void* gm, void* gi, int b_pad,
                                  long long n, int d_pad, int chunk, void* stream) {
  if (b_pad <= 0 || n <= 0 || d_pad <= 0 || d_pad % 16 != 0 || d_pad > 12288 ||
      chunk <= 0 || chunk % kLanes != 0 || chunk > 8192 || n % chunk != 0 ||
      n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* q = static_cast<const int8_t*>(qi);
  const auto* r = static_cast<const int8_t*>(rows);
  const auto* sc = static_cast<const float*>(scale);
  const auto* a = static_cast<const float*>(am);
  const auto* p = static_cast<const float*>(pen);
  const auto* sq = static_cast<const float*>(sqi);
  const auto* iq = static_cast<const float*>(invqs);
  auto* m = static_cast<float*>(gm);
  auto* g = static_cast<int32_t*>(gi);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (b_pad % 16 == 0) {
    err = launch<16>(q, r, sc, a, p, sq, iq, m, g, b_pad, n, d_pad, chunk, s);
  } else {
    err = launch<8>(q, r, sc, a, p, sq, iq, m, g, b_pad, n, d_pad, chunk, s);
  }
  return static_cast<int>(err);
}

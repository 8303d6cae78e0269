// sq8i_bucket.cu — per-row SQ8 int8 bucket scan for Hopper, with four epilogues.
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_sq8i_kernel (the Pallas kernel
// launched by sq8i_bucket_topk), and the three epilogue experiments over the
// same int8 scan in benchmarks/exp_sq8i_v2.py (_k_v2, _k_v2h, _k_v3). Every
// epilogue is bit for bit against its plain torch version
// (sq8i_bucket_ref, and velesdb_tpu_torch/experiments/kernels.py's
// sq8i_v2_bucket_ref):
//
//   inputs   qi     int8  [B_pad, D_pad]  per-query symmetric int8 queries
//            rows   int8  [N, D_pad]      SQ8 codes - 128
//   doti[b, r] = qi[b] . rows[r]  (int32, exact)
//   output   gm  f32   [B_pad, (N / chunk) * 128]
//            gi  int32 [B_pad, (N / chunk) * 128]
//   gm[b, c*128 + j] = max over slices i of s[b, c*chunk + i*128 + j], gi its
//   row; ties go to the smallest slice (the reference's _bucket_select), so a
//   bucket of -inf scores (pen = +inf) returns its slice-0 row.
//
// The epilogues, s[b, r] from doti:
//   #7  (sq8i_bucket_launch): scale, am, pen f32 [N]; sqi, invqs f32 [B_pad]
//        s = (float(doti) * scale[r] + sqi[b] * am[r]) - invqs[b] * pen[r]
//   v2  (sq8i_v2_bucket_launch, variant 0): aux f32 [>=3, N], rows 0/1/2 =
//        scale / am / pen; qaux f32 [B_pad, >=3], columns 1/2 = sqi / -1/qs
//        corr = sqi[b] * am[r] + (-1/qs[b]) * pen[r]
//        s    = float(doti) * scale[r] + corr
//   v2h (variant 1): aux and qaux bf16; every step of v2 rounded to bf16:
//        d = bf16(doti); corr = bf16(sqi * am + (-1/qs) * pen);
//        s = bf16(bf16(d * scale) + corr); the select runs on those bf16
//        values, gm is their exact f32
//   v3  (variant 2): no aux; s = doti (exact in fp32 up to D_pad 1024:
//        |doti| <= 127^2 * 1024 < 2^24), a lower bound, wrong for euclidean
//        by design
// Every product and sum is written with __fmul_rn / __fadd_rn / __fsub_rn in
// the plain version's order: nvcc would otherwise contract a*b + c into an
// FMA, which PyTorch's one-op-per-kernel arithmetic never does. A bf16 step
// is an fp32 operation rounded to nearest even, as PyTorch computes bf16
// tensor arithmetic; the product of two bf16 values is exact in fp32.
//
// What bounds it on this card. Like sq8pd_bucket.cu it computes the dot with
// __dp4a on the integer ALUs: B_pad * N * D_pad / 4 dp4a per call, so it is
// bound by integer issue, not by the 1-byte-per-dim shadow read (N * D_pad
// bytes + 12 bytes of scale/am/pen per row per query tile) and not by the
// tensor cores it does not use. The epilogue adds 5 to 6 flops and a compare
// per (query, row), none for v3.
//
// What the design does about that:
// - one block per (query tile of QT <= 16 queries, corpus chunk); the query
//   tile and the two per-query epilogue values sit in shared memory and every
//   read is a warp-wide broadcast;
// - 128 threads, one per bucket lane: thread j owns rows c*chunk + i*128 + j,
//   reads its row in 16-byte vectors, and keeps a running (max, slice) pair
//   per query in registers, so the [B, N] score tile never exists;
// - QT is 16, half of sq8pd_bucket's 32, because each query now holds a float
//   max and a slice index beside its int32 accumulator;
// - blocks are numbered query tile first, so all query tiles of one chunk run
//   together and the chunk comes from HBM once, then from L2;
// - the epilogue is a template parameter: each one reads only the per-row and
//   per-query values it uses, and the dot and the select are one code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 128;

// #7: the reference's per-row affine, three f32 row vectors.
struct Affine {
  const float *scale, *am, *pen, *sqi, *invqs;
  struct Row {
    float sc, a, p;
  };
  __device__ float qa(int b) const { return sqi[b]; }
  __device__ float qb(int b) const { return invqs[b]; }
  __device__ Row row(long long r) const {
    return {__ldg(scale + r), __ldg(am + r), __ldg(pen + r)};
  }
  __device__ float score(int acc, float sq, float iq, const Row& w) const {
    const float t = __fadd_rn(__fmul_rn(__int2float_rn(acc), w.sc), __fmul_rn(sq, w.a));
    return __fsub_rn(t, __fmul_rn(iq, w.p));
  }
};

// v2: the rank-1 corrections summed first, then added to the scaled dot.
struct Folded {
  const float *aux, *qaux;
  long long n;
  int qstride;
  struct Row {
    float sc, a, p;
  };
  __device__ float qa(int b) const { return qaux[static_cast<long long>(b) * qstride + 1]; }
  __device__ float qb(int b) const { return qaux[static_cast<long long>(b) * qstride + 2]; }
  __device__ Row row(long long r) const {
    return {__ldg(aux + r), __ldg(aux + n + r), __ldg(aux + 2 * n + r)};
  }
  __device__ float score(int acc, float sq, float niq, const Row& w) const {
    const float corr = __fadd_rn(__fmul_rn(sq, w.a), __fmul_rn(niq, w.p));
    return __fadd_rn(__fmul_rn(__int2float_rn(acc), w.sc), corr);
  }
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// v2h: v2 in bf16, each step rounded.
struct FoldedBf16 {
  const __nv_bfloat16 *aux, *qaux;
  long long n;
  int qstride;
  struct Row {
    float sc, a, p;
  };
  __device__ float qa(int b) const {
    return __bfloat162float(qaux[static_cast<long long>(b) * qstride + 1]);
  }
  __device__ float qb(int b) const {
    return __bfloat162float(qaux[static_cast<long long>(b) * qstride + 2]);
  }
  __device__ Row row(long long r) const {
    return {__bfloat162float(aux[r]), __bfloat162float(aux[n + r]),
            __bfloat162float(aux[2 * n + r])};
  }
  __device__ float score(int acc, float sq, float niq, const Row& w) const {
    const float corr = bf16r(__fadd_rn(__fmul_rn(sq, w.a), __fmul_rn(niq, w.p)));
    const float t = bf16r(__fmul_rn(bf16r(__int2float_rn(acc)), w.sc));
    return bf16r(__fadd_rn(t, corr));
  }
};

// v3: the raw dot.
struct RawDot {
  struct Row {};
  __device__ float qa(int) const { return 0.0f; }
  __device__ float qb(int) const { return 0.0f; }
  __device__ Row row(long long) const { return {}; }
  __device__ float score(int acc, float, float, const Row&) const { return __int2float_rn(acc); }
};

template <int QT, class Epi>
__global__ void __launch_bounds__(kLanes)
sq8i_bucket_kernel(const int8_t* __restrict__ qi, const int8_t* __restrict__ rows, Epi epi,
                   float* __restrict__ gm, int32_t* __restrict__ gi, int b_pad, int d_pad,
                   int chunk, int n_tiles, long long n_buckets) {
  extern __shared__ int4 smem_q4[];  // QT * d_pad bytes
  __shared__ float s_qa[QT];
  __shared__ float s_qb[QT];
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
    s_qa[lane] = (q0 + lane < b_pad) ? epi.qa(q0 + lane) : 0.0f;
    s_qb[lane] = (q0 + lane < b_pad) ? epi.qb(q0 + lane) : 0.0f;
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
    const typename Epi::Row w_r = epi.row(r);
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
      const float v = epi.score(acc[q], s_qa[q], s_qb[q], w_r);
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

template <int QT, class Epi>
cudaError_t launch(const int8_t* qi, const int8_t* rows, const Epi& epi, float* gm,
                   int32_t* gi, int b_pad, long long n, int d_pad, int chunk,
                   cudaStream_t stream) {
  const int n_tiles = (b_pad + QT - 1) / QT;
  const long long n_chunks = n / chunk;
  const long long blocks = n_chunks * n_tiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(QT) * d_pad;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sq8i_bucket_kernel<QT, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sq8i_bucket_kernel<QT, Epi><<<static_cast<unsigned>(blocks), kLanes, smem, stream>>>(
      qi, rows, epi, gm, gi, b_pad, d_pad, chunk, n_tiles, n_chunks * kLanes);
  return cudaGetLastError();
}

template <class Epi>
int dispatch(const void* qi, const void* rows, const Epi& epi, void* gm, void* gi, int b_pad,
             long long n, int d_pad, int chunk, void* stream) {
  const auto* q = static_cast<const int8_t*>(qi);
  const auto* r = static_cast<const int8_t*>(rows);
  auto* m = static_cast<float*>(gm);
  auto* g = static_cast<int32_t*>(gi);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (b_pad % 16 == 0) {
    err = launch<16>(q, r, epi, m, g, b_pad, n, d_pad, chunk, s);
  } else {
    err = launch<8>(q, r, epi, m, g, b_pad, n, d_pad, chunk, s);
  }
  return static_cast<int>(err);
}

bool bad_shape(int b_pad, long long n, int d_pad, int chunk, int max_dpad) {
  return b_pad <= 0 || n <= 0 || d_pad <= 0 || d_pad % 16 != 0 || d_pad > max_dpad ||
         chunk <= 0 || chunk % kLanes != 0 || chunk > 8192 || n % chunk != 0 || n > INT_MAX;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on ``stream``
// without synchronizing and returns the launch's CUDA error code.

// #7, the per-row affine of the serve path.
extern "C" int sq8i_bucket_launch(const void* qi, const void* rows, const void* scale,
                                  const void* am, const void* pen, const void* sqi,
                                  const void* invqs, void* gm, void* gi, int b_pad,
                                  long long n, int d_pad, int chunk, void* stream) {
  if (bad_shape(b_pad, n, d_pad, chunk, 12288)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Affine epi{static_cast<const float*>(scale), static_cast<const float*>(am),
                   static_cast<const float*>(pen), static_cast<const float*>(sqi),
                   static_cast<const float*>(invqs)};
  return dispatch(qi, rows, epi, gm, gi, b_pad, n, d_pad, chunk, stream);
}

// The epilogue experiments: variant 0 = v2, 1 = v2h, 2 = v3. ``aux`` is
// [>=3, N] (row stride N), ``qaux`` [B_pad, qstride >= 3]; v3 reads neither.
extern "C" int sq8i_v2_bucket_launch(const void* qi, const void* rows, const void* aux,
                                     const void* qaux, void* gm, void* gi, int b_pad,
                                     long long n, int d_pad, int chunk, int qstride,
                                     int variant, void* stream) {
  if (bad_shape(b_pad, n, d_pad, chunk, 1024) || variant < 0 || variant > 2 ||
      (variant < 2 && (aux == nullptr || qaux == nullptr || qstride < 3))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant == 0) {
    const Folded epi{static_cast<const float*>(aux), static_cast<const float*>(qaux), n,
                     qstride};
    return dispatch(qi, rows, epi, gm, gi, b_pad, n, d_pad, chunk, stream);
  }
  if (variant == 1) {
    const FoldedBf16 epi{static_cast<const __nv_bfloat16*>(aux),
                         static_cast<const __nv_bfloat16*>(qaux), n, qstride};
    return dispatch(qi, rows, epi, gm, gi, b_pad, n, d_pad, chunk, stream);
  }
  return dispatch(qi, rows, RawDot{}, gm, gi, b_pad, n, d_pad, chunk, stream);
}

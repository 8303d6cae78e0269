// ivf_probe.cu — IVF probe scan for Hopper: score the partitions each query
// probes, one thread per partition row.
//
// Replaces velesdb_tpu/ops/ivf_kernel.py::_probe_kernel (the Pallas kernel
// launched by ivf_probe_topk): the scoring core of every unmasked IVF search
// at small batch. Same contract, bit for bit against the plain torch version
// ivf_probe_ref:
//
//   inputs   q      f32   [B, D_pad]     queries (cosine: normalized;
//                                        euclidean: 2q); SQ8: rounded to bf16
//            qsum   f32   [B]            sum of the unrounded q, summed once
//                                        by the wrapper
//            probe  int32 [B, nprobe]    partition ids
//            rows   int32 [P, L, W]      SQ8 codes from sq8_pack_blocked
//                                        (D_pad = 4 W: byte j of word w holds
//                                        dim j * W + w), or
//                   f32   [P, L, D_pad]  f32 rows
//            aux    f32   [P, 3, L]      per slot (mul, add, pen); pen = +inf
//                                        on a dead slot
//   output   out    f32   [B, nprobe, L]
//   dot[b, j, l] = sum over dims 0 .. D_pad-1, in dim order, of q[b, d] *
//                  row[probe[b, j], l, d], each product and partial sum
//                  rounded to fp32
//   out[b, j, l] = ((dot * mul) + (qsum[b] * add)) - pen, each step rounded;
//                  -inf where probe[b, j] is not a partition
//
// What bounds it on this card: bytes. A (query, probe) pair reads its whole
// partition, L * (row bytes + 12) bytes, for 2 * L * D_pad operations: at the
// sift1m shape (L 1,032, D 128, f32) that is 4 bytes an operation pair, far
// below the 67 TFLOP/s fp32 rate's need, so the 3.35 TB/s of device memory
// bounds it (less where queries that probe the same partition hit in L2).
//
// What the design does about that: the TPU kernel's grid walks (query, probe)
// in order and double-buffers one partition DMA per step, with the query
// replicated over 8 sublanes and aux stacked on 8 rows (Mosaic layout rules).
// Here the grid is (B * nprobe, ceil(L / 128)) blocks of 128 threads, so a
// single query's 68 probes still fill 132 SMs with ~600 blocks. Each block
// reads its own probe id (the scalar prefetch's job) and keeps its query row
// in shared memory; each thread owns one row and streams it with 16-byte
// loads where the row width allows, and sums in dim order with
// __fmul_rn/__fadd_rn (no FMA contraction), so the plain version's
// elementwise sum in the same order matches bit for bit. An SQ8 thread walks
// its row's byte planes in turn (plane j is dims j*W .. j*W + W-1), reading
// each word four times, from L1 after the first. The aux reads are
// coalesced across the block's threads. Selection runs outside, in torch.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kRows = 128;
constexpr int kMaxDPad = 12288;  // the query row in 48 KB of shared memory

__device__ __forceinline__ float term(float acc, float qv, float x) {
  return __fadd_rn(acc, __fmul_rn(qv, x));
}

template <bool kQuant, bool kVec>
__global__ void __launch_bounds__(kRows)
ivf_probe_kernel(const float* __restrict__ q, const float* __restrict__ qsum,
                 const int32_t* __restrict__ probe, const void* __restrict__ rows,
                 const float* __restrict__ aux, float* __restrict__ out, int nprobe,
                 long long n_parts, int L, int width) {
  extern __shared__ float s_q[];  // D_pad floats
  const long long bj = blockIdx.x;  // b * nprobe + j
  const int b = static_cast<int>(bj / nprobe);
  const int d_pad = kQuant ? 4 * width : width;
  for (int t = threadIdx.x; t < d_pad; t += kRows) s_q[t] = q[static_cast<long long>(b) * d_pad + t];
  __syncthreads();

  const int r = blockIdx.y * kRows + threadIdx.x;
  if (r >= L) return;
  const long long o = bj * L + r;
  const long long pid = __ldg(probe + bj);
  if (pid < 0 || pid >= n_parts) {
    out[o] = -__int_as_float(0x7f800000);  // -inf
    return;
  }
  const long long slot = pid * L + r;
  float acc = 0.0f;
  if constexpr (kQuant) {
    const int32_t* rp = static_cast<const int32_t*>(rows) + slot * width;
#pragma unroll
    for (int plane = 0; plane < 4; ++plane) {
      const float* qp = s_q + plane * width;
      const int sh = 8 * plane;
      if constexpr (kVec) {
        const int4* rv = reinterpret_cast<const int4*>(rp);
        for (int k = 0; k < width / 4; ++k) {
          const int4 v = __ldg(rv + k);
          acc = term(acc, qp[4 * k], static_cast<float>((v.x >> sh) & 0xFF));
          acc = term(acc, qp[4 * k + 1], static_cast<float>((v.y >> sh) & 0xFF));
          acc = term(acc, qp[4 * k + 2], static_cast<float>((v.z >> sh) & 0xFF));
          acc = term(acc, qp[4 * k + 3], static_cast<float>((v.w >> sh) & 0xFF));
        }
      } else {
        for (int k = 0; k < width; ++k) {
          acc = term(acc, qp[k], static_cast<float>((__ldg(rp + k) >> sh) & 0xFF));
        }
      }
    }
  } else {
    const float* rp = static_cast<const float*>(rows) + slot * width;
    if constexpr (kVec) {
      const float4* rv = reinterpret_cast<const float4*>(rp);
      for (int k = 0; k < width / 4; ++k) {
        const float4 v = __ldg(rv + k);
        acc = term(acc, s_q[4 * k], v.x);
        acc = term(acc, s_q[4 * k + 1], v.y);
        acc = term(acc, s_q[4 * k + 2], v.z);
        acc = term(acc, s_q[4 * k + 3], v.w);
      }
    } else {
      for (int k = 0; k < width; ++k) acc = term(acc, s_q[k], __ldg(rp + k));
    }
  }
  const float* ap = aux + pid * 3 * L + r;
  const float mul = __ldg(ap);
  const float add = __ldg(ap + L);
  const float pen = __ldg(ap + 2 * static_cast<long long>(L));
  const float t = __fadd_rn(__fmul_rn(acc, mul), __fmul_rn(__ldg(qsum + b), add));
  out[o] = __fsub_rn(t, pen);
}

template <bool kQuant, bool kVec>
cudaError_t launch(const float* q, const float* qsum, const int32_t* probe, const void* rows,
                   const float* aux, float* out, int b, int nprobe, long long n_parts, int L,
                   int width, cudaStream_t stream) {
  const long long pairs = static_cast<long long>(b) * nprobe;
  const int tiles = (L + kRows - 1) / kRows;
  if (pairs <= 0 || pairs > INT_MAX || tiles > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(kQuant ? 4 * width : width) * sizeof(float);
  const dim3 grid(static_cast<unsigned>(pairs), static_cast<unsigned>(tiles));
  ivf_probe_kernel<kQuant, kVec><<<grid, kRows, smem, stream>>>(
      q, qsum, probe, rows, aux, out, nprobe, n_parts, L, width);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. ``width`` is the row width in
// elements: words (D_pad / 4) when ``quant`` is 1, floats (D_pad) when 0.
// Launches on ``stream`` without synchronizing and returns the launch's CUDA
// error code. 16-byte row loads are taken when ``width`` is a multiple of 4
// (every row then starts 16-byte aligned: the wrapper hands in aligned bases).
extern "C" int ivf_probe_launch(const void* q, const void* qsum, const void* probe,
                                const void* rows, const void* aux, void* out, int b, int nprobe,
                                long long n_parts, int L, int width, int quant, void* stream) {
  const int d_pad = quant ? 4 * width : width;
  if (b <= 0 || nprobe <= 0 || n_parts <= 0 || L <= 0 || width <= 0 || d_pad > kMaxDPad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* qs = static_cast<const float*>(qsum);
  const auto* pr = static_cast<const int32_t*>(probe);
  const auto* ax = static_cast<const float*>(aux);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = width % 4 == 0;
  cudaError_t err;
  if (quant) {
    err = vec ? launch<true, true>(qf, qs, pr, rows, ax, o, b, nprobe, n_parts, L, width, s)
              : launch<true, false>(qf, qs, pr, rows, ax, o, b, nprobe, n_parts, L, width, s);
  } else {
    err = vec ? launch<false, true>(qf, qs, pr, rows, ax, o, b, nprobe, n_parts, L, width, s)
              : launch<false, false>(qf, qs, pr, rows, ax, o, b, nprobe, n_parts, L, width, s);
  }
  return static_cast<int>(err);
}

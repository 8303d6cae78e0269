// row_gather.cu — scored row gather for Hopper.
//
// Replaces benchmarks/exp_gather_kernel.py::kern and ::kern_db (the Pallas
// kernels that copy each gathered corpus row to VMEM with its own DMA, G in
// flight, then score the gathered block against 8 queries): one function,
// two depths of copies in flight. Bit for bit against the plain torch
// version velesdb_tpu_torch/experiments/kernels.py::row_gather_scores_ref:
//
//   inputs   q       f32   [8, D]   resident queries
//            corpus  f32   [N, D]   rows, D a multiple of 4
//            idx     int32 [R]      row ids in [0, N); repeats allowed
//   output   out     f32   [8, R]
//   out[j, r] = sum over d = 0 .. D-1, in that order, of q[j, d] *
//               corpus[idx[r], d], each product and partial sum rounded to
//               fp32 (__fmul_rn / __fadd_rn). An id outside [0, N) reads
//               nothing and scores NaN.
//
// DEPTH 1 is ``kern``: a block issues the copies of one group of G rows, waits
// for all of them, scores them, and only then issues the next group. DEPTH 2
// is ``kern_db``: the next group's copies are issued before the block waits
// on this one, so one group is always in flight while another is scored.
//
// What bounds it on this card. The function moves R * D * 4 bytes of rows,
// R * 4 of ids and 8 * R * 4 of scores (about 4.5 MB at R 8,192, D 128: 1.3 us
// at 3.35 TB/s) and does 2 * 8 * R * D flops; at that size a launch itself
// (a few us) is the larger share. Each gathered row is one scattered 512-byte
// read: the copy engine's transaction count, not the byte count, sets how fast
// the rows arrive.
//
// What the design does about that:
// - a block owns kRowsPerBlock consecutive ids, loads its slice of idx to
//   shared memory itself, and copies each row with 16-byte cp.async (one warp
//   a row, 32 lanes x 16 bytes = 512 bytes at D 128), G rows a group;
// - the 8 queries sit in shared memory, padded by one float a row, and the
//   rows by four, so the scoring threads' reads spread over the banks;
// - thread (row, query) of a group sums its dot in dimension order, so the
//   result equals the plain version's fixed-order sum.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kQueries = 8;
constexpr int kRowsPerBlock = 64;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int DEPTH>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ q, const float* __restrict__ corpus,
                  const int32_t* __restrict__ idx, float* __restrict__ out, long long n,
                  int d, int r_total, int group) {
  extern __shared__ __align__(16) float smem[];
  const int qs = d + 1;  // query row stride (floats)
  const int rs = d + 4;  // gathered row stride: 16-byte aligned, banks shifted
  float* s_q = smem;
  int* s_id = reinterpret_cast<int*>(s_q + kQueries * qs);
  // the row buffers start on a 16-byte boundary: queries and ids padded to 4 floats
  float* s_rows = reinterpret_cast<float*>(s_id + kRowsPerBlock) +
                  ((4 - (kQueries * qs + kRowsPerBlock) % 4) % 4);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, r_total - r0);

  for (int t = tid; t < kQueries * d; t += kThreads) {
    s_q[(t / d) * qs + t % d] = q[t];
  }
  for (int t = tid; t < rows; t += kThreads) s_id[t] = idx[r0 + t];
  __syncthreads();

  const int n_groups = (rows + group - 1) / group;
  const int words = d >> 2;  // 16-byte words per row

  // issue the copies of group g into buffer slot g % DEPTH (one warp a row)
  auto issue = [&](int g) {
    float* buf = s_rows + (g % DEPTH) * group * rs;
    const int first = g * group, count = min(group, rows - first);
    for (int j = warp; j < count; j += kThreads / 32) {
      const long long id = s_id[first + j];
      if (id < 0 || id >= n) continue;
      const float* src = corpus + id * d;
      const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(buf + j * rs));
      for (int w = lane; w < words; w += 32) cp_async16(dst + 16 * w, src + 4 * w);
    }
    cp_async_commit();
  };

  issue(0);
  for (int g = 0; g < n_groups; ++g) {
    if (DEPTH == 2 && g + 1 < n_groups) {
      issue(g + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = s_rows + (g % DEPTH) * group * rs;
    const int first = g * group, count = min(group, rows - first);
    for (int t = tid; t < count * kQueries; t += kThreads) {
      const int j = t / kQueries, qn = t % kQueries;
      const long long id = s_id[first + j];
      float acc = 0.0f;
      if (id < 0 || id >= n) {
        acc = __int_as_float(0x7fc00000);  // NaN
      } else {
        const float* row = buf + j * rs;
        const float* qr = s_q + qn * qs;
        for (int k = 0; k < d; ++k) acc = __fadd_rn(acc, __fmul_rn(qr[k], row[k]));
      }
      out[static_cast<long long>(qn) * r_total + r0 + first + j] = acc;
    }
    __syncthreads();  // every thread is done with this slot before it is refilled
    if (DEPTH == 1 && g + 1 < n_groups) issue(g + 1);
  }
}

template <int DEPTH>
cudaError_t launch(const float* q, const float* corpus, const int32_t* idx, float* out,
                   long long n, int d, int r_total, int group, cudaStream_t stream) {
  const int blocks = (r_total + kRowsPerBlock - 1) / kRowsPerBlock;
  const int head = kQueries * (d + 1) + kRowsPerBlock;
  const size_t smem =
      4 * (static_cast<size_t>(head) + (4 - head % 4) % 4 +
           static_cast<size_t>(DEPTH) * group * (d + 4));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_gather_kernel<DEPTH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  row_gather_kernel<DEPTH><<<blocks, kThreads, smem, stream>>>(q, corpus, idx, out, n, d,
                                                               r_total, group);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on ``stream`` without
// synchronizing and returns the launch's CUDA error code. ``depth`` is 1
// (``kern``) or 2 (``kern_db``); ``group`` rows are copied per group.
extern "C" int row_gather_launch(const void* q, const void* corpus, const void* idx, void* out,
                                 long long n, int d, int r_total, int group, int depth,
                                 void* stream) {
  if (n <= 0 || d <= 0 || d % 4 != 0 || r_total <= 0 || group <= 0 ||
      group > kRowsPerBlock || (depth != 1 && depth != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qq = static_cast<const float*>(q);
  const auto* c = static_cast<const float*>(corpus);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = depth == 1 ? launch<1>(qq, c, ix, o, n, d, r_total, group, s)
                                     : launch<2>(qq, c, ix, o, n, d, r_total, group, s);
  return static_cast<int>(err);
}

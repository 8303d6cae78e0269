// ivf_probe.cu — IVF probe scan for Hopper: each probed partition tile is read
// once for all the queries that probe it.
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
// What bounds it on this card: bytes. The function needs each probed
// partition once, L * (row bytes + 12) bytes, for 2 * L * D_pad operations a
// query that probes it: at the sift1m shape (L 1,032, D 128, f32) about 4
// bytes an operation pair, far below what the 67 TFLOP/s fp32 rate needs, so
// the 3.35 TB/s of device memory bounds it.
//
// What the design does about that. The TPU kernel walks (query, probe) in
// order, one partition DMA a step. Here one launch runs two kernels. The
// first sorts the M = B * nprobe probes by (partition, slot) on the device:
// a warp ranks one probe against all M, O(M^2) work that costs less than
// the ~30 small launches of a sort-based schedule up to some 16,000 probes
// (b 64 at ef 128: 4,352). Above ivf_kernel.py's SCHED_RANK_MAX
// the wrapper builds the schedule with those launches instead (torch.sort)
// and the launch skips the ranking; this file refuses to rank more than
// kRankMax probes. Either way the schedule is the plain function
// ivf_kernel.py::probe_runs's, entry for entry,
//   order  int32 [M]  entry i's (query, probe) slot b * nprobe + j
//   spid   int32 [M]  entry i's partition id, -1 where the probe id is not a
//                     partition
//   gsize  int32 [M]  the size (<= kGroup) of the group of one partition's
//                     entries starting at i, else 0
// so the queries that probe one partition sit side by side, cut into groups
// of at most kGroup. The second kernel's grid is (sorted entry, third of
// the partition's 128-row tiles); a block whose entry does not start a group
// returns at once, so the grid's blocks per entry are kept few. The others stage their group's
// queries in shared memory once, then walk their tiles: each row tile is
// copied into shared memory once, as coalesced 16-byte cp.async spans
// (4-byte ones where the row width is not a multiple of 4), the tile's
// (mul, add, pen) are fetched while it lands, and the tile is scored
// against each query of the group: one thread a row, summing in dim order
// with __fmul_rn/__fadd_rn (no FMA contraction), so the plain version's
// elementwise sum in the same order matches bit for bit. A tile row is
// padded to an odd number of 16-byte (or 4-byte) units, so a warp's row
// reads fall in distinct banks. Rows wider than 128 elements come in chunks
// of 128 (the queries then too), the sum carried in registers. An SQ8 thread
// walks its row's byte planes in turn (plane j is dims j*W .. j*W + W-1), the
// words staying in shared memory across the planes where the row fits one
// chunk; a code becomes a float through its exact 2^23 + code bit pattern.
// A partition probed by more than kGroup queries is read once a group, the
// later reads mostly from L2.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kRows = 128;    // rows of a tile, one thread each
constexpr int kGroup = 8;     // queries scored against one tile copy
constexpr int kChunk = 128;   // row elements (floats or words) a chunk
constexpr int kMaxDPad = 12288;
constexpr int kSchedWarps = 4;    // probes ranked a block, one warp each
constexpr int kTileBlocks = 3;    // blocks that share a partition's row tiles
constexpr int kRankMax = 65536;   // probes the schedule kernel ranks at most
constexpr int kMaxDevices = 64;

// The schedule: warp s ranks probe s by (partition, slot) among all m, its
// lanes counting over a stride of the probes, and writes it at that rank.
// Invalid ids sort first, as partition -1.
__global__ void __launch_bounds__(32 * kSchedWarps)
probe_schedule_kernel(const int32_t* __restrict__ probe, int m, long long n_parts,
                      int32_t* __restrict__ order, int32_t* __restrict__ spid,
                      int32_t* __restrict__ gsize) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kSchedWarps + threadIdx.x / 32;
  if (s >= m) return;  // the whole warp
  auto part = [n_parts](int p) { return (p >= 0 && p < n_parts) ? p : -1; };
  const int mine = part(__ldg(probe + s));
  int less = 0, before = 0, same = 0;
  for (int x = lane; x < m; x += 32) {
    const int p = part(__ldg(probe + x));
    less += p < mine;
    same += p == mine;
    before += (p == mine) & (x < s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    less += __shfl_xor_sync(0xffffffffu, less, o);
    same += __shfl_xor_sync(0xffffffffu, same, o);
    before += __shfl_xor_sync(0xffffffffu, before, o);
  }
  if (lane == 0) {
    const int pos = less + before;
    order[pos] = s;
    spid[pos] = mine;
    gsize[pos] = before % kGroup == 0 ? min(kGroup, same - before) : 0;
  }
}

cudaError_t launch_schedule(const int32_t* probe, int m, long long n_parts, int32_t* sched,
                            cudaStream_t stream) {
  const int blocks = (m + kSchedWarps - 1) / kSchedWarps;
  probe_schedule_kernel<<<blocks, 32 * kSchedWarps, 0, stream>>>(probe, m, n_parts, sched,
                                                                 sched + m, sched + 2 * m);
  return cudaGetLastError();
}

__device__ __forceinline__ float term(float acc, float qv, float x) {
  return __fadd_rn(acc, __fmul_rn(qv, x));
}

// Byte ``plane`` of ``v`` as an exact float: the bits of 2^23 + code, less 2^23.
__device__ __forceinline__ float code(int v, int plane) {
  const unsigned bits = __byte_perm(static_cast<unsigned>(v), 0x4B000000u, 0x7540u + plane);
  return __fsub_rn(__uint_as_float(bits), 8388608.0f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// f(r, k) for every cell of a rows x cols grid, the block's kRows threads
// taking consecutive cells (consecutive addresses along a row), with two
// divisions a call instead of two a cell.
template <typename F>
__device__ __forceinline__ void for_cells(int rows, int cols, F&& f) {
  int r = threadIdx.x / cols;
  int k = threadIdx.x - r * cols;
  const int dr = kRows / cols;
  const int dk = kRows - dr * cols;
  while (r < rows) {
    f(r, k);
    r += dr;
    k += dk;
    if (k >= cols) {
      k -= cols;
      ++r;
    }
  }
}

// Row element ``k`` of the tile: a float, or an SQ8 word's plane ``plane``.
template <bool kQuant>
__device__ __forceinline__ float elem(const float* row, int k, int plane) {
  if constexpr (kQuant) {
    return code(__float_as_int(row[k]), plane);
  } else {
    return row[k];
  }
}

template <bool kQuant, bool kVec>
__global__ void __launch_bounds__(kRows)
ivf_probe_kernel(const float* __restrict__ q, const float* __restrict__ qsum,
                 const int32_t* __restrict__ order, const int32_t* __restrict__ spid,
                 const int32_t* __restrict__ gsize, const void* __restrict__ rows,
                 const float* __restrict__ aux, float* __restrict__ out, int nprobe,
                 long long n_parts, int L, int width, int kc, int stride, int tiles_per_block) {
  // [kRows][stride] tile, then the group's queries: [kGroup][d_pad] when a row
  // fits one chunk (staged once), else [kGroup][kc] a chunk
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_slot[kGroup];
  __shared__ int s_qrow[kGroup];
  __shared__ float s_qsum[kGroup];
  const int e = blockIdx.x;
  const int g = __ldg(gsize + e);
  if (g == 0) return;  // not the start of a group
  const long long pid = __ldg(spid + e);
  const int tid = threadIdx.x;
  const int tiles = (L + kRows - 1) / kRows;
  const int t_begin = blockIdx.y * tiles_per_block;
  const int t_end = min(tiles, t_begin + tiles_per_block);
  if (tid < g) {
    const int slot = __ldg(order + e + tid);
    s_slot[tid] = slot;
    s_qrow[tid] = slot / nprobe;
    s_qsum[tid] = __ldg(qsum + slot / nprobe);
  }
  __syncthreads();
  if (pid < 0 || pid >= n_parts) {  // not a partition: every score -inf
    for (int r = t_begin * kRows + tid; r < min(L, t_end * kRows); r += kRows) {
      for (int j = 0; j < g; ++j) {
        out[static_cast<long long>(s_slot[j]) * L + r] = -__int_as_float(0x7f800000);
      }
    }
    return;
  }

  const int d_pad = kQuant ? 4 * width : width;
  float* s_tile = smem;
  float* s_q = smem + kRows * stride;
  const float* my_row = s_tile + tid * stride;
  const int n_chunks = (width + kc - 1) / kc;
  const bool whole = n_chunks == 1;  // the queries' rows staged once
  const int qstride = whole ? d_pad : kc;
  if (whole) {
    for_cells(g, d_pad, [&](int j, int k) {
      s_q[j * d_pad + k] = q[static_cast<long long>(s_qrow[j]) * d_pad + k];
    });
  }
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int r0 = tile * kRows;
    const int nr = min(kRows, L - r0);
    const float* src = static_cast<const float*>(rows) + (pid * L + r0) * width;  // words as floats
    float acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j] = 0.0f;
    float mul = 0.0f, add = 0.0f, pen = 0.0f;

    for (int plane = 0; plane < (kQuant ? 4 : 1); ++plane) {
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int c0 = ch * kc;
        const int cn = min(kc, width - c0);
        if (plane == 0 || !whole) {
          __syncthreads();  // the previous tile's or chunk's reads are done
          if constexpr (kVec) {
            for_cells(nr, cn / 4, [&](int r, int k) {
              cp_async16(s_tile + r * stride + 4 * k,
                         src + static_cast<long long>(r) * width + c0 + 4 * k);
            });
          } else {
            for_cells(nr, cn, [&](int r, int k) {
              cp_async4(s_tile + r * stride + k, src + static_cast<long long>(r) * width + c0 + k);
            });
          }
          if (!whole) {
            for_cells(g, cn, [&](int j, int k) {
              s_q[j * kc + k] = q[static_cast<long long>(s_qrow[j]) * d_pad + plane * width + c0 + k];
            });
          }
          if (plane == 0 && ch == 0 && tid < nr) {  // the epilogue's operands, fetched early
            const float* ap = aux + pid * 3 * L + r0 + tid;
            mul = __ldg(ap);
            add = __ldg(ap + L);
            pen = __ldg(ap + 2 * static_cast<long long>(L));
          }
          cp_async_wait_all();
          __syncthreads();
        }
        const float* qb = s_q + (whole ? plane * width : 0);
        if (tid < nr) {
          if constexpr (kVec) {
            for (int k = 0; k < cn; k += 4) {
              const float4 v = *reinterpret_cast<const float4*>(my_row + k);
              const float x0 = kQuant ? code(__float_as_int(v.x), plane) : v.x;
              const float x1 = kQuant ? code(__float_as_int(v.y), plane) : v.y;
              const float x2 = kQuant ? code(__float_as_int(v.z), plane) : v.z;
              const float x3 = kQuant ? code(__float_as_int(v.w), plane) : v.w;
#pragma unroll
              for (int j = 0; j < kGroup; ++j) {
                if (j < g) {
                  const float4 qv = *reinterpret_cast<const float4*>(qb + j * qstride + k);
                  acc[j] = term(term(term(term(acc[j], qv.x, x0), qv.y, x1), qv.z, x2), qv.w, x3);
                }
              }
            }
          } else {
            for (int k = 0; k < cn; ++k) {
              const float x = elem<kQuant>(my_row, k, plane);
#pragma unroll
              for (int j = 0; j < kGroup; ++j) {
                if (j < g) acc[j] = term(acc[j], qb[j * qstride + k], x);
              }
            }
          }
        }
      }
    }

    if (tid < nr) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < g) {
          const float t = __fadd_rn(__fmul_rn(acc[j], mul), __fmul_rn(s_qsum[j], add));
          out[static_cast<long long>(s_slot[j]) * L + r0 + tid] = __fsub_rn(t, pen);
        }
      }
    }
  }
}

template <bool kQuant, bool kVec>
cudaError_t launch(const float* q, const float* qsum, const int32_t* probe, const void* rows,
                   const float* aux, int32_t* sched, float* out, int m, int nprobe,
                   long long n_parts, int L, int width, bool sched_ready, cudaStream_t stream) {
  const int tiles = (L + kRows - 1) / kRows;
  if (!sched_ready) {
    const cudaError_t se = launch_schedule(probe, m, n_parts, sched, stream);
    if (se != cudaSuccess) return se;
  }
  // a chunk of at most 128 elements, its rows padded to an odd count of
  // 16-byte units (vector reads) or 4-byte words (scalar reads)
  const int kc = width < kChunk ? width : kChunk;
  const int stride = kVec ? 4 * ((kc / 4) | 1) : (kc | 1);
  const int n_chunks = (width + kc - 1) / kc;
  const int qcols = n_chunks == 1 ? (kQuant ? 4 * width : width) : kc;
  const size_t smem = (static_cast<size_t>(kRows) * stride + static_cast<size_t>(kGroup) * qcols) *
                      sizeof(float);
  // Above 48 KB the kernel's shared-memory limit is raised once per device
  // (and again only for a larger tile), not on every launch:
  // cudaFuncSetAttribute is a driver call that every search would otherwise
  // pay.
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return cudaErrorInvalidDevice;
  }
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(ivf_probe_kernel<kQuant, kVec>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    allowed[dev] = smem;
  }
  const int ty = tiles < kTileBlocks ? tiles : kTileBlocks;
  const dim3 grid(static_cast<unsigned>(m), static_cast<unsigned>(ty));
  ivf_probe_kernel<kQuant, kVec><<<grid, kRows, smem, stream>>>(
      q, qsum, sched, sched + m, sched + 2 * m, rows, aux, out, nprobe, n_parts, L, width, kc,
      stride, (tiles + ty - 1) / ty);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on ``stream`` without
// synchronizing and returns the launch's CUDA error code.
//
// ``sched`` int32 [3, m] (m = B * nprobe) holds the schedule (order, spid,
// gsize) in groups of kGroup: when ``sched_ready`` is 0 the schedule kernel
// writes it there first (m <= kRankMax), when 1 the caller has. Then the
// scan writes ``out``. ``width`` is the row width in elements: words
// (D_pad / 4) when ``quant`` is 1, floats (D_pad) when 0. 16-byte copies are
// taken when ``width`` is a multiple of 4 (every row then starts 16-byte
// aligned: the wrapper hands in aligned bases).
extern "C" int ivf_probe_launch(const void* q, const void* qsum, const void* probe,
                                const void* rows, const void* aux, void* sched, void* out, int m,
                                int nprobe, long long n_parts, int L, int width, int quant,
                                int sched_ready, void* stream) {
  const int d_pad = quant ? 4 * width : width;
  if (m <= 0 || nprobe <= 0 || m % nprobe != 0 || n_parts <= 0 || L <= 0 || width <= 0 ||
      d_pad > kMaxDPad || (!sched_ready && m > kRankMax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* qs = static_cast<const float*>(qsum);
  const auto* pr = static_cast<const int32_t*>(probe);
  const auto* ax = static_cast<const float*>(aux);
  auto* sc = static_cast<int32_t*>(sched);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = width % 4 == 0;
  cudaError_t err;
  if (quant) {
    err = vec ? launch<true, true>(qf, qs, pr, rows, ax, sc, o, m, nprobe, n_parts, L, width,
                                   sched_ready, s)
              : launch<true, false>(qf, qs, pr, rows, ax, sc, o, m, nprobe, n_parts, L, width,
                                    sched_ready, s);
  } else {
    err = vec ? launch<false, true>(qf, qs, pr, rows, ax, sc, o, m, nprobe, n_parts, L, width,
                                    sched_ready, s)
              : launch<false, false>(qf, qs, pr, rows, ax, sc, o, m, nprobe, n_parts, L, width,
                                     sched_ready, s);
  }
  return static_cast<int>(err);
}

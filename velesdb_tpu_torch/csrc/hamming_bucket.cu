// hamming_bucket.cu — the packed Hamming bucket scan (#4) on Hopper's int8
// tensor cores.
//
// Replaces velesdb_tpu/ops/bucket_kernel.py::_hamming_kernel (the Pallas
// kernel launched by hamming_bucket_topk). Same contract, bit for bit against
// the plain torch version hamming_bucket_ref:
//
//   inputs   q       int32 [B_pad, W]  packed query sign bits (uint32 words),
//                                      1 <= W <= 256
//            packed  int32 [N, W]      packed corpus sign bits
//            pen     f32   [N]         0 on valid rows, +inf on knocked-out
//                                      ones (any f32 is taken)
//   output   gm  f32   [B_pad, (N / chunk) * 128]
//            gi  int32 [B_pad, (N / chunk) * 128]
//   s[b, r]  = -float(popc(q[b] ^ packed[r])) - pen[r]
//   gm[b, c*128 + j] = max over slices i of s[b, c*chunk + i*128 + j], gi its
//   row; ties go to the smallest slice, a bucket of -inf returns slice 0.
//   chunk is a multiple of 128, at most 8,192, and divides N; q, packed and
//   pen start 16-byte aligned.
//
// The distance as an int8 product. Each word unpacks into 32 int8 values, the
// corpus's bits as 0/1 and the query's as +-1, one bit a K position of one
// wgmma k32 step (m64nNk32.s32.s8.s8: one word a K step):
//   sum over bits of c (q ? 1 : -1) = |q & c| - |~q & c| = |q| - popc(q ^ c)
// so the s32 dot gives the distance with one per-query constant, |q|, and no
// per-row one. Any bijection of bits onto K positions serves while the query
// and the corpus share it, so the kernel takes the one its unpack makes
// cheapest. In the A operand's register fragment lane l of a warp holds K
// positions 4 (l % 4) .. + 3 and 16 + 4 (l % 4) .. + 3 of its two rows; they
// carry bits 8 b + l % 4 and 8 b + 4 + l % 4 (b = 0 .. 3) of the word x, so
//   (x >> l % 4) & 0x01010101   and   (x >> l % 4) & 0x10101010
// are the lane's two registers of x: three integer operations a (row, word).
// The second register's bytes are 16 where a bit is set, not 1, so the
// query's bytes are +-4 at those K positions and +-64 at the others: every
// product is 64 c (q ? 1 : -1) and the dot is 64 (|q| - d), exact in any
// order (|dot| <= 64 * 8,192 = 2^19), its low 6 bits zero.
//
// The select. A row whose penalty is +0.0 scores -d, one at +inf -inf. Where
// a thread's rows carry only those two penalties (every row a serve path
// passes), its running max of a (row lane, query) is one int32 key, the
// slice in the dot's free low bits:
//   key = max(key, dot + (63 - slice))    pen +0.0
//   key = max(key, dot - 2^21)            pen +inf
// one DPX instruction a score (__viaddmax_s32). A larger key is a smaller
// distance, then a smaller slice; every valid row beats every knocked-out
// one, so a key below -2^20 means a bucket of knocked-out rows only: -inf
// at slice 0. gm and gi are decoded once a chunk: the int bits 0x4B000000
// + d are the float 2^23 + d, less 2^23 exactly float(d), so gm =
// -float(d) - 0.0 as the plain version rounds it. A thread that meets any
// other penalty turns its keys into (float max, slice byte) pairs and
// finishes the chunk on the float select, v = -float(d) - pen with a strict
// >: the same values in the same order.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1,979 int8 TOPS). At W 4
// (glove100 BINARY: B_pad 256, N 1,310,720, chunk 2,048) the gm / gi writes,
// 8 B a (query, bucket), 168 MB: 0.0579 ms of bytes against 0.035 ms of
// products. At W 8 (hamming-1m-256b: B_pad 256, N 1,048,576) the products,
// 2 * 256 * N * 256 int8 operations and one fp32 operation a distance:
// 0.0735 ms.
//
// What the design does about that: #5's pipeline on the packed words.
// - The products run on the tensor cores with A from registers: the rows are
//   never unpacked into shared memory, the tensor cores read only the query
//   tile (B) there, and the unpack costs three integer operations a (row,
//   word, query tile).
// - Persistent blocks, one a multiprocessor: a block owns one query tile of
//   NQ = 8 .. 64 queries (B: unpacked once, K-major, 128-byte swizzle) and
//   walks every (gridDim / query tiles)-th chunk, so the tiles of a chunk run
//   side by side and it comes from device memory once; 256 threads, two
//   warpgroups, warpgroup w multiplying rows 64 w .. 64 w + 63 of a slice.
// - The packed words (4 B a word: an eighth of #5's 1 byte/bit shadow) and
//   the penalties stream through a ring of 16 stages of 128 rows x 4 words
//   with cp.async, across chunk boundaries, each warp copying and reading
//   its own 16 rows (no block-wide barrier in the loop).
// - Two blocks a multiprocessor (128 registers a thread at NQ 64): one
//   block's select runs while the other's products do. Within a block a
//   slice's steps wait for each other and the select for them: ptxas
//   serializes every wgmma of the kernel where a group stays in flight
//   across a loop's back edge or a register of a group in flight is touched
//   (C7513 / C7514), which the first designs, overlapping a slice's
//   products with the select of the one before on two accumulator sets,
//   ran into.
// - The integer select above, gm / gi written once a chunk from registers:
//   the [B, N] distance tile never exists.
// W 256 launches at NQ 16 (a 128 KB query tile, one block a
// multiprocessor).
//
// What it leaves on the table (NVIDIA H100 80GB HBM3, 700 W; PERF.md row
// #4): about 0.16 ms at W 4 and 0.20 at W 8 (B_pad 256), under 0.4 of the
// bound. Each slice's chain (copy, unpack, wgmma, wait, select) waits on its
// own latencies and the two blocks of a multiprocessor cover only part of
// them; the gm / gi writes come in a burst at each chunk's end. One block a
// multiprocessor on two accumulator sets (222 registers) measured 0.18 /
// 0.23 ms; smaller query tiles, a DPX-free select and a block-wide ring
// measured no faster.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;                         // two warpgroups
constexpr int kLanes = 128;                           // bucket lanes = rows of a slice
constexpr int kStepWords = 4;                         // words a step: one 128-byte K block
constexpr int kRing = 16;                             // ring stages, a power of two
constexpr int kWordBytes = kLanes * kStepWords * 4;   // a stage's words, 16 B a row
constexpr int kStageBytes = kWordBytes + kLanes * 4;  // and its slice's penalties
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;
constexpr int kMaxWords = 256;
constexpr int kKnock = 1 << 21;         // a knocked-out row's key: dot - kKnock
constexpr int kKeyInit = INT_MIN + 63;  // below every key; decodes to (-inf, slice 0)
constexpr uint32_t kLo = 0x01010101u;   // bit 0 of each byte
constexpr uint32_t kHi = 0x10101010u;   // bit 4 of each byte
constexpr uint32_t kMagic = 0x4B000000u;  // the float 2^23
constexpr uint32_t kInfBits = 0x7F800000u;

// Keeps the compiler from giving an A register set's registers other values
// while a wgmma may still read them.
template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// Steps (K blocks of 4 words) a slice.
__host__ __device__ __forceinline__ int slice_steps(int w) {
  return (w + kStepWords - 1) / kStepWords;
}

// float(d), exactly, from the int bits kMagic + d (the float 2^23 + d).
__device__ __forceinline__ float dist_of(uint32_t z) {
  return __fsub_rn(__uint_as_float(z), 8388608.0f);
}

// Whether a key is a knocked-out row's (or none yet): its bucket holds no
// valid row so far.
__device__ __forceinline__ bool knocked(int key) { return key < -(kKnock >> 1); }

// A key's score and slice: (-inf, 0) for a bucket of knocked-out rows, else
// (-float(d), 63 - the low 6 bits) with d = |q| - dot / 64 (cq = kMagic + |q|).
__device__ __forceinline__ float key_score(int key, uint32_t cq) {
  if (knocked(key)) return -__int_as_float(0x7f800000);
  return -dist_of(cq - static_cast<uint32_t>(key >> 6));
}
__device__ __forceinline__ int key_slice(int key) { return knocked(key) ? 0 : 63 - (key & 63); }

// The query bytes at K positions 16 h + 4 jj .. + 3 of a word: bit
// 8 b + 4 h + jj as +-64 (h = 0) or +-4 (h = 1), byte b of the result.
__device__ __forceinline__ uint32_t query_bytes(uint32_t word, int h, int jj) {
  const uint32_t t = (word >> (4 * h + jj)) & kLo;
  return h ? ((t << 2) | ((t ^ kLo) * 0xFCu)) : ((t << 6) | ((t ^ kLo) * 0xC0u));
}

template <int NQ, int kSteps>
__global__ void __launch_bounds__(kThreads, 2)
hamming_tc_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ packed,
                  const float* __restrict__ pen, float* __restrict__ gm,
                  int32_t* __restrict__ gi, int b_pad, int w, int chunk, int n_qtiles,
                  int n_chunks, long long n_buckets) {
  constexpr int R = NQ / 2;  // accumulators a set: two rows x NQ/4 queries
  constexpr int M = NQ / 8;  // slice-byte words of the float select
  constexpr int A = 4 * kStepWords;  // A registers a set: four a word
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the query tile starts 1024-byte aligned in the shared window (the
  // swizzle's repeat), so the launch asks for 1 KB more than it uses
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024u - (raw_addr & 1023u)) & 1023u);
  const int steps = kSteps ? kSteps : slice_steps(w);  // a slice's steps (K blocks)
  // steps x [NQ][128 B] query blocks, kRing x [words | penalties] stages,
  // then kMagic + |q| a query
  unsigned char* s_q = smem;
  unsigned char* s_ring = s_q + steps * NQ * 128;
  uint32_t* s_cq = reinterpret_cast<uint32_t*>(s_ring + kRing * kStageBytes);
  const uint32_t q_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_q));
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_ring));

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // rows 64 wg .. 64 wg + 63 of each slice
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int j = lane % 4;
  const int lr = 64 * wg + 16 * warp + lane / 4;  // this thread's rows lr and lr + 8
  const int q0 = (blockIdx.x % n_qtiles) * NQ;
  const int c0 = blockIdx.x / n_qtiles;
  const int c_step = gridDim.x / n_qtiles;
  const int slices = chunk / kLanes;
  const int n_slices = (n_chunks - c0 + c_step - 1) / c_step * slices;
  const int n_steps = n_slices * steps;
  const bool vec = w % kStepWords == 0;  // rows of whole 16-byte vectors

  // The ring: step t carries words 4 kb .. 4 kb + 3 of the 128 rows of one
  // slice (16 B a row), and at kb 0 the slice's penalties. Each warp copies
  // and reads only its own 16 rows (a thread's rows lr and lr + 8 are its
  // warp's), so a step needs no barrier wider than the warp. The loader runs
  // kRing - 1 steps ahead of the tensor cores, on its own cursor.
  const int wr = 16 * (tid / 32);  // the warp's first row of a slice
  int ld_t = 0, ld_kb = 0, ld_s = 0, ld_c = c0;
  auto load_next = [&]() {
    if (ld_t < n_steps) {
      const uint32_t dst = ring_addr + static_cast<uint32_t>((ld_t & (kRing - 1)) * kStageBytes);
      const long long r0 = static_cast<long long>(ld_c) * chunk + ld_s * kLanes + wr;
      const int k0 = ld_kb * kStepWords;
      if (vec) {
        if (lane < 16) {
          cp_async16(dst + (wr + lane) * 16, packed + (r0 + lane) * w + k0, 16);
        }
      } else {
        const int kw = min(kStepWords, w - k0);
#pragma unroll
        for (int x = lane; x < 16 * kStepWords; x += 32) {
          const int r = x / kStepWords;
          const int k = x % kStepWords;
          if (k < kw) cp_async4(dst + (wr + r) * 16 + k * 4, packed + (r0 + r) * w + k0 + k);
        }
      }
      if (ld_kb == 0 && lane >= 16 && lane < 20) {
        const int x = lane - 16;
        cp_async16(dst + kWordBytes + (wr + 4 * x) * 4, pen + r0 + 4 * x, 16);
      }
      if (++ld_kb == steps) {
        ld_kb = 0;
        if (++ld_s == slices) {
          ld_s = 0;
          ld_c += c_step;
        }
      }
    }
    cp_async_commit();
    ++ld_t;
  };
#pragma unroll 1
  for (int t = 0; t < kRing - 1; ++t) load_next();

  // The query tile, zero past B_pad and W, swizzled as wgmma's B: 16-byte
  // chunk ch of a query's K block kb is half ch % 2 of word 4 kb + ch / 2.
  for (int x = tid; x < steps * NQ * 8; x += kThreads) {
    const int kb = x / (NQ * 8);
    const int n = (x / 8) % NQ;
    const int ch = x % 8;
    const int k = kb * kStepWords + ch / 2;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + n < b_pad && k < w) {
      const uint32_t word = q[static_cast<long long>(q0 + n) * w + k];
      const int h = ch & 1;
      v = make_uint4(query_bytes(word, h, 0), query_bytes(word, h, 1), query_bytes(word, h, 2),
                     query_bytes(word, h, 3));
    }
    *reinterpret_cast<uint4*>(s_q + kb * NQ * 128 + swz(n, ch)) = v;
  }
  for (int n = tid / 32; n < NQ; n += kThreads / 32) {
    int ones = 0;
    if (q0 + n < b_pad) {
      for (int k = lane; k < w; k += 32) {
        ones += __popc(q[static_cast<long long>(q0 + n) * w + k]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ones += __shfl_xor_sync(0xFFFFFFFFu, ones, o);
    if (lane == 0) s_cq[n] = kMagic + static_cast<uint32_t>(ones);
  }
  fence_async_smem();  // the query tile, visible to the tensor cores
  __syncthreads();

  int acc[R];
  uint32_t a[A];  // the A operand of one step
  int kx[R];  // the running keys, or the float maxima's bits
  unsigned mi[M];
  bool gen = false;  // this thread runs the float select for the rest of the chunk
  float pl = 0.0f, ph = 0.0f;  // the slice's penalties of rows lr and lr + 8
#pragma unroll
  for (int i = 0; i < R; ++i) {
    acc[i] = 0;
    kx[i] = kKeyInit;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) mi[i] = 0u;

  // acc[4i + 2h + e]: row lr + 8h, query 8i + 2 (lane % 4) + e
  auto col_of = [&](int i) { return 8 * (i / 4) + 2 * j + (i & 1); };
  int ep_s = 0, ep_c = c0;  // the select's slice and chunk

  auto write_out = [&]() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int col = col_of(i);
      const int row = lr + ((i & 2) ? 8 : 0);
      if (q0 + col < b_pad) {
        float v;
        int slice;
        if (gen) {
          v = __int_as_float(kx[i]);
          slice = static_cast<int>((mi[i / 4] >> (8 * (i % 4))) & 0xFFu);
        } else {
          v = key_score(kx[i], s_cq[col]);
          slice = key_slice(kx[i]);
        }
        const long long off = static_cast<long long>(q0 + col) * n_buckets +
                              static_cast<long long>(ep_c) * kLanes + row;
        gm[off] = v;
        gi[off] = ep_c * chunk + slice * kLanes + row;
      }
      kx[i] = kKeyInit;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) mi[i] = 0u;
    gen = false;
  };

  // Slice ep_s's products into the running select, then past the chunk's
  // last slice, gm / gi.
  auto take = [&](const int (&acc)[R], float p_lo, float p_hi) {
    const uint32_t bl = __float_as_uint(p_lo);
    const uint32_t bh = __float_as_uint(p_hi);
    if (!gen && ((bl != 0u && bl != kInfBits) || (bh != 0u && bh != kInfBits))) {
#pragma unroll
      for (int i = 0; i < R; ++i) {  // the keys so far, as (float max, slice)
        const int slice = key_slice(kx[i]);
        kx[i] = __float_as_int(key_score(kx[i], s_cq[col_of(i)]));
        mi[i / 4] = __byte_perm(mi[i / 4], static_cast<unsigned>(slice), put_byte_sel(i % 4));
      }
      gen = true;
    }
    if (!gen) {
      const int rl = bl ? -kKnock : 63 - ep_s;
      const int rh = bh ? -kKnock : 63 - ep_s;
#pragma unroll
      for (int i = 0; i < R; ++i) kx[i] = __viaddmax_s32(acc[i], (i & 2) ? rh : rl, kx[i]);
    } else {
      const unsigned sb = static_cast<unsigned>(ep_s);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const uint32_t z = s_cq[col_of(i)] - static_cast<uint32_t>(acc[i] >> 6);
        const float v = __fsub_rn(-dist_of(z), (i & 2) ? p_hi : p_lo);
        if (v > __int_as_float(kx[i])) {
          kx[i] = __float_as_int(v);
          mi[i / 4] = __byte_perm(mi[i / 4], sb, put_byte_sel(i % 4));
        }
      }
    }
    if (++ep_s == slices) {
      write_out();
      ep_s = 0;
      ep_c += c_step;
    }
  };

  // One step: K block kb of a slice into the accumulators. FIRST: kb is 0
  // (the slice's penalties; its products start from zero).
  int t = 0;
  auto step = [&](auto first_, int kb) {
    constexpr bool kFirst = decltype(first_)::value;
    cp_async_wait<kRing - 2>();
    __syncwarp();  // step t landed for the warp's lanes; they are done with step t - 1's
    load_next();
    const unsigned char* st = s_ring + (t & (kRing - 1)) * kStageBytes;
    const uint4 xl = *reinterpret_cast<const uint4*>(st + lr * 16);
    const uint4 xh = *reinterpret_cast<const uint4*>(st + (lr + 8) * 16);
    if constexpr (kFirst) {
      pl = *reinterpret_cast<const float*>(st + kWordBytes + 4 * lr);
      ph = *reinterpret_cast<const float*>(st + kWordBytes + 4 * (lr + 8));
    }
    // words past W hold whatever the stage held: the query's bytes there
    // are zero, so they add nothing
    const uint32_t lo[4] = {xl.x, xl.y, xl.z, xl.w};
    const uint32_t hi[4] = {xh.x, xh.y, xh.z, xh.w};
#pragma unroll
    for (int k = 0; k < kStepWords; ++k) {
      const uint32_t tl = lo[k] >> j;
      const uint32_t th = hi[k] >> j;
      a[4 * k] = tl & kLo;
      a[4 * k + 1] = th & kLo;
      a[4 * k + 2] = tl & kHi;
      a[4 * k + 3] = th & kHi;
    }
    const uint32_t b0 = q_addr + static_cast<uint32_t>(kb * NQ * 128);
    if constexpr (kFirst) fence_regs<R>(acc);  // no group is in flight
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kStepWords; ++k) {
      wgmma_s8_rs<NQ>(acc, a + 4 * k, smem_desc(b0 + 32 * k), (kFirst && k == 0) ? 0 : 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    ++t;
  };
  // Until a group is done its A registers may not change, nor its
  // accumulators be read.
  auto wait_all = [&]() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_a(a);
  };

  // A slice: its steps, each waiting for the one before (they share the A
  // registers), then the wait for the last and the select. The other block
  // on the multiprocessor runs its products while this one selects. Every
  // condition around a wgmma is a compile-time one or a loop, and no group
  // stays in flight across a back edge: ptxas serializes the wgmma of the
  // kernel otherwise.
  using Yes = std::true_type;
  using No = std::false_type;
#pragma unroll 1
  for (int u = 0; u < n_slices; ++u) {
    step(Yes{}, 0);
    if constexpr (kSteps == 2) {
      wait_all();
      step(No{}, 1);
    } else if constexpr (kSteps == 0) {
#pragma unroll 1
      for (int kb = 1; kb < steps; ++kb) {
        wait_all();
        step(No{}, kb);
      }
    }
    wait_all();
    fence_regs<R>(acc);
    take(acc, pl, ph);
  }
  cp_async_wait<0>();
}

size_t smem_bytes(int nq, int w) {
  const int steps = slice_steps(w);
  return 1024 + static_cast<size_t>(steps) * nq * 128 +
         static_cast<size_t>(kRing) * kStageBytes + 4 * static_cast<size_t>(nq);
}

// One block a multiprocessor (as many as fit), dealt over the query tiles:
// each tile's blocks split the chunks between them.
template <int NQ, int kSteps>
cudaError_t launch(const uint32_t* q, const uint32_t* packed, const float* pen, float* gm,
                   int32_t* gi, int b_pad, long long n, int w, int chunk,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(NQ, w);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  // The shared-memory limit, the multiprocessor count and the blocks a
  // multiprocessor holds are asked once per device (and again only for a
  // larger tile), not on every launch: each is a driver call.
  static size_t allowed[kMaxDevices] = {};
  static size_t sized[kMaxDevices] = {};
  static int resident[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return cudaErrorInvalidDevice;
  }
  cudaError_t e;
  if (smem > allowed[dev]) {
    e = cudaFuncSetAttribute(hamming_tc_kernel<NQ, kSteps>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    allowed[dev] = smem;
  }
  if (sized[dev] != smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
      return e;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hamming_tc_kernel<NQ, kSteps>,
                                                      kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
    sized[dev] = smem;
  }
  const int n_qtiles = (b_pad + NQ - 1) / NQ;
  const long long n_chunks = n / chunk;
  long long per_tile = resident[dev] / n_qtiles;
  if (per_tile < 1) per_tile = 1;
  if (per_tile > n_chunks) per_tile = n_chunks;
  const long long blocks = per_tile * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  hamming_tc_kernel<NQ, kSteps><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, packed, pen, gm, gi, b_pad, w, chunk, n_qtiles, static_cast<int>(n_chunks),
      n_chunks * kLanes);
  return cudaGetLastError();
}

template <int NQ>
cudaError_t launch_words(const uint32_t* q, const uint32_t* packed, const float* pen, float* gm,
                         int32_t* gi, int b_pad, long long n, int w, int chunk,
                         cudaStream_t stream) {
  const int steps = slice_steps(w);
  if (steps == 1) return launch<NQ, 1>(q, packed, pen, gm, gi, b_pad, n, w, chunk, stream);
  if (steps == 2) return launch<NQ, 2>(q, packed, pen, gm, gi, b_pad, n, w, chunk, stream);
  return launch<NQ, 0>(q, packed, pen, gm, gi, b_pad, n, w, chunk, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on ``stream`` without
// synchronizing and returns the launch's CUDA error code. The query tile is
// the smallest of 8 .. 64 that holds the batch, then the largest whose bytes
// fit beside the ring (NQ 16 at W 256).
extern "C" int hamming_bucket_launch(const void* q, const void* packed, const void* pen,
                                     void* gm, void* gi, int b_pad, long long n, int w,
                                     int chunk, void* stream) {
  if (b_pad <= 0 || n <= 0 || w <= 0 || w > kMaxWords || chunk <= 0 || chunk % kLanes != 0 ||
      chunk > 8192 || n % chunk != 0 || n > INT_MAX ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || reinterpret_cast<uintptr_t>(packed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pen) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qw = static_cast<const uint32_t*>(q);
  const auto* cw = static_cast<const uint32_t*>(packed);
  const auto* p = static_cast<const float*>(pen);
  auto* m = static_cast<float*>(gm);
  auto* g = static_cast<int32_t*>(gi);
  auto s = static_cast<cudaStream_t>(stream);
  int nq = b_pad <= 8 ? 8 : b_pad <= 16 ? 16 : b_pad <= 32 ? 32 : 64;
  while (nq > 8 && smem_bytes(nq, w) > kSmemLimit) nq /= 2;
  cudaError_t err;
  switch (nq) {
    case 8: err = launch_words<8>(qw, cw, p, m, g, b_pad, n, w, chunk, s); break;
    case 16: err = launch_words<16>(qw, cw, p, m, g, b_pad, n, w, chunk, s); break;
    case 32: err = launch_words<32>(qw, cw, p, m, g, b_pad, n, w, chunk, s); break;
    default: err = launch_words<64>(qw, cw, p, m, g, b_pad, n, w, chunk, s);
  }
  return static_cast<int>(err);
}

// Gather-GEMM on the tensor cores: the device core shared by the sparse
// convolution's forward (K6 over an implicit map, K12 over an index table)
// and the dX of its backward (K7), for Hopper (sm_90a).
//
//   out[i, :] = sum_k a[row(k, i), :] @ B_k          (zero where none)
//
// with row(k, i) resolved by a template parameter: a binary search of
// qkey[k, i] in the sorted keys (find_key over skeys / srow), or a read of
// an index table. B_k is W[k] ([depth, width], the forward) or, for dX
// through the reverse map, W[K-1-k]^T read by index arithmetic from W
// ([K][width][depth]): nothing is flipped or copied on the host.
//
// What bounds these convolutions on this card: the products. A row of the
// train step's same-level conv matches 5.7 of its 27 offsets, yet nearly
// every (64-row tile, offset) pair has a match, so a kernel that computes
// every row of a tile for each offset that matches any of them executes
// 2.3-2.6x the matched work; and float32 FMAs on the CUDA cores peak at
// 67 TFLOP/s. What the design does about it:
//
// * Compaction. A block owns 64 output rows. It resolves the rows of up to
//   32 offsets at once and compacts, per offset, the matched ones into a
//   list of (tile row, input row) with __ballot_sync / __popc; an offset
//   with an empty list is skipped. Only the list's rows, padded to a
//   multiple of 16 (one mma fragment), are gathered and multiplied.
// * The full output width per block (up to 256 columns; a wider output,
//   the 384-wide dX of the 384 -> 128 conv, splits over grid.y into two
//   256-column slices, half of the second past the width and idle), so
//   every gathered row is read once per block and not once per 64-column
//   tile.
// * Split TF32 ("3xTF32") on the tensor cores: a = hi + lo with
//   hi = tf32(a), lo = tf32(a - hi), and D += lo*hi' + hi*lo' + hi*hi',
//   three mma.sync.m16n8k8 per product with float32 accumulation. That
//   keeps float32 accuracy (the dropped lo*lo' is ~2^-22 of a product) at
//   the TF32 tensor-core rate; plain TF32 would miss the 1e-4 gates.
// * mma.sync and not wgmma: a compacted list holds ~14-27 rows per offset,
//   and wgmma's 64-row tiles would spend on zero rows what compaction
//   saves. TMA copies boxes of a tensor, not lists of rows, so the gather
//   is cp.async: 16-byte copies (4-byte where a row is not 16-byte
//   aligned) into a ring of stages of 32 input channels each (three where
//   shared memory allows as many blocks per SM as with two, else two),
//   the next stages' gathers in flight while one multiplies. A thread
//   resolves its rows' keys eight at a time in lockstep, so that their
//   dependent loads overlap.
// * The offset's product (registers, in fragment-row order) is added into
//   an accumulator in shared memory at its tile rows; within one offset a
//   tile row appears at most once, so the adds never collide, and offsets
//   come in order: no atomics, and the result repeats bit for bit. The
//   block stores its tile once.
//
// For checks, a source's launches can count the rows they multiply: after
// set_row_counter(p), every block adds the rows of the mma fragments it
// ran (per offset, the compacted list rounded up to 16) to *p; the first
// column slice of a split output counts, the others not.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_search.cuh"

namespace gg {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTileM = 64;     // output rows per block
constexpr int kChunk = 32;     // depth (input channels) per stage
constexpr int kLdA = kChunk + 4;  // row stride of a staged a / B^T tile
constexpr int kBatch = 32;     // offsets resolved at once
constexpr int kMaxWidth = 256;  // output columns per block

// ---- PTX helpers -------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// d += a @ b, m16n8k8, TF32 inputs, float32 accumulation
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a @ b in split TF32: the small terms first
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void zero4(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Four consecutive floats src[0..3] into dst[0..3] (16-byte aligned in
// shared memory): one 16-byte copy when vec (src 16-byte aligned, all four
// in range), else a 4-byte copy for each of the first n_ok and zeros after.
__device__ __forceinline__ void copy4(float* dst, const float* src, int n_ok,
                                      bool vec) {
  if (vec) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < n_ok) {
      cp_async4(dst + q, src + q);
    } else {
      dst[q] = 0.f;
    }
  }
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Positions in keys[0, n) (sorted ascending, signed) of the keys equal to
// q[0..N-1], -1 where absent: N lower-bound searches in lockstep, so that
// their dependent loads overlap (a lone search waits on ~19 of them in
// turn).
template <int N>
__device__ __forceinline__ void find_keys(const int* __restrict__ keys,
                                          int n, const int* q, int* pos) {
  int lo[N];
#pragma unroll
  for (int i = 0; i < N; ++i) lo[i] = 0;  // count of keys < q[i]
  if (n > 0) {
    for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int c = lo[i] + step;
        if (c <= n && __ldg(keys + c - 1) < q[i]) lo[i] = c;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    pos[i] = (lo[i] < n && __ldg(keys + lo[i]) == q[i]) ? lo[i] : -1;
  }
}

// Row stride of the accumulator and of a staged [kChunk][nb] B tile:
// congruent to 8 mod 32 floats, so a fragment's 32 lanes hit 32 banks.
__host__ __device__ constexpr int ld_wide(int nb) { return nb + 8; }

__host__ __device__ constexpr int stage_floats(int nb, bool bt) {
  return kTileM * kLdA + (bt ? nb * kLdA : kChunk * ld_wide(nb));
}

__host__ __device__ constexpr size_t smem_bytes(int nb, bool bt,
                                                int stages) {
  return sizeof(float) *
             (size_t)(kTileM * ld_wide(nb) + stages * stage_floats(nb, bt)) +
         sizeof(int) * (size_t)(kBatch * kTileM + 2 * kBatch + kBatch + 2);
}

// Where this source's launches count their multiplied rows; nullptr: not
// counted (static: each source that includes this header has its own).
static __device__ unsigned long long* row_counter = nullptr;

// Host: point this source's row counter at p (a device address, or nullptr
// to stop counting). Synchronous; returns a cudaError_t as int.
static inline int set_row_counter(unsigned long long* p) {
  return static_cast<int>(cudaMemcpyToSymbol(row_counter, &p, sizeof(p)));
}

// ---- the kernel --------------------------------------------------------

// kTable false: qkey holds packed query keys, resolved against skeys /
// srow (n_keys of them). kTable true: qkey holds rows of a, valid in
// [0, n_keys) where n_keys is a's row count; skeys and srow are not read.
// a has fewer than 2^26 rows: a list entry packs the row beside the 6-bit
// tile row.
// kBT false: b is W [kvol][depth][width] and B_k = W[k]. kBT true: b is W
// [kvol][width][depth] and B_k = W[kvol-1-k]^T.
// nb: the block's output columns (a power of two, 32 to kMaxWidth); the
// block covers [blockIdx.y * nb, +nb) of [0, width). kMF: the most 16-row
// fragments a warp multiplies per offset, 4 / (warps along the rows); it
// sizes the registers that hold an offset's product. kStages: buffers in
// the cp.async ring (2 or 3, whichever keeps more stages in flight per SM).
template <bool kTable, bool kBT, int kMF, int kStages>
__global__ void __launch_bounds__(kThreads, kMF == 1 ? 3 : kMF == 2 ? 2 : 1)
gather_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const int* __restrict__ qkey,
                   const int* __restrict__ skeys,
                   const int* __restrict__ srow, float* __restrict__ out,
                   int depth, int width, int kvol, int n_rows, int n_keys,
                   int nb, int vec_a, int vec_b, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  const int ldc = ld_wide(nb);
  const int ldb = ld_wide(nb);
  float* cacc = smem;                                  // [kTileM][ldc]
  float* stage0 = cacc + kTileM * ldc;
  const int sfl = stage_floats(nb, kBT);
  // per stage: as [kTileM][kLdA], then bs [kChunk][ldb] or [nb][kLdA]
  unsigned* list = reinterpret_cast<unsigned*>(stage0 + kStages * sfl);
  int* cnt = reinterpret_cast<int*>(list + kBatch * kTileM);  // [kBatch][2]
  int* knz = cnt + 2 * kBatch;                         // [kBatch]
  int* nk_s = knz + kBatch;
  int* rows_done = nk_s + 1;  // rows multiplied, thread 0's tally
  // the resolved rows [kBatch][kTileM], while no stage is in use
  int* rows_s = reinterpret_cast<int*>(stage0);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // fragment row / column group
  const int tig = lane & 3;   // thread in group
  const int row0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * nb;
  const int n_chunks = (depth + kChunk - 1) / kChunk;
  // W[k] stage, kBT false: a thread copies 4 columns at w_n of the rows
  // w_c0, w_c0 + w_cstep, ... (nb / 4 is a power of two dividing kThreads)
  const int w_n = (tid & (nb / 4 - 1)) * 4;
  const int w_c0 = tid / (nb / 4);
  const int w_cstep = kThreads / (nb / 4);

  // warps over the block's columns (32 per warp) and the list's 16-row
  // fragments: wn along the columns, wm along the rows
  const int ng_all = nb / 32;
  const int wn = ng_all < 8 ? ng_all : 8;
  const int wm = 8 / wn;
  // a warp whose columns all lie past the output's width has nothing to do
  const bool active = warp < wn * wm && n0 + (warp % wn) * 32 < width;
  const int ng = warp % wn;
  const int mf0 = warp / wn;

  for (int e = tid; e < kTileM * ldc; e += kThreads) cacc[e] = 0.f;
  if (tid == 0) *rows_done = 0;

  float acc[kMF][4][4];
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int kb0 = 0; kb0 < kvol; kb0 += kBatch) {
    const int kbn = min(kBatch, kvol - kb0);
    // resolve: every thread takes (offset, tile row) pairs tid + 256 i,
    // its searches in lockstep
    {
      constexpr int kPer = kBatch * kTileM / kThreads;
      int q[kPer], r[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * kThreads;
        const int kk = e / kTileM;
        const int row = row0 + e % kTileM;
        q[i] = (kk < kbn && row < n_rows)
                   ? qkey[(size_t)(kb0 + kk) * n_rows + row]
                   : -1;
        r[i] = -1;
        if (kTable && kk < kbn && row < n_rows && q[i] >= 0 &&
            q[i] < n_keys) {
          r[i] = q[i];
        }
      }
      if (!kTable) {
        int pos[kPer];
        find_keys<kPer>(skeys, n_keys, q, pos);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int e = tid + i * kThreads;
          if (pos[i] >= 0 && e / kTileM < kbn && row0 + e % kTileM < n_rows) {
            r[i] = __ldg(srow + pos[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) rows_s[tid + i * kThreads] = r[i];
    }
    __syncthreads();
    // compact: a warp takes (offset, 32-row half) pairs; the list
    // [kBatch][64] of offset kk holds (input row << 6 | tile row), the
    // matches of the first half at [0, cnt0), the second at [32, 32+cnt1)
    for (int p = warp; p < 2 * kbn; p += kThreads / 32) {
      const int kk = p >> 1;
      const int half = p & 1;
      const int t = half * 32 + lane;
      const int r = rows_s[kk * kTileM + t];
      const unsigned hits = __ballot_sync(0xffffffffu, r >= 0);
      if (r >= 0) {
        const int at = __popc(hits & ((1u << lane) - 1u));
        list[kk * kTileM + half * 32 + at] =
            (static_cast<unsigned>(r) << 6) | t;
      }
      if (lane == 0) cnt[2 * kk + half] = __popc(hits);
    }
    __syncthreads();
    if (tid == 0) {
      int nk = 0;
      for (int kk = 0; kk < kbn; ++kk) {
        if (cnt[2 * kk] + cnt[2 * kk + 1] > 0) knz[nk++] = kk;
      }
      *nk_s = nk;
    }
    __syncthreads();
    const int n_stages = *nk_s * n_chunks;

    // stage s: offset knz[s / n_chunks], depth chunk s % n_chunks, into
    // buffer s % kStages
    auto load_stage = [&](int s) {
      float* as = stage0 + (s % kStages) * sfl;
      float* bs = as + kTileM * kLdA;
      const int kk = knz[s / n_chunks];
      const int c0 = (s % n_chunks) * kChunk;
      const int k = kb0 + kk;
      const int c_lo = cnt[2 * kk];
      const int m = c_lo + cnt[2 * kk + 1];
      const int m_pad = round_up(m, 16);
      for (int e = tid; e < m_pad * (kChunk / 4); e += kThreads) {
        const int r = e / (kChunk / 4);
        const int c = (e % (kChunk / 4)) * 4;
        float* dst = as + r * kLdA + c;
        if (r < m && c0 + c < depth) {
          const int li = r < c_lo ? r : 32 + r - c_lo;
          const int src = static_cast<int>(list[kk * kTileM + li] >> 6);
          copy4(dst, a + (size_t)src * depth + c0 + c, depth - c0 - c,
                vec_a);
        } else {
          zero4(dst);
        }
      }
      if (kBT) {
        // bs[n][c] = W[kvol-1-k][n0+n][c0+c]
        const float* wk = b + (size_t)(kvol - 1 - k) * width * depth;
        for (int e = tid; e < nb * (kChunk / 4); e += kThreads) {
          const int n = e / (kChunk / 4);
          const int c = (e % (kChunk / 4)) * 4;
          float* dst = bs + n * kLdA + c;
          if (n0 + n < width && c0 + c < depth) {
            copy4(dst, wk + (size_t)(n0 + n) * depth + c0 + c,
                  depth - c0 - c, vec_b);
          } else {
            zero4(dst);
          }
        }
      } else {
        // bs[c][n] = W[k][c0+c][n0+n]
        const float* wk = b + (size_t)k * depth * width;
        for (int c = w_c0; c < kChunk; c += w_cstep) {
          const int n = w_n;
          float* dst = bs + c * ldb + n;
          if (c0 + c < depth && n0 + n < width) {
            copy4(dst, wk + (size_t)(c0 + c) * width + n0 + n,
                  width - n0 - n, vec_b);
          } else {
            zero4(dst);
          }
        }
      }
    };

    // kStages - 1 stages in flight ahead of the one being multiplied
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_stages) load_stage(s);
      cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      if (s + kStages - 1 < n_stages) load_stage(s + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();

      const int kk = knz[s / n_chunks];
      const int chunk = s % n_chunks;
      const int c0 = chunk * kChunk;
      const int c_lo = cnt[2 * kk];
      const int m = c_lo + cnt[2 * kk + 1];
      const int m_frags = (m + 15) / 16;
      if (tid == 0 && chunk == 0) *rows_done += m_frags * 16;
      if (active) {
        const float* as = stage0 + (s % kStages) * sfl;
        const float* bs = as + kTileM * kLdA;
        const int ksteps = min(kChunk, depth - c0 + 7) / 8;
        for (int ks = 0; ks < ksteps; ++ks) {
          const int kc = ks * 8 + tig;
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = ng * 32 + j * 8 + gid;
            float b0, b1;
            if (kBT) {
              b0 = bs[n * kLdA + kc];
              b1 = bs[n * kLdA + kc + 4];
            } else {
              b0 = bs[kc * ldb + n];
              b1 = bs[(kc + 4) * ldb + n];
            }
            split_tf32(b0, bh[j][0], bl[j][0]);
            split_tf32(b1, bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int i = 0; i < kMF; ++i) {
            const int mf = mf0 + i * wm;
            if (mf < m_frags) {
              const float* ar = as + (mf * 16 + gid) * kLdA + kc;
              uint32_t ah[4], al[4];
              split_tf32(ar[0], ah[0], al[0]);
              split_tf32(ar[8 * kLdA], ah[1], al[1]);
              split_tf32(ar[4], ah[2], al[2]);
              split_tf32(ar[8 * kLdA + 4], ah[3], al[3]);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                mma_3xtf32(acc[i][j], ah, al, bh[j], bl[j]);
              }
            }
          }
        }
        if (chunk == n_chunks - 1) {
          // the offset is done: add its rows into the accumulator
#pragma unroll
          for (int i = 0; i < kMF; ++i) {
            const int mf = mf0 + i * wm;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rr = mf * 16 + h * 8 + gid;
              if (mf < m_frags && rr < m) {
                const int li = rr < c_lo ? rr : 32 + rr - c_lo;
                const int trow =
                    static_cast<int>(list[kk * kTileM + li] & 63);
                float* dst = cacc + trow * ldc + ng * 32 + 2 * tig;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  dst[j * 8] += acc[i][j][2 * h];
                  dst[j * 8 + 1] += acc[i][j][2 * h + 1];
                }
              }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
          }
        }
      }
      __syncthreads();
    }
  }

  // one store of the tile
  const int nv = nb / 4;
  for (int e = tid; e < kTileM * nv; e += kThreads) {
    const int r = e / nv;
    const int n = (e % nv) * 4;
    const int row = row0 + r;
    if (row >= n_rows || n0 + n >= width) continue;
    const float* src = cacc + r * ldc + n;
    float* dst = out + (size_t)row * width + n0 + n;
    if (vec_out) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      for (int q = 0; q < 4 && n0 + n + q < width; ++q) dst[q] = src[q];
    }
  }
  if (tid == 0 && blockIdx.y == 0 && row_counter != nullptr) {
    atomicAdd(row_counter, static_cast<unsigned long long>(*rows_done));
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kTable, bool kBT, int kMF, int kStages>
int launch_mf(const float* a, const float* b, const int* qkey,
              const int* skeys, const int* srow, float* out, int depth,
              int width, int kvol, int n_rows, int n_keys, int n_split,
              int nb, cudaStream_t stream) {
  const size_t smem = smem_bytes(nb, kBT, kStages);
  auto kernel = gather_gemm_kernel<kTable, kBT, kMF, kStages>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // a's rows start 16-byte aligned when depth is a multiple of 4, and so
  // on for W's rows and out's
  const int vec_a = aligned16(a) && depth % 4 == 0;
  const int vec_b = aligned16(b) && (kBT ? depth : width) % 4 == 0;
  const int vec_out = aligned16(out) && width % 4 == 0;
  const dim3 grid((n_rows + kTileM - 1) / kTileM, n_split);
  kernel<<<grid, kThreads, smem, stream>>>(a, b, qkey, skeys, srow, out,
                                           depth, width, kvol, n_rows,
                                           n_keys, nb, vec_a, vec_b,
                                           vec_out);
  return static_cast<int>(cudaGetLastError());
}

// Launches the gather-GEMM over n_rows output rows on `stream`; returns a
// cudaError_t as int. Outputs wider than kMaxWidth split over grid.y into
// slices of a power of two columns; the warps of a slice's columns past
// the width idle.
template <bool kTable, bool kBT>
int launch(const float* a, const float* b, const int* qkey,
           const int* skeys, const int* srow, float* out, int depth,
           int width, int kvol, int n_rows, int n_keys,
           cudaStream_t stream) {
  const int n_split = (width + kMaxWidth - 1) / kMaxWidth;
  int nb = 32;
  while (nb < (width + n_split - 1) / n_split) nb <<= 1;
  const int wn = nb / 32 < 8 ? nb / 32 : 8;
  const int wm = 8 / wn;
  // three buffers unless two let more blocks share an SM (228 KB of
  // shared memory, 1 KB of it reserved per block; the registers allow
  // three blocks at kMF 1, two at kMF 2, one at kMF 4): more warps hide
  // the gathers' latency better than a deeper ring
  const int max_blocks = wm >= 4 ? 3 : wm >= 2 ? 2 : 1;
  auto blocks = [&](int stages) {
    const int by_smem =
        static_cast<int>(233472 / (smem_bytes(nb, kBT, stages) + 1024));
    return by_smem < max_blocks ? by_smem : max_blocks;
  };
  const bool three = blocks(3) >= blocks(2);
#define GG_LAUNCH(MF, ST)                                                   \
  return launch_mf<kTable, kBT, MF, ST>(a, b, qkey, skeys, srow, out, depth, \
                                        width, kvol, n_rows, n_keys,        \
                                        n_split, nb, stream)
  if (wm >= 4) {
    if (three) GG_LAUNCH(1, 3);
    GG_LAUNCH(1, 2);
  }
  if (wm >= 2) {
    if (three) GG_LAUNCH(2, 3);
    GG_LAUNCH(2, 2);
  }
  if (three) GG_LAUNCH(4, 3);
  GG_LAUNCH(4, 2);
#undef GG_LAUNCH
}

}  // namespace gg

// Split-K weight gradient on the tensor cores: the device core shared by
// the one-pass backward's dW (K7) and the standalone dW (K8), for Hopper
// (sm_90a).
//
//   dW[s(k)] += x[xr(k, d), :]^T g[gr(k, d), :]     summed over the rows d
//
// over the (offset k, driving row d) pairs that match, with the pair and
// the slice s(k) given by a resolver (a template parameter):
//
// * kReverse (K7, sparse_conv_bwd.cu): d runs over the INPUT rows j;
//   rqkey[k', j] is searched in the OUTPUT level's sorted keys (skeys /
//   srow); the pair is (j, rev(k', j)) and the slice K-1-k' (dW comes out
//   in forward offset order).
// * kForward (K8 over an implicit map, sparse_conv_dw.cu): d runs over the
//   OUTPUT rows i; qkey[k, i] is searched in the INPUT level's sorted
//   keys; the pair is (row(k, i), i) and the slice k.
// * kTable (K8 over an index table, sparse_conv_dw.cu): d runs over the
//   output rows i; idx[k, i] is the input row itself, a match only inside
//   [0, n_in): no search, and the kPer reads of a round run in lockstep.
//
// What bounds it on this card: the products (2 x Cin x Cout per matched
// pair), far above the bytes of the gathered rows, keys and dW. What the
// design does about it: split-K over the driving rows. A block owns
// (offset, a Cin x Cout tile of up to 64 x 128 or 128 x 64, a chunk of
// driving rows); the blocks of one chunk are launched together, so the x
// and g rows that each tile gathers again come from L2. It resolves 2048
// rows at a time (eight a thread in lockstep, so that dependent loads
// overlap), compacts the matched pairs with __ballot_sync into a ring, and
// whenever 32 are ready gathers their x and g rows (cp.async, double
// buffered: the next 32 are in flight while these multiply) and
// accumulates x_c^T g_c in registers with split-TF32 mma.sync (three
// m16n8k8 per product; float32 accuracy at the TF32 rate). The tensor
// cores sum one stage (their float32 adds drop low bits, which a chain
// over thousands of rows piles up past 1e-4), ordinary float32 adds sum
// the stages. The compacted rows make the executed work the matched work
// to within the last stage of a chunk (rounded to 8 rows). A block flushes
// once with atomicAdd: a second reduction launch would need K x Cin x Cout
// x chunks of scratch and a pass over it. The chunks are sized for about
// 32 blocks per SM (two are resident at a time): the offsets' work is
// unequal (the centre offset of a same-level conv matches every row, the
// others about a fifth), and many short blocks even it out where a few
// long ones leave a tail (on an H100 80GB HBM3 at 700 W, 4 blocks per
// SM took 74.2 ms for K7's dW of a 4 x 7 train step, 32 took 55.8, 64
// 55.1; PERF.md lists the sweep). With atomics the order of the sum over chunks
// changes from run to run, so dW agrees with the plain version to float32
// rounding, not bit for bit. Cin = 1 takes a form of its own on the CUDA cores (see
// splitk_dw_c1_kernel), with the same resolvers and the same grid.
//
// For checks, a source's launches can count the rows they stage: after
// set_staged_counter(p), every block of the first Cin x Cout tile that
// staged a row adds its staged rows (each stage rounded up to 8; for
// Cin = 1 the matched pairs) to p[0] and one to p[1].

#pragma once

#include <cuda_runtime.h>

#include "gather_gemm.cuh"

namespace sk {

using gg::kThreads;

constexpr int kStageRows = 32;  // compacted rows per stage
constexpr int kPer = 8;         // rows a thread resolves per round
constexpr int kResolve = kPer * kThreads;  // rows resolved per round
// capacity of the pair ring: it holds < kStageRows + kResolve pairs
constexpr int kRing = 4096;

enum Resolver { kReverse, kForward, kTable };

// Where this source's launches count their staged rows and blocks
// (unsigned long long [2] on the device); nullptr: not counted (static:
// each source that includes this header has its own).
static __device__ unsigned long long* staged_counter = nullptr;

// Host: point this source's staged-row counter at p (a device address, or
// nullptr to stop counting). Synchronous; returns a cudaError_t as int.
static inline int set_staged_counter(unsigned long long* p) {
  return static_cast<int>(cudaMemcpyToSymbol(staged_counter, &p, sizeof(p)));
}

// r[i]: the row that driving row d = next + i * kThreads + threadIdx.x is
// paired with at offset row mp (the output row for kReverse, the input row
// otherwise), -1 where it has none or d >= d_end. The kPer rows of a
// thread resolve in lockstep.
template <int kRes>
__device__ __forceinline__ void resolve_rows(const int* __restrict__ mp,
                                             int next, int d_end,
                                             const int* __restrict__ skeys,
                                             const int* __restrict__ srow,
                                             int n_src, int* r) {
  int q[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = next + i * kThreads + threadIdx.x;
    q[i] = d < d_end ? mp[d] : -1;
  }
  if (kRes == kTable) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      r[i] = (q[i] >= 0 && q[i] < n_src) ? q[i] : -1;
    }
  } else {
    int pos[kPer];
    gg::find_keys<kPer>(skeys, n_src, q, pos);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = next + i * kThreads + threadIdx.x;
      r[i] = (d < d_end && pos[i] >= 0) ? __ldg(srow + pos[i]) : -1;
    }
  }
}

// map int32[kvol, n_drive]: query keys (kReverse, kForward: resolved
// against skeys / srow, n_src of them) or input rows (kTable: valid in
// [0, n_src), n_src the input's row count; skeys and srow are not read).
// TM (Cin) x TN (Cout) tile per block, warps wm x wn x wk over (32 x 32
// warp tiles, depth): wm * wn * wk == 8.
template <int kRes>
__global__ void __launch_bounds__(kThreads, 2)
splitk_dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const int* __restrict__ map, const int* __restrict__ skeys,
                 const int* __restrict__ srow, float* __restrict__ dw,
                 int cin, int cout, int kvol, int n_drive, int n_src, int tm,
                 int tn, int chunk_rows, int vec_x, int vec_g) {
  extern __shared__ __align__(16) float smem[];
  const int ldx = tm + 8;  // 8 mod 32: conflict-free fragment reads
  const int ldg = tn + 8;
  const int sfl = kStageRows * (ldx + ldg);
  float* stage0 = smem;  // 2 x {xs [32][ldx], gs [32][ldg]}
  int* ring_x = reinterpret_cast<int*>(stage0 + 2 * sfl);  // x rows
  int* ring_g = ring_x + kRing;                            // g rows
  int* wcnt = ring_g + kRing;                              // [8]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  // blockIdx: x the Cin x Cout tile, y the offset, z the chunk, so that
  // the blocks in flight together share one chunk's rows and re-read them
  // from L2
  const int kp = blockIdx.y;
  const int kf = kRes == kReverse ? kvol - 1 - kp : kp;
  const int n_co = (cout + tn - 1) / tn;
  const int ci0 = (blockIdx.x / n_co) * tm;
  const int co0 = (blockIdx.x % n_co) * tn;
  const int d_begin = blockIdx.z * chunk_rows;
  const int d_end = min(n_drive, d_begin + chunk_rows);

  const int wn = tn / 32;
  const int wm = tm / 32;
  const int wk = 8 / (wm * wn);
  const int wi_n = warp % wn;
  const int wi_m = (warp / wn) % wm;
  const int wi_k = warp / (wn * wm);

  // the tensor cores add a stage's products into `part` (a short chain:
  // their float32 adds drop low bits that a chain over thousands of rows
  // would pile up); `acc` sums the stages with ordinary float32 adds
  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // the ring: entries [head, tail) are resolved and not yet staged; both
  // counters, and `staged`, are the same in every thread
  int head = 0, tail = 0, staged = 0;
  int next = d_begin;
  const int* mp = map + (size_t)kp * n_drive;

  // resolve rounds until a stage's pairs are ready or the chunk is done; a
  // thread's kPer rows resolve in lockstep, and the pairs of a round go
  // into the ring in driving-row order
  auto fill = [&]() {
    while (tail - head < kStageRows && next < d_end) {
      int r[kPer];
      resolve_rows<kRes>(mp, next, d_end, skeys, srow, n_src, r);
      for (int i = 0; i < kPer; ++i) {
        const unsigned hits = __ballot_sync(0xffffffffu, r[i] >= 0);
        if (lane == 0) wcnt[warp] = __popc(hits);
        __syncthreads();
        int before = 0, total = 0;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) {
          const int c = wcnt[w];
          before += w < warp ? c : 0;
          total += c;
        }
        if (r[i] >= 0) {
          const int at = (tail + before + __popc(hits & ((1u << lane) - 1u))) &
                         (kRing - 1);
          const int d = next + i * kThreads + tid;
          ring_x[at] = kRes == kReverse ? d : r[i];
          ring_g[at] = kRes == kReverse ? r[i] : d;
        }
        __syncthreads();
        tail += total;
      }
      next += kResolve;
    }
  };

  // stage the next min(kStageRows, ready) pairs into buffer `buf`; returns
  // the number of pairs staged
  auto load_stage = [&](int buf) {
    const int n = min(kStageRows, tail - head);
    const int n8 = gg::round_up(n, 8);
    float* xs = stage0 + buf * sfl;
    float* gs = xs + kStageRows * ldx;
    const int xv = tm / 4, gv = tn / 4;
    for (int e = tid; e < n8 * (xv + gv); e += kThreads) {
      const int r = e / (xv + gv);
      const int c = (e % (xv + gv)) * 4;
      const bool is_x = c < tm;
      float* dst = is_x ? xs + r * ldx + c : gs + r * ldg + (c - tm);
      const int col = is_x ? ci0 + c : co0 + (c - tm);
      const int width = is_x ? cin : cout;
      if (r < n && col < width) {
        const int at = (head + r) & (kRing - 1);
        const float* src = is_x ? x + (size_t)ring_x[at] * cin + col
                                : g + (size_t)ring_g[at] * cout + col;
        gg::copy4(dst, src, width - col, is_x ? vec_x : vec_g);
      } else {
        gg::zero4(dst);
      }
    }
    head += n;
    staged += n8;
    return n;
  };

  auto compute = [&](int buf, int n) {
    const float* xs = stage0 + buf * sfl;
    const float* gs = xs + kStageRows * ldx;
    const int ksteps = (n + 7) / 8;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
    for (int ks = wi_k; ks < ksteps; ks += wk) {
      const int kr = ks * 8 + tig;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = wi_n * 32 + j * 8 + gid;
        gg::split_tf32(gs[kr * ldg + nn], bh[j][0], bl[j][0]);
        gg::split_tf32(gs[(kr + 4) * ldg + nn], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // A = x_c^T: A[m = ci][k = row] = xs[row][ci]
        const float* xr = xs + kr * ldx + wi_m * 32 + i * 16 + gid;
        uint32_t ah[4], al[4];
        gg::split_tf32(xr[0], ah[0], al[0]);
        gg::split_tf32(xr[8], ah[1], al[1]);
        gg::split_tf32(xr[4 * ldx], ah[2], al[2]);
        gg::split_tf32(xr[4 * ldx + 8], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          gg::mma_3xtf32(part[i][j], ah, al, bh[j], bl[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  };

  fill();
  if (tail == head) return;  // no match in this chunk: nothing to add
  int buf = 0;
  int n_cur = load_stage(0);
  gg::cp_async_commit();
  for (;;) {
    fill();
    const bool more = tail > head;
    const int n_next = more ? load_stage(buf ^ 1) : 0;
    gg::cp_async_commit();
    gg::cp_async_wait<1>();
    __syncthreads();
    compute(buf, n_cur);
    __syncthreads();
    if (!more) break;
    buf ^= 1;
    n_cur = n_next;
  }
  gg::cp_async_wait<0>();
  __syncthreads();
  if (tid == 0 && blockIdx.x == 0 && staged_counter != nullptr) {
    atomicAdd(staged_counter, static_cast<unsigned long long>(staged));
    atomicAdd(staged_counter + 1, 1ull);
  }

  // flush: the warps' partial tiles through shared memory (the stages are
  // free now), summed over the depth split, one atomicAdd per element
  float* red = smem;  // [8 warps][32][32], over the stages and the ring
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ml = i * 16 + gid + (q >> 1) * 8;
        const int nl = j * 8 + 2 * tig + (q & 1);
        red[warp * 1024 + ml * 32 + nl] = acc[i][j][q];
      }
  __syncthreads();
  float* dwk = dw + (size_t)kf * cin * cout;
  for (int e = tid; e < tm * tn; e += kThreads) {
    const int ci = e / tn;
    const int co = e % tn;
    if (ci0 + ci >= cin || co0 + co >= cout) continue;
    const int w0 = (ci / 32) * wn + co / 32;
    float v = 0.f;
    for (int s = 0; s < wk; ++s) {
      v += red[(s * wm * wn + w0) * 1024 + (ci % 32) * 32 + co % 32];
    }
    if (v != 0.f) atomicAdd(dwk + (size_t)(ci0 + ci) * cout + co0 + co, v);
  }
}

// Cin = 1: dW[s(k), 0, :] is a sum of g rows, each scaled by its x value,
// on the CUDA cores. On the tensor-core path a 32-channel tile would be
// 31/32 padding and a 32-pair stage too short for its pipeline (conv1 of
// the explicit route: K = 125, ~1.9e7 pairs at 8 x 7 clouds). A block owns
// (32 output channels, offset, chunk of driving rows); a thread resolves
// 8 rows a round as above and adds x[xr] * g[gr, 32 channels] of each
// matched pair into 32 registers; the block sums them with warp shuffles
// and shared memory and flushes with one atomicAdd a channel. It stages
// nothing: the rows it counts are the matched pairs.
template <int kRes>
__global__ void __launch_bounds__(kThreads)
splitk_dw_c1_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const int* __restrict__ map,
                    const int* __restrict__ skeys,
                    const int* __restrict__ srow, float* __restrict__ dw,
                    int cout, int kvol, int n_drive, int n_src,
                    int chunk_rows, int vec_g) {
  __shared__ float red[kThreads / 32][32];
  __shared__ int cnt[kThreads / 32];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int co0 = blockIdx.x * 32;
  const int nco = min(32, cout - co0);
  const int kp = blockIdx.y;
  const int kf = kRes == kReverse ? kvol - 1 - kp : kp;
  const int d_begin = blockIdx.z * chunk_rows;
  const int d_end = min(n_drive, d_begin + chunk_rows);
  const int* mp = map + (size_t)kp * n_drive;

  float acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;
  int pairs = 0;
  for (int next = d_begin; next < d_end; next += kResolve) {
    int r[kPer];
    resolve_rows<kRes>(mp, next, d_end, skeys, srow, n_src, r);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (r[i] < 0) continue;
      const int d = next + i * kThreads + tid;
      const float xv = __ldg(x + (kRes == kReverse ? d : r[i]));
      const float* gp =
          g + (size_t)(kRes == kReverse ? r[i] : d) * cout + co0;
      if (vec_g) {  // rows 16-byte aligned, nco a multiple of 4
#pragma unroll
        for (int c = 0; c < 32; c += 4) {
          if (c < nco) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(gp + c));
            acc[c] = fmaf(xv, v.x, acc[c]);
            acc[c + 1] = fmaf(xv, v.y, acc[c + 1]);
            acc[c + 2] = fmaf(xv, v.z, acc[c + 2]);
            acc[c + 3] = fmaf(xv, v.w, acc[c + 3]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          if (c < nco) acc[c] = fmaf(xv, __ldg(gp + c), acc[c]);
        }
      }
      ++pairs;
    }
  }

  // the block's sum: over the lanes by shuffles, over the warps in shared
  // memory; one atomicAdd a channel
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    float v = acc[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][c] = v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    pairs += __shfl_xor_sync(0xffffffffu, pairs, o);
  }
  if (lane == 0) cnt[warp] = pairs;
  __syncthreads();
  if (tid == 0 && blockIdx.x == 0 && staged_counter != nullptr) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += cnt[w];
    if (total > 0) {
      atomicAdd(staged_counter, static_cast<unsigned long long>(total));
      atomicAdd(staged_counter + 1, 1ull);
    }
  }
  if (tid < nco) {
    float v = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) v += red[w][tid];
    if (v != 0.f) atomicAdd(dw + (size_t)kf * cout + co0 + tid, v);
  }
}

inline int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Launches the split-K dW over n_drive driving rows on `stream` (dw zeroed
// by the caller); returns a cudaError_t as int.
template <int kRes>
int launch_dw(const float* x, const float* g, const int* map,
              const int* skeys, const int* srow, float* dw, int cin,
              int cout, int kvol, int n_drive, int n_src,
              cudaStream_t stream) {
  const bool c1 = cin == 1;
  const int tn = c1 || cout <= 32 ? 32 : cout <= 64 ? 64 : 128;
  const int wn = tn / 32;
  int wm = next_pow2((cin + 31) / 32);
  if (wm > 8 / wn) wm = 8 / wn;
  if (wm > 4) wm = 4;
  const int tm = 32 * wm;
  const int n_tiles = ((cin + tm - 1) / tm) * ((cout + tn - 1) / tn);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about kBlocksPerSm blocks per SM over the whole grid, a chunk at
  // least one resolve round long
  constexpr int kBlocksPerSm = 32;
  const int per_chunk = kvol * n_tiles;
  int n_chunks = (kBlocksPerSm * sms + per_chunk - 1) / per_chunk;
  const int max_chunks = (n_drive + kResolve - 1) / kResolve;
  if (n_chunks > max_chunks) n_chunks = max_chunks;
  if (n_chunks < 1) n_chunks = 1;
  const int chunk_rows =
      gg::round_up((n_drive + n_chunks - 1) / n_chunks, kResolve);
  n_chunks = (n_drive + chunk_rows - 1) / chunk_rows;
  const int vec_g = gg::aligned16(g) && cout % 4 == 0;
  if (c1) {  // tm == 32: n_tiles is the count of 32-channel Cout tiles
    splitk_dw_c1_kernel<kRes><<<dim3(n_tiles, kvol, n_chunks), kThreads, 0,
                                stream>>>(x, g, map, skeys, srow, dw, cout,
                                          kvol, n_drive, n_src, chunk_rows,
                                          vec_g);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * 2 * kStageRows * (tm + 8 + tn + 8) +
                      sizeof(int) * (2 * kRing + 8);
  auto kernel = splitk_dw_kernel<kRes>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_x = gg::aligned16(x) && cin % 4 == 0;
  const dim3 grid(n_tiles, kvol, n_chunks);
  kernel<<<grid, kThreads, smem, stream>>>(x, g, map, skeys, srow, dw, cin,
                                           cout, kvol, n_drive, n_src, tm, tn,
                                           chunk_rows, vec_x, vec_g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sk

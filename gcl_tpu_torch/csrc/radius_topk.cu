// Nearest targets within a radius among the 2x2x2 cell block of each query,
// for Hopper (sm_90a): the candidate selection of the hash-grid
// colocation-group search.
//
// Replaces gcl_tpu/core/pallas_radius.py:windowed_cell_topk with its two
// kernel bodies: _topk_kernel_packed (TPU kernel K1, candidates ordered by
// the int32 (quantized d2 << ROWB) | row) and _topk_kernel (K11, candidates
// ordered by the exact float d2, ties by sorted position).
//
// Per search s the targets arrive sorted by packed cell key
// (x << 20 | y << 10 | z, sentinel 0x7FFFFFFF on invalid rows, whose
// coordinates are 1e30). A query carries the key `base` of the min-corner
// cell of its 2x2x2 probe block (sentinel: no block). Its candidates are
// the targets whose key minus base has no bit set but the three per-axis +1
// bits; those within r2 compete for the kn best.
//
// What bounds it on this card: bytes in principle (every key, row,
// coordinate and query read once, kn rows and distances written per query:
// 39 MB at the 4 x 7 step), in practice the latency of the searches: a
// query's candidates are four runs of the sorted keys, and finding them
// over the whole 18,432-key level in L2 takes four chains of ~15 dependent
// reads, then a walk with one dependent load a candidate.
//
// What the design does about it (K1, the packed order): the TPU kernel
// DMAs, per 128-query tile, a window of targets that the caller works out
// in XLA before its pallas_call, and compares every query with every
// window row. Here the window comes back as one that each block works out
// for itself, and no query meets a target outside its cells. A block owns
// a tile of 256 queries of one search, one thread each. It reduces the
// min and max of its tile's bases (the queries arrive sorted by HOME cell,
// so the bases, min corners of the probe blocks, are only about monotone:
// the block reduces them and never takes the first and last; a tile of
// sentinel bases stages nothing). Run r of every query in the tile lies in
// the keys [min + off_r, max + off_r + 1], off_r the run's key offset;
// one warp a window end finds it in the level with a 32-way search
// (csrc/key_window.cuh). The four windows overlap (runs 0 and 1 differ by
// one y line, as do runs 2 and 3), so the block stages their union once,
// run by run, each window less what the windows before it already hold
// (kernels/radius_topk.py:topk_windows is the same table in plain torch,
// the reference the keys the kernel counts are held to): the keys, and
// beside each its coordinates and row in one 16-byte slot, with cp.async,
// 2048 targets at a time in one buffer. A tile whose bases straddle an x
// cell has windows over the rest of an x slab; 95% of the 4 x 7 step's
// tiles fit one chunk, and each chunk more costs a pass of every query
// over it. The staged sequence is sorted, so in each chunk a query
// lower-bounds each run's first key in shared memory and walks the run
// there, keeping its kn best in registers by insertion. The tile's outputs
// leave through shared memory, so that the stores are coalesced. The packed values
// are distinct (rows are distinct within a search), so the visiting order
// does not change the result. One launch covers all searches; there is no
// host sync.
//
// K11 (the exact order, T > 2^19) keeps its first design: one thread per
// (search, query), four lower-bound searches over the whole level, each
// from where the last one ended, and a walk of each run; its tie rule
// depends on that visiting order (see topk_exact_kernel).
//
// d2 is ((dx*dx + dy*dy) + dz*dz) in round-to-nearest multiplies and adds
// with no fused multiply-add, so the quantized order is the plain version's
// bit for bit.

#include <climits>

#include <cuda_runtime.h>

#include "key_window.cuh"

namespace {

constexpr int kThreads = 128;  // K11's block
constexpr int kSentinel = 0x7FFFFFFF;
constexpr int kMaxKn = 8;
constexpr float kBig = 1e30f;

// First position p in keys[lo, n) with keys[p] >= q (n when there is none).
__device__ __forceinline__ int lower_bound_from(const int* __restrict__ keys,
                                                int lo, int n, int q) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ float sq_dist(const float* __restrict__ t, float qx,
                                         float qy, float qz) {
  const float dx = __fsub_rn(qx, __ldg(t));
  const float dy = __fsub_rn(qy, __ldg(t + 1));
  const float dz = __fsub_rn(qz, __ldg(t + 2));
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// K1's blocks: a tile of queries of one search, one thread each
constexpr int kTile = 256;    // queries of a block: radius_topk.TILE
constexpr int kChunk = 2048;  // targets staged at a time: radius_topk.CHUNK
constexpr int kRuns = 4;

// the key offset of run r: its cells' +1 x (r >> 1) and +1 y (r & 1)
__device__ __forceinline__ int run_offset(int r) {
  return ((r >> 1) << 20) + ((r & 1) << 10);
}

__device__ __forceinline__ float sq_dist_at(float4 t, float qx, float qy,
                                            float qz) {
  const float dx = __fsub_rn(qx, t.x);
  const float dy = __fsub_rn(qy, t.y);
  const float dz = __fsub_rn(qz, t.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The tile's windows into cw (run r as group r of the cube windows'
// staging, its non-negative half: target keys are never negative): the
// keys [lo + off_r, hi + off_r + 1] of each run, one warp a window end,
// each window less the positions of the windows before it. lo > hi: no
// valid base, nothing staged. Every thread of the block calls it.
__device__ __forceinline__ void tile_windows(
    kw::CubeWindows<kTile, kRuns>& cw, int (*ends)[2], long long lo,
    long long hi, const int* __restrict__ keys, int t_n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool any = lo <= hi;
  if (any && warp < 2 * kRuns) {
    // end e of run r's window: the first key >= its least key (e = 0) or
    // > its greatest (e = 1)
    const int r = warp >> 1, e = warp & 1;
    const int v = static_cast<int>((e ? hi + 1 : lo) + run_offset(r));
    const int p = kw::warp_partition_point(t_n, [&](int p) {
      const int k = __ldg(keys + p);
      return e ? k <= v : k < v;
    });
    if (lane == 0) ends[r][e] = p;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int held = 0, off = 0;  // the end of the windows so far, staged keys
    for (int r = 0; r < kRuns; ++r) {
      const int s0 = any ? max(ends[r][0], held) : 0;
      const int ln = any ? max(ends[r][1] - s0, 0) : 0;
      if (any) held = max(held, ends[r][1]);
      cw.s0[r][0] = cw.ln[r][0] = 0;
      cw.s0[r][1] = ln > 0 ? s0 : 0;
      cw.ln[r][1] = ln;
      cw.off[r] = off;
      off += ln;
    }
    cw.off[kRuns] = off;
  }
  __syncthreads();
}

// K1: per query, its KN best by the packed int32 value in registers,
// ascending, over the runs staged in its tile's windows. Values are
// distinct (rows are distinct within a search), so the visiting order
// does not matter.
template <int KN>
__global__ void __launch_bounds__(kTile)
topk_packed_kernel(const int* __restrict__ tkey, const int* __restrict__ trow,
                   const float* __restrict__ txyz,
                   const int* __restrict__ pbase,
                   const float* __restrict__ qxyz,
                   const float* __restrict__ r2s,
                   const float* __restrict__ scales,
                   const float* __restrict__ inv_scales, int* __restrict__ rows,
                   float* __restrict__ d2s, int t_n, int q_n, int rowb,
                   float qcap) {
  // the staged targets: keys, and beside them (x, y, z, row) in one
  // 16-byte slot, read by one load
  __shared__ int keys[kChunk];
  __shared__ float4 slots[kChunk];
  __shared__ long long scratch[32];
  __shared__ int ends[kRuns][2];
  __shared__ kw::CubeWindows<kTile, kRuns> cw;

  const int s = blockIdx.y;
  const int q = blockIdx.x * kTile + threadIdx.x;
  const bool live = q < q_n;
  const size_t sq = (size_t)s * q_n + q;
  const int base = live ? __ldg(pbase + sq) : kSentinel;
  const bool valid = base != kSentinel;
  const long long lo =
      kw::block_reduce<false>(valid ? base : LLONG_MAX, scratch);
  const long long hi =
      kw::block_reduce<true>(valid ? base : LLONG_MIN, scratch);

  const int* keys_s = tkey + (size_t)s * t_n;
  const int* trows = trow + (size_t)s * t_n;
  const float* txs = txyz + (size_t)s * t_n * 3;
  tile_windows(cw, ends, lo, hi, keys_s, t_n);

  int best[KN];
#pragma unroll
  for (int j = 0; j < KN; ++j) best[j] = kSentinel;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (valid) {
    qx = __ldg(qxyz + sq * 3);
    qy = __ldg(qxyz + sq * 3 + 1);
    qz = __ldg(qxyz + sq * 3 + 2);
  }
  const float r2 = __ldg(r2s + s), scale = __ldg(scales + s);

  kw::for_each_window_chunk<kTile, kRuns, kTile, 1>(
      cw, kRuns, keys_s, keys, kChunk,
      [&](int p, int slot) {
        float* t = reinterpret_cast<float*>(slots + slot);
        kw::cp_async4(t, txs + (size_t)p * 3);
        kw::cp_async4(t + 1, txs + (size_t)p * 3 + 1);
        kw::cp_async4(t + 2, txs + (size_t)p * 3 + 2);
        kw::cp_async4(t + 3, trows + p);
      },
      [&](int, const int* buf, int, int c0, int c1) {
        if (!valid) return;
        // the staged keys ascend over the chunk: each run's keys, cut or
        // whole, lie at consecutive positions from its lower bound on
        const int len = c1 - c0;
        const int first = buf[0], last = buf[len - 1];
        auto take = [&](int p) {
          const float4 t = slots[p];
          const float d2 = sq_dist_at(t, qx, qy, qz);
          if (d2 > r2) return;
          const int qd = (int)fminf(__fmul_rn(d2, scale), qcap);
          const int v = (qd << rowb) | __float_as_int(t.w);
          if (v >= best[KN - 1]) return;
          best[KN - 1] = v;
#pragma unroll
          for (int j = KN - 1; j > 0; --j) {
            if (best[j] < best[j - 1]) {
              const int tmp = best[j];
              best[j] = best[j - 1];
              best[j - 1] = tmp;
            }
          }
        };
#pragma unroll 1
        for (int r = 0; r < kRuns; ++r) {
          const int key0 = base + run_offset(r);
          if (key0 + 1 < first || key0 > last) continue;
          int p = key0 <= first ? 0 : kw::smem_lower_bound(buf, len, key0);
          // four candidates at a time while the run has them, then two,
          // then one: their loads are independent, and the walk waits on
          // latency, not on throughput
          for (; p + 3 < len && buf[p + 3] <= key0 + 1; p += 4) {
            take(p);
            take(p + 1);
            take(p + 2);
            take(p + 3);
          }
          if (p + 1 < len && buf[p + 1] <= key0 + 1) {
            take(p);
            take(p + 1);
            p += 2;
          }
          if (p < len && buf[p] <= key0 + 1) take(p);
        }
      });

  // the tile's rows and distances go out through shared memory (the
  // staging buffers are free now), so that the stores are coalesced: a
  // query's kn values from its own thread would be kn stores 4 bytes wide
  // at a stride of kn words, each a partial write of many sectors
  int* orow = keys;
  float* od2 = reinterpret_cast<float*>(slots);
  const float inv_scale = __ldg(inv_scales + s);
  const int row_mask = (1 << rowb) - 1;
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    const bool hit = best[j] != kSentinel;
    orow[threadIdx.x * KN + j] = hit ? (best[j] & row_mask) : -1;
    od2[threadIdx.x * KN + j] =
        hit ? __fmul_rn((float)(best[j] >> rowb), inv_scale) : kBig;
  }
  __syncthreads();
  const int q0 = blockIdx.x * kTile;
  const int n_out = min(kTile, q_n - q0) * KN;
  const size_t o0 = ((size_t)s * q_n + q0) * KN;
  for (int e = threadIdx.x; e < n_out; e += kTile) {
    rows[o0 + e] = orow[e];
    d2s[o0 + e] = od2[e];
  }
}

// KN best by (exact d2, sorted position), ascending. The four runs are
// visited in ascending position and a candidate moves ahead of strictly
// larger distances only, so among equal distances the lower sorted position
// comes first. (The TPU kernel merges window chunks by replace-max and may
// emit equal distances from different chunks in another order; that order
// is not reproduced.)
template <int KN>
__global__ void __launch_bounds__(kThreads)
topk_exact_kernel(const int* __restrict__ tkey, const int* __restrict__ trow,
                  const float* __restrict__ txyz,
                  const int* __restrict__ pbase,
                  const float* __restrict__ qxyz,
                  const float* __restrict__ r2s, int* __restrict__ rows,
                  float* __restrict__ d2s, int t_n, int q_n) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int s = blockIdx.y;
  if (q >= q_n) return;
  const size_t sq = (size_t)s * q_n + q;
  float best_d[KN];
  int best_r[KN];
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    best_d[j] = kBig;
    best_r[j] = -1;
  }

  const int base = __ldg(pbase + sq);
  if (base != kSentinel) {
    const int* keys = tkey + (size_t)s * t_n;
    const int* trows = trow + (size_t)s * t_n;
    const float* txs = txyz + (size_t)s * t_n * 3;
    const float qx = __ldg(qxyz + sq * 3), qy = __ldg(qxyz + sq * 3 + 1),
                qz = __ldg(qxyz + sq * 3 + 2);
    const float r2 = __ldg(r2s + s);
    int p = 0;
#pragma unroll 1
    for (int run = 0; run < 4; ++run) {
      const int key0 = base + ((run >> 1) << 20) + ((run & 1) << 10);
      p = lower_bound_from(keys, p, t_n, key0);
      while (p < t_n && __ldg(keys + p) <= key0 + 1) {
        const float d2 = sq_dist(txs + (size_t)p * 3, qx, qy, qz);
        if (d2 <= r2 && d2 < best_d[KN - 1]) {
          best_d[KN - 1] = d2;
          best_r[KN - 1] = __ldg(trows + p);
#pragma unroll
          for (int j = KN - 1; j > 0; --j) {
            if (best_d[j] < best_d[j - 1]) {
              const float td = best_d[j];
              best_d[j] = best_d[j - 1];
              best_d[j - 1] = td;
              const int tr = best_r[j];
              best_r[j] = best_r[j - 1];
              best_r[j - 1] = tr;
            }
          }
        }
        ++p;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    rows[sq * KN + j] = best_r[j];
    d2s[sq * KN + j] = best_d[j];
  }
}

template <int KN>
cudaError_t launch(const int* tkey, const int* trow, const float* txyz,
                   const int* pbase, const float* qxyz, const float* r2,
                   const float* scale, const float* inv_scale, int* rows,
                   float* d2, int s_n, int t_n, int q_n, int kn, int rowb,
                   float qcap, cudaStream_t stream) {
  if constexpr (KN <= kMaxKn) {
    if (kn != KN) {
      return launch<KN + 1>(tkey, trow, txyz, pbase, qxyz, r2, scale,
                            inv_scale, rows, d2, s_n, t_n, q_n, kn, rowb,
                            qcap, stream);
    }
    const dim3 grid((q_n + kThreads - 1) / kThreads, s_n);
    if (rowb > 0) {
      const dim3 tiles((q_n + kTile - 1) / kTile, s_n);
      topk_packed_kernel<KN><<<tiles, kTile, 0, stream>>>(
          tkey, trow, txyz, pbase, qxyz, r2, scale, inv_scale, rows, d2, t_n,
          q_n, rowb, qcap);
    } else {
      topk_exact_kernel<KN><<<grid, kThreads, 0, stream>>>(
          tkey, trow, txyz, pbase, qxyz, r2, rows, d2, t_n, q_n);
    }
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;  // kn outside [1, kMaxKn]
  }
}

}  // namespace

// tkey / trow int32[s_n, t_n] (keys sorted per search), txyz f32[s_n, t_n, 3],
// pbase int32[s_n, q_n], qxyz f32[s_n, q_n, 3], r2 f32[s_n]; rows
// int32[s_n, q_n, kn] and d2 f32[s_n, q_n, kn] out; contiguous on the
// device; 1 <= kn <= 8, s_n <= 65535. rowb > 0 selects the packed order
// with `rowb` row bits, scale / inv_scale f32[s_n] and qcap the largest
// quantized distance (as a float); rowb == 0 the exact order (scale and
// inv_scale unused, may be null). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int windowed_cell_topk(const int* tkey, const int* trow,
                                  const float* txyz, const int* pbase,
                                  const float* qxyz, const float* r2,
                                  const float* scale, const float* inv_scale,
                                  int* rows, float* d2, int s_n, int t_n,
                                  int q_n, int kn, int rowb, float qcap,
                                  void* stream) {
  return static_cast<int>(launch<1>(
      tkey, trow, txyz, pbase, qxyz, r2, scale, inv_scale, rows, d2, s_n, t_n,
      q_n, kn, rowb, qcap, static_cast<cudaStream_t>(stream)));
}

// Counts the keys that K1's launches stage into *counter (unsigned long
// long on the device) from now on; nullptr stops counting. For checks
// only. Returns a cudaError_t as int.
extern "C" int windowed_cell_topk_count_keys(void* counter) {
  return kw::set_staged_key_counter(counter);
}

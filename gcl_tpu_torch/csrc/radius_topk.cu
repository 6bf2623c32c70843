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
// coordinate and query read once, kn rows and distances written per query),
// latency in practice: four dependent binary searches per query over keys
// that sit in L2, then a short data-dependent walk.
//
// What the design does about it: the TPU kernel DMAs a 2048-row window per
// 128-query tile and compares every query with every window row; none of
// that is carried over. The key layout makes the eight probed cells four
// contiguous runs of the sorted keys (the two z-neighbours are adjacent
// keys), so one thread per (search, query) does four lower-bound searches,
// each starting where the last one ended, walks each run while key <=
// run key + 1 (the whole run of the max-corner key included), and keeps its
// kn best in registers by insertion. Queries arrive sorted by home cell, so
// the threads of a warp search and walk neighbouring addresses. One launch
// covers all searches; there is no window table and no host sync.
//
// d2 is ((dx*dx + dy*dy) + dz*dz) in round-to-nearest multiplies and adds
// with no fused multiply-add, so the quantized order is the plain version's
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
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

// KN best by the packed int32 value, ascending. Values are distinct (rows
// are distinct within a search), so the visiting order does not matter.
template <int KN>
__global__ void __launch_bounds__(kThreads)
topk_packed_kernel(const int* __restrict__ tkey, const int* __restrict__ trow,
                   const float* __restrict__ txyz,
                   const int* __restrict__ pbase,
                   const float* __restrict__ qxyz,
                   const float* __restrict__ r2s,
                   const float* __restrict__ scales,
                   const float* __restrict__ inv_scales, int* __restrict__ rows,
                   float* __restrict__ d2s, int t_n, int q_n, int rowb,
                   float qcap) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int s = blockIdx.y;
  if (q >= q_n) return;
  const size_t sq = (size_t)s * q_n + q;
  int best[KN];
#pragma unroll
  for (int j = 0; j < KN; ++j) best[j] = kSentinel;

  const int base = __ldg(pbase + sq);
  if (base != kSentinel) {
    const int* keys = tkey + (size_t)s * t_n;
    const int* trows = trow + (size_t)s * t_n;
    const float* txs = txyz + (size_t)s * t_n * 3;
    const float qx = __ldg(qxyz + sq * 3), qy = __ldg(qxyz + sq * 3 + 1),
                qz = __ldg(qxyz + sq * 3 + 2);
    const float r2 = __ldg(r2s + s), scale = __ldg(scales + s);
    int p = 0;
#pragma unroll 1
    for (int run = 0; run < 4; ++run) {
      const int key0 = base + ((run >> 1) << 20) + ((run & 1) << 10);
      p = lower_bound_from(keys, p, t_n, key0);
      while (p < t_n && __ldg(keys + p) <= key0 + 1) {
        const float d2 = sq_dist(txs + (size_t)p * 3, qx, qy, qz);
        if (d2 <= r2) {
          const int qd = (int)fminf(__fmul_rn(d2, scale), qcap);
          const int v = (qd << rowb) | __ldg(trows + p);
          if (v < best[KN - 1]) {
            best[KN - 1] = v;
#pragma unroll
            for (int j = KN - 1; j > 0; --j) {
              if (best[j] < best[j - 1]) {
                const int tmp = best[j];
                best[j] = best[j - 1];
                best[j - 1] = tmp;
              }
            }
          }
        }
        ++p;
      }
    }
  }
  const float inv_scale = __ldg(inv_scales + s);
  const int row_mask = (1 << rowb) - 1;
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    const bool hit = best[j] != kSentinel;
    rows[sq * KN + j] = hit ? (best[j] & row_mask) : -1;
    d2s[sq * KN + j] =
        hit ? __fmul_rn((float)(best[j] >> rowb), inv_scale) : kBig;
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
      topk_packed_kernel<KN><<<grid, kThreads, 0, stream>>>(
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

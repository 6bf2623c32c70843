// Explicit kernel maps: a join of two-word query keys against a
// level's sorted two-word keys, for Hopper (sm_90a).
//
// Replaces gcl_tpu/core/pallas_join.py:_join_kernel (TPU kernel K10,
// reached through kernel_maps._build_kmap_pallas -> join_kmap):
//
//   kmap[k, i] = perm[p]  where (key_hi[p], key_lo[p]) == (qhi[k, i],
//                                                          qlo[k, i])
//
// and -1 where no key matches or the query carries the sentinel
// 0x7FFFFFFF (a padded output row, a query off the input lattice or
// outside the key window). Keys are unique among a level's valid rows, so
// there is no tie to order.
//
// What bounds it on this card: bytes. Each query is two words read and one
// written, once; the windows of keys add little (a few hundred keys of
// 12 bytes for a tile's 256 outputs times the group's offsets).
//
// What the design does about it: as the TPU kernel, one block per (tile of
// kTile consecutive outputs i, offset group: the offsets of one dx). The
// group's valid queries over the tile lie between their lexicographic min
// and max, so every key they can match lies in one run of the level's
// sorted keys. The block reads its queries once for those bounds (the
// sentinels stay out), reduces them, and two warps find the run's ends
// with a 32-way search each (kernels/join_kmap.py:join_windows is the same
// table in plain torch). The block copies that run into shared memory in
// chunks, cp.async double-buffered (a tile that straddles an x-slab or a
// cloud boundary can have a window several times the tile), each key as
// one int64 (key64: hi, then lo with its sign bit flipped) beside its row.
// A thread owns one output i for all offsets of the group: it reloads its
// queries kBatch at a time (their loads in flight together, coalesced along
// i, L2 hits after the first pass), skips a query outside the chunk's key
// range, and finds the others by a branch-free lower bound over the int64
// keys in shared memory (~9 steps of one compare in place of ~20 dependent
// L2 reads). It writes each row, or -1, straight to the map, coalesced
// along i; a later chunk overwrites only what it finds.

#include <cuda_runtime.h>

#include "key_window.cuh"

namespace {

constexpr int kTile = 256;  // outputs per block; one thread each
constexpr int kBatch = 2;   // queries a thread loads before it searches
constexpr int kMinBlocks = 8;  // resident blocks an SM is built for
constexpr int kSentinel = 0x7FFFFFFF;

// key64 of core.coords: one int64 in the lexicographic signed order of
// (hi, lo)
__device__ __forceinline__ long long key64(int hi, int lo) {
  return (long long)hi * 4294967296LL + ((long long)lo + 2147483648LL);
}

// Copy positions [from, from + len) of the keys into buffer `buf` of
// `chunk` slots: 8 bytes a key (lo in the low word, hi in the high one:
// fix_keys then makes each slot its key64) and the rows after them.
// Returns the keys this thread issued copies for.
__device__ __forceinline__ unsigned int stage(long long* buf, int chunk,
                                              const int* __restrict__ key_hi,
                                              const int* __restrict__ key_lo,
                                              const int* __restrict__ perm,
                                              long long from, int len) {
  int* words = reinterpret_cast<int*>(buf);
  int* rows = reinterpret_cast<int*>(buf + chunk);
  unsigned int n = 0u;
  for (int e = threadIdx.x; e < len; e += kTile, ++n) {
    kw::cp_async4(words + 2 * e, key_lo + from + e);
    kw::cp_async4(words + 2 * e + 1, key_hi + from + e);
    kw::cp_async4(rows + e, perm + from + e);
  }
  kw::cp_async_commit();
  return n;
}

// A staged slot (lo, hi) as little-endian int64 is hi * 2^32 + (unsigned)
// lo; flipping lo's sign bit makes it key64(hi, lo).
__device__ __forceinline__ void fix_keys(long long* buf, int len) {
  unsigned int* words = reinterpret_cast<unsigned int*>(buf);
  for (int e = threadIdx.x; e < len; e += kTile) words[2 * e] ^= 0x80000000u;
}

// First position p in s[0, n) with s[p] >= q (n when there is none),
// without branches that split a warp.
__device__ __forceinline__ int lower_bound64(const long long* s, int n,
                                             long long q) {
  int lo = 0, len = n;
  while (len > 0) {
    const int half = len >> 1;
    const bool less = s[lo + half] < q;
    lo = less ? lo + half + 1 : lo;
    len = less ? len - half - 1 : half;
  }
  return lo;
}

// Load queries [k0, k0 + kBatch) of output i (sentinels past kg).
__device__ __forceinline__ void load_batch(const int* __restrict__ qhi,
                                           const int* __restrict__ qlo,
                                           size_t base, int n_out, int k0,
                                           int kg, int* qh, int* ql) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const size_t q = base + (size_t)(k0 + b) * n_out;
    qh[b] = k0 + b < kg ? __ldg(qhi + q) : kSentinel;
    ql[b] = k0 + b < kg ? __ldg(qlo + q) : kSentinel;
  }
}

__global__ void __launch_bounds__(kTile, kMinBlocks)
join_kmap_kernel(const int* __restrict__ key_hi,
                 const int* __restrict__ key_lo,
                 const int* __restrict__ perm, const int* __restrict__ qhi,
                 const int* __restrict__ qlo, int* __restrict__ out,
                 int n_keys, int n_out, int kg, int chunk) {
  // two buffers of [chunk] key64 then [chunk] rows
  extern __shared__ long long smem[];
  __shared__ long long scratch[32];
  __shared__ int ends[2];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int grp = blockIdx.y;
  const int i = tile * kTile + tid;
  const bool live = i < n_out;
  // query / output (k, i) of offset k = grp * kg + kk
  const size_t base = (size_t)grp * kg * n_out + i;

  // the window: the run of keys between the least and the greatest valid
  // query of the group over the tile
  int qh[kBatch], ql[kBatch];
  long long qmin = LLONG_MAX, qmax = LLONG_MIN;
  for (int k0 = 0; live && k0 < kg; k0 += kBatch) {
    load_batch(qhi, qlo, base, n_out, k0, kg, qh, ql);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (qh[b] == kSentinel) continue;
      const long long q = key64(qh[b], ql[b]);
      qmin = min(qmin, q);
      qmax = max(qmax, q);
    }
  }
  qmin = kw::block_reduce<false>(qmin, scratch);
  qmax = kw::block_reduce<true>(qmax, scratch);
  const int warp = tid >> 5;
  if (warp < 2 && qmin != LLONG_MAX) {
    // warp 0: the first key >= qmin; warp 1: the first key > qmax
    const long long v = warp == 0 ? qmin : qmax;
    const int p = kw::warp_partition_point(n_keys, [&](int p) {
      const long long k = key64(__ldg(key_hi + p), __ldg(key_lo + p));
      return warp == 0 ? k < v : k <= v;
    });
    if ((tid & 31) == 0) ends[warp] = p;
  }
  __syncthreads();
  const int s0 = qmin == LLONG_MAX ? 0 : ends[0];
  const int len = qmin == LLONG_MAX ? 0 : max(ends[1] - ends[0], 0);
  const int stride = chunk + chunk / 2;  // one buffer, in long longs

  const int nch = (len + chunk - 1) / chunk;
  if (nch == 0 && live) {
    for (int kk = 0; kk < kg; ++kk) out[base + (size_t)kk * n_out] = -1;
  }
  unsigned int staged = 0u;
  if (nch > 0) {
    staged += stage(smem, chunk, key_hi, key_lo, perm, s0, min(chunk, len));
  }
  // the first batch of queries is in flight while the window is staged
  if (live) load_batch(qhi, qlo, base, n_out, 0, kg, qh, ql);
  for (int c = 0; c < nch; ++c) {
    long long* buf = smem + (c & 1) * stride;
    if (c + 1 < nch) {
      const int from = (c + 1) * chunk;
      staged += stage(smem + ((c + 1) & 1) * stride, chunk, key_hi, key_lo,
                      perm, (long long)s0 + from, min(chunk, len - from));
      kw::cp_async_wait<1>();
    } else {
      kw::cp_async_wait<0>();
    }
    __syncthreads();
    const int clen = min(chunk, len - c * chunk);
    fix_keys(buf, clen);
    __syncthreads();
    const int* rows = reinterpret_cast<const int*>(buf + chunk);
    const long long first = buf[0], last = buf[clen - 1];
    if (live) {
      // kBatch queries' loads in flight at a time, then their searches; a
      // query's row (or -1) is written in the first chunk and overwritten
      // by a later chunk that holds its key
      for (int k0 = 0; k0 < kg; k0 += kBatch) {
        if (k0 > 0 || c > 0) load_batch(qhi, qlo, base, n_out, k0, kg, qh, ql);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (k0 + b >= kg) break;
          const long long q = key64(qh[b], ql[b]);
          int row = -1;
          if (qh[b] != kSentinel && q >= first && q <= last) {
            const int p = lower_bound64(buf, clen, q);
            if (p < clen && buf[p] == q) row = rows[p];
          }
          if (c == 0 || row >= 0) out[base + (size_t)(k0 + b) * n_out] = row;
        }
      }
    }
    __syncthreads();  // the buffer is staged over two chunks later
  }
  kw::count_staged_keys(staged);
}

}  // namespace

// key_hi / key_lo / perm int32[n_keys], qhi / qlo / out int32[kg * n_groups,
// n_out]; n_tiles = ceil(n_out / 256); chunk: keys staged at a time (even,
// > 0). All contiguous on the device. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int join_kmap(const int* key_hi, const int* key_lo,
                         const int* perm, const int* qhi, const int* qlo,
                         int* out, int n_keys, int n_out, int kg,
                         int n_groups, int n_tiles, int chunk,
                         void* stream) {
  const size_t smem = 2 * (sizeof(long long) + sizeof(int)) * (size_t)chunk;
  if (chunk < 2 || chunk % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        join_kmap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_tiles, n_groups);
  join_kmap_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      key_hi, key_lo, perm, qhi, qlo, out, n_keys, n_out, kg, chunk);
  return static_cast<int>(cudaGetLastError());
}

// Counts the keys that this source's launches stage into *counter
// (unsigned long long on the device) from now on; nullptr stops counting.
// For checks only. Returns a cudaError_t as int.
extern "C" int join_kmap_count_keys(void* counter) {
  return kw::set_staged_key_counter(counter);
}

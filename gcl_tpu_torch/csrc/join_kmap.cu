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
// there is no tie to order; the padded tail of the keys carries the
// sentinel too, which a sentinel query must not find, hence the test on
// the query.
//
// What bounds it on this card: bytes. Each query is two words read and one
// written, once; the searched keys (at most 3 x 4 MB a level) stay in L2.
// The work is ~20 dependent L2 reads per query.
//
// What the design does about it: one thread per query, a lower-bound
// search over the whole level. The TPU kernel's 256-query tiles, 384-row
// DMA windows and dx-groups exist because its compare is all-against-all
// inside a window; a binary search needs none of them. Queries of one
// offset are monotone within a cloud, so the threads of a warp walk nearly
// the same path through the keys and share its cache lines; reads of the
// queries and the write of the map are coalesced along i.

#include <cuda_runtime.h>

#include "key_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSentinel = 0x7FFFFFFF;

__global__ void __launch_bounds__(kThreads)
join_kmap_kernel(const int* __restrict__ key_hi,
                 const int* __restrict__ key_lo,
                 const int* __restrict__ perm, const int* __restrict__ qhi,
                 const int* __restrict__ qlo, int* __restrict__ out,
                 int n_keys, long long total) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= total) return;
  const int qh = qhi[q];
  int row = -1;
  if (qh != kSentinel) {
    const int p = find_key2(key_hi, key_lo, n_keys, qh, qlo[q]);
    if (p >= 0) row = __ldg(perm + p);
  }
  out[q] = row;
}

}  // namespace

// key_hi / key_lo / perm int32[n_keys], qhi / qlo / out int32[total] (the
// [K, N_out] queries flattened); all contiguous on the device. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int join_kmap(const int* key_hi, const int* key_lo,
                         const int* perm, const int* qhi, const int* qlo,
                         int* out, int n_keys, long long total,
                         void* stream) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  join_kmap_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      key_hi, key_lo, perm, qhi, qlo, out, n_keys, total);
  return static_cast<int>(cudaGetLastError());
}

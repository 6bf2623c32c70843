// Key windows staged in shared memory, shared by the kernels that resolve
// keys inside a tile's window (K10's join, K2's occupancy conv).
//
// A tile of key-sorted outputs reads one contiguous run of a level's sorted
// keys. Each block works out its tile's run itself: it reduces the bounds
// of the keys its tile can match, then one warp finds each end of the run
// in the level with a 32-way search (kernels/join_kmap.py and
// kernels/occupancy_conv.py hold the same tables in plain torch, the
// reference the kernels' staged-key counts are held to). It copies the run
// into shared memory in chunks, with cp.async so that the next chunk's copy
// overlaps the search in the current one, then searches there instead of
// over the whole level in global memory.

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace kw {

// One 4-byte asynchronous copy from global to shared memory (sm_80+,
// through L1: the keys of neighbouring tiles' windows overlap).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// First position p in s[0, n) with s[p] >= q, signed int32 keys in shared
// memory (n when there is none).
__device__ __forceinline__ int smem_lower_bound(const int* s, int n, int q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The min (kMax false) or max of v over the warp, returned to every lane.
template <bool kMax>
__device__ __forceinline__ long long warp_reduce(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? max(v, w) : min(v, w);
  }
  return v;
}

// The min (kMax false) or max of v over the block (blockDim.x a multiple
// of 32), returned to every thread; scratch: 32 words of shared memory.
template <bool kMax>
__device__ __forceinline__ long long block_reduce(long long v,
                                                  long long* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_reduce<kMax>(v);
  __syncthreads();  // scratch is free again after a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? scratch[lane]
                                               : (kMax ? LLONG_MIN : LLONG_MAX);
  return warp_reduce<kMax>(v);
}

// The first position p in [0, n) where pred(p) is false (n when it never
// is), for a pred that holds on a prefix of [0, n). The calling warp
// searches together: each round its 32 lanes probe 32 evenly spaced
// positions and a ballot keeps the one gap where pred turns false, so a
// level of 2^20 keys takes 4 rounds of dependent reads, not 20. Every lane
// calls it with the same n and pred.
template <typename Pred>
__device__ __forceinline__ int warp_partition_point(int n, Pred pred) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const long long p = (long long)lo + (long long)(lane + 1) * step - 1;
    const bool below = p < hi && pred(static_cast<int>(p));
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    const int base = lo;
    lo = base + c * step;
    hi = static_cast<int>(
        min((long long)hi, (long long)base + (long long)(c + 1) * step - 1));
  }
  return lo;
}

// For checks: where a source's launches add the keys they stage (one
// atomicAdd per block); nullptr, the default, counts nothing. Static: each
// source that includes this header has its own.
static __device__ unsigned long long* staged_key_counter = nullptr;

// Host: point this source's counter at p (a device address, or nullptr to
// stop counting). Synchronous; returns a cudaError_t as int.
static inline int set_staged_key_counter(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(staged_key_counter, &p,
                                             sizeof(p)));
}

// Adds up over the block the keys each thread issued copies for, and adds
// the sum to the counter, when one is set. Every thread of the block calls
// it.
__device__ __forceinline__ void count_staged_keys(unsigned int mine) {
  __shared__ unsigned int block_sum;
  if (staged_key_counter == nullptr) return;
  if (threadIdx.x == 0) block_sum = 0u;
  __syncthreads();
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine > 0u) atomicAdd(&block_sum, mine);
  __syncthreads();
  if (threadIdx.x == 0 && block_sum > 0u) {
    atomicAdd(staged_key_counter, static_cast<unsigned long long>(block_sum));
  }
}

}  // namespace kw

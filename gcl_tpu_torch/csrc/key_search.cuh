// Binary search over a level's sorted packed keys, shared by the kernels.
//
// The keys are signed int32 in the ascending order torch.sort gives them
// (packed keys of clouds >= 16 are negative), so the search compares as
// signed int32 too.

#pragma once

#include <cuda_runtime.h>

// First position p in keys[0, n) with keys[p] >= q (n when there is none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int n, int q) {
  int lo = 0, hi = n;
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

// Key searches over a level's sorted keys, shared by the kernels.
//
// The keys are signed int32 in the ascending order torch.sort gives them
// (packed keys of clouds >= 16 are negative), so the search compares as
// signed int32 too.

#pragma once

#include <cuda_runtime.h>

// coords.DEFAULT_KEY_BITS
constexpr int kKeyBX = 10, kKeyBY = 10, kKeyBZ = 7;

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

// Position in keys of the key equal to q, or -1.
__device__ __forceinline__ int find_key(const int* __restrict__ keys, int n,
                                        int q) {
  const int p = lower_bound(keys, n, q);
  return (p < n && __ldg(keys + p) == q) ? p : -1;
}

// The same over two-word keys (hi, lo) in lexicographic order, each word
// compared as signed int32 (the words of coords.coord_keys; hi wraps
// negative for cloud ids >= 2^21). Position in the keys of the pair equal
// to (qh, ql), or -1.
__device__ __forceinline__ int find_key2(const int* __restrict__ key_hi,
                                         const int* __restrict__ key_lo,
                                         int n, int qh, int ql) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int mh = __ldg(key_hi + mid);
    if (mh < qh || (mh == qh && __ldg(key_lo + mid) < ql)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < n && __ldg(key_hi + lo) == qh && __ldg(key_lo + lo) == ql)
             ? lo
             : -1;
}

// Position in skeys of the voxel at offset (dx, dy, dz) of a stride-1 row,
// or -1 when it is absent. `a` is the row's occupancy aux
// (kernel_maps._c1z_aux): a[0] its own packed query key, a[1..3] its
// grid-shifted coords (far negative on padded rows, so every neighbour of
// a pad is out of range). A neighbour outside [0, 2^B) on any axis is
// absent: checked before the key arithmetic, so adding the offset's fields
// carries into no other field; unsigned arithmetic wraps exactly as the
// signed int32 keys do.
__device__ __forceinline__ int neighbor_pos(const int* __restrict__ a, int dx,
                                            int dy, int dz,
                                            const int* __restrict__ skeys,
                                            int n_keys) {
  const int ux = __ldg(a + 1) + dx;
  const int uy = __ldg(a + 2) + dy;
  const int uz = __ldg(a + 3) + dz;
  if (ux < 0 || ux >= (1 << kKeyBX) || uy < 0 || uy >= (1 << kKeyBY) ||
      uz < 0 || uz >= (1 << kKeyBZ)) {
    return -1;
  }
  const unsigned int q = static_cast<unsigned int>(__ldg(a)) +
                         (static_cast<unsigned int>(dx) << (kKeyBY + kKeyBZ)) +
                         (static_cast<unsigned int>(dy) << kKeyBZ) +
                         static_cast<unsigned int>(dz);
  return find_key(skeys, n_keys, static_cast<int>(q));
}

// Key windows staged in shared memory, shared by the kernels that resolve
// keys inside a tile's window (K10's join; K2's occupancy conv and K4 / K5's
// scalar conv through the cube-stencil windows below).
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

#include "key_search.cuh"

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

// --- Cube-stencil windows of a tile of stride-1 rows (K2, K4, K5) ---
//
// The packed keys are cloud | x | y | z, so the neighbours at one dx of a
// run of key-sorted rows span one run of the level's keys. Clouds >= 16
// have negative keys, so a tile that mixes clouds can have two runs a dx,
// one of negative and one of non-negative keys.
// kernels/occupancy_conv.py:occupancy_windows is the same table in plain
// torch.

// Shared-memory state of a tile's windows: run h (0: negative keys, 1:
// non-negative) of dx group g starts at s0[g][h] in the level and holds
// ln[g][h] keys; group g sits at [off[g], off[g + 1]) of the staged
// sequence, each dx's negative run before its non-negative one, so each
// dx's keys stay sorted.
template <int kTile, int kMaxSide>
struct CubeWindows {
  long long red[kTile / 32][kMaxSide][2][2];  // per 32 rows
  long long bnd[kMaxSide][2][2];              // over the tile
  int ends[kMaxSide][2][2];
  int s0[kMaxSide][2], ln[kMaxSide][2], off[kMaxSide + 1];
};

// Works out the tile's windows into cw and returns the length of the
// staged sequence. aux_s: columns 0-3 of the tile's aux rows
// (kernel_maps._c1z_aux: the packed key, the grid-shifted coords); rows:
// the tile's rows that exist; sel: nullptr, or the tile's row flags (a
// row whose flag is 0 stays out of the bounds). A row that can have a
// neighbour at dx (its y and z within R of the grid, x + dx on it) has
// them among the keys [q + (dx << (BY + BZ)) - (R << BZ) - R, q + (dx <<
// (BY + BZ)) + (R << BZ) + R], split at 0 into a negative and a
// non-negative part; each run's ends are found in the level by one warp
// with a 32-way search. Every thread of the block (kThreads of them, at
// least kTile, a multiple of 32) calls it.
template <int kTile, int kMaxSide, int kThreads>
__device__ __forceinline__ int cube_windows(
    CubeWindows<kTile, kMaxSide>& cw, const int (*aux_s)[4],
    const unsigned char* sel, int rows, int side,
    const int* __restrict__ skeys, int n_keys) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rad = side / 2;
  // (32 rows, dx group) items, one warp each, spread over the block's warps
  for (int item = warp; item < kTile / 32 * side; item += kThreads / 32) {
    const int rw = item % (kTile / 32), g = item / (kTile / 32);
    const int lr = rw * 32 + lane;
    const bool row = lr < rows && (sel == nullptr || sel[lr]) &&
                     aux_s[lr][2] >= -rad &&
                     aux_s[lr][2] < (1 << kKeyBY) + rad &&
                     aux_s[lr][3] >= -rad &&
                     aux_s[lr][3] < (1 << kKeyBZ) + rad;
    const long long reach = (long long)rad * (1 << kKeyBZ) + rad;
    const int dx = g - rad;
    const bool live = row && aux_s[lr][1] + dx >= 0 &&
                      aux_s[lr][1] + dx < (1 << kKeyBX);
    const long long lo = (long long)aux_s[lr][0] +
                         (long long)dx * (1 << (kKeyBY + kKeyBZ)) - reach;
    const long long hi = lo + 2 * reach;
    const bool neg = live && lo < 0, pos = live && hi >= 0;
    const long long nlo = warp_reduce<false>(neg ? lo : LLONG_MAX);
    const long long nhi = warp_reduce<true>(neg ? min(hi, -1LL) : LLONG_MIN);
    const long long plo = warp_reduce<false>(pos ? max(lo, 0LL) : LLONG_MAX);
    const long long phi = warp_reduce<true>(pos ? hi : LLONG_MIN);
    if (lane == 0) {
      cw.red[rw][g][0][0] = nlo;
      cw.red[rw][g][0][1] = nhi;
      cw.red[rw][g][1][0] = plo;
      cw.red[rw][g][1][1] = phi;
    }
  }
  __syncthreads();
  if (tid < 4 * side) {
    const int g = tid >> 2, h = (tid >> 1) & 1, e = tid & 1;
    long long r = e ? LLONG_MIN : LLONG_MAX;
    for (int wp = 0; wp < kTile / 32; ++wp) {
      r = e ? max(r, cw.red[wp][g][h][e]) : min(r, cw.red[wp][g][h][e]);
    }
    cw.bnd[g][h][e] = r;
  }
  __syncthreads();
  // end e of run h of dx group g: the first key >= its least key (e = 0)
  // or > its greatest (e = 1), one warp a search
  for (int j = warp; j < 4 * side; j += kThreads / 32) {
    const int g = j >> 2, h = (j >> 1) & 1, e = j & 1;
    if (cw.bnd[g][h][0] > cw.bnd[g][h][1]) continue;
    const int v = static_cast<int>(
        max((long long)INT_MIN, min((long long)INT_MAX, cw.bnd[g][h][e])));
    const int p = warp_partition_point(n_keys, [&](int p) {
      const int k = __ldg(skeys + p);
      return e ? k <= v : k < v;
    });
    if (lane == 0) cw.ends[g][h][e] = p;
  }
  __syncthreads();
  if (tid < 2 * side) {
    const int g = tid >> 1, h = tid & 1;
    const bool any = cw.bnd[g][h][0] <= cw.bnd[g][h][1];
    cw.s0[g][h] = any ? cw.ends[g][h][0] : 0;
    cw.ln[g][h] = any ? max(cw.ends[g][h][1] - cw.ends[g][h][0], 0) : 0;
  }
  __syncthreads();
  if (tid == 0) {
    cw.off[0] = 0;
    for (int g = 0; g < side; ++g) {
      cw.off[g + 1] = cw.off[g] + cw.ln[g][0] + cw.ln[g][1];
    }
  }
  __syncthreads();
  return cw.off[side];
}

// Stages the tile's staged sequence into shared memory `chunk` keys at a
// time and runs body on each chunk, in order. keys: kBuffers * chunk ints;
// with two (the default), a double buffer: the copy of chunk c + 1
// (cp.async) overlaps body on chunk c; with one, each chunk is copied after
// the body of the one before. For each key it copies, stage_also(p, slot)
// runs too, p the key's position in the level and slot its place in the
// buffers (to stage what belongs beside the key). body(c, buf, base, c0,
// c1): chunk c holds positions [c0, c1) of the sequence at buf = keys +
// base; the block synchronises before and after it. Adds the keys this
// launch's threads copy to the staged-key counter. Every thread of the
// block (kThreads) calls it.
template <int kTile, int kMaxSide, int kThreads, int kBuffers = 2,
          typename StageAlso, typename Body>
__device__ __forceinline__ void for_each_window_chunk(
    const CubeWindows<kTile, kMaxSide>& cw, int side,
    const int* __restrict__ skeys, int* keys, int chunk,
    StageAlso stage_also, Body body) {
  static_assert(kBuffers == 1 || kBuffers == 2, "one or two buffers");
  const int total = cw.off[side];
  const int nch = (total + chunk - 1) / chunk;
  unsigned int staged = 0u;
  auto stage = [&](int c) {
    const int base = (c % kBuffers) * chunk;
    const int c0 = c * chunk, c1 = min(total, c0 + chunk);
    for (int g = 0; g < side; ++g) {
      const int a = max(cw.off[g], c0), b = min(cw.off[g + 1], c1);
      for (int e = a + threadIdx.x; e < b; e += kThreads, ++staged) {
        const int v = e - cw.off[g];
        const int p = v < cw.ln[g][0] ? cw.s0[g][0] + v
                                      : cw.s0[g][1] + v - cw.ln[g][0];
        cp_async4(keys + base + (e - c0), skeys + p);
        stage_also(p, base + (e - c0));
      }
    }
    cp_async_commit();
  };

  if (nch > 0) stage(0);
  for (int c = 0; c < nch; ++c) {
    if (kBuffers == 2 && c + 1 < nch) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int base = (c % kBuffers) * chunk, c0 = c * chunk;
    body(c, keys + base, base, c0, min(total, c0 + chunk));
    __syncthreads();  // the buffer takes chunk c + kBuffers next
    if (kBuffers == 1 && c + 1 < nch) stage(c + 1);
  }
  count_staged_keys(staged);
}

// The staged keys of dx group g that chunk [c0, c1) holds: buf[*a, *b).
// Then the keys of (row, dx, dy) for dz = -R .. R, lo .. lo + 2R (no carry
// past the z field where dx and dy stay in range), lie among them from
// the first position whose key is >= lo on, in order.
template <int kTile, int kMaxSide>
__device__ __forceinline__ bool chunk_run(
    const CubeWindows<kTile, kMaxSide>& cw, int g, int c0, int c1, int* a,
    int* b) {
  *a = max(cw.off[g], c0) - c0;
  *b = min(cw.off[g + 1], c1) - c0;
  return *a < *b;
}

// The row's neighbour keys at (dx group g, dy index dyi) of a side-wide
// cube, dz = -R .. R: [*lo, *lo + 2R], int64 so that the run's ends
// cannot wrap. False where x + dx or y + dy leaves the grid (then there
// is no neighbour there, and a key in that range is another voxel's).
__device__ __forceinline__ bool cube_run_keys(const int* a, int g, int dyi,
                                              int side, long long* lo) {
  const int rad = side / 2;
  const int ux = a[1] + g - rad;
  const int uy = a[2] + dyi - rad;
  if (ux < 0 || ux >= (1 << kKeyBX) || uy < 0 || uy >= (1 << kKeyBY)) {
    return false;
  }
  *lo = (long long)a[0] + (long long)(g - rad) * (1 << (kKeyBY + kKeyBZ)) +
        (long long)(dyi - rad) * (1 << kKeyBZ) - rad;
  return true;
}

// Scans buf[*p, b) for the keys of one (row, dx, dy) run [lo, lo + 2R],
// where every key before *p is below lo: returns the bitmask of the dz
// indices present (the grid's z edge masks each: a key reached across it
// is another voxel's), sets *first to the buffer position of the lowest
// present one and leaves *p past the run's keys. The present keys sit at
// consecutive positions from *first on (the masked ones can only lie
// below or above them).
__device__ __forceinline__ unsigned int cube_run_scan(const int* buf, int* p,
                                                      int b, long long lo,
                                                      int z, int side,
                                                      int* first) {
  const int rad = side / 2;
  const long long hi = lo + 2 * rad;
  unsigned int found = 0u;
  int q = *p;
  for (; q < b && buf[q] <= hi; ++q) {
    const int dzi = static_cast<int>(buf[q] - lo);
    const int uz = z + dzi - rad;
    if (uz >= 0 && uz < (1 << kKeyBZ)) {
      if (!found) *first = q;
      found |= 1u << dzi;
    }
  }
  *p = q;
  return found;
}

}  // namespace kw

// Scalar-feature (Cin == 1) sparse convolution that READS its features,
// forward, weight gradient and input gradient, for Hopper (sm_90a).
//
// Replaces gcl_tpu/core/pallas_conv.py:_fwd_c1_kernel (TPU kernel K4,
// wrapper _conv_c1_fwd), _dw_c1_kernel (K5, wrapper _conv_c1_dw) and
// _fwd_co1_kernel (K9, wrapper _conv_co1_fwd: the Cout == 1 forward that
// gcl_tpu runs through the reverse queries as the dX of a Cin == 1 conv) on
// a stride-1 same-level odd stencil. With match(k, i) the row of the voxel
// at offset k of row i (none: the term is zero):
//
//   K4:  out[i, :]    = sum_k x[match(k, i)] * W[k, 0, :]
//   K5:  dW[k, 0, :]  = sum_i x[match(k, i)] * g[i, :]
//   K9:  dX[j]        = sum_k sum_c g[match(K-1-k, j), c] * W[k, 0, c]
//
// (match(k, i) == j iff i == match(K-1-k, j): the stencil is odd and the
// level is its own reverse twin.)
//
// On the train path x is the eps term of the exact input jitter: zero off
// the jittered (centre) clouds, and only their rows flagged (row_sel of
// the OUTPUT row); a same-level conv never leaves the row's cloud, so
// skipping the other rows changes no bit of the result.
//
// What bounds them on this card: key searches, up to k^3 = 125 per row
// over the level's sorted keys, then k^3 x Cout FMAs per row; x, g and out
// are 4-132 bytes a row.
//
// What the design does about it (K4, K5, and K9 likewise): K2's resolver. A block of 512
// threads owns a tile of 128 key-sorted rows and works out, per dx, the
// run of the level's keys that its flagged rows' neighbours can have (the
// cube windows of csrc/key_window.cuh, which K2 shares; a row left
// unflagged stays out of the bounds). It stages those runs into shared
// memory with cp.async, in double-buffered chunks, and beside every key
// the scalar of its row, x[srow[p]] as float32 (as gcl_tpu's _c1_windowed
// DMAs the scalar window beside the key window), so a matched offset reads
// its scalar from shared memory with no gather from global memory. In a
// chunk a thread takes one (flagged row, dx) and its side dy runs in
// order: a galloping search in shared memory from where the run before
// ended, then a scan of at most side keys; it keeps where each run's
// present neighbours start in the chunk and their dz bits. A tile with no
// flagged row is not searched: K4 writes its zeros, K5 skips it. K4: a
// thread takes four channels of an output row and sums x_k W[k, :] over
// the row's present offsets in offset order (the staged sequence runs in
// offset order for each row, whatever the chunks), in float32, W in shared
// memory, rounded once: bit for bit what a search of the whole level
// gives. K5: a thread owns one (dx, dy) and channel, visits the tile's
// rows with a neighbour there and adds x_k g[i, c] for each present dz to
// a per-block partial dW in shared memory, over the tiles the block walks;
// it adds that to global memory with one atomicAdd per element, so dW
// agrees with the plain version to float32 rounding.
//
// K9 takes the same windows, of every row of its tile (the rows of g that
// a row's dX gathers need no flag of their own), resolves in them as K4
// does, and sums g[i] . W[K-1-k] over a row's present neighbours: a warp
// lists a row's present pairs, and its lanes take several pairs at a time,
// 8 channels a lane, each g row read from global memory (a tile's
// neighbourhood stays in L1 and L2) in 16-byte loads. What the card spends
// its time on: the windows' searches, the resolution and, per row, the
// listing and gathering of its pairs.
//
// The bf16 forms (the *_bf16 entry points, a bf16 model's eps term) read x
// and g in bf16 and store out and dX in bf16, rounded once; W stays
// float32, as gcl_tpu's c1 / co1 kernels keep it (they take the weights as
// float32 whatever the features' type), and every product and sum is
// float32; dW is float32.

#include <stdint.h>

#include <cuda_runtime.h>

#include "elem.cuh"
#include "key_window.cuh"
#include "launch_cache.cuh"

namespace {

constexpr int kTile = 128;  // K4 / K5's rows a tile: occupancy_conv.TILE
// K4 / K5's threads a block, 3 blocks an SM (as many as their shared
// memory at Cout 32 lets in)
constexpr int kTileThreads = 512;
constexpr int kMaxSide = 5;        // occupancy_conv.MAX_SIDE
constexpr int kMaxVol = kMaxSide * kMaxSide * kMaxSide;

// What K4 and K5 keep in shared memory for the tile they work on.
struct Tile {
  int aux[kTile][4];         // aux columns 0-3 of its rows
  unsigned char sel[kTile];  // its row flags
  // per (row, j = dx index * side + dy index), in the current chunk: the
  // buffer position of its first present neighbour << 5 | the bits of its
  // present dz indices; valid where bit j of hits[c & 1][row] is set
  unsigned int run[kTile][kMaxSide * kMaxSide];
  unsigned int hits[2][kTile];
  kw::CubeWindows<kTile, kMaxSide> cw;
};

// Sets the tile's row flags (a row that exists and, where row_sel is
// given, has row_sel > 0); true where any is set. A barrier for the block.
__device__ __forceinline__ bool tile_flags(Tile& t,
                                           const float* __restrict__ row_sel,
                                           int row0, int n) {
  bool f = false;
  if (threadIdx.x < kTile) {
    const int i = row0 + threadIdx.x;
    f = i < n && (row_sel == nullptr || __ldg(row_sel + i) > 0.f);
  }
  const bool any = __syncthreads_or(f);
  if (threadIdx.x < kTile) t.sel[threadIdx.x] = f;
  return any;
}

// Loads the tile's aux rows, clears its hit masks and works out its
// windows (flagged rows only).
__device__ __forceinline__ void begin_tile(Tile& t,
                                           const int* __restrict__ aux,
                                           const int* __restrict__ skeys,
                                           int row0, int n, int side,
                                           int n_keys) {
  for (int e = threadIdx.x; e < kTile * 4; e += kTileThreads) {
    const int i = row0 + e / 4;
    t.aux[e / 4][e % 4] = i < n ? __ldg(aux + (size_t)i * 8 + e % 4) : 0;
  }
  for (int e = threadIdx.x; e < 2 * kTile; e += kTileThreads) {
    t.hits[e / kTile][e % kTile] = 0u;
  }
  __syncthreads();
  kw::cube_windows<kTile, kMaxSide, kTileThreads>(t.cw, t.aux, t.sel,
                                                  n - row0, side, skeys,
                                                  n_keys);
}

// The present neighbours of the flagged rows in chunk c (buf, positions
// [c0, c1) of the staged sequence) into t.run and t.hits[c & 1]; clears
// t.hits for the chunk after it. A thread takes one (row, dx) and its side
// dy runs in order: their keys ascend by 2^BZ a dy, so each run's lower
// bound lies at or after the end of the one before; it is found by a
// galloping search from there (a few steps where a level is a surface),
// then at most side keys are scanned.
__device__ __forceinline__ void resolve_chunk(Tile& t, int c, const int* buf,
                                              int c0, int c1, int side) {
  if (threadIdx.x < kTile) t.hits[(c + 1) & 1][threadIdx.x] = 0u;
  for (int e = threadIdx.x; e < kTile * side; e += kTileThreads) {
    const int lr = e / side;
    const int g = e % side;
    int a, b;
    if (!t.sel[lr] || !kw::chunk_run(t.cw, g, c0, c1, &a, &b)) continue;
    unsigned int hit = 0u;
    int p = a;  // every key before p is below the next run's keys
    for (int dyi = 0; dyi < side && p < b; ++dyi) {
      long long lo;
      if (!kw::cube_run_keys(t.aux[lr], g, dyi, side, &lo)) continue;
      if (lo > buf[b - 1]) break;  // and so are the later runs' keys
      if (buf[p] < lo) {
        // buf[p] < lo: gallop to a q with buf[q] >= lo (or q == b), then
        // bisect (p, q]
        int step = 1, q = p + 1;
        while (q < b && buf[q] < lo) {
          p = q;
          step <<= 1;
          q = min(b, p + step);
        }
        p += 1 + kw::smem_lower_bound(buf + p + 1, q - p - 1, (int)lo);
      }
      int first;
      const unsigned int found =
          kw::cube_run_scan(buf, &p, b, lo, t.aux[lr][3], side, &first);
      if (found) {
        const int j = g * side + dyi;
        t.run[lr][j] = (static_cast<unsigned int>(first) << 5) | found;
        hit |= 1u << j;
      }
    }
    if (hit) atomicOr(&t.hits[c & 1][lr], hit);
  }
}

// T: the element type of x and out (float or bf16); w and the sums are
// float32. One block a tile.
template <typename T>
__global__ void __launch_bounds__(kTileThreads, 3)
scalar_conv_fwd_kernel(const T* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ aux,
                       const int* __restrict__ skeys,
                       const int* __restrict__ srow,
                       const float* __restrict__ row_sel,
                       T* __restrict__ out, int n, int side, int cout,
                       int n_keys, int chunk) {
  // [kvol, cout] W, [kTile, cout] sums, 2 x [chunk] keys, 2 x [chunk]
  // scalars
  extern __shared__ __align__(16) float ws[];
  __shared__ Tile t;

  const int tid = threadIdx.x;
  const int kvol = side * side * side;
  const int row0 = blockIdx.x * kTile;
  const int n_out = min(kTile, n - row0) * cout;
  T* out_t = out + (size_t)row0 * cout;
  if (!tile_flags(t, row_sel, row0, n)) {
    for (int e = tid; e < n_out; e += kTileThreads) {
      out_t[e] = from_f32<T>(0.f);
    }
    return;
  }
  float* acc = ws + kvol * cout;
  int* keys = reinterpret_cast<int*>(acc + kTile * cout);
  float* xs = reinterpret_cast<float*>(keys + 2 * chunk);
  for (int e = tid; e < kvol * cout; e += kTileThreads) ws[e] = __ldg(w + e);
  for (int e = tid; e < kTile * cout; e += kTileThreads) acc[e] = 0.f;
  begin_tile(t, aux, skeys, row0, n, side, n_keys);

  kw::for_each_window_chunk<kTile, kMaxSide, kTileThreads>(
      t.cw, side, skeys, keys, chunk,
      [&](int p, int slot) { xs[slot] = ldg_f32(x + __ldg(srow + p)); },
      [&](int c, const int* buf, int base, int c0, int c1) {
        resolve_chunk(t, c, buf, c0, c1, side);
        __syncthreads();
        // a thread takes four channels of an output row and adds x_k W[k,
        // :] over the row's present offsets k = j * side + dz, in
        // ascending order (on a last group of fewer than four channels it
        // reads W past them, inside shared memory, and keeps nothing of it)
        const int nq = (cout + 3) / 4;
        for (int e = tid; e < kTile * nq; e += kTileThreads) {
          const int lr = e / nq;
          const int ch = (e % nq) * 4;
          unsigned int m = t.hits[c & 1][lr];
          if (!m) continue;
          float* ar = acc + lr * cout + ch;
          const int nc = min(4, cout - ch);
          float a0 = ar[0];
          float a1 = nc > 1 ? ar[1] : 0.f;
          float a2 = nc > 2 ? ar[2] : 0.f;
          float a3 = nc > 3 ? ar[3] : 0.f;
          do {
            const int j = __ffs(m) - 1;
            m &= m - 1;
            const unsigned int r = t.run[lr][j];
            const float* xj = xs + base + (r >> 5);
            const float* wj = ws + j * side * cout + ch;
            unsigned int bits = r & 31u;
            do {
              const int dz = __ffs(bits) - 1;
              bits &= bits - 1;
              const float xv = *xj++;
              const float* wk = wj + dz * cout;
              a0 = fmaf(xv, wk[0], a0);
              a1 = fmaf(xv, wk[1], a1);
              a2 = fmaf(xv, wk[2], a2);
              a3 = fmaf(xv, wk[3], a3);
            } while (bits);
          } while (m);
          ar[0] = a0;
          if (nc > 1) ar[1] = a1;
          if (nc > 2) ar[2] = a2;
          if (nc > 3) ar[3] = a3;
        }
      });

  for (int e = tid; e < n_out; e += kTileThreads) {
    out_t[e] = from_f32<T>(acc[e]);
  }
}

// T: the element type of x and g; dw and the sums are float32. Each block
// walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...
template <typename T>
__global__ void __launch_bounds__(kTileThreads, 3)
scalar_conv_dw_kernel(const T* __restrict__ x,
                      const T* __restrict__ g,
                      const int* __restrict__ aux,
                      const int* __restrict__ skeys,
                      const int* __restrict__ srow,
                      const float* __restrict__ row_sel,
                      float* __restrict__ dw, int n, int side, int cout,
                      int n_keys, int chunk) {
  // [kvol, cout] partial dW, [kTile, cout] g rows, 2 x [chunk] keys,
  // 2 x [chunk] scalars
  extern __shared__ __align__(16) float part[];
  __shared__ Tile t;

  const int tid = threadIdx.x;
  const int s2 = side * side;
  const int n_part = s2 * side * cout;
  float* gs = part + n_part;
  int* keys = reinterpret_cast<int*>(gs + kTile * cout);
  float* xs = reinterpret_cast<float*>(keys + 2 * chunk);
  for (int e = tid; e < n_part; e += kTileThreads) part[e] = 0.f;

  const int n_tiles = (n + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kTile;
    if (!tile_flags(t, row_sel, row0, n)) continue;
    const int n_g = min(kTile, n - row0) * cout;
    for (int e = tid; e < n_g; e += kTileThreads) {
      gs[e] = ldg_f32(g + (size_t)row0 * cout + e);
    }
    begin_tile(t, aux, skeys, row0, n, side, n_keys);

    kw::for_each_window_chunk<kTile, kMaxSide, kTileThreads>(
        t.cw, side, skeys, keys, chunk,
        [&](int p, int slot) { xs[slot] = ldg_f32(x + __ldg(srow + p)); },
        [&](int c, const int* buf, int base, int c0, int c1) {
          resolve_chunk(t, c, buf, c0, c1, side);
          __syncthreads();
          // a thread owns the side elements part[(j * side + dz) * cout +
          // ch], dz = 0 .. side - 1, of one (j, ch): it visits the rows
          // with a present neighbour at (dx, dy) = j, in order, and adds
          // x_k g[i, ch] for each of their present dz
          const unsigned int* hits = t.hits[c & 1];
          for (int e = tid; e < s2 * cout; e += kTileThreads) {
            const int j = e / cout;
            const int ch = e % cout;
            float a[kMaxSide] = {};
            for (int r = 0; r < kTile; ++r) {
              if (!((hits[r] >> j) & 1u)) continue;
              const unsigned int run = t.run[r][j];
              const float gv = gs[r * cout + ch];
              const float* xr = xs + base + (run >> 5);
#pragma unroll
              for (int dz = 0; dz < kMaxSide; ++dz) {
                if ((run >> dz) & 1u) a[dz] = fmaf(*xr++, gv, a[dz]);
              }
            }
            float* pj = part + j * side * cout + ch;
#pragma unroll
            for (int dz = 0; dz < kMaxSide; ++dz) {
              if (dz < side) pj[dz * cout] += a[dz];
            }
          }
        });
  }
  __syncthreads();
  for (int e = tid; e < n_part; e += kTileThreads) {
    const float v = part[e];
    if (v != 0.f) atomicAdd(dw + e, v);
  }
}

// sum over c in [c0, min(c0 + 8, cout)) of g[i, c] * wm[k, c]; vec: 8
// channels there, g's rows 16-byte aligned (cout % 8 == 0), read as one
// 16-byte load in bf16, two in float32 (wm's rows then are 16-byte aligned
// too)
__device__ __forceinline__ float dot8_vec(const float* gi, const float* wk) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(gi));
  const float4 b = __ldg(reinterpret_cast<const float4*>(gi) + 1);
  const float4 u = *reinterpret_cast<const float4*>(wk);
  const float4 v = *reinterpret_cast<const float4*>(wk + 4);
  float d = a.x * u.x;
  d = fmaf(a.y, u.y, d);
  d = fmaf(a.z, u.z, d);
  d = fmaf(a.w, u.w, d);
  d = fmaf(b.x, v.x, d);
  d = fmaf(b.y, v.y, d);
  d = fmaf(b.z, v.z, d);
  return fmaf(b.w, v.w, d);
}
__device__ __forceinline__ float dot8_vec(const bf16* gi, const float* wk) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(gi));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 u = *reinterpret_cast<const float4*>(wk);
  const float4 v = *reinterpret_cast<const float4*>(wk + 4);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
  float d = a.x * u.x;
  d = fmaf(a.y, u.y, d);
  d = fmaf(b.x, u.z, d);
  d = fmaf(b.y, u.w, d);
  d = fmaf(c.x, v.x, d);
  d = fmaf(c.y, v.y, d);
  d = fmaf(e.x, v.z, d);
  return fmaf(e.y, v.w, d);
}
template <typename T>
__device__ __forceinline__ float dot8(const T* __restrict__ g, int i,
                                      const float* wm, unsigned int k, int c0,
                                      int cout, bool vec) {
  const T* gi = g + (size_t)i * cout + c0;
  const float* wk = wm + (size_t)k * cout + c0;
  if (vec) return dot8_vec(gi, wk);
  float d = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (c0 + t < cout) d = fmaf(ldg_f32(gi + t), wk[t], d);
  }
  return d;
}

// K9. dX[j] = sum over the present neighbours i of row j, at offset index
// k of j's cube, of g[i, :] . W[K-1-k, 0, :]: as K4, on K4's resolver, with
// the windows of every row of the tile (the neighbours of any row can be
// gathered; occupancy_windows without a flag is the same table) and W in
// shared memory, read at the mirrored offset. A gathered row i whose
// row_sel[i] <= 0 counts as absent (K4 left out[i] zero, so g[i] reaches
// no x): the exact adjoint of K4 for any row flag. Beside each staged key
// the block stages its row (-1 where the flag leaves it out).
//
// A warp takes eight of the tile's rows in turn; it lists a row's present
// pairs, then its lanes take them several at a time, each a slice of 8
// channels of one pair (g[i] read from global memory in 16-byte loads,
// W[K-1-k] from shared memory), so that the loads of several pairs are in
// flight together; the lanes' sums meet in one shuffle reduction a row and
// chunk, into the row's sum in shared memory. T: the element type of g and
// dx; w and the sums are float32.

constexpr int kPairUnroll = 4;  // pairs a lane has in flight

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 3)
scalar_conv_dx_kernel(const T* __restrict__ g,
                      const float* __restrict__ w,
                      const int* __restrict__ aux,
                      const int* __restrict__ skeys,
                      const int* __restrict__ srow,
                      const float* __restrict__ row_sel,
                      T* __restrict__ dx, int n, int side, int cout,
                      int n_keys, int chunk) {
  // [kvol, cout] W, 2 x [chunk] keys, 2 x [chunk] rows, then the warps'
  // [kMaxVol] lists of a row's present pairs
  extern __shared__ __align__(16) float ws[];
  __shared__ Tile t;
  __shared__ float sums[kTile];  // dX of the tile's rows so far

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int kvol = side * side * side;
  const int s2 = side * side;
  const int row0 = blockIdx.x * kTile;
  int* keys = reinterpret_cast<int*>(ws + kvol * cout);
  int* rows = keys + 2 * chunk;
  unsigned int(*list)[kMaxVol] =
      reinterpret_cast<unsigned int(*)[kMaxVol]>(rows + 2 * chunk);
  // W arrives with the first chunk's keys (the same cp.async group)
  for (int e = tid; e < kvol * cout; e += kTileThreads) {
    kw::cp_async4(ws + e, w + e);
  }
  if (tid < kTile) sums[tid] = 0.f;
  tile_flags(t, nullptr, row0, n);
  begin_tile(t, aux, skeys, row0, n, side, n_keys);

  // slices of 8 channels, lpp lanes a pair (a power of two), pps pairs a
  // step
  const int slices = (cout + 7) / 8;
  int lpp = 1;
  while (lpp < slices && lpp < 32) lpp <<= 1;
  const int pps = 32 / lpp;
  const bool vec = cout % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  kw::for_each_window_chunk<kTile, kMaxSide, kTileThreads>(
      t.cw, side, skeys, keys, chunk,
      [&](int p, int slot) { kw::cp_async4(rows + slot, srow + p); },
      [&](int c, const int* buf, int base, int c0, int c1) {
        // the flag of each staged row (-1: left out)
        if (row_sel != nullptr) {
          for (int e = tid; e < c1 - c0; e += kTileThreads) {
            if (!(__ldg(row_sel + rows[base + e]) > 0.f)) rows[base + e] = -1;
          }
        }
        resolve_chunk(t, c, buf, c0, c1, side);
        __syncthreads();
        const unsigned int* hits = t.hits[c & 1];
        // a warp's rows in turn: the lanes j < side^2 list the row's
        // present pairs (buffer position << 7 | offset index) in offset
        // order, then each group of lpp lanes takes a pair, its lanes
        // a slice of 8 channels each, so that pps pairs' loads a step
        // are in flight at once
        for (int lr = warp; lr < kTile; lr += kTileThreads / 32) {
          const unsigned int m = hits[lr];
          if (!m) continue;
          const unsigned int r =
              lane < s2 && ((m >> lane) & 1u) ? t.run[lr][lane] : 0u;
          const int cnt = __popc(r & 31u);
          int off = cnt;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, off, o);
            if (lane >= o) off += v;
          }
          const int total = __shfl_sync(0xffffffffu, off, 31);
          off -= cnt;
          unsigned int bits = r & 31u;
          unsigned int pos = r >> 5;
          while (bits) {
            const int dz = __ffs(bits) - 1;
            bits &= bits - 1;
            list[warp][off++] =
                (pos++ << 7) | (kvol - 1 - (lane * side + dz));
          }
          __syncwarp();
          float acc = 0.f;
          for (int b = lane / lpp; b < total; b += kPairUnroll * pps) {
            unsigned int e[kPairUnroll];
            int i[kPairUnroll];
#pragma unroll
            for (int u = 0; u < kPairUnroll; ++u) {
              const bool in = b + u * pps < total;
              e[u] = in ? list[warp][b + u * pps] : 0u;
              i[u] = in ? rows[base + (e[u] >> 7)] : -1;
            }
            for (int sl = lane % lpp; sl < slices; sl += lpp) {
#pragma unroll
              for (int u = 0; u < kPairUnroll; ++u) {
                if (i[u] >= 0) {
                  acc += dot8(g, i[u], ws, e[u] & 127u, sl * 8, cout, vec);
                }
              }
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            acc += __shfl_xor_sync(0xffffffffu, acc, o);
          }
          if (lane == 0) sums[lr] += acc;
          __syncwarp();
        }
      });

  kw::cp_async_wait<0>();  // W's copies, where no chunk waited for them
  __syncthreads();
  if (tid < kTile && row0 + tid < n) dx[row0 + tid] = from_f32<T>(sums[tid]);
}

// K4 / K5's dynamic shared memory: [kvol, cout] and [kTile, cout] floats,
// then 2 x chunk keys and 2 x chunk scalars
size_t tile_smem(int side, int cout, int chunk) {
  return sizeof(float) * ((size_t)(side * side * side + kTile) * cout +
                          4 * (size_t)chunk);
}

bool tile_args_ok(int side, int chunk) {
  return chunk >= 1 && side >= 1 && side <= kMaxSide && side % 2 == 1;
}

template <typename T>
int launch_fwd(const T* x, const float* w, const int* aux, const int* skeys,
               const int* srow, const float* row_sel, T* out, int n,
               int side, int cout, int n_keys, int chunk, void* stream) {
  static lc::LaunchCache cache;
  if (!tile_args_ok(side, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = tile_smem(side, cout, chunk);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cache.allow(scalar_conv_fwd_kernel<T>, dev, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile);
  scalar_conv_fwd_kernel<T><<<grid, kTileThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      x, w, aux, skeys, srow, row_sel, out, n, side, cout, n_keys, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(const T* x, const T* g, const int* aux, const int* skeys,
              const int* srow, const float* row_sel, float* dw, int n,
              int side, int cout, int n_keys, int chunk, void* stream) {
  static lc::LaunchCache cache;
  if (!tile_args_ok(side, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = tile_smem(side, cout, chunk);
  // as many blocks as fit on the card at once, each its own partial dW
  int dev = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cache.allow(scalar_conv_dw_kernel<T>, dev, smem);
  }
  if (err == cudaSuccess) {
    err = cache.resident_blocks(scalar_conv_dw_kernel<T>, dev, kTileThreads,
                                smem, &blocks);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + kTile - 1) / kTile;
  if (blocks > n_tiles) blocks = n_tiles;
  scalar_conv_dw_kernel<T><<<blocks, kTileThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, g, aux, skeys, srow, row_sel, dw, n, side, cout, n_keys, chunk);
  return static_cast<int>(cudaGetLastError());
}

// K9's keys staged at a time, and its dynamic shared memory: [kvol, cout]
// W, 2 x chunk keys and rows, and the warps' pair lists
constexpr int kDxChunk = 1024;

size_t dx_smem(int side, int cout, int chunk) {
  return sizeof(float) * ((size_t)side * side * side * cout +
                          4 * (size_t)chunk) +
         sizeof(unsigned int) * (kTileThreads / 32) * kMaxVol;
}

template <typename T>
int launch_dx(const T* g, const float* w, const int* aux, const int* skeys,
              const int* srow, const float* row_sel, T* dx, int n, int side,
              int cout, int n_keys, void* stream) {
  static lc::LaunchCache cache;
  if (!tile_args_ok(side, kDxChunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = dx_smem(side, cout, kDxChunk);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cache.allow(scalar_conv_dx_kernel<T>, dev, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile);
  scalar_conv_dx_kernel<T><<<grid, kTileThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      g, w, aux, skeys, srow, row_sel, dx, n, side, cout, n_keys, kDxChunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32[n, 1], w f32[side^3, 1, cout], aux int32[n, 8], skeys / srow
// int32[n_keys], row_sel f32[n] or null (rows with row_sel <= 0 are
// skipped and come out zero), out f32[n, cout]; chunk: keys staged at a
// time (> 0); contiguous on the device. side odd, 1 <= side <= 5; one
// block a tile of 128 rows. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int scalar_conv_fwd(const float* x, const float* w, const int* aux,
                               const int* skeys, const int* srow,
                               const float* row_sel, float* out, int n,
                               int side, int cout, int n_keys, int chunk,
                               void* stream) {
  return launch_fwd(x, w, aux, skeys, srow, row_sel, out, n, side, cout,
                    n_keys, chunk, stream);
}

// As above with g f32[n, cout] and dw f32[side^3, 1, cout], zeroed by the
// caller.
extern "C" int scalar_conv_dw(const float* x, const float* g, const int* aux,
                              const int* skeys, const int* srow,
                              const float* row_sel, float* dw, int n,
                              int side, int cout, int n_keys, int chunk,
                              void* stream) {
  return launch_dw(x, g, aux, skeys, srow, row_sel, dw, n, side, cout,
                   n_keys, chunk, stream);
}

// K9: g f32[n, cout], w f32[side^3, 1, cout], dx f32[n, 1] out; the rest
// as scalar_conv_fwd (no chunk). row_sel is K4's flag of its OUTPUT rows,
// i.e. of the rows of g.
extern "C" int scalar_conv_dx(const float* g, const float* w, const int* aux,
                              const int* skeys, const int* srow,
                              const float* row_sel, float* dx, int n,
                              int side, int cout, int n_keys, void* stream) {
  return launch_dx(g, w, aux, skeys, srow, row_sel, dx, n, side, cout,
                   n_keys, stream);
}

// The bf16 forms: x, g, out and dx bf16; w, row_sel and dw float32;
// otherwise as above.
extern "C" int scalar_conv_fwd_bf16(const bf16* x, const float* w,
                                    const int* aux, const int* skeys,
                                    const int* srow, const float* row_sel,
                                    bf16* out, int n, int side, int cout,
                                    int n_keys, int chunk, void* stream) {
  return launch_fwd(x, w, aux, skeys, srow, row_sel, out, n, side, cout,
                    n_keys, chunk, stream);
}

extern "C" int scalar_conv_dw_bf16(const bf16* x, const bf16* g,
                                   const int* aux, const int* skeys,
                                   const int* srow, const float* row_sel,
                                   float* dw, int n, int side, int cout,
                                   int n_keys, int chunk, void* stream) {
  return launch_dw(x, g, aux, skeys, srow, row_sel, dw, n, side, cout,
                   n_keys, chunk, stream);
}

extern "C" int scalar_conv_dx_bf16(const bf16* g, const float* w,
                                   const int* aux, const int* skeys,
                                   const int* srow, const float* row_sel,
                                   bf16* dx, int n, int side, int cout,
                                   int n_keys, void* stream) {
  return launch_dx(g, w, aux, skeys, srow, row_sel, dx, n, side, cout,
                   n_keys, stream);
}

// Counts the keys that K4, K5 and K9's launches stage into *counter
// (unsigned long long on the device) from now on; nullptr stops counting.
// For checks only. Returns a cudaError_t as int.
extern "C" int scalar_conv_count_keys(void* counter) {
  return kw::set_staged_key_counter(counter);
}

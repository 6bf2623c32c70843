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
// What the design does about it (K4, K5): K2's resolver. A block of 512
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
// K9 resolves its neighbours by a binary search of the whole level
// (neighbor_pos), 125 a row, then reads one g row of Cout floats per match:
// a warp takes a row at a time, its lanes spread over the channels so that
// each matched g row is one coalesced read, and the lanes' partial sums
// meet in a shuffle reduction. It is bound by those reads (g once is N *
// Cout * 4 bytes; each row of g is read once per row it neighbours, from
// L2).
//
// The bf16 forms (the *_bf16 entry points, a bf16 model's eps term) read x
// and g in bf16 and store out and dX in bf16, rounded once; W stays
// float32, as gcl_tpu's c1 / co1 kernels keep it (they take the weights as
// float32 whatever the features' type), and every product and sum is
// float32; dW is float32.

#include <mutex>

#include <cuda_runtime.h>

#include "elem.cuh"
#include "key_search.cuh"
#include "key_window.cuh"

namespace {

constexpr int kTile = 128;  // K4 / K5's rows a tile: occupancy_conv.TILE
// K4 / K5's threads a block, 3 blocks an SM (as many as their shared
// memory at Cout 32 lets in)
constexpr int kTileThreads = 512;
constexpr int kMaxSide = 5;        // occupancy_conv.MAX_SIDE
constexpr int kRows = 32;          // K9's rows a block
constexpr int kThreads = 256;      // K9's threads a block
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

// K9. nb[lr][k] = match(K-1-k, row0 + lr) or -1; a gathered row i whose
// row_sel[i] <= 0 counts as absent (K4 left out[i] zero, so g[i] reaches no
// x): the exact adjoint of K4 for any row flag. T: the element type of g
// and dx; w and the sums are float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scalar_conv_dx_kernel(const T* __restrict__ g,
                      const float* __restrict__ w,
                      const int* __restrict__ aux,
                      const int* __restrict__ skeys,
                      const int* __restrict__ srow,
                      const float* __restrict__ row_sel,
                      T* __restrict__ dx, int n, int side, int cout,
                      int n_keys) {
  extern __shared__ __align__(16) float ws[];  // [kvol, cout]
  __shared__ int nb[kRows][kMaxVol];

  const int tid = threadIdx.x;
  const int kvol = side * side * side;
  const int s2 = side * side;
  const int rad = side / 2;
  const int row0 = blockIdx.x * kRows;
  for (int e = tid; e < kvol * cout; e += kThreads) ws[e] = __ldg(w + e);
  for (int e = tid; e < kRows * kvol; e += kThreads) {
    const int lr = e / kvol;
    const int k = e % kvol;
    const int j = row0 + lr;
    int i = -1;
    if (j < n) {
      const int kr = kvol - 1 - k;  // the mirrored offset
      const int p = neighbor_pos(aux + (size_t)j * 8, kr / s2 - rad,
                                 (kr / side) % side - rad, kr % side - rad,
                                 skeys, n_keys);
      if (p >= 0) {
        i = __ldg(srow + p);
        if (row_sel != nullptr && !(__ldg(row_sel + i) > 0.f)) i = -1;
      }
    }
    nb[lr][k] = i;
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int lr = warp; lr < kRows; lr += kThreads / 32) {
    const int j = row0 + lr;
    if (j >= n) break;
    float acc = 0.f;
    for (int k = 0; k < kvol; ++k) {
      const int i = nb[lr][k];  // the same for the whole warp
      if (i < 0) continue;
      const T* gi = g + (size_t)i * cout;
      const float* wk = ws + k * cout;
      for (int c = lane; c < cout; c += 32) {
        acc = fmaf(ldg_f32(gi + c), wk[c], acc);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) dx[j] = from_f32<T>(acc);
  }
}

// What a launcher works out about its kernel once a device and reuses
// after (asking the runtime at every launch costs host time beside a
// kernel of a tenth of a millisecond): the dynamic shared memory its
// attribute allows, and how many blocks fit on the card at once with a
// given size. One for each kernel instantiation (a static in its
// launcher).
class LaunchCache {
 public:
  // Lets kernel launch on device dev with smem bytes of dynamic shared
  // memory (always asked for explicitly: K4 / K5's sit beside a static
  // Tile, K9's beside its neighbour table).
  template <typename Kernel>
  cudaError_t allow(Kernel kernel, int dev, size_t smem) {
    std::lock_guard<std::mutex> lock(mu_);
    if (dev < kMaxDevices && allowed_[dev] >= smem) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess && dev < kMaxDevices) allowed_[dev] = smem;
    return err;
  }

  // *blocks: how many blocks of kernel (threads each, smem bytes of
  // dynamic shared memory) fit on device dev at once, at least one an SM.
  template <typename Kernel>
  cudaError_t resident_blocks(Kernel kernel, int dev, int threads,
                              size_t smem, int* blocks) {
    std::lock_guard<std::mutex> lock(mu_);
    if (dev < kMaxDevices && occ_smem_[dev] == smem && occ_[dev] > 0) {
      *blocks = occ_[dev];
      return cudaSuccess;
    }
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    *blocks = (per_sm > 1 ? per_sm : 1) * sms;
    if (dev < kMaxDevices) {
      occ_smem_[dev] = smem;
      occ_[dev] = *blocks;
    }
    return cudaSuccess;
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::mutex mu_;
  size_t allowed_[kMaxDevices] = {};
  size_t occ_smem_[kMaxDevices] = {};
  int occ_[kMaxDevices] = {};
};

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
  static LaunchCache cache;
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
  static LaunchCache cache;
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

template <typename T>
int launch_dx(const T* g, const float* w, const int* aux, const int* skeys,
              const int* srow, const float* row_sel, T* dx, int n, int side,
              int cout, int n_keys, void* stream) {
  static LaunchCache cache;
  const size_t smem = sizeof(float) * side * side * side * cout;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cache.allow(scalar_conv_dx_kernel<T>, dev, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows);
  scalar_conv_dx_kernel<T><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      g, w, aux, skeys, srow, row_sel, dx, n, side, cout, n_keys);
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

// Counts the keys that K4 and K5's launches stage into *counter (unsigned
// long long on the device) from now on; nullptr stops counting. For
// checks only. Returns a cudaError_t as int.
extern "C" int scalar_conv_count_keys(void* counter) {
  return kw::set_staged_key_counter(counter);
}

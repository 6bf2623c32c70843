// Occupancy convolution (conv1 of an in_ch == 1 model), forward, for
// Hopper (sm_90a).
//
// Replaces gcl_tpu/core/pallas_conv.py:_fwd_c1z_kernel (TPU kernel K2,
// wrapper fused_conv_c1z_fwd):
//
//   out[i, :] = sum_k present_k(i) * W[k, 0, :]
//   sbits[i, dx] bit (dy * side + dz) = present_(dx, dy, dz)(i)
//
// where present_k(i) says that the voxel at offset k of row i exists: its
// grid-shifted coords stay inside [0, 2^B) on every axis and its packed key
// is among the level's sorted valid keys. Exact only under the in_ch == 1
// occupancy contract (features are ones on valid rows), which the serving
// path meets; the kernel never reads features.
//
// What bounds it on this card: key searches. The bytes are few (the aux
// rows, 32 outputs a row, 16 KB of weights); each row has up to k^3 = 125
// neighbours to find among the level's keys.
//
// What the design does about it: as the TPU kernel, a block owns a tile of
// rows and, per dx, reads only the run of sorted keys that the tile's
// neighbours at that dx can have: the packed keys are cloud | x | y | z, so
// one dx of a run of key-sorted rows spans one run of keys. Clouds >= 16
// have negative keys, so a tile that mixes clouds can have two runs, one of
// negative and one of non-negative keys. The block works out its runs
// itself: it reduces each run's key bounds over its rows, then one warp a
// run end finds it in the level with a 32-way search
// (kernels/occupancy_conv.py:occupancy_windows is the same table in plain
// torch). The block stages the runs of all dx one
// after the other into shared memory -- each dx's negative run before its
// non-negative one, so each dx's keys stay sorted -- with cp.async, in
// chunks double-buffered when they exceed one. In a chunk, one lower bound
// in shared memory at the dz = -R key of each (row, dx, dy), then at most
// side consecutive keys, set the side dz bits: side^2 short searches a row
// in shared memory in place of side^3 long ones in global memory.
// Grid-edge validity masks each bit (a key reached across a field edge is
// another voxel's). W lives in shared memory; each output sums the present
// offsets' weights in offset order, visiting the set bits only, four
// channels a thread, and is written coalesced. sbits keeps the layout that
// gcl_tpu's c1z_unpack_bits and dW kernel (K3) read.
//
// The bf16 form (occupancy_conv_fwd_bf16, for a bf16 model: gcl_tpu casts
// W to the features' type, _c1z_w3) takes W already rounded to bf16, sums
// it in float32 as above and rounds each output to bf16 once; sbits are
// the same.

#include <climits>

#include <cuda_runtime.h>

#include "elem.cuh"
#include "key_search.cuh"
#include "key_window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;    // rows of a tile: occupancy_conv.TILE
constexpr int kMaxSide = 5;   // occupancy_conv.MAX_SIDE
constexpr int kRowWarps = kTile / 32;

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned int*>(&a);
  u.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ int clamp_int32(long long v) {
  return static_cast<int>(max((long long)INT_MIN, min((long long)INT_MAX, v)));
}

// T: the element type of w and out (float or bf16); sums are float32
template <typename T>
__global__ void __launch_bounds__(kThreads)
occupancy_conv_fwd_kernel(const int* __restrict__ aux,
                          const int* __restrict__ skeys,
                          const T* __restrict__ w, T* __restrict__ out,
                          int* __restrict__ sbits, int n_keys, int n,
                          int side, int cout, int chunk) {
  // [kvol, cout] weights, then 2 x [chunk] keys
  extern __shared__ __align__(16) float ws[];
  __shared__ unsigned int bits_s[kTile][8];
  __shared__ int aux_s[kTile][4];
  // per row warp, dx group and run: the least and greatest key (run 0:
  // negative keys, run 1: non-negative ones), then the same over the tile
  __shared__ long long red[kRowWarps][kMaxSide][2][2];
  __shared__ long long bnd[kMaxSide][2][2];
  __shared__ int ends[kMaxSide][2][2];
  // window of dx group g: run h of it at s0[g][h], ln[g][h] keys; it sits at
  // [off[g], off[g + 1]) of the staged sequence
  __shared__ int s0[kMaxSide][2], ln[kMaxSide][2], off[kMaxSide + 1];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int kvol = side * side * side;
  const int s2 = side * side;
  const int rad = side / 2;
  const int row0 = blockIdx.x * kTile;
  int* keys = reinterpret_cast<int*>(ws + kvol * cout);

  for (int e = tid; e < kvol * cout; e += kThreads) ws[e] = ldg_f32(w + e);
  for (int e = tid; e < kTile * 8; e += kThreads) bits_s[e / 8][e % 8] = 0u;
  for (int e = tid; e < kTile * 4; e += kThreads) {
    const int i = row0 + e / 4;
    aux_s[e / 4][e % 4] = i < n ? __ldg(aux + (size_t)i * 8 + e % 4) : 0;
  }
  __syncthreads();

  // The windows. A row that can have a neighbour at dx (its y and z within
  // R of the grid, x + dx on it) has them among the keys [q + (dx << (BY +
  // BZ)) - (R << BZ) - R, q + (dx << (BY + BZ)) + (R << BZ) + R], split at
  // 0 into a negative and a non-negative part.
  if (warp < kRowWarps) {
    const int lr = tid;
    const bool row = row0 + lr < n && aux_s[lr][2] >= -rad &&
                     aux_s[lr][2] < (1 << kKeyBY) + rad &&
                     aux_s[lr][3] >= -rad &&
                     aux_s[lr][3] < (1 << kKeyBZ) + rad;
    const long long reach = (long long)rad * (1 << kKeyBZ) + rad;
    for (int g = 0; g < side; ++g) {
      const int dx = g - rad;
      const bool live = row && aux_s[lr][1] + dx >= 0 &&
                        aux_s[lr][1] + dx < (1 << kKeyBX);
      const long long lo = (long long)aux_s[lr][0] +
                           (long long)dx * (1 << (kKeyBY + kKeyBZ)) - reach;
      const long long hi = lo + 2 * reach;
      const bool neg = live && lo < 0, pos = live && hi >= 0;
      const long long nlo = kw::warp_reduce<false>(neg ? lo : LLONG_MAX);
      const long long nhi =
          kw::warp_reduce<true>(neg ? min(hi, -1LL) : LLONG_MIN);
      const long long plo =
          kw::warp_reduce<false>(pos ? max(lo, 0LL) : LLONG_MAX);
      const long long phi = kw::warp_reduce<true>(pos ? hi : LLONG_MIN);
      if (lane == 0) {
        red[warp][g][0][0] = nlo;
        red[warp][g][0][1] = nhi;
        red[warp][g][1][0] = plo;
        red[warp][g][1][1] = phi;
      }
    }
  }
  __syncthreads();
  if (tid < 4 * side) {
    const int g = tid >> 2, h = (tid >> 1) & 1, e = tid & 1;
    long long r = e ? LLONG_MIN : LLONG_MAX;
    for (int wp = 0; wp < kRowWarps; ++wp) {
      r = e ? max(r, red[wp][g][h][e]) : min(r, red[wp][g][h][e]);
    }
    bnd[g][h][e] = r;
  }
  __syncthreads();
  // end e of run h of dx group g: the first key >= its least key (e = 0)
  // or > its greatest (e = 1), one warp a search
  for (int j = warp; j < 4 * side; j += kThreads / 32) {
    const int g = j >> 2, h = (j >> 1) & 1, e = j & 1;
    if (bnd[g][h][0] > bnd[g][h][1]) continue;
    const int v = clamp_int32(bnd[g][h][e]);
    const int p = kw::warp_partition_point(n_keys, [&](int p) {
      const int k = __ldg(skeys + p);
      return e ? k <= v : k < v;
    });
    if (lane == 0) ends[g][h][e] = p;
  }
  __syncthreads();
  if (tid < 2 * side) {
    const int g = tid >> 1, h = tid & 1;
    const bool any = bnd[g][h][0] <= bnd[g][h][1];
    s0[g][h] = any ? ends[g][h][0] : 0;
    ln[g][h] = any ? max(ends[g][h][1] - ends[g][h][0], 0) : 0;
  }
  __syncthreads();
  if (tid == 0) {
    off[0] = 0;
    for (int g = 0; g < side; ++g) off[g + 1] = off[g] + ln[g][0] + ln[g][1];
  }
  __syncthreads();
  const int total = off[side];
  const int nch = (total + chunk - 1) / chunk;

  // copy positions [c * chunk, ...) of the staged sequence into buf,
  // counting the keys this thread issues copies for
  unsigned int staged = 0u;
  auto stage = [&](int* buf, int c) {
    const int c0 = c * chunk, c1 = min(total, c0 + chunk);
    for (int g = 0; g < side; ++g) {
      const int a = max(off[g], c0), b = min(off[g + 1], c1);
      for (int e = a + tid; e < b; e += kThreads, ++staged) {
        const int v = e - off[g];
        kw::cp_async4(buf + (e - c0),
                      skeys + (v < ln[g][0] ? s0[g][0] + v
                                            : s0[g][1] + v - ln[g][0]));
      }
    }
    kw::cp_async_commit();
  };

  if (nch > 0) stage(keys, 0);
  for (int c = 0; c < nch; ++c) {
    const int* buf = keys + (c & 1) * chunk;
    if (c + 1 < nch) {
      stage(keys + ((c + 1) & 1) * chunk, c + 1);
      kw::cp_async_wait<1>();
    } else {
      kw::cp_async_wait<0>();
    }
    __syncthreads();
    const int c0 = c * chunk, c1 = min(total, c0 + chunk);
    for (int e = tid; e < kTile * s2; e += kThreads) {
      const int lr = e / s2;
      const int g = (e % s2) / side;
      const int dyi = e % side;
      // dx group g's keys in this chunk: buf[a, b)
      const int a = max(off[g], c0) - c0, b = min(off[g + 1], c1) - c0;
      if (a >= b || row0 + lr >= n) continue;
      const int ux = aux_s[lr][1] + g - rad;
      const int uy = aux_s[lr][2] + dyi - rad;
      if (ux < 0 || ux >= (1 << kKeyBX) || uy < 0 || uy >= (1 << kKeyBY)) {
        continue;
      }
      // the keys of dz = -R .. R (no carry past the z field when dx and dy
      // stay in range; int64 so that the ends of the run cannot wrap)
      const long long lo = (long long)aux_s[lr][0] +
                           (long long)(g - rad) * (1 << (kKeyBY + kKeyBZ)) +
                           (long long)(dyi - rad) * (1 << kKeyBZ) - rad;
      const long long hi = lo + 2 * rad;
      if (hi < buf[a] || lo > buf[b - 1]) continue;
      const int uz = aux_s[lr][3];
      unsigned int found = 0u;
      int p = lo < buf[a] ? a
                          : a + kw::smem_lower_bound(buf + a, b - a, (int)lo);
      for (; p < b && buf[p] <= hi; ++p) {
        const int dzi = static_cast<int>(buf[p] - lo);
        const int z = uz + dzi - rad;
        if (z >= 0 && z < (1 << kKeyBZ)) found |= 1u << dzi;
      }
      if (found) atomicOr(&bits_s[lr][g], found << (dyi * side));
    }
    __syncthreads();  // the buffer is staged over two chunks later
  }
  __syncthreads();  // bits_s, also where no window had keys
  kw::count_staged_keys(staged);

  for (int e = tid; e < kTile * 8; e += kThreads) {
    const int i = row0 + e / 8;
    if (i < n) {
      sbits[(size_t)i * 8 + e % 8] = static_cast<int>(bits_s[e / 8][e % 8]);
    }
  }
  // the present offsets k = dx * side^2 + bit in ascending order: the sum
  // order of the plain version's present terms
  if (cout % 4 == 0) {
    const int c4 = cout / 4;
    for (int e = tid; e < kTile * c4; e += kThreads) {
      const int lr = e / c4;
      const int c = (e % c4) * 4;
      const int i = row0 + lr;
      if (i >= n) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int g = 0; g < side; ++g) {
        unsigned int bm = bits_s[lr][g];
        while (bm) {
          const int j = __ffs(bm) - 1;
          bm &= bm - 1;
          const float4 v =
              *reinterpret_cast<const float4*>(ws + (g * s2 + j) * cout + c);
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
      }
      store4(out + (size_t)i * cout + c, acc);
    }
  } else {
    for (int e = tid; e < kTile * cout; e += kThreads) {
      const int lr = e / cout;
      const int c = e % cout;
      const int i = row0 + lr;
      if (i >= n) continue;
      float acc = 0.f;
      for (int g = 0; g < side; ++g) {
        unsigned int bm = bits_s[lr][g];
        while (bm) {
          const int j = __ffs(bm) - 1;
          bm &= bm - 1;
          acc += ws[(g * s2 + j) * cout + c];
        }
      }
      out[(size_t)i * cout + c] = from_f32<T>(acc);
    }
  }
}

template <typename T>
int launch(const int* aux, const int* skeys, const T* w, T* out, int* sbits,
           int n_keys, int n, int side, int cout, int chunk, void* stream) {
  if (chunk < 1 || side < 1 || side > kMaxSide) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * side * side * side * cout + sizeof(int) * 2 * chunk;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        occupancy_conv_fwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_tiles = (n + kTile - 1) / kTile;
  occupancy_conv_fwd_kernel<T><<<n_tiles, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      aux, skeys, w, out, sbits, n_keys, n, side, cout, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// aux int32[n, 8], skeys int32[n_keys] (sorted, signed), w f32[side^3, 1,
// cout], out f32[n, cout], sbits int32[n, 8]; chunk: keys staged at a time
// (> 0). All contiguous on the device. side odd, 1 <= side <= 5; one block
// a tile of 128 rows. Launches on `stream`; returns cudaGetLastError().
extern "C" int occupancy_conv_fwd(const int* aux, const int* skeys,
                                  const float* w, float* out, int* sbits,
                                  int n_keys, int n, int side, int cout,
                                  int chunk, void* stream) {
  return launch(aux, skeys, w, out, sbits, n_keys, n, side, cout, chunk,
                stream);
}

// The bf16 form: w bf16[side^3, 1, cout] (rounded by the caller) and out
// bf16[n, cout]; otherwise as above.
extern "C" int occupancy_conv_fwd_bf16(const int* aux, const int* skeys,
                                       const bf16* w, bf16* out, int* sbits,
                                       int n_keys, int n, int side, int cout,
                                       int chunk, void* stream) {
  return launch(aux, skeys, w, out, sbits, n_keys, n, side, cout, chunk,
                stream);
}

// Counts the keys that this source's launches stage into *counter
// (unsigned long long on the device) from now on; nullptr stops counting.
// For checks only. Returns a cudaError_t as int.
extern "C" int occupancy_conv_fwd_count_keys(void* counter) {
  return kw::set_staged_key_counter(counter);
}

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
// chunks double-buffered when they exceed one (the cube windows of
// csrc/key_window.cuh, which K4 and K5 share). In a chunk, one lower bound
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

#include <cuda_runtime.h>

#include "elem.cuh"
#include "key_window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;    // rows of a tile: occupancy_conv.TILE
constexpr int kMaxSide = 5;   // occupancy_conv.MAX_SIDE

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
  __shared__ kw::CubeWindows<kTile, kMaxSide> cw;

  const int tid = threadIdx.x;
  const int kvol = side * side * side;
  const int s2 = side * side;
  const int row0 = blockIdx.x * kTile;
  int* keys = reinterpret_cast<int*>(ws + kvol * cout);

  for (int e = tid; e < kvol * cout; e += kThreads) ws[e] = ldg_f32(w + e);
  for (int e = tid; e < kTile * 8; e += kThreads) bits_s[e / 8][e % 8] = 0u;
  for (int e = tid; e < kTile * 4; e += kThreads) {
    const int i = row0 + e / 4;
    aux_s[e / 4][e % 4] = i < n ? __ldg(aux + (size_t)i * 8 + e % 4) : 0;
  }
  __syncthreads();
  kw::cube_windows<kTile, kMaxSide, kThreads>(cw, aux_s, nullptr, n - row0,
                                              side, skeys, n_keys);

  // In a chunk, one lower bound at the dz = -R key of each (row, dx, dy)
  // and a scan of at most side keys set its side dz bits.
  kw::for_each_window_chunk<kTile, kMaxSide, kThreads>(
      cw, side, skeys, keys, chunk, [](int, int) {},
      [&](int, const int* buf, int, int c0, int c1) {
        for (int e = tid; e < kTile * s2; e += kThreads) {
          const int lr = e / s2;
          const int g = (e % s2) / side;
          const int dyi = e % side;
          int a, b, first;
          long long lo;
          if (row0 + lr >= n || !kw::chunk_run(cw, g, c0, c1, &a, &b) ||
              !kw::cube_run_keys(aux_s[lr], g, dyi, side, &lo) ||
              lo + 2 * (side / 2) < buf[a] || lo > buf[b - 1]) {
            continue;
          }
          int p = lo < buf[a]
                      ? a
                      : a + kw::smem_lower_bound(buf + a, b - a, (int)lo);
          const unsigned int found =
              kw::cube_run_scan(buf, &p, b, lo, aux_s[lr][3], side, &first);
          if (found) atomicOr(&bits_s[lr][g], found << (dyi * side));
        }
      });

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

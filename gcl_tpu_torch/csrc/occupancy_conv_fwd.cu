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
// What bounds it on this card: key searches. Each row runs up to k^3 = 125
// binary searches of ~16 steps over the level's keys (<= 147 KB, resident
// in L2); the output is only 32 floats a row and the weights 16 KB.
//
// What the design does about it: a block owns 64 rows; its 256 threads
// spread the 64 x 125 (row, offset) searches evenly and set presence bits
// in shared memory with atomicOr, so no thread serialises a row's 125
// searches. W lives in shared memory, and each output is the sum of the
// present offsets' weights in offset order, written coalesced. sbits keeps
// the layout that gcl_tpu's c1z_unpack_bits and dW kernel (K3) read.

#include <cuda_runtime.h>

#include "key_search.cuh"

namespace {

constexpr int kRows = 64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
occupancy_conv_fwd_kernel(const int* __restrict__ aux,
                          const int* __restrict__ skeys,
                          const float* __restrict__ w,
                          float* __restrict__ out, int* __restrict__ sbits,
                          int n, int side, int cout, int n_keys) {
  extern __shared__ float ws[];  // [kvol, cout]
  __shared__ unsigned int bits_s[kRows][8];

  const int tid = threadIdx.x;
  const int kvol = side * side * side;
  const int s2 = side * side;
  const int rad = side / 2;
  const int row0 = blockIdx.x * kRows;

  for (int e = tid; e < kvol * cout; e += kThreads) ws[e] = __ldg(w + e);
  for (int e = tid; e < kRows * 8; e += kThreads) bits_s[e / 8][e % 8] = 0u;
  __syncthreads();

  for (int e = tid; e < kRows * kvol; e += kThreads) {
    const int lr = e / kvol;
    const int k = e % kvol;
    const int i = row0 + lr;
    if (i >= n) continue;
    const int dxi = k / s2;
    const int dyi = (k / side) % side;
    const int dzi = k % side;
    if (neighbor_pos(aux + (size_t)i * 8, dxi - rad, dyi - rad, dzi - rad,
                     skeys, n_keys) >= 0) {
      atomicOr(&bits_s[lr][dxi], 1u << (dyi * side + dzi));
    }
  }
  __syncthreads();

  for (int e = tid; e < kRows * 8; e += kThreads) {
    const int i = row0 + e / 8;
    if (i < n) sbits[(size_t)i * 8 + e % 8] = static_cast<int>(bits_s[e / 8][e % 8]);
  }
  for (int e = tid; e < kRows * cout; e += kThreads) {
    const int lr = e / cout;
    const int c = e % cout;
    const int i = row0 + lr;
    if (i >= n) continue;
    float acc = 0.f;
    for (int k = 0; k < kvol; ++k) {
      if ((bits_s[lr][k / s2] >> (k % s2)) & 1u) acc += ws[k * cout + c];
    }
    out[(size_t)i * cout + c] = acc;
  }
}

}  // namespace

// aux int32[n, 8], skeys int32[n_keys], w f32[side^3, 1, cout],
// out f32[n, cout], sbits int32[n, 8]; all contiguous on the device.
// side odd, 1 <= side <= 5. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int occupancy_conv_fwd(const int* aux, const int* skeys,
                                  const float* w, float* out, int* sbits,
                                  int n, int side, int cout, int n_keys,
                                  void* stream) {
  const size_t smem = sizeof(float) * side * side * side * cout;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        occupancy_conv_fwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kRows - 1) / kRows);
  occupancy_conv_fwd_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      aux, skeys, w, out, sbits, n, side, cout, n_keys);
  return static_cast<int>(cudaGetLastError());
}

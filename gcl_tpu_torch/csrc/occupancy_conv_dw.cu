// Occupancy convolution (conv1 of an in_ch == 1 model), weight gradient,
// for Hopper (sm_90a).
//
// Replaces gcl_tpu/core/pallas_conv.py:_dw_c1z_kernel (TPU kernel K3,
// wrapper fused_conv_c1z_dw):
//
//   dW[k, 0, :] = sum_i present_k(i) * g[i, :]
//
// with present_k(i) read back from the forward's presence bitmasks:
// bit (dy * side + dz) of sbits[i, dx]. No key search and no gather.
//
// What bounds it on this card: the masked adds, N x k^3 x Cout of them
// (2e9 at 516,096 rows, k = 5, Cout = 32) against 70 MB of g and sbits
// read once; the output is 16 KB.
//
// What the design does about it: a block walks many 64-row chunks
// (grid-stride), stages each chunk's g rows and bitmasks in shared memory,
// and every thread owns a fixed set of (k, c) outputs whose partial sums
// stay in shared memory for the block's whole walk. A warp's 32 outputs
// share one k when Cout is a multiple of 32, so the bit test is uniform
// over the warp and absent (row, k) pairs cost one branch. On the TPU the
// grid runs in order and carries dW from tile to tile; here each block
// adds its partial to global memory with atomicAdd once, at the end
// (blocks x k^3 x Cout atomics). The order of that sum changes from run to
// run, so dW agrees with the plain version to float32 rounding.
//
// The bf16 form (occupancy_conv_dw_bf16) reads g in bf16 and sums it in
// float32 as above; dW is float32.

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kRows = 64;
constexpr int kThreads = 256;

// T: the element type of g (float or bf16); dw and the sums are float32
template <typename T>
__global__ void __launch_bounds__(kThreads)
occupancy_conv_dw_kernel(const int* __restrict__ sbits,
                         const T* __restrict__ g, float* __restrict__ dw,
                         int n, int side, int cout) {
  extern __shared__ __align__(16) float smem[];
  const int kvol = side * side * side;
  const int s2 = side * side;
  float* part = smem;                 // [kvol, cout]
  float* gs = part + kvol * cout;     // [kRows, cout]
  unsigned int* sb = reinterpret_cast<unsigned int*>(gs + kRows * cout);

  const int tid = threadIdx.x;
  const int n_out = kvol * cout;
  for (int e = tid; e < n_out; e += kThreads) part[e] = 0.f;

  const int n_chunks = (n + kRows - 1) / kRows;
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int row0 = chunk * kRows;
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < kRows * cout; e += kThreads) {
      const int i = row0 + e / cout;
      gs[e] = i < n ? ldg_f32(g + (size_t)i * cout + e % cout) : 0.f;
    }
    for (int e = tid; e < kRows * 8; e += kThreads) {
      const int i = row0 + e / 8;
      sb[e] = i < n ? static_cast<unsigned int>(
                          __ldg(sbits + (size_t)i * 8 + e % 8))
                    : 0u;
    }
    __syncthreads();
    for (int e = tid; e < n_out; e += kThreads) {
      const int k = e / cout;
      const int c = e % cout;
      const int col = k / s2;
      const unsigned int bit = 1u << (k % s2);
      float acc = 0.f;
      for (int r = 0; r < kRows; ++r) {
        if (sb[r * 8 + col] & bit) acc += gs[r * cout + c];
      }
      part[e] += acc;  // this thread alone owns part[e]
    }
  }
  __syncthreads();
  for (int e = tid; e < n_out; e += kThreads) {
    const float v = part[e];
    if (v != 0.f) atomicAdd(dw + e, v);
  }
}

template <typename T>
int launch(const int* sbits, const T* g, float* dw, int n, int side, int cout,
           void* stream) {
  const int kvol = side * side * side;
  const size_t smem = sizeof(float) * (kvol + kRows) * cout +
                      sizeof(unsigned int) * kRows * 8;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(occupancy_conv_dw_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (n + kRows - 1) / kRows;
  int blocks = 4 * sms;
  if (blocks > n_chunks) blocks = n_chunks;
  occupancy_conv_dw_kernel<T><<<blocks, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      sbits, g, dw, n, side, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sbits int32[n, 8], g f32[n, cout], dw f32[side^3, 1, cout]; contiguous
// on the device, dw zeroed by the caller. side odd, 1 <= side <= 5.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int occupancy_conv_dw(const int* sbits, const float* g, float* dw,
                                 int n, int side, int cout, void* stream) {
  return launch(sbits, g, dw, n, side, cout, stream);
}

// The bf16 form: g bf16[n, cout]; dw float32, otherwise as above.
extern "C" int occupancy_conv_dw_bf16(const int* sbits, const bf16* g,
                                      float* dw, int n, int side, int cout,
                                      void* stream) {
  return launch(sbits, g, dw, n, side, cout, stream);
}

// Scalar-feature (Cin == 1) sparse convolution that READS its features,
// forward and weight gradient, for Hopper (sm_90a).
//
// Replaces gcl_tpu/core/pallas_conv.py:_fwd_c1_kernel (TPU kernel K4,
// wrapper _conv_c1_fwd) and _dw_c1_kernel (K5, wrapper _conv_c1_dw) on a
// stride-1 same-level odd stencil. With match(k, i) the row of the voxel
// at offset k of row i (none: the term is zero):
//
//   K4:  out[i, :]    = sum_k x[match(k, i)] * W[k, 0, :]
//   K5:  dW[k, 0, :]  = sum_i x[match(k, i)] * g[i, :]
//
// On the train path x is the eps term of the exact input jitter: zero off
// the jittered (centre) clouds.
//
// What bounds them on this card: key searches, up to k^3 = 125 per row
// over the level's sorted keys (resident in L2), then k^3 x Cout FMAs per
// row; x, g and out are 4-132 bytes a row.
//
// What the design does about it: match(k, i) is resolved exactly as the
// occupancy forward (K2) resolves presence -- from the row's occupancy aux
// with the same grid-edge masks -- so no 125 x N table of query keys is
// built or read. A block's 256 threads spread the (row, offset) searches
// of a 32-row chunk evenly and leave the matched scalars in shared memory;
// K4 then sums them against W held in shared memory, K5 against the
// chunk's g rows. The TPU gates the eps conv's windows to tiles that can
// see a jittered row; here an optional per-row flag (row_sel of the OUTPUT
// row) skips a row's searches: a same-level conv never leaves the row's
// cloud, so where x is zero off the flagged clouds the result is the same
// to the last bit. K5 combines blocks as the occupancy dW (K3) does: each
// block walks many chunks, keeps its partial dW in shared memory and adds
// it to global memory with atomicAdd once, so dW agrees with the plain
// version to float32 rounding.

#include <cuda_runtime.h>

#include "key_search.cuh"

namespace {

constexpr int kRows = 32;
constexpr int kMaxVol = 125;  // side <= 5
constexpr int kThreads = 256;

// xv[lr][k] = x[match(k, row0 + lr)], zero where there is none.
__device__ __forceinline__ void gather_scalars(
    float (*xv)[kMaxVol], const float* __restrict__ x,
    const int* __restrict__ aux, const int* __restrict__ skeys,
    const int* __restrict__ srow, const float* __restrict__ row_sel,
    int row0, int n, int side, int n_keys) {
  const int kvol = side * side * side;
  const int s2 = side * side;
  const int rad = side / 2;
  for (int e = threadIdx.x; e < kRows * kvol; e += kThreads) {
    const int lr = e / kvol;
    const int k = e % kvol;
    const int i = row0 + lr;
    float v = 0.f;
    if (i < n && (row_sel == nullptr || __ldg(row_sel + i) > 0.f)) {
      const int p = neighbor_pos(aux + (size_t)i * 8, k / s2 - rad,
                                 (k / side) % side - rad, k % side - rad,
                                 skeys, n_keys);
      if (p >= 0) v = __ldg(x + __ldg(srow + p));
    }
    xv[lr][k] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
scalar_conv_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ aux,
                       const int* __restrict__ skeys,
                       const int* __restrict__ srow,
                       const float* __restrict__ row_sel,
                       float* __restrict__ out, int n, int side, int cout,
                       int n_keys) {
  extern __shared__ __align__(16) float ws[];  // [kvol, cout]
  __shared__ float xv[kRows][kMaxVol];

  const int tid = threadIdx.x;
  const int kvol = side * side * side;
  const int row0 = blockIdx.x * kRows;
  for (int e = tid; e < kvol * cout; e += kThreads) ws[e] = __ldg(w + e);
  gather_scalars(xv, x, aux, skeys, srow, row_sel, row0, n, side, n_keys);
  __syncthreads();

  for (int e = tid; e < kRows * cout; e += kThreads) {
    const int lr = e / cout;
    const int c = e % cout;
    const int i = row0 + lr;
    if (i >= n) continue;
    float acc = 0.f;
    for (int k = 0; k < kvol; ++k) acc = fmaf(xv[lr][k], ws[k * cout + c], acc);
    out[(size_t)i * cout + c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
scalar_conv_dw_kernel(const float* __restrict__ x,
                      const float* __restrict__ g,
                      const int* __restrict__ aux,
                      const int* __restrict__ skeys,
                      const int* __restrict__ srow,
                      const float* __restrict__ row_sel,
                      float* __restrict__ dw, int n, int side, int cout,
                      int n_keys) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float xv[kRows][kMaxVol];
  const int kvol = side * side * side;
  float* part = smem;              // [kvol, cout]
  float* gs = part + kvol * cout;  // [kRows, cout]

  const int tid = threadIdx.x;
  const int n_out = kvol * cout;
  for (int e = tid; e < n_out; e += kThreads) part[e] = 0.f;

  const int n_chunks = (n + kRows - 1) / kRows;
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int row0 = chunk * kRows;
    __syncthreads();  // the previous chunk's readers are done
    gather_scalars(xv, x, aux, skeys, srow, row_sel, row0, n, side, n_keys);
    for (int e = tid; e < kRows * cout; e += kThreads) {
      const int i = row0 + e / cout;
      gs[e] = i < n ? __ldg(g + (size_t)i * cout + e % cout) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < n_out; e += kThreads) {
      const int k = e / cout;
      const int c = e % cout;
      float acc = 0.f;
      for (int r = 0; r < kRows; ++r) {
        acc = fmaf(xv[r][k], gs[r * cout + c], acc);
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024 - sizeof(float) * kRows * kMaxVol) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// x f32[n, 1], w f32[side^3, 1, cout], aux int32[n, 8], skeys / srow
// int32[n_keys], row_sel f32[n] or null (rows with row_sel <= 0 are
// skipped and come out zero), out f32[n, cout]; contiguous on the device.
// side odd, 1 <= side <= 5. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int scalar_conv_fwd(const float* x, const float* w, const int* aux,
                               const int* skeys, const int* srow,
                               const float* row_sel, float* out, int n,
                               int side, int cout, int n_keys, void* stream) {
  const size_t smem = sizeof(float) * side * side * side * cout;
  const cudaError_t err = allow_smem(scalar_conv_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows);
  scalar_conv_fwd_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, w, aux, skeys, srow, row_sel, out, n, side, cout, n_keys);
  return static_cast<int>(cudaGetLastError());
}

// As above with g f32[n, cout] and dw f32[side^3, 1, cout], zeroed by the
// caller.
extern "C" int scalar_conv_dw(const float* x, const float* g, const int* aux,
                              const int* skeys, const int* srow,
                              const float* row_sel, float* dw, int n,
                              int side, int cout, int n_keys, void* stream) {
  const size_t smem =
      sizeof(float) * (side * side * side + kRows) * cout;
  cudaError_t err = allow_smem(scalar_conv_dw_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (n + kRows - 1) / kRows;
  int blocks = 4 * sms;
  if (blocks > n_chunks) blocks = n_chunks;
  scalar_conv_dw_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, g, aux, skeys, srow, row_sel, dw, n, side, cout, n_keys);
  return static_cast<int>(cudaGetLastError());
}

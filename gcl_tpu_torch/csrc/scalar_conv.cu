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
// version to float32 rounding. K9 resolves its neighbours the same way, 125
// searches a row, then reads one g row of Cout floats per match: a warp
// takes a row at a time, its lanes spread over the channels so that each
// matched g row is one coalesced read, and the lanes' partial sums meet in
// a shuffle reduction. It is bound by those reads (g once is N * Cout * 4
// bytes; each row of g is read once per row it neighbours, from L2).
//
// The bf16 forms (the *_bf16 entry points, a bf16 model's eps term) read x
// and g in bf16 and store out and dX in bf16, rounded once; W stays
// float32, as gcl_tpu's c1 / co1 kernels keep it (they take the weights as
// float32 whatever the features' type), and every product and sum is
// float32; dW is float32.

#include <cuda_runtime.h>

#include "elem.cuh"
#include "key_search.cuh"

namespace {

constexpr int kRows = 32;
constexpr int kMaxVol = 125;  // side <= 5
constexpr int kThreads = 256;

// xv[lr][k] = x[match(k, row0 + lr)], zero where there is none.
template <typename T>
__device__ __forceinline__ void gather_scalars(
    float (*xv)[kMaxVol], const T* __restrict__ x,
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
      if (p >= 0) v = ldg_f32(x + __ldg(srow + p));
    }
    xv[lr][k] = v;
  }
}

// T: the element type of x and out (float or bf16); w and the sums are
// float32
template <typename T>
__global__ void __launch_bounds__(kThreads)
scalar_conv_fwd_kernel(const T* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ aux,
                       const int* __restrict__ skeys,
                       const int* __restrict__ srow,
                       const float* __restrict__ row_sel,
                       T* __restrict__ out, int n, int side, int cout,
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
    out[(size_t)i * cout + c] = from_f32<T>(acc);
  }
}

// T: the element type of x and g; dw and the sums are float32
template <typename T>
__global__ void __launch_bounds__(kThreads)
scalar_conv_dw_kernel(const T* __restrict__ x,
                      const T* __restrict__ g,
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
      gs[e] = i < n ? ldg_f32(g + (size_t)i * cout + e % cout) : 0.f;
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024 - sizeof(float) * kRows * kMaxVol) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_fwd(const T* x, const float* w, const int* aux, const int* skeys,
               const int* srow, const float* row_sel, T* out, int n,
               int side, int cout, int n_keys, void* stream) {
  const size_t smem = sizeof(float) * side * side * side * cout;
  const cudaError_t err = allow_smem(scalar_conv_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows);
  scalar_conv_fwd_kernel<T><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      x, w, aux, skeys, srow, row_sel, out, n, side, cout, n_keys);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(const T* x, const T* g, const int* aux, const int* skeys,
              const int* srow, const float* row_sel, float* dw, int n,
              int side, int cout, int n_keys, void* stream) {
  const size_t smem =
      sizeof(float) * (side * side * side + kRows) * cout;
  cudaError_t err = allow_smem(scalar_conv_dw_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (n + kRows - 1) / kRows;
  int blocks = 4 * sms;
  if (blocks > n_chunks) blocks = n_chunks;
  scalar_conv_dw_kernel<T><<<blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, g, aux, skeys, srow, row_sel, dw, n, side, cout, n_keys);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dx(const T* g, const float* w, const int* aux, const int* skeys,
              const int* srow, const float* row_sel, T* dx, int n, int side,
              int cout, int n_keys, void* stream) {
  const size_t smem = sizeof(float) * side * side * side * cout;
  const cudaError_t err = allow_smem(scalar_conv_dx_kernel<T>, smem);
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
// skipped and come out zero), out f32[n, cout]; contiguous on the device.
// side odd, 1 <= side <= 5. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int scalar_conv_fwd(const float* x, const float* w, const int* aux,
                               const int* skeys, const int* srow,
                               const float* row_sel, float* out, int n,
                               int side, int cout, int n_keys, void* stream) {
  return launch_fwd(x, w, aux, skeys, srow, row_sel, out, n, side, cout,
                    n_keys, stream);
}

// As above with g f32[n, cout] and dw f32[side^3, 1, cout], zeroed by the
// caller.
extern "C" int scalar_conv_dw(const float* x, const float* g, const int* aux,
                              const int* skeys, const int* srow,
                              const float* row_sel, float* dw, int n,
                              int side, int cout, int n_keys, void* stream) {
  return launch_dw(x, g, aux, skeys, srow, row_sel, dw, n, side, cout,
                   n_keys, stream);
}

// K9: g f32[n, cout], w f32[side^3, 1, cout], dx f32[n, 1] out; the rest
// as scalar_conv_fwd. row_sel is K4's flag of its OUTPUT rows, i.e. of the
// rows of g.
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
                                    int n_keys, void* stream) {
  return launch_fwd(x, w, aux, skeys, srow, row_sel, out, n, side, cout,
                    n_keys, stream);
}

extern "C" int scalar_conv_dw_bf16(const bf16* x, const bf16* g,
                                   const int* aux, const int* skeys,
                                   const int* srow, const float* row_sel,
                                   float* dw, int n, int side, int cout,
                                   int n_keys, void* stream) {
  return launch_dw(x, g, aux, skeys, srow, row_sel, dw, n, side, cout,
                   n_keys, stream);
}

extern "C" int scalar_conv_dx_bf16(const bf16* g, const float* w,
                                   const int* aux, const int* skeys,
                                   const int* srow, const float* row_sel,
                                   bf16* dx, int n, int side, int cout,
                                   int n_keys, void* stream) {
  return launch_dx(g, w, aux, skeys, srow, row_sel, dx, n, side, cout,
                   n_keys, stream);
}

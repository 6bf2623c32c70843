// Sparse convolution, the standalone weight gradient, over an implicit
// map or an index table, for Hopper (sm_90a).
//
// Replaces gcl_tpu/core/pallas_conv.py:_dw_kernel_h (TPU kernel K8,
// reached through fused_conv_dw -> _conv_half_dw) and, in its table form,
// pallas_conv_dw (K12: _fused_from_idx -> fused_conv_dw -> _dw_kernel).
// With row(k, i) the input row that output row i reads at offset k (the
// row whose key equals qkey[k, i], or idx[k, i]; none when there is no
// match):
//
//   dW[k] += x[row(k, i), :]^T g[i, :]      summed over the output rows i
//
// It is the second half of the two-pass backward (dX is the forward
// kernel through the reverse map with flipped, transposed weights) and
// the only dW of a conv whose table has no reverse twin.
//
// What bounds it on this card: the products, float32 FMAs on the CUDA
// cores over the matched (offset, row) pairs, far above what the gathered
// x rows, g, keys and dW cost in bytes.
//
// What the design does about it, as the one-pass backward does for its
// dW: on the TPU the grid runs in order and the dW block carries its sum
// from tile to tile; here blocks run in parallel and nothing carries over.
// A block owns a 64-channel slice of Cin (blockIdx.y) and walks MANY
// 64-row tiles of the output level (grid-stride over blockIdx.x). The
// offset k is its outer loop: across all of its tiles it keeps the partial
// dW[k, 64 ci, 128 co] in registers (4 x 4 per thread and 64-channel Cout
// chunk, NCO <= 2 chunks; a wider Cout takes one more walk per 128
// channels) and adds it to global memory with atomicAdd ONCE per offset.
// With atomics the order of the sum over blocks changes from run to run,
// so dW agrees with the plain version to float32 rounding, not bit for
// bit. Per (offset, tile) the block resolves row(k, i) for its 64 rows
// (64 threads: a binary search, or a read of the table), skips the pair
// when no row matched, stages the matched x rows (zeros elsewhere) once
// and the tile's g rows per Cout chunk. Cin = 1 (conv1 on the explicit
// route, K = 125) runs the same code on a slice that is one channel wide:
// right, and wasteful. Tensor cores and TMA are left to later work.

#include <cuda_runtime.h>

#include "key_search.cuh"

namespace {

constexpr int kTileM = 64;     // output rows per tile
constexpr int kTileCI = 64;    // input channels per block
constexpr int kTileCO = 64;    // output channels per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads

// kTable false: qkey holds packed query keys, resolved against skeys /
// srow (n_keys of them). kTable true: qkey holds input rows, valid in
// [0, n_keys) where n_keys is the input level's row count.
template <int NCO, bool kTable>
__global__ void __launch_bounds__(kThreads)
sparse_conv_dw_kernel(const float* __restrict__ x,
                      const float* __restrict__ g,
                      const int* __restrict__ qkey,
                      const int* __restrict__ skeys,
                      const int* __restrict__ srow, float* __restrict__ dw,
                      int cin, int cout, int kvol, int n_out, int n_keys) {
  __shared__ __align__(16) float xs[kTileM * kTileCI];  // x[row(k, i), ci]
  __shared__ __align__(16) float gs[kTileM * kTileCO];  // g[i, co]
  __shared__ int rows_s[kTileM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int ci0 = blockIdx.y * kTileCI;
  const int n_tiles = (n_out + kTileM - 1) / kTileM;
  // this thread's 4 input channels (by ty, so whole warps drop out when
  // the Cin slice is narrower than 64) x 4 output channels per chunk
  const bool mine = ci0 + ty * 4 < cin;

  const int n_groups = (cout + NCO * kTileCO - 1) / (NCO * kTileCO);
  for (int it = 0; it < kvol * n_groups; ++it) {
    const int k = it / n_groups;
    const int co_base = (it % n_groups) * NCO * kTileCO;
    float acc[NCO][4][4];
#pragma unroll
    for (int c = 0; c < NCO; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][i][j] = 0.f;
      }
    }

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row0 = tile * kTileM;
      int found = 0;
      if (tid < kTileM) {
        const int i = row0 + tid;
        int r = -1;
        if (i < n_out) {
          const int q = qkey[(size_t)k * n_out + i];
          if (kTable) {
            if (q >= 0 && q < n_keys) r = q;
          } else {
            const int p = find_key(skeys, n_keys, q);
            if (p >= 0) r = __ldg(srow + p);
          }
        }
        rows_s[tid] = r;
        found = r >= 0;
      }
      if (!__syncthreads_or(found)) continue;  // offset k misses the tile

      for (int e = tid; e < kTileM * kTileCI; e += kThreads) {
        const int r = e / kTileCI;
        const int c = e % kTileCI;
        const int src = rows_s[r];
        float v = 0.f;
        if (src >= 0 && ci0 + c < cin) {
          v = __ldg(x + (size_t)src * cin + ci0 + c);
        }
        xs[e] = v;
      }
#pragma unroll
      for (int c = 0; c < NCO; ++c) {
        const int co0 = co_base + c * kTileCO;
        if (co0 < cout) {  // uniform over the block
          for (int e = tid; e < kTileM * kTileCO; e += kThreads) {
            const int r = e / kTileCO;
            const int o = e % kTileCO;
            float v = 0.f;
            if (row0 + r < n_out && co0 + o < cout) {
              v = __ldg(g + (size_t)(row0 + r) * cout + co0 + o);
            }
            gs[e] = v;
          }
          __syncthreads();
          if (mine) {
#pragma unroll 8
            for (int r = 0; r < kTileM; ++r) {
              const float4 a =
                  *reinterpret_cast<const float4*>(&xs[r * kTileCI + ty * 4]);
              const float4 b =
                  *reinterpret_cast<const float4*>(&gs[r * kTileCO + tx * 4]);
              const float av[4] = {a.x, a.y, a.z, a.w};
              const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  acc[c][i][j] = fmaf(av[i], bv[j], acc[c][i][j]);
                }
              }
            }
          }
          __syncthreads();
        }
      }
    }

    if (mine) {
      float* dwk = dw + (size_t)k * cin * cout;
#pragma unroll
      for (int c = 0; c < NCO; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ci = ci0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int co = co_base + c * kTileCO + tx * 4 + j;
            const float v = acc[c][i][j];
            if (ci < cin && co < cout && v != 0.f) {
              atomicAdd(dwk + (size_t)ci * cout + co, v);
            }
          }
        }
      }
    }
  }
}

template <int NCO, bool kTable>
int launch(const float* x, const float* g, const int* qkey, const int* skeys,
           const int* srow, float* dw, int cin, int cout, int kvol, int n_out,
           int n_keys, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n_out + kTileM - 1) / kTileM;
  const int n_ci = (cin + kTileCI - 1) / kTileCI;
  // about two resident blocks per SM over the whole grid; each walks its
  // share of the tiles
  int workers = (2 * sms + n_ci - 1) / n_ci;
  if (workers > n_tiles) workers = n_tiles;
  if (workers < 1) workers = 1;
  const dim3 grid(workers, n_ci);
  sparse_conv_dw_kernel<NCO, kTable><<<grid, kThreads, 0, stream>>>(
      x, g, qkey, skeys, srow, dw, cin, cout, kvol, n_out, n_keys);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTable>
int dispatch(const float* x, const float* g, const int* qkey,
             const int* skeys, const int* srow, float* dw, int cin, int cout,
             int kvol, int n_out, int n_keys, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= kTileCO) {
    return launch<1, kTable>(x, g, qkey, skeys, srow, dw, cin, cout, kvol,
                             n_out, n_keys, s);
  }
  return launch<2, kTable>(x, g, qkey, skeys, srow, dw, cin, cout, kvol,
                           n_out, n_keys, s);
}

}  // namespace

// x f32[n_in, cin], g f32[n_out, cout], qkey int32[kvol, n_out], skeys /
// srow int32[n_keys] (sorted valid keys of the INPUT level and their
// rows), dw f32[kvol, cin, cout] zeroed by the caller; all contiguous on
// the device. Launches on `stream`; returns cudaGetLastError().
extern "C" int sparse_conv_implicit_dw(const float* x, const float* g,
                                       const int* qkey, const int* skeys,
                                       const int* srow, float* dw, int cin,
                                       int cout, int kvol, int n_out,
                                       int n_keys, void* stream) {
  return dispatch<false>(x, g, qkey, skeys, srow, dw, cin, cout, kvol, n_out,
                         n_keys, stream);
}

// The index-table form: idx int32[kvol, n_out] holds rows of x (n_in of
// them), anything outside [0, n_in) meaning no input. Otherwise as above.
extern "C" int sparse_conv_table_dw(const float* x, const float* g,
                                    const int* idx, float* dw, int cin,
                                    int cout, int kvol, int n_out, int n_in,
                                    void* stream) {
  return dispatch<true>(x, g, idx, nullptr, nullptr, dw, cin, cout, kvol,
                        n_out, n_in, stream);
}

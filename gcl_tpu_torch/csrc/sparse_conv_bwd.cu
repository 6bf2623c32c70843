// Implicit-map sparse convolution, backward (dX and dW in one pass), for
// Hopper (sm_90a).
//
// Replaces gcl_tpu/core/pallas_conv.py:_bwd_kernel_h (TPU kernel K7,
// reached through fused_conv_bwd -> _conv_half_bwd). With rev(k', j) the
// output row whose key equals rqkey[k', j] (the reverse-direction query of
// input row j; -1 when none) and K the kernel volume:
//
//   dX[j, :]      = sum_k'  g[rev(k', j), :] @ W[K-1-k']^T
//   dW[K-1-k']   += x[j, :]^T g[rev(k', j), :]      summed over j
//
// dW comes out in forward offset order: the flip K-1-k' and the transpose
// of W are index arithmetic here, not copies on the host.
//
// What bounds it on this card: the products. Both are float32 FMAs on the
// CUDA cores (twice the forward's count), far above what the gathered g
// rows, x, keys and weights cost in bytes.
//
// What the design does about it, and about dW. On the TPU the grid runs in
// order and the dW block carries its sum from tile to tile; here blocks
// run in parallel and nothing carries over. So a block owns a 64-channel
// slice of Cin (blockIdx.y) and walks MANY 64-row tiles of the input level
// (grid-stride over blockIdx.x). The offset k' is its outer loop: across
// all of its tiles it keeps the partial dW[K-1-k', 64 ci, 128 co] in
// registers (4 x 4 per thread and 64-channel Cout chunk, NCO <= 2 chunks;
// a wider Cout takes one more walk per 128 channels, since four chunks'
// 173 registers left one block per SM and ran slower) and adds it to
// global memory with atomicAdd ONCE per offset -- blocks x K x 64 x Cout
// atomics per launch instead of one per (tile, offset, element).
// With atomics the order of the sum over blocks changes from run to run,
// so dW agrees with the plain version to float32 rounding, not bit for bit.
//
// Per (offset, tile) the block resolves rev(k', j) for its 64 rows by
// binary search (64 threads), skips the pair when no row matched, stages
// x[tile, ci slice] once, and per Cout chunk stages the matched g rows
// once for BOTH products plus the W[K-1-k'] slice transposed. dX of the
// tile accumulates over the Cout chunks in registers and is then added
// into global memory by plain load-add-store: the block is the only
// writer of (tile rows, ci slice), offsets are sequential inside it, and
// the wrapper zeroes dX and dW. That read-modify-write of dX once per
// matched (offset, tile) is the price of keeping dW in registers; tensor
// cores, TMA and a dX tile held on chip are left to later work.

#include <cuda_runtime.h>

#include "key_search.cuh"

namespace {

constexpr int kTileM = 64;     // input rows per tile
constexpr int kTileCI = 64;    // input channels per block
constexpr int kTileCO = 64;    // output channels per shared-memory stage
constexpr int kWsLd = kTileCI + 4;  // keeps float4 alignment of wsT rows
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr size_t kSmemBytes =
    sizeof(float) * (kTileM * kTileCI + kTileM * kTileCO + kTileCO * kWsLd) +
    sizeof(int) * kTileM;

template <int NCO>
__global__ void __launch_bounds__(kThreads)
sparse_conv_implicit_bwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ g,
                                const float* __restrict__ w,
                                const int* __restrict__ rqkey,
                                const int* __restrict__ skeys,
                                const int* __restrict__ srow,
                                float* __restrict__ dx,
                                float* __restrict__ dw, int cin, int cout,
                                int kvol, int n_in, int n_keys,
                                int want_dx) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // [kTileM][kTileCI]   x[j, ci]
  float* gs = xs + kTileM * kTileCI;       // [kTileM][kTileCO]   g[rev, co]
  float* wsT = gs + kTileM * kTileCO;      // [kTileCO][kWsLd]    W[ci, co]^T
  int* rows_s = reinterpret_cast<int*>(wsT + kTileCO * kWsLd);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int ci0 = blockIdx.y * kTileCI;
  const int n_tiles = (n_in + kTileM - 1) / kTileM;
  // dW: this thread's 4 input channels (by ty, so whole warps drop out
  // when the Cin slice is narrower than 64) x 4 output channels per chunk
  const bool dw_mine = ci0 + ty * 4 < cin;

  // outer loops: the reverse offset, then groups of NCO 64-channel Cout
  // chunks (one group unless Cout > NCO * 64)
  const int n_groups = (cout + NCO * kTileCO - 1) / (NCO * kTileCO);
  for (int it = 0; it < kvol * n_groups; ++it) {
    const int kp = it / n_groups;
    const int co_base = (it % n_groups) * NCO * kTileCO;
    const int kf = kvol - 1 - kp;  // forward offset of reverse offset kp
    const float* wk = w + (size_t)kf * cin * cout;
    float acc_dw[NCO][4][4];
#pragma unroll
    for (int c = 0; c < NCO; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_dw[c][i][j] = 0.f;
      }
    }

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row0 = tile * kTileM;
      int found = 0;
      if (tid < kTileM) {
        const int j = row0 + tid;
        int r = -1;
        if (j < n_in) {
          const int p = find_key(skeys, n_keys, rqkey[(size_t)kp * n_in + j]);
          if (p >= 0) r = __ldg(srow + p);
        }
        rows_s[tid] = r;
        found = r >= 0;
      }
      if (!__syncthreads_or(found)) continue;  // offset kp misses the tile

      for (int e = tid; e < kTileM * kTileCI; e += kThreads) {
        const int r = e / kTileCI;
        const int c = e % kTileCI;
        float v = 0.f;
        if (row0 + r < n_in && ci0 + c < cin) {
          v = __ldg(x + (size_t)(row0 + r) * cin + ci0 + c);
        }
        xs[e] = v;
      }
      // dX: this thread's 4 rows (by ty) x 4 input channels (by tx)
      const bool dx_mine =
          want_dx && ((rows_s[ty * 4] >= 0) | (rows_s[ty * 4 + 1] >= 0) |
                      (rows_s[ty * 4 + 2] >= 0) | (rows_s[ty * 4 + 3] >= 0));
      float acc_dx[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_dx[i][j] = 0.f;
      }

#pragma unroll
      for (int c = 0; c < NCO; ++c) {
        const int co0 = co_base + c * kTileCO;
        if (co0 < cout) {  // uniform over the block
          for (int e = tid; e < kTileM * kTileCO; e += kThreads) {
            const int r = e / kTileCO;
            const int o = e % kTileCO;
            const int src = rows_s[r];
            float v = 0.f;
            if (src >= 0 && co0 + o < cout) {
              v = __ldg(g + (size_t)src * cout + co0 + o);
            }
            gs[e] = v;
          }
          if (want_dx) {
            for (int e = tid; e < kTileCI * kTileCO; e += kThreads) {
              const int i = e / kTileCO;
              const int o = e % kTileCO;
              float v = 0.f;
              if (ci0 + i < cin && co0 + o < cout) {
                v = __ldg(wk + (size_t)(ci0 + i) * cout + co0 + o);
              }
              wsT[o * kWsLd + i] = v;
            }
          }
          __syncthreads();
          if (dx_mine) {
#pragma unroll 8
            for (int o = 0; o < kTileCO; ++o) {
              const float4 b =
                  *reinterpret_cast<const float4*>(&wsT[o * kWsLd + tx * 4]);
              const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float a = gs[(ty * 4 + i) * kTileCO + o];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  acc_dx[i][j] = fmaf(a, bv[j], acc_dx[i][j]);
                }
              }
            }
          }
          if (dw_mine) {
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
                  acc_dw[c][i][j] = fmaf(av[i], bv[j], acc_dw[c][i][j]);
                }
              }
            }
          }
          __syncthreads();
        }
      }

      if (dx_mine) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + ty * 4 + i;
          if (row >= n_in) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ci = ci0 + tx * 4 + j;
            if (ci < cin) dx[(size_t)row * cin + ci] += acc_dx[i][j];
          }
        }
      }
    }

    if (dw_mine) {
      float* dwk = dw + (size_t)kf * cin * cout;
#pragma unroll
      for (int c = 0; c < NCO; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ci = ci0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int co = co_base + c * kTileCO + tx * 4 + j;
            const float v = acc_dw[c][i][j];
            if (ci < cin && co < cout && v != 0.f) {
              atomicAdd(dwk + (size_t)ci * cout + co, v);
            }
          }
        }
      }
    }
  }
}

template <int NCO>
int launch(const float* x, const float* g, const float* w, const int* rqkey,
           const int* skeys, const int* srow, float* dx, float* dw, int cin,
           int cout, int kvol, int n_in, int n_keys, int want_dx,
           cudaStream_t stream) {
  auto kernel = sparse_conv_implicit_bwd_kernel<NCO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n_in + kTileM - 1) / kTileM;
  const int n_ci = (cin + kTileCI - 1) / kTileCI;
  // about two resident blocks per SM over the whole grid; each walks its
  // share of the tiles
  int workers = (2 * sms + n_ci - 1) / n_ci;
  if (workers > n_tiles) workers = n_tiles;
  if (workers < 1) workers = 1;
  const dim3 grid(workers, n_ci);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      x, g, w, rqkey, skeys, srow, dx, dw, cin, cout, kvol, n_in, n_keys,
      want_dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32[n_in, cin], g f32[n_out, cout], w f32[kvol, cin, cout],
// rqkey int32[kvol, n_in], skeys / srow int32[n_keys] (sorted valid keys of
// the OUTPUT level and their rows), dx f32[n_in, cin] (read and written
// only when want_dx), dw f32[kvol, cin, cout]; all contiguous on the
// device, dx and dw zeroed by the caller. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int sparse_conv_implicit_bwd(const float* x, const float* g,
                                        const float* w, const int* rqkey,
                                        const int* skeys, const int* srow,
                                        float* dx, float* dw, int cin,
                                        int cout, int kvol, int n_in,
                                        int n_keys, int want_dx,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= kTileCO) {
    return launch<1>(x, g, w, rqkey, skeys, srow, dx, dw, cin, cout, kvol,
                     n_in, n_keys, want_dx, s);
  }
  return launch<2>(x, g, w, rqkey, skeys, srow, dx, dw, cin, cout, kvol,
                   n_in, n_keys, want_dx, s);
}

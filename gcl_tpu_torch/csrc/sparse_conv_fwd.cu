// Implicit-map sparse convolution, forward, for Hopper (sm_90a).
//
// Replaces gcl_tpu/core/pallas_conv.py:_fwd_kernel_h + _windowed_gather_h
// (TPU kernel K6, reached through fused_conv_fwd -> _conv_half_fwd):
//
//   out[i, :] = sum_k x[srow[p], :] @ W[k]    where skeys[p] == qkey[k, i]
//
// and zero where no key matches. skeys are the packed keys of the input
// level's valid rows, sorted ascending as signed int32; srow their rows.
//
// What bounds it on this card: the products. A ResUNetFatBN pair at the
// serving shapes runs ~1.8e11 multiply-adds through the 20 k=3 convs
// counted densely (every (offset, output row) pair, matched or not),
// against a few hundred MB of gathered rows, keys and weights, so the
// kernel sits above the memory roofline and is limited by FP32 FMA issue
// and shared-memory bandwidth.
//
// What the design does about it, simply: each block owns a 64-row x
// 64-channel output tile held in registers (4 x 4 per thread). For each
// offset k, 64 threads binary-search their rows' query keys in skeys (the
// level's keys, <= 147 KB, stay in L2); a block-wide vote skips offsets
// that match no row of the tile, and a thread skips the FMAs of its four
// rows when none of them matched. Matched x rows (zeros elsewhere) and
// the matching W[k] slice are staged in shared memory 32 input channels at
// a time, so Cin up to 384 never needs a whole 64 x Cin tile. Sums are
// float32 FMAs in (k, channel) order: no TF32, so results agree with the
// plain float32 version to rounding. Tensor cores (mma / wgmma), TMA and
// double buffering are left to later work.

#include <cuda_runtime.h>

#include "key_search.cuh"

namespace {

constexpr int kTileM = 64;    // output rows per block
constexpr int kTileN = 64;    // output channels per block
constexpr int kTileK = 32;    // input channels per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
sparse_conv_implicit_fwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ w,
                                const int* __restrict__ qkey,
                                const int* __restrict__ skeys,
                                const int* __restrict__ srow,
                                float* __restrict__ out, int cin, int cout,
                                int kvol, int n_out, int n_keys) {
  __shared__ int rows_s[kTileM];
  // +4 floats per row keeps float4 alignment and spreads the
  // transposed stores over more banks
  __shared__ __align__(16) float xs[kTileK][kTileM + 4];
  __shared__ __align__(16) float ws[kTileK][kTileN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * kTileM;
  const int col0 = blockIdx.y * kTileN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k = 0; k < kvol; ++k) {
    int found = 0;
    if (tid < kTileM) {
      const int i = row0 + tid;
      int r = -1;
      if (i < n_out) {
        const int q = qkey[(size_t)k * n_out + i];
        const int p = lower_bound(skeys, n_keys, q);
        if (p < n_keys && __ldg(skeys + p) == q) r = __ldg(srow + p);
      }
      rows_s[tid] = r;
      found = r >= 0;
    }
    if (!__syncthreads_or(found)) continue;  // offset k misses the tile

    const bool mine = (rows_s[ty * 4] >= 0) | (rows_s[ty * 4 + 1] >= 0) |
                      (rows_s[ty * 4 + 2] >= 0) | (rows_s[ty * 4 + 3] >= 0);
    const float* wk = w + (size_t)k * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += kTileK) {
      for (int e = tid; e < kTileM * kTileK; e += kThreads) {
        const int r = e / kTileK;
        const int c = e % kTileK;
        const int src = rows_s[r];
        float v = 0.f;
        if (src >= 0 && c0 + c < cin) v = __ldg(x + (size_t)src * cin + c0 + c);
        xs[c][r] = v;
      }
      for (int e = tid; e < kTileK * kTileN; e += kThreads) {
        const int c = e / kTileN;
        const int j = e % kTileN;
        float v = 0.f;
        if (c0 + c < cin && col0 + j < cout) {
          v = __ldg(wk + (size_t)(c0 + c) * cout + col0 + j);
        }
        ws[c][j] = v;
      }
      __syncthreads();
      if (mine) {
#pragma unroll 8
        for (int c = 0; c < kTileK; ++c) {
          const float4 a = *reinterpret_cast<const float4*>(&xs[c][ty * 4]);
          const float4 b = *reinterpret_cast<const float4*>(&ws[c][tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < cout) out[(size_t)row * cout + col] = acc[i][j];
    }
  }
}

}  // namespace

// x f32[n_in, cin], w f32[kvol, cin, cout], qkey int32[kvol, n_out],
// skeys / srow int32[n_keys], out f32[n_out, cout]; all contiguous on the
// device. Launches on `stream`; returns cudaGetLastError().
extern "C" int sparse_conv_implicit_fwd(const float* x, const float* w,
                                        const int* qkey, const int* skeys,
                                        const int* srow, float* out,
                                        int cin, int cout, int kvol,
                                        int n_out, int n_keys,
                                        void* stream) {
  const dim3 grid((n_out + kTileM - 1) / kTileM,
                  (cout + kTileN - 1) / kTileN);
  sparse_conv_implicit_fwd_kernel<<<grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      x, w, qkey, skeys, srow, out, cin, cout, kvol, n_out, n_keys);
  return static_cast<int>(cudaGetLastError());
}

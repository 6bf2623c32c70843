// Occupancy convolution (conv1 of an in_ch == 1 model), weight gradient,
// for Hopper (sm_90a).
//
// Replaces gcl_tpu/core/pallas_conv.py:_dw_c1z_kernel (TPU kernel K3,
// wrapper fused_conv_c1z_dw):
//
//   dW[k, 0, :] = sum_i present_k(i) * g[i, :]      i.e. dW = bits^T g
//
// with bits [N, k^3] read back from the forward's presence bitmasks: bit
// (dy * side + dz) of sbits[i, dx]. No key search and no gather.
//
// What bounds it on this card: bytes. g and sbits are read once (49.5 MB
// at 516,096 rows, Cout = 32, in bf16; 82.6 MB in float32); the product is
// 4.1 GFLOP, microseconds on the tensor cores; dW is 16 KB. The TPU kernel
// runs it as a matrix product on the MXU, g_tile^T @ bits for each (dx,
// dz) block of decoded bits. Run instead as 2e9 masked scalar adds on the
// CUDA cores, two shared-memory reads each, it takes ~44x its bytes' time.
//
// What the design does about it: a matrix product on the tensor cores
// with the bits decoded in registers. A block walks chunks of rows
// (grid-stride, as many blocks as fit on the card and no more, so that
// each sums many chunks before it flushes); each chunk's g rows and
// bitmask words (16-byte cp.async) go into a ring of stages, the next
// ones in flight while one multiplies. A warp owns one m-tile of 16
// offsets (of the 128 that pad k^3 = 125) and the block's whole column
// slice (32 or 64 of Cout); the warps of an m-tile split the rows of a
// stage between them (two in bf16, more at side 3). It builds its A
// fragments of mma.sync.m16n8k16 bf16 straight from the bitmask words:
// the bit of offset m for rows r and r + 1 becomes one register of two
// bf16, 0x3F80 (one) or 0, by a shift, a mask and one multiply; no
// [N, 125] matrix is ever written. B (g, [rows][columns] in shared
// memory) comes in by ldmatrix.trans. A bit times a bf16 value is exact.
// The tensor cores sum a warp's share of a stage, 64 rows, into a zeroed
// fragment; the stages are added in float32 on the CUDA cores (the tensor
// cores' adds drop low bits that a chain over the ~2,000 rows a warp
// sums would pile up, as the split-K dW of csrc/splitk_dw.cuh found). At
// the end the warps of an m-tile add their sums through shared memory and
// the block adds its partial dW to global memory with one atomicAdd an
// element; the order of that sum changes from run to run, so dW agrees
// with the plain version to float32 rounding.
//
// The float32 form (occupancy_conv_dw) multiplies the same way: the bits
// are exact in any type, so only g is split, into three bf16 parts per
// value (hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid); their
// 3 x 8 significant bits hold float32's 24, so hi + mid + lo == v) by one
// pass over each staged chunk, and each stage runs three products (the
// small parts first). The products are exact and every sum is float32, so
// the float32 dW meets the 1e-4 gate as a float32 sum would (split TF32,
// g as two TF32 parts, would take four m16n8k8 products for these three
// m16n8k16 ones and drop ~2^-22 of each value).
// The bf16 form (occupancy_conv_dw_bf16) multiplies g as it comes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"
#include "gather_gemm.cuh"
#include "launch_cache.cuh"

namespace {

constexpr int kMaxSide = 5;       // occupancy_conv.MAX_SIDE
// words a row of a stage's bitmasks: its 8, then 4 of pad, so that the
// A fragments' reads of rows 2 apart hit distinct banks
constexpr int kLdBits = 12;

// the 4 8 x 8 bf16 matrices at the rows p of lanes 8q .. 8q + 7, each
// transposed into register q
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// bit `sh` of two rows' words (lo the lower row), masked by mk (1, or 0
// for an offset past k^3), as two bf16 in one register: 0x3F80 is 1.0
__device__ __forceinline__ uint32_t bit_pair(uint32_t lo, uint32_t hi, int sh,
                                             uint32_t mk) {
  return (((lo >> sh) & mk) | (((hi >> sh) & mk) << 16)) * 0x3F80u;
}

// v = hi + mid + lo, three bf16
__device__ __forceinline__ void split3(float v, bf16& hi, bf16& mid,
                                       bf16& lo) {
  hi = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

__device__ __forceinline__ uint32_t bf16_pair(bf16 a, bf16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

// A block's shape and shared memory. bf16: 16 warps, two to an m-tile
// (each takes every other 16 rows of a 128-row stage, so a fragment still
// sums 64 rows a stage), one block an SM, four stages; float32, whose
// stages also pass through the split into bf16 parts: 8 warps, 64-row
// stages, two blocks an SM, three stages. Shared memory in bytes: the
// ring's g rows (float32 as they come, or bf16 in the operand layout) and
// bitmasks, then, for float32, two sets of the three bf16 parts of a
// stage.
template <typename T, int kN>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kThreads = kF32 ? 256 : 512;
  static constexpr int kRows = kF32 ? 64 : 128;  // rows of a stage
  static constexpr int kBlocksPerSm = kF32 ? 2 : 1;
  static constexpr int kStages = kF32 ? 3 : 4;
  static constexpr int kNc = 8 * kN;     // columns of the block's slice
  static constexpr int kLd = kNc + 8;    // bf16 operand row: 16 B of pad
  static constexpr int kGld = kF32 ? kNc : kLd;  // a staged g row
  static constexpr size_t kG = sizeof(T) * kRows * kGld;
  static constexpr size_t kBits = sizeof(uint32_t) * kRows * kLdBits;
  static constexpr size_t kPart = sizeof(bf16) * kRows * kLd;
  static constexpr size_t kBytes =
      kStages * (kG + kBits) + (kF32 ? 2 * 3 * kPart : 0);
};

// T: the element type of g (float or bf16); dw is float32. kN: the n-tiles
// of 8 columns of a block's column slice (blockIdx.y), 4 or 8.
template <typename T, int kN>
__global__ void __launch_bounds__(Layout<T, kN>::kThreads,
                                  Layout<T, kN>::kBlocksPerSm)
occupancy_conv_dw_kernel(const int* __restrict__ sbits,
                         const T* __restrict__ g, float* __restrict__ dw,
                         int n, int side, int cout, int vec,
                         int vec_bits) {
  using L = Layout<T, kN>;
  constexpr int kS = L::kStages, kThreads = L::kThreads, kRows = L::kRows;
  constexpr int kV = gg::kVec<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* parts = smem + kS * (L::kG + L::kBits);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kvol = side * side * side, s2 = side * side;
  const int n_mt = (kvol + 15) / 16;  // 8, 2 or 1: divides the warps
  const int wk = (kThreads / 32) / n_mt;
  const int mt = warp % n_mt, wi_k = warp / n_mt;
  // this thread's two offsets of the A fragment, m0 and m0 + 8: column dx
  // and bit of each; mask 0 past k^3
  const int m0 = mt * 16 + gid, m1 = m0 + 8;
  const uint32_t mk0 = m0 < kvol ? 1u : 0u, mk1 = m1 < kvol ? 1u : 0u;
  const int dx0 = mk0 ? m0 / s2 : 0, sh0 = mk0 ? m0 % s2 : 0;
  const int dx1 = mk1 ? m1 / s2 : 0, sh1 = mk1 ? m1 % s2 : 0;
  const int c0 = blockIdx.y * L::kNc;
  const int ncol = min(L::kNc, cout - c0);

  auto stage_g = [&](int b) {
    return reinterpret_cast<T*>(smem + b * (L::kG + L::kBits));
  };
  auto stage_bits = [&](int b) {
    return reinterpret_cast<uint32_t*>(smem + b * (L::kG + L::kBits) +
                                       L::kG);
  };

  // chunk ch of 64 rows into stage b: g's column slice and the rows'
  // bitmask words (zeros past n and past Cout)
  auto load = [&](int ch, int b) {
    const int row0 = ch * kRows;
    T* gs = stage_g(b);
    uint32_t* bs = stage_bits(b);
    constexpr int kPerRow = L::kNc / kV;
    for (int e = tid; e < kRows * kPerRow; e += kThreads) {
      const int r = e / kPerRow, c = (e % kPerRow) * kV;
      T* dst = gs + r * L::kGld + c;
      if (row0 + r < n && c < ncol) {
        gg::copy_vec(dst, g + (size_t)(row0 + r) * cout + c0 + c, ncol - c,
                     vec);
      } else {
        gg::zero16(dst);
      }
    }
    for (int e = tid; e < 2 * kRows; e += kThreads) {
      const int r = e >> 1, h = (e & 1) * 4;
      uint32_t* dst = bs + r * kLdBits + h;
      const int* src = sbits + (size_t)(row0 + r) * 8 + h;
      if (row0 + r >= n) {
        gg::zero16(dst);
      } else if (vec_bits) {
        gg::cp_async16(dst, src);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          gg::cp_async4(reinterpret_cast<float*>(dst + q),
                        reinterpret_cast<const float*>(src + q));
        }
      }
    }
  };

  // float32: stage b's g rows into bf16 parts set p, in the order the
  // products take them (lo, mid, hi: the small ones first)
  auto split = [&](int b, int p) {
    const float* gs = reinterpret_cast<const float*>(stage_g(b));
    bf16* lo = reinterpret_cast<bf16*>(parts + 3 * p * L::kPart);
    bf16* mid = lo + kRows * L::kLd;
    bf16* hi = mid + kRows * L::kLd;
    constexpr int kPairs = L::kNc / 2;
    for (int e = tid; e < kRows * kPairs; e += kThreads) {
      const int r = e / kPairs, c = (e % kPairs) * 2;
      const float2 v = *reinterpret_cast<const float2*>(gs + r * L::kNc + c);
      bf16 h0, m0v, l0, h1, m1v, l1;
      split3(v.x, h0, m0v, l0);
      split3(v.y, h1, m1v, l1);
      const int at = r * L::kLd + c;
      *reinterpret_cast<uint32_t*>(hi + at) = bf16_pair(h0, h1);
      *reinterpret_cast<uint32_t*>(mid + at) = bf16_pair(m0v, m1v);
      *reinterpret_cast<uint32_t*>(lo + at) = bf16_pair(l0, l1);
    }
  };

  float acc[kN][4], part[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  // one stage: the tensor cores sum its 64 rows into part (n_ops operand
  // planes of g, the small ones first), then part is added into acc
  auto compute = [&](const uint32_t* bs, const bf16* op, int n_ops) {
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
    for (int ks = wi_k; ks < kRows / 16; ks += wk) {
      const int kr = ks * 16 + 2 * tig;
      uint32_t a[4];
      const uint32_t* w = bs + kr * kLdBits;  // rows kr, kr + 1, kr + 8, kr + 9
      a[0] = bit_pair(w[dx0], w[kLdBits + dx0], sh0, mk0);
      a[1] = bit_pair(w[dx1], w[kLdBits + dx1], sh1, mk1);
      a[2] = bit_pair(w[8 * kLdBits + dx0], w[9 * kLdBits + dx0], sh0, mk0);
      a[3] = bit_pair(w[8 * kLdBits + dx1], w[9 * kLdBits + dx1], sh1, mk1);
      // lane l addresses row (l & 7) of matrix l >> 3: k half (l >> 3) & 1,
      // n-tile j + (l >> 4)
      const int lrow = ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int lcol = (lane >> 4) * 8;
      for (int o = 0; o < n_ops; ++o) {
        const bf16* src = op + o * (kRows * L::kLd) + lrow * L::kLd + lcol;
#pragma unroll
        for (int j = 0; j < kN; j += 2) {
          uint32_t b4[4];
          ldsm_x4_trans(b4, src + j * 8);
          gg::mma_bf16(part[j], a, b4);
          gg::mma_bf16(part[j + 1], a, b4 + 2);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
  };

  // this block's chunks: blockIdx.x, + gridDim.x, ...
  const int n_chunks = (n + kRows - 1) / kRows;
  const int mine = blockIdx.x < n_chunks
                       ? (n_chunks - 1 - blockIdx.x) / gridDim.x + 1
                       : 0;
  for (int s = 0; s < kS - 1; ++s) {
    if (s < mine) load(blockIdx.x + s * gridDim.x, s);
    gg::cp_async_commit();
  }
  for (int it = 0; it < mine; ++it) {
    gg::cp_async_wait<kS - 2>();
    __syncthreads();  // stage it is in; stage it - 1 is read by no one
    const int nxt = it + kS - 1;
    if (nxt < mine) load(blockIdx.x + nxt * gridDim.x, nxt % kS);
    gg::cp_async_commit();
    const int b = it % kS;
    if constexpr (L::kF32) {
      split(b, it & 1);
      __syncthreads();
      compute(stage_bits(b),
              reinterpret_cast<const bf16*>(parts + 3 * (it & 1) * L::kPart),
              3);
    } else {
      compute(stage_bits(b), reinterpret_cast<const bf16*>(stage_g(b)), 1);
    }
  }
  gg::cp_async_wait<0>();
  __syncthreads();  // the stages are free

  // flush: the warps' sums through shared memory ([warp][16][columns]),
  // added over the warps of an m-tile, one atomicAdd an element
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      red[(warp * 16 + gid + (q >> 1) * 8) * L::kNc + j * 8 + 2 * tig +
          (q & 1)] = acc[j][q];
    }
  __syncthreads();
  for (int e = tid; e < n_mt * 16 * L::kNc; e += kThreads) {
    const int m = e / L::kNc, c = e % L::kNc;
    float v = 0.f;
    for (int i = 0; i < wk; ++i) {  // warp (m / 16) + i * n_mt
      v += red[(((m >> 4) + i * n_mt) * 16 + (m & 15)) * L::kNc + c];
    }
    if (m < kvol && c < ncol && v != 0.f) {
      atomicAdd(dw + (size_t)m * cout + c0 + c, v);
    }
  }
}

template <typename T, int kN>
int launch_kn(const int* sbits, const T* g, float* dw, int n, int side,
              int cout, void* stream) {
  static lc::LaunchCache cache;
  using L = Layout<T, kN>;
  int dev = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cache.allow(occupancy_conv_dw_kernel<T, kN>, dev, L::kBytes);
  }
  if (err == cudaSuccess) {
    err = cache.resident_blocks(occupancy_conv_dw_kernel<T, kN>, dev,
                                L::kThreads, L::kBytes, &blocks);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > L::kBlocksPerSm * sms) blocks = L::kBlocksPerSm * sms;
  const int n_chunks = (n + L::kRows - 1) / L::kRows;
  if (blocks > n_chunks) blocks = n_chunks;
  const int vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                  (cout * sizeof(T)) % 16 == 0;
  const int vec_bits = reinterpret_cast<uintptr_t>(sbits) % 16 == 0;
  const dim3 grid(blocks, (cout + L::kNc - 1) / L::kNc);
  occupancy_conv_dw_kernel<T, kN><<<grid, L::kThreads, L::kBytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      sbits, g, dw, n, side, cout, vec, vec_bits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const int* sbits, const T* g, float* dw, int n, int side, int cout,
           void* stream) {
  if (side < 1 || side > kMaxSide || side % 2 == 0 || cout < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return cout <= 32 ? launch_kn<T, 4>(sbits, g, dw, n, side, cout, stream)
                    : launch_kn<T, 8>(sbits, g, dw, n, side, cout, stream);
}

}  // namespace

// sbits int32[n, 8], g f32[n, cout], dw f32[side^3, 1, cout]; contiguous
// on the device, dw zeroed by the caller. side odd, 1 <= side <= 5; n and
// cout >= 1. Launches on `stream`; returns cudaGetLastError().
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

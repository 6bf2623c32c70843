// RANSAC's inlier counts: every hypothesis of a correspondence RANSAC
// scored in one launch, for Hopper (sm_90a).
//
//   fitness[h] = ok[h] ? #{n : valid[n] and |R_h src[n] + t_h - tgt[n]|
//                                             < thr} : 0
//
// for the fits trans[h] ([H, 4, 4], R_h | t_h in the first three rows) of
// reg/ransac.py:score_hypotheses. It replaces no TPU kernel: gcl_tpu scores
// in XLA (gcl_tpu/reg/ransac.py, a lax.map over batches of 1024). The plain
// version, kernels/ransac_score.py:ransac_score_plain, scores as that map
// does, 1024 hypotheses at a time, each batch an [1024, N, 3] tensor in
// device memory.
//
// What bounds it on this card: instruction issue on the CUDA cores. A
// (hypothesis, point) pair is a 3 x 3 rotation, a translation, a squared
// distance and a compare, all in float32 (no tensor core: the product
// is too small and must round as float32 does); the inputs are a few KB of
// points and 48 bytes a hypothesis.
//
// What the design does about it: one thread keeps kPerThread hypotheses'
// R | t in registers; a block of kThreads threads walks the points in
// chunks staged in shared memory, every thread on the same point at once,
// so that each shared-memory read is a broadcast. Nothing but the counts
// goes back to device memory.
//
// The count must equal the plain version's bit for bit: one distance that
// rounds to the other side of thr can change which hypothesis wins. So
// each distance rounds as the plain version's kernels round it, op for op,
// written with intrinsics (nvcc contracts a separate multiply and add into
// an fma by default):
// - R src: cuBLAS's float32 product, an fma chain over k from a rounded
//   first product: fma(s2, R[c][2], fma(s1, R[c][1], s0 * R[c][0]));
// - then + t_c and - tgt_c, each rounded;
// - the squares, summed as torch's reduction over the last axis of size 3
//   sums them (two threads an output: (d0^2 + d2^2) + d1^2);
// - the plain version then compares the correctly rounded square root
//   with thr as float32. That root is monotone, so the kernel compares
//   the sum itself with thr2, the least float32 whose root reaches thr
//   (kernels/ransac_score.py:squared_threshold): sqrt(s) < thr exactly
//   when s < thr2, and no root is taken.
// A NaN or inf from a degenerate fit compares false, as it does in torch.
// An invalid row stages its target x as NaN: its distance is NaN and never
// counts.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // threads a block
constexpr int kPerThread = 2;   // hypotheses a thread
constexpr int kChunk = 1024;    // points staged at a time
constexpr int kPerBlock = kThreads * kPerThread;

// R | t of hypothesis h: the first three rows of trans[h], 16-byte aligned
__device__ __forceinline__ void load_fit(const float* __restrict__ trans,
                                         int h, float (&f)[12]) {
  const float4* row = reinterpret_cast<const float4*>(trans + 16LL * h);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float4 v = row[r];
    f[4 * r] = v.x;
    f[4 * r + 1] = v.y;
    f[4 * r + 2] = v.z;
    f[4 * r + 3] = v.w;
  }
}

// a = (src x, y, z, tgt x), b = (tgt y, z): whether the point is an inlier
// of the fit f, rounded as the plain version rounds (see the top)
__device__ __forceinline__ int inlier(const float (&f)[12], float4 a,
                                      float2 b, float thr2) {
  const float m0 = fmaf(a.z, f[2], fmaf(a.y, f[1], __fmul_rn(a.x, f[0])));
  const float m1 = fmaf(a.z, f[6], fmaf(a.y, f[5], __fmul_rn(a.x, f[4])));
  const float m2 = fmaf(a.z, f[10], fmaf(a.y, f[9], __fmul_rn(a.x, f[8])));
  const float d0 = __fsub_rn(__fadd_rn(m0, f[3]), a.w);
  const float d1 = __fsub_rn(__fadd_rn(m1, f[7]), b.x);
  const float d2 = __fsub_rn(__fadd_rn(m2, f[11]), b.y);
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d2, d2)),
                            __fmul_rn(d1, d1));
  return s < thr2 ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
ransac_score_kernel(const float* __restrict__ src,
                    const float* __restrict__ tgt,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ trans,
                    const unsigned char* __restrict__ ok,
                    long long* __restrict__ fitness, int n, int h,
                    float thr2) {
  __shared__ float4 s_a[kChunk];
  __shared__ float2 s_b[kChunk];
  const float nan = __int_as_float(0x7fc00000);

  int hyp[kPerThread];
  float f[kPerThread][12];
  int count[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    hyp[j] = blockIdx.x * kPerBlock + j * kThreads + threadIdx.x;
    // a thread past the last hypothesis counts for hypothesis 0 and
    // writes nothing
    load_fit(trans, hyp[j] < h ? hyp[j] : 0, f[j]);
    count[j] = 0;
  }

  for (int from = 0; from < n; from += kChunk) {
    const int len = min(kChunk, n - from);
    __syncthreads();  // the chunk before is read
    for (int e = threadIdx.x; e < len; e += kThreads) {
      const long long i = 3LL * (from + e);
      s_a[e] = make_float4(src[i], src[i + 1], src[i + 2],
                           valid[from + e] ? tgt[i] : nan);
      s_b[e] = make_float2(tgt[i + 1], tgt[i + 2]);
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < len; ++p) {
      const float4 a = s_a[p];
      const float2 b = s_b[p];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) count[j] += inlier(f[j], a, b, thr2);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    if (hyp[j] < h) fitness[hyp[j]] = ok[hyp[j]] ? count[j] : 0;
}

}  // namespace

// src / tgt float32[n, 3], valid bool[n], trans float32[h, 4, 4], ok
// bool[h], fitness int64[h]: all contiguous on the device, trans 16-byte
// aligned; thr2 the squared threshold (see the top). Launches on
// `stream`; returns cudaGetLastError().
extern "C" int ransac_score(const float* src, const float* tgt,
                            const unsigned char* valid, const float* trans,
                            const unsigned char* ok, long long* fitness,
                            int n, int h, float thr2, void* stream) {
  if (h <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (h + kPerBlock - 1) / kPerBlock;
  ransac_score_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      src, tgt, valid, trans, ok, fitness, n, h, thr2);
  return static_cast<int>(cudaGetLastError());
}

// Implicit-map sparse convolution, backward (dX and dW), for Hopper
// (sm_90a).
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
// What bounds it on this card: the products, twice the forward's, in
// float32 (67 TFLOP/s on the CUDA cores), far above what the gathered g
// rows, x, keys and weights cost in bytes.
//
// The TPU kernel is one pass because its grid runs in order and the dW
// block carries its sum from tile to tile. Here blocks run in parallel and
// nothing carries over, and a one-pass kernel measured no faster than two
// passes (533.8 ms against 523.1 for the 20 convs of a 4 x 7
// train step on an H100), so this entry point makes two launches on the
// same stream:
//
// * dX: the gather-GEMM core of gather_gemm.cuh over rqkey, resolved
//   against the output level's keys, with B = W[K-1-k']^T read in place:
//   matched rows compacted per (64-row tile, offset), the full Cin per
//   block, split TF32 on mma.sync, dX held in shared memory until one
//   store (no read-modify-write of dX in global memory).
// * dW: split-K over the rows. A block owns (reverse offset k', a Cin x
//   Cout tile of up to 64 x 128 or 128 x 64, a chunk of input rows; the
//   blocks of one chunk are launched together, so the x and g rows that
//   each tile gathers again come from L2). It
//   resolves rev(k', j) for 2048 rows at a time (eight searches a thread
//   in lockstep, so that their dependent loads overlap), compacts the
//   matched ones with __ballot_sync into a ring of (j, rev) pairs, and
//   whenever 32 are ready gathers x[j] and g[rev] (cp.async,
//   double-buffered: the next 32 are in flight while these multiply) and
//   accumulates x_c^T g_c in registers with split-TF32 mma.sync: the
//   tensor cores sum one stage (their float32 adds drop low bits, which a
//   chain over thousands of rows piles up past 1e-4), ordinary float32
//   adds sum the stages. The compacted rows make the executed work the
//   matched work to within the last stage of a chunk (rounded to 8 rows).
//   It flushes once per block with atomicAdd: a second reduction launch
//   would need K x Cin x Cout x chunks of scratch and a pass over it,
//   while the chunks are sized so that a (k', tile) has a handful of them
//   (about four blocks per SM in all), far below one flush per (64-row
//   tile, offset). With atomics the order of the sum over chunks changes
//   from run to run, so dW agrees with the plain version to float32
//   rounding, not bit for bit.

#include <cuda_runtime.h>

#include "gather_gemm.cuh"

namespace {

using gg::kThreads;

constexpr int kStageRows = 32;  // compacted rows per dW stage
constexpr int kPer = 8;         // rows a thread resolves per round
constexpr int kResolve = kPer * kThreads;  // rows resolved per round
// capacity of the (j, rev) ring: it holds < kStageRows + kResolve pairs
constexpr int kRing = 4096;

// TM (Cin) x TN (Cout) tile per block, warps wm x wn x wk over (32 x 32
// warp tiles, depth): wm * wn * wk == 8
__global__ void __launch_bounds__(kThreads, 2)
sparse_conv_dw_splitk_kernel(const float* __restrict__ x,
                             const float* __restrict__ g,
                             const int* __restrict__ rqkey,
                             const int* __restrict__ skeys,
                             const int* __restrict__ srow,
                             float* __restrict__ dw, int cin, int cout,
                             int kvol, int n_in, int n_keys, int tm, int tn,
                             int chunk_rows, int vec_x, int vec_g) {
  extern __shared__ __align__(16) float smem[];
  const int ldx = tm + 8;  // 8 mod 32: conflict-free fragment reads
  const int ldg = tn + 8;
  const int sfl = kStageRows * (ldx + ldg);
  float* stage0 = smem;                        // 2 x {xs [64][ldx], gs [64][ldg]}
  int* ring_j = reinterpret_cast<int*>(stage0 + 2 * sfl);
  int* ring_r = ring_j + kRing;
  int* wcnt = ring_r + kRing;                  // [8]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  // blockIdx: x the Cin x Cout tile, y the reverse offset, z the chunk, so
  // that the blocks in flight together share one chunk's rows and re-read
  // them from L2
  const int kp = blockIdx.y;
  const int kf = kvol - 1 - kp;
  const int n_co = (cout + tn - 1) / tn;
  const int ci0 = (blockIdx.x / n_co) * tm;
  const int co0 = (blockIdx.x % n_co) * tn;
  const int j_begin = blockIdx.z * chunk_rows;
  const int j_end = min(n_in, j_begin + chunk_rows);

  const int wn = tn / 32;
  const int wm = tm / 32;
  const int wk = 8 / (wm * wn);
  const int wi_n = warp % wn;
  const int wi_m = (warp / wn) % wm;
  const int wi_k = warp / (wn * wm);

  // the tensor cores add a stage's products into `part` (a short chain:
  // their float32 adds drop low bits that a chain over thousands of rows
  // would pile up); `acc` sums the stages with ordinary float32 adds
  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // the ring: entries [head, tail) are resolved and not yet staged; both
  // counters are the same in every thread
  int head = 0, tail = 0;
  int next = j_begin;
  const int* rq = rqkey + (size_t)kp * n_in;

  // resolve rounds until a stage's pairs are ready or the chunk is done; a
  // thread's kPer searches run in lockstep, and the rows j of a round go
  // into the ring in order
  auto fill = [&]() {
    while (tail - head < kStageRows && next < j_end) {
      int q[kPer], pos[kPer], r[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = next + i * kThreads + tid;
        q[i] = j < j_end ? rq[j] : 0;
      }
      gg::find_keys<kPer>(skeys, n_keys, q, pos);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = next + i * kThreads + tid;
        r[i] = (j < j_end && pos[i] >= 0) ? __ldg(srow + pos[i]) : -1;
      }
      for (int i = 0; i < kPer; ++i) {
        const unsigned hits = __ballot_sync(0xffffffffu, r[i] >= 0);
        if (lane == 0) wcnt[warp] = __popc(hits);
        __syncthreads();
        int before = 0, total = 0;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) {
          const int c = wcnt[w];
          before += w < warp ? c : 0;
          total += c;
        }
        if (r[i] >= 0) {
          const int at = (tail + before + __popc(hits & ((1u << lane) - 1u))) &
                         (kRing - 1);
          ring_j[at] = next + i * kThreads + tid;
          ring_r[at] = r[i];
        }
        __syncthreads();
        tail += total;
      }
      next += kResolve;
    }
  };

  // stage the next min(kStageRows, ready) pairs into buffer `buf`; returns
  // the number of rows staged
  auto load_stage = [&](int buf) {
    const int n = min(kStageRows, tail - head);
    const int n8 = gg::round_up(n, 8);
    float* xs = stage0 + buf * sfl;
    float* gs = xs + kStageRows * ldx;
    const int xv = tm / 4, gv = tn / 4;
    for (int e = tid; e < n8 * (xv + gv); e += kThreads) {
      const int r = e / (xv + gv);
      const int c = (e % (xv + gv)) * 4;
      const bool is_x = c < tm;
      float* dst = is_x ? xs + r * ldx + c : gs + r * ldg + (c - tm);
      const int col = is_x ? ci0 + c : co0 + (c - tm);
      const int width = is_x ? cin : cout;
      if (r < n && col < width) {
        const int at = (head + r) & (kRing - 1);
        const float* src = is_x ? x + (size_t)ring_j[at] * cin + col
                                : g + (size_t)ring_r[at] * cout + col;
        gg::copy4(dst, src, width - col, is_x ? vec_x : vec_g);
      } else {
        gg::zero4(dst);
      }
    }
    head += n;
    return n;
  };

  auto compute = [&](int buf, int n) {
    const float* xs = stage0 + buf * sfl;
    const float* gs = xs + kStageRows * ldx;
    const int ksteps = (n + 7) / 8;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
    for (int ks = wi_k; ks < ksteps; ks += wk) {
      const int kr = ks * 8 + tig;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = wi_n * 32 + j * 8 + gid;
        gg::split_tf32(gs[kr * ldg + nn], bh[j][0], bl[j][0]);
        gg::split_tf32(gs[(kr + 4) * ldg + nn], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // A = x_c^T: A[m = ci][k = row] = xs[row][ci]
        const float* xr = xs + kr * ldx + wi_m * 32 + i * 16 + gid;
        uint32_t ah[4], al[4];
        gg::split_tf32(xr[0], ah[0], al[0]);
        gg::split_tf32(xr[8], ah[1], al[1]);
        gg::split_tf32(xr[4 * ldx], ah[2], al[2]);
        gg::split_tf32(xr[4 * ldx + 8], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          gg::mma_3xtf32(part[i][j], ah, al, bh[j], bl[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  };

  fill();
  if (tail == head) return;  // no match in this chunk: nothing to add
  int buf = 0;
  int n_cur = load_stage(0);
  gg::cp_async_commit();
  for (;;) {
    fill();
    const bool more = tail > head;
    const int n_next = more ? load_stage(buf ^ 1) : 0;
    gg::cp_async_commit();
    gg::cp_async_wait<1>();
    __syncthreads();
    compute(buf, n_cur);
    __syncthreads();
    if (!more) break;
    buf ^= 1;
    n_cur = n_next;
  }
  gg::cp_async_wait<0>();
  __syncthreads();

  // flush: the warps' partial tiles through shared memory (the stages are
  // free now), summed over the depth split, one atomicAdd per element
  float* red = smem;  // [8 warps][32][32], over the stages and the ring
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ml = i * 16 + gid + (q >> 1) * 8;
        const int nl = j * 8 + 2 * tig + (q & 1);
        red[warp * 1024 + ml * 32 + nl] = acc[i][j][q];
      }
  __syncthreads();
  float* dwk = dw + (size_t)kf * cin * cout;
  for (int e = tid; e < tm * tn; e += kThreads) {
    const int ci = e / tn;
    const int co = e % tn;
    if (ci0 + ci >= cin || co0 + co >= cout) continue;
    const int w0 = (ci / 32) * wn + co / 32;
    float v = 0.f;
    for (int s = 0; s < wk; ++s) {
      v += red[(s * wm * wn + w0) * 1024 + (ci % 32) * 32 + co % 32];
    }
    if (v != 0.f) atomicAdd(dwk + (size_t)(ci0 + ci) * cout + co0 + co, v);
  }
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

int launch_dw(const float* x, const float* g, const int* rqkey,
              const int* skeys, const int* srow, float* dw, int cin,
              int cout, int kvol, int n_in, int n_keys,
              cudaStream_t stream) {
  const int tn = cout <= 32 ? 32 : cout <= 64 ? 64 : 128;
  const int wn = tn / 32;
  int wm = next_pow2((cin + 31) / 32);
  if (wm > 8 / wn) wm = 8 / wn;
  if (wm > 4) wm = 4;
  const int tm = 32 * wm;
  const int n_tiles = ((cin + tm - 1) / tm) * ((cout + tn - 1) / tn);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about four blocks per SM over the whole grid, a chunk at least one
  // resolve round long
  const int per_chunk = kvol * n_tiles;
  int n_chunks = (4 * sms + per_chunk - 1) / per_chunk;
  const int max_chunks = (n_in + kResolve - 1) / kResolve;
  if (n_chunks > max_chunks) n_chunks = max_chunks;
  if (n_chunks < 1) n_chunks = 1;
  const int chunk_rows =
      gg::round_up((n_in + n_chunks - 1) / n_chunks, kResolve);
  n_chunks = (n_in + chunk_rows - 1) / chunk_rows;
  const size_t smem = sizeof(float) * 2 * kStageRows * (tm + 8 + tn + 8) +
                      sizeof(int) * (2 * kRing + 8);
  err = cudaFuncSetAttribute(sparse_conv_dw_splitk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_x = gg::aligned16(x) && cin % 4 == 0;
  const int vec_g = gg::aligned16(g) && cout % 4 == 0;
  const dim3 grid(n_tiles, kvol, n_chunks);
  sparse_conv_dw_splitk_kernel<<<grid, kThreads, smem, stream>>>(
      x, g, rqkey, skeys, srow, dw, cin, cout, kvol, n_in, n_keys, tm, tn,
      chunk_rows, vec_x, vec_g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32[n_in, cin], g f32[n_out, cout], w f32[kvol, cin, cout],
// rqkey int32[kvol, n_in], skeys / srow int32[n_keys] (sorted valid keys of
// the OUTPUT level and their rows), dx f32[n_in, cin] (written only when
// want_dx; every element is written), dw f32[kvol, cin, cout] zeroed by
// the caller; all contiguous on the device. Launches dX (when want_dx) and
// then dW on `stream`; returns the first cudaError_t that is not success.
extern "C" int sparse_conv_implicit_bwd(const float* x, const float* g,
                                        const float* w, const int* rqkey,
                                        const int* skeys, const int* srow,
                                        float* dx, float* dw, int cin,
                                        int cout, int kvol, int n_in,
                                        int n_keys, int want_dx,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_dx) {
    const int err = gg::launch<false, true>(g, w, rqkey, skeys, srow, dx,
                                            cout, cin, kvol, n_in, n_keys, s);
    if (err != 0) return err;
  }
  return launch_dw(x, g, rqkey, skeys, srow, dw, cin, cout, kvol, n_in,
                   n_keys, s);
}

// Counts the rows that this source's dX launches multiply into *counter
// (unsigned long long on the device) from now on; nullptr stops counting.
// For checks only. Returns a cudaError_t as int.
extern "C" int sparse_conv_bwd_count_rows(void* counter) {
  return gg::set_row_counter(static_cast<unsigned long long*>(counter));
}

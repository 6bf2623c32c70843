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
// What bounds it on this card: the products, twice the forward's, as
// split TF32 on the tensor cores (three TF32 products per float32 one),
// far above what the gathered g rows, x, keys and weights cost in bytes.
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
// * dW: the split-K core of splitk_dw.cuh with the reverse resolver: a
//   block owns (reverse offset k', a Cin x Cout tile, a chunk of input
//   rows j), compacts the matched (j, rev(k', j)) pairs, multiplies 32 of
//   them at a time in split TF32 on mma.sync and flushes into dW[K-1-k']
//   once with atomicAdd. K8 (sparse_conv_dw.cu) runs the same core over
//   the forward map and the index table. With atomics the order of the
//   sum over chunks changes from run to run, so dW agrees with the plain
//   version to float32 rounding, not bit for bit.

#include <cuda_runtime.h>

#include "gather_gemm.cuh"
#include "splitk_dw.cuh"

namespace {

template <typename T>
int implicit_bwd(const T* x, const T* g, const T* w, const int* rqkey,
                 const int* skeys, const int* srow, T* dx, float* dw, int cin,
                 int cout, int kvol, int n_in, int n_keys, int want_dx,
                 cudaStream_t s) {
  if (want_dx) {
    const int err = gg::launch<T, false, true>(g, w, rqkey, skeys, srow, dx,
                                               cout, cin, kvol, n_in, n_keys,
                                               s);
    if (err != 0) return err;
  }
  return sk::launch_dw<T, sk::kReverse>(x, g, rqkey, skeys, srow, dw, cin,
                                        cout, kvol, n_in, n_keys, s);
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
  return implicit_bwd(x, g, w, rqkey, skeys, srow, dx, dw, cin, cout, kvol,
                      n_in, n_keys, want_dx,
                      static_cast<cudaStream_t>(stream));
}

// The bf16 form: x, g, w (rounded to bf16 by the caller) and dx bf16, dw
// float32; dX is summed in float32 and rounded once, dW's stages are
// m16n8k16 bf16 products summed in float32. Otherwise as above.
extern "C" int sparse_conv_implicit_bwd_bf16(
    const bf16* x, const bf16* g, const bf16* w, const int* rqkey,
    const int* skeys, const int* srow, bf16* dx, float* dw, int cin,
    int cout, int kvol, int n_in, int n_keys, int want_dx, void* stream) {
  return implicit_bwd(x, g, w, rqkey, skeys, srow, dx, dw, cin, cout, kvol,
                      n_in, n_keys, want_dx,
                      static_cast<cudaStream_t>(stream));
}

// Counts the rows that this source's dX launches multiply into *counter
// (unsigned long long on the device) from now on; nullptr stops counting.
// For checks only. Returns a cudaError_t as int.
extern "C" int sparse_conv_bwd_count_rows(void* counter) {
  return gg::set_row_counter(static_cast<unsigned long long*>(counter));
}

// Counts the rows that this source's dW launches stage into counter[0] and
// the blocks that staged them into counter[1] (unsigned long long [2] on
// the device) from now on; nullptr stops counting. For checks only.
// Returns a cudaError_t as int.
extern "C" int sparse_conv_bwd_count_dw_rows(void* counter) {
  return sk::set_staged_counter(static_cast<unsigned long long*>(counter));
}

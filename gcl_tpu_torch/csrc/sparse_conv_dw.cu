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
// It is the dW of every conv on the explicit route (whose tables have no
// reverse map to drive K7 by) and the second half of the implicit route's
// two-pass backward (dX is the forward kernel through the reverse map with
// flipped, transposed weights).
//
// What bounds it on this card: the products, as split TF32 on the tensor
// cores, far above what the gathered x rows, g, keys and dW cost in bytes.
//
// What the design does about it: it is the split-K core of splitk_dw.cuh,
// the one-pass backward's dW (sparse_conv_bwd.cu), with a resolver that
// drives the OUTPUT rows: kForward searches qkey[k, i] in the input
// level's sorted keys, kTable reads idx[k, i] and takes it only inside
// [0, n_in). A block owns (offset k, a Cin x Cout tile, a chunk of output
// rows), compacts the matched (row(k, i), i) pairs, gathers 32 at a time
// with cp.async and multiplies them in split TF32 on mma.sync, each stage
// summed on the tensor cores and the stages in float32 adds; it flushes
// into dW[k] once with atomicAdd, so dW agrees with the plain version to
// float32 rounding, not bit for bit. Cin = 1 (conv1 on the explicit route,
// K = 125) takes the core's CUDA-core form: a sum of g rows, each scaled
// by its x value (on the tensor cores 31/32 of a tile would be padding).
// The *_bf16 entry points take x and g in bf16 (the form gcl_tpu's Pallas
// kernels take for bf16 features) and multiply each stage in m16n8k16
// bf16 mma.sync with float32 sums; dW stays float32.

#include <cuda_runtime.h>

#include "splitk_dw.cuh"

// x f32[n_in, cin], g f32[n_out, cout], qkey int32[kvol, n_out], skeys /
// srow int32[n_keys] (sorted valid keys of the INPUT level and their
// rows), dw f32[kvol, cin, cout] zeroed by the caller; all contiguous on
// the device. Launches on `stream`; returns cudaGetLastError().
extern "C" int sparse_conv_implicit_dw(const float* x, const float* g,
                                       const int* qkey, const int* skeys,
                                       const int* srow, float* dw, int cin,
                                       int cout, int kvol, int n_out,
                                       int n_keys, void* stream) {
  return sk::launch_dw<float, sk::kForward>(x, g, qkey, skeys, srow, dw, cin,
                                            cout, kvol, n_out, n_keys,
                                            static_cast<cudaStream_t>(stream));
}

// The index-table form: idx int32[kvol, n_out] holds rows of x (n_in of
// them), anything outside [0, n_in) meaning no input. Otherwise as above.
extern "C" int sparse_conv_table_dw(const float* x, const float* g,
                                    const int* idx, float* dw, int cin,
                                    int cout, int kvol, int n_out, int n_in,
                                    void* stream) {
  return sk::launch_dw<float, sk::kTable>(x, g, idx, nullptr, nullptr, dw,
                                          cin, cout, kvol, n_out, n_in,
                                          static_cast<cudaStream_t>(stream));
}

// The bf16 forms: x and g bf16, dw float32, otherwise as above.
extern "C" int sparse_conv_implicit_dw_bf16(const bf16* x, const bf16* g,
                                            const int* qkey,
                                            const int* skeys,
                                            const int* srow, float* dw,
                                            int cin, int cout, int kvol,
                                            int n_out, int n_keys,
                                            void* stream) {
  return sk::launch_dw<bf16, sk::kForward>(x, g, qkey, skeys, srow, dw, cin,
                                           cout, kvol, n_out, n_keys,
                                           static_cast<cudaStream_t>(stream));
}

extern "C" int sparse_conv_table_dw_bf16(const bf16* x, const bf16* g,
                                         const int* idx, float* dw, int cin,
                                         int cout, int kvol, int n_out,
                                         int n_in, void* stream) {
  return sk::launch_dw<bf16, sk::kTable>(x, g, idx, nullptr, nullptr, dw,
                                         cin, cout, kvol, n_out, n_in,
                                         static_cast<cudaStream_t>(stream));
}

// Counts the rows that this source's launches stage into counter[0] and
// the blocks that staged them into counter[1] (unsigned long long [2] on
// the device) from now on; nullptr stops counting. For checks only.
// Returns a cudaError_t as int.
extern "C" int sparse_conv_dw_count_rows(void* counter) {
  return sk::set_staged_counter(static_cast<unsigned long long*>(counter));
}

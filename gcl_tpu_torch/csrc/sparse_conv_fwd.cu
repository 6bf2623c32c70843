// Sparse convolution, forward, over an implicit map or an index table,
// for Hopper (sm_90a).
//
// Replaces gcl_tpu/core/pallas_conv.py:_fwd_kernel_h + _windowed_gather_h
// (TPU kernel K6, reached through fused_conv_fwd -> _conv_half_fwd):
//
//   out[i, :] = sum_k x[srow[p], :] @ W[k]    where skeys[p] == qkey[k, i]
//
// and zero where no key matches. skeys are the packed keys of the input
// level's valid rows, sorted ascending as signed int32; srow their rows.
//
// The same kernel with the row read from a table in place of the key
// search replaces pallas_conv_fwd (K12: _fused_from_idx -> fused_conv_fwd
// -> _fwd_kernel, the index-table API of the explicit route):
//
//   out[i, :] = sum_k x[idx[k, i], :] @ W[k]
//
// with an entry outside [0, n_in) contributing zero.
//
// Both are the tensor-core gather-GEMM of gather_gemm.cuh, whose note says
// what bounds them on this card (the products, 2.3-2.6x of them wasted by
// a dense tile) and what the design does about it: matched rows compacted
// per (64-row tile, offset), the full output width per block, split TF32
// on mma.sync for float32; for bf16 (the *_bf16 entry points, the form
// gcl_tpu's Pallas kernels take for bf16 features: x and W in bf16, sums
// in float32, out rounded to bf16 once) one m16n8k16 bf16 mma.sync per
// product. The row resolver is its template parameter. A small Cin
// (conv1 on the explicit route: Cin 1, K 125) runs the same code with one
// 8-deep step per offset: a k-step covers 8 channels of which 1 is real,
// which the tensor cores absorb; no separate path.

#include <cuda_runtime.h>

#include "gather_gemm.cuh"

// x f32[n_in, cin], w f32[kvol, cin, cout], qkey int32[kvol, n_out],
// skeys / srow int32[n_keys], out f32[n_out, cout]; all contiguous on the
// device. Launches on `stream`; returns cudaGetLastError().
extern "C" int sparse_conv_implicit_fwd(const float* x, const float* w,
                                        const int* qkey, const int* skeys,
                                        const int* srow, float* out,
                                        int cin, int cout, int kvol,
                                        int n_out, int n_keys,
                                        void* stream) {
  return gg::launch<float, false, false>(x, w, qkey, skeys, srow, out, cin,
                                         cout, kvol, n_out, n_keys,
                                         static_cast<cudaStream_t>(stream));
}

// The index-table form: idx int32[kvol, n_out] holds rows of x (n_in of
// them), anything outside [0, n_in) meaning no input. Otherwise as above.
extern "C" int sparse_conv_table_fwd(const float* x, const float* w,
                                     const int* idx, float* out, int cin,
                                     int cout, int kvol, int n_out, int n_in,
                                     void* stream) {
  return gg::launch<float, true, false>(x, w, idx, nullptr, nullptr, out,
                                        cin, cout, kvol, n_out, n_in,
                                        static_cast<cudaStream_t>(stream));
}

// The bf16 forms: x, w and out bf16 (w rounded to bf16 by the caller),
// otherwise as above.
extern "C" int sparse_conv_implicit_fwd_bf16(const bf16* x, const bf16* w,
                                             const int* qkey,
                                             const int* skeys,
                                             const int* srow, bf16* out,
                                             int cin, int cout, int kvol,
                                             int n_out, int n_keys,
                                             void* stream) {
  return gg::launch<bf16, false, false>(x, w, qkey, skeys, srow, out, cin,
                                        cout, kvol, n_out, n_keys,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" int sparse_conv_table_fwd_bf16(const bf16* x, const bf16* w,
                                          const int* idx, bf16* out, int cin,
                                          int cout, int kvol, int n_out,
                                          int n_in, void* stream) {
  return gg::launch<bf16, true, false>(x, w, idx, nullptr, nullptr, out,
                                       cin, cout, kvol, n_out, n_in,
                                       static_cast<cudaStream_t>(stream));
}

// Counts the rows that this source's launches (K6, K12) multiply into
// *counter (unsigned long long on the device) from now on; nullptr stops
// counting. For checks only. Returns a cudaError_t as int.
extern "C" int sparse_conv_fwd_count_rows(void* counter) {
  return gg::set_row_counter(static_cast<unsigned long long*>(counter));
}

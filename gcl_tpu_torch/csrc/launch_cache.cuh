// What a launcher works out about its kernel once a device, shared by the
// sources whose launchers ask the runtime about their kernels (K3's
// occupancy_conv_dw.cu, K4 / K5 / K9's scalar_conv.cu).

#pragma once

#include <mutex>

#include <cuda_runtime.h>

namespace lc {

// What a launcher works out about its kernel once a device and reuses
// after (asking the runtime at every launch costs host time beside a
// kernel of a tenth of a millisecond): the dynamic shared memory its
// attribute allows, and how many blocks fit on the card at once with a
// given size. One for each kernel instantiation (a static in its
// launcher).
class LaunchCache {
 public:
  // Lets kernel launch on device dev with smem bytes of dynamic shared
  // memory (always asked for explicitly: K4 / K5's sit beside a static
  // Tile, K9's beside its neighbour table).
  template <typename Kernel>
  cudaError_t allow(Kernel kernel, int dev, size_t smem) {
    std::lock_guard<std::mutex> lock(mu_);
    if (dev < kMaxDevices && allowed_[dev] >= smem) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess && dev < kMaxDevices) allowed_[dev] = smem;
    return err;
  }

  // *blocks: how many blocks of kernel (threads each, smem bytes of
  // dynamic shared memory) fit on device dev at once, at least one an SM.
  template <typename Kernel>
  cudaError_t resident_blocks(Kernel kernel, int dev, int threads,
                              size_t smem, int* blocks) {
    std::lock_guard<std::mutex> lock(mu_);
    if (dev < kMaxDevices && occ_smem_[dev] == smem && occ_[dev] > 0) {
      *blocks = occ_[dev];
      return cudaSuccess;
    }
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    *blocks = (per_sm > 1 ? per_sm : 1) * sms;
    if (dev < kMaxDevices) {
      occ_smem_[dev] = smem;
      occ_[dev] = *blocks;
    }
    return cudaSuccess;
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::mutex mu_;
  size_t allowed_[kMaxDevices] = {};
  size_t occ_smem_[kMaxDevices] = {};
  int occ_[kMaxDevices] = {};
};

}  // namespace lc

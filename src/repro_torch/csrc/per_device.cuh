#pragma once
// Set-up that a launcher does once per CUDA device: a kernel's function
// attributes (its dynamic shared-memory opt-in) and what follows from them
// (its occupancy) belong to one device, so a process-wide static would hold
// the first device's only. Both classes key by the calling thread's current
// device (the wrappers make the tensors' device current for a launch) and
// take a lock, so threads that launch at once set each device up once.
#include <cuda_runtime.h>

#include <mutex>

constexpr int kMaxDevices = 64;

// The dynamic shared memory a kernel may take on each device, raised (by
// cudaFuncSetAttribute) when a launch asks for more than it was allowed.
class SmemOptIn {
 public:
  SmemOptIn() {
    for (int i = 0; i < kMaxDevices; ++i) allowed_[i] = 48 * 1024;
  }
  cudaError_t ensure(const void* kernel, size_t bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) {
      return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes);
    }
    std::lock_guard<std::mutex> lock(mu_);
    if (bytes <= allowed_[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) allowed_[dev] = bytes;
    return err;
  }

 private:
  std::mutex mu_;
  size_t allowed_[kMaxDevices];
};

// A value made once per device by make() (an occupancy query).
template <typename T>
class PerDevice {
 public:
  template <typename Make>
  T get(Make make) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return make();
    std::lock_guard<std::mutex> lock(mu_);
    if (!made_[dev]) {
      value_[dev] = make();
      made_[dev] = true;
    }
    return value_[dev];
  }

 private:
  std::mutex mu_;
  bool made_[kMaxDevices] = {};
  T value_[kMaxDevices] = {};
};

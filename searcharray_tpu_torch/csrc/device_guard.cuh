// The card a C entry launches on, for the entry's scope.  The caller's
// current device is set back when the entry returns, as a torch device
// guard sets it back, so a launch on one card of several leaves the
// process's current device (and with it every later torch call that names
// "cuda" without an index) where it was.
#pragma once

#include <cuda_runtime.h>

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    int current = -1;
    if (cudaGetDevice(&current) == cudaSuccess && current == device) return;
    prev_ = current;  // -1 where it could not be read: nothing to restore
    cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

 private:
  int prev_ = -1;
};

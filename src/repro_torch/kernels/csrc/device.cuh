// Queries of the current device that the kernels' launches share.

#pragma once

#include <cuda_runtime.h>

namespace cuda_device {

// The SMs of the current device, asked once and kept after the first
// query that succeeds (a launch only needs the count, and a host's cards
// are alike); a failed query returns its error.
inline cudaError_t sm_count(int* n) {
  static int kept = 0;
  if (kept == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) return err;
    kept = sms;
  }
  *n = kept;
  return cudaSuccess;
}

}  // namespace cuda_device

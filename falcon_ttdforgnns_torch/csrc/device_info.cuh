// What the launchers of this directory's kernel sources ask of the card,
// shared by the sources of csrc/ (each includes it once; the
// build hashes it with each source, ops/_build.py).
#pragma once

#include <cuda_runtime.h>

namespace {

// The current device's SM count, asked once per device (132 on an H100
// SXM, also the answer when the runtime cannot say).
int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    cached[dev] = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
                          cudaSuccess && n > 0 ? n : 132;
  }
  return cached[dev];
}

// The most dynamic shared memory one CTA may opt into on the current device
// (232,448 bytes, 227 KB, on an H100; also the answer when the runtime
// cannot say), asked once per device.
int max_dynamic_smem() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 232448;
  if (cached[dev] == 0) {
    int n = 0;
    cached[dev] = cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) ==
                          cudaSuccess && n > 0 ? n : 232448;
  }
  return cached[dev];
}

}  // namespace

// Capability probe: y = x + 1.
//
// Replaces: wgsassign_tpu/parallel/mesh.py::_probe_pallas and
// wgsassign_tpu/ops/pallas_emmaf.py::_mosaic_warmup, the trivial Pallas
// kernels that chose the engine path and warmed the Mosaic compiler.  Here
// it proves, once after the library loads, that the library's code runs on
// this card (Runtime.load_kernels rests on it).  Bound: launch latency
// only, an (8, 128) float32 tile.
#include "common.cuh"

__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ y,
                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
WG_EXPORT int wg_probe(int device, const float* x, float* y, int n, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

WG_EXPORT const char* wg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Shared pieces of the EM kernels.
//
// Rounding contract: the library is built with -fmad=false and without
// --use_fast_math, so every multiply, add and IEEE-rounded divide below
// rounds once, in the order written -- the same order as the plain PyTorch
// twins in ops/em_chunk.py and ops/loo_chunk.py (and the JAX package's
// _em_w).  Equal rounding keeps the EM trajectories, and with them the
// convergence iteration counts, equal to the twins'.
#pragma once

#include <cuda_runtime.h>

#define WG_EXPORT extern "C" __attribute__((visibility("default")))

// ops/emmaf.py::_EM_EPS and the clip bounds [EPS, 1 - EPS], each rounded
// once from the double constant to float32, as torch.clamp and jnp.clip do.
#define WG_EM_LO ((float)1e-7)
#define WG_EM_HI ((float)(1.0 - 1e-7))

// The EM weight (p1 + 2 p2) / (2 (p0 + p1 + p2)).  FAST is the reduced form
// (u + p2) / (p0 + 2u + p2) with u = p1 / 2: it scales operands by powers of
// two only, so it rounds identically for normal-range operands.
template <bool FAST>
__device__ __forceinline__ float em_w(float g0, float g1, float g2, float f) {
  const float omf = 1.0f - f;
  if (FAST) {
    const float u = g1 * f * omf;
    const float p0 = g0 * omf * omf;
    const float p2 = g2 * f * f;
    return (u + p2) / (p0 + 2.0f * u + p2);
  }
  const float p0 = g0 * omf * omf;
  const float p1 = g1 * 2.0f * f * omf;
  const float p2 = g2 * f * f;
  return (p1 + 2.0f * p2) / (2.0f * (p0 + p1 + p2));
}

__device__ __forceinline__ float em_clip(float x) {
  return fminf(fmaxf(x, WG_EM_LO), WG_EM_HI);
}

// Butterfly sum over the 32 lanes of a warp: a fixed order, so the result
// is the same from run to run (no atomics anywhere in the sq partials).
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

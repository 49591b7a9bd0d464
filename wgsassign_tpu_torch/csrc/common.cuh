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
// `omf` is 1 - f, passed in so that a loop over members computes it once.
template <bool FAST>
__device__ __forceinline__ float em_w(float g0, float g1, float g2, float f,
                                      float omf) {
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

template <bool FAST>
__device__ __forceinline__ float em_w(float g0, float g1, float g2, float f) {
  return em_w<FAST>(g0, g1, g2, f, 1.0f - f);
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

// Asynchronous global -> shared copies (no registers held while the bytes
// are in flight).  The 16-byte form needs both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* smem_dst,
                                            const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

// Wait for every cp.async this thread issued; a __syncthreads() after it
// makes the copies of all threads visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The leave-one-out kernels (loo_chunk.cu, zloo_chunk.cu): a block owns
// WG_TILE_SITES consecutive sites, a lane is a site, and the block's
// [n_real, 32] tile of both member panels lies in shared memory, or, for a
// population whose tile does not fit there, is read where it lies in the
// global panels (loo_members' STAGED).
constexpr int WG_TILE_SITES = 32;

// Stage rows [0, n_rows) x sites [s0, s0 + 32) of two site-minor planes with
// row length M into sg0 / sg1 ([n_rows][32] each).  `aligned`: every row of
// both planes starts 16-byte aligned at s0, so full tiles go by 16-byte
// cp.async; the ragged last tile and unaligned rows go through registers,
// and sites past M get the padding pattern (1, 0), whose weight is exactly
// 0.  lane, warp, n_warps, real (s < M) and s = s0 + lane are the caller's
// own values (recomputing them here costs the LOO kernel a register and two
// resident blocks an SM).  The caller's __syncthreads() makes the tile
// visible.
__device__ __forceinline__ void stage_member_tile(
    const float* __restrict__ g0p, const float* __restrict__ g1p, float* sg0,
    float* sg1, int n_rows, int M, long long s0, int aligned, int lane,
    int warp, int n_warps, bool real, long long s) {
  const int tid = threadIdx.x;
  if (aligned && s0 + WG_TILE_SITES <= M) {
    // a row of the tile is 128 bytes: eight 16-byte copies per member and
    // plane, consecutive threads on consecutive chunks
    const int per_plane = n_rows * (WG_TILE_SITES / 4);
    for (int e = tid; e < 2 * per_plane; e += blockDim.x) {
      const int plane = e >= per_plane;
      const int ee = e - plane * per_plane;
      const int i = ee >> 3;
      const int c4 = (ee & 7) * 4;
      const float* src = (plane ? g1p : g0p) + (long long)i * M + s0 + c4;
      cp_async_16((plane ? sg1 : sg0) + i * WG_TILE_SITES + c4, src);
    }
    cp_async_wait_all();
  } else {
    for (int i = warp; i < n_rows; i += n_warps) {
      sg0[i * WG_TILE_SITES + lane] = real ? g0p[(long long)i * M + s] : 1.0f;
      sg1[i * WG_TILE_SITES + lane] = real ? g1p[(long long)i * M + s] : 0.0f;
    }
  }
}

// Members [i0, i1) of the member tile added to NB problems' sums, in
// ascending order; sg0 / sg1 point at this lane's column.  STAGED: the tile
// lies in shared memory, rows WG_TILE_SITES apart; otherwise sg0 / sg1 point
// into the global panels themselves and rows are `ld` floats apart (a
// population too large to stage: the warp's 128-byte row reads go through
// L1 and L2, which keep the block's tile between problem tiles).  MASKED: a
// problem's own left-out member j[q] adds an exact 0.0f instead of its
// weight (a select, never a branch).  One (g0, g1, g2) read feeds NB
// weights, and NB independent divide chains hide each other's latency.
template <bool FAST, int NB, bool MASKED, bool STAGED = true>
__device__ __forceinline__ void loo_members(
    const float* __restrict__ sg0, const float* __restrict__ sg1, int i0,
    int i1, const int (&j)[NB], const float (&f)[NB], float (&acc)[NB],
    long long ld = WG_TILE_SITES) {
  float omf[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q) omf[q] = 1.0f - f[q];
  const float* pa;
  const float* pb;
  if constexpr (STAGED) {
    pa = sg0 + i0 * WG_TILE_SITES;
    pb = sg1 + i0 * WG_TILE_SITES;
  } else {
    pa = sg0 + i0 * ld;
    pb = sg1 + i0 * ld;
  }
#pragma unroll 2
  for (int i = i0; i < i1; ++i) {
    const float a = *pa;
    const float b = *pb;
    const float c = 1.0f - a - b;
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const float w = em_w<FAST>(a, b, c, f[q], omf[q]);
      acc[q] += (MASKED && i == j[q]) ? 0.0f : w;
    }
    if constexpr (STAGED) {
      pa += WG_TILE_SITES;
      pb += WG_TILE_SITES;
    } else {
      pa += ld;
      pb += ld;
    }
  }
}

// T fused leave-one-out EM iterations for one population on the GPU.
//
// Replaces: wgsassign_tpu/ops/pallas_emmaf.py::_loo_chunk_kernel (launched
// by loo_chunk_pallas).  Problem j of the population takes
// min(T, limits[j]) updates
//     f_j <- clip(sum_{i != j, i < n_real} w(g_i, f_j) / (n_real - 1))
// and the kernel emits every iteration's squared update per problem.
//
// What bounds it on an H100: per site and iteration each of the P problems
// sums n_real - 1 weights (~12 float ops and an IEEE divide each), so the
// work is P * n_real per site against 8 n_real bytes of GLs read once per
// chunk: compute-bound.  The member panel tile takes 8 * n_real * S bytes of
// shared memory; the smallest tile (S = 32 sites) caps a population at
// max_loo_members(T) members (807 at T = 8), where the wrapper raises.
//
// Design: one thread per site; a block stages its [n_real, S] tile of the
// site-minor member panels in shared memory ONCE and loops over all P
// problems inside the block (the TPU kernel put problems on the grid and
// re-fetched the tile per problem, a Mosaic limit).  Each problem's f stays
// in a register for its T iterations.  Members i == j and i >= n_real are
// skipped, the same mask as the TPU kernel; members are summed in ascending
// order, as the plain twin does.  Problems whose limit is 0 (converged or
// padding rows) are skipped and copied through.  The per-iteration squared
// updates are reduced per warp with shuffles and per block in a fixed order
// into sq_part[block, T, P]; no float atomics.
#include "common.cuh"

template <bool FAST>
__global__ void loo_chunk_kernel(
    const float* __restrict__ g0p, const float* __restrict__ g1p,
    const float* __restrict__ ft_in, float* __restrict__ ft_out,
    const float* __restrict__ limits, float* __restrict__ sq_part,
    int P, int M, int n_real, int T) {
  extern __shared__ float smem[];
  const int S = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = S >> 5;
  const int TP = T * P;

  float* sg0 = smem;                // [n_real][S]
  float* sg1 = sg0 + n_real * S;    // [n_real][S]
  float* ssq = sg1 + n_real * S;    // [n_warps][T * P]

  const long long s = (long long)blockIdx.x * S + tid;
  const bool real = s < M;

  // consecutive threads read consecutive sites of each member row
  for (int i = 0; i < n_real; ++i) {
    sg0[i * S + tid] = real ? g0p[(long long)i * M + s] : 1.0f;
    sg1[i * S + tid] = real ? g1p[(long long)i * M + s] : 0.0f;
  }
  __syncthreads();

  const float inv = 1.0f / ((float)n_real - 1.0f);
  for (int j = 0; j < P; ++j) {
    const float lim = __ldg(limits + j);
    float f = real ? ft_in[(long long)j * M + s] : WG_EM_LO;
    for (int t = 0; t < T; ++t) {
      float d = 0.0f;
      if (lim > (float)t) {  // uniform across the block
        float acc = 0.0f;
        for (int i = 0; i < n_real; ++i) {
          if (i == j) continue;
          const float a = sg0[i * S + tid];
          const float b = sg1[i * S + tid];
          acc += em_w<FAST>(a, b, 1.0f - a - b, f);
        }
        const float f_new = em_clip(acc * inv);
        d = real ? f_new - f : 0.0f;
        f = f_new;
      }
      const float v = warp_sum(d * d);
      if (lane == 0) ssq[warp * TP + t * P + j] = v;
    }
    if (real) ft_out[(long long)j * M + s] = f;
  }
  __syncthreads();
  for (int e = tid; e < TP; e += S) {
    float v = 0.0f;
    for (int w = 0; w < n_warps; ++w) v += ssq[w * TP + e];
    sq_part[(long long)blockIdx.x * TP + e] = v;
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
WG_EXPORT int wg_loo_chunk(int device, const float* g0p, const float* g1p,
                           const float* ft_in, float* ft_out,
                           const float* limits, float* sq_part, int P, int M,
                           int n_real, int T, int block_sites, int smem_bytes,
                           int fast_math, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  void (*kern)(const float*, const float*, const float*, float*,
               const float*, float*, int, int, int, int) =
      fast_math ? loo_chunk_kernel<true> : loo_chunk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + block_sites - 1) / block_sites;
  kern<<<blocks, block_sites, smem_bytes, (cudaStream_t)stream>>>(
      g0p, g1p, ft_in, ft_out, limits, sq_part, P, M, n_real, T);
  return (int)cudaGetLastError();
}

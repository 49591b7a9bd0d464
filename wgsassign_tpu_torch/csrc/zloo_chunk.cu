// T fused leave-one-out EM iterations of B z-score problems of one
// population over the full site axis, on the GPU.
//
// Replaces: wgsassign_tpu/ops/pallas_emmaf.py::_zloo_chunk_kernel (launched
// by zloo_chunk_pallas).  Problem b leaves out member leave[b] and takes
// min(T, limits[b]) updates
//     f_b <- clip(sum_{i != leave[b], i < n_real} w(g_i, f_b) / (n_real - 1))
// at every site; its kept-site mask sw[b] enters only the squared-update
// partials sq[t, b] = sum_s (d * d * sw[b, s]).
//
// What bounds it on an H100: as loo_chunk.cu, per site and iteration each
// problem sums n_real - 1 weights against 8 n_real bytes of GLs read once
// per chunk: compute-bound.  The member tile takes 8 * n_real * S bytes of
// shared memory and the per-warp sq partials 4 * (S / 32) * T * B bytes;
// at the smallest tile (S = 32 sites) the wrapper raises above
// max_zloo_members(T, B) members (900 at T = 8, B = 64).
//
// Design: one thread per site; a block stages its [n_real, S] tile of the
// site-minor member panels in shared memory ONCE and loops over the B
// problems inside the block (the TPU kernel re-fetched the panel per grid
// step, a Mosaic limit).  Each problem's f stays in a register for its T
// iterations.  Members are summed in ascending order, the left-out one and
// the padding rows skipped (the TPU kernel multiplies them by 0, which
// adds exactly 0).  Problems whose limit is 0 are copied through.  The
// per-iteration partials are reduced per warp with shuffles and per block
// in a fixed order into sq_part[block, T, B]; no float atomics.
#include "common.cuh"

template <bool FAST>
__global__ void zloo_chunk_kernel(
    const float* __restrict__ g0p, const float* __restrict__ g1p,
    const float* __restrict__ ft_in, float* __restrict__ ft_out,
    const float* __restrict__ sw, const int* __restrict__ leave,
    const float* __restrict__ limits, float* __restrict__ sq_part,
    int B, int M, int n_real, int T) {
  extern __shared__ float smem[];
  const int S = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = S >> 5;
  const int TB = T * B;

  float* sg0 = smem;                // [n_real][S]
  float* sg1 = sg0 + n_real * S;    // [n_real][S]
  float* ssq = sg1 + n_real * S;    // [n_warps][T * B]

  const long long s = (long long)blockIdx.x * S + tid;
  const bool real = s < M;

  for (int i = 0; i < n_real; ++i) {
    sg0[i * S + tid] = real ? g0p[(long long)i * M + s] : 1.0f;
    sg1[i * S + tid] = real ? g1p[(long long)i * M + s] : 0.0f;
  }
  __syncthreads();

  const float inv = 1.0f / ((float)n_real - 1.0f);
  for (int b = 0; b < B; ++b) {
    const float lim = __ldg(limits + b);
    const int lv = __ldg(leave + b);
    const long long row = (long long)b * M + s;
    float f = real ? ft_in[row] : WG_EM_LO;
    const float w_site = real ? sw[row] : 0.0f;
    for (int t = 0; t < T; ++t) {
      float d = 0.0f;
      if (lim > (float)t) {  // uniform across the block
        float acc = 0.0f;
        for (int i = 0; i < n_real; ++i) {
          if (i == lv) continue;
          const float a = sg0[i * S + tid];
          const float c = sg1[i * S + tid];
          acc += em_w<FAST>(a, c, 1.0f - a - c, f);
        }
        const float f_new = em_clip(acc * inv);
        d = real ? f_new - f : 0.0f;
        f = f_new;
      }
      const float v = warp_sum(d * d * w_site);
      if (lane == 0) ssq[warp * TB + t * B + b] = v;
    }
    if (real) ft_out[row] = f;
  }
  __syncthreads();
  for (int e = tid; e < TB; e += S) {
    float v = 0.0f;
    for (int w = 0; w < n_warps; ++w) v += ssq[w * TB + e];
    sq_part[(long long)blockIdx.x * TB + e] = v;
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
WG_EXPORT int wg_zloo_chunk(int device, const float* g0p, const float* g1p,
                            const float* ft_in, float* ft_out,
                            const float* sw, const int* leave,
                            const float* limits, float* sq_part, int B, int M,
                            int n_real, int T, int block_sites,
                            int smem_bytes, int fast_math, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  void (*kern)(const float*, const float*, const float*, float*,
               const float*, const int*, const float*, float*, int, int, int,
               int) =
      fast_math ? zloo_chunk_kernel<true> : zloo_chunk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + block_sites - 1) / block_sites;
  kern<<<blocks, block_sites, smem_bytes, (cudaStream_t)stream>>>(
      g0p, g1p, ft_in, ft_out, sw, leave, limits, sq_part, B, M, n_real, T);
  return (int)cudaGetLastError();
}

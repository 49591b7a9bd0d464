// T fused iterations of B independent one-population EMs over gathered
// member panels (the z-score reference mode's gathered form), on the GPU.
//
// Replaces: wgsassign_tpu/ops/pallas_emmaf.py::_sites_chunk_kernel
// (launched by sites_chunk_pallas).  Problem b has its own [P, S] member
// panel, member mask, site weight and 1/count, and takes min(T, limits[b])
// updates
//     f_b <- clip((sum_p w(g_bp, f_b) * mask[b, p]) * inv[b])
// at each of its S site slots; sq[t, b] = sum_s (d * d * sw[b, s]).
//
// What bounds it on an H100: per site and iteration ~13 float ops and an
// IEEE divide per member against 8 P bytes of GLs read once per chunk:
// compute-bound.  The block's [P, S] slice of both panels takes 8 * P * S
// bytes of shared memory; at the smallest tile (S = 32 sites) the wrapper
// raises above max_sites_members(T) members (907 at T = 8).
//
// Design: one problem per blockIdx.y, one site per thread.  The block
// stages its [P, S] slice of problem b's panels in shared memory once per
// chunk and keeps f in a register for all T iterations.  Members are summed
// in ascending order and the product with inv[b] follows the member sum,
// the op order of the plain version (ops/emmaf.py::em_maf_sites_batch);
// members whose mask is 0 add exactly 0 there and are skipped here.  The
// per-iteration partials are reduced per warp with shuffles and per block
// in a fixed order into sq_part[site block, T, B]; no float atomics.
#include "common.cuh"

template <bool FAST>
__global__ void sites_chunk_kernel(
    const float* __restrict__ g0p, const float* __restrict__ g1p,
    const float* __restrict__ ft_in, float* __restrict__ ft_out,
    const float* __restrict__ mask, const float* __restrict__ sw,
    const float* __restrict__ limits, const float* __restrict__ inv_counts,
    float* __restrict__ sq_part, int B, int P, int S_total, int T) {
  extern __shared__ float smem[];
  const int S = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = S >> 5;
  const int b = blockIdx.y;

  float* sg0 = smem;           // [P][S]
  float* sg1 = sg0 + P * S;    // [P][S]
  float* ssq = sg1 + P * S;    // [n_warps][T]

  const long long s = (long long)blockIdx.x * S + tid;
  const bool real = s < S_total;
  const long long panel = (long long)b * P * S_total;
  const long long row = (long long)b * S_total + s;

  // consecutive threads read consecutive sites of each member row
  for (int p = 0; p < P; ++p) {
    sg0[p * S + tid] = real ? g0p[panel + (long long)p * S_total + s] : 1.0f;
    sg1[p * S + tid] = real ? g1p[panel + (long long)p * S_total + s] : 0.0f;
  }
  __syncthreads();

  const float lim = __ldg(limits + b);
  const float inv = __ldg(inv_counts + b);
  const float* mask_b = mask + (long long)b * P;
  float f = real ? ft_in[row] : WG_EM_LO;
  const float w_site = real ? sw[row] : 0.0f;
  for (int t = 0; t < T; ++t) {
    float d = 0.0f;
    if (lim > (float)t) {  // uniform across the block
      float acc = 0.0f;
      for (int p = 0; p < P; ++p) {
        const float mk = __ldg(mask_b + p);
        if (mk == 0.0f) continue;
        const float a = sg0[p * S + tid];
        const float c = sg1[p * S + tid];
        acc += em_w<FAST>(a, c, 1.0f - a - c, f) * mk;
      }
      const float f_new = em_clip(acc * inv);
      d = real ? f_new - f : 0.0f;
      f = f_new;
    }
    const float v = warp_sum(d * d * w_site);
    if (lane == 0) ssq[warp * T + t] = v;
  }
  if (real) ft_out[row] = f;
  __syncthreads();
  for (int t = tid; t < T; t += S) {
    float v = 0.0f;
    for (int w = 0; w < n_warps; ++w) v += ssq[w * T + t];
    sq_part[((long long)blockIdx.x * T + t) * B + b] = v;
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
WG_EXPORT int wg_sites_chunk(int device, const float* g0p, const float* g1p,
                             const float* ft_in, float* ft_out,
                             const float* mask, const float* sw,
                             const float* limits, const float* inv_counts,
                             float* sq_part, int B, int P, int S_total, int T,
                             int block_sites, int smem_bytes, int fast_math,
                             void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  void (*kern)(const float*, const float*, const float*, float*,
               const float*, const float*, const float*, const float*,
               float*, int, int, int, int) =
      fast_math ? sites_chunk_kernel<true> : sites_chunk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S_total + block_sites - 1) / block_sites, B);
  kern<<<grid, block_sites, smem_bytes, (cudaStream_t)stream>>>(
      g0p, g1p, ft_in, ft_out, mask, sw, limits, inv_counts, sq_part, B, P,
      S_total, T);
  return (int)cudaGetLastError();
}

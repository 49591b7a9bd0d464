// T fused all-population MAF EM iterations on the GPU.
//
// Replaces: wgsassign_tpu/ops/pallas_emmaf.py::_em_chunk_kernel (launched by
// em_chunk_pallas).  Same chunk contract: every population k takes
// min(T, limits[k]) updates
//     f_k <- clip(inv_counts[k] * sum_{i in pop k} w(g_i, f_k))
// and the kernel emits the squared update of every iteration, so the host
// loop (ops/fused_em.py::_drive_chunks) can rebuild each RMSE sequence.
//
// What bounds it on an H100: with every population active for T >= 2
// iterations, operations (15 float operations a weight, ~23 issue slots
// under the rounding contract of common.cuh); with most
// populations converged, the 8 N bytes a site of GLs read once per chunk.
//
// Design, and what each part is for:
// - EM_LANES = 8 threads share a site, so no thread needs the site's N
//   individuals to itself.  A block owns S (16, 8 or 4) consecutive sites,
//   S * 8 threads; a warp holds four sites.
// - The individuals are taken in population order (`order`, a stable sort of
//   the individual -> population index made by the wrapper, and its inverse
//   `pos`; population k is positions [beg[k], beg[k+1])).  The block reads
//   its sites' GL rows in file order, consecutive lanes on consecutive
//   addresses, and 4-byte cp.async (no registers held across the copy)
//   puts each (g0, g1) pair at its position in shared memory, once for all
//   T iterations, and only for populations still within their limit.  At
//   N = 180 a block of 16 sites takes 25 KB: eight blocks, 32 warps, on an
//   SM (the one-thread-per-site kernel this replaces kept 8 N bytes a
//   thread and held four to five warps).
// - Per iteration and population, lane l of a site sums the weights of the
//   population's members l, l + 8, l + 16, ... in ascending order into one
//   register: f_k is a scalar, there is one 8-byte shared load a weight,
//   no index into a register array and no read-modify-write of shared
//   memory.  The eight partial sums are combined by a butterfly (xor 4, 2,
//   1), a fixed order; the plain twin (ops/em_chunk.py::em_chunk_twin) sums
//   in exactly this order.
// - The row stride of the shared tile is 8 mod 16 pairs, so the two sites
//   of a half-warp's 8-byte loads fall into disjoint banks.
// - f lives in shared memory, one value per (population, site): lane 0 of
//   the site writes the update, __syncwarp() orders it against the group's
//   reads.  All eight lanes hold the same update, so the squared update is
//   summed over the warp's four sites by two more butterfly steps (xor 16,
//   8), per warp into shared memory, and per block in a fixed order into
//   sq_part[block, T, K]; the caller sums the blocks.  No float atomics:
//   the convergence decision reads these sums.
// - No bound on N: when S = 4 sites of N individuals do not fit in shared
//   memory, the tile holds NC positions, and each (iteration, population)
//   walks its members in slices of NC, staged again from L2; a lane's
//   members and their order do not depend on the slicing.
// - A population's range, 1 / count and limit sit in one 16-byte shared
//   entry, read once per round.  Rounds past a population's limit do
//   nothing (limits are uniform over the block): their partials are the
//   zeros set at the start, and the iteration loop ends at the largest
//   limit.  Sites past M behave as padding, (g0, g1) = (1, 0) and
//   f = EPS, whose weight is exactly 0 and whose update is EPS again.
#include "common.cuh"

namespace {

constexpr int L = 8;  // ops/em_chunk.py::EM_LANES

template <bool FAST>
__global__ void __launch_bounds__(16 * L) em_chunk_kernel(
    const float* __restrict__ g0, const float* __restrict__ g1,
    const float* __restrict__ ft_in, float* __restrict__ ft_out,
    const int* __restrict__ pop, const int* __restrict__ pos,
    const int* __restrict__ order, const int* __restrict__ beg,
    const float* __restrict__ inv_counts, const float* __restrict__ limits,
    float* __restrict__ sq_part, int M, int N, int K, int T, int S,
    int stride, int NC) {
  extern __shared__ float4 smem4[];
  float4* spop = smem4;                                 // [K]
  float2* tile = reinterpret_cast<float2*>(smem4 + K);  // [S][stride]
  float* sf = reinterpret_cast<float*>(tile + S * stride);  // [K][S]
  float* ssq = sf + K * S;                              // [n_warps][T * K]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int l = tid % L;
  const int site = tid / L;
  const int TK = T * K;
  const long long s0 = (long long)blockIdx.x * S;
  const bool real = s0 + site < M;
  const bool resident = NC >= N;

  for (int e = tid; e < K * S; e += blockDim.x) {
    const int k = e / S;
    const long long ss = s0 + (e - k * S);
    sf[e] = ss < M ? ft_in[(long long)k * M + ss] : WG_EM_LO;
  }
  for (int e = tid; e < n_warps * TK; e += blockDim.x) ssq[e] = 0.0f;
  for (int k = tid; k < K; k += blockDim.x) {
    spop[k] = make_float4(__int_as_float(__ldg(beg + k)),
                          __int_as_float(__ldg(beg + k + 1)),
                          __ldg(inv_counts + k), __ldg(limits + k));
  }
  float lim_max = 0.0f;
  for (int k = 0; k < K; ++k) lim_max = fmaxf(lim_max, __ldg(limits + k));
  const int t_end = min(T, (int)ceilf(lim_max));

  if (resident) {
    // every individual of a population still within its limit, read in file
    // order (a warp takes a site's row, its lanes consecutive addresses) and
    // written at its position in population order
    for (int row = warp; row < S; row += n_warps) {
      const long long ss = s0 + row;
      float2* dst = tile + row * stride;
      if (ss < M) {
        const float* a = g0 + ss * N;
        const float* b = g1 + ss * N;
        for (int i = lane; i < N; i += 32) {
          if (__ldg(limits + __ldg(pop + i)) > 0.0f) {
            const int r = __ldg(pos + i);
            cp_async_4(&dst[r].x, a + i);
            cp_async_4(&dst[r].y, b + i);
          }
        }
      } else {
        for (int r = lane; r < N; r += 32) dst[r] = make_float2(1.0f, 0.0f);
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();

  // the sliced walk: positions [r0, r1) of every site -> tile[.][r - r0],
  // gathered through `order` (served by L2 after the first iteration)
  auto stage = [&](int r0, int r1) {
    for (int row = warp; row < S; row += n_warps) {
      const long long ss = s0 + row;
      float2* dst = tile + row * stride - r0;
      if (ss < M) {
        const float* a = g0 + ss * N;
        const float* b = g1 + ss * N;
        for (int r = r0 + lane; r < r1; r += 32) {
          const int i = __ldg(order + r);
          cp_async_4(&dst[r].x, a + i);
          cp_async_4(&dst[r].y, b + i);
        }
      } else {
        for (int r = r0 + lane; r < r1; r += 32) {
          dst[r] = make_float2(1.0f, 0.0f);
        }
      }
    }
    cp_async_wait_all();
  };

  // (t, k) rounds past a population's limit write nothing: their partials
  // are the zeros set at the start, and t stops at the largest limit
  const float2* const row = tile + site * stride;
  float* const sf_site = sf + site;
  float* const ssq_warp = ssq + warp * TK;
  for (int t = 0; t < t_end; ++t) {
    const float tf = (float)t;
    for (int k = 0; k < K; ++k) {
      const float4 pk = spop[k];  // beg, end, 1 / count, limit
      if (!(pk.w > tf)) continue;  // uniform across the block
      const int b = __float_as_int(pk.x);
      const int e = __float_as_int(pk.y);
      const float f = sf_site[k * S];
      const float omf = 1.0f - f;
      float acc = 0.0f;
      if (resident) {
        const float2* p = row + b + l;
        const float2* const end = row + e;
#pragma unroll 4
        for (; p < end; p += L) {
          const float2 g = *p;
          acc += em_w<FAST>(g.x, g.y, 1.0f - g.x - g.y, f, omf);
        }
      } else {
        // NC is a multiple of L: lane l keeps members b + l, b + l + L, ...
        for (int c0 = b; c0 < e; c0 += NC) {
          const int c1 = min(c0 + NC, e);
          __syncthreads();  // the previous slice is read no more
          stage(c0, c1);
          __syncthreads();
          for (int r = c0 + l; r < c1; r += L) {
            const float2 g = row[r - c0];
            acc += em_w<FAST>(g.x, g.y, 1.0f - g.x - g.y, f, omf);
          }
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      const float f_new = em_clip(acc * pk.z);
      const float d = real ? f_new - f : 0.0f;
      __syncwarp();  // every lane of the site has read f
      if (l == 0) sf_site[k * S] = f_new;
      float v = d * d;
#pragma unroll
      for (int off = 16; off >= L; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == 0) ssq_warp[t * K + k] = v;
    }
    __syncwarp();  // this iteration's f is visible to the site's lanes
  }

  __syncthreads();
  for (int e = tid; e < K * S; e += blockDim.x) {
    const int k = e / S;
    const long long ss = s0 + (e - k * S);
    if (ss < M) ft_out[(long long)k * M + ss] = sf[e];
  }
  for (int e = tid; e < TK; e += blockDim.x) {
    float v = 0.0f;
    for (int w = 0; w < n_warps; ++w) v += ssq[w * TK + e];
    sq_part[(long long)blockIdx.x * TK + e] = v;
  }
}

using EmKernel = void (*)(const float*, const float*, const float*, float*,
                          const int*, const int*, const int*, const int*,
                          const float*, const float*, float*, int, int, int,
                          int, int, int, int);

EmKernel em_kernel(int fast_math) {
  return fast_math ? em_chunk_kernel<true> : em_chunk_kernel<false>;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
WG_EXPORT int wg_em_chunk(int device, const float* g0, const float* g1,
                          const float* ft_in, float* ft_out, const int* pop,
                          const int* pos, const int* order, const int* beg,
                          const float* inv_counts,
                          const float* limits, float* sq_part, int M, int N,
                          int K, int T, int block_sites, int stride, int NC,
                          int smem_bytes, int fast_math, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  EmKernel kern = em_kernel(fast_math);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + block_sites - 1) / block_sites;
  kern<<<blocks, block_sites * L, smem_bytes, (cudaStream_t)stream>>>(
      g0, g1, ft_in, ft_out, pop, pos, order, beg, inv_counts, limits, sq_part,
      M, N, K, T, block_sites, stride, NC);
  return (int)cudaGetLastError();
}

// Resident blocks per SM the runtime reports for this launch shape, or the
// negated CUDA error code.
WG_EXPORT int wg_em_chunk_occupancy(int device, int block_sites,
                                    int smem_bytes, int fast_math) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  EmKernel kern = em_kernel(fast_math);
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kern, block_sites * L, smem_bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

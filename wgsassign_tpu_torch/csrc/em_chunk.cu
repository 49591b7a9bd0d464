// T fused all-population MAF EM iterations on the GPU.
//
// Replaces: wgsassign_tpu/ops/pallas_emmaf.py::_em_chunk_kernel (launched by
// em_chunk_pallas).  Same chunk contract: every population k takes
// min(T, limits[k]) updates
//     f_k <- clip(inv_counts[k] * sum_{i in pop k} w(g_i, f_k))
// and the kernel emits the squared update of every iteration, so the host
// loop (ops/fused_em.py::_drive_chunks) can rebuild each RMSE sequence.
//
// What bounds it on an H100: the weight is ~12 float ops and one IEEE
// divide per (site, individual, iteration), and the GLs are read once per
// chunk of T iterations, so the chunk is compute-bound at T >= 2.  Each site
// needs 8 N bytes of shared memory (g0 and g1 of all N individuals): at
// N = 180 that is 1.4 KB, so an SM's 227 KB hold ~160 sites, i.e. about five
// resident warps -- occupancy, not bandwidth, is the limit of this first
// version.
//
// Design: one thread per site, a block owns `blockDim.x` consecutive sites.
// The block's GL rows are one contiguous [S, N] region of g0/g1; they are
// staged into shared memory (transposed, [N][S + 1], so the per-individual
// reads of the T loop are conflict-free) once for all T iterations.  The
// individual axis is looped inside the block, NC individuals at a time:
// when NC >= N the tile stays resident for the whole chunk, otherwise each
// iteration re-stages the NC-wide slices from L2 -- so there is no bound on
// the number of individuals.  An int32 individual -> population index
// replaces the TPU kernel's float one-hot (the same exact gather), and each
// thread keeps its site's f[K] and K running member sums in shared memory
// columns that only it touches.  Members are summed in ascending individual
// order, as the plain twin does.  Populations whose limit is reached are
// skipped (their f would be kept unchanged anyway).  The per-iteration
// squared updates are reduced per warp with shuffles and per block in a
// fixed order into sq_part[block, T, K]; the caller sums the blocks.  No
// float atomics: the convergence decision reads these sums.
#include "common.cuh"

template <bool FAST>
__global__ void em_chunk_kernel(
    const float* __restrict__ g0, const float* __restrict__ g1,
    const float* __restrict__ ft_in, float* __restrict__ ft_out,
    const int* __restrict__ pop, const float* __restrict__ inv_counts,
    const float* __restrict__ limits, float* __restrict__ sq_part,
    int M, int N, int K, int T, int NC) {
  extern __shared__ float smem[];
  const int S = blockDim.x;
  const int stride = S + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = S >> 5;
  const int TK = T * K;

  float* sg0 = smem;                 // [NC][S + 1]
  float* sg1 = sg0 + NC * stride;    // [NC][S + 1]
  float* sf = sg1 + NC * stride;     // [K][S]    this chunk's AF
  float* sacc = sf + K * S;          // [K][S]    member sums
  float* ssq = sacc + K * S;         // [n_warps][T * K]

  const long long s0 = (long long)blockIdx.x * S;
  const long long s = s0 + tid;
  const bool real = s < M;
  const int rows = (int)min((long long)S, (long long)M - s0);

  // sites past M behave as padding: (g0, g1) = (1, 0), f = EPS, whose
  // update is exactly EPS again
  for (int k = 0; k < K; ++k) {
    sf[k * S + tid] = real ? ft_in[(long long)k * M + s] : WG_EM_LO;
  }

  // stage individuals [c0, c0 + nc) of the block's rows: the source is the
  // contiguous [rows, N] block, read with consecutive threads on
  // consecutive addresses
  auto stage = [&](int c0, int nc) {
    const long long base = s0 * N;
    for (int e = tid; e < S * nc; e += S) {
      const int r = e / nc;
      const int l = e - r * nc;
      float a = 1.0f, b = 0.0f;
      if (r < rows) {
        const long long off = base + (long long)r * N + c0 + l;
        a = g0[off];
        b = g1[off];
      }
      sg0[l * stride + r] = a;
      sg1[l * stride + r] = b;
    }
  };

  const bool resident = NC >= N;
  if (resident) {
    stage(0, N);
    __syncthreads();
  }

  for (int t = 0; t < T; ++t) {
    const float tf = (float)t;
    for (int k = 0; k < K; ++k) sacc[k * S + tid] = 0.0f;
    for (int c0 = 0; c0 < N; c0 += NC) {
      const int nc = min(NC, N - c0);
      if (!resident) {
        __syncthreads();
        stage(c0, nc);
        __syncthreads();
      }
      for (int l = 0; l < nc; ++l) {
        const int k = __ldg(pop + c0 + l);
        if (!(__ldg(limits + k) > tf)) continue;  // uniform across the block
        const float a = sg0[l * stride + tid];
        const float b = sg1[l * stride + tid];
        const float c = 1.0f - a - b;
        sacc[k * S + tid] += em_w<FAST>(a, b, c, sf[k * S + tid]);
      }
    }
    for (int k = 0; k < K; ++k) {
      float d = 0.0f;
      if (__ldg(limits + k) > tf) {
        const float f = sf[k * S + tid];
        const float f_new = em_clip(sacc[k * S + tid] * __ldg(inv_counts + k));
        d = real ? f_new - f : 0.0f;
        sf[k * S + tid] = f_new;
      }
      const float v = warp_sum(d * d);
      if (lane == 0) ssq[warp * TK + t * K + k] = v;
    }
  }

  for (int k = 0; k < K; ++k) {
    if (real) ft_out[(long long)k * M + s] = sf[k * S + tid];
  }
  __syncthreads();
  for (int e = tid; e < TK; e += S) {
    float v = 0.0f;
    for (int w = 0; w < n_warps; ++w) v += ssq[w * TK + e];
    sq_part[(long long)blockIdx.x * TK + e] = v;
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
WG_EXPORT int wg_em_chunk(int device, const float* g0, const float* g1,
                          const float* ft_in, float* ft_out, const int* pop,
                          const float* inv_counts, const float* limits,
                          float* sq_part, int M, int N, int K, int T, int NC,
                          int block_sites, int smem_bytes, int fast_math,
                          void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  void (*kern)(const float*, const float*, const float*, float*, const int*,
               const float*, const float*, float*, int, int, int, int, int) =
      fast_math ? em_chunk_kernel<true> : em_chunk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + block_sites - 1) / block_sites;
  kern<<<blocks, block_sites, smem_bytes, (cudaStream_t)stream>>>(
      g0, g1, ft_in, ft_out, pop, inv_counts, limits, sq_part, M, N, K, T,
      NC);
  return (int)cudaGetLastError();
}

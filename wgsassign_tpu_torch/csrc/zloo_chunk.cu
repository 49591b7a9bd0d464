// One leave-one-out EM iteration of B z-score problems of one population
// over the full site axis, on the GPU, in place.
//
// Replaces: wgsassign_tpu/ops/pallas_emmaf.py::_zloo_chunk_kernel (launched
// by zloo_chunk_pallas), which fuses T iterations a launch.  Here each
// problem b whose limits[b] is above 0 leaves out member leave[b] and takes
// one update
//     f_b <- clip(sum_{i != leave[b], i < n_real} w(g_i, f_b) / (n_real - 1))
// at every site; its kept-site mask sw[b] enters only the squared-update
// partials sq[b] = sum_s (d * d * sw[b, s]).  The EM driver launches it once
// an iteration, as loo_chunk.cu.
//
// What bounds it on an H100: operations, as loo_chunk.cu.  Per site each
// problem sums n_real - 1 weights against 8 n_real bytes of GLs read once a
// launch, and the rounding contract (common.cuh) makes a weight ~23
// instruction slots: the float32 pipe is the limit long before memory.
//
// Design: loo_chunk.cu's, with the left-out members taken from an array.
// - A block owns 32 consecutive sites and stages their [n_real, 32] tile of
//   both member panels once (common.cuh::stage_member_tile: 16-byte
//   cp.async where rows are 16-byte aligned).  The tile is all the shared
//   memory the block takes, 8 n_real bytes a site whatever B: it fits
//   up to 908 members.  Above that (STAGED false, launched with no shared
//   memory) nothing is staged and a lane reads its column of the global
//   panels row by row, in the same order (loo_chunk.cu says why that is
//   enough); lanes past M read the last site's column and contribute
//   nothing.
// - A lane is a site; a warp carries a tile of JB problems through the
//   member loop at once (common.cuh::loo_members: one GL read feeds JB
//   weights, JB divide chains side by side), and the block's warps take the
//   problem tiles round-robin.  A problem belongs to one warp, so
//   sq[b] = warp_sum(d * d * sw) is one shuffle reduction and needs no
//   scratch in shared memory.
// - Problems are visited in the caller's `order`: by limit, largest first
//   (stable).  So the problems still running form a prefix of every tile,
//   stopped problems gather in the last tiles, and only one tile is ragged.
//   A prefix of n problems runs the n-wide member loop (n = 1 .. JB, one
//   instantiation each): nothing is computed for a stopped problem, and no
//   tile falls back to one problem at a time.
// - The left-out rows are run-time values, so the member loop is split at
//   the running problems' own [min leave, max leave]: no test before and
//   after it; inside, a problem's left-out member adds an exact 0.0f by a
//   select.  That is right for any `leave` (repeated, descending, or out of
//   [0, n_real), which leaves nothing out) and narrow where `leave` ascends
//   with the problem index, as on the z-score path.  Members are summed in
//   ascending order, as the plain twin does.
// - ft is updated in place, as in loo_chunk.cu: each element is read once
//   (by __ldg), by the one thread that later writes it, before that write,
//   and never read again in the launch.  A stopped problem is not written
//   and its sw is not read, and a block in which every limit is 0 returns
//   before it stages its tile.
// - Each warp's lane 0 writes its problems' sums into sq_part[block, B];
//   em_decide.cu sums the blocks in one fixed order.  No float atomics: the
//   convergence decision reads these sums.
#include "common.cuh"

namespace {

constexpr int JB = 4;  // ops/zloo_chunk.py::ZLOO_PROBLEM_TILE

// One update of the first NB problems of a tile (lv: their left-out rows,
// each in [0, n_real], n_real leaving nothing out).
template <bool FAST, int NB, bool STAGED>
__device__ __forceinline__ void zloo_update(
    const float* __restrict__ sg0, const float* __restrict__ sg1,
    long long ld, int n_real, float inv, bool real, const int (&lv)[JB],
    float (&f)[JB], float (&d)[JB]) {
  int j[NB];
  float fq[NB], acc[NB];
  int m0 = n_real, m1 = 0;
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    j[q] = lv[q];
    fq[q] = f[q];
    acc[q] = 0.0f;
    m0 = min(m0, j[q]);
    m1 = max(m1, j[q] + 1);
  }
  m1 = max(min(m1, n_real), m0);
  loo_members<FAST, NB, false, STAGED>(sg0, sg1, 0, m0, j, fq, acc, ld);
  loo_members<FAST, NB, true, STAGED>(sg0, sg1, m0, m1, j, fq, acc, ld);
  loo_members<FAST, NB, false, STAGED>(sg0, sg1, m1, n_real, j, fq, acc, ld);
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const float f_new = em_clip(acc[q] * inv);
    d[q] = real ? f_new - fq[q] : 0.0f;
    f[q] = f_new;
  }
}

// The update of a running prefix of n_run problems, 1 <= n_run <= NB.
template <bool FAST, int NB, bool STAGED>
__device__ __forceinline__ void zloo_update_prefix(
    int n_run, const float* __restrict__ sg0, const float* __restrict__ sg1,
    long long ld, int n_real, float inv, bool real, const int (&lv)[JB],
    float (&f)[JB], float (&d)[JB]) {
  if (n_run == NB) {
    zloo_update<FAST, NB, STAGED>(sg0, sg1, ld, n_real, inv, real, lv, f, d);
  } else if constexpr (NB > 1) {
    zloo_update_prefix<FAST, NB - 1, STAGED>(n_run, sg0, sg1, ld, n_real, inv,
                                             real, lv, f, d);
  }
}

template <bool FAST, bool STAGED>
__global__ void __launch_bounds__(256) zloo_chunk_kernel(
    const float* __restrict__ g0p, const float* __restrict__ g1p,
    float* ft, const float* __restrict__ sw,
    const int* __restrict__ leave, const int* __restrict__ order,
    const float* __restrict__ limits, float* __restrict__ sq_part, int B,
    int M, int n_real, int aligned) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long s0 = (long long)blockIdx.x * WG_TILE_SITES;
  const long long s = s0 + lane;
  const bool real = s < M;
  {
    int running = 0;
    for (int q = tid; q < B; q += blockDim.x) running |= limits[q] > 0.0f;
    if (!__syncthreads_or(running)) return;
  }

  // this lane's column of the member tile, and the distance between rows
  const float* sg0;
  const float* sg1;
  const long long ld = STAGED ? WG_TILE_SITES : M;
  if constexpr (STAGED) {
    extern __shared__ float4 smem4[];
    float* t0 = reinterpret_cast<float*>(smem4);  // [n_real][32]
    float* t1 = t0 + n_real * WG_TILE_SITES;      // [n_real][32]
    stage_member_tile(g0p, g1p, t0, t1, n_real, M, s0, aligned, lane, warp,
                      n_warps, real, s);
    __syncthreads();
    sg0 = t0 + lane;
    sg1 = t1 + lane;
  } else {
    const long long col = real ? s : (long long)M - 1;
    sg0 = g0p + col;
    sg1 = g1p + col;
  }

  const float inv = 1.0f / ((float)n_real - 1.0f);
  const int n_tiles = (B + JB - 1) / JB;
  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    int b[JB], lv[JB];
    float f[JB], lim[JB], w_site[JB];
#pragma unroll
    for (int q = 0; q < JB; ++q) {
      const bool valid = tile * JB + q < B;
      b[q] = valid ? __ldg(order + tile * JB + q) : -1;
      lim[q] = valid ? __ldg(limits + b[q]) : 0.0f;
      const int l = valid ? __ldg(leave + b[q]) : n_real;
      lv[q] = (l >= 0 && l < n_real) ? l : n_real;
      const bool load = valid && real;
      // the element's one read: this thread writes it below, after the
      // update, and nothing reads it again in this launch
      f[q] = load ? __ldg(ft + (long long)b[q] * M + s) : WG_EM_LO;
      w_site[q] = (load && lim[q] > 0.0f) ? sw[(long long)b[q] * M + s] : 0.0f;
    }

    // limits descend along `order`: the running problems are a prefix
    int n_run = 0;
#pragma unroll
    for (int q = 0; q < JB; ++q) n_run += lim[q] > 0.0f;
    float d[JB];
#pragma unroll
    for (int q = 0; q < JB; ++q) d[q] = 0.0f;
    if (n_run > 0) {
      zloo_update_prefix<FAST, JB, STAGED>(n_run, sg0, sg1, ld, n_real, inv,
                                           real, lv, f, d);
    }
#pragma unroll
    for (int q = 0; q < JB; ++q) {
      if (b[q] < 0) continue;
      const float v = (q < n_run) ? warp_sum(d[q] * d[q] * w_site[q]) : 0.0f;
      if (lane == 0) sq_part[(long long)blockIdx.x * B + b[q]] = v;
    }
#pragma unroll
    for (int q = 0; q < JB; ++q) {
      if (b[q] >= 0 && real && lim[q] > 0.0f) {
        ft[(long long)b[q] * M + s] = f[q];  // after its one read, above
      }
    }
  }
}

using ZlooKernel = void (*)(const float*, const float*, float*, const float*,
                            const int*, const int*, const float*, float*,
                            int, int, int, int);

// smem_bytes == 0 asks for the kernel that stages nothing.
ZlooKernel zloo_kernel(int fast_math, int smem_bytes) {
  if (smem_bytes > 0) {
    return fast_math ? zloo_chunk_kernel<true, true>
                     : zloo_chunk_kernel<false, true>;
  }
  return fast_math ? zloo_chunk_kernel<true, false>
                   : zloo_chunk_kernel<false, false>;
}

}  // namespace

// Launches on `stream` (ft updated in place); returns cudaGetLastError()
// (0 on success).
WG_EXPORT int wg_zloo_chunk(int device, const float* g0p, const float* g1p,
                            float* ft, const float* sw, const int* leave,
                            const int* order, const float* limits,
                            float* sq_part, int B, int M, int n_real,
                            int warps, int smem_bytes, int aligned,
                            int fast_math, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  ZlooKernel kern = zloo_kernel(fast_math, smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + WG_TILE_SITES - 1) / WG_TILE_SITES;
  kern<<<blocks, 32 * warps, smem_bytes, (cudaStream_t)stream>>>(
      g0p, g1p, ft, sw, leave, order, limits, sq_part, B, M, n_real, aligned);
  return (int)cudaGetLastError();
}

// Resident blocks per SM the runtime reports for this launch shape, or the
// negated CUDA error code.
WG_EXPORT int wg_zloo_chunk_occupancy(int device, int warps, int smem_bytes,
                                      int fast_math) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  ZlooKernel kern = zloo_kernel(fast_math, smem_bytes);
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      32 * warps, smem_bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

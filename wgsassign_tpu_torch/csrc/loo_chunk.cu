// One leave-one-out EM iteration for one population on the GPU, in place.
//
// Replaces: wgsassign_tpu/ops/pallas_emmaf.py::_loo_chunk_kernel (launched
// by loo_chunk_pallas), which fuses T iterations a launch.  Here each
// problem j whose limits[j] is above 0 takes one update
//     f_j <- clip(sum_{i != j, i < n_real} w(g_i, f_j) / (n_real - 1))
// and the kernel emits its squared update per block.  The EM driver launches
// it once an iteration and tests convergence on the device between launches
// (ops/fused_em.py::_drive_steps, em_decide.cu), so every problem stops at
// its own iteration and nothing is replayed.
//
// What bounds it on an H100: operations.  Per site each of the P problems
// sums n_real - 1 weights (15 float operations counting the divide as one)
// against 8 n_real bytes of GLs read once a launch.  The
// rounding contract (common.cuh: no fused multiply-add, IEEE divide) makes a
// weight ~23 issue slots, the divide alone ~10, so the float32 pipe is the
// limit long before memory.
//
// Design, and what each part is for:
// - A block owns LOO_SITES = 32 consecutive sites and stages their
//   [n_real, 32] tile of both member panels in shared memory once, with
//   16-byte cp.async where the rows are 16-byte aligned (no registers held
//   across the copy).  g2 = 1 - g0 - g1 is rebuilt in registers once per
//   member per pass (two adds shared by JB weights) rather than kept as a
//   third plane: that plane would cost half as much shared memory again and
//   lower the member bound for one shared load saved per JB weights.
// - A lane is a site; a warp is a tile of JB consecutive problems, and the
//   block's warps take the problem tiles round-robin.  So a thread carries
//   JB problems through the member loop at once: each (g0, g1, g2) read
//   feeds JB weights, and JB independent divide chains hide each other's
//   latency.  Every problem belongs to one warp only, so its squared update
//   needs one shuffle reduction and no scratch in shared memory.
// - The shared tile is 8 n_real bytes a site whatever the block's width, and
//   it is shared by all the block's warps: at n_real = 36 a block takes
//   9.2 KB, so the registers, not shared memory, set the occupancy: 36
//   warps (the one-thread-per-site kernel this replaces could hold 24).
//   The tile fits the 227 KB up to 908 members.
// - Above that (STAGED false, launched with no shared memory) nothing is
//   staged: a lane reads its column of the global panels row by row, in the
//   same order, so the sums round as the staged ones do.  A warp's read of a
//   member is one 128-byte line, reused by all the block's problem tiles
//   out of L1 and L2; between two reads lie JB weights of ~23
//   instruction slots each, which hide most of a load's latency.  Lanes
//   past M read the last site's column and contribute nothing.
// - The member loop is split at the tile's own members: outside
//   [j0, j0 + JB) no problem of the tile is left out, so the loop has no
//   test; inside, the left-out member adds an exact 0.0f by a select.
//   Members are summed in ascending order, as the plain twin does.
// - All limits in a tile are warp-uniform.  While every problem of the tile
//   runs the JB-wide loop runs; a tile with some problems stopped runs the
//   others one by one, and a stopped tile only writes zero sums.  Nothing
//   is computed for a stopped problem.
// - ft is updated in place.  Each (problem, site) element is read once, by
//   the one thread that later writes it, before that write, and never read
//   again in the launch: so the read may take the read-only path (__ldg;
//   that cache starts each launch empty).  A plain load of a pointer that is
//   also stored through cost 8 more registers and a spill on sm_90a.  A
//   stopped problem is not written, and a block in which every limit is 0
//   returns before it stages its tile: a launch after the last problem
//   stopped costs its launch (and leaves sq_part as it found it).
// - Each warp's lane 0 writes its problems' sums into sq_part[block, P];
//   em_decide.cu sums the blocks in one fixed order.  No float atomics: the
//   convergence decision reads these sums.
// - No persistent grid: 16 blocks of 2 warps are resident on an H100 SM at
//   n_real = 49 (58 registers a thread), so one block's staging (12.5 KB)
//   hides behind the others' arithmetic without a second buffer.
#include "common.cuh"

namespace {

constexpr int LOO_SITES = WG_TILE_SITES;  // ops/loo_chunk.py::LOO_SITES
constexpr int JB = 4;  // ops/loo_chunk.py::LOO_PROBLEM_TILE

template <bool FAST, bool STAGED>
__global__ void __launch_bounds__(256) loo_chunk_kernel(
    const float* __restrict__ g0p, const float* __restrict__ g1p,
    float* ft, const float* __restrict__ limits,
    float* __restrict__ sq_part, int P, int M, int n_real, int aligned) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long s0 = (long long)blockIdx.x * LOO_SITES;
  const long long s = s0 + lane;
  const bool real = s < M;
  {
    int running = 0;
    for (int j = tid; j < P; j += blockDim.x) running |= limits[j] > 0.0f;
    if (!__syncthreads_or(running)) return;
  }

  // this lane's column of the member tile, and the distance between rows
  const float* sg0;
  const float* sg1;
  const long long ld = STAGED ? LOO_SITES : M;
  if constexpr (STAGED) {
    extern __shared__ float4 smem4[];
    float* t0 = reinterpret_cast<float*>(smem4);  // [n_real][32]
    float* t1 = t0 + n_real * LOO_SITES;          // [n_real][32]
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
  const int n_tiles = (P + JB - 1) / JB;
  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    const int j0 = tile * JB;
    int j[JB];
    float f[JB], lim[JB];
#pragma unroll
    for (int q = 0; q < JB; ++q) {
      j[q] = j0 + q;
      const bool valid = j[q] < P;
      lim[q] = valid ? __ldg(limits + j[q]) : 0.0f;
      // the element's one read: this thread writes it below, after the
      // update, and nothing reads it again in this launch
      f[q] = (valid && real) ? __ldg(ft + (long long)j[q] * M + s) : WG_EM_LO;
    }
    // the tile's own members, clamped to the real ones
    const int m0 = min(j0, n_real);
    const int m1 = min(j0 + JB, n_real);

    int n_act = 0;
#pragma unroll
    for (int q = 0; q < JB; ++q) n_act += lim[q] > 0.0f;
    float d[JB];
#pragma unroll
    for (int q = 0; q < JB; ++q) d[q] = 0.0f;

    if (n_act == JB) {
      float acc[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) acc[q] = 0.0f;
      loo_members<FAST, JB, false, STAGED>(sg0, sg1, 0, m0, j, f, acc, ld);
      loo_members<FAST, JB, true, STAGED>(sg0, sg1, m0, m1, j, f, acc, ld);
      loo_members<FAST, JB, false, STAGED>(sg0, sg1, m1, n_real, j, f, acc,
                                           ld);
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const float f_new = em_clip(acc[q] * inv);
        d[q] = real ? f_new - f[q] : 0.0f;
        f[q] = f_new;
      }
    } else if (n_act > 0) {
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        if (!(lim[q] > 0.0f)) continue;
        const int j1[1] = {j[q]};
        const float f1[1] = {f[q]};
        float acc1[1] = {0.0f};
        const int own = min(j[q], n_real);
        loo_members<FAST, 1, false, STAGED>(sg0, sg1, 0, own, j1, f1, acc1,
                                            ld);
        loo_members<FAST, 1, false, STAGED>(sg0, sg1, min(own + 1, n_real),
                                            n_real, j1, f1, acc1, ld);
        const float f_new = em_clip(acc1[0] * inv);
        d[q] = real ? f_new - f[q] : 0.0f;
        f[q] = f_new;
      }
    }

#pragma unroll
    for (int q = 0; q < JB; ++q) {
      if (j[q] >= P) continue;
      const float v = (lim[q] > 0.0f) ? warp_sum(d[q] * d[q]) : 0.0f;
      if (lane == 0) {
        sq_part[(long long)blockIdx.x * P + j[q]] = v;
      }
    }
#pragma unroll
    for (int q = 0; q < JB; ++q) {
      if (j[q] < P && real && lim[q] > 0.0f) {
        ft[(long long)j[q] * M + s] = f[q];  // after its one read, above
      }
    }
  }
}

using LooKernel = void (*)(const float*, const float*, float*, const float*,
                           float*, int, int, int, int);

// smem_bytes == 0 asks for the kernel that stages nothing.
LooKernel loo_kernel(int fast_math, int smem_bytes) {
  if (smem_bytes > 0) {
    return fast_math ? loo_chunk_kernel<true, true>
                     : loo_chunk_kernel<false, true>;
  }
  return fast_math ? loo_chunk_kernel<true, false>
                   : loo_chunk_kernel<false, false>;
}

}  // namespace

// Launches on `stream` (ft updated in place); returns cudaGetLastError()
// (0 on success).
WG_EXPORT int wg_loo_chunk(int device, const float* g0p, const float* g1p,
                           float* ft, const float* limits, float* sq_part,
                           int P, int M, int n_real, int warps,
                           int smem_bytes, int aligned, int fast_math,
                           void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  LooKernel kern = loo_kernel(fast_math, smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + LOO_SITES - 1) / LOO_SITES;
  kern<<<blocks, 32 * warps, smem_bytes, (cudaStream_t)stream>>>(
      g0p, g1p, ft, limits, sq_part, P, M, n_real, aligned);
  return (int)cudaGetLastError();
}

// Resident blocks per SM the runtime reports for this launch shape, or the
// negated CUDA error code.
WG_EXPORT int wg_loo_chunk_occupancy(int device, int warps, int smem_bytes,
                                     int fast_math) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  LooKernel kern = loo_kernel(fast_math, smem_bytes);
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      32 * warps, smem_bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

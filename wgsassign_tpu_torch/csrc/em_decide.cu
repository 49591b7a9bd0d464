// The leave-one-out EMs' convergence test, on the device, after every
// iteration (ops/em_decide.py::Convergence).
//
// Replaces: none.  The JAX package (and ops/fused_em.py::_drive_chunks,
// which stays for em_chunk and sites_chunk) fetches each chunk's squared
// updates and tests them with numpy on the host.  The LOO EMs
// (loo_chunk.cu, zloo_chunk.cu) run one iteration a launch instead, and
// two launches of this file after each take the host's place: for each
// running problem p
//     sq   = (float)(sum over the chunk kernel's blocks of sq_part[., p],
//                    in float64, in one fixed order)
//     rmse = sqrt(max(sq, 0) / m_real[p])          (float64, NaN kept)
// and where rmse < tol it records iters[p] = it + 1 and sets limits[p] to
// 0, which stops the problem from the next launch on.  That is the host's
// arithmetic to the bit: numpy's maximum keeps a NaN, float32 -> float64
// is exact, and the divide and sqrt are IEEE-rounded (no --use_fast_math).
// The first launch (SUM) writes sq[p]; between the two the caller sums sq
// over the ranks where there are several (all-reduce on the device); the
// second (TEST) tests.  TEST also keeps stats: stats[0] adds the problems
// that ran this iteration, stats[1] counts a launch in which none ran (a
// tail launch), stats[2] is the problems still running: the host reads it
// a few iterations late, from pinned memory.
//
// What bounds it on an H100: bytes, one read of sq_part (4 B a block and
// running problem: 30 MB for 49 problems over 5M sites, ~9 us at
// 3.35 TB/s).  Design:
// - SUM: up to 256 blocks (ops/em_decide.py::DECIDE_BLOCKS) each own a run
//   of the partials' rows.  A thread owns one column (problem) and every
//   rows_at_once-th row of the run, so consecutive threads read consecutive
//   floats; it sums in float64, and the column's first thread adds the
//   rows_at_once sums in order into partial[block, p].  The order depends
//   on the rows, P and the grid only, never on timing.
// - The block that finishes last (a ticket taken after a __threadfence)
//   adds partial[., p] over the blocks in order and writes sq[p].  No float
//   atomics.
// - A column whose problem has stopped is not read, and its sq[p] is 0, so
//   a sum over the ranks adds only defined values.
// - TEST is one block, a thread a problem (P is a population's size).
#include "common.cuh"

namespace {

constexpr int DECIDE_THREADS = 256;
constexpr int DECIDE_SUM = 1, DECIDE_TEST = 2;  // ops/em_decide.py

__global__ void __launch_bounds__(DECIDE_THREADS) em_decide_sum_kernel(
    const float* __restrict__ sq_part, long long n_rows, int P,
    double* __restrict__ partial, unsigned int* __restrict__ ticket,
    float* __restrict__ sq, const float* __restrict__ limits) {
  const int tid = threadIdx.x;
  __shared__ double red[DECIDE_THREADS];
  __shared__ int last;

  const long long per = (n_rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = min(n_rows, r0 + per);
  const int cols = min(P, DECIDE_THREADS);
  const int rows_at_once = DECIDE_THREADS / cols;
  const int y = tid / cols;
  for (int c0 = 0; c0 < P; c0 += cols) {
    const int p = c0 + tid % cols;
    double acc = 0.0;
    if (y < rows_at_once && p < P && limits[p] > 0.0f) {
#pragma unroll 4
      for (long long r = r0 + y; r < r1; r += rows_at_once) {
        acc += (double)sq_part[r * P + p];
      }
    }
    red[tid] = acc;
    __syncthreads();
    if (y == 0 && p < P) {
      double s = 0.0;
      for (int yy = 0; yy < rows_at_once; ++yy) s += red[yy * cols + tid];
      partial[(long long)blockIdx.x * P + p] = s;
    }
    __syncthreads();
  }
  // publish this block's sums, then take a ticket: the last block sees
  // every block's partials
  __threadfence();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int p = tid; p < P; p += blockDim.x) {
    double s = 0.0;
    if (limits[p] > 0.0f) {
      for (unsigned g = 0; g < gridDim.x; ++g) {
        s += __ldcg(partial + (long long)g * P + p);
      }
    }
    sq[p] = (float)s;
  }
  if (tid == 0) *ticket = 0u;  // ready for the next launch
}

__global__ void __launch_bounds__(DECIDE_THREADS) em_decide_test_kernel(
    const float* __restrict__ sq, int P, const double* __restrict__ m_real,
    double tol, int it, float* __restrict__ limits, int* __restrict__ iters,
    long long* __restrict__ stats) {
  const int tid = threadIdx.x;
  __shared__ int n_ran, n_left;
  if (tid == 0) n_ran = n_left = 0;
  __syncthreads();
  for (int p = tid; p < P; p += blockDim.x) {
    if (!(limits[p] > 0.0f)) continue;
    atomicAdd(&n_ran, 1);
    double v = (double)sq[p];
    if (!isnan(v)) v = fmax(v, 0.0);
    if (sqrt(v / m_real[p]) < tol) {
      iters[p] = it + 1;
      limits[p] = 0.0f;
    } else {
      atomicAdd(&n_left, 1);
    }
  }
  __syncthreads();
  if (tid == 0) {
    stats[0] += n_ran;
    stats[1] += n_ran == 0;
    stats[2] = n_left;
  }
}

}  // namespace

// mode DECIDE_SUM: `blocks` blocks sum sq_part[n_rows, P] into sq[P];
// mode DECIDE_TEST: one block tests sq.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
WG_EXPORT int wg_em_decide(int device, const float* sq_part, long long n_rows,
                           int P, double* partial, unsigned int* ticket,
                           float* sq, const double* m_real, double tol,
                           int it, float* limits, int* iters,
                           long long* stats, int mode, int blocks,
                           void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == DECIDE_SUM) {
    em_decide_sum_kernel<<<blocks, DECIDE_THREADS, 0, st>>>(
        sq_part, n_rows, P, partial, ticket, sq, limits);
  } else if (mode == DECIDE_TEST) {
    em_decide_test_kernel<<<1, DECIDE_THREADS, 0, st>>>(
        sq, P, m_real, tol, it, limits, iters, stats);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

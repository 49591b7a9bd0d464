// The assignment likelihood pass: selected per-site log-likelihood sums.
//
// Replaces no TPU kernel: the JAX package's ops/loglik.py is jnp code that
// XLA fuses into its site reduction.  The port's plain form
// (ops/loglik.py::_selected_sums, kept as this kernel's twin) builds
// [block, K, M] float32 temporaries and makes ~10 passes over them; this
// kernel reads each input once.  It computes
//     part[b, r, q] = sum over the sites s this thread of block b takes of
//                     (AccT)(logf(like(g0[s, i], g1[s, i], a)) * w[s])
//     like = g0 (1-a)(1-a) + g1 2 a (1-a) + (1 - g0 - g1) a a,
//     a = bank[col_idx[q], s],  pair q = i * Ks + k,
// and a second kernel adds the partials of each (pair, partition) in a
// fixed order into out[q, p] (out is [N, Ks, P]).
//
// Rounding contract (common.cuh: -fmad=false, no --use_fast_math): each term
// is formed in float32 in the order ops/loglik.py::site_like writes it,
// (g0*oma)*oma + ((g1*2)*a)*oma + (((1-g0)-g1)*a)*a, the log is the
// full-precision logf, the weight product is a float32 multiply, and only
// then is the term widened to AccT (double, or float for --f32_sums) and
// added.  So every term is bit-equal to the twin's; only the order of the
// sum differs.  No atomics: equal inputs give bit-identical sums.
//
// What bounds it on an H100: bytes where the individuals take one AF
// column each (the leave-one-out pass at 180 individuals reads 8 N + 4 C + 4
// bytes a site for N terms: 7.2 GB of GL planes a column), and the issue
// rate where each takes K columns (assignment at N = 34, K = 5: 296 bytes
// for 170 terms a site, each ~40 instructions with the full logf).  So the
// design reads each byte once, at full width, keeps many bytes in flight
// without holding registers for them, and spends few instructions a term
// beside the term's own:
// - A block walks tiles of S consecutive sites (persistent blocks:
//   gridDim.x of them, what the card holds at once divided by gridDim.y).
//   Everything a tile needs is copied into shared memory by cp.async,
//   double-buffered, so the next tile's copies are in flight while this
//   tile's terms are formed: the GL rows of the block's individuals (with
//   all individuals in one block the tile is one contiguous S * N span of
//   each plane, copied 16 bytes at a time), the weights, and the [C, S]
//   bank rows, S + 4 floats apart, which keeps the copies aligned and puts
//   eight consecutive bank rows in distinct banks.  Read straight from
//   global memory into registers, the GLs kept about one site's loads in
//   flight a warp: 1.1-1.3 terms a clock an SM on an H100, bound by the
//   memory's latency.
// - A block is R rows x W pairs of threads (ops/loglik.py::loglik_geometry
//   picks them and S).  Thread (r, w) owns pair q = blockIdx.y * W + w and,
//   in every tile, the sites r, r + R, r + 2R, ...  R and S are multiples
//   of P, so a thread's sites all lie in partition r % P, and it keeps one
//   AccT accumulator in a register for the whole launch.  Consecutive
//   threads own consecutive pairs, pairs are individual-major, so a warp's
//   shared-memory GL reads at one site are consecutive words (the K lanes
//   of one individual share one).
// - BANK_STAGED false (a mini-bank too large to stage beside a GL tile):
//   each thread reads its own bank row from global memory at the same
//   sites, in the same order; the row's sectors are reused from L1 across
//   a thread's next sites.
// - Sites past M are neither copied nor read.  A bank row index outside
//   [0, C) is not read either: that pair's sum is NaN.
// - The second kernel gives each (pair, partition) one warp: lane l adds
//   the partials l, l + 32, ... in ascending (block, row) order, then a
//   butterfly adds the 32 lanes.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int ROW_PAD = 4;  // ops/loglik.py::LOGLIK_ROW_PAD

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The float32 term of one (site, individual, AF), in the twin's order.
__device__ __forceinline__ float site_term(float g0, float g1, float a,
                                           float w) {
  const float oma = 1.0f - a;
  const float like =
      g0 * oma * oma + g1 * 2.0f * a * oma + (1.0f - g0 - g1) * a * a;
  return logf(like) * w;
}

template <typename T>
__device__ __forceinline__ T warp_sum_t(T v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// One tile's copies into one buffer, committed as one group: the GL rows
// [s0, s0 + S) of individuals [i_lo, i_lo + nbk) of both planes into
// sg0 / sg1 ([S][nb]), the weights into sws ([S]) and, if staged, the bank
// rows into sbank ([C][S + ROW_PAD]).  Sites past M are not copied.
// aligned: bit 0, the GL planes and the weights start 16-byte aligned;
// bit 1, every bank row does (M % 4 == 0 too).
template <bool BANK_STAGED>
__device__ __forceinline__ void stage_tile(
    const float* __restrict__ g0, const float* __restrict__ g1,
    const float* __restrict__ bank, const float* __restrict__ sw, float* sg0,
    float* sg1, float* sbank, float* sws, int M, int N, int C, long long s0,
    int S, int i_lo, int nbk, int nb, int aligned) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int s_eff = (int)min((long long)S, (long long)M - s0);
  if (nbk == N) {
    // the tile is one contiguous span of each plane, laid out as [S][N]
    const long long base = s0 * N;
    const int count = s_eff * N;
    int done = 0;
    if (aligned & 1) {
      const int n4 = count / 4;
      for (int e = tid; e < 2 * n4; e += nthr) {
        const int plane = e >= n4;
        const int e4 = (e - plane * n4) * 4;
        cp_async_16((plane ? sg1 : sg0) + e4, (plane ? g1 : g0) + base + e4);
      }
      done = 4 * n4;
    }
    for (int e = done + tid; e < count; e += nthr) {
      cp_async_4(sg0 + e, g0 + base + e);
      cp_async_4(sg1 + e, g1 + base + e);
    }
  } else {
    for (int e = tid; e < s_eff * nbk; e += nthr) {
      const int sl = e / nbk;
      const int ii = e - sl * nbk;
      const long long src = (s0 + sl) * N + i_lo + ii;
      cp_async_4(sg0 + sl * nb + ii, g0 + src);
      cp_async_4(sg1 + sl * nb + ii, g1 + src);
    }
  }
  if ((aligned & 1) && s_eff == S) {
    for (int e = tid; e < S / 4; e += nthr) {
      cp_async_16(sws + 4 * e, sw + s0 + 4 * e);
    }
  } else {
    for (int e = tid; e < s_eff; e += nthr) cp_async_4(sws + e, sw + s0 + e);
  }
  if constexpr (BANK_STAGED) {
    const int pitch = S + ROW_PAD;
    if ((aligned & 2) && s_eff == S) {
      const int per_row = S / 4;
      for (int e = tid; e < C * per_row; e += nthr) {
        const int c = e / per_row;
        const int c4 = (e - c * per_row) * 4;
        cp_async_16(sbank + c * pitch + c4,
                    bank + (long long)c * M + s0 + c4);
      }
    } else {
      for (int e = tid; e < C * S; e += nthr) {
        const int c = e / S;
        const int sl = e - c * S;
        if (sl < s_eff) {
          cp_async_4(sbank + c * pitch + sl,
                     bank + (long long)c * M + s0 + sl);
        }
      }
    }
  }
  cp_async_commit();
}

// At most LOGLIK_MAX_THREADS (ops/loglik.py) a block, and registers for
// two such blocks an SM.
template <typename AccT, bool BANK_STAGED>
__global__ void __launch_bounds__(768, 2) loglik_kernel(
    const float* __restrict__ g0, const float* __restrict__ g1,
    const float* __restrict__ bank, const int* __restrict__ col_idx,
    const float* __restrict__ sw, AccT* __restrict__ part, int M, int N,
    int Ks, int C, int R, int W, int S, int nb, int aligned) {
  const int t = threadIdx.x;
  const int r = t / W;
  const int Q = N * Ks;
  const int q_lo = blockIdx.y * W;
  const int q = q_lo + (t - r * W);
  const bool active = q < Q;
  // the block's individuals: [i_lo, i_lo + nbk), nbk <= nb
  const int i_lo = q_lo / Ks;
  const int nbk = (min(q_lo + W, Q) - 1) / Ks - i_lo + 1;
  const int ii = active ? q / Ks - i_lo : 0;
  int c = active ? col_idx[q] : 0;
  const bool bad = c < 0 || c >= C;
  if (bad) c = 0;
  AccT acc = bad ? (AccT)NAN : (AccT)0;

  // one buffer: sg0 [S][nb], sg1 [S][nb], sws [S], sbank [C][S + ROW_PAD]
  const int pitch = S + ROW_PAD;
  const int buf_floats = 2 * S * nb + S + (BANK_STAGED ? C * pitch : 0);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* arow = bank + (long long)c * M;  // unstaged: this pair's row

  const int n_tiles = (M + S - 1) / S;
  auto stage = [&](int tile, int b) {
    float* base = smem + b * buf_floats;
    stage_tile<BANK_STAGED>(g0, g1, bank, sw, base, base + S * nb,
                            base + 2 * S * nb + S, base + 2 * S * nb, M, N, C,
                            (long long)tile * S, S, i_lo, nbk, nb, aligned);
  };
  int tile = blockIdx.x;
  if (tile < n_tiles) stage(tile, 0);
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      stage(next, (it + 1) & 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    if (active) {
      const long long s0 = (long long)tile * S;
      const int s_eff = (int)min((long long)S, (long long)M - s0);
      const float* base = smem + (it & 1) * buf_floats;
      // this thread's first site of the tile in each staged array
      const float* p0 = base + r * nb + ii;
      const float* p1 = p0 + S * nb;
      const float* pw = base + 2 * S * nb + r;
      const float* pa = BANK_STAGED ? pw + S + c * pitch : arow + s0 + r;
      const int step = R * nb;
#pragma unroll 2
      for (int sl = r; sl < s_eff; sl += R) {
        const float a = BANK_STAGED ? *pa : __ldg(pa);
        acc += (AccT)site_term(*p0, *p1, a, *pw);
        p0 += step;
        p1 += step;
        pw += R;
        pa += R;
      }
    }
    __syncthreads();  // this buffer is refilled in the next iteration
  }
  if (active) {
    part[((long long)blockIdx.x * R + r) * Q + q] = acc;
  }
}

// out[q * P + p] = sum over blocks b and rows r = p, p + P, ... of
// part[b, r, q]; one warp an output.
template <typename AccT>
__global__ void __launch_bounds__(256) loglik_reduce_kernel(
    const AccT* __restrict__ part, AccT* __restrict__ out, int Q, int P,
    int R, int n_blocks) {
  const int lane = threadIdx.x & 31;
  const long long o = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (o >= (long long)Q * P) return;
  const int q = (int)(o / P);
  const int p = (int)(o - (long long)q * P);
  const int per = R / P;
  const long long n_items = (long long)n_blocks * per;
  AccT v = (AccT)0;
  for (long long e = lane; e < n_items; e += 32) {
    const long long b = e / per;
    const int r = p + P * (int)(e - b * per);
    v += part[(b * R + r) * Q + q];
  }
  v = warp_sum_t(v);
  if (lane == 0) out[o] = v;
}

template <typename AccT>
using LoglikKernel = void (*)(const float*, const float*, const float*,
                              const int*, const float*, AccT*, int, int, int,
                              int, int, int, int, int, int);

template <typename AccT>
LoglikKernel<AccT> loglik_kernel_for(int bank_staged) {
  return bank_staged ? loglik_kernel<AccT, true> : loglik_kernel<AccT, false>;
}

template <typename AccT>
int launch_loglik(const float* g0, const float* g1, const float* bank,
                  const int* col_idx, const float* sw, void* part, void* out,
                  int M, int N, int Ks, int C, int P, int R, int W, int S,
                  int nb, int grid_x, int grid_y, int smem_bytes,
                  int bank_staged, int aligned, cudaStream_t stream) {
  LoglikKernel<AccT> kern = loglik_kernel_for<AccT>(bank_staged);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(grid_x, grid_y), R * W, smem_bytes, stream>>>(
      g0, g1, bank, col_idx, sw, static_cast<AccT*>(part), M, N, Ks, C, R, W,
      S, nb, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long warps = (long long)N * Ks * P;
  const int blocks = (int)((warps + 7) / 8);
  loglik_reduce_kernel<AccT><<<blocks, 256, 0, stream>>>(
      static_cast<const AccT*>(part), static_cast<AccT*>(out), N * Ks, P, R,
      grid_x);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int occupancy(Kernel kern, int threads, int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      smem_bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// Both kernels on `stream`: the partials into part ([grid_x, R, N * Ks] of
// AccT), then their sums into out ([N, Ks, P] of AccT); AccT is double when
// f64, else float.  Returns cudaGetLastError() (0 on success).
WG_EXPORT int wg_loglik(int device, const float* g0, const float* g1,
                        const float* bank, const int* col_idx,
                        const float* sw, void* part, void* out, int M, int N,
                        int Ks, int C, int P, int R, int W, int S, int nb,
                        int grid_x, int grid_y, int smem_bytes,
                        int bank_staged, int aligned, int f64, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    return launch_loglik<double>(g0, g1, bank, col_idx, sw, part, out, M, N,
                                 Ks, C, P, R, W, S, nb, grid_x, grid_y,
                                 smem_bytes, bank_staged, aligned, st);
  }
  return launch_loglik<float>(g0, g1, bank, col_idx, sw, part, out, M, N, Ks,
                              C, P, R, W, S, nb, grid_x, grid_y, smem_bytes,
                              bank_staged, aligned, st);
}

// Resident blocks per SM the runtime reports for a block of `threads`
// threads with `smem_bytes` of shared memory (the staged-bank kernel; the
// other uses as many registers), or the negated CUDA error.
WG_EXPORT int wg_loglik_occupancy(int device, int threads, int smem_bytes,
                                  int f64) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  return f64 ? occupancy(loglik_kernel_for<double>(1), threads, smem_bytes)
             : occupancy(loglik_kernel_for<float>(1), threads, smem_bytes);
}

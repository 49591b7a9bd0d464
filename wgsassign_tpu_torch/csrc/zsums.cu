// The three z sums of a group of individuals, on the card.
//
// Replaces no TPU kernel: the JAX package's ops/zscore_ops.py is jnp code
// that XLA fuses on the TPU.  The port's plain form
// (ops/zscore_ops.py::kept_slot_sums_twin, kept as this kernel's twin)
// gathers each block's kept-site GLs, depths and AF into [B, S] temporaries
// and makes C split passes over the whole padded block; this kernel reads
// each kept slot once and loops over that slot's own splits only.  For
// individual b of the group (cohort column col0 + b) and each kept slot
// s < s_local[b], with site k = keep[b * ldk + s], AF a = af[b, s], depth
// D = ad[k, col, 0] + ad[k, col, 1] and the prior
//     p0 = (1-a)(1-a),  p1 = (2 (1-a)) a,  p2 = a a,
// it forms, for the splits x = 0..D of depth D (combo row
// row = rows_by_depth[b, D, x]),
//     lg_x  = logf(mean_gl[row] . p),  wt_x = read_probs[row] . p,
//     w_obs = logf(g0 p0 + g1 p1 + ((1 - g0) - g1) p2),
//     w_mu  = sum_x lg_x wt_x,  w_var = sum_x (w_mu - lg_x)^2 wt_x,
// each in float32 and in the twin's order (the splits in ascending x), and
// adds the three per-slot terms in AccT (double, or float for --f32_sums):
//     part[y, b, :] = sum over the slots of chunk y of (w_obs, w_mu, w_var).
// A second kernel adds each (individual, sum)'s partials over the chunks in
// a fixed order into out[3, G].
//
// Rounding contract (common.cuh: -fmad=false, no --use_fast_math): every
// product and sum rounds once, in the order the twin writes it, and logf is
// the full-precision log, so each slot's three float32 terms equal the
// twin's bit for bit (the twin's masked splits add exact zeros).  Only the
// order of the AccT sums differs.  No atomics: equal inputs give
// bit-identical sums.
//
// What bounds it on an H100: the bytes of one read of the kept slots (8 B
// of keep, 4 B of AF, 4 + 4 B of GLs and two depth counts a slot, 22 B at
// uint8 depths) and the issue of ~1 + D + 1 logf a slot.  The design:
// - The grid is (individual b, chunk y of slots): blockIdx.x runs fastest,
//   so the group's individuals at one chunk are resident together and read
//   neighbouring [site, col0 .. col0 + G) GL and depth bytes, which L2
//   serves once from device memory for all of them.
// - Slots at or past s_local[b] are never visited: a chunk past an
//   individual's kept count only writes a zero partial.
// - The block's tables (rows_by_depth [C, C], mean_gl and read_probs
//   [R, 3]) are staged in shared memory when they fit the launch's
//   smem_bytes (ops/zscore_ops.py::zsums_geometry), else read from global
//   memory, where L1 keeps them.
// - lg_x and wt_x stay in registers between the mean and the variance
//   passes: a fully unrolled loop of CMAX = 16 splits (C <= 16), broken
//   off past the slot's depth.  Above 16 splits the variance pass forms
//   lg_x and wt_x again, bit for bit the same.
// - A combo row outside [0, R) or a depth outside [0, C) is not read: that
//   slot's w_mu and w_var are NaN.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // ops/zscore_ops.py::ZSUMS_THREADS
constexpr int WARPS = THREADS / 32;

template <typename T>
__device__ __forceinline__ T warp_sum_t(T v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// lg and wt of combo row `row` under the prior (p0, p1, p2); a row outside
// [0, R) gives NaN.
__device__ __forceinline__ void split_terms(const float* mg, const float* rp,
                                            int row, int R, float p0,
                                            float p1, float p2, float& lg,
                                            float& wt) {
  const bool ok = row >= 0 && row < R;
  const float* m = mg + 3 * (ok ? row : 0);
  const float* r = rp + 3 * (ok ? row : 0);
  lg = ok ? logf(m[0] * p0 + m[1] * p1 + m[2] * p2) : NAN;
  wt = r[0] * p0 + r[1] * p1 + r[2] * p2;
}

// w_mu and w_var of one slot of depth d (d < 0: none, as for a depth
// outside [0, C)); rows are the combo rows of depth d's splits.
template <int CMAX>
__device__ __forceinline__ void slot_moments(const int* rows,
                                             const float* mg,
                                             const float* rp, int d, int R,
                                             float p0, float p1, float p2,
                                             float& mu, float& var) {
  mu = 0.0f;
  var = 0.0f;
  if constexpr (CMAX > 0) {
    float lg[CMAX], wt[CMAX];
#pragma unroll
    for (int x = 0; x < CMAX; ++x) {
      if (x > d) break;
      split_terms(mg, rp, rows[x], R, p0, p1, p2, lg[x], wt[x]);
      mu = mu + lg[x] * wt[x];
    }
#pragma unroll
    for (int x = 0; x < CMAX; ++x) {
      if (x > d) break;
      const float dv = mu - lg[x];
      var = var + dv * dv * wt[x];
    }
  } else {
    for (int x = 0; x <= d; ++x) {
      float lg, wt;
      split_terms(mg, rp, rows[x], R, p0, p1, p2, lg, wt);
      mu = mu + lg * wt;
    }
    for (int x = 0; x <= d; ++x) {
      float lg, wt;
      split_terms(mg, rp, rows[x], R, p0, p1, p2, lg, wt);
      const float dv = mu - lg;
      var = var + dv * dv * wt;
    }
  }
}

template <typename T, typename AccT, int CMAX>
__global__ void __launch_bounds__(THREADS) zsums_kernel(
    const float* __restrict__ g0, const float* __restrict__ g1,
    const T* __restrict__ ad, const long long* __restrict__ keep,
    const float* __restrict__ af, const int* __restrict__ s_local,
    const int* __restrict__ rbd, const float* __restrict__ mgl,
    const float* __restrict__ rpr, AccT* __restrict__ part, int N, int col0,
    int G, long long S, long long ldk, int C, int R, long long chunk,
    int staged) {
  __shared__ AccT red[WARPS][3];
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const long long lo = (long long)blockIdx.y * chunk;
  const long long hi = min(lo + chunk, min((long long)s_local[b], S));
  const int* trbd = rbd + (long long)b * C * C;
  const float* tmg = mgl + (long long)b * R * 3;
  const float* trp = rpr + (long long)b * R * 3;
  if (staged && lo < hi) {
    int* srbd = reinterpret_cast<int*>(smem4);
    float* smg = reinterpret_cast<float*>(srbd + C * C);
    float* srp = smg + 3 * R;
    for (int e = threadIdx.x; e < C * C; e += THREADS) srbd[e] = trbd[e];
    for (int e = threadIdx.x; e < 3 * R; e += THREADS) {
      smg[e] = tmg[e];
      srp[e] = trp[e];
    }
    __syncthreads();
    trbd = srbd;
    tmg = smg;
    trp = srp;
  }
  AccT s_obs = (AccT)0, s_mu = (AccT)0, s_var = (AccT)0;
  const int col = col0 + b;
  const long long* kp = keep + (long long)b * ldk;
  const float* ap = af + (long long)b * S;
  for (long long s = lo + threadIdx.x; s < hi; s += THREADS) {
    const long long k = kp[s];
    const float a = ap[s];
    const float x0 = g0[k * N + col];
    const float x1 = g1[k * N + col];
    const T* dp = ad + k * 2 * N + 2 * col;
    const int d = (int)dp[0] + (int)dp[1];
    const float oma = 1.0f - a;
    const float p0 = oma * oma;
    const float p1 = 2.0f * oma * a;
    const float p2 = a * a;
    const float w_obs = logf(x0 * p0 + x1 * p1 + (1.0f - x0 - x1) * p2);
    const bool ok = d >= 0 && d < C;
    float mu, var;
    slot_moments<CMAX>(trbd + (ok ? d : 0) * C, tmg, trp, ok ? d : -1, R,
                       p0, p1, p2, mu, var);
    s_obs += (AccT)w_obs;
    s_mu += (AccT)(ok ? mu : NAN);
    s_var += (AccT)(ok ? var : NAN);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s_obs = warp_sum_t(s_obs);
  s_mu = warp_sum_t(s_mu);
  s_var = warp_sum_t(s_var);
  if (lane == 0) {
    red[warp][0] = s_obs;
    red[warp][1] = s_mu;
    red[warp][2] = s_var;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    AccT v = (AccT)0;
    for (int w = 0; w < WARPS; ++w) v += red[w][threadIdx.x];
    part[((long long)blockIdx.y * G + b) * 3 + threadIdx.x] = v;
  }
}

// out[j * G + b] = sum over chunks y of part[y, b, j]; one warp an output,
// lane l adding the chunks l, l + 32, ... in order, then a butterfly.
template <typename AccT>
__global__ void __launch_bounds__(256) zsums_reduce_kernel(
    const AccT* __restrict__ part, AccT* __restrict__ out, int G,
    int n_chunks) {
  const int lane = threadIdx.x & 31;
  const int o = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (o >= 3 * G) return;
  const int j = o / G;
  const int b = o - j * G;
  AccT v = (AccT)0;
  for (int y = lane; y < n_chunks; y += 32) {
    v += part[((long long)y * G + b) * 3 + j];
  }
  v = warp_sum_t(v);
  if (lane == 0) out[o] = v;
}

template <typename T, typename AccT>
using ZsumsKernel = void (*)(const float*, const float*, const T*,
                             const long long*, const float*, const int*,
                             const int*, const float*, const float*, AccT*,
                             int, int, int, long long, long long, int, int,
                             long long, int);

// cmax: 16 (ops/zscore_ops.py::ZSUMS_UNROLLED, the splits held in
// registers), else 0 (formed twice)
template <typename T, typename AccT>
ZsumsKernel<T, AccT> zsums_kernel_for(int cmax) {
  if (cmax == 16) return zsums_kernel<T, AccT, 16>;
  return zsums_kernel<T, AccT, 0>;
}

template <typename T, typename AccT>
int launch_zsums(const float* g0, const float* g1, const void* ad,
                 const long long* keep, const float* af, const int* s_local,
                 const int* rbd, const float* mg, const float* rp,
                 void* part, void* out, int N, int col0, int G, long long S,
                 long long ldk, int C, int R, long long chunk, int n_chunks,
                 int cmax, int smem_bytes, cudaStream_t stream) {
  ZsumsKernel<T, AccT> kern = zsums_kernel_for<T, AccT>(cmax);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(G, n_chunks), THREADS, smem_bytes, stream>>>(
      g0, g1, static_cast<const T*>(ad), keep, af, s_local, rbd, mg, rp,
      static_cast<AccT*>(part), N, col0, G, S, ldk, C, R, chunk,
      smem_bytes > 0 ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = 3 * G;
  zsums_reduce_kernel<AccT><<<(warps + 7) / 8, 256, 0, stream>>>(
      static_cast<const AccT*>(part), static_cast<AccT*>(out), G, n_chunks);
  return (int)cudaGetLastError();
}

template <typename AccT>
int launch_zsums_ad(int ad_type, const float* g0, const float* g1,
                    const void* ad, const long long* keep, const float* af,
                    const int* s_local, const int* rbd, const float* mg,
                    const float* rp, void* part, void* out, int N, int col0,
                    int G, long long S, long long ldk, int C, int R,
                    long long chunk, int n_chunks, int cmax, int smem_bytes,
                    cudaStream_t stream) {
  if (ad_type == 0)
    return launch_zsums<unsigned char, AccT>(
        g0, g1, ad, keep, af, s_local, rbd, mg, rp, part, out, N, col0, G, S,
        ldk, C, R, chunk, n_chunks, cmax, smem_bytes, stream);
  return launch_zsums<int, AccT>(g0, g1, ad, keep, af, s_local, rbd, mg, rp,
                                 part, out, N, col0, G, S, ldk, C, R, chunk,
                                 n_chunks, cmax, smem_bytes, stream);
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

// Both kernels on `stream`: the partials into part ([n_chunks, G, 3] of
// AccT), then their sums into out ([3, G] of AccT); AccT is double when
// f64, else float.  g0/g1 are [M, N] float32, ad [M, 2N] of uint8
// (ad_type 0) or int32 (1), keep [G, S] int64 with rows ldk apart (ldk >=
// S: the z-score driver's slot table has a spare column), af [G, S]
// float32, s_local
// [G] int32, rbd [G, C, C] int32, mg/rp [G, R, 3] float32; smem_bytes is 0
// (tables read from global memory) or their staged size.  Returns
// cudaGetLastError() (0 on success).
WG_EXPORT int wg_zsums(int device, const float* g0, const float* g1,
                       const void* ad, const long long* keep,
                       const float* af, const int* s_local, const int* rbd,
                       const float* mg, const float* rp, void* part,
                       void* out, int N, int col0, int G, long long S,
                       long long ldk, int C, int R, long long chunk,
                       int n_chunks, int cmax, int smem_bytes, int ad_type,
                       int f64, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return launch_zsums_ad<double>(ad_type, g0, g1, ad, keep, af, s_local,
                                   rbd, mg, rp, part, out, N, col0, G, S,
                                   ldk, C, R, chunk, n_chunks, cmax,
                                   smem_bytes, st);
  return launch_zsums_ad<float>(ad_type, g0, g1, ad, keep, af, s_local, rbd,
                                mg, rp, part, out, N, col0, G, S, ldk, C, R,
                                chunk, n_chunks, cmax, smem_bytes, st);
}

// Resident blocks per SM the runtime reports for the uint8-depth kernel of
// `cmax` splits in registers with `smem_bytes` of shared memory (the block
// is always ZSUMS_THREADS wide), or the negated CUDA error.
WG_EXPORT int wg_zsums_occupancy(int device, int cmax, int smem_bytes,
                                 int f64) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  return f64 ? occupancy(zsums_kernel_for<unsigned char, double>(cmax),
                         THREADS, smem_bytes)
             : occupancy(zsums_kernel_for<unsigned char, float>(cmax),
                         THREADS, smem_bytes);
}

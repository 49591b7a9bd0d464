// The z-score combo tables of a block of individuals, on the card.
//
// Replaces no TPU kernel: the JAX package builds these tables on the host
// (wgsassign_tpu/models/zscore.py::build_combo_tables, np.unique and
// np.bincount per individual).  Two kernels carry the two passes over the
// [M, N] cohort that the tables need; everything between them works on
// [B, R] tables and is plain PyTorch (ops/ztables.py, models/zscore.py).
//
// ztables_bin: for individual b (cohort column col0 + b) and each allele-
// depth combo code = Ar * W + Aa, the count of sites and the float64 sums of
// the float32 GL triple (g0, g1, g2 = (1 - g0) - g1), over the sites of one
// chunk:
//     part[c, b, code, :] = sum over sites s of chunk c with that code of
//                           (g0, g1, g2, 1)
// ztables_filter: with the reduced tables (keepc: the combo survived the
// combo and depth-class filters; amax: the GL entry where its mean is
// largest; meanv: that mean, float64), flags the kept sites
//     mask[b, s] = 1 where keepc[b, code] and |meanv[b, code] - g_amax| <= tol
// and counts them by total depth Ar + Aa, per chunk:
//     dcount[c, b, Ar + Aa] += 1.
//
// Determinism: thread (chunk c, individual b) owns part[c, b, :, :] and
// dcount[c, b, :] alone and adds its chunk's sites to them in site order,
// with no atomics; the chunks are added afterwards by a fixed reduction
// (torch.sum over the chunk axis).  So equal inputs give bit-identical
// tables, whatever the scheduling, and the plain twin (ops/ztables.py),
// which adds each chunk's sites in the same order, gives the same per-chunk
// partials.
//
// What bounds it on an H100: the bytes of one read of the individuals' GL
// columns and allele depths (8 + 2 sizeof(T) bytes a site and individual),
// and the latency of each thread's read-modify-write of its own bin, which
// depends on the previous site's.  The design keeps those chains short and
// many: lanes of a warp are consecutive individuals at the same site, so
// every GL and depth load is one coalesced row segment; the site axis is cut
// into as many chunks as the partial buffer's budget allows (ops/ztables.py
// picks it), each walked by one warp per 32 individuals.  A thread's bins
// stay in L1/L2: its R bins of 32 bytes each are its working set.
#include "common.cuh"

namespace {

constexpr int WARP = 32;
constexpr int CHUNKS_PER_BLOCK = 4;

template <typename T>
__global__ void ztables_bin_kernel(const T* __restrict__ ad,
                                   const float* __restrict__ g0,
                                   const float* __restrict__ g1,
                                   double* __restrict__ part, int N, int col0,
                                   int B, long long n_sites, int W,
                                   int n_chunks, long long chunk_sites) {
  const int b = blockIdx.y * WARP + threadIdx.x;
  const int c = blockIdx.x * CHUNKS_PER_BLOCK + threadIdx.y;
  if (b >= B || c >= n_chunks) return;
  const int col = col0 + b;
  const long long R = (long long)W * W;
  double* __restrict__ p = part + ((long long)c * B + b) * R * 4;
  const long long lo = (long long)c * chunk_sites;
  const long long hi = min(lo + chunk_sites, n_sites);
  for (long long s = lo; s < hi; ++s) {
    const int ar = (int)ad[s * 2 * N + 2 * col];
    const int aa = (int)ad[s * 2 * N + 2 * col + 1];
    const float a0 = g0[s * N + col];
    const float a1 = g1[s * N + col];
    if (ar < 0 || aa < 0 || ar >= W || aa >= W) continue;  // not reached
    const float a2 = (1.0f - a0) - a1;
    double* q = p + ((long long)ar * W + aa) * 4;
    q[0] += (double)a0;
    q[1] += (double)a1;
    q[2] += (double)a2;
    q[3] += 1.0;
  }
}

template <typename T>
__global__ void ztables_filter_kernel(
    const T* __restrict__ ad, const float* __restrict__ g0,
    const float* __restrict__ g1, const unsigned char* __restrict__ keepc,
    const unsigned char* __restrict__ amax, const double* __restrict__ meanv,
    unsigned char* __restrict__ mask, int* __restrict__ dcount, int N,
    int col0, int B, long long n_sites, int W, int n_chunks,
    long long chunk_sites, long long mask_stride, double tol) {
  const int b = blockIdx.y * WARP + threadIdx.x;
  const int c = blockIdx.x * CHUNKS_PER_BLOCK + threadIdx.y;
  if (b >= B || c >= n_chunks) return;
  const int col = col0 + b;
  const long long R = (long long)W * W;
  const int D = 2 * W - 1;
  const unsigned char* kb = keepc + (long long)b * R;
  const unsigned char* ab = amax + (long long)b * R;
  const double* mb = meanv + (long long)b * R;
  unsigned char* out = mask + (long long)b * mask_stride;
  int* __restrict__ dc = dcount + ((long long)c * B + b) * D;
  const long long lo = (long long)c * chunk_sites;
  const long long hi = min(lo + chunk_sites, n_sites);
  for (long long s = lo; s < hi; ++s) {
    const int ar = (int)ad[s * 2 * N + 2 * col];
    const int aa = (int)ad[s * 2 * N + 2 * col + 1];
    const float a0 = g0[s * N + col];
    const float a1 = g1[s * N + col];
    if (ar < 0 || aa < 0 || ar >= W || aa >= W) continue;  // not reached
    const long long code = (long long)ar * W + aa;
    if (!kb[code]) continue;
    const int k = ab[code];
    const float g = k == 0 ? a0 : (k == 1 ? a1 : (1.0f - a0) - a1);
    if (fabs(mb[code] - (double)g) <= tol) {
      out[s] = 1;
      dc[ar + aa] += 1;
    }
  }
}

template <typename T>
int launch_bin(const void* ad, const float* g0, const float* g1, double* part,
               int N, int col0, int B, long long n_sites, int W, int n_chunks,
               long long chunk_sites, cudaStream_t stream) {
  const dim3 block(WARP, CHUNKS_PER_BLOCK);
  const dim3 grid((n_chunks + CHUNKS_PER_BLOCK - 1) / CHUNKS_PER_BLOCK,
                  (B + WARP - 1) / WARP);
  ztables_bin_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(ad), g0, g1, part, N, col0, B, n_sites, W,
      n_chunks, chunk_sites);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_filter(const void* ad, const float* g0, const float* g1,
                  const unsigned char* keepc, const unsigned char* amax,
                  const double* meanv, unsigned char* mask, int* dcount,
                  int N, int col0, int B, long long n_sites, int W,
                  int n_chunks, long long chunk_sites, long long mask_stride,
                  double tol, cudaStream_t stream) {
  const dim3 block(WARP, CHUNKS_PER_BLOCK);
  const dim3 grid((n_chunks + CHUNKS_PER_BLOCK - 1) / CHUNKS_PER_BLOCK,
                  (B + WARP - 1) / WARP);
  ztables_filter_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(ad), g0, g1, keepc, amax, meanv, mask, dcount, N,
      col0, B, n_sites, W, n_chunks, chunk_sites, mask_stride, tol);
  return (int)cudaGetLastError();
}

}  // namespace

// ztables_bin on `stream`.  ad is [n_sites+, 2N] of uint8 (ad_type 0) or
// int32 (1); g0/g1 are [n_sites+, N]; part is the zeroed
// [n_chunks, B, W * W, 4] float64 buffer.  Returns cudaGetLastError().
WG_EXPORT int wg_ztables_bin(int device, const void* ad, const float* g0,
                             const float* g1, double* part, int N, int col0,
                             int B, long long n_sites, int W, int n_chunks,
                             long long chunk_sites, int ad_type,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (ad_type == 0)
    return launch_bin<unsigned char>(ad, g0, g1, part, N, col0, B, n_sites, W,
                                     n_chunks, chunk_sites, st);
  return launch_bin<int>(ad, g0, g1, part, N, col0, B, n_sites, W, n_chunks,
                         chunk_sites, st);
}

// ztables_filter on `stream`.  keepc/amax are [B, W * W] uint8, meanv
// [B, W * W] float64; mask rows are mask_stride bytes apart (written only
// where a site is kept); dcount is the zeroed [n_chunks, B, 2W - 1] int32
// buffer.  Returns cudaGetLastError().
WG_EXPORT int wg_ztables_filter(int device, const void* ad, const float* g0,
                                const float* g1, const unsigned char* keepc,
                                const unsigned char* amax,
                                const double* meanv, unsigned char* mask,
                                int* dcount, int N, int col0, int B,
                                long long n_sites, int W, int n_chunks,
                                long long chunk_sites, long long mask_stride,
                                double tol, int ad_type, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (ad_type == 0)
    return launch_filter<unsigned char>(ad, g0, g1, keepc, amax, meanv, mask,
                                        dcount, N, col0, B, n_sites, W,
                                        n_chunks, chunk_sites, mask_stride,
                                        tol, st);
  return launch_filter<int>(ad, g0, g1, keepc, amax, meanv, mask, dcount, N,
                            col0, B, n_sites, W, n_chunks, chunk_sites,
                            mask_stride, tol, st);
}

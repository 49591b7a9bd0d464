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
// What bounds it on an H100: the published bound is bytes (every problem
// reads its own 8 P S bytes of panels once per chunk), but under the
// rounding contract (common.cuh) a weight is ~25 instruction slots, so the
// float32 pipe is what the kernel waits for.  No panel is shared between
// problems, so a site's 8 P bytes stay in shared memory for the T
// iterations and shared memory sets the occupancy whatever the tile
// (~25 warps an SM at P = 35): the design has to spend few instructions on a
// weight.
//
// Design, and what each part is for:
// - A block is one problem (blockIdx.y) and W * 32 consecutive site slots,
//   one thread a site (W = 1, 2, 4 or 8 warps, the caller's choice: the
//   widest tile that keeps the most warps resident, since every block costs
//   a launch: at P = 35 a grid of 1M one-warp blocks takes ~0.3 ms longer
//   than 262,144 blocks of four).  It reads its limit first: a finished
//   problem (limit 0) copies ft through, writes zero partials and stages
//   nothing, so chunks and replays in which most problems have converged
//   read almost no panel bytes.
// - Warp 0 turns the problem's mask row into a bitmap and running counts
//   (8 bytes per 32 members of shared memory).  Where every non-zero mask
//   value is 1.0 -- the z-score path's masks -- only the rows that take part
//   are staged, packed in ascending order, and the member loop runs over
//   them with no test and no multiply (w * 1.0f is w).  Any other mask
//   stages every row and multiplies each weight by its mask value, 0
//   included, exactly as the plain twin does.
// - Rows are staged with 16-byte cp.async where S and the tile offset keep
//   them 16-byte aligned, through registers otherwise (unaligned rows, the
//   ragged last tile, whose slots past S get the padding pattern (1, 0) and
//   d = 0).  No second buffer: 6 blocks of 4 warps are resident on an SM at
//   P = 35, each in another phase, so one block's staging (35 KB) hides
//   behind the others' arithmetic.
// - The member loop is unrolled by SITES_UNROLL, which amortises the loop's
//   own instructions.  It buys no overlap inside a thread: every IEEE
//   divide ends in a range check and a branch to its slow path, and the
//   compiler keeps the unrolled weights in order around them, so the
//   resident warps hide the latency.  The sum is taken in ascending member
//   order as the twin's.  1 - f is hoisted out of the loop; f * (1 - f) is
//   not (it would round otherwise).  g2 = 1 - g0 - g1 is rebuilt in
//   registers, so two planes are staged.
// - Each warp's lane 0 writes its per-iteration sums into
//   sq_part[32-site tile, T, B]; the caller sums the tiles in one fixed
//   order.  No scratch in shared memory and no float atomics: the
//   convergence decision reads these sums.
// - The panel slice fits the 227 KB up to 907 members at any chunk length.
//   Above that (STAGED false, launched with no shared memory) nothing is
//   staged: a thread reads its site of the problem's global panel row by
//   row, in ascending order, skipping the rows a 0/1 mask leaves out and
//   multiplying by the mask value otherwise, so the sums round as the
//   staged ones do.  A warp's read of a member is one 128-byte line, reused
//   over the T iterations out of L1 and L2.  Slots past S read the last
//   slot's column and contribute nothing.
#include "common.cuh"

namespace {

constexpr int SITES_UNROLL = 8;
constexpr int PLANES = 2;  // ops/sites_chunk.py::SITES_PLANES

// The staged GL triple of packed member row i at this thread's site; sg
// points at the thread's column of the TS-site tile, n_rows is the number of
// staged rows.
template <int TS>
__device__ __forceinline__ void staged_gl(const float* __restrict__ sg, int i,
                                          int n_rows, float& a, float& b,
                                          float& c) {
  a = sg[i * TS];
  b = sg[(n_rows + i) * TS];
  c = 1.0f - a - b;
}

// Sum of the n_rows staged members' weights under f, in ascending order.
// MULT: each weight times its mask value (mk, indexed like the rows).
template <bool FAST, bool MULT, int TS>
__device__ __forceinline__ float sites_member_sum(
    const float* __restrict__ sg, int n_rows, float f,
    const float* __restrict__ mk) {
  const float omf = 1.0f - f;
  float acc = 0.0f;
  int i = 0;
  for (; i + SITES_UNROLL <= n_rows; i += SITES_UNROLL) {
    float w[SITES_UNROLL];
#pragma unroll
    for (int u = 0; u < SITES_UNROLL; ++u) {
      float a, b, c;
      staged_gl<TS>(sg, i + u, n_rows, a, b, c);
      w[u] = em_w<FAST>(a, b, c, f, omf);
      if (MULT) w[u] = w[u] * __ldg(mk + i + u);
    }
#pragma unroll
    for (int u = 0; u < SITES_UNROLL; ++u) acc += w[u];
  }
  for (; i < n_rows; ++i) {
    float a, b, c;
    staged_gl<TS>(sg, i, n_rows, a, b, c);
    float w = em_w<FAST>(a, b, c, f, omf);
    if (MULT) w = w * __ldg(mk + i);
    acc += w;
  }
  return acc;
}

// The same sum over the P rows of the problem's global panel, `ld` floats
// apart; g0c / g1c point at this thread's site in row 0, mk is the mask row.
// MULT as above; without it the rows whose mask is 0 are skipped (a branch
// the whole block takes alike).
template <bool FAST, bool MULT>
__device__ __forceinline__ float sites_member_sum_global(
    const float* __restrict__ g0c, const float* __restrict__ g1c,
    long long ld, int P, float f, const float* __restrict__ mk) {
  const float omf = 1.0f - f;
  float acc = 0.0f;
  for (int p = 0; p < P; ++p, g0c += ld, g1c += ld) {
    const float m = __ldg(mk + p);
    if (!MULT && m == 0.0f) continue;
    const float a = *g0c;
    const float b = *g1c;
    float w = em_w<FAST>(a, b, 1.0f - a - b, f, omf);
    if (MULT) w = w * m;
    acc += w;
  }
  return acc;
}

// W warps a block: a tile of TS = 32 W site slots.
template <bool FAST, int W, bool STAGED>
__global__ void __launch_bounds__(32 * W) sites_chunk_kernel(
    const float* __restrict__ g0p, const float* __restrict__ g1p,
    const float* __restrict__ ft_in, float* __restrict__ ft_out,
    const float* __restrict__ mask, const float* __restrict__ sw,
    const float* __restrict__ limits, const float* __restrict__ inv_counts,
    float* __restrict__ sq_part, int B, int P, int S_total, int T,
    int aligned) {
  constexpr int TS = 32 * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const long long s0 = (long long)blockIdx.x * TS;
  const long long s = s0 + tid;
  const bool real = s < S_total;
  const long long row = (long long)b * S_total + s;
  float* part =
      sq_part + ((long long)blockIdx.x * W + warp) * T * B + b;

  const float lim = __ldg(limits + b);
  if (!(lim > 0.0f)) {
    if (real) ft_out[row] = ft_in[row];
    if (lane == 0) {
      for (int t = 0; t < T; ++t) part[(long long)t * B] = 0.0f;
    }
    return;
  }

  const float* mask_b = mask + (long long)b * P;
  int n_rows = 0;
  bool packed = true;
  const float* col = nullptr;
  if constexpr (STAGED) {
    extern __shared__ float4 smem4[];
    float* sg = reinterpret_cast<float*>(smem4);  // [PLANES][rows][TS]
    const int n_words = (P + 31) >> 5;
    unsigned* bits = reinterpret_cast<unsigned*>(sg + PLANES * P * TS);
    int* pre = reinterpret_cast<int*>(bits + n_words);  // rows before a word
    int* head = pre + n_words;  // {staged rows, every non-zero mask is 1}

    if (warp == 0) {
      int count = 0;
      bool ones = true;
      for (int w = 0; w < n_words; ++w) {
        const int p = w * 32 + lane;
        const float mk = p < P ? __ldg(mask_b + p) : 0.0f;
        ones = ones && (mk == 0.0f || mk == 1.0f);
        const unsigned word = __ballot_sync(0xffffffffu, mk != 0.0f);
        if (lane == 0) {
          bits[w] = word;
          pre[w] = count;
        }
        count += __popc(word);
      }
      ones = __all_sync(0xffffffffu, ones);
      __syncwarp();
      if (!ones) {
        // a mask with other values: every row is staged, at its own index
        for (int w = lane; w < n_words; w += 32) {
          const int left = P - w * 32;
          bits[w] = left >= 32 ? 0xffffffffu : ((1u << left) - 1u);
          pre[w] = w * 32;
        }
        count = P;
      }
      if (lane == 0) {
        head[0] = count;
        head[1] = ones;
      }
    }
    __syncthreads();
    n_rows = head[0];
    packed = head[1] != 0;

    const long long panel = (long long)b * P * S_total + s0;
    if (aligned && s0 + TS <= S_total) {
      // a row of the tile is TS / 4 16-byte copies per plane, consecutive
      // threads on consecutive chunks
      constexpr int CPR = TS / 4;
      const int per_plane = P * CPR;
      for (int e = tid; e < 2 * per_plane; e += TS) {
        const int plane = e >= per_plane;
        const int ee = e - plane * per_plane;
        const int p = ee / CPR;
        const int c4 = (ee % CPR) * 4;
        const unsigned word = bits[p >> 5];
        if (!((word >> (p & 31)) & 1u)) continue;
        const int i = pre[p >> 5] + __popc(word & ((1u << (p & 31)) - 1u));
        const float* src =
            (plane ? g1p : g0p) + panel + (long long)p * S_total + c4;
        cp_async_16(sg + ((plane ? n_rows : 0) + i) * TS + c4, src);
      }
      cp_async_wait_all();
    } else {
      for (int p = warp; p < P; p += W) {
        const unsigned word = bits[p >> 5];
        if (!((word >> (p & 31)) & 1u)) continue;
        const int i = pre[p >> 5] + __popc(word & ((1u << (p & 31)) - 1u));
        for (int c = lane; c < TS; c += 32) {
          const bool in = s0 + c < S_total;
          const long long at = panel + (long long)p * S_total + c;
          const float a = in ? g0p[at] : 1.0f;
          const float g = in ? g1p[at] : 0.0f;
          sg[i * TS + c] = a;
          sg[(n_rows + i) * TS + c] = g;
        }
      }
    }
    __syncthreads();
    col = sg + tid;
  } else {
    // every non-zero mask value 1.0?  Each warp finds out for itself.
    for (int p = lane; p < P; p += 32) {
      const float mk = __ldg(mask_b + p);
      packed = packed && (mk == 0.0f || mk == 1.0f);
    }
    packed = __all_sync(0xffffffffu, packed);
  }
  // unstaged: this thread's site in row 0 of the problem's global panel
  const long long at0 =
      (long long)b * P * S_total + (real ? s : (long long)S_total - 1);
  const float inv = __ldg(inv_counts + b);
  float f = real ? ft_in[row] : WG_EM_LO;
  const float w_site = real ? sw[row] : 0.0f;
  for (int t = 0; t < T; ++t) {
    float v = 0.0f;
    if (lim > (float)t) {  // uniform across the block
      float acc;
      if constexpr (STAGED) {
        acc = packed
                  ? sites_member_sum<FAST, false, TS>(col, n_rows, f, mask_b)
                  : sites_member_sum<FAST, true, TS>(col, n_rows, f, mask_b);
      } else {
        acc = packed ? sites_member_sum_global<FAST, false>(
                           g0p + at0, g1p + at0, S_total, P, f, mask_b)
                     : sites_member_sum_global<FAST, true>(
                           g0p + at0, g1p + at0, S_total, P, f, mask_b);
      }
      const float f_new = em_clip(acc * inv);
      const float d = real ? f_new - f : 0.0f;
      f = f_new;
      v = warp_sum(d * d * w_site);
    }
    if (lane == 0) part[(long long)t * B] = v;
  }
  if (real) ft_out[row] = f;
}

using SitesKernel = void (*)(const float*, const float*, const float*,
                             float*, const float*, const float*,
                             const float*, const float*, float*, int, int,
                             int, int, int);

template <int W>
SitesKernel sites_kernel_w(int fast_math, int smem_bytes) {
  if (smem_bytes > 0) {
    return fast_math ? sites_chunk_kernel<true, W, true>
                     : sites_chunk_kernel<false, W, true>;
  }
  return fast_math ? sites_chunk_kernel<true, W, false>
                   : sites_chunk_kernel<false, W, false>;
}

// The instantiation for `warps` warps a block (ops/sites_chunk.py::
// SITES_WARPS), or nullptr.  smem_bytes == 0 asks for the kernel that stages
// nothing.
SitesKernel sites_kernel(int warps, int fast_math, int smem_bytes) {
  switch (warps) {
    case 1: return sites_kernel_w<1>(fast_math, smem_bytes);
    case 2: return sites_kernel_w<2>(fast_math, smem_bytes);
    case 4: return sites_kernel_w<4>(fast_math, smem_bytes);
    case 8: return sites_kernel_w<8>(fast_math, smem_bytes);
    default: return nullptr;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a block width that is not built.
WG_EXPORT int wg_sites_chunk(int device, const float* g0p, const float* g1p,
                             const float* ft_in, float* ft_out,
                             const float* mask, const float* sw,
                             const float* limits, const float* inv_counts,
                             float* sq_part, int B, int P, int S_total, int T,
                             int warps, int smem_bytes, int aligned,
                             int fast_math, void* stream) {
  SitesKernel kern = sites_kernel(warps, fast_math, smem_bytes);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int ts = 32 * warps;
  const dim3 grid((S_total + ts - 1) / ts, B);
  kern<<<grid, ts, smem_bytes, (cudaStream_t)stream>>>(
      g0p, g1p, ft_in, ft_out, mask, sw, limits, inv_counts, sq_part, B, P,
      S_total, T, aligned);
  return (int)cudaGetLastError();
}

// Resident blocks per SM the runtime reports for this launch shape, or the
// negated CUDA error code.
WG_EXPORT int wg_sites_chunk_occupancy(int device, int warps, int smem_bytes,
                                       int fast_math) {
  SitesKernel kern = sites_kernel(warps, fast_math, smem_bytes);
  if (kern == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      32 * warps, smem_bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

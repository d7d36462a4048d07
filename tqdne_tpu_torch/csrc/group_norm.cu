// Fused GroupNorm + affine + optional SiLU over channels-last (B, S, C) activations, f32
// statistics, input and output in the model dtype: one kernel launch per call.
//
// Replaces tqdne_tpu/ops/group_norm.py:_gn_silu_kernel (one TPU program per sample holding the
// whole (S, C) slab in VMEM).  Statistics follow that module's two-pass _reference (mean, then
// the mean of squared deviations), not the TPU kernel's E[x^2] - mean^2, which loses every
// digit in f32 once |mean| is a few hundred times the spread.
//
// Bound: bytes.  The function reads x once and writes y once (plus C-sized parameters), a
// handful of operations per element.  The design moves exactly those bytes, in one launch:
// - Work splits over independent groups and over rows.  A block owns `slice_channels` channels
//   (whole groups, so it shares no statistics across slices) of `chunk_rows` rows of one
//   sample, about 64 KB of it: small enough for two or three blocks an SM.  The row chunks of
//   one (sample, slice) form a thread-block cluster of up to 16 blocks (a non-portable size,
//   planned only where the card co-schedules it); grid (cluster, C / slice_channels, B).
// - Each block stages its chunk into shared memory once, 16 bytes a lane (neighbouring lanes
//   on neighbouring addresses, cp.async), and takes two passes over it: the chunk's group
//   means m1, then the sums of d = x - m1 and d^2, which correct the mean for m1's rounding
//   and give M2 (the corrected two-pass of Chan, Golub and LeVeque); no division per element.
// - The blocks of a cluster publish per-group (n, mean, M2) in shared memory; after
//   cluster.sync() every block reads all of them through distributed shared memory and merges
//   them in rank order with Chan's formula, so the result is the same in every block and from
//   run to run.
// - Each block normalises, applies the affine and the SiLU to its staged chunk and writes y
//   with 16-byte stores: x crosses HBM once each way.
// - Variants (group_norm_plan in ops/group_norm.py picks them): VEC = 16 / sizeof(T) where x,
//   y and C are 16-byte aligned, else 1 (element loads); RESIDENT unless a chunk is too large
//   for 227 KB even at the largest cluster, and then every pass reads the chunk from global
//   memory: HBM once, the second and third reads from L2.  No shape of the flagship paths
//   takes that variant: the largest, the autoencoder's S = 16384 x C = 64, is 1 MB a (sample,
//   slice) in f32 or bf16, 16 chunks of 64 KB.  (A slice of 64 channels takes 4 MB a sample
//   in f32, past 16 x 227 KB; that is the re-read variant.)
// - Two more entry points share the kernel (its MODE), for an activation whose rows are split
//   over ranks (spatial partitioning, parallel/spatial.py): `tq_group_norm_stats` stops after the
//   cluster's merge and writes each (sample, group)'s (n, mean, M2) of the shard's rows, which
//   the ranks combine; `tq_group_norm_apply` skips the statistics and normalises with a given
//   (mean, rstd) a (sample, group), then the affine and the SiLU.  Both move the bytes the
//   function needs (x once for the statistics; x once and y once for the apply), in the plan of
//   the fused kernel, whose code (MODE 0) they leave as it was.
// - The backward, `tq_group_norm_silu_backward`, is a kernel of its own (see its section below):
//   it stages x and dy, recomputes the statistics and writes dx and per-block partial sums.

#include <cooperative_groups.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using tq::bf16;

constexpr int MAX_SMEM = 232448;  // 227 KB: the most dynamic shared memory a block may use
constexpr int MAX_CLUSTER = 16;   // with cudaFuncAttributeNonPortableClusterSizeAllowed

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// VEC consecutive elements as floats: one 16-byte access when VEC > 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_float(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {  // a bf16 is the upper half of the f32 it widens to
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4)
      *p = v[0];
    else
      *p = __float2bfloat16(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = __bfloat16_as_ushort(__float2bfloat16(v[2 * i])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * i + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

constexpr unsigned FULL = 0xffffffffu;

// Rows of the partial-sum buffer: one per warp where the lanes that share a vector column fold
// together by shuffles (nv, the slice's vector columns, divides 32), else one per row slot.
__host__ __device__ __forceinline__ int red_rows(int nv, int threads, int rpp) {
  return 32 % nv == 0 ? threads / 32 : rpp;
}

// Bytes of dynamic shared memory: the staged chunk (RESIDENT only), the partial sums (red_rows
// x cs), the channel totals (cs), the published (n, mean, M2) of each group, the cluster's
// copies of them (3 x cluster x ng) and the merged (mean, rstd).  ops/group_norm.py:_smem
// repeats this formula.
size_t smem_bytes(int esize, int vec, int cs, int gsize, int chunk_rows, int rpp, int threads,
                  int cluster, bool resident) {
  const size_t stage = resident ? ((size_t)chunk_rows * cs * esize + 15) / 16 * 16 : 0;
  const size_t ng = cs / gsize;
  return stage + sizeof(float) * ((size_t)red_rows(cs / vec, threads, rpp) * cs + cs +
                                  (5 + 3 * (size_t)cluster) * ng);
}

// Each thread's VEC partial sums (channels col .. col + VEC - 1 of the slice, over its rows)
// reduced to one total per group of the slice, times `mul`, into dst[0, ng).  Lanes of a warp
// that share a column fold by shuffles where nv divides 32; each channel's total then sums the
// rows of `red` (first split over the threads a channel has to spare, where there are many),
// and a group's channels fold by shuffles where gsize is a power of two up to 32 (else one
// thread a group sums them from `chan`).  blockDim.x is a multiple of 32; threads past the
// last row slot hold zeros.
template <int VEC>
__device__ __forceinline__ void group_sums(float (&acc)[VEC], float* red, float* chan, float* dst,
                                           int cs, int gsize, int rpp, float mul) {
  const int nv = cs / VEC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (32 % nv == 0) {
    for (int off = nv; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(FULL, acc[e], off);
    }
    if (lane < nv) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[(tid >> 5) * cs + lane * VEC + e] = acc[e];
    }
  } else if (tid / nv < rpp) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[(tid / nv) * cs + (tid % nv) * VEC + e] = acc[e];
  }
  __syncthreads();
  int rows = red_rows(nv, blockDim.x, rpp);
  const int parts = min(rows, (int)blockDim.x / cs);  // threads a channel's rows split over
  if (rows > 8 && parts >= 2) {       // many rows: fold them to `parts` first
    const int c = tid % cs;
    const int p = tid / cs;
    float sum = 0.f;
    if (p < parts)
      for (int r = p; r < rows; r += parts) sum += red[r * cs + c];
    __syncthreads();
    if (p < parts) red[p * cs + c] = sum;
    __syncthreads();
    rows = parts;
  }
  const bool pow2 = gsize <= 32 && (gsize & (gsize - 1)) == 0;
  for (int c0 = 0; c0 < cs; c0 += blockDim.x) {  // the same trip count in every thread
    const int c = c0 + tid;
    float sum = 0.f;
    if (c < cs)
      for (int r = 0; r < rows; ++r) sum += red[r * cs + c];
    if (pow2) {
      for (int off = 1; off < gsize; off <<= 1) sum += __shfl_xor_sync(FULL, sum, off);
      if (c < cs && (c & (gsize - 1)) == 0) dst[c / gsize] = sum * mul;
    } else if (c < cs) {
      chan[c] = sum;
    }
  }
  if (!pow2) {
    __syncthreads();
    for (int j = tid; j < cs / gsize; j += blockDim.x) {
      float sum = 0.f;
      for (int c = j * gsize; c < (j + 1) * gsize; ++c) sum += chan[c];
      dst[j] = sum * mul;
    }
  }
  __syncthreads();
}

// MODE 0: the fused GroupNorm; 1: only the statistics, (n, mean, M2) of each (sample, group)
// into `stats` (B, G, 3); 2: only the normalisation, with (mean, rstd) of each (sample, group)
// read from `mean_rstd` (B, G, 2).
template <typename T, typename P, int VEC, bool RESIDENT, int MODE>
__global__ void __launch_bounds__(1024)
    group_norm_silu_kernel(const T* __restrict__ x, const P* __restrict__ scale,
                           const P* __restrict__ bias, T* __restrict__ out,
                           float* __restrict__ stats, const float* __restrict__ mean_rstd, int S,
                           int C, int gsize, int cs, int chunk_rows, int rpp, float eps,
                           int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = gridDim.x;  // the cluster spans the grid's x dimension
  const int rank = blockIdx.x;
  const int nv = cs / VEC;
  const int ng = cs / gsize;
  const int tid = threadIdx.x;
  const int col = (tid % nv) * VEC;  // the thread's first channel in the slice
  const int rslot = tid / nv;
  const int r0 = rank * chunk_rows;
  const int rows = max(0, min(chunk_rows, S - r0));
  const int first = rslot < rpp ? rslot : rows;  // threads past the last row slot walk none
  const size_t base = ((size_t)blockIdx.z * S + r0) * C + (size_t)blockIdx.y * cs + col;
  const T* xg = x + base;
  T* og = out + base;

  const size_t stage_bytes = RESIDENT ? ((size_t)chunk_rows * cs * sizeof(T) + 15) / 16 * 16 : 0;
  T* stage = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + stage_bytes);  // red_rows x cs
  float* chan = red + red_rows(nv, blockDim.x, rpp) * cs;     // cs
  float* pub = chan + cs;                                      // n, mean, M2: 3 x ng
  float* all = pub + 3 * ng;                                   // every rank's: 3 x nc x ng
  float* fin = all + 3 * nc * ng;                              // mean, rstd: 2 x ng

  // the thread's first row, in global memory (row stride C) or staged (row stride cs)
  const T* src = xg + (long long)rslot * C;
  long long ld = C;
  if constexpr (RESIDENT) {
    T* to = stage + rslot * cs + col;
    for (int r = first; r < rows; r += rpp) {
      if constexpr (VEC > 1)
        tq::cp_async16(to + (r - rslot) * cs, src + (long long)(r - rslot) * C, 16);
      else
        to[(r - rslot) * cs] = src[(long long)(r - rslot) * C];
    }
    if constexpr (VEC > 1) {
      tq::cp_async_commit();
      tq::cp_async_wait<0>();
    }
    __syncthreads();
    src = to;
    ld = cs;
  }

  float acc[VEC], mu[VEC];
  // the (sample, group)s of this slice: (B, G, k) arrays hold them at (z * G + y * ng + j) * k
  const size_t group0 = (size_t)blockIdx.z * (C / gsize) + (size_t)blockIdx.y * ng;
  if constexpr (MODE == 2) {
    for (int j = tid; j < ng; j += blockDim.x) {
      fin[j] = mean_rstd[(group0 + j) * 2];
      fin[ng + j] = mean_rstd[(group0 + j) * 2 + 1];
    }
    __syncthreads();
  } else {
    // pass 1: the chunk's group means m1
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int r = first; r < rows; r += rpp) {
      float v[VEC];
      load_vec<T, VEC>(src + (r - rslot) * ld, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += v[e];
    }
    const float n = (float)rows * gsize;
    group_sums<VEC>(acc, red, chan, pub + ng, cs, gsize, rpp, rows ? 1.f / n : 0.f);

    // pass 2: the sums of d = x - m1 and of d^2 (the corrected two-pass: the chunk's mean is
    // m1 + sum(d) / n, its M2 sum(d^2) - sum(d)^2 / n)
    float acc2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      mu[e] = pub[ng + (col + e) / gsize];
      acc[e] = acc2[e] = 0.f;
    }
#pragma unroll 4
    for (int r = first; r < rows; r += rpp) {
      float v[VEC];
      load_vec<T, VEC>(src + (r - rslot) * ld, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = v[e] - mu[e];
        acc[e] += d;
        acc2[e] = fmaf(d, d, acc2[e]);
      }
    }
    group_sums<VEC>(acc, red, chan, fin, cs, gsize, rpp, 1.f);  // fin: scratch until the merge
    group_sums<VEC>(acc2, red, chan, pub + 2 * ng, cs, gsize, rpp, 1.f);
    for (int j = tid; j < ng; j += blockDim.x) {
      const float s1 = fin[j];
      pub[j] = n;
      if (rows) {
        pub[ng + j] += s1 / n;
        pub[2 * ng + j] -= s1 * s1 / n;
      }
    }

    // every rank's (n, mean, M2), one remote load a thread, then a merge in rank order (Chan
    // et al.) from the local copies; a cluster of one block reads its own
    const float* ranks = pub;
    if (nc > 1) {
      cluster.sync();
      for (int i = tid; i < 3 * nc * ng; i += blockDim.x) {
        const int k = i / (3 * ng);
        const int f = i - k * 3 * ng;
        all[i] = cluster.map_shared_rank(pub, k)[f];
      }
      ranks = all;
    }
    cluster.sync();  // the copies are complete, and no block's pub is read any more
    for (int j = tid; j < ng; j += blockDim.x) {
      float cnt = 0.f, mean = 0.f, m2 = 0.f;
      for (int k = 0; k < nc; ++k) {
        const float* other = ranks + k * 3 * ng;
        const float nb = other[j];
        if (nb == 0.f) continue;
        const float total = cnt + nb;
        const float delta = other[ng + j] - mean;
        const float frac = nb / total;
        mean = fmaf(delta, frac, mean);
        m2 += other[2 * ng + j] + delta * delta * cnt * frac;
        cnt = total;
      }
      if constexpr (MODE == 1) {
        if (rank == 0) {
          float* o = stats + (group0 + j) * 3;
          o[0] = cnt;
          o[1] = mean;
          o[2] = m2;
        }
      } else {
        fin[j] = mean;
        fin[ng + j] = rsqrtf(m2 / cnt + eps);
      }
    }
    if constexpr (MODE == 1) return;
    __syncthreads();
  }

  // normalise, affine, SiLU, store
  float a[VEC], b[VEC];
  const int c0 = blockIdx.y * cs + col;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int j = (col + e) / gsize;
    mu[e] = fin[j];
    a[e] = fin[ng + j] * to_float(scale[c0 + e]);
    b[e] = to_float(bias[c0 + e]);
  }
#pragma unroll 4
  for (int r = first; r < rows; r += rpp) {
    float v[VEC];
    load_vec<T, VEC>(src + (r - rslot) * ld, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float y = fmaf(v[e] - mu[e], a[e], b[e]);
      v[e] = silu ? __fdividef(y, 1.f + __expf(-y)) : y;
    }
    store_vec<T, VEC>(og + (long long)r * C, v);
  }
}

// ---- the backward (tq_group_norm_silu_backward) -----------------------------------------------
//
// Replaces no TPU kernel: the JAX module has none (tqdne_tpu/ops/group_norm.py:_bwd is autograd
// over _reference, which XLA fuses on the TPU; eager PyTorch on the card ran it as some fifteen
// strided elementwise kernels and reductions over f32 copies a call).
//
// Bound: bytes.  It reads x and dy once and writes dx once (plus C-sized parameters and per-block
// partial sums).  The design is the forward's, with both x and dy staged:
// - The plan (group_norm_plan(..., backward=True)) cuts (B, S, C) as the forward's does, with
//   twice the bytes a row staged, so a cluster has about twice the blocks.  Each block stages its
//   chunk of x and of dy into shared memory once (dy's lands while the statistics run) and takes
//   four passes over them.
// - Passes 1 and 2 are the forward's statistics (the corrected two-pass a chunk, Chan's merge
//   over the cluster in rank order), so every block holds each group's mean and rstd.
// - Pass 3 forms xhat, y = xhat * scale + bias, g = dy * dSiLU(y) (dy without the SiLU) and sums
//   per channel g and g * (x - mean).  The block writes its channel sums (g * xhat and g: the
//   partials of dscale and dbias) to `part` (B, cluster, 2, C), which the wrapper sums in a fixed
//   order (no atomics: the same inputs give the same bits), and publishes each group's sums of
//   g * scale and g * scale * xhat; the cluster merges them in rank order.
// - Pass 4 writes dx = rstd * (g * scale - mean(g * scale) - xhat * mean(g * scale * xhat)), the
//   means over each (sample, group), with 16-byte stores.
// - 512 threads at most (the plan keeps to it), for 128 registers a thread: x and dy, and five
//   constants of each of a thread's VEC channels, stay in registers in pass 4.

// Bytes of dynamic shared memory of the backward: the staged chunks of x and dy (RESIDENT only),
// the partial sums (red_rows x cs), two rows of channel totals (2 x cs), the published sums of
// each group, the cluster's copies of them (3 x cluster x ng) and four merged values a group
// (mean, rstd and the two terms of dx).  ops/group_norm.py:_smem repeats this formula.
size_t smem_bwd_bytes(int esize, int vec, int cs, int gsize, int chunk_rows, int rpp,
                      int threads, int cluster, bool resident) {
  const size_t stage = resident ? 2 * (((size_t)chunk_rows * cs * esize + 15) / 16 * 16) : 0;
  const size_t ng = cs / gsize;
  return stage + sizeof(float) * ((size_t)red_rows(cs / vec, threads, rpp) * cs + 2 * cs +
                                  (7 + 3 * (size_t)cluster) * ng);
}

constexpr int MAX_BWD_THREADS = 512;

// Each thread's VEC partial sums (channels col .. col + VEC - 1 of the slice, over its rows)
// reduced to one total a channel of the slice, into dst[0, cs): lanes that share a column fold
// by shuffles where nv divides 32, then each channel sums the rows of `red` (first split over
// the threads a channel has to spare, where there are many), in a fixed order.
template <int VEC>
__device__ __forceinline__ void channel_sums(float (&acc)[VEC], float* red, float* dst, int cs,
                                             int rpp) {
  const int nv = cs / VEC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (32 % nv == 0) {
    for (int off = nv; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(FULL, acc[e], off);
    }
    if (lane < nv) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[(tid >> 5) * cs + lane * VEC + e] = acc[e];
    }
  } else if (tid / nv < rpp) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[(tid / nv) * cs + (tid % nv) * VEC + e] = acc[e];
  }
  __syncthreads();
  int rows = red_rows(nv, blockDim.x, rpp);
  const int parts = min(rows, (int)blockDim.x / cs);
  if (rows > 8 && parts >= 2) {
    const int c = tid % cs;
    const int p = tid / cs;
    float sum = 0.f;
    if (p < parts)
      for (int r = p; r < rows; r += parts) sum += red[r * cs + c];
    __syncthreads();
    if (p < parts) red[p * cs + c] = sum;
    __syncthreads();
    rows = parts;
  }
  for (int c = tid; c < cs; c += blockDim.x) {
    float sum = 0.f;
    for (int r = 0; r < rows; ++r) sum += red[r * cs + c];
    dst[c] = sum;
  }
  __syncthreads();
}

// dL/dy from dL/d(out): out = y * sigmoid(y) with the SiLU, else out = y.
__device__ __forceinline__ float silu_grad(float dout, float y, int silu) {
  if (!silu) return dout;
  const float s = __fdividef(1.f, 1.f + __expf(-y));
  return dout * s * fmaf(y, 1.f - s, 1.f);
}

template <typename T, typename P, int VEC, bool RESIDENT>
__global__ void __launch_bounds__(MAX_BWD_THREADS)
    group_norm_silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                               const P* __restrict__ scale, const P* __restrict__ bias,
                               T* __restrict__ dx, float* __restrict__ part, int S, int C,
                               int gsize, int cs, int chunk_rows, int rpp, float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = gridDim.x;  // the cluster spans the grid's x dimension
  const int rank = blockIdx.x;
  const int nv = cs / VEC;
  const int ng = cs / gsize;
  const int tid = threadIdx.x;
  const int col = (tid % nv) * VEC;  // the thread's first channel in the slice
  const int rslot = tid / nv;
  const int r0 = rank * chunk_rows;
  const int rows = max(0, min(chunk_rows, S - r0));
  const int first = rslot < rpp ? rslot : rows;  // threads past the last row slot walk none
  const size_t base = ((size_t)blockIdx.z * S + r0) * C + (size_t)blockIdx.y * cs + col;

  const size_t stage_bytes = RESIDENT ? ((size_t)chunk_rows * cs * sizeof(T) + 15) / 16 * 16 : 0;
  float* red = reinterpret_cast<float*>(smem + 2 * stage_bytes);  // red_rows x cs
  float* chan = red + red_rows(nv, blockDim.x, rpp) * cs;         // sums of g, g * d: 2 x cs
  float* pub = chan + 2 * cs;                                     // 3 x ng
  float* all = pub + 3 * ng;                                      // every rank's: 3 x nc x ng
  float* fin = all + 3 * nc * ng;  // mean, rstd, then the two terms of dx: 4 x ng

  // the thread's first row of x and of dy, in global memory (row stride C) or staged (cs)
  const T* xs = x + base + (long long)rslot * C;
  const T* ds = dy + base + (long long)rslot * C;
  long long ld = C;
  if constexpr (RESIDENT) {  // x's chunk first, then dy's, which lands while the statistics run
    T* xto = reinterpret_cast<T*>(smem) + rslot * cs + col;
    T* dto = reinterpret_cast<T*>(smem + stage_bytes) + rslot * cs + col;
    for (int k = 0; k < 2; ++k) {
      const T* from = k ? ds : xs;
      T* to = k ? dto : xto;
      for (int r = first; r < rows; r += rpp) {
        if constexpr (VEC > 1)
          tq::cp_async16(to + (r - rslot) * cs, from + (long long)(r - rslot) * C, 16);
        else
          to[(r - rslot) * cs] = from[(long long)(r - rslot) * C];
      }
      if constexpr (VEC > 1) tq::cp_async_commit();
    }
    if constexpr (VEC > 1) tq::cp_async_wait<1>();
    __syncthreads();
    xs = xto;
    ds = dto;
    ld = cs;
  }

  // passes 1 and 2: the statistics, as the forward kernel's
  float acc[VEC], acc2[VEC], mu[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int r = first; r < rows; r += rpp) {
    float v[VEC];
    load_vec<T, VEC>(xs + (r - rslot) * ld, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += v[e];
  }
  const float n = (float)rows * gsize;
  group_sums<VEC>(acc, red, chan, pub + ng, cs, gsize, rpp, rows ? 1.f / n : 0.f);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    mu[e] = pub[ng + (col + e) / gsize];
    acc[e] = acc2[e] = 0.f;
  }
#pragma unroll 4
  for (int r = first; r < rows; r += rpp) {
    float v[VEC];
    load_vec<T, VEC>(xs + (r - rslot) * ld, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = v[e] - mu[e];
      acc[e] += d;
      acc2[e] = fmaf(d, d, acc2[e]);
    }
  }
  group_sums<VEC>(acc, red, chan, fin, cs, gsize, rpp, 1.f);  // fin: scratch until the merge
  group_sums<VEC>(acc2, red, chan, pub + 2 * ng, cs, gsize, rpp, 1.f);
  for (int j = tid; j < ng; j += blockDim.x) {
    const float s1 = fin[j];
    pub[j] = n;
    if (rows) {
      pub[ng + j] += s1 / n;
      pub[2 * ng + j] -= s1 * s1 / n;
    }
  }
  const float* ranks = pub;
  if (nc > 1) {
    cluster.sync();
    for (int i = tid; i < 3 * nc * ng; i += blockDim.x) {
      const int k = i / (3 * ng);
      all[i] = cluster.map_shared_rank(pub, k)[i - k * 3 * ng];
    }
    ranks = all;
  }
  cluster.sync();  // the copies are complete, and no block's pub is read any more
  for (int j = tid; j < ng; j += blockDim.x) {
    float cnt = 0.f, mean = 0.f, m2 = 0.f;
    for (int k = 0; k < nc; ++k) {
      const float* other = ranks + k * 3 * ng;
      const float nb = other[j];
      if (nb == 0.f) continue;
      const float total = cnt + nb;
      const float delta = other[ng + j] - mean;
      const float frac = nb / total;
      mean = fmaf(delta, frac, mean);
      m2 += other[2 * ng + j] + delta * delta * cnt * frac;
      cnt = total;
    }
    fin[j] = mean;
    fin[ng + j] = rsqrtf(m2 / cnt + eps);
  }
  if constexpr (RESIDENT && VEC > 1) tq::cp_async_wait<0>();  // dy's chunk
  __syncthreads();

  // pass 3: per channel, the sums of g and of g * d, d = x - mean (g * xhat = rstd * g * d)
  float a[VEC], b[VEC];
  const int c0 = blockIdx.y * cs + col;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int j = (col + e) / gsize;
    mu[e] = fin[j];
    a[e] = fin[ng + j] * to_float(scale[c0 + e]);
    b[e] = to_float(bias[c0 + e]);
    acc[e] = acc2[e] = 0.f;
  }
#pragma unroll 2
  for (int r = first; r < rows; r += rpp) {
    float v[VEC], w[VEC];
    load_vec<T, VEC>(xs + (r - rslot) * ld, v);
    load_vec<T, VEC>(ds + (r - rslot) * ld, w);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = v[e] - mu[e];
      const float g = silu_grad(w[e], fmaf(d, a[e], b[e]), silu);
      acc[e] += g;
      acc2[e] = fmaf(g, d, acc2[e]);
    }
  }
  channel_sums<VEC>(acc, red, chan, cs, rpp);
  channel_sums<VEC>(acc2, red, chan + cs, cs, rpp);

  // this block's partials of dscale (sums of g * xhat) and dbias (sums of g), and each group's
  // sums of g * scale and g * scale * xhat for the cluster (pub is free since the merge)
  const int slice0 = blockIdx.y * cs;
  float* own = part + ((size_t)blockIdx.z * nc + rank) * 2 * C + slice0;
  for (int c = tid; c < cs; c += blockDim.x) {
    own[c] = fin[ng + c / gsize] * chan[cs + c];
    own[C + c] = chan[c];
  }
  for (int j = tid; j < ng; j += blockDim.x) {
    float p1 = 0.f, p2 = 0.f;
    for (int c = j * gsize; c < (j + 1) * gsize; ++c) {
      const float w = to_float(scale[slice0 + c]);
      p1 = fmaf(w, chan[c], p1);
      p2 = fmaf(w, chan[cs + c], p2);
    }
    pub[j] = p1;
    pub[ng + j] = p2 * fin[ng + j];
  }
  const float* sums = pub;
  if (nc > 1) {
    cluster.sync();
    for (int i = tid; i < 2 * nc * ng; i += blockDim.x) {
      const int k = i / (2 * ng);
      all[i] = cluster.map_shared_rank(pub, k)[i - k * 2 * ng];
    }
    sums = all;
  }
  cluster.sync();  // as above; and no block leaves while another reads its pub
  const float inv_n = 1.f / ((float)S * gsize);
  for (int j = tid; j < ng; j += blockDim.x) {
    float p1 = 0.f, p2 = 0.f;
    for (int k = 0; k < nc; ++k) {
      p1 += sums[k * 2 * ng + j];
      p2 += sums[k * 2 * ng + ng + j];
    }
    const float rstd = fin[ng + j];
    fin[2 * ng + j] = -rstd * (p1 * inv_n);
    fin[3 * ng + j] = -rstd * rstd * (p2 * inv_n);
  }
  __syncthreads();

  // pass 4: dx = g * scale * rstd - rstd * mean(g * scale) - d * rstd^2 * mean(g * scale * xhat)
  float k1[VEC], k2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int j = (col + e) / gsize;
    k1[e] = fin[2 * ng + j];
    k2[e] = fin[3 * ng + j];
  }
  T* og = dx + base;
#pragma unroll 2
  for (int r = first; r < rows; r += rpp) {
    float v[VEC], w[VEC];
    load_vec<T, VEC>(xs + (r - rslot) * ld, v);
    load_vec<T, VEC>(ds + (r - rslot) * ld, w);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = v[e] - mu[e];
      const float g = silu_grad(w[e], fmaf(d, a[e], b[e]), silu);
      v[e] = fmaf(g, a[e], fmaf(d, k2[e], k1[e]));
    }
    store_vec<T, VEC>(og + (long long)r * C, v);
  }
}

// Once per device and kernel: room for 227 KB of shared memory and clusters of 16.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int device, bool (&done)[64]) {
  if (device < 64 && done[device]) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
};

void make_config(Config& c, int cluster, int slices, int B, int threads, size_t smem,
                 cudaStream_t st) {
  c.cfg = {};
  c.cfg.gridDim = dim3(cluster, slices, B);
  c.cfg.blockDim = dim3(threads);
  c.cfg.dynamicSmemBytes = smem;
  c.cfg.stream = st;
  c.attr.id = cudaLaunchAttributeClusterDimension;
  c.attr.val.clusterDim.x = cluster;
  c.attr.val.clusterDim.y = 1;
  c.attr.val.clusterDim.z = 1;
  c.cfg.attrs = &c.attr;
  c.cfg.numAttrs = 1;
}

// How many clusters of this shape the card runs at once (0: it cannot co-schedule one), read
// once per kernel, device, cluster size, block size and shared memory.
template <typename Kernel>
cudaError_t co_scheduled(Kernel kernel, const Config& c, int device, bool& ok) {
  struct Seen {
    int device, cluster, threads;
    size_t smem;
    bool ok;
  };
  static Seen seen[128];
  static int n_seen = 0;
  const int cluster = c.cfg.gridDim.x;
  const int threads = c.cfg.blockDim.x;
  for (int i = 0; i < n_seen; ++i) {
    const Seen& s = seen[i];
    if (s.device == device && s.cluster == cluster && s.threads == threads &&
        s.smem == c.cfg.dynamicSmemBytes) {
      ok = s.ok;
      return cudaSuccess;
    }
  }
  Config probe = c;
  probe.cfg.gridDim = dim3(cluster, 1, 1);
  probe.cfg.attrs = &probe.attr;
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &probe.cfg);
  if (err != cudaSuccess) return err;
  ok = clusters > 0;
  if (n_seen < 128) seen[n_seen++] = {device, cluster, threads, c.cfg.dynamicSmemBytes, ok};
  return cudaSuccess;
}

// The arguments of one launch: tensors, shape and plan (see tq_group_norm_silu).
struct Args {
  const void* x;
  const void* scale;
  const void* bias;
  void* out;
  float* stats;
  const float* mean_rstd;
  int B, S, C, gsize, cs, cluster, chunk_rows, rpp, threads;
  float eps;
  int silu, device;
  cudaStream_t st;
};

template <typename T, typename P, int VEC, bool RESIDENT, int MODE>
cudaError_t launch(const Args& a) {
  auto kernel = group_norm_silu_kernel<T, P, VEC, RESIDENT, MODE>;
  static bool prepared[64] = {};
  cudaError_t err = prepare(kernel, a.device, prepared);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(sizeof(T), VEC, a.cs, a.gsize, a.chunk_rows, a.rpp, a.threads,
                                 a.cluster, RESIDENT);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  Config c;
  make_config(c, a.cluster, a.C / a.cs, a.B, a.threads, smem, a.st);
  bool ok = false;
  err = co_scheduled(kernel, c, a.device, ok);
  if (err != cudaSuccess) return err;
  if (!ok) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&c.cfg, kernel, static_cast<const T*>(a.x),
                            static_cast<const P*>(a.scale), static_cast<const P*>(a.bias),
                            static_cast<T*>(a.out), a.stats, a.mean_rstd, a.S, a.C, a.gsize, a.cs,
                            a.chunk_rows, a.rpp, a.eps, a.silu);
}

template <typename T, typename P, int MODE>
cudaError_t launch_variant(int vec, int resident, const Args& a) {
  constexpr int WIDE = 16 / sizeof(T);
  if (vec == WIDE && resident) return launch<T, P, WIDE, true, MODE>(a);
  if (vec == WIDE) return launch<T, P, WIDE, false, MODE>(a);
  if (vec == 1 && resident) return launch<T, P, 1, true, MODE>(a);
  if (vec == 1) return launch<T, P, 1, false, MODE>(a);
  return cudaErrorInvalidValue;
}

// The plan's invariants (see tq_group_norm_silu).
bool valid_plan(int B, int S, int C, int G, int cs, int cluster, int chunk_rows, int rpp,
                int threads, int vec) {
  return !(B < 1 || B > 65535 || S < 1 || C < 1 || G < 1 || C % G != 0 || cs < 1 ||
           C % cs != 0 || cs % (C / G) != 0 || vec < 1 || cs % vec != 0 || cluster < 1 ||
           cluster > MAX_CLUSTER || rpp < 1 || (long long)chunk_rows * cluster < S ||
           (long long)chunk_rows * (cluster - 1) >= S || threads % 32 != 0 || threads > 1024 ||
           rpp * (cs / vec) > threads);
}

// The launch of `a` for the (x, params) dtype pair: (f32, f32), (bf16, bf16) or (bf16, f32).
template <int MODE>
int launch_dtypes(int x_dtype, int p_dtype, int vec, int resident, const Args& a) {
  cudaError_t err = tq::use_device(a.device);
  if (err != cudaSuccess) return (int)err;
  if (x_dtype == 0 && p_dtype == 0) err = launch_variant<float, float, MODE>(vec, resident, a);
  else if (x_dtype == 1 && p_dtype == 1) err = launch_variant<bf16, bf16, MODE>(vec, resident, a);
  else if (x_dtype == 1 && p_dtype == 0) err = launch_variant<bf16, float, MODE>(vec, resident, a);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

// The backward's launch: `a` as the forward's (out is dx, stats the partials) and dy.
template <typename T, typename P, int VEC, bool RESIDENT>
cudaError_t launch_bwd(const Args& a, const void* dy) {
  auto kernel = group_norm_silu_bwd_kernel<T, P, VEC, RESIDENT>;
  static bool prepared[64] = {};
  cudaError_t err = prepare(kernel, a.device, prepared);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bwd_bytes(sizeof(T), VEC, a.cs, a.gsize, a.chunk_rows, a.rpp,
                                     a.threads, a.cluster, RESIDENT);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  Config c;
  make_config(c, a.cluster, a.C / a.cs, a.B, a.threads, smem, a.st);
  bool ok = false;
  err = co_scheduled(kernel, c, a.device, ok);
  if (err != cudaSuccess) return err;
  if (!ok) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&c.cfg, kernel, static_cast<const T*>(a.x), static_cast<const T*>(dy),
                            static_cast<const P*>(a.scale), static_cast<const P*>(a.bias),
                            static_cast<T*>(a.out), a.stats, a.S, a.C, a.gsize, a.cs,
                            a.chunk_rows, a.rpp, a.eps, a.silu);
}

template <typename T, typename P>
cudaError_t launch_bwd_variant(int vec, int resident, const Args& a, const void* dy) {
  constexpr int WIDE = 16 / sizeof(T);
  if (vec == WIDE && resident) return launch_bwd<T, P, WIDE, true>(a, dy);
  if (vec == WIDE) return launch_bwd<T, P, WIDE, false>(a, dy);
  if (vec == 1 && resident) return launch_bwd<T, P, 1, true>(a, dy);
  if (vec == 1) return launch_bwd<T, P, 1, false>(a, dy);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; (x, params) may be (f32, f32), (bf16, bf16) or
// (bf16, f32), the pairs the models use.  x and out are contiguous (B, S, C); scale and bias
// (C,).  The plan (ops/group_norm.py:group_norm_plan): slice_channels (whole groups, dividing
// C, a multiple of vec), cluster (1-16 blocks over S), chunk_rows (cluster * chunk_rows >= S >
// (cluster - 1) * chunk_rows), rows_per_pass (threads per vector column), threads (a multiple
// of 32, at least rows_per_pass * slice_channels / vec), vec (16 / element size for 16-byte
// accesses, else 1) and resident (the chunk stays in shared memory).  Returns the CUDA error
// code of the launch (cudaErrorLaunchOutOfResources where the card cannot co-schedule the
// cluster).
extern "C" int tq_group_norm_silu(const void* x, const void* scale, const void* bias, void* out,
                                  int x_dtype, int p_dtype, int B, int S, int C, int G, float eps,
                                  int silu, int slice_channels, int cluster, int chunk_rows,
                                  int rows_per_pass, int threads, int vec, int resident,
                                  int device, void* stream) {
  if (!valid_plan(B, S, C, G, slice_channels, cluster, chunk_rows, rows_per_pass, threads, vec))
    return (int)cudaErrorInvalidValue;
  const Args a{x, scale, bias, out, nullptr, nullptr, B, S, C, C / G, slice_channels, cluster,
               chunk_rows, rows_per_pass, threads, eps, silu, device,
               static_cast<cudaStream_t>(stream)};
  return launch_dtypes<0>(x_dtype, p_dtype, vec, resident, a);
}

// The backward of tq_group_norm_silu: from x and dy (both contiguous (B, S, C) of x's dtype) and
// the forward's scale, bias, eps and silu, dx into dx (B, S, C) and each block's per-channel
// partials into part (B, cluster, 2, C) float32: [.., 0, c] the sum of dy' * xhat and [.., 1, c]
// the sum of dy' over the block's rows, dy' the gradient before the SiLU; dscale and dbias are
// their sums over the first two axes.  The plan is group_norm_plan(..., backward=True)'s, with
// threads at most 512.  Returns the CUDA error code of the launch.
extern "C" int tq_group_norm_silu_backward(const void* x, const void* dy, const void* scale,
                                           const void* bias, void* dx, float* part, int x_dtype,
                                           int p_dtype, int B, int S, int C, int G, float eps,
                                           int silu, int slice_channels, int cluster,
                                           int chunk_rows, int rows_per_pass, int threads,
                                           int vec, int resident, int device, void* stream) {
  if (!valid_plan(B, S, C, G, slice_channels, cluster, chunk_rows, rows_per_pass, threads, vec) ||
      threads > MAX_BWD_THREADS)
    return (int)cudaErrorInvalidValue;
  const Args a{x, scale, bias, dx, part, nullptr, B, S, C, C / G, slice_channels, cluster,
               chunk_rows, rows_per_pass, threads, eps, silu, device,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = tq::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (x_dtype == 0 && p_dtype == 0)
    err = launch_bwd_variant<float, float>(vec, resident, a, dy);
  else if (x_dtype == 1 && p_dtype == 1)
    err = launch_bwd_variant<bf16, bf16>(vec, resident, a, dy);
  else if (x_dtype == 1 && p_dtype == 0)
    err = launch_bwd_variant<bf16, float>(vec, resident, a, dy);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// The statistics alone: stats (B, G, 3) float32 receives each (sample, group)'s element count,
// mean and M2 (the sum of squared deviations from that mean) over x's S rows, in the plan of
// tq_group_norm_silu for the dtype pair (x_dtype, x_dtype).
extern "C" int tq_group_norm_stats(const void* x, float* stats, int x_dtype, int B, int S, int C,
                                   int G, int slice_channels, int cluster, int chunk_rows,
                                   int rows_per_pass, int threads, int vec, int resident,
                                   int device, void* stream) {
  if (!valid_plan(B, S, C, G, slice_channels, cluster, chunk_rows, rows_per_pass, threads, vec))
    return (int)cudaErrorInvalidValue;
  const Args a{x, nullptr, nullptr, nullptr, stats, nullptr, B, S, C, C / G, slice_channels,
               cluster, chunk_rows, rows_per_pass, threads, 0.f, 0, device,
               static_cast<cudaStream_t>(stream)};
  return launch_dtypes<1>(x_dtype, x_dtype, vec, resident, a);
}

// The normalisation alone: out = (x - mean) * rstd * scale + bias, then the SiLU when `silu`,
// with mean_rstd (B, G, 2) float32 holding each (sample, group)'s mean and rstd; the arguments
// otherwise as tq_group_norm_silu's.
extern "C" int tq_group_norm_apply(const void* x, const float* mean_rstd, const void* scale,
                                   const void* bias, void* out, int x_dtype, int p_dtype, int B,
                                   int S, int C, int G, int silu, int slice_channels, int cluster,
                                   int chunk_rows, int rows_per_pass, int threads, int vec,
                                   int resident, int device, void* stream) {
  if (!valid_plan(B, S, C, G, slice_channels, cluster, chunk_rows, rows_per_pass, threads, vec))
    return (int)cudaErrorInvalidValue;
  const Args a{x, scale, bias, out, nullptr, mean_rstd, B, S, C, C / G, slice_channels, cluster,
               chunk_rows, rows_per_pass, threads, 0.f, silu, device,
               static_cast<cudaStream_t>(stream)};
  return launch_dtypes<2>(x_dtype, p_dtype, vec, resident, a);
}

// The largest cluster (1-16 blocks) of the bf16 resident kernel with 512 threads and 227 KB of
// shared memory a block that the card co-schedules, into *limit: the plan keeps every cluster
// within it.  Returns the CUDA error code.
extern "C" int tq_group_norm_cluster_limit(int device, int* limit) {
  cudaError_t err = tq::use_device(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = group_norm_silu_kernel<bf16, bf16, 8, true, 0>;
  static bool prepared[64] = {};
  err = prepare(kernel, device, prepared);
  if (err != cudaSuccess) return (int)err;
  *limit = 0;
  for (int cluster = MAX_CLUSTER; cluster >= 1; --cluster) {
    Config c;
    make_config(c, cluster, 1, 1, 512, MAX_SMEM, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &c.cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters > 0) {
      *limit = cluster;
      break;
    }
  }
  return (int)cudaSuccess;
}

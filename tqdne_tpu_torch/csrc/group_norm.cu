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

template <typename T, typename P, int VEC, bool RESIDENT>
__global__ void __launch_bounds__(1024)
    group_norm_silu_kernel(const T* __restrict__ x, const P* __restrict__ scale,
                           const P* __restrict__ bias, T* __restrict__ out, int S, int C,
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

  // pass 1: the chunk's group means m1
  float acc[VEC];
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
  float acc2[VEC], mu[VEC];
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
    fin[j] = mean;
    fin[ng + j] = rsqrtf(m2 / cnt + eps);
  }
  __syncthreads();

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

template <typename T, typename P, int VEC, bool RESIDENT>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* out, int B, int S,
                   int C, int gsize, int cs, int cluster, int chunk_rows, int rpp, int threads,
                   float eps, int silu, int device, cudaStream_t st) {
  auto kernel = group_norm_silu_kernel<T, P, VEC, RESIDENT>;
  static bool prepared[64] = {};
  cudaError_t err = prepare(kernel, device, prepared);
  if (err != cudaSuccess) return err;
  const size_t smem =
      smem_bytes(sizeof(T), VEC, cs, gsize, chunk_rows, rpp, threads, cluster, RESIDENT);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  Config c;
  make_config(c, cluster, C / cs, B, threads, smem, st);
  bool ok = false;
  err = co_scheduled(kernel, c, device, ok);
  if (err != cudaSuccess) return err;
  if (!ok) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&c.cfg, kernel, static_cast<const T*>(x),
                            static_cast<const P*>(scale), static_cast<const P*>(bias),
                            static_cast<T*>(out), S, C, gsize, cs, chunk_rows, rpp, eps, silu);
}

template <typename T, typename P>
cudaError_t launch_variant(int vec, int resident, const void* x, const void* scale,
                           const void* bias, void* out, int B, int S, int C, int gsize, int cs,
                           int cluster, int chunk_rows, int rpp, int threads, float eps, int silu,
                           int device, cudaStream_t st) {
  constexpr int WIDE = 16 / sizeof(T);
  if (vec == WIDE && resident)
    return launch<T, P, WIDE, true>(x, scale, bias, out, B, S, C, gsize, cs, cluster,
                                    chunk_rows, rpp, threads, eps, silu, device, st);
  if (vec == WIDE)
    return launch<T, P, WIDE, false>(x, scale, bias, out, B, S, C, gsize, cs, cluster,
                                     chunk_rows, rpp, threads, eps, silu, device, st);
  if (vec == 1 && resident)
    return launch<T, P, 1, true>(x, scale, bias, out, B, S, C, gsize, cs, cluster, chunk_rows,
                                 rpp, threads, eps, silu, device, st);
  if (vec == 1)
    return launch<T, P, 1, false>(x, scale, bias, out, B, S, C, gsize, cs, cluster, chunk_rows,
                                  rpp, threads, eps, silu, device, st);
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
  const int cs = slice_channels;
  if (B < 1 || B > 65535 || S < 1 || C < 1 || G < 1 || C % G != 0 || cs < 1 || C % cs != 0 ||
      cs % (C / G) != 0 || vec < 1 || cs % vec != 0 || cluster < 1 || cluster > MAX_CLUSTER ||
      rows_per_pass < 1 || (long long)chunk_rows * cluster < S ||
      (long long)chunk_rows * (cluster - 1) >= S || threads % 32 != 0 || threads > 1024 ||
      rows_per_pass * (cs / vec) > threads)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = tq::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gsize = C / G;
  if (x_dtype == 0 && p_dtype == 0)
    return (int)launch_variant<float, float>(vec, resident, x, scale, bias, out, B, S, C, gsize,
                                             cs, cluster, chunk_rows, rows_per_pass, threads,
                                             eps, silu, device, st);
  if (x_dtype == 1 && p_dtype == 1)
    return (int)launch_variant<bf16, bf16>(vec, resident, x, scale, bias, out, B, S, C, gsize,
                                           cs, cluster, chunk_rows, rows_per_pass, threads, eps,
                                           silu, device, st);
  if (x_dtype == 1 && p_dtype == 0)
    return (int)launch_variant<bf16, float>(vec, resident, x, scale, bias, out, B, S, C, gsize,
                                            cs, cluster, chunk_rows, rows_per_pass, threads, eps,
                                            silu, device, st);
  return (int)cudaErrorInvalidValue;
}

// The largest cluster (1-16 blocks) of the bf16 resident kernel with 512 threads and 227 KB of
// shared memory a block that the card co-schedules, into *limit: the plan keeps every cluster
// within it.  Returns the CUDA error code.
extern "C" int tq_group_norm_cluster_limit(int device, int* limit) {
  cudaError_t err = tq::use_device(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = group_norm_silu_kernel<bf16, bf16, 8, true>;
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

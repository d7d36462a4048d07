// Fused GroupNorm + affine + optional SiLU over channels-last (B, S, C)
// activations, f32 statistics, input and output in the model dtype.
//
// Replaces tqdne_tpu/ops/group_norm.py:_gn_silu_kernel (one TPU program per
// sample holding the whole (S, C) slab in VMEM).  On the H100 a sample is up
// to 4 MB against 227 KB of shared memory, and B programs cannot fill 132
// SMs, so the work is split three ways:
//
//   1. gn_partial_kernel: grid (chunks, B); each block reduces a chunk of rows
//      of one sample to Welford moments (count, mean, M2) per group;
//   2. gn_finalize_kernel: one thread per (sample, group) merges the chunk
//      moments (Chan et al.) into mean and rstd;
//   3. gn_apply_kernel: same grid as (1); normalise, affine, SiLU, store.
//
// Bound: bytes.  The function reads x once and writes y once (plus C-sized
// parameters); passes 1 and 3 each stream x, so the kernel moves 3 bytes of x
// traffic per 2 the bound counts.  Every thread owns one channel and walks
// rows, so a warp's loads are contiguous in C, and the per-thread Welford
// update keeps the variance free of E[x^2] - mean^2 cancellation (the math of
// the reference's two-pass _reference, not of the TPU kernel's one-pass sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Moments {
  float n, mean, m2;
};

__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float frac = b.n / n;
  Moments out;
  out.n = n;
  out.mean = a.mean + delta * frac;
  out.m2 = a.m2 + b.m2 + delta * delta * a.n * frac;
  return out;
}

// blockDim.x == C * rows_per_iter: thread t owns channel t % C and rows
// r0 + t / C, r0 + t / C + rows_per_iter, ... of its chunk.
template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int S,
                                  int C, int G, int rows_per_chunk) {
  extern __shared__ float smem[];
  const int nthreads = blockDim.x;
  float* s_n = smem;
  float* s_mean = smem + nthreads;
  float* s_m2 = smem + 2 * nthreads;

  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = tid % C;
  const int rows_per_iter = nthreads / C;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(S, r_begin + rows_per_chunk);
  const T* xb = x + (size_t)b * S * C;

  Moments acc = {0.f, 0.f, 0.f};
  for (int r = r_begin + tid / C; r < r_end; r += rows_per_iter) {
    const float v = to_float(xb[(size_t)r * C + c]);
    acc.n += 1.f;
    const float d = v - acc.mean;
    acc.mean += d / acc.n;
    acc.m2 += d * (v - acc.mean);
  }
  s_n[tid] = acc.n;
  s_mean[tid] = acc.mean;
  s_m2[tid] = acc.m2;
  __syncthreads();

  const int gsize = C / G;
  for (int g = tid; g < G; g += nthreads) {
    Moments m = {0.f, 0.f, 0.f};
    for (int ro = 0; ro < rows_per_iter; ++ro) {
      for (int cc = g * gsize; cc < (g + 1) * gsize; ++cc) {
        const int i = ro * C + cc;
        m = merge(m, Moments{s_n[i], s_mean[i], s_m2[i]});
      }
    }
    float* p = partial + ((size_t)(b * gridDim.x + chunk) * G + g) * 3;
    p[0] = m.n;
    p[1] = m.mean;
    p[2] = m.m2;
  }
}

__global__ void gn_finalize_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                                   int B, int G, int nchunks, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // b * G + g
  if (i >= B * G) return;
  const int b = i / G;
  const int g = i % G;
  Moments m = {0.f, 0.f, 0.f};
  for (int k = 0; k < nchunks; ++k) {
    const float* p = partial + ((size_t)(b * nchunks + k) * G + g) * 3;
    m = merge(m, Moments{p[0], p[1], p[2]});
  }
  stats[2 * i] = m.mean;
  stats[2 * i + 1] = rsqrtf(m.m2 / m.n + eps);
}

template <typename T, typename P>
__global__ void gn_apply_kernel(const T* __restrict__ x, const P* __restrict__ scale,
                                const P* __restrict__ bias, const float* __restrict__ stats,
                                T* __restrict__ out, int S, int C, int G, int rows_per_chunk,
                                int silu) {
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int c = tid % C;
  const int rows_per_iter = blockDim.x / C;
  const int r_begin = blockIdx.x * rows_per_chunk;
  const int r_end = min(S, r_begin + rows_per_chunk);
  const int g = c / (C / G);
  const float mean = stats[2 * (b * G + g)];
  const float rstd = stats[2 * (b * G + g) + 1];
  const float w = to_float(scale[c]);
  const float bb = to_float(bias[c]);
  const size_t base = (size_t)b * S * C;
  for (int r = r_begin + tid / C; r < r_end; r += rows_per_iter) {
    const size_t i = base + (size_t)r * C + c;
    float y = (to_float(x[i]) - mean) * rstd;
    y = y * w + bb;
    if (silu) y = y / (1.f + expf(-y));
    out[i] = from_float<T>(y);
  }
}

template <typename T, typename P>
int launch(const void* x, const void* scale, const void* bias, void* out, float* partial,
           float* stats, int B, int S, int C, int G, float eps, int silu, int rows_per_iter,
           int rows_per_chunk, cudaStream_t stream) {
  const int nchunks = (S + rows_per_chunk - 1) / rows_per_chunk;
  const dim3 grid(nchunks, B);
  const int threads = C * rows_per_iter;
  gn_partial_kernel<T><<<grid, threads, 3 * threads * sizeof(float), stream>>>(
      static_cast<const T*>(x), partial, S, C, G, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize_kernel<<<(B * G + 255) / 256, 256, 0, stream>>>(partial, stats, B, G, nchunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply_kernel<T, P><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const P*>(scale), static_cast<const P*>(bias), stats,
      static_cast<T*>(out), S, C, G, rows_per_chunk, silu);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; (x, params) may be (f32, f32),
// (bf16, bf16) or (bf16, f32), the pairs the models use.  `partial` holds
// B * ceil(S / rows_per_chunk) * G * 3 floats, `stats` B * G * 2 floats.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int tq_group_norm_silu(const void* x, const void* scale, const void* bias, void* out,
                                  void* partial, void* stats, int x_dtype, int p_dtype, int B,
                                  int S, int C, int G, float eps, int silu, int rows_per_iter,
                                  int rows_per_chunk, int device, void* stream) {
  if (B < 1 || S < 1 || C < 1 || G < 1 || C % G != 0 || C * rows_per_iter > 1024 ||
      rows_per_iter < 1 || rows_per_chunk < rows_per_iter)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* st_ = static_cast<float*>(stats);
  if (x_dtype == 0 && p_dtype == 0)
    return launch<float, float>(x, scale, bias, out, part, st_, B, S, C, G, eps, silu,
                                rows_per_iter, rows_per_chunk, st);
  if (x_dtype == 1 && p_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, out, part, st_, B, S, C, G, eps,
                                                silu, rows_per_iter, rows_per_chunk, st);
  if (x_dtype == 1 && p_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, bias, out, part, st_, B, S, C, G, eps, silu,
                                        rows_per_iter, rows_per_chunk, st);
  return (int)cudaErrorInvalidValue;
}

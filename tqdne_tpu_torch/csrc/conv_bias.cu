// A convolution's per-channel epilogue, in place: y[b, c, ...] += bias[c] (+ shift[b, c]), the
// sum taken in f32 as (y + bias) + shift and rounded once to y's dtype.  cuDNN runs without its
// bias; this adds the bias and, after a ResBlock's first convolution, the projected time and
// condition embedding in the same pass.
//
// No TPU kernel is replaced: the JAX package leaves the bias to XLA, which fuses it into the
// convolution.  In PyTorch the bias is ATen's add_ of bias.view(1, C, 1, 1) after cuDNN, and
// the embedding a second broadcast add; over a channels-last output neither broadcast is
// contiguous, so both take TensorIterator's strided, non-vectorized kernel.
//
// Bound: bytes.  The function reads y once and writes it once (plus C or B x C addends), one or
// two adds an element.  The design moves those bytes in 16-byte accesses, with the addends in
// registers:
// - The vector is laid along whichever axis of y is contiguous (the wrapper,
//   ops/conv_bias.py:conv_bias_plan, reads it from the strides):
//   - channels innermost (2D channels-last, any C): each sample is a flat run of S x C
//     elements whose channel is the index mod C.  The grid's threads a sample times VEC is a
//     multiple of C, so a thread meets the same VEC channels in every step of its grid-stride
//     loop: it reads their bias once, and their shift once a sample.  C need not divide VEC
//     (C = 3 or 6 packs 8 elements of 3 channels into one vector).
//   - rows of one channel (channels-first (B, C, S)): a warp owns a row, reads its bias and
//     shift once and walks the row in vectors.
// - VEC is 16 bytes' worth where the run (S x C, or S) and y's address allow, else 8, 4 or 2
//   bytes' worth (S = 508 in bf16 takes 8-byte vectors), else one element.
// - Each thread keeps UNROLL vectors in flight (all loads before any store): 256 threads a
//   block, about two waves of blocks on 132 SMs, and a grid-stride loop over the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int UNROLL = 4;
constexpr int THREADS = 256;   // a block's threads (the wrapper's plan)
constexpr int MIN_BLOCKS = 4;  // blocks an SM at least: 64 registers a thread

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void round_to(float v, float& out) { out = v; }
__device__ __forceinline__ void round_to(float v, bf16& out) { out = __float2bfloat16(v); }

// y = T(float(y) + b (+ s)) for the elements of one pack.
template <typename T, int VEC, bool SHIFT>
__device__ __forceinline__ void add_pack(Pack<T, VEC>& r, const Pack<T, VEC>& b,
                                         const Pack<T, VEC>& s) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float t = to_float(r.v[e]) + to_float(b.v[e]);
    if constexpr (SHIFT) t += to_float(s.v[e]);
    round_to(t, r.v[e]);
  }
}

// The packs first, first + step, ... before `end` of p, each element e of a pack plus b.v[e] and,
// with SHIFT, s.v[e]: UNROLL packs loaded before any is stored, then the rest one at a time.
// The addends stay packed in y's dtype (bf16 values widen exactly): a bf16 thread holds 16 + 8
// registers of data.
template <typename T, int VEC, bool SHIFT>
__device__ __forceinline__ void add_packs(Pack<T, VEC>* p, int first, int step, int end,
                                          const Pack<T, VEC>& b, const Pack<T, VEC>& s) {
  int v = first;
  for (; v + (UNROLL - 1) * step < end; v += UNROLL * step) {
    Pack<T, VEC> r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) r[u] = p[v + u * step];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      add_pack<T, VEC, SHIFT>(r[u], b, s);
      p[v + u * step] = r[u];
    }
  }
  for (; v < end; v += step) {
    Pack<T, VEC> r = p[v];
    add_pack<T, VEC, SHIFT>(r, b, s);
    p[v] = r;
  }
}

// The VEC addends of channels c0, c0 + 1, ... (mod C) from `a`: one load where they are a
// whole aligned pack (C a multiple of VEC), else element by element.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> channel_pack(const T* a, int c0, int C) {
  Pack<T, VEC> out;
  if (C % VEC == 0 && reinterpret_cast<unsigned long long>(a) % sizeof(out) == 0)
    return *reinterpret_cast<const Pack<T, VEC>*>(a + c0);
  int c = c0;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    out.v[e] = a[c];
    if (++c == C) c = 0;
  }
  return out;
}

// Channels innermost: B samples of n = S x C elements; grid (per-sample blocks, samples).
template <typename T, int VEC, bool SHIFT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    bias_channels_kernel(T* __restrict__ y, const T* __restrict__ bias,
                         const T* __restrict__ shift, long long B, long long n, int C) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;  // step * VEC % C == 0
  const int c0 = (int)((long long)t * VEC % C);  // the channel of the thread's first element
  const Pack<T, VEC> b = channel_pack<T, VEC>(bias, c0, C);
  Pack<T, VEC> s = b;  // unread without SHIFT
  for (long long smp = blockIdx.y; smp < B; smp += gridDim.y) {
    if constexpr (SHIFT) s = channel_pack<T, VEC>(shift + smp * C, c0, C);
    add_packs<T, VEC, SHIFT>(reinterpret_cast<Pack<T, VEC>*>(y + smp * n), t, step,
                             (int)(n / VEC), b, s);
  }
}

// Rows of one channel: `rows` = B x C rows of S elements, row r of channel r % C; a warp a row.
template <typename T, int VEC, bool SHIFT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    bias_rows_kernel(T* __restrict__ y, const T* __restrict__ bias, const T* __restrict__ shift,
                     long long rows, long long S, int C) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = warp; r < rows; r += warps) {
    const T br = bias[r % C];
    T sr;
    if constexpr (SHIFT) sr = shift[r];
    else round_to(0.f, sr);
    Pack<T, VEC> b, s;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      b.v[e] = br;
      s.v[e] = sr;
    }
    add_packs<T, VEC, SHIFT>(reinterpret_cast<Pack<T, VEC>*>(y + r * S), lane, 32,
                             (int)(S / VEC), b, s);
  }
}

// Launches run on the caller's current device; switch only when y lives elsewhere.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

template <typename T, int VEC, bool SHIFT>
cudaError_t launch(void* y, const void* bias, const void* shift, int layout, long long B,
                   long long S, int C, dim3 grid, int threads, cudaStream_t st) {
  T* py = static_cast<T*>(y);
  const T* pb = static_cast<const T*>(bias);
  const T* ps = static_cast<const T*>(shift);
  if (layout == 0)
    bias_channels_kernel<T, VEC, SHIFT><<<grid, threads, 0, st>>>(py, pb, ps, B, S * C, C);
  else
    bias_rows_kernel<T, VEC, SHIFT><<<grid, threads, 0, st>>>(py, pb, ps, B * C, S, C);
  return cudaGetLastError();
}

template <typename T, bool SHIFT>
cudaError_t launch_vec(int vec, void* y, const void* bias, const void* shift, int layout,
                       long long B, long long S, int C, dim3 grid, int threads, cudaStream_t st) {
  switch (vec) {
    case 1: return launch<T, 1, SHIFT>(y, bias, shift, layout, B, S, C, grid, threads, st);
    case 2: return launch<T, 2, SHIFT>(y, bias, shift, layout, B, S, C, grid, threads, st);
    case 4: return launch<T, 4, SHIFT>(y, bias, shift, layout, B, S, C, grid, threads, st);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, 8, SHIFT>(y, bias, shift, layout, B, S, C, grid, threads, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (B, C, S) channels-first (layout 1) or (B, S, C) channels-innermost (layout 0), of dtype 0
// (float32) or 1 (bfloat16), plus bias (C,) and, unless shift is null, shift (B, C), both of
// y's dtype and contiguous; in place.  vec: elements a thread moves at once (1, 2, 4, or 8 in
// bf16), dividing the run (S x C for layout 0, S for layout 1), with y aligned to vec elements.
// Grid (blocks_x, blocks_y) of `threads` threads (a multiple of 32, at most 256); layout 0 needs
// blocks_x x threads x vec to be a multiple of C.  Returns the CUDA error code of the launch.
extern "C" int tq_conv_bias_add(void* y, const void* bias, const void* shift, int dtype,
                                int layout, long long B, long long S, int C, int vec,
                                int blocks_x, int blocks_y, int threads, int device,
                                void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const long long run = layout == 0 ? S * C : S;
  if (dtype < 0 || dtype > 1 || layout < 0 || layout > 1 || B < 1 || S < 1 || C < 1 ||
      vec < 1 || vec * esize > 16 || run % vec || reinterpret_cast<unsigned long long>(y) %
      (vec * esize) || threads < 32 || threads > THREADS || threads % 32 ||
      blocks_x < 1 || blocks_y < 1 || blocks_y > 65535 ||
      run / vec + 4LL * blocks_x * threads >= (1LL << 31) ||
      (layout == 0 && (long long)blocks_x * threads * vec % C))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks_x, blocks_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = shift ? launch_vec<float, true>(vec, y, bias, shift, layout, B, S, C, grid, threads, st)
                : launch_vec<float, false>(vec, y, bias, shift, layout, B, S, C, grid, threads,
                                           st);
  else
    err = shift ? launch_vec<bf16, true>(vec, y, bias, shift, layout, B, S, C, grid, threads, st)
                : launch_vec<bf16, false>(vec, y, bias, shift, layout, B, S, C, grid, threads, st);
  return (int)err;
}

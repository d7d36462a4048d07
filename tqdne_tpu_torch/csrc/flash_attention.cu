// Flash-attention forward over (B, L, H, D) tensors, D <= 128.
//
// Replaces tqdne_tpu/ops/flash_attention.py:_attention_kernel (reached via
// _flash_forward).  Same numerics: q and k are both scaled by
// d^-1/4 * sqrt(log2 e), the softmax runs in base 2 with f32 running max,
// denominator and accumulator, masked logits are -1e30, the output divides by
// max(l, 1e-30) and the optional log-sum-exp is written in base 2.
//
// Design: one block per (q-tile of 16 rows, batch*head).  The TPU kernel's
// sequential k-block grid axis becomes a loop inside the block that carries
// (m, l, acc) in registers: 8 threads share a query row, each holding up to 16
// accumulator columns.  K and V tiles of 32 keys are staged in shared memory
// as f32.  The ragged key edge is masked inside the loop (only the keys that
// exist are multiplied), so the 16-token UNet attention does 16 keys of work
// where the TPU kernel pads to 128; a causal block stops at its last query.
// Inputs are read through their (batch, token, head) strides, so q, k and v
// can be strided views of one fused qkv projection.
//
// Bound: at the UNet's 16 tokens (and the classifier's 256) the products are
// tiny and the kernel moves q, k, v and o once, so bytes bound it; the plain
// FMA loops (no tensor cores yet) bound it in operations at long sequences.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 16;               // query rows per block
constexpr int BK = 32;               // keys per shared-memory tile
constexpr int THREADS = 128;         // threads per block
constexpr int TPR = THREADS / BQ;    // threads per query row (8)
constexpr int MAX_D = 128;
constexpr int DPT = MAX_D / TPR;     // accumulator columns per thread (16)
constexpr int SPT = BK / TPR;        // scores per thread per tile (4)
constexpr float NEG_INF = -1e30f;

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

struct Strides {
  long long b, l, h;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int L, int H, int D, Strides qs_,
                     Strides ks_, Strides vs_, float scale, int causal) {
  extern __shared__ float smem[];
  const int DP = D + 1;                // padded row stride against bank conflicts
  float* qs = smem;                    // BQ x DP
  float* ks = qs + BQ * DP;            // BK x DP
  float* vs = ks + BK * DP;            // BK x D
  float* ps = vs + BK * D;             // BQ x (BK + 1)

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int q_pos = q0 + row;

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    const int pos = q0 + r;
    qs[r * DP + d] = pos < L ? to_float(qb[pos * qs_.l + d]) * scale : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  const int k_end = causal ? min(L, q0 + BQ) : L;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    const int kn = min(BK, k_end - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kn * D; e += THREADS) {
      const int r = e / D;
      const int d = e % D;
      const long long pos = k0 + r;
      ks[r * DP + d] = to_float(kb[pos * ks_.l + d]) * scale;
      vs[r * D + d] = to_float(vb[pos * vs_.l + d]);
    }
    __syncthreads();

    float s[SPT];
    float tile_max = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int j = lane + jj * TPR;
      float sv = NEG_INF;
      if (j < kn && (!causal || k0 + j <= q_pos)) {
        const float* qr = qs + row * DP;
        const float* kr = ks + j * DP;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        sv = dot;
      }
      s[jj] = sv;
      tile_max = fmaxf(tile_max, sv);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));

    const float m_next = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_next);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int j = lane + jj * TPR;
      const bool valid = j < kn && (!causal || k0 + j <= q_pos);
      const float p = valid ? exp2f(s[jj] - m_next) : 0.f;
      ps[row * (BK + 1) + j] = p;
      psum += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_next;
    __syncwarp();  // a row's probabilities are written and read by the same warp

    const float* pr = ps + row * (BK + 1);
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int d = lane + jd * TPR;
      if (d < D) {
        float a = acc[jd] * alpha;
        for (int j = 0; j < kn; ++j) a = fmaf(pr[j], vs[j * D + d], a);
        acc[jd] = a;
      }
    }
  }

  if (q_pos < L) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + (((long long)b * L + q_pos) * H + h) * D;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int d = lane + jd * TPR;
      if (d < D) orow[d] = from_float<T>(acc[jd] / denom);
    }
    if (lse != nullptr && lane == 0) lse[(long long)bh * L + q_pos] = m + log2f(denom);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q, k, v are indexed as
// base + b * s_b + l * s_l + h * s_h + d (unit stride in D); o is a contiguous
// (B, L, H, D) tensor of the same dtype; lse, when not null, a contiguous
// (B, H, L) float32 tensor.  Returns the CUDA error code of the launch.
extern "C" int tq_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int dtype, int B, int L, int H, int D,
                                      long long q_sb, long long q_sl, long long q_sh,
                                      long long k_sb, long long k_sl, long long k_sh,
                                      long long v_sb, long long v_sl, long long v_sh, float scale,
                                      int causal, int device, void* stream) {
  if (B < 1 || L < 1 || H < 1 || D < 1 || D > MAX_D || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  const size_t smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sl, q_sh}, ks{k_sb, k_sl, k_sh}, vs{v_sb, v_sl, v_sh};
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0) {
    flash_fwd_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse_f, L, H, D, qs, ks, vs, scale, causal);
  } else if (dtype == 1) {
    flash_fwd_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse_f, L, H, D, qs,
        ks, vs, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

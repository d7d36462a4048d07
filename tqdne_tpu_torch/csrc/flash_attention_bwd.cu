// Flash-attention backward over (B, L, H, D) tensors, D <= 128: two kernels.
//
// tq_flash_attention_bwd_dkdv replaces tqdne_tpu/ops/flash_attention.py:_bwd_dkdv_kernel and
// tq_flash_attention_bwd_dq replaces _bwd_dq_kernel (both reached via _flash_backward).  Same
// numerics: q and k are scaled by d^-1/4 * sqrt(log2 e); P is recomputed as exp2(S - lse) from
// the forward's base-2 log-sum-exp; dS = P * (dP - delta) with delta = rowsum(dO * O), which the
// wrapper computes; the base-2 chain rule's ln 2 and the pre-scale are folded into the final
// write (dK = scale ln2 dS^T Q', dQ = scale ln2 dS K'; dV = P^T dO needs neither).  Keys and
// queries beyond L and, under the causal mask, keys after their query contribute exactly zero:
// they are never multiplied.  Accumulators are f32, outputs take the input dtype.
//
// Design: the TPU kernels' sequential inner grid axis becomes a loop inside the block.
// - dkdv: one block per (key tile of 16, batch*head).  The block stages its K and V tile in
//   shared memory as f32 and keeps the dK and dV accumulators in registers, 8 threads per key
//   row with up to 16 columns each.  It walks the query tiles (under the causal mask only those
//   that hold a query at or after its first key), staging Q, dO, lse and delta for each, and
//   forms the transposed scores P^T and dS^T for its keys, as the TPU kernel does.
// - dq: one block per (query tile of 16, batch*head), the mirror image: Q, dO, lse and delta
//   stay, the key tiles are walked (under the causal mask only up to the tile's last query).
// The products are FMA loops on f32 shared-memory tiles, with no tensor cores yet.  Inputs are
// read through their (batch, token, head) strides, so q, k and v can be strided views of one
// fused qkv projection.
//
// Bound: at the UNet's 16 tokens each block reads its tiles once and does 4 (dkdv) or 3 (dq)
// 16x16xD products, so bytes bound it; at long sequences the O(L^2 D) FMA loops without tensor
// cores bound it in operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 16;               // rows per tile: the block's own tile and each walked tile
constexpr int THREADS = 128;         // threads per block
constexpr int TPR = THREADS / BT;    // threads per row (8)
constexpr int MAX_D = 128;
constexpr int DPT = MAX_D / TPR;     // accumulator columns per thread (16)
constexpr int SPT = BT / TPR;        // scores per thread per tile (2)
constexpr int PS = BT + 1;           // padded row stride of the score tiles
constexpr float LN2 = 0.6931471805599453f;

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

// Rows [r0, r0 + n) of one (batch, head) slice of a strided operand, times mul, into a BT-row
// f32 tile with row stride ld; rows from n on are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base, long long sl, int r0,
                                          int n, int D, float mul) {
  for (int e = threadIdx.x; e < BT * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    dst[r * ld + d] = r < n ? to_float(base[(long long)(r0 + r) * sl + d]) * mul : 0.f;
  }
}

// Row `r` of a contiguous (B, L, H, D) output at (b, h).
template <typename T>
__device__ __forceinline__ T* out_row(T* base, int b, int pos, int h, int L, int H, int D) {
  return base + (((long long)b * L + pos) * H + h) * D;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int L, int H, int D, Strides qs_,
                          Strides ks_, Strides vs_, Strides os_, float scale, int causal) {
  extern __shared__ float smem[];
  const int DP = D + 1;                // padded row stride against bank conflicts
  float* kt = smem;                    // BT x DP: this block's keys, pre-scaled
  float* vt = kt + BT * DP;            // BT x DP: their values
  float* qt = vt + BT * DP;            // BT x DP: the walked query tile, pre-scaled
  float* ot = qt + BT * DP;            // BT x DP: its dO
  float* pt = ot + BT * DP;            // BT x PS: P^T (key row, query column)
  float* st = pt + BT * PS;            // BT x PS: dS^T
  float* lt = st + BT * PS;            // BT: the query tile's lse
  float* dt = lt + BT;                 // BT: its delta

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BT;
  const int kn = min(BT, L - k0);
  const int tid = threadIdx.x;
  const int row = tid / TPR;           // this thread's key row in the tile
  const int lane = tid % TPR;
  const int k_pos = k0 + row;

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* ob = dout + b * os_.b + h * os_.h;
  const float* lb = lse + (long long)bh * L;
  const float* db = delta + (long long)bh * L;
  load_tile(kt, DP, k + b * ks_.b + h * ks_.h, ks_.l, k0, kn, D, scale);
  load_tile(vt, DP, v + b * vs_.b + h * vs_.h, vs_.l, k0, kn, D, 1.f);

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  // under the causal mask, queries before this block's first key see none of it (query and
  // key tiles share BT, so the walk starts at the tile holding query k0)
  for (int q0 = causal ? k0 : 0; q0 < L; q0 += BT) {
    const int qn = min(BT, L - q0);
    __syncthreads();  // the previous tile's readers are done
    load_tile(qt, DP, qb, qs_.l, q0, qn, D, scale);
    load_tile(ot, DP, ob, os_.l, q0, qn, D, 1.f);
    if (tid < BT) {
      lt[tid] = tid < qn ? lb[q0 + tid] : 0.f;
      dt[tid] = tid < qn ? db[q0 + tid] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int i = lane + jj * TPR;  // query column
      float p = 0.f;
      float ds = 0.f;
      if (row < kn && i < qn && (!causal || k_pos <= q0 + i)) {
        const float* kr = kt + row * DP;
        const float* vr = vt + row * DP;
        const float* qr = qt + i * DP;
        const float* gr = ot + i * DP;
        float s = 0.f;
        float dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(kr[d], qr[d], s);
          dp = fmaf(vr[d], gr[d], dp);
        }
        p = exp2f(s - lt[i]);
        ds = p * (dp - dt[i]);
      }
      pt[row * PS + i] = p;
      st[row * PS + i] = ds;
    }
    __syncwarp();  // a key row's scores are written and read by the same warp

    const float* pr = pt + row * PS;
    const float* sr = st + row * PS;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int d = lane + jd * TPR;
      if (d < D) {
        float a = dv_acc[jd];
        float c = dk_acc[jd];
        for (int i = 0; i < qn; ++i) {
          a = fmaf(pr[i], ot[i * DP + d], a);
          c = fmaf(sr[i], qt[i * DP + d], c);
        }
        dv_acc[jd] = a;
        dk_acc[jd] = c;
      }
    }
  }

  if (row < kn) {
    const float fold = scale * LN2;
    T* dkr = out_row(dk, b, k_pos, h, L, H, D);
    T* dvr = out_row(dv, b, k_pos, h, L, H, D);
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int d = lane + jd * TPR;
      if (d < D) {
        dkr[d] = from_float<T>(dk_acc[jd] * fold);
        dvr[d] = from_float<T>(dv_acc[jd]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq, int L, int H, int D,
                        Strides qs_, Strides ks_, Strides vs_, Strides os_, float scale,
                        int causal) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* qt = smem;                    // BT x DP: this block's queries, pre-scaled
  float* ot = qt + BT * DP;            // BT x DP: their dO
  float* kt = ot + BT * DP;            // BT x DP: the walked key tile, pre-scaled
  float* vt = kt + BT * DP;            // BT x DP: its values
  float* st = vt + BT * DP;            // BT x PS: dS (query row, key column)

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BT;
  const int qn = min(BT, L - q0);
  const int tid = threadIdx.x;
  const int row = tid / TPR;           // this thread's query row in the tile
  const int lane = tid % TPR;
  const int q_pos = q0 + row;

  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  load_tile(qt, DP, q + b * qs_.b + h * qs_.h, qs_.l, q0, qn, D, scale);
  load_tile(ot, DP, dout + b * os_.b + h * os_.h, os_.l, q0, qn, D, 1.f);
  const float row_lse = row < qn ? lse[(long long)bh * L + q_pos] : 0.f;
  const float row_delta = row < qn ? delta[(long long)bh * L + q_pos] : 0.f;

  float dq_acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dq_acc[j] = 0.f;

  const int k_end = causal ? min(L, q0 + BT) : L;
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    const int kn = min(BT, k_end - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile(kt, DP, kb, ks_.l, k0, kn, D, scale);
    load_tile(vt, DP, vb, vs_.l, k0, kn, D, 1.f);
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int j = lane + jj * TPR;  // key column
      float ds = 0.f;
      if (row < qn && j < kn && (!causal || k0 + j <= q_pos)) {
        const float* qr = qt + row * DP;
        const float* gr = ot + row * DP;
        const float* kr = kt + j * DP;
        const float* vr = vt + j * DP;
        float s = 0.f;
        float dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(gr[d], vr[d], dp);
        }
        ds = exp2f(s - row_lse) * (dp - row_delta);
      }
      st[row * PS + j] = ds;
    }
    __syncwarp();  // a query row's scores are written and read by the same warp

    const float* sr = st + row * PS;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int d = lane + jd * TPR;
      if (d < D) {
        float a = dq_acc[jd];
        for (int j = 0; j < kn; ++j) a = fmaf(sr[j], kt[j * DP + d], a);
        dq_acc[jd] = a;
      }
    }
  }

  if (row < qn) {
    const float fold = scale * LN2;
    T* dqr = out_row(dq, b, q_pos, h, L, H, D);
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int d = lane + jd * TPR;
      if (d < D) dqr[d] = from_float<T>(dq_acc[jd] * fold);
    }
  }
}

bool bad_shape(int B, int L, int H, int D) {
  return B < 1 || L < 1 || H < 1 || D < 1 || D > MAX_D || B * H > 65535;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q, k, v and dout are indexed as
// base + b * s_b + l * s_l + h * s_h + d (unit stride in D); lse and delta are contiguous
// (B, H, L) float32 tensors; dk, dv and dq are contiguous (B, L, H, D) tensors of the input
// dtype.  `scale` is the q/k pre-scale d^-1/4 * sqrt(log2 e).  Each returns the CUDA error
// code of its launch.
extern "C" int tq_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int dtype, int B, int L, int H, int D, long long q_sb,
    long long q_sl, long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, float scale, int causal, int device, void* stream) {
  if (bad_shape(B, L, H, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  const size_t smem = sizeof(float) * (4 * BT * (D + 1) + 2 * BT * PS + 2 * BT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sl, q_sh}, ks{k_sb, k_sl, k_sh}, vs{v_sb, v_sl, v_sh},
      os{o_sb, o_sl, o_sh};
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (dtype == 0) {
    flash_bwd_dkdv_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse_f, delta_f, static_cast<float*>(dk),
        static_cast<float*>(dv), L, H, D, qs, ks, vs, os, scale, causal);
  } else if (dtype == 1) {
    flash_bwd_dkdv_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse_f,
        delta_f, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), L, H, D, qs,
        ks, vs, os, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int tq_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int dtype, int B, int L, int H, int D, long long q_sb,
    long long q_sl, long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, float scale, int causal, int device, void* stream) {
  if (bad_shape(B, L, H, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  const size_t smem = sizeof(float) * (4 * BT * (D + 1) + BT * PS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sl, q_sh}, ks{k_sb, k_sl, k_sh}, vs{v_sb, v_sl, v_sh},
      os{o_sb, o_sl, o_sh};
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (dtype == 0) {
    flash_bwd_dq_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse_f, delta_f, static_cast<float*>(dq), L, H, D, qs,
        ks, vs, os, scale, causal);
  } else if (dtype == 1) {
    flash_bwd_dq_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse_f,
        delta_f, static_cast<__nv_bfloat16*>(dq), L, H, D, qs, ks, vs, os, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

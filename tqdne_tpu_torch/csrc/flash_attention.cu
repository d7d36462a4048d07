// Flash-attention forward over (B, L, H, D) tensors, D <= 128.
//
// Replaces tqdne_tpu/ops/flash_attention.py:_attention_kernel (reached via
// _flash_forward).  Same numerics: the logits are (q k) * d^-1/2 * log2 e (the TPU kernel
// pre-scales q and k by d^-1/4 * sqrt(log2 e) each), the softmax runs in base 2 with f32
// running max, denominator and accumulator, masked logits are -1e30, the output divides by
// max(l, 1e-30) and the optional log-sum-exp is written in base 2.  Inputs are read through
// their (batch, token, head) strides, so q, k and v can be strided views of one fused qkv
// projection.
//
// bf16 (the sampling and training paths): flash_fwd_mma_kernel, on the tensor cores.
// - One warp per (batch*head, 16-query tile), 4 warps a block (mma_bf16.cuh's tiling): at
//   L <= 16 the warps take four heads, at longer L 64 consecutive queries of one head that
//   share each staged 64-key K/V tile, double-buffered.  The wrapper picks the variant from L.
// - q, k and v are staged as bf16 by 16-byte cp.async (zero rows past L, zero columns from D
//   to the head block of 32, 64 or 128, so every fragment loop is static), into rows padded
//   against ldmatrix bank conflicts.
// - S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 operands from ldmatrix, f32
//   accumulators).  S comes from the unscaled bf16 q and k, whose products are exact in f32,
//   and is scaled once by d^-1/2 log2 e.  The softmax stays in registers (row max and sum over
//   the 4-lane quad), and P goes from the S accumulators straight into the A fragments of
//   P V, split into bf16 hi + lo so that P keeps about 16 bits (one bf16 P alone would put a
//   2^-9 relative error on every probability, about the bf16 tolerance at values near zero).
// - The epilogue stages O through shared memory and writes 16-byte rows.
// Bound: at the UNet's 16 tokens a call moves q, k, v and o once (2.1 MB at batch 32, 4 heads
// of 128) for about 34 MFLOP, so bytes bound it; the design keeps those bytes at 16-byte width
// and one pass.  mma.sync, not wgmma: a wgmma tile has 64 rows per warpgroup and a head here
// has 16 queries, so it would be 3/4 padding or mix heads whose K differs; nor does the
// tensor-core rate bind at 16 tokens.  wgmma and TMA pay at the classifier's 256 tokens and
// the 1D UNet's 508, with the paths that run them.
//
// f32 (the checking dtype, never the main path's): flash_fwd_kernel, FMA loops on f32 shared
// tiles.  TF32 mma keeps about 3 decimal digits and would fail the f32 tolerance (1e-4) that
// the full-width f32 checks hold the kernels to.  One block per (16-query tile, batch*head);
// 8 threads share a query row, each holding up to 16 accumulator columns; K and V tiles of 32
// keys.  The ragged key edge is masked inside the loop, so L = 16 does 16 keys of work.

#include "mma_bf16.cuh"

namespace {

using tq::bf16;

constexpr int BQ = 16;               // query rows per block
constexpr int BK = 32;               // keys per shared-memory tile
constexpr int THREADS = 128;         // threads per block
constexpr int TPR = THREADS / BQ;    // threads per query row (8)
constexpr int MAX_D = 128;
constexpr int DPT = MAX_D / TPR;     // accumulator columns per thread (16)
constexpr int SPT = BK / TPR;        // scores per thread per tile (4)
constexpr float NEG_INF = tq::NEG_INF;

struct Strides {
  long long b, l, h;
};

__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int L, int H, int D, Strides qs_, Strides ks_, Strides vs_, float scale,
                     int causal) {
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

  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + h * ks_.h;
  const float* vb = v + b * vs_.b + h * vs_.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    const int pos = q0 + r;
    qs[r * DP + d] = pos < L ? qb[pos * qs_.l + d] * scale : 0.f;
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
      ks[r * DP + d] = kb[pos * ks_.l + d] * scale;
      vs[r * D + d] = vb[pos * vs_.l + d];
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
    float* orow = o + (((long long)b * L + q_pos) * H + h) * D;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int d = lane + jd * TPR;
      if (d < D) orow[d] = acc[jd] / denom;
    }
    if (lse != nullptr && lane == 0) lse[(long long)bh * L + q_pos] = m + log2f(denom);
  }
}

// HB: head dims up to HB (32, 64 or 128); WPH: warps per head (1 for L <= 16, else 4).
template <int HB, int WPH>
__global__ void __launch_bounds__(tq::THREADS)
    flash_fwd_mma_kernel(tq::View q, tq::View k, tq::View v, bf16* __restrict__ o,
                         float* __restrict__ lse, int BH, int H, int L, int D, float sl2,
                         int causal, int vec) {
  using namespace tq;
  constexpr int RS = HB + ROW_PAD;
  constexpr int ROWS = TILE * WPH;        // positions of one head in a stage
  constexpr int HPB = WARPS / WPH;        // heads per block
  constexpr int STAGES = WPH == 1 ? 1 : 2;
  constexpr int NT = ROWS / 8;            // key n-tiles of a stage, per warp
  constexpr int NO = HB / 8;              // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);           // STAGE_ROWS x RS
  bf16* ks = qs + STAGE_ROWS * RS;                         // STAGES x STAGE_ROWS x RS
  bf16* vs = ks + STAGES * STAGE_ROWS * RS;                // STAGES x STAGE_ROWS x RS

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh0 = blockIdx.y * HPB;
  const int pos0 = blockIdx.x * ROWS;     // the block's first query
  const int slot = warp / WPH;            // the warp's head in a stage
  const int qw = pos0 + (warp % WPH) * TILE;  // the warp's first query
  const int k_end = causal ? min(L, pos0 + ROWS) : L;
  const int n_tiles = (k_end + ROWS - 1) / ROWS;
  // warp w stages rows 16w .. 16w + 15 of every stage: its own queries, and keys
  // kr .. kr + 15 of each key tile of its head
  const int kr = (warp % WPH) * TILE;
  const int bh = bh0 + slot;
  const int batch = bh / H;
  const int h = bh - batch * H;
  const bool live = bh < BH;
  const bf16* qh = live ? q.p + batch * q.sb + h * q.sh : nullptr;
  const bf16* kh = live ? k.p + batch * k.sb + h * k.sh : nullptr;
  const bf16* vh = live ? v.p + batch * v.sb + h * v.sh : nullptr;
  const int own = warp * TILE * RS;

  stage_tile<HB>(qs + own, qh, q.p, q.sl, qw, L, D, vec);
  stage_tile<HB>(ks + own, kh, k.p, k.sl, kr, L, D, vec);
  stage_tile<HB>(vs + own, vh, v.p, v.sl, kr, L, D, vec);
  cp_async_commit();

  const bf16* qt = qs + own;  // the warp's own queries
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;       // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;               // this lane's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * ROWS;
    if (it + 1 < n_tiles) {  // only with two stages: fetch the next tile while this one runs
      const int nb = (it + 1) % STAGES * STAGE_ROWS * RS + own;
      stage_tile<HB>(ks + nb, kh, k.p, k.sl, k0 + ROWS + kr, L, D, vec);
      stage_tile<HB>(vs + nb, vh, v.p, v.sl, k0 + ROWS + kr, L, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int buf = (it % STAGES) * STAGE_ROWS * RS + slot * ROWS * RS;
    const bf16* kt = ks + buf;
    const bf16* vt = vs + buf;
    if (!causal || k0 <= qw + TILE - 1) {  // else every key of the tile follows the warp's queries
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HB / 16; ++kk) {
        unsigned a[4];
        load_a(a, qt, RS, kk * 16);
#pragma unroll
        for (int j2 = 0; j2 < NT / 2; ++j2) {
          unsigned b[4];
          load_b(b, kt + j2 * 16 * RS, RS, kk * 16);
          mma(s[2 * j2], a, b[0], b[1]);
          mma(s[2 * j2 + 1], a, b[2], b[3]);
        }
      }

      const int qa = qw + g;
      const int qb = qa + 8;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + j * 8 + 2 * t + e;
          const bool in = key < L;
          s[j][e] = in && (!causal || key <= qa) ? s[j][e] * sl2 : NEG_INF;
          s[j][2 + e] = in && (!causal || key <= qb) ? s[j][2 + e] * sl2 : NEG_INF;
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float alpha0 = exp2f(m0 - mx0);
      const float alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha0;
        acc[n][1] *= alpha0;
        acc[n][2] *= alpha1;
        acc[n][3] *= alpha1;
      }
      // every row holds a key at or before its query by now, so m is finite and a masked
      // logit's exp2(-1e30 - m) is exactly 0
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp2f(s[j][0] - m0);
        s[j][1] = exp2f(s[j][1] - m0);
        s[j][2] = exp2f(s[j][2] - m1);
        s[j][3] = exp2f(s[j][3] - m1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        unsigned hi[4], lo[4];
        to_a(s[2 * j2], s[2 * j2 + 1], hi, lo);
#pragma unroll
        for (int nd = 0; nd < HB / 16; ++nd) {
          unsigned b[4];
          load_b_trans(b, vt + j2 * 16 * RS, RS, nd * 16);
          mma(acc[2 * nd], hi, b[0], b[1]);
          mma(acc[2 * nd], lo, b[0], b[1]);
          mma(acc[2 * nd + 1], hi, b[2], b[3]);
          mma(acc[2 * nd + 1], lo, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the tile's readers are done before the next prefetch overwrites it
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float denom0 = fmaxf(l0, 1e-30f);
  const float denom1 = fmaxf(l1, 1e-30f);
  if (!live) return;
  if (lse != nullptr && t == 0) {
    if (qw + g < L) lse[(long long)bh * L + qw + g] = m0 + log2f(denom0);
    if (qw + g + 8 < L) lse[(long long)bh * L + qw + g + 8] = m1 + log2f(denom1);
  }
  // the warp's query rows of the stage are its own: reuse them for the output tile
  bf16* ot = qs + own;
  store_acc(ot, RS, acc, 1.f / denom0, 1.f / denom1);
  __syncwarp();
  write_tile<HB>(o + ((long long)batch * L * H + h) * D, (long long)H * D, ot, qw, L, D);
}

template <int HB, int WPH>
cudaError_t launch_mma(const tq::View& q, const tq::View& k, const tq::View& v, bf16* o,
                       float* lse, int B, int L, int H, int D, float scale, int causal, int vec,
                       cudaStream_t st) {
  constexpr int RS = HB + tq::ROW_PAD;
  constexpr int STAGES = WPH == 1 ? 1 : 2;
  constexpr int ROWS = tq::TILE * WPH;
  constexpr size_t smem = sizeof(bf16) * (1 + 2 * STAGES) * tq::STAGE_ROWS * RS;
  auto kernel = flash_fwd_mma_kernel<HB, WPH>;
  static bool opted_in[64] = {};
  const cudaError_t err = tq::opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  const int BH = B * H;
  const dim3 grid((L + ROWS - 1) / ROWS, (BH + tq::WARPS / WPH - 1) / (tq::WARPS / WPH));
  kernel<<<grid, tq::THREADS, smem, st>>>(q, k, v, o, lse, BH, H, L, D, scale * scale, causal,
                                          vec);
  return cudaGetLastError();
}

template <int HB>
cudaError_t launch_mma_hb(int warps_per_head, const tq::View& q, const tq::View& k,
                          const tq::View& v, bf16* o, float* lse, int B, int L, int H, int D,
                          float scale, int causal, int vec, cudaStream_t st) {
  if (warps_per_head == 1 && L <= tq::TILE)
    return launch_mma<HB, 1>(q, k, v, o, lse, B, L, H, D, scale, causal, vec, st);
  if (warps_per_head == 4)
    return launch_mma<HB, 4>(q, k, v, o, lse, B, L, H, D, scale, causal, vec, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q, k, v are indexed as
// base + b * s_b + l * s_l + h * s_h + d (unit stride in D); o is a contiguous
// (B, L, H, D) tensor of the same dtype; lse, when not null, a contiguous
// (B, H, L) float32 tensor.  bf16 only: head_block (32, 64 or 128, at least D) and
// warps_per_head (1, which needs L <= 16, or 4) pick the kernel's variant, and vec says that
// q, k, v and their (b, l, h) strides are 16-byte aligned (else the kernel loads 2 bytes at a
// time).  Returns the CUDA error code of the launch.
extern "C" int tq_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int dtype, int B, int L, int H, int D,
                                      long long q_sb, long long q_sl, long long q_sh,
                                      long long k_sb, long long k_sl, long long k_sh,
                                      long long v_sb, long long v_sl, long long v_sh, float scale,
                                      int causal, int device, void* stream, int head_block,
                                      int warps_per_head, int vec) {
  if (B < 1 || L < 1 || H < 1 || D < 1 || D > MAX_D || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = tq::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0) {
    const dim3 grid((L + BQ - 1) / BQ, B * H);
    const size_t smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
    const Strides qs{q_sb, q_sl, q_sh}, ks{k_sb, k_sl, k_sh}, vs{v_sb, v_sl, v_sh};
    flash_fwd_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse_f, L, H, D, qs, ks, vs, scale, causal);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || head_block < D) return (int)cudaErrorInvalidValue;
  const tq::View qv{static_cast<const bf16*>(q), q_sb, q_sl, q_sh};
  const tq::View kv{static_cast<const bf16*>(k), k_sb, k_sl, k_sh};
  const tq::View vv{static_cast<const bf16*>(v), v_sb, v_sl, v_sh};
  bf16* out = static_cast<bf16*>(o);
  switch (head_block) {
    case 32:
      return (int)launch_mma_hb<32>(warps_per_head, qv, kv, vv, out, lse_f, B, L, H, D, scale,
                                    causal, vec, st);
    case 64:
      return (int)launch_mma_hb<64>(warps_per_head, qv, kv, vv, out, lse_f, B, L, H, D, scale,
                                    causal, vec, st);
    case 128:
      return (int)launch_mma_hb<128>(warps_per_head, qv, kv, vv, out, lse_f, B, L, H, D, scale,
                                     causal, vec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

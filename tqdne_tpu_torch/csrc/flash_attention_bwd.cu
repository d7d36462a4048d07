// Flash-attention backward over (B, L, H, D) tensors, D <= 128: two kernels, dQ first.
//
// tq_flash_attention_bwd_dq replaces tqdne_tpu/ops/flash_attention.py:_bwd_dq_kernel and also
// forms delta = rowsum(dO * O) in f32, which the JAX package computes beside it
// (_flash_backward, the f32 product of its padded output); tq_flash_attention_bwd_dkdv
// replaces _bwd_dkdv_kernel and reads the delta dQ wrote.  Same numerics: the logits are
// (q k) * d^-1/2 * log2 e (the TPU kernels pre-scale q and k by d^-1/4 * sqrt(log2 e) each); P
// is recomputed as exp2(S - lse) from the forward's base-2 log-sum-exp; dS = P * (dP - delta);
// the base-2 chain rule's ln 2 and the pre-scales are folded into the final write (dK = scale
// ln2 dS^T Q', dQ = scale ln2 dS K'; dV = P^T dO needs neither).  Keys and queries beyond L
// and, under the causal mask, keys after their query contribute exactly zero.  Accumulators
// are f32, outputs take the input dtype.  Inputs are read through their (batch, token, head)
// strides, so q, k and v can be strided views of one fused qkv projection.
//
// bf16 (the training path): both on the tensor cores, built from mma_bf16.cuh as the forward
// is.  One warp per (batch*head, 16-row tile), 4 warps a block: at L <= 16 four heads, at
// longer L 64 consecutive rows of one head that share each walked 64-row tile, double-buffered
// with cp.async; the wrapper picks the variant (tensor_core_plan).
// - dK/dV (flash_bwd_dkdv_mma_kernel): the warp owns 16 keys, stages its K and V rows once and
//   walks tiles of Q, dO, lse and delta, under the causal mask only those at or after its first
//   key, skipping the 16-query slices that precede all of its keys.  Per slice: S^T = K Q^T and
//   dP^T = V dO^T (mma, f32), P^T = exp2(S^T d^-1/2 log2 e - lse) with masked entries exactly
//   0, dS^T = P^T (dP^T - delta); then dV += P^T dO and dK += dS^T Q, whose A operands come
//   from those accumulators in registers (split into bf16 hi + lo, as the forward's P) and
//   whose B operands are ldmatrix.trans loads of dO and Q.
// - dQ (flash_bwd_dq_mma_kernel), the mirror image: the warp owns 16 queries and stages their
//   Q, dO and O rows once.  While the first K/V tile is in flight it forms delta for its rows
//   (two lanes a row, 16-byte shared loads) and writes it out.  Per 16-key slice of the walked
//   tiles (under the causal mask only up to its last query): S = Q K^T and dP = dO V^T, P =
//   exp2(S d^-1/2 log2 e - lse), dS = P (dP - delta), then dQ += dS K with dS from registers
//   (hi + lo) and K through ldmatrix.trans.  The O tile holds the output rows at the end.
// - The unscaled Q and K leave both pre-scales and ln 2 to the final write: d^-1/2 log2 e ln 2.
// Bound: at the UNet's 16 tokens dK/dV reads q, k, v, dO, lse and delta once and writes dK and
// dV (12.6 MB at batch 128); dQ reads q, k, v, dO, O and lse and writes dQ and delta (12.6 MB):
// bytes bound both.  mma.sync and not wgmma for the forward's reason: a head has 16 rows, a
// wgmma tile 64.
//
// f32 (the checking dtype): FMA loops on f32 shared-memory tiles.  TF32 mma keeps about 3
// decimal digits, against f32 checks that hold every gradient element to 2e-3 relative and
// 2e-4 absolute.
// - dkdv: one block per (key tile of 16, batch*head).  The block stages its K and V tile in
//   shared memory as f32 and keeps the dK and dV accumulators in registers, 8 threads per key
//   row with up to 16 columns each.  It walks the query tiles (under the causal mask only those
//   that hold a query at or after its first key), staging Q, dO, lse and delta for each.
// - dq: one block per (query tile of 16, batch*head), the mirror image: Q, dO and lse stay,
//   delta is summed from dO and O by the row's 8 threads, the key tiles are walked (under the
//   causal mask only up to the tile's last query).

#include "mma_bf16.cuh"

namespace {

using tq::bf16;

constexpr int BT = 16;               // rows per tile: the block's own tile and each walked tile
constexpr int THREADS = 128;         // threads per block
constexpr int TPR = THREADS / BT;    // threads per row (8)
constexpr int MAX_D = 128;
constexpr int DPT = MAX_D / TPR;     // accumulator columns per thread (16)
constexpr int SPT = BT / TPR;        // scores per thread per tile (2)
constexpr int PS = BT + 1;           // padded row stride of the score tiles
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

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

// dq (f32): also forms delta = rowsum(dO * O) for its query rows and writes it.
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ o, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq, int L, int H, int D,
                        Strides qs_, Strides ks_, Strides vs_, Strides gs_, Strides os_,
                        float scale, int causal) {
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

  const float* kb = k + b * ks_.b + h * ks_.h;
  const float* vb = v + b * vs_.b + h * vs_.h;
  load_tile(qt, DP, q + b * qs_.b + h * qs_.h, qs_.l, q0, qn, D, scale);
  load_tile(ot, DP, dout + b * gs_.b + h * gs_.h, gs_.l, q0, qn, D, 1.f);
  const float row_lse = row < qn ? lse[(long long)bh * L + q_pos] : 0.f;
  __syncthreads();

  // delta over the row's 8 threads (neighbouring lanes of one warp)
  float row_delta = 0.f;
  if (row < qn) {
    const float* orow = o + b * os_.b + h * os_.h + (long long)q_pos * os_.l;
    for (int d = lane; d < D; d += TPR) row_delta = fmaf(ot[row * DP + d], orow[d], row_delta);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    row_delta += __shfl_xor_sync(0xffffffffu, row_delta, off);
  if (row < qn && lane == 0) delta[(long long)bh * L + q_pos] = row_delta;

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
    float* dqr = out_row(dq, b, q_pos, h, L, H, D);
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int d = lane + jd * TPR;
      if (d < D) dqr[d] = dq_acc[jd] * fold;
    }
  }
}

// HB: head dims up to HB (32, 64 or 128); WPH: warps per head (1 for L <= 16, else 4).
template <int HB, int WPH>
__global__ void __launch_bounds__(tq::THREADS)
    flash_bwd_dkdv_mma_kernel(tq::View q, tq::View k, tq::View v, tq::View dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int H, int L,
                              int D, float sl2, float fold, int causal, int vec) {
  using namespace tq;
  constexpr int RS = HB + ROW_PAD;
  constexpr int ROWS = TILE * WPH;        // positions of one head in a stage
  constexpr int HPB = WARPS / WPH;        // heads per block
  constexpr int STAGES = WPH == 1 ? 1 : 2;
  constexpr int NO = HB / 8;              // output n-tiles
  constexpr int TILE_ELEMS = STAGE_ROWS * RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kt = reinterpret_cast<bf16*>(smem_raw);  // STAGE_ROWS x RS: the block's keys
  bf16* vt = kt + TILE_ELEMS;                     // their values
  bf16* qs = vt + TILE_ELEMS;                     // STAGES x STAGE_ROWS x RS: walked queries
  bf16* gs = qs + STAGES * TILE_ELEMS;            // STAGES x STAGE_ROWS x RS: their dO
  float* ls = reinterpret_cast<float*>(gs + STAGES * TILE_ELEMS);  // STAGES x STAGE_ROWS: lse
  float* ds = ls + STAGES * STAGE_ROWS;                           // STAGES x STAGE_ROWS: delta

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh0 = blockIdx.y * HPB;
  const int pos0 = blockIdx.x * ROWS;     // the block's first key
  const int slot = warp / WPH;            // the warp's head in a stage
  const int kw = pos0 + (warp % WPH) * TILE;  // the warp's first key
  // under the causal mask, queries before the block's first key see none of its keys
  const int q_begin = causal ? pos0 : 0;
  const int n_tiles = (L - q_begin + ROWS - 1) / ROWS;

  // warp w stages rows 16w .. 16w + 15 of every stage: its own keys and values, and queries
  // qr .. qr + 15 of each walked tile of its head
  const int qr = (warp % WPH) * TILE;
  const int bh = bh0 + slot;
  const int batch = bh / H;
  const int h = bh - batch * H;
  const bool live = bh < BH;
  const bf16* kh = live ? k.p + batch * k.sb + h * k.sh : nullptr;
  const bf16* vh = live ? v.p + batch * v.sb + h * v.sh : nullptr;
  const bf16* qh = live ? q.p + batch * q.sb + h * q.sh : nullptr;
  const bf16* gh = live ? dout.p + batch * dout.sb + h * dout.sh : nullptr;
  const float* lrow = live ? lse + (long long)bh * L : nullptr;
  const float* drow = live ? delta + (long long)bh * L : nullptr;
  const int own = warp * TILE * RS;

  stage_tile<HB>(kt + own, kh, k.p, k.sl, kw, L, D, vec);
  stage_tile<HB>(vt + own, vh, v.p, v.sl, kw, L, D, vec);
  stage_tile<HB>(qs + own, qh, q.p, q.sl, q_begin + qr, L, D, vec);
  stage_tile<HB>(gs + own, gh, dout.p, dout.sl, q_begin + qr, L, D, vec);
  stage_values(ls + warp * TILE, lrow, lse, q_begin + qr, L);
  stage_values(ds + warp * TILE, drow, delta, q_begin + qr, L);
  cp_async_commit();

  const bf16* kw_t = kt + own;  // the warp's own keys and values
  const bf16* vw_t = vt + own;
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const int ka = kw + g;                  // this lane's key rows
  const int kb = ka + 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * ROWS;
    if (it + 1 < n_tiles) {  // only with two stages: fetch the next tile while this one runs
      const int nb = (it + 1) % STAGES;
      const int next = q0 + ROWS + qr;
      stage_tile<HB>(qs + nb * TILE_ELEMS + own, qh, q.p, q.sl, next, L, D, vec);
      stage_tile<HB>(gs + nb * TILE_ELEMS + own, gh, dout.p, dout.sl, next, L, D, vec);
      stage_values(ls + nb * STAGE_ROWS + warp * TILE, lrow, lse, next, L);
      stage_values(ds + nb * STAGE_ROWS + warp * TILE, drow, delta, next, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int buf = it % STAGES;
    const int row0 = slot * ROWS;         // the warp's head's rows in the stage
#pragma unroll 1
    for (int j2 = 0; j2 < ROWS / TILE; ++j2) {
      const int qs0 = q0 + j2 * TILE;     // first query of the slice
      if (qs0 >= L || (causal && qs0 + TILE - 1 < kw)) continue;  // nothing but zeros
      const bf16* qt = qs + buf * TILE_ELEMS + (row0 + j2 * TILE) * RS;
      const bf16* gt = gs + buf * TILE_ELEMS + (row0 + j2 * TILE) * RS;
      const float* lt = ls + buf * STAGE_ROWS + row0 + j2 * TILE;
      const float* dt = ds + buf * STAGE_ROWS + row0 + j2 * TILE;

      float st[2][4], pt[2][4];           // S^T then P^T; dP^T then dS^T
#pragma unroll
      for (int n = 0; n < 2; ++n)
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = pt[n][0] = pt[n][1] = pt[n][2] = pt[n][3] =
            0.f;
#pragma unroll
      for (int kk = 0; kk < HB / 16; ++kk) {
        unsigned a[4], b[4];
        load_a(a, kw_t, RS, kk * 16);
        load_b(b, qt, RS, kk * 16);
        mma(st[0], a, b[0], b[1]);
        mma(st[1], a, b[2], b[3]);
        load_a(a, vw_t, RS, kk * 16);
        load_b(b, gt, RS, kk * 16);
        mma(pt[0], a, b[0], b[1]);
        mma(pt[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t + e;  // query qs0 + col
          const int qpos = qs0 + col;
          const float lq = lt[col];
          const float dq = dt[col];
          const bool in = qpos < L;
          const float pa = in && (!causal || ka <= qpos) ? exp2f(st[n][e] * sl2 - lq) : 0.f;
          const float pb = in && (!causal || kb <= qpos) ? exp2f(st[n][2 + e] * sl2 - lq) : 0.f;
          st[n][e] = pa;
          st[n][2 + e] = pb;
          pt[n][e] = pa * (pt[n][e] - dq);
          pt[n][2 + e] = pb * (pt[n][2 + e] - dq);
        }
      }
      unsigned p_hi[4], p_lo[4], s_hi[4], s_lo[4];
      to_a(st[0], st[1], p_hi, p_lo);
      to_a(pt[0], pt[1], s_hi, s_lo);
#pragma unroll
      for (int nd = 0; nd < HB / 16; ++nd) {
        unsigned b[4];
        load_b_trans(b, gt, RS, nd * 16);
        mma(dva[2 * nd], p_hi, b[0], b[1]);
        mma(dva[2 * nd], p_lo, b[0], b[1]);
        mma(dva[2 * nd + 1], p_hi, b[2], b[3]);
        mma(dva[2 * nd + 1], p_lo, b[2], b[3]);
        load_b_trans(b, qt, RS, nd * 16);
        mma(dka[2 * nd], s_hi, b[0], b[1]);
        mma(dka[2 * nd], s_lo, b[0], b[1]);
        mma(dka[2 * nd + 1], s_hi, b[2], b[3]);
        mma(dka[2 * nd + 1], s_lo, b[2], b[3]);
      }
    }
    __syncthreads();  // the tile's readers are done before the next prefetch overwrites it
  }

  if (!live) return;
  // the warp's key and value rows of the stage are its own: reuse them for the output tiles
  bf16* kout = kt + own;
  bf16* vout = vt + own;
  store_acc(kout, RS, dka, fold, fold);
  store_acc(vout, RS, dva, 1.f, 1.f);
  __syncwarp();
  const long long head = ((long long)batch * L * H + h) * D;
  write_tile<HB>(dk + head, (long long)H * D, kout, kw, L, D);
  write_tile<HB>(dv + head, (long long)H * D, vout, kw, L, D);
}

template <int HB, int WPH>
cudaError_t launch_dkdv_mma(const tq::View& q, const tq::View& k, const tq::View& v,
                            const tq::View& dout, const float* lse, const float* delta, bf16* dk,
                            bf16* dv, int B, int L, int H, int D, float scale, int causal, int vec,
                            cudaStream_t st) {
  constexpr int RS = HB + tq::ROW_PAD;
  constexpr int STAGES = WPH == 1 ? 1 : 2;
  constexpr int ROWS = tq::TILE * WPH;
  constexpr size_t smem = (sizeof(bf16) * (2 + 2 * STAGES) * RS + sizeof(float) * 2 * STAGES) *
                          tq::STAGE_ROWS;
  auto kernel = flash_bwd_dkdv_mma_kernel<HB, WPH>;
  static bool opted_in[64] = {};
  const cudaError_t err = tq::opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  const int BH = B * H;
  const float sl2 = scale * scale;
  const dim3 grid((L + ROWS - 1) / ROWS, (BH + tq::WARPS / WPH - 1) / (tq::WARPS / WPH));
  kernel<<<grid, tq::THREADS, smem, st>>>(q, k, v, dout, lse, delta, dk, dv, BH, H, L, D, sl2,
                                          sl2 * LN2, causal, vec);
  return cudaGetLastError();
}

template <int HB>
cudaError_t launch_dkdv_mma_hb(int warps_per_head, const tq::View& q, const tq::View& k,
                               const tq::View& v, const tq::View& dout, const float* lse,
                               const float* delta, bf16* dk, bf16* dv, int B, int L, int H, int D,
                               float scale, int causal, int vec, cudaStream_t st) {
  if (warps_per_head == 1 && L <= tq::TILE)
    return launch_dkdv_mma<HB, 1>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D, scale, causal,
                                  vec, st);
  if (warps_per_head == 4)
    return launch_dkdv_mma<HB, 4>(q, k, v, dout, lse, delta, dk, dv, B, L, H, D, scale, causal,
                                  vec, st);
  return cudaErrorInvalidValue;
}

// dQ in bf16, the mirror of the dK/dV kernel: one warp per (batch*head, 16-query tile).
template <int HB, int WPH>
__global__ void __launch_bounds__(tq::THREADS)
    flash_bwd_dq_mma_kernel(tq::View q, tq::View k, tq::View v, tq::View dout, tq::View o,
                            const float* __restrict__ lse, float* __restrict__ delta,
                            bf16* __restrict__ dq, int BH, int H, int L, int D, float sl2,
                            float fold, int causal, int vec) {
  using namespace tq;
  constexpr int RS = HB + ROW_PAD;
  constexpr int ROWS = TILE * WPH;        // positions of one head in a stage
  constexpr int HPB = WARPS / WPH;        // heads per block
  constexpr int STAGES = WPH == 1 ? 1 : 2;
  constexpr int NO = HB / 8;              // output n-tiles
  constexpr int TILE_ELEMS = STAGE_ROWS * RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // STAGE_ROWS x RS: the block's queries
  bf16* gs = qs + TILE_ELEMS;                     // their dO
  bf16* os = gs + TILE_ELEMS;                     // their O, then the dQ output tile
  bf16* ks = os + TILE_ELEMS;                     // STAGES x STAGE_ROWS x RS: walked keys
  bf16* vs = ks + STAGES * TILE_ELEMS;            // STAGES x STAGE_ROWS x RS: their values
  float* dls = reinterpret_cast<float*>(vs + STAGES * TILE_ELEMS);  // STAGE_ROWS: delta

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh0 = blockIdx.y * HPB;
  const int pos0 = blockIdx.x * ROWS;     // the block's first query
  const int slot = warp / WPH;            // the warp's head in a stage
  const int qw = pos0 + (warp % WPH) * TILE;  // the warp's first query
  // under the causal mask, keys after the block's last query meet none of its queries
  const int k_end = causal ? min(L, pos0 + ROWS) : L;
  const int n_tiles = (k_end + ROWS - 1) / ROWS;
  // warp w stages rows 16w .. 16w + 15 of every stage: its own queries, dO and O, and keys
  // kr .. kr + 15 of each walked tile of its head
  const int kr = (warp % WPH) * TILE;
  const int bh = bh0 + slot;
  const int batch = bh / H;
  const int h = bh - batch * H;
  const bool live = bh < BH;
  const bf16* qh = live ? q.p + batch * q.sb + h * q.sh : nullptr;
  const bf16* kh = live ? k.p + batch * k.sb + h * k.sh : nullptr;
  const bf16* vh = live ? v.p + batch * v.sb + h * v.sh : nullptr;
  const bf16* gh = live ? dout.p + batch * dout.sb + h * dout.sh : nullptr;
  const bf16* oh = live ? o.p + batch * o.sb + h * o.sh : nullptr;
  const int own = warp * TILE * RS;

  stage_tile<HB>(qs + own, qh, q.p, q.sl, qw, L, D, vec);
  stage_tile<HB>(gs + own, gh, dout.p, dout.sl, qw, L, D, vec);
  stage_tile<HB>(os + own, oh, o.p, o.sl, qw, L, D, vec);
  cp_async_commit();
  stage_tile<HB>(ks + own, kh, k.p, k.sl, kr, L, D, vec);
  stage_tile<HB>(vs + own, vh, v.p, v.sl, kr, L, D, vec);
  cp_async_commit();

  // delta = rowsum(dO * O) of the warp's 16 queries (two lanes a row, the padding is zero)
  // while the first key tile is in flight; written as the (B, H, L) rows dK/dV reads
  cp_async_wait<1>();
  __syncwarp();
  {
    const int row = lane / 2;
    const int c0 = (lane % 2) * (HB / 2);
    const bf16* gr = gs + own + row * RS + c0;
    const bf16* orow = os + own + row * RS + c0;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < HB / 2; c += 8) {
      const uint4 ga = *reinterpret_cast<const uint4*>(gr + c);
      const uint4 oa = *reinterpret_cast<const uint4*>(orow + c);
      const unsigned gw[4] = {ga.x, ga.y, ga.z, ga.w}, ow[4] = {oa.x, oa.y, oa.z, oa.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a bf16 is the upper half of the f32 it widens to
        sum = fmaf(__uint_as_float(gw[i] << 16), __uint_as_float(ow[i] << 16), sum);
        sum = fmaf(__uint_as_float(gw[i] & 0xffff0000u), __uint_as_float(ow[i] & 0xffff0000u),
                   sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (lane % 2 == 0) {
      dls[warp * TILE + row] = sum;
      if (live && qw + row < L) delta[(long long)bh * L + qw + row] = sum;
    }
  }
  __syncwarp();
  const int qa = qw + g;                  // this lane's query rows
  const int qb = qa + 8;
  const float dla = dls[warp * TILE + g];
  const float dlb = dls[warp * TILE + g + 8];
  const float lsa = live && qa < L ? lse[(long long)bh * L + qa] : 0.f;
  const float lsb = live && qb < L ? lse[(long long)bh * L + qb] : 0.f;

  const bf16* qt = qs + own;
  const bf16* gt = gs + own;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * ROWS;
    if (it + 1 < n_tiles) {  // only with two stages: fetch the next tile while this one runs
      const int nb = (it + 1) % STAGES * TILE_ELEMS + own;
      stage_tile<HB>(ks + nb, kh, k.p, k.sl, k0 + ROWS + kr, L, D, vec);
      stage_tile<HB>(vs + nb, vh, v.p, v.sl, k0 + ROWS + kr, L, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int buf = (it % STAGES) * TILE_ELEMS + slot * ROWS * RS;
#pragma unroll
    for (int j2 = 0; j2 < ROWS / TILE; ++j2) {
      const int ks0 = k0 + j2 * TILE;     // first key of the slice
      if (ks0 >= L || (causal && ks0 > qw + TILE - 1)) continue;  // nothing but zeros
      const bf16* kt = ks + buf + j2 * TILE * RS;
      const bf16* vt = vs + buf + j2 * TILE * RS;

      float s[2][4], dp[2][4];            // S then dS; dP
#pragma unroll
      for (int n = 0; n < 2; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HB / 16; ++kk) {
        unsigned a[4], b[4];
        load_a(a, qt, RS, kk * 16);
        load_b(b, kt, RS, kk * 16);
        mma(s[0], a, b[0], b[1]);
        mma(s[1], a, b[2], b[3]);
        load_a(a, gt, RS, kk * 16);
        load_b(b, vt, RS, kk * 16);
        mma(dp[0], a, b[0], b[1]);
        mma(dp[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = ks0 + n * 8 + 2 * t + e;
          const bool in = key < L;
          const float pa = in && qa < L && (!causal || key <= qa) ? exp2f(s[n][e] * sl2 - lsa)
                                                                  : 0.f;
          const float pb = in && qb < L && (!causal || key <= qb)
                               ? exp2f(s[n][2 + e] * sl2 - lsb)
                               : 0.f;
          s[n][e] = pa * (dp[n][e] - dla);
          s[n][2 + e] = pb * (dp[n][2 + e] - dlb);
        }
      }
      unsigned s_hi[4], s_lo[4];
      to_a(s[0], s[1], s_hi, s_lo);
#pragma unroll
      for (int nd = 0; nd < HB / 16; ++nd) {
        unsigned b[4];
        load_b_trans(b, kt, RS, nd * 16);
        mma(acc[2 * nd], s_hi, b[0], b[1]);
        mma(acc[2 * nd], s_lo, b[0], b[1]);
        mma(acc[2 * nd + 1], s_hi, b[2], b[3]);
        mma(acc[2 * nd + 1], s_lo, b[2], b[3]);
      }
    }
    __syncthreads();  // the tile's readers are done before the next prefetch overwrites it
  }

  if (!live) return;
  // the warp's O rows are read: reuse them for the output tile
  bf16* out = os + own;
  store_acc(out, RS, acc, fold, fold);
  __syncwarp();
  write_tile<HB>(dq + ((long long)batch * L * H + h) * D, (long long)H * D, out, qw, L, D);
}

template <int HB, int WPH>
cudaError_t launch_dq_mma(const tq::View& q, const tq::View& k, const tq::View& v,
                          const tq::View& dout, const tq::View& o, const float* lse, float* delta,
                          bf16* dq, int B, int L, int H, int D, float scale, int causal, int vec,
                          cudaStream_t st) {
  constexpr int RS = HB + tq::ROW_PAD;
  constexpr int STAGES = WPH == 1 ? 1 : 2;
  constexpr int ROWS = tq::TILE * WPH;
  constexpr size_t smem =
      (sizeof(bf16) * (3 + 2 * STAGES) * RS + sizeof(float)) * tq::STAGE_ROWS;
  auto kernel = flash_bwd_dq_mma_kernel<HB, WPH>;
  static bool opted_in[64] = {};
  const cudaError_t err = tq::opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  const int BH = B * H;
  const float sl2 = scale * scale;
  const dim3 grid((L + ROWS - 1) / ROWS, (BH + tq::WARPS / WPH - 1) / (tq::WARPS / WPH));
  kernel<<<grid, tq::THREADS, smem, st>>>(q, k, v, dout, o, lse, delta, dq, BH, H, L, D, sl2,
                                          sl2 * LN2, causal, vec);
  return cudaGetLastError();
}

template <int HB>
cudaError_t launch_dq_mma_hb(int warps_per_head, const tq::View& q, const tq::View& k,
                             const tq::View& v, const tq::View& dout, const tq::View& o,
                             const float* lse, float* delta, bf16* dq, int B, int L, int H,
                             int D, float scale, int causal, int vec, cudaStream_t st) {
  if (warps_per_head == 1 && L <= tq::TILE)
    return launch_dq_mma<HB, 1>(q, k, v, dout, o, lse, delta, dq, B, L, H, D, scale, causal,
                                vec, st);
  if (warps_per_head == 4)
    return launch_dq_mma<HB, 4>(q, k, v, dout, o, lse, delta, dq, B, L, H, D, scale, causal,
                                vec, st);
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int L, int H, int D) {
  return B < 1 || L < 1 || H < 1 || D < 1 || D > MAX_D || B * H > 65535;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q, k, v and dout are indexed as
// base + b * s_b + l * s_l + h * s_h + d (unit stride in D); lse and delta are contiguous
// (B, H, L) float32 tensors; dk, dv and dq are contiguous (B, L, H, D) tensors of the input
// dtype.  `scale` is the q/k pre-scale d^-1/4 * sqrt(log2 e).  dK/dV in bf16 only:
// head_block (32, 64 or 128, at least D) and warps_per_head (1, which needs L <= 16, or 4)
// pick the kernel's variant, and vec says that q, k, v, dout and their (b, l, h) strides are
// 16-byte aligned (else the kernel loads 2 bytes at a time).  Each returns the CUDA error code
// of its launch.
extern "C" int tq_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int dtype, int B, int L, int H, int D, long long q_sb,
    long long q_sl, long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, float scale, int causal, int device, void* stream, int head_block,
    int warps_per_head, int vec) {
  if (bad_shape(B, L, H, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err = tq::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (dtype == 0) {
    const dim3 grid((L + BT - 1) / BT, B * H);
    const size_t smem = sizeof(float) * (4 * BT * (D + 1) + 2 * BT * PS + 2 * BT);
    const Strides qs{q_sb, q_sl, q_sh}, ks{k_sb, k_sl, k_sh}, vs{v_sb, v_sl, v_sh},
        os{o_sb, o_sl, o_sh};
    flash_bwd_dkdv_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse_f, delta_f, static_cast<float*>(dk),
        static_cast<float*>(dv), L, H, D, qs, ks, vs, os, scale, causal);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || head_block < D) return (int)cudaErrorInvalidValue;
  const tq::View qv{static_cast<const bf16*>(q), q_sb, q_sl, q_sh};
  const tq::View kv{static_cast<const bf16*>(k), k_sb, k_sl, k_sh};
  const tq::View vv{static_cast<const bf16*>(v), v_sb, v_sl, v_sh};
  const tq::View ov{static_cast<const bf16*>(dout), o_sb, o_sl, o_sh};
  bf16* dk_b = static_cast<bf16*>(dk);
  bf16* dv_b = static_cast<bf16*>(dv);
  switch (head_block) {
    case 32:
      return (int)launch_dkdv_mma_hb<32>(warps_per_head, qv, kv, vv, ov, lse_f, delta_f, dk_b,
                                         dv_b, B, L, H, D, scale, causal, vec, st);
    case 64:
      return (int)launch_dkdv_mma_hb<64>(warps_per_head, qv, kv, vv, ov, lse_f, delta_f, dk_b,
                                         dv_b, B, L, H, D, scale, causal, vec, st);
    case 128:
      return (int)launch_dkdv_mma_hb<128>(warps_per_head, qv, kv, vv, ov, lse_f, delta_f, dk_b,
                                          dv_b, B, L, H, D, scale, causal, vec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dQ and delta together: dq reads o (the forward's output, same layout rules as dout), forms
// delta = rowsum(dO * O) in f32 for its queries, uses it, and writes it to `delta`, the (B, H,
// L) float32 rows tq_flash_attention_bwd_dkdv then reads.  In bf16 the tensor-core kernel
// takes head_block, warps_per_head and vec as dK/dV does, with o among the aligned operands.
extern "C" int tq_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* o,
    const void* lse, void* delta, void* dq, int dtype, int B, int L, int H, int D,
    long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh, long long g_sb,
    long long g_sl, long long g_sh, long long o_sb, long long o_sl, long long o_sh, float scale,
    int causal, int device, void* stream, int head_block, int warps_per_head, int vec) {
  if (bad_shape(B, L, H, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err = tq::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0) {
    const dim3 grid((L + BT - 1) / BT, B * H);
    const size_t smem = sizeof(float) * (4 * BT * (D + 1) + BT * PS);
    const Strides qs{q_sb, q_sl, q_sh}, ks{k_sb, k_sl, k_sh}, vs{v_sb, v_sl, v_sh},
        gs{g_sb, g_sl, g_sh}, os{o_sb, o_sl, o_sh};
    flash_bwd_dq_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(o), lse_f, delta_f,
        static_cast<float*>(dq), L, H, D, qs, ks, vs, gs, os, scale, causal);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || head_block < D) return (int)cudaErrorInvalidValue;
  const tq::View qv{static_cast<const bf16*>(q), q_sb, q_sl, q_sh};
  const tq::View kv{static_cast<const bf16*>(k), k_sb, k_sl, k_sh};
  const tq::View vv{static_cast<const bf16*>(v), v_sb, v_sl, v_sh};
  const tq::View gv{static_cast<const bf16*>(dout), g_sb, g_sl, g_sh};
  const tq::View ov{static_cast<const bf16*>(o), o_sb, o_sl, o_sh};
  bf16* dq_b = static_cast<bf16*>(dq);
  switch (head_block) {
    case 32:
      return (int)launch_dq_mma_hb<32>(warps_per_head, qv, kv, vv, gv, ov, lse_f, delta_f, dq_b,
                                       B, L, H, D, scale, causal, vec, st);
    case 64:
      return (int)launch_dq_mma_hb<64>(warps_per_head, qv, kv, vv, gv, ov, lse_f, delta_f, dq_b,
                                       B, L, H, D, scale, causal, vec, st);
    case 128:
      return (int)launch_dq_mma_hb<128>(warps_per_head, qv, kv, vv, gv, ov, lse_f, delta_f,
                                        dq_b, B, L, H, D, scale, causal, vec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

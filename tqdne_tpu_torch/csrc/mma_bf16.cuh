// Building blocks of the bf16 tensor-core flash kernels (flash_attention.cu and
// flash_attention_bwd.cu): 16-byte cp.async staging of strided (B, L, H, D) operands with
// zero fill, ldmatrix fragment loads, the m16n8k16 bf16 mma with f32 accumulators, and the
// hi/lo split that turns an f32 accumulator tile into bf16 A fragments.  group_norm.cu takes
// its cp.async and device helpers.
//
// Tiling shared by the flash kernels: a block is 4 warps, and each warp owns one 16-row tile
// (16 queries in the forward and dQ, 16 keys in dK/dV) of one batch*head.  A "stage" is 64
// rows of one operand in shared memory: with WPH warps per head it holds HPB = 4 / WPH heads
// of ROWS = 16 * WPH consecutive positions each.  WPH = 1 serves L <= 16 (the UNet's 16 tokens:
// four heads a block, one tile each), WPH = 4 longer sequences (four warps share each staged
// tile of their one head, as FlashAttention-2 does).  Warp w stages rows 16w .. 16w + 15 of
// every stage, which belong to its own head in both variants.
//
// mma.m16n8k16 fragments (lane = 4 g + t): A (16 x 16, row major) holds rows g and g + 8 at
// columns 2t, 2t + 1 and 2t + 8, 2t + 9; B (16 x 8) holds column g at rows 2t, 2t + 1 and
// 2t + 8, 2t + 9; the f32 accumulator C (16 x 8) holds rows g and g + 8 at columns 2t, 2t + 1.
// So two neighbouring C tiles are, element for element, the A fragment of the 16 x 16 product
// that follows (FlashAttention-2's register reuse of P): no shared-memory round trip.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tq {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;                    // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16;                    // rows of a warp's own tile
constexpr int STAGE_ROWS = TILE * WARPS;    // rows of a staged operand
constexpr float NEG_INF = -1e30f;

// A strided (B, L, H, D) operand with unit stride in D.
struct View {
  const bf16* p;
  long long sb, sl, sh;
};

// Padding, in elements, of a staged tile's rows (a tile for head dims up to HB has rows of
// HB + ROW_PAD): the 16 bytes put the 8 rows that one ldmatrix reads on distinct banks.
constexpr int ROW_PAD = 8;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; bytes past `src_bytes` are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp stages 16 rows of one head of an operand: positions pos0 .. pos0 + 15 (zeros from L
// on) of the (b, h) slice that starts at `head` (nullptr: a head past the last, all zeros),
// columns [0, HB) with zeros from D on, into a tile with rows of HB + ROW_PAD.  Every row of a
// stage that warp w loads belongs to w's own head, so the head's base is computed once; each
// lane keeps one 16-byte column chunk in every row, so the loop only steps a pointer.  vec:
// 16-byte cp.async, which needs every row start 16-byte aligned (the wrapper checks the
// pointer and strides); otherwise 2-byte loads.
template <int HB>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* head, const bf16* any,
                                           long long sl, int pos0, int L, int D, bool vec) {
  constexpr int CH = HB / 8;     // 16-byte chunks of a row
  constexpr int STEP = 32 / CH;  // rows a warp covers in one pass
  const int lane = threadIdx.x % 32;
  const int d0 = (lane % CH) * 8;
  const int r0 = lane / CH;
  const int n = head != nullptr ? max(0, min(8, D - d0)) : 0;  // values of the chunk below D
  const bf16* src = head != nullptr ? head + (pos0 + r0) * sl + d0 : any;
  bf16* out = dst + r0 * (HB + ROW_PAD) + d0;
#pragma unroll
  for (int j = 0; j < TILE / STEP; ++j) {
    const bool in = n > 0 && pos0 + r0 + j * STEP < L;
    const bf16* from = in ? src + j * STEP * sl : any;
    bf16* to = out + j * STEP * (HB + ROW_PAD);
    if (vec) {
      cp_async16(to, from, in ? 2 * n : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) to[e] = in && e < n ? from[e] : __float2bfloat16(0.f);
    }
  }
}

// The per-row f32 values (lse or delta) of the rows stage_tile stages: `row` is the head's
// (L,) row of a contiguous (BH, L) tensor (nullptr: zeros).
__device__ __forceinline__ void stage_values(float* dst, const float* row, const float* any,
                                             int pos0, int L) {
  const int lane = threadIdx.x % 32;
  if (lane < TILE) {
    const bool ok = row != nullptr && pos0 + lane < L;
    cp_async4(dst + lane, ok ? row + pos0 + lane : any, ok ? 4 : 0);
  }
}

// A fragment of the 16 x 16 tile at rows [0, 16), columns [k0, k0 + 16) of a row-major tile.
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* tile, int rs, int k0) {
  const int lane = threadIdx.x % 32;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(tile + (lane & 15) * rs + k0 + (lane >> 4) * 8)));
}

// B fragments of two n-tiles (rows [0, 8) and [8, 16)) of a tile stored as [n][k], columns
// [k0, k0 + 16): b[0], b[1] for the first n-tile, b[2], b[3] for the second.
__device__ __forceinline__ void load_b(unsigned (&b)[4], const bf16* tile, int rs, int k0) {
  const int lane = threadIdx.x % 32;
  const int row = (lane & 7) + ((lane >> 4) << 3);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(tile + row * rs + k0 + ((lane >> 3) & 1) * 8)));
}

// B fragments of two n-tiles (columns [n0, n0 + 8) and [n0 + 8, n0 + 16)) of a tile stored as
// [k][n], rows [0, 16): the transposing load.
__device__ __forceinline__ void load_b_trans(unsigned (&b)[4], const bf16* tile, int rs, int n0) {
  const int lane = threadIdx.x % 32;
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(tile + row * rs + n0 + (lane >> 4) * 8)));
}

// c += a b on the tensor cores, f32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x0, x1) = hi + lo with both in bf16: hi + lo keeps about 16 significant bits where one bf16
// keeps 8, so a product of probabilities or score gradients with bf16 operands loses no more
// than the f32 products of the plain version.
__device__ __forceinline__ void split(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The hi and lo A fragments of the 16 x 16 tile held as two neighbouring accumulators.
__device__ __forceinline__ void to_a(const float (&c0)[4], const float (&c1)[4], unsigned (&hi)[4],
                                     unsigned (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// Rows [0, 16) of a warp's f32 accumulator tile (row g in c[n][0..1], row g + 8 in c[n][2..3],
// columns 8n + 2t, 8n + 2t + 1), times mul, as bf16 into a row-major shared tile.
template <int NT>
__device__ __forceinline__ void store_acc(bf16* tile, int rs, const float (&c)[NT][4], float mul0,
                                          float mul1) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(tile + g * rs + n * 8 + 2 * t) =
        __floats2bfloat162_rn(c[n][0] * mul0, c[n][1] * mul0);
    *reinterpret_cast<__nv_bfloat162*>(tile + (g + 8) * rs + n * 8 + 2 * t) =
        __floats2bfloat162_rn(c[n][2] * mul1, c[n][3] * mul1);
  }
}

// A warp copies its 16-row bf16 tile to positions pos0 .. pos0 + 15 (those below L) of an
// output head whose position 0 is at `out`, rows ld elements apart: 16-byte stores when D is
// a multiple of 8, else 2-byte ones.
template <int HB>
__device__ __forceinline__ void write_tile(bf16* out, long long ld, const bf16* tile, int pos0,
                                           int L, int D) {
  constexpr int CH = HB / 8;
  constexpr int STEP = 32 / CH;
  const int lane = threadIdx.x % 32;
  const int d0 = (lane % CH) * 8;
  const int r0 = lane / CH;
  if (d0 >= D) return;
#pragma unroll
  for (int j = 0; j < TILE / STEP; ++j) {
    const int r = r0 + j * STEP;
    if (pos0 + r >= L) return;
    bf16* dst = out + (pos0 + r) * ld + d0;
    const bf16* src = tile + r * (HB + ROW_PAD) + d0;
    if (D % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && d0 + e < D; ++e) dst[e] = src[e];
    }
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once per device; `done` is the
// calling launcher's record of the devices where its kernel has.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes, bool (&done)[64]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && done[device])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

// Launches run on the caller's current device; switch only when the tensors live elsewhere.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

}  // namespace tq

// Tensor-core attention backward core for Hopper (sm_90a), bf16 inputs:
// the tile routines of K7's `short_bwd_dq_kernel_tc` and
// `short_bwd_dkv_kernel_tc` (short_attention.cu), built from tc_common.cuh's
// blocks like the forward core (attn_fwd_tc.cuh).
//
// FlashAttention-2's deterministic two-kernel split, with P rebuilt from the
// forward's row statistics (no [L, L] residual, no atomics):
// - dk/dv: a CTA of 4 warps owns 64 keys, each warp 16 of them. Its K and V
//   rows are the A operands of S^T = K.Q^T and dP^T = V.dO^T; 64-row tiles
//   of Q and dO stream through a double-buffered cp.async ring with each
//   row's (max, sum) and delta. P^T and dS^T are formed in registers and
//   packed in place to bf16 A fragments (the C fragments of two adjacent
//   n-tiles are one A fragment), then dV += P^T.dO and dK += dS^T.Q read dO
//   and Q through ldmatrix.trans.
// - dq: a CTA owns 64 q rows, each warp 16; its Q and dO rows are A
//   fragments held in registers, K/V tiles stream through the ring, and
//   dQ += dS.K reads K through ldmatrix.trans.
// So the five products are two shapes, both the forward's: `mma_abt` (a
// warp's 16 rows times the rows of a tile, B through ldmatrix) and
// `mma_pb` (packed C fragments times a tile, B through ldmatrix.trans).
//
// A tile's columns are taken a sub-step at a time (32 in dq, 16 in dk/dv),
// so a warp holds S and dP for 16 x 32 or 16 x 16 (16 or 8 fp32 registers
// each) and a stream tile past the ragged edge stops after its first live
// sub-step; a warp whose 16 rows all lie past L does no products. At ViT's
// L = 197 that issues 208 of 256 rows against 224 (dq) or 208 (dk/dv) of
// 256 columns.
//
// K2/K3's `flash_bwd_dq_kernel_tc` and `flash_bwd_dkv_kernel_tc`
// (flash_bwd.cu) use the same routines with the forward's lse in place of
// (max, sum): `load_lse_delta` fills a stage with a q tile's lse and delta,
// `mma_abt_a` reads the warp's K or V rows from shared memory one 16-deep
// chunk at a time, and `bias_at` reads a bias tile transposed.
//
// Rounding: S and dP come out of the tensor cores in fp32 from bf16
// operands; P and dS are fp32 until they are rounded to bf16 as the A
// operand of their products (the plain version keeps them fp32), which
// moves dV by at most 2^-8 sum_q P |dO|, dK by 2^-8 sum_q |dS| |q| and dQ by
// 2^-8 sum_k |dS| |k| (bf16's unit roundoff is 2^-8).

#pragma once

#include "tc_common.cuh"

namespace vyomai {
namespace tc {

constexpr int kRowStage = 3 * kTile;   // floats: (max, sum) x 64, delta x 64

// Shared memory of either backward kernel's bf16 tiles: dq holds q, dO and
// 2 stages of (K, V); dk/dv holds K, V and 2 stages of (q, dO).
template <int D>
constexpr size_t bwd_smem_bytes() {
  return (size_t)6 * kTile * D * sizeof(bf16);
}

// CTAs per SM the register cap aims at, for either kernel (the shared
// memory allows them).
template <int D>
constexpr int bwd_min_ctas() {
  return D <= 32 ? 4 : D <= 64 ? 3 : 2;
}

// Tile columns a sub-step takes: dq holds one 16 x D accumulator, dk/dv
// two, which at 32 columns (or with the warp's K and V A fragments kept in
// registers) spill under the cap of 3 CTAs per SM at D = 64 (ptxas). dk/dv
// reads its K and V fragments again from shared memory each sub-step.
constexpr int kDqSub = 32;
constexpr int kDkvSub = 16;

// cp.async of N = 4 or 8 bytes (`bytes` 0 writes zeros), for fp32 rows
// whose start is not 16-byte aligned.
template <int N>
__device__ __forceinline__ void cp_async_small(uint32_t dst, const void* src,
                                               int bytes) {
  static_assert(N == 4 || N == 8, "cp.async.ca copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(N), "r"(bytes));
}

// Issue the copies of rows [row0, row0 + 64) of the (max, sum) pairs and
// delta into a ring stage of kRowStage floats: pairs first, then delta;
// rows at or past `rows` are zero-filled.
__device__ __forceinline__ void load_row_stats(const float* __restrict__ ms,
                                               const float* __restrict__ dl,
                                               int row0, int rows,
                                               float* dst, int tid) {
  static_assert(kThreads == 2 * kTile, "one copy a thread");
  const uint32_t base = smem_addr(dst);
  const int r = tid & (kTile - 1);
  const bool live = row0 + r < rows;
  if (tid < kTile)
    cp_async_small<8>(base + r * 8, live ? ms + 2 * (row0 + r) : ms,
                      live ? 8 : 0);
  else
    cp_async_small<4>(base + 2 * kTile * 4 + r * 4, live ? dl + row0 + r : dl,
                      live ? 4 : 0);
}

// Floats of a K2/K3 row stage: lse x 64, then delta x 64.
constexpr int kLseStage = 2 * kTile;

// Issue the copies of rows [row0, row0 + 64) of lse and delta into a ring
// stage of kLseStage floats; rows at or past `rows` are zero-filled. A
// (batch, head)'s rows start at 4 Lq bytes, not 16-byte aligned for odd Lq:
// 4-byte copies, one a thread.
__device__ __forceinline__ void load_lse_delta(const float* __restrict__ lse,
                                               const float* __restrict__ dl,
                                               int row0, int rows,
                                               float* dst, int tid) {
  static_assert(kThreads == kLseStage, "one copy a thread");
  const int r = tid & (kTile - 1);
  const bool live = row0 + r < rows;
  const float* src = tid < kTile ? lse : dl;
  cp_async_small<4>(smem_addr(dst + tid), live ? src + row0 + r : src,
                    live ? 4 : 0);
}

// The bias of (tile row rl, tile column cl) from a [64][64] ring stage
// (load_bias's swizzle), one float: K3 reads its q-row tile transposed,
// with keys as its fragments' rows.
__device__ __forceinline__ float bias_at(const float* t, int rl, int cl) {
  return t[(rl * 16 + ((cl >> 2) ^ (rl & 7))) * 4 + (cl & 3)];
}

// A fragments of rows [row0, row0 + 16) of a swizzled [64][D] tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t tile, int row0,
                                       uint32_t (&af)[D / 16][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldsm_x4(tile + swz<D>(row0 + (lane & 15), kc * 2 + (lane >> 4)) * 16,
            af[kc][0], af[kc][1], af[kc][2], af[kc][3]);
}

// c += A.B^T over one 16-deep chunk kc of D: `af` a warp's A fragment of
// that chunk, B rows [row0, row0 + 8 NT) of a swizzled [64][D] tile.
template <int D, int NT>
__device__ __forceinline__ void mma_abt_kc(const uint32_t (&af)[4],
                                           uint32_t tile, int row0, int kc,
                                           float (&c)[NT][4]) {
  static_assert(NT % 2 == 0, "n-tiles come in pairs");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4(tile + swz<D>(row0 + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                          kc * 2 + ((lane >> 3) & 1)) * 16,
            b0, b1, b2, b3);
    mma_bf16(c[2 * np], af, b0, b1);
    mma_bf16(c[2 * np + 1], af, b2, b3);
  }
}

// c = A.B^T for a warp's 16 rows (A fragments `af`, 16 x D) and rows
// [row0, row0 + 8 NT) of a swizzled [64][D] tile: NT n-tiles of 8 columns.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(const uint32_t (&af)[D / 16][4],
                                        uint32_t tile, int row0,
                                        float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    mma_abt_kc<D, NT>(af[kc], tile, row0, kc, c);
}

// mma_abt with the A fragments read from rows [a_row0, a_row0 + 16) of a
// swizzled [64][D] tile one 16-deep chunk at a time (4 registers live,
// not D / 4: what keeps K3's two accumulators at D = 128 in registers).
template <int D, int NT>
__device__ __forceinline__ void mma_abt_a(uint32_t a_tile, int a_row0,
                                          uint32_t tile, int row0,
                                          float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t af[4];
    ldsm_x4(a_tile + swz<D>(a_row0 + (lane & 15), kc * 2 + (lane >> 4)) * 16,
            af[0], af[1], af[2], af[3]);
    mma_abt_kc<D, NT>(af, tile, row0, kc, c);
  }
}

// acc += bf16(p).B: p the fp32 C fragments of a warp's 16 x 16 KK block
// (2 KK n-tiles), packed in place to A fragments; B rows [row0, row0 + 16
// KK) of a swizzled [64][D] tile through ldmatrix.trans; acc 16 x D.
template <int D, int KK>
__device__ __forceinline__ void mma_pb(const float (&p)[2 * KK][4],
                                       uint32_t tile, int row0,
                                       float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(
          tile + swz<D>(row0 + kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                        dp * 2 + (lane >> 4)) * 16,
          b0, b1, b2, b3);
      mma_bf16(acc[2 * dp], pa, b0, b1);
      mma_bf16(acc[2 * dp + 1], pa, b2, b3);
    }
  }
}

}  // namespace tc
}  // namespace vyomai

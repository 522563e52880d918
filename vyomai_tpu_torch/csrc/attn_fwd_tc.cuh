// Tensor-core attention forward core for Hopper (sm_90a), bf16 inputs:
// shared by K1 (`flash_fwd_kernel_tc`, flash_fwd.cu) and K5/K6
// (`short_fwd_kernel_tc`, short_attention.cu). Its building blocks (the
// swizzle, cp.async, ldmatrix, mma.sync, fragment packing, the bias ring and
// the epilogue) are tc_common.cuh's, shared with the backward core
// (attn_bwd_tc.cuh).
//
// One CTA of 4 warps owns a 64-row q tile of one (batch, head); each warp
// owns 16 of those rows (FlashAttention-2's split, so no row statistic
// crosses warps).
// - The q tile is copied once with cp.async into shared memory (bf16) and
//   read into registers with ldmatrix as mma A fragments, where it stays for
//   the whole key loop.
// - K and V stream through a double-buffered ring of 64-key tiles,
//   cp.async.cg 16-byte copies, one commit group per tile: tile kt+1 is in
//   flight while tile kt is computed. Rows past the ragged edge are
//   zero-filled by the src-size form of cp.async. Every tile is stored with
//   its 16-byte chunks XOR-swizzled on the row, so the 8 row addresses of
//   each ldmatrix hit 8 distinct bank groups.
// - An additive fp32 bias, where the kernel has one, rides in the same
//   ring: a [64][64] tile per K/V tile (one row when the bias broadcasts
//   over the q rows), chunks swizzled as above, so a thread's float2 reads
//   of its fragment's columns cost 2 wavefronts a warp.
// - S = Q.K^T with mma.sync m16n8k16 (bf16 in, fp32 accumulate), K through
//   ldmatrix. Scale, causal mask and bias are applied to the fp32
//   accumulator fragment in registers; keys past the ragged edge take -inf.
// - Online softmax in registers: a thread holds 2 rows (g, g + 8) of each
//   16x8 fragment, so a row max is a 4-lane shuffle reduction; the row sum
//   stays a per-thread partial until the end.
// - P is rounded to bf16 in registers: the C fragments of two adjacent
//   n-tiles are the A fragment of the next mma, so P never touches shared
//   memory. O += P.V with V through ldmatrix.trans, fp32 accumulators (16 x D
//   per warp, D/2 registers a thread). The row sum adds the fp32 p.
// - A warp whose 16 rows all lie past Lq does no mma work but takes part in
//   the loads and barriers (ViT's last tile at L = 197 holds 5 live rows).
//
// Shared memory: q 64*D*2 bytes plus 2 stages x (K + V) x 64*D*2 bytes, 40 KB
// at D = 64 and 80 KB at D = 128, plus 2 x 16 KB for a [64, 64] bias tile
// or 2 x 256 bytes for a bias row. The epilogue stages each warp's
// normalised bf16 rows in its own rows of the q tile, then writes them with
// 16-byte stores through the output's row stride.

#pragma once

#include "tc_common.cuh"

namespace vyomai {
namespace tc {

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)5 * kTile * D * sizeof(bf16);   // q, 2 x K, 2 x V
}

// CTAs per SM the register cap aims at: ptxas meets 4 at D = 32, 3 at D = 64
// (3 matched 4's time and 4 spilled) and 2 at D = 128 (also the shared-memory
// limit) without spills.
template <int D>
constexpr int min_ctas() {
  return D <= 32 ? 4 : D <= 64 ? 3 : 2;
}

// What a thread holds of its warp's 16 rows: rows g = lane / 4 and g + 8.
template <int D>
struct FwdAcc {
  float o[D / 8][4];   // C fragments of the 16 x D output, d = 8j + 2(lane%4)
  float m[2];          // running row max (natural units)
  float l[2];          // row sum of exp(s - m); the full sum after fwd_core
};

// The key loop. Scores are q.k * scale, then with `causal` keys after
// q_offset + row add NEG_INF (K1's mask), then the bias tile is added.
// kFloor floors the running max at kMaxFloor (the flash contract: a fully
// masked row gives 0); without it the max starts at -inf and a row whose
// scores all equal finfo.min stays uniform. Ends with every copy landed and
// a barrier, so the caller may reuse the q tile's shared memory.
template <int D, bool kFloor>
__device__ __forceinline__ void fwd_core(
    const bf16* __restrict__ q, long long q_rs, const bf16* __restrict__ k,
    const bf16* __restrict__ v, long long kv_rs, int Lq, int Lk, int q0,
    int nk, float scale, int causal, int q_offset, const BiasTile& bias,
    bf16* smem, FwdAcc<D>& acc) {
  constexpr int KC = D / 16;     // 16-deep chunks of D
  constexpr int TILE = kTile * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;
  const bool warp_live = q0 + wrow < Lq;
  bf16* sq = smem;
  const uint32_t sk0 = smem_addr(smem + TILE), sv0 = smem_addr(smem + 3 * TILE);
  constexpr uint32_t kStage = TILE * sizeof(bf16);
  float* sb = reinterpret_cast<float*>(smem + 5 * TILE);   // bias ring
  const int b_stage = bias.rows * kTile;
  const bool has_bias = bias.src != nullptr;

  load_tile<D>(q, q_rs, q0, Lq, sq, tid);
  if (nk > 0) {
    load_tile<D>(k, kv_rs, 0, Lk, smem + TILE, tid);
    load_tile<D>(v, kv_rs, 0, Lk, smem + 3 * TILE, tid);
    if (has_bias) load_bias(bias, 0, sb, tid);
  }
  cp_async_commit();

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.o[j][e] = 0.f;
  acc.m[0] = acc.m[1] = -INFINITY;
  acc.l[0] = acc.l[1] = 0.f;
  uint32_t qf[KC][4];

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kTile;
    if (kt + 1 < nk) {   // the next tile into the other stage
      load_tile<D>(k, kv_rs, k0 + kTile, Lk, smem + (1 + (st ^ 1)) * TILE,
                   tid);
      load_tile<D>(v, kv_rs, k0 + kTile, Lk, smem + (3 + (st ^ 1)) * TILE,
                   tid);
      if (has_bias) load_bias(bias, k0 + kTile, sb + (st ^ 1) * b_stage, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // all but the newest group: tile kt (and q) landed
    __syncthreads();

    if (warp_live) {
      if (kt == 0) {
        const uint32_t qa = smem_addr(sq);
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          ldsm_x4(qa + swz<D>(wrow + (lane & 15), kc * 2 + (lane >> 4)) * 16,
                  qf[kc][0], qf[kc][1], qf[kc][2], qf[kc][3]);
      }

      // S = Q K^T: 8 n-tiles of 8 keys
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const uint32_t ka = sk0 + st * kStage;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(ka + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                              kc * 2 + ((lane >> 3) & 1)) * 16,
                  b0, b1, b2, b3);
          mma_bf16(s[2 * np], qf[kc], b0, b1);
          mma_bf16(s[2 * np + 1], qf[kc], b2, b3);
        }

      // scores, mask, bias, ragged key edge, row max
      const int r0 = q0 + wrow + g;
      const float* bt = sb + st * b_stage;
      const bool edge = k0 + kTile > Lk;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // element e of the fragment: row r0 + 8 * (e / 2), key c + e % 2
        const int c = k0 + 8 * j + 2 * t4;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = s[j][e] * scale;
          if (causal && c + (e & 1) > q_offset + r0 + 8 * (e >> 1))
            x[e] += kNegInf;
        }
        if (has_bias) {
          const float2 b0 = tile_bias(bt, bias.rows, wrow + g, c - k0);
          const float2 b1 = tile_bias(bt, bias.rows, wrow + g + 8, c - k0);
          x[0] += b0.x;
          x[1] += b0.y;
          x[2] += b1.x;
          x[3] += b1.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge && c + (e & 1) >= Lk) x[e] = -INFINITY;   // not a key
          s[j][e] = x[e];
          mx[e >> 1] = fmaxf(mx[e >> 1], x[e]);
        }
      }

      // online softmax: rescale the running state, p = exp(s - m)
      float m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        float m_new = fmaxf(acc.m[i], mx[i]);
        if (kFloor) m_new = fmaxf(m_new, kMaxFloor);
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = ex2((acc.m[i] - m_use[i]) * kLog2e);
        acc.m[i] = m_new;
        acc.l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc.o[j][2 * i] *= alpha;
          acc.o[j][2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2((s[j][e] - m_use[e >> 1]) * kLog2e);
          acc.l[e >> 1] += p;
          s[j][e] = p;
        }

      // O += P V: P's C fragments are the A fragments, V via ldmatrix.trans
      const uint32_t va = sv0 + st * kStage;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < KC; ++dp) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(
              va + swz<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                          dp * 2 + (lane >> 4)) * 16,
              b0, b1, b2, b3);
          mma_bf16(acc.o[2 * dp], pa, b0, b1);
          mma_bf16(acc.o[2 * dp + 1], pa, b2, b3);
        }
      }
    }
    __syncthreads();   // stage st fully read before tile kt + 2 lands in it
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    acc.l[i] += __shfl_xor_sync(0xffffffffu, acc.l[i], 1);
    acc.l[i] += __shfl_xor_sync(0xffffffffu, acc.l[i], 2);
  }
}

}  // namespace tc
}  // namespace vyomai

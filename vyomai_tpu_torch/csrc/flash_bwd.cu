// Flash-attention backward for Hopper (sm_90a): K2 (dq) and K3 (dk, dv).
//
// Replaces the TPU kernels vyomai_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (K2) and `_bwd_dkv_kernel` (K3), launched by `_bwd`
// (additive bias, causal with q_offset; no sliding window or segment ids).
// Both recompute P = exp(scale*q.k + causal + bias - lse) tile by tile from
// the forward's lse (no [Lq, Lk] residual), with dS = P * (dO.v - delta) *
// scale and delta = rowsum(dO * O) computed by the wrapper before launch,
// as the TPU `_bwd` does outside its kernels.
//
// What bounds them on the H100: arithmetic. K2 does three D-long products
// per live (query, key) pair (q.k, dO.v, dS.k), K3 four (q.k, dO.v, P^T.dO,
// dS^T.q), all on operands reused across a 64x64 tile.
//
// The launchers pick the kernels by dtype. This is a dispatch, not a
// fallback: each path returns its cudaError_t, and a bf16 tensor never
// reaches a CUDA-core kernel.
//
// bf16: `flash_bwd_dq_kernel_tc` and `flash_bwd_dkv_kernel_tc`, on the
// backward core of attn_bwd_tc.cuh (mma.sync m16n8k16 with fp32
// accumulation, ldmatrix, a double-buffered cp.async ring, P and dS
// rounded to bf16 as the A operands of their products). CTAs of 4 warps,
// 16 rows a warp; the tile index is the slowest grid dimension, ordered so
// that the tiles with the most causal work start first.
// - K2: one CTA per (64-row q tile, head, batch), last q tile first. q and
//   dO are A fragments in registers, each row's lse and delta too; 64-key
//   K/V tiles of kv head h / group stream through the ring up to the last
//   tile any row of the CTA sees, with the bias (one row when it broadcasts
//   over q rows, else the 64x64 tile). A warp takes its tile's columns 32
//   at a time and stops at its rows' causal edge and at Lk; only tiles
//   that cross a warp's edge mask element by element.
// - K3: one CTA per (64-key tile, kv head, batch), first key tile first.
//   K and V rows are the A operands of S^T and dP^T; the ring streams the
//   (q head of the group, q tile) sequence from the first q tile that sees
//   key k0, each stage with its tile's lse and delta and, for a full bias,
//   the 64x64 bias tile (read transposed); a bias that broadcasts over q
//   rows is two registers a thread, read again when the head changes. A
//   warp takes 32 q columns at a time and skips those wholly before its
//   keys' causal edge. dk and dv accumulate over the whole group in
//   registers: one CTA owns its keys' sum, no atomics, the same result run
//   to run.
// The bias ring is sized at launch from the bias's shape, so the decoder's
// row bias costs 512 bytes (K2) or nothing (K3): 48 KB of shared memory a
// CTA at D = 64 and 96 KB at D = 128, plus 1 KB of lse/delta in K3.
//
// fp32: `flash_bwd_dq_kernel` and `flash_bwd_dkv_kernel`, fp32 FMAs on the
// CUDA cores (tensor cores would round fp32 inputs to TF32, and the fp32
// card-vs-CPU checks hold the port to 1e-4 of each gradient's max). 256
// threads per CTA; every tile is 64 rows, staged in shared memory as fp32
// with 16-byte vector loads into rows padded to D+1 floats (the column walks
// then hit distinct banks). A thread owns a 4x4 block of each 64x64 score
// tile (rows ty*4+i, columns tx+16j) and a 4 x D/16 block of its
// accumulators, so no row reduction is needed (lse and delta are given).
// K2 walks the K/V tiles of kv head h / group up to the causal edge, writes
// dS to shared memory and accumulates dq = dS.K in registers; K3 walks
// every q head of the GQA group and every q tile at or after the causal
// edge, computing the transposed tile (keys as rows) so dk = sum dS^T.q and
// dv = sum P^T.dO accumulate in registers. Shared memory: K2 4*64*(D+1) +
// 64*65 floats (83 KB at D=64, 149 KB at D=128); K3 adds a second 64x65
// tile and lse/delta rows (100 KB, 166 KB).
//
// Both: the bias is addressed through its broadcast strides (0 for a
// size-1 dim; 64-bit), in place (fp32) or through the ring, which needs
// 16-byte aligned rows (bf16: the wrapper pads a bias that has none, and
// the launchers refuse one). Ragged Lq/Lk edges are masked here (P = 0
// outside), whole tiles past the causal edge are skipped, and masked
// scores take NEG_INF, so a fully-masked row (lse -1e30) gets P = 0 and
// exactly zero gradient.

#include "attn_bwd_tc.cuh"

namespace vyomai {

constexpr int kBwdThreads = 256;
constexpr int kT = 64;           // rows of every q / key tile
constexpr int kLDP = kT + 1;     // padded row of a 64x64 score tile

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kT * (D + 1) + kT * kLDP);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kT * (D + 1) + 2 * kT * kLDP + 2 * kT);
}

// Stage rows [row0, row0 + 64) of a [rows, D] tensor into dst[64][D+1] as
// fp32; rows at or past `rows` are zero.
template <int D>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src,
                                           int row0, int rows, float* dst,
                                           int tid) {
  constexpr int VN = Vec<float>::kN, CPR = D / VN, LD = D + 1;
  for (int c = tid; c < kT * CPR; c += kBwdThreads) {
    const int r = c / CPR, col = (c % CPR) * VN;
    float x[VN];
    if (row0 + r < rows) {
      load_vec<float>(src + (size_t)(row0 + r) * D + col, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[r * LD + col + e] = x[e];
  }
}

// P of one (query r, key c) pair from its raw dot q.k, or 0 outside the
// ragged edges.
__device__ __forceinline__ float recompute_p(float dot, int r, int c, int Lq,
                                             int Lk, float scale, int causal,
                                             int q_offset, const float* bb,
                                             long long sq, float row_lse) {
  if (r >= Lq || c >= Lk) return 0.f;
  float x = dot * scale;
  if (causal && c > q_offset + r) x += kNegInf;
  if (bb != nullptr) x += bb[r * sq + c];
  return expf(x - row_lse);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ bias,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int H_kv, int Lq, int Lk, long long sb,
                    long long sh, long long sq, int causal, int q_offset) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kT][LD]
  float* dos = qs + kT * LD;         // [kT][LD]
  float* ks = dos + kT * LD;         // [kT][LD]
  float* vs = ks + kT * LD;          // [kT][LD]
  float* ds = vs + kT * LD;          // [kT][kLDP]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int hk = h / (H / H_kv);
  const int q0 = qt * kT;
  const size_t row_base = ((size_t)b * H + h) * (size_t)Lq;
  const float* kb = k + ((size_t)b * H_kv + hk) * (size_t)Lk * D;
  const float* vb = v + ((size_t)b * H_kv + hk) * (size_t)Lk * D;
  const float* bb = bias == nullptr ? nullptr : bias + b * sb + h * sh;
  const float scale = (float)(1.0 / sqrt((double)D));

  stage_tile<D>(q + row_base * D, q0, Lq, qs, tid);
  stage_tile<D>(dout + row_base * D, q0, Lq, dos, tid);
  float row_lse[4], row_delta[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    row_lse[i] = r < Lq ? lse[row_base + r] : 0.f;
    row_delta[i] = r < Lq ? delta[row_base + r] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int nk = (Lk + kT - 1) / kT;
  if (causal) {   // skip K/V tiles entirely in every row's future
    const long long last_q = (long long)q_offset + q0 + kT - 1;
    const long long live = last_q < 0 ? 0 : last_q / kT + 1;
    nk = live < nk ? (int)live : nk;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();   // previous tile's ks/vs/ds fully consumed
    stage_tile<D>(kb, k0, Lk, ks, tid);
    stage_tile<D>(vb, k0, Lk, vs, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * LD + d];
        g[i] = dos[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = ks[(tx + 16 * j) * LD + d];
        vv[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = q0 + ty * 4 + i, c = k0 + tx + 16 * j;
        const float p = recompute_p(s[i][j], r, c, Lq, Lk, scale, causal,
                                    q_offset, bb, sq, row_lse[i]);
        ds[(ty * 4 + i) * kLDP + tx + 16 * j] =
            p * (dp[i][j] - row_delta[i]) * scale;
      }
    __syncthreads();   // ds rows are written by 16 threads each

#pragma unroll 4
    for (int c = 0; c < kT; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds[(ty * 4 + i) * kLDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j],
                                                      acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[(row_base + r) * D + tx + 16 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int H_kv, int Lq, int Lk,
                     long long sb, long long sh, long long sq, int causal,
                     int q_offset) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                  // [kT][LD]
  float* vs = ks + kT * LD;          // [kT][LD]
  float* qs = vs + kT * LD;          // [kT][LD]
  float* dos = qs + kT * LD;         // [kT][LD]
  float* pt = dos + kT * LD;         // [kT keys][kLDP queries]: P^T
  float* dst = pt + kT * kLDP;       // [kT][kLDP]: dS^T
  float* lse_s = dst + kT * kLDP;    // [kT]
  float* delta_s = lse_s + kT;       // [kT]

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int group = H / H_kv;
  const int k0 = kt * kT;
  const size_t kv_base = ((size_t)b * H_kv + hk) * (size_t)Lk;
  const float scale = (float)(1.0 / sqrt((double)D));

  stage_tile<D>(k + kv_base * D, k0, Lk, ks, tid);
  stage_tile<D>(v + kv_base * D, k0, Lk, vs, tid);
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int nq = (Lq + kT - 1) / kT;
  int qt_first = 0;
  if (causal) {   // first q row that sees key k0 is k0 - q_offset
    const long long r = (long long)k0 - q_offset;
    qt_first = r <= 0 ? 0 : (int)(r / kT < nq ? r / kT : nq);
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t row_base = ((size_t)b * H + h) * (size_t)Lq;
    const float* bb = bias == nullptr ? nullptr : bias + b * sb + h * sh;
    for (int qt = qt_first; qt < nq; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();   // previous q tile fully consumed
      stage_tile<D>(q + row_base * D, q0, Lq, qs, tid);
      stage_tile<D>(dout + row_base * D, q0, Lq, dos, tid);
      if (tid < kT) {
        const int r = q0 + tid;
        lse_s[tid] = r < Lq ? lse[row_base + r] : 0.f;
        delta_s[tid] = r < Lq ? delta[row_base + r] : 0.f;
      }
      __syncthreads();

      // transposed tile: rows are keys ty*4+i, columns queries tx+16j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[4], vv[4], a[4], gg[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = ks[(ty * 4 + i) * LD + d];
          vv[i] = vs[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = qs[(tx + 16 * j) * LD + d];
          gg[j] = dos[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kk[i], a[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gg[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = k0 + ty * 4 + i, rr = tx + 16 * j;
          const float p = recompute_p(s[i][j], q0 + rr, c, Lq, Lk, scale,
                                      causal, q_offset, bb, sq, lse_s[rr]);
          pt[(ty * 4 + i) * kLDP + rr] = p;
          dst[(ty * 4 + i) * kLDP + rr] =
              p * (dp[i][j] - delta_s[rr]) * scale;
        }
      __syncthreads();   // pt/dst rows are written by 16 threads each

#pragma unroll 4
      for (int c = 0; c < kT; ++c) {
        float pv[4], dsv[4], gv[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt[(ty * 4 + i) * kLDP + c];
          dsv[i] = dst[(ty * 4 + i) * kLDP + c];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          gv[j] = dos[c * LD + tx + 16 * j];
          qv[j] = qs[c * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            acc_v[i][j] = fmaf(pv[i], gv[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= Lk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[(kv_base + c) * D + tx + 16 * j] = acc_k[i][j];
      dv[(kv_base + c) * D + tx + 16 * j] = acc_v[i][j];
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *bias, *lse, *delta;
  int B, H, H_kv, Lq, Lk;
  long long sb, sh, sq;
  int causal, q_offset;
};

// ------------------------------------------------------ bf16, tensor cores

// bf16 on the tensor cores (attn_bwd_tc.cuh): dq for one 64-row q tile.
template <int D>
__global__ void __launch_bounds__(tc::kThreads, tc::bwd_min_ctas<D>())
flash_bwd_dq_kernel_tc(BwdArgs a, tc::bf16* __restrict__ dq) {
  using namespace tc;
  constexpr int TILE = kTile * D, NS = kDqSub;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sq = reinterpret_cast<bf16*>(tc_smem);   // q, later dq staging
  bf16* sdo = sq + TILE;
  bf16* ring = sdo + TILE;                       // stage s: K, then V
  float* sb = reinterpret_cast<float*>(ring + 4 * TILE);   // bias ring

  // the last q tiles see the most keys under causal: they go first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int Lq = a.Lq, Lk = a.Lk;
  const int tid = threadIdx.x, lane = tid & 31, wrow = (tid >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const bool warp_live = q0 + wrow < Lq;
  const int hk = h / (a.H / a.H_kv);
  const long long rows = ((long long)b * a.H + h) * Lq;
  const long long krows = ((long long)b * a.H_kv + hk) * Lk;
  const bf16* k = (const bf16*)a.k + krows * D;
  const bf16* v = (const bf16*)a.v + krows * D;
  // the launcher checked 16-byte aligned bias rows (strides % 4 == 0)
  const BiasTile bt{
      a.bias == nullptr ? nullptr : a.bias + b * a.sb + h * a.sh + q0 * a.sq,
      a.sq, a.sq == 0 ? 1 : kTile, a.sq == 0 ? 1 : Lq - q0, Lk};
  const bool has_bias = bt.src != nullptr;
  const int b_stage = bt.rows * kTile;
  const float scale = (float)(1.0 / sqrt((double)D));
  // K/V tiles up to the last key any row of the CTA sees; a warp's rows
  // see keys up to `wlast`
  int nk = (Lk + kTile - 1) / kTile;
  const long long wlast = (long long)a.q_offset + q0 + wrow + 15;
  if (a.causal) {
    const long long last = (long long)a.q_offset + q0 + kTile - 1;
    nk = last < 0 ? 0 : (int)(last / kTile + 1 < nk ? last / kTile + 1 : nk);
  }

  load_tile<D>((const bf16*)a.q + rows * D, D, q0, Lq, sq, tid);
  load_tile<D>((const bf16*)a.dout + rows * D, D, q0, Lq, sdo, tid);
  if (nk > 0) {
    load_tile<D>(k, D, 0, Lk, ring, tid);
    load_tile<D>(v, D, 0, Lk, ring + TILE, tid);
    if (has_bias) load_bias(bt, 0, sb, tid);
  }
  cp_async_commit();

  // the thread's rows g and g + 8: lse (+inf past Lq: P = 0) and delta
  float ls[2], de[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + wrow + g + 8 * i;
    ls[i] = r < Lq ? a.lse[rows + r] : INFINITY;
    de[i] = r < Lq ? a.delta[rows + r] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[D / 16][4], df[D / 16][4];

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kTile;
    if (kt + 1 < nk) {   // the next tile into the other stage
      load_tile<D>(k, D, k0 + kTile, Lk, ring + 2 * (st ^ 1) * TILE, tid);
      load_tile<D>(v, D, k0 + kTile, Lk, ring + (2 * (st ^ 1) + 1) * TILE,
                   tid);
      if (has_bias) load_bias(bt, k0 + kTile, sb + (st ^ 1) * b_stage, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // all but the newest group: tile kt (and q, dO)
    __syncthreads();

    if (warp_live) {
      if (kt == 0) {
        load_a<D>(smem_addr(sq), wrow, qf);
        load_a<D>(smem_addr(sdo), wrow, df);
      }
      const uint32_t ska = smem_addr(ring + 2 * st * TILE);
      const uint32_t sva = smem_addr(ring + (2 * st + 1) * TILE);
      const float* brow = sb + st * b_stage;
      const bool edge = k0 + kTile > Lk;
      // the tile crosses the causal edge of some row of the warp
      const bool diag = a.causal && k0 + kTile - 1 > wlast - 15;
      long long c_end = Lk - k0 < kTile ? Lk - k0 : kTile;
      if (a.causal && wlast - k0 + 1 < c_end) c_end = wlast - k0 + 1;
      for (int c0 = 0; c0 < c_end; c0 += NS) {
        float s[NS / 8][4], dp[NS / 8][4];
        mma_abt<D, NS / 8>(qf, ska, c0, s);    // S = Q.K^T
        mma_abt<D, NS / 8>(df, sva, c0, dp);   // dP = dO.V^T
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          // element e: row g + 8 (e / 2), key column c + e % 2
          const int c = c0 + 8 * j + 2 * t4;
          float2 kb[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
          if (has_bias) {
            kb[0] = tile_bias(brow, bt.rows, wrow + g, c);
            kb[1] = tile_bias(brow, bt.rows, wrow + g + 8, c);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, key = k0 + c + (e & 1);
            float x = s[j][e] * scale;
            if (diag && key > wlast - 15 + g + 8 * i) x += kNegInf;
            x += (e & 1) ? kb[i].y : kb[i].x;
            if (edge && key >= Lk) x = -INFINITY;   // not a key
            const float p = ex2((x - ls[i]) * kLog2e);
            dp[j][e] = p * (dp[j][e] - de[i]) * scale;   // dS
          }
        }
        mma_pb<D, NS / 16>(dp, ska, c0, acc);   // dQ += dS.K
      }
    }
    __syncthreads();   // stage st fully read before tile kt + 2 lands in it
  }
  cp_async_wait<0>();
  __syncthreads();     // q and dO landed, also when no tile was live
  if (!warp_live) return;
  const float one[2] = {1.f, 1.f};
  store_rows<D>(acc, one, sq, dq + rows * D, D, q0, Lq);
}

// K3's sub-step (q columns) and register cap. Its grid is (key tiles x kv
// heads x batch), 256 CTAs at the decoder's shape, under 2 a SM, so the cap
// allows 2: 32-column sub-steps then fit without a spill (218 registers at
// D = 64, 254 at D = 128) and ran faster on the H100 than K7's 16 at 3 a
// SM (PERF.md's kernel findings).
constexpr int kK3Sub = 32;
constexpr int kK3MinCtas = 2;

// bf16 on the tensor cores (attn_bwd_tc.cuh): dk and dv for 64 keys,
// summed over the GQA group.
template <int D>
__global__ void __launch_bounds__(tc::kThreads, kK3MinCtas)
flash_bwd_dkv_kernel_tc(BwdArgs a, tc::bf16* __restrict__ dk,
                        tc::bf16* __restrict__ dv) {
  using namespace tc;
  constexpr int TILE = kTile * D, NS = kK3Sub;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sk = reinterpret_cast<bf16*>(tc_smem);   // K, later dk staging
  bf16* sv = sk + TILE;                          // V, later dv staging
  bf16* ring = sv + TILE;                        // stage s: q, then dO
  float* srs = reinterpret_cast<float*>(ring + 4 * TILE);   // lse, delta
  float* sb = srs + 2 * kLseStage;               // full bias tiles

  // the first key tiles are seen by the most q tiles under causal: they
  // go first
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kTile;
  const int Lq = a.Lq, Lk = a.Lk, group = a.H / a.H_kv;
  const int tid = threadIdx.x, lane = tid & 31, wrow = (tid >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const bool warp_live = k0 + wrow < Lk;
  const long long krows = ((long long)b * a.H_kv + hk) * Lk;
  const bf16* q = (const bf16*)a.q;
  const bf16* go = (const bf16*)a.dout;
  // a bias with q rows rides in the ring; one that broadcasts over them
  // is per key, in registers
  const bool full_bias = a.bias != nullptr && a.sq != 0;
  const bool row_bias = a.bias != nullptr && a.sq == 0;
  const float scale = (float)(1.0 / sqrt((double)D));
  // the stream: step i is q head hk * group + i / nqs, q tile qt_first +
  // i % nqs, from the first q tile that sees key k0
  const int nq = (Lq + kTile - 1) / kTile;
  int qt_first = 0;
  if (a.causal) {
    const long long r = (long long)k0 - a.q_offset;
    qt_first = r <= 0 ? 0 : (int)(r / kTile < nq ? r / kTile : nq);
  }
  const int nqs = nq - qt_first, n = group * nqs;

  auto issue = [&](int i, int st) {   // step i's copies into stage st
    const int h = hk * group + i / nqs, q0 = (qt_first + i % nqs) * kTile;
    const long long rows = ((long long)b * a.H + h) * Lq;
    load_tile<D>(q + rows * D, D, q0, Lq, ring + 2 * st * TILE, tid);
    load_tile<D>(go + rows * D, D, q0, Lq, ring + (2 * st + 1) * TILE, tid);
    load_lse_delta(a.lse + rows, a.delta + rows, q0, Lq,
                   srs + st * kLseStage, tid);
    if (full_bias)
      load_bias(BiasTile{a.bias + b * a.sb + h * a.sh + q0 * a.sq, a.sq,
                         kTile, Lq - q0, Lk},
                k0, sb + st * kTile * kTile, tid);
  };

  load_tile<D>((const bf16*)a.k + krows * D, D, k0, Lk, sk, tid);
  load_tile<D>((const bf16*)a.v + krows * D, D, k0, Lk, sv, tid);
  if (n > 0) issue(0, 0);
  cp_async_commit();

  // the thread's keys g and g + 8: -inf past Lk (P = 0), else the bias
  // that broadcasts over q rows (of the current head), else 0
  auto bias_of_key = [&](int h, int i) {
    const int key = k0 + wrow + g + 8 * i;
    return key >= Lk ? -INFINITY
           : row_bias ? a.bias[b * a.sb + h * a.sh + key]
                      : 0.f;
  };
  float kb[2] = {bias_of_key(hk * group, 0), bias_of_key(hk * group, 1)};
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  const uint32_t ska = smem_addr(sk), sva = smem_addr(sv);

  for (int i = 0; i < n; ++i) {
    const int st = i & 1, q0 = (qt_first + i % nqs) * kTile;
    if (i + 1 < n) issue(i + 1, st ^ 1);   // the next step, other stage
    cp_async_commit();
    cp_async_wait<1>();   // all but the newest group: step i (and K, V)
    __syncthreads();
    if (row_bias && a.sh != 0 && i > 0 && i % nqs == 0) {
      kb[0] = bias_of_key(hk * group + i / nqs, 0);   // the next head's
      kb[1] = bias_of_key(hk * group + i / nqs, 1);   // row
    }

    if (warp_live) {
      const uint32_t sqa = smem_addr(ring + 2 * st * TILE);
      const uint32_t sdoa = smem_addr(ring + (2 * st + 1) * TILE);
      const float* rs = srs + st * kLseStage;
      const float* bt = sb + st * kTile * kTile;
      const bool edge = q0 + kTile > Lq;
      // q column `first` is the first that sees the warp's first key; the
      // sub-steps before it are wholly masked
      int c_begin = 0;
      bool diag = false;
      if (a.causal) {
        const long long first = (long long)k0 + wrow - a.q_offset - q0;
        c_begin = first <= 0 ? 0
                  : first >= kTile ? kTile
                                   : (int)first & ~(NS - 1);
        diag = first + 15 > 0;   // the tile crosses a key's causal edge
      }
      for (int c0 = c_begin; c0 < kTile && q0 + c0 < Lq; c0 += NS) {
        float s[NS / 8][4], dp[NS / 8][4];
        mma_abt_a<D, NS / 8>(ska, wrow, sqa, c0, s);     // S^T = K.Q^T
        mma_abt_a<D, NS / 8>(sva, wrow, sdoa, c0, dp);   // dP^T = V.dO^T
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          // element e: key row g + 8 (e / 2), q column c + e % 2
          const int c = c0 + 8 * j + 2 * t4;
          const float2 ls = *reinterpret_cast<const float2*>(rs + c);
          const float2 dl = *reinterpret_cast<const float2*>(rs + kTile + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i2 = e >> 1, qi = e & 1;
            const int key = k0 + wrow + g + 8 * i2;
            float x = s[j][e] * scale;
            if (diag && key > a.q_offset + q0 + c + qi) x += kNegInf;
            x += kb[i2];
            if (full_bias) x += bias_at(bt, c + qi, wrow + g + 8 * i2);
            float p = ex2((x - (qi ? ls.y : ls.x)) * kLog2e);
            if (edge && q0 + c + qi >= Lq) p = 0.f;   // not a query
            dp[j][e] = p * (dp[j][e] - (qi ? dl.y : dl.x)) * scale;  // dS^T
            s[j][e] = p;                                             // P^T
          }
        }
        mma_pb<D, NS / 16>(s, sdoa, c0, acc_v);    // dV += P^T.dO
        mma_pb<D, NS / 16>(dp, sqa, c0, acc_k);    // dK += dS^T.Q
      }
    }
    __syncthreads();   // stage st fully read before step i + 2 lands in it
  }
  cp_async_wait<0>();
  __syncthreads();     // K and V landed, also when no q tile sees them
  if (!warp_live) return;
  const float one[2] = {1.f, 1.f};
  store_rows<D>(acc_k, one, sk, dk + krows * D, D, k0, Lk);
  store_rows<D>(acc_v, one, sv, dv + krows * D, D, k0, Lk);
}

template <typename Kernel>
static cudaError_t smem_limit(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Bytes of the bias ring: a full tile per stage, a row, or none.
static size_t bias_ring(const BwdArgs& a) {
  return a.bias == nullptr ? 0 : tc::bias_smem_bytes(a.sq == 0 ? 1 : kT);
}

template <int D>
static int launch_dq_tc(const BwdArgs& a, void* dq, cudaStream_t st) {
  const size_t smem = tc::bwd_smem_bytes<D>() + bias_ring(a);
  const cudaError_t err = smem_limit(flash_bwd_dq_kernel_tc<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.H, a.B, (a.Lq + kT - 1) / kT);
  flash_bwd_dq_kernel_tc<D><<<grid, tc::kThreads, smem, st>>>(
      a, (tc::bf16*)dq);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dkv_tc(const BwdArgs& a, void* dk, void* dv,
                         cudaStream_t st) {
  // the per-key row bias lives in registers: only a full tile needs a ring
  const size_t smem = tc::bwd_smem_bytes<D>() +
                      2 * tc::kLseStage * sizeof(float) +
                      (a.sq == 0 ? 0 : bias_ring(a));
  const cudaError_t err = smem_limit(flash_bwd_dkv_kernel_tc<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.H_kv, a.B, (a.Lk + kT - 1) / kT);
  flash_bwd_dkv_kernel_tc<D><<<grid, tc::kThreads, smem, st>>>(
      a, (tc::bf16*)dk, (tc::bf16*)dv);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- fp32 launchers

template <int D>
static int launch_dq_d(const BwdArgs& a, void* dq, cudaStream_t st) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Lq + kT - 1) / kT, a.H, a.B), block(kBwdThreads);
  flash_bwd_dq_kernel<D><<<grid, block, smem, st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, a.bias,
      (const float*)a.dout, a.lse, a.delta, (float*)dq, a.H, a.H_kv, a.Lq,
      a.Lk, a.sb, a.sh, a.sq, a.causal, a.q_offset);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dkv_d(const BwdArgs& a, void* dk, void* dv,
                        cudaStream_t st) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Lk + kT - 1) / kT, a.H_kv, a.B), block(kBwdThreads);
  flash_bwd_dkv_kernel<D><<<grid, block, smem, st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, a.bias,
      (const float*)a.dout, a.lse, a.delta, (float*)dk, (float*)dv, a.H,
      a.H_kv, a.Lq, a.Lk, a.sb, a.sh, a.sq, a.causal, a.q_offset);
  return (int)cudaGetLastError();
}

static BwdArgs make_args(const void* q, const void* k, const void* v,
                         const void* bias, const void* dout, const void* lse,
                         const void* delta, int B, int H, int H_kv, int Lq,
                         int Lk, long long sb, long long sh, long long sq,
                         int causal, int q_offset) {
  return BwdArgs{q, k, v, dout, (const float*)bias, (const float*)lse,
                 (const float*)delta, B, H, H_kv, Lq, Lk, sb, sh, sq,
                 causal, q_offset};
}

// The tensor-core kernels read the bias through the ring: 16-byte aligned
// rows (every stride a multiple of 4 floats).
static bool bias_aligned(const BwdArgs& a) {
  return a.bias == nullptr ||
         (((uintptr_t)a.bias & 15) == 0 && (a.sb | a.sh | a.sq) % 4 == 0);
}

}  // namespace vyomai

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq, int B, int H,
                                   int H_kv, int Lq, int Lk, int D,
                                   long long bias_sb, long long bias_sh,
                                   long long bias_sq, int causal,
                                   int q_offset, int is_bf16, void* stream) {
  using namespace vyomai;
  if ((D != 64 && D != 128) || H % H_kv) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, bias, dout, lse, delta, B, H, H_kv,
                              Lq, Lk, bias_sb, bias_sh, bias_sq, causal,
                              q_offset);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    if (!bias_aligned(a)) return (int)cudaErrorInvalidValue;
    return D == 64 ? launch_dq_tc<64>(a, dq, st) : launch_dq_tc<128>(a, dq, st);
  }
  return D == 64 ? launch_dq_d<64>(a, dq, st)
                 : launch_dq_d<128>(a, dq, st);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv,
                                    int B, int H, int H_kv, int Lq, int Lk,
                                    int D, long long bias_sb,
                                    long long bias_sh, long long bias_sq,
                                    int causal, int q_offset, int is_bf16,
                                    void* stream) {
  using namespace vyomai;
  if ((D != 64 && D != 128) || H % H_kv) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, bias, dout, lse, delta, B, H, H_kv,
                              Lq, Lk, bias_sb, bias_sh, bias_sq, causal,
                              q_offset);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    if (!bias_aligned(a)) return (int)cudaErrorInvalidValue;
    return D == 64 ? launch_dkv_tc<64>(a, dk, dv, st)
                   : launch_dkv_tc<128>(a, dk, dv, st);
  }
  return D == 64 ? launch_dkv_d<64>(a, dk, dv, st)
                 : launch_dkv_d<128>(a, dk, dv, st);
}

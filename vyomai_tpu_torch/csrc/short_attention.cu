// Short bidirectional attention for Hopper (sm_90a): K5/K6 forward and the
// K7 backward.
//
// Replaces the TPU kernels of vyomai_tpu/ops/short_attention.py:
// `_kernel` / `_kernel_paired` (K5, [B, H, L, D] with an optional key-pad
// bias), `_kernel_qkv` (K6, the same math reading the packed fused-qkv
// projection [B, L, 3*H*D]) and `_kernel_bwd` (K7). Every tensor is
// addressed through (batch, head, row) strides in elements with unit
// stride along D, so one forward kernel serves both layouts: K6's q/k/v are
// views of the packed tensor at column offsets 0, H*D and 2*H*D with row
// stride 3*H*D, and its output is written as [B, L, H*D] directly. The
// backward writes dq/dk/dv through the inputs' strides, so for K6 it fills
// the packed dx [B, L, 3*H*D] with no transpose in device memory.
//
// The head pairing and block-diagonal packing of the TPU kernels fill its
// 128-wide matrix unit; they are not ported. Softmax semantics kept from
// the TPU kernels: scores s = q.k / sqrt(D) + bias[key] in fp32, a row max
// per head, p = exp(s - max), normalisation after the PV sum. A query row
// whose keys are all padded (every score ~ finfo(fp32).min) gets a uniform
// softmax, the mean of V, as the TPU kernel and the "xla" route give; no
// -1e30 floor (that is the flash kernels' contract, not this one). The
// forward also writes each row's (final max, sum of exp(s - max)) when the
// caller asks, so the backward recomputes P = exp(s - max) / sum tile by
// tile with no [L, L] residual.
//
// What bounds them on the H100: 4*D FLOPs per (query, key) pair forward
// and 10*D backward (five products), on operands reused across 64x64 tiles. At D = 64 and
// L = 128 or 197 (MLM, ViT) the bf16 forward's bytes (q, k, v read once, o
// written once) take longer at 3.35 TB/s than its products at the tensor
// cores' rate; at L = 512, and for the backward, arithmetic binds.
//
// The forward launcher picks the kernel by dtype. This is a dispatch, not a
// fallback: each path raises (a non-zero cudaError_t) on failure, and a bf16
// tensor never reaches the CUDA-core forward.
//
// - bf16 forward: `short_fwd_kernel_tc`, the tensor-core core of
//   attn_fwd_tc.cuh in one pass (mma.sync m16n8k16, ldmatrix, a cp.async
//   double-buffered K/V ring, online softmax in registers with the running
//   max starting at -inf, P in bf16): no score block in shared memory, 40
//   KB of it at D = 64. One CTA of 4 warps per (64-row q tile, head,
//   batch); a warp whose 16 rows lie past L only helps load.
// - fp32 forward: `short_fwd_kernel`, fp32 FMAs on the CUDA cores (tensor
//   cores would round fp32 inputs to TF32). One CTA of 128 threads per
//   (64-row q tile, head, batch). The q tile is staged once in shared
//   memory as fp32. Pass 1 streams 64-key K tiles and writes the tile's
//   whole fp32 score block [64][Lpad+1] to shared memory (at most 64 x 513
//   floats), tracking each row's max; then each row's exp and sum; pass 2
//   streams 64-key V tiles and accumulates p.V in registers. Each thread
//   owns 8 rows x 4 columns of a 64x64 score tile and 8 rows x D/16 output
//   columns, so row reductions are 16-lane shuffles.
//
// The backward launcher dispatches by dtype the same way: a failed launch
// returns its cudaError_t, and a bf16 tensor never reaches a CUDA-core
// backward. Both paths take K2/K3's deterministic decomposition (no
// atomics); the wrapper computes delta = rowsum(dO * O) (= rowsum(dP * P)),
// then
// - dq: one CTA per (64-row q tile, head, batch) walks the K/V tiles,
//   forms dS = P * (dP - delta) / sqrt(D) and accumulates dq = dS.K;
// - dk/dv: one CTA per (64-key tile, head, batch) walks the q tiles and
//   accumulates dk = dS^T.q and dv = P^T.dO.
//
// - bf16 backward: `short_bwd_dq_kernel_tc` / `short_bwd_dkv_kernel_tc`,
//   the tensor-core core of attn_bwd_tc.cuh (mma.sync, ldmatrix /
//   ldmatrix.trans, a cp.async double-buffered ring of the streamed tiles,
//   P and dS in registers, rounded to bf16 only as the A operand of their
//   products): 4 warps a CTA, 16 rows a warp. The key-pad bias reaches dq
//   through the ring (a 64-float row a stage) and dk/dv as two registers a
//   thread (its keys are fixed). Shared memory 6 * 64 * D * 2 bytes (48 KB
//   at D = 64) plus 1.5 KB of row statistics (dk/dv) or 512 bytes of bias
//   (dq). Arithmetic binds it: 14 * D FLOPs issued per (query, key) pair
//   (the recompute of S and dP in both kernels) against 10 * D essential.
// - fp32 backward: `short_bwd_dq_kernel` / `short_bwd_dkv_kernel`, fp32
//   FMAs on the CUDA cores (phases 8 and 12 hold fp32 gradients to 1e-4 of
//   their max, and TF32 would round the inputs): 256 threads a CTA, dS
//   through shared memory. Tiles are staged as fp32 in rows padded to D+1
//   floats (the column walks then hit distinct banks) with 16-byte vector
//   loads.
//
// Shared memory of the CUDA-core kernels: the fp32 forward 4*(2*64*(D+1) +
// 64*(Lpad+1)) bytes (up to 197 KB at L = 512, D = 128); dq 4*(4*64*(D+1) +
// 64*65) (83 KB at D = 64, 149 KB at D = 128); dk/dv that plus a second
// 64x65 tile and three row vectors (100 KB, 166 KB). All above 48 KB, so
// the launchers raise the dynamic limit.

#include "attn_fwd_tc.cuh"
#include "attn_bwd_tc.cuh"

namespace vyomai {

constexpr int kSaT = 64;              // rows of every q / key tile
constexpr int kSaFwdThreads = 128;
constexpr int kSaBwdThreads = 256;
constexpr int kSaLDP = kSaT + 1;      // padded row of a 64x64 tile

struct SaArgs {
  const void *q, *k, *v;              // share the input strides
  const float* bias;                  // [B|1, L] key-pad bias or null
  long long bias_sb;                  // 0 when broadcast over the batch
  int H, L;
  long long sb, sh, sr;               // q/k/v (and dq/dk/dv) strides
  long long ob, oh, orow;             // out / dO strides
};

__host__ __device__ inline int sa_lpad(int L) {
  return (L + kSaT - 1) / kSaT * kSaT;
}

template <int D>
size_t sa_fwd_smem(int L) {
  return sizeof(float) * ((size_t)2 * kSaT * (D + 1) +
                          (size_t)kSaT * (sa_lpad(L) + 1));
}

template <int D>
constexpr size_t sa_dq_smem() {
  return sizeof(float) * (size_t)(4 * kSaT * (D + 1) + kSaT * kSaLDP);
}

template <int D>
constexpr size_t sa_dkv_smem() {
  return sizeof(float) *
         (size_t)(4 * kSaT * (D + 1) + 2 * kSaT * kSaLDP + 3 * kSaT);
}

// Stage rows [row0, row0 + 64) of a strided fp32 [rows, D] matrix into
// dst[64][D+1]; rows at or past `rows` are zero.
template <int D, int NT>
__device__ __forceinline__ void sa_stage(const float* __restrict__ src,
                                         long long row_stride, int row0,
                                         int rows, float* dst, int tid) {
  constexpr int VN = Vec<float>::kN, CPR = D / VN, LD = D + 1;
  for (int c = tid; c < kSaT * CPR; c += NT) {
    const int r = c / CPR, col = (c % CPR) * VN;
    float x[VN];
    if (row0 + r < rows) {
      load_vec<float>(src + (long long)(row0 + r) * row_stride + col, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[r * LD + col + e] = x[e];
  }
}

// ---------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(tc::kThreads, tc::min_ctas<D>())
short_fwd_kernel_tc(SaArgs a, tc::bf16* __restrict__ out,
                    float* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  tc::bf16* smem = reinterpret_cast<tc::bf16*>(tc_smem);
  const int L = a.L, qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kSaT;
  const long long head = (long long)b * a.sb + (long long)h * a.sh;
  // one key-pad row for every q row; the launcher checked its alignment
  const tc::BiasTile bt{
      a.bias == nullptr ? nullptr : a.bias + b * a.bias_sb, 0, 1, 1, L};

  tc::FwdAcc<D> acc;
  tc::fwd_core<D, false>((const tc::bf16*)a.q + head, a.sr,
                         (const tc::bf16*)a.k + head,
                         (const tc::bf16*)a.v + head, a.sr, L, L, q0,
                         sa_lpad(L) / kSaT, (float)(1.0 / sqrt((double)D)),
                         0, 0, bt, smem, acc);

  const int wrow = q0 + (threadIdx.x >> 5) * 16, lane = threadIdx.x & 31;
  if (wrow >= L) return;   // a tail warp: no live row
  const int r0 = wrow + (lane >> 2);
  // every live row has a key at its max, so its sum is at least 1
  const float inv_l[2] = {1.f / acc.l[0], 1.f / acc.l[1]};
  if (stats != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < L)
        *reinterpret_cast<float2*>(
            stats + (((long long)b * a.H + h) * L + r) * 2) =
            make_float2(acc.m[i], acc.l[i]);
    }
  }
  tc::store_rows<D>(acc.o, inv_l, smem,
                    out + (long long)b * a.ob + (long long)h * a.oh, a.orow,
                    q0, L);
}

// fp32 on the CUDA cores: two passes over a whole score block
template <int D>
__global__ void __launch_bounds__(kSaFwdThreads)
short_fwd_kernel(SaArgs a, float* __restrict__ out,
                 float* __restrict__ stats) {
  constexpr int NT = kSaFwdThreads, LD = D + 1, DJ = D / 16;
  const int L = a.L, LDS = sa_lpad(L) + 1, nk = sa_lpad(L) / kSaT;
  extern __shared__ float smem[];
  float* qs = smem;                   // [64][LD]
  float* kvs = qs + kSaT * LD;        // [64][LD]: a K tile, later a V tile
  float* ss = kvs + kSaT * LD;        // [64][LDS]: scores, then exp

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kSaT;
  const long long head = (long long)b * a.sb + (long long)h * a.sh;
  const float* qb = (const float*)a.q + head;
  const float* kb = (const float*)a.k + head;
  const float* vb = (const float*)a.v + head;
  const float* bb = a.bias == nullptr ? nullptr : a.bias + b * a.bias_sb;
  const float scale = (float)(1.0 / sqrt((double)D));

  sa_stage<D, NT>(qb, a.sr, q0, L, qs, tid);
  float mx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i] = -INFINITY;

  // pass 1: the score block and each row's max
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kSaT;
    __syncthreads();                  // previous K tile fully consumed
    sa_stage<D, NT>(kb, a.sr, k0, L, kvs, tid);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float x[8], kk[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = qs[(ty * 8 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = kvs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      const float kb_add = (c < L && bb != nullptr) ? bb[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // the ragged key edge is no key at all: exp gives exactly 0
        const float x = c < L ? s[i][j] * scale + kb_add : -INFINITY;
        ss[(ty * 8 + i) * LDS + c] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
  }

  // each row's max and sum; a thread rewrites only its own columns
  float lsum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    float* row = ss + (ty * 8 + i) * LDS;
    float sum = 0.f;
    for (int c = tx; c < nk * kSaT; c += 16) {
      const float p = expf(row[c] - mx[i]);
      row[c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    lsum[i] = sum;
    const int r = q0 + ty * 8 + i;
    if (stats != nullptr && tx == 0 && r < L) {
      float* st = stats + (((long long)b * a.H + h) * L + r) * 2;
      st[0] = mx[i];
      st[1] = sum;
    }
  }

  // pass 2: o = p.V, normalised after the sum
  float o[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kSaT;
    __syncthreads();                  // p rows and the previous tile ready
    sa_stage<D, NT>(vb, a.sr, k0, L, kvs, tid);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kSaT; ++c) {
      float p[8], vv[DJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = ss[(ty * 8 + i) * LDS + k0 + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = kvs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(p[i], vv[j], o[i][j]);
    }
  }

  float* ob = out + (long long)b * a.ob + (long long)h * a.oh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty * 8 + i;
    if (r >= L) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(long long)r * a.orow + tx + 16 * j] = o[i][j] / lsum[i];
  }
}

// --------------------------------------------------------------- backward

// P of one (query r, key c) pair from its raw dot q.k, or 0 outside the
// ragged edge.
__device__ __forceinline__ float sa_p(float dot, int r, int c, int L,
                                      float scale, const float* bb,
                                      float row_max, float row_inv) {
  if (r >= L || c >= L) return 0.f;
  const float x = dot * scale + (bb != nullptr ? bb[c] : 0.f);
  return expf(x - row_max) * row_inv;
}

template <int D>
__global__ void __launch_bounds__(kSaBwdThreads)
short_bwd_dq_kernel(SaArgs a, const float* __restrict__ dout,
                    const float* __restrict__ stats,
                    const float* __restrict__ delta, float* __restrict__ dq) {
  constexpr int NT = kSaBwdThreads, LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                   // [64][LD]
  float* dos = qs + kSaT * LD;        // [64][LD]
  float* ks = dos + kSaT * LD;        // [64][LD]
  float* vs = ks + kSaT * LD;         // [64][LD]
  float* ds = vs + kSaT * LD;         // [64][kSaLDP]

  const int L = a.L, qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kSaT;
  const long long head = (long long)b * a.sb + (long long)h * a.sh;
  const long long ohead = (long long)b * a.ob + (long long)h * a.oh;
  const long long rows = ((long long)b * a.H + h) * L;
  const float* bb = a.bias == nullptr ? nullptr : a.bias + b * a.bias_sb;
  const float scale = (float)(1.0 / sqrt((double)D));

  sa_stage<D, NT>((const float*)a.q + head, a.sr, q0, L, qs, tid);
  sa_stage<D, NT>(dout + ohead, a.orow, q0, L, dos, tid);
  float rmax[4], rinv[4], rdelta[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    rmax[i] = r < L ? stats[(rows + r) * 2] : 0.f;
    rinv[i] = r < L ? 1.f / stats[(rows + r) * 2 + 1] : 0.f;
    rdelta[i] = r < L ? delta[rows + r] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = sa_lpad(L) / kSaT;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kSaT;
    __syncthreads();                  // previous tile's ks/vs/ds consumed
    sa_stage<D, NT>((const float*)a.k + head, a.sr, k0, L, ks, tid);
    sa_stage<D, NT>((const float*)a.v + head, a.sr, k0, L, vs, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float x[4], g[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = qs[(ty * 4 + i) * LD + d];
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
          s[i][j] = fmaf(x[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = q0 + ty * 4 + i, c = k0 + tx + 16 * j;
        const float p = sa_p(s[i][j], r, c, L, scale, bb, rmax[i], rinv[i]);
        ds[(ty * 4 + i) * kSaLDP + tx + 16 * j] =
            p * (dp[i][j] - rdelta[i]) * scale;
      }
    __syncthreads();                  // ds rows are written by 16 threads
#pragma unroll 4
    for (int c = 0; c < kSaT; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds[(ty * 4 + i) * kSaLDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j],
                                                      acc[i][j]);
    }
  }

  float* dqb = dq + head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= L) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[(long long)r * a.sr + tx + 16 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(kSaBwdThreads)
short_bwd_dkv_kernel(SaArgs a, const float* __restrict__ dout,
                     const float* __restrict__ stats,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv) {
  constexpr int NT = kSaBwdThreads, LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                   // [64][LD]
  float* vs = ks + kSaT * LD;         // [64][LD]
  float* qs = vs + kSaT * LD;         // [64][LD]
  float* dos = qs + kSaT * LD;        // [64][LD]
  float* pt = dos + kSaT * LD;        // [64 keys][kSaLDP queries]: P^T
  float* dst = pt + kSaT * kSaLDP;    // [64][kSaLDP]: dS^T
  float* max_s = dst + kSaT * kSaLDP; // [64]
  float* inv_s = max_s + kSaT;        // [64]
  float* delta_s = inv_s + kSaT;      // [64]

  const int L = a.L, kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kSaT;
  const long long head = (long long)b * a.sb + (long long)h * a.sh;
  const long long ohead = (long long)b * a.ob + (long long)h * a.oh;
  const long long rows = ((long long)b * a.H + h) * L;
  const float* bb = a.bias == nullptr ? nullptr : a.bias + b * a.bias_sb;
  const float scale = (float)(1.0 / sqrt((double)D));

  sa_stage<D, NT>((const float*)a.k + head, a.sr, k0, L, ks, tid);
  sa_stage<D, NT>((const float*)a.v + head, a.sr, k0, L, vs, tid);
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int nq = sa_lpad(L) / kSaT;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kSaT;
    __syncthreads();                  // previous q tile fully consumed
    sa_stage<D, NT>((const float*)a.q + head, a.sr, q0, L, qs, tid);
    sa_stage<D, NT>(dout + ohead, a.orow, q0, L, dos, tid);
    if (tid < kSaT) {
      const int r = q0 + tid;
      max_s[tid] = r < L ? stats[(rows + r) * 2] : 0.f;
      inv_s[tid] = r < L ? 1.f / stats[(rows + r) * 2 + 1] : 0.f;
      delta_s[tid] = r < L ? delta[rows + r] : 0.f;
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
      float kk[4], vv[4], x[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = ks[(ty * 4 + i) * LD + d];
        vv[i] = vs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = qs[(tx + 16 * j) * LD + d];
        g[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kk[i], x[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], g[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + ty * 4 + i, rr = tx + 16 * j;
        const float p = sa_p(s[i][j], q0 + rr, c, L, scale, bb, max_s[rr],
                             inv_s[rr]);
        pt[(ty * 4 + i) * kSaLDP + rr] = p;
        dst[(ty * 4 + i) * kSaLDP + rr] = p * (dp[i][j] - delta_s[rr]) *
                                          scale;
      }
    __syncthreads();                  // pt/dst rows are written by 16 threads
#pragma unroll 4
    for (int c = 0; c < kSaT; ++c) {
      float pv[4], dsv[4], gv[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt[(ty * 4 + i) * kSaLDP + c];
        dsv[i] = dst[(ty * 4 + i) * kSaLDP + c];
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

  float* dkb = dk + head;
  float* dvb = dv + head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= L) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkb[(long long)c * a.sr + tx + 16 * j] = acc_k[i][j];
      dvb[(long long)c * a.sr + tx + 16 * j] = acc_v[i][j];
    }
  }
}

// bf16 on the tensor cores (attn_bwd_tc.cuh): dq for one 64-row q tile.
template <int D>
__global__ void __launch_bounds__(tc::kThreads, tc::bwd_min_ctas<D>())
short_bwd_dq_kernel_tc(SaArgs a, const tc::bf16* __restrict__ dout,
                       const float* __restrict__ stats,
                       const float* __restrict__ delta,
                       tc::bf16* __restrict__ dq) {
  using namespace tc;
  constexpr int KC = D / 16, TILE = kTile * D, NS = kDqSub;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sq = reinterpret_cast<bf16*>(tc_smem);   // q, later dq staging
  bf16* sdo = sq + TILE;
  bf16* ring = sdo + TILE;                       // stage s: K, then V
  float* sb = reinterpret_cast<float*>(ring + 4 * TILE);   // bias rows

  const int L = a.L, q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, wrow = (tid >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const bool warp_live = q0 + wrow < L;
  const long long head = (long long)b * a.sb + (long long)h * a.sh;
  const long long rows = ((long long)b * a.H + h) * L;
  const bf16* k = (const bf16*)a.k + head;
  const bf16* v = (const bf16*)a.v + head;
  const BiasTile bt{a.bias == nullptr ? nullptr : a.bias + b * a.bias_sb, 0,
                    1, 1, L};
  const bool has_bias = bt.src != nullptr;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int nk = sa_lpad(L) / kTile;

  load_tile<D>((const bf16*)a.q + head, a.sr, q0, L, sq, tid);
  load_tile<D>(dout + (long long)b * a.ob + (long long)h * a.oh, a.orow, q0,
               L, sdo, tid);
  load_tile<D>(k, a.sr, 0, L, ring, tid);
  load_tile<D>(v, a.sr, 0, L, ring + TILE, tid);
  if (has_bias) load_bias(bt, 0, sb, tid);
  cp_async_commit();

  // the thread's rows g and g + 8: max, 1 / sum and delta (0 past L: P = 0)
  float m[2], inv[2], de[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + wrow + g + 8 * i;
    const bool live = r < L;
    m[i] = live ? stats[(rows + r) * 2] : 0.f;
    inv[i] = live ? __frcp_rn(stats[(rows + r) * 2 + 1]) : 0.f;
    de[i] = live ? delta[rows + r] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[KC][4], df[KC][4];

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kTile;
    if (kt + 1 < nk) {   // the next tile into the other stage
      load_tile<D>(k, a.sr, k0 + kTile, L, ring + 2 * (st ^ 1) * TILE, tid);
      load_tile<D>(v, a.sr, k0 + kTile, L, ring + (2 * (st ^ 1) + 1) * TILE,
                   tid);
      if (has_bias) load_bias(bt, k0 + kTile, sb + (st ^ 1) * kTile, tid);
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
      const float* brow = sb + st * kTile;
      const bool edge = k0 + kTile > L;
      for (int c0 = 0; c0 < kTile && k0 + c0 < L; c0 += NS) {
        float s[NS / 8][4], dp[NS / 8][4];
        mma_abt<D, NS / 8>(qf, ska, c0, s);    // S = Q.K^T
        mma_abt<D, NS / 8>(df, sva, c0, dp);   // dP = dO.V^T
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          // element e: row g + 8 (e / 2), key column c + e % 2
          const int c = c0 + 8 * j + 2 * t4;
          const float2 kb = has_bias ? tile_bias(brow, 1, 0, c)
                                     : make_float2(0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float x = s[j][e] * scale + ((e & 1) ? kb.y : kb.x);
            if (edge && k0 + c + (e & 1) >= L) x = -INFINITY;   // not a key
            const float p = ex2((x - m[i]) * kLog2e) * inv[i];
            dp[j][e] = p * (dp[j][e] - de[i]) * scale;   // dS
          }
        }
        mma_pb<D, NS / 16>(dp, ska, c0, acc);   // dQ += dS.K
      }
    }
    __syncthreads();   // stage st fully read before tile kt + 2 lands in it
  }
  cp_async_wait<0>();
  if (!warp_live) return;
  const float one[2] = {1.f, 1.f};
  store_rows<D>(acc, one, sq, dq + head, a.sr, q0, L);
}

// bf16 on the tensor cores (attn_bwd_tc.cuh): dk and dv for 64 keys.
template <int D>
__global__ void __launch_bounds__(tc::kThreads, tc::bwd_min_ctas<D>())
short_bwd_dkv_kernel_tc(SaArgs a, const tc::bf16* __restrict__ dout,
                        const float* __restrict__ stats,
                        const float* __restrict__ delta,
                        tc::bf16* __restrict__ dk,
                        tc::bf16* __restrict__ dv) {
  using namespace tc;
  constexpr int KC = D / 16, TILE = kTile * D, NS = kDkvSub;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sk = reinterpret_cast<bf16*>(tc_smem);   // K, later dk staging
  bf16* sv = sk + TILE;                          // V, later dv staging
  bf16* ring = sv + TILE;                        // stage s: q, then dO
  float* srs = reinterpret_cast<float*>(ring + 4 * TILE);   // row stats

  const int L = a.L, k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, wrow = (tid >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const bool warp_live = k0 + wrow < L;
  const long long head = (long long)b * a.sb + (long long)h * a.sh;
  const long long rows = ((long long)b * a.H + h) * L;
  const bf16* q = (const bf16*)a.q + head;
  const bf16* go = dout + (long long)b * a.ob + (long long)h * a.oh;
  const float* ms = stats + rows * 2;
  const float* dl = delta + rows;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int nq = sa_lpad(L) / kTile;

  load_tile<D>((const bf16*)a.k + head, a.sr, k0, L, sk, tid);
  load_tile<D>((const bf16*)a.v + head, a.sr, k0, L, sv, tid);
  load_tile<D>(q, a.sr, 0, L, ring, tid);
  load_tile<D>(go, a.orow, 0, L, ring + TILE, tid);
  load_row_stats(ms, dl, 0, L, srs, tid);
  cp_async_commit();

  // the key-pad bias of the thread's keys g and g + 8 (-inf past L: P = 0)
  float kb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + wrow + g + 8 * i;
    kb[i] = key >= L ? -INFINITY
            : a.bias == nullptr ? 0.f
                                : a.bias[b * a.bias_sb + key];
  }
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  const uint32_t ska = smem_addr(sk), sva = smem_addr(sv);

  for (int qt = 0; qt < nq; ++qt) {
    const int st = qt & 1, q0 = qt * kTile;
    if (qt + 1 < nq) {   // the next tile into the other stage
      load_tile<D>(q, a.sr, q0 + kTile, L, ring + 2 * (st ^ 1) * TILE, tid);
      load_tile<D>(go, a.orow, q0 + kTile, L,
                   ring + (2 * (st ^ 1) + 1) * TILE, tid);
      load_row_stats(ms, dl, q0 + kTile, L, srs + (st ^ 1) * kRowStage, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // all but the newest group: tile qt (and K, V)
    __syncthreads();

    if (warp_live) {
      const uint32_t sqa = smem_addr(ring + 2 * st * TILE);
      const uint32_t sdoa = smem_addr(ring + (2 * st + 1) * TILE);
      const float* rs = srs + st * kRowStage;
      for (int c0 = 0; c0 < kTile && q0 + c0 < L; c0 += NS) {
        float s[NS / 8][4], dp[NS / 8][4];
        uint32_t kf[KC][4], vf[KC][4];
        load_a<D>(ska, wrow, kf);
        mma_abt<D, NS / 8>(kf, sqa, c0, s);     // S^T = K.Q^T
        load_a<D>(sva, wrow, vf);
        mma_abt<D, NS / 8>(vf, sdoa, c0, dp);   // dP^T = V.dO^T
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          // element e: key row g + 8 (e / 2), q column c + e % 2
          const int c = c0 + 8 * j + 2 * t4;
          const float4 st2 = *reinterpret_cast<const float4*>(rs + 2 * c);
          const float2 de = *reinterpret_cast<const float2*>(rs + 2 * kTile
                                                             + c);
          const float m[2] = {st2.x, st2.z};
          const float inv[2] = {__frcp_rn(st2.y), __frcp_rn(st2.w)};
          const float dlt[2] = {de.x, de.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e & 1;
            const float x = s[j][e] * scale + kb[e >> 1];
            float p = ex2((x - m[i]) * kLog2e) * inv[i];
            if (q0 + c + i >= L) p = 0.f;   // not a query
            dp[j][e] = p * (dp[j][e] - dlt[i]) * scale;   // dS^T
            s[j][e] = p;                                  // P^T
          }
        }
        mma_pb<D, NS / 16>(s, sdoa, c0, acc_v);    // dV += P^T.dO
        mma_pb<D, NS / 16>(dp, sqa, c0, acc_k);    // dK += dS^T.Q
      }
    }
    __syncthreads();   // stage st fully read before tile qt + 2 lands in it
  }
  cp_async_wait<0>();
  if (!warp_live) return;
  const float one[2] = {1.f, 1.f};
  store_rows<D>(acc_k, one, sk, dk + head, a.sr, k0, L);
  store_rows<D>(acc_v, one, sv, dv + head, a.sr, k0, L);
}

// -------------------------------------------------------------- launchers

template <typename Kernel>
static cudaError_t sa_smem_limit(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
static int sa_fwd_d(const SaArgs& a, int B, void* out, float* stats,
                    bool bf16, cudaStream_t st) {
  static_assert(tc::kThreads == kSaFwdThreads, "one block size");
  const dim3 grid(sa_lpad(a.L) / kSaT, a.H, B);
  cudaError_t err;
  if (bf16) {   // the bias ring reads a 16-byte aligned row
    if (a.bias != nullptr && (((uintptr_t)a.bias & 15) || a.bias_sb % 4))
      return (int)cudaErrorInvalidValue;
    const size_t smem = tc::smem_bytes<D>() +
                        (a.bias == nullptr ? 0 : tc::bias_smem_bytes(1));
    err = sa_smem_limit(short_fwd_kernel_tc<D>, smem);
    if (err != cudaSuccess) return (int)err;
    short_fwd_kernel_tc<D><<<grid, kSaFwdThreads, smem, st>>>(
        a, (tc::bf16*)out, stats);
  } else {
    const size_t smem = sa_fwd_smem<D>(a.L);
    err = sa_smem_limit(short_fwd_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    short_fwd_kernel<D><<<grid, kSaFwdThreads, smem, st>>>(a, (float*)out,
                                                           stats);
  }
  return (int)cudaGetLastError();
}

template <int D>
static int sa_bwd_d(const SaArgs& a, int B, const void* dout,
                    const float* stats, const float* delta, void* dq,
                    void* dk, void* dv, bool bf16, cudaStream_t st) {
  const dim3 grid(sa_lpad(a.L) / kSaT, a.H, B);
  cudaError_t err;
  if (bf16) {   // the bias ring of dq reads a 16-byte aligned row
    if (a.bias != nullptr && (((uintptr_t)a.bias & 15) || a.bias_sb % 4))
      return (int)cudaErrorInvalidValue;
    const size_t dq_smem = tc::bwd_smem_bytes<D>() +
                           (a.bias == nullptr ? 0 : tc::bias_smem_bytes(1));
    err = sa_smem_limit(short_bwd_dq_kernel_tc<D>, dq_smem);
    if (err != cudaSuccess) return (int)err;
    short_bwd_dq_kernel_tc<D><<<grid, tc::kThreads, dq_smem, st>>>(
        a, (const tc::bf16*)dout, stats, delta, (tc::bf16*)dq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t dkv_smem = tc::bwd_smem_bytes<D>() +
                            2 * tc::kRowStage * sizeof(float);
    err = sa_smem_limit(short_bwd_dkv_kernel_tc<D>, dkv_smem);
    if (err != cudaSuccess) return (int)err;
    short_bwd_dkv_kernel_tc<D><<<grid, tc::kThreads, dkv_smem, st>>>(
        a, (const tc::bf16*)dout, stats, delta, (tc::bf16*)dk,
        (tc::bf16*)dv);
    return (int)cudaGetLastError();
  }
  err = sa_smem_limit(short_bwd_dq_kernel<D>, sa_dq_smem<D>());
  if (err != cudaSuccess) return (int)err;
  short_bwd_dq_kernel<D><<<grid, kSaBwdThreads, sa_dq_smem<D>(), st>>>(
      a, (const float*)dout, stats, delta, (float*)dq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sa_smem_limit(short_bwd_dkv_kernel<D>, sa_dkv_smem<D>());
  if (err != cudaSuccess) return (int)err;
  short_bwd_dkv_kernel<D><<<grid, kSaBwdThreads, sa_dkv_smem<D>(), st>>>(
      a, (const float*)dout, stats, delta, (float*)dk, (float*)dv);
  return (int)cudaGetLastError();
}

static SaArgs sa_args(const void* q, const void* k, const void* v,
                      const void* bias, long long bias_sb, int H, int L,
                      long long sb, long long sh, long long sr, long long ob,
                      long long oh, long long orow) {
  return SaArgs{q, k, v, (const float*)bias, bias_sb, H, L, sb, sh, sr,
                ob, oh, orow};
}

static bool sa_shape_ok(int L, int D) {
  return (D == 32 || D == 64 || D == 128) && L >= 1 && L <= 512;
}

}  // namespace vyomai

extern "C" int short_fwd_launch(const void* q, const void* k, const void* v,
                                const void* bias, long long bias_sb,
                                void* out, void* stats, int B, int H, int L,
                                int D, long long sb, long long sh,
                                long long sr, long long ob, long long oh,
                                long long orow, int is_bf16, void* stream) {
  using namespace vyomai;
  if (!sa_shape_ok(L, D)) return (int)cudaErrorInvalidValue;
  const SaArgs a = sa_args(q, k, v, bias, bias_sb, H, L, sb, sh, sr, ob, oh,
                           orow);
  cudaStream_t st = (cudaStream_t)stream;
  float* sp = (float*)stats;
  const bool bf16 = is_bf16 != 0;
  if (D == 32) return sa_fwd_d<32>(a, B, out, sp, bf16, st);
  if (D == 64) return sa_fwd_d<64>(a, B, out, sp, bf16, st);
  return sa_fwd_d<128>(a, B, out, sp, bf16, st);
}

extern "C" int short_bwd_launch(const void* q, const void* k, const void* v,
                                const void* bias, long long bias_sb,
                                const void* dout, const void* stats,
                                const void* delta, void* dq, void* dk,
                                void* dv, int B, int H, int L, int D,
                                long long sb, long long sh, long long sr,
                                long long ob, long long oh, long long orow,
                                int is_bf16, void* stream) {
  using namespace vyomai;
  if (!sa_shape_ok(L, D)) return (int)cudaErrorInvalidValue;
  const SaArgs a = sa_args(q, k, v, bias, bias_sb, H, L, sb, sh, sr, ob, oh,
                           orow);
  cudaStream_t st = (cudaStream_t)stream;
  const float *sp = (const float*)stats, *dp = (const float*)delta;
  const bool bf16 = is_bf16 != 0;
  if (D == 32) return sa_bwd_d<32>(a, B, dout, sp, dp, dq, dk, dv, bf16, st);
  if (D == 64) return sa_bwd_d<64>(a, B, dout, sp, dp, dq, dk, dv, bf16, st);
  return sa_bwd_d<128>(a, B, dout, sp, dp, dq, dk, dv, bf16, st);
}

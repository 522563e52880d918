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
// and 8*D backward, on operands reused across 64x64 tiles. At D = 64 and
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
// Backward design (K2/K3's decomposition, no atomics, deterministic; CUDA
// cores for both dtypes): the wrapper computes delta = rowsum(dO * O) (=
// rowsum(dP * P)); then
// - dq: one CTA of 256 threads per (64-row q tile, head, batch) stages q and
//   dO, walks the K/V tiles, forms dS = P * (dP - delta) / sqrt(D) in shared
//   memory and accumulates dq = dS.K in registers;
// - dk/dv: one CTA per (64-key tile, head, batch) stages K and V, walks the
//   q tiles and accumulates dk = dS^T.q and dv = P^T.dO in registers.
// Tiles are staged as fp32 in rows padded to D+1 floats (the column walks
// then hit distinct banks) with 16-byte vector loads. Shared memory: the
// fp32 forward 4*(2*64*(D+1) + 64*(Lpad+1)) bytes (up to 197 KB at L = 512,
// D = 128); dq 4*(4*64*(D+1) + 64*65) (83 KB at D = 64, 149 KB at D = 128);
// dk/dv that plus a second 64x65 tile and three row vectors (100 KB, 166
// KB). All above 48 KB, so the launchers raise the dynamic limit.

#include "attn_fwd_tc.cuh"

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

// Stage rows [row0, row0 + 64) of a strided [rows, D] matrix into
// dst[64][D+1] as fp32; rows at or past `rows` are zero.
template <typename T, int D, int NT>
__device__ __forceinline__ void sa_stage(const T* __restrict__ src,
                                         long long row_stride, int row0,
                                         int rows, float* dst, int tid) {
  constexpr int VN = Vec<T>::kN, CPR = D / VN, LD = D + 1;
  for (int c = tid; c < kSaT * CPR; c += NT) {
    const int r = c / CPR, col = (c % CPR) * VN;
    float x[VN];
    if (row0 + r < rows) {
      load_vec<T>(src + (long long)(row0 + r) * row_stride + col, x);
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
  tc::store_rows<D>(acc, inv_l, smem,
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

  sa_stage<float, D, NT>(qb, a.sr, q0, L, qs, tid);
  float mx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i] = -INFINITY;

  // pass 1: the score block and each row's max
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kSaT;
    __syncthreads();                  // previous K tile fully consumed
    sa_stage<float, D, NT>(kb, a.sr, k0, L, kvs, tid);
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
    sa_stage<float, D, NT>(vb, a.sr, k0, L, kvs, tid);
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

template <typename T, int D>
__global__ void __launch_bounds__(kSaBwdThreads)
short_bwd_dq_kernel(SaArgs a, const T* __restrict__ dout,
                    const float* __restrict__ stats,
                    const float* __restrict__ delta, T* __restrict__ dq) {
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

  sa_stage<T, D, NT>((const T*)a.q + head, a.sr, q0, L, qs, tid);
  sa_stage<T, D, NT>(dout + ohead, a.orow, q0, L, dos, tid);
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
    sa_stage<T, D, NT>((const T*)a.k + head, a.sr, k0, L, ks, tid);
    sa_stage<T, D, NT>((const T*)a.v + head, a.sr, k0, L, vs, tid);
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

  T* dqb = dq + head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= L) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[(long long)r * a.sr + tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kSaBwdThreads)
short_bwd_dkv_kernel(SaArgs a, const T* __restrict__ dout,
                     const float* __restrict__ stats,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv) {
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

  sa_stage<T, D, NT>((const T*)a.k + head, a.sr, k0, L, ks, tid);
  sa_stage<T, D, NT>((const T*)a.v + head, a.sr, k0, L, vs, tid);
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int nq = sa_lpad(L) / kSaT;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kSaT;
    __syncthreads();                  // previous q tile fully consumed
    sa_stage<T, D, NT>((const T*)a.q + head, a.sr, q0, L, qs, tid);
    sa_stage<T, D, NT>(dout + ohead, a.orow, q0, L, dos, tid);
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

  T* dkb = dk + head;
  T* dvb = dv + head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= L) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkb[(long long)c * a.sr + tx + 16 * j] = from_float<T>(acc_k[i][j]);
      dvb[(long long)c * a.sr + tx + 16 * j] = from_float<T>(acc_v[i][j]);
    }
  }
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

template <typename T, int D>
static int sa_bwd_d(const SaArgs& a, int B, const void* dout,
                    const float* stats, const float* delta, void* dq,
                    void* dk, void* dv, cudaStream_t st) {
  const dim3 grid(sa_lpad(a.L) / kSaT, a.H, B);
  cudaError_t err = sa_smem_limit(short_bwd_dq_kernel<T, D>, sa_dq_smem<D>());
  if (err != cudaSuccess) return (int)err;
  short_bwd_dq_kernel<T, D><<<grid, kSaBwdThreads, sa_dq_smem<D>(), st>>>(
      a, (const T*)dout, stats, delta, (T*)dq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sa_smem_limit(short_bwd_dkv_kernel<T, D>, sa_dkv_smem<D>());
  if (err != cudaSuccess) return (int)err;
  short_bwd_dkv_kernel<T, D><<<grid, kSaBwdThreads, sa_dkv_smem<D>(), st>>>(
      a, (const T*)dout, stats, delta, (T*)dk, (T*)dv);
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
  if (is_bf16) {
    using T = __nv_bfloat16;
    if (D == 32) return sa_bwd_d<T, 32>(a, B, dout, sp, dp, dq, dk, dv, st);
    if (D == 64) return sa_bwd_d<T, 64>(a, B, dout, sp, dp, dq, dk, dv, st);
    return sa_bwd_d<T, 128>(a, B, dout, sp, dp, dq, dk, dv, st);
  }
  if (D == 32) return sa_bwd_d<float, 32>(a, B, dout, sp, dp, dq, dk, dv, st);
  if (D == 64) return sa_bwd_d<float, 64>(a, B, dout, sp, dp, dq, dk, dv, st);
  return sa_bwd_d<float, 128>(a, B, dout, sp, dp, dq, dk, dv, st);
}

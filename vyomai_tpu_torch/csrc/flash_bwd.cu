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
// dS^T.q), all on operands reused across a 64x64 tile. This first version
// runs them as fp32 FMAs on the CUDA cores, like K1, so it is capped well
// below the tensor cores' rate; mma/wgmma is the next step.
//
// Design. 256 threads per CTA; every tile is 64 rows, staged in shared
// memory as fp32 with 16-byte vector loads into rows padded to D+1 floats
// (the column walks then hit distinct banks). A thread owns a 4x4 block of
// each 64x64 score tile (rows ty*4+i, columns tx+16j) and a 4 x D/16 block
// of its accumulators, so no row reduction is needed (lse and delta are
// given).
// - K2: one CTA per (64-row q tile, head, batch). q and dO are staged once;
//   the loop walks 64-key K/V tiles of kv head h / group up to the causal
//   edge, writes dS to shared memory and accumulates dq = dS.K in
//   registers.
// - K3: one CTA per (64-key tile, kv head, batch). K and V are staged once;
//   the loop walks every q head of the GQA group and every q tile at or
//   after the causal edge, computing the transposed tile (keys as rows) so
//   dk = sum dS^T.q and dv = sum P^T.dO accumulate in registers. One CTA
//   owns its keys' whole sum: no atomics, and the result is the same run to
//   run.
// Shared memory: K2 4*64*(D+1) + 64*65 floats (83 KB at D=64, 149 KB at
// D=128); K3 adds a second 64x65 tile and lse/delta rows (100 KB, 166 KB),
// above 48 KB so the launchers raise the dynamic limit. `nvcc -Xptxas -v`
// (CUDA 12.8, sm_90a): K2 126-128 registers, K3 127 at D=64 and 174-176 at
// D=128, no spills; 256 threads x 128 registers and 83-166 KB of shared
// memory leave one CTA per SM. The bias is read in
// place with broadcast strides (0 for a size-1 dim), ragged Lq/Lk edges are
// masked here (P = 0 outside), whole tiles past the causal edge are
// skipped, and masked scores take NEG_INF, so a fully-masked row (lse
// -1e30) gets P = 0 and exactly zero gradient.

#include "common.cuh"

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
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           int row0, int rows, float* dst,
                                           int tid) {
  constexpr int VN = Vec<T>::kN, CPR = D / VN, LD = D + 1;
  for (int c = tid; c < kT * CPR; c += kBwdThreads) {
    const int r = c / CPR, col = (c % CPR) * VN;
    float x[VN];
    if (row0 + r < rows) {
      load_vec<T>(src + (size_t)(row0 + r) * D + col, x);
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

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
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
  const T* kb = k + ((size_t)b * H_kv + hk) * (size_t)Lk * D;
  const T* vb = v + ((size_t)b * H_kv + hk) * (size_t)Lk * D;
  const float* bb = bias == nullptr ? nullptr : bias + b * sb + h * sh;
  const float scale = (float)(1.0 / sqrt((double)D));

  stage_tile<T, D>(q + row_base * D, q0, Lq, qs, tid);
  stage_tile<T, D>(dout + row_base * D, q0, Lq, dos, tid);
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
    stage_tile<T, D>(kb, k0, Lk, ks, tid);
    stage_tile<T, D>(vb, k0, Lk, vs, tid);
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
      dq[(row_base + r) * D + tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int H_kv, int Lq, int Lk,
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

  stage_tile<T, D>(k + kv_base * D, k0, Lk, ks, tid);
  stage_tile<T, D>(v + kv_base * D, k0, Lk, vs, tid);
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
      stage_tile<T, D>(q + row_base * D, q0, Lq, qs, tid);
      stage_tile<T, D>(dout + row_base * D, q0, Lq, dos, tid);
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
      dk[(kv_base + c) * D + tx + 16 * j] = from_float<T>(acc_k[i][j]);
      dv[(kv_base + c) * D + tx + 16 * j] = from_float<T>(acc_v[i][j]);
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

template <typename T, int D>
static int launch_dq_d(const BwdArgs& a, void* dq, cudaStream_t st) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Lq + kT - 1) / kT, a.H, a.B), block(kBwdThreads);
  flash_bwd_dq_kernel<T, D><<<grid, block, smem, st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.bias,
      (const T*)a.dout, a.lse, a.delta, (T*)dq, a.H, a.H_kv, a.Lq, a.Lk,
      a.sb, a.sh, a.sq, a.causal, a.q_offset);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_dkv_d(const BwdArgs& a, void* dk, void* dv,
                        cudaStream_t st) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Lk + kT - 1) / kT, a.H_kv, a.B), block(kBwdThreads);
  flash_bwd_dkv_kernel<T, D><<<grid, block, smem, st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.bias,
      (const T*)a.dout, a.lse, a.delta, (T*)dk, (T*)dv, a.H, a.H_kv, a.Lq,
      a.Lk, a.sb, a.sh, a.sq, a.causal, a.q_offset);
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
  if (is_bf16)
    return D == 64 ? launch_dq_d<__nv_bfloat16, 64>(a, dq, st)
                   : launch_dq_d<__nv_bfloat16, 128>(a, dq, st);
  return D == 64 ? launch_dq_d<float, 64>(a, dq, st)
                 : launch_dq_d<float, 128>(a, dq, st);
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
  if (is_bf16)
    return D == 64 ? launch_dkv_d<__nv_bfloat16, 64>(a, dk, dv, st)
                   : launch_dkv_d<__nv_bfloat16, 128>(a, dk, dv, st);
  return D == 64 ? launch_dkv_d<float, 64>(a, dk, dv, st)
                 : launch_dkv_d<float, 128>(a, dk, dv, st);
}

// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel vyomai_tpu/ops/flash_attention.py `_fwd_kernel`
// (forward only: additive bias, causal with q_offset; no sliding window or
// segment ids yet).
//
// What bounds it on the H100: arithmetic. Prefill attention does 4*D FLOPs
// per (query, key) pair on operands that are reused across a whole tile, so
// it sits far above the card's bytes-per-FLOP line. This first version runs
// its dots as fp32 FMAs on the CUDA cores (the TPU kernel also casts q/k/v
// to fp32 before its dots), which caps it well below the tensor cores'
// rate; moving the two products onto mma/wgmma is the next step.
//
// Design: one CTA of 128 threads per (64-row q tile, head, batch). The q
// tile is staged once in shared memory as fp32; the loop walks 64-key K/V
// tiles of kv head h / group, staged with 16-byte vector loads. Each thread
// owns an 8x4 block of the 64x64 score tile and an 8 x D/16 block of the
// output, so the running max and denominator of its 8 rows live in
// registers and row reductions are 16-lane shuffles. Shared rows are padded
// (D+1, 64+1 floats) so the column walks hit distinct banks. The additive
// bias is read in place with broadcast strides (0 for a size-1 dim); the
// causal mask uses q_offset and whole future K/V tiles are skipped; ragged
// Lq/Lk edges are masked here instead of padding the inputs. Masked scores
// take NEG_INF, the running max is floored at -1e30, so a fully-masked row
// writes 0 and lse = -1e30 as the TPU kernel does.

#include "common.cuh"

namespace vyomai {

constexpr int kFlashThreads = 128;
constexpr int kBQ = 64, kBK = 64;

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int H,
                 int H_kv, int Lq, int Lk, long long sb, long long sh,
                 long long sq, int causal, int q_offset) {
  constexpr int NT = kFlashThreads, VN = Vec<T>::kN, CPR = D / VN;
  constexpr int LDQ = D + 1, LDP = kBK + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][LDQ]
  float* ks = qs + kBQ * LDQ;        // [kBK][LDQ]
  float* vs = ks + kBK * LDQ;        // [kBK][D]
  float* ps = vs + kBK * D;          // [kBQ][LDP]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int hk = h / (H / H_kv);
  const int q0 = qt * kBQ;
  const T* qb = q + ((size_t)b * H + h) * (size_t)Lq * D;
  const T* kb = k + ((size_t)b * H_kv + hk) * (size_t)Lk * D;
  const T* vb = v + ((size_t)b * H_kv + hk) * (size_t)Lk * D;
  const float* bb = bias == nullptr ? nullptr : bias + b * sb + h * sh;
  const float scale = (float)(1.0 / sqrt((double)D));

  for (int c = tid; c < kBQ * CPR; c += NT) {
    const int r = c / CPR, col = (c % CPR) * VN;
    float x[VN];
    if (q0 + r < Lq) {
      load_vec<T>(qb + (size_t)(q0 + r) * D + col, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) qs[r * LDQ + col + e] = x[e];
  }

  float m[8], l[8], o[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  }

  int nk = (Lk + kBK - 1) / kBK;
  if (causal) {   // skip K/V tiles entirely in every row's future
    const long long last_q = (long long)q_offset + q0 + kBQ - 1;
    const long long live = last_q < 0 ? 0 : last_q / kBK + 1;
    nk = live < nk ? (int)live : nk;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // previous tile's ks/vs/ps fully consumed
    for (int c = tid; c < kBK * CPR; c += NT) {
      const int r = c / CPR, col = (c % CPR) * VN;
      float kx[VN], vx[VN];
      if (k0 + r < Lk) {
        load_vec<T>(kb + (size_t)(k0 + r) * D + col, kx);
        load_vec<T>(vb + (size_t)(k0 + r) * D + col, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        ks[r * LDQ + col + e] = kx[e];
        vs[r * D + col + e] = vx[e];
      }
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[8], kk[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = qs[(ty * 8 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = q0 + ty * 8 + i;
      const long long qpos = (long long)q_offset + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x;
        if (c >= Lk) {
          x = -INFINITY;   // ragged key edge: not a key at all
        } else {
          x = s[i][j] * scale;
          if (causal && c > qpos) x += kNegInf;
          if (bb != nullptr && r < Lq) x += bb[r * sq + c];
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(fmaxf(m[i], mx), kMaxFloor);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 8 + i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= alpha;
    }
    __syncthreads();   // ps rows are written by 16 threads each

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[8], vv[DJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = ps[(ty * 8 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(p[i], vv[j], o[i][j]);
    }
  }

  T* ob = out + ((size_t)b * H + h) * (size_t)Lq * D;
  float* lb = lse + ((size_t)b * H + h) * (size_t)Lq;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty * 8 + i;
    if (r >= Lq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(size_t)r * D + tx + 16 * j] = from_float<T>(o[i][j] / l_safe);
    if (tx == 0) lb[r] = fmaxf(m[i], kMaxFloor) + logf(l_safe);
  }
}

template <typename T, int D>
static int launch_flash_d(const void* q, const void* k, const void* v,
                          const float* bias, void* out, float* lse, int B,
                          int H, int H_kv, int Lq, int Lk, long long sb,
                          long long sh, long long sq, int causal,
                          int q_offset, cudaStream_t st) {
  constexpr size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B), block(kFlashThreads);
  flash_fwd_kernel<T, D><<<grid, block, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)out, lse, H, H_kv,
      Lq, Lk, sb, sh, sq, causal, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_flash(const void* q, const void* k, const void* v,
                        const float* bias, void* out, float* lse, int B,
                        int H, int H_kv, int Lq, int Lk, int D, long long sb,
                        long long sh, long long sq, int causal, int q_offset,
                        cudaStream_t st) {
  if (D == 64)
    return launch_flash_d<T, 64>(q, k, v, bias, out, lse, B, H, H_kv, Lq,
                                 Lk, sb, sh, sq, causal, q_offset, st);
  return launch_flash_d<T, 128>(q, k, v, bias, out, lse, B, H, H_kv, Lq, Lk,
                                sb, sh, sq, causal, q_offset, st);
}

}  // namespace vyomai

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* bias, void* out, void* lse, int B,
                                int H, int H_kv, int Lq, int Lk, int D,
                                int bias_sb, int bias_sh, int bias_sq,
                                int causal, int q_offset, int is_bf16,
                                void* stream) {
  using namespace vyomai;
  if ((D != 64 && D != 128) || H % H_kv) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* bp = (const float*)bias;
  if (is_bf16)
    return launch_flash<__nv_bfloat16>(q, k, v, bp, out, (float*)lse, B, H,
                                       H_kv, Lq, Lk, D, bias_sb, bias_sh,
                                       bias_sq, causal, q_offset, st);
  return launch_flash<float>(q, k, v, bp, out, (float*)lse, B, H, H_kv, Lq,
                             Lk, D, bias_sb, bias_sh, bias_sq, causal,
                             q_offset, st);
}

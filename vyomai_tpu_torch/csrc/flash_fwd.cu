// Flash-attention forward for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel vyomai_tpu/ops/flash_attention.py `_fwd_kernel`
// (forward only: additive bias, causal with q_offset; no sliding window or
// segment ids yet).
//
// What bounds it on the H100: arithmetic. Prefill attention does 4*D FLOPs
// per (query, key) pair on operands reused across a whole tile, far above
// the card's bytes-per-FLOP line, so the tensor cores' rate is the bound.
//
// The launcher picks the kernel by dtype. This is a dispatch, not a
// fallback: each path raises (a non-zero cudaError_t) on failure, and a bf16
// tensor never reaches the CUDA-core kernel.
//
// - bf16: `flash_fwd_kernel_tc`, the tensor-core core of attn_fwd_tc.cuh
//   (mma.sync m16n8k16 with fp32 accumulation, ldmatrix, a cp.async
//   double-buffered K/V ring, online softmax in registers, P in bf16). One
//   CTA of 4 warps per (64-row q tile, head, batch), 16 q rows per warp.
// - fp32: `flash_fwd_kernel`, fp32 FMAs on the CUDA cores. Tensor cores
//   would round fp32 inputs to TF32 (about 3 digits), and the fp32 card-vs-
//   CPU checks hold the port to 1e-4 of each tensor's max. One CTA of 128
//   threads per (64-row q tile, head, batch); the q tile is staged once in
//   shared memory, each thread owns an 8x4 block of the 64x64 score tile
//   and an 8 x D/16 block of the output, rows padded (D+1, 64+1 floats) so
//   the column walks hit distinct banks.
//
// Both: GQA reads kv head h / group; the additive fp32 bias is addressed
// through its broadcast strides (0 for a size-1 dim; 64-bit): the bf16
// kernel copies it in [64][64] tiles (one row when it broadcasts over the q
// rows) through its K/V ring, which needs 16-byte aligned rows (the wrapper
// pads a bias that has none), the fp32 kernel reads it in place. The causal
// mask uses q_offset and whole future K/V tiles are skipped; ragged Lq/Lk
// edges are masked here instead of padding the inputs. Masked scores take
// NEG_INF, the running max is floored at -1e30, so a fully-masked row
// writes 0 and lse = -1e30 as the TPU kernel does.

#include "attn_fwd_tc.cuh"

namespace vyomai {

constexpr int kFlashThreads = 128;
constexpr int kBQ = 64, kBK = 64;

// K-tiles a q tile reads: causal skips the tiles in every row's future.
__device__ __forceinline__ int flash_live_tiles(int Lk, int q0, int causal,
                                                int q_offset) {
  int nk = (Lk + kBK - 1) / kBK;
  if (causal) {
    const long long last_q = (long long)q_offset + q0 + kBQ - 1;
    const long long live = last_q < 0 ? 0 : last_q / kBK + 1;
    nk = live < nk ? (int)live : nk;
  }
  return nk;
}

// ------------------------------------------------------ bf16, tensor cores

template <int D>
__global__ void __launch_bounds__(tc::kThreads, tc::min_ctas<D>())
flash_fwd_kernel_tc(const tc::bf16* __restrict__ q,
                    const tc::bf16* __restrict__ k,
                    const tc::bf16* __restrict__ v,
                    const float* __restrict__ bias, tc::bf16* __restrict__ out,
                    float* __restrict__ lse, int H, int H_kv, int Lq, int Lk,
                    long long sb, long long sh, long long sq, int causal,
                    int q_offset) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  tc::bf16* smem = reinterpret_cast<tc::bf16*>(tc_smem);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / H_kv);
  const int q0 = qt * kBQ;
  const size_t qrow = ((size_t)b * H + h) * (size_t)Lq;
  const size_t krow = ((size_t)b * H_kv + hk) * (size_t)Lk;
  // the launcher checked 16-byte aligned bias rows (strides % 4 == 0)
  const tc::BiasTile bt{
      bias == nullptr ? nullptr : bias + b * sb + h * sh + q0 * sq, sq,
      sq == 0 ? 1 : kBQ, sq == 0 ? 1 : Lq - q0, Lk};

  tc::FwdAcc<D> acc;
  tc::fwd_core<D, true>(q + qrow * D, D, k + krow * D, v + krow * D, D, Lq,
                        Lk, q0, flash_live_tiles(Lk, q0, causal, q_offset),
                        (float)(1.0 / sqrt((double)D)), causal, q_offset, bt,
                        smem, acc);

  const int wrow = q0 + (threadIdx.x >> 5) * 16, lane = threadIdx.x & 31;
  if (wrow >= Lq) return;   // a tail warp: no live row
  const int r0 = wrow + (lane >> 2);
  float inv_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = acc.l[i] == 0.f ? 1.f : acc.l[i];
    inv_l[i] = 1.f / l_safe;
    const int r = r0 + 8 * i;
    if ((lane & 3) == 0 && r < Lq)
      lse[qrow + r] = fmaxf(acc.m[i], kMaxFloor) + logf(l_safe);
  }
  tc::store_rows<D>(acc.o, inv_l, smem, out + qrow * D, D, q0, Lq);
}

// ------------------------------------------------------- fp32, CUDA cores

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int H,
                 int H_kv, int Lq, int Lk, long long sb, long long sh,
                 long long sq, int causal, int q_offset) {
  constexpr int NT = kFlashThreads, VN = Vec<float>::kN, CPR = D / VN;
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
  const float* qb = q + ((size_t)b * H + h) * (size_t)Lq * D;
  const float* kb = k + ((size_t)b * H_kv + hk) * (size_t)Lk * D;
  const float* vb = v + ((size_t)b * H_kv + hk) * (size_t)Lk * D;
  const float* bb = bias == nullptr ? nullptr : bias + b * sb + h * sh;
  const float scale = (float)(1.0 / sqrt((double)D));

  for (int c = tid; c < kBQ * CPR; c += NT) {
    const int r = c / CPR, col = (c % CPR) * VN;
    float x[VN];
    if (q0 + r < Lq) {
      load_vec<float>(qb + (size_t)(q0 + r) * D + col, x);
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

  const int nk = flash_live_tiles(Lk, q0, causal, q_offset);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // previous tile's ks/vs/ps fully consumed
    for (int c = tid; c < kBK * CPR; c += NT) {
      const int r = c / CPR, col = (c % CPR) * VN;
      float kx[VN], vx[VN];
      if (k0 + r < Lk) {
        load_vec<float>(kb + (size_t)(k0 + r) * D + col, kx);
        load_vec<float>(vb + (size_t)(k0 + r) * D + col, vx);
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

  float* ob = out + ((size_t)b * H + h) * (size_t)Lq * D;
  float* lb = lse + ((size_t)b * H + h) * (size_t)Lq;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty * 8 + i;
    if (r >= Lq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(size_t)r * D + tx + 16 * j] = o[i][j] / l_safe;
    if (tx == 0) lb[r] = fmaxf(m[i], kMaxFloor) + logf(l_safe);
  }
}

// -------------------------------------------------------------- launchers

struct FlashArgs {
  const void *q, *k, *v;
  const float* bias;
  void* out;
  float* lse;
  int B, H, H_kv, Lq, Lk;
  long long sb, sh, sq;
  int causal, q_offset;
};

template <class T, class Kernel>
static int launch_flash(Kernel kernel, size_t smem, const FlashArgs& a,
                        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.H, a.B);
  kernel<<<grid, kFlashThreads, smem, st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.bias, (T*)a.out, a.lse,
      a.H, a.H_kv, a.Lq, a.Lk, a.sb, a.sh, a.sq, a.causal, a.q_offset);
  return (int)cudaGetLastError();
}

}  // namespace vyomai

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* bias, void* out, void* lse, int B,
                                int H, int H_kv, int Lq, int Lk, int D,
                                long long bias_sb, long long bias_sh,
                                long long bias_sq, int causal, int q_offset,
                                int is_bf16, void* stream) {
  using namespace vyomai;
  if ((D != 64 && D != 128) || H % H_kv) return (int)cudaErrorInvalidValue;
  static_assert(tc::kThreads == kFlashThreads, "one block size");
  const FlashArgs a{q, k, v, (const float*)bias, out, (float*)lse, B, H,
                    H_kv, Lq, Lk, bias_sb, bias_sh, bias_sq, causal,
                    q_offset};
  cudaStream_t st = (cudaStream_t)stream;
  using tc::bf16;
  if (is_bf16) {   // the bias ring reads 16-byte aligned rows
    if (bias != nullptr &&
        (((uintptr_t)bias & 15) || (bias_sb | bias_sh | bias_sq) % 4))
      return (int)cudaErrorInvalidValue;
    const size_t ring =
        bias == nullptr ? 0 : tc::bias_smem_bytes(bias_sq == 0 ? 1 : kBQ);
    return D == 64 ? launch_flash<bf16>(flash_fwd_kernel_tc<64>,
                                        tc::smem_bytes<64>() + ring, a, st)
                   : launch_flash<bf16>(flash_fwd_kernel_tc<128>,
                                        tc::smem_bytes<128>() + ring, a, st);
  }
  return D == 64 ? launch_flash<float>(flash_fwd_kernel<64>,
                                       flash_smem_bytes<64>(), a, st)
                 : launch_flash<float>(flash_fwd_kernel<128>,
                                       flash_smem_bytes<128>(), a, st);
}

// Paged-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel vyomai_tpu/ops/paged_decode_pallas.py `_kernel`:
// bf16 / fp32 pools (PR 1) and, as the `Quant` template variants, its int8
// pool (one fp32 scale per written row) and int4 pool (two values per byte,
// per-head-local split halves, one fp32 scale per (row, kv head)). Window
// and sinks are not ported yet.
//
// What bounds it on the H100: device-memory bandwidth. Per decode step each
// live context token's K and V rows (2 * D elements per kv head) are read
// once and used for a handful of FMAs per byte, far below the ~295 FLOP/byte
// the card needs before its arithmetic would limit. The int8 and int4 pools
// halve and quarter those bytes.
//
// Design: one CTA per (sequence, kv head), 128 threads. The CTA loads its
// `group` query rows once, reads block_tables[b, j] itself (no scalar
// prefetch exists here), and streams the live context in tiles of 32 tokens:
// each K/V row is the contiguous column range of head g in the pool row,
// fetched with 16-byte vector loads by neighbouring threads and staged
// in shared memory as fp32 (rows padded to D+1 floats so the per-token dot
// products hit distinct banks). Quantized rows are staged as their integer
// values; int4 bytes are unpacked in registers straight into natural
// feature order (byte j of a head holds feature j low and feature j + D/2
// high), so the TPU kernel's "pi order" and block-diagonal q, which existed
// for Mosaic's lanes, are not carried over. The scales fold through the
// score matrix as on the TPU: a key row's scale multiplies its score, and a
// value row's scale multiplies its probability AFTER the running sum `l` has
// taken the unscaled one (the TPU kernel's l.163 before l.166-167). Scores,
// the online softmax (running max floored at -1e30) and the value sum are
// fp32; only the live blocks (min(seq_len, MAXB*BS) tokens) are read.
// Not yet done (later work): double-buffered cp.async/TMA loads and a
// split-KV pass for batches whose B*H_kv CTAs leave SMs idle.

#include "common.cuh"

namespace vyomai {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeTile = 32;   // tokens per shared-memory tile (= warp)
constexpr int kMaxGroup = 8;      // query heads per kv head

enum PoolQuant { kFloatPool = 0, kInt8Pool = 1, kInt4Pool = 2 };

// One 16-byte chunk `c` of head g's part of a pool row, into the fp32 smem
// row `dst` in natural feature order. Float pools: Vec<T>::kN features;
// int8: 16; int4: 16 bytes = features c*16.. (low nibbles) and
// D/2 + c*16.. (high nibbles).
template <typename T, int D, int Quant>
__device__ __forceinline__ void stage_chunk(const char* row, int c,
                                            float* dst) {
  if (Quant == kFloatPool) {
    constexpr int VN = Vec<T>::kN;
    float v[VN];
    load_vec<T>(reinterpret_cast<const T*>(row) + c * VN, v);
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[c * VN + e] = v[e];
  } else {
    const uint4 raw = *(reinterpret_cast<const uint4*>(row) + c);
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int x = (int)bytes[e];
      if (Quant == kInt8Pool) {
        dst[c * 16 + e] = (float)x;
      } else {
        dst[c * 16 + e] = (float)(((x & 15) ^ 8) - 8);
        dst[D / 2 + c * 16 + e] = (float)(x >> 4);
      }
    }
  }
}

// Zero what stage_chunk would have written (tokens past the live length).
template <typename T, int D, int Quant>
__device__ __forceinline__ void zero_chunk(int c, float* dst) {
  if (Quant == kFloatPool) {
    constexpr int VN = Vec<T>::kN;
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[c * VN + e] = 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      dst[c * 16 + e] = 0.f;
      if (Quant == kInt4Pool) dst[D / 2 + c * 16 + e] = 0.f;
    }
  }
}

template <typename T, int D, int Quant>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const char* __restrict__ pool,
                    const float* __restrict__ scales,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int H, int H_kv, int BS, int MAXB, int W) {
  constexpr int TOK = kDecodeTile, NT = kDecodeThreads;
  // 16-byte chunks per head row, bytes per stored element, stored elements
  // per head row
  constexpr int CPR = Quant == kFloatPool  ? D / Vec<T>::kN
                      : Quant == kInt8Pool ? D / 16
                                           : D / 32;
  constexpr int EB = Quant == kFloatPool ? (int)sizeof(T) : 1;
  constexpr int HW = Quant == kInt4Pool ? D / 2 : D;
  constexpr int LD = D + 1;
  constexpr int PER = kMaxGroup * D / NT;   // accumulators per thread
  __shared__ float qs[kMaxGroup * D];
  __shared__ float ks[TOK * LD];
  __shared__ float vs[TOK * LD];
  __shared__ float ps[kMaxGroup][TOK];
  __shared__ float ksc[TOK], vsc[TOK];     // quantized pools' row scales
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int G = H / H_kv;
  const int warp = tid / 32, lane = tid % 32;
  // q is scaled in fp32 and rounded to its own dtype before the dots
  const float scale = (float)(1.0 / sqrt((double)D));
  const T* qrow = q + ((size_t)b * H + (size_t)g * G) * D;
  for (int i = tid; i < G * D; i += NT)
    qs[i] = to_float<T>(from_float<T>(to_float<T>(qrow[i]) * scale));

  const int maxlen = MAXB * BS;
  int n = seq_lens[b];
  n = n < 0 ? 0 : (n > maxlen ? maxlen : n);
  const int* table = block_tables + (size_t)b * MAXB;

  float acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) acc[k] = 0.f;

  for (int t0 = 0; t0 < n; t0 += TOK) {
    __syncthreads();   // previous tile fully consumed
    for (int c = tid; c < TOK * CPR; c += NT) {
      const int t = c / CPR, ch = c % CPR, tok = t0 + t;
      if (tok < n) {
        int blk = table[tok / BS];
        blk = blk < 0 ? 0 : blk;   // -1 entries read block 0 (masked)
        const size_t row =
            ((size_t)blk * 2 * BS + (size_t)(tok % BS)) * W + (size_t)g * HW;
        stage_chunk<T, D, Quant>(pool + row * EB, ch, ks + t * LD);
        stage_chunk<T, D, Quant>(pool + (row + (size_t)BS * W) * EB, ch,
                                 vs + t * LD);
      } else {
        zero_chunk<T, D, Quant>(ch, ks + t * LD);
        zero_chunk<T, D, Quant>(ch, vs + t * LD);
      }
    }
    if (Quant != kFloatPool) {
      for (int t = tid; t < TOK; t += NT) {
        const int tok = t0 + t;
        float a = 0.f, c = 0.f;
        if (tok < n) {
          int blk = table[tok / BS];
          blk = blk < 0 ? 0 : blk;
          if (Quant == kInt8Pool) {   // scales [NB, 2, BS]
            const size_t i = (size_t)blk * 2 * BS + tok % BS;
            a = scales[i];
            c = scales[i + BS];
          } else {                    // scales [NB, 2, H_kv, BS]
            const size_t i = ((size_t)blk * 2 * H_kv + g) * BS + tok % BS;
            a = scales[i];
            c = scales[i + (size_t)H_kv * BS];
          }
        }
        ksc[t] = a;
        vsc[t] = c;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * TOK; i += NT) {
      const int gg = i / TOK, t = i % TOK;
      const float* qr = qs + gg * D;
      const float* kr = ks + t * LD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      if (Quant != kFloatPool) s *= ksc[t];
      ps[gg][t] = (t0 + t < n) ? s : -INFINITY;
    }
    __syncthreads();
    for (int gg = warp; gg < G; gg += NT / 32) {   // one warp per head
      const float s = ps[gg][lane];
      const float m_prev = t0 == 0 ? kNegInf : m_s[gg];
      const float l_prev = t0 == 0 ? 0.f : l_s[gg];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(fmaxf(m_prev, mx), kMaxFloor);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // l takes the unscaled p; the value sum takes p times v's row scale
      ps[gg][lane] = Quant == kFloatPool ? p : p * vsc[lane];
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[gg] = alpha;
        m_s[gg] = m_new;
        l_s[gg] = alpha * l_prev + sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = tid + k * NT;
      if (idx < G * D) {
        const int gg = idx / D, d = idx % D;
        float a = acc[k] * alpha_s[gg];
#pragma unroll 8
        for (int t = 0; t < TOK; ++t) a = fmaf(ps[gg][t], vs[t * LD + d], a);
        acc[k] = a;
      }
    }
  }
  __syncthreads();
  T* orow = out + ((size_t)b * H + (size_t)g * G) * D;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * NT;
    if (idx < G * D) {
      float l = n > 0 ? l_s[idx / D] : 0.f;
      l = l == 0.f ? 1.f : l;   // dead lane: 0 / 1
      orow[idx] = from_float<T>(acc[k] / l);
    }
  }
}

template <typename T, int Quant>
static void launch_paged(const void* q, const void* pool, const float* sc,
                         const int* bt, const int* sl, void* out, int B,
                         int H, int H_kv, int D, int BS, int MAXB, int W,
                         cudaStream_t st) {
  const dim3 grid(B, H_kv), block(kDecodeThreads);
  if (D == 64)
    paged_decode_kernel<T, 64, Quant><<<grid, block, 0, st>>>(
        (const T*)q, (const char*)pool, sc, bt, sl, (T*)out, H, H_kv, BS,
        MAXB, W);
  else
    paged_decode_kernel<T, 128, Quant><<<grid, block, 0, st>>>(
        (const T*)q, (const char*)pool, sc, bt, sl, (T*)out, H, H_kv, BS,
        MAXB, W);
}

template <typename T>
static void launch_quant(int quant, const void* q, const void* pool,
                         const float* sc, const int* bt, const int* sl,
                         void* out, int B, int H, int H_kv, int D, int BS,
                         int MAXB, int W, cudaStream_t st) {
  if (quant == kInt8Pool)
    launch_paged<T, kInt8Pool>(q, pool, sc, bt, sl, out, B, H, H_kv, D, BS,
                               MAXB, W, st);
  else if (quant == kInt4Pool)
    launch_paged<T, kInt4Pool>(q, pool, sc, bt, sl, out, B, H, H_kv, D, BS,
                               MAXB, W, st);
  else
    launch_paged<T, kFloatPool>(q, pool, sc, bt, sl, out, B, H, H_kv, D, BS,
                                MAXB, W, st);
}

}  // namespace vyomai

// W: the pool row's stored width in elements (H_kv*D; H_kv*D/2 bytes for
// int4). quant: 0 float pool of q's dtype, 1 int8, 2 int4 (scales needed).
extern "C" int paged_decode_launch(const void* q, const void* pool,
                                   const void* scales,
                                   const void* block_tables,
                                   const void* seq_lens, void* out, int B,
                                   int H, int H_kv, int D, int BS, int MAXB,
                                   int W, int quant, int is_bf16,
                                   void* stream) {
  using namespace vyomai;
  if ((D != 64 && D != 128) || H % H_kv || H / H_kv > kMaxGroup ||
      quant < 0 || quant > 2 || (quant && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    launch_quant<__nv_bfloat16>(quant, q, pool, (const float*)scales,
                                (const int*)block_tables,
                                (const int*)seq_lens, out, B, H, H_kv, D, BS,
                                MAXB, W, st);
  else
    launch_quant<float>(quant, q, pool, (const float*)scales,
                        (const int*)block_tables, (const int*)seq_lens, out,
                        B, H, H_kv, D, BS, MAXB, W, st);
  return (int)cudaGetLastError();
}

extern "C" const char* vyomai_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Paged-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel vyomai_tpu/ops/paged_decode_pallas.py `_kernel`
// (bf16 / fp32 pool, no window, sinks or quantization yet).
//
// What bounds it on the H100: device-memory bandwidth. Per decode step each
// live context token's K and V rows (2 * D elements per kv head) are read
// once and used for a handful of FMAs per byte, far below the ~295 FLOP/byte
// the card needs before its arithmetic would limit.
//
// Design: one CTA per (sequence, kv head), 128 threads. The CTA loads its
// `group` query rows once, reads block_tables[b, j] itself (no scalar
// prefetch exists here), and streams the live context in tiles of 32 tokens:
// each K/V row is the contiguous column range g*D:(g+1)*D of the H_kv*D pool
// row, fetched with 16-byte vector loads by neighbouring threads and staged
// in shared memory as fp32 (rows padded to D+1 floats so the per-token dot
// products hit distinct banks). Scores, the online softmax (running max
// floored at -1e30) and the value sum are fp32; only the live blocks
// (min(seq_len, MAXB*BS) tokens) are read. The TPU kernel's block-diagonal q
// expansion existed to feed its matrix unit and is not carried over: a
// group of 1-8 query rows is a few dot products per token here.
// Not yet done (later work): double-buffered cp.async/TMA loads and a
// split-KV pass for batches whose B*H_kv CTAs leave SMs idle.

#include "common.cuh"

namespace vyomai {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeTile = 32;   // tokens per shared-memory tile (= warp)
constexpr int kMaxGroup = 8;      // query heads per kv head

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int H, int H_kv, int BS, int MAXB, int W) {
  constexpr int TOK = kDecodeTile, NT = kDecodeThreads;
  constexpr int VN = Vec<T>::kN, CPR = D / VN, LD = D + 1;
  constexpr int PER = kMaxGroup * D / NT;   // accumulators per thread
  __shared__ float qs[kMaxGroup * D];
  __shared__ float ks[TOK * LD];
  __shared__ float vs[TOK * LD];
  __shared__ float ps[kMaxGroup][TOK];
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
      const int t = c / CPR, col = (c % CPR) * VN, tok = t0 + t;
      float kx[VN], vx[VN];
      if (tok < n) {
        int blk = table[tok / BS];
        blk = blk < 0 ? 0 : blk;   // -1 entries read block 0 (masked)
        const size_t row =
            ((size_t)blk * 2 * BS + (size_t)(tok % BS)) * W + (size_t)g * D +
            col;
        load_vec<T>(pool + row, kx);
        load_vec<T>(pool + row + (size_t)BS * W, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        ks[t * LD + col + e] = kx[e];
        vs[t * LD + col + e] = vx[e];
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
      ps[gg][lane] = p;
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

template <typename T>
static void launch_paged(const void* q, const void* pool, const int* bt,
                         const int* sl, void* out, int B, int H, int H_kv,
                         int D, int BS, int MAXB, int W, cudaStream_t st) {
  const dim3 grid(B, H_kv), block(kDecodeThreads);
  if (D == 64)
    paged_decode_kernel<T, 64><<<grid, block, 0, st>>>(
        (const T*)q, (const T*)pool, bt, sl, (T*)out, H, H_kv, BS, MAXB, W);
  else
    paged_decode_kernel<T, 128><<<grid, block, 0, st>>>(
        (const T*)q, (const T*)pool, bt, sl, (T*)out, H, H_kv, BS, MAXB, W);
}

}  // namespace vyomai

extern "C" int paged_decode_launch(const void* q, const void* pool,
                                   const void* block_tables,
                                   const void* seq_lens, void* out, int B,
                                   int H, int H_kv, int D, int BS, int MAXB,
                                   int W, int is_bf16, void* stream) {
  using namespace vyomai;
  if ((D != 64 && D != 128) || H % H_kv || H / H_kv > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    launch_paged<__nv_bfloat16>(q, pool, (const int*)block_tables,
                                (const int*)seq_lens, out, B, H, H_kv, D, BS,
                                MAXB, W, st);
  else
    launch_paged<float>(q, pool, (const int*)block_tables,
                        (const int*)seq_lens, out, B, H, H_kv, D, BS, MAXB,
                        W, st);
  return (int)cudaGetLastError();
}

extern "C" const char* vyomai_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

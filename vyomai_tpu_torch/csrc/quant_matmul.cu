// Weight-only int8 and int4 matmuls for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   K8  vyomai_tpu/ops/quant_matmul.py `_kernel_kn` / `_kernel_nk`
//       y = (x @ w_q) * scale[n], int8 weights [K, N] or [N, K];
//   K9  vyomai_tpu/ops/quant_matmul.py `_kernel_int4` (split) /
//       `_kernel_int4_fold` (fold), packed int4 [K/2, N] with group scales;
//   K10 benchmarks/int4_dense_bench.py `_stream_kernel` / `_noscale_kernel`,
//       two attribution modes of K9 (one compile-time `Mode` of the int4
//       kernel here).
//
// What bounds them on the H100. At decode (M = 16 tokens) each weight byte
// is used for 2 * 16 FLOPs: the weight stream over 3.35 TB/s is the bound,
// and int8 / int4 storage is what halves / quarters it against bf16. At
// prefill (M up to 2,048) the same call is bound by arithmetic: 2*M*K*N
// FLOPs, which these kernels do as fp32 FMAs on CUDA cores (67 TFLOP/s
// peak) rather than on tensor cores (989 TFLOP/s bf16).
//
// Design, shaped by decode's 16 rows. A CTA of 8 warps owns 16 rows of x
// (blockIdx.y) and 32 output columns (blockIdx.x), one column per lane,
// and sweeps K in slabs of 128: the slab's x (16 x 128, as fp32) is staged
// in shared memory, and warp w takes rows [16w, 16w + 16) of the slab.
// Each lane reads its column's 16 weights of that chunk straight from
// device memory into registers (one 16-byte load where k is contiguous,
// byte loads otherwise; 8 packed bytes for int4), the next slab's chunk
// loaded while the current one is consumed, widens them, and does 16 x 16
// fp32 FMAs against x rows read from shared memory as broadcasts (every
// lane of a warp reads the same x). The eight warps' partial sums are added
// in a fixed order through shared memory (deterministic), and the epilogue
// is the Pallas one: K8 multiplies the fp32 sum by scale[n] and rounds once
// to x's dtype; K9 "fold" rounds each scaled weight (nibble * scale[g, n],
// an fp32 product) to x's dtype before the sum; "split" multiplies each
// 16-row slice's fp32 partial sum by its group's scale (group sizes are
// multiples of 16, so a slice never straddles two groups); K10 "stream"
// dots the packed bytes themselves with both the even and the odd row of
// x, "noscale" the unpacked nibbles, each times one scale row
// (`scale_row`) at the end. The int8 weight is addressed through (n, k)
// strides, so the kn layout of the JAX package and the nk layout of the
// tied head and of nn.Linear-shaped modules take the same kernel. Ragged
// M, N and K are masked; M needs no padding.
//
// Cost of the one tiling at prefill: CTAs of 16 rows read each weight
// column once per 16 tokens, so at M = 2,048 (1024 -> 3072) every weight
// byte is read 128 times, mostly from L2, and the 2*M*K*N = 12.9 GFLOP run
// as CUDA-core FMAs: ~0.3 ms at half the fp32 peak, against 13 us at the
// bf16 tensor-core rate. Narrow decode shapes (N = 1,024) give 32 CTAs, a
// quarter of the SMs. Later work: mma/wgmma on bf16, split-K across CTAs
// for narrow N, cp.async staging.

#include "common.cuh"

namespace vyomai {

constexpr int kQmThreads = 256, kQmWarps = 8;
constexpr int kMT = 16;                  // rows of x per CTA
constexpr int kKC = 16;                  // k per warp chunk
constexpr int kSlab = kQmWarps * kKC;    // k per slab (128)
constexpr int kCols = 32;                // columns per CTA (one per lane)

enum Int4Mode { kFold = 0, kSplit = 1, kStream = 2, kNoscale = 3 };

// x[m0:m0+16, k0:k0+128] -> xs[k][m] (fp32). Consecutive threads take
// consecutive m, so the shared stores are conflict-free.
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, float* xs,
                                        int M, int K, int m0, int k0,
                                        int tid) {
#pragma unroll
  for (int i = 0; i < kSlab * kMT / kQmThreads; ++i) {
    const int e = tid + i * kQmThreads;
    const int m = e % kMT, k = e / kMT;
    const int gm = m0 + m, gk = k0 + k;
    xs[k * kMT + m] =
        (gm < M && gk < K) ? to_float<T>(x[(size_t)gm * K + gk]) : 0.f;
  }
}

// acc[m] += x[m, kk] * w for the 16 rows (four broadcast float4 reads)
__device__ __forceinline__ void fma_rows(const float* xs, int kk, float w,
                                         float (&acc)[kMT]) {
  const float4* xr = reinterpret_cast<const float4*>(xs + kk * kMT);
#pragma unroll
  for (int q = 0; q < kMT / 4; ++q) {
    const float4 v = xr[q];
    acc[4 * q + 0] = fmaf(v.x, w, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
  }
}

// Add the eight warps' acc in warp order into red[m][lane], then write
// out[m0 + m, n0 + n] = round(red * scale) (scale == nullptr: 1).
template <typename T>
__device__ __forceinline__ void reduce_store(float (&acc)[kMT], float* red,
                                             const float* scale_row,
                                             T* __restrict__ out, int M,
                                             int N, int m0, int n0, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  for (int w = 0; w < kQmWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        red[m * kCols + lane] =
            w == 0 ? acc[m] : red[m * kCols + lane] + acc[m];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kMT * kCols / kQmThreads; ++i) {
    const int e = tid + i * kQmThreads;
    const int m = e / kCols, n = e % kCols;
    const int gm = m0 + m, gn = n0 + n;
    if (gm < M && gn < N) {
      const float s = scale_row == nullptr ? 1.f : scale_row[gn];
      out[(size_t)gm * N + gn] = from_float<T>(red[m * kCols + n] * s);
    }
  }
}

// One lane's 16 int8 weights of column n at rows [k, k + 16).
__device__ __forceinline__ void load_int8_chunk(
    const int8_t* __restrict__ w, int n, int k, int N, int K, long long sn,
    long long sk, bool vec, int8_t (&dst)[kKC]) {
  if (vec) {   // k contiguous, 16-byte aligned, K % 16 == 0
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (n < N && k < K)
      raw = *reinterpret_cast<const uint4*>(w + n * sn + k);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < kKC; ++j) dst[j] = b[j];
  } else {
#pragma unroll
    for (int j = 0; j < kKC; ++j)
      dst[j] = (n < N && k + j < K) ? w[n * sn + (k + j) * sk] : (int8_t)0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kQmThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int M, int N, int K, long long sn, long long sk, int vec) {
  __shared__ __align__(16) float xs[kSlab * kMT];
  __shared__ float red[kMT * kCols];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.x * kCols + lane, m0 = blockIdx.y * kMT;
  float acc[kMT] = {};
  int8_t cur[kKC], nxt[kKC] = {};
  load_int8_chunk(w, n, warp * kKC, N, K, sn, sk, vec, cur);
  for (int k0 = 0; k0 < K; k0 += kSlab) {
    __syncthreads();   // the previous slab is consumed
    stage_x<T>(x, xs, M, K, m0, k0, tid);
    __syncthreads();
    if (k0 + kSlab < K)   // next slab's weights, in flight meanwhile
      load_int8_chunk(w, n, k0 + kSlab + warp * kKC, N, K, sn, sk, vec, nxt);
#pragma unroll
    for (int j = 0; j < kKC; ++j)
      fma_rows(xs, warp * kKC + j, (float)cur[j], acc);
#pragma unroll
    for (int j = 0; j < kKC; ++j) cur[j] = nxt[j];
  }
  reduce_store<T>(acc, red, scale, out, M, N, m0, blockIdx.x * kCols, tid);
}

// One lane's 8 packed bytes of column n at packed rows [k/2, k/2 + 8).
__device__ __forceinline__ void load_int4_chunk(
    const int8_t* __restrict__ wp, int n, int k, int N, int K,
    int8_t (&dst)[kKC / 2]) {
#pragma unroll
  for (int j = 0; j < kKC / 2; ++j)
    dst[j] = (n < N && k + 2 * j < K) ? wp[(size_t)(k / 2 + j) * N + n]
                                      : (int8_t)0;
}

template <typename T, int Mode>
__global__ void __launch_bounds__(kQmThreads)
int4_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wp,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int M, int N, int K, int gs, int scale_row) {
  __shared__ __align__(16) float xs[kSlab * kMT];
  __shared__ float red[kMT * kCols];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.x * kCols + lane, m0 = blockIdx.y * kMT;
  float acc[kMT] = {};
  int8_t cur[kKC / 2], nxt[kKC / 2] = {};
  load_int4_chunk(wp, n, warp * kKC, N, K, cur);
  for (int k0 = 0; k0 < K; k0 += kSlab) {
    __syncthreads();
    stage_x<T>(x, xs, M, K, m0, k0, tid);
    __syncthreads();
    const int kc = k0 + warp * kKC;   // this warp's first row
    if (k0 + kSlab < K) load_int4_chunk(wp, n, kc + kSlab, N, K, nxt);
    // the chunk's group scale (a chunk lies in one group: gs % 16 == 0)
    float s = 0.f;
    if ((Mode == kFold || Mode == kSplit) && kc < K && n < N)
      s = scale[(size_t)(kc / gs) * N + n];
    float part[kMT] = {};
#pragma unroll
    for (int j = 0; j < kKC / 2; ++j) {
      const int b = (int)cur[j];
      float lo = (float)(((b & 15) ^ 8) - 8), hi = (float)(b >> 4);
      if (Mode == kFold) {   // scaled weight rounded to x's dtype
        lo = to_float<T>(from_float<T>(lo * s));
        hi = to_float<T>(from_float<T>(hi * s));
      } else if (Mode == kStream) {
        lo = hi = (float)b;
      }
      if (Mode == kSplit) {
        fma_rows(xs, warp * kKC + 2 * j, lo, part);
        fma_rows(xs, warp * kKC + 2 * j + 1, hi, part);
      } else {
        fma_rows(xs, warp * kKC + 2 * j, lo, acc);
        fma_rows(xs, warp * kKC + 2 * j + 1, hi, acc);
      }
    }
    if (Mode == kSplit) {
#pragma unroll
      for (int m = 0; m < kMT; ++m) acc[m] = fmaf(part[m], s, acc[m]);
    }
#pragma unroll
    for (int j = 0; j < kKC / 2; ++j) cur[j] = nxt[j];
  }
  const float* srow = (Mode == kStream || Mode == kNoscale)
                          ? scale + (size_t)scale_row * N : nullptr;
  reduce_store<T>(acc, red, srow, out, M, N, m0, blockIdx.x * kCols, tid);
}

template <typename T>
static void launch_int4(const void* x, const void* wp, const float* scale,
                        void* out, int M, int N, int K, int gs, int mode,
                        int scale_row, cudaStream_t st) {
  const dim3 grid((N + kCols - 1) / kCols, (M + kMT - 1) / kMT);
  const dim3 block(kQmThreads);
  const T* xt = (const T*)x;
  const int8_t* w = (const int8_t*)wp;
  T* o = (T*)out;
  switch (mode) {
    case kFold:
      int4_matmul_kernel<T, kFold><<<grid, block, 0, st>>>(
          xt, w, scale, o, M, N, K, gs, scale_row);
      break;
    case kSplit:
      int4_matmul_kernel<T, kSplit><<<grid, block, 0, st>>>(
          xt, w, scale, o, M, N, K, gs, scale_row);
      break;
    case kStream:
      int4_matmul_kernel<T, kStream><<<grid, block, 0, st>>>(
          xt, w, scale, o, M, N, K, gs, scale_row);
      break;
    default:
      int4_matmul_kernel<T, kNoscale><<<grid, block, 0, st>>>(
          xt, w, scale, o, M, N, K, gs, scale_row);
  }
}

}  // namespace vyomai

extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* out, int M, int N,
                                  int K, long long sn, long long sk,
                                  int is_bf16, void* stream) {
  using namespace vyomai;
  if (M <= 0 || N <= 0 || K <= 0 || (M + kMT - 1) / kMT > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = sk == 1 && K % kKC == 0 && sn % 16 == 0 &&
                  (uintptr_t)w % 16 == 0;
  const dim3 grid((N + kCols - 1) / kCols, (M + kMT - 1) / kMT);
  const dim3 block(kQmThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    int8_matmul_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale,
        (__nv_bfloat16*)out, M, N, K, sn, sk, vec);
  else
    int8_matmul_kernel<float><<<grid, block, 0, st>>>(
        (const float*)x, (const int8_t*)w, (const float*)scale, (float*)out,
        M, N, K, sn, sk, vec);
  return (int)cudaGetLastError();
}

extern "C" int int4_matmul_launch(const void* x, const void* wp,
                                  const void* scale, void* out, int M, int N,
                                  int K, int gs, int mode, int scale_row,
                                  int is_bf16, void* stream) {
  using namespace vyomai;
  if (M <= 0 || N <= 0 || K <= 0 || K % 2 || gs <= 0 || gs % kKC ||
      K % gs || mode < 0 || mode > 3 || (M + kMT - 1) / kMT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    launch_int4<__nv_bfloat16>(x, wp, (const float*)scale, out, M, N, K, gs,
                               mode, scale_row, st);
  else
    launch_int4<float>(x, wp, (const float*)scale, out, M, N, K, gs, mode,
                       scale_row, st);
  return (int)cudaGetLastError();
}

// Weight-only int8 and int4 matmuls for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   K8  vyomai_tpu/ops/quant_matmul.py `_kernel_kn` / `_kernel_nk`
//       y = (x @ w_q) * scale[n], int8 weights [K, N] or [N, K];
//   K9  vyomai_tpu/ops/quant_matmul.py `_kernel_int4` (split) /
//       `_kernel_int4_fold` (fold), packed int4 [K/2, N] (kn) or [N, K/2]
//       (nk) with group scales;
//   K10 benchmarks/int4_dense_bench.py `_stream_kernel` / `_noscale_kernel`,
//       two attribution modes of K9 (one compile-time `Mode` of the int4
//       kernel here).
//
// What bounds them on the H100. At decode (M = 16 to 64 tokens) each
// weight byte is used for 2 * M FLOPs: the weight stream over 3.35 TB/s
// is the bound, and int8 / int4 storage is what halves / quarters it
// against bf16. At prefill (M up to 2,048) the same call is bound by
// arithmetic: 2*M*K*N FLOPs, 989 TFLOP/s on the bf16 tensor cores, 67 on
// the CUDA cores.
//
// Two designs. bf16 x against an `nk` weight (k contiguous, 16-byte
// aligned rows, K % 16 == 0: every int8 / int4 linear and the tied head of
// the serving modules) runs on the tensor cores: `int8_matmul_kernel_tc`
// (K8, int8 [N, K]) and `int4_matmul_kernel_tc` (K9 fold and K10's stream
// and noscale, packed int4 [N, K/2]). fp32 x, the `kn` layout, K9's split
// mode and unaligned operands run the CUDA-core kernels. The wrapper picks
// the route and the tensor-core plan (tile, splits) from the operands'
// dtype, layout, mode, alignment and shape before any launch
// (`ops/quant_matmul.py` `int8_route`, `int4_route`, `int8_tc_plan`), and
// the launcher refuses a plan the operands do not admit.
//
// The tensor-core kernels (`qmm_tc<Fmt, MT, NT>`, one body for the weight
// formats: int8, or an int4 mode). A CTA of 4 warps owns BM = 16 MT rows
// and BN = 32 NT columns; warp w takes columns [8 NT w, 8 NT (w + 1)) of
// every row, so each weight byte is widened once per CTA. K runs in
// steps of 64: the weight tile (int8 [BN][64], or int4 [BN][32] packed
// bytes) and x's tile [BM][64] (bf16, 16-byte chunks XOR-swizzled on the
// row), and for fold the step's group scales [BN][4], stream through a
// `cp.async` ring of kQStages stages, zero-filled past M, N and K. Within
// a step, lane (g, t4) reads k [16 t4, 16 t4 + 16) of a weight row with
// one load (16 int8 bytes, or 8 packed bytes: byte i holds k = 2i in its
// low nibble and 2i + 1 in its high one, exactly one bf16x2 register) and
// x's elements of the same k; `mma.sync.m16n8k16` j (0..3) takes k 16 t4
// + 4 j + {0..3}. That permutes k inside the step identically for both
// operands, so the products are those of the Pallas kernel, and every
// shared-memory read is conflict-free. The weights are widened in
// registers (`b_frag`): int8 and K10 stream widen bytes to bf16 exactly
// (`i8x4_to_bf16`; stream duplicates each packed byte for its two k);
// noscale takes the nibbles (exact); fold multiplies each nibble by its
// column's group scale in fp32 and rounds the product to bf16, the bits
// of the CUDA-core kernel and of the plain version, so only the fp32
// summation order changes. gs % 16 == 0, so a lane's 16 k lie in one
// group: fold's scales ride the ring (4-byte `cp.async`, one per column
// and 16 k), so they arrive with the weights three steps ahead instead
// of costing a device-memory round trip inside each step.
//
// Three tiles (`ops/quant_matmul.py` `int8_tc_plan`). 16 x 32 (MT = NT =
// 1) up to 16 rows, where the weight stream wants the most CTAs: x is the
// mma's A, the weights its B. Above 16 rows (int8 and fold), 64 x 128 (MT
// = NT = 4) where those tiles fill the SMs, else 64 x 64 (MT = 4, NT =
// 2): a 64-row tile holds a whole 64-lane decode batch, so each weight
// byte is fetched and widened once and feeds eight 8-row mma tiles.
// There the weights are the mma's A (their widened words are its
// registers as they come; x's 16-byte loads give aligned B pairs), so no
// register is moved into place for an mma.
//
// Any tile splits K across blockIdx.z when the tiles alone would not fill
// the SMs: each split CTA writes its fp32 partial tile to the workspace
// ([tile][split][BM * BN], each thread's sums at fixed offsets: coalesced
// 16-byte stores and loads, no masks), and the last CTA of a tile to
// finish (a counter, `__threadfence`, `atomicAdd`) sums them in split
// order 0..S-1 (deterministic) and resets the counter to 0. The epilogue
// is the Pallas one: the fp32 sum times scale[n] (K8), times
// scale[scale_row, n] (stream, noscale) or as it is (fold), rounded once
// to bf16.
//
// CUDA-core design, shaped by decode's 16 rows. A CTA of 8 warps owns 16
// rows of x (blockIdx.y) and 32 output columns (blockIdx.x), one column
// per lane, and sweeps K in slabs of 128: the slab's x (16 x 128, as fp32)
// is staged in shared memory, and warp w takes rows [16w, 16w + 16) of the
// slab. Each lane reads its column's 16 weights of that chunk straight
// from device memory into registers (one 16-byte load where k is
// contiguous, byte loads otherwise; 8 packed bytes for int4, one 8-byte
// load where k is contiguous), the next
// slab's chunk loaded while the current one is consumed, widens them, and
// does 16 x 16 fp32 FMAs against x rows read from shared memory as
// broadcasts (every lane of a warp reads the same x). The eight warps'
// partial sums are added in a fixed order through shared memory
// (deterministic), and the epilogue is the Pallas one: K8 multiplies the
// fp32 sum by scale[n] and rounds once to x's dtype; K9 "fold" rounds each
// scaled weight (nibble * scale[g, n], an fp32 product) to x's dtype
// before the sum; "split" multiplies each 16-row slice's fp32 partial sum
// by its group's scale (group sizes are multiples of 16, so a slice never
// straddles two groups); K10 "stream" dots the packed bytes themselves
// with both the even and the odd row of x, "noscale" the unpacked nibbles,
// each times one scale row (`scale_row`) at the end. Both weights are
// addressed through (n, k) strides, so the kn layout of the JAX package
// and the nk layout take the same kernel. Ragged M, N and K are masked; M
// needs no padding. Its costs: at M = 2,048 every weight byte is read 128
// times and the FLOPs run as fp32 FMAs; N = 1,024 gives 32 CTAs.

#include "common.cuh"
#include "tc_common.cuh"

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

// One lane's 8 packed bytes of column n at packed rows [k/2, k/2 + 8),
// through the (n, k) strides: one 8-byte load where k is contiguous (the
// modules' nk layout, 8-byte aligned rows), byte loads otherwise. K % 16
// == 0, so a chunk that starts below K is whole.
__device__ __forceinline__ void load_int4_chunk(
    const int8_t* __restrict__ wp, int n, int k, int N, int K, long long sn,
    long long sk, bool vec, int8_t (&dst)[kKC / 2]) {
  if (vec) {
    uint2 raw = make_uint2(0, 0);
    if (n < N && k < K)
      raw = *reinterpret_cast<const uint2*>(wp + n * sn + k / 2);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < kKC / 2; ++j) dst[j] = b[j];
  } else {
#pragma unroll
    for (int j = 0; j < kKC / 2; ++j)
      dst[j] = (n < N && k + 2 * j < K) ? wp[n * sn + (k / 2 + j) * sk]
                                        : (int8_t)0;
  }
}

template <typename T, int Mode>
__global__ void __launch_bounds__(kQmThreads)
int4_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wp,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int M, int N, int K, int gs, int scale_row,
                   long long sn, long long sk, int vec) {
  __shared__ __align__(16) float xs[kSlab * kMT];
  __shared__ float red[kMT * kCols];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.x * kCols + lane, m0 = blockIdx.y * kMT;
  float acc[kMT] = {};
  int8_t cur[kKC / 2], nxt[kKC / 2] = {};
  load_int4_chunk(wp, n, warp * kKC, N, K, sn, sk, vec, cur);
  for (int k0 = 0; k0 < K; k0 += kSlab) {
    __syncthreads();
    stage_x<T>(x, xs, M, K, m0, k0, tid);
    __syncthreads();
    const int kc = k0 + warp * kKC;   // this warp's first row
    if (k0 + kSlab < K)
      load_int4_chunk(wp, n, kc + kSlab, N, K, sn, sk, vec, nxt);
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

// ------------------------------- tensor-core K8 / K9 / K10 (bf16, nk)

constexpr int kQK = 64;        // k per ring step
constexpr int kQStages = 4;    // ring depth (steps in flight: 3)
constexpr int kInt8W = 4;      // weight format of K8, beside Int4Mode's

// Bytes of one weight row per k step: 64 int8, or 32 packed int4 bytes.
template <int Fmt>
__host__ __device__ constexpr int tc_wrow() {
  return Fmt == kInt8W ? kQK : kQK / 2;
}

// Bytes of a ring stage: the weight tile [BN][tc_wrow], x's [BM][64] bf16,
// and for fold the group scales of the step [BN][4] fp32 (one per 16 k).
template <int Fmt, int MT, int NT>
__host__ __device__ constexpr int tc_stage_bytes() {
  return 32 * NT * tc_wrow<Fmt>() + 16 * MT * kQK * 2 +
         (Fmt == kFold ? 32 * NT * 16 : 0);
}

// 4-byte global -> shared copy; `bytes` 0 writes 4 zero bytes.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// Four int8 weights (a little-endian word, k ascending) as two bf16x2
// words, exactly: each byte, offset to unsigned, becomes the low mantissa
// bits of 2^23 (0x4B000000 | u = 2^23 + u as fp32), 2^23 + 128 is
// subtracted, and the top half of the exact fp32 integer is its bf16.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653));
  const float kBias = 8388736.f;   // 2^23 + 128
  lo = __byte_perm(__float_as_uint(f0 - kBias), __float_as_uint(f1 - kBias),
                   0x7632);
  hi = __byte_perm(__float_as_uint(f2 - kBias), __float_as_uint(f3 - kBias),
                   0x7632);
}

// The two nibbles of the low byte of v (k = 2i low, 2i + 1 high) as one
// bf16x2 word, the low nibble in the low half. Each nibble, offset to
// unsigned (^ 8), becomes the low mantissa bits of 2^23 and 2^23 + 8 is
// subtracted: the signed nibble, exact in fp32. noscale keeps it (the top
// half of a small fp32 integer is its exact bf16); fold multiplies it by
// the column's group scale in fp32 and rounds the product to bf16 (RNE),
// the bits of the CUDA-core kernel and of `int4_matmul_ref`.
template <int Mode>
__device__ __forceinline__ uint32_t nibbles_to_bf16(uint32_t v, float s) {
  const uint32_t u = v ^ 0x88u;
  const float kBias = 8388616.f;   // 2^23 + 8
  const float lo = __uint_as_float(0x4B000000u | (u & 0xFu)) - kBias;
  const float hi = __uint_as_float(0x4B000000u | ((u >> 4) & 0xFu)) - kBias;
  if constexpr (Mode == kFold) return tc::pack_bf16(lo * s, hi * s);
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// 32-bit word i (a constant once unrolled) of a 16-byte vector.
__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The B fragment (b0: k rows 2 t4, 2 t4 + 1; b1: 2 t4 + 8, 2 t4 + 9 in the
// mma's order) of mma j = 2 h + jj from a lane's weight bytes `raw`: int8,
// 16 bytes, word j; int4, 8 bytes (raw.x, raw.y), bytes 2 j and 2 j + 1,
// each holding two k of the column. stream widens each packed byte itself
// as the int8 of both its k (bytes duplicated, then PR 10's widening).
template <int Fmt>
__device__ __forceinline__ void b_frag(const uint4& raw, int h, int jj,
                                       float s, uint32_t& b0, uint32_t& b1) {
  if constexpr (Fmt == kInt8W) {
    i8x4_to_bf16(word_of(raw, 2 * h + jj), b0, b1);
  } else {
    const uint32_t w = word_of(raw, h);   // bytes 4 h .. 4 h + 3
    if constexpr (Fmt == kStream) {
      i8x4_to_bf16(__byte_perm(w, 0, jj ? 0x3322 : 0x1100), b0, b1);
    } else {
      b0 = nibbles_to_bf16<Fmt>(w >> (16 * jj), s);
      b1 = nibbles_to_bf16<Fmt>(w >> (16 * jj + 8), s);
    }
  }
}

// Issue the copies of k step `k0` into a ring stage: weight rows [n0, n0 +
// BN) at tc_wrow bytes a row, as 16-byte chunks (int8 rows r, r + 1 fill
// one 128-byte line; int4 rows are 32 bytes), and x rows [m0, m0 + BM)
// with chunk c of row r at c ^ (r & 7); for fold, the scale of each 16 k
// of each column, scale[(k0 + 16 c) / gs, n], at [col][c]. Past M, N or K
// a chunk is zero-filled (K % 16 == 0: a 16-k piece is wholly in or out;
// an int4 chunk of 32 k may be half live), from an address clamped into
// the operand (row, and k, clamped: no select of a pointer a step).
template <int Fmt, int MT, int NT>
__device__ __forceinline__ void tc_load_step(
    const tc::bf16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, int M, int N, int K, int gs,
    long long sn, int m0, int n0, int k0, char* stage, int tid) {
  constexpr int BM = 16 * MT, BN = 32 * NT, WR = tc_wrow<Fmt>();
  constexpr int CPR = WR / 16, KPB = Fmt == kInt8W ? 1 : 2;  // k a byte
  constexpr int WCH = BN * CPR;
  const uint32_t wbase = tc::smem_addr(stage);
  const uint32_t xbase = wbase + BN * WR;
#pragma unroll
  for (int it = 0; it < (WCH + tc::kThreads - 1) / tc::kThreads; ++it) {
    const int i = tid + it * tc::kThreads, r = i / CPR, c = i % CPR;
    if (WCH % tc::kThreads == 0 || i < WCH) {
      const int gk = k0 + 16 * KPB * c;   // the chunk's first k
      const bool live = n0 + r < N && gk < K;
      const int8_t* src = w + (long long)min(n0 + r, N - 1) * sn +
                          (gk < K ? gk / KPB : 0);
      const int bytes = KPB == 1 ? 16 : min(16, (K - gk) / KPB);
      tc::cp_async16(wbase + i * 16, src, live ? bytes : 0);
    }
  }
#pragma unroll
  for (int it = 0; it < BM * 8 / tc::kThreads; ++it) {
    const int i = tid + it * tc::kThreads, r = i >> 3, c = i & 7;
    const int gk = k0 + 8 * c;
    const bool live = m0 + r < M && gk < K;
    const tc::bf16* src =
        x + (long long)min(m0 + r, M - 1) * K + (gk < K ? gk : 0);
    tc::cp_async16(xbase + (r * 8 + (c ^ (r & 7))) * 16, src, live ? 16 : 0);
  }
  if constexpr (Fmt == kFold) {
    const uint32_t sbase = xbase + BM * kQK * 2;
#pragma unroll
    for (int it = 0; it < BN * 4 / tc::kThreads; ++it) {
      const int e = tid + it * tc::kThreads, col = e >> 2, c = e & 3;
      const int gk = k0 + 16 * c;
      const bool live = n0 + col < N && gk < K;
      const float* src =
          live ? scale + (long long)(gk / gs) * N + n0 + col : scale;
      cp_async4(sbase + e * 4, src, live ? 4 : 0);
    }
  }
}

// One k step of a warp over the stage's 64 k. Lane (g, t4) holds k [16
// t4, 16 t4 + 16) of weight row 8 nt + g of the warp's 8 NT (16 int8
// bytes, or 8 packed int4 bytes, in one load) and, for fold, that row's
// group scale for them (gs % 16 == 0: the 16 k lie in one group); mma j
// takes k 16 t4 + 4 j + {0, 1} as its k pair 2 t4 and + {2, 3} as its
// pair 2 t4 + 8, weights and x alike.
//  - 16-row tile (MT = 1): x is the mma's A (rows g, g + 8: four words
// gathered from two loads), the weights its B: acc[nt] += x rows . weight
// columns 8 nt ...
//  - 64-row tiles (MT = 4): the weights are the mma's A, columns g and g
// + 8 of each 16 (rows 8 nt + g, nt = 2 at + {0, 1}: their widened words
// are the A registers as they come), and x its B, the 8 rows 8 bt ..
// (one 16-byte load: two aligned B pairs): acc[8 at + bt] += weight
// columns 16 at .. of the warp . x rows 8 bt .., so no register is moved
// into place for an mma.
template <int Fmt, int MT, int NT>
__device__ __forceinline__ void tc_step(const char* stage, int warp,
                                        int lane, float (&acc)[MT * NT][4]) {
  constexpr int BM = 16 * MT, BN = 32 * NT, WR = tc_wrow<Fmt>();
  const int g = lane >> 2, t4 = lane & 3;
  const int row = warp * 8 * NT + g;
  const char* wt = stage + row * WR + (WR / 4) * t4;
  const char* xt = stage + BN * WR;
  const float* st = reinterpret_cast<const float*>(xt + BM * kQK * 2);
  uint4 raw[NT];
  float sc[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if constexpr (Fmt == kInt8W) {
      raw[nt] = *reinterpret_cast<const uint4*>(wt + 8 * nt * WR);
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(wt + 8 * nt * WR);
      raw[nt] = make_uint4(v.x, v.y, 0u, 0u);
    }
    sc[nt] = Fmt == kFold ? st[(row + 8 * nt) * 4 + t4] : 1.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // mma j = 2 h + jj: k [16 t4 + 8 h, + 8)
    const int chunk = (2 * t4 + h) ^ g;   // x rows r with r & 7 = g
    if constexpr (MT == 1) {
      uint32_t b[2][NT][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          b_frag<Fmt>(raw[nt], h, jj, sc[nt], b[jj][nt][0], b[jj][nt][1]);
      const uint4 xlo =
          *reinterpret_cast<const uint4*>(xt + (g * 8 + chunk) * 16);
      const uint4 xhi =
          *reinterpret_cast<const uint4*>(xt + ((g + 8) * 8 + chunk) * 16);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const uint32_t a[4] = {word_of(xlo, 2 * jj), word_of(xhi, 2 * jj),
                               word_of(xlo, 2 * jj + 1),
                               word_of(xhi, 2 * jj + 1)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          tc::mma_bf16(acc[nt], a, b[jj][nt][0], b[jj][nt][1]);
      }
    } else {
      uint32_t a[2][NT / 2][4];   // [jj][at]: columns g (0, 2), g + 8 (1, 3)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int at = 0; at < NT / 2; ++at) {
          b_frag<Fmt>(raw[2 * at], h, jj, sc[2 * at], a[jj][at][0],
                      a[jj][at][2]);
          b_frag<Fmt>(raw[2 * at + 1], h, jj, sc[2 * at + 1], a[jj][at][1],
                      a[jj][at][3]);
        }
#pragma unroll
      for (int bt = 0; bt < BM / 8; ++bt) {
        const uint4 xv = *reinterpret_cast<const uint4*>(
            xt + ((8 * bt + g) * 8 + chunk) * 16);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int at = 0; at < NT / 2; ++at)
            tc::mma_bf16(acc[at * (BM / 8) + bt], a[jj][at],
                         word_of(xv, 2 * jj), word_of(xv, 2 * jj + 1));
      }
    }
  }
}

// out[row, col], out[row, col + 1] = v0, v1 rounded to bf16, masked at N
// (a 4-byte store where both are live and the row start is aligned).
__device__ __forceinline__ void store_pair(tc::bf16* __restrict__ out,
                                           int N, int row, int col, float v0,
                                           float v1) {
  tc::bf16* o = out + (long long)row * N + col;
  if (col + 1 < N && !(N & 1)) {
    *reinterpret_cast<uint32_t*>(o) = tc::pack_bf16(v0, v1);
  } else {
    if (col < N) o[0] = __float2bfloat16(v0);
    if (col + 1 < N) o[1] = __float2bfloat16(v1);
  }
}

// The body of the tensor-core kernels, for one weight format: the ring,
// the steps, the split-K sum and the epilogue, out = round(acc *
// ep_scale[n]) (fold: no scale, the weights carry it).
template <int Fmt, int MT, int NT>
__device__ __forceinline__ void qmm_tc(
    const tc::bf16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ ep_scale,
    tc::bf16* __restrict__ out, int M, int N, int K, int gs, long long sn,
    int splits, float* __restrict__ ws, int* __restrict__ counters) {
  constexpr int BM = 16 * MT, BN = 32 * NT;
  constexpr int kStage = tc_stage_bytes<Fmt, MT, NT>();
  extern __shared__ __align__(128) char smem[];
  __shared__ int is_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  // this split's whole k steps [s0, s0 + nsteps)
  const int steps = (K + kQK - 1) / kQK;
  const int per = (steps + splits - 1) / splits;
  const int s0 = blockIdx.z * per;
  const int nsteps = min(steps, s0 + per) - s0;

  float acc[MT * NT][4];   // the mma tiles of the warp (tc_step)
#pragma unroll
  for (int t = 0; t < MT * NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kQStages - 1; ++s) {
    if (s < nsteps)
      tc_load_step<Fmt, MT, NT>(x, w, scale, M, N, K, gs, sn, m0, n0,
                                (s0 + s) * kQK, smem + s * kStage, tid);
    tc::cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    tc::cp_async_wait<kQStages - 2>();
    __syncthreads();   // step i landed; step i - 1's stage is consumed
    const int nxt = i + kQStages - 1;
    if (nxt < nsteps)
      tc_load_step<Fmt, MT, NT>(x, w, scale, M, N, K, gs, sn, m0, n0,
                                (s0 + nxt) * kQK,
                                smem + (nxt % kQStages) * kStage, tid);
    tc::cp_async_commit();
    tc_step<Fmt, MT, NT>(smem + (i % kQStages) * kStage, warp, lane, acc);
  }
  tc::cp_async_wait<0>();

  if (splits > 1) {
    // fp32 partials in the tile's slice of the workspace, [tile][split]
    // [BM * BN / 4] float4s: a thread's acc[t] at float4 t * kThreads +
    // tid, so partials are written and read back with coalesced 16-byte
    // accesses and no masks (rows and columns past M and N hold zeros).
    // The last CTA of the tile to finish sums them.
    constexpr int kPart = BM * BN / 4;   // float4s of one partial
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float4* part = reinterpret_cast<float4*>(ws) +
                   (long long)tile * splits * kPart + tid;
#pragma unroll
    for (int t = 0; t < MT * NT; ++t)
      part[(long long)blockIdx.z * kPart + t * tc::kThreads] =
          make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
    __threadfence();
    __syncthreads();
    int* counter = counters + tile;
    if (tid == 0) is_last = atomicAdd(counter, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // acc = partial 0 + partial 1 + ... in split order; each pass loads
    // kSumUnroll splits (16 float4s a thread, 8 on the 16-row tile, whose
    // registers bound how many of its CTAs an SM holds) before it adds them
    constexpr int kSumUnroll = (MT == 1 ? 8 : 16) / (MT * NT);
    for (int sb = 0; sb < splits; sb += kSumUnroll) {
      float4 v[kSumUnroll][MT * NT];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u)
#pragma unroll
        for (int e = 0; e < MT * NT; ++e)
          v[u][e] = sb + u < splits
                        ? __ldcg(part + (long long)(sb + u) * kPart +
                                 e * tc::kThreads)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u)
#pragma unroll
        for (int t = 0; t < MT * NT; ++t) {
          const float4 w = v[u][t];
          float* a = acc[t];
          if (sb + u == 0) {
            a[0] = w.x, a[1] = w.y, a[2] = w.z, a[3] = w.w;
          } else if (sb + u < splits) {
            a[0] += w.x, a[1] += w.y, a[2] += w.z, a[3] += w.w;
          }
        }
    }
    if (tid == 0) *counter = 0;   // ready for the next call
  }
  if constexpr (MT == 1) {   // acc[nt]: rows g, g + 8; columns 2 t4 + {0, 1}
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + warp * 8 * NT + 8 * nt + 2 * t4;
      float sc0 = 1.f, sc1 = 1.f;
      if constexpr (Fmt != kFold) {
        sc0 = col < N ? ep_scale[col] : 0.f;
        sc1 = col + 1 < N ? ep_scale[col + 1] : 0.f;
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + g + 8 * hr;
        if (row < M)
          store_pair(out, N, row, col, acc[nt][2 * hr] * sc0,
                     acc[nt][2 * hr + 1] * sc1);
      }
    }
  } else {   // acc[8 at + bt]: columns g, g + 8 of 16; rows 2 t4 + {0, 1}
#pragma unroll
    for (int at = 0; at < NT / 2; ++at)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int col = n0 + warp * 8 * NT + 16 * at + g + 8 * hr;
        if (col >= N) continue;
        const float sc = Fmt == kFold ? 1.f : ep_scale[col];
#pragma unroll
        for (int bt = 0; bt < BM / 8; ++bt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = m0 + 8 * bt + 2 * t4 + e;
            if (row < M)
              out[(long long)row * N + col] =
                  __float2bfloat16(acc[at * (BM / 8) + bt][2 * hr + e] * sc);
          }
      }
  }
}

// K8: int8 [N, K], out = round(acc * scale[n]).
template <int MT, int NT>
__global__ void __launch_bounds__(tc::kThreads, MT == 1 ? 4 : 3)
int8_matmul_kernel_tc(const tc::bf16* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      tc::bf16* __restrict__ out, int M, int N, int K,
                      long long sn, int splits, float* __restrict__ ws,
                      int* __restrict__ counters) {
  qmm_tc<kInt8W, MT, NT>(x, w, scale, scale, out, M, N, K, 0, sn, splits,
                         ws, counters);
}

// K9 fold and K10 stream / noscale: packed int4 [N, K/2]; stream and
// noscale scale by scale[scale_row, n] at the end.
template <int Mode, int MT, int NT>
__global__ void __launch_bounds__(tc::kThreads, MT == 1 ? 4 : 3)
int4_matmul_kernel_tc(const tc::bf16* __restrict__ x,
                      const int8_t* __restrict__ wp,
                      const float* __restrict__ scale,
                      tc::bf16* __restrict__ out, int M, int N, int K,
                      int gs, int scale_row, long long sn, int splits,
                      float* __restrict__ ws, int* __restrict__ counters) {
  qmm_tc<Mode, MT, NT>(x, wp, scale, scale + (long long)scale_row * N, out,
                       M, N, K, gs, sn, splits, ws, counters);
}

// Grid and dynamic shared memory of a tensor-core launch (above 48 KB,
// with the static `is_last`, only by opt-in).
template <int Fmt, int MT, int NT, typename Kern>
static cudaError_t tc_prepare(Kern kern, int M, int N, int splits,
                              dim3& grid, int& smem) {
  constexpr int BM = 16 * MT, BN = 32 * NT;
  smem = kQStages * tc_stage_bytes<Fmt, MT, NT>();
  grid = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (grid.y > 65535 || splits > 65535) return cudaErrorInvalidValue;
  if (smem + 16 > 48 * 1024)
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return cudaSuccess;
}

// Whether the operands admit a tensor-core plan: k-contiguous weight rows
// and both pointers 16-byte aligned, K % 16 == 0, and `splits` whole k
// steps with none empty (a workspace and counters where it splits).
static bool tc_plan_ok(const void* x, const void* w, int K, long long sn,
                       long long sk, int splits, const void* ws,
                       const void* counters) {
  if (sk != 1 || K % 16 || sn % 16 || (uintptr_t)w % 16 ||
      (uintptr_t)x % 16 || splits < 1)
    return false;
  const int steps = (K + kQK - 1) / kQK;
  const int per = (steps + splits - 1) / splits;
  return (steps + per - 1) / per == splits &&
         (splits == 1 || (ws != nullptr && counters != nullptr));
}

template <int MT, int NT>
static int launch_int8_tc(const void* x, const void* w, const float* scale,
                          void* out, int M, int N, int K, long long sn,
                          int splits, float* ws, int* counters,
                          cudaStream_t st) {
  dim3 grid;
  int smem;
  const cudaError_t err = tc_prepare<kInt8W, MT, NT>(
      int8_matmul_kernel_tc<MT, NT>, M, N, splits, grid, smem);
  if (err != cudaSuccess) return (int)err;
  int8_matmul_kernel_tc<MT, NT><<<grid, tc::kThreads, smem, st>>>(
      (const tc::bf16*)x, (const int8_t*)w, scale, (tc::bf16*)out, M, N, K,
      sn, splits, ws, counters);
  return (int)cudaGetLastError();
}

template <int Mode, int MT, int NT>
static int launch_int4_tc(const void* x, const void* wp, const float* scale,
                          void* out, int M, int N, int K, int gs,
                          int scale_row, long long sn, int splits, float* ws,
                          int* counters, cudaStream_t st) {
  dim3 grid;
  int smem;
  const cudaError_t err = tc_prepare<Mode, MT, NT>(
      int4_matmul_kernel_tc<Mode, MT, NT>, M, N, splits, grid, smem);
  if (err != cudaSuccess) return (int)err;
  int4_matmul_kernel_tc<Mode, MT, NT><<<grid, tc::kThreads, smem, st>>>(
      (const tc::bf16*)x, (const int8_t*)wp, scale, (tc::bf16*)out, M, N, K,
      gs, scale_row, sn, splits, ws, counters);
  return (int)cudaGetLastError();
}

template <typename T>
static void launch_int4(const void* x, const void* wp, const float* scale,
                        void* out, int M, int N, int K, int gs, int mode,
                        int scale_row, long long sn, long long sk, int vec,
                        cudaStream_t st) {
  const dim3 grid((N + kCols - 1) / kCols, (M + kMT - 1) / kMT);
  const dim3 block(kQmThreads);
  const T* xt = (const T*)x;
  const int8_t* w = (const int8_t*)wp;
  T* o = (T*)out;
  switch (mode) {
    case kFold:
      int4_matmul_kernel<T, kFold><<<grid, block, 0, st>>>(
          xt, w, scale, o, M, N, K, gs, scale_row, sn, sk, vec);
      break;
    case kSplit:
      int4_matmul_kernel<T, kSplit><<<grid, block, 0, st>>>(
          xt, w, scale, o, M, N, K, gs, scale_row, sn, sk, vec);
      break;
    case kStream:
      int4_matmul_kernel<T, kStream><<<grid, block, 0, st>>>(
          xt, w, scale, o, M, N, K, gs, scale_row, sn, sk, vec);
      break;
    default:
      int4_matmul_kernel<T, kNoscale><<<grid, block, 0, st>>>(
          xt, w, scale, o, M, N, K, gs, scale_row, sn, sk, vec);
  }
}

}  // namespace vyomai

extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* out, int M, int N,
                                  int K, long long sn, long long sk,
                                  int is_bf16, int bm, int bn, int splits,
                                  void* ws, void* counters, void* stream) {
  using namespace vyomai;
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bm) {   // the tensor-core plan: bf16 x, nk weight, aligned rows
    if (!is_bf16 || !tc_plan_ok(x, w, K, sn, sk, splits, ws, counters))
      return (int)cudaErrorInvalidValue;
    const float* s = (const float*)scale;
    float* wsp = (float*)ws;
    int* cnt = (int*)counters;
    if (bm == 16 && bn == 32)
      return launch_int8_tc<1, 1>(x, w, s, out, M, N, K, sn, splits, wsp,
                                  cnt, st);
    if (bm == 64 && bn == 64)
      return launch_int8_tc<4, 2>(x, w, s, out, M, N, K, sn, splits, wsp,
                                  cnt, st);
    if (bm == 64 && bn == 128)
      return launch_int8_tc<4, 4>(x, w, s, out, M, N, K, sn, splits, wsp,
                                  cnt, st);
    return (int)cudaErrorInvalidValue;
  }
  if ((M + kMT - 1) / kMT > 65535) return (int)cudaErrorInvalidValue;
  const int vec = sk == 1 && K % kKC == 0 && sn % 16 == 0 &&
                  (uintptr_t)w % 16 == 0;
  const dim3 grid((N + kCols - 1) / kCols, (M + kMT - 1) / kMT);
  const dim3 block(kQmThreads);
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
                                  int is_bf16, long long sn, long long sk,
                                  int bm, int bn, int splits, void* ws,
                                  void* counters, void* stream) {
  using namespace vyomai;
  if (M <= 0 || N <= 0 || K <= 0 || K % 2 || gs <= 0 || gs % kKC ||
      K % gs || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bm) {   // the tensor-core plan: bf16 x, nk weight, fold/stream/noscale
    if (!is_bf16 || mode == kSplit ||
        !tc_plan_ok(x, wp, K, sn, sk, splits, ws, counters))
      return (int)cudaErrorInvalidValue;
    const float* s = (const float*)scale;
    float* wsp = (float*)ws;
    int* cnt = (int*)counters;
    if (bm == 16 && bn == 32) {
      if (mode == kFold)
        return launch_int4_tc<kFold, 1, 1>(x, wp, s, out, M, N, K, gs,
                                           scale_row, sn, splits, wsp, cnt,
                                           st);
      if (mode == kStream)
        return launch_int4_tc<kStream, 1, 1>(x, wp, s, out, M, N, K, gs,
                                             scale_row, sn, splits, wsp, cnt,
                                             st);
      return launch_int4_tc<kNoscale, 1, 1>(x, wp, s, out, M, N, K, gs,
                                            scale_row, sn, splits, wsp, cnt,
                                            st);
    }
    if (bm == 64 && bn == 64 && mode == kFold)
      return launch_int4_tc<kFold, 4, 2>(x, wp, s, out, M, N, K, gs,
                                         scale_row, sn, splits, wsp, cnt, st);
    if (bm == 64 && bn == 128 && mode == kFold)
      return launch_int4_tc<kFold, 4, 4>(x, wp, s, out, M, N, K, gs,
                                         scale_row, sn, splits, wsp, cnt, st);
    return (int)cudaErrorInvalidValue;
  }
  if ((M + kMT - 1) / kMT > 65535) return (int)cudaErrorInvalidValue;
  const int vec = sk == 1 && sn % 8 == 0 && (uintptr_t)wp % 8 == 0;
  if (is_bf16)
    launch_int4<__nv_bfloat16>(x, wp, (const float*)scale, out, M, N, K, gs,
                               mode, scale_row, sn, sk, vec, st);
  else
    launch_int4<float>(x, wp, (const float*)scale, out, M, N, K, gs, mode,
                       scale_row, sn, sk, vec, st);
  return (int)cudaGetLastError();
}

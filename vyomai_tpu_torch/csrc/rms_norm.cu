// K12: RMSNorm over the last dimension of a [rows, D] bf16 or fp32 tensor,
// with an optional residual add folded into the same launch.
//
// Replaces no TPU kernel: the JAX package leaves its norms to XLA, which
// fuses the widen, square, mean, rsqrt, scale and cast (and the residual
// add in front) into one fusion. PyTorch runs each of those as a kernel of
// its own, about nine launches a norm site, each moving a few hundred KB:
// the serving steps' norms are bound by launches, not by bytes. One launch
// a site reads each input row once in 16-byte vectors, keeps it in
// registers, reduces the squares by warp shuffles (and through shared
// memory across the warps of a wide row), and writes each output once.
//
// Arithmetic, that of core.nn.rms_norm: x widened to fp32; with a residual
// s = round(x + residual) in x's type, stored, and the norm reads that
// rounded s; mean of squares in fp32 (each square rounded, then summed:
// only the order of the sum differs); rsqrtf(mean + eps), the function
// ATen's rsqrt calls on the card; (x * r) * w in fp32 with w widened;
// rounded to x's type. No operation is contracted into an fma.
//
// Block shape from the row width: a row of V vectors takes T threads, T the
// power of two >= V where V <= 32 (several rows share a warp), else a
// multiple of 32 giving each thread at most kMaxVecs vectors.
#include "common.cuh"

namespace vyomai {

constexpr int kMaxVecs = 4;     // 16-byte vectors a thread keeps of its row
constexpr int kRowBlock = 256;  // threads of a block of narrow rows
constexpr int kMinBlocks = 128; // wide rows: blocks a grid aims at first

struct RmsNormArgs {
  const void* x;
  const void* residual;  // nullptr: no residual add
  const void* weight;
  void* sum;             // x + residual, written with a residual
  void* out;
  int rows, V, T;        // rows, 16-byte vectors a row, threads a row
  float eps, inv_d;
};

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const float* src) {
  uint4 raw;
  T* elems = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < Vec<T>::kN; ++e) elems[e] = from_float<T>(src[e]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

template <typename T>
__global__ void __launch_bounds__(1024) rms_norm_kernel(const RmsNormArgs a) {
  constexpr int kN = Vec<T>::kN;
  __shared__ float warp_sums[32];
  const int t = threadIdx.x % a.T;
  const int r = threadIdx.x / a.T;
  const long long row = (long long)blockIdx.x * (blockDim.x / a.T) + r;
  const bool live = row < a.rows;
  const long long base = row * a.V * kN;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* res = a.residual == nullptr
                     ? nullptr : static_cast<const T*>(a.residual) + base;

  float v[kMaxVecs][kN];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int j = t + i * a.T;
    if (!live || j >= a.V) continue;
    load_vec(x + j * kN, v[i]);
    if (res != nullptr) {
      float d[kN];
      load_vec(res + j * kN, d);
#pragma unroll
      for (int e = 0; e < kN; ++e)   // the sum as x's type stores it
        v[i][e] = to_float<T>(from_float<T>(__fadd_rn(d[e], v[i][e])));
      store_vec(static_cast<T*>(a.sum) + base + j * kN, v[i]);
    }
#pragma unroll
    for (int e = 0; e < kN; ++e)
      ss = __fadd_rn(ss, __fmul_rn(v[i][e], v[i][e]));
  }
  // every thread of a row ends with the same sum: a butterfly adds the
  // same two operands on both sides of each exchange
  if (a.T <= 32) {
    for (int o = a.T / 2; o > 0; o >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  } else {
    for (int o = 16; o > 0; o >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = ss;
    __syncthreads();
    const int warps = a.T / 32;
    ss = 0.f;
    for (int k = 0; k < warps; ++k)
      ss = __fadd_rn(ss, warp_sums[r * warps + k]);
  }
  if (!live) return;
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss, a.inv_d), a.eps));
  const T* w = static_cast<const T*>(a.weight);
  T* out = static_cast<T*>(a.out) + base;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int j = t + i * a.T;
    if (j >= a.V) continue;
    float wv[kN], y[kN];
    load_vec(w + j * kN, wv);
#pragma unroll
    for (int e = 0; e < kN; ++e)
      y[e] = __fmul_rn(__fmul_rn(v[i][e], inv), wv[e]);
    store_vec(out + j * kN, y);
  }
}

template <typename T>
int launch_rows(RmsNormArgs a, int D, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  if (D < kN || D % kN) return (int)cudaErrorInvalidValue;
  a.V = D / kN;
  int rows_per_block;
  if (a.V <= 32) {
    a.T = 1;
    while (a.T < a.V) a.T *= 2;
    rows_per_block = kRowBlock / a.T;
  } else {
    a.T = 32 * ((a.V + 32 * kMaxVecs - 1) / (32 * kMaxVecs));
    if (a.T > 1024) return (int)cudaErrorInvalidValue;
    // few rows (a decode step): one row a block, spread over the SMs
    const int fit = a.T >= kRowBlock ? 1 : kRowBlock / a.T;
    const int want = (a.rows + kMinBlocks - 1) / kMinBlocks;
    rows_per_block = want < 1 ? 1 : (want < fit ? want : fit);
  }
  a.inv_d = 1.0f / (float)D;
  const long long blocks =
      ((long long)a.rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rms_norm_kernel<T><<<(unsigned)blocks, rows_per_block * a.T, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace vyomai

// x, residual (nullptr: none), weight [D], sum (written with a residual),
// out: 16-byte aligned, rows of D contiguous elements of one type.
extern "C" int rms_norm_launch(const void* x, const void* residual,
                               const void* weight, void* sum, void* out,
                               int rows, int D, float eps, int is_bf16,
                               void* stream) {
  using namespace vyomai;
  if (rows < 1 || (residual != nullptr && sum == nullptr))
    return (int)cudaErrorInvalidValue;
  const RmsNormArgs a{x, residual, weight, sum, out, rows, 0, 0, eps, 0.f};
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_rows<__nv_bfloat16>(a, D, st)
                 : launch_rows<float>(a, D, st);
}

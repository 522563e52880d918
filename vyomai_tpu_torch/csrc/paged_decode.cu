// Paged-decode attention for Hopper (sm_90a): a split-KV pair of kernels
// (flash decoding).
//
// Replaces the TPU kernel vyomai_tpu/ops/paged_decode_pallas.py `_kernel`:
// bf16 / fp32 pools and its int8 pool (one fp32 scale per written row) and
// int4 pool (two values per byte, per-head-local split halves, one fp32
// scale per (row, kv head)). Window and sinks are not ported yet.
//
// What bounds it on the H100: device-memory bandwidth. Per decode step each
// live context token's K and V rows (2 * D elements per kv head) are read
// once and used for a handful of FMAs per byte, far below the ~295 FLOP/byte
// the card needs before its arithmetic would limit, so there is nothing for
// the tensor cores to do. The int8 and int4 pools halve and quarter the
// bytes.
//
// What the design does about it. A decode call moves a few MB, which the
// card reads in microseconds, so what costs is latency and idle SMs: one
// CTA per (sequence, kv head) left the longest lane to set the time. Here
// - each lane's context is cut into partitions of P tokens, a whole number
//   of pool blocks, chosen on the host from shapes alone
//   (ops/paged_decode.py `_decode_plan`, so a CUDA graph can capture the
//   launch): one CTA per (sequence, kv head, partition), and the live CTAs
//   fill the SMs several times over; a partition past the live length
//   returns at once. `split_range` is the one place a partition's tokens
//   are computed (window + sinks would narrow it there);
// - a CTA reads its table entries once into shared memory (-1 reads block
//   0, as the JAX wrapper does) and streams its K and V rows with 16-byte
//   cp.async into a ring of shared-memory stages, in the pool's stored type
//   (bf16, fp32, int8 or packed int4 bytes); a quantized pool's row scales
//   travel through the same ring (4-byte cp.async). Values are converted in
//   registers where they are used; nothing is staged as fp32;
// - each warp owns a quarter of every tile's tokens and runs its own online
//   softmax over them for all G <= 8 query rows of the kv head: a lane holds
//   D/32 features of each q row (scaled in fp32 and rounded to q's dtype)
//   and of each K and V row, so each K row is read once and used G times,
//   and dots are summed with warp shuffles. Every thread works at any G.
//   int4 bytes unpack in natural feature order (byte j holds feature j low,
//   j + D/2 high); the TPU kernel's "pi order" existed for Mosaic's lanes;
// - scores, softmax and value sums are fp32; the running max is floored at
//   -1e30. A key row's scale multiplies its score; the value sum takes p
//   times the value row's scale, after the running sum l has taken the
//   unscaled p (the TPU kernel's l.163 before l.166-167);
// - the CTA combines its four warps and writes (m, l, unnormalised acc) in
//   fp32 to a workspace the wrapper allocates; the combine kernel (a warp
//   per (sequence, head)) reads the live partitions in split order and
//   writes acc / l rounded once to q's dtype. The order is fixed and there
//   are no atomics, so two calls give the same bits. With one partition the
//   first kernel writes the output itself.

#include "common.cuh"
#include "tc_common.cuh"

namespace vyomai {

constexpr int kDecodeThreads = 128;   // 4 warps
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kMaxGroup = 8;          // query heads per kv head
constexpr int kMaxTable = 256;        // table entries one partition spans

enum PoolQuant { kFloatPool = 0, kInt8Pool = 1, kInt4Pool = 2 };

// The tokens [lo, hi) of partition s of a lane with n live tokens (empty
// when lo >= hi).
struct TokenRange {
  int lo, hi;
};

__device__ __forceinline__ TokenRange split_range(int s, int P, int n) {
  TokenRange r;
  r.lo = s * P;
  r.hi = min(r.lo + P, n);
  return r;
}

// A pool row of one kv head: its bytes, the bytes and features one lane
// reads of it, the tokens of a ring stage and the ring's depth (2 stages of
// 16 KB K + V for the float pools at D = 128, up to 4 smaller ones).
template <typename T, int D, int Quant>
struct PoolRow {
  static constexpr int kBytes = Quant == kFloatPool  ? D * (int)sizeof(T)
                                : Quant == kInt8Pool ? D
                                                     : D / 2;
  static constexpr int kLaneBytes = kBytes / 32;
  static constexpr int kTok = kBytes > 256 ? 16 : 32;
  static constexpr int kKV = kTok * kBytes;   // one K (or V) tile
  static constexpr int kStageBytes =
      2 * kKV + (Quant == kFloatPool ? 0 : 2 * kTok * (int)sizeof(float));
  static constexpr int kFit = 32768 / (2 * kKV);
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
};

// Feature i (< D/32) that a lane holds: consecutive features, or for int4
// the low nibbles of its bytes then their high nibbles.
template <int D, int Quant>
__device__ __forceinline__ int lane_feature(int lane, int i) {
  constexpr int F = D / 32;
  if (Quant == kInt4Pool) {
    constexpr int LB = F / 2;
    return i < LB ? lane * LB + i : D / 2 + lane * LB + (i - LB);
  }
  return lane * F + i;
}

template <int N> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };
template <> struct Raw<1> { using type = uint8_t; };

// A lane's D/32 features of a pool row in shared memory, as floats (a
// quantized pool's integer values, unscaled), in lane_feature's order.
template <typename T, int D, int Quant>
__device__ __forceinline__ void lane_row(const unsigned char* row, int lane,
                                         float (&x)[D / 32]) {
  constexpr int LB = PoolRow<T, D, Quant>::kLaneBytes;
  using R = typename Raw<LB>::type;
  const R raw = *reinterpret_cast<const R*>(row + lane * LB);
  if constexpr (Quant == kFloatPool) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) x[i] = to_float<T>(e[i]);
  } else {
    // at most 4 bytes: byte i sign-extended from the word
    static_assert(LB <= 4, "a lane reads at most a word of int8 / int4");
    const uint32_t w = (uint32_t)raw;
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int v = (int)(int8_t)(w >> (8 * i));
      if constexpr (Quant == kInt8Pool) {
        x[i] = (float)v;
      } else {
        x[i] = (float)(((v & 15) ^ 8) - 8);
        x[LB + i] = (float)(v >> 4);
      }
    }
  }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// One CTA per (partition s, kv head g, sequence b): the partition's
// (m, l, acc) for the G query rows of head g into the workspace, or, when
// the grid has one partition, the output rows themselves. GM: G rounded up
// to 2 or 8 (the rows a lane keeps in registers).
template <typename T, int D, int Quant, int GM>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const char* __restrict__ pool,
                          const float* __restrict__ scales,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ seq_lens,
                          T* __restrict__ out, float* __restrict__ ws_acc,
                          float* __restrict__ ws_ml, int H, int H_kv, int BS,
                          int MAXB, int W, int P) {
  using Row = PoolRow<T, D, Quant>;
  constexpr int RB = Row::kBytes, TOK = Row::kTok, NS = Row::kStages;
  constexpr int KV = Row::kKV, STAGE = Row::kStageBytes;
  constexpr int F = D / 32, CH = TOK / kDecodeWarps, CPR = RB / 16;
  constexpr int SCRATCH = kDecodeWarps * GM * (D + 2) * (int)sizeof(float);
  constexpr int SMEM = NS * STAGE > SCRATCH ? NS * STAGE : SCRATCH;
  static_assert(RB % 32 == 0 && CH * kDecodeWarps == TOK, "row layout");
  __shared__ __align__(16) unsigned char smem[SMEM];
  __shared__ int tab[kMaxTable];

  constexpr int ENT = kMaxTable / kDecodeThreads;
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / H_kv;
  const size_t row0 = (size_t)b * H + (size_t)g * G;   // first q / out row

  // The partition's table entries and q rows are loaded before the length
  // is known, so the three loads overlap. A partition spans P / BS entries
  // from s * P / BS (past MAXB: none).
  const int nent = P / BS, e0 = s * nent;
  const int* table = block_tables + (size_t)b * MAXB + e0;
  int ent[ENT];
#pragma unroll
  for (int k = 0; k < ENT; ++k) {
    const int i = tid + k * kDecodeThreads;
    ent[k] = i < nent && e0 + i < MAXB ? table[i] : 0;
  }
  // q rows of head g, scaled in fp32 and rounded to q's dtype
  const float qscale = (float)(1.0 / sqrt((double)D));
  float qr[GM][F];
#pragma unroll
  for (int gg = 0; gg < GM; ++gg)
#pragma unroll
    for (int i = 0; i < F; ++i)
      qr[gg][i] = gg < G ? to_float<T>(q[(row0 + gg) * D +
                                         lane_feature<D, Quant>(lane, i)])
                         : 0.f;

  const int maxlen = MAXB * BS;
  int n = seq_lens[b];
  n = n < 0 ? 0 : (n > maxlen ? maxlen : n);
  const TokenRange r = split_range(s, P, n);
  if (r.lo >= r.hi) {
    if (S == 1)   // the output is this CTA's to write: a dead lane is 0
      for (int i = tid; i < G * D; i += kDecodeThreads)
        out[row0 * D + i] = from_float<T>(0.f);
    return;
  }
#pragma unroll
  for (int k = 0; k < ENT; ++k) {
    const int i = tid + k * kDecodeThreads;
    if (i < nent) tab[i] = ent[k] < 0 ? 0 : ent[k];   // -1 reads block 0
  }
#pragma unroll
  for (int gg = 0; gg < GM; ++gg)
#pragma unroll
    for (int i = 0; i < F; ++i)
      qr[gg][i] = to_float<T>(from_float<T>(qr[gg][i] * qscale));
  __syncthreads();   // tab is written

  const size_t row_bytes = (size_t)W * (Quant == kFloatPool ? sizeof(T) : 1);
  const int ntiles = (r.hi - r.lo + TOK - 1) / TOK;
  // tile `tile` of the partition into its ring stage: K rows, V rows, then
  // a quantized pool's K and V row scales; tokens past r.hi are zero-filled
  auto load_tile = [&](int tile) {
    unsigned char* st = smem + (tile % NS) * STAGE;
    const int t0 = r.lo + tile * TOK;
    // a thread copies chunk tid % CPR of its tokens' K row and V row
    for (int t = tid / CPR; t < TOK; t += kDecodeThreads / CPR) {
      const int tok = t0 + t;
      const bool live = tok < r.hi;
      const int j = (live ? tok : r.lo) - r.lo;   // inside the partition
      const char* src = pool +
                        ((size_t)tab[j / BS] * 2 * BS + j % BS) * row_bytes +
                        (size_t)g * RB + (tid % CPR) * 16;
      const uint32_t dst = tc::smem_addr(st + t * RB + (tid % CPR) * 16);
      tc::cp_async16(dst, src, live ? 16 : 0);                       // K
      tc::cp_async16(dst + KV, src + (size_t)BS * row_bytes,          // V
                     live ? 16 : 0);
    }
    if constexpr (Quant != kFloatPool) {
      float* sc = reinterpret_cast<float*>(st + 2 * KV);   // [2][TOK]
      for (int c = tid; c < 2 * TOK; c += kDecodeThreads) {
        const int kv = c / TOK, tok = t0 + c % TOK;
        const bool live = tok < r.hi;
        const int tk = live ? tok : r.lo;
        const int blk = tab[(tk - r.lo) / BS];
        const size_t i =
            Quant == kInt8Pool
                ? ((size_t)blk * 2 + kv) * BS + tk % BS    // [NB, 2, BS]
                : (((size_t)blk * 2 + kv) * H_kv + g) * BS +
                      tk % BS;                              // [NB, 2, H_kv, BS]
        cp_async4(tc::smem_addr(sc + c), scales + i, live ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < ntiles) load_tile(i);
    tc::cp_async_commit();
  }

  float m[GM], l[GM], acc[GM][F];
#pragma unroll
  for (int gg = 0; gg < GM; ++gg) {
    m[gg] = kMaxFloor;
    l[gg] = 0.f;
#pragma unroll
    for (int i = 0; i < F; ++i) acc[gg][i] = 0.f;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + NS - 1 < ntiles) load_tile(tile + NS - 1);
    tc::cp_async_commit();
    tc::cp_async_wait<NS - 1>();
    __syncthreads();
    const unsigned char* st = smem + (tile % NS) * STAGE;
    const int t0 = r.lo + tile * TOK + warp * CH;   // this warp's tokens
    if (t0 < r.hi) {
      const unsigned char* kt = st + warp * CH * RB;
      const unsigned char* vt = kt + KV;
      const float* ksc = reinterpret_cast<const float*>(st + 2 * KV) +
                         warp * CH;
      const float* vsc = ksc + TOK;
      float sc[GM][CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        float x[F];
        lane_row<T, D, Quant>(kt + j * RB, lane, x);
#pragma unroll
        for (int gg = 0; gg < GM; ++gg) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < F; ++i) d = fmaf(qr[gg][i], x[i], d);
          sc[gg][j] = d;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int gg = 0; gg < GM; ++gg)
#pragma unroll
          for (int j = 0; j < CH; ++j)
            sc[gg][j] += __shfl_xor_sync(0xffffffffu, sc[gg][j], off);
#pragma unroll
      for (int gg = 0; gg < GM; ++gg) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          float v = sc[gg][j];
          if (Quant != kFloatPool) v *= ksc[j];
          v = t0 + j < r.hi ? v : -INFINITY;
          sc[gg][j] = v;
          mx = fmaxf(mx, v);
        }
        const float m_new = fmaxf(fmaxf(m[gg], mx), kMaxFloor);
        const float alpha = tc::ex2((m[gg] - m_new) * tc::kLog2e);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const float p = tc::ex2((sc[gg][j] - m_new) * tc::kLog2e);
          sum += p;
          // l takes the unscaled p; the value sum takes p times v's scale
          sc[gg][j] = Quant == kFloatPool ? p : p * vsc[j];
        }
        l[gg] = fmaf(alpha, l[gg], sum);
        m[gg] = m_new;
#pragma unroll
        for (int i = 0; i < F; ++i) acc[gg][i] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        float x[F];
        lane_row<T, D, Quant>(vt + j * RB, lane, x);
#pragma unroll
        for (int gg = 0; gg < GM; ++gg)
#pragma unroll
          for (int i = 0; i < F; ++i)
            acc[gg][i] = fmaf(sc[gg][j], x[i], acc[gg][i]);
      }
    }
    __syncthreads();   // the stage is consumed before it is refilled
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // the four warps' (m, l, acc) through the idle ring, then combined
  float* wml = reinterpret_cast<float*>(smem);        // [warps][GM][2]
  float* wacc = wml + kDecodeWarps * GM * 2;          // [warps][GM][D]
#pragma unroll
  for (int gg = 0; gg < GM; ++gg) {
    if (lane == 0) {
      wml[(warp * GM + gg) * 2] = m[gg];
      wml[(warp * GM + gg) * 2 + 1] = l[gg];
    }
#pragma unroll
    for (int i = 0; i < F; ++i)
      wacc[(warp * GM + gg) * D + lane_feature<D, Quant>(lane, i)] =
          acc[gg][i];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kDecodeThreads) {
    const int gg = idx / D, d = idx % D;
    float M = kMaxFloor;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w)
      M = fmaxf(M, wml[(w * GM + gg) * 2]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float e = expf(wml[(w * GM + gg) * 2] - M);
      L = fmaf(e, wml[(w * GM + gg) * 2 + 1], L);
      A = fmaf(e, wacc[(w * GM + gg) * D + d], A);
    }
    if (S == 1) {
      out[(row0 + gg) * D + d] = from_float<T>(A / (L == 0.f ? 1.f : L));
    } else {
      const size_t o = (row0 + gg) * S + s;   // [B, H, S]
      ws_acc[o * D + d] = A;
      if (d == 0) {
        ws_ml[o * 2] = M;
        ws_ml[o * 2 + 1] = L;
      }
    }
  }
}

// A warp per (sequence, head): out = sum_s e^(m_s - M) acc_s / L with
// M = max_s m_s and L = sum_s e^(m_s - M) l_s over the live partitions in
// split order (L = 0, a dead lane, gives 0).
template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_combine_kernel(const float* __restrict__ ws_acc,
                            const float* __restrict__ ws_ml,
                            const int* __restrict__ seq_lens,
                            T* __restrict__ out, int B, int H, int maxlen,
                            int P, int S) {
  constexpr int F = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kDecodeWarps + warp;   // b * H + h
  if (row >= B * H) return;
  int n = seq_lens[row / H];
  n = n < 0 ? 0 : (n > maxlen ? maxlen : n);
  const float* ml = ws_ml + (size_t)row * S * 2;
  const float* ac = ws_acc + (size_t)row * S * D;
  // M: lane s reads m_s of splits s, s + 32, ...
  float M = kMaxFloor;
  for (int s = lane; s < S; s += 32) {
    const TokenRange r = split_range(s, P, n);
    if (r.lo < r.hi) M = fmaxf(M, ml[s * 2]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float L = 0.f, a[F];
#pragma unroll
  for (int i = 0; i < F; ++i) a[i] = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    // lane j weighs split s0 + j; the value sums take the splits in order
    const int s = s0 + lane;
    float w = 0.f;
    bool live = false;
    if (s < S) {
      const TokenRange r = split_range(s, P, n);
      live = r.lo < r.hi;
      if (live) {
        const float2 v = *reinterpret_cast<const float2*>(ml + s * 2);
        w = expf(v.x - M);
        L = fmaf(w, v.y, L);
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    const int cnt = min(32, S - s0);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const bool lj = (mask >> j) & 1u;   // a dead split's slot is unset
#pragma unroll
      for (int i = 0; i < F; ++i) {
        const float x = ac[(size_t)(s0 + j) * D + lane + 32 * i];
        a[i] = lj ? fmaf(wj, x, a[i]) : a[i];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    L += __shfl_xor_sync(0xffffffffu, L, off);
  const float den = L == 0.f ? 1.f : L;
#pragma unroll
  for (int i = 0; i < F; ++i)
    out[(size_t)row * D + lane + 32 * i] = from_float<T>(a[i] / den);
}

struct DecodeArgs {
  const void* q;
  const char* pool;
  const float* scales;
  const int* tables;
  const int* lens;
  void* out;
  float* ws_acc;
  float* ws_ml;
  int B, H, H_kv, BS, MAXB, W, P, S;
};

template <typename T, int D, int Quant, int GM>
static cudaError_t launch_pair(const DecodeArgs& a, cudaStream_t st) {
  const dim3 grid(a.S, a.H_kv, a.B);
  paged_decode_split_kernel<T, D, Quant, GM><<<grid, kDecodeThreads, 0, st>>>(
      (const T*)a.q, a.pool, a.scales, a.tables, a.lens, (T*)a.out, a.ws_acc,
      a.ws_ml, a.H, a.H_kv, a.BS, a.MAXB, a.W, a.P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return err;
  const int rows = a.B * a.H;
  paged_decode_combine_kernel<T, D>
      <<<(rows + kDecodeWarps - 1) / kDecodeWarps, kDecodeThreads, 0, st>>>(
          a.ws_acc, a.ws_ml, a.lens, (T*)a.out, a.B, a.H, a.MAXB * a.BS, a.P,
          a.S);
  return cudaGetLastError();
}

template <typename T, int D, int Quant>
static cudaError_t launch_group(const DecodeArgs& a, cudaStream_t st) {
  return a.H / a.H_kv <= 2 ? launch_pair<T, D, Quant, 2>(a, st)
                           : launch_pair<T, D, Quant, kMaxGroup>(a, st);
}

template <typename T, int Quant>
static cudaError_t launch_dim(int D, const DecodeArgs& a, cudaStream_t st) {
  return D == 64 ? launch_group<T, 64, Quant>(a, st)
                 : launch_group<T, 128, Quant>(a, st);
}

template <typename T>
static cudaError_t launch_quant(int quant, int D, const DecodeArgs& a,
                                cudaStream_t st) {
  if (quant == kInt8Pool) return launch_dim<T, kInt8Pool>(D, a, st);
  if (quant == kInt4Pool) return launch_dim<T, kInt4Pool>(D, a, st);
  return launch_dim<T, kFloatPool>(D, a, st);
}

}  // namespace vyomai

// W: the pool row's stored width in elements (H_kv*D; H_kv*D/2 bytes for
// int4). quant: 0 float pool of q's dtype, 1 int8, 2 int4 (scales needed).
// P, S: the plan's partition (tokens, a multiple of BS spanning at most
// 256 blocks) and split count (S * P >= MAXB * BS). ws_acc [B, H, S, D] and
// ws_ml [B, H, S, 2] fp32: the workspace (unused when S == 1).
extern "C" int paged_decode_launch(const void* q, const void* pool,
                                   const void* scales,
                                   const void* block_tables,
                                   const void* seq_lens, void* out,
                                   void* ws_acc, void* ws_ml, int B, int H,
                                   int H_kv, int D, int BS, int MAXB, int W,
                                   int quant, int is_bf16, int P, int S,
                                   void* stream) {
  using namespace vyomai;
  if ((D != 64 && D != 128) || H % H_kv || H / H_kv > kMaxGroup ||
      quant < 0 || quant > 2 || (quant && scales == nullptr) || BS < 1 ||
      P < BS || P % BS || P / BS > kMaxTable || S < 1 ||
      (long long)S * P < (long long)MAXB * BS || B > 65535 || H_kv > 65535 ||
      (S > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q,
                     (const char*)pool,
                     (const float*)scales,
                     (const int*)block_tables,
                     (const int*)seq_lens,
                     out,
                     (float*)ws_acc,
                     (float*)ws_ml,
                     B, H, H_kv, BS, MAXB, W, P, S};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_quant<__nv_bfloat16>(quant, D, a, st)
                       : launch_quant<float>(quant, D, a, st));
}

extern "C" const char* vyomai_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

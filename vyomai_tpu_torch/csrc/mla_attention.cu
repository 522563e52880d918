// K13: multi-head latent attention (MLA) over the paged latent pool for
// Hopper (sm_90a), bf16, on the tensor cores: a split-context decode pair
// (`k13_decode_split_kernel`, `k13_decode_combine_kernel`) and a prefill
// kernel (`k13_prefill_kernel`).
//
// Replaces no TPU kernel: the JAX package has no MLA. No other kernel of
// the port computes this attention. MLA's absorbed form scores each head's
// query of C + R = 512 + 64 dims against one row a token that every head
// shares (the latent c_kv and the rotary k_pe), and sums the rows' first C
// dims; K1 and K4 read per-head K and V rows of one width, 64 or 128.
//
// What bounds it on the H100. Decode reads every live latent row of every
// lane, 1,152 bytes, for 2 * 16 * (576 + 512) FLOPs: 30 FLOPs a byte, far
// under the ridge (~295), so it is bytes. Prefill scores each cached row
// against every query of the suffix (16 heads a token): FLOPs.
//
// What the design does about it. A CTA holds its query rows in shared
// memory and streams tiles of latent rows straight from the pool through
// the block table (no gather into a copy): cp.async 16-byte copies into a
// double-buffered ring, a warp copying whole rows (one table entry a row,
// 512 contiguous bytes an instruction), chunks XOR-swizzled on the row as
// in tc_common.cuh, so each row is read once for all the query rows of
// the CTA. Both products run on mma.sync m16n8k16 (bf16 in, fp32
// accumulate), operands through ldmatrix. A row of the output is 512 fp32
// values, too many for one warp to keep, so each warp accumulates a
// quarter (decode) or half (prefill) of the output columns of its rows,
// and the warps share the scores:
// - decode (128 threads, 32-row tiles, two CTAs an SM): the 16 heads of
//   one lane are the query rows. Warp w keeps the query's A fragments of
//   dims [144 w, 144 w + 144) in registers and scores every key of a tile
//   over them; the four partial scores meet in shared memory and each
//   warp adds them in the same order, so all four run one online softmax
//   and keep P in registers as the A fragments of P.c_kv. Two barriers a
//   tile. Each lane's context is cut into partitions planned on the host
//   from shapes alone (ops/mla_attention.py `decode_plan`, so a CUDA graph
//   captures the launch), one CTA a (lane, partition); the CTA writes (m,
//   l, unnormalised acc) in fp32 and the combine kernel merges the
//   partitions in a fixed order, or with one partition the split kernel
//   writes the output itself;
// - prefill (256 threads, 64-row tiles, one CTA an SM): 64 (token, head)
//   query rows of one row of the call, 4 tokens, against its context up
//   to the last of their positions, each query row masked causally at its
//   own position. Warp (rg, cg) scores its 16 query rows against half the
//   tile's keys over all 576 dims; the halves' row maxima meet in shared
//   memory so both keep one running max, and each rounds its
//   probabilities to bf16 into a shared [64][64] tile that both read as
//   the A fragments of P.c_kv. Three barriers a tile.
//
// Shared memory: decode 18,432 bytes of queries + 2 x 32 x 576 bf16 + the
// partial scores (102,400 bytes); prefill 73,728 + 2 x 64 x 576 bf16 + P +
// maxima (229,888 bytes).
//
// Arithmetic: scores fp32, times the softmax scale in base 2 (exp2 on the
// SFU); the running max starts at -inf and a row that sees no key gives 0;
// P rounded to bf16 for P.c_kv, the row sum over the fp32 p; the output
// divided by the sum and rounded once to bf16.

#include <climits>

#include "tc_common.cuh"

namespace vyomai {
namespace mla {

using tc::bf16;

constexpr int kC = 512;             // latent dims (kv_lora_rank)
constexpr int kW = kC + 64;         // a pool row: latent + rotary dims
constexpr int kHeads = 16;          // query heads sharing each row
constexpr int kBN = 64;             // latent rows a prefill tile
constexpr int kCPR = kW / 8;        // 16-byte chunks of a row (72)
constexpr int kKC = kW / 16;        // 16-deep chunks of the score (36)

// A prefill CTA: RG x CG warps, warp (rg, cg) over query rows [16 rg, 16 rg
// + 16), keys [cg * 64 / CG, ...) of a tile and output columns [cg * 512 /
// CG, ...).
template <int RG, int CG>
struct Shape {
  static constexpr int kThreads = 32 * RG * CG;
  static constexpr int kBM = 16 * RG;     // query rows of a CTA
  static constexpr int kKW = kBN / CG;    // keys a warp scores
  static constexpr int kNT = kKW / 8;     // its 8-key n-tiles
  static constexpr int kCW = kC / CG;     // output columns a warp owns
  static constexpr int kON = kCW / 8;     // its 8-column n-tiles
  static constexpr size_t kQBytes = (size_t)kBM * kW * sizeof(bf16);
  static constexpr size_t kStage = (size_t)kBN * kW * sizeof(bf16);
  static constexpr size_t kPBytes = (size_t)kBM * kBN * sizeof(bf16);
  static constexpr size_t kSmem =
      kQBytes + 2 * kStage + kPBytes + (size_t)CG * kBM * sizeof(float);
  static_assert(kNT % 2 == 0 && kON % 2 == 0, "pairs of n-tiles");
};

// What a thread holds of its warp's 16 rows (g = lane / 4 and g + 8) and
// columns: the C fragments of the output, the running max (base 2) and,
// after attend(), the row's whole sum.
template <int RG, int CG>
struct State {
  float o[Shape<RG, CG>::kON][4];
  float m[2];
  float l[2];
};

// Issue the copies of query rows [0, 64 or 16) of `q` (rows of kW, row
// `rows` and after zero-filled) into a swizzled tile.
template <int NT, int BM>
__device__ __forceinline__ void load_queries(const bf16* __restrict__ q,
                                             int rows, uint32_t dst,
                                             int tid) {
#pragma unroll
  for (int it = 0; it < BM * kCPR / NT; ++it) {
    const int i = tid + it * NT, r = i / kCPR, c = i - r * kCPR;
    const bool live = r < rows;
    tc::cp_async16(dst + tc::swz<kW>(r, c) * 16,
                   live ? q + (long long)r * kW + c * 8 : q, live ? 16 : 0);
  }
}

// Issue the copies of a lane's latent rows [j0, j0 + BN) through its block
// table `tab` (blocks of 1 << bs_shift rows; -1 reads block 0) into a
// swizzled stage; rows at or past `kend` are zero-filled. Each warp copies
// whole rows, one table entry a row, its lanes 16-byte chunks c, c + 32 and
// c + 64 (< 72), so each copy instruction reads 512 contiguous bytes.
template <int NT, int BN>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ pool,
                                          const int* __restrict__ tab,
                                          int bs_shift, int j0, int kend,
                                          uint32_t dst, int tid) {
  constexpr int kRows = BN / (NT / 32);   // rows a warp copies
  const int warp = tid >> 5, lane = tid & 31;
  const int in_block = (1 << bs_shift) - 1;
#pragma unroll 4
  for (int k = 0; k < kRows; ++k) {
    const int r = warp * kRows + k, j = j0 + r;
    const bool live = j < kend;
    const bf16* row = pool;
    if (live) {
      const int blk = max(__ldg(tab + (j >> bs_shift)), 0);
      row = pool + ((((long long)blk) << bs_shift) + (j & in_block)) * kW;
    }
#pragma unroll
    for (int c = lane; c < kCPR; c += 32)
      tc::cp_async16(dst + tc::swz<kW>(r, c) * 16, live ? row + c * 8 : pool,
                     live ? 16 : 0);
  }
}

// The CTA's query rows (`q`, `q_rows` of them live) against a lane's latent
// rows [j0, kend): key j counts for this thread's row i when j <= lim[i].
// Ends with every copy landed, the row sums whole in st.l, and a barrier.
template <int RG, int CG>
__device__ __forceinline__ void attend(const bf16* __restrict__ q, int q_rows,
                                       const bf16* __restrict__ pool,
                                       const int* __restrict__ tab,
                                       int bs_shift, int j0, int kend,
                                       const int lim[2], float scale_log2,
                                       char* smem, State<RG, CG>& st) {
  using S = Shape<RG, CG>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp % RG, cg = warp / RG, wrow = 16 * rg;
  const uint32_t sq = tc::smem_addr(smem);
  const uint32_t skv = sq + (uint32_t)S::kQBytes;
  char* sp = smem + S::kQBytes + 2 * S::kStage;
  const uint32_t spa = tc::smem_addr(sp);
  float* red = reinterpret_cast<float*>(sp + S::kPBytes);   // [CG][BM]

  load_queries<S::kThreads, S::kBM>(q, q_rows, sq, tid);
  const int nk = kend > j0 ? (kend - j0 + kBN - 1) / kBN : 0;
  if (nk > 0)
    load_rows<S::kThreads, kBN>(pool, tab, bs_shift, j0, kend, skv, tid);
  tc::cp_async_commit();

#pragma unroll
  for (int j = 0; j < S::kON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int n0 = j0 + kt * kBN;
    const uint32_t stage = skv + (uint32_t)((kt & 1) * S::kStage);
    tc::cp_async_wait<0>();   // tile kt (and the queries) landed
    __syncthreads();          // and every warp is done with tile kt - 1
    if (kt + 1 < nk)
      load_rows<S::kThreads, kBN>(pool, tab, bs_shift, n0 + kBN, kend,
                             skv + (uint32_t)(((kt + 1) & 1) * S::kStage),
                             tid);
    tc::cp_async_commit();

    // scores of the warp's rows against its keys
    float s[S::kNT][4];
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < kKC; ++kc) {
      uint32_t a[4];
      tc::ldsm_x4(sq + tc::swz<kW>(wrow + (lane & 15), kc * 2 + (lane >> 4)) *
                           16,
                  a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int np = 0; np < S::kNT / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        tc::ldsm_x4(stage + tc::swz<kW>(cg * S::kKW + np * 16 + (lane & 7) +
                                            ((lane >> 4) << 3),
                                        kc * 2 + ((lane >> 3) & 1)) *
                                16,
                    b0, b1, b2, b3);
        tc::mma_bf16(s[2 * np], a, b0, b1);
        tc::mma_bf16(s[2 * np + 1], a, b2, b3);
      }
    }

    // scale, mask, the warp's row maxima into shared memory
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // element e: row g + 8 (e / 2), key key0 + e % 2
        const int key = n0 + cg * S::kKW + 8 * j + 2 * t4 + (e & 1);
        const bool ok = key < kend && key <= lim[e >> 1];
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if (t4 == 0) {
      red[cg * S::kBM + wrow + g] = mx[0];
      red[cg * S::kBM + wrow + g + 8] = mx[1];
    }
    __syncthreads();

    // the row group's running max, rescale, P into shared memory
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m_new = st.m[i];
#pragma unroll
      for (int c = 0; c < CG; ++c)
        m_new = fmaxf(m_new, red[c * S::kBM + wrow + g + 8 * i]);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = tc::ex2(st.m[i] - m_use[i]);
      st.m[i] = m_new;
      st.l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < S::kON; ++j) {
        st.o[j][2 * i] *= alpha;
        st.o[j][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < S::kNT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = tc::ex2(s[j][e] - m_use[e >> 1]);
        st.l[e >> 1] += p[e];
      }
      const int chunk = cg * S::kNT + j;
      *reinterpret_cast<uint32_t*>(sp + tc::swz<kBN>(wrow + g, chunk) * 16 +
                                   t4 * 4) = tc::pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(sp + tc::swz<kBN>(wrow + g + 8, chunk) *
                                            16 +
                                   t4 * 4) = tc::pack_bf16(p[2], p[3]);
    }
    __syncthreads();

    // O += P c_kv over the warp's columns
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      tc::ldsm_x4(spa + tc::swz<kBN>(wrow + (lane & 15), kk * 2 + (lane >> 4)) *
                            16,
                  pa[0], pa[1], pa[2], pa[3]);
#pragma unroll
      for (int dp = 0; dp < S::kON / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        tc::ldsm_x4_trans(
            stage + tc::swz<kW>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                cg * (S::kCW / 8) + dp * 2 + (lane >> 4)) *
                        16,
            b0, b1, b2, b3);
        tc::mma_bf16(st.o[2 * dp], pa, b0, b1);
        tc::mma_bf16(st.o[2 * dp + 1], pa, b2, b3);
      }
    }
  }
  tc::cp_async_wait<0>();

  // whole row sums: the 4 lanes of a row, then the CG warps of its group
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 1);
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 2);
  }
  __syncthreads();
  if (t4 == 0) {
    red[cg * S::kBM + wrow + g] = st.l[0];
    red[cg * S::kBM + wrow + g + 8] = st.l[1];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c) l += red[c * S::kBM + wrow + g + 8 * i];
    st.l[i] = l;
  }
}

using Prefill = Shape<4, 2>;

// The decode CTA: 4 warps over the 16 heads of one lane, tiles of 32 rows
// (timed 1.27x faster than 64 at a served step: two CTAs an SM). Warp w
// keeps the A fragments of query dims [144 w, 144 w + 144) (9 of the 36
// k-chunks) in registers and scores all 32 keys of a tile over them: 4
// independent mma chains of 9. The four partial scores meet in shared
// memory, and every warp adds them in the same order, so all four run the
// same online softmax; P stays in registers as the A fragments of P.c_kv,
// and warp w accumulates output columns [128 w, 128 w + 128). Two barriers
// a tile: landed, partial scores.
struct DecodeShape {
  static constexpr int kThreads = 128;
  static constexpr int kBN = 32;          // latent rows a tile
  static constexpr int kKCW = kKC / 4;    // k-chunks a warp scores (9)
  static constexpr int kNT = kBN / 8;     // 8-key n-tiles of a tile
  static constexpr int kPS = kBN + 8;     // partial scores' row stride
  static constexpr int kON = kC / 4 / 8;  // a warp's 8-column n-tiles (16)
  static constexpr size_t kQBytes = (size_t)kHeads * kW * sizeof(bf16);
  static constexpr size_t kStage = (size_t)kBN * kW * sizeof(bf16);
  static constexpr size_t kSmem =
      kQBytes + 2 * kStage + (size_t)4 * kHeads * kPS * sizeof(float);
};

// One CTA a (lane, partition): rows [sp * chunk, min((sp + 1) * chunk,
// len)) of lane b. With one partition it writes out [B, 16, 512] itself;
// else (m, l) to ws_ml [B, S, 16, 2] and the unnormalised sums to ws_acc
// [B, S, 16, 512], fp32 (an empty partition writes m = -inf, l = 0 only).
__global__ void __launch_bounds__(DecodeShape::kThreads, 2)
    k13_decode_split_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ pool,
                            const int* __restrict__ tables,
                            const int* __restrict__ lens,
                            bf16* __restrict__ out, float* __restrict__ ws_acc,
                            float* __restrict__ ws_ml, float scale_log2,
                            int maxb, int bs_shift, int chunk, int splits) {
  using S = DecodeShape;
  constexpr int BN = S::kBN;
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.x, sp = blockIdx.y;
  const int n_len = min(lens[b], maxb << bs_shift);
  const int start = sp * chunk, end = min(start + chunk, n_len);
  const long long part = (long long)b * splits + sp;
  if (splits > 1 && start >= end) {
    if (threadIdx.x < kHeads) {
      ws_ml[(part * kHeads + threadIdx.x) * 2] = -INFINITY;
      ws_ml[(part * kHeads + threadIdx.x) * 2 + 1] = 0.f;
    }
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t sq = tc::smem_addr(smem);
  const uint32_t skv = sq + (uint32_t)S::kQBytes;
  float* scores = reinterpret_cast<float*>(smem + S::kQBytes + 2 * S::kStage);
  const int* tab = tables + (long long)b * maxb;

  load_queries<S::kThreads, kHeads>(q + (long long)b * kHeads * kW, kHeads,
                                    sq, tid);
  const int nk = end > start ? (end - start + BN - 1) / BN : 0;
  if (nk > 0)
    load_rows<S::kThreads, BN>(pool, tab, bs_shift, start, end, skv, tid);
  tc::cp_async_commit();

  float o[S::kON][4];
#pragma unroll
  for (int j = 0; j < S::kON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[S::kKCW][4];
  const int kc0 = warp * S::kKCW;

  for (int kt = 0; kt < nk; ++kt) {
    const int n0 = start + kt * BN;
    const uint32_t stage = skv + (uint32_t)((kt & 1) * S::kStage);
    tc::cp_async_wait<0>();   // tile kt (and the queries) landed
    __syncthreads();          // and every warp is done with tile kt - 1
    if (kt + 1 < nk)
      load_rows<S::kThreads, BN>(
          pool, tab, bs_shift, n0 + BN, end,
          skv + (uint32_t)(((kt + 1) & 1) * S::kStage), tid);
    tc::cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int kc = 0; kc < S::kKCW; ++kc)
        tc::ldsm_x4(sq + tc::swz<kW>(lane & 15, (kc0 + kc) * 2 +
                                                    (lane >> 4)) *
                             16,
                    qf[kc][0], qf[kc][1], qf[kc][2], qf[kc][3]);
    }

    // the warp's partial scores of every key, into shared memory
    float s[S::kNT][4];
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < S::kKCW; ++kc)
#pragma unroll
      for (int np = 0; np < S::kNT / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        tc::ldsm_x4(stage + tc::swz<kW>(np * 16 + (lane & 7) +
                                            ((lane >> 4) << 3),
                                        (kc0 + kc) * 2 + ((lane >> 3) & 1)) *
                                16,
                    b0, b1, b2, b3);
        tc::mma_bf16(s[2 * np], qf[kc], b0, b1);
        tc::mma_bf16(s[2 * np + 1], qf[kc], b2, b3);
      }
    float* mine = scores + warp * kHeads * S::kPS;
#pragma unroll
    for (int j = 0; j < S::kNT; ++j) {
      *reinterpret_cast<float2*>(mine + g * S::kPS + 8 * j + 2 * t4) =
          make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * S::kPS + 8 * j + 2 * t4) =
          make_float2(s[j][2], s[j][3]);
    }
    __syncthreads();

    // whole scores, scaled and masked; the online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* at = scores + (g + 8 * i) * S::kPS + 8 * j + 2 * t4;
        float2 v = *reinterpret_cast<const float2*>(at);
#pragma unroll
        for (int w = 1; w < 4; ++w) {
          const float2 u =
              *reinterpret_cast<const float2*>(at + w * kHeads * S::kPS);
          v.x += u.x;
          v.y += u.y;
        }
        const int key = n0 + 8 * j + 2 * t4;
        s[j][2 * i] = key < end ? v.x * scale_log2 : -INFINITY;
        s[j][2 * i + 1] = key + 1 < end ? v.y * scale_log2 : -INFINITY;
        mx[i] = fmaxf(mx[i], fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      }
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = tc::ex2(m[i] - m_use[i]);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < S::kON; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = tc::ex2(s[j][e] - m_use[e >> 1]);
        l[e >> 1] += s[j][e];
      }

    // O += P c_kv over the warp's columns, P's C fragments as A fragments
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {
          tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < S::kON / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        tc::ldsm_x4_trans(
            stage + tc::swz<kW>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                warp * (S::kON) + dp * 2 + (lane >> 4)) *
                        16,
            b0, b1, b2, b3);
        tc::mma_bf16(o[2 * dp], pa, b0, b1);
        tc::mma_bf16(o[2 * dp + 1], pa, b2, b3);
      }
    }
  }
  tc::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  const int col0 = warp * (kC / 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int h = g + 8 * i;
    if (splits == 1) {
      const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
      bf16* row = out + ((long long)b * kHeads + h) * kC + col0;
#pragma unroll
      for (int j = 0; j < S::kON; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
            tc::pack_bf16(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    } else {
      float* row = ws_acc + (part * kHeads + h) * kC + col0;
#pragma unroll
      for (int j = 0; j < S::kON; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + 2 * t4) =
            make_float2(o[j][2 * i], o[j][2 * i + 1]);
      if (warp == 0 && t4 == 0) {
        ws_ml[(part * kHeads + h) * 2] = m[i];
        ws_ml[(part * kHeads + h) * 2 + 1] = l[i];
      }
    }
  }
}

// One CTA a (lane, head): the partitions' sums weighted by 2^(m - max),
// in partition order, over the weighted row sums; 4 columns a thread.
__global__ void __launch_bounds__(kC / 4)
    k13_decode_combine_kernel(const float* __restrict__ ws_acc,
                              const float* __restrict__ ws_ml,
                              bf16* __restrict__ out, int splits) {
  const long long row = blockIdx.x;   // lane * 16 + head
  const long long b = row / kHeads, h = row % kHeads;
  const int col = 4 * threadIdx.x;
  float big = -INFINITY;
  for (int s = 0; s < splits; ++s)
    big = fmaxf(big, ws_ml[((b * splits + s) * kHeads + h) * 2]);
  float den = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const long long at = (b * splits + s) * kHeads + h;
    const float m = ws_ml[at * 2];
    if (m == -INFINITY) continue;
    const float w = tc::ex2(m - big);
    den += w * ws_ml[at * 2 + 1];
    const float4 a = *reinterpret_cast<const float4*>(ws_acc + at * kC + col);
    acc[0] += w * a.x;
    acc[1] += w * a.y;
    acc[2] += w * a.z;
    acc[3] += w * a.w;
  }
  const float inv = 1.f / (den == 0.f ? 1.f : den);
  uint2 v;
  v.x = tc::pack_bf16(acc[0] * inv, acc[1] * inv);
  v.y = tc::pack_bf16(acc[2] * inv, acc[3] * inv);
  *reinterpret_cast<uint2*>(out + row * kC + col) = v;
}

// One CTA a (row n of the call, 64 query rows = 4 tokens x 16 heads):
// query row t * 16 + h of row n attends latent rows j <= pos[n, t] with j
// < ctx_len[n], for t < true_len[n]; other rows give 0.
__global__ void __launch_bounds__(Prefill::kThreads, 1)
    k13_prefill_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ pool,
                       const int* __restrict__ tables,
                       const long long* __restrict__ pos,
                       const long long* __restrict__ ctx_len,
                       const long long* __restrict__ true_len,
                       bf16* __restrict__ out, float scale_log2, int T,
                       int maxb, int bs_shift) {
  extern __shared__ __align__(128) char smem[];
  const int n = blockIdx.x, row0 = blockIdx.y * Prefill::kBM;
  const int rows = T * kHeads;
  const long long live_t = min(true_len[n], (long long)T);
  const int ctx = (int)min(ctx_len[n], (long long)maxb << bs_shift);
  const long long* p = pos + (long long)n * T;
  int last = -1;   // the last position of the CTA's live tokens
#pragma unroll
  for (int k = 0; k < Prefill::kBM / kHeads; ++k) {
    const int t = row0 / kHeads + k;
    if (t < live_t) last = max(last, (int)p[t]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp % 4, cg = warp / 4;
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = (row0 + 16 * rg + g + 8 * i) / kHeads;
    lim[i] = t < live_t ? (int)p[t] : -1;
  }
  State<4, 2> st;
  attend<4, 2>(q + ((long long)n * rows + row0) * kW, rows - row0, pool,
               tables + (long long)n * maxb, bs_shift, 0, min(last + 1, ctx),
               lim, scale_log2, smem, st);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * rg + g + 8 * i;
    if (r >= rows) continue;
    const float inv = 1.f / (st.l[i] == 0.f ? 1.f : st.l[i]);
    bf16* dst = out + ((long long)n * rows + r) * kC + cg * Prefill::kCW;
#pragma unroll
    for (int j = 0; j < Prefill::kON; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) =
          tc::pack_bf16(st.o[j][2 * i] * inv, st.o[j][2 * i + 1] * inv);
  }
}

static int log2_exact(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return (1 << s) == x ? s : -1;
}

}  // namespace mla
}  // namespace vyomai

// q [B, 16, 576], pool [NB, BS, 576], tables [B, MAXB] int32, lens [B]
// int32, out [B, 16, 512]; bf16. chunk, splits: the plan (splits * chunk
// >= MAXB * BS); ws_acc [B, splits, 16, 512] and ws_ml [B, splits, 16, 2]
// fp32, unused with one split. BS a power of 2.
extern "C" int mla_decode_launch(const void* q, const void* pool,
                                 const void* tables, const void* lens,
                                 void* out, void* ws_acc, void* ws_ml, int B,
                                 int MAXB, int BS, float scale_log2,
                                 int chunk, int splits, void* stream) {
  using namespace vyomai::mla;
  const int shift = log2_exact(BS);
  if (shift < 0 || B < 1 || MAXB < 1 || chunk < 1 || splits < 1 ||
      splits > 65535 || (long long)splits * chunk < (long long)MAXB * BS ||
      (long long)MAXB * BS > INT_MAX / 2 ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      k13_decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DecodeShape::kSmem);
  if (err != cudaSuccess) return (int)err;
  k13_decode_split_kernel<<<dim3(B, splits), DecodeShape::kThreads,
                            DecodeShape::kSmem, st>>>(
      (const bf16*)q, (const bf16*)pool, (const int*)tables, (const int*)lens,
      (bf16*)out, (float*)ws_acc, (float*)ws_ml, scale_log2, MAXB, shift,
      chunk, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  k13_decode_combine_kernel<<<B * kHeads, kC / 4, 0, st>>>(
      (const float*)ws_acc, (const float*)ws_ml, (bf16*)out, splits);
  return (int)cudaGetLastError();
}

// q [N, T, 16, 576], pool and tables as above, pos [N, T], ctx_len [N],
// true_len [N] int64, out [N, T, 16, 512]; bf16.
extern "C" int mla_prefill_launch(const void* q, const void* pool,
                                  const void* tables, const void* pos,
                                  const void* ctx_len, const void* true_len,
                                  void* out, int N, int T, int MAXB, int BS,
                                  float scale_log2, void* stream) {
  using namespace vyomai::mla;
  const int shift = log2_exact(BS);
  if (shift < 0 || N < 1 || T < 1 || MAXB < 1 || N > INT_MAX ||
      (long long)T * kHeads > INT_MAX / 2 ||
      (long long)MAXB * BS > INT_MAX / 2 ||
      ((long long)T * kHeads + Prefill::kBM - 1) / Prefill::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      k13_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Prefill::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N, (T * kHeads + Prefill::kBM - 1) / Prefill::kBM);
  k13_prefill_kernel<<<grid, Prefill::kThreads, Prefill::kSmem, st>>>(
      (const bf16*)q, (const bf16*)pool, (const int*)tables,
      (const long long*)pos, (const long long*)ctx_len,
      (const long long*)true_len, (bf16*)out, scale_log2, T, MAXB, shift);
  return (int)cudaGetLastError();
}

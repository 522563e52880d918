// Tensor-core building blocks for Hopper (sm_90a), bf16 inputs, shared by
// the attention forward core (attn_fwd_tc.cuh: K1, K5/K6) and the backward
// core (attn_bwd_tc.cuh: K7): 64-row tiles of [64][D] bf16 in shared memory
// with their 16-byte chunks XOR-swizzled on the row, filled by cp.async
// (a double-buffered ring in each kernel) and read with ldmatrix /
// ldmatrix.trans as the fragments of mma.sync.m16n8k16 (bf16 in, fp32
// accumulate); an fp32 bias tile in the same ring; fp32 C fragments packed
// to bf16 A fragments in registers; the bf16 epilogue through a staged tile.
//
// Fragments (lane = 4 g + t4): an A fragment (16 x 16) holds rows g, g + 8
// at columns 2 t4, 2 t4 + 1 and 2 t4 + 8, 2 t4 + 9; a B fragment (16 x 8)
// column g at rows 2 t4, 2 t4 + 1 and 2 t4 + 8, 2 t4 + 9; a C fragment
// (16 x 8) rows g, g + 8 at columns 2 t4, 2 t4 + 1. So the C fragments of
// two adjacent 8-column n-tiles are, packed to bf16, the A fragment of one
// 16-deep k chunk.

#pragma once

#include "common.cuh"

namespace vyomai {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps
constexpr int kTile = 64;       // q rows of a CTA, keys of a K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// The additive fp32 bias a CTA reads, loaded through the K/V ring: rows
// [q0, q0 + 64) of the keys' columns, or one row for every q row.
struct BiasTile {
  const float* src;   // bias of this (batch, head) at q row q0; null: none
  long long rs;       // row stride in elements (16-byte aligned rows)
  int rows;           // rows a tile holds: 64, or 1 (broadcast over rows)
  int live_rows;      // rows at or past this are zero-filled
  int cols;           // Lk: columns at or past it are zero-filled
};

// Bytes of the bias ring (2 stages) for a tile of `rows` rows.
__host__ __device__ constexpr size_t bias_smem_bytes(int rows) {
  return (size_t)2 * rows * kTile * sizeof(float);
}

// Index of 16-byte chunk `chunk` of row `row` in a swizzled [64][D] bf16
// tile. Rows of 8+ chunks XOR the low 3 chunk bits with the row; 4-chunk
// rows (D = 32, two rows per 128-byte line) XOR with row / 2.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int CPR = D / 8;
  static_assert(CPR == 4 || CPR % 8 == 0, "D must be 32 or a multiple of 64");
  if constexpr (CPR >= 8) {
    return row * CPR + (chunk ^ (row & 7));
  } else {
    return row * CPR + (chunk ^ ((row >> 1) & 3));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `bytes` 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (ex2.approx: relative error 2^-22; -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a bf16x2 word, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Issue the copies of rows [row0, row0 + 64) of a [rows, D] bf16 matrix
// (row stride `rs` elements, unit stride along D) into a swizzled tile;
// rows at or past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          long long rs, int row0, int rows,
                                          bf16* dst, int tid) {
  constexpr int CPR = D / 8;
  const uint32_t base = smem_addr(dst);
#pragma unroll
  for (int it = 0; it < kTile * CPR / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i / CPR, c = i % CPR;
    const bool live = row0 + r < rows;
    const bf16* g = live ? src + (long long)(row0 + r) * rs + c * 8 : src;
    cp_async16(base + swz<D>(r, c) * 16, g, live ? 16 : 0);
  }
}

// Issue the copies of the bias tile of keys [k0, k0 + 64) into a ring
// stage: 16 chunks of 4 floats a row, chunk c of row r at (c ^ (r & 7)).
__device__ __forceinline__ void load_bias(const BiasTile& bt, int k0,
                                          float* dst, int tid) {
  const uint32_t base = smem_addr(dst);
  for (int i = tid; i < bt.rows * 16; i += kThreads) {
    const int r = i >> 4, c = i & 15, col = k0 + c * 4;
    const int n = r < bt.live_rows && col < bt.cols
                      ? 4 * (bt.cols - col < 4 ? bt.cols - col : 4)
                      : 0;
    cp_async16(base + (r * 16 + (c ^ (r & 7))) * 16,
               n ? bt.src + r * bt.rs + col : bt.src, n);
  }
}

// The bias of (tile row rl, tile columns cl, cl + 1) from a ring stage.
__device__ __forceinline__ float2 tile_bias(const float* t, int rows, int rl,
                                            int cl) {
  const int r = rows == 1 ? 0 : rl;
  return *reinterpret_cast<const float2*>(
      t + (r * 16 + ((cl >> 2) ^ (r & 7))) * 4 + (cl & 3));
}

// Write a warp's 16 x D accumulator (C fragments, rows g and g + 8 of each
// thread scaled by mul[0], mul[1]) in bf16 to out + r * o_rs, rows r = row0
// + 16 * warp + i below `rows`: staged in the warp's own 16 rows of a
// swizzled [64][D] tile at `smem`, which no other warp reads and no copy in
// flight writes, then 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4],
                                           const float mul[2], bf16* smem,
                                           bf16* __restrict__ out,
                                           long long o_rs, int row0,
                                           int rows) {
  constexpr int CPR = D / 8;
  const int lane = threadIdx.x & 31, wrow = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  char* base = reinterpret_cast<char*>(smem);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(base + swz<D>(wrow + g, j) * 16 + t4 * 4) =
        pack_bf16(o[j][0] * mul[0], o[j][1] * mul[0]);
    *reinterpret_cast<uint32_t*>(base + swz<D>(wrow + g + 8, j) * 16 +
                                 t4 * 4) =
        pack_bf16(o[j][2] * mul[1], o[j][3] * mul[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < CPR / 2; ++it) {
    const int i = lane + 32 * it, row = i / CPR, c = i % CPR;
    const int r = row0 + wrow + row;
    if (r < rows)
      *reinterpret_cast<uint4*>(out + (long long)r * o_rs + c * 8) =
          *reinterpret_cast<const uint4*>(base + swz<D>(wrow + row, c) * 16);
  }
}

}  // namespace tc
}  // namespace vyomai

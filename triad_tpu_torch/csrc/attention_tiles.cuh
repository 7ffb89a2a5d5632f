// Tile machinery shared by the attention kernels that keep S, P and their
// accumulators in mma.sync registers (attention_flash.cu and
// attention_train.cu): 64 x 64 bf16 tiles of a (B, H, N, 64) view staged
// in shared memory with cp.async and XOR-swizzled 16-byte chunks,
// ldmatrix loads, mma.sync m16n8k16 bf16 -> fp32 products on a warp's 16
// rows, and the map from an accumulator fragment to its (row, column).
//
// A warp's 16 x 64 fp32 accumulator is float c[8][4]: c[j] is the m16n8
// tile of columns 8j .. 8j + 7, and element e of it sits at row
// frag_row(lane, e) and column 8j + frag_col(lane, e) (row lane / 4, plus
// 8 for e >= 2; column 2 (lane % 4) + e % 2). The four lanes of a quad
// (lane / 4 equal) hold one row pair; lanes 4g + t and 4g + (t ^ 1) hold
// adjacent column pairs.
#pragma once

#include "common.cuh"

namespace triad {
namespace tiles {

constexpr int D = 64;         // head dim
constexpr int TILE = 64;      // rows of a block and of a streamed tile
constexpr int THREADS = 128;  // 4 warps of 16 rows
constexpr int TILE_ELEMS = TILE * D;

// (batch, head, row) element strides of one (B, H, N, 64) view.
struct View {
  long long b, h, r;
};

__device__ __forceinline__ int frag_row(int lane, int e) { return (lane >> 2) + ((e >> 1) << 3); }
__device__ __forceinline__ int frag_col(int lane, int e) { return 2 * (lane & 3) + (e & 1); }

// A 64 x 64 bf16 tile in shared memory: row r's 16-byte chunk c sits at
// chunk c ^ (r & 7), so 8 rows read at one logical chunk hit 8 banks sets.
__device__ __forceinline__ int swz(int r, int c) { return r * D + ((c ^ (r & 7)) << 3); }

// cp.async of rows row0 .. row0 + 63 of a (b, h) slice into a tile;
// rows at or past n are zero-filled.
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long rs, int row0, int n,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < TILE * (D / 8); i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = row0 + r < n;
    cp_async16(s + swz(r, c), ok ? g + (long long)(row0 + r) * rs + c * 8 : g, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments (16 rows from row0, 64 columns = 4 k-steps) of a tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* s, int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], s + swz(row0 + (lane & 15), kk * 2 + (lane >> 4)));
}

// A fragments of a 16 x 64 fp32 accumulator, rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// B fragments of k-step kk, output columns 16 np .. 16 np + 15, of a tile
// whose rows are the output columns and whose columns are the contraction.
__device__ __forceinline__ void load_b_nt(uint32_t (&b)[4], const bf16* t, int kk, int np,
                                          int lane) {
  ldsm_x4(b, t + swz(np * 16 + (lane & 7) + ((lane >> 4) << 3), kk * 2 + ((lane >> 3) & 1)));
}

// The same for a tile whose rows are the contraction and whose columns are
// the output columns.
__device__ __forceinline__ void load_b_nn(uint32_t (&b)[4], const bf16* t, int kk, int np,
                                          int lane) {
  ldsm_x4_t(b, t + swz(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3), np * 2 + (lane >> 4)));
}

// acc (16 x 64) += A (16 x 64) . T^T, T a tile whose rows are the output
// columns and whose columns are the contraction (q.k^T, dO.v^T).
__device__ __forceinline__ void mma_nt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b_nt(b, t, kk, np, lane);
      mma(acc[2 * np], a[kk], b[0], b[1]);
      mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// acc (16 x 64) += A (16 x 64) . T, T a tile whose rows are the
// contraction and whose columns are the output columns (P.V, dS.K).
__device__ __forceinline__ void mma_nn(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b_nn(b, t, kk, np, lane);
      mma(acc[2 * np], a[kk], b[0], b[1]);
      mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// x = hi + lo, both bf16, packed in pairs (split_bf16 of common.cuh).
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(x0 - hf.x, x1 - hf.y);
}

// acc (16 x 64) += C (16 x 64) . T as mma_nn, with the fp32 accumulator C
// as the A operand carried as bf16 hi + lo halves (~16 mantissa bits).
__device__ __forceinline__ void mma_nn_split(float (&acc)[8][4], const float (&c)[8][4],
                                             const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    split_pack(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
    split_pack(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
    split_pack(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
    split_pack(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b_nn(b, t, kk, np, lane);
      mma(acc[2 * np], hi, b[0], b[1]);
      mma(acc[2 * np], lo, b[0], b[1]);
      mma(acc[2 * np + 1], hi, b[2], b[3]);
      mma(acc[2 * np + 1], lo, b[2], b[3]);
    }
  }
}

// S = acc * sm_scale + bias of its key, in place, for a row-major tile
// whose key biases are bias[0 .. 63].
__device__ __forceinline__ void scale_bias(float (&s)[8][4], const float* bias, float sm_scale,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] * sm_scale + bias[j * 8 + frag_col(lane, e)];
}

// Row sums (rows g and g + 8) of the thread-partial x0, x1 over the quad.
__device__ __forceinline__ void quad_sum(float& x0, float& x1) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    x0 += __shfl_xor_sync(0xffffffffu, x0, o);
    x1 += __shfl_xor_sync(0xffffffffu, x1, o);
  }
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
}

// Store a 16 x 64 fp32 accumulator as bf16 rows row0 + (lane >> 2) and
// + 8 (rows at or past n skipped), each times its row's scale.
__device__ __forceinline__ void store_rows(bf16* g, long long rs, const float (&c)[8][4],
                                           int row0, int n, int lane, float s0, float s1) {
  const int r = row0 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (r < n)
      *reinterpret_cast<__nv_bfloat162*>(g + (long long)r * rs + j * 8 + col) =
          __floats2bfloat162_rn(c[j][0] * s0, c[j][1] * s0);
    if (r + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(g + (long long)(r + 8) * rs + j * 8 + col) =
          __floats2bfloat162_rn(c[j][2] * s1, c[j][3] * s1);
  }
}

}  // namespace tiles
}  // namespace triad

// Training attention with in-kernel attention dropout, head_dim 64, any N:
// one forward kernel and a backward of two kernels (dQ with di, then
// dK/dV), for any layout whose heads are 64 contiguous columns.
//
// Replaces three TPU kernels of triad_tpu/ops/pallas_attention.py that
// share the per-head bodies _head_fwd (:157) and _head_bwd (:177) and
// differ only in addressing (:60-66):
//   strided (B, H, T, D)   fused_attention (:319): _fwd :269 (pallas_call
//                          :277), _bwd :294 (:301);
//   packed (B, N, H*64)    fused_attention_packed: _pk_call :564 (pallas_call
//                          "fwd" :575, "bwd" :585);
//   merged (B, N, 3*H*64)  fused_attention_packed_merged (:797): _pkm_call
//                          :763 ("fwd" :774, "bwd" :784), q|k|v at column
//                          offsets 0, C, 2C and one merged d(qkv).
// Here every operand (q, k, v, out; dout, dq, dk, dv) is addressed through
// its own element strides of batch, head and row (View); a column offset
// is the operand's base pointer. So the three layouts are three sets of
// arguments to the same kernels, and the merged backward writes dq, dk
// and dv into one (B, N, 3C) tensor at offsets 0, C and 2C.
//
// Numerics kept from _head_fwd: S = q.k^T accumulated in fp32, times
// sm_scale, plus a key bias of (1 - mask) * -1e30 (a fully masked row
// gets uniform weights over its N keys, not NaN); P = exp(S - max) / sum
// in fp32, rounded to bf16 *after* the division; with dropout D = P *
// keep / (1 - p) in fp32, then rounded; O = bf16(D) V with fp32
// accumulation. The division is a product with the row's 1 / sum and one
// fma correction (div_by), which gives the correctly rounded quotient, as
// `/` does. From _head_bwd: dP = (dO V^T) * keep / (1 - p); di = sum_j
// dP * P (:208) over the fp32 P and dP, as the TPU kernel takes it (not
// FlashAttention's rowsum(dO * O), whose O was made from the bf16 D: with
// one key P = 1, so dS = P (dP - di) is exactly 0, as in _head_bwd). The
// kernel's tiles cannot sum in the TPU's order, so it departs from
// _head_bwd's fp32 sum on purpose and takes the value no order changes:
// the products and their sum in fp64 (exact products, ~2^-53 relative
// sum), rounded once to fp32. Where dP is nearly constant over the keys P
// weights, dS = P (dP - di) is much smaller than the terms of di, and di's
// rounding reaches dS magnified: in HuBERT's layers on trained weights
// the rows cancel 29x at the median and up to 89x, and an fp32 sum in the
// tiles' order (a chain of N / 4 fma per lane) gave 2.3x the dq error of
// this one (tools/kernel_probe.py di). dS =
// P (dP - di); dV = D^T dO with the fp32 D; dQ = dS K s; dK = dS^T Q s.
// The backward products with an fp32 operand (D, dS) run on bf16 tensor
// cores as two halves hi + lo (split_bf16, ~16 mantissa bits), so they
// stay at fp32 level and each output rounds once, to bf16. Ragged N: keys
// and query rows at or past N are zero-filled on load, a key past N has
// the bias -inf (its P is 0 and it never counts in the sum), and nothing
// past N is stored.
//
// Dropout (p > 0, pallas_attention.py:15-21): the keep bit of (query i,
// key j) in head (b, h) is word j % 4 of triad::keep4 under key (seed,
// (b0 + b) * H + h) at row i, column j / 4 (b0: the global index of the
// first batch row, passed as offset = b0 * H), so the forward and the
// backward, which
// tile the (N, N) matrix differently, use the same mask, and so do the
// three layouts: strided, packed and merged agree bit for bit on the same
// inputs and seed (the TPU kernels cannot promise that,
// pallas_attention.py:646-653). At p = 0 nothing is drawn.
//
// What bounds it on the card: per (batch, head) the work is a few N x N x
// 64 products (N 261 in the ViT, 499 in HuBERT on 10 s clips), and at
// p > 0 one Philox4x32-10 call per 4 keys per pass over the mask (~48 M at
// (64, 12, 499), comparable to the forward's products). So the kernels are
// bound by how fast the tensor cores are fed and by the keep draws, not by
// bytes. The design is FlashAttention-2 on the tiles of
// attention_tiles.cuh (as attention_flash.cu): 64-row blocks, 4 warps of
// 16 rows, S, P, dP, dS and every accumulator in mma.sync register
// fragments, the streamed 64 x 64 tiles double-buffered with cp.async.
// Shared memory holds a few tiles and does not grow with N: there is no
// key cap, and several blocks share an SM.
//   forward  one block per (b, h, 64-query tile). Pass 1 walks the key
//            tiles for the row max m and sum l (online, fp32); pass 2
//            walks them again, forms P = exp(S - m) / l (normalised, then
//            rounded, as _head_fwd: one extra Q K^T product keeps that,
//            where a one-pass online softmax would round the
//            un-normalised exp), applies the keep bits and accumulates
//            bf16(D) V. Writes O and the row stats (m, l), (2, B, H, N)
//            fp32, all the autograd Function saves for the backward.
//   dQ       one block per (b, h, 64-query tile), two passes over the key
//            tiles: pass 1 forms P from (m, l) and dP from dO V^T and the
//            keep bits, and sums di = rowsum(dP * P) in fp64; pass 2 forms
//            them again, dS and dQ += dS K (hi + lo). Writes dQ, di, (B,
//            H, N) fp32, and with dropout the keep bits pass 1 drew (N^2 /
//            8 bytes per head of scratch), which pass 2 reads back.
//   dK/dV    one block per (b, h, 64-key tile) walking every query tile in
//            order: S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T are
//            already A fragments; dV += D^T dO and dK += dS^T Q (hi + lo).
// dK and dV sum over every query row. TPU grid steps run in order, Hopper
// blocks do not: here each sum lives in one block's loop (no atomics, two
// runs give bit-equal gradients), at the price of rebuilding S and dP in
// both backward kernels. di's pass costs the dQ kernel two more products,
// an exp and a keep draw per key; the forward saves 8 bytes per row and
// head.
//
// The keep bits. A Philox4x32-10 call is ~50 integer operations for 4
// keys, as much as the rest of a key's work, so each (query, quad) is
// drawn once in the forward and once in the backward. An m16n8
// accumulator gives a lane two adjacent keys of each 8, so one keep4 draw
// covers the keys of two neighbouring lanes: in the row-major tiles
// (forward, dQ) the lane pair splits the work by row, the even lane
// drawing its 8 quads of row g, the odd lane those of row g + 8; each
// packs its 32 keep bits into one word and one __shfl_xor_sync(.., 1)
// hands each lane the other row. The dQ kernel stores those words in its
// first pass and reads them back in its second; the dK/dV kernel, whose
// transposed tiles put the 4 keys of a quad in 4 different lanes, stages
// the words of each query tile in shared memory with the tile (512 bytes)
// and picks its keys' bits out of them: no draw, no shuffle.
#include "attention_tiles.cuh"

namespace {

using triad::bf16;
using namespace triad::tiles;

// The views of every operand: q, k, v, o (the output in the forward, its
// gradient dout in the backward), dq, dk, dv.
struct Views {
  View q, k, v, o, dq, dk, dv;
};

__device__ __forceinline__ long long at(const View& s, int b, int hh) {
  return b * s.b + hh * s.h;
}

// _head_fwd's key bias for key j < n; -inf past n (P = 0, not counted).
__device__ __forceinline__ float key_bias(const float* mask_b, int n, int j) {
  return j < n ? (1.0f - mask_b[j]) * -1e30f : -INFINITY;
}

// Keep bits of a row-major 16 x 64 tile (rows row0 + frag_row, keys k0 +
// frag_col). A lane pair (lanes 2i, 2i + 1) shares the quads of 4 keys:
// draw_rows gives this lane's word, the 8 draws of its row (row g for the
// even lane, g + 8 for the odd one) on its quads, the draw of key block j
// at bits 4j .. 4j + 3 (word u of the draw is key 4 quad + u); exchange
// hands each lane both rows: bits[0] row g, bits[1] row g + 8, with the
// bit of (j, e) at 4j + 2 (lane & 1) + (e & 1) of bits[e >> 1].
__device__ __forceinline__ uint32_t draw_rows(const triad::Dropout& dp, uint32_t stream,
                                              int row0, int k0, int lane) {
  const uint32_t row = (uint32_t)(row0 + (lane >> 2) + ((lane & 1) << 3));
  const uint32_t quad = (uint32_t)(k0 >> 2) + ((lane >> 1) & 1);
  uint32_t mine = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const triad::Keep4 kb = triad::keep4(dp.seed, stream, row, quad + 2 * j);
#pragma unroll
    for (int u = 0; u < 4; ++u) mine |= (uint32_t)(kb.w[u] >= dp.thresh) << (4 * j + u);
  }
  return mine;
}

__device__ __forceinline__ void exchange(uint32_t (&bits)[2], uint32_t mine, int lane) {
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  bits[0] = (lane & 1) ? other : mine;
  bits[1] = (lane & 1) ? mine : other;
}

__device__ __forceinline__ bool kept_rows(const uint32_t (&bits)[2], int lane, int j, int e) {
  return (bits[e >> 1] >> (4 * j + 2 * (lane & 1) + (e & 1))) & 1u;
}

// The backward's keep-bit scratch: the draw_rows words of (row, key tile
// kt), two per row and tile (quad parity (lane >> 1) & 1), laid out
// [B H][N][tiles][2] so a key tile's words of one row are 8 bytes.
__device__ __forceinline__ long long kbits_at(long long bh, int row, int tiles, int kt, int par) {
  return ((bh + row) * tiles + kt) * 2 + par;
}

// Keep bits of a transposed 16 x 64 tile (keys key0 + frag_row, queries
// q0 + 8j + frag_col; key0 = the tile's key 16 warp) from the scratch
// words of its 64 query rows, staged as w[row][parity]: the bit of (j, e)
// at 8e + j. Lane 16a + 4u + t holds keys 16 warp + 4a + u (+ 8), of
// parity a, bit 4 (2 warp) + u (+ 4) of each word.
__device__ __forceinline__ uint32_t keep_cols(const uint32_t* w, int warp, int lane) {
  const int t = lane & 3, u = (lane >> 2) & 3, a = lane >> 4;
  const int sh = 8 * warp + u;
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const uint32_t word = w[(8 * j + 2 * t + e1) * 2 + a];
      bits |= ((word >> sh) & 1u) << (8 * e1 + j);
      bits |= ((word >> (sh + 4)) & 1u) << (8 * (2 + e1) + j);
    }
  return bits;
}

// Row max over this thread's elements, reduced over the quad (rows g, g + 8).
__device__ __forceinline__ void quad_max(const float (&s)[8][4], float& m0, float& m1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
}

// a / b correctly rounded, from rb = 1 / b (correctly rounded): the
// product and one fma correction (Markstein), as `a / b` gives it.
__device__ __forceinline__ float div_by(float a, float b, float rb) {
  const float q = a * rb;
  return fmaf(fmaf(-b, q, a), rb, q);
}

// P = exp(S - m) / l in place, rows g (m0, l0, rl0 = 1 / l0) and g + 8.
__device__ __forceinline__ void probs(float (&s)[8][4], float m0, float m1, float l0, float l1,
                                      float rl0, float rl1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = div_by(expf(s[j][0] - m0), l0, rl0);
    s[j][1] = div_by(expf(s[j][1] - m0), l0, rl0);
    s[j][2] = div_by(expf(s[j][2] - m1), l1, rl1);
    s[j][3] = div_by(expf(s[j][3] - m1), l1, rl1);
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (b, h, 64-query tile). Steps 0 .. tiles - 1 are
// pass 1 (K tiles: m, l), steps tiles .. 2 tiles - 1 pass 2 (K and V
// tiles: P, D, O); the next step's tiles load during this step's products.
// ---------------------------------------------------------------------------

constexpr size_t FWD_SMEM = sizeof(bf16) * 5 * TILE_ELEMS + sizeof(float) * 2 * TILE;

__global__ void __launch_bounds__(THREADS)
attention_train_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           bf16* __restrict__ out, float* __restrict__ stats, Views vw, int H,
                           int n, float sm_scale, triad::Dropout dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TILE_ELEMS;      // [2][TILE_ELEMS]
  bf16* sV = sK + 2 * TILE_ELEMS;  // [2][TILE_ELEMS]
  float* sBias = reinterpret_cast<float*>(sV + 2 * TILE_ELEMS);  // [2][TILE]

  const int q0 = blockIdx.x * TILE, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kb = k + at(vw.k, b, hh);
  const bf16* vb = v + at(vw.v, b, hh);
  const float* mb = mask + (long long)b * n;
  const int tiles = (n + TILE - 1) / TILE;
  const uint32_t stream = dp.offset + (uint32_t)(b * H + hh);
  const int r0 = q0 + warp * 16;

  auto fetch = [&](int step, int buf) {
    const int k0 = (step < tiles ? step : step - tiles) * TILE;
    load_tile(sK + buf * TILE_ELEMS, kb, vw.k.r, k0, n, tid);
    if (step >= tiles) load_tile(sV + buf * TILE_ELEMS, vb, vw.v.r, k0, n, tid);
    triad::cp_async_commit();
    if (tid < TILE) sBias[buf * TILE + tid] = key_bias(mb, n, k0 + tid);
  };
  load_tile(sQ, q + at(vw.q, b, hh), vw.q.r, q0, n, tid);
  fetch(0, 0);

  uint32_t qa[4][4];
  float acc[8][4];  // bf16(D) V
  zero(acc);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows g, g + 8
  float rl0 = 1.0f, rl1 = 1.0f;

  for (int step = 0; step < 2 * tiles; ++step) {
    const int buf = step & 1;
    triad::cp_async_wait<0>();
    __syncthreads();  // this step's tiles landed; every warp is done with the last step's
    if (step + 1 < 2 * tiles) fetch(step + 1, buf ^ 1);
    if (step == 0) load_a(qa, sQ, warp * 16, lane);
    float s[8][4];
    zero(s);
    mma_nt(s, qa, sK + buf * TILE_ELEMS, lane);
    scale_bias(s, sBias + buf * TILE, sm_scale, lane);
    if (step < tiles) {
      // online max and (thread-partial) sum; the rescale is quad-uniform
      float mx0 = m0, mx1 = m1;
      quad_max(s, mx0, mx1);
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sum0 += expf(s[j][0] - mx0) + expf(s[j][1] - mx0);
        sum1 += expf(s[j][2] - mx1) + expf(s[j][3] - mx1);
      }
      l0 = l0 * expf(m0 - mx0) + sum0;
      l1 = l1 * expf(m1 - mx1) + sum1;
      m0 = mx0;
      m1 = mx1;
      if (step == tiles - 1) {
        quad_sum(l0, l1);
        rl0 = 1.0f / l0;
        rl1 = 1.0f / l1;
      }
      continue;
    }
    probs(s, m0, m1, l0, l1, rl0, rl1);
    if (dp.active) {
      uint32_t bits[2];
      exchange(bits, draw_rows(dp, stream, r0, (step - tiles) * TILE, lane), lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = kept_rows(bits, lane, j, e) ? s[j][e] * dp.scale : 0.0f;
    }
    uint32_t da[4][4];  // bf16(D)
    to_a(da, s);
    mma_nn(acc, da, sV + buf * TILE_ELEMS, lane);
  }

  store_rows(out + at(vw.o, b, hh), vw.o.r, acc, r0, n, lane, 1.0f, 1.0f);
  const long long plane = (long long)gridDim.z * H * n, bh = ((long long)b * H + hh) * n;
  const int r = r0 + frag_row(lane, 0);
  if ((lane & 3) == 0) {
    if (r < n) {
      stats[bh + r] = m0;
      stats[plane + bh + r] = l0;
    }
    if (r + 8 < n) {
      stats[bh + r + 8] = m1;
      stats[plane + bh + r + 8] = l1;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 1, dQ and di: one block per (b, h, 64-query tile). Steps 0 ..
// tiles - 1 are pass 1 (di), steps tiles .. 2 tiles - 1 pass 2 (dS, dQ);
// each step streams the K and V tiles of key tile step % tiles.
// ---------------------------------------------------------------------------

constexpr size_t DQ_SMEM = sizeof(bf16) * 6 * TILE_ELEMS + sizeof(float) * 2 * TILE;

__global__ void __launch_bounds__(THREADS)
attention_train_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ mask,
                          const bf16* __restrict__ dout, const float* __restrict__ stats,
                          bf16* __restrict__ dq, float* __restrict__ di_out,
                          uint32_t* __restrict__ kbits, Views vw, int H, int n, float sm_scale,
                          triad::Dropout dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sD = sQ + TILE_ELEMS;      // dO
  bf16* sK = sD + TILE_ELEMS;      // [2][TILE_ELEMS]
  bf16* sV = sK + 2 * TILE_ELEMS;  // [2][TILE_ELEMS]
  float* sBias = reinterpret_cast<float*>(sV + 2 * TILE_ELEMS);  // [2][TILE]

  const int q0 = blockIdx.x * TILE, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kb = k + at(vw.k, b, hh);
  const bf16* vb = v + at(vw.v, b, hh);
  const float* mb = mask + (long long)b * n;
  const int tiles = (n + TILE - 1) / TILE;
  const uint32_t stream = dp.offset + (uint32_t)(b * H + hh);
  const int r0 = q0 + warp * 16, r = r0 + frag_row(lane, 0);
  const long long plane = (long long)gridDim.z * H * n, bh = ((long long)b * H + hh) * n;
  // the keep-bit word this lane draws (pass 1) and reads back (pass 2)
  const int bits_row = r0 + (lane >> 2) + ((lane & 1) << 3), bits_par = (lane >> 1) & 1;

  auto fetch = [&](int step, int buf) {
    const int k0 = (step < tiles ? step : step - tiles) * TILE;
    load_tile(sK + buf * TILE_ELEMS, kb, vw.k.r, k0, n, tid);
    load_tile(sV + buf * TILE_ELEMS, vb, vw.v.r, k0, n, tid);
    triad::cp_async_commit();
    if (tid < TILE) sBias[buf * TILE + tid] = key_bias(mb, n, k0 + tid);
  };
  load_tile(sQ, q + at(vw.q, b, hh), vw.q.r, q0, n, tid);
  load_tile(sD, dout + at(vw.o, b, hh), vw.o.r, q0, n, tid);
  fetch(0, 0);

  // This thread's rows g and g + 8: m, l, 1 / l (rows past n: inert),
  // and di, summed in fp64 (sd) and rounded once at the end of pass 1.
  float m0 = 0.0f, m1 = 0.0f, l0 = 1.0f, l1 = 1.0f, di0 = 0.0f, di1 = 0.0f;
  double sd0 = 0.0, sd1 = 0.0;
  if (r < n) {
    m0 = stats[bh + r];
    l0 = stats[plane + bh + r];
  }
  if (r + 8 < n) {
    m1 = stats[bh + r + 8];
    l1 = stats[plane + bh + r + 8];
  }
  const float rl0 = 1.0f / l0, rl1 = 1.0f / l1;
  uint32_t qa[4][4], da[4][4];
  float dq_acc[8][4];
  zero(dq_acc);

  for (int step = 0; step < 2 * tiles; ++step) {
    const int buf = step & 1, t = step < tiles ? step : step - tiles;
    triad::cp_async_wait<0>();
    __syncthreads();
    if (step + 1 < 2 * tiles) fetch(step + 1, buf ^ 1);
    if (step == 0) {
      load_a(qa, sQ, warp * 16, lane);
      load_a(da, sD, warp * 16, lane);
    }
    const bf16* tk = sK + buf * TILE_ELEMS;
    float p[8][4], ds[8][4];
    zero(p);
    mma_nt(p, qa, tk, lane);  // S = Q K^T
    scale_bias(p, sBias + buf * TILE, sm_scale, lane);
    probs(p, m0, m1, l0, l1, rl0, rl1);
    zero(ds);
    mma_nt(ds, da, sV + buf * TILE_ELEMS, lane);  // dO V^T
    if (dp.active) {
      // pass 1 draws this lane's word and keeps it for pass 2 and dK/dV
      uint32_t mine = 0u;
      const long long at_bits = kbits_at(bh, bits_row, tiles, t, bits_par);
      if (step < tiles) {
        mine = draw_rows(dp, stream, r0, t * TILE, lane);
        if (bits_row < n) kbits[at_bits] = mine;
      } else if (bits_row < n) {
        mine = kbits[at_bits];
      }
      uint32_t bits[2];
      exchange(bits, mine, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = kept_rows(bits, lane, j, e) ? ds[j][e] * dp.scale : 0.0f;
    }
    if (step < tiles) {  // di += rowsum(dP * P), this thread's columns
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sd0 = fma((double)ds[j][0], (double)p[j][0], sd0);
        sd0 = fma((double)ds[j][1], (double)p[j][1], sd0);
        sd1 = fma((double)ds[j][2], (double)p[j][2], sd1);
        sd1 = fma((double)ds[j][3], (double)p[j][3], sd1);
      }
      if (step == tiles - 1) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          sd0 += __shfl_xor_sync(0xffffffffu, sd0, o);
          sd1 += __shfl_xor_sync(0xffffffffu, sd1, o);
        }
        di0 = (float)sd0;
        di1 = (float)sd1;
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ds[j][0] = p[j][0] * (ds[j][0] - di0);
      ds[j][1] = p[j][1] * (ds[j][1] - di0);
      ds[j][2] = p[j][2] * (ds[j][2] - di1);
      ds[j][3] = p[j][3] * (ds[j][3] - di1);
    }
    mma_nn_split(dq_acc, ds, tk, lane);  // dQ += dS K
  }

  store_rows(dq + at(vw.dq, b, hh), vw.dq.r, dq_acc, r0, n, lane, sm_scale, sm_scale);
  if ((lane & 3) == 0) {
    if (r < n) di_out[bh + r] = di0;
    if (r + 8 < n) di_out[bh + r + 8] = di1;
  }
}

// ---------------------------------------------------------------------------
// Backward 2, dK and dV: one block per (b, h, 64-key tile), walking the
// query tiles in order. Warp w owns keys 16w .. 16w + 15 of the tile.
// ---------------------------------------------------------------------------

constexpr size_t DKV_SMEM = sizeof(bf16) * 6 * TILE_ELEMS + sizeof(float) * 2 * 4 * TILE +
                            sizeof(uint32_t) * 2 * TILE * 2;

__global__ void __launch_bounds__(THREADS)
attention_train_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           const bf16* __restrict__ dout, const float* __restrict__ stats,
                           const float* __restrict__ di, const uint32_t* __restrict__ kbits,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, Views vw, int H, int n,
                           float sm_scale, triad::Dropout dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE_ELEMS;
  bf16* sQ = sV + TILE_ELEMS;      // [2][TILE_ELEMS]
  bf16* sD = sQ + 2 * TILE_ELEMS;  // dO, [2][TILE_ELEMS]
  float* sStat = reinterpret_cast<float*>(sD + 2 * TILE_ELEMS);  // [2][4][TILE]: m, l, 1 / l, di
  uint32_t* sBits = reinterpret_cast<uint32_t*>(sStat + 2 * 4 * TILE);  // [2][TILE][2]

  const int k0 = blockIdx.x * TILE, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qb = q + at(vw.q, b, hh);
  const bf16* db = dout + at(vw.o, b, hh);
  const long long plane = (long long)gridDim.z * H * n, bh = ((long long)b * H + hh) * n;
  const int tiles = (n + TILE - 1) / TILE;

  // Query rows past n: m 0, l 1, di 0 and no keep bits, with zero q and
  // dO, add nothing.
  auto fetch = [&](int t, int buf) {
    const int q0 = t * TILE;
    load_tile(sQ + buf * TILE_ELEMS, qb, vw.q.r, q0, n, tid);
    load_tile(sD + buf * TILE_ELEMS, db, vw.o.r, q0, n, tid);
    if (dp.active && tid < TILE) {
      const bool ok = q0 + tid < n;
      triad::cp_async8(sBits + (buf * TILE + tid) * 2,
                kbits + (ok ? kbits_at(bh, q0 + tid, tiles, blockIdx.x, 0) : 0), ok);
    }
    triad::cp_async_commit();
    if (tid < TILE) {
      const bool ok = q0 + tid < n;
      float* st = sStat + buf * 4 * TILE;
      const float l = ok ? stats[plane + bh + q0 + tid] : 1.0f;
      st[tid] = ok ? stats[bh + q0 + tid] : 0.0f;
      st[TILE + tid] = l;
      st[2 * TILE + tid] = 1.0f / l;
      st[3 * TILE + tid] = ok ? di[bh + q0 + tid] : 0.0f;
    }
  };
  load_tile(sK, k + at(vw.k, b, hh), vw.k.r, k0, n, tid);
  load_tile(sV, v + at(vw.v, b, hh), vw.v.r, k0, n, tid);
  fetch(0, 0);

  // This thread's keys: rows g and g + 8 of its warp's 16.
  const int key0 = k0 + warp * 16, key = key0 + frag_row(lane, 0);
  const float* mb = mask + (long long)b * n;
  const float bias0 = key_bias(mb, n, key), bias1 = key_bias(mb, n, key + 8);

  uint32_t ka[4][4], va[4][4];
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    triad::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < tiles) fetch(t + 1, buf ^ 1);
    if (t == 0) {
      load_a(ka, sK, warp * 16, lane);
      load_a(va, sV, warp * 16, lane);
    }
    const bf16* tq = sQ + buf * TILE_ELEMS;
    const bf16* td = sD + buf * TILE_ELEMS;
    const float* st = sStat + buf * 4 * TILE;
    float p[8][4], ds[8][4];
    zero(p);
    mma_nt(p, ka, tq, lane);  // S^T: keys x queries
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + frag_col(lane, e);
        const float s = p[j][e] * sm_scale + (e < 2 ? bias0 : bias1);
        p[j][e] = div_by(expf(s - st[qc]), st[TILE + qc], st[2 * TILE + qc]);
      }
    zero(ds);
    mma_nt(ds, va, td, lane);  // (dO V^T)^T = V dO^T
    // dS^T = P^T (dP^T - di), then P^T becomes D^T = P^T keep / (1 - p)
    const uint32_t bits = dp.active ? keep_cols(sBits + buf * TILE * 2, warp, lane) : 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + frag_col(lane, e);
        if (dp.active) {
          const bool keep = (bits >> (8 * e + j)) & 1u;
          ds[j][e] = keep ? ds[j][e] * dp.scale : 0.0f;
          ds[j][e] = p[j][e] * (ds[j][e] - st[3 * TILE + qc]);
          p[j][e] = keep ? p[j][e] * dp.scale : 0.0f;
        } else {
          ds[j][e] = p[j][e] * (ds[j][e] - st[3 * TILE + qc]);
        }
      }
    mma_nn_split(dv_acc, p, td, lane);   // dV += D^T dO
    mma_nn_split(dk_acc, ds, tq, lane);  // dK += dS^T Q
  }
  store_rows(dk + at(vw.dk, b, hh), vw.dk.r, dk_acc, key0, n, lane, sm_scale, sm_scale);
  store_rows(dv + at(vw.dv, b, hh), vw.dv.r, dv_acc, key0, n, lane, 1.0f, 1.0f);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The views of `count` operands from their element strides, three per
// operand in the order of Views (q, k, v, o, dq, dk, dv).
Views views_of(const long long* strides, int count) {
  View s[7] = {};
  for (int i = 0; i < count; ++i)
    s[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return Views{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
}

}  // namespace

// q, k, v, out: bf16 operands seen as (B, H, N, 64) with unit column
// stride; strides: their (batch, head, row) element strides, 3 x 4 in the
// order q, k, v, out (every stride a multiple of 8 and every base pointer
// 16-byte aligned); mask: (B, N) contiguous fp32 key mask (1 = attend);
// stats: (2, B, H, N) fp32 out, the row max m and sum l of the softmax;
// dropout: keep iff bits >= thresh, kept values times keep_scale, none
// when active == 0, streams shifted by offset = b0 * h. Any n >= 1.
// Returns a cudaError_t.
extern "C" int triad_attention_train_fwd(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, void* stats,
                                         const long long* strides, int b, int h, int n,
                                         float sm_scale, unsigned seed, unsigned thresh,
                                         float keep_scale, int active, unsigned offset,
                                         void* stream) {
  if (b <= 0 || h <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(attention_train_fwd_kernel, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  attention_train_fwd_kernel<<<dim3((n + TILE - 1) / TILE, h, b), THREADS, FWD_SMEM,
                               (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (bf16*)out,
      (float*)stats, views_of(strides, 4), h, n, sm_scale,
      triad::Dropout{seed, thresh, keep_scale, active, offset});
  return (int)cudaGetLastError();
}

// The backward, dQ (with di) then dK/dV, two grids on one stream. Adds
// dout (the output gradient) and writes dq, dk, dv, all addressed like the
// forward's operands (strides: 3 x 7 in the order q, k, v, dout, dq, dk,
// dv); stats: the forward's; di: (B, H, N) fp32 scratch that the first
// grid writes and the second reads; the dropout arguments are the
// forward's; kbits: with dropout, B H N ceil(N / 64) 2 uint32 scratch for
// the keep bits the first grid draws and both read (else unused).
// Returns a cudaError_t.
extern "C" int triad_attention_train_bwd(const void* q, const void* k, const void* v,
                                         const void* mask, const void* dout, const void* stats,
                                         void* di, void* kbits, void* dq, void* dk, void* dv,
                                         const long long* strides, int b, int h, int n,
                                         float sm_scale, unsigned seed, unsigned thresh,
                                         float keep_scale, int active, unsigned offset,
                                         void* stream) {
  if (b <= 0 || h <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const triad::Dropout dp{seed, thresh, keep_scale, active, offset};
  const Views vw = views_of(strides, 7);
  cudaError_t err = allow_smem(attention_train_dq_kernel, DQ_SMEM);
  if (err == cudaSuccess) err = allow_smem(attention_train_dkv_kernel, DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + TILE - 1) / TILE, h, b);
  attention_train_dq_kernel<<<grid, THREADS, DQ_SMEM, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (const bf16*)dout,
      (const float*)stats, (bf16*)dq, (float*)di, (uint32_t*)kbits, vw, h, n, sm_scale, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_train_dkv_kernel<<<grid, THREADS, DKV_SMEM, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (const bf16*)dout,
      (const float*)stats, (const float*)di, (const uint32_t*)kbits, (bf16*)dk, (bf16*)dv, vw, h,
      n, sm_scale, dp);
  return (int)cudaGetLastError();
}

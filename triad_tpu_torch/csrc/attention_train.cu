// Training attention with in-kernel attention dropout: a forward kernel
// and a recompute backward in two kernels, for any layout whose heads are
// 64 contiguous columns.
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
// Dropout (p > 0, pallas_attention.py:15-21): the keep bit of (query i,
// key j) in head (b, h) is triad::keep4 under key (seed, b * H + h) at
// row i, column j, so the forward and both backward kernels, which tile
// the (N, N) matrix differently, draw the same mask, and so do the three
// layouts: strided, packed and merged agree bit for bit on the same
// inputs and seed (the TPU kernels cannot promise that,
// pallas_attention.py:646-653). Forward: D = P * keep / (1 - p) in fp32,
// rounded to bf16, times V. Backward: dD = dO V^T, dP = dD * keep / (1 -
// p), di = sum_j dP * P, dS = P (dP - di), dV = D^T dO with the fp32 D.
// Each draw yields the bits of four adjacent keys, so the loops that apply
// the mask walk the keys four at a time.
//
// Numerics kept from _head_fwd: S = q.k^T accumulated in fp32, times
// sm_scale, plus a key bias of (1 - mask) * -1e30 (a fully masked row
// gets uniform weights, not NaN); P = exp(S - max) / sum in fp32; P is
// rounded to bf16 *after* the division (the eval kernel rounds the
// un-normalised exp and divides later, so it is not reused here);
// O = bf16(P) V with fp32 accumulation.
//
// Numerics kept from _head_bwd: dP = dO V^T; dV = P^T dO with the fp32
// P; di = sum_k dP * P over the fp32 P (not FlashAttention's shortcut
// rowsum(dO * O), whose O was made from the bf16 P); dS = P (dP - di);
// dQ = dS K s; dK = dS^T Q s. The three products with an fp32 operand
// (P or dS) run on bf16 tensor cores as two halves hi + lo
// (triad::split_bf16, ~16 mantissa bits), so they stay at fp32 level and
// each output rounds once, to bf16.
//
// What bounds it on the card: per (batch, head) the work is a few
// N x N x 64 products (N = 261 in the ViT), small for the tensor cores;
// the kernels are bound by shared-memory traffic and by how many blocks
// fit beside the full fp32 score rows they keep. The design:
//   forward    one block per (b, h, 64-query tile), the eval kernel's
//              structure: the tile's whole fp32 score row in shared
//              memory, so the softmax is the exact two-pass one (512-key
//              cap). Those rows leave room for one block per SM, so the
//              kernel declares a minimum of 1 block: without it ptxas held
//              it at 72 registers and spilled (13% slower at (64, 499)).
//   backward 1 ("rows") one block per (b, h, 32-query tile): full S and
//              dP rows in shared memory give the row max, sum and di,
//              then dS and dQ over all keys; writes dQ and the row stats.
//   backward 2 ("columns") one block per (b, h, 64-key tile) that walks
//              every query tile in order and accumulates dK and dV in
//              registers, rebuilding P and dS from the saved row stats.
// dK and dV sum over every query row. TPU grid steps run in order,
// Hopper blocks do not: here the sum lives in one block's loop (no
// atomics, deterministic), at the price of computing S and dP twice.
// Ragged N: query rows and keys past N are zero-filled on load, their P
// and dS are 0, and they are never stored.
#include "common.cuh"

using namespace nvcuda;

namespace {

using triad::bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr int D = 64;          // head dim
constexpr int KC = 64;         // keys per staged chunk
constexpr int LDT = D + 8;     // bf16 row stride of a 64-wide tile
constexpr int LDF = KC + 4;    // fp32 row stride of a 64-wide tile
constexpr int THREADS = 128;   // 4 warps
constexpr int FQ = 64;         // forward: query rows per block
constexpr int RQ = 32;         // backward rows: query rows per block
constexpr int CK = 64;         // backward columns: keys per block
constexpr int CQ = 64;         // backward columns: query rows per step
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Element strides of one operand seen as (B, H, N, 64): batch, head, row.
struct View {
  long long b, h, r;
};

// The views of every operand: q, k, v, o (the output in the forward, its
// gradient dout in the backward), dq, dk, dv.
struct Views {
  View q, k, v, o, dq, dk, dv;
};

__device__ inline long long at(const View& s, int b, int hh) { return b * s.b + hh * s.h; }

// Rows [r0, r0 + rows) of one head's 64 columns -> shared memory with
// row stride LDT; rows >= n are zero-filled.
__device__ inline void load_rows(bf16* dst, const bf16* src, long long row_stride, int r0,
                                 int rows, int n, int tid) {
  for (int i = tid; i < rows * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = r0 + r < n;
    triad::copy16(dst + r * LDT + c, ok ? src + (long long)(r0 + r) * row_stride + c : src, ok);
  }
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float key_bias(const float* mask, long long b, int n, int j) {
  return j < n ? (1.0f - mask[b * n + j]) * -1e30f : 0.0f;
}

__device__ inline bool kept(const triad::Keep4& kb, int u, const triad::Dropout& dp) {
  return kb.w[u] >= dp.thresh;
}

// ---------------------------------------------------------------- forward

__host__ inline size_t fwd_smem(int nk_pad) {
  return sizeof(bf16) * (size_t)(FQ * LDT + KC * LDT)   // sQ, sKV
         + sizeof(float) * (size_t)FQ * (nk_pad + 4)    // sS
         + sizeof(bf16) * (size_t)FQ * (nk_pad + 8)     // sP
         + sizeof(float) * (size_t)nk_pad;              // sBias
}

__global__ void __launch_bounds__(THREADS, 1)
attention_train_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           bf16* __restrict__ out, Views vw, int n, int h, float sm_scale,
                           triad::Dropout dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk_pad = round_up(n, KC);
  const int ldS = nk_pad + 4, ldP = nk_pad + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + FQ * LDT;
  float* sS = reinterpret_cast<float*>(sKV + KC * LDT);
  bf16* sP = reinterpret_cast<bf16*>(sS + FQ * ldS);
  float* sBias = reinterpret_cast<float*>(sP + FQ * ldP);

  const int q0 = blockIdx.x * FQ, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const bf16* __restrict__ kb = k + at(vw.k, b, hh);
  const bf16* __restrict__ vb = v + at(vw.v, b, hh);
  const int kr = (int)vw.k.r, vr = (int)vw.v.r;  // row strides < 2^31 (checked by the wrapper)
  load_rows(sQ, q + at(vw.q, b, hh), vw.q.r, q0, FQ, n, tid);
  for (int j = tid; j < nk_pad; j += THREADS) sBias[j] = key_bias(mask, b, n, j);

  // Pass 1: S = Q K^T, one 64-key chunk at a time; warp w owns rows 16w.
  FragA qa[D / 16];
  for (int kc = 0; kc < nk_pad; kc += KC) {
    __syncthreads();
    load_rows(sKV, kb, kr, kc, KC, n, tid);
    __syncthreads();
    if (kc == 0)
      for (int kk = 0; kk < D / 16; ++kk)
        wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * LDT + kk * 16, LDT);
    for (int t = 0; t < KC / 16; ++t) {
      FragC acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBT kf;
        wmma::load_matrix_sync(kf, sKV + t * 16 * LDT + kk * 16, LDT);
        wmma::mma_sync(acc, qa[kk], kf, acc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * ldS + kc + t * 16, acc, ldS, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // Softmax per row, normalised in fp32, then rounded to bf16.
  for (int rr = 0; rr < 16; ++rr) {
    float* srow = sS + (warp * 16 + rr) * ldS;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float s = srow[j] * sm_scale + sBias[j];
      srow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    bf16* prow = sP + (warp * 16 + rr) * ldP;
    if (!dp.active) {
      for (int j = lane; j < nk_pad; j += 32)
        prow[j] = __float2bfloat16(j < n ? srow[j] / sum : 0.0f);
      continue;
    }
    // D = P * keep / (1 - p), four keys per draw (nk_pad % 4 == 0).
    const uint32_t stream = (uint32_t)(b * h + hh), row = (uint32_t)(q0 + warp * 16 + rr);
    for (int j0 = lane * 4; j0 < nk_pad; j0 += 128) {
      const triad::Keep4 kb = triad::keep4(dp.seed, stream, row, (uint32_t)j0 >> 2);
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u;
        const float p = j < n ? srow[j] / sum : 0.0f;
        prow[j] = __float2bfloat16(kept(kb, u, dp) ? p * dp.scale : 0.0f);
      }
    }
  }

  // Pass 2: O = bf16(P) V, fp32 accumulation.
  FragC o[D / 16];
  for (int t = 0; t < D / 16; ++t) wmma::fill_fragment(o[t], 0.0f);
  for (int kc = 0; kc < nk_pad; kc += KC) {
    __syncthreads();
    load_rows(sKV, vb, vr, kc, KC, n, tid);
    __syncthreads();
    for (int kk = 0; kk < KC / 16; ++kk) {
      FragA pa;
      wmma::load_matrix_sync(pa, sP + warp * 16 * ldP + kc + kk * 16, ldP);
      for (int t = 0; t < D / 16; ++t) {
        FragB vf;
        wmma::load_matrix_sync(vf, sKV + kk * 16 * LDT + t * 16, LDT);
        wmma::mma_sync(o[t], pa, vf, o[t]);
      }
    }
  }
  for (int t = 0; t < D / 16; ++t)
    wmma::store_matrix_sync(sS + warp * 16 * ldS + t * 16, o[t], ldS, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    if (q0 + r >= n) break;
    const float* orow = sS + r * ldS;
    const int c = lane * 2;
    *reinterpret_cast<__nv_bfloat162*>(out + at(vw.o, b, hh) + (long long)(q0 + r) * vw.o.r +
                                       c) = __floats2bfloat162_rn(orow[c], orow[c + 1]);
  }
}

// ---------------------------------------------------------- backward rows

__host__ inline size_t rows_smem(int nk_pad) {
  return sizeof(bf16) * (size_t)(2 * RQ * LDT + 2 * KC * LDT + 2 * RQ * LDT)  // Q dO K V hi lo
         + sizeof(float) * (size_t)(2 * RQ * (nk_pad + 4) + nk_pad);        // S dP bias
}

__global__ void __launch_bounds__(THREADS)
attention_train_bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ mask,
                                const bf16* __restrict__ dout, bf16* __restrict__ dq,
                                float* __restrict__ row_max, float* __restrict__ row_sum,
                                float* __restrict__ row_di, Views vw, int n, int h,
                                float sm_scale, triad::Dropout dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk_pad = round_up(n, KC);
  const int ldS = nk_pad + 4;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + RQ * LDT;
  bf16* sK = sDO + RQ * LDT;
  bf16* sV = sK + KC * LDT;
  bf16* sHi = sV + KC * LDT;
  bf16* sLo = sHi + RQ * LDT;
  float* sS = reinterpret_cast<float*>(sLo + RQ * LDT);
  float* sDP = sS + RQ * ldS;
  float* sBias = sDP + RQ * ldS;

  const int q0 = blockIdx.x * RQ, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long stat = ((long long)b * h + hh) * n;
  const bf16* kb = k + at(vw.k, b, hh);
  const bf16* vb = v + at(vw.v, b, hh);

  load_rows(sQ, q + at(vw.q, b, hh), vw.q.r, q0, RQ, n, tid);
  load_rows(sDO, dout + at(vw.o, b, hh), vw.o.r, q0, RQ, n, tid);
  for (int j = tid; j < nk_pad; j += THREADS) sBias[j] = key_bias(mask, b, n, j);

  // S = Q K^T and dP = dO V^T over all keys. The 32 x 64 output of a
  // chunk is 2 x 4 tiles: warp w takes row tile w & 1, column tiles
  // 2 (w >> 1) and 2 (w >> 1) + 1 (the same split serves dQ below).
  const int rt = warp & 1, ct0 = (warp >> 1) * 2;
  FragA qa[D / 16], da[D / 16];
  for (int kc = 0; kc < nk_pad; kc += KC) {
    __syncthreads();
    load_rows(sK, kb, vw.k.r, kc, KC, n, tid);
    load_rows(sV, vb, vw.v.r, kc, KC, n, tid);
    __syncthreads();
    if (kc == 0)
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(qa[kk], sQ + rt * 16 * LDT + kk * 16, LDT);
        wmma::load_matrix_sync(da[kk], sDO + rt * 16 * LDT + kk * 16, LDT);
      }
    for (int t = 0; t < 2; ++t) {
      const int ct = ct0 + t;
      FragC s, dp;
      wmma::fill_fragment(s, 0.0f);
      wmma::fill_fragment(dp, 0.0f);
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBT kf, vf;
        wmma::load_matrix_sync(kf, sK + ct * 16 * LDT + kk * 16, LDT);
        wmma::mma_sync(s, qa[kk], kf, s);
        wmma::load_matrix_sync(vf, sV + ct * 16 * LDT + kk * 16, LDT);
        wmma::mma_sync(dp, da[kk], vf, dp);
      }
      wmma::store_matrix_sync(sS + rt * 16 * ldS + kc + ct * 16, s, ldS, wmma::mem_row_major);
      wmma::store_matrix_sync(sDP + rt * 16 * ldS + kc + ct * 16, dp, ldS, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // Per row (warp w owns rows 8w..8w+7): max, sum, P in fp32, di, dS.
  for (int rr = 0; rr < RQ / 4; ++rr) {
    const int r = warp * (RQ / 4) + rr;
    float* srow = sS + r * ldS;
    float* drow = sDP + r * ldS;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float s = srow[j] * sm_scale + sBias[j];
      srow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float di = 0.0f;
    if (!dp.active) {
      for (int j = lane; j < n; j += 32) {
        const float p = srow[j] / sum;
        srow[j] = p;
        di += drow[j] * p;
      }
    } else {
      // dP = dD * keep / (1 - p), replacing dD in place.
      const uint32_t stream = (uint32_t)(b * h + hh), row = (uint32_t)(q0 + r);
      for (int j0 = lane * 4; j0 < n; j0 += 128) {
        const triad::Keep4 kb = triad::keep4(dp.seed, stream, row, (uint32_t)j0 >> 2);
        for (int u = 0; u < 4 && j0 + u < n; ++u) {
          const int j = j0 + u;
          const float p = srow[j] / sum;
          const float dpj = kept(kb, u, dp) ? drow[j] * dp.scale : 0.0f;
          srow[j] = p;
          drow[j] = dpj;
          di += dpj * p;
        }
      }
    }
    di = warp_sum(di);
    for (int j = lane; j < nk_pad; j += 32) drow[j] = j < n ? srow[j] * (drow[j] - di) : 0.0f;
    if (lane == 0 && q0 + r < n) {
      row_max[stat + q0 + r] = m;
      row_sum[stat + q0 + r] = sum;
      row_di[stat + q0 + r] = di;
    }
  }

  // dQ = dS K (times sm_scale at the store), dS split into bf16 halves.
  FragC dqa[2];
  wmma::fill_fragment(dqa[0], 0.0f);
  wmma::fill_fragment(dqa[1], 0.0f);
  for (int kc = 0; kc < nk_pad; kc += KC) {
    __syncthreads();
    load_rows(sK, kb, vw.k.r, kc, KC, n, tid);
    for (int i = tid; i < RQ * KC; i += THREADS) {
      const int r = i / KC, c = i % KC;
      triad::split_bf16(sDP[r * ldS + kc + c], sHi + r * LDT + c, sLo + r * LDT + c);
    }
    __syncthreads();
    for (int kk = 0; kk < KC / 16; ++kk) {
      FragA hi, lo;
      wmma::load_matrix_sync(hi, sHi + rt * 16 * LDT + kk * 16, LDT);
      wmma::load_matrix_sync(lo, sLo + rt * 16 * LDT + kk * 16, LDT);
      for (int t = 0; t < 2; ++t) {
        FragB kf;
        wmma::load_matrix_sync(kf, sK + kk * 16 * LDT + (ct0 + t) * 16, LDT);
        wmma::mma_sync(dqa[t], hi, kf, dqa[t]);
        wmma::mma_sync(dqa[t], lo, kf, dqa[t]);
      }
    }
  }
  __syncthreads();
  for (int t = 0; t < 2; ++t)
    wmma::store_matrix_sync(sS + rt * 16 * ldS + (ct0 + t) * 16, dqa[t], ldS, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < RQ * (D / 2); i += THREADS) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    if (q0 + r >= n) continue;
    *reinterpret_cast<__nv_bfloat162*>(dq + at(vw.dq, b, hh) + (long long)(q0 + r) * vw.dq.r +
                                       c) =
        __floats2bfloat162_rn(sS[r * ldS + c] * sm_scale, sS[r * ldS + c + 1] * sm_scale);
  }
}

// ------------------------------------------------------- backward columns

constexpr size_t COLS_SMEM = sizeof(bf16) * (size_t)(2 * CK * LDT + 2 * CQ * LDT + 4 * CQ * LDT)
                             + sizeof(float) * (size_t)(2 * CQ * LDF + CK + 3 * CQ);

__global__ void __launch_bounds__(THREADS)
attention_train_bwd_cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ mask,
                                const bf16* __restrict__ dout, const float* __restrict__ row_max,
                                const float* __restrict__ row_sum,
                                const float* __restrict__ row_di, bf16* __restrict__ dk,
                                bf16* __restrict__ dv, Views vw, int n, int h, float sm_scale,
                                triad::Dropout dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + CK * LDT;
  bf16* sQ = sV + CK * LDT;
  bf16* sDO = sQ + CQ * LDT;
  bf16* sPhi = sDO + CQ * LDT;
  bf16* sPlo = sPhi + CQ * LDT;
  bf16* sDhi = sPlo + CQ * LDT;
  bf16* sDlo = sDhi + CQ * LDT;
  float* sS = reinterpret_cast<float*>(sDlo + CQ * LDT);
  float* sDP = sS + CQ * LDF;
  float* sBias = sDP + CQ * LDF;
  float* sM = sBias + CK;
  float* sL = sM + CQ;
  float* sDI = sL + CQ;

  const int k0 = blockIdx.x * CK, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long stat = ((long long)b * h + hh) * n;
  const bf16* qb = q + at(vw.q, b, hh);
  const bf16* dob = dout + at(vw.o, b, hh);

  load_rows(sK, k + at(vw.k, b, hh), vw.k.r, k0, CK, n, tid);
  load_rows(sV, v + at(vw.v, b, hh), vw.v.r, k0, CK, n, tid);
  for (int j = tid; j < CK; j += THREADS) sBias[j] = key_bias(mask, b, n, k0 + j);

  // Warp w accumulates dK and dV for keys 16w..16w+15 of the tile.
  FragC dka[D / 16], dva[D / 16];
  for (int t = 0; t < D / 16; ++t) {
    wmma::fill_fragment(dka[t], 0.0f);
    wmma::fill_fragment(dva[t], 0.0f);
  }
  for (int qt = 0; qt < n; qt += CQ) {
    __syncthreads();
    load_rows(sQ, qb, vw.q.r, qt, CQ, n, tid);
    load_rows(sDO, dob, vw.o.r, qt, CQ, n, tid);
    for (int i = tid; i < CQ; i += THREADS) {
      const bool ok = qt + i < n;
      sM[i] = ok ? row_max[stat + qt + i] : 0.0f;
      sL[i] = ok ? row_sum[stat + qt + i] : 1.0f;
      sDI[i] = ok ? row_di[stat + qt + i] : 0.0f;
    }
    __syncthreads();
    // S and dP for this query tile; warp w owns query rows 16w..16w+15.
    {
      FragA qa[D / 16], da[D / 16];
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * LDT + kk * 16, LDT);
        wmma::load_matrix_sync(da[kk], sDO + warp * 16 * LDT + kk * 16, LDT);
      }
      for (int t = 0; t < CK / 16; ++t) {
        FragC s, dp;
        wmma::fill_fragment(s, 0.0f);
        wmma::fill_fragment(dp, 0.0f);
        for (int kk = 0; kk < D / 16; ++kk) {
          FragBT kf, vf;
          wmma::load_matrix_sync(kf, sK + t * 16 * LDT + kk * 16, LDT);
          wmma::mma_sync(s, qa[kk], kf, s);
          wmma::load_matrix_sync(vf, sV + t * 16 * LDT + kk * 16, LDT);
          wmma::mma_sync(dp, da[kk], vf, dp);
        }
        wmma::store_matrix_sync(sS + warp * 16 * LDF + t * 16, s, LDF, wmma::mem_row_major);
        wmma::store_matrix_sync(sDP + warp * 16 * LDF + t * 16, dp, LDF, wmma::mem_row_major);
      }
    }
    __syncwarp();
    // P and dS from the row stats (the same expression as the rows
    // kernel, so P matches it to the bit), split into bf16 halves. With
    // dropout, D = P * keep / (1 - p) takes P's place in dV and dP =
    // dD * keep / (1 - p) enters dS, from the forward's keep bits.
    if (!dp.active) {
      for (int i = lane; i < 16 * CK; i += 32) {
        const int r = warp * 16 + i / CK, c = i % CK;
        float p = 0.0f, ds = 0.0f;
        if (qt + r < n && k0 + c < n) {
          const float s = sS[r * LDF + c] * sm_scale + sBias[c];
          p = expf(s - sM[r]) / sL[r];
          ds = p * (sDP[r * LDF + c] - sDI[r]);
        }
        triad::split_bf16(p, sPhi + r * LDT + c, sPlo + r * LDT + c);
        triad::split_bf16(ds, sDhi + r * LDT + c, sDlo + r * LDT + c);
      }
    } else {
      const uint32_t stream = (uint32_t)(b * h + hh);
      for (int i = lane; i < 16 * CK / 4; i += 32) {
        const int r = warp * 16 + i / (CK / 4), c0 = (i % (CK / 4)) * 4;
        const triad::Keep4 kb =
            triad::keep4(dp.seed, stream, (uint32_t)(qt + r), (uint32_t)(k0 + c0) >> 2);
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + u;
          float d = 0.0f, ds = 0.0f;
          if (qt + r < n && k0 + c < n) {
            const float s = sS[r * LDF + c] * sm_scale + sBias[c];
            const float p = expf(s - sM[r]) / sL[r];
            const bool keep = kept(kb, u, dp);
            d = keep ? p * dp.scale : 0.0f;
            ds = p * ((keep ? sDP[r * LDF + c] * dp.scale : 0.0f) - sDI[r]);
          }
          triad::split_bf16(d, sPhi + r * LDT + c, sPlo + r * LDT + c);
          triad::split_bf16(ds, sDhi + r * LDT + c, sDlo + r * LDT + c);
        }
      }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the tile's query rows.
    for (int kk = 0; kk < CQ / 16; ++kk) {
      FragAT ph, pl, dh, dl;
      wmma::load_matrix_sync(ph, sPhi + kk * 16 * LDT + warp * 16, LDT);
      wmma::load_matrix_sync(pl, sPlo + kk * 16 * LDT + warp * 16, LDT);
      wmma::load_matrix_sync(dh, sDhi + kk * 16 * LDT + warp * 16, LDT);
      wmma::load_matrix_sync(dl, sDlo + kk * 16 * LDT + warp * 16, LDT);
      for (int t = 0; t < D / 16; ++t) {
        FragB of, qf;
        wmma::load_matrix_sync(of, sDO + kk * 16 * LDT + t * 16, LDT);
        wmma::mma_sync(dva[t], ph, of, dva[t]);
        wmma::mma_sync(dva[t], pl, of, dva[t]);
        wmma::load_matrix_sync(qf, sQ + kk * 16 * LDT + t * 16, LDT);
        wmma::mma_sync(dka[t], dh, qf, dka[t]);
        wmma::mma_sync(dka[t], dl, qf, dka[t]);
      }
    }
  }
  __syncthreads();
  for (int t = 0; t < D / 16; ++t) {
    wmma::store_matrix_sync(sS + warp * 16 * LDF + t * 16, dka[t], LDF, wmma::mem_row_major);
    wmma::store_matrix_sync(sDP + warp * 16 * LDF + t * 16, dva[t], LDF, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < CK * (D / 2); i += THREADS) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    if (k0 + r >= n) continue;
    *reinterpret_cast<__nv_bfloat162*>(dk + at(vw.dk, b, hh) + (long long)(k0 + r) * vw.dk.r +
                                       c) =
        __floats2bfloat162_rn(sS[r * LDF + c] * sm_scale, sS[r * LDF + c + 1] * sm_scale);
    *reinterpret_cast<__nv_bfloat162*>(dv + at(vw.dv, b, hh) + (long long)(k0 + r) * vw.dv.r +
                                       c) = __floats2bfloat162_rn(sDP[r * LDF + c],
                                                                  sDP[r * LDF + c + 1]);
  }
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   MAX_SMEM);
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
// dropout: keep iff bits >= thresh, kept values times keep_scale, none
// when active == 0. Returns a cudaError_t.
extern "C" int triad_attention_train_fwd(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, const long long* strides,
                                         int b, int h, int n, float sm_scale, unsigned seed,
                                         unsigned thresh, float keep_scale, int active,
                                         void* stream) {
  if (b <= 0 || h <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(round_up(n, KC));
  int err = prepare(attention_train_fwd_kernel, smem);
  if (err) return err;
  attention_train_fwd_kernel<<<dim3((n + FQ - 1) / FQ, h, b), THREADS, smem,
                               (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (bf16*)out,
      views_of(strides, 4), n, h, sm_scale, triad::Dropout{seed, thresh, keep_scale, active});
  return (int)cudaGetLastError();
}

// Adds dout (the output gradient) and writes dq, dk, dv, all addressed like
// the forward's operands (strides: 3 x 7 in the order q, k, v, dout, dq,
// dk, dv), and the (B, H, N) fp32 row stats scratch (max, sum, di) that
// the second kernel reads; the dropout arguments are the forward's.
// Returns a cudaError_t.
extern "C" int triad_attention_train_bwd(const void* q, const void* k, const void* v,
                                         const void* mask, const void* dout, void* dq,
                                         void* dk, void* dv, void* row_max, void* row_sum,
                                         void* row_di, const long long* strides, int b, int h,
                                         int n, float sm_scale, unsigned seed, unsigned thresh,
                                         float keep_scale, int active, void* stream) {
  if (b <= 0 || h <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const triad::Dropout dp{seed, thresh, keep_scale, active};
  const Views vw = views_of(strides, 7);
  const size_t smem = rows_smem(round_up(n, KC));
  int err = prepare(attention_train_bwd_rows_kernel, smem);
  if (err) return err;
  attention_train_bwd_rows_kernel<<<dim3((n + RQ - 1) / RQ, h, b), THREADS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (const bf16*)dout,
      (bf16*)dq, (float*)row_max, (float*)row_sum, (float*)row_di, vw, n, h, sm_scale, dp);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = prepare(attention_train_bwd_cols_kernel, COLS_SMEM);
  if (err) return err;
  attention_train_bwd_cols_kernel<<<dim3((n + CK - 1) / CK, h, b), THREADS, COLS_SMEM, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (const bf16*)dout,
      (const float*)row_max, (const float*)row_sum, (const float*)row_di, (bf16*)dk, (bf16*)dv,
      vw, n, h, sm_scale, dp);
  return (int)cudaGetLastError();
}

extern "C" int triad_attention_train_max_keys() {
  int nk = KC;
  while (fwd_smem(nk + KC) <= (size_t)MAX_SMEM && rows_smem(nk + KC) <= (size_t)MAX_SMEM)
    nk += KC;
  return nk;
}

// Training attention on the packed (B, N, H*64) layout at p_drop = 0:
// a forward kernel and a recompute backward in two kernels.
//
// Replaces triad_tpu/ops/pallas_attention.py:fused_attention_packed
// (_pk_call :564, pallas_call "fwd" :575 and "bwd" :585), whose
// per-head bodies are _head_fwd (:157) and _head_bwd (:177).
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
//              cap).
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

// ---------------------------------------------------------------- forward

__host__ inline size_t fwd_smem(int nk_pad) {
  return sizeof(bf16) * (size_t)(FQ * LDT + KC * LDT)   // sQ, sKV
         + sizeof(float) * (size_t)FQ * (nk_pad + 4)    // sS
         + sizeof(bf16) * (size_t)FQ * (nk_pad + 8)     // sP
         + sizeof(float) * (size_t)nk_pad;              // sBias
}

__global__ void __launch_bounds__(THREADS)
attention_train_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           bf16* __restrict__ out, int n, int h, float sm_scale) {
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
  const long long rs = (long long)h * D;
  const long long off = (long long)b * n * rs + hh * D;

  load_rows(sQ, q + off, rs, q0, FQ, n, tid);
  for (int j = tid; j < nk_pad; j += THREADS) sBias[j] = key_bias(mask, b, n, j);

  // Pass 1: S = Q K^T, one 64-key chunk at a time; warp w owns rows 16w.
  FragA qa[D / 16];
  for (int kc = 0; kc < nk_pad; kc += KC) {
    __syncthreads();
    load_rows(sKV, k + off, rs, kc, KC, n, tid);
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
    for (int j = lane; j < nk_pad; j += 32) prow[j] = __float2bfloat16(j < n ? srow[j] / sum : 0.0f);
  }

  // Pass 2: O = bf16(P) V, fp32 accumulation.
  FragC o[D / 16];
  for (int t = 0; t < D / 16; ++t) wmma::fill_fragment(o[t], 0.0f);
  for (int kc = 0; kc < nk_pad; kc += KC) {
    __syncthreads();
    load_rows(sKV, v + off, rs, kc, KC, n, tid);
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
    *reinterpret_cast<__nv_bfloat162*>(out + off + (long long)(q0 + r) * rs + c) =
        __floats2bfloat162_rn(orow[c], orow[c + 1]);
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
                                float* __restrict__ row_di, int n, int h, float sm_scale) {
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
  const long long rs = (long long)h * D;
  const long long off = (long long)b * n * rs + hh * D;
  const long long stat = ((long long)b * h + hh) * n;

  load_rows(sQ, q + off, rs, q0, RQ, n, tid);
  load_rows(sDO, dout + off, rs, q0, RQ, n, tid);
  for (int j = tid; j < nk_pad; j += THREADS) sBias[j] = key_bias(mask, b, n, j);

  // S = Q K^T and dP = dO V^T over all keys. The 32 x 64 output of a
  // chunk is 2 x 4 tiles: warp w takes row tile w & 1, column tiles
  // 2 (w >> 1) and 2 (w >> 1) + 1 (the same split serves dQ below).
  const int rt = warp & 1, ct0 = (warp >> 1) * 2;
  FragA qa[D / 16], da[D / 16];
  for (int kc = 0; kc < nk_pad; kc += KC) {
    __syncthreads();
    load_rows(sK, k + off, rs, kc, KC, n, tid);
    load_rows(sV, v + off, rs, kc, KC, n, tid);
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
    for (int j = lane; j < n; j += 32) {
      const float p = srow[j] / sum;
      srow[j] = p;
      di += drow[j] * p;
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
    load_rows(sK, k + off, rs, kc, KC, n, tid);
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
    *reinterpret_cast<__nv_bfloat162*>(dq + off + (long long)(q0 + r) * rs + c) =
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
                                bf16* __restrict__ dv, int n, int h, float sm_scale) {
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
  const long long rs = (long long)h * D;
  const long long off = (long long)b * n * rs + hh * D;
  const long long stat = ((long long)b * h + hh) * n;

  load_rows(sK, k + off, rs, k0, CK, n, tid);
  load_rows(sV, v + off, rs, k0, CK, n, tid);
  for (int j = tid; j < CK; j += THREADS) sBias[j] = key_bias(mask, b, n, k0 + j);

  // Warp w accumulates dK and dV for keys 16w..16w+15 of the tile.
  FragC dka[D / 16], dva[D / 16];
  for (int t = 0; t < D / 16; ++t) {
    wmma::fill_fragment(dka[t], 0.0f);
    wmma::fill_fragment(dva[t], 0.0f);
  }
  for (int qt = 0; qt < n; qt += CQ) {
    __syncthreads();
    load_rows(sQ, q + off, rs, qt, CQ, n, tid);
    load_rows(sDO, dout + off, rs, qt, CQ, n, tid);
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
    // kernel, so P matches it to the bit), split into bf16 halves.
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
    const long long o = off + (long long)(k0 + r) * rs + c;
    *reinterpret_cast<__nv_bfloat162*>(dk + o) =
        __floats2bfloat162_rn(sS[r * LDF + c] * sm_scale, sS[r * LDF + c + 1] * sm_scale);
    *reinterpret_cast<__nv_bfloat162*>(dv + o) =
        __floats2bfloat162_rn(sDP[r * LDF + c], sDP[r * LDF + c + 1]);
  }
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   MAX_SMEM);
}

}  // namespace

// q, k, v, out: contiguous bf16 (B, N, H*64); mask: (B, N) fp32 key mask
// (1 = attend). Returns a cudaError_t.
extern "C" int triad_attention_train_fwd(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, int b, int h, int n,
                                         float sm_scale, void* stream) {
  if (b <= 0 || h <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(round_up(n, KC));
  int err = prepare(attention_train_fwd_kernel, smem);
  if (err) return err;
  attention_train_fwd_kernel<<<dim3((n + FQ - 1) / FQ, h, b), THREADS, smem,
                               (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (bf16*)out, n, h,
      sm_scale);
  return (int)cudaGetLastError();
}

// Adds dout (the output gradient, same layout) and writes dq, dk, dv (same
// layout) and the (B, H, N) fp32 row stats scratch (max, sum, di) that
// the second kernel reads. Returns a cudaError_t.
extern "C" int triad_attention_train_bwd(const void* q, const void* k, const void* v,
                                         const void* mask, const void* dout, void* dq,
                                         void* dk, void* dv, void* row_max, void* row_sum,
                                         void* row_di, int b, int h, int n, float sm_scale,
                                         void* stream) {
  if (b <= 0 || h <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = rows_smem(round_up(n, KC));
  int err = prepare(attention_train_bwd_rows_kernel, smem);
  if (err) return err;
  attention_train_bwd_rows_kernel<<<dim3((n + RQ - 1) / RQ, h, b), THREADS, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (const bf16*)dout,
      (bf16*)dq, (float*)row_max, (float*)row_sum, (float*)row_di, n, h, sm_scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = prepare(attention_train_bwd_cols_kernel, COLS_SMEM);
  if (err) return err;
  attention_train_bwd_cols_kernel<<<dim3((n + CK - 1) / CK, h, b), THREADS, COLS_SMEM, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (const bf16*)dout,
      (const float*)row_max, (const float*)row_sum, (const float*)row_di, (bf16*)dk, (bf16*)dv,
      n, h, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" int triad_attention_train_max_keys() {
  int nk = KC;
  while (fwd_smem(nk + KC) <= (size_t)MAX_SMEM && rows_smem(nk + KC) <= (size_t)MAX_SMEM)
    nk += KC;
  return nk;
}

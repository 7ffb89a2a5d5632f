// Inference attention with delayed normalisation, one (batch, head,
// 64-query tile) per block, for head_dim 64 and up to 512 keys.
//
// Replaces triad_tpu/ops/pallas_attention.py:fused_attention_eval (:366,
// packed (B, N, H*64) q/k/v) and fused_attention_eval_merged (:680, one
// (B, N, 3*H*64) qkv tensor read at column offsets 0, C, 2C). Both TPU
// kernels run _head_eval (:69) per head; this kernel is that body with
// the layouts expressed as row strides, so one kernel serves both. The
// head-pair variants fused_attention_eval_pair (:428) and
// fused_attention_eval_merged_pair (:490) are a mode of it (pair_heads >
// 0): _head_pair_eval (:90) is per-head attention whose block-diagonal
// layout only serves the TPU's 128 lanes, with two numerical differences
// kept here for the heads of a pair: the row sum adds e AFTER its bf16
// rounding (the MXU sums the rounded probabilities), and the output is
// o / sum, a true division. An odd last head keeps _head_eval's numbers.
// The pair adapter pads keys to a multiple of 128 (models/layers.py
// :262-283) with zero k, v and a -1e30 bias; those keys enter the softmax
// here too (nk_soft), which matters only for a row whose keys are all
// masked: its e is 1 on every key, padded ones included.
//
// Numerics kept from _head_eval: S = q.k^T accumulated in fp32, times
// sm_scale, plus a key bias of (1 - mask) * -1e30; row max m; e =
// exp(S - m) in fp32; the row sum of the fp32 e; e rounded to bf16
// before the e.V product (fp32 accumulation); output times 1/sum. The
// max is per (row, head) in both modes.
//
// What bounds it on the card: the full fp32 score row of a 64-query
// tile (64 x 512 x 4 B = 128 KB at HuBERT's 499 keys) lives in shared
// memory, which caps a block per SM at 4 warps. That keeps the exact
// two-pass softmax of the TPU kernel (no running-max rescale, so the
// bf16 rounding of e is the one the TPU kernel does), at the price of
// low occupancy; K and V are staged one 64-key chunk at a time without
// double buffering. A flash-style online softmax would free the shared
// memory but round e against a moving max. The ragged 499/261 edges are
// masked here: out-of-range query rows and keys are zero-filled on load
// and never stored or summed.
#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int D = 64;        // head dim
constexpr int KC = 64;       // keys per staged chunk
constexpr int LDT = D + 8;   // bf16 tile row stride in shared memory
constexpr int THREADS = 128; // 4 warps, 16 query rows each
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ inline size_t smem_bytes(int nk_pad) {
  return sizeof(triad::bf16) * (size_t)(BQ * LDT + KC * LDT)   // sQ, sKV
         + sizeof(float) * (size_t)BQ * (nk_pad + 4)          // sS
         + sizeof(triad::bf16) * (size_t)BQ * (nk_pad + 8)    // sP
         + sizeof(float) * (size_t)(nk_pad + BQ);             // sBias, sInv
}

__global__ void __launch_bounds__(THREADS)
attention_eval_kernel(const triad::bf16* __restrict__ q,
                      const triad::bf16* __restrict__ k,
                      const triad::bf16* __restrict__ v,
                      const float* __restrict__ mask,
                      triad::bf16* __restrict__ out, int nq, int nk, int nk_soft,
                      int pair_heads, long long q_bs, long long q_rs, long long k_bs,
                      long long k_rs, long long v_bs, long long v_rs,
                      long long o_bs, long long o_rs, long long m_bs,
                      float sm_scale) {
  using triad::bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk_pad = round_up(nk_soft, KC);
  const int ldS = nk_pad + 4;
  const int ldP = nk_pad + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + BQ * LDT;
  float* sS = reinterpret_cast<float*>(sKV + KC * LDT);
  bf16* sP = reinterpret_cast<bf16*>(sS + BQ * ldS);
  float* sBias = reinterpret_cast<float*>(sP + BQ * ldP);
  float* sInv = sBias + nk_pad;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bf16* qb = q + b * q_bs + h * D;
  const bf16* kb = k + b * k_bs + h * D;
  const bf16* vb = v + b * v_bs + h * D;

  for (int i = tid; i < BQ * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = q0 + r < nq;
    triad::copy16(sQ + r * LDT + c, ok ? qb + (q0 + r) * q_rs + c : qb, ok);
  }
  for (int j = tid; j < nk_pad; j += THREADS)
    sBias[j] = j < nk ? (1.0f - mask[b * m_bs + j]) * -1e30f : j < nk_soft ? -1e30f : 0.0f;
  const bool pair = h < pair_heads;

  // Pass 1: S = Q K^T, one 64-key chunk at a time.
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
  for (int kc = 0; kc < nk_pad; kc += KC) {
    __syncthreads();
    for (int i = tid; i < KC * (D / 8); i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = kc + r < nk;
      triad::copy16(sKV + r * LDT + c, ok ? kb + (kc + r) * k_rs + c : kb, ok);
    }
    __syncthreads();
    if (kc == 0) {
      for (int kk = 0; kk < D / 16; ++kk)
        wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * LDT + kk * 16, LDT);
    }
    for (int n = 0; n < KC / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sKV + n * 16 * LDT + kk * 16, LDT);
        wmma::mma_sync(acc, qa[kk], kf, acc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * ldS + kc + n * 16, acc, ldS,
                              wmma::mem_row_major);
    }
  }
  __syncwarp();

  // Softmax numerator per row; each warp owns its 16 rows. sInv holds
  // 1 / sum, or the sum of the bf16-rounded e in pair mode.
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    float* srow = sS + r * ldS;
    float m = -INFINITY;
    for (int j = lane; j < nk_soft; j += 32) {
      const float s = srow[j] * sm_scale + sBias[j];
      srow[j] = s;
      m = fmaxf(m, s);
    }
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    bf16* prow = sP + r * ldP;
    for (int j = lane; j < nk_pad; j += 32) {
      const float e = j < nk_soft ? expf(srow[j] - m) : 0.0f;
      const triad::bf16 eb = __float2bfloat16(e);
      sum += pair ? __bfloat162float(eb) : e;
      prow[j] = eb;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) sInv[r] = pair ? sum : 1.0f / sum;
  }

  // Pass 2: O = bf16(e) V, fp32 accumulation.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[D / 16];
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(o[n], 0.0f);
  for (int kc = 0; kc < nk_pad; kc += KC) {
    __syncthreads();
    for (int i = tid; i < KC * (D / 8); i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = kc + r < nk;
      triad::copy16(sKV + r * LDT + c, ok ? vb + (kc + r) * v_rs + c : vb, ok);
    }
    __syncthreads();
    for (int kk = 0; kk < KC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, sP + warp * 16 * ldP + kc + kk * 16, ldP);
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, sKV + kk * 16 * LDT + n * 16, LDT);
        wmma::mma_sync(o[n], pa, vf, o[n]);
      }
    }
  }

  // Delayed normalisation and store; the score rows are free again.
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(sS + warp * 16 * ldS + n * 16, o[n], ldS, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    if (q0 + r >= nq) break;
    const float inv = sInv[r];
    const float* orow_s = sS + r * ldS;
    bf16* orow = out + b * o_bs + (q0 + r) * o_rs + h * D;
    const int c = lane * 2;
    *reinterpret_cast<__nv_bfloat162*>(orow + c) =
        pair ? __floats2bfloat162_rn(orow_s[c] / inv, orow_s[c + 1] / inv)
             : __floats2bfloat162_rn(orow_s[c] * inv, orow_s[c + 1] * inv);
  }
}

}  // namespace

// q, k, v: bf16 rows of H*64 (packed) or views into one merged qkv
// tensor; *_bs / *_rs are batch and row strides in elements. mask:
// (B, >= nk) fp32 key mask, 1 = attend. nk_soft >= nk: keys in the
// softmax, those past nk with zero k, v and a -1e30 bias. pair_heads:
// heads 0 .. pair_heads - 1 take the head-pair numerics (0: none).
// Returns a cudaError_t.
extern "C" int triad_attention_eval(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int b, int h,
                                    int nq, int nk, int nk_soft, int pair_heads,
                                    long long q_bs, long long q_rs,
                                    long long k_bs, long long k_rs, long long v_bs,
                                    long long v_rs, long long o_bs, long long o_rs,
                                    long long m_bs, float sm_scale, void* stream) {
  const size_t smem = smem_bytes(round_up(nk_soft, KC));
  if (smem > (size_t)MAX_SMEM || nq <= 0 || nk <= 0 || nk_soft < nk)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + BQ - 1) / BQ, h, b);
  attention_eval_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const triad::bf16*)q, (const triad::bf16*)k, (const triad::bf16*)v,
      (const float*)mask, (triad::bf16*)out, nq, nk, nk_soft, pair_heads, q_bs, q_rs, k_bs,
      k_rs, v_bs, v_rs, o_bs, o_rs, m_bs, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" int triad_attention_eval_max_keys() {
  int nk = KC;
  while (smem_bytes(nk + KC) <= (size_t)MAX_SMEM) nk += KC;
  return nk;
}

// HuBERT's positional grouped conv1d on the packed (B, N, C) layout: a
// forward kernel (also the dX kernel) and a dW kernel.
//
// Replaces triad_tpu/ops/pallas_posconv.py:pos_conv_gelu: _run_conv
// (:165, pallas_call :170, body _pc_kernel :85), which runs the forward
// and, with the flipped, co/ci-swapped weight (_prep_w_flip :211), dX;
// and _pc_bwd's dW (:270, pallas_call :285, body _dw_kernel :125). The
// TPU kernel takes one batch row per grid step and accumulates dW in VMEM
// across the sequential grid; Hopper blocks run in no order, so here dW
// sums inside one block's loop over every row instead.
//
// Forward, an implicit GEMM per (128-row tile, group, batch row):
//   out[t, o] = act(sum_k sum_i in[t - left + k, g*48 + i] * W[g][k][i][o]
//                   + bias[g*48 + o])
// with the weight prepared as W[g][k][i][o] (bf16), so for each tap k the
// B operand is a contiguous 48 x 48 tile. The block stages the input
// window (its 128 rows + K - 1 more, zero outside [0, N)) once, and
// streams the group's taps in chunks of 8 through a two-stage cp.async
// ring; warp w computes rows 16w .. 16w + 15 against all 48 outputs, one
// 16-deep step per (tap, 16 input channels) on bf16 tensor cores (WMMA)
// with fp32 accumulation; bias and the activation (identity or exact
// GELU) in the epilogue, the output rounded to bf16 once.
// The forward uses left = K / 2 (SAME padding with the even-kernel
// trailing trim); dX uses left = K - 1 - K / 2 and the flipped weight.
//
// dW[g][k][o][i] = sum_b sum_t dz[b, t, g*48 + o] * x[b, t - left + k, g*48 + i]
// (fp32): one block per (8 taps, group), warp w owning tap 8 * blockIdx.x
// + w, walks every batch row and 64-row tile in order and accumulates in
// registers. No atomics, so dW is the same from run to run.
//
// What bounds it on the card: operations. Each pass (forward, dX, dW) is
// 2 * B * N * C * K * 48 = 301.4 GFLOP at (64, 499, 768), K = 128: 0.305 ms
// at the bf16 tensor-core peak; the bytes (x and the output, 98 MB) take
// 0.03 ms. Every forward block re-streams its group's 590 KB of weights
// from L2.
#include "common.cuh"

using namespace nvcuda;

namespace {

using triad::bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr int CPG = 48;        // channels per group (768 / 16)
constexpr int NB = CPG / 16;   // 16-wide blocks of a group's channels
constexpr int TM = 128;        // forward: output rows per block
constexpr int KCH = 8;         // taps per staged weight chunk (and per dW block)
constexpr int RT = 64;         // dW: rows per step
constexpr int THREADS = 256;   // 8 warps
constexpr int LDX = CPG;       // bf16 row stride: 96 B keeps every WMMA row 32-byte aligned
constexpr int LDO = CPG + 4;   // fp32 epilogue row stride
constexpr int WCHUNK = KCH * CPG * CPG;  // bf16 elements of one weight chunk
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline size_t fwd_smem(int k) {
  return sizeof(bf16) * ((size_t)(TM + k) * LDX + 2 * (size_t)WCHUNK);
}

__global__ void __launch_bounds__(THREADS)
posconv_kernel(const bf16* __restrict__ in, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out, int nin, int nout, int c,
               int k, int left, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sW = sX + (size_t)(TM + k) * LDX;
  float* sO = reinterpret_cast<float*>(sW);  // epilogue reuses the ring

  const int t0 = blockIdx.x * TM, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;
  const bf16* wg = w + (size_t)g * k * CPG * CPG;

  // The input window: rows t0 - left .. t0 - left + TM + k - 2.
  for (int i = tid; i < (TM + k - 1) * (CPG / 8); i += THREADS) {
    const int r = i / (CPG / 8), c8 = (i % (CPG / 8)) * 8;
    const int src = t0 - left + r;
    const bool ok = src >= 0 && src < nin;
    triad::cp_async16(sX + r * LDX + c8,
                      ok ? in + ((long long)b * nin + src) * c + g * CPG + c8 : in, ok);
  }
  auto load_chunk = [&](int stage, int chunk) {
    const bf16* src = wg + (size_t)chunk * WCHUNK;
    bf16* dst = sW + stage * WCHUNK;
    for (int i = tid; i < WCHUNK / 8; i += THREADS) triad::cp_async16(dst + i * 8, src + i * 8, true);
  };
  load_chunk(0, 0);
  triad::cp_async_commit();

  FragC acc[NB];
  for (int f = 0; f < NB; ++f) wmma::fill_fragment(acc[f], 0.0f);
  const int nchunks = k / KCH;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int s = ci & 1;
    triad::cp_async_wait<0>();
    __syncthreads();  // chunk ci landed; chunk ci - 1 fully consumed
    if (ci + 1 < nchunks) {
      load_chunk(s ^ 1, ci + 1);
      triad::cp_async_commit();
    }
    const bf16* ws = sW + s * WCHUNK;
    for (int kk = 0; kk < KCH; ++kk) {
      const int tap = ci * KCH + kk;
      for (int cs = 0; cs < NB; ++cs) {
        FragA a;
        wmma::load_matrix_sync(a, sX + (warp * 16 + tap) * LDX + cs * 16, LDX);
        for (int f = 0; f < NB; ++f) {
          FragB bw;
          wmma::load_matrix_sync(bw, ws + (kk * CPG + cs * 16) * CPG + f * 16, CPG);
          wmma::mma_sync(acc[f], a, bw, acc[f]);
        }
      }
    }
  }
  __syncthreads();
  for (int f = 0; f < NB; ++f)
    wmma::store_matrix_sync(sO + warp * 16 * LDO + f * 16, acc[f], LDO, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TM * (CPG / 2); i += THREADS) {
    const int r = i / (CPG / 2), cc = (i % (CPG / 2)) * 2;
    if (t0 + r >= nout) continue;
    float v0 = sO[r * LDO + cc], v1 = sO[r * LDO + cc + 1];
    if (bias != nullptr) {
      v0 += bias[g * CPG + cc];
      v1 += bias[g * CPG + cc + 1];
    }
    if (act) {
      v0 = triad::gelu_erf(v0);
      v1 = triad::gelu_erf(v1);
    }
    *reinterpret_cast<__nv_bfloat162*>(out + ((long long)b * nout + t0 + r) * c + g * CPG + cc) =
        __floats2bfloat162_rn(v0, v1);
  }
}

__global__ void __launch_bounds__(THREADS)
posconv_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dz,
                  float* __restrict__ dw, int batch, int n, int c, int k, int left) {
  __shared__ __align__(128) bf16 sDZ[RT * LDX];
  __shared__ __align__(128) bf16 sX[(RT + KCH) * LDX];
  const int kc = blockIdx.x * KCH, g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32;

  FragC acc[NB][NB];  // (output block, input block) of tap kc + warp
  for (int ob = 0; ob < NB; ++ob)
    for (int ib = 0; ib < NB; ++ib) wmma::fill_fragment(acc[ob][ib], 0.0f);
  for (int b = 0; b < batch; ++b) {
    for (int t0 = 0; t0 < n; t0 += RT) {
      __syncthreads();
      for (int i = tid; i < RT * (CPG / 8); i += THREADS) {
        const int r = i / (CPG / 8), c8 = (i % (CPG / 8)) * 8;
        const bool ok = t0 + r < n;
        triad::copy16(sDZ + r * LDX + c8,
                      ok ? dz + ((long long)b * n + t0 + r) * c + g * CPG + c8 : dz, ok);
      }
      // x rows t0 - left + kc .. + RT + KCH - 2 (row r of the tile at tap
      // kc + w reads window row r + w).
      for (int i = tid; i < (RT + KCH - 1) * (CPG / 8); i += THREADS) {
        const int r = i / (CPG / 8), c8 = (i % (CPG / 8)) * 8;
        const int src = t0 - left + kc + r;
        const bool ok = src >= 0 && src < n;
        triad::copy16(sX + r * LDX + c8,
                      ok ? x + ((long long)b * n + src) * c + g * CPG + c8 : x, ok);
      }
      __syncthreads();
      for (int rs = 0; rs < RT / 16; ++rs) {
        FragAT a[NB];
        for (int ob = 0; ob < NB; ++ob)
          wmma::load_matrix_sync(a[ob], sDZ + rs * 16 * LDX + ob * 16, LDX);
        for (int ib = 0; ib < NB; ++ib) {
          FragB bx;
          wmma::load_matrix_sync(bx, sX + (rs * 16 + warp) * LDX + ib * 16, LDX);
          for (int ob = 0; ob < NB; ++ob) wmma::mma_sync(acc[ob][ib], a[ob], bx, acc[ob][ib]);
        }
      }
    }
  }
  float* out = dw + ((size_t)g * k + kc + warp) * CPG * CPG;
  for (int ob = 0; ob < NB; ++ob)
    for (int ib = 0; ib < NB; ++ib)
      wmma::store_matrix_sync(out + ob * 16 * CPG + ib * 16, acc[ob][ib], CPG,
                              wmma::mem_row_major);
}

}  // namespace

// in (B, nin, c), out (B, nout, c): contiguous bf16; w: bf16 (c / 48, k, 48,
// 48) as W[g][k][i][o]; bias: fp32 (c) or null; act 0 = identity, 1 =
// exact GELU. c % 48 == 0, k % 8 == 0. Returns a cudaError_t.
extern "C" int triad_posconv(const void* in, const void* w, const void* bias, void* out,
                             int batch, int nin, int nout, int c, int k, int left, int act,
                             void* stream) {
  if (batch <= 0 || nin <= 0 || nout <= 0 || c % CPG || k % KCH || k <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(k);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(posconv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  posconv_kernel<<<dim3((nout + TM - 1) / TM, c / CPG, batch), THREADS, smem,
                   (cudaStream_t)stream>>>((const bf16*)in, (const bf16*)w, (const float*)bias,
                                           (bf16*)out, nin, nout, c, k, left, act);
  return (int)cudaGetLastError();
}

// x, dz: contiguous bf16 (B, n, c); dw: fp32 (c / 48, k, 48, 48) as
// dW[g][k][o][i]. c % 48 == 0, k % 8 == 0. Returns a cudaError_t.
extern "C" int triad_posconv_dw(const void* x, const void* dz, void* dw, int batch, int n, int c,
                                int k, int left, void* stream) {
  if (batch <= 0 || n <= 0 || c % CPG || k % KCH || k <= 0) return (int)cudaErrorInvalidValue;
  posconv_dw_kernel<<<dim3(k / KCH, c / CPG), THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)dz, (float*)dw, batch, n, c, k, left);
  return (int)cudaGetLastError();
}

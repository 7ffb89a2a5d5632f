// HuBERT conv waveform frontend (7 bias-free convs, kernels 10,3,3,3,3,2,2,
// strides 5,2,2,2,2,2,2, 512 channels), as three kernels:
//
//   frontend_stats_kernel   conv_0 per-(batch, channel) sum and sum of
//                           squares over every time step, fp32, for the
//                           GroupNorm. Replaces pallas_frontend.py:
//                           conv0_stats (:324; _stats_gram_kernel :268,
//                           _stats_kernel :246).
//   frontend_conv0_kernel   conv_0 (bf16 operands, fp32 accumulation),
//                           the folded GroupNorm affine, bf16 rounding,
//                           GELU -> bf16 activation (T0, 512).
//   frontend_conv_kernel    one stride-2 conv (k in {2, 3}) as a GEMM,
//                           GELU epilogue -> bf16 (Tout, 512).
//
// The last two replace pallas_frontend.py:monolithic_frontend (:471;
// _main_kernel :440, _stride2_layer :208), launched once per layer.
//
// Why not one kernel as on the TPU: one output token's receptive field
// after conv_0 is 79 rows x 512 channels, and an 8-token tile needs about
// 527 KB of conv_0 activation, more than an SM's 227 KB. So the
// intermediates go to device memory (bf16), one launch per layer.
//
// GELU placement: _stride2_layer applies GELU to each layer's INPUT
// (gelu(bf16 y) -> bf16) and the final GELU to the last output. Each
// stored activation here is that same value, bf16(gelu(float(bf16(y)))),
// computed once in the producing kernel's epilogue instead of once per
// consuming output tile; the arithmetic is identical.
//
// A stride-2 conv with k taps over a row-major (T, 512) activation is a
// GEMM whose A operand is the activation viewed with a leading dimension
// of 2 * 512 and a depth of k * 512: window t covers input rows 2t ..
// 2t + k - 1, which are contiguous. No im2col copy is made. B is the
// conv weight as (k * 512, 512) row-major (tap-major, then input channel).
//
// What bounds it on the card: the stride-2 GEMMs hold ~99% of the
// frontend's FLOPs (about 390 GFLOP at B = 8, 10 s); they run on WMMA
// bf16 tensor-core tiles of 128 x 128 x 32 with a two-stage cp.async
// ring. The stats and conv_0 kernels are FMA loops over a shared-memory
// window of the waveform; conv_0 writes the largest activation (B x
// 31999 x 512 bf16), so it is bound by that write.
#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int C = 512;

// ---------------------------------------------------------------- stats
constexpr int ST_T = 256;  // conv_0 outputs per block

__global__ void __launch_bounds__(256)
frontend_stats_kernel(const float* __restrict__ wave, long long wave_bs,
                      const float* __restrict__ w0, float* __restrict__ sum,
                      float* __restrict__ sumsq, int m0) {
  __shared__ float sw[ST_T * 5 + 5];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * ST_T;
  const int nt = min(ST_T, m0 - t0);
  const float* wb = wave + b * wave_bs + 5LL * t0;
  const int ns = 5 * (nt - 1) + 10;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) sw[i] = wb[i];
  const int c = 2 * threadIdx.x;
  float wa[10], wc[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    wa[j] = w0[j * C + c];
    wc[j] = w0[j * C + c + 1];
  }
  __syncthreads();
  float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
  for (int t = 0; t < nt; ++t) {
    const float* xs = sw + 5 * t;
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      y0 = fmaf(xs[j], wa[j], y0);
      y1 = fmaf(xs[j], wc[j], y1);
    }
    s0 += y0;
    s1 += y1;
    q0 = fmaf(y0, y0, q0);
    q1 = fmaf(y1, y1, q1);
  }
  atomicAdd(sum + b * C + c, s0);
  atomicAdd(sum + b * C + c + 1, s1);
  atomicAdd(sumsq + b * C + c, q0);
  atomicAdd(sumsq + b * C + c + 1, q1);
}

// ---------------------------------------------------------------- conv_0
constexpr int C0_T = 64;  // conv_0 outputs per block

__global__ void __launch_bounds__(256)
frontend_conv0_kernel(const float* __restrict__ wave, long long wave_bs,
                      const float* __restrict__ w0, const float* __restrict__ scale,
                      const float* __restrict__ bias, triad::bf16* __restrict__ y, int m0,
                      int tanh_form) {
  __shared__ float sw[C0_T * 5 + 5];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * C0_T;
  const int nt = min(C0_T, m0 - t0);
  const float* wb = wave + b * wave_bs + 5LL * t0;
  const int ns = 5 * (nt - 1) + 10;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) sw[i] = triad::round_bf16(wb[i]);
  const int c = 2 * threadIdx.x;
  float wa[10], wc[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    wa[j] = triad::round_bf16(w0[j * C + c]);
    wc[j] = triad::round_bf16(w0[j * C + c + 1]);
  }
  const float sa = scale[b * C + c], sc = scale[b * C + c + 1];
  const float ba = bias[b * C + c], bc = bias[b * C + c + 1];
  __syncthreads();
  triad::bf16* yb = y + ((long long)b * m0 + t0) * C + c;
  for (int t = 0; t < nt; ++t) {
    const float* xs = sw + 5 * t;
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      y0 = fmaf(xs[j], wa[j], y0);
      y1 = fmaf(xs[j], wc[j], y1);
    }
    const float z0 = triad::round_bf16(y0 * sa + ba);
    const float z1 = triad::round_bf16(y1 * sc + bc);
    *reinterpret_cast<__nv_bfloat162*>(yb + (long long)t * C) = __floats2bfloat162_rn(
        triad::gelu(z0, tanh_form), triad::gelu(z1, tanh_form));
  }
}

// ------------------------------------------------------- stride-2 conv GEMM
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA = BK + 8, LDB = BN + 8, LDE = 16 + 4;
constexpr int THREADS = 256;  // 8 warps: 4 (M) x 2 (N), 32 x 64 each

__global__ void __launch_bounds__(THREADS)
frontend_conv_kernel(const triad::bf16* __restrict__ x, long long x_bs,
                     const triad::bf16* __restrict__ w, triad::bf16* __restrict__ y,
                     int tout, int ktaps, int tanh_form) {
  using triad::bf16;
  __shared__ __align__(128) bf16 sA[2][BM * LDA];
  __shared__ __align__(128) bf16 sB[2][BK * LDB];
  __shared__ __align__(128) float sE[8][16 * LDE];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp >> 1, wn = warp & 1;
  const int K = ktaps * C;
  const bf16* xa = x + b * x_bs;

  auto load = [&](int stage, int k0) {
    // A: 128 rows x 32 cols = 512 16-byte vectors, 2 per thread.
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = m0 + r < tout;
      triad::cp_async16(&sA[stage][r * LDA + c],
                        ok ? xa + (long long)(m0 + r) * (2 * C) + k0 + c : xa, ok);
    }
    // B: 32 rows x 128 cols = 512 vectors, 2 per thread.
    for (int i = tid; i < BK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      triad::cp_async16(&sB[stage][r * LDB + c], w + (long long)(k0 + r) * C + n0 + c, true);
    }
    triad::cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nkt = K / BK;
  load(0, 0);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load((kt + 1) & 1, (kt + 1) * BK);
      triad::cp_async_wait<1>();
    } else {
      triad::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a_s = sA[kt & 1];
    const bf16* b_s = sB[kt & 1];
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], a_s + (wm * 32 + i * 16) * LDA + kk, LDA);
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, b_s + kk * LDB + wn * 64 + j * 16, LDB);
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16 x 16 staging tile: bf16 rounding,
  // GELU, bf16 store (8 channels = 16 bytes per lane).
  float* e = sE[warp];
  const int er = lane >> 1, ec = (lane & 1) * 8;
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(e, acc[i][j], LDE, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * 32 + i * 16 + er;
      if (row < tout) {
        __align__(16) bf16 out[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          out[q] = __float2bfloat16(triad::gelu(triad::round_bf16(e[er * LDE + ec + q]), tanh_form));
        bf16* dst = y + ((long long)b * tout + row) * C + n0 + wn * 64 + j * 16 + ec;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// wave: (B, >= 5 * (m0 - 1) + 10) fp32 with batch stride wave_bs; w0:
// (10, 512) fp32; sum, sumsq: (B, 512) fp32, zeroed by the caller (the
// blocks add into them atomically). Returns a cudaError_t.
extern "C" int triad_frontend_stats(const void* wave, long long wave_bs, const void* w0,
                                    void* sum, void* sumsq, int b, int m0, void* stream) {
  if (m0 <= 0 || b <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((m0 + ST_T - 1) / ST_T, b);
  frontend_stats_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)wave, wave_bs, (const float*)w0, (float*)sum, (float*)sumsq, m0);
  return (int)cudaGetLastError();
}

// scale, bias: (B, 512) fp32 folded GroupNorm affine; y: (B, m0, 512) bf16.
extern "C" int triad_frontend_conv0(const void* wave, long long wave_bs, const void* w0,
                                    const void* scale, const void* bias, void* y, int b,
                                    int m0, int tanh_form, void* stream) {
  if (m0 <= 0 || b <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((m0 + C0_T - 1) / C0_T, b);
  frontend_conv0_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)wave, wave_bs, (const float*)w0, (const float*)scale,
      (const float*)bias, (triad::bf16*)y, m0, tanh_form);
  return (int)cudaGetLastError();
}

// x: (B, tin, 512) bf16 contiguous; w: (ktaps * 512, 512) bf16; y: (B,
// tout, 512) bf16 with tout = (tin - ktaps) / 2 + 1.
extern "C" int triad_frontend_conv(const void* x, int tin, const void* w, void* y, int b,
                                   int tout, int ktaps, int tanh_form, void* stream) {
  if (tout <= 0 || b <= 0 || ktaps < 1 || (tin - ktaps) / 2 + 1 != tout)
    return (int)cudaErrorInvalidValue;
  dim3 grid((tout + BM - 1) / BM, C / BN, b);
  frontend_conv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const triad::bf16*)x, (long long)tin * C, (const triad::bf16*)w, (triad::bf16*)y, tout,
      ktaps, tanh_form);
  return (int)cudaGetLastError();
}

// HuBERT conv waveform frontend (7 bias-free convs, kernels 10,3,3,3,3,2,2,
// strides 5,2,2,2,2,2,2, 512 channels), as three kernels:
//
//   frontend_stats_kernel   conv_0 per-(batch, channel) sum and sum of
//                           squares over every time step, fp32, for the
//                           GroupNorm: one partial per block of 256 steps,
//                           summed by the caller in a fixed order (no
//                           atomics, the same sums every run). Replaces pallas_frontend.py:
//                           conv0_stats (:324; _stats_gram_kernel :268,
//                           _stats_kernel :246).
//   frontend_conv0_kernel   conv_0 (bf16 operands, fp32 accumulation),
//                           the folded GroupNorm affine, bf16 rounding,
//                           GELU -> bf16 activation (T0, 512).
//   gemm_kernel             one stride-2 conv (k in {2, 3}) as
//   (conv_s2.cuh)           conv_s2.cuh's GEMM with a GELU epilogue ->
//                           bf16 (Tout, 512).
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
// GEMM of depth k * 512 whose A operand is read straight from the
// activation (window t covers input rows 2t .. 2t + k - 1; no im2col
// copy) and whose B is the conv weight as (512, k * 512) row-major
// (output channel, then tap, then input channel): conv_s2.cuh.
//
// What bounds it on the card: the stride-2 GEMMs hold ~99% of the
// frontend's FLOPs (about 390 GFLOP at B = 8, 10 s), so operations; they
// run conv_s2.cuh's persistent TMA + wgmma GEMM. The stats and conv_0
// kernels are FMA loops over a shared-memory window of the waveform;
// conv_0 writes the largest activation (B x 31999 x 512 bf16), so it is
// bound by that write.
#include "common.cuh"
#include "conv_s2.cuh"

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
  const long long o = ((long long)b * gridDim.x + blockIdx.x) * C + c;
  sum[o] = s0;
  sum[o + 1] = s1;
  sumsq[o] = q0;
  sumsq[o + 1] = q1;
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
// The GEMM is conv_s2.cuh's; its epilogue rounds the fp32 sum to bf16,
// applies the GELU and stores bf16.
struct GeluEpilogue {
  int tanh_form;
  __device__ triad::bf16 operator()(float v) const {
    return __float2bfloat16(triad::gelu(triad::round_bf16(v), tanh_form));
  }
};

}  // namespace

// wave: (B, >= 5 * (m0 - 1) + 10) fp32 with batch stride wave_bs; w0:
// (10, 512) fp32; sum, sumsq: (B, ceil(m0 / 256), 512) fp32, each block's
// partial sums over its 256 conv_0 steps. Returns a cudaError_t.
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

// x: (B, tin, 512) bf16 contiguous; w: (512, ktaps * 512) bf16 (output
// channel, tap, input channel); y: (B, tout, 512) bf16 with tout = (tin -
// ktaps) / 2 + 1.
extern "C" int triad_frontend_conv(const void* x, int tin, const void* w, void* y, int b,
                                   int tout, int ktaps, int tanh_form, void* stream) {
  if (tout <= 0 || b <= 0 || ktaps < 1 || (tin - ktaps) / 2 + 1 != tout)
    return (int)cudaErrorInvalidValue;
  return triad::conv_s2::launch((const triad::bf16*)x, (long long)tin * C, C,
                                (const triad::bf16*)w, C, (triad::bf16*)y, b, tout, ktaps,
                                triad::conv_s2::NoPrologue{}, GeluEpilogue{tanh_form},
                                (cudaStream_t)stream);
}

// HuBERT's frontend after conv_0 with the input activation fused into the
// conv, and that activation as a pass of its own:
//
//   frontend_conv_fused_kernel  y = conv_s2(prologue(x[:, :t_logical]), w),
//                               a stride-2 VALID conv (k in {2, 3}) whose
//                               input goes through the prologue on its way
//                               to the tensor cores: None, GELU, or the
//                               GroupNorm affine with external per-(b, c)
//                               stats and then GELU. Replaces
//                               triad_tpu/ops/pallas_conv.py:fused_frontend_conv
//                               (_pallas_call :177, pallas_call :195;
//                               _kernel :106).
//   frontend_act_kernel         one elementwise pass, GELU or GroupNorm
//                               affine + GELU. Replaces pallas_conv.py:
//                               pallas_activation (_act_call :228,
//                               pallas_call :232; _act_kernel :215).
//
// Numerics of both TPU kernels: the prologue in fp32 on the bf16 input,
// (x - mean) * rstd * scale + bias in that order (each operation rounded
// on its own, no contraction into an fma), the exact GELU (erff; the TPU
// kernel carries an A&S erf of error 1.5e-7), rounded to bf16 before the
// products; fp32 accumulation; the output rounded to bf16.
//
// The TPU kernel's alignment scheme (8-row aligned sub-blocks, a margin of
// garbage rows, a zero-padded waveform) serves Mosaic's tiling and is not
// carried over: the wrapper passes logical lengths and the kernel writes
// exactly the tout = (t_logical - k) / 2 + 1 real rows, reading only rows
// below t_logical.
//
// What bounds it on the card: at conv_1's shape, (8, 31999, 512) -> (8,
// 15999, 512) with k = 3, the products (201 GFLOP) on bf16 tensor cores,
// 0.2 ms at the peak. The GEMM is conv_s2.cuh's (the plain conv's of
// frontend.cu), and the prologue rewrites each staged 128 x 32 input tile
// in shared memory before its products: the activated input never reaches
// device memory, at the price of recomputing it once per 128 output
// channels (4 times at 512) and per window that reads the row (1.5 times
// at k = 3). The activation pass reads and writes each element once and
// is bound by those bytes.
#include "common.cuh"
#include "conv_s2.cuh"

namespace {

using triad::bf16;
using triad::conv_s2::BK;
using triad::conv_s2::BM;
using triad::conv_s2::BN;
using triad::conv_s2::LDA;
using triad::conv_s2::THREADS;

enum Mode { kNone = 0, kGelu = 1, kNormGelu = 2 };

__device__ __forceinline__ float activate(float x, int mode, float mean, float rstd, float scale,
                                          float bias) {
  if (mode == kNormGelu)
    x = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), scale), bias);
  return mode == kNone ? x : triad::gelu_erf(x);
}

// The prologue on a staged A tile: thread tid owns depth column tid % BK
// (one input channel) of rows tid / BK, tid / BK + 8, ...
struct InputPrologue {
  static constexpr bool kActive = true;
  int mode, cin;
  const float* mean;  // (cin,) of this batch row
  const float* rstd;
  const float* scale;  // (cin,)
  const float* bias;

  __device__ void operator()(bf16* tile, int k0, int tid) const {
    if (mode == kNone) return;
    const int c = tid % BK;
    const int ch = k0 % cin + c;
    float mu = 0.0f, rs = 1.0f, sc = 1.0f, bi = 0.0f;
    if (mode == kNormGelu) {
      mu = mean[ch];
      rs = rstd[ch];
      sc = scale[ch];
      bi = bias[ch];
    }
    for (int r = tid / BK; r < BM; r += THREADS / BK) {
      bf16* p = tile + r * LDA + c;
      *p = __float2bfloat16(activate(__bfloat162float(*p), mode, mu, rs, sc, bi));
    }
  }
};

struct StoreEpilogue {
  __device__ bf16 operator()(float v) const { return __float2bfloat16(v); }
};

__global__ void __launch_bounds__(THREADS)
frontend_conv_fused_kernel(const bf16* __restrict__ x, long long x_bs, int cin,
                           const bf16* __restrict__ w, int cout, bf16* __restrict__ y, int tout,
                           int ktaps, int mode, const float* __restrict__ mean,
                           const float* __restrict__ rstd, const float* __restrict__ scale,
                           const float* __restrict__ bias) {
  const int b = blockIdx.z;
  const InputPrologue prologue{mode, cin, mean + (long long)b * cin, rstd + (long long)b * cin,
                               scale, bias};
  triad::conv_s2::gemm_tile(x + b * x_bs, cin, w, cout, y + (long long)b * tout * cout, tout,
                            ktaps, prologue, StoreEpilogue{});
}

// Eight channels (16 bytes) per thread and step; c % 8 == 0, so the eight
// share one batch row.
__global__ void __launch_bounds__(256)
frontend_act_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, long long n8,
                    long long per_batch, int c, int mode, const float* __restrict__ mean,
                    const float* __restrict__ rstd, const float* __restrict__ scale,
                    const float* __restrict__ bias) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e0 = i * 8;
    const long long b = e0 / per_batch;
    const int ch0 = (int)(e0 % c);
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
    __align__(16) bf16 out[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int ch = ch0 + q;
      float mu = 0.0f, rs = 1.0f, sc = 1.0f, bi = 0.0f;
      if (mode == kNormGelu) {
        mu = mean[b * c + ch];
        rs = rstd[b * c + ch];
        sc = scale[ch];
        bi = bias[ch];
      }
      out[q] = __float2bfloat16(activate(__bfloat162float(v[q]), mode, mu, rs, sc, bi));
    }
    reinterpret_cast<uint4*>(y)[i] = *reinterpret_cast<const uint4*>(out);
  }
}

}  // namespace

// x: (B, >= t_logical, cin) bf16 with unit channel stride, row stride cin
// and batch stride x_bs; w: (ktaps * cin, cout) bf16; y: (B, tout, cout)
// bf16 contiguous, tout = (t_logical - ktaps) / 2 + 1 (the wrapper's
// out_rows). mode 0 / 1 / 2 = None / "gelu" / "norm_gelu"; mean, rstd:
// (B, cin) fp32, scale, bias: (cin,) fp32, read by "norm_gelu" only.
// cin a multiple of 32, cout of 128. Returns a cudaError_t.
extern "C" int triad_frontend_conv_fused(const void* x, long long x_bs, int cin, const void* w,
                                         int cout, void* y, int b, int tout, int ktaps, int mode,
                                         const void* mean, const void* rstd, const void* scale,
                                         const void* bias, void* stream) {
  if (tout <= 0 || b <= 0 || ktaps < 1 || cin % BK || cout % BN || mode < kNone ||
      mode > kNormGelu)
    return (int)cudaErrorInvalidValue;
  dim3 grid((tout + BM - 1) / BM, cout / BN, b);
  frontend_conv_fused_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, x_bs, cin, (const bf16*)w, cout, (bf16*)y, tout, ktaps, mode,
      (const float*)mean, (const float*)rstd, (const float*)scale, (const float*)bias);
  return (int)cudaGetLastError();
}

// x, y: (B, t, c) bf16 contiguous, c a multiple of 8; mode, mean, rstd,
// scale, bias as above.
extern "C" int triad_frontend_act(const void* x, void* y, int b, long long t, int c, int mode,
                                  const void* mean, const void* rstd, const void* scale,
                                  const void* bias, void* stream) {
  if (b <= 0 || t <= 0 || c <= 0 || c % 8 || mode < kNone || mode > kNormGelu)
    return (int)cudaErrorInvalidValue;
  const long long n8 = (long long)b * t * c / 8;
  const long long blocks = (n8 + 255) / 256;
  frontend_act_kernel<<<(unsigned)(blocks < 132 * 32 ? blocks : 132 * 32), 256, 0,
                        (cudaStream_t)stream>>>((const bf16*)x, (bf16*)y, n8, t * c, c, mode,
                                                (const float*)mean, (const float*)rstd,
                                                (const float*)scale, (const float*)bias);
  return (int)cudaGetLastError();
}

// HuBERT's frontend after conv_0 with the input activation fused into the
// conv, and that activation as a pass of its own:
//
//   gemm_kernel (conv_s2.cuh)   y = conv_s2(prologue(x[:, :t_logical]), w),
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
// 0.2036 ms at the peak. The GEMM is conv_s2.cuh's TMA + wgmma GEMM (the
// plain conv's of frontend.cu), and the prologue rewrites each staged 64 x
// 64 input slice of a consumer warpgroup in shared memory before its
// products: the activated input never reaches device memory, at the price
// of recomputing it once per 256 output channels (twice at 512) and per
// window that reads the row (1.5 times at k = 3). That is ~30 fp32
// operations (an erff) per staged element on the CUDA cores beside the
// 256 products per element on the tensor cores. The activation pass reads
// and writes each element once and is bound by those bytes.
#include "common.cuh"
#include "conv_s2.cuh"

namespace {

using triad::bf16;

enum Mode { kNone = 0, kGelu = 1, kNormGelu = 2 };

__device__ __forceinline__ float activate(float x, int mode, float mean, float rstd, float scale,
                                          float bias) {
  if (mode == kNormGelu)
    x = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), scale), bias);
  return mode == kNone ? x : triad::gelu_erf(x);
}

// The prologue on the staged input, in fp32, rounded to bf16 by the GEMM
// afterwards: coef reads the norm's per-channel values of channels ch0 ..
// ch0 + 7 of batch row b once, apply activates 8 values of them.
struct InputPrologue {
  int mode, cin;
  const float* mean;  // (B, cin)
  const float* rstd;
  const float* scale;  // (cin,)
  const float* bias;

  struct Coef {
    float mu[8], rs[8], sc[8], bi[8];
  };
  __device__ bool active() const { return mode != kNone; }
  __device__ Coef coef(int b, int ch0) const {
    Coef k;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      k.mu[q] = 0.0f;
      k.rs[q] = 1.0f;
      k.sc[q] = 1.0f;
      k.bi[q] = 0.0f;
    }
    if (mode == kNormGelu) {
      const long long row = (long long)b * cin + ch0;
#pragma unroll
      for (int q = 0; q < 8; q += 4) {  // 16-byte loads: ch0 % 8 == 0
        put4(k.mu + q, mean + row + q);
        put4(k.rs + q, rstd + row + q);
        put4(k.sc + q, scale + ch0 + q);
        put4(k.bi + q, bias + ch0 + q);
      }
    }
    return k;
  }
  static __device__ void put4(float* dst, const float* src) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __device__ void apply(const Coef& k, float (&f)[8]) const {
#pragma unroll
    for (int q = 0; q < 8; ++q) f[q] = activate(f[q], mode, k.mu[q], k.rs[q], k.sc[q], k.bi[q]);
  }
};

struct StoreEpilogue {
  __device__ bf16 operator()(float v) const { return __float2bfloat16(v); }
};

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
// and batch stride x_bs (a multiple of 8); w: (cout, ktaps * cin) bf16
// (output channel, tap, input channel); y: (B, tout, cout) bf16
// contiguous, tout = (t_logical - ktaps) / 2 + 1 (the wrapper's out_rows):
// rows past 2 (tout - 1) + ktaps are never read. mode 0 / 1 / 2 = None /
// "gelu" / "norm_gelu"; mean, rstd: (B, cin) fp32, scale, bias: (cin,)
// fp32, read by "norm_gelu" only. cin a multiple of 64, cout of 256.
// Returns a cudaError_t.
extern "C" int triad_frontend_conv_fused(const void* x, long long x_bs, int cin, const void* w,
                                         int cout, void* y, int b, int tout, int ktaps, int mode,
                                         const void* mean, const void* rstd, const void* scale,
                                         const void* bias, void* stream) {
  if (mode < kNone || mode > kNormGelu) return (int)cudaErrorInvalidValue;
  const InputPrologue prologue{mode, cin, (const float*)mean, (const float*)rstd,
                               (const float*)scale, (const float*)bias};
  return triad::conv_s2::launch((const bf16*)x, x_bs, cin, (const bf16*)w, cout, (bf16*)y, b,
                                tout, ktaps, prologue, StoreEpilogue{}, (cudaStream_t)stream);
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

// Shared helpers for the triad_tpu_torch CUDA kernels (sm_90a).
//
// Every kernel file exposes plain C entry points that take raw device
// pointers and a cudaStream_t, launch on that stream, and return
// cudaGetLastError() so the ctypes wrapper can raise on a refused
// launch. Nothing here allocates or synchronises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace triad {

using bf16 = __nv_bfloat16;

// tanh-form GELU, fp32 (triad_tpu/ops/pallas_mlp.py:_gelu_tanh and
// pallas_frontend.py:_gelu_tanh_f32).
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// Exact GELU, fp32. The TPU kernels carry an A&S rational for erf (max
// abs error 1.5e-7) because Mosaic has no erf; CUDA has erff.
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu(float x, int tanh_form) {
  return tanh_form ? gelu_tanh(x) : gelu_erf(x);
}

// GELU (tanh or erf form) of x and d gelu / dx at x, in fp32, their
// shared transcendental taken once (pallas_mlp.py:_gelu_tanh /
// _gelu_tanh_grad and _gelu_exact / _gelu_grad).
template <bool TANH>
__device__ __forceinline__ void gelu_and_grad(float x, float* g, float* grad) {
  if constexpr (TANH) {
    const float t = tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x));
    const float du = 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * x * x);
    *g = 0.5f * x * (1.0f + t);
    *grad = 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * du;
  } else {
    const float cdf = 0.5f * (1.0f + erff(x * 0.7071067811865476f));
    *g = x * cdf;
    *grad = cdf + x * expf(-0.5f * x * x) * 0.3989422804014327f;
  }
}

// v = hi + lo with both halves bf16: two bf16 products against an exact
// bf16 operand carry ~16 mantissa bits of v (an fp32 operand on bf16
// tensor cores).
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16* hi, __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16(v);
  *hi = h;
  *lo = __float2bfloat16(v - __bfloat162float(h));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Dropout keep bits: Philox4x32-10 of counter (col / 4, row, 0, 0) under
// key (seed, stream); word col % 4 of the output belongs to col. The
// torch twin is triad_tpu_torch/ops/dropout.py:keep_bits; the two give the
// same bits for the same coordinates. keep4 returns the four words of
// columns 4q .. 4q + 3 at once.
struct Keep4 {
  uint32_t w[4];
};

__device__ __forceinline__ Keep4 keep4(uint32_t seed, uint32_t stream, uint32_t row,
                                      uint32_t quad) {
  uint32_t c0 = quad, c1 = row, c2 = 0u, c3 = 0u, k0 = seed, k1 = stream;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  Keep4 out;
  out.w[0] = c0;
  out.w[1] = c1;
  out.w[2] = c2;
  out.w[3] = c3;
  return out;
}

// The word of column col among the four keep4 gives for col / 4.
__device__ __forceinline__ uint32_t keep_word(const Keep4& kb, int col) {
  const int u = col & 3;
  return u == 0 ? kb.w[0] : u == 1 ? kb.w[1] : u == 2 ? kb.w[2] : kb.w[3];
}

// The dropout parameters a kernel takes: keep iff bits >= thresh
// (floor(p * 2^32), the JAX rule), kept values times scale = 1 / (1 - p).
// p = 0 is active == 0: nothing is drawn. offset shifts the coordinate
// that names a batch row to its place in the global batch: b0 * H for the
// attention's stream, b0 * N for the MLP's and LayerNorm's row (b0 = the
// global index of this process's first batch row; 0 in one process).
struct Dropout {
  uint32_t seed, thresh;
  float scale;
  int active;
  uint32_t offset;
};

// Asynchronous 16-byte copy global -> shared (cp.async, sm_80+), zero-
// filled when `valid` is false (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
// The same for 8 bytes (cp.async.ca: 4- and 8-byte copies go through L1).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace triad

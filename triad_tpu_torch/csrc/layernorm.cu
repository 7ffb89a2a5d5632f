// Fused dropout + residual add + LayerNorm, forward and backward:
//   y = LN(x + keep * h / (1 - p)) * scale + bias, stats in fp32.
//
// Replaces triad_tpu/ops/pallas_ln.py:fused_dropout_add_ln (_fwd :124,
// pallas_call :128, body _fwd_kernel :41; _bwd_call :144, pallas_call
// :148, body _bwd_kernel :64). The TPU kernel takes one batch row of
// (T, C) per grid step and draws its keep bits from the core PRNG; here
// one warp owns one token row of C = 128 * NV channels, held in
// registers (lane l holds channels 4l + 128v .. 4l + 128v + 3), and the
// keep bit of (row (b0 + b) * N + t, channel c; offset = b0 * N, b0 the
// global index of the first batch row) is triad::keep4 under key
// (seed, 0), so the backward replays the forward's mask. mean and var
// (two-pass, over the fp32 sum s) reduce by warp shuffles.
//
// Forward writes y only. Backward recomputes s, mean and rstd from x, h
// and the replayed mask, and writes dx = ds, dh = ds * keep / (1 - p) and
// one fp32 row of dscale / dbias partials per block (each block sums its
// warps' rows in a fixed order; the wrapper sums the blocks). No atomics,
// so the gradients are the same from run to run.
//
// What bounds it on the card: memory. At (64, 499, 768) bf16 the forward
// moves 147 MB (x, h in, y out), about 44 us at 3.35 TB/s; the backward
// 245 MB (x, h, dy in, dx, dh out), about 73 us. One warp per row keeps
// every load a 8-byte vector per lane and every value in registers.
#include "common.cuh"

namespace {

using triad::bf16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_BWD_BLOCKS = 1024;

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four bf16 at p -> fp32.
__device__ inline void load4(const bf16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(a);
  out[1] = __high2float(a);
  out[2] = __low2float(b);
  out[3] = __high2float(b);
}

__device__ inline void store4(bf16* p, const float* v) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// s = x + keep * h / (1 - p) for one row, and the keep bits for the
// backward's dh.
template <int NV>
__device__ inline void row_sum_input(const bf16* xr, const bf16* hr, long long row, int lane,
                                     const triad::Dropout& dp, float (&s)[NV][4],
                                     bool (&keep)[NV][4]) {
  for (int v = 0; v < NV; ++v) {
    const int c = v * 128 + lane * 4;
    float xv[4], hv[4];
    load4(xr + c, xv);
    load4(hr + c, hv);
    triad::Keep4 kb;
    if (dp.active) kb = triad::keep4(dp.seed, 0u, dp.offset + (uint32_t)row, (uint32_t)c >> 2);
    for (int u = 0; u < 4; ++u) {
      keep[v][u] = !dp.active || kb.w[u] >= dp.thresh;
      const float h = dp.active ? (keep[v][u] ? hv[u] * dp.scale : 0.0f) : hv[u];
      s[v][u] = xv[u] + h;
    }
  }
}

template <int NV>
__device__ inline void row_stats(const float (&s)[NV][4], float eps, float* mean, float* rstd) {
  constexpr float inv_c = 1.0f / (NV * 128);
  float sum = 0.0f;
  for (int v = 0; v < NV; ++v)
    for (int u = 0; u < 4; ++u) sum += s[v][u];
  const float m = warp_sum(sum) * inv_c;
  float sq = 0.0f;
  for (int v = 0; v < NV; ++v)
    for (int u = 0; u < 4; ++u) sq += (s[v][u] - m) * (s[v][u] - m);
  *mean = m;
  *rstd = rsqrtf(warp_sum(sq) * inv_c + eps);
}

template <int NV>
__global__ void __launch_bounds__(THREADS)
layernorm_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     bf16* __restrict__ y, int rows, float eps, triad::Dropout dp) {
  constexpr int C = NV * 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= rows) return;
  float s[NV][4];
  bool keep[NV][4];
  row_sum_input<NV>(x + row * C, h + row * C, row, lane, dp, s, keep);
  float mean, rstd;
  row_stats<NV>(s, eps, &mean, &rstd);
  for (int v = 0; v < NV; ++v) {
    const int c = v * 128 + lane * 4;
    float out[4];
    for (int u = 0; u < 4; ++u) out[u] = (s[v][u] - mean) * rstd * scale[c + u] + bias[c + u];
    store4(y + row * C + c, out);
  }
}

template <int NV>
__global__ void __launch_bounds__(THREADS)
layernorm_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
                     const float* __restrict__ scale, const bf16* __restrict__ dy,
                     bf16* __restrict__ dx, bf16* __restrict__ dh,
                     float* __restrict__ dscale_part, float* __restrict__ dbias_part, int rows,
                     float eps, triad::Dropout dp) {
  constexpr int C = NV * 128;
  constexpr float inv_c = 1.0f / C;
  __shared__ float red[WARPS * C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float ps[NV][4], pb[NV][4];
  for (int v = 0; v < NV; ++v)
    for (int u = 0; u < 4; ++u) ps[v][u] = pb[v][u] = 0.0f;

  // Rows blockIdx.x * 8 + warp, then a grid's worth of rows further on.
  for (long long row = (long long)blockIdx.x * WARPS + warp; row < rows;
       row += (long long)gridDim.x * WARPS) {
    float s[NV][4], g[NV][4], xhat[NV][4];
    bool keep[NV][4];
    row_sum_input<NV>(x + row * C, h + row * C, row, lane, dp, s, keep);
    float mean, rstd;
    row_stats<NV>(s, eps, &mean, &rstd);
    float m1 = 0.0f, m2 = 0.0f;
    for (int v = 0; v < NV; ++v) {
      const int c = v * 128 + lane * 4;
      load4(dy + row * C + c, g[v]);
      for (int u = 0; u < 4; ++u) {
        xhat[v][u] = (s[v][u] - mean) * rstd;
        ps[v][u] += g[v][u] * xhat[v][u];
        pb[v][u] += g[v][u];
        g[v][u] *= scale[c + u];  // dyh = dy * scale
        m1 += g[v][u];
        m2 += g[v][u] * xhat[v][u];
      }
    }
    m1 = warp_sum(m1) * inv_c;
    m2 = warp_sum(m2) * inv_c;
    for (int v = 0; v < NV; ++v) {
      const int c = v * 128 + lane * 4;
      float dsv[4], dhv[4];
      for (int u = 0; u < 4; ++u) {
        dsv[u] = rstd * (g[v][u] - m1 - xhat[v][u] * m2);
        dhv[u] = dp.active ? (keep[v][u] ? dsv[u] * dp.scale : 0.0f) : dsv[u];
      }
      store4(dx + row * C + c, dsv);
      store4(dh + row * C + c, dhv);
    }
  }

  // Block partials: warps' sums added in warp order.
  for (int pass = 0; pass < 2; ++pass) {
    for (int v = 0; v < NV; ++v)
      for (int u = 0; u < 4; ++u)
        red[warp * C + v * 128 + lane * 4 + u] = pass == 0 ? ps[v][u] : pb[v][u];
    __syncthreads();
    float* out = (pass == 0 ? dscale_part : dbias_part) + (long long)blockIdx.x * C;
    for (int c = threadIdx.x; c < C; c += THREADS) {
      float acc = 0.0f;
      for (int w = 0; w < WARPS; ++w) acc += red[w * C + c];
      out[c] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// x, h, y: contiguous bf16 (rows, c); scale, bias: fp32 (c). c == 768.
// Dropout: keep iff bits >= thresh, kept values times keep_scale, none
// when active == 0. Returns a cudaError_t.
extern "C" int triad_layernorm_fwd(const void* x, const void* h, const void* scale,
                                   const void* bias, void* y, int rows, int c, float eps,
                                   unsigned seed, unsigned thresh, float keep_scale, int active,
                                   unsigned offset,
                                   void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  const triad::Dropout dp{seed, thresh, keep_scale, active, offset};
  const int blocks = (rows + WARPS - 1) / WARPS;
  switch (c) {
    case 768:
      layernorm_fwd_kernel<6><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          (const bf16*)x, (const bf16*)h, (const float*)scale, (const float*)bias, (bf16*)y,
          rows, eps, dp);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The number of blocks (rows of partials) the backward writes for `rows`.
extern "C" int triad_layernorm_bwd_blocks(int rows) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  return blocks < MAX_BWD_BLOCKS ? blocks : MAX_BWD_BLOCKS;
}

// x, h, dy, dx, dh: contiguous bf16 (rows, c); scale fp32 (c); dscale_part,
// dbias_part: fp32 (triad_layernorm_bwd_blocks(rows), c). The dropout
// arguments are the forward's. Returns a cudaError_t.
extern "C" int triad_layernorm_bwd(const void* x, const void* h, const void* scale,
                                   const void* dy, void* dx, void* dh, void* dscale_part,
                                   void* dbias_part, int rows, int c, int blocks, float eps,
                                   unsigned seed, unsigned thresh, float keep_scale, int active,
                                   unsigned offset,
                                   void* stream) {
  if (rows <= 0 || blocks != triad_layernorm_bwd_blocks(rows)) return (int)cudaErrorInvalidValue;
  const triad::Dropout dp{seed, thresh, keep_scale, active, offset};
  switch (c) {
    case 768:
      layernorm_bwd_kernel<6><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          (const bf16*)x, (const bf16*)h, (const float*)scale, (const bf16*)dy, (bf16*)dx,
          (bf16*)dh, (float*)dscale_part, (float*)dbias_part, rows, eps, dp);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

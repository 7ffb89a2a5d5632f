// HuBERT conv waveform frontend (7 bias-free convs, kernels 10,3,3,3,3,2,2,
// strides 5,2,2,2,2,2,2, 512 channels), as five kernels:
//
//   frontend_gram_kernel    the GroupNorm statistics of conv_0 without
//   frontend_stats_kernel   conv_0, after pallas_frontend.py:conv0_stats's
//                           "xt" Gram pass (:324; pallas_call :352,
//                           _stats_gram_kernel :268, the contraction
//                           :379-398).
//   frontend_gelu_table_kernel,  conv_0 (bf16 operands, fp32
//   frontend_conv0_kernel   accumulation) on tensor cores, the folded
//                           GroupNorm affine, bf16 rounding, GELU (a table
//                           of every bf16's) -> bf16 activation (T0, 512).
//   gemm_kernel             one stride-2 conv (k in {2, 3}) as
//   (conv_s2.cuh)           conv_s2.cuh's GEMM with a GELU epilogue ->
//                           bf16 (Tout, 512).
//
// The conv_0 pair and the GEMM replace pallas_frontend.py:
// monolithic_frontend (:471; _main_kernel :440, _conv0_block :141,
// _stride2_layer :208), launched once per layer.
//
// The stats. conv_0's output is y[t, c] = w_c . x_t, x_t = wave[5t : 5t +
// 10], so sum_t y = w_c . S and sum_t y^2 = w_c^T G w_c with S = sum_t x_t
// and G = sum_t x_t x_t^T (10 x 10, symmetric: 55 sums). The Gram kernel
// reads the waveform once: a block per 2048 steps of a batch row stages
// its window in shared memory (4-byte cp.async, all in flight), each
// thread sums G's upper triangle and S over its strided steps in fp64 (a
// product of two fp32 samples is exact there), then the warp by xor
// shuffles and the warps in order: one partial of 65 sums per block. The
// stats kernel sums a row's partials in block order and contracts them
// with each channel's taps in fp64: mean = w.S / m0, var = max(w^T G w /
// m0 - mean^2, 0), rounded to fp32. No atomics: the same bits every run.
// In fp64 the cancellation in w^T G w / m0 - mean^2 is harmless for an
// fp32 result; it is what drove the TPU's variance negative when the
// contraction ran at bf16 precision (pallas_frontend.py:379-388). What
// bounds it: the waveform read (B x T x 4 bytes); the fp64 work is 130
// operations a step. At B = 8 it is launch-bound (two grids of a few
// microseconds each). The "x10" recompute (_stats_kernel :246: conv_0
// again and its squares, 22 fp32 operations per step and channel) is gone.
//
// conv_0. What bounds it is the output write (B x m0 x 512 x 2 bytes); the
// products are ~4 GFLOP at B = 8, a few microseconds of tensor-core time,
// so mma.sync m16n8k16 serves and wgmma would buy nothing. A warp's 16
// steps x 16 taps (taps 10-15 zero) are one A fragment, built from the
// tile's waveform window in shared memory and rounded to bf16; the bf16
// weight of the warp's 64 channels is 8 B fragments held in registers.
// The epilogue stays on the CUDA cores: the affine in fp32 (an fma),
// rounded to bf16, then GELU. Per element, triad::gelu (tanhf / erff)
// costs more than the store: the GELU input is a bf16 value, so a first
// grid tabulates bf16(gelu(z)) with triad::gelu for all 65536 bf16 z, each
// block copies the table (128 KB) into shared memory, and the epilogue
// looks each output up by z's bits: the same bits as triad::gelu per
// element, for one shared-memory load. Each warp's 16 x 64 output tile
// goes through 2 KB of shared memory (16-byte chunks XOR-swizzled by row,
// so neither the accumulator layout's 4-byte writes nor the 16-byte reads
// conflict) and leaves as 16-byte evict-first stores, 128 contiguous bytes
// a row. Persistent blocks, one an SM, walk contiguous ranges of (batch
// row, 256- or 512-step tile); two warps share each 64-channel slab and
// take its 16-step pieces in turn (16 warps); each tile's window arrives
// by cp.async while the one before is computed, behind one block barrier
// a tile. The lookups' bank conflicts and the barriers keep it at ~70% of
// the bound (tools/kernel_probe.py frontend).
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
// (output channel, then tap, then input channel): conv_s2.cuh. The
// stride-2 GEMMs hold ~99% of the frontend's FLOPs (about 390 GFLOP at B =
// 8, 10 s), so they are bound by operations; conv_s2.cuh is a persistent
// TMA + wgmma GEMM.
#include <climits>

#include "attention_tiles.cuh"
#include "common.cuh"
#include "conv_s2.cuh"

namespace {

using triad::bf16;
using triad::tiles::pack;

constexpr int C = 512;
constexpr int TAPS = 10;

// 4-byte asynchronous copy global -> shared (cp.async), zero-filled when
// !valid (src must still be a mapped address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

// ---------------------------------------------------------------- stats
constexpr int ST_T = 2048;  // conv_0 steps per block of the Gram pass
constexpr int ST_THREADS = 128;
constexpr int GRAM = TAPS * (TAPS + 1) / 2;  // G's upper triangle, row by row
constexpr int PART = GRAM + TAPS;            // then S
static_assert(ST_THREADS % 32 == 0 && ST_THREADS >= PART, "a thread per partial sum");

__global__ void __launch_bounds__(ST_THREADS)
frontend_gram_kernel(const float* __restrict__ wave, long long wave_bs, double* __restrict__ part,
                     int m0) {
  __shared__ float sw[5 * ST_T + 5];
  __shared__ double red[ST_THREADS / 32][PART];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * ST_T;
  const int nt = min(ST_T, m0 - t0);
  const int ns = 5 * nt + 5;
  const float* src = wave + blockIdx.y * wave_bs + 5LL * t0;
  for (int i = tid; i < ns; i += ST_THREADS) cp_async4(sw + i, src + i);  // all in flight
  triad::cp_async_commit();
  triad::cp_async_wait<0>();
  __syncthreads();
  double acc[PART];
#pragma unroll
  for (int k = 0; k < PART; ++k) acc[k] = 0.0;
  for (int t = tid; t < nt; t += ST_THREADS) {
    double x[TAPS];
#pragma unroll
    for (int j = 0; j < TAPS; ++j) x[j] = sw[5 * t + j];
    int k = 0;
#pragma unroll
    for (int i = 0; i < TAPS; ++i)
#pragma unroll
      for (int j = i; j < TAPS; ++j, ++k) acc[k] = fma(x[i], x[j], acc[k]);
#pragma unroll
    for (int j = 0; j < TAPS; ++j) acc[GRAM + j] += x[j];
  }
#pragma unroll
  for (int k = 0; k < PART; ++k)
#pragma unroll
    for (int off = 16; off; off >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < PART; ++k) red[warp][k] = acc[k];
  }
  __syncthreads();
  if (tid < PART) {
    double s = red[0][tid];
#pragma unroll
    for (int w = 1; w < ST_THREADS / 32; ++w) s += red[w][tid];
    part[((long long)blockIdx.y * gridDim.x + blockIdx.x) * PART + tid] = s;
  }
}

// One block per batch row, a thread per channel.
__global__ void __launch_bounds__(C)
frontend_stats_kernel(const double* __restrict__ part, int nblk, const float* __restrict__ w0,
                      float* __restrict__ mean, float* __restrict__ var, int m0) {
  __shared__ double g[PART];
  const int b = blockIdx.x, c = threadIdx.x;
  if (c < PART) {
    const double* p = part + (long long)b * nblk * PART + c;
    double s = p[0];
    for (int k = 1; k < nblk; ++k) s += p[(long long)k * PART];
    g[c] = s;
  }
  __syncthreads();
  double w[TAPS];
#pragma unroll
  for (int j = 0; j < TAPS; ++j) w[j] = w0[c * TAPS + j];
  // w^T G w = sum_i w_i (G_ii w_i + 2 sum_{j > i} G_ij w_j)
  double sum = 0.0, sq = 0.0;
  int k = 0;
#pragma unroll
  for (int i = 0; i < TAPS; ++i) {
    const double gii = g[k++];
    double r = 0.0;
#pragma unroll
    for (int j = i + 1; j < TAPS; ++j) r = fma(g[k++], w[j], r);
    sq = fma(w[i], fma(gii, w[i], 2.0 * r), sq);
    sum = fma(w[i], g[GRAM + i], sum);
  }
  const double mu = sum / m0;
  mean[b * C + c] = (float)mu;
  var[b * C + c] = (float)fmax(sq / m0 - mu * mu, 0.0);
}

// ---------------------------------------------------------------- conv_0
constexpr int C0_TMAX = 512;  // conv_0 steps per tile at most (the host picks 256 or 512)
constexpr int C0_NT = 8;      // n-tiles (8 channels each) of a warp: 2, 4 or 8
constexpr int C0_ROWG = 2;    // warps that share a warp's channels, taking 16 steps in turn
constexpr int C0_COLG = C / (8 * C0_NT);  // warps across the channels
constexpr int C0_WARPS = C0_COLG * C0_ROWG;
constexpr int C0_THREADS = 32 * C0_WARPS;
constexpr int C0_WIN = 5 * C0_TMAX + 5;  // waveform samples of a tile
constexpr int C0_ROW = 4 * C0_NT;        // 32-bit words of a staged row of a warp
// a warp's staged tile: 16 rows of C0_NT 16-byte chunks, chunk j of row r
// at j ^ swz(r), so that the 8 rows of an accumulator store (and the rows
// that share a bank row) hit distinct banks; rows r and r + 8 share it
__device__ __forceinline__ int swz(int r) { return (r / (8 / C0_NT)) % C0_NT; }

// The GELU table: bf16(gelu(z)) for every bf16 z, by z's bits.
constexpr int LUT_N = 1 << 16;
// dynamic shared memory (one block an SM): the table, the warps' staged
// tiles, three windows (one computed on, one arriving, one free for the
// next copy)
constexpr int C0_SMEM = 2 * LUT_N + 4 * (C0_WARPS * 16 * C0_ROW + 3 * C0_WIN);

// bf16(gelu(z)) of the bf16 z with bits u, as bits.
template <bool TANH>
__device__ __forceinline__ uint32_t gelu_bits(uint32_t u) {
  return __bfloat16_as_ushort(__float2bfloat16(triad::gelu(__uint_as_float(u << 16), TANH)));
}

template <bool TANH>
__global__ void __launch_bounds__(256) frontend_gelu_table_kernel(uint16_t* __restrict__ table) {
  const uint32_t u = blockIdx.x * 256 + threadIdx.x;
  table[u] = gelu_bits<TANH>(u);
}

// GELU of a pair of bf16 (bits in, bits out), from the table.
__device__ __forceinline__ uint32_t gelu2(uint32_t z, const uint16_t* lut) {
  return uint32_t(lut[z & 0xffffu]) | uint32_t(lut[z >> 16]) << 16;
}

// bf16(y * scale + bias) of two outputs of a row, as a bf16 pair.
__device__ __forceinline__ uint32_t affine2(float y0, float y1, float2 s, float2 b) {
  return pack(y0 * s.x + b.x, y1 * s.y + b.y);
}

__device__ __forceinline__ void store_evict_first(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Tiles are (batch row, `steps` steps) in row-major order, ntiles of them;
// block i takes tiles [i * ntiles / grid, (i + 1) * ntiles / grid), and
// its warp (column c, row r of the warp grid) the 64 channels of column c
// and the 16-step pieces r, r + C0_ROWG, .. of each tile. table:
// frontend_gelu_table_kernel's, copied into shared memory first.
template <bool TANH>
__global__ void __launch_bounds__(C0_THREADS, 1)
frontend_conv0_kernel(const float* __restrict__ wave, long long wave_bs,
                      const float* __restrict__ w0, const float* __restrict__ scale,
                      const float* __restrict__ bias, const uint16_t* __restrict__ table,
                      bf16* __restrict__ y, int m0, int steps, int tiles_per_row, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* lut = reinterpret_cast<uint16_t*>(smem);
  uint32_t* stage = reinterpret_cast<uint32_t*>(lut + LUT_N);  // swz's layout
  float* windows = reinterpret_cast<float*>(stage + C0_WARPS * 16 * C0_ROW);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int c0 = 8 * C0_NT * (warp % C0_COLG), s0 = 16 * (warp / C0_COLG);
  const int first = (int)((long long)blockIdx.x * ntiles / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x);
  // a tile's window, 5 * steps + 5 samples (zeros past the row's last
  // step), by 4-byte cp.async, one group
  auto window = [&](int tile) { return windows + (tile - first) % 3 * C0_WIN; };
  auto fetch = [&](int tile) {
    const int b = tile / tiles_per_row, t0 = (tile % tiles_per_row) * steps;
    const float* src = wave + b * wave_bs + 5LL * t0;
    const int valid = 5 * min(steps, m0 - t0) + 5;
    float* dst = window(tile);
    for (int i = tid; i < 5 * steps + 5; i += C0_THREADS)
      cp_async4(dst + i, src + (i < valid ? i : 0), i < valid);
    triad::cp_async_commit();
  };
  for (int i = tid; i < LUT_N / 8; i += C0_THREADS)
    triad::cp_async16(lut + 8 * i, table + 8 * i, true);
  fetch(first);  // one group with the table
  if (first + 1 < last) fetch(first + 1);
  // B fragments of the n-tiles: channel c0 + 8j + g; taps 2q, 2q + 1 and
  // 2q + 8, 2q + 9 (zero from tap 10 on)
  uint32_t bw[C0_NT][2];
#pragma unroll
  for (int j = 0; j < C0_NT; ++j) {
    const float* wc = w0 + (c0 + 8 * j + g) * TAPS;
    bw[j][0] = pack(wc[2 * q], wc[2 * q + 1]);
    bw[j][1] = q == 0 ? pack(wc[8], wc[9]) : 0u;
  }
  float2 sc[C0_NT], bi[C0_NT];  // the affine of channels c0 + 8j + 2q, + 1 of row row_b
  int row_b = -1;
  uint32_t* st = stage + warp * 16 * C0_ROW;
  for (int tile = first; tile < last; ++tile) {
    if (tile + 1 < last)
      triad::cp_async_wait<1>();  // the next tile's window may stay in flight
    else
      triad::cp_async_wait<0>();
    // this tile's window (and the table) in place, and every warp done with
    // the last tile's, which the copy of the tile after next overwrites
    __syncthreads();
    if (tile + 2 < last) fetch(tile + 2);
    const float* sw = window(tile);
    const int b = tile / tiles_per_row, t0 = (tile % tiles_per_row) * steps;
    const int nt = min(steps, m0 - t0);
    if (b != row_b) {
      row_b = b;
#pragma unroll
      for (int j = 0; j < C0_NT; ++j) {
        const long long o = (long long)b * C + c0 + 8 * j + 2 * q;
        sc[j] = *reinterpret_cast<const float2*>(scale + o);
        bi[j] = *reinterpret_cast<const float2*>(bias + o);
      }
    }
    bf16* yt = y + ((long long)b * m0 + t0) * C + c0;
    for (int s = s0; s < nt; s += 16 * C0_ROWG) {
      // A: rows g and g + 8 of these 16 steps, taps 2q, 2q + 1 and 8, 9
      const float* x0 = sw + 5 * (s + g);
      const float* x1 = x0 + 40;
      const uint32_t a[4] = {pack(x0[2 * q], x0[2 * q + 1]), pack(x1[2 * q], x1[2 * q + 1]),
                             q == 0 ? pack(x0[8], x0[9]) : 0u, q == 0 ? pack(x1[8], x1[9]) : 0u};
#pragma unroll
      for (int j = 0; j < C0_NT; ++j) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        triad::tiles::mma(d, a, bw[j][0], bw[j][1]);
        const int col = ((j ^ swz(g)) << 2) + q;  // rows g and g + 8
        st[g * C0_ROW + col] = gelu2(affine2(d[0], d[1], sc[j], bi[j]), lut);
        st[(g + 8) * C0_ROW + col] = gelu2(affine2(d[2], d[3], sc[j], bi[j]), lut);
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < C0_NT / 2; ++u) {
        const int r = (32 * u + lane) / C0_NT, ch = lane % C0_NT;
        if (s + r < nt)
          store_evict_first(
              yt + (long long)(s + r) * C + 8 * ch,
              *reinterpret_cast<const uint4*>(st + r * C0_ROW + ((ch ^ swz(r)) << 2)));
      }
      __syncwarp();
    }
  }
}

// The kernel's dynamic shared memory allowed once per device and form.
template <bool TANH>
cudaError_t allow_conv0_smem(int dev) {
  static bool done[triad::hopper::MAX_DEVICES] = {};
  if (done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      frontend_conv0_kernel<TANH>, cudaFuncAttributeMaxDynamicSharedMemorySize, C0_SMEM);
  done[dev] = err == cudaSuccess;
  return err;
}

template <bool TANH>
int launch_conv0(const float* wave, long long wave_bs, const float* w0, const float* scale,
                 const float* bias, uint16_t* table, bf16* y, int b, int m0,
                 cudaStream_t stream) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= triad::hopper::MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  const int sms = triad::hopper::sm_count(dev);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // the longest tiles that still give every SM two of them: fewer block
  // barriers a step
  const int steps = (long long)b * ((m0 + C0_TMAX - 1) / C0_TMAX) >= 2LL * sms ? C0_TMAX
                                                                              : C0_TMAX / 2;
  const long long tiles_per_row = (m0 + steps - 1) / steps, ntiles = b * tiles_per_row;
  if (ntiles > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_conv0_smem<TANH>(dev);
  if (err != cudaSuccess) return (int)err;
  frontend_gelu_table_kernel<TANH><<<LUT_N / 256, 256, 0, stream>>>(table);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  frontend_conv0_kernel<TANH><<<(int)(ntiles < sms ? ntiles : sms), C0_THREADS, C0_SMEM,
                                 stream>>>(wave, wave_bs, w0, scale, bias, table, y, m0,
                                           steps, (int)tiles_per_row, (int)ntiles);
  return (int)cudaGetLastError();
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

// wave: (B, >= 5 * (m0 - 1) + 10) fp32 with unit sample stride and
// batch stride wave_bs; w0: (512, 10) fp32 (torch's Conv1d layout without
// its unit input-channel axis); part: (B, ceil(m0 / 2048), 65) fp64
// scratch, each block's partial sums (G's upper triangle, then S); mean,
// var: (B, 512) fp32. Two grids. Returns a cudaError_t.
extern "C" int triad_frontend_stats(const void* wave, long long wave_bs, const void* w0,
                                    void* part, void* mean, void* var, int b, int m0,
                                    void* stream) {
  if (m0 <= 0 || b <= 0 || b > 65535) return (int)cudaErrorInvalidValue;
  const int nblk = (m0 + ST_T - 1) / ST_T;
  frontend_gram_kernel<<<dim3(nblk, b), ST_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)wave, wave_bs, (double*)part, m0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  frontend_stats_kernel<<<b, C, 0, (cudaStream_t)stream>>>(
      (const double*)part, nblk, (const float*)w0, (float*)mean, (float*)var, m0);
  return (int)cudaGetLastError();
}

// wave, w0 as above; scale, bias: (B, 512) fp32 folded GroupNorm affine
// (8-byte aligned); table: 65536 uint16 scratch (16-byte aligned), which
// the first grid fills with the GELU of every bf16; y: (B, m0, 512) bf16,
// 16-byte aligned. Two grids. Returns a cudaError_t.
extern "C" int triad_frontend_conv0(const void* wave, long long wave_bs, const void* w0,
                                    const void* scale, const void* bias, void* table, void* y,
                                    int b, int m0, int tanh_form, void* stream) {
  if (m0 <= 0 || b <= 0) return (int)cudaErrorInvalidValue;
  auto run = tanh_form ? launch_conv0<true> : launch_conv0<false>;
  return run((const float*)wave, wave_bs, (const float*)w0, (const float*)scale,
             (const float*)bias, (uint16_t*)table, (bf16*)y, b, m0, (cudaStream_t)stream);
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

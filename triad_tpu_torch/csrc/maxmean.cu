// Cross-batch max-mean aggregation with a recompute backward: a forward
// kernel, a dQ kernel and a dK kernel.
//
// Replaces triad_tpu/ops/pallas_maxmean.py: _forward (:150, pallas_call
// :158; _fwd_kernel) and _backward (:329; the dQ pass, pallas_call :337,
// _dq_kernel, and the dK pass, pallas_call :369, _dk_kernel). For query
// clip i, key clip j, query token a and key token v:
//   ts[i,j,a,v] = <q_ia, k_jv> * T
//   clip[i,j]   = sum_a coeff[i,a] * max_v ts[i,j,a,v]
//   nonneg      = sum clamp(ts, clamp_min, 0)^2
//   tsq         = sum of ts^2 where clamp_min < ts < 0 (the open window;
//                 the temperature gradient reads it, _maxmean_bwd :413)
//   dts         = (onehot(first argmax_v) * g_clip[i,j] * coeff[i,a]
//                  + window * 2 ts * g_nonneg) * T
//   dQ_i        = sum_j dts K_j,   dK_j = sum_i dts^T Q_i.
// coeff is 1/Nq for the AV mean and mask/count for the TV masked mean.
//
// Ties in the max route the whole gradient to the FIRST argmax over keys,
// as the TPU kernel does (pallas_maxmean.py:18-21, jnp.argmax). This is
// not the XLA path's even split among ties (jnp.max's VJP), which the
// port's chunked_vjp aggregation (ops/similarity.py:MaxMeanChunked) keeps;
// the plain twin of these kernels (ops/maxmean.py) routes to the first
// argmax too.
//
// Precision, as the reference: the sims <q, k> take the features' dtype,
// bf16 tensor-core products with fp32 accumulation (_matmul_qk :78-84).
// fp32 features arrive split into bf16 halves hi + lo (the wrapper splits
// them) and the sims take qh kh + ql kh + qh kl: fp32 level, never TF32,
// because the argmax routing and the clamp window read single sims. The
// backward products take the fp32 dts (and the fp32 K or Q of the
// reference, :250-254, :313-317) as bf16 hi + lo halves (triad::
// split_bf16, ~16 mantissa bits). Every kernel computes a sim tile with the
// same function over the same 16 x 16 blocks in the same order, so the
// backward's recomputed ts equal the forward's to the bit.
//
// What bounds it on the card: 2 Bq Bk Nq Nk D operations per pass (4 for
// each backward pass, whose dts is split in two); at the AV shape (64 x 499
// queries, 64 x 256 keys, D = 512) the forward is 5.4e11 operations, 0.54
// ms at the bf16 tensor-core peak, far above its 45 MB of input. The
// design is the simple one (WMMA, synchronous tile loads, whole-D tiles in
// shared memory); it sits well above that bound.
//   forward  one block per pair (i, j): a 64-key tile of K_j stays in
//            shared memory while 32-query tiles of Q_i stream past it; a
//            running (max, first argmax) per query row lives in shared
//            memory; the block writes clip[i, j] itself (no atomics), its
//            clamp^2 and window ts^2 sums to a per-pair buffer that the
//            wrapper sums in a fixed order, and the first argmax of every
//            query row to an int32 (Bq, Bk, Nq) residual (8.2 MB at the AV
//            shape) that the backward reads: the dK kernel tiles the keys
//            and could not find a row's argmax over all of them itself.
//   dQ       one block per (i, 32-query tile), walking every (j, 64-key
//            tile); the (32, D) fp32 dQ tile accumulates in registers.
//   dK       one block per (j, 32-key tile), walking every (i, 64-query
//            tile); the (32, D) fp32 dK tile accumulates in registers.
// Both backward kernels sum in a fixed order: deterministic, no atomics.
// D a multiple of 64 up to 512; Nk a multiple of 64; ragged Nq (rows past
// Nq are zero-filled and skipped).
#include "common.cuh"

using namespace nvcuda;

namespace {

using triad::bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_D = 512;    // 8 fp32 accumulator fragments per warp
constexpr int MAX_SMEM = 232448;
// forward: 32 query rows x 64 keys per sim tile
constexpr int FQ = 32, FK = 64;
// dQ: 32 query rows, 64 keys per step
constexpr int GQ = 32, GK = 64;
// dK: 32 keys, 64 query rows per step
constexpr int HK = 32, HQ = 64;

// The warp's accumulator fragments, fully unrolled so they stay in
// registers; f < nf (= D / 64) are live.
#define FOR_FRAGS(f) _Pragma("unroll") for (int f = 0; f < MAX_D / 64; ++f) if (f < nf)

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// The inputs as the kernels take them: bf16 halves (lo null for bf16
// features) and their shapes.
struct Inputs {
  const bf16 *qh, *ql, *kh, *kl;
  const float* coeff;  // (Bq, Nq)
  const float* temp;   // scalar T
  int bq, bk, nq, nk, d;
  float clamp_min;
};

// rows x d of a (.., d) row-major tensor -> shared memory with row stride
// ld; rows at or past `valid` are zero-filled.
__device__ inline void load_tile(bf16* dst, const bf16* src, int rows, int valid, int d, int ld) {
  const int per_row = d / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const bool ok = r < valid;
    triad::copy16(dst + r * ld + c, ok ? src + (long long)r * d + c : src, ok);
  }
}

// One 16 x 16 block of raw sims <q, k> over all of d, in 16-wide steps:
// qh/ql point at 16 query rows, kh/kl at 16 keys (both row-major [.][d]
// with row stride ld). Every kernel uses this, so equal blocks give equal
// bits.
__device__ inline void sim_block(FragC& acc, const bf16* qh, const bf16* ql, const bf16* kh,
                                 const bf16* kl, int ld, int d, bool split) {
  wmma::fill_fragment(acc, 0.0f);
  for (int kk = 0; kk < d; kk += 16) {
    FragA a;
    FragBT b;
    wmma::load_matrix_sync(a, qh + kk, ld);
    wmma::load_matrix_sync(b, kh + kk, ld);
    wmma::mma_sync(acc, a, b, acc);
    if (split) {
      FragA al;
      FragBT bl;
      wmma::load_matrix_sync(al, ql + kk, ld);
      wmma::mma_sync(acc, al, b, acc);
      wmma::load_matrix_sync(bl, kl + kk, ld);
      wmma::mma_sync(acc, a, bl, acc);
    }
  }
}

__device__ inline float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];  // fixed order
  return s;
}

// dL/d(raw sim) of one element (zero for a row past nq).
__device__ inline float dts_of(float s, float temp, bool is_max, float g_max, float g_nn,
                               float clamp_min) {
  const float ts = s * temp;
  float d = is_max ? g_max : 0.0f;
  if (ts > clamp_min && ts < 0.0f) d += 2.0f * ts * g_nn;
  return d * temp;
}

// ---------------------------------------------------------------- forward

__host__ inline size_t fwd_smem(int d, int nq, bool split) {
  const int ld = d + 8;
  const size_t tiles = sizeof(bf16) * (size_t)(FK + FQ) * ld * (split ? 2 : 1);
  return align128(tiles) + align128(sizeof(float) * FQ * (FK + 4)) +
         align128(sizeof(float) * nq) + align128(sizeof(int) * nq) + 128;
}

__global__ void __launch_bounds__(THREADS)
maxmean_fwd_kernel(Inputs in, float* __restrict__ clip, int* __restrict__ amax,
                   float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int j = blockIdx.x, i = blockIdx.y;
  const int d = in.d, ld = d + 8, nq = in.nq, nk = in.nk;
  const bool split = in.ql != nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sQ = sK + FK * ld;
  bf16* sKl = sQ + FQ * ld;  // used when split
  bf16* sQl = sKl + FK * ld;
  size_t off = align128(sizeof(bf16) * (size_t)(FK + FQ) * ld * (split ? 2 : 1));
  float* sS = reinterpret_cast<float*>(smem + off);
  off += align128(sizeof(float) * FQ * (FK + 4));
  float* sMax = reinterpret_cast<float*>(smem + off);
  off += align128(sizeof(float) * nq);
  int* sArg = reinterpret_cast<int*>(smem + off);
  off += align128(sizeof(int) * nq);
  float* red = reinterpret_cast<float*>(smem + off);
  constexpr int LDS = FK + 4;

  const float temp = *in.temp;
  for (int a = threadIdx.x; a < nq; a += THREADS) {
    sMax[a] = -INFINITY;
    sArg[a] = 0;
  }
  const long long qbase = (long long)i * nq * d, kbase = (long long)j * nk * d;
  float nn = 0.0f, tsq = 0.0f;
  const int rt = warp & 1, ct = warp >> 1;  // the warp's 16 x 16 block of the 32 x 64 tile
  for (int k0 = 0; k0 < nk; k0 += FK) {
    __syncthreads();
    load_tile(sK, in.kh + kbase + (long long)k0 * d, FK, FK, d, ld);
    if (split) load_tile(sKl, in.kl + kbase + (long long)k0 * d, FK, FK, d, ld);
    for (int q0 = 0; q0 < nq; q0 += FQ) {
      __syncthreads();
      load_tile(sQ, in.qh + qbase + (long long)q0 * d, FQ, nq - q0, d, ld);
      if (split) load_tile(sQl, in.ql + qbase + (long long)q0 * d, FQ, nq - q0, d, ld);
      __syncthreads();
      FragC s;
      sim_block(s, sQ + rt * 16 * ld, sQl + rt * 16 * ld, sK + ct * 16 * ld,
                sKl + ct * 16 * ld, ld, d, split);
      wmma::store_matrix_sync(sS + rt * 16 * LDS + ct * 16, s, LDS, wmma::mem_row_major);
      __syncthreads();
      // warp w owns rows 4w .. 4w + 3 of the tile; a lane two keys
      for (int rr = 0; rr < FQ / 8; ++rr) {
        const int r = warp * (FQ / 8) + rr, a = q0 + r;
        if (a >= nq) break;
        const float t0 = sS[r * LDS + lane] * temp, t1 = sS[r * LDS + lane + 32] * temp;
        const float c0 = fminf(fmaxf(t0, in.clamp_min), 0.0f);
        const float c1 = fminf(fmaxf(t1, in.clamp_min), 0.0f);
        nn += c0 * c0 + c1 * c1;
        if (t0 > in.clamp_min && t0 < 0.0f) tsq += t0 * t0;
        if (t1 > in.clamp_min && t1 < 0.0f) tsq += t1 * t1;
        float best = t0;
        int arg = lane;
        if (t1 > t0) {
          best = t1;
          arg = lane + 32;
        }
        for (int o = 16; o > 0; o >>= 1) {  // max, lowest key on ties
          const float ob = __shfl_xor_sync(0xffffffffu, best, o);
          const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
          if (ob > best || (ob == best && oa < arg)) {
            best = ob;
            arg = oa;
          }
        }
        if (lane == 0 && best > sMax[a]) {  // an earlier key tile wins a tie
          sMax[a] = best;
          sArg[a] = k0 + arg;
        }
      }
    }
  }
  __syncthreads();
  const long long pair = (long long)i * in.bk + j;
  float c = 0.0f;
  for (int a = threadIdx.x; a < nq; a += THREADS) {
    c += in.coeff[(long long)i * nq + a] * sMax[a];
    amax[pair * nq + a] = sArg[a];
  }
  c = block_sum(c, red);
  nn = block_sum(nn, red);
  tsq = block_sum(tsq, red);
  if (threadIdx.x == 0) {
    clip[pair] = c;
    partials[2 * pair] = nn;
    partials[2 * pair + 1] = tsq;
  }
}

// --------------------------------------------------------------------- dQ

__host__ inline size_t dq_smem(int d, bool split) {
  const int ld = d + 8;
  return align128(sizeof(bf16) * (size_t)(GQ + GK) * ld * (split ? 2 : 1)) +
         align128(sizeof(float) * GQ * (GK + 4)) + 2 * align128(sizeof(bf16) * GQ * (GK + 8));
}

__global__ void __launch_bounds__(THREADS)
maxmean_dq_kernel(Inputs in, const float* __restrict__ g_clip, const float* __restrict__ g_nn,
                  const int* __restrict__ amax, float* __restrict__ dq) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * GQ, i = blockIdx.y;
  const int d = in.d, ld = d + 8, nq = in.nq, nk = in.nk;
  const bool split = in.ql != nullptr;
  const int warp = threadIdx.x / 32;
  constexpr int LDS = GK + 4, LDD = GK + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + GQ * ld;
  bf16* sQl = sK + GK * ld;  // used when split
  bf16* sKl = sQl + GQ * ld;
  size_t off = align128(sizeof(bf16) * (size_t)(GQ + GK) * ld * (split ? 2 : 1));
  float* sS = reinterpret_cast<float*>(smem + off);
  off += align128(sizeof(float) * GQ * LDS);
  bf16* sDh = reinterpret_cast<bf16*>(smem + off);
  bf16* sDl = sDh + align128(sizeof(bf16) * GQ * LDD) / sizeof(bf16);

  const float temp = *in.temp, gnn = *g_nn;
  const long long qbase = ((long long)i * nq + q0) * d;
  load_tile(sQ, in.qh + qbase, GQ, nq - q0, d, ld);
  if (split) load_tile(sQl, in.ql + qbase, GQ, nq - q0, d, ld);

  const int rt = warp & 1, ct = warp >> 1;  // sim block; dQ: rows rt, column group ct
  const int nf = d / 64, col0 = ct * (d / 4);
  FragC acc[MAX_D / 64];
  FOR_FRAGS(f) wmma::fill_fragment(acc[f], 0.0f);
  for (int j = 0; j < in.bk; ++j) {
    const long long pair = (long long)i * in.bk + j;
    const float g = g_clip[pair];
    for (int k0 = 0; k0 < nk; k0 += GK) {
      __syncthreads();
      const long long kbase = ((long long)j * nk + k0) * d;
      load_tile(sK, in.kh + kbase, GK, GK, d, ld);
      if (split) load_tile(sKl, in.kl + kbase, GK, GK, d, ld);
      __syncthreads();
      FragC s;
      sim_block(s, sQ + rt * 16 * ld, sQl + rt * 16 * ld, sK + ct * 16 * ld,
                sKl + ct * 16 * ld, ld, d, split);
      wmma::store_matrix_sync(sS + rt * 16 * LDS + ct * 16, s, LDS, wmma::mem_row_major);
      __syncthreads();
      for (int e = threadIdx.x; e < GQ * GK; e += THREADS) {
        const int r = e / GK, c = e % GK, a = q0 + r;
        float v = 0.0f;
        if (a < nq)
          v = dts_of(sS[r * LDS + c], temp, amax[pair * nq + a] == k0 + c,
                     g * in.coeff[(long long)i * nq + a], gnn, in.clamp_min);
        triad::split_bf16(v, sDh + r * LDD + c, sDl + r * LDD + c);
      }
      __syncthreads();
      // dQ += dts K over this tile's 64 keys
      for (int kk = 0; kk < GK; kk += 16) {
        FragA ah, al;
        wmma::load_matrix_sync(ah, sDh + rt * 16 * LDD + kk, LDD);
        wmma::load_matrix_sync(al, sDl + rt * 16 * LDD + kk, LDD);
        FOR_FRAGS(f) {
          FragB b;
          wmma::load_matrix_sync(b, sK + kk * ld + col0 + f * 16, ld);
          wmma::mma_sync(acc[f], ah, b, acc[f]);
          wmma::mma_sync(acc[f], al, b, acc[f]);
          if (split) {
            wmma::load_matrix_sync(b, sKl + kk * ld + col0 + f * 16, ld);
            wmma::mma_sync(acc[f], ah, b, acc[f]);
          }
        }
      }
    }
  }
  // Rows past nq are not stored: each warp stages its blocks in sS.
  __syncthreads();
  float* stage = sS + warp * 256;
  const int lane = threadIdx.x % 32;
  FOR_FRAGS(f) {
    wmma::store_matrix_sync(stage, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, c = e % 16, a = q0 + rt * 16 + r;
      if (a < nq) dq[((long long)i * nq + a) * d + col0 + f * 16 + c] = stage[e];
    }
    __syncwarp();
  }
}

// --------------------------------------------------------------------- dK

__host__ inline size_t dk_smem(int d, bool split) {
  const int ld = d + 8;
  return align128(sizeof(bf16) * (size_t)(HK + HQ) * ld * (split ? 2 : 1)) +
         align128(sizeof(float) * HQ * (HK + 4)) + 2 * align128(sizeof(bf16) * HQ * (HK + 8));
}

__global__ void __launch_bounds__(THREADS)
maxmean_dk_kernel(Inputs in, const float* __restrict__ g_clip, const float* __restrict__ g_nn,
                  const int* __restrict__ amax, float* __restrict__ dk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k0 = blockIdx.x * HK, j = blockIdx.y;
  const int d = in.d, ld = d + 8, nq = in.nq, nk = in.nk;
  const bool split = in.ql != nullptr;
  const int warp = threadIdx.x / 32;
  constexpr int LDS = HK + 4, LDD = HK + 8;
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sQ = sK + HK * ld;
  bf16* sKl = sQ + HQ * ld;  // used when split
  bf16* sQl = sKl + HK * ld;
  size_t off = align128(sizeof(bf16) * (size_t)(HK + HQ) * ld * (split ? 2 : 1));
  float* sS = reinterpret_cast<float*>(smem + off);
  off += align128(sizeof(float) * HQ * LDS);
  bf16* sDh = reinterpret_cast<bf16*>(smem + off);
  bf16* sDl = sDh + align128(sizeof(bf16) * HQ * LDD) / sizeof(bf16);

  const float temp = *in.temp, gnn = *g_nn;
  const long long kbase = ((long long)j * nk + k0) * d;
  load_tile(sK, in.kh + kbase, HK, HK, d, ld);
  if (split) load_tile(sKl, in.kl + kbase, HK, HK, d, ld);

  const int rt = warp & 3, ct = warp >> 2;  // sim block of the 64 x 32 tile
  const int kt = warp & 1, cg = warp >> 1;  // dK: keys kt, column group cg
  const int nf = d / 64, col0 = cg * (d / 4);
  FragC acc[MAX_D / 64];
  FOR_FRAGS(f) wmma::fill_fragment(acc[f], 0.0f);
  for (int i = 0; i < in.bq; ++i) {
    const long long pair = (long long)i * in.bk + j;
    const float g = g_clip[pair];
    for (int q0 = 0; q0 < nq; q0 += HQ) {
      __syncthreads();
      const long long qbase = ((long long)i * nq + q0) * d;
      load_tile(sQ, in.qh + qbase, HQ, nq - q0, d, ld);
      if (split) load_tile(sQl, in.ql + qbase, HQ, nq - q0, d, ld);
      __syncthreads();
      FragC s;
      sim_block(s, sQ + rt * 16 * ld, sQl + rt * 16 * ld, sK + ct * 16 * ld,
                sKl + ct * 16 * ld, ld, d, split);
      wmma::store_matrix_sync(sS + rt * 16 * LDS + ct * 16, s, LDS, wmma::mem_row_major);
      __syncthreads();
      for (int e = threadIdx.x; e < HQ * HK; e += THREADS) {
        const int r = e / HK, c = e % HK, a = q0 + r;
        float v = 0.0f;
        if (a < nq)
          v = dts_of(sS[r * LDS + c], temp, amax[pair * nq + a] == k0 + c,
                     g * in.coeff[(long long)i * nq + a], gnn, in.clamp_min);
        triad::split_bf16(v, sDh + r * LDD + c, sDl + r * LDD + c);
      }
      __syncthreads();
      // dK += dts^T Q over this tile's 64 query rows
      for (int kk = 0; kk < HQ; kk += 16) {
        FragAT ah, al;
        wmma::load_matrix_sync(ah, sDh + kk * LDD + kt * 16, LDD);
        wmma::load_matrix_sync(al, sDl + kk * LDD + kt * 16, LDD);
        FOR_FRAGS(f) {
          FragB b;
          wmma::load_matrix_sync(b, sQ + kk * ld + col0 + f * 16, ld);
          wmma::mma_sync(acc[f], ah, b, acc[f]);
          wmma::mma_sync(acc[f], al, b, acc[f]);
          if (split) {
            wmma::load_matrix_sync(b, sQl + kk * ld + col0 + f * 16, ld);
            wmma::mma_sync(acc[f], ah, b, acc[f]);
          }
        }
      }
    }
  }
  FOR_FRAGS(f)
    wmma::store_matrix_sync(dk + ((long long)j * nk + k0 + kt * 16) * d + col0 + f * 16, acc[f],
                            d, wmma::mem_row_major);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

bool bad_shape(const Inputs& in) {
  return in.bq <= 0 || in.bk <= 0 || in.nq <= 0 || in.nk <= 0 || in.nk % 64 != 0 ||
         in.d <= 0 || in.d % 64 != 0 || in.d > MAX_D;
}

Inputs inputs_of(const void* qh, const void* ql, const void* kh, const void* kl,
                 const void* coeff, const void* temp, int bq, int bk, int nq, int nk, int d,
                 float clamp_min) {
  return Inputs{(const bf16*)qh, (const bf16*)ql, (const bf16*)kh, (const bf16*)kl,
                (const float*)coeff, (const float*)temp, bq, bk, nq, nk, d, clamp_min};
}

}  // namespace

// q (Bq, Nq, D) and k (Bk, Nk, D) contiguous bf16, as hi and lo halves (the
// lo pointers null for bf16 features, both set for split fp32 features);
// coeff (Bq, Nq) fp32; temp: the fp32 temperature on the device. Writes
// clip (Bq, Bk) fp32, amax (Bq, Bk, Nq) int32 (first argmax over keys) and
// partials (Bq, Bk, 2) fp32 (the pair's clamp^2 and window ts^2 sums).
// Returns a cudaError_t.
extern "C" int triad_maxmean_fwd(const void* qh, const void* ql, const void* kh, const void* kl,
                                 const void* coeff, const void* temp, void* clip, void* amax,
                                 void* partials, int bq, int bk, int nq, int nk, int d,
                                 float clamp_min, void* stream) {
  const Inputs in = inputs_of(qh, ql, kh, kl, coeff, temp, bq, bk, nq, nk, d, clamp_min);
  if (bad_shape(in)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(d, nq, ql != nullptr);
  int err = prepare(maxmean_fwd_kernel, smem);
  if (err) return err;
  maxmean_fwd_kernel<<<dim3(bk, bq), THREADS, smem, (cudaStream_t)stream>>>(
      in, (float*)clip, (int*)amax, (float*)partials);
  return (int)cudaGetLastError();
}

// dq (Bq, Nq, D) fp32 from the forward's inputs and amax, g_clip (Bq, Bk)
// fp32 and g_nn, the fp32 cotangent of the clamp^2 sum on the device.
extern "C" int triad_maxmean_dq(const void* qh, const void* ql, const void* kh, const void* kl,
                                const void* coeff, const void* temp, const void* g_clip,
                                const void* g_nn, const void* amax, void* dq, int bq, int bk,
                                int nq, int nk, int d, float clamp_min, void* stream) {
  const Inputs in = inputs_of(qh, ql, kh, kl, coeff, temp, bq, bk, nq, nk, d, clamp_min);
  if (bad_shape(in)) return (int)cudaErrorInvalidValue;
  const size_t smem = dq_smem(d, ql != nullptr);
  int err = prepare(maxmean_dq_kernel, smem);
  if (err) return err;
  maxmean_dq_kernel<<<dim3((nq + GQ - 1) / GQ, bq), THREADS, smem, (cudaStream_t)stream>>>(
      in, (const float*)g_clip, (const float*)g_nn, (const int*)amax, (float*)dq);
  return (int)cudaGetLastError();
}

// dk (Bk, Nk, D) fp32, with the arguments of triad_maxmean_dq.
extern "C" int triad_maxmean_dk(const void* qh, const void* ql, const void* kh, const void* kl,
                                const void* coeff, const void* temp, const void* g_clip,
                                const void* g_nn, const void* amax, void* dk, int bq, int bk,
                                int nq, int nk, int d, float clamp_min, void* stream) {
  const Inputs in = inputs_of(qh, ql, kh, kl, coeff, temp, bq, bk, nq, nk, d, clamp_min);
  if (bad_shape(in)) return (int)cudaErrorInvalidValue;
  const size_t smem = dk_smem(d, ql != nullptr);
  int err = prepare(maxmean_dk_kernel, smem);
  if (err) return err;
  maxmean_dk_kernel<<<dim3(nk / HK, bk), THREADS, smem, (cudaStream_t)stream>>>(
      in, (const float*)g_clip, (const float*)g_nn, (const int*)amax, (float*)dk);
  return (int)cudaGetLastError();
}

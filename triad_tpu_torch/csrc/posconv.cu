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
// (fp32), a product per tap k whose reduction axis is the row (b, t):
// one block per (16 taps, group), 128 blocks at K = 128 and 16 groups, a
// single wave on the 132 SMs, each reducing over every row. Rows are
// staged 128 at a time, the dz tile and the x window of 128 + 15 rows the
// block's 16 taps read, by TMA into a 6-slot ring (full and empty
// mbarriers; thread 0 refills a slot once every warp has released it), so
// the copies of tiles i + 1 .. i + 5 overlap the products of tile i and
// the warps that multiply run no copy instructions and no block-wide
// barrier. Rows outside [0, N) read as zeros. A copy box is 56 channels
// wide (the group's 48 and 8 more, zeros past C): 112-byte rows, on which
// the 8 rows of an ldmatrix fall on distinct banks. Warp w owns taps 2w
// and 2w + 1 and keeps their 2 x 48 x 48 fp32 sums in registers for the
// whole reduction: bf16 mma.sync m16n8k16 with dz^T as A and the x window
// as B, both read by ldmatrix.trans, which takes the one-row shift of
// each tap at any 16-byte-aligned row. The sums leave through shared
// memory in torch's (C, 48, K) weight layout. No atomics and no split of
// the rows across blocks: each sum runs in one fixed order, so dW is the
// same from run to run.
//
// What bounds it on the card: operations. Each pass (forward, dX, dW) is
// 2 * B * N * C * K * 48 = 301.4 GFLOP at (64, 499, 768), K = 128: 0.305 ms
// at the bf16 tensor-core peak; the bytes (x and the output, 98 MB) take
// 0.03 ms. Every forward block re-streams its group's 590 KB of weights
// from L2; every dW block reads its group's x and dz (6.1 MB at B = 64)
// through L2, 8 times over the 8 tap blocks of a group.
#include "attention_tiles.cuh"
#include "common.cuh"
#include "hopper.cuh"

using namespace nvcuda;

namespace {

using triad::bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr int CPG = 48;        // channels per group (768 / 16)
constexpr int NB = CPG / 16;   // 16-wide blocks of a group's channels
constexpr int TM = 128;        // forward: output rows per block
constexpr int KCH = 8;         // taps per staged weight chunk
constexpr int THREADS = 256;   // 8 warps
constexpr int LDX = CPG;       // bf16 row stride: 96 B keeps every WMMA row 32-byte aligned
constexpr int LDO = CPG + 4;   // fp32 epilogue row stride
constexpr int WCHUNK = KCH * CPG * CPG;  // bf16 elements of one weight chunk
constexpr int MAX_SMEM = 232448;
// dW
constexpr int DW_TAPS = 16;                      // taps per block, 2 per warp
constexpr int DW_ROWS = 128;                     // rows per staged tile
constexpr int DW_XROWS = DW_ROWS + DW_TAPS - 1;  // x window rows of a tile
constexpr int DW_STAGES = 6;
constexpr int DW_LD = CPG + 8;  // channels of a copy box, 112-byte rows
constexpr int DW_DZ = DW_ROWS * DW_LD;            // bf16 elements of a dz tile (128-byte multiple)
constexpr int DW_STAGE = (DW_ROWS + DW_XROWS + 1) * DW_LD;  // a stage, rounded to 128 bytes
constexpr uint32_t DW_TX = sizeof(bf16) * (DW_ROWS + DW_XROWS) * DW_LD;  // bytes a stage lands
static_assert(DW_STAGE * sizeof(bf16) % 128 == 0 && DW_DZ * sizeof(bf16) % 128 == 0,
              "TMA destinations 128-byte aligned");
constexpr int DW_OLD = CPG + 8;         // fp32 row stride of an output plane: a warp's
                                        // float2 writes fall on distinct banks
constexpr int DW_PLANE = CPG * DW_OLD;  // one tap's 48 x 48 sums
// The ring, then the output planes in the same bytes, then the barriers.
constexpr size_t DW_RING = sizeof(bf16) * DW_STAGES * DW_STAGE;
constexpr size_t DW_BUF =
    DW_RING > DW_TAPS * DW_PLANE * sizeof(float) ? DW_RING : DW_TAPS * DW_PLANE * sizeof(float);
constexpr size_t DW_SMEM = DW_BUF + 2 * DW_STAGES * sizeof(uint64_t);

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

__global__ void __launch_bounds__(THREADS, 1)
posconv_dw_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_dz, float* __restrict__ dw,
                  int batch, int n, int k, int left) {
  namespace hp = triad::hopper;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_BUF);
  uint64_t* empty = full + DW_STAGES;
  const int kt0 = blockIdx.x * DW_TAPS, g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tpb = (n + DW_ROWS - 1) / DW_ROWS;  // row tiles per batch row
  const int ntiles = batch * tpb;

  // Tile `tile` (batch row tile / tpb, rows t0 .. t0 + DW_ROWS - 1) into
  // slot s: the dz tile, then the x window of rows t0 - left + kt0 .. +
  // DW_XROWS - 1.
  auto issue = [&](int s, int tile) {
    const int b = tile / tpb, t0 = (tile - b * tpb) * DW_ROWS;
    bf16* sdz = ring + s * DW_STAGE;
    hp::mbar_expect_tx(&full[s], DW_TX);
    hp::tma_load_3d(sdz, &map_dz, &full[s], g * CPG, t0, b);
    hp::tma_load_3d(sdz + DW_DZ, &map_x, &full[s], g * CPG, t0 - left + kt0, b);
  };
  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], THREADS / 32);
    }
    hp::fence_mbarrier_init();
    for (int s = 0; s < DW_STAGES && s < ntiles; ++s) issue(s, s);
  }
  __syncthreads();

  // acc[j][m][f]: tap kt0 + 2 warp + j, outputs 16m .. 16m + 15, inputs
  // 8f .. 8f + 7, as an m16n8 fragment (tiles::frag_row / frag_col).
  float acc[2][NB][2 * NB][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int f = 0; f < 2 * NB; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][m][f][e] = 0.0f;

  // ldmatrix.x4.trans row addresses: lane l feeds row l % 8 of 8 x 8 matrix
  // l / 8. A (dz^T, 16 outputs x 16 rows): matrix q covers outputs + 8 (q &
  // 1), rows + 8 (q >> 1). B (x window, 16 rows x 16 inputs): rows + 8 (q &
  // 1), inputs + 8 (q >> 1).
  const int a_off = (((lane >> 4) << 3) + (lane & 7)) * DW_LD + (((lane >> 3) & 1) << 3);
  const int b_off = ((((lane >> 3) & 1) << 3) + (lane & 7) + 2 * warp) * DW_LD + ((lane >> 4) << 3);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % DW_STAGES, parity = (it / DW_STAGES) & 1;
    hp::mbar_wait(&full[s], parity);
    const bf16* sdz = ring + s * DW_STAGE;
    const bf16* sx = sdz + DW_DZ;
#pragma unroll
    for (int ks = 0; ks < DW_ROWS / 16; ++ks) {
      uint32_t a[NB][4], bx[2][NB][4];
#pragma unroll
      for (int m = 0; m < NB; ++m)
        triad::tiles::ldsm_x4_t(a[m], sdz + ks * 16 * DW_LD + a_off + m * 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int p = 0; p < NB; ++p)
          triad::tiles::ldsm_x4_t(bx[j][p], sx + (ks * 16 + j) * DW_LD + b_off + p * 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int m = 0; m < NB; ++m)
#pragma unroll
          for (int p = 0; p < NB; ++p) {
            triad::tiles::mma(acc[j][m][2 * p], a[m], bx[j][p][0], bx[j][p][1]);
            triad::tiles::mma(acc[j][m][2 * p + 1], a[m], bx[j][p][2], bx[j][p][3]);
          }
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[s]);  // this warp is done with slot s
    if (tid == 0 && it + DW_STAGES < ntiles) {
      hp::mbar_wait(&empty[s], parity);
      issue(s, it + DW_STAGES);
    }
  }
  // dW in torch's (C, 48, K) layout: the block's 16 taps of an (o, i) pair
  // are 64 contiguous bytes. The sums go through shared memory (the ring's
  // bytes, free once every tile is consumed) as 16 planes [tap][o][i],
  // read back a pair's taps at a time.
  __syncthreads();
  float* plane = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int f = 0; f < 2 * NB; ++f) {
        float* p = plane + ((2 * warp + j) * CPG + m * 16 + triad::tiles::frag_row(lane, 0)) *
                               DW_OLD + f * 8 + triad::tiles::frag_col(lane, 0);
        *reinterpret_cast<float2*>(p) = make_float2(acc[j][m][f][0], acc[j][m][f][1]);
        *reinterpret_cast<float2*>(p + 8 * DW_OLD) = make_float2(acc[j][m][f][2], acc[j][m][f][3]);
      }
  __syncthreads();
  const int ntaps = min(DW_TAPS, k - kt0);  // 8 or 16: k % 8 == 0
  for (int e = tid; e < CPG * CPG; e += THREADS) {
    const int o = e / CPG, i = e - o * CPG;
    float* out = dw + ((size_t)(g * CPG + o) * CPG + i) * k + kt0;
    const float* in = plane + o * DW_OLD + i;
    for (int q = 0; q < ntaps; q += 4)
      *reinterpret_cast<float4*>(out + q) =
          make_float4(in[q * DW_PLANE], in[(q + 1) * DW_PLANE], in[(q + 2) * DW_PLANE],
                      in[(q + 3) * DW_PLANE]);
  }
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

// x, dz: contiguous bf16 (B, n, c), 16-byte aligned; dw: fp32 (c, 48, k),
// torch's Conv1d weight layout (dw[g * 48 + o][i][k] = dW[g][k][o][i]),
// 16-byte aligned, every element written. c % 48 == 0, k % 8 == 0.
// Returns a cudaError_t.
extern "C" int triad_posconv_dw(const void* x, const void* dz, void* dw, int batch, int n, int c,
                                int k, int left, void* stream) {
  if (batch <= 0 || n <= 0 || c % CPG || k % KCH || k <= 0) return (int)cudaErrorInvalidValue;
  // (channel, row, batch row), innermost first
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)c * sizeof(bf16), (cuuint64_t)n * c * sizeof(bf16)};
  const cuuint32_t box_dz[3] = {DW_LD, DW_ROWS, 1}, box_x[3] = {DW_LD, DW_XROWS, 1};
  CUtensorMap map_x, map_dz;
  if (!triad::hopper::encode(&map_dz, dz, 3, dims, strides, box_dz, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !triad::hopper::encode(&map_x, x, 3, dims, strides, box_x, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(posconv_dw_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  posconv_dw_kernel<<<dim3((k + DW_TAPS - 1) / DW_TAPS, c / CPG), THREADS, DW_SMEM,
                      (cudaStream_t)stream>>>(map_x, map_dz, (float*)dw, batch, n, k, left);
  return (int)cudaGetLastError();
}

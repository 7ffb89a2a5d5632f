// The stride-2 VALID conv GEMM of HuBERT's frontend (k taps over a
// row-major (T, cin) bf16 activation), shared by frontend.cu's conv +
// GELU-epilogue kernel and frontend_conv.cu's fused-prologue kernel.
//
// Window t covers input rows 2t .. 2t + k - 1, which are contiguous, so
// the A operand is the activation viewed with a leading dimension of
// 2 * cin and a depth of k * cin: no im2col copy is made. B is the conv
// weight as (k * cin, cout) row-major (tap-major, then input channel).
// WMMA bf16 tensor-core tiles of 128 x 128 x 32 with fp32 accumulation
// and a two-stage cp.async ring. A prologue may rewrite each staged A
// tile in shared memory before its products (the fused input
// activation); the epilogue maps each fp32 sum to the bf16 it stores.
#pragma once

#include "common.cuh"

namespace triad {
namespace conv_s2 {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA = BK + 8, LDB = BN + 8, LDE = 16 + 4;
constexpr int THREADS = 256;  // 8 warps: 4 (M) x 2 (N), 32 x 64 each

// The prologue that leaves the staged input as it is.
struct NoPrologue {
  static constexpr bool kActive = false;
  __device__ void operator()(bf16*, int, int) const {}
};

// One BM x BN output tile (rows blockIdx.x * BM, columns blockIdx.y * BN)
// of one batch row: xa (T, cin) with T >= 2 * (tout - 1) + ktaps, ya
// (tout, cout). cin a multiple of BK, cout of BN; xa, w 16-byte aligned.
// prologue(tile, k0, tid) runs on every staged A tile (rows m0 .., depth
// columns k0 .. k0 + BK) after it lands; epilogue(float) -> bf16.
template <class Prologue, class Epilogue>
__device__ __forceinline__ void gemm_tile(const bf16* __restrict__ xa, int cin,
                                          const bf16* __restrict__ w, int cout,
                                          bf16* __restrict__ ya, int tout, int ktaps,
                                          const Prologue& prologue, const Epilogue& epilogue) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 sA[2][BM * LDA];
  __shared__ __align__(128) bf16 sB[2][BK * LDB];
  __shared__ __align__(128) float sE[8][16 * LDE];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp >> 1, wn = warp & 1;
  const int K = ktaps * cin;

  auto load = [&](int stage, int k0) {
    // A: 128 rows x 32 cols = 512 16-byte vectors, 2 per thread.
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = m0 + r < tout;
      cp_async16(&sA[stage][r * LDA + c],
                 ok ? xa + (long long)(m0 + r) * (2 * cin) + k0 + c : xa, ok);
    }
    // B: 32 rows x 128 cols = 512 vectors, 2 per thread.
    for (int i = tid; i < BK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      cp_async16(&sB[stage][r * LDB + c], w + (long long)(k0 + r) * cout + n0 + c, true);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nkt = K / BK;
  load(0, 0);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Prologue::kActive) {
      prologue(sA[kt & 1], kt * BK, tid);
      __syncthreads();
    }
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

  // Epilogue through a per-warp 16 x 16 staging tile, 8 channels (16
  // bytes) per lane.
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
        for (int q = 0; q < 8; ++q) out[q] = epilogue(e[er * LDE + ec + q]);
        bf16* dst = ya + (long long)row * cout + n0 + wn * 64 + j * 16 + ec;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
      }
      __syncwarp();
    }
  }
}

}  // namespace conv_s2
}  // namespace triad

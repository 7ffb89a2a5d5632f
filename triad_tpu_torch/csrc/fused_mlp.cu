// Fused transformer MLP forward: y = dropout(gelu(x W1^T + b1)) W2^T + b2,
// bf16 in and out, fp32 accumulation; its backward (dx, dh, g) follows
// further down.
//
// Replaces triad_tpu/ops/pallas_mlp.py:fused_mlp's forward (_fwd :174,
// body _fwd_kernel :88). Activation dropout (p > 0): the keep bit of
// (row b * N + t, hidden unit c) is triad::keep4 under key (seed, 0), so
// the backward replays it whatever its tiling; a kept GELU output is
// multiplied by 1 / (1 - p) in fp32 before the bf16 rounding, a dropped
// one is 0. The GELU pass keeps one element per thread, so every thread
// draws the four words of its unit's group of four and keeps its own
// (four times the draws, none of the threads idle). The TPU kernel holds a whole
// (T, 3072) hidden tile in ~100 MB of VMEM; a Hopper SM has 227 KB of
// shared memory, so this kernel walks the hidden dimension in 16-wide
// chunks instead: for each chunk it computes h = x W1[chunk]^T + b1 with
// fp32 accumulation, applies GELU (tanh or erf form) in fp32, rounds to
// bf16 (the TPU kernel's g.astype(w2.dtype)) and accumulates g W2[:,
// chunk]^T into a BM x Dout fp32 tile held in registers (WMMA
// fragments). The hidden activation never reaches device memory.
//
// Weights use torch's Linear layout: w1 (Dh, Din), w2 (Dout, Dh).
//
// What bounds it on the card: every BM-row block streams all of W1 and
// W2 (9.4 MB bf16 at 768/3072) from L2 through shared memory, about 32
// FLOP per byte at BM = 32, so L2 bandwidth, not the tensor cores, sets
// the ceiling. The chunks arrive through a two-stage cp.async ring, so
// the next chunk's weights load while the current one computes. BM is 32
// unless 16-row blocks fit in one wave over the SMs (ViT's 8 x 261
// rows), which trades weight re-reads for occupancy. Larger row tiles need
// more accumulator registers than WMMA leaves (the 768-wide fp32 row
// tile); wgmma with TMA is the next step.
#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int HC = 16;        // hidden chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int LDW2 = HC + 8;
constexpr int LDH = HC + 4;
constexpr int LDG = HC + 8;
constexpr int MAX_SMEM = 232448;

struct Layout {
  size_t x, stage, w2_in_stage, stage_bytes, h, g, total;
};

__host__ __device__ inline size_t up128(size_t v) { return (v + 127) / 128 * 128; }

template <int BM>
__host__ __device__ inline Layout layout(int din, int dout) {
  constexpr int KS = 8 / (BM / 16);  // K splits of GEMM 1 (one h fragment per warp)
  Layout L;
  const size_t ldx = din + 8;
  L.x = 0;
  L.stage = up128(BM * ldx * 2);
  L.w2_in_stage = up128(HC * ldx * 2);
  L.stage_bytes = up128(L.w2_in_stage + (size_t)dout * LDW2 * 2);
  size_t region = 2 * L.stage_bytes;
  const size_t yb = (size_t)BM * (dout + 4) * 4;  // epilogue reuses the ring
  if (yb > region) region = yb;
  L.h = L.stage + up128(region);
  L.g = L.h + up128((size_t)KS * BM * LDH * 4);
  L.total = L.g + up128(BM * LDG * 2);
  return L;
}

template <int BM, int DOUT>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const triad::bf16* __restrict__ x, const triad::bf16* __restrict__ w1,
                 const triad::bf16* __restrict__ b1, const triad::bf16* __restrict__ w2,
                 const triad::bf16* __restrict__ b2, triad::bf16* __restrict__ y, int m,
                 int din, int dh, int tanh_form, triad::Dropout dp) {
  using triad::bf16;
  constexpr int WR = BM / 16;       // warp rows in GEMM 2
  constexpr int WC = 8 / WR;        // warp columns in GEMM 2
  constexpr int NF = DOUT / 16 / WC;  // output fragments per warp
  constexpr int KS = 8 / WR;        // GEMM 1: WR h fragments x KS K-splits
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout<BM>(din, DOUT);
  const int ldx = din + 8;
  bf16* sX = reinterpret_cast<bf16*>(smem + L.x);
  float* sY = reinterpret_cast<float*>(smem + L.stage);
  float* sH = reinterpret_cast<float*>(smem + L.h);
  bf16* sG = reinterpret_cast<bf16*>(smem + L.g);
  auto sW1 = [&](int s) { return reinterpret_cast<bf16*>(smem + L.stage + s * L.stage_bytes); };
  auto sW2 = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L.stage + s * L.stage_bytes + L.w2_in_stage);
  };

  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int vx = din / 8;

  auto load_chunk = [&](int s, int c0) {
    bf16* d1 = sW1(s);
    for (int i = tid; i < HC * vx; i += THREADS) {
      const int r = i / vx, c = (i % vx) * 8;
      triad::cp_async16(d1 + r * ldx + c, w1 + (long long)(c0 + r) * din + c, true);
    }
    bf16* d2 = sW2(s);
    for (int i = tid; i < DOUT * (HC / 8); i += THREADS) {
      const int r = i / (HC / 8), c = (i % (HC / 8)) * 8;
      triad::cp_async16(d2 + r * LDW2 + c, w2 + (long long)r * dh + c0 + c, true);
    }
  };

  for (int i = tid; i < BM * vx; i += THREADS) {
    const int r = i / vx, c = (i % vx) * 8;
    const bool ok = m0 + r < m;
    triad::cp_async16(sX + r * ldx + c, ok ? x + (long long)(m0 + r) * din + c : x, ok);
  }
  load_chunk(0, 0);
  triad::cp_async_commit();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  const int hr = warp % WR, split = warp / WR;  // GEMM 1 role
  const int k_len = din / KS, k_lo = split * k_len;
  const int wr = warp / WC, wc = warp % WC;     // GEMM 2 role

  const int nchunks = dh / HC;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int s = ci & 1, c0 = ci * HC;
    triad::cp_async_wait<0>();
    __syncthreads();  // chunk ci landed; chunk ci-1 fully consumed
    if (ci + 1 < nchunks) {
      load_chunk(s ^ 1, c0 + HC);
      triad::cp_async_commit();
    }
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
      wmma::fill_fragment(hacc, 0.0f);
      const bf16* w1s = sW1(s);
      for (int kk = k_lo; kk < k_lo + k_len; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(a, sX + hr * 16 * ldx + kk, ldx);
        wmma::load_matrix_sync(bw, w1s + kk, ldx);
        wmma::mma_sync(hacc, a, bw, hacc);
      }
      wmma::store_matrix_sync(sH + (split * BM + hr * 16) * LDH, hacc, LDH,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < BM * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      float h = __bfloat162float(b1[c0 + c]);
      for (int k = 0; k < KS; ++k) h += sH[(k * BM + r) * LDH + c];
      float g = triad::gelu(h, tanh_form);
      if (dp.active) {
        const triad::Keep4 kb =
            triad::keep4(dp.seed, 0u, (uint32_t)(m0 + r), (uint32_t)(c0 + c) >> 2);
        g = triad::keep_word(kb, c0 + c) >= dp.thresh ? g * dp.scale : 0.0f;
      }
      sG[r * LDG + c] = __float2bfloat16(g);
    }
    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ga;
    wmma::load_matrix_sync(ga, sG + wr * 16 * LDG, LDG);
    const bf16* w2s = sW2(s);
    for (int f = 0; f < NF; ++f) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(bw, w2s + (wc * NF + f) * 16 * LDW2, LDW2);
      wmma::mma_sync(acc[f], ga, bw, acc[f]);
    }
  }
  __syncthreads();
  constexpr int LDY = DOUT + 4;
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(sY + wr * 16 * LDY + (wc * NF + f) * 16, acc[f], LDY,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * (DOUT / 2); i += THREADS) {
    const int r = i / (DOUT / 2), c = (i % (DOUT / 2)) * 2;
    if (m0 + r >= m) continue;
    const float v0 = sY[r * LDY + c] + __bfloat162float(b2[c]);
    const float v1 = sY[r * LDY + c + 1] + __bfloat162float(b2[c + 1]);
    *reinterpret_cast<__nv_bfloat162*>(y + (long long)(m0 + r) * DOUT + c) =
        __floats2bfloat162_rn(v0, v1);
  }
}

template <int BM, int DOUT>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* y, int m, int din, int dh, int tanh_form, triad::Dropout dp,
           cudaStream_t stream) {
  const Layout L = layout<BM>(din, DOUT);
  if (L.total > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<BM, DOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_kernel<BM, DOUT><<<(m + BM - 1) / BM, THREADS, L.total, stream>>>(
      (const triad::bf16*)x, (const triad::bf16*)w1, (const triad::bf16*)b1,
      (const triad::bf16*)w2, (const triad::bf16*)b2, (triad::bf16*)y, m, din, dh, tanh_form, dp);
  return (int)cudaGetLastError();
}

template <int DOUT>
int launch_rows(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                void* y, int m, int din, int dh, int tanh_form, triad::Dropout dp,
                cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if ((m + 15) / 16 <= sms)  // one wave of 16-row blocks
    return launch<16, DOUT>(x, w1, b1, w2, b2, y, m, din, dh, tanh_form, dp, stream);
  return launch<32, DOUT>(x, w1, b1, w2, b2, y, m, din, dh, tanh_form, dp, stream);
}

// ------------------------------------------------------------------------
// Backward: replaces pallas_mlp._bwd_call (:197, body _bwd_kernel :114).
// Per 16-row block it walks the hidden dimension in the forward's 16-wide
// chunks through the same two-stage cp.async ring:
//   h  = x W1[c]^T + b1        (fp32 accumulation)
//   dg = dy W2[:, c]           (fp32 accumulation of exact bf16 products,
//                               the TPU body's fp32 dy . W2^T)
//   with dropout, the forward's keep bits replayed: g = gelu(h) * keep /
//   (1 - p) and dg = dg * keep / (1 - p)
//   dh = dg * gelu'(h)         (fp32; tanh or erf form)
//   writes bf16 dh and the dropped g for the weight gradients, and
//   dx += bf16(dh) W1[c]       (fp32 accumulator tile in registers)
// x and dy stay resident in shared memory, so 32-row blocks no longer fit
// beside the ring; every 16-row block re-streams W1 and W2 from L2 (the
// same bound as the forward, at half its rows per weight byte).

constexpr int BBM = 16;  // backward rows per block
constexpr int BKS = 8;   // K splits of the two chunk GEMMs (one per warp)

struct BwdLayout {
  size_t x, dy, stage, w2_in_stage, stage_bytes, h, dg, dh, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int din, int dout) {
  BwdLayout L;
  const size_t ldx = din + 8, ldy = dout + 8;
  L.x = 0;
  L.dy = up128(BBM * ldx * 2);
  L.stage = L.dy + up128(BBM * ldy * 2);
  L.w2_in_stage = up128(HC * ldx * 2);
  L.stage_bytes = up128(L.w2_in_stage + (size_t)dout * LDW2 * 2);
  size_t region = 2 * L.stage_bytes;
  const size_t xb = (size_t)BBM * (din + 4) * 4;  // epilogue reuses the ring
  if (xb > region) region = xb;
  L.h = L.stage + up128(region);
  L.dg = L.h + up128((size_t)BKS * BBM * LDH * 4);
  L.dh = L.dg + up128((size_t)BKS * BBM * LDH * 4);
  L.total = L.dh + up128(BBM * LDG * 2);
  return L;
}

template <int DIN>
__global__ void __launch_bounds__(THREADS)
fused_mlp_bwd_kernel(const triad::bf16* __restrict__ x, const triad::bf16* __restrict__ w1,
                     const triad::bf16* __restrict__ b1, const triad::bf16* __restrict__ w2,
                     const triad::bf16* __restrict__ dy, triad::bf16* __restrict__ dx,
                     triad::bf16* __restrict__ dh_out, triad::bf16* __restrict__ g_out, int m,
                     int dout, int dh, int tanh_form, triad::Dropout dp) {
  using triad::bf16;
  constexpr int NF = DIN / 16 / 8;  // dx fragments per warp (8 warps side by side)
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = bwd_layout(DIN, dout);
  const int ldx = DIN + 8, ldy = dout + 8;
  bf16* sX = reinterpret_cast<bf16*>(smem + L.x);
  bf16* sDY = reinterpret_cast<bf16*>(smem + L.dy);
  float* sOut = reinterpret_cast<float*>(smem + L.stage);
  float* sH = reinterpret_cast<float*>(smem + L.h);
  float* sDG = reinterpret_cast<float*>(smem + L.dg);
  bf16* sDH = reinterpret_cast<bf16*>(smem + L.dh);
  auto sW1 = [&](int s) { return reinterpret_cast<bf16*>(smem + L.stage + s * L.stage_bytes); };
  auto sW2 = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L.stage + s * L.stage_bytes + L.w2_in_stage);
  };

  const int m0 = blockIdx.x * BBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  auto load_chunk = [&](int s, int c0) {
    bf16* d1 = sW1(s);
    for (int i = tid; i < HC * (DIN / 8); i += THREADS) {
      const int r = i / (DIN / 8), c = (i % (DIN / 8)) * 8;
      triad::cp_async16(d1 + r * ldx + c, w1 + (long long)(c0 + r) * DIN + c, true);
    }
    bf16* d2 = sW2(s);
    for (int i = tid; i < dout * (HC / 8); i += THREADS) {
      const int r = i / (HC / 8), c = (i % (HC / 8)) * 8;
      triad::cp_async16(d2 + r * LDW2 + c, w2 + (long long)r * dh + c0 + c, true);
    }
  };

  for (int i = tid; i < BBM * (DIN / 8); i += THREADS) {
    const int r = i / (DIN / 8), c = (i % (DIN / 8)) * 8;
    const bool ok = m0 + r < m;
    triad::cp_async16(sX + r * ldx + c, ok ? x + (long long)(m0 + r) * DIN + c : x, ok);
  }
  for (int i = tid; i < BBM * (dout / 8); i += THREADS) {
    const int r = i / (dout / 8), c = (i % (dout / 8)) * 8;
    const bool ok = m0 + r < m;
    triad::cp_async16(sDY + r * ldy + c, ok ? dy + (long long)(m0 + r) * dout + c : dy, ok);
  }
  load_chunk(0, 0);
  triad::cp_async_commit();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  const int kx = DIN / BKS, ky = dout / BKS;  // each warp's K slice of h and dg

  const int nchunks = dh / HC;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int s = ci & 1, c0 = ci * HC;
    triad::cp_async_wait<0>();
    __syncthreads();  // chunk ci landed; chunk ci-1 fully consumed
    if (ci + 1 < nchunks) {
      load_chunk(s ^ 1, c0 + HC);
      triad::cp_async_commit();
    }
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc, gacc;
      wmma::fill_fragment(hacc, 0.0f);
      wmma::fill_fragment(gacc, 0.0f);
      const bf16* w1s = sW1(s);
      for (int kk = warp * kx; kk < (warp + 1) * kx; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(a, sX + kk, ldx);
        wmma::load_matrix_sync(bw, w1s + kk, ldx);
        wmma::mma_sync(hacc, a, bw, hacc);
      }
      const bf16* w2s = sW2(s);
      for (int kk = warp * ky; kk < (warp + 1) * ky; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(a, sDY + kk, ldy);
        wmma::load_matrix_sync(bw, w2s + kk * LDW2, LDW2);
        wmma::mma_sync(gacc, a, bw, gacc);
      }
      wmma::store_matrix_sync(sH + warp * BBM * LDH, hacc, LDH, wmma::mem_row_major);
      wmma::store_matrix_sync(sDG + warp * BBM * LDH, gacc, LDH, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < BBM * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      float h = __bfloat162float(b1[c0 + c]);
      float dg = 0.0f;
      for (int k = 0; k < BKS; ++k) {
        h += sH[(k * BBM + r) * LDH + c];
        dg += sDG[(k * BBM + r) * LDH + c];
      }
      float g = triad::gelu(h, tanh_form);
      if (dp.active) {
        const triad::Keep4 kb =
            triad::keep4(dp.seed, 0u, (uint32_t)(m0 + r), (uint32_t)(c0 + c) >> 2);
        const bool keep = triad::keep_word(kb, c0 + c) >= dp.thresh;
        g = keep ? g * dp.scale : 0.0f;
        dg = keep ? dg * dp.scale : 0.0f;
      }
      const bf16 dhb = __float2bfloat16(dg * triad::gelu_grad(h, tanh_form));
      sDH[r * LDG + c] = dhb;
      if (m0 + r < m) {
        const long long o = (long long)(m0 + r) * dh + c0 + c;
        dh_out[o] = dhb;
        g_out[o] = __float2bfloat16(g);
      }
    }
    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> da;
    wmma::load_matrix_sync(da, sDH, LDG);
    const bf16* w1s = sW1(s);
    for (int f = 0; f < NF; ++f) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(bw, w1s + (warp * NF + f) * 16, ldx);
      wmma::mma_sync(acc[f], da, bw, acc[f]);
    }
  }
  __syncthreads();
  constexpr int LDO = DIN + 4;
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(sOut + (warp * NF + f) * 16, acc[f], LDO, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BBM * (DIN / 2); i += THREADS) {
    const int r = i / (DIN / 2), c = (i % (DIN / 2)) * 2;
    if (m0 + r >= m) continue;
    *reinterpret_cast<__nv_bfloat162*>(dx + (long long)(m0 + r) * DIN + c) =
        __floats2bfloat162_rn(sOut[r * LDO + c], sOut[r * LDO + c + 1]);
  }
}

template <int DIN>
int launch_bwd(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
               void* dx, void* dh_out, void* g_out, int m, int dout, int dh, int tanh_form,
               triad::Dropout dp, cudaStream_t stream) {
  const BwdLayout L = bwd_layout(DIN, dout);
  if (L.total > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bwd_kernel<DIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_bwd_kernel<DIN><<<(m + BBM - 1) / BBM, THREADS, L.total, stream>>>(
      (const triad::bf16*)x, (const triad::bf16*)w1, (const triad::bf16*)b1,
      (const triad::bf16*)w2, (const triad::bf16*)dy, (triad::bf16*)dx, (triad::bf16*)dh_out,
      (triad::bf16*)g_out, m, dout, dh, tanh_form, dp);
  return (int)cudaGetLastError();
}

}  // namespace

// x (m, din), w1 (dh, din), b1 (dh), w2 (dout, dh), dy (m, dout); outputs
// dx (m, din), dh_out and g (m, dh): contiguous bf16. din == 768 (the
// width of the ViT and HuBERT, the only one on a path), dout % 128 == 0,
// dh % 16 == 0; the dropout arguments are the forward's. Returns a
// cudaError_t.
extern "C" int triad_fused_mlp_bwd(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* dy, void* dx, void* dh_out,
                                   void* g_out, int m, int din, int dh, int dout, int tanh_form,
                                   unsigned seed, unsigned thresh, float keep_scale, int active,
                                   void* stream) {
  if (m <= 0 || dout % 128 || dh % HC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const triad::Dropout dp{seed, thresh, keep_scale, active};
  switch (din) {
    case 768:
      return launch_bwd<768>(x, w1, b1, w2, dy, dx, dh_out, g_out, m, dout, dh, tanh_form, dp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x (m, din), w1 (dh, din), b1 (dh), w2 (dout, dh), b2 (dout), y (m, dout):
// contiguous bf16. din % 128 == 0, dh % 16 == 0, dout in {256, 512, 768,
// 1024}; dropout: keep iff bits >= thresh, kept values times keep_scale,
// none when active == 0. Returns a cudaError_t.
extern "C" int triad_fused_mlp(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* y, int m, int din,
                               int dh, int dout, int tanh_form, unsigned seed, unsigned thresh,
                               float keep_scale, int active, void* stream) {
  if (m <= 0 || din % 128 || dh % HC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const triad::Dropout dp{seed, thresh, keep_scale, active};
  switch (dout) {
    case 256: return launch_rows<256>(x, w1, b1, w2, b2, y, m, din, dh, tanh_form, dp, s);
    case 512: return launch_rows<512>(x, w1, b1, w2, b2, y, m, din, dh, tanh_form, dp, s);
    case 768: return launch_rows<768>(x, w1, b1, w2, b2, y, m, din, dh, tanh_form, dp, s);
    case 1024: return launch_rows<1024>(x, w1, b1, w2, b2, y, m, din, dh, tanh_form, dp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

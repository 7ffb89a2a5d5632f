// Flash attention for head_dim 64, forward and backward, any N: the
// "flash" attention route.
//
// Replaces the TPU kernel behind triad_tpu/models/layers.py:
// flash_dot_product_attention (:36), JAX's library Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention: its forward
// (_flash_attention_kernel), its dK/dV kernel (_flash_attention_dkv_kernel)
// and its dQ kernel (_flash_attention_dq_kernel). The JAX adapter pads N to
// a multiple of 128 with masked keys and turns the key mask into segment
// ids; here the padded keys are never loaded: they count only in the row
// sum l of the forward (n_soft - n keys of zero k and v at the mask value).
//
// Numerics kept from the library kernel: S = q.k^T accumulated in fp32,
// times sm_scale, plus MASK_VALUE (-0.7 * FLT_MAX) on a masked key, so a
// row whose keys are all masked is uniform over its n_soft keys. Forward:
// an online softmax in fp32 (running max m, sum l), the un-normalised
// exp(S - m) rounded to bf16 before P.V with fp32 accumulation, O = acc /
// l at the end; m and l are written per row. The library walks 512-key
// blocks and rescales a normalised accumulator (within one block it
// divides P before the rounding); this kernel walks 64-key tiles, so its
// bf16 roundings of P differ from it by an ulp here and there.
// Backward: di = rowsum(O * dO) in fp32 from the bf16 O; P = exp(S - m) *
// (1 / l); dV = bf16(P)^T dO; dS = (dO V^T - di) * P * sm_scale; dK =
// bf16(dS)^T Q; dQ = bf16(dS) K, each product with fp32 accumulation.
//
// What bounds it on the card: at the model's shapes (N 128 to 1000, 64
// dims) the work per (batch, head) is a few N x N x 64 products, so the
// kernels are bound by how fast the tensor cores are fed, not by bytes.
// The design keeps everything the TPU kernel held in VMEM out of memory
// traffic, the FlashAttention-2 way: one block per (b, h, 64-row tile), 4
// warps of 16 rows; S, P and the accumulators live in mma.sync m16n8k16
// bf16 -> fp32 register fragments (no score rows in shared memory, so
// several blocks share an SM); the streamed operand's 64 x 64 tiles are
// double-buffered with cp.async, the next tile's copy overlapping this
// tile's products, one barrier per tile; tiles are XOR-swizzled in 16-byte
// chunks so the ldmatrix reads are free of bank conflicts. The backward
// is two kernels with no atomics, as the library splits it: dK/dV walks
// the query tiles for one key tile, dQ walks the key tiles for one query
// tile; a small kernel forms di first. Each recomputes S and P.
#include "attention_tiles.cuh"

namespace {

using triad::bf16;
using namespace triad::tiles;

// The library's DEFAULT_MASK_VALUE: -0.7 * finfo(f32).max, formed in
// double and rounded once to fp32, as Python and JAX do.
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ float key_bias(const float* mask, int j) {
  return mask[j] != 0.0f ? 0.0f : MASK_VALUE;
}

// ---------------------------------------------------------------------------
// Forward: one block per (b, h, 64-query tile), walking 64-key tiles.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ mask,
                 bf16* __restrict__ out, float* __restrict__ l_out, float* __restrict__ m_out,
                 View vq, View vk, View vv, View vo, int H, int n, int n_soft,
                 float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TILE_ELEMS;          // [2][TILE_ELEMS]
  bf16* sV = sK + 2 * TILE_ELEMS;      // [2][TILE_ELEMS]
  float* sBias = reinterpret_cast<float*>(sV + 2 * TILE_ELEMS);  // [2][TILE]

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qb = q + b * vq.b + h * vq.h;
  const bf16* kb = k + b * vk.b + h * vk.h;
  const bf16* vb = v + b * vv.b + h * vv.h;
  const float* mb = mask + (long long)b * n;
  const int tiles = (n + TILE - 1) / TILE;

  load_tile(sQ, qb, vq.r, q0, n, tid);
  load_tile(sK, kb, vk.r, 0, n, tid);
  load_tile(sV, vb, vv.r, 0, n, tid);
  triad::cp_async_commit();
  if (tid < TILE) sBias[tid] = tid < n ? key_bias(mb, tid) : -INFINITY;

  uint32_t qa[4][4];
  float acc[8][4];
  zero(acc);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows g, g + 8
  const int col = 2 * (lane & 3);

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    triad::cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < tiles) {
      const int nb = buf ^ 1, k0 = (t + 1) * TILE;
      load_tile(sK + nb * TILE_ELEMS, kb, vk.r, k0, n, tid);
      load_tile(sV + nb * TILE_ELEMS, vb, vv.r, k0, n, tid);
      triad::cp_async_commit();
      if (tid < TILE) sBias[nb * TILE + tid] = k0 + tid < n ? key_bias(mb, k0 + tid) : -INFINITY;
    }
    if (t == 0) load_a(qa, sQ, warp * 16, lane);
    float s[8][4];
    zero(s);
    mma_nt(s, qa, sK + buf * TILE_ELEMS, lane);
    const float* bias = sBias + buf * TILE;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b0 = bias[j * 8 + col], b1 = bias[j * 8 + col + 1];
      s[j][0] = s[j][0] * sm_scale + b0;
      s[j][1] = s[j][1] * sm_scale + b1;
      s[j][2] = s[j][2] * sm_scale + b0;
      s[j][3] = s[j][3] * sm_scale + b1;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    uint32_t pa[4][4];
    to_a(pa, s);
    mma_nn(acc, pa, sV + buf * TILE_ELEMS, lane);
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  // The adapter's padded keys: zero k and v at the mask value.
  const float pad = (float)(n_soft - n);
  l0 += pad * expf(MASK_VALUE - m0);
  l1 += pad * expf(MASK_VALUE - m1);
  const int r0 = q0 + warp * 16;
  store_rows(out + b * vo.b + h * vo.h, vo.r, acc, r0, n, lane, 1.0f / l0, 1.0f / l1);
  if ((lane & 3) == 0) {
    const long long row = ((long long)b * H + h) * n;
    const int r = r0 + (lane >> 2);
    if (r < n) {
      l_out[row + r] = l0;
      m_out[row + r] = m0;
    }
    if (r + 8 < n) {
      l_out[row + r + 8] = l1;
      m_out[row + r + 8] = m1;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 0: di = rowsum(O * dO) in fp32, 8 threads per row.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
flash_di_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ di,
                View vo, View vd, int H, int n) {
  const long long row = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
  const int c = (threadIdx.x & 7) * 8, h = blockIdx.y, b = blockIdx.z;
  float sum = 0.0f;
  const bool ok = row < n;
  if (ok) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * vo.b + h * vo.h + row * vo.r + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * vd.b + h * vd.h + row * vd.r + c);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(op[i]), df = __bfloat1622float2(dp[i]);
      sum += of.x * df.x + of.y * df.y;
    }
  }
#pragma unroll
  for (int s = 1; s < 8; s <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
  if (ok && (threadIdx.x & 7) == 0) di[((long long)b * H + h) * n + row] = sum;
}

// ---------------------------------------------------------------------------
// Backward 1: dK and dV, one block per (b, h, 64-key tile), walking the
// query tiles. Each warp owns 16 keys: S^T = K Q^T and dP^T = V dO^T in
// registers, dV += bf16(P^T) dO, dK += bf16(dS^T) Q.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ mask,
                 const bf16* __restrict__ dout, const float* __restrict__ l_in,
                 const float* __restrict__ m_in, const float* __restrict__ di,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, View vq, View vk, View vv,
                 View vd, View vdk, View vdv, int H, int n, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE_ELEMS;
  bf16* sQ = sV + TILE_ELEMS;          // [2][TILE_ELEMS]
  bf16* sD = sQ + 2 * TILE_ELEMS;      // dO, [2][TILE_ELEMS]
  float* sStat = reinterpret_cast<float*>(sD + 2 * TILE_ELEMS);  // [2][3][TILE]: m, 1/l, di

  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qb = q + b * vq.b + h * vq.h;
  const bf16* db = dout + b * vd.b + h * vd.h;
  const long long bh = ((long long)b * H + h) * n;
  const int tiles = (n + TILE - 1) / TILE;

  load_tile(sK, k + b * vk.b + h * vk.h, vk.r, k0, n, tid);
  load_tile(sV, v + b * vv.b + h * vv.h, vv.r, k0, n, tid);
  load_tile(sQ, qb, vq.r, 0, n, tid);
  load_tile(sD, db, vd.r, 0, n, tid);
  triad::cp_async_commit();
  // Rows past n: m 0, 1/l 1, di 0 with zero q and dO add nothing.
  auto stats = [&](int buf, int r0) {
    if (tid < TILE) {
      const bool ok = r0 + tid < n;
      float* st = sStat + buf * 3 * TILE;
      st[tid] = ok ? m_in[bh + r0 + tid] : 0.0f;
      st[TILE + tid] = ok ? 1.0f / l_in[bh + r0 + tid] : 1.0f;
      st[2 * TILE + tid] = ok ? di[bh + r0 + tid] : 0.0f;
    }
  };
  stats(0, 0);

  // This thread's two keys (rows g and g + 8 of its warp's 16).
  const int key0 = k0 + warp * 16 + (lane >> 2);
  const float* mb = mask + (long long)b * n;
  const float bias0 = key0 < n ? key_bias(mb, key0) : 0.0f;
  const float bias1 = key0 + 8 < n ? key_bias(mb, key0 + 8) : 0.0f;
  const int col = 2 * (lane & 3);

  uint32_t ka[4][4], va[4][4];
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    triad::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < tiles) {
      const int nb = buf ^ 1, r0 = (t + 1) * TILE;
      load_tile(sQ + nb * TILE_ELEMS, qb, vq.r, r0, n, tid);
      load_tile(sD + nb * TILE_ELEMS, db, vd.r, r0, n, tid);
      triad::cp_async_commit();
      stats(nb, r0);
    }
    if (t == 0) {
      load_a(ka, sK, warp * 16, lane);
      load_a(va, sV, warp * 16, lane);
    }
    const bf16* tq = sQ + buf * TILE_ELEMS;
    const bf16* td = sD + buf * TILE_ELEMS;
    const float* st = sStat + buf * 3 * TILE;
    float p[8][4];
    zero(p);
    mma_nt(p, ka, tq, lane);  // S^T: keys x queries
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + col + (e & 1);
        const float s = p[j][e] * sm_scale + (e < 2 ? bias0 : bias1);
        p[j][e] = expf(s - st[qc]) * st[TILE + qc];
      }
    uint32_t fa[4][4];
    to_a(fa, p);
    mma_nn(dv_acc, fa, td, lane);  // dV += P^T dO
    float ds[8][4];
    zero(ds);
    mma_nt(ds, va, td, lane);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + col + (e & 1);
        ds[j][e] = (ds[j][e] - st[2 * TILE + qc]) * p[j][e] * sm_scale;
      }
    to_a(fa, ds);
    mma_nn(dk_acc, fa, tq, lane);  // dK += dS^T Q
  }
  const int r0 = k0 + warp * 16;
  store_rows(dk + b * vdk.b + h * vdk.h, vdk.r, dk_acc, r0, n, lane, 1.0f, 1.0f);
  store_rows(dv + b * vdv.b + h * vdv.h, vdv.r, dv_acc, r0, n, lane, 1.0f, 1.0f);
}

// ---------------------------------------------------------------------------
// Backward 2: dQ, one block per (b, h, 64-query tile), walking the key
// tiles: S = Q K^T and dP = dO V^T in registers, dQ += bf16(dS) K.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ mask,
                const bf16* __restrict__ dout, const float* __restrict__ l_in,
                const float* __restrict__ m_in, const float* __restrict__ di,
                bf16* __restrict__ dq, View vq, View vk, View vv, View vd, View vdq, int H,
                int n, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sD = sQ + TILE_ELEMS;
  bf16* sK = sD + TILE_ELEMS;          // [2][TILE_ELEMS]
  bf16* sV = sK + 2 * TILE_ELEMS;      // [2][TILE_ELEMS]
  float* sBias = reinterpret_cast<float*>(sV + 2 * TILE_ELEMS);  // [2][TILE]

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kb = k + b * vk.b + h * vk.h;
  const bf16* vb = v + b * vv.b + h * vv.h;
  const float* mb = mask + (long long)b * n;
  const long long bh = ((long long)b * H + h) * n;
  const int tiles = (n + TILE - 1) / TILE;

  load_tile(sQ, q + b * vq.b + h * vq.h, vq.r, q0, n, tid);
  load_tile(sD, dout + b * vd.b + h * vd.h, vd.r, q0, n, tid);
  load_tile(sK, kb, vk.r, 0, n, tid);
  load_tile(sV, vb, vv.r, 0, n, tid);
  triad::cp_async_commit();
  // Keys past n: P = 0 (a zero k adds nothing to dQ).
  if (tid < TILE) sBias[tid] = tid < n ? key_bias(mb, tid) : -INFINITY;

  // This thread's rows g and g + 8: m, 1 / l, di (rows past n: inert).
  const int row = q0 + warp * 16 + (lane >> 2);
  const float mr0 = row < n ? m_in[bh + row] : 0.0f;
  const float mr1 = row + 8 < n ? m_in[bh + row + 8] : 0.0f;
  const float il0 = row < n ? 1.0f / l_in[bh + row] : 1.0f;
  const float il1 = row + 8 < n ? 1.0f / l_in[bh + row + 8] : 1.0f;
  const float di0 = row < n ? di[bh + row] : 0.0f;
  const float di1 = row + 8 < n ? di[bh + row + 8] : 0.0f;
  const int col = 2 * (lane & 3);

  uint32_t qa[4][4], da[4][4];
  float dq_acc[8][4];
  zero(dq_acc);

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    triad::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < tiles) {
      const int nb = buf ^ 1, c0 = (t + 1) * TILE;
      load_tile(sK + nb * TILE_ELEMS, kb, vk.r, c0, n, tid);
      load_tile(sV + nb * TILE_ELEMS, vb, vv.r, c0, n, tid);
      triad::cp_async_commit();
      if (tid < TILE) sBias[nb * TILE + tid] = c0 + tid < n ? key_bias(mb, c0 + tid) : -INFINITY;
    }
    if (t == 0) {
      load_a(qa, sQ, warp * 16, lane);
      load_a(da, sD, warp * 16, lane);
    }
    const bf16* tk = sK + buf * TILE_ELEMS;
    const float* bias = sBias + buf * TILE;
    float p[8][4];
    zero(p);
    mma_nt(p, qa, tk, lane);  // S = Q K^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = p[j][e] * sm_scale + bias[j * 8 + col + (e & 1)];
        p[j][e] = e < 2 ? expf(s - mr0) * il0 : expf(s - mr1) * il1;
      }
    float ds[8][4];
    zero(ds);
    mma_nt(ds, da, sV + buf * TILE_ELEMS, lane);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = (ds[j][e] - (e < 2 ? di0 : di1)) * p[j][e] * sm_scale;
    uint32_t fa[4][4];
    to_a(fa, ds);
    mma_nn(dq_acc, fa, tk, lane);  // dQ += dS K
  }
  store_rows(dq + b * vdq.b + h * vdq.h, vdq.r, dq_acc, q0 + warp * 16, n, lane, 1.0f, 1.0f);
}

constexpr size_t FWD_SMEM = sizeof(bf16) * 5 * TILE_ELEMS + sizeof(float) * 2 * TILE;
constexpr size_t DKV_SMEM = sizeof(bf16) * 6 * TILE_ELEMS + sizeof(float) * 6 * TILE;
constexpr size_t DQ_SMEM = sizeof(bf16) * 6 * TILE_ELEMS + sizeof(float) * 2 * TILE;

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

View view(const long long* s, int i) { return View{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

}  // namespace

// q, k, v, out: (B, H, N, 64) bf16 views, strides[12] their (batch, head,
// row) element strides (unit column stride, rows 16-byte aligned). mask:
// (B, N) fp32 key mask, 1 = attend. l, m: (B, H, N) fp32 out.
// n_soft >= n: the softmax's key count (the adapter's padded N). Returns
// a cudaError_t.
extern "C" int triad_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, void* l, void* m,
                                         const long long* strides, int b, int h, int n,
                                         int n_soft, float sm_scale, void* stream) {
  if (b <= 0 || h <= 0 || n <= 0 || n_soft < n) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_kernel, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + TILE - 1) / TILE, h, b);
  flash_fwd_kernel<<<grid, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (bf16*)out,
      (float*)l, (float*)m, view(strides, 0), view(strides, 1), view(strides, 2),
      view(strides, 3), h, n, n_soft, sm_scale);
  return (int)cudaGetLastError();
}

// The backward: di, then dK/dV, then dQ, in three grids on one stream.
// strides[24]: q, k, v, out, dout, dq, dk, dv. di: (B, H, N) fp32
// scratch. l, m: the forward's.
extern "C" int triad_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* mask, const void* out, const void* dout,
                                         const void* l, const void* m, void* di, void* dq,
                                         void* dk, void* dv, const long long* strides, int b,
                                         int h, int n, float sm_scale, void* stream) {
  if (b <= 0 || h <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const View vq = view(strides, 0), vk = view(strides, 1), vv = view(strides, 2),
             vo = view(strides, 3), vd = view(strides, 4), vdq = view(strides, 5),
             vdk = view(strides, 6), vdv = view(strides, 7);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = allow_smem(flash_dkv_kernel, DKV_SMEM);
  if (err == cudaSuccess) err = allow_smem(flash_dq_kernel, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_di_kernel<<<dim3((n + 31) / 32, h, b), 256, 0, st>>>(
      (const bf16*)out, (const bf16*)dout, (float*)di, vo, vd, h, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + TILE - 1) / TILE, h, b);
  flash_dkv_kernel<<<grid, THREADS, DKV_SMEM, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (const bf16*)dout,
      (const float*)l, (const float*)m, (const float*)di, (bf16*)dk, (bf16*)dv, vq, vk, vv, vd,
      vdk, vdv, h, n, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<<<grid, THREADS, DQ_SMEM, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (const bf16*)dout,
      (const float*)l, (const float*)m, (const float*)di, (bf16*)dq, vq, vk, vv, vd, vdq, h, n,
      sm_scale);
  return (int)cudaGetLastError();
}

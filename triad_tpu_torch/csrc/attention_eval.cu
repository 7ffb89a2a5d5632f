// Inference attention with delayed normalisation for head_dim 64, any
// number of keys: one (batch, head, 64-query tile) per block.
//
// Replaces four TPU kernels of triad_tpu/ops/pallas_attention.py:
//   fused_attention_eval (:366, pallas_call :393), packed (B, N, H*64)
//   q/k/v, and fused_attention_eval_merged (:680, pallas_call :694), one
//   (B, N, 3*H*64) qkv tensor read at column offsets 0, C, 2C, both
//   running _head_eval (:69) per head;
//   fused_attention_eval_pair (:428, pallas_call :449) and
//   fused_attention_eval_merged_pair (:490, pallas_call :497), running
//   _head_pair_eval (:90) on head pairs and _head_eval on an odd last head.
// The layouts are row strides (tiles::View), so one kernel serves all
// four: the pair variants are a mode of it (pair_heads > 0), since
// _head_pair_eval is per-head attention whose block-diagonal layout only
// serves the TPU's 128 lanes, with two numerical differences kept here
// for the heads of a pair: the row sum adds e AFTER its bf16 rounding (the
// MXU sums the rounded probabilities), and the output is o / sum, a true
// division. An odd last head keeps _head_eval's numbers.
//
// Numerics kept from _head_eval, exactly: S = q.k^T accumulated in fp32,
// then S * sm_scale + a key bias of (1 - mask) * -1e30, in that order, so
// an all-masked row reads -1e30 on every key; row max m; e = exp(S - m) in
// fp32 against the final m; the row sum of the fp32 e; e rounded to bf16
// before the e.V product (fp32 accumulation); output times 1 / sum. The
// max is per (row, head) in both modes. Keys nk .. nk_soft - 1 are the
// adapter's padding to a multiple of 128 (models/layers.py:262-283): zero
// k and v and a -1e30 bias. They count in the max and the sum (which
// matters only in a row whose keys are all masked: its e is 1 on every
// key, padded ones included) and add nothing to e.V, so they are never
// loaded: the kernel adds (nk_soft - nk) e(-1e30) to the sum. Keys past
// the last real one in its tile (and query rows past nq) are zero-filled
// on load, take a -inf bias and are never stored or summed.
//
// What bounds it on the card: bytes. At HuBERT's (8, 499, 768) the
// function reads q, k, v and writes o, 24.5 MB, 0.0073 ms at 3.35 TB/s;
// its 3 N x N x 64 products per head (S twice, e.V once) are 0.0093 ms of
// tensor-core time at the bf16 peak, and the exp per score is ~47 M
// special-function operations. In practice it is bound by the rate of its
// mma.sync tiles: on an H100 (tools/kernel_probe.py eval) the one-pass
// flash forward on the same tiles takes 0.74-0.82 of its time and is
// itself ~2x SDPA's, and whole waves of blocks explain under a tenth of
// it. The design is that of
// attention_flash.cu's forward on the tiles of attention_tiles.cuh: 4
// warps of 16 query rows, the Q fragments in registers, S, e and O in
// mma.sync m16n8k16 register fragments, the 64 x 64 K and V tiles
// XOR-swizzled and double-buffered with cp.async (the next tile's copy
// overlaps this tile's products). Nothing N-sized lives in shared memory
// (41 KB a block: Q, two K and two V tiles, their biases), so there is no
// key cap and several blocks share an SM. The exact two passes of the TPU
// kernel replace an online softmax: pass 1 walks the K tiles for the row
// max alone (no exp), pass 2 walks K and V again, recomputes S and forms
// e against the final max, so e is rounded to bf16 where _head_eval
// rounds it. That costs one more Q K^T product per tile; a one-pass
// online softmax would round e against a moving max.
#include "attention_tiles.cuh"

namespace {

using triad::bf16;
using namespace triad::tiles;

constexpr float NEG = -1e30f;  // _head_eval's masked-key bias
// 41 KB: under the 48 KB a launch may take without opting in
constexpr size_t SMEM = sizeof(bf16) * 5 * TILE_ELEMS + sizeof(float) * 2 * TILE;

// The bias of key j: (1 - mask) * -1e30 below nk (0 without a mask), -inf
// past it (excluded).
__device__ __forceinline__ float key_bias(const float* mask_b, int nk, int j) {
  if (j >= nk) return -INFINITY;
  return mask_b ? (1.0f - mask_b[j]) * NEG : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
attention_eval_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ mask,
                      bf16* __restrict__ out, View vq, View vk, View vv, View vo, int nq, int nk,
                      int nk_soft, int pair_heads, long long m_bs, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TILE_ELEMS;      // [2][TILE_ELEMS]
  bf16* sV = sK + 2 * TILE_ELEMS;  // [2][TILE_ELEMS]
  float* sBias = reinterpret_cast<float*>(sV + 2 * TILE_ELEMS);  // [2][TILE]

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kb = k + b * vk.b + h * vk.h;
  const bf16* vb = v + b * vv.b + h * vv.h;
  const float* mb = mask ? mask + b * m_bs : nullptr;
  const int tiles = (nk + TILE - 1) / TILE;
  const bool pair = h < pair_heads;

  // Steps 0 .. tiles - 1: pass 1 (K tiles); tiles .. 2 tiles - 1: pass 2
  // (K and V tiles).
  auto fetch = [&](int step, int buf) {
    const int k0 = (step < tiles ? step : step - tiles) * TILE;
    load_tile(sK + buf * TILE_ELEMS, kb, vk.r, k0, nk, tid);
    if (step >= tiles) load_tile(sV + buf * TILE_ELEMS, vb, vv.r, k0, nk, tid);
    triad::cp_async_commit();
    if (tid < TILE) sBias[buf * TILE + tid] = key_bias(mb, nk, k0 + tid);
  };
  load_tile(sQ, q + b * vq.b + h * vq.h, vq.r, q0, nq, tid);
  fetch(0, 0);

  uint32_t qa[4][4];
  float acc[8][4];
  zero(acc);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows g, g + 8

  for (int step = 0; step < 2 * tiles; ++step) {
    const int buf = step & 1;
    triad::cp_async_wait<0>();
    __syncthreads();  // this step's tiles landed; every warp is done with the last step's
    if (step + 1 < 2 * tiles) fetch(step + 1, buf ^ 1);
    if (step == 0) load_a(qa, sQ, warp * 16, lane);
    float s[8][4];
    zero(s);
    mma_nt(s, qa, sK + buf * TILE_ELEMS, lane);
    scale_bias(s, sBias + buf * TILE, sm_scale, lane);
    if (step < tiles) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
      if (step == tiles - 1) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
        }
        if (nk_soft > nk) {  // the padded keys' S is -1e30
          m0 = fmaxf(m0, NEG);
          m1 = fmaxf(m1, NEG);
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[j][e] - (e < 2 ? m0 : m1));
        s[j][e] = x;
        const float add = pair ? triad::round_bf16(x) : x;
        if (e < 2) l0 += add; else l1 += add;
      }
    uint32_t ea[4][4];  // bf16(e)
    to_a(ea, s);
    mma_nn(acc, ea, sV + buf * TILE_ELEMS, lane);
  }

  quad_sum(l0, l1);
  if (nk_soft > nk) {
    const float pad = (float)(nk_soft - nk);
    const float e0 = expf(NEG - m0), e1 = expf(NEG - m1);
    l0 += pad * (pair ? triad::round_bf16(e0) : e0);
    l1 += pad * (pair ? triad::round_bf16(e1) : e1);
  }
  // Delayed normalisation: o * (1 / sum), or o / sum on a pair's heads.
  const float rl0 = 1.0f / l0, rl1 = 1.0f / l1;
  const int r = q0 + warp * 16 + frag_row(lane, 0), col = frag_col(lane, 0);
  bf16* ob = out + b * vo.b + h * vo.h;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (r < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r * vo.r + j * 8 + col) =
          pair ? __floats2bfloat162_rn(acc[j][0] / l0, acc[j][1] / l0)
               : __floats2bfloat162_rn(acc[j][0] * rl0, acc[j][1] * rl0);
    if (r + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(r + 8) * vo.r + j * 8 + col) =
          pair ? __floats2bfloat162_rn(acc[j][2] / l1, acc[j][3] / l1)
               : __floats2bfloat162_rn(acc[j][2] * rl1, acc[j][3] * rl1);
  }
}

}  // namespace

// q, k, v: bf16 rows of H*64 (packed) or views into one merged qkv
// tensor; *_bs / *_rs are batch and row strides in elements (multiples of
// 8, base pointers 16-byte aligned; a head is 64 contiguous columns).
// mask: (B, >= nk) fp32 key mask with batch stride m_bs, 1 = attend, or
// null for none. nk_soft >= nk: keys in the softmax, those past nk with
// zero k, v and a -1e30 bias. pair_heads: heads 0 .. pair_heads - 1 take
// the head-pair numerics (0: none). Any nq, nk >= 1. Returns a cudaError_t.
extern "C" int triad_attention_eval(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int b, int h,
                                    int nq, int nk, int nk_soft, int pair_heads,
                                    long long q_bs, long long q_rs,
                                    long long k_bs, long long k_rs, long long v_bs,
                                    long long v_rs, long long o_bs, long long o_rs,
                                    long long m_bs, float sm_scale, void* stream) {
  if (b <= 0 || h <= 0 || nq <= 0 || nk <= 0 || nk_soft < nk) return (int)cudaErrorInvalidValue;
  dim3 grid((nq + TILE - 1) / TILE, h, b);
  attention_eval_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask, (bf16*)out,
      View{q_bs, D, q_rs}, View{k_bs, D, k_rs}, View{v_bs, D, v_rs}, View{o_bs, D, o_rs}, nq, nk,
      nk_soft, pair_heads, m_bs, sm_scale);
  return (int)cudaGetLastError();
}

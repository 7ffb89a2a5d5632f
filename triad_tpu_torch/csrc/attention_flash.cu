// Flash attention for head_dim 64, forward and backward, any N: the
// "flash" attention route, as Hopper kernels (TMA-fed wgmma tiles).
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
// exp(S - m) rounded to bf16 before P.V with fp32 accumulation, O = acc *
// (1 / l) at the end; m and l are written per row. The library walks
// 512-key blocks and rescales a normalised accumulator (within one block
// it divides P before the rounding); this kernel walks 64-key tiles, so
// its bf16 roundings of P differ from it by an ulp here and there
// (ops/flash_attention.py:flash_fwd_tiled_plain is this kernel's order).
// Backward: di = rowsum(O * dO) in fp32 from the bf16 O; P = exp(S - m) *
// (1 / l); dV = bf16(P)^T dO; dS = (dO V^T - di) * P * sm_scale; dK =
// bf16(dS)^T Q; dQ = bf16(dS) K, each product with fp32 accumulation. The
// exponentials are exp2 of scores scaled by log2 e (to_natural below).
//
// What bounds it on the card: the ViT's (64, 12, 261, 64) moves more bytes
// than its products take (forward 0.031 ms of bytes at 3.35 TB/s); at N =
// 1000 the products bound it (0.025 ms of the bf16 peak). With 64-wide
// heads every score costs one exponential per 128 multiply-adds, so the
// SM's 16 exponentials a clock match its tensor cores' rate. Measured
// (PERF.md §6): the kernels are held back by the latency of each
// warpgroup's serial chain (products, wait, softmax, products), not by
// their copies. The design, Hopper's (hopper.cuh's helpers):
//   - persistent blocks, one per SM, each walking items (b, h, 128-row
//     tile) strided by the grid, so a head's tiles run on neighbouring
//     SMs at once and share its K/V (or Q/dO) in L2;
//   - block = 2 consumer warpgroups (64 rows of the item each) + 1
//     producer warpgroup, one warp of which keeps a ring of 4 stages of
//     64-row tiles (K and V for the forward and dQ, Q and dO for dK/dV)
//     in flight on full / empty mbarriers. The launch gives each of the
//     384 threads 168 registers (65536 / 384); the producer warpgroup
//     gives most of its own back (setmaxnreg.dec to 40) and the consumers
//     take them (setmaxnreg.inc to 232). A block of 9 warps (one producer
//     warp) would hold every thread to 168 with nothing to give: one SM
//     sub-partition then holds 3 of its warps, 16384 / 96 = 170, rounded
//     down to 168;
//   - every copy is a rank-4 cp.async.bulk.tensor over (64, N, H, B) with
//     the view's row, head and batch strides (the wrapper's plan), so
//     strided (B, H, N, 64) views of (B, N, H, 64) or fused-qkv memory
//     load as they lie; rows past N come in as TMA's zero fill (a ragged
//     tile needs no masking of its loads), 128-byte swizzled;
//   - every product is wgmma.mma_async m64n64k16 bf16 -> fp32. The
//     resident operands of an item (the forward's Q, dK/dV's K and V,
//     dQ's Q and dO) are read once per item into register A fragments
//     with ldmatrix (the tiles then take the next item's copy). P, P^T,
//     dS and dS^T go from the fp32 accumulator, packed pairwise to bf16,
//     straight into the next product's A fragment; no score tile touches
//     shared memory. B is the streamed
//     tile, K-major for S = Q K^T, S^T = K Q^T, dP = dO V^T and dP^T = V
//     dO^T, MN-major (the transposed B) for P.V, P^T dO, dS^T Q and dS K;
//   - the forward issues tile t's S with tile t - 1's P.V, so that product
//     runs during tile t's softmax, and its two warpgroups take turns
//     issuing products (my_turn), so one's softmax runs during the other's
//     wgmma (5% faster than without the turns, PERF.md). The backward
//     kernels issue tile t's S and dP right behind tile t - 1's gradient
//     products and wait once for all of them. No branch on the data sits
//     between a product and the next (a shortcut for tiles with no masked
//     key gave wrong gradients in the backward kernels, PERF.md), and no
//     register a wgmma reads is written while another is in flight:
//     either makes ptxas serialise every wgmma of the kernel (its notes
//     C7520 and C7513, which chip_smoke.py's build phase prints);
//   - the producer warp also writes each key tile's bias (0, MASK_VALUE,
//     or -inf past N) or each query tile's stats (m, 1 / l, di) beside
//     the tile, before its arrival on the stage's full barrier.
// The backward is three kernels with no atomics, as the library splits it
// (seven products: di first, then dK/dV walking the query tiles for one
// key tile, then dQ walking the key tiles for one query tile; each
// recomputes S and P), so it repeats bit for bit.
#include "hopper.cuh"

namespace {

using triad::bf16;
using namespace triad::hopper;

constexpr int D = 64;                       // head dim: one 128-byte swizzle row
constexpr int TILE = 64;                    // rows of a tile and of a warpgroup's slice
constexpr int CONSUMERS = 2;                // warpgroups of 64 rows
constexpr int ROWS = TILE * CONSUMERS;      // rows of an item
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
// Registers a thread after setmaxnreg: 40 x 128 + 232 x 256 = the 168 x
// 384 of the block's launch (grid_of checks the kernel's count).
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGES = 4;
constexpr int TILE_BYTES = TILE * D * 2;    // 8 KB
constexpr int PLAN = 8;                     // longs of one operand's tensor-map plan
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The library's DEFAULT_MASK_VALUE: -0.7 * finfo(f32).max, formed in
// double and rounded once to fp32, as Python and JAX do.
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e38);

// Shared memory: the item's resident tiles (CONSUMERS x TILE rows of one
// or two operands), the ring (STAGES x two tiles), the ring's per-tile
// floats (bias or stats), then the barriers; 1 KB to align the base.
constexpr int RING_FLOATS = 3 * TILE;  // a key tile's bias, or a query tile's m, 1 / l, di
constexpr size_t smem_bytes(int resident) {
  return (size_t)resident * CONSUMERS * TILE_BYTES + (size_t)STAGES * 2 * TILE_BYTES +
         (size_t)STAGES * RING_FLOATS * 4 + (2 + 2 * STAGES) * 8 + 1024;
}

struct Smem {
  bf16* res;            // [resident][CONSUMERS][TILE][D]
  unsigned char* ring;  // [STAGES][2][TILE][D] bf16
  float* extra;         // [STAGES][RING_FLOATS]
  uint64_t *res_full, *res_empty, *full, *empty;
};

__device__ __forceinline__ Smem carve(unsigned char* raw, int resident) {
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  Smem s;
  s.res = reinterpret_cast<bf16*>(base);
  s.ring = base + resident * CONSUMERS * TILE_BYTES;
  s.extra = reinterpret_cast<float*>(s.ring + STAGES * 2 * TILE_BYTES);
  s.res_full = reinterpret_cast<uint64_t*>(s.extra + STAGES * RING_FLOATS);
  s.res_empty = s.res_full + 1;
  s.full = s.res_empty + 1;
  s.empty = s.full + STAGES;
  return s;
}

// Barriers: the resident tiles' full takes the producer's one arrival and
// the resident bytes, their empty one arrival per consumer warp once the
// warp has read them; a stage's full the producer warp's 32 arrivals
// (lane 0's with the bytes) after its floats are written, its empty one
// arrival per consumer warpgroup once the products that read it retired.
__device__ __forceinline__ void init_barriers(const Smem& s) {
  if (threadIdx.x == 0) {
    mbar_init(s.res_full, 1);
    mbar_init(s.res_empty, CONSUMERS * 4);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 32);
      mbar_init(&s.empty[i], CONSUMERS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
}

// Item i of a grid over (b, h, 128-row tile): tile fastest, so the tiles
// of one head run on neighbouring blocks.
struct Item {
  int b, h, r0;
};
__device__ __forceinline__ Item item_of(int i, int tiles, int H) {
  const int bh = i / tiles;
  return Item{bh / H, bh % H, (i % tiles) * ROWS};
}

__device__ __forceinline__ void advance(int& stage, int& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// A fragments (a warp's 16 rows from row0, 64 columns = 4 k16 steps) of a
// 64 x 64 tile written by TMA with the 128-byte swizzle (1024-byte
// aligned: row r's 16-byte chunk c sits at chunk c ^ (r & 7)).
__device__ __forceinline__ void load_frags(uint32_t (&a)[4][4], const bf16* tile, int row0,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r = row0 + (lane & 15), c = kk * 2 + (lane >> 4);
    const uint32_t addr = smem_u32(tile + r * D + ((c ^ (r & 7)) << 3));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                 : "r"(addr));
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a 64 x 64 fp32 accumulator, rounded to bf16: element
// 4 j + e of a thread is row lane / 4 (+ 8 for e >= 2) of its warp's 16,
// column 8 j + 2 (lane % 4) + e % 2, which is where the next product's A
// fragment wants it.
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4], const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = pack(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

__device__ __forceinline__ void zero(float (&c)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] = 0.0f;
}

// acc (+)= A . B for the 64 x 64 tile B (K-major: S-like products).
__device__ __forceinline__ void mma_k(float (&acc)[32], const uint32_t (&a)[4][4], const bf16* b,
                                      bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_rs<0>(acc, a[kk], desc_sw128(b + kk * 16), accumulate || kk > 0);
}

// acc += A . B for the 64 x 64 tile B read MN-major (P.V-like products).
__device__ __forceinline__ void mma_mn(float (&acc)[32], const uint32_t (&a)[4][4],
                                       const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_rs<1>(acc, a[kk], desc_sw128_mn(b + kk * 16 * D), 1);
}

// Store a warpgroup's 64 x 64 fp32 accumulator as bf16: thread rows r and
// r + 8 (rows at or past n skipped), each times its scale.
__device__ __forceinline__ void store_rows(bf16* g, long long rs, const float (&c)[32], int r,
                                           int n, int lane, float s0, float s1) {
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (r < n)
      *reinterpret_cast<__nv_bfloat162*>(g + (long long)r * rs + j * 8 + col) =
          __floats2bfloat162_rn(c[4 * j] * s0, c[4 * j + 1] * s0);
    if (r + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(g + (long long)(r + 8) * rs + j * 8 + col) =
          __floats2bfloat162_rn(c[4 * j + 2] * s1, c[4 * j + 3] * s1);
  }
}

__device__ __forceinline__ float key_bias(const float* mask, int j) {
  return mask[j] != 0.0f ? 0.0f : MASK_VALUE;
}

// 2^x in one MUFU.EX2 (denormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The kernels take exponentials in base 2: a score is x2 = S c + bias, c =
// sm_scale log2 e, with the bias (0, MASK_VALUE, -inf) added unscaled, so a
// masked score stays MASK_VALUE exactly (|S c| is far under its ulp) and a
// row whose keys are all masked has max MASK_VALUE and exp2(x2 - m2) = 1
// for every key, as exp(s - m) is for the library. m2 is the row max in
// these units; the natural m is m2 ln 2, and MASK_VALUE for such a row.
__device__ __forceinline__ float to_natural(float m2) {
  return m2 == MASK_VALUE ? MASK_VALUE : m2 * LN2;
}
__device__ __forceinline__ float to_log2(float m) {
  return m == MASK_VALUE ? MASK_VALUE : m * LOG2E;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// (batch, head, row) element strides of a view the kernels write.
struct View {
  long long b, h, r;
};

struct Args {
  const float* mask;                     // (B, N) fp32, 1 = attend
  const float *l, *m, *di;               // (B, H, N) fp32 row stats
  float *l_out, *m_out;                  // the forward's
  bf16 *o0, *o1;                         // outputs: O; dK and dV; dQ
  View v0, v1;
  int H, n, n_soft, tiles, items;        // tiles: 128-row tiles per head
  float sm_scale;
};

// The producer's loop, shared by the three kernels: per item, the
// resident operands' CONSUMERS boxes each (res0, and res1 if given) on
// res_full, then every 64-row tile of the streamed operands (ring0,
// ring1) with the stage's floats for rows (or keys) r0 .. r0 + 63 of (b,
// h): fetch loads a lane's V raw values of a tile into registers, put
// writes the floats from them. The next tile's fetch is issued before the
// wait for its stage, so its loads are in flight while the ring is full.
template <int V, class Fetch, class Put>
__device__ __forceinline__ void produce(const Smem& s, const CUtensorMap* res0,
                                        const CUtensorMap* res1, const CUtensorMap* ring0,
                                        const CUtensorMap* ring1, const Args& a, int lane,
                                        Fetch fetch, Put put) {
  const int nres = res1 ? 2 : 1, ntiles = (a.n + TILE - 1) / TILE;
  int stage = 0, phase = 0;
  for (int i = blockIdx.x, li = 0; i < a.items; i += gridDim.x, ++li) {
    const Item it = item_of(i, a.tiles, a.H);
    float cur[V];
    fetch(cur, it, 0, lane);
    if (lane == 0) {
      mbar_wait(s.res_empty, (li & 1) ^ 1);
      mbar_expect_tx(s.res_full, nres * CONSUMERS * TILE_BYTES);
      for (int w = 0; w < CONSUMERS; ++w) {
        tma_load_4d(s.res + w * TILE * D, res0, s.res_full, 0, it.r0 + w * TILE, it.h, it.b);
        if (res1)
          tma_load_4d(s.res + (CONSUMERS + w) * TILE * D, res1, s.res_full, 0, it.r0 + w * TILE,
                      it.h, it.b);
      }
    }
    for (int t = 0; t < ntiles; ++t) {
      float nxt[V];
#pragma unroll
      for (int v = 0; v < V; ++v) nxt[v] = 0.0f;
      if (t + 1 < ntiles) fetch(nxt, it, (t + 1) * TILE, lane);
      mbar_wait(&s.empty[stage], phase ^ 1);
      put(s.extra + stage * RING_FLOATS, cur, t * TILE, lane);
      if (lane == 0) {
        unsigned char* dst = s.ring + stage * 2 * TILE_BYTES;
        mbar_expect_tx(&s.full[stage], 2 * TILE_BYTES);
        tma_load_4d(dst, ring0, &s.full[stage], 0, t * TILE, it.h, it.b);
        tma_load_4d(dst + TILE_BYTES, ring1, &s.full[stage], 0, t * TILE, it.h, it.b);
      } else {
        mbar_arrive(&s.full[stage]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) cur[v] = nxt[v];
      advance(stage, phase);
    }
  }
}

// The key tiles' floats (forward, dQ): a lane fetches the mask of keys k0
// + lane and k0 + lane + 32 and puts their bias: 0, MASK_VALUE on a
// masked key, -inf past n.
__device__ __forceinline__ void fetch_mask(float (&v)[2], const Args& a, const Item& it, int k0,
                                           int lane) {
  const float* mb = a.mask + (long long)it.b * a.n;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int k = k0 + lane + 32 * e;
    v[e] = k < a.n ? mb[k] : 0.0f;
  }
}
__device__ __forceinline__ void put_bias(float* bias, const float (&v)[2], const Args& a, int k0,
                                         int lane) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = lane + 32 * e;
    bias[c] = k0 + c < a.n ? (v[e] != 0.0f ? 0.0f : MASK_VALUE) : -INFINITY;
  }
}

// The two consumer warpgroups take turns issuing their products (named
// barriers 1 and 2, one per warpgroup, FlashAttention-3's ping-pong), so
// one's softmax runs while the other's wgmma does. Warpgroup 1 gives the
// first turn (turns_begin) and warpgroup 0 takes back the last one
// (turns_end); between them every tile of every item is one turn each.
__device__ __forceinline__ void my_turn(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void your_turn(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg ^ 1)) : "memory");
}
__device__ __forceinline__ void turns_begin(int wg) {
  if (wg == 1) your_turn(wg);
}
__device__ __forceinline__ void turns_end(int wg) {
  if (wg == 0) my_turn(wg);
}

// A consumer warpgroup whose 64 rows all lie past n: it takes the item's
// barriers (and turns, where the kernel takes them) and computes nothing.
__device__ __forceinline__ void skip_item(const Smem& s, int ntiles, int wg, int t, int& stage,
                                          int& phase, bool turns) {
  for (int i = 0; i < ntiles; ++i) {
    mbar_wait(&s.full[stage], phase);
    if (turns) {
      my_turn(wg);
      your_turn(wg);
    }
    if (t == 0) mbar_arrive(&s.empty[stage]);
    advance(stage, phase);
  }
}

// The resident rows' A fragments of the li-th item (the block's li-th
// since launch): once their copy has landed, the warp's 16 rows of each
// resident operand, read once; the warp's reads (ldmatrix, generic proxy)
// are then ordered before the next item's copy into the same tiles.
__device__ __forceinline__ void take_resident(const Smem& s, int li, int wg, int warp, int lane,
                                              bool live, uint32_t (&a0)[4][4],
                                              uint32_t (&a1)[4][4], bool two) {
  mbar_wait(s.res_full, li & 1);
  if (live) {
    load_frags(a0, s.res + wg * TILE * D, warp * 16, lane);
    if (two) load_frags(a1, s.res + (CONSUMERS + wg) * TILE * D, warp * 16, lane);
  }
  fence_proxy_async();
  if (lane == 0) mbar_arrive(s.res_empty);
}

// ---------------------------------------------------------------------------
// Forward: an item is 128 query rows; the ring streams K and V tiles with
// each key tile's bias.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw, 1);
  init_barriers(s);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
  const int ntiles = (a.n + TILE - 1) / TILE;

  if (wg == CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0)
      produce<2>(
          s, &map_q, nullptr, &map_k, &map_v, a, lane,
          [&](float (&v)[2], const Item& it, int k0, int l) { fetch_mask(v, a, it, k0, l); },
          [&](float* bias, const float (&v)[2], int k0, int l) { put_bias(bias, v, a, k0, l); });
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int col = 2 * (lane & 3);
    int stage = 0, phase = 0;
    turns_begin(wg);
    for (int i = blockIdx.x, li = 0; i < a.items; i += gridDim.x, ++li) {
      const Item it = item_of(i, a.tiles, a.H);
      const int r0 = it.r0 + wg * TILE;
      const bool live = r0 < a.n;
      uint32_t qa[4][4];
      take_resident(s, li, wg, warp, lane, live, qa, qa, false);
      if (!live) {
        skip_item(s, ntiles, wg, t, stage, phase, true);
        continue;
      }
      // m0, m1 in log2 units (to_natural); rows g and g + 8 of the warp's 16.
      const float c = a.sm_scale * LOG2E;
      float o[32];
      zero(o);
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
      // One tile's scores sc (S, fp32) in place: x2 = S c + bias, the new
      // row max, sc = exp2(x2 - max) (un-normalised P), l rescaled by a0, a1
      // = exp2(old max - new max) plus the tile's sum.
      auto softmax = [&](float (&sc)[32], const float* bias, float& a0, float& a1) {
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + col);
          sc[4 * j] = fmaf(sc[4 * j], c, bb.x);
          sc[4 * j + 1] = fmaf(sc[4 * j + 1], c, bb.y);
          sc[4 * j + 2] = fmaf(sc[4 * j + 2], c, bb.x);
          sc[4 * j + 3] = fmaf(sc[4 * j + 3], c, bb.y);
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[4 * j] = ex2(sc[4 * j] - mx0);
          sc[4 * j + 1] = ex2(sc[4 * j + 1] - mx0);
          sc[4 * j + 2] = ex2(sc[4 * j + 2] - mx1);
          sc[4 * j + 3] = ex2(sc[4 * j + 3] - mx1);
        }
        a0 = ex2(m0 - mx0);
        a1 = ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sum0 += sc[4 * j] + sc[4 * j + 1];
          sum1 += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l0 = l0 * a0 + sum0;
        l1 = l1 * a1 + sum1;
      };
      // Tile t's S = Q K^T is issued with tile t - 1's O += bf16(P) V, so
      // the product runs while this warpgroup takes tile t's softmax. Tile
      // 0's S goes alone, before the loop: a product issued under a branch
      // made ptxas serialise every wgmma of the kernel.
      uint32_t pa[4][4];
      float a0, a1;
      mbar_wait(&s.full[stage], phase);
      const bf16* sk0 = reinterpret_cast<const bf16*>(s.ring + stage * 2 * TILE_BYTES);
      {
        float sc[32];
        my_turn(wg);
        wgmma_fence();
        mma_k(sc, qa, sk0, false);
        wgmma_commit();
        your_turn(wg);
        wgmma_wait<0>();
        fence_regs(sc);
        softmax(sc, s.extra + stage * RING_FLOATS, a0, a1);  // o is 0: no rescale
        to_frags(pa, sc);
      }
      const bf16* sv_prev = sk0 + TILE * D;
      int prev = stage;
      advance(stage, phase);
      for (int kt = 1; kt < ntiles; ++kt) {
        mbar_wait(&s.full[stage], phase);
        const bf16* sk = reinterpret_cast<const bf16*>(s.ring + stage * 2 * TILE_BYTES);
        float sc[32];
        fence_regs(o);
        fence_regs(pa);
        my_turn(wg);
        wgmma_fence();
        mma_k(sc, qa, sk, false);
        wgmma_commit();
        mma_mn(o, pa, sv_prev);
        wgmma_commit();
        your_turn(wg);
        wgmma_wait<1>();
        fence_regs(sc);
        softmax(sc, s.extra + stage * RING_FLOATS, a0, a1);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        if (t == 0) mbar_arrive(&s.empty[prev]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
        // P's A fragment is packed only once tile t - 1's P.V retired: a
        // register a wgmma reads, written while an earlier one is in
        // flight, made ptxas serialise them.
        to_frags(pa, sc);
        sv_prev = sk + TILE * D;
        prev = stage;
        advance(stage, phase);
      }
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      mma_mn(o, pa, sv_prev);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (t == 0) mbar_arrive(&s.empty[prev]);
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      // The adapter's padded keys: zero k and v at the mask value.
      const float pad = (float)(a.n_soft - a.n);
      l0 += pad * ex2(MASK_VALUE - m0);
      l1 += pad * ex2(MASK_VALUE - m1);
      const int r = r0 + warp * 16 + (lane >> 2);
      store_rows(a.o0 + it.b * a.v0.b + it.h * a.v0.h, a.v0.r, o, r, a.n, lane, 1.0f / l0,
                 1.0f / l1);
      if ((lane & 3) == 0) {
        const long long row = ((long long)it.b * a.H + it.h) * a.n;
        if (r < a.n) {
          a.l_out[row + r] = l0;
          a.m_out[row + r] = to_natural(m0);
        }
        if (r + 8 < a.n) {
          a.l_out[row + r + 8] = l1;
          a.m_out[row + r + 8] = to_natural(m1);
        }
      }
    }
    turns_end(wg);
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
// Backward 1: dK and dV. An item is 128 keys, K and V resident; the ring
// streams Q and dO tiles with each query tile's m, 1 / l and di (rows past
// n: m 0, 1 / l 1, di 0, which with zero q and dO add nothing). A
// warpgroup's 64 keys: S^T = K Q^T and dP^T = V dO^T, P^T = exp(S^T - m)
// / l, dV += bf16(P^T) dO, dS^T = (dP^T - di) P^T sm_scale, dK +=
// bf16(dS^T) Q.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_d, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw, 2);
  init_barriers(s);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
  const int ntiles = (a.n + TILE - 1) / TILE;

  if (wg == CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0)
      produce<6>(
          s, &map_k, &map_v, &map_q, &map_d, a, lane,
          [&](float (&v)[6], const Item& it, int q0, int l) {
            const long long bh = ((long long)it.b * a.H + it.h) * a.n;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = q0 + l + 32 * e;
              const bool ok = r < a.n;
              v[3 * e] = ok ? a.m[bh + r] : 0.0f;
              v[3 * e + 1] = ok ? a.l[bh + r] : 1.0f;
              v[3 * e + 2] = ok ? a.di[bh + r] : 0.0f;
            }
          },
          [&](float* st, const float (&v)[6], int, int l) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = l + 32 * e;
              st[c] = -to_log2(v[3 * e]);
              st[TILE + c] = 1.0f / v[3 * e + 1];
              st[2 * TILE + c] = v[3 * e + 2];
            }
          });
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int col = 2 * (lane & 3);
    int stage = 0, phase = 0;
    for (int i = blockIdx.x, li = 0; i < a.items; i += gridDim.x, ++li) {
      const Item it = item_of(i, a.tiles, a.H);
      const int k0 = it.r0 + wg * TILE;
      const bool live = k0 < a.n;
      uint32_t ka[4][4], va[4][4];
      take_resident(s, li, wg, warp, lane, live, ka, va, true);
      if (!live) {
        skip_item(s, ntiles, wg, t, stage, phase, false);
        continue;
      }
      // This thread's two keys (rows g and g + 8 of its warp's 16); keys past
      // n at -inf (P = 0; their rows are not stored).
      const int key = k0 + warp * 16 + (lane >> 2);
      const float* mb = a.mask + (long long)it.b * a.n;
      const float bias0 = key < a.n ? key_bias(mb, key) : -INFINITY;
      const float bias1 = key + 8 < a.n ? key_bias(mb, key + 8) : -INFINITY;
      const float c = a.sm_scale * LOG2E;
      float dk[32], dv[32];
      zero(dk);
      zero(dv);
      // Tile t's S^T and dP^T are issued behind tile t - 1's dV and dK
      // products, with no wait between them.
      uint32_t pa[4][4], da[4][4];
      int prev = -1;
      for (int qt = 0; qt < ntiles; ++qt) {
        mbar_wait(&s.full[stage], phase);
        const bf16* sq = reinterpret_cast<const bf16*>(s.ring + stage * 2 * TILE_BYTES);
        const bf16* sd = sq + TILE * D;
        const float* st = s.extra + stage * RING_FLOATS;
        float p[32], ds[32];
        wgmma_fence();
        mma_k(p, ka, sq, false);   // S^T = K Q^T: keys x queries
        mma_k(ds, va, sd, false);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(p);
        fence_regs(ds);
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
        if (prev >= 0 && t == 0) mbar_arrive(&s.empty[prev]);
        // P^T = exp2(S^T c + bias - m2) / l; the stats hold -m2 (log2 units).
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 nm = *reinterpret_cast<const float2*>(st + 8 * j + col);
          const float2 il = *reinterpret_cast<const float2*>(st + TILE + 8 * j + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = fmaf(p[4 * j + e], c, e < 2 ? bias0 : bias1) + ((e & 1) ? nm.y : nm.x);
            p[4 * j + e] = ex2(x) * ((e & 1) ? il.y : il.x);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dq = *reinterpret_cast<const float2*>(st + 2 * TILE + 8 * j + col);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[4 * j + e] = (ds[4 * j + e] - ((e & 1) ? dq.y : dq.x)) * p[4 * j + e] * a.sm_scale;
        }
        to_frags(pa, p);
        to_frags(da, ds);
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
        wgmma_fence();
        mma_mn(dv, pa, sd);  // dV += bf16(P^T) dO
        mma_mn(dk, da, sq);  // dK += bf16(dS^T) Q
        wgmma_commit();
        prev = stage;
        advance(stage, phase);
      }
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (t == 0) mbar_arrive(&s.empty[prev]);
      store_rows(a.o0 + it.b * a.v0.b + it.h * a.v0.h, a.v0.r, dk, key, a.n, lane, 1.0f, 1.0f);
      store_rows(a.o1 + it.b * a.v1.b + it.h * a.v1.h, a.v1.r, dv, key, a.n, lane, 1.0f, 1.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 2: dQ. An item is 128 queries, Q and dO resident; the ring
// streams K and V tiles with each key tile's bias (keys past n: -inf, so P
// = 0). A warpgroup's 64 queries: S = Q K^T and dP = dO V^T, P = exp(S -
// m) / l, dS = (dP - di) P sm_scale, dQ += bf16(dS) K.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_d, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw, 2);
  init_barriers(s);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
  const int ntiles = (a.n + TILE - 1) / TILE;

  if (wg == CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0)
      produce<2>(
          s, &map_q, &map_d, &map_k, &map_v, a, lane,
          [&](float (&v)[2], const Item& it, int k0, int l) { fetch_mask(v, a, it, k0, l); },
          [&](float* bias, const float (&v)[2], int k0, int l) { put_bias(bias, v, a, k0, l); });
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int col = 2 * (lane & 3);
    int stage = 0, phase = 0;
    for (int i = blockIdx.x, li = 0; i < a.items; i += gridDim.x, ++li) {
      const Item it = item_of(i, a.tiles, a.H);
      const int q0 = it.r0 + wg * TILE;
      const bool live = q0 < a.n;
      uint32_t qa[4][4], da[4][4];
      take_resident(s, li, wg, warp, lane, live, qa, da, true);
      if (!live) {
        skip_item(s, ntiles, wg, t, stage, phase, false);
        continue;
      }
      // This thread's rows g and g + 8: m (log2 units), 1 / l, di (rows past
      // n: inert).
      const int row = q0 + warp * 16 + (lane >> 2);
      const long long bh = ((long long)it.b * a.H + it.h) * a.n;
      const float mr0 = row < a.n ? to_log2(a.m[bh + row]) : 0.0f;
      const float mr1 = row + 8 < a.n ? to_log2(a.m[bh + row + 8]) : 0.0f;
      const float il0 = row < a.n ? 1.0f / a.l[bh + row] : 1.0f;
      const float il1 = row + 8 < a.n ? 1.0f / a.l[bh + row + 8] : 1.0f;
      const float di0 = row < a.n ? a.di[bh + row] : 0.0f;
      const float di1 = row + 8 < a.n ? a.di[bh + row + 8] : 0.0f;
      const float c = a.sm_scale * LOG2E;
      float dq[32];
      zero(dq);
      // Tile t's S and dP are issued behind tile t - 1's dQ product, with
      // no wait between them.
      uint32_t dsa[4][4];
      int prev = -1;
      for (int kt = 0; kt < ntiles; ++kt) {
        mbar_wait(&s.full[stage], phase);
        const bf16* sk = reinterpret_cast<const bf16*>(s.ring + stage * 2 * TILE_BYTES);
        const bf16* sv = sk + TILE * D;
        const float* bias = s.extra + stage * RING_FLOATS;
        float p[32], ds[32];
        wgmma_fence();
        mma_k(p, qa, sk, false);   // S = Q K^T
        mma_k(ds, da, sv, false);  // dP = dO V^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(p);
        fence_regs(ds);
        fence_regs(dq);
        fence_regs(dsa);
        if (prev >= 0 && t == 0) mbar_arrive(&s.empty[prev]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = fmaf(p[4 * j + e], c, (e & 1) ? bb.y : bb.x);
            const float pe = e < 2 ? ex2(x - mr0) * il0 : ex2(x - mr1) * il1;
            ds[4 * j + e] = (ds[4 * j + e] - (e < 2 ? di0 : di1)) * pe * a.sm_scale;
          }
        }
        to_frags(dsa, ds);
        fence_regs(dq);
        fence_regs(dsa);
        wgmma_fence();
        mma_mn(dq, dsa, sk);  // dQ += bf16(dS) K
        wgmma_commit();
        prev = stage;
        advance(stage, phase);
      }
      wgmma_wait<0>();
      fence_regs(dq);
      if (t == 0) mbar_arrive(&s.empty[prev]);
      store_rows(a.o0 + it.b * a.v0.b + it.h * a.v0.h, a.v0.r, dq, row, a.n, lane, 1.0f, 1.0f);
    }
  }
}

// ------------------------------------------------------------------ host

View view(const long long* s, int i) { return View{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

// The tensor map of one operand from its plan (ops/flash_attention.py:
// tma_plan): dims (64, N, H, B), the byte strides of dims 1 .. 3, the box's
// rows, which must be the kernels' tile.
bool encode_operand(CUtensorMap* map, const void* base, const long long* plan, int b, int h,
                    int n) {
  if (plan[0] != D || plan[1] != n || plan[2] != h || plan[3] != b || plan[7] != TILE)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)plan[0], (cuuint64_t)plan[1], (cuuint64_t)plan[2],
                              (cuuint64_t)plan[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)plan[4], (cuuint64_t)plan[5], (cuuint64_t)plan[6]};
  const cuuint32_t box[4] = {D, TILE, 1, 1};
  return encode(map, base, 4, dims, strides, box);
}

// The persistent grid of a kernel: one block per SM, at most one per item;
// sets the kernel's dynamic shared memory once per device and process, and
// refuses a build whose launch leaves the block fewer registers than its
// warpgroups ask for after setmaxnreg (setmaxnreg.inc would wait for them
// for ever).
template <typename K>
cudaError_t grid_of(K kernel, size_t smem, bool (&done)[MAX_DEVICES], int dev, int items,
                    int* grid) {
  const int sms = sm_count(dev);
  if (sms <= 0) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * THREADS < 128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS))
      return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  *grid = items < sms ? items : sms;
  return cudaSuccess;
}

bool fwd_smem_set[MAX_DEVICES], dkv_smem_set[MAX_DEVICES], dq_smem_set[MAX_DEVICES];

}  // namespace

// q, k, v: (B, H, N, 64) bf16 views, loaded by TMA as plan[24] describes
// them (8 longs each: dims (64, N, H, B), byte strides of rows, heads and
// batches, box rows 64; 16-byte aligned bases). out: (B, H, N, 64) bf16,
// written through its (batch, head, row) element strides strides[3] (unit
// column stride, rows 16-byte aligned). mask: (B, N) fp32 key mask, 1 =
// attend. l, m: (B, H, N) fp32 out. n_soft >= n: the softmax's key count
// (the adapter's padded N). Returns a cudaError_t.
extern "C" int triad_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, void* l, void* m,
                                         const long long* strides, const long long* plan, int b,
                                         int h, int n, int n_soft, float sm_scale, void* stream) {
  if (b <= 0 || h <= 0 || n <= 0 || n_soft < n) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = bind_device(&dev);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv;
  if (!encode_operand(&mq, q, plan, b, h, n) || !encode_operand(&mk, k, plan + PLAN, b, h, n) ||
      !encode_operand(&mv, v, plan + 2 * PLAN, b, h, n))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.mask = (const float*)mask;
  a.l_out = (float*)l;
  a.m_out = (float*)m;
  a.o0 = (bf16*)out;
  a.v0 = view(strides, 0);
  a.H = h;
  a.n = n;
  a.n_soft = n_soft;
  a.tiles = (n + ROWS - 1) / ROWS;
  a.items = b * h * a.tiles;
  a.sm_scale = sm_scale;
  const size_t smem = smem_bytes(1);
  int grid = 0;
  err = grid_of(flash_fwd_kernel, smem, fwd_smem_set, dev, a.items, &grid);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

// The backward: di, then dK/dV, then dQ, in three grids on one stream.
// plan[32]: q, k, v, dout as the forward's. strides[15]: the element
// strides of out, dout, dq, dk, dv. di: (B, H, N) fp32 scratch. l, m: the
// forward's.
extern "C" int triad_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* mask, const void* out, const void* dout,
                                         const void* l, const void* m, void* di, void* dq,
                                         void* dk, void* dv, const long long* strides,
                                         const long long* plan, int b, int h, int n,
                                         float sm_scale, void* stream) {
  if (b <= 0 || h <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = bind_device(&dev);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv, md;
  if (!encode_operand(&mq, q, plan, b, h, n) || !encode_operand(&mk, k, plan + PLAN, b, h, n) ||
      !encode_operand(&mv, v, plan + 2 * PLAN, b, h, n) ||
      !encode_operand(&md, dout, plan + 3 * PLAN, b, h, n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Args a{};
  a.mask = (const float*)mask;
  a.l = (const float*)l;
  a.m = (const float*)m;
  a.di = (const float*)di;
  a.H = h;
  a.n = n;
  a.n_soft = n;
  a.tiles = (n + ROWS - 1) / ROWS;
  a.items = b * h * a.tiles;
  a.sm_scale = sm_scale;
  const size_t smem_bwd = smem_bytes(2);
  int grid_dkv = 0, grid_dq = 0;
  err = grid_of(flash_dkv_kernel, smem_bwd, dkv_smem_set, dev, a.items, &grid_dkv);
  if (err == cudaSuccess)
    err = grid_of(flash_dq_kernel, smem_bwd, dq_smem_set, dev, a.items, &grid_dq);
  if (err != cudaSuccess) return (int)err;
  flash_di_kernel<<<dim3((n + 31) / 32, h, b), 256, 0, st>>>(
      (const bf16*)out, (const bf16*)dout, (float*)di, view(strides, 0), view(strides, 1), h, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args akv = a;
  akv.o0 = (bf16*)dk;
  akv.v0 = view(strides, 3);
  akv.o1 = (bf16*)dv;
  akv.v1 = view(strides, 4);
  flash_dkv_kernel<<<grid_dkv, THREADS, smem_bwd, st>>>(mq, mk, mv, md, akv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args aq = a;
  aq.o0 = (bf16*)dq;
  aq.v0 = view(strides, 2);
  flash_dq_kernel<<<grid_dq, THREADS, smem_bwd, st>>>(mq, mk, mv, md, aq);
  return (int)cudaGetLastError();
}

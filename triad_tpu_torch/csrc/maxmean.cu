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
// split_bf16, ~16 mantissa bits). The forward and the backward sum a sim
// the same way: wgmma products with both operands from shared memory in
// the 128-byte swizzle, D's 64-column chunks in order, 16 columns a
// product, hi.hi, lo.hi, hi.lo per step, zero chunks past D adding +0; the
// forward's tiles are 128 keys wide (m64n128k16), dQ's 64 (m64n64k16; 32
// split), and dK multiplies the transposed tile, K . Q^T. On the card the
// backward's recomputed sims equal the forward's bit for bit for bf16
// features, in dQ and dK, and in dQ for split fp32 features; dK's split
// sims differ from them in the last bit (7.5e-9 on sims below 1;
// tools/kernel_probe.py maxmean_fwd, TS lines). A sim that differs could
// change its window test only at clamp_min or at 0 exactly (a term of 2
// clamp_min g_nn T, or of 0): the argmax comes from the forward's int32
// amax residual, never from the backward's sims.
//
// What bounds it on the card: operations. A forward pass is 2 Bq Bk Nq Nk
// D of them; a backward pass recomputes the sims (the same count) and
// multiplies dts, as hi and lo, by K or Q (twice it). At the AV shape (64
// x 499 queries, 64 x 256 keys, D = 512) the forward is 5.4e11
// operations, 0.54 ms at the bf16 tensor-core peak, and each backward pass
// 1.6e12, 1.63 ms, far above their 45 MB of input.
//   forward  a Hopper kernel (hopper.cuh's helpers), the dQ kernel's frame:
//            items of 64 query rows of one clip (the tile's rows past Nq
//            read as zeros from a rank-3 (D, N, B) tensor map); a block of
//            two consumer warpgroups (one for split features at D = 512)
//            holds one item each, resident in shared memory, and a producer
//            thread streams every key of a range of key clips past both
//            through a 4-stage ring of 128-key x 64-column stages (16 KB,
//            32 KB split) by TMA. The two items share each stage, so K
//            crosses L2 once per 128 query rows: 256 blocks x 16.8 MB = 4.3
//            GB a call at the AV shape. A consumer sums its 64 x 128 sim
//            tile over D's chunks on SS wgmma m64n128k16 (three quarters
//            of the shared-memory reads per operation of m64n64k16, which
//            the first build used), and holds two sim tiles in turn: while one
//            tile's chunks are multiplied, it folds the other, a slice of
//            its columns per chunk, into its two rows' running (max, first
//            argmax), clamp^2 and window ts^2 sums in registers. No sim
//            goes to shared memory and no barrier spans the block. At a
//            clip's end the quad's rows reduce by shuffles (lowest key on
//            ties), the first argmax of every row goes to the int32 (Bq, Bk,
//            Nq) residual that the backward reads (8.2 MB at the AV shape;
//            the dK kernel tiles the keys and could not find a row's argmax
//            over all of them itself), and one (sum coeff max, clamp^2,
//            window ts^2) partial per (query tile, i, j) goes to device
//            memory through one named barrier of the warpgroup; the wrapper
//            sums the partials over the tiles (one torch reduction, a fixed
//            order). No atomics. Items alone fill the card
//            at the AV shape (512 items, 256 blocks); at the TV shape (Nq =
//            32: 64 items, each half past Nq) the key clips are cut into
//            ranges (grid.y) so that at least two blocks an SM run, without
//            more L2 reads per block. What was hard: ptxas (CUDA 12.8)
//            decides per build whether the fold beside products in flight
//            serialises them (C7514, printed by chip_smoke.py phase 2): at
//            6 stages it did and the kernel lost a third; at 4 it does not.
//            A rolled chunk loop makes it wait after every product (the
//            backward's lesson), so the chunk loop stays unrolled with the
//            stage waits inside.
//   dQ, dK   Hopper kernels (hopper.cuh's helpers), one body: a block per
//            item of 64 resident rows (dQ: query rows of clip i, dK: keys of
//            clip j), 384 threads: a producer warpgroup, one warp of which
//            keeps a 2-stage ring of 64-row streamed tiles full by TMA (dQ:
//            keys of every clip j, dK: query rows of every clip i; rank-3
//            maps over (D, N, B), so rows past Nq read as zeros and never as
//            the next clip's), with each tile's 64 scalars (amax and g_clip
//            coeff of its query rows, read once per tile, -1 and 0 past Nq),
//            and two consumer warpgroups on wgmma (setmaxnreg: producer 40,
//            consumers 232 registers a thread).
//            The output's 64 x D fp32 tile would need 256 accumulator
//            registers a thread at D = 512 in one warpgroup, so each
//            consumer owns half of D (128 accumulators at D = 512). Both
//            need the whole 64 x 64 sim tile, whose contraction runs over
//            all of D: each computes it itself (wgmma m64n64k16, both
//            operands from shared memory; 4 product passes where 3 would
//            do). tools/kernel_probe.py maxmean times this against a third
//            consumer warpgroup that computes the sims and dts once for
//            both (SIM_WG; slower: at 512 threads ptxas kept every thread
//            to 128 registers and spilled); PERF.md has the halves-added
//            variant and the earlier register-fragment designs.
//            dts goes from the sims' fp32 accumulator to the warpgroup's
//            own dts tiles in shared memory as bf16 hi and lo (16 KB, TMA's
//            swizzle), and out += dts . tile runs with both operands from
//            shared memory, the tile read MN-major (wgmma m64n128k16, two
//            per 16 rows at D = 512; hi, lo, and hi times the lo of split
//            features). In registers as A fragments, dts and the sims beside
//            128 accumulators made ptxas spill the accumulators around every
//            product. Each warpgroup's products retire before its next
//            tile's sims, and the stage is released at once; the other
//            warpgroup's products fill the tensor cores meanwhile. ptxas
//            still spills ~200 bytes a thread at D = 512 and serialises the
//            sims' wgmma (its note C7512, phase 2): the bound that is left.
//            Shared memory at D = 512: the resident 64 x 512 tile (64 KB),
//            two 64-row ring stages (128 KB) and the dts tiles (32 KB).
//            Split fp32 features double the resident tile and the stages:
//            they stream 32-row tiles, one stage at D = 512 (the products
//            then wait for each copy). D under 512 is padded with zero
//            chunks to 128, 256 or 512 (chunks_per_half).
//            dQ: grid (ceil(Nq / 64), Bq), walking (j, 64-key tile); dK: grid
//            (Nk / 64, Bk), walking (i, 64-query tile). At the TV shape (Nq
//            = 32) dQ has 64 blocks for 132 SMs, half of each tile's rows
//            past Nq: it is left so (PERF.md).
// Both backward kernels sum in a fixed order: deterministic, no atomics.
// D a multiple of 64 up to 512; Nk a multiple of 64; ragged Nq (rows past
// Nq are zero-filled and skipped).
#include <algorithm>

#include "hopper.cuh"

using namespace triad::hopper;

namespace {

using triad::bf16;

constexpr int MAX_D = 512;
constexpr int MAX_SMEM = 232448;

// The inputs as the kernels take them: bf16 halves (lo null for bf16
// features) and their shapes.
struct Inputs {
  const bf16 *qh, *ql, *kh, *kl;
  const float* coeff;  // (Bq, Nq)
  const float* temp;   // scalar T
  int bq, bk, nq, nk, d;
  float clamp_min;
};

// dL/d(raw sim) of one element.
__device__ inline float dts_of(float s, float temp, bool is_max, float g_max, float g_nn,
                               float clamp_min) {
  const float ts = s * temp;
  float d = is_max ? g_max : 0.0f;
  if (ts > clamp_min && ts < 0.0f) d += 2.0f * ts * g_nn;
  return d * temp;
}

// --------------------------------------------------------------- backward
//
// One kernel body for dQ and dK. An item is 64 resident rows (dQ: query
// rows of clip i; dK: keys of clip j); the ring streams tiles of the other
// operand (dQ: KT keys of every clip j; dK: KT query rows of every clip i)
// with the 64 (amax, g_clip coeff) scalars of the tile's pair. Per tile:
// the sim tile (dQ: S = Q K^T, dK: S^T = K Q^T), dts from it, then out +=
// dts . tile.

// Who computes a tile's sims and dts, which both output warpgroups read
// from shared memory: 1, a third consumer warpgroup of its own (the two
// output warpgroups then hold only their accumulators); 0, each output
// warpgroup computes the whole tile itself before its products (tools/
// kernel_probe.py maxmean times both).
constexpr int SIM_WG = 0;
constexpr int BW_CONSUMERS = 2;  // output warpgroups: the item's 64 rows, half of D each
constexpr int BW_THREADS = 128 * (BW_CONSUMERS + SIM_WG + 1);  // + the producer warpgroup
// Registers a thread after setmaxnreg, within the block's 65536: the
// producer 40 and the outputs 232 (40 + 2 x 232 = 504 of 384 x 168); with
// SIM_WG the producer 24, the sims 112 and the outputs 184 (24 + 112 + 2 x
// 184 = 504 of 512 x 128).
constexpr int BW_PRODUCER_REGS = SIM_WG ? 24 : 40, BW_SIM_REGS = 112;
constexpr int BW_CONSUMER_REGS = SIM_WG ? 184 : 232;
constexpr int BW_ROWS = 64;     // rows of the resident tile: one wgmma M
constexpr int CHUNK = 64;       // columns of D a TMA box (one 128-byte swizzle row) holds
constexpr int MAX_STAGES = 4;

// Rows of a streamed tile: 64, or 32 for split fp32 features, whose
// resident tile and ring take twice the bytes.
template <bool SPLIT>
constexpr int stream_rows() { return SPLIT ? 32 : 64; }

// The 64-column chunks of D that each consumer warpgroup owns; D is padded
// with zero chunks to twice that.
inline int chunks_per_half(int d) { return d <= 128 ? 1 : d <= 256 ? 2 : 4; }

template <bool SPLIT, int NC>
struct BwdLayout {
  static constexpr int KT = stream_rows<SPLIT>();
  static constexpr int HALVES = SPLIT ? 2 : 1;  // bf16 hi (+ lo) of each operand
  static constexpr int CHUNKS = 2 * NC;
  static constexpr int RES_CHUNK = BW_ROWS * CHUNK, TILE_CHUNK = KT * CHUNK;  // elements
  static constexpr int RES_BYTES = HALVES * CHUNKS * RES_CHUNK * 2;
  static constexpr int TILE_BYTES = HALVES * CHUNKS * TILE_CHUNK * 2;
  // Two dts tiles, bf16 hi and lo, 64 x 64 (KT columns used): one per
  // tile parity with SIM_WG, else one per output warpgroup.
  static constexpr int DTS_BYTES = 2 * 2 * BW_ROWS * CHUNK * 2;
  static constexpr int SCALAR_BYTES = 2 * BW_ROWS * 4;  // a stage's amax and g_max
  static constexpr int FIT = (MAX_SMEM - 1024 - RES_BYTES - DTS_BYTES - 40) /
                             (TILE_BYTES + SCALAR_BYTES + 16);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr size_t SMEM = 1024 + (size_t)RES_BYTES + (size_t)STAGES * TILE_BYTES +
                                 DTS_BYTES + (size_t)STAGES * SCALAR_BYTES +
                                 (2 * STAGES + 5) * 8;
  static_assert(STAGES >= 1 && SMEM <= (size_t)MAX_SMEM, "max-mean backward: no room");
};

struct BwdArgs {
  const float *coeff, *temp, *g_clip, *g_nn;
  const int* amax;
  float* out;
  int bq, bk, nq, nk, d;
  float clamp_min;
};

// Shared memory, 1024-aligned: the resident tile [HALVES][CHUNKS][64][64],
// the ring [STAGES][HALVES][CHUNKS][KT][64] (each chunk a TMA box in the
// 128-byte swizzle), the dts tiles [2][hi | lo][64][64] (the same
// swizzle), the stages' scalars [STAGES][amax | g_max][64], then the
// barriers.
struct BwdSmem {
  bf16 *res, *ring, *dts;
  float* scal;
  uint64_t *res_full, *full, *empty, *dts_full, *dts_empty;
};

template <class L>
__device__ __forceinline__ BwdSmem carve_bwd(unsigned char* raw) {
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  BwdSmem s;
  s.res = reinterpret_cast<bf16*>(base);
  s.ring = reinterpret_cast<bf16*>(base + L::RES_BYTES);
  s.dts = reinterpret_cast<bf16*>(base + L::RES_BYTES + L::STAGES * L::TILE_BYTES);
  s.scal = reinterpret_cast<float*>(base + L::RES_BYTES + L::STAGES * L::TILE_BYTES +
                                    L::DTS_BYTES);
  s.res_full = reinterpret_cast<uint64_t*>(s.scal + L::STAGES * 2 * BW_ROWS);
  s.full = s.res_full + 1;
  s.empty = s.full + L::STAGES;
  s.dts_full = s.empty + L::STAGES;
  s.dts_empty = s.dts_full + 2;
  return s;
}

// The item of a block and its tiles: dQ (clip i, rows r0 .. r0 + 63 of
// Nq), tiles (j, KT keys) for every key clip j; dK (clip j, keys r0 .. r0
// + 63), tiles (i, KT query rows) for every query clip i. Tile t is tile t
// % per of streamed clip t / per.
template <bool DQ, int KT>
struct Walk {
  int clip, r0, per, ntiles;
  __device__ Walk(const BwdArgs& a) {
    clip = blockIdx.y;
    r0 = blockIdx.x * BW_ROWS;
    per = DQ ? a.nk / KT : (a.nq + KT - 1) / KT;
    ntiles = (DQ ? a.bk : a.bq) * per;
  }
};

__device__ __forceinline__ void advance(int& stage, int& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// The producer warp: the resident tile's real chunks (those that hold D's
// columns) once, then per tile the 64 scalars of its pair, (amax, g_clip
// coeff) of query rows q0 .. q0 + 63 (-1 and 0 past Nq or past the tile,
// so that no row past Nq reads amax or coeff), and the tile's real chunks.
template <bool DQ, bool SPLIT, int NC>
__device__ __forceinline__ void bwd_produce(const BwdSmem& s, const CUtensorMap* map_rh,
                                            const CUtensorMap* map_rl, const CUtensorMap* map_th,
                                            const CUtensorMap* map_tl, const BwdArgs& a,
                                            int lane) {
  using L = BwdLayout<SPLIT, NC>;
  const Walk<DQ, L::KT> w(a);
  const int real = a.d / CHUNK;
  if (lane == 0) {
    mbar_expect_tx(s.res_full, L::HALVES * real * L::RES_CHUNK * 2);
    for (int h = 0; h < L::HALVES; ++h)
      for (int c = 0; c < real; ++c)
        tma_load_3d(s.res + (h * L::CHUNKS + c) * L::RES_CHUNK, h ? map_rl : map_rh, s.res_full,
                    c * CHUNK, w.r0, w.clip);
  }
  int stage = 0, phase = 0;
  for (int t = 0; t < w.ntiles; ++t) {
    const int other = t / w.per, row = (t % w.per) * L::KT;
    const int i = DQ ? w.clip : other, j = DQ ? other : w.clip;
    const int q0 = DQ ? w.r0 : row, npos = DQ ? BW_ROWS : L::KT;
    const long long pair = (long long)i * a.bk + j;
    int am[2];
    float g[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = lane + 32 * e, q = q0 + p;
      const bool ok = p < npos && q < a.nq;
      am[e] = ok ? a.amax[pair * a.nq + q] : -1;
      g[e] = ok ? a.g_clip[pair] * a.coeff[(long long)i * a.nq + q] : 0.0f;
    }
    mbar_wait(&s.empty[stage], phase ^ 1);
    int* sam = reinterpret_cast<int*>(s.scal + stage * 2 * BW_ROWS);
    float* sg = s.scal + stage * 2 * BW_ROWS + BW_ROWS;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sam[lane + 32 * e] = am[e];
      sg[lane + 32 * e] = g[e];
    }
    if (lane == 0) {
      bf16* dst = s.ring + stage * (L::TILE_BYTES / 2);
      mbar_expect_tx(&s.full[stage], L::HALVES * real * L::TILE_CHUNK * 2);
      for (int h = 0; h < L::HALVES; ++h)
        for (int c = 0; c < real; ++c)
          tma_load_3d(dst + (h * L::CHUNKS + c) * L::TILE_CHUNK, h ? map_tl : map_th,
                      &s.full[stage], c * CHUNK, row, other);
    } else {
      mbar_arrive(&s.full[stage]);
    }
    advance(stage, phase, L::STAGES);
  }
}

// d (64 x KT) (+)= A (64 x 16) . B (KT x 16)^T, both K-major in shared memory.
template <int KT>
__device__ __forceinline__ void mma_sim(float (&d)[KT / 2], const bf16* a, const bf16* b,
                                        int accumulate) {
  if constexpr (KT == 64)
    wgmma_m64n64k16(d, desc_sw128(a), desc_sw128(b), accumulate);
  else
    wgmma_m64n32k16(d, desc_sw128(a), desc_sw128(b), accumulate);
}

// Puts bf16 (a, b) at (row, col), (row, col + 1) of a 64 x 64 bf16 tile in
// TMA's 128-byte swizzle (the 16-byte chunk of column c in row r is chunk
// c / 8 ^ r % 8), so a warp's stores of one column group hit every bank
// once; col even.
__device__ __forceinline__ void put_pair(bf16* tile, int row, int col, __nv_bfloat162 v) {
  *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<unsigned char*>(tile) + row * 128 +
                                     (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2) = v;
}

// A tile's sims, summed over all of D by warpgroup-thread t: sv holds
// element (j, e) of the 64 x KT tile, row r + 8 (e / 2), column 8 j + col
// + e % 2 (r = 16 (t / 32) + t % 32 / 4, col = 2 (t % 4)).
template <bool SPLIT, int NC>
__device__ __forceinline__ void tile_sims(float (&sv)[BwdLayout<SPLIT, NC>::KT / 2],
                                          const BwdSmem& s, const bf16* tile) {
  using L = BwdLayout<SPLIT, NC>;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* rp = s.res + c * L::RES_CHUNK + kk * 16;
      const bf16* tp = tile + c * L::TILE_CHUNK + kk * 16;
      mma_sim<L::KT>(sv, rp, tp, c > 0 || kk > 0);
      if constexpr (SPLIT) {
        mma_sim<L::KT>(sv, rp + L::CHUNKS * L::RES_CHUNK, tp, 1);
        mma_sim<L::KT>(sv, rp, tp + L::CHUNKS * L::TILE_CHUNK, 1);
      }
    }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sv);
}

// dts in place of the sims of tile tt (dQ: rows are query rows and columns
// keys; dK: rows keys and columns query rows), from the stage's scalars.
template <bool DQ, int KT>
__device__ __forceinline__ void tile_dts(float (&sv)[KT / 2], const float* scal, int k0,
                                         const BwdArgs& a, float temp, float gnn, int t) {
  const int r = (t >> 5) * 16 + ((t & 31) >> 2), col = 2 * (t & 3);
  const int* sam = reinterpret_cast<const int*>(scal);
  const float* sg = scal + BW_ROWS;
  int am_r[2] = {0, 0};
  float g_r[2] = {0.0f, 0.0f};
  if constexpr (DQ) {
    am_r[0] = sam[r];
    am_r[1] = sam[r + 8];
    g_r[0] = sg[r];
    g_r[1] = sg[r + 8];
  }
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = r + 8 * (e >> 1), cc = 8 * j + col + (e & 1);
      const int am = DQ ? am_r[e >> 1] : sam[cc];
      const float gm = DQ ? g_r[e >> 1] : sg[cc];
      const int key = DQ ? k0 + cc : k0 + rr;
      sv[4 * j + e] = dts_of(sv[4 * j + e], temp, am == key, gm, gnn, a.clamp_min);
    }
}

// dts as bf16 hi and lo into a pair of dts tiles (hi, then lo 8 KB on).
// The thread's row is laundered so that its 16 store addresses are formed
// anew every tile: hoisted out of the tile loop, they held 32 registers
// beside the accumulators and ptxas spilled.
template <int KT>
__device__ __forceinline__ void put_dts(const float (&v)[KT / 2], bf16* hi, int t) {
  int r = (t >> 5) * 16 + ((t & 31) >> 2);
  asm volatile("" : "+r"(r));
  const int col = 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 bh = __floats2bfloat162_rn(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
      const float2 back = __bfloat1622float2(bh);
      put_pair(hi, r + 8 * h, 8 * j + col, bh);
      put_pair(hi + BW_ROWS * CHUNK, r + 8 * h, 8 * j + col,
               __floats2bfloat162_rn(v[4 * j + 2 * h] - back.x, v[4 * j + 2 * h + 1] - back.y));
    }
}

// out (64 x 64 NC) += A (64 x 16, K-major) . B (16 rows of the tile's NC
// chunks read MN-major, chunks KT rows apart): wgmma n128 per two chunks
// (n256 needs more registers than the launch leaves), n64 for one.
template <int NC, int KT>
__device__ __forceinline__ void mma_out(float (&d)[NC * 32], const bf16* a, const bf16* b) {
  const uint64_t da = desc_sw128(a);
  if constexpr (NC == 1) {
    wgmma_m64n64k16<1>(d, da, desc_sw128_mn(b), 1);
  } else {
#pragma unroll
    for (int p = 0; p < NC / 2; ++p)
      wgmma_m64n128k16<1>(*reinterpret_cast<float(*)[64]>(d + 64 * p), da,
                          desc_sw128_mn(b + 2 * p * KT * CHUNK, KT * CHUNK * 2), 1);
  }
}

// out += dts . tile over output warpgroup wg's chunks, both from shared
// memory: the tile read MN-major (its rows are the contraction); hi, lo
// (and hi times the lo of split features) per 16 rows; waited for.
template <bool SPLIT, int NC>
__device__ __forceinline__ void tile_outputs(float (&acc)[NC * 32], const bf16* dts_hi,
                                             const bf16* tile, int wg) {
  using L = BwdLayout<SPLIT, NC>;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::KT / 16; ++kk) {
    const bf16* bp = tile + wg * NC * L::TILE_CHUNK + kk * 16 * CHUNK;
    mma_out<NC, L::KT>(acc, dts_hi + kk * 16, bp);
    mma_out<NC, L::KT>(acc, dts_hi + BW_ROWS * CHUNK + kk * 16, bp);
    if constexpr (SPLIT)
      mma_out<NC, L::KT>(acc, dts_hi + kk * 16, bp + L::CHUNKS * L::TILE_CHUNK);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// The sims warpgroup (SIM_WG): per tile the sims, dts, and dts into the
// dts tiles of the tile's parity once both output warpgroups are done
// with them (dts_empty), announced on dts_full by all 128 threads.
template <bool DQ, bool SPLIT, int NC>
__device__ __forceinline__ void bwd_sims(const BwdSmem& s, const BwdArgs& a, int t) {
  using L = BwdLayout<SPLIT, NC>;
  const Walk<DQ, L::KT> w(a);
  const float temp = *a.temp, gnn = *a.g_nn;
  mbar_wait(s.res_full, 0);
  int stage = 0, phase = 0, buf = 0, bphase = 0;
  for (int tt = 0; tt < w.ntiles; ++tt) {
    mbar_wait(&s.full[stage], phase);
    float sv[L::KT / 2];
    tile_sims<SPLIT, NC>(sv, s, s.ring + stage * (L::TILE_BYTES / 2));
    tile_dts<DQ, L::KT>(sv, s.scal + stage * 2 * BW_ROWS, DQ ? (tt % w.per) * L::KT : w.r0, a,
                        temp, gnn, t);
    mbar_wait(&s.dts_empty[buf], bphase ^ 1);
    put_dts<L::KT>(sv, s.dts + buf * 2 * BW_ROWS * CHUNK, t);
    fence_proxy_async();
    mbar_arrive(&s.dts_full[buf]);
    advance(stage, phase, L::STAGES);
    advance(buf, bphase, 2);
  }
}

// The store of output warpgroup wg's accumulators: rows (dQ: below Nq)
// and the chunks that hold D's columns.
template <bool DQ, int NC>
__device__ __forceinline__ void store_out(const float (&acc)[NC * 32], const BwdArgs& a,
                                          int clip, int r0, int wg, int t) {
  const int row = r0 + (t >> 5) * 16 + ((t & 31) >> 2), col = 2 * (t & 3);
  const int nrows = DQ ? a.nq : a.nk;
  float* out = a.out + (long long)clip * nrows * a.d;
#pragma unroll
  for (int j = 0; j < NC * 8; ++j) {
    const int cc = wg * NC * CHUNK + 8 * j + col;
    if (cc >= a.d) continue;
    if (row < nrows)
      *reinterpret_cast<float2*>(out + (long long)row * a.d + cc) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < nrows)
      *reinterpret_cast<float2*>(out + (long long)(row + 8) * a.d + cc) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Output warpgroup wg: the output's 64 rows x its NC chunks of D, NC x 32
// fp32 accumulators a thread. With SIM_WG it takes each tile's dts from
// the sims warpgroup; else it computes the tile's sims and dts itself into
// dts tiles of its own. Either way it releases the stage once its
// products retired (and, with SIM_WG, the dts tiles).
template <bool DQ, bool SPLIT, int NC>
__device__ __forceinline__ void bwd_outputs(const BwdSmem& s, const BwdArgs& a, int wg, int t) {
  using L = BwdLayout<SPLIT, NC>;
  const Walk<DQ, L::KT> w(a);
  float acc[NC * 32];
#pragma unroll
  for (int e = 0; e < NC * 32; ++e) acc[e] = 0.0f;
  if constexpr (!SIM_WG) mbar_wait(s.res_full, 0);
  int stage = 0, phase = 0, buf = 0, bphase = 0;
  for (int tt = 0; tt < w.ntiles; ++tt) {
    mbar_wait(&s.full[stage], phase);
    const bf16* tile = s.ring + stage * (L::TILE_BYTES / 2);
    bf16* dts_hi = s.dts + (SIM_WG ? buf : wg) * 2 * BW_ROWS * CHUNK;
    if constexpr (SIM_WG) {
      mbar_wait(&s.dts_full[buf], bphase);
    } else {
      float sv[L::KT / 2];
      tile_sims<SPLIT, NC>(sv, s, tile);
      tile_dts<DQ, L::KT>(sv, s.scal + stage * 2 * BW_ROWS, DQ ? (tt % w.per) * L::KT : w.r0,
                          a, *a.temp, *a.g_nn, t);
      put_dts<L::KT>(sv, dts_hi, t);
      fence_proxy_async();
      warpgroup_sync(wg);
    }
    tile_outputs<SPLIT, NC>(acc, dts_hi, tile, wg);
    if (t == 0) {
      if constexpr (SIM_WG) mbar_arrive(&s.dts_empty[buf]);
      mbar_arrive(&s.empty[stage]);
    }
    advance(stage, phase, L::STAGES);
    advance(buf, bphase, 2);
  }
  store_out<DQ, NC>(acc, a, w.clip, w.r0, wg, t);
}

template <bool DQ, bool SPLIT, int NC>
__device__ __forceinline__ void bwd_body(const CUtensorMap* map_rh, const CUtensorMap* map_rl,
                                         const CUtensorMap* map_th, const CUtensorMap* map_tl,
                                         const BwdArgs& a) {
  using L = BwdLayout<SPLIT, NC>;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem s = carve_bwd<L>(smem_raw);
  const int real = a.d / CHUNK;
  if (real < L::CHUNKS) {
    // The chunks past D, which no copy writes, read as zeros.
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int h = 0; h < L::HALVES; ++h)
      for (int c = real; c < L::CHUNKS; ++c) {
        uint4* p = reinterpret_cast<uint4*>(s.res + (h * L::CHUNKS + c) * L::RES_CHUNK);
        for (int i = threadIdx.x; i < L::RES_CHUNK / 8; i += BW_THREADS) p[i] = z;
        for (int st = 0; st < L::STAGES; ++st) {
          uint4* q = reinterpret_cast<uint4*>(s.ring + st * (L::TILE_BYTES / 2) +
                                              (h * L::CHUNKS + c) * L::TILE_CHUNK);
          for (int i = threadIdx.x; i < L::TILE_CHUNK / 8; i += BW_THREADS) q[i] = z;
        }
      }
    fence_proxy_async();
  }
  // Barriers: the resident tile's full takes the producer's one arrival
  // and its bytes; a stage's full the producer warp's 32 arrivals (lane
  // 0's with the bytes) after its scalars are written, its empty one
  // arrival per output warpgroup once the products that read it retired;
  // a dts pair's full the sims warpgroup's 128 arrivals after its writes,
  // its empty one arrival per output warpgroup.
  if (threadIdx.x == 0) {
    mbar_init(s.res_full, 1);
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&s.full[i], 32);
      mbar_init(&s.empty[i], BW_CONSUMERS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.dts_full[i], 128);
      mbar_init(&s.dts_empty[i], BW_CONSUMERS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  // The warpgroup, warp-uniform to the compiler (broadcast from lane 0).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0), t = threadIdx.x % 128;
  if (wg == BW_CONSUMERS + SIM_WG) {
    setmaxnreg_dec<BW_PRODUCER_REGS>();
    if (t < 32) bwd_produce<DQ, SPLIT, NC>(s, map_rh, map_rl, map_th, map_tl, a, t);
  } else if (wg == BW_CONSUMERS) {
    if constexpr (SIM_WG) {
      setmaxnreg_dec<BW_SIM_REGS>();
      bwd_sims<DQ, SPLIT, NC>(s, a, t);
    }
  } else {
    setmaxnreg_inc<BW_CONSUMER_REGS>();
    bwd_outputs<DQ, SPLIT, NC>(s, a, wg, t);
  }
}

// dQ: grid (ceil(Nq / 64), Bq); the maps: Q (resident, 64-row boxes) and
// K (streamed, KT-row boxes), hi and lo (lo = hi for bf16 features).
template <bool SPLIT, int NC>
__global__ void __launch_bounds__(BW_THREADS, 1)
maxmean_dq_kernel(const __grid_constant__ CUtensorMap map_qh,
                  const __grid_constant__ CUtensorMap map_ql,
                  const __grid_constant__ CUtensorMap map_kh,
                  const __grid_constant__ CUtensorMap map_kl, const BwdArgs a) {
  bwd_body<true, SPLIT, NC>(&map_qh, &map_ql, &map_kh, &map_kl, a);
}

// dK: grid (Nk / 64, Bk); the maps: K (resident, 64-row boxes) and Q
// (streamed, KT-row boxes; rows past Nq read as zeros).
template <bool SPLIT, int NC>
__global__ void __launch_bounds__(BW_THREADS, 1)
maxmean_dk_kernel(const __grid_constant__ CUtensorMap map_kh,
                  const __grid_constant__ CUtensorMap map_kl,
                  const __grid_constant__ CUtensorMap map_qh,
                  const __grid_constant__ CUtensorMap map_ql, const BwdArgs a) {
  bwd_body<false, SPLIT, NC>(&map_kh, &map_kl, &map_qh, &map_ql, a);
}

// ---------------------------------------------------------------- forward
//
// An item is 64 query rows of one clip (tile r of clip i, rows 64 r ..
// 64 r + 63, zeros past Nq); a block holds FwdLayout::CONS items, one per
// consumer warpgroup (items CONS blockIdx.x + wg of the (i, r) list), and
// streams the keys of the key clips j0 .. j1 - 1 of its range past them,
// one FW_KEYS-key x 64-column chunk a ring stage, D's chunks in order.
// Each consumer warpgroup sums a 64 x FW_KEYS sim tile over the chunks
// (SS wgmma), and folds the previous tile into its rows' running (max,
// first argmax) and clamp^2 / window ts^2 sums in registers, a slice per
// chunk while that chunk's products run; at clip j's last key tile it
// writes its rows' first argmax and one partial (sum of coeff max,
// clamp^2, window ts^2) for (tile, i, j).

constexpr int FW_KEYS = 128;  // keys of a ring stage and of a sim tile (one wgmma's N)
// Stages of the ring: 4 (64 KB). At 6 (what fits beside two D = 512
// items) ptxas serialised the products (C7514) and the kernel ran 35%
// slower (tools/kernel_probe.py maxmean_fwd).
constexpr int FW_MAX_STAGES = 4;
// Registers a thread after setmaxnreg (two items a block, 384 threads):
// the producer 40, the consumers 232, which hold two sim tiles.
constexpr int FW_PRODUCER_REGS = 40, FW_CONSUMER_REGS = 232;

// The 64-column chunks a forward item holds: D padded to 128, 256 or 512
// (the padding's copies read zeros past D), as the backward pads it.
inline int fwd_chunks(int d) { return 2 * chunks_per_half(d); }

template <bool SPLIT, int NC>
struct FwdLayout {
  static constexpr int HALVES = SPLIT ? 2 : 1;
  // Consumer warpgroups (items) a block: split features at D = 512 take
  // one, their 64 resident rows being 128 KB.
  static constexpr int CONS = SPLIT && NC == 8 ? 1 : 2;
  static constexpr int THREADS = 128 * (CONS + 1);  // + the producer warpgroup
  static constexpr int BOX = BW_ROWS * CHUNK;        // elements of a 64-row TMA box
  static constexpr int KBOX = FW_KEYS * CHUNK;       // elements of a key box
  static constexpr int RES_BYTES = CONS * HALVES * NC * BOX * 2;
  static constexpr int STAGE_BYTES = HALVES * KBOX * 2;
  static constexpr int RED_BYTES = 2 * CONS * 4 * 4 * 4;  // [clip parity][wg][warp][4]
  static constexpr int FIT =
      (MAX_SMEM - 1024 - RES_BYTES - RED_BYTES - 8 * CONS) / (STAGE_BYTES + 16);
  static constexpr int STAGES = FIT < FW_MAX_STAGES ? FIT : FW_MAX_STAGES;
  static constexpr size_t SMEM = 1024 + (size_t)RES_BYTES + (size_t)STAGES * STAGE_BYTES +
                                 RED_BYTES + (CONS + 2 * STAGES) * 8;
  static_assert(STAGES >= 2 && SMEM <= (size_t)MAX_SMEM, "max-mean forward: no room");
};

struct FwdArgs {
  const float *coeff, *temp;
  int* amax;    // (Bq, Bk, Nq)
  float* part;  // (ntq, Bq, Bk, 3): per query tile, pair: sum coeff max, clamp^2, window ts^2
  int bq, bk, nq, nk, ntq, per;  // ntq: 64-row tiles of a clip; per: key clips of a range
  float clamp_min;
};

// Shared memory, 1024-aligned: the resident items [CONS][HALVES][NC][64][64]
// and the ring [STAGES][HALVES][FW_KEYS][64] (TMA boxes in the 128-byte
// swizzle), the warps' partial sums, then the barriers.
struct FwdSmem {
  bf16 *res, *ring;
  float* red;
  uint64_t *res_full, *full, *empty;
};

template <class L>
__device__ __forceinline__ FwdSmem carve_fwd(unsigned char* raw) {
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  FwdSmem s;
  s.res = reinterpret_cast<bf16*>(base);
  s.ring = reinterpret_cast<bf16*>(base + L::RES_BYTES);
  s.red = reinterpret_cast<float*>(base + L::RES_BYTES + L::STAGES * L::STAGE_BYTES);
  s.res_full = reinterpret_cast<uint64_t*>(base + L::RES_BYTES + L::STAGES * L::STAGE_BYTES +
                                           L::RED_BYTES);
  s.full = s.res_full + L::CONS;
  s.empty = s.full + L::STAGES;
  return s;
}

// One producer thread: each item's resident tile once, then per key clip
// of the range, per FW_KEYS-key tile, per chunk of D one stage (keys past
// Nk read as zeros).
template <bool SPLIT, int NC>
__device__ __forceinline__ void fwd_produce(const FwdSmem& s, const CUtensorMap* map_qh,
                                            const CUtensorMap* map_ql, const CUtensorMap* map_kh,
                                            const CUtensorMap* map_kl, const FwdArgs& a,
                                            int active) {
  using L = FwdLayout<SPLIT, NC>;
  for (int w = 0; w < active; ++w) {
    const int item = L::CONS * blockIdx.x + w;
    const int i = item / a.ntq, r0 = (item % a.ntq) * BW_ROWS;
    mbar_expect_tx(&s.res_full[w], L::HALVES * NC * L::BOX * 2);
    for (int h = 0; h < L::HALVES; ++h)
      for (int c = 0; c < NC; ++c)
        tma_load_3d(s.res + ((w * L::HALVES + h) * NC + c) * L::BOX, h ? map_ql : map_qh,
                    &s.res_full[w], c * CHUNK, r0, i);
  }
  const int j0 = blockIdx.y * a.per, j1 = min(a.bk, j0 + a.per);
  int stage = 0, phase = 0;
  for (int j = j0; j < j1; ++j)
    for (int k0 = 0; k0 < a.nk; k0 += FW_KEYS)
      for (int c = 0; c < NC; ++c) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        bf16* dst = s.ring + stage * (L::STAGE_BYTES / 2);
        mbar_expect_tx(&s.full[stage], L::STAGE_BYTES);
        tma_load_3d(dst, map_kh, &s.full[stage], c * CHUNK, k0, j);
        if constexpr (SPLIT) tma_load_3d(dst + L::KBOX, map_kl, &s.full[stage], c * CHUNK, k0, j);
        advance(stage, phase, L::STAGES);
      }
}

// d (64 x FW_KEYS) (+)= A (64 x 16) . B (FW_KEYS x 16)^T, both K-major in
// shared memory.
__device__ __forceinline__ void mma_keys(float (&d)[FW_KEYS / 2], const bf16* a, const bf16* b,
                                         int accumulate) {
  wgmma_m64n128k16(d, desc_sw128(a), desc_sw128(b), accumulate);
}

// A consumer's running state for the rows r and r + 8 of its item that
// thread t holds (r = 16 (t / 32) + t % 32 / 4): the max ts and its first
// key, and the thread's clamp^2 and window ts^2 sums over the clip.
struct Fold {
  float best[2], nn, tsq;
  int arg[2];
  __device__ __forceinline__ void reset() {
    best[0] = best[1] = -INFINITY;
    arg[0] = arg[1] = 0;
    nn = tsq = 0.0f;
  }
};

// Folds slice c of NC of a sim tile (key columns 8 jj + col + {0, 1},
// jj in the slice) whose first key is k0: keys in increasing order within
// the thread, so a strict > keeps the first max; keys past Nk (zeros of
// the last tile) take no part in the max.
template <int NC>
__device__ __forceinline__ void fold_slice(const float (&sv)[FW_KEYS / 2], Fold& f, int c, int k0,
                                           int col, float temp, float cm, int nk) {
  constexpr int JPS = FW_KEYS / 8 / NC;
#pragma unroll
  for (int jj = c * JPS; jj < (c + 1) * JPS; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ts = sv[4 * jj + e] * temp;
      const float cl = fminf(fmaxf(ts, cm), 0.0f);
      f.nn += cl * cl;
      if (ts > cm && ts < 0.0f) f.tsq += ts * ts;
      const int key = k0 + 8 * jj + col + (e & 1);
      if (ts > f.best[e >> 1] && key < nk) {
        f.best[e >> 1] = ts;
        f.arg[e >> 1] = key;
      }
    }
}

// One key tile of a consumer: per chunk c, wait for its stage, issue its
// products into cur, release the previous chunk's stage once its products
// retired (pending), then fold slice c of prev (the previous tile, whose
// first key is prev_k0) while chunk c's products run.
template <bool SPLIT, int NC, bool FOLD>
__device__ __forceinline__ void fwd_tile(float (&cur)[FW_KEYS / 2], float (&prev)[FW_KEYS / 2],
                                         Fold& f, const FwdSmem& s, const bf16* res, int& stage,
                                         int& phase, int& pending, int prev_k0, int col,
                                         float temp, float cm, int nk, int t) {
  using L = FwdLayout<SPLIT, NC>;
  fence_regs(cur);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    mbar_wait(&s.full[stage], phase);
    const bf16* kt = s.ring + stage * (L::STAGE_BYTES / 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* rp = res + c * L::BOX + kk * 16;
      const bf16* tp = kt + kk * 16;
      mma_keys(cur, rp, tp, c > 0 || kk > 0);
      if constexpr (SPLIT) {
        mma_keys(cur, rp + NC * L::BOX, tp, 1);
        mma_keys(cur, rp, tp + L::KBOX, 1);
      }
    }
    wgmma_commit();
    if (pending >= 0) {  // all but this chunk's products retired
      wgmma_wait<1>();
      if (t == 0) mbar_arrive(&s.empty[pending]);
    }
    pending = stage;
    advance(stage, phase, L::STAGES);
    if constexpr (FOLD) {
      if (c == 0) fence_regs(prev);
      fold_slice<NC>(prev, f, c, prev_k0, col, temp, cm, nk);
    }
  }
}

// Consumer warpgroup wg: its item's 64 rows against every key of the
// range, tile by tile (the flattened (key clip, key tile) sequence), two
// sim tiles in turn so that each is folded while the next one's products
// run.
template <bool SPLIT, int NC>
__device__ __forceinline__ void fwd_consume(const FwdSmem& s, const FwdArgs& a, int wg, int t) {
  using L = FwdLayout<SPLIT, NC>;
  const int item = L::CONS * blockIdx.x + wg;
  const int i = item / a.ntq, tile = item % a.ntq;
  const int warp = t >> 5, lane = t & 31;
  const int q0 = tile * BW_ROWS + warp * 16 + (lane >> 2), col = 2 * (lane & 3);
  const float temp = *a.temp, cm = a.clamp_min;
  float cf[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    cf[h] = q0 + 8 * h < a.nq ? a.coeff[(long long)i * a.nq + q0 + 8 * h] : 0.0f;
  const bf16* res = s.res + wg * L::HALVES * NC * L::BOX;
  const int j0 = blockIdx.y * a.per, j1 = min(a.bk, j0 + a.per);
  const int per_clip = (a.nk + FW_KEYS - 1) / FW_KEYS, ntiles = (j1 - j0) * per_clip;
  int parity = 0;
  // Clip j's end: the rows' max over the quad's keys (lowest key on ties),
  // the first argmax of every row, and the warpgroup's partials of (tile,
  // i, j), the warps' sums added in a fixed order.
  auto clip_end = [&](Fold& f, int j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, f.best[h], o);
        const int oa = __shfl_xor_sync(0xffffffffu, f.arg[h], o);
        if (ob > f.best[h] || (ob == f.best[h] && oa < f.arg[h])) {
          f.best[h] = ob;
          f.arg[h] = oa;
        }
      }
    float clip = 0.0f, nn = f.nn, tsq = f.tsq;
    if ((lane & 3) == 0) {
      const long long pair = (long long)i * a.bk + j;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (q0 + 8 * h < a.nq) {
          a.amax[pair * a.nq + q0 + 8 * h] = f.arg[h];
          clip += cf[h] * f.best[h];
        }
    }
    for (int o = 1; o < 32; o <<= 1) {
      clip += __shfl_xor_sync(0xffffffffu, clip, o);
      nn += __shfl_xor_sync(0xffffffffu, nn, o);
      tsq += __shfl_xor_sync(0xffffffffu, tsq, o);
    }
    float* red = s.red + (parity * L::CONS + wg) * 16;
    if (lane == 0) {
      red[warp * 4] = clip;
      red[warp * 4 + 1] = nn;
      red[warp * 4 + 2] = tsq;
    }
    warpgroup_sync(wg);
    if (t == 0) {
      float* out = a.part + (((long long)tile * a.bq + i) * a.bk + j) * 3;
#pragma unroll
      for (int v = 0; v < 3; ++v) out[v] = red[v] + red[4 + v] + red[8 + v] + red[12 + v];
    }
    parity ^= 1;  // the next clip writes the other half, so no second barrier
    f.reset();
  };
  // After tile n's products are issued, tile n - 1 has been folded: close
  // its clip if it was the clip's last tile.
  auto after = [&](Fold& f, int n) {
    if (n % per_clip == 0) clip_end(f, j0 + n / per_clip - 1);
  };
  Fold f;
  f.reset();
  float sa[FW_KEYS / 2], sb[FW_KEYS / 2];
  int stage = 0, phase = 0, pending = -1;
  mbar_wait(&s.res_full[wg], 0);
  fwd_tile<SPLIT, NC, false>(sa, sb, f, s, res, stage, phase, pending, 0, col, temp, cm, a.nk,
                             t);
  int n = 1;
  for (; n + 1 < ntiles; n += 2) {
    fwd_tile<SPLIT, NC, true>(sb, sa, f, s, res, stage, phase, pending,
                              ((n - 1) % per_clip) * FW_KEYS, col, temp, cm, a.nk, t);
    after(f, n);
    fwd_tile<SPLIT, NC, true>(sa, sb, f, s, res, stage, phase, pending,
                              (n % per_clip) * FW_KEYS, col, temp, cm, a.nk, t);
    after(f, n + 1);
  }
  // n == ntiles - 1 (one tile left to issue) or n == ntiles (none)
  const int last_k0 = ((ntiles - 1) % per_clip) * FW_KEYS;
  if (n < ntiles) {
    fwd_tile<SPLIT, NC, true>(sb, sa, f, s, res, stage, phase, pending,
                              ((n - 1) % per_clip) * FW_KEYS, col, temp, cm, a.nk, t);
    after(f, n);
    wgmma_wait<0>();
    fence_regs(sb);
#pragma unroll
    for (int c = 0; c < NC; ++c) fold_slice<NC>(sb, f, c, last_k0, col, temp, cm, a.nk);
  } else {
    wgmma_wait<0>();
    fence_regs(sa);
#pragma unroll
    for (int c = 0; c < NC; ++c) fold_slice<NC>(sa, f, c, last_k0, col, temp, cm, a.nk);
  }
  if (t == 0) mbar_arrive(&s.empty[pending]);
  clip_end(f, j1 - 1);
}

// Grid (ceil(items / CONS), ranges of key clips); the maps: Q (resident,
// 64-row boxes; rows past Nq read as zeros) and K (FW_KEYS-row boxes), hi
// and lo (lo = hi for bf16 features).
template <bool SPLIT, int NC>
__global__ void __launch_bounds__(FwdLayout<SPLIT, NC>::THREADS, 1)
maxmean_fwd_kernel(const __grid_constant__ CUtensorMap map_qh,
                   const __grid_constant__ CUtensorMap map_ql,
                   const __grid_constant__ CUtensorMap map_kh,
                   const __grid_constant__ CUtensorMap map_kl, const FwdArgs a) {
  using L = FwdLayout<SPLIT, NC>;
  extern __shared__ unsigned char smem_raw[];
  const FwdSmem s = carve_fwd<L>(smem_raw);
  const int active = min(L::CONS, a.bq * a.ntq - L::CONS * (int)blockIdx.x);
  // Barriers: an item's full takes the producer's one arrival and its
  // bytes; a stage's full likewise, its empty one arrival per active
  // consumer warpgroup once the products that read it retired.
  if (threadIdx.x == 0) {
    for (int w = 0; w < L::CONS; ++w) mbar_init(&s.res_full[w], 1);
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], active);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0), t = threadIdx.x % 128;
  if (wg == L::CONS) {
    if constexpr (L::CONS == 2) setmaxnreg_dec<FW_PRODUCER_REGS>();
    if (t == 0) fwd_produce<SPLIT, NC>(s, &map_qh, &map_ql, &map_kh, &map_kl, a, active);
  } else {
    if constexpr (L::CONS == 2) setmaxnreg_inc<FW_CONSUMER_REGS>();
    if (wg < active) fwd_consume<SPLIT, NC>(s, a, wg, t);
  }
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

// A contiguous bf16 (b, n, d) operand as a rank-3 tensor map (d, n, b),
// boxes of 64 columns x rows x 1: rows past n read as zeros, never the
// next clip's.
bool map3d(CUtensorMap* map, const bf16* base, int b, int n, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[2] = {2ull * d, 2ull * d * n};
  const cuuint32_t box[3] = {(cuuint32_t)CHUNK, (cuuint32_t)rows, 1};
  return encode(map, base, 3, dims, strides, box);
}

// The forward's key-clip ranges: enough blocks for two per SM where the
// items alone give fewer than one per SM (the TV loss's 32-row clips).
// Returns the key clips a range holds.
inline int fwd_per(int blocks, int bk, int sms) {
  int ranges = 1;
  if (blocks < sms) ranges = std::min(bk, (2 * sms + blocks - 1) / blocks);
  return (bk + ranges - 1) / ranges;
}

template <bool SPLIT, int NC>
int launch_fwd(const Inputs& in, int* amax, float* part, cudaStream_t stream) {
  using L = FwdLayout<SPLIT, NC>;
  auto kernel = maxmean_fwd_kernel<SPLIT, NC>;
  static bool ready[MAX_DEVICES];
  int dev = 0;
  const cudaError_t err = bind_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!ready[dev]) {
    const int set = prepare(kernel, L::SMEM);
    if (set) return set;
    ready[dev] = true;
  }
  CUtensorMap m[4];
  if (!map3d(&m[0], in.qh, in.bq, in.nq, in.d, BW_ROWS) ||
      !map3d(&m[2], in.kh, in.bk, in.nk, in.d, FW_KEYS))
    return (int)cudaErrorInvalidValue;
  m[1] = m[0];
  m[3] = m[2];
  if (SPLIT && (!map3d(&m[1], in.ql, in.bq, in.nq, in.d, BW_ROWS) ||
                !map3d(&m[3], in.kl, in.bk, in.nk, in.d, FW_KEYS)))
    return (int)cudaErrorInvalidValue;
  const int ntq = (in.nq + BW_ROWS - 1) / BW_ROWS;
  const int blocks = (in.bq * ntq + L::CONS - 1) / L::CONS;
  const int per = fwd_per(blocks, in.bk, sm_count(dev));
  const FwdArgs a{in.coeff, in.temp, amax, part, in.bq, in.bk, in.nq, in.nk, ntq, per,
                  in.clamp_min};
  kernel<<<dim3(blocks, (in.bk + per - 1) / per), L::THREADS, L::SMEM, stream>>>(m[0], m[1], m[2],
                                                                                 m[3], a);
  return (int)cudaGetLastError();
}

// One backward grid on the stream: its tensor maps and its dynamic shared
// memory (set once per device and process).
template <bool DQ, bool SPLIT, int NC>
int launch_bwd(const Inputs& in, const BwdArgs& a, cudaStream_t stream) {
  using L = BwdLayout<SPLIT, NC>;
  auto kernel = DQ ? maxmean_dq_kernel<SPLIT, NC> : maxmean_dk_kernel<SPLIT, NC>;
  static bool ready[MAX_DEVICES];
  int dev = 0;
  const cudaError_t err = bind_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!ready[dev]) {
    const int set = prepare(kernel, L::SMEM);
    if (set) return set;
    ready[dev] = true;
  }
  // The resident operand (dQ: q, dK: k) in 64-row boxes, the streamed one
  // in KT-row boxes.
  const bf16 *rh = DQ ? in.qh : in.kh, *rl = DQ ? in.ql : in.kl;
  const bf16 *th = DQ ? in.kh : in.qh, *tl = DQ ? in.kl : in.ql;
  const int rb = DQ ? in.bq : in.bk, rn = DQ ? in.nq : in.nk;
  const int tb = DQ ? in.bk : in.bq, tn = DQ ? in.nk : in.nq;
  CUtensorMap m[4];
  if (!map3d(&m[0], rh, rb, rn, in.d, BW_ROWS) || !map3d(&m[2], th, tb, tn, in.d, L::KT))
    return (int)cudaErrorInvalidValue;
  m[1] = m[0];
  m[3] = m[2];
  if (SPLIT && (!map3d(&m[1], rl, rb, rn, in.d, BW_ROWS) || !map3d(&m[3], tl, tb, tn, in.d, L::KT)))
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3((rn + BW_ROWS - 1) / BW_ROWS, rb), BW_THREADS, L::SMEM, stream>>>(m[0], m[1], m[2],
                                                                                 m[3], a);
  return (int)cudaGetLastError();
}

template <bool DQ>
int backward(const Inputs& in, const void* g_clip, const void* g_nn, const void* amax, void* out,
             void* stream) {
  if (bad_shape(in)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{in.coeff,         in.temp, (const float*)g_clip, (const float*)g_nn,
                  (const int*)amax, (float*)out, in.bq, in.bk, in.nq, in.nk, in.d, in.clamp_min};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool split = in.ql != nullptr;
  switch (chunks_per_half(in.d)) {
    case 1:
      return split ? launch_bwd<DQ, true, 1>(in, a, st) : launch_bwd<DQ, false, 1>(in, a, st);
    case 2:
      return split ? launch_bwd<DQ, true, 2>(in, a, st) : launch_bwd<DQ, false, 2>(in, a, st);
    default:
      return split ? launch_bwd<DQ, true, 4>(in, a, st) : launch_bwd<DQ, false, 4>(in, a, st);
  }
}

}  // namespace

// q (Bq, Nq, D) and k (Bk, Nk, D) contiguous bf16, as hi and lo halves (the
// lo pointers null for bf16 features, both set for split fp32 features);
// coeff (Bq, Nq) fp32; temp: the fp32 temperature on the device. Writes
// amax (Bq, Bk, Nq) int32 (first argmax over keys) and partials
// (ceil(Nq / 64), Bq, Bk, 3) fp32: per 64-row query tile and pair, the
// tile's sum of coeff max, its clamp^2 sum and its window ts^2 sum. clip
// is not written: the caller sums the partials over the tiles
// (ops/maxmean.py:maxmean_fwd), clip[i, j] the first column's. Returns a
// cudaError_t.
extern "C" int triad_maxmean_fwd(const void* qh, const void* ql, const void* kh, const void* kl,
                                 const void* coeff, const void* temp, void* clip, void* amax,
                                 void* partials, int bq, int bk, int nq, int nk, int d,
                                 float clamp_min, void* stream) {
  const Inputs in = inputs_of(qh, ql, kh, kl, coeff, temp, bq, bk, nq, nk, d, clamp_min);
  if (bad_shape(in)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* p = (float*)partials;
  int* am = (int*)amax;
  const bool split = ql != nullptr;
  switch (fwd_chunks(d)) {
    case 2:
      return split ? launch_fwd<true, 2>(in, am, p, st) : launch_fwd<false, 2>(in, am, p, st);
    case 4:
      return split ? launch_fwd<true, 4>(in, am, p, st) : launch_fwd<false, 4>(in, am, p, st);
    default:
      return split ? launch_fwd<true, 8>(in, am, p, st) : launch_fwd<false, 8>(in, am, p, st);
  }
}

// dq (Bq, Nq, D) fp32 from the forward's inputs and amax, g_clip (Bq, Bk)
// fp32 and g_nn, the fp32 cotangent of the clamp^2 sum on the device.
extern "C" int triad_maxmean_dq(const void* qh, const void* ql, const void* kh, const void* kl,
                                const void* coeff, const void* temp, const void* g_clip,
                                const void* g_nn, const void* amax, void* dq, int bq, int bk,
                                int nq, int nk, int d, float clamp_min, void* stream) {
  return backward<true>(inputs_of(qh, ql, kh, kl, coeff, temp, bq, bk, nq, nk, d, clamp_min),
                        g_clip, g_nn, amax, dq, stream);
}

// dk (Bk, Nk, D) fp32, with the arguments of triad_maxmean_dq.
extern "C" int triad_maxmean_dk(const void* qh, const void* ql, const void* kh, const void* kl,
                                const void* coeff, const void* temp, const void* g_clip,
                                const void* g_nn, const void* amax, void* dk, int bq, int bk,
                                int nq, int nk, int d, float clamp_min, void* stream) {
  return backward<false>(inputs_of(qh, ql, kh, kl, coeff, temp, bq, bk, nq, nk, d, clamp_min),
                         g_clip, g_nn, amax, dk, stream);
}

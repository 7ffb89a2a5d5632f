// Fused transformer MLP on Hopper, forward and backward: y =
// dropout(gelu(x W1^T + b1)) W2^T + b2, bf16 in and out, fp32 sums.
//
// Replaces triad_tpu/ops/pallas_mlp.py:_fwd (:174, pallas_call :180, body
// _fwd_kernel :88) and _bwd_call (:197, pallas_call :204, body _bwd_kernel
// :114). Weights take torch's Linear layout: w1 (Dh, Din), w2 (Dout, Dh).
//
// What bounds it on the card: operations. At HuBERT's training shape
// (64 x 499 = 31936 rows, 768 -> 3072 -> 768) the forward is two products
// of 150.7 GFLOP, 0.30 ms at the 989 TFLOP/s bf16 peak, and the backward
// three, 0.46 ms, against 0.03-0.05 ms for the bytes of the function.
//
// The TPU kernel keeps a whole (T, 3072) hidden tile in ~100 MB of VMEM,
// so h and g never leave the core. A Hopper SM holds 227 KB: a 128-row
// block cannot keep its 128 x 768 fp32 output beside its hidden band, and
// walking Dh in narrow chunks (the WMMA kernels this file held before) makes
// every row block re-stream all of W1 and W2 from L2 (~32 FLOP a byte,
// L2-bound at 47-61 TFLOP/s). So each product is a GEMM of its own, and the
// hidden activation g goes through device memory in bf16, the rounding the
// TPU kernel applies before its second product anyway (the values are
// the same): 2 x 31936 x 3072 x 2 bytes, ~0.12 ms at 3.35 TB/s.
//
// mlp_gemm_kernel is conv_s2.cuh's design on plain row-major operands:
//   - persistent: one block per SM walks BM x BN output tiles (tile t,
//     t + grid, ...; the column tiles of a BM-row band are neighbours, so
//     the band is read from device memory once). BN is 256, 128 or 64
//     (at most 128 for the GELU and dual epilogues), picked per call as
//     the widest whose grid still fills the SMs (pick_bn);
//   - warp-specialised: one thread of a producer warpgroup keeps a ring of
//     64-deep slices (A BM x 64 and B BN x 64; 3 to 8 stages, as many as
//     the staged outputs leave room for) filled by TMA copies (128-byte
//     swizzle, zero fill past the last row and column), signalling a
//     "full" mbarrier per stage; two consumer warpgroups (three in GEMM 1;
//     64 of the BM rows each, BN / 2 fp32 accumulators a thread) run
//     m64nBNk16 wgmma from shared memory and release a stage on its
//     "empty" mbarrier once the products that read it retired, one wgmma
//     group in flight; no block barrier after the start;
//   - the epilogue maps the accumulator registers to bf16 values in a
//     staged copy of the warpgroup's 64 x BN output in shared memory
//     (TMA's swizzled layout), which one thread stores by TMA while the
//     warpgroup goes on to its next tile. Stored from the registers
//     straight to device memory (4 bytes a thread, 8 rows a warp), a plain
//     epilogue (bias and rounding only) cost the forward 0.24 ms on an
//     H100 80GB HBM3 at 700 W; staged, 0.04.
// Each output element is one accumulator of one thread summed in K order:
// no atomics and no split of K, so calls repeat bit for bit.
//
// What holds it back (the same card, (64 x 499, 768), tanh, p = 0.1;
// tools/kernel_probe.py fused_mlp; two consumer warpgroups in GEMM 1): the
// products alone took 0.43 ms of the forward's 0.72 and 0.69 of the
// backward's 1.00. The rest is the epilogues' arithmetic (GELU, GELU', the
// Philox rounds), which the consumer warpgroups run between tiles, with
// the tensor cores idle, bound by its latency.
//
// Forward: GEMM 1 g = bf16(dropout(gelu(x W1^T + b1))) into a transient
// (M, Dh) buffer the wrapper allocates; GEMM 2 y = bf16(g W2^T + b2). The
// forward saves neither g nor h: the backward recomputes them, as the JAX
// VJP does.
// Backward: kernel 1 is a dual-accumulator GEMM over (M, Dh) tiles: h = x
// W1^T (K = Din) into one accumulator, then dg = dy W2 (K = Dout) into a
// second, so h and dg meet in registers (an h written in bf16 would add a
// rounding the TPU kernel does not have); its epilogue replays the keep
// mask and writes dh = bf16(keep dg gelu'(h)) and the dropped g, both for
// the weight gradients. Kernel 2: dx = dh W1, GEMM 2's code with no bias.
// dy W2 and dh W1 contract over the weights' rows, so the wrapper passes
// W2^T and W1^T (one transpose each a call, 0.04 ms together at 768 x
// 3072 on that card) and every operand is K-major.
//
// Activation dropout: the keep bit of (row, hidden unit c) is
// triad::keep4(seed, 0, offset + row, c / 4) word c % 4 (offset = b0 * N,
// b0 the global index of the first batch row), a kept value times
// 1 / (1 - p) in fp32, whatever the tiling. A thread's accumulator holds
// column pairs (c, c + 1) at rows r and r + 8; lanes 2i and 2i + 1 hold the
// two halves of one group of four columns. The even lane draws the group
// at row r, the odd lane at row r + 8, and one shuffle swaps the halves:
// one Philox draw per four elements.
#include "hopper.cuh"

namespace {

using namespace triad::hopper;
using triad::bf16;

constexpr int BK = 64;
constexpr int PRODUCER_REGS = 40;
constexpr int SMEM_MAX = 232448;                // a block's dynamic shared memory
constexpr int BOX = 64;                         // staged output boxes: 64 x 64 bf16
constexpr int BOX_BYTES = BOX * BOX * 2;

// What a tile's fp32 sums become.
enum Epilogue {
  EPI_GELU = 0,    // forward GEMM 1: g = bf16(dropout(gelu(acc + b1)))
  EPI_LINEAR = 1,  // forward GEMM 2 (acc + b2) and backward dx (acc): bf16
  EPI_DGELU = 2,   // backward kernel 1: dh = bf16(keep dg gelu'(h)) and g
};

// Consumer warpgroups (64 output rows each) of GEMM 1's blocks: three, so
// 192-row tiles. Its epilogue's GELU and Philox arithmetic is bound by its
// latency, and a third warpgroup adds warps to hide it (the forward 0.72
// -> 0.65 ms at 64 x 499 rows on an H100 80GB HBM3, kernel_probe.py
// fused_mlp). The other kernels hold 128 accumulators a thread (BN 256, or
// the dual kernel's two), more than the 152 registers a thread that four
// warpgroups leave.
constexpr int GELU_CONSUMERS = 3;

// A block of MODE: its consumer warpgroups, their BM rows, its threads (+
// the producer warpgroup) and the registers a consumer thread takes after
// setmaxnreg (what the block's 65536 leave beside the producer's 40).
template <int MODE>
struct Block {
  static constexpr int CONSUMERS = MODE == EPI_GELU ? GELU_CONSUMERS : 2;
  static constexpr int BM = 64 * CONSUMERS;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int CONSUMER_REGS = CONSUMERS == 2 ? 232 : 152;
};

// Shared memory: the ring of A and B slices, then each consumer
// warpgroup's staged outputs (64 x BN bf16 per output), then the ring's
// mbarriers; as many stages (at most 8) as the rest leaves room for.
template <int BN, int MODE>
struct Layout {
  static constexpr int OUTS = MODE == EPI_DGELU ? 2 : 1;
  static constexpr int A_BYTES = Block<MODE>::BM * BK * 2, B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGED_BYTES = 64 * BN * 2;  // one output of one warpgroup
  static constexpr int EPI_BYTES = Block<MODE>::CONSUMERS * OUTS * STAGED_BYTES;
  static constexpr int FIT = (SMEM_MAX - 1024 - EPI_BYTES) / (STAGE_BYTES + 16);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;  // BN 256: 3; 128: 4-6; 64: 6-8
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr size_t SMEM = (size_t)RING + EPI_BYTES + 2 * STAGES * 8 + 1024;
};

struct Params {
  const bf16* bias;  // (n), or null for none (EPI_LINEAR)
  int m, n;
  int kb0, kb1;  // 64-deep slices of the first product and (EPI_DGELU) the second
  int ntiles, tiles;
  int tanh_form;
  triad::Dropout dp;
};

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 256)
    wgmma_m64n256k16(d, da, db, acc);
  else if constexpr (BN == 128)
    wgmma_m64n128k16(d, da, db, acc);
  else
    wgmma_m64n64k16(d, da, db, acc);
}

// The keep words of a thread's elements (row, c), (row, c + 1), (row + 8,
// c), (row + 8, c + 1), c even: the pair of lanes draws the two rows' groups
// of four and swaps halves. Every lane of the warp must call it.
__device__ __forceinline__ void keep_words(const triad::Dropout& dp, int row, int c, int lane,
                                           uint32_t (&w)[4]) {
  const bool odd = lane & 1;
  const triad::Keep4 kb =
      triad::keep4(dp.seed, 0u, dp.offset + (uint32_t)(row + (odd ? 8 : 0)), (uint32_t)c >> 2);
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? kb.w[0] : kb.w[2], 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? kb.w[1] : kb.w[3], 1);
  w[0] = odd ? r0 : kb.w[0];
  w[1] = odd ? r1 : kb.w[1];
  w[2] = odd ? kb.w[2] : r0;
  w[3] = odd ? kb.w[3] : r1;
}

// Puts bf16(a), bf16(b) at (r, c), (r, c + 1) of a warpgroup's staged 64 x
// BN output: 64-column boxes of 64 rows of 128 bytes in TMA's 128-byte
// swizzle (the 16-byte chunk of column c in row r is chunk c / 8 ^ r % 8),
// so a warp's stores of one column block hit every bank once.
__device__ __forceinline__ void stage_pair(unsigned char* staged, int r, int c, float a, float b) {
  const int cb = c & (BOX - 1);
  *reinterpret_cast<__nv_bfloat162*>(staged + (c / BOX) * BOX_BYTES + r * 128 +
                                     ((cb >> 3) ^ (r & 7)) * 16 + (cb & 7) * 2) =
      __floats2bfloat162_rn(a, b);
}

// Element (j, e) of a thread's accumulator is row r = 16 (t / 32) + (t %
// 32) / 4 + 8 (e / 2) of the warpgroup's 64, column 8 j + 2 (t % 4) + e % 2
// of the tile. TANH: the GELU form, fixed per instantiation so a loop holds
// one form's code. Writes the warpgroup's staged outputs (staged[1]: g,
// EPI_DGELU).
template <int BN, int MODE, bool TANH, int N1>
__device__ __forceinline__ void epilogue(const float (&d0)[BN / 2], const float (&d1)[N1],
                                         const Params& p, unsigned char* const (&staged)[2],
                                         int m0, int n0, int t) {
  const int lane = t & 31, r = (t >> 5) * 16 + (lane >> 2);
  const int row = m0 + r;  // of the output: the keep mask's row
  const bool drop = MODE != EPI_LINEAR && p.dp.active;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    uint32_t kw[4] = {0u, 0u, 0u, 0u};
    if (drop) keep_words(p.dp, row, n0 + c, lane, kw);
    float v[4] = {d0[4 * j], d0[4 * j + 1], d0[4 * j + 2], d0[4 * j + 3]};
    if (p.bias != nullptr && n0 + c < p.n) {
      const float2 b =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bias + n0 + c));
      v[0] += b.x;
      v[1] += b.y;
      v[2] += b.x;
      v[3] += b.y;
    }
    if constexpr (MODE == EPI_GELU) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = TANH ? triad::gelu_tanh(v[e]) : triad::gelu_erf(v[e]);
        if (drop) v[e] = kw[e] >= p.dp.thresh ? v[e] * p.dp.scale : 0.0f;
      }
    }
    if constexpr (MODE == EPI_DGELU) {
      float g[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dg = d1[4 * j + e], grad;
        triad::gelu_and_grad<TANH>(v[e], &g[e], &grad);
        if (drop) {
          const bool keep = kw[e] >= p.dp.thresh;
          g[e] = keep ? g[e] * p.dp.scale : 0.0f;
          dg = keep ? dg * p.dp.scale : 0.0f;
        }
        v[e] = dg * grad;
      }
      stage_pair(staged[1], r, c, g[0], g[1]);
      stage_pair(staged[1], r + 8, c, g[2], g[3]);
    }
    stage_pair(staged[0], r, c, v[0], v[1]);
    stage_pair(staged[0], r + 8, c, v[2], v[3]);
  }
}

// A consumer warpgroup's epilogue of a tile in the call's GELU form: once
// its previous tile's TMA stores have read the staged outputs, it writes
// this tile's into them and thread 0 stores them by TMA (rows and columns
// past the output's are not written), which runs on while the warpgroup
// starts its next tile.
template <int BN, int MODE, int N1>
__device__ __forceinline__ void epilogue_any(const float (&d0)[BN / 2], const float (&d1)[N1],
                                             const Params& p, unsigned char* const (&staged)[2],
                                             const CUtensorMap* const (&out)[2], int m0, int n0,
                                             int wg, int t) {
  if (t == 0) bulk_wait_read<0>();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (MODE == EPI_LINEAR || p.tanh_form)
    epilogue<BN, MODE, true>(d0, d1, p, staged, m0 + wg * 64, n0, t);
  else
    epilogue<BN, MODE, false>(d0, d1, p, staged, m0 + wg * 64, n0, t);
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (t == 0) {
#pragma unroll
    for (int o = 0; o < (MODE == EPI_DGELU ? 2 : 1); ++o)
#pragma unroll
      for (int b = 0; b < BN / BOX; ++b)
        tma_store_2d(out[o], staged[o] + b * BOX_BYTES, n0 + b * BOX, m0 + wg * 64);
    bulk_commit();
  }
}

// out (m, n) = epilogue(A0 B0^T [, A1 B1^T]) for row-major bf16 A (m, k)
// and B (n, k) brought in through the tensor maps map_a*, map_b* (boxes 64
// x 128 for A, 64 x BN for B); the outputs leave through map_o0 and
// (EPI_DGELU) map_o1 (boxes 64 x 64).
template <int BN, int MODE>
__global__ void __launch_bounds__(Block<MODE>::THREADS, 1)
mlp_gemm_kernel(const __grid_constant__ CUtensorMap map_a0,
                const __grid_constant__ CUtensorMap map_b0,
                const __grid_constant__ CUtensorMap map_a1,
                const __grid_constant__ CUtensorMap map_b1,
                const __grid_constant__ CUtensorMap map_o0,
                const __grid_constant__ CUtensorMap map_o1, const Params p) {
  using L = Layout<BN, MODE>;
  constexpr bool DUAL = MODE == EPI_DGELU;
  constexpr int CONSUMERS = Block<MODE>::CONSUMERS, BM = Block<MODE>::BM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::RING + L::EPI_BYTES);
  uint64_t* empty = full + L::STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one thread keeps the ring full, the tiles' slices in order.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (t == 0) {
      int stage = 0, phase = 0;
      const int kblocks = p.kb0 + (DUAL ? p.kb1 : 0);
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int n0 = (tile % p.ntiles) * BN, m0 = (tile / p.ntiles) * BM;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* dst = smem + stage * L::STAGE_BYTES;
          mbar_expect_tx(&full[stage], L::STAGE_BYTES);
          const bool second = DUAL && kb >= p.kb0;
          const int k = (second ? kb - p.kb0 : kb) * BK;
          tma_load_2d(dst, second ? &map_a1 : &map_a0, &full[stage], k, m0);
          tma_load_2d(dst + L::A_BYTES, second ? &map_b1 : &map_b0, &full[stage], k, n0);
          if (++stage == L::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns output rows 64 wg .. 64 wg + 63 of a tile.
    setmaxnreg_inc<Block<MODE>::CONSUMER_REGS>();
    unsigned char* const staged[2] = {smem + L::RING + wg * L::OUTS * L::STAGED_BYTES,
                                      smem + L::RING + (wg * L::OUTS + L::OUTS - 1) *
                                                          L::STAGED_BYTES};
    const CUtensorMap* const out[2] = {&map_o0, &map_o1};
    int stage = 0, phase = 0;
    float d0[BN / 2];
    float d1[DUAL ? BN / 2 : 1];
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int n0 = (tile % p.ntiles) * BN, m0 = (tile / p.ntiles) * BM;
      int prev = -1;
      auto products = [&](float (&d)[BN / 2], int kblocks) {
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&full[stage], phase);
          const bf16* a =
              reinterpret_cast<const bf16*>(smem + stage * L::STAGE_BYTES) + wg * 64 * BK;
          const bf16* b = reinterpret_cast<const bf16*>(smem + stage * L::STAGE_BYTES + L::A_BYTES);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < BK / 16; ++k)
            wgmma_ss<BN>(d, desc_sw128(a + k * 16), desc_sw128(b + k * 16), kb > 0 || k > 0);
          wgmma_commit();
          // one group in flight: the previous slice's products are done
          wgmma_wait<1>();
          if (prev >= 0 && t == 0) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == L::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      };
      products(d0, p.kb0);
      if constexpr (DUAL) products(d1, p.kb1);
      wgmma_wait<0>();
      if (t == 0) mbar_arrive(&empty[prev]);
      epilogue_any<BN, MODE>(d0, d1, p, staged, out, m0, n0, wg, t);
    }
    if (t == 0) bulk_wait<0>();  // the last stores out of shared memory
  }
}

// ------------------------------------------------------------------ host

// A row-major bf16 (rows, k) tensor, boxes of 64 columns x box_rows.
bool map2d(CUtensorMap* map, const void* base, int rows, int k, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {2ull * k};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  return encode(map, base, 2, dims, strides, box);
}

// The tensors of one launch: A0 (m, k0) with B0 (n, k0), for EPI_DGELU A1
// (m, k1) with B1 (n, k1); the outputs out0 and (EPI_DGELU) out1, (m, n).
struct Operands {
  const void *a0, *b0, *a1, *b1;
  int k0, k1;
  void *out0, *out1;
};

// Sets the kernel's dynamic shared memory once per device and process,
// and refuses a build whose launch leaves the block fewer registers than
// its warpgroups ask for after setmaxnreg (setmaxnreg.inc would wait for
// them for ever).
template <int BN, int MODE>
cudaError_t prepare(int dev) {
  static bool done[MAX_DEVICES] = {};
  if (done[dev]) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mlp_gemm_kernel<BN, MODE>);
  if (err != cudaSuccess) return err;
  using K = Block<MODE>;
  if (attr.numRegs * K::THREADS < 128 * (PRODUCER_REGS + K::CONSUMERS * K::CONSUMER_REGS))
    return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(mlp_gemm_kernel<BN, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout<BN, MODE>::SMEM);
  done[dev] = err == cudaSuccess;
  return err;
}

template <int BN, int MODE>
int launch(const Operands& op, Params p, int dev, int sms, cudaStream_t stream) {
  static_assert(Layout<BN, MODE>::SMEM <= (size_t)SMEM_MAX, "shared memory");
  CUtensorMap a0, b0, a1, b1, o0, o1;
  constexpr int BM = Block<MODE>::BM;
  if (!map2d(&a0, op.a0, p.m, op.k0, BM) || !map2d(&b0, op.b0, p.n, op.k0, BN) ||
      !map2d(&o0, op.out0, p.m, p.n, BOX))
    return (int)cudaErrorInvalidValue;
  if (MODE == EPI_DGELU) {
    if (!map2d(&a1, op.a1, p.m, op.k1, BM) || !map2d(&b1, op.b1, p.n, op.k1, BN) ||
        !map2d(&o1, op.out1, p.m, p.n, BOX))
      return (int)cudaErrorInvalidValue;
  } else {
    a1 = a0;
    b1 = b0;
    o1 = o0;
  }
  p.kb0 = (op.k0 + BK - 1) / BK;
  p.kb1 = MODE == EPI_DGELU ? (op.k1 + BK - 1) / BK : 0;
  p.ntiles = (p.n + BN - 1) / BN;
  p.tiles = (p.m + BM - 1) / BM * p.ntiles;
  const cudaError_t err = prepare<BN, MODE>(dev);
  if (err != cudaSuccess) return (int)err;
  mlp_gemm_kernel<BN, MODE>
      <<<p.tiles < sms ? p.tiles : sms, Block<MODE>::THREADS, Layout<BN, MODE>::SMEM, stream>>>(
          a0, b0, a1, b1, o0, o1, p);
  return (int)cudaGetLastError();
}

// The widest tile (BN from `widest` down to 64) whose grid still fills the
// SMs. At 64 x 499 rows every GEMM takes its widest; serving's 8 x 261 =
// 2088 rows give forward GEMM 1 (n 3072, 192-row tiles) BN 128, 264 tiles,
// and GEMM 2 (n 768, 128-row tiles) BN 64, 204 tiles; 8 x 128 rows give BN
// 128, 144 tiles, and BN 64, 96 tiles.
int pick_bn(int m, int bm, int n, int sms, int widest) {
  const long long mt = (m + bm - 1) / bm;
  for (int bn = widest; bn > 64; bn /= 2)
    if (mt * ((n + bn - 1) / bn) >= sms) return bn;
  return 64;
}

// The widest tile of each epilogue. EPI_DGELU holds two accumulators a
// thread, so 64 x 128 each at most. The GELU epilogue is bound by the
// latency of its arithmetic (tanh or erf, the Philox rounds): at BN 128 the
// 64 accumulators a thread leave it the registers to overlap more of it
// and let a third consumer warpgroup in (kernel_probe.py fused_mlp,
// VARIANTS).
constexpr int WIDEST_GELU = 128, WIDEST_LINEAR = 256, WIDEST_DGELU = 128;

template <int MODE>
int run(const Operands& op, const Params& p, cudaStream_t stream) {
  int dev = 0;
  const cudaError_t err = bind_device(&dev);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(dev);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  constexpr int widest = MODE == EPI_GELU    ? WIDEST_GELU
                         : MODE == EPI_DGELU ? WIDEST_DGELU
                                             : WIDEST_LINEAR;
  const int bn = pick_bn(p.m, Block<MODE>::BM, p.n, sms, widest);
  if constexpr (widest >= 256)
    if (bn == 256) return launch<256, MODE>(op, p, dev, sms, stream);
  if constexpr (widest >= 128)
    if (bn == 128) return launch<128, MODE>(op, p, dev, sms, stream);
  return launch<64, MODE>(op, p, dev, sms, stream);
}

bool bad_shape(int m, int a, int b, int c) {
  return m <= 0 || a <= 0 || b <= 0 || c <= 0 || a % 8 || b % 8 || c % 8;
}

}  // namespace

// x (m, din), w1 (dh, din), b1 (dh), w2 (dout, dh), b2 (dout), y (m,
// dout), g (m, dh) scratch: contiguous bf16, 16-byte aligned; din, dh and
// dout multiples of 8. Dropout: keep iff bits >= thresh, kept values times
// keep_scale, none when active == 0. Two grids on one stream (GEMM 1 then
// GEMM 2). Returns a cudaError_t.
extern "C" int triad_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* y, void* g, int m, int din, int dh,
                               int dout, int tanh_form, unsigned seed, unsigned thresh,
                               float keep_scale, int active, unsigned offset,
                                   void* stream) {
  if (bad_shape(m, din, dh, dout)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const triad::Dropout dp{seed, thresh, keep_scale, active, offset};
  const Params p1{(const bf16*)b1, m, dh, 0, 0, 0, 0, tanh_form, dp};
  const int err = run<EPI_GELU>(Operands{x, w1, nullptr, nullptr, din, 0, g, nullptr}, p1, s);
  if (err != 0) return err;
  const Params p2{(const bf16*)b2, m, dout, 0, 0, 0, 0, tanh_form, dp};
  return run<EPI_LINEAR>(Operands{g, w2, nullptr, nullptr, dh, 0, y, nullptr}, p2, s);
}

// x (m, din), w1 (dh, din) and its transpose w1t (din, dh), b1 (dh), w2t
// (dh, dout) = w2^T, dy (m, dout); outputs dx (m, din), dh_out and g (m,
// dh): contiguous bf16, 16-byte aligned, widths multiples of 8; the
// dropout arguments are the forward's. Two grids on one stream (dh and g,
// then dx). Returns a cudaError_t.
extern "C" int triad_fused_mlp_bwd(const void* x, const void* w1, const void* w1t,
                                   const void* b1, const void* w2t, const void* dy, void* dx,
                                   void* dh_out, void* g_out, int m, int din, int dh, int dout,
                                   int tanh_form, unsigned seed, unsigned thresh,
                                   float keep_scale, int active, unsigned offset,
                                   void* stream) {
  if (bad_shape(m, din, dh, dout)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const triad::Dropout dp{seed, thresh, keep_scale, active, offset};
  const Params p1{(const bf16*)b1, m, dh, 0, 0, 0, 0, tanh_form, dp};
  const int err =
      run<EPI_DGELU>(Operands{x, w1, dy, w2t, din, dout, dh_out, g_out}, p1, s);
  if (err != 0) return err;
  const Params p2{nullptr, m, din, 0, 0, 0, 0, tanh_form, dp};
  return run<EPI_LINEAR>(Operands{dh_out, w1t, nullptr, nullptr, dh, 0, dx, nullptr}, p2, s);
}

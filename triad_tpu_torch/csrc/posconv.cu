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
// Forward (and dX), an implicit GEMM per (512-row piece, group, batch row):
//   out[t, o] = act(sum_k sum_i in[t - left + k, g*48 + i] * W[g][k][i][o]
//                   + bias[g*48 + o])
// on TMA + wgmma (hopper.cuh). The block's input window, 512 + K - 1 rows
// x 48 channels (61 KB at K = 128, zeros outside [0, N)), lands once by
// TMA as 6 planes of 8 channels: each row of a plane is 16 bytes, so 8
// consecutive rows form a wgmma core matrix (the no-swizzle layout) that
// may start at ANY row. A tap shifts the A rows by one, which the 128-byte
// swizzle (atoms of 8 rows) cannot follow; here the A operand of tap k for
// an output tile at row r is the plain descriptor of window row r + k
// (next 8 rows 128 bytes on, next 8 channels a plane on). The wrapper lays
// the weight out as the B operand wants, W[g][k][p][o][e] (input channel
// 8 p + e, ops/posconv.py:_kernel_weight), and one producer thread streams
// the group's 590 KB of taps once per 512 rows, 4 taps (18 KB) a stage by
// bulk copy, through a 6-stage mbarrier ring: 0.6 GB of L2 reads a call
// at (64, 499, 768), and no __syncthreads or cp.async in the tap loop. Two
// consumer warpgroups own four 64-row tiles each (96 fp32 sums a thread)
// and issue, per tap and 16 input channels, one wgmma m64n48k16 per tile
// (3 per tap), a stage's 48 products in flight while the next stage is
// awaited. The epilogue adds the bias in fp32, applies the activation
// (identity or exact GELU), rounds to bf16 once, stages each tile in
// shared memory and stores 16-byte row pieces in the (B, N, C) layout.
// Rows past N (the last piece's) are computed from zeros and not stored.
// Its outputs equal those of the WMMA kernel it replaced bit for bit at
// chip_smoke.py phase 3's shapes. tools/kernel_probe.py posconv_fwd times it against
// (b), the transposed products out^T = W^T . X^T (the 48 outputs padded to
// wgmma's M of 64, 256 rows as N; an edited copy of this file), 18%
// slower, and against the mma.sync dW kernel below, which runs the same
// products.
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
// 0.03 ms. A forward block's 64 x 48 products are narrow (n48): both
// operands come from shared memory, 3.5 KB per 49 K multiply-adds, about
// what the SM's shared memory delivers in the time its tensor cores take.
// It runs at 66% of the bound at (64, 499, 768), and no ring depth, stage
// width or epilogue moves it (the probe's variants). Every
// dW block reads its group's x and dz (6.1 MB at B = 64) through L2, 8
// times over the 8 tap blocks of a group.
#include "attention_tiles.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

using triad::bf16;

constexpr int CPG = 48;        // channels per group (768 / 16)
constexpr int NB = CPG / 16;   // 16-wide blocks of a group's channels
constexpr int KCH = 8;         // the kernels take K a multiple of this
constexpr int THREADS = 256;   // dW: 8 warps
constexpr int MAX_SMEM = 232448;
// Forward and dX
constexpr int PC_ROWS = 512;                       // output rows a block covers
constexpr int PC_CONS = 2;                         // consumer warpgroups
constexpr int PC_TILES = PC_ROWS / 64 / PC_CONS;   // 64-row tiles a consumer owns
constexpr int PC_PLANES = CPG / 8;                 // 8-channel planes of the window
constexpr int PC_BOX = 160;                        // window rows a TMA box holds (<= 256)
constexpr int PC_TAPS = 4;                         // taps a weight stage holds
constexpr int PC_STAGES = 6;
constexpr int PC_TAP_BYTES = CPG * CPG * 2;        // one tap's 48 x 48 bf16 block
constexpr int PC_STAGE_BYTES = PC_TAPS * PC_TAP_BYTES;
constexpr int PC_OUT = 64 * CPG;                   // bf16 elements of a staged output tile
constexpr int PC_THREADS = 128 * (PC_CONS + 1);    // + the producer warpgroup
static_assert(PC_STAGE_BYTES % 1024 == 0 && KCH % PC_TAPS == 0, "stages: whole taps, aligned");
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

// TMA boxes of the input window: 512 output rows read 512 + K - 1 rows.
__host__ __device__ inline int pc_boxes(int k) { return (PC_ROWS + k - 1 + PC_BOX - 1) / PC_BOX; }

// The ring [PC_STAGES][PC_TAPS][6 planes][48 outputs][8 inputs], the window
// [6 planes][pc_boxes(k) * PC_BOX rows][8 channels], the consumers' output
// tiles, the barriers; 1024 bytes for the alignment.
__host__ __device__ inline size_t pc_smem(int k) {
  return 1024 + (size_t)PC_STAGES * PC_STAGE_BYTES + (size_t)PC_PLANES * pc_boxes(k) * PC_BOX * 16 +
         (size_t)PC_CONS * PC_OUT * 2 + (1 + 2 * PC_STAGES) * 8;
}

__device__ __forceinline__ void pc_advance(int& stage, int& phase) {
  if (++stage == PC_STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// Block (512-row piece, group g, batch row b). Its producer thread copies
// the input window once (plane p: channels 48 g + 8 p .. + 7 of rows t0 -
// left .. t0 - left + 639, zeros outside [0, nin)), then streams the
// group's taps, 4 a stage. Consumer wg owns output rows 256 wg .. 256 wg +
// 255 of the piece, four 64-row tiles, 24 fp32 sums a thread each; per tap
// and 16 input channels one wgmma m64n48k16 a tile, A the window from row
// (tile row + tap), B the tap's block.
__global__ void __launch_bounds__(PC_THREADS, 1)
posconv_kernel(const __grid_constant__ CUtensorMap map_in, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out, int nout, int c, int k,
               int left, int act) {
  namespace hp = triad::hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int plane = pc_boxes(k) * PC_BOX;  // rows of a window plane
  bf16* ring = reinterpret_cast<bf16*>(base);
  bf16* win = reinterpret_cast<bf16*>(base + PC_STAGES * PC_STAGE_BYTES);
  bf16* staged = win + (size_t)PC_PLANES * plane * 8;
  uint64_t* win_full = reinterpret_cast<uint64_t*>(staged + PC_CONS * PC_OUT);
  uint64_t* full = win_full + 1;
  uint64_t* empty = full + PC_STAGES;
  const int t0 = blockIdx.x * PC_ROWS, g = blockIdx.y, b = blockIdx.z;
  const int nst = k / PC_TAPS;
  if (threadIdx.x == 0) {
    hp::mbar_init(win_full, 1);
    for (int i = 0; i < PC_STAGES; ++i) {
      hp::mbar_init(&full[i], 1);
      hp::mbar_init(&empty[i], PC_CONS);
    }
    hp::fence_mbarrier_init();
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0), t = threadIdx.x % 128;
  if (wg == PC_CONS) {
    if (t == 0) {
      hp::mbar_expect_tx(win_full, PC_PLANES * plane * 16);
      for (int p = 0; p < PC_PLANES; ++p)
        for (int r = 0; r < plane; r += PC_BOX)
          hp::tma_load_3d(win + ((size_t)p * plane + r) * 8, &map_in, win_full, g * CPG + 8 * p,
                          t0 - left + r, b);
      const bf16* src = w + (size_t)g * k * CPG * CPG;
      int stage = 0, phase = 0;
      for (int s = 0; s < nst; ++s) {
        hp::mbar_wait(&empty[stage], phase ^ 1);
        hp::mbar_expect_tx(&full[stage], PC_STAGE_BYTES);
        hp::bulk_load(ring + stage * (PC_STAGE_BYTES / 2), src + (size_t)s * PC_TAPS * CPG * CPG,
                      PC_STAGE_BYTES, &full[stage]);
        pc_advance(stage, phase);
      }
    }
    return;
  }
  const uint32_t win_a = hp::smem_u32(win), ring_a = hp::smem_u32(ring);
  const uint32_t plane_bytes = plane * 16;
  const int row0 = wg * PC_TILES * 64;  // the consumer's first row in the piece
  const int r = (t >> 5) * 16 + ((t & 31) >> 2), col = 2 * (t & 3);
  // The descriptors of one product: A or B from the window (window row w,
  // input channels 16 kk .. + 15: planes 2 kk, 2 kk + 1) and from the
  // stage's tap (its 48 outputs of the same inputs).
  auto window = [&](int w, int kk) {
    return hp::desc_plain(win_a + 2 * kk * plane_bytes + 16 * w, plane_bytes, 128);
  };
  auto taps = [&](int stage, int tap, int kk) {
    return hp::desc_plain(ring_a + stage * PC_STAGE_BYTES + tap * PC_TAP_BYTES +
                              kk * 2 * (CPG * 16), CPG * 16, 128);
  };
  auto activate = [&](float v) { return act ? triad::gelu_erf(v) : v; };
  // The staged 64-row tile tt to (B, N, C) in 16-byte row pieces.
  bf16* so = staged + wg * PC_OUT;
  auto store = [&](int tt) {
    hp::warpgroup_sync(wg);
    const int tr = t0 + row0 + tt * 64;
    for (int e = t; e < 64 * PC_PLANES; e += 128) {
      const int row = e / PC_PLANES, piece = e - row * PC_PLANES;
      if (tr + row < nout)
        *reinterpret_cast<uint4*>(out + ((long long)b * nout + tr + row) * c + g * CPG + 8 * piece) =
            *reinterpret_cast<const uint4*>(so + row * CPG + 8 * piece);
    }
    hp::warpgroup_sync(wg);
  };
  // Per stage: wait for it; per tap and 16 input channels, one product a
  // 64-row tile (A the window from row tile row + tap, B the tap's block,
  // 64 rows x 48 outputs, 24 sums a thread); release the previous stage
  // once its products retired.
  float acc[PC_TILES][24];
#pragma unroll
  for (int tt = 0; tt < PC_TILES; ++tt)
#pragma unroll
    for (int e = 0; e < 24; ++e) acc[tt][e] = 0.0f;
  int stage = 0, phase = 0, prev = 0;
  hp::mbar_wait(win_full, 0);
  for (int s = 0; s < nst; ++s) {
    hp::mbar_wait(&full[stage], phase);
#pragma unroll
    for (int tt = 0; tt < PC_TILES; ++tt) hp::fence_regs(acc[tt]);
    hp::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < PC_TAPS; ++tap)
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        const uint64_t db = taps(stage, tap, kk);
#pragma unroll
        for (int tt = 0; tt < PC_TILES; ++tt)
          hp::wgmma_m64n48k16(acc[tt], window(row0 + tt * 64 + s * PC_TAPS + tap, kk), db, 1);
      }
    hp::wgmma_commit();
    if (s > 0) {
      hp::wgmma_wait<1>();
      if (t == 0) hp::mbar_arrive(&empty[prev]);
    }
    prev = stage;
    pc_advance(stage, phase);
  }
  hp::wgmma_wait<0>();
#pragma unroll
  for (int tt = 0; tt < PC_TILES; ++tt) hp::fence_regs(acc[tt]);
  // Epilogue: bias and the activation in fp32, one rounding to bf16, the
  // tile staged in shared memory.
  float bv[2 * NB * 2];
#pragma unroll
  for (int jj = 0; jj < 2 * NB; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bv[2 * jj + e] = bias != nullptr ? bias[g * CPG + 8 * jj + col + e] : 0.0f;
#pragma unroll
  for (int tt = 0; tt < PC_TILES; ++tt) {
#pragma unroll
    for (int jj = 0; jj < 2 * NB; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(so + (r + 8 * h) * CPG + 8 * jj + col) =
            __floats2bfloat162_rn(activate(acc[tt][4 * jj + 2 * h] + bv[2 * jj]),
                                  activate(acc[tt][4 * jj + 2 * h + 1] + bv[2 * jj + 1]));
    store(tt);
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

// in (B, nin, c), out (B, nout, c): contiguous bf16, 16-byte aligned; w:
// bf16 (c / 48, k, 6, 48, 8), W[g][k][p][o][e] the weight of input channel
// 8 p + e to output channel o of tap k (ops/posconv.py:_kernel_weight);
// bias: fp32 (c) or null; act 0 = identity, 1 = exact GELU. c % 48 == 0,
// k % 8 == 0. Returns a cudaError_t.
extern "C" int triad_posconv(const void* in, const void* w, const void* bias, void* out,
                             int batch, int nin, int nout, int c, int k, int left, int act,
                             void* stream) {
  if (batch <= 0 || nin <= 0 || nout <= 0 || c % CPG || k % KCH || k <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = pc_smem(k);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = triad::hopper::bind_device(&dev);
  if (err != cudaSuccess) return (int)err;
  // (channel, row, batch row), innermost first; 8-channel boxes of PC_BOX rows
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)nin, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)c * sizeof(bf16), (cuuint64_t)nin * c * sizeof(bf16)};
  const cuuint32_t box[3] = {8, PC_BOX, 1};
  CUtensorMap map_in;
  if (!triad::hopper::encode(&map_in, in, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(posconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  posconv_kernel<<<dim3((nout + PC_ROWS - 1) / PC_ROWS, c / CPG, batch), PC_THREADS, smem,
                   (cudaStream_t)stream>>>(map_in, (const bf16*)w, (const float*)bias, (bf16*)out,
                                           nout, c, k, left, act);
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

// The stride-2 VALID conv GEMM of HuBERT's frontend (k taps over a
// row-major (T, cin) bf16 activation), shared by frontend.cu's conv +
// GELU-epilogue kernel and frontend_conv.cu's fused-prologue kernel. It
// replaces the GEMM inside triad_tpu/ops/pallas_frontend.py:
// monolithic_frontend (:471; _stride2_layer :208, pallas_call :569) and
// triad_tpu/ops/pallas_conv.py:_pallas_call (:177, pallas_call :195).
//
// What bounds it on the card: operations. At conv_1 of 10 s clips, (8,
// 31999, 512) -> (8, 15999, 512) with k = 3, it is 2.0e11 products-and-
// sums on bf16 tensor cores, 0.2036 ms at the 989 TFLOP/s peak, against
// 0.08 ms of bytes (the input read once, the output written once). The
// design is Hopper's GEMM: operands brought in by TMA, products by
// wgmma.mma_async, warp-specialised, persistent:
//   - one block per SM walks 128 x 256 output tiles (tile t, t + grid,
//     ...; the two 256-column halves of a 128-row band are neighbours, so
//     the band is read from device memory once and from L2 the second
//     time). Block = 2 consumer warpgroups (64 output rows each, a 64 x
//     256 fp32 accumulator in 128 registers a thread) + 1 producer
//     warpgroup, one thread of which starts the copies;
//   - a ring of 4 stages of 64-deep slices, A 128 x 64 and B 256 x 64 (48
//     KB a stage), each filled by two cp.async.bulk.tensor copies whose
//     bytes complete the stage's "full" mbarrier; the consumers release a
//     stage on its "empty" mbarrier once the wgmma that read it retired,
//     keeping one wgmma group in flight, so the copies of the next slices
//     (and the next tile's, during an epilogue) overlap the products;
//   - tiles land with TMA's 128-byte swizzle and are read by wgmma through
//     K-major shared-memory descriptors (m64n256k16, bf16 -> fp32).
// No im2col: window t covers input rows 2t .. 2t + k - 1, so depth d of
// the GEMM (tap j = d / cin, channel d % cin) is row 2t + j. Two 3-D
// tensor maps view the activation's even rows and its odd rows (row
// stride 2 cin, batch stride x_bs), each exactly the rows the windows
// read, so tap j of output rows m0 .. m0 + 127 is one box of map j % 2 at
// row m0 + j / 2; rows past the last one any window reads, and the rows of
// a ragged last tile past it, come in as TMA's zero fill and are never
// stored. B is the weight as (cout, k cin) row-major (K-major: for each
// output channel, tap-major then input channel).
// A prologue may rewrite each consumer's 64 staged A rows in shared memory
// before its products (the fused input activation): the channel of a
// 16-byte chunk is found through the swizzle, and a
// fence.proxy.async.shared::cta orders the rewrite before wgmma's reads.
// The epilogue maps each fp32 sum to the bf16 it stores, straight from the
// accumulator registers.
#pragma once

#include "hopper.cuh"

namespace triad {
namespace conv_s2 {

using namespace hopper;

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                  // warpgroups of 64 output rows
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + 1 KB to align

// The prologue that leaves the staged input as it is. A prologue gives
// the coefficients of 8 channels of a batch row (coef) and applies them to
// 8 fp32 values of those channels (apply).
struct NoPrologue {
  struct Coef {};
  __device__ bool active() const { return false; }
  __device__ Coef coef(int, int) const { return {}; }
  __device__ void apply(const Coef&, float (&)[8]) const {}
};

// What a launch needs besides the tensor maps.
struct Shape {
  bf16* y;    // (batch, tout, cout) bf16 out
  int cin, cout, tout, ktaps;
  int mtiles, ntiles, tiles;  // output tiles: rows, columns, all batches
};

template <class Prologue, class Epilogue>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_even, const __grid_constant__ CUtensorMap map_odd,
            const __grid_constant__ CUtensorMap map_w, const Shape sh, const Prologue prologue,
            const Epilogue epilogue) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int kblocks = sh.ktaps * sh.cin / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one thread keeps the ring full.
    setmaxnreg_dec<40>();
    if (t == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < sh.tiles; tile += gridDim.x) {
        const int n0 = (tile % sh.ntiles) * BN, rest = tile / sh.ntiles;
        const int m0 = (rest % sh.mtiles) * BM, b = rest / sh.mtiles;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* dst = smem + stage * STAGE_BYTES;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          const int tap = kb * BK / sh.cin, ch = kb * BK % sh.cin;
          tma_load_3d(dst, (tap & 1) ? &map_odd : &map_even, &full[stage], ch, m0 + tap / 2, b);
          tma_load_2d(dst + A_BYTES, &map_w, &full[stage], kb * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns output rows 64 wg .. 64 wg + 63 of a tile.
    setmaxnreg_inc<232>();
    int stage = 0, phase = 0;
    float d[128];
    for (int tile = blockIdx.x; tile < sh.tiles; tile += gridDim.x) {
      const int n0 = (tile % sh.ntiles) * BN, rest = tile / sh.ntiles;
      const int m0 = (rest % sh.mtiles) * BM, b = rest / sh.mtiles;
      int prev = -1;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[stage], phase);
        bf16* a = reinterpret_cast<bf16*>(smem + stage * STAGE_BYTES) + wg * 64 * BK;
        const bf16* w = reinterpret_cast<const bf16*>(smem + stage * STAGE_BYTES + A_BYTES);
        if (prologue.active()) {
          // Row r's 16-byte chunk c holds the channels of logical chunk c ^
          // (r & 7). Thread t rewrites chunk t % 8 of rows t / 8 + 16 i, so
          // its four chunks share r & 7 and hold the same 8 channels.
          const int r0 = t >> 3, c = t & 7;
          const auto coef = prologue.coef(b, kb * BK % sh.cin + ((c ^ (r0 & 7)) << 3));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + 16 * i;
            uint4* p = reinterpret_cast<uint4*>(a + r * BK + c * 8);
            uint4 raw = *p;
            __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
            float f[8];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 x = __bfloat1622float2(h2[e]);
              f[2 * e] = x.x;
              f[2 * e + 1] = x.y;
            }
            prologue.apply(coef, f);
#pragma unroll
            for (int e = 0; e < 4; ++e) h2[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
            *p = raw;
          }
          fence_proxy_async();
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        }
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          wgmma_m64n256k16(d, desc_sw128(a + k * 16), desc_sw128(w + k * 16), kb > 0 || k > 0);
        wgmma_commit();
        // one group in flight: the previous slice's products are done
        wgmma_wait<1>();
        if (prev >= 0 && t == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (t == 0) mbar_arrive(&empty[prev]);

      // Epilogue from the accumulator: element (j, e) of thread t is row
      // 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.
      const int row = m0 + wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
      bf16* yb = sh.y + ((long long)b * sh.tout) * sh.cout + n0 + 2 * (t & 3);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (row < sh.tout) {
          __nv_bfloat162 o;
          o.x = epilogue(d[4 * j]);
          o.y = epilogue(d[4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(yb + (long long)row * sh.cout + 8 * j) = o;
        }
        if (row + 8 < sh.tout) {
          __nv_bfloat162 o;
          o.x = epilogue(d[4 * j + 2]);
          o.y = epilogue(d[4 * j + 3]);
          *reinterpret_cast<__nv_bfloat162*>(yb + (long long)(row + 8) * sh.cout + 8 * j) = o;
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host

// Lets gemm_kernel<Prologue, Epilogue> take SMEM bytes of dynamic shared
// memory: set once per device and process.
template <class Prologue, class Epilogue>
cudaError_t allow_smem(int dev) {
  static bool done[MAX_DEVICES] = {};
  if (done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<Prologue, Epilogue>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  done[dev] = err == cudaSuccess;
  return err;
}

// y (batch, tout, cout) = epilogue(conv_s2(prologue(x), w)) for x (batch,
// >= 2 (tout - 1) + ktaps, cin) bf16 with unit channel stride, row stride
// cin and batch stride x_bs; w (cout, ktaps cin) bf16 row-major. cin a
// multiple of 64, cout of 256, x_bs of 8; x, w, y 16-byte aligned.
// Returns a cudaError_t.
template <class Prologue, class Epilogue>
int launch(const bf16* x, long long x_bs, int cin, const bf16* w, int cout, bf16* y, int batch,
           int tout, int ktaps, const Prologue& prologue, const Epilogue& epilogue,
           cudaStream_t stream) {
  if (batch <= 0 || tout <= 0 || ktaps < 1 || cin <= 0 || cin % BK || cout <= 0 || cout % BN ||
      x_bs % 8)
    return (int)cudaErrorInvalidValue;
  // rows 0 .. rows - 1 are all any window reads: ceil(rows / 2) even ones
  const long long rows = 2LL * (tout - 1) + ktaps;
  CUtensorMap even, odd, wmap;
  const cuuint64_t row_bytes = 4ull * cin, batch_bytes = 2ull * x_bs;
  const cuuint64_t dims_e[3] = {(cuuint64_t)cin, (cuuint64_t)((rows + 1) / 2), (cuuint64_t)batch};
  const cuuint64_t dims_o[3] = {(cuuint64_t)cin, (cuuint64_t)(rows / 2), (cuuint64_t)batch};
  const cuuint64_t strides_x[2] = {row_bytes, batch_bytes};
  const cuuint32_t box_x[3] = {BK, BM, 1};
  const cuuint64_t dims_w[2] = {(cuuint64_t)ktaps * cin, (cuuint64_t)cout};
  const cuuint64_t strides_w[1] = {2ull * ktaps * cin};
  const cuuint32_t box_w[2] = {BK, BN};
  if (!encode(&even, x, 3, dims_e, strides_x, box_x) ||
      (rows > 1 && !encode(&odd, x + cin, 3, dims_o, strides_x, box_x)) ||
      !encode(&wmap, w, 2, dims_w, strides_w, box_w))
    return (int)cudaErrorInvalidValue;
  if (rows <= 1) odd = even;  // ktaps == 1: no odd rows are read
  const int mtiles = (tout + BM - 1) / BM, ntiles = cout / BN;
  const Shape sh{y, cin, cout, tout, ktaps, mtiles, ntiles, batch * mtiles * ntiles};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  const int sms = sm_count(dev);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const cudaError_t err = allow_smem<Prologue, Epilogue>(dev);
  if (err != cudaSuccess) return (int)err;
  gemm_kernel<Prologue, Epilogue><<<sh.tiles < sms ? sh.tiles : sms, THREADS, SMEM, stream>>>(
      even, odd, wmap, sh, prologue, epilogue);
  return (int)cudaGetLastError();
}

}  // namespace conv_s2
}  // namespace triad

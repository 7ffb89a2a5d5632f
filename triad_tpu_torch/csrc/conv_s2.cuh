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

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

namespace triad {
namespace conv_s2 {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// never completes (a copy that faulted) traps after ~2^28 tries instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A K-major wgmma operand descriptor of a tile of 128-byte rows written by
// TMA with the 128-byte swizzle (1024-byte aligned): stride between
// 8-row groups 1024 bytes, layout SWIZZLE_128B. A k16 step within the
// 64-element rows advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 256 fp32 of a warpgroup) (+)= A (64 x 16) . B (256 x 16)^T.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "
      "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
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
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up in the library the CUDA
// runtime has already loaded (no -lcuda at link time).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return reinterpret_cast<EncodeTiled>(lib ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr);
  }();
  return fn;
}

// A bf16 tensor map of rank 2 or 3 with the 128-byte swizzle; dims and
// box innermost first, strides (bytes) of dims 1 .. rank - 1.
inline bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                  strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEVICES = 64;

// The current device's SM count, read once per device and process.
inline int sm_count(int dev) {
  static int count[MAX_DEVICES] = {};
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 0;
  return count[dev];
}

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

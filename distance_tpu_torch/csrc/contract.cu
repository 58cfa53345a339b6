// Counter contraction over prebuilt features for Hopper (sm_90a): an int8
// GEMM on the tensor cores, and the exact integer mix of a shared plan.
//
// Replaces the JAX package's distance_tpu/ops/pairwise_xla.py::
// contract_features (the engine's cached-feature block, _jit_block_fn_feat):
// fx (R, m, len) and gy (R, n, len) int8 features, built once per matrix or
// strip (csrc/features.cu), -> out (P, m, n) int32, exact.  Plane p is the
// sum over channels k in bounds[p]..bounds[p+1]-1 and all sites of
// fx[k] * gy[k], divided exactly by den[p]: a per-counter plan has one
// plane a counter (its channel slice), a shared plan (k80, tn93) one plane
// a channel, whose counters the second entry mixes,
// counter[g] = sum_k mix[g][k] plane[k] / den[g] (every numerator even).
// Zero features add nothing, so ragged rows and sites are masked by
// loading zeros: any m, n >= 0 and any len >= 0 that is a multiple of 16.
//
// Bound.  Operations: 2 m n len R int8 operations at 1,979 TOP/s; at the
// main path's 2048 x 2048 x 29952 block the bytes (features in once,
// counters out once) are under a fifth of that.  What may bound it instead
// is the feature bytes that flow from L2 into the SMs: a 128 x 256 tile
// reads (128 + 256) bytes a site and channel for 128 x 256 MACs, R times
// the code bytes csrc/counters.cu reads.
//
// Design.  csrc/counters.cu's machinery without its feature build: one CTA
// computes one plane of one 128 x 256 pair tile, as a GEMM with K = the
// plane's channels x all sites.  x row tiles go on grid.x (up to 2^31 - 1
// blocks), y row tiles on grid.y (65535 blocks of 256 rows), planes on
// grid.z, the plane with the most channels first.
// - Warp specialisation, 384 threads: warpgroups 0-1 are consumers (each
//   one m64n256 s32 accumulator, 128 registers a thread), warpgroup 2 the
//   producer (setmaxnreg moves registers to the consumers).
// - A ring of NST stages, each the x features (128 rows) and y features
//   (256 rows) of one channel and KC = 128 sites: one TMA box a side, rows
//   of 128 bytes (a whole cache line each) in the 128-byte swizzle that
//   wgmma reads K-major (8-row atoms of 1024 bytes).  One producer thread
//   issues a stage's two boxes (cp.async.bulk.tensor through tensor maps
//   of the two sides, whose zero fill past the last row or site masks the
//   ragged edges) with the stage's byte count on its `full` mbarrier, as
//   soon as the consumers have released the stage; K-steps run over
//   (channel of the plane) x (128-site chunks).  16-byte cp.async from
//   128 threads, or boxes of 16 sites (half a 32-byte sector a row), fed
//   the tensor cores at a fifth of their rate (scripts/k6_variants.py).
// - Both operands from shared memory by descriptor: each consumer
//   warpgroup issues two wgmma.mma_async m64n256k32 .s32.s8.s8 a stage on
//   its 64 x rows, keeps one stage's products in flight, and releases the
//   stage before (`empty` mbarrier) once those are done.
// - Epilogue: divide by den[p] exactly (a shift, then the odd part's
//   inverse mod 2^32) and store int32, as csrc/counters.cu does.
// Every offset into a feature tensor is 64-bit: a g cache of 18 channels
// at 8192 x 29952 is 4.4 GB.

#include <cuda.h>  // the tensor map's types; nothing links libcuda
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;                     // x rows per CTA (2 x m64)
constexpr int BN = 256;                     // y rows per CTA (n256)
constexpr int KC = 128;                     // sites per stage: a 128 B row
constexpr int KSTEP = 32;                   // sites (int8 K) per wgmma
constexpr int NST = 4;                      // ring stages
constexpr int A_STAGE = BM * KC;            // bytes of the x box
constexpr int STAGE = (BM + BN) * KC;
constexpr int CONSUMER = 256;               // two warpgroups
constexpr int PRODUCER = 128;               // one warpgroup
constexpr int THREADS = CONSUMER + PRODUCER;
constexpr int MAX_PLANES = 32;
constexpr int MAX_G = 4;
// the ring's stages 1024-byte aligned for the swizzle atoms, then the
// mbarriers
constexpr size_t SMEM = (size_t)NST * STAGE + 2 * NST * sizeof(uint64_t)
                        + 1024;
// Row bounds of one launch: every row index i0 + BM - 1 stays an int.
constexpr long long MAX_M = 0x7fffffffLL - BM;
constexpr long long MAX_N = 65535LL * BN;
constexpr int MIX_THREADS = 256;

static_assert(KC == 128 && A_STAGE % 1024 == 0 && STAGE % 1024 == 0,
              "128-byte swizzled rows in whole atoms");
static_assert(SMEM <= 232448, "shared memory of one CTA");

struct Params {
  CUtensorMap fx_map;  // fx as (channels, m, len), boxes of 128 x 128 rows
  CUtensorMap gy_map;  // gy as (channels, n, len), boxes of 128 x 256 rows
  long long len;
  int m, n, planes;
  int bounds[MAX_PLANES + 1];  // plane p contracts bounds[p]..bounds[p+1]-1
  int order[MAX_PLANES];       // plane of grid.z: the most channels first
  int den_shift[MAX_PLANES];     // den[p] = 2^den_shift[p] * odd, and
  uint32_t den_inv[MAX_PLANES];  // odd * den_inv[p] = 1 mod 2^32
  int32_t* out;
};

struct MixParams {
  const int32_t* o;
  long long count;  // m n: cells of a plane
  int planes, counters;
  int num[MAX_G][MAX_PLANES];
  int den_shift[MAX_G];
  uint32_t den_inv[MAX_G];
  int32_t* out;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One box of a tensor map at (site, row, channel) into shared memory; its
// bytes complete the transaction count of the mbarrier `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int site, int row, int channel,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(site), "r"(row),
         "r"(channel), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle, K-major: rows of 128
// bytes, atoms of 8 rows (1024 bytes, SBO) from a 1024-aligned base; a
// k-step of 32 sites starts 32 bytes into the row.
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define D8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),        \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 256 s32, this warpgroup's fragment) += A (64 x 32 s8) B^T
// (256 x 32 s8), both read from shared memory.
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "l"(a), "l"(b), "r"(1));
}

#undef D8

__global__ void __launch_bounds__(THREADS, 1)
contract_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring_s = (smem_addr(smem) + 1023) & ~1023u;  // [NST][STAGE]
  const uint32_t full_s = ring_s + NST * STAGE;      // [NST] mbarriers
  const uint32_t empty_s = full_s + NST * 8;         // [NST] mbarriers

  const int plane = p.order[blockIdx.z];
  const int i0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;
  const int k0 = p.bounds[plane];
  const int chunks = (int)((p.len + KC - 1) / KC);
  const int steps = (p.bounds[plane + 1] - k0) * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full_s + 8 * s, 1);  // the producer thread, with the bytes
      mbar_init(empty_s + 8 * s, CONSUMER / 32);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER) {
    // Producer: one thread issues each stage's boxes once it is free.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 120;\n");
    if (threadIdx.x == CONSUMER) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % NST;
        if (it >= NST) mbar_wait(empty_s + 8 * s, ((it / NST) - 1) & 1);
        const int k = k0 + it / chunks;
        const int site = (it % chunks) * KC;
        const uint32_t stage = ring_s + s * STAGE;
        const uint32_t bar = full_s + 8 * s;
        mbar_expect(bar, STAGE);
        tma_box(stage, &p.fx_map, site, i0, k, bar);
        tma_box(stage + A_STAGE, &p.gy_map, site, j0, k, bar);
      }
    }
  } else {
    // Consumers: wgmma on each full stage, then the epilogue.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 192;\n");
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    int d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    for (int it = 0; it < steps; ++it) {
      const int s = it % NST;
      mbar_wait(full_s + 8 * s, (it / NST) & 1);
      const uint32_t a = ring_s + s * STAGE + wg * 64 * KC;
      const uint32_t b = ring_s + s * STAGE + A_STAGE;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < KC / KSTEP; ++ks)
        wgmma_m64n256k32(d, desc(a + ks * KSTEP), desc(b + ks * KSTEP));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the stage before is done: give it back to the producer
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (it > 0 && lane == 0) mbar_arrive(empty_s + 8 * ((it - 1) % NST));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i]) :: "memory");

    // Fragment: d[4c + 2h + e] is row 16 warp + lane / 4 + 8 h, column
    // 8 c + 2 (lane % 4) + e of this warpgroup's 64 x 256 tile.
    const int row0 = i0 + wg * 64 + warp * 16 + lane / 4;
    const int col0 = j0 + 2 * (lane % 4);
    const int shift = p.den_shift[plane];
    const uint32_t inv = p.den_inv[plane];
    int32_t* out = p.out + (long long)plane * p.m * p.n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= p.m) continue;
      int32_t* orow = out + (long long)row * p.n;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * c + e;
          if (col < p.n)
            orow[col] = (int)((uint32_t)(d[4 * c + 2 * h + e] >> shift) * inv);
        }
      }
    }
  }
}

// counter[g] = sum_k num[g][k] o[k] / den[g], four cells a thread where the
// planes' cell counts allow 16-byte accesses.
template <bool VEC>
__global__ void __launch_bounds__(MIX_THREADS)
mix_kernel(const __grid_constant__ MixParams p) {
  const long long step = VEC ? 4 : 1;
  const long long items = VEC ? p.count / 4 : p.count;
  for (long long it = (long long)blockIdx.x * MIX_THREADS + threadIdx.x;
       it < items; it += (long long)gridDim.x * MIX_THREADS) {
    const long long cell = it * step;
    int4 acc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[g] = make_int4(0, 0, 0, 0);
    for (int k = 0; k < p.planes; ++k) {
      const int32_t* src = p.o + (long long)k * p.count + cell;
      const int4 v = VEC ? *reinterpret_cast<const int4*>(src)
                         : make_int4(*src, 0, 0, 0);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        const int w = p.num[g][k];  // 0 past the plan's counters
        acc[g].x += w * v.x;
        acc[g].y += w * v.y;
        acc[g].z += w * v.z;
        acc[g].w += w * v.w;
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= p.counters) break;
      const int s = p.den_shift[g];
      const uint32_t inv = p.den_inv[g];
      const int4 c = make_int4((int)((uint32_t)(acc[g].x >> s) * inv),
                               (int)((uint32_t)(acc[g].y >> s) * inv),
                               (int)((uint32_t)(acc[g].z >> s) * inv),
                               (int)((uint32_t)(acc[g].w >> s) * inv));
      int32_t* dst = p.out + (long long)g * p.count + cell;
      if (VEC)
        *reinterpret_cast<int4*>(dst) = c;
      else
        *dst = c.x;
    }
  }
}

// den = 2^shift odd; inv = odd^-1 mod 2^32 (Newton: each step doubles the
// correct low bits).
bool exact_divisor(int den, int& shift, uint32_t& inv) {
  if (den <= 0) return false;
  uint32_t odd = (uint32_t)den;
  shift = 0;
  for (; !(odd & 1); odd >>= 1) ++shift;
  inv = odd;
  for (int i = 0; i < 5; ++i) inv *= 2 - odd * inv;
  return true;
}

// cuTensorMapEncodeTiled, found through the runtime so that nothing links
// libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The tensor map of one side, (channels, rows, len) int8 at channel stride
// `ld_channel` and row stride `ld_row` bytes, in boxes of KC sites x
// `box_rows` rows of one channel, 128-byte swizzled; reads past the last
// row or site give 0.
bool side_map(CUtensorMap* map, const void* base, long long channels,
              long long rows, long long len, long long ld_channel,
              long long ld_row, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)len, (cuuint64_t)rows,
                              (cuuint64_t)channels};
  const cuuint64_t strides[2] = {(cuuint64_t)ld_row, (cuuint64_t)ld_channel};
  const cuuint32_t box[3] = {KC, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Planes of every (x, y) pair: fx (channels, m, len) and gy (channels, n,
// len) int8 with channel strides sfx/sgy and row strides ldx/ldy (len a
// multiple of 16; unless len is 0, the strides and both addresses too),
// out (planes, m, n) int32, all on the device.  bounds (planes + 1) and den
// (planes) are host int arrays.  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take (among them m > MAX_M and n > MAX_N, and features whose
// tensor map cuTensorMapEncodeTiled refuses).
extern "C" int dt_contract_launch(const void* fx, const void* gy, long long m,
                                  long long n, long long len, long long sfx,
                                  long long ldx, long long sgy, long long ldy,
                                  int planes, const void* bounds,
                                  const void* den, void* out, void* stream) {
  if (m < 0 || n < 0 || len < 0 || m > MAX_M || n > MAX_N || planes < 1 ||
      planes > MAX_PLANES || len % 16)
    return (int)cudaErrorInvalidValue;
  if (len > 0 && (ldx % 16 || ldy % 16 || sfx % 16 || sgy % 16 ||
                  ldx < len || ldy < len || (uintptr_t)fx % 16 ||
                  (uintptr_t)gy % 16))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int* b = static_cast<const int*>(bounds);
  const int* dn = static_cast<const int*>(den);
  if (b[0] != 0 || b[planes] > MAX_PLANES) return (int)cudaErrorInvalidValue;
  for (int z = 0; z <= planes; ++z) p.bounds[z] = b[z];
  for (int z = 0; z < planes; ++z)
    if (b[z + 1] <= b[z] || !exact_divisor(dn[z], p.den_shift[z],
                                           p.den_inv[z]))
      return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return (int)cudaSuccess;
  if (len > 0 && !(side_map(&p.fx_map, fx, b[planes], m, len, sfx, ldx, BM) &&
                   side_map(&p.gy_map, gy, b[planes], n, len, sgy, ldy, BN)))
    return (int)cudaErrorInvalidValue;
  p.len = len;
  p.m = (int)m;
  p.n = (int)n;
  p.planes = planes;
  p.out = static_cast<int32_t*>(out);
  cudaError_t e = cudaFuncSetAttribute(
      contract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  for (int z = 0; z < planes; ++z) p.order[z] = z;
  for (int z = 1; z < planes; ++z)  // insertion sort, fewest channels last
    for (int y = z; y > 0; --y) {
      const int a = p.order[y - 1], c = p.order[y];
      if (b[a + 1] - b[a] >= b[c + 1] - b[c]) break;
      p.order[y - 1] = c;
      p.order[y] = a;
    }
  dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN),
            (unsigned)planes);
  contract_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

// The counters of a shared plan from its per-channel planes: o (planes,
// count) int32 -> out (counters, count) int32, out[g] = sum_k num[g][k]
// o[k] / den[g], exact when every numerator is a multiple of den[g].
// num (counters x planes) and den (counters) are host int arrays.
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int dt_mix_launch(const void* o, long long count, int planes,
                             int counters, const void* num, const void* den,
                             void* out, void* stream) {
  if (count < 0 || planes < 1 || planes > MAX_PLANES || counters < 1 ||
      counters > MAX_G)
    return (int)cudaErrorInvalidValue;
  MixParams p = {};
  const int* nm = static_cast<const int*>(num);
  const int* dn = static_cast<const int*>(den);
  for (int g = 0; g < counters; ++g) {
    for (int k = 0; k < planes; ++k) p.num[g][k] = nm[g * planes + k];
    if (!exact_divisor(dn[g], p.den_shift[g], p.den_inv[g]))
      return (int)cudaErrorInvalidValue;
  }
  if (count == 0) return (int)cudaSuccess;
  p.o = static_cast<const int32_t*>(o);
  p.count = count;
  p.planes = planes;
  p.counters = counters;
  p.out = static_cast<int32_t*>(out);
  const bool vec = count % 4 == 0 && (uintptr_t)o % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const long long items = vec ? count / 4 : count;
  long long blocks = (items + MIX_THREADS - 1) / MIX_THREADS;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    mix_kernel<true><<<(unsigned)blocks, MIX_THREADS, 0, s>>>(p);
  else
    mix_kernel<false><<<(unsigned)blocks, MIX_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// Pairwise counter kernel for Hopper (sm_90a): an int8 GEMM on the tensor
// cores whose operands are made on chip.
//
// Replaces the TPU kernel distance_tpu/ops/pairwise_pallas.py::_kernel
// (launched by counters_pallas): every integer counter of one measure for
// every (x, y) pair of two uint8 Paradis-code matrices, out (G, m, n)
// int32, exact.  Counter g is a sum over its channels k and all sites of
// f_k(x) * g_k(y) with int8 features (ops/plan.py folds the shared k80 and
// tn93 plans into this per-counter form, the mix weight in g_k), divided
// exactly by den[g].  Code 0 (padding) has a zero feature in every channel
// on both sides, so ragged rows and sites are masked by loading code 0:
// any m, n >= 0 and any length >= 0 that is a multiple of 16 (the wrapper
// pads other widths).
//
// Bound.  Operations: 2 m n L R int8 operations (R = the JAX plan's
// channels, L = sites) at 1,979 TOP/s; the bytes (codes in, counters out)
// take under 3% of that at the main path's 2048 x 2048 x 29952 block.
// Measured there (NVIDIA H100 80GB HBM3, 700 W): 61% of the bound for raw,
// 65% for n.  The producer's stores of the B features into shared memory
// bound it (scripts/k1_variants.py), and short counters (k80, tn93) spread
// the producer's per-chunk work over few channels.
//
// Design.  One CTA computes one counter of one 128 x 256 pair tile, as a
// GEMM with K = its channels x all sites.  x row tiles go on grid.x (up to
// 2^31 - 1 blocks: millions of loaded rows), y row tiles on grid.y (65535
// blocks of 256 rows), counters on grid.z, the counter with the most
// channels first: CTAs start in that order and take time in proportion to
// their channels, so the longest start first (raw's 14- and 4-channel
// counters interleaved tile by tile took 1.5x as long).
// - Warp specialisation, 384 threads: warpgroups 0-1 are consumers (each
//   one m64n256 s32 accumulator, 128 registers a thread), warpgroup 2 the
//   producer (setmaxnreg moves registers to the consumers).
// - Code ring: the producer copies the uint8 codes of the tile's 128 + 256
//   rows, 64 sites a chunk, into NC stages with 16-byte cp.async (src-size
//   0 past the last row or site gives code 0), two chunks ahead.  The
//   consumers read their x codes of a chunk once and arrive on its `read`
//   mbarrier before the producer reuses the stage.
// - Features: for a Paradis code (or code 0) the candidacy nibble decides
//   every feature, so each channel's feature is a 16-entry table
//   (ops/plan.py nibble_tables).  Each word of four codes becomes a
//   byte-permute selector (the nibbles' low three bits) and a mask of the
//   nibbles' high bit, once a chunk; per channel a word of four features
//   is then two prmt and one select, with no memory gather (the TPU kernel
//   evaluated the same features with bit operations on its VPU,
//   _eval_prim_i32).  The tables sit in the launch's parameters.
// - A from registers: each consumer thread builds its own x features, the
//   A fragment of wgmma (rows r, r + 8, four bytes at 4 (lane % 4) and
//   16 + 4 (lane % 4) of each 32-site k-step), so x features never pass
//   through shared memory.
// - B through a feature ring: for each (chunk, channel) the producer
//   builds the y features of 256 rows x 64 sites into one of NS slots, in
//   the K-major layout wgmma reads without swizzle (core matrices of 8 rows
//   x 16 bytes), and arrives on the slot's `full` mbarrier; the consumers
//   issue two wgmma.mma_async m64n256k32 .s32.s8.s8 per slot (2 M MACs of
//   the CTA, 512 tensor-core clocks of an SM) and arrive on its `empty`
//   mbarrier once those are done.
// - Epilogue: divide by den[g] exactly (a shift, then the odd part's
//   inverse mod 2^32) and store int32, four lanes of a quad on 32
//   contiguous bytes of a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                     // x rows per CTA (2 x m64)
constexpr int BN = 256;                     // y rows per CTA (n256)
constexpr int ROWS = BM + BN;
constexpr int KC = 64;                      // sites per code chunk and slot
constexpr int KSTEP = 32;                   // sites (int8 K) per wgmma
constexpr int NC = 3;                       // code ring stages
constexpr int NS = 6;                       // feature ring slots
constexpr int CODE_LD = KC + 16;            // padded: conflict-free reads
constexpr int CODE_STAGE = ROWS * CODE_LD;
constexpr int KSTEP_BYTES = BN * KSTEP;     // one k32 step of a slot
constexpr int SLOT = BN * KC;               // y features of one slot
constexpr int CONSUMER = 256;               // two warpgroups
constexpr int PRODUCER = 128;               // one warpgroup
constexpr int THREADS = CONSUMER + PRODUCER;
constexpr int COPIES = ROWS * (KC / 16) / PRODUCER;  // 16-byte code pieces
constexpr int PIECES = BN * (KC / 16) / PRODUCER;    // 16-byte feature pieces
constexpr int MAX_CHANNELS = 32;
constexpr int MAX_G = 4;
constexpr size_t SMEM = (size_t)NS * SLOT + (size_t)NC * CODE_STAGE
                        + (2 * NS + NC) * sizeof(uint64_t);
// Row bounds of one launch: every row index i0 + BM - 1 stays an int.
constexpr long long MAX_M = 0x7fffffffLL - BM;
constexpr long long MAX_N = 65535LL * BN;

static_assert(COPIES * PRODUCER == ROWS * KC / 16, "whole code pieces");
static_assert(PIECES * PRODUCER == BN * KC / 16, "whole feature pieces");
static_assert(SMEM <= 232448, "shared memory of one CTA");

struct Params {
  const uint8_t* x;
  const uint8_t* y;
  long long ldx, ldy, len;
  int m, n, counters;
  int bounds[MAX_G + 1];  // counter g contracts channels bounds[g]..bounds[g+1]-1
  int order[MAX_G];       // counter of grid.z: the most channels first
  int den_shift[MAX_G];     // den[g] = 2^den_shift[g] * odd, and
  uint32_t den_inv[MAX_G];  // odd * den_inv[g] = 1 mod 2^32
  uint4 f_tab[MAX_CHANNELS];  // x-side feature by nibble, 16 int8
  uint4 g_tab[MAX_CHANNELS];  // y-side feature by nibble, weight folded in
  int32_t* out;
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// A word of four codes -> the byte-permute selector of their nibbles' low
// three bits, and 0xff in each byte whose nibble has its high bit (bit 7
// of the code) set.
__device__ __forceinline__ void split(uint32_t w, uint32_t& sel,
                                      uint32_t& hi) {
  const uint32_t t = (w >> 4) & 0x07070707u;
  const uint32_t u = t | (t >> 4);
  sel = (u & 0xffu) | ((u >> 8) & 0xff00u);
  hi = prmt(w, 0u, 0xBA98u);  // sign of each byte, replicated
}

// The table in vector registers: kept in uniform registers, each prmt
// would first copy one of its words.
__device__ __forceinline__ uint4 vector_regs(uint4 tab) {
  return make_uint4(__shfl_sync(0xffffffffu, tab.x, 0),
                    __shfl_sync(0xffffffffu, tab.y, 0),
                    __shfl_sync(0xffffffffu, tab.z, 0),
                    __shfl_sync(0xffffffffu, tab.w, 0));
}

// Four features: table[nibble] of each code.
__device__ __forceinline__ uint32_t lookup(const uint4& tab, uint32_t sel,
                                           uint32_t hi) {
  const uint32_t lo = prmt(tab.x, tab.y, sel);
  const uint32_t up = prmt(tab.z, tab.w, sel);
  return (lo & ~hi) | (up & hi);
}

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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared-memory matrix descriptor, no swizzle, K-major: core matrices of
// 8 rows x 16 bytes (128 contiguous bytes); the next one along K is 128
// bytes on (LBO), the next 8 rows 256 bytes on (SBO).
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

#define D8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),        \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 256 s32, this warpgroup's fragment) += A (64 x 32 s8, from
// registers: a[0..3] as mma.m16n8k32 holds A, for each warp's 16 rows)
// B^T (256 x 32 s8, read from shared memory).
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
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
      "%122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, "
      "p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef D8

__global__ void __launch_bounds__(THREADS, 1)
counters_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* slots = smem;                    // [NS][SLOT]
  unsigned char* codes = smem + NS * SLOT;        // [NC][ROWS][CODE_LD]
  const uint32_t slots_s = smem_addr(slots);
  const uint32_t codes_s = smem_addr(codes);
  const uint32_t full_s = codes_s + NC * CODE_STAGE;  // [NS] mbarriers
  const uint32_t empty_s = full_s + NS * 8;            // [NS] mbarriers
  const uint32_t read_s = empty_s + NS * 8;            // [NC] mbarriers

  const int g = p.order[blockIdx.z];
  const int i0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;
  const int k0 = p.bounds[g];
  const int k1 = p.bounds[g + 1];
  const int chunks = (int)((p.len + KC - 1) / KC);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_s + 8 * s, PRODUCER);
      mbar_init(empty_s + 8 * s, CONSUMER / 32);  // lane 0 of each warp
    }
    for (int s = 0; s < NC; ++s) mbar_init(read_s + 8 * s, CONSUMER / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER) {
    // Producer: codes into the code ring, y features into the slot ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 120;\n");
    const int t = threadIdx.x - CONSUMER;
    // Copies: piece `it` is row 32 it + t / 4 (x rows, then y rows), its
    // 16 bytes t % 4 of the chunk: four lanes on 64 contiguous bytes.
    const int cr = t >> 2, cb = (t & 3) * 16;
    const long long xstep = 32 * p.ldx, ystep = 32 * p.ldy;
    const uint8_t* xrow = p.x + (long long)(i0 + cr) * p.ldx + cb;
    const uint8_t* yrow = p.y + (long long)(j0 + cr) * p.ldy + cb;
    uint32_t rows_ok = 0;  // bit it: piece it's row exists
#pragma unroll
    for (int it = 0; it < COPIES; ++it)
      rows_ok |= (uint32_t)(it < BM / 32 ? i0 + cr + 32 * it < p.m
                                         : j0 + cr + 32 * it - BM < p.n)
                 << it;
    auto load_chunk = [&](int c) {
      if (c < chunks) {
        const uint32_t stage = codes_s + (c % NC) * CODE_STAGE + cr * CODE_LD
                               + cb;
        const long long site = (long long)c * KC;
        const uint32_t ok = site + cb < p.len ? rows_ok : 0u;
        const uint8_t* src = xrow + site;
#pragma unroll
        for (int it = 0; it < COPIES; ++it) {
          if (it == BM / 32) src = yrow + site;
          const bool on = (ok >> it) & 1;
          cp_async16(stage + 32 * it * CODE_LD, on ? src : p.x, on ? 16 : 0);
          src += it < BM / 32 ? xstep : ystep;
        }
      }
      cp_async_commit();  // empty past the last chunk: counts stay uniform
    };
    for (int c = 0; c < NC - 1; ++c) load_chunk(c);
    // Features: piece `it` is y row 32 it + fr, its 16 sites fb; eight
    // lanes on the eight rows of one core matrix.
    const int fr = (t >> 5) * 8 + (t & 7), fb = ((t >> 3) & 3) * 16;
    const int fdst = (fb >> 5) * KSTEP_BYTES + (fr >> 3) * 256 +
                     ((fb >> 4) & 1) * 128 + (fr & 7) * 16;
    uint32_t sel[PIECES][4], hi[PIECES][4];
    int slot = 0;
    uint32_t phase = 1;  // the slots start empty
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<NC - 2>();
      // all of chunk c is in, and no producer thread still reads c - 1
      asm volatile("bar.sync 1, %0;\n" :: "n"(PRODUCER) : "memory");
      const unsigned char* stage =
          codes + (c % NC) * CODE_STAGE + (BM + fr) * CODE_LD + fb;
#pragma unroll
      for (int it = 0; it < PIECES; ++it) {
        const uint4 cw = *reinterpret_cast<const uint4*>(
            stage + 32 * it * CODE_LD);
        split(cw.x, sel[it][0], hi[it][0]);
        split(cw.y, sel[it][1], hi[it][1]);
        split(cw.z, sel[it][2], hi[it][2]);
        split(cw.w, sel[it][3], hi[it][3]);
      }
      for (int k = k0; k < k1; ++k) {
        const uint4 tab = vector_regs(p.g_tab[k]);
        mbar_wait(empty_s + 8 * slot, phase);
        unsigned char* dst = slots + slot * SLOT + fdst;
#pragma unroll
        for (int it = 0; it < PIECES; ++it)
          *reinterpret_cast<uint4*>(dst + it * 1024) =
              make_uint4(lookup(tab, sel[it][0], hi[it][0]),
                         lookup(tab, sel[it][1], hi[it][1]),
                         lookup(tab, sel[it][2], hi[it][2]),
                         lookup(tab, sel[it][3], hi[it][3]));
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full_s + 8 * slot);
        if (++slot == NS) {
          slot = 0;
          phase ^= 1;
        }
      }
      // chunk c + NC - 1 goes where chunk c - 1 was, once the consumers
      // have read their x codes of it
      if (c >= 1)
        mbar_wait(read_s + 8 * ((c - 1) % NC), ((c - 1) / NC) & 1);
      load_chunk(c + NC - 1);
    }
  } else {
    // Consumers: x features into registers, wgmma on each full slot, then
    // the epilogue.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 192;\n");
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // A fragment rows of this thread: r and r + 8; its sites of a chunk:
    // 16 j + 4 (lane % 4) .. + 3, j = 0..3 (a[0], a[2] of k-step 0, then
    // of k-step 1).
    const int r = wg * 64 + warp * 16 + lane / 4;
    const int word = lane % 4;
    int d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    uint32_t sel[2][4], hi[2][4];  // rows r, r + 8; words j of the chunk
    int slot = 0;
    uint32_t phase = 0;
    for (int c = 0; c < chunks; ++c) {
      for (int k = k0; k < k1; ++k) {
        mbar_wait(full_s + 8 * slot, phase);
        if (k == k0) {  // the producer filled chunk c's stage before this
          const uint32_t* rows = reinterpret_cast<const uint32_t*>(
              codes + (c % NC) * CODE_STAGE + r * CODE_LD) + word;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            split(rows[4 * j], sel[0][j], hi[0][j]);
            split(rows[8 * CODE_LD / 4 + 4 * j], sel[1][j], hi[1][j]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(read_s + 8 * (c % NC));
        }
        const uint4 tab = vector_regs(p.f_tab[k]);
        uint32_t a[2][4];  // a[ks][q]: row r + 8 (q & 1), word 2 ks + q / 2
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[ks][q] = lookup(tab, sel[q & 1][2 * ks + q / 2],
                              hi[q & 1][2 * ks + q / 2]);
        const uint32_t base = slots_s + slot * SLOT;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_m64n256k32(d, a[0], desc(base));
        wgmma_m64n256k32(d, a[1], desc(base + KSTEP_BYTES));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (lane == 0) mbar_arrive(empty_s + 8 * slot);
        if (++slot == NS) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i]) :: "memory");

    // Fragment: d[4q + 2h + e] is row 16 warp + lane / 4 + 8 h, column
    // 8 q + 2 (lane % 4) + e of this warpgroup's 64 x 256 tile.
    const int row0 = i0 + r;
    const int col0 = j0 + 2 * (lane % 4);
    // exact division by den = 2^s o: shift, then times o^-1 mod 2^32
    const int shift = p.den_shift[g];
    const uint32_t inv = p.den_inv[g];
    int32_t* out = p.out + (long long)g * p.m * p.n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= p.m) continue;
      int32_t* orow = out + (long long)row * p.n;
#pragma unroll
      for (int q = 0; q < 32; ++q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * q + e;
          if (col < p.n)
            orow[col] = (int)((uint32_t)(d[4 * q + 2 * h + e] >> shift) * inv);
        }
      }
    }
  }
}

}  // namespace

// Counters of every (x, y) pair: x (m, len) and y (n, len) uint8 with row
// strides ldx/ldy (len a multiple of 16; unless len is 0, the strides and
// both addresses too),
// out (counters, m, n) int32, all on the device.  bounds (counters + 1),
// den (counters) are host int arrays, tables (channels x 2 x 4) host uint32
// words: each channel's x-side, then its y-side 16-entry int8 nibble table,
// channels = bounds[counters].  Codes are Paradis codes or 0.
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take (among them
// m > MAX_M and n > MAX_N).
extern "C" int dt_counters_launch(const void* x, const void* y, long long m,
                                  long long n, long long len, long long ldx,
                                  long long ldy, int counters,
                                  const void* bounds, const void* den,
                                  const void* tables, void* out,
                                  void* stream) {
  if (m < 0 || n < 0 || len < 0 || m > MAX_M || n > MAX_N || counters < 1 ||
      counters > MAX_G || len % 16)
    return (int)cudaErrorInvalidValue;
  if (len > 0 && (ldx % 16 || ldy % 16 || ldx < len || ldy < len ||
                  (uintptr_t)x % 16 || (uintptr_t)y % 16))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int* b = static_cast<const int*>(bounds);
  const int* dn = static_cast<const int*>(den);
  if (b[0] != 0 || b[counters] > MAX_CHANNELS)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g <= counters; ++g) p.bounds[g] = b[g];
  for (int g = 0; g < counters; ++g) {
    if (b[g + 1] <= b[g] || dn[g] <= 0) return (int)cudaErrorInvalidValue;
    uint32_t odd = (uint32_t)dn[g];
    int shift = 0;
    for (; !(odd & 1); odd >>= 1) ++shift;
    uint32_t inv = odd;  // Newton: each step doubles the correct low bits
    for (int i = 0; i < 5; ++i) inv *= 2 - odd * inv;
    p.den_shift[g] = shift;
    p.den_inv[g] = inv;
  }
  const uint32_t* tab = static_cast<const uint32_t*>(tables);
  for (int k = 0; k < b[counters]; ++k) {
    const uint32_t* w = tab + 8 * k;
    p.f_tab[k] = make_uint4(w[0], w[1], w[2], w[3]);
    p.g_tab[k] = make_uint4(w[4], w[5], w[6], w[7]);
  }
  if (m == 0 || n == 0) return (int)cudaSuccess;
  p.x = static_cast<const uint8_t*>(x);
  p.y = static_cast<const uint8_t*>(y);
  p.ldx = ldx;
  p.ldy = ldy;
  p.len = len;
  p.m = (int)m;
  p.n = (int)n;
  p.counters = counters;
  p.out = static_cast<int32_t*>(out);
  cudaError_t e = cudaFuncSetAttribute(
      counters_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  for (int z = 0; z < counters; ++z) p.order[z] = z;
  for (int z = 1; z < counters; ++z)  // insertion sort, fewest channels last
    for (int y = z; y > 0; --y) {
      const int a = p.order[y - 1], c = p.order[y];
      if (b[a + 1] - b[a] >= b[c + 1] - b[c]) break;
      p.order[y - 1] = c;
      p.order[y] = a;
    }
  dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN),
            (unsigned)counters);
  counters_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

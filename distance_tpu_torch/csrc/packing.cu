// Counter packing for Hopper (sm_90a): the packs of the counters before
// they leave the card.  Two families, in two parts of this file.
//
// K4, the narrow and wide packs.  Replaces pack_device_narrow
// (distance_tpu/ops/packing.py:98) and pack_device (:49), which XLA fused
// into the JAX engine's block and stream functions at widths below 2^16
// sites.  From (G, m, n) int32 counters c, G = 1, 2, 3 or 4 for the
// measures n/n_high, raw/jc69, k80 and tn93 (G fixes the form):
// - narrow: (G, m, n) int8 lanes, each min(v, 255) cast to uint8 (255 =
//   saturated; numpy's astype wraps a negative v, and so does the cast
//   here), of v = [c0] (n), [c0, w - (c0 + c1)] (raw), [w - (c0 + c1 +
//   c2), c1, c2] (k80), [w - c1, c1 - c0, c2, c3] (tn93), w the width;
// - wide: the unsigned bit patterns, in signed types: (1, m, n) int16 c0
//   (n), (1, m, n) int32 c0 << 16 | c1 (raw), (2, m, n) int32 [c0 << 16 |
//   c1, c2] (k80) and [c0 << 16 | c1, c2 << 16 | c3] (tn93).
// Arithmetic wraps as numpy's int32 and uint32 do (it is done unsigned).
// Bound: bytes, the counters read once (4 G m n B) and the lanes written
// once (G m n B narrow; 2 m n or 4 P m n B wide), a handful of integer
// operations a pair.  Design, simple first: a grid-stride loop, one
// thread a pair (cell), which reads its G counters (neighbouring threads
// read neighbouring words of each counter plane) and writes its lanes.
//
// Rank-1 residual packing, the rel4 and rel packs (K2).
//
// Replaces the device half of distance_tpu/ops/packing.py: pack_device_rel4
// (packing.py:189) and pack_device_rel (:141), which XLA fused into the
// JAX engine's block and stream functions (engine.py _jit_block_fn,
// _jit_block_fn_feat, _jit_stream_fn).  From (G, m, n) int32 counters c
// and int32 baselines rb (G, m), cb (G, n), cc (G,), the residual
//     res = c - rb - cb + cc
// is zeroed on the self-pair diagonal (row i0 + r and column j0 + col of a
// sweep over one source with i0 + r + doff == j0 + col) and, under rel4,
// on padding (i0 + r >= nv1 or j0 + col >= nv2), then
// - rel4: |res| > 7 becomes -8, and two's-complement nibbles go two a
//   byte along columns (the even column in the low nibble), out (G, m,
//   n/2) int8.  The flat (G, m, n) tensor is cut into 8192 segments of
//   ceil(G m n / 8192) cells; the first outlier of each segment goes to
//   exc_idx[s], the last of a segment holding two or more to exc_idx[8192
//   + s] (flat indices, -1 for none), and their true residuals to exc_val
//   (0 where the index is -1): the JAX packing.py:208-224 exactly.
// - rel: |res| > 127 becomes -128, out (G, m, n) int8.
//
// Bound.  Bytes: the counters are read once (4 G m n B) and the lanes
// written once (G m n / 2 B under rel4, G m n B under rel); the baselines
// are G (m + n + 1) words and the sidecar 128 KB.  A few integer
// operations a cell put it far below the card's operation rate, so it is
// bound by memory.
//
// Design, simple first: one thread per output byte (two cells under rel4,
// one under rel) reads its counters with one 8-byte (4-byte) load, so
// neighbouring threads read neighbouring words; rows' and columns'
// baselines come through the caches.  Outliers are rare (the residual
// accrues only where both records differ from the reference), so each
// outlier does an atomicMin and an atomicMax on its segment's (first,
// last) pair in a (8192, 2) scratch, which a first pass sets to (INT_MAX,
// -1); a last pass of 8192 threads writes exc_idx and exc_val.  The three
// passes run on one stream, in order.  Fusing the pack into the counter
// kernel's epilogue, so that the int32 counters never reach device
// memory, is later work.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int SEGMENTS = 8192;
constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1LL << 20;

struct Block {
  const int32_t* c;
  const int32_t* rb;
  const int32_t* cb;
  const int32_t* cc;
  long long m, n, i0, j0, nv1, nv2, doff;
  int diag, pad;
};

// The (masked) residual of cell (g, r, col) with counter value v.
__device__ __forceinline__ int32_t residual(const Block& b, long long g,
                                            long long r, long long col,
                                            int32_t v) {
  const long long ri = b.i0 + r, cj = b.j0 + col;
  if ((b.diag && ri + b.doff == cj) ||
      (b.pad && (ri >= b.nv1 || cj >= b.nv2)))
    return 0;
  // int32 arithmetic that wraps as numpy's does (unsigned: no overflow UB)
  return (int32_t)((uint32_t)v - (uint32_t)b.rb[g * b.m + r] -
                   (uint32_t)b.cb[g * b.n + col] + (uint32_t)b.cc[g]);
}

__device__ __forceinline__ bool out4(int32_t res) {
  return res > 7 || res < -7;
}

__global__ void segments_init(int32_t* scratch) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < SEGMENTS) {
    scratch[2 * s] = INT_MAX;
    scratch[2 * s + 1] = -1;
  }
}

__global__ void rel4_lanes(Block b, long long bytes, long long seg_len,
                           int8_t* lanes, int32_t* scratch) {
  const long long half = b.n / 2;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < bytes; k += (long long)gridDim.x * blockDim.x) {
    const long long gr = k / half;  // g * m + r
    const long long col = 2 * (k - gr * half);
    const long long g = gr / b.m, r = gr - g * b.m;
    const long long flat = gr * b.n + col;
    const int2 v = *reinterpret_cast<const int2*>(b.c + flat);
    const int32_t res[2] = {residual(b, g, r, col, v.x),
                            residual(b, g, r, col + 1, v.y)};
    uint32_t byte = 0;
    for (int h = 0; h < 2; ++h) {
      int32_t q = res[h];
      if (out4(q)) {
        q = -8;
        const long long f = flat + h;
        const long long s = f / seg_len;
        atomicMin(&scratch[2 * s], (int)f);
        atomicMax(&scratch[2 * s + 1], (int)f);
      }
      byte |= ((uint32_t)q & 0xFu) << (4 * h);
    }
    lanes[k] = (int8_t)(uint8_t)byte;
  }
}

__global__ void rel4_sidecar(Block b, const int32_t* scratch,
                             int32_t* exc_idx, int32_t* exc_val) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= SEGMENTS) return;
  const int first = scratch[2 * s], last = scratch[2 * s + 1];
  const int idx[2] = {first == INT_MAX ? -1 : first,
                      last >= 0 && last != first ? last : -1};
  for (int h = 0; h < 2; ++h) {
    int32_t val = 0;
    if (idx[h] >= 0) {
      const long long f = idx[h];
      const long long gr = f / b.n, col = f - gr * b.n;
      const long long g = gr / b.m, r = gr - g * b.m;
      val = residual(b, g, r, col, b.c[f]);
    }
    exc_idx[h * SEGMENTS + s] = idx[h];
    exc_val[h * SEGMENTS + s] = val;
  }
}

__global__ void rel_lanes(Block b, long long cells, int8_t* lanes) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < cells; k += (long long)gridDim.x * blockDim.x) {
    const long long gr = k / b.n, col = k - gr * b.n;
    const long long g = gr / b.m, r = gr - g * b.m;
    const int32_t res = residual(b, g, r, col, b.c[k]);
    lanes[k] = (int8_t)(res > 127 || res < -127 ? -128 : res);
  }
}

// numpy's minimum(v, 255).astype(uint8): the cast keeps the low byte.
__device__ __forceinline__ int8_t sat8(uint32_t v) {
  return (int8_t)(uint8_t)((int32_t)v < 255 ? v : 255u);
}

// A 32-bit word of two 16-bit fields: hi << 16 | lo, as numpy's uint32.
__device__ __forceinline__ int32_t word(uint32_t hi, uint32_t lo) {
  return (int32_t)((hi << 16) | lo);
}

template <int G>
__global__ void narrow_lanes(const int32_t* __restrict__ c, long long cells,
                             uint32_t w, int8_t* __restrict__ out) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < cells; k += (long long)gridDim.x * blockDim.x) {
    uint32_t v[G];
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = (uint32_t)c[g * cells + k];
    if (G == 1) {
      out[k] = sat8(v[0]);
    } else if (G == 2) {
      out[k] = sat8(v[0]);
      out[cells + k] = sat8(w - (v[0] + v[1 % G]));
    } else if (G == 3) {
      out[k] = sat8(w - (v[0] + v[1 % G] + v[2 % G]));
      out[cells + k] = sat8(v[1 % G]);
      out[2 * cells + k] = sat8(v[2 % G]);
    } else {
      out[k] = sat8(w - v[1 % G]);
      out[cells + k] = sat8(v[1 % G] - v[0]);
      out[2 * cells + k] = sat8(v[2 % G]);
      out[3 * cells + k] = sat8(v[3 % G]);
    }
  }
}

template <int G>
__global__ void wide_words(const int32_t* __restrict__ c, long long cells,
                           void* __restrict__ out) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < cells; k += (long long)gridDim.x * blockDim.x) {
    uint32_t v[G];
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = (uint32_t)c[g * cells + k];
    if (G == 1) {
      static_cast<int16_t*>(out)[k] = (int16_t)(uint16_t)v[0];
    } else {
      int32_t* o = static_cast<int32_t*>(out);
      o[k] = word(v[0], v[1 % G]);
      if (G == 3) o[cells + k] = (int32_t)v[2 % G];
      if (G == 4) o[cells + k] = word(v[2 % G], v[3 % G]);
    }
  }
}

unsigned grid_for(long long work) {
  const long long blocks = (work + THREADS - 1) / THREADS;
  return (unsigned)(blocks < MAX_BLOCKS ? (blocks > 0 ? blocks : 1)
                                        : MAX_BLOCKS);
}

bool valid(long long g, long long m, long long n) {
  return g >= 1 && m >= 0 && n >= 0 && g * m * n < (1LL << 31);
}

}  // namespace

// rel4 pack of c (g, m, n) int32 (n even) with baselines rb (g, m), cb
// (g, n), cc (g,), all contiguous on the device: lanes (g, m, n/2) int8,
// exc_idx and exc_val (16384,) int32, scratch (8192, 2) int32 of the
// caller's.  The block's rows are records i0.. and its columns j0..;
// `diag` masks the self-pairs (i0 + r + doff == j0 + col), and cells past
// nv1 rows or nv2 columns are padding.  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take (an odd n, 2^31 cells or more).
extern "C" int dt_pack_rel4_launch(const void* c, const void* rb,
                                   const void* cb, const void* cc,
                                   long long g, long long m, long long n,
                                   long long i0, long long j0, long long nv1,
                                   long long nv2, int diag, long long doff,
                                   void* lanes, void* scratch, void* exc_idx,
                                   void* exc_val, void* stream) {
  if (!valid(g, m, n) || n % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Block b = {static_cast<const int32_t*>(c), static_cast<const int32_t*>(rb),
             static_cast<const int32_t*>(cb), static_cast<const int32_t*>(cc),
             m, n, i0, j0, nv1, nv2, doff, diag, 1};
  const long long cells = g * m * n;
  const long long seg_len = cells ? (cells + SEGMENTS - 1) / SEGMENTS : 1;
  int32_t* sc = static_cast<int32_t*>(scratch);
  segments_init<<<SEGMENTS / THREADS, THREADS, 0, st>>>(sc);
  if (cells)
    rel4_lanes<<<grid_for(cells / 2), THREADS, 0, st>>>(
        b, cells / 2, seg_len, static_cast<int8_t*>(lanes), sc);
  rel4_sidecar<<<SEGMENTS / THREADS, THREADS, 0, st>>>(
      b, sc, static_cast<int32_t*>(exc_idx), static_cast<int32_t*>(exc_val));
  return (int)cudaGetLastError();
}

// rel pack of c (g, m, n) int32 with baselines as above: lanes (g, m, n)
// int8; `diag` masks the self-pairs (no padding mask, as in the JAX rel).
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for 2^31 cells or more.
extern "C" int dt_pack_rel_launch(const void* c, const void* rb,
                                  const void* cb, const void* cc, long long g,
                                  long long m, long long n, long long i0,
                                  long long j0, int diag, long long doff,
                                  void* lanes, void* stream) {
  if (!valid(g, m, n)) return (int)cudaErrorInvalidValue;
  Block b = {static_cast<const int32_t*>(c), static_cast<const int32_t*>(rb),
             static_cast<const int32_t*>(cb), static_cast<const int32_t*>(cc),
             m, n, i0, j0, 0, 0, doff, diag, 0};
  const long long cells = g * m * n;
  if (cells)
    rel_lanes<<<grid_for(cells), THREADS, 0, static_cast<cudaStream_t>(
                                                  stream)>>>(
        b, cells, static_cast<int8_t*>(lanes));
  return (int)cudaGetLastError();
}

// Narrow pack of c (g, cells) int32, contiguous on the device, at `width`
// sites: out (g, cells) int8, g = 1 to 4 the measure's counters.  Launches
// on `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// a g outside 1-4 or a negative cell count.
extern "C" int dt_pack_narrow_launch(const void* c, long long g,
                                     long long cells, long long width,
                                     void* out, void* stream) {
  if (g < 1 || g > 4 || cells < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* cp = static_cast<const int32_t*>(c);
  int8_t* op = static_cast<int8_t*>(out);
  const uint32_t w = (uint32_t)width;
  const unsigned grid = grid_for(cells);
  if (cells) {
    if (g == 1) narrow_lanes<1><<<grid, THREADS, 0, st>>>(cp, cells, w, op);
    if (g == 2) narrow_lanes<2><<<grid, THREADS, 0, st>>>(cp, cells, w, op);
    if (g == 3) narrow_lanes<3><<<grid, THREADS, 0, st>>>(cp, cells, w, op);
    if (g == 4) narrow_lanes<4><<<grid, THREADS, 0, st>>>(cp, cells, w, op);
  }
  return (int)cudaGetLastError();
}

// Wide pack of c (g, cells) int32: out (1, cells) int16 for g = 1, else
// ((g + 1) / 2, cells) int32.  Returns as dt_pack_narrow_launch does.
extern "C" int dt_pack_wide_launch(const void* c, long long g,
                                   long long cells, void* out, void* stream) {
  if (g < 1 || g > 4 || cells < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* cp = static_cast<const int32_t*>(c);
  const unsigned grid = grid_for(cells);
  if (cells) {
    if (g == 1) wide_words<1><<<grid, THREADS, 0, st>>>(cp, cells, out);
    if (g == 2) wide_words<2><<<grid, THREADS, 0, st>>>(cp, cells, out);
    if (g == 3) wide_words<3><<<grid, THREADS, 0, st>>>(cp, cells, out);
    if (g == 4) wide_words<4><<<grid, THREADS, 0, st>>>(cp, cells, out);
  }
  return (int)cudaGetLastError();
}

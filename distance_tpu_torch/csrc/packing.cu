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
//   L = ceil(G m n / 8192) cells; the first outlier of each segment goes
//   to exc_idx[s], the last of a segment holding two or more to
//   exc_idx[8192 + s] (flat indices, -1 for none), and their true
//   residuals to exc_val (0 where the index is -1): the JAX
//   packing.py:208-224 exactly.  A pack may be a column window of a
//   wider block, the columns col0 .. col0 + n of a block of n_whole
//   (one part of a block whose columns are split over devices): its
//   segments and sidecar indices are then the whole block's, so that the
//   parts' sidecars merge into the whole block's (packing.py
//   merge_rel4_sidecars).  The window of a whole block (col0 0, n_whole
//   n) is the plain pack.
// - rel: |res| > 127 becomes -128, out (G, m, n) int8.
//
// Bound.  Bytes: the counters are read once (4 G m n B) and the lanes
// written once (G m n / 2 B under rel4, G m n B under rel); the baselines
// are G (m + n + 1) words and the sidecar 128 KB.  A few integer
// operations a cell put it far below the card's operation rate, so it is
// bound by memory, if the loads are wide and enough of them are in
// flight, and if the index arithmetic does not bind it instead.
//
// Design.  One launch a pack, no scratch, no atomics.  Positions are
// 32-bit (valid() keeps a pack under 2^31 cells).  Cells go in quads of 4
// (one 16-byte load), and the 32 lanes of a warp take 32 consecutive
// quads, so that every load and store of a warp is contiguous: the
// counters (512 B), the column baselines cb (one 16-byte load a quad
// where its 4 cells share a row and the address allows) and the lanes.
// A lane's flat index is divided into (plane, row, column) once, then
// stepped from quad to quad, with a division only where it passes a row;
// the row's constants (cc - rb, the column of its self-pair, whether it
// is padding) are recomputed only when the row changes.  The baselines
// take a row stride, so the caller's slices of a prepared matrix's
// baselines are read in place.
// - rel4: one warp a segment, 8 warps a block, UNROLL quads in flight a
//   lane; each quad's 4 nibbles go out as one 16-bit store (a warp's
//   stores are 64 contiguous bytes).  A quad is written by the warp
//   whose segment holds its first cell, which also reads the quad's
//   cells past its segment's end (L need not be a multiple of 4, nor
//   even) but counts an outlier only in its own range; the cells of a segment before its first quad (at most 3) are
//   read once more by its own warp, after its quads, for their outliers.
//   Each lane keeps the first and last outlier it met with its residual;
//   __reduce_min_sync/__reduce_max_sync give the segment's, a ballot and
//   a shuffle bring their residuals to lane 0, which writes the
//   segment's sidecar slots.
// - rel: a grid-stride loop over warp chunks of 128 quads, four quads in
//   flight a lane, each quad's 4 int8 lanes one 32-bit store.
// Fusing the pack into the counter kernel's epilogue is declined: a strip
// whose pack saturates is packed again at a lower rung from the int32
// counters the engine keeps on the card (engine._Strip), which a fused
// epilogue would have to count again; the saving, the counters' write and
// read, is about 0.02 ms of a 3.7 ms block.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int SEGMENTS = 8192;
constexpr int THREADS = 256;
constexpr int SEG_WARPS = THREADS / 32;  // rel4 segments a block
constexpr int UNROLL = 8;                // rel4 quads in flight a lane
constexpr long long MAX_BLOCKS = 1LL << 20;

// A pack's inputs and the block's masks, in the cells' own coordinates.
struct Rel {
  const int32_t* c;
  const int32_t* rb;  // (g, r) at rb[g * rb_stride + r]
  const int32_t* cb;  // (g, col) at cb[g * cb_stride + col]
  const int32_t* cc;
  long long rb_stride, cb_stride;
  unsigned m, n, cells;
  unsigned rows_valid;  // rows from here on are padding
  unsigned cols_valid;  // columns from here on are padding
  long long dshift;     // a row's self-pair column is r + dshift
  int diag;
};

// The cell a cursor is on, and its row's constants.
struct Cursor {
  unsigned g, r, col;
  uint32_t base;  // cc[g] - rb[g, r], wrapping as numpy's int32 does
  const int32_t* cbg;
  long long dcol;  // the row's self-pair column, or -1
  bool zero;       // a padding row
};

__device__ __forceinline__ void row_of(const Rel& p, Cursor& k) {
  k.base = (uint32_t)__ldg(p.cc + k.g) -
           (uint32_t)__ldg(p.rb + k.g * p.rb_stride + k.r);
  k.cbg = p.cb + k.g * p.cb_stride;
  k.dcol = p.diag ? (long long)k.r + p.dshift : -1;
  k.zero = k.r >= p.rows_valid;
}

__device__ __forceinline__ void seek(const Rel& p, unsigned f, Cursor& k) {
  const unsigned gr = f / p.n;
  k.col = f - gr * p.n;
  k.g = gr / p.m;
  k.r = gr - k.g * p.m;
  row_of(p, k);
}

// To the next cell, which must exist.
__device__ __forceinline__ void step(const Rel& p, Cursor& k) {
  if (++k.col == p.n) {
    k.col = 0;
    if (++k.r == p.m) {
      k.r = 0;
      ++k.g;
    }
    row_of(p, k);
  }
}

// The (masked) residual of the cursor's cell, whose counter is v.
__device__ __forceinline__ int32_t residual(const Rel& p, const Cursor& k,
                                            int32_t v) {
  if (k.zero || k.col >= p.cols_valid || (long long)k.col == k.dcol)
    return 0;
  return (int32_t)((uint32_t)v - (uint32_t)__ldg(k.cbg + k.col) + k.base);
}

// numpy's int32 abs, which wraps: |INT_MIN| stays negative, so a residual
// of INT_MIN is no outlier.
__device__ __forceinline__ int32_t wabs(int32_t res) {
  return res < 0 ? (int32_t)(0u - (uint32_t)res) : res;
}

__device__ __forceinline__ bool out4(int32_t res) { return wabs(res) > 7; }

__device__ __forceinline__ int32_t residual_at(const Rel& p, unsigned f) {
  Cursor k;
  seek(p, f, k);
  return residual(p, k, __ldg(p.c + f));
}

// To the cell `d` cells on, which must exist.
__device__ __forceinline__ void advance(const Rel& p, Cursor& k, unsigned d) {
  k.col += d;
  if (k.col >= p.n) {
    const unsigned rows = k.col / p.n;
    const unsigned gr = k.g * p.m + k.r + rows;
    k.col -= rows * p.n;
    k.g = gr / p.m;
    k.r = gr - k.g * p.m;
    row_of(p, k);
  }
}

// The 4 counters of quad q (cells 4 q ..), 0 past the last cell.
__device__ __forceinline__ int4 load4(const Rel& p, unsigned q) {
  const unsigned f0 = 4u * q;
  if (f0 + 4u <= p.cells) return __ldg(reinterpret_cast<const int4*>(p.c) + q);
  int4 v = {0, 0, 0, 0};
  v.x = __ldg(p.c + f0);
  if (f0 + 1u < p.cells) v.y = __ldg(p.c + f0 + 1);
  if (f0 + 2u < p.cells) v.z = __ldg(p.c + f0 + 2);
  return v;
}

// The residuals of a quad's `cnt` cells, the cursor on its first cell and
// left on its last; 0 past them.
__device__ __forceinline__ void quad_res(const Rel& p, Cursor& k,
                                         const int4& v, unsigned cnt,
                                         int32_t (&res)[4]) {
  const int32_t vv[4] = {v.x, v.y, v.z, v.w};
  if (cnt == 4 && k.col + 3u < p.n) {  // the quad lies in one row
    const int32_t* cbp = k.cbg + k.col;
    int32_t cb[4];
    if (reinterpret_cast<uintptr_t>(cbp) % 16 == 0) {
      const int4 b = __ldg(reinterpret_cast<const int4*>(cbp));
      cb[0] = b.x; cb[1] = b.y; cb[2] = b.z; cb[3] = b.w;
    } else {
#pragma unroll
      for (int h = 0; h < 4; ++h) cb[h] = __ldg(cbp + h);
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const unsigned col = k.col + h;
      res[h] = k.zero || col >= p.cols_valid || (long long)col == k.dcol
                   ? 0
                   : (int32_t)((uint32_t)vv[h] - (uint32_t)cb[h] + k.base);
    }
    k.col += 3;
    return;
  }
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    res[h] = 0;
    if ((unsigned)h < cnt) {
      if (h) step(p, k);
      res[h] = residual(p, k, vv[h]);
    }
  }
}

// The cells of a window (columns col0 .. col0 + p.n of each of the rows of
// a block n_whole columns wide) whose flat index in the whole block is
// below x: a segment of the whole block is a run of the window's cells.
__device__ __forceinline__ unsigned window_before(const Rel& p, unsigned x,
                                                  unsigned col0,
                                                  unsigned n_whole) {
  if (n_whole == p.n) return x;
  const unsigned rows = x / n_whole, col = x - rows * n_whole;
  return rows * p.n + (col <= col0 ? 0u : min(col - col0, p.n));
}

// The whole block's flat index of the window's cell f.
__device__ __forceinline__ unsigned whole_index(const Rel& p, unsigned f,
                                                unsigned col0,
                                                unsigned n_whole) {
  if (n_whole == p.n) return f;
  const unsigned row = f / p.n;
  return row * n_whole + col0 + (f - row * p.n);
}

// An outlier at cell f with residual res, for a lane's first and last.
__device__ __forceinline__ void note(int f, int32_t res, int& first,
                                     int32_t& first_res, int& last,
                                     int32_t& last_res) {
  if (f < first) {
    first = f;
    first_res = res;
  }
  if (f > last) {
    last = f;
    last_res = res;
  }
}

// 4 blocks an SM (at most 64 registers a thread): 1024 blocks take two
// waves of the card's 132 SMs, not three.
__global__ void __launch_bounds__(THREADS, 4)
    rel4_pack(Rel p, unsigned seg_len, unsigned col0, unsigned n_whole,
              unsigned whole, uint16_t* __restrict__ lanes,
              int32_t* __restrict__ exc) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned s = blockIdx.x * SEG_WARPS + (threadIdx.x >> 5);
  // the segment's cells of the window, in its own flat order
  const unsigned lo_w = min(s * seg_len, whole);
  const unsigned lo = window_before(p, lo_w, col0, n_whole);
  const unsigned hi =
      window_before(p, min(lo_w + seg_len, whole), col0, n_whole);
  int first = INT_MAX, last = -1;
  int32_t first_res = 0, last_res = 0;
  const unsigned q_lo = (lo + 3u) >> 2, q_hi = (hi + 3u) >> 2;
  Cursor k;
  bool placed = false;
  for (unsigned q0 = q_lo + lane; q0 < q_hi; q0 += 32u * UNROLL) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (q0 + 32u * u < q_hi) v[u] = load4(p, q0 + 32u * u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned q = q0 + 32u * u;
      if (q >= q_hi) break;
      // from the last cell of the lane's quad before, 32 quads back
      if (placed) advance(p, k, 125u);
      else seek(p, 4u * q, k);
      placed = true;
      const unsigned cnt = min(4u, p.cells - 4u * q);
      int32_t res[4];
      quad_res(p, k, v[u], cnt, res);
      uint32_t half = 0;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        int32_t nib = res[h];
        if (out4(nib)) {
          if (4u * q + h < hi)
            note((int)(4u * q + h), nib, first, first_res, last, last_res);
          nib = -8;
        }
        half |= ((uint32_t)nib & 0xFu) << (4 * h);
      }
      if (cnt == 4) {
        lanes[q] = (uint16_t)half;
      } else {  // the tensor's last quad: cnt is even
        reinterpret_cast<uint8_t*>(lanes)[2u * q] = (uint8_t)half;
      }
    }
  }
  // the head, read once more after the quads' loads: cells before the
  // segment's first quad
  if (lo + lane < min(hi, (lo + 3u) & ~3u)) {
    const int32_t res = residual_at(p, lo + lane);
    if (out4(res))
      note((int)(lo + lane), res, first, first_res, last, last_res);
  }
  const int seg_first = __reduce_min_sync(0xffffffffu, first);
  const int seg_last = __reduce_max_sync(0xffffffffu, last);
  // each cell is one lane's: exactly one lane holds each of them
  const unsigned has_first = __ballot_sync(0xffffffffu, first == seg_first);
  const unsigned has_last = __ballot_sync(0xffffffffu, last == seg_last);
  first_res = __shfl_sync(0xffffffffu, first_res, __ffs(has_first) - 1);
  last_res = __shfl_sync(0xffffffffu, last_res, __ffs(has_last) - 1);
  if (lane == 0) {
    const bool one = seg_first != INT_MAX;
    const bool two = seg_last >= 0 && seg_last != seg_first;
    exc[s] = one ? (int)whole_index(p, seg_first, col0, n_whole) : -1;
    exc[SEGMENTS + s] =
        two ? (int)whole_index(p, seg_last, col0, n_whole) : -1;
    exc[2 * SEGMENTS + s] = one ? first_res : 0;
    exc[3 * SEGMENTS + s] = two ? last_res : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
    rel_pack(Rel p, uint32_t* __restrict__ lanes) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned quads = (p.cells + 3u) / 4u;
  const unsigned warps = gridDim.x * SEG_WARPS;
  for (unsigned w = blockIdx.x * SEG_WARPS + (threadIdx.x >> 5);
       w < (quads + 127u) / 128u; w += warps) {
    const unsigned q0 = 128u * w + lane;
    int4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (q0 + 32u * u < quads) v[u] = load4(p, q0 + 32u * u);
    Cursor k;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned q = q0 + 32u * u;
      if (q >= quads) break;
      if (u) advance(p, k, 125u);
      else seek(p, 4u * q, k);
      const unsigned cnt = min(4u, p.cells - 4u * q);
      int32_t res[4];
      quad_res(p, k, v[u], cnt, res);
      uint32_t word = 0;
#pragma unroll
      for (int h = 0; h < 4; ++h)
        word |= ((uint32_t)(wabs(res[h]) > 127 ? -128 : res[h]) & 0xFFu)
                << (8 * h);
      if (cnt == 4) {
        lanes[q] = word;
      } else {  // the tensor's last quad
        uint8_t* bytes = reinterpret_cast<uint8_t*>(lanes) + 4u * q;
        for (unsigned h = 0; h < cnt; ++h)
          bytes[h] = (uint8_t)(word >> (8 * h));
      }
    }
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

// The Rel of a pack, or false for arguments the kernels do not take: 2^31
// cells or more, negative strides, counters off the 16-byte grid.
bool rel_of(const void* c, const void* rb, long long rb_stride,
            const void* cb, long long cb_stride, const void* cc, long long g,
            long long m, long long n, long long i0, long long j0,
            long long nv1, long long nv2, int diag, long long doff, Rel& p) {
  if (!valid(g, m, n) || rb_stride < 0 || cb_stride < 0 ||
      reinterpret_cast<uintptr_t>(c) % 16)
    return false;
  const auto clamp = [](long long v, long long hi) {
    return (unsigned)(v < 0 ? 0 : v > hi ? hi : v);
  };
  p = {static_cast<const int32_t*>(c), static_cast<const int32_t*>(rb),
       static_cast<const int32_t*>(cb), static_cast<const int32_t*>(cc),
       rb_stride, cb_stride, (unsigned)m, (unsigned)n, (unsigned)(g * m * n),
       clamp(nv1 - i0, m), clamp(nv2 - j0, n), i0 + doff - j0, diag};
  return true;
}

}  // namespace

// rel4 pack of c (g, m, n) int32 (n even, contiguous, 16-byte aligned) with
// baselines rb (g, m) and cb (g, n) whose rows are rb_stride and cb_stride
// words apart (each row contiguous) and cc (g,), on the device: lanes (g,
// m, n/2) int8 and the sidecar exc (2, 16384) int32, exc_idx then
// exc_val.  The block's rows are records i0.. and its columns j0..; `diag`
// masks the self-pairs (i0 + r + doff == j0 + col), and cells past nv1
// rows or nv2 columns are padding.  c is the window of columns col0 ..
// col0 + n of a block n_whole columns wide: the sidecar's segments and
// indices are the whole block's (col0 0 and n_whole n for a whole block).
// One launch on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take (an odd n,
// a window outside its block, 2^31 cells or more in the block, c off the
// 16-byte grid).
extern "C" int dt_pack_rel4_launch(const void* c, const void* rb,
                                   long long rb_stride, const void* cb,
                                   long long cb_stride, const void* cc,
                                   long long g, long long m, long long n,
                                   long long i0, long long j0, long long nv1,
                                   long long nv2, int diag, long long doff,
                                   long long col0, long long n_whole,
                                   void* lanes, void* exc, void* stream) {
  Rel p;
  if (n % 2 || reinterpret_cast<uintptr_t>(lanes) % 2 || col0 < 0 ||
      n_whole < n || col0 > n_whole - n || !valid(g, m, n_whole) ||
      !rel_of(c, rb, rb_stride, cb, cb_stride, cc, g, m, n, i0, j0, nv1, nv2,
              diag, doff, p))
    return (int)cudaErrorInvalidValue;
  const unsigned whole = (unsigned)(g * m * n_whole);
  const unsigned seg_len = whole ? (whole + SEGMENTS - 1) / SEGMENTS : 1;
  rel4_pack<<<SEGMENTS / SEG_WARPS, THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(
      p, seg_len, (unsigned)col0, (unsigned)n_whole, whole,
      static_cast<uint16_t*>(lanes), static_cast<int32_t*>(exc));
  return (int)cudaGetLastError();
}

// rel pack of c (g, m, n) int32 with baselines as above: lanes (g, m, n)
// int8, 4-byte aligned; `diag` masks the self-pairs (no padding mask, as
// in the JAX rel).  Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int dt_pack_rel_launch(const void* c, const void* rb,
                                  long long rb_stride, const void* cb,
                                  long long cb_stride, const void* cc,
                                  long long g, long long m, long long n,
                                  long long i0, long long j0, int diag,
                                  long long doff, void* lanes, void* stream) {
  Rel p;
  if (reinterpret_cast<uintptr_t>(lanes) % 4 ||
      !rel_of(c, rb, rb_stride, cb, cb_stride, cc, g, m, n, i0, j0, i0 + m,
              j0 + n, diag, doff, p))
    return (int)cudaErrorInvalidValue;
  if (p.cells)  // a warp a chunk of 128 quads
    rel_pack<<<grid_for((p.cells + 511LL) / 512 * 32), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<uint32_t*>(lanes));
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

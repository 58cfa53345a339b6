// Distance estimate epilogue for Hopper (sm_90a): the site partials of a
// block's (G, m, cols) int32 counters -> their sum's (m, cols) float32
// estimates of one measure, written into a window of an (m, ld) output.
//
// Replaces the in-graph tail of the JAX package's
// distance_tpu/parallel/mesh.py::sharded_step (mesh.py:79-111): the psum
// over "sp" of sharded_counters_fn (mesh.py:44) and the float32 estimate
// after it, as one pass over each partial.  With c the summed counters as
// float32 and the rows taken by name from the measure's plan:
//   n, n_high  diff
//   raw        p = diff / (same + diff)
//   jc69       -0.75 log(1 - 4/3 p)
//   k80        l = same + ts + tv, p = ts / l, q = tv / l,
//              -0.5 log((1 - 2p - q) sqrt(1 - 2q))
//   tn93       (kk - same) / kk
// each operation in the JAX expression's order, rounded once as float32
// (the intrinsics keep nvcc from contracting a product and a sum into one
// fma), but for jc69's 1 - 4/3 p, which compiled JAX fuses into one
// multiply-add and this kernel computes as the plain version does, in
// float64 rounded once to float32; with IEEE division and square root and
// the library's logf, so the result is bit for bit the plain version's on
// the card: NaN and inf fall where they fall there (0 / 0, a log of 0 or
// less).  The partials are added in int32, which is exact, so their order
// does not matter.
//
// Bound.  Bytes: 4 B a cell of each counter row the form reads, of each
// partial, and 4 B a cell written, at 3.35 TB/s; a few dozen float
// operations a cell, below the card's float32 rate.  A read-once stream
// below the ridge: what counts is the bytes in flight (about 2.3 MB at
// 3.35 TB/s and 0.7 us of latency, 18 KB an SM).
//
// Design: a persistent grid (the kernel's occupancy times the SMs) walks
// chunks of THREADS x UNROLL quads of cells of each segment (the whole
// block, or a row of a window).  A thread issues all its loads of a trip,
// UNROLL 16-byte loads of each row it reads of the first one or two
// partials, before any math, with streaming hints (read once: __ldcs;
// written once: __stcs), which plain loads and stores lose to.  The bytes
// in flight come from occupancy: one quad a row a trip keeps a thread at
// 31-44 registers, five to eight blocks an SM (k80's one partial: 48 B a
// thread in flight); 2 or 4 quads a trip held more registers, left fewer
// warps to hide the math's latency, and lost (scripts/k8_variants.py).
// Where every input row has the same offset modulo 16 B, a segment takes
// a scalar head of up to three cells, then quads, then a tail; an output
// row whose offset differs from its inputs' stores a quad as four cells.
// Inputs whose offsets differ take 4-byte loads, UNROLL x 4 cells a
// thread a trip.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 1;                   // quads a thread a trip, a row
constexpr int SP_MAX = 8;                   // partials a launch
constexpr long long QPC = THREADS * UNROLL;  // quads a chunk
constexpr long long CPC = 4 * QPC;           // cells a chunk
constexpr int MAX_DEVICES = 64;

enum Form { DIFF = 0, RAW = 1, JC69 = 2, K80 = 3, TN93 = 4 };

template <int FORM>
__host__ __device__ constexpr int rows_read() {
  return FORM == DIFF ? 1 : FORM == K80 ? 3 : 2;
}

struct Args {
  const int32_t* rows[SP_MAX][3];  // partial p's rows the form reads, in order
  float* out;                      // the window's first cell
  long long len;                   // cells a segment
  long long in_stride;             // cells from a segment's inputs to the next's
  long long out_stride;            // and of its output
  long long chunks;                // chunks a segment
  long long items;                 // segments x chunks
  int sp;                          // partials
};

// The estimate of one cell from its counters as float32 (a, b, c: the
// form's rows in order).
template <int FORM>
__device__ __forceinline__ float estimate_of(float a, float b, float c) {
  if (FORM == DIFF) return a;
  if (FORM == RAW || FORM == JC69) {
    // a diff, b same
    const float p = __fdiv_rn(a, __fadd_rn(b, a));
    if (FORM == RAW) return p;
    // 1 - 4/3 p rounded once, as XLA fuses it; the plain version's float64
    // expression, so the two agree bit for bit
    const float d = __double2float_rn(
        __dsub_rn(1.0, __dmul_rn((double)(4.0f / 3.0f), (double)p)));
    return __fmul_rn(-0.75f, logf(d));
  }
  if (FORM == K80) {
    // a same, b ts, c tv
    const float count_l = __fadd_rn(__fadd_rn(a, b), c);
    const float p = __fdiv_rn(b, count_l);
    const float q = __fdiv_rn(c, count_l);
    const float u = __fsub_rn(__fsub_rn(1.0f, __fmul_rn(2.0f, p)), q);
    const float v = __fsqrt_rn(__fsub_rn(1.0f, __fmul_rn(2.0f, q)));
    return __fmul_rn(-0.5f, logf(__fmul_rn(u, v)));
  }
  // a kk, b same
  return __fdiv_rn(__fsub_rn(a, b), a);
}

template <int FORM>
__device__ __forceinline__ float estimate_int(const int (&s)[3]) {
  return estimate_of<FORM>(__int2float_rn(s[0]),
                           rows_read<FORM>() > 1 ? __int2float_rn(s[1]) : 0.f,
                           rows_read<FORM>() > 2 ? __int2float_rn(s[2]) : 0.f);
}

// The counters of one cell summed over the partials: s[r] row r's sum.
template <int R>
__device__ __forceinline__ void cell_sum(const Args& a, long long e, int p,
                                         int (&s)[3]) {
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = __ldcs(a.rows[p][r] + e);
}

// N cells of a segment, first + k step for k < N, those below end: PB 1,
// the one partial; PB 2, the loads of the first two partials all issued
// before their sums, then one partial at a time.
template <int FORM, int PB, int N>
__device__ __forceinline__ void cells(const Args& a, long long e0, float* out,
                                      long long first, long long step,
                                      long long end) {
  constexpr int R = rows_read<FORM>();
  int s[N][3] = {};
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (first + k * step < end) cell_sum<R>(a, e0 + first + k * step, 0, s[k]);
  if (PB == 2) {
    int t[N][3] = {};
    for (int p = 1; p < a.sp; ++p) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (first + k * step < end)
          cell_sum<R>(a, e0 + first + k * step, p, t[k]);
#pragma unroll
      for (int k = 0; k < N; ++k)
#pragma unroll
        for (int r = 0; r < R; ++r) s[k][r] += t[k][r];
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const long long i = first + k * step;
    if (i < end) __stcs(out + i, estimate_int<FORM>(s[k]));
  }
}

// Partial p's quads q0 + u THREADS (u < UNROLL) below `quads` of each row
// the form reads, from the segment's aligned cells at e.
template <int R>
__device__ __forceinline__ void quad_loads(const Args& a, long long e, int p,
                                           long long q0, long long quads,
                                           int4 (&v)[R][UNROLL]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int4* row = reinterpret_cast<const int4*>(a.rows[p][r] + e);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long q = q0 + (long long)u * THREADS;
      v[r][u] = q < quads ? __ldcs(row + q) : make_int4(0, 0, 0, 0);
    }
  }
}

// The quads q0 + u THREADS (u < UNROLL) below `quads` of a segment whose
// aligned cells start at `head`: PB 1, the one partial's loads; PB 2, the
// loads of the first two partials all issued before their sums, then one
// partial at a time; out_vec: the output's quads are aligned too, else a
// quad is stored as four cells.
template <int FORM, int PB>
__device__ __forceinline__ void quads_of(const Args& a, long long e0,
                                         float* out, long long head,
                                         long long q0, long long quads,
                                         bool out_vec) {
  constexpr int R = rows_read<FORM>();
  int4 s[R][UNROLL];
  quad_loads<R>(a, e0 + head, 0, q0, quads, s);
  if (PB == 2) {
    int4 t[R][UNROLL];
    quad_loads<R>(a, e0 + head, 1, q0, quads, t);
    for (int p = 2;; ++p) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          s[r][u] = make_int4(s[r][u].x + t[r][u].x, s[r][u].y + t[r][u].y,
                              s[r][u].z + t[r][u].z, s[r][u].w + t[r][u].w);
      if (p == a.sp) break;
      quad_loads<R>(a, e0 + head, p, q0, quads, t);
    }
  }
  float* o = out + head;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long q = q0 + (long long)u * THREADS;
    if (q >= quads) continue;
    int c[4][3] = {};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c[0][r] = s[r][u].x;
      c[1][r] = s[r][u].y;
      c[2][r] = s[r][u].z;
      c[3][r] = s[r][u].w;
    }
    const float4 e =
        make_float4(estimate_int<FORM>(c[0]), estimate_int<FORM>(c[1]),
                    estimate_int<FORM>(c[2]), estimate_int<FORM>(c[3]));
    if (out_vec) {
      __stcs(reinterpret_cast<float4*>(o) + q, e);
    } else {
      __stcs(o + 4 * q, e.x);
      __stcs(o + 4 * q + 1, e.y);
      __stcs(o + 4 * q + 2, e.z);
      __stcs(o + 4 * q + 3, e.w);
    }
  }
}

template <int FORM, int PB, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    estimate_kernel(const __grid_constant__ Args a) {
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const long long seg = item / a.chunks, chunk = item - seg * a.chunks;
    const long long e0 = seg * a.in_stride;
    float* out = a.out + seg * a.out_stride;
    if (!ALIGNED) {
      // every cell with 4-byte loads, UNROLL x 4 a thread
      const long long first = chunk * CPC;
      const long long end = first + CPC < a.len ? first + CPC : a.len;
      cells<FORM, PB, 4 * UNROLL>(a, e0, out, first + threadIdx.x, THREADS,
                                  end);
      continue;
    }
    // the cells before the first 16-byte boundary of the inputs' rows,
    // whole quads, and the cells after the last
    const unsigned off =
        (unsigned)(reinterpret_cast<uintptr_t>(a.rows[0][0] + e0) & 15);
    const long long lead = (long long)(((16u - off) & 15u) >> 2);
    const long long head = lead < a.len ? lead : a.len;
    const long long quads = (a.len - head) >> 2;
    if (chunk == 0) {
      // head (threads 0-2) and tail (threads 4-6), a cell each
      const long long tail0 = head + 4 * quads;
      const int t = threadIdx.x;
      const long long i = t < 4 ? t : tail0 + (t - 4);
      if ((t < 4 && i < head) || (t >= 4 && t < 8 && i < a.len))
        cells<FORM, PB, 1>(a, e0, out, i, 0, i + 1);
    }
    const bool out_vec =
        (reinterpret_cast<uintptr_t>(out) & 15) == (uintptr_t)off;
    quads_of<FORM, PB>(a, e0, out, head, chunk * QPC + threadIdx.x, quads,
                       out_vec);
  }
}

// The persistent grid of one kernel on the current device: its resident
// blocks an SM times the SMs, kept after the first query.
template <int FORM, int PB, bool ALIGNED>
int grid_cap() {
  static int cap[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 0;
  if (cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, estimate_kernel<FORM, PB, ALIGNED>, THREADS, 0) !=
            cudaSuccess)
      return 0;
    cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cap[dev];
}

template <int FORM, int PB, bool ALIGNED>
int launch(const Args& a, cudaStream_t s) {
  const int cap = grid_cap<FORM, PB, ALIGNED>();
  if (cap == 0) {
    const cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? (int)e : (int)cudaErrorUnknown;
  }
  const unsigned grid = (unsigned)(a.items < cap ? a.items : cap);
  estimate_kernel<FORM, PB, ALIGNED><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// One partial, or more; inputs that share their offset modulo 16 B
// (aligned), or not.
template <int FORM>
int launch(const Args& a, bool aligned, cudaStream_t s) {
  if (a.sp == 1)
    return aligned ? launch<FORM, 1, true>(a, s) : launch<FORM, 1, false>(a, s);
  return aligned ? launch<FORM, 2, true>(a, s) : launch<FORM, 2, false>(a, s);
}

}  // namespace

// The estimates in form `form` (0 diff, 1 raw, 2 jc69, 3 k80, 4 tn93) of
// the sum of `sp` (1 to 8) site partials of an m x cols block: rows[3 p +
// k] the device address of partial p's k-th counter row of the form
// (diff; diff, same; diff, same; same, ts, tv; kk, same; a row the form
// does not read may repeat the first), each m x cols contiguous int32;
// out the device address of an (m, ld) float32 matrix on the same device,
// whose columns col0 .. col0 + cols take the estimates (ld >= col0 +
// cols).  Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int dt_estimate_partials_launch(int form, const void* const* rows,
                                           int sp, long long m,
                                           long long cols, void* out,
                                           long long ld, long long col0,
                                           void* stream) {
  if (form < DIFF || form > TN93 || sp < 1 || sp > SP_MAX || m < 0 ||
      cols < 0 || col0 < 0 || ld < col0 + cols || rows == nullptr)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || cols == 0) return (int)cudaSuccess;
  Args a = {};
  uintptr_t offsets = 0, first = 0;
  for (int p = 0; p < sp; ++p)
    for (int k = 0; k < 3; ++k) {
      const void* r = rows[3 * p + k];
      if (r == nullptr) return (int)cudaErrorInvalidValue;
      a.rows[p][k] = static_cast<const int32_t*>(r);
      const uintptr_t off = reinterpret_cast<uintptr_t>(r) & 15;
      if (p == 0 && k == 0) first = off;
      offsets |= off ^ first;
    }
  a.sp = sp;
  a.out = static_cast<float*>(out) + col0;
  if (ld == cols) {
    // the whole output: one segment of every cell
    a.len = m * cols;
    a.in_stride = a.out_stride = 0;
    a.chunks = (a.len + CPC - 1) / CPC;
    a.items = a.chunks;
  } else {
    // a window: a segment a row
    a.len = cols;
    a.in_stride = cols;
    a.out_stride = ld;
    a.chunks = (cols + CPC - 1) / CPC;
    a.items = m * a.chunks;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = offsets == 0;
  switch (form) {
    case DIFF: return launch<DIFF>(a, aligned, s);
    case RAW: return launch<RAW>(a, aligned, s);
    case JC69: return launch<JC69>(a, aligned, s);
    case K80: return launch<K80>(a, aligned, s);
    default: return launch<TN93>(a, aligned, s);
  }
}

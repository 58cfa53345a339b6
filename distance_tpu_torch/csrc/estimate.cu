// Distance estimate epilogue for Hopper (sm_90a): (G, m, n) int32
// counters -> (m, n) float32 estimates of one measure.
//
// Replaces the in-graph estimate of the JAX package's
// distance_tpu/parallel/mesh.py::sharded_step (mesh.py:96-111), which its
// dry run computes after the sharded counters.  With c the counters as
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
// less).
//
// Bound.  Bytes: 4 m n bytes of each counter row read and 4 m n written,
// at 3.35 TB/s; a handful of float operations a cell.
//
// Design: one elementwise pass, a grid-stride loop over the cells; where
// every row and the output start on a 16-byte boundary (rows of a
// contiguous block of counters whose cells are a multiple of 4), a thread
// takes four consecutive cells with one 16-byte load of each row it reads
// and one 16-byte store, else a cell with 4-byte ones.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

enum Form { DIFF = 0, RAW = 1, JC69 = 2, K80 = 3, TN93 = 4 };

struct Rows {
  const int32_t* r[3];  // the counter rows the form reads, in its order
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
__device__ __forceinline__ float cell(const Rows& rows, long long i) {
  const float a = __int2float_rn(__ldg(rows.r[0] + i));
  const float b = FORM == DIFF ? 0.f : __int2float_rn(__ldg(rows.r[1] + i));
  const float c = FORM == K80 ? __int2float_rn(__ldg(rows.r[2] + i)) : 0.f;
  return estimate_of<FORM>(a, b, c);
}

__device__ __forceinline__ float4 to_float4(int4 v) {
  return make_float4(__int2float_rn(v.x), __int2float_rn(v.y),
                     __int2float_rn(v.z), __int2float_rn(v.w));
}

// VEC: every row and the output start on a 16-byte boundary, so a thread
// takes four cells with one 16-byte load a row and one store (four times
// the bytes in flight of a cell a thread); the last cells % 4 one by one.
template <int FORM, bool VEC>
__global__ void __launch_bounds__(THREADS)
    estimate_kernel(const __grid_constant__ Rows rows, long long cells,
                    float* __restrict__ out) {
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  long long done = 0;
  if (VEC) {
    const long long quads = cells >> 2;
    const int4* r0 = reinterpret_cast<const int4*>(rows.r[0]);
    const int4* r1 = reinterpret_cast<const int4*>(rows.r[1]);
    const int4* r2 = reinterpret_cast<const int4*>(rows.r[2]);
    for (long long q = first; q < quads; q += stride) {
      const float4 a = to_float4(__ldg(r0 + q));
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f), c = b;
      if (FORM != DIFF) b = to_float4(__ldg(r1 + q));
      if (FORM == K80) c = to_float4(__ldg(r2 + q));
      reinterpret_cast<float4*>(out)[q] = make_float4(
          estimate_of<FORM>(a.x, b.x, c.x), estimate_of<FORM>(a.y, b.y, c.y),
          estimate_of<FORM>(a.z, b.z, c.z), estimate_of<FORM>(a.w, b.w, c.w));
    }
    done = quads << 2;
  }
  for (long long i = done + first; i < cells; i += stride)
    out[i] = cell<FORM>(rows, i);
}

template <int FORM>
void launch(const Rows& rows, long long cells, float* out, bool vec,
            unsigned grid, cudaStream_t s) {
  if (vec)
    estimate_kernel<FORM, true><<<grid, THREADS, 0, s>>>(rows, cells, out);
  else
    estimate_kernel<FORM, false><<<grid, THREADS, 0, s>>>(rows, cells, out);
}

}  // namespace

// Estimates of `cells` cells (m n) in form `form` (0 diff, 1 raw, 2 jc69,
// 3 k80, 4 tn93): rows[k] the device address of the form's k-th counter
// row (diff; diff, same; diff, same; same, ts, tv; kk, same), each `cells`
// contiguous int32; out `cells` float32 on the same device.  Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int dt_estimate_launch(int form, const void* row0,
                                  const void* row1, const void* row2,
                                  long long cells, void* out, void* stream) {
  if (form < DIFF || form > TN93 || cells < 0)
    return (int)cudaErrorInvalidValue;
  if (cells == 0) return (int)cudaSuccess;
  Rows rows = {{static_cast<const int32_t*>(row0),
                static_cast<const int32_t*>(row1),
                static_cast<const int32_t*>(row2)}};
  const bool vec = ((uintptr_t)row0 | (uintptr_t)row1 | (uintptr_t)row2 |
                    (uintptr_t)out) % 16 == 0;
  long long blocks = ((vec ? cells / 4 : cells) + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  const unsigned grid = (unsigned)blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (form) {
    case DIFF: launch<DIFF>(rows, cells, o, vec, grid, s); break;
    case RAW: launch<RAW>(rows, cells, o, vec, grid, s); break;
    case JC69: launch<JC69>(rows, cells, o, vec, grid, s); break;
    case K80: launch<K80>(rows, cells, o, vec, grid, s); break;
    default: launch<TN93>(rows, cells, o, vec, grid, s); break;
  }
  return (int)cudaGetLastError();
}

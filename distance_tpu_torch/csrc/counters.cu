// Pairwise counter kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel distance_tpu/ops/pairwise_pallas.py::_kernel
// (launched by counters_pallas): every integer counter of one measure for
// every (x, y) pair of two uint8 Paradis-code matrices, out (G, m, n)
// int32, exact.  Every counter is a sum over sites and feature channels of
// f_k(x) * g_k(y) with features in {-1, 0, 1} (distance_tpu/ops/features.py).
//
// Design.  One block owns a TI x TJ tile of pairs and loops over all sites
// itself; that loop takes the place of the TPU kernel's sequential site
// grid axis.  Per chunk of KC sites the block builds the int8 features of
// every channel for its TI x rows and TJ y rows by lookup in the two
// (R, 256) tables, which sit in shared memory (the TPU built them with bit
// ops because it has no fast gather), packing four sites per 32-bit word.
// Each thread then accumulates a 4 x 4 micro-tile of pairs with __dp4a
// into int32 registers.  A per-counter plan sums its counter's channel
// range into one accumulator; a shared plan (k80, tn93) keeps one
// accumulator per channel, and the epilogue takes the integer mix and
// divides it exactly (every numerator is even per site).  Code 0 (padding)
// has a zero feature in every channel on both sides, so the ragged edges
// are masked by loading code 0: any m, n >= 0 and any length >= 0.
//
// Bound.  Integer throughput: R channels cost R/4 dp4a per pair per four
// sites, and each thread's 4 x 4 micro-tile reads 2 bytes of shared memory
// per dp4a.  The tensor cores do none of the work.  Later work should
// recast this as an int8 GEMM with K = channels x sites (mma.sync or
// wgmma over feature tiles), which is how the TPU's XLA path runs it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TI = 64;           // x rows per block
constexpr int TJ = 64;           // y rows per block
constexpr int KC = 16;           // sites per chunk
constexpr int KW = KC / 4;       // feature words per row and chunk
constexpr int THREADS = 256;     // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int MAX_CHANNELS = 32;
constexpr int MAX_ACC = 6;
constexpr int MAX_G = 4;

static_assert(KW == 4, "a row's chunk of features is one uint4");
static_assert(THREADS == TI * KW && THREADS == TJ * KW,
              "one feature word per thread and side");

struct Mix {
  int bounds[MAX_ACC + 1];   // accumulator a sums channels bounds[a]..bounds[a+1]-1
  int mix[MAX_G][MAX_ACC];   // counter g = sum_a mix[g][a] * acc[a] / den[g]
  int den[MAX_G];
  int channels;
  int counters;
};

size_t smem_bytes(int channels) {
  return (size_t)channels * ((TI + TJ) * KW * 4 + 2 * 256);
}

__device__ __forceinline__ uint32_t feature_word(const uint8_t* lut,
                                                 uint32_t codes) {
  return (uint32_t)lut[codes & 255] | ((uint32_t)lut[(codes >> 8) & 255] << 8) |
         ((uint32_t)lut[(codes >> 16) & 255] << 16) |
         ((uint32_t)lut[codes >> 24] << 24);
}

template <int A>
__global__ void __launch_bounds__(THREADS)
counters_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
                int m, int n, long long len, long long ldx, long long ldy,
                const int8_t* __restrict__ f_lut,
                const int8_t* __restrict__ g_lut, Mix p,
                int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = p.channels;
  uint4* xs = reinterpret_cast<uint4*>(smem);   // [R][TI]: KC features per row
  uint4* ys = xs + R * TI;                      // [R][TJ]
  uint8_t* flut = reinterpret_cast<uint8_t*>(ys + R * TJ);  // [R][256]
  uint8_t* glut = flut + R * 256;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.y * TI;
  const int j0 = blockIdx.x * TJ;

  for (int e = tid; e < R * 256; e += THREADS) {
    flut[e] = (uint8_t)f_lut[e];
    glut[e] = (uint8_t)g_lut[e];
  }

  int acc[A][4][4];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][r][c] = 0;

  // Feature build: this thread fills word `bw` of row `br` on both sides.
  const int br = tid / KW;
  const int bw = tid % KW;
  const bool x_ok = i0 + br < m;
  const bool y_ok = j0 + br < n;
  const uint8_t* xrow = x + (long long)(x_ok ? i0 + br : 0) * ldx;
  const uint8_t* yrow = y + (long long)(y_ok ? j0 + br : 0) * ldy;

  for (long long s0 = 0; s0 < len; s0 += KC) {
    __syncthreads();  // the tables are filled; the last chunk is consumed
    uint32_t cx = 0, cy = 0;
    const long long s = s0 + bw * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (s + q < len) {
        if (x_ok) cx |= (uint32_t)xrow[s + q] << (8 * q);
        if (y_ok) cy |= (uint32_t)yrow[s + q] << (8 * q);
      }
    }
    for (int k = 0; k < R; ++k) {
      reinterpret_cast<uint32_t*>(xs + k * TI + br)[bw] =
          feature_word(flut + k * 256, cx);
      reinterpret_cast<uint32_t*>(ys + k * TJ + br)[bw] =
          feature_word(glut + k * 256, cy);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < A; ++a) {
      for (int k = p.bounds[a]; k < p.bounds[a + 1]; ++k) {
        uint4 xv[4], yv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = xs[k * TI + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) yv[c] = ys[k * TJ + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            int v = acc[a][r][c];
            v = __dp4a((int)xv[r].x, (int)yv[c].x, v);
            v = __dp4a((int)xv[r].y, (int)yv[c].y, v);
            v = __dp4a((int)xv[r].z, (int)yv[c].z, v);
            v = __dp4a((int)xv[r].w, (int)yv[c].w, v);
            acc[a][r][c] = v;
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (i >= m || j >= n) continue;
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= p.counters) break;
        long long num = 0;
#pragma unroll
        for (int a = 0; a < A; ++a)
          num += (long long)p.mix[g][a] * acc[a][r][c];
        out[((long long)g * m + i) * n + j] = (int32_t)(num / p.den[g]);
      }
    }
  }
}

template <int A>
cudaError_t launch(const uint8_t* x, const uint8_t* y, int m, int n,
                   long long len, long long ldx, long long ldy,
                   const int8_t* f_lut, const int8_t* g_lut, const Mix& p,
                   int32_t* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.channels);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        counters_kernel<A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((n + TJ - 1) / TJ, (m + TI - 1) / TI);
  counters_kernel<A><<<grid, THREADS, smem, stream>>>(
      x, y, m, n, len, ldx, ldy, f_lut, g_lut, p, out);
  return cudaGetLastError();
}

}  // namespace

// Counters of every (x, y) pair: x (m, len) and y (n, len) uint8 with row
// strides ldx/ldy, LUTs (channels, 256) int8, out (counters, m, n) int32,
// all on the device.  bounds (accumulators + 1), mix (counters x
// accumulators, row-major) and den (counters) are host int arrays.
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int dt_counters_launch(const void* x, const void* y, long long m,
                                  long long n, long long len, long long ldx,
                                  long long ldy, const void* f_lut,
                                  const void* g_lut, int channels,
                                  int accumulators, int counters,
                                  const void* bounds, const void* mix,
                                  const void* den, void* out, void* stream) {
  if (m < 0 || n < 0 || len < 0 || m > 65535LL * TI || n > 0x7fffffffLL ||
      channels < 1 || channels > MAX_CHANNELS || accumulators < 1 ||
      accumulators > MAX_ACC || counters < 1 || counters > MAX_G)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return (int)cudaSuccess;
  Mix p = {};
  const int* b = static_cast<const int*>(bounds);
  const int* w = static_cast<const int*>(mix);
  const int* d = static_cast<const int*>(den);
  for (int a = 0; a <= accumulators; ++a) p.bounds[a] = b[a];
  if (p.bounds[0] != 0 || p.bounds[accumulators] != channels)
    return (int)cudaErrorInvalidValue;
  for (int a = 0; a < accumulators; ++a)
    if (p.bounds[a + 1] <= p.bounds[a]) return (int)cudaErrorInvalidValue;
  for (int g = 0; g < counters; ++g) {
    if (d[g] <= 0) return (int)cudaErrorInvalidValue;
    p.den[g] = d[g];
    for (int a = 0; a < accumulators; ++a)
      p.mix[g][a] = w[g * accumulators + a];
  }
  p.channels = channels;
  p.counters = counters;
  const auto* xp = static_cast<const uint8_t*>(x);
  const auto* yp = static_cast<const uint8_t*>(y);
  const auto* fl = static_cast<const int8_t*>(f_lut);
  const auto* gl = static_cast<const int8_t*>(g_lut);
  auto* op = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int mi = (int)m, ni = (int)n;
  cudaError_t e;
  switch (accumulators) {
    case 1: e = launch<1>(xp, yp, mi, ni, len, ldx, ldy, fl, gl, p, op, st); break;
    case 2: e = launch<2>(xp, yp, mi, ni, len, ldx, ldy, fl, gl, p, op, st); break;
    case 3: e = launch<3>(xp, yp, mi, ni, len, ldx, ldy, fl, gl, p, op, st); break;
    case 4: e = launch<4>(xp, yp, mi, ni, len, ldx, ldy, fl, gl, p, op, st); break;
    case 5: e = launch<5>(xp, yp, mi, ni, len, ldx, ldy, fl, gl, p, op, st); break;
    default: e = launch<6>(xp, yp, mi, ni, len, ldx, ldy, fl, gl, p, op, st); break;
  }
  return (int)e;
}

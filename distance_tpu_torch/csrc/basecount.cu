// Base count for Hopper (sm_90a): each row's tallies of the codes A, T, G
// and C, in that order.
//
// Replaces the JAX package's distance_tpu/ops/pairwise_xla.py::
// base_counts_device (pairwise_xla.py:99), the tn93 precompute as a device
// reduction: codes (m, len) uint8 with row stride ld -> out (m, 4) int32,
// contiguous.  A row of width 0 counts zeros.  int32 is exact for any
// width below 2^31.
//
// Bound.  Bytes: m len bytes read once and 16 m written, at 3.35 TB/s;
// four byte compares a code are far below the card's integer rate.
//
// Design: one CTA a row (a grid-stride loop over rows past the grid),
// its threads a power of two from 32 to 256 sized to the row, so that a
// narrow row does not hold 256 idle threads.  A row may start anywhere
// (rows are slices at any stride): its bytes before the first 16-byte
// boundary and after the last are counted one by one, the rest with one
// 16-byte load a thread a step, consecutive threads on consecutive words.
// A word of four codes is compared with each base's code in every byte at
// once (__vcmpeq4: 0xff in each equal byte), and the set bits counted.
// Each thread keeps four counters in registers; a warp adds them with
// shuffles, and the warps' sums meet in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;
// A, T, G, C in every byte of a word (distance_tpu_torch/encoding.py).
constexpr uint32_t CODE_A = 0x88888888u, CODE_T = 0x18181818u,
                   CODE_G = 0x48484848u, CODE_C = 0x28282828u;

struct Counts {
  int a, t, g, c;
};

__device__ __forceinline__ void count_word(Counts& n, uint32_t w) {
  n.a += __popc(__vcmpeq4(w, CODE_A)) >> 3;
  n.t += __popc(__vcmpeq4(w, CODE_T)) >> 3;
  n.g += __popc(__vcmpeq4(w, CODE_G)) >> 3;
  n.c += __popc(__vcmpeq4(w, CODE_C)) >> 3;
}

__device__ __forceinline__ void count_byte(Counts& n, uint8_t b) {
  n.a += b == (uint8_t)CODE_A;
  n.t += b == (uint8_t)CODE_T;
  n.g += b == (uint8_t)CODE_G;
  n.c += b == (uint8_t)CODE_C;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__global__ void __launch_bounds__(MAX_THREADS)
    base_counts_kernel(const uint8_t* __restrict__ codes, long long m,
                       long long len, long long ld, int32_t* __restrict__ out) {
  __shared__ int part[MAX_THREADS / 32][4];
  const int tid = threadIdx.x, threads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = threads >> 5;
  for (long long row = blockIdx.x; row < m; row += gridDim.x) {
    const uint8_t* p = codes + row * ld;
    Counts n = {0, 0, 0, 0};
    // bytes before the first 16-byte boundary, then whole words, then
    // the bytes after the last
    const long long lead = (long long)((16 - ((uintptr_t)p & 15)) & 15);
    const long long head = lead < len ? lead : len;
    const long long words = (len - head) >> 4;
    const uint4* q = reinterpret_cast<const uint4*>(p + head);
    for (long long b = tid; b < head; b += threads) count_byte(n, __ldg(p + b));
    for (long long k = tid; k < words; k += threads) {
      const uint4 v = __ldg(q + k);
      count_word(n, v.x);
      count_word(n, v.y);
      count_word(n, v.z);
      count_word(n, v.w);
    }
    const uint8_t* tail = p + head + (words << 4);
    const long long rest = len - head - (words << 4);
    for (long long b = tid; b < rest; b += threads)
      count_byte(n, __ldg(tail + b));
    n.a = warp_sum(n.a);
    n.t = warp_sum(n.t);
    n.g = warp_sum(n.g);
    n.c = warp_sum(n.c);
    if (lane == 0) {
      part[warp][0] = n.a;
      part[warp][1] = n.t;
      part[warp][2] = n.g;
      part[warp][3] = n.c;
    }
    __syncthreads();
    if (tid < 4) {
      int s = 0;
      for (int w = 0; w < warps; ++w) s += part[w][tid];
      out[row * 4 + tid] = s;
    }
    __syncthreads();  // part is written again for the next row
  }
}

}  // namespace

// Tallies of A, T, G and C of each row: codes (m, len) uint8 with row
// stride ld (>= len) on the device, out (m, 4) int32 contiguous on the
// same device.  Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int dt_base_counts_launch(const void* codes, long long m,
                                     long long len, long long ld, void* out,
                                     void* stream) {
  if (m < 0 || len < 0 || ld < len || len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  int threads = 32;
  while (threads < MAX_THREADS && (long long)threads * 16 < len) threads *= 2;
  const long long grid = m < (1LL << 30) ? m : (1LL << 30);
  base_counts_kernel<<<(unsigned)grid, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), m, len, ld,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// Diff rebuild for Hopper (sm_90a): a code matrix on the card from a
// reference row and the (index, code) pairs where the matrix differs.
//
// Replaces the TPU device function distance_tpu/ops/diffup.py::_build_fn
// (diffup.py:74) and the same rebuild inside the JAX engine's fused stream
// function (engine.py:819-825): out (rows, l_pad) uint8 is the reference
// row (l_pad) broadcast to every row, then vals[k] written at the flat
// index idx[k] for each k with 0 <= idx[k] < rows * l_pad.  The encoder
// gives sorted, unique indices and pads its capacity with a strictly
// increasing tail at and past rows * l_pad, which is dropped.  Rows past
// the real ones (padding) hold the reference row, as in the JAX package.
//
// Bound.  Bytes: rows x l_pad bytes written once, 5 bytes a diff (an int32
// index and a code) and the l_pad-byte reference read once; no arithmetic
// to speak of, so it is bound by memory.
//
// Design, simple first: one pass writes the reference into every row in
// 16-byte stores (l_pad is a multiple of 16; the reference row stays in the
// caches), then one thread a diff stores its code.  The indices are
// unique, so no two threads write one byte and no atomics are needed; the
// passes run in order on one stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1LL << 20;

__global__ void fill_rows(const uint4* ref, long long row_words,
                          long long words, uint4* out) {
  for (long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       w < words; w += (long long)gridDim.x * blockDim.x)
    out[w] = ref[w % row_words];
}

__global__ void scatter_diffs(const int32_t* idx, const uint8_t* vals,
                              long long cap, long long total, uint8_t* out) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < cap; k += (long long)gridDim.x * blockDim.x) {
    const long long i = idx[k];
    if (i >= 0 && i < total) out[i] = vals[k];
  }
}

unsigned grid_for(long long work) {
  const long long blocks = (work + THREADS - 1) / THREADS;
  return (unsigned)(blocks < MAX_BLOCKS ? (blocks > 0 ? blocks : 1)
                                        : MAX_BLOCKS);
}

}  // namespace

// out (rows, l_pad) uint8 from ref (l_pad) uint8 and the cap diffs idx
// int32 / vals uint8, all on the device (ref and out 16-byte aligned,
// l_pad a multiple of 16).  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.
extern "C" int dt_diff_rebuild_launch(const void* ref, const void* idx,
                                      const void* vals, long long cap,
                                      long long rows, long long l_pad,
                                      void* out, void* stream) {
  if (rows < 0 || l_pad < 0 || cap < 0 || l_pad % 16 ||
      (uintptr_t)ref % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long words = rows * l_pad / 16;
  if (words)
    fill_rows<<<grid_for(words), THREADS, 0, st>>>(
        static_cast<const uint4*>(ref), l_pad / 16, words,
        static_cast<uint4*>(out));
  if (cap && words)
    scatter_diffs<<<grid_for(cap), THREADS, 0, st>>>(
        static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(vals),
        cap, rows * l_pad, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// Diff rebuild for Hopper (sm_90a): a code matrix on the card from a
// reference row and the (index, code) pairs where the matrix differs.
//
// Replaces the TPU device function distance_tpu/ops/diffup.py::_build_fn
// (diffup.py:74) and the same rebuild inside the JAX engine's fused stream
// function (engine.py:819-825): out (rows, l_pad) uint8 is the reference
// row (l_pad) broadcast to every row, then vals[k] written at the flat
// index idx[k] for each k with 0 <= idx[k] < rows * l_pad.  As the JAX
// scatter is told (indices_are_sorted, unique_indices), the indices must be
// sorted and unique: the encoder gives them so, and pads its capacity with
// a strictly increasing tail at and past rows * l_pad, which is dropped, as
// are negative indices.  Rows past the real ones (padding) hold the
// reference row, as in the JAX package.
//
// Bound.  Bytes: rows x l_pad bytes written once, 5 bytes a diff (an int32
// index and a code) read once; no arithmetic to speak of, so it is bound by
// the memory's write rate.
//
// Design: one launch, and every output byte written to device memory once,
// in whole 16-byte words.  The output is one flat run of 16-byte words cut
// into equal parts, one a CTA (whole 128-byte lines), and a part into tiles
// of 16 KiB; a grid of as many CTAs as the card holds at once (no grid axis
// carries the row count).  A CTA finds the first diff of its part once,
// with a search of 256 probes a round, and then walks its tiles and the
// sorted diffs together, each diff read once by one CTA.  A tile is built
// in shared memory: the reference words (the column of a word steps by
// the tile's width and wraps with a compare, no modulo), the tile's diffs
// stored over them as bytes (the indices are unique, so no two threads
// write one byte), then the tile stored in coalesced 16-byte words, marked
// evict-first: the output streams through the L2 once.  Three tile buffers
// let the next tile's reference words be written while this tile is
// stored, with one barrier a tile.  The diffs come in chunks of 1024 held
// in registers, the next chunk loaded while this one is used.
//
// Measured (scripts/k3_variants.py, PERF.md): evict-first stores and 16 KiB
// tiles each took time off 8 KiB tiles stored write-back, and together
// they are as fast as any variant tried (TMA bulk stores among them); what
// is left is the card's write rate, which a plain fill_ of the same bytes
// does not exceed by more than about a tenth.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WORDS = 4;                     // 16-byte words a thread a tile
constexpr int TILE_WORDS = THREADS * WORDS;  // 1024 words: a 16 KiB tile
constexpr int STAGES = 3;                    // tile buffers
constexpr int PER_THREAD = 4;                // diffs a thread holds a chunk
constexpr int CHUNK = THREADS * PER_THREAD;  // diffs a chunk
constexpr int LINE_WORDS = 8;                // a CTA's part: whole lines
constexpr int MAX_DEVICES = 64;

struct Chunk {
  int32_t idx[PER_THREAD];
  uint8_t val[PER_THREAD];
  long long last;  // the chunk's last index; LLONG_MAX if it holds the end
};

__device__ __forceinline__ void load_chunk(Chunk& c, const int32_t* idx,
                                           const uint8_t* vals, long long cap,
                                           long long q) {
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long e = q + k * THREADS + threadIdx.x;
    const bool in = e < cap;
    c.idx[k] = in ? __ldg(idx + e) : -1;  // -1 lies in no tile
    c.val[k] = in ? __ldg(vals + e) : 0;
  }
  c.last = q + CHUNK <= cap ? (long long)__ldg(idx + q + CHUNK - 1)
                            : LLONG_MAX;
}

__global__ void __launch_bounds__(THREADS)
    diff_rebuild_tiles(const uint4* __restrict__ ref,
                       const int32_t* __restrict__ idx,
                       const uint8_t* __restrict__ vals, long long cap,
                       long long words, int row_words, long long part_words,
                       uint4* __restrict__ out) {
  __shared__ uint4 buf[STAGES][TILE_WORDS];
  const int t = threadIdx.x;
  const long long w0 = blockIdx.x * part_words;
  if (w0 >= words) return;
  const long long w1 = min(words, w0 + part_words);

  // The first diff at or past the part's first byte: each round probes
  // THREADS evenly spaced indices of [lo, hi) and keeps the gap between
  // the last probe below the target and the first one not below it.
  long long lo = 0, hi = cap;
  while (lo < hi) {
    const long long step = (hi - lo + THREADS - 1) / THREADS;
    const long long p = lo + t * step;
    const int below =
        __syncthreads_count(p < hi && (long long)__ldg(idx + p) < w0 * 16);
    const long long next_lo = below ? lo + (below - 1) * step + 1 : lo;
    hi = min(hi, lo + below * step);
    lo = next_lo;
  }
  long long q = lo;
  Chunk cur, nxt;
  load_chunk(cur, idx, vals, cap, q);
  load_chunk(nxt, idx, vals, cap, q + CHUNK);

  // The reference column of each of the thread's words of the next tile
  // to build, stepped a tile at a time.
  const int col_step = TILE_WORDS % row_words;
  int col[WORDS];
  const int c0 = (int)(w0 % row_words);
#pragma unroll
  for (int w = 0; w < WORDS; ++w) col[w] = (c0 + w * THREADS + t) % row_words;
  auto build = [&](uint4* b, long long n) {
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      const int j = w * THREADS + t;
      if (j < n) b[j] = __ldg(ref + col[w]);
      col[w] += col_step;
      if (col[w] >= row_words) col[w] -= row_words;
    }
  };

  build(buf[0], min((long long)TILE_WORDS, w1 - w0));
  __syncthreads();
  int s = 0;
  for (long long tw0 = w0; tw0 < w1; tw0 += TILE_WORDS) {
    const int n = (int)min((long long)TILE_WORDS, w1 - tw0);
    const long long first = tw0 * 16;
    const unsigned long long bytes = 16ull * n;
    uint8_t* b8 = reinterpret_cast<uint8_t*>(buf[s]);
    for (;;) {
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const unsigned long long off =
            (unsigned long long)((long long)cur.idx[k] - first);
        if (off < bytes) b8[off] = cur.val[k];
      }
      if (cur.last >= first + (long long)bytes) break;
      cur = nxt;
      q += CHUNK;
      load_chunk(nxt, idx, vals, cap, q + CHUNK);
    }
    const int s1 = s == STAGES - 1 ? 0 : s + 1;
    if (tw0 + TILE_WORDS < w1)
      build(buf[s1], min((long long)TILE_WORDS, w1 - tw0 - TILE_WORDS));
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      const int j = w * THREADS + t;
      if (j < n) __stcs(out + tw0 + j, buf[s][j]);
    }
    s = s1;
  }
}

// CTAs of the kernel an SM holds at once, by device (0 until asked).
std::atomic<int> ctas_per_sm[MAX_DEVICES];

}  // namespace

// out (rows, l_pad) uint8 from ref (l_pad) uint8 and the cap diffs idx
// int32 (sorted, unique) / vals uint8, all on the device (ref and out
// 16-byte aligned, l_pad a multiple of 16).  One kernel launch on `stream`
// (none for an empty output); returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int dt_diff_rebuild_launch(const void* ref, const void* idx,
                                      const void* vals, long long cap,
                                      long long rows, long long l_pad,
                                      void* out, void* stream) {
  if (rows < 0 || l_pad < 0 || cap < 0 || l_pad % 16 ||
      l_pad / 16 >= (1LL << 30) || (uintptr_t)ref % 16 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const long long words = rows * (l_pad / 16);
  if (!words) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int per_sm = dev < MAX_DEVICES ? ctas_per_sm[dev].load() : 0;
  if (!per_sm) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, diff_rebuild_tiles, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (!per_sm) return (int)cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) ctas_per_sm[dev].store(per_sm);
  }
  const long long tiles = (words + TILE_WORDS - 1) / TILE_WORDS;
  long long ctas = (long long)sms * per_sm;
  if (ctas > tiles) ctas = tiles;
  long long part = (words + ctas - 1) / ctas;
  part = (part + LINE_WORDS - 1) / LINE_WORDS * LINE_WORDS;
  ctas = (words + part - 1) / part;
  diff_rebuild_tiles<<<(unsigned)ctas, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ref), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(vals), cap, words, (int)(l_pad / 16), part,
      static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

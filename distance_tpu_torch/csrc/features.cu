// Feature build for Hopper (sm_90a): uint8 Paradis codes -> int8 features
// of every channel of one measure's unfolded plan, one side.
//
// Replaces the JAX package's distance_tpu/ops/features.py::features_device
// (which its engine runs once per prepared matrix and once per strip):
// codes (m, len) with row stride ld -> out (R, m, len) int8, contiguous.
// The x side (f) carries each channel's sign, the y side (g) does not;
// the wrapper passes that side's tables.  Code 0 (padding) gives 0 in every channel on both sides, so
// padding rows and sites add nothing to a later contraction.
//
// Bound.  One elementwise pass: (1 + R) m len bytes (the codes read once,
// R feature planes written once) at 3.35 TB/s; no arithmetic to speak of.
//
// Design.  For a Paradis code (or code 0) the candidacy nibble decides
// every feature (ops/plan.py nibble_tables), so each channel's feature is a
// 16-entry table held in the launch's parameters.  Each thread takes 16
// codes of one row with one 16-byte load, turns each word of four codes
// into a byte-permute selector and a high-bit mask once, then per channel
// writes 16 features with one 16-byte store: two prmt and one select a
// word, no memory gather (the lookup of csrc/counters.cu, copied).
// Consecutive threads take consecutive 16-site pieces of a row, so a
// warp's loads and each channel's stores are 512 contiguous bytes.  Rows
// whose width or stride is not a multiple of 16 take the same lookup with
// byte loads and stores.  Every offset is 64-bit: a cache of 18 channels
// at 8192 x 29952 is 4.4 GB.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_CHANNELS = 32;
constexpr int THREADS = 256;

struct Params {
  const uint8_t* codes;
  long long m, len, ld;
  long long pieces;  // 16-site pieces a row
  int channels;
  uint4 tab[MAX_CHANNELS];  // feature by nibble, 16 int8 a channel
  int8_t* out;
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

// Four features: table[nibble] of each code.
__device__ __forceinline__ uint32_t lookup(const uint4& tab, uint32_t sel,
                                           uint32_t hi) {
  const uint32_t lo = prmt(tab.x, tab.y, sel);
  const uint32_t up = prmt(tab.z, tab.w, sel);
  return (lo & ~hi) | (up & hi);
}

// I: the type of the item index, 32-bit unless the items pass 2^32 (a
// 64-bit division per item would cost more than the item's bytes).
template <bool VEC, typename I>
__global__ void __launch_bounds__(THREADS)
features_kernel(const __grid_constant__ Params p) {
  const I items = (I)(p.m * p.pieces);
  const I pieces = (I)p.pieces;
  const long long plane = p.m * p.len;
  for (I it = (I)blockIdx.x * THREADS + threadIdx.x; it < items;
       it += (I)gridDim.x * THREADS) {
    const I row_i = it / pieces;
    const long long row = (long long)row_i;
    const long long site = (long long)(it - row_i * pieces) * 16;
    const uint8_t* src = p.codes + row * p.ld + site;
    const long long dst = row * p.len + site;
    uint4 cw;
    int width = 16;
    if (VEC) {
      cw = *reinterpret_cast<const uint4*>(src);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      width = p.len - site < 16 ? (int)(p.len - site) : 16;
      for (int b = 0; b < width; ++b)
        w[b >> 2] |= (uint32_t)src[b] << (8 * (b & 3));
      cw = make_uint4(w[0], w[1], w[2], w[3]);
    }
    uint32_t sel[4], hi[4];
    split(cw.x, sel[0], hi[0]);
    split(cw.y, sel[1], hi[1]);
    split(cw.z, sel[2], hi[2]);
    split(cw.w, sel[3], hi[3]);
    for (int k = 0; k < p.channels; ++k) {
      const uint4 tab = p.tab[k];
      const uint4 f = make_uint4(lookup(tab, sel[0], hi[0]),
                                 lookup(tab, sel[1], hi[1]),
                                 lookup(tab, sel[2], hi[2]),
                                 lookup(tab, sel[3], hi[3]));
      int8_t* o = p.out + (long long)k * plane + dst;
      if (VEC) {
        *reinterpret_cast<uint4*>(o) = f;
      } else {
        const uint32_t w[4] = {f.x, f.y, f.z, f.w};
        for (int b = 0; b < width; ++b)
          o[b] = (int8_t)(w[b >> 2] >> (8 * (b & 3)));
      }
    }
  }
}

}  // namespace

// Features of one side: codes (m, len) uint8 with row stride ld (>= len),
// out (channels, m, len) int8 contiguous, both on the device; tables
// (channels x 4) host uint32 words, each channel's 16-entry int8 nibble
// table of this side.  Codes are Paradis codes or 0.  Launches on `stream`
// and returns cudaGetLastError(), or cudaErrorInvalidValue for arguments
// the kernel does not take.
extern "C" int dt_features_launch(const void* codes, long long m,
                                  long long len, long long ld, int channels,
                                  const void* tables, void* out,
                                  void* stream) {
  if (m < 0 || len < 0 || ld < len || channels < 1 ||
      channels > MAX_CHANNELS)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const uint32_t* tab = static_cast<const uint32_t*>(tables);
  for (int k = 0; k < channels; ++k)
    p.tab[k] = make_uint4(tab[4 * k], tab[4 * k + 1], tab[4 * k + 2],
                          tab[4 * k + 3]);
  if (m == 0 || len == 0) return (int)cudaSuccess;
  p.codes = static_cast<const uint8_t*>(codes);
  p.m = m;
  p.len = len;
  p.ld = ld;
  p.pieces = (len + 15) / 16;
  p.channels = channels;
  p.out = static_cast<int8_t*>(out);
  const long long items = m * p.pieces;
  // enough blocks for 16 resident a multiprocessor on 132 of them; each
  // thread walks the rest
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  const bool vec = len % 16 == 0 && ld % 16 == 0 &&
                   (uintptr_t)codes % 16 == 0 && (uintptr_t)out % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)blocks;
  if (items + (long long)grid * THREADS < (1LL << 32)) {
    if (vec)
      features_kernel<true, uint32_t><<<grid, THREADS, 0, s>>>(p);
    else
      features_kernel<false, uint32_t><<<grid, THREADS, 0, s>>>(p);
  } else if (vec) {
    features_kernel<true, unsigned long long><<<grid, THREADS, 0, s>>>(p);
  } else {
    features_kernel<false, unsigned long long><<<grid, THREADS, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

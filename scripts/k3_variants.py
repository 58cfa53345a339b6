#!/usr/bin/env python3
"""What bounds the diff rebuild (K3): time variants of csrc/diffup.cu.

    python3 scripts/k3_variants.py [variant ...]

Run from the root of a checkout on a machine with a CUDA card.  Each
variant is the kernel's source with one textual patch, built with nvcc
(printing ptxas's registers and spills) into a temporary directory and
launched through the port's own wrapper on the uploads ``chip_smoke.py``
times K3 at (``k3_uploads``: the square's 8192 x 29952, an 8000-record
stream group and a 1024-row super-row of the bench alignments), timed as
phase 5 times it (``cold_ring_ms``: the kernel's device time by the
profiler, a CUDA graph's back-to-back calls, a call by CUDA events):

- ``kernel``: the source as it is (16 KiB tiles, evict-first stores);
- ``write_back``: the tile stores keep the default write-back policy;
- ``tile_8k``: 2 words a thread, a tile of 8 KiB;
- ``first_design``: both (this kernel's first design);
- ``threads_512``: 512 threads a CTA, 2 words each (16 KiB tiles);
- ``chunk_2048``: 8 diffs a thread a chunk;
- ``ctas_8``: ``__launch_bounds__`` asking for 8 CTAs an SM (32
  registers a thread);
- ``bulk_store``: 8 KiB tiles in four buffers, each tile stored by one
  TMA bulk copy (``cp.async.bulk``) from shared memory, the tile after
  next built while it is stored; ``bulk_evict_first``: the same with an
  evict-first L2 policy on each copy;
- ``no_scatter``: no diff is written (the reference rows alone);
- ``no_build``: no reference word is written into the tiles.

Every variant but the last two must equal the plain version.  Then the
yardsticks of a pure write: ``fill_`` of a tensor of the output's size,
and ``expand().clone()`` of the reference row, by CUDA events.  The
card's name and power limit are printed first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

sys.modules["jax"] = None  # the port must never import jax
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WRITE_BACK = ("      if (j < n) __stcs(out + tw0 + j, buf[s][j]);",
              "      if (j < n) out[tw0 + j] = buf[s][j];")
TILE_8K = ("constexpr int WORDS = 4; ", "constexpr int WORDS = 2; ")
THREADS = ("constexpr int THREADS = 256;\nconstexpr int WORDS = 4; ",
           "constexpr int THREADS = 512;\nconstexpr int WORDS = 2; ")
CHUNK = ("constexpr int PER_THREAD = 4; ", "constexpr int PER_THREAD = 8; ")
CTAS_8 = ("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 8)")
NO_SCATTER = ("        if (off < bytes) b8[off] = cur.val[k];",
              "        if (off < bytes && cur.val[k] == 0xEE) b8[off] = 1;")
NO_BUILD = ("      if (j < n) b[j] = __ldg(ref + col[w]);",
            "      if (j < n && col[w] < 0) b[j] = __ldg(ref + col[w]);")
BULK_COPY = """      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
          :: "l"(out + tw0),
             "r"((unsigned)__cvta_generic_to_shared(buf[s])), "r"(n * 16)
          : "memory");"""
BULK_COPY_EVICT_FIRST = """      unsigned long long policy;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                   : "=l"(policy));
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
          " [%0], [%1], %2, %3;"
          :: "l"(out + tw0),
             "r"((unsigned)__cvta_generic_to_shared(buf[s])), "r"(n * 16),
             "l"(policy)
          : "memory");"""


def bulk(copy: str) -> list:
    """8 KiB tiles in four buffers, each stored by one TMA bulk copy
    (``copy``) that thread 0 issues after the tile's barrier; the tile
    after next is built meanwhile, and a buffer is built again only after
    the copy that read it has finished reading."""
    return [TILE_8K,
            ("constexpr int STAGES = 3; ", "constexpr int STAGES = 4; "),
            ("  build(buf[0], min((long long)TILE_WORDS, w1 - w0));\n",
             "  build(buf[0], min((long long)TILE_WORDS, w1 - w0));\n"
             "  if (w0 + TILE_WORDS < w1)\n"
             "    build(buf[1], min((long long)TILE_WORDS,"
             " w1 - w0 - TILE_WORDS));\n"),
            ("""    const int s1 = s == STAGES - 1 ? 0 : s + 1;
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
""", f"""    if (tw0 + 2 * TILE_WORDS < w1)
      build(buf[(s + 2) & 3],
            min((long long)TILE_WORDS, w1 - tw0 - 2 * TILE_WORDS));
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncthreads();
    if (t == 0) {{
{copy}
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }}
    s = (s + 1) & 3;
  }}
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
""")]


VARIANTS = {
    "kernel": [],
    "write_back": [WRITE_BACK],
    "tile_8k": [TILE_8K],
    "first_design": [WRITE_BACK, TILE_8K],
    "threads_512": [THREADS],
    "chunk_2048": [CHUNK],
    "ctas_8": [CTAS_8],
    "bulk_store": bulk(BULK_COPY),
    "bulk_evict_first": bulk(BULK_COPY_EVICT_FIRST),
    "no_scatter": [NO_SCATTER],
    "no_build": [NO_BUILD],
}
WRONG_BY_DESIGN = ("no_scatter", "no_build")


def build(src: str, name: str, tmp: str) -> ctypes.CDLL:
    from distance_tpu_torch.ops import _build

    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  {line.strip()}")
    return ctypes.CDLL(so)


def main(names: list) -> int:
    import torch

    import chip_smoke
    from distance_tpu_torch.ops import _build, diffup

    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 1
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"k3_variants: no variant {sorted(unknown)}", file=sys.stderr)
        return 2
    card = chip_smoke.gpu_line()
    print(card)
    with open(os.path.join(_build.CSRC, "diffup.cu")) as f:
        source = f.read()
    uploads = chip_smoke.k3_uploads(chip_smoke.make_alignment(
        chip_smoke.N_BENCH, chip_smoke.L_BENCH, chip_smoke.SEED))
    lib = diffup._kernel_lib()  # binds the argument types
    argtypes = lib.dt_diff_rebuild_launch.argtypes
    with tempfile.TemporaryDirectory() as tmp:
        for name in names or VARIANTS:
            src = source
            for old, new in VARIANTS[name]:
                if old not in src:
                    raise RuntimeError(f"{name}: the source has no {old!r}")
                src = src.replace(old, new)
            print(f"{name}:")
            lib = build(src, name, tmp)
            lib.dt_diff_rebuild_launch.argtypes = argtypes
            lib.dt_diff_rebuild_launch.restype = ctypes.c_int
            diffup._bound = lib
            for tag, (ref, idx, vals, rows) in uploads.items():
                got = diffup.diff_rebuild_cuda(ref, idx, vals, rows)
                torch.cuda.synchronize()
                exact = bool(torch.equal(got, diffup.diff_rebuild_torch(
                    ref, idx, vals, rows)))
                del got
                if name not in WRONG_BY_DESIGN and not exact:
                    raise RuntimeError(f"{name} {tag}: kernel != plain")
                total = rows * ref.shape[0]
                t = chip_smoke.cold_ring_ms(
                    lambda i, v: diffup.diff_rebuild_cuda(ref, i, v, rows),
                    (idx, vals), None, 10,
                    call_bytes=total + idx.nbytes + vals.nbytes)
                n_diff = int(((idx >= 0) & (idx < total)).sum())
                bound = (total + 5.0 * n_diff) / chip_smoke.PEAK_BYTES * 1e3
                print(f"  {tag} {rows} x {ref.shape[0]}: kernel"
                      f" {t['ms']:.4f} ms = {bound / t['ms']:.4f} of the"
                      f" bound, graph {t['graph_ms']:.4f} ms, call"
                      f" {t['call_ms']:.4f} ms (equals the plain version:"
                      f" {exact}; {card})", flush=True)
    diffup._bound = None
    print("pure writes:")
    for tag, (ref, idx, vals, rows) in uploads.items():
        out = torch.empty((rows, ref.shape[0]), dtype=torch.uint8,
                          device=ref.device)
        out.fill_(7)
        ref.expand(rows, ref.shape[0]).clone()
        fill = chip_smoke.cuda_timed(lambda: out.fill_(7), 20)
        clone = chip_smoke.cuda_timed(
            lambda: ref.expand(rows, ref.shape[0]).clone(), 20)
        bound = out.nbytes / chip_smoke.PEAK_BYTES * 1e3
        print(f"  {tag} {rows} x {ref.shape[0]}: fill_ {fill:.4f} ms ="
              f" {bound / fill:.4f} of {bound:.4f} ms (its bytes written"
              f" once), expand().clone() {clone:.4f} ms ({card})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""What bounds the estimate epilogue (K8): time variants of csrc/estimate.cu.

    python3 scripts/k8_variants.py [variant ...]

Run from the root of a checkout on a machine with a CUDA card.  Each
variant is the kernel's source with one textual patch, built with nvcc
(printing ptxas's registers and spills of each instantiation) into a
temporary directory and launched through the port's own wrapper on the
counters ``chip_smoke.py`` times K8 at (``time_k8``: a 2048 x 2048 block
of the bench alignment, K1's counters of each measure, and the k80
step's two site partials), timed as phase 14 times it
(``cold_ring_ms``: the kernel's device time by the profiler, a CUDA
graph's back-to-back calls, a call by CUDA events):

- ``kernel``: the source as it is (one quad a row a thread a trip, no
  occupancy asked of the compiler);
- ``unroll_2``, ``unroll_4``: 2 or 4 quads a row a thread a trip, every
  load of a trip issued before any math;
- ``unroll_4_min_blocks_3``, ``unroll_4_min_blocks_4``: 4 quads, the
  one-partial kernels compiled for 3 or 4 blocks an SM (at most 85 or 64
  registers a thread);
- ``cached_hints``: plain read-only loads (``__ldg``) and write-back
  stores in place of the streaming hints.

Every variant must equal the plain version bit for bit, NaN cells alike.
The card's name and power limit are printed first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

sys.modules["jax"] = None  # the port must never import jax
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UNROLL = "constexpr int UNROLL = 1; "
BOUNDS = "__global__ void __launch_bounds__(THREADS)"
INCLUDES = "#include <cuda_runtime.h>\n"


def unroll(quads: int, min_blocks: int = 0) -> list:
    patches = [(UNROLL, f"constexpr int UNROLL = {quads}; ")]
    if min_blocks:
        patches.append((BOUNDS, "__global__ void __launch_bounds__(THREADS,"
                                f" PB == 1 ? {min_blocks} : 1)"))
    return patches


VARIANTS = {
    "kernel": [],
    "unroll_2": unroll(2),
    "unroll_4": unroll(4),
    "unroll_4_min_blocks_3": unroll(4, 3),
    "unroll_4_min_blocks_4": unroll(4, 4),
    "cached_hints": [(INCLUDES, INCLUDES + "#define __ldcs __ldg\n"
                      "#define __stcs(p, v) (*(p) = (v))\n")],
}


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
    entry = ""
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("estimate_kernel")[-1].split("EEEv")[0]
        elif "Used" in line or "spill" in line:
            print(f"  {entry}: {line.strip()}")
    return ctypes.CDLL(so)


def main(names: list) -> int:
    import torch

    import chip_smoke
    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops import _build, estimate
    from distance_tpu_torch.ops.counters import counters_cuda
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch
    from distance_tpu_torch.parallel.mesh import site_shards

    if not torch.cuda.is_available():
        print("k8_variants: no CUDA device", file=sys.stderr)
        return 1
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"k8_variants: no variant {sorted(unknown)}", file=sys.stderr)
        return 2
    card = chip_smoke.gpu_line()
    print(card)
    with open(os.path.join(_build.CSRC, "estimate.cu")) as f:
        source = f.read()
    dev = torch.device("cuda", 0)
    block = chip_smoke.BLOCK
    rows = chip_smoke.make_alignment(2 * block, chip_smoke.L_BENCH,
                                     chip_smoke.SEED)
    x = torch.from_numpy(rows[:block]).to(dev)
    y = torch.from_numpy(rows[block:]).to(dev)
    cells = block * block
    counters = {m: counters_cuda(x, y, plan_to_torch(get_plan(m), dev))
                for m in MEASURES}
    kplan = plan_to_torch(get_plan("k80"), dev)
    parts = tuple(counters_cuda(x[:, s0:s1].contiguous(),
                                y[:, s0:s1].contiguous(), kplan)
                  for s0, s1 in site_shards(chip_smoke.L_BENCH, 2))
    lib = estimate._lib()  # binds the argument types
    argtypes = lib.dt_estimate_partials_launch.argtypes
    with tempfile.TemporaryDirectory() as tmp:
        for name in names or VARIANTS:
            src = source
            for old, new in VARIANTS[name]:
                if old not in src:
                    raise RuntimeError(f"{name}: the source has no {old!r}")
                src = src.replace(old, new)
            print(f"{name}:")
            lib = build(src, name, tmp)
            lib.dt_estimate_partials_launch.argtypes = argtypes
            lib.dt_estimate_partials_launch.restype = ctypes.c_int
            estimate._bound = lib
            for measure, c in counters.items():
                reads = len(estimate.FORMS[measure][1])
                got = estimate.estimate_cuda(c, measure)
                torch.cuda.synchronize()
                if chip_smoke.k8_mismatch(got, estimate.estimate_torch(
                        c, measure)):
                    raise RuntimeError(f"{name} {measure}: kernel != plain")
                t = chip_smoke.cold_ring_ms(
                    lambda t: estimate.estimate_cuda(t, measure), c,
                    chip_smoke.K8_KERNEL, 20,
                    call_bytes=(4 * reads + 4) * cells)
                bound = chip_smoke.k8_bound_ms(cells, 4.0 * reads)
                print(f"  {measure} {block}^2: kernel {t['ms']:.4f} ms ="
                      f" {bound / t['ms']:.1%} of {bound:.4f} ms, graph"
                      f" {t['graph_ms']:.4f} ms, call {t['call_ms']:.4f} ms"
                      f" ({card})", flush=True)
            got = estimate.estimate_partials_cuda(list(parts), "k80")
            torch.cuda.synchronize()
            if chip_smoke.k8_mismatch(got, estimate.estimate_partials_torch(
                    list(parts), "k80")):
                raise RuntimeError(f"{name} k80 step: kernel != plain")
            t = chip_smoke.cold_ring_ms(
                lambda p0, p1: estimate.estimate_partials_cuda([p0, p1],
                                                               "k80"),
                parts, chip_smoke.K8_KERNEL, 20, call_bytes=28 * cells)
            bound = chip_smoke.k8_bound_ms(cells, 24.0)
            print(f"  k80 step, 2 partials: kernel {t['ms']:.4f} ms ="
                  f" {bound / t['ms']:.1%} of {bound:.4f} ms, graph"
                  f" {t['graph_ms']:.4f} ms, call {t['call_ms']:.4f} ms"
                  f" ({card})", flush=True)
    estimate._bound = None
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

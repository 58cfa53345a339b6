#!/usr/bin/env python3
"""Where the counter kernel's time goes: time variants of csrc/counters.cu.

    python3 scripts/k1_variants.py [variant ...]

Run from the root of a checkout on a machine with a CUDA card.  Each
variant is the kernel's source with one part taken out by a textual
patch, built with nvcc (and ptxas's report) into a temporary directory
and launched through the port's own wrapper at the main path's block
(2048 x 2048 x 29952 codes, random Paradis codes from a seed) for each
measure, timed with CUDA events:

- ``kernel``: the source as it is (its counters must equal the plain
  version's);
- ``no_mma``: the consumers issue no wgmma (everything else runs);
- ``producer_only``: the consumers neither build their A fragments nor
  issue wgmma, so the producer's code copies and B features set the pace;
- ``producer_no_stores``: as ``producer_only``, and the producer does not
  store its B features either.

Variants other than ``kernel`` compute wrong counters by design; only
their times mean anything.  The card's name and power limit are printed
first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

sys.modules["jax"] = None  # the port must never import jax
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

NO_MMA = ("        wgmma_m64n256k32(d, a[0], desc(base));\n"
          "        wgmma_m64n256k32(d, a[1], desc(base + KSTEP_BYTES));",
          "        d[0] += a[0][0] ^ a[0][1] ^ a[0][2] ^ a[0][3] ^ a[1][0]"
          " ^ a[1][1] ^ a[1][2] ^ a[1][3];")
NO_A = ("            a[ks][q] = lookup(tab, sel[q & 1][2 * ks + q / 2],\n"
        "                              hi[q & 1][2 * ks + q / 2]);",
        "            a[ks][q] = tab.x + q + ks;")
NO_STORES = ("          *reinterpret_cast<uint4*>(dst + it * 1024) =",
             "          if (tab.x == 0x9abcdef1u)\n"
             "            *reinterpret_cast<uint4*>(dst + it * 1024) =")
VARIANTS = {
    "kernel": [],
    "no_mma": [NO_MMA],
    "producer_only": [NO_MMA, NO_A],
    "producer_no_stores": [NO_MMA, NO_A, NO_STORES],
}
SHAPE = (2048, 2048, 29952)
REPS = 10


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

    from distance_tpu_torch.encoding import ALL_CODES
    from distance_tpu_torch.measures import MEASURES
    from distance_tpu_torch.ops import _build
    from distance_tpu_torch.ops import counters as kernels
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import plan_to_torch

    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 1
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"k1_variants: no variant {sorted(unknown)}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with open(os.path.join(_build.CSRC, "counters.cu")) as f:
        source = f.read()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    m, n, width = SHAPE
    x = torch.from_numpy(rng.choice(ALL_CODES, size=(m, width))
                         .astype(np.uint8)).to(dev)
    y = torch.from_numpy(rng.choice(ALL_CODES, size=(n, width))
                         .astype(np.uint8)).to(dev)
    plans = {k: plan_to_torch(get_plan(k), dev) for k in MEASURES}
    lib = kernels._kernel_lib()  # binds the argument types
    argtypes = lib.dt_counters_launch.argtypes
    with tempfile.TemporaryDirectory() as tmp:
        for name in names or VARIANTS:
            src = source
            for old, new in VARIANTS[name]:
                if old not in src:
                    raise RuntimeError(f"{name}: the source has no {old!r}")
                src = src.replace(old, new)
            print(f"{name}:")
            lib = build(src, name, tmp)
            lib.dt_counters_launch.argtypes = argtypes
            lib.dt_counters_launch.restype = ctypes.c_int
            kernels._bound = lib
            for measure, plan in plans.items():
                got = kernels.counters_cuda(x, y, plan)
                torch.cuda.synchronize()
                exact = bool(torch.equal(got, kernels.counters_torch(x, y,
                                                                     plan)))
                if name == "kernel" and not exact:
                    raise RuntimeError(f"{measure}: kernel != plain")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    kernels.counters_cuda(x, y, plan)
                end.record()
                torch.cuda.synchronize()
                print(f"  {measure} {m} x {n} x {width}:"
                      f" {start.elapsed_time(end) / REPS:.3f} ms"
                      f" (equals the plain version: {exact})", flush=True)
    kernels._bound = None
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Where the contraction kernel's time goes: time variants of
csrc/contract.cu.

    python3 scripts/k6_variants.py [variant ...] [MxN ...]

Run from the root of a checkout on a machine with a CUDA card.  Each
variant is the kernel's source with one part changed by a textual patch,
built with nvcc (and ptxas's report) into a temporary directory and
launched through the port's own wrapper at the main path's block (2048 x
2048 rows x 29952 sites of features built from random Paradis codes made
from a seed, the JAX plan's channels), or at each M x N rows given (the
stream's group: 2000x8000), for tn93, k80 and n, timed with CUDA events
beside K1 on the same codes:

- ``kernel``: the source as it is (its counters must equal the plain
  version's);
- ``no_mma``: the consumers issue no wgmma (the producer's copies and the
  ring's barriers set the pace);
- ``no_copy``: the producer issues no copy (the tensor cores on whatever
  the ring holds, and the barriers, set the pace);
- ``nst3``: a ring of 3 stages instead of 4.

``no_mma`` and ``no_copy`` compute wrong counters by design; only their
times mean anything.  The card's name and power limit are printed first.
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

NO_MMA = ("        wgmma_m64n256k32(d, desc(a + ks * KSTEP), desc(b + ks *"
          " KSTEP));",
          "        d[ks] += (int)(a ^ b);")
NO_COPY = [("        mbar_expect(bar, STAGE);", "        mbar_arrive(bar);"),
           ("        tma_box(stage, &p.fx_map,",
            "        if (k < 0) tma_box(stage, &p.fx_map,"),
           ("        tma_box(stage + A_STAGE, &p.gy_map,",
            "        if (k < 0) tma_box(stage + A_STAGE, &p.gy_map,")]
VARIANTS = {
    "kernel": [],
    "no_mma": [NO_MMA],
    "no_copy": NO_COPY,
    "nst3": [("constexpr int NST = 4;", "constexpr int NST = 3;")],
}
EXACT = ("kernel", "nst3")
MEASURES = ("tn93", "k80", "n")
SHAPE = (2048, 2048)
WIDTH = 29952
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


def timed(fn) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv: list) -> int:
    import torch

    from distance_tpu_torch.encoding import ALL_CODES
    from distance_tpu_torch.ops import _build, cached
    from distance_tpu_torch.ops import counters as kernels
    from distance_tpu_torch.ops.features import get_plan
    from distance_tpu_torch.ops.plan import cached_plan_to_torch, plan_to_torch

    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device", file=sys.stderr)
        return 1
    def is_shape(arg: str) -> bool:
        parts = arg.split("x")
        return len(parts) == 2 and all(p.isdigit() for p in parts)

    shapes = [tuple(int(v) for v in a.split("x")) for a in argv
              if is_shape(a)]
    names = [a for a in argv if not is_shape(a)]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"k6_variants: no variant {sorted(unknown)}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with open(os.path.join(_build.CSRC, "contract.cu")) as f:
        source = f.read()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    width = WIDTH
    cases = {}
    for m, n in shapes or [SHAPE]:
        x = torch.from_numpy(rng.choice(ALL_CODES, size=(m, width))
                             .astype(np.uint8)).to(dev)
        y = torch.from_numpy(rng.choice(ALL_CODES, size=(n, width))
                             .astype(np.uint8)).to(dev)
        for measure in MEASURES:
            plan = cached_plan_to_torch(get_plan(measure), dev)
            kp = plan_to_torch(get_plan(measure), dev)
            cases[measure, m, n] = (plan, cached.features_torch(x, plan, "f"),
                                    cached.features_torch(y, plan, "g"),
                                    kernels.counters_cuda(x, y, kp))
            k1 = timed(lambda: kernels.counters_cuda(x, y, kp))
            print(f"K1 {measure} {m} x {n} x {width}: {k1:.3f} ms")
    cached._lib("contract")  # binds the argument types
    bound = cached._bound["contract"]
    types = {e: (getattr(bound, e).argtypes, getattr(bound, e).restype)
             for e in ("dt_contract_launch", "dt_mix_launch")}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names or VARIANTS:
            src = source
            for old, new in VARIANTS[name]:
                if old not in src:
                    raise RuntimeError(f"{name}: the source has no {old!r}")
                src = src.replace(old, new)
            print(f"{name}:")
            lib = build(src, name, tmp)
            for entry, (args, res) in types.items():
                getattr(lib, entry).argtypes = args
                getattr(lib, entry).restype = res
            cached._bound["contract"] = lib
            for (measure, m, n), (plan, fx, gy, want) in cases.items():
                got = cached.contract_cuda(fx, gy, plan)
                torch.cuda.synchronize()
                exact = bool(torch.equal(got, want))
                if name in EXACT and not exact:
                    raise RuntimeError(f"{name} {measure}: K6 != K1")
                ms = timed(lambda: cached.contract_cuda(fx, gy, plan))
                print(f"  {measure} {m} x {n} x {width} (R = {plan.channels}):"
                      f" {ms:.3f} ms (equals K1: {exact})", flush=True)
    cached._bound.pop("contract", None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The port's dry run: the counter step on one device, then the sharded
step and the engine's split sweep over several.

The counterpart of the JAX package's ``__graft_entry__.py``:

* ``entry(device)`` gives (fn, args): the raw counters of 128 x 256
  records of 512 sites through the cached-feature path (K5, then K6 on a
  card), on ``device``;
* ``dryrun_multichip(devices)`` runs two stages over ``devices``
  (several cards, or logical devices of one card or of the CPU): (1)
  ``parallel/mesh.sharded_step`` for k80 on a (dp, sp) grid, sp = 2 when
  the device count is even, the counters of each device's rows and sites
  summed on the grid's first device, then their float32 estimate there
  (K8 on a card), held against the plain counters and estimate on the
  CPU; (2) the engine's split sweep, a tn93 square of 4k + 3 records of
  256 sites with tiles of 8 x 2k, split over the k devices, whose TSV
  must equal the one-device ``--backend torch`` run's byte for byte.

    python -m distance_tpu_torch.dryrun [--devices K] [--cpu]

runs both on the card: K devices (the first K cards, or K logical
devices of the first card when the host has fewer; default every card),
or with ``--cpu`` on K logical CPU devices.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from distance_tpu_torch import engine
from distance_tpu_torch.encoding import ALL_CODES, CODE_TO_CHAR
from distance_tpu_torch.fastaio import load_fastas
from distance_tpu_torch.ops.cached import counters_cached
from distance_tpu_torch.ops.counters import counters_torch
from distance_tpu_torch.ops.estimate import estimate_torch
from distance_tpu_torch.ops.features import get_plan
from distance_tpu_torch.ops.plan import cached_plan_to_torch, plan_to_torch
from distance_tpu_torch.parallel.mesh import make_mesh, sharded_step
from distance_tpu_torch.writer import TsvWriter


def _example_data(m=128, n=256, width=512, seed=0):
    from distance_tpu_torch.encoding import ALL_CODES

    rng = np.random.default_rng(seed)
    x = rng.choice(ALL_CODES, size=(m, width)).astype(np.uint8)
    y = rng.choice(ALL_CODES, size=(n, width)).astype(np.uint8)
    return x, y


def entry(device: torch.device = None) -> Tuple[Callable, tuple]:
    """(fn, example_args): the counter step of the raw measure (its
    features, then their contraction) and its inputs on ``device`` (the
    first card by default)."""
    device = engine.device_of("cuda") if device is None else device
    plan = cached_plan_to_torch(get_plan("raw"), device)

    def fn(x, y):
        return counters_cached(x, y, plan)

    x, y = _example_data()
    return fn, tuple(torch.from_numpy(a).to(device) for a in (x, y))


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dry run: {what}")


def _sync(devices: Sequence[torch.device]) -> None:
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def dryrun_multichip(devices: Sequence[torch.device]) -> None:
    """Both stages over ``devices``; raises AssertionError where a result
    is not the expected one."""
    devices = list(devices)
    n_devices = len(devices)
    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(devices, sp=sp)
    dp = n_devices // sp

    m = 16
    rows_per_dp = 16
    width_per_sp = 256
    x, y = _example_data(
        m=m, n=rows_per_dp * dp, width=width_per_sp * sp, seed=1
    )
    out = sharded_step("k80", mesh, backend="cached")(x, y)
    _sync(devices)
    _expect(out.shape == (m, rows_per_dp * dp)
            and out.dtype == torch.float32,
            f"sharded step gave {tuple(out.shape)} {out.dtype}")
    want = estimate_torch(
        counters_torch(torch.from_numpy(x), torch.from_numpy(y),
                       plan_to_torch(get_plan("k80"), torch.device("cpu"))),
        "k80")
    got = out.cpu()
    # the card's logf and the CPU's may differ in the last bits
    _expect(torch.equal(got.isnan(), want.isnan())
            and torch.allclose(got, want, rtol=1e-6, atol=0, equal_nan=True),
            "the sharded step diverged from the plain counters' estimate")

    _dryrun_engine_sharded(devices)


@contextlib.contextmanager
def _engine_on(devices: Sequence[torch.device], backend: str):
    """The engine's runs of ``backend`` in this process on ``devices``."""
    real = engine.devices_of
    engine.devices_of = (lambda b: list(devices) if b == backend
                         else real(b))
    try:
        yield
    finally:
        engine.devices_of = real


def _dryrun_engine_sharded(devices: List[torch.device]) -> None:
    """The engine's split sweep end to end on tiny shapes, byte-compared
    with the one-device ``--backend torch`` run."""
    n_devices = len(devices)
    rng = np.random.default_rng(3)
    mat = rng.choice(ALL_CODES, size=(4 * n_devices + 3, 256)).astype(
        np.uint8
    )
    fasta = b"".join(
        b">s%d\n%s\n"
        % (i, "".join(CODE_TO_CHAR[c] for c in row).encode())
        for i, row in enumerate(mat)
    )

    def run_backend(backend: str) -> bytes:
        loaded = load_fastas([io.BytesIO(fasta)])
        loaded[0].count_bases()
        out = io.BytesIO()
        setup = engine.Setup(
            loaded=loaded,
            streamed=None,
            writer=TsvWriter(out),
            measure="tn93",
            n_threads=1,
            batchsize=1,
            backend=backend,
            tile_i=8,
            tile_j=2 * n_devices,  # divisible: the blocks split
        )
        engine.run(setup)
        return out.getvalue()

    _expect(len(engine._split_devices(devices, 2 * n_devices)) == n_devices,
            f"the engine does not split over {devices}")
    backend = "cuda" if devices[0].type == "cuda" else "torch"
    with _engine_on(devices, backend):
        got = run_backend(backend)
    want = run_backend("torch")
    _expect(got == want, "the split sweep diverged from --backend torch")


def _devices(k: int, cpu: bool) -> List[torch.device]:
    if cpu:
        return [torch.device("cpu")] * k
    cards = torch.cuda.device_count()
    if k <= cards:
        return [torch.device("cuda", c) for c in range(k)]
    return [torch.device("cuda", 0)] * k


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m distance_tpu_torch.dryrun")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices of the dry run (default: every card;"
                         " more than the cards: logical devices of the"
                         " first)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on logical CPU devices instead of the card")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("dryrun: no CUDA device (--cpu runs on the CPU)",
              file=sys.stderr)
        return 1
    k = args.devices or (1 if args.cpu else torch.cuda.device_count())
    devices = _devices(k, args.cpu)
    fn, fargs = entry(devices[0])
    res = fn(*fargs)
    _sync(devices)
    print("entry ok:", tuple(res.shape), res.dtype)
    dryrun_multichip(devices)
    print(f"dryrun ok on {len(devices)} devices:"
          f" {', '.join(str(d) for d in devices)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

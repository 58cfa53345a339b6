"""The port's dry run (``distance_tpu_torch/dryrun.py``) and its sharded
step on CPU devices, against the JAX ``__graft_entry__`` and
``parallel/mesh.py::sharded_step`` on the conftest's virtual CPU devices.

The estimate is float32: XLA:CPU's ``log`` and ``sqrt`` and torch's may
differ in the last bits, so finite cells agree within 4 ulp, and the
NaN, +inf and -inf cells fall in the same places.  Counters are exact.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from distance_tpu.encoding import A, C, G, GAP  # noqa: E402
from distance_tpu.parallel import mesh as jax_mesh  # noqa: E402
from distance_tpu_torch import dryrun  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch.ops import estimate as estimate_ops  # noqa: E402
from distance_tpu_torch.fastaio import load_fastas  # noqa: E402
from distance_tpu_torch.parallel import mesh  # noqa: E402
from distance_tpu_torch.writer import TsvWriter  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402
from tests.test_golden import run_engine  # noqa: E402

CPU = torch.device("cpu")
MEASURES = ["n", "n_high", "raw", "jc69", "k80", "tn93"]
ULP = 4


def special_rows(x, y):
    """Rows whose estimates are NaN or inf in some measure: an all-gap x
    row (no known or comparable site: 0 / 0), and an all-A x row against
    an all-C y row (p = 1: the log of a negative number), a y row three
    quarters C (p = 0.75: jc69's 1 - 4/3 p, fused as XLA compiles it,
    is -2^-25, so NaN, where two roundings would give 0 and inf) and a y
    row half G (k80's p = 0.5: the log of 0, inf)."""
    x, y = x.copy(), y.copy()
    width = x.shape[1]
    x[0] = GAP
    x[1] = A
    y[0] = C
    y[1:3] = A
    y[1, : 3 * width // 4] = C
    y[2, : width // 2] = G
    return x, y


def assert_close_ulp(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    for mask in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(mask(got), mask(want))
    fin = np.isfinite(want)
    # ulp distance of finite float32 values through their ordered ints
    gi = got[fin].view(np.int32).astype(np.int64)
    wi = want[fin].view(np.int32).astype(np.int64)
    gi = np.where(gi < 0, -(gi & 0x7FFFFFFF), gi)
    wi = np.where(wi < 0, -(wi & 0x7FFFFFFF), wi)
    assert np.abs(gi - wi).max(initial=0) <= ULP


@pytest.mark.parametrize("dp, sp", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("measure", MEASURES)
def test_sharded_step_equals_jax(measure, dp, sp):
    """The port's ``sharded_step`` on a (dp, sp) grid of CPU devices
    against the JAX one on a (dp, sp) mesh of virtual CPU devices, on the
    dry run's inputs with NaN and inf cells among them."""
    x, y = special_rows(*dryrun._example_data(
        m=16, n=16 * dp, width=256 * sp, seed=1))
    jm = jax_mesh.make_mesh(dp * sp, sp=sp)
    want = np.asarray(jax_mesh.sharded_step(measure, jm)(
        jax.device_put(x, NamedSharding(jm, P(None, "sp"))),
        jax.device_put(y, NamedSharding(jm, P("dp", "sp")))))
    grid = mesh.make_mesh([CPU] * (dp * sp), sp=sp)
    got = mesh.sharded_step(measure, grid)(x, y).numpy()
    assert_close_ulp(got, want)
    if measure in ("raw", "jc69", "k80", "tn93"):
        assert np.isnan(want).any()
    if measure == "jc69":
        assert np.isnan(want[1, 1])
    if measure == "k80":
        assert np.isposinf(want[1, 2])
    # the K1 form of the counters gives the same estimate
    k1 = mesh.sharded_step(measure, grid, backend="k1")(x, y).numpy()
    np.testing.assert_array_equal(k1, got)


@pytest.mark.parametrize("measure", MEASURES)
def test_estimate_checks_its_counters(measure):
    g = {"n": 1, "n_high": 1, "raw": 2, "jc69": 2, "k80": 3, "tn93": 4}
    ok = torch.zeros((g[measure], 2, 3), dtype=torch.int32)
    assert estimate_ops.estimate(ok, measure).shape == (2, 3)
    with pytest.raises(ValueError, match="int32"):
        estimate_ops.estimate(
            ok[:1] if g[measure] > 1 else ok.repeat(2, 1, 1), measure)
    with pytest.raises(ValueError, match="CUDA"):
        estimate_ops.estimate_cuda(ok, measure)


def test_entry_equals_jax():
    """``entry``'s counters on the CPU equal the JAX entry's."""
    jfn, jargs = graft.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = dryrun.entry(CPU)
    got = fn(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_example_data_equals_jax():
    for kwargs in ({}, dict(m=16, n=32, width=512, seed=1)):
        for a, b in zip(dryrun._example_data(**kwargs),
                        graft._example_data(**kwargs)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_dryrun_multichip_on_cpu_devices(k, monkeypatch):
    """Both stages on k logical CPU devices; the split sweep engages."""
    made = []
    real = port_engine._BlockEngine.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        made.append(self.k)

    monkeypatch.setattr(port_engine._BlockEngine, "__init__", init)
    dryrun.dryrun_multichip([CPU] * k)
    assert made == [k, 1]  # the split run, then the one-device run
    assert port_engine.devices_of("torch") == [CPU]  # restored


def test_dryrun_main_on_the_cpu(capsys):
    assert dryrun.main(["--cpu", "--devices", "4"]) == 0
    out = capsys.readouterr().out
    assert "entry ok: (2, 128, 256) torch.int32" in out
    assert "dryrun ok on 4 devices" in out


def test_dryrun_main_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["square", "rectangle"])
@pytest.mark.parametrize("ti, tj", [(8, 6), (6, 8), (4, 12)])
def test_tiles_off_the_strip_grid(mode, ti, tj):
    """A column tile that neither divides the row tile nor is a multiple
    of it is rounded up to a multiple of it on one device (the dry run's
    tiles on three devices, 8 x 6): before, a block past the padded rows
    raised.  The bytes are the numpy path's."""
    rng = np.random.default_rng(tj)
    f1 = make_fasta(random_seqs(rng, 15, 100, amb_frac=0.2))
    f2 = make_fasta(random_seqs(rng, 11, 100, amb_frac=0.2))
    want, _ = run_engine("k80", f1, f2 if mode == "rectangle" else None,
                         backend="numpy")
    handles = [io.BytesIO(f1)] + ([io.BytesIO(f2)] if mode == "rectangle"
                                  else [])
    out = io.BytesIO()
    port_engine.run(port_engine.Setup(
        loaded=load_fastas(handles), streamed=None, writer=TsvWriter(out),
        measure="k80", n_threads=1, batchsize=1, backend="torch",
        tile_i=ti, tile_j=tj))
    assert out.getvalue() == want

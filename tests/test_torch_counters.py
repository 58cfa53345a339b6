"""The port's counters equal the JAX package's, exactly.

``counters_torch`` (the plain version of the CUDA kernel) is held against
the Pallas kernel in interpret mode, the XLA path and the numpy
reference.  The CUDA kernel itself runs only on the card: its tests are
in test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distance_tpu.engine import _counters_numpy  # noqa: E402
from distance_tpu.encoding import ALL_CODES  # noqa: E402
from distance_tpu.measures import MEASURES  # noqa: E402
from distance_tpu.ops.features import get_plan  # noqa: E402
from distance_tpu.ops.pairwise_xla import counters_xla  # noqa: E402
from distance_tpu_torch.ops import counters as kernels  # noqa: E402
from distance_tpu_torch.ops.plan import plan_to_torch  # noqa: E402
from tests.conftest import random_seqs  # noqa: E402
from tests.test_pallas import encode_padded  # noqa: E402

CPU = torch.device("cpu")


def port_counters(x: np.ndarray, y: np.ndarray, measure: str) -> np.ndarray:
    plan = plan_to_torch(get_plan(measure), CPU)
    out = kernels.counters_torch(
        torch.from_numpy(x), torch.from_numpy(y), plan
    )
    assert out.dtype == torch.int32
    return out.numpy()


def random_codes(rng, rows: int, width: int) -> np.ndarray:
    return rng.choice(ALL_CODES, size=(rows, width)).astype(np.uint8)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("shape", [(16, 8, 256), (8, 8, 384)])
def test_matches_pallas_interpret(measure, shape):
    from distance_tpu.ops.pairwise_pallas import counters_pallas

    m, n, width = shape
    rng = np.random.default_rng(11)
    x = encode_padded(random_seqs(rng, m - 2, width - 56, amb_frac=0.3),
                      m, width)
    y = encode_padded(random_seqs(rng, n - 1, width - 56, amb_frac=0.3),
                      n, width)
    plan = get_plan(measure)
    want = np.asarray(
        counters_pallas(jnp.asarray(x), jnp.asarray(y), plan, interpret=True)
    )
    np.testing.assert_array_equal(port_counters(x, y, measure), want)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize(
    "shape", [(13, 7, 200), (1, 1, 1), (0, 5, 128), (3, 4, 0)]
)
def test_matches_numpy_and_xla_at_ragged_shapes(measure, shape):
    m, n, width = shape
    rng = np.random.default_rng(5)
    x, y = random_codes(rng, m, width), random_codes(rng, n, width)
    plan = get_plan(measure)
    got = port_counters(x, y, measure)
    assert got.shape == (len(plan.counters), m, n)
    np.testing.assert_array_equal(got, _counters_numpy(x, y, plan))
    np.testing.assert_array_equal(
        got, np.asarray(counters_xla(jnp.asarray(x), jnp.asarray(y), plan))
    )


@pytest.mark.parametrize("measure", MEASURES)
def test_zero_padding_adds_nothing(measure):
    """Padded rows and sites (code 0) leave every counter unchanged and
    count 0 themselves: what the engine's padding relies on."""
    rng = np.random.default_rng(9)
    x, y = random_codes(rng, 5, 70), random_codes(rng, 6, 70)
    xp = np.zeros((8, 128), dtype=np.uint8)
    yp = np.zeros((9, 128), dtype=np.uint8)
    xp[:5, :70], yp[:6, :70] = x, y
    got = port_counters(xp, yp, measure)
    np.testing.assert_array_equal(got[:, :5, :6], port_counters(x, y, measure))
    assert not got[:, 5:].any() and not got[:, :, 6:].any()


def test_plain_version_chunks_over_sites(monkeypatch):
    """Chunking the plain version's site axis does not change a counter."""
    rng = np.random.default_rng(3)
    x, y = random_codes(rng, 9, 301), random_codes(rng, 4, 301)
    whole = port_counters(x, y, "tn93")
    monkeypatch.setattr(kernels, "_PLAIN_CHUNK_ELEMS", 9 * 5 * 7)
    np.testing.assert_array_equal(port_counters(x, y, "tn93"), whole)


def test_dispatch_takes_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    x, y = random_codes(rng, 6, 50), random_codes(rng, 7, 50)
    plan = plan_to_torch(get_plan("raw"), CPU)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    before = kernels.LAUNCHES
    assert torch.equal(
        kernels.counters(xt, yt, plan), kernels.counters_torch(xt, yt, plan)
    )
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize(
    "x, y, match",
    [
        (np.zeros((2, 5), np.uint8), np.zeros((2, 4), np.uint8), "widths"),
        (np.zeros((2, 5), np.int32), np.zeros((2, 5), np.int32), "uint8"),
        (np.zeros(5, np.uint8), np.zeros((2, 5), np.uint8), "2-D"),
    ],
)
def test_bad_codes_raise(x, y, match):
    plan = plan_to_torch(get_plan("raw"), CPU)
    with pytest.raises(ValueError, match=match):
        kernels.counters(torch.from_numpy(x), torch.from_numpy(y), plan)


def test_kernel_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper raises on tensors it cannot
    launch on instead of computing them another way."""
    plan = plan_to_torch(get_plan("raw"), CPU)
    x = torch.zeros((2, 8), dtype=torch.uint8)
    before = kernels.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        kernels.counters_cuda(x, x, plan)
    assert kernels.LAUNCHES == before


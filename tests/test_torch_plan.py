"""The port's counter plans equal the JAX package's, and carry over to
the tensors the counter kernel consumes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distance_tpu.measures import MEASURES  # noqa: E402
from distance_tpu.ops import features as jax_features  # noqa: E402
from distance_tpu_torch.ops import features as port_features  # noqa: E402
from distance_tpu_torch.ops.counters import features_torch  # noqa: E402
from distance_tpu_torch.ops.plan import (  # noqa: E402
    MAX_ACCUMULATORS,
    MAX_CHANNELS,
    MAX_COUNTERS,
    plan_to_torch,
)

CPU = torch.device("cpu")


@pytest.mark.parametrize("measure", MEASURES)
def test_plans_equal_field_by_field(measure):
    a = jax_features.get_plan(measure)
    b = port_features.get_plan(measure)
    assert a.measure == b.measure
    assert a.counters == b.counters
    assert a.channels == b.channels
    assert a.slices == b.slices
    np.testing.assert_array_equal(a.f_luts, b.f_luts)
    np.testing.assert_array_equal(a.g_luts, b.g_luts)
    assert a.f_luts.dtype == b.f_luts.dtype == np.int8
    for x, y in ((a.mix_num, b.mix_num), (a.mix_den, b.mix_den)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("measure", MEASURES)
def test_plan_to_torch_same_from_either_package(measure):
    a = plan_to_torch(jax_features.get_plan(measure), CPU)
    b = plan_to_torch(port_features.get_plan(measure), CPU)
    assert torch.equal(a.f_lut, b.f_lut) and torch.equal(a.g_lut, b.g_lut)
    assert a.f_lut.dtype == torch.int8
    assert (a.bounds, a.mix, a.den) == (b.bounds, b.mix, b.den)
    assert a.channels <= MAX_CHANNELS
    assert a.accumulators <= MAX_ACCUMULATORS
    assert a.counters <= MAX_COUNTERS


@pytest.mark.parametrize("measure", MEASURES)
def test_plan_mix_reproduces_counter_truth_tables(measure):
    """Accumulators mixed by (mix, den) give each counter's 256 x 256
    predicate table — the per-counter decomposition of ops/features.py."""
    kp = plan_to_torch(port_features.get_plan(measure), CPU)
    f = kp.f_lut.numpy().astype(np.int64)
    g = kp.g_lut.numpy().astype(np.int64)
    acc = [
        f[lo:hi].T @ g[lo:hi]
        for lo, hi in zip(kp.bounds[:-1], kp.bounds[1:])
    ]
    names = port_features.get_plan(measure).counters
    for name, row, den in zip(names, kp.mix, kp.den):
        num = sum(w * a for w, a in zip(row, acc))
        assert not (num % den).any()
        np.testing.assert_array_equal(
            num // den, port_features.reference_counter_matrix(name)
        )


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("side", ["f", "g"])
def test_lut_features_equal_jax_features_device(measure, side):
    plan = jax_features.get_plan(measure)
    kp = plan_to_torch(plan, CPU)
    codes = np.arange(256, dtype=np.uint8).reshape(4, 64)
    want = np.asarray(
        jax_features.features_device(
            jnp.asarray(codes), plan, side, jnp, jnp.int8
        )
    )
    lut = kp.f_lut if side == "f" else kp.g_lut
    got = features_torch(torch.from_numpy(codes), lut).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("measure", MEASURES)
def test_padding_code_has_zero_features(measure):
    """Code 0 pads rows and sites; the kernel masks its ragged edges by
    loading it, which is right only if it adds nothing on either side."""
    kp = plan_to_torch(port_features.get_plan(measure), CPU)
    assert not kp.f_lut[:, 0].any() and not kp.g_lut[:, 0].any()

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
    MAX_CHANNELS,
    MAX_COUNTERS,
    cached_plan_to_torch,
    fold_cached,
    plan_to_torch,
)

CPU = torch.device("cpu")


def _fold(plan):
    """(plan channel, g-side weight) of each channel of the folded plan:
    a counter's channels in order, counter after counter."""
    if plan.mix_num is None:
        return [(c, 1) for _, lo, hi in plan.slices for c in range(lo, hi)]
    return [(c, int(w)) for row in plan.mix_num for c, w in enumerate(row)
            if w]


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
    assert (a.bounds, a.den) == (b.bounds, b.den)
    assert np.array_equal(a.f_nib, b.f_nib)
    assert np.array_equal(a.g_nib, b.g_nib)
    assert a.channels <= MAX_CHANNELS
    assert a.counters <= MAX_COUNTERS


@pytest.mark.parametrize("measure", MEASURES)
def test_plan_mix_reproduces_counter_truth_tables(measure):
    """Each folded counter's channel range divided by its ``den`` gives
    the counter's 256 x 256 predicate table — the per-counter
    decomposition of ops/features.py."""
    kp = plan_to_torch(port_features.get_plan(measure), CPU)
    f = kp.f_lut.numpy().astype(np.int64)
    g = kp.g_lut.numpy().astype(np.int64)
    names = port_features.get_plan(measure).counters
    assert len(kp.bounds) == len(names) + 1 == len(kp.den) + 1
    for name, lo, hi, den in zip(names, kp.bounds[:-1], kp.bounds[1:],
                                 kp.den):
        num = f[lo:hi].T @ g[lo:hi]
        assert not (num % den).any()
        np.testing.assert_array_equal(
            num // den, port_features.reference_counter_matrix(name)
        )


@pytest.mark.parametrize("measure, channels", [
    ("n", 14), ("n_high", 14), ("raw", 18), ("jc69", 18), ("k80", 10),
    ("tn93", 9),
])
def test_folded_plan_fits_int8(measure, channels):
    """The fold scales each shared channel's g-side row by its mix weight
    (in {-1, 1, 2}); the folded features stay int8, and k80 and tn93
    contract 4 + 4 + 2 and 4 + 1 + 2 + 2 channels."""
    plan = port_features.get_plan(measure)
    kp = plan_to_torch(plan, CPU)
    assert kp.channels == channels and kp.f_lut.dtype == torch.int8
    assert kp.g_lut.dtype == torch.int8
    fold = _fold(plan)
    assert len(fold) == channels
    for k, (c, w) in enumerate(fold):
        assert w in (-1, 1, 2)
        np.testing.assert_array_equal(kp.g_lut[k].numpy().astype(np.int16),
                                      plan.g_luts[c].astype(np.int16) * w)
        np.testing.assert_array_equal(kp.f_lut[k].numpy(), plan.f_luts[c])


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
    # the folded plan's channel k is the plan's channel c, its g side
    # scaled by w
    want = np.stack([want[c].astype(np.int16) * (w if side == "g" else 1)
                     for c, w in _fold(plan)])
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
    assert not kp.f_nib[:, 0].any() and not kp.g_nib[:, 0].any()


# The kernel's feature build (csrc/counters.cu split, lookup), word for
# word on uint32 words of four codes.
def _prmt(a, b, sel):
    """prmt.b32 in its default mode: byte i of the result is byte
    (sel >> 4 i) & 7 of {b, a}, or that byte's sign replicated if
    (sel >> 4 i) & 8."""
    pool = np.stack([a, b], axis=-1).astype("<u4").view(np.uint8)
    pool = pool.reshape(*np.shape(a), 8)
    out = np.zeros((*np.shape(a), 4), dtype=np.uint8)
    for i in range(4):
        s = np.broadcast_to(np.asarray(sel, dtype=np.uint32) >> (4 * i),
                            np.shape(a)) & 0xF
        byte = np.take_along_axis(pool, (s & 7)[..., None].astype(np.int64),
                                  axis=-1)[..., 0]
        out[..., i] = np.where(s & 8, np.where(byte & 0x80, 0xFF, 0), byte)
    return out.view("<u4")[..., 0]


def _split(w):
    t = (w >> 4) & np.uint32(0x07070707)
    u = t | (t >> 4)
    sel = (u & np.uint32(0xFF)) | ((u >> 8) & np.uint32(0xFF00))
    return sel, _prmt(w, np.zeros_like(w), np.uint32(0xBA98))


def _lookup(tab, sel, hi):
    tx, ty, tz, tw = (np.full_like(sel, v) for v in tab)
    lo, up = _prmt(tx, ty, sel), _prmt(tz, tw, sel)
    return (lo & ~hi) | (up & hi)


@pytest.mark.parametrize("measure", MEASURES)
def test_kernel_nibble_lookup_equals_luts(measure):
    """The kernel's byte-permute lookup of each channel's nibble tables
    gives the folded LUTs' features for code 0 and every Paradis code, in
    every byte position of a word of four codes."""
    from distance_tpu_torch.encoding import ALL_CODES
    from distance_tpu_torch.ops.counters import nibble_words

    kp = plan_to_torch(port_features.get_plan(measure), CPU)
    words = np.array(nibble_words(kp), dtype=np.uint32).reshape(-1, 2, 4)
    codes = np.concatenate([[0], ALL_CODES, [0, 0]]).astype(np.uint8)
    assert codes.size % 4 == 0
    for shift in range(4):
        rolled = np.roll(codes, shift)
        sel, hi = _split(rolled.view("<u4"))
        for k in range(kp.channels):
            for side, lut in ((0, kp.f_lut), (1, kp.g_lut)):
                got = _lookup(words[k, side], sel, hi).view(np.int8)
                np.testing.assert_array_equal(got, lut[k].numpy()[rolled])


@pytest.mark.parametrize("measure", MEASURES)
def test_cached_plan_carries_the_jax_plan(measure):
    """The unfolded carrier of the cached-feature path: the JAX plan's own
    channels (LUTs with the f side's sign), its counter slices or its mix
    and divisors, the same from either package."""
    jp = jax_features.get_plan(measure)
    cp = cached_plan_to_torch(jp, CPU)
    np.testing.assert_array_equal(cp.f_lut.numpy(), jp.f_luts)
    np.testing.assert_array_equal(cp.g_lut.numpy(), jp.g_luts)
    assert cp.channels == jp.total_channels
    assert cp.counters == len(jp.counters)
    assert cp.den == (1,) * cp.planes
    if jp.mix_num is None:
        assert cp.bounds == (0,) + tuple(hi for _, _, hi in jp.slices)
        assert cp.mix_num is None and cp.mix_den is None
    else:
        assert cp.bounds == tuple(range(jp.total_channels + 1))
        np.testing.assert_array_equal(np.array(cp.mix_num), jp.mix_num)
        np.testing.assert_array_equal(np.array(cp.mix_den), jp.mix_den)
    other = cached_plan_to_torch(port_features.get_plan(measure), CPU)
    assert torch.equal(other.f_lut, cp.f_lut)
    assert (other.bounds, other.mix_num, other.mix_den) == (
        cp.bounds, cp.mix_num, cp.mix_den)


@pytest.mark.parametrize("measure", MEASURES)
def test_cached_plan_nibble_tables_decide_every_code(measure):
    """K5's lookup (csrc/features.cu split, lookup, as csrc/counters.cu's)
    of the unfolded nibble tables gives each side's LUT feature for code
    0 and every Paradis code in every byte of a word; the folded form is
    K1's plan."""
    from distance_tpu_torch.encoding import ALL_CODES

    cp = cached_plan_to_torch(port_features.get_plan(measure), CPU)
    codes = np.concatenate([[0], ALL_CODES, [0, 0]]).astype(np.uint8)
    for nib, lut in ((cp.f_nib, cp.f_lut), (cp.g_nib, cp.g_lut)):
        words = np.ascontiguousarray(nib).view("<u4").reshape(-1, 4)
        for shift in range(4):
            rolled = np.roll(codes, shift)
            sel, hi = _split(rolled.view("<u4"))
            for k in range(cp.channels):
                got = _lookup(words[k], sel, hi).view(np.int8)
                np.testing.assert_array_equal(got, lut[k].numpy()[rolled])
    folded = fold_cached(port_features.get_plan(measure), CPU)
    kp = plan_to_torch(port_features.get_plan(measure), CPU)
    assert torch.equal(folded.f_lut, kp.f_lut)
    assert torch.equal(folded.g_lut, kp.g_lut)
    assert (folded.bounds, folded.den, folded.mix_num) == (
        kp.bounds, kp.den, None)

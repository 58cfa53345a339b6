"""The port's packing (``distance_tpu_torch/ops/packing.py``) against the
JAX package's ``distance_tpu/ops/packing.py`` with ``xp=np``, and the
engine's packed strips and pack ladder against the JAX engine's on the
CPU.

The plain versions of K2 (rel4, rel) and K4 (narrow, wide) must give the
lanes, words and the exception sidecar byte for byte; the host finish and
the copied unpackers must give back the counters; one strip of the port
(``_Strip``, packed again from its kept counters after its first rung)
must equal the JAX ``_dispatch_strip`` at ``--backend xla`` at every
rung, with the same tiles and the same reference row; and
the port's ``pack_mode`` must follow the JAX engine's through the same
sequence of saturations.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distance_tpu.engine as jax_engine  # noqa: E402
import distance_tpu.ops.packing as jax_packing  # noqa: E402
import distance_tpu_torch.engine as port_engine  # noqa: E402
from distance_tpu_torch.encoding import ALL_CODES  # noqa: E402
from distance_tpu_torch.measures import MEASURES  # noqa: E402
from distance_tpu_torch.ops import packing  # noqa: E402
from distance_tpu_torch.ops.counters import counters_torch  # noqa: E402
from distance_tpu_torch.ops.features import get_plan  # noqa: E402
from distance_tpu_torch.ops.plan import plan_to_torch  # noqa: E402
from tests.test_torch_cuda import REL4_EDGES, rel4_edge_counters  # noqa: E402

CPU = torch.device("cpu")
G_OF = {m: len(get_plan(m).counters) for m in MEASURES}


def outliers(rng, g, m, n, per_segment=((1, 1), (3, 2), (5, 3), (8, -1))):
    """int32 residuals in [-7, 7] but for segments holding 1, 2, 3 and
    every cell (-1) as outliers, -8 among them."""
    c = rng.integers(-7, 8, size=(g, m, n)).astype(np.int32)
    flat = c.reshape(-1)
    seg = -(-flat.size // packing.REL4_SEGMENTS)
    for s, k in per_segment:
        lo, hi = s * seg, min((s + 1) * seg, flat.size)
        if lo < hi:
            k = hi - lo if k < 0 else min(k, hi - lo)
            cells = rng.choice(np.arange(lo, hi), size=k, replace=False)
            flat[cells] = rng.choice([-8, 8, 127, -128, 300, -9000], size=k)
    return c


def random_block(rng, g, m, n, spread=7):
    c = outliers(rng, g, m, n)
    rb = rng.integers(-spread, spread + 1, (g, m)).astype(np.int32)
    cb = rng.integers(-spread, spread + 1, (g, n)).astype(np.int32)
    cc = rng.integers(-spread, spread + 1, g).astype(np.int32)
    return c, rb, cb, cc


def jax_mask(m, n, i0, j0, nv, diag_off):
    """The mask of the JAX block function (engine._jit_block_fn)."""
    ri = np.arange(m) + i0
    cj = np.arange(n) + j0
    mask = None
    if diag_off is not None:
        mask = (ri[:, None] + diag_off) == cj[None, :]
    if nv is not None:
        pad = (ri[:, None] >= nv[0]) | (cj[None, :] >= nv[1])
        mask = pad if mask is None else (mask | pad)
    return mask


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


MASKS = [(0, 0, None, None), (0, 0, None, 0), (5, 2, (40, 70), None),
         (3, 1, (30, 50), 2)]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("shape", [(33, 66), (64, 128), (1, 2), (129, 258)])
@pytest.mark.parametrize("measure", MEASURES)
def test_plain_rel4_equals_jax(measure, shape, mask):
    rng = np.random.default_rng(hash((measure, shape, mask)) % 2**32)
    m, n = shape
    c, rb, cb, cc = random_block(rng, G_OF[measure], m, n)
    mk = jax_mask(m, n, *mask)
    want = jax_packing.pack_device_rel4(c, rb, cb, cc, np, mk)
    got = packing.pack_rel4_torch(t(c), t(rb), t(cb), t(cc),
                                  None if mk is None else t(mk))
    for a, b in zip(got, want):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    # the wrapper takes the same mask from the block's coordinates
    i0, j0, nv, diag = mask
    got = packing.pack_rel4(t(c), t(rb), t(cb), t(cc), i0, j0,
                            nv or (i0 + m, j0 + n), diag)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("mask", MASKS[:2] + [(4, 0, None, -4)])
@pytest.mark.parametrize("shape", [(33, 65), (64, 128), (1, 1), (7, 3)])
@pytest.mark.parametrize("measure", MEASURES)
def test_plain_rel_equals_jax(measure, shape, mask):
    rng = np.random.default_rng(hash((measure, shape, mask, 1)) % 2**32)
    m, n = shape
    c, rb, cb, cc = random_block(rng, G_OF[measure], m, n, spread=60)
    i0, j0, _, diag = mask
    mk = jax_mask(m, n, i0, j0, None, diag)
    want = jax_packing.pack_device_rel(c, rb, cb, cc, np, mk)
    got = packing.pack_rel(t(c), t(rb), t(cb), t(cc), i0, j0, diag)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mask", [(0, 0, None, None), (3, 1, (-2, -3), 2)])
@pytest.mark.parametrize("every", [False, True])
@pytest.mark.parametrize("shape", REL4_EDGES)
def test_plain_rel4_equals_jax_at_segment_edges(shape, every, mask):
    """At segment lengths above 1, odd and even: a byte straddling two
    segments, segments with 0, 1, 2 and every cell out, the last segment
    partial, a residual of -2^31, and every cell out; masked and not.
    The plain rel4 (and rel) give the JAX lanes and sidecar byte for
    byte."""
    g, m, n = shape
    seg = -(-g * m * n // packing.REL4_SEGMENTS)
    assert seg in (2, 3, 7, 8)
    rng = np.random.default_rng(sum(shape) + every)
    c, rb, cb, cc = rel4_edge_counters(rng, g, m, n, every)
    i0, j0, nv, diag = mask
    if nv is not None:
        nv = (i0 + m + nv[0], j0 + n + nv[1])
    mk = jax_mask(m, n, i0, j0, nv, diag)
    want = jax_packing.pack_device_rel4(c, rb, cb, cc, np, mk)
    got = packing.pack_rel4(t(c), t(rb), t(cb), t(cc), i0, j0,
                            nv or (i0 + m, j0 + n), diag)
    for a, b in zip(got, want):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    firsts = int((want[1][:packing.REL4_SEGMENTS] >= 0).sum())
    assert firsts >= 4
    want = jax_packing.pack_device_rel(c, rb, cb, cc, np,
                                       jax_mask(m, n, i0, j0, None, diag))
    got = packing.pack_rel(t(c), t(rb), t(cb), t(cc), i0, j0, diag)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segments_with_0_1_2_and_3_outliers():
    """First and last outlier of a segment travel in the sidecar; a third
    stays a -8 sentinel, so the host finish reports the saturation (and
    a segment with two is patched exactly), as the JAX finish does."""
    rng = np.random.default_rng(5)
    g, m, n = 2, 64, 256  # 32768 cells: segments of 4
    base = rng.integers(-7, 8, size=(g, m, n)).astype(np.int32)
    z = (np.zeros((g, m), np.int32), np.zeros((g, n), np.int32),
         np.zeros(g, np.int32))
    for k in (0, 1, 2, 3):
        c = base.copy()
        flat = c.reshape(-1)
        flat[40:40 + k] = [100, -8, 9][:k]  # segment 10
        lanes, ei, ev = packing.pack_rel4_torch(t(c), *(t(a) for a in z))
        want = jax_packing.pack_device_rel4(c, *z, np)
        for a, b in zip((lanes, ei, ev), want):
            np.testing.assert_array_equal(a.numpy(), b)
        first, last = ei[10].item(), ei[packing.REL4_SEGMENTS + 10].item()
        assert first == (40 if k else -1)
        assert last == (39 + k if k >= 2 else -1)
        bundle = packing.bundle_sidecars(t(z[1]), t(np.concatenate(
            [z[0], z[2][:, None]], 1)), ei, ev).numpy()
        counters, was4 = port_engine._unpack_rel_parts(
            None, (lanes.numpy(), bundle), m, n)
        assert was4
        if k <= 2:
            np.testing.assert_array_equal(counters, c)
        else:
            assert counters is None


@pytest.mark.parametrize("exc", [False, True])
@pytest.mark.parametrize("blocks", [1, 3])
def test_bundle_equals_jax(blocks, exc):
    rng = np.random.default_rng(blocks)
    g, ti, span = 3, 17, 40
    cb = rng.integers(-99, 99, (g, span)).astype(np.int32)
    rb_cc = rng.integers(-99, 99, (g, ti + 1)).astype(np.int32)
    extra = ()
    if exc:
        shape = (blocks, packing.REL4_EXC_CAP) if blocks > 1 else (
            packing.REL4_EXC_CAP,)
        extra = (rng.integers(-1, 9, shape).astype(np.int32),
                 rng.integers(-9, 9, shape).astype(np.int32))
    want = jax_packing.bundle_sidecars(np, cb, rb_cc, *extra)
    got = packing.bundle_sidecars(t(cb), t(rb_cc), *(t(a) for a in extra))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def real_block(rng, measure, m, n, width, mutations):
    """K1 counters of two low-diversity code matrices and their baselines
    against the per-column mode of both."""
    from distance_tpu_torch.ops.diffup import mode_row

    anc = rng.choice(ALL_CODES[:4], width).astype(np.uint8)
    mat = np.repeat(anc[None], m + n, 0)
    hits = rng.random(mat.shape) < mutations
    mat[hits] = rng.choice(ALL_CODES, int(hits.sum()))
    ref = mode_row(mat)[None]
    plan = plan_to_torch(get_plan(measure), CPU)
    x, y, r = t(mat[:m]), t(mat[m:]), t(ref)
    return (counters_torch(x, y, plan), counters_torch(x, r, plan)[:, :, 0],
            counters_torch(r, y, plan)[:, 0, :],
            counters_torch(r, r, plan)[:, 0, 0])


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("measure", MEASURES)
def test_host_finish_round_trips(measure, native, monkeypatch):
    """Blocks packed at rel4 (and rel) and bundled as a strip of three
    blocks come back to the counters through the copied host finish, on
    the native path and the numpy one; crops past padding too."""
    import distance_tpu_torch._native as native_mod

    if not native:
        monkeypatch.setattr(native_mod, "get_lib", lambda: None)
    rng = np.random.default_rng(11)
    tj = 96
    c, rb, cb, cc = real_block(rng, measure, 70, 3 * tj, 300, 0.08)
    rb_cc = torch.cat([rb, cc[:, None]], 1)
    for mode in ("rel4", "rel"):
        parts = []
        for b in range(3):
            blk = (c[:, :, b * tj:(b + 1) * tj], rb,
                   cb[:, b * tj:(b + 1) * tj], cc)
            parts.append(packing.pack_rel4(*blk) if mode == "rel4"
                         else (packing.pack_rel(*blk),))
        lanes = torch.cat([p[0] for p in parts], -1)
        extra = ()
        if mode == "rel4":
            extra = (torch.stack([p[1] for p in parts]),
                     torch.stack([p[2] for p in parts]))
        bundle = packing.bundle_sidecars(cb, rb_cc, *extra)
        for vr, vc in ((70, 3 * tj), (61, 250)):
            got, was4 = port_engine._unpack_rel_parts(
                None, (lanes.numpy(), bundle.numpy()), vr, vc)
            assert was4 == (mode == "rel4")
            np.testing.assert_array_equal(got, c[:, :vr, :vc].numpy())


def test_wrappers_refuse_odd_rel4_columns_and_mismatched_baselines():
    z = torch.zeros((1, 3, 5), dtype=torch.int32)
    b3, b5 = torch.zeros((1, 3), dtype=torch.int32), torch.zeros(
        (1, 5), dtype=torch.int32)
    cc = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="odd"):
        packing.pack_rel4(z, b3, b5, cc)
    assert packing.pack_rel(z, b3, b5, cc).shape == (1, 3, 5)
    with pytest.raises(ValueError, match="do not fit"):
        packing.pack_rel(z, b5, b3, cc)
    with pytest.raises(ValueError, match="int32"):
        packing.pack_rel(z.long(), b3, b5, cc)
    with pytest.raises(ValueError, match="CUDA"):
        packing.pack_rel4_cuda(torch.zeros((1, 3, 4), dtype=torch.int32), b3,
                               torch.zeros((1, 4), dtype=torch.int32), cc)


def low_diversity(rng, n, width, mutations=0.03):
    anc = rng.choice(ALL_CODES[:4], width).astype(np.uint8)
    mat = np.repeat(anc[None], n, 0)
    hits = rng.random(mat.shape) < mutations
    mat[hits] = rng.choice(ALL_CODES, int(hits.sum()))
    return mat


@pytest.mark.parametrize("diff", ["on", "off"])
@pytest.mark.parametrize("mode", ["square", "rectangle"])
@pytest.mark.parametrize("measure", ["raw", "tn93", "n", "k80"])
def test_dispatch_strip_equals_jax(measure, mode, diff, monkeypatch):
    """One strip of several blocks (the last ragged) of a small alignment:
    the port's (lanes, bundle) equals the JAX engine's at --backend xla on
    the CPU, byte for byte, with the same tiles and reference row, at
    rel4 and, packed again from the kept counters, at rel, narrow and
    wide; with diff uploads (pad rows hold the reference row) and dense
    ones."""
    if diff == "off":
        monkeypatch.setenv("DISTANCE_TPU_NO_DIFF_UPLOAD", "1")
    rng = np.random.default_rng(17)
    n1, n2, width, ti, tj = 50, 70, 300, 16, 32
    src1 = low_diversity(rng, n1, width)
    src2 = src1 if mode == "square" else low_diversity(rng, n2, width)
    n2 = src2.shape[0]
    jeng = jax_engine._BlockEngine(measure, "xla", ti, tj, width)
    peng = port_engine._BlockEngine(measure, [CPU], ti, width, rel=True,
                                    tj=tj)
    dref = jeng.diff_ref_for(src1)
    pref = peng.diff_ref_for(src1)
    if diff == "on":
        np.testing.assert_array_equal(dref, pref)
    if mode == "square":
        jm1 = jm2 = jeng.prepare(src1, max(ti, tj), diff_ref=dref)
        pm1 = pm2 = peng.prepare(src1, max(ti, tj), diff_ref=pref)
        diag = 0
    else:
        jm1 = jeng.prepare(src1, ti, diff_ref=dref, cache_g=False)
        jm2 = jeng.prepare(src2, tj, diff_ref=dref)
        pm1 = peng.prepare(src1, ti, diff_ref=pref)
        pm2 = peng.prepare(src2, tj, diff_ref=pref)
        diag = None
    assert (jeng.diff_up is None) == (diff == "off")
    np.testing.assert_array_equal(np.asarray(jm2), pm2.numpy())
    for i0 in (0, 32):
        col_starts = list(range(i0 if mode == "square" else 0, n2, tj))
        # one strip, dispatched at rel4 and packed again at each later rung
        # from its kept counters
        strip = port_engine._Strip(peng, pm1, pm2, i0, col_starts, ti, tj,
                                   (n1, n2), diag)
        for rung in ("rel4", "rel", "narrow", "wide"):
            want = jax_engine._dispatch_strip(
                jeng, jm1, jm2, i0, col_starts, ti, tj, rung, nv=(n1, n2))
            got = strip(rung)
            if rung in ("narrow", "wide"):
                got, want = (got,), (want,)
            for a, b in zip(got, want):
                assert a.numpy().dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- K4: narrow and wide -------------------------------------------------------

WIDTHS = [1, 300, 29904, (1 << 16) - 1]


def counters_near_saturation(rng, measure, m, n, width):
    """(G, m, n) int32 counters of ``measure`` whose narrow lanes fall on
    either side of 255 (254, 255, 256 and far past it, and ``width - sum``
    at 255), with random cells between."""
    g = G_OF[measure]
    c = rng.integers(0, max(2, min(width, 600)), size=(g, m, n)).astype(
        np.int32)
    flat = c.reshape(g, -1)
    picks = [254, 255, 256, 1000, 0, width, (1 << 16) - 1]
    for k, v in enumerate(picks):
        flat[:, k % flat.shape[1]] = v
    # the first lane of raw, k80 and tn93 at exactly 255 below the width
    cell = len(picks) % flat.shape[1]
    flat[:, cell] = 0
    if measure in ("raw", "jc69"):
        flat[0, cell], flat[1, cell] = 0, width - 255
    elif measure == "k80":
        flat[0, cell] = width - 255
    elif measure == "tn93":
        flat[1, cell] = width - 255
    return c


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("shape", [(1, 1), (33, 65), (64, 128)])
@pytest.mark.parametrize("measure", MEASURES)
def test_plain_narrow_and_wide_equal_jax(measure, shape, width):
    rng = np.random.default_rng(hash((measure, shape, width)) % 2**32)
    c = counters_near_saturation(rng, measure, *shape, width)
    want = jax_packing.pack_device_narrow(measure, c, width, np)
    got = packing.pack_narrow(measure, t(c), width)
    assert got.dtype == torch.int8 and want.dtype == np.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        packing.pack_narrow_torch(measure, t(c), width).numpy(), want)
    want = jax_packing.pack_device(measure, c, np)
    got = packing.pack_wide(measure, t(c))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        packing.pack_wide_torch(measure, t(c)).numpy(), want)


@pytest.mark.parametrize("measure", MEASURES)
def test_narrow_and_wide_wrap_as_numpy_does(measure):
    """Counters outside a lane's range (negative, past 2^16, near 2^31):
    the casts wrap as numpy's astype does."""
    rng = np.random.default_rng(7)
    g = G_OF[measure]
    c = rng.choice(np.array([-1, -256, -70000, 65535, 65536, 70000,
                             (1 << 30) + 5, -(1 << 30)], np.int32),
                   size=(g, 9, 11))
    for width in (0, 255, 40000):
        np.testing.assert_array_equal(
            packing.pack_narrow_torch(measure, t(c), width).numpy(),
            jax_packing.pack_device_narrow(measure, c, width, np))
    np.testing.assert_array_equal(packing.pack_wide_torch(measure, t(c)).numpy(),
                                  jax_packing.pack_device(measure, c, np))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("measure", MEASURES)
def test_copied_unpackers_round_trip(measure, width):
    """Real counters (K1 of low-diversity codes) come back through the
    copied ``unpack_host`` (wide) and ``unpack_host_narrow``; a saturated
    narrow lane gives None."""
    rng = np.random.default_rng(width)
    anc = rng.choice(ALL_CODES[:4], width).astype(np.uint8)
    mat = np.repeat(anc[None], 30, 0)
    hits = rng.random(mat.shape) < min(0.5, 20 / width)
    mat[hits] = rng.choice(ALL_CODES, int(hits.sum()))
    plan = plan_to_torch(get_plan(measure), CPU)
    c = counters_torch(t(mat[:13]), t(mat[13:]), plan)
    wide = packing.pack_wide(measure, c).numpy()
    np.testing.assert_array_equal(packing.unpack_host(measure, wide),
                                  c.numpy())
    narrow = packing.pack_narrow(measure, c, width).numpy()
    back = packing.unpack_host_narrow(measure, narrow, width)
    if (narrow.view(np.uint8) == packing.NARROW_SAT).any():
        assert back is None
    else:
        np.testing.assert_array_equal(back, c.numpy())


def test_narrow_lane_at_255_saturates():
    c = np.zeros((2, 1, 3), np.int32)
    c[0, 0] = [254, 255, 10]
    c[1, 0] = [0, 0, 1000 - 10 - 255]  # width - (diff + same) = 255
    lanes = packing.pack_narrow("raw", t(c), 1000).numpy()
    assert lanes.view(np.uint8).tolist() == [[[254, 255, 10]],
                                             [[255, 255, 255]]]
    assert packing.unpack_host_narrow("raw", lanes[:, :, :1], 1000) is None
    c[1, 0, 0] = 1000 - 254 - 254  # both lanes 254: not saturated
    back = packing.unpack_host_narrow(
        "raw", packing.pack_narrow("raw", t(c), 1000).numpy()[:, :, :1], 1000)
    np.testing.assert_array_equal(back, c[:, :, :1])


def test_narrow_and_wide_wrappers_refuse():
    c = torch.zeros((2, 3, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="tn93 packs"):
        packing.pack_narrow("tn93", c, 100)
    with pytest.raises(ValueError, match="int32"):
        packing.pack_wide("raw", c.long())
    with pytest.raises(ValueError):
        packing.pack_wide("nope", c)
    with pytest.raises(ValueError, match="CUDA"):
        packing.pack_narrow_cuda("raw", c, 100)
    with pytest.raises(ValueError, match="CUDA"):
        packing.pack_wide_cuda("raw", c)
    with pytest.raises(ValueError, match="int32"):
        packing.pack_narrow_cuda("raw", c, 1 << 31)


# -- the pack ladder beside the JAX engine's ---------------------------------

def ladder_pair(width):
    # tile_j 16: the JAX rel4 rung's halved lane axis must divide the
    # 8-device mesh of the tests
    return (jax_engine._BlockEngine("raw", "xla", 8, 16, width=width),
            port_engine._BlockEngine("raw", [CPU], 8, width, rel=True,
                                     tj=16))


def test_sticky_escalation_ladder_equals_jax():
    """tests/test_packing.py's ladder, on both engines side by side: with a
    reference row rel4 -> rel -> narrow/wide, without one narrow -> wide;
    a clean fetch resets each streak."""
    from distance_tpu_torch.engine import NARROW_STICKY_LIMIT

    jeng, peng = ladder_pair(600)
    assert peng.packed == jeng.packed is True

    def same(want_mode):
        assert peng.pack_mode == jeng.pack_mode == want_mode
        assert peng.mode_for(16) == jeng.stream_pack_mode

    def note(kind, saturated):
        getattr(jeng, f"note_{kind}")(saturated)
        getattr(peng, f"note_{kind}")(saturated)

    same("narrow")
    for _ in range(NARROW_STICKY_LIMIT - 1):
        note("narrow", True)
    same("narrow")
    note("narrow", False)
    same("narrow")
    for _ in range(NARROW_STICKY_LIMIT):
        note("narrow", True)
    same("wide")
    jeng.rel_ref = peng.rel_ref = object()
    same("rel4")
    for _ in range(NARROW_STICKY_LIMIT - 1):
        note("rel4", True)
    same("rel4")
    note("rel4", False)
    same("rel4")
    for _ in range(NARROW_STICKY_LIMIT):
        note("rel4", True)
    same("rel")
    for _ in range(NARROW_STICKY_LIMIT):
        note("rel", True)
    same("wide")
    note("narrow", False)  # a clean narrow fetch: narrow again
    same("narrow")


@pytest.mark.parametrize("width", [0, 1, 600, (1 << 16) - 1, 1 << 16, 70000])
@pytest.mark.parametrize("seed", range(4))
def test_random_saturations_walk_both_ladders_alike(width, seed):
    """Random sequences of fetch outcomes at every rung, at widths on
    either side of 2^16 (and 0): the port's rung equals the JAX engine's
    after every step."""
    jeng, peng = ladder_pair(width)
    assert peng.packed == jeng.packed
    rng = np.random.default_rng(seed)
    if seed % 2:
        jeng.rel_ref = peng.rel_ref = object()
    for _ in range(60):
        kind = rng.choice(["narrow", "rel4", "rel"])
        saturated = bool(rng.random() < 0.6)
        getattr(jeng, f"note_{kind}")(saturated)
        getattr(peng, f"note_{kind}")(saturated)
        assert peng.pack_mode == jeng.pack_mode

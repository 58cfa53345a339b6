"""Host emission and pruning helpers of the square sweep.

Copied verbatim from ``distance_tpu.engine`` (the JAX engine keeps its
own): importing anything from ``distance_tpu`` loads jax, and the port
must run where jax is not installed.  ``tests/test_torch_host_copies.py``
pins every function here to its counterpart's source text, less the
repairs it lists (the tn93 memo's bail-outs are timed).
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np

from distance_tpu_torch.fastaio import Alignment
from distance_tpu_torch.finalize import finalize_block
from distance_tpu_torch.utils import timing
from distance_tpu_torch.utils.timing import phase_timer

if TYPE_CHECKING:
    from distance_tpu_torch.engine import Setup


def _emit_pairs(
    setup: Setup,
    aln1: Alignment,
    aln2: Alignment,
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    counters: Dict[str, np.ndarray],
    same_offset: int = 0,
    emitter=None,
    after=None,
    pool: Optional[_ScratchPool] = None,
    lease: Optional[List[np.ndarray]] = None,
) -> None:
    """Finalize + write one flat batch of pairs (already in order).

    ``same_offset`` re-adds exact-base invariant columns dropped by
    column pruning (they contribute +1 to ``same``/``kk`` per pair and
    nothing to any other counter).  With an ``emitter``, the formatting/
    write tail (plus the ``after`` callback — progress checkpointing)
    runs on the ordered writer thread, overlapped with the next strip.
    tn93's per-pair base tallies are never materialized: the native
    finalizer gathers rows from the per-sequence tables using the same
    index arrays that drive id emission.
    """
    if same_offset:
        for key in ("same", "kk"):
            arr = counters.get(key)
            if arr is None:
                continue
            if arr.flags.writeable:
                # in place: these are this emission's own gather/lease
                # buffers, and a fresh multi-GB array per strip is
                # exactly what the scratch pool exists to avoid
                np.add(arr, same_offset, out=arr)
            else:
                counters[key] = arr + same_offset
    bc = None
    if setup.measure == "tn93":
        bc = (aln1.base_counts, pair_i, aln2.base_counts, pair_j)
    with phase_timer("keys"):
        if (
            setup.measure == "tn93"
            and aln1.base_counts is not None
            and aln2.base_counts is not None
        ):
            keys, keyspace = _tn93_value_keys(
                counters, aln1.tally_ranks(), pair_i,
                aln2.tally_ranks(), pair_j, pool, lease,
            )
        else:
            keys, keyspace = _value_keys(setup.measure, counters,
                                         aln1.width, pool, lease)
    if keys is not None:
        # Memoized tail: the writer ranks the keys and calls back with
        # one representative row per DISTINCT key — finalize runs over
        # thousands of rows instead of millions (the f64 logs and the
        # per-pair value array both vanish from the hot path).  Equal
        # keys imply equal counters (and, for tn93, equal tally rows)
        # imply bit-identical values, so any representative is exact.
        measure = setup.measure

        def values(first_rows: Optional[np.ndarray]) -> np.ndarray:
            if first_rows is None:
                with phase_timer("finalize"):
                    return finalize_block(measure, counters, bc)
            sub = {k: v[first_rows] for k, v in counters.items()}
            sbc = None
            if bc is not None:
                bcq, iq, bct, it = bc
                sbc = (bcq, iq[first_rows], bct, it[first_rows])
            with phase_timer("finalize"):
                return finalize_block(measure, sub, sbc)
    else:
        out = None
        if (
            pool is not None and lease is not None
            and setup.measure not in ("n", "n_high")
        ):
            n_rows = next(iter(counters.values())).shape[0]
            out = pool.take(n_rows, np.float64, lease)
        with phase_timer("finalize"):
            values = finalize_block(setup.measure, counters, bc, out=out)

    def tail() -> None:
        with phase_timer("write"):
            setup.writer.rows(
                aln1.ids, aln2.ids, pair_i, pair_j, values, keys, keyspace
            )
        if after is not None:
            after()
        if pool is not None and lease:
            pool.give_all(lease)

    if emitter is None:
        tail()
    else:
        emitter.submit(tail)


# Upper bound on the memo keyspace: the writer's rank table is one int32
# per key (dt_key_rank), so 2^26 caps it at 256 MB — far above any
# realistic tight packing (see _value_keys), present only as a backstop
# against adversarial counter spreads.
_KEYSPACE_CAP = 1 << 26


def _lin3_native(lib, out, a, b, c, ca, cb, cc, c0):
    """Parallel out = ca*a + cb*b (+ cc*c) + c0 over int32 arrays."""
    import ctypes

    from distance_tpu_torch.finalize import _get_pool

    p32 = ctypes.POINTER(ctypes.c_int32)
    n = out.shape[0]
    step = max(1 << 21, -(-n // 8))

    def run(lo):
        hi = min(lo + step, n)
        lib.dt_keys_lin3(
            a[lo:hi].ctypes.data_as(p32), b[lo:hi].ctypes.data_as(p32),
            c[lo:hi].ctypes.data_as(p32) if c is not None else None,
            hi - lo, ca, cb, cc, c0, out[lo:hi].ctypes.data_as(p32),
        )

    futs = [_get_pool().submit(run, lo) for lo in range(0, n, step)]
    for f in futs:
        f.result()


def _minmax_native(lib, a):
    import ctypes

    mn = ctypes.c_int32()
    mx = ctypes.c_int32()
    lib.dt_minmax_i32(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), 0, a.shape[0],
        ctypes.byref(mn), ctypes.byref(mx),
    )
    return mn.value, mx.value


def _value_keys(measure: str, counters: Dict[str, np.ndarray], width: int,
                pool: Optional[_ScratchPool] = None, lease=None):
    """Per-pair integer keys that determine the finalized value.

    A pair's distance is a pure function of its counters (plus the
    constant alignment width); packing them into a small key lets the
    writer finalize + format each DISTINCT value once (sort-free
    memoization).  Packing is tight — mixed-radix over the counters'
    actual maxima — because realistic ambiguity loads (~150 N/gap sites
    per record -> pair nonsame ~300) overflow any fixed 8-bit field; the
    round-2 static packing silently disabled the memo for raw/jc69/k80
    on exactly the data it was built for.  tn93 is excluded — its value
    also depends on the pair's base tallies.

    Every keyed measure's key is LINEAR in its counters given width, so
    the native path builds keys in one fused parallel pass
    (dt_keys_lin3) instead of a chain of numpy temporaries (~2.5 s ->
    ~0.3 s per 74 M-pair strip measured on the 4-core bench host).
    """
    from distance_tpu_torch._native import get_lib

    lib = get_lib()

    def scratch(n):
        if pool is not None and lease is not None:
            return pool.take(n, np.int32, lease)
        return np.empty(n, dtype=np.int32)

    if measure in ("n", "n_high"):
        d = counters["diff"]
        if not d.size:
            return None, 0
        dm = int(d.max(initial=0))
        if dm >= _KEYSPACE_CAP:
            return None, 0
        return np.asarray(d, dtype=np.int32), dm + 1
    native = (
        lib is not None
        and all(
            v.dtype == np.int32 and v.flags.c_contiguous
            for v in counters.values()
        )
    )
    if measure in ("raw", "jc69"):
        d, same = counters["diff"], counters["same"]
        if not d.size:
            return None, 0
        if native:
            nsum = scratch(d.shape[0])
            _lin3_native(lib, nsum, d, same, None, 1, 1, 0, 0)
            s_mn, s_mx = _minmax_native(lib, nsum)
            _, d_mx = _minmax_native(lib, d)
            if s_mx > width:  # negative nonsame somewhere
                return None, 0
            nm = width - s_mn + 1
            if (d_mx + 1) * nm > _KEYSPACE_CAP:
                return None, 0
            keys = nsum  # reuse the buffer: keys = nm*d - nsum + width
            _lin3_native(lib, keys, d, nsum, None, nm, -1, 0, width)
            return keys, (d_mx + 1) * nm
        nonsame = width - (same + d)
        if int(nonsame.min(initial=0)) < 0:
            return None, 0
        dm = int(d.max(initial=0)) + 1
        nm = int(nonsame.max(initial=0)) + 1
        if dm * nm > _KEYSPACE_CAP:
            return None, 0
        return (d * np.int32(nm) + nonsame).astype(np.int32), dm * nm
    if measure == "k80":
        same, ts, tv = counters["same"], counters["ts"], counters["tv"]
        if not ts.size:
            return None, 0
        if native:
            nsum = scratch(ts.shape[0])
            _lin3_native(lib, nsum, same, ts, tv, 1, 1, 1, 0)
            s_mn, s_mx = _minmax_native(lib, nsum)
            _, t_mx = _minmax_native(lib, ts)
            _, v_mx = _minmax_native(lib, tv)
            if s_mx > width:
                return None, 0
            tm, vm, lm = t_mx + 1, v_mx + 1, width - s_mn + 1
            if tm * vm * lm > _KEYSPACE_CAP:
                return None, 0
            # key = (W - nsum)*tm*vm + ts*vm + tv
            keys = nsum
            _lin3_native(lib, keys, ts, tv, nsum, vm, 1, -tm * vm,
                         width * tm * vm)
            return keys, tm * vm * lm
        nonl = width - (same + ts + tv)
        if int(nonl.min(initial=0)) < 0:
            return None, 0
        tm = int(ts.max(initial=0)) + 1
        vm = int(tv.max(initial=0)) + 1
        lm = int(nonl.max(initial=0)) + 1
        if tm * vm * lm > _KEYSPACE_CAP:
            return None, 0
        keys = (nonl * np.int32(tm) + ts) * np.int32(vm) + tv
        return keys.astype(np.int32), tm * vm * lm
    return None, 0


def _tn93_value_keys(counters: Dict[str, np.ndarray], rq, pair_i, rt,
                     pair_j, pool: Optional[_ScratchPool] = None,
                     lease=None):
    """tn93 memo keys: (counter key, tally-rank-q, tally-rank-t).

    tn93's value is a pure function of (kk, kk - same, p1, p2) and the
    pairwise tally SUM (finalize_tn93, measures.rs:116-193) — equal
    per-side tally rows imply an equal sum, so distinct tally rows
    ranked once per side (Alignment.tally_ranks) make the value keyable.
    When counter-space x Rq x Rt fits _KEYSPACE_CAP the key is dense
    (mixed radix); beyond that a native hash-rank pass
    (dt_keys_hashrank_slots, chunked across the pool) densifies the
    OCCURRING combinations — on
    duplicate-heavy real datasets (identical records => identical
    tallies) those are few even when the product space is astronomical.
    The maximal-diversity worst case (every record a distinct tally)
    bails inside the hash pass the moment distinct keys exceed the
    budget, at a bounded partial-pass cost.  Each bail-out (there, or
    before it where the spread is too wide for the hash path) adds one
    to the total ``keys-bail``, with the call's seconds up to it.

    ``rq``/``rt``: (rank int32 array indexed by pair_i/pair_j, cardinality).
    """
    from distance_tpu_torch._native import get_lib

    lib = get_lib()
    rank_q, rq_card = rq
    rank_t, rt_card = rt
    kk, same = counters["kk"], counters["same"]
    p1, p2 = counters["p1"], counters["p2"]
    n = kk.shape[0]
    if not n:
        return None, 0
    t0 = time.perf_counter()

    def scratch(m):
        if pool is not None and lease is not None:
            return pool.take(m, np.int32, lease)
        return np.empty(m, dtype=np.int32)

    native = (
        lib is not None
        and all(
            v.dtype == np.int32 and v.flags.c_contiguous
            for v in (kk, same, p1, p2, pair_i, pair_j, rank_q, rank_t)
        )
    )
    if native:
        d = scratch(n)
        _lin3_native(lib, d, kk, same, None, 1, -1, 0, 0)
        kk_mn, kk_mx = _minmax_native(lib, kk)
        d_mn, d_mx = _minmax_native(lib, d)
        p1_mn, p1_mx = _minmax_native(lib, p1)
        p2_mn, p2_mx = _minmax_native(lib, p2)
    else:
        d = (kk - same).astype(np.int32)
        kk_mn, kk_mx = int(kk.min()), int(kk.max())
        d_mn, d_mx = int(d.min()), int(d.max())
        p1_mn, p1_mx = int(p1.min()), int(p1.max())
        p2_mn, p2_mx = int(p2.min()), int(p2.max())
    km = kk_mx - kk_mn + 1
    dm = d_mx - d_mn + 1
    p1m = p1_mx - p1_mn + 1
    p2m = p2_mx - p2_mn + 1
    cspace = km * dm * p1m * p2m
    keyspace = cspace * rq_card * rt_card
    dense = keyspace <= _KEYSPACE_CAP
    if not dense and (
        not native or keyspace > (1 << 62) or cspace > (1 << 31)
    ):
        # the hash path needs the native lib, a 64-bit combined key, and
        # a counter key that fits int32 (keyc is built by dt_keys_lin3
        # into an int32 buffer; cspace beyond 2^31 would truncate it and
        # collide DISTINCT counter tuples onto one memo key — silently
        # wrong values).  Spreads that wide mean maximal diversity,
        # where the memo would not pay anyway.
        timing.add("keys-bail", time.perf_counter() - t0, 1)
        return None, 0
    # key_c = ((kk-kk_mn)*dm + (d-d_mn))*p1m*p2m + (p1-p1_mn)*p2m + (p2-p2_mn)
    a_co = dm * p1m * p2m
    b_co = p1m * p2m
    c0 = -(kk_mn * a_co + d_mn * b_co + p1_mn * p2m + p2_mn)
    if native:
        import ctypes

        t = scratch(n)
        _lin3_native(lib, t, kk, d, None, a_co, b_co, 0, c0)
        keyc = d  # reuse: d is consumed
        _lin3_native(lib, keyc, p1, p2, t, p2m, 1, 1, 0)
        keys = t  # reuse
        p32 = ctypes.POINTER(ctypes.c_int32)
        if dense:
            lib.dt_keys_rank2(
                keyc.ctypes.data_as(p32), pair_i.ctypes.data_as(p32),
                pair_j.ctypes.data_as(p32), rank_q.ctypes.data_as(p32),
                rank_t.ctypes.data_as(p32), n, rq_card, rt_card,
                keys.ctypes.data_as(p32),
            )
            return keys, keyspace
        # Hash-rank: the dense product space is too large, but the
        # OCCURRING combinations may be few (duplicate-heavy data).
        # Produces already-dense keys, so the writer's rank table is
        # exactly n_distinct; bails the moment distinct keys exceed the
        # budget (memo would not pay), costing a bounded partial pass.
        # Three phases so the row passes parallelize (the serial
        # single-pass version measured 5.2 s at 401 M rows): (1) chunks
        # CAS-claim slots in a shared table, out = slot index; (2) the
        # <= 2^20 occupied slots rank in ascending-key order (numpy,
        # deterministic regardless of racy slot placement); (3) chunks
        # map slot -> rank in place.
        max_distinct = min(1 << 20, max(1024, n // 4))
        table_bits = max(12, (2 * max_distinct - 1).bit_length())
        tsize = 1 << table_bits
        key_tab = np.full(tsize, -1, dtype=np.int64)
        nd_ctr = np.zeros(1, dtype=np.int64)
        p64 = ctypes.POINTER(ctypes.c_int64)
        from distance_tpu_torch.finalize import _get_pool

        tpool = _get_pool()
        step = max(1 << 21, -(-n // max(1, tpool._max_workers)))

        def run1(lo, hi):
            return lib.dt_keys_hashrank_slots(
                keyc.ctypes.data_as(p32), pair_i.ctypes.data_as(p32),
                pair_j.ctypes.data_as(p32), rank_q.ctypes.data_as(p32),
                rank_t.ctypes.data_as(p32), lo, hi, rq_card, rt_card,
                key_tab.ctypes.data_as(p64), table_bits, max_distinct,
                nd_ctr.ctypes.data_as(p64), keys.ctypes.data_as(p32),
            )

        futs = [
            tpool.submit(run1, lo, min(lo + step, n))
            for lo in range(0, n, step)
        ]
        # await EVERY chunk before deciding: a short-circuit on the
        # first overflow would return (and later recycle the pool lease
        # backing `keys`) while straggler chunks are still writing into
        # it — cross-strip buffer corruption
        if any(r < 0 for r in [f.result() for f in futs]):
            timing.add("keys-bail", time.perf_counter() - t0, 1)
            return None, 0
        nd = int(nd_ctr[0])
        occ = np.flatnonzero(key_tab != -1)
        rank_tab = np.empty(tsize, dtype=np.int32)
        rank_tab[occ[np.argsort(key_tab[occ])]] = np.arange(
            nd, dtype=np.int32
        )

        def run3(lo, hi):
            lib.dt_map_i32(
                rank_tab.ctypes.data_as(p32), lo, hi,
                keys.ctypes.data_as(p32),
            )

        futs = [
            tpool.submit(run3, lo, min(lo + step, n))
            for lo in range(0, n, step)
        ]
        for f in futs:
            f.result()
        return keys, nd
    keyc = (
        (kk.astype(np.int64) - kk_mn) * a_co + (d.astype(np.int64) - d_mn) * b_co
        + (p1.astype(np.int64) - p1_mn) * p2m + (p2.astype(np.int64) - p2_mn)
    )
    keys = (
        keyc * (rq_card * rt_card)
        + rank_q[pair_i].astype(np.int64) * rt_card + rank_t[pair_j]
    )
    return keys.astype(np.int32), keyspace


def _tri_indices(si: int, i0: int, n: int):
    """Vectorized emission indices for one square-mode strip.

    Rows i0..i0+si-1; row i emits columns i+1..n.  Returns
    (local_rows int32, col_idx int32) in canonical (row-major) order.
    """
    rows = np.arange(si, dtype=np.int64)
    counts = np.maximum(n - (i0 + rows) - 1, 0)
    total = int(counts.sum())
    local_rows = np.repeat(np.arange(si, dtype=np.int32), counts)
    # concatenated ranges [i+1, n): global position minus the start of
    # this row's run, plus the row's first column (fused int32 — the
    # widened-int64 form of this arithmetic is ~100x slower)
    starts = np.zeros(si, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    first_col = i0 + rows + 1
    col_idx = np.arange(total, dtype=np.int32) - np.repeat(
        (starts - first_col).astype(np.int32), counts
    )
    return local_rows, col_idx


class _ScratchPool:
    """Recycled large scratch arrays for the emission tail.

    Strips allocate multi-GB gather/key/index buffers; on VM hosts with
    lazy guest-memory faulting (measured here: first-touch 1.8 GB/s vs
    5.9 GB/s warm, with DAMON reclaim re-chilling freed pages) fresh
    allocations per strip dominate the tail.  The pool hands back the
    previous strip's buffers instead — square-mode strips shrink
    monotonically, so the first strip's buffers fit all later ones.
    take() is called on the producing thread, give() by the emitter
    thread after the rows are written.
    """

    def __init__(self) -> None:
        import threading

        self._lock = threading.Lock()
        self._free: Dict[str, List[np.ndarray]] = {}

    def take(self, n: int, dtype, lease: List[np.ndarray]) -> np.ndarray:
        """A 1-D array of ``n`` elements; its backing root is appended to
        ``lease`` for give_all() once the consumer is done with it."""
        key = np.dtype(dtype).str
        root = None
        with self._lock:
            lst = self._free.get(key)
            if lst:
                for k, arr in enumerate(lst):
                    if arr.shape[0] >= n:
                        root = lst.pop(k)
                        break
        if root is None:
            root = np.empty(n, dtype=dtype)
        lease.append(root)
        return root[:n]

    def give_all(self, lease: List[np.ndarray]) -> None:
        with self._lock:
            for root in lease:
                self._free.setdefault(root.dtype.str, []).append(root)
        lease.clear()


def _gather_emit(strip: np.ndarray, si: int, i0: int, n: int, col0: int,
                 pool: Optional[_ScratchPool] = None, lease=None,
                 tri: bool = True):
    """Fused gather + emission-index build for one strip.

    ``tri``: square-mode upper triangle (row li emits columns > i0+li);
    False emits full rows (rectangle / two-file mode, hi = n - col0
    columns each).  Returns (counter_rows, pair_i, col_idx) —
    counter_rows[g] is the g-th counter gathered over the emitted region
    in canonical row-major order, pair_i/col_idx the absolute emission
    indices — or None when the strip emits nothing.  One parallel native
    pass (dt_gather_strip_tri, rows chunked over the shared pool)
    replaces the numpy repeat/arange index build plus per-row slice
    concatenation that was the measured main-thread bottleneck of the
    emission tail; falls back to exactly those numpy helpers without the
    native lib.
    """
    from distance_tpu_torch._native import get_lib

    lib = get_lib()
    G = strip.shape[0]
    hi = n - col0
    # only the column axis must be unit-stride; counter-plane and row
    # axes may be strided (cropped fetch views, out-of-core buffers)
    plain = strip.size and strip.strides[2] == 4
    if lib is None or not plain:
        if tri:
            local_rows, col_idx = _tri_indices(si, i0, n)
            if col_idx.size == 0:
                return None
            gathered = _gather_strip_triangle(strip, si, i0, n, col0)
            return [gathered[g] for g in range(G)], (
                local_rows + np.int32(i0)
            ), col_idx
        if hi <= 0 or si == 0:
            return None
        local_rows = np.repeat(np.arange(si, dtype=np.int32), hi)
        col_idx = np.tile(
            np.arange(col0, col0 + hi, dtype=np.int32), si
        )
        rows_c = [
            np.ascontiguousarray(strip[g, :si, :hi]).reshape(-1)
            for g in range(G)
        ]
        return rows_c, local_rows + np.int32(i0), col_idx
    import ctypes

    rows = np.arange(si, dtype=np.int64)
    if tri:
        lens = np.maximum(hi - np.maximum(i0 + rows + 1 - col0, 0), 0)
    else:
        lens = np.full(si, max(hi, 0), dtype=np.int64)
    starts = np.zeros(si + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    total = int(starts[-1])
    if total == 0:
        return None
    if pool is not None and lease is not None:
        outc = pool.take(G * total, np.int32, lease).reshape(G, total)
        pair_i = pool.take(total, np.int32, lease)
        col_idx = pool.take(total, np.int32, lease)
    else:
        outc = np.empty((G, total), dtype=np.int32)
        pair_i = np.empty(total, dtype=np.int32)
        col_idx = np.empty(total, dtype=np.int32)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    args = (
        strip.ctypes.data_as(p_i32), G, strip.strides[0] // 4,
        strip.strides[1] // 4, hi, i0, col0,
        starts.ctypes.data_as(p_i64), total,
    )
    outs = (
        outc.ctypes.data_as(p_i32), pair_i.ctypes.data_as(p_i32),
        col_idx.ctypes.data_as(p_i32),
    )
    from distance_tpu_torch.finalize import _get_pool

    tpool = _get_pool()
    n_chunks = min(8, max(1, total // (1 << 21)))
    # balanced row ranges: boundaries where the pair prefix crosses k/n
    bounds = np.searchsorted(
        starts, np.linspace(0, total, n_chunks + 1)
    ).astype(np.int64)
    bounds[0], bounds[-1] = 0, si
    futs = [
        tpool.submit(lib.dt_gather_strip_tri, *args,
                     int(bounds[k]), int(bounds[k + 1]), *outs,
                     int(tri))
        for k in range(n_chunks)
        if bounds[k] < bounds[k + 1]
    ]
    for f in futs:
        f.result()
    return [outc[g] for g in range(G)], pair_i, col_idx


def _gather_strip_triangle(strip: np.ndarray, si: int, i0: int, n: int,
                           col0: int) -> Dict[int, np.ndarray]:
    """Gather the emitted (i < j) region of a (G, si, cols) strip whose
    column axis starts at absolute column ``col0``.

    Row li covers absolute columns i0+li+1 .. n-1; each row's region is
    CONTIGUOUS in the strip, so this concatenates slices (memcpy speed)
    instead of fancy-indexing ~0.12 us/pair.
    """
    out = {}
    for k in range(strip.shape[0]):
        parts = [
            strip[k, li, i0 + li + 1 - col0 : n - col0] for li in range(si)
        ]
        out[k] = (
            np.concatenate(parts) if len(parts) > 1
            else parts[0].copy() if parts else np.empty(0, strip.dtype)
        )
    return out


# Prune when at least this fraction of columns is invariant.
PRUNE_MIN_FRACTION = 0.25


def _prune_invariant_columns(mats: Sequence[np.ndarray]):
    """Drop columns where every row (across all given matrices) holds the
    same code — the TPU-native analog of the reference's
    consensus-difference sparsification (measures.rs:28-53), generalized
    to every measure.

    An invariant column contributes nothing to any difference counter; if
    its common code is an exact base (bit 3) it contributes exactly +1
    per pair to ``same`` (and hence tn93's ``kk``), re-added as a scalar
    offset at finalization.  Exactness is unconditional.

    Returns (pruned_mats, same_offset, pruned_width) or None if pruning
    is not worthwhile.
    """
    first = mats[0][0:1]
    inv = None
    for m in mats:
        eq = (m == first).all(axis=0)
        inv = eq if inv is None else (inv & eq)
    frac = float(inv.mean()) if inv.size else 0.0
    if frac < PRUNE_MIN_FRACTION:
        return None
    keep = ~inv
    same_offset = int((inv & ((first[0] & 8) == 8)).sum())
    pruned = [np.ascontiguousarray(m[:, keep]) for m in mats]
    return pruned, same_offset, int(keep.sum())


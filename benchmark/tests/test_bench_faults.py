"""A run with the timed path broken underneath comes out not correct.

The harness runs as on the card but on the program's plain PyTorch
backend, at a tiny size where every line is compared, once for each
fault a cell can have: a job that returns without its work (the header
alone), half of the rows left out, and an answer altered where it is
produced.  No cell spans chips, so no exchange between chips can be left
out.  A sound run, and the control, are judged by the same comparison.
"""

import numpy as np
import pytest

import control
import run
from conftest import CELLS


def _nothing_done(mp):
    from distance_tpu_torch import engine

    def no_work(setup):
        setup.writer.header()
        setup.writer.close()

    mp.setattr(engine, "run", no_work)


def _half_the_rows(mp):
    from distance_tpu_torch import writer

    rows = writer.TsvWriter.rows

    def half(self, ids1, ids2, pair_i, pair_j, values, keys=None,
             keyspace=0):
        h = len(pair_i) // 2
        return rows(self, ids1, ids2, pair_i[:h], pair_j[:h], values,
                    None if keys is None else keys[:h], keyspace)

    mp.setattr(writer.TsvWriter, "rows", half)


def _answer_altered(mp):
    from distance_tpu_torch import emit, engine

    final = emit.finalize_block

    def altered(measure, *args, **kw):
        out = np.array(final(measure, *args, **kw))
        out.flat[0] += 1 if out.dtype.kind in "iu" else 1e-6
        return out

    mp.setattr(emit, "finalize_block", altered)
    mp.setattr(engine, "finalize_block", altered)


FAULTS = {"nothing_done": _nothing_done, "half_the_rows": _half_the_rows,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    r = run.run(tiny, cell, 2 ** 31 + 11, 0.3, False, backend="torch")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    r = run.run(tiny, cell, 17, 0.3, False, backend="torch")
    assert not r["correct"]
    assert r["checks"]["rows_wrong"]["value"] > 0
    assert r["failed"] == r["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    for seed in (5, 6, 7):
        c = control.control_reading(tiny, cell, seed)
        # every row but the header differs one precision step down
        assert c["rows_wrong"] >= 0.9 * (c["rows_compared"] - 1)

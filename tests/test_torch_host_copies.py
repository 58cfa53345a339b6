"""The port's copies of the JAX package's host code stay identical to it.

``distance_tpu_torch`` cannot import ``distance_tpu``: every submodule of
it loads jax through ``distance_tpu/__init__.py``.  So the port carries
copies of the JAX-free host modules and helpers; these tests pin them to
their originals, with the import prefix (and the path prefix of citations
of the Rust reference's sources) the only allowed difference, and check
that the port runs with jax unimportable.
"""

import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distance_tpu.engine as jax_engine  # noqa: E402
import distance_tpu_torch.emit as port_emit  # noqa: E402
import distance_tpu_torch.engine as port_engine  # noqa: E402
from tests.conftest import make_fasta, oracle_tsv, random_seqs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

COPIED_FILES = [
    "encoding.py",
    "measures.py",
    "_native/__init__.py",
    "_native/native.c",
    "utils/__init__.py",
    "utils/timing.py",
    "fastaio.py",
    "finalize.py",
    "writer.py",
    "progress.py",
    "ops/features.py",
]

EMIT_HELPERS = [
    "_emit_pairs", "_lin3_native", "_minmax_native", "_value_keys",
    "_tn93_value_keys", "_tri_indices", "_ScratchPool", "_gather_emit",
    "_gather_strip_triangle", "_prune_invariant_columns",
]

ENGINE_HELPERS = [
    "_input_fingerprint", "_resume_skip", "_progress_mark",
    "_pipeline_strips", "_AsyncEmitter", "_split_strips",
    "_strip_ram_budget", "_cap_tile_ram", "_pow2_at_least",
]


def ported(text: str) -> str:
    """The original's text as the port carries it: the import prefix, and
    citations of the Rust reference's sources without the absolute path
    they were written with."""
    text = re.sub(r"\bdistance_tpu\b", "distance_tpu_torch", text)
    return text.replace("/root/reference/", "reference/")


@pytest.mark.parametrize("rel", COPIED_FILES)
def test_copied_file_is_verbatim(rel):
    orig = (ROOT / "distance_tpu" / rel).read_text()
    copy = (ROOT / "distance_tpu_torch" / rel).read_text()
    assert copy == ported(orig)


@pytest.mark.parametrize("name", EMIT_HELPERS)
def test_emit_helper_is_verbatim(name):
    want = ported(inspect.getsource(getattr(jax_engine, name)))
    assert inspect.getsource(getattr(port_emit, name)) == want


@pytest.mark.parametrize("name", ["_KEYSPACE_CAP", "PRUNE_MIN_FRACTION"])
def test_emit_constant_is_verbatim(name):
    assert getattr(port_emit, name) == getattr(jax_engine, name)


@pytest.mark.parametrize("name", ENGINE_HELPERS)
def test_engine_helper_is_verbatim(name):
    want = ported(inspect.getsource(getattr(jax_engine, name)))
    assert inspect.getsource(getattr(port_engine, name)) == want


_NO_JAX_RUN = """
import sys
sys.modules["jax"] = None
import distance_tpu_torch.cli
import distance_tpu_torch.engine
assert "distance_tpu" not in sys.modules
sys.exit(distance_tpu_torch.cli.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("measure", ["raw", "tn93"])
def test_port_runs_without_jax(tmp_path, measure):
    """With jax unimportable, the port imports and writes the oracle's
    TSV — as it must on a GPU host that has no jax."""
    from distance_tpu.fastaio import load_fasta

    rng = np.random.default_rng(7)
    fasta = tmp_path / "a.fasta"
    fasta.write_bytes(make_fasta(random_seqs(rng, 12, 90, amb_frac=0.3)))
    out = tmp_path / "out.tsv"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, str(fasta), "-m", measure,
         "--backend", "torch", "-o", str(out)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    with open(fasta, "rb") as f:
        aln = load_fasta(f)
    if measure == "tn93":
        aln.count_bases()
    assert out.read_bytes() == oracle_tsv(measure, aln)


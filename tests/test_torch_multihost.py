"""The port's multi-process layer writes the JAX CLI's bytes.

Mirrors ``tests/test_multihost.py`` for ``distance_tpu_torch``: the
sharded stream with its ``.units`` merge, ``--merge``, ``--launch``,
``--num-hosts``/``--host-id`` and the ``--coordinator`` rendezvous
(torch.distributed over gloo).  Every port run is ``--backend torch``
(the plain version on the CPU), held against ``distance --backend
numpy`` on the same files.  Parents run in this process where the
subprocess is not the point; every wait has a timeout.
"""

import io
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distance_tpu import cli as jax_cli  # noqa: E402
from distance_tpu.measures import MEASURES  # noqa: E402
from distance_tpu_torch import cli as port_cli  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch.fastaio import DistanceError, load_fastas  # noqa: E402
from distance_tpu_torch.parallel import multihost  # noqa: E402
from distance_tpu_torch.parallel.multihost import (  # noqa: E402
    UnitIndex,
    merge_parts,
)
from distance_tpu_torch.writer import TsvWriter  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402
from tests.test_torch_rect_stream import _Boom  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 120
CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)


class _BoundedPopen(subprocess.Popen):
    """A process started here, directly or by ``--launch`` in this
    process, is killed after WAIT_S: a hung worker fails its test instead
    of hanging the run."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        timer = threading.Timer(WAIT_S, self.kill)
        timer.daemon = True
        timer.start()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the JAX CLI would otherwise keep a compilation cache under $HOME;
    # worker processes import the port from this checkout
    monkeypatch.setenv("DISTANCE_TPU_JIT_CACHE", "0")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    monkeypatch.setattr(multihost, "MERGE_TIMEOUT_S", float(WAIT_S))
    monkeypatch.setattr(subprocess, "Popen", _BoundedPopen)


@pytest.fixture(scope="module")
def fastas():
    rng = np.random.default_rng(23)
    f1 = make_fasta(random_seqs(rng, 13, 70, amb_frac=0.2))
    f2 = make_fasta(random_seqs(rng, 41, 70, amb_frac=0.2))
    return f1, f2


def write_inputs(tmp_path, fastas):
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    a.write_bytes(fastas[0])
    b.write_bytes(fastas[1])
    return str(a), str(b)


def jax_tsv(tmp_path, args):
    out = tmp_path / "jax.tsv"
    assert jax_cli.main([*args, "--backend", "numpy", "-o", str(out)]) == 0
    return out.read_bytes()


def port(args):
    return port_cli.main([*args, "--backend", "torch"])


def spawn(args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "distance_tpu_torch.cli", *args],
        stderr=subprocess.PIPE, env=env,
    )


def wait_ok(proc):
    try:
        _, err = proc.communicate(timeout=WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err.decode()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def small_groups(monkeypatch, measure, rows=4, n1=13):
    """Pin the host allowance every shard's auto group size follows, so
    that ``rows`` records make a group (in this process and in workers)."""
    g = len(port_engine.get_plan(measure).counters)
    ram = (port_engine.STREAM_PENDING + 1) * (g + 2) * n1 * 4 * rows
    monkeypatch.setenv("DISTANCE_TPU_STRIP_RAM", str(ram))


# -- the sharded stream and its merge ----------------------------------------

@pytest.mark.parametrize("nshards", [2, 3])
@pytest.mark.parametrize("measure", MEASURES)
def test_stream_shards_merge(measure, nshards, fastas, tmp_path, monkeypatch):
    # small device groups so several units exist per shard
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 4)
    a, b = write_inputs(tmp_path, fastas)
    args = [a, "-s", b, "-m", measure, "-b", "3"]
    parts, ordinals = [], []
    for k in range(nshards):
        p = str(tmp_path / f"part{k}")
        assert port([*args, "--shard", f"{k}/{nshards}", "-o", p]) == 0
        ix = UnitIndex(p)
        assert ix.load() and ix.group == 4
        assert all(g % nshards == k for g, _ in ix.units)
        ordinals += [g for g, _ in ix.units]
        parts.append(p)
    assert sorted(ordinals) == list(range(14))  # 41 records, -b 3: 14 groups
    merged = tmp_path / "merged.tsv"
    with open(merged, "wb") as out:
        merge_parts(out, parts)
    assert merged.read_bytes() == jax_tsv(tmp_path, args)
    # merge cleaned up parts + sidecars
    assert not os.path.exists(parts[0])
    assert not os.path.exists(parts[0] + ".units")


def test_stream_shard_without_output_path_skips_units(fastas, tmp_path,
                                                      monkeypatch):
    """Sharded stream into a non-file sink still works (no .units)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 4)
    f1, f2 = fastas
    out = io.BytesIO()
    setup = port_engine.Setup(
        loaded=load_fastas([io.BytesIO(f1)]), streamed=io.BytesIO(f2),
        writer=TsvWriter(out), measure="raw", n_threads=1, batchsize=2,
        backend="torch", shard=(0, 2),
    )
    port_engine.run(setup)
    assert out.getvalue().startswith(b"sequence1\t")
    assert out.getvalue().count(b"\n") == 1 + 13 * (4 + 4 + 4 + 4 + 4 + 1)
    assert not list(tmp_path.rglob("*.units"))


def test_shards_sized_under_different_cards_merge(fastas, tmp_path,
                                                  monkeypatch):
    """Shards on hosts with other RAM and cards with other memory cut the
    stream into the same groups: the unsharded auto size would differ
    (4 and 2 records here), the sharded one follows neither."""
    monkeypatch.setattr(port_engine, "STREAM_GROUP_CAP", 4)
    a, b = write_inputs(tmp_path, fastas)
    args = [a, "-s", b, "-m", "raw", "-b", "1"]
    real_ram = port_engine._strip_ram_budget
    hosts = [
        (None, None),  # this host, no card
        # a card of 7040 B, and a host whose RAM allows groups of 2: a
        # third of it for 4 groups in flight of (2 + 2) int32 x 13 x 2
        ((7040, 7040), 3 * 4 * (2 + 2) * 4 * 13 * 2),
    ]
    staged, parts = [], []
    for k, (card, ram) in enumerate(hosts):
        monkeypatch.setattr(port_engine, "_card_memory",
                            lambda device, card=card: card)
        monkeypatch.setattr(
            port_engine, "_strip_ram_budget",
            lambda deterministic=False, ram=ram: (
                real_ram(deterministic) if deterministic or ram is None
                else ram // 3))
        assert port_engine._stream_group_size(13, 70, "raw", CPU) == (
            4 if k == 0 else 2)
        assert port_engine._stream_group_size(13, 70, "raw", CPU,
                                              sharded=True) == 4
        real_staged = port_engine._dispatch_stream_staged
        monkeypatch.setattr(port_engine, "_dispatch_stream_staged",
                            lambda *a, **kw: staged.append(k) or real_staged(
                                *a, **kw))
        parts.append(str(tmp_path / f"p{k}"))
        assert port([*args, "--shard", f"{k}/2", "-o", parts[-1]]) == 0
        monkeypatch.setattr(port_engine, "_dispatch_stream_staged",
                            real_staged)
    # the fake card's budget (3520 B) holds the loaded side but not 4
    # groups of 4 in flight: that shard runs staged, the other in core
    assert set(staged) == {1}
    out = tmp_path / "m.tsv"
    assert port_cli.main(["--merge", *parts, "-o", str(out)]) == 0
    assert out.read_bytes() == jax_tsv(tmp_path, args)


@pytest.mark.parametrize("n1", [2000, 100_000, 2_000_000])
@pytest.mark.parametrize("measure", ["raw", "tn93"])
def test_sharded_group_size_follows_no_memory(monkeypatch, n1, measure):
    """At the sizes users run, a shard's auto group is the same on an
    80 GB card with 96 GiB of RAM as on a 16 GB card with 8 GiB, a valid
    K1 launch, and a staged group's host buffer within half the host
    budget (or the floor)."""
    sizes = set()
    for card, ram in (((84 << 30, 85 << 30), 96 << 30),
                      ((15 << 30, 16 << 30), 8 << 30)):
        monkeypatch.setattr(port_engine, "_card_memory",
                            lambda device, card=card: card)
        monkeypatch.setattr(port_engine._os, "sysconf", lambda name, ram=ram:
                            ram // 4096 if name == "SC_PHYS_PAGES" else 4096)
        sizes.add(port_engine._stream_layout(n1, 29904, measure, CUDA, 8192,
                                             sharded=True).group)
    group, = sizes
    g = len(port_engine.get_plan(measure).counters)
    assert 2 <= group <= min(port_engine.STREAM_GROUP_CAP,
                             port_engine.kernels.MAX_Y_ROWS)
    assert group % 2 == 0
    assert g * n1 * 4 * group <= port_engine.HOST_BUF_BUDGET // 2 or (
        group == port_engine.STAGED_ROWS_FLOOR)


def test_one_shard_in_core_and_one_staged(fastas, tmp_path, monkeypatch):
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 4)
    monkeypatch.setattr(port_engine, "TILE_I", 8)
    a, b = write_inputs(tmp_path, fastas)
    args = [a, "-s", b, "-m", "tn93", "-b", "2"]
    spans = []
    real_get = port_engine._StagedSide.get
    monkeypatch.setattr(port_engine._StagedSide, "get",
                        lambda side, q0, q1: spans.append((q0, q1)) or
                        real_get(side, q0, q1))
    parts = [str(tmp_path / "p0"), str(tmp_path / "p1")]
    assert port([*args, "--shard", "0/2", "-o", parts[0]]) == 0
    assert not spans
    # 13 loaded rows of 128 padded sites: 2 super-rows of 8 and 5
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET", 2500)
    assert port([*args, "--shard", "1/2", "-o", parts[1]]) == 0
    assert set(spans) == {(0, 8), (8, 13)}
    out = tmp_path / "m.tsv"
    assert port_cli.main(["--merge", *parts, "-o", str(out)]) == 0
    assert out.read_bytes() == jax_tsv(tmp_path, args)


def test_resumed_sharded_stream(fastas, tmp_path, monkeypatch):
    """A shard killed between a unit's sidecar entry and its checkpoint
    resumes: the output and the ``.units`` index are cut back together
    to the checkpoint, and the merge equals the unsharded file."""
    monkeypatch.setattr(port_engine, "STREAM_GROUP", 4)
    a, b = write_inputs(tmp_path, fastas)
    args = [a, "-s", b, "-m", "k80", "-b", "3"]
    parts = [str(tmp_path / "p0"), str(tmp_path / "p1")]
    assert port([*args, "--shard", "0/2", "-o", parts[0]]) == 0
    real = port_engine._progress_mark
    marks = []

    def bomb(setup, units):
        marks.append(units)
        if len(marks) == 3:  # the third unit is indexed, not checkpointed
            raise _Boom()
        real(setup, units)

    monkeypatch.setattr(port_engine, "_progress_mark", bomb)
    resume = [*args, "--shard", "1/2", "--resume", "-o", parts[1]]
    with pytest.raises(_Boom):
        setup = port_engine.set_up(port_cli.build_parser().parse_args(
            [*resume, "--backend", "torch"]))
        try:
            port_engine.run(setup)
        finally:
            setup.writer.close()
    ix = UnitIndex(parts[1])
    assert ix.load() and [g for g, _ in ix.units] == [1, 3, 5]
    progress = json.loads(Path(parts[1] + ".progress").read_text())
    assert progress["units_done"] == 2
    monkeypatch.setattr(port_engine, "_progress_mark", real)
    assert port(resume) == 0
    assert ix.load() and [g for g, _ in ix.units] == [1, 3, 5, 7, 9, 11, 13]
    out = tmp_path / "m.tsv"
    assert port_cli.main(["--merge", *parts, "-o", str(out)]) == 0
    assert out.read_bytes() == jax_tsv(tmp_path, args)


def test_merge_refuses_parts_of_different_group_sizes(fastas, tmp_path,
                                                      capsys, monkeypatch):
    a, b = write_inputs(tmp_path, fastas)
    parts = []
    for k, group in ((0, 4), (1, 6)):
        monkeypatch.setattr(port_engine, "STREAM_GROUP", group)
        parts.append(str(tmp_path / f"p{k}"))
        assert port([a, "-s", b, "--shard", f"{k}/2", "-o", parts[-1]]) == 0
    out = tmp_path / "m.tsv"
    capsys.readouterr()
    assert port_cli.main(["--merge", *parts, "-o", str(out)]) == 1
    assert "groups of different sizes" in capsys.readouterr().err
    assert not out.exists()
    with pytest.raises(DistanceError, match="p0: 4, .*p1: 6"):
        merge_parts(io.BytesIO(), parts)
    assert os.path.exists(parts[0])  # a refused merge removes nothing


# -- --launch -----------------------------------------------------------------

def test_launch_square(tmp_path, fastas):
    a, _b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    assert port([a, "-m", "jc69", "--launch", "3", "-o", str(o)]) == 0
    assert o.read_bytes() == jax_tsv(tmp_path, [a, "-m", "jc69"])
    # no leftover parts
    assert not list(tmp_path.glob("out.tsv.part*"))


def test_launch_rectangle(tmp_path, fastas):
    a, b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    assert port([a, b, "-m", "n_high", "--launch", "2", "-o", str(o)]) == 0
    assert o.read_bytes() == jax_tsv(tmp_path, [a, b, "-m", "n_high"])
    assert not list(tmp_path.glob("out.tsv.part*"))


def test_launch_stream(tmp_path, fastas, monkeypatch):
    small_groups(monkeypatch, "k80")
    a, b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    args = ["-i", a, "-s", b, "-m", "k80", "-b", "2"]
    assert port([*args, "--launch", "2", "-o", str(o)]) == 0
    assert o.read_bytes() == jax_tsv(tmp_path, args)
    assert not list(tmp_path.glob("out.tsv.part*"))


def test_launch_stdout(tmp_path, fastas, capsysbinary):
    a, _b = write_inputs(tmp_path, fastas)
    assert port([a, "-m", "n", "--launch", "2"]) == 0
    assert capsysbinary.readouterr().out == jax_tsv(tmp_path, [a, "-m", "n"])


def test_launch_rejects_stdin(capsys):
    assert port(["--launch", "2"]) == 1
    assert "stdin" in capsys.readouterr().err


def test_worker_argv_always_names_the_backend(tmp_path):
    parse = port_cli.build_parser().parse_args
    for extra, backend in (([], "cuda"), (["--backend", "torch"], "torch")):
        args = parse(["a.fasta", "-s", "b.fasta", "-b", "7", *extra])
        argv = multihost._worker_argv(args, 1, 3, "o.part1")
        assert argv[:3] == [sys.executable, "-m", "distance_tpu_torch.cli"]
        assert argv[3:] == ["a.fasta", "-s", "b.fasta", "-m", "raw",
                            "--shard", "1/3", "-o", "o.part1", "-b", "7",
                            "--backend", backend]


def test_launched_workers_share_the_card(tmp_path, fastas, monkeypatch):
    """``--launch N`` tells each worker, and only its workers, its index
    k/N: on one card each takes 1/N of the auto device budget; a nonzero
    DEVICE_BUDGET stays as set."""
    launched = []

    class Worker:
        def __init__(self, argv, env):
            launched.append((argv, env))
            Path(argv[argv.index("-o") + 1]).write_bytes(b"")

        def poll(self):
            return 0

    monkeypatch.setattr(multihost.subprocess, "Popen", Worker)
    a, _b = write_inputs(tmp_path, fastas)
    assert port([a, "--launch", "3", "-o", str(tmp_path / "o.tsv")]) == 0
    assert [env[multihost.CARD_SHARE_ENV] for _, env in launched] == [
        "0/3", "1/3", "2/3"]
    assert multihost.CARD_SHARE_ENV not in os.environ
    monkeypatch.setattr(port_engine, "_card_memory",
                        lambda device: (60_000, 90_000))
    assert port_engine._device_budget(CUDA) == 30_000
    monkeypatch.setenv(multihost.CARD_SHARE_ENV, "1/3")
    assert port_engine._device_budget(CUDA) == 10_000
    assert port_engine._device_budget(CUDA, of_total=True) == 15_000
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET", 12345)
    assert port_engine._device_budget(CUDA) == 12345


def test_launch_cuda_workers_fail_without_a_card(tmp_path, fastas, capsys):
    """No fallback: workers asked for the card fail without one, and the
    launch names the shards that failed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a, _b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    rc = port_cli.main([a, "--backend", "cuda", "--launch", "2",
                        "-o", str(o)])
    assert rc == 1
    assert "--launch worker shard(s) [" in capsys.readouterr().err
    assert not o.exists()
    assert not list(tmp_path.glob("out.tsv.part*"))


def test_worker_failure_reported(tmp_path, capsys):
    """A failing shard worker fails the launch (no silent partial file)."""
    a = tmp_path / "bad.fasta"
    a.write_bytes(b">x\nACGT\n>y\nACG!\n")
    assert port([str(a), "--launch", "2", "-o", str(tmp_path / "o.tsv")]) == 1
    assert "worker shard" in capsys.readouterr().err


def test_worker_failure_removes_partial_output(tmp_path):
    a = tmp_path / "bad.fasta"
    a.write_bytes(b">x\nACGT\n>y\nACG!\n")
    o = tmp_path / "o.tsv"
    assert port([str(a), "--launch", "2", "-o", str(o)]) == 1
    assert not o.exists()


def test_worker_failure_removes_parts_and_sidecars(tmp_path):
    """--launch failure must not leave partK/.units leftovers: a later
    run at the same -o would misread a fresh load-mode part through a
    stale stream-mode unit index."""
    a = tmp_path / "bad.fasta"
    a.write_bytes(b">x\nACGT\n>y\nACG!\n")
    o = tmp_path / "o.tsv"
    # plant a stale sidecar from a hypothetical earlier stream run
    (tmp_path / "o.tsv.part0.units").write_text('{"preamble": 99}')
    assert port([str(a), "--launch", "2", "-o", str(o)]) == 1
    assert not o.exists()
    assert not list(tmp_path.glob("o.tsv.part*"))


# -- multi-host ---------------------------------------------------------------

def hosts(args, o, extra_env=None):
    """Host 1 as a process, then host 0 in this process (it merges once
    host 1's marker lands); returns host 0's exit code."""
    flags = ["--backend", "torch", "--num-hosts", "2", "-o", str(o)]
    proc = spawn([*args, *flags, "--host-id", "1"], env=extra_env)
    try:
        return port_cli.main([*args, *flags, "--host-id", "0"])
    finally:
        wait_ok(proc)


def test_hosts_flags_merge(tmp_path, fastas):
    """Explicit --num-hosts/--host-id, shared-FS rendezvous: host 0
    merges once host 1's marker lands."""
    a, _b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    assert hosts([a, "-m", "raw"], o) == 0
    assert o.read_bytes() == jax_tsv(tmp_path, [a, "-m", "raw"])
    assert not list(tmp_path.glob("out.tsv.part*"))


def test_hosts_flags_stream(tmp_path, fastas, monkeypatch):
    small_groups(monkeypatch, "tn93")
    a, b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    args = ["-i", a, "-s", b, "-m", "tn93"]
    assert hosts(args, o) == 0
    assert o.read_bytes() == jax_tsv(tmp_path, args)
    assert not list(tmp_path.glob("out.tsv.part*"))


@pytest.mark.parametrize("indices", ["flags", "torchrun"])
def test_coordinator_rendezvous(tmp_path, fastas, indices):
    """torch.distributed (gloo) startup: the indices come from the flags
    or, as torchrun gives them, from WORLD_SIZE/RANK."""
    a, _b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    for k in range(2):
        args = [a, "-m", "n", "--backend", "torch", "--coordinator",
                coordinator, "-o", str(o)]
        env = dict(os.environ, DISTANCE_TPU_MERGE_TIMEOUT=str(WAIT_S))
        if indices == "flags":
            args += ["--num-hosts", "2", "--host-id", str(k)]
        else:
            env.update(WORLD_SIZE="2", RANK=str(k))
        procs.append(spawn(args, env=env))
    for p in procs:
        wait_ok(p)
    assert o.read_bytes() == jax_tsv(tmp_path, [a, "-m", "n"])
    assert not list(tmp_path.glob("out.tsv.part*"))


def test_rendezvous_without_peer_fails(tmp_path, fastas, monkeypatch):
    """A missing peer fails the rendezvous after its timeout; no hang."""
    import torch.distributed as dist

    monkeypatch.setattr(multihost, "RENDEZVOUS_TIMEOUT_S", 1.0)
    a, _b = write_inputs(tmp_path, fastas)
    args = port_cli.build_parser().parse_args(
        [a, "--coordinator", f"127.0.0.1:{free_port()}", "--num-hosts", "2",
         "--host-id", "1", "-o", str(tmp_path / "o.tsv")])
    with pytest.raises(DistanceError, match="rendezvous of 2 hosts"):
        multihost.resolve_multihost(args)
    assert not dist.is_initialized()


def test_merge_cli_load_mode(tmp_path, fastas):
    """Manual workflow: --shard runs + --merge reproduce the file."""
    a, _b = write_inputs(tmp_path, fastas)
    parts = []
    for k in range(2):
        p = tmp_path / f"p{k}.tsv"
        assert port([a, "-m", "k80", "--shard", f"{k}/2", "-o", str(p)]) == 0
        parts.append(str(p))
    o = tmp_path / "out.tsv"
    assert port_cli.main(["--merge", *parts, "-o", str(o)]) == 0
    assert o.read_bytes() == jax_tsv(tmp_path, [a, "-m", "k80"])
    # --merge without cleanup keeps the parts
    assert os.path.exists(parts[0])


def test_multihost_conflicts(tmp_path, fastas, capsys):
    a, _b = write_inputs(tmp_path, fastas)
    o = str(tmp_path / "o")
    assert port([a, "--num-hosts", "2", "--host-id", "0", "--shard", "0/2",
                 "-o", o]) == 1
    assert "--shard conflicts" in capsys.readouterr().err
    assert port([a, "--num-hosts", "2", "-o", o]) == 1
    assert "--num-hosts and --host-id" in capsys.readouterr().err


def test_unit_index_roundtrip(tmp_path):
    ix = UnitIndex(str(tmp_path / "p"))
    ix.preamble = 29
    ix.group = 8
    ix.append(0, 100)
    ix.append(2, 50)
    ix.save()
    ix2 = UnitIndex(str(tmp_path / "p"))
    assert ix2.load()
    assert ix2.preamble == 29 and ix2.units == [[0, 100], [2, 50]]
    assert ix2.group == 8
    ix2.truncate(1)
    assert ix2.units == [[0, 100]]
    ix2.clear()
    assert not os.path.exists(ix.sidecar)


def test_stale_done_marker_is_ignored(tmp_path, fastas):
    """A .done marker from an earlier run (different fingerprint) at the
    same -o path must not gate or corrupt the merge: host 0 waits for a
    CURRENT marker instead of merging a stale/mid-write part."""
    a, _b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    # stale markers in the OLD (no-fingerprint) and wrong-fp formats
    (tmp_path / "out.tsv.part0.done").write_text("ok")
    (tmp_path / "out.tsv.part1.done").write_text("deadbeef\nok")
    assert hosts([a, "-m", "raw"], o) == 0
    assert o.read_bytes() == jax_tsv(tmp_path, [a, "-m", "raw"])
    assert not list(tmp_path.glob("out.tsv.part*"))


def test_unexpected_worker_exception_writes_failure_marker(tmp_path, fastas):
    """ANY host failure (not just DistanceError/OSError) must publish
    the failure marker, or host 0 waits for it forever."""
    a, _b = write_inputs(tmp_path, fastas)
    args = port_cli.build_parser().parse_args(
        [a, "-m", "raw", "--num-hosts", "2", "--host-id", "1",
         "-o", str(tmp_path / "o.tsv")])
    ctx = multihost.resolve_multihost(args)
    assert ctx is not None and args.shard == "1/2"
    multihost.finish_multihost(ctx, ok=False, err="RuntimeError boom")
    marker = tmp_path / "o.tsv.part1.done"
    content = marker.read_text().split("\n")
    assert content[0] == ctx.fp
    assert content[1].startswith("err RuntimeError boom")


def test_host_failure_marker_from_cli(tmp_path, monkeypatch):
    """The CLI publishes the marker for an exception of any type."""
    a = tmp_path / "a.fasta"
    a.write_bytes(b">x\nACGT\n>y\nACGA\n")

    def boom(setup):
        raise KeyError("unexpected")

    monkeypatch.setattr(port_engine, "run", boom)
    o = tmp_path / "o.tsv"
    with pytest.raises(KeyError):
        port([str(a), "--num-hosts", "2", "--host-id", "1", "-o", str(o)])
    status = (tmp_path / "o.tsv.part1.done").read_text().split("\n")[1]
    assert status.startswith("err 'unexpected'")

"""The port's run-time knobs: the card a torchrun rank takes and shares,
and the budgets and sizes read from the JAX CLI's environment variables
when a run starts.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distance_tpu import cli as jax_cli  # noqa: E402
from distance_tpu_torch import cli as port_cli  # noqa: E402
from distance_tpu_torch import engine as port_engine  # noqa: E402
from distance_tpu_torch.fastaio import DistanceError  # noqa: E402
from distance_tpu_torch.parallel.multihost import CARD_SHARE_ENV  # noqa: E402
from tests.conftest import make_fasta, random_seqs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TORCHRUN_ENV = ("LOCAL_RANK", "LOCAL_WORLD_SIZE", CARD_SHARE_ENV)


def fake_cards(monkeypatch, count, free=40_000, total=80_000):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(port_engine, "_card_memory",
                        lambda device: (free, total))
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("local_rank, cards, card", [
    (None, 1, 0), (None, 4, 0), ("0", 4, 0), ("3", 4, 3), ("5", 4, 1),
    ("2", 1, 0)])
def test_device_of_maps_torchrun_local_rank_to_a_card(monkeypatch,
                                                      local_rank, cards, card):
    fake_cards(monkeypatch, cards)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert port_engine.device_of("cuda") == torch.device("cuda", card)
    assert port_engine.device_of("torch") == torch.device("cpu")


@pytest.mark.parametrize("local_rank, local_world, cards, launch, share", [
    (None, None, 1, None, 1),  # one process, one card
    ("0", "4", 1, None, 4),    # four ranks on one card
    ("1", "4", 2, None, 2),    # ranks 1 and 3 on card 1
    ("0", "3", 2, None, 2),    # ranks 0 and 2 on card 0
    ("1", "3", 2, None, 1),    # rank 1 alone on card 1
    ("2", "8", 4, None, 2),
    ("0", "2", 1, "2/3", 6),   # a --launch 3 under each of two ranks
    (None, None, 1, "1/2", 2),  # a --launch 2 worker
    (None, None, 2, "1/3", 1),  # worker 1 of 3 alone on card 1
    (None, None, 2, "2/3", 2),  # workers 0 and 2 on card 0
])
def test_card_sharers_divide_the_auto_budget(monkeypatch, local_rank,
                                             local_world, cards, launch,
                                             share):
    fake_cards(monkeypatch, cards)
    for name, value in zip(TORCHRUN_ENV, (local_rank, local_world, launch)):
        if value is not None:
            monkeypatch.setenv(name, value)
    card = port_engine.device_of("cuda")
    assert port_engine._card_share() == share
    assert port_engine._device_budget(card) == 40_000 // 2 // share
    assert port_engine._device_budget(card, of_total=True) == (
        80_000 // 2 // share)
    # a budget that is set is not shared
    monkeypatch.setattr(port_engine, "DEVICE_BUDGET", 12_345)
    assert port_engine._device_budget(card) == 12_345


@pytest.mark.parametrize("name", sorted(port_engine.KNOB_ENV))
def test_knob_is_read_from_the_environment_when_a_run_starts(monkeypatch,
                                                             name):
    var = port_engine.KNOB_ENV[name]
    default = getattr(port_engine, name)
    monkeypatch.setenv(var, "12345")
    assert getattr(port_engine, name) == default  # not when imported
    with port_engine._env_knobs():
        assert getattr(port_engine, name) == 12345
    assert getattr(port_engine, name) == default
    monkeypatch.delenv(var)
    with port_engine._env_knobs():
        assert getattr(port_engine, name) == default
    monkeypatch.setenv(var, "lots")
    with pytest.raises(DistanceError, match=var):
        with port_engine._env_knobs():
            pass
    assert getattr(port_engine, name) == default


def test_knob_defaults_are_the_jax_clis():
    assert {name: getattr(port_engine, name)
            for name in port_engine.KNOB_ENV} == {
        "DEVICE_BUDGET": 0, "HOST_BUF_BUDGET": 4 << 30, "STREAM_GROUP": 0,
        "STRIP_LOOKAHEAD": 6, "STREAM_PENDING": 3, "NARROW_STICKY_LIMIT": 2,
        "RETARGET_FAIL_LIMIT": 3, "FEATCACHE_BUDGET": 8 << 30}


@pytest.fixture
def inputs(tmp_path):
    rng = np.random.default_rng(61)
    a, b = tmp_path / "a.fasta", tmp_path / "b.fasta"
    a.write_bytes(make_fasta(random_seqs(rng, 30, 120, amb_frac=0.2)))
    b.write_bytes(make_fasta(
        (f"t{i}", s.upper())
        for i, (_, s) in enumerate(random_seqs(rng, 23, 120))))
    return str(a), str(b)


def numpy_tsv(tmp_path, args):
    out = tmp_path / "numpy.tsv"
    assert jax_cli.main([*args, "--backend", "numpy", "-o", str(out)]) == 0
    return out.read_bytes()


def port_proc(tmp_path, args, env_extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **env_extra)
    for name in ("DISTANCE_TPU_HBM_BUDGET", "DISTANCE_TPU_HOST_BUF_BUDGET",
                 "DISTANCE_TPU_STREAM_GROUP"):
        if name not in env_extra:
            env.pop(name, None)
    out = tmp_path / "port.tsv"
    proc = subprocess.run(
        [sys.executable, "-m", "distance_tpu_torch.cli", *args, "--backend",
         "torch", "-o", str(out)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return out.read_bytes(), proc.stderr


@pytest.mark.parametrize("mode", ["square", "rectangle", "stream"])
def test_tiny_hbm_budget_sends_a_cli_run_out_of_core(tmp_path, inputs, mode):
    """DISTANCE_TPU_HBM_BUDGET (and DISTANCE_TPU_HOST_BUF_BUDGET) set on a
    CLI process send a --backend torch run out of core, with the bytes of
    the in-core run."""
    a, b = inputs
    args = {"square": [a], "rectangle": [a, b],
            "stream": [a, "-s", b, "-b", "4"]}[mode]
    want = numpy_tsv(tmp_path, args + ["-m", "tn93"])
    got, err = port_proc(tmp_path, args + ["-m", "tn93"], {
        "DISTANCE_TPU_HBM_BUDGET": "3000",
        "DISTANCE_TPU_HOST_BUF_BUDGET": "4000"})
    assert got == want
    assert ("staged stream" if mode == "stream" else "out-of-core") in err
    got, err = port_proc(tmp_path, args + ["-m", "tn93"], {})
    assert got == want and "out-of-core" not in err


def test_launch_workers_inherit_the_budget(tmp_path, inputs):
    """A --launch 2 run's workers are processes of their own: the budget
    of the parent's environment sends both out of core."""
    a, _ = inputs
    want = numpy_tsv(tmp_path, [a, "-m", "raw"])
    got, err = port_proc(tmp_path, [a, "-m", "raw", "--launch", "2"],
                         {"DISTANCE_TPU_HBM_BUDGET": "3000"})
    assert got == want
    assert err.count("out-of-core sweep") == 2


def test_stream_group_from_the_environment_is_a_resume_unit(tmp_path,
                                                            inputs,
                                                            monkeypatch):
    """DISTANCE_TPU_STREAM_GROUP sets the stream's groups, which the
    resume sidecar records; a resume under another group size is
    refused, and under the same one finishes the file."""
    a, b = inputs
    out = tmp_path / "out.tsv"
    args = [a, "-s", b, "-b", "2", "-m", "raw", "--backend", "torch",
            "--resume", "-o", str(out)]
    monkeypatch.setenv("DISTANCE_TPU_STREAM_GROUP", "4")
    real = port_engine._progress_mark

    def bomb(setup, units):
        real(setup, units)
        if units >= 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(port_engine, "_progress_mark", bomb)
    with pytest.raises(KeyboardInterrupt):
        port_cli.main(args)
    monkeypatch.setattr(port_engine, "_progress_mark", real)
    sidecar = json.loads((tmp_path / "out.tsv.progress").read_text())
    assert sidecar["config"]["stream_group"] == 4
    assert sidecar["units_done"] == 2
    monkeypatch.setenv("DISTANCE_TPU_STREAM_GROUP", "6")
    assert port_cli.main(args) == 1  # Cannot resume: the group size differs
    monkeypatch.setenv("DISTANCE_TPU_STREAM_GROUP", "4")
    assert port_cli.main(args) == 0
    assert out.read_bytes() == numpy_tsv(tmp_path, [a, "-s", b, "-m", "raw"])

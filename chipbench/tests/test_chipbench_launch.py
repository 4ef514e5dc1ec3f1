"""The launcher of a cell on more than one chip (``chipbench/run.py``), at
world 2 on the CPU over gloo, driven through its own entry by
``launch_probe.py`` (a driver of its own, no cell of ``BENCHMARK.json``):
one result line, from rank 0; the ranks' records merged by the rules of
``record.merge``; a rank that raises, or one that outlives the run's
limit, ends every rank with a nonzero exit and no line, and so does the
launcher's own end. A cell on one chip runs in the process it was started
as, with no process group."""

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

from chipbench.tests.tiny import ROOT  # noqa: I001  (first: puts src/ on the path)
from chipbench import run
from chipbench.harness import manifest
from chipbench.tests import launch_probe

PROBE = ROOT / "chipbench/tests/launch_probe.py"


def probe(*args, limit=60.0, wait=120):
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, str(PROBE), "--limit", str(limit), *args],
                       capture_output=True, text=True, timeout=wait, cwd=ROOT,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    return p, time.perf_counter() - t0


def pids(stderr):
    return [int(x) for x in re.findall(r"probe rank \d pid (\d+)", stderr)]


def gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.parametrize("mode,split", [("ok", 0), ("ok", 1), ("fail1", 0)])
def test_one_line_from_rank_0_with_the_ranks_merged(mode, split):
    p, _ = probe("--mode", mode, "--split", str(split))
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    # rank 0's own output comes through before its line; rank 1's does not
    assert lines[:-1] == ["probe rank 0: a line on standard output"]
    assert "probe rank 1: a line on standard output" in p.stderr
    line = json.loads(lines[-1])
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["device"]["count"] == 2 and line["device"]["memory_peak_bytes"] == 2000
    assert m["window_s"] == 2.0                 # the longest rank's
    assert m["window_peak_bytes"] == 200        # a peak: the largest
    # every rank ended on rank 0's third step; work counters summed or rank 0's
    assert m["window_steps"] == (6 if split else 3)
    assert m["window_tokens"] == (30 if split else 10)
    assert line["attempted"] == (11 if split else 5)
    assert line["failed"] == 1
    if not split:                               # timed from the launcher's start
        assert m["setup_s"] > m["rank_up_s"]
    gap = line["checks"]["gap"]
    assert gap == {"value": 5.0 if mode == "fail1" else 0.2, "limit": 1.0}
    assert line["correct"] is (mode == "ok")
    assert "check gap" in p.stderr.splitlines()[-1]
    assert all(gone(x) for x in pids(p.stderr))


def test_a_rank_that_raises_ends_the_run_with_no_line():
    p, took = probe("--mode", "raise")
    assert p.returncode != 0 and p.stdout == ""
    assert "rank 1 fails in set-up" in p.stderr and took < 60
    assert len(pids(p.stderr)) == 2 and all(gone(x) for x in pids(p.stderr))


def test_a_rank_past_the_limit_is_ended():
    p, took = probe("--mode", "sleep", limit=10.0)
    assert p.returncode != 0 and p.stdout == ""
    assert took < 10.0 + 30
    assert len(pids(p.stderr)) == 2 and all(gone(x) for x in pids(p.stderr))


@pytest.mark.parametrize("sig", ["SIGTERM", "SIGKILL"])
def test_a_launcher_ended_from_outside_ends_its_ranks(tmp_path, sig):
    err = tmp_path / "stderr"
    with open(err, "w") as f:
        p = subprocess.Popen([sys.executable, str(PROBE), "--mode", "sleep", "--limit", "100"],
                             stdout=subprocess.DEVNULL, stderr=f, cwd=ROOT,
                             env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        t0 = time.perf_counter()
        while len(pids(err.read_text())) < 2 and time.perf_counter() - t0 < 60:
            time.sleep(0.2)
        ranks = pids(err.read_text())
        assert len(ranks) == 2
        p.send_signal(getattr(signal, sig))
        assert p.wait(timeout=30) != 0
        t0 = time.perf_counter()
        while not all(gone(x) for x in ranks) and time.perf_counter() - t0 < 20:
            time.sleep(0.2)
        assert all(gone(x) for x in ranks)
    finally:
        p.kill()
        p.wait()


def test_one_rank_opens_no_process_group(monkeypatch, capsys):
    def refused(*a, **k):
        raise AssertionError("a process group at world 1")

    monkeypatch.setattr(torch.distributed, "init_process_group", refused)
    # the suite's other files load JAX into this process; a run would not
    monkeypatch.setattr(run, "forbidden_modules", lambda names=None: [])
    cell = manifest.Cell(name="probe", config_name="probe", traffic_name="probe", chips=1,
                         config={}, traffic={"kind": "probe"}, limits={})
    args = argparse.Namespace(rank=None, world=None, addr=None, t0=None, timeout=None, seed=1,
                              seconds=0.0, trace=0)
    rc = run.run_rank(cell, launch_probe.Probe("ok"), args, torch.device("cpu"),
                      launch_probe.read_metrics, False)
    assert rc == 0 and (cell.ranks.rank, cell.ranks.world) == (0, 1)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["device"]["count"] == 1 and line["correct"]
    assert line["checks"]["gap"] == {"value": 0.1, "limit": 1.0}


@pytest.mark.parametrize("chips", [1, 2])
def test_main_runs_one_process_for_one_chip_and_launches_ranks_for_more(monkeypatch, chips):
    for k in ("TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):     # main sets them
        monkeypatch.setenv(k, os.environ.get(k, ""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: chips)
    cell_of = manifest.cell

    def with_chips(*a, **k):
        c = cell_of(*a, **k)
        c.chips = chips
        return c

    calls = []
    monkeypatch.setattr(manifest, "cell", with_chips)
    monkeypatch.setattr(run, "launch", lambda cmd, world: calls.append(("launch", cmd, world)) or 0)
    monkeypatch.setattr(run, "run_rank", lambda cell, driver, args, device, *_: calls.append(
        ("rank", args.rank, args.world, str(device), driver.__name__)) or 0)
    argv = ["--workload", "qwen3-1.7b.train", "--seed", "3000000001", "--seconds", "1"]
    assert run.main(argv) == 0
    if chips == 1:
        assert calls == [("rank", None, None, "cuda:0", "chipbench.harness.train_cell")]
    else:
        assert calls == [("launch", [sys.executable, str(ROOT / "chipbench/run.py")] + argv, 2)]

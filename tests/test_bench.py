"""bench.py orchestration tests (mocked subprocesses — no GPU needed).

These pin the sweep's reporting properties:

  * the headline JSON line is printed as soon as the FIRST batch lands
    (and re-printed last), so a kill mid-sweep still leaves a record;
  * the wall-clock budget skips batches it can no longer afford;
  * a failed batch (nonzero rc) is retried once, a timed-out one is not;
  * an all-failed sweep exits nonzero instead of recording 0.0 img/s;
  * every line names its device, and MFU divides by the device's own peak.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys

import pytest


@pytest.fixture
def bench(monkeypatch):
    spec = importlib.util.spec_from_file_location("bench_under_test", "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    return mod


H100 = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


class _R:
    def __init__(self, rc, out):
        self.returncode, self.stdout, self.stderr = rc, out, ""


def _child(value):
    """stdout of a successful `bench.py --batch B` child."""
    return (json.dumps({"device": H100}) + "\n"
            + json.dumps({"metric": "x", "value": value, "device": H100}) + "\n")


def _metric_lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(l) for l in out.splitlines() if l.strip()]


def test_headline_streams_first_and_prints_last(bench, capsys, monkeypatch):
    def fake_run(cmd, capture_output, text, timeout):
        B = int(cmd[cmd.index("--batch") + 1])
        return _R(0, _child({8: 20.7, 32: 20.8, 64: 20.6, 1: 17.0}[B]))

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    bench.main()
    lines = _metric_lines(capsys)
    # first printed line is already a valid headline (from batch 8)
    assert lines[0]["metric"] == "cascade_images_per_sec_per_chip"
    assert lines[0]["value"] == 20.7
    assert "mfu" in lines[0] and "achieved_tflops" in lines[0]
    # last line is the final headline with the best batch
    assert lines[-1]["value"] == 20.8
    assert "vs_baseline" not in lines[-1]
    # every line names the device the children ran on
    assert all(l["device"] == H100 for l in lines)
    tflops = bench.cascade_flops_per_image() * 20.8 / 1e12
    assert lines[-1]["mfu"] == round(tflops / 989.0, 3)


def test_transient_failure_retried_timeout_not(bench, capsys, monkeypatch):
    calls = []

    def fake_run(cmd, capture_output, text, timeout):
        B = int(cmd[cmd.index("--batch") + 1])
        calls.append(B)
        if B == 32 and calls.count(32) == 1:
            return _R(1, "transfer closed")  # transient: retried
        if B == 1:
            raise subprocess.TimeoutExpired(cmd, timeout)  # not retried
        return _R(0, _child({8: 20.7, 32: 20.8}[B]))

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    bench.main()
    # the transient rc-failure retries IMMEDIATELY (before any later sweep
    # batch can consume the budget — round-5 validation lesson), the
    # timeout is never retried
    assert calls == [8, 1, 32, 32]
    lines = _metric_lines(capsys)
    assert lines[-1]["value"] == 20.8  # retry recovered the best batch
    per_batch = next(l for l in lines if "per_batch" in l)["per_batch"]
    assert per_batch["32"] == 20.8
    assert str(per_batch["1"]).startswith("failed: exceeded")


def test_budget_exhaustion_skips_later_batches(bench, capsys, monkeypatch):
    monkeypatch.setattr(bench, "BUDGET_S", 1000.0)
    clock = iter([0.0, 0.0])  # t_start, then batch-8's remaining check

    def fake_run(cmd, capture_output, text, timeout):
        B = int(cmd[cmd.index("--batch") + 1])
        return _R(0, _child(20.0 + B / 100))

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    monkeypatch.setattr(bench.time, "monotonic", lambda: next(clock, 999.5))
    bench.main()
    lines = _metric_lines(capsys)
    per_batch = next(l for l in lines if "per_batch" in l)["per_batch"]
    assert isinstance(per_batch["8"], float)  # first batch ran
    assert per_batch["1"] == "skipped: budget exhausted"


def test_under_min_budget_skips_even_without_headline(bench, capsys, monkeypatch):
    """In the all-batches-fail regime, a later batch with less than
    MIN_BATCH_S of budget left is skipped, headline or not (an attempt
    could not finish its compile and would overshoot the budget)."""
    monkeypatch.setattr(bench, "BUDGET_S", 1000.0)
    calls = []
    # t_start=0; batch 8 checks remaining at t=0 (runs, fails); batches 1
    # and 32 check at t=900 (remaining 100 < MIN_BATCH_S -> skip)
    clock = iter([0.0, 0.0])

    def fake_run(cmd, capture_output, text, timeout):
        calls.append(int(cmd[cmd.index("--batch") + 1]))
        return _R(1, "boom")

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    monkeypatch.setattr(bench.time, "monotonic", lambda: next(clock, 900.0))
    with pytest.raises(SystemExit):
        bench.main()
    assert calls == [8]  # later batches never attempted
    lines = _metric_lines(capsys)
    per_batch = next(l for l in lines if "per_batch" in l)["per_batch"]
    assert str(per_batch["8"]).startswith("failed: rc=")
    assert per_batch["1"] == "skipped: budget exhausted"
    assert per_batch["32"] == "skipped: budget exhausted"


def test_b1_in_sweep_and_per_batch_streams(bench, capsys, monkeypatch):
    """b1 has a guaranteed sweep slot, and every per-batch outcome streams
    as its own line the moment it resolves (diagnostics survive a kill even
    when no batch succeeds)."""
    timeouts = []

    def fake_run(cmd, capture_output, text, timeout):
        B = int(cmd[cmd.index("--batch") + 1])
        timeouts.append((B, timeout))
        return _R(0, _child({8: 20.7, 1: 17.0, 32: 20.8}[B]))

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    bench.main()
    assert [b for b, _ in timeouts] == [8, 1, 32]
    # the first batch's timeout leaves HEADROOM_S of the budget for this
    # process to report before a driver kill
    assert timeouts[0][1] <= bench.BUDGET_S - bench.HEADROOM_S
    lines = _metric_lines(capsys)
    updates = [l["per_batch_update"] for l in lines if "per_batch_update" in l]
    assert [list(u) for u in updates] == [["8"], ["1"], ["32"]]
    per_batch = next(l for l in lines if "per_batch" in l)["per_batch"]
    assert per_batch["1"] == 17.0


def test_all_failed_exits_nonzero(bench, capsys, monkeypatch):
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k: _R(1, "boom"))
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code == 1
    lines = _metric_lines(capsys)
    assert any("error" in l for l in lines)


def test_peak_table_h100(bench):
    """The H100 SXM entry is NVIDIA's 989 TF/s dense bf16."""
    assert bench.peak_bf16_tflops("NVIDIA H100 80GB HBM3") == 989.0


def test_peak_table_unknown_kind_raises(bench):
    """A device missing from the table is an error, not a default."""
    with pytest.raises(KeyError, match="A100"):
        bench.peak_bf16_tflops("NVIDIA A100-SXM4-80GB")


def test_child_refuses_cpu(bench, capsys):
    """`bench.py --batch B` on a machine without a GPU exits non-zero and
    prints no metric (the CPU is never measured as a device)."""
    with pytest.raises(SystemExit) as e:
        bench.device_info()
    assert e.value.code != 0
    lines = _metric_lines(capsys)
    assert lines and all("metric" not in l for l in lines)
    assert lines[0]["device"]["platform"] == "cpu"

"""chip_smoke.py on the CPU: it must refuse to run without a GPU, and its
multi-device phase must hold on virtual CPU devices (the rehearsal of the
four-card run, at the tiny config)."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def test_chip_smoke_exits_nonzero_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository, the script fails and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_multi_check_on_virtual_devices():
    """dp4 and dp2 x tp2 training steps and tp4 eval match one device
    (float32 tiny cascade, so the bound is float32 summation order)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from camouflaged_vlm_tpu.factory import build_tiny_cascade

    model, cfg = build_tiny_cascade()
    devices = jax.devices()[:4]
    assert len(devices) == 4
    res = smoke.multi_check(model, cfg, devices, log=lambda m: None)
    assert set(res) == {"dp4", "dp2xtp2", "tp4_eval"}
    for name, (a, b) in res.items():
        assert np.isfinite(a) and np.isfinite(b), name
        assert a < 1e-5 and b < 1e-4, (name, a, b)

"""Test configuration: force CPU with 8 virtual devices so multi-device
sharding tests run anywhere.

Tests that need an NVIDIA GPU carry the `gpu` marker and take the
`gpu_device` fixture, which skips them when no GPU is present (decided at
run time, never at import). On a machine with a card:
`python -m pytest tests/ -m gpu -p no:cacheprovider` with
`CVLM_TEST_GPU=1` set, which keeps JAX on its default (GPU) platform.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("CVLM_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run with CVLM_TEST_GPU=1 on the card)")
    return gpus[0]


@pytest.fixture(scope="session")
def tiny_cascade_2class():
    """Shared tiny cascade (cfg, model, bank, params) for test_train and
    test_convert, which built IDENTICAL fixtures independently (~40 s of
    init each on this host). Session-scoped is safe: params are immutable
    jax arrays and no test donates them (cli/train's donation is on a
    TrainState built per test)."""
    from camouflaged_vlm_tpu.factory import init_cascade_params, make_bank_inputs
    from camouflaged_vlm_tpu.models import CascadeConfig, OVCOSCascade

    cfg = CascadeConfig.tiny()
    model = OVCOSCascade(cfg)
    bank = make_bank_inputs(cfg, ["cat", "owl"])
    params = init_cascade_params(model, seed=0)
    return cfg, model, bank, params

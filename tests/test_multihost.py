"""Multi-host training smoke + equivalence.

Two jax processes (2 CPU devices each, Gloo collectives) run the train CLI
with --distributed against the same synthetic dataset; the run must (a)
complete with rank-gated logging and ONE checkpoint, and (b) produce the
SAME final params as a single-process run over an identical 4-device mesh —
the multi-host feed (`parallel.sharding.make_global_batch_array`) carves the
same seed-deterministic global batch into per-process shards, replacing the
reference's DistributedSampler + NCCL DDP
(`/root/reference/train_ovcos_maskdecoder_edge.py:25-29,287-293`).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import jax

pytestmark = pytest.mark.slow  # ~6 min equality run (fast tier skips; `pytest -m slow`)


@pytest.fixture(scope="module")
def synthetic_dataset(tmp_path_factory):
    import yaml

    root = tmp_path_factory.mktemp("ovcamo_mh")
    rng = np.random.default_rng(11)
    classes = [
        {"name": "cat", "split": "train"},
        {"name": "owl", "split": "train"},
        {"name": "bat", "split": "test"},
        {"name": "slug", "split": "test"},
    ]
    samples = []
    for split in ("train", "test"):
        os.makedirs(root / split / "image")
        os.makedirs(root / split / "mask")
    for i, (name, split) in enumerate(
        [("cat", "train"), ("owl", "train")] * 4 + [("bat", "test"), ("slug", "test")]
    ):
        uid = f"img{i}"
        h, w = 60 + 5 * i, 70 + 3 * i
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / split / "image" / f"{uid}.jpg"
        )
        Image.fromarray(((rng.random((h, w)) > 0.6) * 255).astype(np.uint8)).save(
            root / split / "mask" / f"{uid}.png"
        )
        samples.append({"unique_id": uid, "base_class": name,
                        "image": f"{uid}.jpg", "mask": f"{uid}.png"})
    os.makedirs(root / "jsonfile")
    json.dump(classes, open(root / "jsonfile" / "class_info.json", "w"))
    json.dump(samples, open(root / "jsonfile" / "sample_info.json", "w"))
    info = {
        "OVCamo_CLASS_JSON_PATH": str(root / "jsonfile" / "class_info.json"),
        "OVCamo_SAMPLE_JSON_PATH": str(root / "jsonfile" / "sample_info.json"),
        "OVCamo_TR_IMAGE_DIR": str(root / "train" / "image"),
        "OVCamo_TR_MASK_DIR": str(root / "train" / "mask"),
        "OVCamo_TE_IMAGE_DIR": str(root / "test" / "image"),
        "OVCamo_TE_MASK_DIR": str(root / "test" / "mask"),
    }
    info_path = root / "dataset_info.yaml"
    yaml.safe_dump(info, open(info_path, "w"))
    return str(info_path)


_RUNNER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from camouflaged_vlm_tpu.cli.train import main
sys.argv = ["train"] + sys.argv[1:]
main()
"""


def _spawn(info_path, save_dir, devices_per_proc, log_path, extra):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices_per_proc}"
    env.pop("JAX_PLATFORMS", None)
    args = [
        sys.executable, "-c", _RUNNER,
        "--dataset-info", info_path, "--save-dir", str(save_dir),
        "--epochs", "1", "--batch-size", "8", "--epoch-val", "100",
        "--tiny", "--dtype", "float32", "--seed", "5",
    ] + extra
    # outputs go to FILES: a filled stdout PIPE would block one rank, which
    # then stalls the other at the next collective
    return subprocess.Popen(
        args, env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stdout=open(log_path, "w"), stderr=subprocess.STDOUT, text=True,
    )


def _wait_all(procs, timeout):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _ckpt_params(save_dir):
    # host-side restore: the multi-host run's checkpoint embeds the 2x2
    # saving topology, which a plain restore can't reconstruct in-process
    from camouflaged_vlm_tpu.io.checkpoint import restore_checkpoint_host

    state = restore_checkpoint_host(os.path.join(str(save_dir), "ckpt_last"))
    return state["trainable"], int(np.asarray(state["step"]))


def test_two_process_train_matches_single_process(synthetic_dataset, tmp_path):
    port = socket.socket()
    port.bind(("localhost", 0))
    port_no = port.getsockname()[1]
    port.close()

    mh_dir = tmp_path / "mh"
    logs = [tmp_path / f"rank{i}.log" for i in range(2)]
    procs = [
        _spawn(
            synthetic_dataset, mh_dir, 2, logs[i],
            ["--distributed", "--coordinator", f"localhost:{port_no}",
             "--num-processes", "2", "--process-id", str(i)],
        )
        for i in range(2)
    ]
    _wait_all(procs, timeout=1500)
    outs = [p.read_text() for p in logs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, "\n== rank0 ==\n%s\n== rank1 ==\n%s" % (
            outs[0][-2000:], outs[1][-2000:],
        )
    # rank gating: epoch lines from process 0 only
    assert "epoch 1/1" in outs[0]
    assert "epoch 1/1" not in outs[1]
    assert os.path.isdir(mh_dir / "ckpt_last")

    single_dir = tmp_path / "single"
    p = _spawn(synthetic_dataset, single_dir, 4, tmp_path / "single.log", [])
    _wait_all([p], timeout=1500)
    assert p.returncode == 0, (tmp_path / "single.log").read_text()[-3000:]

    p_mh, step_mh = _ckpt_params(mh_dir)
    p_s, step_s = _ckpt_params(single_dir)
    assert step_mh == step_s
    flat_mh = jax.tree_util.tree_leaves_with_path(p_mh)
    flat_s = {
        jax.tree_util.keystr(k): v
        for k, v in jax.tree_util.tree_leaves_with_path(p_s)
    }
    assert len(flat_mh) == len(flat_s)
    for k, v in flat_mh:
        np.testing.assert_allclose(
            np.asarray(v), np.asarray(flat_s[jax.tree_util.keystr(k)]),
            rtol=1e-5, atol=1e-5, err_msg=jax.tree_util.keystr(k),
        )

"""Kill/resume cycle for the train CLI.

A run killed after epoch 2 and resumed with --resume must produce EXACTLY the
state of an uninterrupted run: same final params (the optimizer step count
restores, so the step-indexed cosine schedule continues on the same curve)
and the same per-epoch data order (per-epoch derived rng seeds).

Reference counterpart: `train_ovcos_maskdecoder_edge.py:167-172`, whose
`resume` key restores only the epoch counter — never weights or optimizer.
"""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

import jax

pytestmark = pytest.mark.slow  # ~6 min equality run (fast tier skips; `pytest -m slow`)


@pytest.fixture(scope="module")
def synthetic_dataset(tmp_path_factory):
    import yaml

    root = tmp_path_factory.mktemp("ovcamo_resume")
    rng = np.random.default_rng(7)
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


def _run_train(monkeypatch, info_path, save_dir, extra):
    from camouflaged_vlm_tpu.cli import train as train_cli

    argv = [
        "train", "--dataset-info", info_path, "--save-dir", str(save_dir),
        "--epochs", "4", "--batch-size", "8", "--epoch-val", "100",
        "--tiny", "--dtype", "float32", "--seed", "3",
    ] + extra
    monkeypatch.setattr(sys, "argv", argv)
    train_cli.main()


def _load_ckpt_params(save_dir):
    from camouflaged_vlm_tpu.io.checkpoint import restore_checkpoint

    state = restore_checkpoint(os.path.join(str(save_dir), "ckpt_last"))
    return state["trainable"], int(np.asarray(state["step"]))


def test_kill_and_resume_matches_uninterrupted(monkeypatch, synthetic_dataset, tmp_path):
    straight = tmp_path / "straight"
    resumed = tmp_path / "resumed"

    _run_train(monkeypatch, synthetic_dataset, straight, [])
    _run_train(monkeypatch, synthetic_dataset, resumed, ["--stop-after-epoch", "2"])
    meta = json.load(open(resumed / "ckpt_meta.json"))
    assert meta["epoch"] == 2
    _run_train(monkeypatch, synthetic_dataset, resumed, ["--resume"])

    p_a, step_a = _load_ckpt_params(straight)
    p_b, step_b = _load_ckpt_params(resumed)
    assert step_a == step_b  # cosine schedule position continues exactly
    flat_a = jax.tree_util.tree_leaves_with_path(p_a)
    flat_b = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(p_b)}
    assert len(flat_a) == len(flat_b)
    for k, va in flat_a:
        vb = flat_b[jax.tree_util.keystr(k)]
        np.testing.assert_allclose(
            np.asarray(va), np.asarray(vb), rtol=1e-6, atol=1e-6,
            err_msg=jax.tree_util.keystr(k),
        )

"""End-to-end EVAL throughput on the GPU.

bench.py times only the device pipeline; the north-star number is
`cli/evaluate.py`'s images_per_sec over a realistic dataset — including host
decode/preprocess, the per-image COD + OVCOS metric sweeps and the original-
resolution resize. This script synthesises a >=200-image OVCamo-format test
split at realistic resolutions (the OVCamo distribution is roughly
500-1500 px) and runs the full eval CLI on it at the production config.

Usage: python scripts/eval_throughput.py [--images 200] [--batch 8]
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import os

import numpy as np
from PIL import Image
import yaml


def make_dataset(root: str, n_images: int) -> str:
    from camouflaged_vlm_tpu.data.ovcamo import TEST_CLASS_NAMES

    rng = np.random.default_rng(0)
    os.makedirs(f"{root}/test/image", exist_ok=True)
    os.makedirs(f"{root}/test/mask", exist_ok=True)
    os.makedirs(f"{root}/jsonfile", exist_ok=True)
    classes = [{"name": n, "split": "test"} for n in TEST_CLASS_NAMES]
    samples = []
    for i in range(n_images):
        name = TEST_CLASS_NAMES[i % len(TEST_CLASS_NAMES)]
        uid = f"synth{i}"
        h = int(rng.integers(500, 1400))
        w = int(rng.integers(500, 1400))
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        yy, xx = np.mgrid[:h, :w]
        cy, cx = rng.integers(h // 4, 3 * h // 4), rng.integers(w // 4, 3 * w // 4)
        r = min(h, w) // 5
        mask = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.uint8) * 255
        Image.fromarray(img).save(f"{root}/test/image/{uid}.jpg", quality=88)
        Image.fromarray(mask).save(f"{root}/test/mask/{uid}.png")
        samples.append({"unique_id": uid, "base_class": name,
                        "image": f"{uid}.jpg", "mask": f"{uid}.png"})
    json.dump(classes, open(f"{root}/jsonfile/class_info.json", "w"))
    json.dump(samples, open(f"{root}/jsonfile/sample_info.json", "w"))
    info = {
        "OVCamo_CLASS_JSON_PATH": f"{root}/jsonfile/class_info.json",
        "OVCamo_SAMPLE_JSON_PATH": f"{root}/jsonfile/sample_info.json",
        "OVCamo_TR_IMAGE_DIR": f"{root}/test/image",
        "OVCamo_TR_MASK_DIR": f"{root}/test/mask",
        "OVCamo_TE_IMAGE_DIR": f"{root}/test/image",
        "OVCamo_TE_MASK_DIR": f"{root}/test/mask",
    }
    path = f"{root}/dataset_info.yaml"
    yaml.safe_dump(info, open(path, "w"))
    return path


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--images", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--root", default="/tmp/ovcamo_eval_bench")
    p.add_argument("--out", default="/tmp/eval_bench_out")
    args = p.parse_args()

    import json as _json

    sample_json = f"{args.root}/jsonfile/sample_info.json"
    cached = (
        os.path.exists(f"{args.root}/dataset_info.yaml")
        and os.path.exists(sample_json)
        and len(_json.load(open(sample_json))) == args.images
    )
    if not cached:
        import shutil

        shutil.rmtree(args.root, ignore_errors=True)
        print(f"generating {args.images} synthetic images under {args.root}")
        info_path = make_dataset(args.root, args.images)
    else:
        info_path = f"{args.root}/dataset_info.yaml"

    import sys

    sys.argv = [
        "evaluate", "--dataset-info", info_path, "--batch-size", str(args.batch),
        "--output-dir", args.out,
    ]
    from camouflaged_vlm_tpu.cli.evaluate import main as eval_main

    eval_main()
    results = json.load(open(f"{args.out}/results.json"))
    print(json.dumps({
        "eval_images_per_sec": results["images_per_sec"],
        "images": results["images"],
        "batch": args.batch,
    }))


if __name__ == "__main__":
    main()

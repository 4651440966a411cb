"""Single-image cascade demo.

Equivalent of `/root/reference/demo.py`: preprocess one image, run the fused
cascade (stage-1 mask + stage-2 open-vocab class), save a green-overlay image
named `[predicted_class]<input name>`.

Usage:
  python -m camouflaged_vlm_tpu.cli.demo --image demo_img/scorpionfish.jpg \
      --cascade-ckpt model_epoch_best.pth --clip-ckpt ViT-L-14-336px.pt \
      --out-dir ./demo_out
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

import jax
import jax.numpy as jnp

from ..data.ovcamo import TEST_CLASS_NAMES
from ..data.transforms import (
    clip_image_transform,
    clip_ones_alpha,
    sam_image_transform,
)
from ..utils.logging import log
from .common import assemble_cascade


def overlay_mask(image: np.ndarray, mask01: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Green overlay where mask > 0.5 (uint8 HWC in, uint8 HWC out)."""
    out = image.astype(np.float32).copy()
    sel = mask01 > 0.5
    green = np.array([0.0, 255.0, 0.0], np.float32)
    out[sel] = (1 - alpha) * out[sel] + alpha * green
    return out.astype(np.uint8)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True)
    p.add_argument("--out-dir", default="./demo_out")
    p.add_argument("--cascade-ckpt", default=None)
    p.add_argument("--sam-ckpt", default=None)
    p.add_argument("--clip-ckpt", default=None)
    p.add_argument("--maple-ckpt", default=None)
    p.add_argument("--text-bank", default=None)
    p.add_argument("--classnames", default=None, help="comma-separated; default OVCamo test split")
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke test)")
    p.add_argument("--dtype", default="bfloat16")
    args = p.parse_args()
    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    if not os.path.exists(args.image):
        p.error(f"--image {args.image!r} does not exist")  # before model assembly

    classnames = (
        args.classnames.split(",") if args.classnames else TEST_CLASS_NAMES
    )
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    model, cfg, params, bank = assemble_cascade(
        classnames,
        cascade_ckpt=args.cascade_ckpt,
        sam_ckpt=args.sam_ckpt,
        clip_ckpt=args.clip_ckpt,
        maple_ckpt=args.maple_ckpt,
        text_bank_path=args.text_bank,
        dtype=dtype,
        tiny=args.tiny,
    )
    from ..factory import attach_rel_cache

    params = attach_rel_cache(params, cfg)

    img = Image.open(args.image).convert("RGB")
    orig = np.asarray(img)
    inp = sam_image_transform(img, cfg.inp_size)[None]
    cimg = clip_image_transform(img, cfg.clip_size)[None]
    cmask = clip_ones_alpha(cfg.clip_size)[None]

    @jax.jit
    def run(params, inp, cimg, cmask):
        return model.infer_cascade(
            params, inp, cimg, cmask,
            bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"],
        )

    probs, pred, score = run(
        params, jnp.asarray(inp), jnp.asarray(cimg), jnp.asarray(cmask)
    )
    probs = np.asarray(probs)[0, :, :, 0]
    pred_cls = classnames[int(pred[0])]
    log(f"predicted class: {pred_cls}")

    # resize mask back to the original resolution: float-first with
    # cv2.INTER_LINEAR semantics, then quantise — the reference demo's
    # order (`demo.py:127` resize -> `demo.py:48` *255 truncate)
    from ..utils.image import bilinear_resize_f32

    mask01 = (
        (bilinear_resize_f32(probs, orig.shape[0], orig.shape[1]) * 255)
        .astype(np.uint8)
        .astype(np.float32)
        / 255.0
    )

    os.makedirs(args.out_dir, exist_ok=True)
    out = overlay_mask(orig, mask01)
    name = os.path.basename(args.image)
    out_path = os.path.join(args.out_dir, f"[{pred_cls}]{name}")
    Image.fromarray(out).save(out_path)
    mask_path = os.path.join(
        args.out_dir, f"mask_{os.path.splitext(name)[0]}.png"
    )
    Image.fromarray((mask01 * 255).astype(np.uint8)).save(mask_path)
    log(f"wrote {out_path} and {mask_path}")


if __name__ == "__main__":
    main()

"""Host input pipeline: decode + preprocess in a thread pool, prefetch batches.

Replaces the reference's torch DataLoader(num_workers=8) with a
thread-pooled PIL pipeline feeding static-shaped NHWC numpy batches; callers
device_put them (the jitted program overlaps the next host batch with device
compute thanks to async dispatch).
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from . import native_pipeline as npp
from .ovcamo import OVCamoIndex, OVCamoSample
from .transforms import (
    clip_alpha_transform,
    clip_image_resized_u8,
    clip_image_transform,
    clip_ones_alpha,
    mask_to_target,
    maybe_rot90_to_match,
    sam_image_resized_u8,
    sam_image_transform,
)


@dataclasses.dataclass
class EvalSample:
    inp: np.ndarray          # (1024, 1024, 3) fp32 normalised, or uint8 raw
    gt: np.ndarray           # (1024, 1024, 1)
    clip_image: np.ndarray   # (336, 336, 3) fp32 normalised, or uint8 raw
    clip_mask: Optional[np.ndarray]  # (336, 336, 1); None in raw_uint8 mode
    label_id: int
    label_name: str
    image_path: str
    mask_path: str
    orig_size: tuple         # (H, W) of the original mask


def native_preproc_enabled() -> bool:
    """Native (libcvtpre) fast path: on when the library is built, overridable
    with CVLM_NATIVE_PREPROC=0/1.  Outputs are bit-identical either way
    (tests/test_native_preproc.py), so this is purely a host-CPU choice."""
    env = os.environ.get("CVLM_NATIVE_PREPROC")
    if env is not None and env.lower() in ("0", "false", "off"):
        return False
    return npp.available()


def _load_eval_sample(
    sample: OVCamoSample,
    inp_size: int,
    clip_size: int,
    raw_uint8: bool = False,
    use_native: bool = False,
) -> EvalSample:
    from PIL import Image

    if use_native:
        pair = npp.decode_pair(sample.image_path, sample.mask_path)
        if pair is not None:
            img_a, mask_a = pair
            if raw_uint8:
                inp = npp.sam_image_resized_u8(img_a, inp_size)
                cimg = npp.clip_image_resized_u8(img_a, clip_size)
                cmask = None
            else:
                inp = npp.sam_image_transform(img_a, inp_size)
                cimg = npp.clip_image_transform(img_a, clip_size)
                cmask = clip_ones_alpha(clip_size)
            return EvalSample(
                inp=inp,
                gt=npp.mask_to_target(mask_a, inp_size),
                clip_image=cimg,
                clip_mask=cmask,
                label_id=sample.class_id,
                label_name=sample.class_label,
                image_path=sample.image_path,
                mask_path=sample.mask_path,
                orig_size=tuple(mask_a.shape[:2]),
            )
        # unsupported container (16-bit PNG, CMYK JPEG, ...) -> PIL fallback
    img = Image.open(sample.image_path).convert("RGB")
    mask = Image.open(sample.mask_path).convert("L")
    img = maybe_rot90_to_match(img, mask)
    if raw_uint8:
        # resize-only host work; /255 + normalisation happen in-graph
        # (quarters host->device traffic — see transforms.sam_image_resized_u8)
        inp = sam_image_resized_u8(img, inp_size)
        cimg = clip_image_resized_u8(img, clip_size)
        cmask = None  # constant alpha is built device-side
    else:
        inp = sam_image_transform(img, inp_size)
        cimg = clip_image_transform(img, clip_size)
        cmask = clip_ones_alpha(clip_size)
    return EvalSample(
        inp=inp,
        gt=mask_to_target(mask, inp_size),
        clip_image=cimg,
        clip_mask=cmask,
        label_id=sample.class_id,
        label_name=sample.class_label,
        image_path=sample.image_path,
        mask_path=sample.mask_path,
        orig_size=(mask.size[1], mask.size[0]),
    )


def iter_eval_batches(
    index: OVCamoIndex,
    batch_size: int = 1,
    inp_size: int = 1024,
    clip_size: int = 336,
    num_workers: int = 8,
    prefetch: int = 2,
    raw_uint8: bool = False,
) -> Iterator[List[EvalSample]]:
    """Yield lists of EvalSamples (last batch may be short).

    Submission is BOUNDED: at most `num_workers + prefetch * batch_size`
    samples are in flight at once. Decoded 1024px fp32 samples are ~17 MB
    each, so submitting the whole index upfront (the naive version) lets a
    slow consumer — e.g. an eval loop bound by a slow host<->device link —
    accumulate the entire decoded dataset in host RAM (3k images ≈ 50 GB).
    """
    use_native = native_preproc_enabled()

    def load(s):
        return _load_eval_sample(s, inp_size, clip_size, raw_uint8, use_native)

    batch: List[EvalSample] = []
    for item in _map_bounded(
        load, index.samples, num_workers, num_workers + prefetch * batch_size
    ):
        batch.append(item)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def _map_bounded(
    load: Callable, items: Sequence, num_workers: int, window: int
) -> Iterator:
    """`pool.map(load, items)` in submission order with at most `window`
    results in flight — back-pressure so a slow consumer never accumulates
    the whole decoded dataset in host RAM. `num_workers=0` runs
    synchronously (debugging decode errors without threads, matching the
    OVCOSMetricer contract)."""
    if num_workers <= 0:
        for item in items:
            yield load(item)
        return
    window = max(window, 1)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: deque = deque()
        next_i = 0
        while next_i < len(items) or pending:
            while next_i < len(items) and len(pending) < window:
                pending.append(pool.submit(load, items[next_i]))
                next_i += 1
            yield pending.popleft().result()


def iter_train_batches(
    index: OVCamoIndex,
    batch_size: int,
    rng: np.random.Generator,
    inp_size: int = 1024,
    clip_size: int = 336,
    num_workers: int = 8,
) -> Iterator[dict]:
    """One epoch of shuffled, h-flip-augmented train batches (stacked arrays).

    Matches the reference TrainDataset semantics
    (`/root/reference/datasets/wrappers.py:120-161`): the CLIP crop is taken
    BEFORE the flip (the reference flips after computing clip tensors), flip
    probability 0.5, nearest-resized GT.
    """
    from PIL import Image

    order = rng.permutation(len(index.samples))
    # Flip decisions are drawn on the main thread (numpy Generator is not
    # thread-safe; concurrent rng.random() from pool workers would make the
    # augmentation non-deterministic despite seeding).
    flips = rng.random(len(order)) < 0.5

    use_native = native_preproc_enabled()

    def load(args):
        i, flip = args
        s = index.samples[int(i)]
        if use_native:
            pair = npp.decode_pair(s.image_path, s.mask_path)
            if pair is not None:
                img_a, mask_a = pair
                clip_img = npp.clip_image_transform(img_a, clip_size)
                if flip:
                    img_a = npp.fliplr(img_a)
                    mask_a = npp.fliplr(mask_a)
                return (
                    npp.sam_image_transform(img_a, inp_size),
                    npp.mask_to_target(mask_a, inp_size),
                    clip_img,
                    s.class_id,
                )
        img = Image.open(s.image_path).convert("RGB")
        mask = Image.open(s.mask_path).convert("L")
        img = maybe_rot90_to_match(img, mask)
        clip_img = clip_image_transform(img, clip_size)
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
        return (
            sam_image_transform(img, inp_size),
            mask_to_target(mask, inp_size),
            clip_img,
            s.class_id,
        )

    n_full = (len(order) // batch_size) * batch_size
    items = list(zip(order[:n_full], flips[:n_full]))
    # Per-sample bounded prefetch pipelines decode across batch boundaries:
    # while the trainer runs batch k on-device, workers are already decoding
    # batch k+1 (the old per-batch pool.map stalled at every batch edge).
    stream = _map_bounded(load, items, num_workers, num_workers + 2 * batch_size)
    chunk = []
    for item in stream:
        chunk.append(item)
        if len(chunk) < batch_size:
            continue
        inp, gt, cimg, label = zip(*chunk)
        chunk = []
        yield {
            "inp": np.stack(inp),
            "gt": np.stack(gt),
            "clip_image": np.stack(cimg),
            "clip_mask": np.broadcast_to(
                clip_ones_alpha(clip_size), (batch_size, clip_size, clip_size, 1)
            ).copy(),
            "label_id": np.asarray(label, np.int32),
        }


def iter_maple_train_batches(
    index: OVCamoIndex,
    batch_size: int,
    rng: np.random.Generator,
    clip_size: int = 336,
    num_workers: int = 8,
) -> Iterator[dict]:
    """One epoch of (clip_image, GT-mask alpha, label) batches for MaPLe
    prompt training — the capability behind the reference's dassl
    `MaPLeAlphaCLIP(TrainerX)` (`/root/reference/cocotrainers/mapleAlphaCLIP.py:300-386`,
    `parse_batch_train` :395-404), which conditions Alpha-CLIP on the
    ground-truth mask and trains the prompt learner with cross-entropy.
    """
    from PIL import Image

    order = rng.permutation(len(index.samples))
    flips = rng.random(len(order)) < 0.5  # main-thread draw (see above)

    use_native = native_preproc_enabled()

    def load(args):
        i, flip = args
        s = index.samples[int(i)]
        if use_native:
            pair = npp.decode_pair(s.image_path, s.mask_path)
            if pair is not None:
                img_a, mask_a = pair
                if flip:
                    img_a = npp.fliplr(img_a)
                    mask_a = npp.fliplr(mask_a)
                return (
                    npp.clip_image_transform(img_a, clip_size),
                    npp.clip_alpha_transform(mask_a, clip_size),
                    s.class_id,
                )
        img = Image.open(s.image_path).convert("RGB")
        mask = Image.open(s.mask_path).convert("L")
        img = maybe_rot90_to_match(img, mask)
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
        return (
            clip_image_transform(img, clip_size),
            clip_alpha_transform(mask, clip_size),
            s.class_id,
        )

    n_full = (len(order) // batch_size) * batch_size
    items = list(zip(order[:n_full], flips[:n_full]))
    stream = _map_bounded(load, items, num_workers, num_workers + 2 * batch_size)
    chunk = []
    for item in stream:
        chunk.append(item)
        if len(chunk) < batch_size:
            continue
        cimg, alpha, label = zip(*chunk)
        chunk = []
        yield {
            "clip_image": np.stack(cimg),
            "clip_alpha": np.stack(alpha),
            "label_id": np.asarray(label, np.int32),
        }

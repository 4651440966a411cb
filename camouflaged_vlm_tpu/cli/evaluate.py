"""Full OVCamo test-split evaluation.

Equivalent of `/root/reference/test_ovcos_maskdecoder_edge.py`
(`eval_psnr_ovcamo_both`, :68-148): per image

  * stage-1 mask -> class-agnostic COD metrics (sm/em/wfm/mae) at 1024px;
  * stage-2 classification (alpha = resized sigmoid mask) -> top1/top5/macroF1;
  * class-aware OVCOS metrics at the ORIGINAL mask resolution
    (sm/wfm/mae/adp|max|avg fm/em/iou, zeroed on class mismatch);
  * optional overlay dumps.

Design: both stages run as ONE jitted program per batch (the mask never
leaves device memory between stages); host threads overlap decode/preprocess and the
per-image metric computation with device compute.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
from PIL import Image

import jax
import jax.numpy as jnp
import yaml

from ..data.ovcamo import OVCamoIndex
from ..data.loader import iter_eval_batches
from ..metrics import CODMetrics, OVCOSMetricer, ClassificationEvaluator
from ..utils.logging import log, set_log_file
from .common import assemble_cascade


def evaluate(
    model, cfg, params, bank, index: OVCamoIndex,
    batch_size: int = 4, save_img_path: str | None = None, num_workers: int = 8,
    mesh=None, oracle_cls: bool = False, mask_dtype: str = "float16",
):
    """Run the full OVCOS eval. With `mesh` (a jax Mesh with 'data' and
    'model' axes), each batch is sharded over `data` and params by the
    Megatron partition rules (replication when the model axis is 1) — the
    compiled program runs data- and/or tensor-parallel across chips (the
    reference is single-GPU batch-1, `test_ovcos_maskdecoder_edge.py:175-178`).
    batch_size must be divisible by the data-axis size.

    `oracle_cls=True` scores the class-aware metrics with the GROUND-TRUTH
    class (the reference debug entry's `pre_cls = gt_cls` bypass,
    `debug_ovcos_maskdecoder_edge.py:111`) — isolates segmentation quality
    from classification."""
    from ..factory import attach_rel_cache

    classnames = index.classes
    # Params are fixed for the whole eval: hoist the param-derived rel-pos
    # tables out of the per-batch program (fresh per call, so in-training
    # validation always caches the CURRENT rel_pos params).
    if "relcache" not in params:
        params = attach_rel_cache(params, cfg)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel import shard_params

        assert batch_size % mesh.shape["data"] == 0, (batch_size, dict(mesh.shape))
        batch_sharding = NamedSharding(mesh, P("data"))
        # Megatron partition rules over the param paths: with a model axis
        # of size 1 every spec degenerates to replication (the pure-dp
        # case); with n_model > 1 the qkv/MLP-up kernels shard their output
        # features and proj/MLP-down their input features, and GSPMD
        # inserts one all-reduce per block — tensor-parallel eval for
        # latency-bound multi-device deployments.
        params = shard_params(mesh, params)
        put = lambda a: jax.device_put(a, batch_sharding)
    else:
        put = jnp.asarray

    # text features are class-split constants at eval time: encode once
    text_features = jax.jit(model.encode_class_text_features)(params, bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"])

    from ..data.transforms import (
        IMAGENET_MEAN, IMAGENET_STD, ONES_ALPHA_VALUE,
        OPENAI_CLIP_MEAN, OPENAI_CLIP_STD,
    )

    @jax.jit
    def run(params, inp_u8, cimg_u8):
        # /255 + normalisation in-graph (uint8 transfer is 4x lighter; same
        # fp32 op order as the host transforms -> identical values)
        inp = (inp_u8.astype(jnp.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        cimg = (
            cimg_u8.astype(jnp.float32) / 255.0 - OPENAI_CLIP_MEAN
        ) / OPENAI_CLIP_STD
        cmask = jnp.full(
            (inp_u8.shape[0], cfg.clip_size, cfg.clip_size, 1), ONES_ALPHA_VALUE
        )
        probs, pred, score = model.infer_cascade_with_text(
            params, inp, cimg, cmask, text_features
        )
        # fp16 (default) halves the device->host mask traffic; resolution ~3e-4 is finer than the 256-bin
        # threshold metrics' own quantisation. mask_dtype="float32" keeps
        # full precision for programmatic consumers of raw probabilities
        # (and for cross-framework A/B runs, tests/test_eval_ab.py).
        out_dt = jnp.float16 if mask_dtype == "float16" else jnp.float32
        return probs.astype(out_dt), pred, score

    cod = CODMetrics()
    metricer = OVCOSMetricer(class_names=classnames, num_workers=num_workers)
    clf = ClassificationEvaluator(class_names=classnames)
    if save_img_path:
        os.makedirs(save_img_path, exist_ok=True)

    # Compile before the clock starts: the first call compiles, which would
    # dominate images_per_sec on small runs (a deployment compiles once per
    # process).
    warm = run(
        params,
        put(np.zeros((batch_size, cfg.inp_size, cfg.inp_size, 3), np.uint8)),
        put(np.zeros((batch_size, cfg.clip_size, cfg.clip_size, 3), np.uint8)),
    )
    jax.tree.map(lambda a: np.asarray(a), warm)

    n_done = 0
    t0 = time.time()

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    # ALL per-image host work runs in this pool: cod.step's 256-threshold
    # sweep + wFm distance transform alone cost tens of ms/image — run
    # synchronously on the drain thread they cap eval at well under the
    # device rate. CODMetrics/OVCOSMetricer
    # accumulate via list.append (atomic; results are order-independent).
    metric_pool = ThreadPoolExecutor(max_workers=num_workers)
    metric_futures = deque()
    # Backpressure: each queued future pins a full-res f32 probability map
    # (~4 MB at 1024px). One chip (~20 img/s) never outruns 8 metric workers,
    # but a wide data-parallel eval can — bound the queue instead of letting
    # it absorb the dataset.
    max_metric_queue = 4 * num_workers

    from ..utils.image import bilinear_resize_f32

    def image_work(prob, s, pre_cls):
        cod.step(prob, s.gt[:, :, 0])
        gt = np.asarray(Image.open(s.mask_path).convert("L"))
        h, w = gt.shape
        # Reference order and arithmetic (`test_ovcos_maskdecoder_edge.py:
        # 124-131`): resize the FLOAT probability with cv2.INTER_LINEAR
        # semantics, THEN truncate-quantise to uint8. (Quantise-then-PIL-
        # resize differs: PIL antialiases on downscale and rounds.)
        pred_full = (bilinear_resize_f32(prob, h, w) * 255).astype(np.uint8)
        metricer.step(
            pre=pred_full, gt=gt, pre_cls=pre_cls, gt_cls=s.label_name,
            gt_path=s.mask_path,
        )
        if save_img_path:
            Image.fromarray(pred_full).save(
                os.path.join(
                    save_img_path, f"[{pre_cls}]{os.path.basename(s.mask_path)}"
                )
            )

    def consume(outs, batch):
        """Drain one finished batch; fan per-image work out to the pool."""
        nonlocal n_done
        B = len(batch)
        probs = np.asarray(outs[0], np.float32)[:B, :, :, 0]
        pred = np.asarray(outs[1])[:B]
        score = np.asarray(outs[2])[:B]
        clf.process(score, np.asarray([s.label_id for s in batch]))
        for i, s in enumerate(batch):
            pre_cls = s.label_name if oracle_cls else classnames[int(pred[i])]
            metric_futures.append(
                metric_pool.submit(image_work, probs[i], s, pre_cls)
            )
            if len(metric_futures) > max_metric_queue:
                metric_futures.popleft().result()
        n_done += B

    # Pipelined loop: up to 3 dispatched batches are alive before the oldest
    # is drained, so the host fetch + metric fan-out of batch k overlaps
    # device compute of k+1..k+3 (the reference's eval loop is fully
    # serialised, SURVEY §3.2). Transfers stay inline.
    pending = deque()
    for batch in iter_eval_batches(
        index, batch_size, cfg.inp_size, cfg.clip_size, num_workers,
        raw_uint8=True,
    ):
        B = len(batch)
        pad = batch_size - B  # keep shapes static for the compiled program
        inp = np.stack([s.inp for s in batch] + [batch[-1].inp] * pad)
        cimg = np.stack([s.clip_image for s in batch] + [batch[-1].clip_image] * pad)
        outs = run(params, put(inp), put(cimg))
        pending.append((outs, batch))
        if len(pending) > 2:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())
    while metric_futures:
        metric_futures.popleft().result()  # surface worker exceptions
    metric_pool.shutdown(wait=False)

    ovcos = metricer.show()
    ori_sm, ori_em, ori_wfm, ori_mae = cod.results()
    elapsed = time.time() - t0  # includes metric drain: honest end-to-end rate
    cls_res = clf.evaluate()
    results = {
        **ovcos,
        "ori_sm": round(ori_sm, 4),
        "ori_em": round(ori_em, 4),
        "ori_wfm": round(ori_wfm, 4),
        "ori_mae": round(ori_mae, 4),
        **{k: round(v, 2) for k, v in cls_res.items()},
        "images": n_done,
        "images_per_sec": round(n_done / elapsed, 3),
    }
    return results


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset-info", required=True, help="splitted_ovcamo.yaml with path keys")
    p.add_argument("--config", default=None, help="model config yaml (configs/*.yaml)")
    p.add_argument("--split", default="test")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--output-dir", default="./eval_results")
    p.add_argument("--save-images", action="store_true")
    p.add_argument("--cascade-ckpt", default=None)
    p.add_argument("--sam-ckpt", default=None)
    p.add_argument("--clip-ckpt", default=None)
    p.add_argument("--maple-ckpt", default=None)
    p.add_argument("--text-bank", default=None)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument(
        "--mask-dtype", default="float16", choices=["float16", "float32"],
        help="device->host probability transfer dtype (float16 halves bytes; "
        "float32 for full-precision programmatic consumers)",
    )
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke runs)")
    p.add_argument(
        "--data-parallel", action="store_true",
        help="shard each batch over all devices (jax Mesh 'data' axis)",
    )
    p.add_argument(
        "--n-model", type=int, default=1,
        help="tensor-parallel axis size (Megatron rules; devices are "
        "arranged as data x model, so --data-parallel with --n-model 2 on "
        "8 chips gives a 4x2 mesh)",
    )
    p.add_argument(
        "--oracle-cls", action="store_true",
        help="score class-aware metrics with the GT class (the reference "
        "debug entry's pre_cls=gt_cls bypass) — segmentation-only quality",
    )
    args = p.parse_args()
    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    os.makedirs(args.output_dir, exist_ok=True)
    set_log_file(os.path.join(args.output_dir, "log.txt"))

    with open(args.dataset_info) as f:
        dataset_info = yaml.safe_load(f)
    index = OVCamoIndex.from_dataset_info(dataset_info, args.split)
    log(f"[eval] {len(index)} samples, {len(index.classes)} classes ({args.split})")

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    config = None
    if args.config:
        from ..config import cascade_config_from_yaml

        config, _ = cascade_config_from_yaml(args.config)
    model, cfg, params, bank = assemble_cascade(
        index.classes,
        config=config,
        cascade_ckpt=args.cascade_ckpt,
        sam_ckpt=args.sam_ckpt,
        clip_ckpt=args.clip_ckpt,
        maple_ckpt=args.maple_ckpt,
        text_bank_path=args.text_bank,
        dtype=dtype,
        tiny=args.tiny,
    )
    save_path = os.path.join(args.output_dir, "result_image") if args.save_images else None
    mesh = None
    if args.data_parallel or args.n_model > 1:
        from ..parallel import make_mesh

        mesh = make_mesh(n_model=args.n_model)
        log(
            f"[eval] mesh data={mesh.shape['data']} x model={mesh.shape['model']}"
        )
    results = evaluate(
        model, cfg, params, bank, index,
        batch_size=args.batch_size, save_img_path=save_path, mesh=mesh,
        oracle_cls=args.oracle_cls, mask_dtype=args.mask_dtype,
    )
    log(json.dumps(results, indent=2))
    with open(os.path.join(args.output_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()

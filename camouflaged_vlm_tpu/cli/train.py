"""OVCOS cascade training.

Equivalent of `/root/reference/train_ovcos_maskdecoder_edge.py` (main :240,
train :183): AdamW(2e-4) + per-epoch cosine to 1e-7 over 20 epochs, training
only {EVP prompt generator, mask decoder, CLIP->prompt projections,
no_mask_embed}, validating every `epoch_val` epochs, saving
last/best (min val MAE).

Deltas from the reference (documented deviations):
  * data parallelism via a jax Mesh with per-step compiled gradient psum —
    the reference's DDP never synchronised gradients (SURVEY.md §5.8);
  * checkpoints are orbax TrainStates (params + optimizer + step), so resume
    actually works (the reference's resume restores only the epoch counter);
  * global batch = batch_size (sharded over devices), not per-rank.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import yaml

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..data.ovcamo import OVCamoIndex
from ..data.loader import iter_train_batches
from ..parallel import make_global_batch_array, make_mesh, shard_params
from ..train import (
    SCANNED_BATCH_KEYS,
    make_optimizer,
    make_train_step,
    create_train_state,
)
from ..io.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.logging import log, set_log_file, set_quiet
from ..utils.timer import Timer
from .common import assemble_cascade
from .evaluate import evaluate


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset-info", required=True)
    p.add_argument("--config", default=None, help="model config yaml (configs/*.yaml)")
    p.add_argument("--save-dir", default="./save/ovcos")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=4, help="global batch")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument(
        "--weight-decay", type=float, default=0.01,
        help="AdamW decoupled weight decay — 0.01 is torch AdamW's default, "
        "which the reference inherits (it builds AdamW(params, lr=...) with "
        "no explicit decay, utils.py:111-117)",
    )
    p.add_argument("--eta-min", type=float, default=1e-7)
    p.add_argument("--epoch-val", type=int, default=2)
    p.add_argument("--loss", default="iou", choices=["bce", "bbce", "iou"])
    p.add_argument("--sam-ckpt", default=None)
    p.add_argument("--clip-ckpt", default=None)
    p.add_argument("--maple-ckpt", default=None)
    p.add_argument("--text-bank", default=None, help="TEST-split text bank "
                   "(conditions BOTH validation and — reference quirk, see "
                   "the static_bank comment — the training forward)")
    p.add_argument("--train-text-bank", default=None, help="train-split bank; "
                   "only shapes the initial params (the reference loads it "
                   "but its cascade paths never consume it)")
    p.add_argument("--n-model", type=int, default=1, help="tensor-parallel axis size")
    p.add_argument(
        "--distributed", action="store_true",
        help="multi-host training: jax.distributed.initialize() before "
        "building the mesh (the NCCL-free counterpart of the reference's "
        "init_process_group, `train_ovcos_maskdecoder_edge.py:25-29`). Pass "
        "--coordinator/--num-processes/--process-id unless the cluster "
        "environment lets jax.distributed autodetect them.",
    )
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument(
        "--remat", action="store_true",
        help="rematerialise encoder blocks in the backward pass: ~1/3 more "
        "forward FLOPs for far less activation memory. The per-device batch "
        "at which ViT-H needs it is not measured on the H100.",
    )
    p.add_argument(
        "--accum-steps", type=int, default=1,
        help="gradient accumulation: split each global batch into this many "
        "sequentially-scanned microbatches inside the jitted step (one "
        "optimizer update per global batch). Activation memory drops to one "
        "microbatch's; its speed against --remat is not measured on the "
        "H100.",
    )
    p.add_argument(
        "--fused-optimizer", choices=["auto", "on", "off"], default="auto",
        help="ravel the trainable subtree into ONE vector around the AdamW "
        "update (optax.flatten): collapses hundreds of small per-leaf "
        "update chains into one fused elementwise program (bitwise-equal "
        "updates — AdamW is elementwise). 'auto' enables it when the mesh "
        "has no model axis (tensor-parallel params keep per-leaf sharding, "
        "which a raveled vector cannot represent). NOTE: changes the orbax "
        "opt_state structure — resuming a pre-round-5 checkpoint needs "
        "'off'.",
    )
    p.add_argument(
        "--stop-after-epoch", type=int, default=None,
        help="fault injection: exit cleanly after this epoch's checkpoint "
        "(simulates a kill for resume testing)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="resume from <save-dir>/ckpt_last: restores params + optimizer "
        "state + step (so the cosine schedule continues exactly), the epoch "
        "counter and best val MAE. The reference's resume key restored only "
        "the epoch counter (`train_ovcos_maskdecoder_edge.py:167-172`).",
    )
    args = p.parse_args()
    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    if args.distributed:
        kw = {}
        if args.coordinator is not None:
            kw = dict(
                coordinator_address=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id,
            )
        jax.distributed.initialize(**kw)
        # Establish the cross-process collective context NOW, while every
        # rank is seconds from initialize: the first collective's transport
        # setup has a short (~30 s) key-value-exchange timeout, and the first
        # natural collective sits behind a minutes-long model compile whose
        # duration can skew between ranks (observed under CPU load: Gloo
        # "GetKeyValue timed out", killing the laggard's peer).
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("camouflaged_vlm_tpu:init")
    # Rank gating: epoch lines / tensorboard / meta json are process-0-only;
    # checkpoint saves stay ALL-process (orbax coordinates the write
    # internally — gating them would deadlock a multi-host save).
    is_main = jax.process_index() == 0
    set_quiet(not is_main)

    os.makedirs(args.save_dir, exist_ok=True)
    if is_main:
        set_log_file(os.path.join(args.save_dir, "log.txt"))
    writer = None
    if is_main:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(os.path.join(args.save_dir, "tensorboard"))
        except Exception:
            writer = None

    with open(args.dataset_info) as f:
        dataset_info = yaml.safe_load(f)
    train_index = OVCamoIndex.from_dataset_info(dataset_info, "train")
    val_index = OVCamoIndex.from_dataset_info(dataset_info, "test")
    log(f"[train] {len(train_index)} samples / {len(train_index.classes)} classes")

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    # Training conditions the CLIP pass on the TRAIN class split
    # (`/root/reference/train_ovcos_maskdecoder_edge.py:266`).
    config = None
    if args.config:
        from ..config import cascade_config_from_yaml

        config, train_hp = cascade_config_from_yaml(args.config)
        for key in ("epochs", "batch_size", "lr", "eta_min", "epoch_val", "loss"):
            if key in train_hp:
                setattr(args, key.replace("-", "_"), train_hp[key])
    model, cfg, params, bank, make_bank = assemble_cascade(
        train_index.classes,
        config=config,
        sam_ckpt=args.sam_ckpt,
        clip_ckpt=args.clip_ckpt,
        maple_ckpt=args.maple_ckpt,
        text_bank_path=args.train_text_bank or args.text_bank,
        dtype=dtype,
        tiny=args.tiny,
        seed=args.seed,
        return_bank_builder=True,
    )
    val_bank = make_bank(val_index.classes, bank_path=args.text_bank)

    if args.remat and not cfg.encoder.remat:
        import dataclasses as _dc

        cfg = _dc.replace(cfg, encoder=_dc.replace(cfg.encoder, remat=True))
        model = type(model)(cfg)

    mesh = make_mesh(n_model=args.n_model)
    n_data = mesh.shape["data"]
    if args.accum_steps < 1:
        p.error(f"--accum-steps must be >= 1 (got {args.accum_steps})")
    accum = args.accum_steps
    assert args.batch_size % accum == 0, (args.batch_size, accum)
    micro_bs = args.batch_size // accum
    assert micro_bs % n_data == 0, (micro_bs, n_data)
    params = shard_params(mesh, params)

    steps_per_epoch = max(1, len(train_index) // args.batch_size)
    tx = make_optimizer(
        params,
        base_lr=args.lr,
        weight_decay=args.weight_decay,
        total_epochs=args.epochs,
        steps_per_epoch=steps_per_epoch,
        eta_min=args.eta_min,
    )
    if args.fused_optimizer == "on" or (
        args.fused_optimizer == "auto" and args.n_model == 1
    ):
        import optax

        tx = optax.flatten(tx)
    state = create_train_state(params, tx)

    start_epoch, best_mae = 1, float("inf")
    ckpt_last = os.path.join(args.save_dir, "ckpt_last")
    meta_path = os.path.join(args.save_dir, "ckpt_meta.json")
    if args.resume:
        if not os.path.isdir(ckpt_last):
            raise FileNotFoundError(f"--resume: no checkpoint at {ckpt_last}")
        state = restore_checkpoint(ckpt_last, state)
        # orbax restores scalars (step, optimizer counts) as committed
        # single-device arrays while the params carry their mesh sharding —
        # re-replicate anything that came back without a NamedSharding.
        repl = NamedSharding(mesh, P())
        state = jax.tree.map(
            lambda a: a
            if isinstance(getattr(a, "sharding", None), NamedSharding)
            else jax.device_put(jnp.asarray(a), repl),
            state,
        )
        # The epoch is derived from the restored optimizer step (the
        # checkpoint is the single source of truth — a kill between the
        # checkpoint write and the meta write can NOT desync them); the meta
        # json only carries best_mae, where staleness is benign.
        start_epoch = int(np.asarray(state.step)) // steps_per_epoch + 1
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            best_mae = float(meta.get("best_mae", float("inf")))
        log(
            f"[resume] restored step {int(state.step)} from {ckpt_last}; "
            f"continuing at epoch {start_epoch} (best mae {best_mae})"
        )

    # Donate the state: without it every step holds TWO copies of
    # params+optimizer (ViT-H + AdamW moments is multi-GB).
    train_step = jax.jit(
        make_train_step(model, tx, loss_mode=args.loss, accum_steps=accum),
        donate_argnums=(0,),
    )

    if accum > 1:
        # (A, B/A, H, W, C): the data axis shards the per-microbatch batch
        # dim; the reshape happens host-side so no resharding collective.
        batch_shard = NamedSharding(mesh, P(None, "data", None, None, None))
    else:
        batch_shard = NamedSharding(mesh, P("data", None, None, None))
    from ..parallel import make_replicated_array

    # Reference-faithful quirk (found by the gradient A/B,
    # tests/test_grad_ab.py): the reference's TRAINING forward conditions
    # the decoder on the TEST-split class-text features — its
    # `clip_model(image, alpha, self.training)` passes `self.training` into
    # CustomCLIP.forward's `label` slot (signature `(image, mask,
    # label=None, train=False)`, `models/sam_maskdecoder_edge.py:269` vs
    # `cocotrainers/mapleAlphaCLIP.py:264`), so `train=False` — the
    # test-branch prompts over `val_loader`'s 61 classnames
    # (`train_ovcos_maskdecoder_edge.py:265-266`) — runs at every training
    # step. The shipped cascade checkpoint learned under exactly this
    # conditioning, so we replicate it: the TRAIN batch carries the
    # test-split text features (the train-split bank still drives
    # `train_maple`, where the dassl trainer passes train=True correctly).
    #
    # The text tower + prompt learner are FROZEN during cascade training,
    # so the per-class text features are run constants: encode them ONCE
    # here instead of re-running the 61-prompt text transformer inside
    # every step (the reference re-runs it per step; hoisting is exact —
    # gradient equality pinned in tests/test_train.py).
    repl_bank = {
        k: make_replicated_array(mesh, np.asarray(v)) for k, v in val_bank.items()
    }
    with mesh:
        train_text_features = jax.jit(model.encode_class_text_features)(
            params, repl_bank["prefix"], repl_bank["suffix"],
            repl_bank["eot_indices"], repl_bank["bank_features"],
        )
    static_bank = {"text_features": train_text_features}

    timer = Timer()
    with mesh:
        for epoch in range(start_epoch, args.epochs + 1):
            timer.s()
            # Per-epoch derived seed so a resumed run reproduces the exact
            # shuffle/flip stream of the epochs it skips.
            rng = np.random.default_rng([args.seed, epoch])
            losses = []
            for batch in iter_train_batches(
                train_index, args.batch_size, rng, cfg.inp_size, cfg.clip_size
            ):
                device_batch = {**static_bank}
                for k in SCANNED_BATCH_KEYS:
                    x = batch[k]
                    if accum > 1:
                        x = x.reshape((accum, micro_bs) + x.shape[1:])
                    device_batch[k] = make_global_batch_array(
                        batch_shard, x, batch_axis=1 if accum > 1 else 0
                    )
                state, metrics = train_step(state, device_batch)
                losses.append(metrics)
            losses = {
                k: float(np.mean([float(m[k]) for m in losses]))
                for k in (losses[0] if losses else {})
            }
            log(
                f"epoch {epoch}/{args.epochs} "
                + " ".join(f"{k}={v:.4f}" for k, v in losses.items())
                + f" ({timer.t():.1f}s)"
            )
            if writer:
                for k, v in losses.items():
                    writer.add_scalar(k, v, epoch)

            save_checkpoint(ckpt_last, state)
            if is_main:
                with open(meta_path, "w") as f:
                    json.dump({"epoch": epoch, "best_mae": best_mae}, f)
            if args.stop_after_epoch == epoch:
                log(f"[stop-after-epoch] exiting after epoch {epoch}")
                return

            if epoch % args.epoch_val == 0:
                if jax.process_count() > 1:
                    # Multi-host: the eval loop's host-side metric
                    # accumulation only sees local shards, so validation runs
                    # on process 0 over a host-local copy of the (replicated)
                    # params; the mae is broadcast so every process joins the
                    # best-checkpoint save (orbax saves are all-process).
                    from jax.experimental import multihost_utils

                    replicated = all(
                        a.is_fully_replicated for a in jax.tree.leaves(state.params)
                    )
                    mae_val = np.inf
                    results = {}
                    if is_main and replicated:
                        local_params = jax.tree.map(
                            lambda a: np.asarray(a.addressable_data(0)),
                            state.params,
                        )
                        results = evaluate(
                            model, cfg, local_params, val_bank, val_index,
                            batch_size=max(1, args.batch_size // 2),
                        )
                        mae_val = results.get("mae", np.inf)
                    elif is_main:
                        log("[val] skipped: params not replicated across hosts")
                    mae_val = float(
                        multihost_utils.broadcast_one_to_all(np.float32(mae_val))
                    )
                    results = {**results, "mae": mae_val}
                else:
                    # In-training validation rides the same data-parallel
                    # mesh as training: at 3k+ val
                    # images every 2 epochs, serial validation is the
                    # epoch-time long pole on a multi-chip mesh. Batch size
                    # rounds up to a multiple of the data-axis size.
                    val_bs = max(1, args.batch_size // 2)
                    val_bs = -(-val_bs // n_data) * n_data
                    results = evaluate(
                        model, cfg, state.params, val_bank, val_index,
                        batch_size=val_bs,
                        mesh=mesh if n_data > 1 else None,
                    )
                log(f"[val epoch {epoch}] {json.dumps(results)}")
                if writer:
                    for k in ("sm", "wfm", "mae", "avgiou"):
                        if k in results:
                            writer.add_scalar(f"val/{k}", results[k], epoch)
                if results.get("mae", 1.0) < best_mae:
                    best_mae = results["mae"]
                    save_checkpoint(os.path.join(args.save_dir, "ckpt_best"), state)
                    if is_main:
                        with open(meta_path, "w") as f:
                            json.dump({"epoch": epoch, "best_mae": best_mae}, f)
                    log(f"[val epoch {epoch}] new best mae {best_mae}")

    log("training done")


if __name__ == "__main__":
    main()

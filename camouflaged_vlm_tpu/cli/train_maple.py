"""MaPLe prompt-learner training CLI.

Equivalent of the reference's dassl trainer
`MaPLeAlphaCLIP(TrainerX)` (`/root/reference/cocotrainers/mapleAlphaCLIP.py:300-440`)
— the tool that produced the shipped `model-best.pth.tar` the cascade loads.
Freezes everything except the multi-modal prompt learner and trains it with
cross-entropy on OVCamo train-split (clip_image, GT-mask alpha, label)
batches; the best-accuracy prompt state is saved as an orbax checkpoint that
`assemble_cascade` consumes via the native TrainState restore, plus an `.npz`
of the raw prompt-learner tensors.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import yaml

import jax
import jax.numpy as jnp

from ..data.ovcamo import OVCamoIndex
from ..data.loader import iter_maple_train_batches
from ..train import (
    MAPLE_TRAINABLE_SUBTREES,
    create_train_state,
    make_maple_optimizer,
    make_maple_train_step,
)
from ..train.maple import maple_loss
from ..io.checkpoint import save_checkpoint
from ..utils.logging import log, set_log_file
from ..utils.timer import Timer
from .common import assemble_cascade


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset-info", required=True)
    p.add_argument("--save-dir", default="./save/maple")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.0035)
    p.add_argument("--warmup-epochs", type=int, default=1)
    p.add_argument("--clip-ckpt", default=None, help="Alpha-CLIP weights (.pth)")
    p.add_argument("--maple-ckpt", default=None, help="resume/init prompt learner")
    p.add_argument("--train-text-bank", default=None)
    p.add_argument("--dtype", default="float32",
                   help="prompt training is small; fp32 by default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args()
    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    os.makedirs(args.save_dir, exist_ok=True)
    set_log_file(os.path.join(args.save_dir, "log.txt"))
    try:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(os.path.join(args.save_dir, "tensorboard"))
    except Exception:
        writer = None

    with open(args.dataset_info) as f:
        dataset_info = yaml.safe_load(f)
    train_index = OVCamoIndex.from_dataset_info(dataset_info, "train")
    log(f"[maple] {len(train_index)} samples / {len(train_index.classes)} classes")

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    model, cfg, params, bank = assemble_cascade(
        train_index.classes,
        clip_ckpt=args.clip_ckpt,
        maple_ckpt=args.maple_ckpt,
        text_bank_path=args.train_text_bank,
        dtype=dtype,
        tiny=args.tiny,
        seed=args.seed,
    )

    steps_per_epoch = max(1, len(train_index) // args.batch_size)
    tx = make_maple_optimizer(
        base_lr=args.lr,
        total_epochs=args.epochs,
        steps_per_epoch=steps_per_epoch,
        warmup_epochs=args.warmup_epochs,
    )
    # Drive the cascade's CustomClip pass; only clip_model/prompt_learner
    # paths are trainable.
    state = create_train_state(params, tx, MAPLE_TRAINABLE_SUBTREES)
    train_step = jax.jit(make_maple_train_step(model.clip_forward, tx))

    static_bank = {k: jnp.asarray(np.asarray(v)) for k, v in bank.items()}
    rng = np.random.default_rng(args.seed)
    best_acc = -1.0
    timer = Timer()
    for epoch in range(1, args.epochs + 1):
        timer.s()
        losses, accs = [], []
        for batch in iter_maple_train_batches(
            train_index, args.batch_size, rng, cfg.clip_size
        ):
            device_batch = {
                "clip_image": jnp.asarray(batch["clip_image"]),
                "clip_alpha": jnp.asarray(batch["clip_alpha"]),
                "label_id": jnp.asarray(batch["label_id"]),
                **static_bank,
            }
            state, metrics = train_step(state, device_batch)
            losses.append(float(metrics["loss"]))
            accs.append(float(metrics["acc"]))
        loss = float(np.mean(losses)) if losses else float("nan")
        acc = float(np.mean(accs)) if accs else 0.0
        log(f"[maple] epoch {epoch}/{args.epochs} loss={loss:.4f} "
            f"train-acc={acc:.4f} ({timer.t():.1f}s)")
        if writer:
            writer.add_scalar("maple/loss", loss, epoch)
            writer.add_scalar("maple/train_acc", acc, epoch)

        save_checkpoint(os.path.join(args.save_dir, "maple_last"), state)
        if acc > best_acc:
            best_acc = acc
            save_checkpoint(os.path.join(args.save_dir, "maple_best"), state)
            # flat npz of just the prompt-learner tensors for inspection/export
            flat = {
                "/".join(k): np.asarray(v)
                for k, v in state.trainable.items()
            }
            np.savez(os.path.join(args.save_dir, "prompt_learner_best.npz"), **flat)

    log(f"[maple] done; best train-acc {best_acc:.4f}")


if __name__ == "__main__":
    main()

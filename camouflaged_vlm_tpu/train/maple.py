"""MaPLe prompt-learner training (dassl-trainer equivalent).

The reference ships a dassl `MaPLeAlphaCLIP(TrainerX)` trainer
(`/root/reference/cocotrainers/mapleAlphaCLIP.py:300-440`) that produced the
shipped `model-best.pth.tar` prompt-learner checkpoint: CustomCLIP with every
parameter frozen except the multi-modal prompt learner
(`name_to_update = "prompt_learner"`, :323-331), trained with cross-entropy
on (image, GT-mask alpha, label) batches (`parse_batch_train` :395-404).
That trainer is dead code at the reference's entry points, but the capability
matters — it is how the prompt weights the cascade depends on are produced.

Here it is one jitted step: the frozen CLIP towers are partitioned out of the
differentiated function (train_step.partition_params), so jax AD never
builds a backward pass through the frozen weights' update path, and the
optimizer state covers only the ~50k prompt parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import optax

from .train_step import TrainState, combine_params

MAPLE_TRAINABLE_SUBTREES: Tuple[str, ...] = ("prompt_learner",)


def maple_loss(logits: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """Mean cross-entropy over class logits (dassl's F.cross_entropy)."""
    return optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), labels
    ).mean()


def make_maple_train_step(
    clip_forward: Callable,
    tx: optax.GradientTransformation,
) -> Callable[[TrainState, Dict[str, jnp.ndarray]], Tuple[TrainState, Dict[str, jnp.ndarray]]]:
    """`clip_forward(params, clip_image, clip_alpha, prefix, suffix,
    eot_indices, bank_features)` returns the CustomCLIP outputs (e.g.
    `OVCOSCascade.clip_forward`); batch keys: clip_image (B,h,w,3),
    clip_alpha (B,h,w,1), label_id (B,), prefix/suffix/eot_indices/
    bank_features for the TRAIN class split.

    Note the text features cannot be hoisted out of the step here (unlike
    inference): the learned ctx/deep prompts change every update, so the text
    tower runs inside the differentiated program, exactly like the
    reference's train branch (`mapleAlphaCLIP.py:267-280`).
    """

    def loss_fn(trainable, frozen, batch):
        params = combine_params(trainable, frozen)
        _, _, _, logits = clip_forward(
            params,
            batch["clip_image"],
            batch["clip_alpha"],
            batch["prefix"],
            batch["suffix"],
            batch["eot_indices"],
            batch["bank_features"],
        )
        loss = maple_loss(logits, batch["label_id"])
        acc = (jnp.argmax(logits, -1) == batch["label_id"]).mean()
        return loss, {"acc": acc}

    def train_step(state: TrainState, batch):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.trainable, state.frozen, batch
        )
        updates, new_opt_state = tx.update(grads, state.opt_state, state.trainable)
        new_trainable = optax.apply_updates(state.trainable, updates)
        return (
            state.replace(
                step=state.step + 1,
                trainable=new_trainable,
                opt_state=new_opt_state,
            ),
            {"loss": loss, **aux},
        )

    return train_step


def make_maple_optimizer(
    base_lr: float = 0.0035,
    total_epochs: int = 10,
    steps_per_epoch: int = 1,
    warmup_epochs: int = 1,
    warmup_lr: float = 1e-5,
    momentum: float = 0.9,
    weight_decay: float = 5e-4,
) -> optax.GradientTransformation:
    """SGD + constant warmup + per-epoch cosine — dassl's MaPLe OPTIM recipe
    (the reference consumes it via `build_optimizer(self.model, cfg.OPTIM)`,
    `mapleAlphaCLIP.py:345-346`). dassl's ConstantWarmupScheduler holds
    `warmup_lr` during the warmup epochs; the inner
    CosineAnnealingLR(T_max=total_epochs) only starts stepping AFTER warmup
    (dassl's `build_lr_scheduler` rewinds it to `warmup_epoch - 1` only when
    `WARMUP_RECOUNT` is False, and the default — which the reference's
    config never overrides — is True), so post-warmup epoch e trains at
    cosine index (e - warmup): the FIRST post-warmup epoch runs at full
    base_lr, and the cosine never reaches its T_max tail."""
    import jax.numpy as jnp

    def schedule(step):
        epoch = jnp.minimum(step // steps_per_epoch, total_epochs)
        cos_idx = jnp.maximum(epoch - warmup_epochs, 0)
        cos = 0.5 * base_lr * (1.0 + jnp.cos(jnp.pi * cos_idx / total_epochs))
        return jnp.where(epoch < warmup_epochs, warmup_lr, cos)

    return optax.chain(
        optax.add_decayed_weights(weight_decay),
        optax.sgd(schedule, momentum=momentum),
    )

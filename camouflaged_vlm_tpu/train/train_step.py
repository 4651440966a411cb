"""Jittable training step.

Functional equivalent of the reference's `optimize_parameters`
(`/root/reference/models/sam_maskdecoder_edge.py:456-460`) + the DDP loop
(`/root/reference/train_ovcos_maskdecoder_edge.py:183-238`), as ONE compiled
program: forward, loss, grad, AdamW update. Data parallelism comes from the
batch's `data`-axis sharding; XLA inserts the gradient reductions
(correctly — unlike the reference, whose DDP wrapper is unwrapped before
training so its ranks never synchronise gradients; see SURVEY.md §5.8).

Frozen parameters (SAM ViT weights, the whole CLIP tower) are PARTITIONED
out of the differentiated function rather than masked in the optimizer:
jax AD then prunes the backward pass through the frozen CLIP tower entirely
(it feeds the decoder only through its outputs) and skips frozen-weight
grads, saving both FLOPs and activation memory. The optimizer state covers
only the trainable subtree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import optax

from ..utils.tree import flatten_dict, unflatten_dict
from .losses import segmentation_loss
from .optim import trainable_mask


def partition_params(params, trainable_subtrees=None) -> Tuple[Dict, Dict]:
    """Split a params pytree into (trainable, frozen) flat-dict halves.

    `trainable_subtrees` defaults to the cascade freeze rule
    (optim.TRAINABLE_SUBTREES); the MaPLe prompt trainer passes
    ('prompt_learner',) instead."""
    if trainable_subtrees is None:
        labels = flatten_dict(trainable_mask(params))
    else:
        labels = flatten_dict(trainable_mask(params, trainable_subtrees))
    flat = flatten_dict(params)
    train = {k: v for k, v in flat.items() if labels[k] == "train"}
    frozen = {k: v for k, v in flat.items() if labels[k] == "freeze"}
    return train, frozen


def combine_params(train: Dict, frozen: Dict):
    return unflatten_dict({**train, **frozen})


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    trainable: Any   # flat dict of trainable leaves
    frozen: Any      # flat dict of frozen leaves
    opt_state: Any

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    @property
    def params(self):
        return combine_params(self.trainable, self.frozen)


def create_train_state(
    params, tx: optax.GradientTransformation, trainable_subtrees=None
) -> TrainState:
    trainable, frozen = partition_params(params, trainable_subtrees)
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        trainable=trainable,
        frozen=frozen,
        opt_state=tx.init(trainable),
    )


# Batch tensors that carry a per-image leading dim (and, under gradient
# accumulation, a leading microbatch dim). Everything else in the batch dict
# (text bank tensors) is image-independent and shared across microbatches.
SCANNED_BATCH_KEYS = ("inp", "gt", "clip_image", "clip_mask")


def make_train_step(
    model,
    tx: optax.GradientTransformation,
    loss_mode: str = "iou",
    accum_steps: int = 1,
) -> Callable[[TrainState, Dict[str, jnp.ndarray]], Tuple[TrainState, Dict[str, jnp.ndarray]]]:
    """batch keys: inp (B,H,W,3), gt (B,H,W,1), clip_image (B,h,w,3),
    clip_mask (B,h,w,1), prefix, suffix, eot_indices, bank_features.

    With `accum_steps > 1` the image tensors arrive with a leading
    microbatch axis ((A, B/A, ...) — reshaped HOST-side so the data-axis
    sharding stays on the per-microbatch batch dim; an in-jit reshape of a
    batch-sharded axis would insert a resharding collective) and the step
    `lax.scan`s the forward+backward over microbatches, averaging gradients
    before ONE optimizer update. Activation memory is one microbatch's;
    the extra carry is just the trainable-subtree gradients. Per-image-mean
    losses (iou/bce) average to exactly the full-batch loss; bbce's
    batch-level negative weight is computed per microbatch (the standard
    gradient-accumulation deviation)."""

    def loss_fn(trainable, frozen, batch):
        params = combine_params(trainable, frozen)
        if "text_features" in batch:
            # Precomputed class-text features (exact: the text tower is
            # frozen during cascade training — see
            # OVCOSCascade.forward_with_text). cli/train encodes them once.
            masks, edges = model.forward_with_text(
                params,
                batch["inp"],
                batch["clip_image"],
                batch["clip_mask"],
                batch["text_features"],
            )
        else:
            masks, edges = model(
                params,
                batch["inp"],
                batch["clip_image"],
                batch["clip_mask"],
                batch["prefix"],
                batch["suffix"],
                batch["eot_indices"],
                batch["bank_features"],
            )
        total, parts = segmentation_loss(masks, edges, batch["gt"], loss_mode)
        return total, parts

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

    def apply(state: TrainState, grads, metrics):
        updates, new_opt_state = tx.update(grads, state.opt_state, state.trainable)
        new_trainable = optax.apply_updates(state.trainable, updates)
        return (
            state.replace(
                step=state.step + 1,
                trainable=new_trainable,
                opt_state=new_opt_state,
            ),
            metrics,
        )

    def train_step(state: TrainState, batch):
        (total, parts), grads = grad_fn(state.trainable, state.frozen, batch)
        return apply(state, grads, {"loss": total, **parts})

    if accum_steps == 1:
        return train_step

    def train_step_accum(state: TrainState, batch):
        scanned = {k: batch[k] for k in SCANNED_BATCH_KEYS}
        static = {k: v for k, v in batch.items() if k not in SCANNED_BATCH_KEYS}
        for k, v in scanned.items():
            # a mismatched leading dim would silently mis-scale the
            # gradient average (scan runs shape[0] iterations, the divisor
            # below is accum_steps)
            assert v.shape[0] == accum_steps, (
                f"batch['{k}'] leading dim {v.shape[0]} != accum_steps "
                f"{accum_steps}: reshape to (accum, B/accum, ...) host-side"
            )

        def micro(gsum, mb):
            (total, parts), g = grad_fn(
                state.trainable, state.frozen, {**mb, **static}
            )
            return (
                jax.tree.map(jnp.add, gsum, g),
                {"loss": total, **parts},
            )

        gsum, metrics = jax.lax.scan(
            micro, jax.tree.map(jnp.zeros_like, state.trainable), scanned
        )
        grads = jax.tree.map(lambda g: g / accum_steps, gsum)
        metrics = jax.tree.map(lambda m: m.mean(0), metrics)
        return apply(state, grads, metrics)

    return train_step_accum

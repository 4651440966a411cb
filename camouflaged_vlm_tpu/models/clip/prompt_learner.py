"""MaPLe multi-modal prompt learner.

Re-design of `MultiModalPromptLearner`
(`/root/reference/cocotrainers/mapleAlphaCLIP.py:81-227`):

  * `ctx`: n_ctx learned text tokens, initialised from the embedding of
    "a photo of a" (done by the checkpoint converter / bank builder);
  * `proj`: Linear(text_width -> vision_width) mapping ctx to the shallow
    visual prompt;
  * `compound_prompts_text[i]` (i < prompt_depth-1): deep text prompts, each
    with its own Linear(text_width -> vision_width) producing the deep visual
    prompts.

The frozen per-class token prefix/suffix (SOT embedding and class-name/EOT
embeddings) are *data*, not parameters — the reference registers them as
non-restored buffers recomputed from the current class names
(mapleAlphaCLIP.py:140-167). Here they live in a `ClassPromptBank` built on
host from the tokenizer + the checkpoint's token-embedding table, passed into
`apply` as a regular input. This keeps train/test class splits switchable
without touching parameters, and keeps the jitted program static-shaped.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from .. import layers as L

from .tokenizer import tokenize


@dataclasses.dataclass(frozen=True)
class PromptLearnerConfig:
    n_ctx: int = 4
    prompt_depth: int = 9
    text_width: int = 768
    vision_width: int = 1024
    ctx_init: str = "a photo of a"
    dtype: jnp.dtype = jnp.float32


@dataclasses.dataclass
class ClassPromptBank:
    """Frozen per-class prompt data for one class split."""

    tokenized: np.ndarray     # (N, 77) int32
    prefix: np.ndarray        # (N, 1, text_width) — SOT embedding
    suffix: np.ndarray        # (N, 77-1-n_ctx, text_width) — class/EOT embeddings
    eot_indices: np.ndarray   # (N,) int32 — argmax of token ids

    @property
    def num_classes(self) -> int:
        return self.tokenized.shape[0]


def build_class_prompt_bank(
    classnames: Sequence[str],
    token_embedding: np.ndarray,  # (vocab, text_width)
    n_ctx: int = 4,
    ctx_init: str = "a photo of a",
    context_length: int = 77,
) -> ClassPromptBank:
    """Tokenize '"{ctx_init}" {name}.' per class and embed prefix/suffix."""
    names = [name.replace("_", " ") for name in classnames]
    prompts = [f"{ctx_init} {name}." for name in names]
    tokenized = tokenize(prompts, context_length)  # (N, 77)
    embedded = token_embedding[tokenized]  # (N, 77, width)
    return ClassPromptBank(
        tokenized=tokenized,
        prefix=embedded[:, :1, :].astype(np.float32),
        suffix=embedded[:, 1 + n_ctx :, :].astype(np.float32),
        eot_indices=tokenized.argmax(axis=-1).astype(np.int32),
    )


def ctx_init_embedding(
    token_embedding: np.ndarray, ctx_init: str = "a photo of a", n_ctx: int = 4
) -> np.ndarray:
    """Initial value for the learned ctx: embedding of the init phrase."""
    ids = tokenize(ctx_init)[0]
    return token_embedding[ids[1 : 1 + n_ctx]].astype(np.float32)


def init(cfg: PromptLearnerConfig, key) -> dict:
    k = L.Keys(key)
    params = {
        "ctx": L.normal(k(), (cfg.n_ctx, cfg.text_width), 0.02),
        "proj": L.dense_init(k(), cfg.text_width, cfg.vision_width),
    }
    for i in range(cfg.prompt_depth - 1):
        params[f"compound_prompts_text_{i}"] = L.normal(
            k(), (cfg.n_ctx, cfg.text_width), 0.02
        )
        params[f"compound_prompt_proj_{i}"] = L.dense_init(
            k(), cfg.text_width, cfg.vision_width
        )
    return params


def apply(
    cfg: PromptLearnerConfig, params: dict, prefix: jnp.ndarray, suffix: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, List[jnp.ndarray], List[jnp.ndarray]]:
    """Returns (prompts, shared_ctx, deep_text_prompts, deep_visual_prompts).

    prefix: (N, 1, W), suffix: (N, L-1-n_ctx, W) for the active class split.
    """
    ctx = params["ctx"]
    n_cls = prefix.shape[0]
    ctx_b = jnp.broadcast_to(ctx[None], (n_cls, cfg.n_ctx, cfg.text_width))
    prompts = jnp.concatenate(
        [prefix.astype(jnp.float32), ctx_b, suffix.astype(jnp.float32)], axis=1
    )
    shared_ctx = L.dense(params["proj"], ctx, cfg.dtype)
    deep_text: List[jnp.ndarray] = []
    deep_visual: List[jnp.ndarray] = []
    for i in range(cfg.prompt_depth - 1):
        pt = params[f"compound_prompts_text_{i}"]
        deep_text.append(pt)
        deep_visual.append(L.dense(params[f"compound_prompt_proj_{i}"], pt, cfg.dtype))
    return prompts, shared_ctx, deep_text, deep_visual

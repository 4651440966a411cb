"""Edge-aware SAM mask decoder.

Re-design of `/root/reference/models/mmseg/models/sam/mask_decoder_edge.py`
(MaskDecoder :16-190). Differences from stock SAM:

  * 6 output tokens: iou + 4 mask tokens + 1 edge token;
  * prompt tokens are NOT concatenated into the query stream — the CLIP
    sparse embeddings enter as the `cond` stream of the two-way transformer
    (`mask_decoder_edge.py:152-154`);
  * `embedding_encoder` upsamples image embeddings 4x into edge features,
    `embedding_maskfeature` refines the upscaled mask features, and the final
    mask is fused as `masks * sigmoid(edge) + masks` (`:181-186`);
  * `interm_embeddings` is accepted and ignored, faithfully reproducing the
    reference's dead argument (`:99` — its `compress_vit_feat` is commented
    out).

Layout notes: everything is NHWC; the hypernetwork mask product is one
einsum over (tokens, channels) x (channels, pixels).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from . import layers as L
from . import two_way_transformer
from .two_way_transformer import TwoWayTransformerConfig


@dataclasses.dataclass(frozen=True)
class MaskDecoderConfig:
    transformer_dim: int = 256
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    transformer: TwoWayTransformerConfig = dataclasses.field(
        default_factory=TwoWayTransformerConfig
    )
    dtype: jnp.dtype = jnp.float32

    @property
    def num_mask_tokens(self) -> int:  # 4 mask + 1 edge
        return self.num_multimask_outputs + 1 + 1


def _init_hyper_mlp(key, din: int, hidden: int, out: int, num_layers: int = 3) -> dict:
    k = L.Keys(key)
    dims = [din] + [hidden] * (num_layers - 1) + [out]
    return {f"layer_{i}": L.dense_init(k(), dims[i], dims[i + 1])
            for i in range(num_layers)}


def hyper_mlp(p: dict, x: jnp.ndarray, dtype) -> jnp.ndarray:
    """ReLU MLP (reference `MLP`, `mask_decoder_edge.py:195-217`)."""
    n = len(p)
    for i in range(n - 1):
        x = jax.nn.relu(L.dense(p[f"layer_{i}"], x, dtype))
    return L.dense(p[f"layer_{n - 1}"], x, dtype)


def init(cfg: MaskDecoderConfig, key) -> dict:
    k = L.Keys(key)
    C = cfg.transformer_dim
    params = {
        "edge_encoder_conv1": L.conv_transpose_init(k(), 2, 2, C, C // 4),
        "edge_encoder_ln": L.ln_init(C // 4),
        "edge_encoder_conv2": L.conv_transpose_init(k(), 2, 2, C // 4, C // 8),
        "iou_token": L.normal(k(), (1, C), 1.0),
        "mask_tokens": L.normal(k(), (cfg.num_mask_tokens - 1, C), 1.0),
        "edge_token": L.normal(k(), (1, C), 1.0),
        "transformer": two_way_transformer.init(cfg.transformer, k()),
        "upscale_conv1": L.conv_transpose_init(k(), 2, 2, C, C // 4),
        "upscale_ln": L.ln_init(C // 4),
        "upscale_conv2": L.conv_transpose_init(k(), 2, 2, C // 4, C // 8),
        "maskfeature_conv1": L.conv_transpose_init(k(), 3, 3, C // 8, C // 4),
        "maskfeature_ln": L.ln_init(C // 4),
        "maskfeature_conv2": L.conv_transpose_init(k(), 3, 3, C // 4, C // 8),
        "edge_mlp": _init_hyper_mlp(k(), C, C, C // 8),
        "iou_prediction_head": _init_hyper_mlp(
            k(), C, cfg.iou_head_hidden_dim, cfg.num_mask_tokens - 1,
            cfg.iou_head_depth,
        ),
    }
    for i in range(cfg.num_mask_tokens - 1):
        params[f"hyper_mlp_{i}"] = _init_hyper_mlp(k(), C, C, C // 8)
    return params


def apply(
    cfg: MaskDecoderConfig,
    params: dict,
    image_embeddings: jnp.ndarray,       # (B, h, w, C) NHWC
    image_pe: jnp.ndarray,               # (h, w, C)
    sparse_prompt_embeddings: jnp.ndarray,  # (B, S, C) — cond stream
    dense_prompt_embeddings: jnp.ndarray,   # (B, h, w, C)
    multimask_output: bool = False,
    interm_embeddings: Optional[List[jnp.ndarray]] = None,  # accepted, unused
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    p, dt = params, cfg.dtype
    C = cfg.transformer_dim
    B, h, w, _ = image_embeddings.shape
    n_tokens = 1 + cfg.num_mask_tokens  # iou + 4 mask + edge
    gelu = lambda x: jax.nn.gelu(x, approximate=False)

    # Deep edge features from raw image embeddings (4x upsample).
    e = L.conv_transpose(p["edge_encoder_conv1"], image_embeddings, 2, "VALID", dt)
    e = gelu(L.ln(p["edge_encoder_ln"], e, 1e-6))
    edge_embeddings = L.conv_transpose(p["edge_encoder_conv2"], e, 2, "VALID", dt)

    output_tokens = jnp.concatenate(
        [p["iou_token"], p["mask_tokens"], p["edge_token"]], axis=0
    )
    tokens = jnp.broadcast_to(output_tokens[None].astype(dt), (B, n_tokens, C))

    src = image_embeddings + dense_prompt_embeddings
    src_flat = src.reshape(B, h * w, C)
    pe_flat = jnp.broadcast_to(
        image_pe.reshape(1, h * w, C).astype(dt), (B, h * w, C)
    )

    hs, src_out = two_way_transformer.apply(
        cfg.transformer, p["transformer"],
        src_flat, pe_flat, tokens, sparse_prompt_embeddings,
    )
    iou_token_out = hs[:, 0, :]
    mask_tokens_out = hs[:, 1 : 1 + cfg.num_mask_tokens, :]

    # Upscale transformer-refined image embeddings 4x.
    src_img = src_out.reshape(B, h, w, C)
    upscaled = L.conv_transpose(p["upscale_conv1"], src_img, 2, "VALID", dt)
    upscaled = gelu(L.ln(p["upscale_ln"], upscaled, 1e-6))
    upscaled = gelu(L.conv_transpose(p["upscale_conv2"], upscaled, 2, "VALID", dt))

    # Edge feature refinement (3x3 "ConvTranspose" with stride 1 == conv).
    f = L.conv_transpose(p["maskfeature_conv1"], upscaled, 1, "SAME", dt)
    f = gelu(L.ln(p["maskfeature_ln"], f, 1e-6))
    f = L.conv_transpose(p["maskfeature_conv2"], f, 1, "SAME", dt)
    edge_feat = f + edge_embeddings

    # Hypernetwork heads: 5 per-token MLPs (4 mask + 1 edge).
    hyper_masks = jnp.stack(
        [hyper_mlp(p[f"hyper_mlp_{i}"], mask_tokens_out[:, i, :], dt)
         for i in range(cfg.num_mask_tokens - 1)],
        axis=1,
    )  # (B, 4, C/8)
    hyper_edge = hyper_mlp(
        p["edge_mlp"], mask_tokens_out[:, cfg.num_mask_tokens - 1, :], dt
    )

    masks = jnp.einsum(
        "btc,bhwc->bthw", hyper_masks, upscaled, preferred_element_type=jnp.float32
    )
    edge = jnp.einsum(
        "bc,bhwc->bhw", hyper_edge, edge_feat, preferred_element_type=jnp.float32
    )[:, None]  # (B, 1, H4, W4)

    edge = jax.nn.sigmoid(edge)
    masks = masks * edge + masks  # edge-gated fusion (fp32)

    # The reference builds the IoU head before adding the edge token, so
    # it predicts only the 4 mask qualities (`mask_decoder_edge.py:67-74`).
    iou_pred = hyper_mlp(p["iou_prediction_head"], iou_token_out, dt)

    if multimask_output:
        masks = masks[:, 1:, :, :]
        iou_pred = iou_pred[:, 1:]
    else:
        masks = masks[:, 0:1, :, :]
        iou_pred = iou_pred[:, 0:1]

    # (B, n, H4, W4) logits fp32; edge (B, 1, H4, W4) in [0, 1].
    return masks, edge, iou_pred

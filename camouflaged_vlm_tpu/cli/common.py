"""Shared CLI plumbing: model assembly from checkpoints + banks."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..factory import build_full_cascade, build_tiny_cascade, make_bank_inputs, init_cascade_params
from ..models import CascadeConfig, OVCOSCascade
from ..models.clip import build_class_prompt_bank
from ..io import (
    load_torch_state_dict,
    load_openai_clip_state_dict,
    load_dassl_checkpoint,
)
from ..io.convert import (
    convert_cascade_checkpoint,
    convert_sam_backbone,
    convert_openai_clip,
    convert_maple_prompt_learner,
    merge_into_params,
)
from ..utils.logging import log


def assemble_cascade(
    classnames: Sequence[str],
    cascade_ckpt: Optional[str] = None,
    sam_ckpt: Optional[str] = None,
    clip_ckpt: Optional[str] = None,
    maple_ckpt: Optional[str] = None,
    text_bank_path: Optional[str] = None,
    dtype=jnp.bfloat16,
    tiny: bool = False,
    seed: int = 0,
    return_bank_builder: bool = False,
    config: Optional[CascadeConfig] = None,
):
    """Build model + params + class bank, restoring whatever checkpoints exist.

    Mirrors the reference's assembly order
    (`/root/reference/test_ovcos_maskdecoder_edge.py:180-189`,
    `/root/reference/train_ovcos_maskdecoder_edge.py:266-303`): OpenAI CLIP
    -> MaPLe prompt learner -> SAM backbone -> trained cascade (strict).
    Missing checkpoints leave random init (useful for smoke tests/benches).
    """
    if config is not None:
        cfg = config
        model = OVCOSCascade(cfg)
    else:
        model, cfg = (build_tiny_cascade if tiny else build_full_cascade)(dtype=dtype)

    # model-zoo names/URLs resolve to cached, checksum-verified downloads
    # (reference: alpha_clip_rw/alpha_clip.py:135-141); plain paths pass
    # through and keep the missing-file-skips-restore smoke-test semantics
    from ..io.download import CLIP_MODELS, resolve_checkpoint

    if clip_ckpt and (
        clip_ckpt in CLIP_MODELS or clip_ckpt.startswith(("http://", "https://"))
    ):
        clip_ckpt = resolve_checkpoint(clip_ckpt)

    token_embedding = None
    clip_tree = None
    if clip_ckpt and os.path.exists(clip_ckpt):
        sd = load_openai_clip_state_dict(clip_ckpt)
        clip_tree, token_embedding, missing = convert_openai_clip(sd, cfg.clip)
        log(f"[assemble] OpenAI CLIP loaded from {clip_ckpt} (missing={len(missing)})")

    bank_features = None
    if text_bank_path and os.path.exists(text_bank_path):
        bank_features = load_torch_state_dict_as_array(text_bank_path)
        log(f"[assemble] text-feature bank {bank_features.shape} from {text_bank_path}")

    bank = make_bank_inputs(
        cfg, classnames, token_embedding=token_embedding,
        bank_features=bank_features, seed=seed,
    )

    params = init_cascade_params(model, seed=seed)
    params = jax.tree.map(np.asarray, params)  # host-side for merging

    if clip_tree is not None:
        params = merge_into_params(params, clip_tree)
    if maple_ckpt and os.path.exists(maple_ckpt):
        sd, extras = load_dassl_checkpoint(maple_ckpt)
        tree, missing, _ = convert_maple_prompt_learner(sd, cfg.clip)
        params = merge_into_params(params, tree)
        log(f"[assemble] MaPLe prompt learner from {maple_ckpt} (epoch={extras.get('epoch')})")
    if sam_ckpt and os.path.exists(sam_ckpt):
        sd = load_torch_state_dict(sam_ckpt)
        tree, missing, used = convert_sam_backbone(sd, cfg)
        params = merge_into_params(params, tree)
        log(f"[assemble] SAM backbone from {sam_ckpt} ({len(used)} tensors)")
    if cascade_ckpt and os.path.exists(cascade_ckpt):
        sd = load_torch_state_dict(cascade_ckpt)
        tree, missing, used = convert_cascade_checkpoint(sd, cfg)
        params = merge_into_params(params, tree)
        log(f"[assemble] cascade weights from {cascade_ckpt} ({len(used)} tensors, {len(missing)} missing)")

    # cast big weights to compute dtype (layer norms stay fp32 via ndim<2 rule)
    params = jax.tree.map(
        lambda p: jnp.asarray(p, dtype) if np.asarray(p).ndim >= 2 else jnp.asarray(p),
        params,
    )
    if return_bank_builder:
        def make_bank(names: Sequence[str], bank_features=None, bank_path=None):
            feats = bank_features
            if feats is None and bank_path and os.path.exists(bank_path):
                feats = load_torch_state_dict_as_array(bank_path)
            return make_bank_inputs(
                cfg, names, token_embedding=token_embedding,
                bank_features=feats, seed=seed,
            )

        return model, cfg, params, bank, make_bank
    return model, cfg, params, bank


def load_torch_state_dict_as_array(path: str) -> np.ndarray:
    """Load a text-feature bank: .npy (native) or .pth single-tensor."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    import torch

    t = torch.load(path, map_location="cpu", weights_only=False)
    return t.detach().cpu().float().numpy()

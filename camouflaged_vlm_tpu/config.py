"""YAML -> config dataclass loading.

Capability equivalent of the reference's yaml config system
(`/root/reference/configs/*.yaml` + the DotDict plumbing in each entry
script), mapped onto the typed dataclass configs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp

from .models import CascadeConfig, SamEncoderConfig, MaskDecoderConfig
from .models.two_way_transformer import TwoWayTransformerConfig
from .models.clip import AlphaClipConfig

_DTYPES = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}


def _build(dc_cls, spec: Dict[str, Any], **extra):
    fields = {f.name for f in dataclasses.fields(dc_cls)}
    kwargs = {k: v for k, v in (spec or {}).items() if k in fields}
    unknown = set(spec or {}) - fields - set(extra)
    if unknown:
        raise KeyError(f"unknown {dc_cls.__name__} keys: {sorted(unknown)}")
    kwargs.update(extra)
    if "global_attn_indexes" in kwargs:
        kwargs["global_attn_indexes"] = tuple(kwargs["global_attn_indexes"])
    return dc_cls(**kwargs)


def _from_reference_yaml(raw: Dict[str, Any]) -> Tuple[CascadeConfig, Dict[str, Any]]:
    """Map the reference's OWN config format onto (CascadeConfig, train hp).

    A reference user's `configs/ovcos-sam-vit-h-maskdecoder-edge.yaml`
    (consumed by `/root/reference/train_ovcos_maskdecoder_edge.py:380-400`
    via its DotDict plumbing) loads directly: `--config` auto-detects the
    format, so switching frameworks does not require rewriting configs.
    this framework's numerics defaults (bfloat16, fused blocks) apply — pass a re-keyed
    native yaml to override those.
    """
    m = raw["model"]["args"]
    enc = dict(m.get("encoder_mode", {}))
    # The implemented EVP variant (fft high-pass handcrafted+embedding
    # tuning, adaptor prompts, tuning stage 1234, qkv bias): any other
    # requested variant must fail loudly, not silently train the wrong one.
    # NB the reference itself HARDCODES every selector except qkv_bias
    # (image_encoder.py:116-123 overrides the yaml), so a config that passes
    # here runs the same variant under both frameworks.
    for key, want in (("name", "sam"), ("input_type", "fft"),
                      ("prompt_type", "highpass"), ("tuning_stage", 1234),
                      ("handcrafted_tune", True), ("embedding_tune", True),
                      ("adaptor", "adaptor"), ("qkv_bias", True)):
        got = enc.get(key, want)
        if got != want:
            raise ValueError(
                f"reference config encoder_mode.{key}={got!r} — only "
                f"{want!r} is implemented (SURVEY.md §2.6)"
            )
    dtype = jnp.bfloat16
    enc_spec = dict(
        img_size=enc.get("img_size", 1024),
        patch_size=enc.get("patch_size", 16),
        embed_dim=enc.get("embed_dim", 1280),
        depth=enc.get("depth", 32),
        num_heads=enc.get("num_heads", 16),
        mlp_ratio=float(enc.get("mlp_ratio", 4)),
        out_chans=enc.get("out_chans", 256),
        window_size=enc.get("window_size", 14),
        global_attn_indexes=tuple(enc.get("global_attn_indexes", (7, 15, 23, 31))),
        use_rel_pos=enc.get("use_rel_pos", True),
        prompt_scale_factor=enc.get("scale_factor", 32),
        freq_rate=enc.get("freq_nums", 0.25),
    )
    maple = (raw.get("MAPLE_ALPHA_CLIP") or {}).get("TRAINER", {}).get("MAPLE", {})
    clip_spec = {}
    if "N_CTX" in maple:
        clip_spec["n_ctx"] = maple["N_CTX"]
    if "PROMPT_DEPTH" in maple:
        clip_spec["prompt_depth"] = maple["PROMPT_DEPTH"]
    prompt_dim = enc.get("prompt_embed_dim", 256)
    clip_size = (
        (raw.get("MAPLE_ALPHA_CLIP") or {}).get("INPUT", {}).get("SIZE", [336])
    )[0]
    twt = _build(TwoWayTransformerConfig, {}, embedding_dim=prompt_dim, dtype=dtype)
    cfg = CascadeConfig(
        inp_size=m.get("inp_size", 1024),
        clip_size=clip_size,
        prompt_embed_dim=prompt_dim,
        encoder=_build(SamEncoderConfig, enc_spec, dtype=dtype),
        decoder=_build(
            MaskDecoderConfig, {"transformer_dim": prompt_dim},
            transformer=twt, dtype=dtype,
        ),
        clip=_build(AlphaClipConfig, clip_spec, dtype=dtype),
    )
    train_hp = {
        "epochs": raw.get("epoch_max", 20),
        "lr": (raw.get("optimizer") or {}).get("args", {}).get("lr", 2e-4),
        "eta_min": raw.get("lr_min", 1e-7),
        "epoch_val": raw.get("epoch_val", 2),
        "batch_size": (raw.get("train_dataset") or {}).get("batch_size", 1),
        "loss": m.get("loss", "iou"),
    }
    return cfg, train_hp


def cascade_config_from_yaml(path: str) -> Tuple[CascadeConfig, Dict[str, Any]]:
    """Returns (CascadeConfig, train-hyperparameter dict). Accepts BOTH the
    native re-keyed format (configs/*.yaml here) and the reference's own
    format (auto-detected by its `model.args` nesting)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    m = raw["model"]
    if "args" in m:
        return _from_reference_yaml(raw)
    dtype = _DTYPES[m.get("dtype", "bfloat16")]

    dec_spec = dict(m.get("decoder", {}))
    twt_spec = dec_spec.pop("transformer", {})
    twt = _build(
        TwoWayTransformerConfig, twt_spec,
        embedding_dim=dec_spec.get("transformer_dim", 256), dtype=dtype,
    )
    cfg = CascadeConfig(
        inp_size=m.get("inp_size", 1024),
        clip_size=m.get("clip_size", 336),
        prompt_embed_dim=dec_spec.get("transformer_dim", 256),
        encoder=_build(SamEncoderConfig, m.get("encoder", {}), dtype=dtype),
        decoder=_build(MaskDecoderConfig, dec_spec, transformer=twt, dtype=dtype),
        clip=_build(AlphaClipConfig, m.get("clip", {}), dtype=dtype),
    )
    return cfg, raw.get("train", {})

"""Torch-layout -> parameter-tree weight conversion.

A declarative key map covers every parameter of the cascade; each entry is
(torch_key, param_path, kind) where `kind` names the tensor transform:

  linear_w  (out,in)        -> kernel (in,out)        transpose
  convT_w   (in,out,kh,kw)  -> kernel (kh,kw,out,in)  transpose(2,3,1,0)
            (models/layers.conv_transpose uses transpose_kernel=True)
  conv_w    (out,in,kh,kw)  -> kernel (kh,kw,in,out)  transpose(2,3,1,0)
  row0      (1,D) embedding -> (D,)                   squeeze
  direct    identical layout

The map is generated from the model config, so shape checks are exact and a
coverage test guarantees every param is written (tests/test_convert.py).

Reference torch layouts: `/root/reference/models/sam_maskdecoder_edge.py`
(cascade), `/root/reference/models/mmseg/models/sam/*` (SAM modules),
`/root/reference/alpha_clip_rw/model.py:825-884` (`build_model`'s in_proj
rename + conv1_alpha zero-init), `/root/reference/cocotrainers/mapleAlphaCLIP.py`
(CustomCLIP/prompt learner).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..models.cascade import CascadeConfig
from ..models.clip.model import AlphaClipConfig

KeyMapEntry = Tuple[str, str, str]  # (torch_key, param_path, kind)


def _transform(kind: str, v: np.ndarray) -> np.ndarray:
    if kind == "linear_w":
        return np.ascontiguousarray(v.T)
    if kind == "conv_w":
        return np.ascontiguousarray(v.transpose(2, 3, 1, 0))
    if kind == "convT_w":
        # torch (in,out,kh,kw) -> (kh,kw,out,in) for transpose_kernel=True
        # kernel layout (kh,kw,out,in) — verified vs torch in test_convert.py.
        return np.ascontiguousarray(v.transpose(2, 3, 1, 0))
    if kind == "row0":
        return np.ascontiguousarray(v.reshape(-1))
    if kind == "direct":
        # NB: np.ascontiguousarray promotes 0-d arrays to 1-d; preserve shape.
        return np.ascontiguousarray(v).reshape(np.asarray(v).shape)
    raise ValueError(f"unknown transform kind {kind!r}")


def _linear(tk: str, fp: str) -> List[KeyMapEntry]:
    return [(f"{tk}.weight", f"{fp}/kernel", "linear_w"), (f"{tk}.bias", f"{fp}/bias", "direct")]


def _ln(tk: str, fp: str) -> List[KeyMapEntry]:
    return [(f"{tk}.weight", f"{fp}/scale", "direct"), (f"{tk}.bias", f"{fp}/bias", "direct")]


def _conv(tk: str, fp: str, bias: bool = True) -> List[KeyMapEntry]:
    out = [(f"{tk}.weight", f"{fp}/kernel", "conv_w")]
    if bias:
        out.append((f"{tk}.bias", f"{fp}/bias", "direct"))
    return out


def _convT(tk: str, fp: str) -> List[KeyMapEntry]:
    return [(f"{tk}.weight", f"{fp}/kernel", "convT_w"), (f"{tk}.bias", f"{fp}/bias", "direct")]


def _proj_attn(tk: str, fp: str) -> List[KeyMapEntry]:
    """Decoder-style attention with separate q/k/v/out projections."""
    out: List[KeyMapEntry] = []
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        out += _linear(f"{tk}.{name}", f"{fp}/{name}")
    return out


def _sam_encoder_map(cfg: CascadeConfig, prefix: str = "image_encoder") -> List[KeyMapEntry]:
    enc = cfg.encoder
    fp = "image_encoder"
    m: List[KeyMapEntry] = []
    m += _conv(f"{prefix}.patch_embed.proj", f"{fp}/patch_embed")
    m.append((f"{prefix}.pos_embed", f"{fp}/pos_embed", "direct"))
    for i in range(enc.depth):
        t = f"{prefix}.blocks.{i}"
        f = f"{fp}/block_{i}"
        m += _ln(f"{t}.norm1", f"{f}/norm1") + _ln(f"{t}.norm2", f"{f}/norm2")
        m += _linear(f"{t}.attn.qkv", f"{f}/attn/qkv")
        m += _linear(f"{t}.attn.proj", f"{f}/attn/proj")
        m.append((f"{t}.attn.rel_pos_h", f"{f}/attn/rel_pos_h", "direct"))
        m.append((f"{t}.attn.rel_pos_w", f"{f}/attn/rel_pos_w", "direct"))
        m += _linear(f"{t}.mlp.lin1", f"{f}/mlp/lin1")
        m += _linear(f"{t}.mlp.lin2", f"{f}/mlp/lin2")
    m += _conv(f"{prefix}.neck.0", f"{fp}/neck_conv1", bias=False)
    m += _ln(f"{prefix}.neck.1", f"{fp}/neck_ln1")
    m += _conv(f"{prefix}.neck.2", f"{fp}/neck_conv2", bias=False)
    m += _ln(f"{prefix}.neck.3", f"{fp}/neck_ln2")
    # EVP prompt generator
    pg_t, pg_f = f"{prefix}.prompt_generator", f"{fp}/prompt_generator"
    m += _linear(f"{pg_t}.shared_mlp", f"{pg_f}/shared_mlp")
    m += _linear(f"{pg_t}.embedding_generator", f"{pg_f}/embedding_generator")
    for i in range(enc.depth):
        m += _linear(f"{pg_t}.lightweight_mlp_{i}.0", f"{pg_f}/lightweight_mlp_{i}")
    m += _conv(f"{pg_t}.prompt_generator.proj", f"{pg_f}/handcrafted_embed")
    return m


def _mask_decoder_map(cfg: CascadeConfig, prefix: str = "mask_decoder") -> List[KeyMapEntry]:
    fp = "mask_decoder"
    m: List[KeyMapEntry] = []
    for tok in ("iou_token", "mask_tokens", "edge_token"):
        m.append((f"{prefix}.{tok}.weight", f"{fp}/{tok}", "direct"))
    for i in range(cfg.decoder.transformer.depth):
        t = f"{prefix}.transformer.layers.{i}"
        f = f"{fp}/transformer/layer_{i}"
        for attn in (
            "self_attn",
            "cross_attn_token_to_image",
            "cross_attn_token_to_cond",
            "cross_attn_image_to_cond",
            "cross_attn_image_to_token",
        ):
            m += _proj_attn(f"{t}.{attn}", f"{f}/{attn}")
        for norm in ("norm1", "norm2", "norm2_cond", "norm3", "norm4", "norm4_cond"):
            m += _ln(f"{t}.{norm}", f"{f}/{norm}")
        m += _linear(f"{t}.mlp.lin1", f"{f}/mlp/lin1")
        m += _linear(f"{t}.mlp.lin2", f"{f}/mlp/lin2")
    m += _proj_attn(
        f"{prefix}.transformer.final_attn_token_to_image",
        f"{fp}/transformer/final_attn_token_to_image",
    )
    m += _ln(f"{prefix}.transformer.norm_final_attn", f"{fp}/transformer/norm_final_attn")
    m += _convT(f"{prefix}.output_upscaling.0", f"{fp}/upscale_conv1")
    m += _ln(f"{prefix}.output_upscaling.1", f"{fp}/upscale_ln")
    m += _convT(f"{prefix}.output_upscaling.3", f"{fp}/upscale_conv2")
    m += _convT(f"{prefix}.embedding_encoder.0", f"{fp}/edge_encoder_conv1")
    m += _ln(f"{prefix}.embedding_encoder.1", f"{fp}/edge_encoder_ln")
    m += _convT(f"{prefix}.embedding_encoder.3", f"{fp}/edge_encoder_conv2")
    m += _convT(f"{prefix}.embedding_maskfeature.0", f"{fp}/maskfeature_conv1")
    m += _ln(f"{prefix}.embedding_maskfeature.1", f"{fp}/maskfeature_ln")
    m += _convT(f"{prefix}.embedding_maskfeature.3", f"{fp}/maskfeature_conv2")
    for i in range(4):
        for j in range(3):
            m += _linear(
                f"{prefix}.output_hypernetworks_mlps.{i}.layers.{j}",
                f"{fp}/hyper_mlp_{i}/layer_{j}",
            )
    for j in range(3):
        m += _linear(f"{prefix}.edge_mlp.layers.{j}", f"{fp}/edge_mlp/layer_{j}")
        m += _linear(
            f"{prefix}.iou_prediction_head.layers.{j}", f"{fp}/iou_prediction_head/layer_{j}"
        )
    return m


def clip_key_map(
    clip_cfg: AlphaClipConfig,
    torch_prefix: str = "",
    flax_prefix: str = "clip_model",
    visual_in_proj_renamed: bool = True,
    custom_clip_layout: bool = False,
) -> List[KeyMapEntry]:
    """Map for the Alpha-CLIP towers.

    `visual_in_proj_renamed`: the reference renames the visual tower's fused
    attention weights from `in_proj_weight` to `in_proj.weight` when building
    from an OpenAI archive (`alpha_clip_rw/model.py:864-874`); raw OpenAI
    state dicts use the underscore form.

    `custom_clip_layout`: CustomCLIP renames `visual` -> `image_encoder` and
    hangs the text stack under `text_encoder.` (`mapleAlphaCLIP.py:55-78,229-238`).
    """
    tp = torch_prefix
    vis_t = f"{tp}image_encoder" if custom_clip_layout else f"{tp}visual"
    txt_t = f"{tp}text_encoder" if custom_clip_layout else tp.rstrip(".")
    txt_t_prefix = f"{txt_t}." if txt_t else ""
    fp = flax_prefix

    m: List[KeyMapEntry] = []
    # vision tower
    vf = f"{fp}/image_encoder"
    m.append((f"{vis_t}.conv1.weight", f"{vf}/conv1/kernel", "conv_w"))
    m.append((f"{vis_t}.conv1_alpha.weight", f"{vf}/conv1_alpha/kernel", "conv_w"))
    m.append((f"{vis_t}.class_embedding", f"{vf}/class_embedding", "direct"))
    m.append((f"{vis_t}.positional_embedding", f"{vf}/positional_embedding", "direct"))
    m += _ln(f"{vis_t}.ln_pre", f"{vf}/ln_pre")
    m += _ln(f"{vis_t}.ln_post", f"{vf}/ln_post")
    m.append((f"{vis_t}.proj", f"{vf}/proj", "direct"))
    in_w = "in_proj.weight" if visual_in_proj_renamed else "in_proj_weight"
    in_b = "in_proj.bias" if visual_in_proj_renamed else "in_proj_bias"
    for i in range(clip_cfg.vision_layers):
        t = f"{vis_t}.transformer.resblocks.{i}"
        f = f"{vf}/resblock_{i}"
        m.append((f"{t}.attn.{in_w}", f"{f}/attn/in_proj/kernel", "linear_w"))
        m.append((f"{t}.attn.{in_b}", f"{f}/attn/in_proj/bias", "direct"))
        m += _linear(f"{t}.attn.out_proj", f"{f}/attn/out_proj")
        m += _ln(f"{t}.ln_1", f"{f}/ln_1") + _ln(f"{t}.ln_2", f"{f}/ln_2")
        m += _linear(f"{t}.mlp.c_fc", f"{f}/mlp/c_fc")
        m += _linear(f"{t}.mlp.c_proj", f"{f}/mlp/c_proj")
    # text tower (torch nn.MultiheadAttention keeps the underscore form)
    tf = f"{fp}/text_encoder"
    m.append((f"{txt_t_prefix}positional_embedding", f"{tf}/positional_embedding", "direct"))
    m += _ln(f"{txt_t_prefix}ln_final", f"{tf}/ln_final")
    m.append((f"{txt_t_prefix}text_projection", f"{tf}/text_projection", "direct"))
    for i in range(clip_cfg.transformer_layers):
        t = f"{txt_t_prefix}transformer.resblocks.{i}"
        f = f"{tf}/resblock_{i}"
        m.append((f"{t}.attn.in_proj_weight", f"{f}/attn/in_proj/kernel", "linear_w"))
        m.append((f"{t}.attn.in_proj_bias", f"{f}/attn/in_proj/bias", "direct"))
        m += _linear(f"{t}.attn.out_proj", f"{f}/attn/out_proj")
        m += _ln(f"{t}.ln_1", f"{f}/ln_1") + _ln(f"{t}.ln_2", f"{f}/ln_2")
        m += _linear(f"{t}.mlp.c_fc", f"{f}/mlp/c_fc")
        m += _linear(f"{t}.mlp.c_proj", f"{f}/mlp/c_proj")
    m.append((f"{tp}logit_scale", f"{fp}/logit_scale", "direct"))
    return m


def _prompt_learner_map(
    clip_cfg: AlphaClipConfig, torch_prefix: str = "prompt_learner", flax_prefix: str = "clip_model/prompt_learner"
) -> List[KeyMapEntry]:
    def j(suffix: str) -> str:  # "" prefix -> bare dassl per-model keys
        return f"{torch_prefix}.{suffix}" if torch_prefix else suffix

    m: List[KeyMapEntry] = [(j("ctx"), f"{flax_prefix}/ctx", "direct")]
    m += _linear(j("proj"), f"{flax_prefix}/proj")
    for i in range(clip_cfg.prompt_depth - 1):
        m.append(
            (
                j(f"compound_prompts_text.{i}"),
                f"{flax_prefix}/compound_prompts_text_{i}",
                "direct",
            )
        )
        m += _linear(
            j(f"compound_prompt_projections.{i}"),
            f"{flax_prefix}/compound_prompt_proj_{i}",
        )
    return m


def cascade_key_map(cfg: CascadeConfig) -> List[KeyMapEntry]:
    """Full map for the trained-cascade checkpoint (`model_epoch_best.pth`)."""
    m = _sam_encoder_map(cfg) + _mask_decoder_map(cfg)
    m.append(("no_mask_embed.weight", "no_mask_embed", "row0"))
    m.append(
        (
            "pe_layer.positional_encoding_gaussian_matrix",
            "pe_layer/positional_encoding_gaussian_matrix",
            "direct",
        )
    )
    m += _ln("sam_visual_proj.0", "visual_proj_ln1")
    m += _linear("sam_visual_proj.1", "visual_proj_dense")
    m += _ln("sam_visual_proj.2", "visual_proj_ln2")
    m += _ln("sam_text_proj.0", "text_proj_ln")
    m += _linear("sam_text_proj.1", "text_proj_dense")
    m += clip_key_map(
        cfg.clip, torch_prefix="clip_model.", custom_clip_layout=True
    )
    m += _prompt_learner_map(cfg.clip, torch_prefix="clip_model.prompt_learner")
    return m


def _set_path(tree: Dict, path: str, value: np.ndarray) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def convert_state_dict(
    sd: Dict[str, np.ndarray],
    key_map: Iterable[KeyMapEntry],
    strict: bool = False,
) -> Tuple[Dict, List[str], List[str]]:
    """Apply a key map. Returns (param tree, missing torch keys, used keys)."""
    tree: Dict = {}
    missing, used = [], []
    for tk, fp, kind in key_map:
        if tk not in sd:
            missing.append(tk)
            if strict:
                raise KeyError(f"checkpoint missing key {tk}")
            continue
        _set_path(tree, fp, _transform(kind, sd[tk]))
        used.append(tk)
    return tree, missing, used


def convert_cascade_checkpoint(sd: Dict[str, np.ndarray], cfg: CascadeConfig):
    return convert_state_dict(sd, cascade_key_map(cfg))


def convert_sam_backbone(sd: Dict[str, np.ndarray], cfg: CascadeConfig):
    """`sam_vit_h_4b8939.pth` loaded strict=False in the reference
    (`train_ovcos_maskdecoder_edge.py:296-299`): the ViT encoder fully
    matches; the stock decoder initialises the shared parts of the edge
    decoder (transformer minus cond attns, upscaling, hyper MLPs, iou head,
    tokens)."""
    m = _sam_encoder_map(cfg)
    # stock SAM decoder pieces that overlap the edge decoder by name
    stock = [
        e
        for e in _mask_decoder_map(cfg)
        if "cond" not in e[0] and "edge" not in e[0] and "embedding_" not in e[0]
    ]
    return convert_state_dict(sd, m + stock)


def convert_openai_clip(sd: Dict[str, np.ndarray], clip_cfg: AlphaClipConfig):
    """Raw OpenAI/Alpha-CLIP state dict -> (clip param tree, token_embedding).

    Performs the reference's surgeries (`alpha_clip_rw/model.py:864-881`):
    tolerate either in_proj naming; zero-init `conv1_alpha` if absent.
    """
    sd = dict(sd)
    if "visual.conv1_alpha.weight" not in sd:
        rgb = sd["visual.conv1.weight"]
        sd["visual.conv1_alpha.weight"] = np.zeros_like(rgb[:, 0:1])
    renamed = any("in_proj.weight" in k for k in sd)
    m = clip_key_map(
        clip_cfg, torch_prefix="", flax_prefix="clip_model",
        visual_in_proj_renamed=renamed, custom_clip_layout=False,
    )
    tree, missing, used = convert_state_dict(sd, m)
    token_embedding = sd.get("token_embedding.weight")
    return tree, token_embedding, missing


def convert_maple_prompt_learner(sd: Dict[str, np.ndarray], clip_cfg: AlphaClipConfig):
    """dassl MaPLe checkpoint -> prompt-learner subtree. Drops the
    token_prefix/suffix buffers like the reference
    (`models/sam_maskdecoder_edge.py:192-201`)."""
    sd = {
        k: v
        for k, v in sd.items()
        if not k.endswith(("token_prefix", "token_suffix", "token_prefix_test", "token_suffix_test"))
    }
    # dassl saves either a wrapped ("prompt_learner.ctx", ...) or a
    # per-model bare ("ctx", "proj.weight", ...) state dict
    prefix = "prompt_learner" if any(k.startswith("prompt_learner") for k in sd) else ""
    m = _prompt_learner_map(clip_cfg, torch_prefix=prefix)
    tree, missing, used = convert_state_dict(sd, m)
    if not used:
        raise ValueError(
            "MaPLe checkpoint matched no prompt-learner keys — the model "
            f"would run with random prompts. Checkpoint keys: {sorted(sd)[:6]}..."
        )
    return tree, missing, used


def _inverse_transform(kind: str, v: np.ndarray) -> np.ndarray:
    v = np.asarray(v)
    if kind == "linear_w":
        return np.ascontiguousarray(v.T)
    if kind in ("conv_w", "convT_w"):
        # both forward transforms are transpose(2,3,1,0); inverse (3,2,0,1)
        return np.ascontiguousarray(v.transpose(3, 2, 0, 1))
    if kind == "row0":
        return np.ascontiguousarray(v.reshape(1, -1))
    if kind == "direct":
        return np.ascontiguousarray(v).reshape(v.shape)
    raise ValueError(f"unknown transform kind {kind!r}")


def _get_path(tree: Dict, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def export_state_dict(
    tree: Dict,
    key_map: Iterable[KeyMapEntry],
    strict: bool = False,
) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Inverse of `convert_state_dict`: param tree -> torch-layout
    state dict (numpy, fp32). Returns (state dict, param paths missing from
    the tree). Every transform kind is exactly invertible, so
    convert(export(tree)) == tree bit-for-bit (tests/test_convert.py)."""
    sd: Dict[str, np.ndarray] = {}
    missing: List[str] = []
    for tk, fp, kind in key_map:
        try:
            v = _get_path(tree, fp)
        except (KeyError, TypeError):
            if strict:
                raise KeyError(f"param tree missing {fp}")
            missing.append(fp)
            continue
        sd[tk] = _inverse_transform(kind, np.asarray(v, dtype=np.float32))
    return sd, missing


def export_cascade_checkpoint(
    params: Dict, cfg: CascadeConfig, strict: bool = False
) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Flax cascade params -> the reference's `model.state_dict()` layout
    (save site: `/root/reference/train_ovcos_maskdecoder_edge.py` best/last
    `torch.save`), so checkpoints trained here can be loaded by the
    reference's eval/demo tooling. Accepts either the full variables dict
    ({'params': ...}) or the bare 'params' collection. `strict` fails on any
    mapped param missing from the tree instead of reporting it."""
    tree = params.get("params", params)
    return export_state_dict(tree, cascade_key_map(cfg), strict=strict)


def merge_into_params(params: Dict, tree: Dict) -> Dict:
    """Recursively overwrite `params` (the 'params' entry of a variables dict) with
    converted leaves, checking shapes."""
    import jax

    def merge(dst, src, path=""):
        for k, v in src.items():
            if isinstance(v, dict):
                if k not in dst:
                    raise KeyError(f"converted subtree {path}/{k} not in model params")
                merge(dst[k], v, f"{path}/{k}")
            else:
                if k not in dst:
                    raise KeyError(f"converted leaf {path}/{k} not in model params")
                expected = dst[k].shape
                if tuple(v.shape) != tuple(expected):
                    raise ValueError(
                        f"shape mismatch at {path}/{k}: ckpt {v.shape} vs model {expected}"
                    )
                dst[k] = v.astype(np.asarray(dst[k]).dtype) if hasattr(dst[k], "dtype") else v
        return dst

    # tree_map rebuilds the dict structure (fresh mutable containers, same
    # leaves) so the caller's tree is never mutated in place
    unfrozen = jax.tree.map(lambda x: x, params)
    merge(unfrozen["params"] if "params" in unfrozen else unfrozen, tree)
    return unfrozen

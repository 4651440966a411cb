"""Precompute frozen per-class text-feature banks.

Capability equivalent of the reference's prompt-bank trainer
(`/root/reference/cocotrainers/alphaCLIP.py:148-223`): for each class name,
embed N templated prompts with the PLAIN CLIP text encoder (no MaPLe
prompting), L2-normalise each, average, renormalise — producing the
(num_classes, 768) banks the cascade adds to its learned text features
(the shipped `{Train,Test}CamoPromptsTextFeaturesViTB-14-336.pth`).

Usage:
  python -m camouflaged_vlm_tpu.cli.precompute_text_bank \
      --clip-ckpt ViT-L-14-336px.pt --split test --out test_bank.npy
"""

from __future__ import annotations

import argparse

import numpy as np
import jax
import jax.numpy as jnp

from ..data.ovcamo import TRAIN_CLASS_NAMES, TEST_CLASS_NAMES
from ..data.templates import TEMPLATE_SETS
from ..models.clip import AlphaClipConfig, tokenize
from ..models.clip import model as clip_model
from ..io import load_openai_clip_state_dict
from ..io.convert import convert_openai_clip
from ..utils.logging import log


def _make_encoder(clip_cfg: AlphaClipConfig, text_params: dict, token_embedding):
    @jax.jit
    def encode(prompt_embeds, eot):
        # no deep prompts: plain CLIP encode_text semantics
        return clip_model.text(clip_cfg, text_params, prompt_embeds, eot, [])

    def encode_prompts(prompts):
        # Pad the prompt count up to a power-of-two bucket so varying
        # per-class CuPL list lengths hit a handful of compiled shapes, not
        # one compile per distinct count; the padded
        # rows are sliced off before the caller's mean.
        n = len(prompts)
        if n == 0:
            raise ValueError(
                "empty prompt list (a CuPL JSON class entry with no prompts?) "
                "— every class needs at least one prompt"
            )
        bucket = 1
        while bucket < n:
            bucket *= 2
        padded = list(prompts) + [prompts[0]] * (bucket - n)
        tokens = tokenize(padded, clip_cfg.context_length)
        embeds = jnp.asarray(token_embedding[tokens])
        eot = jnp.asarray(tokens.argmax(axis=-1).astype(np.int32))
        feats = np.asarray(encode(embeds, eot), np.float32)[:n]
        return feats / np.linalg.norm(feats, axis=-1, keepdims=True)

    return encode_prompts


def encode_text_features(
    clip_cfg: AlphaClipConfig,
    text_params: dict,
    token_embedding: np.ndarray,
    classnames,
    templates,
    encode_prompts=None,
) -> np.ndarray:
    """(num_classes, embed_dim) normalised mean template embeddings
    (the reference's per-class ensembling loop, `alphaCLIP.py:148-163`)."""
    if encode_prompts is None:
        encode_prompts = _make_encoder(clip_cfg, text_params, token_embedding)
    out = []
    for name in classnames:
        feats = encode_prompts([t.format(name) for t in templates])
        mean = feats.mean(axis=0)
        out.append(mean / np.linalg.norm(mean))
    return np.stack(out)


def encode_gpt_bank(
    clip_cfg: AlphaClipConfig,
    text_params: dict,
    token_embedding: np.ndarray,
    classnames,
    gpt_json_path: str,
    encode_prompts=None,
) -> np.ndarray:
    """CuPL-GPT per-class prompt bank (`alphaCLIP.py:195-223`): each class
    has its own prompt list in the JSON (keys matched lowercase, underscores
    as spaces); per-class mean of normalised features, rows renormalised at
    the end. NOTE: the reference's CuPL JSONs are stripped upstream
    (`/root/reference/.MISSING_LARGE_BLOBS`) — only the loading path is
    portable; any CuPL-format JSON works here."""
    import json

    with open(gpt_json_path) as f:
        gpt = json.load(f)
    gpt = {k.lower().replace("_", " "): v for k, v in gpt.items()}
    # fail fast on missing/misspelled class keys BEFORE minutes of encoding
    missing = [n for n in classnames if n.lower().replace("_", " ") not in gpt]
    if missing:
        raise KeyError(
            f"CuPL JSON {gpt_json_path} lacks prompts for {len(missing)} "
            f"classes (keys are matched lowercase with underscores as "
            f"spaces): {missing[:5]}{'...' if len(missing) > 5 else ''}"
        )
    if encode_prompts is None:
        encode_prompts = _make_encoder(clip_cfg, text_params, token_embedding)
    out = []
    for name in classnames:
        feats = encode_prompts(gpt[name.lower().replace("_", " ")])
        out.append(feats.mean(axis=0))
    bank = np.stack(out)
    return bank / np.linalg.norm(bank, axis=-1, keepdims=True)


def combine_banks(banks) -> np.ndarray:
    """The reference's cross-mode ensembling: each new bank is averaged
    pairwise with the accumulated one, then renormalised
    (`alphaCLIP.py:190-196,216-222,236-242`)."""
    acc = banks[0]
    for b in banks[1:]:
        acc = np.stack([acc, b]).mean(axis=0)
        acc = acc / np.linalg.norm(acc, axis=-1, keepdims=True)
    return acc


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--clip-ckpt", required=True)
    p.add_argument("--split", default="test", choices=["train", "test"])
    p.add_argument(
        "--templates", default="camoprompts",
        help="comma-separated subset of %s — multiple modes are ensembled "
        "with the reference's pairwise mean+renorm chain" % sorted(TEMPLATE_SETS),
    )
    p.add_argument(
        "--gpt-json", default=None,
        help="CuPL-GPT per-class prompts JSON (reference USE_GPT mode; the "
        "upstream JSONs are stripped — supply your own)",
    )
    p.add_argument("--classnames", default=None, help="comma-separated override")
    p.add_argument("--out", required=True, help=".npy output path")
    args = p.parse_args()
    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    clip_cfg = AlphaClipConfig.vit_l_14_336()
    sd = load_openai_clip_state_dict(args.clip_ckpt)
    tree, token_embedding, missing = convert_openai_clip(sd, clip_cfg)
    assert token_embedding is not None, "checkpoint lacks token_embedding.weight"
    text_params = tree["clip_model"]["text_encoder"]

    if args.classnames:
        names = args.classnames.split(",")
    else:
        names = TRAIN_CLASS_NAMES if args.split == "train" else TEST_CLASS_NAMES

    encode_prompts = _make_encoder(clip_cfg, text_params, token_embedding)
    modes = args.templates.split(",")
    for mode in modes:
        if mode not in TEMPLATE_SETS:
            raise SystemExit(f"unknown template set {mode!r}; have {sorted(TEMPLATE_SETS)}")
    # The pairwise mean+renorm chain is ORDER-SENSITIVE; the reference's
    # fixed mode order is imagenet80 -> camoprompts -> CuPL-GPT ->
    # attributes (`alphaCLIP.py:131-242` — each `if use_*` block folds into
    # the accumulator in that sequence), so the chain follows that order
    # regardless of how --templates is spelled.
    ref_order = ["imagenet80", "camoprompts", "__gpt__", "attributes"]
    dropped = [m for m in modes if m not in ref_order]
    if dropped:
        # TEMPLATE_SETS is the extension point; a new set also needs a slot
        # in the reference ensembling order above — fail loudly rather than
        # silently writing a bank that excludes it.
        raise SystemExit(
            f"template set(s) {dropped} have no position in the reference "
            f"ensembling order {ref_order}; add them to ref_order in "
            "cli/precompute_text_bank.py"
        )
    modes = [m for m in ref_order if m in modes or (m == "__gpt__" and args.gpt_json)]
    banks = []
    for mode in modes:
        if mode == "__gpt__":
            banks.append(
                encode_gpt_bank(
                    clip_cfg, text_params, token_embedding, names, args.gpt_json,
                    encode_prompts=encode_prompts,
                )
            )
            log("[bank] encoded CuPL-GPT prompts")
        else:
            banks.append(
                encode_text_features(
                    clip_cfg, text_params, token_embedding, names,
                    TEMPLATE_SETS[mode], encode_prompts=encode_prompts,
                )
            )
            log(f"[bank] encoded {mode} ({len(TEMPLATE_SETS[mode])} templates)")
    bank = combine_banks(banks)
    np.save(args.out, bank)
    log(f"wrote {bank.shape} bank to {args.out}")


if __name__ == "__main__":
    main()

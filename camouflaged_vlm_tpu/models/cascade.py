"""The OVCOS cascade: prompt-tuned SAM + Alpha-CLIP classification.

Re-design of the registered `'sam_maskdecoder_edge'` model
(`/root/reference/models/sam_maskdecoder_edge.py:112-473`) as one fused,
jittable program:

  stage 1 (`infer_test`, reference :331-357):
    SAM ViT-H encoder -> CLIP forward with all-ones alpha -> project CLIP
    image+text features to two 256-d sparse prompt embeddings -> edge mask
    decoder -> bilinear upsample of mask logits to the input resolution.

  stage 2 (reference eval loop, `/root/reference/test_ovcos_maskdecoder_edge.py:111-114`):
    alpha = bilinear(sigmoid(stage-1 mask), 336) -> CLIP forward with the
    predicted alpha -> class logits.

`infer_cascade` runs both stages in a single XLA program — the mask never
leaves device memory between stages, unlike the reference which round-trips through
the eval loop. Class-split data (prompt bank prefix/suffix/EOT indices and
the frozen text-feature bank) are inputs, so the same compiled program serves
train/test splits of the same class count.

`OVCOSCascade` holds only the config. `init(key)` returns the variables dict
`{"params": ...}`; every other method is a pure function whose first
argument is that dict (optionally with the inference-only "relcache" entry,
see `factory.attach_rel_cache`).
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from . import layers as L
from . import mask_decoder, position_embedding, sam_encoder
from .clip import AlphaClipConfig
from .clip import custom_clip
from .mask_decoder import MaskDecoderConfig
from .position_embedding import random_position_embedding
from .sam_encoder import SamEncoderConfig
from .two_way_transformer import TwoWayTransformerConfig
from ..ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    inp_size: int = 1024
    clip_size: int = 336
    prompt_embed_dim: int = 256
    encoder: SamEncoderConfig = dataclasses.field(default_factory=SamEncoderConfig)
    decoder: MaskDecoderConfig = dataclasses.field(default_factory=MaskDecoderConfig)
    clip: AlphaClipConfig = dataclasses.field(default_factory=AlphaClipConfig)

    @property
    def embedding_size(self) -> int:
        return self.inp_size // self.encoder.patch_size

    @classmethod
    def full(cls, dtype=jnp.float32) -> "CascadeConfig":
        """SAM ViT-H + Alpha-CLIP ViT-L/14@336 (the reference's configuration)."""
        return cls(
            encoder=SamEncoderConfig.vit_h(dtype=dtype),
            decoder=MaskDecoderConfig(
                transformer=TwoWayTransformerConfig(dtype=dtype), dtype=dtype
            ),
            clip=AlphaClipConfig.vit_l_14_336(dtype=dtype),
        )

    @classmethod
    def tiny(cls, dtype=jnp.float32) -> "CascadeConfig":
        """Small config for tests and multi-chip dry runs."""
        enc = SamEncoderConfig.tiny(dtype=dtype)
        dec_dim = 32
        return cls(
            inp_size=enc.img_size,
            clip_size=28,
            prompt_embed_dim=dec_dim,
            encoder=enc,
            decoder=MaskDecoderConfig(
                transformer_dim=dec_dim,
                transformer=TwoWayTransformerConfig(
                    embedding_dim=dec_dim, num_heads=4, mlp_dim=64, dtype=dtype
                ),
                dtype=dtype,
            ),
            clip=AlphaClipConfig.tiny(dtype=dtype),
        )


@dataclasses.dataclass(frozen=True)
class OVCOSCascade:
    cfg: CascadeConfig

    def init(self, key) -> dict:
        """Random-weight variables {"params": ...} (real runs load a
        checkpoint into this tree)."""
        cfg = self.cfg
        assert cfg.decoder.transformer_dim == cfg.prompt_embed_dim
        k = L.Keys(key)
        C = cfg.prompt_embed_dim
        E = cfg.clip.embed_dim
        return {"params": {
            "image_encoder": sam_encoder.init(cfg.encoder, k()),
            "mask_decoder": mask_decoder.init(cfg.decoder, k()),
            "pe_layer": position_embedding.init(C // 2, k()),
            "no_mask_embed": L.normal(k(), (C,), 1.0),
            "clip_model": custom_clip.init(cfg.clip, k()),
            # sam_visual_proj: LN -> Linear(768->256) -> LN   (reference :166-170)
            "visual_proj_ln1": L.ln_init(E),
            "visual_proj_dense": L.dense_init(k(), E, C),
            "visual_proj_ln2": L.ln_init(C),
            # sam_text_proj: LN -> Linear(768->256)            (reference :172-175)
            "text_proj_ln": L.ln_init(E),
            "text_proj_dense": L.dense_init(k(), E, C),
        }}

    # ----- pieces -----

    def encode_image(self, variables, inp):
        """SAM encoder -> (features NHWC, global-block tokens)."""
        cache = variables.get("relcache", {}).get("image_encoder")
        return sam_encoder.apply(
            self.cfg.encoder, variables["params"]["image_encoder"], inp,
            interm=True, relcache=cache,
        )

    def classify(self, variables, clip_image, clip_mask, text_features):
        return custom_clip.classify(
            self.cfg.clip, variables["params"]["clip_model"],
            clip_image, clip_mask, text_features,
        )

    def _sparse_embeddings(self, p, image_feat, text_feat):
        """(B,1,768) x2 -> (B,2,256) CLIP-conditioned sparse prompts."""
        dt = self.cfg.decoder.dtype
        v = L.ln(p["visual_proj_ln1"], image_feat, 1e-5)
        v = L.ln(p["visual_proj_ln2"], L.dense(p["visual_proj_dense"], v, dt), 1e-5)
        t = L.dense(p["text_proj_dense"], L.ln(p["text_proj_ln"], text_feat, 1e-5), dt)
        return jnp.concatenate([v, t], axis=1)

    def decode(self, variables, features, interm, image_feat, text_feat):
        """Mask decoder on encoder features + CLIP features ->
        (masks (B,H,W,1) logits, edges (B,H,W,1), iou (B,1))."""
        cfg = self.cfg
        p = variables["params"]
        sparse = self._sparse_embeddings(p, image_feat, text_feat)
        B = features.shape[0]
        g = cfg.embedding_size
        dense = jnp.broadcast_to(
            p["no_mask_embed"][None, None, None, :],
            (B, g, g, cfg.prompt_embed_dim),
        ).astype(features.dtype)
        image_pe = random_position_embedding(
            p["pe_layer"]["positional_encoding_gaussian_matrix"], g
        )
        masks, edges, iou = mask_decoder.apply(
            cfg.decoder, p["mask_decoder"], features, image_pe, sparse, dense,
            multimask_output=False, interm_embeddings=interm,
        )
        # (B, 1, H/4, W/4) logits -> NHWC -> full resolution
        masks = resize_bilinear(
            masks.transpose(0, 2, 3, 1), cfg.inp_size, cfg.inp_size
        )
        edges = resize_bilinear(
            edges.transpose(0, 2, 3, 1), cfg.inp_size, cfg.inp_size
        )
        return masks, edges, iou  # masks/edges: (B, H, W, 1)

    # ----- entry points -----

    def clip_forward(self, variables, clip_image, clip_mask, prefix, suffix,
                     eot_indices, bank_features):
        """The CustomCLIP pass alone (MaPLe prompt training): (image
        features, picked text features, pred, logits)."""
        return custom_clip.apply(
            self.cfg.clip, variables["params"]["clip_model"],
            clip_image, clip_mask, prefix, suffix, eot_indices, bank_features,
        )

    def stage1(
        self, variables, inp, clip_image, clip_mask, prefix, suffix,
        eot_indices, bank_features,
    ):
        """Segmentation pass. inp: (B,1024,1024,3); clip_*: (B,336,336,C).

        Returns (mask_logits (B,H,W,1), edges (B,H,W,1), iou (B,1),
        clip pred ids (B,), clip logits (B,N)).
        """
        features, interm = self.encode_image(variables, inp)
        image_feat, text_feat, pred, score = self.clip_forward(
            variables, clip_image, clip_mask, prefix, suffix, eot_indices,
            bank_features,
        )
        masks, edges, iou = self.decode(
            variables, features, interm, image_feat, text_feat
        )
        return masks, edges, iou, pred, score

    def __call__(self, variables, inp, clip_image, clip_mask, prefix, suffix,
                 eot_indices, bank_features):
        """Training forward: mask + edge predictions at full resolution."""
        masks, edges, _, _, _ = self.stage1(
            variables, inp, clip_image, clip_mask, prefix, suffix,
            eot_indices, bank_features,
        )
        return masks, edges

    def infer_test(self, variables, inp, clip_image, clip_mask, prefix, suffix,
                   eot_indices, bank_features):
        """Reference `infer_test` equivalent: stage-1 mask logits only."""
        masks, _, _, _, _ = self.stage1(
            variables, inp, clip_image, clip_mask, prefix, suffix,
            eot_indices, bank_features,
        )
        return masks

    def infer_cascade(self, variables, inp, clip_image, clip_mask, prefix,
                      suffix, eot_indices, bank_features):
        """Full fused pipeline: stage-1 mask + stage-2 open-vocab class.

        Returns (mask_probs (B,H,W,1), pred_class (B,), class_logits (B,N)).
        """
        text_features = self.encode_class_text_features(
            variables, prefix, suffix, eot_indices, bank_features
        )
        return self.infer_cascade_with_text(
            variables, inp, clip_image, clip_mask, text_features
        )

    def encode_class_text_features(self, variables, prefix, suffix, eot_indices,
                                   bank_features):
        """Per-class-split text features (image-independent; hoist at eval)."""
        return custom_clip.encode_class_text_features(
            self.cfg.clip, variables["params"]["clip_model"],
            prefix, suffix, eot_indices, bank_features,
        )

    def forward_with_text(self, variables, inp, clip_image, clip_mask, text_features):
        """Training forward with PRECOMPUTED per-class text features.

        Exact under the production freeze rule: the text tower and prompt
        learner are frozen during cascade training (the reference freezes
        the whole CLIP, `train_ovcos_maskdecoder_edge.py:301-303` +
        `load_mapleAlphaCLIP`), so the class-text features are constants —
        encoding them once per run instead of once per microbatch saves the
        61-prompt text transformer from every step (the reference re-runs
        it every step). Gradient equality with the non-hoisted forward is
        pinned in tests/test_train.py."""
        features, interm = self.encode_image(variables, inp)
        image_feat, text_feat, _, _ = self.classify(
            variables, clip_image, clip_mask, text_features
        )
        masks, edges, _ = self.decode(
            variables, features, interm, image_feat, text_feat
        )
        return masks, edges

    def infer_cascade_with_text(self, variables, inp, clip_image, clip_mask,
                                text_features):
        """Fused pipeline with precomputed per-class text features.

        At inference the text tower is class-split-constant, so callers encode
        it once (encode_class_text_features) instead of per batch — the
        reference recomputes the full text transformer every image.
        """
        cfg = self.cfg
        features, interm = self.encode_image(variables, inp)
        image_feat, text_feat, _, _ = self.classify(
            variables, clip_image, clip_mask, text_features
        )
        masks, _, _ = self.decode(
            variables, features, interm, image_feat, text_feat
        )
        probs = jax.nn.sigmoid(masks.astype(jnp.float32))
        alpha = resize_bilinear(probs, cfg.clip_size, cfg.clip_size)
        _, _, pred, score = self.classify(variables, clip_image, alpha, text_features)
        return probs, pred, score

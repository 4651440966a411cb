"""SAM image encoder (ViTDet-style ViT) with the EVP prompt generator.

Re-design of `/root/reference/models/mmseg/models/sam/image_encoder.py`
(ImageEncoderViT :25-155, PromptGenerator :218-353, Block :383-446,
Attention :449-504) as plain functions over a parameter dict
(`init(cfg, key)` / `apply(cfg, params, x, ...)`):

  * NHWC layout end to end — patch embed is a 16x16/stride-16 conv computed
    as one matmul on rearranged patches; "LayerNorm2d" collapses to a
    last-axis norm.
  * Windowed attention (14x14) runs as one batched attention over all
    windows — no per-window loop — on a pad-free carry
    (ops/compact_window.py).
  * Global attention (4 blocks at 64x64 = 4096 tokens) uses the decomposed
    rel-pos attention on the packed qkv (ops/attention.py).
  * Compute dtype is configurable (bf16 for speed); layer norms and softmax
    stay fp32.
  * The EVP prompt stream (FFT high-pass handcrafted features + patch
    embedding features -> per-block tiny MLPs -> shared up-projection) is
    computed once per image; per-block prompts are generated inside the
    block loop.

Trainable-at-finetune params (mirroring the reference freeze rule,
`/root/reference/train_ovcos_maskdecoder_edge.py:301-303`): only
`prompt_generator/*`; everything else is frozen SAM weights.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from . import layers as L
from ..ops.aug_attention import augment_qk, attention_xla
from ..ops.attention import (
    make_rel_scatter,
    qkv_packed_edge,
    qkv_packed_global,
    qkv_packed_windows,
    qkv_packed_windows_s,
    qkv_relpos_windows,
    xla_attention_relpos,
)
from ..ops.compact_window import (
    REL_LANES,
    CompactGeometry,
    compact_partition,
    compact_unpartition,
    edge_consts,
    edge_rel_fast,
    edge_rel_lpad,
)
from ..ops.fft_prompt import fft_highpass
from ..ops.linear import (
    ln_linear_act_bt,
    ln_mask_linear_bt,
    ln_mlp_residual_bt,
    proj_from_heads,
    proj_rows,
)
from ..ops.rel_pos import attention_with_decomposed_rel_pos, get_rel_pos_table
from ..ops.window import (
    window_partition_seq,
    window_unpartition_seq,
    window_valid_mask,
)


@dataclasses.dataclass(frozen=True)
class SamEncoderConfig:
    img_size: int = 1024
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    use_rel_pos: bool = True
    # EVP prompt generator
    prompt_scale_factor: int = 32  # embed_dim // 32 = handcrafted dim
    freq_rate: float = 0.25
    # numerics
    dtype: jnp.dtype = jnp.float32
    # attention formulation:
    #   'flash'     — fused block on the packed qkv: LN1 ahead of the qkv
    #                 projection, rel-pos bias as `rel @ sel`, compact window
    #                 layout, residual in the projection epilogue (default)
    #   'aug_xla'   — rel-pos as augmented q/k features, plain attention
    #   'reference' — dense bias materialisation (parity/debug path)
    attn_impl: str = "flash"
    # tanh-approximated GELU in the ViT MLPs (max deviation ~1e-3 relative,
    # below bf16 rounding). Its speed against the erf GELU is not measured
    # on the H100. Set False (with dtype=float32, attn_impl='reference') for
    # bit-faithful parity runs.
    gelu_approximate: bool = True
    # rematerialise block activations in the backward pass (jax.checkpoint):
    # costs ~1/3 extra forward FLOPs during training; no effect on inference.
    remat: bool = False

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def prompt_dim(self) -> int:
        return self.embed_dim // self.prompt_scale_factor

    @classmethod
    def vit_h(cls, **overrides) -> "SamEncoderConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "SamEncoderConfig":
        """Small config for tests / dry runs."""
        defaults = dict(
            img_size=64, patch_size=16, embed_dim=64, depth=4, num_heads=4,
            out_chans=32, window_size=2, global_attn_indexes=(1, 3),
            prompt_scale_factor=8,
        )
        defaults.update(overrides)
        return cls(**defaults)


def fused_attention_enabled(attn_impl: str, use_rel_pos: bool, num_heads: int) -> bool:
    """Whether blocks take the fused data path (LN1 + qkv, packed
    attention, projection + residual; compact window layout)."""
    return attn_impl == "flash" and use_rel_pos and num_heads % 8 == 0


# ----------------------------------------------------------------------------
# rel-pos factor builders
# ----------------------------------------------------------------------------


def rel_and_scatter(q_heads, rel_pos_h, rel_pos_w, H, W):
    """Rank-structured rel-pos bias factors.

    q_heads: (..., H, W, heads, hd) UNSCALED queries (reference semantics,
    `image_encoder.py:589-625`). Returns (rel (..., H, W, heads, H+W) =
    [rel_h | rel_w] per query, sel (H+W, H*W) scatter constant) such that
    bias[q, k] = (rel @ sel)[q, k]."""
    Rh = get_rel_pos_table(H, H, rel_pos_h)  # (H, H, hd)
    Rw = get_rel_pos_table(W, W, rel_pos_w)  # (W, W, hd)
    rel_h = jnp.einsum("...hwnc,hkc->...hwnk", q_heads, Rh.astype(q_heads.dtype))
    rel_w = jnp.einsum("...hwnc,wkc->...hwnk", q_heads, Rw.astype(q_heads.dtype))
    rel = jnp.concatenate([rel_h, rel_w], axis=-1)
    return rel, make_rel_scatter(H, W, dtype=q_heads.dtype)


def make_rcomb(H, W, rel_pos_h, rel_pos_w, dt, lanes=32):
    """Combined per-(qh, qw) rel-pos table (H, W, hd, lanes): lane j < H holds
    Rh[qh, j], lanes H..H+W-1 hold Rw[qw, j-H], the rest zero — one einsum
    with it emits the packed [rel_h | rel_w | 0] layout. Windowed callers use
    lanes=32; the global blocks pass lanes=H+W."""
    assert H + W <= lanes, (H, W, lanes)
    Rh = get_rel_pos_table(H, H, rel_pos_h).astype(dt)  # (H, kh, hd)
    Rw = get_rel_pos_table(W, W, rel_pos_w).astype(dt)  # (W, kw, hd)
    hd = Rh.shape[-1]
    parts = [
        jnp.broadcast_to(
            jnp.transpose(Rh, (0, 2, 1))[:, None], (H, W, hd, H)
        ),
        jnp.broadcast_to(
            jnp.transpose(Rw, (0, 2, 1))[None, :], (H, W, hd, W)
        ),
    ]
    if lanes > H + W:
        parts.append(jnp.zeros((H, W, hd, lanes - H - W), dt))
    return jnp.concatenate(parts, axis=-1)  # (H, W, hd, lanes)


def rel_smajor_global(q_heads, rel_pos_h, rel_pos_w, H, W, rcg=None):
    """Position-major packed rel factors for the global blocks.

    q_heads: (B, H, W, heads, hd) UNSCALED queries. Returns
    rel_s (H*W, B, heads, H+W) with bias[q, k] = (rel_s[q] @ sel)[k] — the
    SAME factors as `rel_and_scatter`, in the batched matmul's natural
    layout (contraction batch = query position), which `qkv_packed_global`
    consumes. `rcg` takes the precomputed combined table (see
    `precompute_rel_tables` — it is param-derived, so inference hoists its
    construction out of the per-batch program)."""
    B = q_heads.shape[0]
    heads = q_heads.shape[3]
    if rcg is None:
        rcg = make_rcomb(
            H, W, rel_pos_h, rel_pos_w, q_heads.dtype, lanes=H + W
        )  # (H, W, hd, H+W)
    return jnp.einsum(
        "bhwnc,hwcj->hwbnj", q_heads, rcg.astype(q_heads.dtype)
    ).reshape(H * W, B, heads, H + W)


def rel_packed32(q_heads, rel_pos_h, rel_pos_w, H, W):
    """`rel_and_scatter` as ONE einsum with the 32-lane pad built in: the
    per-(qh, qw) tables are pre-combined into `Rcomb[(qh, qw), c, j]`
    (j = [kh | kw | 0-pad] of width 32), so the output is already the packed
    layout.

    Returns (rel (..., H, W, heads, 32), sel32 (32, H*W))."""
    rel = jnp.einsum(
        "...hwnc,hwcj->...hwnj",
        q_heads,
        make_rcomb(H, W, rel_pos_h, rel_pos_w, q_heads.dtype),
    )
    sel = make_rel_scatter(H, W, dtype=q_heads.dtype)
    sel32 = jnp.pad(sel, ((0, 32 - H - W), (0, 0)))
    return rel, sel32


def make_rblk(win, rel_pos_h, rel_pos_w, hd, dt, head_group=8):
    """Block-diagonal kron(I_hg, Rcomb[s]) table (S, hg*hd, hg*32) for the
    windowed s-major rel einsum. Param-derived only, so inference
    precomputes it once (`precompute_rel_tables`)."""
    S = win * win
    rc = make_rcomb(win, win, rel_pos_h, rel_pos_w, dt).reshape(S, hd, 32)
    eye = jnp.eye(head_group, dtype=dt)
    return jax.vmap(lambda r: jnp.kron(eye, r))(rc)  # (S, ghd, hg*32)


def rel_smajor_windows(qkv_flat, rel_pos_h, rel_pos_w, win, heads, hd,
                       head_group=8, rblk=None):
    """Position-major packed rel for the windowed blocks.

    qkv_flat: (BW, S, 3*heads*hd) raw qkv projection (UNSCALED q in the
    leading lanes). Returns (rel_s (S, BW, heads*32), sel32 (32, S)) — the
    same [rel_h | rel_w | 0] per-head packing as `rel_packed32`, in the rel
    einsum's natural batched-matmul layout (contraction batch = window
    position), consumed by `qkv_packed_windows_s`. With `rblk` (the
    precomputed block-diagonal kron(I_hg, Rcomb[s]) table) ONE einsum over
    head groups emits all heads' lanes already packed; without it (training,
    where the rel params update) each head contracts against the small
    combined table."""
    S = win * win
    dim = heads * hd
    if heads % head_group != 0:
        head_group = heads
    ghd = head_group * hd
    n_g = dim // ghd
    if rblk is None:
        rc = make_rcomb(win, win, rel_pos_h, rel_pos_w, qkv_flat.dtype)
        rc = rc.reshape(S, hd, 32)
        q = qkv_flat[:, :, :dim].reshape(-1, S, heads, hd)
        rel_s = jnp.einsum("wshr,src->swhc", q, rc).reshape(
            S, -1, heads * 32
        )
    else:
        q2 = qkv_flat[:, :, :dim].reshape(-1, S, n_g, ghd)
        rel_s = jnp.einsum(
            "wsgc,scj->swgj", q2, rblk.astype(qkv_flat.dtype)
        ).reshape(S, -1, heads * 32)
    sel = make_rel_scatter(win, win, dtype=qkv_flat.dtype)
    sel32 = jnp.pad(sel, ((0, 32 - 2 * win), (0, 0)))
    return rel_s, sel32


def make_redge_tables(win, rel_pos_h, rel_pos_w, hd, dt, geom, head_group=8):
    """Hoisted kron tables for the edge windows, one per edge group:
    (R_u, hg*hd, hg*REL_LANES). Query-position rows follow the uniform edge
    layout (row-major over the group's (nr, nc) real grid; corner rows
    beyond g.rows are zero — their outputs are discarded). Consumed by
    `ops.compact_window.edge_rel_fast`."""
    rc = make_rcomb(win, win, rel_pos_h, rel_pos_w, dt)  # (win, win, hd, 32)
    eye = jnp.eye(head_group, dtype=dt)
    R = geom.R_u
    tabs = []
    for g in geom.edge_groups:
        rcg = rc[: g.nr, : g.nc].reshape(g.rows, hd, REL_LANES)
        t = jax.vmap(lambda r: jnp.kron(eye, r))(rcg)
        if g.rows < R:
            t = jnp.pad(t, ((0, R - g.rows), (0, 0), (0, 0)))
        tabs.append(t)
    return tabs


def precompute_rel_tables(cfg, encoder_params):
    """Param-derived rel-pos tables for inference (the 'relcache' entry).

    The combined rel tables (`make_rcomb` / `make_rblk`) depend ONLY on the
    rel_pos_{h,w} params. For fixed weights (eval/bench/serve) build them
    ONCE here and pass `{'relcache': {'image_encoder': <this>}}` beside
    'params' to the cascade; the attention picks them up and skips the
    in-program build. Training keeps the in-program path (the tables must
    track the updating rel_pos params).

    encoder_params: the ENCODER's param subtree (params['params']
    ['image_encoder']). Returns {'block_i': {'attn': {...}}}.
    """
    dt = cfg.dtype
    hd = cfg.embed_dim // cfg.num_heads
    win = cfg.window_size
    # must match rel_smajor_windows' head grouping exactly
    hg = 8 if cfg.num_heads % 8 == 0 else cfg.num_heads
    out = {}
    for i in range(cfg.depth):
        bp = encoder_params.get(f"block_{i}")
        if bp is None or "attn" not in bp or "rel_pos_h" not in bp["attn"]:
            continue
        rh = jnp.asarray(bp["attn"]["rel_pos_h"])
        rw = jnp.asarray(bp["attn"]["rel_pos_w"])
        if win > 0 and i not in cfg.global_attn_indexes:
            entry = {
                "rblk": make_rblk(win, rh, rw, hd, dt, head_group=hg),
            }
            g = CompactGeometry(cfg.grid, cfg.grid, win)
            if g.supported() and g.has_edge:
                for gi, tab in enumerate(
                    make_redge_tables(win, rh, rw, hd, dt, g, head_group=hg)
                ):
                    entry[f"redge_{gi}"] = tab
            out[f"block_{i}"] = {"attn": entry}
        else:
            g = cfg.grid
            out[f"block_{i}"] = {"attn": {
                "rcg": make_rcomb(g, g, rh, rw, dt, lanes=2 * g),
            }}
    return out


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------


def _init_block(cfg: SamEncoderConfig, key, attn_size: Tuple[int, int]) -> dict:
    k = L.Keys(key)
    D = cfg.embed_dim
    hd = D // cfg.num_heads
    hidden = int(D * cfg.mlp_ratio)
    attn = {"qkv": L.dense_init(k(), D, 3 * D), "proj": L.dense_init(k(), D, D)}
    if cfg.use_rel_pos:
        attn["rel_pos_h"] = jnp.zeros((2 * attn_size[0] - 1, hd), jnp.float32)
        attn["rel_pos_w"] = jnp.zeros((2 * attn_size[1] - 1, hd), jnp.float32)
    return {
        "norm1": L.ln_init(D),
        "attn": attn,
        "norm2": L.ln_init(D),
        "mlp": {"lin1": L.dense_init(k(), D, hidden),
                "lin2": L.dense_init(k(), hidden, D)},
    }


def init(cfg: SamEncoderConfig, key) -> dict:
    """Encoder parameter tree (random weights)."""
    k = L.Keys(key)
    D, P, p = cfg.embed_dim, cfg.prompt_dim, cfg.patch_size
    params = {
        "patch_embed": L.conv_init(k(), p, p, cfg.in_chans, D, bias=True),
        "prompt_generator": {
            "embedding_generator": L.dense_init(k(), D, P),
            "handcrafted_embed": L.conv_init(k(), p, p, cfg.in_chans, P, bias=True),
            "shared_mlp": L.dense_init(k(), P, D),
            **{f"lightweight_mlp_{i}": L.dense_init(k(), P, P)
               for i in range(cfg.depth)},
        },
        "pos_embed": jnp.zeros((1, cfg.grid, cfg.grid, D), jnp.float32),
        "neck_conv1": L.conv_init(k(), 1, 1, D, cfg.out_chans, bias=False),
        "neck_ln1": L.ln_init(cfg.out_chans),
        "neck_conv2": L.conv_init(k(), 3, 3, cfg.out_chans, cfg.out_chans, bias=False),
        "neck_ln2": L.ln_init(cfg.out_chans),
    }
    for i in range(cfg.depth):
        windowed = cfg.window_size > 0 and i not in cfg.global_attn_indexes
        size = (cfg.window_size,) * 2 if windowed else (cfg.grid, cfg.grid)
        params[f"block_{i}"] = _init_block(cfg, k(), size)
    return params


# ----------------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------------


def patch_embed(p: dict, x: jnp.ndarray, patch: int, dtype) -> jnp.ndarray:
    """Patch-embed conv (kernel == stride, VALID) as one matmul on
    rearranged patches; param tree of a (p, p, C, D) conv. Equivalent of the
    reference `PatchEmbed`/`PatchEmbed2` (`image_encoder.py:628-657,355-381`)."""
    B, H, W, C = x.shape
    features = p["kernel"].shape[-1]
    gh, gw = H // patch, W // patch
    x2 = (
        x.astype(dtype)
        .reshape(B, gh, patch, gw, patch, C)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(B * gh * gw, patch * patch * C)
    )
    w2 = p["kernel"].astype(dtype).reshape(patch * patch * C, features)
    y = x2 @ w2 + p["bias"].astype(dtype)
    return y.reshape(B, gh, gw, features)


def _proj_residual(p: dict, x: jnp.ndarray, res: jnp.ndarray, dtype) -> jnp.ndarray:
    """(..., in) @ proj + bias + residual, float32 accumulation."""
    acc = jnp.einsum(
        "...k,ko->...o", x, p["kernel"].astype(dtype),
        preferred_element_type=jnp.float32,
    )
    acc = acc + p["bias"].astype(jnp.float32) + res.astype(jnp.float32)
    return acc.astype(x.dtype)


def _attention_compact(cfg, p, xf, xe, ln, geom, rc):
    """Compact-layout windowed attention: x_full (B*n_full, win^2, C) as
    full windows, x_edge (B, E, C) through the virtual-pad-key edge
    attention (see ops/compact_window.py). LN1 rides ahead of the qkv
    projection; the block residual rides the projection."""
    win, dim, heads = geom.win, cfg.embed_dim, cfg.num_heads
    dt = cfg.dtype
    hd = dim // heads
    scale = hd ** -0.5
    S = win * win
    nf = geom.n_full
    B = xf.shape[0] // nf
    g1, be1 = ln
    wq, bq = p["qkv"]["kernel"], p["qkv"]["bias"]
    wqc = wq.astype(dt)
    bqc = bq.astype(dt)[None]
    wp = p["proj"]["kernel"].astype(dt)
    bp = p["proj"]["bias"].astype(dt)[None]
    rc = rc or {}

    qkv_f = ln_linear_act_bt(
        xf, g1[None], be1[None], wqc, bqc, eps=1e-6, activation=None
    )  # (B*nf, S, 3*dim)
    rel_s, sel32 = rel_smajor_windows(
        qkv_f, p["rel_pos_h"], p["rel_pos_w"], win, heads, hd,
        rblk=rc.get("rblk"),
    )
    out_f = qkv_packed_windows_s(
        qkv_f, rel_s, sel32, scale, heads, hd,
    ).reshape(B, nf, dim, S)  # d-major for proj_rows
    yf = proj_rows(out_f, wp, bp, xf.reshape(B, nf, S, dim)).reshape(B * nf, S, dim)
    if xe is None:
        return yf, None

    qkv_e = ln_linear_act_bt(
        xe, g1[None], be1[None], wqc, bqc, eps=1e-6, activation=None
    )  # (B, E, 3*dim)
    n, R = geom.n_edge, geom.R_u
    k_bias = bq[dim : 2 * dim].reshape(heads, hd)
    redge0 = rc.get("redge_0")
    if redge0 is not None and redge0.shape[0] == R:
        # inference: hoisted kron tables + dot-based Lpad (edge_rel_fast)
        tables = [rc[f"redge_{gi}"] for gi in range(len(geom.edge_groups))]
        rel_nr = edge_rel_fast(
            qkv_e, tables, k_bias, scale, geom, heads, hd
        )  # (B, n, R, heads*32), Lpad in lane 28
    else:
        q_e = qkv_e[:, :, :dim].reshape(B, geom.E, heads, hd)
        rcomb = make_rcomb(win, win, p["rel_pos_h"], p["rel_pos_w"], qkv_e.dtype)
        rel_e = edge_rel_lpad(
            q_e, rcomb, k_bias, scale, geom
        )  # (B, E, heads, 32) with the virtual-pad-key logit in lane 28
        rel_nr = rel_e.reshape(B, n, R, heads * REL_LANES)
    sel_e, kmask_e = edge_consts(geom, qkv_e.dtype)
    vb = bq[2 * dim :].astype(dt).reshape(heads, hd)
    out_e = qkv_packed_edge(
        qkv_e.reshape(B, n, R, 3 * dim), rel_nr,
        sel_e, vb, kmask_e, scale, heads, hd,
    )  # (B, n, heads*hd, R) — d-major
    ye = proj_rows(out_e, wp, bp, xe.reshape(B, n, R, dim))
    return yf, ye.reshape(B, geom.E, dim)


def _attention_fused(cfg, p, x, input_size, num_windows, ln, mask, residual, rc):
    """Fused attention: x is the block's RAW input; LN1 (+pad mask) rides
    ahead of the qkv projection and `residual` into the projection."""
    B, N, _ = x.shape
    H, W = input_size
    dim, heads, dt = cfg.embed_dim, cfg.num_heads, cfg.dtype
    hd = dim // heads
    scale = hd ** -0.5
    g1, be1 = ln
    m = mask if mask is not None else jnp.ones((1, N, 1), jnp.float32)
    qkv3d = ln_mask_linear_bt(
        x, g1[None], be1[None], m.astype(x.dtype),
        p["qkv"]["kernel"].astype(dt), p["qkv"]["bias"].astype(dt)[None],
        eps=1e-6,
    )
    qh = qkv3d[:, :, :dim].reshape(B, H, W, heads, hd)
    wp = p["proj"]["kernel"].astype(dt)
    bp = p["proj"]["bias"].astype(dt)[None]
    nwin = num_windows
    if (nwin > 1 or N <= 512) and H + W <= 32:
        rel_p, sel32 = rel_packed32(qh, p["rel_pos_h"], p["rel_pos_w"], H, W)
        out = qkv_packed_windows(
            qkv3d.reshape(B // nwin, nwin, N, 3 * dim),
            rel_p.reshape(B // nwin, nwin, N, heads * 32),
            sel32, scale, heads, hd,
        )  # (B/nwin, nwin, heads*hd, Nw) — d-major
        res = residual.reshape(B // nwin, nwin, N, dim)
        y = proj_rows(out, wp, bp, res)
    elif nwin > 1 or N <= 512:
        rel, sel = rel_and_scatter(qh, p["rel_pos_h"], p["rel_pos_w"], H, W)
        out = qkv_relpos_windows(
            qkv3d.reshape(B // nwin, nwin, N, 3 * heads, hd),
            rel.reshape(B // nwin, nwin, N, heads, H + W),
            sel, scale,
        )  # (B/nwin, heads, nwin, Nw, hd)
        res = residual.reshape(B // nwin, nwin, N, dim)
        y = proj_from_heads(out, wp.reshape(heads, hd, dim), bp, res)
    else:
        # global blocks: rel arrives position-major (N, B, heads, H+W)
        rcg = (rc or {}).get("rcg")
        if rcg is not None and rcg.shape[:2] != (H, W):
            rcg = None  # cache built for a different input size
        rel_s = rel_smajor_global(qh, p["rel_pos_h"], p["rel_pos_w"], H, W, rcg=rcg)
        out = qkv_packed_global(qkv3d, rel_s, scale, heads, hd, H, W)
        y = _proj_residual(p["proj"], out, residual, dt)
    return y.reshape(B, N, dim)


def _attention(cfg, p, x, input_size):
    """Unfused attention: x arrives normed (+masked); caller adds the
    residual."""
    B, N, _ = x.shape
    H, W = input_size
    dim, heads, dt = cfg.embed_dim, cfg.num_heads, cfg.dtype
    hd = dim // heads
    scale = hd ** -0.5
    qkv = L.dense(p["qkv"], x, dt)
    qkv = qkv.reshape(B, N, 3, heads, hd).transpose(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, heads, N, hd)
    rel_pos_h = p.get("rel_pos_h")
    rel_pos_w = p.get("rel_pos_w")
    if cfg.attn_impl == "reference":
        out = attention_with_decomposed_rel_pos(
            q, k, v, rel_pos_h, rel_pos_w, (H, W), scale
        )
    elif cfg.attn_impl == "flash" and cfg.use_rel_pos:
        rq = jnp.moveaxis(q, 1, 2).reshape(B, H, W, heads, hd)
        rel, sel = rel_and_scatter(rq, rel_pos_h, rel_pos_w, H, W)
        rel = jnp.moveaxis(rel.reshape(B, N, heads, H + W), 2, 1)
        out = xla_attention_relpos(q * jnp.asarray(scale, q.dtype), k, v, rel, sel)
    else:
        q_aug, k_aug = augment_qk(q, k, rel_pos_h, rel_pos_w, (H, W), scale)
        out = attention_xla(q_aug, k_aug, v)
    out = out.transpose(0, 2, 1, 3).reshape(B, N, dim)
    return L.dense(p["proj"], out, dt)


def _block(cfg, p, x, mask=None, rc=None, *, window_size, num_windows=1,
           attn_size=None, geom=None):
    """ViT block on SEQUENCE layout (B', S, C).

    Windowed blocks (window_size > 0) run either on the compact carry
    (`geom`: x is (x_full, x_edge)) or in the padded window-carry layout:
    B' = B * nWin, S = window^2, and `mask` re-zeroes padded tokens after
    LN1 (the reference zero-pads activations after LN1 per block,
    `image_encoder.py:427-431`; in carry mode the pad rows persist between
    blocks and must not reach attention). Global blocks get (B, H*W, C)
    with mask=None."""
    input_size = (window_size,) * 2 if window_size > 0 else attn_size
    act = "gelu_tanh" if cfg.gelu_approximate else "gelu"
    n1, n2, mlp = p["norm1"], p["norm2"], p["mlp"]
    ln1 = (n1["scale"], n1["bias"])

    def fused_mlp(t):
        dt = cfg.dtype
        return ln_mlp_residual_bt(
            t, n2["scale"][None], n2["bias"][None],
            mlp["lin1"]["kernel"].astype(dt), mlp["lin1"]["bias"].astype(dt)[None],
            mlp["lin2"]["kernel"].astype(dt), mlp["lin2"]["bias"].astype(dt)[None],
            eps=1e-6, activation=act,
        )

    if geom is not None:
        xf, xe = _attention_compact(cfg, p["attn"], x[0], x[1], ln1, geom, rc)
        return fused_mlp(xf), (fused_mlp(xe) if xe is not None else None)
    if fused_attention_enabled(cfg.attn_impl, cfg.use_rel_pos, cfg.num_heads):
        x = _attention_fused(
            cfg, p["attn"], x, input_size, num_windows, ln1, mask, x, rc
        )
        return fused_mlp(x)
    shortcut = x
    x = L.ln(n1, x, 1e-6)
    if mask is not None:
        # mask: (nwin, S, 1); broadcast over the leading B'=B*nwin
        B0 = x.shape[0] // mask.shape[0]
        x = (
            x.reshape(B0, mask.shape[0], *x.shape[1:])
            * mask[None].astype(x.dtype)
        ).reshape(x.shape)
    x = shortcut + _attention(cfg, p["attn"], x, input_size)
    y = L.ln(n2, x, 1e-6)
    y = L.dense(mlp["lin1"], y, cfg.dtype)
    y = jax.nn.gelu(y, approximate=cfg.gelu_approximate)
    return x + L.dense(mlp["lin2"], y, cfg.dtype)


def _block_prompt(cfg, pg, features, i):
    p = L.dense(pg[f"lightweight_mlp_{i}"], features, cfg.dtype)
    p = jax.nn.gelu(p, approximate=False)
    return L.dense(pg["shared_mlp"], p, cfg.dtype)


def _prompt_features(cfg, pg, image, patch_tokens):
    """EVP adapter features: handcrafted FFT features + embedding features
    (reference `PromptGenerator`, `image_encoder.py:218-353`).

    QUIRK (load-bearing for checkpoint parity): the reference's
    `init_embeddings` (`image_encoder.py:283-286`) reshapes the NHWC patch
    tokens as `(N, C, H*W)` WITHOUT permuting first — a raw memory
    reinterpretation that scrambles tokens against channels before the
    embedding_generator. The trained prompt-generator weights absorbed that
    scramble, so it is replicated exactly (golden-parity-tested in
    tests/test_golden_parity.py)."""
    handcrafted = patch_embed(
        pg["handcrafted_embed"],
        fft_highpass(image, cfg.freq_rate).astype(cfg.dtype),
        cfg.patch_size, cfg.dtype,
    )  # (B, h, w, prompt_dim)
    B, h, w, D = patch_tokens.shape
    scrambled = patch_tokens.reshape(B, D, h * w).transpose(0, 2, 1)
    embedding = L.dense(pg["embedding_generator"], scrambled, cfg.dtype)
    return handcrafted + embedding.reshape(B, h, w, -1)


def apply(cfg: SamEncoderConfig, params: dict, x: jnp.ndarray,
          interm: bool = False, relcache: Optional[dict] = None):
    """SAM image encoder: (B, H, W, 3) -> neck features NHWC, plus the
    global-block tokens when `interm`. `relcache` is the optional
    `precompute_rel_tables` output."""
    relcache = relcache or {}
    inp = x
    x = patch_embed(params["patch_embed"], x, cfg.patch_size, cfg.dtype)
    pg = params["prompt_generator"]
    prompt_features = _prompt_features(cfg, pg, inp, x)
    x = x + params["pos_embed"].astype(cfg.dtype)

    B, H, W, D = x.shape
    win = cfg.window_size
    has_windows = win > 0 and any(
        i not in cfg.global_attn_indexes for i in range(cfg.depth)
    )
    # Compact (pad-free) carry for the fused path: windowed runs hold
    # (x_full (B*n_full, win^2, C), x_edge (B, E, C)) — 4096 instead of
    # 4900 rows/image at ViT-H. Partition ONCE per windowed run; pad-token
    # attention semantics live in the edge attention's virtual pad key
    # (ops/compact_window.py).
    geom = None
    if has_windows and fused_attention_enabled(
        cfg.attn_impl, cfg.use_rel_pos, cfg.num_heads
    ):
        g = CompactGeometry(H, W, win)
        geom = g if g.supported() else None
    if has_windows and geom is None:
        # padded window-carry: `valid` re-zeroes the structural pad tokens
        # after each LN1 (see _block)
        valid = window_valid_mask(H, W, win)
        pf_w, _ = window_partition_seq(prompt_features, win)
        nwin = valid.shape[0]
    elif has_windows:
        pf_f, pf_e = compact_partition(prompt_features, geom)

    interm_embeddings = []
    x_w = None  # carry-layout activations (None <=> x holds grid layout)
    xc = None   # compact carry (x_full, x_edge)
    for i in range(cfg.depth):
        windowed = win > 0 and i not in cfg.global_attn_indexes
        rc = relcache.get(f"block_{i}", {}).get("attn")
        bp = params[f"block_{i}"]
        if windowed and geom is not None:
            if xc is None:
                xc = compact_partition(x, geom)
            xf = xc[0] + _block_prompt(cfg, pg, pf_f, i)
            xe = (
                xc[1] + _block_prompt(cfg, pg, pf_e, i)
                if xc[1] is not None else None
            )
            xc = _run_block(cfg, bp, (xf, xe), None, rc,
                            window_size=win, geom=geom)
        elif windowed:
            if x_w is None:
                x_w, pad_hw = window_partition_seq(x, win)
            x_w = x_w + _block_prompt(cfg, pg, pf_w, i)
            x_w = _run_block(cfg, bp, x_w, valid, rc,
                             window_size=win, num_windows=nwin)
        else:
            if xc is not None:
                x = compact_unpartition(xc[0], xc[1], geom)
                xc = None
            if x_w is not None:
                x = window_unpartition_seq(x_w, win, pad_hw, (H, W))
                x_w = None
            x = x + _block_prompt(cfg, pg, prompt_features, i)
            x = _run_block(
                cfg, bp, x.reshape(B, H * W, D), None, rc,
                window_size=0, attn_size=(H, W),
            ).reshape(B, H, W, D)
            if interm:
                interm_embeddings.append(x)
    if xc is not None:
        x = compact_unpartition(xc[0], xc[1], geom)
    if x_w is not None:
        x = window_unpartition_seq(x_w, win, pad_hw, (H, W))

    # Neck: 1x1 conv -> LN -> 3x3 conv -> LN (all channel-last).
    y = L.conv(params["neck_conv1"], x, 1, "VALID", cfg.dtype)
    y = L.ln(params["neck_ln1"], y, 1e-6)
    y = L.conv(params["neck_conv2"], y, 1, "SAME", cfg.dtype)
    y = L.ln(params["neck_ln2"], y, 1e-6)

    if interm:
        return y, interm_embeddings
    return y


def _run_block(cfg, bp, x, mask, rc, **static):
    """One block, rematerialised in the backward pass when `cfg.remat`."""
    fn = functools.partial(_block, cfg, **static)
    if cfg.remat:
        fn = jax.checkpoint(fn)
    return fn(bp, x, mask, rc)

"""Compact (pad-free) window layout for windowed ViT attention.

The reference pads the token grid up to a multiple of the window size before
every windowed attention and crops afterwards
(`/root/reference/models/mmseg/models/sam/image_encoder.py:507-553`): SAM
ViT-H runs 64x64 tokens as 70x70 = 25 windows of 196 tokens, so every
row-wise op (qkv, MLP, proj) processes 4900 rows where only 4096 are real —
a ~20% FLOP/bandwidth tax.

This module removes the pad rows. Key observation: the reference applies
LN1 on the UNPADDED grid and pads with zeros afterwards
(`image_encoder.py:433-439`), so a pad token enters the qkv projection as an
exact zero row — its k and v equal the qkv BIAS, a per-head constant, and
its attention-score contribution to a real query q at window position
(qh, qw) is

    s_pad(kh, kw) = (q . k_bias) * scale + rel_h[qh, kh] + rel_w[qw, kw].

Within each partially-padded window the pad positions form a union of at
most two PRODUCT sets (rows x cols), so the total pad probability mass per
query collapses to ONE virtual key whose logit

    Lpad = logsumexp_t [ q.k_bias*scale + LSE(rel_h over kh_t)
                                        + LSE(rel_w over kw_t) ]

is computed from the rel factors and delivered to the attention in rel
lane LPAD_LANE, concatenated in when rel is built. Softmax over
[real keys | virtual pad key] is algebraically identical to the
reference's softmax over the padded window.

Layout: a windowed run carries two tensors instead of one padded one —

    x_full: (B * n_full, win*win, C)   interior windows (all tokens real)
    x_edge: (B, n_edge * R_u, C)       right | bottom | corner windows'
                                       tokens, window-major, row-major
                                       within each window

All edge windows share ONE uniform row count R_u = max over edge groups of
(rows-per-window), so a single attention call covers them; windows with fewer
real rows (the corner) carry zero-filled dummy rows whose key columns are
masked with -1e30 and whose query rows are discarded at
unpartition. ViT-H: n_full = 16 (3136 rows), n_edge = 9, R_u = 112 ->
4144 rows/image vs 4900 padded.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

# Lane layout of the packed rel factors (see sam_encoder.rel_packed32): per
# head, lanes [0, win) hold rel_h over kh, [win, 2*win) hold rel_w over kw;
# edge windows carry the virtual-pad-key logit in lane LPAD_LANE.
REL_LANES = 32
LPAD_LANE = 28
NEG = -1e30


@dataclasses.dataclass(frozen=True)
class EdgeGroup:
    """`n` edge windows of `nr` x `nc` real tokens.

    `terms` lists the pad-position product sets of each window as
    (kh_lo, kh_hi, kw_lo, kw_hi) ranges in window coordinates (the corner
    has two; a missing second term is encoded by all-zero lane masks)."""

    n: int
    nr: int
    nc: int
    terms: Tuple[Tuple[int, int, int, int], ...]

    @property
    def rows(self) -> int:  # real rows per window
        return self.nr * self.nc


@dataclasses.dataclass(frozen=True)
class CompactGeometry:
    """Static description of the compact window layout for an (H, W) grid."""

    H: int
    W: int
    win: int

    @property
    def nh(self) -> int:  # full-window grid height
        return self.H // self.win

    @property
    def nw(self) -> int:
        return self.W // self.win

    @property
    def rb(self) -> int:  # bottom-edge real rows
        return self.H % self.win

    @property
    def rw(self) -> int:  # right-edge real cols
        return self.W % self.win

    @property
    def n_full(self) -> int:
        return self.nh * self.nw

    @property
    def has_edge(self) -> bool:
        return self.rb > 0 or self.rw > 0

    @property
    def edge_groups(self) -> Tuple[EdgeGroup, ...]:
        """Right-edge, bottom-edge, corner window groups (window order of
        x_edge)."""
        k, nh, nw, rb, rw = self.win, self.nh, self.nw, self.rb, self.rw
        groups = []
        if rw:
            groups.append(EdgeGroup(nh, k, rw, ((0, k, rw, k),)))
        if rb:
            groups.append(EdgeGroup(nw, rb, k, ((rb, k, 0, k),)))
        if rb and rw:
            groups.append(EdgeGroup(1, rb, rw, ((rb, k, 0, k), (0, rb, rw, k))))
        return tuple(groups)

    @property
    def n_edge(self) -> int:
        return sum(g.n for g in self.edge_groups)

    @property
    def R_u(self) -> int:
        """Uniform per-window row count (smaller windows are zero-padded)."""
        return max((g.rows for g in self.edge_groups), default=0)

    @property
    def E(self) -> int:
        return self.n_edge * self.R_u

    def supported(self) -> bool:
        return 2 * self.win <= LPAD_LANE


def compact_partition(
    x: jnp.ndarray, geom: CompactGeometry
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """(B, H, W, C) -> (x_full (B*n_full, win^2, C), x_edge (B, E, C)|None)."""
    B, H, W, C = x.shape
    k, nh, nw, rb, rw = geom.win, geom.nh, geom.nw, geom.rb, geom.rw
    fh, fw = nh * k, nw * k
    xf = (
        x[:, :fh, :fw]
        .reshape(B, nh, k, nw, k, C)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(B * nh * nw, k * k, C)
    )
    if not geom.has_edge:
        return xf, None
    R = geom.R_u
    parts = []
    if rw:
        # (B, nh, k, rw, C) is already window-major row-major
        parts.append(x[:, :fh, fw:].reshape(B, nh, k * rw, C))
    if rb:
        parts.append(
            x[:, fh:, :fw]
            .reshape(B, rb, nw, k, C)
            .transpose(0, 2, 1, 3, 4)
            .reshape(B, nw, rb * k, C)
        )
    if rb and rw:
        parts.append(x[:, fh:, fw:].reshape(B, 1, rb * rw, C))
    parts = [
        jnp.pad(p, ((0, 0), (0, 0), (0, R - p.shape[2]), (0, 0)))
        if p.shape[2] != R else p
        for p in parts
    ]
    xe = jnp.concatenate(parts, axis=1).reshape(B, geom.E, C)
    return xf, xe


def compact_unpartition(
    xf: jnp.ndarray, xe: Optional[jnp.ndarray], geom: CompactGeometry
) -> jnp.ndarray:
    """Inverse of :func:`compact_partition` -> (B, H, W, C)."""
    k, nh, nw, rb, rw = geom.win, geom.nh, geom.nw, geom.rb, geom.rw
    C = xf.shape[-1]
    fh, fw = nh * k, nw * k
    B = xf.shape[0] // (nh * nw)
    full = (
        xf.reshape(B, nh, nw, k, k, C)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(B, fh, fw, C)
    )
    if xe is None:
        return full
    R = geom.R_u
    xe = xe.reshape(B, geom.n_edge, R, C)
    off = 0
    top, bot = full, None
    if rw:
        right = xe[:, : nh, : k * rw].reshape(B, fh, rw, C)
        off += nh
        top = jnp.concatenate([full, right], axis=2)
    if rb:
        bottom = (
            xe[:, off : off + nw, : rb * k]
            .reshape(B, nw, rb, k, C)
            .transpose(0, 2, 1, 3, 4)
            .reshape(B, rb, fw, C)
        )
        off += nw
        bot = bottom
        if rw:
            corner = xe[:, off, : rb * rw].reshape(B, rb, rw, C)
            bot = jnp.concatenate([bottom, corner], axis=2)
    return jnp.concatenate([top, bot], axis=1) if bot is not None else top


@functools.lru_cache(maxsize=None)
def _edge_consts_np(geom: CompactGeometry):
    """Per-window kernel constants for the uniform edge layout:

      sel     (n_edge, REL_LANES, R_u) — rel scatter (lane a < win -> keys
              with kh == a, lane win+b -> kw == b); zero at dummy columns
              AND at the LPAD_LANE row, so the Lpad lane never reaches
              real-key scores.
      kmask   (n_edge, 1, R_u)         — 0 at real keys, -1e30 at dummies.
    """
    win, R = geom.win, geom.R_u
    sels, kmasks = [], []
    for g in geom.edge_groups:
        n = g.nr * g.nc
        kh = np.arange(n) // g.nc
        kw = np.arange(n) % g.nc
        sel = np.zeros((REL_LANES, R), np.float32)
        for a in range(g.nr):
            sel[a, np.flatnonzero(kh == a)] = 1.0
        for b in range(g.nc):
            sel[win + b, np.flatnonzero(kw == b)] = 1.0
        km = np.full((R,), NEG, np.float32)
        km[:n] = 0.0
        sels += [sel] * g.n
        kmasks += [km] * g.n
    return np.stack(sels), np.stack(kmasks)


def edge_consts(geom: CompactGeometry, dtype):
    sel, km = _edge_consts_np(geom)
    return jnp.asarray(sel, dtype), jnp.asarray(km[:, None, :], jnp.float32)


def _lse(x: jnp.ndarray, lo: int, hi: int) -> jnp.ndarray:
    """logsumexp over lane slice [lo, hi) of the trailing axis."""
    import jax

    return jax.nn.logsumexp(x[..., lo:hi], axis=-1)


@functools.lru_cache(maxsize=None)
def _edge_lpad_masks_np(geom: CompactGeometry, heads: int):
    """Per-window 0/1 masks for the dot-based Lpad logsumexp
    (`edge_rel_fast`): Mh/Mw (n_edge, heads*REL_LANES, 2*heads) pick, per
    head, the exp'd rel_h / rel_w lanes of pad term t into output column
    t*heads + h. A window type's missing second term keeps all-zero columns
    (sum 0 -> log -inf -> logaddexp drops it)."""
    win = geom.win
    T = 2
    mh_all, mw_all = [], []
    for g in geom.edge_groups:
        mh = np.zeros((heads * REL_LANES, T * heads), np.float32)
        mw = np.zeros((heads * REL_LANES, T * heads), np.float32)
        for t, (hlo, hhi, wlo, whi) in enumerate(g.terms):
            for h in range(heads):
                mh[h * REL_LANES + hlo : h * REL_LANES + hhi, t * heads + h] = 1.0
                mw[h * REL_LANES + win + wlo : h * REL_LANES + win + whi,
                   t * heads + h] = 1.0
        mh_all += [mh] * g.n
        mw_all += [mw] * g.n
    return np.stack(mh_all), np.stack(mw_all)


def edge_rel_fast(
    qkv_edge: jnp.ndarray,   # (B, E, 3*heads*hd) — packed qkv, uniform layout
    tables,                  # per edge group: (R_u, hg*hd, hg*REL_LANES)
    k_bias: jnp.ndarray,     # (heads, hd) — k slice of the qkv bias
    scale: float,
    geom: CompactGeometry,
    heads: int,
    hd: int,
) -> jnp.ndarray:
    """`edge_rel_lpad` against precomputed kron tables -> (B, n, R, heads*32).

    `edge_rel_lpad` builds rel per edge GROUP with 5-D einsums over (nr, nc)
    batch dims, computes Lpad with lane-slice logsumexps on (..., heads, 28)
    tensors, then concatenates the Lpad lane and merges (heads, 32) lanes.
    Here:

      * rel comes from ONE einsum per group against the hoisted kron table
        (`make_redge_tables` — same [rel_h | rel_w | 0] packing as the
        interior `make_rblk`, lane-aligned 256-wide output, dummy corner
        rows zero);
      * Lpad's logsumexps become exp + one 0/1-mask dot per side on the
        ALIGNED (B, n, R, heads*32) tensor (global-max stabilised — exact
        up to f32 rounding);
      * the Lpad lane lands by a one-hot K=heads dot — no concat, no
        dynamic-update-slice.

    Only used at inference (tables ride the 'relcache' collection); training
    keeps `edge_rel_lpad`, whose gradients flow to the rel params."""
    import jax

    B = qkv_edge.shape[0]
    n, R = geom.n_edge, geom.R_u
    dim = heads * hd
    hg = tables[0].shape[1] // hd
    n_g = heads // hg
    dt = qkv_edge.dtype

    q2 = qkv_edge[:, :, :dim].reshape(B, n, R, n_g, hg * hd)
    rels = []
    off = 0
    for g, tab in zip(geom.edge_groups, tables):
        qg = q2[:, off : off + g.n]
        off += g.n
        rel_g = jnp.einsum(
            "bnrgc,rcj->bnrgj", qg, tab.astype(dt)
        )  # (B, g.n, R, n_g, hg*32)
        rels.append(rel_g.reshape(B, g.n, R, heads * REL_LANES))
    rel = jnp.concatenate(rels, axis=1)  # (B, n, R, heads*32)

    # virtual-pad-key logit (see module docstring): per pad term t,
    # lp_t = q.k_bias*scale + LSE(rel_h over kh_t) + LSE(rel_w over kw_t)
    q4 = q2.reshape(B, n, R, heads, hd)
    qkb = jnp.einsum(
        "bnrhc,hc->bnrh", q4, k_bias.astype(dt)
    ).astype(jnp.float32) * scale
    mh, mw = _edge_lpad_masks_np(geom, heads)
    relf = rel.astype(jnp.float32)
    C = jnp.max(relf)  # global-max stabilisation (exact LSE up to rounding)
    es = jnp.exp(relf - C)
    sh = jnp.einsum("bnrj,njt->bnrt", es, jnp.asarray(mh))  # (B,n,R,2*heads)
    sw = jnp.einsum("bnrj,njt->bnrt", es, jnp.asarray(mw))
    lse_sum = jnp.log(sh) + jnp.log(sw) + 2.0 * C  # -inf where term absent
    lp2 = qkb[:, :, :, None, :] + lse_sum.reshape(B, n, R, 2, heads)
    lp = jnp.logaddexp(lp2[:, :, :, 0], lp2[:, :, :, 1])  # (B, n, R, heads)
    # clamp -inf (dummy rows / absent terms both sides) so the one-hot
    # scatter dot below cannot produce -inf * 0 = NaN
    lp = jnp.maximum(lp, NEG)
    e28 = np.zeros((heads, heads * REL_LANES), np.float32)
    e28[np.arange(heads), np.arange(heads) * REL_LANES + LPAD_LANE] = 1.0
    rel = rel + jnp.einsum(
        "bnrh,hj->bnrj", lp.astype(dt), jnp.asarray(e28, dt)
    )
    return rel


def edge_rel_lpad(
    q_edge: jnp.ndarray,    # (B, E, heads, hd) — UNSCALED queries
    rcomb: jnp.ndarray,     # (win, win, hd, REL_LANES) combined rel table
    k_bias: jnp.ndarray,    # (heads, hd) — k slice of the qkv bias
    scale: float,
    geom: CompactGeometry,
) -> jnp.ndarray:
    """Packed rel factors for the edge windows with the virtual-pad-key
    logit in lane LPAD_LANE, (B, E, heads, REL_LANES).

    Per window type the pad positions are a union of <=2 product sets
    (kh range x kw range); `Lpad = logsumexp_t [ q.k_bias*scale
    + LSE(rel_h over kh_t) + LSE(rel_w over kw_t) ]` — exactly
    `log sum_pad exp(s_pad)` of the reference's padded-window scores. The
    lane is concatenated in when rel is built. Dummy rows (corner
    padding) get zero rel; their outputs are discarded and their key
    columns masked."""
    B, E, heads, hd = q_edge.shape
    win, R = geom.win, geom.R_u
    kb = k_bias.astype(q_edge.dtype)
    q4 = q_edge.reshape(B, geom.n_edge, R, heads, hd)
    out = []
    off = 0
    for g in geom.edge_groups:
        qp = q4[:, off : off + g.n, : g.rows].reshape(
            B, g.n, g.nr, g.nc, heads, hd
        )
        off += g.n
        rel = jnp.einsum(
            "bnhwxc,hwcj->bnhwxj", qp, rcomb[: g.nr, : g.nc, :, :LPAD_LANE]
        )
        qkb = jnp.einsum("bnhwxc,xc->bnhwx", qp, kb).astype(jnp.float32) * scale
        relf = rel.astype(jnp.float32)
        lp = None
        for (hlo, hhi, wlo, whi) in g.terms:
            t = qkb + _lse(relf, hlo, hhi) + _lse(relf, win + wlo, win + whi)
            lp = t if lp is None else jnp.logaddexp(lp, t)
        rel = jnp.concatenate(
            [
                rel,
                lp[..., None].astype(rel.dtype),
                jnp.zeros(rel.shape[:-1] + (REL_LANES - LPAD_LANE - 1,), rel.dtype),
            ],
            axis=-1,
        )
        rel = rel.reshape(B, g.n, g.rows, heads, REL_LANES)
        if g.rows != R:
            rel = jnp.pad(rel, ((0, 0), (0, 0), (0, R - g.rows), (0, 0), (0, 0)))
        out.append(rel)
    return jnp.concatenate(out, axis=1).reshape(B, E, heads, REL_LANES)


def edge_attention_literal(
    qkv_edge: jnp.ndarray,   # (B, E, 3*heads*hd) — packed qkv (uniform layout)
    qkv_bias: jnp.ndarray,   # (3*heads*hd,) — fp32 qkv projection bias
    rel_pos_h: jnp.ndarray,  # (2*win-1, hd)
    rel_pos_w: jnp.ndarray,
    scale: float,
    heads: int,
    geom: CompactGeometry,
) -> jnp.ndarray:
    """Test oracle: reconstruct each padded window LITERALLY (pad k/v rows =
    qkv bias, exactly what the reference's zero-pad + qkv produces), run
    dense rel-pos attention over all win^2 keys, return real-query rows with
    dummy rows zeroed. Output (B, heads, E, hd). Mirrors the reference block
    semantics (`image_encoder.py:433-446`) without the compact
    factorisation — verifies the in-kernel virtual-pad-key path."""
    from .rel_pos import attention_with_decomposed_rel_pos

    B, E, _ = qkv_edge.shape
    win, R = geom.win, geom.R_u
    hd = qkv_edge.shape[-1] // (3 * heads)
    dt = qkv_edge.dtype
    bias_row = qkv_bias.astype(dt)
    q4 = qkv_edge.reshape(B, geom.n_edge, R, -1)
    outs = []
    off = 0
    for g in geom.edge_groups:
        qkv_w = q4[:, off : off + g.n, : g.rows].reshape(
            B, g.n, g.nr, g.nc, -1
        )
        off += g.n
        pad = jnp.broadcast_to(bias_row, (B, g.n, win, win, bias_row.shape[0]))
        full = pad.at[:, :, : g.nr, : g.nc, :].set(qkv_w)
        full = full.reshape(B, g.n, win * win, 3, heads, hd)
        q = jnp.moveaxis(full[..., 0, :, :], 3, 2)  # (B, n, heads, win^2, hd)
        k = jnp.moveaxis(full[..., 1, :, :], 3, 2)
        v = jnp.moveaxis(full[..., 2, :, :], 3, 2)
        o = attention_with_decomposed_rel_pos(
            q, k, v, rel_pos_h, rel_pos_w, (win, win), scale
        )
        o = o.reshape(B, g.n, heads, win, win, hd)[:, :, :, : g.nr, : g.nc]
        o = o.reshape(B, g.n, heads, g.rows, hd)
        if g.rows != R:
            o = jnp.pad(o, ((0, 0), (0, 0), (0, 0), (0, R - g.rows), (0, 0)))
        outs.append(jnp.moveaxis(o, 2, 1))  # (B, heads, n, R, hd)
    out = jnp.concatenate(outs, axis=2)
    return out.reshape(B, heads, E, hd)

"""Smoke check of the OVCOS cascade on NVIDIA GPUs, through its entry points.

    python chip_smoke.py            # one card: phases 1-5
    python chip_smoke.py --multi    # four cards: the multi-device phase only

Phases (each prints its own lines; any failure exits non-zero before the
final line):

1. environment — the card's name and power limit (nvidia-smi), the JAX
   version and devices, which optional packages import. No GPU -> exit 2.
2. kernel check — the Pallas-Triton global-attention kernel, compiled for
   the card, against two float32 references at ViT-H widths, each within
   a bound derived from its inputs, plus the `gpu`-marked tests.
3. cascade inference — SAM ViT-H @1024 + EVP + edge decoder + two
   Alpha-CLIP ViT-L/14@336 passes, bf16, random weights from a seed, at
   batch 1 and 8; compile time, memory analysis, timed iterations, and a
   batch-1 check against the same params in float32 with the dense
   reference attention.
4. serving — `serve.InferenceEngine` with buckets (1, 8) answers 20
   in-process requests.
5. training — train steps (production freeze mask) at batch 2, at full
   width with the depth cut (`TRAIN_DEPTH`): the full-depth step compiles
   for minutes, which this check cannot afford.
6. `--multi` (four cards, and nothing else) — the global-attention kernel
   under dp4 and dp2 x tp2 meshes (it must read only its batch shard),
   then dp4 and dp2 x tp2 training steps and tensor-parallel eval, each
   against one card, in bf16 with the kernel on, at full width with the
   depth cut further (`MULTI_DEPTH`).

The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
# Tolerances of the phase-3 check, bf16 program vs float32 reference on the
# same params (see `check_against_f32`).
MASK_MEAN_TOL = 2e-2
MASK_MAX_TOL = 0.25
CLASS_PROB_TOL = 5e-2
# Phase-2 shape: one SAM ViT-H global block (H, W, heads, head width); the
# bounds are derived in `kernel_errors`.
KERNEL_SHAPE = (64, 64, 16, 80)
# Depth cuts (encoder blocks, its global blocks, CLIP vision / text layers,
# MaPLe prompt depth); every width stays at SAM ViT-H / Alpha-CLIP ViT-L.
TRAIN_DEPTH = dict(depth=8, global_attn_indexes=(3, 7), clip_layers=8, prompt_depth=8)
MULTI_DEPTH = dict(depth=2, global_attn_indexes=(1,), clip_layers=2, prompt_depth=2)


def card() -> str:
    """`name, power.limit` of the card as nvidia-smi reports it (a child
    process that stays off JAX)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "unavailable"
    except (OSError, subprocess.SubprocessError):
        return "unavailable"


CARD = None
# persistent compilation cache events of this run (jax.monitoring)
CACHE_EVENTS = {"/jax/compilation_cache/cache_hits": 0,
                "/jax/compilation_cache/cache_misses": 0}


def count_cache_event(event: str, **_) -> None:
    if event in CACHE_EVENTS:
        CACHE_EVENTS[event] += 1


def say(msg: str) -> None:
    print(msg, flush=True)


def with_card(msg: str) -> None:
    say(f"{msg}  [{CARD}]")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ----------------------------------------------------------------------------
# phase 1
# ----------------------------------------------------------------------------


def phase_environment():
    global CARD
    CARD = card()
    say("== phase 1: environment")
    say(CARD)
    from camouflaged_vlm_tpu.utils.compile_cache import setup_compile_cache

    say(f"compile cache: {setup_compile_cache()}")
    import jax

    jax.monitoring.register_event_listener(count_cache_event)

    say(f"jax {jax.__version__}; devices: {jax.devices()}")
    for mod in ("flax", "PIL", "yaml", "orbax.checkpoint", "regex"):
        try:
            importlib.import_module(mod)
            say(f"import {mod}: ok")
        except Exception as e:  # report, never require
            say(f"import {mod}: {type(e).__name__}")
    d = jax.devices()
    device = {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}
    if device["platform"] != "gpu":
        print(f"chip_smoke needs an NVIDIA GPU; JAX found {device}",
              file=sys.stderr, flush=True)
        sys.exit(2)
    return device


# ----------------------------------------------------------------------------
# phase 2
# ----------------------------------------------------------------------------


def kernel_inputs(B, rel_scale, seed=SEED):
    """Global-block inputs at ViT-H widths (64 x 64 tokens, 16 heads of
    d = 80): bf16 packed qkv, rel-pos tables of std `rel_scale`, and the
    position-major rel the encoder derives from them, in bf16 (what the
    kernel reads) and in float32 (from the unrounded queries)."""
    import jax
    import jax.numpy as jnp

    from camouflaged_vlm_tpu.models.sam_encoder import rel_smajor_global

    H, W, heads, d = KERNEL_SHAPE
    rng = np.random.default_rng(seed)
    qkv = jnp.asarray(rng.standard_normal((B, H * W, 3 * heads * d)) * 0.5, jnp.bfloat16)
    rph = jnp.asarray(rng.standard_normal((2 * H - 1, d)) * rel_scale, jnp.float32)
    rpw = jnp.asarray(rng.standard_normal((2 * W - 1, d)) * rel_scale, jnp.float32)
    q = qkv[:, :, : heads * d].reshape(B, H, W, heads, d)
    rel = rel_smajor_global(q, rph, rpw, H, W)
    with jax.default_matmul_precision("highest"):
        rel32 = rel_smajor_global(q.astype(jnp.float32), rph, rpw, H, W)
    return qkv, rel, rel32, rph, rpw


def kernel_errors(B, rel_scale):
    """The global-attention kernel, compiled for the card, against two
    float32 references under matmul precision "highest". Returns
    {name: (max abs error, bound)}.

    "own inputs": the repo's XLA formulation in float32, fed exactly what
    the kernel reads (q * scale rounded to bf16 as the kernel rounds it, k,
    v and rel as their bf16 values). The kernel rounds only twice more: the
    probabilities to bf16 before the value product (relative 2^-9 each, so
    the output moves by at most 2^-9 max|v|, since they sum to 1) and the
    output to bf16 (2^-9 |o| <= 2^-9 max|v|). Bound: 2^-8 max|v|, plus
    1e-4 for float32 summation order. It does not depend on the bias.

    "tables": `attention_with_decomposed_rel_pos` from the float32 tables
    and unrounded queries (the model's definition). On top of the above,
    every score moves by at most D = |bf16 q*scale . k - scale q . k| +
    |rel_h error| + |rel_w error|, and a score shift of at most D moves the
    softmax weights by a factor within e^(+-2D). Bound: max|v| (e^(2D) - 1)
    + the bound above, with D taken from these inputs (Cauchy-Schwarz for
    the q.k term), so it grows with the bias magnitude."""
    import jax
    import jax.numpy as jnp

    from camouflaged_vlm_tpu.ops.attention import make_rel_scatter, xla_attention_relpos
    from camouflaged_vlm_tpu.ops.global_attention_triton import global_attention_triton
    from camouflaged_vlm_tpu.ops.rel_pos import attention_with_decomposed_rel_pos

    H, W, heads, d = KERNEL_SHAPE
    N, scale = H * W, d ** -0.5
    qkv, rel, rel32, rph, rpw = kernel_inputs(B, rel_scale)
    got = jax.jit(
        lambda a, b: global_attention_triton(a, b, scale, heads, d, H, W)
    )(qkv, rel).astype(jnp.float32)
    r = qkv.reshape(B, N, 3, heads, d)
    q, k, v = (jnp.moveaxis(r[:, :, i], 2, 1) for i in range(3))  # (B, heads, N, d)
    q_s = q * jnp.asarray(scale, q.dtype)
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    rows = lambda o: jnp.moveaxis(o, 1, 2).reshape(B, N, heads * d)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        own = rows(jax.jit(xla_attention_relpos)(
            f32(q_s), f32(k), f32(v), f32(rel).transpose(1, 2, 0, 3),
            make_rel_scatter(H, W, jnp.float32)))
        tables = rows(jax.jit(
            lambda q, k, v: attention_with_decomposed_rel_pos(
                q, k, v, rph, rpw, (H, W), scale)
        )(f32(q), f32(k), f32(v)))
    vmax = float(jnp.max(jnp.abs(f32(v))))
    bound_own = 2.0 ** -8 * vmax + 1e-4
    qk = (float(jnp.max(jnp.linalg.norm(f32(q_s), axis=-1)))
          * float(jnp.max(jnp.linalg.norm(f32(k), axis=-1))))
    d_qk = 2.0 ** -8 * qk * (1 + 2.0 ** -8)  # q*scale's and scale's rounding
    drel = jnp.abs(f32(rel) - rel32)
    D = d_qk + float(jnp.max(drel[..., :H])) + float(jnp.max(drel[..., H:]))
    return {
        "own inputs": (float(jnp.max(jnp.abs(got - own))), bound_own),
        "tables": (float(jnp.max(jnp.abs(got - tables))),
                   vmax * float(np.expm1(2 * D)) + bound_own),
    }


def phase_kernel_check():
    say("== phase 2: global-attention kernel vs float32 references")
    H, W, heads, d = KERNEL_SHAPE
    # SAM initialises its rel-pos tables at zero and no trained table is in
    # the repo, so the check spans zero and two larger scales; the bounds
    # are computed from whatever tables are fed (see `kernel_errors`).
    for rel_scale in (0.0, 0.3, 1.0):
        for name, (err, bound) in kernel_errors(2, rel_scale).items():
            with_card(f"kernel (B=2, heads={heads}, N={H * W}, d={d}, bf16, rel tables "
                      f"std {rel_scale}) vs f32 reference on {name}: "
                      f"max abs err {err:.3e}, bound {bound:.3e}")
            if not np.isfinite(err) or err > bound:
                fail(f"global-attention kernel error {err} > {bound} ({name})")

    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "test_attention_impls.py")
    if os.path.exists(tests):
        import pytest

        os.environ["CVLM_TEST_GPU"] = "1"
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", tests])
        say(f"pytest -m gpu: exit {int(rc)}")
        if rc != 0:
            fail("gpu-marked tests failed")


# ----------------------------------------------------------------------------
# phase 3
# ----------------------------------------------------------------------------


def depth_cut(dtype, depth, global_attn_indexes, clip_layers, prompt_depth):
    """The full-width cascade with fewer encoder blocks and CLIP layers."""
    from camouflaged_vlm_tpu.models import CascadeConfig, OVCOSCascade

    base = CascadeConfig.full(dtype=dtype)
    cfg = dataclasses.replace(
        base,
        encoder=dataclasses.replace(base.encoder, depth=depth,
                                    global_attn_indexes=global_attn_indexes),
        clip=dataclasses.replace(base.clip, vision_layers=clip_layers,
                                 transformer_layers=clip_layers,
                                 prompt_depth=prompt_depth),
    )
    return OVCOSCascade(cfg), cfg


def _cast_params(params, dtype):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(
        lambda p: p.astype(dtype) if p.dtype == jnp.float32 and p.ndim >= 2 else p,
        params,
    )


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory analysis unavailable"
    gib = lambda b: f"{b / 2**30:.2f} GiB"
    return (f"args {gib(m.argument_size_in_bytes)}, out {gib(m.output_size_in_bytes)}, "
            f"temp {gib(m.temp_size_in_bytes)}, code {gib(m.generated_code_size_in_bytes)}")


def phase_inference():
    say("== phase 3: cascade inference (SAM ViT-H @1024 + EVP + edge decoder "
        "+ 2x Alpha-CLIP ViT-L/14@336, bf16)")
    import jax
    import jax.numpy as jnp

    from camouflaged_vlm_tpu.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu.factory import (
        attach_rel_cache,
        build_full_cascade,
        init_cascade_params,
        make_bank_inputs,
        make_example_inputs,
    )

    model, cfg = build_full_cascade(dtype=jnp.bfloat16)
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES, seed=SEED)
    t0 = time.perf_counter()
    params32 = jax.block_until_ready(init_cascade_params(model, seed=SEED))
    n_params = sum(x.size for x in jax.tree.leaves(params32))
    with_card(f"init {n_params / 1e6:.1f}M params: {time.perf_counter() - t0:.1f} s")
    params = attach_rel_cache(_cast_params(params32, jnp.bfloat16), cfg)
    text_features = jax.jit(model.encode_class_text_features)(
        params, bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"]
    )
    fwd = jax.jit(model.infer_cascade_with_text)
    n_cls = len(TEST_CLASS_NAMES)
    results = {}
    for B in (1, 8):
        inp, cimg, cmask = make_example_inputs(cfg, B, seed=B)
        t0 = time.perf_counter()
        compiled = fwd.lower(params, inp, cimg, cmask, text_features).compile()
        with_card(f"b{B} compile {time.perf_counter() - t0:.1f} s; {_memory(compiled)}")
        out = jax.block_until_ready(compiled(params, inp, cimg, cmask, text_features))
        probs, pred, score = out
        if probs.shape != (B, cfg.inp_size, cfg.inp_size, 1) or score.shape != (B, n_cls):
            fail(f"b{B} output shapes {probs.shape} {score.shape}")
        if not (np.isfinite(np.asarray(probs, np.float32)).all()
                and np.isfinite(np.asarray(score, np.float32)).all()):
            fail(f"b{B} outputs not finite")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(params, inp, cimg, cmask, text_features))
            times.append(time.perf_counter() - t0)
        ms = 1e3 * float(np.median(times))
        with_card(f"b{B} forward: median {ms:.1f} ms over 5 ({B / ms * 1e3:.2f} img/s), "
                  f"min {1e3 * min(times):.1f} ms")
        results[B] = (inp, cimg, cmask, out)
    del fwd, compiled
    check_against_f32(model, cfg, params32, bank, results[1])
    return model, cfg, params, bank


def check_against_f32(model, cfg, params32, bank, b1):
    """The bf16 program against the same params in float32 with the dense
    reference attention, under matmul precision "highest", at batch 1.

    Tolerances: bf16 keeps 8 mantissa bits (2^-9 relative rounding per
    stored value); 32 encoder blocks, the decoder and two CLIP passes each
    re-round their activations, so with random weights the mask logits move
    by a few percent. Mask probabilities pass through a sigmoid (slope
    <= 1/4), so their mean absolute difference stays well under 2e-2 and no
    pixel moves by more than 0.25; the class probabilities (softmax of the
    logits) stay within 5e-2."""
    import jax
    import jax.numpy as jnp

    from camouflaged_vlm_tpu.models import CascadeConfig, OVCOSCascade

    base = CascadeConfig.full(dtype=jnp.float32)
    ref = OVCOSCascade(dataclasses.replace(
        base, encoder=dataclasses.replace(base.encoder, attn_impl="reference")))
    inp, cimg, cmask, (probs, _, score) = b1
    with jax.default_matmul_precision("highest"):
        tf = jax.jit(ref.encode_class_text_features)(
            params32, bank["prefix"], bank["suffix"], bank["eot_indices"],
            bank["bank_features"])
        r_probs, _, r_score = jax.block_until_ready(
            jax.jit(ref.infer_cascade_with_text)(params32, inp, cimg, cmask, tf))
    dm = np.abs(np.asarray(probs, np.float32) - np.asarray(r_probs, np.float32))
    cp = np.asarray(jax.nn.softmax(jnp.asarray(score, jnp.float32), -1))
    rcp = np.asarray(jax.nn.softmax(jnp.asarray(r_score, jnp.float32), -1))
    dc = float(np.max(np.abs(cp - rcp)))
    say(f"b1 bf16 vs f32 reference: mask prob |diff| mean {dm.mean():.3e} "
        f"(tol {MASK_MEAN_TOL:.0e}), max {dm.max():.3e} (tol {MASK_MAX_TOL}); "
        f"class prob |diff| max {dc:.3e} (tol {CLASS_PROB_TOL:.0e}); "
        f"argmax {int(np.argmax(cp))} vs {int(np.argmax(rcp))}")
    if not (dm.mean() <= MASK_MEAN_TOL and dm.max() <= MASK_MAX_TOL
            and dc <= CLASS_PROB_TOL):
        fail("bf16 cascade outside its tolerance of the f32 reference")


# ----------------------------------------------------------------------------
# phase 4
# ----------------------------------------------------------------------------


def phase_serving(model, cfg, params, bank):
    say("== phase 4: serving (InferenceEngine, buckets 1 and 8)")
    from camouflaged_vlm_tpu.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu.serve import InferenceEngine, ServeConfig

    eng = InferenceEngine(
        model, cfg, params, bank, TEST_CLASS_NAMES,
        ServeConfig(buckets=(1, 8), max_delay_ms=20.0, mask_dtype="uint8"),
    )
    try:
        t0 = time.perf_counter()
        eng.warmup()
        with_card(f"engine warmup (compile buckets 1, 8): {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(SEED)
        n = 20
        inps = rng.integers(0, 256, (n, cfg.inp_size, cfg.inp_size, 3), dtype=np.uint8)
        cimgs = rng.integers(0, 256, (n, cfg.clip_size, cfg.clip_size, 3), dtype=np.uint8)
        done = {}

        def submit(i):
            t = time.perf_counter()
            f = eng.submit(inps[i], cimgs[i])
            f.add_done_callback(lambda _f, i=i, t=t: done.__setitem__(i, time.perf_counter() - t))
            return f

        futures = [submit(0)]
        futures[0].result(timeout=300)           # a lone interactive request
        futures += [submit(i) for i in range(1, n)]  # then a burst
        outs = [f.result(timeout=300) for f in futures]
        for mask, cls, logits in outs:
            if (mask.shape != (cfg.inp_size, cfg.inp_size)
                    or not 0 <= cls < len(TEST_CLASS_NAMES)
                    or not np.isfinite(logits).all()):
                fail(f"bad engine response: {mask.shape} {cls}")
        lat = np.array([done[i] for i in range(n)]) * 1e3
        with_card(f"{n} requests answered; latency ms: first {lat[0]:.1f}, burst p50 "
                  f"{np.median(lat[1:]):.1f}, max {lat[1:].max():.1f}; "
                  f"batches {eng.stats()['batch_size_hist']}")
    finally:
        eng.close()


# ----------------------------------------------------------------------------
# phase 5 / 6: training
# ----------------------------------------------------------------------------


def _train_batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return {
        "inp": rng.standard_normal((B, cfg.inp_size, cfg.inp_size, 3)).astype(np.float32),
        "gt": (rng.random((B, cfg.inp_size, cfg.inp_size, 1)) > 0.5).astype(np.float32),
        "clip_image": rng.standard_normal(
            (B, cfg.clip_size, cfg.clip_size, 3)).astype(np.float32),
        "clip_mask": np.full((B, cfg.clip_size, cfg.clip_size, 1), 1.923, np.float32),
    }


def phase_training():
    say(f"== phase 5: training (production freeze mask, batch 2, full width, "
        f"depth cut {TRAIN_DEPTH})")
    import jax
    import jax.numpy as jnp

    from camouflaged_vlm_tpu.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu.factory import init_cascade_params, make_bank_inputs
    from camouflaged_vlm_tpu.train import create_train_state, make_optimizer, make_train_step

    model, cfg = depth_cut(jnp.bfloat16, **TRAIN_DEPTH)
    params32 = init_cascade_params(model, seed=SEED)
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES, seed=SEED)
    text_features = jax.jit(model.encode_class_text_features)(
        params32, bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"]
    )
    tx = make_optimizer(params32)
    state = create_train_state(params32, tx)
    step = jax.jit(make_train_step(model, tx), donate_argnums=(0,))
    batch = {k: jnp.asarray(v) for k, v in _train_batch(cfg, 2, SEED).items()}
    batch["text_features"] = text_features.astype(jnp.float32)
    for i in range(3):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(jax.block_until_ready(metrics["loss"]))
        dt = time.perf_counter() - t0
        with_card(f"step {i}: loss {loss:.4f}, {dt:.2f} s" + (" (incl. compile)" if i == 0 else ""))
        if not np.isfinite(loss):
            fail(f"training loss not finite at step {i}")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
    with_card(f"peak_bytes_in_use {peak / 2**30:.2f} GiB")


def partition_check(devices, log=print):
    """The global-attention dispatcher (`qkv_packed_global`) at ViT-H widths
    and batch 4 under a dp and a dp x tp mesh, against one device. Returns
    {name: (max abs difference, the largest batch the kernel's custom calls
    read, the batch of one data shard)}: the kernel is partitioned along the
    batch, so the last two agree."""
    import re

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from camouflaged_vlm_tpu.ops.attention import qkv_packed_global
    from camouflaged_vlm_tpu.parallel import make_mesh

    H, W, heads, d = KERNEL_SHAPE
    B, n = 4, len(devices)
    qkv, rel = kernel_inputs(B, 0.3)[:2]

    def f(qkv, rel):
        return qkv_packed_global(qkv, rel, d ** -0.5, heads, d, H, W)

    want = np.asarray(jax.jit(f)(qkv, rel), np.float32)
    out = {}
    for name, (nd, nm) in {f"dp{n}": (n, 1), f"dp{n // 2}xtp2": (n // 2, 2)}.items():
        mesh = make_mesh(n_data=nd, n_model=nm, devices=devices[: nd * nm])
        args = (jax.device_put(qkv, NamedSharding(mesh, P("data", None, "model"))),
                jax.device_put(rel, NamedSharding(mesh, P(None, "data"))))
        g = jax.jit(f, out_shardings=NamedSharding(mesh, P("data")))
        compiled = g.lower(*args).compile()
        calls = [ln for ln in compiled.as_text().splitlines() if "xla.gpu.triton" in ln]
        # the kernel's qkv operand is (batch, N, 3 * heads, d)
        batches = [int(m) for ln in calls
                   for m in re.findall(rf"\[(\d+),{H * W},{3 * heads},{d}\]", ln)]
        err = float(np.max(np.abs(np.asarray(compiled(*args), np.float32) - want)))
        local = max(batches) if batches else 0
        log(f"{name} global attention vs one device: max abs diff {err:.3e}; "
            f"{len(calls)} kernel call(s) reading batch {local} of {B}")
        out[name] = (err, local, B // nd)
    return out


def multi_check(model, cfg, devices, log=print):
    """dp (all devices) and dp x tp (n/2 x 2) training steps, and
    tensor-parallel eval, each against the same computation on ONE device.
    The five programs are lowered first and compiled concurrently.

    The steps use SGD with learning rate 1, so each updated trainable
    parameter is `p - grad` and the parameter difference IS the gradient
    difference. Returns {name: (relative loss or mask probability
    difference, relative L2 gradient or class probability difference)}."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from camouflaged_vlm_tpu.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu.factory import init_cascade_params, make_bank_inputs
    from camouflaged_vlm_tpu.parallel import make_mesh, shard_params
    from camouflaged_vlm_tpu.train import create_train_state, make_train_step
    from camouflaged_vlm_tpu.train.train_step import partition_params

    n = len(devices)
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES[:8], seed=SEED)
    host_params = jax.tree.map(np.asarray, init_cascade_params(model, seed=SEED))
    host_batch = _train_batch(cfg, n, SEED)
    tx = optax.sgd(1.0)

    def train_job(n_data, n_model):
        mesh = make_mesh(n_data=n_data, n_model=n_model, devices=devices[: n_data * n_model])
        state = create_train_state(shard_params(mesh, host_params), tx)
        data = NamedSharding(mesh, P("data"))
        repl = NamedSharding(mesh, P())
        batch = {k: jax.device_put(v, data) for k, v in host_batch.items()}
        batch.update({k: jax.device_put(np.asarray(v), repl) for k, v in bank.items()})
        with mesh:
            return jax.jit(make_train_step(model, tx)).lower(state, batch), (state, batch)

    def eval_job(n_model):
        mesh = make_mesh(n_data=1, n_model=n_model, devices=devices[:n_model])
        repl = NamedSharding(mesh, P())
        args = [shard_params(mesh, host_params)]
        args += [jax.device_put(host_batch[k][:2], repl)
                 for k in ("inp", "clip_image", "clip_mask")]
        args += [jax.device_put(np.asarray(bank[k]), repl)
                 for k in ("prefix", "suffix", "eot_indices", "bank_features")]
        with mesh:
            return jax.jit(model.infer_cascade).lower(*args), args

    jobs = {"train1": train_job(1, 1), f"dp{n}": train_job(n, 1),
            f"dp{n // 2}xtp2": train_job(n // 2, 2),
            "eval1": eval_job(1), f"tp{n}_eval": eval_job(n)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        compiled = dict(zip(jobs, pool.map(lambda j: j[0].compile(), jobs.values())))
    log(f"compiled {len(jobs)} programs concurrently in {time.perf_counter() - t0:.1f} s")

    def train(name):
        state, metrics = compiled[name](*jobs[name][1])
        return float(metrics["loss"]), jax.tree.map(np.asarray, state.trainable)

    def evaluate(name):
        probs, _, score = compiled[name](*jobs[name][1])
        return (np.asarray(probs, np.float32),
                np.asarray(jax.nn.softmax(score.astype(np.float32), -1)))

    out = {}
    loss1, tr1 = train("train1")
    g1 = [b - a for a, b in zip(jax.tree.leaves(partition_params(host_params)[0]),
                                jax.tree.leaves(tr1))]
    norm1 = np.sqrt(sum(float(np.sum(g * g)) for g in g1))
    gmax = max(float(np.max(np.abs(g))) for g in g1)
    for name in (f"dp{n}", f"dp{n // 2}xtp2"):
        loss, tr = train(name)
        dloss = abs(loss - loss1) / max(abs(loss1), 1e-6)
        diff = [a - b for a, b in zip(jax.tree.leaves(tr), jax.tree.leaves(tr1))]
        dgrad = np.sqrt(sum(float(np.sum(x * x)) for x in diff)) / norm1
        dmax = max(float(np.max(np.abs(x))) for x in diff) / gmax
        log(f"{name} train step vs one device: loss {loss:.5f} vs {loss1:.5f} "
            f"(relative dloss {dloss:.2e}), gradient |diff| / |grad| {dgrad:.2e} "
            f"(largest entry: {dmax:.2e} of max |grad|)")
        out[name] = (dloss, dgrad)

    p1, s1 = evaluate("eval1")
    pt, st = evaluate(f"tp{n}_eval")
    d = (float(np.max(np.abs(pt - p1))), float(np.max(np.abs(st - s1))))
    log(f"tp{n} eval vs one device: mask prob max diff {d[0]:.2e}, "
        f"class prob max diff {d[1]:.2e}")
    out[f"tp{n}_eval"] = d
    return out


def phase_multi(device):
    say("== phase 6: four cards (dp4, dp2 x tp2 training; tp4 eval) vs one card")
    import jax
    import jax.numpy as jnp

    if device["count"] < 4:
        fail(f"--multi needs 4 devices, found {device['count']}")
    devices = jax.devices()[:4]
    # The Pallas kernel sees only its batch shard under the mesh, and gives
    # the same numbers as on one device (the same per-row program).
    for name, (err, local, shard) in partition_check(devices, log=with_card).items():
        if local != shard or err > 1e-2:
            fail(f"{name}: global-attention kernel reads batch {local} (shard "
                 f"{shard}), diff {err}")
    say(f"full width, depth cut {MULTI_DEPTH}, bf16 (the Pallas global kernel on)")
    model, cfg = depth_cut(jnp.bfloat16, **MULTI_DEPTH)
    res = multi_check(model, cfg, devices, log=with_card)
    # bf16: sharded programs round their activations where one device
    # rounds them too, but sum in another order and with other GEMM tilings,
    # so results move by bf16 rounding (2^-9 relative per op). Eval keeps
    # the bounds of phase 3 (bf16 against float32, a larger gap than two
    # bf16 programs): mask probabilities within 0.25 at any pixel, class
    # probabilities within 5e-2. Training: loss within 2e-2 relative, the
    # gradient within 0.25 in L2 relative to its norm. The largest bf16
    # gradient term is the decoder's conv-bias sums over 1024^2 pixels,
    # which shards reorder: on four virtual CPU devices (tiny config) dp4
    # moved the gradient by 6.4e-2 in L2 (0.16 at one bias entry). A
    # sharding fault (a lost reduction, a wrong shard) moves them by O(1).
    tol = {"train": (2e-2, 0.25), "eval": (MASK_MAX_TOL, CLASS_PROB_TOL)}
    for name, (a, b) in res.items():
        ta, tb = tol["eval" if name.endswith("eval") else "train"]
        if not (a <= ta and b <= tb):
            fail(f"{name} diverges from one device: {a} {b} (tol {ta}, {tb})")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card phase (needs 4 GPUs)")
    args = p.parse_args()

    device = phase_environment()
    if args.multi:
        phase_multi(device)
    else:
        phase_kernel_check()
        model, cfg, params, bank = phase_inference()
        phase_serving(model, cfg, params, bank)
        del model, params
        phase_training()
    say("persistent compile cache: {} hits, {} programs written".format(
        *CACHE_EVENTS.values()))
    say(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()

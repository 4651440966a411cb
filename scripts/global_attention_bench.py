"""Global-block attention on the GPU: the XLA formulation against the
Pallas-Triton kernel, at SAM ViT-H widths (4096 tokens, 16 heads, d = 80).

First, at batch 2, it checks the kernel and the XLA formulation against
the float32 dense reference and times both, for bf16 and for float32
inputs (the dispatcher sends float32 to XLA; this is the measurement that
decides it). Then, for each batch size, it times one global block's bf16
attention forward both ways, in turns within this one process. Prints one
JSON line per measurement, each with the device and the card's name and
power limit.

    python scripts/global_attention_bench.py [--batches 1,8,32] [--tune]
    python scripts/global_attention_bench.py --batches "" --cascade 1,8

`--tune` also times a grid of (block_q, num_warps, num_stages) at batch 8.
`--cascade` times the whole bf16 cascade (`infer_cascade_with_text`) with
the kernel and with the XLA formulation in its global blocks, in turns.
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import subprocess
import time

import numpy as np


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="1,8,32")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--tune", action="store_true")
    p.add_argument("--cascade", default="", help="batch sizes, e.g. 1,8")
    args = p.parse_args()

    from camouflaged_vlm_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp

    from camouflaged_vlm_tpu.ops.attention import qkv_packed_global_xla
    from camouflaged_vlm_tpu.ops.global_attention_triton import global_attention_triton
    from camouflaged_vlm_tpu.ops.rel_pos import attention_with_decomposed_rel_pos
    from camouflaged_vlm_tpu.models.sam_encoder import rel_smajor_global

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    name_power = card()
    H = W = 64
    N, heads, d = H * W, 16, 80
    scale = d ** -0.5

    def emit(**kw):
        print(json.dumps({**kw, "device": device, "card": name_power}), flush=True)

    def inputs(B, seed=0, dtype=jnp.bfloat16):
        rng = np.random.default_rng(seed)
        qkv = jnp.asarray(rng.standard_normal((B, N, 3 * heads * d)) * 0.5, dtype)
        # rel-pos tables of std 0.3 (as in chip_smoke.py's phase 2),
        # projected by the (unscaled) queries
        rph = jnp.asarray(rng.standard_normal((2 * H - 1, d)) * 0.3, jnp.float32)
        rpw = jnp.asarray(rng.standard_normal((2 * W - 1, d)) * 0.3, jnp.float32)
        qh = qkv[:, :, : heads * d].reshape(B, H, W, heads, d)
        rel = rel_smajor_global(qh, rph, rpw, H, W)
        return qkv, rel, rph, rpw

    def xla(qkv, rel):
        return qkv_packed_global_xla(qkv, rel, scale, heads, d, H, W)

    def kernel(bq=64, nw=4, ns=3):
        return lambda qkv, rel: global_attention_triton(
            qkv, rel, scale, heads, d, H, W, block_q=bq, num_warps=nw, num_stages=ns
        )

    def timed(fn, *a):
        f = jax.jit(fn)
        t0 = time.perf_counter()
        jax.block_until_ready(f(*a))
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(f(*a))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = f(*a)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / args.iters * 1e3, compile_s

    # batch 2, bf16 and float32: errors against the float32 dense reference
    # (precision "highest") and times, xla / kernel / kernel / xla
    for dtype in (jnp.bfloat16, jnp.float32):
        qkv, rel, rph, rpw = inputs(2, dtype=dtype)
        r = qkv.astype(jnp.float32).reshape(2, N, 3, heads, d)
        q, k, v = (jnp.moveaxis(r[:, :, i], 2, 1) for i in range(3))
        with jax.default_matmul_precision("highest"):
            want = attention_with_decomposed_rel_pos(q, k, v, rph, rpw, (H, W), scale)
        want = jnp.moveaxis(want, 1, 2).reshape(2, N, heads * d)
        for turn, (name, fn) in enumerate(
            [("xla", xla), ("triton", kernel()), ("triton", kernel()), ("xla", xla)]
        ):
            try:
                err = float(jnp.max(jnp.abs(jax.jit(fn)(qkv, rel).astype(jnp.float32) - want)))
                ms, _ = timed(fn, qkv, rel)
                emit(check="vs_f32_reference", impl=name, dtype=jnp.dtype(dtype).name, B=2,
                     turn=turn, max_abs_err=err, ms_per_block=ms)
            except Exception as e:  # a tile configuration the dtype cannot take
                emit(check="vs_f32_reference", impl=name, dtype=jnp.dtype(dtype).name,
                     error=f"{type(e).__name__}: {str(e)[:300]}")
        del qkv, rel, want

    for B in [int(b) for b in args.batches.split(",") if b]:
        qkv, rel, _, _ = inputs(B, seed=B)
        for turn, (name, fn) in enumerate(
            [("xla", xla), ("triton", kernel()), ("triton", kernel()), ("xla", xla)]
        ):
            try:
                ms, cs = timed(fn, qkv, rel)
                emit(impl=name, B=B, turn=turn, ms_per_block=ms, compile_s=cs)
            except Exception as e:  # XLA's dense scores may not fit
                emit(impl=name, B=B, turn=turn, error=f"{type(e).__name__}: {str(e)[:200]}")
        del qkv, rel

    if args.tune:
        qkv, rel, _, _ = inputs(8, seed=8)
        for bq in (64, 128):
            for nw in (4, 8):
                for ns in (1, 2, 3):
                    try:
                        ms, cs = timed(kernel(bq, nw, ns), qkv, rel)
                        emit(tune=dict(block_q=bq, num_warps=nw, num_stages=ns),
                             B=8, ms_per_block=ms)
                    except Exception as e:
                        emit(tune=dict(block_q=bq, num_warps=nw, num_stages=ns),
                             B=8, error=f"{type(e).__name__}: {str(e)[:200]}")

    if args.cascade:
        cascade_ab([int(b) for b in args.cascade.split(",")], args.iters, emit)


def cascade_ab(batches, iters, emit):
    """Whole-cascade img/s with the global blocks on the kernel or on the
    XLA formulation (swapped in for the kernel), in turns: xla, kernel,
    kernel, xla."""
    import jax
    import jax.numpy as jnp

    import camouflaged_vlm_tpu.ops.attention as attn
    from camouflaged_vlm_tpu.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu.factory import (
        attach_rel_cache, build_full_cascade, init_cascade_params,
        make_bank_inputs, make_example_inputs,
    )

    kernel = attn.global_attention_triton

    model, cfg = build_full_cascade(dtype=jnp.bfloat16)
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES)
    params = init_cascade_params(model)
    params = jax.tree.map(
        lambda p: p.astype(jnp.bfloat16) if p.dtype == jnp.float32 and p.ndim >= 2 else p,
        params,
    )
    params = attach_rel_cache(params, cfg)
    tf = jax.jit(model.encode_class_text_features)(
        params, bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"])
    for B in batches:
        inp, cimg, cmask = make_example_inputs(cfg, B)
        progs = {}
        for impl, fn in (("xla", attn.qkv_packed_global_xla), ("triton", kernel)):
            attn.global_attention_triton = fn  # read when the program traces
            t0 = time.perf_counter()
            progs[impl] = jax.jit(model.infer_cascade_with_text).lower(
                params, inp, cimg, cmask, tf).compile()
            emit(cascade_compile=impl, B=B, compile_s=time.perf_counter() - t0)
        attn.global_attention_triton = kernel
        for turn, impl in enumerate(("xla", "triton", "triton", "xla")):
            f = progs[impl]
            jax.block_until_ready(f(params, inp, cimg, cmask, tf))
            t0 = time.perf_counter()
            for _ in range(iters):
                out = f(params, inp, cimg, cmask, tf)
            jax.block_until_ready(out)
            sec = (time.perf_counter() - t0) / iters
            emit(cascade=impl, B=B, turn=turn, ms_per_batch=sec * 1e3,
                 images_per_sec=B / sec)


if __name__ == "__main__":
    main()

"""Profiling CLI: per-stage device times + a jax.profiler trace.

The reference has no profiling subsystem (SURVEY.md §5.1 — only a wall-clock
Timer). Here: `--stages` times the SAM encoder and one CLIP pass separately;
`--trace` captures a jax.profiler trace and prints the operations that took
the most device time (read with `jax.profiler.ProfileData`); a plain run
prints end-to-end latency. Every timing ends in `jax.block_until_ready`.
"""

from __future__ import annotations

import argparse
import collections
import glob
import time


def _timed(fn, args, iters, warmup, name=""):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    print(f"{name:32s} {dt*1e3:9.2f} ms")
    return dt


def print_device_breakdown(logdir: str, top: int = 15) -> None:
    """Sum device-plane event durations by name from the newest trace."""
    import jax

    pbs = sorted(glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True))
    if not pbs:
        print("no xplane capture found under", logdir)
        return
    prof = jax.profiler.ProfileData.from_file(pbs[-1])
    agg = collections.Counter()
    for plane in prof.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                agg[ev.name] += ev.duration_ns
    total = sum(agg.values())
    if not total:
        print("no device events in", pbs[-1])
        return
    print(f"total device event time: {total/1e6:.1f} ms (all traced iterations)")
    for name, t in agg.most_common(top):
        print(f"  {name[:60]:60s} {t/1e6:9.2f} ms ({100*t/total:.1f}%)")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--stages", action="store_true", help="time each stage")
    p.add_argument("--trace", action="store_true", help="capture a jax.profiler trace")
    p.add_argument("--trace-dir", default="traces/profile")
    args = p.parse_args()

    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp

    from ..factory import (
        attach_rel_cache,
        build_full_cascade,
        build_tiny_cascade,
        init_cascade_params,
        make_bank_inputs,
        make_example_inputs,
    )
    from ..data.ovcamo import TEST_CLASS_NAMES

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    model, cfg = (build_tiny_cascade if args.tiny else build_full_cascade)(dtype=dtype)
    bank = make_bank_inputs(cfg, TEST_CLASS_NAMES)
    params = attach_rel_cache(init_cascade_params(model), cfg)
    text_features = jax.jit(model.encode_class_text_features)(
        params, bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"]
    )
    inp, cimg, cmask = make_example_inputs(cfg, args.batch)
    full = jax.jit(model.infer_cascade_with_text)

    if args.stages:
        enc = jax.jit(model.encode_image)
        _timed(enc, (params, inp), args.iters, args.warmup, "sam encoder")
        clip = jax.jit(model.classify)
        _timed(clip, (params, cimg, cmask, text_features), args.iters, args.warmup,
               "clip classify (1 pass)")

    if args.trace:
        jax.block_until_ready(full(params, inp, cimg, cmask, text_features))
        jax.profiler.start_trace(args.trace_dir)
        for _ in range(args.iters):
            out = full(params, inp, cimg, cmask, text_features)
        jax.block_until_ready(out)
        jax.profiler.stop_trace()
        print(f"trace written to {args.trace_dir}")
        print_device_breakdown(args.trace_dir)
    else:
        dt = _timed(full, (params, inp, cimg, cmask, text_features),
                    args.iters, args.warmup, "FULL fused cascade")
        print(f"throughput: {args.batch/dt:.2f} img/s")


if __name__ == "__main__":
    main()

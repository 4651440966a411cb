"""Serving throughput + latency under concurrent load (GPU).

bench.py times the bare device pipeline; this measures the SERVING stack —
`camouflaged_vlm_tpu.serve.InferenceEngine` with its queue, deadline
coalescing, bucket padding and host<->device transfers — under closed-loop
concurrent clients, the way a deployed server actually sees traffic. Each of
K client threads submits a preprocessed image, waits for its result, and
immediately submits the next, for N total requests. Reports steady-state
img/s plus p50/p95/p99 request latency and the realised batch histogram.

The reference has no serving counterpart (its eval loop is serialised
batch-1, `/root/reference/test_ovcos_maskdecoder_edge.py:68-143`); the
comparison that matters is against OUR bench.py device ceiling — the gap is
the serving overhead (queueing + padding + per-batch host fetch).

Usage:
  python scripts/serve_throughput.py                  # full ViT-H, GPU
  python scripts/serve_throughput.py --tiny           # smoke (CPU ok)
  python scripts/serve_throughput.py --clients 32 --requests 256
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import threading
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--clients", type=int, default=32, help="concurrent closed-loop clients")
    p.add_argument("--requests", type=int, default=256, help="timed requests total")
    p.add_argument("--warm-requests", type=int, default=32)
    p.add_argument("--buckets", default="1,2,4,8,16,32")
    p.add_argument("--max-delay-ms", type=float, default=10.0)
    p.add_argument(
        "--max-inflight", type=int, default=2,
        help="dispatched-but-unfetched batch bound (deeper pipelining hides "
        "the per-batch fetch)",
    )
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--mask-dtype", default="uint8", choices=["uint8", "float16"])
    p.add_argument(
        "--bytes", action="store_true",
        help="drive predict_bytes with encoded JPEGs: measures the FULL host "
        "path (decode + resizes + mask-back-resize), not just the engine; "
        "toggle the native fast path with CVLM_NATIVE_PREPROC=0/1",
    )
    p.add_argument(
        "--engine-only", action="store_true",
        help="engine ceiling without HTTP/JPEG: drive the "
        "batcher/completer via serve.bench_engine with a shape-keyed device "
        "input cache (each bucket uploads once) and a return_mask=False "
        "program, so per-batch device->host traffic is just class ids/logits — "
        "what remains is engine orchestration + compute",
    )
    p.add_argument(
        "--engine-mask", action="store_true",
        help="with --engine-only: keep the mask output in the program (its "
        "device->host fetch is then on the clock)",
    )
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from camouflaged_vlm_tpu.cli.common import assemble_cascade
    from camouflaged_vlm_tpu.data.loader import native_preproc_enabled
    from camouflaged_vlm_tpu.data.ovcamo import TEST_CLASS_NAMES
    from camouflaged_vlm_tpu.serve import InferenceEngine, ServeConfig

    classnames = TEST_CLASS_NAMES
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    model, cfg, params, bank = assemble_cascade(
        classnames, dtype=dtype, tiny=args.tiny
    )
    buckets = tuple(int(b) for b in args.buckets.split(","))
    eng = InferenceEngine(
        model, cfg, params, bank, classnames,
        ServeConfig(
            buckets=buckets,
            max_delay_ms=args.max_delay_ms,
            mask_dtype=args.mask_dtype,
            max_inflight=args.max_inflight,
            return_mask=args.engine_mask or not args.engine_only,
        ),
    )

    if args.engine_only:
        from camouflaged_vlm_tpu.serve import bench_engine

        t0 = time.perf_counter()
        eng.warmup()
        print(f"[engine-only] warmup (compile) {time.perf_counter() - t0:.0f}s",
              flush=True)
        # short un-timed lead-in so the pipeline is primed
        bench_engine(eng, n_images=2 * buckets[-1], stage_inputs=True)
        rep = bench_engine(eng, n_images=args.requests, stage_inputs=True)
        rep["buckets"] = list(buckets)
        # program-only rate for the SAME compiled program (bench.py
        # methodology: enqueue all executions, wait for the last) — the
        # delta vs images_per_sec above is the engine-orchestration +
        # per-batch-fetch overhead
        b = buckets[-1]
        d_inp = jnp.asarray(np.zeros((b, cfg.inp_size, cfg.inp_size, 3), np.uint8))
        d_cimg = jnp.asarray(np.zeros((b, cfg.clip_size, cfg.clip_size, 3), np.uint8))
        run = lambda: eng._run(eng._params, eng._text_features, d_inp, d_cimg)
        jax.block_until_ready(run())  # warm
        n_prog = 8
        t0 = time.perf_counter()
        outs = [run() for _ in range(n_prog)]
        jax.block_until_ready(outs)
        rep["program_only_images_per_sec"] = n_prog * b / (time.perf_counter() - t0)
        print(json.dumps({"serve_engine_only": rep}, default=float), flush=True)
        eng.close()
        return

    rng = np.random.default_rng(0)
    if args.bytes:
        # encoded-JPEG pool at a typical OVCamo source size: the clients pay
        # the whole host path per request (decode, 1024/336 resizes,
        # normalisation in-graph, mask resized back to 500x700)
        import io as _io

        from PIL import Image

        pool = []
        for _ in range(8):
            buf = _io.BytesIO()
            Image.fromarray(
                rng.integers(0, 256, (500, 700, 3), dtype=np.uint8)
            ).save(buf, "JPEG", quality=90)
            pool.append(buf.getvalue())
    else:
        # a small pool of preprocessed inputs, cycled by the clients
        # (host preprocessing is measured by --bytes / eval_throughput.py;
        # here we isolate the engine + device path)
        pool = [
            (
                rng.integers(0, 256, (cfg.inp_size, cfg.inp_size, 3), dtype=np.uint8),
                rng.integers(0, 256, (cfg.clip_size, cfg.clip_size, 3), dtype=np.uint8),
            )
            for _ in range(8)
        ]

    print(f"[serve-bench] warming buckets {buckets} ...", file=_sys.stderr, flush=True)
    t0 = time.monotonic()
    eng.warmup()
    print(f"[serve-bench] warmup {time.monotonic() - t0:.1f}s", file=_sys.stderr, flush=True)

    latencies: list = []
    lat_lock = threading.Lock()
    counter = {"left": args.warm_requests + args.requests}

    def client(idx: int):
        while True:
            with lat_lock:
                if counter["left"] <= 0:
                    return
                counter["left"] -= 1
                timed = counter["left"] < args.requests  # first warm ones untimed
            t = time.monotonic()
            if args.bytes:
                eng.predict_bytes(pool[idx % len(pool)], timeout=600)
            else:
                inp, cimg = pool[idx % len(pool)]
                eng.submit(inp, cimg).result(timeout=600)
            if timed:
                with lat_lock:
                    latencies.append(time.monotonic() - t)

    t_start = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(args.clients)]
    for t in threads:
        t.start()
    # timing starts at the first TIMED request; approximate by subtracting the
    # warm fraction measured from total wall (warm and timed interleave)
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    total = args.warm_requests + args.requests
    ips = total / wall  # closed-loop steady state: warm requests are identical load

    lat = np.sort(np.asarray(latencies)) * 1e3
    stats = eng.stats()

    # Interactive-path floor: a SINGLE closed-loop client after the load
    # drains — every request coalesces alone and rides bucket 1, so this
    # p50 is the per-request latency floor.
    b1_lat = []
    for i in range(24):
        t = time.monotonic()
        if args.bytes:
            eng.predict_bytes(pool[i % len(pool)], timeout=600)
        else:
            inp, cimg = pool[i % len(pool)]
            eng.submit(inp, cimg).result(timeout=600)
        b1_lat.append(time.monotonic() - t)
    b1 = np.sort(np.asarray(b1_lat[4:])) * 1e3  # drop coalescing warm-in
    eng.close()
    print(json.dumps({
        "serve_images_per_sec": round(ips, 3),
        "clients": args.clients,
        "requests_timed": len(latencies),
        "latency_ms": {
            "p50": round(float(lat[len(lat) // 2]), 1),
            "p95": round(float(lat[int(len(lat) * 0.95)]), 1),
            "p99": round(float(lat[min(len(lat) - 1, int(len(lat) * 0.99))]), 1),
        },
        "b1_latency_ms": {
            "p50": round(float(b1[len(b1) // 2]), 1),
            "max": round(float(b1[-1]), 1),
        },
        "bucket_latency_ms": {
            b: {k: round(float(v2), 1) for k, v2 in v.items() if k != "sum"}
            for b, v in stats["bucket_latency_ms"].items()
        },
        "batch_size_hist": stats["batch_size_hist"],
        "pad_fraction": round(stats["pad_fraction"], 4),
        "mask_dtype": args.mask_dtype,
        "config": "tiny" if args.tiny else "vit-h-1024",
        "mode": "bytes" if args.bytes else "preprocessed",
        "native_preproc": bool(args.bytes) and native_preproc_enabled(),
    }))


if __name__ == "__main__":
    main()

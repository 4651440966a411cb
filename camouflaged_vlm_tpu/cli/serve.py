"""HTTP model server for the OVCOS cascade.

Mounts `camouflaged_vlm_tpu.serve.InferenceEngine` (micro-batching fused
cascade — see that module's docstring) behind a stdlib threaded HTTP server.
No reference counterpart: the reference ships only a batch-1 demo script
(`/root/reference/demo.py`); this is the deployment entry the framework adds.

Endpoints:
  POST /predict        body = raw image bytes (any PIL-decodable format).
                       Query params: mask=0 omits the mask from the response.
                       -> JSON {class, class_id, score, latency_ms,
                                mask_png_b64?}
  GET  /healthz        200 "ok" once the bucket programs are compiled,
                       503 "warming" before that.
  GET  /stats          JSON batching/latency counters.
  GET  /metrics        the same counters in Prometheus text format.
  GET  /classnames     JSON list of the class split being served.

SIGTERM/SIGINT drain gracefully: the server stops accepting, queued
requests still run, then the process exits.

Usage:
  python -m camouflaged_vlm_tpu.cli.serve --port 8000 \
      --cascade-ckpt model_epoch_best.pth --clip-ckpt ViT-L-14-336px.pt \
      --text-bank TestCamoPromptsTextFeaturesViTB-14-336.pth
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
from PIL import Image

from ..data.ovcamo import TEST_CLASS_NAMES
from ..serve import InferenceEngine, ServeConfig
from ..utils.logging import log
from .common import assemble_cascade


def make_handler(engine: InferenceEngine, quiet: bool = False):
    class Handler(BaseHTTPRequestHandler):
        # ThreadingHTTPServer runs one thread per connection; the engine's
        # queue provides the backpressure.
        protocol_version = "HTTP/1.1"
        # idle keep-alive connections drop after this, so the graceful
        # shutdown's handler-thread join (server_close) is bounded
        timeout = 30

        def _drain_body(self) -> None:
            """Read and discard the request body so a keep-alive connection
            stays in sync after an error response (unread bytes would be
            parsed as the next request line)."""
            length = int(self.headers.get("Content-Length", 0) or 0)
            while length > 0:
                chunk = self.rfile.read(min(length, 1 << 20))
                if not chunk:
                    break
                length -= len(chunk)

        def log_message(self, fmt, *args):
            if not quiet:
                log("[serve] " + fmt % args)

        def _json(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                if engine.ready():
                    self._json(200, {"status": "ok"})
                else:
                    self._json(503, {"status": "warming"})
            elif path == "/stats":
                self._json(200, engine.stats())
            elif path == "/metrics":
                # Prometheus text exposition format
                s = engine.stats()
                lines = [
                    f"cvlm_requests_total {s['requests']}",
                    f"cvlm_batches_total {s['batches']}",
                    f"cvlm_batched_images_total {s['batched_images']}",
                    f"cvlm_errors_total {s['errors']}",
                    f"cvlm_latency_ms_mean {s.get('latency_ms_mean', 0.0):.3f}",
                    f"cvlm_latency_ms_max {s['latency_ms_max']:.3f}",
                    f"cvlm_pad_fraction {s['pad_fraction']:.4f}",
                    f"cvlm_ready {int(s['ready'])}",
                ] + [
                    f'cvlm_batches_by_size_total{{size="{k}"}} {v}'
                    for k, v in sorted(s["batch_size_hist"].items())
                ]
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/classnames":
                self._json(200, engine.classnames)
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/predict":
                self._drain_body()
                self._json(404, {"error": f"unknown path {parsed.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._json(400, {"error": "empty body; send raw image bytes"})
                    return
                data = self.rfile.read(length)
                # decode is validated inside predict_bytes (native fast path
                # when built, PIL otherwise); a bad container raises there
            except Exception as e:
                self._json(400, {"error": f"unreadable body: {e}"})
                return
            want_mask = parse_qs(parsed.query).get("mask", ["1"])[0] != "0"
            t0 = time.monotonic()
            try:
                out = engine.predict_bytes(data, want_mask=want_mask)
            except (ValueError, OSError) as e:
                self._json(400, {"error": f"undecodable image: {e}"})
                return
            except Exception as e:
                self._json(500, {"error": f"inference failed: {e}"})
                return
            resp = {
                "class": out["class"],
                "class_id": out["class_id"],
                "score": out["score"],
                "latency_ms": round((time.monotonic() - t0) * 1e3, 2),
            }
            if want_mask:
                buf = io.BytesIO()
                Image.fromarray(out["mask"]).save(buf, format="PNG")
                resp["mask_png_b64"] = base64.b64encode(buf.getvalue()).decode()
            self._json(200, resp)

    return Handler


def serve_forever(engine: InferenceEngine, host: str, port: int, quiet: bool = False):
    """Build the HTTP server; returns (server, thread) with warmup running
    in the background so /healthz reports readiness honestly."""
    server = ThreadingHTTPServer((host, port), make_handler(engine, quiet=quiet))
    # non-daemon handler threads + block_on_close: server_close() joins
    # in-flight handlers, so a graceful shutdown never truncates a response
    # mid-write (the Handler.timeout above bounds the join on idle
    # keep-alive connections)
    server.daemon_threads = False
    threading.Thread(target=engine.warmup, daemon=True).start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def main():
    import jax.numpy as jnp

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--cascade-ckpt", default=None)
    p.add_argument("--sam-ckpt", default=None)
    p.add_argument("--clip-ckpt", default=None)
    p.add_argument("--maple-ckpt", default=None)
    p.add_argument("--text-bank", default=None)
    p.add_argument("--classnames", default=None, help="comma-separated; default OVCamo test split")
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke test)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument(
        "--buckets", default="1,4,16,32",
        help="compiled batch sizes, ascending (default: bench-derived — "
        "throughput saturates at 32, small buckets bound latency; PERF.md)",
    )
    p.add_argument("--max-delay-ms", type=float, default=10.0)
    p.add_argument(
        "--data-parallel", action="store_true",
        help="shard each batch over all chips (buckets must divide evenly)",
    )
    p.add_argument(
        "--n-model", type=int, default=1,
        help="tensor-parallel axis size (Megatron rules; data x model mesh)",
    )
    p.add_argument(
        "--mask-dtype", default="uint8", choices=["uint8", "float16"],
        help="mask transfer dtype; uint8 halves device->host bytes and is "
        "lossless for the 8-bit PNG response",
    )
    args = p.parse_args()
    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    classnames = args.classnames.split(",") if args.classnames else TEST_CLASS_NAMES
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    model, cfg, params, bank = assemble_cascade(
        classnames,
        cascade_ckpt=args.cascade_ckpt,
        sam_ckpt=args.sam_ckpt,
        clip_ckpt=args.clip_ckpt,
        maple_ckpt=args.maple_ckpt,
        text_bank_path=args.text_bank,
        dtype=dtype,
        tiny=args.tiny,
    )
    mesh = None
    if args.data_parallel or args.n_model > 1:
        from ..parallel import make_mesh

        mesh = make_mesh(n_model=args.n_model)
        log(
            f"[serve] mesh data={mesh.shape['data']} x model={mesh.shape['model']}"
        )
    engine = InferenceEngine(
        model, cfg, params, bank, classnames,
        ServeConfig(
            buckets=tuple(int(b) for b in args.buckets.split(",")),
            max_delay_ms=args.max_delay_ms,
            mask_dtype=args.mask_dtype,
        ),
        mesh=mesh,
    )
    server, thread = serve_forever(engine, args.host, args.port)
    log(f"[serve] listening on {args.host}:{args.port} (warming {args.buckets})")

    import signal

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    # graceful drain: stop accepting, run out the queue, resolve in-flight
    # futures, then join handler threads so every drained response is fully
    # written before the process exits
    log("[serve] shutting down (draining queue)")
    server.shutdown()
    engine.close()
    server.server_close()


if __name__ == "__main__":
    main()

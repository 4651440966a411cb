"""Production serving: micro-batching inference engine for the fused cascade.

The reference has no serving story — its eval entry is a serialised batch-1
CUDA loop (`/root/reference/test_ovcos_maskdecoder_edge.py:68-143`). This
module serves the cascade as one compiled program per batch bucket:

- Requests are coalesced into the largest batch available within a small
  deadline window and padded to a fixed set of pre-compiled batch *buckets*
  (XLA programs are shape-specialised; a new batch size means a new compile,
  so production traffic must ride a closed set of shapes).
- Each batch runs as ONE fused device program (SAM encoder -> CLIP pass 1 ->
  edge decoder -> alpha handoff -> CLIP pass 2), identical to
  `cli/evaluate.run`: uint8 transfer with in-graph normalisation, per-class
  text features encoded once at startup, param-derived rel-pos tables hoisted.
- Host preprocessing (PIL resize to uint8) runs on the caller's thread; the
  batching worker only stacks arrays and dispatches (async), and a separate
  completion thread performs the blocking result download — so batch k+1's
  preprocessing + upload + compute overlap batch k's download; the
  optional uint8 mask return halves the largest response tensor.

- With a `mesh`, each batch is sharded over the data axis and params are
  replicated — one request batch fans out across every device (GSPMD inserts
  the transfers; the reference's eval loop is single-GPU by construction).

`InferenceEngine` is transport-agnostic (futures in, results out);
`cli/serve.py` mounts it behind a stdlib HTTP front end.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .data import native as _nat
from .data import native_pipeline as _npp
from .data.loader import native_preproc_enabled
from .data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ONES_ALPHA_VALUE,
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    clip_image_resized_u8,
    sam_image_resized_u8,
)
from .factory import attach_rel_cache


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Batching policy.

    buckets: allowed (pre-compilable) batch sizes, ascending. A batch of n
        requests runs at the smallest bucket >= n, padded by repeating the
        last row (pad rows are discarded; padding with real data keeps the
        program free of degenerate values).
    max_delay_ms: how long the worker holds the first request of a batch
        waiting for more to coalesce. The latency/throughput knob.
    queue_capacity: backpressure bound — submit() blocks when this many
        requests are already queued.
    mask_dtype: dtype of the returned mask probabilities. "float16" (2
        bytes/px) by default; "uint8" halves the device->host bytes again
        — exactly lossless for any 8-bit image output (PNG/overlay), only
        programmatic consumers of raw probabilities should keep float16.
    max_inflight: dispatched-but-unfetched batch bound. Dispatch is async
        (jax queues the program and returns), so the batcher can stack and
        ship batch k+1 while batch k's results are still downloading — the
        completion thread below fetches in order. >1 overlaps host<->device
        transfer with compute; the bound caps device-side input buffers.
    return_mask: compile the mask output out of the program entirely when
        False. Classification-only deployments (predict_* want_mask=False
        clients) then skip the mask's device->host transfer — the largest
        response tensor (1024^2 * 2 B/image fp16) — not just its host-side
        resize; futures resolve to (None, class_id, logits).
    """

    # Large buckets carry throughput while the small ones bound interactive
    # latency (a lone request pads to 1, never to 32). Larger buckets add
    # coalescing delay (max_delay_ms) under light load. These defaults are
    # not measured on the H100 yet; override per deployment via
    # `cli/serve.py --buckets`.
    buckets: Tuple[int, ...] = (1, 4, 16, 32)
    max_delay_ms: float = 10.0
    queue_capacity: int = 256
    mask_dtype: str = "float16"
    max_inflight: int = 2
    return_mask: bool = True

    def __post_init__(self):
        assert self.buckets == tuple(sorted(self.buckets)) and self.buckets, (
            "buckets must be a non-empty ascending tuple"
        )
        assert self.mask_dtype in ("float16", "uint8"), self.mask_dtype
        assert self.max_inflight >= 1, self.max_inflight


class _Request:
    __slots__ = ("inp", "cimg", "future", "t_enqueue")

    def __init__(self, inp: np.ndarray, cimg: np.ndarray):
        self.inp = inp
        self.cimg = cimg
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()


_SENTINEL = object()


class InferenceEngine:
    """Micro-batching server core around one fused cascade program.

    Args mirror `cli.common.assemble_cascade`'s outputs: a built model,
    its config, host-or-device params, and the class prompt bank.
    """

    def __init__(
        self,
        model,
        cfg,
        params,
        bank: Dict[str, jnp.ndarray],
        classnames: Sequence[str],
        serve_cfg: ServeConfig = ServeConfig(),
        mesh=None,
    ):
        self.model = model
        self.cfg = cfg
        self.classnames = list(classnames)
        self.serve_cfg = serve_cfg
        self.mesh = mesh

        self._params = attach_rel_cache(params, cfg)
        if mesh is not None:
            # Multi-device serving: each batch sharded over the mesh's data
            # axis, params sharded by the Megatron partition rules (pure
            # replication when the model axis is 1; with a model axis the
            # per-block weights tensor-parallelise for latency scaling).
            from jax.sharding import NamedSharding, PartitionSpec as P

            from .parallel import shard_params

            n_data = mesh.shape["data"]
            bad = [b for b in serve_cfg.buckets if b % n_data]
            assert not bad, (
                f"buckets {bad} not divisible by the data axis ({n_data}); "
                f"every compiled batch shape must shard evenly"
            )
            self._params = shard_params(mesh, self._params)
            batch_sharding = NamedSharding(mesh, P("data"))
            self._put = lambda a: jax.device_put(a, batch_sharding)
        else:
            self._put = lambda a: a
        # Per-class text features are image-independent: encode once at
        # startup, not per request (the reference reruns the text tower
        # every image).
        self._text_features = jax.jit(model.encode_class_text_features)(
            self._params,
            bank["prefix"],
            bank["suffix"],
            bank["eot_indices"],
            bank["bank_features"],
        )

        clip_size = cfg.clip_size

        @jax.jit
        def _run(params, text_features, inp_u8, cimg_u8):
            inp = (inp_u8.astype(jnp.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
            cimg = (
                cimg_u8.astype(jnp.float32) / 255.0 - OPENAI_CLIP_MEAN
            ) / OPENAI_CLIP_STD
            cmask = jnp.full((inp_u8.shape[0], clip_size, clip_size, 1), ONES_ALPHA_VALUE)
            probs, pred, score = model.infer_cascade_with_text(
                params, inp, cimg, cmask, text_features
            )
            if not serve_cfg.return_mask:
                # classification-only program: the mask (the dominant
                # response tensor) never leaves the device — XLA DCEs any
                # mask-only tail work too
                return pred, score
            # fp16 halves device->host mask traffic vs f32 (~3e-4 resolution,
            # far below any threshold's quantisation); uint8 halves it again
            # for image-output consumers.
            if serve_cfg.mask_dtype == "uint8":
                m = jnp.round(probs * 255.0).astype(jnp.uint8)
            else:
                m = probs.astype(jnp.float16)
            return m, pred, score

        self._run = _run

        self._queue: "queue.Queue" = queue.Queue(maxsize=serve_cfg.queue_capacity)
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "batches": 0,
            "batched_images": 0,  # includes pad rows
            "errors": 0,
            "batch_size_hist": {},  # real (unpadded) sizes
            "latency_ms_sum": 0.0,
            "latency_ms_max": 0.0,
            # per-BUCKET request latency (count/sum/max): ties observed
            # latency to the compiled batch size a request actually rode —
            # the b1 row is the interactive-path floor (PERF.md latency table)
            "bucket_latency_ms": {},
        }
        self._ready = threading.Event()
        self._stop = False
        # serialises submit()'s stop-check-then-put against close()'s
        # stop-set-then-sentinel: without it a request racing with shutdown
        # can land behind the drain and its future would hang forever
        self._submit_lock = threading.Lock()
        # dispatched-but-unfetched batches: the batcher stacks + ships batch
        # k+1 while the completer is still downloading batch k's results
        # (jax dispatch is async; np.asarray is the blocking fetch)
        self._inflight: "queue.Queue" = queue.Queue(maxsize=serve_cfg.max_inflight)
        self._worker = threading.Thread(
            target=self._worker_loop, name="cvlm-serve-batcher", daemon=True
        )
        self._completer = threading.Thread(
            target=self._completer_loop, name="cvlm-serve-completer", daemon=True
        )
        self._worker.start()
        self._completer.start()

    # ---- public API ----

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Pre-compile the bucket programs, so a warm server answers its
        first request at steady-state latency."""
        cfg = self.cfg
        for b in buckets if buckets is not None else self.serve_cfg.buckets:
            out = self._run(
                self._params,
                self._text_features,
                self._put(np.zeros((b, cfg.inp_size, cfg.inp_size, 3), np.uint8)),
                self._put(np.zeros((b, cfg.clip_size, cfg.clip_size, 3), np.uint8)),
            )
            jax.tree.map(np.asarray, out)
        self._ready.set()

    def ready(self) -> bool:
        return self._ready.is_set()

    def submit(self, inp_u8: np.ndarray, cimg_u8: np.ndarray) -> Future:
        """Enqueue one preprocessed image pair.

        inp_u8: (inp_size, inp_size, 3) uint8; cimg_u8: (clip_size,
        clip_size, 3) uint8. Returns a Future resolving to
        (mask_probs (H, W) `serve_cfg.mask_dtype`, class_id int,
        class_logits (N,) float32).
        Blocks when queue_capacity requests are pending (backpressure).
        """
        cfg = self.cfg
        assert inp_u8.shape == (cfg.inp_size, cfg.inp_size, 3), inp_u8.shape
        assert cimg_u8.shape == (cfg.clip_size, cfg.clip_size, 3), cimg_u8.shape
        req = _Request(np.ascontiguousarray(inp_u8), np.ascontiguousarray(cimg_u8))
        # holding the lock across the (possibly blocking) put is safe: the
        # worker keeps draining the queue, so a full queue always makes
        # progress and the lock is released
        with self._submit_lock:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._queue.put(req)
        return req.future

    def predict_pil(
        self,
        img,
        timeout: Optional[float] = None,
        want_mask: bool = True,
    ) -> Dict:
        """Preprocess one PIL image, run it through the batcher, and return
        a response dict with the mask resized back to the input resolution
        (same host path as `cli/demo.py`). want_mask=False skips the
        original-resolution mask resize (classification-only clients)."""
        img = img.convert("RGB")
        w, h = img.size
        fut = self.submit(
            sam_image_resized_u8(img, self.cfg.inp_size),
            clip_image_resized_u8(img, self.cfg.clip_size),
        )
        return self._respond(fut, w, h, timeout, native=False, want_mask=want_mask)

    def predict_bytes(
        self,
        data: bytes,
        timeout: Optional[float] = None,
        want_mask: bool = True,
    ) -> Dict:
        """predict_pil on raw JPEG/PNG bytes, using the native (libcvtpre)
        decode+resize fast path when built — bit-identical output, but the
        whole preprocess runs in C with the GIL released, so concurrent
        request handlers don't serialise on host preprocessing.  Falls back
        to PIL per request (library absent, exotic container)."""
        if native_preproc_enabled():
            img = _nat.decode(data, 3)
            if img is not None:
                h, w = img.shape[:2]
                fut = self.submit(
                    _npp.sam_image_resized_u8(img, self.cfg.inp_size),
                    _npp.clip_image_resized_u8(img, self.cfg.clip_size),
                )
                return self._respond(
                    fut, w, h, timeout, native=True, want_mask=want_mask
                )
        import io as _io

        from PIL import Image

        return self.predict_pil(Image.open(_io.BytesIO(data)), timeout, want_mask)

    def _respond(
        self, fut: Future, w: int, h: int, timeout, native: bool, want_mask: bool = True
    ) -> Dict:
        probs, pred, score = fut.result(timeout=timeout)
        cls_id = int(pred)
        out = {
            "class_id": cls_id,
            "class": self.classnames[cls_id],
            "score": float(np.asarray(score, np.float32)[cls_id]),
        }
        if not want_mask:
            return out
        if probs is None:
            raise RuntimeError(
                "mask requested but the engine was built with "
                "return_mask=False (classification-only program)"
            )
        probs = np.asarray(probs)
        # round (not truncate) so float16 transfer quantises to the SAME
        # uint8 mask as the mask_dtype="uint8" in-graph path (jnp.round)
        m8 = (
            probs
            if probs.dtype == np.uint8
            else np.round(probs.astype(np.float32) * 255).astype(np.uint8)
        )
        if native:
            mask = _nat.resize(m8, (w, h), _nat.BILINEAR)  # 2D in, 2D out
        else:
            from PIL import Image

            mask = np.asarray(Image.fromarray(m8).resize((w, h), Image.BILINEAR))
        out["mask"] = mask  # (h, w) uint8
        return out

    def stats(self) -> Dict:
        with self._stats_lock:
            s = dict(self._stats)
            s["batch_size_hist"] = dict(self._stats["batch_size_hist"])
            s["bucket_latency_ms"] = {
                b: {**v, "mean": v["sum"] / v["count"]}
                for b, v in self._stats["bucket_latency_ms"].items()
            }
        if s["requests"]:
            s["latency_ms_mean"] = s["latency_ms_sum"] / s["requests"]
        s["pad_fraction"] = (
            1.0 - s["requests"] / s["batched_images"] if s["batched_images"] else 0.0
        )
        s["ready"] = self.ready()
        return s

    def close(self) -> None:
        """Graceful drain: everything queued before shutdown still runs
        (the sentinel rides the FIFO behind it); anything racing in after
        is rejected by submit(), never left hanging.

        The completer's sentinel is planted by the WORKER as it exits (see
        `_worker_loop`), so it is FIFO-ordered behind the last dispatched
        batch even if the joins below time out (e.g. a batch is mid-compile
        when SIGTERM arrives) — the threads then finish the drain on their
        own and every future still resolves."""
        with self._submit_lock:
            self._stop = True
            self._queue.put(_SENTINEL)
        self._worker.join(timeout=60)
        self._completer.join(timeout=60)

    # ---- batching worker ----

    def _bucket_for(self, n: int) -> int:
        for b in self.serve_cfg.buckets:
            if b >= n:
                return b
        return self.serve_cfg.buckets[-1]

    def _worker_loop(self) -> None:
        max_batch = self.serve_cfg.buckets[-1]
        delay_s = self.serve_cfg.max_delay_ms / 1e3
        try:
            while True:
                first = self._queue.get()
                if first is _SENTINEL:
                    return
                batch: List[_Request] = [first]
                deadline = time.monotonic() + delay_s
                while len(batch) < max_batch:
                    remaining = deadline - time.monotonic()
                    try:
                        item = (
                            self._queue.get(timeout=remaining)
                            if remaining > 0
                            else self._queue.get_nowait()
                        )
                    except queue.Empty:
                        break
                    if item is _SENTINEL:
                        self._flush(batch)
                        return
                    batch.append(item)
                self._flush(batch)
        finally:
            # planted HERE (not in close()) so it is FIFO-ordered behind the
            # last dispatched batch even when close()'s join times out
            self._inflight.put(_SENTINEL)

    def _flush(self, batch: List[_Request]) -> None:
        """Stack, ship, and dispatch one batch (async — compute and the
        result download happen behind the completer thread)."""
        if not batch:
            return
        n = len(batch)
        bucket = self._bucket_for(n)
        try:
            inp = np.stack([r.inp for r in batch] + [batch[-1].inp] * (bucket - n))
            cimg = np.stack([r.cimg for r in batch] + [batch[-1].cimg] * (bucket - n))
            outs = self._run(
                self._params, self._text_features, self._put(inp), self._put(cimg)
            )
        except Exception as e:  # compile/dispatch failure: fail the batch, not the server
            self._fail_batch(batch, e)
            return
        # blocks when max_inflight batches are already awaiting download —
        # backpressure that bounds device-side input buffers
        self._inflight.put((batch, bucket, outs))

    def _fail_batch(self, batch: List[_Request], e: Exception) -> None:
        with self._stats_lock:
            self._stats["errors"] += len(batch)
        for r in batch:
            r.future.set_exception(e)

    def _completer_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is _SENTINEL:
                return
            batch, bucket, outs = item
            try:
                # the device->host sync point: one fetch per batch
                if len(outs) == 2:  # return_mask=False program
                    probs = None
                    pred, score = outs
                else:
                    probs, pred, score = outs
                    probs = np.asarray(probs)[..., 0]
                pred = np.asarray(pred)
                score = np.asarray(score, np.float32)
            except Exception as e:  # device-side failure surfaces at fetch
                self._fail_batch(batch, e)
                continue
            n = len(batch)
            now = time.monotonic()
            with self._stats_lock:
                s = self._stats
                s["requests"] += n
                s["batches"] += 1
                s["batched_images"] += bucket
                s["batch_size_hist"][n] = s["batch_size_hist"].get(n, 0) + 1
                bl = s["bucket_latency_ms"].setdefault(
                    bucket, {"count": 0, "sum": 0.0, "max": 0.0}
                )
                for r in batch:
                    lat = (now - r.t_enqueue) * 1e3
                    s["latency_ms_sum"] += lat
                    s["latency_ms_max"] = max(s["latency_ms_max"], lat)
                    bl["count"] += 1
                    bl["sum"] += lat
                    bl["max"] = max(bl["max"], lat)
            for i, r in enumerate(batch):
                r.future.set_result(
                    (None if probs is None else probs[i], int(pred[i]), score[i])
                )


def bench_engine(
    engine: InferenceEngine,
    n_images: int = 128,
    stage_inputs: bool = True,
    pool: int = 4,
    seed: int = 0,
) -> Dict:
    """In-process engine benchmark: the serving ceiling WITHOUT the network.

    This drives the REAL batcher/worker/completer machinery
    (submit -> coalesce -> pad-to-bucket -> async dispatch -> pipelined
    fetch) with pre-resized uint8 inputs — no HTTP, no JPEG decode, no
    per-request preprocessing — and, with `stage_inputs=True`, a shape-keyed
    device cache behind `_put` so each bucket's input tensor is uploaded
    ONCE and every later batch reuses the device-resident buffer (batches
    then recompute identical data, exactly like bench.py's steady-state
    loop). Combined with a `return_mask=False` engine, the only per-batch
    device->host traffic is the class ids/logits — engine orchestration +
    compute is what remains on the clock.

    Call `engine.warmup()` first; compile time is not part of the
    measurement. Returns {images_per_sec, elapsed_s, n_images, staged,
    bucket_latency_ms, batch_size_hist, pad_fraction}.
    """
    cfg = engine.cfg
    rng = np.random.default_rng(seed)
    inps = [
        rng.integers(0, 256, (cfg.inp_size, cfg.inp_size, 3), dtype=np.uint8)
        for _ in range(pool)
    ]
    cimgs = [
        rng.integers(0, 256, (cfg.clip_size, cfg.clip_size, 3), dtype=np.uint8)
        for _ in range(pool)
    ]

    orig_put = engine._put
    if stage_inputs:
        staged: Dict = {}

        def _staged_put(a):
            key = (a.shape, str(a.dtype))
            if key not in staged:
                d = orig_put(a)
                d = jax.block_until_ready(jnp.asarray(d))
                staged[key] = d
            return staged[key]

        engine._put = _staged_put
    try:
        t0 = time.monotonic()
        futures = [
            engine.submit(inps[i % pool], cimgs[i % pool])
            for i in range(n_images)
        ]
        for f in futures:
            f.result(timeout=600)
        elapsed = time.monotonic() - t0
    finally:
        engine._put = orig_put

    stats = engine.stats()
    return {
        "images_per_sec": n_images / elapsed,
        "elapsed_s": elapsed,
        "n_images": n_images,
        "staged": stage_inputs,
        "return_mask": engine.serve_cfg.return_mask,
        "bucket_latency_ms": stats["bucket_latency_ms"],
        "batch_size_hist": stats["batch_size_hist"],
        "pad_fraction": stats["pad_fraction"],
    }

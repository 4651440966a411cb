"""Serving subsystem: micro-batching engine + HTTP front end (CPU, tiny).

Covers: batched-and-padded results == direct single-image inference,
request coalescing, bucket selection, backpressure accounting, and the
HTTP endpoints end-to-end.
"""

import base64
import http.client
import io
import json
import threading

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from camouflaged_vlm_tpu.factory import (
    build_tiny_cascade,
    init_cascade_params,
    make_bank_inputs,
)
from camouflaged_vlm_tpu.serve import InferenceEngine, ServeConfig

CLASSNAMES = ["cat", "owl", "snow leopard", "scorpionfish"]


@pytest.fixture(scope="module")
def engine_parts():
    model, cfg = build_tiny_cascade()
    bank = make_bank_inputs(cfg, CLASSNAMES)
    params = init_cascade_params(model)
    return model, cfg, params, bank


def _make_engine(engine_parts, **kw):
    model, cfg, params, bank = engine_parts
    serve_cfg = ServeConfig(**{"buckets": (1, 2, 4), "max_delay_ms": 200.0, **kw})
    return InferenceEngine(model, cfg, params, bank, CLASSNAMES, serve_cfg)


def _rand_inputs(cfg, rng, n):
    inp = rng.integers(0, 256, (n, cfg.inp_size, cfg.inp_size, 3), dtype=np.uint8)
    cimg = rng.integers(0, 256, (n, cfg.clip_size, cfg.clip_size, 3), dtype=np.uint8)
    return inp, cimg


def test_batched_padded_matches_direct(engine_parts, rng):
    """3 concurrent requests coalesce into one bucket-4 (padded) batch whose
    per-request results equal direct batch-1 inference."""
    model, cfg, params, bank = engine_parts
    eng = _make_engine(engine_parts)
    try:
        inp, cimg = _rand_inputs(cfg, rng, 3)
        futures = [None] * 3
        threads = [
            threading.Thread(
                target=lambda i=i: futures.__setitem__(i, eng.submit(inp[i], cimg[i]))
            )
            for i in range(3)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [f.result(timeout=120) for f in futures]

        # direct single-image reference through the same jitted program
        for i, (probs, pred, score) in enumerate(results):
            p1, d1, s1 = eng._run(
                eng._params, eng._text_features, inp[i : i + 1], cimg[i : i + 1]
            )
            # batch-4 and batch-1 programs may tile reductions differently;
            # fp16-level agreement is the contract
            np.testing.assert_allclose(
                probs.astype(np.float32),
                np.asarray(p1, np.float32)[0, :, :, 0],
                atol=2e-3,
            )
            assert pred == int(d1[0])
            np.testing.assert_allclose(
                score, np.asarray(s1, np.float32)[0], rtol=1e-4, atol=1e-5
            )

        s = eng.stats()
        assert s["requests"] == 3
        # coalescing: strictly fewer batches than requests
        assert s["batches"] < 3
        # a 3-request batch must have run at bucket 4 (padded)
        assert s["batched_images"] >= 4
        assert s["pad_fraction"] > 0
    finally:
        eng.close()


def test_bucket_selection(engine_parts):
    eng = _make_engine(engine_parts)
    try:
        assert [eng._bucket_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    finally:
        eng.close()


def test_default_buckets_are_bench_derived():
    """The out-of-the-box bucket set must include the measured throughput
    point (batch 32) AND a batch-1 latency bucket (the old (1,2,4,8)
    default left a throughput deployment riding the wrong buckets)."""
    cfg = ServeConfig()
    assert 32 in cfg.buckets
    assert 1 in cfg.buckets


def test_large_bucket_coalesces_and_matches_direct(engine_parts, rng):
    """A burst bigger than the mid buckets rides the 32 bucket (padded) and
    every request still gets its own correct result."""
    model, cfg, params, bank = engine_parts
    eng = _make_engine(engine_parts, buckets=(1, 32), max_delay_ms=300.0)
    try:
        n = 20
        inp, cimg = _rand_inputs(cfg, rng, n)
        futures = [None] * n
        threads = [
            threading.Thread(
                target=lambda i=i: futures.__setitem__(i, eng.submit(inp[i], cimg[i]))
            )
            for i in range(n)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [f.result(timeout=300) for f in futures]

        s = eng.stats()
        assert s["requests"] == n
        # any multi-request batch rides the 32 bucket (buckets=(1,32)):
        # batched_images sums BUCKET sizes, so >=32 proves the large bucket
        # actually ran (batch_size_hist keys are pre-pad request counts)
        assert s["batches"] < n
        assert s["batched_images"] >= 32, s

        for i in (0, n // 2, n - 1):
            probs, pred, score = results[i]
            p1, d1, s1 = eng._run(
                eng._params, eng._text_features, inp[i : i + 1], cimg[i : i + 1]
            )
            np.testing.assert_allclose(
                probs.astype(np.float32),
                np.asarray(p1, np.float32)[0, :, :, 0],
                atol=2e-3,
            )
            assert pred == int(d1[0])
    finally:
        eng.close()


def test_predict_pil_shapes(engine_parts, rng):
    eng = _make_engine(engine_parts, max_delay_ms=1.0)
    try:
        img = Image.fromarray(
            rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
        )  # non-square: mask must come back at the ORIGINAL size
        out = eng.predict_pil(img, timeout=120)
        assert out["class"] in CLASSNAMES
        assert out["mask"].shape == (50, 70)
        assert out["mask"].dtype == np.uint8
        assert isinstance(out["score"], float)
        # classification-only fast path: no mask resize, no mask key
        out2 = eng.predict_pil(img, timeout=120, want_mask=False)
        assert "mask" not in out2 and out2["class_id"] == out["class_id"]
    finally:
        eng.close()


def test_predict_bytes_matches_pil(engine_parts, rng):
    """predict_bytes (native decode fast path when built, PIL fallback
    otherwise) returns the same class and a bit-identical mask as
    predict_pil on the same encoded image."""
    import io

    eng = _make_engine(engine_parts, max_delay_ms=1.0)
    try:
        arr = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "PNG")  # lossless: both paths decode
        a = eng.predict_bytes(buf.getvalue(), timeout=120)
        b = eng.predict_pil(Image.open(io.BytesIO(buf.getvalue())), timeout=120)
        assert a["class_id"] == b["class_id"] and a["score"] == b["score"]
        assert a["mask"].shape == (50, 70) and a["mask"].dtype == np.uint8
        assert np.array_equal(a["mask"], b["mask"])
        with pytest.raises((ValueError, OSError)):
            eng.predict_bytes(b"not an image at all", timeout=120)
    finally:
        eng.close()


def test_uint8_mask_matches_float16(engine_parts, rng):
    """mask_dtype='uint8' returns round(p*255) of the float16 path."""
    model, cfg, params, bank = engine_parts
    eng8 = _make_engine(engine_parts, mask_dtype="uint8", max_delay_ms=1.0)
    eng16 = _make_engine(engine_parts, max_delay_ms=1.0)
    try:
        inp, cimg = _rand_inputs(cfg, rng, 1)
        p8, d8, s8 = eng8.submit(inp[0], cimg[0]).result(timeout=120)
        p16, d16, s16 = eng16.submit(inp[0], cimg[0]).result(timeout=120)
        assert p8.dtype == np.uint8 and p16.dtype == np.float16
        np.testing.assert_allclose(
            p8.astype(np.float32),
            np.round(p16.astype(np.float32) * 255),
            atol=1.0,  # fp16 quantisation can flip a rounding boundary
        )
        assert d8 == d16
        # predict_pil handles both dtypes
        img = Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
        out = eng8.predict_pil(img, timeout=120)
        assert out["mask"].shape == (30, 40) and out["mask"].dtype == np.uint8
    finally:
        eng8.close()
        eng16.close()


def test_close_drains_then_rejects(engine_parts, rng):
    """Requests queued before close() still resolve; submits after raise."""
    eng = _make_engine(engine_parts, max_delay_ms=500.0)
    inp, cimg = _rand_inputs(engine_parts[1], rng, 2)
    futs = [eng.submit(inp[i], cimg[i]) for i in range(2)]
    eng.close()
    for f in futs:
        probs, pred, score = f.result(timeout=120)  # drained, not dropped
        assert probs.ndim == 2
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(inp[0], cimg[0])


def test_concurrent_submit_close_race(engine_parts, rng):
    """Submits racing close() from many threads: every future either
    resolves (queued before the drain sentinel) or submit() raises —
    none may hang. Exercises the submit-lock ordering guarantee."""
    eng = _make_engine(engine_parts, max_delay_ms=1.0)
    inp, cimg = _rand_inputs(engine_parts[1], rng, 1)
    results = []  # (kind, payload)
    lock = threading.Lock()

    def hammer():
        for _ in range(8):
            try:
                fut = eng.submit(inp[0], cimg[0])
            except RuntimeError:
                with lock:
                    results.append(("rejected", None))
                continue
            with lock:
                results.append(("accepted", fut))

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    eng.close()  # races the hammers
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 32
    for kind, fut in results:
        if kind == "accepted":
            probs, pred, score = fut.result(timeout=120)  # must resolve
            assert probs.ndim == 2


def test_warmup_sets_ready(engine_parts):
    eng = _make_engine(engine_parts, buckets=(1,))
    try:
        assert not eng.ready()
        eng.warmup()
        assert eng.ready()
    finally:
        eng.close()


def test_data_parallel_engine_matches_single(engine_parts, rng):
    """Mesh-sharded serving (batch fanned out over the data axis) returns
    the same results as the single-device engine."""
    from camouflaged_vlm_tpu.parallel import make_mesh

    model, cfg, params, bank = engine_parts
    mesh = make_mesh(n_data=4, devices=jax.devices()[:4])
    eng_dp = InferenceEngine(
        model, cfg, params, bank, CLASSNAMES,
        ServeConfig(buckets=(4, 8), max_delay_ms=300.0), mesh=mesh,
    )
    eng_1 = _make_engine(engine_parts, buckets=(1,), max_delay_ms=1.0)
    try:
        inp, cimg = _rand_inputs(cfg, rng, 4)
        futs = [eng_dp.submit(inp[i], cimg[i]) for i in range(4)]
        results = [f.result(timeout=300) for f in futs]
        assert eng_dp.stats()["batches"] == 1  # all 4 rode one sharded batch
        for i, (probs, pred, score) in enumerate(results):
            p1, d1, s1 = eng_1.submit(inp[i], cimg[i]).result(timeout=300)
            np.testing.assert_allclose(
                probs.astype(np.float32), p1.astype(np.float32), atol=2e-3
            )
            assert pred == d1
            np.testing.assert_allclose(score, s1, rtol=1e-4, atol=1e-5)
    finally:
        eng_dp.close()
        eng_1.close()


def test_data_parallel_rejects_indivisible_buckets(engine_parts):
    from camouflaged_vlm_tpu.parallel import make_mesh

    model, cfg, params, bank = engine_parts
    mesh = make_mesh(n_data=4, devices=jax.devices()[:4])
    with pytest.raises(AssertionError, match="not divisible"):
        InferenceEngine(
            model, cfg, params, bank, CLASSNAMES,
            ServeConfig(buckets=(2, 4)), mesh=mesh,
        )


def test_http_server_end_to_end(engine_parts, rng):
    from camouflaged_vlm_tpu.cli.serve import serve_forever

    eng = _make_engine(engine_parts, max_delay_ms=1.0, buckets=(1, 2))
    server, thread = serve_forever(eng, "127.0.0.1", 0, quiet=True)
    try:
        port = server.server_address[1]

        # wait for warmup (tiny config compiles in seconds on CPU)
        import time

        for _ in range(600):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("GET", "/healthz")
            r = conn.getresponse()
            r.read()
            if r.status == 200:
                break
            time.sleep(0.2)
        else:
            raise AssertionError("server never became ready")

        # classnames endpoint
        conn.request("GET", "/classnames")
        r = conn.getresponse()
        assert json.loads(r.read()) == CLASSNAMES

        # predict with a JPEG body
        img = Image.fromarray(rng.integers(0, 256, (40, 60, 3), dtype=np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="JPEG")
        conn.request("POST", "/predict", body=buf.getvalue())
        r = conn.getresponse()
        assert r.status == 200, r.read()
        resp = json.loads(r.read())
        assert resp["class"] in CLASSNAMES
        mask = Image.open(io.BytesIO(base64.b64decode(resp["mask_png_b64"])))
        assert mask.size == (60, 40)

        # predict without the mask payload
        conn.request("POST", "/predict?mask=0", body=buf.getvalue())
        resp = json.loads(conn.getresponse().read())
        assert "mask_png_b64" not in resp and resp["class"] in CLASSNAMES

        # malformed body -> 400, not a crash
        conn.request("POST", "/predict", body=b"not an image")
        r = conn.getresponse()
        assert r.status == 400
        r.read()  # drain before reusing the keep-alive connection

        # POST to an unknown path must drain the request body, or the
        # keep-alive connection desynchronises (the unread image bytes
        # would be parsed as the next request line)
        conn.request("POST", "/segment", body=buf.getvalue())
        r = conn.getresponse()
        assert r.status == 404
        r.read()
        conn.request("POST", "/predict?mask=0", body=buf.getvalue())
        r = conn.getresponse()
        assert r.status == 200, r.read()
        assert json.loads(r.read())["class"] in CLASSNAMES

        # stats endpoint reflects the traffic
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["requests"] >= 2 and stats["ready"]

        # prometheus exposition
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        assert "cvlm_requests_total" in text and "cvlm_ready 1" in text
    finally:
        if "conn" in locals():
            conn.close()  # EOF the keep-alive handler so the join is quick
        server.shutdown()
        eng.close()
        server.server_close()  # joins the (non-daemon) handler threads


def test_bench_engine_staged_classification_only(engine_parts, rng):
    """`bench_engine` drives the REAL batcher/completer with a shape-keyed device
    cache behind `_put`, and a `return_mask=False` engine resolves futures
    as (None, class_id, logits) — no mask ever crosses the link."""
    from camouflaged_vlm_tpu.serve import bench_engine

    model, cfg, params, bank = engine_parts
    eng = _make_engine(engine_parts, return_mask=False, max_delay_ms=5.0)
    try:
        eng.warmup()
        orig_put = eng._put
        rep = bench_engine(eng, n_images=12, stage_inputs=True, pool=2)
        assert eng._put is orig_put  # staging wrapper removed afterwards
        assert rep["images_per_sec"] > 0 and rep["n_images"] == 12
        assert rep["staged"] is True and rep["return_mask"] is False
        assert sum(rep["batch_size_hist"].values()) >= 1
        assert rep["bucket_latency_ms"]  # per-bucket latency present

        # classification-only future: no mask payload
        inp, cimg = _rand_inputs(cfg, rng, 1)
        probs, cls_id, score = eng.submit(inp[0], cimg[0]).result(timeout=120)
        assert probs is None and 0 <= cls_id < len(CLASSNAMES)
        assert score.shape == (len(CLASSNAMES),)

        # mask-requesting clients get a loud error, not a crash
        img = Image.fromarray(inp[0])
        with pytest.raises(RuntimeError, match="return_mask"):
            eng.predict_pil(img, timeout=120, want_mask=True)
        out = eng.predict_pil(img, timeout=120, want_mask=False)
        assert out["class"] in CLASSNAMES
    finally:
        eng.close()


@pytest.mark.slow  # upload-path variant; the staged bench test stays fast
def test_bench_engine_unstaged_masked(engine_parts, rng):
    """bench_engine's pre-staged-host mode (stage_inputs=False) exercises
    the full upload path with the default masked program."""
    from camouflaged_vlm_tpu.serve import bench_engine

    eng = _make_engine(engine_parts, max_delay_ms=5.0)
    try:
        eng.warmup()
        rep = bench_engine(eng, n_images=6, stage_inputs=False, pool=2)
        assert rep["images_per_sec"] > 0 and rep["staged"] is False
        assert rep["return_mask"] is True
    finally:
        eng.close()

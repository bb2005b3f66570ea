"""The PyTorch port's serving stack on the CPU: the micro-batcher, the
pipelined executor and the HTTP server, against the JAX package's.

The batcher cases mirror tests/test_serve.py's. The executor's results
equal ``engine.run``'s for the same images (the executor batches them
into other buckets; the CPU's plain versions are per-sample exact to
1e-6 abs). The server answers a ``.npy`` upload on the int8_fused tier
with a PNG that decodes to within 1 count of the JAX server's encoding of
the JAX engine's int8_fused output for the same image (the two engines
agree to 1e-4 abs before rounding to uint8). The port's PNG writer (zlib
and struct, no imaging library) decodes with PIL to exactly the array it
was given, and its Prometheus text equals the JAX server's for the same
snapshot.
"""

import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util
from PIL import Image

from cyclegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from cyclegan_tpu.config import ModelConfig as JaxModelConfig
from cyclegan_tpu.serve import engine as jax_engine
from cyclegan_tpu.serve import server as jax_server
from cyclegan_tpu_torch.config import GeneratorConfig, ModelConfig
from cyclegan_tpu_torch.convert import generator_state_from_flax, signal_flax_params
from cyclegan_tpu_torch.serve import server
from cyclegan_tpu_torch.serve.batcher import MicroBatcher, Request
from cyclegan_tpu_torch.serve.engine import (
    InferenceEngine,
    ServeConfig,
    preprocess_request,
)
from cyclegan_tpu_torch.serve.executor import PipelinedExecutor
from cyclegan_tpu_torch.utils.plotting import to_uint8

TINY = dict(filters=4, num_residual_blocks=1)
SIZE = 16
STATS_KEYS = {"queue_depths", "max_queue_depth", "n_flushes",
              "n_queued_requests", "n_images_done", "tiers"}
SUMMARY_KEYS = {"n_images", "n_flushes", "wall_s", "images_per_sec",
                "latency_p50_s", "latency_p95_s", "latency_p99_s",
                "max_queue_depth"}


# -- micro-batcher edge cases (tests/test_serve.py:98-163) ------------------

def _resolving_flush(record, fail=None):
    def flush(batch, trigger):
        if fail is not None and fail[0]:
            raise RuntimeError("poisoned flush")
        record.append((len(batch), trigger))
        for r in batch:
            r.future.set_result(len(batch))
    return flush


def test_batcher_flushes_full_buckets():
    record = []
    b = MicroBatcher(_resolving_flush(record), max_batch=4, max_wait_s=5.0)
    futs = [b.submit(Request(i, 32)) for i in range(8)]
    assert all(f.result(timeout=30) == 4 for f in futs)
    b.close()
    assert record == [(4, "full"), (4, "full")]
    assert b.n_requests == 8 and b.n_flushes == 2


def test_batcher_deadline_flush_with_slow_producer():
    record = []
    b = MicroBatcher(_resolving_flush(record), max_batch=8, max_wait_s=0.05)
    t0 = time.perf_counter()
    futs = [b.submit(Request(i, 32)) for i in range(2)]
    assert all(f.result(timeout=30) == 2 for f in futs)
    waited = time.perf_counter() - t0
    b.close()
    assert record == [(2, "deadline")]
    assert 0.05 <= waited < 5.0


def test_batcher_drains_residue_on_close():
    record = []
    b = MicroBatcher(_resolving_flush(record), max_batch=8, max_wait_s=60.0)
    futs = [b.submit(Request(i, 32)) for i in range(3)]
    b.close()
    assert record == [(3, "drain")]
    assert all(f.result(timeout=5) == 3 for f in futs)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(Request(9, 32))


def test_batcher_flush_exception_fails_futures_not_engine():
    record, fail = [], [True]
    b = MicroBatcher(_resolving_flush(record, fail),
                     max_batch=2, max_wait_s=0.02)
    bad = [b.submit(Request(i, 32)) for i in range(2)]
    for f in bad:
        with pytest.raises(RuntimeError, match="poisoned"):
            f.result(timeout=30)
    fail[0] = False
    good = b.submit(Request(9, 32))
    assert good.result(timeout=30) == 1
    b.close()
    assert record == [(1, "deadline")]


def test_batcher_max_queue_watermark():
    release = threading.Event()

    def slow_flush(batch, trigger):
        release.wait(timeout=30)
        for r in batch:
            r.future.set_result(None)

    b = MicroBatcher(slow_flush, max_batch=1, max_wait_s=0.0, max_queue=64)
    futs = [b.submit(Request(i, 32)) for i in range(5)]
    assert b.max_depth >= 1
    release.set()
    for f in futs:
        f.result(timeout=30)
    b.close()


def test_batcher_splits_flushes_at_tier_boundaries():
    record = []
    b = MicroBatcher(_resolving_flush(record), max_batch=4, max_wait_s=0.2)
    futs = [b.submit(Request(i, 32, tier=t))
            for i, t in enumerate(("base", "base", "int8", "int8"))]
    for f in futs:
        f.result(timeout=30)
    b.close()
    assert [n for n, _ in record] == [2, 2]


# -- the pipelined executor -------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return signal_flax_params(GeneratorConfig(**TINY), 20)


@pytest.fixture(scope="module")
def engine(params):
    return InferenceEngine(
        ModelConfig(generator=GeneratorConfig(**TINY), image_size=SIZE),
        generator_state_from_flax(params),
        serve_cfg=ServeConfig(batch_buckets=(1, 4), sizes=(SIZE,),
                              int8_tier=True, infer_tier=True),
        device="cpu")


class _Events:
    """A logger hook: records (kind, fields)."""

    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append((kind, fields))


def test_executor_matches_engine_run(engine):
    log = _Events()
    ex = PipelinedExecutor(engine, max_wait_ms=20.0, logger=log)
    rng = np.random.default_rng(0)
    shapes = [(20, 20), (16, 12), (33, 20), (8, 8), (16, 16)] * 2
    tiers = ["base", "int8", "int8_fused"] * 4
    imgs = [rng.integers(0, 255, s + (3,), dtype=np.uint8) for s in shapes]
    futs = [ex.submit_raw(img, tier=t) for img, t in zip(imgs, tiers)]
    results = [f.result(timeout=120) for f in futs]
    for img, tier, res in zip(imgs, tiers, results):
        assert res["fake"].shape == (SIZE, SIZE, 3) and "cycled" not in res
        x = preprocess_request(img, SIZE)[None]
        (want,), _ = engine.run(x, tier=tier)
        np.testing.assert_allclose(res["fake"], want[0].numpy(), rtol=0,
                                   atol=1e-6)
    snap = ex.stats()
    assert set(snap) == STATS_KEYS
    assert snap["n_queued_requests"] == snap["n_images_done"] == len(imgs)
    assert snap["tiers"] == ["base", "int8", "int8_fused"]
    assert set(snap["queue_depths"]) == {f"{SIZE}/{t}" for t in set(tiers)}
    summary = ex.close()
    assert set(summary) == SUMMARY_KEYS
    assert summary["n_images"] == len(imgs) and summary["images_per_sec"] > 0
    assert summary["latency_p95_s"] >= summary["latency_p50_s"]
    flushes = [f for k, f in log.events if k == "serve_flush"]
    assert len(flushes) == summary["n_flushes"] >= 3
    assert sum(f["n"] for f in flushes) == len(imgs)
    assert {f["tier"] for f in flushes} == set(tiers)
    assert log.events[-1][0] == "serve_summary"


def test_engine_run_from_many_threads(engine):
    """Each batcher thread calls ``engine.run``; the quantized tiers swap
    the skeleton's tensors in and out, so concurrent dispatches must not
    interleave. More threads than cores, a short switch interval; every
    result must equal the same flush run alone (1e-6 abs)."""
    tiers = engine.tiers
    x = np.random.default_rng(3).uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    want = {t: engine.run(x, tier=t)[0][0].numpy() for t in tiers}
    errors, results = [], []

    def worker(i):
        try:
            for j in range(3):
                tier = tiers[(i + j) % len(tiers)]
                results.append((tier, engine.run(x, tier=tier)[0][0].numpy()))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range((os.cpu_count() or 4) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert len(results) == 3 * len(threads)
    for tier, got in results:
        np.testing.assert_allclose(got, want[tier], rtol=0, atol=1e-6)


def test_executor_refusals(engine):
    with pytest.raises(ValueError, match="exceeds"):
        PipelinedExecutor(engine, max_batch=16)
    ex = PipelinedExecutor(engine, max_wait_ms=1.0)
    with pytest.raises(ValueError, match="resolution bucket"):
        ex.submit(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="perturb"):
        ex.submit(np.zeros((SIZE, SIZE, 3), np.float32), tier="perturb")
    assert ex.close()["n_images"] == 0
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit(np.zeros((SIZE, SIZE, 3), np.float32))
    assert ex.close() == {}  # idempotent


# -- PNG and Prometheus text ------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16, 3), (5, 9, 3), (16, 48, 3)])
def test_png_encoder_decodes_with_pil(shape):
    x = np.random.default_rng(1).uniform(-1.2, 1.2, shape).astype(np.float32)
    body = server._encode_png(x)
    with Image.open(io.BytesIO(body)) as im:
        assert im.mode == "RGB" and im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), to_uint8(x))
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(jax_server._encode_png(x)))),
        np.asarray(Image.open(io.BytesIO(body))))


def test_prometheus_text_matches_jax():
    stats = {"n_requests": 7, "n_errors": 1, "n_shed": 0, "fleet": False,
             "queue_depths": {"16/base": 0, "16/int8_fused": 2},
             "max_queue_depth": 3, "n_flushes": 5, "n_queued_requests": 7,
             "n_images_done": 6, "tiers": ["base", "int8", "int8_fused"],
             "admission": {"depth": 1, "shed": {"batch": 2}},
             "classes": {"batch": {"p50_s": 0.01, "p95_s": 0.25}}}
    assert server.render_prometheus(stats) == jax_server.render_prometheus(stats)
    assert server.render_prometheus({}) == jax_server.render_prometheus({})


# -- the HTTP server --------------------------------------------------------

def _jax_fused_png(params, img):
    """The JAX server's reply for ``img`` on the int8_fused tier."""
    cfg = JaxModelConfig(generator=JaxGeneratorConfig(**TINY), image_size=SIZE,
                         instance_norm_impl="pallas", pad_impl="epilogue",
                         upsample_impl="zeroskip_fused")
    tree = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in params.items()}, sep="/")}
    eng = jax_engine.InferenceEngine(
        cfg, tree, serve_cfg=jax_engine.ServeConfig(
            batch_buckets=(1,), sizes=(SIZE,), dtype="float32",
            infer_tier=True))
    x = jax_engine.preprocess_request(img, SIZE)[None]
    (fake,), _ = eng.run(x, size=SIZE, tier="int8_fused")
    return jax_server._encode_png(np.asarray(fake)[0])


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_http_server_round_trip(engine, params):
    ex = PipelinedExecutor(engine, max_wait_ms=5.0)
    httpd, app = server.make_server(ex, port=0)
    host, port = httpd.server_address[:2]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert r.status == 200
        img = np.random.default_rng(2).integers(0, 255, (20, 28, 3), np.uint8)
        buf = io.BytesIO()
        np.save(buf, img)
        status, ctype, body = _post(f"{base}/translate?tier=int8_fused",
                                    buf.getvalue())
        assert (status, ctype) == (200, "image/png")
        assert body[:8] == b"\x89PNG\r\n\x1a\n"
        got = np.asarray(Image.open(io.BytesIO(body)))
        want = np.asarray(Image.open(io.BytesIO(_jax_fused_png(params, img))))
        assert got.shape == want.shape == (SIZE, SIZE, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        for tier in ("base", "int8"):
            assert _post(f"{base}/translate?tier={tier}", buf.getvalue())[0] == 200

        # ?tenant= needs the fleet mode: a 400, not a 500.
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/translate?tenant=monet/base", buf.getvalue())
        assert ei.value.code == 400
        # A garbage upload 500s without killing the server.
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/translate", b"not an image")
        assert ei.value.code == 500

        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["n_requests"] == 5 and stats["n_errors"] == 2
        assert stats["fleet"] is False and stats["n_images_done"] == 3
        assert set(stats) >= STATS_KEYS
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            assert r.headers["Content-Type"] == "text/plain; version=0.0.4"
            text = r.read().decode()
        assert "cyclegan_serve_requests_total 5" in text
        assert 'cyclegan_serve_queue_depth{bucket="16/int8_fused"} 0' in text
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert r.status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        ex.close()


@pytest.mark.parametrize("argv", [
    ["--fleet", "2"], ["--output_dir", "runs"], ["--autoscale"],
    ["--brownout"], ["--hedge_ms", "100"], ["--tenant", "monet/base=runs"],
    ["--obs_jsonl", "x.jsonl"], ["--trace_sample", "0.1"],
    ["--capacity", "256"], ["--default_class", "batch"],
    ["--min_replicas", "1"], ["--max_replicas", "2"],
    ["--shadow_fraction", "0.05"], ["--tenant_slo_ms", "50"],
    ["--tenant_shed_budget", "0.5"],
])
def test_main_refuses_flags_not_ported(argv):
    with pytest.raises(SystemExit, match="not ported yet"):
        server.main(argv + ["--device", "cpu"])


def test_main_refusals_before_serving(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        server.main(["--int8", "--panels", "--device", "cpu"])
    np.savez(tmp_path / "g.npz", **signal_flax_params(GeneratorConfig(**TINY), 0))
    with pytest.raises(ValueError, match="bfloat16"):
        server.main(["--weights", str(tmp_path / "g.npz"), "--dtype",
                     "bfloat16", "--image_size", str(SIZE), "--device", "cpu"])
    with pytest.raises(SystemExit, match="both generators"):
        server.main(["--weights", str(tmp_path / "g.npz"), "--direction",
                     "BtoA", "--device", "cpu"])

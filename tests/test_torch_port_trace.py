"""The port's request tracer (obs/trace.py) and the server's and
translate's telemetry, against the JAX package's, on the CPU.

The ``Tracer``: one scripted sequence of requests — spans with explicit
timestamps, root point events, a forced tail, failures, a late span after
a kept trace finished — through the JAX tracer and the port's, each with
a seeded ``random.Random`` (the head-sampling coin and the trace ids),
writes the same events exactly (tolerance: none) and folds the same hop
histograms; ``render_prometheus`` then renders the same text from the
same snapshot and tracer.

The HTTP server (a tiny engine on the CPU): every reply carries
``X-Trace-Id``; at sample 1 each answered request has exactly one kept
``trace`` event whose hops (admit, queue, stack, submit, device, resolve)
run in that order inside the request's interval; at sample 0 only the
failed one is kept; ``/metrics`` parses as Prometheus text with the
JAX server's trace families (tests/test_trace.py's
``test_http_x_trace_id_and_metrics_exposition``). The server's
``--obs_jsonl`` writes the serve manifest, ``serve_summary`` and ``end``;
translate's writes the ``translate`` manifest; ``tools/obs_report.py``
folds both with no unknown kinds.
"""

import io
import os
import random
import re
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from cyclegan_tpu.obs import trace as jax_trace
from cyclegan_tpu.serve import server as jax_server
from cyclegan_tpu_torch.config import (
    KERNEL_LAYOUT,
    GeneratorConfig,
    ModelConfig,
)
from cyclegan_tpu_torch.convert import generator_state_from_flax, signal_flax_params
from cyclegan_tpu_torch.obs import trace
from cyclegan_tpu_torch.serve import server
from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
from cyclegan_tpu_torch.serve.executor import PipelinedExecutor
from cyclegan_tpu_torch import translate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

TINY = dict(filters=4, num_residual_blocks=1)
SIZE = 16
HOPS = ["admit", "queue", "stack", "submit", "device", "resolve"]


class CapLogger:
    """A MetricsLogger-shaped capture: the tracer needs .event() only."""

    def __init__(self):
        self.events = []
        self._lock = threading.Lock()

    def event(self, kind, /, **fields):
        with self._lock:
            self.events.append({"event": kind, **fields})

    def traces(self):
        with self._lock:
            return [e for e in self.events if e["event"] == "trace"]


def _script(module, monkeypatch):
    """Twelve scripted requests; the tracer and its captured events."""
    monkeypatch.setattr(module, "_now", lambda: 77.0)
    cap = CapLogger()
    tracer = module.Tracer(cap, sample=0.3, rng=random.Random(17))
    t = 10.0
    kept_late = None
    for i in range(12):
        ctx = tracer.trace("request", t_start=t, klass="batch")
        ctx.set("tier", "base" if i % 3 else "int8")
        ctx.span_done("admit", None, t + 0.001)
        ctx.span_done("queue", t + 0.001, t + 0.004 + 0.001 * i)
        s = ctx.span("device", t_start=t + 0.01, n=4)
        s.event("requeue", reason="x")
        s.end(t_end=t + 0.02 + 0.01 * i, fetch_block_s=0.002)
        ctx.event("hedge", replica=1)
        if i == 4:
            ctx.mark_tail()
        status = {7: "error", 9: "shed"}.get(i, "ok")
        assert ctx.finish(status, t_end=t + 0.03 + 0.01 * i)
        assert not ctx.finish("ok")
        if ctx.kept and kept_late is None:
            kept_late = ctx
        t += 0.1
    kept_late.span_done("queued", t, t + 0.5)  # a late supplement
    return tracer, cap


def test_tracer_matches_jax(monkeypatch):
    ours, our_cap = _script(trace, monkeypatch)
    theirs, their_cap = _script(jax_trace, monkeypatch)
    assert our_cap.events == their_cap.events
    assert ours.hop_histograms() == theirs.hop_histograms()
    assert ours.stats() == theirs.stats()
    stats = ours.stats()
    full = [e for e in our_cap.traces() if not e.get("late")]
    assert stats["traces"] == 12 and stats["late"] == 1
    assert stats["tail"] == sum(e["status"] != "ok" and not e["sampled"]
                                for e in full) >= 1
    assert {"error", "shed"} <= {e["status"] for e in full}
    assert any(e["tail"] and e["status"] == "ok" for e in full)
    assert trace.HIST_BUCKETS_S == jax_trace.HIST_BUCKETS_S
    for module in (trace, jax_trace):
        with pytest.raises(ValueError, match="sample"):
            module.Tracer(sample=1.5)


def test_null_tracer_is_inert_as_jaxs():
    for module in (trace, jax_trace):
        null = module.NullTracer()
        ctx = null.trace("request")
        assert ctx is module.NULL_TRACE and ctx.trace_id == ""
        span = ctx.span("x")
        span.set("k", 1); span.event("e"); span.end()
        ctx.span_done("y", None, 1.0); ctx.event("e"); ctx.set("k", 1)
        ctx.mark_tail()
        assert ctx.finish("error") is False
        assert null.hop_histograms() == {}
    assert trace.NullTracer().stats() == jax_trace.NullTracer().stats()


def test_prometheus_with_a_tracer_matches_jax(monkeypatch):
    ours, _ = _script(trace, monkeypatch)
    theirs, _ = _script(jax_trace, monkeypatch)
    stats = {"n_requests": 12, "n_errors": 1, "n_shed": 1, "fleet": False,
             "queue_depths": {"16/base": 0}, "n_flushes": 3}
    text = server.render_prometheus(stats, ours)
    assert text == jax_server.render_prometheus(stats, theirs)
    assert "cyclegan_trace_hop_seconds_bucket" in text
    assert server.render_prometheus(stats) == jax_server.render_prometheus(
        stats)


# -- the HTTP server --------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return signal_flax_params(GeneratorConfig(**TINY), 20)


@pytest.fixture(scope="module")
def engine(params):
    return InferenceEngine(
        ModelConfig(generator=GeneratorConfig(**TINY), image_size=SIZE,
                    **KERNEL_LAYOUT),
        generator_state_from_flax(params),
        serve_cfg=ServeConfig(batch_buckets=(1, 4), sizes=(SIZE,)),
        device="cpu")


def _npy(seed, shape=(20, 28, 3)):
    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(seed).integers(0, 255, shape, np.uint8))
    return buf.getvalue()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers["X-Trace-Id"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["X-Trace-Id"], e.read()


def _serve(engine, sample, posts):
    """Serve ``posts`` (bodies) at ``sample``; the replies, the kept
    traces and the /metrics text."""
    cap = CapLogger()
    tracer = trace.Tracer(cap, sample=sample, rng=random.Random(3))
    ex = PipelinedExecutor(engine, max_wait_ms=2.0)
    httpd, app = server.make_server(ex, port=0, tracer=tracer)
    host, port = httpd.server_address[:2]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://{host}:{port}"
    try:
        replies = [_post(f"{base}/translate", body) for body in posts]
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        ex.close()
    return replies, cap.traces(), text


def test_every_answered_request_has_one_trace_with_its_hops(engine):
    replies, kept, text = _serve(engine, 1.0, [_npy(i) for i in range(4)])
    by_id = {}
    for e in kept:
        by_id.setdefault(e["trace_id"], []).append(e)
    for status, trace_id, body in replies:
        assert status == 200 and body[:4] == b"\x89PNG"
        assert re.fullmatch(r"[0-9a-f]{16}", trace_id)
        (ev,) = by_id[trace_id]
        assert ev["status"] == "ok" and ev["sampled"] and not ev["tail"]
        spans = ev["spans"]
        assert [s["name"] for s in spans] == HOPS
        t0, t1 = ev["t_start"], ev["t_end"]
        last = t0
        for s in spans:
            assert t0 <= s["t0"] <= s["t1"] <= t1, s
            assert s["t0"] >= last, s
            last = s["t1"]
        assert spans[0]["t0"] == t0 and spans[-1]["t1"] == t1
    assert len(kept) == len(replies)
    assert "cyclegan_trace_hop_seconds" in text


def test_sample_zero_keeps_only_the_failure(engine):
    replies, kept, _ = _serve(engine, 0.0, [_npy(9), b"not an image"])
    (ok, ok_id, _), (bad, bad_id, _) = replies
    assert (ok, bad) == (200, 500)
    assert ok_id and bad_id and ok_id != bad_id
    assert [(e["trace_id"], e["status"], e["tail"], e["sampled"])
            for e in kept] == [(bad_id, "error", True, False)]


def test_metrics_exposition_parses_with_the_trace_families(engine):
    """tests/test_trace.py's checks of the JAX server's text."""
    _, _, text = _serve(engine, 1.0, [_npy(5), _npy(6)])
    sample_re = re.compile(
        r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? "
        r"(?:[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|nan|inf))$")
    families = set()
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# TYPE "):
            name, kind = line.split()[2:4]
            assert name not in families, f"duplicate TYPE for {name}"
            families.add(name)
            assert kind in ("counter", "gauge", "summary", "histogram")
            continue
        if line.startswith("#"):
            continue
        assert sample_re.match(line), f"unparseable sample line: {line!r}"
    assert {"cyclegan_serve_requests_total", "cyclegan_trace_sample",
            "cyclegan_trace_traces_total", "cyclegan_trace_emitted_total",
            "cyclegan_trace_hop_seconds"} <= families
    bucket_lines = [ln for ln in text.split("\n")
                    if ln.startswith("cyclegan_trace_hop_seconds_bucket")
                    and 'hop="device"' in ln]
    counts = [float(ln.rsplit(" ", 1)[1]) for ln in bucket_lines]
    assert counts and counts == sorted(counts)
    inf_line = [ln for ln in bucket_lines if 'le="+Inf"' in ln]
    count_line = [ln for ln in text.split("\n")
                  if ln.startswith("cyclegan_trace_hop_seconds_count")
                  and 'hop="device"' in ln]
    assert inf_line[0].rsplit(" ", 1)[1] == count_line[0].rsplit(" ", 1)[1]


# -- the entry points' streams ----------------------------------------------

def _fold(path):
    from obs_report import fold, load_events, render

    events, skipped = load_events(path)
    report = fold(events, skipped)
    return events, report, render(report)


def test_server_main_writes_its_stream(tmp_path, monkeypatch, params):
    np.savez(tmp_path / "g.npz", **params)
    path = str(tmp_path / "serve.jsonl")
    built = []
    make = server.make_server

    def make_and_stop(executor, *args, **kw):
        httpd, app = make(executor, *args, **kw)
        built.append(app)

        def stop():
            raise KeyboardInterrupt
        httpd.serve_forever, httpd.shutdown = stop, lambda: None
        return httpd, app

    monkeypatch.setattr(server, "make_server", make_and_stop)
    server.main(["--weights", str(tmp_path / "g.npz"), "--image_size",
                 str(SIZE), "--port", "0", "--int8", "--obs_jsonl", path,
                 "--trace_sample", "1.0", "--device", "cpu"])
    assert built[0].tracer.sample == 1.0
    events, report, text = _fold(path)
    kinds = [e["event"] for e in events]
    assert kinds[0] == "manifest" and events[0]["role"] == "serve"
    assert "mesh" not in events[0]
    assert kinds[-1] == "end" and events[-1]["status"] == "completed"
    assert kinds[1:] == ["serve_summary", "end"]
    assert report["unknown_kinds"] == {}


def test_translate_writes_the_translate_manifest(tmp_path, params):
    np.savez(tmp_path / "g.npz", **params)
    os.makedirs(tmp_path / "in")
    np.save(tmp_path / "in" / "a.npy",
            np.random.default_rng(1).integers(0, 255, (20, 20, 3), np.uint8))
    path = str(tmp_path / "translate.jsonl")
    translate.main(["--weights", str(tmp_path / "g.npz"), "--image_size",
                    str(SIZE), "--input", str(tmp_path / "in"), "--output",
                    str(tmp_path / "out"), "--obs_jsonl", path, "--device",
                    "cpu"])
    assert os.path.exists(tmp_path / "out" / "a.png")
    events, report, text = _fold(path)
    assert events[0]["event"] == "manifest"
    assert events[0]["role"] == "translate"
    assert events[0]["config"]["model"]["image_size"] == SIZE
    assert [e["event"] for e in events[1:]] == ["end"]
    assert report["unknown_kinds"] == {} and "run end: completed" in text

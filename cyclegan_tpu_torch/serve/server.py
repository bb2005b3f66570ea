"""Lightweight HTTP front-end over the port's serving pipeline (the JAX
package's serve/server.py, single-replica mode).

Pure stdlib (http.server): a handler thread only decodes the upload,
submits to the PipelinedExecutor and encodes the resolved result, so
ThreadingHTTPServer's thread per connection is the decode/encode stage
parallelism the executor assumes. PNG output is written with ``zlib`` and
``struct`` (8-bit RGB, filter 0), so serving needs no imaging library;
uploads other than ``.npy`` are decoded with PIL where it is installed.

Endpoints:
  POST /translate   image bytes (a raw .npy image array, or PNG/JPEG/any
                    PIL format) -> translated PNG bytes.
                    ?panels=1 additionally returns the
                    [input | translated | cycled] panel when the engine
                    was built with the cycle pass (--panels).
                    ?tier=int8 routes to the int8 tier (--int8);
                    ?tier=int8_fused to the int8_fused tier (--int8_fused).
                    ?tenant= needs the fleet mode of a later slice and
                    answers 400.
  GET  /healthz     200 once the engine is built: readiness probe.
  GET  /stats       JSON snapshot: requests served, errors, queue depths,
                    tiers.
  GET  /metrics     Prometheus text exposition (version 0.0.4) of the same
                    snapshot, plus the span-derived per-hop latency
                    histograms and the cyclegan_trace_* counters of the
                    request tracer (obs/trace.py).

Every POST reply carries an ``X-Trace-Id`` header (the tracer is always
built and mints an id a request). With --trace_sample F that fraction of
requests, and every failed one whatever F, is kept: its span graph
(admit -> queue -> stack -> submit -> device -> resolve, from timestamps
the executor takes anyway) lands on --obs_jsonl as one ``trace`` event,
which tools/trace_timeline.py turns into a timeline. --obs_jsonl PATH
also writes the run manifest (role "serve"), the executor's
``serve_flush`` events and ``serve_summary``, and ``end``;
tools/obs_report.py folds it. The JAX engine's ``serve_compile`` events
have no counterpart: PyTorch compiles no program at start-up.

Run (weights as translate.py takes them: from the newest verified slot
of the ring under --output_dir, "runs" by default, which must hold one;
from --weights G.npz [F.npz]; or random ones from an explicit --seed):
  python -m cyclegan_tpu_torch.serve.server --output_dir runs --port 8080 \
      [--batch_bucket 8] [--max_wait_ms 5] [--panels] [--int8] \
      [--int8_fused] [--obs_jsonl PATH] [--trace_sample F] [--device cpu]

The JAX server's fleet and tenant flags (--fleet, --capacity,
--default_class, --autoscale, --min_replicas, --max_replicas, --brownout,
--shadow_fraction, --hedge_ms, --tenant, --tenant_slo_ms,
--tenant_shed_budget) are accepted by name and raise "not ported yet"
when given.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from cyclegan_tpu_torch.utils.plotting import to_uint8
from cyclegan_tpu_torch.utils.png import encode_png


class ServeApp:
    """The handler-visible application state: executor + counters. The
    handler reads the executor only through its public ``stats()``.
    ``tracer`` (obs/trace.py) mints one TraceContext a POST; None
    disables tracing."""

    def __init__(self, executor, with_cycle: bool, tracer=None):
        self.executor = executor
        self.with_cycle = with_cycle
        self.tracer = tracer
        self.fleet = False
        self.n_requests = 0
        self.n_errors = 0
        self.n_shed = 0
        self._lock = threading.Lock()

    def count(self, error: bool = False) -> None:
        with self._lock:
            self.n_requests += 1
            if error:
                self.n_errors += 1

    def stats(self) -> dict:
        out = {"n_requests": self.n_requests, "n_errors": self.n_errors,
               "n_shed": self.n_shed, "fleet": self.fleet}
        out.update(self.executor.stats())
        return out


def _prom_escape(value) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_prom_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_prometheus(stats: dict, tracer=None) -> str:
    """Prometheus text exposition (version 0.0.4) rendered with the
    stdlib from the server's ``stats()`` snapshot plus the tracer's
    span-derived hop histograms: host-side dict reads only, safe to
    scrape at any frequency. Tolerant of missing keys, so the fleet's
    keys render where a later slice's fleet executor reports them."""
    lines = []
    seen_meta = set()

    def emit(name, value, labels=None, help_=None, type_="gauge"):
        if value is None:
            return
        if name not in seen_meta:
            seen_meta.add(name)
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {type_}")
        v = float(value)
        out = int(v) if v == int(v) else round(v, 9)
        lines.append(f"{name}{_prom_labels(labels)} {out}")

    emit("cyclegan_serve_requests_total", stats.get("n_requests"),
         help_="HTTP requests handled", type_="counter")
    emit("cyclegan_serve_errors_total", stats.get("n_errors"),
         type_="counter")
    emit("cyclegan_serve_shed_total", stats.get("n_shed"),
         help_="HTTP requests answered 429/503 (shed or expired)",
         type_="counter")
    emit("cyclegan_serve_images_done_total", stats.get("n_images_done"),
         type_="counter")
    emit("cyclegan_serve_flushes_total", stats.get("n_flushes"),
         type_="counter")

    # Pipeline (single-replica) executor: per-bucket queue depths.
    for bucket, depth in sorted(
            (stats.get("queue_depths") or {}).items()):
        emit("cyclegan_serve_queue_depth", depth,
             labels={"bucket": bucket},
             help_="live micro-batcher queue depth per (size, tier)")
    emit("cyclegan_serve_queue_depth_max",
         stats.get("max_queue_depth"))

    # Fleet admission queue.
    adm = stats.get("admission") or {}
    emit("cyclegan_fleet_queue_depth", adm.get("depth"),
         help_="live admission queue depth")
    emit("cyclegan_fleet_queue_capacity", adm.get("capacity"))
    emit("cyclegan_fleet_queue_depth_max", adm.get("max_depth"))
    emit("cyclegan_fleet_drain_rate", adm.get("drain_rate"),
         help_="drain-rate EWMA, images/sec")
    emit("cyclegan_fleet_arrival_rate", adm.get("arrival_rate"))
    emit("cyclegan_fleet_retry_after_seconds", adm.get("retry_after_s"))
    for klass, n in sorted((adm.get("admitted") or {}).items()):
        emit("cyclegan_fleet_admitted_total", n,
             labels={"class": klass}, type_="counter")
    for klass, n in sorted((adm.get("shed") or {}).items()):
        emit("cyclegan_fleet_shed_total", n,
             labels={"class": klass},
             help_="requests shed (rejected + evicted + expired)",
             type_="counter")
    for reason, n in sorted((adm.get("shed_reasons") or {}).items()):
        emit("cyclegan_fleet_shed_reason_total", n,
             labels={"reason": reason}, type_="counter")
    for reason, n in sorted((adm.get("cancelled") or {}).items()):
        emit("cyclegan_fleet_hedge_cancel_total", n,
             labels={"reason": reason}, type_="counter")

    # Per-class latency (summary-style quantile gauges) + misses.
    for klass, row in sorted((stats.get("classes") or {}).items()):
        for q, key in (("0.5", "p50_s"), ("0.95", "p95_s")):
            emit("cyclegan_fleet_latency_seconds", row.get(key),
                 labels={"class": klass, "quantile": q},
                 help_="resolved-request e2e latency by deadline class",
                 type_="summary")
        emit("cyclegan_fleet_deadline_misses_total",
             row.get("deadline_misses"), labels={"class": klass},
             type_="counter")

    # Fleet shape / self-driving overlay counters.
    emit("cyclegan_fleet_replicas", stats.get("n_replicas"))
    emit("cyclegan_fleet_replicas_active",
         stats.get("n_replicas_active"))
    emit("cyclegan_fleet_replicas_busy", stats.get("replicas_busy"))
    emit("cyclegan_fleet_circuits_open", stats.get("circuits_open"))
    emit("cyclegan_fleet_recoveries_total", stats.get("recoveries"),
         type_="counter")
    hedges = stats.get("hedges") or {}
    for key in ("dispatched", "wins", "losses"):
        emit("cyclegan_fleet_hedges_total", hedges.get(key),
             labels={"outcome": key}, type_="counter")
    emit("cyclegan_fleet_degraded_total",
         stats.get("degraded_requests"),
         help_="requests served on a browned-out tier",
         type_="counter")
    quar = stats.get("quarantine") or {}
    for key in ("quarantined", "readmitted", "condemned"):
        emit("cyclegan_fleet_quarantine_total", quar.get(key),
             labels={"action": key}, type_="counter")
    auto = stats.get("autoscale") or {}
    emit("cyclegan_fleet_scale_ups_total", auto.get("scale_ups"),
         type_="counter")
    emit("cyclegan_fleet_scale_downs_total", auto.get("scale_downs"),
         type_="counter")
    brown = stats.get("brownout") or {}
    emit("cyclegan_fleet_brownout_level", brown.get("level"),
         help_="current brownout cascade level (0 = full quality)")

    # Per-tenant rollup.
    for tkey, row in sorted((stats.get("tenants") or {}).items()):
        labels = {"tenant": tkey}
        for q, key in (("0.5", "p50_s"), ("0.95", "p95_s")):
            emit("cyclegan_tenant_latency_seconds", row.get(key),
                 labels=dict(labels, quantile=q), type_="summary")
        emit("cyclegan_tenant_images_total", row.get("n_images"),
             labels=labels, type_="counter")
        emit("cyclegan_tenant_slo_misses_total", row.get("slo_misses"),
             labels=labels, type_="counter")

    # Span-derived hop histograms (obs/trace.py).
    if tracer is not None:
        tstats = tracer.stats()
        emit("cyclegan_trace_sample", tstats.get("sample"),
             help_="head-sampling fraction (--trace_sample)")
        for key in ("traces", "emitted", "tail", "late"):
            emit(f"cyclegan_trace_{key}_total", tstats.get(key),
                 type_="counter")
        from cyclegan_tpu_torch.obs.trace import HIST_BUCKETS_S

        hists = sorted(tracer.hop_histograms().items())
        if hists:
            name = "cyclegan_trace_hop_seconds"
            lines.append(f"# HELP {name} per-hop span durations "
                         f"(seconds), from finished traces")
            lines.append(f"# TYPE {name} histogram")
            for hop, h in hists:
                cum = 0
                for edge, n in zip(HIST_BUCKETS_S, h["buckets"]):
                    cum += n
                    lines.append(
                        f"{name}_bucket"
                        f"{_prom_labels({'hop': hop, 'le': repr(edge)})}"
                        f" {cum}")
                cum += h["buckets"][-1]
                lines.append(
                    f"{name}_bucket"
                    f"{_prom_labels({'hop': hop, 'le': '+Inf'})} {cum}")
                lines.append(
                    f"{name}_sum{_prom_labels({'hop': hop})} "
                    f"{round(h['sum'], 9)}")
                lines.append(
                    f"{name}_count{_prom_labels({'hop': hop})} {cum}")
    return "\n".join(lines) + "\n"


def _decode_upload(body: bytes) -> np.ndarray:
    """Upload bytes -> HWC uint8/float image array: .npy with numpy, any
    other format with PIL."""
    if body[:6] == b"\x93NUMPY":  # .npy magic
        return np.load(io.BytesIO(body), allow_pickle=False)
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def _encode_png(img_float: np.ndarray) -> bytes:
    """[-1, 1] float HW3 -> PNG bytes (the encode stage)."""
    return encode_png(to_uint8(img_float))


def make_handler(app: ServeApp):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/json",
                   headers: Optional[dict] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, b'{"status": "ok"}')
            elif self.path == "/stats":
                self._reply(200, json.dumps(app.stats()).encode())
            elif self.path == "/metrics":
                body = render_prometheus(app.stats(), app.tracer).encode()
                self._reply(200, body,
                            ctype="text/plain; version=0.0.4")
            else:
                self._reply(404, b'{"error": "not found"}')

        def do_POST(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path != "/translate":
                self._reply(404, b'{"error": "not found"}')
                return
            q = urllib.parse.parse_qs(parsed.query)
            want_panel = q.get("panels", ["0"])[0] == "1"
            tier = q.get("tier", [None])[0]
            tenant = q.get("tenant", [None])[0]
            # Mint the trace at ingress, before decode, so the "admit" hop
            # recorded at submission covers decode and preprocessing. The
            # id goes back on every reply (X-Trace-Id).
            ctx = (app.tracer.trace("request")
                   if app.tracer is not None else None)
            hdrs = ({"X-Trace-Id": ctx.trace_id}
                    if ctx is not None else None)
            try:
                length = int(self.headers.get("Content-Length", "0"))
                img = _decode_upload(self.rfile.read(length))
                # Decode runs here (handler thread), compute is batched
                # across connections by the executor, encode runs here
                # again once the future resolves.
                if tenant is not None:
                    raise KeyError(
                        "?tenant= requires fleet mode with configured "
                        "tenants (--fleet N --tenant ...), which is not "
                        "ported yet")
                fut = app.executor.submit_raw(img, tier=tier, trace=ctx)
                result = fut.result(timeout=120)
                if want_panel and "cycled" in result:
                    from cyclegan_tpu_torch.serve.engine import (
                        preprocess_request,
                    )

                    size = result["fake"].shape[0]
                    panel = np.concatenate(
                        [preprocess_request(img, size), result["fake"],
                         result["cycled"]], axis=1)
                    body = _encode_png(panel)
                else:
                    body = _encode_png(result["fake"])
                app.count()
                # The executor finishes the trace of every request it
                # resolves, after its last hop; a finish here could win
                # the race to it and cut the trace short.
                self._reply(200, body, ctype="image/png", headers=hdrs)
            except Exception as e:  # noqa: BLE001 — a request must not kill the server
                app.count(error=True)
                if ctx is not None:
                    ctx.finish("error")
                if isinstance(e, KeyError):
                    # A routing identity the server does not have: the
                    # client's mistake, not a server fault.
                    self._reply(400, json.dumps(
                        {"error": str(e).strip("'\"")}).encode(),
                        headers=hdrs)
                else:
                    self._reply(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(),
                        headers=hdrs)

    return Handler


def make_server(executor, host: str = "127.0.0.1", port: int = 0,
                with_cycle: bool = False, tracer=None):
    """Build (but do not start) the HTTP server; port 0 picks a free one
    (server.server_address reports it). Returns (server, app). ``tracer``
    enables per-request tracing (X-Trace-Id echo + /metrics hop
    histograms)."""
    app = ServeApp(executor, with_cycle, tracer=tracer)
    server = ThreadingHTTPServer((host, port), make_handler(app))
    server.daemon_threads = True
    return server, app


# The JAX server's flags that later slices of the port bring in: each is
# accepted by name and raises when given.
LATER_FLAGS = {
    "--fleet": dict(type=int, help="fleet mode: N replicas"),
    "--capacity": dict(type=int, help="fleet admission queue bound"),
    "--default_class": dict(choices=["interactive", "batch", "best_effort"],
                            help="fleet deadline class"),
    "--autoscale": dict(action="store_true", help="fleet autoscaling"),
    "--min_replicas": dict(type=int, help="autoscale floor"),
    "--max_replicas": dict(type=int, help="autoscale ceiling"),
    "--brownout": dict(action="store_true", help="fleet brownout cascade"),
    "--shadow_fraction": dict(type=float, help="brownout shadow probes"),
    "--hedge_ms": dict(type=float, help="fleet hedged dispatch"),
    "--tenant": dict(action="append", metavar="DOMAIN[/TIER]=RUN_DIR",
                     help="multi-tenant fleet"),
    "--tenant_slo_ms": dict(type=float, help="per-tenant SLO"),
    "--tenant_shed_budget": dict(type=float, help="per-tenant shed budget"),
}


def main(argv: Optional[list] = None) -> None:
    from cyclegan_tpu_torch.config import Config, ModelConfig
    from cyclegan_tpu_torch.convert import (
        config_from_flax,
        generator_state_from_flax,
        layout_from_flax,
    )
    from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from cyclegan_tpu_torch.serve.executor import PipelinedExecutor
    from cyclegan_tpu_torch.translate import resolve_weights

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", default="runs",
                   help="training output dir whose checkpoints/ ring gives "
                        "G and F (when neither --weights nor --seed)")
    p.add_argument("--weights", nargs="+", default=None,
                   help="G (and F) weights: .npz of flat flax parameters")
    p.add_argument("--seed", type=int, default=None,
                   help="draw random weights from this seed (no --weights)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--direction", default="AtoB", choices=["AtoB", "BtoA"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8080, type=int)
    p.add_argument("--image_size", default=None, type=int,
                   help="serving size (default: the checkpoint's, else 256)")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="serving compute dtype of the base tier (default: "
                        "the checkpoint's; the int8 tiers stay float32)")
    p.add_argument("--batch_bucket", default=8, type=int,
                   help="largest flush size (bucket grammar: {1, this})")
    p.add_argument("--max_wait_ms", default=5.0, type=float,
                   help="max ms a lone request waits for batch companions")
    p.add_argument("--panels", action="store_true",
                   help="also run the cycle generator so ?panels=1 works "
                        "(costs a second generator pass)")
    p.add_argument("--int8", action="store_true",
                   help="also serve the int8 weight-quantized tier "
                        "(?tier=int8 routes to it)")
    p.add_argument("--int8_fused", action="store_true",
                   help="also serve the int8_fused tier: upsample weights "
                        "stay int8 into the int8 upsample kernel "
                        "(?tier=int8_fused routes to it)")
    p.add_argument("--obs_jsonl", default=None,
                   help="telemetry stream path (fold with "
                        "tools/obs_report.py)")
    p.add_argument("--trace_sample", default=0.0, type=float,
                   help="head-sampling fraction of requests to trace "
                        "end to end (0..1). Failures are ALWAYS tail-kept "
                        "regardless. Kept traces land on --obs_jsonl as "
                        "'trace' events (timeline via "
                        "tools/trace_timeline.py); /metrics exposes "
                        "span-derived hop histograms either way")
    for flag, kw in LATER_FLAGS.items():
        p.add_argument(flag, default=None, **{
            k: v for k, v in kw.items() if k != "help"},
            help=f"{kw['help']}: not ported yet")
    args = p.parse_args(argv)
    for flag in LATER_FLAGS:
        if getattr(args, flag[2:]) not in (None, False):
            raise SystemExit(
                f"{flag} is not ported yet: it comes with a later slice of "
                "the port (ROADMAP.md, Queue A); this server runs one "
                "replica on weights from --output_dir, --weights or --seed")
    if (args.int8 or args.int8_fused) and args.panels:
        raise SystemExit("--int8/--int8_fused and --panels are mutually "
                         "exclusive (the quantized tiers have no cycle pass)")

    g_params, f_params, model_cfg = resolve_weights(args)
    fwd, bwd = ((g_params, f_params) if args.direction == "AtoB"
                else (f_params, g_params))
    if fwd is None or (args.panels and bwd is None):
        raise SystemExit("this direction / --panels needs both generators: "
                         "--weights G.npz F.npz")
    if model_cfg is None:
        model_cfg = ModelConfig(generator=config_from_flax(fwd),
                                image_size=args.image_size or 256,
                                **layout_from_flax(fwd))
    logger = None
    if args.obs_jsonl:
        from cyclegan_tpu_torch.obs import MetricsLogger, build_manifest

        logger = MetricsLogger(args.obs_jsonl)
        logger.event("manifest", **build_manifest(
            Config(model=model_cfg), query_devices=False, role="serve"))
    serve_cfg = ServeConfig(
        batch_buckets=tuple(sorted({1, args.batch_bucket})),
        sizes=(model_cfg.image_size,),
        dtype=args.dtype or model_cfg.compute_dtype,
        with_cycle=args.panels,
        int8_tier=args.int8,
        infer_tier=args.int8_fused,
    )
    engine = InferenceEngine(
        model_cfg, generator_state_from_flax(fwd),
        generator_state_from_flax(bwd) if args.panels else None,
        serve_cfg=serve_cfg, device=args.device)
    executor = PipelinedExecutor(engine, max_wait_ms=args.max_wait_ms,
                                 logger=logger)
    # The tracer is always built: without --obs_jsonl kept traces go
    # nowhere, but the X-Trace-Id echo and /metrics' hop histograms work.
    from cyclegan_tpu_torch.obs import NullMetricsLogger, Tracer

    tracer = Tracer(logger if logger is not None else NullMetricsLogger(),
                    sample=args.trace_sample)
    server, _app = make_server(executor, args.host, args.port,
                               with_cycle=args.panels, tracer=tracer)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  "
          f"(buckets {serve_cfg.batch_buckets} @ {serve_cfg.sizes}, "
          f"dtype {serve_cfg.dtype}, tiers {engine.tiers}, pipelined, "
          f"{engine.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        executor.close()
        if logger is not None:
            logger.event("end", status="completed")
            logger.close()


if __name__ == "__main__":
    main()

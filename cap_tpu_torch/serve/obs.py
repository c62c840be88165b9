"""Observability exposition surface: /metrics, /snapshot, /flight.

The port of ``cap_tpu.serve.obs``. Every fleet worker (and anything
else that wants one) can serve a tiny HTTP endpoint exposing the
process's telemetry:

- ``/metrics`` — Prometheus text format: counters (``_total``),
  gauges, and histogram series as summaries (p50/p95/p99 quantile
  labels + ``_sum``/``_count``), so any off-the-shelf scraper can
  consume the fleet;
- ``/snapshot`` — the MERGEABLE JSON snapshot
  (:meth:`cap_tpu_torch.telemetry.Recorder.snapshot` plus live extras such
  as batcher depth): ``tools/capstat.py`` scrapes these and merges
  them exactly (bucket counts add) rather than averaging quantiles;
- ``/flight`` — the flight recorder: the N slowest recent TRACED
  request timelines, each a list of span records, from which a
  cross-process trace can be reassembled by joining on the 16-hex
  trace id (``capstat.py --trace``);
- ``/decisions`` — the sampled decision ring
  (:mod:`cap_tpu_torch.obs.decision`): full verdict records with reason
  class, family, latency bucket, hashed kid;
- ``/tenants`` — this worker's per-tenant rollup (issuer HASH →
  tokens / accept / reject mix / vcache splits) plus the exact
  ``lookups == attributed + overflow`` accounting triple, over the
  same merged snapshot ``/snapshot`` serves (docs/OBSERVABILITY.md
  §Tenant attribution — raw issuers never appear here);
- ``/healthz`` — liveness.

Stalled-scraper hardening: every connection runs on its own daemon
handler thread with a SHORT socket timeout (``handler_timeout_s``,
default 5 s) — a scraper that connects and never sends a request, or
stops reading the response, times out and its thread exits instead of
accumulating forever. The worker's serve loop never shares a thread
with scrapes in the first place; the timeout bounds the obs server's
own resource growth under a misbehaving collector (chaos-tested).

Redaction discipline: everything served here comes from the telemetry
recorder, whose write boundary already rejects token-shaped names and
scrubs notes (:func:`cap_tpu_torch.telemetry.check_name`); the server adds
no request-derived content of its own.

The server is stdlib-only (``http.server`` on a daemon thread), binds
127.0.0.1 by default, and costs nothing until scraped.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from .. import telemetry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "cap_" + _NAME_RE.sub("_", name)


def render_prometheus(snapshot: Dict[str, Any],
                      extra_gauges: Optional[Dict[str, float]] = None
                      ) -> str:
    """Prometheus text exposition of a telemetry snapshot.

    Counters → ``cap_<name>_total``; gauges (snapshot + extras) →
    ``cap_<name>``; histogram series → summary: quantile-labelled
    samples (computed from the log-scale buckets) plus _sum/_count.
    """
    lines = ["# TYPE cap_up gauge", "cap_up 1"]
    for name, v in sorted((snapshot.get("counters") or {}).items()):
        pn = _prom_name(name) + "_total"
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {v}")
    gauges = dict(snapshot.get("gauges") or {})
    gauges.update(extra_gauges or {})
    for name, v in sorted(gauges.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {float(v):g}")
    summaries = telemetry.summarize_snapshot(snapshot)
    for name, s in sorted(summaries.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} summary")
        for q in ("0.5", "0.95", "0.99"):
            key = "p" + str(int(float(q) * 100))
            lines.append(f'{pn}{{quantile="{q}"}} {s[key]:.9g}')
        lines.append(f"{pn}_sum {s['total']:.9g}")
        lines.append(f"{pn}_count {int(s['count'])}")
    return "\n".join(lines) + "\n"


class ObsServer:
    """Serve the process's telemetry over HTTP (daemon thread).

    extra: callable returning live numeric gauges to fold into every
    scrape (the worker passes batcher depth/inflight); flight_n: how
    many slowest timelines ``/flight`` returns.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 extra: Optional[Callable[[], Dict[str, float]]] = None,
                 snapshot_extra: Optional[Callable[[], Optional[
                     Dict[str, Any]]]] = None,
                 flight_n: int = 32, handler_timeout_s: float = 5.0):
        self._extra = extra
        # snapshot_extra: callable returning an ADDITIONAL mergeable
        # snapshot (or None) folded into /metrics and /snapshot via
        # merge_snapshots — the worker passes its native telemetry
        # plane, so natively-counted decisions and histograms scrape
        # exactly like recorder-side ones.
        self._snapshot_extra = snapshot_extra
        self._flight_n = flight_n
        obs = self

        class _Handler(BaseHTTPRequestHandler):
            # Socket timeout for the whole request/response exchange
            # (stdlib applies it in setup()): a scraper that stalls —
            # never sends the request line, or never drains the
            # response — raises in ITS handler thread and the thread
            # exits; other scrapes and the worker loop are unaffected.
            timeout = handler_timeout_s

            def log_message(self, *args):   # no stderr chatter
                pass

            def handle_timeout(self):       # noqa: N802 (stdlib API)
                self.close_connection = True

            def do_GET(self):               # noqa: N802 (stdlib API)
                try:
                    obs._respond(self)
                except (BrokenPipeError, ConnectionResetError,
                        TimeoutError, OSError):
                    self.close_connection = True

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="cap-gpu-obs")
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass

    # -- handlers ---------------------------------------------------------

    def _extras(self) -> Dict[str, float]:
        try:
            return dict(self._extra()) if self._extra is not None else {}
        except Exception:  # noqa: BLE001 - a scrape must never 500 on it
            return {}

    def _snapshot(self, rec) -> Dict[str, Any]:
        if rec is not None:
            # flush the occupancy plane's counter deltas + window
            # gauges BEFORE the snapshot is taken, so every scrape is
            # self-contained (no-op until an engine dispatches)
            try:
                from ..obs import occupancy as _occupancy

                _occupancy.publish(rec)
            except Exception:  # noqa: BLE001 - never 500 a scrape
                pass
        snap = rec.snapshot() if rec is not None else {}
        if self._snapshot_extra is not None:
            try:
                extra_snap = self._snapshot_extra()
            except Exception:  # noqa: BLE001 - never 500 a scrape
                extra_snap = None
            if extra_snap:
                snap = telemetry.merge_snapshots([snap, extra_snap])
        return snap

    def _respond(self, h: BaseHTTPRequestHandler) -> None:
        rec = telemetry.active()
        path = h.path.split("?", 1)[0]
        if path == "/metrics":
            body = render_prometheus(self._snapshot(rec),
                                     self._extras()).encode()
            ctype = "text/plain; version=0.0.4"
        elif path == "/snapshot":
            body = json.dumps({
                "snapshot": self._snapshot(rec),
                "extra": self._extras(),
            }).encode()
            ctype = "application/json"
        elif path == "/flight":
            entries = (rec.flight_slowest(self._flight_n)
                       if rec is not None else [])
            body = json.dumps({"slowest": entries}).encode()
            ctype = "application/json"
        elif path == "/decisions":
            body = json.dumps({
                "decisions": rec.decisions() if rec is not None else [],
            }).encode()
            ctype = "application/json"
        elif path == "/tenants":
            from ..obs import decision as _decision

            counters = self._snapshot(rec).get("counters") or {}
            body = json.dumps({
                "tenants": _decision.tenant_totals(counters),
                "lookups": counters.get("tenant.lookups", 0),
                "attributed": counters.get("tenant.attributed", 0),
                "overflow": counters.get("tenant.overflow", 0),
            }).encode()
            ctype = "application/json"
        elif path == "/healthz":
            body = b'{"ok": true}'
            ctype = "application/json"
        else:
            h.send_response(404)
            h.end_headers()
            return
        h.send_response(200)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

"""Instrumentation: bounded metrics, structured tracing, flight record.

The port of ``cap_tpu.telemetry``, with the same names, buckets and
snapshot format, so a snapshot taken here merges with one taken there.

- a process-local :class:`Recorder` with named counters, gauges, and
  **bounded** log-scale histograms (``observe`` into a long-running
  worker stays O(buckets) forever — raw samples are retained only up
  to a small reservoir cap, quantiles come from the buckets beyond
  it);
- **mergeable snapshots** (:meth:`Recorder.snapshot`,
  :func:`merge_snapshots`): bucket counts add exactly, so an
  aggregate of per-worker snapshots yields the same quantiles as one
  recorder observing everything;
- **structured tracing**: a 16-hex trace id carried in a
  ``contextvars`` context (:func:`trace` / :func:`current_trace`),
  per-stage span records (:func:`span` attaches automatically when a
  trace is active, :func:`trace_span` records explicitly from worker
  threads), and the CVB1 trace-context frame field
  (:mod:`cap_tpu_torch.serve.protocol` types 9/10) to cross process
  boundaries;
- a **flight recorder**: a bounded ring of completed request
  timelines, from which the slowest recent requests can be replayed
  span by span.

Recorders store ONLY metric names and numbers — never tokens, keys,
claims, or any request payload. Metric names are *checked* on first
use (:func:`check_name` rejects anything token-shaped), and span notes
pass through :func:`scrub_note`.

Telemetry is off by default (zero overhead beyond one attribute check
on the hot path); enable with ``telemetry.enable()`` or scoped via
``telemetry.recording()``.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from bisect import bisect_left
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# registered span names (the same table as cap_tpu.telemetry —
# tests pin the two against each other so names cannot drift)
# ---------------------------------------------------------------------------

SPAN_FRONTDOOR_ROUTE = "frontdoor.route"    # FrontDoor partition+dispatch
SPAN_FRONTDOOR_RELAY = "frontdoor.relay"    # native gate slow-path handoff
SPAN_CLIENT_SUBMIT = "client.submit"        # FleetClient.verify_batch, whole
SPAN_ROUTER_ATTEMPT = "router.attempt"      # one wire attempt on one worker
SPAN_ROUTER_HEDGE = "router.hedge"          # duplicate attempt on a peer
SPAN_ROUTER_BACKOFF = "router.backoff"      # sleep between retry rounds
SPAN_ROUTER_FALLBACK = "router.fallback"    # terminal CPU-oracle verify
SPAN_WORKER_DEQUEUE = "worker.dequeue"      # frame read -> batcher admit
SPAN_BATCHER_FILL = "batcher.fill"          # batcher admit -> flush start
SPAN_BATCHER_FLUSH = "batcher.flush"        # sync verify_batch call
SPAN_BATCHER_DISPATCH = "batcher.dispatch"  # async dispatch (prep+H2D)
SPAN_BATCHER_COLLECT = "batcher.collect"    # async device drain
SPAN_KEYPLANE_SWAP = "keyplane.swap"        # key-table build + hot swap
SPAN_NATIVE_DRAIN = "serve.native.drain"    # ring drain -> batcher submit
SPAN_NATIVE_POST = "serve.native.post"      # verdicts -> native writers
SPAN_SHM_ATTACH = "serve.shm.attach"        # shm region map + negotiate
SPAN_OIDC_VALIDATE = "oidc.claims_validate"  # raw-batch claims rules
SPAN_ENGINE_PREFIX = "dispatch."            # dispatch.<family>.<detail>

SPAN_NAMES = frozenset({
    SPAN_CLIENT_SUBMIT, SPAN_ROUTER_ATTEMPT, SPAN_ROUTER_HEDGE,
    SPAN_ROUTER_BACKOFF, SPAN_ROUTER_FALLBACK, SPAN_WORKER_DEQUEUE,
    SPAN_BATCHER_FILL, SPAN_BATCHER_FLUSH, SPAN_BATCHER_DISPATCH,
    SPAN_BATCHER_COLLECT, SPAN_KEYPLANE_SWAP, SPAN_NATIVE_DRAIN,
    SPAN_NATIVE_POST, SPAN_SHM_ATTACH, SPAN_OIDC_VALIDATE,
    SPAN_FRONTDOOR_ROUTE, SPAN_FRONTDOOR_RELAY,
})

# ---------------------------------------------------------------------------
# histogram buckets: log-scale, fixed at import time
# ---------------------------------------------------------------------------

# Geometric bucket edges covering 100 ns .. 1e7 (seconds for spans,
# dimensionless for batch sizes / ratios), 4 buckets per octave →
# ≤ ~9% quantile error at the geometric midpoint. ~190 edges, shared
# (module-level) by every histogram — per-series memory is one int
# array plus the reservoir.
_HIST_LO = 1e-7
_HIST_HI = 1e7
_PER_OCTAVE = 4


def _make_bounds() -> Tuple[float, ...]:
    bounds: List[float] = []
    step = 2.0 ** (1.0 / _PER_OCTAVE)
    v = _HIST_LO
    while v < _HIST_HI:
        bounds.append(v)
        v *= step
    bounds.append(_HIST_HI)
    return tuple(bounds)


BUCKET_BOUNDS: Tuple[float, ...] = _make_bounds()
_N_BUCKETS = len(BUCKET_BOUNDS) + 1          # +1 overflow bucket

# Raw samples kept per series before going bucket-only. Small counts
# (most tests, cold workers) get EXACT quantiles; past the cap the
# series stays O(buckets) no matter how many observations arrive.
RESERVOIR_CAP = 256

# Bounded trace storage: span records and completed-request timelines.
MAX_TRACE_SPANS = 4096
MAX_FLIGHT_ENTRIES = 256
# Bounded decision ring: sampled verdict records (cap_tpu_torch.obs.decision).
MAX_DECISION_ENTRIES = 256


class Histogram:
    """Fixed-bucket log-scale histogram + exact count/sum/min/max.

    NOT thread-safe on its own — the owning Recorder's lock guards it.
    """

    __slots__ = ("counts", "count", "total", "vmin", "vmax", "raw")

    def __init__(self) -> None:
        self.counts = [0] * _N_BUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.raw: Optional[List[float]] = []   # None once bucket-only

    def add(self, value: float) -> None:
        self.counts[bisect_left(BUCKET_BOUNDS, value)] += 1
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        if self.raw is not None:
            if len(self.raw) < RESERVOIR_CAP:
                self.raw.append(value)
            else:
                self.raw = None                # bucket-only from now on

    def add_many(self, value: float, k: int) -> None:
        """``k`` observations of the same value in one bucket add
        (``sum += value * k`` — the exact arithmetic the native
        telemetry plane replicates, so merged states stay
        bit-identical). The per-tenant latency fold uses this: one add
        per (chunk, tenant), never per token."""
        if k <= 0:
            return
        self.counts[bisect_left(BUCKET_BOUNDS, value)] += k
        self.count += k
        self.total += value * k
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        if self.raw is not None:
            if len(self.raw) + k <= RESERVOIR_CAP:
                self.raw.extend([value] * k)
            else:
                self.raw = None                # bucket-only from now on

    def quantile(self, q: float) -> float:
        """Exact while the reservoir holds every sample; bucket
        geometric-midpoint interpolation beyond it."""
        if self.count == 0:
            return 0.0
        if self.raw is not None and len(self.raw) == self.count:
            vals = sorted(self.raw)
            idx = min(len(vals) - 1,
                      max(0, int(round(q * (len(vals) - 1)))))
            return vals[idx]
        rank = q * (self.count - 1)
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            seen += c
            if seen > rank:
                lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                hi = (BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS)
                      else self.vmax)
                mid = ((lo * hi) ** 0.5 if lo > 0 else hi / 2.0)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def state(self) -> Dict[str, Any]:
        """Mergeable snapshot: sparse bucket counts + exact moments."""
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "buckets": {str(i): c for i, c in enumerate(self.counts)
                        if c},
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "Histogram":
        h = cls()
        h.raw = None                           # snapshots are bucket-only
        h.count = int(state.get("count", 0))
        h.total = float(state.get("sum", 0.0))
        if h.count:
            h.vmin = float(state.get("min", 0.0))
            h.vmax = float(state.get("max", 0.0))
        for i, c in (state.get("buckets") or {}).items():
            h.counts[int(i)] += int(c)
        return h


# ---------------------------------------------------------------------------
# name hygiene (redaction enforcement at the write boundary)
# ---------------------------------------------------------------------------

MAX_NAME_LEN = 120


def check_name(name: str) -> str:
    """Reject metric/span names that could smuggle payload material:
    over-long names, embedded whitespace/newlines, anything starting
    like a JWS segment (``eyJ`` = base64url('{"')), or a raw ISSUER
    string (URL-shaped — ``://``; tenants are recorded ONLY as
    sha256(iss)[:12] hashes, docs/OBSERVABILITY.md §Tenant
    attribution). Applied on FIRST use of a name (dict miss), so the
    hot path stays one dict hit."""
    if (len(name) > MAX_NAME_LEN or "eyJ" in name or "://" in name
            or any(ch.isspace() for ch in name)):
        raise ValueError(
            f"metric name rejected by redaction rules (len="
            f"{len(name)}): names must be short registered "
            f"identifiers, never payload material")
    return name


def scrub_note(note: Optional[str]) -> Optional[str]:
    """Span notes are free-text-ish (endpoints, family names) — bound
    the length and drop anything token-shaped or issuer-shaped (raw
    issuer URLs are tenant PII — only their hashes may be recorded)
    rather than record it."""
    if note is None:
        return None
    if "eyJ" in note or "://" in note or len(note) > MAX_NAME_LEN:
        return "[redacted]"
    return note


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------


class Recorder:
    """Thread-safe counters + gauges + bounded histograms + traces."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._series: Dict[str, Histogram] = {}
        self._trace_spans: deque = deque(maxlen=MAX_TRACE_SPANS)
        self._flight: deque = deque(maxlen=MAX_FLIGHT_ENTRIES)
        self._decisions: deque = deque(maxlen=MAX_DECISION_ENTRIES)

    # -- write side -------------------------------------------------------

    def count(self, name: str, n: int = 1) -> int:
        """Increment and return the new value (the return value lets
        deterministic samplers key off the count without re-reading
        the whole counter map)."""
        with self._lock:
            if name in self._counters:
                self._counters[name] += n
            else:
                self._counters[check_name(name)] = n
            return self._counters[name]

    def count_many(self, increments: Dict[str, int]) -> Dict[str, int]:
        """Apply several counter increments under ONE lock acquisition;
        returns the post-increment value per name (same contract as
        :meth:`count`, batched — the decision hot path uses this so a
        drained chunk costs one lock round, not one per counter)."""
        out: Dict[str, int] = {}
        with self._lock:
            counters = self._counters
            for name, n in increments.items():
                if name in counters:
                    counters[name] += n
                else:
                    counters[check_name(name)] = n
                out[name] = counters[name]
        return out

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            if name not in self._gauges:
                check_name(name)
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._series.get(name)
            if h is None:
                h = self._series[check_name(name)] = Histogram()
            h.add(float(value))

    def observe_many(self, name: str, value: float, k: int) -> None:
        """``k`` observations of one value under one lock round (see
        :meth:`Histogram.add_many`)."""
        if k <= 0:
            return
        with self._lock:
            h = self._series.get(name)
            if h is None:
                h = self._series[check_name(name)] = Histogram()
            h.add_many(float(value), k)

    @contextmanager
    def span(self, name: str, note: Optional[str] = None) -> Iterator[None]:
        """Time a block; the duration lands in the ``name`` series (s).
        When a trace context is active, a span record is attached to
        the trace(s) as well."""
        traces = _trace_ctx.get()
        t0_wall = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            self.observe(name, dur)
            if traces is not None:
                self.trace_span(traces, name, t0_wall, dur, note=note)

    def trace_span(self, trace: Union[str, Sequence[str]], name: str,
                   t0: float, dur: float,
                   note: Optional[str] = None) -> None:
        """Record a span explicitly (worker threads where the context
        var does not flow). ``trace`` may be one id or several (a
        coalesced batch fans its device spans out to every member)."""
        if not trace:
            return
        ids = (trace,) if isinstance(trace, str) else tuple(trace)
        note = scrub_note(note)
        with self._lock:
            if name not in self._series and name not in SPAN_NAMES:
                check_name(name)
            for tid in ids:
                rec = {"trace": tid, "name": name, "t0": t0, "dur": dur}
                if note:
                    rec["note"] = note
                self._trace_spans.append(rec)

    def flight(self, trace: str, total_s: float,
               note: Optional[str] = None) -> None:
        """Close out a traced request: snapshot its span records into
        the flight ring (bounded; ``flight_slowest`` reads it back)."""
        note = scrub_note(note)
        with self._lock:
            spans = [dict(s) for s in self._trace_spans
                     if s["trace"] == trace]
            entry: Dict[str, Any] = {"trace": trace, "t_done": time.time(),
                                     "total_s": total_s, "spans": spans}
            if note:
                entry["note"] = note
            self._flight.append(entry)

    def decision(self, entry: Dict[str, Any]) -> None:
        """Append one sampled decision record (bounded ring; entries
        are built and redaction-checked by cap_tpu_torch.obs.decision)."""
        with self._lock:
            self._decisions.append(dict(entry))

    def decision_many(self, entries: Sequence[Dict[str, Any]]) -> None:
        """Append several decision records under ONE lock round (the
        native plane's exemplar pump hands over a drained batch)."""
        with self._lock:
            self._decisions.extend(dict(e) for e in entries)

    # -- read side --------------------------------------------------------

    def decisions(self) -> List[dict]:
        with self._lock:
            return [dict(d) for d in self._decisions]

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def series(self, name: str) -> List[float]:
        """Raw reservoir samples (complete below RESERVOIR_CAP
        observations; empty once a hot series goes bucket-only)."""
        with self._lock:
            h = self._series.get(name)
            return list(h.raw) if h is not None and h.raw else []

    def trace_spans(self, trace: Optional[str] = None) -> List[dict]:
        with self._lock:
            return [dict(s) for s in self._trace_spans
                    if trace is None or s["trace"] == trace]

    def flight_entries(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._flight]

    def flight_slowest(self, n: int = 32) -> List[dict]:
        """The n slowest request timelines still in the ring."""
        return sorted(self.flight_entries(),
                      key=lambda e: e["total_s"], reverse=True)[:n]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-series {count, total, mean, p50, p95, p99, max}."""
        with self._lock:
            items = list(self._series.items())
            stats = [(k, h.count, h.total, h.quantile(0.50),
                      h.quantile(0.95), h.quantile(0.99), h.vmax)
                     for k, h in items if h.count]
        return {name: {"count": float(n), "total": total,
                       "mean": total / n, "p50": p50, "p95": p95,
                       "p99": p99, "max": vmax}
                for name, n, total, p50, p95, p99, vmax in stats}

    def snapshot(self) -> Dict[str, Any]:
        """Mergeable JSON-able state: counters, gauges, histogram
        bucket counts. ``merge_snapshots`` adds these exactly."""
        with self._lock:
            return {
                "v": 1,
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "series": {k: h.state()
                           for k, h in self._series.items() if h.count},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._series.clear()
            self._trace_spans.clear()
            self._flight.clear()
            self._decisions.clear()


# ---------------------------------------------------------------------------
# snapshot merge + summary (the fleet aggregation path)
# ---------------------------------------------------------------------------


def merge_snapshots(snaps: Sequence[Optional[Dict[str, Any]]]
                    ) -> Dict[str, Any]:
    """Exact aggregate of recorder snapshots: counters and histogram
    buckets ADD; gauges add too (fleet gauges are occupancy-like —
    queued tokens, open breakers — where the fleet total is the sum).
    Quantiles of the merged histograms equal those of one recorder
    that had observed every sample (within bucket resolution)."""
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    series: Dict[str, Histogram] = {}
    for snap in snaps:
        if not snap:
            continue
        for k, v in (snap.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + int(v)
        for k, v in (snap.get("gauges") or {}).items():
            gauges[k] = gauges.get(k, 0.0) + float(v)
        for k, st in (snap.get("series") or {}).items():
            h = Histogram.from_state(st)
            if k in series:
                prev = series[k]
                for i, c in enumerate(h.counts):
                    prev.counts[i] += c
                prev.count += h.count
                prev.total += h.total
                prev.vmin = min(prev.vmin, h.vmin)
                prev.vmax = max(prev.vmax, h.vmax)
            else:
                series[k] = h
    return {"v": 1, "counters": counters, "gauges": gauges,
            "series": {k: h.state() for k, h in series.items()}}


def summarize_snapshot(snap: Dict[str, Any]
                       ) -> Dict[str, Dict[str, float]]:
    """summary()-shaped quantiles computed from a (merged) snapshot."""
    out: Dict[str, Dict[str, float]] = {}
    for name, st in (snap.get("series") or {}).items():
        h = Histogram.from_state(st)
        if not h.count:
            continue
        out[name] = {"count": float(h.count), "total": h.total,
                     "mean": h.total / h.count,
                     "p50": h.quantile(0.50), "p95": h.quantile(0.95),
                     "p99": h.quantile(0.99), "max": h.vmax}
    return out


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------

_trace_ctx: "contextvars.ContextVar[Optional[Union[str, Tuple[str, ...]]]]" \
    = contextvars.ContextVar("cap_tpu_trace", default=None)

TRACE_HEX = "0123456789abcdef"


def new_trace_id() -> str:
    """16 lowercase hex chars (64 random bits)."""
    return os.urandom(8).hex()


def valid_trace_id(tid: str) -> bool:
    return (0 < len(tid) <= 64 and len(tid) % 2 == 0
            and all(c in TRACE_HEX for c in tid))


def current_trace() -> Optional[str]:
    """The active trace id (first of the set, if a batch scope)."""
    t = _trace_ctx.get()
    if t is None or isinstance(t, str):
        return t
    return t[0] if t else None


def current_traces() -> Tuple[str, ...]:
    t = _trace_ctx.get()
    if t is None:
        return ()
    return (t,) if isinstance(t, str) else tuple(t)


@contextmanager
def trace(trace_id: Optional[str] = None) -> Iterator[str]:
    """Scoped trace context: spans inside attach to this id."""
    tid = trace_id if trace_id is not None else new_trace_id()
    token = _trace_ctx.set(tid)
    try:
        yield tid
    finally:
        _trace_ctx.reset(token)


@contextmanager
def trace_scope(trace_ids: Sequence[str]) -> Iterator[None]:
    """Batch scope: spans inside fan out to EVERY id (a coalesced
    device batch serves many traced requests at once)."""
    token = _trace_ctx.set(tuple(trace_ids) if trace_ids else None)
    try:
        yield
    finally:
        _trace_ctx.reset(token)


# -- module-level switchboard ---------------------------------------------

_recorder: Optional[Recorder] = None


def enable(recorder: Optional[Recorder] = None) -> Recorder:
    """Turn telemetry on (idempotent); returns the active recorder."""
    global _recorder
    if recorder is not None:
        _recorder = recorder
    elif _recorder is None:
        _recorder = Recorder()
    return _recorder


def disable() -> None:
    global _recorder
    _recorder = None


def active() -> Optional[Recorder]:
    """The live recorder, or None when telemetry is off."""
    return _recorder


@contextmanager
def recording(recorder: Optional[Recorder] = None) -> Iterator[Recorder]:
    """Scoped telemetry: enable for the block, restore the prior state."""
    global _recorder
    prev = _recorder
    rec = recorder if recorder is not None else Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = prev


def count(name: str, n: int = 1) -> Optional[int]:
    rec = _recorder
    if rec is not None:
        return rec.count(name, n)
    return None


def gauge(name: str, value: float) -> None:
    rec = _recorder
    if rec is not None:
        rec.gauge(name, value)


def observe(name: str, value: float) -> None:
    rec = _recorder
    if rec is not None:
        rec.observe(name, value)


def trace_span(trace_ids: Union[str, Sequence[str]], name: str,
               t0: float, dur: float, note: Optional[str] = None) -> None:
    rec = _recorder
    if rec is not None:
        rec.trace_span(trace_ids, name, t0, dur, note=note)


def flight(trace_id: str, total_s: float,
           note: Optional[str] = None) -> None:
    rec = _recorder
    if rec is not None:
        rec.flight(trace_id, total_s, note=note)


@contextmanager
def span(name: str, note: Optional[str] = None) -> Iterator[None]:
    rec = _recorder
    if rec is None:
        yield
        return
    with rec.span(name, note=note):
        yield

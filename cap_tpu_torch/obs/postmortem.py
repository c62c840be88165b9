"""Crash postmortems: what a worker looked like just before it died.

The port of ``cap_tpu.obs.postmortem``. A ``kill -9`` leaves no chance
to flush logs — so the flight recorder, counters, and decision ring a
worker accumulated die with it, exactly when they are most needed. The
fix is checkpoint-shaped, not signal-shaped:

- every worker runs a :class:`PostmortemWriter`: an immediate
  checkpoint at startup, then one every ``interval_s`` seconds, each
  an ATOMIC write (tmp + ``os.replace``) of the process's telemetry
  state to a well-known path (``worker_main --postmortem-path``, passed
  by the pool);
- on SIGTERM drain the worker writes one final fresh checkpoint
  (reason ``sigterm-drain``);
- the :class:`~cap_tpu_torch.fleet.pool.WorkerPool` COLLECTS the file once a
  worker's death is confirmed — so even the hardest crash leaves a
  postmortem at most one checkpoint interval stale;
- ``capstat --postmortem FILE`` renders it (final flight ring, stage
  quantiles, decision/reason counters, queue depth at death).

Redaction: everything checkpointed comes from the telemetry recorder
(whose write boundary already rejects token-shaped content), and the
writer re-scrubs the serialized document anyway — any string that
looks like a JWS segment or is implausibly long is replaced with
``[redacted]`` before it reaches disk. Defense in depth: a postmortem
file must be shareable in an incident channel.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .. import telemetry

PM_VERSION = 1
DEFAULT_INTERVAL_S = 2.0
_MAX_STR = 512
_FLIGHT_KEEP = 16


def _scrub(obj: Any) -> Any:
    """Recursive write-boundary scrub (strings only; keys included).
    Token-shaped, over-long, and raw-issuer-shaped (URL — tenants are
    recorded only as hashes) strings are all replaced."""
    if isinstance(obj, str):
        if "eyJ" in obj or "://" in obj or len(obj) > _MAX_STR:
            return "[redacted]"
        return obj
    if isinstance(obj, dict):
        return {_scrub(k): _scrub(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    return obj


def build_postmortem(reason: str,
                     stats_fn: Optional[Callable[[], Dict[str, Any]]]
                     = None,
                     t_start: Optional[float] = None) -> Dict[str, Any]:
    """Assemble (and scrub) one postmortem document from the live
    process state. Never raises — a failing stats callback degrades to
    an error note, because the checkpoint path must survive exactly
    the situations that break everything else."""
    rec = telemetry.active()
    doc: Dict[str, Any] = {
        "v": PM_VERSION,
        "pid": os.getpid(),
        "reason": reason,
        "t_write": time.time(),
    }
    if t_start is not None:
        doc["uptime_s"] = round(time.time() - t_start, 3)
    snap = None
    if stats_fn is not None:
        try:
            stats = dict(stats_fn())
            # the stats snapshot is the worker's MERGED view (recorder
            # + native telemetry plane, serve.worker.stats) — prefer
            # it over the bare recorder so natively-counted decisions
            # survive into the document (carried once, below)
            snap = stats.pop("snapshot", None)
            doc["stats"] = stats
        except Exception as e:  # noqa: BLE001 - keep checkpointing
            doc["stats_error"] = repr(e)[:_MAX_STR]
    if rec is not None:
        doc["snapshot"] = snap if snap else rec.snapshot()
        doc["flight"] = rec.flight_slowest(_FLIGHT_KEEP)
        doc["decisions"] = rec.decisions()
    elif snap:
        doc["snapshot"] = snap
    return _scrub(doc)


def write_postmortem(path: str, doc: Dict[str, Any]) -> None:
    """Atomic single-file write: readers (the pool, capstat) never see
    a torn document, even when SIGKILL lands mid-checkpoint."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_postmortem(path: str) -> Optional[Dict[str, Any]]:
    """Parse a postmortem file; None when absent/unreadable (a worker
    that died before its first checkpoint, or an empty slot)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class PostmortemWriter:
    """Periodic checkpointer (daemon thread) + final-write hook.

    Writes IMMEDIATELY on construction (so a worker killed in its
    first milliseconds still leaves a document), then every
    ``interval_s``. ``close(reason)`` writes one final fresh
    checkpoint and stops the timer — the SIGTERM drain path.
    """

    def __init__(self, path: str, interval_s: float = DEFAULT_INTERVAL_S,
                 stats_fn: Optional[Callable[[], Dict[str, Any]]] = None):
        self.path = path
        self._interval = max(0.05, float(interval_s))
        self._stats_fn = stats_fn
        self._t_start = time.time()
        self._stop = threading.Event()
        self.write_now("startup")
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="cap-gpu-postmortem")
        self._thread.start()

    def write_now(self, reason: str) -> None:
        try:
            write_postmortem(self.path, build_postmortem(
                reason, self._stats_fn, self._t_start))
        except OSError:
            pass                       # a full disk must not kill serving

    def close(self, reason: str = "shutdown") -> None:
        self._stop.set()
        self.write_now(reason)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.write_now("checkpoint")


# ---------------------------------------------------------------------------
# rendering (capstat --postmortem)
# ---------------------------------------------------------------------------


def render_postmortem(doc: Dict[str, Any]) -> str:
    """One-screen incident view of a collected postmortem."""
    lines: List[str] = []
    age = time.time() - float(doc.get("t_write", 0.0))
    lines.append(
        f"postmortem pid={doc.get('pid')} reason={doc.get('reason')} "
        f"written {age:.1f}s ago"
        + (f" uptime={doc.get('uptime_s')}s" if "uptime_s" in doc
           else ""))
    stats = doc.get("stats") or {}
    if stats:
        lines.append(
            f"  queue at death: queued_tokens="
            f"{stats.get('queued_tokens', 0)} inflight_batches="
            f"{stats.get('inflight_batches', 0)}")
    snap = doc.get("snapshot") or {}
    counters = snap.get("counters") or {}
    worker_counts = {k: v for k, v in sorted(counters.items())
                     if k.startswith(("worker.", "batcher.flushes"))}
    if worker_counts:
        lines.append("  counters: " + "  ".join(
            f"{k}={v}" for k, v in worker_counts.items()))
    from . import decision as _decision

    rollup = _decision.surface_totals(counters)
    for surf, row in sorted(rollup.items()):
        reasons = "  ".join(f"{k.split('.', 1)[1]}={v}"
                            for k, v in sorted(row.items())
                            if k.startswith("reject."))
        lines.append(f"  decisions[{surf}]: accept={row['accept']} "
                     f"reject={row['reject']}"
                     + (f"  ({reasons})" if reasons else ""))
    tenants = _decision.tenant_totals(counters)
    if tenants:
        lines.append(f"  tenants ({len(tenants)} attributed):")
        ordered = sorted(tenants.items(),
                         key=lambda kv: kv[1].get("tokens", 0),
                         reverse=True)
        for t, r in ordered[:8]:
            mix = "  ".join(f"{k.split('.', 1)[1]}={v}"
                            for k, v in sorted(r.items())
                            if k.startswith("reject."))
            lines.append(
                f"    tenant={t:<12} tokens={r.get('tokens', 0)} "
                f"accept={r.get('accept', 0)} "
                f"reject={r.get('reject', 0)}"
                + (f"  wrong_verdicts={r['wrong_verdicts']}"
                   if r.get("wrong_verdicts") else "")
                + (f"  ({mix})" if mix else ""))
    summary = telemetry.summarize_snapshot(snap)
    for name in sorted(summary):
        s = summary[name]
        lines.append(f"  {name:<28} n={int(s['count']):>7}  "
                     f"p50={s['p50'] * 1e3:9.3f}ms  "
                     f"p99={s['p99'] * 1e3:9.3f}ms")
    flights = doc.get("flight") or []
    if flights:
        lines.append(f"  final flight ring ({len(flights)} traced):")
        for e in flights[:8]:
            lines.append(f"    trace={e.get('trace')} "
                         f"total={float(e.get('total_s', 0)) * 1e3:.3f}ms "
                         f"spans={len(e.get('spans') or [])}")
    decisions = doc.get("decisions") or []
    if decisions:
        lines.append(f"  decision ring ({len(decisions)} sampled):")
        for d in decisions[-8:]:
            lines.append(
                "    " + " ".join(f"{k}={v}" for k, v in d.items()))
    return "\n".join(lines)

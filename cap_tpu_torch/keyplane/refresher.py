"""The refresher: epoch-versioned snapshots with stampede protection.

The port of ``cap_tpu.keyplane.refresher``. A :class:`Refresher` pulls
JWKS documents out of a
:class:`~cap_tpu_torch.keyplane.source.KeySource` and versions them into
:class:`Snapshot` objects — the epoch counter increments ONLY when the
document's canonical digest changes, so jittered periodic polling of a
stable IdP never churns epochs (and never rebuilds device tables).

Stampede protection, in layers:

- **singleflight**: concurrent ``refresh()`` callers coalesce onto one
  in-flight fetch; followers wait for the leader's result instead of
  issuing their own (the thundering-herd guard for a fleet worker
  whose every connection sees the same unknown kid at once);
- **miss cooldown**: ``on_miss(kid)`` refreshes at most once per
  ``miss_cooldown_s`` — attacker tokens with random kids cannot
  amplify into IdP fetches;
- **TTL'd negative-kid cache**: a kid the *freshly fetched* document
  still lacks is remembered for ``negative_ttl_s``; repeat misses on
  it return instantly without even reaching the cooldown check.

The refresher never raises out of its background thread and never
drops a working snapshot on a failed fetch: the previous epoch keeps
serving, and ``keyplane.refresh_errors`` counts the failure.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, FrozenSet, Optional

from .. import telemetry
from .source import KeySource

# Bound on remembered unknown kids (attacker-controlled names).
_MAX_NEGATIVE_KIDS = 1024


class Snapshot:
    """One epoch of key material: the JWKS document, its kid set, and
    the monotonically increasing epoch number."""

    __slots__ = ("epoch", "doc", "digest", "kids", "fetched_at")

    def __init__(self, epoch: int, doc: Dict[str, Any], digest: str,
                 fetched_at: float):
        self.epoch = epoch
        self.doc = doc
        self.digest = digest
        self.fetched_at = fetched_at
        self.kids: FrozenSet[str] = frozenset(
            k.get("kid") for k in doc.get("keys", [])
            if isinstance(k, dict) and k.get("kid"))

    def __repr__(self) -> str:
        return (f"Snapshot(epoch={self.epoch}, kids={len(self.kids)}, "
                f"digest={self.digest[:12]})")


class Refresher:
    """Pull snapshots from a source; push changed ones into ``apply``.

    apply: callable(Snapshot) run OUTSIDE the refresher lock whenever
    the key material changed — the keyplane wires it to
    ``GPUBatchKeySet.swap_keys`` (device-table build happens there, off
    every serving thread but this one). interval_s/jitter: periodic
    cadence of the background thread (``start()``); each sleep is
    ``interval_s`` ± ``jitter`` fraction, so a fleet of workers never
    phase-locks onto the IdP.
    """

    def __init__(self, source: KeySource,
                 apply: Optional[Callable[[Snapshot], None]] = None,
                 interval_s: float = 300.0, jitter: float = 0.1,
                 miss_cooldown_s: float = 10.0,
                 negative_ttl_s: float = 30.0):
        self._source = source
        self._apply = apply
        self._interval = interval_s
        self._jitter = max(0.0, min(jitter, 0.9))
        self._miss_cooldown = miss_cooldown_s
        self._negative_ttl = negative_ttl_s
        self._lock = threading.Lock()
        self._inflight: Optional[threading.Event] = None
        self._snapshot: Optional[Snapshot] = None
        self._neg: Dict[str, float] = {}      # kid → expiry (monotonic)
        self._last_miss = float("-inf")
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- read side ---------------------------------------------------------

    @property
    def snapshot(self) -> Optional[Snapshot]:
        with self._lock:
            return self._snapshot

    @property
    def epoch(self) -> int:
        snap = self.snapshot
        return snap.epoch if snap is not None else 0

    # -- refresh -----------------------------------------------------------

    def refresh(self, wait_s: float = 30.0) -> Optional[Snapshot]:
        """Fetch once (singleflight) and return the current snapshot.

        The LEADER (first caller while nothing is in flight) performs
        the fetch and raises on failure; FOLLOWERS wait up to
        ``wait_s`` for the leader and return whatever snapshot is then
        current (possibly the previous epoch — they never raise for
        the leader's failure).
        """
        with self._lock:
            ev = self._inflight
            if ev is None:
                ev = self._inflight = threading.Event()
                leader = True
            else:
                leader = False
        if not leader:
            telemetry.count("keyplane.refresh_coalesced")
            ev.wait(timeout=wait_s)
            return self.snapshot
        t0 = time.perf_counter()
        try:
            doc, digest = self._source.fetch()
        except Exception:
            telemetry.count("keyplane.refresh_errors")
            raise
        finally:
            with self._lock:
                self._inflight = None
            ev.set()
        now = time.monotonic()
        with self._lock:
            cur = self._snapshot
            if cur is not None and cur.digest == digest:
                cur.fetched_at = now
                telemetry.count("keyplane.refresh_unchanged")
                return cur
            snap = Snapshot((cur.epoch if cur else 0) + 1, doc, digest,
                            now)
            self._snapshot = snap
            # A kid that exists now is no longer negative.
            for kid in list(self._neg):
                if kid in snap.kids:
                    del self._neg[kid]
        telemetry.count("keyplane.refreshes")
        telemetry.observe("keyplane.refresh_s",
                          time.perf_counter() - t0)
        telemetry.gauge("keyplane.epoch", snap.epoch)
        if self._apply is not None:
            # Outside the lock: table builds are slow, readers of
            # .snapshot/.epoch must not block behind them. Serialized
            # anyway — only a refresh leader ever reaches here.
            self._apply(snap)
        return snap

    def on_miss(self, kid: Optional[str]) -> Optional[Snapshot]:
        """Unknown-kid hook: maybe refresh; returns the new snapshot
        when one was fetched, None when suppressed (negative cache or
        cooldown) or when the fetch failed."""
        now = time.monotonic()
        with self._lock:
            if kid:
                exp = self._neg.get(kid)
                if exp is not None and exp > now:
                    telemetry.count("keyplane.miss_negative_hits")
                    return None
            if now - self._last_miss < self._miss_cooldown:
                telemetry.count("keyplane.miss_suppressed")
                return None
            # Stamp BEFORE the fetch so a slow/failing IdP is also
            # rate-limited (same stance as JSONWebKeySet's cooldown).
            self._last_miss = now
        telemetry.count("keyplane.miss_refreshes")
        try:
            snap = self.refresh()
        except Exception:  # noqa: BLE001 - counted in refresh()
            return None
        if kid and snap is not None and kid not in snap.kids:
            with self._lock:
                if len(self._neg) >= _MAX_NEGATIVE_KIDS:
                    # Drop the soonest-to-expire entries first.
                    for k in sorted(self._neg, key=self._neg.get)[
                            :len(self._neg) - _MAX_NEGATIVE_KIDS + 1]:
                        del self._neg[k]
                self._neg[kid] = now + self._negative_ttl
        return snap

    # -- background polling ------------------------------------------------

    def start(self) -> "Refresher":
        """Start the jittered periodic refresh thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="cap-gpu-keyplane")
        self._thread.start()
        return self

    def _loop(self) -> None:
        import random

        while True:
            delay = self._interval * (
                1.0 + self._jitter * (2.0 * random.random() - 1.0))
            if self._closed.wait(max(0.05, delay)):
                return
            try:
                self.refresh()
            except Exception:  # noqa: BLE001 - counted; keep serving
                pass

    def close(self) -> None:
        self._closed.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

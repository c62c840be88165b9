"""Device-occupancy plane: interval accounting for pipeline busy time.

The port of ``cap_tpu.obs.occupancy``. Verification throughput is won
by keeping a fixed-latency pipeline FULL, not by making one batch
faster, so the number that matters for continuous batching is the
fraction of wall time with device work in flight. This module is that
measurement: every engine dispatch site records a busy interval into
one process-wide accumulator, and the scrape surface turns the
accumulated counters into `device.occupancy` gauges.

Accounting model
----------------
``record(family, t0, t1)`` folds one busy interval (monotonic-clock
endpoints, seconds):

- **global busy** is the UNION of all intervals — each interval is
  clipped against the running high-water end, so two overlapping
  in-flight batches (the 2-deep pipeline) never double-count a
  microsecond. ``device.occupancy = Δbusy / Δwall`` is therefore a
  true "work in flight" fraction, ≤ 1 by construction.
- **per-family busy** is the RAW duration — overlap double-counts
  deliberately, because ``device.<fam>.busy_us`` answers "how much
  device time did family X consume", the lane-share question
  2211.12265's per-scheme GPU batching motivates.
- **idle gaps**: a positive gap between the previous dispatch-level
  interval's end and this one's start is the host-prep bubble #5's
  double-buffering must close; it lands in the ``device.idle_gap_s``
  histogram (observed through the active recorder, so it is a no-op
  while telemetry is off).

All totals are integer MICROSECONDS held locally and flushed to the
active recorder as plain counters at :func:`publish` time — counters
merge exactly across snapshot/STATS/`pool.stats_merged()`, and
consumers apply the counter-reset clamp (never a negative rate
after a worker restart). The wall-clock anchor is itself a counter
(``device.wall_us``: µs elapsed since the first interval), so a fleet
merge yields sum-busy / sum-wall — the worker-weighted mean occupancy.

Published keys (docs/OBSERVABILITY.md §Occupancy plane):

==============================  =============================================
counter                         meaning
==============================  =============================================
``device.busy_us``              union busy time, µs (occupancy numerator)
``device.wall_us``              wall anchor, µs since first interval
``device.dispatches``           dispatch-level intervals recorded
``device.<fam>.busy_us``        per-family raw busy time, µs
``device.<fam>.intervals``      per-family interval count
==============================  =============================================

Gauges (scrape-window delta ratios, set at publish):
``device.occupancy``, ``device.<fam>.occupancy``.

Clock note: interval endpoints are ``time.monotonic()`` seconds. On
Linux that is CLOCK_MONOTONIC — the same clock the native serve
chain's ``std::chrono::steady_clock`` enqueue stamps use, so ring-wait
math mixes the two freely (the JAX package's native serve chain).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, Optional

from .. import telemetry

__all__ = [
    "OccAccumulator", "accumulator", "reset", "interval", "begin",
    "end", "publish", "occupancy_from_counters",
]


def _us(seconds: float) -> int:
    return int(seconds * 1e6)


class OccAccumulator:
    """Mergeable busy-interval accumulator (thread-safe).

    Holds its own integer-µs totals independent of any recorder;
    :meth:`publish` flushes the delta since the previous publish into
    the active telemetry recorder. A fake ``clock`` makes every number
    deterministic under test.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._origin: Optional[float] = None   # first interval start
        self._last_end: float = 0.0            # union high-water mark
        self._busy_us = 0                      # global union, µs
        self._dispatches = 0
        self._fam_us: Dict[str, int] = {}
        self._fam_n: Dict[str, int] = {}
        # per-name totals already flushed to the recorder
        self._published: Dict[str, int] = {}
        # previous publish's totals, for the gauge window
        self._win_busy = 0
        self._win_wall = 0
        self._win_fam: Dict[str, int] = {}

    # -- write side -------------------------------------------------------

    def record(self, family: Optional[str], t0: float, t1: float,
               dispatch: bool = False) -> None:
        """Fold one busy interval [t0, t1] (monotonic seconds).

        ``family`` feeds the per-family raw counters (None: global
        union only). ``dispatch`` marks a batch-level interval: it
        increments ``device.dispatches`` and participates in idle-gap
        accounting (per-family enqueue slices inside one batch do
        not — their gaps are host packing, not pipeline bubbles).
        """
        if t1 < t0:
            t1 = t0
        with self._lock:
            if self._origin is None:
                self._origin = t0
                self._last_end = t0
            elif dispatch and t0 > self._last_end:
                gap = t0 - self._last_end
                telemetry.observe("device.idle_gap_s", gap)
            self._busy_us += _us(max(0.0, t1 - max(t0, self._last_end)))
            if t1 > self._last_end:
                self._last_end = t1
            if dispatch:
                self._dispatches += 1
            if family is not None:
                self._fam_us[family] = (self._fam_us.get(family, 0)
                                        + _us(t1 - t0))
                self._fam_n[family] = self._fam_n.get(family, 0) + 1

    @contextmanager
    def interval(self, family: Optional[str],
                 dispatch: bool = True) -> Iterator[None]:
        """Time a block as one busy interval. No-op (one attribute
        check) while telemetry is off — the obs-off bench arms must
        not even read the clock."""
        if telemetry.active() is None:
            yield
            return
        t0 = self._clock()
        try:
            yield
        finally:
            self.record(family, t0, self._clock(), dispatch=dispatch)

    def begin(self) -> Optional[float]:
        """Start stamp for a split begin/end interval (the async
        dispatch→collect path); None while telemetry is off."""
        if telemetry.active() is None:
            return None
        return self._clock()

    def end(self, family: Optional[str], t0: Optional[float],
            dispatch: bool = True) -> None:
        """Close a :meth:`begin` interval (no-op when t0 is None)."""
        if t0 is None or telemetry.active() is None:
            return
        self.record(family, t0, self._clock(), dispatch=dispatch)

    # -- publish side -----------------------------------------------------

    def totals(self) -> Dict[str, int]:
        """Cumulative counter values (µs / counts) as of now."""
        with self._lock:
            return self._totals_locked()

    def _totals_locked(self) -> Dict[str, int]:
        if self._origin is None:
            return {}
        out = {
            "device.busy_us": self._busy_us,
            "device.wall_us": max(0, _us(self._clock() - self._origin)),
            "device.dispatches": self._dispatches,
        }
        for fam, us in self._fam_us.items():
            out[f"device.{fam}.busy_us"] = us
            out[f"device.{fam}.intervals"] = self._fam_n[fam]
        return out

    def publish(self, rec: Optional[telemetry.Recorder] = None) -> None:
        """Flush counter deltas since the previous publish into the
        recorder and set the scrape-window occupancy gauges. Called
        from every scrape surface (worker stats/gauges, bench embeds);
        publishes nothing until the first interval lands, so an engine
        that never dispatched contributes no occupancy keys."""
        rec = rec if rec is not None else telemetry.active()
        if rec is None:
            return
        with self._lock:
            totals = self._totals_locked()
            if not totals:
                return
            increments = {}
            for k, v in totals.items():
                d = v - self._published.get(k, 0)
                if d > 0 or k not in self._published:
                    increments[k] = max(0, d)
                self._published[k] = v
            busy, wall = totals["device.busy_us"], totals["device.wall_us"]
            d_busy = max(0, busy - self._win_busy)
            d_wall = max(0, wall - self._win_wall)
            gauges = {"device.occupancy":
                      min(1.0, d_busy / d_wall) if d_wall else 0.0}
            for fam, us in self._fam_us.items():
                d_fam = max(0, us - self._win_fam.get(fam, 0))
                gauges[f"device.{fam}.occupancy"] = (
                    d_fam / d_wall if d_wall else 0.0)
                self._win_fam[fam] = us
            self._win_busy, self._win_wall = busy, wall
        if increments:
            rec.count_many(increments)
        for k, v in gauges.items():
            rec.gauge(k, v)


# ---------------------------------------------------------------------------
# module-level accumulator: one per process (workers are processes)
# ---------------------------------------------------------------------------

_acc = OccAccumulator()


def accumulator() -> OccAccumulator:
    return _acc


def reset(clock: Callable[[], float] = time.monotonic) -> OccAccumulator:
    """Replace the process accumulator (tests / chain swaps)."""
    global _acc
    _acc = OccAccumulator(clock)
    return _acc


def interval(family: Optional[str], dispatch: bool = True):
    return _acc.interval(family, dispatch=dispatch)


def begin() -> Optional[float]:
    return _acc.begin()


def end(family: Optional[str], t0: Optional[float],
        dispatch: bool = True) -> None:
    _acc.end(family, t0, dispatch=dispatch)


def publish(rec: Optional[telemetry.Recorder] = None) -> None:
    _acc.publish(rec)


# ---------------------------------------------------------------------------
# counter-space rollup (capstat / SLO / pool aggregate views)
# ---------------------------------------------------------------------------


def occupancy_from_counters(cur: Dict[str, Any],
                            prev: Optional[Dict[str, Any]] = None
                            ) -> Optional[Dict[str, Any]]:
    """Occupancy rollup from (merged) counter maps.

    With ``prev`` (an earlier scrape of the same surface) the ratios
    are window deltas with the counter-reset clamp (a restarted
    worker's lower counters clamp to zero contribution, never a
    negative rate); without it they are lifetime ratios. Returns None
    when the occupancy section is absent (plane never recorded).
    """
    prev = prev or {}

    def delta(key: str) -> int:
        return max(0, int(cur.get(key, 0)) - int(prev.get(key, 0)))

    if "device.wall_us" not in cur:
        return None
    d_wall = delta("device.wall_us")
    d_busy = delta("device.busy_us")
    fams = sorted({k.split(".")[1] for k in cur
                   if k.startswith("device.") and k.endswith(".busy_us")
                   and k.count(".") == 2})
    out = {
        "occupancy": min(1.0, d_busy / d_wall) if d_wall else 0.0,
        "busy_us": d_busy,
        "wall_us": d_wall,
        "dispatches": delta("device.dispatches"),
        "families": {},
    }
    for fam in fams:
        d_fam = delta(f"device.{fam}.busy_us")
        out["families"][fam] = {
            "occupancy": d_fam / d_wall if d_wall else 0.0,
            "busy_us": d_fam,
            "intervals": delta(f"device.{fam}.intervals"),
        }
    return out

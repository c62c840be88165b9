"""Per-tenant token-bucket admission control.

The port of ``cap_tpu.serve.admission`` (the python chain's
enforcement point there): bucket arithmetic (start full, lazy refill
from a monotonic clock, one token per token) and counters are the
same, so ``admission.checked == admission.admitted +
admission.throttled`` holds on both.

A throttled token is rejected BEFORE verification with
:class:`cap_tpu_torch.errors.ThrottledError` whose message carries the
additive ``retry_after_ms=<int>`` pushback hint
(``serve/protocol.retry_after_hint`` parses it back). The decision
fold then counts it under the registered ``throttled`` reason —
per tenant — like any other reject.

Config: :class:`AdmissionConfig` takes the knobs as arguments (the
worker's ``fair``, ``admit_rate`` and ``admit_burst``): tokens/sec per
tenant (0 = off), bucket depth (default 2×rate, min 1), DRR fair
scheduling, the DRR per-visit credit (default 512) and per-tenant DRR
weights (``{"<tenant-hash>": w}``, ``"be"`` for the shared best-effort
slot).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import telemetry
from ..errors import ThrottledError
from ..obs import decision as _decision


class AdmissionConfig:
    """Admission/fairness knobs, given as arguments (the JAX package
    falls back to its environment for each one left None; the port
    takes the same defaults: fair off, admission off, the default DRR
    quantum, no weights)."""

    __slots__ = ("fair", "rate", "burst", "quantum", "weights")

    def __init__(self, fair: Optional[bool] = None,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 quantum: Optional[int] = None,
                 weights: Optional[Dict[str, int]] = None):
        rate = float(rate or 0.0)
        burst = float(burst or 0.0)
        if burst <= 0:
            burst = max(1.0, 2.0 * rate)
        self.fair = bool(fair)
        self.rate = rate
        self.burst = burst
        self.quantum = int(quantum) if quantum and quantum > 0 else 0
        self.weights = {str(k): max(1, int(w))
                        for k, w in (weights or {}).items()}

    @property
    def admission_on(self) -> bool:
        """Admission is armed iff a positive per-tenant rate is set
        (a deterministic hard-cap config uses a tiny rate, e.g.
        1e-4 tok/s, so refill is negligible inside a test window)."""
        return self.rate > 0


class _Bucket:
    __slots__ = ("level", "t_last", "scale", "init")

    def __init__(self):
        self.level = 0.0
        self.t_last = 0.0
        self.scale = 1.0
        self.init = False


class AdmissionController:
    """Token buckets keyed by tenant LABEL (hash / none / other).

    ``check(labels)`` refills + takes one token per entry and returns
    ``(mask, retry_after_ms)`` — mask[i] True means token i is over
    budget (reject with pushback, never verify). Counters ride the
    active recorder under the exact names the native chain exposes
    from its counter slots (``admission.checked`` / ``.admitted`` /
    ``.throttled``), so fleet merges are chain-agnostic.
    """

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock=time.monotonic):
        self.rate = max(0.0, float(rate))
        self.burst = float(burst) if burst and burst > 0 \
            else max(1.0, 2.0 * self.rate)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, _Bucket] = {}
        # shed state: tenant label → rate scale (the pool's admission
        # op writes it; capstat's ledger renders it)
        self.shed: Dict[str, float] = {}

    # -- hot path ---------------------------------------------------------

    def check(self, labels: Sequence[str]
              ) -> Tuple[Optional[List[bool]], int]:
        """One bucket take per token; (None, 0) when all admitted."""
        n = len(labels)
        if n == 0:
            return (None, 0)
        now = self._clock()
        throttled = 0
        worst = 0.0
        mask: Optional[List[bool]] = None
        with self._lock:
            for i, label in enumerate(labels):
                b = self._buckets.get(label)
                if b is None:
                    if len(self._buckets) >= 4 * _decision.N_TENANT:
                        self._buckets.clear()   # bounded, like caches
                    b = self._buckets[label] = _Bucket()
                rate = self.rate * b.scale
                if not b.init:
                    b.init = True
                    b.level = self.burst     # buckets start full
                    b.t_last = now
                elif now > b.t_last:
                    b.level = min(self.burst,
                                  b.level + (now - b.t_last) * rate)
                    b.t_last = now
                if b.level >= 1.0:
                    b.level -= 1.0
                else:
                    if mask is None:
                        mask = [False] * n
                    mask[i] = True
                    throttled += 1
                    wait = (1.0 - b.level) / rate if rate > 1e-9 \
                        else 60.0
                    if wait > worst:
                        worst = wait
        rec = telemetry.active()
        if rec is not None:
            inc = {"admission.checked": n}
            if n - throttled:
                inc["admission.admitted"] = n - throttled
            if throttled:
                inc["admission.throttled"] = throttled
            rec.count_many(inc)
        retry_ms = 0
        if throttled:
            retry_ms = min(60000, max(1, int(worst * 1000.0) + 1))
        return (mask, retry_ms)

    def check_tokens(self, tokens: Sequence[str]
                     ) -> Tuple[Optional[List[bool]], int]:
        """check() over per-token tenant labels (header-segment
        cached — the python chain's entry point)."""
        return self.check(_decision.tenant_labels(tokens))

    # -- shed lever (the pool's admission op) -----------------------------

    def set_scale(self, label: str, scale: float) -> None:
        scale = max(0.0, float(scale))
        with self._lock:
            b = self._buckets.get(label)
            if b is None:
                b = self._buckets[label] = _Bucket()
            b.scale = scale
        if scale < 1.0:
            self.shed[label] = scale
        else:
            self.shed.pop(label, None)

    def fill(self, label: str) -> float:
        """Current bucket level in tokens (point-in-time, no refill —
        the capstat admission column)."""
        with self._lock:
            b = self._buckets.get(label)
            return b.level if b is not None and b.init else self.burst


def throttled_error(retry_ms: int) -> ThrottledError:
    """The canonical pushback exception both chains encode: class head
    ``ThrottledError`` + the additive ``retry_after_ms`` hint."""
    return ThrottledError(retry_after_ms=max(1, int(retry_ms or 1)))

"""SLO-burn-driven pool autoscaling + tenant shed.

The port of ``cap_tpu.fleet.autoscale``; its decisions are the JAX
autoscaler's. The control loop the pool supervisor ticks
(``WorkerPool(..., autoscale={...})``): it watches the fleet's
queue-depth gauges and the per-tenant burn rates over the EXACT merged
worker counters and moves the three levers the enforcement plane
exposes:

- **scale up** (``pool.resize(+1)``) on SUSTAINED global queue
  pressure — ``high_queue_per_worker`` tokens of backlog per active
  worker for ``sustain_ticks`` consecutive looks;
- **shed** when already at ``max_workers``: tighten admission for the
  burn-rate-breaching tenant with the LOWEST configured weight (ties:
  most tokens — the flooder), via ``pool.shed_tenant`` (the op rides
  the CVB1 type-13/14 control pair; workers scale that tenant's
  bucket rate). Only a tenant actually breaching a ``tenant.*`` SLO
  template is ever shed — quiet tenants are untouchable by design;
- **scale down / unshed** after ``quiet_ticks`` consecutive calm
  looks: sheds lift first (restore scale 1.0), then the pool shrinks
  toward ``min_workers``.

Every transition is a counter (``fleet.resize.*``) and a
``pool.resize_events()`` entry; capstat's tenant ledger renders the
pool line from them and the chaos postmortems embed the log.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from .. import telemetry
from ..obs import decision as _decision
from ..obs import slo as _slo


class PoolAutoscaler:
    """One pool's scaling/shed control loop (ticked by the pool's
    supervisor thread; every fault is swallowed into a counter — the
    supervisor must survive anything this class does)."""

    def __init__(self, pool, min_workers: int = 1,
                 max_workers: int = 4, *,
                 high_queue_per_worker: float = 1024.0,
                 sustain_ticks: int = 3, quiet_ticks: int = 10,
                 interval_s: float = 1.0, shed_scale: float = 0.25,
                 shed: bool = True,
                 tenant_weights: Optional[Dict[str, int]] = None):
        self._pool = pool
        self.min_workers = max(1, int(min_workers))
        self.max_workers = max(self.min_workers, int(max_workers))
        self.high_queue_per_worker = float(high_queue_per_worker)
        self.sustain_ticks = max(1, int(sustain_ticks))
        self.quiet_ticks = max(1, int(quiet_ticks))
        self.interval_s = float(interval_s)
        self.shed_scale = float(shed_scale)
        self.shed_enabled = bool(shed)
        self.tenant_weights = dict(tenant_weights or {})
        self._hot = 0
        self._quiet = 0
        self._last_tick = 0.0
        self.shed_state: Dict[str, float] = {}
        # tenant SLO templates only: the burn signal the shed lever
        # keys off (expanded per observed tenant at eval time)
        self._rules = [r for r in _slo.default_rules()
                       if _slo.is_tenant_template(r)]
        self._engine = _slo.SLOEngine(self._rules)

    # -- signal extraction -------------------------------------------------

    @staticmethod
    def _pressure(merged: Dict[str, Any]) -> float:
        """Global backlog in tokens: batcher queues + native rings."""
        agg = merged.get("aggregate") or {}
        queued = float(agg.get("queued_tokens") or 0)
        for st in (merged.get("workers") or {}).values():
            queued += float((st or {}).get("ring_depth") or 0)
        return queued

    def _breaching_tenants(self, snapshot: Dict[str, Any]
                           ) -> List[str]:
        """Tenant ids currently burning a tenant.* SLO rule (the
        burn-rate signal), multi-window semantics unchanged."""
        out = set()
        for r in self._engine.evaluate(snapshot):
            tid = r.get("tenant")
            if tid is not None and not r.get("ok", True):
                out.add(tid)
        return sorted(out)

    def _pick_shed(self, breaching: List[str],
                   counters: Dict[str, int]) -> Optional[str]:
        """Lowest-weight breaching tenant first; ties → most tokens
        (the flooder). Already fully-shed tenants are skipped."""
        totals = _decision.tenant_totals(counters, surface="serve")
        best = None
        best_key = None
        for t in breaching:
            if t in (_decision.TENANT_NONE,):
                continue
            if self.shed_state.get(t, 1.0) <= self.shed_scale:
                continue            # already tightened
            key = (self.tenant_weights.get(t, 1),
                   -(totals.get(t, {}).get("tokens", 0)))
            if best_key is None or key < best_key:
                best, best_key = t, key
        return best

    # -- the loop ----------------------------------------------------------

    def tick(self, now: Optional[float] = None,
             merged: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """One control-loop step (rate-limited to ``interval_s``).
        Returns the action taken ("up"/"down"/"shed"/"unshed"/None) —
        handy for tests; the pool ignores it."""
        now = time.monotonic() if now is None else now
        if now - self._last_tick < self.interval_s:
            return None
        self._last_tick = now
        pool = self._pool
        if merged is None:
            merged = pool.stats_merged()
        agg = merged.get("aggregate") or {}
        snapshot = agg.get("snapshot") or {}
        counters = {k: int(v) for k, v in
                    (agg.get("counters") or {}).items()}
        active = pool.size()
        pressure = self._pressure(merged)
        per_worker = pressure / max(1, active)
        telemetry.gauge("fleet.autoscale_pressure", per_worker)
        if per_worker > self.high_queue_per_worker:
            self._hot += 1
            self._quiet = 0
        else:
            self._hot = 0
            self._quiet += 1
        if self._hot >= self.sustain_ticks:
            self._hot = 0
            if active < self.max_workers:
                pool.resize(active + 1, reason="queue-pressure")
                return "up"
            if self.shed_enabled:
                tenant = self._pick_shed(
                    self._breaching_tenants(snapshot), counters)
                if tenant is not None:
                    pool.shed_tenant(tenant, self.shed_scale,
                                     reason="slo-burn@max-size")
                    self.shed_state[tenant] = self.shed_scale
                    return "shed"
            return None
        if self._quiet >= self.quiet_ticks:
            self._quiet = 0
            if self.shed_state:
                tenant = sorted(self.shed_state)[0]
                pool.shed_tenant(tenant, 1.0, reason="quiet-restore")
                self.shed_state.pop(tenant, None)
                return "unshed"
            if active > self.min_workers:
                pool.resize(active - 1, reason="quiet")
                return "down"
        return None

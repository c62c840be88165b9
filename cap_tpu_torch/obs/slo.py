"""SLO engine: declarative objectives, multi-window burn rates.

The port of ``cap_tpu.obs.slo``; the rules, their text syntax and the
results are the JAX module's. The fleet's availability contract is
*qualitative* in docs/SERVE.md ("never wrong, at worst slow"); this
module makes it *enforceable*: objectives are declared as data,
evaluated against (merged) telemetry snapshots, and rendered by
``capstat --slo`` — nonzero exit on breach, so CI and cron probes can
page on contract burn instead of reading dashboards.

Rule kinds
----------

``counter <name> max <v>``
    A counter must never exceed ``v`` (the wrong-verdict objective is
    ``counter decision.wrong_verdicts max 0``). Evaluated on totals
    and, when history exists, on per-window deltas.

``ratio <num> / <den> max <r> [burn <b>]``
    The rate ``num/den`` must stay at or below objective ``r``
    (oracle-fallback rate, hedge rate, protocol-error rate). The
    **burn rate** is ``(num/den) / r`` — 1.0 means the budget is being
    consumed exactly as fast as allowed. A rule breaches when burn
    exceeds ``b`` (default 1.0) in EVERY evaluated window
    (multi-window discipline: a short spike that the long window has
    already absorbed does not page; a sustained burn trips both).

``quantile <series> <p50|p95|p99> max <seconds>``
    A histogram series quantile ceiling (stage latency targets).
    Histogram buckets are cumulative, so quantile rules evaluate on
    lifetime totals (documented limitation — windowed quantiles would
    need bucket-delta history).

``occupancy_floor min <fraction>``
    Device occupancy (``device.busy_us / device.wall_us`` from the
    occupancy plane, reset-clamped window deltas) must stay at or
    above the floor **while under load** — a window with zero
    ``device.dispatches`` is idle and never burns (an idle fleet is
    cheap, not broken). Breaches only when EVERY loaded window is
    below the floor, same multi-window discipline as ratio rules.

Any rule whose names contain the literal ``tenant.*`` is a
**per-tenant template**: at evaluation time it expands into one
concrete rule per observed tenant id (``tenant.<t>`` substituted
everywhere, result named ``rule[<t>]``, multi-window burn semantics
unchanged) — e.g. ``tr ratio decision.serve.tenant.*.reject /
decision.serve.tenant.*.tokens max 0.5 burn 1.5`` pages on the ONE
issuer burning its rejection budget while every other tenant's rule
stays green. ``tq quantile tenant.*.request_s p99 max 0.05`` works
the same way over the per-tenant latency series.

Windows: an :class:`SLOEngine` fed periodic snapshots via
:meth:`SLOEngine.observe` evaluates counter/ratio rules over each
configured window's delta. A one-shot evaluation (``capstat --slo``
scraping a live fleet once) has a single sample: every rule evaluates
over process-lifetime totals, labeled window ``"lifetime"``.

Rules files are plain text (one rule per line, ``#`` comments):

    wrong_verdicts   counter decision.wrong_verdicts max 0
    oracle_fallback  ratio fleet.fallback_tokens / worker.tokens max 0.05
    hedge_rate       ratio fleet.hedges / worker.requests max 0.25 burn 2
    flush_p99        quantile batcher.flush p99 max 0.5
"""

from __future__ import annotations

import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import telemetry

# Per-tenant rule templates: any rule whose counter/series names
# contain the literal ``tenant.*`` is EXPANDED at evaluation time —
# one concrete rule per tenant id observed in the evaluated counters
# and series (``tenant.<t>`` substituted, result name ``rule[<t>]``).
# Tenant ids are issuer hashes plus the fixed "none"/"other" labels
# (docs/OBSERVABILITY.md §Tenant attribution); a template with no
# observed tenants evaluates to a single vacuous-ok result so a quiet
# fleet never pages.
TENANT_WILDCARD = "tenant.*"
_TENANT_ID_RE = re.compile(r"\btenant\.([0-9a-f]{12}|none|other)\.")

DEFAULT_RULES_TEXT = """
# The availability contract, as data. `capstat --slo` evaluates these
# (or a rules file) against the scraped fleet; nonzero exit on breach.
wrong_verdicts   counter decision.wrong_verdicts max 0
protocol_errors  ratio worker.protocol_errors / worker.requests max 0.01
oracle_fallback  ratio fleet.fallback_tokens / worker.tokens max 0.05
hedge_rate       ratio fleet.hedges / worker.requests max 0.25
# Keyplane: a rotation must reach every worker fast (push start →
# last ack; docs/KEYPLANE.md) and pushes must not be flaking.
rotation_lag     quantile keyplane.propagate_s p99 max 5
push_failures    ratio keyplane.push_failures / keyplane.push_attempts max 0.5
# Verdict cache: the serve-time tripwire must NEVER fire — a cached
# accept served past its exp/epoch clamp would be a wrong verdict in
# the making (docs/SERVE.md cache-tier invalidation matrix).
stale_accepts    counter vcache.stale_accepts max 0
# Per-tenant budgets (templates — expanded per observed tenant id):
# wrong verdicts are zero-tolerance per tenant exactly as globally,
# and a tenant whose traffic is mostly rejections is burning its own
# rejection budget (a flooding/abusive issuer shows up HERE without
# drowning in fleet-wide averages). Thresholds: ratio > 0.5 sustained
# at burn > 1.5 → a tenant sending ≥75% garbage pages; the obs-smoke
# two-tenant gate pins flood-breaches-while-quiet-stays-green.
tenant_wrong_verdicts counter decision.tenant.*.wrong_verdicts max 0
tenant_reject_ratio   ratio decision.serve.tenant.*.reject / decision.serve.tenant.*.tokens max 0.5 burn 1.5
# Admission: a tenant whose traffic is mostly THROTTLED is
# burning the fleet's admission budget — its own rule pages (the
# flooder breaches, quiet tenants have zero throttles and stay
# green), and the pool autoscaler reads this burn as its shed signal.
tenant_throttle_ratio ratio decision.serve.tenant.*.reject.throttled / decision.serve.tenant.*.tokens max 0.5 burn 1.5
# Occupancy: sustained device idling UNDER LOAD is throughput left on
# the table. Off by default — the discrete-dispatch baseline sits far
# below a 90% gate until continuous batching lands; uncomment (and
# tighten toward 0.9) then.
#occupancy       occupancy_floor min 0.05
"""


class SLOError(ValueError):
    """A rules file / rule line could not be parsed."""


class SLORule:
    """One declarative objective (see module docstring for kinds)."""

    __slots__ = ("name", "kind", "counter", "num", "den", "series",
                 "quantile", "max_value", "burn_threshold")

    def __init__(self, name: str, kind: str, *, counter: str = "",
                 num: str = "", den: str = "", series: str = "",
                 quantile: str = "p99", max_value: float = 0.0,
                 burn_threshold: float = 1.0):
        self.name = name
        self.kind = kind
        self.counter = counter
        self.num = num
        self.den = den
        self.series = series
        self.quantile = quantile
        self.max_value = max_value
        self.burn_threshold = burn_threshold


def parse_rules(text: str) -> List[SLORule]:
    """Parse the text syntax; raises :class:`SLOError` with the line on
    any violation (an unparseable SLO config must fail loudly, not
    silently guard nothing)."""
    rules: List[SLORule] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        toks = line.split()
        try:
            name, kind = toks[0], toks[1]
            if kind == "counter":
                # <name> counter <counter> max <v>
                if toks[3] != "max":
                    raise IndexError
                rules.append(SLORule(name, "counter", counter=toks[2],
                                     max_value=float(toks[4])))
            elif kind == "ratio":
                # <name> ratio <num> / <den> max <r> [burn <b>]
                if toks[3] != "/" or toks[5] != "max":
                    raise IndexError
                burn = 1.0
                if len(toks) > 7:
                    if toks[7] != "burn":
                        raise IndexError
                    burn = float(toks[8])
                rules.append(SLORule(name, "ratio", num=toks[2],
                                     den=toks[4],
                                     max_value=float(toks[6]),
                                     burn_threshold=burn))
            elif kind == "quantile":
                # <name> quantile <series> <pXX> max <seconds>
                if toks[3] not in ("p50", "p95", "p99") \
                        or toks[4] != "max":
                    raise IndexError
                rules.append(SLORule(name, "quantile", series=toks[2],
                                     quantile=toks[3],
                                     max_value=float(toks[5])))
            elif kind == "occupancy_floor":
                # <name> occupancy_floor min <fraction>
                if toks[2] != "min":
                    raise IndexError
                rules.append(SLORule(name, "occupancy_floor",
                                     max_value=float(toks[3])))
            else:
                raise SLOError(
                    f"line {lineno}: unknown rule kind {kind!r}")
        except (IndexError, ValueError) as e:
            if isinstance(e, SLOError):
                raise
            raise SLOError(
                f"line {lineno}: cannot parse rule {line!r}") from e
    return rules


def default_rules() -> List[SLORule]:
    return parse_rules(DEFAULT_RULES_TEXT)


def is_tenant_template(rule: SLORule) -> bool:
    return any(TENANT_WILDCARD in f for f in
               (rule.counter, rule.num, rule.den, rule.series))


def observed_tenants(counters: Dict[str, Any],
                     series_names: Sequence[str] = ()) -> List[str]:
    """Tenant ids present in a counter map / series-name set — what a
    ``tenant.*`` rule template expands over."""
    ids = set()
    for k in counters:
        m = _TENANT_ID_RE.search(k)
        if m:
            ids.add(m.group(1))
    for k in series_names:
        m = _TENANT_ID_RE.search(k)
        if m:
            ids.add(m.group(1))
    return sorted(ids)


def expand_tenant_rule(rule: SLORule, tenant_id: str) -> SLORule:
    """One concrete rule for one tenant id (``tenant.*`` substituted,
    name suffixed ``[<id>]``)."""
    sub = f"tenant.{tenant_id}"
    return SLORule(
        f"{rule.name}[{tenant_id}]", rule.kind,
        counter=rule.counter.replace(TENANT_WILDCARD, sub),
        num=rule.num.replace(TENANT_WILDCARD, sub),
        den=rule.den.replace(TENANT_WILDCARD, sub),
        series=rule.series.replace(TENANT_WILDCARD, sub),
        quantile=rule.quantile, max_value=rule.max_value,
        burn_threshold=rule.burn_threshold)


class SLOEngine:
    """Evaluate rules against snapshots, with optional burn windows.

    windows: seconds of history per burn window (short, long). History
    is bounded: one retained sample per ``min(windows)/4`` interval,
    capped at 512 samples.
    """

    MAX_SAMPLES = 512

    def __init__(self, rules: Sequence[SLORule],
                 windows: Tuple[float, ...] = (60.0, 300.0)):
        self.rules = list(rules)
        self.windows = tuple(sorted(windows))
        self._samples: List[Tuple[float, Dict[str, int]]] = []

    # -- history ----------------------------------------------------------

    def observe(self, snapshot: Dict[str, Any],
                now: Optional[float] = None) -> None:
        """Feed one (merged) snapshot into the burn-window history."""
        now = time.monotonic() if now is None else now
        counters = dict(snapshot.get("counters") or {})
        min_gap = (self.windows[0] / 4.0) if self.windows else 1.0
        if self._samples and now - self._samples[-1][0] < min_gap:
            self._samples[-1] = (self._samples[-1][0], counters)
        else:
            self._samples.append((now, counters))
        if len(self._samples) > self.MAX_SAMPLES:
            del self._samples[0:len(self._samples) - self.MAX_SAMPLES]

    def _window_deltas(self, now: float
                       ) -> List[Tuple[str, Dict[str, int]]]:
        """(label, counter-delta) per window with data; falls back to a
        single lifetime pseudo-window when history is too thin."""
        out: List[Tuple[str, Dict[str, int]]] = []
        if len(self._samples) >= 2:
            latest = self._samples[-1][1]
            for w in self.windows:
                base = None
                for t, counters in self._samples:
                    if t >= now - w:
                        base = counters
                        break
                if base is None or base is latest:
                    continue
                delta = {k: latest.get(k, 0) - base.get(k, 0)
                         for k in latest}
                out.append((f"{int(w)}s", delta))
        if not out and self._samples:
            out.append(("lifetime", self._samples[-1][1]))
        return out

    # -- evaluation -------------------------------------------------------

    def evaluate(self, snapshot: Optional[Dict[str, Any]] = None,
                 now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One result dict per rule: {name, kind, ok, detail,
        windows: {label: burn-or-value}}. ``snapshot`` (when given) is
        observed first, so a one-shot caller needs a single call."""
        now = time.monotonic() if now is None else now
        if snapshot is not None:
            self.observe(snapshot, now=now)
        deltas = self._window_deltas(now)
        summary = (telemetry.summarize_snapshot(snapshot)
                   if snapshot is not None else {})
        # tenant templates expand over the tenants observed in the
        # LATEST counters + the snapshot's series names — per-tenant
        # objectives are evaluated per tenant, never averaged across
        # tenants (a flooding issuer must not hide behind quiet ones)
        tenants: Optional[List[str]] = None
        results = []
        for rule in self.rules:
            if not is_tenant_template(rule):
                results.append(self._eval_rule(rule, deltas, summary))
                continue
            if tenants is None:
                latest = self._samples[-1][1] if self._samples else {}
                tenants = observed_tenants(latest, summary.keys())
            if not tenants:
                results.append({
                    "name": rule.name, "kind": rule.kind, "ok": True,
                    "windows": {},
                    "detail": "no tenants observed (template idle)"})
                continue
            for tid in tenants:
                res = self._eval_rule(expand_tenant_rule(rule, tid),
                                      deltas, summary)
                res["tenant"] = tid
                results.append(res)
        return results

    def _eval_rule(self, rule: SLORule,
                   deltas: List[Tuple[str, Dict[str, int]]],
                   summary: Dict[str, Dict[str, float]]
                   ) -> Dict[str, Any]:
        res: Dict[str, Any] = {"name": rule.name, "kind": rule.kind,
                               "ok": True, "windows": {}}
        if rule.kind == "counter":
            breached = []
            for label, counters in deltas:
                v = counters.get(rule.counter, 0)
                res["windows"][label] = v
                breached.append(v > rule.max_value)
            res["ok"] = not (breached and all(breached))
            res["detail"] = (f"{rule.counter} max {rule.max_value:g}")
        elif rule.kind == "ratio":
            burns = []
            for label, counters in deltas:
                num = counters.get(rule.num, 0)
                den = counters.get(rule.den, 0)
                rate = (num / den) if den > 0 else 0.0
                burn = (rate / rule.max_value if rule.max_value > 0
                        else (float("inf") if rate > 0 else 0.0))
                res["windows"][label] = round(burn, 4)
                burns.append(burn > rule.burn_threshold)
            res["ok"] = not (burns and all(burns))
            res["detail"] = (f"{rule.num}/{rule.den} max "
                             f"{rule.max_value:g} "
                             f"burn>{rule.burn_threshold:g}")
        elif rule.kind == "occupancy_floor":
            # under-load discipline: an idle window (no dispatches)
            # never burns; deltas are reset-clamped
            loaded = []
            for label, counters in deltas:
                wall = max(0, counters.get("device.wall_us", 0))
                busy = max(0, counters.get("device.busy_us", 0))
                disp = max(0, counters.get("device.dispatches", 0))
                if wall <= 0 or disp <= 0:
                    res["windows"][label] = "idle"
                    continue
                occ = min(1.0, busy / wall)
                res["windows"][label] = round(occ, 4)
                loaded.append(occ < rule.max_value)
            res["ok"] = not (loaded and all(loaded))
            res["detail"] = (f"device.occupancy min "
                             f"{rule.max_value:g} (under load)")
        elif rule.kind == "quantile":
            s = summary.get(rule.series)
            v = s[rule.quantile] if s else 0.0
            res["windows"]["lifetime"] = round(v, 6)
            res["ok"] = v <= rule.max_value
            res["detail"] = (f"{rule.series} {rule.quantile} max "
                             f"{rule.max_value:g}s")
        else:  # unreachable via parse_rules; defensive for dict-built rules
            res["ok"] = False
            res["detail"] = f"unknown rule kind {rule.kind!r}"
        return res


def any_breach(results: Sequence[Dict[str, Any]]) -> bool:
    return any(not r.get("ok", False) for r in results)


def format_results(results: Sequence[Dict[str, Any]]) -> str:
    """The ``capstat --slo`` table."""
    lines = ["SLO                        state   windows (burn/value)"]
    for r in results:
        state = "ok" if r["ok"] else "BREACH"
        wins = "  ".join(f"{k}={v}" for k, v in r["windows"].items()) \
            or "no-data"
        lines.append(f"  {r['name']:<24} {state:<7} {wins}   "
                     f"[{r.get('detail', '')}]")
    return "\n".join(lines)


def evaluate_once(snapshot: Dict[str, Any],
                  rules: Optional[Sequence[SLORule]] = None
                  ) -> List[Dict[str, Any]]:
    """One-shot evaluation over a single (merged) snapshot — the
    ``capstat --slo`` / bench-embedding entry point."""
    eng = SLOEngine(rules if rules is not None else default_rules())
    return eng.evaluate(snapshot)

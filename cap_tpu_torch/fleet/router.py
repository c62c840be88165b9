"""Failover routing client for the serve fleet.

The port of ``cap_tpu.fleet.router`` (``ConsistentHashRing`` lives with
the front door, :mod:`cap_tpu_torch.fleet.frontdoor`, whose pools are
each a ``FleetClient``). ``FleetClient`` mirrors the
``KeySet.verify_batch`` surface over a POOL of workers, with the
availability contract the single-process ``VerifyClient`` cannot offer:

    verdicts are always produced, and they are never wrong —
    at worst they are slow.

Mechanics, in the order a batch experiences them:

- **balance**: round-robin over the live endpoints (re-polled from the
  pool per attempt round, so respawned workers join automatically);
- **per-worker deadline**: every attempt is bounded
  (``attempt_timeout``), so a stalled or black-holed worker costs one
  timeout, not the request;
- **integrity**: all verify traffic uses the checksummed CVB1 frame
  pair (types 7/8) — a corrupt frame in EITHER direction is a typed
  transport error (never a verdict), handled like any other failure;
- **hedged retry**: if a response hasn't arrived after ``hedge_after``
  seconds, the SAME batch is also sent to a healthy peer and the first
  answer wins (verdicts are deterministic, so duplicated work is safe
  by construction — verify is idempotent);
- **circuit breaker**: ``breaker_threshold`` consecutive failures open
  a worker's breaker for ``breaker_reset_s`` (one probe re-admits it),
  so a dead worker stops eating attempt timeouts;
- **exponential backoff** between full retry rounds (all endpoints
  tried once), bounded by ``backoff_max``;
- **terminal fallback**: when every worker is unreachable, the batch
  is verified LOCALLY on ``fallback`` — an object with
  ``verify_batch`` that the CALLER passes (a ``StaticKeySet`` over the
  same JWKS, say), counted in ``fleet.fallback_batches`` /
  ``fleet.fallback_tokens``. Without one, an exhausted fleet raises
  :class:`FleetExhaustedError` for the whole batch and nothing is
  verified on the host. Transport failure is therefore never
  translated into a token-level rejection.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .. import telemetry
from ..errors import CapError
from ..obs import decision as _decision
from ..serve import protocol
from ..serve import vcache as _vcache
from ..serve.client import RemoteVerifyError

Endpoint = Tuple[str, int]


class FleetExhaustedError(CapError):
    default_message = ("no fleet worker reachable and no fallback "
                      "keyset configured")


class _Breaker:
    """Per-endpoint consecutive-failure circuit breaker."""

    __slots__ = ("failures", "open_until", "backoff")

    def __init__(self):
        self.failures = 0
        self.open_until = 0.0
        self.backoff = 0.0


class _Attempt:
    """One in-flight request on its own connection (own socket: an
    abandoned/hedged-out attempt is closed, never reused — CVB1
    correlates by order, so a socket with an unread response is
    poisoned)."""

    def __init__(self, endpoint: Endpoint, timeout: float):
        self.endpoint = endpoint
        self.sock = socket.create_connection(endpoint, timeout=timeout)
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.reader = protocol.FrameReader(self.sock)

    def run(self, tokens: Sequence[str],
            trace: Optional[str] = None) -> List[Any]:
        protocol.send_request(self.sock, tokens, crc=True, trace=trace)
        ftype, entries, echo = self.reader.recv_frame_ex()
        want = (protocol.T_VERIFY_RESP_TRACE if trace is not None
                else protocol.T_VERIFY_RESP_CRC)
        if ftype != want or (trace is not None and echo != trace):
            raise protocol.ProtocolError(
                f"expected checksummed response type {want}, got type "
                f"{ftype}")
        if len(entries) != len(tokens):
            raise protocol.ProtocolError(
                f"response count {len(entries)} != request {len(tokens)}")
        out: List[Any] = []
        import json

        for status, payload in entries:
            if status == 0:
                out.append(json.loads(payload.decode()))
            else:
                out.append(RemoteVerifyError(payload.decode()))
        return out

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class FleetClient:
    """Verify batches against a worker fleet; never wrong, at worst slow.

    endpoints: list of (host, port), dict {id: (host, port)}, a
    callable returning either (the pool's ``endpoints`` method), or a
    ``WorkerPool`` (its ``endpoints`` is used).
    fallback: terminal local keyset (``verify_batch``); without it an
    all-workers-down batch raises :class:`FleetExhaustedError`.
    vcache: the client-side verdict-cache tier — False (off, the
    default), True (a default cache) or a configured ``VerdictCache``.
    vcache_ttl_s: the hard TTL of a default cache on bare endpoints
    (a pool-backed client clamps by the pool's key epoch and keeps
    entries up to 300 s).
    """

    def __init__(self, endpoints, fallback=None, *,
                 attempt_timeout: float = 5.0,
                 total_deadline: float = 30.0,
                 max_rounds: int = 3,
                 backoff_base: float = 0.05, backoff_max: float = 1.0,
                 breaker_threshold: int = 3, breaker_reset_s: float = 1.0,
                 hedge_after: Optional[float] = None,
                 rr_seed: Optional[int] = None,
                 vcache=False, vcache_ttl_s: float = 30.0):
        if hasattr(endpoints, "endpoints"):       # a WorkerPool
            self._pool = endpoints
            endpoints = endpoints.endpoints
        else:
            self._pool = None
        # Client-side verdict-cache tier (opt-in): hot tokens short-
        # circuit BEFORE the wire, with the same epoch/exp/nbf clamps
        # as the worker tier. Epoch clamp: pool-backed clients track
        # the pool's push-target epoch per call; bare-endpoint clients
        # (no epoch visibility) get a short hard TTL instead.
        # vcache: True → default cache; or pass a configured
        # VerdictCache instance. Bare-endpoint clients have NO epoch
        # visibility, so their only rotation bound is the hard TTL
        # (vcache_ttl_s), clamped positive so 0 can't mean forever.
        if vcache is True:
            ttl = (300.0 if self._pool is not None
                   else max(0.001, float(vcache_ttl_s)))
            vcache = _vcache.VerdictCache(max_ttl_s=ttl)
        self._vcache: Optional[_vcache.VerdictCache] = \
            vcache if isinstance(vcache, _vcache.VerdictCache) else None
        if self._vcache is not None and self._pool is not None:
            self._vcache.set_epoch(self._pool_epoch())
        self._endpoints_src = endpoints
        self._fallback = fallback
        self._attempt_timeout = attempt_timeout
        self._total_deadline = total_deadline
        self._max_rounds = max_rounds
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max
        self._breaker_threshold = breaker_threshold
        self._breaker_reset_s = breaker_reset_s
        self._hedge_after = hedge_after
        self._lock = threading.Lock()
        self._breakers: Dict[Endpoint, _Breaker] = {}
        # Admission pushback: when a worker answers with
        # ``throttled`` rejects, the retry-after hint opens a
        # client-side pushback window — inside it this client does
        # not hedge (duplicating a throttled batch doubles the very
        # load admission is shedding) and briefly waits before the
        # next routed batch (bounded by backoff_max). A throttled
        # reject is TERMINAL: it never triggers the CPU-oracle
        # fallback (re-verifying shed traffic would defeat admission)
        # and never earns breaker credit or failure — the transport
        # worked; the tenant is over budget.
        self._pushback_until = 0.0
        self._last_retry_after: Optional[float] = None
        # Start round-robin at a per-process offset (rr_seed pins it
        # for tests): N client processes all beginning at index 0
        # march over the workers in lockstep (batching re-syncs the
        # cohort every flush), convoying onto one worker while its
        # peers idle (the JAX fleet measured 1.34× instead of ~2× for
        # 2 workers).
        self._rr = (os.getpid() if rr_seed is None else rr_seed) % 7919

    # -- endpoint selection ----------------------------------------------

    def _live_endpoints(self) -> List[Endpoint]:
        src = self._endpoints_src
        eps = src() if callable(src) else src
        if isinstance(eps, dict):
            eps = [eps[k] for k in sorted(eps)]
        return list(eps)

    def _pick(self, exclude: Iterable[Endpoint] = ()) -> Optional[Endpoint]:
        """Next endpoint round-robin, skipping open breakers (a breaker
        past its reset window admits one probe)."""
        eps = [e for e in self._live_endpoints() if e not in set(exclude)]
        if not eps:
            return None
        now = time.monotonic()
        with self._lock:
            for i in range(len(eps)):
                ep = eps[(self._rr + i) % len(eps)]
                br = self._breakers.setdefault(ep, _Breaker())
                if br.open_until <= now:
                    self._rr = (self._rr + i + 1) % len(eps)
                    return ep
        return None

    def has_live_endpoint(self) -> bool:
        """Whether ANY endpoint is currently routable: at least one
        address listed and its breaker closed (or past its reset
        window, i.e. willing to admit a probe). The front-door tier
        uses this as its dead-pool signal for breaker-driven
        re-routes — cheap, lock-held only for the breaker scan."""
        eps = self._live_endpoints()
        if not eps:
            return False
        now = time.monotonic()
        with self._lock:
            return any(
                self._breakers.setdefault(ep, _Breaker()).open_until
                <= now for ep in eps)

    def _on_success(self, ep: Endpoint) -> None:
        with self._lock:
            br = self._breakers.setdefault(ep, _Breaker())
            if br.open_until > time.monotonic():
                # Half-open probe succeeded: the breaker CLOSES (the
                # transition capstat renders alongside the opens).
                telemetry.count("fleet.breaker_closes")
            br.failures = 0
            br.open_until = 0.0
            br.backoff = 0.0
            self._breaker_gauge_locked()

    def _on_failure(self, ep: Endpoint) -> None:
        telemetry.count("fleet.attempt_failures")
        with self._lock:
            br = self._breakers.setdefault(ep, _Breaker())
            br.failures += 1
            if br.failures >= self._breaker_threshold:
                if br.open_until <= time.monotonic():
                    telemetry.count("fleet.breaker_opens")
                br.open_until = time.monotonic() + self._breaker_reset_s
            self._breaker_gauge_locked()

    def _breaker_gauge_locked(self) -> None:
        now = time.monotonic()
        telemetry.gauge("fleet.breakers_open",
                        sum(1 for b in self._breakers.values()
                            if b.open_until > now))

    # -- client-side verdict cache ----------------------------------------

    def _pool_epoch(self) -> Optional[int]:
        try:
            return self._pool.keys_epoch()
        except Exception:  # noqa: BLE001 - cache stays conservative
            return None

    def _cache_consult(self, tokens: List[str]):
        """(hits, miss_idx, fill) — fill(fresh) merges the routed miss
        verdicts into hits IN PLACE and inserts them. None when the
        client tier is off."""
        vc = self._vcache
        if vc is None:
            return None
        if self._pool is not None:
            ep = self._pool_epoch()
            if ep != vc.epoch:
                # a rotation reached the fleet since our last call:
                # cached verdicts from before it die immediately
                vc.bump_epoch(ep)
        hits, miss_idx, digests = vc.lookup_batch(tokens)
        epoch0 = vc.epoch

        def fill(fresh: List[Any]) -> List[Any]:
            vc.insert_batch([digests[i] for i in miss_idx], fresh,
                            tokens=[tokens[i] for i in miss_idx],
                            epoch=epoch0)
            for j, i in enumerate(miss_idx):
                hits[i] = fresh[j]
            return hits

        return hits, miss_idx, fill

    # -- verify ----------------------------------------------------------

    def verify_batch(self, tokens: Sequence[str]) -> List[Any]:
        """Claims dict per verified token; RemoteVerifyError (or the
        fallback's per-token error) per rejected token. Raises only
        :class:`FleetExhaustedError` (whole batch, no fallback).

        When the caller holds a ``telemetry.trace()`` scope, the whole
        submission is spanned (``client.submit``), every attempt /
        hedge / backoff / fallback stage records a span against the
        trace id, and the id crosses the wire in the traced CVB1
        frame pair so the worker's stage spans join the same timeline.
        """
        tokens = list(tokens)
        if not tokens:
            return []
        t0 = time.perf_counter()
        with telemetry.span(telemetry.SPAN_CLIENT_SUBMIT):
            consult = self._cache_consult(tokens)
            if consult is None:
                out = self._verify_batch_routed(
                    tokens, telemetry.current_trace())
            else:
                hits, miss_idx, fill = consult
                if miss_idx:
                    fresh = self._verify_batch_routed(
                        [tokens[i] for i in miss_idx],
                        telemetry.current_trace())
                    out = fill(fresh)
                else:
                    out = hits
        # Router-surface decision records: the verdicts the CALLER
        # sees, whichever path produced them (worker, hedge peer, or
        # the terminal oracle) — worker rejections arrive as
        # RemoteVerifyError and classify back to the engine's reason.
        _decision.record_batch("router", out, tokens=tokens,
                               latency_s=time.perf_counter() - t0)
        self._note_pushback(out)
        return out

    # -- admission pushback ------------------------------------------------

    @staticmethod
    def _is_throttled(res: Any) -> bool:
        return (isinstance(res, Exception)
                and _decision.classify(res)
                == _decision.REASON_THROTTLED)

    def _note_pushback(self, results: Sequence[Any]) -> None:
        """Honor throttled rejects: count them and open the pushback
        window from the worker's retry-after hint."""
        thr = sum(1 for r in results if self._is_throttled(r))
        if not thr:
            return
        telemetry.count("fleet.throttled_tokens", thr)
        hint = None
        for r in results:
            if self._is_throttled(r):
                h = protocol.retry_after_hint(str(r))
                if h is not None and (hint is None or h > hint):
                    hint = h
        if hint is None:
            hint = self._backoff_base
        self._last_retry_after = hint
        until = time.monotonic() + min(hint, self._backoff_max)
        with self._lock:
            if until > self._pushback_until:
                self._pushback_until = until

    def _pushback_remaining(self) -> float:
        with self._lock:
            return max(0.0, self._pushback_until - time.monotonic())

    @classmethod
    def _all_throttled(cls, results: Sequence[Any]) -> bool:
        """True when a response is PURE admission pushback: such an
        exchange proves the transport works but says nothing about
        verify health — it earns neither breaker credit nor failure."""
        return bool(results) and all(cls._is_throttled(r)
                                     for r in results)

    def pushback_state(self) -> Dict[str, Any]:
        """The live pushback window (capstat's router view): seconds
        remaining + the last retry-after hint a worker sent."""
        return {"active_s": round(self._pushback_remaining(), 4),
                "retry_after_s": self._last_retry_after}

    def _verify_batch_routed(self, tokens: List[str],
                             trace: Optional[str]) -> List[Any]:
        # Client-side backoff inside an open pushback window: one
        # bounded wait (≤ backoff_max) before dispatching more load
        # at a fleet that is actively shedding this client's tenants.
        wait = self._pushback_remaining()
        if wait > 0:
            telemetry.count("fleet.pushback_waits")
            with telemetry.span(telemetry.SPAN_ROUTER_BACKOFF):
                time.sleep(min(wait, self._backoff_max))
        deadline = time.monotonic() + self._total_deadline
        tried_this_round: List[Endpoint] = []
        rounds = 0
        while rounds < self._max_rounds and time.monotonic() < deadline:
            ep = self._pick(exclude=tried_this_round)
            if ep is None:
                if not tried_this_round:
                    break              # nothing live at all → fallback
                rounds += 1            # full round exhausted
                tried_this_round = []
                sleep = min(self._backoff_max,
                            self._backoff_base * (2 ** (rounds - 1)))
                telemetry.count("fleet.retry_rounds")
                if time.monotonic() + sleep >= deadline:
                    break
                with telemetry.span(telemetry.SPAN_ROUTER_BACKOFF):
                    time.sleep(sleep)
                continue
            tried_this_round.append(ep)
            budget = min(self._attempt_timeout,
                         deadline - time.monotonic())
            if budget <= 0:
                break
            try:
                # Success credit happens INSIDE the attempt, to the
                # endpoint that actually answered: crediting ``ep``
                # here would reset a stalled primary's breaker on
                # every hedge win, keeping it permanently half-dead.
                return self._attempt_hedged(ep, tokens, budget,
                                            tried_this_round, trace)
            except (OSError, protocol.ProtocolError):
                self._on_failure(ep)
                telemetry.count("fleet.failovers")
        return self._terminal_fallback(tokens, trace)

    def verify_signature(self, token: str) -> Any:
        res = self.verify_batch([token])[0]
        if isinstance(res, Exception):
            raise res
        return res

    # -- internals --------------------------------------------------------

    def _attempt_once(self, ep: Endpoint, tokens: Sequence[str],
                      budget: float,
                      trace: Optional[str] = None,
                      span_name: str = telemetry.SPAN_ROUTER_ATTEMPT
                      ) -> List[Any]:
        t0_wall = time.time()
        t0 = time.perf_counter()
        at = _Attempt(ep, budget)
        try:
            at.sock.settimeout(budget)
            return at.run(tokens, trace=trace)
        finally:
            at.close()
            dur = time.perf_counter() - t0
            telemetry.observe("router.attempt_s", dur)
            if trace:
                # Recorded explicitly: hedge attempts run on worker
                # threads where the caller's context var doesn't flow.
                telemetry.trace_span(trace, span_name, t0_wall, dur,
                                     note=f"{ep[0]}:{ep[1]}")

    def _attempt_hedged(self, ep: Endpoint, tokens: Sequence[str],
                        budget: float, tried: List[Endpoint],
                        trace: Optional[str] = None) -> List[Any]:
        """Primary attempt on ``ep``; if no answer after ``hedge_after``
        and a healthy peer exists, race a duplicate on the peer and
        take the first success (verify is deterministic → duplicate
        execution cannot change any verdict)."""
        hedge = self._hedge_after
        if hedge is not None and self._pushback_remaining() > 0:
            # no hedging inside a pushback window: duplicating a
            # throttled batch doubles exactly the load being shed
            hedge = None
        if hedge is None or hedge >= budget:
            res = self._attempt_once(ep, tokens, budget, trace)
            if not self._all_throttled(res):
                self._on_success(ep)
            return res

        result_q: "List[Tuple[Endpoint, Any]]" = []
        done = threading.Condition()
        attempts: List[_Attempt] = []

        def run_on(endpoint: Endpoint, timeout: float,
                   span_name: str = telemetry.SPAN_ROUTER_ATTEMPT) -> None:
            at = None
            t0_wall = time.time()
            t0a = time.perf_counter()
            try:
                at = _Attempt(endpoint, timeout)
                with done:
                    attempts.append(at)
                at.sock.settimeout(timeout)
                res = at.run(tokens, trace=trace)
                with done:
                    result_q.append((endpoint, res))
                    done.notify_all()
            except (OSError, protocol.ProtocolError) as e:
                if at is not None:
                    at.close()
                self._on_failure(endpoint)
                with done:
                    result_q.append((endpoint, e))
                    done.notify_all()
            finally:
                dur = time.perf_counter() - t0a
                telemetry.observe("router.attempt_s", dur)
                if trace:
                    telemetry.trace_span(
                        trace, span_name, t0_wall, dur,
                        note=f"{endpoint[0]}:{endpoint[1]}")

        t0 = time.monotonic()
        threading.Thread(target=run_on, args=(ep, budget),
                         daemon=True, name="cap-gpu-fleet-attempt").start()
        launched = 1
        hedge_ep = None
        try:
            with done:
                while True:
                    oks = [r for r in result_q
                           if not isinstance(r[1], Exception)]
                    if oks:
                        break
                    if len(result_q) >= launched:
                        # every launched attempt failed
                        raise result_q[0][1]
                    elapsed = time.monotonic() - t0
                    if elapsed >= budget:
                        raise socket.timeout(
                            f"attempt deadline ({budget:.2f}s) exceeded")
                    if (launched == 1 and elapsed >= hedge
                            and hedge_ep is None):
                        hedge_ep = self._pick(exclude=tried)
                        if hedge_ep is not None:
                            tried.append(hedge_ep)
                            telemetry.count("fleet.hedges")
                            remaining = budget - elapsed
                            threading.Thread(
                                target=run_on,
                                args=(hedge_ep, remaining,
                                      telemetry.SPAN_ROUTER_HEDGE),
                                daemon=True,
                                name="cap-gpu-fleet-hedge").start()
                            launched = 2
                    next_wake = (hedge - elapsed if launched == 1
                                 and hedge_ep is None else 0.05)
                    done.wait(timeout=max(0.01, min(next_wake,
                                                    budget - elapsed)))
                winner_ep, res = oks[0]
            if winner_ep != ep:
                telemetry.count("fleet.hedge_wins")
            if not self._all_throttled(res):
                self._on_success(winner_ep)
            return res
        finally:
            # Close EVERY attempt socket (winner included — done with
            # it; losers carry unread or never-coming responses, and a
            # close unblocks their recv so the threads exit).
            with done:
                pending = list(attempts)
            for at in pending:
                at.close()

    def _terminal_fallback(self, tokens: List[str],
                           trace: Optional[str] = None) -> List[Any]:
        if self._fallback is None:
            raise FleetExhaustedError()
        telemetry.count("fleet.fallback_batches")
        telemetry.count("fleet.fallback_tokens", len(tokens))
        # Runs in-caller, so the trace context is still active: any
        # engine spans inside the oracle attach to the same timeline.
        with telemetry.span(telemetry.SPAN_ROUTER_FALLBACK):
            return self._fallback.verify_batch(tokens)

    # -- observability ----------------------------------------------------

    def breaker_states(self) -> Dict[Endpoint, Dict[str, float]]:
        now = time.monotonic()
        with self._lock:
            return {ep: {"failures": br.failures,
                         "open_for_s": max(0.0, br.open_until - now)}
                    for ep, br in self._breakers.items()}

    def key_epoch_skew(self) -> Optional[int]:
        """Key-epoch spread across the pool's workers (0 = converged,
        None when this client routes to bare endpoints): a sustained
        nonzero value means part of the fleet is verifying against
        retired key material — rotation propagation is stuck."""
        if self._pool is None or not hasattr(self._pool, "epoch_skew"):
            return None
        return self._pool.epoch_skew()

    def snapshot(self) -> Dict[str, Any]:
        """Client-side observability bundle (``tools/capstat.py`` reads
        its shape):
        the process recorder's mergeable snapshot (router counters,
        attempt latency histograms, breaker gauges) plus the live
        per-endpoint breaker states keyed ``host:port`` and — when the
        client is pool-backed — the fleet's key-epoch map and skew."""
        rec = telemetry.active()
        out = {
            "snapshot": rec.snapshot() if rec is not None else {},
            "spans": rec.trace_spans() if rec is not None else [],
            "breakers": {f"{ep[0]}:{ep[1]}": st
                         for ep, st in self.breaker_states().items()},
            "pushback": self.pushback_state(),
        }
        if rec is not None:
            # router-side tenant fold (issuer-hash keyed): what THIS
            # client routed per tenant, from its own decision counters
            # (docs/OBSERVABILITY.md §Tenant attribution)
            tenants = _decision.tenant_totals(rec.counters(),
                                              surface="router")
            if tenants:
                out["tenants"] = tenants
        if self._vcache is not None:
            out["vcache"] = self._vcache.stats()
        skew = self.key_epoch_skew()
        if skew is not None:
            out["key_epochs"] = {str(k): v for k, v in
                                 self._pool.key_epochs().items()}
            out["epoch_skew"] = skew
            telemetry.gauge("keyplane.epoch_skew", skew)
        out["pushback"] = self.pushback_state()
        if self._pool is not None and hasattr(self._pool,
                                              "resize_events"):
            events = self._pool.resize_events()
            if events:
                out["resize_events"] = events[-8:]
            if hasattr(self._pool, "size"):
                out["pool_size"] = self._pool.size()
        return out

    def close(self) -> None:
        pass                           # attempts own their sockets

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

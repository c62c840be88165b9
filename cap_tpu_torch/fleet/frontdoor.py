"""Digest-affinity front door: the cross-host routing tier.

The port of ``cap_tpu.fleet.frontdoor``. Everything below one
:class:`~cap_tpu_torch.fleet.pool.WorkerPool` assumes a single host.
The front door is the tier above it: ONE router speaking CVB1 to N
worker pools ("hosts"), turning each worker's verdict cache into a
FLEET-WIDE one:

- **affinity routing**: every token is routed by a consistent hash
  over its sha256[:16] digest — the same digest the C++ serve readers
  compute at frame-parse time (and the vcache keys on), handed down
  through the batcher (``verify_batch_digests``) so the front door
  never re-hashes what the reader already hashed. Every repeat of a
  token therefore lands on the host that cached its verdict; a pool
  joining or leaving remaps ONLY the ring segments it owned.
- **bounded-load spill** (power-of-two-choices): when the hash target
  is hot — its in-flight load exceeds ``spill_factor ×`` the fleet
  average — the token spills to its SECOND ring choice, which then
  warms its own cache for that token. Affinity bends under load, it
  never wedges behind one hot shard.
- **breaker-driven re-route**: a pool with no live workers (crash,
  kill -9, every breaker open) is skipped at partition time, and a
  dispatch that still dies (``FleetExhaustedError``) re-routes to the
  next ring choice before the terminal ``fallback`` the caller passed
  (without one, :class:`FleetExhaustedError`). The availability
  contract is unchanged: never wrong, at worst slow.
- **keyplane fan-out**: ``push_keys`` records the distribution target,
  then fans the epoch to every pool (each pool's supervisor keeps
  re-pushing its own stragglers); ``epoch_skew`` / ``key_epochs``
  surface convergence across the WHOLE fleet in one place.

Peer-fill (cache warming for rotated-in workers) rides the CVB1
type-13/14 frame pair and is driven by each pool's supervisor — see
:mod:`cap_tpu_torch.fleet.pool`.

:class:`NativeFrontDoorServer` is the deployable gateway's fast path:
C++ readers (``runtime/native/frontdoor_native.cpp``, the ``frontdoor``
target of :mod:`cap_tpu_torch._build`) route each frame by digest and
splice its bytes to the owning pool; this module's :class:`FrontDoor`
stays the slow path. Where the JAX package picks the relay by default
behind an environment kill switch and falls back to the Python gate
when the library is missing, this one takes the chain as an argument
(``worker_main --frontdoor-chain native|python``): a relay that does
not build raises ``RuntimeError``, a missing symbol or a drifted layout
``ImportError``.

Counters (exact: ``frontdoor.lookups == frontdoor.affinity_hits +
frontdoor.affinity_misses``; misses further split into spills +
reroutes + rr-routed):
``frontdoor.lookups / affinity_hits / affinity_misses / spills /
reroutes / fallback_tokens / keys_pushes / throttled_tokens``.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import telemetry
from ..obs import decision as _decision
from ..serve import protocol
from ..serve import vcache as _vcache
from .router import FleetClient, FleetExhaustedError

Endpoint = Tuple[str, int]


class ConsistentHashRing:
    """Consistent hash ring over pool ids, with virtual nodes.

    Positions are sha256-derived 64-bit points, so the keyspace each
    pool owns is stable under membership change: removing a pool
    remaps ONLY its own segments (pinned by test). ``vnodes`` virtual
    nodes per pool keep the ownership split near-uniform.
    """

    def __init__(self, pool_ids: Sequence[int], vnodes: int = 64):
        self._vnodes = vnodes
        self._points: List[int] = []
        self._owners: List[int] = []
        for pid in pool_ids:
            for v in range(vnodes):
                h = hashlib.sha256(
                    f"cap-frontdoor:{pid}:{v}".encode()).digest()
                self._points.append(int.from_bytes(h[:8], "big"))
                self._owners.append(pid)
        order = sorted(range(len(self._points)),
                       key=lambda i: self._points[i])
        self._points = [self._points[i] for i in order]
        self._owners = [self._owners[i] for i in order]
        self._n_pools = len(set(pool_ids))

    def primary(self, digest: bytes) -> int:
        """The pool owning this digest's ring point."""
        return self.preference(digest, 1)[0]

    def preference(self, digest: bytes, n: int = 2) -> List[int]:
        """First ``n`` DISTINCT pools walking the ring clockwise from
        the digest's point — preference order for spill/re-route."""
        pts = self._points
        if not pts:
            raise ValueError("empty ring")
        i = bisect.bisect_right(pts, int.from_bytes(digest[:8], "big"))
        out: List[int] = []
        for k in range(len(pts)):
            owner = self._owners[(i + k) % len(pts)]
            if owner not in out:
                out.append(owner)
                if len(out) >= min(n, self._n_pools):
                    break
        return out


class _PoolArm:
    """One routed pool: its transport client + live-load accounting."""

    def __init__(self, pool_id: int, pool: Any,
                 client: FleetClient):
        self.pool_id = pool_id
        self.pool = pool              # WorkerPool or None (bare eps)
        self.client = client
        self.inflight = 0             # tokens currently dispatched
        self.tokens = 0               # lifetime routed tokens
        self.affinity_hits = 0
        self.spills_in = 0            # tokens spilled TO this arm
        self.reroutes_in = 0          # tokens re-routed TO this arm

    def live(self) -> bool:
        return self.client.has_live_endpoint()


class FrontDoor:
    """Route verify batches across N worker pools by digest affinity.

    pools: a list where each element describes one "host" — a
    ``WorkerPool``, a list of ``(host, port)`` endpoints, or a
    callable returning endpoints (the ``FleetClient`` contract).
    fallback: terminal local keyset (``verify_batch``) used only when
    a token's whole preference chain is exhausted; without one that
    batch raises :class:`FleetExhaustedError`.
    routing: ``"affinity"`` (consistent hash, the point of this tier)
    or ``"rr"`` (round-robin whole batches across pools — the A/B
    control arm).
    spill_factor: bounded-load constant ``c`` — a primary whose
    in-flight tokens exceed ``c ×`` the fleet-average load spills to
    the second ring choice when that choice is strictly less loaded
    (c=1.25, the classic bounded-load consistent-hashing constant;
    note the average includes the overloaded arm, so with N pools the
    ratio is bounded by N — c must stay below that).
    client_kw: passed through to each pool's ``FleetClient``.
    """

    def __init__(self, pools: Sequence[Any], fallback=None, *,
                 routing: str = "affinity", spill_factor: float = 1.25,
                 vnodes: int = 64,
                 client_kw: Optional[Dict[str, Any]] = None):
        if not pools:
            raise ValueError("front door needs at least one pool")
        if routing not in ("affinity", "rr"):
            raise ValueError(f"unknown routing mode {routing!r}")
        self._routing = routing
        self._spill_factor = float(spill_factor)
        self._fallback = fallback
        kw = dict(client_kw or {})
        kw.setdefault("attempt_timeout", 5.0)
        kw.setdefault("total_deadline", 15.0)
        kw.setdefault("max_rounds", 2)
        self._arms: List[_PoolArm] = []
        for pid, pool in enumerate(pools):
            is_pool = hasattr(pool, "endpoints") \
                and hasattr(pool, "push_keys")
            client = FleetClient(pool, fallback=None,
                                 rr_seed=pid, **kw)
            self._arms.append(_PoolArm(pid, pool if is_pool else None,
                                       client))
        self._ring = ConsistentHashRing(
            [a.pool_id for a in self._arms], vnodes=vnodes)
        self._rr_next = 0
        self._lock = threading.Lock()
        # Keyplane distribution target: recorded BEFORE any pool is
        # contacted (kill -9 mid-push converges via the pools'
        # supervisors; bare-endpoint pools get best-effort re-push on
        # the next push_keys call).
        self._keys_current: Optional[Tuple[int, dict]] = None
        self._ctr = {"frontdoor.lookups": 0,
                     "frontdoor.affinity_hits": 0,
                     "frontdoor.affinity_misses": 0,
                     "frontdoor.spills": 0,
                     "frontdoor.reroutes": 0,
                     "frontdoor.fallback_tokens": 0,
                     "frontdoor.keys_pushes": 0}

    # -- routing ----------------------------------------------------------

    def verify_batch(self, tokens: Sequence[str],
                     digests: Optional[Sequence[Optional[bytes]]]
                     = None) -> List[Any]:
        """Claims per verified token, Exception per rejected — order
        preserved, whatever pool (or the terminal fallback) produced
        each verdict. ``digests``: optional per-token sha256[:16]
        (reader-computed upstream); missing ones are hashed here."""
        tokens = list(tokens)
        if not tokens:
            return []
        t0 = time.perf_counter()
        with telemetry.span(telemetry.SPAN_FRONTDOOR_ROUTE):
            groups, group_hits = self._partition(tokens, digests)
            out: List[Any] = [None] * len(tokens)
            if len(groups) == 1:
                arm_id, idxs = next(iter(groups.items()))
                self._dispatch_group(arm_id, tokens, idxs, out,
                                     group_hits.get(arm_id, 0))
            else:
                # A group whose whole chain is exhausted raises in its
                # thread: the error is carried back and raised here, so
                # its tokens never come back as a None "verdict" (the
                # serve encoder would send None as an accept).
                errors: List[BaseException] = []

                def dispatch(arm_id, idxs):
                    try:
                        self._dispatch_group(arm_id, tokens, idxs, out,
                                             group_hits.get(arm_id, 0))
                    except BaseException as e:  # noqa: BLE001 - raised
                        errors.append(e)

                threads = []
                for arm_id, idxs in groups.items():
                    th = threading.Thread(
                        target=dispatch, args=(arm_id, idxs),
                        daemon=True, name="cap-gpu-frontdoor")
                    th.start()
                    threads.append(th)
                for th in threads:
                    th.join()
                if errors:
                    raise errors[0]
        _decision.record_batch("frontdoor", out, tokens=tokens,
                               latency_s=time.perf_counter() - t0)
        # Admission pushback accounting: throttled rejects are
        # TERMINAL here exactly as at the router — the front door
        # never re-routes or oracle-falls-back a shed token (that
        # would defeat admission); it only counts what came back.
        thr = sum(1 for r in out
                  if isinstance(r, Exception)
                  and _decision.classify(r)
                  == _decision.REASON_THROTTLED)
        if thr:
            self._count({"frontdoor.throttled_tokens": thr})
        return out

    def verify_batch_digests(self, tokens: Sequence[str],
                             digests: Optional[Sequence[
                                 Optional[bytes]]]) -> List[Any]:
        """The batcher-facing digest-routed entry point: what lets a
        ``VerifyWorker(FrontDoor(...))`` reuse the native readers'
        frame-parse-time digests instead of re-hashing."""
        return self.verify_batch(tokens, digests=digests)

    def _partition(self, tokens: List[str],
                   digests: Optional[Sequence[Optional[bytes]]]
                   ) -> Tuple[Dict[int, List[int]], Dict[int, int]]:
        """token index → owning arm, by ring + bounded load (or rr);
        also returns how many of each group's tokens were counted as
        affinity hits (dispatch re-routes re-class exactly those)."""
        n = len(tokens)
        arms = self._arms
        if self._routing == "rr" or len(arms) == 1:
            with self._lock:
                arm = arms[self._rr_next % len(arms)]
                self._rr_next += 1
            if not arm.live():
                live = [a for a in arms if a.live()]
                if live:
                    arm = live[self._rr_next % len(live)]
            if len(arms) > 1:
                hit_flags = [self._ring.primary(self._digest(
                    tokens[i], digests, i)) == arm.pool_id
                    for i in range(n)]
                hits = sum(hit_flags)
            else:
                hit_flags = [True] * n
                hits = n
            self._count({"frontdoor.lookups": n,
                         "frontdoor.affinity_hits": hits,
                         "frontdoor.affinity_misses": n - hits})
            self._count_tenants(tokens, hit_flags)
            with self._lock:
                arm.tokens += n
                arm.affinity_hits += hits
            return {arm.pool_id: list(range(n))}, {arm.pool_id: hits}
        # affinity: per-token ring walk with bounded-load spill
        groups: Dict[int, List[int]] = {}
        loads = {a.pool_id: a.inflight for a in arms}
        hits = reroutes = 0
        hit_flags = [False] * n
        hits_by: Dict[int, int] = {}
        spills_by: Dict[int, int] = {}
        reroutes_by: Dict[int, int] = {}
        for i in range(n):
            d = self._digest(tokens[i], digests, i)
            pref = self._ring.preference(d, 2)
            target = pref[0]
            primary_live = arms[target].live()
            if not primary_live and len(pref) > 1:
                # breaker-driven re-route: the hash target is dead
                nxt = next((p for p in pref[1:] if arms[p].live()),
                           None)
                if nxt is not None:
                    target = nxt
                    reroutes += 1
                    reroutes_by[target] = \
                        reroutes_by.get(target, 0) + 1
                else:
                    hits += 1      # nothing live: stay on primary,
                    #                the dispatch fallback owns it
                    hit_flags[i] = True
                    hits_by[target] = hits_by.get(target, 0) + 1
            elif len(pref) > 1:
                avg = (sum(loads.values()) + n) / max(1, len(loads))
                second = pref[1]
                if (loads[target] > self._spill_factor * avg
                        and loads[second] < loads[target]
                        and arms[second].live()):
                    target = second
                    spills_by[target] = spills_by.get(target, 0) + 1
                else:
                    hits += 1
                    hit_flags[i] = True
                    hits_by[target] = hits_by.get(target, 0) + 1
            else:
                hits += 1
                hit_flags[i] = True
                hits_by[target] = hits_by.get(target, 0) + 1
            loads[target] += 1
            groups.setdefault(target, []).append(i)
        spills = sum(spills_by.values())
        self._count({"frontdoor.lookups": n,
                     "frontdoor.affinity_hits": hits,
                     "frontdoor.affinity_misses": spills + reroutes,
                     "frontdoor.spills": spills,
                     "frontdoor.reroutes": reroutes})
        self._count_tenants(tokens, hit_flags)
        with self._lock:
            for a in arms:
                extra = len(groups.get(a.pool_id, ()))
                if extra:
                    a.tokens += extra
                a.affinity_hits += hits_by.get(a.pool_id, 0)
                a.spills_in += spills_by.get(a.pool_id, 0)
                a.reroutes_in += reroutes_by.get(a.pool_id, 0)
        return groups, hits_by

    def _count_tenants(self, tokens: List[str],
                       hit_flags: List[bool]) -> None:
        """Per-tenant routed traffic + affinity hit-rate
        (``frontdoor.tenant.<t>.lookups`` / ``.affinity_hits``) — the
        router-side tenant fold. Labels come from the same
        header-segment cache the decision fold uses (one dict hit per
        token)."""
        from collections import Counter

        labels = _decision.tenant_labels(tokens)
        lookups = Counter(labels)
        hit_c = Counter(t for t, h in zip(labels, hit_flags) if h)
        inc = {}
        for t, k in lookups.items():
            inc[f"frontdoor.tenant.{t}.lookups"] = k
        for t, k in hit_c.items():
            inc[f"frontdoor.tenant.{t}.affinity_hits"] = k
        self._count(inc)

    @staticmethod
    def _digest(token: str, digests, i: int) -> bytes:
        if digests is not None:
            d = digests[i]
            if d:
                return d
        return _vcache.token_digest(token)

    def _dispatch_group(self, arm_id: int, tokens: List[str],
                        idxs: List[int], out: List[Any],
                        hits0: int = 0) -> None:
        """One arm's sub-batch: primary arm → ring re-route chain →
        terminal fallback. Writes verdicts into ``out`` in place
        (disjoint index sets per group — no lock needed)."""
        sub = [tokens[i] for i in idxs]
        tried = set()
        chain = [arm_id] + [a.pool_id for a in self._arms
                            if a.pool_id != arm_id]
        results: Optional[List[Any]] = None
        for hop, pid in enumerate(chain):
            if pid in tried:
                continue
            tried.add(pid)
            arm = self._arms[pid]
            if hop > 0:
                if not arm.live():
                    continue
                # A dispatch-time death discovered AFTER partition
                # accounting: re-class exactly the tokens the
                # partition counted as hits, so the
                # lookups == hits + misses invariant stays exact.
                self._count({"frontdoor.reroutes": len(sub),
                             "frontdoor.affinity_misses": hits0,
                             "frontdoor.affinity_hits": -hits0})
                hits0 = 0
                with self._lock:
                    arm.reroutes_in += len(sub)
            with self._lock:
                arm.inflight += len(sub)
            try:
                results = arm.client.verify_batch(sub)
                break
            except (FleetExhaustedError, OSError,
                    protocol.ProtocolError):
                results = None
            finally:
                with self._lock:
                    arm.inflight -= len(sub)
        if results is None:
            results = self._terminal_fallback(sub)
        for j, i in enumerate(idxs):
            out[i] = results[j]

    def _terminal_fallback(self, tokens: List[str]) -> List[Any]:
        if self._fallback is None:
            raise FleetExhaustedError()
        self._count({"frontdoor.fallback_tokens": len(tokens)})
        with telemetry.span(telemetry.SPAN_ROUTER_FALLBACK):
            return self._fallback.verify_batch(tokens)

    # -- keyplane fan-out -------------------------------------------------

    def push_keys(self, jwks_doc: dict, epoch: Optional[int] = None
                  ) -> Dict[int, Any]:
        """Fan one key epoch out to every pool; returns
        pool_id → per-worker ack map (or per-endpoint list for bare
        endpoints). The target is recorded BEFORE any pool is
        contacted, so a front door asked again (or a pool supervisor)
        can converge stragglers after a kill -9 mid-push."""
        with self._lock:
            if epoch is None:
                epoch = (self._keys_current[0] + 1
                         if self._keys_current else 1)
            epoch = int(epoch)
            self._keys_current = (epoch, jwks_doc)
        self._count({"frontdoor.keys_pushes": 1})
        telemetry.gauge("keyplane.epoch", epoch)
        out: Dict[int, Any] = {}
        for arm in self._arms:
            if arm.pool is not None:
                out[arm.pool_id] = arm.pool.push_keys(jwks_doc,
                                                      epoch=epoch)
            else:
                out[arm.pool_id] = self._push_keys_endpoints(
                    arm, jwks_doc, epoch)
        return out

    def _push_keys_endpoints(self, arm: _PoolArm, jwks_doc: dict,
                             epoch: int) -> Dict[str, Optional[int]]:
        """Direct KEYS push to a bare-endpoint pool (no supervisor —
        best effort, re-converged on the next push)."""
        import json as _json
        import socket as _socket

        acked: Dict[str, Optional[int]] = {}
        for ep in arm.client._live_endpoints():
            key = f"{ep[0]}:{ep[1]}"
            try:
                with _socket.create_connection(ep, timeout=5.0) as s:
                    s.settimeout(30.0)
                    protocol.send_keys_push(s, jwks_doc, epoch)
                    ftype, entries = \
                        protocol.FrameReader(s).recv_frame()
                if (ftype == protocol.T_KEYS_ACK and entries
                        and entries[0][0] == 0):
                    acked[key] = int(
                        _json.loads(entries[0][1]).get("epoch"))
                else:
                    acked[key] = None
            except (OSError, protocol.ProtocolError, ValueError,
                    TypeError):
                acked[key] = None
        return acked

    def swap_keys(self, jwks_doc: dict, epoch: Optional[int] = None,
                  grace_s: float = 0.0) -> int:
        """The engine-facing alias: lets a front door BE a
        ``VerifyWorker`` keyset, so a KEYS push to the front-door
        server propagates to every pool behind it."""
        with self._lock:
            if epoch is None:
                epoch = (self._keys_current[0] + 1
                         if self._keys_current else 1)
        self.push_keys(jwks_doc, epoch=int(epoch))
        return int(epoch)

    @property
    def key_epoch(self) -> Optional[int]:
        """The epoch the fleet is converging on (None: never pushed)."""
        with self._lock:
            return self._keys_current[0] if self._keys_current else None

    def key_epochs(self) -> Dict[str, Optional[int]]:
        """``"p<pool>.w<worker>"`` → last known epoch, every pool."""
        out: Dict[str, Optional[int]] = {}
        for arm in self._arms:
            if arm.pool is None:
                continue
            for wid, ep in arm.pool.key_epochs().items():
                out[f"p{arm.pool_id}.w{wid}"] = ep
        return out

    def epoch_skew(self) -> int:
        """Spread between newest and oldest worker epoch across the
        WHOLE fleet (0 = converged) — rotation health in one number."""
        epochs = [e for e in self.key_epochs().values()
                  if e is not None]
        skew = (max(epochs) - min(epochs)) if epochs else 0
        telemetry.gauge("keyplane.epoch_skew", skew)
        return skew

    # -- observability ----------------------------------------------------

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._ctr)

    def _count(self, inc: Dict[str, int]) -> None:
        inc = {k: v for k, v in inc.items() if v}
        if not inc:
            return
        with self._lock:
            for k, v in inc.items():
                self._ctr[k] = self._ctr.get(k, 0) + v
        rec = telemetry.active()
        if rec is not None:
            rec.count_many(inc)

    def snapshot(self) -> Dict[str, Any]:
        """The observability bundle (the shape ``tools/capstat.py
        --frontdoor FILE`` reads): routing counters, per-pool
        affinity/spill/load state, breaker views, and the fleet epoch
        map + skew."""
        with self._lock:
            pools = {
                str(a.pool_id): {
                    "tokens": a.tokens,
                    "affinity_hits": a.affinity_hits,
                    "spills_in": a.spills_in,
                    "reroutes_in": a.reroutes_in,
                    "inflight": a.inflight,
                    "endpoints": len(a.client._live_endpoints()),
                    "live": a.live(),
                    "pushback": a.client.pushback_state(),
                } for a in self._arms
            }
            ctr = dict(self._ctr)
        skew = self.epoch_skew()
        # per-tenant routed-traffic view (issuer-hash keyed — raw
        # issuers never appear anywhere in this document)
        tenants: Dict[str, Dict[str, int]] = {}
        for k, v in ctr.items():
            if not k.startswith("frontdoor.tenant."):
                continue
            parts = k.split(".")
            if len(parts) != 4:
                continue
            tenants.setdefault(parts[2], {})[parts[3]] = int(v)
        return {
            "routing": self._routing,
            "counters": ctr,
            "tenants": tenants,
            "pools": pools,
            "key_epochs": self.key_epochs(),
            "epoch_skew": skew,
            "epoch": self.key_epoch,
            "breakers": {
                str(a.pool_id): {f"{ep[0]}:{ep[1]}": st
                                 for ep, st in
                                 a.client.breaker_states().items()}
                for a in self._arms
            },
        }

    def close(self) -> None:
        for a in self._arms:
            a.client.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def frontdoor_from_spec(spec: str) -> FrontDoor:
    """Build a front door from a ``--keyset frontdoor:`` spec string:

        frontdoor:pool=h1:p1+h2:p2;pool=h3:p3[;routing=rr][;spill=2.0]

    Pools are ``;``-separated ``pool=`` items, each a ``+``-separated
    list of host:port endpoints; ``routing`` and ``spill`` map to the
    constructor knobs. The resulting worker serves CVB1 on the front
    AND speaks CVB1 to every pool behind — the deployable router-tier
    process (``worker_main --keyset frontdoor:...``).
    """
    pools: List[List[Endpoint]] = []
    routing = "affinity"
    spill = 1.25
    for part in spec.split(";"):
        if not part:
            continue
        k, _, v = part.partition("=")
        if k == "pool":
            eps: List[Endpoint] = []
            for hp in v.split("+"):
                host, _, port = hp.rpartition(":")
                eps.append((host, int(port)))
            if not eps:
                raise ValueError("empty pool in frontdoor spec")
            pools.append(eps)
        elif k == "routing":
            routing = v
        elif k == "spill":
            spill = float(v)
        else:
            raise ValueError(f"unknown frontdoor option {k!r}")
    if not pools:
        raise ValueError("frontdoor spec names no pools")
    return FrontDoor(pools, routing=routing, spill_factor=spill)


# ---------------------------------------------------------------------------
# Native relay front door: the C++ fast path wrapped around the
# FrontDoor slow path.
# ---------------------------------------------------------------------------

# drain meta[1] reason codes → counter suffixes
# (frontdoor_native.cpp R_* enum; pinned by the layout handshake's
# version field rather than per-code — keep in sync)
_SLOW_REASONS = {1: "control", 2: "dead_pool", 3: "overload",
                 4: "upstream_fail", 5: "unrouted"}

# cap_frontdoor_counter slot → exported counter suffix, in slot order
# (native_serve.FDC_* constants)
_FDC_NAMES = ("conns", "frames", "tokens", "proto_errors", "pongs",
              "lookups", "hits", "relays", "relay_tokens", "splices",
              "slow_frames", "slow_tokens", "upstream_fails",
              "seq_held_max", "dropped_posts", "conns_closed")


class NativeFrontDoorServer:
    """The zero-copy relay front door: C++ per-connection readers
    parse/validate/classify each CVB1 frame ONCE at the edge, look the
    reader-computed digest up against a pushed-down ring snapshot, and
    splice payload bytes straight onto the owning pool's socket —
    responses splice back in strict per-connection seq order. Python
    (the wrapped :class:`FrontDoor`) stays the slow path: bounded-load
    spill, breaker re-route, keyplane fan-out and every control frame
    drain through ``cap_frontdoor_drain`` and are answered via
    ``cap_frontdoor_post_raw`` — the twin pattern (drr.py) keeps the
    routing decision itself pinned bit-exact via
    ``cap_frontdoor_probe_route``.

    Surface-compatible with ``VerifyWorker(FrontDoor(...))`` — the
    deployable gateway worker_main builds for ``--frontdoor-chain
    native``: ``address`` / ``obs_address`` / ``key_epoch`` /
    ``stats()`` / ``close()``. The relay library is loaded (built on
    first use) by ``serve.native_serve.load_frontdoor``, which raises
    when it cannot be built or bound.

    Counting contract: the native fast path relays ONLY to a token's
    live primary owner, so its lookups and affinity hits are EQUAL by
    construction; the refresh thread folds their deltas into the
    wrapped front door's counters, and every slow-path token is
    counted by ``FrontDoor.verify_batch`` itself — the fleet-wide
    ``frontdoor.lookups == affinity_hits + affinity_misses`` invariant
    survives the split.

    Known undercount: per-POOL ``tokens`` / ``affinity_hits`` arm
    attribution only sees slow-path traffic (the native relay keeps
    per-pool in-flight gauges, not lifetime arm counters) — the
    fleet-level counters above are exact either way.
    """

    def __init__(self, frontdoor: FrontDoor, host: str = "127.0.0.1",
                 port: int = 0, *, obs_port: Optional[int] = None,
                 drain_wait_s: float = 0.1, refresh_s: float = 0.25,
                 max_frames: int = 64):
        import ctypes
        import socket as _socket

        import numpy as np

        from ..serve import native_serve as _ns

        if frontdoor._routing != "affinity":
            raise ValueError(
                "native relay requires routing='affinity' (rr is the "
                "Python control arm)")
        if len(frontdoor._arms) > _ns.FD_MAX_POOLS:
            raise ValueError(
                f"native relay supports at most {_ns.FD_MAX_POOLS} "
                f"pools, got {len(frontdoor._arms)}")
        lib = _ns.load_frontdoor()
        self._fd = frontdoor
        self._ns = _ns
        self._np = np
        self._lib = lib
        self._ct = ctypes
        self._u8p = ctypes.POINTER(ctypes.c_uint8)
        self._u64p = ctypes.POINTER(ctypes.c_uint64)
        self._i32p = ctypes.POINTER(ctypes.c_int32)
        self._i64p = ctypes.POINTER(ctypes.c_int64)
        self._drain_wait_s = float(drain_wait_s)
        self._refresh_s = float(refresh_s)
        self._max_frames = int(max_frames)
        self._closed = False
        self._stop_ev = threading.Event()
        self._ctr_lock = threading.Lock()
        self._last_lookups = 0
        self._last_hits = 0
        self._ep_sig: Optional[tuple] = None
        self._h = ctypes.c_void_p(lib.cap_frontdoor_create())
        try:
            self._push_config(force=True)
            for arm in frontdoor._arms:
                lib.cap_frontdoor_set_live(
                    self._h, arm.pool_id, 1 if arm.live() else 0)
            self._sock = _socket.socket(_socket.AF_INET,
                                        _socket.SOCK_STREAM)
            self._sock.setsockopt(_socket.SOL_SOCKET,
                                  _socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self._sock.listen(128)
            self._addr: Endpoint = self._sock.getsockname()
        except Exception:
            lib.cap_frontdoor_destroy(self._h)
            raise
        self._obs = None
        if obs_port is not None:
            from ..serve.obs import ObsServer

            self._obs = ObsServer(host=host, port=obs_port,
                                  extra=self._obs_gauges,
                                  snapshot_extra=self._obs_snapshot)
        self._threads = []
        for name, fn in (("cap-gpu-fd-accept", self._accept_loop),
                         ("cap-gpu-fd-drain", self._drain_loop),
                         ("cap-gpu-fd-refresh", self._refresh_loop)):
            th = threading.Thread(target=fn, daemon=True, name=name)
            th.start()
            self._threads.append(th)

    # -- VerifyWorker-compatible surface ----------------------------------

    @property
    def address(self) -> Endpoint:
        return self._addr

    @property
    def obs_address(self) -> Optional[Endpoint]:
        return self._obs.address if self._obs is not None else None

    @property
    def key_epoch(self) -> Optional[int]:
        return self._fd.key_epoch

    @property
    def serve_chain(self) -> str:
        return "native"

    @property
    def frontdoor_chain(self) -> str:
        return "native"

    @property
    def transport(self) -> str:
        return "socket"

    @property
    def frontdoor(self) -> FrontDoor:
        return self._fd

    def native_counters(self) -> Dict[str, int]:
        """Raw relay counters, exported as ``frontdoor.native.<slot>``
        (``seq_held_max`` is a high-water mark, not a monotone count)."""
        lib, h = self._lib, self._h
        return {f"frontdoor.native.{name}":
                int(lib.cap_frontdoor_counter(h, i))
                for i, name in enumerate(_FDC_NAMES)}

    def probe_route(self, digests: Sequence[bytes]) -> List[int]:
        """The parity pin: the exact owner decision the relay fast
        path would make per 16-byte digest (-1 = slow path)."""
        np = self._np
        if not digests:
            return []
        buf = np.frombuffer(
            b"".join(bytes(d[:16]).ljust(16, b"\x00")
                     for d in digests), np.uint8)
        out = np.zeros(len(digests), np.int32)
        self._lib.cap_frontdoor_probe_route(
            self._h, buf.ctypes.data_as(self._u8p), len(digests),
            out.ctypes.data_as(self._i32p))
        return [int(x) for x in out]

    def stats(self) -> dict:
        import os as _os

        rec = telemetry.active()
        obs = self.obs_address
        self._fold_native_counters()
        return {
            "pid": _os.getpid(),
            "key_epoch": self.key_epoch,
            "serve_chain": self.serve_chain,
            "frontdoor_chain": self.frontdoor_chain,
            "transport": self.transport,
            "obs_port": obs[1] if obs is not None else None,
            "counters": {**(rec.counters() if rec is not None else {}),
                         **self._fd.counters(),
                         **self.native_counters()},
            "series": rec.summary() if rec is not None else {},
            "snapshot": rec.snapshot() if rec is not None else {},
            "frontdoor": self._fd.snapshot(),
        }

    def close(self, deadline_s: float = 30.0) -> None:
        import socket as _socket

        self._closed = True
        self._stop_ev.set()
        if self._obs is not None:
            self._obs.close()
        # shutdown() is what actually WAKES an accept() blocked in the
        # accept thread (closing the fd from another thread leaves it
        # parked until a client happens to connect — close would then
        # burn its whole deadline in the join below).
        try:
            self._sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # The drain thread must be OUT of cap_frontdoor_drain before
        # the handle dies (destroy frees it); it exits on its next
        # empty poll once _closed is set.
        deadline = time.monotonic() + max(1.0, deadline_s)
        for th in self._threads:
            th.join(timeout=max(0.1, deadline - time.monotonic()))
        if not any(th.is_alive() for th in self._threads):
            self._lib.cap_frontdoor_destroy(self._h)
        # else: leak the handle rather than free it under a live
        # drain call — close is on the exit path either way.
        self._fd.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- config push-down -------------------------------------------------

    def _push_config(self, force: bool = False) -> None:
        """Stage ring points + per-pool endpoints and commit one
        immutable config snapshot. The ring is static for a front
        door's lifetime (membership is fixed at construction); the
        endpoint lists are not — the refresh thread re-commits when a
        pool's live endpoint set changes."""
        fd, lib, np = self._fd, self._lib, self._np
        sig = tuple(tuple(sorted(a.client._live_endpoints()))
                    for a in fd._arms)
        if not force and sig == self._ep_sig:
            return
        self._ep_sig = sig
        ring = fd._ring
        pts = np.asarray(ring._points, dtype=np.uint64)
        owners = np.asarray(ring._owners, dtype=np.int32)
        rc = lib.cap_frontdoor_stage_ring(
            self._h, pts.ctypes.data_as(self._u64p),
            owners.ctypes.data_as(self._i32p), len(pts))
        if rc:
            raise ValueError("ring owner id out of native range")
        for arm, eps in zip(fd._arms, sig):
            for ep_host, ep_port in eps:
                # (path, 0) is the UDS convention fleet-wide; the
                # native side takes port<0 as "host is a UDS path".
                lib.cap_frontdoor_stage_pool(
                    self._h, arm.pool_id, ep_host.encode(),
                    ep_port if ep_port > 0 else -1)
        lib.cap_frontdoor_commit(
            self._h, len(fd._arms),
            self._ct.c_double(fd._spill_factor))

    # -- observability ----------------------------------------------------

    def _obs_gauges(self) -> Dict[str, float]:
        lib, h, ns = self._lib, self._h, self._ns
        conns = int(lib.cap_frontdoor_counter(h, ns.FDC_CONNS)) \
            - int(lib.cap_frontdoor_counter(h, ns.FDC_CONNS_CLOSED))
        g = {"frontdoor.native.active": 1.0,
             "frontdoor.native.conns_live": float(conns),
             "frontdoor.native.seq_held_max": float(
                 lib.cap_frontdoor_counter(h, ns.FDC_SEQ_HELD_MAX))}
        for arm in self._fd._arms:
            g[f"frontdoor.pool.{arm.pool_id}.relay_inflight"] = float(
                lib.cap_frontdoor_inflight(h, arm.pool_id))
        return g

    def _obs_snapshot(self) -> Optional[dict]:
        self._fold_native_counters()
        return {"v": 1, "counters": self.native_counters(),
                "gauges": {}, "series": {}}

    def _fold_native_counters(self) -> None:
        """Fold native fast-path lookup/hit deltas into the wrapped
        front door's exact counters (relays go only to live primaries:
        the two deltas are equal, misses stay 0 for native traffic)."""
        lib, h, ns = self._lib, self._h, self._ns
        with self._ctr_lock:
            cur_l = int(lib.cap_frontdoor_counter(h, ns.FDC_LOOKUPS))
            cur_h = int(lib.cap_frontdoor_counter(h, ns.FDC_HITS))
            d_l, d_h = cur_l - self._last_lookups, \
                cur_h - self._last_hits
            self._last_lookups, self._last_hits = cur_l, cur_h
        if d_l or d_h:
            self._fd._count({"frontdoor.lookups": d_l,
                             "frontdoor.affinity_hits": d_h})

    # -- threads ----------------------------------------------------------

    def _accept_loop(self) -> None:
        import os as _os
        import socket as _socket

        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listen socket closed
            telemetry.count("worker.connections")
            try:
                conn.setsockopt(_socket.IPPROTO_TCP,
                                _socket.TCP_NODELAY, 1)
            except OSError:
                pass
            fd = conn.detach()
            if self._closed:        # raced close(): never touch the
                _os.close(fd)       # handle once destroy may run
                return
            cid = int(self._lib.cap_frontdoor_add_conn(self._h, fd))
            if cid < 0:
                _os.close(fd)

    def _refresh_loop(self) -> None:
        fd, lib = self._fd, self._lib
        while not self._stop_ev.wait(self._refresh_s):
            try:
                for arm in fd._arms:
                    lib.cap_frontdoor_set_live(
                        self._h, arm.pool_id, 1 if arm.live() else 0)
                self._push_config()
                self._fold_native_counters()
            except Exception:  # noqa: BLE001 - keep refreshing
                pass

    def _drain_loop(self) -> None:
        np, lib, ct = self._np, self._lib, self._ct
        mf = self._max_frames
        blob = np.zeros(1 << 20, np.uint8)
        frame_off = np.zeros(mf + 1, np.int64)
        meta = np.zeros(mf * 4, np.int32)
        seqs = np.zeros(mf, np.int64)
        need = np.zeros(1, np.int64)
        while True:
            n = int(lib.cap_frontdoor_drain(
                self._h, ct.c_double(self._drain_wait_s),
                blob.ctypes.data_as(self._u8p), blob.size,
                frame_off.ctypes.data_as(self._i64p),
                meta.ctypes.data_as(self._i32p),
                seqs.ctypes.data_as(self._i64p), mf,
                need.ctypes.data_as(self._i64p)))
            if n == -1:
                return
            if n == -2:     # grow-and-retry; the frame is carried
                blob = np.zeros(max(int(need[0]), blob.size * 2),
                                np.uint8)
                continue
            for k in range(n):
                raw = bytes(blob[int(frame_off[k]):
                                 int(frame_off[k + 1])])
                conn_id = int(meta[4 * k + 0])
                reason = int(meta[4 * k + 1])
                ftype = int(meta[4 * k + 2])
                ntok = int(meta[4 * k + 3])
                rname = _SLOW_REASONS.get(reason, f"r{reason}")
                self._fd._count(
                    {f"frontdoor.native.slow.{rname}": 1})
                try:
                    resp = self._handle_slow(raw, ftype, ntok)
                except Exception as e:  # noqa: BLE001 - must answer
                    resp = protocol.encode_response(
                        [e] * max(1, ntok),
                        crc=ftype == protocol.T_VERIFY_REQ_CRC)
                rb = np.frombuffer(resp, np.uint8)
                lib.cap_frontdoor_post_raw(
                    self._h, conn_id, int(seqs[k]),
                    rb.ctypes.data_as(self._u8p), len(resp))
            if n == 0 and self._closed:
                return

    # -- the slow path ----------------------------------------------------

    def _handle_slow(self, raw: bytes, ftype: int, ntok: int) -> bytes:
        """One drained frame → exactly one pre-encoded response frame.
        Every branch returns bytes (the caller's catch-all answers
        anything that raises) — a slow-path frame is NEVER dropped."""
        import json as _json

        P = protocol
        if ftype in (P.T_VERIFY_REQ, P.T_VERIFY_REQ_CRC,
                     P.T_VERIFY_REQ_TRACE):
            _ft, tokens, trace, _c = P.parse_frame_bytes(raw)
            try:
                with telemetry.span(telemetry.SPAN_FRONTDOOR_RELAY):
                    results = self._fd.verify_batch(tokens)
            except Exception as e:  # noqa: BLE001 - per-token errors
                results = [e] * len(tokens)
            return P.encode_response(
                results, crc=ftype == P.T_VERIFY_REQ_CRC, trace=trace)
        if ftype == P.T_STATS_REQ:
            return P.encode_stats_response(self.stats())
        if ftype == P.T_KEYS_PUSH:
            try:
                _ft, entries, _t, _c = P.parse_frame_bytes(raw)
                doc = _json.loads(entries[0])
                epoch = self._fd.swap_keys(doc["jwks"],
                                           epoch=doc.get("epoch"))
                return P.encode_keys_ack(epoch=epoch)
            except Exception as e:  # noqa: BLE001 - error ack
                return P.encode_keys_ack(
                    error=f"{type(e).__name__}: {e}")
        if ftype == P.T_PEER_FILL:
            return P.encode_peer_ack(
                error="TypeError: front-door relay keeps no verdict "
                      "cache (peer fill targets pool workers)")
        if ftype == P.T_SHM_ATTACH:
            return P.encode_shm_ack(
                error="shm transport is not offered at the front door")
        raise protocol.MalformedFrameError(
            f"unroutable slow-path frame type {ftype}")

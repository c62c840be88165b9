"""The verify worker: owns the card's engine, serves the wire protocol.

The port of ``cap_tpu.serve.worker``: host applications connect over
TCP (or a Unix socket) and stream verify requests; all connections
share ONE AdaptiveBatcher → ONE GPUBatchKeySet → one card, so
concurrent small callers coalesce into full device batches. Two serve
chains speak the same CVB1 bytes:

- the Python chain (default): a reader and a responder thread a
  connection, so a client may pipeline requests; responses return in
  request order;
- the native chain (``serve_native=True``,
  :mod:`cap_tpu_torch.serve.native_serve`): C++ reader and writer
  threads own the TCP fds and feed a lock-free ring; Python drains
  whole chunks into the batcher. It serves TCP only:
  ``serve_native=True`` with ``uds_path`` raises ``ValueError`` (the
  JAX worker quietly runs its Python chain there), and a failed build
  or load of the native library raises too.

``transport="shm"`` honours per-connection shared-memory attach
negotiations (CVB1 type 15, :mod:`cap_tpu_torch.serve.shm_ring`) on
either chain; ``"socket"`` acks them status 1 and the connection keeps
serving over the socket.

Where the JAX package's worker reads its environment
(``CAP_SERVE_TRANSPORT``, ``CAP_SERVE_DEDUP``, ``CAP_SERVE_VCACHE``,
``CAP_SERVE_VCACHE_CAP``, ``CAP_SERVE_NATIVE``, ``CAP_SERVE_NATIVE_OBS``,
``CAP_SERVE_FAIR``, ``CAP_SERVE_ADMIT_*``), this one takes arguments
with the same defaults. ``obs_port`` (0: an ephemeral port) starts the
HTTP observability server (:mod:`cap_tpu_torch.serve.obs`: ``/metrics``,
``/snapshot``, ``/flight``, ``/decisions``, ``/tenants``, ``/healthz``)
on either chain.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Optional, Tuple

from .. import telemetry
from ..obs import decision as _decision
from ..obs import occupancy as _occupancy
from . import admission as _admission
from . import drr as _drr
from . import protocol
from . import shm_ring as _shm
from . import vcache as _vcache
from .batcher import AdaptiveBatcher

# shared pre-set event for all-cache-hit submissions (nothing to wait on)
_DONE_EVENT = threading.Event()
_DONE_EVENT.set()


class _CachePending:
    """A pending-shaped handle over a cache-consulted submission.

    Mirrors the ``_Pending`` surface the responder loop reads
    (``tokens`` / ``ts`` / ``event`` / ``results``): all-hit requests
    carry their verdicts immediately (event pre-set, no batcher
    round-trip); partial hits wait on the underlying miss submission
    and merge lazily at respond time, filling the cache with the fresh
    verdicts as a side effect."""

    __slots__ = ("tokens", "ts", "event", "_hits", "_miss_idx",
                 "_inner", "_fill", "_results")

    def __init__(self, tokens, hits, miss_idx, inner, fill):
        self.tokens = tokens
        self.ts = time.monotonic()
        self._hits = hits
        self._miss_idx = miss_idx
        self._inner = inner
        self._fill = fill
        self._results = None
        self.event = inner.event if inner is not None else _DONE_EVENT

    @property
    def results(self):
        if self._results is None:
            out = self._hits
            if self._inner is not None:
                fresh = self._inner.results
                for j, i in enumerate(self._miss_idx):
                    out[i] = fresh[j]
                if self._fill is not None:
                    self._fill(self._miss_idx, fresh)
            self._results = out
        return self._results


class _RawClaimsSync:
    """Route the batcher at a keyset's SYNC raw-claims entry point
    (rotation-aware keysets like GPURemoteKeySet: no async dispatch,
    the batcher falls back to its sync path)."""

    def __init__(self, keyset):
        self._keyset = keyset

    def verify_batch(self, tokens):
        return self._keyset.verify_batch_raw(tokens)


class _RawClaims(_RawClaimsSync):
    """Raw entry points including async dispatch (GPUBatchKeySet)."""

    def verify_batch_async(self, tokens):
        return self._keyset.verify_batch_async_raw(tokens)


class VerifyWorker:
    """Serve ``keyset.verify_batch`` over the CVB1 protocol.

    keyset: typically a GPUBatchKeySet; anything with verify_batch.
    host/port: TCP bind (port 0 → ephemeral, see ``address``);
    uds_path: serve on a Unix socket instead of TCP.
    raw_claims: route the batcher through the keyset's raw entry
    points (payload bytes, no claims dicts) where it has them.
    vcache / vcache_capacity: the verdict cache (on, 65,536 entries);
    it caches no accept while an engine's ``in_grace`` holds.
    dedup: the batcher's in-flight dedup (None: on with the cache).
    fair / admit_rate / admit_burst / drr_quantum / drr_weights: DRR
    fair scheduling and per-tenant admission (off by default).
    keys_grace_s: the grace window a KEYS push gives the old epoch's
    kids (None: the engine's default).
    serve_native: the native C++ chain (TCP only; with ``uds_path`` it
    raises ValueError). native_obs: its native telemetry plane, on
    while telemetry is on (False: the Python decision fold).
    transport: "socket", or "shm" to honour shared-memory attaches.
    obs_port: the HTTP observability server (None: off; 0: ephemeral).
    """

    def __init__(self, keyset, host: str = "127.0.0.1", port: int = 0,
                 uds_path: Optional[str] = None,
                 target_batch: int = 4096, max_wait_ms: float = 2.0,
                 max_batch: int = 32768, raw_claims: bool = True,
                 obs_port: Optional[int] = None,
                 serve_native: bool = False,
                 vcache: bool = True,
                 vcache_capacity: int = 65536,
                 transport: str = "socket",
                 fair: bool = False,
                 admit_rate: Optional[float] = None,
                 admit_burst: Optional[float] = None,
                 dedup: Optional[bool] = None,
                 drr_quantum: Optional[int] = None,
                 drr_weights: Optional[dict] = None,
                 keys_grace_s: Optional[float] = None,
                 native_obs: bool = True):
        if transport not in ("socket", "shm"):
            raise ValueError(f"unknown transport {transport!r}")
        if serve_native and uds_path is not None:
            raise ValueError("the native serve chain serves TCP only: "
                             "serve_native=True takes no uds_path")
        self._shm_enabled = transport == "shm"
        # The unwrapped engine: keyplane operations (KEYS pushes,
        # epoch reporting) address it directly, whatever raw-claims
        # wrapper the batcher ends up routed through.
        self._engine = keyset
        self._keys_grace_s = keys_grace_s
        # Raw-claims passthrough: the response payload for a verified
        # token IS its claims JSON, and the signed payload bytes are
        # exactly that. Keysets without the raw entry (stubs, plain
        # KeySets) keep the dict path; the wire format is identical.
        if raw_claims and hasattr(keyset, "verify_batch_async_raw"):
            keyset = _RawClaims(keyset)
        elif raw_claims and hasattr(keyset, "verify_batch_raw"):
            keyset = _RawClaimsSync(keyset)
        self._adm_cfg = _admission.AdmissionConfig(
            fair=fair, rate=admit_rate, burst=admit_burst,
            quantum=drr_quantum, weights=drr_weights)
        self._admission: Optional[_admission.AdmissionController] = None
        self._batcher = AdaptiveBatcher(
            keyset, target_batch=target_batch, max_wait_ms=max_wait_ms,
            max_batch=max_batch,
            dedup=bool(vcache) if dedup is None else dedup,
            fair=self._adm_cfg.fair,
            drr_quantum=self._adm_cfg.quantum)
        if self._adm_cfg.fair and self._adm_cfg.weights:
            for label, w in self._adm_cfg.weights.items():
                slot = (_drr.SCHED_BE if label == "be"
                        else _drr.sched_slot_for_label(label))
                self._batcher.set_weight(slot, w)
        # Verdict cache: consulted BEFORE the batcher; epoch-invalidated
        # by KEYS pushes (apply_keys below), exp/nbf-clamped per entry.
        self._vcache: Optional[_vcache.VerdictCache] = None
        if vcache:
            self._vcache = _vcache.VerdictCache(
                capacity=vcache_capacity or 65536)
            self._vcache.set_epoch(getattr(self._engine, "key_epoch",
                                           None))
        # The native chain: C++ frame I/O and a lock-free ring over the
        # same batcher, cache and control handlers.
        self._native = None
        if serve_native:
            from .native_serve import NativeServeChain

            self._native = NativeServeChain(
                self._batcher, stats_fn=self.stats,
                keys_fn=self.apply_keys, peer_fill_fn=self.peer_fill,
                max_batch=max_batch, vcache=self._vcache,
                shm=self._shm_enabled, admission=self._adm_cfg,
                native_obs=native_obs, grace_fn=self._in_grace)
        elif self._adm_cfg.admission_on:
            # the reader thread polices at dispatch time
            self._admission = _admission.AdmissionController(
                self._adm_cfg.rate, self._adm_cfg.burst)
        self._uds_path = uds_path
        if uds_path is not None:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                os.unlink(uds_path)        # stale socket from a restart
            except FileNotFoundError:
                pass
            self._sock.bind(uds_path)
            self._addr: Tuple[str, int] = (uds_path, 0)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self._addr = self._sock.getsockname()
        self._sock.listen(128)
        self._closed = False
        # Observability surface (obs_port=None → off, 0 → ephemeral):
        # Prometheus /metrics + mergeable /snapshot + /flight recorder
        # (serve.obs). Extras are live batcher depth — present in every
        # scrape even when the telemetry recorder is off.
        self._obs = None
        if obs_port is not None:
            from .obs import ObsServer

            self._obs = ObsServer(
                host=host if uds_path is None else "127.0.0.1",
                port=obs_port, extra=self._obs_gauges,
                snapshot_extra=self._native_obs_snapshot)
        # live connections (the STATS and gauge surface)
        self._conns_live = 0
        self._conns_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="cap-gpu-accept")
        self._accept_thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        """(host, port) for TCP, (path, 0) for UDS."""
        return self._addr

    @property
    def obs_address(self) -> Optional[Tuple[str, int]]:
        """(host, port) of the HTTP observability server, if enabled."""
        return self._obs.address if self._obs is not None else None

    @property
    def key_epoch(self):
        """The engine's key-table epoch (None: not epoch-versioned)."""
        return getattr(self._engine, "key_epoch", None)

    @property
    def serve_chain(self) -> str:
        """Which serve chain this worker runs: "native" (C++ frame I/O
        + lock-free ring) or "python" (reader/responder threads)."""
        return "native" if self._native is not None else "python"

    @property
    def transport(self) -> str:
        """The transport capability live: "shm" when this worker
        honours shared-memory attach negotiations, else "socket"."""
        return "shm" if self._shm_enabled else "socket"

    def _in_grace(self) -> bool:
        return bool(getattr(self._engine, "in_grace", False))

    def apply_keys(self, jwks_doc: dict, epoch) -> int:
        """Apply one keyplane KEYS push; returns the installed epoch.

        Raises when the engine is not swap-capable or the document is
        unusable — the caller acks with the error, never half-applies.
        """
        swap = getattr(self._engine, "swap_keys", None)
        if swap is None:
            raise TypeError(
                f"{type(self._engine).__name__} does not support hot "
                "key rotation")
        if self._keys_grace_s is None:
            got = swap(jwks_doc, epoch=epoch)
        else:
            got = swap(jwks_doc, epoch=epoch, grace_s=self._keys_grace_s)
        if self._vcache is not None:
            # Atomic cache invalidation rides the SAME push that swaps
            # the tables: cached verdicts from the previous epoch die
            # immediately (grace 0 — the ENGINE's grace window covers
            # retired-kid re-verifies; the cache never extends it), and
            # no accept verified inside that window is cached
            # (_cached_submit), so a cached accept cannot outlive a
            # rotated key.
            self._vcache.bump_epoch(got)
        telemetry.count("worker.keys_pushes")
        telemetry.gauge("keyplane.epoch", got)
        return got

    def peer_fill(self, doc: dict) -> dict:
        """Handle one peer-fill op (CVB1 type 13; see
        :mod:`cap_tpu_torch.serve.vcache` for the clamp contract).

        ``op=export`` dumps a bounded slice of this worker's verdict
        cache; ``op=import`` installs a sibling's dump into it;
        ``op=admission`` (rides the same control pair, no new
        frame type) retunes the admission plane: per-tenant shed
        scales and/or a new rate/burst, pushed by the pool's
        SLO-burn autoscaler. Raises when this worker cannot serve the
        op or the document is unusable — the caller acks with the
        error, nothing is half-applied."""
        op = doc.get("op")
        if op == "admission":
            return self.apply_admission(doc)
        if self._vcache is None:
            raise TypeError("worker has no verdict-cache tier "
                            "(vcache off)")
        if op == "export":
            max_n = int(doc.get("max") or 2048)
            entries, epoch = self._vcache.export_entries(
                max_entries=max_n)
            telemetry.count("worker.peer_exports")
            return {"entries": entries, "epoch": epoch}
        if op == "import":
            # a sibling's accepts may rest on kids a push dropped here:
            # none is taken while they still resolve
            entries = [] if self._in_grace() \
                else doc.get("entries") or []
            n = self._vcache.import_entries(entries, epoch=doc.get("epoch"))
            telemetry.count("worker.peer_imports")
            return {"imported": n}
        raise ValueError(f"unknown peer-fill op {op!r}")

    def apply_admission(self, doc: dict) -> dict:
        """Apply one admission-control op (``op=admission`` on the
        CVB1 type-13/14 pair): ``scale`` maps tenant hashes to rate
        scales (< 1.0 sheds, 1.0 restores); ``rate``/``burst`` retune
        the buckets wholesale. Raises when this worker has no
        admission plane armed."""
        native = self._native
        if self._admission is None and (native is None
                                        or not native.adm_native):
            raise TypeError("worker has no admission plane armed "
                            "(admit_rate unset)")
        applied = 0
        rate = doc.get("rate")
        burst = doc.get("burst")
        if rate is not None:
            rate = float(rate)
            burst = float(burst) if burst is not None \
                else max(1.0, 2.0 * rate)
            if native is not None:
                native._lib.cap_serve_set_admission(
                    native._h, 1, rate, burst)
            if self._admission is not None:
                self._admission.rate = max(0.0, rate)
                self._admission.burst = burst
            self._adm_cfg.rate = max(0.0, rate)
            self._adm_cfg.burst = burst
            applied += 1
        for label, s in (doc.get("scale") or {}).items():
            label = str(label)
            s = float(s)
            if native is not None:
                native.set_tenant_scale(label, s)
            if self._admission is not None:
                self._admission.set_scale(label, s)
            telemetry.count("admission.sheds" if s < 1.0
                            else "admission.unsheds")
            applied += 1
        telemetry.count("worker.admission_ops")
        return {"applied": applied, "shed": self.shed_state()}

    def shed_state(self) -> dict:
        """Currently shed tenants (label → rate scale), whichever
        enforcement point holds them."""
        if self._native is not None:
            return self._native.shed_state
        if self._admission is not None:
            return dict(self._admission.shed)
        return {}

    def _obs_gauges(self) -> dict:
        # flush the occupancy plane's counter deltas + window gauges
        # into the recorder so this scrape sees device.occupancy fresh
        _occupancy.publish()
        d = self._batcher.depth()
        out = {"batcher.queued_tokens": d["queued_tokens"],
               "batcher.inflight_batches": d["inflight_batches"],
               "worker.pid": os.getpid(),
               # 1.0 when the native chain serves this worker — the
               # numeric form capstat renders as chain=native
               "serve.native.active": 1.0 if self._native else 0.0,
               # 1.0 when shm attach negotiation is live — capstat
               # renders it as tr=shm
               "serve.shm.active": 1.0 if self.transport == "shm"
               else 0.0}
        if self._native is not None:
            out["serve.native.ring_depth"] = float(
                self._native.ring_depth())
            # burst-visible peak depth since the LAST scrape (the
            # native side tracks the max at push time; reading it here
            # rearms the mark — gauge-reset-on-scrape)
            out["serve.native.ring_hwm"] = float(
                self._native.ring_hwm(reset=True))
            out["serve.native.obs_plane"] = (
                1.0 if self._native.obs_plane is not None else 0.0)
        # connection plane: live conns, whichever chain accepts
        if self._native is not None:
            nc = self._native.counters()
            out["serve.conns_live"] = float(
                nc.get("serve.native.connections", 0)
                - nc.get("serve.native.connections_closed", 0))
        else:
            out["serve.conns_live"] = float(self._conns_live)
        epoch = self.key_epoch
        if epoch is not None:
            out["keyplane.epoch"] = float(epoch)
        if self._vcache is not None:
            out["vcache.size"] = float(self._vcache.size())
        # admission & fairness state (capstat's tenant-ledger columns)
        out["serve.fair.active"] = 1.0 if self._adm_cfg.fair else 0.0
        adm_on = (self._admission is not None
                  or (self._native is not None and self._native.adm_native))
        out["admission.active"] = 1.0 if adm_on else 0.0
        if adm_on:
            out["admission.rate"] = float(self._adm_cfg.rate)
            out["admission.burst"] = float(self._adm_cfg.burst)
            for label, s in self.shed_state().items():
                out[f"admission.tenant.{label}.shed_scale"] = float(s)
            # per-tenant bucket fill + DRR weight for the capstat
            # ledger's admission columns (bounded: the tenant table
            # caps at 64 slots + none/other)
            weights = self._adm_cfg.weights
            for slot, label in sorted(
                    _decision.TENANTS.labels().items()):
                fill = None
                if self._native is not None:
                    fill = self._native.admission_fill(label)
                elif self._admission is not None:
                    fill = self._admission.fill(label)
                if fill is not None:
                    out[f"admission.tenant.{label}.fill"] = \
                        round(float(fill), 3)
                w = weights.get(label)
                if w is not None:
                    out[f"admission.tenant.{label}.weight"] = float(w)
        return out

    def _native_obs_snapshot(self):
        """The native side's mergeable snapshot (None on the python
        chain): the serve chain's own counters plus — when the
        telemetry plane is on — its decision counters and histogram
        series; the exemplar pump runs first so the decision ring is
        fresh."""
        native = self._native
        if native is None:
            return None
        snap = {"v": 1, "counters": dict(native.counters()),
                "gauges": {}, "series": {}}
        plane = native.obs_plane
        if plane is not None:
            plane.pump()
            snap = telemetry.merge_snapshots([snap, plane.snapshot()])
        return snap

    def stats(self) -> dict:
        """Process-local load/health snapshot (the STATS op payload).

        Counts and timings only — never tokens, keys, or claims. The
        telemetry recorder may be off (empty dicts then); queue depth
        and inflight come straight from the batcher either way. The
        keys are the JAX worker's.
        """
        rec = telemetry.active()
        obs = self.obs_address
        # occupancy counters flush into the recorder BEFORE the
        # snapshot below, so STATS carries them
        _occupancy.publish(rec)
        native_counters = (self._native.counters()
                           if self._native is not None else {})
        # The native telemetry plane's counters (decision.serve.*) and
        # series live in the C region, not the recorder: merged here so
        # STATS shows one worker, whichever side counted.
        plane_snap = self._native_obs_snapshot()
        snap = rec.snapshot() if rec is not None else {}
        series = rec.summary() if rec is not None else {}
        if plane_snap is not None:
            snap = telemetry.merge_snapshots([snap, plane_snap])
            series = {**series, **telemetry.summarize_snapshot(
                {"series": plane_snap.get("series") or {}})}
        return {
            "pid": os.getpid(),
            **self._batcher.stats(),
            "key_epoch": self.key_epoch,
            "serve_chain": self.serve_chain,
            "transport": self.transport,
            **({"ring_depth": self._native.ring_depth()}
               if self._native is not None else {}),
            "obs_port": obs[1] if obs is not None else None,
            "counters": {**(rec.counters() if rec is not None else {}),
                         **native_counters,
                         **((plane_snap.get("counters") or {})
                            if plane_snap is not None else {})},
            "series": series,
            # Mergeable form: bucket counts add across workers for
            # exact quantiles.
            "snapshot": snap,
        }

    def close(self, deadline_s: float = 120.0) -> None:
        """Stop accepting, then drain: every batch already queued or in
        flight is verified and answered (within ``deadline_s``)."""
        self._closed = True
        if self._obs is not None:
            self._obs.close()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._uds_path is not None:
            try:
                os.unlink(self._uds_path)
            except OSError:
                pass
        if self._native is not None:
            # Graceful-drain order: flush the ring into the batcher,
            # let the batcher finish (its close waits for in-flight
            # dispatches, whose on_done posts write the responses),
            # give the native writers a beat, then sever connections.
            self._native.stop_drain(deadline_s=min(10.0, deadline_s))
        self._batcher.close(deadline_s=deadline_s)
        if self._native is not None:
            time.sleep(0.2)
            self._native.destroy()

    # -- internals --------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed
            telemetry.count("worker.connections")
            if self._native is not None:
                # Native chain: the fd moves to C++ reader/writer
                # threads; Python never sees this connection's frames.
                try:
                    conn.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                except OSError:
                    pass
                self._native.add_conn(conn)
                continue
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="cap-gpu-conn").start()

    # Outstanding frames per connection before the reader stops reading
    # (backpressure then propagates to the client through TCP). Bounds
    # the memory a frame-spamming client can pin.
    _MAX_INFLIGHT = 64

    def _serve_conn(self, conn: socket.socket) -> None:
        import queue as q

        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # UDS
        # Reader/responder split: this thread KEEPS READING frames while
        # earlier submissions verify, so a client may pipeline several
        # requests on one connection; responses return strictly in
        # request order (CVB1 has no request ids — order IS the
        # correlation).
        respq: "q.Queue" = q.Queue(maxsize=self._MAX_INFLIGHT)
        responder = threading.Thread(
            target=self._respond_loop, args=(conn, respq),
            daemon=True, name="cap-gpu-respond")
        responder.start()
        # This thread owns the connection's read side exclusively, so
        # the buffered FrameReader is safe.
        reader = protocol.FrameReader(conn)
        with self._conns_lock:
            self._conns_live += 1
            live = self._conns_live
        telemetry.gauge("serve.conns_live", float(live))
        tenant_counted = False
        try:
            while True:
                try:
                    t_recv = time.time()
                    ftype, entries, trace = reader.recv_frame_ex()
                except (ConnectionError, OSError):
                    return
                except (protocol.ProtocolError, UnicodeDecodeError):
                    # Malformed frame (attacker-spammable): drop the
                    # connection quietly.
                    telemetry.count("worker.protocol_errors")
                    return
                if ftype == protocol.T_SHM_ATTACH:
                    # Transport negotiation: map the client's region
                    # and swap this connection's frame source to its
                    # request ring (responses follow through the
                    # responder's sink switch). Anything unsupported
                    # acks status 1 and the SOCKET keeps serving.
                    shm_state = self._shm_attach(entries, respq)
                    if shm_state is None:
                        continue
                    region, consumer = shm_state
                    self._serve_shm_conn(conn, respq, region, consumer)
                    return
                if (not tenant_counted and entries
                        and ftype in (protocol.T_VERIFY_REQ,
                                      protocol.T_VERIFY_REQ_CRC,
                                      protocol.T_VERIFY_REQ_TRACE)
                        and telemetry.active() is not None):
                    # attribute the connection to its first verify
                    # frame's tenant, once
                    tenant_counted = True
                    label = _decision.tenant_labels(entries[:1])[0]
                    telemetry.count(f"serve.tenant.{label}.conns")
                if not self._dispatch_frame(ftype, entries, trace,
                                            respq, t_recv):
                    return  # protocol violation → drop the connection
        finally:
            with self._conns_lock:
                self._conns_live -= 1
                live = self._conns_live
            telemetry.gauge("serve.conns_live", float(live))
            if reader.hwm:
                telemetry.observe("serve.conn_buffered_hwm_b",
                                  float(reader.hwm))
            respq.put(None)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch_frame(self, ftype, entries, trace, respq,
                        t_recv) -> bool:
        """Handle one parsed frame (both transports feed this): queue
        the response kind in order; False = protocol violation."""
        if ftype == protocol.T_PING:
            respq.put(("pong", None, None))
            return True
        if ftype == protocol.T_STATS_REQ:
            respq.put(("stats", None, None))
            return True
        if ftype == protocol.T_KEYS_PUSH:
            # Applied HERE, in the reader thread (the pool pushes on a
            # dedicated connection): the table build blocks only this
            # connection, and by frame order every verify request read
            # AFTER the push dispatches on the new epoch. The ack
            # rides the responder queue so in-order delivery holds.
            import json as _json

            try:
                doc = _json.loads(entries[0])
                got = self.apply_keys(doc.get("jwks") or {},
                                      doc.get("epoch"))
                respq.put(("keys_ack", got, None))
            except Exception as e:  # noqa: BLE001 - acked
                telemetry.count("worker.keys_push_errors")
                respq.put(("keys_err",
                           f"{type(e).__name__}: {e}", None))
            return True
        if ftype == protocol.T_PEER_FILL:
            # Same in-order stance as KEYS pushes: applied in the
            # reader thread, acked through the responder queue — a
            # verify read after an import sees the warmed cache.
            import json as _json

            try:
                doc = self.peer_fill(_json.loads(entries[0]))
                respq.put(("peer_ack", doc, None))
            except Exception as e:  # noqa: BLE001 - acked
                telemetry.count("worker.peer_fill_errors")
                respq.put(("peer_err",
                           f"{type(e).__name__}: {e}", None))
            return True
        if ftype not in (protocol.T_VERIFY_REQ,
                         protocol.T_VERIFY_REQ_CRC,
                         protocol.T_VERIFY_REQ_TRACE):
            return False
        telemetry.count("worker.requests")
        telemetry.count("worker.tokens", len(entries))
        # A checksummed request gets a checksummed response, a traced
        # one a traced response echoing its trace id — the fleet
        # router's end-to-end integrity envelope.
        if ftype == protocol.T_VERIFY_REQ_TRACE:
            pending = self._admitted_submit(entries, trace=trace)
            telemetry.trace_span(
                trace, telemetry.SPAN_WORKER_DEQUEUE, t_recv,
                time.time() - t_recv)
            respq.put(("batch_trace", pending, trace))
            return True
        crc = ftype == protocol.T_VERIFY_REQ_CRC
        respq.put(("batch_crc" if crc else "batch",
                   self._admitted_submit(entries), None))
        return True

    def _shm_attach(self, entries, respq):
        """Negotiate one shm attach: returns (region, consumer) on
        success (ack queued), None on a status-1 refusal (socket keeps
        serving)."""
        import json as _json

        with telemetry.span(telemetry.SPAN_SHM_ATTACH):
            try:
                if not self._shm_enabled:
                    raise TypeError("worker has no shm transport "
                                    "(transport=socket)")
                doc = _json.loads(entries[0])
                if doc.get("op") != "attach" \
                        or doc.get("version") != 1:
                    raise ValueError(
                        f"unsupported attach op/version: "
                        f"{doc.get('op')!r}/{doc.get('version')!r}")
                region = _shm.ShmRegion.open(str(doc.get("path")))
            except Exception as e:  # noqa: BLE001 - acked, never fatal
                telemetry.count("serve.shm_fallbacks")
                respq.put(("shm_err",
                           f"{type(e).__name__}: {e}", None))
                return None
            telemetry.count("serve.shm.attaches")
            # short write timeout: a client killed mid-read stops
            # consuming the response ring; the responder must give up
            # and discard, not wedge for the default 30 s per frame
            producer = _shm.RingProducer(region, "resp", timeout=5.0)
            consumer = _shm.RingConsumer(region, "req")
            # the ack rides the SOCKET; every later response rides the
            # ring (the responder switches sinks on this marker)
            respq.put(("shm_ack", producer, None))
            return region, consumer

    def _serve_shm_conn(self, conn, respq, region, consumer) -> None:
        """Serve one attached connection from its request ring; the
        socket is polled as the liveness channel only. A poisoned ring
        (overrun / stale generation / malformed frame) detaches, the
        worker survives — the shm analog of dropping a bad socket."""
        import select

        try:
            while True:
                try:
                    rec = consumer.read(timeout=0.05)
                except _shm.StaleGenerationError:
                    telemetry.count("serve.shm.stale_gen")
                    telemetry.count("worker.protocol_errors")
                    return
                except (protocol.ProtocolError, ValueError):
                    telemetry.count("worker.protocol_errors")
                    return
                if rec is None:
                    if self._closed:
                        return
                    try:
                        readable, _, _ = select.select([conn], [], [], 0)
                        if readable:
                            if conn.recv(4096) == b"":
                                return       # EOF: client gone
                            # bytes on the socket after the attach:
                            # protocol violation
                            telemetry.count("worker.protocol_errors")
                            return
                    except (OSError, ValueError):
                        return
                    continue
                t_recv = time.time()
                try:
                    ftype, entries, trace, used = \
                        protocol.parse_frame_bytes(rec)
                    if used != len(rec):
                        raise protocol.MalformedFrameError(
                            "shm record carries trailing bytes")
                except (protocol.ProtocolError, UnicodeDecodeError,
                        ConnectionError):
                    telemetry.count("worker.protocol_errors")
                    return
                telemetry.count("serve.shm.frames")
                if not self._dispatch_frame(ftype, entries, trace,
                                            respq, t_recv):
                    return
        finally:
            telemetry.count("serve.shm.detaches")
            # the worker is the reliable janitor: unlink reclaims the
            # file even after the client died to kill -9 (its own
            # mapping dies with it); the responder may still hold the
            # mmap through its producer — the mapping stays valid
            try:
                os.unlink(region.path)
            except OSError:
                pass

    def _admitted_submit(self, entries, trace: Optional[str] = None):
        """Token-bucket admission in front of the cache/batcher (the
        python chain's enforcement point). Throttled tokens get a ThrottledError
        with the retry-after pushback hint and are NEVER verified; the
        responder's decision fold counts them under reason
        ``throttled`` per tenant like any other reject."""
        adm = self._admission
        if adm is None:
            return self._cached_submit(entries, trace=trace)
        mask, retry_ms = adm.check_tokens(entries)
        if mask is None:
            return self._cached_submit(entries, trace=trace)
        hits = [(_admission.throttled_error(retry_ms) if m else None)
                for m in mask]
        admit_idx = [i for i, m in enumerate(mask) if not m]
        if not admit_idx:
            return _CachePending(list(entries), hits, (), None, None)
        inner = self._cached_submit([entries[i] for i in admit_idx],
                                    trace=trace)
        return _CachePending(list(entries), hits, admit_idx, inner,
                             None)

    def _cached_submit(self, entries, trace: Optional[str] = None):
        """Consult the verdict cache, then submit only the misses.

        All-hit requests never touch the batcher (answered at memory
        speed); partial hits submit the miss subset and merge at
        respond time. Returns a pending-shaped handle either way."""
        vc = self._vcache
        if vc is None:
            return self._batcher.submit_nowait(entries, trace=trace)
        hits, miss_idx, digests = vc.lookup_batch(entries)
        if telemetry.active() is not None:
            # per-tenant cache accounting (header-segment cached —
            # one dict hit per token)
            _decision.count_tenant_cache(
                _decision.tenant_labels(entries), miss_idx)
        if not miss_idx:
            return _CachePending(list(entries), hits, (), None, None)
        epoch0 = vc.epoch
        # read after the epoch: a push that bumped it had already
        # installed its graced tables
        graced = self._in_grace()

        def fill(idxs, fresh):
            if graced:
                # an accept verified while a push's dropped kids still
                # resolve may rest on one of them: left uncached, so no
                # cached accept outlives the grace
                keep = [j for j, v in enumerate(fresh)
                        if isinstance(v, BaseException)]
                idxs = [idxs[j] for j in keep]
                fresh = [fresh[j] for j in keep]
            vc.insert_batch([digests[i] for i in idxs], fresh,
                            tokens=[entries[i] for i in idxs],
                            epoch=epoch0)

        inner = self._batcher.submit_nowait(
            [entries[i] for i in miss_idx], trace=trace,
            digests=[digests[i] for i in miss_idx])
        return _CachePending(list(entries), hits, miss_idx, inner, fill)

    def _respond_loop(self, conn: socket.socket, respq) -> None:
        broken = False
        # Responses go to `sink`: the socket, until an shm attach
        # swaps in the region's response-ring producer (which
        # duck-types sendall — every protocol.send_* call emits one
        # complete frame in one sendall). The attach ACK itself still
        # rides the socket, so the client confirms the switch before
        # it starts reading the ring.
        sink = conn
        while True:
            item = respq.get()
            if item is None:
                return
            if broken:
                continue              # discard; reader is winding down
            kind, pending, trace = item
            try:
                if kind == "pong":
                    protocol.send_pong(sink)
                elif kind == "shm_ack":
                    protocol.send_shm_ack(conn)
                    sink = pending    # the RingProducer
                elif kind == "shm_err":
                    protocol.send_shm_ack(conn, error=pending)
                elif kind == "keys_ack":
                    protocol.send_keys_ack(sink, epoch=pending)
                elif kind == "keys_err":
                    protocol.send_keys_ack(sink, error=pending)
                elif kind == "peer_ack":
                    protocol.send_peer_ack(sink, doc=pending)
                elif kind == "peer_err":
                    protocol.send_peer_ack(sink, error=pending)
                elif kind == "stats":
                    # Snapshot at RESPOND time (in-order with verifies
                    # on this connection, so a stats probe sent after a
                    # batch reflects that batch's accounting).
                    protocol.send_stats_response(sink, self.stats())
                else:
                    pending.event.wait()
                    # Serve-surface decision records: every verdict that
                    # leaves this worker is accounted by reason class,
                    # with the request's submit→respond latency bucket.
                    latency_s = time.monotonic() - pending.ts
                    # the stage-waterfall denominator: the occupancy
                    # plane's queue.* + device.exec_s histograms must
                    # sum to this within tolerance (docs/OBSERVABILITY
                    # §Occupancy plane, pinned by test)
                    telemetry.observe("serve.request_s", latency_s)
                    _decision.record_batch(
                        "serve", pending.results, tokens=pending.tokens,
                        latency_s=latency_s,
                        trace=trace)
                    protocol.send_response(sink, pending.results,
                                           crc=kind == "batch_crc",
                                           trace=trace)
            except (ConnectionError, OSError, TimeoutError,
                    protocol.ProtocolError):
                # Connection broke mid-response (socket) or the peer
                # stopped consuming the response ring (shm): close the
                # socket so the reader unblocks, then keep DRAINING
                # until the reader's final None — exiting early would
                # leave the reader wedged in a full-queue put().
                broken = True
                try:
                    conn.close()
                except OSError:
                    pass

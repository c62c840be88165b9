"""The fleet pool manager: spawn, place, supervise, respawn.

The port of ``cap_tpu.fleet.pool``. ``WorkerPool`` owns N
``python -m cap_tpu_torch.fleet.worker_main`` subprocesses under an
explicit single-owner-per-device placement (``parallel.place``): every
worker's card group is carried as its ``CUDA_VISIBLE_DEVICES`` (the one
variable the pool sets) and its ``--device``, so two workers can never
share a card, and a CPU worker (``CUDA_VISIBLE_DEVICES=""``, ``--device
cpu``) cannot touch one. A pool may mix them: one worker owning the
card, the rest on the CPU.

Supervision model (the host-side dispatcher shape of the FPGA/GPU
batch-verification engines — arXiv:2112.02229, arXiv:2211.12265):

- a supervisor thread polls each child (``Popen.poll``) and pings its
  serve socket on a fresh connection every ``ping_interval``;
- a dead child (crash, kill -9) or one that misses ``hung_after``
  consecutive pings is respawned onto the SAME device group — the old
  process is made fully dead first (SIGTERM → grace → SIGKILL), so
  device ownership transfers without ever being shared;
- respawns are capped (``max_restarts``) to bound a crash storm; a
  worker past the cap is marked ``failed`` and its devices idle.

The pool never touches tokens — it moves processes and reads health.
Routing lives in :mod:`cap_tpu_torch.fleet.router`, which consumes
``endpoints()`` (live addresses, re-polled per attempt round).

Where the JAX pool passes knobs to its workers as environment
(``CAP_FLEET_PM_PATH``, ``CAP_FLEET_PM_INTERVAL``, ``env_extra``), this
one passes ``worker_main`` flags (``--postmortem-path``,
``--pm-interval``, ``--keyplane-refresh-s``, ``--keyplane-grace-s``,
``worker_args``).
"""

from __future__ import annotations

import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import telemetry
from ..errors import CapError
from ..obs import postmortem as _postmortem
from ..parallel.place import (
    WorkerPlacement,
    assert_single_owner,
    single_owner_placement,
)
from ..serve import protocol


class FleetError(CapError):
    default_message = "fleet error"


# Worker lifecycle states.
STARTING = "starting"
READY = "ready"
DRAINING = "draining"
DEAD = "dead"          # crash observed, respawn pending/possible
FAILED = "failed"      # out of respawn budget; devices idle
RETIRED = "retired"    # drained by resize(); slot reusable on growth


class WorkerHandle:
    """One supervised worker slot (a device group and its process)."""

    def __init__(self, placement: WorkerPlacement):
        self.placement = placement
        self.proc: Optional[subprocess.Popen] = None
        self.address: Optional[Tuple[str, int]] = None
        self.obs_address: Optional[Tuple[str, int]] = None
        self.state = STARTING
        self.restarts = 0
        self.ping_failures = 0
        # Last key epoch this worker ACKED (or announced on its ready
        # line); the supervisor re-pushes until it matches the pool's
        # current distribution — convergence after crash/kill -9.
        self.key_epoch: Optional[int] = None
        # Which serve chain the worker announced on its ready line
        # ("native" / "python"; None before the first ready line).
        self.serve_chain: Optional[str] = None
        # Transport capability from the ready line ("shm" / "socket";
        # None while starting) — what actually runs, stale-.so
        # fallback included.
        self.transport: Optional[str] = None
        # Latest collected crash/drain postmortem (obs.postmortem doc)
        # and the checkpoint file the worker writes into.
        self.postmortem: Optional[dict] = None
        self.postmortem_path: Optional[str] = None
        # Peer-fill state: a freshly (re)spawned worker boots with an
        # EMPTY verdict cache; the supervisor keeps offering it a
        # sibling's cache dump (CVB1 types 13/14) until one lands or
        # the attempt budget runs out — warming comes from a peer, not
        # from re-verifying against the IdP.
        self.peer_fill_pending = False
        self.peer_fill_attempts = 0
        # The latest ready line as the worker printed it (None while
        # starting).
        self.ready_line: Optional[str] = None

    @property
    def worker_id(self) -> int:
        return self.placement.worker_id

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None


class WorkerPool:
    """Spawn and supervise a fleet of verify workers.

    keyset_spec: passed to every worker (``worker_main.make_keyset``).
    placements: explicit list (each with its platform, "cuda" or
    "cpu"), or None → ``single_owner_placement(n_workers, n_devices or
    n_workers, platform)``.
    keyplane_refresh_s / keyplane_grace_s: the ``jwks-url:`` /
    ``oidc:`` workers' refresh cadence and rotation grace.
    worker_args: further ``worker_main`` flags for every worker (e.g.
    ``["--vcache", "off"]``).
    """

    def __init__(self, n_workers: int, keyset_spec: str = "stub",
                 placements: Optional[List[WorkerPlacement]] = None,
                 n_devices: Optional[int] = None, platform: str = "cuda",
                 host: str = "127.0.0.1",
                 target_batch: int = 4096, max_wait_ms: float = 2.0,
                 max_batch: int = 32768,
                 ping_interval: float = 0.5, ping_timeout: float = 2.0,
                 hung_after: int = 3, max_restarts: int = 5,
                 spawn_timeout: float = 60.0, drain_grace: float = 5.0,
                 worker_args: Sequence[str] = (),
                 keyplane_refresh_s: Optional[float] = None,
                 keyplane_grace_s: Optional[float] = None,
                 postmortem_dir: Optional[str] = None,
                 postmortem_interval: float = 1.0,
                 keys_push_timeout: float = 30.0,
                 serve_chain: Optional[str] = None,
                 transport: Optional[str] = None,
                 peer_fill: bool = True, peer_fill_max: int = 2048,
                 peer_fill_attempts: int = 50,
                 autoscale: Optional[dict] = None):
        if placements is None:
            placements = single_owner_placement(
                n_workers, n_devices if n_devices is not None else n_workers,
                platform=platform)
        if len(placements) != n_workers:
            raise FleetError(f"{n_workers} workers but "
                             f"{len(placements)} placements")
        assert_single_owner(placements)
        self._spec = keyset_spec
        self._host = host
        self._worker_args = ["--target-batch", str(target_batch),
                             "--max-wait-ms", str(max_wait_ms),
                             "--max-batch", str(max_batch),
                             "--drain-deadline-s", str(drain_grace)]
        if serve_chain is not None:
            # explicit chain selection ("native"/"python") —
            # the ready line still reports what actually came up
            self._worker_args += ["--serve-chain", serve_chain]
        if transport is not None:
            # transport capability ("shm"/"socket") — same
            # report-what-runs stance as the serve chain
            self._worker_args += ["--transport", transport]
        if keyplane_refresh_s is not None:
            self._worker_args += ["--keyplane-refresh-s",
                                  str(keyplane_refresh_s)]
        if keyplane_grace_s is not None:
            self._worker_args += ["--keyplane-grace-s",
                                  str(keyplane_grace_s)]
        self._worker_args += list(worker_args)
        self._ping_interval = ping_interval
        self._ping_timeout = ping_timeout
        self._hung_after = hung_after
        self._max_restarts = max_restarts
        self._spawn_timeout = spawn_timeout
        self._drain_grace = drain_grace
        # Crash postmortems are ON by default: workers checkpoint into
        # per-slot files here; the pool collects a file once the death
        # is CONFIRMED (so even kill -9 leaves a ≤interval-stale
        # document). postmortem_dir=None → a pool-owned temp dir,
        # removed in close(); an explicit dir is the caller's to keep.
        self._pm_interval = postmortem_interval
        self._pm_dir_owned = postmortem_dir is None
        self._pm_dir = (tempfile.mkdtemp(prefix="cap-fleet-pm-")
                        if postmortem_dir is None else postmortem_dir)
        os.makedirs(self._pm_dir, exist_ok=True)
        # Keyplane distribution state: the epoch+JWKS the fleet should
        # converge on. Set BEFORE the first worker is contacted in
        # push_keys, so a crash mid-push leaves the supervisor enough
        # to finish the rotation on the respawned worker.
        self._keys_push_timeout = keys_push_timeout
        self._keys_current: Optional[Tuple[int, dict]] = None
        # Verdict-cache peer fill (docs/SERVE.md §Front door): ON by
        # default — correctness is clamp-guaranteed worker-side, so
        # the only cost of offering is two small control exchanges.
        self._peer_fill = bool(peer_fill)
        self._peer_fill_max = int(peer_fill_max)
        self._peer_fill_budget = int(peer_fill_attempts)
        self._lock = threading.Lock()
        self._closed = threading.Event()
        # Resize machinery: the placement split every later
        # growth extends, plus the bounded transition log capstat and
        # the chaos postmortems render.
        self._platform = placements[0].platform if placements else "cuda"
        self._devices_per_worker = (len(placements[0].device_ids)
                                    if placements else 1)
        self._resize_events: List[dict] = []
        self._handles = [WorkerHandle(p) for p in placements]
        for h in self._handles:
            self._spawn(h)
        telemetry.gauge("fleet.pool_size", n_workers)
        # SLO-burn autoscaler: opt-in via a knob dict (see
        # fleet/autoscale.PoolAutoscaler); ticked from the supervisor
        # sweep so scaling rides the existing supervision cadence.
        self._autoscaler = None
        if autoscale is not None:
            from .autoscale import PoolAutoscaler

            self._autoscaler = PoolAutoscaler(self, **autoscale)
        self._supervisor = threading.Thread(
            target=self._supervise_loop, daemon=True,
            name="cap-gpu-fleet-supervisor")
        self._supervisor.start()

    # -- public surface ---------------------------------------------------

    def endpoints(self) -> Dict[int, Tuple[str, int]]:
        """worker_id → (host, port) of every READY worker."""
        with self._lock:
            return {h.worker_id: h.address for h in self._handles
                    if h.state == READY and h.address is not None}

    def obs_endpoints(self) -> Dict[int, Tuple[str, int]]:
        """worker_id → (host, port) of every READY worker's HTTP
        observability server (/metrics, /snapshot, /flight) — what
        ``tools/capstat.py`` scrapes."""
        with self._lock:
            return {h.worker_id: h.obs_address for h in self._handles
                    if h.state == READY and h.obs_address is not None}

    def address(self, worker_id: int) -> Optional[Tuple[str, int]]:
        with self._lock:
            return self._handles[worker_id].address

    def pid(self, worker_id: int) -> Optional[int]:
        with self._lock:
            return self._handles[worker_id].pid

    def state(self, worker_id: int) -> str:
        with self._lock:
            return self._handles[worker_id].state

    def ready_line(self, worker_id: int) -> Optional[str]:
        """The worker's latest ``CAP_FLEET_READY`` line, as printed."""
        with self._lock:
            return self._handles[worker_id].ready_line

    def restarts(self, worker_id: int) -> int:
        with self._lock:
            return self._handles[worker_id].restarts

    def placement_map(self) -> Dict[int, Tuple[int, ...]]:
        """worker_id → owned device ids (the single-owner map)."""
        return {h.worker_id: h.placement.device_ids for h in self._handles}

    def wait_all_ready(self, timeout: float = 60.0) -> bool:
        """Block until every non-failed worker is READY (or timeout)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                states = [h.state for h in self._handles]
            if all(s in (READY, FAILED) for s in states):
                return all(s == READY for s in states)
            time.sleep(0.05)
        return False

    # -- resize / autoscale -----------------------------------------------

    def size(self) -> int:
        """ACTIVE worker slots (everything not retired/failed)."""
        with self._lock:
            return sum(1 for h in self._handles
                       if h.state not in (RETIRED, FAILED))

    def resize_events(self, last: int = 64) -> List[dict]:
        """The bounded transition log: every resize / shed / unshed,
        newest last — capstat renders it and the chaos postmortems
        embed it (the pool annotates collected docs)."""
        with self._lock:
            return list(self._resize_events[-last:])

    def _record_resize(self, kind: str, frm: int, to: int, reason: str,
                       tenant: Optional[str] = None) -> None:
        ev: Dict[str, Any] = {"t": time.time(), "kind": kind,
                              "from": frm, "to": to, "reason": reason}
        if tenant is not None:
            ev["tenant"] = tenant
        with self._lock:
            self._resize_events.append(ev)
            del self._resize_events[:-64]
        telemetry.count(f"fleet.resize.{kind}")
        telemetry.gauge("fleet.pool_size", to)

    def resize(self, n: int, reason: str = "manual") -> int:
        """Grow or shrink the pool to ``n`` active workers under the
        existing placement + supervision machinery.

        Growth reuses RETIRED slots first (fresh respawn budget), then
        appends new single-owner placements extending the original
        devices-per-worker split — slots only on ``cpu`` (a CPU worker
        owns no card), so growth is unbounded there; a pool whose first
        placement is ``cuda`` cannot grow past the cards it was given.
        Shrink drains the HIGHEST-id active workers (SIGTERM → grace →
        SIGKILL, postmortem collected) and retires their slots. Every
        transition is a counter (``fleet.resize.up`` / ``.down``) and
        a :meth:`resize_events` entry. Returns the new active size."""
        n = int(n)
        if n < 1:
            raise FleetError(f"cannot resize below 1 worker (asked {n})")
        cur = self.size()
        if n == cur or self._closed.is_set():
            return cur
        if n > cur:
            grow = n - cur
            with self._lock:
                retired = [h for h in self._handles
                           if h.state == RETIRED][:grow]
            for h in retired:
                with self._lock:
                    h.restarts = 0
                self._spawn(h)
                grow -= 1
            while grow > 0:
                if self._platform == "cuda":
                    raise FleetError(
                        "cannot grow a CUDA pool past its initial "
                        "device budget (single-owner placement)")
                with self._lock:
                    wid = len(self._handles)
                    placement = WorkerPlacement(
                        worker_id=wid,
                        device_ids=tuple(range(
                            wid * self._devices_per_worker,
                            (wid + 1) * self._devices_per_worker)),
                        platform=self._platform)
                    active_pl = [x.placement for x in self._handles
                                 if x.state != RETIRED]
                    h = WorkerHandle(placement)
                    self._handles.append(h)
                # disjointness stays structural even under growth
                assert_single_owner(active_pl + [placement])
                self._spawn(h)
                grow -= 1
            self._record_resize("up", cur, n, reason)
            return n
        # shrink: drain the highest-id active workers
        with self._lock:
            victims = sorted(
                (h for h in self._handles
                 if h.state not in (RETIRED, FAILED)),
                key=lambda h: -h.worker_id)[: cur - n]
            for h in victims:
                h.state = DRAINING
        for h in victims:
            self._reap(h, graceful=True)
            self._collect_postmortem(h)
            with self._lock:
                h.state = RETIRED
        self._record_resize("down", cur, n, reason)
        return n

    # -- admission distribution -------------------------------------------

    def _control_exchange(self, h: WorkerHandle,
                          doc: dict) -> Optional[dict]:
        """One type-13/14 control exchange on a fresh connection
        (KEYS-push shape; returns the ack doc or None)."""
        import json as _json

        with self._lock:
            addr = h.address if h.state == READY else None
        if addr is None:
            return None
        try:
            with socket.create_connection(
                    addr, timeout=self._ping_timeout) as s:
                s.settimeout(self._keys_push_timeout)
                protocol.send_peer_fill(s, doc)
                ftype, entries = protocol.FrameReader(s).recv_frame()
            if (ftype != protocol.T_PEER_ACK or not entries
                    or entries[0][0] != 0):
                return None
            return _json.loads(entries[0][1])
        except (OSError, protocol.ProtocolError, ValueError):
            return None

    def push_admission(self, doc: dict) -> Dict[int, bool]:
        """Push one admission op (rate/burst retune and/or per-tenant
        shed scales) to every READY worker — the autoscaler's tighten
        lever, riding the existing peer-fill control pair (no new
        frame type). Returns worker_id → applied."""
        doc = {**doc, "op": "admission"}
        with self._lock:
            targets = [h for h in self._handles
                       if h.state == READY and h.address is not None]
        telemetry.count("fleet.admission_pushes")
        out: Dict[int, bool] = {}
        for h in targets:
            out[h.worker_id] = self._control_exchange(h, doc) \
                is not None
        return out

    def shed_tenant(self, tenant: str, scale: float,
                    reason: str = "slo-burn") -> Dict[int, bool]:
        """Tighten one tenant's admission fleet-wide (scale < 1.0
        sheds; 1.0 restores) — counted, evented, capstat-visible."""
        out = self.push_admission({"scale": {str(tenant):
                                             float(scale)}})
        sz = self.size()
        self._record_resize("shed" if scale < 1.0 else "unshed",
                            sz, sz, reason, tenant=str(tenant))
        return out

    def stats(self) -> Dict[int, Optional[dict]]:
        """Aggregate per-worker STATS snapshots (None for the dead)."""
        out: Dict[int, Optional[dict]] = {}
        for wid, addr in sorted(self.endpoints().items()):
            try:
                with socket.create_connection(
                        addr, timeout=self._ping_timeout) as s:
                    protocol.send_stats_request(s)
                    reader = protocol.FrameReader(s)
                    ftype, entries = reader.recv_frame()
                if ftype == protocol.T_STATS_RESP and entries:
                    import json as _json

                    out[wid] = _json.loads(entries[0][1].decode())
                else:
                    out[wid] = None
            except (OSError, protocol.ProtocolError):
                out[wid] = None
        with self._lock:
            for h in self._handles:
                out.setdefault(h.worker_id, None)
        return out

    def tenant_totals(self) -> dict:
        """Fleet-wide per-tenant rollup (issuer hash → tokens /
        accept / reject mix / vcache splits) over the EXACT merged
        worker counters — the pool-side form of ``capstat --tenants``
        (docs/OBSERVABILITY.md §Tenant attribution)."""
        from ..obs import decision as _decision

        merged = self.stats_merged()["aggregate"]["counters"]
        return _decision.tenant_totals(merged)

    def stats_merged(self) -> dict:
        """Per-worker STATS plus an EXACT fleet aggregate.

        The per-worker payloads carry mergeable telemetry snapshots
        (bucket counts), so the aggregate's p50/p95/p99 are those of
        one recorder that had observed every worker's samples — not a
        lossy average of per-worker quantiles.
        """
        from ..obs import occupancy as _occupancy

        workers = self.stats()
        merged = telemetry.merge_snapshots(
            [(s or {}).get("snapshot") for s in workers.values()])
        return {
            "workers": workers,
            "aggregate": {
                "snapshot": merged,
                "series": telemetry.summarize_snapshot(merged),
                "counters": merged["counters"],
                "gauges": merged["gauges"],
                # fleet occupancy from the EXACT merged counters:
                # sum-busy / sum-wall = worker-weighted mean (None
                # until some worker's engine dispatched)
                "occupancy": _occupancy.occupancy_from_counters(
                    merged["counters"]),
                "queued_tokens": sum(
                    (s or {}).get("queued_tokens", 0)
                    for s in workers.values()),
                "inflight_batches": sum(
                    (s or {}).get("inflight_batches", 0)
                    for s in workers.values()),
                "restarts": {h.worker_id: h.restarts
                             for h in self._handles},
                "key_epochs": self.key_epochs(),
                "epoch_skew": self.epoch_skew(),
                "serve_chains": self.serve_chains(),
                "transports": self.transports(),
                "pool_size": self.size(),
                "resize_events": self.resize_events(),
            },
        }

    # -- keyplane distribution --------------------------------------------

    def push_keys(self, jwks_doc: dict,
                  epoch: Optional[int] = None) -> Dict[int, Optional[int]]:
        """Push one key epoch to every READY worker; returns
        worker_id → acked epoch (None: push failed — the supervisor
        keeps re-pushing until the worker converges or dies).

        The distribution target is recorded BEFORE any worker is
        contacted: a worker killed mid-push converges after respawn
        (the ready-path re-push), and a worker that missed its frame
        converges on the next supervisor sweep. ``epoch`` defaults to
        the previous push's epoch + 1.
        """
        with self._lock:
            if epoch is None:
                epoch = (self._keys_current[0] + 1
                         if self._keys_current else 1)
            epoch = int(epoch)
            self._keys_current = (epoch, jwks_doc)
            targets = [h for h in self._handles
                       if h.state == READY and h.address is not None]
        telemetry.count("keyplane.pushes")
        telemetry.gauge("keyplane.epoch", epoch)
        t0 = time.perf_counter()
        out: Dict[int, Optional[int]] = {}
        for h in targets:
            out[h.worker_id] = self._push_keys_to(h, jwks_doc, epoch)
        if out and all(v == epoch for v in out.values()):
            # Rotation propagation lag: push start → last ack. The
            # default SLO rules bound its p99 (docs/KEYPLANE.md).
            telemetry.observe("keyplane.propagate_s",
                              time.perf_counter() - t0)
        with self._lock:
            for h in self._handles:
                out.setdefault(h.worker_id, h.key_epoch
                               if h.key_epoch == epoch else None)
        return out

    def _push_keys_to(self, h: WorkerHandle, jwks_doc: dict,
                      epoch: int) -> Optional[int]:
        """One KEYS push/ack exchange on a fresh connection."""
        with self._lock:
            addr = h.address if h.state == READY else None
        if addr is None:
            return None
        telemetry.count("keyplane.push_attempts")
        try:
            with socket.create_connection(
                    addr, timeout=self._ping_timeout) as s:
                # Table builds on real keysets take longer than a
                # ping: the exchange gets its own (generous) deadline.
                s.settimeout(self._keys_push_timeout)
                protocol.send_keys_push(s, jwks_doc, epoch)
                ftype, entries = protocol.FrameReader(s).recv_frame()
        except (OSError, protocol.ProtocolError):
            telemetry.count("keyplane.push_failures")
            return None
        if (ftype != protocol.T_KEYS_ACK or not entries
                or entries[0][0] != 0):
            telemetry.count("keyplane.push_failures")
            return None
        import json as _json

        try:
            got = int(_json.loads(entries[0][1]).get("epoch"))
        except (ValueError, TypeError):
            telemetry.count("keyplane.push_failures")
            return None
        with self._lock:
            h.key_epoch = got
        return got

    def key_epochs(self) -> Dict[int, Optional[int]]:
        """worker_id → last known key epoch (ready line or KEYS ack)."""
        with self._lock:
            return {h.worker_id: h.key_epoch for h in self._handles}

    def serve_chains(self) -> Dict[int, Optional[str]]:
        """worker_id → serve chain from the ready line ("native" /
        "python"; None while a worker is still starting) — how
        bench_serve/capstat see which chain each worker runs."""
        with self._lock:
            return {h.worker_id: h.serve_chain for h in self._handles}

    def transports(self) -> Dict[int, Optional[str]]:
        """worker_id → transport capability from the ready line
        ("shm" / "socket"; None while starting) — fleet transport
        state in one place, like :meth:`serve_chains`."""
        with self._lock:
            return {h.worker_id: h.transport for h in self._handles}

    def keys_epoch(self) -> Optional[int]:
        """The epoch the fleet is converging on (None: never pushed)."""
        with self._lock:
            return self._keys_current[0] if self._keys_current else None

    def epoch_skew(self) -> int:
        """Spread between the newest and oldest known worker epoch —
        0 when the fleet is converged (what the router surfaces)."""
        epochs = [e for e in self.key_epochs().values() if e is not None]
        if not epochs:
            return 0
        return max(epochs) - min(epochs)

    # -- verdict-cache peer fill ------------------------------------------

    def _peer_fill_once(self, h: WorkerHandle) -> bool:
        """Offer ``h`` one sibling's cache dump: pull an export from a
        READY peer, push it into ``h`` as an import. Returns True when
        at least one entry landed (the worker's own clamps decide —
        the pool moves opaque entries, it never parses verdicts).

        Every fault is survivable: a dead sibling, an empty cache, an
        epoch mismatch at the importer all just mean "try again on the
        next supervisor sweep" while the attempt budget lasts."""
        import json as _json

        with self._lock:
            addr = h.address if h.state == READY else None
            donors = [d.address for d in self._handles
                      if d is not h and d.state == READY
                      and d.address is not None]
        if addr is None or not donors:
            return False
        telemetry.count("fleet.peer_fill_attempts")
        for donor in donors:
            try:
                with socket.create_connection(
                        donor, timeout=self._ping_timeout) as s:
                    s.settimeout(self._keys_push_timeout)
                    protocol.send_peer_fill(
                        s, {"op": "export",
                            "max": self._peer_fill_max})
                    ftype, entries = \
                        protocol.FrameReader(s).recv_frame()
                if (ftype != protocol.T_PEER_ACK or not entries
                        or entries[0][0] != 0):
                    continue
                doc = _json.loads(entries[0][1])
                dump = doc.get("entries") or []
                if not dump:
                    continue
                with socket.create_connection(
                        addr, timeout=self._ping_timeout) as s:
                    s.settimeout(self._keys_push_timeout)
                    protocol.send_peer_fill(
                        s, {"op": "import", "epoch": doc.get("epoch"),
                            "entries": dump})
                    ftype, entries = \
                        protocol.FrameReader(s).recv_frame()
                if (ftype != protocol.T_PEER_ACK or not entries
                        or entries[0][0] != 0):
                    continue
                imported = int(
                    _json.loads(entries[0][1]).get("imported") or 0)
                if imported > 0:
                    telemetry.count("fleet.peer_fill_transfers")
                    telemetry.count("fleet.peer_fill_entries",
                                    imported)
                    return True
            except (OSError, protocol.ProtocolError, ValueError,
                    TypeError):
                telemetry.count("fleet.peer_fill_errors")
                continue
        return False

    def _peer_fill_sweep(self, h: WorkerHandle) -> None:
        """One supervisor-cadence peer-fill attempt for a pending
        worker; clears the pending flag on success or budget
        exhaustion."""
        with self._lock:
            if (not self._peer_fill or not h.peer_fill_pending
                    or h.state != READY):
                return
            h.peer_fill_attempts += 1
            give_up = h.peer_fill_attempts > self._peer_fill_budget
        if give_up:
            with self._lock:
                h.peer_fill_pending = False
            return
        if self._peer_fill_once(h):
            with self._lock:
                h.peer_fill_pending = False

    def postmortem(self, worker_id: int) -> Optional[dict]:
        """The latest postmortem collected for this slot (crash or
        drain), or — when no death was confirmed yet — whatever the
        LIVE worker last checkpointed (best-effort read)."""
        with self._lock:
            h = self._handles[worker_id]
            doc, path = h.postmortem, h.postmortem_path
        if doc is not None:
            return doc
        return _postmortem.read_postmortem(path) if path else None

    def postmortem_path(self, worker_id: int) -> Optional[str]:
        with self._lock:
            return self._handles[worker_id].postmortem_path

    def postmortems(self) -> Dict[int, Optional[dict]]:
        return {h.worker_id: self.postmortem(h.worker_id)
                for h in self._handles}

    def _collect_postmortem(self, h: WorkerHandle) -> None:
        """Read the dead worker's last checkpoint into the handle
        (called only after the death is CONFIRMED, so the file cannot
        be mid-replace — writes are atomic anyway)."""
        if not h.postmortem_path:
            return
        doc = _postmortem.read_postmortem(h.postmortem_path)
        if doc is not None:
            # Pool-side enrichment: the dying worker cannot see pool
            # transitions, so the collector stamps the resize/shed log
            # onto the doc — the chaos bar "resize events visible in
            # the victim's postmortem".
            events = self.resize_events()
            if events:
                doc["pool_resize_events"] = events
            with self._lock:
                h.postmortem = doc
            telemetry.count("fleet.postmortems_collected")

    def restart(self, worker_id: int, graceful: bool = True) -> None:
        """Respawn one worker onto its device group.

        graceful: SIGTERM first (the worker drains: stops accepting,
        flushes queued batches) with ``drain_grace`` to comply, then
        SIGKILL. The replacement is only spawned once the old process
        is confirmed dead — single-owner transfer, never sharing.
        """
        with self._lock:
            h = self._handles[worker_id]
            h.state = DRAINING
        self._reap(h, graceful=graceful)
        self._collect_postmortem(h)
        with self._lock:
            if self._closed.is_set():
                return
            h.restarts += 1
            if h.restarts > self._max_restarts:
                h.state = FAILED
                telemetry.count("fleet.workers_failed")
                return
        telemetry.count("fleet.respawns")
        self._spawn(h)

    def close(self) -> None:
        self._closed.set()
        for h in self._handles:
            self._reap(h, graceful=True)
            self._collect_postmortem(h)
            with self._lock:
                h.state = DEAD
        if self._pm_dir_owned:
            # The docs were collected onto the handles; the pool-owned
            # checkpoint dir has served its purpose.
            shutil.rmtree(self._pm_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals --------------------------------------------------------

    def _spawn(self, h: WorkerHandle) -> None:
        h.postmortem_path = os.path.join(
            self._pm_dir, f"worker-{h.worker_id}.json")
        # The child inherits this process's environment with the
        # placement's variables set on top: env(1) sets them and execs
        # the interpreter in place, so the pid is the worker's own.
        cmd = ["env", *(f"{k}={v}" for k, v in h.placement.env().items()),
               sys.executable, "-m", "cap_tpu_torch.fleet.worker_main",
               "--host", self._host, "--port", "0",
               "--keyset", self._spec, *h.placement.args(),
               "--postmortem-path", h.postmortem_path,
               "--pm-interval", str(self._pm_interval),
               *self._worker_args]
        with self._lock:
            h.state = STARTING
            h.address = None
            h.ready_line = None
            h.ping_failures = 0
            h.proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=None,
                text=True, bufsize=1,
                cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))))
        threading.Thread(target=self._await_ready, args=(h, h.proc),
                         daemon=True, name="cap-gpu-fleet-ready").start()

    def _await_ready(self, h: WorkerHandle, proc: subprocess.Popen) -> None:
        """Parse the child's ready line (bounded), then keep draining
        its stdout so a chatty child can never block on a full pipe."""
        deadline = time.monotonic() + self._spawn_timeout
        port = None
        obs_port = None
        epoch = None
        serve_chain = None
        transport = None
        ready_line = None
        try:
            while time.monotonic() < deadline:
                line = proc.stdout.readline()
                if not line:            # EOF: child died before ready
                    break
                if line.startswith("CAP_FLEET_READY"):
                    ready_line = line.strip()
                    for field in line.split():
                        k, _, v = field.partition("=")
                        if k == "port":
                            port = int(v)
                        elif k == "obs":
                            obs_port = int(v)
                        elif k == "epoch":
                            epoch = int(v)
                        elif k == "serve_chain":
                            serve_chain = v
                        elif k == "transport":
                            transport = v
                    break
        except (OSError, ValueError):
            port = None
        with self._lock:
            if h.proc is not proc or self._closed.is_set():
                return                  # superseded by a later respawn
            if port is None:
                h.state = DEAD
                telemetry.count("fleet.spawn_failures")
            else:
                h.address = (self._host, port)
                h.obs_address = ((self._host, obs_port)
                                 if obs_port else None)
                h.key_epoch = epoch
                h.serve_chain = serve_chain
                h.transport = transport
                h.ready_line = ready_line
                h.state = READY
                h.peer_fill_pending = self._peer_fill
                h.peer_fill_attempts = 0
                telemetry.count("fleet.workers_started")
            keys_current = self._keys_current
        if port is not None and keys_current is not None \
                and epoch != keys_current[0]:
            # A (re)spawned worker boots on its own key material:
            # converge it onto the fleet's current epoch immediately —
            # the kill -9-mid-push recovery path.
            self._push_keys_to(h, keys_current[1], keys_current[0])
        if port is not None:
            # First peer-fill offer right at ready (epochs converged
            # above); siblings that are still cold fail soft and the
            # supervisor keeps retrying on its sweep cadence.
            self._peer_fill_sweep(h)
        # Drain any further output (worker stays quiet normally).
        try:
            for _ in proc.stdout:
                pass
        except (OSError, ValueError):
            pass

    def _ping(self, addr: Tuple[str, int]) -> bool:
        t0 = time.perf_counter()
        try:
            with socket.create_connection(
                    addr, timeout=self._ping_timeout) as s:
                s.settimeout(self._ping_timeout)
                protocol.send_ping(s)
                ftype, _ = protocol.recv_frame(s)
                if ftype == protocol.T_PONG:
                    # Health-ping round trip: the supervisor's view of
                    # worker responsiveness (a climbing p99 here is the
                    # early signal before hung_after trips).
                    telemetry.observe("fleet.ping_s",
                                      time.perf_counter() - t0)
                    return True
                return False
        except (OSError, protocol.ProtocolError):
            return False

    def _supervise_loop(self) -> None:
        while not self._closed.wait(self._ping_interval):
            with self._lock:
                telemetry.gauge(
                    "fleet.workers_ready",
                    sum(1 for h in self._handles if h.state == READY))
            if self._autoscaler is not None:
                try:
                    self._autoscaler.tick()
                except Exception:  # noqa: BLE001 - never kill the loop
                    telemetry.count("fleet.autoscale_errors")
            for h in list(self._handles):
                if self._closed.is_set():
                    return
                with self._lock:
                    state, proc, addr = h.state, h.proc, h.address
                if state in (FAILED, RETIRED) or proc is None:
                    continue
                if proc.poll() is not None and state != DRAINING:
                    # Crash (or kill -9): the process is gone.
                    telemetry.count("fleet.worker_crashes")
                    with self._lock:
                        h.state = DEAD
                    self.restart(h.worker_id, graceful=False)
                    continue
                if state == READY and addr is not None:
                    if self._ping(addr):
                        with self._lock:
                            h.ping_failures = 0
                            keys_current = self._keys_current
                            stale = (keys_current is not None
                                     and h.key_epoch != keys_current[0])
                        if stale:
                            # Missed or failed push (worker restarted
                            # mid-rotation, transient socket error):
                            # keep re-pushing until the ack matches.
                            self._push_keys_to(h, keys_current[1],
                                               keys_current[0])
                        self._peer_fill_sweep(h)
                    else:
                        with self._lock:
                            h.ping_failures += 1
                            hung = h.ping_failures >= self._hung_after
                        if hung:
                            # Alive but unresponsive: treat as hung.
                            telemetry.count("fleet.workers_hung")
                            self.restart(h.worker_id, graceful=True)
                elif state == DEAD:
                    self.restart(h.worker_id, graceful=False)

    def _reap(self, h: WorkerHandle, graceful: bool) -> None:
        """Make the worker's process fully dead (drain → kill)."""
        with self._lock:
            proc = h.proc
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.send_signal(signal.SIGTERM if graceful
                             else signal.SIGKILL)
        except (ProcessLookupError, OSError):
            return
        try:
            proc.wait(timeout=self._drain_grace if graceful else 5.0)
        except subprocess.TimeoutExpired:
            try:
                proc.kill()
                proc.wait(timeout=5.0)
            except (ProcessLookupError, OSError,
                    subprocess.TimeoutExpired):
                pass

"""Adaptive batching in front of the device engine.

The throughput/latency tension from SURVEY.md §7: >500k verifies/sec
wants huge device batches, p99 latency wants small ones. The batcher
resolves it adaptively — submissions from any number of threads or
connections accumulate in one queue; a dispatcher flushes to
``KeySet.verify_batch`` as soon as EITHER the batch-size target is
reached OR the oldest queued token has waited ``max_wait_ms``. Under
load, flushes are back-to-back full batches (max throughput); when
idle, a lone token waits at most one wait window (bounded p99).

When the keyset exposes ``verify_batch_async`` (GPUBatchKeySet), the
dispatcher runs TWO-DEEP: flush k+1's host prep and H2D overlap flush
k's device drain (a collector thread owns the materializing syncs), so
sustained load keeps the device busy. On the card an ES dispatch
still waits once on the device (the batch inverse's host ``pow``,
``gpu.bignum.batch_mont_inverse``), so that overlap is partial.

The port of ``cap_tpu.serve.batcher``; ``fair`` and ``dedup`` are
arguments (the JAX package reads them from its environment).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from .. import telemetry

# Dispatcher-side shutdown sentinel: put into the inflight queue by the
# dispatcher thread itself just before it exits, so by FIFO order it
# arrives AFTER every batch the dispatcher ever handed over.
_DISPATCHER_DONE = object()


class _Pending:
    __slots__ = ("tokens", "results", "event", "ts", "trace", "t0_wall",
                 "traces", "on_done", "digests", "handoff")

    def __init__(self, tokens: Sequence[str],
                 trace: Optional[str] = None,
                 traces: Optional[Sequence[str]] = None,
                 on_done=None,
                 digests: Optional[Sequence[Optional[bytes]]] = None,
                 handoff: bool = False):
        self.tokens = tokens
        # Per-token sha256[:16] digests, when the submitter already
        # has them (the serve cache-consult path; the native chain's
        # C readers compute them at frame-parse time). Routed engines
        # (``verify_batch_digests``) consume them instead of
        # re-hashing; everyone else ignores them.
        self.digests = digests
        self.results: Optional[List[Any]] = None
        self.event = threading.Event()
        self.ts = time.monotonic()
        # Trace context: captured at submit (explicitly from the wire,
        # or from the caller's telemetry.trace() scope) so the flush /
        # dispatch stages can attribute their spans per request even
        # though many submissions coalesce into one device batch.
        self.trace = trace if trace is not None \
            else telemetry.current_trace()
        self.t0_wall = time.time() if (self.trace or traces) else 0.0
        # Batch handoff extras (submit_handoff): the native serve
        # chain submits one _Pending per DRAINED RING CHUNK, carrying
        # the union of its requests' trace ids and one completion
        # callback — no per-token (or per-request) callbacks anywhere.
        self.traces: Sequence[str] = traces or ()
        self.on_done = on_done
        # Ring-chunk handoff marker: a size-triggered flush whose sole
        # member is one handed-off chunk classifies as flush reason
        # "handoff" (the native chain's drained-chunk shape) rather
        # than "size".
        self.handoff = handoff


class AdaptiveBatcher:
    """Aggregates verify submissions into device-sized batches.

    keyset: anything with ``verify_batch(tokens) -> list`` (claims dict
    or per-token Exception). target_batch: flush threshold;
    max_wait_ms: max time the OLDEST submission waits before a flush;
    max_batch: hard cap per device dispatch.
    """

    def __init__(self, keyset, target_batch: int = 4096,
                 max_wait_ms: float = 2.0, max_batch: int = 32768,
                 max_queued_tokens: int = 0,
                 dedup: bool = True,
                 fair: bool = False,
                 drr_quantum: int = 0):
        self._keyset = keyset
        # Tenant-fair mode: pending submissions park in per-tenant DRR
        # subqueues (cap_tpu_torch.serve.drr) and flushes pop them in
        # deficit-round-robin order, so a flooding issuer cannot starve
        # quiet tenants of batch slots.
        self._sched = None
        self._carry: Optional["_Pending"] = None
        if fair:
            from . import drr as _drr

            self._sched = _drr.DRRScheduler(
                quantum=drr_quantum or _drr.DEFAULT_QUANTUM)
        self.fair = self._sched is not None
        # In-flight replay dedup: identical tokens queued together
        # verify ONCE per flush and the single verdict fans out to every
        # waiter (verify is deterministic, so duplicate suppression
        # cannot change any verdict; per-submission trace ids and
        # decision records are untouched — they attach to the _Pending,
        # not to the deduped dispatch list).
        self._dedup = bool(dedup)
        # Digest-routed engines (the front-door router): the sync
        # flush path calls ``verify_batch_digests(tokens, digests)``
        # so reader/cache-computed digests survive the batcher instead
        # of being re-hashed per hop. Async dispatch wins when a
        # keyset exposes both.
        self._wants_digests = hasattr(keyset, "verify_batch_digests")
        self._target = target_batch
        self._max_wait = max_wait_ms / 1000.0
        self._max_batch = max_batch
        # Admission watermark: submit_nowait blocks once this many
        # tokens are queued (pipelined connections then push the
        # backpressure into TCP instead of growing the queue without
        # bound). 0 → 4 device batches of headroom.
        self._max_queued = max_queued_tokens or 4 * max_batch
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[_Pending] = []
        self._queued_tokens = 0
        self._closed = False
        # Flush-reason attribution + last-flush lifecycle (occupancy
        # plane, docs/OBSERVABILITY.md §Occupancy plane). Written only
        # from the dispatcher/collector threads; reads take racy-but-
        # consistent dict copies (stats()).
        self._flush_reasons: Dict[str, int] = {}
        self._last_flush: Dict[str, Any] = {}
        self._gauges_decayed = False
        # 2-deep pipeline: one batch draining in the collector while
        # the dispatcher preps/dispatches the next. TWO slots, each
        # acquired BEFORE dispatching and released when the collector
        # finishes draining that batch: batch k+1's host prep/H2D runs
        # while batch k drains (the point of the pipeline), and batch
        # k+2's dispatch blocks until k is collected — a bounded queue
        # alone would admit a third batch's device work first.
        self._inflight: "queue.Queue" = queue.Queue()
        self._slot = threading.Semaphore(2)
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True,
            name="cap-gpu-collector")
        self._collector.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cap-gpu-batcher")
        self._thread.start()

    # -- submission side --------------------------------------------------

    def submit(self, tokens: Sequence[str]) -> List[Any]:
        """Block until the batch containing ``tokens`` is verified."""
        p = self.submit_nowait(tokens)
        p.event.wait()
        assert p.results is not None
        return p.results

    def submit_nowait(self, tokens: Sequence[str],
                      trace: Optional[str] = None,
                      digests: Optional[Sequence[Optional[bytes]]]
                      = None) -> "_Pending":
        """Enqueue and return the pending handle WITHOUT waiting.

        The caller waits on ``pending.event`` and reads
        ``pending.results``. This is what lets a serve connection keep
        READING frames while earlier submissions verify — request
        pipelining. ``trace``: telemetry trace id for
        this submission (the worker passes the wire's trace-context).
        ``digests``: optional per-token sha256[:16] for digest-routed
        engines.
        """
        return self._admit(_Pending(list(tokens), trace=trace,
                                    digests=digests))

    def submit_handoff(self, tokens: Sequence[str],
                       traces: Sequence[str] = (),
                       on_done=None,
                       digests: Optional[Sequence[Optional[bytes]]]
                       = None) -> "_Pending":
        """Batch handoff for ring-draining front ends (the native
        serve chain): enqueue one whole drained chunk, with ``traces``
        (the union of its requests' trace ids, for fill/dispatch span
        attribution) and ONE ``on_done(results)`` callback invoked
        from the dispatcher/collector thread when the chunk's verdicts
        are ready — the caller never parks a thread per submission and
        never registers per-token callbacks."""
        return self._admit(_Pending(list(tokens), traces=traces,
                                    on_done=on_done, digests=digests,
                                    handoff=True))

    def _admit(self, p: "_Pending") -> "_Pending":
        if not p.tokens:
            p.results = []
            p.event.set()
            if p.on_done is not None:
                p.on_done(p.results)
            return p
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            # Admission control: hold the caller (a serve reader
            # thread) while the queue is saturated — an empty queue
            # always admits, so one oversized submission can't wedge.
            while (self._queued_tokens > 0
                   and self._queued_tokens + len(p.tokens)
                   > self._max_queued and not self._closed):
                self._cv.wait()
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._sched is not None:
                from . import drr as _drr

                self._sched.push(_drr.sched_slot_for_tokens(p.tokens),
                                 p, len(p.tokens))
            else:
                self._queue.append(p)
            self._queued_tokens += len(p.tokens)
            self._cv.notify_all()
        return p

    def set_weight(self, slot: int, w: int) -> None:
        """Per-tenant DRR weight (fair mode only; slot = tenant slot,
        ``drr.SCHED_BE`` for the best-effort slot)."""
        if self._sched is not None:
            with self._lock:
                self._sched.set_weight(slot, w)

    # -- fair-mode pending accessors (called under self._lock) ------------

    def _have_pending(self) -> bool:
        if self._sched is not None:
            return self._carry is not None or self._sched.n > 0
        return bool(self._queue)

    def _oldest_ts(self) -> float:
        if self._sched is None:
            return self._queue[0].ts
        oldest = self._carry.ts if self._carry is not None else None
        ts = self._sched.peek_oldest_ts(lambda p: p.ts)
        if ts is not None and (oldest is None or ts < oldest):
            oldest = ts
        return oldest if oldest is not None else time.monotonic()

    def _take_batch(self):
        """Next flush's members: FIFO order, or DRR order in fair mode
        (a popped submission that would overflow max_batch carries to
        the next flush — same carry semantics as the native drain)."""
        batch: List[_Pending] = []
        n = 0
        if self._sched is None:
            while self._queue and n < self._max_batch:
                nxt = self._queue[0]
                if batch and n + len(nxt.tokens) > self._max_batch:
                    break
                batch.append(self._queue.pop(0))
                n += len(nxt.tokens)
            return batch, n
        while n < self._max_batch:
            p = self._carry
            self._carry = None
            if p is None:
                p = self._sched.pop()
            if p is None:
                break
            if batch and n + len(p.tokens) > self._max_batch:
                self._carry = p
                break
            batch.append(p)
            n += len(p.tokens)
        return batch, n

    def depth(self) -> Dict[str, int]:
        """Queue-depth snapshot: tokens awaiting dispatch + batches in
        flight on the device (the fleet STATS op reads this)."""
        with self._lock:
            queued = self._queued_tokens
        return {"queued_tokens": queued,
                "inflight_batches": self._inflight.qsize()}

    def stats(self) -> Dict[str, Any]:
        """Depth plus occupancy-plane extras: cumulative flush-reason
        counts and the last flush's lifecycle durations. ADDITIVE —
        the keys are absent until the first flush, so STATS frames of
        a batcher that never flushed are byte-identical to before this
        surface existed."""
        out: Dict[str, Any] = self.depth()
        reasons = dict(self._flush_reasons)
        if reasons:
            out["flush_reasons"] = reasons
        last = dict(self._last_flush)
        if last:
            out["last_flush"] = last
        return out

    def close(self, deadline_s: float = 120.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        # The dispatcher may be blocked in _slot.acquire() for its LAST
        # batch while the collector sits in a multi-second device sync —
        # wait it out, but bound the whole shutdown: if a device sync
        # wedges past the deadline, give up and return; both threads
        # are daemons, and the collector keeps draining whatever the
        # dispatcher hands it until the dispatcher-side DONE sentinel.
        limit = time.monotonic() + deadline_s
        while self._thread.is_alive() and time.monotonic() < limit:
            self._thread.join(timeout=2.0)
        self._collector.join(timeout=max(1.0, limit - time.monotonic()))

    # -- dispatcher -------------------------------------------------------

    def _run(self) -> None:
        try:
            self._run_loop()
        finally:
            self._inflight.put(_DISPATCHER_DONE)

    def _run_loop(self) -> None:
        while True:
            with self._cv:
                if not self._have_pending() and not self._gauges_decayed:
                    # Staleness fix: an emptied queue decays its depth
                    # gauges to 0 instead of freezing the last flush's
                    # values on the scrape surface forever.
                    telemetry.gauge("batcher.queued_tokens", 0)
                    telemetry.gauge("batcher.fill_ratio", 0.0)
                    self._gauges_decayed = True
                while not self._have_pending() and not self._closed:
                    self._cv.wait()
                if self._closed and not self._have_pending():
                    return
                # Wait for more work up to the flush condition: the
                # OLDEST queued submission waits at most max_wait.
                while (self._queued_tokens < self._target
                       and not self._closed):
                    remaining = (self._oldest_ts() + self._max_wait
                                 - time.monotonic())
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                # Flush-reason attribution, decided while the queue
                # state that caused the flush is still visible.
                if self._queued_tokens >= self._target:
                    reason = "size"
                elif self._closed:
                    reason = "close"
                else:
                    reason = "timeout"
                batch, n = self._take_batch()
                self._queued_tokens -= n
                if n:
                    self._cv.notify_all()   # wake admission waiters
            if not batch:
                continue
            if reason == "size" and len(batch) == 1 and batch[0].handoff:
                # One drained ring chunk alone met the size target —
                # the native chain's characteristic flush shape.
                reason = "handoff"
            elif reason == "close" and n >= self._target:
                reason = "drain"       # full batch while closing
            self._flush(batch, n, reason)

    def _flush(self, batch: List[_Pending], n: int,
               reason: str = "size") -> None:
        t_flush = time.monotonic()
        tokens: List[str] = []
        for p in batch:
            tokens.extend(p.tokens)
        telemetry.count("batcher.flushes")
        telemetry.count(f"batcher.flush.{reason}")
        self._flush_reasons[reason] = \
            self._flush_reasons.get(reason, 0) + 1
        telemetry.observe("batcher.batch_size", float(n))
        # Depth/fill gauges at flush time: what the exposition surface
        # shows as the batcher's current operating point.
        telemetry.gauge("batcher.queued_tokens", self.depth()["queued_tokens"])
        telemetry.gauge("batcher.fill_ratio", n / self._target)
        self._gauges_decayed = False
        telemetry.observe("batcher.fill_ratio", n / self._target)
        now_wall = time.time()
        telemetry.observe("batcher.fill_wait_s", t_flush - batch[0].ts)
        # Stage waterfall (docs/OBSERVABILITY.md §Occupancy plane):
        # per-member queueing delay submit → flush start.
        for p in batch:
            telemetry.observe("queue.batcher_wait_s", t_flush - p.ts)
        lf: Dict[str, Any] = {"t_wall": now_wall, "reason": reason,
                              "batch_size": n,
                              "batcher_wait_s": t_flush - batch[0].ts}
        self._last_flush = lf
        # Per-request FILL span (submit -> flush start), then run the
        # flush/dispatch under the union of member traces so engine
        # spans (dispatch.<family>.*) attach to every traced request
        # in the coalesced batch.
        traces = []
        for p in batch:
            for tid in (p.traces or ((p.trace,) if p.trace else ())):
                traces.append(tid)
                telemetry.trace_span(tid, telemetry.SPAN_BATCHER_FILL,
                                     p.t0_wall, now_wall - p.t0_wall)
        # Per-token digests for digest-routed engines: token-aligned,
        # None where a submitter had none (the engine hashes those
        # itself — digest is a pure function of the token, so a mixed
        # list is still exact).
        digests: Optional[List[Optional[bytes]]] = None
        if self._wants_digests:
            digests = []
            for p in batch:
                if p.digests is not None and len(p.digests) \
                        == len(p.tokens):
                    digests.extend(p.digests)
                else:
                    digests.extend([None] * len(p.tokens))
        # In-flight dedup: collapse identical tokens queued in this
        # flush to ONE dispatch slot each; the verdict fans back out
        # in _expand. Digest equality == token equality (the vcache's
        # sha256 contract), so string identity is the same key.
        send_tokens = tokens
        send_digests = digests
        expand: Optional[List[int]] = None
        # len(set()) probe first: all-unique flushes (the common case
        # once the vcache absorbs repeats upstream) pay one C-speed
        # pass, not a per-token Python dict loop.
        if self._dedup and n > 1 and len(set(tokens)) < n:
            first: Dict[Any, int] = {}
            idx_map: List[int] = []
            uniq: List[Any] = []
            uniq_dig: List[Optional[bytes]] = []
            for i, t in enumerate(tokens):
                j = first.get(t)
                if j is None:
                    j = first[t] = len(uniq)
                    uniq.append(t)
                    if digests is not None:
                        uniq_dig.append(digests[i])
                idx_map.append(j)
            telemetry.count("batcher.dedup_fanout", n - len(uniq))
            send_tokens = uniq
            if digests is not None:
                send_digests = uniq_dig
            expand = idx_map
        dispatch = getattr(self._keyset, "verify_batch_async", None)
        if dispatch is not None:
            self._slot.acquire()          # backpressure BEFORE dispatch
            # flush → dispatch gap: dominated by _slot.acquire, i.e.
            # the 2-deep pipeline's backpressure on the device.
            t_dispatch = time.monotonic()
            telemetry.observe("queue.dispatch_gap_s", t_dispatch - t_flush)
            lf["dispatch_gap_s"] = t_dispatch - t_flush
            try:
                with telemetry.trace_scope(traces), \
                        telemetry.span(telemetry.SPAN_BATCHER_DISPATCH):
                    collect = dispatch(send_tokens)
            except Exception as e:  # noqa: BLE001 - fan the failure out
                self._slot.release()
                self._distribute(batch, [e] * n)
                return
            self._inflight.put((batch, n, collect, expand, t_dispatch, lf))
            return
        t_dispatch = time.monotonic()
        telemetry.observe("queue.dispatch_gap_s", t_dispatch - t_flush)
        lf["dispatch_gap_s"] = t_dispatch - t_flush
        try:
            with telemetry.trace_scope(traces), \
                    telemetry.span(telemetry.SPAN_BATCHER_FLUSH):
                if self._wants_digests:
                    raw = self._keyset.verify_batch_digests(
                        send_tokens, send_digests)
                else:
                    raw = self._keyset.verify_batch(send_tokens)
                results = self._expand(raw, expand)
        except Exception as e:  # noqa: BLE001 - fan the failure out
            results = [e] * n
        exec_s = time.monotonic() - t_dispatch
        telemetry.observe("device.exec_s", exec_s)
        lf["exec_s"] = exec_s
        self._distribute(batch, results)

    @staticmethod
    def _expand(results: List[Any],
                expand: Optional[List[int]]) -> List[Any]:
        """Fan a deduped dispatch's verdicts back out to every queued
        position (shared verdict objects — verify is deterministic and
        downstream only reads them)."""
        if expand is None:
            return results
        return [results[j] for j in expand]

    def _collect_loop(self) -> None:
        # The dispatcher enqueues _DISPATCHER_DONE on exit, so by FIFO
        # order every batch it ever dispatched is collected before this
        # loop returns — even when close()'s deadline expired while
        # batches were still dispatching, submitters are never stranded
        # in event.wait(). (A dispatcher that dies without the sentinel
        # is impossible short of interpreter teardown; both threads are
        # daemons regardless.)
        while True:
            item = self._inflight.get()
            if item is _DISPATCHER_DONE:
                return
            batch, n_tokens, collect, expand, t_dispatch, lf = item
            traces = [tid for p in batch
                      for tid in (p.traces
                                  or ((p.trace,) if p.trace else ()))]
            try:
                with telemetry.trace_scope(traces), \
                        telemetry.span(telemetry.SPAN_BATCHER_COLLECT):
                    results = self._expand(collect(), expand)
            except Exception as e:  # noqa: BLE001 - fan the failure out
                results = [e] * n_tokens
            finally:
                self._slot.release()
            # dispatch → collect-done: the device-execution stage of
            # the waterfall (includes the in-flight overlap window).
            exec_s = time.monotonic() - t_dispatch
            telemetry.observe("device.exec_s", exec_s)
            lf["exec_s"] = exec_s
            self._distribute(batch, results)

    @staticmethod
    def _distribute(batch: List[_Pending], results: List[Any]) -> None:
        off = 0
        now = time.time()
        for p in batch:
            p.results = list(results[off: off + len(p.tokens)])
            off += len(p.tokens)
            if p.trace:
                # Close the traced request's worker-side timeline into
                # the flight ring (spans: fill, flush/dispatch/collect,
                # any engine dispatch.* recorded under the batch scope)
                # BEFORE waking the submitter, so a scrape racing the
                # response already sees the completed timeline.
                telemetry.flight(p.trace, now - p.t0_wall)
            p.event.set()
            if p.on_done is not None:
                # Batch handoff: the whole chunk's verdicts in one
                # call, from this (dispatcher/collector) thread. The
                # native chain records its traced requests' flight
                # entries itself (it knows each request's t0).
                try:
                    p.on_done(p.results)
                except Exception:  # noqa: BLE001 - never kill the loop
                    telemetry.count("batcher.handoff_errors")

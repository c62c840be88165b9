"""Deficit-round-robin scheduler for the batcher's fair mode.

The port of ``cap_tpu.serve.drr`` (there the python twin of the
native serve chain's ``DrrSched``), used by
:class:`~cap_tpu_torch.serve.batcher.AdaptiveBatcher`'s ``fair=True``
mode. Its pop order equals the JAX package's element for element.

Shape (the classic DRR result — Shreedhar & Varghese — behind
token-bucket-policed ingest): one subqueue per real tenant slot
(``TENANT_CAP``) plus ONE shared best-effort slot for none / other /
unclassified traffic; costs are TOKENS; a queue whose head costs more
than its accumulated deficit yields the cursor and earns another
``quantum × weight`` on its next visit; a queue that empties resets
its deficit (leaving the active set forfeits credit).
"""

from __future__ import annotations

from collections import deque
from typing import Any, List, Optional, Tuple

from ..obs import decision as _decision

# One slot per real tenant + the shared best-effort slot. Mirrors
# serve_native.cpp SCHED_SLOTS / SCHED_BE — the parity test drives
# both against the same slot universe.
SCHED_SLOTS = _decision.TENANT_CAP + 1
SCHED_BE = _decision.TENANT_CAP
DEFAULT_QUANTUM = 512


def sched_slot_for_label(label: str) -> int:
    """DRR slot for a resolved tenant label: its own slot while the
    tenant table has room, the shared best-effort slot for none /
    other (the native readers make the same call on the tenant slot
    they classified at frame-parse time)."""
    idx = _decision.tenant_index(label)
    if 0 <= idx < _decision.TENANT_CAP:
        return idx
    return SCHED_BE


def sched_slot_for_tokens(tokens) -> int:
    """Slot of a submission: the FIRST token's tenant (frames are
    per-connection and issuers per-client, so mixed-tenant
    submissions are rare — the native reader picks the same way)."""
    if not tokens:
        return SCHED_BE
    tok = tokens[0]
    seg = tok.split(".", 1)[0] if isinstance(tok, str) else None
    return sched_slot_for_label(_decision._seg_fkt(seg, tok)[2])


class DRRScheduler:
    """Deficit round robin over ``SCHED_SLOTS`` subqueues.

    ``push(slot, item, cost)`` enqueues; ``pop()`` returns the next
    item in DRR order (None when empty). Deterministic given the
    arrival sequence — the cross-chain parity contract.
    """

    __slots__ = ("_q", "_deficit", "weight", "quantum", "_cursor",
                 "_fresh", "n")

    def __init__(self, quantum: int = DEFAULT_QUANTUM,
                 slots: int = SCHED_SLOTS):
        self._q: List[deque] = [deque() for _ in range(slots)]
        self._deficit = [0] * slots
        self.weight = [1] * slots
        self.quantum = int(quantum) if quantum > 0 else DEFAULT_QUANTUM
        self._cursor = 0
        self._fresh = True
        self.n = 0

    def set_weight(self, slot: int, w: int) -> None:
        if 0 <= slot < len(self._q) and w >= 1:
            self.weight[slot] = int(w)

    def push(self, slot: int, item: Any, cost: int) -> None:
        if not 0 <= slot < len(self._q):
            slot = SCHED_BE
        self._q[slot].append((item, max(1, int(cost))))
        self.n += 1

    def peek_oldest_ts(self, ts_of) -> Optional[float]:
        """min(ts) over every queue head (the batcher's flush-window
        clock needs the OLDEST pending submission, whichever slot it
        parked in)."""
        oldest = None
        for q in self._q:
            if q:
                ts = ts_of(q[0][0])
                if oldest is None or ts < oldest:
                    oldest = ts
        return oldest

    def pop(self) -> Optional[Any]:
        if self.n == 0:
            return None
        nslot = len(self._q)
        empties = 0
        while True:
            s = self._cursor
            q = self._q[s]
            if not q:
                self._deficit[s] = 0     # leaving the active set
                self._cursor = (s + 1) % nslot
                self._fresh = True
                empties += 1
                if empties >= nslot:     # defensive; n > 0 excludes it
                    return None
                continue
            empties = 0
            if self._fresh:
                self._deficit[s] += self.quantum * self.weight[s]
                self._fresh = False
            item, cost = q[0]
            if cost <= self._deficit[s]:
                self._deficit[s] -= cost
                q.popleft()
                self.n -= 1
                return item
            self._cursor = (s + 1) % nslot   # out of deficit: yield
            self._fresh = True

    def drain_fifo(self) -> List[Any]:
        """Flush everything in plain slot-scan order (shutdown path:
        nothing may be stranded when fair mode winds down)."""
        out = []
        for q in self._q:
            while q:
                out.append(q.popleft()[0])
        self.n = 0
        return out

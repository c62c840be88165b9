"""Verdict cache: serve repeated tokens at memory speed.

The port of ``cap_tpu.serve.vcache``. Real ingress traffic for an auth
verifier is massively repetitive — the same bearer token arrives many
times within its lifetime. This module is the correctness-preserving caching
tier in front of the verify engines: a sharded, bounded map from
**token digest** (sha256 of the token bytes, truncated to 16 bytes —
collision-resistant, so digest equality IS token equality) to the
token's verdict, clamped so a cached entry can never outlive:

- the token's own ``exp`` (and never activate before ``nbf``) — both
  parsed once, at insert time, from the claims the accept carries;
- the key-table **epoch**: every entry is tagged with the epoch it was
  verified under; a keyplane rotation bumps the cache epoch atomically
  (:meth:`VerdictCache.bump_epoch`) and entries from the previous
  epoch survive only inside the rotation's grace window (default 0 —
  cached verdicts die IMMEDIATELY on rotation; the engines' own grace
  handling serves the re-verify);
- a hard TTL (``max_ttl_s``) as belt-and-braces bound for entries
  whose claims carry no ``exp``.

What is cached: **accepts** (the claims payload — for raw-claims
engines these are exactly the token's own payload bytes, so a cache
hit is byte-identical to a fresh verify by construction) and **only
terminal rejects** — reason classes where the verdict is a pure
function of the token bytes and the key material
(:data:`CACHEABLE_REJECTS`: bad_signature / malformed / not_signed).
Transient or environment-dependent classes (unknown_kid before a
refresh, jwks_error, transport, expired, internal) are NEVER cached:
the next arrival must reach an engine.

Any clamp uncertainty resolves to a MISS: the token goes to the
engine and the verdict is whatever the engine says — the cache can
change how fast a verdict is produced, never which verdict. A final
re-validation at serve time backs this with a tripwire counter
(``vcache.stale_accepts``, SLO-pinned to 0).

Counters (one ``count_many`` lock round per batched lookup):
``vcache.lookups == vcache.hits + vcache.misses`` exactly
plus inserts / evictions / epoch_bumps /
clamp_drops, and a ``vcache.size`` gauge on the worker scrape.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import telemetry
from ..obs import decision as _decision

DIGEST_LEN = 16

# Reject reason classes whose verdict depends only on the token bytes
# and the installed key tables — safe to replay until the epoch moves.
CACHEABLE_REJECTS = frozenset({
    _decision.REASON_BAD_SIGNATURE,
    _decision.REASON_MALFORMED,
    _decision.REASON_NOT_SIGNED,
})

_MISS = object()


def token_digest(token: Any) -> bytes:
    """The cache key: sha256 of the token's UTF-8 bytes, truncated to
    :data:`DIGEST_LEN`. The native serve chain computes the identical
    digest in its reader threads (serve_native.cpp) so the Python
    drain does zero hashing on that chain."""
    if isinstance(token, str):
        token = token.encode("utf-8", "surrogatepass")
    return hashlib.sha256(token).digest()[:DIGEST_LEN]


def _claims_exp_nbf(verdict: Any, token: Any) -> Tuple[Optional[float],
                                                       Optional[float]]:
    """(exp, nbf) for the clamp, best-effort: from the accept's claims
    (dict or raw payload bytes), else from the token's payload
    segment. Unparseable → (None, None): the TTL bound still applies."""
    claims = None
    if isinstance(verdict, dict):
        claims = verdict
    elif isinstance(verdict, (bytes, bytearray, memoryview)):
        try:
            claims = json.loads(bytes(verdict))
        except (ValueError, UnicodeDecodeError):
            claims = None
    if claims is None and isinstance(token, str):
        parts = token.split(".")
        if len(parts) >= 2:
            seg = parts[1]
            try:
                pad = "=" * (-len(seg) % 4)
                claims = json.loads(base64.urlsafe_b64decode(seg + pad))
            except (ValueError, binascii.Error, UnicodeDecodeError):
                claims = None
    if not isinstance(claims, dict):
        return (None, None)

    def _num(v):
        return float(v) if isinstance(v, (int, float)) \
            and not isinstance(v, bool) else None

    return (_num(claims.get("exp")), _num(claims.get("nbf")))


# Cache entries are plain tuples — the lookup hot loop indexes them
# without attribute-load overhead:
#   (verdict, valid_from, valid_until, epoch, exp)
# valid_from = nbf (0.0 when absent); valid_until = min(insert-time +
# max_ttl, exp) — the exp and TTL clamps collapse into ONE compare.
_E_VERDICT, _E_FROM, _E_UNTIL, _E_EPOCH, _E_EXP = range(5)


class VerdictCache:
    """Sharded bounded token-digest → verdict map with epoch/exp/nbf
    clamps. Thread-safe; every public entry point may be called from
    any serve/drain/client thread."""

    def __init__(self, capacity: int = 65536, shards: int = 16,
                 max_ttl_s: float = 300.0):
        # power-of-two shard count so digest[0] masks cleanly
        n = 1
        while n < max(1, shards):
            n <<= 1
        self._n_shards = n
        self._cap_per_shard = max(1, capacity // n)
        self._shards: List[Dict[bytes, _Entry]] = [{} for _ in range(n)]
        self._locks = [threading.Lock() for _ in range(n)]
        self._max_ttl = float(max_ttl_s)
        # epoch state: entries tagged `epoch` serve while it is the
        # current epoch, or while it is the PREVIOUS epoch inside the
        # grace window of the last bump. Anything older is invalid.
        self._epoch_lock = threading.Lock()
        self._epoch: Optional[int] = None
        self._prev_epoch: Optional[int] = None
        self._grace_until = 0.0
        # counter staging: folded into the active telemetry recorder
        # in one count_many round per batched operation
        self._ctr_lock = threading.Lock()
        self._ctr = {"vcache.lookups": 0, "vcache.hits": 0,
                     "vcache.misses": 0, "vcache.inserts": 0,
                     "vcache.insert_skips": 0, "vcache.evictions": 0,
                     "vcache.epoch_bumps": 0, "vcache.clamp_drops": 0,
                     "vcache.stale_accepts": 0,
                     "vcache.peer_fills": 0,
                     "vcache.peer_fill_skips": 0,
                     "vcache.peer_exports": 0}

    # -- epoch / invalidation ---------------------------------------------

    @property
    def epoch(self) -> Optional[int]:
        return self._epoch

    def set_epoch(self, epoch: Optional[int]) -> None:
        """Initial epoch install (construction time): no bump
        accounting, no grace — the cache is empty anyway."""
        with self._epoch_lock:
            self._epoch = epoch
            self._prev_epoch = None
            self._grace_until = 0.0

    def bump_epoch(self, epoch: Optional[int],
                   grace_s: float = 0.0) -> None:
        """Atomic invalidation on key rotation: entries verified under
        the (now previous) epoch stay valid for ``grace_s`` seconds,
        then die; entries from any older epoch are invalid at once.
        A no-op when the epoch is unchanged (re-pushes must not churn
        the cache)."""
        with self._epoch_lock:
            if epoch == self._epoch:
                return
            self._prev_epoch = self._epoch
            self._epoch = epoch
            self._grace_until = time.time() + max(0.0, grace_s)
        self._count({"vcache.epoch_bumps": 1})

    def _epoch_valid(self, entry_epoch: Optional[int],
                     now: float) -> bool:
        # unlocked read of the trio: a racing bump makes the check
        # CONSERVATIVE at worst (a just-valid entry misses)
        if entry_epoch == self._epoch:
            return True
        return (entry_epoch == self._prev_epoch
                and entry_epoch is not None
                and now < self._grace_until)

    # -- lookup -----------------------------------------------------------

    def _valid(self, e: tuple, now: float) -> bool:
        return (e[_E_FROM] <= now < e[_E_UNTIL]
                and self._epoch_valid(e[_E_EPOCH], now))

    def get(self, digest: bytes, now: Optional[float] = None) -> Any:
        """The verdict for one digest, or the module's miss sentinel
        (compare with ``vcache.MISS``). Single-key form of
        :meth:`lookup_batch` — counts exactly the same way."""
        hit = self._get_nocount(digest, now)
        self._count({"vcache.lookups": 1,
                     "vcache.hits": 0 if hit is _MISS else 1,
                     "vcache.misses": 1 if hit is _MISS else 0})
        return hit

    def _get_nocount(self, digest: bytes,
                     now: Optional[float] = None) -> Any:
        if now is None:
            now = time.time()
        s = digest[0] & (self._n_shards - 1)
        e = self._shards[s].get(digest)
        if e is None:
            return _MISS
        if not self._valid(e, now):
            with self._locks[s]:
                self._shards[s].pop(digest, None)
            self._stage("vcache.clamp_drops", 1)
            return _MISS
        verdict = e[_E_VERDICT]
        # serve-time tripwire: re-validate against a FRESH clock read
        # before the verdict leaves the cache — an accept that expired
        # between check and serve is dropped and counted, never served
        # (vcache.stale_accepts is SLO-pinned to 0).
        if not isinstance(verdict, BaseException) \
                and not self._valid(e, time.time()):
            self._stage("vcache.stale_accepts", 1)
            return _MISS
        return verdict

    def lookup_batch(self, tokens: Sequence[Any],
                     digests: Optional[Sequence[Optional[bytes]]] = None
                     ) -> Tuple[List[Any], List[int], List[bytes]]:
        """Consult the cache for a whole batch in one pass.

        Returns ``(results, miss_idx, digests)``: ``results`` has the
        cached verdict at hit positions and ``None`` at misses,
        ``miss_idx`` lists the miss positions (submit exactly these to
        the engine), ``digests`` the per-token digest (computed here
        unless the caller supplies them, e.g. from the native reader
        threads). One counter fold for the whole batch."""
        now = time.time()
        n = len(tokens)
        out: List[Any] = [None] * n
        miss_idx: List[int] = []
        digs: List[bytes] = [b""] * n
        # inlined hot loop (no per-token function calls): validity =
        # TTL deadline ∧ epoch/grace ∧ exp ∧ nbf, all against one
        # clock read; epoch trio snapshotted unlocked (a racing bump
        # makes the check conservative at worst)
        shards = self._shards
        locks = self._locks
        mask = self._n_shards - 1
        cur, prev, guntil = self._epoch, self._prev_epoch, \
            self._grace_until
        hits = 0
        drops = 0
        hit_entries: List[tuple] = []
        for i in range(n):
            d = digests[i] if digests is not None else None
            if not d:
                d = token_digest(tokens[i])
            digs[i] = d
            # unlocked read (GIL-atomic, same stance as the decision
            # header cache); the lock is taken only to delete
            e = shards[d[0] & mask].get(d)
            if e is not None:
                ep = e[3]
                if e[1] <= now < e[2] and (
                        ep == cur or (ep == prev and ep is not None
                                      and now < guntil)):
                    out[i] = e[0]
                    hits += 1
                    hit_entries.append((i, e))
                    continue
                s = d[0] & mask
                with locks[s]:
                    shards[s].pop(d, None)
                drops += 1
            miss_idx.append(i)
        # serve-time tripwire: ONE fresh clock read for the batch; an
        # accept whose exp crossed between check and serve is demoted
        # to a miss and counted (vcache.stale_accepts, SLO-pinned 0).
        stale = 0
        if hit_entries:
            now2 = time.time()
            for i, e in hit_entries:
                exp = e[4]
                if exp is not None and now2 >= exp:
                    out[i] = None
                    miss_idx.append(i)
                    hits -= 1
                    stale += 1
            if stale:
                miss_idx.sort()
        self._count({"vcache.lookups": n, "vcache.hits": hits,
                     "vcache.misses": n - hits,
                     "vcache.clamp_drops": drops,
                     "vcache.stale_accepts": stale})
        return out, miss_idx, digs

    # -- insert -----------------------------------------------------------

    def cacheable(self, verdict: Any) -> bool:
        """Whether a verdict may be cached at all: accepts always,
        rejects only for :data:`CACHEABLE_REJECTS` reason classes."""
        if isinstance(verdict, BaseException):
            return _decision.classify(verdict) in CACHEABLE_REJECTS
        return True

    def insert(self, digest: bytes, verdict: Any, token: Any = None,
               epoch: Optional[int] = None,
               now: Optional[float] = None) -> bool:
        """Insert one verdict; returns False (counted as a skip) when
        the verdict class is uncacheable, the entry is already expired,
        or ``epoch`` no longer matches the cache epoch (the verify
        raced a rotation — conservative drop)."""
        if now is None:
            now = time.time()
        if not self.cacheable(verdict) or epoch != self._epoch:
            self._count({"vcache.insert_skips": 1})
            return False
        exp, nbf = _claims_exp_nbf(verdict, token) \
            if not isinstance(verdict, BaseException) else (None, None)
        if exp is not None and now >= exp:
            self._count({"vcache.insert_skips": 1})
            return False
        until = now + self._max_ttl
        if exp is not None and exp < until:
            until = exp
        e = (verdict, nbf if nbf is not None else 0.0, until, epoch,
             exp)
        s = digest[0] & (self._n_shards - 1)
        evicted = 0
        with self._locks[s]:
            shard = self._shards[s]
            if digest not in shard and len(shard) >= self._cap_per_shard:
                # bounded: evict the oldest inserted (dict order)
                shard.pop(next(iter(shard)))
                evicted = 1
            shard[digest] = e
        self._count({"vcache.inserts": 1, "vcache.evictions": evicted})
        return True

    def insert_batch(self, digests: Sequence[bytes],
                     verdicts: Sequence[Any],
                     tokens: Optional[Sequence[Any]] = None,
                     epoch: Optional[int] = None) -> int:
        now = time.time()
        n_in = 0
        for i, d in enumerate(digests):
            if self.insert(d, verdicts[i],
                           token=tokens[i] if tokens is not None
                           else None,
                           epoch=epoch, now=now):
                n_in += 1
        return n_in

    # -- peer fill (fleet cache warming, CVB1 frame pair 13/14) -----------

    def export_entries(self, max_entries: int = 2048,
                       max_bytes: int = 768 * 1024
                       ) -> Tuple[List[list], Optional[int]]:
        """Dump currently-valid ACCEPT entries for a peer-fill
        transfer → (entries, epoch).

        Each entry is ``[digest_hex, payload_b64, valid_from,
        valid_until, exp_or_null]``. Accepts only: rejects are cheap
        to re-verify and their exception classes don't round-trip
        bit-exactly. Entries from a previous epoch (grace residue)
        are skipped — an export carries exactly ONE epoch, the
        current one, so the importer's clamp is a single equality.
        ``max_bytes`` approximates the wire bound so the frame can
        never exceed ``protocol.MAX_ENTRY_BYTES``."""
        now = time.time()
        epoch = self._epoch
        out: List[list] = []
        size = 0
        for shard in self._shards:
            if len(out) >= max_entries or size >= max_bytes:
                break
            # snapshot the dict (GIL-atomic list()) — exports race
            # inserts harmlessly; we only need a consistent-ish slice
            for digest, e in list(shard.items()):
                if len(out) >= max_entries or size >= max_bytes:
                    break
                verdict = e[_E_VERDICT]
                if isinstance(verdict, BaseException):
                    continue
                if e[_E_EPOCH] != epoch or not (e[_E_FROM] <= now
                                                < e[_E_UNTIL]):
                    continue
                if isinstance(verdict, (bytes, bytearray, memoryview)):
                    payload = bytes(verdict)
                else:
                    # exactly protocol._response_parts' encoding, so
                    # an imported hit is byte-identical on the wire
                    payload = json.dumps(
                        verdict, separators=(",", ":")).encode()
                row = [digest.hex(),
                       base64.b64encode(payload).decode("ascii"),
                       e[_E_FROM], e[_E_UNTIL], e[_E_EXP]]
                size += len(payload) + len(row[0]) + 48
                out.append(row)
        self._count({"vcache.peer_exports": len(out)})
        return out, epoch

    def import_entries(self, entries: Sequence[Sequence[Any]],
                       epoch: Any) -> int:
        """Install a peer's export, under the SAME clamps a local
        insert gets — warming can never extend a verdict's validity:

        - ``epoch`` must equal the cache's CURRENT epoch (a transfer
          racing a rotation is dropped whole — conservative);
        - per entry, ``valid_until`` is re-bounded by this cache's own
          ``now + max_ttl`` (min, never max) and already-expired or
          not-yet-valid windows are skipped;
        - the serve-time stale-accept tripwire applies to imported
          entries exactly as to local ones (they are ordinary entries).

        Returns how many entries were installed
        (``vcache.peer_fills``); clamped drops count
        ``vcache.peer_fill_skips``."""
        now = time.time()
        if epoch != self._epoch:
            self._count({"vcache.peer_fill_skips": len(entries)})
            return 0
        filled = 0
        skipped = 0
        evicted = 0
        for row in entries:
            try:
                digest = bytes.fromhex(row[0])
                payload = base64.b64decode(row[1])
                valid_from = float(row[2])
                valid_until = float(row[3])
                exp = float(row[4]) if row[4] is not None else None
            except (ValueError, TypeError, IndexError,
                    binascii.Error):
                skipped += 1
                continue
            until = min(valid_until, now + self._max_ttl)
            if exp is not None:
                until = min(until, exp)
            if len(digest) != DIGEST_LEN or now >= until:
                skipped += 1
                continue
            # re-check the epoch per entry: a rotation landing mid-
            # import invalidates the REST of the transfer, not just
            # the next lookup
            if epoch != self._epoch:
                skipped += len(entries) - filled - skipped
                break
            e = (payload, valid_from, until, epoch, exp)
            s = digest[0] & (self._n_shards - 1)
            with self._locks[s]:
                shard = self._shards[s]
                if digest not in shard \
                        and len(shard) >= self._cap_per_shard:
                    shard.pop(next(iter(shard)))
                    evicted += 1
                shard[digest] = e
            filled += 1
        self._count({"vcache.peer_fills": filled,
                     "vcache.peer_fill_skips": skipped,
                     "vcache.evictions": evicted})
        return filled

    # -- stats ------------------------------------------------------------

    def size(self) -> int:
        return sum(len(s) for s in self._shards)

    def stats(self) -> Dict[str, int]:
        """Lifetime counters (also folded into the telemetry recorder
        under the same names) plus the live size."""
        with self._ctr_lock:
            out = dict(self._ctr)
        out["vcache.size"] = self.size()
        return out

    def clear(self) -> None:
        for lock, shard in zip(self._locks, self._shards):
            with lock:
                shard.clear()

    # -- counter plumbing -------------------------------------------------

    def _stage(self, name: str, n: int) -> None:
        if not n:
            return
        with self._ctr_lock:
            self._ctr[name] += n
        telemetry.count(name, n)

    def _count(self, increments: Dict[str, int]) -> None:
        inc = {k: v for k, v in increments.items() if v}
        if not inc:
            return
        with self._ctr_lock:
            for k, v in inc.items():
                self._ctr[k] += v
        rec = telemetry.active()
        if rec is not None:
            rec.count_many(inc)


MISS = _MISS

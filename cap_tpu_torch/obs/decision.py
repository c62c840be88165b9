"""Decision records: WHY every token was accepted or rejected.

The port of ``cap_tpu.obs.decision``. It maps every exception a verify
surface can produce (the classes of :mod:`cap_tpu_torch.errors`) onto
a small, REGISTERED set of rejection-reason classes and folds each
verdict into:

- **reason-keyed mergeable counters** on the active telemetry
  recorder (``decision.<surface>.accept``,
  ``decision.<surface>.reject.<reason>``,
  ``decision.<surface>.family.<family>``) — these ride the STATS
  snapshot wire and add exactly when snapshots merge;
- a **sampled decision ring** (bounded, 256 entries per recorder):
  full records ``{surface, family, verdict, reason, lat, trace,
  kid}`` for the first occurrence of every (surface, reason) pair and
  a deterministic 1-in-16 sample after that.

The surfaces that record here: the card's batch engine
(``GPUBatchKeySet``, surface ``gpu``) and the serve worker (per
response batch). A worker rejection reaches a client as
``RemoteVerifyError`` whose payload is ``"<ErrorClass>: <message>"``
(serve/protocol.py), and the classifier parses that head back to the
class's reason, so the same reason is counted on both sides.

Redaction: reasons, families, and verdicts are registered enum
strings; kids are HASHED (sha256, 12 hex chars) before they touch the
recorder; trace ids are lowercase hex; latency is a bucket label.
``_checked_entry`` enforces this at the write boundary (anything
token-shaped raises), same stance as ``telemetry.check_name``.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import json
import threading
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence

from .. import telemetry

# ---------------------------------------------------------------------------
# rejection-reason classes (registered; docs/OBSERVABILITY.md pins this
# table; tests pin the mapping against cap_tpu_torch/errors.py)
# ---------------------------------------------------------------------------

REASON_MALFORMED = "malformed"            # unparseable / invalid structure
REASON_NOT_SIGNED = "not_signed"          # empty/absent signature
REASON_BAD_SIGNATURE = "bad_signature"    # signature check failed
REASON_UNKNOWN_KID = "unknown_kid"        # kid matches no known key
REASON_UNSUPPORTED_ALG = "unsupported_alg"
REASON_EXPIRED = "expired"                # exp / auth_time / request age
REASON_INVALID_CLAIMS = "invalid_claims"  # iss/aud/sub/nonce/azp/hashes
REASON_JWKS_ERROR = "jwks_error"          # key material unavailable/bad
REASON_OIDC_FLOW = "oidc_flow"            # RP flow violations
REASON_TRANSPORT = "transport"            # wire/socket/protocol failure
REASON_THROTTLED = "throttled"            # admission pushback (not a verdict)
REASON_INTERNAL = "internal"              # anything else (bug bucket)

REASON_CLASSES = frozenset({
    REASON_MALFORMED, REASON_NOT_SIGNED, REASON_BAD_SIGNATURE,
    REASON_UNKNOWN_KID, REASON_UNSUPPORTED_ALG, REASON_EXPIRED,
    REASON_INVALID_CLAIMS, REASON_JWKS_ERROR, REASON_OIDC_FLOW,
    REASON_TRANSPORT, REASON_THROTTLED, REASON_INTERNAL,
})

# FIXED-ORDER index form of the registry: the native telemetry plane
# (runtime/native/telemetry_native.cpp) counts by INDEX in a plain C
# struct region and the binding maps indices back to these names at
# scrape time. Order is part of the native ABI — append-only; the
# layout handshake in native_serve disables the plane on length drift.
# Like families, new reasons insert BEFORE "internal" (the native fold
# uses the LAST index as its out-of-range bucket).
REASON_INDEX = (
    REASON_MALFORMED, REASON_NOT_SIGNED, REASON_BAD_SIGNATURE,
    REASON_UNKNOWN_KID, REASON_UNSUPPORTED_ALG, REASON_EXPIRED,
    REASON_INVALID_CLAIMS, REASON_JWKS_ERROR, REASON_OIDC_FLOW,
    REASON_TRANSPORT, REASON_THROTTLED, REASON_INTERNAL,
)
_REASON_TO_INDEX = {r: i for i, r in enumerate(REASON_INDEX)}

# classify() resolved per exception TYPE (one dict hit on the reject
# path instead of an MRO walk per token). RemoteVerifyError is never
# cached: its reason depends on the MESSAGE head, not the type.
_REASON_IDX_BY_TYPE: Dict[type, int] = {}


def reason_index(err: BaseException) -> int:
    """Index of ``classify(err)`` in :data:`REASON_INDEX` (cached by
    exception type; the native fold consumes the index directly)."""
    t = type(err)
    if t.__name__ == "RemoteVerifyError":
        return _REASON_TO_INDEX[classify(err)]
    idx = _REASON_IDX_BY_TYPE.get(t)
    if idx is None:
        idx = _REASON_TO_INDEX[classify(err)]
        if len(_REASON_IDX_BY_TYPE) < 1024:
            _REASON_IDX_BY_TYPE[t] = idx
    return idx

# Exception CLASS NAME -> reason. Keyed by name (not type) so the
# classifier needs no imports from the crypto-dependent modules and so
# a wire-roundtripped error ("InvalidSignatureError: ...") classifies
# identically to the in-process instance — the four-surface parity
# contract. tests/test_obs_decision.py pins completeness over every
# CapError subclass in cap_tpu_torch/errors.py.
REASON_FOR_ERROR: Dict[str, str] = {
    # base (fallback for unmapped future subclasses via MRO walk)
    "CapError": REASON_INTERNAL,
    # structure / parameters
    "InvalidParameterError": REASON_MALFORMED,
    "NilParameterError": REASON_MALFORMED,
    "MalformedTokenError": REASON_MALFORMED,
    "TokenNotSignedError": REASON_NOT_SIGNED,
    "UnsupportedAlgError": REASON_UNSUPPORTED_ALG,
    # signature layer
    "InvalidSignatureError": REASON_BAD_SIGNATURE,
    "UnknownKeyIDError": REASON_UNKNOWN_KID,
    "IDTokenVerificationFailedError": REASON_BAD_SIGNATURE,
    # freshness
    "ExpiredTokenError": REASON_EXPIRED,
    "ExpiredRequestError": REASON_EXPIRED,
    "ExpiredAuthTimeError": REASON_EXPIRED,
    # claims validation
    "InvalidIssuerError": REASON_INVALID_CLAIMS,
    "InvalidSubjectError": REASON_INVALID_CLAIMS,
    "InvalidAudienceError": REASON_INVALID_CLAIMS,
    "InvalidNonceError": REASON_INVALID_CLAIMS,
    "InvalidNotBeforeError": REASON_INVALID_CLAIMS,
    "InvalidIssuedAtError": REASON_INVALID_CLAIMS,
    "InvalidAuthorizedPartyError": REASON_INVALID_CLAIMS,
    "InvalidAtHashError": REASON_INVALID_CLAIMS,
    "InvalidCodeHashError": REASON_INVALID_CLAIMS,
    "MissingClaimError": REASON_INVALID_CLAIMS,
    # key material
    "InvalidJWKSError": REASON_JWKS_ERROR,
    "InvalidCACertError": REASON_JWKS_ERROR,
    # OIDC relying-party flow
    "InvalidResponseStateError": REASON_OIDC_FLOW,
    "InvalidFlowError": REASON_OIDC_FLOW,
    "UnsupportedChallengeMethodError": REASON_OIDC_FLOW,
    "UnauthorizedRedirectURIError": REASON_OIDC_FLOW,
    "LoginFailedError": REASON_OIDC_FLOW,
    "UserInfoFailedError": REASON_OIDC_FLOW,
    "MissingIDTokenError": REASON_OIDC_FLOW,
    "MissingAccessTokenError": REASON_OIDC_FLOW,
    "IDGeneratorFailedError": REASON_INTERNAL,
    "NotFoundError": REASON_INTERNAL,
    # admission control (serve-time pushback; never a verify verdict)
    "ThrottledError": REASON_THROTTLED,
    # serve/fleet transport layer
    "ProtocolError": REASON_TRANSPORT,
    "MalformedFrameError": REASON_TRANSPORT,
    "FrameTooLargeError": REASON_TRANSPORT,
    "FrameCorruptError": REASON_TRANSPORT,
    "FleetExhaustedError": REASON_TRANSPORT,
    "ConnectionError": REASON_TRANSPORT,
    "TimeoutError": REASON_TRANSPORT,
    "OSError": REASON_TRANSPORT,
}


def classify(err: BaseException) -> str:
    """Map one rejection to its registered reason class.

    ``RemoteVerifyError`` (a worker rejection crossing the CVB1 wire)
    carries ``"<ErrorClass>: <message>"`` — the head is parsed back so
    the router increments the SAME reason the worker's engine did.
    Everything else walks the MRO by class name; unknown classes land
    in ``internal`` (never raises — classification must not be able to
    break a verify path).
    """
    if type(err).__name__ == "RemoteVerifyError":
        head = str(err).split(":", 1)[0].strip()
        return REASON_FOR_ERROR.get(head, REASON_INTERNAL)
    for klass in type(err).__mro__:
        reason = REASON_FOR_ERROR.get(klass.__name__)
        if reason is not None:
            return reason
    return REASON_INTERNAL


# ---------------------------------------------------------------------------
# tenant (issuer) attribution — the per-stream accounting admission
# control needs (arXiv 2112.02229 frames multi-tenant verify
# as filling a fixed-latency pipeline from competing request streams;
# the streams must be *countable* before they can be arbitrated)
# ---------------------------------------------------------------------------

# Tenant ids are sha256(iss)[:12] HASHES — the same redaction stance
# as hash_kid: records correlate per issuer without the issuer string
# (a URL, i.e. payload material) ever touching a recorder.
TENANT_HASH_LEN = 12

# Fixed-size tenant table: at most TENANT_CAP distinct issuer hashes
# get their own label; every later tenant routes to the "other"
# overflow bucket, so a hostile unique-issuer flood cannot blow up
# label cardinality. The cap is part of the native-plane ABI
# (telemetry_native.h N_TEN = TENANT_CAP + 2; layout handshake).
TENANT_CAP = 64
TENANT_NONE = "none"      # no/unparseable issuer claim
TENANT_OTHER = "other"    # table full — overflow bucket
TENANT_NONE_IDX = TENANT_CAP
TENANT_OTHER_IDX = TENANT_CAP + 1
N_TENANT = TENANT_CAP + 2

_MAX_PAYLOAD_SEG = 4096   # issuer parse bound (payloads > headers)
_MAX_ISS_LEN = 1024


class TenantTable:
    """Bounded issuer-hash → slot map (slots 0..TENANT_CAP-1).

    ``admit`` allocates first-come-first-served and routes everything
    past the cap to the overflow slot; the mapping is shared by the
    Python fold and the native plane (the plane counts by SLOT, the
    binding maps slots back to labels here at scrape time), so both
    folds attribute identically by construction. ``reset`` drops every
    mapping and counts the evictions (``tenant.table_evictions``) —
    the only way an admitted tenant ever leaves the table.
    """

    def __init__(self, cap: int = TENANT_CAP):
        self.cap = cap
        self._slots: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.evictions = 0

    def admit(self, tenant_hash: str) -> tuple:
        """(slot, label) for one raw issuer hash: its own slot + hash
        label while the table has room, the overflow slot + "other"
        after."""
        slot = self._slots.get(tenant_hash)
        if slot is not None:
            return (slot, tenant_hash)
        with self._lock:
            slot = self._slots.get(tenant_hash)
            if slot is not None:
                return (slot, tenant_hash)
            if len(self._slots) >= self.cap:
                return (TENANT_OTHER_IDX, TENANT_OTHER)
            slot = len(self._slots)
            self._slots[tenant_hash] = slot
            return (slot, tenant_hash)

    def label(self, slot: int) -> str:
        if slot == TENANT_NONE_IDX:
            return TENANT_NONE
        if slot == TENANT_OTHER_IDX:
            return TENANT_OTHER
        with self._lock:
            for h, s in self._slots.items():
                if s == slot:
                    return h
        return TENANT_OTHER

    def labels(self) -> Dict[int, str]:
        """slot → label for every allocated slot (plus none/other)."""
        with self._lock:
            out = {s: h for h, s in self._slots.items()}
        out[TENANT_NONE_IDX] = TENANT_NONE
        out[TENANT_OTHER_IDX] = TENANT_OTHER
        return out

    def size(self) -> int:
        return len(self._slots)

    def reset(self) -> int:
        """Drop every mapping; returns (and accumulates) the eviction
        count, mirrored onto the active recorder as
        ``tenant.table_evictions``."""
        with self._lock:
            n = len(self._slots)
            self._slots.clear()
            self.evictions += n
        if n:
            telemetry.count("tenant.table_evictions", n)
        return n


# The process-wide table (one per process = one per worker; the fleet
# view merges by LABEL, so slot numbering never crosses processes).
TENANTS = TenantTable()


def issuer_hash(iss: Any) -> str:
    """sha256(iss)[:12 hex] — or "none" for anything that is not a
    plausible issuer string (non-str, empty, over-long)."""
    if not isinstance(iss, str) or not iss or len(iss) > _MAX_ISS_LEN:
        return TENANT_NONE
    return hashlib.sha256(iss.encode("utf-8", "surrogatepass")) \
        .hexdigest()[:TENANT_HASH_LEN]


def token_tenant(token: Any) -> str:
    """Raw tenant hash for one token: the ``iss`` claim of its payload
    segment, hashed — "none" when the token has no parseable issuer.
    Bounded like the header parse (over-long segments are "none"
    without decoding). This is the ONE place issuer extraction
    happens: the native plane never parses payloads, it memoizes what
    this classifier produced."""
    if not isinstance(token, str):
        return TENANT_NONE
    parts = token.split(".")
    if len(parts) < 2:
        return TENANT_NONE
    seg = parts[1]
    if not seg or len(seg) > _MAX_PAYLOAD_SEG:
        return TENANT_NONE
    try:
        pad = "=" * (-len(seg) % 4)
        claims = json.loads(base64.urlsafe_b64decode(seg + pad))
    except (ValueError, binascii.Error, UnicodeDecodeError):
        return TENANT_NONE
    if not isinstance(claims, dict):
        return TENANT_NONE
    return issuer_hash(claims.get("iss"))


# ---------------------------------------------------------------------------
# family + kid extraction (bounded, cached — hot-path safe)
# ---------------------------------------------------------------------------

# Fixed-order family registry — like REASON_INDEX, the ORDER is part
# of the native telemetry plane's ABI (telemetry_native.h N_FAM /
# FAM_UNKNOWN): new families insert BEFORE "other"/"unknown" with a
# matching header bump + rebuild, and the cap_tel_layout handshake
# disables the plane on any drift.
FAMILIES = ("rs", "ps", "es", "ed", "mldsa44", "mldsa65", "mldsa87",
            "slhdsa128s", "slhdsa128f", "other", "unknown")

_FAMILY_FOR_ALG_PREFIX = {"RS": "rs", "PS": "ps", "ES": "es"}

# Post-quantum families: one registered family per parameter set so a
# hybrid-migration rollout can watch ES256 traffic drain and ML-DSA /
# SLH-DSA traffic ramp as separate counter series (docs/KEYPLANE.md).
_MLDSA_FAMILY = {"ML-DSA-44": "mldsa44", "ML-DSA-65": "mldsa65",
                 "ML-DSA-87": "mldsa87",
                 "SLH-DSA-SHAKE-128s": "slhdsa128s",
                 "SLH-DSA-SHAKE-128f": "slhdsa128f"}

# JOSE headers repeat massively across a token stream (one IdP = a
# handful of distinct headers), so (family, kid-hash, tenant-label)
# is cached by the raw header segment. The cache holds header TEXT as
# keys in memory only — nothing from it is ever recorded. Bounded:
# cleared at cap. The tenant slot is resolved LAZILY (None until a
# tenant-aware caller supplies a token whose payload carries the
# issuer) — attribution granularity is therefore per distinct header,
# which is what lets the native readers classify tenants at frame-
# parse time without ever parsing a payload in C.
_HDR_CACHE: Dict[str, tuple] = {}
_HDR_CACHE_CAP = 4096
_HDR_LOCK = threading.Lock()


def family_for_alg(alg: Optional[str]) -> str:
    # non-string alg values (e.g. a crafted header {"alg": 5}) must
    # classify, not raise — a TypeError here used to escape through
    # record_batch into the serve responder (found by the native-plane
    # parity sweep's adversarial corpus)
    if not alg or not isinstance(alg, str):
        return "unknown"
    if alg == "EdDSA":
        return "ed"
    fam = _MLDSA_FAMILY.get(alg)
    if fam is not None:
        return fam
    return _FAMILY_FOR_ALG_PREFIX.get(alg[:2], "other")


def hash_kid(kid: Optional[str]) -> Optional[str]:
    """12-hex one-way digest: correlates records without carrying the
    kid itself (kids can embed tenant/issuer hints)."""
    if not kid:
        return None
    return hashlib.sha256(str(kid).encode()).hexdigest()[:12]


def _parse_header_segment(seg: str) -> tuple:
    try:
        pad = "=" * (-len(seg) % 4)
        hdr = json.loads(base64.urlsafe_b64decode(seg + pad))
        if not isinstance(hdr, dict):
            return ("unknown", None)
        return (family_for_alg(hdr.get("alg")), hash_kid(hdr.get("kid")))
    except (ValueError, binascii.Error, UnicodeDecodeError):
        return ("unknown", None)


def _seg_family_kid(seg: Any) -> tuple:
    """(family, kid-hash-or-None) for one header SEGMENT (cached)."""
    if not isinstance(seg, str) or not seg or len(seg) > 1024:
        return ("unknown", None)
    hit = _HDR_CACHE.get(seg)
    if hit is not None:
        return hit[:2]
    out = _parse_header_segment(seg) + (None,)
    with _HDR_LOCK:
        if len(_HDR_CACHE) >= _HDR_CACHE_CAP:
            _HDR_CACHE.clear()
        _HDR_CACHE[seg] = out
    return out[:2]


def _seg_fkt(seg: Any, token: Any) -> tuple:
    """(family, kid-hash-or-None, tenant-label) for one header segment,
    resolving the tenant lazily from ``token``'s payload on the first
    tenant-aware sighting of the segment. The label is the table's
    DISPLAY label (hash while the tenant table has room, "other" once
    it overflowed, "none" without an issuer) captured at resolve time
    — stable for the cached lifetime of the segment, which is exactly
    what keeps the Python fold and the native plane bit-identical
    (fix_misses resolves through THIS function)."""
    if not isinstance(seg, str) or not seg or len(seg) > 1024:
        return ("unknown", None, TENANT_NONE)
    hit = _HDR_CACHE.get(seg)
    if hit is not None and hit[2] is not None:
        return hit
    fam, kid = hit[:2] if hit is not None else _parse_header_segment(seg)
    raw = token_tenant(token)
    label = raw if raw == TENANT_NONE else TENANTS.admit(raw)[1]
    out = (fam, kid, label)
    with _HDR_LOCK:
        if len(_HDR_CACHE) >= _HDR_CACHE_CAP:
            _HDR_CACHE.clear()
        _HDR_CACHE[seg] = out
    return out


def tenant_index(label: str) -> int:
    """The native-plane slot for a resolved tenant label (the inverse
    lives in ``TENANTS.labels()``)."""
    if label == TENANT_NONE:
        return TENANT_NONE_IDX
    if label == TENANT_OTHER:
        return TENANT_OTHER_IDX
    return TENANTS.admit(label)[0]


def tenant_labels(tokens: Sequence[Any]) -> List[str]:
    """Per-token tenant labels (header-segment cached — O(1) per
    repeated header). The python serve chain's cache tier uses this
    for its per-tenant vcache accounting."""
    out = []
    for t in tokens:
        seg = t.split(".", 1)[0] if isinstance(t, str) else None
        out.append(_seg_fkt(seg, t)[2])
    return out


def tenant_labels_from_slots(slots: Sequence[int]) -> List[str]:
    """Native-plane slot array → labels (the native serve chain's
    per-tenant vcache accounting; unresolved slots map to "none")."""
    labels = TENANTS.labels()
    return [labels.get(int(s), TENANT_NONE) for s in slots]


def token_family_kid(token: Any) -> tuple:
    """(family, kid-hash-or-None) from a token's header segment.

    O(1) per repeated header (cache hit); the parse itself is bounded
    (header segment > 1024 chars -> "unknown" without decoding).
    """
    if not isinstance(token, str):
        return ("unknown", None)
    return _seg_family_kid(token.split(".", 1)[0])


# ---------------------------------------------------------------------------
# latency buckets
# ---------------------------------------------------------------------------

_LAT_BUCKETS = ((0.001, "lt1ms"), (0.010, "lt10ms"), (0.100, "lt100ms"),
                (1.0, "lt1s"))


def latency_bucket(latency_s: Optional[float]) -> str:
    if latency_s is None:
        return "na"
    for bound, label in _LAT_BUCKETS:
        if latency_s < bound:
            return label
    return "ge1s"


# Fixed-order label table for the native plane (index form of
# latency_bucket; pinned against it by test).
LAT_BUCKET_INDEX = ("lt1ms", "lt10ms", "lt100ms", "lt1s", "ge1s", "na")


def latency_bucket_index(latency_s: Optional[float]) -> int:
    if latency_s is None:
        return 5
    for i, (bound, _label) in enumerate(_LAT_BUCKETS):
        if latency_s < bound:
            return i
    return 4


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

SURFACES = ("oracle", "gpu", "serve", "router", "frontdoor")

# Ring sampling: always the first record of a (surface, reason) pair,
# then every RING_SAMPLE_EVERY-th decision on that key (deterministic —
# derived from the counter value itself, no clock/randomness).
RING_SAMPLE_EVERY = 16

_MAX_FIELD_LEN = 64


def _checked_entry(entry: Dict[str, Any]) -> Dict[str, Any]:
    """Write-boundary redaction: every string field must be a short
    registered identifier — token-shaped or oversized values raise,
    the same stance as :func:`telemetry.check_name`."""
    for k, v in entry.items():
        if isinstance(v, str) and ("eyJ" in v or len(v) > _MAX_FIELD_LEN
                                   or any(ch.isspace() for ch in v)):
            raise ValueError(
                f"decision field {k!r} rejected by redaction rules")
    return entry


def record_batch(surface: str, results: Sequence[Any],
                 tokens: Optional[Sequence[Any]] = None,
                 families: Optional[Sequence[str]] = None,
                 latency_s: Optional[float] = None,
                 trace: Optional[str] = None) -> None:
    """Fold one batch of per-token verdicts into decision telemetry.

    results: the verify_batch contract — claims dict / raw payload
    bytes per accept, Exception per reject. tokens OR families supply
    the per-token family ("unknown" when neither is available, e.g.
    stub engines). No-op (one attribute check) while telemetry is off.
    """
    rec = telemetry.active()
    if rec is None or not results:
        return
    lat = latency_bucket(latency_s)
    if trace is None:
        trace = telemetry.current_trace()

    # AGGREGATED exact path (the serve hot loop calls this once per
    # drained chunk): one pass groups indices by decision key, family
    # counts come from a C-speed Counter over header segments, every
    # counter increments ONCE per group — the counters and the ring
    # SAMPLE POSITIONS are identical to k single-token walks (sampled
    # counts are c == 1 or c % RING_SAMPLE_EVERY == 0 over the same
    # post-increment sequence, attributed to the same token).
    reject_groups: Dict[str, List[int]] = {}
    if any(isinstance(r, BaseException) for r in results):
        accept_idx: Any = []
        for i, res in enumerate(results):
            if isinstance(res, BaseException):
                reject_groups.setdefault(classify(res), []).append(i)
            else:
                accept_idx.append(i)
    else:
        # all-accept fast path (the raw-claims serve hot loop): no
        # index list materialized — sampling indexes a range
        accept_idx = range(len(results))

    n_results = len(results)
    ten_counts: Counter = Counter()
    ten_of = None
    if families is not None:
        fam_counts = Counter(families)
        ten_counts[TENANT_NONE] = n_results

        def fam_kid(i: int) -> tuple:
            return (families[i], None)
    elif tokens is not None:
        try:
            segs: List[Any] = [t.split(".", 1)[0] for t in tokens]
        except AttributeError:      # non-str tokens: guarded walk
            segs = [t.split(".", 1)[0] if isinstance(t, str) else None
                    for t in tokens]
        seg_counts = Counter(segs)
        # tenant resolution rides the SAME per-distinct-segment pass:
        # the first occurrence of a segment in the chunk supplies the
        # payload the issuer comes from (exactly what the native
        # plane's fix_misses does — parity by construction)
        seg_first: Dict[Any, int] = {}
        for i, seg in enumerate(segs):
            if seg not in seg_first:
                seg_first[seg] = i
        seg_fk = {seg: _seg_fkt(seg, tokens[seg_first[seg]])
                  for seg in seg_counts}
        fam_counts = Counter()
        for seg, k in seg_counts.items():
            fam_counts[seg_fk[seg][0]] += k
            ten_counts[seg_fk[seg][2]] += k

        def fam_kid(i: int) -> tuple:
            return seg_fk[segs[i]][:2]

        def ten_of(i: int) -> str:
            return seg_fk[segs[i]][2]
    else:
        fam_counts = Counter({"unknown": len(results)})
        ten_counts[TENANT_NONE] = n_results

        def fam_kid(i: int) -> tuple:
            return ("unknown", None)

    increments = {f"decision.{surface}.family.{fam}": k
                  for fam, k in fam_counts.items()}
    # per-tenant accounting: tokens / accept / reject(+reason) per
    # resolved tenant label, plus the exact global equation
    # tenant.lookups == tenant.attributed + tenant.overflow
    if n_results:
        overflow = ten_counts.get(TENANT_OTHER, 0)
        increments["tenant.lookups"] = n_results
        if n_results - overflow:
            increments["tenant.attributed"] = n_results - overflow
        if overflow:
            increments["tenant.overflow"] = overflow
    for t, k in ten_counts.items():
        increments[f"decision.{surface}.tenant.{t}.tokens"] = k
    if reject_groups and ten_of is not None:
        rej_ten: Dict[str, Counter] = {}
        ten_rejects: Counter = Counter()
        for reason, idxs in reject_groups.items():
            c = Counter(ten_of(i) for i in idxs)
            rej_ten[reason] = c
            ten_rejects.update(c)
        for t, k in ten_rejects.items():
            increments[f"decision.{surface}.tenant.{t}.reject"] = k
        for reason, c in rej_ten.items():
            for t, k in c.items():
                increments[
                    f"decision.{surface}.tenant.{t}.reject.{reason}"] = k
        for t, k in ten_counts.items():
            acc = k - ten_rejects.get(t, 0)
            if acc:
                increments[f"decision.{surface}.tenant.{t}.accept"] = acc
    elif reject_groups:
        # families-only / token-less chunks attribute to "none"
        n_rej = sum(len(v) for v in reject_groups.values())
        increments[f"decision.{surface}.tenant.{TENANT_NONE}.reject"] \
            = n_rej
        for reason, idxs in reject_groups.items():
            increments[f"decision.{surface}.tenant.{TENANT_NONE}"
                       f".reject.{reason}"] = len(idxs)
        if n_results - n_rej:
            increments[f"decision.{surface}.tenant.{TENANT_NONE}"
                       ".accept"] = n_results - n_rej
    else:
        for t, k in ten_counts.items():
            increments[f"decision.{surface}.tenant.{t}.accept"] = k
    accept_key = f"decision.{surface}.accept"
    if accept_idx:
        increments[accept_key] = len(accept_idx)
    for reason, idxs in reject_groups.items():
        increments[f"decision.{surface}.reject.{reason}"] = len(idxs)
    # one lock round for the whole chunk's counters
    post = rec.count_many(increments)
    # per-tenant latency histograms (serve surface only — the worker
    # side is where verification latency is real; router/front-door
    # views come from merged worker snapshots): every token of the
    # chunk observes the chunk latency into its tenant's series, as
    # ONE bucket add of k per tenant (sum += value * k, the exact
    # arithmetic the native plane replicates)
    if surface == "serve" and latency_s is not None:
        for t, k in ten_counts.items():
            rec.observe_many(f"tenant.{t}.request_s", latency_s, k)

    def bulk(key: str, idxs, verdict: str,
             reason: Optional[str]) -> None:
        k = len(idxs)
        after = post[key]
        start = after - k
        sampled = [1] if start == 0 else []
        m = (start // RING_SAMPLE_EVERY + 1) * RING_SAMPLE_EVERY
        while m <= after:
            sampled.append(m)
            m += RING_SAMPLE_EVERY
        for c in sampled:
            fam, kid = fam_kid(idxs[c - start - 1])
            entry: Dict[str, Any] = {
                "surface": surface, "family": fam, "verdict": verdict,
                "lat": lat,
            }
            if reason is not None:
                entry["reason"] = reason
            if kid is not None:
                entry["kid"] = kid
            if trace is not None:
                entry["trace"] = trace
            rec.decision(_checked_entry(entry))

    if accept_idx:
        bulk(f"decision.{surface}.accept", accept_idx, "accept", None)
    for reason, idxs in reject_groups.items():
        bulk(f"decision.{surface}.reject.{reason}", idxs, "reject",
             reason)


def entry_from_exemplar(key: int, fam_idx: int, lat_idx: int,
                        kid: Optional[str],
                        trace: Optional[str]) -> Dict[str, Any]:
    """One ring entry from a native-plane exemplar record.

    ``key`` is 0 for accept, ``1 + reason_index`` for a reject — the
    fields come out exactly as :func:`record_batch`'s ``bulk`` builds
    them.
    """
    entry: Dict[str, Any] = {
        "surface": "serve",
        "family": FAMILIES[fam_idx],
        "verdict": "accept" if key == 0 else "reject",
        "lat": LAT_BUCKET_INDEX[lat_idx],
    }
    if key:
        entry["reason"] = REASON_INDEX[key - 1]
    if kid:
        entry["kid"] = kid
    if trace:
        entry["trace"] = trace
    return _checked_entry(entry)


def record_one(surface: str, result: Any, token: Optional[str] = None,
               latency_s: Optional[float] = None,
               trace: Optional[str] = None) -> None:
    record_batch(surface, [result],
                 tokens=None if token is None else [token],
                 latency_s=latency_s, trace=trace)


def record_wrong_verdict(token: Any = None, n: int = 1) -> None:
    """Count a verdict conflict caught by a cross-check — globally
    (``decision.wrong_verdicts``, the zero-tolerance SLO) AND per
    tenant (``decision.tenant.<t>.wrong_verdicts``, the per-tenant
    zero-tolerance default rule) when the offending token is known."""
    rec = telemetry.active()
    if rec is None or n <= 0:
        return
    inc = {"decision.wrong_verdicts": n}
    if token is not None:
        seg = token.split(".", 1)[0] if isinstance(token, str) else None
        label = _seg_fkt(seg, token)[2]
        inc[f"decision.tenant.{label}.wrong_verdicts"] = n
    rec.count_many(inc)


def count_tenant_cache(labels: Sequence[str],
                       miss_idx: Sequence[int]) -> None:
    """Fold one vcache consult into per-tenant hit accounting
    (``vcache.tenant.<t>.lookups`` / ``.hits``) — what capstat's
    tenant ledger renders as per-tenant hit%. One count_many round
    per batch; a no-op while telemetry is off."""
    rec = telemetry.active()
    if rec is None or not labels:
        return
    lookups = Counter(labels)
    hits = lookups - Counter(labels[i] for i in miss_idx)
    inc = {}
    for t, k in lookups.items():
        inc[f"vcache.tenant.{t}.lookups"] = k
    for t, k in hits.items():
        if k:
            inc[f"vcache.tenant.{t}.hits"] = k
    rec.count_many(inc)


# ---------------------------------------------------------------------------
# read side helpers (capstat / obs_smoke)
# ---------------------------------------------------------------------------


def decision_counters(counters: Dict[str, int]) -> Dict[str, int]:
    """The ``decision.*`` subset of a counter map (snapshot or merged)."""
    return {k: v for k, v in sorted(counters.items())
            if k.startswith("decision.")}


def surface_totals(counters: Dict[str, int]) -> Dict[str, Dict[str, int]]:
    """Per-surface {accept, reject, reject.<reason>...} rollup from a
    (merged) counter map — what capstat renders as the verdict table."""
    out: Dict[str, Dict[str, int]] = {}
    for k, v in counters.items():
        if not k.startswith("decision."):
            continue
        parts = k.split(".")
        # tenant-keyed counters (decision.<surface>.tenant.<t>.* and
        # decision.tenant.<t>.wrong_verdicts) have their own rollup
        # (tenant_totals) — they must not double into the surface view
        if len(parts) < 3 or parts[1] == "tenant" \
                or parts[2] in ("family", "tenant"):
            continue
        surf = parts[1]
        row = out.setdefault(surf, {"accept": 0, "reject": 0})
        if parts[2] == "accept":
            row["accept"] += int(v)
        elif parts[2] == "reject" and len(parts) >= 4:
            row["reject"] += int(v)
            row[f"reject.{parts[3]}"] = row.get(f"reject.{parts[3]}", 0) \
                + int(v)
    return out


def tenant_totals(counters: Dict[str, int],
                  surface: Optional[str] = None
                  ) -> Dict[str, Dict[str, int]]:
    """Per-tenant rollup from a (merged) counter map: tenant label →
    {tokens, accept, reject, reject.<reason>…, wrong_verdicts,
    vcache.lookups, vcache.hits}. ``surface`` narrows the decision
    counters to one surface (capstat's ledger uses "serve" — worker-
    side truth); None sums every surface."""
    out: Dict[str, Dict[str, int]] = {}

    def row(t: str) -> Dict[str, int]:
        return out.setdefault(t, {"tokens": 0, "accept": 0,
                                  "reject": 0})

    for k, v in counters.items():
        parts = k.split(".")
        if k.startswith("decision.tenant.") and len(parts) == 4 \
                and parts[3] == "wrong_verdicts":
            r = row(parts[2])
            r["wrong_verdicts"] = r.get("wrong_verdicts", 0) + int(v)
            continue
        if k.startswith("vcache.tenant.") and len(parts) == 4:
            r = row(parts[2])
            key = f"vcache.{parts[3]}"
            r[key] = r.get(key, 0) + int(v)
            continue
        if not k.startswith("decision.") or len(parts) < 5 \
                or parts[2] != "tenant":
            continue
        if surface is not None and parts[1] != surface:
            continue
        t = parts[3]
        r = row(t)
        what = parts[4]
        if what == "tokens":
            r["tokens"] += int(v)
        elif what == "accept":
            r["accept"] += int(v)
        elif what == "reject":
            if len(parts) >= 6:
                r[f"reject.{parts[5]}"] = r.get(f"reject.{parts[5]}", 0) \
                    + int(v)
            else:
                r["reject"] += int(v)
    return out


def nonzero_check(counters: Dict[str, int],
                  surfaces: Sequence[str]) -> List[str]:
    """obs-smoke's gate: every listed surface must have counted BOTH an
    accept and a reject for the driven mixed batch. Returns problem
    strings (empty = healthy)."""
    problems = []
    rollup = surface_totals(counters)
    for surf in surfaces:
        row = rollup.get(surf)
        if row is None:
            problems.append(f"surface {surf}: no decision counters at all")
            continue
        if row["accept"] <= 0:
            problems.append(f"surface {surf}: zero accept decisions")
        if row["reject"] <= 0:
            problems.append(f"surface {surf}: zero reject decisions")
    return problems

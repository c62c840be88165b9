"""ctypes binding and drain loop for the native (C++) serve chain.

The port of ``cap_tpu.serve.native_serve``. ``serve_native.cpp`` (the
``serve`` target of :mod:`cap_tpu_torch._build`, one library with the
telemetry plane, the shm rings and the JOSE prep's SHA-256) owns the
per-token serve hot path: per-connection reader threads parse and
validate CVB1 frames without the GIL and feed a bounded lock-free MPSC
ring; per-connection writer threads encode and send responses in
strict request order. Python's only per-token work is slicing the
drained token blob into strings and joining verdict payloads back into
one buffer — everything else crosses the boundary as whole batches:

    drain()  → one flat buffer of tokens + request descriptors
    batcher  → one submission per drained chunk (no per-token or
               per-request callbacks; ``AdaptiveBatcher.submit_handoff``)
    post()   → one call with every verdict of the chunk

The drain thread only hands a chunk to the batcher: the batcher's
dispatcher thread runs ``verify_batch_async_raw`` and any wait on the
card, so the ring keeps draining while a chunk verifies.

Control frames (stats requests, KEYS pushes, peer fills) ride the
SAME ring in frame order, so a keys push still applies before any
verify read after it, exactly like the Python chain's reader-thread
apply. Pings are answered natively without waking Python at all.

Where the JAX package degrades, this one raises: every symbol group
(the telemetry plane, the reader digests, shm, fair scheduling and
admission, the occupancy stamps) is built from the port's own sources,
so a failed build raises ``RuntimeError`` and a missing symbol or a
drifted layout ``ImportError``; no ``*_fallbacks`` counter stands in
for either. The front door's symbols are not bound here. The native
telemetry plane is an argument (``native_obs``) where the JAX package
reads ``CAP_SERVE_NATIVE_OBS``. Like the Python chain, the drain caches
no accept verified while the engine's grace window is open
(``grace_fn``).
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
import time
from typing import Any, Callable, List, Optional

import numpy as np

from .. import _build
from .. import telemetry
from ..obs import decision as _decision
from . import protocol

_SYMBOLS = ("cap_serve_create", "cap_serve_destroy", "cap_serve_add_conn",
            "cap_serve_drain", "cap_serve_post_results",
            "cap_serve_post_raw", "cap_serve_ring_depth",
            "cap_serve_counter", "cap_serve_probe_frame")

# The telemetry plane (telemetry_native.cpp).
_TEL_SYMBOLS = ("cap_tel_layout", "cap_tel_create", "cap_tel_destroy",
                "cap_tel_classify_seg", "cap_tel_learn", "cap_tel_fold",
                "cap_tel_hist_observe", "cap_tel_counters",
                "cap_tel_hist_state", "cap_tel_drain_exemplars",
                "cap_tel_reset", "cap_serve_set_telemetry",
                "cap_serve_drain_aux", "cap_serve_post_results_tel",
                "cap_serve_ring_hwm",
                # the tenant-attribution block
                "cap_tel_layout_ten", "cap_tel_tenant_counters",
                "cap_tel_tenant_hist_state", "cap_serve_drain_tens")

# The readers' verdict-cache digests (sha256(token)[:16]).
_VC_SYMBOLS = ("cap_serve_set_digests", "cap_serve_drain_digests")

# The shared-memory transport (shm_ring.cpp).
_SHM_SYMBOLS = ("cap_serve_set_shm", "cap_shm_create", "cap_shm_open",
                "cap_shm_close", "cap_shm_probe", "cap_shm_write",
                "cap_shm_read")

# Tenant-fair DRR scheduling and token-bucket admission.
_SCHED_SYMBOLS = ("cap_serve_layout_sched", "cap_serve_set_fair",
                  "cap_serve_set_weight", "cap_serve_set_admission",
                  "cap_serve_set_tenant_scale", "cap_serve_adm_take",
                  "cap_serve_bucket_fill", "cap_serve_drain_thr",
                  "cap_drr_create", "cap_drr_set_weight",
                  "cap_drr_push", "cap_drr_pop", "cap_drr_destroy")

# The occupancy plane's reader-side enqueue stamps.
_OCC_SYMBOLS = ("cap_serve_layout_occ", "cap_serve_drain_enq")

# exemplar record stride (telemetry_native.h EX_STRIDE)
_EX_STRIDE = 88
_KID_LEN = 12
_DIG_LEN = 16
_ZERO_DIG = b"\x00" * _DIG_LEN

# counter slots, mirroring serve_native.cpp
CTR_CONNS = 0
CTR_FRAMES = 1
CTR_TOKENS = 2
CTR_PROTO_ERR = 3
CTR_PONGS = 4
CTR_DROPPED_POSTS = 5
CTR_CONNS_CLOSED = 6
CTR_SHM_ATTACHES = 7
CTR_SHM_FALLBACKS = 8
CTR_SHM_FRAMES = 9
CTR_SHM_STALE_GEN = 10
CTR_SHM_DETACHES = 11
CTR_ADM_CHECKED = 12
CTR_ADM_ADMITTED = 13
CTR_ADM_THROTTLED = 14

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)

_lib = None
_lib_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """Load (building on first use) and type-check the ``serve``
    library. A failed build raises ``RuntimeError``; a missing symbol
    or a layout that drifted from the Python registries
    ``ImportError``."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = _build.load("serve")
        missing = [s for s in (_SYMBOLS + _TEL_SYMBOLS + _VC_SYMBOLS
                               + _SHM_SYMBOLS + _SCHED_SYMBOLS
                               + _OCC_SYMBOLS) if not hasattr(lib, s)]
        if missing:
            raise ImportError("the serve library lacks "
                              + ", ".join(missing))
        lib.cap_serve_create.restype = ctypes.c_void_p
        lib.cap_serve_create.argtypes = [ctypes.c_int32, ctypes.c_int64]
        lib.cap_serve_destroy.argtypes = [ctypes.c_void_p]
        lib.cap_serve_add_conn.restype = ctypes.c_int32
        lib.cap_serve_add_conn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.cap_serve_ring_depth.restype = ctypes.c_int64
        lib.cap_serve_ring_depth.argtypes = [ctypes.c_void_p]
        lib.cap_serve_counter.restype = ctypes.c_int64
        lib.cap_serve_counter.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.cap_serve_drain.restype = ctypes.c_int64
        lib.cap_serve_drain.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, _u8p, ctypes.c_int64,
            _i64p, _i32p, _i64p, _f64p, _u8p, ctypes.c_int32, _i64p]
        lib.cap_serve_post_results.restype = ctypes.c_int32
        lib.cap_serve_post_results.argtypes = [
            ctypes.c_void_p, _i32p, _i64p, _u8p, ctypes.c_int32,
            _u8p, _u8p, _i64p]
        lib.cap_serve_post_raw.restype = ctypes.c_int32
        lib.cap_serve_post_raw.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, _u8p,
            ctypes.c_int64]
        lib.cap_serve_probe_frame.restype = ctypes.c_int32
        lib.cap_serve_probe_frame.argtypes = [_u8p, ctypes.c_int64, _i64p]
        _setup_tel(lib)
        _setup_vc(lib)
        _setup_shm(lib)
        _setup_sched(lib)
        _setup_occ(lib)
        _lib = lib
        return lib


def _layout(fn, n: int) -> tuple:
    out = np.zeros(n, np.int32)
    fn(out.ctypes.data_as(_i32p))
    return tuple(int(v) for v in out)


def _check_layout(what: str, got: tuple, want: tuple) -> None:
    if got != want:
        raise ImportError(f"the serve library's {what} layout {got} "
                          f"drifted from the registries' {want}")


def _setup_tel(lib: ctypes.CDLL) -> None:
    """Type the telemetry-plane symbols and check that the plane's
    index vocabularies match the Python registries."""
    lib.cap_tel_layout.argtypes = [_i32p]
    lib.cap_tel_layout_ten.argtypes = [_i32p]
    lib.cap_tel_create.restype = ctypes.c_void_p
    lib.cap_tel_create.argtypes = [_f64p, ctypes.c_int32]
    lib.cap_tel_destroy.argtypes = [ctypes.c_void_p]
    lib.cap_tel_classify_seg.restype = ctypes.c_int32
    lib.cap_tel_classify_seg.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int64, _u8p, _i32p, _i16p]
    lib.cap_tel_learn.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int64, ctypes.c_int32, _u8p,
        ctypes.c_int32, ctypes.c_int32]
    lib.cap_tel_fold.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _u8p, _u8p, _i8p, _i16p,
        _u8p, ctypes.c_int32, ctypes.c_double, _u8p, ctypes.c_int32]
    lib.cap_tel_hist_observe.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_double]
    lib.cap_tel_counters.argtypes = [ctypes.c_void_p, _i64p]
    lib.cap_tel_tenant_counters.argtypes = [ctypes.c_void_p, _i64p]
    lib.cap_tel_hist_state.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, _i64p, _i64p, _f64p, _f64p,
        _f64p]
    lib.cap_tel_tenant_hist_state.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, _i64p, _i64p, _f64p, _f64p,
        _f64p]
    lib.cap_tel_drain_exemplars.restype = ctypes.c_int32
    lib.cap_tel_drain_exemplars.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int32]
    lib.cap_tel_reset.argtypes = [ctypes.c_void_p]
    lib.cap_serve_set_telemetry.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p]
    lib.cap_serve_drain_aux.restype = ctypes.c_int64
    lib.cap_serve_drain_aux.argtypes = [
        ctypes.c_void_p, _i8p, _u8p, ctypes.c_int64]
    lib.cap_serve_drain_tens.restype = ctypes.c_int64
    lib.cap_serve_drain_tens.argtypes = [
        ctypes.c_void_p, _i16p, ctypes.c_int64]
    lib.cap_serve_post_results_tel.restype = ctypes.c_int32
    lib.cap_serve_post_results_tel.argtypes = [
        ctypes.c_void_p, _i32p, _i64p, _u8p, _f64p, ctypes.c_int32,
        _u8p, _u8p, _i64p, _u8p, _i8p, _i16p, _u8p, ctypes.c_int32,
        ctypes.c_double]
    lib.cap_serve_ring_hwm.restype = ctypes.c_int64
    lib.cap_serve_ring_hwm.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    # layout handshake: reason/family/latency vocabularies are indexed
    # in the C structs; a drift raises rather than miscount
    n_reason, n_fam = len(_decision.REASON_INDEX), len(_decision.FAMILIES)
    _check_layout("telemetry", _layout(lib.cap_tel_layout, 8),
                  (n_reason, n_fam, len(_decision.LAT_BUCKET_INDEX),
                   1 + n_reason + n_fam + 3, _EX_STRIDE, 2,
                   _decision.RING_SAMPLE_EVERY,
                   telemetry.MAX_DECISION_ENTRIES))
    # the bounded tenant table's slot layout is ABI too
    ten_stride = 3 + n_reason
    _check_layout("tenant", _layout(lib.cap_tel_layout_ten, 4),
                  (_decision.N_TENANT, ten_stride,
                   3 + _decision.N_TENANT * ten_stride,
                   _decision.TENANT_OTHER_IDX))


def _setup_vc(lib: ctypes.CDLL) -> None:
    """Type the verdict-cache digest symbols."""
    lib.cap_serve_set_digests.argtypes = [ctypes.c_void_p,
                                          ctypes.c_int32]
    lib.cap_serve_drain_digests.restype = ctypes.c_int64
    lib.cap_serve_drain_digests.argtypes = [ctypes.c_void_p, _u8p,
                                            ctypes.c_int64]


def _setup_shm(lib: ctypes.CDLL) -> None:
    """Type the shm-transport symbols."""
    lib.cap_serve_set_shm.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.cap_shm_create.restype = ctypes.c_void_p
    lib.cap_shm_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int32]
    lib.cap_shm_open.restype = ctypes.c_void_p
    lib.cap_shm_open.argtypes = [ctypes.c_char_p]
    lib.cap_shm_close.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.cap_shm_probe.restype = ctypes.c_int32
    lib.cap_shm_probe.argtypes = [ctypes.c_char_p]
    lib.cap_shm_write.restype = ctypes.c_int64
    lib.cap_shm_write.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                  _u8p, ctypes.c_int64,
                                  ctypes.c_double]
    lib.cap_shm_read.restype = ctypes.c_int64
    lib.cap_shm_read.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                 _u8p, ctypes.c_int64, ctypes.c_double]


def _setup_sched(lib: ctypes.CDLL) -> None:
    """Type the fair-scheduling/admission symbols and check the slot
    layout."""
    lib.cap_serve_layout_sched.argtypes = [_i32p]
    lib.cap_serve_set_fair.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                       ctypes.c_int64]
    lib.cap_serve_set_weight.argtypes = [ctypes.c_void_p,
                                         ctypes.c_int32, ctypes.c_int32]
    lib.cap_serve_set_admission.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_double,
        ctypes.c_double]
    lib.cap_serve_set_tenant_scale.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_double]
    lib.cap_serve_adm_take.restype = ctypes.c_int32
    lib.cap_serve_adm_take.argtypes = [ctypes.c_void_p,
                                       ctypes.c_int32, _i32p]
    lib.cap_serve_bucket_fill.restype = ctypes.c_double
    lib.cap_serve_bucket_fill.argtypes = [ctypes.c_void_p,
                                          ctypes.c_int32]
    lib.cap_serve_drain_thr.restype = ctypes.c_int64
    lib.cap_serve_drain_thr.argtypes = [ctypes.c_void_p, _u8p,
                                        ctypes.c_int64]
    lib.cap_drr_create.restype = ctypes.c_void_p
    lib.cap_drr_create.argtypes = [ctypes.c_int64]
    lib.cap_drr_set_weight.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                       ctypes.c_int32]
    lib.cap_drr_push.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                 ctypes.c_int64]
    lib.cap_drr_pop.restype = ctypes.c_int64
    lib.cap_drr_pop.argtypes = [ctypes.c_void_p]
    lib.cap_drr_destroy.argtypes = [ctypes.c_void_p]
    _check_layout("scheduler", _layout(lib.cap_serve_layout_sched, 4),
                  (_decision.TENANT_CAP + 1, _decision.TENANT_CAP,
                   _decision.N_TENANT, 15))


def _setup_occ(lib: ctypes.CDLL) -> None:
    """Type the occupancy-plane symbols and check the per-request
    stamp layout."""
    lib.cap_serve_layout_occ.argtypes = [_i32p]
    lib.cap_serve_drain_enq.restype = ctypes.c_int64
    lib.cap_serve_drain_enq.argtypes = [ctypes.c_void_p, _f64p,
                                        ctypes.c_int64]
    _check_layout("occupancy", _layout(lib.cap_serve_layout_occ, 2),
                  (1, 1))


def probe_frame(data: bytes) -> int:
    """Classify one complete frame with the NATIVE parser → PF status
    (0 ok; see protocol.NATIVE_STATUS_ERRORS for the class map). The
    malformed-frame parity sweep drives this against
    ``protocol.parse_frame_bytes``."""
    lib = load()
    buf = np.frombuffer(bytearray(data), np.uint8) if data else \
        np.zeros(1, np.uint8)
    return int(lib.cap_serve_probe_frame(
        buf.ctypes.data_as(_u8p), len(data), None))


class NativeTelemetryPlane:
    """Binding for the native telemetry plane (telemetry_native.cpp).

    The plane holds the serve surface's decision counters, log-bucket
    histograms, and sampled-exemplar ring in a plain C struct region
    the GIL never touches. This class is the Python edge of it:

    - ``fix_misses`` resolves header-cache misses with the REAL
      classifier (``obs/decision._seg_family_kid``) and teaches the
      native cache — family attribution is therefore bit-exact by
      construction, the cache only ever holds Python-computed values;
    - ``pump`` drains sampled exemplars into the active recorder's
      decision ring (same entries ``record_batch`` would have built);
    - ``snapshot`` emits the plane's state as a MERGEABLE telemetry
      snapshot — scrape paths fold it in with ``merge_snapshots``, so
      fleet quantiles and counter totals stay exact.

    Standalone use (``fold_batch``) exists for the fuzz parity sweep:
    it drives the same classify → learn → fold path the serve chain
    uses, without sockets.
    """

    SERIES_NAMES = ("serve.native.request_s", "serve.native.chunk_tokens")
    _FAM_UNKNOWN = len(_decision.FAMILIES) - 1

    def __init__(self, lib: Optional[ctypes.CDLL] = None):
        self._lib = lib if lib is not None else load()
        bounds = np.asarray(telemetry.BUCKET_BOUNDS, np.float64)
        self._n_buckets = len(bounds) + 1
        self._h: Optional[ctypes.c_void_p] = ctypes.c_void_p(
            self._lib.cap_tel_create(bounds.ctypes.data_as(_f64p),
                                     len(bounds)))
        if not self._h:
            raise ImportError("cap_tel_create failed")
        # True until attached to a serve handle (which then owns the
        # free); standalone planes free themselves in destroy().
        self._owned = True
        self._fam_to_idx = {f: i for i, f
                            in enumerate(_decision.FAMILIES)}
        n_reason = len(_decision.REASON_INDEX)
        self._ctr_names = (
            ["decision.serve.accept"]
            + [f"decision.serve.reject.{r}"
               for r in _decision.REASON_INDEX]
            + [f"decision.serve.family.{f}" for f in _decision.FAMILIES]
            + ["serve.native.hdr_cache_hits",
               "serve.native.hdr_cache_misses",
               "serve.native.exemplar_drops"])
        self._n_ctr = len(self._ctr_names)
        self._n_reason = n_reason
        self._ctr_buf = np.zeros(self._n_ctr, np.int64)
        # tenant counter block (telemetry_native.h TEN_* layout): 3
        # globals + per-slot [tokens, accept, reject, reject.<r>…];
        # slots map back to issuer-hash labels via decision.TENANTS
        # at scrape time, so names match the Python fold exactly
        self._ten_stride = 3 + n_reason
        self._n_tctr = 3 + _decision.N_TENANT * self._ten_stride
        self._tctr_buf = np.zeros(self._n_tctr, np.int64)
        self._ex_buf = np.zeros(
            telemetry.MAX_DECISION_ENTRIES * _EX_STRIDE, np.uint8)
        self._bucket_buf = np.zeros(self._n_buckets, np.int64)
        self._pump_lock = threading.Lock()
        # captured at teardown so the sigterm-drain postmortem (which
        # checkpoints AFTER the native side is destroyed) still
        # carries everything the plane ever counted
        self._final_snapshot: Optional[dict] = None

    # -- classification ---------------------------------------------------

    def classify_seg(self, seg_bytes: bytes):
        """(fam_idx, kid, tenant_slot) via the NATIVE cache; fam_idx
        -1 = miss (tenant then unresolved too)."""
        if not self._h:
            return (-1, None, -1)
        if not seg_bytes:
            return (self._FAM_UNKNOWN, None, _decision.TENANT_NONE_IDX)
        buf = np.frombuffer(seg_bytes, np.uint8)
        kid_out = np.zeros(_KID_LEN, np.uint8)
        kid_len = ctypes.c_int32(0)
        ten = ctypes.c_int16(-1)
        fam = int(self._lib.cap_tel_classify_seg(
            self._h, buf.ctypes.data_as(_u8p), len(seg_bytes),
            kid_out.ctypes.data_as(_u8p), ctypes.byref(kid_len),
            ctypes.byref(ten)))
        kid = (kid_out[: kid_len.value].tobytes().decode("ascii")
               if kid_len.value else None)
        return (fam, kid, int(ten.value) if fam >= 0 else -1)

    def learn(self, seg_bytes: bytes, fam_idx: int,
              kid: Optional[str], ten_idx: int) -> None:
        if not self._h or not seg_bytes:
            return
        buf = np.frombuffer(seg_bytes, np.uint8)
        kb = np.frombuffer(kid.encode(), np.uint8) if kid else None
        self._lib.cap_tel_learn(
            self._h, buf.ctypes.data_as(_u8p), len(seg_bytes), fam_idx,
            kb.ctypes.data_as(_u8p) if kb is not None else None,
            _KID_LEN if kid else 0, int(ten_idx))

    def fix_misses(self, tokens, fams: np.ndarray, kids: np.ndarray,
                   tens: Optional[np.ndarray] = None) -> None:
        """Resolve header-cache misses (fam < 0) with the Python
        classifier and teach the native cache — cold headers cost one
        Python parse (header AND, for the tenant, the first such
        token's payload — decision._seg_fkt) per DISTINCT header, then
        hit natively forever. Per-chunk the first miss of a segment
        resolves it; later same-segment tokens reuse that resolution,
        exactly like record_batch's per-distinct-segment pass."""
        seen: dict = {}
        for i in np.nonzero(fams < 0)[0]:
            tok = tokens[i]
            seg = tok.split(".", 1)[0] if isinstance(tok, str) else None
            hit = seen.get(seg) if isinstance(seg, str) else None
            if hit is None:
                fam_name, kid, ten_label = _decision._seg_fkt(seg, tok)
                hit = (self._fam_to_idx[fam_name], kid,
                       _decision.tenant_index(ten_label))
                if isinstance(seg, str) and 0 < len(seg) <= 1024:
                    seen[seg] = hit
                    self.learn(seg.encode("utf-8"), hit[0], kid,
                               hit[2])
            fams[i] = hit[0]
            if hit[1]:
                kids[i * _KID_LEN:(i + 1) * _KID_LEN] = \
                    np.frombuffer(hit[1].encode(), np.uint8)
            if tens is not None:
                tens[i] = hit[2]

    # -- standalone fold (the parity sweep's entry point) -----------------

    def fold_batch(self, results, tokens=None, latency_s=None,
                   trace=None) -> None:
        """Drive one batch through the native fold exactly as the
        serve chain would: classify (native cache → Python on miss),
        statuses from the verify contract, reasons via the indexed
        classifier, one cap_tel_fold call."""
        n = len(results)
        if n == 0 or not self._h:
            return
        fams = np.full(n, -1, np.int8)
        kids = np.zeros(n * _KID_LEN, np.uint8)
        tens = np.full(n, -1, np.int16)
        if tokens is not None:
            for i, t in enumerate(tokens):
                if not isinstance(t, str):
                    fams[i] = self._FAM_UNKNOWN
                    tens[i] = _decision.TENANT_NONE_IDX
                    continue
                fam, kid, ten = self.classify_seg(
                    t.split(".", 1)[0].encode("utf-8"))
                if fam >= 0:
                    fams[i] = fam
                    tens[i] = ten
                    if kid:
                        kids[i * _KID_LEN:(i + 1) * _KID_LEN] = \
                            np.frombuffer(kid.encode(), np.uint8)
            if (fams < 0).any():
                self.fix_misses(tokens, fams, kids, tens)
        else:
            fams[:] = self._FAM_UNKNOWN
            tens[:] = _decision.TENANT_NONE_IDX
        statuses = np.zeros(n, np.uint8)
        reasons = None
        for i, r in enumerate(results):
            if isinstance(r, BaseException):
                if reasons is None:
                    reasons = np.zeros(n, np.uint8)
                statuses[i] = 1
                reasons[i] = _decision.reason_index(r)
        lat_idx = _decision.latency_bucket_index(latency_s)
        tb = np.frombuffer(trace.encode(), np.uint8) \
            if trace else None
        self._lib.cap_tel_fold(
            self._h, n, statuses.ctypes.data_as(_u8p),
            reasons.ctypes.data_as(_u8p) if reasons is not None
            else None,
            fams.ctypes.data_as(_i8p), tens.ctypes.data_as(_i16p),
            kids.ctypes.data_as(_u8p), lat_idx,
            -1.0 if latency_s is None else float(latency_s),
            tb.ctypes.data_as(_u8p) if tb is not None else None,
            len(tb) if tb is not None else 0)

    # -- scrape side ------------------------------------------------------

    def pump(self, rec: Optional[telemetry.Recorder] = None) -> int:
        """Drain queued exemplars into the recorder's decision ring;
        returns how many entries crossed."""
        if rec is None:
            rec = telemetry.active()
        h = self._h
        if rec is None or not h:
            return 0
        with self._pump_lock:
            n = int(self._lib.cap_tel_drain_exemplars(
                h, self._ex_buf.ctypes.data_as(_u8p),
                telemetry.MAX_DECISION_ENTRIES))
            if not n:
                return 0
            entries = []
            buf = self._ex_buf
            for i in range(n):
                r = buf[i * _EX_STRIDE:(i + 1) * _EX_STRIDE]
                kid_len = int(r[3])
                kid = (r[4:4 + kid_len].tobytes().decode("ascii")
                       if kid_len else None)
                trace_len = int(r[16])
                trace = (r[17:17 + trace_len].tobytes().decode("ascii")
                         if trace_len else None)
                entries.append(_decision.entry_from_exemplar(
                    int(r[0]), int(r[1]), int(r[2]), kid, trace))
        rec.decision_many(entries)
        return n

    def counters(self):
        """Nonzero plane counters under their registered names (the
        final pre-teardown values once destroyed) — including the
        per-tenant block, with native slots mapped back to issuer-hash
        labels so the names match the Python fold exactly."""
        h = self._h
        if not h:
            return dict((self._final_snapshot or {}).get("counters")
                        or {})
        self._lib.cap_tel_counters(h,
                                   self._ctr_buf.ctypes.data_as(_i64p))
        out = {name: int(v) for name, v
               in zip(self._ctr_names, self._ctr_buf) if v}
        self._lib.cap_tel_tenant_counters(
            h, self._tctr_buf.ctypes.data_as(_i64p))
        tb = self._tctr_buf
        for name, v in zip(("tenant.lookups", "tenant.attributed",
                            "tenant.overflow"), tb[:3]):
            if v:
                out[name] = int(v)
        if tb[3:].any():
            labels = _decision.TENANTS.labels()
            stride = self._ten_stride
            for slot in range(_decision.N_TENANT):
                base = 3 + slot * stride
                if not tb[base]:
                    continue
                t = labels.get(slot, _decision.TENANT_OTHER)
                prefix = f"decision.serve.tenant.{t}"
                out[f"{prefix}.tokens"] = int(tb[base])
                if tb[base + 1]:
                    out[f"{prefix}.accept"] = int(tb[base + 1])
                if tb[base + 2]:
                    out[f"{prefix}.reject"] = int(tb[base + 2])
                for j, reason in enumerate(_decision.REASON_INDEX):
                    if tb[base + 3 + j]:
                        out[f"{prefix}.reject.{reason}"] = \
                            int(tb[base + 3 + j])
        return out

    def _hist_state(self, series: int, tenant_slot: bool = False):
        count = np.zeros(1, np.int64)
        smm = np.zeros(3, np.float64)
        fn = (self._lib.cap_tel_tenant_hist_state if tenant_slot
              else self._lib.cap_tel_hist_state)
        fn(self._h, series, self._bucket_buf.ctypes.data_as(_i64p),
           count.ctypes.data_as(_i64p),
           smm[0:].ctypes.data_as(_f64p),
           smm[1:].ctypes.data_as(_f64p),
           smm[2:].ctypes.data_as(_f64p))
        return {"count": int(count[0]), "sum": float(smm[0]),
                "min": float(smm[1]), "max": float(smm[2]),
                "buckets": {str(i): int(c) for i, c
                            in enumerate(self._bucket_buf) if c}}

    def snapshot(self):
        """telemetry.Recorder.snapshot()-shaped state: scrape paths
        merge it with the Python recorder's via merge_snapshots.
        After teardown, the final pre-destroy snapshot is served."""
        if not self._h:
            return dict(self._final_snapshot
                        or {"v": 1, "counters": {}, "gauges": {},
                            "series": {}})
        series = {}
        for idx, name in enumerate(self.SERIES_NAMES):
            st = self._hist_state(idx)
            if st["count"]:
                series[name] = st
        # per-tenant latency series under the fold's exact names
        # (tenant.<label>.request_s), slot → label like counters()
        labels = None
        for slot in range(_decision.N_TENANT):
            st = self._hist_state(slot, tenant_slot=True)
            if not st["count"]:
                continue
            if labels is None:
                labels = _decision.TENANTS.labels()
            t = labels.get(slot, _decision.TENANT_OTHER)
            series[f"tenant.{t}.request_s"] = st
        return {"v": 1, "counters": self.counters(), "gauges": {},
                "series": series}

    def observe(self, series: int, value: float) -> None:
        if self._h:
            self._lib.cap_tel_hist_observe(self._h, series,
                                           float(value))

    def reset(self) -> None:
        if self._h:
            self._lib.cap_tel_reset(self._h)

    def destroy(self) -> None:
        h, self._h = self._h, None
        if h and self._owned:
            self._lib.cap_tel_destroy(h)


class NativeServeChain:
    """One worker's native frame-I/O front end.

    batcher: the worker's AdaptiveBatcher (must expose
    ``submit_handoff``). stats_fn / keys_fn / peer_fill_fn: the
    worker's control-op handlers (``VerifyWorker.stats`` /
    ``apply_keys`` / ``peer_fill``). vcache: the worker's verdict cache
    (None: off). shm: arm the readers' shared-memory attach
    negotiation. admission: the worker's ``AdmissionConfig`` (fair DRR
    and token buckets, policed in the C++ readers). native_obs: attach
    the native telemetry plane when telemetry is on. grace_fn: whether
    the engine's grace window is open (``GPUBatchKeySet.in_grace``);
    no accept verified while it is open is cached.
    """

    _META_STRIDE = 6

    def __init__(self, batcher, stats_fn: Callable[[], dict],
                 keys_fn: Callable[[dict, Any], int],
                 peer_fill_fn: Optional[Callable[[dict], dict]] = None,
                 max_batch: int = 32768, vcache=None,
                 shm: bool = False, admission=None,
                 native_obs: bool = True,
                 grace_fn: Optional[Callable[[], bool]] = None):
        self._lib = load()
        self._batcher = batcher
        self._stats_fn = stats_fn
        self._keys_fn = keys_fn
        self._peer_fill_fn = peer_fill_fn
        self._grace_fn = grace_fn
        self._h = ctypes.c_void_p(self._lib.cap_serve_create(
            4096, 4 * max_batch))
        if not self._h:
            raise RuntimeError("cap_serve_create failed")
        # Shared-memory transport: arm attach negotiation in the C++
        # readers (a socket-only chain acks attaches status 1).
        self.shm_armed = bool(shm)
        if shm:
            self._lib.cap_serve_set_shm(self._h, 1)
        # Verdict cache (the worker's instance — one cache serves both
        # chains, so the worker's apply_keys invalidation hook covers
        # this chain too): the C readers sha256 each token at
        # frame-parse time and the drain picks the digests up next to
        # fams/kids — zero Python hashing on the hot path.
        self._vcache = vcache
        self._native_digests = (vcache is not None
                                or getattr(batcher, "_wants_digests",
                                           False))
        if self._native_digests:
            self._lib.cap_serve_set_digests(self._h, 1)
        # Native telemetry plane: on when telemetry is enabled and
        # native_obs holds; off, the Python decision fold runs.
        self._plane = None
        if telemetry.active() is not None and native_obs:
            plane = NativeTelemetryPlane(self._lib)
            self._lib.cap_serve_set_telemetry(self._h, plane._h)
            plane._owned = False   # freed with the serve handle
            self._plane = plane
        # Occupancy plane: the drain copies the reader-side enqueue
        # stamps out next to req_t0, so queue.ring_wait_s is MEASURED
        # (steady clock both sides).
        self._occ_n = 0
        # conn ids already attributed to a tenant (the connection
        # plane); bounded — a clear on overflow re-attributes at most
        # one extra count per long-lived conn
        self._conn_tenants_seen: set = set()
        # Tenant-fair DRR scheduling + token-bucket admission, armed
        # in the C++ readers (they police, the drain pops DRR order).
        self.fair_native = False
        self.adm_native = False
        self._shed: dict = {}               # tenant label → scale
        if admission is not None and admission.fair:
            self._lib.cap_serve_set_fair(
                self._h, 1, int(admission.quantum or 0))
            for label, w in admission.weights.items():
                self.set_weight(label, w)
            self.fair_native = True
        if admission is not None and admission.admission_on:
            self._lib.cap_serve_set_admission(
                self._h, 1, float(admission.rate), float(admission.burst))
            self.adm_native = True
        self._final_counters: dict = {}     # captured at destroy
        self._stop = threading.Event()
        self._drained = threading.Event()   # ring empty after stop
        # drain buffers (grown on demand when a giant frame arrives)
        self._alloc(max_tokens=max_batch, blob_cap=8 << 20,
                    max_reqs=4096)
        self._thread = threading.Thread(
            target=self._drain_loop, daemon=True,
            name="cap-gpu-native-drain")
        self._thread.start()

    def _alloc(self, max_tokens: int, blob_cap: int,
               max_reqs: int) -> None:
        self._max_tokens = max_tokens
        self._blob_cap = blob_cap
        self._max_reqs = max_reqs
        self._tok_blob = np.empty(blob_cap, np.uint8)
        self._tok_off = np.zeros(max_tokens + 1, np.int64)
        self._req_meta = np.zeros(max_reqs * self._META_STRIDE, np.int32)
        self._req_seq = np.zeros(max_reqs, np.int64)
        self._req_t0 = np.zeros(max_reqs, np.float64)
        self._trace_buf = np.zeros(max_reqs * 64, np.uint8)
        self._out_counts = np.zeros(3, np.int64)
        # telemetry plane: per-token (family idx, kid hash, tenant
        # slot) of the last drain, classified by the native readers
        self._fam_buf = np.full(max_tokens, -1, np.int8)
        self._kid_buf = np.zeros(max_tokens * _KID_LEN, np.uint8)
        self._ten_buf = np.full(max_tokens, -1, np.int16)
        # verdict cache: per-token digest of the last drain (sha256
        # truncated, computed by the native readers; all-zero rows
        # fall back to Python hashing)
        self._dig_buf = np.zeros(max_tokens * _DIG_LEN, np.uint8)
        # admission: per-token throttle verdicts of the last drain
        # (1 = over budget — answer with pushback, never verify)
        self._thr_buf = np.zeros(max_tokens, np.uint8)
        # occupancy: per-REQUEST reader-side enqueue stamps (steady-
        # clock seconds) of the last drain
        self._enq_buf = np.zeros(max_reqs, np.float64)

    # -- connection handoff ------------------------------------------------

    def add_conn(self, conn) -> int:
        """Take ownership of an accepted socket: its fd moves to the
        native reader/writer threads (the Python socket object is
        detached and must not be used again)."""
        fd = conn.detach()
        cid = int(self._lib.cap_serve_add_conn(self._h, fd))
        if cid < 0:
            os.close(fd)
        return cid

    # -- stats surface -----------------------------------------------------

    def ring_depth(self) -> int:
        h = self._h
        if not h:               # destroyed (post-drain stats snapshot)
            return 0
        return int(self._lib.cap_serve_ring_depth(h))

    def ring_hwm(self, reset: bool = True) -> int:
        """Ring high-water mark since the last scrape (native-side
        max of queued tokens — drain-time sampling misses bursts);
        reset=True rearms the mark at the current depth."""
        h = self._h
        if not h:
            return 0
        return int(self._lib.cap_serve_ring_hwm(h, 1 if reset else 0))

    @property
    def obs_plane(self) -> Optional[NativeTelemetryPlane]:
        """The attached native telemetry plane (None: Python fold)."""
        return self._plane

    # -- fair scheduling / admission ---------------------------------------

    @staticmethod
    def _sched_slot(label: str) -> int:
        """Tenant label → DRR slot (best-effort for none/other/"be")."""
        if label == "be":
            return _decision.TENANT_CAP
        idx = _decision.tenant_index(label)
        return idx if 0 <= idx < _decision.TENANT_CAP \
            else _decision.TENANT_CAP

    def set_weight(self, label: str, w: int) -> None:
        """Per-tenant DRR weight (label = issuer hash, or "be" for the
        shared best-effort slot)."""
        if self._h:
            self._lib.cap_serve_set_weight(self._h,
                                           self._sched_slot(label),
                                           int(w))

    def set_tenant_scale(self, label: str, scale: float) -> None:
        """Shed lever: scale one tenant's admission rate (1.0
        restores) in the native buckets."""
        scale = max(0.0, float(scale))
        if self.adm_native and self._h:
            self._lib.cap_serve_set_tenant_scale(
                self._h, _decision.tenant_index(label), scale)
        if scale < 1.0:
            self._shed[label] = scale
        else:
            self._shed.pop(label, None)

    @property
    def shed_state(self) -> dict:
        """Currently shed tenants (label → rate scale)."""
        return dict(self._shed)

    def admission_fill(self, label: str) -> Optional[float]:
        """One tenant bucket's current level in tokens (None when
        admission is not natively armed)."""
        if not self.adm_native or not self._h:
            return None
        return float(self._lib.cap_serve_bucket_fill(
            self._h, _decision.tenant_index(label)))

    def counters(self) -> dict:
        h = self._h
        if not h:               # destroyed: serve the final values
            return dict(self._final_counters)  # (postmortem freshness)
        return self._read_counters(h)

    def _read_counters(self, h) -> dict:
        c = self._lib.cap_serve_counter
        out = {
            "serve.native.connections": int(c(h, CTR_CONNS)),
            "serve.native.frames": int(c(h, CTR_FRAMES)),
            "serve.native.tokens": int(c(h, CTR_TOKENS)),
            "serve.native.protocol_errors": int(c(h, CTR_PROTO_ERR)),
            "serve.native.pongs": int(c(h, CTR_PONGS)),
            "serve.native.dropped_posts": int(c(h, CTR_DROPPED_POSTS)),
            "serve.native.connections_closed":
                int(c(h, CTR_CONNS_CLOSED)),
        }
        # the shm transport's slots ("serve.shm_fallbacks" counts the
        # attaches a socket-only chain refused, as the Python chain's)
        out["serve.shm.attaches"] = int(c(h, CTR_SHM_ATTACHES))
        out["serve.shm_fallbacks"] = int(c(h, CTR_SHM_FALLBACKS))
        out["serve.shm.frames"] = int(c(h, CTR_SHM_FRAMES))
        out["serve.shm.stale_gen"] = int(c(h, CTR_SHM_STALE_GEN))
        out["serve.shm.detaches"] = int(c(h, CTR_SHM_DETACHES))
        # admission slots under the EXACT names the python
        # AdmissionController counts, so merges are chain-agnostic;
        # zeros stay out (a python-chain worker with admission off has
        # no such counters either)
        for name, slot in (("admission.checked", CTR_ADM_CHECKED),
                           ("admission.admitted", CTR_ADM_ADMITTED),
                           ("admission.throttled", CTR_ADM_THROTTLED)):
            v = int(c(h, slot))
            if v:
                out[name] = v
        return out

    # -- drain loop --------------------------------------------------------

    def _drain_loop(self) -> None:
        lib = self._lib
        h = self._h
        while True:
            stopping = self._stop.is_set()
            # GREEDY drain: block until at least one request is queued
            # (idle wait), then take everything available and return —
            # the drain layer adds NO batching window of its own; the
            # AdaptiveBatcher below owns the latency/throughput
            # tradeoff, exactly as on the Python chain. Under load the
            # ring refills while Python processes the previous chunk,
            # so chunks grow toward max_tokens by themselves.
            rc = int(lib.cap_serve_drain(
                h, self._max_tokens, self._max_tokens,
                0.0,
                # short idle wait while serving (cheap wakeups keep
                # close() responsive); near-zero when draining out
                0.0 if stopping else 0.05,
                self._tok_blob.ctypes.data_as(_u8p), self._blob_cap,
                self._tok_off.ctypes.data_as(_i64p),
                self._req_meta.ctypes.data_as(_i32p),
                self._req_seq.ctypes.data_as(_i64p),
                self._req_t0.ctypes.data_as(_f64p),
                self._trace_buf.ctypes.data_as(_u8p),
                self._max_reqs,
                self._out_counts.ctypes.data_as(_i64p)))
            if rc == -2:
                # one request alone exceeds the buffers: grow to fit
                # (bounded by the protocol's own frame caps)
                need_toks, need_blob = int(self._out_counts[1]), \
                    int(self._out_counts[2])
                self._alloc(
                    max_tokens=max(self._max_tokens, need_toks),
                    blob_cap=max(self._blob_cap * 2, need_blob),
                    max_reqs=self._max_reqs)
                continue
            if self._plane is not None:
                # exemplar handoff rides the drain cadence: one call
                # moves everything the fold sampled since last time
                # into the recorder's decision ring
                self._plane.pump()
            if rc <= 0:
                if stopping:
                    self._drained.set()
                    return
                continue
            if self._plane is not None:
                lib.cap_serve_drain_aux(
                    h, self._fam_buf.ctypes.data_as(_i8p),
                    self._kid_buf.ctypes.data_as(_u8p),
                    self._max_tokens)
                lib.cap_serve_drain_tens(
                    h, self._ten_buf.ctypes.data_as(_i16p),
                    self._max_tokens)
            if self._native_digests:
                lib.cap_serve_drain_digests(
                    h, self._dig_buf.ctypes.data_as(_u8p),
                    self._max_tokens)
            if self.adm_native:
                self._thr_buf[:] = 0
                lib.cap_serve_drain_thr(
                    h, self._thr_buf.ctypes.data_as(_u8p),
                    self._max_tokens)
            self._occ_n = int(lib.cap_serve_drain_enq(
                h, self._enq_buf.ctypes.data_as(_f64p), self._max_reqs))
            telemetry.gauge("serve.native.ring_depth",
                            float(self.ring_depth()))
            try:
                self._process(int(rc))
            except Exception:  # noqa: BLE001 - the loop must survive
                telemetry.count("serve.native.drain_errors")

    def _process(self, n_reqs: int) -> None:
        t_drain = time.time()
        n_toks = int(self._out_counts[1])
        rec = telemetry.active()
        if rec is not None and self._occ_n:
            # measured ring wait: drain-side monotonic minus the
            # reader-side enqueue stamp (same CLOCK_MONOTONIC both
            # sides — see serve_native.cpp Req.t_enq)
            waits = time.monotonic() \
                - self._enq_buf[: min(self._occ_n, n_reqs)]
            for w in waits:
                rec.observe("queue.ring_wait_s", max(0.0, float(w)))
        # same accounting names the Python chain counts per frame, so
        # pool.stats_merged / bench per-worker attribution are
        # chain-agnostic (control records ride in n_reqs but carry no
        # tokens; close enough for request accounting).
        telemetry.count("worker.requests", n_reqs)
        telemetry.count("worker.tokens", n_toks)
        blob = self._tok_blob[: int(self._out_counts[2])].tobytes()
        # ASCII fast path: one whole-blob decode, then str slicing per
        # token (byte offsets == char offsets). Compact JWS is ASCII
        # by construction; non-ASCII tokens take the per-slice decode.
        try:
            text: Optional[str] = blob.decode("ascii")
        except UnicodeDecodeError:
            text = None
        offs = self._tok_off[: n_toks + 1].tolist()
        meta = self._req_meta[: n_reqs * self._META_STRIDE]
        tok_i = 0
        i = 0
        while i < n_reqs:
            kind = int(meta[i * 6 + 0])
            if kind == 0:
                # contiguous run of verify requests → ONE submission
                j = i
                seg_toks = 0
                while j < n_reqs and int(meta[j * 6 + 0]) == 0:
                    seg_toks += int(meta[j * 6 + 3])
                    j += 1
                self._submit_segment(i, j, tok_i, seg_toks, blob, text,
                                     offs, t_drain)
                tok_i += seg_toks
                i = j
            else:
                self._handle_control(i, kind, blob, offs, tok_i)
                tok_i += int(meta[i * 6 + 3])
                i += 1

    def _submit_segment(self, i0: int, i1: int, tok0: int, seg_toks: int,
                        blob: bytes, text: Optional[str],
                        offs: List[int], t_drain: float) -> None:
        with telemetry.span(telemetry.SPAN_NATIVE_DRAIN):
            if text is not None:
                tokens = [text[offs[k]: offs[k + 1]]
                          for k in range(tok0, tok0 + seg_toks)]
            else:
                tokens = [blob[offs[k]: offs[k + 1]].decode("utf-8")
                          for k in range(tok0, tok0 + seg_toks)]
            n = i1 - i0
            meta = self._req_meta[i0 * 6: i1 * 6].copy()
            seqs = self._req_seq[i0:i1].copy()
            t0s = self._req_t0[i0:i1].copy()
            traces_raw = self._trace_buf[i0 * 64: i1 * 64].copy()
            plane = self._plane
            if plane is not None:
                # reader-classified (family, kid, tenant) per token;
                # the rare header-cache misses resolve through the
                # Python classifier ONCE per distinct header (issuer
                # parse included), then hit native
                fams = self._fam_buf[tok0: tok0 + seg_toks].copy()
                kids = self._kid_buf[tok0 * _KID_LEN:
                                     (tok0 + seg_toks) * _KID_LEN].copy()
                tens = self._ten_buf[tok0: tok0 + seg_toks].copy()
                if (fams < 0).any():
                    plane.fix_misses(tokens, fams, kids, tens)
            else:
                fams = kids = tens = None
            if tens is not None:
                # connection plane: attribute each conn to its
                # FIRST verify frame's tenant, once — same counter the
                # python chain's reader thread writes
                labels = None
                tb = 0
                for k in range(n):
                    nent = int(meta[k * 6 + 3])
                    cid = int(meta[k * 6 + 1])
                    if nent and cid not in self._conn_tenants_seen:
                        if len(self._conn_tenants_seen) >= 1 << 20:
                            self._conn_tenants_seen.clear()
                        self._conn_tenants_seen.add(cid)
                        if labels is None:
                            labels = _decision.TENANTS.labels()
                        label = labels.get(int(tens[tb]),
                                           _decision.TENANT_NONE)
                        telemetry.count(f"serve.tenant.{label}.conns")
                    tb += nent
            traces: List[tuple] = []
            for k in range(n):
                tl = int(meta[k * 6 + 4])
                if tl:
                    tid = traces_raw[k * 64: k * 64 + tl].tobytes() \
                        .decode("ascii")
                    t_recv = float(t0s[k])
                    telemetry.trace_span(
                        tid, telemetry.SPAN_WORKER_DEQUEUE, t_recv,
                        max(0.0, t_drain - t_recv))
                    traces.append((tid, t_recv))

        def on_done(results: List[Any]) -> None:
            # Serve-surface decision records (the r9 contract). With
            # the native plane attached, the fold happens INSIDE the
            # response-encode call (cap_serve_post_results_tel) — same
            # counters, same ring sample positions, no Python pass
            # over the tokens. Without it, the Python fold runs, same
            # as the Python chain's responder. Cache hits flow through
            # the SAME fold — the decision counters cannot tell a
            # cached verdict from a fresh one (that is the parity pin).
            if plane is not None:
                lat_s = time.time() - t_drain
                self._post(results, meta, seqs, traces_raw, n, traces,
                           t0s=t0s, fams=fams, kids=kids, tens=tens,
                           lat_idx=_decision.latency_bucket_index(
                               lat_s),
                           lat_s=lat_s)
            else:
                _decision.record_batch(
                    "serve", results, tokens=tokens,
                    latency_s=time.time() - t_drain,
                    trace=traces[0][0] if traces else None)
                self._post(results, meta, seqs, traces_raw, n, traces)

        # Admission: throttled tokens are answered with the
        # retry-after pushback and NEVER verified — they skip the
        # cache and the batcher entirely. The decision fold still
        # counts them (reason "throttled", per tenant) because
        # on_done always receives the FULL-length results.
        verify_idx: Optional[List[int]] = None
        thr = None
        retry_pend: dict = {}
        if self.adm_native:
            tb = self._thr_buf[tok0: tok0 + seg_toks]
            if (tb == 2).any():
                # header-cache-miss tokens the reader could not judge:
                # their tenants are resolved NOW (fix_misses above /
                # the python classifier), so take from the native
                # buckets late — same arithmetic, same counters, and
                # no cross-tenant bleed through a shared miss bucket
                if tens is not None:
                    slots = [int(s) for s in tens]
                else:
                    slots = [_decision.tenant_index(label) for label
                             in _decision.tenant_labels(tokens)]
                rb = ctypes.c_int32(0)
                for i in np.nonzero(tb == 2)[0]:
                    i = int(i)
                    if self._lib.cap_serve_adm_take(
                            self._h, slots[i], ctypes.byref(rb)):
                        tb[i] = 1
                        retry_pend[i] = int(rb.value)
                    else:
                        tb[i] = 0
            if tb.any():
                thr = tb != 0
        if thr is not None and thr.any():
            from . import admission as _adm

            # per-token retry hint: the owning request's drained
            # meta[5] (the native readers')
            retry_of = np.zeros(seg_toks, np.int32)
            at = 0
            for k in range(n):
                cnt = int(meta[k * 6 + 3])
                retry_of[at: at + cnt] = int(meta[k * 6 + 5])
                at += cnt
            for i, ms in retry_pend.items():
                retry_of[i] = ms    # late-judged miss tokens
            full: List[Any] = [None] * seg_toks
            verify_idx = []
            for i in range(seg_toks):
                if thr[i]:
                    full[i] = _adm.throttled_error(int(retry_of[i]))
                else:
                    verify_idx.append(i)
            base_done = on_done
            if not verify_idx:
                base_done(full)     # all-throttled: zero verify work
                return

            def on_done(fresh: List[Any], _full=full, _vi=verify_idx,
                        _bd=base_done) -> None:
                for j, i in enumerate(_vi):
                    _full[i] = fresh[j]
                _bd(_full)

            tokens_v = [tokens[i] for i in verify_idx]
        else:
            tokens_v = tokens
        # reader-computed digests (all-zero rows — stale carry,
        # control filler — rehash in Python)
        dig_full = None
        if self._native_digests:
            db = self._dig_buf[tok0 * _DIG_LEN:
                               (tok0 + seg_toks) * _DIG_LEN].tobytes()
            dig_full = [None if (d := db[k * _DIG_LEN:
                                         (k + 1) * _DIG_LEN])
                        == _ZERO_DIG else d for k in range(seg_toks)]
        if verify_idx is None or dig_full is None:
            dig_list = dig_full
        else:
            dig_list = [dig_full[i] for i in verify_idx]
        vc = self._vcache
        if vc is None:
            self._batcher.submit_handoff(
                tokens_v, traces=[t for t, _ in traces],
                on_done=on_done, digests=dig_list)
            return
        # Verdict-cache consult BEFORE the batcher (admitted tokens
        # only — throttled traffic must not warm or read the cache).
        hits, miss_idx, digs = vc.lookup_batch(tokens_v,
                                               digests=dig_list)
        # per-tenant cache accounting: reader-classified slots when
        # the plane runs, the Python classifier when it is off
        if telemetry.active() is not None:
            if tens is not None:
                tens_v = (tens if verify_idx is None
                          else tens[np.asarray(verify_idx,
                                               np.intp)])
                cache_labels = _decision.tenant_labels_from_slots(
                    tens_v)
            else:
                cache_labels = _decision.tenant_labels(tokens_v)
            _decision.count_tenant_cache(cache_labels, miss_idx)
        if not miss_idx:
            # every token answered from cache: encode + fold directly,
            # no batcher round-trip (memory-speed path)
            on_done(hits)
            return
        epoch0 = vc.epoch
        # read after the epoch: a push that bumped it had already
        # installed its graced tables
        graced = self._grace_fn is not None and bool(self._grace_fn())

        def fill(digs_f: List[Any], fresh: List[Any],
                 toks: List[str]) -> None:
            if graced:
                # an accept verified while a push's dropped kids still
                # resolve may rest on one of them: left uncached, so
                # no cached accept outlives the grace
                keep = [j for j, v in enumerate(fresh)
                        if isinstance(v, BaseException)]
                digs_f = [digs_f[j] for j in keep]
                fresh = [fresh[j] for j in keep]
                toks = [toks[j] for j in keep]
            vc.insert_batch(digs_f, fresh, tokens=toks, epoch=epoch0)

        if len(miss_idx) == len(tokens_v):

            def on_done_fill(fresh: List[Any]) -> None:
                fill(digs, fresh, tokens_v)
                on_done(fresh)

            self._batcher.submit_handoff(
                tokens_v, traces=[t for t, _ in traces],
                on_done=on_done_fill, digests=digs)
            return
        miss_tokens = [tokens_v[i] for i in miss_idx]

        def on_done_merge(fresh: List[Any]) -> None:
            fill([digs[i] for i in miss_idx], fresh, miss_tokens)
            full = hits
            for j, i in enumerate(miss_idx):
                full[i] = fresh[j]
            on_done(full)

        self._batcher.submit_handoff(
            miss_tokens, traces=[t for t, _ in traces],
            on_done=on_done_merge,
            digests=[digs[i] for i in miss_idx])

    def _post(self, results: List[Any], meta: np.ndarray,
              seqs: np.ndarray, traces_raw: np.ndarray, n_reqs: int,
              traces: List[tuple],
              t0s: Optional[np.ndarray] = None,
              fams: Optional[np.ndarray] = None,
              kids: Optional[np.ndarray] = None,
              tens: Optional[np.ndarray] = None,
              lat_idx: int = 0, lat_s: float = -1.0) -> None:
        tel = fams is not None and self._plane is not None
        with telemetry.span(telemetry.SPAN_NATIVE_POST):
            n_tok = len(results)
            poff = np.zeros(n_tok + 1, np.int64)
            reasons: Optional[np.ndarray] = None
            try:
                # fast path: every verdict is raw payload bytes (the
                # raw-claims engines) — one join, all statuses 0
                pblob = b"".join(results)
                if n_tok:
                    np.cumsum(np.fromiter(map(len, results), np.int64,
                                          count=n_tok), out=poff[1:])
                st = np.zeros(max(1, n_tok), np.uint8)
            except TypeError:
                statuses = bytearray(n_tok)
                rbuf = bytearray(n_tok) if tel else None
                payloads: List[bytes] = []
                for i, r in enumerate(results):
                    if isinstance(r, Exception):
                        statuses[i] = 1
                        if rbuf is not None:
                            # exact reason class, resolved per
                            # exception TYPE (one dict hit) — the
                            # native fold consumes the index
                            rbuf[i] = _decision.reason_index(r)
                        payloads.append(
                            f"{type(r).__name__}: {r}".encode())
                    elif isinstance(r, (bytes, bytearray, memoryview)):
                        payloads.append(bytes(r))
                    else:
                        payloads.append(
                            json.dumps(r, separators=(",", ":")).encode())
                pblob = b"".join(payloads)
                if payloads:
                    np.cumsum([len(p) for p in payloads], out=poff[1:])
                st = np.frombuffer(bytes(statuses), np.uint8) \
                    if statuses else np.zeros(1, np.uint8)
                if rbuf is not None:
                    reasons = np.frombuffer(bytes(rbuf), np.uint8)
            pb = np.frombuffer(pblob, np.uint8) if pblob else \
                np.zeros(1, np.uint8)
            if tel:
                # encode + decision fold + latency observe in ONE
                # GIL-released native call
                self._lib.cap_serve_post_results_tel(
                    self._h, meta.ctypes.data_as(_i32p),
                    seqs.ctypes.data_as(_i64p),
                    traces_raw.ctypes.data_as(_u8p),
                    t0s.ctypes.data_as(_f64p), n_reqs,
                    st.ctypes.data_as(_u8p), pb.ctypes.data_as(_u8p),
                    poff.ctypes.data_as(_i64p),
                    reasons.ctypes.data_as(_u8p)
                    if reasons is not None else None,
                    fams.ctypes.data_as(_i8p),
                    tens.ctypes.data_as(_i16p)
                    if tens is not None else None,
                    kids.ctypes.data_as(_u8p), lat_idx, lat_s)
            else:
                self._lib.cap_serve_post_results(
                    self._h, meta.ctypes.data_as(_i32p),
                    seqs.ctypes.data_as(_i64p),
                    traces_raw.ctypes.data_as(_u8p), n_reqs,
                    st.ctypes.data_as(_u8p), pb.ctypes.data_as(_u8p),
                    poff.ctypes.data_as(_i64p))
        now = time.time()
        for tid, t_recv in traces:
            telemetry.flight(tid, now - t_recv)

    def _handle_control(self, i: int, kind: int, blob: bytes,
                        offs: List[int], tok0: int) -> None:
        meta = self._req_meta
        conn_id = int(meta[i * 6 + 1])
        seq = int(self._req_seq[i])
        if kind == 2:  # stats request
            try:
                frame = protocol.encode_stats_response(self._stats_fn())
            except Exception as e:  # noqa: BLE001 - never wedge the loop
                frame = protocol.encode_stats_response(
                    {"error": f"{type(e).__name__}"})
        elif kind == 4:  # peer fill (exactly one entry: the op JSON)
            try:
                doc = json.loads(blob[offs[tok0]: offs[tok0 + 1]])
                if self._peer_fill_fn is None:
                    raise TypeError("worker has no peer-fill handler")
                frame = protocol.encode_peer_ack(
                    doc=self._peer_fill_fn(doc))
            except Exception as e:  # noqa: BLE001 - acked, like Python
                telemetry.count("worker.peer_fill_errors")
                frame = protocol.encode_peer_ack(
                    error=f"{type(e).__name__}: {e}")
        else:          # keys push (exactly one entry: the payload)
            try:
                doc = json.loads(blob[offs[tok0]: offs[tok0 + 1]])
                got = self._keys_fn(doc.get("jwks") or {},
                                    doc.get("epoch"))
                frame = protocol.encode_keys_ack(epoch=got)
            except Exception as e:  # noqa: BLE001 - acked, like Python
                telemetry.count("worker.keys_push_errors")
                frame = protocol.encode_keys_ack(
                    error=f"{type(e).__name__}: {e}")
        buf = np.frombuffer(frame, np.uint8)
        self._lib.cap_serve_post_raw(
            self._h, conn_id, seq, buf.ctypes.data_as(_u8p), len(frame))

    # -- shutdown ----------------------------------------------------------

    def stop_drain(self, deadline_s: float = 10.0) -> None:
        """Stop the drain loop AFTER it has emptied the ring into the
        batcher — queued requests are flushed, not dropped."""
        self._stop.set()
        self._drained.wait(timeout=deadline_s)
        self._thread.join(timeout=deadline_s)

    def destroy(self) -> None:
        """Tear down the native side (sever connections, join its
        threads). Call after the batcher has finished so in-flight
        verdict posts have been written out."""
        h, self._h = self._h, None
        if self._plane is not None:
            # last exemplar handoff and a final snapshot capture, then
            # invalidate under the pump lock (a concurrent scrape's
            # pump either finished or sees None): the plane's C region
            # is freed with the handle, but the sigterm-drain
            # postmortem still reads the captured state
            self._plane.pump()
            self._plane._final_snapshot = self._plane.snapshot()
            with self._plane._pump_lock:
                self._plane._h = None
        if h:
            self._final_counters = self._read_counters(h)
            self._lib.cap_serve_destroy(h)

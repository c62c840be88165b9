"""GPUBatchKeySet — the keyset whose batch path runs on the card.

The port of the JAX package's ``TPUBatchKeySet`` packed path for the
north-star workload (RS256 + ES256 over a multi-key JWKS), ES384 and
ES512 (P-384 and P-521 keys), PS256/PS384/PS512, EdDSA, ML-DSA-44/65/87
and SLH-DSA-SHAKE-128s/128f (AKP keys). A batch runs in two phases, as
the JAX keyset's ``_dispatch_batch`` and ``_collect_batch`` do:

1. dispatch: JSON-form normalization, then one native prep call
   (``runtime.native_binding.prepare_batch_arrays``: the strict
   compact parse, the header's alg and kid, SHA-2 of the signing
   input); families bucketed by alg id (the ML-DSA and SLH-DSA sets
   by the raw alg bytes), kid → key row per distinct kid.
   Tokens with a unique key go to the packed paths, in chunks sized
   and padded as the JAX keyset does, the post-quantum families first:
   SLH-DSA-SHAKE-* to ``gpu.slhdsa`` (host decode, then the whole hash
   forest on the Keccak kernel), ML-DSA-* to ``gpu.mldsa`` (the fused
   engine: μ, SampleInBall, the NTT network and the c̃ compare on the
   device), RS* and PS* to ``gpu.rsa`` (PS* with the device EMSA-PSS
   check over SHA-256, SHA-384 or SHA-512), ES256/ES384/ES512 to
   ``gpu.ec`` (P-256/P-384/P-521; the ladder runs as one whole-ladder
   launch a chunk), EdDSA to ``gpu.ed25519`` (k = SHA-512(R‖A‖M) by
   one native hash call a chunk). RS, PS and ES records come from the
   native record packer. A key class of more than 255 keys (one RSA
   width, one curve, the Ed25519 keys) takes the arrays path instead,
   as in the JAX keyset: the same engines, its key rows an int64
   tensor beside the signatures and digests, since the record's key
   row is one byte. Every chunk is queued on the device before
   any result is read, but each ES and EdDSA chunk waits once on the
   device while it is queued (the batch inverse's root is inverted by
   a host ``pow``, see ``gpu.bignum.batch_mont_inverse``);
2. collect: the claims of every parsed token are parsed natively
   (``PreparedBatch.prefetch_claims``) while the device drains, then
   each chunk's verdicts are read; lanes the device flags (ES ladder
   degeneracies, ML-DSA lanes whose SampleInBall walk exhausted its
   squeeze budget) are re-verified on the pure-integer oracle (and
   counted in ``deg_reverified``); tokens without a unique key
   candidate take the trial path on the host oracle (``jwt.verify``),
   as the JAX keyset's CPU fallback does.

Results are one claims dict or one exception per token, with the JAX
keyset's exception classes and messages. ``verify_batch_raw`` runs the
same dispatch and launches and gives an accepted token's payload bytes
in place of its dict: the collect checks that payloads are JSON objects
(``PreparedBatch.payload_object_ok``) instead of parsing them. An entry
that is not a ``str`` raises ``TypeError`` for the whole batch, as in
the JAX keyset.

Key tables are epoch-versioned as in the JAX keyset: one immutable
``_KeyTables`` set serves a batch from dispatch to collect, and
``swap_keys`` installs a new set (the old epoch's retired kids stay for
a grace window, then a timer installs the pure new epoch), so a batch
dispatched before a swap finishes on its own epoch.
``verify_batch_async`` / ``verify_batch_async_raw`` return a collect
thunk and ``verify_stream`` keeps ``depth`` batches in flight; chunk
sizes follow the observed host-to-device byte rate (``_observe_wire``,
over the packed records' copies timed by CUDA events, and
``_chunk_tokens``, a ``chunk_budget_ms`` time budget). Counters,
spans and the occupancy interval of each batch go to
:mod:`cap_tpu_torch.telemetry` as the JAX keyset's do.
``GPURemoteKeySet`` keeps a ``GPUBatchKeySet`` over a remote JWKS with
at most one refetch a batch for unknown kids.

With a ``mesh`` (:func:`cap_tpu_torch.parallel.make_mesh`) every
packed chunk shards along the batch axis over the mesh's devices, the
key tables replicated on each, as the JAX keyset's ``mesh=`` does; the
arrays paths run on the mesh's first device.

Not ported (ROADMAP): the bench helpers ``resident_dispatchers`` /
``resident_slope_vps``, which belong to the port's benchmark.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..errors import (
    InvalidSignatureError,
    MalformedTokenError,
    NilParameterError,
    UnsupportedAlgError,
)
from ..gpu import ec as gpuec
from ..gpu import ed25519 as gpued
from ..gpu import mldsa as gpumldsa
from ..gpu import rsa as gpursa
from ..gpu import slhdsa as gpuslh
from ..gpu.limbs import nlimbs_for_bits
from ..obs import decision as _decision
from ..obs import occupancy as _occupancy
from ..runtime import native_binding as nb
from . import algs
from .jose import normalize_batch, parse_jws
from .jwk import JWK, RSAPublicKey, parse_jwks
from .keyset import JSONWebKeySet, KeySet
from .verify import key_matches_alg, verify_parsed

_RS = {algs.RS256: "sha256", algs.RS384: "sha384", algs.RS512: "sha512"}
_PS = {algs.PS256: "sha256", algs.PS384: "sha384", algs.PS512: "sha512"}
_ES = {algs.ES256: "P-256", algs.ES384: "P-384", algs.ES512: "P-521"}

_MIN_BUCKET = 128
# RSA key-table rows encode as class * _RSA_CLS_STRIDE + row.
_RSA_CLS_STRIDE = 1 << 16
_MAX_CLASS_KEYS = 255          # the packed record's key row is one byte
_CHUNK_BYTES = 5 << 20         # record bytes a chunk before any rate
_REJECT = "no known key successfully validated the token signature"


def _pad_size(n: int, max_chunk: int) -> int:
    """Next power of two ≥ n (≥ _MIN_BUCKET), capped at max_chunk."""
    size = _MIN_BUCKET
    while size < n:
        size *= 2
    return min(size, max_chunk)


def _mldsa_alg_indices(pb, ok: np.ndarray, name: str) -> np.ndarray:
    """Token indices whose protected alg is the ML-DSA or SLH-DSA set
    ``name``.

    The native prep interns only the ten classical alg names
    (``ALG_NAMES``); any other alg has ``alg_id`` -1 and its raw bytes,
    so the set's bucket is a vectorized compare against ``alg_raw``.
    """
    want = np.frombuffer(name.encode(), np.uint8)
    cand = ok & (pb.alg_id == -1) & (pb.alg_len == len(want))
    if not cand.any():
        return np.zeros(0, np.int64)
    match = (pb.alg_raw[:, : len(want)] == want).all(axis=1)
    return np.nonzero(cand & match)[0]


def _pad_telemetry(family: str, m: int, pad: int) -> None:
    """Per-family dispatch-lane accounting: the lanes each chunk used
    (``pad``, the padded bucket size) and how many of them were padding
    (the JAX keyset's counters of the same names)."""
    telemetry.observe(f"device.{family}.lanes", pad)
    telemetry.observe(f"device.{family}.fill_ratio", m / pad if pad else 0.0)
    if pad > m:
        telemetry.count(f"device.{family}.pad_waste_rows", pad - m)
    telemetry.gauge(f"device.{family}.last_lanes", pad)


def rsa_records(pb, table, kind: str, hash_name: str, chunk: np.ndarray,
                crows: np.ndarray, pad: int) -> np.ndarray:
    """The packed RS* (``kind`` "rs") or PS* ("ps") records of one chunk
    by the native packer: the bytes ``gpu.rsa.rs_packed_records`` makes."""
    h_len = gpursa.HASH_LEN[hash_name]
    sizes = np.asarray(table.sizes_bytes, np.int64)[crows]
    if kind == "rs":
        # PKCS#1 v1.5 needs emLen ≥ tLen + 11; the PSS length checks
        # run on the device
        t_len = len(gpursa.DIGEST_INFO_PREFIX[hash_name]) + h_len
        extra = sizes >= t_len + 11
    else:
        extra = np.ones(len(chunk), bool)
    return pb.pack_sig_records(chunk, sizes, extra, crows, 2 * table.k,
                               h_len, pad)


def es_records(pb, table, chunk: np.ndarray, crows: np.ndarray,
               hash_len: int, pad: int) -> np.ndarray:
    """The packed ES* records of one chunk by the native packer: the
    bytes ``gpu.ec.es_packed_records`` makes."""
    width = 2 * table.coord_bytes
    m = len(chunk)
    return pb.pack_sig_records(chunk, np.full(m, width, np.int64),
                               np.ones(m, bool), crows, width, hash_len,
                               pad)


class _KeyTables:
    """One epoch's immutable key-table set: the JWKs partitioned into
    per-family device tables plus the kid-routing maps (the JAX
    keyset's ``_KeyTables``).

    Everything a batch needs to resolve kids and dispatch lives here,
    built once and never mutated: ``GPUBatchKeySet.swap_keys`` installs
    a fresh instance with one reference swap, so a batch that captured
    the previous instance finishes entirely on its epoch.
    """

    __slots__ = ("epoch", "grace_kids", "mesh", "jwks", "by_kid",
                 "rsa_tables",
                 "n_rsa_keys", "ec_tables", "ed_table", "rsa_rows",
                 "ec_rows", "ed_rows", "kid_rsa_row", "kid_ec_row",
                 "kid_ed_row", "ec_keys", "mldsa_rows", "mldsa_tables",
                 "kid_mldsa_row", "slhdsa_rows", "slhdsa_tables",
                 "kid_slhdsa_row")

    def __init__(self, jwks: Sequence[JWK], device: torch.device,
                 epoch: int = 0, grace_kids: Sequence[str] = (),
                 mesh=None):
        self.epoch = int(epoch)
        self.mesh = mesh
        # kids of the previous epoch that resolve only until the grace
        # retires (empty in a pure epoch)
        self.grace_kids = frozenset(grace_kids)
        self.jwks = list(jwks)
        rsa_classes: List[list] = []
        rsa_class_need: List[int] = []
        self.rsa_rows: Dict[int, int] = {}
        self.ec_keys: Dict[str, list] = {}
        self.ec_rows: Dict[str, Dict[int, int]] = {}
        ed_keys: list = []
        self.ed_rows: Dict[int, int] = {}
        # one table per ML-DSA parameter set (alg name = set name)
        mldsa_keys: Dict[str, list] = {}
        self.mldsa_rows: Dict[str, Dict[int, int]] = {}
        slhdsa_keys: Dict[str, list] = {}
        self.slhdsa_rows: Dict[str, Dict[int, int]] = {}
        for i, jwk in enumerate(self.jwks):
            key = jwk.key
            if isinstance(key, RSAPublicKey):
                need = nlimbs_for_bits(key.n.bit_length())
                if need in rsa_class_need:
                    cls = rsa_class_need.index(need)
                else:
                    cls = len(rsa_classes)
                    rsa_classes.append([])
                    rsa_class_need.append(need)
                self.rsa_rows[i] = cls * _RSA_CLS_STRIDE + \
                    len(rsa_classes[cls])
                rsa_classes[cls].append((key.n, key.e))
            elif isinstance(key, gpuec.HostECPublicKey):
                crv = key.curve_name
                rows = self.ec_rows.setdefault(crv, {})
                rows[i] = len(self.ec_keys.setdefault(crv, []))
                self.ec_keys[crv].append(key)
            elif isinstance(key, gpued.HostEd25519PublicKey):
                self.ed_rows[i] = len(ed_keys)
                ed_keys.append(key)
            elif isinstance(key, gpumldsa.MLDSAPublicKey):
                pset = key.parameter_set
                rows = self.mldsa_rows.setdefault(pset, {})
                rows[i] = len(mldsa_keys.setdefault(pset, []))
                mldsa_keys[pset].append(key)
            elif isinstance(key, gpuslh.SLHDSAPublicKey):
                pset = key.parameter_set
                rows = self.slhdsa_rows.setdefault(pset, {})
                rows[i] = len(slhdsa_keys.setdefault(pset, []))
                slhdsa_keys[pset].append(key)
            else:
                raise UnsupportedAlgError(
                    f"key type {type(key).__name__} is not supported by "
                    f"GPUBatchKeySet")
        self.rsa_tables = [gpursa.RSAKeyTable(nums, device)
                           for nums in rsa_classes]
        self.n_rsa_keys = sum(len(c) for c in rsa_classes)
        self.ec_tables = {crv: gpuec.ECKeyTable(crv, keys, device)
                          for crv, keys in self.ec_keys.items()}
        self.ed_table = (gpued.Ed25519KeyTable(ed_keys, device)
                         if ed_keys else None)
        self.mldsa_tables = {
            pset: gpumldsa.MLDSAKeyTable(pset, keys, device)
            for pset, keys in mldsa_keys.items()}
        self.slhdsa_tables = {
            pset: gpuslh.SLHDSAKeyTable(pset, keys, device)
            for pset, keys in slhdsa_keys.items()}

        self.by_kid: Dict[str, List[int]] = {}
        for i, jwk in enumerate(self.jwks):
            if jwk.kid:
                self.by_kid.setdefault(jwk.kid, []).append(i)
        # kid → family table row, for kids naming exactly one key
        self.kid_rsa_row: Dict[str, int] = {}
        self.kid_ec_row: Dict[str, Dict[str, int]] = {
            c: {} for c in self.ec_rows}
        self.kid_ed_row: Dict[str, int] = {}
        self.kid_mldsa_row: Dict[str, Dict[str, int]] = {
            p: {} for p in self.mldsa_rows}
        self.kid_slhdsa_row: Dict[str, Dict[str, int]] = {
            p: {} for p in self.slhdsa_rows}
        for kid, idxs in self.by_kid.items():
            if len(idxs) != 1:
                continue
            i = idxs[0]
            if i in self.rsa_rows:
                self.kid_rsa_row[kid] = self.rsa_rows[i]
            for crv, rows in self.ec_rows.items():
                if i in rows:
                    self.kid_ec_row[crv][kid] = rows[i]
            if i in self.ed_rows:
                self.kid_ed_row[kid] = self.ed_rows[i]
            for pset, rows in self.mldsa_rows.items():
                if i in rows:
                    self.kid_mldsa_row[pset][kid] = rows[i]
            for pset, rows in self.slhdsa_rows.items():
                if i in rows:
                    self.kid_slhdsa_row[pset][kid] = rows[i]


    def warm(self) -> "_KeyTables":
        """Build the EC and Ed25519 window tables now, on this thread
        (they are built at their first batch otherwise), so a batch on
        a swapped-in epoch builds nothing on the verify path. Over a
        mesh: the window tables on each distinct mesh device, and the
        other tables' copies there (``parallel.place.replicated``)."""
        mesh = self.mesh
        devices = mesh.distinct() if mesh is not None else None
        windowed = list(self.ec_tables.values())
        if self.ed_table is not None:
            windowed.append(self.ed_table)
        for table in windowed:
            for dev in devices or (table.device,):
                table.rns().device_tab(dev)
        if mesh is not None:
            from ..parallel.place import replicated_views

            for table in self.rsa_tables:
                replicated_views(mesh, table, gpursa.TABLE_TENSORS)
            for table in self.mldsa_tables.values():
                replicated_views(mesh, table, gpumldsa.TABLE_TENSORS)
            for table in self.slhdsa_tables.values():
                replicated_views(mesh, table, gpuslh.TABLE_TENSORS)
        return self


class GPUBatchKeySet(KeySet):
    """KeySet whose batch path runs on the GPU verify engine.

    ``jwks``: JWKs of this package (RSA, EC, Ed25519, ML-DSA and SLH-DSA
    keys).
    ``device``: where the engine runs, ``"cuda"`` by default; raises
    when CUDA is absent.
    ``device="cpu"`` runs the plain PyTorch versions of every kernel.
    ``max_chunk``: tokens a packed chunk at most.
    ``chunk_budget_ms``: the time a chunk's records may take on the
    observed host-to-device rate (the JAX keyset reads it from
    ``CAP_TPU_CHUNK_BUDGET_MS``).
    ``epoch``: the key-material version of the initial tables;
    :meth:`swap_keys` installs later ones.
    ``mesh``: a :class:`cap_tpu_torch.parallel.mesh.Mesh`: every packed
    chunk then shards along the batch axis over its devices (equal
    shards, so the mesh size must divide the chunk pads, powers of two
    ≥ 128; SLH-DSA's ≥ 16) with the key tables replicated on each; the
    arrays paths run on its first device. ``device`` defaults to that
    first device and must equal it. A shard that fails raises: nothing
    is re-run unsharded or on the CPU.
    """

    def __init__(self, jwks: Sequence[JWK], device=None, mesh=None,
                 max_chunk: int = 32768, chunk_budget_ms: float = 250.0,
                 epoch: int = 0):
        if not jwks:
            raise NilParameterError("at least one key is required")
        if mesh is not None:
            first = mesh.devices[0]
            if device is not None and not _same_device(device, first):
                raise ValueError(
                    f"device {torch.device(device)} is not the mesh's "
                    f"first device {first}")
            device = first
        device = torch.device("cuda" if device is None else device)
        uses_cuda = device.type == "cuda" or (mesh is not None and any(
            d.type == "cuda" for d in mesh.devices))
        if uses_cuda and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; GPUBatchKeySet runs on the card "
                "unless device='cpu' is given")
        self.device = device
        self.mesh = mesh
        # the engines' keyword: an unmeshed keyset calls them as before
        self._mesh_kw = {} if mesh is None else {"mesh": mesh}
        self.deg_reverified = 0
        self._max_chunk = max_chunk
        # Wire-adaptive chunk sizing: an EWMA of the observed
        # host-to-device byte rate, updated after every collect;
        # _chunk_tokens sizes chunks to a time budget against it. None
        # until a batch has timed its copies (the static 5 MB applies).
        self._wire_bps: Optional[float] = None
        self._chunk_budget_s = float(chunk_budget_ms) / 1e3
        self._swap_lock = threading.Lock()
        self._tables = _KeyTables(jwks, device, epoch=epoch, mesh=mesh)

    # -- epoch-versioned key tables (hot swap) -----------------------------

    @property
    def key_epoch(self) -> int:
        """Epoch of the tables new batches dispatch against."""
        return self._tables.epoch

    @property
    def in_grace(self) -> bool:
        """Whether a swap's dropped kids still resolve: from a
        ``swap_keys`` with grace until its retirement."""
        return bool(self._tables.grace_kids)

    def swap_keys(self, jwks, epoch: Optional[int] = None,
                  grace_s: float = 30.0) -> int:
        """Hot-swap the key tables to a new epoch; returns the epoch.

        ``jwks``: a JWKS document (dict, parsed by
        :func:`cap_tpu_torch.jwt.jwk.parse_jwks`) or a sequence of
        :class:`JWK`. ``epoch``: the version of this material (default:
        current + 1).

        The new tables, their EC and Ed25519 window tables included,
        are built on the caller's thread (never a verify thread) and
        installed with one reference swap; batches already
        dispatched finish on the tables they captured. For ``grace_s``
        seconds, kids that exist only in the old epoch still resolve
        (the installed set is the new JWKS plus the retired kids' keys);
        then a timer thread builds and installs the pure new epoch.
        """
        if isinstance(jwks, dict):
            jwks = parse_jwks(jwks)
        jwks = list(jwks)
        if not jwks:
            raise NilParameterError("at least one key is required")
        t0 = time.perf_counter()
        with self._swap_lock:
            old = self._tables
            new_epoch = old.epoch + 1 if epoch is None else int(epoch)
            new_kids = {j.kid for j in jwks if j.kid}
            retained = ([j for j in old.jwks
                         if j.kid and j.kid not in new_kids]
                        if grace_s > 0 else [])
            with telemetry.span(telemetry.SPAN_KEYPLANE_SWAP):
                self._tables = _KeyTables(
                    jwks + retained, self.device, epoch=new_epoch,
                    grace_kids=[j.kid for j in retained],
                    mesh=self.mesh).warm()
        if retained:
            telemetry.count("keyplane.grace_kids", len(retained))
            timer = threading.Timer(
                grace_s, self._retire_grace, args=(jwks, new_epoch))
            timer.daemon = True
            timer.start()
        telemetry.count("keyplane.swaps")
        telemetry.observe("keyplane.swap_s", time.perf_counter() - t0)
        telemetry.gauge("keyplane.epoch", new_epoch)
        return new_epoch

    def _retire_grace(self, jwks, epoch: int) -> None:
        """Grace expiry: install the pure new-epoch tables (on the timer
        thread). A newer swap having landed meanwhile makes this a
        no-op."""
        try:
            pure = _KeyTables(jwks, self.device, epoch=epoch,
                              mesh=self.mesh).warm()
        except Exception:  # noqa: BLE001 - keep serving graced tables
            telemetry.count("keyplane.grace_retire_errors")
            return
        with self._swap_lock:
            if self._tables.epoch == epoch:
                self._tables = pure
                telemetry.count("keyplane.grace_retired")

    # The tables' attribute names before they were versioned (tests and
    # chip_smoke read them): each reads the CURRENT epoch.
    _jwks = property(lambda self: self._tables.jwks)
    _by_kid = property(lambda self: self._tables.by_kid)
    _rsa_tables = property(lambda self: self._tables.rsa_tables)
    _n_rsa_keys = property(lambda self: self._tables.n_rsa_keys)
    _ec_tables = property(lambda self: self._tables.ec_tables)
    _ed_table = property(lambda self: self._tables.ed_table)
    _kid_rsa_row = property(lambda self: self._tables.kid_rsa_row)
    _kid_ec_row = property(lambda self: self._tables.kid_ec_row)
    _kid_ed_row = property(lambda self: self._tables.kid_ed_row)

    # -- single-token path (host oracle) -----------------------------------

    def _candidate_indices(self, parsed,
                           tables: Optional[_KeyTables] = None
                           ) -> List[int]:
        t = self._tables if tables is None else tables
        if parsed.kid is not None and parsed.kid in t.by_kid:
            pool = t.by_kid[parsed.kid]
        else:
            pool = range(len(t.jwks))
        return [i for i in pool
                if key_matches_alg(t.jwks[i].key, parsed.alg)]

    def _verify_parsed_trial(self, parsed,
                             tables: Optional[_KeyTables] = None):
        t = self._tables if tables is None else tables
        last: Optional[Exception] = None
        for i in self._candidate_indices(parsed, t):
            try:
                verify_parsed(parsed, t.jwks[i].key)
                return parsed.claims()
            except InvalidSignatureError as e:
                last = e
        raise InvalidSignatureError(_REJECT) from last

    def verify_signature(self, token: str) -> Dict[str, Any]:
        return self._verify_parsed_trial(parse_jws(token))

    def _verify_one_parsed(self, p,
                           tables: Optional[_KeyTables] = None) -> Any:
        """Trial verification of one parsed token (the slow path)."""
        try:
            return self._verify_parsed_trial(p, tables)
        except (InvalidSignatureError, MalformedTokenError) as e:
            return e

    # -- batch path --------------------------------------------------------

    def verify_batch(self, tokens: Sequence[str]) -> List[Any]:
        telemetry.count("verify_batch.calls")
        telemetry.count("verify_batch.tokens", len(tokens))
        with telemetry.span("verify_batch.total"):
            return self._collect_batch(self._dispatch_batch(tokens))

    def verify_batch_async(self, tokens: Sequence[str],
                           raw: bool = False):
        """Dispatch a batch; returns ``collect() -> per-token results``.

        Every chunk is queued on the device before this returns (each ES
        and EdDSA chunk waits once on the device while it is queued, for
        the batch inverse's host ``pow``); the thunk runs the collect.
        Dispatching the next batch before collecting this one overlaps
        its host prep with this one's device drain, the 2-deep pipeline
        of the serve batcher. ``raw``: accepted tokens yield payload
        bytes, as in :meth:`verify_batch_raw`.
        """
        telemetry.count("verify_batch.calls")
        telemetry.count("verify_batch.tokens", len(tokens))
        state = self._dispatch_batch(tokens)
        if raw:
            state["raw"] = True
        return lambda: self._collect_batch(state)

    def verify_batch_raw(self, tokens: Sequence[str]) -> List[Any]:
        """Like verify_batch, but a verified token yields its payload
        bytes (the claims JSON the issuer signed) in place of its
        dict. A verified signature over a payload that is not a JSON
        object is rejected as in verify_batch."""
        with telemetry.span("verify_batch.total"):
            return self.verify_batch_async(tokens, raw=True)()

    def verify_batch_async_raw(self, tokens: Sequence[str]):
        """``verify_batch_async(tokens, raw=True)``: the serve worker's
        entry point (its responses carry the payload bytes)."""
        return self.verify_batch_async(tokens, raw=True)

    def verify_stream(self, batches, depth: int = 2):
        """Pipelined verification of an iterable of token batches:
        yields each batch's results in order while keeping up to
        ``depth`` batches in flight."""
        from collections import deque

        inflight: deque = deque()
        for tokens in batches:
            inflight.append(self.verify_batch_async(tokens))
            if len(inflight) >= depth:
                yield inflight.popleft()()
        while inflight:
            yield inflight.popleft()()

    def _dispatch_batch(self, tokens: Sequence[str]) -> dict:
        """Phase 1: prep, bucket, pack and queue every chunk."""
        # Epoch capture: ONE immutable table set serves this whole
        # batch (dispatch, collect, trial path).
        tables = self._tables
        # the wire estimate's span starts here: records go to the
        # device while later chunks are still being packed
        t_dispatch = time.perf_counter()
        # the whole batch is ONE dispatch-level busy interval on the
        # occupancy plane (dispatch start → collect end); the family
        # slices below feed lane shares only (dispatch=False)
        occ_t0 = _occupancy.begin()
        tokens, specials = normalize_batch(tokens)
        with telemetry.span("prep.native"):
            pb = nb.prepare_batch_arrays(tokens)
        results: List[Any] = [None] * pb.n
        ok = pb.status == 0
        for i in np.nonzero(~ok)[0].tolist():
            results[i] = pb.error(i)
        # JSON-form tokens verified on the object path: their payloads,
        # for the raw mode
        special_payloads: Dict[int, bytes] = {}
        for i, sp in specials.items():
            # normalization verdicts outrank the ""-sentinel's prep error
            if isinstance(sp, Exception):
                results[i] = sp
            else:
                try:
                    results[i] = self._verify_parsed_trial(sp, tables)
                    special_payloads[i] = sp.payload
                except Exception as e:  # noqa: BLE001 - per-token
                    results[i] = e

        pending: List[tuple] = []       # (chunk, m, device outs, finish)
        # record bytes this batch; (bytes, start, end) of timed copies
        stats = {"h2d": 0, "copies": []}
        alg_ids = {name: k for k, name in enumerate(nb.ALG_NAMES)}

        def family(alg: str) -> np.ndarray:
            return np.nonzero(ok & (pb.alg_id == alg_ids[alg]))[0]

        # post-quantum first: the deepest device programs (the SLH-DSA
        # hash forest, then the ML-DSA NTT network) go on the stream
        # before the cheaper families
        for pset in sorted(tables.slhdsa_tables):
            idx = _mldsa_alg_indices(pb, ok, pset)
            if len(idx):
                with _occupancy.interval("slhdsa", dispatch=False):
                    self._run_slhdsa_packed(pset, idx, pb, pending,
                                            tables, stats)
        for pset in sorted(tables.mldsa_tables):
            idx = _mldsa_alg_indices(pb, ok, pset)
            if len(idx):
                with _occupancy.interval("mldsa", dispatch=False):
                    self._run_mldsa_packed(pset, idx, pb, pending,
                                           tables, stats)
        for alg, crv in _ES.items():
            idx = family(alg)
            if crv in tables.ec_tables and len(idx):
                with _occupancy.interval("ec", dispatch=False):
                    self._run_ec_packed(alg, idx, pb, pending, tables,
                                        stats)
        idx = family(algs.EdDSA)
        if tables.ed_table is not None and len(idx):
            with _occupancy.interval("ed", dispatch=False):
                self._run_ed_packed(idx, pb, pending, tables, stats)
        if tables.rsa_tables:
            for kind, fam in (("rs", _RS), ("ps", _PS)):
                for alg, hash_name in fam.items():
                    idx = family(alg)
                    if len(idx):
                        with _occupancy.interval("rsa", dispatch=False):
                            self._run_rsa_packed(kind, hash_name, idx,
                                                 pb, pending, tables,
                                                 stats)
        return dict(pb=pb, ok=ok, results=results, pending=pending,
                    special_payloads=special_payloads, tables=tables,
                    stats=stats, t_dispatch=t_dispatch, occ_t0=occ_t0)

    def _collect_batch(self, state: dict) -> List[Any]:
        """Phase 2: claims parse (raw mode: the object check) while the
        device drains, the syncs, the verdicts, the trial path."""
        pb, ok, results = state["pb"], state["ok"], state["results"]
        raw = state.get("raw", False)
        idx = np.nonzero(ok)[0]
        with telemetry.span("device.sync"):
            if raw:
                with telemetry.span("claims.validate"):
                    pb.raw_ok = np.zeros(pb.n, bool)
                    pb.raw_ok[idx] = pb.payload_object_ok(idx)
            else:
                with telemetry.span("claims.prefetch"):
                    pb.prefetch_claims(idx)
            for chunk, m, outs, finish in state["pending"]:
                finish(chunk, [o.cpu().numpy()[:m] for o in outs], pb,
                       results)
        # no unique key candidate, or no table for the family: the trial
        # path on the host oracle, over the batch's own tables
        slow = [j for j in idx.tolist() if results[j] is None]
        if slow:
            telemetry.count("cpu_fallback.tokens", len(slow))
            with telemetry.span("cpu_fallback"):
                for j in slow:
                    out = self._verify_one_parsed(pb.parsed(j),
                                                  state["tables"])
                    if raw and not isinstance(out, Exception):
                        # the oracle built the dict from these bytes
                        out = pb.payload_bytes(j)
                    results[j] = out
        if raw:
            for i, pay in state["special_payloads"].items():
                if not isinstance(results[i], Exception):
                    results[i] = pay
        self._observe_wire(state)
        if telemetry.active() is not None:
            # decision records: families straight from the prep arrays
            fam_for = [_decision.family_for_alg(a) for a in nb.ALG_NAMES]

            def fam(j: int) -> str:
                if not ok[j]:
                    return "unknown"
                aid = int(pb.alg_id[j])
                if aid >= 0:
                    return fam_for[aid]
                # non-interned algs (ML-DSA, SLH-DSA) carry raw bytes
                return _decision.family_for_alg(pb.alg(j))

            _decision.record_batch(
                "gpu", results, families=[fam(j) for j in range(pb.n)],
                latency_s=time.perf_counter() - state["t_dispatch"])
        # close the batch's dispatch-level busy interval
        _occupancy.end("flight", state["occ_t0"])
        return results

    def _observe_wire(self, state: dict) -> None:
        """Fold one batch's host-to-device rate into the EWMA: the bytes
        of its timed record copies (those of at least 1 MB) over the
        copies' device time (CUDA events around each copy, read here
        after the syncs).

        The JAX keyset divides a batch's record bytes by the span from
        its dispatch to its collect, which over its TPU link is the
        transfer. On the card that span is the host's prep and the
        engines' launches: it shrank config-4's PS chunks to 2,048
        tokens and its batch from 1.6 to 8 s (PERF.md §6). A CPU
        keyset copies nothing and keeps the static budget."""
        copies = state["stats"]["copies"]
        secs = sum(a.elapsed_time(b) for _, a, b in copies) / 1e3
        if secs <= 0:
            return
        est = sum(n for n, _, _ in copies) / secs
        prev = self._wire_bps
        self._wire_bps = est if prev is None else 0.5 * prev + 0.5 * est
        telemetry.observe("wire.est_mbps", self._wire_bps / (1 << 20))

    def _chunk_tokens(self, rec_width: int) -> int:
        """Tokens per packed chunk, a power of two: about 5 MB of
        records until the first batch completes; after it, the records
        the observed rate moves in ``chunk_budget_ms``, clamped to
        [1, 8] MB; at least 1,024 and at most ``max_chunk``."""
        budget_bytes = _CHUNK_BYTES
        bps = self._wire_bps
        if bps:
            budget_bytes = min(max(int(bps * self._chunk_budget_s),
                                   1 << 20), 8 << 20)
        c = 1024
        while c * 2 * rec_width <= budget_bytes:
            c *= 2
        return min(self._max_chunk, max(1024, c))

    @staticmethod
    def _finish(chunk, okv, pb, results) -> None:
        raw_ok = pb.raw_ok
        for j, good in zip(chunk.tolist(), np.asarray(okv).tolist()):
            if not good:
                results[j] = InvalidSignatureError(_REJECT)
            elif raw_ok is not None and raw_ok[j]:
                results[j] = pb.payload_bytes(j)
            else:
                # dict mode; or raw mode on a payload that is not an
                # object, whose claims() raises the dict mode's error
                try:
                    claims = pb.claims(j)
                    results[j] = (claims if raw_ok is None
                                  else pb.payload_bytes(j))
                except MalformedTokenError as e:
                    results[j] = e

    def _finish_ok(self, chunk, arrs, pb, results) -> None:
        """The finish of a path whose one device output is the verdict."""
        self._finish(chunk, arrs[0], pb, results)

    @staticmethod
    def _rows(idx, pb, kid_to_row: Dict[str, int],
              n_keys: int) -> np.ndarray:
        """Key row per token: -1 no kid, -2 unknown kid; a family of one
        key takes kid-less tokens (their only candidate)."""
        rows = pb.kid_rows(idx, kid_to_row)
        if n_keys == 1:
            rows = np.where(rows == -1, 0, rows)
        return rows

    def _run_rsa_packed(self, kind: str, hash_name: str, idx: np.ndarray,
                        pb, pending: list,
                        tables: Optional[_KeyTables] = None,
                        stats: Optional[dict] = None) -> None:
        """RS* (``kind`` "rs") or PS* ("ps") tokens in packed chunks per
        RSA class; a class of more than 255 keys gives each chunk to
        ``gpu.rsa`` as arrays (the same chunks and finish)."""
        t = self._tables if tables is None else tables
        rows = self._rows(idx, pb, t.kid_rsa_row, t.n_rsa_keys)
        fast = rows >= 0
        idx, rows = idx[fast], rows[fast]
        h_len = gpursa.HASH_LEN[hash_name]
        for cls, table in enumerate(t.rsa_tables):
            sel = (rows // _RSA_CLS_STRIDE) == cls
            if not sel.any():
                continue
            cls_idx = idx[sel]
            cls_rows = rows[sel] % _RSA_CLS_STRIDE
            chunk_n = self._chunk_tokens(2 * table.k + h_len
                                         + gpursa.RS_REC_EXTRA)
            big = len(table.n_ints) > _MAX_CLASS_KEYS
            for lo in range(0, len(cls_idx), chunk_n):
                chunk = cls_idx[lo: lo + chunk_n]
                crows = cls_rows[lo: lo + chunk_n]
                m = len(chunk)
                pad = _pad_size(m, chunk_n)
                telemetry.count(f"device.{kind}.tokens", m)
                _pad_telemetry(kind, m, pad)
                with telemetry.span(f"dispatch.{kind}.{hash_name}"):
                    if big:
                        # the arrays path (_run_rsa_arrays in the JAX
                        # keyset)
                        verify = (gpursa.verify_pkcs1v15_arrays_pending
                                  if kind == "rs"
                                  else gpursa.verify_pss_arrays_pending)
                        arrs = self._arrays(pb, chunk, crows,
                                            2 * table.k, pad)
                        _count_h2d(stats, arrs)
                        ok = verify(table, *arrs[:3], hash_name, arrs[3])
                    else:
                        verify = (gpursa.verify_rs_packed_pending
                                  if kind == "rs"
                                  else gpursa.verify_ps_packed_pending)
                        rec = rsa_records(pb, table, kind, hash_name,
                                          chunk, crows, pad)
                        ok = verify(table, self._send(rec, stats),
                                    hash_name, **self._mesh_kw)
                pending.append((chunk, m, [ok], self._finish_ok))

    @staticmethod
    def _arrays(pb, chunk: np.ndarray, crows: np.ndarray, width: int,
                pad: int):
        """The arrays of one chunk padded to ``pad`` rows (zero
        signatures on key row 0): (sig_mat, sig_lens, hash_mat, key_idx)
        as the JAX keyset's arrays runners build them."""
        m = len(chunk)
        sig_mat = np.zeros((pad, width), np.uint8)
        sig_mat[:m] = pb.sig_matrix(chunk, width)
        sig_lens = np.zeros(pad, np.int64)
        sig_lens[:m] = pb.sig_len[chunk]
        hash_mat = np.zeros((pad, 64), np.uint8)
        hash_mat[:m] = pb.digest[chunk]
        key_idx = np.zeros(pad, np.int64)
        key_idx[:m] = crows
        return sig_mat, sig_lens, hash_mat, key_idx

    def _run_ec_packed(self, alg: str, idx: np.ndarray, pb,
                       pending: list, tables: Optional[_KeyTables] = None,
                       stats: Optional[dict] = None) -> None:
        """ES* tokens of one curve in packed chunks; a curve of more
        than 255 keys gives each chunk to ``gpu.ec`` as arrays (the same
        chunks, engine and finish)."""
        t = self._tables if tables is None else tables
        crv = _ES[alg]
        table = t.ec_tables[crv]
        hash_len = gpursa.HASH_LEN[algs.HASH_FOR_ALG[alg]]
        rows = self._rows(idx, pb, t.kid_ec_row[crv], len(table.keys))
        fast = rows >= 0
        idx, rows = idx[fast], rows[fast]
        cb = table.coord_bytes
        chunk_n = self._chunk_tokens(2 * cb + hash_len + gpuec.ES_REC_EXTRA)
        big = len(table.keys) > _MAX_CLASS_KEYS
        for lo in range(0, len(idx), chunk_n):
            chunk = idx[lo: lo + chunk_n]
            crows = rows[lo: lo + chunk_n]
            m = len(chunk)
            pad = _pad_size(m, chunk_n)
            telemetry.count("device.es.tokens", m)
            _pad_telemetry("es", m, pad)
            with telemetry.span(f"dispatch.es.{crv}"):
                if big:
                    # the arrays path (_run_ec_arrays in the JAX keyset)
                    sig_mat, sig_lens, hash_mat, key_idx = self._arrays(
                        pb, chunk, crows, 2 * cb, pad)
                    _count_h2d(stats, (sig_mat, sig_lens, hash_mat,
                                       key_idx))
                    ok, deg = gpuec.verify_ecdsa_arrays_pending(
                        table, sig_mat, sig_lens, hash_mat, hash_len,
                        key_idx)
                    sig_of = sig_mat[:, :2 * cb]
                    dig_of = hash_mat[:, :hash_len]
                else:
                    rec = es_records(pb, table, chunk, crows, hash_len,
                                     pad)
                    ok, deg = gpuec.verify_es_packed_pending(
                        table, self._send(rec, stats), hash_len,
                        **self._mesh_kw)
                    sig_of = rec[:, :2 * cb]
                    dig_of = rec[:, 2 * cb:2 * cb + hash_len]

            def finish(chunk, arrs, pb, results, sig_of=sig_of,
                       dig_of=dig_of, crows=crows, table=table):
                okv = np.array(arrs[0])
                for j in np.nonzero(arrs[1])[0]:
                    self.deg_reverified += 1
                    okv[j] = gpuec._py_verify_one(
                        table, int(crows[j]), sig_of[j].tobytes(),
                        dig_of[j].tobytes())
                self._finish(chunk, okv, pb, results)

            pending.append((chunk, m, [ok, deg], finish))

    def _run_ed_packed(self, idx: np.ndarray, pb, pending: list,
                       tables: Optional[_KeyTables] = None,
                       stats: Optional[dict] = None) -> None:
        """EdDSA tokens in packed chunks (``_chunk_tokens(64 + 32 + 2)``:
        32,768 tokens at the static budget), padded to a power of two ≥
        128 with empty signatures on key row 0. More than 255 keys: the
        same chunks go to ``gpu.ed25519`` as lists and int64 key rows."""
        t = self._tables if tables is None else tables
        table = t.ed_table
        rows = self._rows(idx, pb, t.kid_ed_row, len(table.keys))
        fast = rows >= 0
        idx, rows = idx[fast], rows[fast]
        chunk_n = self._chunk_tokens(64 + 32 + gpued.ED_REC_EXTRA)
        for lo in range(0, len(idx), chunk_n):
            chunk = idx[lo: lo + chunk_n]
            m = len(chunk)
            pad = _pad_size(m, chunk_n)
            fill = pad - m
            telemetry.count("device.ed.tokens", m)
            _pad_telemetry("ed", m, pad)
            sigs = [pb.signature(j) for j in chunk.tolist()]
            msgs = [pb.signing_input(j) for j in chunk.tolist()]
            key_idx = np.zeros(pad, np.int64)
            key_idx[:m] = rows[lo: lo + chunk_n]
            sigs += [b""] * fill
            msgs += [b""] * fill
            with telemetry.span("dispatch.ed25519"):
                if len(table.keys) > _MAX_CLASS_KEYS:
                    # the arrays path (_run_ed_arrays in the JAX keyset)
                    if stats is not None:
                        stats["h2d"] += key_idx.nbytes + sum(
                            len(x) for x in sigs) + sum(len(x)
                                                       for x in msgs)
                    ok = gpued.verify_ed25519_batch_pending(
                        table, sigs, msgs, key_idx)
                else:
                    rec = gpued.ed_packed_records(table, sigs, msgs,
                                                  key_idx)
                    ok = gpued.verify_ed_packed_pending(
                        table, self._send(rec, stats), **self._mesh_kw)
            pending.append((chunk, m, [ok], self._finish_ok))

    def _run_mldsa_packed(self, pset: str, idx: np.ndarray, pb,
                          pending: list,
                          tables: Optional[_KeyTables] = None,
                          stats: Optional[dict] = None) -> None:
        """One ML-DSA parameter set through the fused engine, in chunks
        of ``_chunk_tokens(bpt // 2)`` (1,024 tokens for every set) with
        bpt the per-token device bytes of the JAX keyset's budget,
        padded to a power of two ≥ 128. Tokens whose kid does not name
        one key of the set take the trial path."""
        t = self._tables if tables is None else tables
        table = t.mldsa_tables[pset]
        p = table.params
        rows = self._rows(idx, pb, t.kid_mldsa_row[pset], len(table.keys))
        fast = rows >= 0
        idx, rows = idx[fast], rows[fast]
        # z lanes (l·256 u32) + c lanes (256 u32) + hint lanes (k·256
        # u8) + the key row
        bpt = (p.l + 1) * gpumldsa.N * 4 + p.k * gpumldsa.N + 4
        chunk_n = self._chunk_tokens(max(1, bpt // 2))
        for lo in range(0, len(idx), chunk_n):
            chunk = idx[lo: lo + chunk_n]
            m = len(chunk)
            pad = _pad_size(m, chunk_n)
            telemetry.count("device.mldsa.tokens", m)
            _pad_telemetry("mldsa", m, pad)
            telemetry.count("h2d.bytes", pad * bpt)
            if stats is not None:
                stats["h2d"] += pad * bpt
            with telemetry.span(f"dispatch.mldsa.{pset}"):
                fin = gpumldsa.verify_mldsa_fused_pending(
                    table, [pb.signature(j) for j in chunk.tolist()],
                    [pb.signing_input(j) for j in chunk.tolist()],
                    rows[lo: lo + chunk_n], pad=pad, **self._mesh_kw)

            def finish(chunk, arrs, pb, results, fin=fin):
                okv = fin.verdicts(arrs)
                self.deg_reverified += fin.reverified
                self._finish(chunk, okv, pb, results)

            pending.append((chunk, m, fin.outs, finish))

    def _run_slhdsa_packed(self, pset: str, idx: np.ndarray, pb,
                           pending: list,
                           tables: Optional[_KeyTables] = None,
                           stats: Optional[dict] = None) -> None:
        """One SLH-DSA parameter set: the host decode of each chunk at
        dispatch, its whole hash forest queued on the device, the
        verdict bits at the sync. Chunks of ``_chunk_tokens(bpt // 2)``
        (1,024 tokens for both sets) with bpt the per-token device bytes
        of the JAX keyset's budget, padded to a power of two with a
        16-row floor (not ``_MIN_BUCKET``: an SLH-DSA row is hundreds of
        classical rows' device work). Tokens whose kid does not name
        one key of the set take the trial path."""
        t = self._tables if tables is None else tables
        table = t.slhdsa_tables[pset]
        p = table.params
        rows = self._rows(idx, pb, t.kid_slhdsa_row[pset],
                          len(table.keys))
        fast = rows >= 0
        idx, rows = idx[fast], rows[fast]
        # the signature's hash values plus the precomputed 32-byte ADRS
        # words as interleaved lanes
        bpt = p.sig_size + 32 * (p.k * (p.a + 1) + 1
                                 + p.d * (p.wlen + p.hp + 1))
        chunk_n = self._chunk_tokens(max(1, bpt // 2))
        for lo in range(0, len(idx), chunk_n):
            chunk = idx[lo: lo + chunk_n]
            m = len(chunk)
            pad = min(gpuslh.pad_rows(m), chunk_n)
            telemetry.count("device.slhdsa.tokens", m)
            _pad_telemetry("slhdsa", m, pad)
            telemetry.count("h2d.bytes", pad * bpt)
            if stats is not None:
                stats["h2d"] += pad * bpt
            with telemetry.span(f"dispatch.slhdsa.{pset}"):
                ok = gpuslh.verify_slhdsa_pending(
                    table, [pb.signature(j) for j in chunk.tolist()],
                    [pb.signing_input(j) for j in chunk.tolist()],
                    rows[lo: lo + chunk_n], pad=pad, **self._mesh_kw)
            pending.append((chunk, m, [ok], self._finish_ok))

    def _send(self, rec: np.ndarray, stats: Optional[dict]):
        """One packed chunk's records for the engine, counted as its h2d
        bytes and copied to the keyset's device (:func:`_copy`); over a
        mesh, split into its shards (``parallel.place.shard_bounds``),
        each copied to its device so, timed the same way."""
        _count_h2d(stats, (rec,))
        if self.mesh is None:
            return _copy(rec, self.device, stats)
        from ..parallel.place import Sharded, shard_bounds

        parts = [_copy(rec[sl], dev, stats) for sl, dev in zip(
            shard_bounds(self.mesh, len(rec)), self.mesh.devices)]
        return Sharded(self.mesh, [torch.from_numpy(np.ascontiguousarray(p))
                                   if isinstance(p, np.ndarray) else p
                                   for p in parts])


def _same_device(a, b) -> bool:
    """Whether two device names are one device ("cuda" is card 0)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


# copies smaller than this time the host's hand-off more than the link
_MIN_TIMED_COPY = 1 << 20


def _copy(rec: np.ndarray, device: torch.device, stats: Optional[dict]):
    """Packed records on the engine's device. On the card the copy is
    made here, one of at least ``_MIN_TIMED_COPY`` bytes between two
    CUDA events (the observed rate of ``_observe_wire``); on the CPU
    the records go as they are."""
    if device.type != "cuda":
        return rec
    host = torch.from_numpy(np.ascontiguousarray(rec))
    if rec.nbytes < _MIN_TIMED_COPY:
        return host.to(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    dev = host.to(device)
    end.record()
    if stats is not None:
        stats["copies"].append((int(rec.nbytes), start, end))
    return dev


def _count_h2d(stats: Optional[dict], arrays) -> None:
    """Count one chunk's host arrays as the bytes it sends the device
    (``h2d.bytes``, and the batch's wire estimate)."""
    n = sum(int(a.nbytes) for a in arrays)
    telemetry.count("h2d.bytes", n)
    if stats is not None:
        stats["h2d"] += n


class GPURemoteKeySet(KeySet):
    """A remote JWKS served by a :class:`GPUBatchKeySet` on the card
    (the JAX package's ``TPURemoteKeySet``).

    Keys come from a JWKS endpoint (through ``JSONWebKeySet``) and live
    in device tables. A batch whose tokens present UNKNOWN kids triggers
    at most one refetch and table swap, rate-limited by
    ``min_refresh_interval``; a failed signature under a known kid never
    fetches (forged tokens must not amplify into IdP fetches).
    """

    def __init__(self, jwks_url: str, jwks_ca_pem: Optional[str] = None,
                 max_chunk: int = 32768,
                 min_refresh_interval: float = 10.0, device=None,
                 mesh=None):
        self._remote = JSONWebKeySet(jwks_url, jwks_ca_pem)
        self._max_chunk = max_chunk
        self._min_refresh = min_refresh_interval
        self._device = device
        self._mesh = mesh          # passed to every table rebuild
        self._ks: Optional[GPUBatchKeySet] = None
        self._kids: set = set()
        self._last_refresh = 0.0
        self._lock = threading.Lock()

    def _ensure(self, refresh: bool = False) -> GPUBatchKeySet:
        # Fetch and rebuild under one lock: concurrent rotation triggers
        # must not double-fetch or double-build; unknown random kids are
        # bounded by the cooldown, and an unchanged key set never
        # rebuilds tables.
        with self._lock:
            if self._ks is not None and refresh:
                if time.monotonic() - self._last_refresh < self._min_refresh:
                    return self._ks
            elif self._ks is not None:
                return self._ks
            if refresh:
                # stamp BEFORE the fetch: a failing IdP also respects
                # the cooldown
                self._last_refresh = time.monotonic()
            jwks = self._remote.keys(refresh=refresh)
            kids = {j.kid for j in jwks if j.kid}
            if self._ks is None:
                self._ks = GPUBatchKeySet(jwks, device=self._device,
                                          mesh=self._mesh,
                                          max_chunk=self._max_chunk)
                self._kids = kids
            elif kids != self._kids:
                # a hot swap: in-flight batches finish on their tables,
                # and the wire-rate estimate survives the rotation
                self._ks.swap_keys(jwks)
                self._kids = kids
            return self._ks

    def verify_signature(self, token: str) -> Dict[str, Any]:
        ks = self._ensure()
        try:
            return ks.verify_signature(token)
        except InvalidSignatureError:
            parsed = parse_jws(token)
            if parsed.kid is not None and parsed.kid not in self._kids:
                return self._ensure(refresh=True).verify_signature(token)
            raise

    def verify_batch(self, tokens: Sequence[str]) -> List[Any]:
        return self._verify_rotation_aware(tokens, raw=False)

    def verify_batch_raw(self, tokens: Sequence[str]) -> List[Any]:
        """Raw-claims ``verify_batch``: accepted tokens yield their
        signed payload bytes, with the same at-most-one refetch."""
        return self._verify_rotation_aware(tokens, raw=True)

    def _verify_rotation_aware(self, tokens: Sequence[str],
                               raw: bool) -> List[Any]:
        ks = self._ensure()
        call = ks.verify_batch_raw if raw else ks.verify_batch
        results = call(tokens)
        missed: List[int] = []
        for i, r in enumerate(results):
            if not isinstance(r, InvalidSignatureError):
                continue
            try:
                parsed = parse_jws(tokens[i])
            except Exception:  # noqa: BLE001 - malformed keeps its error
                continue
            if parsed.kid is not None and parsed.kid not in self._kids:
                missed.append(i)
        if missed:
            telemetry.count("jwks.rotation_refetch")
            # A failed refetch must not discard the batch's verdicts:
            # the original per-token errors stand.
            try:
                ks = self._ensure(refresh=True)
                retry_call = ks.verify_batch_raw if raw else \
                    ks.verify_batch
                retry = retry_call([tokens[i] for i in missed])
            except Exception:  # noqa: BLE001 - network/IdP failure
                telemetry.count("jwks.rotation_refetch_failed")
            else:
                for i, r in zip(missed, retry):
                    results[i] = r
        return results

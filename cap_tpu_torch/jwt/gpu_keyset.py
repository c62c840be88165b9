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

Not ported yet (ROADMAP): the two-phase ML-DSA arm (host μ/c̃ around
the device NTT), hot key swaps, the async and stream entry points,
telemetry.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

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
from ..runtime import native_binding as nb
from . import algs
from .jose import normalize_batch, parse_jws
from .jwk import JWK, RSAPublicKey
from .keyset import KeySet
from .verify import key_matches_alg, verify_parsed

_RS = {algs.RS256: "sha256", algs.RS384: "sha384", algs.RS512: "sha512"}
_PS = {algs.PS256: "sha256", algs.PS384: "sha384", algs.PS512: "sha512"}
_ES = {algs.ES256: "P-256", algs.ES384: "P-384", algs.ES512: "P-521"}

_MIN_BUCKET = 128
# RSA key-table rows encode as class * _RSA_CLS_STRIDE + row.
_RSA_CLS_STRIDE = 1 << 16
_MAX_CLASS_KEYS = 255          # the packed record's key row is one byte
_CHUNK_BYTES = 5 << 20         # record bytes per chunk
_MAX_CHUNK = 32768             # tokens per chunk at most
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


def _chunk_tokens(rec_width: int) -> int:
    """Tokens per packed chunk: pow-2, about 5 MB of records (the JAX
    keyset's static budget)."""
    c = 1024
    while c * 2 * rec_width <= _CHUNK_BYTES:
        c *= 2
    return min(_MAX_CHUNK, max(1024, c))


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


class GPUBatchKeySet(KeySet):
    """KeySet whose batch path runs on the GPU verify engine.

    ``jwks``: JWKs of this package (RSA, EC, Ed25519, ML-DSA and SLH-DSA
    keys).
    ``device``: where the engine runs, ``"cuda"`` by default; raises
    when CUDA is absent.
    ``device="cpu"`` runs the plain PyTorch versions of every kernel.
    """

    def __init__(self, jwks: Sequence[JWK], device=None):
        if not jwks:
            raise NilParameterError("at least one key is required")
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; GPUBatchKeySet runs on the card "
                "unless device='cpu' is given")
        self.device = device
        self.deg_reverified = 0
        self._jwks = list(jwks)

        rsa_classes: List[list] = []
        rsa_class_need: List[int] = []
        self._rsa_rows: Dict[int, int] = {}
        self._ec_keys: Dict[str, list] = {}
        self._ec_rows: Dict[str, Dict[int, int]] = {}
        ed_keys: list = []
        self._ed_rows: Dict[int, int] = {}
        # one table per ML-DSA parameter set (alg name = set name)
        mldsa_keys: Dict[str, list] = {}
        self._mldsa_rows: Dict[str, Dict[int, int]] = {}
        slhdsa_keys: Dict[str, list] = {}
        self._slhdsa_rows: Dict[str, Dict[int, int]] = {}
        for i, jwk in enumerate(self._jwks):
            key = jwk.key
            if isinstance(key, RSAPublicKey):
                need = nlimbs_for_bits(key.n.bit_length())
                if need in rsa_class_need:
                    cls = rsa_class_need.index(need)
                else:
                    cls = len(rsa_classes)
                    rsa_classes.append([])
                    rsa_class_need.append(need)
                self._rsa_rows[i] = cls * _RSA_CLS_STRIDE + \
                    len(rsa_classes[cls])
                rsa_classes[cls].append((key.n, key.e))
            elif isinstance(key, gpuec.HostECPublicKey):
                crv = key.curve_name
                rows = self._ec_rows.setdefault(crv, {})
                rows[i] = len(self._ec_keys.setdefault(crv, []))
                self._ec_keys[crv].append(key)
            elif isinstance(key, gpued.HostEd25519PublicKey):
                self._ed_rows[i] = len(ed_keys)
                ed_keys.append(key)
            elif isinstance(key, gpumldsa.MLDSAPublicKey):
                pset = key.parameter_set
                rows = self._mldsa_rows.setdefault(pset, {})
                rows[i] = len(mldsa_keys.setdefault(pset, []))
                mldsa_keys[pset].append(key)
            elif isinstance(key, gpuslh.SLHDSAPublicKey):
                pset = key.parameter_set
                rows = self._slhdsa_rows.setdefault(pset, {})
                rows[i] = len(slhdsa_keys.setdefault(pset, []))
                slhdsa_keys[pset].append(key)
            else:
                raise UnsupportedAlgError(
                    f"key type {type(key).__name__} is not supported by "
                    f"GPUBatchKeySet")
        self._rsa_tables = [gpursa.RSAKeyTable(nums, device)
                            for nums in rsa_classes]
        self._n_rsa_keys = sum(len(c) for c in rsa_classes)
        self._ec_tables = {crv: gpuec.ECKeyTable(crv, keys, device)
                           for crv, keys in self._ec_keys.items()}
        self._ed_table = (gpued.Ed25519KeyTable(ed_keys, device)
                          if ed_keys else None)
        self._mldsa_tables = {
            pset: gpumldsa.MLDSAKeyTable(pset, keys, device)
            for pset, keys in mldsa_keys.items()}
        self._slhdsa_tables = {
            pset: gpuslh.SLHDSAKeyTable(pset, keys, device)
            for pset, keys in slhdsa_keys.items()}

        self._by_kid: Dict[str, List[int]] = {}
        for i, jwk in enumerate(self._jwks):
            if jwk.kid:
                self._by_kid.setdefault(jwk.kid, []).append(i)
        # kid → family table row, for kids naming exactly one key
        self._kid_rsa_row: Dict[str, int] = {}
        self._kid_ec_row: Dict[str, Dict[str, int]] = {
            c: {} for c in self._ec_rows}
        self._kid_ed_row: Dict[str, int] = {}
        self._kid_mldsa_row: Dict[str, Dict[str, int]] = {
            p: {} for p in self._mldsa_rows}
        self._kid_slhdsa_row: Dict[str, Dict[str, int]] = {
            p: {} for p in self._slhdsa_rows}
        for kid, idxs in self._by_kid.items():
            if len(idxs) != 1:
                continue
            i = idxs[0]
            if i in self._rsa_rows:
                self._kid_rsa_row[kid] = self._rsa_rows[i]
            for crv, rows in self._ec_rows.items():
                if i in rows:
                    self._kid_ec_row[crv][kid] = rows[i]
            if i in self._ed_rows:
                self._kid_ed_row[kid] = self._ed_rows[i]
            for pset, rows in self._mldsa_rows.items():
                if i in rows:
                    self._kid_mldsa_row[pset][kid] = rows[i]
            for pset, rows in self._slhdsa_rows.items():
                if i in rows:
                    self._kid_slhdsa_row[pset][kid] = rows[i]

    # -- single-token path (host oracle) -----------------------------------

    def _candidate_indices(self, parsed) -> List[int]:
        if parsed.kid is not None and parsed.kid in self._by_kid:
            pool = self._by_kid[parsed.kid]
        else:
            pool = range(len(self._jwks))
        return [i for i in pool
                if key_matches_alg(self._jwks[i].key, parsed.alg)]

    def _verify_parsed_trial(self, parsed):
        last: Optional[Exception] = None
        for i in self._candidate_indices(parsed):
            try:
                verify_parsed(parsed, self._jwks[i].key)
                return parsed.claims()
            except InvalidSignatureError as e:
                last = e
        raise InvalidSignatureError(_REJECT) from last

    def verify_signature(self, token: str) -> Dict[str, Any]:
        return self._verify_parsed_trial(parse_jws(token))

    def _verify_one_parsed(self, p) -> Any:
        """Trial verification of one parsed token (the slow path)."""
        try:
            return self._verify_parsed_trial(p)
        except (InvalidSignatureError, MalformedTokenError) as e:
            return e

    # -- batch path --------------------------------------------------------

    def verify_batch(self, tokens: Sequence[str]) -> List[Any]:
        return self._collect_batch(self._dispatch_batch(tokens))

    def verify_batch_raw(self, tokens: Sequence[str]) -> List[Any]:
        """Like verify_batch, but a verified token yields its payload
        bytes (the claims JSON the issuer signed) in place of its
        dict. A verified signature over a payload that is not a JSON
        object is rejected as in verify_batch."""
        state = self._dispatch_batch(tokens)
        state["raw"] = True
        return self._collect_batch(state)

    def _dispatch_batch(self, tokens: Sequence[str]) -> dict:
        """Phase 1: prep, bucket, pack and queue every chunk."""
        tokens, specials = normalize_batch(tokens)
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
                    results[i] = self._verify_parsed_trial(sp)
                    special_payloads[i] = sp.payload
                except Exception as e:  # noqa: BLE001 - per-token
                    results[i] = e

        pending: List[tuple] = []       # (chunk, m, device outs, finish)
        alg_ids = {name: k for k, name in enumerate(nb.ALG_NAMES)}

        def family(alg: str) -> np.ndarray:
            return np.nonzero(ok & (pb.alg_id == alg_ids[alg]))[0]

        # post-quantum first: the deepest device programs (the SLH-DSA
        # hash forest, then the ML-DSA NTT network) go on the stream
        # before the cheaper families
        for pset in sorted(self._slhdsa_tables):
            idx = _mldsa_alg_indices(pb, ok, pset)
            if len(idx):
                self._run_slhdsa_packed(pset, idx, pb, pending)
        for pset in sorted(self._mldsa_tables):
            idx = _mldsa_alg_indices(pb, ok, pset)
            if len(idx):
                self._run_mldsa_packed(pset, idx, pb, pending)
        for alg, crv in _ES.items():
            idx = family(alg)
            if crv in self._ec_tables and len(idx):
                self._run_ec_packed(alg, idx, pb, pending)
        idx = family(algs.EdDSA)
        if self._ed_table is not None and len(idx):
            self._run_ed_packed(idx, pb, pending)
        if self._rsa_tables:
            for kind, fam in (("rs", _RS), ("ps", _PS)):
                for alg, hash_name in fam.items():
                    idx = family(alg)
                    if len(idx):
                        self._run_rsa_packed(kind, hash_name, idx, pb,
                                             pending)
        return dict(pb=pb, ok=ok, results=results, pending=pending,
                    special_payloads=special_payloads)

    def _collect_batch(self, state: dict) -> List[Any]:
        """Phase 2: claims parse (raw mode: the object check) while the
        device drains, the syncs, the verdicts, the trial path."""
        pb, ok, results = state["pb"], state["ok"], state["results"]
        raw = state.get("raw", False)
        idx = np.nonzero(ok)[0]
        if raw:
            pb.raw_ok = np.zeros(pb.n, bool)
            pb.raw_ok[idx] = pb.payload_object_ok(idx)
        else:
            pb.prefetch_claims(idx)
        for chunk, m, outs, finish in state["pending"]:
            finish(chunk, [o.cpu().numpy()[:m] for o in outs], pb, results)
        # no unique key candidate, or no table for the family: the trial
        # path on the host oracle
        for j in idx.tolist():
            if results[j] is None:
                out = self._verify_one_parsed(pb.parsed(j))
                if raw and not isinstance(out, Exception):
                    # the oracle built the dict from these bytes
                    out = pb.payload_bytes(j)
                results[j] = out
        if raw:
            for i, pay in state["special_payloads"].items():
                if not isinstance(results[i], Exception):
                    results[i] = pay
        return results

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
                        pb, pending: list) -> None:
        """RS* (``kind`` "rs") or PS* ("ps") tokens in packed chunks per
        RSA class; a class of more than 255 keys gives each chunk to
        ``gpu.rsa`` as arrays (the same chunks and finish)."""
        rows = self._rows(idx, pb, self._kid_rsa_row, self._n_rsa_keys)
        fast = rows >= 0
        idx, rows = idx[fast], rows[fast]
        h_len = gpursa.HASH_LEN[hash_name]
        for cls, table in enumerate(self._rsa_tables):
            sel = (rows // _RSA_CLS_STRIDE) == cls
            if not sel.any():
                continue
            cls_idx = idx[sel]
            cls_rows = rows[sel] % _RSA_CLS_STRIDE
            chunk_n = _chunk_tokens(2 * table.k + h_len
                                    + gpursa.RS_REC_EXTRA)
            big = len(table.n_ints) > _MAX_CLASS_KEYS
            for lo in range(0, len(cls_idx), chunk_n):
                chunk = cls_idx[lo: lo + chunk_n]
                crows = cls_rows[lo: lo + chunk_n]
                pad = _pad_size(len(chunk), chunk_n)
                if big:
                    # the arrays path (_run_rsa_arrays in the JAX keyset)
                    verify = (gpursa.verify_pkcs1v15_arrays_pending
                              if kind == "rs"
                              else gpursa.verify_pss_arrays_pending)
                    sig_mat, sig_lens, hash_mat, key_idx = self._arrays(
                        pb, chunk, crows, 2 * table.k, pad)
                    ok = verify(table, sig_mat, sig_lens, hash_mat,
                                hash_name, key_idx)
                else:
                    verify = (gpursa.verify_rs_packed_pending
                              if kind == "rs"
                              else gpursa.verify_ps_packed_pending)
                    ok = verify(table, rsa_records(pb, table, kind,
                                                   hash_name, chunk, crows,
                                                   pad), hash_name)
                pending.append((chunk, len(chunk), [ok], self._finish_ok))

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
                       pending: list) -> None:
        """ES* tokens of one curve in packed chunks; a curve of more
        than 255 keys gives each chunk to ``gpu.ec`` as arrays (the same
        chunks, engine and finish)."""
        crv = _ES[alg]
        table = self._ec_tables[crv]
        hash_len = gpursa.HASH_LEN[algs.HASH_FOR_ALG[alg]]
        rows = self._rows(idx, pb, self._kid_ec_row[crv], len(table.keys))
        fast = rows >= 0
        idx, rows = idx[fast], rows[fast]
        cb = table.coord_bytes
        chunk_n = _chunk_tokens(2 * cb + hash_len + gpuec.ES_REC_EXTRA)
        big = len(table.keys) > _MAX_CLASS_KEYS
        for lo in range(0, len(idx), chunk_n):
            chunk = idx[lo: lo + chunk_n]
            crows = rows[lo: lo + chunk_n]
            m = len(chunk)
            pad = _pad_size(m, chunk_n)
            if big:
                # the arrays path (_run_ec_arrays in the JAX keyset)
                sig_mat, sig_lens, hash_mat, key_idx = self._arrays(
                    pb, chunk, crows, 2 * cb, pad)
                ok, deg = gpuec.verify_ecdsa_arrays_pending(
                    table, sig_mat, sig_lens, hash_mat, hash_len, key_idx)
                sig_of = sig_mat[:, :2 * cb]
                dig_of = hash_mat[:, :hash_len]
            else:
                rec = es_records(pb, table, chunk, crows, hash_len, pad)
                ok, deg = gpuec.verify_es_packed_pending(table, rec,
                                                         hash_len)
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

    def _run_ed_packed(self, idx: np.ndarray, pb, pending: list) -> None:
        """EdDSA tokens in packed chunks (``_chunk_tokens(64 + 32 + 2)``:
        32,768 tokens), padded to a power of two ≥ 128 with empty
        signatures on key row 0. More than 255 keys: the same chunks go
        to ``gpu.ed25519`` as lists and int64 key rows."""
        table = self._ed_table
        rows = self._rows(idx, pb, self._kid_ed_row, len(table.keys))
        fast = rows >= 0
        idx, rows = idx[fast], rows[fast]
        chunk_n = _chunk_tokens(64 + 32 + gpued.ED_REC_EXTRA)
        for lo in range(0, len(idx), chunk_n):
            chunk = idx[lo: lo + chunk_n]
            m = len(chunk)
            pad = _pad_size(m, chunk_n)
            fill = pad - m
            sigs = [pb.signature(j) for j in chunk.tolist()]
            msgs = [pb.signing_input(j) for j in chunk.tolist()]
            key_idx = np.zeros(pad, np.int64)
            key_idx[:m] = rows[lo: lo + chunk_n]
            sigs += [b""] * fill
            msgs += [b""] * fill
            if len(table.keys) > _MAX_CLASS_KEYS:
                # the arrays path (_run_ed_arrays in the JAX keyset)
                ok = gpued.verify_ed25519_batch_pending(table, sigs, msgs,
                                                        key_idx)
            else:
                rec = gpued.ed_packed_records(table, sigs, msgs, key_idx)
                ok = gpued.verify_ed_packed_pending(table, rec)
            pending.append((chunk, m, [ok], self._finish_ok))

    def _run_mldsa_packed(self, pset: str, idx: np.ndarray, pb,
                          pending: list) -> None:
        """One ML-DSA parameter set through the fused engine, in chunks
        of ``_chunk_tokens(bpt // 2)`` (1,024 tokens for every set) with
        bpt the per-token device bytes of the JAX keyset's budget,
        padded to a power of two ≥ 128. Tokens whose kid does not name
        one key of the set take the trial path."""
        table = self._mldsa_tables[pset]
        p = table.params
        rows = self._rows(idx, pb, self._kid_mldsa_row[pset],
                          len(table.keys))
        fast = rows >= 0
        idx, rows = idx[fast], rows[fast]
        # z lanes (l·256 u32) + c lanes (256 u32) + hint lanes (k·256
        # u8) + the key row
        bpt = (p.l + 1) * gpumldsa.N * 4 + p.k * gpumldsa.N + 4
        chunk_n = _chunk_tokens(max(1, bpt // 2))
        for lo in range(0, len(idx), chunk_n):
            chunk = idx[lo: lo + chunk_n]
            m = len(chunk)
            pad = _pad_size(m, chunk_n)
            fin = gpumldsa.verify_mldsa_fused_pending(
                table, [pb.signature(j) for j in chunk.tolist()],
                [pb.signing_input(j) for j in chunk.tolist()],
                rows[lo: lo + chunk_n], pad=pad)

            def finish(chunk, arrs, pb, results, fin=fin):
                okv = fin.verdicts(arrs)
                self.deg_reverified += fin.reverified
                self._finish(chunk, okv, pb, results)

            pending.append((chunk, m, fin.outs, finish))

    def _run_slhdsa_packed(self, pset: str, idx: np.ndarray, pb,
                           pending: list) -> None:
        """One SLH-DSA parameter set: the host decode of each chunk at
        dispatch, its whole hash forest queued on the device, the
        verdict bits at the sync. Chunks of ``_chunk_tokens(bpt // 2)``
        (1,024 tokens for both sets) with bpt the per-token device bytes
        of the JAX keyset's budget, padded to a power of two with a
        16-row floor (not ``_MIN_BUCKET``: an SLH-DSA row is hundreds of
        classical rows' device work). Tokens whose kid does not name
        one key of the set take the trial path."""
        table = self._slhdsa_tables[pset]
        p = table.params
        rows = self._rows(idx, pb, self._kid_slhdsa_row[pset],
                          len(table.keys))
        fast = rows >= 0
        idx, rows = idx[fast], rows[fast]
        # the signature's hash values plus the precomputed 32-byte ADRS
        # words as interleaved lanes
        bpt = p.sig_size + 32 * (p.k * (p.a + 1) + 1
                                 + p.d * (p.wlen + p.hp + 1))
        chunk_n = _chunk_tokens(max(1, bpt // 2))
        for lo in range(0, len(idx), chunk_n):
            chunk = idx[lo: lo + chunk_n]
            m = len(chunk)
            ok = gpuslh.verify_slhdsa_pending(
                table, [pb.signature(j) for j in chunk.tolist()],
                [pb.signing_input(j) for j in chunk.tolist()],
                rows[lo: lo + chunk_n],
                pad=min(gpuslh.pad_rows(m), chunk_n))
            pending.append((chunk, m, [ok], self._finish_ok))

"""JOSE (JWS) parsing: compact and JSON serializations.

The reference delegates to go-jose's ``jose.ParseSigned``
(jwt/jwt.go:212, jwt/keyset.go:155); this is a from-scratch strict
parser. Compact form ``b64url(header).b64url(payload).b64url(sig)``
per RFC 7515:
- exactly three dot-separated segments;
- base64url *without* padding, no whitespace;
- the protected header must be a JSON object;
- the ``alg`` header must be present and a string;
- any ``crit`` protected header is rejected (go-jose rejects every
  JWS bearing one — "unsupported crit header" — and this framework
  matches that verdict bit-for-bit, jwt/jwt.go:212 via ParseSigned).

The JSON serialization (RFC 7515 §7.2, both flattened and general
forms) is accepted with exactly ONE signature, matching the
reference's post-parse check (jwt/jwt.go:212-227): go-jose
auto-detects a leading ``{`` and the reference then requires
``len(parsedJWT.Headers) == 1``.

The GPU keyset's batch prep (gpu_keyset.py) maps these parse errors
onto the native prep's status messages; this module is the reference
implementation and single-token path. ``parse_jws`` dispatches on serialization form;
``json_to_compact`` re-serializes a JSON-form token so the batch
paths (native prep, TPU packing, serve) stay compact-only.
"""

from __future__ import annotations

import base64
import binascii
import json
from dataclasses import dataclass
from typing import Any, Dict

from ..errors import MalformedTokenError, TokenNotSignedError

_B64URL_CHARS = frozenset(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_"
)


def b64url_decode(segment: str) -> bytes:
    """Strict unpadded base64url decode (RFC 7515 §2)."""
    if not set(segment) <= _B64URL_CHARS:
        raise MalformedTokenError("illegal base64url character")
    if len(segment) % 4 == 1:
        raise MalformedTokenError("illegal base64url length")
    pad = "=" * (-len(segment) % 4)
    try:
        return base64.urlsafe_b64decode(segment + pad)
    except (binascii.Error, ValueError) as e:
        raise MalformedTokenError(f"invalid base64url segment: {e}") from e


def b64url_encode(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


@dataclass(frozen=True)
class ParsedJWS:
    """A parsed (but unverified) compact JWS."""

    header: Dict[str, Any]       # decoded protected header
    payload: bytes               # decoded payload bytes
    signature: bytes             # decoded signature bytes
    signing_input: bytes         # ascii(b64(header) + "." + b64(payload))

    @property
    def alg(self) -> str:
        return self.header["alg"]

    @property
    def kid(self) -> str | None:
        kid = self.header.get("kid")
        return kid if isinstance(kid, str) else None

    def claims(self) -> Dict[str, Any]:
        """Decode the payload as a JSON claims object (unverified)."""
        try:
            claims = json.loads(self.payload)
        except (ValueError, UnicodeDecodeError) as e:
            raise MalformedTokenError(f"payload is not valid JSON: {e}") from e
        if not isinstance(claims, dict):
            raise MalformedTokenError("payload is not a JSON object")
        return claims


def _split_and_header(token: str):
    """Shared strict structural parse: split, decode+check the header.

    Returns (header_dict, raw_header, raw_payload, raw_sig). Single
    source of truth for the structural rules — peek_alg, parse_compact
    and the batch prep all key off this behavior.
    """
    if not isinstance(token, str) or not token:
        raise MalformedTokenError("token is empty")
    parts = token.split(".")
    if len(parts) != 3:
        raise MalformedTokenError(
            f"compact JWS must have 3 segments, found {len(parts)}"
        )
    raw_header, raw_payload, raw_sig = parts
    header_bytes = b64url_decode(raw_header)
    try:
        header = json.loads(header_bytes)
    except (ValueError, UnicodeDecodeError) as e:
        raise MalformedTokenError(f"protected header is not valid JSON: {e}") from e
    if not isinstance(header, dict):
        raise MalformedTokenError("protected header is not a JSON object")
    alg = header.get("alg")
    if not isinstance(alg, str) or not alg:
        raise MalformedTokenError("protected header missing alg parameter")
    if "crit" in header:
        # go-jose rejects any JWS carrying a crit header, regardless of
        # its value; matching that keeps rejection parity with the
        # reference's verify path (jwt/keyset.go:155-167).
        raise MalformedTokenError("unsupported crit header")
    return header, raw_header, raw_payload, raw_sig


def peek_alg(token: str) -> str:
    """Return the alg header of a JWS, enforcing the same structural
    rules as :func:`parse_jws` but (for the compact form) without
    decoding the payload segment — cheap header-only inspection."""
    if is_json_form(token):
        return parse_json(token).alg
    header, _, raw_payload, raw_sig = _split_and_header(token)
    # Validate payload/signature segment charsets without decoding bytes.
    for seg in (raw_payload, raw_sig):
        if not set(seg) <= _B64URL_CHARS or len(seg) % 4 == 1:
            raise MalformedTokenError("illegal base64url segment")
    if not raw_sig:
        raise TokenNotSignedError("token must be signed")
    return header["alg"]


def parse_compact(token: str) -> ParsedJWS:
    """Parse a compact-serialization JWS without verifying it."""
    header, raw_header, raw_payload, raw_sig = _split_and_header(token)
    payload = b64url_decode(raw_payload)
    signature = b64url_decode(raw_sig)
    if len(signature) == 0:
        raise TokenNotSignedError("token must be signed")
    signing_input = (raw_header + "." + raw_payload).encode("ascii")
    return ParsedJWS(
        header=header,
        payload=payload,
        signature=signature,
        signing_input=signing_input,
    )


def is_json_form(token) -> bool:
    """True when the token uses the JWS JSON serialization (go-jose's
    detection rule: first non-whitespace byte is ``{``)."""
    return isinstance(token, str) and token.lstrip()[:1] == "{"


def _json_segment(obj, field: str, what: str) -> str:
    v = obj.get(field)
    if not isinstance(v, str):
        raise MalformedTokenError(f"JSON JWS {what} missing {field!r}")
    if not set(v) <= _B64URL_CHARS or len(v) % 4 == 1:
        raise MalformedTokenError("illegal base64url segment")
    return v


def _parse_json_signature(doc, sig_obj) -> ParsedJWS:
    """One signature object (+ shared payload) → ParsedJWS."""
    raw_payload = _json_segment(doc, "payload", "document")
    raw_header = _json_segment(sig_obj, "protected", "signature")
    raw_sig = _json_segment(sig_obj, "signature", "signature")

    header_bytes = b64url_decode(raw_header)
    try:
        header = json.loads(header_bytes)
    except (ValueError, UnicodeDecodeError) as e:
        raise MalformedTokenError(
            f"protected header is not valid JSON: {e}") from e
    if not isinstance(header, dict):
        raise MalformedTokenError("protected header is not a JSON object")

    unprotected = sig_obj.get("header")
    if unprotected is not None:
        if not isinstance(unprotected, dict):
            raise MalformedTokenError(
                "JSON JWS unprotected header is not a JSON object")
        # RFC 7515 §7.2.1: the two header sets MUST be disjoint.
        dup = set(header) & set(unprotected)
        if dup:
            raise MalformedTokenError(
                f"duplicate header parameter {sorted(dup)[0]!r}")
        merged = dict(unprotected)
        merged.update(header)
        header = merged

    alg = header.get("alg")
    if not isinstance(alg, str) or not alg:
        raise MalformedTokenError("protected header missing alg parameter")
    if "crit" in header:
        raise MalformedTokenError("unsupported crit header")

    payload = b64url_decode(raw_payload)
    signature = b64url_decode(raw_sig)
    if len(signature) == 0:
        raise TokenNotSignedError("token must be signed")
    return ParsedJWS(
        header=header,
        payload=payload,
        signature=signature,
        signing_input=(raw_header + "." + raw_payload).encode("ascii"),
    )


def parse_json(token: str) -> ParsedJWS:
    """Parse a JSON-serialization JWS (RFC 7515 §7.2) with exactly one
    signature — flattened or general form.

    The reference accepts this form through go-jose's ParseSigned and
    then enforces the single signature itself (jwt/jwt.go:212-227);
    more than one signature is rejected the same way here.
    """
    try:
        doc = json.loads(token)
    except (ValueError, UnicodeDecodeError) as e:
        raise MalformedTokenError(f"JSON JWS is not valid JSON: {e}") from e
    if not isinstance(doc, dict):
        raise MalformedTokenError("JSON JWS is not a JSON object")

    sigs = doc.get("signatures")
    if sigs is None:
        return _parse_json_signature(doc, doc)  # flattened form
    if not isinstance(sigs, list) or len(sigs) != 1:
        raise MalformedTokenError(
            "JSON JWS must carry exactly one signature")
    if "signature" in doc or "protected" in doc or "header" in doc:
        # RFC 7515 §7.2.1/§7.2.2: the general and flattened members are
        # mutually exclusive in one document.
        raise MalformedTokenError(
            "JSON JWS mixes general and flattened members")
    if not isinstance(sigs[0], dict):
        raise MalformedTokenError("JSON JWS signature is not an object")
    return _parse_json_signature(doc, sigs[0])


def parse_jws(token: str) -> ParsedJWS:
    """Parse a JWS in either serialization (go-jose ParseSigned's
    dispatch rule: a leading ``{`` means the JSON form)."""
    if is_json_form(token):
        return parse_json(token)
    return parse_compact(token)


def json_normalize(token: str):
    """Parse a JSON-form JWS; return ``(compact_or_None, parsed)``.

    ``compact`` preserves the signing input byte-for-byte (protected +
    "." + payload as they appear in the document), so signatures verify
    identically. ``compact`` is None — callers must verify via the
    returned ParsedJWS, whose merged header is authoritative — when
    the compact re-serialization would change the VERDICT, not just
    the bytes:

    - ``alg`` lives only in the unprotected header: the compact form
      would parse as alg-less and flip an accept into a reject;
    - ``kid`` lives only in the unprotected header: compacting drops
      it, so key selection would widen from "the kid-named key" to
      "every key of the alg's type" — a token whose unprotected kid
      names a different trusted key would then accept on the batch
      path while ``verify_signature`` (merged-header kid routing)
      rejects it.
    """
    parsed = parse_json(token)
    doc = json.loads(token)
    sig_obj = doc if doc.get("signatures") is None else doc["signatures"][0]
    protected = json.loads(b64url_decode(sig_obj["protected"]))
    if not isinstance(protected.get("alg"), str) or not protected["alg"]:
        return None, parsed
    unprotected = sig_obj.get("header")
    if isinstance(unprotected, dict) and "kid" in unprotected:
        return None, parsed
    return ".".join((sig_obj["protected"], doc["payload"],
                     sig_obj["signature"])), parsed


def json_to_compact(token: str) -> str:
    """Re-serialize a JSON-form JWS as the equivalent compact token.

    Raises for tokens whose compact form would verify differently
    (alg or kid present solely in the unprotected header) — batch
    machinery uses :func:`normalize_batch`, which falls back to
    object-path verification for those instead.
    """
    compact, _ = json_normalize(token)
    if compact is None:
        raise MalformedTokenError(
            "JSON JWS is not representable compactly without changing "
            "its verification semantics (alg or kid only in the "
            "unprotected header)")
    return compact


def normalize_batch(tokens):
    """Shared batch normalization: JSON-form entries → compact.

    Returns ``(tokens', specials)``. ``tokens'`` is ``tokens`` with
    every JSON-form entry replaced by its compact re-serialization
    (or ``""`` when it has none); ``specials`` maps those indices that
    can't ride the compact machinery to either the ParsedJWS to verify
    on the object path (valid but non-compactable) or the exact parse
    exception. The single source of truth for prep and the TPU batch
    dispatcher, so their error channels can never diverge.
    """
    out = None
    specials = {}
    for i, t in enumerate(tokens):
        if not is_json_form(t):
            continue
        if out is None:
            out = list(tokens)
        try:
            compact, parsed = json_normalize(t)
        except Exception as e:  # noqa: BLE001 - per-token error channel
            specials[i] = e
            out[i] = ""
            continue
        if compact is None:
            specials[i] = parsed
            out[i] = ""
        else:
            out[i] = compact
    return (tokens if out is None else out), specials

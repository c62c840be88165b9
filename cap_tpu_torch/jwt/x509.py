"""A strict DER reader for X.509 certificates and SubjectPublicKeyInfo.

The JAX package reads ``x5c`` chains and PEM keys with ``cryptography``
(``x509.load_der_x509_certificate``, ``Certificate.public_key``,
``load_der_public_key``). The card's machine has no ``cryptography``, so
the port reads them here in pure Python, with the same strictness in
both directions: what ``cryptography`` 46 loads loads here, and what it
rejects is rejected here.

Two stages, as in ``cryptography``:

- :func:`load_der_x509_certificate` parses the whole ``Certificate``
  with DER's rules (minimal tags, lengths and INTEGERs, no indefinite
  lengths, no trailing bytes, DEFAULT values omitted, SET OF in order,
  BIT STRING padding bits zero, UTCTime/GeneralizedTime to the second
  with ``Z``, PrintableString/BMPString/UniversalString contents
  checked), and the parameters of every AlgorithmIdentifier whose OID it
  knows. A failure raises ``ValueError``; a version other than v1 or v3
  raises :class:`InvalidVersion`.
- :func:`load_der_public_key` (``Certificate.public_key``) reads the
  key: ``rsaEncryption`` and ``id-RSASSA-PSS`` (a PKCS#1 RSAPublicKey)
  give :class:`~cap_tpu_torch.jwt.jwk.RSAPublicKey`; ``id-ecPublicKey``
  on P-256, P-384, P-521, secp256k1, P-192 or P-224 (compressed,
  uncompressed or hybrid points, on-curve and below p) gives
  :class:`~cap_tpu_torch.gpu.ec.HostECPublicKey` (curve names "P-256",
  "P-384", "P-521", else the reference's: "secp256k1", "secp192r1",
  "secp224r1"); ``id-Ed25519`` gives
  :class:`~cap_tpu_torch.gpu.ed25519.HostEd25519PublicKey`; Ed448,
  X25519, X448, DSA, DH and the binary and Brainpool curves that
  ``cryptography`` supports give :class:`OtherPublicKey` (the point on
  those curves is not checked), which no JOSE alg of the port uses. A
  named curve ``cryptography`` does not support raises
  :class:`UnsupportedAlgorithm`; any other failure raises
  ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..gpu.ec import _CURVE_INTS, HostECPublicKey
from ..gpu.ed25519 import HostEd25519PublicKey
from .jwk import RSAPublicKey


class InvalidVersion(Exception):
    """A certificate version other than v1 (0) or v3 (2)."""


class UnsupportedAlgorithm(Exception):
    """An EC key on a named curve that the reference's parser lacks."""


class OtherPublicKey:
    """A public key the reference's parser loads but no JOSE alg of the
    port uses: Ed448, X25519, X448, DSA, DH, or an EC key on a binary or
    Brainpool curve (its point is not checked)."""

    def __init__(self, kind: str, curve_name: Optional[str] = None):
        self.kind = kind
        self.curve_name = curve_name

    def __repr__(self) -> str:
        return f"OtherPublicKey({self.kind!r}, {self.curve_name!r})"


def _err(what: str) -> ValueError:
    return ValueError(f"error parsing asn1 value: {what}")


# ---------------------------------------------------------------------------
# DER primitives
# ---------------------------------------------------------------------------

# a tag is (class, constructed, number)
SEQUENCE = (0, True, 16)
SET = (0, True, 17)
INTEGER = (0, False, 2)
BIT_STRING = (0, False, 3)
OCTET_STRING = (0, False, 4)
NULL = (0, False, 5)
OID = (0, False, 6)
BOOLEAN = (0, False, 1)
UTC_TIME = (0, False, 23)
GENERALIZED_TIME = (0, False, 24)
PRINTABLE_STRING = (0, False, 19)
BMP_STRING = (0, False, 30)
UNIVERSAL_STRING = (0, False, 28)


def _base128(data: bytes, pos: int, end: int,
             max_bytes: int) -> Tuple[int, int]:
    """One base-128 integer (high bit: more follows), minimal."""
    value = 0
    for i in range(max_bytes):
        if pos >= end:
            raise _err("ShortData")
        b = data[pos]
        pos += 1
        if i == 0 and b == 0x80:
            raise _err("InvalidValue (non-minimal base-128)")
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos
    raise _err("InvalidValue (base-128 integer too long)")


class _Reader:
    """A cursor over data[pos:end] reading DER TLVs."""

    def __init__(self, data: bytes, pos: int = 0, end: Optional[int] = None):
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else end

    def empty(self) -> bool:
        return self.pos >= self.end

    def _tag(self) -> Tuple[Tuple[int, bool, int], int]:
        data, pos = self.data, self.pos
        if pos >= self.end:
            raise _err("ShortData")
        b = data[pos]
        pos += 1
        num = b & 0x1F
        if num == 0x1F:
            num, pos = _base128(data, pos, self.end, 5)
            if not 0x1F <= num < 1 << 32:
                raise _err("InvalidTag")
        return (b >> 6, bool(b & 0x20), num), pos

    def peek_tag(self) -> Optional[Tuple[int, bool, int]]:
        if self.empty():
            return None
        return self._tag()[0]

    def read_tlv(self) -> Tuple[Tuple[int, bool, int], int, int, int]:
        """(tag, start of the TLV, start of the content, end of it)."""
        start = self.pos
        tag, pos = self._tag()
        if pos >= self.end:
            raise _err("ShortData")
        first = self.data[pos]
        pos += 1
        if first < 0x80:
            length = first
        elif 0x81 <= first <= 0x84:
            n = first - 0x80
            if pos + n > self.end:
                raise _err("ShortData")
            length = int.from_bytes(self.data[pos:pos + n], "big")
            pos += n
            if length < (0x80 if n == 1 else 1 << (8 * (n - 1))):
                raise _err("InvalidLength")
        else:
            raise _err("InvalidLength")
        if pos + length > self.end:
            raise _err(f"ShortData (needed {pos + length - self.end})")
        self.pos = pos + length
        return tag, start, pos, pos + length

    def read(self, want) -> "_Reader":
        """The next element, which must carry tag ``want``; returns a
        reader over its content."""
        tag, _, a, b = self.read_tlv()
        if tag != want:
            raise _err(f"UnexpectedTag {tag}")
        return _Reader(self.data, a, b)

    def optional(self, want) -> Optional["_Reader"]:
        if self.peek_tag() != want:
            return None
        return self.read(want)

    def bytes_of(self) -> bytes:
        return self.data[self.pos:self.end]

    def finish(self) -> None:
        if not self.empty():
            raise _err("ExtraData")


def _parse_single(data: bytes, want) -> _Reader:
    r = _Reader(data)
    content = r.read(want)
    r.finish()
    return content


def _integer(content: bytes, signed: bool) -> int:
    if not content:
        raise _err("InvalidValue (empty INTEGER)")
    if len(content) > 1 and (
            (content[0] == 0 and not content[1] & 0x80)
            or (content[0] == 0xFF and content[1] & 0x80)):
        raise _err("InvalidValue (non-minimal INTEGER)")
    if not signed and content[0] & 0x80:
        raise _err("InvalidValue (negative INTEGER)")
    return int.from_bytes(content, "big", signed=signed)


def _read_uint(r: _Reader, limit: Optional[int] = None) -> int:
    v = _integer(r.read(INTEGER).bytes_of(), signed=False)
    if limit is not None and v > limit:
        raise _err("IntegerOverflow")
    return v


def _read_oid(r: _Reader) -> str:
    c = r.read(OID)
    data = c.bytes_of()
    if not data or len(data) > 63:
        raise _err("InvalidValue (OID length)")
    arcs: List[int] = []
    pos = 0
    while pos < len(data):
        v, pos = _base128(data, pos, len(data), 19)
        if v >= 1 << 128:
            raise _err("InvalidValue (OID arc)")
        if not arcs:
            arcs.extend((v // 40, v % 40) if v < 80 else (2, v - 80))
        else:
            arcs.append(v)
    return ".".join(map(str, arcs))


def _bit_string(content: bytes) -> bytes:
    """The bytes of a BIT STRING after its unused-bits count, whose
    padding bits must be zero."""
    if not content:
        raise _err("InvalidValue (empty BIT STRING)")
    unused, body = content[0], content[1:]
    if unused > 7 or (not body and unused):
        raise _err("InvalidValue (BIT STRING padding)")
    if unused and body[-1] & ((1 << unused) - 1):
        raise _err("InvalidValue (BIT STRING padding bits)")
    return body


def _read_null(r: _Reader) -> None:
    if r.read(NULL).bytes_of():
        raise _err("InvalidValue (NULL with content)")


def _read_bool(r: _Reader) -> bool:
    v = r.read(BOOLEAN).bytes_of()
    if v not in (b"\x00", b"\xff"):
        raise _err("InvalidValue (BOOLEAN)")
    return v == b"\xff"


# ---------------------------------------------------------------------------
# Times and names
# ---------------------------------------------------------------------------

def _digits(s: bytes, n: int) -> int:
    if len(s) < n or not all(0x30 <= c <= 0x39 for c in s[:n]):
        raise _err("InvalidValue (time digits)")
    return int(s[:n])


def _days_in_month(year: int, month: int) -> int:
    if month == 2:
        leap = year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)
        return 29 if leap else 28
    return 30 if month in (4, 6, 9, 11) else 31


def _read_time(r: _Reader) -> None:
    tag = r.peek_tag()
    if tag == UTC_TIME:
        s = r.read(UTC_TIME).bytes_of()
        if len(s) != 13:
            raise _err("InvalidValue (UTCTime)")
        year = _digits(s, 2)
        year += 1900 if year >= 50 else 2000
        rest = s[2:]
    elif tag == GENERALIZED_TIME:
        s = r.read(GENERALIZED_TIME).bytes_of()
        if len(s) != 15:
            raise _err("InvalidValue (GeneralizedTime)")
        year = _digits(s, 4)
        rest = s[4:]
    else:
        raise _err(f"UnexpectedTag {tag}")
    month, day = _digits(rest, 2), _digits(rest[2:], 2)
    hour, minute = _digits(rest[4:], 2), _digits(rest[6:], 2)
    second = _digits(rest[8:], 2)
    if rest[10:] != b"Z":
        raise _err("InvalidValue (time zone)")
    if not (1 <= month <= 12 and 1 <= day <= _days_in_month(year, month)
            and hour < 24 and minute < 60 and second < 60):
        raise _err("InvalidValue (date)")


_PRINTABLE = frozenset(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
                       b"0123456789 '()+,-./:=?")


def _check_attribute_value(tag, content: bytes) -> None:
    if tag == PRINTABLE_STRING:
        if not set(content) <= _PRINTABLE:
            raise _err("InvalidValue (PrintableString)")
    elif tag == BMP_STRING:
        try:
            content.decode("utf-16-be")
        except UnicodeDecodeError:
            raise _err("InvalidValue (BMPString)") from None
    elif tag == UNIVERSAL_STRING:
        try:
            content.decode("utf-32-be")
        except UnicodeDecodeError:
            raise _err("InvalidValue (UniversalString)") from None


def _read_set_of(r: _Reader, element) -> None:
    """SET OF: every element parses, in DER order (by encoding)."""
    s = r.read(SET)
    last = None
    while not s.empty():
        _, start, _, end = s.read_tlv()
        enc = s.data[start:end]
        if last is not None and enc < last:
            raise _err("InvalidSetOrdering")
        last = enc
        s.pos = start
        element(s)


def _read_attribute(r: _Reader) -> None:
    a = r.read(SEQUENCE)
    _read_oid(a)
    tag, _, lo, hi = a.read_tlv()
    _check_attribute_value(tag, a.data[lo:hi])
    a.finish()


def _read_name(r: _Reader) -> None:
    rdns = r.read(SEQUENCE)
    while not rdns.empty():
        _read_set_of(rdns, _read_attribute)


# ---------------------------------------------------------------------------
# AlgorithmIdentifier
# ---------------------------------------------------------------------------

RSA_ENCRYPTION = "1.2.840.113549.1.1.1"
RSASSA_PSS = "1.2.840.113549.1.1.10"
MGF1 = "1.2.840.113549.1.1.8"
EC_PUBLIC_KEY = "1.2.840.10045.2.1"
ED25519 = "1.3.101.112"
ED448 = "1.3.101.113"
X25519 = "1.3.101.110"
X448 = "1.3.101.111"
DSA = "1.2.840.10040.4.1"
DH = "1.2.840.113549.1.3.1"
DHX = "1.2.840.10046.2.1"
SHA1 = "1.3.14.3.2.26"

# AlgorithmIdentifier parameters by OID, as the reference's parser types
# them; any other OID takes one optional element of any kind.
# An optional NULL: RSA and the RSA, ECDSA and DSA signatures over SHA-1,
# SHA-2 and SHA-3, the hashes and HMACs.
_OPT_NULL = {
    RSA_ENCRYPTION,
    "1.2.840.113549.1.1.4", "1.2.840.113549.1.1.5", "1.3.14.3.2.29",
    "1.2.840.113549.1.1.11", "1.2.840.113549.1.1.12",
    "1.2.840.113549.1.1.13", "1.2.840.113549.1.1.14",
    "2.16.840.1.101.3.4.3.13", "2.16.840.1.101.3.4.3.14",
    "2.16.840.1.101.3.4.3.15", "2.16.840.1.101.3.4.3.16",
    "1.2.840.10045.4.1", "1.2.840.10045.4.3.1", "1.2.840.10045.4.3.2",
    "1.2.840.10045.4.3.3", "1.2.840.10045.4.3.4",
    "2.16.840.1.101.3.4.3.9", "2.16.840.1.101.3.4.3.10",
    "2.16.840.1.101.3.4.3.11", "2.16.840.1.101.3.4.3.12",
    "1.2.840.10040.4.3", "2.16.840.1.101.3.4.3.1", "2.16.840.1.101.3.4.3.2",
    "2.16.840.1.101.3.4.3.3", "2.16.840.1.101.3.4.3.4",
    SHA1, "2.16.840.1.101.3.4.2.1", "2.16.840.1.101.3.4.2.2",
    "2.16.840.1.101.3.4.2.3", "2.16.840.1.101.3.4.2.4",
    "2.16.840.1.101.3.4.2.7", "2.16.840.1.101.3.4.2.8",
    "2.16.840.1.101.3.4.2.9", "2.16.840.1.101.3.4.2.10",
    "1.2.840.113549.2.7", "1.2.840.113549.2.8", "1.2.840.113549.2.9",
    "1.2.840.113549.2.10", "1.2.840.113549.2.11",
}
# No parameters at all.
_ABSENT = {ED25519, ED448, X25519, X448}
# A SEQUENCE of unsigned INTEGERs: (how many are required, at most).
_INT_PARAMS = {DSA: (3, 3), DH: (2, 3), DHX: (3, 4)}


def _read_explicit(r: _Reader, number: int) -> Optional[_Reader]:
    return r.optional((2, True, number))


def _read_pss_params(r: _Reader) -> None:
    """RSASSA-PSS-params; an encoded DEFAULT is an error."""
    s = r.read(SEQUENCE)
    h = _read_explicit(s, 0)
    if h is not None:
        oid, params = _read_algorithm(h)
        h.finish()
        if oid == SHA1 and params == "null":
            raise _err("EncodedDefault")
    m = _read_explicit(s, 1)
    if m is not None:
        mg = m.read(SEQUENCE)
        oid = _read_oid(mg)
        hoid, hparams = _read_algorithm(mg)
        mg.finish()
        m.finish()
        if oid == MGF1 and hoid == SHA1 and hparams == "null":
            raise _err("EncodedDefault")
    salt = _read_explicit(s, 2)
    if salt is not None:
        v = _read_uint(salt, 0xFFFF)
        salt.finish()
        if v == 20:
            raise _err("EncodedDefault")
    trailer = _read_explicit(s, 3)
    if trailer is not None:
        _read_uint(trailer, 0xFF)
        trailer.finish()
    s.finish()


def _read_algorithm(r: _Reader):
    """AlgorithmIdentifier → (oid, params): params is None, "null", a
    curve OID, "implicit", "specified", or the raw bytes of an element
    the parser does not type."""
    a = r.read(SEQUENCE)
    oid = _read_oid(a)
    params = None
    if oid in _OPT_NULL:
        if a.peek_tag() == NULL:
            _read_null(a)
            params = "null"
    elif oid in _ABSENT:
        pass
    elif oid == EC_PUBLIC_KEY:
        tag = a.peek_tag()
        if tag == OID:
            params = _read_oid(a)
        elif tag == NULL:
            _read_null(a)
            params = "implicit"
        elif tag == SEQUENCE:
            a.read(SEQUENCE)                # explicit curve parameters
            params = "specified"
        else:
            raise _err(f"UnexpectedTag {tag}")
    elif oid == RSASSA_PSS:
        if a.peek_tag() == SEQUENCE:
            _read_pss_params(a)
    elif oid in _INT_PARAMS:
        need, most = _INT_PARAMS[oid]
        p = a.read(SEQUENCE)
        got = 0
        while got < most and (got < need or p.peek_tag() == INTEGER):
            _read_uint(p)
            got += 1
        if oid == DHX and not p.empty():       # validationParams
            v = p.read(SEQUENCE)
            _bit_string(v.read(BIT_STRING).bytes_of())
            _read_uint(v)
            v.finish()
        p.finish()
    elif not a.empty():
        _, start, _, end = a.read_tlv()
        params = a.data[start:end]
    a.finish()
    return oid, params


# ---------------------------------------------------------------------------
# Certificate
# ---------------------------------------------------------------------------

class Certificate:
    """A parsed X.509 certificate: its DER, version and key."""

    def __init__(self, der: bytes, version: int, spki: bytes):
        self.der = der
        self.version = version
        self.spki = spki

    def public_key(self):
        """The subject's public key (see :func:`load_der_public_key`)."""
        return load_der_public_key(self.spki)


def _read_extensions(r: _Reader) -> None:
    seq = r.read(SEQUENCE)
    while not seq.empty():
        e = seq.read(SEQUENCE)
        _read_oid(e)
        if e.peek_tag() == BOOLEAN and not _read_bool(e):
            raise _err("EncodedDefault")          # critical DEFAULT FALSE
        e.read(OCTET_STRING)
        e.finish()


def load_der_x509_certificate(der: bytes) -> Certificate:
    """Parse a DER certificate; ``ValueError`` on any DER or structure
    fault, :class:`InvalidVersion` for a version other than v1 or v3."""
    der = bytes(der)
    cert = _parse_single(der, SEQUENCE)
    tbs = cert.read(SEQUENCE)
    version = 0
    v = _read_explicit(tbs, 0)
    if v is not None:
        version = _read_uint(v, 0xFF)
        v.finish()
        if version == 0:
            raise _err("EncodedDefault")
    _integer(tbs.read(INTEGER).bytes_of(), signed=True)      # serial
    _read_algorithm(tbs)
    _read_name(tbs)                                         # issuer
    validity = tbs.read(SEQUENCE)
    _read_time(validity)
    _read_time(validity)
    validity.finish()
    _read_name(tbs)                                         # subject
    spki_start = tbs.pos
    s = tbs.read(SEQUENCE)
    spki = der[spki_start:tbs.pos]
    _read_algorithm(s)
    _bit_string(s.read(BIT_STRING).bytes_of())
    s.finish()
    for number in (1, 2):                       # issuer, subject unique ID
        uid = tbs.optional((2, False, number))
        if uid is not None:
            _bit_string(uid.bytes_of())
    ext = _read_explicit(tbs, 3)
    if ext is not None:
        _read_extensions(ext)
        ext.finish()
    tbs.finish()
    _read_algorithm(cert)
    _bit_string(cert.read(BIT_STRING).bytes_of())
    cert.finish()
    if version not in (0, 2):
        raise InvalidVersion(f"{version} is not a valid X509 version")
    return Certificate(der, version, spki)


# ---------------------------------------------------------------------------
# SubjectPublicKeyInfo
# ---------------------------------------------------------------------------

# Named curves by OID: (the reference parser's curve name, the port's
# own key curve name where it checks the point, else None).
_NAMED_CURVES: Dict[str, Tuple[str, Optional[str]]] = {
    "1.2.840.10045.3.1.7": ("secp256r1", "P-256"),
    "1.3.132.0.34": ("secp384r1", "P-384"),
    "1.3.132.0.35": ("secp521r1", "P-521"),
    "1.3.132.0.10": ("secp256k1", "secp256k1"),
    "1.2.840.10045.3.1.1": ("secp192r1", "secp192r1"),
    "1.3.132.0.33": ("secp224r1", "secp224r1"),
    "1.3.132.0.1": ("sect163k1", None),
    "1.3.132.0.15": ("sect163r2", None),
    "1.3.132.0.26": ("sect233k1", None),
    "1.3.132.0.27": ("sect233r1", None),
    "1.3.132.0.16": ("sect283k1", None),
    "1.3.132.0.17": ("sect283r1", None),
    "1.3.132.0.36": ("sect409k1", None),
    "1.3.132.0.37": ("sect409r1", None),
    "1.3.132.0.38": ("sect571k1", None),
    "1.3.132.0.39": ("sect571r1", None),
    "1.3.36.3.3.2.8.1.1.7": ("brainpoolP256r1", None),
    "1.3.36.3.3.2.8.1.1.11": ("brainpoolP384r1", None),
    "1.3.36.3.3.2.8.1.1.13": ("brainpoolP512r1", None),
}

# Short Weierstrass y^2 = x^3 + a x + b over F_p.
_P256_B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B  # noqa: E501
_P384_B = 0xB3312FA7E23EE7E4988E056BE3F82D19181D9C6EFE8141120314088F5013875AC656398D8A2ED19D2A85C8EDD3EC2AEF  # noqa: E501
_P521_B = 0x0051953EB9618E1C9A1F929A21A0B68540EEA2DA725B99B315F3B8B489918EF109E156193951EC7E937B1652C0BD3BB1BF073573DF883D2C34F1EF451FD46B503F00  # noqa: E501
_WEIERSTRASS = {
    "P-256": (_CURVE_INTS["P-256"]["p"], -3, _P256_B),
    "P-384": (_CURVE_INTS["P-384"]["p"], -3, _P384_B),
    "P-521": (_CURVE_INTS["P-521"]["p"], -3, _P521_B),
    "secp256k1": ((1 << 256) - (1 << 32) - 977, 0, 7),
    "secp192r1": ((1 << 192) - (1 << 64) - 1, -3,
                  0x64210519E59C80E70FA7E9AB72243049FEB8DEECC146B9B1),
    "secp224r1": ((1 << 224) - (1 << 96) + 1, -3,
                  0xB4050A850C04B3ABF54132565044B0B7D7BFD8BA270B39432355FFB4),
}


def _sqrt_mod(a: int, p: int) -> Optional[int]:
    """A square root of a mod the prime p, or None (Tonelli-Shanks)."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r

_INVALID_KEY = "Invalid key"
_UNDECODABLE = (
    "Could not deserialize key data. The data may be in an incorrect "
    "format, it may be encrypted with an unsupported algorithm, or it may "
    "be an unsupported key type (e.g. EC curves with explicit parameters).")


def decode_point(crv: str, data: bytes) -> Tuple[int, int]:
    """SEC 1 point decoding (uncompressed, compressed, hybrid) with the
    range and on-curve checks; ``ValueError`` otherwise."""
    p, a, b = _WEIERSTRASS[crv]
    size = (p.bit_length() + 7) // 8
    if not data:
        raise ValueError(_INVALID_KEY)
    form, ybit = data[0] & 0xFE, data[0] & 1
    if form == 0:
        if data == b"\x00":
            raise ValueError(
                "Cannot load an EC public key where the point is at infinity")
        raise ValueError(_INVALID_KEY)
    if form == 2:
        if len(data) != 1 + size:
            raise ValueError(_INVALID_KEY)
        x = int.from_bytes(data[1:], "big")
        if x >= p:
            raise ValueError(_INVALID_KEY)
        y = _sqrt_mod(x * x * x + a * x + b, p)
        if y is None:
            raise ValueError(_INVALID_KEY)
        if y & 1 != ybit:
            y = (p - y) % p
        return x, y
    if form not in (4, 6) or (form == 4 and ybit) or \
            len(data) != 1 + 2 * size:
        raise ValueError(_INVALID_KEY)
    x = int.from_bytes(data[1:1 + size], "big")
    y = int.from_bytes(data[1 + size:], "big")
    if x >= p or y >= p or (form == 6 and y & 1 != ybit) or \
            (y * y - (x * x * x + a * x + b)) % p:
        raise ValueError(_INVALID_KEY)
    return x, y


def _rsa_public_key(body: bytes) -> RSAPublicKey:
    try:
        s = _parse_single(body, SEQUENCE)
        n = _read_uint(s)
        e = _read_uint(s)
        s.finish()
    except ValueError:
        raise ValueError(_UNDECODABLE) from None
    return RSAPublicKey(n, e)


def load_der_public_key(spki: bytes):
    """The key of a DER SubjectPublicKeyInfo (see the module docstring)."""
    try:
        s = _parse_single(bytes(spki), SEQUENCE)
        oid, params = _read_algorithm(s)
        body = _bit_string(s.read(BIT_STRING).bytes_of())
        s.finish()
    except ValueError:
        raise ValueError(_UNDECODABLE) from None
    if oid in (RSA_ENCRYPTION, RSASSA_PSS):
        return _rsa_public_key(body)
    if oid == EC_PUBLIC_KEY:
        if params in ("implicit", "specified"):
            raise ValueError("ECDSA keys with explicit parameters are "
                             "unsupported at this time")
        if params not in _NAMED_CURVES:
            raise UnsupportedAlgorithm(f"Curve {params} is not supported")
        name, crv = _NAMED_CURVES[params]
        if crv is None:
            return OtherPublicKey("EC", name)
        x, y = decode_point(crv, body)
        return HostECPublicKey(crv, x, y)
    raw_sizes = {ED25519: 32, ED448: 57, X25519: 32, X448: 56}
    if oid in raw_sizes:
        if len(body) != raw_sizes[oid]:
            raise ValueError(_INVALID_KEY)
        if oid == ED25519:
            return HostEd25519PublicKey(body)
        return OtherPublicKey({ED448: "Ed448", X25519: "X25519",
                               X448: "X448"}[oid])
    if oid in _INT_PARAMS:
        try:
            _integer(_parse_single(body, INTEGER).bytes_of(), signed=False)
        except ValueError:
            raise ValueError(_UNDECODABLE) from None
        return OtherPublicKey("DSA" if oid == DSA else "DH")
    raise ValueError(f"Unknown key type: {oid}")


# ---------------------------------------------------------------------------
# PEM
# ---------------------------------------------------------------------------

def _pem_body(body: bytes) -> bytes:
    """The DER of a PEM block's body: RFC 1421 headers (lines with ':'
    up to a blank line) skipped, whitespace dropped, the base64's
    trailing '=' optional."""
    import base64
    import binascii

    lines = body.replace(b"\r", b"").split(b"\n")
    while lines and not lines[0].strip():
        lines.pop(0)
    if lines and b":" in lines[0] and b"" in [ln.strip() for ln in lines]:
        lines = lines[[ln.strip() for ln in lines].index(b"") + 1:]
    b64 = b"".join(b"".join(ln.split()) for ln in lines)
    data = b64.rstrip(b"=")
    pads = len(b64) - len(data)
    if len(data) % 4 == 1 or pads not in (0, -len(data) % 4):
        raise ValueError("PEM base64 has a bad length or padding")
    try:
        return base64.b64decode(data + b"=" * (-len(data) % 4), validate=True)
    except (binascii.Error, ValueError) as e:
        raise ValueError(f"PEM base64 does not decode: {e}") from e


def pem_blocks(data: bytes, first_only: bool = False
               ) -> List[Tuple[str, bytes]]:
    """The ``-----BEGIN label-----`` … ``-----END label-----`` blocks of
    ``data`` as (label, DER), in order; text around them is skipped.
    ``ValueError`` when there is none, or on a block that does not
    close, closes under another label, or whose base64 does not decode.
    ``first_only``: read only the first block."""
    out = []
    pos = 0
    while not (first_only and out):
        begin = data.find(b"-----BEGIN ", pos)
        if begin < 0:
            break
        label_end = data.find(b"-----", begin + 11)
        end = data.find(b"-----END ", label_end + 5) if label_end >= 0 else -1
        close = data.find(b"-----", end + 9) if end >= 0 else -1
        if close < 0:
            raise ValueError("PEM block is not closed")
        label = data[begin + 11:label_end]
        if data[end + 9:close] != label:
            raise ValueError("PEM END label differs from its BEGIN label")
        out.append((label.decode("ascii", "replace"),
                    _pem_body(data[label_end + 5:end])))
        pos = close + 5
    if not out:
        raise ValueError("no PEM block found")
    return out


def load_pem_x509_certificate(data: bytes) -> Certificate:
    """The first CERTIFICATE (or X509 CERTIFICATE) block of ``data``."""
    for label, der in pem_blocks(data):
        if label in ("CERTIFICATE", "X509 CERTIFICATE"):
            return load_der_x509_certificate(der)
    raise ValueError("no BEGIN CERTIFICATE block")


def load_pem_public_key(data: bytes):
    """The key of the first PEM block: a ``PUBLIC KEY`` (SPKI) block, or
    an ``RSA PUBLIC KEY`` block (PKCS#1, or an SPKI holding an RSA
    key)."""
    (label, der), = pem_blocks(data, first_only=True)
    if label == "PUBLIC KEY":
        return load_der_public_key(der)
    if label != "RSA PUBLIC KEY":
        raise ValueError("no BEGIN PUBLIC KEY block")
    try:
        return _rsa_public_key(der)
    except ValueError:
        try:
            key = load_der_public_key(der)
        except (ValueError, UnsupportedAlgorithm):
            key = None
        if not isinstance(key, RSAPublicKey):
            raise
        return key

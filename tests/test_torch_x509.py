"""x5c JWKs and PEM keys: the port's DER reader (``jwt/x509.py``)
behind ``parse_jwk`` and ``parse_public_key_pem``, against the JAX
package's ``cryptography`` route, live on the same documents.

Outcomes compare as: equal keys, kids, algs and uses; or equal class
and message. Two classes are mapped, as ROADMAP §C records: where the
JAX package lets ``cryptography``'s own ``InvalidVersion`` or
``UnsupportedAlgorithm`` escape, the port raises ``InvalidJWKSError``
(``InvalidParameterError`` on the PEM route). Texts that are
``cryptography``'s or OpenSSL's own (after "invalid x5c certificate at
index i: ", a raw ``ValueError`` from a leaf's key, a mapped class, and
after "failed to parse ...: ") are not compared.
"""

import base64
import random
import warnings

import pytest

pytest.importorskip("cryptography")

from cryptography import x509 as cx509  # noqa: E402
from cryptography.hazmat.primitives import hashes  # noqa: E402
from cryptography.hazmat.primitives.asymmetric import (  # noqa: E402
    ec,
    ed448,
    ed25519,
    padding,
    rsa,
    x25519,
)
from cryptography.hazmat.primitives.serialization import (  # noqa: E402
    Encoding,
    PublicFormat,
)

from cap_tpu import testing as captest  # noqa: E402
from cap_tpu.jwt import jwk as j_jwk  # noqa: E402
from cap_tpu.jwt import pem as j_pem  # noqa: E402
from cap_tpu.jwt.keyset import JSONWebKeySet as JJSONWebKeySet  # noqa: E402
from cap_tpu.jwt.keyset import StaticKeySet as JStaticKeySet  # noqa: E402

from cap_tpu_torch import testing as tt  # noqa: E402
from cap_tpu_torch.gpu.ec import HostECPublicKey  # noqa: E402
from cap_tpu_torch.gpu.ed25519 import HostEd25519PublicKey  # noqa: E402
from cap_tpu_torch.gpu.mldsa import keygen as mldsa_keygen  # noqa: E402
from cap_tpu_torch.jwt import jwk as t_jwk  # noqa: E402
from cap_tpu_torch.jwt import pem as t_pem  # noqa: E402
from cap_tpu_torch.jwt import x509 as t_x509  # noqa: E402
from cap_tpu_torch.jwt.jose import b64url_encode  # noqa: E402
from cap_tpu_torch.jwt.keyset import JSONWebKeySet  # noqa: E402
from cap_tpu_torch.jwt.keyset import StaticKeySet  # noqa: E402

_JOSE_CURVE = {"secp256r1": "P-256", "secp384r1": "P-384",
               "secp521r1": "P-521"}
_UNCHECKED = ("sect", "brainpool")
MAPPED = {"InvalidVersion": "InvalidJWKSError",
          "UnsupportedAlgorithm": "InvalidJWKSError"}


def _norm(key):
    """A key of either package as comparable numbers."""
    if isinstance(key, rsa.RSAPublicKey):
        n = key.public_numbers()
        return "RSA", n.n, n.e
    if isinstance(key, t_jwk.RSAPublicKey):
        return "RSA", key.n, key.e
    if isinstance(key, ec.EllipticCurvePublicKey):
        name = key.curve.name
        if name.startswith(_UNCHECKED):
            return "EC-unchecked", name
        n = key.public_numbers()
        return "EC", _JOSE_CURVE.get(name, name), n.x, n.y
    if isinstance(key, HostECPublicKey):
        n = key.public_numbers()
        return "EC", key.curve_name, n.x, n.y
    if isinstance(key, ed25519.Ed25519PublicKey):
        return "Ed25519", key.public_bytes(Encoding.Raw, PublicFormat.Raw)
    if isinstance(key, HostEd25519PublicKey):
        return "Ed25519", key.raw
    if isinstance(key, t_x509.OtherPublicKey):
        if key.kind == "EC":
            return "EC-unchecked", key.curve_name
        return "other", key.kind
    if hasattr(key, "parameter_set"):
        return key.parameter_set, bytes(key.pk)
    return "other", type(key).__name__.replace("PublicKey", "")


def _message(cls: str, msg: str):
    """The part of a message that is compared; None for none."""
    if cls == "ValueError" or cls in MAPPED:
        return None
    for prefix in ("invalid x5c certificate at index",
                   "failed to parse certificate",
                   "failed to parse public key PEM",
                   "unsupported public key type"):
        if msg.startswith(prefix):
            return msg.split(":")[0]
    return msg


def jwk_outcome(parse, doc):
    try:
        j = parse(doc)
    except Exception as e:  # noqa: BLE001 - compared across packages
        cls = type(e).__name__
        return MAPPED.get(cls, cls), _message(cls, str(e))
    return "jwk", _norm(j.key), j.kid, j.alg, j.use


def agree(got, want) -> bool:
    """Equal outcomes; a message of None (not compared) matches any."""
    if got[0] == "jwk" or want[0] == "jwk" or got[0] != want[0]:
        return got == want
    return None in (got[1], want[1]) or got[1] == want[1]


def same_jwk(doc):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jwk_outcome(j_jwk.parse_jwk, doc)
    got = jwk_outcome(t_jwk.parse_jwk, doc)
    assert agree(got, want), (doc.get("kty"), got, want)
    return got


# ---------------------------------------------------------------------------
# keys made from seed 0, so the certificates' keys repeat run to run
# ---------------------------------------------------------------------------

KEYS = [("RS256", 2048), ("RS256", 4096), ("ES256", 0), ("ES384", 0),
        ("ES512", 0), ("EdDSA", 0)]
_CURVES = {"ES256": ("P-256", ec.SECP256R1), "ES384": ("P-384", ec.SECP384R1),
           "ES512": ("P-521", ec.SECP521R1)}
_KEY_CACHE = {}


def ref_key(alg: str, bits: int = 2048, seed: int = 0):
    """A cryptography private key from the port's seeded generators."""
    ident = (alg, bits, seed)
    if ident not in _KEY_CACHE:
        rng = random.Random(seed)
        if alg == "RS256":
            k = tt.generate_rsa_key(rng, bits)
            pub = rsa.RSAPublicNumbers(k.e, k.n)
            priv = rsa.RSAPrivateNumbers(k.p, k.q, k.d, k.dp, k.dq, k.qinv,
                                         pub).private_key()
        elif alg == "EdDSA":
            priv = ed25519.Ed25519PrivateKey.from_private_bytes(
                rng.randbytes(32))
        else:
            crv, cls = _CURVES[alg]
            priv = ec.derive_private_key(tt.generate_ec_key(rng, crv).d,
                                         cls())
        _KEY_CACHE[ident] = priv
    return _KEY_CACHE[ident]


def _ids(keys):
    return [f"{a}-{b}" if b else a for a, b in keys]


# ---------------------------------------------------------------------------
# x5c: the JAX package's cases (TestX5CKeys, TestX5CChainValidation)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("include_params", [False, True])
@pytest.mark.parametrize("alg,bits", KEYS, ids=_ids(KEYS))
def test_x5c_jwk_parses_and_verifies(alg, bits, include_params):
    priv = ref_key(alg, bits)
    doc = captest.x5c_jwk(priv, priv.public_key(), kid="x1",
                          include_params=include_params)
    fields = ("n", "e") if alg == "RS256" else ("x", "y")
    assert any(f in doc for f in fields) == include_params
    got = same_jwk(dict(doc, alg=alg, use="sig"))
    assert got[1] == _norm(priv.public_key())
    tok = captest.sign_jwt(priv, alg, captest.default_claims(), kid="x1")
    key = t_jwk.parse_jwk(doc).key
    assert (StaticKeySet([key]).verify_signature(tok)
            == JStaticKeySet([priv.public_key()]).verify_signature(tok))


@pytest.mark.parametrize("alg,bits", KEYS, ids=_ids(KEYS))
def test_x5c_params_mismatching_chain(alg, bits):
    priv = ref_key(alg, bits)
    other = ref_key(alg, bits, seed=1).public_key()
    doc = captest.x5c_jwk(priv, priv.public_key(), include_params=True)
    doc.update({k: v for k, v in j_jwk.serialize_public_key(other).items()
                if k in ("n", "e", "x", "y")})
    assert same_jwk(doc) == (
        "InvalidJWKSError", "jwk parameters do not match x5c certificate key")


@pytest.mark.parametrize("kty", ["RSA", "EC", "OKP", "oct", None])
@pytest.mark.parametrize("alg,bits", KEYS[1:4:2] + KEYS[5:],
                         ids=_ids(KEYS[1:4:2] + KEYS[5:]))
def test_x5c_kty_against_the_chain(alg, bits, kty):
    """kty against the cert's key type, with and without crv."""
    priv = ref_key(alg, bits)
    doc = captest.x5c_jwk(priv, priv.public_key())
    for crv in (None, "Ed25519", "P-256", "P-384", "P-192"):
        d = dict(doc, kty=kty)
        d.pop("crv", None)
        if crv is not None:
            d["crv"] = crv
        same_jwk(d)


@pytest.mark.parametrize("alg,bits", KEYS, ids=_ids(KEYS))
def test_x5c_malformed_params_reject(alg, bits):
    """Malformed parameters reject even beside a valid chain."""
    priv = ref_key(alg, bits)
    doc = captest.x5c_jwk(priv, priv.public_key())
    for bad in ({"x": 123, "y": 456}, {"n": 17}, {"e": "AQAB"},
                {"x": "!!!"}, {"y": "AAAA"}):
        same_jwk(dict(doc, **bad))


@pytest.mark.parametrize("alg,bits", KEYS[2:], ids=_ids(KEYS[2:]))
def test_x5c_bad_chains(alg, bits):
    priv = ref_key(alg, bits)
    doc = captest.x5c_jwk(priv, priv.public_key())
    leaf = doc["x5c"][0]
    garbage = base64.b64encode(b"not a certificate").decode()
    chains = [[], ["!!!"], "not-a-list", [42], {"a": 1}, [leaf, garbage],
              [leaf, "!!!not-base64!!!"], [leaf, leaf], [garbage, leaf],
              [leaf[:-4]], [leaf + "="], [leaf.replace("M", "é", 1)],
              [" " + leaf]]
    for chain in chains:
        same_jwk(dict(doc, x5c=chain))
    # a base64 failure keeps binascii's own text, equal in both
    for chain in (["!!!"], [leaf, "!!!not-base64!!!"]):
        msgs = []
        for parse in (j_jwk.parse_jwk, t_jwk.parse_jwk):
            with pytest.raises(Exception) as exc:
                parse(dict(doc, x5c=chain))
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


def test_x5c_curves_and_key_types_the_port_lacks():
    """A chain whose key is on secp256k1, Ed448 or X25519 (cryptography
    builds these certificates; X25519 cannot sign, so an Ed25519 issuer
    signs it)."""
    name = cx509.Name([cx509.NameAttribute(cx509.oid.NameOID.COMMON_NAME,
                                           "x")])
    import datetime

    now = datetime.datetime(2024, 1, 1, tzinfo=datetime.timezone.utc)
    issuer = ed25519.Ed25519PrivateKey.generate()

    def cert_of(pub):
        c = (cx509.CertificateBuilder().subject_name(name).issuer_name(name)
             .public_key(pub).serial_number(7).not_valid_before(now)
             .not_valid_after(now + datetime.timedelta(days=1))
             .sign(issuer, None))
        return base64.b64encode(c.public_bytes(Encoding.DER)).decode()

    pubs = [ec.generate_private_key(ec.SECP256K1()).public_key(),
            ec.generate_private_key(ec.SECP224R1()).public_key(),
            ed448.Ed448PrivateKey.generate().public_key(),
            x25519.X25519PrivateKey.generate().public_key()]
    for pub in pubs:
        for kty, crv in (("EC", None), ("EC", "P-256"), ("OKP", "Ed25519"),
                         ("RSA", None)):
            d = {"kty": kty, "x5c": [cert_of(pub)]}
            if crv:
                d["crv"] = crv
            same_jwk(d)


def test_akp_ignores_x5c():
    """An AKP key is parsed before the chain is read."""
    _, pub = mldsa_keygen("ML-DSA-44", bytes(32))
    good = {"kty": "AKP", "alg": "ML-DSA-44", "pub": b64url_encode(pub.pk),
            "x5c": ["!!!"], "kid": "pq"}
    assert same_jwk(good)[1] == ("ML-DSA-44", bytes(pub.pk))
    short = dict(good, pub=b64url_encode(b"abc"))
    assert same_jwk(short) == (
        "InvalidJWKSError",
        "invalid AKP jwk: ML-DSA-44 public key must be 1312 bytes, got 3")


def test_x5c_jwks_over_http():
    priv = ref_key("ES256")
    rs = ref_key("RS256")
    state = {"keys": [captest.x5c_jwk(priv, priv.public_key(), kid="x1"),
                      captest.x5c_jwk(rs, rs.public_key(), kid="x2",
                                      include_params=True)]}
    toks = [captest.sign_jwt(priv, "ES256", captest.default_claims(),
                             kid="x1"),
            captest.sign_jwt(rs, "RS256", captest.default_claims(),
                             kid="x2")]
    with captest.jwks_test_server(state) as (url, _srv):
        for tok in toks:
            assert (JSONWebKeySet(url).verify_signature(tok)
                    == JJSONWebKeySet(url).verify_signature(tok))


# ---------------------------------------------------------------------------
# the mutation sweep
# ---------------------------------------------------------------------------

# Mutants where the port cannot give the JAX package's outcome, by
# position and reason: none.
UNMATCHED = {}


@pytest.mark.parametrize("alg", ["RS256", "ES256", "EdDSA"])
def test_mutation_sweep(alg):
    """Every single-byte mutant (XOR 0x01, XOR 0x80, 0x00) and every
    truncation of a ``captest.x5c_jwk`` certificate, as the only key
    material of a JWK: both packages accept with equal keys, or both
    raise with the mapped class."""
    priv = ref_key(alg)
    doc = captest.x5c_jwk(priv, priv.public_key(), kid="m")
    der = base64.b64decode(doc["x5c"][0])
    mutants = []
    for i in range(len(der)):
        for how, byte in (("xor01", der[i] ^ 0x01), ("xor80", der[i] ^ 0x80),
                          ("zero", 0)):
            if byte != der[i]:
                mutants.append((f"{i}:{how}",
                                der[:i] + bytes([byte]) + der[i + 1:]))
    mutants += [(f"truncate:{k}", der[:k]) for k in range(len(der))]
    seen, bad = {}, []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for where, m in mutants:
            d = dict(doc, x5c=[base64.b64encode(m).decode()])
            want = jwk_outcome(j_jwk.parse_jwk, d)
            got = jwk_outcome(t_jwk.parse_jwk, d)
            seen[want[0]] = seen.get(want[0], 0) + 1
            if not agree(got, want) and where not in UNMATCHED.get(alg, ()):
                bad.append((where, want, got))
    assert not bad, f"{len(bad)} of {len(mutants)} mutants differ: {bad[:5]}"
    assert seen.get("jwk") and seen.get("InvalidJWKSError"), seen


# ---------------------------------------------------------------------------
# the port's certificates under cryptography
# ---------------------------------------------------------------------------

def test_cryptography_loads_the_port_certificates():
    rng = random.Random(0)
    privs = [tt.generate_rsa_key(rng), tt.generate_ec_key(rng, "P-256"),
             tt.generate_ec_key(rng, "P-384"),
             tt.generate_ec_key(rng, "P-521"), tt.generate_ed25519_key(rng)]
    for priv in privs:
        doc = tt.x5c_jwk(priv, kid="p", rng=rng)
        cert = cx509.load_der_x509_certificate(
            base64.b64decode(doc["x5c"][0]))
        key = cert.public_key()
        assert _norm(key) == _norm(priv.public_key())
        args = {rsa.RSAPublicKey: (padding.PKCS1v15(), hashes.SHA256()),
                ec.EllipticCurvePublicKey: (ec.ECDSA(hashes.SHA256()),)}
        extra = next((v for k, v in args.items() if isinstance(key, k)), ())
        key.verify(cert.signature, cert.tbs_certificate_bytes, *extra)
        assert cert.version == cx509.Version.v3
        assert same_jwk(doc)[1] == _norm(priv.public_key())
        assert same_jwk(tt.x5c_jwk(priv, include_params=True,
                                   rng=rng))[1] == _norm(priv.public_key())


# ---------------------------------------------------------------------------
# PEM
# ---------------------------------------------------------------------------

def pem_outcome(parse, pem):
    try:
        key = parse(pem)
    except Exception as e:  # noqa: BLE001 - compared across packages
        cls = type(e).__name__
        return ("InvalidParameterError" if cls in MAPPED else cls,
                _message(cls, str(e)))
    return "key", _norm(key)


def _pem_cases():
    cases = {}
    for alg, bits in KEYS:
        priv = ref_key(alg, bits)
        pub = priv.public_key()
        spki = pub.public_bytes(Encoding.PEM,
                                PublicFormat.SubjectPublicKeyInfo)
        cases[f"spki {alg}-{bits}"] = spki
        cases[f"spki str {alg}-{bits}"] = spki.decode()
        der = base64.b64decode(captest.x5c_jwk(priv, pub)["x5c"][0])
        cases[f"cert {alg}-{bits}"] = (
            b"-----BEGIN CERTIFICATE-----\n" + base64.encodebytes(der)
            + b"-----END CERTIFICATE-----\n")
        cases[f"cert junk {alg}-{bits}"] = (
            b"subject=CN x\n" + cases[f"cert {alg}-{bits}"] + b"trailer")
        cases[f"junk around {alg}-{bits}"] = b"# key\n" + spki + b"\nend"
    rs = ref_key("RS256").public_key()
    pkcs1 = rs.public_bytes(Encoding.PEM, PublicFormat.PKCS1)
    spki = rs.public_bytes(Encoding.PEM, PublicFormat.SubjectPublicKeyInfo)
    es = ref_key("ES256").public_key()
    es_spki = es.public_bytes(Encoding.PEM, PublicFormat.SubjectPublicKeyInfo)
    cases.update({
        "pkcs1": pkcs1,
        "pkcs1 junk": b"junk " + pkcs1 + b" junk",
        "rsa label over spki": spki.replace(b"PUBLIC KEY", b"RSA PUBLIC KEY"),
        "rsa label over ec": es_spki.replace(b"PUBLIC KEY",
                                             b"RSA PUBLIC KEY"),
        "pkcs1 under spki label": pkcs1.replace(b"RSA PUBLIC KEY",
                                                b"PUBLIC KEY"),
        "two blocks": es_spki + spki,
        "mismatched end": spki.replace(b"END PUBLIC", b"END PRIVATE"),
        "no end": spki.split(b"-----END")[0],
        "crlf": spki.replace(b"\n", b"\r\n"),
        "missing padding": spki.replace(b"=\n", b"\n"),
        "compressed p256": (
            b"-----BEGIN PUBLIC KEY-----\n" + base64.encodebytes(
                es.public_bytes(Encoding.DER,
                                PublicFormat.SubjectPublicKeyInfo)[:26]
                + es.public_bytes(Encoding.X962,
                                  PublicFormat.CompressedPoint))
            + b"-----END PUBLIC KEY-----\n").replace(b"MFkw", b"MDkw"),
        "ed448": ed448.Ed448PrivateKey.generate().public_key().public_bytes(
            Encoding.PEM, PublicFormat.SubjectPublicKeyInfo),
        "x25519": x25519.X25519PrivateKey.generate().public_key()
        .public_bytes(Encoding.PEM, PublicFormat.SubjectPublicKeyInfo),
        "secp256k1": ec.generate_private_key(ec.SECP256K1()).public_key()
        .public_bytes(Encoding.PEM, PublicFormat.SubjectPublicKeyInfo),
        "garbage": b"garbage",
        "empty": b"",
        "garbage CERTIFICATE": b"CERTIFICATE garbage",
        "key under certificate label": spki.replace(b"PUBLIC KEY",
                                                    b"CERTIFICATE"),
        "port spki": tt.spki_pem(t_jwk.RSAPublicKey(rs.public_numbers().n,
                                                    65537)),
        "port pkcs1": tt.pkcs1_pem(t_jwk.RSAPublicKey(rs.public_numbers().n,
                                                      65537)),
    })
    return cases


PEM_CASES = _pem_cases()


@pytest.mark.parametrize("name", sorted(PEM_CASES))
def test_pem_forms(name):
    pem = PEM_CASES[name]
    got = pem_outcome(t_pem.parse_public_key_pem, pem)
    want = pem_outcome(j_pem.parse_public_key_pem, pem)
    assert got == want if "key" in (got[0], want[0]) else agree(got, want)


def test_pem_secp256k1_key_matches_no_alg():
    """The JAX package accepts a secp256k1 PEM; no alg matches the key,
    so every token under it fails in StaticKeySet, in both."""
    priv = ec.generate_private_key(ec.SECP256K1())
    pem = priv.public_key().public_bytes(Encoding.PEM,
                                         PublicFormat.SubjectPublicKeyInfo)
    tok = captest.sign_jwt(ref_key("ES256"), "ES256",
                           captest.default_claims())
    outs = []
    for ks in (JStaticKeySet([j_pem.parse_public_key_pem(pem)]),
               StaticKeySet([t_pem.parse_public_key_pem(pem)])):
        with pytest.raises(Exception) as exc:
            ks.verify_signature(tok)
        outs.append((type(exc.value).__name__, str(exc.value)))
    assert outs[0] == outs[1]


def test_pem_brainpool_point_unchecked():
    """ROADMAP §C: on a Brainpool or binary curve the port does not
    check the point (the JAX package, through OpenSSL, does), so it
    loads a key there whose point is off the curve."""
    priv = ec.generate_private_key(ec.BrainpoolP256R1())
    der = bytearray(priv.public_key().public_bytes(
        Encoding.DER, PublicFormat.SubjectPublicKeyInfo))
    der[-1] ^= 1
    pem = (b"-----BEGIN PUBLIC KEY-----\n" + base64.encodebytes(bytes(der))
           + b"-----END PUBLIC KEY-----\n")
    assert pem_outcome(j_pem.parse_public_key_pem, pem)[0] == \
        "InvalidParameterError"
    assert pem_outcome(t_pem.parse_public_key_pem, pem) == (
        "key", ("EC-unchecked", "brainpoolP256r1"))


# ---------------------------------------------------------------------------
# crafted DER: the reader against load_der_x509_certificate + public_key
# ---------------------------------------------------------------------------

def _len(n):
    if n < 0x80:
        return bytes([n])
    b = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(b)]) + b


def _tlv(tag, body):
    return bytes([tag]) + _len(len(body)) + body


def _seq(*parts):
    return _tlv(0x30, b"".join(parts))


def _oid(dotted):
    arcs = [int(a) for a in dotted.split(".")]
    out = b""
    for v in [arcs[0] * 40 + arcs[1]] + arcs[2:]:
        chunk = [v & 0x7F]
        v >>= 7
        while v:
            chunk.append(0x80 | (v & 0x7F))
            v >>= 7
        out += bytes(reversed(chunk))
    return _tlv(6, out)


def _int(v):
    return _tlv(2, v.to_bytes(max(1, (v.bit_length() + 8) // 8), "big",
                              signed=True))


NULL = b"\x05\x00"
ECDSA = _seq(_oid("1.2.840.10045.4.3.2"))
CN = _seq(_oid("2.5.4.3"), _tlv(0x0C, b"cap"))
NAME = _seq(_tlv(0x31, CN))
VALID = _seq(_tlv(0x17, b"240101000000Z"), _tlv(0x17, b"250101000000Z"))
V3 = b"\xa0\x03\x02\x01\x02"


def _curve_point(crv, form="04"):
    from cap_tpu_torch.gpu.ec import curve

    cp = curve(crv)
    x = cp.gx.to_bytes(cp.coord_bytes, "big")
    y = cp.gy.to_bytes(cp.coord_bytes, "big")
    if form == "04":
        return b"\x04" + x + y
    if form == "06":
        return bytes([6 | cp.gy & 1]) + x + y
    return bytes([int(form, 16) ^ (cp.gy & 1)]) + x


P256 = "1.2.840.10045.3.1.7"


def _spki_ec(pt=None, curve_oid=P256, params=None):
    p = params if params is not None else _oid(curve_oid)
    pt = pt if pt is not None else _curve_point("P-256")
    return _seq(_seq(_oid("1.2.840.10045.2.1"), p), _tlv(3, b"\x00" + pt))


def _cert(version=V3, serial=_int(12345), sigalg=ECDSA, issuer=NAME,
          validity=VALID, spki=None, extra=b"", outer=None,
          sig=_tlv(3, b"\x00" + b"\x11" * 8)):
    spki = spki if spki is not None else _spki_ec()
    tbs = _seq(version, serial, sigalg, issuer, validity, NAME, spki, extra)
    return _seq(tbs, outer if outer is not None else sigalg, sig)


def _alg(oid, *params):
    a = _seq(_oid(oid), *params)
    return dict(sigalg=a, outer=a)


def _rdn(tag, value):
    return dict(issuer=_seq(_tlv(0x31, _seq(_oid("2.5.4.3"),
                                            _tlv(tag, value)))))


def _crafted():
    g = {}
    g["oid"] = [_cert(sigalg=_seq(_tlv(6, b"\x2a" + arc)),
                      outer=_seq(_tlv(6, b"\x2a" + arc)))
                for nb in (4, 5, 9, 16, 18, 19, 20)
                for arc in (b"\x81" * (nb - 1) + b"\x01",
                            b"\xff" * (nb - 1) + b"\x7f")]
    g["oid"] += [_cert(**dict.fromkeys(("sigalg", "outer"),
                                       _seq(_tlv(6, body))))
                 for body in (b"\x2a" + b"\x01" * 62, b"\x2a" + b"\x01" * 63,
                              b"", b"\x81\x00\x01", b"\x2a\x80\x01")]
    g["tags"] = [_cert(**_alg("1.2.3.4", t + b"\x00"))
                 for t in (b"\x1f\x1f", b"\x1f\x20", b"\x1f\x81\x00",
                           b"\x1f\x80\x20", b"\x9f\x1f", b"\x1f\x7f",
                           b"\x1f\x8f\xff\xff\xff\x7f",
                           b"\x1f\x90\x80\x80\x80\x00", b"\x00",
                           b"\x3f\x81\x01")]
    g["tags"] += [_cert(**_alg("1.2.3.4", NULL, NULL)),
                  b"\x30\x80" + _cert()[2:] + b"\x00\x00", _cert() + b"\x00",
                  b"\x30\x85\x00\x00\x00\x01\x00",
                  _cert(sig=b"\x03\x81\x09\x00" + b"\x11" * 8),
                  _cert(sig=b"\x03\x82\x00\x09\x00" + b"\x11" * 8),
                  b"\x30\x82\x00" + _cert()[1:],
                  b"\x30\x81\x05" + b"\x02\x01\x00" + b"\x05\x00"]
    cn2 = _seq(_oid("2.5.4.10"), _tlv(0x0C, b"org"))
    g["names"] = [_cert(issuer=_seq(_tlv(0x31, a))) for a in
                  (CN + cn2, cn2 + CN, CN + CN, b"",
                   _seq(_oid("2.5.4.3")),
                   _seq(_oid("2.5.4.3"), _tlv(0x0C, b"a"), _tlv(0x0C, b"b")))]
    g["names"] += [_cert(issuer=_seq())]
    g["strings"] = [_cert(**_rdn(0x13, s)) for s in
                    (b"abc", b"a*b", b"a@b", b"a&b", b"A-Z:=?", b"a\x00",
                     b"\xff", b"a_b", b"")]
    g["strings"] += [_cert(**_rdn(0x1E, s)) for s in
                     (b"\x00a", b"\x00", b"\xd8\x00", b"\xd8\x00\xdc\x00",
                      b"\xdc\x00", b"")]
    g["strings"] += [_cert(**_rdn(0x1C, s)) for s in
                     (b"\x00\x00\x00a", b"\x00\x00\xd8\x00",
                      b"\x00\x11\x00\x00", b"\x00\x00a")]
    g["strings"] += [_cert(**_rdn(tag, s)) for tag in (0x0C, 0x16, 0x12)
                     for s in (b"\xff\xfe", b"\xc3\x28")]
    g["times"] = [_cert(validity=_seq(_tlv(0x17, t), _tlv(0x17, t)))
                  for t in (b"240229000000Z", b"230229000000Z",
                            b"000229000000Z", b"240431000000Z",
                            b"241231235959Z", b"241231235960Z",
                            b"241231240000Z", b"2412312359Z",
                            b"241231235959+0000", b"241231235959",
                            b"500101000000Z", b"241301000000Z",
                            b"240001000000Z", b"240100000000Z",
                            b"-40101000000Z")]
    g["times"] += [_cert(validity=_seq(_tlv(0x18, t), _tlv(0x17, t[2:])))
                   for t in (b"20240101000000Z", b"20240101000000.5Z",
                             b"202401010000Z", b"21000229000000Z",
                             b"20000229000000Z", b"00000101000000Z",
                             b"99991231235959Z", b"20240101000000")]
    g["times"] += [_cert(validity=_seq(_tlv(0x16, b"240101000000Z"),
                                       _tlv(0x17, b"250101000000Z"))),
                   _cert(validity=VALID[:-1] + b"")]
    ext1 = _seq(_oid("2.5.29.19"), _tlv(4, _seq()))

    def ext(*e):
        return _tlv(0xA3, _seq(*e))

    g["extensions"] = [_cert(extra=e) for e in (
        ext(ext1), ext(), ext(ext1, ext1),
        ext(_seq(_oid("2.5.29.19"), b"\x01\x01\xff", _tlv(4, _seq()))),
        ext(_seq(_oid("2.5.29.19"), b"\x01\x01\x00", _tlv(4, _seq()))),
        ext(_seq(_oid("2.5.29.19"), b"\x01\x01\x01", _tlv(4, _seq()))),
        ext(_seq(_oid("2.5.29.19"))),
        _tlv(0xA3, _seq(ext1) + _seq(ext1)),
        _tlv(0x81, b"\x00\xaa"), _tlv(0x82, b"\x00\xaa"),
        _tlv(0x81, b"\x00\xaa") + _tlv(0x82, b"\x00\xaa"),
        _tlv(0x82, b"\x00\xaa") + _tlv(0x81, b"\x00\xaa"),
        _tlv(0x81, b"\x01\xab"), _tlv(0xA1, b"\x00\xaa"), _tlv(0x81, b""),
        _tlv(0x81, b"\x00\xaa") + ext(ext1))]
    g["versions"] = [_cert(version=v) for v in (
        b"", b"\xa0\x03\x02\x01\x01", b"\xa0\x03\x02\x01\x00",
        b"\xa0\x04\x02\x02\x00\xff", b"\xa0\x04\x02\x02\x01\x00",
        b"\xa0\x03\x02\x01\xff", b"\xa0\x06\x02\x01\x02\x02\x01\x02")]
    g["versions"] += [_cert(serial=s) for s in (
        _int(-5), _int(0), _int(1 << 238), _tlv(2, b""),
        _tlv(2, b"\x00\x05"), _tlv(2, b"\xff\x85"))]
    pss = "1.2.840.113549.1.1.10"
    sha256 = _seq(_oid("2.16.840.1.101.3.4.2.1"), NULL)
    sha1 = _seq(_oid("1.3.14.3.2.26"), NULL)

    def mgf(h):
        return _seq(_oid("1.2.840.113549.1.1.8"), h)

    g["algorithms"] = [_cert(**_alg(pss, *p)) for p in (
        (), (_seq(),), (NULL,),
        (_seq(_tlv(0xA0, sha256), _tlv(0xA1, mgf(sha256)),
              _tlv(0xA2, _int(32))),),
        (_seq(_tlv(0xA0, sha1)),),
        (_seq(_tlv(0xA0, _seq(_oid("1.3.14.3.2.26")))),),
        (_seq(_tlv(0xA1, mgf(sha1))),), (_seq(_tlv(0xA2, _int(20))),),
        (_seq(_tlv(0xA2, _int(70000))),), (_seq(_tlv(0xA3, _int(1))),),
        (_seq(_tlv(0xA2, _int(32)), _tlv(0xA0, sha256)),),
        (_seq(_tlv(0xA2, _int(32)), NULL),))]
    g["algorithms"] += [_cert(**_alg(o, *p)) for o in (
        "2.16.840.1.101.3.4.3.2", "1.2.840.10045.4.3.2", "1.3.101.112",
        "2.16.840.1.101.3.4.2.1", "1.2.840.113549.2.9",
        "1.2.840.113549.1.1.11") for p in ((), (NULL,), (_int(1),))]
    n = (1 << 2047) | 12345
    rsa_body = _seq(_int(n), _int(65537))
    g["rsa"] = [_cert(spki=_seq(_seq(_oid(o), *p), _tlv(3, b"\x00" + body)))
                for o, p, body in (
                    (pss, (), rsa_body), (pss, (NULL,), rsa_body),
                    ("1.2.840.113549.1.1.1", (), rsa_body),
                    ("1.2.840.113549.1.1.1", (_int(1),), rsa_body),
                    ("1.2.840.113549.1.1.1", (NULL,),
                     _seq(_tlv(2, b"\x00\x00" + n.to_bytes(256, "big")),
                          _int(65537))),
                    ("1.2.840.113549.1.1.1", (NULL,),
                     _seq(_int(n), _tlv(2, b"\x00\x01\x00\x01"))),
                    ("1.2.840.113549.1.1.1", (NULL,), _seq(_int(n), _int(-3))),
                    ("1.2.840.113549.1.1.1", (NULL,), _seq(_int(0), _int(1))),
                    ("1.2.840.113549.1.1.1", (NULL,), rsa_body + b"\x00"),
                    ("1.2.840.113549.1.1.1", (NULL,),
                     b"\x30\x80" + rsa_body[4:] + b"\x00\x00"))]
    g["ec"] = [_cert(spki=_spki_ec(params=p)) for p in (
        NULL, _int(1), _seq(_int(1)), _seq(NULL),
        _seq(_int(1), _seq(_oid("1.2.840.10045.1.1"), _int(7)),
             _seq(_tlv(4, b"\x01"), _tlv(4, b"\x02")), _tlv(4, b"\x04"),
             _int(7)))]
    g["ec"] += [_cert(spki=_seq(_seq(_oid("1.2.840.10045.2.1")),
                                _tlv(3, b"\x00" + _curve_point("P-256"))))]
    k1x = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
    k1y = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
    for crv, oid in (("P-256", P256), ("P-384", "1.3.132.0.34"),
                     ("P-521", "1.3.132.0.35")):
        g["ec"] += [_cert(spki=_spki_ec(pt=_curve_point(crv, f),
                                        curve_oid=oid))
                    for f in ("04", "06", "02", "03")]
    g["ec"] += [_cert(spki=_spki_ec(pt=pt, curve_oid=oid)) for oid, pt in (
        ("1.3.132.0.10", b"\x04" + k1x.to_bytes(32, "big")
         + k1y.to_bytes(32, "big")),
        ("1.3.132.0.10", b"\x02" + k1x.to_bytes(32, "big")),
        ("1.3.132.0.10", b"\x04" + (5).to_bytes(32, "big") * 2),
        ("1.2.840.10045.3.1.4", _curve_point("P-256")))]
    g["ec"] += [_cert(spki=_spki_ec(pt=b"\x02" + x.to_bytes(size, "big"),
                                    curve_oid=oid))
                for oid, size in (("1.3.132.0.33", 28),
                                  ("1.2.840.10045.3.1.1", 24),
                                  ("1.3.132.0.10", 32), (P256, 32))
                for x in range(1, 8)]
    g["ec"] += [_cert(spki=_spki_ec(pt=pt)) for pt in (
        b"\x00", b"\x01", b"\x00" * 65, b"\x05" + _curve_point("P-256")[1:],
        b"", _curve_point("P-256", "06")[:1] + _curve_point("P-256")[1:-1]
        + bytes([_curve_point("P-256")[-1] ^ 1]),
        b"\x02" + (2 ** 256 - 1).to_bytes(32, "big"))]
    pt = _curve_point("P-256")
    g["ec"] += [_cert(spki=_seq(_seq(_oid("1.2.840.10045.2.1"), _oid(P256)),
                                _tlv(3, b"\x01" + pt[:-1]
                                     + bytes([pt[-1] & 0xFE]))))]
    g["raw"] = [_cert(spki=_seq(_seq(_oid(o), *p),
                                _tlv(3, b"\x00" + b"\x11" * n)))
                for o in ("1.3.101.112", "1.3.101.113", "1.3.101.110",
                          "1.3.101.111")
                for n, p in ((31, ()), (32, ()), (56, ()), (57, ()),
                             (32, (NULL,)))]
    g["raw"] += [_cert(spki=_seq(_seq(_oid("1.3.101.112")),
                                 _tlv(3, b"\x01" + b"\x10" * 32)))]
    dsa = _seq(_int(23), _int(11), _int(4))
    g["dsa-dh"] = [_cert(spki=_seq(_seq(_oid(o), *p), _tlv(3, b"\x00" + k)))
                   for o, p, k in (
                       ("1.2.840.10040.4.1", (dsa,), _int(8)),
                       ("1.2.840.10040.4.1", (), _int(8)),
                       ("1.2.840.10040.4.1", (dsa,), b"\x05"),
                       ("1.2.840.10040.4.1", (dsa,), _int(-8)),
                       ("1.2.840.10040.4.1", (_seq(_int(23), _int(11)),),
                        _int(8)),
                       ("1.2.840.113549.1.3.1", (_seq(_int(23), _int(5)),),
                        _int(8)),
                       ("1.2.840.113549.1.3.1",
                        (_seq(_int(23), _int(5), _int(7), _int(1)),), _int(8)),
                       ("1.2.840.10046.2.1",
                        (_seq(_int(23), _int(5), _int(11)),), _int(8)),
                       ("1.2.840.10046.2.1", (_seq(_int(23), _int(5)),),
                        _int(8)),
                       ("1.2.840.10046.2.1",
                        (_seq(_int(23), _int(5), _int(11),
                              _seq(_tlv(3, b"\x00\x01"), _int(3))),),
                        _int(8)))]
    g["signature"] = [_cert(sig=s) for s in (
        _tlv(3, b""), _tlv(3, b"\x03"), _tlv(3, b"\x08\x00"),
        _tlv(3, b"\x07\x80"), _tlv(3, b"\x07\x81"))]
    g["signature"] += [_cert(outer=_seq(_oid("1.2.840.10045.4.3.3")))]
    return g


CRAFTED = _crafted()


def reader_outcome(der):
    """The JAX package's route (cryptography) and the port's reader on one
    certificate: the stage that fails and the class, or the key."""
    out = []
    for load, mapped in ((cx509.load_der_x509_certificate, {}),
                         (t_x509.load_der_x509_certificate,
                          {"InvalidVersion": "InvalidVersion",
                           "UnsupportedAlgorithm": "UnsupportedAlgorithm"})):
        try:
            cert = load(der)
        except Exception as e:  # noqa: BLE001 - compared across readers
            out.append(("load", type(e).__name__))
            continue
        try:
            key = cert.public_key()
        except Exception as e:  # noqa: BLE001 - compared across readers
            out.append(("key", type(e).__name__))
            continue
        out.append(("ok", _norm(key)))
    return out


@pytest.mark.parametrize("group", sorted(CRAFTED))
def test_crafted_der(group):
    """Hand-made certificates on the DER rules, the strings, times,
    extensions, versions, algorithm parameters and key forms where a
    hand reader most often parts from cryptography's: both readers fail
    at the same stage with the same class, or give equal keys."""
    bad = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, der in enumerate(CRAFTED[group]):
            want, got = reader_outcome(der)
            if got != want:
                bad.append((i, want, got))
    assert not bad, bad[:5]

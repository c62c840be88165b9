"""Pooled HTTP helpers with optional CA pinning (the port's copy of the
JAX package's ``utils/http.py``, as far as the keysets need it).

A process-wide keep-alive connection pool keyed by (scheme, host,
port, SSL context), so one TLS handshake serves discovery and every
JWKS fetch when the server allows keep-alive; ``get``, ``get_json``,
``fetch_discovery`` (the issuer-equality check) and ``post_form`` (the
OIDC token exchange) over it, and the conditional-GET (ETag) cache the
keyplane's remote sources poll through (``get(conditional=True)``,
counted in ``http.etag_hits``). Left out of this copy: the connection
counters, which nothing in the port reads.
"""

from __future__ import annotations

import http.client
import json
import socket
import ssl
import threading
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlencode, urljoin, urlparse

from .. import telemetry
from ..errors import InvalidCACertError, InvalidIssuerError


def ssl_context_for_ca(ca_pem: Optional[str]) -> Optional[ssl.SSLContext]:
    """Build an SSLContext trusting only ``ca_pem`` (None → system default)."""
    if not ca_pem:
        return None
    ctx = ssl.create_default_context()
    try:
        ctx.load_verify_locations(cadata=ca_pem)
    except ssl.SSLError as e:
        raise InvalidCACertError(f"could not load CA PEM: {e}") from e
    return ctx


class ConnectionPool:
    """Keep-alive HTTP(S) connection cache.

    Mirrors the pooled-transport role of the reference's cleanhttp
    clients: idle connections are parked per (scheme, host, port, SSL
    context) and reused for subsequent requests. A request on a reused
    connection that fails mid-flight (stale keep-alive the server
    already closed) is retried ONCE on a fresh connection — idempotent
    methods only; failures on fresh connections propagate as
    ConnectionError/OSError.
    """

    def __init__(self, max_idle_per_key: int = 4,
                 idle_ttl: float = 60.0):
        self._idle: Dict[tuple, list] = {}   # key -> [(conn, parked_at)]
        self._lock = threading.Lock()
        self._max_idle = max_idle_per_key
        self._idle_ttl = idle_ttl

    def _checkout(self, key):
        import time

        now = time.monotonic()
        stale = []
        try:
            with self._lock:
                conns = self._idle.get(key)
                while conns:
                    conn, parked = conns.pop()
                    if now - parked <= self._idle_ttl:
                        return conn, True
                    stale.append(conn)
            return None, False
        finally:
            for c in stale:
                c.close()

    def _checkin(self, key, conn) -> None:
        import time

        now = time.monotonic()
        evict = []
        with self._lock:
            # lazy sweep: expire idle sockets everywhere so dead
            # Providers' contexts don't pin fds for the process life
            for k in list(self._idle):
                kept = [(c, t) for (c, t) in self._idle[k]
                        if now - t <= self._idle_ttl]
                evict.extend(c for (c, t) in self._idle[k]
                             if now - t > self._idle_ttl)
                if kept:
                    self._idle[k] = kept
                else:
                    del self._idle[k]
            conns = self._idle.setdefault(key, [])
            if len(conns) < self._max_idle:
                conns.append((conn, now))
                conn = None
        for c in evict:
            c.close()
        if conn is not None:
            conn.close()

    def close(self) -> None:
        with self._lock:
            for conns in self._idle.values():
                for c, _ in conns:
                    c.close()
            self._idle.clear()

    def request(self, method: str, url: str,
                body: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None,
                ctx: Optional[ssl.SSLContext] = None,
                timeout: float = 30.0,
                max_redirects: int = 5) -> Tuple[int, bytes,
                                                 Dict[str, str]]:
        """One HTTP exchange → (status, body, lowercased headers).

        4xx/5xx are returned, not raised (callers branch on status);
        transport failures raise OSError subclasses. GET redirects are
        followed up to ``max_redirects`` (the reference's http.Client
        default behavior).
        """
        origin = urlparse(url)
        for _ in range(max_redirects + 1):
            status, data, hdrs = self._one(method, url, body, headers,
                                           ctx, timeout)
            loc = hdrs.get("location")
            if loc and status in (301, 302, 303, 307, 308):
                url = urljoin(url, loc)
                target = urlparse(url)
                downgrade = origin.scheme == "https" and \
                    target.scheme != "https"
                if headers and (target.hostname != origin.hostname
                                or downgrade):
                    # Credentials must not follow a redirect off the
                    # original host OR onto cleartext http (Go's
                    # http.Client strips them the same way): a
                    # compromised IdP response would otherwise
                    # exfiltrate Bearer/Basic credentials.
                    headers = {k: v for k, v in headers.items()
                               if k.lower() not in ("authorization",
                                                    "cookie")}
                if status in (301, 302, 303) and method != "GET":
                    # urllib/browser semantics: re-issue as GET
                    method, body = "GET", None
                continue  # 307/308 keep method + body
            return status, data, hdrs
        raise ConnectionError(f"{method} {url}: too many redirects")

    def _one(self, method, url, body, headers, ctx, timeout):
        u = urlparse(url)
        if u.scheme not in ("http", "https"):
            raise ConnectionError(f"unsupported URL scheme {u.scheme!r}")
        port = u.port or (443 if u.scheme == "https" else 80)
        # Key on the SSLContext OBJECT (hashable; the pool entry keeps
        # it alive): an id()-based key could alias a dead Provider's
        # context with a newly-allocated one at the same address and
        # hand out a socket validated under the wrong CA.
        key = (u.scheme, u.hostname, port, ctx)
        path = u.path or "/"
        if u.query:
            path += "?" + u.query

        last_exc: Optional[Exception] = None
        for attempt in (0, 1):
            if attempt == 0:
                conn, reused = self._checkout(key)
            else:
                conn, reused = None, False  # retry always on a fresh conn
            if conn is None:
                try:
                    if u.scheme == "https":
                        conn = http.client.HTTPSConnection(
                            u.hostname, port, timeout=timeout,
                            context=ctx)
                    else:
                        conn = http.client.HTTPConnection(
                            u.hostname, port, timeout=timeout)
                except Exception as e:  # noqa: BLE001
                    raise ConnectionError(str(e)) from e
                reused = False
            else:
                # reused sockets keep their creator's timeout: apply
                # THIS caller's
                conn.timeout = timeout
                if getattr(conn, "sock", None) is not None:
                    conn.sock.settimeout(timeout)
            sent = False
            try:
                conn.request(method, path, body=body,
                             headers=headers or {})
                sent = True
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, ConnectionError,
                    BrokenPipeError, socket.timeout, ssl.SSLError,
                    OSError) as e:
                conn.close()
                last_exc = e
                if reused and (not sent or method in ("GET", "HEAD")):
                    # Stale keep-alive → one fresh retry. Send-phase
                    # failures retry for ANY method (the server closed
                    # the parked socket before reading, so nothing was
                    # processed); after the request went out, only
                    # idempotent methods retry — replaying a completed
                    # POST (token exchange) could consume the one-shot
                    # auth code twice.
                    continue
                if isinstance(e, OSError):
                    raise
                raise ConnectionError(str(e)) from e
            if resp.will_close:
                conn.close()
            else:
                self._checkin(key, conn)
            return (resp.status, data,
                    {k.lower(): v for k, v in resp.getheaders()})
        raise ConnectionError(str(last_exc)) from last_exc


_POOL = ConnectionPool()


def default_pool() -> ConnectionPool:
    return _POOL


# Conditional-GET cache: url+context → (etag, body, headers) of the
# last 200 that carried an ETag. ``get(conditional=True)`` sends
# If-None-Match and transparently answers a 304 with the cached body,
# so a periodic keyplane refresh of an unchanged JWKS costs one
# header-only round trip instead of the document. Bounded (FIFO) —
# this is a freshness cache for a handful of polled endpoints, not a
# general HTTP cache (no Vary/Cache-Control semantics).
_COND_LOCK = threading.Lock()
_COND_CACHE: Dict[tuple, Tuple[str, bytes, Dict[str, str]]] = {}
_COND_CACHE_MAX = 64


def get(url: str, ctx: Optional[ssl.SSLContext] = None,
        headers: Optional[Dict[str, str]] = None,
        timeout: float = 30.0,
        conditional: bool = False) -> Tuple[int, bytes, Dict[str, str]]:
    """GET a URL; returns (status, body, lowercased headers).

    ``conditional=True``: honor ETag validators — a cached ETag for
    this (url, ctx) is sent as If-None-Match, and a 304 answer is
    returned as status 200 with the CACHED body (plus header
    ``x-cap-conditional: revalidated``), so callers branch on status
    exactly as for a plain fetch.
    """
    key = (url, ctx)
    cached = None
    if conditional:
        with _COND_LOCK:
            cached = _COND_CACHE.get(key)
        if cached is not None:
            headers = dict(headers or {})
            headers["If-None-Match"] = cached[0]
    status, body, hdrs = _POOL.request("GET", url, headers=headers,
                                       ctx=ctx, timeout=timeout)
    if not conditional:
        return status, body, hdrs
    if status == 304 and cached is not None:
        telemetry.count("http.etag_hits")
        out = dict(cached[2])
        out.update(hdrs)
        out["x-cap-conditional"] = "revalidated"
        return 200, cached[1], out
    if status == 200:
        etag = hdrs.get("etag")
        if etag:
            with _COND_LOCK:
                if key not in _COND_CACHE and \
                        len(_COND_CACHE) >= _COND_CACHE_MAX:
                    _COND_CACHE.pop(next(iter(_COND_CACHE)))
                _COND_CACHE[key] = (etag, body, hdrs)
    return status, body, hdrs




def get_json(url: str, ctx: Optional[ssl.SSLContext] = None,
             timeout: float = 30.0) -> Any:
    status, body, headers = get(url, ctx, timeout=timeout)
    if status != 200:
        raise RuntimeError(f"GET {url}: unexpected status {status}: {body[:200]!r}")
    content_type = headers.get("content-type", "")
    try:
        return json.loads(body)
    except ValueError as e:
        raise RuntimeError(
            f"GET {url}: expected JSON (content-type {content_type!r}): {e}"
        ) from e


def fetch_discovery(issuer: str,
                    ctx: Optional[ssl.SSLContext] = None) -> Dict[str, Any]:
    """Fetch {issuer}/.well-known/openid-configuration and enforce the
    issuer-equality check (single source of the discovery protocol for
    both the jwt discovery keyset and the oidc Provider)."""
    well_known = issuer.rstrip("/") + "/.well-known/openid-configuration"
    status, body, _ = get(well_known, ctx)
    if status != 200:
        raise InvalidIssuerError(f"discovery request failed: status {status}")
    try:
        doc = json.loads(body)
    except ValueError as e:
        raise InvalidIssuerError(f"discovery document is not JSON: {e}") from e
    if not isinstance(doc, dict):
        raise InvalidIssuerError("discovery document is not a JSON object")
    got = doc.get("issuer")
    if got != issuer:
        raise InvalidIssuerError(
            f"oidc issuer did not match the issuer returned by provider, "
            f"expected {issuer!r} got {got!r}")
    return doc


def post_form(url: str, fields: Dict[str, str],
              ctx: Optional[ssl.SSLContext] = None,
              headers: Optional[Dict[str, str]] = None,
              timeout: float = 30.0) -> Tuple[int, bytes, Dict[str, str]]:
    """POST application/x-www-form-urlencoded fields."""
    data = urlencode(fields).encode("ascii")
    hdrs = {"Content-Type": "application/x-www-form-urlencoded"}
    hdrs.update(headers or {})
    return _POOL.request("POST", url, body=data, headers=hdrs, ctx=ctx,
                         timeout=timeout)

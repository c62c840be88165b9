"""Worker process entry: ``python -m cap_tpu_torch.fleet.worker_main``.

The port of ``cap_tpu.fleet.worker_main``. One process = one
:class:`~cap_tpu_torch.serve.worker.VerifyWorker` = one card. The
process:

1. builds its keyset from ``--keyset`` (below) on ``--device``
   (``cuda`` by default; without CUDA the keyset raises). A pool holds
   the process to its card with ``CUDA_VISIBLE_DEVICES``
   (:mod:`cap_tpu_torch.parallel.place`);
2. binds the serve socket and prints ONE machine-readable ready line on
   stdout (``CAP_FLEET_READY port=<p> pid=<p>``) — a supervisor parses
   it to learn the ephemeral port;
3. serves until SIGTERM, then drains gracefully: stops accepting,
   flushes every queued batch, answers the in-flight connections,
   writes a final ``sigterm-drain`` postmortem (``--postmortem-path``)
   and exits 0 (kill -9 is the CRASH path: the pool collects the last
   periodic checkpoint).

Keyset specs (``--keyset``):

- ``stub`` / ``stub:batch_ms=F,token_us=F,pipeline=1,raw=1,echo=1`` —
  the deterministic test engine (tokens ending ``.ok`` verify), the
  JAX package's ``StubKeySet`` as is;
- ``jwks:<path>`` — a ``GPUBatchKeySet`` over the JWKS JSON file at
  ``<path>``;
- ``jwks-url:<url>`` — boot straight from a REMOTE JWKS via the
  keyplane: a ``KeyPlaneKeySet`` fetches the document, builds the
  ``GPUBatchKeySet``, and keeps it fresh (jittered periodic refresh
  every ``--keyplane-refresh-s`` + singleflight unknown-kid refresh;
  a rotation keeps the old kids for ``--keyplane-grace-s``);
- ``oidc:<issuer>`` — same, with the JWKS URL resolved through OIDC
  discovery (issuer-equality enforced);
- ``oidc-rp:issuer=I;client=C;nonce=N[;algs=ES256+RS256][;aud=a+b]
  [;keyset=<inner spec>]`` — the inner engine (default
  ``stub:raw=1,echo=1``) wrapped in ``oidc.serve_keyset.OIDCRawKeySet``
  so every served token passes signature verification AND
  registered-claims validation.

Not ported yet (ROADMAP A item 8.5): ``frontdoor:``; it raises
``ValueError``. The worker's knobs are flags here where the JAX
package reads its environment (``--vcache off``, ``--no-telemetry``,
``--postmortem-path``, ``--pm-interval``, ``--keyplane-refresh-s``,
``--keyplane-grace-s``).

Every keyset kind accepts the fleet's KEYS pushes (CVB1 type 11):
``swap_keys`` swaps the live tables and the ready line / STATS /
``/snapshot`` all report ``key_epoch`` so the pool can verify epoch
convergence.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time


class StubKeySet:
    """Deterministic verdict engine: tokens ending ``.ok`` verify.

    The fleet tests' ground truth — the router's CPU-oracle fallback
    uses the SAME class, so a verdict produced by any path (worker,
    failover peer, fallback) is comparable bit-for-bit.
    """

    def __init__(self, batch_ms: float = 0.0, token_us: float = 0.0,
                 pipeline: float = 0.0, raw: float = 0.0,
                 echo: float = 0.0):
        self._batch_s = batch_ms / 1e3
        self._token_s = token_us / 1e6
        # echo=1 (raw mode only): a verified token's payload is its
        # OWN base64url-decoded middle segment instead of the fixed
        # stub bytes — the crypto-free seam the OIDC serve surface and
        # the claims differential suite drive real claim JSON through
        # (verdict still suffix-determined; undecodable middles keep
        # the fixed payload so the stub can never raise).
        self._echo = bool(echo)
        # raw=1: serve the raw-claims interface real engines expose
        # (verify_batch_raw → payload BYTES per verified token), so a
        # bench against the stub exercises the same zero-reserialize
        # response path as a GPUBatchKeySet. Verdicts stay
        # suffix-determined either way.
        self._raw = bool(raw)
        # pipeline=1: expose verify_batch_async so the batcher runs
        # its 2-deep pipeline against the stub — the simulated device
        # occupancy of batch k+1 then overlaps batch k's drain, the
        # way a real device's H2D/compute overlap does. Opt-in: the
        # chaos suite's timing assumptions stay on the sync path.
        self._pipeline = bool(pipeline)
        self.key_epoch = 0

    def swap_keys(self, jwks, epoch=None, grace_s: float = 0.0) -> int:
        """Keyplane hook: record the pushed epoch. Verdicts stay
        suffix-determined — a rotation must not change the fleet
        tests' ground truth (that WOULD be a wrong verdict)."""
        self.key_epoch = (self.key_epoch + 1 if epoch is None
                          else int(epoch))
        return self.key_epoch

    def _results(self, tokens):
        from ..errors import InvalidSignatureError

        if self._raw:
            reject = InvalidSignatureError(
                "no known key successfully validated the token signature")
            ok = b'{"sub":"stub"}'
            if self._echo:
                return [self._echo_payload(t, ok)
                        if t.endswith(".ok") else reject for t in tokens]
            return [ok if t.endswith(".ok") else reject for t in tokens]
        return [
            {"sub": t} if t.endswith(".ok")
            else InvalidSignatureError(
                "no known key successfully validated the token signature")
            for t in tokens
        ]

    @staticmethod
    def _echo_payload(token: str, default: bytes) -> bytes:
        import base64
        import binascii

        parts = token.split(".")
        if len(parts) != 3:
            return default
        try:
            pad = "=" * (-len(parts[1]) % 4)
            # validate=True: stdlib b64decode silently DROPS foreign
            # characters otherwise, and a corrupt middle segment must
            # keep the fixed payload, not decode to garbage
            return base64.b64decode(
                parts[1].replace("-", "+").replace("_", "/") + pad,
                validate=True)
        except (ValueError, binascii.Error):
            return default

    def verify_batch(self, tokens):
        from ..obs import occupancy as _occupancy

        sleep_s = self._batch_s + self._token_s * len(tokens)
        # The simulated device time is a real dispatch-level busy
        # interval on the occupancy plane.
        with _occupancy.interval("stub"):
            if sleep_s > 0.0:
                time.sleep(sleep_s)  # models device occupancy (no GIL)
        return self._results(tokens)

    def __getattr__(self, name):
        # Mode-dependent interface: verify_batch_async exists only in
        # pipeline mode (the batcher's hasattr probe picks the right
        # dispatch path) and verify_batch_raw only in raw mode (the
        # worker's raw-claims wrapper probes it the same way).
        # (__dict__ lookup: __getattr__ must not recurse during
        # unpickling, before __init__ has run.)
        if name == "verify_batch_async" and self.__dict__.get("_pipeline"):
            return self._verify_batch_async
        if name == "verify_batch_raw" and self.__dict__.get("_raw"):
            return self.verify_batch
        raise AttributeError(name)

    def _verify_batch_async(self, tokens):
        from ..obs import occupancy as _occupancy

        done_at = time.monotonic() + self._batch_s \
            + self._token_s * len(tokens)
        results = self._results(tokens)
        # pipeline=1 arm: the busy interval spans dispatch → collect
        # return, so two in-flight stub batches overlap on the plane
        # exactly like a real device's H2D/compute overlap (the union
        # accounting never double-counts the overlap window).
        occ_t0 = _occupancy.begin()

        def collect():
            remaining = done_at - time.monotonic()
            if remaining > 0.0:
                time.sleep(remaining)   # occupancy overlaps next prep
            _occupancy.end("stub", occ_t0)
            return results

        return collect


_DEVICE = "cuda"


def make_keyset(spec: str, device: str = _DEVICE,
                keyplane_refresh_s: float = 300.0,
                keyplane_grace_s: float = 30.0):
    """Build the worker's engine from a ``--keyset`` spec string."""
    if spec == "stub" or spec.startswith("stub:"):
        kwargs = {}
        if spec.startswith("stub:"):
            for kv in spec[len("stub:"):].split(","):
                if not kv:
                    continue
                k, _, v = kv.partition("=")
                if k not in ("batch_ms", "token_us", "pipeline", "raw",
                             "echo"):
                    raise ValueError(f"unknown stub option {k!r}")
                kwargs[k] = float(v)
        return StubKeySet(**kwargs)
    if spec.startswith("oidc-rp:"):
        # Full OIDC verify-AND-validate serving: wrap an inner engine
        # spec in the Provider-backed serve surface. Options are
        # ';'-separated k=v; `keyset=` holds the inner spec verbatim.
        # Discovery is injected, not fetched.
        from ..oidc.serve_keyset import oidc_rp_keyset_from_spec

        opts = {}
        for part in spec[len("oidc-rp:"):].split(";"):
            if not part:
                continue
            k, _, v = part.partition("=")
            if k not in ("issuer", "client", "nonce", "algs", "aud",
                         "redirect", "keyset"):
                raise ValueError(f"unknown oidc-rp option {k!r}")
            opts[k] = v
        inner = make_keyset(opts.pop("keyset", "stub:raw=1,echo=1"),
                            device, keyplane_refresh_s, keyplane_grace_s)
        return oidc_rp_keyset_from_spec(opts, inner)
    if spec.startswith("jwks:"):
        import json

        from ..jwt.gpu_keyset import GPUBatchKeySet
        from ..jwt.jwk import parse_jwks

        with open(spec[len("jwks:"):], "r") as f:
            doc = json.load(f)
        return GPUBatchKeySet(parse_jwks(doc), device=device)
    if spec.startswith("jwks-url:") or spec.startswith("oidc:"):
        from ..keyplane import source_for_spec
        from ..keyplane.plane import KeyPlaneKeySet

        return KeyPlaneKeySet(source_for_spec(spec),
                              interval_s=keyplane_refresh_s,
                              grace_s=keyplane_grace_s, device=device)
    if spec.startswith("frontdoor:"):
        raise ValueError(
            "keyset spec 'frontdoor:' is not ported yet (ROADMAP A "
            "item 8.5)")
    raise ValueError(f"unknown keyset spec {spec!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cap_tpu_torch.fleet.worker_main")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--keyset", default="stub")
    ap.add_argument("--device", default=_DEVICE, choices=["cuda", "cpu"])
    ap.add_argument("--target-batch", type=int, default=4096)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=32768)
    ap.add_argument("--drain-deadline-s", type=float, default=30.0)
    # Serve chain: "native" (C++ frame I/O + lock-free ring) or
    # "python" (reader/responder threads). A native chain that does not
    # build or load raises; the ready line's serve_chain= field reports
    # what runs.
    ap.add_argument("--serve-chain", default="python",
                    choices=["native", "python"])
    # Native telemetry plane: "auto" (on whenever the native chain and
    # telemetry are both on) or "off" (the Python decision fold).
    ap.add_argument("--native-obs", default="auto", choices=["auto", "off"])
    # Transport capability: "shm" honours per-connection shared-memory
    # attach negotiations (CVB1 type 15) on whichever chain runs;
    # "socket" refuses them (status 1, counted serve.shm_fallbacks).
    ap.add_argument("--transport", default="socket",
                    choices=["socket", "shm"])
    # Verdict cache: "auto" (on) or "off" (the cache tier and the
    # batcher's in-flight dedup off).
    ap.add_argument("--vcache", default="auto", choices=["auto", "off"])
    # The telemetry recorder is on by default (the STATS op then serves
    # real numbers); --no-telemetry serves structural fields only.
    ap.add_argument("--no-telemetry", action="store_true")
    # Observability server (serve.obs): 0 = ephemeral port (default),
    # below 0 = disabled. The bound port is announced on the ready line.
    ap.add_argument("--obs-port", type=int, default=0)
    # Crash postmortems: checkpoint telemetry to this path on a timer
    # and on SIGTERM drain, so the pool can collect a ≤interval-stale
    # document even after kill -9. Empty = disabled.
    ap.add_argument("--postmortem-path", default="")
    ap.add_argument("--pm-interval", type=float, default=2.0)
    # Keyplane (jwks-url: / oidc: specs): the periodic refresh cadence
    # and the grace a rotation gives the retired kids.
    ap.add_argument("--keyplane-refresh-s", type=float, default=300.0)
    ap.add_argument("--keyplane-grace-s", type=float, default=30.0)
    # PyTorch's intra-op threads (0: its default, one a core). A CPU
    # worker beside others on one host takes a share of the cores:
    # processes that each spin a thread a core slow one another down.
    ap.add_argument("--torch-threads", type=int, default=0)
    args = ap.parse_args(argv)

    from .. import telemetry
    from ..serve.worker import VerifyWorker

    if not args.no_telemetry:
        telemetry.enable()
    if args.torch_threads > 0:
        import torch

        torch.set_num_threads(args.torch_threads)
    keyset = make_keyset(args.keyset, args.device,
                         keyplane_refresh_s=args.keyplane_refresh_s,
                         keyplane_grace_s=args.keyplane_grace_s)
    worker = VerifyWorker(keyset, host=args.host, port=args.port,
                          target_batch=args.target_batch,
                          max_wait_ms=args.max_wait_ms,
                          max_batch=args.max_batch,
                          vcache=args.vcache != "off",
                          serve_native=args.serve_chain == "native",
                          native_obs=args.native_obs != "off",
                          transport=args.transport,
                          obs_port=(None if args.obs_port < 0
                                    else args.obs_port))
    pm = None
    if args.postmortem_path:
        from ..obs.postmortem import PostmortemWriter

        pm = PostmortemWriter(args.postmortem_path,
                              interval_s=args.pm_interval,
                              stats_fn=worker.stats)
    host, port = worker.address
    obs = worker.obs_address
    epoch = worker.key_epoch
    # The ONE ready line a supervisor parses; flushed so it cannot sit
    # in a stdio buffer. Additive k=v fields as in the JAX package.
    print(f"CAP_FLEET_READY port={port} pid={os.getpid()}"
          + (f" obs={obs[1]}" if obs is not None else "")
          + (f" epoch={epoch}" if epoch is not None else "")
          + f" serve_chain={worker.serve_chain}"
          + f" transport={worker.transport}"
          + f" tel={int(telemetry.active() is not None)}",
          flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    # Graceful drain: stop accepting, flush queued batches (bounded),
    # give the responder threads a beat to write the last frames out.
    worker.close(deadline_s=args.drain_deadline_s)
    if pm is not None:
        # Fresh final checkpoint AFTER the drain: the postmortem then
        # reflects everything this process ever served.
        pm.close("sigterm-drain")
    time.sleep(0.2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

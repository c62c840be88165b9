"""KeyPlaneKeySet: a device keyset fed by the keyplane.

The port of ``cap_tpu.keyplane.plane``. The glue between a
:class:`~cap_tpu_torch.keyplane.refresher.Refresher` and a swap-capable
keyset (``GPUBatchKeySet.swap_keys``): boots from the
source's first snapshot, hot-swaps the device tables whenever the
refresher sees a new epoch, and reproduces cap's reference rotation
behavior on the batch path — a verification that fails because its
kid is unknown to the CURRENT epoch triggers (at most) one
refresher-mediated refresh-and-retry, with the refresher's cooldown
and negative-kid cache bounding what hostile kids can cost.

This is what ``worker_main --keyset jwks-url:<url>`` builds: the
worker keeps serving verdicts across rotations without a restart,
and the same object accepts fleet KEYS pushes (``swap_keys``
delegates), so push- and pull-propagation converge on the same
tables.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

from .. import telemetry
from ..errors import InvalidSignatureError
from .refresher import Refresher, Snapshot
from .source import KeySource


class KeyPlaneKeySet:
    """KeySet facade over a keyplane-managed ``GPUBatchKeySet``.

    source: where JWKS documents come from; interval_s/jitter/
    miss_cooldown_s/negative_ttl_s: refresher knobs; grace_s: how long
    a retired epoch's kids keep resolving after a swap; device: where
    the keyset runs (None: the card); keyset_factory:
    ``callable(jwks, epoch) -> keyset`` override (tests); remaining
    kwargs go to ``GPUBatchKeySet``.
    """

    def __init__(self, source: KeySource, interval_s: float = 300.0,
                 jitter: float = 0.1, miss_cooldown_s: float = 10.0,
                 negative_ttl_s: float = 30.0, grace_s: float = 30.0,
                 start: bool = True, keyset_factory=None,
                 device=None, **ks_kwargs: Any):
        self._grace = grace_s
        self._factory = keyset_factory
        self._device = device
        self._ks_kwargs = ks_kwargs
        self._ks = None
        self._swap_lock = threading.Lock()
        self._refresher = Refresher(
            source, apply=self._apply_snapshot, interval_s=interval_s,
            jitter=jitter, miss_cooldown_s=miss_cooldown_s,
            negative_ttl_s=negative_ttl_s)
        # First snapshot is mandatory: a worker must not come up READY
        # with no keys (it would reject valid tokens — a wrong verdict).
        self._refresher.refresh()
        if start:
            self._refresher.start()

    # -- keyplane plumbing -------------------------------------------------

    def _make_keyset(self, jwks, epoch: int):
        if self._factory is not None:
            return self._factory(jwks, epoch)
        from ..jwt.gpu_keyset import GPUBatchKeySet

        return GPUBatchKeySet(jwks, epoch=epoch, device=self._device,
                              **self._ks_kwargs)

    def _apply_snapshot(self, snap: Snapshot) -> None:
        from ..jwt.jwk import parse_jwks

        jwks = parse_jwks(snap.doc)
        with self._swap_lock:
            if self._ks is None:
                with telemetry.span(telemetry.SPAN_KEYPLANE_SWAP):
                    self._ks = self._make_keyset(jwks, snap.epoch)
                telemetry.gauge("keyplane.epoch", snap.epoch)
            else:
                self._ks.swap_keys(jwks, epoch=snap.epoch,
                                   grace_s=self._grace)

    @property
    def refresher(self) -> Refresher:
        return self._refresher

    @property
    def key_epoch(self) -> int:
        ks = self._ks
        return getattr(ks, "key_epoch", 0) if ks is not None else 0

    @property
    def in_grace(self) -> bool:
        """Whether a rotation's retired kids still resolve (the device
        keyset's grace). The serve worker caches no accept while it
        holds, so a cached accept cannot outlive a rotated key; the JAX
        ``KeyPlaneKeySet`` has no such property (ROADMAP C.2)."""
        return bool(getattr(self._ks, "in_grace", False))

    def swap_keys(self, jwks, epoch: Optional[int] = None,
                  grace_s: Optional[float] = None) -> int:
        """Fleet KEYS-push entry point: delegate to the device keyset.

        A pushed epoch overrides the refresher's counter on the TABLE
        side; the refresher keeps its own digest-based counter and
        will only swap again when the SOURCE's content changes.
        """
        with self._swap_lock:
            return self._ks.swap_keys(
                jwks, epoch=epoch,
                grace_s=self._grace if grace_s is None else grace_s)

    def close(self) -> None:
        self._refresher.close()

    # -- verify surface ----------------------------------------------------

    def verify_signature(self, token: str) -> Dict[str, Any]:
        res = self._verify_rotation_aware([token], raw=False)[0]
        if isinstance(res, Exception):
            raise res
        return res

    def verify_batch(self, tokens: Sequence[str]) -> List[Any]:
        return self._verify_rotation_aware(tokens, raw=False)

    def verify_batch_raw(self, tokens: Sequence[str]) -> List[Any]:
        return self._verify_rotation_aware(tokens, raw=True)

    def _verify_rotation_aware(self, tokens: Sequence[str],
                               raw: bool) -> List[Any]:
        from ..jwt.jose import parse_jws

        ks = self._ks
        call = ks.verify_batch_raw if raw else ks.verify_batch
        results = call(tokens)
        snap = self._refresher.snapshot
        known = snap.kids if snap is not None else frozenset()
        missed: Dict[int, str] = {}
        for i, r in enumerate(results):
            if not isinstance(r, InvalidSignatureError):
                continue
            try:
                parsed = parse_jws(tokens[i])
            except Exception:  # noqa: BLE001 - malformed keeps its error
                continue
            if parsed.kid is not None and parsed.kid not in known:
                missed[i] = parsed.kid
        if not missed:
            return results
        # Rotation path: one refresher-mediated refresh for the whole
        # batch (singleflight + cooldown + negative cache inside), then
        # retry ONLY the missed tokens against the swapped tables. A
        # suppressed or failed refresh keeps the original verdicts —
        # never an exception for the whole batch.
        refreshed = None
        for kid in dict.fromkeys(missed.values()):
            refreshed = self._refresher.on_miss(kid) or refreshed
        if refreshed is None:
            return results
        ks = self._ks
        retry_call = ks.verify_batch_raw if raw else ks.verify_batch
        retry = retry_call([tokens[i] for i in missed])
        for i, r in zip(missed, retry):
            results[i] = r
        return results

"""Decision-grade observability: verdict accounting and the device
occupancy plane.

- :mod:`cap_tpu_torch.obs.decision` — WHY tokens are rejected: every
  verify on the card's batch engine and the serve worker emits a
  bounded, redaction-enforced decision record into reason-keyed
  mergeable counters plus a sampled ring;
- :mod:`cap_tpu_torch.obs.occupancy` — the fraction of wall time with
  device work in flight, from busy intervals the keyset records.

Both are the JAX package's modules of the same names, stdlib-only,
riding :mod:`cap_tpu_torch.telemetry`. The JAX package's
``postmortem`` and ``slo`` are not ported yet (ROADMAP).
"""

from . import decision, occupancy

__all__ = ["decision", "occupancy"]

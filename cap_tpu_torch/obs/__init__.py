"""Decision-grade observability: verdict accounting, SLOs, postmortems,
and the device occupancy plane.

- :mod:`cap_tpu_torch.obs.decision` — WHY tokens are rejected: every
  verify on the card's batch engine, the serve worker and the fleet
  router emits a bounded, redaction-enforced decision record into
  reason-keyed mergeable counters plus a sampled ring;
- :mod:`cap_tpu_torch.obs.slo` — is the availability contract ("never
  wrong, at worst slow") actually holding: declarative objectives
  evaluated with multi-window burn rates;
- :mod:`cap_tpu_torch.obs.postmortem` — what a worker looked like in
  the seconds before it died: periodic crash-consistent checkpoints of
  the telemetry state, collected by the pool on confirmed death;
- :mod:`cap_tpu_torch.obs.occupancy` — the fraction of wall time with
  device work in flight, from busy intervals the keyset records.

Each is the JAX package's module of the same name, stdlib-only, riding
:mod:`cap_tpu_torch.telemetry`.
"""

from . import decision, occupancy, postmortem, slo  # noqa: F401

__all__ = ["decision", "postmortem", "slo"]

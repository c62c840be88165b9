"""Process entry points: ``python -m cap_tpu_torch.fleet.worker_main``
runs one verify worker on the card. The JAX package's pool, router,
front door and chaos tooling are not ported yet (ROADMAP A item 8)."""

"""cap_tpu_torch — the PyTorch/CUDA port of cap_tpu's JWT verify engine.

Batched RS256/ES256 verification on an NVIDIA H100: the JAX package's
RNS engines rewritten in PyTorch, with the RNS REDC and the ES
mixed add as hand-written CUDA kernels (``gpu/csrc``). The entry point
is :class:`~cap_tpu_torch.jwt.gpu_keyset.GPUBatchKeySet`; it runs on
the card unless the caller passes ``device="cpu"``.

The package imports ``torch``, never ``jax``, and nothing of
``cap_tpu``.
"""

__version__ = "0.1.0"

"""cap_tpu_torch — the PyTorch/CUDA port of cap_tpu's JWT verify engine.

Batched RS256/ES256/PS256/EdDSA/ML-DSA verification on an NVIDIA
H100: the JAX package's engines rewritten in PyTorch, with the RNS
REDC, the ES and Ed25519 mixed adds, Keccak-f[1600] and the ML-DSA
NTT and inverse NTT as hand-written CUDA kernels (``gpu/csrc``). The
entry point is :class:`~cap_tpu_torch.jwt.gpu_keyset.GPUBatchKeySet`;
it runs on the card unless the caller passes ``device="cpu"``. Above
it, :mod:`cap_tpu_torch.jwt` has the Validator and the CPU keysets and
:mod:`cap_tpu_torch.oidc` the OIDC relying party (Provider, ID tokens,
callbacks, an in-process TLS IdP).

The package imports ``torch``, never ``jax``, and nothing of
``cap_tpu``.
"""

__version__ = "0.1.0"

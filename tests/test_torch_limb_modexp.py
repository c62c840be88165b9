"""The limb engine's ``modexp_vare`` (``gpu.bignum``) against the JAX
package's, limb for limb, at 2, 5, 17 and 32 exponent bits, with
per-token exponents and s ∈ {0, 1, n − 1} among random s < n, on
three odd 127-bit moduli (8 limbs: each exponent width compiles the
JAX function anew, and a narrow one compiles fastest). Wider moduli
run ``modexp_vare`` at 31 bits in the keyset tests
(``test_torch_keyset_limb.py``, ``test_torch_keyset_arrays.py``), and
``modexp_65537`` limb for limb in ``test_torch_keyset_limb.py``."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cap_tpu.tpu import bignum as jb

from cap_tpu_torch.gpu import bignum as tb
from cap_tpu_torch.gpu import limbs as L


@pytest.mark.parametrize("ebits", [2, 5, 17, 32])
def test_modexp_vare_limb_equal(ebits):
    """Every fourth exponent exactly ``ebits`` bits wide; equal limb for
    limb to the JAX package's and to ``pow``."""
    rng = random.Random(ebits)
    k, n_tok = 8, 16
    mods = [rng.getrandbits(127) | (1 << 126) | 1 for _ in range(3)]
    ns = [mods[j % 3] for j in range(n_tok)]
    s_ints = [0, 1, ns[2] - 1] + [rng.randrange(n) for n in ns[3:]]
    es = [rng.randrange(1 << (ebits - 1), 1 << ebits) if j % 4 == 0
          else rng.randrange(1, 1 << ebits) for j in range(n_tok)]

    def limbs(vals):
        return np.stack([L.int_to_limbs(v, k) for v in vals], axis=1)

    consts = [limbs([tb.mont_params(n, k)[t] for n in ns]) for t in range(3)]
    args = [limbs(s_ints), limbs(ns)] + consts     # s, n, N', R², R
    s, n, nprime, r2, one = args
    ref = np.asarray(jb.modexp_vare(
        jnp.asarray(s), jnp.asarray(np.asarray(es, np.uint32)),
        jnp.asarray(n), jnp.asarray(nprime), jnp.asarray(r2),
        jnp.asarray(one), ebits=ebits))
    s, n, nprime, r2, one = (torch.as_tensor(a.astype(np.int64))
                             for a in args)
    got = tb.modexp_vare(s, torch.as_tensor(es), n, nprime, r2, one, ebits)
    assert np.array_equal(got.numpy(), ref.astype(np.int64))
    assert [L.limbs_to_int(got[:, j].tolist()) for j in range(n_tok)] == \
        [pow(v, e, m) for v, e, m in zip(s_ints, es, ns)]

"""A ``jwks-url:`` worker of the port's fleet, on the CPU: a
``WorkerPool`` of one ``python -m cap_tpu_torch.fleet.worker_main
--keyset jwks-url:<url> --device cpu`` over the loopback
``jwks_test_server``, its verdicts through the ``FleetClient`` against
the in-process ``GPUBatchKeySet(device="cpu")``, and a rotation at the
source reaching it without a restart. A file of its own: the worker
imports torch and builds its keyset, about 10 s here."""

import random
import signal
import time

import pytest

from cap_tpu_torch import testing as tt
from cap_tpu_torch.fleet import FleetClient, WorkerPool
from cap_tpu_torch.jwt import jwk as t_jwk
from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet

HARD_TIMEOUT_S = 50
WAIT_S = 30.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hard_timeout():
    def on_alarm(signum, frame):
        raise TimeoutError(f"fleet test exceeded {HARD_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _wait(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def test_jwks_url_worker_pulls_keys_and_rotates():
    """A ``jwks-url:`` worker (``--device cpu``) boots from a loopback
    JWKS, its verdicts through the router equal the in-process
    ``GPUBatchKeySet(device="cpu")``'s, and a rotation at the source
    reaches it without a restart: on-miss refresh, then its poll."""
    rng = random.Random(83)
    rs = [tt.generate_rsa_key(rng) for _ in range(2)]
    es = tt.generate_ec_key(rng)
    jwk = {"rs-0": t_jwk.serialize_public_key(rs[0].public_key(),
                                              kid="rs-0"),
           "rs-1": t_jwk.serialize_public_key(rs[1].public_key(),
                                              kid="rs-1"),
           "es-0": t_jwk.serialize_public_key(es.public_key(), kid="es-0")}
    toks = [tt.sign_jwt(rs[0], "RS256", tt.default_claims(sub=f"r{i}"),
                        kid="rs-0", rng=rng) for i in range(3)]
    toks += [tt.sign_jwt(es, "ES256", tt.default_claims(sub=f"e{i}"),
                         kid="es-0", rng=rng) for i in range(2)]
    h, p, sig = toks[0].split(".")
    toks += [f"{h}.{p}.{sig[:-4]}AAAA", "not-a-token"]
    new = tt.sign_jwt(rs[1], "RS256", tt.default_claims(sub="n"),
                      kid="rs-1", rng=rng)
    state = {"keys": [jwk["rs-0"], jwk["es-0"]], "etags": True}
    with tt.jwks_test_server(state) as (url, _):
        ks = GPUBatchKeySet(t_jwk.parse_jwks({"keys": state["keys"]}),
                            device="cpu")
        want = [f"{type(r).__name__}: {r}" if isinstance(r, Exception)
                else r for r in ks.verify_batch(toks)]
        with WorkerPool(1, keyset_spec=f"jwks-url:{url}", platform="cpu",
                        keyplane_refresh_s=0.3, keyplane_grace_s=30.0,
                        ping_interval=0.5, spawn_timeout=WAIT_S,
                        worker_args=["--torch-threads", "1"]) as pool:
            assert pool.wait_all_ready(WAIT_S)
            assert pool.key_epochs() == {0: 1}
            cl = FleetClient(pool)
            got = [str(r) if isinstance(r, Exception) else r
                   for r in cl.verify_batch(toks)]
            assert got == want
            assert sum(isinstance(r, dict) for r in got) == 5
            # rotation at the source: rs-1 in, found by the on-miss
            # refresh (or by the poll, when a poll's fetch of the old
            # document was in flight: the miss then joins it)
            state["keys"] = [jwk["rs-0"], jwk["rs-1"], jwk["es-0"]]
            assert _wait(lambda: isinstance(
                cl.verify_batch([new])[0], dict), 10)
            res = cl.verify_batch([new, toks[0]])
            assert res[0]["sub"] == "n" and res[1]["sub"] == "r0"
            assert pool.stats()[0]["key_epoch"] == 2
            # and rs-0 out, found by the poll (no miss triggers it)
            state["keys"] = [jwk["rs-1"], jwk["es-0"]]
            assert _wait(lambda: pool.stats()[0]["key_epoch"] == 3, 10)
            res = cl.verify_batch([new, toks[3]])
            assert [r["sub"] for r in res] == ["n", "e0"]
            assert state["not_modified"] >= 1     # polls were 304s

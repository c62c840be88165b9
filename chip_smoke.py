#!/usr/bin/env python3
"""Drive cap_tpu_torch on one NVIDIA card and hold it to its plain path.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. the card's name and power limit (nvidia-smi), then the build of
   every kernel from ``cap_tpu_torch/gpu/csrc`` with nvcc for sm_90a
   and of the host targets from ``cap_tpu_torch/runtime/native`` and
   ``cap_tpu_torch/serve/native`` with g++ (the prep library, the
   claims extension, the claims rules, the native serve chain with its
   telemetry plane and shm rings, the front door's relay and the C
   client), one compiler a target, all in parallel;
2. kernels: each kernel against its plain PyTorch version on the card
   at the main paths' shapes (23+23 RNS channels, 65,536 lanes: one
   32,768-token ES or EdDSA chunk with both ladder chains; redc and
   madd on P-256, edw on the Ed25519 field: one window, its table
   gather inside, over a random packed table of the basepoint and 9
   keys), outputs equal by value mod p on both residue planes, ``deg``
   equal on true degeneracies;
   kernel and plain times by CUDA events. keccak (65,536 states), ntt
   and intt (65,536 rows each, edge values 0 and q − 1 included) equal
   to their plain versions on every state and row. redc and madd also
   at P-384's 34+33 and P-521's 45+45 channels; the whole-ladder
   kernel at 65,536 lanes over a table of G and 8 keys, 32 windows on
   P-256, 48 on P-384 and 66 on P-521, against its plain version and
   the per-window path (gathers + W madd launches) on every lane, with
   planted same-x degeneracies. The RNS kernels' bounds count their
   work per pipe (``madd_work`` and the rest); the JSON carries
   ptxas's registers, stack frame and spill bytes of each redc, madd,
   ladder and edw instantiation and of the keccak, ntt and intt
   kernels;
3. the north-star path — a JWKS of 8 RSA-2048 and 8 P-256 keys and a
   batch of 65,536 RS256/ES256 tokens tiled from 1,024 unique signed
   tokens, a seeded 1/8 share tampered, and a few tokens of each
   rejection class — through ``GPUBatchKeySet(jwks).verify_batch``;
   first the card host's native prep of the whole batch held against
   ``jwt.jose.parse_jws`` and ``hashlib`` on every token, and one
   chunk's records of each family against the numpy builders; then
   every verdict checked, the unique tokens cross-checked on the
   pure-integer oracle, the kernels' launch counters zeroed before one
   run and read after it, verifies/s timed after a warm-up, one warm
   batch split by phase ("batch breakdown": native prep, the rest of
   the dispatch, claims prefetch, syncs and finishes, trial path), one
   whose collect phase runs under cProfile ("collect profile"), the
   native prep and the claims prefetch timed alone ("host prep",
   "claims prefetch") and each engine's records and device time. Each
   ES chunk runs the whole-ladder kernel once and redc 11 times, madd
   never;
4. the validator path, on the north-star's keys and batch: 4 RSA and
   4 P-256 keys served as x5c-only JWKs (rs-0 with its parameters
   too) behind a loopback OIDC discovery document, loaded through
   ``new_oidc_discovery_keyset(issuer).keys()`` and held equal to the
   originals; ``Validator(GPUBatchKeySet(keys)).validate_batch`` on the
   65,536 tokens with 224 more tiled in (32 of each claims rejection
   class), every verdict checked, its launches equal to
   ``verify_batch``'s (1 ladder + 11 redc an ES chunk); a 4,096-token
   slice with only RS256 allowed (every verifying ES256 token gets
   ``UnsupportedAlgError``); validate_batch and verify_batch timed in
   turns and the claims loop alone; then every unique token held
   against the single-token Validators over the JSONWebKeySet and over
   a StaticKeySet of SPKI and PKCS#1 PEMs (same class, equal claims),
   in one spawned process a host core;
5. the config-3 path (BASELINE.json's third configuration) the same
   way (the oracle cross-check on 256 of the unique tokens): 8 P-256
   and 8 P-384 keys, 65,536 ES256/ES384 tokens, the ES rejection
   classes, one chunk of each curve, each one ladder launch; then
   every whole-ladder input of one batch, captured at the wrapper,
   replayed through the plain version and timed at that shape;
6. the PS256 + EdDSA path (BASELINE.json's fourth configuration) the
   same way: 8 RSA-2048 and 8 Ed25519 keys plus one Ed25519 key that
   does not decode, 65,536 PS256/EdDSA tokens, the EdDSA and PS256
   rejection classes, edw launched 32 times and redc 3 times per
   EdDSA chunk, madd never;
7. the pq-mldsa path the same way: 8 ML-DSA-44 and 8 ML-DSA-65 AKP
   keys, 16,384 tokens half under each set tiled from 256 unique ones,
   the ML-DSA rejection classes, keccak launched 14 times, ntt twice
   and intt once per ML-DSA chunk of 1,024 tokens, madd, edw and redc
   never; then one more batch with the keccak, ntt and intt wrappers
   hooked, every input they were handed replayed through the plain
   versions ([1024, 25, 2] states; [1024, l, 256], [1024, 256] and
   [1024, k, 256] rows), and both timed at each of those shapes;
8. the engine modes, through the engine entry points that take them
   (``rns=``, ``ladder=``; the JAX package reads them from its
   environment) on the signatures of the north-star's first 8,192
   tokens, config-4's first 8,192 and pq-mldsa's first 2,048, each
   pass one counted run after its window tables are built (every
   launch counter zeroed just before it and read just after it, every
   verdict the signature's, the engine entries it called counted),
   then one timed run beside the default entries' on the same inputs:
   (a) ``rns=False`` (RS256 by ``modexp_65537``, ES256 by the limb
   Jacobian ladder: no kernel), (b) ES256 with ``ladder="affine"``
   (the RNS affine ladder: redc W·(2·log2(M/128) + pbits +
   popcount(p − 2) + 2) + 11 times, ``ec_rns.affine_redc_launches``,
   every launch held against the plain REDC on its inputs and each
   lane count timed; no ladder, no madd), (c) ES256 with ``rns=False,
   ladder="affine"`` (the limb affine ladder: no kernel), (d) config-4
   with ``rns=False`` (EdDSA by the limb ladder, PS256 by
   ``modexp_65537`` with the device PSS check: no kernel), (e) pq-mldsa
   on the two-phase arm (``verify_mldsa_batch``: 2 ntt and 1 intt
   launches a set, no Keccak, the host SHAKE counted);
9. the ps-sha512 path the same way: 8 RSA-2048 keys, 65,536 tokens half
   PS384 and half PS512 tiled from 1,024 unique ones, the 1/8 tampered
   share, three tokens of each PS rejection class of config-4 under
   each hash, no kernel launched (the PS engine is PyTorch); before the
   batch, the device SHA-384/512 against hashlib at every length 0–300
   (0–111 for the one-block form) and on one chunk's MGF1 seeds and M'
   inputs of each hash, captured where the engine hashes them, timed
   by CUDA events;
10. the pq-slhdsa path the same way: 8 SLH-DSA-SHAKE-128f and 8
   SLH-DSA-SHAKE-128s AKP keys, 512 tokens half under each set tiled
   from 16 unique 128f and 2 unique 128s tokens, the 1/8 tampered
   share, three tokens of each SLH-DSA rejection class under each set,
   a kid-less token of each set, an unknown kid and a 128f alg over a
   128s kid; keccak launched 518 times a 128f chunk and 219 times a
   128s chunk, no other kernel; then one more batch with the keccak
   wrapper hooked, every input replayed through the plain version
   ([256, 33 | 14 | 35, 25, 2] and [256, 25, 2] states) and both
   timed at each shape;
11. the config-2 path (BASELINE.json's second configuration) the same
   way: 4 RSA-2048 and 4 RSA-4096 keys, 65,536 tokens a third each
   RS256, RS384 and RS512 over both widths, the RS rejection classes
   under each width, a kid-less token and an unknown kid; the RNS
   engine at two widths, no kernel launched;
12. the rsa-limb path the same way: an RSA-2048 class of e = 3, 17,
   65537 and 2^31 − 1 keys (``modexp_vare``), an RSA-3072 class with a
   4099·q modulus (``modexp_65537`` on limbs) and 4 P-256 keys, 16,384
   tokens half RS256/PS256 and half ES256 (one ES chunk: 1 ladder + 11
   redc); then one full limb chunk a width (2048-bit vare at 16,384
   tokens, 3072- and 4096-bit F4 at 8,192) timed by CUDA events with
   its peak device memory, 64 lanes against ``pow``;
13. the big-jwks path the same way: 300 RSA-2048, 300 P-256 and 300
   Ed25519 keys, so every class takes the arrays path (int64 key
   rows), 32,768 tokens a third each RS256, ES256 and EdDSA over all
   300 rows, the rejection classes over rows above 255; one ES chunk
   (1 ladder + 11 redc) and one EdDSA chunk (32 edw + 3 redc); then
   every ladder, redc and edw input of one batch replayed through the
   plain versions (key rows above 255 read) and the ladder and edw
   timed at those shapes;
14. the oidc path (BASELINE.json's fifth configuration): the port's
   ``oidc.testing.TestProvider`` on loopback TLS (its CA a pure-Python
   P-256 certificate), mid-rotation with 4 P-256 keys and 1 RSA-2048
   key in its JWKS; a ``Provider`` built through discovery over
   ``GPUBatchKeySet`` of the JWKS at the discovered jwks_uri (keys
   held equal to the IdP's); one code flow with PKCE (auth_url,
   /authorize, exchange over post_form, verify_id_token, at_hash,
   c_hash, userinfo) and one implicit flow through
   ``callback.implicit``; then ``verify_id_token_batch`` on 100,000 ID
   tokens tiled from 1,024 signed by the 4 ES256 keys (the 1/8
   tampered share) with three tokens of each native status class,
   fallback class and signature class, in dict and raw modes, every
   verdict checked, the raw bytes the dict mode's payloads, both modes
   launching what verify_batch launches (1 ladder + 11 redc an ES
   chunk), the native-validated and fallback counts; a second request
   with max_age over an 8,192-token slice (every accepted token to the
   Python rules); the all-accepted slice (native rules take every
   token); dict, raw and verify_batch_raw timed in turns and the
   native rules call alone, one batch split by phase and one profiled
   on the device; every unique token against the single-
   token ``verify_id_token`` over the CPU JSONWebKeySet in spawned
   processes;
15. the serve path: ``VerifyWorker(GPUBatchKeySet)`` on loopback (raw
   claims, the async pipeline; the verdict cache and dedup off) takes
   the north-star's 65,536 tokens as requests of 1 to 4,096 tokens
   over 4 pipelined ``VerifyClient`` connections: every verdict as
   expected and equal to ``verify_batch_raw``, the ladder launches
   equal to the ES chunks the keyset counted (11 redc each),
   verifies/s over the socket, p50/p99 request latency and the
   device's idle share under the profiler ("serve path line"); the
   same traffic through the native chain (``serve_native=True``, C++
   readers and writers, its telemetry plane on; "serve native line",
   with its frame, token and ring high-water counts) and over the shm
   transport on the native chain (4 pipelined ``ShmVerifyClient``
   connections, rings sized from the largest frame, in /dev/shm when
   it has room, else a temporary directory; "serve shm line"); then
   the deployed defaults on the Python chain and on the native chain:
   a KEYS push mid-stream (rs-0 and es-0, then rs-1 and es-1 dropped,
   a new RSA-2048 and P-256 key added, a 2 s grace), tokens under the
   dropped kids accepted in the grace and rejected once the keyset's
   retire counter moves (the grace's accepts too: the verdict cache
   kept none of them), STATS at the new epoch, a request replayed from
   the verdict cache with the keyset's token counter unchanged; and
   ``python -m cap_tpu_torch.fleet.worker_main --keyset jwks:<file>``
   on the card, then with ``--serve-chain native --transport shm``
   and an shm client: its ready line, one request, SIGTERM, exit 0.
   The Python-chain and native-chain passes serve the obs endpoints
   (``obs_port=0``): after each pass's clock stops, a STATS frame and
   a scrape of /healthz, /metrics, /snapshot, /flight, /decisions and
   /tenants, the scrape's worker and decision counters equal to
   STATS', the device's dispatches and busy time above zero, /metrics
   Prometheus text ("… obs scrape");
16. the fleet path: the north-star's JWKS served on loopback, a
   ``WorkerPool`` of two ``worker_main --keyset jwks-url:<url>``
   processes (worker 0 owning the card, worker 1 on the CPU, a 1 s
   keyplane poll and a 2 s grace) behind ``FleetClient(pool,
   fallback=None)``: 24 seeded requests of 64–384 north-star tokens
   from 4 threads, every verdict as expected and equal to
   ``verify_batch_raw`` on the card, the card worker's ES chunks read
   from its /snapshot; a pull rotation at the source (rs-0 and es-0
   out, a new RSA-2048 and P-256 key in: the dropped kids accepted on
   each worker inside its grace, rejected after it, the new kids
   accepted), a push rotation (``pool.push_keys``, epoch skew 0), a
   ``kill -9`` of the card worker mid-stream (every verdict right, the
   respawn onto the card, the epochs reconverged, its postmortem with
   the flight ring and no token's signature segment), the SLO defaults
   over the merged counters, and the pool closed within a deadline
   ("fleet line": verifies/s through the router, p50/p99, the split by
   worker, boot, convergence and respawn seconds);
17. the frontdoor path, on the fleet's two workers before its pool
   closes, each a host: a ``worker_main --keyset frontdoor:…
   --frontdoor-chain native`` process (its ready line, one request,
   SIGTERM); the Python gate ``VerifyWorker(FrontDoor)`` and the native
   relay ``NativeFrontDoorServer(FrontDoor)``, both ``fallback=None``,
   each sent 640 of the window's tokens twice (requests of 64 over 2
   connections): every verdict as expected and equal to
   ``verify_batch_raw``, each host's tokens the ring's split (and its
   spills), lookups = hits + misses, the repeats' cacheable rejects
   hitting their host's verdict cache, the card host's ES chunks; a
   ``kill -9`` of the CPU worker in a stream through the relay (its
   tokens re-routed, no wrong verdict, the ring's owner serving again
   after the respawn); ``FrontDoor.push_keys`` with epoch skew 0
   ("frontdoor line": verifies/s and p50/p99 a gateway, tokens a host,
   the routing and relay counters, the phase's seconds);
18. the w12 phase: the whole-ladder kernel at 12-bit windows (22, 32
   and 44 on P-256, P-384 and P-521) at 65,536 lanes over a table of G
   and 8 key slots (4,095 rows a slot and window), held against its
   plain version on every lane with planted degeneracies and timed in
   turns with itself at 8 bits (8, 12, 12, 8), each against its bound,
   while each key set's 12-bit table builds in a worker process (host
   seconds, bytes, seconds to the card); then the ES signatures of the
   first 8,192 tokens of the north-star and config-3 through
   ``ec.verify_ecdsa_batch(..., w_bits=12)``: the 8-bit entries timed
   with every verdict the signature's, one counted run at 12 bits (1
   ladder + 11 redc a call, every verdict the signature's, every
   ladder and redc launch held against its plain version at the path's
   shapes, each shape timed) and one more timed beside them;
19. the mesh phase, on one card: ``GPUBatchKeySet(jwks,
   mesh=Mesh([cuda:0, cuda:0]))`` on the first 8,192 tokens of the
   north-star and config-4, the first 2,048 of pq-mldsa and
   pq-slhdsa's 512, beside the unmeshed keyset: verdicts equal, each
   chunk's launches once a shard (counted over one run in which every
   launch is held against its plain version at the shard's shape, each
   shape timed), both timed warm in turns; the first 1,024 tokens of
   the north-star and config-4 over ``Mesh([cuda:0, cpu])`` (one shard
   a chunk on the CPU's plain path; launches once a chunk, verdicts
   equal); then the sharded steps (``parallel.mesh``'s limb step with
   the key gather, the limb step, the RNS step) on the north-star's
   RS256 signatures and RSA-2048 keys, ok vectors and totals against
   each signature's verdict.

Every cell's fixtures (keys, signed tokens, the unique tokens on the
pure-integer oracle) are built in worker processes (spawned, one a
core less one) while the card runs the kernel phases (1, kernels at
the wide moduli, and the ladder), which time the card alone; the run
waits for all of them before the north-star ("phase fixtures"), so no
phase that times the host runs beside them. Each phase's seconds and
the whole run's are logged ("phase …" and "chip_smoke: … s in all").
The line before the last is the per-kernel
JSON record; the last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import random
import subprocess
import sys
import time

SEED = 20261016
N_TOKENS = 65536
N_UNIQUE = 1024
# pq-mldsa: the host decode of an ML-DSA token (its 2.4-3.3 KB
# signature) costs several times an RS/ES token's, so the cell runs
# 16 chunks of 1,024 tokens, not 65,536 tokens; 256 unique tokens keep
# the pure-Python signer's fixture time near half a minute.
N_PQ_TOKENS = 16384
N_PQ_UNIQUE = 256
# pq-slhdsa: the host decode of an SLH-DSA token (per-token Python, as
# in the JAX package) costs milliseconds, so the cell runs 512 tokens,
# half under each set (one chunk a set); a 128s signature takes seconds
# of pure Python, so 2 unique 128s tokens beside 16 unique 128f tokens
# (the rejection classes need 2 and 9). Cut from 2,048 tokens and 64 + 8
# unique ones to make room for the oidc path.
N_SLH_TOKENS = 512
N_SLH_UNIQUE_F = 16
N_SLH_UNIQUE_S = 2
SLH_F = "SLH-DSA-SHAKE-128f"
SLH_S = "SLH-DSA-SHAKE-128s"
# keccak launches of one SLH-DSA chunk (gpu/slhdsa.py chunk_launches):
# 128f (k = 33, a = 6, d = 22, h' = 3): 1 FORS leaf + 6 folds + 5 T_k
# blocks, then 22 x (15 chain steps + 5 T_len blocks + 3 XMSS folds);
# 128s (k = 14, a = 12, d = 7, h' = 9): 1 + 12 + 3, then 7 x (15 + 5 + 9)
SLH_LAUNCHES = {SLH_F: 518, SLH_S: 219}
KERNEL_LANES = 65536
# H100 SXM peaks at 700 W. HBM: 3.35 TB/s (NVIDIA data sheet). INT32:
# Hopper issues 64 int32 multiply-adds per SM per clock (CUDA C++
# Programming Guide, arithmetic throughput table, compute capability
# 9.0), half its 128 float32 FMAs; the data sheet's 67 TFLOP/s float32
# rate (132 SMs at 1.98 GHz) halved, counting a multiply-add as 2 ops.
HBM_BPS = 3.35e12
INT32_OPS = 33.5e12
# Hopper issues integer instructions on two pipes, 64 per SM per clock
# each (16.75 T/s): multiplies and multiply-adds on the FMA pipe; adds,
# compares, selects, logic ops and (funnel) shifts on the integer ALU
# pipe. The keccak and ntt bounds count each pipe's instructions at
# that rate and take the busier pipe.
INT_PIPE = INT32_OPS / 2


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(text: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel
    instantiation in an ``nvcc -Xptxas -v`` log: {"madd<23,23> T=8":
    {"registers": r, "stack_frame": f, "spill_stores": s, "spill_loads":
    l}, ...} (" T=…" where an RNS kernel takes a group size; "keccak",
    "ntt_fwd" and "intt" for the ML-DSA kernels, "ntt<false>" and
    "ntt<true>" for an older checkout's)."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            m = re.search(r"(redc|madd|ladder|edw)_kernelILi(\d+)ELi(\d+)E"
                          r"(?:Li(\d+)E)?", line)
            k = re.search(r"(keccak|ntt_fwd|intt)_kernel|ntt_kernelILb([01])E",
                          line)
            if m:
                cur = f"{m[1]}<{m[2]},{m[3]}>" + (f" T={m[4]}" if m[4]
                                                  else "")
            elif k:
                cur = k[1] or f"ntt<{'true' if k[2] == '1' else 'false'}>"
            if m or k:
                out.setdefault(cur, {})
                continue
        if cur is None:
            continue
        sp = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads", line)
        if sp:
            out[cur].update(stack_frame=int(sp[1]), spill_stores=int(sp[2]),
                            spill_loads=int(sp[3]))
        rg = re.search(r"Used (\d+) registers", line)
        if rg:
            out[cur]["registers"] = int(rg[1])
    return out


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


PROFILE_TRIES = 3


def kernel_ms(fn, reps: int, key: str):
    """(ms, by): the mean device time of one launch of the kernel whose
    name holds ``key``, over ``reps`` calls of fn (torch.profiler over
    CUPTI), by "profiler". At the path's small shapes a call's host
    work outlasts its kernel, so CUDA events around a loop of calls
    time the host: only when PROFILE_TRIES profiles in a row record no
    launch of the kernel is that time returned, by "events", and no
    table may read it as a launch's device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    for i in range(PROFILE_TRIES):
        with device_profile() as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [v for name, v in device_events(prof).items()
               if key in name and v[1]]
        n = sum(c for c, _ in evs)
        if n:
            return sum(us for _, us in evs) / n / 1e3, "profiler"
        log(f"kernel_ms: no device time recorded for {key} (profile "
            f"{i + 1} of {PROFILE_TRIES})")
    log(f"kernel_ms: {key} timed by CUDA events: a call's host time, not "
        f"the kernel's")
    return cuda_ms(fn, reps), "events"


# -- the RNS kernels' work per lane, by pipe, for the bounds ---------------
# The least work a lane needs, counted the same way whatever implements
# it: the extension products on the int8 tensor cores (four products
# of 7-bit halves a weight, 2 ops each, at 1,979 T op/s); each
# reduction an integer Barrett (a multiply-high and a multiply on the
# FMA pipe; a subtract and an unsigned min of r and r − m on the ALU
# pipe); lazy adds and subs one ALU instruction a digit; α on the
# float32 pipe (a multiply and an add a source digit, 128 a clock an
# SM) with one
# conversion a source digit and one for its floor on the conversion
# pipe (16 a clock an SM, the CUDA C++ Programming Guide's throughput
# table for compute capability 9.0). The bound is the busiest pipe, or
# the bytes.
INT8_OPS = 1979e12
FP32_PIPE = INT32_OPS          # 33.5 T float32 instructions/s
CVT_PIPE = INT_PIPE / 4        # 4.19 T conversions/s
PIPE_RATE = dict(fma=INT_PIPE, alu=INT_PIPE, fp32=FP32_PIPE, cvt=CVT_PIPE,
                 mma=INT8_OPS)
RED = dict(fma=2, alu=2)


def work(*parts, **counts) -> dict:
    """Sum of per-pipe counts: each part a dict or (k, dict) for k
    times it, plus keyword counts."""
    out = dict.fromkeys(PIPE_RATE, 0)
    for part in parts + (counts,):
        k, d = part if isinstance(part, tuple) else (1, part)
        for pipe, v in d.items():
            out[pipe] += k * v
    return out


def extend_work(i_src: int, i_dst: int) -> dict:
    # per destination digit: the hh reduction, the recombination
    # hh·2^14 + mid·2^7 + ll (two multiply-adds), the α fold (a
    # multiply-add and a select) and the final reduction
    return work((2 * i_dst, RED), mma=8 * i_src * i_dst, fma=3 * i_dst,
                alu=i_dst, fp32=2 * i_src + 1, cvt=i_src + 1)


def redc_work(ia: int, ib: int) -> dict:
    # σ = x_A·sig_c (a product and a reduction an A digit); t_B =
    # (x_B + q·p)·A⁻¹ and σ' = t_B·(B/b_j)⁻¹ (three products and three
    # reductions a B digit)
    return work(extend_work(ia, ib), extend_work(ib, ia),
                (ia + 3 * ib, RED), fma=ia + 3 * ib)


def rmul_work(ia: int, ib: int) -> dict:
    return work(redc_work(ia, ib), (ia + ib, RED), fma=ia + ib)


def edw_work(ia: int, ib: int) -> dict:
    # 7 multiplies; three lazy subs and four adds; the unpack of the
    # table triple (a mask or a shift a digit)
    return work((7, rmul_work(ia, ib)), alu=10 * (ia + ib))


def madd_work(ia: int, ib: int) -> dict:
    i = ia + ib
    # 11 multiplies; 6 lazy adds and 8 subs; rr, X3, Y3, Z3 reduced;
    # the probe (2 reductions, 40 compares, 20 ORs); the unpack of x2,
    # y2 and the lift and select (two selects an output digit)
    return work((11, rmul_work(ia, ib)), (4 * i + 2, RED),
                alu=14 * i + 60 + 2 * i + 6 * i)


def rns_bound(nbytes: float, per_lane: dict, lanes: int):
    """(bound ms, by, busiest pipe) of ``lanes`` lanes of ``per_lane``
    work moving ``nbytes``."""
    t_b = nbytes / HBM_BPS * 1e3
    pipe = max(PIPE_RATE, key=lambda p: per_lane[p] / PIPE_RATE[p])
    t_o = lanes * per_lane[pipe] / PIPE_RATE[pipe] * 1e3
    return (t_b, "bytes", pipe) if t_b >= t_o else (t_o, "operations", pipe)


def keccak_instr() -> int:
    """ALU-pipe instructions of one permutation (it has no multiply),
    the least the round needs on interleaved words: θ's column parities
    as three-input XORs (2 per parity word), its 5 one-step rotations
    and 10 XORs for D and 50 XORs to apply D; ρ's nonzero word
    rotations; χ as one three-input logic op per word; ι's 2 XORs."""
    from cap_tpu_torch.gpu import keccak as kk

    rho = int((kk._RHO_RE != 0).sum() + (kk._RHO_RO != 0).sum())
    return 24 * (20 + 5 + 10 + 50 + rho + 50 + 2)


# a Montgomery product: a wide multiply, a multiply and a wide
# multiply-add on the FMA pipe, a compare and a select on the ALU pipe;
# add_q and sub_q: an add, a compare and a select on the ALU pipe
MONT_FMA, MONT_ALU, ADDQ_ALU = 3, 2, 3


def ntt_instr(inverse: bool) -> int:
    """Instructions of one 256-point row on its busier pipe (the ALU):
    8 stages of 128 butterflies (one product, one add_q, one sub_q),
    and for the inverse the 256 products of the 256⁻¹ scale."""
    products = 8 * 128 + (256 if inverse else 0)
    alu = products * MONT_ALU + 8 * 128 * 2 * ADDQ_ALU
    return max(alu, products * MONT_FMA)


def bound(nbytes: float, ops: float, rate: float = INT32_OPS):
    t_b = nbytes / HBM_BPS * 1e3
    t_o = ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def mldsa_bound(name: str, units: int):
    """(bound ms, by) of keccak on ``units`` states (400 B in and out a
    state) or of ntt / intt on ``units`` rows (2 KB a row)."""
    if name == "keccak":
        return bound(units * 2 * 200, units * keccak_instr(), INT_PIPE)
    return bound(units * 2 * 1024, units * ntt_instr(name == "intt"),
                 INT_PIPE)


# -- inputs -----------------------------------------------------------------

def residues_of_bytes(c, raw):
    """[N, L] big-endian value bytes → (A [I_A, N], B [I_B, N]) int32
    residues, exact (float64 sums of byte × (256^j mod m) < 2^53)."""
    import numpy as np

    n, width = raw.shape
    ms = [int(m) for m in c.A.m] + [int(m) for m in c.B.m]
    powm = np.array([[pow(256, width - 1 - j, m) for m in ms]
                     for j in range(width)], np.float64)
    res = (raw.astype(np.float64) @ powm).astype(np.int64) % \
        np.asarray(ms, np.int64)[None, :]
    ia = c.A.count
    return (np.ascontiguousarray(res[:, :ia].T).astype(np.int32),
            np.ascontiguousarray(res[:, ia:].T).astype(np.int32))


def crt(base, col) -> int:
    """CRT value of one residue column over an RNS base."""
    return sum(int(r) * int(inv) % int(m) * mi for r, inv, m, mi in
               zip(col, base.inv_Mi, base.m, base.Mi)) % base.prod


def max_err(c, kernel, plain):
    """Compare two (A [I_A, N], B [I_B, N]) residue pairs lane by lane.

    Bit-equal lanes contribute 0. On a lane where either plane differs,
    each plane's CRT value (base A, base B) is compared with the plain
    one's mod p, folded to the nearer representative, and the kernel's
    two planes must hold one integer. Returns (max err, lanes that
    differ, lanes whose A and B planes disagree)."""
    import numpy as np

    (ka, kb), (pa, pb) = kernel, plain
    diff = np.nonzero((ka != pa).any(axis=0) | (kb != pb).any(axis=0))[0]
    p = c.p_int
    err = split = 0
    for j in diff:
        va, vb = crt(c.A, ka[:, j]), crt(c.B, kb[:, j])
        split += va != vb
        for d in ((va - crt(c.A, pa[:, j])) % p,
                  (vb - crt(c.B, pb[:, j])) % p):
            err = max(err, min(d, p - d))
    return err, len(diff), split


def pack_words(c, a, b):
    """(A [I_A, N], B [I_B, N]) residues → [max(I_A, I_B), N] int32
    table words, A|B<<16 (ec_rns._pack_residue_rows)."""
    import numpy as np

    out = np.zeros((max(c.A.count, c.B.count), a.shape[1]), np.int32)
    out[:c.A.count] = a
    out[:c.B.count] |= b << 16
    return out


def redc_check(c, rng, n: int, label: str):
    """The REDC kernel against its plain version on ``n`` lanes of
    products x < 2^(16·cb) < A·p (what an rmul feeds its REDC, cb the
    curve's coordinate bytes), 64 lanes also against x·A⁻¹ mod p;
    the kernel's device time by the profiler, the plain version's by
    CUDA events."""
    import numpy as np
    import torch

    from cap_tpu_torch.gpu import cuda_redc

    ia, ib = c.A.count, c.B.count
    p = c.p_int
    T = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    raw = rng.integers(0, 256, (n, 2 * c.cp.coord_bytes), dtype=np.uint8)
    xa, xb = residues_of_bytes(c, raw)
    xA, xB = T(xa), T(xb)
    tA, tB = cuda_redc.redc(c, xA, xB)
    rA, rB = cuda_redc.redc_ref(c, xA, xB)
    torch.cuda.synchronize()
    ka = tA.cpu().numpy()
    err, ndiff, split = max_err(c, (ka, tB.cpu().numpy()),
                                (rA.cpu().numpy(), rB.cpu().numpy()))
    a_inv = pow(c.A.prod, -1, p)
    for j in rng.choice(n, 64, replace=False):
        x = int.from_bytes(raw[j].tobytes(), "big")
        assert (c.value_of(ka[:, j]) - x * a_inv) % p == 0, "redc value"
    assert err == 0 and split == 0, \
        f"redc disagrees by {err} on {ndiff} lanes ({split} split)"
    # the kernel's device time a launch: at 65,536 lanes a call's host
    # work outlasts the kernel, so CUDA events around a loop of calls
    # would time the host
    ms_k, by = kernel_ms(lambda: cuda_redc.redc(c, xA, xB), 50,
                         "redc_kernel")
    ms_p = cuda_ms(lambda: cuda_redc.redc_ref(c, xA, xB), 10)
    nbytes = n * (2 * ia + 2 * ib) * 4
    b_ms, b_by, pipe = rns_bound(nbytes, redc_work(ia, ib), n)
    log(f"kernel {label}: {n} lanes, {ndiff} lanes not bit-equal in A or "
        f"B, max value err {err} over both planes; kernel {ms_k:.4f} ms "
        f"(by {by}), plain {ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{pipe})")
    return dict(max_abs_err=err, ms=ms_k, by=by, plain_ms=ms_p,
                bound_ms=b_ms, bound_by=b_by)


def madd_check(c, rng, n: int, label: str):
    """The mixed-add kernel against its plain version on ``n`` lanes:
    states below 11p, table points below p, random has/inf,
    every 97th lane a true same-x degeneracy (X = x2·Z², has, ¬inf);
    outputs equal by value on both planes, ``deg`` on every true
    degeneracy and on no masked lane; times by CUDA events."""
    import numpy as np
    import torch

    from cap_tpu_torch.gpu import cuda_madd

    ia, ib = c.A.count, c.B.count
    p = c.p_int
    cb = c.cp.coord_bytes
    a_dom = c.A.prod % p
    T = lambda a: torch.from_numpy(a).cuda()  # noqa: E731

    def rand_vals(top):
        raw = rng.integers(0, 256, (n, cb), dtype=np.uint8)
        raw[:, 0] = np.minimum(raw[:, 0], top)
        return raw

    # leading-byte caps: states below 11p, table points below p
    shift = 8 * (cb - 1)
    state_top = min(255, (11 * p >> shift) - 1)
    point_top = (p >> shift) - 1
    xs, ys, zs = (rand_vals(state_top) for _ in range(3))
    x2s, y2s = rand_vals(point_top), rand_vals(point_top)
    has = rng.integers(0, 2, n).astype(bool)
    inf = rng.integers(0, 2, n).astype(bool)
    true_deg = np.zeros(n, bool)
    a_inv_dom = pow(a_dom, -1, p)
    for j in range(0, n, 97):
        z = int.from_bytes(zs[j].tobytes(), "big") * a_inv_dom % p
        x2 = int.from_bytes(x2s[j].tobytes(), "big") * a_inv_dom % p
        xs[j] = np.frombuffer(((x2 * z * z % p) * a_dom % p)
                              .to_bytes(cb, "big"), np.uint8)
        has[j], inf[j], true_deg[j] = True, False, True
    planes = [tuple(T(a) for a in residues_of_bytes(c, v))
              for v in (xs, ys, zs)]
    x2p, y2p = (T(pack_words(c, *residues_of_bytes(c, v)))
                for v in (x2s, y2s))
    t_has, t_inf = T(has), T(inf)
    out_k = cuda_madd.madd(c, *planes, t_inf, t_has, x2p, y2p)
    out_p = cuda_madd.madd_ref(c, *planes, t_inf, t_has, x2p, y2p)
    torch.cuda.synchronize()
    err = ndiff = split = 0
    for kk, pp in zip(out_k[:3], out_p[:3]):
        e, d, sp = max_err(c, [t.cpu().numpy() for t in kk],
                           [t.cpu().numpy() for t in pp])
        err, ndiff, split = max(err, e), ndiff + d, split + sp
    deg_k = out_k[3].cpu().numpy()
    deg_p = out_p[3].cpu().numpy()
    assert err == 0 and split == 0, \
        f"madd disagrees by {err} on {ndiff} lane planes ({split} split)"
    assert deg_k[true_deg].all() and deg_p[true_deg].all(), "deg missed"
    assert not deg_k[~has | inf].any(), "deg on a masked lane"
    deg_only = int((deg_k != deg_p).sum())
    ms_k = cuda_ms(lambda: cuda_madd.madd(c, *planes, t_inf, t_has,
                                          x2p, y2p), 20)
    ms_p = cuda_ms(lambda: cuda_madd.madd_ref(c, *planes, t_inf, t_has,
                                              x2p, y2p), 5)
    iap = max(ia, ib)
    nbytes = n * (4 * (3 * (ia + ib) + 2 * iap) + 2
                  + 4 * 3 * (ia + ib) + 1)
    b_ms, b_by, pipe = rns_bound(nbytes, madd_work(ia, ib), n)
    log(f"kernel {label}: {n} lanes, {ndiff} lane planes not bit-equal in "
        f"A or B, max value err {err} over both planes, "
        f"{int(true_deg.sum())} true degeneracies flagged by both, "
        f"{deg_only} probe flags differ; kernel {ms_k:.4f} ms, plain "
        f"{ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {pipe})")
    return dict(max_abs_err=err, ms=ms_k, by="events", plain_ms=ms_p,
                bound_ms=b_ms, bound_by=b_by)


def kernel_phase(records):
    import numpy as np

    from cap_tpu_torch.gpu import ec_rns

    c = ec_rns.ctx_for("P-256")
    rng = np.random.default_rng(SEED)
    records["redc"] = redc_check(c, rng, KERNEL_LANES, "redc")
    records["madd"] = madd_check(c, rng, KERNEL_LANES, "madd")
    edw_phase(records, rng)


def wide_phase(records):
    """REDC and madd at P-384's 34+33 and P-521's 45+45 channels,
    65,536 lanes (one 32,768-token ES384 chunk's ladder lanes)."""
    import numpy as np

    from cap_tpu_torch.gpu import ec_rns

    for k, crv in enumerate(("P-384", "P-521")):
        c = ec_rns.ctx_for(crv)
        rng = np.random.default_rng(SEED + 5 + 2 * k)
        ch = f"{c.A.count}+{c.B.count}"
        shape = dict(curve=crv, channels=ch, lanes=KERNEL_LANES)
        for name, check in (("redc", redc_check), ("madd", madd_check)):
            rec = check(c, rng, KERNEL_LANES, f"{name} at {ch} ({crv})")
            records[name].setdefault("shapes", []).append(dict(shape, **rec))


def edw_phase(records, rng):
    """One Ed25519 ladder window (``cuda_edw.edw_window``) at 65,536
    lanes, as a 32,768-token EdDSA chunk runs it: states below 2^256
    (< 3p, the REDC output bound), a packed table of random triples
    below p in the basepoint's slot and 9 key slots (config-4's 8 + 1
    keys), and window 17's rows, the B chain on the basepoint's slot
    and the A chain on random key slots, with random digits."""
    import numpy as np
    import torch

    from cap_tpu_torch.gpu import cuda_edw, ed25519_rns

    c = ed25519_rns.ctx()
    ia, ib = c.A.count, c.B.count
    iap = max(ia, ib)
    n = KERNEL_LANES
    dev = torch.device("cuda")

    def raw(m, top):
        r = rng.integers(0, 256, (m, 32), dtype=np.uint8)
        r[:, 0] = np.minimum(r[:, 0], top)
        return r

    state = [tuple(torch.from_numpy(a).to(dev)
                   for a in residues_of_bytes(c, raw(n, 255)))
             for _ in range(4)]
    slot = ed25519_rns.NW8 * ed25519_rns.PER
    n_rows = 10 * slot
    tab = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [pack_words(c, *residues_of_bytes(c, raw(n_rows, 0x7E))).T
         for _ in range(3)], axis=1))).to(dev)
    win = 17 * ed25519_rns.PER
    slots = np.concatenate([np.zeros(n // 2, np.int64),
                            rng.integers(1, 10, n - n // 2)])
    rows = torch.from_numpy((slots * slot + win + rng.integers(
        0, ed25519_rns.PER, n)).astype(np.int32)).to(dev)
    out_k = cuda_edw.edw_window(c, *state, tab, rows)
    out_p = cuda_edw.edw_window_ref(c, *state, tab, rows)
    torch.cuda.synchronize()
    err = ndiff = split = 0
    for kk, pp in zip(out_k, out_p):
        e, d, sp = max_err(c, [t.cpu().numpy() for t in kk],
                           [t.cpu().numpy() for t in pp])
        err, ndiff, split = max(err, e), ndiff + d, split + sp
    assert err == 0 and split == 0, \
        f"edw disagrees by {err} on {ndiff} lane planes ({split} split)"
    ms_k = cuda_ms(lambda: cuda_edw.edw_window(c, *state, tab, rows), 20)
    ms_p = cuda_ms(lambda: cuda_edw.edw_window_ref(c, *state, tab, rows), 5)
    # 4 state pairs in and 4 out, one packed table row and its index
    nbytes = n * (8 * (ia + ib) * 4 + 3 * iap * 4 + 4)
    b_ms, b_by, pipe = rns_bound(nbytes, edw_work(ia, ib), n)
    log(f"kernel edw: {n} lanes, one window over a {n_rows}-row table, "
        f"{ndiff} lane planes not bit-equal in A or B, max value err {err} "
        f"over both planes of X, Y, Z, T; kernel {ms_k:.4f} ms, plain "
        f"{ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {pipe})")
    records["edw"] = dict(max_abs_err=err, ms=ms_k, by="events",
                          plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)
    keccak_phase(records, rng)
    ntt_phase(records, rng)


def ladder_bound(c, n: int, w: int):
    """(bound ms, by) of the whole ladder on ``n`` lanes of ``w``
    windows: W × madd's work; each lane reads a table row and a digit a
    window and its base, and writes X, Y, Z, inf and deg."""
    ia, ib = c.A.count, c.B.count
    iap = max(ia, ib)
    nbytes = n * (w * (2 * iap + 1) * 4 + 4 + 3 * (ia + ib) * 4 + 2)
    return rns_bound(nbytes, work((w, madd_work(ia, ib))), n)[:2]


def ladder_compare(c, out_k, out_p, what: str):
    """X, Y, Z equal by value on both planes, inf equal, deg equal on
    every lane whose planes are bit-equal. Returns (max err, lane
    planes not bit-equal, deg flags that differ)."""
    import numpy as np

    err = ndiff = split = 0
    same = None
    for kk, pp in zip(out_k[:3], out_p[:3]):
        ka, kb = (t.cpu().numpy() for t in kk)
        pa, pb = (t.cpu().numpy() for t in pp)
        e, d, sp = max_err(c, (ka, kb), (pa, pb))
        err, ndiff, split = max(err, e), ndiff + d, split + sp
        eq = ~((ka != pa).any(axis=0) | (kb != pb).any(axis=0))
        same = eq if same is None else same & eq
    assert err == 0 and split == 0, \
        f"{what}: disagrees by {err} on {ndiff} lane planes ({split} split)"
    inf_k, inf_p = out_k[3].cpu().numpy(), out_p[3].cpu().numpy()
    assert np.array_equal(inf_k, inf_p), f"{what}: inf differs"
    deg_k, deg_p = out_k[4].cpu().numpy(), out_p[4].cpu().numpy()
    assert np.array_equal(deg_k[same], deg_p[same]), f"{what}: deg differs"
    assert not deg_k[inf_k].any(), f"{what}: deg on a lane at infinity"
    return err, ndiff, int((deg_k != deg_p).sum())


def ladder_phase(records):
    """The whole-ladder kernel at the ES cells' shapes: 65,536 lanes
    (one 32,768-token chunk, both chains) over a table of G and 8 keys,
    32 windows on P-256, 48 on P-384 and 66 on P-521; held against its
    plain version (and the per-window path on the same inputs) on every
    lane;
    kernel, plain and per-window times by CUDA events, against the
    bound and against W × the madd kernel's time of this run."""
    import numpy as np
    import torch

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.gpu import cuda_ladder, ec_rns

    rng = np.random.default_rng(SEED + 6)
    n = KERNEL_LANES
    shapes = []
    madd_at = {sh["curve"]: sh["ms"] for sh in records["madd"]["shapes"]}
    madd_at["P-256"] = records["madd"]["ms"]
    for crv in ("P-256", "P-384", "P-521"):
        madd_ms = madd_at[crv]
        c = ec_rns.ctx_for(crv)
        w = c.n_windows
        # a table of G and 8 keys; lanes 0..15 at infinity, every 97th
        # lane of the first 255·97 a planted same-x degeneracy
        tab, d, base, stride, true_deg = tt.ladder_inputs(c, w, n, 8, rng)
        T = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
        args = (T(tab), T(d), T(base), stride)

        def per_window():
            return ec_rns.ladder_per_window(c, *args)

        out_k = cuda_ladder.ladder(c, *args)
        out_p = cuda_ladder.ladder_ref(c, *args)
        out_w = per_window()
        torch.cuda.synchronize()
        err, ndiff, deg_only = ladder_compare(c, out_k, out_p,
                                              f"ladder {crv}")
        ladder_compare(c, out_k, out_w, f"ladder {crv} per-window")
        deg_k = out_k[4].cpu().numpy()
        assert deg_k[true_deg].all(), f"ladder {crv}: deg missed"
        ms_k = cuda_ms(lambda: cuda_ladder.ladder(c, *args), 3)
        ms_w = cuda_ms(per_window, 3)
        ms_p = cuda_ms(lambda: cuda_ladder.ladder_ref(c, *args), 1)
        b_ms, b_by = ladder_bound(c, n, w)
        log(f"kernel ladder {crv}: {n} lanes, {w} windows, {ndiff} lane "
            f"planes not bit-equal, max value err {err}, inf equal, "
            f"{int(true_deg.sum())} true degeneracies flagged, {deg_only} "
            f"probe flags differ; kernel {ms_k:.4f} ms, per-window path "
            f"(gathers + {w} madd) {ms_w:.4f} ms, {w} x madd "
            f"{w * madd_ms:.4f} ms (ladder/that {ms_k / (w * madd_ms):.3f}),"
            f" plain {ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        shapes.append(dict(curve=crv, windows=w, lanes=n, max_abs_err=err,
                           ms=ms_k, by="events", per_window_ms=ms_w,
                           madd_x_windows_ms=w * madd_ms, plain_ms=ms_p,
                           bound_ms=b_ms, bound_by=b_by))
    # the top-level numbers: P-256's, the north-star's curve
    main = shapes[0]
    records["ladder"] = dict(
        {k: main[k] for k in ("ms", "by", "plain_ms", "bound_ms",
                              "bound_by")},
        max_abs_err=max(sh["max_abs_err"] for sh in shapes), shapes=shapes)


def word_diff(kernel, plain):
    """(max |kernel − plain| over the words as unsigned 32-bit values,
    rows [leading axis] with any word differing)."""
    import torch

    d = ((kernel.to(torch.int64) & 0xFFFFFFFF)
         - (plain.to(torch.int64) & 0xFFFFFFFF)).abs()
    rows = int(d.reshape(d.shape[0], -1).any(dim=1).sum())
    return int(d.max()), rows


def keccak_phase(records, rng):
    """The Keccak permutation at 65,536 states of random words (the
    first all zero, the second all ones)."""
    import numpy as np
    import torch

    from cap_tpu_torch.gpu import cuda_keccak, keccak

    n = KERNEL_LANES
    words = rng.integers(0, 2 ** 32, (n, 25, 2), dtype=np.uint64)
    words[0], words[1] = 0, 2 ** 32 - 1
    s = torch.from_numpy(words.astype(np.uint32).view(np.int32)).cuda()
    got = cuda_keccak.f1600(s)
    want = keccak.f1600_plain(s)
    torch.cuda.synchronize()
    err, ndiff = word_diff(got, want)
    # the plain version against the numpy uint64 reference on a sample
    ref = keccak.interleave(keccak.f1600_ref(keccak.deinterleave(
        words[:256].astype(np.uint32))))
    assert np.array_equal(got[:256].cpu().numpy().view(np.uint32), ref), \
        "keccak against f1600_ref"
    assert err == 0 and ndiff == 0, \
        f"keccak disagrees on {ndiff} states (max word diff {err})"
    ms_k = cuda_ms(lambda: cuda_keccak.f1600(s), 50)
    ms_p = cuda_ms(lambda: keccak.f1600_plain(s), 3)
    b_ms, b_by = mldsa_bound("keccak", n)
    log(f"kernel keccak: {n} states, {ndiff} states not bit-equal, max "
        f"word diff {err}; kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    records["keccak"] = dict(max_abs_err=err, ms=ms_k, by="events",
                             plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)


def ntt_phase(records, rng):
    """The forward and inverse NTT at 65,536 rows of canonical values,
    a row of zeros, a row of q − 1 and an alternating row among them."""
    import numpy as np
    import torch

    from cap_tpu_torch.gpu import cuda_ntt, ntt

    q = ntt.Q
    n = KERNEL_LANES
    x = rng.integers(0, q, (n, 256), dtype=np.int64)
    x[0], x[1], x[2] = 0, q - 1, np.arange(256) % 2 * (q - 1)
    t = torch.from_numpy(x.astype(np.int32)).cuda()
    for name, kern, plain, ref in (
            ("ntt", cuda_ntt.ntt, ntt.ntt_plain, ntt.ntt_ref),
            ("intt", cuda_ntt.intt, ntt.intt_plain, ntt.intt_ref)):
        got = kern(t)
        want = plain(t)
        torch.cuda.synchronize()
        err, ndiff = word_diff(got, want)
        assert np.array_equal(got[:64].cpu().numpy(), ref(x[:64])), \
            f"{name} against {ref.__name__}"
        assert err == 0 and ndiff == 0, \
            f"{name} disagrees on {ndiff} rows (max diff {err})"
        ms_k = cuda_ms(lambda: kern(t), 50)
        ms_p = cuda_ms(lambda: plain(t), 3)
        b_ms, b_by = mldsa_bound(name, n)
        log(f"kernel {name}: {n} rows, {ndiff} rows not equal, max diff "
            f"{err}; kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        records[name] = dict(max_abs_err=err, ms=ms_k, by="events",
                             plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)


def hook_wrapper_calls(ks, tokens, names, check):
    """One batch through ``ks.verify_batch`` with the kernel wrappers
    ``names`` (of keccak, ntt, intt) hooked: ``check(name, input,
    output)`` runs on every call as the path makes it, before the path
    goes on (so no call's tensors need be kept)."""
    from cap_tpu_torch.gpu import cuda_keccak, cuda_ntt

    hooks = {"keccak": (cuda_keccak, "f1600"), "ntt": (cuda_ntt, "ntt"),
             "intt": (cuda_ntt, "intt")}
    hooks = {k: hooks[k] for k in names}
    wrappers = {k: getattr(mod, attr) for k, (mod, attr) in hooks.items()}

    def hooked(name):
        def call(x):
            out = wrappers[name](x)
            check(name, x, out)
            return out
        return call

    try:
        for k, (mod, attr) in hooks.items():
            setattr(mod, attr, hooked(k))
        ks.verify_batch(tokens)
    finally:
        for k, (mod, attr) in hooks.items():
            setattr(mod, attr, wrappers[k])


def path_shape_phase(records, ks, tokens, path,
                     names=("keccak", "ntt", "intt")):
    """The kernels ``names`` at the shapes the path gives them: every
    input one batch handed their wrappers, the path's kernel output held
    against the plain version on it (every state or row equal), then, on
    the first input of each shape, the kernel's device time a launch
    (profiler), and one wrapper call and one plain call (CUDA events)."""
    import torch

    from cap_tpu_torch.gpu import cuda_keccak, cuda_ntt, keccak, ntt

    fns = {"keccak": (cuda_keccak.f1600, keccak.f1600_plain, 50, "states"),
           "ntt": (cuda_ntt.ntt, ntt.ntt_plain, 256, "rows"),
           "intt": (cuda_ntt.intt, ntt.intt_plain, 256, "rows")}
    kernel_keys = {"keccak": "keccak_kernel", "ntt": "ntt_fwd_kernel",
                   "intt": "intt_kernel"}
    shapes = {}

    def check(name, x, out):
        width, unit = fns[name][2:]
        n = x.numel() // width
        err, ndiff = word_diff(out.reshape(n, width),
                               fns[name][1](x).reshape(n, width))
        assert err == 0 and ndiff == 0, \
            f"{name} at {list(x.shape)} disagrees on {ndiff} {unit}"
        first = shapes.setdefault((name, tuple(x.shape)), [x.clone(), 0])
        first[1] += 1

    hook_wrapper_calls(ks, tokens, names, check)
    assert {k for k, _ in shapes} == set(names), sorted(shapes)
    for (name, shape), (x, calls) in sorted(shapes.items(),
                                            key=lambda kv: kv[0]):
        kern, plain, width, unit = fns[name]
        n = x.numel() // width
        ms_k, by = kernel_ms(lambda: kern(x), 50, kernel_keys[name])
        ms_call = cuda_ms(lambda: kern(x), 50)
        ms_p = cuda_ms(lambda: plain(x), 3)
        torch.cuda.synchronize()
        b_ms, b_by = mldsa_bound(name, n)
        log(f"kernel {name} at the {path} path's shape {list(shape)}: {n} "
            f"{unit}, {calls} call(s) in one batch, every one equal to the "
            f"plain version; kernel {ms_k:.4f} ms (by {by}; one wrapper "
            f"call {ms_call:.4f} ms), plain {ms_p:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        records[name].setdefault("path_shapes", []).append(dict(
            path=path, shape=list(shape), calls=calls, max_abs_err=0,
            ms=ms_k, by=by, call_ms=ms_call, plain_ms=ms_p, bound_ms=b_ms,
            bound_by=b_by))


# -- main path --------------------------------------------------------------

def b64(b: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def unb64(s: str) -> bytes:
    import base64

    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def with_sig(token: str, sig: bytes) -> str:
    h, p, _ = token.split(".")
    return f"{h}.{p}.{b64(sig)}"


REJECT = ("InvalidSignatureError",
          "no known key successfully validated the token signature")


def tile(rng, uniq, n_tokens=N_TOKENS):
    """n_tokens tokens tiled from the unique ones, a seeded 1/8 share
    with one signature bit flipped: (tokens, expected, tampered)."""
    tampered = []
    for tok in uniq:
        sig = bytearray(unb64(tok.split(".")[2]))
        sig[rng.randrange(len(sig))] ^= 1 << rng.randrange(8)
        tampered.append(with_sig(tok, bytes(sig)))
    subs = [json.loads(unb64(t.split(".")[1]))["sub"] for t in uniq]
    tokens, expected = [], []
    for i in range(n_tokens):
        u = i % len(uniq)
        if rng.random() < 0.125:
            tokens.append(tampered[u])
            expected.append(REJECT)
        else:
            tokens.append(uniq[u])
            expected.append(subs[u])
    return tokens, expected, tampered


def build_batch(rng):
    """(jwks, unique tokens, tampered tokens, tokens, expected, signers)
    for the north-star batch. expected[i] is the sub claim of an
    accepted token, or the exception class name with its message;
    signers [(private key, alg, kid)] as ``testing.headline_fixtures``
    gives them."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.gpu.ec import curve
    from cap_tpu_torch.jwt import algs

    t0 = time.perf_counter()
    jwks, uniq, signers = tt.headline_fixtures(N_UNIQUE, seed=SEED)
    log(f"fixtures: 8 RSA-2048 + 8 P-256 keys, {N_UNIQUE} signed tokens "
        f"in {time.perf_counter() - t0:.1f} s")
    tokens, expected, tampered = tile(rng, uniq)

    n_p256 = curve("P-256").n
    outsider = tt.generate_ec_key(rng)
    claims = tt.default_claims(sub="special")
    es_tok = next(t for t, s in zip(uniq, signers * N_UNIQUE)
                  if s[1] == algs.ES256)
    es_sig = unb64(es_tok.split(".")[2])
    rs_tok = uniq[0]
    specials = [
        (tt.sign_jwt(outsider, algs.ES256, claims, kid="nobody", rng=rng),
         REJECT),
        (b64(b'{"alg":"none"}') + "." + b64(b'{"sub":"x"}') + ".",
         ("TokenNotSignedError", "token must be signed")),
        (with_sig(es_tok, b"\0" * 32 + es_sig[32:]), REJECT),
        (with_sig(es_tok, es_sig[:32] + n_p256.to_bytes(32, "big")),
         REJECT),
        (with_sig(es_tok, es_sig[:-1]), REJECT),
        (with_sig(rs_tok, unb64(rs_tok.split(".")[2])[:-1]), REJECT),
        ("a.b", ("MalformedTokenError",
                 "compact JWS must have 3 segments")),
        ("!!!." + rs_tok.split(".", 1)[1],
         ("MalformedTokenError", "invalid base64url segment")),
    ]
    stride = N_TOKENS // (3 * len(specials) + 1)
    for k, (tok, exp) in enumerate(specials):
        for rep in range(3):
            pos = (k * 3 + rep) * stride + 17
            tokens[pos] = tok
            expected[pos] = exp
    return jwks, uniq, tampered, tokens, expected, signers


def oracle_check(jwks, uniq, tampered):
    """Unique tokens accept and a sample of tampered ones reject on the
    pure-integer oracle (``jwt.verify.verify_parsed``: pow for RS256 and
    PS256, py_ecdsa_verify for ES256, py_ed25519_verify for EdDSA)."""
    from cap_tpu_torch.errors import InvalidSignatureError
    from cap_tpu_torch.jwt.jose import parse_jws
    from cap_tpu_torch.jwt.verify import verify_parsed

    by_kid = {j.kid: j.key for j in jwks}
    t0 = time.perf_counter()
    for tok in uniq:
        p = parse_jws(tok)
        verify_parsed(p, by_kid[p.kid])
    for tok in tampered[:128]:
        p = parse_jws(tok)
        try:
            verify_parsed(p, by_kid[p.kid])
        except InvalidSignatureError:
            continue
        raise AssertionError("oracle accepted a tampered token")
    log(f"oracle: {len(uniq)} unique tokens accept, 128 tampered reject "
        f"({time.perf_counter() - t0:.1f} s)")


# Each cell's fixtures: (builder, seed offset, unique tokens held on the
# oracle, None for all). Signing is pure Python (minutes in all), so
# main() builds them in worker processes while the card runs the kernel
# phases, and waits for them all before the first phase that times the
# host (wait_fixtures); each path takes its own with cell_fixtures().
FIXTURE_JOBS = {
    "north-star": ("build_batch", 0, None),
    "config-3": ("build_config3", 5, 256),
    "config-4": ("build_config4", 4, None),
    "pq-mldsa": ("build_mldsa", 3, None),
    "ps-sha512": ("build_ps512", 6, None),
    "pq-slhdsa": ("build_slhdsa", 7, None),
    "config-2": ("build_config2", 8, None),
    "rsa-limb": ("build_rsalimb", 9, None),
    "big-jwks": ("build_bigjwks", 11, None),
}
_FIXTURES = {}
# the w12 phase's 12-bit window tables, built by the fixture jobs of
# their cells: (kid prefix, curve) a key set
W12_SETS = {"north-star": (("es-", "P-256"),),
            "config-3": (("es-", "P-256"), ("es384-", "P-384"))}
_W12_TABLES = {}


def fixture_job(name, w12: bool = False):
    """One cell's fixtures, their unique tokens held on the pure-integer
    oracle (the first 256 on config-3: a P-384 verify takes ~0.1 s) and
    a sample of the tampered ones rejected, and (``w12``) the 12-bit
    window tables of the cell's ``W12_SETS`` key sets, G included:
    (fixtures, log lines, {kid prefix: (host table, seconds)}). Runs in
    a worker process (or inline)."""
    global log
    from cap_tpu_torch.gpu import ec_rns

    lines, saved = [], log
    log = lambda *a: lines.append(" ".join(str(x) for x in a))  # noqa: E731
    tables = {}
    try:
        builder, off, n_oracle = FIXTURE_JOBS[name]
        out = globals()[builder](random.Random(SEED + off))
        jwks, uniq, tampered = out[:3]
        oracle_check(jwks, uniq[:n_oracle], tampered)
        for prefix, crv in W12_SETS.get(name, ()) if w12 else ():
            t0 = time.perf_counter()
            pubs = [j.key for j in jwks if j.kid and j.kid.startswith(prefix)]
            tab = ec_rns.ECRNSKeyTable(crv, pubs, w_bits=12).tab
            tables[prefix] = (tab, time.perf_counter() - t0)
    finally:
        log = saved
    return out, lines, tables


def start_fixtures(pool):
    """Submit every cell's fixture job to ``pool``, the 12-bit tables
    with them."""
    for name in FIXTURE_JOBS:
        _FIXTURES[name] = pool.submit(fixture_job, name, True)


def wait_fixtures():
    """Wait for every fixture job, so that no phase after this one runs
    beside the workers' signing: the phases before it (kernels, wide
    kernels, ladder) time the card alone, by CUDA events and the
    profiler."""
    from concurrent.futures import wait

    t0 = time.perf_counter()
    wait(list(_FIXTURES.values()))
    log(f"fixtures: every cell's fixture job done, {len(_FIXTURES)} "
        f"jobs in worker processes during the kernel phases; waited "
        f"{time.perf_counter() - t0:.1f} s for the last")


def cell_fixtures(name):
    """A cell's fixtures from its job (built inline where none was
    started), the job's log lines printed here and its 12-bit tables
    kept for the w12 phase."""
    fut = _FIXTURES.pop(name, None)
    out, lines, tables = (fut.result() if fut is not None
                          else fixture_job(name))
    for line in lines:
        log(line)
    _W12_TABLES[name] = tables
    return out


def check_verdicts(results, expected):
    bad = []
    for i, (got, exp) in enumerate(zip(results, expected)):
        if isinstance(exp, tuple):
            ok = (type(got).__name__ == exp[0]
                  and str(got) == exp[1])
        else:
            ok = isinstance(got, dict) and got.get("sub") == exp
        if not ok:
            bad.append((i, exp, got))
    assert not bad, f"{len(bad)} wrong verdicts, first: {bad[:3]}"


def counters():
    """Kernel name → (module, attribute) of its launch counter."""
    from cap_tpu_torch.gpu import (
        cuda_edw,
        cuda_keccak,
        cuda_ladder,
        cuda_madd,
        cuda_ntt,
        cuda_redc,
    )

    return {"redc": (cuda_redc, "launches"), "madd": (cuda_madd, "launches"),
            "ladder": (cuda_ladder, "launches"),
            "edw": (cuda_edw, "launches"),
            "keccak": (cuda_keccak, "launches"),
            "ntt": (cuda_ntt, "ntt_launches"),
            "intt": (cuda_ntt, "intt_launches")}


def family_idx(pb, alg: str):
    """Indices of the tokens of a PreparedBatch that parsed with
    ``alg`` (an interned classical alg, or an ML-DSA set by its raw
    bytes), as the keyset buckets them."""
    import numpy as np

    from cap_tpu_torch.jwt.gpu_keyset import _mldsa_alg_indices
    from cap_tpu_torch.runtime.native_binding import ALG_NAMES

    ok = pb.status == 0
    if alg in ALG_NAMES:
        return np.nonzero(ok & (pb.alg_id == ALG_NAMES.index(alg)))[0]
    return _mldsa_alg_indices(pb, ok, alg)


def prep_phase(name, ks, tokens, engines):
    """The card host's native prep of a path's whole batch against the
    port's strict parser (``jwt.jose.parse_jws``) and ``hashlib``: the
    status class, alg, kid, signature, payload and digest of every
    token. Then one chunk's records of each packed family, per RSA
    class (RS, PS, ES: the native packer against the numpy builders
    ``rs_packed_records``/``es_packed_records`` on parse_jws's bytes
    and hashlib's digests; a class of more than 255 keys: its arrays,
    ``GPUBatchKeySet._arrays``, against the same inputs; EdDSA: k
    against hashlib's SHA-512 mod L). ML-DSA has no record packer (its
    host decode is ``_FusedPrep``)."""
    import hashlib

    import numpy as np

    from cap_tpu_torch.gpu import ec as gpuec
    from cap_tpu_torch.gpu import ed25519 as gpued
    from cap_tpu_torch.gpu import rsa as gpursa
    from cap_tpu_torch.jwt import algs, gpu_keyset
    from cap_tpu_torch.jwt.jose import parse_jws
    from cap_tpu_torch.runtime.native_binding import (
        ALG_NAMES,
        prepare_batch_arrays,
    )

    t0 = time.perf_counter()
    pb = prepare_batch_arrays(tokens)
    parsed = []
    bad = []
    for i, tok in enumerate(tokens):
        try:
            p = parse_jws(tok)
        except Exception as e:  # noqa: BLE001 - compared below
            parsed.append(None)
            if pb.status[i] == 0 or \
                    type(pb.error(i)).__name__ != type(e).__name__:
                bad.append((i, "status", type(e).__name__))
            continue
        parsed.append(p)
        if pb.status[i] != 0:
            bad.append((i, "status", str(pb.error(i))))
            continue
        # the native prep hashes by the ten interned algs' family
        digest = (hashlib.new(algs.HASH_FOR_ALG[p.alg],
                              p.signing_input).digest()
                  if p.alg in ALG_NAMES and p.alg != algs.EdDSA else b"")
        got = (pb.alg(i), pb.kid(i), pb.signature(i), pb.payload_bytes(i),
               pb.signing_input(i), pb.parsed(i).digest())
        want = (p.alg, p.kid, p.signature, p.payload, p.signing_input,
                digest)
        if got != want:
            bad.append((i, "fields", p.alg))
    assert not bad, f"{name}: native prep differs on {len(bad)} tokens, " \
        f"first {bad[:3]}"
    n_ok = int((pb.status == 0).sum())
    log(f"prep {name}: {len(tokens)} tokens, native prep equal to "
        f"parse_jws + hashlib on every one ({n_ok} parsed, "
        f"{len(tokens) - n_ok} rejected with the same class) in "
        f"{time.perf_counter() - t0:.1f} s")

    def chunk_of(idx, rows, rec_width):
        keep = rows >= 0
        n = ks._chunk_tokens(rec_width)
        idx, rows = idx[keep][:n], rows[keep][:n]
        return idx, rows, gpu_keyset._pad_size(len(idx), n)

    def numpy_inputs(idx, rows, width, hash_name, pad):
        m = len(idx)
        sig_mat = np.zeros((pad, width), np.uint8)
        sig_lens = np.zeros(pad, np.int64)
        hash_mat = np.zeros((pad, 64), np.uint8)
        key_idx = np.zeros(pad, np.int64)
        for r, j in enumerate(idx.tolist()):
            sig = parsed[j].signature
            sig_mat[r, :min(len(sig), width)] = np.frombuffer(
                sig[:width], np.uint8)
            sig_lens[r] = len(sig)
            dig = hashlib.new(hash_name, parsed[j].signing_input).digest()
            hash_mat[r, :len(dig)] = np.frombuffer(dig, np.uint8)
        key_idx[:m] = rows
        return sig_mat, sig_lens, hash_mat, key_idx

    def as_rows(arrays):
        # (sig_mat, sig_lens, hash_mat, key_idx) as one row a token
        return np.concatenate([np.asarray(a).reshape(len(a), -1)
                               .astype(np.int64) for a in arrays], axis=1)

    checks = []
    for alg in engines:
        idx = family_idx(pb, alg)
        if alg[:2] in ("RS", "PS"):
            kind = alg[:2].lower()
            hash_name = algs.HASH_FOR_ALG[alg]
            h_len = gpursa.HASH_LEN[hash_name]
            rows = ks._rows(idx, pb, ks._kid_rsa_row, ks._n_rsa_keys)
            stride = gpu_keyset._RSA_CLS_STRIDE
            for cls, table in enumerate(ks._rsa_tables):
                crows = np.where((rows >= 0) & (rows // stride == cls),
                                 rows % stride, -1)
                cidx, crows, pad = chunk_of(idx, crows,
                                            2 * table.k + h_len + 2)
                if not len(cidx):
                    continue
                want = numpy_inputs(cidx, crows, 2 * table.k, hash_name, pad)
                if len(table.n_ints) > gpu_keyset._MAX_CLASS_KEYS:
                    got = as_rows(ks._arrays(pb, cidx, crows, 2 * table.k,
                                             pad))
                    want = as_rows(want)
                else:
                    got = gpu_keyset.rsa_records(pb, table, kind, hash_name,
                                                 cidx, crows, pad)
                    want = gpursa.rs_packed_records(table, *want[:3],
                                                    hash_name, want[3], kind)
                checks.append((f"{alg} class {cls}", cidx, pad, got, want))
        elif alg in ("ES256", "ES384"):
            crv = gpu_keyset._ES[alg]
            table = ks._ec_tables[crv]
            hash_name = algs.HASH_FOR_ALG[alg]
            h_len = gpursa.HASH_LEN[hash_name]
            width = 2 * table.coord_bytes
            rows = ks._rows(idx, pb, ks._kid_ec_row[crv], len(table.keys))
            cidx, crows, pad = chunk_of(idx, rows, width + h_len + 2)
            want = numpy_inputs(cidx, crows, width, hash_name, pad)
            if len(table.keys) > gpu_keyset._MAX_CLASS_KEYS:
                got = as_rows(ks._arrays(pb, cidx, crows, width, pad))
                want = as_rows(want)
            else:
                got = gpu_keyset.es_records(pb, table, cidx, crows, h_len,
                                            pad)
                want = gpuec.es_packed_records(table, *want[:3], h_len,
                                               want[3])
            checks.append((alg, cidx, pad, got, want))
        elif alg == "EdDSA":
            table = ks._ed_table
            rows = ks._rows(idx, pb, ks._kid_ed_row, len(table.keys))
            idx, rows, pad = chunk_of(idx, rows, 64 + 32 + 2)
            fill = pad - len(idx)
            key_idx = np.zeros(pad, np.int64)
            key_idx[:len(idx)] = rows
            # the k column of the records both paths build
            got = gpued._ed_records(
                table, [pb.signature(j) for j in idx.tolist()] + [b""] * fill,
                [pb.signing_input(j) for j in idx.tolist()] + [b""] * fill,
                key_idx, 97)
            want = got.copy()
            want[:, 64:96] = 0
            for r, j in enumerate(idx.tolist()):
                sig = parsed[j].signature
                if len(sig) != 64:
                    continue
                h = hashlib.sha512(sig[:32] + table.key_bytes[rows[r]]
                                   + parsed[j].signing_input).digest()
                k = int.from_bytes(h, "little") % gpued.L_ORDER
                want[r, 64:96] = np.frombuffer(k.to_bytes(32, "little"),
                                               np.uint8)
            checks.append((alg, idx, pad, got, want))
    for label, idx, pad, got, want in checks:
        ndiff = int((got != want).any(axis=1).sum())
        assert got.shape == want.shape and ndiff == 0, \
            f"{name} {label}: {ndiff} record rows differ from the numpy " \
            f"builder"
        log(f"prep {name} {label}: one chunk's records ({len(idx)} tokens, "
            f"{pad} rows of {got.shape[1]} columns) equal to the numpy "
            f"builder")


# warm batches a path; the paths whose batch takes more than 2 s
# (config-4, pq-mldsa, ps-sha512, pq-slhdsa, rsa-limb, oidc) run two,
# to keep the whole run within its time budget on a slow host
WARM = 3
WARM_SLOW = 2


def family_launches(jwks, tokens, families):
    """(launches, chunks, family summary) of one batch: ``families``
    [(alg, kid prefix, chunk tokens, {kernel: launches per chunk})]
    name the tokens of the kernels' packed path and what each of their
    chunks launches."""
    from cap_tpu_torch.runtime.native_binding import prepare_batch_arrays

    pb = prepare_batch_arrays(tokens)
    want, n_chunks, fams = {}, 0, []
    for alg, prefix, chunk, per_chunk in families:
        kids = {j.kid: 0 for j in jwks if j.kid and j.kid.startswith(prefix)}
        idx = family_idx(pb, alg)
        n_fam = int((pb.kid_rows(idx, kids) >= 0).sum())
        chunks = (n_fam + chunk - 1) // chunk
        n_chunks += chunks
        for k, per in per_chunk.items():
            want[k] = want.get(k, 0) + per * chunks
        fams.append(f"{n_fam} {alg}")
    return want, n_chunks, fams


@contextlib.contextmanager
def counted_launches(records, name, want):
    """Every launch counter zeroed as the block starts and read as it
    ends: every kernel launched exactly ``want[k]`` times (0 for a
    kernel ``want`` does not name; a kernel it names launched), the
    counts added to ``records`` under the path ``name``. Yields the
    dict the counts land in."""
    ctr = counters()
    for mod, attr in ctr.values():
        setattr(mod, attr, 0)
    launches = {}
    yield launches
    launches.update({k: getattr(mod, attr) for k, (mod, attr) in ctr.items()})
    for k, count in launches.items():
        assert count == want.get(k, 0) and (k not in want or want[k] > 0), \
            (name, launches, want)
        rec = records[k]
        rec["launches"] = rec.get("launches", 0) + count
        rec.setdefault("launches_by_path", {})[name] = count


def drive_path(records, name, jwks, tokens, expected, families, engines,
               warm=WARM, **ks_opts):
    """One path through ``GPUBatchKeySet(jwks, **ks_opts).verify_batch``:
    every launch counter zeroed just before the first run and read just
    after it, every verdict checked, then ``warm`` warm runs, the
    engines' lines and the profile. ``families`` [(alg, kid prefix, chunk
    tokens, {kernel: launches per chunk})] name the tokens of the
    kernels' packed path and what each of their chunks launches; every
    other kernel must not launch. Returns the keyset, the first run's
    verdicts, the best verifies/s and the profiled device ms."""
    import torch

    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet

    ks = GPUBatchKeySet(jwks, **ks_opts)
    prep_phase(name, ks, tokens, engines)
    want, n_chunks, fams = family_launches(jwks, tokens, families)
    with counted_launches(records, name, want) as launches:
        t0 = time.perf_counter()
        results = ks.verify_batch(tokens)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        check_verdicts(results, expected)
    on_path = (f"{', '.join(fams)} on the kernels' path, {n_chunks} "
               f"chunk(s)") if fams else "no kernel on the path"
    log(f"{name} path: {len(tokens)} tokens ({on_path}), every verdict "
        f"as expected; "
        f"launches {launches}; flagged lanes re-verified on the "
        f"oracle: {ks.deg_reverified}; first run {first_s:.2f} s")

    times = []
    for _ in range(warm):
        t0 = time.perf_counter()
        again = ks.verify_batch(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check_verdicts(again, expected)
    best = min(times)
    vps = len(tokens) / best
    log(f"{name} path warm: {len(tokens)} tokens in "
        f"{', '.join(f'{t:.3f}' for t in times)} s; best "
        f"{vps:.0f} verifies/s")
    batch_breakdown(ks, tokens)
    engine_times(ks, tokens, engines)
    device_ms = profile_batch(ks, tokens, best)
    return dict(ks=ks, results=results, vps=vps, device_ms=device_ms)


# what one ES chunk launches, on every curve: the whole-ladder kernel
# once, then redc 11 times (the merge and the projective check)
ES_LAUNCHES = {"ladder": 1, "redc": 11}


def es256_want(n_es: int, ctr):
    """(chunks, launches) of one batch whose n_es ES256 tokens take the
    kernels' path: chunks of 32,768 tokens, 1 ladder + 11 redc each."""
    chunks = (n_es + 32767) // 32768
    return chunks, {k: ES_LAUNCHES.get(k, 0) * chunks for k in ctr}


def main_path(records):
    """The north-star path; returns its fixtures for the validator path."""
    jwks, uniq, tampered, tokens, expected, signers = cell_fixtures(
        "north-star")
    drive_path(records, "north-star", jwks, tokens, expected,
               [("ES256", "es-", 32768, ES_LAUNCHES)],
               ("RS256", "ES256"))
    return dict(jwks=jwks, tokens=tokens, expected=expected, uniq=uniq,
                signers=signers)


# the validator path's clock: the fixtures' iat/nbf plus a minute
VALIDATOR_NOW = 1_700_000_060
CLAIMS_CLASSES = {
    "expired": (dict(exp=1_699_990_000), (
        "ExpiredTokenError",
        "invalid expiration time (exp) claim: token is expired")),
    "not yet valid": (dict(nbf=1_700_007_200), (
        "InvalidNotBeforeError",
        "invalid not before (nbf) claim: token not yet valid")),
    "issued in the future": (dict(iat=1_700_007_200, nbf=1_700_000_000), (
        "InvalidIssuedAtError",
        "invalid issued at (iat) claim: token issued in the future")),
    "no iat, exp or nbf": (dict(iat=None, nbf=None, exp=None), (
        "MissingClaimError",
        "no issued at (iat), not before (nbf), or expiration time (exp) "
        "claims in token")),
    "wrong iss": (dict(iss="https://evil.example/"), (
        "InvalidIssuerError", "invalid issuer (iss) claim")),
    "wrong aud": (dict(aud=["someone-else"]), (
        "InvalidAudienceError",
        "audience claim does not match any expected audience")),
    "aud not a string": (dict(aud=[7]), (
        "MalformedTokenError",
        "claim 'aud' is not a string or string array")),
}


def _verdict(v):
    """A verdict as comparable data: the claims dict, or (class, text)."""
    return v if isinstance(v, dict) else (type(v).__name__, str(v))


_CHECKERS = None


def _checkers_init(repo, issuer, pems, expected):
    """Worker set-up for the unique-token cross-check: the single-token
    Validators over a JSONWebKeySet loaded by discovery and over a
    StaticKeySet of the PEMs; ``expected`` the Expected fields, with
    ``now`` a number."""
    global _CHECKERS
    sys.path.insert(0, repo)
    from cap_tpu_torch.jwt import (
        Expected,
        StaticKeySet,
        Validator,
        new_oidc_discovery_keyset,
        parse_public_key_pem,
    )

    now = expected["now"]
    _CHECKERS = (Validator(new_oidc_discovery_keyset(issuer)),
                 Validator(StaticKeySet([parse_public_key_pem(p)
                                         for p in pems])),
                 Expected(**dict(expected, now=lambda: now)))


def _check_tokens(tokens):
    """[(JSONWebKeySet verdict, StaticKeySet verdict)] of tokens."""
    jv, sv, expected = _CHECKERS
    out = []
    for tok in tokens:
        pair = []
        for v in (jv, sv):
            try:
                pair.append(_verdict(v.validate(tok, expected)))
            except Exception as e:  # noqa: BLE001 - compared by the caller
                pair.append(_verdict(e))
        out.append(tuple(pair))
    return out


class _FixedKeySet:
    """A keyset whose batch verdicts are given: times the claims loop of
    ``Validator.validate_batch`` alone."""

    def __init__(self, results):
        self.results = results

    def verify_batch(self, tokens):
        return self.results


def validator_path(records, north):
    """``Validator.validate_batch`` over ``GPUBatchKeySet`` on the card,
    its keys served as x5c JWKs behind a loopback discovery document.

    The north-star's 16 keys (4 RSA and 4 P-256 of them x5c-only JWKs,
    one with both its parameters and its chain) load through
    ``new_oidc_discovery_keyset(issuer).keys()`` and must equal the
    originals; the north-star's 65,536 tokens, with a few hundred more
    signed by its keys tiled in (every claims rejection class), go
    through ``validate_batch`` and every verdict is checked, then a
    4,096-token slice with only RS256 allowed. Each unique token's
    verdict is held against the single-token Validators over the
    JSONWebKeySet and over a StaticKeySet of SPKI and PKCS#1 PEMs (in
    one spawned process a host core). validate_batch must launch exactly
    what verify_batch launches."""
    import multiprocessing

    import torch

    from cap_tpu_torch import errors
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt import (
        Expected,
        GPUBatchKeySet,
        Validator,
        new_oidc_discovery_keyset,
    )
    from cap_tpu_torch.jwt.jose import peek_alg
    from cap_tpu_torch.jwt.jwk import RSAPublicKey, serialize_public_key
    from cap_tpu_torch.runtime.native_binding import prepare_batch_arrays

    t_phase = time.perf_counter()
    rng = random.Random(SEED + 11)
    jwks = north["jwks"]
    signers = north["signers"]
    priv_of = {kid: priv for priv, _, kid in signers}

    # serve the keys: x5c-only JWKs for rs-0..3 and es-0..3, rs-0 with
    # its parameters too
    doc = []
    for j in jwks:
        x5c = j.kid[3:] in ("0", "1", "2", "3")
        doc.append(tt.x5c_jwk(priv_of[j.kid], kid=j.kid, rng=rng,
                              include_params=j.kid == "rs-0")
                   if x5c else serialize_public_key(j.key, kid=j.kid))
    pems = [tt.pkcs1_pem(j.key) if isinstance(j.key, RSAPublicKey)
            and int(j.kid[3:]) % 2 else tt.spki_pem(j.key) for j in jwks]
    state = {"keys": doc}

    def same_key(a, b):
        if isinstance(a, RSAPublicKey):
            return isinstance(b, RSAPublicKey) and (a.n, a.e) == (b.n, b.e)
        na, nb = a.public_numbers(), b.public_numbers()
        return (a.curve_name, na.x, na.y) == (b.curve_name, nb.x, nb.y)

    # a few hundred tokens per claims class, signed by the north-star keys
    base = tt.default_claims()
    extra, extra_exp = [], []
    for label, (change, verdict) in CLAIMS_CLASSES.items():
        for k, (priv, alg, kid) in enumerate(signers * 2):
            claims = {key: v for key, v in dict(
                base, sub=f"claims-{label}-{k}", **change).items()
                if v is not None}
            extra.append(tt.sign_jwt(priv, alg, claims, kid=kid, rng=rng))
            extra_exp.append(verdict)
    tokens = list(north["tokens"])
    expected = list(north["expected"])
    taken = {i for i, e in enumerate(expected) if isinstance(e, tuple)
             and e != REJECT}
    stride = len(tokens) // len(extra)
    pos = stride // 2
    for tok, exp in zip(extra, extra_exp):
        while pos in taken:
            pos += 1
        tokens[pos], expected[pos] = tok, exp
        pos += stride
    t_fix = time.perf_counter() - t_phase
    fields = dict(issuer="https://example.com/", audiences=["client-id"],
                  signing_algorithms=["RS256", "ES256"], now=VALIDATOR_NOW)
    exp_args = dict(fields, now=lambda: VALIDATOR_NOW)

    with tt.discovery_test_server(state) as (issuer, _srv):
        t0 = time.perf_counter()
        loaded = new_oidc_discovery_keyset(issuer).keys()
        assert [j.kid for j in loaded] == [j.kid for j in jwks]
        assert all(same_key(a.key, b.key) for a, b in zip(loaded, jwks)), \
            "keys loaded through discovery differ from the originals"
        t_load = time.perf_counter() - t0
        log(f"validator: {len(jwks)} keys ({sum('x5c' in d for d in doc)} "
            f"as x5c JWKs, rs-0 with its parameters too) loaded through "
            f"new_oidc_discovery_keyset on loopback, equal to the "
            f"originals ({state['fetches']} fetches, {t_load:.2f} s); "
            f"{len(extra)} claims-class tokens signed and tiled in "
            f"({t_fix:.1f} s)")

        ks = GPUBatchKeySet(loaded)
        validator = Validator(ks)
        ctr = counters()
        pb = prepare_batch_arrays(tokens)
        n_es = int((pb.kid_rows(family_idx(pb, "ES256"),
                                {f"es-{i}": 0 for i in range(8)}) >= 0).sum())
        chunks, want = es256_want(n_es, ctr)
        for mod, attr in ctr.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        results, counted = telemetry_chunks(
            lambda: validator.validate_batch(tokens, Expected(**exp_args)))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {k: getattr(mod, attr) for k, (mod, attr) in ctr.items()}
        check_verdicts(results, expected)
        for mod, attr in ctr.values():
            setattr(mod, attr, 0)
        verified, v_counted = telemetry_chunks(
            lambda: ks.verify_batch(tokens))
        torch.cuda.synchronize()
        verify_launches = {k: getattr(mod, attr)
                           for k, (mod, attr) in ctr.items()}
        assert launches == verify_launches == want, \
            (launches, verify_launches, want)
        assert counted["es"] == v_counted["es"] == chunks, \
            (counted, v_counted, chunks)
        for k, count in launches.items():
            rec = records[k]
            rec["launches"] = rec.get("launches", 0) + count
            rec.setdefault("launches_by_path", {})["validator"] = count
        log(f"validator path: {len(tokens)} tokens through "
            f"Validator(GPUBatchKeySet).validate_batch, every verdict as "
            f"expected (each claims class {2 * len(signers)} times); "
            f"launches {launches}, equal to verify_batch's ({chunks} ES "
            f"chunk(s), as the keyset counted them); first run "
            f"{first_s:.2f} s")

        # RS256 only: every ES256 token that verifies gets
        # UnsupportedAlgError
        sl_tokens, sl_expected = tokens[:4096], []
        for tok, exp, ver in zip(sl_tokens, expected, verified):
            try:
                alg = peek_alg(tok)
            except Exception:  # noqa: BLE001 - keeps its verdict
                alg = None
            if alg == "ES256" and isinstance(ver, dict):
                exp = ("UnsupportedAlgError",
                       "token signed with unexpected algorithm")
            sl_expected.append(exp)
        sl = validator.validate_batch(
            sl_tokens, Expected(**dict(exp_args,
                                       signing_algorithms=["RS256"])))
        check_verdicts(sl, sl_expected)
        n_alg = sum(isinstance(v, tuple) and v[0] == "UnsupportedAlgError"
                    for v in sl_expected)
        log(f"validator path, RS256 only: {len(sl_tokens)} tokens, every "
            f"verdict as expected ({n_alg} ES256 tokens refused with "
            f"UnsupportedAlgError)")

        # verifies/s of validate_batch against verify_batch, in turns
        t_val, t_ver = [], []
        for _ in range(3):
            for fn, acc in ((lambda: validator.validate_batch(
                    tokens, Expected(**exp_args)), t_val),
                    (lambda: ks.verify_batch(tokens), t_ver)):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                acc.append(time.perf_counter() - t0)
        fixed = Validator(_FixedKeySet(verified))
        t_claims = []
        for _ in range(3):
            t0 = time.perf_counter()
            fixed.validate_batch(tokens, Expected(**exp_args))
            t_claims.append(time.perf_counter() - t0)
        card = card_line()
        log(f"validator path warm ({card}): validate_batch "
            f"{', '.join(f'{t:.3f}' for t in t_val)} s, best "
            f"{len(tokens) / min(t_val):.0f} verifies/s; verify_batch "
            f"{', '.join(f'{t:.3f}' for t in t_ver)} s, best "
            f"{len(tokens) / min(t_ver):.0f} verifies/s; claims loop "
            f"alone {min(t_claims) / len(tokens) * 1e6:.2f} µs/token "
            f"(best of {', '.join(f'{t:.3f}' for t in t_claims)} s)")

        # every unique token against the single-token Validators
        first = {}
        for i, tok in enumerate(tokens):
            first.setdefault(tok, i)
        uniq = list(first)
        n_proc = len(os.sched_getaffinity(0))
        t0 = time.perf_counter()
        with multiprocessing.get_context("spawn").Pool(
                n_proc, _checkers_init,
                (os.path.dirname(os.path.abspath(__file__)), issuer, pems,
                 fields)) as pool:
            parts = pool.map_async(_check_tokens,
                                   [uniq[k::4 * n_proc]
                                    for k in range(4 * n_proc)]).get(600)
        singles = {}
        for k, part in enumerate(parts):
            for tok, pair in zip(uniq[k::4 * n_proc], part):
                singles[tok] = pair
        bad = []
        for tok in uniq:
            batch = _verdict(results[first[tok]])
            for single in singles[tok]:
                if isinstance(batch, dict) or isinstance(single, dict):
                    ok = batch == single
                else:
                    # a kid no key has is UnknownKeyIDError on the
                    # JSONWebKeySet, a subclass of the batch's class
                    ok = issubclass(getattr(errors, single[0]),
                                    getattr(errors, batch[0]))
                if not ok:
                    bad.append((first[tok], batch, single))
        assert not bad, f"{len(bad)} unique tokens differ, first {bad[:3]}"
        log(f"validator path: {len(uniq)} unique tokens, each verdict "
            f"equal to Validator(JSONWebKeySet).validate and to "
            f"Validator(StaticKeySet of {len(pems)} SPKI/PKCS#1 PEMs)"
            f".validate (same class, equal claims) in "
            f"{time.perf_counter() - t0:.1f} s on {n_proc} processes")
    log(f"validator path: phase {time.perf_counter() - t_phase:.1f} s")


BAD_ED_KEY = (2).to_bytes(32, "little")     # y = 2: not on the curve


def build_config4(rng):
    """(jwks, uniq, tampered, tokens, expected) for the PS256 + EdDSA
    batch: 8 RSA-2048 (ps-i) and 8 Ed25519 (ed-i) keys plus one Ed25519
    key that does not decode (ed-bad); 65,536 tokens tiled from 1,024
    unique ones, a seeded 1/8 share with one signature bit flipped, and
    three tokens of each rejection class, each over a token of its own
    family (so the EdDSA tokens fill one packed chunk)."""
    import hashlib

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.gpu import ed25519 as ed
    from cap_tpu_torch.jwt import algs
    from cap_tpu_torch.jwt.jwk import JWK

    t0 = time.perf_counter()
    jwks, uniq, signers = tt.config4_fixtures(N_UNIQUE, seed=SEED + 4)
    jwks.append(JWK(ed.HostEd25519PublicKey(BAD_ED_KEY), kid="ed-bad"))
    log(f"fixtures: 8 RSA-2048 + 8 Ed25519 keys (+1 that does not "
        f"decode), {N_UNIQUE} signed tokens in "
        f"{time.perf_counter() - t0:.1f} s")
    tokens, expected, tampered = tile(rng, uniq)

    ps_priv, _, ps_kid = signers[0]
    ed_priv, _, ed_kid = signers[8]
    claims = tt.default_claims(sub="special")
    ed_tok = tt.sign_jwt(ed_priv, algs.EdDSA, claims, kid=ed_kid)
    sig = unb64(ed_tok.split(".")[2])
    s_plus_l = int.from_bytes(sig[32:], "little") + ed.L_ORDER
    r_big = bytearray((ed.P + 1).to_bytes(32, "little"))
    r_big[31] |= sig[31] & 0x80
    outsider = tt.generate_ed25519_key(rng)
    si = tt.signing_input(algs.PS256, claims, ps_kid)
    em = tt.pss_em(hashlib.sha256(si).digest(), ps_priv.n.bit_length() - 1,
                   "sha256", rng.randbytes(32))
    no_sep = bytearray(em)
    no_sep[len(em) - 32 - 1 - 32 - 1] ^= 0x01   # the 0x01 under the mask
    top = bytearray(em)
    top[0] = 0x80 | (top[0] & 0x0F)             # EM ≥ 2^emBits, still < n
    ps_tok = tt.sign_jwt(ps_priv, algs.PS256, claims, kid=ps_kid, rng=rng)

    def ps(sub, salt):
        return tt.sign_jwt(ps_priv, algs.PS256, dict(claims, sub=sub),
                           kid=ps_kid, rng=rng, salt_len=salt)

    specials = [   # (token, expected, is EdDSA)
        (with_sig(ed_tok, sig[:32] + s_plus_l.to_bytes(32, "little")),
         REJECT, True),
        (with_sig(ed_tok, bytes(r_big) + sig[32:]), REJECT, True),
        (with_sig(ed_tok, sig[:63]), REJECT, True),
        (with_sig(ed_tok, sig + b"\0"), REJECT, True),
        (tt.sign_jwt(ed_priv, algs.EdDSA, claims, kid="ed-bad"), REJECT,
         True),
        (tt.sign_jwt(ed_priv, algs.EdDSA, dict(claims, sub="ed-no-kid")),
         "ed-no-kid", True),
        (tt.sign_jwt(outsider, algs.EdDSA, claims, kid="nobody"), REJECT,
         True),
        (ps("salt-0", 0), "salt-0", False),
        (ps("salt-max", "max"), "salt-max", False),
        (tt.sign_em(ps_priv, si, em[:-1] + b"\xbd"), REJECT, False),
        (tt.sign_em(ps_priv, si, bytes(no_sep)), REJECT, False),
        (tt.sign_em(ps_priv, si, bytes(top)), REJECT, False),
        (with_sig(ps_tok, unb64(ps_tok.split(".")[2])[:-1]), REJECT, False),
    ]
    stride = N_TOKENS // (3 * len(specials) + 1) // 16 * 16
    for k, (tok, exp, is_ed) in enumerate(specials):
        for rep in range(3):
            # unique token u signs with signers[u % 16]: EdDSA at u % 16 ≥ 8
            pos = (k * 3 + rep) * stride + (8 if is_ed else 0)
            tokens[pos] = tok
            expected[pos] = exp
    return jwks, uniq, tampered, tokens, expected


def config4_path(records):
    jwks, uniq, tampered, tokens, expected = cell_fixtures("config-4")
    drive_path(records, "config-4", jwks, tokens, expected,
               [("EdDSA", "ed-", 32768, {"edw": 32, "redc": 3})],
               ("PS256", "EdDSA"), warm=WARM_SLOW)
    return dict(jwks=jwks, tokens=tokens, expected=expected)


def build_config3(rng):
    """(jwks, uniq, tampered, tokens, expected) for the ES256 + ES384
    batch: 8 P-256 (es-i) and 8 P-384 (es384-i) keys, 65,536 tokens
    tiled from 1,024 unique ones (half under each curve), the 1/8
    tampered share, and three tokens of each rejection class: r = 0,
    s ≥ n and a signature one byte short under each curve, an ES384
    alg over a P-256 kid, a kid-less ES384 token (the trial path over
    the 8 P-384 keys: accepted) and an outsider's under an unknown kid;
    each in place of a token of its own curve (unique token u signs
    with signers[u % 16]: ES384 at u % 16 ≥ 8)."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.gpu.ec import curve
    from cap_tpu_torch.jwt import algs

    t0 = time.perf_counter()
    jwks, uniq, signers = tt.config3_fixtures(N_UNIQUE, seed=SEED + 5)
    log(f"fixtures: 8 P-256 + 8 P-384 keys, {N_UNIQUE} signed tokens in "
        f"{time.perf_counter() - t0:.1f} s")
    tokens, expected, tampered = tile(rng, uniq)
    claims = tt.default_claims(sub="special")
    specials = []                  # (token, expected, is ES384)
    for u, crv in ((0, "P-256"), (8, "P-384")):
        tok = uniq[u]
        sig = unb64(tok.split(".")[2])
        cb = curve(crv).coord_bytes
        n = curve(crv).n.to_bytes(cb, "big")
        is384 = crv == "P-384"
        specials += [(with_sig(tok, b"\0" * cb + sig[cb:]), REJECT, is384),
                     (with_sig(tok, sig[:cb] + n), REJECT, is384),
                     (with_sig(tok, sig[:-1]), REJECT, is384)]
    p384, _, _ = signers[8]
    specials += [
        (tt.sign_jwt(p384, algs.ES384, claims, kid="es-0", rng=rng),
         REJECT, True),
        (tt.sign_jwt(p384, algs.ES384, dict(claims, sub="no-kid"),
                     rng=rng), "no-kid", True),
        (tt.sign_jwt(tt.generate_ec_key(rng, "P-384"), algs.ES384, claims,
                     kid="nobody", rng=rng), REJECT, True),
    ]
    stride = N_TOKENS // (3 * len(specials) + 1) // 16 * 16
    for k, (tok, exp, is384) in enumerate(specials):
        for rep in range(3):
            pos = (k * 3 + rep) * stride + (8 if is384 else 0)
            tokens[pos] = tok
            expected[pos] = exp
    return jwks, uniq, tampered, tokens, expected


def config3_path(records):
    """The config-3 cell: one ES256 and one ES384 chunk, one ladder
    launch each. Then the whole-ladder inputs of one batch,
    replayed."""
    jwks, uniq, tampered, tokens, expected = cell_fixtures("config-3")
    run = drive_path(records, "config-3", jwks, tokens, expected,
                     [("ES256", "es-", 32768, ES_LAUNCHES),
                      ("ES384", "es384-", 32768, ES_LAUNCHES)],
                     ("ES256", "ES384"))
    ladder_path_shapes(records, run["ks"], tokens, 2)
    return dict(jwks=jwks, tokens=tokens, expected=expected)


def ladder_path_shapes(records, ks, tokens, n_calls: int):
    """Every whole-ladder input of one config-3 batch (``n_calls``: one
    a chunk, as the keyset counted them), captured at the wrapper and
    replayed through the plain version: X, Y, Z equal by value, inf and
    deg equal; each shape's kernel and plain times (CUDA events) and
    bound."""
    import torch

    from cap_tpu_torch.gpu import cuda_ladder

    kern = cuda_ladder.ladder
    calls = []

    def hooked(ctx, tab, d_all, base, win_stride):
        out = kern(ctx, tab, d_all, base, win_stride)
        calls.append((ctx, tab, d_all.clone(), base.clone(), win_stride,
                      [t.clone() for pair in out[:3] for t in pair]
                      + [out[3].clone(), out[4].clone()]))
        return out

    cuda_ladder.ladder = hooked
    try:
        _, chunks = telemetry_chunks(lambda: ks.verify_batch(tokens))
    finally:
        cuda_ladder.ladder = kern
    assert len(calls) == chunks["es"] == n_calls, (len(calls), chunks)
    for ctx, tab, d_all, base, stride, o in calls:
        args = (tab, d_all, base, stride)
        out_k = ((o[0], o[1]), (o[2], o[3]), (o[4], o[5]), o[6], o[7])
        out_p = cuda_ladder.ladder_ref(ctx, *args)
        torch.cuda.synchronize()
        w, m = d_all.shape
        err, ndiff, deg_only = ladder_compare(ctx, out_k, out_p,
                                              f"ladder at {w}x{m}")
        # a launch takes tens of ms here: CUDA events around a loop of
        # wrapper calls time the kernel, not the host
        ms_k = cuda_ms(lambda: kern(ctx, *args), 3)
        ms_p = cuda_ms(lambda: cuda_ladder.ladder_ref(ctx, *args), 1)
        b_ms, b_by = ladder_bound(ctx, m, w)
        flagged = int(o[7].sum())
        log(f"kernel ladder at the path's shape: {w} windows x {m} lanes "
            f"over a {tab.shape[0]}-row table, equal to the plain version "
            f"({ndiff} lane planes not bit-equal, {flagged} lanes flagged, "
            f"{deg_only} flags differ); kernel {ms_k:.4f} ms, plain "
            f"{ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        records["ladder"].setdefault("path_shapes", []).append(dict(
            shape=[w, m], table_rows=int(tab.shape[0]), max_abs_err=err,
            ms=ms_k, by="events", plain_ms=ms_p, bound_ms=b_ms,
            bound_by=b_by))


def build_mldsa(rng):
    """(jwks, uniq, tampered, tokens, expected) for the pq-mldsa batch:
    8 ML-DSA-44 (mldsa44-i) and 8 ML-DSA-65 (mldsa65-i) AKP keys,
    16,384 tokens tiled from 256 unique ones, the 1/8 tampered share,
    and three tokens of each rejection class under each set, each over
    a token of its own set (unique token u signs with signers[u % 16]:
    ML-DSA-65 at u % 16 ≥ 8)."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.gpu import mldsa
    from cap_tpu_torch.jwt import algs

    t0 = time.perf_counter()
    jwks, uniq, signers = tt.mldsa_fixtures(N_PQ_UNIQUE, seed=SEED + 3)
    log(f"fixtures: 8 ML-DSA-44 + 8 ML-DSA-65 keys, {N_PQ_UNIQUE} signed "
        f"tokens in {time.perf_counter() - t0:.1f} s")
    tokens, expected, tampered = tile(rng, uniq, N_PQ_TOKENS)
    claims = tt.default_claims(sub="special")
    specials = []                  # (token, expected, is ML-DSA-65)
    for off, alg in ((0, algs.MLDSA44), (8, algs.MLDSA65)):
        priv, _, kid = signers[off]
        good = tt.sign_jwt(priv, alg, claims, kid=kid)
        other = tt.sign_jwt(priv, alg, dict(claims, sub="other"), kid=kid)
        sig = unb64(good.split(".")[2])
        is65 = alg == algs.MLDSA65
        for _, bad in tt.mldsa_bad_signatures(sig, alg):
            specials.append((with_sig(good, bad), REJECT, is65))
        h, _, s = good.split(".")
        specials.append((f"{h}.{other.split('.')[1]}.{s}", REJECT, is65))
        specials.append((tt.sign_jwt(priv, alg, dict(claims, sub="no-kid")),
                         "no-kid", is65))
        outsider, _ = mldsa.keygen(alg, bytes([off + 1]) * 32)
        specials.append((tt.sign_jwt(outsider, alg, claims, kid="nobody"),
                         REJECT, is65))
    p65, _, _ = signers[8]
    specials.append((tt.sign_jwt(p65, algs.MLDSA65, claims,
                                 kid=signers[0][2]), REJECT, True))
    stride = N_PQ_TOKENS // (3 * len(specials) + 1) // 16 * 16
    for k, (tok, exp, is65) in enumerate(specials):
        for rep in range(3):
            pos = (k * 3 + rep) * stride + (8 if is65 else 0)
            tokens[pos] = tok
            expected[pos] = exp
    return jwks, uniq, tampered, tokens, expected


def mldsa_path(records):
    jwks, uniq, tampered, tokens, expected = cell_fixtures("pq-mldsa")
    per_chunk = {"keccak": 14, "ntt": 2, "intt": 1}
    run = drive_path(records, "pq-mldsa", jwks, tokens, expected,
                     [("ML-DSA-44", "mldsa44-", 1024, per_chunk),
                      ("ML-DSA-65", "mldsa65-", 1024, per_chunk)],
                     ("ML-DSA-44", "ML-DSA-65"), warm=WARM_SLOW)
    path_shape_phase(records, run["ks"], tokens, "pq-mldsa")
    return dict(jwks=jwks, tokens=tokens, expected=expected)


N_MODE_TOKENS = 8192          # engine modes: cut from 65,536
N_MODE_PQ_TOKENS = 2048       # engine modes: cut from 16,384
MLDSA_CHUNK = 1024            # the keyset's ML-DSA chunk, every set


def pad_pow2(n: int) -> int:
    """The lanes an engine entry pads n tokens to: a power of two ≥ 128."""
    return max(128, 1 << max(n - 1, 0).bit_length())


@contextlib.contextmanager
def redc_swapped(hook):
    """``cuda_redc.redc`` replaced by ``hook`` while the block runs: the
    module's attribute and the ``redc=`` default of every ec_rns and
    ed25519_rns function that binds it. Yields the real wrapper."""
    from cap_tpu_torch.gpu import cuda_redc, ec_rns, ed25519_rns

    real = cuda_redc.redc
    swapped = []
    for mod in (ec_rns, ed25519_rns):
        for fn in list(vars(mod).values()):
            d = getattr(fn, "__defaults__", None)
            if d and any(x is real for x in d):
                swapped.append((fn, d))
                fn.__defaults__ = tuple(hook if x is real else x for x in d)
    cuda_redc.redc = hook
    try:
        yield real
    finally:
        cuda_redc.redc = real
        for fn, d in swapped:
            fn.__defaults__ = d


REPLAY_LANES = 65536          # lanes (states, rows) a batched replay
HELD_KERNELS = ("ladder", "redc", "edw", "keccak", "ntt", "intt")


@contextlib.contextmanager
def kernels_held(path: str, names=HELD_KERNELS):
    """Every card launch of the kernels ``names`` while the block runs,
    held against its plain version on the same inputs. The ladder and
    edw right after each call: X, Y, Z (and T) equal by value mod p on
    both residue planes, the ladder's inf and deg as
    :func:`ladder_compare` has them. REDC, Keccak, NTT and inverse NTT,
    whose lanes (states, rows) depend on themselves alone: each call's
    inputs and outputs kept and replayed through the plain version with
    the other calls of its shape side by side, in batches of up to
    ``REPLAY_LANES`` lanes, REDC bit-equal or equal by value mod p on
    both planes, the others every word equal. A call on a CPU shard
    (the plain version itself) is not held. Yields {(kernel, shape):
    [calls, the first call's inputs]}, which :func:`held_times` times
    (the REDC defaults of ec_rns and ed25519_rns swapped as
    :func:`redc_swapped` does)."""
    import torch

    from cap_tpu_torch.gpu import (
        cuda_edw,
        cuda_keccak,
        cuda_ladder,
        cuda_ntt,
        cuda_redc,
        keccak,
        ntt,
    )

    attrs = {"ladder": (cuda_ladder, "ladder"),
             "edw": (cuda_edw, "edw_window"),
             "keccak": (cuda_keccak, "f1600"), "ntt": (cuda_ntt, "ntt"),
             "intt": (cuda_ntt, "intt")}
    real = {k: getattr(*attrs[k]) for k in attrs}
    real["redc"] = cuda_redc.redc
    plain = {"keccak": keccak.f1600_plain, "ntt": ntt.ntt_plain,
             "intt": ntt.intt_plain}
    unit = {"keccak": (25, 2), "ntt": (256,), "intt": (256,)}
    held, queued = {}, {}

    def planes(pair):
        return [t.cpu().numpy() for t in pair]

    def note(name, shape, first):
        h = held.setdefault((name, shape), [0, None])
        h[0] += 1
        if h[1] is None:
            h[1] = first()

    def flush(key):
        name, ctx, _, rows = queued.pop(key)
        if name == "redc":
            xA, xB, tA, tB = (torch.cat([r[i] for r in rows], dim=1)
                              for i in range(4))
            rA, rB = cuda_redc.redc_ref(ctx, xA, xB)
            if torch.equal(tA, rA) and torch.equal(tB, rB):
                return
            err, nd, split = max_err(ctx, planes((tA, tB)),
                                     planes((rA, rB)))
            assert err == 0 and split == 0, f"redc at {path}: {err}, {nd}"
            return
        x, out = (torch.cat([r[i] for r in rows]) for i in range(2))
        err, nd = word_diff(out.reshape(len(out), -1),
                            plain[name](x).reshape(len(out), -1))
        assert err == 0 and nd == 0, f"{name} at {path}: {nd} differ"

    def later(name, ctx, lanes, row):
        key = (name, id(ctx), lanes if name == "redc" else 0)
        q = queued.setdefault(key, [name, ctx, 0, []])
        q[2] += lanes
        q[3].append(row)
        if q[2] >= REPLAY_LANES:
            flush(key)

    def ladder(ctx, tab, d_all, base, stride):
        out = real["ladder"](ctx, tab, d_all, base, stride)
        if d_all.is_cuda:
            ladder_compare(ctx, out, cuda_ladder.ladder_ref(
                ctx, tab, d_all, base, stride), f"ladder at {path}")
            note("ladder", (*d_all.shape, int(tab.shape[0])),
                 lambda: (ctx, tab, d_all.clone(), base.clone(), stride))
        return out

    def edw(ctx, X, Y, Z, T, tab, rows):
        out = real["edw"](ctx, X, Y, Z, T, tab, rows)
        if rows.is_cuda:
            for kk, pp in zip(out, cuda_edw.edw_window_ref(
                    ctx, X, Y, Z, T, tab, rows)):
                err, nd, split = max_err(ctx, planes(kk), planes(pp))
                assert err == 0 and split == 0, \
                    f"edw at {path}: {err}, {nd}"
            note("edw", (int(rows.numel()), int(tab.shape[0])),
                 lambda: (ctx, *[tuple(t.clone() for t in v)
                                 for v in (X, Y, Z, T)], tab, rows.clone()))
        return out

    def redc(ctx, xA, xB):
        out = real["redc"](ctx, xA, xB)
        if xA.is_cuda:
            row = (xA.clone(), xB.clone(), out[0].clone(), out[1].clone())
            note("redc", (int(xA.shape[1]),), lambda: (ctx, row[0], row[1]))
            later("redc", ctx, int(xA.shape[1]), row)
        return out

    def rowwise(name):
        def call(x):
            out = real[name](x)
            if x.is_cuda:
                note(name, tuple(x.shape), x.clone)
                later(name, None, x.numel() // (50 if name == "keccak"
                                                else 256),
                      (x.reshape((-1,) + unit[name]).clone(),
                       out.reshape((-1,) + unit[name]).clone()))
            return out
        return call

    hooks = {"ladder": ladder, "edw": edw, "keccak": rowwise("keccak"),
             "ntt": rowwise("ntt"), "intt": rowwise("intt")}
    try:
        for k in names:
            if k in attrs:
                setattr(*attrs[k], hooks[k])
        with (redc_swapped(redc) if "redc" in names
              else contextlib.nullcontext()):
            yield held
    finally:
        for k in names:
            if k in attrs:
                setattr(*attrs[k], real[k])
    for key in list(queued):
        flush(key)


def held_times(records, path: str, held, launches) -> str:
    """Each shape :func:`kernels_held` saw: its calls (which must sum to
    the path's ``launches`` of each kernel), the kernel and its plain
    version timed on the first call's inputs (CUDA events around 3
    calls and 1: at the small shapes a call's host work outlasts its
    kernel, so these are call times, marked "events"), beside the
    bound; added to the kernel's ``path_shapes``. Returns the log's
    summary."""
    from cap_tpu_torch.gpu import (
        cuda_edw,
        cuda_keccak,
        cuda_ladder,
        cuda_ntt,
        cuda_redc,
        keccak,
        ntt,
    )

    calls = {}
    for (name, _), (n, _) in held.items():
        calls[name] = calls.get(name, 0) + n
    for name, n in calls.items():
        assert n == launches[name], (path, name, n, launches)
    fns = {"ladder": (cuda_ladder.ladder, cuda_ladder.ladder_ref),
           "edw": (cuda_edw.edw_window, cuda_edw.edw_window_ref),
           "redc": (cuda_redc.redc, cuda_redc.redc_ref),
           "keccak": (cuda_keccak.f1600, keccak.f1600_plain),
           "ntt": (cuda_ntt.ntt, ntt.ntt_plain),
           "intt": (cuda_ntt.intt, ntt.intt_plain)}
    parts = []
    for (name, shape), (n, args) in sorted(held.items(), key=str):
        kern, ref = fns[name]
        args = args if isinstance(args, tuple) else (args,)
        ms_k = cuda_ms(lambda: kern(*args), 3)
        ms_p = cuda_ms(lambda: ref(*args), 1)
        row = dict(path=path, calls=n, max_abs_err=0, ms=ms_k,
                   by="events", plain_ms=ms_p)
        if name == "ladder":
            w, m, rows = shape
            b_ms, b_by = ladder_bound(args[0], m, w)
            row.update(shape=[w, m], table_rows=rows,
                       w_bits=args[0].w_bits)
            what = f"{w}x{m} over {rows} rows"
        elif name in ("redc", "edw"):
            c = args[0]
            ia, ib = c.A.count, c.B.count
            lanes = shape[0]
            if name == "redc":
                b_ms, b_by, _ = rns_bound(lanes * (2 * ia + 2 * ib) * 4,
                                          redc_work(ia, ib), lanes)
            else:
                nbytes = lanes * (8 * (ia + ib) * 4 + 3 * max(ia, ib) * 4
                                  + 4)
                b_ms, b_by, _ = rns_bound(nbytes, edw_work(ia, ib), lanes)
                row["table_rows"] = shape[1]
            row["lanes"] = lanes
            what = f"{lanes} lanes"
        else:
            units = args[0].numel() // (50 if name == "keccak" else 256)
            b_ms, b_by = mldsa_bound(name, units)
            row["shape"] = list(shape)
            what = f"{list(shape)}"
        row.update(bound_ms=b_ms, bound_by=b_by)
        records[name].setdefault("path_shapes", []).append(row)
        parts.append(f"{name} {what} x {n} ({ms_k:.4f} ms, plain "
                     f"{ms_p:.4f} ms, bound {b_ms:.5f} ms)")
    return "; ".join(parts)


@contextlib.contextmanager
def engine_calls():
    """Counts of the calls into each engine entry while the block runs
    (which engine a mode routes each family to; ``_py_verify_one``
    counts the ES lanes re-verified on the oracle)."""
    from cap_tpu_torch.gpu import ec, ec_rns, ed25519, ed25519_rns, mldsa, rsa

    calls = {}
    hooks = [(rsa, "modexp_65537"), (rsa, "verify_em_equals_device"),
             (rsa, "modexp_em_device"), (ec, "_ecdsa_core"),
             (ec, "_ecdsa_affine_tail"), (ec, "_py_verify_one"),
             (ec_rns, "_ecdsa_rns_core_steps"), (ec_rns, "affine_ladder"),
             (ed25519, "_ed25519_core"),
             (ed25519_rns, "_ed25519_rns_core_steps"),
             (mldsa, "verify_mldsa_core_pending"), (mldsa, "_fused_core")]
    saved = []
    for mod, name in hooks:
        real = getattr(mod, name)

        def hook(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        saved.append((mod, name, real))
        setattr(mod, name, hook)
    try:
        yield calls
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


MODE_CURVE = {"ES256": "P-256", "ES384": "P-384"}
MODE_HASH = {"ES384": "sha384"}


def mode_inputs(jwks, tokens, expected, fams):
    """One slice's engine inputs by family. ``fams`` [(alg, kid prefix)]:
    a token of the alg whose kid names one of the family's keys goes in,
    with the verdict its signature alone decides (True where the keyset
    accepts it, False where it answers ``REJECT``), and the family's
    key table on the card. Returns {alg: dict(table, sigs, msgs,
    digests, rows, want)}."""
    import hashlib

    import numpy as np

    from cap_tpu_torch.errors import CapError
    from cap_tpu_torch.gpu import ec, ed25519, mldsa, rsa
    from cap_tpu_torch.jwt.jose import parse_jws

    out = {}
    for alg, prefix in fams:
        keys = [j for j in jwks if j.kid and j.kid.startswith(prefix)]
        row = {j.kid: i for i, j in enumerate(keys)}
        b = dict(sigs=[], msgs=[], rows=[], want=[])
        for tok, exp in zip(tokens, expected):
            try:
                p = parse_jws(tok)
            except CapError:
                continue
            if p.alg != alg or p.kid not in row:
                continue
            assert isinstance(exp, str) or exp == REJECT, (alg, exp)
            b["sigs"].append(p.signature)
            b["msgs"].append(p.signing_input)
            b["rows"].append(row[p.kid])
            b["want"].append(isinstance(exp, str))
        b["digests"] = [hashlib.new(MODE_HASH.get(alg, "sha256"),
                                    m).digest() for m in b["msgs"]]
        b["rows"] = np.asarray(b["rows"], np.int64)
        pubs = [j.key for j in keys]
        if alg in ("RS256", "PS256"):
            b["table"] = rsa.RSAKeyTable([(k.n, k.e) for k in pubs])
        elif alg in MODE_CURVE:
            b["table"] = ec.ECKeyTable(MODE_CURVE[alg], pubs)
        elif alg == "EdDSA":
            b["table"] = ed25519.Ed25519KeyTable(pubs)
        else:
            b["table"] = mldsa.MLDSAKeyTable(alg, pubs)
        out[alg] = b
    return out


def mode_verify(alg: str, b: dict, mode: dict):
    """One family's verdicts through its engine entry point in ``mode``
    (the entry's ``rns=``/``ladder=`` keywords; ``{}`` the default).
    ML-DSA: the two-phase arm (``verify_mldsa_batch``) for a mode, the
    fused engine in the keyset's chunks for the default."""
    from cap_tpu_torch.gpu import ec, ed25519, mldsa, rsa

    t = b["table"]
    if alg == "RS256":
        return rsa.verify_pkcs1v15_batch(t, b["sigs"], b["digests"],
                                         "sha256", b["rows"], **mode)
    if alg == "PS256":
        return rsa.verify_pss_batch(t, b["sigs"], b["digests"], "sha256",
                                    b["rows"], **mode)
    if alg in MODE_CURVE:
        return ec.verify_ecdsa_batch(t, b["sigs"], b["digests"], b["rows"],
                                     **mode)
    if alg == "EdDSA":
        return ed25519.verify_ed25519_batch(t, b["sigs"], b["msgs"],
                                            b["rows"], **mode)
    if mode:
        return mldsa.verify_mldsa_batch(t, b["sigs"], b["msgs"], b["rows"])
    out = []
    for lo in range(0, len(b["sigs"]), MLDSA_CHUNK):
        n = len(b["sigs"][lo:lo + MLDSA_CHUNK])
        fin = mldsa.verify_mldsa_fused_pending(
            t, b["sigs"][lo:lo + n], b["msgs"][lo:lo + n],
            b["rows"][lo:lo + n], pad=pad_pow2(n))
        out.extend(fin()[:n])
    return out


def mode_run(inputs, modes):
    """The verdicts of every family of ``modes`` {alg: mode} and the
    run's seconds (the card synchronized at its end)."""
    import torch

    t0 = time.perf_counter()
    got = {alg: [bool(v) for v in mode_verify(alg, inputs[alg], mode)]
           for alg, mode in modes.items()}
    torch.cuda.synchronize()
    return got, time.perf_counter() - t0


def mode_pass(records, name, inputs, modes, want, engines, base_s, card,
              hold=()):
    """One engine-mode pass over the families of ``modes`` {alg: mode}:
    the mode's window tables built first, then one counted run (every
    launch counter zeroed just before it and read just after it, every
    kernel launched exactly ``want[k]`` times and no other, every
    verdict the signature's, the engines in ``engines`` called, the
    counts added to ``records`` under ``name``), timed as the pass's
    warm run beside the default entries' time on the same inputs
    (``base_s``). With ``hold`` (kernel names) every launch of those
    kernels in the counted run is held against its plain version
    (:func:`kernels_held`, each shape timed by :func:`held_times`), and
    one more run, unhooked, is timed."""
    from cap_tpu_torch.gpu import mldsa

    for alg, mode in modes.items():
        t = inputs[alg]["table"]
        if alg in MODE_CURVE and mode.get("rns") is False:
            t.limb_tables()
        elif alg in MODE_CURVE:
            t.rns(mode.get("w_bits", 8)).device_tab(t.device)
        elif alg == "EdDSA" and mode.get("rns") is False:
            t.tna()
    mldsa.host_shake_calls = 0
    # the REDC defaults are swapped before engine_calls wraps the
    # functions that bind them
    with counted_launches(records, name, want) as launches, (
            kernels_held(name, hold) if hold else contextlib.nullcontext(
                {})) as held, engine_calls() as calls:
        got, warm_s = mode_run(inputs, modes)
        for alg in modes:
            bad = [i for i, (g, w) in enumerate(zip(got[alg],
                                                    inputs[alg]["want"]))
                   if g != w]
            assert not bad, (name, alg, len(bad), bad[:5])
    shakes = mldsa.host_shake_calls
    for e in engines:
        assert calls.get(e, 0) > 0, (name, e, calls)
    if hold:
        log(f"engine modes {name}: every launch of "
            + ", ".join(f"{launches[k]} {k}" for k in hold)
            + " equal to the plain version on its inputs; by shape: "
            + held_times(records, name, held, launches))
        # the held run is not timed: one more, unhooked
        again, warm_s = mode_run(inputs, modes)
        assert again == got, name
    n = sum(len(inputs[alg]["sigs"]) for alg in modes)
    log(f"engine modes {name}: {modes} over "
        + ", ".join(f"{len(inputs[a]['sigs'])} {a}" for a in modes)
        + f", every verdict the signature's; launches {launches}; engine "
        f"calls {calls}; host SHAKE {shakes}; warm run {warm_s:.3f} s, "
        f"{n / warm_s:.0f} verifies/s beside the default entries' "
        f"{n / base_s:.0f} on the same inputs ({card})")
    return dict(shakes=shakes, calls=calls, warm_s=warm_s)


def default_s(inputs, algs) -> float:
    """The default entries' warm seconds on the families ``algs``: one
    run to build the RNS tables, then one timed (verdicts checked)."""
    modes = dict.fromkeys(algs, {})
    mode_run(inputs, modes)
    got, secs = mode_run(inputs, modes)
    for alg in algs:
        assert got[alg] == inputs[alg]["want"], alg
    return secs


def engine_modes_path(records, north, config4, pq):
    """The engine modes off the default path, through the engine entry
    points that take them (``rsa.verify_pkcs1v15_batch``,
    ``verify_pss_batch``, ``ec.verify_ecdsa_batch``,
    ``ed25519.verify_ed25519_batch``, ``mldsa.verify_mldsa_batch``), on
    the signatures of the first 8,192 tokens of the north-star and
    config-4 batches and the first 2,048 of pq-mldsa: (a) ``rns=False``
    (RS256 by ``modexp_65537``, ES256 by the limb Jacobian ladder; no
    kernel), (b) ES256 with ``ladder="affine"`` (the RNS affine ladder,
    :func:`ec_rns.affine_redc_launches` redc launches, each held against
    the plain REDC; no ladder, no madd), (c) ES256 with ``rns=False,
    ladder="affine"`` (the limb affine ladder; no kernel), (d) config-4
    with ``rns=False`` (EdDSA by the limb ladder, PS256 by
    ``modexp_65537`` with the device PSS check; no kernel), (e) pq-mldsa
    on the two-phase arm (2 ntt + 1 intt a set's call, no Keccak, host
    SHAKE)."""
    from cap_tpu_torch.gpu import ec_rns

    card = card_line()
    ns = mode_inputs(north["jwks"], north["tokens"][:N_MODE_TOKENS],
                     north["expected"][:N_MODE_TOKENS],
                     [("RS256", "rs-"), ("ES256", "es-")])
    c4 = mode_inputs(config4["jwks"], config4["tokens"][:N_MODE_TOKENS],
                     config4["expected"][:N_MODE_TOKENS],
                     [("PS256", "ps-"), ("EdDSA", "ed-")])
    pqs = mode_inputs(pq["jwks"], pq["tokens"][:N_MODE_PQ_TOKENS],
                      pq["expected"][:N_MODE_PQ_TOKENS],
                      [("ML-DSA-44", "mldsa44-"), ("ML-DSA-65", "mldsa65-")])
    base = dict(north=default_s(ns, ("RS256", "ES256")),
                es=default_s(ns, ("ES256",)),
                config4=default_s(c4, ("PS256", "EdDSA")),
                pq=default_s(pqs, ("ML-DSA-44", "ML-DSA-65")))
    off = dict(rns=False)
    mode_pass(records, "modes-a rns=off", ns,
              {"RS256": off, "ES256": off}, {},
              ("modexp_65537", "_ecdsa_core"), base["north"], card)
    n_es = len(ns["ES256"]["sigs"])
    mode_pass(records, "modes-b affine", ns, {"ES256": dict(ladder="affine")},
              {"redc": ec_rns.affine_redc_launches("P-256", pad_pow2(n_es))},
              ("affine_ladder",), base["es"], card, hold=("redc",))
    mode_pass(records, "modes-c rns=off affine", ns,
              {"ES256": dict(ladder="affine", rns=False)}, {},
              ("_ecdsa_core", "_ecdsa_affine_tail"), base["es"], card)
    mode_pass(records, "modes-d config-4 rns=off", c4,
              {"PS256": off, "EdDSA": off}, {},
              ("modexp_65537", "_ed25519_core"), base["config4"], card)
    two = dict(two_phase=True)
    # one verify_mldsa_batch a set: 2 ntt + 1 intt each
    run = mode_pass(records, "modes-e two-phase", pqs,
                    {"ML-DSA-44": two, "ML-DSA-65": two},
                    {"ntt": 4, "intt": 2}, ("verify_mldsa_core_pending",),
                    base["pq"], card)
    assert run["shakes"] > 0 and "_fused_core" not in run["calls"]


def sha512_phase(ks, tokens):
    """The device SHA-384/512 (``gpu/sha512.py``, plain PyTorch) on the
    card: every length 0–300 (``*_var``) and 0–111 (``*_fixed``)
    against hashlib, then the MGF1 seeds and M' inputs of one chunk of
    each hash, captured where the PS engine hashes them, word-equal to
    hashlib row by row; each captured call timed by CUDA events beside
    hashlib on the host."""
    import hashlib

    import numpy as np
    import torch

    from cap_tpu_torch.gpu import sha512
    from cap_tpu_torch.gpu import rsa as gpursa
    from cap_tpu_torch.jwt import gpu_keyset
    from cap_tpu_torch.runtime.native_binding import prepare_batch_arrays

    rng = np.random.default_rng(SEED + 8)
    dev = ks.device
    for name in ("sha384", "sha512"):
        fixed = getattr(sha512, f"{name}_fixed")
        var = getattr(sha512, f"{name}_var")
        lens = np.arange(301)
        buf = np.zeros((301, 300), np.uint8)
        for i, n in enumerate(lens):
            buf[i, :n] = rng.integers(0, 256, n)
        got = var(torch.from_numpy(buf).to(dev),
                  torch.from_numpy(lens).to(dev), 300).cpu().numpy()
        bad = [int(n) for i, n in enumerate(lens) if got[i].tobytes() !=
               hashlib.new(name, buf[i, :n].tobytes()).digest()]
        for n in range(112):
            msgs = rng.integers(0, 256, (4, n), dtype=np.uint8)
            out = fixed(torch.from_numpy(msgs).to(dev)).cpu().numpy()
            if [o.tobytes() for o in out] != \
                    [hashlib.new(name, m.tobytes()).digest() for m in msgs]:
                bad.append(("fixed", n))
        assert not bad, f"{name} differs from hashlib at {bad[:5]}"
        log(f"sha {name}: device {name}_var at every length 0-300 and "
            f"{name}_fixed at every length 0-111 equal to hashlib")

    pb = prepare_batch_arrays(tokens)
    table = ks._rsa_tables[0]
    calls = []

    def hooked(fn_name, fn):
        def call(*a):
            out = fn(*a)
            calls.append((fn_name, fn, [x.clone() if hasattr(x, "clone")
                                        else x for x in a], out.clone()))
            return out
        return call

    for alg, name in (("PS384", "sha384"), ("PS512", "sha512")):
        h_len = gpursa.HASH_LEN[name]
        chunk_n = ks._chunk_tokens(2 * table.k + h_len + 2)
        idx = family_idx(pb, alg)
        idx = idx[ks._rows(idx, pb, ks._kid_rsa_row, ks._n_rsa_keys) >= 0]
        originals = {f: getattr(sha512, f) for f in
                     (f"{name}_fixed", f"{name}_var")}
        calls.clear()
        try:
            for f, fn in originals.items():
                setattr(sha512, f, hooked(f, fn))
            pending = []
            ks._run_rsa_packed("ps", name, idx[:chunk_n], pb, pending)
            torch.cuda.synchronize()
        finally:
            for f, fn in originals.items():
                setattr(sha512, f, fn)
        assert sorted(c[0] for c in calls) == sorted(originals), calls
        for fn_name, fn, args, out in calls:
            x = args[0].cpu().numpy()
            lens = (args[1].cpu().numpy() if len(args) > 1
                    else np.full(len(x), x.shape[1]))
            t0 = time.perf_counter()
            want = [hashlib.new(name, row[:n].tobytes()).digest()
                    for row, n in zip(x, lens)]
            host_ms = (time.perf_counter() - t0) * 1e3
            got = out.cpu().numpy()
            ndiff = sum(g.tobytes() != w for g, w in zip(got, want))
            assert ndiff == 0, f"{fn_name}: {ndiff} rows differ from hashlib"
            ms = cuda_ms(lambda: fn(*args), 3)
            log(f"sha {fn_name} at one {alg} chunk's "
                f"{'MGF1 seeds' if len(args) == 1 else 'M-prime inputs'} "
                f"{list(x.shape)}: every row equal to hashlib; device "
                f"{ms:.2f} ms (CUDA events), hashlib on the host "
                f"{host_ms:.2f} ms")


def build_ps512(rng):
    """(jwks, uniq, tampered, tokens, expected) for the PS384 + PS512
    batch: 8 RSA-2048 keys (ps-i), 65,536 tokens tiled from 1,024 unique
    ones (half PS384, half PS512), the 1/8 tampered share, and three
    tokens of each PS rejection class of config-4 (salt 0 and max salt
    accepted; bad trailer, no separator, top bits, one byte short
    rejected) under each hash, each in place of a token of its own hash
    (unique token u signs with signers[u % 16]: PS512 at u % 16 ≥ 8)."""
    import hashlib

    from cap_tpu_torch import testing as tt

    t0 = time.perf_counter()
    jwks, uniq, signers = tt.ps512_fixtures(N_UNIQUE, seed=SEED + 6)
    log(f"fixtures: 8 RSA-2048 keys, {N_UNIQUE} signed PS384/PS512 tokens "
        f"in {time.perf_counter() - t0:.1f} s")
    tokens, expected, tampered = tile(rng, uniq)
    specials = []                  # (token, expected, is PS512)
    for off in (0, 8):
        priv, alg, kid = signers[off]
        hash_name = {"PS384": "sha384", "PS512": "sha512"}[alg]
        h_len = len(hashlib.new(hash_name).digest())
        claims = tt.default_claims(sub=f"special-{alg}")
        si = tt.signing_input(alg, claims, kid)
        em = tt.pss_em(hashlib.new(hash_name, si).digest(),
                       priv.n.bit_length() - 1, hash_name,
                       rng.randbytes(h_len))
        no_sep = bytearray(em)
        no_sep[len(em) - h_len - 1 - h_len - 1] ^= 0x01
        top = bytearray(em)
        top[0] = 0x80 | (top[0] & 0x0F)
        tok = tt.sign_jwt(priv, alg, claims, kid=kid, rng=rng)
        is512 = off == 8
        for sub, salt in ((f"salt-0-{alg}", 0), (f"salt-max-{alg}", "max")):
            specials.append((tt.sign_jwt(priv, alg, dict(claims, sub=sub),
                                         kid=kid, rng=rng, salt_len=salt),
                             sub, is512))
        specials += [
            (tt.sign_em(priv, si, em[:-1] + b"\xbd"), REJECT, is512),
            (tt.sign_em(priv, si, bytes(no_sep)), REJECT, is512),
            (tt.sign_em(priv, si, bytes(top)), REJECT, is512),
            (with_sig(tok, unb64(tok.split(".")[2])[:-1]), REJECT, is512)]
    stride = N_TOKENS // (3 * len(specials) + 1) // 16 * 16
    for k, (tok, exp, is512) in enumerate(specials):
        for rep in range(3):
            pos = (k * 3 + rep) * stride + (8 if is512 else 0)
            tokens[pos] = tok
            expected[pos] = exp
    return jwks, uniq, tampered, tokens, expected


def ps512_path(records):
    """The ps-sha512 cell: PS384 and PS512 through the PS engine with the
    device SHA-384/512. No kernel of the port runs on it (the RNS modexp
    and the PSS check are PyTorch, as in the JAX package)."""
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet

    jwks, uniq, tampered, tokens, expected = cell_fixtures("ps-sha512")
    sha512_phase(GPUBatchKeySet(jwks), tokens)
    drive_path(records, "ps-sha512", jwks, tokens, expected,
               [("PS384", "ps-", 16384, {}), ("PS512", "ps-", 8192, {})],
               ("PS384", "PS512"), warm=WARM_SLOW)


def build_slhdsa(rng):
    """(jwks, uniq, tampered, tokens, expected) for the pq-slhdsa batch:
    8 SLH-DSA-SHAKE-128f (slh128f-i) and 8 SLH-DSA-SHAKE-128s
    (slh128s-i) AKP keys, N_SLH_TOKENS tokens alternating between the
    sets, each set's tiled from its unique tokens (N_SLH_UNIQUE_F 128f,
    N_SLH_UNIQUE_S 128s) with the
    1/8 tampered share, and three tokens of each rejection class under
    each set (an R bit, a FORS byte, one byte short and one long, a
    hypertree byte, another payload under the signature), a kid-less
    token of each set (the trial path over its 8 keys: accepted), an
    outsider's 128f token under an unknown kid, and a 128f alg over a
    128s kid; each in place of a token of its own set (128s at odd
    positions)."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.gpu import slhdsa

    t0 = time.perf_counter()
    jwks, uniq, signers = tt.slhdsa_fixtures(N_SLH_UNIQUE_F, N_SLH_UNIQUE_S,
                                             seed=SEED + 7)
    log(f"fixtures: 8 {SLH_F} + 8 {SLH_S} keys, {N_SLH_UNIQUE_F} + "
        f"{N_SLH_UNIQUE_S} signed tokens in "
        f"{time.perf_counter() - t0:.1f} s")
    uniq_f, uniq_s = uniq[:N_SLH_UNIQUE_F], uniq[N_SLH_UNIQUE_F:]
    half = N_SLH_TOKENS // 2
    tok_f, exp_f, tamp_f = tile(rng, uniq_f, half)
    tok_s, exp_s, tamp_s = tile(rng, uniq_s, half)
    tokens = [t for pair in zip(tok_f, tok_s) for t in pair]
    expected = [e for pair in zip(exp_f, exp_s) for e in pair]
    claims = tt.default_claims(sub="special")
    specials = []                  # (token, expected, is 128s)
    for own, other, off in ((uniq_f[0], uniq_f[8], 0),
                            (uniq_s[0], uniq_s[1], 8)):
        priv, alg, kid = signers[off]
        is_s = off == 8
        h, _, s = own.split(".")
        for _, bad in tt.slhdsa_bad_signatures(unb64(s), alg):
            specials.append((with_sig(own, bad), REJECT, is_s))
        specials.append((f"{h}.{other.split('.')[1]}.{s}", REJECT, is_s))
        sub = f"no-kid-{alg}"
        specials.append((tt.sign_jwt(priv, alg, dict(claims, sub=sub)), sub,
                         is_s))
    outsider, _ = slhdsa.keygen(SLH_F, bytes([7]) * 32)
    specials.append((tt.sign_jwt(outsider, SLH_F, claims, kid="nobody"),
                     REJECT, False))
    specials.append((tt.sign_jwt(signers[0][0], SLH_F, claims,
                                 kid=signers[8][2]), REJECT, False))
    stride = N_SLH_TOKENS // (3 * len(specials) + 1) // 2 * 2
    for k, (tok, exp, is_s) in enumerate(specials):
        for rep in range(3):
            pos = (k * 3 + rep) * stride + (1 if is_s else 0)
            tokens[pos] = tok
            expected[pos] = exp
    return jwks, uniq, tamp_f + tamp_s, tokens, expected


def slhdsa_path(records):
    """The pq-slhdsa cell: one chunk of each set, keccak launched 518
    times a 128f chunk and 219 times a 128s chunk, no other kernel;
    then every keccak input of one batch replayed through the plain
    version and timed at each shape."""
    from cap_tpu_torch.gpu import slhdsa

    for pset, n in SLH_LAUNCHES.items():
        assert slhdsa.chunk_launches(slhdsa.PARAMS[pset]) == n, pset
    jwks, uniq, tampered, tokens, expected = cell_fixtures("pq-slhdsa")
    run = drive_path(records, "pq-slhdsa", jwks, tokens, expected,
                     [(pset, f"slh128{pset[-1]}-", 1024, {"keccak": n})
                      for pset, n in SLH_LAUNCHES.items()],
                     (SLH_F, SLH_S), warm=WARM_SLOW)
    path_shape_phase(records, run["ks"], tokens, "pq-slhdsa", ("keccak",))
    return dict(jwks=jwks, tokens=tokens, expected=expected)


N_C2_TOKENS = N_TOKENS        # config-2: not cut
N_LIMB_TOKENS = 16384         # rsa-limb: cut from 65,536
N_BIG_TOKENS = 32768          # big-jwks: cut from 65,536
N_BIG_KEYS = 300


def place_specials(tokens, expected, specials):
    """Three copies of each (token, expected) special at evenly spread
    positions of the tiled batch."""
    stride = len(tokens) // (3 * len(specials) + 1)
    for k, (tok, exp) in enumerate(specials):
        for rep in range(3):
            pos = (k * 3 + rep) * stride + 17
            tokens[pos] = tok
            expected[pos] = exp


def build_config2(rng):
    """(jwks, uniq, tampered, tokens, expected) for BASELINE.json's
    second configuration: 4 RSA-2048 (rs2k-i) and 4 RSA-4096 (rs4k-i)
    keys, 65,536 RS256/RS384/RS512 tokens tiled from 1,024 unique ones
    (``testing.config2_fixtures``), the 1/8 tampered share, and three
    tokens of each rejection class under each width (a signature one
    byte short, s = n, an RS384 header over an RS256 signature), a
    kid-less RS512 token (the trial path: accepted) and an outsider's
    RS256 token under an unknown kid."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt import algs

    t0 = time.perf_counter()
    jwks, uniq, signers = tt.config2_fixtures(N_UNIQUE, seed=SEED + 8)
    log(f"fixtures: 4 RSA-2048 + 4 RSA-4096 keys, {N_UNIQUE} signed "
        f"tokens in {time.perf_counter() - t0:.1f} s")
    tokens, expected, tampered = tile(rng, uniq, N_C2_TOKENS)
    claims = tt.default_claims(sub="special")
    outsider = tt.pool_rsa_keys(tt.prime_pool(2, 1024, rng), 1)[0]
    specials = []                      # (token, expected)
    for u in (0, 4):                   # rs2k-0 and rs4k-0 under RS256
        tok = uniq[u]
        sig = unb64(tok.split(".")[2])
        n = signers[u][0].n
        h384 = b64(json.dumps({"alg": "RS384", "kid": signers[u][2]})
                   .encode())
        specials += [(with_sig(tok, sig[:-1]), REJECT),
                     (with_sig(tok, n.to_bytes(len(sig), "big")), REJECT),
                     (h384 + "." + tok.split(".", 1)[1], REJECT)]
    specials += [
        (tt.sign_jwt(signers[20][0], algs.RS512,
                     dict(claims, sub="no-kid")), "no-kid"),
        (tt.sign_jwt(outsider, algs.RS256, claims, kid="nobody"), REJECT)]
    place_specials(tokens, expected, specials)
    return jwks, uniq, tampered, tokens, expected


def config2_path(records):
    """The config-2 cell: two RSA classes (2048 and 4096 bits) on the RNS
    engine under three hashes; no kernel of the port launches."""
    jwks, uniq, tampered, tokens, expected = cell_fixtures("config-2")
    drive_path(records, "config-2", jwks, tokens, expected, [],
               ("RS256", "RS384", "RS512"))


def build_rsalimb(rng):
    """(jwks, uniq, tampered, tokens, expected) for the rsa-limb batch:
    ``testing.rsalimb_fixtures`` (an RSA-2048 class of e = 3, 17, 65537
    and 2^31 − 1 keys, an RSA-3072 class of e = 65537 keys one of whose
    moduli is 4099·q, 4 P-256 keys), 16,384 tokens tiled from 1,024
    unique ones (half RS256 and PS256, half ES256), the 1/8 tampered
    share, and three tokens of each rejection class: s = n and a
    signature one byte short under each RSA class, a PS256 header over
    an RS256 signature, a kid-less RS256 token under the e = 3 key (the
    trial path: accepted) and an outsider's ES256 token under an
    unknown kid."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt import algs

    t0 = time.perf_counter()
    jwks, uniq, signers = tt.rsalimb_fixtures(N_UNIQUE, seed=SEED + 9)
    log(f"fixtures: RSA-2048 e = 3/17/65537/2^31-1, 4 RSA-3072 (one "
        f"4099·q) + 4 P-256 keys, {N_UNIQUE} signed tokens in "
        f"{time.perf_counter() - t0:.1f} s")
    tokens, expected, tampered = tile(rng, uniq, N_LIMB_TOKENS)
    claims = tt.default_claims(sub="special")
    specials = []
    for u in (0, 4):                   # lim-0 (e = 3) and lim3k-0 (4099·q)
        tok = uniq[u]
        sig = unb64(tok.split(".")[2])
        n = signers[u][0].n
        hps = b64(json.dumps({"alg": "PS256", "kid": signers[u][2]})
                  .encode())
        specials += [(with_sig(tok, n.to_bytes(len(sig), "big")), REJECT),
                     (with_sig(tok, sig[:-1]), REJECT),
                     (hps + "." + tok.split(".", 1)[1], REJECT)]
    specials += [
        (tt.sign_jwt(signers[0][0], algs.RS256, dict(claims, sub="no-kid")),
         "no-kid"),
        (tt.sign_jwt(tt.generate_ec_key(rng), algs.ES256, claims,
                     kid="nobody", rng=rng), REJECT)]
    place_specials(tokens, expected, specials)
    return jwks, uniq, tampered, tokens, expected


def limb_phase():
    """One limb-engine chunk at each width the paths give it, on random
    odd moduli: ``modexp_vare`` over 31 exponent bits at 2048 bits
    (16,384 tokens: the rsa-limb vare class's chunk), ``modexp_65537``
    at 3072 bits (8,192: its F4 class's chunk) and at 4096 bits (8,192:
    a 4096-bit class's chunk). Device ms by CUDA events and the peak of
    ``torch.cuda.max_memory_allocated`` above what was allocated before;
    64 lanes against ``pow``."""
    import numpy as np
    import torch

    from cap_tpu_torch.gpu import limbs as L
    from cap_tpu_torch.gpu import rsa as gpursa

    rng = random.Random(SEED + 10)
    for bits, chunk, exps in ((2048, 16384, (3, 17, 65537, 2 ** 31 - 1)),
                              (3072, 8192, (65537,)),
                              (4096, 8192, (65537,))):
        nums = [(rng.getrandbits(bits) | (1 << (bits - 1)) | 1,
                 exps[i % len(exps)]) for i in range(4)]
        table = gpursa.RSAKeyTable(nums, device="cuda")
        rows = [i % 4 for i in range(chunk)]
        s_ints = [rng.randrange(nums[r][0]) for r in rows[:64]]
        s = np.zeros((chunk, 2 * table.k), np.uint8)
        s[:, 2 * table.k - bits // 8:] = np.frombuffer(
            rng.randbytes(chunk * bits // 8), np.uint8).reshape(chunk, -1)
        s[:, 2 * table.k - bits // 8] &= 0x3F       # s < n
        for j, v in enumerate(s_ints):
            s[j] = np.frombuffer(v.to_bytes(2 * table.k, "big"), np.uint8)
        s_l = L.bytes_to_limbs_device(torch.from_numpy(s).cuda())
        idx = torch.as_tensor(rows, device="cuda")
        gpursa.modexp_for_table(table, s_l[:, :128], idx[:128])  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: gpursa.modexp_for_table(table, s_l, idx), 1)
        peak = torch.cuda.max_memory_allocated() - base
        em = gpursa.modexp_for_table(table, s_l, idx)[:, :64].cpu().numpy()
        for j, v in enumerate(s_ints):
            n, e = nums[rows[j]]
            assert L.limbs_to_int(em[:, j]) == pow(v, e, n), (bits, j)
        name = "modexp_65537" if table.all_f4 else \
            f"modexp_vare ({table.max_ebits} bits)"
        log(f"limb chunk: {bits}-bit {name} over {chunk} tokens (K = "
            f"{table.k} limbs): {ms:.1f} ms, peak {peak / 2 ** 30:.2f} GiB "
            f"above {base / 2 ** 30:.2f} GiB; 64 lanes equal to pow")



def rsalimb_path(records):
    """The rsa-limb cell: RS256 and PS256 on the limb engine
    (``modexp_vare`` for the 2048-bit class, ``modexp_65537`` for the
    3072-bit one; no kernel) beside an ES256 chunk (1 ladder + 11
    redc); then one limb chunk at each width timed and its peak memory
    read."""
    jwks, uniq, tampered, tokens, expected = cell_fixtures("rsa-limb")
    run = drive_path(records, "rsa-limb", jwks, tokens, expected,
                     [("ES256", "es-", 32768, ES_LAUNCHES)],
                     ("RS256", "PS256", "ES256"), warm=WARM_SLOW)
    tables = run["ks"]._rsa_tables
    assert [(t.all_f4, t.ctx is None, t.max_ebits) for t in tables] == \
        [(False, True, 31), (True, True, 17)], \
        [(t.all_f4, t.ctx, t.max_ebits) for t in tables]
    limb_phase()


def build_bigjwks(rng):
    """(jwks, uniq, tampered, tokens, expected) for the big-jwks batch:
    ``testing.bigjwks_fixtures`` (300 RSA-2048, 300 P-256 and 300
    Ed25519 keys), 32,768 tokens tiled from 1,024 unique ones (a third
    each RS256, ES256 and EdDSA, their kids over all 300 rows of each
    class), the 1/8 tampered share, and three tokens of each rejection
    class, each over a token of a row above 255: s = n and a signature
    one byte short (RS256), r = 0, s ≥ n and one byte short (ES256),
    S + L and one byte short (EdDSA); kid-less tokens of each family
    signed by row 1 (the trial path over 300 keys: accepted) and an
    outsider's RS256 token under an unknown kid."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.gpu import ed25519 as ed
    from cap_tpu_torch.gpu.ec import curve
    from cap_tpu_torch.jwt import algs

    t0 = time.perf_counter()
    jwks, uniq, signers = tt.bigjwks_fixtures(N_UNIQUE, seed=SEED + 11,
                                              n_keys=N_BIG_KEYS)
    log(f"fixtures: {N_BIG_KEYS} RSA-2048 + {N_BIG_KEYS} P-256 + "
        f"{N_BIG_KEYS} Ed25519 keys, {N_UNIQUE} signed tokens in "
        f"{time.perf_counter() - t0:.1f} s")
    tokens, expected, tampered = tile(rng, uniq, N_BIG_TOKENS)
    claims = tt.default_claims(sub="special")
    n_p256 = curve("P-256").n
    # unique token u = 3·r + f signs with row r of family f (u < 900)
    rs, es, edt = uniq[3 * 280], uniq[3 * 290 + 1], uniq[3 * 299 + 2]
    rs_sig, es_sig, ed_sig = (unb64(t.split(".")[2]) for t in (rs, es, edt))
    s_plus_l = int.from_bytes(ed_sig[32:], "little") + ed.L_ORDER
    outsider = tt.pool_rsa_keys(tt.prime_pool(2, 1024, rng), 1)[0]

    def row1(f):
        priv, alg, kid = signers[f * N_BIG_KEYS + 1]
        return tt.sign_jwt(priv, alg, dict(claims, sub=f"no-kid-{alg}"),
                           rng=rng)

    specials = [                   # (token, expected)
        (with_sig(rs, signers[280][0].n.to_bytes(256, "big")), REJECT),
        (with_sig(rs, rs_sig[:-1]), REJECT),
        (with_sig(es, bytes(32) + es_sig[32:]), REJECT),
        (with_sig(es, es_sig[:32] + n_p256.to_bytes(32, "big")), REJECT),
        (with_sig(es, es_sig[:-1]), REJECT),
        (with_sig(edt, ed_sig[:32] + s_plus_l.to_bytes(32, "little")),
         REJECT),
        (with_sig(edt, ed_sig[:-1]), REJECT),
        (row1(0), "no-kid-RS256"),
        (row1(1), "no-kid-ES256"),
        (row1(2), "no-kid-EdDSA"),
        (tt.sign_jwt(outsider, algs.RS256, claims, kid="nobody"), REJECT),
    ]
    place_specials(tokens, expected, specials)
    return jwks, uniq, tampered, tokens, expected


def telemetry_chunks(fn):
    """Run ``fn()`` with the telemetry recorder on: (its result, the
    packed chunks the keyset dispatched by family, from its
    ``device.<family>.lanes`` series)."""
    from cap_tpu_torch import telemetry

    with telemetry.recording() as rec:
        out = fn()
    summary = rec.summary()
    return out, {k.split(".")[1]: int(v["count"]) for k, v in
                 summary.items()
                 if k.startswith("device.") and k.endswith(".lanes")}


def rns_path_replay(records, ks, tokens, path, want, want_chunks):
    """Every ladder, redc and edw input of one batch, captured at the
    wrappers as the path makes them (the redc default of every ec_rns
    and ed25519_rns function swapped for the hook) and replayed through
    the plain versions right away: outputs equal by value mod p on both
    residue planes, the ladder's inf and deg equal. The calls of each
    kernel must be ``want``, and the chunks the keyset counted by family
    ``want_chunks``; the widest key row the ladder and edw read is
    logged. The ladder and edw are timed at the path's shape (CUDA
    events, one call each)."""
    import torch

    from cap_tpu_torch.gpu import cuda_edw, cuda_ladder, cuda_redc, ed25519_rns

    real = dict(ladder=cuda_ladder.ladder, redc=cuda_redc.redc,
                edw=cuda_edw.edw_window)
    calls = dict.fromkeys(real, 0)
    top_row = dict(ladder=-1, edw=-1)
    first = {}

    def planes(pair):
        return [t.cpu().numpy() for t in pair]

    def ladder(ctx, tab, d_all, base, win_stride):
        out = real["ladder"](ctx, tab, d_all, base, win_stride)
        ladder_compare(ctx, out, cuda_ladder.ladder_ref(
            ctx, tab, d_all, base, win_stride), f"ladder at {path}")
        per = (1 << ctx.w_bits) - 1
        top_row["ladder"] = max(top_row["ladder"],
                                int(base.max()) // per - 1)
        first.setdefault("ladder", (ctx, tab, d_all.clone(), base.clone(),
                                    win_stride))
        calls["ladder"] += 1
        return out

    def redc(ctx, xA, xB):
        out = real["redc"](ctx, xA, xB)
        err, nd, split = max_err(ctx, planes(out), planes(
            cuda_redc.redc_ref(ctx, xA, xB)))
        assert err == 0 and split == 0, f"redc at {path}: {err}, {nd}"
        calls["redc"] += 1
        return out

    def edw(ctx, X, Y, Z, T, tab, rows):
        out = real["edw"](ctx, X, Y, Z, T, tab, rows)
        for kk, pp in zip(out, cuda_edw.edw_window_ref(ctx, X, Y, Z, T, tab,
                                                       rows)):
            err, nd, split = max_err(ctx, planes(kk), planes(pp))
            assert err == 0 and split == 0, f"edw at {path}: {err}, {nd}"
        slot = ed25519_rns.NW8 * ed25519_rns.PER
        top_row["edw"] = max(top_row["edw"], int(rows.max()) // slot - 1)
        first.setdefault("edw", (ctx, X, Y, Z, T, tab, rows.clone()))
        calls["edw"] += 1
        return out

    cuda_ladder.ladder, cuda_edw.edw_window = ladder, edw
    try:
        with redc_swapped(redc):
            _, chunks = telemetry_chunks(lambda: ks.verify_batch(tokens))
    finally:
        cuda_ladder.ladder = real["ladder"]
        cuda_edw.edw_window = real["edw"]
    assert calls == want and {f: chunks.get(f) for f in want_chunks} \
        == want_chunks, \
        (path, calls, want, chunks, want_chunks)
    assert min(top_row.values()) > 255, top_row
    ctx, tab, d_all, base, stride = first["ladder"]
    ms_k = cuda_ms(lambda: real["ladder"](ctx, tab, d_all, base, stride), 1)
    ms_p = cuda_ms(lambda: cuda_ladder.ladder_ref(ctx, tab, d_all, base,
                                                  stride), 1)
    w, m = d_all.shape
    b_ms, b_by = ladder_bound(ctx, m, w)
    records["ladder"].setdefault("path_shapes", []).append(dict(
        path=path, shape=[w, m], table_rows=int(tab.shape[0]),
        max_abs_err=0, ms=ms_k, by="events", plain_ms=ms_p, bound_ms=b_ms,
        bound_by=b_by))
    ectx, *args = first["edw"]
    ms_e = cuda_ms(lambda: real["edw"](ectx, *args), 1)
    ms_ep = cuda_ms(lambda: cuda_edw.edw_window_ref(ectx, *args), 1)
    records["edw"].setdefault("path_shapes", []).append(dict(
        path=path, lanes=int(args[-1].numel()),
        table_rows=int(args[-2].shape[0]), max_abs_err=0, ms=ms_e,
        by="events", plain_ms=ms_ep))
    log(f"kernels at the {path} path's shapes: {calls['ladder']} ladder, "
        f"{calls['redc']} redc and {calls['edw']} edw calls in one batch, "
        f"every output equal to the plain version; key rows read up to "
        f"{top_row['ladder']} (ladder) and {top_row['edw']} (edw); ladder "
        f"{w} windows x {m} lanes over a {tab.shape[0]}-row table "
        f"{ms_k:.3f} ms (plain {ms_p:.1f} ms, bound {b_ms:.4f} ms), edw "
        f"{args[-1].numel()} lanes over a {args[-2].shape[0]}-row table "
        f"{ms_e:.4f} ms (plain {ms_ep:.2f} ms)")


def bigjwks_path(records):
    """The big-jwks cell: every class of 300 keys, so RS256, ES256 and
    EdDSA all take the arrays paths (int64 key rows); one ES chunk (1
    ladder + 11 redc) and one EdDSA chunk (32 edw + 3 redc); then every
    ladder, redc and edw input of one batch replayed through the plain
    versions."""
    import torch

    jwks, uniq, tampered, tokens, expected = cell_fixtures("big-jwks")
    run = drive_path(records, "big-jwks", jwks, tokens, expected,
                     [("ES256", "bes-", 32768, ES_LAUNCHES),
                      ("EdDSA", "bed-", 32768, {"edw": 32, "redc": 3})],
                     ("RS256", "ES256", "EdDSA"))
    ks = run["ks"]
    ec_tab = ks._ec_tables["P-256"].rns().device_tab("cuda")
    ed_tab = ks._ed_table.rns().device_tab("cuda")
    log(f"big-jwks tables on the card: P-256 {ec_tab.shape[0]} rows x "
        f"{ec_tab.shape[1]} words ({ec_tab.numel() * 4 / 2 ** 20:.0f} MiB), "
        f"Ed25519 {ed_tab.shape[0]} x {ed_tab.shape[1]} "
        f"({ed_tab.numel() * 4 / 2 ** 20:.0f} MiB); largest table offset "
        f"{max(ec_tab.numel(), ed_tab.numel())} words (int32 range "
        f"{2 ** 31 - 1}); card memory allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    rns_path_replay(records, ks, tokens, "big-jwks",
                    dict(ladder=1, redc=14, edw=32), dict(es=1, ed=1))


# ---------------------------------------------------------------------------
# the oidc path (BASELINE.json's fifth configuration)
# ---------------------------------------------------------------------------

N_OIDC_TOKENS = 100_000
N_OIDC_UNIQUE = 1024
N_OIDC_MAX_AGE = 8192         # the second request's slice (max_age)
N_OIDC_GOOD_SLICE = 8192      # the all-accepted slice (counters)
OIDC_NOW = 1_700_000_060      # the IdP's and the relying party's clock
OIDC_REDIRECT = "https://rp.example/callback"
OIDC_NONCE = "n-oidc-batch"
OIDC_AUD2 = "svc-2"           # a second audience the request accepts


def oidc_idp(rng):
    """The port's TestProvider mid-rotation: it signs with es-0 and its
    JWKS publishes 4 P-256 keys (es-0..3) and 1 RSA-2048 key (rs-0).
    Returns (idp, signers [(private key, alg, kid)])."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt.jwk import serialize_public_key
    from cap_tpu_torch.oidc.testing import TestProvider

    signers = [(tt.generate_ec_key(rng), "ES256", f"es-{i}")
               for i in range(4)]
    signers.append((tt.generate_rsa_key(rng, 2048), "RS256", "rs-0"))

    class RotatingIdP(TestProvider):
        def jwks_document(self):
            return {"keys": [serialize_public_key(priv.public_key(),
                                                  kid=kid, alg=alg)
                             for priv, alg, kid in signers]}

    idp = RotatingIdP(rng=rng)
    priv, alg, kid = signers[0]
    idp.set_signing_keys(priv, priv.public_key(), alg, kid)
    idp.set_now_func(lambda: OIDC_NOW)
    return idp, signers


def oidc_authorize(idp, url):
    """GET the IdP's authorize URL as a browser would, without following
    its redirect: (status, headers, body)."""
    import http.client
    import ssl
    from urllib.parse import urlparse

    u = urlparse(url)
    conn = http.client.HTTPSConnection(
        u.hostname, u.port,
        context=ssl.create_default_context(cadata=idp.ca_cert()))
    try:
        conn.request("GET", u.path + "?" + u.query)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def sign_payload(priv, kid: str, payload: bytes, rng) -> str:
    """An ES256 token over payload bytes given verbatim."""
    import hashlib

    from cap_tpu_torch.gpu.ec import curve, host_ecdsa_sign

    si = b64(json.dumps({"alg": "ES256", "kid": kid}).encode()) + "." + \
        b64(payload)
    e = int.from_bytes(hashlib.sha256(si.encode()).digest(), "big")
    r, s = host_ecdsa_sign("P-256", priv.d, e,
                           rng.randrange(1, curve("P-256").n))
    return si + "." + b64(r.to_bytes(32, "big") + s.to_bytes(32, "big"))


def oidc_flows(idp, p, ks, signers, rng):
    """One code flow with PKCE (auth_url, /authorize, exchange over
    post_form, verify_id_token, at_hash, c_hash, userinfo) and one
    implicit flow through ``callback.implicit``, on the Provider over
    the card's keyset; each ID token also through
    ``verify_id_token_batch`` on the card."""
    import hashlib
    import io
    import re
    from urllib.parse import parse_qs, urlencode, urlparse

    from cap_tpu_torch import errors
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.oidc import IDToken, Request, S256Verifier, callback

    now = lambda: float(OIDC_NOW)  # noqa: E731
    v = S256Verifier()
    req = Request(600, OIDC_REDIRECT, pkce_verifier=v, now_func=now)
    idp.set_expected_auth_nonce(req.nonce())
    idp.set_expected_code_verifier(v.verifier())
    try:
        status, headers, _ = oidc_authorize(idp, p.auth_url(req))
        assert status == 302, status
        q = parse_qs(urlparse(headers["Location"]).query)
        code, state = q["code"][0], q["state"][0]
        assert state == req.state()
        token = p.exchange(req, state, code)
    finally:
        idp.expected_code_verifier = None
    claims = p.verify_id_token(token.id_token(), req)
    assert claims["nonce"] == req.nonce() and token.valid()
    assert token.id_token().verify_access_token(token.access_token())
    batch = p.verify_id_token_batch([token.id_token()], req)
    assert batch == [claims], batch
    # c_hash: the IdP issues none in the code flow, so one of its keys
    # signs the same claims with the code's left-half hash
    half = hashlib.sha256(code.encode()).digest()[:16]
    priv, alg, kid = signers[1]
    c_tok = IDToken(tt.sign_jwt(priv, alg, dict(claims, c_hash=b64(half)),
                                kid=kid, rng=rng))
    assert c_tok.verify_authorization_code(code) is True
    try:
        c_tok.verify_authorization_code("stolen-code")
        raise AssertionError("c_hash accepted another code")
    except errors.InvalidCodeHashError:
        pass
    assert p.verify_id_token(c_tok, req)["c_hash"] == b64(half)
    info = p.userinfo(token.static_token_source(), idp.replay_subject)
    assert info["sub"] == idp.replay_subject == claims["sub"]

    ireq = Request(600, OIDC_REDIRECT, implicit_flow=True,
                   implicit_access_token=True, now_func=now)
    status, _, body = oidc_authorize(idp, p.auth_url(ireq))
    assert status == 200, status
    fields = dict(re.findall(r'name="([^"]+)" value="([^"]+)"',
                             body.decode()))
    got = {}

    def success(state, token, environ):
        got["token"] = token
        return 200, [("Content-Type", "text/plain")], "ok"

    def error(state, resp, err, environ):
        return 401, [("Content-Type", "text/plain")], f"{resp} {err!r}"

    app = callback.implicit(p, callback.SingleRequestReader(ireq), success,
                            error)
    form = urlencode(fields).encode()
    seen = {}
    out = b"".join(app({"REQUEST_METHOD": "POST", "QUERY_STRING": "",
                        "CONTENT_LENGTH": str(len(form)),
                        "wsgi.input": io.BytesIO(form)},
                       lambda st, hd: seen.setdefault("status", st)))
    assert seen["status"] == "200 OK" and out == b"ok", (seen, out)
    itok = got["token"]
    assert itok.id_token().verify_access_token(itok.access_token())
    assert isinstance(p.verify_id_token_batch([itok.id_token()], ireq)[0],
                      dict)
    log(f"oidc flows: code flow with PKCE (authorize, exchange over "
        f"post_form, verify_id_token, at_hash, c_hash, userinfo) and an "
        f"implicit flow through callback.implicit, each ID token also "
        f"through verify_id_token_batch on the card")


def build_oidc(rng, idp, signers, client):
    """(tokens, expected, expected_raw, n_fallback) for the oidc batch: N_OIDC_TOKENS ID tokens tiled from N_OIDC_UNIQUE
    signed round-robin by the four ES256 keys (the 1/8 tampered share),
    and three tokens of each native status class, each fallback class
    and each signature rejection class. expected[i] is the sub of an
    accepted token or (class, message); the raw mode's messages differ
    from the dict mode's where the native rules keep a template
    (``claims_native.status_error``)."""
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.gpu.ec import curve

    t0 = time.perf_counter()
    iss = idp.issuer()
    base = dict(iss=iss, aud=[client], iat=OIDC_NOW - 60,
                nbf=OIDC_NOW - 60, exp=OIDC_NOW + 3600,
                auth_time=OIDC_NOW - 60, nonce=OIDC_NONCE)
    es = signers[:4]
    uniq = []
    for j in range(N_OIDC_UNIQUE):
        priv, alg, kid = es[j % 4]
        uniq.append(tt.sign_jwt(priv, alg, dict(base, sub=f"user-{j:05d}"),
                                kid=kid, rng=rng))
    tokens, expected, tampered = tile(rng, uniq, N_OIDC_TOKENS)
    expected_raw = list(expected)

    def sign(k, **over):
        priv, alg, kid = signers[k]
        claims = {key: v for key, v in dict(base, **over).items()
                  if v is not None}
        return tt.sign_jwt(priv, alg, claims, kid=kid, rng=rng)

    now = float(OIDC_NOW)
    aud_err = "InvalidAudienceError"
    azp_err = "InvalidAuthorizedPartyError"
    multi = ["svc-2", "svc-3"]
    # (token, dict-mode verdict, raw-mode verdict)
    status_classes = [
        (sign(0, sub="x-exp", exp=None),
         ("MissingClaimError", "id_token missing exp claim"), None),
        (sign(1, sub="x-expired", exp=OIDC_NOW - 3600),
         ("ExpiredTokenError", "token is expired"), None),
        (sign(2, sub="x-nbf", nbf=OIDC_NOW + 3600),
         ("InvalidNotBeforeError",
          "current time before the nbf (not before) time"), None),
        (sign(3, sub="x-iss", iss="https://evil.example/"),
         ("InvalidIssuerError", "id token issued by a different provider"),
         None),
        (sign(4, sub="x-rs256"),
         ("UnsupportedAlgError",
          "id_token signed with unsupported algorithm 'RS256'"), None),
        (sign(0, sub="x-nonce", nonce="another-nonce"),
         ("InvalidNonceError", "invalid id_token nonce"), None),
        (sign(1, sub="x-iat", iat=OIDC_NOW + 3600),
         ("InvalidIssuedAtError", f"current time {now} before the iat "
          f"(issued at) time {OIDC_NOW + 3600}"),
         ("InvalidIssuedAtError",
          f"current time {now} before the iat (issued at) time")),
        (sign(2, sub="x-aud-int", aud=[client, 42]),
         (aud_err, "aud claim contains a non-string value"), None),
        (sign(3, sub="x-aud", aud=["someone-else"]),
         (aud_err, "invalid id_token audiences"), None),
        (sign(0, sub="x-multi", aud=multi),
         (aud_err, f"multiple audiences ({multi}) and one of them is not "
          f"equal client_id ({client})"),
         (aud_err, f"multiple audiences and one of them is not equal "
          f"client_id ({client})")),
        (sign(1, sub="x-azp", azp="intruder"),
         (azp_err, f"authorized party (intruder) is not equal client_id "
          f"({client})"),
         (azp_err, f"authorized party is not equal client_id ({client})")),
    ]
    escaped = json.dumps(dict(base, sub="fb-escaped"),
                         separators=(",", ":")).replace('"iss"',
                                                        '"i\\u0073s"')
    fallback_classes = [
        (sign_payload(signers[2][0], "es-2", escaped.encode(), rng),
         "fb-escaped", None),
        (sign(3, sub="fb-bool-exp", exp=True),
         ("ExpiredTokenError", "token is expired"), None),
        (sign(0, sub="fb-aud-object", aud={"weird": 1}),
         (aud_err, "invalid id_token audiences"), None),
    ]
    es_tok = uniq[0]
    es_sig = unb64(es_tok.split(".")[2])
    n = curve("P-256").n
    outsider = tt.generate_ec_key(rng)

    def wrapped(msg):
        return ("InvalidSignatureError",
                f"failed to verify id token signature: {msg}")

    sig_classes = [
        (tt.sign_jwt(outsider, "ES256", dict(base, sub="x-outsider"),
                     kid="nobody", rng=rng), REJECT, None),
        (b64(b'{"alg":"none"}') + "." + b64(b'{"sub":"x"}') + ".",
         wrapped("token must be signed"), None),
        (with_sig(es_tok, b"\0" * 32 + es_sig[32:]), REJECT, None),
        (with_sig(es_tok, es_sig[:32] + n.to_bytes(32, "big")), REJECT,
         None),
        (with_sig(es_tok, es_sig[:-1]), REJECT, None),
        ("a.b", wrapped("compact JWS must have 3 segments"), None),
        ("!!!." + es_tok.split(".", 1)[1],
         wrapped("invalid base64url segment"), None),
    ]
    specials = status_classes + fallback_classes + sig_classes
    stride = N_OIDC_TOKENS // (3 * len(specials) + 1)
    for k, (tok, exp, exp_raw) in enumerate(specials):
        for rep in range(3):
            pos = (k * 3 + rep) * stride + 11
            tokens[pos] = tok
            expected[pos] = exp
            expected_raw[pos] = exp if exp_raw is None else exp_raw
    log(f"oidc fixtures: {N_OIDC_UNIQUE} ES256 ID tokens signed by 4 "
        f"P-256 keys, {len(status_classes)} native status classes, "
        f"{len(fallback_classes)} fallback classes and {len(sig_classes)} "
        f"signature classes three times each, in "
        f"{time.perf_counter() - t0:.1f} s")
    return tokens, expected, expected_raw, 3 * len(fallback_classes)


def check_oidc(results, expected, tokens, raw: bool):
    """Every verdict as expected; in raw mode an accepted token's
    result is exactly its payload bytes."""
    bad = []
    for i, (got, exp) in enumerate(zip(results, expected)):
        if isinstance(exp, tuple):
            ok = (type(got).__name__ == exp[0] and str(got) == exp[1])
        elif raw:
            ok = (isinstance(got, bytes)
                  and got == unb64(tokens[i].split(".")[1])
                  and json.loads(got).get("sub") == exp)
        else:
            ok = isinstance(got, dict) and got.get("sub") == exp
        if not ok:
            bad.append((i, exp, got))
    assert not bad, f"{len(bad)} wrong verdicts, first: {bad[:3]}"


_OIDC_CHECK = None


def _oidc_check_init(repo, issuer, ca, client, secret, state, audiences):
    """Worker set-up for the unique-token cross-check: a Provider over
    the port's CPU JSONWebKeySet, built by discovery over the IdP's TLS,
    and the batch's Request."""
    global _OIDC_CHECK
    sys.path.insert(0, repo)
    from cap_tpu_torch.oidc import Config, Provider, Request

    now = lambda: float(OIDC_NOW)  # noqa: E731
    p = Provider(Config(issuer=issuer, client_id=client,
                        client_secret=secret,
                        supported_signing_algs=["ES256"],
                        allowed_redirect_urls=[OIDC_REDIRECT],
                        provider_ca=ca, now_func=now))
    req = Request(3600, OIDC_REDIRECT, state=state, nonce=OIDC_NONCE,
                  audiences=audiences, now_func=now)
    _OIDC_CHECK = (p, req)


def _oidc_check_tokens(tokens):
    p, req = _OIDC_CHECK
    out = []
    for tok in tokens:
        try:
            out.append(_verdict(p.verify_id_token(tok, req)))
        except Exception as e:  # noqa: BLE001 - compared by the caller
            out.append(_verdict(e))
    return out


def oidc_path(records):
    """BASELINE.json's fifth configuration on the card: the port's
    TestProvider on loopback TLS, mid-rotation (4 P-256 keys and 1
    RSA-2048 key in its JWKS); a Provider built through discovery over
    ``GPUBatchKeySet`` of the JWKS fetched from the discovered
    jwks_uri; one code flow with PKCE and one implicit flow; then
    ``verify_id_token_batch`` on N_OIDC_TOKENS ID tokens in dict and raw
    modes with every native status, fallback and signature class, a
    second request with max_age over a slice, and the all-accepted
    slice's counters. Both modes launch what ``verify_batch`` launches
    (1 ladder + 11 redc an ES chunk); dict, raw and verify_batch_raw
    are timed in turns, the native rules call alone, and one
    verify_batch is split by phase and profiled on the device; each
    unique token's verdict equals the single-token ``verify_id_token``
    over the CPU JSONWebKeySet (in spawned processes)."""
    import multiprocessing

    import numpy as np
    import torch

    from cap_tpu_torch import errors
    from cap_tpu_torch.jwt import GPUBatchKeySet
    from cap_tpu_torch.jwt.jwk import RSAPublicKey, parse_jwks
    from cap_tpu_torch.oidc import Config, Provider, Request, claims_native
    from cap_tpu_torch.runtime.native_binding import (
        ALG_NAMES,
        prepare_batch_arrays,
    )
    from cap_tpu_torch.utils import http

    t_phase = time.perf_counter()
    rng = random.Random(SEED + 13)
    idp, signers = oidc_idp(rng)
    now = lambda: float(OIDC_NOW)  # noqa: E731
    with idp:
        client = idp.client_id
        cfg = Config(issuer=idp.issuer(), client_id=client,
                     client_secret=idp.client_secret,
                     supported_signing_algs=["ES256"],
                     allowed_redirect_urls=[OIDC_REDIRECT],
                     provider_ca=idp.ca_cert(), now_func=now)
        t0 = time.perf_counter()
        discovered = Provider(cfg)
        doc = http.get_json(discovered.jwks_uri,
                            http.ssl_context_for_ca(idp.ca_cert()))
        jwks = parse_jwks(doc)
        assert [j.kid for j in jwks] == [s[2] for s in signers]
        for j, (priv, _, _) in zip(jwks, signers):
            want = priv.public_key()
            if isinstance(want, RSAPublicKey):
                assert (j.key.n, j.key.e) == (want.n, want.e)
            else:
                a, b = j.key.public_numbers(), want.public_numbers()
                assert (j.key.curve_name, a.x, a.y) == \
                    (want.curve_name, b.x, b.y)
        ks = GPUBatchKeySet(jwks)
        p = Provider(cfg, keyset=ks)
        log(f"oidc: Provider through discovery at {idp.issuer()} (TLS, "
            f"the port's pure-Python CA), GPUBatchKeySet of the "
            f"{len(jwks)} keys at the discovered jwks_uri (4 P-256, 1 "
            f"RSA-2048), equal to the IdP's ({time.perf_counter() - t0:.2f}"
            f" s)")
        oidc_flows(idp, p, ks, signers, rng)

        tokens, expected, expected_raw, n_fb = build_oidc(rng, idp, signers,
                                                          client)
        req = Request(3600, OIDC_REDIRECT, state="st-oidc-batch",
                      nonce=OIDC_NONCE, audiences=[client, OIDC_AUD2],
                      now_func=now)

        pb = prepare_batch_arrays(tokens)
        n_es = int((pb.kid_rows(family_idx(pb, "ES256"),
                                {f"es-{i}": 0 for i in range(4)})
                    >= 0).sum())
        ctr = counters()
        chunks, want = es256_want(n_es, ctr)
        counted = []

        def launched(fn):
            for mod, attr in ctr.values():
                setattr(mod, attr, 0)
            t0 = time.perf_counter()
            out, per_family = telemetry_chunks(fn)
            torch.cuda.synchronize()
            counted.append(per_family["es"])
            return out, {k: getattr(mod, attr)
                         for k, (mod, attr) in ctr.items()}, \
                time.perf_counter() - t0

        verified, l_ver, _ = launched(lambda: ks.verify_batch(tokens))
        res_d, l_dict, s_dict = launched(
            lambda: p.verify_id_token_batch(tokens, req))
        claims_native.reset_counts()
        res_r, l_raw, s_raw = launched(
            lambda: p.verify_id_token_batch(tokens, req, raw=True))
        n_val, n_fb_got = (claims_native.native_validated,
                           claims_native.native_fallbacks)
        _, l_vraw, _ = launched(lambda: ks.verify_batch_raw(tokens))
        assert l_dict == l_raw == l_ver == l_vraw == want, \
            (l_dict, l_raw, l_ver, l_vraw, want)
        assert counted == [chunks] * 4, (counted, chunks)
        check_oidc(res_d, expected, tokens, raw=False)
        check_oidc(res_r, expected_raw, tokens, raw=True)
        for i, (d, r) in enumerate(zip(res_d, res_r)):
            if isinstance(d, dict):
                assert json.loads(r) == d, i
            else:
                assert type(d) is type(r), (i, d, r)
        n_acc = sum(not isinstance(v, Exception) for v in verified)
        assert n_val + n_fb_got == n_acc and n_fb_got == n_fb, \
            (n_val, n_fb_got, n_acc, n_fb)
        for k, count in l_dict.items():
            rec = records[k]
            rec["launches"] = rec.get("launches", 0) + count
            rec.setdefault("launches_by_path", {})["oidc"] = count
        log(f"oidc path: {len(tokens)} ID tokens ({n_es} ES256 on the "
            f"kernels' path, {chunks} chunk(s)) through "
            f"verify_id_token_batch, dict and raw modes, every verdict as "
            f"expected, raw bytes the payloads of the dict mode's claims; "
            f"launches {l_dict} in each mode, equal to verify_batch's and "
            f"verify_batch_raw's, the chunks as the keyset counted them in "
            f"each; native rules decided {n_val} tokens, the "
            f"Python rules {n_fb_got} (the fallback classes); first runs "
            f"{s_dict:.2f} s (dict), {s_raw:.2f} s (raw)")

        # the second request, with max_age: auth_time is the Python
        # rules', so every accepted token falls back
        ma_req = Request(3600, OIDC_REDIRECT, state="st-oidc-ma",
                         nonce=OIDC_NONCE, audiences=[client, OIDC_AUD2],
                         max_age=600, now_func=now)
        sl = tokens[:N_OIDC_MAX_AGE]
        claims_native.reset_counts()
        ma = p.verify_id_token_batch(sl, ma_req, raw=True)
        check_oidc(ma, expected_raw[:N_OIDC_MAX_AGE], sl, raw=True)
        ma_acc = sum(isinstance(v, bytes) for v in ma)
        assert claims_native.native_fallbacks >= ma_acc > 0, \
            (claims_native.native_fallbacks, ma_acc)
        check_oidc(p.verify_id_token_batch(sl, ma_req),
                   expected[:N_OIDC_MAX_AGE], sl, raw=False)
        log(f"oidc path, max_age request: {len(sl)} tokens, every verdict "
            f"as expected in both modes; {ma_acc} accepted, all through "
            f"the Python rules ({claims_native.native_fallbacks} "
            f"fallbacks, {claims_native.native_validated} native rejects)")

        # the all-accepted slice: the native rules take every token
        good = [t for t, e in zip(tokens, expected)
                if not isinstance(e, tuple)][:N_OIDC_GOOD_SLICE]
        claims_native.reset_counts()
        out = p.verify_id_token_batch(good, req, raw=True)
        assert all(isinstance(v, bytes) for v in out)
        assert (claims_native.native_validated,
                claims_native.native_fallbacks) == (len(good), 0), \
            (claims_native.native_validated, claims_native.native_fallbacks)
        log(f"oidc path, all-accepted slice: {len(good)} tokens, native "
            f"rules {claims_native.native_validated}, fallbacks "
            f"{claims_native.native_fallbacks}")

        # warm: dict, raw and verify_batch_raw alone, in turns
        t_d, t_r, t_v = [], [], []
        for _ in range(WARM_SLOW):
            for fn, acc in ((lambda: p.verify_id_token_batch(tokens, req),
                             t_d),
                            (lambda: p.verify_id_token_batch(tokens, req,
                                                             raw=True), t_r),
                            (lambda: ks.verify_batch_raw(tokens), t_v)):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                acc.append(time.perf_counter() - t0)
        # the native rules call alone, on the accepted tokens' payloads
        raws = ks.verify_batch_raw(tokens)
        acc_idx = [i for i, v in enumerate(raws) if isinstance(v, bytes)]
        payloads = [raws[i] for i in acc_idx]
        es_id = ALG_NAMES.index("ES256")
        alg_ok = (pb.alg_id[acc_idx] == es_id).astype(np.uint8)
        blob = p._policy_blob(req)
        t_rules = []
        for _ in range(3):
            t0 = time.perf_counter()
            claims_native.validate_payloads(payloads, alg_ok, now(), blob)
            t_rules.append(time.perf_counter() - t0)
        card = card_line()
        n = len(tokens)
        vps = [n / min(t) for t in (t_d, t_r, t_v)]
        log(f"oidc path warm ({card}): dict {', '.join(f'{t:.3f}' for t in t_d)}"
            f" s, best {vps[0]:.0f} verifies/s; raw "
            f"{', '.join(f'{t:.3f}' for t in t_r)} s, best {vps[1]:.0f} "
            f"verifies/s; verify_batch_raw alone "
            f"{', '.join(f'{t:.3f}' for t in t_v)} s, best {vps[2]:.0f} "
            f"verifies/s; raw / verify_batch_raw {vps[1] / vps[2]:.3f}, "
            f"dict / verify_batch_raw {vps[0] / vps[2]:.3f}; native rules "
            f"alone {min(t_rules) / len(payloads) * 1e6:.3f} µs/token over "
            f"{len(payloads)} payloads (best of "
            f"{', '.join(f'{t * 1e3:.1f}' for t in t_rules)} ms)")
        batch_breakdown(ks, tokens)
        profile_batch(ks, tokens, min(t_v))

        # every unique token against the single-token verify_id_token
        first = {}
        for i, tok in enumerate(tokens):
            first.setdefault(tok, i)
        uniq_toks = list(first)
        n_proc = len(os.sched_getaffinity(0))
        t0 = time.perf_counter()
        with multiprocessing.get_context("spawn").Pool(
                n_proc, _oidc_check_init,
                (os.path.dirname(os.path.abspath(__file__)), idp.issuer(),
                 idp.ca_cert(), client, idp.client_secret, req.state(),
                 req.audiences())) as pool:
            parts = pool.map_async(
                _oidc_check_tokens,
                [uniq_toks[k::4 * n_proc] for k in range(4 * n_proc)]
            ).get(600)
        singles = {}
        for k, part in enumerate(parts):
            for tok, v in zip(uniq_toks[k::4 * n_proc], part):
                singles[tok] = v
        bad = []
        for tok in uniq_toks:
            batch = _verdict(res_d[first[tok]])
            single = singles[tok]
            if isinstance(batch, dict) or isinstance(single, dict):
                ok = batch == single
            elif batch[0] == "InvalidSignatureError":
                # the prep's and parse_jws's parse messages differ; a
                # kid no key has is UnknownKeyIDError, a subclass
                ok = issubclass(getattr(errors, single[0]),
                                errors.InvalidSignatureError)
            else:
                ok = batch == single
            if not ok:
                bad.append((first[tok], batch, single))
        assert not bad, f"{len(bad)} unique tokens differ, first {bad[:3]}"
        log(f"oidc path: {len(uniq_toks)} unique tokens, each verdict equal "
            f"to Provider(JSONWebKeySet).verify_id_token's in "
            f"{time.perf_counter() - t0:.1f} s on {n_proc} processes")
    log(f"oidc path: phase {time.perf_counter() - t_phase:.1f} s "
        f"({card_line()})")


# ---------------------------------------------------------------------------
# the serve path: the verify worker on the card
# ---------------------------------------------------------------------------

SERVE_CONNS = 4
SERVE_MAX_REQUEST = 4096
SERVE_GRACE_S = 2.0
# the traffic that flows while the KEYS push lands: small enough that
# the grace-window request does not queue behind seconds of it
SERVE_BACKGROUND = 8192
SERVE_WAIT_S = 120.0
# the requests replayed under the profiler for the device's busy share
SERVE_PROFILED = 16384


def spans_upto(spans, n_tokens: int) -> int:
    """How many of the leading spans end within the first n_tokens (at
    least one)."""
    return max(1, sum(hi <= n_tokens for _, hi in spans))


def serve_spans(rng, n_tokens: int):
    """Request spans of 1 to SERVE_MAX_REQUEST tokens covering n_tokens."""
    spans, lo = [], 0
    while lo < n_tokens:
        hi = min(n_tokens, lo + rng.randint(1, SERVE_MAX_REQUEST))
        spans.append((lo, hi))
        lo = hi
    return spans


def serve_traffic(addr, tokens, spans, client=None):
    """The spans' requests over SERVE_CONNS connections, each pipelined
    (4 requests in flight), all connections at once: (per-token results
    with accepted payloads as bytes, request latencies in s, wall s).
    ``client(addr)`` opens a connection (default: a raw
    ``VerifyClient``)."""
    import threading

    from cap_tpu_torch.serve.client import VerifyClient

    if client is None:
        def client(a):
            return VerifyClient(*a, timeout=SERVE_WAIT_S, raw=True)

    results = [None] * len(tokens)
    lat, errs = [], []

    def run(mine):
        try:
            sent_at = []
            with client(addr) as c:
                stream = c.verify_stream(
                    (tokens[lo:hi] for lo, hi in mine), depth=4,
                    sent_at=sent_at)
                for i, ((lo, hi), out) in enumerate(zip(mine, stream)):
                    lat.append(time.perf_counter() - sent_at[i])
                    results[lo:hi] = out
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(spans[i::SERVE_CONNS],),
                                daemon=True) for i in range(SERVE_CONNS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_WAIT_S)
    wall = time.perf_counter() - t0
    assert not errs and not any(t.is_alive() for t in threads), errs
    return results, lat, wall


def check_served(results, tokens, expected):
    """Every verdict from the wire as expected: an accepted token's
    payload bytes (its own payload segment, the expected sub), a
    rejected token's "<class>: <message>"."""
    bad = []
    for i, (got, exp) in enumerate(zip(results, expected)):
        if isinstance(exp, tuple):
            ok = (isinstance(got, Exception)
                  and str(got) == f"{exp[0]}: {exp[1]}")
        else:
            ok = (isinstance(got, bytes)
                  and got == unb64(tokens[i].split(".")[1])
                  and json.loads(got).get("sub") == exp)
        if not ok:
            bad.append((i, exp, got))
    assert not bad, f"{len(bad)} wrong verdicts, first: {bad[:3]}"


def wire_form(v):
    """A verdict as the wire carries it: payload bytes or the error's
    "<class>: <message>"."""
    if isinstance(v, Exception):
        return str(v) if type(v).__name__ == "RemoteVerifyError" else \
            f"{type(v).__name__}: {v}"
    return v


def serve_keys_push(addr, doc, epoch: int) -> dict:
    """One KEYS push on its own connection; the ack's JSON."""
    import socket

    from cap_tpu_torch.serve import protocol

    with socket.create_connection(addr, timeout=SERVE_WAIT_S) as s:
        protocol.send_keys_push(s, doc, epoch)
        ftype, entries = protocol.recv_frame(s)
    assert ftype == protocol.T_KEYS_ACK and entries[0][0] == 0, entries
    return json.loads(entries[0][1])


def serve_worker_main(jwks, tokens, expected, args=(), client=None):
    """``python -m cap_tpu_torch.fleet.worker_main --keyset
    jwks:<file> [args]`` on the card: its ready line, one request
    (``client(port)``: a raw ``VerifyClient`` by default), SIGTERM,
    exit 0. Returns the ready line's fields."""
    import queue
    import signal
    import tempfile
    import threading

    from cap_tpu_torch.jwt.jwk import serialize_public_key
    from cap_tpu_torch.serve.client import VerifyClient

    if client is None:
        def client(port):
            return VerifyClient("127.0.0.1", port, timeout=SERVE_WAIT_S,
                                raw=True)

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="cap-serve-")
    path = os.path.join(tmp, "jwks.json")
    with open(path, "w") as f:
        json.dump({"keys": [serialize_public_key(j.key, kid=j.kid)
                            for j in jwks]}, f)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cap_tpu_torch.fleet.worker_main",
         "--keyset", f"jwks:{path}", "--drain-deadline-s", "30", *args],
        cwd=here, env=dict(os.environ, PYTHONPATH=here),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        ready = lines.get(timeout=SERVE_WAIT_S)
        boot_s = time.perf_counter() - t0
        assert ready.startswith("CAP_FLEET_READY port="), ready
        fields = dict(kv.split("=", 1) for kv in ready.split()[1:])
        assert fields["pid"] == str(proc.pid), ready
        with client(int(fields["port"])) as c:
            got = c.verify_batch(tokens)
        check_served(got, tokens, expected)
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        assert rc == 0, (rc, proc.stderr.read()[-2000:])
        over = getattr(c, "transport", "socket")
        log(f"serve worker_main{''.join(' ' + a for a in args)}: "
            f"{ready.strip()} after {boot_s:.1f} s; {len(tokens)} tokens "
            f"verified as expected over the {over} transport; SIGTERM "
            f"drained and exited 0 in {time.perf_counter() - t1:.1f} s")
        return fields
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
        os.unlink(path)
        os.rmdir(tmp)


def serve_pass(records, ks, north, spans, name, direct=None, client=None,
               **worker_kw):
    """One measured pass of the north-star's tokens through
    ``VerifyWorker(ks, vcache=False, dedup=False, **worker_kw)`` (a
    warm request first): every verdict as expected and equal to
    ``direct`` (``verify_batch_raw``'s, computed here when None), the
    ladder launches equal to the ES chunks the keyset counted (11 redc
    each), verifies/s, p50/p99 and the device's idle share under the
    profiler over the first SERVE_PROFILED tokens' requests. Returns
    (the pass's figures, ``direct``)."""
    import torch

    from cap_tpu_torch import telemetry
    from cap_tpu_torch.serve.worker import VerifyWorker

    tokens, expected = north["tokens"], north["expected"]
    ctr = counters()
    with telemetry.recording() as rec:
        # the native chain's telemetry plane attaches at construction
        worker = VerifyWorker(ks, vcache=False, dedup=False, **worker_kw)
        try:
            serve_traffic(worker.address, tokens[:4096], [(0, 4096)],
                          client)  # warm
            lanes0 = rec.summary().get("device.es.lanes", {}).get("count", 0)
            n0 = rec.counters().get("verify_batch.tokens", 0)
            f0 = rec.counters().get("batcher.flushes", 0)
            native0 = worker._native.counters() if worker._native else {}
            if worker._native is not None:
                worker._native.ring_hwm(reset=True)
            for mod, attr in ctr.values():
                setattr(mod, attr, 0)
            results, lat, wall = serve_traffic(worker.address, tokens, spans,
                                               client)
            torch.cuda.synchronize()
            launches = {k: getattr(mod, attr)
                        for k, (mod, attr) in ctr.items()}
            chunks = int(rec.summary()["device.es.lanes"]["count"] - lanes0)
            n_card = rec.counters()["verify_batch.tokens"] - n0
            flushes = rec.counters()["batcher.flushes"] - f0
            native = {}
            if worker._native is not None:
                after = worker._native.counters()
                native = {k: after[k] - native0.get(k, 0) for k in after}
                native["ring_hwm"] = worker._native.ring_hwm(reset=False)
            check_served(results, tokens, expected)
            want = {k: ES_LAUNCHES.get(k, 0) * chunks for k in ctr}
            assert launches == want and chunks > 0, (launches, want)
            if direct is None:
                direct = [wire_form(v) for v in ks.verify_batch_raw(tokens)]
            assert [wire_form(v) for v in results] == direct, \
                f"served != verify_batch_raw ({name})"
            for k, count in launches.items():
                r = records[k]
                r["launches"] = r.get("launches", 0) + count
                r.setdefault("launches_by_path", {})[name] = count
            n_prof = spans_upto(spans, SERVE_PROFILED)
            with device_profile() as prof:
                _, _, prof_wall = serve_traffic(
                    worker.address, tokens[:spans[n_prof - 1][1]],
                    spans[:n_prof], client)
                torch.cuda.synchronize()
            busy_ms = sum(us for _, us in device_events(prof).values()) / 1e3
            if worker.obs_address is not None:
                # the clock has stopped: STATS and the six endpoints
                obs_scrape(worker.address, worker.obs_address, name)
        finally:
            worker.close(deadline_s=SERVE_WAIT_S)
    lat.sort()
    fig = dict(vps=len(tokens) / wall, wall_s=wall,
               p50_ms=lat[len(lat) // 2] * 1e3,
               p99_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
               device_busy_ms=busy_ms, profiled_wall_s=prof_wall,
               flushes=flushes, chunks=chunks, n_card=n_card,
               launches=launches, native=native,
               idle=(f"{100 - 100 * busy_ms / 1e3 / prof_wall:.1f}% "
                     f"({busy_ms:.1f} ms of device time in {prof_wall:.2f} s "
                     f"under the profiler)") if busy_ms else "not measured")
    records.setdefault(name, {}).update(
        {k: v for k, v in fig.items() if k not in ("launches", "idle")})
    return fig, direct


def serve_keys_pass(ks, north, rng, drop, new, worker_kw, label):
    """The deployed defaults (verdict cache on, a SERVE_GRACE_S KEYS
    grace) on ``VerifyWorker(ks, **worker_kw)``: a KEYS push mid-stream
    that drops the kids ``drop`` (an RSA and an EC one) and adds the
    kids ``new`` (keys made here); tokens under the dropped kids
    accepted inside the grace and rejected after the keyset's retire
    counter moves (the grace window's accepts replayed too: the cache
    kept none), tokens under the new kids accepted, STATS at the new
    epoch; one request replayed from the verdict cache (the keyset's
    token counter does not grow)."""
    import threading

    from cap_tpu_torch import telemetry
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.jwt import algs
    from cap_tpu_torch.jwt.jwk import serialize_public_key
    from cap_tpu_torch.serve.worker import VerifyWorker

    tokens, expected = north["tokens"], north["expected"]
    signers = dict(north["keys"])
    made = {new[0]: tt.generate_rsa_key(rng), new[1]: tt.generate_ec_key(rng)}
    signers.update(made)

    def signed(kid, n, tag, now=1_700_000_000):
        alg = algs.RS256 if kid.startswith("rs") else algs.ES256
        return [tt.sign_jwt(signers[kid], alg,
                            tt.default_claims(now=now,
                                              sub=f"{tag}-{kid}-{i}"),
                            kid=kid, rng=rng) for i in range(n)]

    # the grace window's tokens live (the cache keeps an accept only
    # before its exp)
    now = int(time.time())
    during = signed(drop[0], 4, "during", now=now) \
        + signed(drop[1], 4, "during", now=now)
    after = signed(drop[0], 4, "after") + signed(drop[1], 4, "after")
    fresh = signed(new[0], 4, "new") + signed(new[1], 4, "new")
    pub = {k: v for k, v in north["pub"].items() if k not in drop}
    pub.update({k: made[k].public_key() for k in new})
    kept = sorted(k for k in pub if k not in new)
    live = [t for k in ([k for k in kept if k.startswith("rs")][:2]
                        + [k for k in kept if k.startswith("es")][:2])
            for t in signed(k, 8, "live", now=now)]
    keys = [serialize_public_key(key, kid=k) for k, key in pub.items()]
    sub = [json.loads(unb64(t.split(".")[1]))["sub"] for t in
           during + after + fresh]

    def subs(out):
        return [json.loads(v)["sub"] if isinstance(v, bytes) else str(v)
                for v in out]

    load = tokens[:SERVE_BACKGROUND]

    worker = VerifyWorker(ks, keys_grace_s=SERVE_GRACE_S, **worker_kw)
    stream_errs = []

    def background():
        try:
            serve_traffic(worker.address, load,
                          serve_spans(rng, len(load)))
        except Exception as e:  # noqa: BLE001 - raised below
            stream_errs.append(e)

    from cap_tpu_torch.serve.client import VerifyClient

    try:
        with telemetry.recording() as rec:
            epoch0 = ks.key_epoch
            retired0 = rec.counters().get("keyplane.grace_retired", 0)
            bg = threading.Thread(target=background, daemon=True)
            bg.start()
            t0 = time.perf_counter()
            ack = serve_keys_push(worker.address, {"keys": keys},
                                  epoch0 + 1)
            swap_s = time.perf_counter() - t0
            with VerifyClient(*worker.address, timeout=SERVE_WAIT_S,
                              raw=True) as c:
                got_during = subs(c.verify_batch(during + fresh))
                during_s = time.perf_counter() - t0
                in_grace = rec.counters().get("keyplane.grace_retired",
                                              0) - retired0
                bg.join(SERVE_WAIT_S)
                assert not bg.is_alive() and not stream_errs, stream_errs
                deadline = time.perf_counter() + SERVE_WAIT_S
                while rec.counters().get("keyplane.grace_retired",
                                         0) - retired0 < 1:
                    assert time.perf_counter() < deadline, \
                        "grace never retired"
                    time.sleep(0.05)
                retire_s = time.perf_counter() - t0
                # the grace window's accepts again, beside tokens never
                # sent: the verdict cache kept none of them
                got_after = subs(c.verify_batch(during + after + fresh))
                stats = c.stats()
                # the cache: one request twice; the second never reaches
                # the keyset. Accepts are cached only while their exp is
                # ahead of the clock (the north-star's expired in 2023),
                # so the request is tokens signed now beside the
                # north-star's rejected ones.
                replay = live + [t for t, e in zip(tokens, expected)
                                 if isinstance(e, tuple)][:256]
                first = c.verify_batch(replay)
                n0 = rec.counters()["verify_batch.tokens"]
                second = c.verify_batch(replay)
                n1 = rec.counters()["verify_batch.tokens"]
                hits = rec.counters().get("vcache.hits", 0)
    finally:
        worker.close(deadline_s=SERVE_WAIT_S)
    n = len(during)
    assert ack == {"epoch": epoch0 + 1} and in_grace == 0, (
        ack, in_grace, f"acked {swap_s:.2f} s, the grace request answered "
        f"{during_s:.2f} s, retired {retire_s:.2f} s after the push")
    assert got_during == sub[:n] + sub[2 * n:], got_during
    assert got_after == [f"InvalidSignatureError: {REJECT[1]}"] * 2 * n \
        + sub[2 * n:], got_after
    assert stats["key_epoch"] == ks.key_epoch == epoch0 + 1, stats
    assert stats["serve_chain"] == worker.serve_chain, stats
    assert n1 == n0 and hits >= len(replay), (n0, n1, hits)
    assert [wire_form(v) for v in first] == [wire_form(v) for v in second]
    log(f"serve keys{label}: KEYS push mid-stream (epoch {epoch0} -> "
        f"{epoch0 + 1}, {' and '.join(drop)} dropped, {' and '.join(new)} "
        f"added) acked in {swap_s:.2f} s; {n} tokens under the dropped kids "
        f"accepted in the {SERVE_GRACE_S} s grace (answered "
        f"{during_s:.2f} s after the push), they and {n} more rejected "
        f"after the keyset's retire counter moved ({retire_s:.2f} s after "
        f"the push; the verdict cache on, holding none of the grace's "
        f"accepts); {len(fresh)} under the new kids accepted; STATS at "
        f"epoch {stats['key_epoch']}; a {len(replay)}-token request "
        f"replayed from the verdict cache ({hits} hits, the keyset's "
        f"token counter unchanged at {n1})")
    north["keys"] = {k: v for k, v in signers.items() if k not in drop}
    north["pub"] = pub


def retired_kid_cost(ks, tokens, drop, held_kids, n=256):
    """The host time of tokens under kids that a KEYS push retired:
    ``verify_batch_raw`` of the first ``n`` north-star tokens under the
    kids ``drop`` (no key holds their kid any more, so the trial path
    tries each key of their alg on the host oracle; every one
    rejected), beside ``n`` tokens under ``held_kids``, which the
    keyset holds."""
    heads = {}

    def kid(t):
        seg = t.split(".", 1)[0]
        if seg not in heads:
            try:
                heads[seg] = json.loads(unb64(seg)).get("kid")
            except (ValueError, AttributeError):
                heads[seg] = None
        return heads[seg]

    gone = [t for t in tokens if kid(t) in drop][:n]
    held = [t for t in tokens if kid(t) in held_kids][:n]
    assert len(gone) == len(held) == n, (len(gone), len(held))
    ks.verify_batch_raw(held)  # warm
    walls = []
    for batch in (gone, held):
        t0 = time.perf_counter()
        out = ks.verify_batch_raw(batch)
        walls.append(time.perf_counter() - t0)
        if batch is gone:
            assert all(isinstance(v, Exception) for v in out), \
                [v for v in out if not isinstance(v, Exception)][:2]
    log(f"serve retired kids: {n} north-star tokens under "
        f"{' and '.join(drop)}, which the push retired, rejected by "
        f"verify_batch_raw in {walls[0]:.3f} s (the trial path on the host "
        f"oracle, {walls[0] / n * 1e3:.2f} ms a token), against "
        f"{walls[1]:.3f} s for {n} under held kids")


def shm_plan(spans, tokens):
    """(ring bytes, region directory) for SERVE_CONNS shm connections:
    each ring holds two of the largest request frames (a frame may take
    half a ring). The directory is this run's own, made empty in
    /dev/shm when /dev/shm has room for every region twice, else under
    TMPDIR; the caller checks that it is empty again and removes it.
    Logs /dev/shm's size and free bytes."""
    import tempfile

    largest = max(9 + sum(4 + len(t) for t in tokens[lo:hi])
                  for lo, hi in spans)
    ring = 1 << (2 * largest - 1).bit_length()
    need = SERVE_CONNS * (4096 + 2 * ring)
    try:
        st = os.statvfs("/dev/shm")
        size, free = st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize
    except OSError:
        size = free = 0
    shm_dir = tempfile.mkdtemp(prefix="cap-shm-run-",
                               dir="/dev/shm" if free >= 2 * need else None)
    log(f"serve shm: /dev/shm size {size} bytes, {free} free; the largest "
        f"request frame {largest} bytes, so rings of {ring} bytes, "
        f"{need} bytes for {SERVE_CONNS} connections' regions, in "
        f"{shm_dir}")
    return ring, shm_dir


def serve_line(fig, what: str) -> str:
    return (f"{fig['vps']:.0f} verifies/s {what} ({fig['wall_s']:.3f} s); "
            f"request latency p50 {fig['p50_ms']:.1f} ms, p99 "
            f"{fig['p99_ms']:.1f} ms; device idle {fig['idle']}; "
            f"{fig['flushes']} batcher flushes, {fig['chunks']} ES chunk(s) "
            f"by the keyset's counter, launches {fig['launches']}")


def serve_path(records, north):
    """The north-star's keys and tokens through the verify worker on
    the card.

    1. ``VerifyWorker(GPUBatchKeySet(jwks))`` on loopback, raw claims
       and the async pipeline, the verdict cache and dedup off so every
       token reaches the card: the 65,536-token batch as requests of 1
       to 4,096 tokens over 4 pipelined ``VerifyClient`` connections
       (``serve_pass``) on the Python chain, then on the native chain
       (``serve_native=True``, its telemetry plane on), then over the
       shm transport on the native chain (4 pipelined
       ``ShmVerifyClient`` connections, rings sized from the largest
       frame): each pass's verdicts as expected and equal to
       ``verify_batch_raw``, its launches and its line;
    2. the deployed defaults (``serve_keys_pass``) on the Python chain
       (rs-0 and es-0 dropped, rs-new and es-new added), the host time
       of tokens under the retired kids (``retired_kid_cost``), then
       the same push and background on the native chain over a fresh
       ``GPUBatchKeySet(jwks)``;
    3. ``python -m cap_tpu_torch.fleet.worker_main`` on the card, then
       with ``--serve-chain native --transport shm`` and one shm
       request.
    """
    import shutil

    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.serve.shm_client import ShmVerifyClient

    rng = random.Random(SEED + 14)
    jwks, tokens, expected = north["jwks"], north["tokens"], north["expected"]
    spans = serve_spans(rng, len(tokens))
    ks = GPUBatchKeySet(jwks)
    served = dict(north, keys={kid: priv for priv, _, kid in north["signers"]},
                  pub={j.kid: j.key for j in jwks})

    # 1. every token to the card: the Python chain, the native chain,
    # the shm transport
    fig, direct = serve_pass(records, ks, served, spans, "serve",
                             obs_port=0)
    log(f"serve path: {len(tokens)} tokens as {len(spans)} requests of "
        f"1-{SERVE_MAX_REQUEST} tokens over {SERVE_CONNS} pipelined "
        f"connections, {fig['n_card']} tokens to the card; every verdict as "
        f"expected and equal to verify_batch_raw; observed host-to-device "
        f"rate " + (f"{ks._wire_bps / 1e9:.2f} GB/s" if ks._wire_bps
                    else "not measured") + " (the records' timed copies)")
    log(f"serve path line: {serve_line(fig, 'over the socket')}; card: "
        f"{card_line()}")
    fig, _ = serve_pass(records, ks, served, spans, "serve-native",
                        direct=direct, serve_native=True, obs_port=0)
    nat = fig["native"]
    line = serve_line(fig, "over the socket, native chain")
    log(f"serve native line: {line}; native counters: "
        f"{nat['serve.native.frames']} frames, "
        f"{nat['serve.native.tokens']} tokens, ring high-water mark "
        f"{nat['ring_hwm']} tokens, {nat['serve.native.protocol_errors']} "
        f"protocol errors; card: {card_line()}")
    # (the warm request too)
    ring, shm_dir = shm_plan(spans + [(0, 4096)], tokens)

    def shm_client(addr):
        c = ShmVerifyClient(*addr, timeout=SERVE_WAIT_S, raw=True,
                            ring_bytes=ring, shm_dir=shm_dir)
        assert c.transport == "shm", c.attach_error
        return c

    try:
        fig, _ = serve_pass(records, ks, served, spans, "serve-shm",
                            direct=direct, client=shm_client,
                            serve_native=True, transport="shm")
        assert not os.listdir(shm_dir), "regions left behind"
    finally:
        shutil.rmtree(shm_dir, ignore_errors=True)
    nat = fig["native"]
    line = serve_line(fig, "over shm rings, native chain")
    log(f"serve shm line: {line}; native counters: "
        f"{nat['serve.shm.attaches']} attaches, "
        f"{nat['serve.shm.frames']} shm frames, {nat['serve.native.tokens']} "
        f"tokens, ring high-water mark {nat['ring_hwm']} tokens, "
        f"{nat['serve.shm.stale_gen']} stale generations; card: "
        f"{card_line()}")

    # 2. the deployed defaults on both chains, each on a keyset that
    # holds every north-star kid, with the same push and background
    fresh = dict(served, keys=dict(served["keys"]), pub=dict(served["pub"]))
    serve_keys_pass(ks, served, rng, ("rs-0", "es-0"), ("rs-new", "es-new"),
                    {}, "")
    retired_kid_cost(ks, tokens, ("rs-0", "es-0"), served["pub"])
    ks = GPUBatchKeySet(jwks)
    serve_keys_pass(ks, fresh, rng, ("rs-0", "es-0"), ("rs-new", "es-new"),
                    {"serve_native": True}, " (native chain)")

    # 3. the process entry point, on either chain and transport
    probe = tokens[:64] + [t for t, e in zip(tokens, expected)
                           if isinstance(e, tuple)][:8]
    probe_exp = expected[:64] + [e for e in expected
                                 if isinstance(e, tuple)][:8]
    serve_worker_main(jwks, probe, probe_exp)
    ring, shm_dir = shm_plan([(0, len(probe))], probe)
    try:
        fields = serve_worker_main(
            jwks, probe, probe_exp,
            ("--serve-chain", "native", "--transport", "shm"),
            lambda port: shm_client(("127.0.0.1", port)))
        assert not os.listdir(shm_dir), "regions left behind"
    finally:
        shutil.rmtree(shm_dir, ignore_errors=True)
    assert (fields["serve_chain"], fields["transport"]) == \
        ("native", "shm"), fields


# ---------------------------------------------------------------------------
# the obs scrape of a serving worker (serve path) and the fleet path
# ---------------------------------------------------------------------------

PROM_LINE = (r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{quantile="[0-9.]+"\})? '
             r'[-+]?([0-9.]+([eE][-+]?[0-9]+)?|inf|nan)$')
OBS_PATHS = ("/healthz", "/metrics", "/snapshot", "/flight", "/decisions",
             "/tenants")


def http_get(addr, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{path}",
                                timeout=SERVE_WAIT_S) as r:
        return r.read().decode()


def stats_frame(addr) -> dict:
    """One STATS request on its own connection; its JSON."""
    import socket

    from cap_tpu_torch.serve import protocol

    with socket.create_connection(addr, timeout=SERVE_WAIT_S) as s:
        protocol.send_stats_request(s)
        ftype, entries = protocol.FrameReader(s).recv_frame()
    assert ftype == protocol.T_STATS_RESP, ftype
    return json.loads(entries[0][1])


def worker_counters(counters: dict) -> dict:
    return {k: v for k, v in counters.items()
            if k.startswith(("worker.", "decision."))}


def obs_scrape(addr, obs_addr, what: str) -> dict:
    """A STATS frame, then the worker's six HTTP endpoints: the
    scrape's worker and decision counters equal to STATS', the device's
    dispatches and busy time above zero, /metrics Prometheus text
    (every sample line a name, an optional quantile label and a
    number), /tenants' exact lookups = attributed + overflow. Returns
    the /snapshot document."""
    import re

    stats = stats_frame(addr)
    t0 = time.perf_counter()
    got = {p: http_get(obs_addr, p) for p in OBS_PATHS}
    scrape_s = time.perf_counter() - t0
    assert json.loads(got["/healthz"]) == {"ok": True}
    snap = json.loads(got["/snapshot"])
    counters = snap["snapshot"]["counters"]
    assert worker_counters(counters) == worker_counters(stats["counters"]), \
        f"{what}: the scrape's counters differ from STATS'"
    assert stats["obs_port"] == obs_addr[1], stats["obs_port"]
    assert counters.get("device.dispatches", 0) > 0 and \
        counters.get("device.busy_us", 0) > 0, "no device time scraped"
    prom = re.compile(PROM_LINE)
    lines = got["/metrics"].splitlines()
    for line in lines:
        assert (line.startswith("# TYPE ") and line.split()[3] in (
            "counter", "gauge", "summary")) or prom.match(line), line
    tenants = json.loads(got["/tenants"])
    assert tenants["lookups"] == tenants["attributed"] + \
        tenants["overflow"], tenants
    flights = json.loads(got["/flight"])["slowest"]
    decisions = json.loads(got["/decisions"])["decisions"]
    log(f"{what} obs scrape: /healthz, /metrics ({len(lines)} lines, "
        f"Prometheus text), /snapshot, /flight ({len(flights)} traced), "
        f"/decisions ({len(decisions)} sampled), /tenants "
        f"({len(tenants['tenants'])} tenants, {tenants['lookups']} lookups) "
        f"in {scrape_s * 1e3:.1f} ms; {len(worker_counters(counters))} worker "
        f"and decision counters equal to the STATS frame's "
        f"(worker.tokens {counters.get('worker.tokens', 0)}, "
        f"decision.serve.accept {counters.get('decision.serve.accept', 0)}); "
        f"device.dispatches {counters['device.dispatches']}, "
        f"device.busy_us {counters['device.busy_us']}")
    return snap


FLEET_REFRESH_S = 1.0         # the keyplane's poll
FLEET_GRACE_S = 2.0           # a pull rotation's grace
FLEET_REQUESTS = 24           # routed requests, half to each worker
FLEET_MIN_REQUEST = 64
FLEET_MAX_REQUEST = 384
FLEET_SUBMITTERS = 4          # threads calling FleetClient.verify_batch
FLEET_DROPPED = 8             # tokens a dropped kid (rs-0, es-0)
FLEET_NEW = 8                 # tokens a new kid
FLEET_CRASH_REQUESTS = 8      # the stream the kill -9 lands in
FLEET_WAIT_S = 120.0
# each worker's PyTorch threads: half the host's cores, so the CPU
# worker's intra-op threads and the card worker's host threads do not
# spin against each other (a thread a core in each process took a
# 1,554-token dry run of this phase on an 8-core CPU host from 2.6 s to
# 89 s)
FLEET_TORCH_THREADS = max(1, (os.cpu_count() or 2) // 2)


def token_kid(token: str):
    """The kid of a token's header (None: none, or no JSON header)."""
    try:
        return json.loads(unb64(token.split(".", 1)[0])).get("kid")
    except (ValueError, AttributeError):
        return None


def check_routed(results, tokens, expected):
    """Every verdict through the router as expected: an accepted token's
    claims (its own payload segment, the expected sub), a rejected
    token's ``RemoteVerifyError`` "<class>: <message>"."""
    bad = []
    for i, (got, exp) in enumerate(zip(results, expected)):
        if isinstance(exp, tuple):
            ok = (type(got).__name__ == "RemoteVerifyError"
                  and str(got) == f"{exp[0]}: {exp[1]}")
        else:
            ok = (isinstance(got, dict)
                  and got == json.loads(unb64(tokens[i].split(".")[1]))
                  and got.get("sub") == exp)
        if not ok:
            bad.append((i, exp, got))
    assert not bad, f"{len(bad)} wrong verdicts, first: {bad[:3]}"


def routed_form(v):
    """A router verdict in ``wire_form``'s terms (claims as the JSON
    bytes' parse)."""
    return str(v) if isinstance(v, Exception) else v


def direct_form(v):
    return json.loads(v) if isinstance(v, bytes) else v


def fleet_epochs(pool) -> dict:
    """worker_id → the key epoch its own STATS reports (None: no
    answer)."""
    return {w: (s or {}).get("key_epoch") for w, s in pool.stats().items()}


def fleet_wait(what: str, cond, timeout: float = FLEET_WAIT_S) -> float:
    """Seconds until ``cond()`` holds; fails the run after
    ``timeout``."""
    t0 = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t0 < timeout, f"timed out: {what}"
        time.sleep(0.05)
    return time.perf_counter() - t0


def fleet_close(pool):
    """Close the pool within a deadline, every worker gone."""
    import threading

    t1 = time.perf_counter()
    closer = threading.Thread(target=pool.close, daemon=True)
    closer.start()
    closer.join(FLEET_WAIT_S)
    assert not closer.is_alive(), "the pool did not close"
    assert all(h.proc is None or h.proc.poll() is not None
               for h in pool._handles), "a worker outlived close"
    log(f"fleet: pool closed in {time.perf_counter() - t1:.1f} s")


def fleet_path(records, north):
    """The north-star's keys and tokens through the fleet on one card.

    1. the port's ``testing.jwks_test_server`` serves the north-star's
       JWKS on loopback (ETags on);
    2. a ``WorkerPool`` of two ``python -m cap_tpu_torch.fleet.
       worker_main --keyset jwks-url:<url>`` processes: worker 0 owns
       the card (``WorkerPlacement(0, (0,), "cuda")``), worker 1 runs
       on the CPU (``CUDA_VISIBLE_DEVICES=""``, ``--device cpu``), a
       FLEET_REFRESH_S keyplane poll, a FLEET_GRACE_S grace, the obs
       server on; ``FleetClient(pool, fallback=None)`` in front;
    3. FLEET_REQUESTS seeded requests of the north-star's tokens from
       FLEET_SUBMITTERS threads: every verdict as expected and equal to
       ``verify_batch_raw`` on the card; the tokens each worker served;
       the card worker's /snapshot showing its ES chunks on the card;
    4. a pull rotation at the source (rs-0 and es-0 out, a new RSA-2048
       and P-256 key in): each worker's swap read from its STATS; the
       dropped kids' tokens accepted on each worker inside the grace
       and rejected through the router after it, the new kids' tokens
       accepted;
    5. a push rotation: ``pool.push_keys`` of the served JWKS at the
       next epoch reaching both workers;
    6. ``chaos.kill9`` of the card worker in the middle of a stream of
       requests: every verdict right, no ``FleetExhaustedError``, the
       pool respawning it onto the card, the epochs reconverging, its
       postmortem collected with its flight ring and counters and no
       token's signature segment;
    7. the SLO defaults over ``pool.stats_merged()``: no wrong verdict,
       and no breach but tenant "none"'s reject ratio where the routed
       tokens without an issuer (all expected rejected) reach a worker;
    8. the "fleet line"; 9. the pool closed within a deadline, when
       the stack this returns closes (after the front door's phase,
       which takes the pool over with the tokens whose kids stayed).
    """
    import threading

    import torch

    from cap_tpu_torch import telemetry
    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.fleet import FleetClient, WorkerPool
    from cap_tpu_torch.fleet.chaos import kill9
    from cap_tpu_torch.jwt import algs
    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet
    from cap_tpu_torch.jwt.jwk import serialize_public_key
    from cap_tpu_torch.obs import decision, slo
    from cap_tpu_torch.parallel import WorkerPlacement
    from cap_tpu_torch.serve.client import VerifyClient

    rng = random.Random(SEED + 16)
    jwks, tokens, expected = north["jwks"], north["tokens"], north["expected"]
    signers = {kid: priv for priv, _, kid in north["signers"]}
    sizes = [rng.randint(FLEET_MIN_REQUEST, FLEET_MAX_REQUEST)
             for _ in range(FLEET_REQUESTS + FLEET_CRASH_REQUESTS)]
    n_routed = sum(sizes[:FLEET_REQUESTS])
    start = rng.randrange(len(tokens) - 2 * sum(sizes))
    sample = tokens[start:start + n_routed]
    sample_exp = expected[start:start + n_routed]
    # after the pull rotation: tokens under kids that stay (the
    # rotation changes no other verdict: every accepted north-star
    # token names its kid)
    for t, e in zip(tokens[start + n_routed:], expected[start + n_routed:]):
        if len(sample) == sum(sizes):
            break
        if token_kid(t) not in ("rs-0", "es-0"):
            sample.append(t)
            sample_exp.append(e)
    spans, lo = [], 0
    for n in sizes:
        spans.append((lo, lo + n))
        lo += n
    crash_spans, spans = spans[FLEET_REQUESTS:], spans[:FLEET_REQUESTS]
    ks = GPUBatchKeySet(jwks)
    direct = [direct_form(wire_form(v)) for v in ks.verify_batch_raw(sample)]
    del ks

    made = {"rs-fleet": tt.generate_rsa_key(rng),
            "es-fleet": tt.generate_ec_key(rng)}
    signers.update(made)

    # live tokens (exp ahead of the clock): a worker's verdict cache
    # would keep their accepts, but for the grace's (ROADMAP C.2)
    now = int(time.time())

    def signed(kid, n, tag):
        alg = algs.RS256 if kid.startswith("rs") else algs.ES256
        return [tt.sign_jwt(signers[kid], alg,
                            tt.default_claims(now=now,
                                              sub=f"{tag}-{kid}-{i}"),
                            kid=kid, rng=rng) for i in range(n)]

    dropped = signed("rs-0", FLEET_DROPPED, "dropped") + \
        signed("es-0", FLEET_DROPPED, "dropped")
    fresh = signed("rs-fleet", FLEET_NEW, "new") + \
        signed("es-fleet", FLEET_NEW, "new")

    def subs(toks):
        return [json.loads(unb64(t.split(".")[1]))["sub"] for t in toks]

    keys = {j.kid: serialize_public_key(j.key, kid=j.kid) for j in jwks}
    state = {"keys": list(keys.values()), "etags": True}
    figs = {}
    stack = contextlib.ExitStack()
    try:
        url, _ = stack.enter_context(tt.jwks_test_server(state))
        rec = stack.enter_context(telemetry.recording())
        # 2. the pool: one card worker beside one CPU worker
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pool = WorkerPool(
            2, keyset_spec=f"jwks-url:{url}",
            placements=[WorkerPlacement(0, (0,), "cuda"),
                        WorkerPlacement(1, (1,), "cpu")],
            keyplane_refresh_s=FLEET_REFRESH_S,
            keyplane_grace_s=FLEET_GRACE_S, ping_interval=0.5,
            spawn_timeout=FLEET_WAIT_S, postmortem_interval=0.5,
            max_restarts=2, drain_grace=20.0,
            worker_args=["--torch-threads", str(FLEET_TORCH_THREADS)])
        stack.callback(fleet_close, pool)
        boot = {}

        def booted():
            for w in (0, 1):
                st = pool.state(w)
                assert st not in ("dead", "failed"), \
                    f"fleet worker {w} did not boot ({st})"
                if st == "ready" and w not in boot:
                    boot[w] = time.perf_counter() - t0
            return len(boot) == 2

        fleet_wait("the pool's boot", booted)
        for w, where in ((0, "the card"), (1, "the CPU")):
            log(f"fleet worker {w} ({where}): "
                f"{pool.ready_line(w)} after {boot[w]:.1f} s")
        assert pool.key_epochs() == {0: 1, 1: 1}, pool.key_epochs()
        try:
            apps = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader"], capture_output=True,
                text=True, timeout=60).stdout.strip().replace(
                    "\n", "; ")
        except (OSError, subprocess.SubprocessError) as e:
            apps = f"not read ({e})"
        log(f"fleet: nvidia-smi compute apps: {apps or 'none listed'} "
            f"(worker pids {pool.pid(0)} on the card, {pool.pid(1)} on "
            f"the CPU)")
        client = FleetClient(pool, fallback=None,
                             total_deadline=FLEET_WAIT_S,
                             attempt_timeout=FLEET_WAIT_S / 2)

        # 3. the traffic
        results = [None] * len(sample)
        lat, errs = [], []
        todo = list(spans)
        lock = threading.Lock()

        def submit():
            try:
                while True:
                    with lock:
                        if not todo:
                            return
                        lo, hi = todo.pop(0)
                    t1 = time.perf_counter()
                    with telemetry.trace():
                        out = client.verify_batch(sample[lo:hi])
                    lat.append(time.perf_counter() - t1)
                    results[lo:hi] = out
            except Exception as e:  # noqa: BLE001 - raised below
                errs.append(e)

        before = {w: (s or {}).get("counters", {}).get(
            "worker.tokens", 0) for w, s in pool.stats().items()}
        threads = [threading.Thread(target=submit, daemon=True)
                   for _ in range(FLEET_SUBMITTERS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(FLEET_WAIT_S)
        wall = time.perf_counter() - t1
        assert not errs and not any(t.is_alive() for t in threads), errs
        check_routed(results[:n_routed], sample, sample_exp)
        assert [routed_form(v) for v in results[:n_routed]] == \
            direct[:n_routed], "routed != verify_batch_raw"
        stats = pool.stats()
        split = {w: s["counters"].get("worker.tokens", 0) - before[w]
                 for w, s in stats.items()}
        assert sum(split.values()) == n_routed and min(
            split.values()) > 0, split
        card_snap = json.loads(http_get(pool.obs_endpoints()[0],
                                        "/snapshot"))["snapshot"]
        es_chunks = int(card_snap["series"].get(
            "device.es.lanes", {}).get("count", 0))
        dispatches = card_snap["counters"].get("device.dispatches", 0)
        assert es_chunks > 0 and dispatches > 0, (es_chunks, dispatches)
        lat.sort()
        figs.update(vps=n_routed / wall, wall_s=wall,
                    p50_ms=lat[len(lat) // 2] * 1e3,
                    p99_ms=lat[min(len(lat) - 1,
                                   int(0.99 * len(lat)))] * 1e3,
                    split=split, es_chunks=es_chunks,
                    boot_s=max(boot.values()))
        log(f"fleet traffic: {n_routed} tokens as {len(spans)} requests "
            f"of {FLEET_MIN_REQUEST}-{FLEET_MAX_REQUEST} from "
            f"{FLEET_SUBMITTERS} threads through FleetClient(pool, "
            f"fallback=None) in {wall:.3f} s; every verdict as expected "
            f"and equal to verify_batch_raw on the card; worker.tokens "
            f"{split[0]} on the card, {split[1]} on the CPU; the card "
            f"worker's /snapshot: {es_chunks} ES chunk(s) by the "
            f"keyset's counter, device.dispatches {dispatches}")

        # 4. pull rotation at the source
        epoch0 = max(fleet_epochs(pool).values())
        state["keys"] = [v for k, v in keys.items()
                         if k not in ("rs-0", "es-0")] + [
            serialize_public_key(made[k].public_key(), kid=k)
            for k in made]
        t1 = time.perf_counter()
        swapped, graced = {}, {}
        while len(graced) < 2:
            assert time.perf_counter() - t1 < FLEET_WAIT_S, \
                "pull rotation never reached every worker"
            for w, e in fleet_epochs(pool).items():
                if e == epoch0 + 1 and w not in swapped:
                    swapped[w] = time.perf_counter() - t1
                    # the worker's swap just landed: the dropped
                    # kids still resolve on it for the grace
                    with VerifyClient(*pool.address(w),
                                      timeout=FLEET_WAIT_S) as c:
                        got = c.verify_batch(dropped)
                    graced[w] = time.perf_counter() - t1 - swapped[w]
                    assert [v["sub"] if isinstance(v, dict) else str(v)
                            for v in got] == subs(dropped), got[:2]
            time.sleep(0.02)
        converge_s = max(swapped.values())
        out = client.verify_batch(fresh)
        assert [v.get("sub") if isinstance(v, dict) else str(v)
                for v in out] == subs(fresh), out[:2]

        def retired():
            return all((s or {}).get("counters", {}).get(
                "keyplane.grace_retired", 0) >= 1
                for s in pool.stats().values())

        retire_s = fleet_wait("the grace's retirement", retired)
        out = client.verify_batch(dropped + fresh)
        assert [str(v) for v in out[:len(dropped)]] == [
            f"InvalidSignatureError: {REJECT[1]}"] * len(dropped), \
            out[:2]
        assert [v["sub"] for v in out[len(dropped):]] == subs(fresh)
        figs["converge_s"] = converge_s
        log(f"fleet pull rotation: rs-0 and es-0 out, rs-fleet and "
            f"es-fleet in at the source; each worker's STATS at epoch "
            f"{epoch0 + 1} after " + ", ".join(
                f"{swapped[w]:.2f} s (worker {w})" for w in (0, 1))
            + f"; {len(dropped)} tokens under the dropped kids accepted "
            f"on each worker inside the {FLEET_GRACE_S} s grace ("
            + ", ".join(f"answered {graced[w]:.2f} s after worker {w}'s "
                        f"swap" for w in (0, 1))
            + f") and rejected through the router after both graces "
            f"retired ({retire_s:.2f} s later); {len(fresh)} under the "
            f"new kids accepted; pool.key_epochs() {pool.key_epochs()} "
            f"(ready lines and KEYS acks)")

        # 5. push rotation
        doc = {"keys": list(state["keys"])}
        t1 = time.perf_counter()
        acks = pool.push_keys(doc, epoch=epoch0 + 2)
        push_s = time.perf_counter() - t1
        assert acks == {0: epoch0 + 2, 1: epoch0 + 2}, acks
        assert pool.epoch_skew() == 0
        assert set(fleet_epochs(pool).values()) == {epoch0 + 2}
        lo, hi = crash_spans[0]
        out = client.verify_batch(fresh + sample[lo:hi])
        assert [routed_form(v) for v in out[len(fresh):]] == \
            direct[lo:hi]
        log(f"fleet push rotation: pool.push_keys at epoch {epoch0 + 2} "
            f"acked by both workers in {push_s:.2f} s, epoch_skew 0, "
            f"STATS epochs {fleet_epochs(pool)}")

        # 6. kill -9 of the card worker mid-stream, once its
        # checkpoint carries traced timelines
        from cap_tpu_torch.obs import postmortem

        victim, pm_path = pool.pid(0), pool.postmortem_path(0)
        fleet_wait("a checkpoint with the flight ring", lambda: (
            postmortem.read_postmortem(pm_path) or {}).get("flight"))
        crash_out, crash_errs = {}, []

        def stream():
            try:
                for i, (lo, hi) in enumerate(crash_spans):
                    with telemetry.trace():
                        crash_out[i] = client.verify_batch(
                            sample[lo:hi])
            except Exception as e:  # noqa: BLE001 - raised below
                crash_errs.append(e)

        th = threading.Thread(target=stream, daemon=True)
        th.start()
        fleet_wait("the stream's first answers",
                   lambda: len(crash_out) >= 2 or not th.is_alive())
        t_kill = time.perf_counter()
        kill9(victim)
        th.join(FLEET_WAIT_S)
        assert not th.is_alive() and not crash_errs, crash_errs
        for i, (lo, hi) in enumerate(crash_spans):
            check_routed(crash_out[i], sample[lo:hi], sample_exp[lo:hi])
            assert [routed_form(v) for v in crash_out[i]] == \
                direct[lo:hi]
        fleet_wait("the card worker's respawn",
                   lambda: pool.state(0) == "ready"
                   and pool.pid(0) != victim)
        respawn_s = time.perf_counter() - t_kill
        fleet_wait("the epochs' reconvergence",
                   lambda: pool.key_epochs() == {0: epoch0 + 2,
                                                 1: epoch0 + 2}
                   and set(fleet_epochs(pool).values())
                   == {epoch0 + 2})
        doc = pool.postmortem(0)
        assert doc is not None and doc["pid"] == victim, doc
        pm_counters = doc["snapshot"]["counters"]
        assert pm_counters.get("worker.tokens", 0) > 0 and doc["flight"]
        raw = json.dumps(doc)
        with open(pm_path) as f:
            raw += f.read()
        sent = sample + dropped + fresh
        leaked = [t for t in set(sent) if len(t.split(".")) == 3
                  and len(t.split(".")[2]) >= 16
                  and t.split(".")[2] in raw]
        assert not leaked, f"{len(leaked)} signature segments leaked"
        out = client.verify_batch(fresh)
        assert [v["sub"] for v in out] == subs(fresh)
        figs["respawn_s"] = respawn_s
        log(f"fleet kill -9: the card worker (pid {victim}) killed "
            f"mid-stream; {sum(len(v) for v in crash_out.values())} "
            f"tokens in {len(crash_spans)} requests all verified as "
            f"expected, no FleetExhaustedError; respawned onto the "
            f"card (pid {pool.pid(0)}, {pool.ready_line(0)}) "
            f"{respawn_s:.1f} s after the kill, epochs "
            f"{pool.key_epochs()} again; its postmortem "
            f"(reason {doc['reason']}, {len(doc['flight'])} traced "
            f"timelines, worker.tokens {pm_counters['worker.tokens']}) "
            f"holds none of the {len(set(sent))} tokens' signature "
            f"segments")

        # 7. SLOs over the merged counters
        merged = pool.stats_merged()["aggregate"]
        results = slo.evaluate_once(merged["snapshot"],
                                    slo.default_rules())
        for line in slo.format_results(results).splitlines():
            log(f"fleet slo: {line}")
        breached = [r["name"] for r in results if not r["ok"]]
        mc = merged["counters"]
        assert mc.get("decision.wrong_verdicts", 0) == 0
        assert rec.counters().get("fleet.fallback_tokens", 0) == 0
        # Tokens without an issuer count under tenant "none": here
        # only the north-star's unsigned and two-segment tokens, all
        # rejected, as their expected verdicts say. The default
        # per-tenant template reads that as tenant "none" burning
        # its rejection budget (ratio 1 against 0.5 at burn 1.5):
        # the one breach the traffic implies, and no other.
        unattributed = [e for t, e in zip(sample, sample_exp)
                        if decision.token_tenant(t)
                        == decision.TENANT_NONE]
        assert all(isinstance(e, tuple) for e in unattributed)
        none_tokens = mc.get("decision.serve.tenant.none.tokens", 0)
        if breached:
            assert breached == ["tenant_reject_ratio[none]"] and \
                0 < none_tokens == mc.get(
                    "decision.serve.tenant.none.reject", 0), breached
        log(f"fleet slo: {len(results)} rules, "
            + (f"one breach, tenant_reject_ratio[none]: "
               f"{none_tokens} unattributed tokens on the workers, "
               f"every one rejected ({len(unattributed)} of the "
               f"routed tokens have no issuer, each expected "
               f"rejected)" if breached else "no breach")
            + f"; decision.wrong_verdicts "
            f"{mc.get('decision.wrong_verdicts', 0)}")
    except BaseException:
        stack.close()
        raise

    # 8. the fleet line
    records.setdefault("fleet", {}).update(figs)
    log(f"fleet line: {figs['vps']:.0f} verifies/s through the router "
        f"({figs['wall_s']:.3f} s); request latency p50 "
        f"{figs['p50_ms']:.1f} ms, p99 {figs['p99_ms']:.1f} ms; split "
        f"{figs['split'][0]} tokens on the card, {figs['split'][1]} on the "
        f"CPU; boot {figs['boot_s']:.1f} s, convergence "
        f"{figs['converge_s']:.2f} s, respawn {figs['respawn_s']:.1f} s; "
        f"card: {card_line()}")
    # the front door's phase takes the pool over; the stack closes it
    # (and the JWKS server) after that phase
    keep = [i for i, t in enumerate(sample)
            if token_kid(t) not in ("rs-0", "es-0")]
    return {"stack": stack, "pool": pool, "epoch": epoch0 + 2,
            "doc": {"keys": list(state["keys"])},
            "tokens": [sample[i] for i in keep],
            "expected": [sample_exp[i] for i in keep],
            "direct": [direct[i] for i in keep]}


FD_UNIQUE = 640               # request positions a chain, each sent twice
FD_REQUEST = 64               # tokens a request
FD_CLIENTS = 2                # client connections a gateway
FD_CRASH_REQUESTS = 8         # the native stream the kill -9 lands in
FD_PROC_TOKENS = 64           # the spec-booted gateway's one request


class PoolHost:
    """One worker of a ``WorkerPool`` presented to a ``FrontDoor`` as a
    pool of its own (a "host"): its endpoints follow the worker's
    respawns; a key push goes through the pool once (its supervisor
    re-pushes stragglers), and each host reports its worker's epoch."""

    def __init__(self, pool, worker_id: int):
        self.pool, self.worker_id = pool, worker_id

    def endpoints(self):
        eps = self.pool.endpoints()
        w = self.worker_id
        return {w: eps[w]} if w in eps else {}

    def push_keys(self, doc, epoch=None):
        if self.pool.keys_epoch() != epoch:
            self.pool.push_keys(doc, epoch=epoch)
        return self.key_epochs()

    def key_epochs(self):
        return {self.worker_id: self.pool.key_epochs()[self.worker_id]}


def host_counters(pool) -> dict:
    """worker_id → (worker.tokens, vcache.hits) from its STATS."""
    out = {}
    for w, st in pool.stats().items():
        c = (st or {}).get("counters", {})
        out[w] = (c.get("worker.tokens", 0), c.get("vcache.hits", 0))
    return out


def cacheable(exp) -> bool:
    """Whether a worker's verdict cache keeps this expected reject
    (accepts of the north-star's tokens are past their exp)."""
    from cap_tpu_torch import errors
    from cap_tpu_torch.obs import decision
    from cap_tpu_torch.serve import vcache

    return isinstance(exp, tuple) and decision.classify(
        getattr(errors, exp[0])(exp[1])) in vcache.CACHEABLE_REJECTS


def frontdoor_gateway_proc(pool, tokens, expected, direct):
    """``python -m cap_tpu_torch.fleet.worker_main --keyset
    frontdoor:pool=…;pool=… --frontdoor-chain native`` over the two
    hosts: its ready line (``frontdoor_chain=native``), one request,
    SIGTERM, exit 0. Returns its seconds to the ready line."""
    import queue
    import signal
    import threading

    from cap_tpu_torch.serve.client import VerifyClient

    here = os.path.dirname(os.path.abspath(__file__))
    eps = pool.endpoints()
    spec = "frontdoor:" + ";".join(f"pool={eps[w][0]}:{eps[w][1]}"
                                   for w in (0, 1))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cap_tpu_torch.fleet.worker_main",
         "--keyset", spec, "--frontdoor-chain", "native",
         "--obs-port", "-1"],
        cwd=here, env=dict(os.environ, PYTHONPATH=here),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        ready = lines.get(timeout=FLEET_WAIT_S)
        boot_s = time.perf_counter() - t0
        fields = dict(kv.split("=", 1) for kv in ready.split()[1:])
        assert ready.startswith("CAP_FLEET_READY") and fields.get(
            "frontdoor_chain") == "native", ready
        with VerifyClient("127.0.0.1", int(fields["port"]),
                          timeout=FLEET_WAIT_S) as c:
            got = c.verify_batch(tokens)
        check_routed(got, tokens, expected)
        assert [routed_form(v) for v in got] == direct
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        assert rc == 0, (rc, proc.stderr.read()[-2000:])
        log(f"frontdoor worker_main --keyset {spec} --frontdoor-chain "
            f"native: {ready.strip()} after {boot_s:.1f} s; "
            f"{len(tokens)} tokens verified as expected; SIGTERM, exit 0")
        return boot_s
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def frontdoor_path(records, fleet):
    """The front door over the fleet phase's two workers, each a host.

    1. ``python -m cap_tpu_torch.fleet.worker_main --keyset
       frontdoor:pool=…;pool=… --frontdoor-chain native``: its ready
       line, one request, SIGTERM;
    2. two gateways over the hosts (``PoolHost``: worker 0 on the card,
       worker 1 on the CPU), each ``FrontDoor(hosts, fallback=None)``
       with the default routing (affinity, spill 1.25, 64 virtual
       nodes): the Python gate ``VerifyWorker(FrontDoor, vcache=False)``
       (no cache of its own, so every send reaches a host) and the
       native relay ``NativeFrontDoorServer(FrontDoor)``;
    3. through each, FD_UNIQUE of the fleet's north-star tokens whose
       kids stayed, as requests of FD_REQUEST over FD_CLIENTS
       connections, then the same requests again: every verdict as
       expected and equal to ``verify_batch_raw`` on the card; each
       host's STATS tokens equal to what the ring gives it (plus what
       spilled to it, less what spilled away); ``frontdoor.lookups ==
       affinity_hits + affinity_misses``; on each host the repeats of
       the cacheable rejects hit its verdict cache; the card worker's
       ES chunks counted in its /snapshot; the relay's choices
       (``probe_route``) the ring's;
    4. kill -9 of the CPU worker in the middle of FD_CRASH_REQUESTS
       requests through the native gate: every verdict right, its
       tokens re-routed to the card (``frontdoor.reroutes``, the relay's
       upstream failures or dead-pool frames counted); after the
       respawn the ring's owner serves its tokens again;
    5. ``FrontDoor.push_keys`` at the next epoch: both hosts at it,
       ``epoch_skew() == 0``, each worker's STATS at it;
    6. the "frontdoor line"."""
    import statistics
    import threading

    from cap_tpu_torch.fleet import FrontDoor
    from cap_tpu_torch.fleet.chaos import kill9
    from cap_tpu_torch.fleet.frontdoor import NativeFrontDoorServer
    from cap_tpu_torch.serve import vcache
    from cap_tpu_torch.serve.client import VerifyClient
    from cap_tpu_torch.serve.worker import VerifyWorker

    t_phase = time.perf_counter()
    pool = fleet["pool"]
    tokens = fleet["tokens"][:FD_UNIQUE + FD_CRASH_REQUESTS * FD_REQUEST]
    expected = fleet["expected"][:len(tokens)]
    direct = fleet["direct"][:len(tokens)]
    assert len(tokens) == FD_UNIQUE + FD_CRASH_REQUESTS * FD_REQUEST
    spans = [(lo, min(lo + FD_REQUEST, FD_UNIQUE))
             for lo in range(0, FD_UNIQUE, FD_REQUEST)]
    crash = [(lo, lo + FD_REQUEST)
             for lo in range(FD_UNIQUE, len(tokens), FD_REQUEST)]
    hosts = [PoolHost(pool, 0), PoolHost(pool, 1)]
    kw = dict(fallback=None,
              client_kw={"attempt_timeout": FLEET_WAIT_S / 2,
                         "total_deadline": FLEET_WAIT_S})
    figs = {}

    # 1. the gateway process from a spec
    figs["proc_boot_s"] = frontdoor_gateway_proc(
        pool, tokens[:FD_PROC_TOKENS], expected[:FD_PROC_TOKENS],
        direct[:FD_PROC_TOKENS])

    ring_fd = FrontDoor(hosts, **kw)
    digests = [vcache.token_digest(t) for t in tokens]
    owners = [ring_fd._ring.primary(d) for d in digests]
    ring_fd.close()
    owned = [sum(owners[lo] == w for lo in range(FD_UNIQUE))
             for w in (0, 1)]
    repeats = [sum(owners[i] == w and cacheable(expected[i])
                   for i in range(FD_UNIQUE)) for w in (0, 1)]
    assert min(owned) > 0 and min(repeats) > 0, (owned, repeats)

    def run(addr, todo):
        """The requests ``todo`` over FD_CLIENTS connections: (results
        by span, latencies, wall seconds)."""
        out, lat, errs = {}, [], []
        todo = list(todo)
        lock = threading.Lock()

        def client():
            try:
                with VerifyClient(*addr, timeout=FLEET_WAIT_S) as c:
                    while True:
                        with lock:
                            if not todo:
                                return
                            lo, hi = todo.pop(0)
                        t1 = time.perf_counter()
                        out[lo] = c.verify_batch(tokens[lo:hi])
                        lat.append(time.perf_counter() - t1)
            except Exception as e:  # noqa: BLE001 - raised below
                errs.append(e)

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(FD_CLIENTS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(FLEET_WAIT_S)
        wall = time.perf_counter() - t1
        assert not errs and not any(t.is_alive() for t in threads), errs
        return out, lat, wall

    def check(out, todo):
        for lo, hi in todo:
            check_routed(out[lo], tokens[lo:hi], expected[lo:hi])
            assert [routed_form(v) for v in out[lo]] == direct[lo:hi], \
                "through the front door != verify_batch_raw"

    def es_chunks():
        snap = json.loads(http_get(pool.obs_endpoints()[0],
                                   "/snapshot"))["snapshot"]
        return int(snap["series"].get("device.es.lanes", {}).get(
            "count", 0))

    # 2-3. the two gateways, the same requests twice through each
    chains = {}
    for chain in ("python", "native"):
        fd = FrontDoor(hosts, **kw)
        gate = (VerifyWorker(fd, vcache=False) if chain == "python"
                else NativeFrontDoorServer(fd))
        try:
            before, es0 = host_counters(pool), es_chunks()
            out1, lat1, wall1 = run(gate.address, spans)
            out2, lat2, wall2 = run(gate.address, spans)
            after, es1 = host_counters(pool), es_chunks()
            check(out1, spans)
            check(out2, spans)
            if chain == "native":
                assert gate.probe_route(digests) == owners
                time.sleep(0.5)               # one fold of the relay
                nc = gate.native_counters()
            else:
                nc = {}
            c, pools = fd.counters(), fd.snapshot()["pools"]
        finally:
            gate.close(30.0)
            fd.close()
        assert c["frontdoor.lookups"] == c["frontdoor.affinity_hits"] + \
            c["frontdoor.affinity_misses"] == 2 * FD_UNIQUE, c
        assert c["frontdoor.reroutes"] == 0, c
        spill = [pools[str(w)]["spills_in"] for w in (0, 1)]
        sent = [after[w][0] - before[w][0] for w in (0, 1)]
        hits = [after[w][1] - before[w][1] for w in (0, 1)]
        assert sent == [2 * owned[w] - spill[1 - w] + spill[w]
                        for w in (0, 1)], (chain, sent, owned, spill)
        assert all(hits[w] >= repeats[w] for w in (0, 1)), (hits, repeats)
        assert es1 > es0, "the card worker ran no ES chunk"
        lat = sorted(lat1 + lat2)
        chains[chain] = dict(
            vps=2 * FD_UNIQUE / (wall1 + wall2), wall_s=wall1 + wall2,
            p50_ms=statistics.median(lat) * 1e3,
            p99_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
            sent=sent, hits=hits, es_chunks=es1 - es0,
            counters={k.split(".", 1)[1]: v for k, v in c.items()
                      if k.count(".") == 1},
            native={k.rsplit(".", 1)[1]: v for k, v in nc.items()})
        log(f"frontdoor {chain} gate: {2 * FD_UNIQUE} tokens "
            f"({FD_UNIQUE} twice) as {2 * len(spans)} requests of "
            f"{FD_REQUEST} over {FD_CLIENTS} connections in "
            f"{wall1 + wall2:.3f} s; every verdict as expected and equal "
            f"to verify_batch_raw on the card; worker.tokens {sent[0]} on "
            f"the card host, {sent[1]} on the CPU host (the ring owns "
            f"{owned[0]} and {owned[1]} of the {FD_UNIQUE}; spills in "
            f"{spill}); vcache.hits {hits} (at least the {repeats} "
            f"repeats of cacheable rejects); {es1 - es0} ES chunk(s) on "
            f"the card; counters {chains[chain]['counters']}"
            + (f"; relay {chains[chain]['native']}" if nc else ""))

    # 4. kill -9 of the CPU host's worker mid-stream, native gate
    fd = FrontDoor(hosts, **kw)
    gate = NativeFrontDoorServer(fd)
    try:
        victim = pool.pid(1)
        results, errs = {}, []

        def stream():
            try:
                with VerifyClient(*gate.address, timeout=FLEET_WAIT_S) as c:
                    for lo, hi in crash:
                        results[lo] = c.verify_batch(tokens[lo:hi])
            except Exception as e:  # noqa: BLE001 - raised below
                errs.append(e)

        th = threading.Thread(target=stream, daemon=True)
        th.start()
        fleet_wait("the stream's first answers",
                   lambda: len(results) >= 2 or not th.is_alive())
        t_kill = time.perf_counter()
        kill9(victim)
        th.join(FLEET_WAIT_S)
        assert not th.is_alive() and not errs, errs
        check(results, crash)
        c, nc = fd.counters(), gate.native_counters()
        slow = {k.rsplit(".", 1)[1]: v for k, v in c.items()
                if k.startswith("frontdoor.native.slow.")}
        assert c["frontdoor.reroutes"] > 0, c
        assert nc["frontdoor.native.upstream_fails"] + slow.get(
            "dead_pool", 0) > 0, (nc, slow)
        assert c["frontdoor.lookups"] == c["frontdoor.affinity_hits"] + \
            c["frontdoor.affinity_misses"], c
        fleet_wait("the CPU worker's respawn",
                   lambda: pool.state(1) == "ready"
                   and pool.pid(1) != victim)
        respawn_s = time.perf_counter() - t_kill
        fleet_wait("the relay's view of the respawn", lambda: gate.probe_route(
            digests[:FD_REQUEST]) == owners[:FD_REQUEST])
        before = host_counters(pool)
        s0 = fd.snapshot()["pools"]
        with VerifyClient(*gate.address, timeout=FLEET_WAIT_S) as cl:
            out = cl.verify_batch(tokens[:FD_REQUEST])
        check({0: out}, [(0, FD_REQUEST)])
        after, s1 = host_counters(pool), fd.snapshot()["pools"]
        spill = [s1[str(w)]["spills_in"] - s0[str(w)]["spills_in"]
                 for w in (0, 1)]
        back = [sum(o == w for o in owners[:FD_REQUEST]) - spill[1 - w]
                + spill[w] for w in (0, 1)]
        assert [after[w][0] - before[w][0] for w in (0, 1)] == back, back
        figs.update(reroutes=c["frontdoor.reroutes"], respawn_s=respawn_s,
                    upstream_fails=nc["frontdoor.native.upstream_fails"],
                    crash_slow=slow)
        log(f"frontdoor kill -9: the CPU worker (pid {victim}) killed in "
            f"the middle of {len(crash)} requests of {FD_REQUEST} through "
            f"the native gate; every verdict as expected, no "
            f"FleetExhaustedError; frontdoor.reroutes "
            f"{c['frontdoor.reroutes']}, relay upstream_fails "
            f"{nc['frontdoor.native.upstream_fails']}, slow frames {slow}; "
            f"respawned (pid {pool.pid(1)}) {respawn_s:.1f} s after the "
            f"kill; then {FD_REQUEST} tokens on their ring owners again "
            f"({back[0]} card, {back[1]} CPU)")

        # 5. the keyplane fan-out through the front door, once the
        # respawned worker has the pool's epoch again (else the pool's
        # re-push of it could land after this one)
        fleet_wait("the epochs' reconvergence", lambda: set(
            fleet_epochs(pool).values()) == {fleet["epoch"]})
        epoch = fleet["epoch"] + 1
        t1 = time.perf_counter()
        acks = fd.push_keys(fleet["doc"], epoch=epoch)
        push_s = time.perf_counter() - t1
        assert acks == {0: {0: epoch}, 1: {1: epoch}}, acks
        assert fd.key_epochs() == {"p0.w0": epoch, "p1.w1": epoch}
        assert fd.epoch_skew() == 0 and fd.key_epoch == epoch
        assert set(fleet_epochs(pool).values()) == {epoch}
        figs["push_s"] = push_s
        log(f"frontdoor push_keys at epoch {epoch}: {acks}, key_epochs "
            f"{fd.key_epochs()}, epoch_skew 0, STATS epochs "
            f"{fleet_epochs(pool)} in {push_s:.2f} s")
    finally:
        gate.close(30.0)
        fd.close()

    # 6. the frontdoor line
    figs.update(chains=chains, seconds=time.perf_counter() - t_phase)
    records["frontdoor"] = figs
    py, nat = chains["python"], chains["native"]
    log(f"frontdoor line: python gate {py['vps']:.0f} verifies/s, p50 "
        f"{py['p50_ms']:.1f} ms, p99 {py['p99_ms']:.1f} ms; native relay "
        f"{nat['vps']:.0f} verifies/s, p50 {nat['p50_ms']:.1f} ms, p99 "
        f"{nat['p99_ms']:.1f} ms; tokens a host (card, CPU): python "
        f"{py['sent']}, native {nat['sent']}; python lookups "
        f"{py['counters']['lookups']} hits "
        f"{py['counters']['affinity_hits']} misses "
        f"{py['counters']['affinity_misses']} spills "
        f"{py['counters']['spills']}; native lookups "
        f"{nat['counters']['lookups']} hits "
        f"{nat['counters']['affinity_hits']} misses "
        f"{nat['counters']['affinity_misses']} spills "
        f"{nat['counters']['spills']}; reroutes under the kill "
        f"{figs['reroutes']}; relay relays {nat['native']['relays']} "
        f"splices {nat['native']['splices']} slow frames "
        f"{nat['native']['slow_frames']}; phase "
        f"{figs['seconds']:.1f} s; card: {card_line()}")


# ---------------------------------------------------------------------------
# The 12-bit-window ladder and the mesh
# ---------------------------------------------------------------------------

N_W12_TOKENS = 8192           # the w12 phase's slices of the ES cells
W12_POOL = 1 << 16            # random values a kernel-check table draws on
W12_WINDOWS = {"P-256": 22, "P-384": 32, "P-521": 44}


def w12_kernels(records):
    """The whole-ladder kernel at 12-bit windows (22, 32 and 44 on P-256,
    P-384 and P-521): 65,536 lanes over a table of G and 8 key slots
    (4,095 rows a slot and window, drawn from a pool of random values),
    held against its plain version on every lane with planted same-x
    degeneracies (the plain run timed by CUDA events), and timed against
    its bound in turns with itself at 8-bit windows on inputs made the
    same way (8, 12, 12, 8: each width's mean of its two). Records them
    under the ladder's ``w12_shapes``."""
    import numpy as np
    import torch

    from cap_tpu_torch import testing as tt
    from cap_tpu_torch.gpu import cuda_ladder, ec_rns

    rng = np.random.default_rng(SEED + 12)
    n = KERNEL_LANES
    T = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    shapes = []
    for crv, w12 in W12_WINDOWS.items():
        args, cs = {}, {}
        for w in (8, 12):
            c = cs[w] = ec_rns.ctx_for(crv, w)
            tab, d, base, stride, true_deg = tt.ladder_inputs(
                c, c.n_windows, n, 8, rng, pool=W12_POOL)
            args[w] = (T(tab), T(d), T(base), stride)
        c = cs[12]
        assert c.n_windows == w12
        out_k = cuda_ladder.ladder(c, *args[12])
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out_p = cuda_ladder.ladder_ref(c, *args[12])
        t1.record()
        torch.cuda.synchronize()
        ms_p = t0.elapsed_time(t1)
        err, ndiff, deg_only = ladder_compare(c, out_k, out_p,
                                              f"ladder {crv} w12")
        assert out_k[4].cpu().numpy()[true_deg].all(), \
            f"ladder {crv} w12: deg missed"
        del out_k, out_p
        ms = {8: [], 12: []}
        for w in (8, 12, 12, 8):
            ms[w].append(cuda_ms(
                lambda: cuda_ladder.ladder(cs[w], *args[w]), 3))
        ms8, ms12 = (sum(ms[w]) / 2 for w in (8, 12))
        b_ms, b_by = ladder_bound(c, n, w12)
        b8, _ = ladder_bound(cs[8], n, cs[8].n_windows)
        rows = args[12][0].shape[0]
        nbytes = args[12][0].numel() * 4
        log(f"kernel ladder {crv} w12: {n} lanes, {w12} windows over "
            f"{rows} rows ({nbytes / 1e6:.1f} MB), {ndiff} lane planes not "
            f"bit-equal, max value err {err}, inf equal, "
            f"{int(true_deg.sum())} true degeneracies flagged, {deg_only} "
            f"probe flags differ; kernel {ms12:.4f} ms "
            f"({', '.join(f'{t:.4f}' for t in ms[12])}), 8-bit "
            f"({cs[8].n_windows} windows) {ms8:.4f} ms "
            f"({', '.join(f'{t:.4f}' for t in ms[8])}) in turns: 12/8 "
            f"{ms12 / ms8:.3f}; plain {ms_p:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; 8-bit {b8:.4f})")
        shapes.append(dict(curve=crv, lanes=n, w_bits=12, windows=w12,
                           max_abs_err=err, ms=ms12, by="events",
                           plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
                           ms_w8=ms8, table_rows=int(rows),
                           table_bytes=int(nbytes)))
        del args
    rec = records["ladder"]
    rec["w12_shapes"] = shapes
    rec["max_abs_err"] = max([rec["max_abs_err"]]
                             + [sh["max_abs_err"] for sh in shapes])


def w12_path(records, north, config3):
    """The 12-bit windows (``w_bits=12`` of ``ec``'s entry points): the
    kernel at 22, 32 and 44 windows (:func:`w12_kernels`); each key
    set's 12-bit window table (host seconds, G's table included, as its
    cell's fixture job built it in a worker process; bytes, seconds to
    the card); then the ES signatures of the first 8,192 tokens of the
    north-star (ES256) and config-3 (ES256, ES384) batches: the default
    8-bit entries timed (verdicts the signatures'), then one counted run
    at ``w_bits=12`` (1 ladder + 11 redc a call, every verdict the
    signature's, every ladder and redc launch held against its plain
    version), and one more timed beside them."""
    import torch

    from cap_tpu_torch.gpu import ec_rns

    card = card_line()
    w12_kernels(records)
    n = N_W12_TOKENS
    ns = mode_inputs(north["jwks"], north["tokens"][:n],
                     north["expected"][:n], [("ES256", "es-")])
    c3 = mode_inputs(config3["jwks"], config3["tokens"][:n],
                     config3["expected"][:n],
                     [("ES256", "es-"), ("ES384", "es384-")])
    tables = []
    for label, cell, prefix, b in (
            ("north-star ES256", "north-star", "es-", ns["ES256"]),
            ("config-3 ES256", "config-3", "es-", c3["ES256"]),
            ("config-3 ES384", "config-3", "es384-", c3["ES384"])):
        t = b["table"]
        built = _W12_TABLES.get(cell, {}).get(prefix)
        where = "its cell's fixture job"
        if built is None:
            t0 = time.perf_counter()
            built, where = (t.rns(12).tab, time.perf_counter() - t0), "here"
        tab, host_s = built
        rt = t._rns[12] = ec_rns.ECRNSKeyTable(t.curve.name, t.keys,
                                               tab=tab, w_bits=12)
        t0 = time.perf_counter()
        rt.device_tab(t.device)
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t0
        tables.append(dict(cell=label, keys=rt.nk, rows=int(rt.tab.shape[0]),
                           bytes=int(rt.tab.nbytes), host_s=host_s,
                           copy_s=copy_s))
        log(f"w12 table {label}: G + {rt.nk} keys, {rt.tab.shape[0]} rows, "
            f"{rt.tab.nbytes / 1e6:.1f} MB (8-bit: "
            f"{t.rns().tab.nbytes / 1e6:.1f} MB), host build {host_s:.1f} "
            f"s ({where}), to the card {copy_s:.2f} s")
    records["ladder"]["w12_tables"] = tables
    w12 = dict(w_bits=12)
    runs = {}
    for name, inputs, algs_ in (("w12 north-star", ns, ("ES256",)),
                                ("w12 config-3", c3, ("ES256", "ES384"))):
        base = default_s(inputs, algs_)
        runs[name] = mode_pass(
            records, name, inputs, dict.fromkeys(algs_, w12),
            {k: v * len(algs_) for k, v in ES_LAUNCHES.items()},
            ("_ecdsa_rns_core_steps",), base, card,
            hold=("ladder", "redc"))
        runs[name]["base_s"] = base
    records["ladder"]["w12_runs"] = {
        k: dict(warm_s=v["warm_s"], base_s=v["base_s"])
        for k, v in runs.items()}


N_MESH_TOKENS = 8192          # the mesh phase's slices of the cells
N_MESH_PQ_TOKENS = 2048


def mesh_pass(records, name, mesh, fx, n, families, warm=True):
    """One cell's first ``n`` tokens through ``GPUBatchKeySet(jwks,
    mesh=mesh)`` beside ``GPUBatchKeySet(jwks)``: one meshed run with
    every launch counter zeroed just before it and read just after it
    (each chunk's launches once a card shard) and every launch held
    against its plain version at the shard's shape (:func:`kernels_held`,
    each shape timed by :func:`held_times`), every verdict as expected;
    then the unmeshed keyset, warmed on the first 256 tokens (its window
    tables built), over all of them: its verdicts the meshed ones (class
    and message). With ``warm`` that unmeshed run is timed, and one
    more meshed run beside it. Returns their seconds."""
    import torch

    from cap_tpu_torch.jwt.gpu_keyset import GPUBatchKeySet

    jwks, tokens = fx["jwks"], fx["tokens"][:n]
    expected = fx["expected"][:n]
    plain = GPUBatchKeySet(jwks)
    meshed = GPUBatchKeySet(jwks, mesh=mesh)
    per_shard, n_chunks, fams = family_launches(jwks, tokens, families)
    cards = sum(d.type == "cuda" for d in mesh.devices)
    want = {k: v * cards for k, v in per_shard.items()}
    with counted_launches(records, name, want) as launches, \
            kernels_held(name, tuple(per_shard)) as held:
        got = meshed.verify_batch(tokens)
        torch.cuda.synchronize()
    shapes = held_times(records, name, held, launches)
    check_verdicts(got, expected)
    plain.verify_batch(tokens[:256])
    best = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain.verify_batch(tokens)
    torch.cuda.synchronize()
    best["plain"] = time.perf_counter() - t0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert type(g) is type(r) and (g == r if isinstance(r, dict)
                                       else str(g) == str(r)), (name, i)
    if warm:
        t0 = time.perf_counter()
        meshed.verify_batch(tokens)
        torch.cuda.synchronize()
        best["mesh"] = time.perf_counter() - t0
    else:
        best.pop("plain")
    speed = (f"; warm {best['mesh']:.3f} s meshed, {best['plain']:.3f} s "
             f"unmeshed: {len(tokens) / best['mesh']:.0f} against "
             f"{len(tokens) / best['plain']:.0f} verifies/s") if warm else ""
    log(f"{name}: {len(tokens)} tokens ({', '.join(fams)}; {n_chunks} "
        f"chunk(s), each over the shards {[str(d) for d in mesh.devices]})"
        f", verdicts equal to the unmeshed keyset's; launches {launches}, "
        f"each equal to the plain version at its shard's shape: {shapes}"
        f"{speed}")
    return dict(best, n=len(tokens), launches=launches)


def mesh_steps(mesh, north, n):
    """The three sharded steps over the RS256 signatures of the
    north-star's first ``n`` tokens on its RSA-2048 keys (the limb
    step with the key gather on each shard, the limb step on gathered
    operands, the RNS step), against each signature's verdict, their
    totals the sum of the shards' counts."""
    import numpy as np
    import torch

    from cap_tpu_torch.gpu import rsa
    from cap_tpu_torch.parallel import mesh as pm

    b = mode_inputs(north["jwks"], north["tokens"][:n], north["expected"][:n],
                    [("RS256", "rs-")])["RS256"]
    t = b["table"]
    keep = [i for i, sg in enumerate(b["sigs"])
            if len(sg) == t.sizes_bytes[b["rows"][i]]]
    keep = keep[:len(keep) - len(keep) % len(mesh)]
    m = len(keep)
    sig = np.zeros((m, 2 * t.k), np.uint8)
    for j, i in enumerate(keep):
        sig[j, :len(b["sigs"][i])] = np.frombuffer(b["sigs"][i], np.uint8)
    rec = rsa.rs_packed_records(
        t, sig, np.asarray([len(b["sigs"][i]) for i in keep]),
        np.stack([np.frombuffer(b["digests"][i], np.uint8) for i in keep]),
        "sha256", b["rows"][keep])
    s_l, dig, _, idx = rsa._rs_packed_unpack(
        torch.from_numpy(rec).to(t.device), t.k, 32)
    exp = rsa._expected_em_device(dig, t.sizes_dev[idx], t.k, "sha256")
    want = np.asarray(b["want"])[keep]
    keys = [k[idx].T for k in t.rtab.device_tables(t.device)]
    steps = {
        "sharded_verify_step": lambda: pm.sharded_verify_step(mesh)(
            t.n_tab, t.np_tab, t.r2_tab, idx, s_l, exp),
        "sharded_rs256_verify": lambda: pm.sharded_rs256_verify(mesh)(
            s_l, t.n_tab[idx].T, t.np_tab[idx].T, t.r2_tab[idx].T, exp),
        "sharded_rns_verify_step": lambda: pm.sharded_rns_verify_step(
            mesh, t.ctx)(s_l, exp, *keys)}
    out = {}
    for name, fn in steps.items():
        t0 = time.perf_counter()
        ok, total = fn()
        got = ok.cpu().numpy()
        secs = time.perf_counter() - t0
        assert np.array_equal(got, want), (name, int((got != want).sum()))
        assert int(total) == int(want.sum()), (name, int(total))
        out[name] = secs
    log(f"mesh steps: {m} RS256 signatures over {len(mesh)} shards, "
        f"{int(want.sum())} valid: " + ", ".join(
            f"{k} ok and total equal ({v:.3f} s)" for k, v in out.items()))
    return out


N_MIXED_TOKENS = 1024         # the card-and-CPU mesh's slices


def mesh_path(records, north, config4, pq, slh):
    """The mesh on one card: ``Mesh([cuda:0, cuda:0])``, two shards a
    chunk on one device (a real multi-card mesh needs a four-card cell).
    The first 8,192 tokens of the north-star and config-4, the first
    2,048 of pq-mldsa and pq-slhdsa's 512 through the meshed keyset
    beside the unmeshed one (:func:`mesh_pass`); the first 1,024 of the
    north-star and config-4 over ``Mesh([cuda:0, cpu])``, one shard a
    chunk on the CPU's plain path (so a tensor left on the wrong device
    fails); then the sharded steps on the north-star's RSA-2048 keys
    (:func:`mesh_steps`)."""
    from cap_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(["cuda:0", "cuda:0"])
    mixed = Mesh(["cuda:0", "cpu"])
    pq_chunk = {"keccak": 14, "ntt": 2, "intt": 1}
    es = ("ES256", "es-", 32768, ES_LAUNCHES)
    ed = ("EdDSA", "ed-", 32768, {"edw": 32, "redc": 3})
    cells = [
        ("mesh north-star", mesh, north, N_MESH_TOKENS, [es], True),
        ("mesh config-4", mesh, config4, N_MESH_TOKENS, [ed], True),
        ("mesh pq-mldsa", mesh, pq, N_MESH_PQ_TOKENS,
         [("ML-DSA-44", "mldsa44-", 1024, pq_chunk),
          ("ML-DSA-65", "mldsa65-", 1024, pq_chunk)], True),
        ("mesh pq-slhdsa", mesh, slh, N_SLH_TOKENS,
         [(pset, f"slh128{pset[-1]}-", 1024, {"keccak": k})
          for pset, k in SLH_LAUNCHES.items()], True),
        ("mesh card+cpu north-star", mixed, north, N_MIXED_TOKENS, [es],
         False),
        ("mesh card+cpu config-4", mixed, config4, N_MIXED_TOKENS, [ed],
         False),
    ]
    runs = {name: mesh_pass(records, name, m, fx, n, fams, warm)
            for name, m, fx, n, fams, warm in cells}
    steps = mesh_steps(mesh, north, N_MESH_TOKENS)
    records.setdefault("mesh", {}).update(
        shards=len(mesh), devices=[str(d) for d in mesh.devices],
        cells={k: dict(n=v["n"], mesh_s=v.get("mesh"),
                       plain_s=v.get("plain"), launches=v["launches"])
               for k, v in runs.items()},
        steps_s=steps)


def device_profile():
    """A torch.profiler context over CUPTI that records the card's work
    only (kernels, copies, fills), no host operator."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def device_events(prof) -> dict:
    """{name: [launches, device µs]} of a finished ``device_profile``,
    summed from its raw Kineto records: building the profiler's own
    event objects costs tens of µs a record on the host, minutes over
    this script's batches."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or (hasattr(e, "is_user_annotation")
                                       and e.is_user_annotation()):
            continue
        rec = out.setdefault(e.name(), [0, 0.0])
        rec[0] += 1
        rec[1] += e.duration_ns() / 1e3
    return out


def profile_batch(ks, tokens, wall_s: float):
    """Device time of one warm batch by kernel (torch.profiler over
    CUPTI) and its share of the best unprofiled wall time."""
    import torch

    with device_profile() as prof:
        ks.verify_batch(tokens)
        torch.cuda.synchronize()

    events = device_events(prof)
    total_ms = sum(us for _, us in events.values()) / 1e3
    if total_ms == 0:
        log("profile: no device time recorded (not measured)")
        return None
    n_launch = sum(n for n, _ in events.values())
    log(f"profile: {total_ms:.1f} ms of device time in {n_launch} kernel "
        f"launches in one batch, {100 * total_ms / 1e3 / wall_s:.1f}% of "
        f"the best wall time (device idle "
        f"{100 - 100 * total_ms / 1e3 / wall_s:.1f}%)")
    for name, (n, us) in sorted(events.items(), key=lambda kv: kv[1][1],
                                reverse=True)[:10]:
        log(f"  {us / 1e3:9.2f} ms  {n:6d}x  {name[:70]}")
    return total_ms


def batch_breakdown(ks, tokens):
    """One warm batch split by phase on the host clock (each phase
    ends where the next starts; the card syncs inside them): the
    native prep, the rest of the dispatch (bucketing, key rows, record
    packing, queueing, and the ES and Ed chunks' host ``pow`` waits),
    the claims prefetch, the syncs with the finishes, and the trial
    path."""
    import torch

    from cap_tpu_torch.runtime import native_binding as nb

    spans = {}

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spans[name] = spans.get(name, 0.0) + \
                    time.perf_counter() - t0
                spans[name + " calls"] = spans.get(name + " calls", 0) + 1
        return call

    prep, prefetch = nb.prepare_batch_arrays, nb.PreparedBatch.prefetch_claims
    nb.prepare_batch_arrays = timed("prep", prep)
    nb.PreparedBatch.prefetch_claims = timed("prefetch", prefetch)
    for name in ("_dispatch_batch", "_collect_batch", "_verify_one_parsed"):
        setattr(ks, name, timed(name, getattr(ks, name)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ks.verify_batch(tokens)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        nb.prepare_batch_arrays = prep
        nb.PreparedBatch.prefetch_claims = prefetch
        for name in ("_dispatch_batch", "_collect_batch",
                     "_verify_one_parsed"):
            delattr(ks, name)
    trial = spans.get("_verify_one_parsed", 0.0)
    ms = {"prep": spans["prep"],
          "dispatch rest": spans["_dispatch_batch"] - spans["prep"],
          "claims prefetch": spans["prefetch"],
          "syncs + finishes": spans["_collect_batch"] - spans["prefetch"]
          - trial,
          "trial path": trial}
    log(f"batch breakdown: {total * 1e3:.1f} ms = "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in ms.items())
        + f" ms ({spans.get('_verify_one_parsed calls', 0)} tokens on the "
        f"trial path)")

    # one more with its collect phase under cProfile: where the host
    # time after the dispatch goes, function by function
    import cProfile
    import pstats

    state = ks._dispatch_batch(tokens)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.runcall(ks._collect_batch, state)
    stats = pstats.Stats(prof)
    top = sorted(stats.stats.items(), key=lambda kv: kv[1][2],
                 reverse=True)[:6]
    log("collect profile (cProfile, own time): " + "; ".join(
        f"{fn[2]} ({os.path.basename(fn[0])}:{fn[1]}) {tt * 1e3:.1f} ms "
        f"in {nc} calls" for fn, (_, nc, tt, _, _) in top))


def engine_times(ks, tokens, engines):
    """Record packing and device time of each named packed path (host
    prep excluded), with the count of tokens each one packed: the
    engines' share of the batch."""
    import torch

    from cap_tpu_torch.runtime.native_binding import prepare_batch_arrays

    runners = {
        "RS256": lambda *a: ks._run_rsa_packed("rs", "sha256", *a),
        "RS384": lambda *a: ks._run_rsa_packed("rs", "sha384", *a),
        "RS512": lambda *a: ks._run_rsa_packed("rs", "sha512", *a),
        "PS256": lambda *a: ks._run_rsa_packed("ps", "sha256", *a),
        "PS384": lambda *a: ks._run_rsa_packed("ps", "sha384", *a),
        "PS512": lambda *a: ks._run_rsa_packed("ps", "sha512", *a),
        "ES256": lambda *a: ks._run_ec_packed("ES256", *a),
        "ES384": lambda *a: ks._run_ec_packed("ES384", *a),
        "EdDSA": ks._run_ed_packed,
        "ML-DSA-44": lambda *a: ks._run_mldsa_packed("ML-DSA-44", *a),
        "ML-DSA-65": lambda *a: ks._run_mldsa_packed("ML-DSA-65", *a),
        SLH_F: lambda *a: ks._run_slhdsa_packed(SLH_F, *a),
        SLH_S: lambda *a: ks._run_slhdsa_packed(SLH_S, *a),
    }
    t0 = time.perf_counter()
    pb = prepare_batch_arrays(tokens)
    dt = time.perf_counter() - t0
    log(f"host prep: {len(tokens)} tokens prepared (native parse and "
        f"SHA-2) in {dt * 1e3:.1f} ms ({dt / len(tokens) * 1e6:.2f} "
        f"µs/token)")
    ok = (pb.status == 0).nonzero()[0]
    t0 = time.perf_counter()
    pb.prefetch_claims(ok)
    dt = time.perf_counter() - t0
    log(f"claims prefetch: {len(ok)} payloads parsed in {dt * 1e3:.1f} ms "
        f"({dt / max(1, len(ok)) * 1e6:.2f} µs/token)")
    for alg in engines:
        idx = family_idx(pb, alg)
        idx = idx[pb.kid_len[idx] != -1]
        pending = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runners[alg](idx, pb, pending)
        outs = [o.cpu() for _, _, o_list, _ in pending for o in o_list]
        dt = time.perf_counter() - t0
        packed = sum(m for _, m, _, _ in pending)
        log(f"engine {alg}: {packed} tokens packed in {len(pending)} "
            f"chunk(s) ({len(idx) - packed} without a key row left out), "
            f"{dt * 1e3:.1f} ms record packing + device, "
            f"{packed / dt:.0f} verifies/s ({len(outs)} outputs)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "cap_tpu_torch")):
        print("chip_smoke: run from a checkout that holds cap_tpu_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from cap_tpu_torch import _build

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for the kernels "
        f"{', '.join(_build.KERNELS)} (nvcc) and the host targets "
        f"{', '.join(_build.HOST_TARGETS)} (g++), all in parallel: "
        + ", ".join(f"{n} {info['seconds']:.1f} s"
                    for n, info in _build.BUILD_LOG.items()))
    ptxas = {}
    for name, info in sorted(_build.BUILD_LOG.items()):
        ptxas.update(ptxas_kernels(info["ptxas"]))
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    records = {}
    t_run = time.perf_counter()
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        max_workers=max(1, min(len(FIXTURE_JOBS), (os.cpu_count() or 2) - 1)),
        mp_context=multiprocessing.get_context("spawn"))
    try:
        start_fixtures(pool)
        run_phases(records)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all "
        f"({time.perf_counter() - t_run:.1f} s after the build)")
    print_records(records, ptxas)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(records):
    """Every phase in order, each timed ("phase …: s")."""

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("kernels", kernel_phase, records)
    timed("kernels at 34+33 and 45+45", wide_phase, records)
    timed("ladder", ladder_phase, records)
    timed("fixtures", wait_fixtures)
    north = timed("north-star", main_path, records)
    timed("validator", validator_path, records, north)
    config3 = timed("config-3", config3_path, records)
    config4 = timed("config-4", config4_path, records)
    pq = timed("pq-mldsa", mldsa_path, records)
    timed("engine modes", engine_modes_path, records, north, config4, pq)
    timed("ps-sha512", ps512_path, records)
    slh = timed("pq-slhdsa", slhdsa_path, records)
    timed("config-2", config2_path, records)
    timed("rsa-limb", rsalimb_path, records)
    timed("big-jwks", bigjwks_path, records)
    timed("oidc", oidc_path, records)
    timed("serve", serve_path, records, north)
    fleet = timed("fleet", fleet_path, records, north)
    with fleet["stack"]:
        timed("frontdoor", frontdoor_path, records, fleet)
    timed("w12", w12_path, records, north, config3)
    timed("mesh", mesh_path, records, north, config4, pq, slh)


def print_records(records, ptxas):
    """The per-kernel JSON line."""
    kernels = [
        dict(name="redc", route="cuda",
             source="cap_tpu_torch/gpu/csrc/redc.cu",
             replaces="cap_tpu/tpu/pallas_redc.py:177",
             library_ms=None, **records["redc"],
             ptxas={k: v for k, v in ptxas.items() if k.startswith("redc")}),
        dict(name="madd", route="cuda",
             source="cap_tpu_torch/gpu/csrc/madd.cu",
             replaces="cap_tpu/tpu/pallas_madd.py:125",
             library_ms=None, **records["madd"],
             ptxas={k: v for k, v in ptxas.items() if k.startswith("madd")}),
        dict(name="ladder", route="cuda",
             source="cap_tpu_torch/gpu/csrc/ladder.cu",
             replaces="cap_tpu/tpu/pallas_madd.py:262",
             library_ms=None, **records["ladder"],
             ptxas={k: v for k, v in ptxas.items()
                    if k.startswith("ladder")}),
        dict(name="edw", route="cuda",
             source="cap_tpu_torch/gpu/csrc/edw.cu",
             replaces="cap_tpu/tpu/pallas_edw.py:58",
             library_ms=None, **records["edw"],
             ptxas={k: v for k, v in ptxas.items() if k.startswith("edw")}),
        dict(name="keccak", route="cuda",
             source="cap_tpu_torch/gpu/csrc/keccak.cu",
             replaces="cap_tpu/tpu/pallas_keccak.py:360",
             library_ms=None, **records["keccak"],
             ptxas={k: v for k, v in ptxas.items() if k == "keccak"}),
        dict(name="ntt", route="cuda",
             source="cap_tpu_torch/gpu/csrc/ntt.cu",
             replaces="cap_tpu/tpu/pallas_ntt.py:89",
             library_ms=None, **records["ntt"],
             ptxas={k: v for k, v in ptxas.items() if k == "ntt_fwd"}),
        dict(name="intt", route="cuda",
             source="cap_tpu_torch/gpu/csrc/ntt.cu",
             replaces="cap_tpu/tpu/pallas_ntt.py:93",
             library_ms=None, **records["intt"],
             ptxas={k: v for k, v in ptxas.items() if k == "intt"}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of the credential prover on one GPU.

    python chip_smoke.py           one card: kernels, MSMs, N=1 credential
    python chip_smoke.py --four    four cards: sharded MSM, sharded NTT and
                                   batched proving, against one card

Runs in one process and refuses to run without a GPU: there is no CPU
fallback.  Prints the card's name and power limit, the JAX version, one
line per phase (compile seconds, warm seconds, comparison result), and as
its last line one JSON object with the device JAX reports.

Exactness: every value here is exact integer arithmetic -- 16-bit limbs
in uint32 under XLA, 32-bit words with 64-bit products in the CUDA
kernels, both reduced to the canonical residue.  There is no floating
point, no matrix unit and no TF32, and segment_sum's atomics add
integers, which is exact in any order.  So every comparison below is
bit-exact equality, with no tolerance.

The phases are functions of their sizes, so the CPU tests run them at
tiny sizes (tests/test_chip_smoke.py); main() alone insists on a GPU.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from zklaim_tpu.ec import cuda_curve as CC
from zklaim_tpu.ec import jaxcurve as JC
from zklaim_tpu.ec.hostcurve import g1_generator, g2_generator
from zklaim_tpu.ff.limbs import ints_to_limbs
from zklaim_tpu.ff.montgomery import FQ
from zklaim_tpu.ff.params import R
from zklaim_tpu.msm import pippenger as P
from zklaim_tpu.utils.device import device_info, gpu_name_and_power, require_gpu
from zklaim_tpu.utils.jaxconfig import setup_cache


def log(msg: str) -> None:
    print(msg, flush=True)


def _timed(fn, *args):
    """(result, first-call seconds, best warm seconds of two)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    warm = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        warm = min(warm, time.perf_counter() - t0)
    return out, first, warm


def _same(a, b) -> bool:
    return all(
        np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


def random_planes(rng: np.random.Generator, deg: int, width: int):
    """(48*deg, width) planes of canonical Fq limbs: the top limb of each
    value stays below p's, so every value is < p.  The point formulas are
    deterministic functions of their inputs, so arbitrary field values
    compare the kernels with the reference as well as curve points do."""
    a = rng.integers(0, 1 << 16, size=(3 * deg, 16, width), dtype=np.uint32)
    a[:, 15] = rng.integers(0, int(FQ.p_limbs[-1]), size=(3 * deg, width),
                            dtype=np.uint32)
    return jnp.asarray(a.reshape(48 * deg, width))


def phase_kernels(widths=((1, 16), (2, 15)), impl: str = "kernel",
                  seed: int = 0):
    """Each point kernel against the XLA point ops, bit-exact, for each
    (deg, log2 width) in `widths`: by default the MSM chunk widths,
    2^16 lanes for G1 (deg 1) and 2^15 for G2 (deg 2)."""
    rng = np.random.default_rng(seed)
    ok = True
    for deg, lw in widths:
        f = JC.FQ_OPS if deg == 1 else JC.FQ2_OPS
        xla_add = jax.jit(P._plane_add(f, "xla"))
        xla_dbl = jax.jit(P._plane_double(f, "xla"))
        n = 1 << lw
        p = random_planes(rng, deg, n)
        q = random_planes(rng, deg, n)
        cases = (
            ("add", lambda a, b: CC.point_add(deg, a, b, impl), xla_add, (p, q)),
            ("double", lambda a: CC.point_double(deg, a, impl), xla_dbl, (p,)),
            ("add_halves", lambda a: CC.point_add_halves(deg, a, impl),
             lambda a: xla_add(a[:, : n // 2], a[:, n // 2:]), (p,)),
        )
        for name, kern, ref, args in cases:
            t0 = time.perf_counter()
            compiled = jax.jit(kern).lower(*args).compile()
            k_compile = time.perf_counter() - t0
            if impl == "kernel":
                log(f"  g{deg} {name} 2^{lw}: {compiled.memory_analysis()}")
            got, _, k_warm = _timed(compiled, *args)
            want, x_first, x_warm = _timed(jax.jit(ref), *args)
            same = _same(got, want)
            ok &= same
            log(f"[kernels] g{deg} {name} 2^{lw}: kernel compile "
                f"{k_compile:.2f}s warm {k_warm * 1e3:.3f}ms | xla compile+run "
                f"{x_first:.2f}s warm {x_warm * 1e3:.3f}ms | bit-exact={same}")
    return ok


def _tiled_instance(f, gen, n: int, n_distinct: int, rng: random.Random):
    """n device points cycling through n_distinct random multiples of
    gen, n random scalars, and the host MSM of that instance: with the
    points tiled, sum_i s_i P_(i mod K) = sum_j (sum of s_i on P_j) P_j,
    K host scalar multiplies however large n is."""
    base = [gen * rng.randrange(1, R) for _ in range(n_distinct)]
    scalars = [rng.randrange(R) for _ in range(n)]
    sums = [0] * n_distinct
    for i, s in enumerate(scalars):
        sums[i % n_distinct] = (sums[i % n_distinct] + s) % R
    want = None
    for p, s in zip(base, sums):
        t = p * s
        want = t if want is None else want + t
    dev = JC.host_points_to_proj(f, base)
    reps = n // n_distinct
    points = jax.tree.map(
        lambda a: jnp.tile(a, (reps,) + (1,) * (a.ndim - 1)), dev
    )
    return points, jnp.asarray(ints_to_limbs(scalars)), want


def phase_msm(log2n: int = 15, impl: str | None = None, degs=(1, 2),
              n_distinct: int = 64, seed: int = 1):
    """msm_pow2 at 2^log2n points against the host MSM of the same
    instance (exact group elements)."""
    rng = random.Random(seed)
    ok = True
    for deg in degs:
        f = JC.FQ_OPS if deg == 1 else JC.FQ2_OPS
        gen = g1_generator() if deg == 1 else g2_generator()
        points, scalars, want = _tiled_instance(
            f, gen, 1 << log2n, min(n_distinct, 1 << log2n), rng
        )
        out, first, warm = _timed(
            lambda p, s: P.msm_pow2(f, p, s, 8, impl), points, scalars
        )
        got = JC.proj_to_host_points(f, jax.tree.map(lambda a: a[None], out))[0]
        same = got == want
        ok &= same
        log(f"[msm] g{deg} msm_pow2 2^{log2n} impl={impl or 'auto'}: "
            f"compile+run {first:.2f}s warm {warm * 1e3:.2f}ms "
            f"matches host={same}")
    return ok


def _credential_context(num_payloads: int, rng: random.Random):
    """Issuer's payloads as in cli.demo: age 23, flags 1/2/3, score 599,
    against age >= 18, flags ==, score < 600."""
    from zklaim_tpu.claims.api import Context, Payload, ZkOp

    ctx = Context()
    for i in range(num_payloads):
        pl = Payload()
        for pos, attr in enumerate([23 + i, 1, 2, 3, 599]):
            pl.set_attr(attr, pos)
        pl.data_ref = [18, 1, 2, 3, 600]
        pl.data_op = [ZkOp.GREATER_OR_EQ, ZkOp.EQ, ZkOp.EQ, ZkOp.EQ, ZkOp.LESS]
        ctx.add_payload(pl)
    return ctx


def credential_round(num_payloads: int, rng: random.Random):
    """One issuer -> prover -> verifier run through claims/api.py, as
    cli.demo drives it.  Returns ({role: seconds}, ok)."""
    from zklaim_tpu.claims import signing
    from zklaim_tpu.claims.api import (
        Context, ZKLAIM_INVALID_PROOF, ZKLAIM_OK,
    )

    times = {}
    t0 = time.perf_counter()
    ctx = _credential_context(num_payloads, rng)
    ctx.hash_payloads(rng)
    ok = ctx.trusted_setup(rng) == ZKLAIM_OK
    ok &= ctx.sign(signing.keygen(rng), rng) == ZKLAIM_OK
    wire_issuer = ctx.serialize()
    times["issuer"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    prover, status = Context.deserialize(wire_issuer)
    ok &= status == ZKLAIM_OK
    prover.pk = ctx.pk                      # the pk ships out of band
    ok &= prover.proof_generate(rng) == ZKLAIM_OK
    prover.clear_pres()
    wire_prover = prover.serialize()
    times["prover"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    verifier, status = Context.deserialize(wire_prover)
    ok &= status == ZKLAIM_OK
    res = verifier.verify()
    times["verifier"] = time.perf_counter() - t0
    ok &= res == ZKLAIM_OK

    tampered = bytearray(verifier.proof)
    tampered[len(tampered) // 2] ^= 1
    verifier.proof = bytes(tampered)
    rejected = verifier.verify() == ZKLAIM_INVALID_PROOF
    return times, res, bool(ok and rejected)


def phase_credential(num_payloads: int = 1, rounds: int = 2, seed: int = 3):
    """The credential flow `rounds` times: the first pays compilation,
    the later ones run warm.  Each must verify (ZKLAIM_OK) and reject a
    proof with one flipped byte (ZKLAIM_INVALID_PROOF)."""
    rng = random.Random(seed)
    ok = True
    for r in range(rounds):
        times, res, good = credential_round(num_payloads, rng)
        ok &= good
        label = "cold" if r == 0 else "warm"
        log(f"[credential] N={num_payloads} {label}: " + " ".join(
            f"{role} {sec:.2f}s" for role, sec in times.items())
            + f" | verify={res} tampered-rejected={good}")
    return ok


def phase_four(n_devices: int = 4, log2n_msm: int = 16, log2n_ntt: int = 16,
               num_payloads: int = 1, batch: int = 4, seed: int = 4,
               impl: str | None = None):
    """The multi-device paths against one device: sharded MSM == msm_pow2,
    sharded NTT == radix2 (and back), batched proofs all verify."""
    from zklaim_tpu.claims.circuit import ZKlaimCircuit
    from zklaim_tpu.ff import montgomery as M
    from zklaim_tpu.ff.montgomery import FR
    from zklaim_tpu.groth16.api import setup, verify
    from zklaim_tpu.ntt.radix2 import get_domain
    from zklaim_tpu.parallel.mesh import make_mesh
    from zklaim_tpu.parallel.msm import sharded_msm
    from zklaim_tpu.parallel.ntt import ShardedNTT
    from zklaim_tpu.parallel.prove import batched_prove

    rng = random.Random(seed)
    mesh = make_mesh(n_devices)
    f = JC.FQ_OPS
    host = lambda p: JC.proj_to_host_points(f, jax.tree.map(lambda a: a[None], p))[0]

    points, scalars, want = _tiled_instance(
        f, g1_generator(), 1 << log2n_msm, min(64, 1 << log2n_msm), rng
    )
    sharded, s_first, s_warm = _timed(
        lambda p, s: sharded_msm(mesh, f, p, s, c=8), points, scalars
    )
    local = P.msm_pow2(f, points, scalars, 8)
    msm_ok = host(sharded) == host(local) == want
    log(f"[four] sharded_msm g1 2^{log2n_msm} over {n_devices}: compile+run "
        f"{s_first:.2f}s warm {s_warm * 1e3:.2f}ms | == msm_pow2 == host: {msm_ok}")

    n = 1 << log2n_ntt
    plan = ShardedNTT(mesh, n)
    coeffs = jnp.asarray(M.encode_ints(FR, [rng.randrange(R) for _ in range(n)]))
    z, n_first, n_warm = _timed(lambda x: plan.ntt_t(plan.to_matrix(x)), coeffs)
    dom = get_domain(n)
    want_eval = jax.jit(dom.ntt)(coeffs, dom.device_tables())
    back = plan.intt_t(z)
    ntt_ok = _same(plan.from_transposed(z), want_eval) and _same(
        back.reshape(n, -1), coeffs)
    log(f"[four] ShardedNTT 2^{log2n_ntt} over {n_devices}: compile+run "
        f"{n_first:.2f}s warm {n_warm * 1e3:.2f}ms | == radix2 and round trip: {ntt_ok}")

    circ = ZKlaimCircuit(num_payloads)
    pk, vk, qap = setup(circ.cs, rng)
    inputs = []
    for _ in range(batch):
        ctx = _credential_context(num_payloads, rng)
        ctx.hash_payloads(rng)
        inputs.append([(p.pre, p.data_ref, p.op_positions()) for p in ctx.payloads])
    witnesses = [circ.witness(x) for x in inputs]
    t0 = time.perf_counter()
    proofs = batched_prove(mesh, pk, qap, witnesses, rng, impl=impl)
    b_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    proofs = batched_prove(mesh, pk, qap, witnesses, rng, impl=impl)
    b_warm = time.perf_counter() - t0
    prove_ok = all(
        verify(vk, circ.public_inputs(x), p) for x, p in zip(inputs, proofs)
    )
    log(f"[four] batched_prove {batch} x N={num_payloads} over {n_devices}: "
        f"compile+run {b_first:.2f}s warm {b_warm:.2f}s | all verify: {prove_ok}")
    return bool(msm_ok and ntt_ok and prove_ok)


def _peak_bytes() -> str:
    stats = jax.devices()[0].memory_stats() or {}
    return str(stats.get("peak_bytes_in_use", "not reported"))


def phase_build() -> bool:
    """nvcc build of the point kernels (set-up time, once per checkout)."""
    t0 = time.perf_counter()
    CC.build_gpu_library()
    log(f"[build] CUDA point kernels: {time.perf_counter() - t0:.1f}s")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its comparison")
    args = ap.parse_args(argv)

    require_gpu("chip_smoke")
    setup_cache()
    log(f"card: {gpu_name_and_power()}")
    log(f"jax {jax.__version__}, devices {jax.devices()}")
    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [("build", phase_build), ("kernels", phase_kernels),
                  ("msm", phase_msm), ("credential", phase_credential)]
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        good = fn()
        ok &= good
        log(f"phase {name}: {'ok' if good else 'FAILED'} in "
            f"{time.perf_counter() - t0:.1f}s, peak_bytes_in_use {_peak_bytes()}")
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark entry point: prints ONE JSON line.

Headline metric: G1 Pippenger MSM throughput (points/s) at 2^16 points
on the GPU -- the primitive that dominates Groth16 setup/prove cost.
Every result names the device it ran on (platform, device_kind, count);
without a GPU the benchmark refuses to run.

`python bench.py` runs the headline; `--full` runs the end-to-end
credential flow and reports warm prover latency instead; `--all` runs
the whole BASELINE.md surface (G1/G2 MSM at 2^16/2^20/2^22, NTT at
2^16/2^20/2^22, warm prover latency + proofs/s) and writes every row
to --out (default BENCH_FULL.json) while printing the headline line.
vs_baseline is 1.0: the reference publishes no numbers (BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp

from zklaim_tpu.utils.device import device_info, require_gpu
from zklaim_tpu.utils.jaxconfig import setup_cache


def _make_points(f, n: int, kind: str):
    """n device points: a 2^14 batch of distinct multiples of G, tiled.

    Tiling repeats points past 2^14 -- harmless for throughput
    benchmarking (scalars stay random) and it keeps the scalar ladder
    that makes them at 2^14 lanes.
    """
    import numpy as np

    from zklaim_tpu.ec import jaxcurve as JC
    from zklaim_tpu.ec.hostcurve import g1_generator, g2_generator

    from zklaim_tpu.ff.limbs import u64s_to_limbs

    base = min(n, 1 << 14)
    gen = g1_generator() if kind == "g1" else g2_generator()
    gen_dev = JC.host_points_to_proj(f, [gen])
    tiled = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (base,) + a.shape[1:]), gen_dev
    )
    small = jnp.asarray(u64s_to_limbs(np.arange(1, base + 1, dtype=np.uint64)))
    pts = jax.block_until_ready(
        jax.jit(JC.scalar_mul, static_argnums=0)(f, tiled, small)
    )
    if n > base:
        reps = n // base
        pts = jax.jit(
            lambda p: tuple(
                jnp.tile(c, (reps,) + (1,) * (c.ndim - 1)) for c in p
            )
        )(pts)
        jax.block_until_ready(pts)
    return pts


def bench_msm(log2n: int = 16, c: int = 8, runs: int = 3, kind: str = "g1"):
    from zklaim_tpu.ec import jaxcurve as JC
    from zklaim_tpu.ff.limbs import ints_to_limbs
    from zklaim_tpu.ff.params import R
    from zklaim_tpu.msm.pippenger import msm_pow2

    f = JC.FQ_OPS if kind == "g1" else JC.FQ2_OPS
    n = 1 << log2n
    points = _make_points(f, n, kind)

    import random as _random

    prng = _random.Random(20260817)
    scalars = jnp.asarray(ints_to_limbs([prng.randrange(R) for _ in range(n)]))

    jax.block_until_ready(msm_pow2(f, points, scalars, c))   # warmup
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(msm_pow2(f, points, scalars, c))
        best = min(best, time.perf_counter() - t0)
    return {
        "metric": f"{kind}_msm_2^{log2n}_points_per_sec",
        "value": round(n / best, 1),
        "unit": "points/s",
        "vs_baseline": 1.0,
    }


def bench_ntt(log2n: int = 16, runs: int = 3):
    import random as _random

    from zklaim_tpu.ff import montgomery as M
    from zklaim_tpu.ff.montgomery import FR
    from zklaim_tpu.ff.params import R
    from zklaim_tpu.ntt.radix2 import get_domain

    n = 1 << log2n
    dom = get_domain(n)
    prng = _random.Random(20260818)
    coeffs = jnp.asarray(
        M.encode_ints(FR, [prng.randrange(R) for _ in range(n)])
    )
    # twiddles as jit arguments, not inlined literals (see the
    # ntt.radix2 class comment)
    tables = dom.device_tables()
    run = jax.jit(dom.ntt)

    jax.block_until_ready(run(coeffs, tables))
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(run(coeffs, tables))
        best = min(best, time.perf_counter() - t0)
    return {
        "metric": f"ntt_fr_2^{log2n}_elems_per_sec",
        "value": round(n / best, 1),
        "unit": "elems/s",
        "vs_baseline": 1.0,
    }


def bench_prover(runs: int = 3):
    import random

    from zklaim_tpu.claims import signing
    from zklaim_tpu.claims.api import Context, Payload, ZKLAIM_OK, ZkOp

    rng = random.Random(1)
    ctx = Context()
    pl = Payload()
    pl.set_attr(23, 0)
    pl.data_ref = [18, 0, 0, 0, 0]
    pl.data_op = [ZkOp.GREATER_OR_EQ] + [ZkOp.NOOP] * 4
    ctx.add_payload(pl)
    ctx.hash_payloads(rng)
    t0 = time.perf_counter()
    assert ctx.trusted_setup(rng) == ZKLAIM_OK
    issuer_cold_s = time.perf_counter() - t0
    # steady-state issuer: the first call pays one-time compiles
    # (persisted to the on-disk cache); production issuers -- and every
    # later process -- run warm
    t0 = time.perf_counter()
    assert ctx.trusted_setup(rng) == ZKLAIM_OK
    issuer_s = time.perf_counter() - t0
    ctx.sign(signing.keygen(rng), rng)
    assert ctx.proof_generate(rng) == ZKLAIM_OK      # warmup (compiles)
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        assert ctx.proof_generate(rng) == ZKLAIM_OK
        best = min(best, time.perf_counter() - t0)
    ctx.clear_pres()
    t0 = time.perf_counter()
    assert ctx.verify() == ZKLAIM_OK
    verifier_s = time.perf_counter() - t0
    return [
        {
            "metric": "groth16_prover_latency_1payload",
            "value": round(best * 1e3, 1),
            "unit": "ms",
            "vs_baseline": 1.0,
        },
        {
            "metric": "groth16_proofs_per_sec_1payload",
            "value": round(1.0 / best, 3),
            "unit": "proofs/s",
            "vs_baseline": 1.0,
        },
        {
            "metric": "issuer_trusted_setup_1payload",
            "value": round(issuer_s * 1e3, 1),
            "unit": "ms",
            "vs_baseline": 1.0,
        },
        {
            "metric": "issuer_trusted_setup_1payload_cold",
            "value": round(issuer_cold_s * 1e3, 1),
            "unit": "ms",
            "vs_baseline": 1.0,
        },
        {
            "metric": "verifier_latency_1payload",
            "value": round(verifier_s * 1e3, 1),
            "unit": "ms",
            "vs_baseline": 1.0,
        },
        {
            "metric": "proof_size",
            "value": len(ctx.proof),
            "unit": "B",
            "vs_baseline": 1.0,
        },
        {
            "metric": "pk_size",
            "value": len(ctx.pk),
            "unit": "B",
            "vs_baseline": 1.0,
        },
        {
            "metric": "vk_size",
            "value": len(ctx.vk),
            "unit": "B",
            "vs_baseline": 1.0,
        },
    ]


def bench_batched(batch: int = 8, runs: int = 3):
    """Data-parallel batched proving throughput on the credential
    circuit (single chip: the batch axis pipelines the five MSMs and
    the NTT pipeline across proofs inside one compiled program)."""
    import random

    from zklaim_tpu.claims.api import Context, Payload, ZKLAIM_OK, ZkOp
    from zklaim_tpu.claims.circuit import ZKlaimCircuit
    from zklaim_tpu.groth16.api import setup, verify
    from zklaim_tpu.parallel.mesh import make_mesh
    from zklaim_tpu.parallel.prove import batched_prove

    rng = random.Random(7)
    ctx = Context()
    pl = Payload()
    pl.set_attr(23, 0)
    pl.data_ref = [18, 0, 0, 0, 0]
    pl.data_op = [ZkOp.GREATER_OR_EQ] + [ZkOp.NOOP] * 4
    ctx.add_payload(pl)
    ctx.hash_payloads(rng)
    circ = ZKlaimCircuit(1)
    pk, vk, qap = setup(circ.cs, rng)
    inputs = [(p.pre, p.data_ref, p.op_positions()) for p in ctx.payloads]
    w = circ.witness(inputs)
    witnesses = [w] * batch
    mesh = make_mesh(1)
    proofs = batched_prove(mesh, pk, qap, witnesses, rng)      # warmup
    primary = circ.public_inputs(inputs)
    assert all(verify(vk, primary, p) for p in proofs[:1])
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        batched_prove(mesh, pk, qap, witnesses, rng)
        best = min(best, time.perf_counter() - t0)
    return {
        "metric": f"groth16_proofs_per_sec_batch{batch}",
        "value": round(batch / best, 3),
        "unit": "proofs/s",
        "vs_baseline": 1.0,
    }


def bench_all(out_path: str):
    rows = []

    def push(row):
        row = {**row, "device": device_info()}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)

    for log2n in (16, 20, 22):
        push(bench_msm(log2n, kind="g1"))
    for log2n in (16, 20, 22):
        push(bench_msm(log2n, kind="g2"))
    for log2n in (16, 20, 22):
        push(bench_ntt(log2n))
    for row in bench_prover():
        push(row)
    push(bench_batched())
    with open(out_path, "w") as fh:
        json.dump(rows, fh, indent=1)
    headline = next(r for r in rows if r["metric"] == "g1_msm_2^16_points_per_sec")
    return headline


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="end-to-end prover latency")
    ap.add_argument("--all", action="store_true",
                    help="entire BASELINE.md surface -> --out")
    ap.add_argument("--out", default="BENCH_FULL.json")
    ap.add_argument("--log2n", type=int, default=16)
    args = ap.parse_args()
    require_gpu("bench")
    setup_cache()
    if args.all:
        result = bench_all(args.out)
    elif args.full:
        result = bench_prover()[0]
    else:
        result = bench_msm(args.log2n)
    print(json.dumps({**result, "device": device_info()}))


if __name__ == "__main__":
    main()

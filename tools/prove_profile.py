"""Phase-level timing of the warm Groth16 prover on the N=1 credential.

Times: witness build, h_pipeline (witness map + NTTs), each of the five
MSMs, device->host point decode, and the verifier.  GPU only:

    python tools/prove_profile.py
"""

from __future__ import annotations

import random
import sys
import time

sys.path.insert(0, ".")

from zklaim_tpu.utils.device import gpu_name_and_power, require_gpu
from zklaim_tpu.utils.jaxconfig import setup_cache

import jax
import jax.numpy as jnp


def _start(prog):
    info = require_gpu(prog)
    setup_cache()
    print(f"{prog}: {info} | {gpu_name_and_power()}", flush=True)


def main():
    _start("prove_profile")
    from zklaim_tpu.claims.api import Context, Payload, ZKLAIM_OK, ZkOp
    from zklaim_tpu.claims.circuit import ZKlaimCircuit
    from zklaim_tpu.ec import jaxcurve as JC
    from zklaim_tpu.groth16 import api as A
    from zklaim_tpu.groth16.api import h_pipeline, setup, verify
    from zklaim_tpu.msm.pippenger import msm_pow2

    rng = random.Random(5)
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

    sync_pt = jax.block_until_ready

    # warmup (compiles)
    w = circ.witness(inputs)
    proof = A.prove(pk, qap, w, rng)
    assert verify(vk, circ.public_inputs(inputs), proof)

    for rep in range(2):
        marks = [("start", time.perf_counter())]

        def mark(name):
            marks.append((name, time.perf_counter()))
            dt = marks[-1][1] - marks[-2][1]
            print(f"  {name:26s} {dt*1e3:9.1f} ms", flush=True)

        print(f"--- rep {rep}")
        w = circ.witness(inputs)
        mark("witness build (host)")
        w_plain = jnp.asarray(A.witness_plain_limbs(w))
        mark("witness limbs -> device")
        w_pad = jnp.pad(w_plain, ((0, qap.num_vars_pad - qap.num_vars), (0, 0)))
        h_plain, n_bad = jax.block_until_ready(h_pipeline(qap)(w_pad))
        mark("h_pipeline (wmap+NTTs)")
        ev_a = msm_pow2(JC.FQ_OPS, pk.a_g1, w_plain, 8); sync_pt(ev_a)
        mark("msm A")
        ev_b1 = msm_pow2(JC.FQ_OPS, pk.b_g1, w_plain, 8); sync_pt(ev_b1)
        mark("msm B1")
        ev_b2 = msm_pow2(JC.FQ2_OPS, pk.b_g2, w_plain, 8); sync_pt(ev_b2)
        mark("msm B2 (G2)")
        ev_h = msm_pow2(JC.FQ_OPS, pk.h_g1, h_plain, 8); sync_pt(ev_h)
        mark("msm H")
        aux_plain = w_plain[pk.num_primary + 1:]
        ev_l = msm_pow2(JC.FQ_OPS, pk.l_g1, aux_plain, 8); sync_pt(ev_l)
        mark("msm L")
        pts = [A._single(p) for p in (ev_a, ev_b1, ev_b2, ev_h, ev_l)]
        mark("device->host decode x5")
        total = marks[-1][1] - marks[0][1]
        print(f"  {'TOTAL':26s} {total*1e3:9.1f} ms")

    # verifier profile
    ctx2_primary = circ.public_inputs(inputs)
    t0 = time.perf_counter()
    ok = verify(vk, ctx2_primary, proof)
    t1 = time.perf_counter()
    print(f"groth16.verify: {1e3*(t1-t0):.1f} ms (ok={ok})")


if __name__ == "__main__":
    main()

"""Phase-level timing of the Groth16 trusted setup.

Rebuilds groth16.api.setup step by step on the real N-payload zklaim
credential circuit and prints a wall-clock breakdown: circuit build,
QAP/COO prep, host instance map (lagrange + eval_at_tau), scalar prep,
each device fixed-base table, and host point decode.  GPU only:

    python tools/setup_profile.py --payloads 1
"""

from __future__ import annotations

import argparse
import random
import sys
import time

sys.path.insert(0, ".")

from zklaim_tpu.utils.device import gpu_name_and_power, require_gpu
from zklaim_tpu.utils.jaxconfig import setup_cache

import jax


def _start(prog):
    info = require_gpu(prog)
    setup_cache()
    print(f"{prog}: {info} | {gpu_name_and_power()}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--payloads", type=int, default=1)
    args = ap.parse_args()
    _start("setup_profile")

    from zklaim_tpu.claims.circuit import ZKlaimCircuit
    from zklaim_tpu.ec import jaxcurve as JC
    from zklaim_tpu.ff.params import R
    from zklaim_tpu.groth16 import api as A
    from zklaim_tpu.groth16.qap import QAP

    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))
        dt = marks[-1][1] - marks[-2][1]
        print(f"  {name:28s} {dt*1e3:10.1f} ms", flush=True)

    circ = ZKlaimCircuit(args.payloads)
    cs = circ.cs
    mark("circuit build")
    print(f"  (constraints={cs.num_constraints}, vars={cs.num_vars})")

    qap = QAP(cs)
    mark("QAP/COO prep")

    rng = random.Random(42)
    tau = rng.randrange(1, R)
    alpha, beta, gamma, delta = (rng.randrange(1, R) for _ in range(4))
    at, bt, ct, z_tau = qap.eval_at_tau(tau)
    mark("instance map (eval_at_tau)")

    gamma_inv = pow(gamma, -1, R)
    delta_inv = pow(delta, -1, R)
    n_pub = qap.num_primary + 1
    ic_s = [(beta * at[i] + alpha * bt[i] + ct[i]) * gamma_inv % R for i in range(n_pub)]
    l_s = [
        (beta * at[i] + alpha * bt[i] + ct[i]) * delta_inv % R
        for i in range(n_pub, qap.num_vars)
    ]
    h_s = []
    t_pow = 1
    for _ in range(qap.m - 1):
        h_s.append(t_pow * z_tau % R * delta_inv % R)
        t_pow = t_pow * tau % R
    mark("scalar prep (host)")

    for name, f, kind, scal in [
        ("fixed_base a_g1", JC.FQ_OPS, "g1", at),
        ("fixed_base b_g1", JC.FQ_OPS, "g1", bt),
        ("fixed_base b_g2", JC.FQ2_OPS, "g2", bt),
        ("fixed_base h_g1", JC.FQ_OPS, "g1", h_s),
        ("fixed_base l_g1", JC.FQ_OPS, "g1", l_s),
        ("fixed_base ic", JC.FQ_OPS, "g1", ic_s),
    ]:
        out = A._fixed_base(f, kind, scal)
        jax.block_until_ready(out)
        mark(f"{name} (n={len(scal)})")
        if name == "fixed_base ic":
            ic_dev = out

    ic_host = JC.proj_to_host_points(JC.FQ_OPS, ic_dev)
    mark("ic host decode")

    total = marks[-1][1] - marks[0][1]
    print(f"  {'TOTAL':28s} {total*1e3:10.1f} ms")


if __name__ == "__main__":
    main()

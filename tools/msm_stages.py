"""Per-stage timing of the flat Pippenger pipeline on the current device.

Times CUMULATIVE PREFIXES of msm/pippenger._window_partials (each
program ends in a u32 checksum, so every stage's output is consumed);
successive differences attribute wall time to each stage: digits,
composite sort, packed gather (bit-reversed storage), upsweep tree,
bucket-tail prefixes, Abel reduction, and the doubling/Horner finish.
Stage bodies are copied from the shipped pipeline
(pippenger.py:_window_partials) so the attribution matches the
production program.  GPU only; --impl xla times the plain XLA point ops:

    python tools/msm_stages.py --log2n 15 [--g2] [--impl xla]
"""

from __future__ import annotations

import argparse
import random
import sys
import time

sys.path.insert(0, ".")

from zklaim_tpu.utils.device import gpu_name_and_power, require_gpu
from zklaim_tpu.utils.jaxconfig import setup_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _start(prog):
    info = require_gpu(prog)
    setup_cache()
    print(f"{prog}: {info} | {gpu_name_and_power()}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=16)
    ap.add_argument("--c", type=int, default=8)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--g2", action="store_true")
    ap.add_argument("--impl", choices=("kernel", "xla"), default="kernel")
    args = ap.parse_args()
    _start("msm_stages")
    impl = args.impl

    from zklaim_tpu.ec import jaxcurve as JC
    from zklaim_tpu.ff.limbs import ints_to_limbs, u64s_to_limbs
    from zklaim_tpu.ff.params import R
    from zklaim_tpu.msm import pippenger as P

    f = JC.FQ2_OPS if args.g2 else JC.FQ_OPS
    n = 1 << args.log2n
    c = args.c
    W = 256 // c
    B = 1 << (c - 1)
    M = W * n
    k = M.bit_length() - 1
    print(f"n=2^{args.log2n} c={c} W={W} B={B} flat M=2^{k}")

    from zklaim_tpu.ec.hostcurve import g1_generator, g2_generator

    gen = g2_generator() if args.g2 else g1_generator()
    gen_dev = JC.host_points_to_proj(f, [gen])
    tiled = jax.tree.map(lambda a: jnp.broadcast_to(a, (n,) + a.shape[1:]), gen_dev)
    small = jnp.asarray(u64s_to_limbs(np.arange(1, n + 1, dtype=np.uint64)))
    points = jax.block_until_ready(
        jax.jit(JC.scalar_mul, static_argnums=0)(f, tiled, small)
    )
    rng = random.Random(20260820)
    scalars = jnp.asarray(ints_to_limbs([rng.randrange(R) for _ in range(n)]))

    add = P._plane_add(f, impl)
    add_halves = P._plane_add_halves(f, impl)
    bucket_keys = (
        jnp.arange(W, dtype=jnp.int32)[:, None] * (B + 1)
        + jnp.arange(B + 1, dtype=jnp.int32)[None, :]
    ).reshape(-1)

    # --- stage bodies mirroring _window_partials -------------------------

    def stage_digits(points, scalars):
        return (P.signed_digits(scalars, c),)

    def _sort(points, scalars):
        digits = P.signed_digits(scalars, c)
        mag = jnp.abs(digits)
        keys = (jnp.arange(W, dtype=jnp.int32)[:, None] * (B + 1) + mag).reshape(-1)
        src = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (W, n))
        idx = jnp.where(
            mag == 0, 2 * n, src + jnp.where(digits < 0, n, 0)
        ).reshape(-1)
        return lax.sort_key_val(keys, idx)

    def stage_sort(points, scalars):
        return _sort(points, scalars)

    def _gather(points, scalars):
        skeys, sidx = _sort(points, scalars)
        x, y, z = points
        neg_pt = (x, f.neg(y), z)
        packed = P._pack_rows(f, points)
        packed_neg = P._pack_rows(f, neg_pt)
        inf_row = P._pack_rows(f, JC.point_infinity(f, (1,)))
        table = jnp.concatenate([packed, packed_neg, inf_row], axis=0)
        sidx_br = P._apply_bitrev(sidx, k)
        pts = jnp.swapaxes(jnp.take(table, sidx_br, axis=0), 0, 1)
        return pts, skeys

    def stage_gather(points, scalars):
        return _gather(points, scalars)

    def _upsweep(pts):
        levels = [pts]
        while levels[-1].shape[1] > 1:
            levels.append(add_halves(levels[-1]))
        return levels

    def stage_upsweep(points, scalars):
        pts, skeys = _gather(points, scalars)
        return _upsweep(pts)[-1], skeys

    def _tails(points, scalars):
        pts, skeys = _gather(points, scalars)
        levels = _upsweep(pts)
        u = jnp.searchsorted(skeys, bucket_keys, side="right") - 1
        m = u + 1
        acc = P._plane_infinity(f, m.shape[0])
        for t, lvl in enumerate(levels):
            wt = max(1, M >> t)
            nat = jnp.clip((m >> t) - 1, 0, wt - 1)
            store = P._revbits_dyn(nat, k - t) if k - t > 0 else nat
            node = jnp.take(lvl, store, axis=1)
            bit = ((m >> t) & 1) == 1
            acc = P._plane_select(bit, add(acc, node), acc)
        return acc

    def stage_tails(points, scalars):
        return _tails(points, scalars)

    def stage_partials(points, scalars):
        return P._window_partials(f, points, scalars, c, impl)

    def stage_full(points, scalars):
        tot, head = P._window_partials(f, points, scalars, c, impl)
        return P._finish(f, tot, head, c, impl)

    def checksum(fn):
        def run(points, scalars):
            out = fn(points, scalars)
            return sum(
                jnp.sum(leaf.astype(jnp.uint32))
                for leaf in jax.tree.leaves(out)
            )
        return jax.jit(run)

    prev = 0.0
    for name, fn in [
        ("digits", stage_digits),
        ("+sort", stage_sort),
        ("+gather/bitrev", stage_gather),
        ("+upsweep", stage_upsweep),
        ("+tails", stage_tails),
        ("+abel (partials)", stage_partials),
        ("+finish (FULL)", stage_full),
    ]:
        run = checksum(fn)
        jax.block_until_ready(run(points, scalars))
        best = float("inf")
        for _ in range(args.runs):
            t0 = time.perf_counter()
            jax.block_until_ready(run(points, scalars))
            best = min(best, time.perf_counter() - t0)
        print(f"  {name:20s} cum {best*1e3:9.2f} ms   (+{(best-prev)*1e3:8.2f} ms)", flush=True)
        prev = best
    print(f"  throughput @FULL: {n/prev/1e3:.1f}k pts/s")


if __name__ == "__main__":
    main()

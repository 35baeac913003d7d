"""Fixed-base multi-scalar multiplication via precomputed window tables.

Replaces libff's fixed-base window exponentiation (used throughout the
reference's Groth16 generator via libsnark; SURVEY.md §2.6 row 3) for
the setup-time pk/vk table builds: s*G for thousands of scalars s and a
FIXED generator G.

Method (comb): precompute T[w][d] = d * 2^(cw) * G on the host for all
windows w < 256/c and digits d < 2^c (one-time, ~8k host point adds,
~1.5 MiB for G1 at c=8).  Then s*G = sum_w T[w][digit_w(s)]: on device
this is a fori_loop of 32 gathers + batched complete point-adds -- a
small graph with 16x less field work than a 256-step double-and-add
ladder.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ec import jaxcurve as JC
from ..ec.hostcurve import CurvePoint, g1_generator, g2_generator
from ..ff.limbs import LIMB_BITS
from ..kernels import curve_impl


class FixedBaseTable:
    """Per-generator comb table, device-resident."""

    def __init__(self, f, gen: CurvePoint, c: int = 8):
        if LIMB_BITS % c:
            raise ValueError("window size must divide 16")
        self.f = f
        self.c = c
        self.windows = 256 // c
        rows = []
        base = gen
        for _ in range(self.windows):
            row = [CurvePoint.infinity(gen.b)]
            for _d in range((1 << c) - 1):
                row.append(row[-1] + base)
            rows.append(row)
            base = row[-1] + base           # base * 2^c
        flat = [p for row in rows for p in row]
        dev = JC.host_points_to_proj(f, flat)
        self.table = jax.tree.map(
            lambda a: a.reshape((self.windows, 1 << c) + a.shape[1:]), dev
        )

    def mul(self, scalars, impl: str = "xla"):
        """(k, 16) plain u32 limbs -> point batch (k,). Jittable.

        The comb rounds run on struct-of-arrays limb planes through the
        batched complete add chosen by `impl` (zklaim_tpu/kernels.py)."""
        from .pippenger import (
            _pack_rows, _plane_add, _plane_infinity, _planes_to_point,
        )

        c, W = self.c, self.windows
        per_limb = LIMB_BITS // c
        mask = (1 << c) - 1
        digits = jnp.stack(
            [
                (scalars[:, w // per_limb] >> (c * (w % per_limb))) & mask
                for w in range(W)
            ],
            axis=0,
        ).astype(jnp.int32)                  # (W, k)

        # packed (W * 2^c, 48*deg) row table: one gather per round
        flat_tab = jax.tree.map(
            lambda a: a.reshape((W * (1 << c),) + a.shape[2:]), self.table
        )
        packed = _pack_rows(self.f, flat_tab)
        add = _plane_add(self.f, impl)

        def body(w, acc):
            d_w = lax.dynamic_index_in_dim(digits, w, 0, keepdims=False)
            rows = jnp.take(packed, w * (1 << c) + d_w, axis=0)
            return add(acc, jnp.swapaxes(rows, 0, 1))

        acc = lax.fori_loop(0, W, body, _plane_infinity(self.f, scalars.shape[0]))
        return _planes_to_point(self.f, acc)


@lru_cache(maxsize=None)
def g1_table(c: int = 8) -> FixedBaseTable:
    return FixedBaseTable(JC.FQ_OPS, g1_generator(), c)


@lru_cache(maxsize=None)
def g2_table(c: int = 8) -> FixedBaseTable:
    return FixedBaseTable(JC.FQ2_OPS, g2_generator(), c)


def fixed_base_mul(f, gen_kind: str, scalars_limbs, c: int = 8,
                   impl: str | None = None):
    """s*G for every row of scalars_limbs; gen_kind in {'g1','g2'}."""
    table = g1_table(c) if gen_kind == "g1" else g2_table(c)
    # one jit wrapper per table (a fresh jax.jit each call re-traces)
    fn = table.__dict__.get("_mul_jit")
    if fn is None:
        fn = table._mul_jit = jax.jit(table.mul, static_argnums=1)
    return fn(scalars_limbs, curve_impl(impl))

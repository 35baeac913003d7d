"""Shared checks of the point kernels' arithmetic (ec/cuda/curve.cuh,
built for the CPU: impl "host") against ec/jaxcurve.py under XLA.  Kept
in one helper so the G1 and G2 files, which test workers run in
parallel, check the same things."""

import jax
import numpy as np

from zklaim_tpu.ec import cuda_curve as CC
from zklaim_tpu.ec import jaxcurve as JC
from zklaim_tpu.ec.hostcurve import g1_generator, g2_generator
from zklaim_tpu.ff.params import R
from zklaim_tpu.msm import pippenger as P


def group(deg):
    if deg == 1:
        return JC.FQ_OPS, g1_generator()
    return JC.FQ2_OPS, g2_generator()


def host_points(rng, gen, n, distinct=16):
    base = [gen * rng.randrange(1, R) for _ in range(min(n, distinct))]
    return [base[i % len(base)] for i in range(n)]


def planes(f, pts):
    return P._point_to_planes(f, JC.host_points_to_proj(f, pts))


def assert_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def check_add(rng, deg, n):
    """add(P, Q) == jaxcurve.point_add, including P + inf, inf + Q,
    P + P and P + (-P) where the width has room for them."""
    f, gen = group(deg)
    p_host = host_points(rng, gen, n)
    q_host = host_points(rng, gen, n)
    edits = [(0, "p_inf"), (1, "q_inf"), (2, "same"), (3, "neg")]
    for i, kind in edits[:n]:
        if kind == "p_inf":
            p_host[i] = gen * 0
        elif kind == "q_inf":
            q_host[i] = gen * 0
        elif kind == "same":
            q_host[i] = p_host[i]
        else:
            q_host[i] = -p_host[i]
    p, q = planes(f, p_host), planes(f, q_host)
    want = jax.jit(P._plane_add(f, "xla"))(p, q)
    assert_equal(jax.jit(lambda a, b: CC.point_add(deg, a, b, "host"))(p, q), want)


def check_double(rng, deg, n):
    f, gen = group(deg)
    p_host = host_points(rng, gen, n)
    p_host[0] = gen * 0
    p = planes(f, p_host)
    want = jax.jit(P._plane_double(f, "xla"))(p)
    assert_equal(CC.point_double(deg, p, "host"), want)


def check_add_halves(rng, deg, n):
    f, gen = group(deg)
    p = planes(f, host_points(rng, gen, n))
    want = jax.jit(P._plane_add(f, "xla"))(p[:, : n // 2], p[:, n // 2 :])
    assert_equal(CC.point_add_halves(deg, p, "host"), want)

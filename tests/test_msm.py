"""Pippenger MSM and batched scalar-mul vs the host golden model.

Two device paths are covered (see pippenger.msm dispatch):
  - msm_ladder (N <= ZKLAIM_MSM_LADDER_MAX): O(1)-size graph, tested
    JITTED on every backend — this is the compiled program that the
    sharded/per-shard and tiny-circuit paths actually run;
  - msm_flat (the flat single-sort pipeline): its traced graph grows
    with W*N and XLA:CPU takes tens of minutes on it, so on CPU its
    numerics are checked EAGERLY here and the compiled program is
    exercised by the gpu-marked tests below (make test-gpu) and by
    chip_smoke.py on the GPU.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zklaim_tpu.ec import jaxcurve as JC
from zklaim_tpu.ec.hostcurve import g1_generator, g1_infinity, g2_generator
from zklaim_tpu.ff.limbs import ints_to_limbs
from zklaim_tpu.ff.params import R
from zklaim_tpu.msm import pippenger as P


def host_msm(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        t = p * s
        acc = t if acc is None else acc + t
    return acc


def _to_host(f, out):
    return JC.proj_to_host_points(f, jax.tree.map(lambda a: a[None], out))[0]


def _flat_ctx():
    """Eager on CPU (flat graphs are compile-prohibitive there), jitted
    elsewhere."""
    if jax.default_backend() == "cpu":
        return jax.disable_jit()
    return contextlib.nullcontext()


def test_signed_digits_reconstruct(rng):
    c = 8
    scalars = [rng.randrange(R) for _ in range(16)] + [0, 1, R - 1]
    limbs = jnp.asarray(ints_to_limbs(scalars))
    digits = np.asarray(P.signed_digits(limbs, c))
    for i, s in enumerate(scalars):
        v = sum(int(digits[w, i]) << (c * w) for w in range(digits.shape[0]))
        assert v == s
        assert np.max(np.abs(digits[:, i])) <= 1 << (c - 1)


# --- ladder path (jitted everywhere: the small-N production program) ----


@pytest.mark.parametrize(
    "n",
    [
        5,
        pytest.param(1, marks=pytest.mark.slow),
        pytest.param(32, marks=pytest.mark.slow),
    ],
)
def test_msm_ladder_jitted(rng, n):
    gen = g1_generator()
    points = [gen * rng.randrange(1, R) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(max(0, n - 3))] + [1, 0, R - 1][:n]
    if n > 1:
        points[n // 2] = points[n // 2 - 1]  # duplicate point edge case
    want = host_msm(points, scalars)
    jac = JC.host_points_to_proj(JC.FQ_OPS, points)
    limbs = jnp.asarray(ints_to_limbs(scalars))
    out = jax.jit(P.msm, static_argnums=(0, 3))(JC.FQ_OPS, jac, limbs, 8)
    assert _to_host(JC.FQ_OPS, out) == want


@pytest.mark.slow
def test_msm_ladder_g2_jitted(rng):
    n = 4
    gen = g2_generator()
    points = [gen * rng.randrange(1, R) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    want = host_msm(points, scalars)
    jac = JC.host_points_to_proj(JC.FQ2_OPS, points)
    limbs = jnp.asarray(ints_to_limbs(scalars))
    out = jax.jit(P.msm, static_argnums=(0, 3))(JC.FQ2_OPS, jac, limbs, 4)
    assert _to_host(JC.FQ2_OPS, out) == want


@pytest.mark.slow
def test_msm_ladder_all_zero_scalars():
    n = 4
    gen = g1_generator()
    points = [gen * (i + 1) for i in range(n)]
    jac = JC.host_points_to_proj(JC.FQ_OPS, points)
    limbs = jnp.asarray(ints_to_limbs([0] * n))
    out = jax.jit(P.msm, static_argnums=(0, 3))(JC.FQ_OPS, jac, limbs, 4)
    assert _to_host(JC.FQ_OPS, out) == g1_infinity()


@pytest.mark.slow
def test_msm_dispatch_threshold(rng, monkeypatch):
    """msm() routes small N to the ladder, large N to the flat pipeline."""
    monkeypatch.setenv("ZKLAIM_MSM_LADDER_MAX", "4")
    n = 8
    gen = g1_generator()
    points = [gen * rng.randrange(1, R) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    want = host_msm(points, scalars)
    jac = JC.host_points_to_proj(JC.FQ_OPS, points)
    limbs = jnp.asarray(ints_to_limbs(scalars))
    with _flat_ctx():
        out = P.msm(JC.FQ_OPS, jac, limbs, 4)   # above threshold -> flat
    assert _to_host(JC.FQ_OPS, out) == want
    monkeypatch.setenv("ZKLAIM_MSM_LADDER_MAX", "512")
    out = jax.jit(P.msm, static_argnums=(0, 3))(JC.FQ_OPS, jac, limbs, 4)
    assert _to_host(JC.FQ_OPS, out) == want


# --- flat pipeline numerics (eager on CPU; compiled covered on GPU) -----

@pytest.mark.slow
@pytest.mark.parametrize("c", [4, 8])
def test_msm_flat_g1(rng, c):
    n = 32
    gen = g1_generator()
    points = [gen * rng.randrange(1, R) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n - 3)] + [0, 1, R - 1]
    points[5] = points[4]
    want = host_msm(points, scalars)
    jac = JC.host_points_to_proj(JC.FQ_OPS, points)
    limbs = jnp.asarray(ints_to_limbs(scalars))
    with _flat_ctx():
        out = P.msm_flat(JC.FQ_OPS, jac, limbs, c)
    assert _to_host(JC.FQ_OPS, out) == want


@pytest.mark.slow
def test_msm_flat_g2(rng):
    n = 8
    gen = g2_generator()
    points = [gen * rng.randrange(1, R) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    want = host_msm(points, scalars)
    jac = JC.host_points_to_proj(JC.FQ2_OPS, points)
    limbs = jnp.asarray(ints_to_limbs(scalars))
    with _flat_ctx():
        out = P.msm_flat(JC.FQ2_OPS, jac, limbs, 4)
    assert _to_host(JC.FQ2_OPS, out) == want


@pytest.mark.slow
def test_msm_chunked_path(rng, monkeypatch):
    """Large-input scan-over-chunks path matches the direct kernel."""
    monkeypatch.setitem(P.MAX_CHUNK, 1, 16)
    monkeypatch.setenv("ZKLAIM_MSM_LADDER_MAX", "0")
    n = 40  # pads to 48 = 3 chunks of 16
    gen = g1_generator()
    points = [gen * rng.randrange(1, R) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    want = host_msm(points, scalars)
    jac = JC.host_points_to_proj(JC.FQ_OPS, points)
    limbs = jnp.asarray(ints_to_limbs(scalars))
    with _flat_ctx():
        out = P.msm_pow2(JC.FQ_OPS, jac, limbs, 4)
    assert _to_host(JC.FQ_OPS, out) == want


@pytest.mark.slow
def test_scalar_mul_batched(rng):
    gen = g1_generator()
    points = [gen * k for k in (1, 2, 3, 4)]
    scalars = [rng.randrange(R) for _ in range(3)] + [0]
    want = [p * s for p, s in zip(points, scalars)]
    jac = JC.host_points_to_proj(JC.FQ_OPS, points)
    limbs = jnp.asarray(ints_to_limbs(scalars))
    out = jax.jit(JC.scalar_mul, static_argnums=0)(JC.FQ_OPS, jac, limbs)
    assert JC.proj_to_host_points(JC.FQ_OPS, out) == want


@pytest.mark.slow
def test_msm_flat_pallas_path_matches(rng):
    """The point kernels' arithmetic (host build on CPU) == XLA path."""
    n = 16
    gen = g1_generator()
    points = [gen * rng.randrange(1, R) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n - 2)] + [0, 1]
    want = host_msm(points, scalars)
    jac = JC.host_points_to_proj(JC.FQ_OPS, points)
    limbs = jnp.asarray(ints_to_limbs(scalars))
    with _flat_ctx():
        out = P.msm_flat(JC.FQ_OPS, jac, limbs, 8, "host")
    assert _to_host(JC.FQ_OPS, out) == want


# --- compiled flat pipeline on the GPU ----------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("deg,c,n", [(1, 8, 1 << 10), (2, 4, 1 << 9)])
def test_msm_flat_compiled_gpu(gpu, rng, deg, c, n):
    """The JITTED flat pipeline (the program bench.py measures) is
    correct on the GPU with the compiled point kernels."""
    f = JC.FQ_OPS if deg == 1 else JC.FQ2_OPS
    gen = g1_generator() if deg == 1 else g2_generator()
    points = [gen * rng.randrange(1, R) for _ in range(4)]
    # tile to n with small scalars so the host model stays cheap
    reps = [points[i % 4] for i in range(n)]
    scalars = [rng.randrange(1 << 16) for _ in range(n)]
    want = host_msm(reps, scalars)
    jac = JC.host_points_to_proj(f, reps)
    limbs = jnp.asarray(ints_to_limbs(scalars))
    out = jax.jit(P.msm_flat, static_argnums=(0, 3, 4))(f, jac, limbs, c, "kernel")
    assert _to_host(f, out) == want

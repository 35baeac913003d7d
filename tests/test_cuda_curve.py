"""Point kernels (ec/cuda_curve.py) == XLA point ops, bit-exact.

On the CPU the kernels' source runs as a host build (impl "host"); the
tests marked `gpu` run the compiled CUDA kernels at MSM widths.  G2
lives in test_cuda_curve_g2.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zklaim_tpu.ec import cuda_curve as CC
from zklaim_tpu.ec import jaxcurve as JC
from zklaim_tpu.ff.limbs import ints_to_limbs
from zklaim_tpu.ff.params import R
from zklaim_tpu.msm import pippenger as P
from zklaim_tpu.msm.fixedbase import fixed_base_mul

import _curve_cases as C


@pytest.mark.parametrize("n", [1, 3, 130, 256])
def test_g1_add_matches_xla(rng, n):
    C.check_add(rng, 1, n)


@pytest.mark.parametrize("n", [1, 130])
def test_g1_double_matches_xla(rng, n):
    C.check_double(rng, 1, n)


@pytest.mark.parametrize("n", [2, 6, 256])
def test_g1_add_halves_matches_xla(rng, n):
    C.check_add_halves(rng, 1, n)


@pytest.mark.parametrize(
    "shape,dtype", [((47, 4), jnp.uint32), ((48, 4), jnp.int32), ((48,), jnp.uint32)]
)
def test_rejects_bad_planes(shape, dtype):
    with pytest.raises(ValueError):
        CC.point_add(1, jnp.zeros(shape, dtype), jnp.zeros(shape, dtype), "host")


def test_halves_rejects_odd_width():
    with pytest.raises(ValueError):
        CC.point_add_halves(1, jnp.zeros((48, 5), jnp.uint32), "host")


def test_planes_round_trip(rng):
    for deg in (1, 2):
        f, gen = C.group(deg)
        pt = JC.host_points_to_proj(f, C.host_points(rng, gen, 5))
        back = P._planes_to_point(f, P._point_to_planes(f, pt))
        for a, b in zip(pt, back):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_msm_flat_with_kernel_arithmetic(rng):
    """The whole flat pipeline (upsweep halves, tail prefixes, Abel
    reduction, Horner finish) on the kernels' arithmetic == host MSM."""
    n = 16
    f, gen = C.group(1)
    pts = [gen * rng.randrange(1, R) for _ in range(n)]
    pts[5] = pts[4]
    sc = [rng.randrange(R) for _ in range(n - 3)] + [0, 1, R - 1]
    want = None
    for p, s in zip(pts, sc):
        want = p * s if want is None else want + p * s
    out = jax.jit(P.msm_flat, static_argnums=(0, 3, 4))(
        f, JC.host_points_to_proj(f, pts), jnp.asarray(ints_to_limbs(sc)), 8, "host"
    )
    got = JC.proj_to_host_points(f, jax.tree.map(lambda a: a[None], out))[0]
    assert got == want


def test_fixed_base_with_kernel_arithmetic(rng):
    f, gen = C.group(1)
    sc = [rng.randrange(R) for _ in range(5)] + [0, 1, R - 1]
    out = fixed_base_mul(f, "g1", jnp.asarray(ints_to_limbs(sc)), impl="host")
    assert JC.proj_to_host_points(f, out) == [gen * s for s in sc]


@pytest.mark.gpu
@pytest.mark.parametrize("deg", [1, 2])
def test_compiled_kernels_at_msm_width(gpu, deg):
    """The compiled kernels at an MSM level width, against XLA."""
    import chip_smoke

    assert chip_smoke.phase_kernels(widths=((deg, 15),))

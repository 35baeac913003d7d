"""G2 point kernels' arithmetic == XLA, bit-exact (host build on the
CPU).  See test_cuda_curve.py."""

import pytest

import _curve_cases as C


@pytest.mark.parametrize("n", [1, 3, 130, 256])
def test_g2_add_matches_xla(rng, n):
    C.check_add(rng, 2, n)


def test_g2_double_matches_xla(rng):
    C.check_double(rng, 2, 3)


def test_g2_add_halves_matches_xla(rng):
    C.check_add_halves(rng, 2, 8)

"""Known-answer tests: batched limb/Montgomery device code vs Python ints."""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zklaim_tpu.ff import montgomery as M
from zklaim_tpu.ff.limbs import ints_to_limbs, limbs_to_ints, u64s_to_limbs, limbs_to_int, int_to_limbs
from zklaim_tpu.ff.params import MONT_R, Q, R

SPECS = [M.FQ, M.FR]


def rand_ints(n, p, seed):
    rnd = random.Random(seed)
    # mix of random, small, and boundary values
    vals = [rnd.randrange(p) for _ in range(n - 4)]
    vals += [0, 1, p - 1, p - 2]
    return vals


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_encode_decode_roundtrip(spec):
    vals = rand_ints(16, spec.p, 11)
    enc = M.encode_ints(spec, vals)
    dec = M.decode_ints(spec, enc)
    assert dec == vals


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mont_mul_matches_host(spec):
    n = 64
    a = rand_ints(n, spec.p, 21)
    b = rand_ints(n, spec.p, 22)
    am = jnp.asarray(M.encode_ints(spec, a))
    bm = jnp.asarray(M.encode_ints(spec, b))
    prod = jax.jit(M.mont_mul, static_argnums=0)(spec, am, bm)
    got = M.decode_ints(spec, prod)
    want = [(x * y) % spec.p for x, y in zip(a, b)]
    assert got == want


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_add_sub_neg(spec):
    n = 64
    a = rand_ints(n, spec.p, 31)
    b = rand_ints(n, spec.p, 32)
    am = jnp.asarray(M.encode_ints(spec, a))
    bm = jnp.asarray(M.encode_ints(spec, b))
    s = M.decode_ints(spec, M.add_mod(spec, am, bm))
    d = M.decode_ints(spec, M.sub_mod(spec, am, bm))
    ng = M.decode_ints(spec, M.neg_mod(spec, am))
    # mont domain is linear, so add/sub/neg of encodings decode to add/sub/neg
    assert s == [(x + y) % spec.p for x, y in zip(a, b)]
    assert d == [(x - y) % spec.p for x, y in zip(a, b)]
    assert ng == [(-x) % spec.p for x in a]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mont_inv(spec):
    vals = [1, 2, spec.p - 1, 12345, 0]  # 0 -> 0 convention
    am = jnp.asarray(M.encode_ints(spec, vals))
    inv = M.decode_ints(spec, jax.jit(M.mont_inv, static_argnums=0)(spec, am))
    for v, iv in zip(vals, inv):
        if v == 0:
            assert iv == 0
        else:
            assert (v * iv) % spec.p == 1


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_to_from_mont(spec):
    vals = rand_ints(8, spec.p, 41)
    plain = jnp.asarray(ints_to_limbs(vals))
    m = M.to_mont(spec, plain)
    back = M.from_mont(spec, m)
    assert limbs_to_ints(np.asarray(back)) == vals
    # to_mont(x) literally equals x*R mod p
    assert limbs_to_ints(np.asarray(m)) == [(v * MONT_R) % spec.p for v in vals]


def test_u64_vectorized_conversion():
    xs = np.array([0, 1, 2**40, 2**64 - 1], dtype=np.uint64)
    limbs = u64s_to_limbs(xs)
    assert [limbs_to_int(l) for l in limbs] == [0, 1, 2**40, 2**64 - 1]


def test_eq_iszero():
    a = jnp.asarray(M.encode_ints(M.FQ, [0, 5, 7]))
    b = jnp.asarray(M.encode_ints(M.FQ, [0, 5, 8]))
    assert list(np.asarray(M.is_zero(a))) == [True, False, False]
    assert list(np.asarray(M.eq(a, b))) == [True, True, False]


def test_batched_2d_shapes():
    spec = M.FQ
    vals = rand_ints(12, spec.p, 51)
    am = jnp.asarray(M.encode_ints(spec, vals)).reshape(3, 4, 16)
    out = M.mont_mul(spec, am, am)
    got = M.decode_ints(spec, out)
    assert got == [(v * v) % spec.p for v in vals]

"""Multi-chip kernels on the virtual 8-device CPU mesh: sharded == local."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zklaim_tpu.ec import jaxcurve as JC
from zklaim_tpu.ec.hostcurve import g1_generator
from zklaim_tpu.ff.limbs import ints_to_limbs
from zklaim_tpu.ff.params import R
from zklaim_tpu.msm.pippenger import msm
from zklaim_tpu.parallel.mesh import make_mesh
from zklaim_tpu.parallel.msm import sharded_msm



@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (default test platform)")


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_msm_matches_local(rng):
    mesh = make_mesh(8)
    n = 32
    gen = g1_generator()
    points = [gen * rng.randrange(1, R) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    jac = JC.host_points_to_proj(JC.FQ_OPS, points)
    limbs = jnp.asarray(ints_to_limbs(scalars))

    local = jax.jit(msm, static_argnums=(0, 3))(JC.FQ_OPS, jac, limbs, 4)
    shard = sharded_msm(mesh, JC.FQ_OPS, jac, limbs, c=4)

    single = lambda p: JC.proj_to_host_points(
        JC.FQ_OPS, jax.tree.map(lambda a: a[None], p)
    )[0]
    assert single(shard) == single(local)


def test_sharded_ntt_matches_local(rng):
    from zklaim_tpu.ff import montgomery as M
    from zklaim_tpu.ff.montgomery import FR
    from zklaim_tpu.ntt.radix2 import get_domain
    from zklaim_tpu.parallel.ntt import ShardedNTT

    mesh = make_mesh(8)
    # small n: XLA's SPMD partitioner compiles these wide-limb graphs
    # ~20x slower than single-device (224s vs 11s for n=256 on CPU), so
    # the correctness check uses the smallest 8-shardable size
    n = 64
    plan = ShardedNTT(mesh, n)
    coeffs = [rng.randrange(R) for _ in range(n)]
    x = jnp.asarray(M.encode_ints(FR, coeffs))

    want = M.decode_ints(FR, get_domain(n).ntt(x))
    z = plan.ntt_t(plan.to_matrix(x))
    got = M.decode_ints(FR, plan.from_transposed(z))
    assert got == want

    # inverse consumes the transposed layout and returns natural order
    back = M.decode_ints(FR, plan.intt_t(z).reshape(n, 16))
    assert back == coeffs

    # pointwise op in transposed order == local pipeline (Groth16 H shape)
    sq_local = M.decode_ints(
        FR, get_domain(n).intt(M.mont_mul(FR, get_domain(n).ntt(x), get_domain(n).ntt(x)))
    )
    sq_shard = M.decode_ints(FR, plan.intt_t(M.mont_mul(FR, z, z)).reshape(n, 16))
    assert sq_shard == sq_local


def test_sharded_msm_rejects_bad_shard_count(rng):
    mesh = make_mesh(8)
    gen = g1_generator()
    jac = JC.host_points_to_proj(JC.FQ_OPS, [gen] * 12)
    limbs = jnp.asarray(ints_to_limbs([1] * 12))
    with pytest.raises(ValueError):
        sharded_msm(mesh, JC.FQ_OPS, jac, limbs, c=4)

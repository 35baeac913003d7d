"""Data-parallel batched Groth16 proving over a device mesh.

The reference proves one credential per process (single-process CPU
library; SURVEY.md §2.6 last row names "data-parallel batched proving
across chips/hosts" as a first-class new capability).  This module
proves k independent statements of the SAME circuit simultaneously:
the witness batch axis is sharded over the mesh, each device runs the
full device pipeline (sparse witness map -> NTT H coefficients -> five
MSMs) for its slice via vmap, and only the per-proof finishing
(r/s blinding, +alpha/+beta single-point adds -- microseconds of host
work) stays sequential.

Semantics match groth16.api.prove exactly: result i verifies against
the same vk/public inputs as a sequential prove of witness i.

Memory model: the pk tables are REPLICATED to every device (in_axes
None) -- inherent to data parallelism, where each device proves its own
statements against the full key.  At zklaim sweep sizes that is ~10 MB
(N=1) to ~200 MB (N=20) of device memory per device.  When a single
proof's key outgrows one device, the model-parallel alternative is
parallel.msm.sharded_msm (point axis partitioned, O(devices)
communication) driven per MSM -- the two compose as a 2-D
(batch, shard) mesh.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..ec import jaxcurve as JC
from ..ff import montgomery as M
from ..ff.limbs import ints_to_limbs
from ..ff.montgomery import FR
from ..ff.params import R
from ..groth16.api import Proof, ProvingKey
from ..kernels import curve_impl
from ..msm.pippenger import msm


def _pad_pow2(f, points):
    """Pad a projective pytree's point axis up to a power of two."""
    n = jax.tree.leaves(points)[0].shape[0]
    n2 = max(2, 1 << (n - 1).bit_length()) if n > 1 else 2
    if n2 == n:
        return points, n
    inf = JC.point_infinity(f, (n2 - n,))
    return (
        jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0), points, inf),
        n,
    )


def batched_prove(
    mesh, pk: ProvingKey, qap, witnesses: list, rng, msm_c: int = 8,
    axis: str = "shards", impl: str | None = None,
) -> list:
    """Prove every witness in `witnesses` (full assignments, same circuit).

    Returns a list of Proof in input order.  The batch is padded to a
    multiple of the mesh size; padding lanes recompute witness 0 and are
    dropped.  rng supplies the per-proof (r, s) blinding scalars.  impl:
    point-op implementation of the MSMs (zklaim_tpu/kernels.py).
    """
    impl = curve_impl(impl)
    k = len(witnesses)
    if k == 0:
        return []

    S = mesh.shape[axis]
    kp = ((k + S - 1) // S) * S
    padded = list(witnesses) + [witnesses[0]] * (kp - k)

    w_mont = np.stack([M.encode_ints(FR, w) for w in padded])
    w_plain = np.stack([ints_to_limbs(w) for w in padded])
    n_waves = kp // S

    a_pts, n_vars = _pad_pow2(JC.FQ_OPS, pk.a_g1)
    b1_pts, _ = _pad_pow2(JC.FQ_OPS, pk.b_g1)
    b2_pts, _ = _pad_pow2(JC.FQ2_OPS, pk.b_g2)
    l_pts, n_aux = _pad_pow2(JC.FQ_OPS, pk.l_g1)
    # h_g1 has m-1 points; h_coefficients emits m (last identically zero),
    # so pad the point table to m and feed all m scalars.
    h_pts, _ = _pad_pow2(JC.FQ_OPS, pk.h_g1)
    n_pow2 = jax.tree.leaves(a_pts)[0].shape[0]
    h_pow2 = jax.tree.leaves(h_pts)[0].shape[0]
    aux_pow2 = jax.tree.leaves(l_pts)[0].shape[0]
    n_primary1 = pk.num_primary + 1

    def per_witness(wm, wp, tabs, dev):
        # satisfaction check rides the constraint evaluations the
        # witness map needs anyway (device-side; the old per-witness
        # HOST is_satisfied loop cost ~0.5 s x batch on the real
        # circuit and skewed every batched-prove measurement)
        evals = qap.constraint_evals(wm, dev["coo"])
        a_ev, b_ev, c_ev = evals
        bad = jnp.sum(jnp.any(M.mont_mul(FR, a_ev, b_ev) != c_ev, axis=-1))
        h_mont = qap.h_coefficients(wm, evals=evals, dev=dev)  # (m, 16)
        h_plain = M.from_mont(FR, h_mont)
        h_sc = jnp.pad(h_plain, ((0, h_pow2 - qap.m), (0, 0)))
        w_sc = jnp.pad(wp, ((0, n_pow2 - qap.num_vars), (0, 0)))
        aux = wp[n_primary1:]
        aux_sc = jnp.pad(aux, ((0, aux_pow2 - n_aux), (0, 0)))
        a_p, b1_p, b2_p, h_p, l_p = tabs
        return (
            bad,
            msm(JC.FQ_OPS, a_p, w_sc, msm_c, impl),
            msm(JC.FQ_OPS, b1_p, w_sc, msm_c, impl),
            msm(JC.FQ2_OPS, b2_p, w_sc, msm_c, impl),
            msm(JC.FQ_OPS, h_p, h_sc, msm_c, impl),
            msm(JC.FQ_OPS, l_p, aux_sc, msm_c, impl),
        )

    # pk tables + COO/twiddles ride as jit arguments (in_axes=None),
    # not closed-over constants: captured constants are inlined into
    # the HLO as literals -- see groth16.qap.device_args.
    tabs = (a_pts, b1_pts, b2_pts, h_pts, l_pts)
    # shard_map, not a partitioned jit: each device runs the vmapped
    # pipeline on its own slice, so the point kernels (FFI custom calls)
    # never meet the SPMD partitioner.
    fn = jax.jit(shard_map(
        jax.vmap(per_witness, in_axes=(0, 0, None, None)),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    ))
    # The batch is processed in MESH-SIZED WAVES (vmap width exactly 1
    # per device per wave): one compiled program reused n_waves times,
    # with the per-device layout an S-device mesh uses.  Whether a wider
    # per-device vmap pays on the GPU is not measured.
    dev = qap.device_args()
    wave_evs = []
    for wv in range(n_waves):
        sl = slice(wv * S, (wv + 1) * S)
        wave_evs.append(
            fn(jnp.asarray(w_mont[sl]), jnp.asarray(w_plain[sl]), tabs, dev)
        )
    wave_evs = jax.device_get(wave_evs)
    evs = jax.tree.map(
        lambda *xs: np.concatenate(xs, axis=0), *wave_evs
    )
    bad_b, ev_a_b, ev_b1_b, ev_b2_b, ev_h_b, ev_l_b = evs
    bad_counts = np.asarray(bad_b)
    if bad_counts[:k].any():
        i = int(np.argmax(bad_counts[:k] > 0))
        raise ValueError(
            f"witness {i} unsatisfied: {qap.cs.first_unsatisfied(witnesses[i])}"
        )

    a_host = JC.proj_to_host_points(JC.FQ_OPS, ev_a_b)
    b1_host = JC.proj_to_host_points(JC.FQ_OPS, ev_b1_b)
    b2_host = JC.proj_to_host_points(JC.FQ2_OPS, ev_b2_b)
    h_host = JC.proj_to_host_points(JC.FQ_OPS, ev_h_b)
    l_host = JC.proj_to_host_points(JC.FQ_OPS, ev_l_b)

    proofs = []
    for i in range(k):
        r = rng.randrange(R)
        s = rng.randrange(R)
        a_pt = pk.alpha_g1 + a_host[i] + pk.delta_g1 * r
        b2_pt = pk.beta_g2 + b2_host[i] + pk.delta_g2 * s
        b1_pt = pk.beta_g1 + b1_host[i] + pk.delta_g1 * s
        c_pt = (
            l_host[i] + h_host[i] + a_pt * s + b1_pt * r
            - pk.delta_g1 * (r * s % R)
        )
        proofs.append(Proof(a=a_pt, b=b2_pt, c=c_pt))
    return proofs

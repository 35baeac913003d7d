"""Groth16 zk-SNARK: setup / prove / verify.

Replacement for libsnark's r1cs_gg_ppzksnark_{generator,
prover, verifier_strong_IC} (reference call sites zklaim/snark.cpp:91,
126,62; SURVEY.md §2.6 row 5).

Work placement:
  - setup: QAP instance map on host ints (exact), then device batched
    fixed-base exponentiation for the large pk tables;
  - prove: device sparse-matvec + NTT pipeline for H, device Pippenger
    MSMs for the five big sums, host single-point finishing;
  - verify: host optimal-ate pairing product (latency-bound, 4 pairings).

Proof system notes: identical to Groth16 as instantiated by libsnark
(BN254, input-consistency rows, H from a same-size coset).  The prover
early-aborts if the witness does not satisfy the constraint system,
mirroring snark.cpp:121-124.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from ..ec import jaxcurve as JC
from ..ec.hostcurve import CurvePoint, g1_generator, g2_generator
from ..ec.pairing import pairing_product_is_one
from ..ff import montgomery as M
from ..ff.limbs import ints_to_limbs
from ..ff.montgomery import FR
from ..ff.params import R
from ..msm.pippenger import msm_pow2
from .qap import QAP


def _fixed_base(f, gen_kind: str, scalars, impl=None):
    """Device batched fixed-base multiplication: [s * G for s in scalars].

    Uses the precomputed comb table (msm.fixedbase); scalar count is
    padded to a power of two so call sites share log-many XLA compiles.
    """
    from ..msm.fixedbase import fixed_base_mul

    k = len(scalars)
    if k == 0:
        return JC.point_infinity(f, (0,))
    k2 = max(2, 1 << (k - 1).bit_length())
    padded = [s % R for s in scalars] + [0] * (k2 - k)
    limbs = jnp.asarray(ints_to_limbs(padded))
    out = fixed_base_mul(f, gen_kind, limbs, impl=impl)
    return jax.tree.map(lambda a: a[:k], out)


def _single(points_dev, i=None):
    """Decode a device point (batch () or pick index i) to a host CurvePoint."""
    if i is not None:
        points_dev = jax.tree.map(lambda a: a[i], points_dev)
    batched = jax.tree.map(lambda a: a[None], points_dev)
    f = JC.FQ_OPS if batched[0].ndim == 2 else JC.FQ2_OPS
    return JC.proj_to_host_points(f, batched)[0]


@dataclass
class ProvingKey:
    num_vars: int
    num_primary: int
    m: int
    alpha_g1: CurvePoint
    beta_g1: CurvePoint
    delta_g1: CurvePoint
    beta_g2: CurvePoint
    delta_g2: CurvePoint
    a_g1: tuple          # (num_vars,) G1
    b_g1: tuple          # (num_vars,) G1
    b_g2: tuple          # (num_vars,) G2
    h_g1: tuple          # (m-1,)      G1
    l_g1: tuple          # (num_aux,)  G1


@dataclass
class VerifyingKey:
    alpha_g1: CurvePoint
    beta_g2: CurvePoint
    gamma_g2: CurvePoint
    delta_g2: CurvePoint
    ic: list             # num_primary + 1 host G1 points


@dataclass
class Proof:
    a: CurvePoint
    b: CurvePoint
    c: CurvePoint


def setup(cs, rng, impl=None) -> tuple[ProvingKey, VerifyingKey, QAP]:
    """Trusted setup over a finished ConstraintSystem.

    rng: random.Random-like (inject a seeded one for deterministic tests;
    the caller owns destroying the toxic waste by dropping rng state).
    impl: point-op implementation (zklaim_tpu/kernels.py).
    """
    qap = QAP(cs)
    tau = rng.randrange(1, R)
    alpha = rng.randrange(1, R)
    beta = rng.randrange(1, R)
    gamma = rng.randrange(1, R)
    delta = rng.randrange(1, R)

    at, bt, ct, z_tau = qap.eval_at_tau(tau)
    gamma_inv = pow(gamma, -1, R)
    delta_inv = pow(delta, -1, R)

    n_pub = qap.num_primary + 1
    ic_scalars = [
        (beta * at[i] + alpha * bt[i] + ct[i]) * gamma_inv % R for i in range(n_pub)
    ]
    l_scalars = [
        (beta * at[i] + alpha * bt[i] + ct[i]) * delta_inv % R
        for i in range(n_pub, qap.num_vars)
    ]
    h_scalars = []
    t_pow = 1
    for _ in range(qap.m - 1):
        h_scalars.append(t_pow * z_tau % R * delta_inv % R)
        t_pow = t_pow * tau % R

    g1, g2 = g1_generator(), g2_generator()
    # ONE batched device call for every G1 table (a, b, h, l, ic
    # concatenated): one compile + one dispatch instead of five (the r4
    # setup profile was dominated by per-call compile/dispatch overhead)
    segs = [at, bt, h_scalars, l_scalars, ic_scalars]
    bounds = np.cumsum([0] + [len(s) for s in segs])
    all_g1 = _fixed_base(JC.FQ_OPS, "g1", [x for s in segs for x in s], impl)
    a_dev, b1_dev, h_dev, l_dev, ic_dev = (
        jax.tree.map(lambda a: a[bounds[i] : bounds[i + 1]], all_g1)
        for i in range(5)
    )
    pk = ProvingKey(
        num_vars=qap.num_vars,
        num_primary=qap.num_primary,
        m=qap.m,
        alpha_g1=g1 * alpha,
        beta_g1=g1 * beta,
        delta_g1=g1 * delta,
        beta_g2=g2 * beta,
        delta_g2=g2 * delta,
        a_g1=a_dev,
        b_g1=b1_dev,
        b_g2=_fixed_base(JC.FQ2_OPS, "g2", bt, impl),
        h_g1=h_dev,
        l_g1=l_dev,
    )
    vk = VerifyingKey(
        alpha_g1=g1 * alpha,
        beta_g2=g2 * beta,
        gamma_g2=g2 * gamma,
        delta_g2=g2 * delta,
        ic=JC.proj_to_host_points(JC.FQ_OPS, ic_dev),
    )
    return pk, vk, qap


_H_PIPELINE_CACHE: dict = {}


def h_pipeline(qap: QAP):
    """ONE jitted program: plain witness -> mont encode -> satisfaction
    check -> witness map -> NTT -> plain H coefficients.

    One program, not eager per-op dispatch: un-jitted, every limb op of
    the witness map and the NTT is its own launch.  Memoized on the QAP.
    The MSMs stay as separate msm_pow2 programs on purpose: a/b1/h/l
    share one compiled program (same shapes), which a fused mega-jit
    would forfeit.

    The satisfaction check (reference early-abort, snark.cpp:121-124)
    rides the constraint evaluations the witness map needs anyway:
    mont_mul(<A_j,w>, <B_j,w>) == <C_j,w> on every domain row (the
    input-consistency tail rows hold trivially: B row is empty).
    """
    fn = getattr(qap, "_h_fn", None)
    if fn is None:
        # ONE jit wrapper per SHAPE SIGNATURE, not per QAP object: the
        # traced program depends only on (m, padded nnz, padded vars) --
        # every tensor rides as an argument -- so payload counts sharing
        # a domain bucket share the compiled executable.  (A per-QAP
        # jax.jit recompiled an identical ~200 s program for every N of
        # the benchmark sweep.)
        key = (
            qap.m,
            qap.num_vars_pad,
            tuple(int(qap.coo_dev[k][0].shape[0]) for k in ("A", "B", "C")),
        )
        jfn = _H_PIPELINE_CACHE.get(key)
        if jfn is None:

            def run(w_plain, dev, _q=qap):
                w_mont = M.to_mont(FR, w_plain)
                evals = _q.constraint_evals(w_mont, dev["coo"])
                a_ev, b_ev, c_ev = evals
                bad = jnp.any(M.mont_mul(FR, a_ev, b_ev) != c_ev, axis=-1)
                h_mont = _q.h_coefficients(w_mont, evals, dev)
                return M.from_mont(FR, h_mont)[: _q.m - 1], jnp.sum(bad)

            # COO + twiddles ride as jit arguments, not closed-over HLO
            # literals (see qap.device_args)
            jfn = _H_PIPELINE_CACHE[key] = jax.jit(run)
        fn = qap._h_fn = lambda w_plain: jfn(w_plain, qap.device_args())
    return fn


def witness_plain_limbs(witness) -> np.ndarray:
    """(num_vars, 16) u32 plain-domain limbs from either witness form."""
    to_limbs = getattr(witness, "to_plain_limbs", None)
    if to_limbs is not None:
        return to_limbs()
    return ints_to_limbs(witness)


def prove(pk: ProvingKey, qap: QAP, witness, rng, msm_c: int = 8,
          impl=None) -> Proof:
    """Groth16 prover.  witness: full assignment [1, primary..., aux...]
    (list[int] or r1cs.system.WitnessVec).  impl: point-op
    implementation of the MSMs (zklaim_tpu/kernels.py)."""
    r = rng.randrange(R)
    s = rng.randrange(R)

    w_plain = jnp.asarray(witness_plain_limbs(witness))

    # pow2-padded witness into the h pipeline: with the padded COO
    # (qap.coo_dev) the traced shapes depend only on the m bucket, so
    # payload counts sharing a domain size share ONE compiled program
    w_pad = jnp.pad(w_plain, ((0, qap.num_vars_pad - qap.num_vars), (0, 0)))
    h_plain, n_bad = h_pipeline(qap)(w_pad)
    if int(n_bad):
        raise ValueError(
            f"unsatisfied constraint: {qap.cs.first_unsatisfied(witness)}"
        )

    # dispatch all five MSM programs asynchronously, then pull every
    # result in ONE device_get: one device-to-host transfer instead of a
    # synchronising pull per point
    aux_plain = w_plain[pk.num_primary + 1 :]
    devs = [
        msm_pow2(JC.FQ_OPS, pk.a_g1, w_plain, msm_c, impl),
        msm_pow2(JC.FQ_OPS, pk.b_g1, w_plain, msm_c, impl),
        msm_pow2(JC.FQ2_OPS, pk.b_g2, w_plain, msm_c, impl),
        msm_pow2(JC.FQ_OPS, pk.h_g1, h_plain, msm_c, impl),
        msm_pow2(JC.FQ_OPS, pk.l_g1, aux_plain, msm_c, impl),
    ]
    host = jax.device_get(devs)
    ev_a, ev_b1, ev_b2, ev_h, ev_l = (
        _single(p) for p in host
    )

    a_pt = pk.alpha_g1 + ev_a + pk.delta_g1 * r
    b2_pt = pk.beta_g2 + ev_b2 + pk.delta_g2 * s
    b1_pt = pk.beta_g1 + ev_b1 + pk.delta_g1 * s
    c_pt = ev_l + ev_h + a_pt * s + b1_pt * r - pk.delta_g1 * (r * s % R)
    return Proof(a=a_pt, b=b2_pt, c=c_pt)


def verify(vk: VerifyingKey, primary: list, proof: Proof) -> bool:
    """Strong-IC verification: primary must have exactly len(ic)-1 values."""
    if len(primary) != len(vk.ic) - 1:
        return False
    vk_x = vk.ic[0]
    for v, pt in zip(primary, vk.ic[1:]):
        vk_x = vk_x + pt * (v % R)
    return pairing_product_is_one(
        [
            (-proof.a, proof.b),
            (vk.alpha_g1, vk.beta_g2),
            (vk_x, vk.gamma_g2),
            (proof.c, vk.delta_g2),
        ]
    )

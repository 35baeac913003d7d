"""Optimal ate pairing on BN254 (host-side, exact Python int arithmetic).

The verifier's pairing-product check is inherently scalar, latency-bound
work (4 pairings per Groth16 verification) and is therefore implemented on
the host, while the throughput-bound primitives (MSM, NTT) run on the device.

Production path (ms-class, matching the reference verifier's C++ speed
class, zklaim/snark.cpp:53-62):

  - Miller loop in TWISTED affine coordinates: the running point and all
    slopes stay in Fq2; each line is the sparse Fq12 element
    l = yp + (-lam*xp) w + (lam*X - Y) w^3 (from the untwist embedding
    psi(x', y') = (x' w^2, y' w^3)), multiplied in via a 3-coefficient
    sparse product instead of a full 18-mul Fq12 multiply.
  - Multi-pairing: prod_i e(P_i, Q_i) runs ONE shared Miller variable
    (one Fq12 squaring per iteration regardless of the number of pairs)
    and ONE final exponentiation.
  - Final exponentiation hard part via the base-q digit decomposition
    (q^4 - q^2 + 1)/r = lam0 + lam1 q + lam2 q^2 + q^3 with
    lam0 = -(36u^3+30u^2+18u+2), lam1 = -(36u^3+18u^2+12u-1),
    lam2 = 6u^2+1 (u = BN parameter; identity asserted at import), three
    63-bit cyclotomic exponentiations by u replacing a generic 2540-bit
    square-and-multiply.  Frobenius maps use gamma constants COMPUTED
    from xi at import (ff/hostfield.py) -- no transcribed tables.

The original all-Fq12 formulation (every Frobenius a computed q-power,
lines evaluated on the untwisted curve) is kept as *_generic: it is the
trust anchor the fast path is tested against (tests/test_hostcurve.py).

Replaces libff's alt_bn128 ate pairing (miller loop + final exponentiation)
used by the reference through libsnark's r1cs_gg_ppzksnark verifier
(reference call site: zklaim/snark.cpp:62).
"""

from __future__ import annotations

from ..ff.hostfield import Fq2, Fq12, XI_FQ2
from ..ff.params import ATE_LOOP_COUNT, BN_X, Q, R
from .hostcurve import CurvePoint, fq_to_fq12, g1_to_fq12, untwist

# exponents of the final exponentiation, computed once
_EASY2_EXP = Q * Q
_HARD_EXP = (Q**4 - Q**2 + 1) // R
assert (Q**4 - Q**2 + 1) % R == 0
assert (
    -(36 * BN_X**3 + 30 * BN_X**2 + 18 * BN_X + 2)
    + -(36 * BN_X**3 + 18 * BN_X**2 + 12 * BN_X - 1) * Q
    + (6 * BN_X**2 + 1) * Q * Q
    + Q**3
) == _HARD_EXP

# Frobenius on the twisted curve through the untwist embedding:
# pi(x', y') = (conj(x') * xi^((q-1)/3), conj(y') * xi^((q-1)/2))
_TW_X = XI_FQ2.pow((Q - 1) // 3)
_TW_Y = XI_FQ2.pow((Q - 1) // 2)

_LOOP_BITS = [
    (ATE_LOOP_COUNT >> i) & 1
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1)
]


# ---------------------------------------------------------------------------
# Fast path: twisted-coordinate Miller loop + sparse line products, all on
# the allocation-free flat-int Fq12 engine (ff/fq12flat.py).  Points and
# slopes are Fq2 int pairs; the per-round Fq2 inversions of every live
# pair are batched into ONE modular inversion (Montgomery trick).
# ---------------------------------------------------------------------------

from ..ff import fq12flat as F
from ..ff.hostfield import batch_inverse

_TWX = (_TW_X.c0, _TW_X.c1)
_TWY = (_TW_Y.c0, _TW_Y.c1)


def _batch_fq2_inv(dens):
    """[(c0, c1)] -> [(c0, c1)^-1] with one int inversion total."""
    norms = [(c0 * c0 + c1 * c1) % Q for c0, c1 in dens]
    ninvs = batch_inverse(norms, Q)
    return [
        ((c0 * n) % Q, (-c1 * n) % Q)
        for (c0, c1), n in zip(dens, ninvs)
    ]


def _dbl_steps(ts, ps, f):
    """One doubling round for every live pair; returns updated ts, f."""
    invs = _batch_fq2_inv([((2 * Y0) % Q, (2 * Y1) % Q) for _, Y0, Y1 in
                           ((t, t[2], t[3]) for t in ts)])
    out = []
    for (X0, X1, Y0, Y1), (i0, i1), (xp, yp) in zip(ts, invs, ps):
        s0, s1 = F.s2(X0, X1)
        l0, l1 = F.m2((3 * s0) % Q, (3 * s1) % Q, i0, i1)
        q0, q1 = F.s2(l0, l1)
        X30 = (q0 - 2 * X0) % Q
        X31 = (q1 - 2 * X1) % Q
        t0, t1 = F.m2(l0, l1, (X0 - X30) % Q, (X1 - X31) % Q)
        Y30 = (t0 - Y0) % Q
        Y31 = (t1 - Y1) % Q
        k10 = (-(l0 * xp)) % Q
        k11 = (-(l1 * xp)) % Q
        m0, m1 = F.m2(l0, l1, X0, X1)
        k30 = (m0 - Y0) % Q
        k31 = (m1 - Y1) % Q
        f = F.mul_line(f, yp, (k10, k11), (k30, k31))
        out.append((X30, X31, Y30, Y31))
    return out, f


def _add_steps(ts, qs, ps, f):
    """One addition round (T_j += Q_j) for every live pair."""
    invs = _batch_fq2_inv([
        ((q[0] - t[0]) % Q, (q[1] - t[1]) % Q) for t, q in zip(ts, qs)
    ])
    out = []
    for (X10, X11, Y10, Y11), (X20, X21, Y20, Y21), (i0, i1), (xp, yp) in zip(
        ts, qs, invs, ps
    ):
        l0, l1 = F.m2((Y20 - Y10) % Q, (Y21 - Y11) % Q, i0, i1)
        q0, q1 = F.s2(l0, l1)
        X30 = (q0 - X10 - X20) % Q
        X31 = (q1 - X11 - X21) % Q
        t0, t1 = F.m2(l0, l1, (X10 - X30) % Q, (X11 - X31) % Q)
        Y30 = (t0 - Y10) % Q
        Y31 = (t1 - Y11) % Q
        k10 = (-(l0 * xp)) % Q
        k11 = (-(l1 * xp)) % Q
        m0, m1 = F.m2(l0, l1, X10, X11)
        k30 = (m0 - Y10) % Q
        k31 = (m1 - Y11) % Q
        f = F.mul_line(f, yp, (k10, k11), (k30, k31))
        out.append((X30, X31, Y30, Y31))
    return out, f


def _frob_twist_i(q):
    """pi on twisted int coordinates: conj then * xi^((q-1)/3 | (q-1)/2)."""
    X0, X1, Y0, Y1 = q
    a0, a1 = F.m2(X0, (-X1) % Q, *_TWX)
    b0, b1 = F.m2(Y0, (-Y1) % Q, *_TWY)
    return (a0, a1, b0, b1)


def _miller_flat(pairs):
    """prod_i f_{6x+2,Q_i}(P_i) as a flat Fq12 list; one shared squaring
    per iteration regardless of the number of pairs."""
    ps, qs = [], []
    for p_g1, q_g2 in pairs:
        if p_g1.inf or q_g2.inf:
            continue
        ps.append((p_g1.x.v, p_g1.y.v))
        qs.append((q_g2.x.c0, q_g2.x.c1, q_g2.y.c0, q_g2.y.c1))
    if not ps:
        return list(F.ONE)

    ts = list(qs)
    f = list(F.ONE)
    for bit in _LOOP_BITS:
        f = F.f_sqr(f)
        ts, f = _dbl_steps(ts, ps, f)
        if bit:
            ts, f = _add_steps(ts, qs, ps, f)

    q1s = [_frob_twist_i(q) for q in qs]
    nq2s = []
    for q1 in q1s:
        X0, X1, Y0, Y1 = _frob_twist_i(q1)
        nq2s.append((X0, X1, (-Y0) % Q, (-Y1) % Q))
    ts, f = _add_steps(ts, q1s, ps, f)
    ts, f = _add_steps(ts, nq2s, ps, f)
    return f


def miller_loop_multi(pairs) -> Fq12:
    """prod_i f_{6x+2,Q_i}(P_i).  pairs: (P in G1(Fq), Q in G2 twisted
    coords over Fq2); pairs with a point at infinity contribute 1."""
    return F.to_fq12(_miller_flat(pairs))


def miller_loop(q_twisted: CurvePoint, p_g1: CurvePoint) -> Fq12:
    """Optimal ate Miller loop f_{6x+2,Q}(P) (fast twisted-coords path)."""
    return miller_loop_multi([(p_g1, q_twisted)])


def _final_exp_flat(m0):
    """Flat-engine final exponentiation (easy + base-q digit hard part)."""
    # easy part: f^(q^6 - 1) then ^(q^2 + 1); the one full inversion
    # goes through the tower classes (cold path)
    x = F.to_fq12(m0)
    f1 = x.conjugate() * x.inverse()
    g = F.from_fq12(f1)
    m = F.f_mul(F.f_frob(F.f_frob(g)), g)
    # hard part digits (identity asserted at import)
    fu = F.f_pow_cyc(m, BN_X)
    fu2 = F.f_pow_cyc(fu, BN_X)
    fu3 = F.f_pow_cyc(fu2, BN_X)
    t36 = F.f_pow_cyc(fu3, 36)
    y0 = F.f_conj(
        F.f_mul(
            F.f_mul(t36, F.f_pow_cyc(fu2, 30)),
            F.f_mul(F.f_pow_cyc(fu, 18), F.f_cyc_sqr(m)),
        )
    )
    y1 = F.f_mul(
        F.f_conj(
            F.f_mul(t36, F.f_mul(F.f_pow_cyc(fu2, 18), F.f_pow_cyc(fu, 12)))
        ),
        m,
    )
    y2 = F.f_mul(F.f_pow_cyc(fu2, 6), m)
    y3 = m
    r = F.f_mul(y0, F.f_frob(y1))
    r = F.f_mul(r, F.f_frob(F.f_frob(y2)))
    return F.f_mul(r, F.f_frob(F.f_frob(F.f_frob(y3))))


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((q^12 - 1) / r): easy part, then the base-q digit hard part
    ((q^4-q^2+1)/r = lam0 + lam1 q + lam2 q^2 + q^3, three 63-bit
    cyclotomic exponentiations by u instead of a generic 2540-bit pow)."""
    return F.to_fq12(_final_exp_flat(F.from_fq12(f)))


def pairing(p_g1: CurvePoint, q_g2: CurvePoint) -> Fq12:
    """e(P, Q) for P in G1(Fq), Q in G2 (twisted coordinates over Fq2)."""
    return final_exponentiation(miller_loop(q_g2, p_g1))


def pairing_product_is_one(pairs) -> bool:
    """Check prod e(P_i, Q_i) == 1: one shared Miller variable + one
    final exponentiation."""
    return F.f_is_one(_final_exp_flat(_miller_flat(pairs)))


# ---------------------------------------------------------------------------
# Generic golden path (original formulation; trust anchor for tests)
# ---------------------------------------------------------------------------


def _frobenius_point(p: CurvePoint) -> CurvePoint:
    """q-power Frobenius endomorphism on E(Fq12)."""
    if p.inf:
        return p
    return CurvePoint(p.x.pow(Q), p.y.pow(Q), p.b)


def _line(a: CurvePoint, b: CurvePoint, xp: Fq12, yp: Fq12) -> Fq12:
    """Evaluate the line through points a, b of E(Fq12) at (xp, yp)."""
    if a.inf or b.inf:
        return Fq12.ONE
    if a.x == b.x:
        if a.y == b.y and not a.y.is_zero():
            xx = a.x.square()
            lam = (xx + xx + xx) * (a.y + a.y).inverse()
        else:
            # vertical line
            return xp - a.x
    else:
        lam = (b.y - a.y) * (b.x - a.x).inverse()
    return (yp - a.y) - lam * (xp - a.x)


def miller_loop_generic(q_twisted: CurvePoint, p_g1: CurvePoint) -> Fq12:
    """All-Fq12 Miller loop: every Frobenius a computed q-power, lines on
    the untwisted curve.  Slow; the fast path's correctness reference."""
    if q_twisted.inf or p_g1.inf:
        return Fq12.ONE

    qq = untwist(q_twisted)
    pp = g1_to_fq12(p_g1)
    xp, yp = pp.x, pp.y

    f = Fq12.ONE
    t = qq
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = f.square() * _line(t, t, xp, yp)
        t = t.double()
        if (ATE_LOOP_COUNT >> i) & 1:
            f = f * _line(t, qq, xp, yp)
            t = t + qq

    q1 = _frobenius_point(qq)
    q2 = _frobenius_point(q1)
    f = f * _line(t, q1, xp, yp)
    t = t + q1
    f = f * _line(t, -q2, xp, yp)
    return f


def final_exponentiation_generic(f: Fq12) -> Fq12:
    """f^((q^12 - 1) / r) via generic square-and-multiply (golden)."""
    f1 = f.conjugate() * f.inverse()
    f2 = f1.pow(_EASY2_EXP) * f1
    return f2.pow(_HARD_EXP)

"""Batched projective elliptic-curve arithmetic in XLA (BN254 G1 and G2).

Points are pytrees (X, Y, Z) of Montgomery-domain limb arrays in
homogeneous projective coordinates; G1 coordinates are Fq elements of
shape (..., 16), G2 coordinates are Fq2 elements of shape (..., 2, 16).
Infinity is (0, 1, 0) (any (0, y!=0, 0) decodes as infinity).

Group law: the *complete* addition/doubling formulas of Renes-Costello-
Batina 2016 for a=0 short-Weierstrass curves (add: 12M + 2 mul-by-3b,
dbl: 8M + 1 mul-by-3b).  Complete formulas suit batched devices:
one branch-free dataflow handles every input combination (P=Q, P=-Q,
either infinity) with NO masks and NO second formula path, so the op is
safe as a combiner in data-dependent reductions (MSM bucket sums) and
the XLA graph stays small.  Completeness holds for points of odd prime
order -- all of G1 (cofactor 1) and the r-order G2 subgroup.

Independent field multiplications are stacked into single mont_mul calls
("stage batching"): an add is 2 stacked multiplies of width 6, keeping
both compile time (~2k StableHLO lines vs ~8k for masked Jacobian) and
runtime (fewer, wider kernels) down.

Replacement for libff alt_bn128_G1/G2 arithmetic
(SURVEY.md §2.6 rows 1-2).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

from ..ff import montgomery as M
from ..ff.limbs import LIMB_BITS, NUM_LIMBS
from ..ff.montgomery import FQ
from .hostcurve import B_G1, B_G2, CurvePoint
from ..ff.hostfield import Fq, Fq2
from ..ff.params import Q


# ---------------------------------------------------------------------------
# Field-ops namespaces (degree-1 Fq and degree-2 Fq2), jit-static singletons
# ---------------------------------------------------------------------------


class FqOps:
    """Fq elements: (..., 16) Montgomery-domain uint32 limbs."""

    name = "fq"
    deg = 1

    @staticmethod
    def add(a, b):
        return M.add_mod(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return M.sub_mod(FQ, a, b)

    @staticmethod
    def neg(a):
        return M.neg_mod(FQ, a)

    @staticmethod
    def dbl(a):
        return M.add_mod(FQ, a, a)

    @staticmethod
    def mul(a, b):
        return M.mont_mul(FQ, a, b)

    @staticmethod
    def sqr(a):
        return M.mont_mul(FQ, a, a)

    @staticmethod
    def mul_many(pairs):
        """Stack independent products into one mont_mul call."""
        lhs = jnp.stack([jnp.broadcast_to(p[0], jnp.broadcast_shapes(p[0].shape, p[1].shape)) for p in pairs], axis=0)
        rhs = jnp.stack([jnp.broadcast_to(p[1], jnp.broadcast_shapes(p[0].shape, p[1].shape)) for p in pairs], axis=0)
        out = M.mont_mul(FQ, lhs, rhs)
        return [out[i] for i in range(len(pairs))]

    @staticmethod
    def add_many(pairs):
        lhs = jnp.stack([p[0] for p in pairs], axis=0)
        rhs = jnp.stack([p[1] for p in pairs], axis=0)
        out = M.add_mod(FQ, lhs, rhs)
        return [out[i] for i in range(len(pairs))]

    @staticmethod
    def sub_many(pairs):
        lhs = jnp.stack([p[0] for p in pairs], axis=0)
        rhs = jnp.stack([p[1] for p in pairs], axis=0)
        out = M.sub_mod(FQ, lhs, rhs)
        return [out[i] for i in range(len(pairs))]

    @staticmethod
    def mul_b3(x):
        """9*x (3b for b=3) via an addition chain: ((2(2(2x))) + x)."""
        d = M.add_mod(FQ, x, x)
        d = M.add_mod(FQ, d, d)
        d = M.add_mod(FQ, d, d)
        return M.add_mod(FQ, d, x)

    @staticmethod
    def inv(a):
        return M.mont_inv(FQ, a)

    @staticmethod
    def is_zero(a):
        return jnp.all(a == 0, axis=-1)

    @staticmethod
    def select(mask, a, b):
        """mask: (...,) bool; a, b: (..., 16)."""
        return jnp.where(mask[..., None], a, b)

    @staticmethod
    def zeros(batch_shape):
        return jnp.zeros(batch_shape + (NUM_LIMBS,), dtype=jnp.uint32)

    @staticmethod
    def ones(batch_shape):
        return jnp.broadcast_to(
            jnp.asarray(FQ.one_mont, dtype=jnp.uint32), batch_shape + (NUM_LIMBS,)
        )


def _b3_g2_mont() -> np.ndarray:
    """3 * b' for the G2 curve (b' = 3/xi), as (2, 16) Montgomery limbs."""
    b3 = B_G2 * 3
    out = np.stack([
        M.encode_ints(M.FQ, [b3.c0])[0],
        M.encode_ints(M.FQ, [b3.c1])[0],
    ])
    return out


class Fq2Ops:
    """Fq2 elements: (..., 2, 16) Montgomery-domain uint32 limbs."""

    name = "fq2"
    deg = 2

    # component-wise ops reuse the Fq kernels (they are elementwise in limbs)
    @staticmethod
    def add(a, b):
        return M.add_mod(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return M.sub_mod(FQ, a, b)

    @staticmethod
    def neg(a):
        return M.neg_mod(FQ, a)

    @staticmethod
    def dbl(a):
        return M.add_mod(FQ, a, a)

    @staticmethod
    def mul(a, b):
        return Fq2Ops.mul_many([(a, b)])[0]

    @staticmethod
    def sqr(a):
        return Fq2Ops.mul(a, a)

    @staticmethod
    def mul_many(pairs):
        """Karatsuba over Fq, all pairs stacked into a single mont_mul.

        For each (a, b): t0 = a0 b0, t1 = a1 b1, t2 = (a0+a1)(b0+b1);
        c0 = t0 - t1,  c1 = t2 - t0 - t1.
        """
        shapes = [jnp.broadcast_shapes(a.shape, b.shape) for a, b in pairs]
        lhs, rhs = [], []
        for (a, b), s in zip(pairs, shapes):
            a = jnp.broadcast_to(a, s)
            b = jnp.broadcast_to(b, s)
            a0, a1 = a[..., 0, :], a[..., 1, :]
            b0, b1 = b[..., 0, :], b[..., 1, :]
            lhs += [a0, a1, M.add_mod(FQ, a0, a1)]
            rhs += [b0, b1, M.add_mod(FQ, b0, b1)]
        prod = M.mont_mul(FQ, jnp.stack(lhs, 0), jnp.stack(rhs, 0))
        out = []
        for i in range(len(pairs)):
            t0, t1, t2 = prod[3 * i], prod[3 * i + 1], prod[3 * i + 2]
            c0 = M.sub_mod(FQ, t0, t1)
            c1 = M.sub_mod(FQ, M.sub_mod(FQ, t2, t0), t1)
            out.append(jnp.stack([c0, c1], axis=-2))
        return out

    @staticmethod
    def add_many(pairs):
        lhs = jnp.stack([p[0] for p in pairs], axis=0)
        rhs = jnp.stack([p[1] for p in pairs], axis=0)
        out = M.add_mod(FQ, lhs, rhs)
        return [out[i] for i in range(len(pairs))]

    @staticmethod
    def sub_many(pairs):
        lhs = jnp.stack([p[0] for p in pairs], axis=0)
        rhs = jnp.stack([p[1] for p in pairs], axis=0)
        out = M.sub_mod(FQ, lhs, rhs)
        return [out[i] for i in range(len(pairs))]

    _B3 = None

    @classmethod
    def mul_b3(cls, x):
        """(3b') * x -- full Fq2 constant multiply (b' = 3/xi is generic)."""
        if cls._B3 is None:
            cls._B3 = _b3_g2_mont()
        c = jnp.asarray(cls._B3)
        return cls.mul(x, jnp.broadcast_to(c, x.shape))

    @staticmethod
    def inv(a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        sq = M.mont_mul(FQ, jnp.stack([a0, a1], 0), jnp.stack([a0, a1], 0))
        norm = M.add_mod(FQ, sq[0], sq[1])
        ninv = M.mont_inv(FQ, norm)
        c = M.mont_mul(FQ, jnp.stack([a0, a1], 0), jnp.stack([ninv, ninv], 0))
        return jnp.stack([c[0], M.neg_mod(FQ, c[1])], axis=-2)

    @staticmethod
    def is_zero(a):
        return jnp.all(a == 0, axis=(-1, -2))

    @staticmethod
    def select(mask, a, b):
        return jnp.where(mask[..., None, None], a, b)

    @staticmethod
    def zeros(batch_shape):
        return jnp.zeros(batch_shape + (2, NUM_LIMBS), dtype=jnp.uint32)

    @staticmethod
    def ones(batch_shape):
        one = np.zeros((2, NUM_LIMBS), dtype=np.uint32)
        one[0] = FQ.one_mont
        return jnp.broadcast_to(jnp.asarray(one), batch_shape + (2, NUM_LIMBS))


FQ_OPS = FqOps()
FQ2_OPS = Fq2Ops()


# ---------------------------------------------------------------------------
# Complete projective group law (RCB16, a = 0)
# ---------------------------------------------------------------------------


def point_infinity(f, batch_shape=()):
    return (f.zeros(batch_shape), f.ones(batch_shape), f.zeros(batch_shape))


def point_neg(f, p):
    x, y, z = p
    return (x, f.neg(y), z)


def point_select(f, mask, p, q):
    """mask True -> p, False -> q (batched)."""
    return tuple(f.select(mask, a, b) for a, b in zip(p, q))


def point_is_inf(f, p):
    return f.is_zero(p[2])


def point_add(f, p, q):
    """Complete projective add (RCB16 alg. 7): valid for ALL inputs."""
    x1, y1, z1 = p
    x2, y2, z2 = q

    s0, s1, s2, s3, s4, s5 = f.add_many(
        [(x1, y1), (x2, y2), (y1, z1), (y2, z2), (x1, z1), (x2, z2)]
    )
    t0, t1, t2, m0, m1, m2 = f.mul_many(
        [(x1, x2), (y1, y2), (z1, z2), (s0, s1), (s2, s3), (s4, s5)]
    )
    u01, u12, u02 = f.add_many([(t0, t1), (t1, t2), (t0, t2)])
    t3, t4, t5 = f.sub_many([(m0, u01), (m1, u12), (m2, u02)])
    # m = 3*X1X2
    m = f.add(f.dbl(t0), t0)
    # n = 3b*Z1Z2 ; bv = 3b*(X1Z2+X2Z1)   (stacked through one chain/mul)
    nb = f.mul_b3(jnp.stack([t2, t5], axis=0))
    n, bv = nb[0], nb[1]
    wmn = f.sub(t1, n)
    wpn = f.add(t1, n)
    p0, p1_, p2_, p3_, p4_, p5_ = f.mul_many(
        [(t3, wmn), (t4, bv), (wpn, wmn), (m, bv), (t4, wpn), (t3, m)]
    )
    x3 = f.sub(p0, p1_)
    y3, z3 = f.add_many([(p2_, p3_), (p4_, p5_)])
    return (x3, y3, z3)


def point_double(f, p):
    """Complete projective doubling (RCB16 alg. 9): valid for ALL inputs."""
    x, y, z = p
    t0, t1, t2, t3 = f.mul_many([(y, y), (y, z), (z, z), (x, y)])
    z8 = f.dbl(f.dbl(f.dbl(t0)))          # 8*Y^2
    n = f.mul_b3(t2)                       # 3b*Z^2
    n3 = f.add(f.dbl(n), n)
    t0m, t0p = f.sub(t0, n3), f.add(t0, n)
    q0, q1, q2, q3 = f.mul_many([(t1, z8), (n, z8), (t0m, t0p), (t0m, t3)])
    z3 = q0
    y3 = f.add(q2, q1)
    x3 = f.dbl(q3)
    return (x3, y3, z3)


def _batch_shape(f, coord):
    """Leading batch shape of a coordinate array (strip field dims)."""
    return coord.shape[: coord.ndim - (1 if f.deg == 1 else 2)]


def scalar_mul(f, point, scalars):
    """Batched double-and-add: scalars[i] * point[i].

    scalars: (..., 16) u32 plain-domain (NOT Montgomery) limbs, batch shape
    matching the point batch.  256-step fori_loop, MSB-first.
    """

    def body(i, acc):
        bit_index = 255 - i
        limb = jnp.take(scalars, bit_index // LIMB_BITS, axis=-1)
        bit = (limb >> (bit_index % LIMB_BITS).astype(jnp.uint32)) & 1
        acc = point_double(f, acc)
        added = point_add(f, acc, point)
        return point_select(f, bit == 1, added, acc)

    init = point_infinity(f, _batch_shape(f, point[2]))
    return lax.fori_loop(0, 256, body, init)


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def _fq_encode_many(vals):
    return M.encode_ints(FQ, vals)


def host_points_to_proj(f, points):
    """List of host CurvePoints (affine or inf) -> batched projective arrays."""
    n = len(points)
    if f.deg == 1:
        xs, ys, zs = [], [], []
        for p in points:
            if p.inf:
                xs.append(0), ys.append(1), zs.append(0)
            else:
                xs.append(p.x.v), ys.append(p.y.v), zs.append(1)
        return (
            jnp.asarray(_fq_encode_many(xs)),
            jnp.asarray(_fq_encode_many(ys)),
            jnp.asarray(_fq_encode_many(zs)),
        )
    xs, ys, zs = [], [], []
    for p in points:
        if p.inf:
            xs += [0, 0]
            ys += [1, 0]
            zs += [0, 0]
        else:
            xs += [p.x.c0, p.x.c1]
            ys += [p.y.c0, p.y.c1]
            zs += [1, 0]
    shape = (n, 2, NUM_LIMBS)
    return (
        jnp.asarray(_fq_encode_many(xs)).reshape(shape),
        jnp.asarray(_fq_encode_many(ys)).reshape(shape),
        jnp.asarray(_fq_encode_many(zs)).reshape(shape),
    )


def proj_to_host_points(f, proj):
    """Batched projective arrays -> list of host CurvePoints (exact)."""
    x_arr, y_arr, z_arr = (np.asarray(c) for c in proj)
    if f.deg == 1:
        xs = M.decode_ints(FQ, x_arr)
        ys = M.decode_ints(FQ, y_arr)
        zs = M.decode_ints(FQ, z_arr)
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(CurvePoint.infinity(B_G1))
            else:
                zinv = pow(z, -1, Q)
                out.append(CurvePoint(Fq(x * zinv % Q), Fq(y * zinv % Q), B_G1))
        return out
    n = x_arr.shape[0]
    xs = M.decode_ints(FQ, x_arr.reshape(n * 2, NUM_LIMBS))
    ys = M.decode_ints(FQ, y_arr.reshape(n * 2, NUM_LIMBS))
    zs = M.decode_ints(FQ, z_arr.reshape(n * 2, NUM_LIMBS))
    out = []
    for i in range(n):
        z = Fq2(zs[2 * i], zs[2 * i + 1])
        if z.is_zero():
            out.append(CurvePoint.infinity(B_G2))
            continue
        x = Fq2(xs[2 * i], xs[2 * i + 1])
        y = Fq2(ys[2 * i], ys[2 * i + 1])
        zinv = z.inverse()
        out.append(CurvePoint(x * zinv, y * zinv, B_G2))
    return out


def proj_to_affine_limbs(f, proj):
    """Device batch: projective mont points -> (x, y, inf) plain-domain limbs.

    Batched Fermat inversion of Z; infinity rows decode to x = y = 0.
    """
    x, y, z = proj
    zinv = f.inv(z)                      # 0 -> 0 convention handles infinity
    xa, ya = f.mul_many([(x, zinv), (y, zinv)])
    # from_mont is elementwise in the trailing limb axis; Fq2's extra
    # component axis broadcasts through untouched
    return M.from_mont(FQ, xa), M.from_mont(FQ, ya), f.is_zero(z)


def affine_limbs_to_proj(f, x_plain, y_plain, inf_mask):
    """Inverse of proj_to_affine_limbs: plain affine limbs -> mont projective."""
    xm = M.to_mont(FQ, x_plain)
    ym = M.to_mont(FQ, y_plain)
    batch = _batch_shape(f, xm)
    zm = f.ones(batch)
    xm = f.select(inf_mask, f.zeros(batch), xm)
    ym = f.select(inf_mask, f.ones(batch), ym)
    zm = f.select(inf_mask, f.zeros(batch), zm)
    return (xm, ym, zm)


# Backwards-compatible aliases (pre-projective names)
host_points_to_jac = host_points_to_proj
jac_to_host_points = proj_to_host_points

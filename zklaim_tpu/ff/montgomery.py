"""Batched Montgomery field arithmetic over BN254 Fq / Fr in XLA.

All functions are pure, jit-able, and vectorized over arbitrary leading
batch axes; the trailing axis is the 16-limb base-2^16 representation
(see limbs.py).  Elements are kept in the Montgomery domain (x*R mod p,
R = 2^256) on device; conversion happens only at host boundaries.

Algorithm: full-width SOS/REDC Montgomery multiplication, reformulated
for XLA:

  T  = a * b                      (31-limb lazy product)
  m  = (T mod R) * (-p^-1 mod R)  (low 16 limbs only)
  t  = (T + m * p) / R            (exact division; < 2p, one cond-subtract)

The limb-by-limb sequential CIOS recurrence used on scalar CPUs is
hostile to XLA here: fully unrolled it costs ~2k HLO ops per multiply and
compile time explodes superlinearly (measured: 1 mul = 3s, 30 muls = 143s
to compile on this toolchain).  Full-width REDC instead expresses each
256x256-bit product as ONE broadcasted outer product (..., 16, 16) plus a
"shear by reshape" anti-diagonal reduction -- pad (16,16)->(16,32),
flatten, truncate to 496, reshape (16,31), sum rows.  Element O[i,j] of
the padded row-major buffer sits at flat index 32i+j = 31i + (i+j), i.e.
exactly at column i+j of the (16,31) view, so the polynomial convolution
c[k] = sum_{i+j=k} a_i*b_j costs pad+reshape+sum: no gathers, no loops.

Lazy-carry bounds (everything in uint32):
  - 16x16-bit limb products are exact in u32;
  - anti-diagonal sums of lo/hi halves are < 16*2^16 = 2^20 each, so a
    combined product limb is < 2^21;
  - T + m*p limbs are < 2^22.
Carry chains (16 sequential shift+adds) run only three times per multiply.

Replacement for libff's Fp_model Montgomery arithmetic (reference
reaches it via libsnark; see SURVEY.md §2.6 row 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import jax.numpy as jnp
from jax import lax

from . import params
from .limbs import (
    LIMB_BITS,
    LIMB_MASK,
    NUM_LIMBS,
    U32,
    carry_canonical,
    int_to_limbs,
    select,
    shift_up,
    sub_borrow,
)


@dataclass(frozen=True)
class FieldSpec:
    """Static per-field constants (hashable, safe as a jit static arg)."""

    name: str
    p: int
    pinv16: int          # -p^{-1} mod 2^16
    r_mod: int           # R mod p       (Montgomery one)
    r2: int              # R^2 mod p     (to-Montgomery factor)

    # numpy constants, derived in __post_init__
    p_limbs: np.ndarray = field(init=False, repr=False, compare=False)
    one_mont: np.ndarray = field(init=False, repr=False, compare=False)
    r2_limbs: np.ndarray = field(init=False, repr=False, compare=False)
    nprime_limbs: np.ndarray = field(init=False, repr=False, compare=False)
    exp_p_minus_2_bits: np.ndarray = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "p_limbs", int_to_limbs(self.p))
        object.__setattr__(self, "p2_limbs", int_to_limbs(2 * self.p))
        object.__setattr__(self, "p4_limbs", int_to_limbs(4 * self.p))
        object.__setattr__(self, "one_mont", int_to_limbs(self.r_mod))
        object.__setattr__(self, "r2_limbs", int_to_limbs(self.r2))
        nprime = (-pow(self.p, -1, params.MONT_R)) % params.MONT_R
        object.__setattr__(self, "nprime_limbs", int_to_limbs(nprime))
        bits = np.array([(self.p - 2 >> i) & 1 for i in range(256)], dtype=np.uint32)
        object.__setattr__(self, "exp_p_minus_2_bits", bits)

    def __hash__(self):
        return hash((self.name, self.p))


FQ = FieldSpec("Fq", params.Q, params.Q_PINV16, params.Q_R_MOD, params.Q_R2)
FR = FieldSpec("Fr", params.R, params.R_PINV16, params.R_R_MOD, params.R_R2)


# ---------------------------------------------------------------------------
# Core kernels
# ---------------------------------------------------------------------------


def _cond_sub_p(spec: FieldSpec, a):
    """Given canonical limbs possibly in [0, 2p), reduce to [0, p)."""
    p_arr = jnp.broadcast_to(jnp.asarray(spec.p_limbs), a.shape)
    diff, borrow = sub_borrow(a, p_arr)
    return select(borrow == 0, diff, a)


def _diag_sum(outer):
    """(..., 16, 16) -> (..., 31) anti-diagonal sums via shear-by-reshape."""
    L = NUM_LIMBS
    batch = outer.shape[:-2]
    pad_widths = [(0, 0)] * len(batch) + [(0, 0), (0, L)]
    padded = jnp.pad(outer, pad_widths)                       # (..., 16, 32)
    flat = padded.reshape(batch + (2 * L * L,))               # O[i,j] at 32i+j
    sheared = flat[..., : L * (2 * L - 1)].reshape(batch + (L, 2 * L - 1))
    return jnp.sum(sheared, axis=-2)                          # (..., 31)


def _poly_mul(a, b, out_limbs=2 * NUM_LIMBS):
    """Lazy schoolbook product of 16-limb numbers: (..., 32) limbs < 2^21.

    Inputs must be canonical (< 2^16).  out_limbs=16 computes mod 2^256.
    """
    outer = a[..., :, None] * b[..., None, :]                 # exact in u32
    lo = _diag_sum(outer & LIMB_MASK)                         # (..., 31)
    hi = _diag_sum(outer >> LIMB_BITS)                        # (..., 31)
    pad_hi = [(0, 0)] * (hi.ndim - 1) + [(1, 0)]
    pad_lo = [(0, 0)] * (lo.ndim - 1) + [(0, 1)]
    c = jnp.pad(lo, pad_lo) + jnp.pad(hi, pad_hi)             # (..., 32)
    return c[..., :out_limbs]


def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product abR^{-1} mod p. a, b: (..., 16) u32 canonical."""
    L = NUM_LIMBS
    t = _poly_mul(a, b)                                       # (..., 32) lazy

    # canonicalize low half; its overflow feeds the high half at limb 16
    t_low, carry16 = carry_canonical(t[..., :L])

    # m = (T mod R) * nprime mod R
    np_l = jnp.asarray(spec.nprime_limbs)
    m_lazy = _poly_mul(t_low, jnp.broadcast_to(np_l, a.shape), out_limbs=L)
    m, _ = carry_canonical(m_lazy)                            # mod R: drop carry

    # T + m*p, divided by R
    mp = _poly_mul(m, jnp.broadcast_to(jnp.asarray(spec.p_limbs), a.shape))
    # low half of T + m*p is divisible by R; compute its carry into limb 16
    _, carry_low = carry_canonical(t_low + mp[..., :L])

    res = t[..., L:] + mp[..., L:]                            # (..., 16) < 2^22
    head = (carry16 + carry_low)[..., None]
    res = res + jnp.pad(head, [(0, 0)] * (head.ndim - 1) + [(0, L - 1)])
    canon, _carry_out = carry_canonical(res)                  # < 2p so no overflow
    return _cond_sub_p(spec, canon)


def add_mod(spec: FieldSpec, a, b):
    """(a + b) mod p, canonical in/out."""
    canon, _carry = carry_canonical(a.astype(U32) + b.astype(U32))
    # a + b < 2p < 2^255 so carry out of 16 limbs is impossible
    return _cond_sub_p(spec, canon)


def sub_mod(spec: FieldSpec, a, b):
    """(a - b) mod p, canonical in/out."""
    d, borrow = sub_borrow(a, b)
    canon, _ = carry_canonical(d + jnp.asarray(spec.p_limbs))
    return select(borrow == 0, d, canon)


def reduce_wide(spec: FieldSpec, a):
    """Reduce lazy limbs (each < 2^32, value < 2^276) to canonical [0, p).

    Used after lazy u32 segment-sums of canonical Montgomery values (up
    to 2^16 addends are safe per limb).  The dropped 2^256-carry is
    folded back with one Montgomery multiply by R^2
    (mont_mul(c, R2) = c * 2^256 mod p).
    """
    canon, carry = carry_canonical(a)
    pad = [(0, 0)] * (a.ndim - 1) + [(0, NUM_LIMBS - 2)]
    carry_limbs = jnp.pad(
        jnp.stack([carry & LIMB_MASK, carry >> LIMB_BITS], axis=-1), pad
    )
    fold = mont_mul(spec, carry_limbs, jnp.broadcast_to(jnp.asarray(spec.r2_limbs), a.shape))
    for plimbs in (spec.p4_limbs, spec.p2_limbs, spec.p_limbs):
        p_arr = jnp.broadcast_to(jnp.asarray(plimbs), canon.shape)
        diff, borrow = sub_borrow(canon, p_arr)
        canon = select(borrow == 0, diff, canon)
    return add_mod(spec, canon, fold)


def neg_mod(spec: FieldSpec, a):
    zero = jnp.zeros_like(a)
    return sub_mod(spec, zero, a)


def double_mod(spec: FieldSpec, a):
    return add_mod(spec, a, a)


def mont_sqr(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def is_zero(a):
    """(..., 16) -> (...,) bool."""
    return jnp.all(a == 0, axis=-1)


def eq(a, b):
    return jnp.all(a == b, axis=-1)


def mont_pow_bits(spec: FieldSpec, a, exp_bits: np.ndarray):
    """a^e for a fixed public exponent given as static LSB-first bit array.

    Square-and-multiply with lax.fori_loop (graph stays small); exponent is
    baked in as a constant uint32 vector.
    """
    bits = jnp.asarray(exp_bits, dtype=U32)
    one = jnp.broadcast_to(jnp.asarray(spec.one_mont), a.shape).astype(U32)

    def body(i, carry):
        acc, base = carry
        bit = bits[i]
        mul = mont_mul(spec, acc, base)
        acc = select(bit == 1, mul, acc)
        base = mont_mul(spec, base, base)
        return acc, base

    acc, _ = lax.fori_loop(0, int(len(exp_bits)), body, (one, a))
    return acc


def mont_inv(spec: FieldSpec, a):
    """Batched inversion via Fermat: a^(p-2).  mont-domain in/out.

    0 maps to 0 (convenient for curve-point edge cases).
    """
    return mont_pow_bits(spec, a, spec.exp_p_minus_2_bits)


# ---------------------------------------------------------------------------
# Host boundary conversions
# ---------------------------------------------------------------------------


def to_mont(spec: FieldSpec, x):
    """Canonical limbs (plain domain) -> Montgomery domain."""
    r2 = jnp.broadcast_to(jnp.asarray(spec.r2_limbs), x.shape).astype(U32)
    return mont_mul(spec, x, r2)


def from_mont(spec: FieldSpec, x):
    """Montgomery domain -> plain domain limbs."""
    one = jnp.zeros_like(x).at[..., 0].set(1)
    return mont_mul(spec, x, one)


def encode_ints(spec: FieldSpec, xs) -> np.ndarray:
    """Host ints -> Montgomery-domain limb array (len(xs), 16), via numpy."""
    from .limbs import ints_to_limbs

    return ints_to_limbs(
        [(x % spec.p) * spec.r_mod % spec.p for x in xs]
    )


def decode_ints(spec: FieldSpec, limbs) -> list:
    """Montgomery-domain limb array (..., 16) -> list of ints."""
    arr = np.asarray(limbs, dtype=np.uint64).reshape(-1, NUM_LIMBS)
    rinv = pow(params.MONT_R, -1, spec.p)
    out = []
    for row in arr:
        v = 0
        for i in range(NUM_LIMBS - 1, -1, -1):
            v = (v << LIMB_BITS) | int(row[i])
        out.append(v * rinv % spec.p)
    return out

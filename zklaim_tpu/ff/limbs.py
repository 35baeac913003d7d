"""Multi-limb big-integer representation for the device field code.

Layout: little-endian base-2**16 limbs held in uint32, trailing axis of
length NUM_LIMBS (16) => 256 bits per element.  With 16-bit limbs a
16x16-bit product fits exactly in a uint32 (max (2^16-1)^2 < 2^32), and
lo/hi split accumulators stay below 2^32 for the full schoolbook/CIOS
inner loop without intermediate carry passes (lazy-carry bound analysis
in montgomery.py).  Every computation stays in 32-bit integer lanes.

This file has the representation plumbing + raw (non-modular) helpers;
modular/Montgomery arithmetic lives in montgomery.py.

Replacement for GMP/libff bigint (SURVEY.md §2.6 row 1).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .params import LIMB_BITS, LIMB_MASK, NUM_LIMBS

U32 = jnp.uint32


# ---------------------------------------------------------------------------
# Host <-> limb conversion (numpy; exact for arbitrary ints)
# ---------------------------------------------------------------------------


def int_to_limbs(x: int, n: int = NUM_LIMBS) -> np.ndarray:
    """Single int -> (n,) uint32 limb array (little-endian base 2^16)."""
    out = np.empty(n, dtype=np.uint32)
    for i in range(n):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("integer does not fit in limb array")
    return out


def ints_to_limbs(xs, n: int = NUM_LIMBS) -> np.ndarray:
    """Iterable of ints -> (len, n) uint32 limb array."""
    xs = list(xs)
    if n == NUM_LIMBS:
        # int.to_bytes + frombuffer: C-speed conversion (the Python
        # limb loop was ~1.5 s per 131k scalars in the setup profile)
        try:
            buf = b"".join(x.to_bytes(2 * NUM_LIMBS, "little") for x in xs)
        except OverflowError as e:
            raise ValueError("integer does not fit in limb array") from e
        return (
            np.frombuffer(buf, dtype="<u2")
            .reshape(len(xs), NUM_LIMBS)
            .astype(np.uint32)
        )
    out = np.empty((len(xs), n), dtype=np.uint32)
    for j, x in enumerate(xs):
        for i in range(n):
            out[j, i] = x & LIMB_MASK
            x >>= LIMB_BITS
        if x:
            raise ValueError("integer does not fit in limb array")
    return out


def limbs_to_int(a) -> int:
    """(n,) limb array -> int."""
    a = np.asarray(a, dtype=np.uint64)
    x = 0
    for i in range(a.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(a[i])
    return x


def limbs_to_ints(a):
    """(..., n) limb array -> nested list of ints (flattened to 1-D list)."""
    a = np.asarray(a, dtype=np.uint64).reshape(-1, np.asarray(a).shape[-1])
    return [limbs_to_int(row) for row in a]


def u64s_to_limbs(xs: np.ndarray, n: int = NUM_LIMBS) -> np.ndarray:
    """Vectorized: (...,) uint64 array -> (..., n) uint32 limbs (zero-padded)."""
    xs = np.asarray(xs, dtype=np.uint64)
    out = np.zeros(xs.shape + (n,), dtype=np.uint32)
    for i in range(4):
        out[..., i] = (xs >> np.uint64(LIMB_BITS * i)) & np.uint64(LIMB_MASK)
    return out


# ---------------------------------------------------------------------------
# Raw limb helpers (jnp, batched over leading axes, vectorized in the limb
# axis).  Carry/borrow chains are NOT unrolled limb-by-limb: an unrolled
# 16-step ripple costs ~50 HLO ops per chain and there are three chains per
# Montgomery multiply, which made point-add graphs balloon to ~17k StableHLO
# lines (47 s XLA compile each).  Instead: two vectorized relax passes bring
# every limb to <= 2^16 with pending carries in {0,1}, then a Kogge-Stone
# carry-lookahead (log2(16) = 4 rounds of whole-array ops) finishes the
# ripple exactly.
# ---------------------------------------------------------------------------


def shift_up(a, d: int = 1):
    """Move limb i -> i+d along the trailing axis (zero-fill low limbs)."""
    pad = [(0, 0)] * (a.ndim - 1) + [(d, 0)]
    return jnp.pad(a, pad)[..., : a.shape[-1]]


def _kogge_stone_prefix(g, p):
    """Inclusive prefix of the carry operator over the trailing axis.

    g, p: u32 arrays in {0,1} (generate / propagate per limb).  Returns
    G with G[..., i] = carry generated out of limbs [0..i].
    """
    n = g.shape[-1]
    d = 1
    while d < n:
        g = g | (p & shift_up(g, d))
        p = p & shift_up(p, d)
        d *= 2
    return g


def carry_canonical(a):
    """Exact carry propagation: (..., n) lazy u32 limbs (< 2^22 each) ->
    (canonical limbs < 2^16, carry_out) with
    value(a) = value(canonical) + carry_out * 2^(16n).
    """
    carry_out = jnp.zeros_like(a[..., 0])
    for _ in range(2):                       # limbs: < 2^22 -> < 2^16+2^6 -> <= 2^16
        c = a >> LIMB_BITS
        carry_out = carry_out + c[..., -1]
        a = (a & LIMB_MASK) + shift_up(c)
    g = a >> LIMB_BITS                        # in {0,1}
    p = ((a & LIMB_MASK) == LIMB_MASK).astype(U32)
    G = _kogge_stone_prefix(g, p)
    carry_out = carry_out + G[..., -1]
    return (a + shift_up(G)) & LIMB_MASK, carry_out


def sub_borrow(a, b):
    """a - b over canonical (..., n) limbs -> (canonical limbs, borrow).

    borrow is (...,) in {0,1}; result encodes a - b + borrow * 2^(16n).
    """
    g = (a < b).astype(U32)
    p = (a == b).astype(U32)
    G = _kogge_stone_prefix(g, p)
    out = (a - b - shift_up(G)) & LIMB_MASK   # u32 wraparound is exact mod 2^16
    return out, G[..., -1]


def geq(a, b):
    """(..., n) >= (..., n) elementwise over the batch (canonical limbs)."""
    _, borrow = sub_borrow(a, b)
    return borrow == 0


def select(mask, a, b):
    """Broadcast select over trailing limb axis: mask (...,), a/b (..., n)."""
    return jnp.where(mask[..., None], a, b)

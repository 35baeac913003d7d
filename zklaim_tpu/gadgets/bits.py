"""Bit-level gadget primitives: booleans, packing, XOR/AND/Ch/Maj, decompose.

Replacement for libsnark gadgetlib1 basic gadgets
(packing_gadget / multipacking_gadget and the boolean plumbing the
SHA256 gadget is built from; used by the reference via
zklaim/zklaim_gadget.cpp:18-19,357-362).

Bits are represented as LCs over Fr: either a variable constrained to
{0,1} or a folded constant (LC.const(0/1)).  Gadget helpers constant-
fold aggressively so constant IV/padding bits cost zero constraints.

Every helper that allocates a variable also registers a witness hook
that derives the value from already-assigned entries, so running hooks
in allocation order always yields a consistent assignment.
"""

from __future__ import annotations

from ..ff.params import R
from ..r1cs.system import (
    LC, ONE, ZERO, ConstraintSystem, bit_operand, signed_terms,
)

# Vectorizable-decompose coefficient bound: with bit-valued inputs and a
# few hundred terms, |sum| stays far below 2^63 (i64-safe).  The 65-bit
# comparison decompose (coeffs up to 2^63) intentionally fails this and
# takes the python path -- a handful of instances per circuit.
_DEC_BOUND = 1 << 48


def _bitop_desc(kind, ins, out_lc):
    """("bitop", ...) descriptor, or None if an input isn't canonical."""
    ops = [bit_operand(x) for x in ins]
    if any(o is None for o in ops):
        return None
    return ("bitop", kind, ops, next(iter(out_lc.terms)))


def _lc_vars(*lcs):
    return sorted({v for lc in lcs for v in lc.terms if v != 0})


def as_const(lc: LC):
    """Return the constant value of an LC if it is constant, else None."""
    if not lc.terms:
        return 0
    if len(lc.terms) == 1 and 0 in lc.terms:
        return lc.terms[0]
    return None


def alloc_bit(cs: ConstraintSystem, note="bit") -> LC:
    b = cs.alloc_lc()
    cs.enforce_boolean(b, note)
    return b


def alloc_input_bits(cs: ConstraintSystem, n: int, note="input") -> list:
    """n boolean-constrained variables (values set by an external hook)."""
    return [alloc_bit(cs, f"{note}[{i}]") for i in range(n)]


def pack_lc(bits) -> LC:
    """sum_i bits[i] * 2^i (little-endian)."""
    s = LC()
    for i, b in enumerate(bits):
        s = s + b * (1 << i)
    return s


def decompose(cs: ConstraintSystem, lc: LC, n: int, note="decomp") -> list:
    """Allocate n bits b with sum b_i 2^i == lc; returns the bit LCs.

    The caller guarantees 0 <= value(lc) < 2^n.  Costs n bitness
    constraints + 1 linear constraint.
    """
    first = cs.alloc(n)
    bits = [LC.of(first + i) for i in range(n)]
    for i, b in enumerate(bits):
        cs.enforce_boolean(b, f"{note}.bit{i}")
    cs.constrain(pack_lc(bits) - lc, ONE, ZERO, f"{note}.pack")

    def hook(w, first=first, lc=lc, n=n):
        v = lc.eval(w)
        for i in range(n):
            w[first + i] = (v >> i) & 1

    st = signed_terms(lc, _DEC_BOUND)
    if st is not None:
        desc = ("dec", st[0], st[1], first, n)
    else:
        desc = ("py", _lc_vars(lc), list(range(first, first + n)))
    cs.add_hook(hook, desc)
    return bits


def bxor(cs: ConstraintSystem, a: LC, b: LC, note="xor") -> LC:
    """a XOR b for boolean LCs; 1 constraint (0 if either is constant)."""
    ca, cb = as_const(a), as_const(b)
    if ca is not None:
        return b if ca == 0 else ONE - b
    if cb is not None:
        return a if cb == 0 else ONE - a
    c = cs.alloc_lc()
    # (2a) * b = a + b - c  <=>  c = a + b - 2ab
    cs.constrain(a * 2, b, a + b - c, note)
    var = next(iter(c.terms))

    def hook(w, a=a, b=b, var=var):
        w[var] = a.eval(w) ^ b.eval(w)

    cs.add_hook(hook, _bitop_desc("xor", (a, b), c)
                or ("py", _lc_vars(a, b), [var]))
    return c


def bxor3(cs: ConstraintSystem, a: LC, b: LC, c: LC, note="xor3") -> LC:
    return bxor(cs, bxor(cs, a, b, note + ".0"), c, note + ".1")


def band(cs: ConstraintSystem, a: LC, b: LC, note="and") -> LC:
    ca, cb = as_const(a), as_const(b)
    if ca is not None:
        return b if ca else ZERO
    if cb is not None:
        return a if cb else ZERO
    c = cs.alloc_lc()
    cs.constrain(a, b, c, note)
    var = next(iter(c.terms))

    def hook(w, a=a, b=b, var=var):
        w[var] = a.eval(w) & b.eval(w)

    cs.add_hook(hook, _bitop_desc("and", (a, b), c)
                or ("py", _lc_vars(a, b), [var]))
    return c


def ch(cs: ConstraintSystem, e: LC, f: LC, g: LC, note="ch") -> LC:
    """(e AND f) XOR ((NOT e) AND g): one constraint e*(f-g) = c-g."""
    ce = as_const(e)
    if ce is not None:
        return f if ce else g
    if as_const(f) is not None and as_const(f) == as_const(g):
        return f
    c = cs.alloc_lc()
    cs.constrain(e, f - g, c - g, note)
    var = next(iter(c.terms))

    def hook(w, e=e, f=f, g=g, var=var):
        w[var] = f.eval(w) if e.eval(w) else g.eval(w)

    cs.add_hook(hook, _bitop_desc("ch", (e, f, g), c)
                or ("py", _lc_vars(e, f, g), [var]))
    return c


def maj(cs: ConstraintSystem, a: LC, b: LC, c: LC, note="maj") -> LC:
    """Majority of three bits: m + bit carry decomposition of a+b+c.

    a+b+c = m*2 + s with m, s bits => m = majority.  2 constraints.
    """
    consts = [as_const(x) for x in (a, b, c)]
    if consts.count(None) <= 1:
        known = [v for v in consts if v is not None]
        if sum(known) >= 2:
            return ONE
        if len(known) == 3 or (len(known) == 2 and sum(known) == 0):
            return ZERO if sum(known) < 2 else ONE
        # one unknown, one known 1 and one known 0 -> majority = unknown
        (unknown,) = [x for x, v in zip((a, b, c), consts) if v is None]
        if sum(known) == 1:
            return unknown
    t = a + b + c
    m = cs.alloc_lc()
    # s = t - 2m must be boolean: (t-2m)(1-t+2m) = 0; plus m boolean
    cs.enforce_boolean(m, note + ".m")
    cs.constrain(t - m * 2, ONE - t + m * 2, ZERO, note)
    var = next(iter(m.terms))

    def hook(w, a=a, b=b, c=c, var=var):
        w[var] = 1 if (a.eval(w) + b.eval(w) + c.eval(w)) >= 2 else 0

    cs.add_hook(hook, _bitop_desc("maj", (a, b, c), m)
                or ("py", _lc_vars(a, b, c), [var]))
    return m

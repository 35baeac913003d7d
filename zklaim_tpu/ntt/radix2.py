"""Radix-2 NTT / iNTT over BN254 Fr.

Replacement for libfqfft's basic_radix2_domain (the reference
reaches it through libsnark's QAP instance/witness maps; SURVEY.md §2.6
row 4, include path reference zklaim/CMakeLists.txt:68,77).

Design notes (XLA-first):
  - Constant-geometry (Pease) decimation in frequency: every one of the
    k = log2(n) stages pairs x[i] with x[i + n/2] and writes the two
    butterfly outputs to positions 2i and 2i + 1.  All stages have the
    same shapes, so they run as ONE lax.fori_loop body: the compiled
    program is one stage, not k unrolled ones (the unrolled form took
    minutes of XLA compile per transform on the GPU).  After k stages
    the data is the in-place DIF result, in bit-reversed order; one
    static `take` restores natural order.
  - Stage s multiplies (a - b) by w^((i >> s) << s), gathered from one
    table of the n/2 powers of omega.
  - Twiddle tables are precomputed on the host in python ints and
    shipped as Montgomery-domain limb constants.
  - Coset (shifted-domain) transforms premultiply by powers of the Fr
    multiplicative generator g -- one extra batched multiply -- which is
    what Groth16's H-polynomial division needs (Z(g·ω^i) = g^n - 1 is a
    nonzero constant on the coset).

Multi-device: parallel/ntt.py runs the four-step algorithm over a mesh,
with these transforms as its local steps and one all_to_all between.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ff import montgomery as M
from ..ff.limbs import NUM_LIMBS, ints_to_limbs
from ..ff.montgomery import FR
from ..ff.params import FR_GENERATOR, R, ROOT_OF_UNITY, TWO_ADICITY


class NTTDomain:
    """Radix-2 evaluation domain of size n = 2^k over Fr.

    Holds host-side integer constants and device-ready Montgomery limb
    tables.  Instances are cached per size; safe to treat as jit-static.
    """

    def __init__(self, n: int):
        if n & (n - 1) or n == 0:
            raise ValueError("domain size must be a power of two")
        k = n.bit_length() - 1
        if k > TWO_ADICITY:
            raise ValueError("domain too large for Fr two-adicity")
        self.n = n
        self.k = k
        self.omega = pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - k), R)
        self.omega_inv = pow(self.omega, R - 2, R)
        self.n_inv = pow(n, R - 2, R)
        self.shift = FR_GENERATOR          # coset shift g
        self.shift_inv = pow(self.shift, R - 2, R)

        # bit-reversal permutation (static gather indices)
        idx = np.arange(n, dtype=np.int32)
        rev = np.zeros(n, dtype=np.int32)
        for b in range(k):
            rev |= ((idx >> b) & 1) << (k - 1 - b)
        self.bitrev = rev

        # omega^j and omega^-j for j < n/2, Montgomery domain
        def mont(vals):
            return ints_to_limbs([v * (1 << 256) % R for v in vals])

        tw, twi = [1], [1]
        for _ in range(n // 2 - 1):
            tw.append(tw[-1] * self.omega % R)
            twi.append(twi[-1] * self.omega_inv % R)
        self.tw = mont(tw[: n // 2])
        self.tw_inv = mont(twi[: n // 2])

        # coset premultipliers g^i and their inverses; n^{-1} scalar
        pw, pwi = [1], [1]
        for _ in range(n - 1):
            pw.append(pw[-1] * self.shift % R)
            pwi.append(pwi[-1] * self.shift_inv % R)
        self.shift_pows = mont(pw)
        self.shift_pows_inv = mont(pwi)
        self.n_inv_mont = mont([self.n_inv])[0]
        # Z_H(g) = g^n - 1 on the coset (constant), and its inverse
        zg = (pow(self.shift, n, R) - 1) % R
        self.z_coset_inv_mont = mont([pow(zg, R - 2, R)])[0]

    # -- device transforms ------------------------------------------------
    #
    # All transforms act along axis 0 and broadcast over any extra axes
    # between the transform axis and the trailing limb axis, i.e. input
    # shape (n, ..., 16) -- the batched form the distributed four-step
    # NTT needs (parallel/ntt.py).
    #
    # Twiddle tables: every transform takes an optional `tables=` pytree
    # (from device_tables()) so jitted callers can pass them as REAL
    # ARGUMENTS.  Closed-over constants -- numpy or device arrays alike
    # (verified on jax 0.9) -- are inlined into the HLO as literals:
    # ~270 MB of program text at n = 2^22.  The default (tables=None)
    # falls back to inlined literals, which is fine for small domains
    # and standalone tests.

    def _dev(self, name: str):
        cache = self.__dict__.setdefault("_dev_cache", {})
        if name not in cache:
            conv = jnp.asarray(getattr(self, name))
            # inside a jit/shard_map trace jnp.asarray yields a TRACER;
            # caching one would leak it into later calls (a sharded
            # intt_t once crashed on the tracer cached by the preceding
            # ntt_t trace).  Only memoize concrete arrays.
            if isinstance(conv, jax.core.Tracer):
                return conv
            cache[name] = conv
        return cache[name]

    def _transform(self, x, tw, bitrev):
        """DFT with twiddle table tw (omega^j or omega^-j, j < n/2),
        natural order in and out (module docstring)."""
        half = self.n // 2
        ones = (1,) * (x.ndim - 2)
        pos = jnp.arange(half, dtype=jnp.int32)

        def stage(s, x):
            a, b = x[:half], x[half:]
            w = jnp.take(tw, (pos >> s) << s, axis=0)
            w = w.reshape((half,) + ones + (NUM_LIMBS,))
            y0 = M.add_mod(FR, a, b)
            y1 = M.mont_mul(FR, M.sub_mod(FR, a, b), w)
            return jnp.stack([y0, y1], axis=1).reshape(x.shape)

        if self.k:                      # n = 1 is the identity
            x = lax.fori_loop(0, self.k, stage, x)
        return jnp.take(x, bitrev, axis=0)

    def device_tables(self):
        """All device-resident tables as one pytree, for passing through
        a jit boundary as arguments (see class comment)."""
        return {
            "bitrev": self._dev("bitrev"),
            "tw": self._dev("tw"),
            "tw_inv": self._dev("tw_inv"),
            "n_inv": self._dev("n_inv_mont"),
            "shift": self._dev("shift_pows"),
            "shift_inv": self._dev("shift_pows_inv"),
            "z_coset_inv": self._dev("z_coset_inv_mont"),
        }

    def ntt(self, x, tables=None):
        """Coefficients -> evaluations on <omega>.  x: (n, ..., 16) mont."""
        t = tables if tables is not None else self.device_tables()
        return self._transform(x, t["tw"], t["bitrev"])

    def intt(self, y, tables=None):
        """Evaluations on <omega> -> coefficients."""
        t = tables if tables is not None else self.device_tables()
        out = self._transform(y, t["tw_inv"], t["bitrev"])
        return M.mont_mul(FR, out, t["n_inv"])

    def _bshape(self, x):
        return (self.n,) + (1,) * (x.ndim - 2) + (NUM_LIMBS,)

    def coset_ntt(self, x, tables=None):
        """Coefficients -> evaluations on g·<omega>."""
        t = tables if tables is not None else self.device_tables()
        return self.ntt(M.mont_mul(FR, x, t["shift"].reshape(self._bshape(x))), t)

    def coset_intt(self, y, tables=None):
        """Evaluations on g·<omega> -> coefficients."""
        t = tables if tables is not None else self.device_tables()
        c = self.intt(y, t)
        return M.mont_mul(FR, c, t["shift_inv"].reshape(self._bshape(c)))


@lru_cache(maxsize=None)
def get_domain(n: int) -> NTTDomain:
    return NTTDomain(n)

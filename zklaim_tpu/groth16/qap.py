"""R1CS -> QAP instance/witness maps for Groth16.

Replacement for libsnark's r1cs_to_qap reductions (reached by
the reference through r1cs_gg_ppzksnark generator/prover,
zklaim/snark.cpp:91,126; SURVEY.md §2.6 rows 4-5).

Split of labor:
  - Instance map (setup-time, one-off): Lagrange evaluations
    L_j(tau) and the per-wire sums A_i(tau), B_i(tau), C_i(tau) are exact
    host integer math (batch-inverted denominators); setup cost is
    dominated by the device fixed-base exponentiations, not this.
  - Witness map (prover-hot): <A_j, w> per constraint is a sparse COO
    matvec on device -- mont_mul products, *lazy* u32 segment-sum
    (safe for <= 2^16 addends per row), one reduce_wide -- followed by
    the iNTT/coset-NTT pipeline to get H coefficients.

Input-consistency rows (libsnark r1cs_to_qap convention): constraint
rows n_cons + i enforce "primary wire i appears in A" for
i = 0..num_primary, which is why the domain holds
n_cons + num_primary + 1 rows.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ff import montgomery as M
from ..ff.limbs import ints_to_limbs
from ..ff.montgomery import FR
from ..ff.params import R
from ..ntt.radix2 import NTTDomain, get_domain


def _batch_inverse(xs: list, p: int) -> list:
    """Montgomery's trick: n inversions for one pow + 3n mults."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % p
    inv_all = pow(prefix[n], p - 2, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % p
        inv_all = inv_all * xs[i] % p
    return out


class QAP:
    """Prepared QAP artifacts for a fixed constraint system."""

    def __init__(self, cs):
        self.cs = cs
        self.num_vars = cs.num_vars
        self.num_primary = cs.num_primary
        self.n_cons = cs.num_constraints
        rows_needed = self.n_cons + self.num_primary + 1
        self.m = 1 << (rows_needed - 1).bit_length()
        self.domain: NTTDomain = get_domain(self.m)

        coo = cs.to_coo()
        # append input-consistency rows to A: row n_cons + i, wire i, coeff 1
        a_rows, a_cols, a_coeffs = coo["A"]
        extra = np.arange(self.num_primary + 1, dtype=np.int32)
        coo["A"] = (
            np.concatenate([a_rows, self.n_cons + extra]),
            np.concatenate([a_cols, extra]),
            list(a_coeffs) + [1] * (self.num_primary + 1),
        )
        self.coo_host = coo

        # DEVICE copies are padded to power-of-two nnz (row m-1, col 0,
        # coeff 0: contributes nothing to any segment sum).  Together
        # with the power-of-two witness padding in the prover this makes
        # the h_pipeline's traced shapes identical for every payload
        # count sharing an m bucket -- without it the N=1..20 sweep paid
        # a fresh ~200 s XLA compile PER N for the same pipeline.
        def pad_coo(rows, cols, coeffs):
            nnz = len(rows)
            nnz2 = max(2, 1 << (nnz - 1).bit_length())
            enc = M.encode_ints(FR, coeffs)
            if nnz2 != nnz:
                pad = nnz2 - nnz
                rows = np.concatenate(
                    [rows, np.full(pad, self.m - 1, dtype=np.int32)]
                )
                cols = np.concatenate([cols, np.zeros(pad, dtype=np.int32)])
                enc = np.concatenate(
                    [enc, np.zeros((pad, enc.shape[1]), dtype=enc.dtype)]
                )
            return jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(enc)

        self.coo_dev = {
            name: pad_coo(np.asarray(rows, dtype=np.int32),
                          np.asarray(cols, dtype=np.int32), coeffs)
            for name, (rows, cols, coeffs) in coo.items()
        }
        # witness rows the device pipeline expects (pow2-padded)
        self.num_vars_pad = max(2, 1 << (self.num_vars - 1).bit_length())

    # -- instance map (host, setup-time) ----------------------------------

    def lagrange_at(self, tau: int) -> list:
        """All L_j(tau), j < m: L_j = (tau^m - 1) w^j / (m (tau - w^j))."""
        m, omega = self.m, self.domain.omega
        zt = (pow(tau, m, R) - 1) % R
        if zt == 0:
            raise ValueError("tau hit the evaluation domain; resample")
        wj = [1] * m
        for j in range(1, m):
            wj[j] = wj[j - 1] * omega % R
        denoms = [m * (tau - w) % R for w in wj]
        invs = _batch_inverse(denoms, R)
        return [zt * w % R * inv % R for w, inv in zip(wj, invs)]

    def eval_at_tau(self, tau: int):
        """A_i(tau), B_i(tau), C_i(tau) for every wire i; plus Z(tau)."""
        lag = self.lagrange_at(tau)
        at = [0] * self.num_vars
        bt = [0] * self.num_vars
        ct = [0] * self.num_vars
        for (rows, cols, coeffs), acc in (
            (self.coo_host["A"], at),
            (self.coo_host["B"], bt),
            (self.coo_host["C"], ct),
        ):
            for r_, c_, v in zip(rows, cols, coeffs):
                acc[c_] = (acc[c_] + v * lag[r_]) % R
        z_tau = (pow(tau, self.m, R) - 1) % R
        return at, bt, ct, z_tau

    # -- witness map (device, prover-hot) ---------------------------------
    #
    # The COO matrices and NTT tables are passed through jit boundaries
    # as ARGUMENTS via device_args(): closed-over constants are inlined
    # into the HLO as literals (~200 MB of COO + ~270 MB of twiddles at
    # the 20-payload sweep point), which bloats every compile and the
    # compile cache.  Default None keeps standalone use working.

    def device_args(self):
        """Large device-resident operands for the jitted witness map."""
        cached = getattr(self, "_device_args", None)
        if cached is None:
            cached = self._device_args = {
                "coo": self.coo_dev,
                "ntt": self.domain.device_tables(),
            }
        return cached

    def constraint_evals(self, w_mont, coo=None):
        """<A_j,w>, <B_j,w>, <C_j,w> over the full domain: 3 x (m, 16) mont."""
        coo = coo if coo is not None else self.coo_dev
        out = []
        for name in ("A", "B", "C"):
            rows, cols, coeffs = coo[name]
            prod = M.mont_mul(FR, coeffs, jnp.take(w_mont, cols, axis=0))
            lazy = jax.ops.segment_sum(prod, rows, num_segments=self.m)
            out.append(M.reduce_wide(FR, lazy))
        return tuple(out)

    def h_coefficients(self, w_mont, evals=None, dev=None):
        """H(x) = (A(x)B(x) - C(x)) / Z(x) coefficients, (m, 16) mont.

        The last coefficient is identically zero (deg H = m - 2).
        evals: precomputed constraint_evals(w_mont) to share work with
        the satisfaction check.  dev: device_args() passed through a
        jit boundary.
        """
        ntt_t = dev["ntt"] if dev is not None else self.domain.device_tables()
        if evals is None:
            evals = self.constraint_evals(
                w_mont, dev["coo"] if dev is not None else None
            )
        a_ev, b_ev, c_ev = evals
        dom = self.domain
        a_cos = dom.coset_ntt(dom.intt(a_ev, ntt_t), ntt_t)
        b_cos = dom.coset_ntt(dom.intt(b_ev, ntt_t), ntt_t)
        c_cos = dom.coset_ntt(dom.intt(c_ev, ntt_t), ntt_t)
        ab = M.mont_mul(FR, a_cos, b_cos)
        num = M.sub_mod(FR, ab, c_cos)
        h_cos = M.mont_mul(FR, num, jnp.broadcast_to(ntt_t["z_coset_inv"], num.shape))
        return dom.coset_intt(h_cos, ntt_t)

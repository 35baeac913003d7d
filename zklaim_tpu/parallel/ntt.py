"""Distributed NTT over a device mesh: the four-step (Bailey) algorithm.

Scale-out of the radix-2 NTT (SURVEY.md §2.6: "distributed
NTT (butterfly stages with all-to-all)").  Factor n = n1*n2 and view the
coefficient vector as a row-major (n1, n2) matrix:

  1. length-n1 NTTs along COLUMNS  -- local when the matrix is sharded
     over the column axis (each device owns full columns);
  2. twiddle by w_n^(k1*i2)        -- local elementwise multiply;
  3. ONE all_to_all transposing the shard axis: (n1, n2/S) -> (n1/S, n2);
  4. length-n2 NTTs along ROWS     -- local.

The result lands in TRANSPOSED order: out[k1, k2] = X_hat[k2*n1 + k1],
sharded over k1.  The inverse transform consumes exactly that layout and
returns natural order, so an ntt -> pointwise -> intt pipeline (the
Groth16 H computation) pays only two all_to_alls and never reorders.
Communication volume: n/S elements per device per transform.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map as _shard_map
from jax.sharding import PartitionSpec as P

from ..ff import montgomery as M
from ..ff.limbs import NUM_LIMBS, ints_to_limbs
from ..ff.montgomery import FR
from ..ff.params import R
from ..ntt.radix2 import get_domain


class ShardedNTT:
    """Four-step NTT plan for size n over `mesh` (1-D, axis name `axis`)."""

    def __init__(self, mesh, n: int, axis: str = "shards"):
        self.mesh = mesh
        self.axis = axis
        self.n = n
        self.S = mesh.shape[axis]
        k = n.bit_length() - 1
        k1 = (k + 1) // 2
        self.n1 = 1 << k1
        self.n2 = n >> k1
        if self.n1 % self.S or self.n2 % self.S:
            raise ValueError(f"n1={self.n1}, n2={self.n2} must divide by {self.S} shards")
        self.dom1 = get_domain(self.n1)
        self.dom2 = get_domain(self.n2)

        # full-size root: w = primitive n-th root; twiddle W[k1, i2] = w^(k1*i2)
        omega = get_domain(n).omega
        omega_inv = pow(omega, R - 2, R)
        self.tw = self._twiddle_matrix(omega)
        self.tw_inv = self._twiddle_matrix(omega_inv)

    def _twiddle_matrix(self, w: int) -> np.ndarray:
        rows = []
        wk = 1
        for _k1 in range(self.n1):
            row = [1] * self.n2
            for i2 in range(1, self.n2):
                row[i2] = row[i2 - 1] * wk % R
            rows.append(row)
            wk = wk * w % R
        flat = [v * (1 << 256) % R for row in rows for v in row]
        return ints_to_limbs(flat).reshape(self.n1, self.n2, NUM_LIMBS)

    # -- transforms -------------------------------------------------------
    # The shard_map-wrapped callables are built ONCE per plan and jitted:
    # rebuilding them per call would recompile the (expensive) SPMD
    # program on every invocation.

    def _build(self):
        ax = self.axis

        @partial(
            _shard_map,
            mesh=self.mesh,
            in_specs=(P(None, ax), P(None, ax)),
            out_specs=P(ax),
            check_vma=False,
        )
        def fwd(x_local, tw_local):
            y = self.dom1.ntt(x_local)                    # columns, local
            y = M.mont_mul(FR, y, tw_local)
            z = lax.all_to_all(y, ax, split_axis=0, concat_axis=1, tiled=True)
            z = self.dom2.ntt(jnp.swapaxes(z, 0, 1))      # rows, local
            return jnp.swapaxes(z, 0, 1)                  # (n1/S, n2)

        @partial(
            _shard_map,
            mesh=self.mesh,
            in_specs=(P(ax), P(None, ax)),
            out_specs=P(None, ax),
            check_vma=False,
        )
        def inv(z_local, twi_local):
            y = self.dom2.intt(jnp.swapaxes(z_local, 0, 1))
            y = jnp.swapaxes(y, 0, 1)                     # (n1/S, n2)
            x = lax.all_to_all(y, ax, split_axis=1, concat_axis=0, tiled=True)
            x = M.mont_mul(FR, x, twi_local)              # undo twiddles
            return self.dom1.intt(x)                      # (n1, n2/S)

        self._fwd = jax.jit(fwd)
        self._inv = jax.jit(inv)

    def ntt_t(self, x_mat):
        """(n1, n2, 16) natural-order matrix (shard over axis 1) ->
        (n1, n2, 16) transposed-order result (shard over axis 0)."""
        if not hasattr(self, "_fwd"):
            self._build()
        return self._fwd(x_mat, jnp.asarray(self.tw))

    def intt_t(self, z_mat):
        """Inverse of ntt_t: transposed-order (shard axis 0) ->
        natural-order (shard axis 1)."""
        if not hasattr(self, "_fwd"):
            self._build()
        return self._inv(z_mat, jnp.asarray(self.tw_inv))

    # -- host helpers -----------------------------------------------------

    def to_matrix(self, flat):
        return flat.reshape(self.n1, self.n2, NUM_LIMBS)

    def from_transposed(self, z_mat):
        """Transposed-order matrix -> natural-order flat evaluations."""
        return jnp.swapaxes(z_mat, 0, 1).reshape(self.n, NUM_LIMBS)

    def transposed_from_flat(self, flat_eval):
        """Natural-order flat evaluations -> transposed-order matrix."""
        return jnp.swapaxes(flat_eval.reshape(self.n2, self.n1, NUM_LIMBS), 0, 1)

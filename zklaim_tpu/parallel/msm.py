"""Multi-device MSM: points/scalars sharded, one point exchanged per device.

Scale-out of the Pippenger pipeline (SURVEY.md §2.6: "sharded MSM
(points/scalars partitioned, bucket sums reduced ...)").  Design: each
device runs the local MSM on its slice of the point axis
(embarrassingly parallel -- the expensive part), then the per-device
partial results (ONE projective point each, ~3 KiB) are all-gathered
and folded with the complete point-add.  Communication is O(devices),
independent of N.

Works over 1-D ('shards') meshes and 2-D (host, chip) meshes from
parallel.mesh.make_host_mesh: pass the axis name(s) the point dimension
is sharded over; the final fold's all-gather spans every device named
-- ~3 KiB per device.  (With a tuple
of axis names, lax.all_gather already emits ONE stacked leading dim of
size prod(axis sizes) -- verified on the virtual mesh -- so no reshape
is needed after the gather.)

The local kernel is msm.pippenger.msm, whose small-N dispatch matters
here: per-shard slices are usually tiny, and the O(1)-graph ladder path
keeps the SPMD program compilable in seconds on XLA:CPU (the unrolled
flat pipeline takes minutes there).  The shard_map body is jitted ONCE
per (mesh, axis, shapes, c) and cached.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..ec import jaxcurve as JC
from ..msm.pippenger import MAX_CHUNK, _ladder_max, msm, msm_pow2


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, str):
        return mesh.shape[axis]
    n = 1
    for a in axis:
        n *= mesh.shape[a]
    return n


# One compiled SPMD program per (mesh, axis, deg, n, c); re-wrapping
# shard_map + jit per call would re-trace and re-compile every time.
_BODY_CACHE: dict = {}


def _get_body(mesh, axis, deg, n_local, n_shards, c):
    axis_key = axis if isinstance(axis, str) else tuple(axis)
    key = (id(mesh), axis_key, deg, n_local, c)
    fn = _BODY_CACHE.get(key)
    if fn is not None:
        return fn

    f = JC.FQ_OPS if deg == 1 else JC.FQ2_OPS
    point_spec = (P(axis),) * 3

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(point_spec, P(axis)),
        out_specs=(P(),) * 3,
        # the ladder/fold mix replicated constants (infinity inits) with
        # sharded data inside fori_loop carries; skip the varying-manual-
        # axes type check (correctness: test_parallel sharded == local)
        check_vma=False,
    )
    def body(pts_local, scal_local):
        # local slice: small shards hit the O(1)-graph ladder inside
        # msm(); larger ones go through pow2 padding + the flat pipeline
        if n_local <= _ladder_max():
            part = msm(f, pts_local, scal_local, c)
        else:
            part = msm_pow2(f, pts_local, scal_local, c)
        parts = jax.tree.map(lambda a: lax.all_gather(a, axis), part)

        def fold(i, acc):
            p_i = jax.tree.map(
                lambda a: lax.dynamic_index_in_dim(a, i, 0, keepdims=False),
                parts,
            )
            return JC.point_add(f, acc, p_i)

        return lax.fori_loop(0, n_shards, fold, JC.point_infinity(f))

    fn = jax.jit(body)
    _BODY_CACHE[key] = fn
    return fn


def sharded_msm(mesh, f, points, scalars, c: int = 8, axis="shards"):
    """MSM with the point axis sharded over `mesh`.

    points: projective pytree (N, ...); scalars (N, 16) plain limbs.
    axis: mesh axis name, or tuple of names for multi-axis (host, chip)
    sharding.  N must be divisible by the total shard count.  Returns a
    replicated point.
    """
    n_shards = _axis_size(mesh, axis)
    n = jax.tree.leaves(points)[0].shape[0]
    if n % n_shards:
        raise ValueError(f"point count {n} not divisible by {n_shards} shards")
    body = _get_body(mesh, axis, f.deg, n // n_shards, n_shards, c)
    return body(points, scalars)

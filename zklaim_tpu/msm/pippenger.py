"""Multi-scalar multiplication (Pippenger) over BN254 G1/G2 on the device.

Replacement for libsnark/libff's multi_exp (reference reaches
it inside r1cs_gg_ppzksnark generator/prover; SURVEY.md §2.6 row 3, OpenMP
`MULTICORE` flag reference CMakeLists.txt:35-39).

Vectorization strategy (XLA static shapes; no data-dependent scatters,
and -- critically for a wide device -- NO sequential scalar point ops in
the bucket path):

  - Scalars are split into W = 256/c signed c-bit digits (window size
    c | 16 so digits slice cleanly out of 16-bit limbs).  Signed digits
    halve the bucket count: B = 2^(c-1).
  - ALL windows are processed as ONE flat batch of W*N (point, digit)
    pairs -- there is no per-window loop.  The flat pipeline:
      1. composite keys  k = w*(B+1) + |digit|  put the pairs in
         window-major, bucket-minor order under a single
         `lax.sort_key_val`; the carried value is a PRE-RESOLVED gather
         index into the tripled table [P | -P | infinity], so digit
         sign/zero handling costs nothing after the sort;
      2. ONE row gather from the PACKED (x‖y‖z) point table
         materializes the working set (a packed 192/384-byte row
         gathers ~3x faster than three 64-byte gathers, measured);
      3. the working set is stored in BIT-REVERSED index order
         (reversal applied to the (cheap, i32) gather indices via a
         reshape/transpose decomposition, never to point data): an
         upsweep tree over bit-reversed storage pairs CONTIGUOUS
         HALVES at every level  (s_{t+1} = s_t[:w/2] + s_t[w/2:]),
         eliminating the strided even/odd relayouts that dominated a
         natural-order tree;
      4. levels live as struct-of-arrays (48*deg, width) limb planes --
         the fused point kernels' layout (ec/cuda_curve.py) -- so no
         per-call AoS<->SoA conversion exists in the hot path;
      5. GLOBAL inclusive prefixes F(t) of the SORTED order are
         materialized only at the W*(B+1) bucket-tail positions (each
         prefix = sum of the <= log2(W*N) aligned blocks named by the
         set bits of its length; block -> storage position is a static
         per-level bit twiddle);
      6. per window the weighted bucket total collapses by Abel
         summation, and the window-start offsets CANCEL: with
         t_{w,b} = tail index of bucket b in window w,

            sum_{b=1..B} b * S_{w,b}  =  B*F(t_{w,B}) - sum_{b<B} F(t_{w,b})

         (the -F(end of window w-1) corrections appear B times with
         both signs).  So the bucket phase is a halving-tree reduction
         over the (B, W) tail grid -- all batched adds, zero sequential
         scalar work.
  - B*F(t_{w,B}) for all windows at once: (c-1) batched doublings of
    the (W,) totals.
  - Windows are combined MSB-first by a Horner ladder (c doublings + one
    add per window) in a `fori_loop` -- the only remaining sequential
    scalar point ops (256 doublings, inherent to the radix ladder).
    Chunked MSMs (see msm_pow2) accumulate per-window partials across
    chunks and run this ladder ONCE at the end.

Cost model: ~W*N + W*(B+1)*log2(W*N) point-add lanes total.  Designs
given up earlier: sequential bucket adds, full Hillis-Steele prefix
scans (log(N)x the lane-adds), a lax.scan over windows (W rounds of
narrow launches), and a natural-order tree over AoS rows (strided slice
relayouts plus three gathers per level).

Point ops: every batched add/double goes through `impl`
(zklaim_tpu/kernels.py): the fused CUDA kernels on the GPU, XLA's
lowering of ec/jaxcurve.py elsewhere.  Both give bit-identical points.

Multi-device: shard the point axis; each device runs this pipeline on
its slice and the per-device partial results are combined with one
all-gather + fold -- see parallel/ for the shard_map wrapper.
"""

from __future__ import annotations

import functools
import os

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..ec import jaxcurve as JC
from ..ec import cuda_curve as CC
from ..ff.limbs import LIMB_BITS, NUM_LIMBS
from ..kernels import curve_impl


def _ladder_max() -> int:
    """Largest point count routed to the O(1)-graph ladder path.

    The flat pipeline's fully unrolled upsweep tree is the fast path on
    the GPU but its traced graph grows with W*N — XLA:CPU takes
    minutes to compile even tiny instances (and the SPMD partitioner is
    ~20x worse).  Small MSMs (per-shard slices, tiny test circuits,
    the multi-device dry run) instead use msm_ladder: a 256-step fori_loop
    whose graph is ~3 point-ops regardless of N."""
    return int(os.environ.get("ZKLAIM_MSM_LADDER_MAX", "512"))


def signed_digits(scalars, c: int):
    """(N, 16) plain-domain u32 limbs -> (W, N) int32 signed digits.

    Digits lie in [-2^(c-1), 2^(c-1)]; windows are LSB-first.  Requires
    c | 16 and scalars < 2^254 (true for Fr), so the final carry is
    absorbed by the top window.
    """
    if LIMB_BITS % c:
        raise ValueError("window size must divide 16")
    per_limb = LIMB_BITS // c
    W = NUM_LIMBS * per_limb
    mask = (1 << c) - 1
    half = 1 << (c - 1)

    raw = []
    for w in range(W):
        limb = scalars[:, w // per_limb].astype(jnp.int32)
        raw.append((limb >> (c * (w % per_limb))) & mask)

    out = []
    carry = jnp.zeros_like(raw[0])
    for w in range(W):
        d = raw[w] + carry
        ge = d > half
        carry = ge.astype(jnp.int32)
        out.append(jnp.where(ge, d - (1 << c), d))
    return jnp.stack(out, axis=0)


# ---------------------------------------------------------------------------
# Struct-of-arrays plane representation: a point batch of width n is one
# (48*deg, n) u32 array, 16 limb rows per Fq value in the order x, y, z
# (G2: x.c0, x.c1, y.c0, y.c1, z.c0, z.c1) -- the layout of the point
# kernels (ec/cuda_curve.py).
# ---------------------------------------------------------------------------


def _plane_add(f, impl):
    """Batched complete add on planes."""
    if impl != "xla":
        return lambda p, q: CC.point_add(f.deg, p, q, impl)

    def xla_add(p, q):
        return _point_to_planes(
            f, JC.point_add(f, _planes_to_point(f, p), _planes_to_point(f, q))
        )

    return xla_add


def _plane_double(f, impl):
    if impl != "xla":
        return lambda p: CC.point_double(f.deg, p, impl)
    return lambda p: _point_to_planes(f, JC.point_double(f, _planes_to_point(f, p)))


def _plane_add_halves(f, impl):
    """(48*deg, w) planes -> lo + hi halves summed, (48*deg, w/2).

    The kernel reads both halves in place (ec/cuda_curve.point_add_halves),
    so no level of the upsweep tree materializes lo/hi slices."""
    if impl != "xla":
        return lambda cur: CC.point_add_halves(f.deg, cur, impl)
    add = _plane_add(f, impl)

    def xla_halves(cur):
        w = cur.shape[1]
        return add(cur[:, : w // 2], cur[:, w // 2 :])

    return xla_halves


def _pack_rows(f, points):
    """Projective AoS pytree (N, ...) -> packed (N, 48*deg) u32 rows."""
    n = points[0].shape[0]
    return jnp.concatenate([c.reshape(n, -1) for c in points], axis=1)


def _point_to_planes(f, pt):
    return jnp.swapaxes(_pack_rows(f, pt), 0, 1)


def _planes_to_point(f, planes):
    rows = jnp.swapaxes(planes, 0, 1)                   # (n, 48*deg)
    k = NUM_LIMBS * f.deg
    shape = (rows.shape[0],) + ((2, NUM_LIMBS) if f.deg == 2 else (NUM_LIMBS,))
    return tuple(rows[:, i * k : (i + 1) * k].reshape(shape) for i in range(3))


def _plane_infinity(f, width: int):
    inf = _point_to_planes(f, JC.point_infinity(f, (1,)))
    return jnp.broadcast_to(inf, (inf.shape[0], width))


def _plane_select(mask, a, b):
    """mask: (width,) bool; a, b: planes."""
    return jnp.where(mask[None, :], a, b)


# ---------------------------------------------------------------------------
# Bit-reversal helpers
# ---------------------------------------------------------------------------


def _apply_bitrev(v, k: int):
    """Permute a (2^k,)-vector into bit-reversed index order:
    out[j] = v[rev_k(j)].  Implemented as a reshape/per-axis-reverse/
    transpose decomposition (no large gathers)."""
    dims = []
    rem = k
    while rem > 0:
        s = min(8, rem)
        dims.append(s)
        rem -= s
    x = v.reshape([1 << s for s in dims])
    for ax, s in enumerate(dims):
        if s > 1:
            perm = np.zeros(1 << s, dtype=np.int32)
            idx = np.arange(1 << s)
            for b in range(s):
                perm |= ((idx >> b) & 1) << (s - 1 - b)
            x = jnp.take(x, jnp.asarray(perm), axis=ax)
    x = jnp.transpose(x, tuple(reversed(range(len(dims)))))
    return x.reshape(-1)


def _revbits_dyn(idx, nb: int):
    """Bit-reverse (width nb) each element of an int32 vector."""
    r = jnp.zeros_like(idx)
    for b in range(nb):
        r = r | (((idx >> b) & 1) << (nb - 1 - b))
    return r


# ---------------------------------------------------------------------------
# Flat bucket phase
# ---------------------------------------------------------------------------


def _window_partials(f, points, scalars, c, impl):
    """Flat-batch bucket phase: per-window (F(t_B), sum_{b<B} F(t_b)).

    Returns (tot_w, head_w) plane tuples with lane width W.  These are
    GROUP-LINEAR in the input points, so chunked MSMs may sum them
    across chunks before the (nonlinear) doubling/Horner finish.
    """
    n = jax.tree.leaves(points)[0].shape[0]
    digits = signed_digits(scalars, c)                     # (W, N)
    W = digits.shape[0]
    B = 1 << (c - 1)
    M = W * n
    k = M.bit_length() - 1
    if (1 << k) != M:
        raise ValueError("flat batch W*N must be a power of two (pad N)")
    add = _plane_add(f, impl)

    # tripled packed table [P | -P | inf]; gather indices pre-resolve
    # digit sign (row + n) and digit zero (row 2n)
    x, y, z = points
    neg_pt = (x, f.neg(y), z)
    packed = _pack_rows(f, points)
    packed_neg = _pack_rows(f, neg_pt)
    inf_row = _pack_rows(f, JC.point_infinity(f, (1,)))
    table = jnp.concatenate([packed, packed_neg, inf_row], axis=0)

    mag = jnp.abs(digits)
    keys = (jnp.arange(W, dtype=jnp.int32)[:, None] * (B + 1) + mag).reshape(-1)
    src = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (W, n))
    idx = jnp.where(
        mag == 0, 2 * n, src + jnp.where(digits < 0, n, 0)
    ).reshape(-1)
    skeys, sidx = lax.sort_key_val(keys, idx)

    # bit-reversed storage: all upsweep levels pair contiguous halves
    sidx_br = _apply_bitrev(sidx, k)
    pts = jnp.swapaxes(jnp.take(table, sidx_br, axis=0), 0, 1)

    add_halves = _plane_add_halves(f, impl)
    levels = [pts]
    while levels[-1].shape[1] > 1:
        levels.append(add_halves(levels[-1]))

    # global prefixes at every bucket tail: t_{w,b} = last sorted index
    # with key <= w*(B+1)+b; block j of level t lives at storage
    # position rev_{k-t}(j)
    bucket_keys = (
        jnp.arange(W, dtype=jnp.int32)[:, None] * (B + 1)
        + jnp.arange(B + 1, dtype=jnp.int32)[None, :]
    ).reshape(-1)                                          # (W*(B+1),)
    u = jnp.searchsorted(skeys, bucket_keys, side="right") - 1
    m = u + 1                                              # prefix lengths
    acc = _plane_infinity(f, m.shape[0])
    for t, lvl in enumerate(levels):
        wt = max(1, M >> t)
        nat = jnp.clip((m >> t) - 1, 0, wt - 1)
        store = _revbits_dyn(nat, k - t) if k - t > 0 else nat
        node = jnp.take(lvl, store, axis=1)
        bit = ((m >> t) & 1) == 1
        acc = _plane_select(bit, add(acc, node), acc)

    # Abel summation per window; window-start corrections cancel (see
    # module docstring), leaving  B*F(t_{w,B}) - sum_{b<B} F(t_{w,b}).
    rows = acc.shape[0]
    grid = acc.reshape(rows, W, B + 1)
    tot_w = grid[:, :, B]
    heads = jnp.swapaxes(grid[:, :, :B], 1, 2).reshape(rows, B * W)  # b-major
    while heads.shape[1] > W:
        heads = add_halves(heads)
    return tot_w, heads                                    # (48*deg, W)


def _finish(f, tot_planes, head_planes, c, impl):
    """(48*deg, W) plane partials -> final point: doublings + Horner ladder."""
    add = _plane_add(f, impl)
    dbl = _plane_double(f, impl)

    def dbl_k(p, k):
        return lax.fori_loop(0, k, lambda i, a: dbl(a), p) if k else p

    W = tot_planes.shape[1]
    neg_head = _point_to_planes(
        f, JC.point_neg(f, _planes_to_point(f, head_planes))
    )
    window = add(dbl_k(tot_planes, c - 1), neg_head)

    def horner(w, acc):
        pw = lax.dynamic_slice_in_dim(window, W - 1 - w, 1, axis=1)
        return add(dbl_k(acc, c), pw)

    acc = lax.fori_loop(0, W, horner, _plane_infinity(f, 1))
    return jax.tree.map(lambda a: a[0], _planes_to_point(f, acc))


# Max point-axis batch per compiled flat pipeline.  Two reasons:
#   1. working-set size: the flat batch is W*chunk gathered rows plus
#      roughly the same again in upsweep levels (~3x chunk * 192B * W);
#   2. shape bucketing: any larger MSM runs as a lax.scan over fixed
#      chunks, so arbitrarily sized inputs share ONE compiled kernel.
MAX_CHUNK = {1: 1 << 16, 2: 1 << 15}


def _msm_chunked(f, pts_c, sc_c, c, impl):
    """Scan the bucket phase over (k, chunk, ...) stacked chunks, summing
    the W-wide window partials; ONE Horner finish at the end."""
    W = 256 // c
    add = _plane_add(f, impl)

    def body(acc, xs):
        pts, sc = xs
        tot, head = _window_partials(f, pts, sc, c, impl)
        acc_t, acc_h = acc
        return (add(acc_t, tot), add(acc_h, head)), None

    init = (_plane_infinity(f, W), _plane_infinity(f, W))
    (tot, head), _ = lax.scan(body, init, (pts_c, sc_c))
    return _finish(f, tot, head, c, impl)


def msm_pow2(f, points, scalars, c: int = 8, impl: str | None = None):
    """msm() with the point axis padded to a power of two and large
    inputs split into fixed-size chunks (see MAX_CHUNK).  impl: see
    zklaim_tpu/kernels.py (None: the platform's choice)."""
    impl = curve_impl(impl)
    n = jax.tree.leaves(points)[0].shape[0]
    n2 = max(2, 1 << (n - 1).bit_length()) if n > 1 else 2
    chunk = MAX_CHUNK[f.deg]
    if n2 > chunk:
        # chunk-count rounded to a power of two: every MSM in a sweep
        # then hits one of log-many compiled (k, chunk) programs instead
        # of recompiling the (expensive) flat pipeline per exact size
        k = (n + chunk - 1) // chunk
        n2 = chunk * (1 << (k - 1).bit_length())
    if n2 != n:
        inf = JC.point_infinity(f, (n2 - n,))
        points = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), points, inf
        )
        scalars = jnp.pad(scalars, ((0, n2 - n), (0, 0)))
    if n2 <= chunk:
        return _msm_jit(f, points, scalars, c, impl)
    k = n2 // chunk
    pts_c = jax.tree.map(lambda a: a.reshape((k, chunk) + a.shape[1:]), points)
    sc_c = scalars.reshape(k, chunk, scalars.shape[-1])
    return _msm_chunked_jit(f, pts_c, sc_c, c, impl)


def msm_ladder(f, points, scalars):
    """Small-N MSM with an O(1)-size traced graph.

    Batched 256-step double-and-add computes scalars[i]*points[i] for
    all lanes at once (one fori_loop: 1 double + 1 add in the graph),
    then a fori_loop halving fold combines the N partial points: level
    t adds lane i+half into lane i via a dynamic roll, so the fold is
    ONE more point-add in the graph regardless of N.  No power-of-two
    or divisibility requirements (padding lanes are infinity, absorbed
    by the complete RCB formulas).  Slower per point than the flat
    pipeline at scale, but XLA:CPU compiles it in seconds at any N,
    which the unrolled tree is not (see _ladder_max).
    """
    per = JC.scalar_mul(f, points, scalars)
    n = jax.tree.leaves(per)[0].shape[0]
    n2 = max(1, 1 << (n - 1).bit_length()) if n > 1 else 1
    if n2 != n:
        inf = JC.point_infinity(f, (n2 - n,))
        per = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), per, inf
        )
    levels = n2.bit_length() - 1
    if levels == 0:
        return jax.tree.map(lambda a: a[0], per)

    def fold(t, cur):
        half = n2 >> (t + 1)
        rolled = jax.tree.map(lambda a: jnp.roll(a, -half, axis=0), cur)
        return JC.point_add(f, cur, rolled)

    out = lax.fori_loop(0, levels, fold, per)
    return jax.tree.map(lambda a: a[0], out)


def msm_flat(f, points, scalars, c: int = 8, impl: str = "xla"):
    """The flat single-sort Pippenger pipeline (module docstring).

    N * (256/c) must be a power of two (callers pad via msm_pow2).
    Traced-graph size grows with W*N, so XLA:CPU compiles it slowly;
    use msm() for automatic small-N dispatch.
    """
    tot_w, head_w = _window_partials(f, points, scalars, c, impl)
    return _finish(f, tot_w, head_w, c, impl)


def msm(f, points, scalars, c: int = 8, impl: str = "xla"):
    """Multi-scalar multiplication: sum_i scalars[i] * points[i].

    f: JC.FQ_OPS (G1) or JC.FQ2_OPS (G2) -- pass statically under jit.
    points: projective pytree, batch (N,); scalars (N, 16) u32
    plain-domain (NOT Montgomery) Fr limbs.  Returns a projective point
    pytree with scalar batch shape ().

    Dispatch: N <= ZKLAIM_MSM_LADDER_MAX (default 512) uses the
    compile-cheap ladder; larger N uses the flat Pippenger pipeline
    (which then requires N*(256/c) to be a power of two — msm_pow2
    pads arbitrary sizes).
    """
    n = jax.tree.leaves(points)[0].shape[0]
    if n <= _ladder_max():
        return msm_ladder(f, points, scalars)
    return msm_flat(f, points, scalars, c, impl)


# Module-level jit wrappers: a fresh jax.jit() per call would re-trace the
# (large) windowed graph on every invocation even when the compiled
# executable is cached persistently.
_msm_jit = jax.jit(msm, static_argnums=(0, 3, 4))
_msm_chunked_jit = jax.jit(_msm_chunked, static_argnums=(0, 3, 4))

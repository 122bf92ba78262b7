"""Banded DP primitives for online time warping.

The reference's OTW/LiveNote engines evaluate DP cells one at a time in
Python: a width-``c`` row band per live frame (otw_eran.py:58-62), a
width-``c`` column band per reference advance (otw_eran.py:73-77), and band
argmins for the best point (otw_eran.py:192-211).

Device reformulation (SURVEY.md §7 "align/otw.py"): each band update becomes a
fixed-shape vectorized computation against the full accumulated-cost matrix —
one matvec for the cell costs, one vectorized min for the up/diagonal
candidates, and a length-``c`` min-plus chain for the within-band left/up
dependency (the only true serial dependency; ``c`` is small and static),
evaluated either as a log-depth associative scan (fast path) or in the
reference's sequential cell order (bit-exact parity mode) — see
``_minplus_chain``.

All functions are pure and shape-static; they are assembled into jitted
insert/set_live steps by ``models.online_core``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Traced start indices in dynamic slices must share one integer type; these
# pair with the engines' int32 pointers.
_I0 = jnp.int32(0)
_I1 = jnp.int32(1)


def _cost_vector(query: jnp.ndarray, bank: jnp.ndarray, euclidean: bool) -> jnp.ndarray:
    """Cost of one feature column against every column of ``bank``.

    cosine (otw_eran.py:220, livenote.py:161): ``1 − q·bank``
    euclidean (livenote_v2.py:167-168): ``sqrt(Σ (q − bank)²)``

    HIGHEST: full f32 — a TF32 product would move costs by ~1e-3 and flip
    path decisions against the f64 reference.
    """
    if euclidean:
        d = bank - query[:, None]
        return jnp.sqrt(jnp.sum(d * d, axis=0))
    return 1.0 - jnp.matmul(query, bank, precision=lax.Precision.HIGHEST)


def _shift_fill_inf(v: jnp.ndarray) -> jnp.ndarray:
    """v[k] ← v[k-1], +inf into slot 0 (masks the k=0 diagonal/up step)."""
    return jnp.concatenate([jnp.full((1,), jnp.inf, v.dtype), v[:-1]])


def _minplus_chain(b_win: jnp.ndarray, c_win: jnp.ndarray, r_init: jnp.ndarray, exact: bool) -> jnp.ndarray:
    """Band recurrence ``r_k = min(b_k, r_{k-1} + c_k)`` with
    ``r_{-1} = r_init``.

    ``exact=False`` (default runtime path): the recurrence is an associative
    min-plus composition — element ``(c_k, b_k)`` composes as
    ``(c₁,b₁)⊕(c₂,b₂) = (c₁+c₂, min(b₁+c₂, b₂))`` — so it runs as a
    log-depth ``lax.associative_scan`` of pure vector ops, where the O(c)
    sequential form would be c dependent steps; the tree form reassociates
    the cost sums, which can differ from the reference by ~1 ulp (observed
    path-identical on real and random data).

    ``exact=True``: the reference's left-to-right evaluation order,
    bit-identical accumulated costs; used by the CPU parity tests.
    """
    # fold the boundary value into element 0 (vector ops only — no extracts)
    first = jnp.arange(b_win.shape[0]) == 0
    b0 = jnp.where(first, jnp.minimum(b_win, r_init + c_win), b_win)

    if exact:
        def step(r, bc):
            b, cc = bc
            r2 = jnp.minimum(b, r + cc)
            return r2, r2

        _, rs = lax.scan(step, r_init, (b_win, c_win))
        return rs

    def combine(e1, e2):
        c1, r1 = e1
        c2, r2 = e2
        return c1 + c2, jnp.minimum(r1 + c2, r2)

    _, rs = lax.associative_scan(combine, (c_win, b0))
    return rs


def row_update(acc, live, ref, t, j, *, c: int, sentinel: float, euclidean: bool, exact: bool = False, enable=None):
    """Evaluate row band ``(t, [max(0, j−c+1) .. j])`` (otw_eran.py:58-62).

    Row ``t`` is fresh (never written before), so the left neighbour of the
    band's first cell is the uncomputed-cell sentinel, exactly as the
    reference reads it.
    """
    dtype = acc.dtype
    f = ref.shape[0]
    n = ref.shape[1]
    live_t = lax.dynamic_slice(live, (_I0, t), (f, 1))[:, 0]
    cost_row = _cost_vector(live_t, ref, euclidean)  # (N,)

    prev_row = lax.dynamic_slice(acc, (t - _I1, _I0), (1, n))[0]
    diag = _shift_fill_inf(prev_row)
    # up/diag candidates (left is the sequential chain below); min order is
    # value-exact vs the reference's min-of-list
    b = jnp.minimum(prev_row + cost_row, diag + 2.0 * cost_row)

    s = jnp.maximum(j - (c - 1), 0)
    b_win = lax.dynamic_slice(b, (s,), (c,))
    c_win = lax.dynamic_slice(cost_row, (s,), (c,))
    # left neighbour of cell (t, s): sentinel when s>0 (uncomputed cell read
    # by the reference), no left step at all when s==0
    r_init = jnp.where(s > 0, jnp.asarray(sentinel, dtype), jnp.asarray(jnp.inf, dtype))
    chain = _minplus_chain(b_win, c_win, r_init, exact)

    idx = s + jnp.arange(c)
    old_win = lax.dynamic_slice(acc, (t, s), (1, c))[0]
    mask = idx <= j
    if enable is not None:
        # predication by masking instead of lax.cond: a cond carrying the
        # dense acc matrix makes XLA copy the whole buffer per step
        mask = mask & enable
    new_win = jnp.where(mask, chain, old_win)
    return lax.dynamic_update_slice(acc, new_win[None, :], (t, s))


def col_update(acc, live, ref, t, j, *, c: int, sentinel: float, euclidean: bool, exact: bool = False, enable=None):
    """Evaluate column band ``([max(0, t−c+1) .. t], j)`` (otw_eran.py:73-77).

    Column ``j`` is fresh; cells of column ``j−1`` are read whether or not
    they were ever evaluated — uncomputed ones hold the sentinel, as in the
    reference's dense matrices.
    """
    dtype = acc.dtype
    f, m = live.shape
    ref_j = lax.dynamic_slice(ref, (_I0, j), (f, 1))[:, 0]
    cost_col = _cost_vector(ref_j, live, euclidean)  # (M,)

    prev_col = lax.dynamic_slice(acc, (_I0, j - _I1), (m, 1))[:, 0]
    diag = _shift_fill_inf(prev_col)
    b = jnp.minimum(prev_col + cost_col, diag + 2.0 * cost_col)

    s = jnp.maximum(t - (c - 1), 0)
    b_win = lax.dynamic_slice(b, (s,), (c,))
    c_win = lax.dynamic_slice(cost_col, (s,), (c,))
    r_init = jnp.where(s > 0, jnp.asarray(sentinel, dtype), jnp.asarray(jnp.inf, dtype))
    chain = _minplus_chain(b_win, c_win, r_init, exact)

    idx = s + jnp.arange(c)
    old_win = lax.dynamic_slice(acc, (s, j), (c, 1))[:, 0]
    mask = idx <= t
    if enable is not None:
        mask = mask & enable
    new_win = jnp.where(mask, chain, old_win)
    return lax.dynamic_update_slice(acc, new_win[:, None], (s, j))


def eval_cell(acc, live, ref, x, y, *, euclidean: bool):
    """Single-cell DP evaluation at traced indices (otw_eran.py:215-239).

    Used by set_live's prologue, which evaluates cell ``(t, j)`` before the
    main loop — at a fresh state this is the origin cell, after streaming
    inserts it re-evaluates the current frontier cell (LiveNote semantics,
    livenote.py:105-108).  Edge neighbours are excluded from the min exactly
    as the reference's ``if x > 0`` / ``if y > 0`` guards do; interior
    neighbours are read from the dense matrix whether or not they were ever
    computed (sentinel reads, as in the reference)."""
    dtype = acc.dtype
    f = ref.shape[0]
    live_x = lax.dynamic_slice(live, (_I0, x), (f, 1))[:, 0]
    ref_y = lax.dynamic_slice(ref, (_I0, y), (f, 1))[:, 0]
    if euclidean:
        d = live_x - ref_y
        cost = jnp.sqrt(jnp.sum(d * d)).astype(dtype)
    else:
        cost = (1.0 - jnp.matmul(live_x, ref_y, precision=lax.Precision.HIGHEST)).astype(dtype)

    inf = jnp.asarray(jnp.inf, dtype)
    # dynamic_slice clamps negative starts to 0; the masks discard those reads
    left = lax.dynamic_slice(acc, (x, y - _I1), (1, 1))[0, 0]
    up = lax.dynamic_slice(acc, (x - _I1, y), (1, 1))[0, 0]
    diag = lax.dynamic_slice(acc, (x - _I1, y - _I1), (1, 1))[0, 0]
    best = jnp.minimum(
        jnp.minimum(
            jnp.where(y > 0, left + cost, inf),
            jnp.where(x > 0, up + cost, inf),
        ),
        jnp.where((x > 0) & (y > 0), diag + 2.0 * cost, inf),
    )
    new = jnp.where((x == 0) & (y == 0), cost, best)
    return lax.dynamic_update_slice(acc, new[None, None], (x, y))


def band_argmin(acc, t, j, *, c: int):
    """Best point over the row band ∪ column band (otw_eran.py:192-211).

    Returns ``(x, y)``.  First-min tie-breaking within each band matches
    ``np.argmin``; on a row/column tie the column result wins (the reference
    tests ``cost_j < cost_t`` strictly).  Band windows are clamped to width
    ``c`` at the matrix edge; the extra cells they cover hold the huge
    uncomputed-cell sentinel and can never win the argmin.
    """
    sj = jnp.maximum(j - (c - 1), 0)
    row_win = lax.dynamic_slice(acc, (t, sj), (1, c))[0]
    best_j = sj + jnp.argmin(row_win)
    cost_j = jnp.min(row_win)  # == row_win[argmin]; avoids a scalar extract

    st = jnp.maximum(t - (c - 1), 0)
    col_win = lax.dynamic_slice(acc, (st, j), (c, 1))[:, 0]
    best_t = st + jnp.argmin(col_win)
    cost_t = jnp.min(col_win)

    use_row = cost_j < cost_t
    x = jnp.where(use_row, t, best_t)
    y = jnp.where(use_row, best_j, j)
    return x.astype(jnp.int32), y.astype(jnp.int32)

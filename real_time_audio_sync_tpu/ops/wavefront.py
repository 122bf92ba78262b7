"""Anti-diagonal wavefront dynamic programming for DTW-family recurrences.

The reference computes its accumulated-cost matrices with O(M·N) pure-Python
double loops (dtw.py:32-40, wtw.py:201-215).  On the device the same recurrence is
reformulated as a `lax.scan` over the M+N−1 anti-diagonals: every cell of a
diagonal depends only on the two previous diagonals, so each scan step is one
fully vectorized update of up to min(M, N) cells — no data-dependent
control flow, static shapes throughout.  (The same wavefront decomposition —
with the two-previous-diagonals linear-memory property — is the basis of
exact parallelizable DTW in Tralie & Dempsey, "Exact, Parallelizable Dynamic
Time Warping Alignment with Linear Memory", arXiv:2008.02734.)

Two step conventions exist in the reference and are captured as
:class:`StepSpec`:

- ``DTW_SPEC`` — dtw.py:30-40: candidate order (left, up, diag) with the
  diagonal weighted 2×; back codes 0=left, 1=up, 2=diag, corner code 2;
  ``np.argmin`` first-min tie-breaking.
- ``WTW_SPEC`` — wtw.py:173-217: candidate order (up, left, diag), all
  weights 1 (strict ``<`` update ⇒ first-min priority up, left, diag); back
  codes 3=up("below"), 1=left, 2=diag, corner code 0.

The skewed (diagonal-major) layout, the scan and the backtracking scan all
run in a single jitted program; tie-breaking parity with the reference is
exact because the per-candidate arithmetic is performed in the same order
with the same dtype.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """DP step convention: candidates in tie-priority order."""

    # (di, dj) of each candidate, in the order the reference compares them
    steps: Tuple[Tuple[int, int], ...]
    # multiplier applied to the cell cost for each candidate
    weights: Tuple[float, ...]
    # back-pointer code recorded for each candidate
    codes: Tuple[int, ...]
    # back-pointer code of the (0, 0) corner
    corner_code: int


DTW_SPEC = StepSpec(
    steps=((0, -1), (-1, 0), (-1, -1)),
    weights=(1.0, 1.0, 2.0),
    codes=(0, 1, 2),
    corner_code=2,
)

WTW_SPEC = StepSpec(
    steps=((-1, 0), (0, -1), (-1, -1)),
    weights=(1.0, 1.0, 1.0),
    codes=(3, 1, 2),
    corner_code=0,
)


def _skew(mat: jnp.ndarray, fill) -> jnp.ndarray:
    """(M, N) → diagonal-major (M+N-1, M): out[d, i] = mat[i, d-i] (else fill)."""
    m, n = mat.shape
    padded = jnp.concatenate([mat, jnp.full((m, m - 1), fill, mat.dtype)], axis=1) if m > 1 else mat
    rolled = jax.vmap(jnp.roll)(padded, jnp.arange(m))
    return rolled.T


def _unskew(skewed: jnp.ndarray, n: int) -> jnp.ndarray:
    """Inverse of :func:`_skew`: (M+N-1, M) → (M, N)."""
    m = skewed.shape[1]
    unrolled = jax.vmap(jnp.roll)(skewed.T, -jnp.arange(m))
    return unrolled[:, :n]


@partial(jax.jit, static_argnames=("spec", "unroll"))
def wavefront_dp(cost: jnp.ndarray, spec: StepSpec = DTW_SPEC, unroll: bool = False):
    """Run the DP over anti-diagonals.

    Returns ``(acc, back)`` — the accumulated-cost matrix and the
    back-pointer matrix (codes per ``spec``), both (M, N).

    ``unroll=True`` traces the M+N−1 diagonal updates as straight-line code
    instead of a ``lax.scan`` — identical results; for small windows (WTW's
    w×w) this removes the per-loop-iteration overhead, which can dominate
    the tiny per-diagonal vector work.
    """
    m, n = cost.shape
    dtype = cost.dtype
    inf = jnp.asarray(jnp.inf, dtype)
    n_diag = m + n - 1

    cost_skew = _skew(cost, inf)  # (D, M)
    weights = [jnp.asarray(w, dtype) for w in spec.weights]
    code_map = jnp.asarray(spec.codes, jnp.int8)

    def shift_down(v):  # index i ← i-1, INF into row 0
        return jnp.concatenate([jnp.full((1,), inf, dtype), v[:-1]])

    def step(carry, xs):
        prev, prev2 = carry  # acc over diagonals d-1, d-2
        c, d = xs
        neighbors = []
        for (di, dj) in spec.steps:
            if (di, dj) == (0, -1):  # left: same index, previous diagonal
                neighbors.append(prev)
            elif (di, dj) == (-1, 0):  # up: shifted index, previous diagonal
                neighbors.append(shift_down(prev))
            else:  # diagonal: shifted index, diagonal d-2
                neighbors.append(shift_down(prev2))
        cands = jnp.stack([nb + w * c for nb, w in zip(neighbors, weights)])
        pick = jnp.argmin(cands, axis=0)  # first-min ⇒ reference tie order
        val = jnp.min(cands, axis=0)
        code = code_map[pick]
        # corner cell (0, 0) on diagonal 0 has no predecessors
        is_corner = (d == 0) & (jnp.arange(m) == 0)
        val = jnp.where(is_corner, c, val)
        code = jnp.where(is_corner, jnp.int8(spec.corner_code), code)
        return (val, prev), (val, code)

    init = (jnp.full((m,), inf, dtype), jnp.full((m,), inf, dtype))
    if unroll:
        carry = init
        accs, backs = [], []
        for d in range(n_diag):
            carry, (val, code) = step(carry, (cost_skew[d], jnp.int32(d)))
            accs.append(val)
            backs.append(code)
        acc_skew = jnp.stack(accs)
        back_skew = jnp.stack(backs)
    else:
        xs = (cost_skew, jnp.arange(n_diag))
        _, (acc_skew, back_skew) = jax.lax.scan(step, init, xs)

    return _unskew(acc_skew, n), _unskew(back_skew, n)


@partial(jax.jit, static_argnames=("spec", "unroll"))
def backtrack(back: jnp.ndarray, spec: StepSpec = DTW_SPEC, unroll: bool = False):
    """Trace the optimal path from (M-1, N-1) to (0, 0).

    Returns ``(points, length)``: a (M+N-1, 2) int32 array whose first
    ``length`` rows are the path **in reverse order** (end → origin), matching
    the reference's pre-``reverse()`` construction (dtw.py:42-51,
    wtw.py:219-240).  ``unroll=True`` as in :func:`wavefront_dp`.
    """
    m, n = back.shape
    max_len = m + n - 1
    # map engine back codes → (di, dj)
    table = np.zeros((max(spec.codes) + 1, 2), np.int32)
    for (di, dj), code in zip(spec.steps, spec.codes):
        table[code] = (di, dj)
    table = jnp.asarray(table)

    def step(carry, _):
        i, j, done = carry
        code = back[i, j].astype(jnp.int32)
        di, dj = table[code, 0], table[code, 1]
        emitted = jnp.stack([i, j])
        now_done = done | ((i == 0) & (j == 0))
        i2 = jnp.where(now_done, i, i + di)
        j2 = jnp.where(now_done, j, j + dj)
        return (i2, j2, now_done), (emitted, done)

    init = (jnp.int32(m - 1), jnp.int32(n - 1), jnp.bool_(False))
    if unroll:
        carry = init
        pts, dones = [], []
        for _ in range(max_len):
            carry, (emitted, done_before) = step(carry, None)
            pts.append(emitted)
            dones.append(done_before)
        points = jnp.stack(pts)
        length = max_len - jnp.sum(jnp.stack(dones))
    else:
        (_, _, _), (points, done_before) = jax.lax.scan(step, init, None, length=max_len)
        length = max_len - jnp.sum(done_before)
    return points, length

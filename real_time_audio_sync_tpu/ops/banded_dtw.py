"""Banded offline DTW — hour-scale full-pair alignment in O(M·band) memory.

The dense wavefront (ops/wavefront.py) materializes
O(M·N) acc+back matrices: exact reference parity (dtw.py:5-53), but two
hour-long recordings (M ≈ N ≈ 39k frames) need ~12 GB — a large share of
the device and beyond any host the reference could run on (its dense f64 matrices would
be ~24 TB).  This module restricts the DP to a Sakoe-Chiba-style band of
``band`` reference frames around the resampled main diagonal — the same
banded-locality assumption the online engines already make (SURVEY.md §5.7:
OTW's width-c search band, WTW's window tiling), applied to the offline
recurrence:

- **band-relative rows**: row ``i`` keeps only ``acc[i, off(i) : off(i)+W]``
  with ``off(i) = clip(i·(N−1)//(M−1) − W/2, 0, N−W)`` — a (W,) vector
  carried through a ``lax.scan`` over live frames.  Advancing a row shifts
  the window by ``off(i) − off(i−1)`` (a dynamic slice of the padded carry).
- the within-row left dependency is the associative min-plus chain
  (ops/band.py ``_minplus_chain`` composition) — log-depth, which
  reassociates cost sums by ~1 ulp vs the sequential reference order (the
  documented deviation class of the streaming engines; observed
  path-identical on real audio).
- back codes are recomputed from the final row values with the reference's
  first-min candidate order (left, up, diag — dtw.py:35-38, DTW_SPEC), so
  backtracking follows exactly the reference's tie-breaking.
- cells outside the band read +inf: the result is EXACT full DTW whenever
  the unconstrained optimal path stays within the band (tested against the
  dense wavefront on real and synthetic pairs), and the band width is the
  explicit accuracy/memory dial otherwise.

Memory: back codes (M, W) int8 + offsets (M,) int32 — ~20 MB for an
hour-long pair at W=512, vs ~12 GB dense.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@partial(jax.jit, static_argnames=("band",))
def _banded_dp(seq_a, seq_b, band: int):
    """Returns (last_row (W,), offs (M,) int32, codes (M, W) int8).

    ``codes``: 0=left, 1=up, 2=diag (DTW_SPEC back codes; corner code 2)."""
    f, m = seq_a.shape
    n = seq_b.shape[1]
    w = band
    dtype = seq_a.dtype
    inf = jnp.asarray(jnp.inf, dtype)
    denom = max(m - 1, 1)
    dmax = -(-(n - 1) // denom) + 1  # max per-row window shift, static pad

    def off_of(i):
        return jnp.clip(i * (n - 1) // denom - w // 2, 0, max(n - w, 0))

    def combine(e1, e2):  # min-plus composition (ops/band.py)
        c1, r1 = e1
        c2, r2 = e2
        return c1 + c2, jnp.minimum(r1 + c2, r2)

    barange = jnp.arange(w)

    def row_step(carry, i):
        prev, prev_off = carry
        off = off_of(i)
        delta = off - prev_off
        ref_win = lax.dynamic_slice(seq_b, (jnp.int32(0), off), (f, w))
        live_i = lax.dynamic_slice(seq_a, (jnp.int32(0), i), (f, 1))[:, 0]
        # (W,) cosine cost (dtw.py:11); Precision.HIGHEST = full f32 so
        # the banded DP agrees with the dense engine's cost (a reduced-
        # precision path differs per program shape —
        # models/dtw._cosine_cost rationale)
        cost = 1.0 - jnp.matmul(live_i, ref_win,
                                precision=jax.lax.Precision.HIGHEST)

        prev_pad = jnp.concatenate([jnp.full((1,), inf, dtype), prev,
                                    jnp.full((dmax,), inf, dtype)])
        up = lax.dynamic_slice(prev_pad, (delta + 1,), (w,))  # prev[b+delta]
        diag = lax.dynamic_slice(prev_pad, (delta,), (w,))  # prev[b+delta-1]

        bvec = jnp.minimum(up + cost, diag + 2.0 * cost)
        # corner (0, 0) = cost folds in BEFORE the chain so row 0's
        # cumulative left-edge (dtw.py:20-23) propagates through it
        first = barange == 0
        is_corner = (i == 0) & (off + barange == 0)
        bvec = jnp.where(is_corner, cost, bvec)
        # left chain: r_b = min(bvec_b, r_{b-1} + cost_b); left of the band's
        # first cell is outside the band → inf (j = 0 has no left at all)
        _, r = lax.associative_scan(combine, (cost, bvec))

        # back codes recomputed from the FINAL row values in the reference's
        # first-min candidate order (left, up, diag — dtw.py:35-38).  The
        # associative chain reassociates sums by ~1 ulp, so r itself cannot
        # be equality-matched against candidates; the argmin over the
        # recomputed candidates is self-consistent for backtracking (the
        # documented chain-deviation class, ops/band.py)
        left_cand = jnp.where(first, inf,
                              jnp.concatenate([jnp.full((1,), inf, dtype),
                                               r[:-1]]) + cost)
        up_cand = up + cost
        diag_cand = diag + 2.0 * cost
        best = jnp.minimum(jnp.minimum(left_cand, up_cand), diag_cand)
        code = jnp.where(left_cand == best, 0,
                         jnp.where(up_cand == best, 1, 2)).astype(jnp.int8)
        code = jnp.where(is_corner, jnp.int8(2), code)
        return (r, off), (code, off)

    init = (jnp.full((w,), inf, dtype), jnp.int32(0))
    (last_row, _), (codes, offs) = lax.scan(
        row_step, init, jnp.arange(m, dtype=jnp.int32))
    return last_row, offs.astype(jnp.int32), codes


@partial(jax.jit, static_argnames=("n",))
def _banded_backtrack(codes, offs, n: int):
    """Trace the path from (M−1, N−1) through the band-relative codes.

    Same output contract as ops/wavefront.backtrack: (points (M+N-1, 2)
    int32 end → origin with frozen repeats after the origin, length), plus
    ``edge_touched``: True when any visited cell sat on (or past) a band
    edge that is *interior* to the matrix — the signal that the band was too
    narrow and the result may differ from the dense optimum.  Coordinates
    are clamped at 0 so a too-narrow band yields a terminating (degraded)
    path instead of negative-coordinate garbage (ADVICE r4 item 2)."""
    m, w = codes.shape
    max_len = m + n - 1

    def step(carry, _):
        i, j, done, edge = carry
        b_raw = j - offs[i]
        b = jnp.clip(b_raw, 0, w - 1)
        # touching the band's left edge while off > 0 (a real left neighbor
        # exists outside the band) or its right edge while off + w < n means
        # the banded path was constrained where the dense one wasn't
        interior_left = (b_raw <= 0) & (offs[i] > 0)
        interior_right = (b_raw >= w - 1) & (offs[i] + w < n)
        edge = edge | (~done & (interior_left | interior_right))
        code = codes[i, b].astype(jnp.int32)
        emitted = jnp.stack([i, j])
        now_done = done | ((i == 0) & (j == 0))
        di = jnp.where(code == 0, 0, -1)  # left keeps i
        dj = jnp.where(code == 1, 0, -1)  # up keeps j
        i2 = jnp.maximum(jnp.where(now_done, i, i + di), 0)
        j2 = jnp.maximum(jnp.where(now_done, j, j + dj), 0)
        return (i2, j2, now_done, edge), (emitted, done)

    init = (jnp.int32(m - 1), jnp.int32(n - 1), jnp.bool_(False),
            jnp.bool_(False))
    (_, _, _, edge_touched), (points, done_before) = lax.scan(
        step, init, None, length=max_len)
    length = max_len - jnp.sum(done_before)
    return points, length, edge_touched


def _validate_path(path: np.ndarray, m: int, n: int) -> None:
    """Host-side sanity check: monotone steps in {(1,0),(0,1),(1,1)},
    origin → corner.  A violation means the band was too narrow for even a
    degraded-but-valid path (ADVICE r4 item 2) — raise with guidance rather
    than return garbage."""
    ok = (
        len(path) >= 1
        and tuple(path[0]) == (0, 0)
        and tuple(path[-1]) == (m - 1, n - 1)
    )
    if ok and len(path) > 1:
        d = np.diff(path, axis=0)
        ok = bool(np.all((d >= 0) & (d <= 1)) and np.all(d.sum(axis=1) >= 1))
    if not ok:
        raise ValueError(
            "banded DTW backtrack produced an invalid path — the band is too "
            "narrow for this pair; widen `band` (or use dtw_auto, which "
            "widens and retries automatically)")


def dtw_banded(seq_a, seq_b, band: int = 512, *, return_edge_touch=False):
    """Banded offline DTW: ``(path (L, 2) origin → end, final_cost)``.

    ``path`` matches the dense :func:`~real_time_audio_sync_tpu.models.dtw.
    DTW` path whenever the unconstrained optimal path stays within ``band``
    reference frames of the resampled main diagonal; O(M·band) memory makes
    hour-long pairs feasible on one chip.  ``final_cost`` is
    ``acc[M−1, N−1]`` (the reference's returned ``cost[-1, -1]`` regime).

    With ``return_edge_touch=True`` a third value is returned: True when the
    backtracked path touched a band edge interior to the matrix — i.e. the
    band constrained the path and a wider band might find a better one
    (the widen-and-retry signal ``dtw_auto`` uses for its exactness loop).
    The returned path is always validated monotone origin → corner; a band
    too narrow to produce even that raises ValueError.
    """
    seq_a = jnp.asarray(seq_a)
    seq_b = jnp.asarray(seq_b)
    f, m = seq_a.shape
    n = seq_b.shape[1]
    w = min(band, n)
    if w < 1:
        raise ValueError("empty reference")
    last_row, offs, codes = _banded_dp(seq_a, seq_b, w)
    points, length, edge = _banded_backtrack(codes, offs, n)
    final = last_row[n - 1 - offs[m - 1]]
    pts, ln, fin, edge = jax.device_get((points, length, final, edge))
    path = np.asarray(pts)[: int(ln)][::-1]
    _validate_path(path, m, n)
    if return_edge_touch:
        return path, float(fin), bool(edge)
    return path, float(fin)

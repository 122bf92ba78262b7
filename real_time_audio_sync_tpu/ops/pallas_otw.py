"""One Pallas kernel (Triton route) for every online time-warping engine.

The XLA engine (models/online_core.py) runs each insert as a chain of small
HLO ops against a dense (2N, N) accumulator; on a GPU every op that XLA does
not fuse is its own kernel launch.  This kernel runs K inserts
(otw_eran.py:38-85) per launch for B independent streams, one program per
stream (grid ``(B,)``), and keeps each stream's DP state at O(c):

- **two band vectors**: ``rowv[b] = acc[t, j-c+b]`` and
  ``colv[a] = acc[t-c+a, j]`` for ``a, b ∈ [0, c]``.  A row band update reads
  only the previous row and a column band update only the previous column
  (otw_eran.py:58-62, 73-77), and the best point reads the current row and
  column (otw_eran.py:192-211), so nothing else of the accumulator is ever
  read again.  Advancing ``t`` shifts ``colv`` by one and appends the new
  row's last cell; advancing ``j`` does the same to ``rowv``.
- **features read by index from device memory**: the reference as a
  (rows, F) array with ``c`` leading zero rows (row ``j + c`` ↔ column j);
  live frames from this launch's column block, older ones from a ring of the
  last R frames that each launch rewrites.
- **costs as elementwise products and sums in f32** — never a matrix-unit
  dot, so TF32 never enters.
- **the min-plus chain** ``r_k = min(b_k, r_{k-1} + c_k)`` either as one
  (R, R) tile (a masked cumulative sum of the costs, then a min over the
  sources; sums reassociate at the ulp level like the XLA engine's
  associative scan) or, with ``exact_chain``, in the reference's sequential
  order.
- band argmins as min + first-match, keeping ``np.argmin``'s first-min order
  even where computed cells equal the uncomputed-cell sentinel;
- scalar state, band vectors and the committed path are aliased from input
  to output, so nothing is rebuilt between launches.

The same kernel serves solo streaming (B=1), B-stream serving (shared or
per-stream references), references of any length, and batched ``set_live``
(K = the live length, with set_live's extra origin point seeded into the
state — :func:`pallas_batched_set_live`).

Shifts by a static offset are one (R, R) masked min: exact, because every
other candidate is +inf.  ``interpret=True`` runs the kernel in the Pallas
interpreter (CPU tests); otherwise it compiles for an NVIDIA GPU through
Triton (:func:`real_time_audio_sync_tpu.ops.require_kernel_platform`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from real_time_audio_sync_tpu.models.online_core import BOTH, COL, PREV_NONE, ROW, OnlineConfig
from real_time_audio_sync_tpu.ops import require_kernel_platform

# scalar-state slots, one int32 row of _N_SCALARS per stream
(S_T, S_J, S_RC, S_PREV, S_PLEN, S_LASTX, S_LASTY, S_FIRST,
 S_STOPPED, S_DIR, S_OVERFLOW) = range(11)
_N_SCALARS = 16
_N_STATUS = 8

_NUM_WARPS = 4


def _pow2(x: int, lo: int = 1) -> int:
    return max(lo, 1 << (int(x) - 1).bit_length())


def band_width(c: int) -> int:
    """R: the band vectors' and live ring's length (power of two > c)."""
    return _pow2(c + 1, 16)


def feature_width(f: int) -> int:
    return _pow2(f, 16)


def ref_rows(c: int, n: int) -> int:
    """Rows of the padded reference: c leading zero rows, n frames, and
    room for a full R-row window read at j = n-1."""
    return _pow2(c + n + band_width(c))


def path_capacity(n: int, t: int) -> int:
    """Committed points bound: one per set_direction, at most t + n + 1."""
    return _pow2(t + n + 16)


def pad_ref(ref: np.ndarray, c: int) -> np.ndarray:
    """(F, N) reference → (rows, Fp) frame-major array, row j + c ↔ column j."""
    f, n = ref.shape
    out = np.zeros((ref_rows(c, n), feature_width(f)), np.float32)
    out[c : c + n, :f] = np.asarray(ref, np.float32).T
    return out


def init_state(cfg: OnlineConfig, b: int, f: int, p: int, seed_origin: bool = False):
    """Fresh state for B streams: (hist, vec, scalars, path) numpy arrays.

    ``seed_origin`` pre-commits the (0, 0) best point that set_live appends
    right after the origin eval, BEFORE its first row/column step
    (otw_eran.py:103-107) — the one place the batch-mode path differs from
    frame-by-frame insert.  With it, K streaming inserts reproduce set_live.
    """
    r = band_width(cfg.c)
    sc = np.zeros((b, _N_SCALARS), np.int32)
    sc[:, S_RC] = cfg.run_count_init
    sc[:, S_PREV] = PREV_NONE
    sc[:, S_LASTX] = -1
    sc[:, S_LASTY] = -1
    sc[:, S_FIRST] = 1
    sc[:, S_DIR] = BOTH
    if seed_origin:
        sc[:, S_PLEN] = 1
        sc[:, S_LASTX] = 0
        sc[:, S_LASTY] = 0
    return (
        np.zeros((b, r, feature_width(f)), np.float32),  # live-frame ring
        np.full((b, 2, r), cfg.sentinel, np.float32),  # rowv, colv
        sc,
        np.zeros((b, 2, p), np.int32),  # path x, y (slot 0 reads (0, 0))
    )


def _make_kernel(cfg: OnlineConfig, r: int, interpret: bool):
    c = cfg.c
    i32, f32 = jnp.int32, jnp.float32
    # numpy scalars, never Python ones: jax arrays closed over by a kernel
    # are captured consts, and a weakly typed literal in a select takes the
    # predicate's type in the Triton lowering
    sentinel = np.float32(cfg.sentinel)
    inf = np.float32(np.inf)
    two = np.float32(2.0)
    zero = np.float32(0.0)
    row, col, both, one = (np.int32(v) for v in (ROW, COL, BOTH, 1))

    def kernel(lens_ref, ref_ref, cols_ref, hist_ref, vec_in, sc_in, path_in,
               hist_out, vec_ref, sc_ref, path_ref, status_ref):
        del path_in  # aliased with path_ref; committed points are append-only
        iota = lax.broadcasted_iota(i32, (r,), 0)
        src = lax.broadcasted_iota(i32, (r, r), 0)  # tile row: source index
        dst = lax.broadcasted_iota(i32, (r, r), 1)  # tile column: target index
        k_rows = cols_ref.shape[0]

        live_cap = lens_ref[0]
        ref_len = lens_ref[1]
        n_valid = lens_ref[2]
        t0 = sc_in[S_T]
        first0 = sc_in[S_FIRST] != 0
        # live frame f arrived in this launch iff f >= k_base, as column
        # f - k_base of the block; older frames sit in the ring at f % r
        k_base = jnp.where(first0, np.int32(0), t0 + 1)

        def cost_of(feats, vec):
            """Costs of the rows of ``feats`` (r, Fp) against ``vec`` (Fp,):
            cosine 1 − q·x (otw_eran.py:220), Euclidean (livenote_v2.py:167)."""
            if cfg.euclidean:
                d = feats - vec[None, :]
                return jnp.sqrt(jnp.sum(d * d, axis=1))
            return 1.0 - jnp.sum(feats * vec[None, :], axis=1)

        def live_window(t):
            """(r, Fp): live frames t-c+a on rows a (clamped reads outside
            the band are masked by the callers)."""
            f = t - c + iota
            kidx = jnp.clip(f - k_base, 0, k_rows - 1)
            from_block = cols_ref[kidx, :]
            from_ring = hist_ref[f & (r - 1), :]
            return jnp.where((f >= k_base)[:, None], from_block, from_ring)

        def shift(v, s):
            """out[k] = v[k - s] (static s), +inf where k - s is off the end."""
            return jnp.min(jnp.where(src == dst - s, v[:, None], inf), axis=0)

        def chain(bvec, cost, lo):
            """r_k = min(b_k, r_{k-1} + c_k) over the band [lo, c]."""
            if cfg.exact_chain:
                def step(k, carry):
                    rk, out = carry
                    bk = jnp.min(jnp.where(iota == k, bvec, inf))
                    ck = jnp.min(jnp.where(iota == k, cost, inf))
                    rk = jnp.where(k == lo, bk, jnp.minimum(bk, rk + ck))
                    return rk, jnp.where(iota == k, rk, out)

                _, out = lax.fori_loop(lo, np.int32(c + 1), step,
                                       (inf, jnp.full((r,), inf, f32)))
                return out
            # S[i, k] = Σ_{i<m<=k} c_m, then r_k = min_{lo<=i<=k} b_i + S[i, k]
            steps = lax.cumsum(jnp.where((dst > src) & (dst <= c), cost[None, :], zero), axis=1)
            cands = jnp.where((src >= lo) & (src <= c) & (src <= dst), bvec[:, None] + steps, inf)
            return jnp.min(cands, axis=0)

        def band_update(prev, cost, lo, origin_at, sentinel_left):
            """One fresh band (a row or a column) from the previous one:
            up/left = prev[k], diagonal = prev[k-1] (none at k = 0 or at
            the matrix origin edge), then the min-plus chain."""
            band = (iota >= lo) & (iota <= c)
            diag = jnp.where((iota == 0) | (iota == origin_at), inf, shift(prev, 1))
            bvec = jnp.where(band, jnp.minimum(prev + cost, diag + two * cost), inf)
            # left (or up) neighbour of the band's first cell: the
            # uncomputed sentinel when the band is unclamped, no step at all
            # at the matrix edge
            r_init = jnp.where(sentinel_left, sentinel, inf)
            bvec = jnp.where(iota == lo, jnp.minimum(bvec, r_init + cost), bvec)
            return jnp.where(band, chain(bvec, cost, lo), sentinel)

        def row_update(j, lv, rowv, colv):
            """Row band (t, [max(0, j-c+1) .. j]) — otw_eran.py:58-62."""
            lo = jnp.maximum(c - j, 1)
            cost = cost_of(ref_ref[pl.ds(j, r), :], lv)
            new_row = band_update(rowv, cost, lo, c - j, j >= c)
            corner = jnp.min(jnp.where(iota == c, new_row, inf))
            new_col = jnp.where(iota == c, corner, shift(colv, -1))
            return new_row, new_col

        def col_update(t, j, rowv, colv):
            """Column band ([max(0, t-c+1) .. t], j) — otw_eran.py:73-77."""
            lo = jnp.maximum(c - t, 1)
            cost = cost_of(live_window(t), ref_ref[j + c, :])
            new_col = band_update(colv, cost, lo, c - t, t >= c)
            corner = jnp.min(jnp.where(iota == c, new_col, inf))
            new_row = jnp.where(iota == c, corner, shift(rowv, -1))
            return new_row, new_col

        def first_min(vals, valid):
            m = jnp.min(jnp.where(valid, vals, inf))
            k = jnp.min(jnp.where(valid & (vals == m), iota, np.int32(r)))
            return m, k

        def set_direction(t, j, rc, prev, plen, lastx, lasty, rowv, colv):
            """otw_eran.py:153-188 / livenote.py:184-207: append the best
            point, choose the next direction, update run count."""
            cost_j, bj = first_min(rowv, (iota >= jnp.maximum(c - j, 1)) & (iota <= c))
            cost_t, ak = first_min(colv, (iota >= jnp.maximum(c - t, 1)) & (iota <= c))
            use_row = cost_j < cost_t
            x = jnp.where(use_row, t, t - c + ak)
            y = jnp.where(use_row, j - c + bj, j)

            def commit():
                path_ref[0, plen] = x
                path_ref[1, plen] = y

            if cfg.monotone_path:
                ok = (plen == 0) | ((x > lastx) & (y >= lasty))
                pl.when(ok)(commit)
                plen = plen + ok.astype(i32)
                lastx = jnp.where(ok, x, lastx)
                lasty = jnp.where(ok, y, lasty)
            else:
                commit()
                plen, lastx, lasty = plen + 1, x, y
            startup = t < c
            forced = rc >= cfg.max_run_count
            forced_dir = jnp.where(prev == row, col, row)
            free_dir = jnp.where(x < t, col, jnp.where(y < j, row, both))
            d = jnp.where(startup, both, jnp.where(forced, forced_dir, free_dir))
            rc = jnp.where(d == prev, rc + 1, one)
            prev = jnp.where(d != both, d, prev)
            return d, rc, prev, plen, lastx, lasty

        def insert(carry):
            """One streaming insert (otw_eran.py:38-85) of block column k."""
            (k, t, j, rc, prev, plen, lastx, lasty, first, stopped, d,
             overflow, rowv, colv) = carry
            lv = cols_ref[k, :]

            def origin(vecs):
                # live[:, 0] ← col, acc[0, 0] = cost(0, 0) (otw_eran.py:43-48)
                c00 = cost_of(lv[None, :], ref_ref[c, :])
                v = jnp.where(iota == c, jnp.min(c00), sentinel)
                return v, v

            rowv, colv = lax.cond(first, origin, lambda v: v, (rowv, colv))
            # "ran out of room" keeps incrementing t and does nothing else
            # (otw_eran.py:50-54)
            t_new = jnp.where(first, t, t + 1)
            do_row = ~first & (t_new < live_cap)
            rowv, colv = lax.cond(
                do_row, lambda v: row_update(j, lv, *v), lambda v: v,
                (rowv, colv))

            # column phase (otw_eran.py:64-85): consecutive Column
            # directions cap at max_run_count, so loop_iters bounds it
            def phase_cond(ph):
                return ph[-1] & (ph[0] < cfg.loop_iters)

            def phase(ph):
                it, j2, rc2, prev2, plen2, lx2, ly2, stop2, d2, rowv2, colv2, _ = ph
                do_col = d2 != row
                j_new = jnp.where(do_col, j2 + 1, j2)
                new_stop = do_col & (j_new >= ref_len)
                rowv2, colv2 = lax.cond(
                    do_col & ~new_stop,
                    lambda v: col_update(t_new, j_new, *v), lambda v: v,
                    (rowv2, colv2))

                def with_dir(a):
                    return set_direction(t_new, j_new, *a, rowv2, colv2)

                d3, rc2, prev2, plen2, lx2, ly2 = lax.cond(
                    new_stop, lambda a: (d2, *a), with_dir,
                    (rc2, prev2, plen2, lx2, ly2))
                active = ~new_stop & (d3 == col)
                return (it + 1, j_new, rc2, prev2, plen2, lx2, ly2,
                        stop2 | new_stop, d3, rowv2, colv2, active)

            ph = lax.while_loop(phase_cond, phase, (
                np.int32(0), j, rc, prev, plen, lastx, lasty, stopped, d, rowv,
                colv, do_row))
            _, j, rc, prev, plen, lastx, lasty, stopped, d, rowv, colv, active = ph
            # a still-active phase means the loop bound was violated (never,
            # by design); sticky until the status is read
            # (first & ~first: a literal False would not lower as a carry)
            return (k + 1, t_new, j, rc, prev, plen, lastx, lasty,
                    first & ~first, stopped, d, overflow | active, rowv, colv)

        carry = (
            np.int32(0), t0, sc_in[S_J], sc_in[S_RC], sc_in[S_PREV], sc_in[S_PLEN],
            sc_in[S_LASTX], sc_in[S_LASTY], first0, sc_in[S_STOPPED] != 0,
            sc_in[S_DIR], sc_in[S_OVERFLOW] != 0, vec_in[0, :], vec_in[1, :],
        )
        (_, t, j, rc, prev, plen, lastx, lasty, first, stopped, d, overflow,
         rowv, colv) = lax.while_loop(
            lambda cr: (cr[0] < n_valid) & ~cr[9], insert, carry)

        # the ring keeps the newest r frames: slot q holds the newest frame
        # f <= t with f ≡ q (mod r)
        fq = t - ((t - iota) & (r - 1))
        kidx = jnp.clip(fq - k_base, 0, k_rows - 1)
        ring = jnp.where((fq >= k_base)[:, None], cols_ref[kidx, :], hist_ref[...])
        if not interpret:
            # every read of the aliased inputs precedes these stores
            plgpu.debug_barrier()
        hist_out[...] = ring
        vec_ref[0, :] = rowv
        vec_ref[1, :] = colv
        for slot, v in ((S_T, t), (S_J, j), (S_RC, rc), (S_PREV, prev),
                        (S_PLEN, plen), (S_LASTX, lastx), (S_LASTY, lasty),
                        (S_FIRST, first.astype(i32)),
                        (S_STOPPED, stopped.astype(i32)), (S_DIR, d),
                        (S_OVERFLOW, overflow.astype(i32))):
            sc_ref[slot] = v
        status_ref[0] = stopped.astype(i32) | (overflow.astype(i32) << 1)
        status_ref[1] = plen
        status_ref[2] = lastx
        status_ref[3] = lasty
        for slot in range(4, _N_STATUS):
            status_ref[slot] = np.int32(0)

    return kernel


@partial(jax.jit, static_argnames=("cfg", "interpret"),
         donate_argnames=("hist", "vec", "sc", "path"))
def band_insert_block(lens, ref, cols, hist, vec, sc, path, *, cfg: OnlineConfig,
                      interpret: bool = False):
    """K streaming inserts for each of B streams in one launch.

    ``lens`` (B, 4) int32 [live_cap, ref_len, n_valid, 0]; ``ref`` (1|B,
    rows, Fp) from :func:`pad_ref` (one row shared by every stream, or one
    per stream); ``cols`` (B, K, Fp) this launch's live columns; state
    ``hist, vec, sc, path`` from :func:`init_state`.  Returns
    ``(hist, vec, sc, path, status)`` with status (B, 8) int32
    ``[stopped | overflow<<1, path_len, last_x, last_y, 0...]``."""
    b, _, r = vec.shape
    shared = ref.shape[0] == 1

    def per_stream(arr):
        zeros = (0,) * (arr.ndim - 1)
        return pl.BlockSpec((None, *arr.shape[1:]), lambda i: (i, *zeros))

    ref_spec = pl.BlockSpec(
        (None, *ref.shape[1:]),
        (lambda i: (0, 0, 0)) if shared else (lambda i: (i, 0, 0)))
    status = jax.ShapeDtypeStruct((b, _N_STATUS), jnp.int32)
    return pl.pallas_call(
        _make_kernel(cfg, r, interpret),
        grid=(b,),
        in_specs=[per_stream(lens), ref_spec, per_stream(cols), per_stream(hist),
                  per_stream(vec), per_stream(sc), per_stream(path)],
        out_specs=(per_stream(hist), per_stream(vec), per_stream(sc),
                   per_stream(path), per_stream(status)),
        out_shape=(
            jax.ShapeDtypeStruct(hist.shape, jnp.float32),
            jax.ShapeDtypeStruct(vec.shape, jnp.float32),
            jax.ShapeDtypeStruct(sc.shape, jnp.int32),
            jax.ShapeDtypeStruct(path.shape, jnp.int32),
            status,
        ),
        # inputs (lens, ref, cols, hist, vec, sc, path) → outputs
        # (hist', vec', sc', path', status): the ring is rewritten whole,
        # the rest is updated in place
        input_output_aliases={4: 1, 5: 2, 6: 3},
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="band_insert_block",
    )(lens, ref, cols, hist, vec, sc, path)


def online_config(params, *, sentinel=1e10, run_count_init=1, monotone_path=False,
                  euclidean=False, exact_chain=False) -> OnlineConfig:
    from real_time_audio_sync_tpu.config import OTWParams

    p = OTWParams.from_any(params)
    return OnlineConfig(
        c=p.c, max_run_count=p.max_run_count, sentinel=sentinel,
        run_count_init=run_count_init, monotone_path=monotone_path,
        euclidean=euclidean, exact_chain=exact_chain,
    )


def pallas_set_live(ref, live, params, *, interpret=False, **cfg_kw):
    """Batch-align one pair with the kernel; returns ``(path (L, 2) int32,
    live_ptr, ref_ptr, stopped)``.  ``cfg_kw``: sentinel, run_count_init,
    monotone_path, euclidean, exact_chain (the engines' overrides)."""
    return pallas_batched_set_live([ref], [live], params, interpret=interpret, **cfg_kw)[0]


def batched_set_live_arrays(refs, lives, cfg: OnlineConfig):
    """Host-side inputs of a batched set_live launch: ``(lens, ref, cols,
    state)`` for :func:`band_insert_block`, one stream per pair.  One padded
    reference row is shared when every pair has the same reference."""
    refs = [np.asarray(x, np.float32) for x in refs]
    lives = [np.asarray(x, np.float32) for x in lives]
    b = len(refs)
    if len(lives) != b:
        raise ValueError(f"{b} refs vs {len(lives)} lives")
    c = cfg.c
    if min(x.shape[1] for x in refs) < c:
        raise ValueError("reference shorter than the search band")
    f = refs[0].shape[0]
    n_max = max(x.shape[1] for x in refs)
    t_max = max(x.shape[1] for x in lives)
    shared = all(x.shape == refs[0].shape and np.array_equal(x, refs[0]) for x in refs[1:])
    ref_arr = np.stack([_pad_to(pad_ref(x, c), ref_rows(c, n_max)) for x in (refs[:1] if shared else refs)])
    cols = np.zeros((b, t_max, feature_width(f)), np.float32)
    lens = np.zeros((b, 4), np.int32)
    for i, (rf, lv) in enumerate(zip(refs, lives)):
        cols[i, : lv.shape[1], :f] = lv.T
        # set_live stops at the 2N live capacity (otw_eran.py:14)
        lens[i] = (2 * rf.shape[1], rf.shape[1], lv.shape[1], 0)
    state = init_state(cfg, b, f, path_capacity(n_max, t_max), seed_origin=True)
    return lens, ref_arr, cols, state


def _pad_to(arr: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows, arr.shape[1]), arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def set_live_results(sc, path, lens):
    """Per-pair ``(path, live_ptr, ref_ptr, stopped)`` from a batched
    set_live launch's final scalars and path (numpy)."""
    out = []
    for i in range(sc.shape[0]):
        stopped = bool(sc[i, S_STOPPED])
        t = int(sc[i, S_T])
        # set_live's live_ptr counts one past the last frame when the live
        # sequence runs out without a stop (the loop's final t advance,
        # otw_eran.py:99) and halts at the 2N capacity (otw_eran.py:14)
        live_ptr = t if stopped else min(t + 1, int(lens[i, 0]))
        plen = int(sc[i, S_PLEN])
        out.append((np.stack([path[i, 0, :plen], path[i, 1, :plen]], axis=1),
                    live_ptr, int(sc[i, S_J]), stopped))
    return out


def pallas_batched_set_live(refs, lives, params, *, interpret=False, **cfg_kw):
    """Batch-align B pairs in one launch (one program per pair).

    ``refs``/``lives``: sequences of (F, Nᵢ)/(F, Tᵢ) arrays (ragged; true
    lengths drive each pair's stop conditions).  Returns a list of per-pair
    ``(path (L, 2) int32, live_ptr, ref_ptr, stopped)`` tuples, each equal
    to the pair's own set_live."""
    require_kernel_platform(interpret)
    cfg = online_config(params, **cfg_kw)
    lens, ref_arr, cols, state = batched_set_live_arrays(refs, lives, cfg)
    hist, vec, sc, path, _ = band_insert_block(
        lens, ref_arr, cols, *state, cfg=cfg, interpret=interpret)
    sc, path = jax.device_get((sc, path))
    return set_live_results(sc, path, lens)

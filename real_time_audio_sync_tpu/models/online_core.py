"""Shared core of the three online score followers.

One fixed-shape, jitted step function drives all three reference engines —
OnlineTimeWarping (otw_eran.py), LiveNote (livenote.py) and LiveNoteV2
(livenote_v2.py) — which implement the same Dixon-2005 recurrence and differ
only in documented details (SURVEY.md §7 hard part 2):

============== ============ ============= =====================
engine         sentinel     run_count₀    path append guard
============== ============ ============= =====================
OTW            1e10         1             none
LiveNote       inf          0             none
LiveNoteV2     inf          0             monotone (x↑, y≥)
============== ============ ============= =====================

LiveNoteV2 additionally supports Euclidean cost on chroma-diff features
(livenote_v2.py:167-170).

Device redesign of the data-dependent control flow (otw_eran.py:64-85): per
insert, exactly one row band is evaluated, then the row/column state machine
runs for at most ``max_run_count + 3`` iterations (the slope constraint
forces direction away from Column once run_count saturates), so the
while-loop unrolls into a static, predicated sequence — no per-frame Python
control flow, every shape static, the whole insert is one XLA program.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from real_time_audio_sync_tpu.config import OTWParams
from real_time_audio_sync_tpu.ops.band import _I0
from real_time_audio_sync_tpu.ops.band import (
    band_argmin,
    col_update,
    eval_cell,
    row_update,
)

# direction / previous encodings
ROW, COL, BOTH = 0, 1, 2
PREV_NONE = -1

# Per-engine config deltas (SURVEY.md §7 hard part 2) — the single source
# used by the engine subclasses, the fused backends, the follower runtime
# and the fused corpus mode.
ENGINE_OVERRIDES = {
    "otw": dict(sentinel=1e10, run_count_init=1, monotone_path=False, euclidean=False),
    "livenote": dict(sentinel=float("inf"), run_count_init=0, monotone_path=False, euclidean=False),
    "livenote_v2": dict(sentinel=float("inf"), run_count_init=0, monotone_path=True, euclidean=False),
    "livenote_v2_diff": dict(sentinel=float("inf"), run_count_init=0, monotone_path=True, euclidean=True),
}


class StatusPolling:
    """Lazy polling of the engines' int32[4] status vector
    ``[stopped | overflow<<1, path_len, last_x, last_y]`` — shared by the
    XLA and fused streaming engines.

    Two facts shape this design:

    - ``is_ready()`` is a LOCAL flag check — probing completion of any
      number of in-flight statuses is free;
    - actually *reading* a status vector — even a completed one — is a
      device→host copy that synchronizes with the stream, so reads
      (harvests) are rate-limited by ``poll_min_interval``.  Whether that
      read is cheap enough on a given device to drop the rate limit and
      the background thread is a measurement (ROADMAP S8).

    The dispatcher appends every status to an in-flight deque via
    :meth:`_swap_status`; free front-probes retire completed entries
    (execution is in-order, so a ready entry implies everything before it is
    done), keeping only the NEWEST completed-but-unread status — the vector
    is cumulative, older ones are subsumed.  A rate-limited harvest then
    reads that newest completed vector, so under sustained dispatch
    ``last_point``/"stop" lag by at most ``poll_min_interval`` seconds plus
    the device backlog, and at real-time pacing (device idle between hops,
    default interval = one hop) by at most ONE hop.

    Staleness accounting: each dispatch records the cumulative frame count;
    each harvest records how many frames were dispatched beyond the
    harvested status (``staleness_log``, in frames) — the exact score-
    position lag a UI built on ``last_point`` inherits.

    Caveat: ``is_ready`` flags resolve asynchronously (a
    status can briefly report not-ready after its sibling state output is
    known complete), so a probe may undercount completions — harmless by
    design, a later probe or a blocking ``flush`` picks it up."""

    #: default harvest interval: one feature hop (chroma.py:20-22) — bounds
    #: position staleness to ≤1 hop at real-time pacing while costing at
    #: most one status read per 92.9 ms hop
    POLL_INTERVAL_HOP = 2048 / 22050.0

    def _init_status_polling(self) -> None:
        self._outstanding = []  # [(frames_dispatched_after, status), ...]
        self._latest_done = None  # newest completed-but-unread entry
        self._frames_dispatched = 0
        self._stopped_cached = False
        self._last_point = None  # (path_len, x, y) from the last status read
        self._last_point_frames = 0  # frames covered by that read
        self.poll_min_interval = self.POLL_INTERVAL_HOP
        self._last_poll_time = 0.0
        self.staleness_log = []  # frames-behind at each harvest (diagnostics)
        #: run the blocking status READ on a background thread so the
        #: audio/dispatch loop never stalls on it.  Only the np.asarray
        #: read runs off-thread; all bookkeeping stays on the caller thread
        #: via a single-slot hand-off (the future), so no locks are needed.
        self.async_harvest = True
        self._harvest_future = None
        self._harvest_pool = None
        # claim guard for draining the single-slot future: dispatching stays
        # single-threaded, but last_point is documented for UI-thread polling
        # and both paths drain — without the claim, two threads passing the
        # done() check would .result() the same future (one sees None ->
        # AttributeError) or double-consume one vector
        import threading

        self._drain_lock = threading.Lock()

    def _claim_harvest_future(self, done_only: bool = True):
        """Atomically take the in-flight future if present (and, by default,
        completed); returns it or None if another thread claimed it first."""
        fut = self._harvest_future
        if fut is None or (done_only and not fut.done()):
            return None
        with self._drain_lock:
            if self._harvest_future is not fut:
                return None  # another thread claimed it
            self._harvest_future = None
        return fut

    def _drain_harvest(self):
        """Consume a background read that has completed (caller thread)."""
        fut = self._claim_harvest_future()
        if fut is None:
            return None
        frames, vec = fut.result()
        return self._consume_status(vec, frames)

    # -- free local probes ---------------------------------------------------

    def _probe(self) -> None:
        """Retire completed in-flight statuses (front-scan, local flag
        checks only).  Keeps the newest completed one for a later harvest."""
        q = self._outstanding
        while q and q[0][1].is_ready():
            self._latest_done = q.pop(0)

    def in_flight(self) -> int:
        """Number of dispatched-but-unfinished inserts (free local probes;
        conservative — flag resolution can briefly lag true completion)."""
        self._probe()
        return len(self._outstanding)

    # -- dispatch-side hook --------------------------------------------------

    def _swap_status(self, new, n_frames: int = 1) -> None:
        """Record a dispatch's status vector (``n_frames`` frames covered),
        retire completed predecessors, and harvest the newest completed
        vector if the rate limit allows."""
        self._frames_dispatched += n_frames
        if self._stopped_cached:
            return
        self._outstanding.append((self._frames_dispatched, new))
        result = self._drain_harvest()
        if result == "stop":
            return
        self._probe()
        if self._latest_done is not None and (
            not self.async_harvest or self._harvest_future is None
        ):
            now = time.monotonic()
            if now - self._last_poll_time >= self.poll_min_interval:
                self._last_poll_time = now
                self._harvest()

    # -- reads (device→host copies, rate-limited) ----------------------------

    def _harvest(self):
        if not self.async_harvest:
            entry, self._latest_done = self._latest_done, None
            if entry is None:
                return None
            frames, status = entry
            return self._consume_status(np.asarray(status), frames)
        # Pop-and-submit atomically.  If a read is already in flight, KEEP
        # the entry — it stays the newest completed vector and is harvested
        # after the in-flight read drains (or consumed directly by a
        # blocking poll).  Popping it while a read is in flight would lose
        # the FINAL status irrecoverably when no further dispatch arrives:
        # stop detection and last_point would never surface, even through
        # flush().  The lock also stops two racing pollers from
        # double-popping (the loser would submit None).
        with self._drain_lock:
            if self._harvest_future is not None or self._latest_done is None:
                return None
            frames, status = self._latest_done
            self._latest_done = None
            # hand the blocking RPC to the worker; consumed by a later
            # _drain_harvest on the caller thread
            if self._harvest_pool is None:
                import concurrent.futures

                self._harvest_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="rtas-harvest"
                )
            self._harvest_future = self._harvest_pool.submit(
                lambda f=frames, s=status: (f, np.asarray(s))
            )
        return None

    def poll(self, block: bool = False):
        """Check the newest completed status; returns ``"stop"`` or None.

        ``block=True`` waits for ALL in-flight inserts (one blocking read of
        the newest status)."""
        if self._stopped_cached:
            return "stop"
        if block:
            fut = self._claim_harvest_future(done_only=False)
            if fut is not None:  # settle the worker first
                frames, vec = fut.result()
                if self._consume_status(vec, frames) == "stop":
                    return "stop"
            if self._outstanding:
                frames, status = self._outstanding[-1]
                self._outstanding = []
                self._latest_done = None
                return self._consume_status(np.asarray(status), frames)
            if self._latest_done is not None:
                frames, status = self._latest_done
                self._latest_done = None
                return self._consume_status(np.asarray(status), frames)
            return None
        result = self._drain_harvest()
        if result == "stop":
            return "stop"
        self._probe()
        if self._latest_done is None:
            return None
        if self.async_harvest and self._harvest_future is not None:
            return None  # read in flight; the entry is kept for the next poll
        now = time.monotonic()
        if now - self._last_poll_time < self.poll_min_interval:
            return None
        self._last_poll_time = now
        return self._harvest()

    def flush(self):
        """Wait for all in-flight inserts; returns ``"stop"`` or None."""
        return self.poll(block=True)

    #: message raised on the status overflow flag (engines override)
    _overflow_msg = "column-phase loop bound violated"

    def _consume_status(self, vec, frames: Optional[int] = None):
        if frames is None:  # synchronous read: covers everything dispatched
            frames = self._frames_dispatched
        if frames < self._last_point_frames:
            # stale vector ordered behind a newer harvest (possible only
            # with concurrent pollers interleaving _probe): the newer
            # cumulative vector subsumes it — consuming it would move
            # last_point BACKWARDS and corrupt the staleness accounting
            return "stop" if self._stopped_cached else None
        self.staleness_log.append(self._frames_dispatched - frames)
        self._last_point_frames = frames
        vec = np.asarray(vec).reshape(-1)  # the fused engine's (1, 8) row
        flags = int(vec[0])
        self._last_point = (int(vec[1]), int(vec[2]), int(vec[3]))
        if flags & 2:  # pragma: no cover - design invariant
            raise AssertionError(self._overflow_msg)
        if flags & 1:
            self._stopped_cached = True
            # post-stop state is frozen; drop older in-flight vectors and
            # any background read still in flight
            self._outstanding = []
            self._latest_done = None
            self._harvest_future = None
            return "stop"
        return None

    @property
    def last_point(self):
        """(path_len, live, ref) from the most recent status read — the
        current score position (== path[-1]) without fetching the path.
        Consumes a completed background read first, so a UI polling this
        property sees the freshest harvested position (typically ≤1 hop
        behind at real-time pacing)."""
        self._drain_harvest()
        return self._last_point

    @property
    def last_point_age_frames(self) -> int:
        """How many frames have been dispatched beyond the state
        ``last_point`` reflects — the current score-position staleness."""
        self._drain_harvest()
        return self._frames_dispatched - self._last_point_frames


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Static (compile-time) engine configuration."""

    c: int
    max_run_count: int
    sentinel: float  # uncomputed-cell value: 1e10 (OTW) or inf (LiveNote*)
    run_count_init: int  # 1 (OTW) or 0 (LiveNote*)
    monotone_path: bool  # LiveNoteV2 guard (livenote_v2.py:197-199)
    euclidean: bool  # LiveNoteV2 chroma-diff cost
    exact_chain: bool = False  # bit-exact sequential band chain (parity mode)

    @property
    def loop_iters(self) -> int:
        # Consecutive Column directions are bounded by max_run_count before
        # the slope constraint forces a Row (otw_eran.py:168-170); +3 margin.
        # State.overflow would flag any violation.
        return self.max_run_count + 3


class OnlineState(NamedTuple):
    """Complete engine state as a pytree of fixed-shape arrays."""

    live: jnp.ndarray  # (F, M) live feature buffer, M = 2N
    acc: jnp.ndarray  # (M, N) accumulated cost
    t: jnp.ndarray  # live pointer
    j: jnp.ndarray  # ref pointer
    direction: jnp.ndarray  # ROW/COL/BOTH
    previous: jnp.ndarray  # PREV_NONE/ROW/COL
    run_count: jnp.ndarray
    path: jnp.ndarray  # (P, 2) int32, P = M + N + 8
    path_len: jnp.ndarray
    last_x: jnp.ndarray  # last appended path point (V2 monotone guard) — kept
    last_y: jnp.ndarray  # as scalars to avoid reading back from the path array
    first: jnp.ndarray  # bool: next insert is the first
    stopped: jnp.ndarray  # bool: ref sequence exhausted ("stop")
    overflow: jnp.ndarray  # bool: unrolled loop bound violated (never, by design)


def init_state(ref: jnp.ndarray, cfg: OnlineConfig, dtype) -> OnlineState:
    f, n = ref.shape
    m = 2 * n
    # the dense (2N, N) accumulator is this engine's parity-with-reference
    # artifact (otw_eran.py:23-27); past ~8 GB it cannot exist on any chip.
    # Long scores belong on the banded engines, which are path-identical.
    acc_bytes = 2 * n * n * np.dtype(dtype).itemsize
    if acc_bytes > 8 << 30:
        raise ValueError(
            f"reference of {n} frames needs a {acc_bytes / 2**30:.0f} GB dense"
            f" accumulator in the XLA engine; hour-scale references belong on"
            f" the band kernel: FusedStreamingEngine or"
            f" parallel.FusedMultiStreamFollower (O(c) state at any length),"
            f" or AsyncWTW for raw audio"
        )
    return OnlineState(
        live=jnp.zeros((f, m), dtype),
        acc=jnp.full((m, n), cfg.sentinel, dtype),
        t=jnp.int32(0),
        j=jnp.int32(0),
        direction=jnp.int32(BOTH),
        previous=jnp.int32(PREV_NONE),
        run_count=jnp.int32(cfg.run_count_init),
        path=jnp.zeros((m + n + 8, 2), jnp.int32),
        path_len=jnp.int32(0),
        last_x=jnp.int32(-1),
        last_y=jnp.int32(-1),
        first=jnp.bool_(True),
        stopped=jnp.bool_(False),
        overflow=jnp.bool_(False),
    )


def _append_point(path, path_len, last_x, last_y, x, y, monotone: bool, enable=None):
    """Append (x, y); under the V2 guard only when strictly forward in live
    and non-backward in ref (livenote_v2.py:197-199).  The last appended
    point is threaded as scalars so the guard never reads the path array."""
    if monotone:
        ok = (path_len == 0) | ((x > last_x) & (y >= last_y))
    else:
        ok = jnp.bool_(True)
    if enable is not None:
        ok = ok & enable
    new_path = lax.dynamic_update_slice(path, jnp.stack([x, y])[None, :], (path_len, _I0))
    path = jnp.where(ok, new_path, path)
    last_x = jnp.where(ok, x, last_x)
    last_y = jnp.where(ok, y, last_y)
    return path, path_len + ok.astype(jnp.int32), last_x, last_y


def _set_direction(acc, t, j, run_count, previous, path, path_len, last_x, last_y, cfg: OnlineConfig, enable=None, old_direction=None):
    """otw_eran.py:153-188 / livenote.py:184-207 as integer arithmetic.

    Appends the best point, chooses the next direction, updates
    run_count/previous.  Returns (direction, run_count, previous, path,
    path_len, last_x, last_y).  ``enable=False`` makes the whole call a
    no-op (predication by masking — a lax.cond here would force XLA to copy
    the dense acc buffer every step).
    """
    x, y = band_argmin(acc, t, j, c=cfg.c)
    path, path_len, last_x, last_y = _append_point(
        path, path_len, last_x, last_y, x, y, cfg.monotone_path, enable=enable
    )

    startup = t < cfg.c
    forced = run_count >= cfg.max_run_count
    forced_dir = jnp.where(previous == ROW, COL, ROW)
    free_dir = jnp.where(x < t, COL, jnp.where(y < j, ROW, BOTH))
    d = jnp.where(startup, BOTH, jnp.where(forced, forced_dir, free_dir)).astype(jnp.int32)

    rc_new = jnp.where(d == previous, run_count + 1, 1).astype(jnp.int32)
    prev_new = jnp.where(d != BOTH, d, previous).astype(jnp.int32)
    if enable is not None:
        d = jnp.where(enable, d, old_direction).astype(jnp.int32)
        rc_new = jnp.where(enable, rc_new, run_count).astype(jnp.int32)
        prev_new = jnp.where(enable, prev_new, previous).astype(jnp.int32)
    return d, rc_new, prev_new, path, path_len, last_x, last_y


def _column_phase(state: OnlineState, ref, cfg: OnlineConfig, ref_len=None, active_init=None, unroll: bool = False) -> OnlineState:
    """The reference's inner while-loop (otw_eran.py:64-85) as a bounded
    loop: the slope constraint caps consecutive Column directions at
    max_run_count, so the loop terminates within ``loop_iters`` iterations by
    construction (an explicit counter enforces the bound and flags
    ``overflow`` if ever hit).

    ``unroll=False``: a ``lax.while_loop`` — one body instance, small
    program, and early exit saves device work per step.  Used by the block/
    scan modes where the body runs thousands of times per dispatch.

    ``unroll=True``: ``loop_iters`` statically inlined, masked copies — no
    while_loop in the program.  Used by the per-frame ``insert_step``: a
    while_loop's predicate is read back each iteration on some backends,
    which a one-frame program cannot amortize (masked no-op iterations are
    equivalent to the while_loop's early exit, so results are identical —
    covered by the parity tests)."""
    n = jnp.int32(ref.shape[1]) if ref_len is None else ref_len

    def iteration(st: OnlineState, active):
        do_col = active & (st.direction != ROW)
        j_new = jnp.where(do_col, st.j + 1, st.j)
        new_stop = do_col & (j_new >= n)
        do_eval = do_col & ~new_stop

        acc = col_update(
            st.acc, st.live, ref, st.t, j_new,
            c=cfg.c, sentinel=cfg.sentinel, euclidean=cfg.euclidean,
            exact=cfg.exact_chain, enable=do_eval,
        )
        stopped = st.stopped | new_stop

        do_dir = active & ~new_stop
        d, rc, prev, path, plen, lx, ly = _set_direction(
            acc, st.t, j_new, st.run_count, st.previous, st.path, st.path_len,
            st.last_x, st.last_y, cfg, enable=do_dir, old_direction=st.direction,
        )
        st = st._replace(
            acc=acc, j=j_new, direction=d, run_count=rc, previous=prev,
            path=path, path_len=plen, last_x=lx, last_y=ly, stopped=stopped,
        )
        return st, do_dir & (d == COL)

    def loop_cond(carry):
        st, active, iters = carry
        return active & (iters < cfg.loop_iters)

    def loop_body(carry):
        st, active, iters = carry
        st, active = iteration(st, active)
        return st, active, iters + 1

    active0 = ~state.stopped if active_init is None else active_init
    if unroll:
        active = active0
        for _ in range(cfg.loop_iters):
            state, active = iteration(state, active)
    else:
        state, active, _ = lax.while_loop(
            loop_cond, loop_body, (state, active0, jnp.int32(0))
        )
    return state._replace(overflow=state.overflow | active)


def _insert_body(state: OnlineState, col, ref, cfg: OnlineConfig, ref_len=None, live_cap=None, unroll: bool = False) -> OnlineState:
    """One streaming insert (otw_eran.py:38-85 / livenote.py:37-98).

    ``ref_len``/``live_cap`` override the shape-derived sequence bounds for
    zero-padded batched serving (parallel/serving.py).

    All effects are predicated by masking rather than lax.cond — a cond
    carrying the dense acc matrix makes XLA copy the whole buffer per call,
    which dominates block/batched streaming.  After "stop" every effect is
    masked off (the reference's caller must cease calling insert or it reads
    out of bounds; we freeze instead — a deliberate, graceful deviation).
    """
    f, m = state.live.shape
    cap = jnp.int32(m) if live_cap is None else live_cap
    st = state

    alive = ~st.stopped
    is_first = alive & st.first
    is_normal = alive & ~st.first

    # --- first insert: fill live[:, 0], evaluate the origin cell
    old_col0 = lax.dynamic_slice(st.live, (_I0, _I0), (f, 1))
    live = lax.dynamic_update_slice(
        st.live, jnp.where(is_first, col[:, None], old_col0), (_I0, _I0)
    )
    if cfg.euclidean:
        d0 = live[:, 0] - ref[:, 0]
        c00 = jnp.sqrt(jnp.sum(d0 * d0))
    else:
        c00 = 1.0 - jnp.matmul(live[:, 0], ref[:, 0], precision=lax.Precision.HIGHEST)
    acc = st.acc.at[0, 0].set(jnp.where(is_first, c00.astype(st.acc.dtype), st.acc[0, 0]))
    st = st._replace(live=live, acc=acc, first=st.first & ~is_first)

    # --- normal insert: advance t; "ran out of room" keeps incrementing t
    # and does nothing else (otw_eran.py:50-54)
    t_new = jnp.where(is_normal, st.t + 1, st.t)
    do_row = is_normal & (t_new < cap)

    old_colt = lax.dynamic_slice(st.live, (_I0, t_new), (f, 1))
    live = lax.dynamic_update_slice(
        st.live, jnp.where(do_row, col[:, None], old_colt), (_I0, t_new)
    )
    acc = row_update(
        st.acc, live, ref, t_new, st.j, c=cfg.c, sentinel=cfg.sentinel,
        euclidean=cfg.euclidean, exact=cfg.exact_chain, enable=do_row,
    )
    st = st._replace(live=live, acc=acc, t=t_new)

    return _column_phase(st, ref, cfg, ref_len, active_init=do_row, unroll=unroll)


def _status_vec(st: OnlineState) -> jnp.ndarray:
    """Compact int32[4] status: ``[stopped | overflow<<1, path_len, last_x,
    last_y]``.  Returned as a *separate, non-donated* output of every insert
    program so the host can (a) detect "stop" and (b) report the current
    score position (== ``path[-1]``, otw_eran.py:158-160) with one tiny
    device→host read — without ever synchronizing on the donated state.
    Streaming mode reads this vector lazily instead of blocking per
    insert."""
    return jnp.stack(
        [
            st.stopped.astype(jnp.int32) | (st.overflow.astype(jnp.int32) << 1),
            st.path_len,
            st.last_x,
            st.last_y,
        ]
    )


@partial(jax.jit, static_argnames=("cfg",), donate_argnames=("state",))
def insert_step(state: OnlineState, col, ref, cfg: OnlineConfig):
    """One streaming insert; returns ``(state, status_vec)``.

    Compiled with the unrolled column phase — no while_loop in the
    program (see ``_column_phase``)."""
    st = _insert_body(state, col, ref, cfg, unroll=True)
    return st, _status_vec(st)


@partial(jax.jit, static_argnames=("cfg",), donate_argnames=("state",))
def insert_block(state: OnlineState, cols, ref, cfg: OnlineConfig):
    """Insert a block of feature columns in ONE device dispatch: a
    ``lax.scan`` of the exact single-insert body over ``cols`` (F, K).

    Semantically identical to K successive ``insert_step`` calls (inserts
    after "stop" freeze), but amortizes the per-dispatch cost over K
    frames."""

    def step(st, col):
        return _insert_body(st, col, ref, cfg), None

    state, _ = lax.scan(step, state, jnp.transpose(cols))
    return state, _status_vec(state)


def set_live_scan_body(state: OnlineState, live_full, ref, cfg: OnlineConfig, live_len=None, ref_len=None, reset: bool = False) -> OnlineState:
    """Batch alignment (otw_eran.py:91-142 / livenote.py:102-149) as one
    ``lax.scan`` — the whole alignment runs on-device in a single dispatch.

    Each scan step is one iteration of the reference's set_live loop:
    direction decision first (appending a path point), then predicated row
    and/or column band updates.  Loop count is bounded by T_live + N since
    every live iteration advances t and/or j.

    ``reset=True`` replays OnlineTimeWarping.set_live's state reset
    (otw_eran.py:92-97): pointers, direction state and path restart, while
    the dense cost matrices and live buffer keep their streamed contents —
    exactly the reference's behaviour when set_live follows inserts.
    LiveNote's set_live (livenote.py:102) does NOT reset and continues from
    the current ``(t, j)`` frontier, which the generic prologue below covers.
    """
    f, m = state.live.shape
    # true sequence lengths may be traced (padded batch mode); they default
    # to the array shapes
    n = jnp.int32(ref.shape[1]) if ref_len is None else ref_len
    t_live = jnp.int32(live_full.shape[1]) if live_len is None else live_len

    if reset:
        state = state._replace(
            t=jnp.int32(0),
            j=jnp.int32(0),
            direction=jnp.int32(BOTH),
            previous=jnp.int32(PREV_NONE),
            run_count=jnp.int32(cfg.run_count_init),
            path_len=jnp.int32(0),
            last_x=jnp.int32(-1),
            last_y=jnp.int32(-1),
            stopped=jnp.bool_(False),
        )

    # prologue: fill_input + eval_path_cost(t, j) (otw_eran.py:99-100,
    # livenote.py:103-108) — the origin cell on a fresh state, the current
    # frontier cell when continuing after streaming inserts
    new_col = lax.dynamic_slice(live_full, (_I0, state.t), (f, 1))
    live0 = lax.dynamic_update_slice(state.live, new_col, (_I0, state.t))
    acc0 = eval_cell(state.acc, live0, ref, state.t, state.j, euclidean=cfg.euclidean)
    state = state._replace(live=live0, acc=acc0, first=jnp.bool_(False))

    def step(s: OnlineState, _):
        # everything is predicated by masking, never by lax.cond: conds that
        # carry the dense acc matrix make XLA copy the whole buffer per step
        live_on = ~s.stopped

        d, rc, prev, path, plen, lx, ly = _set_direction(
            s.acc, s.t, s.j, s.run_count, s.previous, s.path, s.path_len,
            s.last_x, s.last_y, cfg, enable=live_on, old_direction=s.direction,
        )
        s = s._replace(
            direction=d, run_count=rc, previous=prev, path=path,
            path_len=plen, last_x=lx, last_y=ly,
        )

        # row step
        do_row = live_on & (d != COL)
        t_new = jnp.where(do_row, s.t + 1, s.t)
        row_done = do_row & ((t_new >= t_live) | (t_new >= m))
        do_row_eval = do_row & ~row_done

        new_col = lax.dynamic_slice(live_full, (_I0, t_new), (f, 1))
        old_col = lax.dynamic_slice(s.live, (_I0, t_new), (f, 1))
        live = lax.dynamic_update_slice(
            s.live, jnp.where(do_row_eval, new_col, old_col), (_I0, t_new)
        )
        acc = row_update(
            s.acc, live, ref, t_new, s.j, c=cfg.c, sentinel=cfg.sentinel,
            euclidean=cfg.euclidean, exact=cfg.exact_chain, enable=do_row_eval,
        )
        s = s._replace(live=live, acc=acc, t=t_new, stopped=s.stopped | row_done)

        # column step (skipped if the row step broke out)
        do_col = live_on & (d != ROW) & ~s.stopped
        j_new = jnp.where(do_col, s.j + 1, s.j)
        col_done = do_col & (j_new >= n)
        acc = col_update(
            s.acc, s.live, ref, s.t, j_new, c=cfg.c, sentinel=cfg.sentinel,
            euclidean=cfg.euclidean, exact=cfg.exact_chain, enable=do_col & ~col_done,
        )
        return s._replace(acc=acc, j=j_new, stopped=s.stopped | col_done), None

    state, _ = lax.scan(step, state, None, length=live_full.shape[1] + ref.shape[1])
    return state


set_live_scan = partial(
    jax.jit, static_argnames=("cfg", "reset"), donate_argnames=("state",)
)(set_live_scan_body)


# ---------------------------------------------------------------------------
# Host-facing engine
# ---------------------------------------------------------------------------


class BandedOnlineEngine(StatusPolling):
    """Host wrapper: owns the device state, streams frames through the jitted
    step, exposes the reference attribute surface (.path, .acc_cost, ...)."""

    def __init__(self, ref, params, cfg_overrides: dict, dtype=None, exact_chain=False, reset_on_set_live=False):
        p = OTWParams.from_any(params)
        # OnlineTimeWarping.set_live resets pointers/direction/path
        # (otw_eran.py:92-97); LiveNote's continues from the current state
        # (livenote.py:102-108)
        self.reset_on_set_live = bool(reset_on_set_live)
        dtype = np.dtype(dtype or np.float32)
        self.dtype = dtype
        self.params = p
        self.cfg = OnlineConfig(
            c=p.c,
            max_run_count=p.max_run_count,
            exact_chain=bool(exact_chain),
            **cfg_overrides,
        )
        ref = np.asarray(ref)
        if ref.shape[1] < self.cfg.c:
            raise ValueError(
                f"reference length {ref.shape[1]} shorter than search band {self.cfg.c}"
            )
        self.ref = jax.device_put(jnp.asarray(ref, dtype))
        self.state = init_state(self.ref, self.cfg, dtype)
        self._batch_mode = False
        # pipelined-streaming bookkeeping ("stop" is sticky, so only the
        # newest status vector matters) — see StatusPolling
        self._init_status_polling()

    # -- reference API surface ---------------------------------------------

    def insert(self, live_col):
        """Insert one feature column; returns ``"stop"`` when the reference
        sequence is exhausted (otw_eran.py:69-71), else None.

        This is the synchronous form: it reads the status vector back every
        call.  For sustained real-time streaming use :meth:`insert_nowait` +
        :meth:`poll`.
        """
        # Pass host data straight into the jitted call (jit's own argument
        # transfer, no separate device_put dispatch).
        col = np.ascontiguousarray(live_col, self.dtype)
        self.state, status = insert_step(self.state, col, self.ref, self.cfg)
        return self._read_status(status, 1)

    def insert_block(self, cols):
        """Insert K feature columns (F, K) in one device dispatch —
        semantically identical to K ``insert`` calls; returns ``"stop"`` if
        the reference sequence was exhausted anywhere in the block."""
        k = np.asarray(cols).shape[1]
        self.state, status = self._dispatch_block(cols)
        return self._read_status(status, k)

    # -- pipelined streaming (dispatch without synchronizing) ----------------

    def insert_nowait(self, live_col):
        """Dispatch one insert WITHOUT waiting for the device.

        JAX dispatch is asynchronous, so the host can run many frames ahead
        of the device; the per-call cost is the dispatch itself.  "stop"
        is detected lazily — this returns ``"stop"`` as soon as a previously
        *polled* status showed it, which may be a few frames after the exact
        insert that exhausted the reference.  Because post-stop inserts are
        frozen no-ops (see ``_insert_body``), the committed path is identical
        to the synchronous form's; only the return-value timing differs
        (documented deviation, docs/PARITY.md).
        """
        # harvest the previous status first if it completed by now
        if self._stopped_cached or self.poll() == "stop":
            return "stop"
        col = np.ascontiguousarray(live_col, self.dtype)
        self.state, status = insert_step(self.state, col, self.ref, self.cfg)
        self._swap_status(status, 1)
        return None

    def insert_block_nowait(self, cols):
        """Dispatch a (F, K) block without waiting; see :meth:`insert_nowait`."""
        if self._stopped_cached or self.poll() == "stop":
            return "stop"
        k = np.asarray(cols).shape[1]
        self.state, status = self._dispatch_block(cols)
        self._swap_status(status, k)
        return None

    def _dispatch_block(self, cols):
        cols = np.ascontiguousarray(cols, self.dtype)
        if cols.ndim != 2:
            raise ValueError("insert_block expects a (F, K) column block")
        return insert_block(self.state, cols, self.ref, self.cfg)

    def _read_status(self, status, n_frames: int):
        self._frames_dispatched += n_frames
        # This synchronous read covers everything dispatched so far: drop
        # older in-flight/backgrounded vectors, else a later rate-limited
        # harvest of one of them would regress last_point backwards.
        self._outstanding = []
        self._latest_done = None
        self._harvest_future = None
        return self._consume_status(np.asarray(status))

    def set_live(self, live):
        """Batch mode: align a full live sequence in one device dispatch.

        For OnlineTimeWarping this replays the reference's state reset
        (otw_eran.py:92-97) so set_live after streaming inserts restarts the
        alignment; LiveNote/V2 continue from the current frontier
        (livenote.py:102-108)."""
        live = np.ascontiguousarray(live, self.dtype)
        self.state = set_live_scan(
            self.state, live, self.ref, self.cfg, reset=self.reset_on_set_live
        )
        stopped = self._stopped_cached and not self.reset_on_set_live
        interval = self.poll_min_interval
        self._init_status_polling()
        self.poll_min_interval = interval
        self._stopped_cached = stopped
        self._batch_mode = True
        return self.path

    @property
    def path(self):
        """Committed best-point path as a list of (live, ref) int tuples."""
        return [tuple(p) for p in self.path_array]

    @property
    def path_array(self):
        # one batched device→host fetch of path and path_len
        pts, n = jax.device_get((self.state.path, self.state.path_len))
        return pts[: int(n)]

    @property
    def acc_cost(self):
        """Dense accumulated-cost matrix (uncomputed cells = sentinel), for
        notebook heatmaps and debugging."""
        return np.asarray(self.state.acc)

    @property
    def live_ptr(self):
        return int(self.state.t)

    @property
    def ref_ptr(self):
        return int(self.state.j)

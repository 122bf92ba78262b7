"""Multi-stream streaming service: follow B concurrent live performances on
one chip.

The reference follows exactly one performance per process.  On the device
the banded insert step is a fixed-shape program, so B independent followers
(possibly against different reference recordings, zero-padded to a common
length) batch into ONE vmapped dispatch per frame-step — per-dispatch
overhead and device occupancy amortize across streams, which is what makes
large-scale serving viable (bench: aggregate throughput scales near-linearly
in B).

Per-frame DP recurrences stay stream-local; there is no cross-stream
communication (SURVEY.md §5.8).  Pass ``mesh=corpus_mesh(...)`` to shard the
stream batch over multiple chips: every pytree leaf carries the batch axis,
so partitioning along it needs zero collectives — B/n_chips streams per chip,
one SPMD dispatch per step.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from real_time_audio_sync_tpu.config import OTWParams
from real_time_audio_sync_tpu.parallel.polling import BatchedStatusPolling
from real_time_audio_sync_tpu.models.online_core import (
    OnlineConfig,
    _insert_body,
    init_state,
)


def batch_axis_sharding_put(mesh: Mesh):
    """``device_put`` along ALL mesh axes over the leading (batch) dim — a
    partial spec would silently replicate across the remaining axes of a
    multi-axis mesh.  Accepts numpy arrays directly (no default-device
    materialization)."""
    axes = tuple(mesh.axis_names)
    return lambda x: jax.device_put(
        x, NamedSharding(mesh, P(axes, *(None,) * (np.ndim(x) - 1)))
    )


def require_batch_divisible(mesh: Mesh, b: int) -> None:
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if b % n_dev:
        raise ValueError(
            f"stream count {b} must be divisible by the mesh's {n_dev} "
            f"devices (pad with inactive dummy streams)"
        )


@partial(jax.jit, static_argnames=("cfg",), donate_argnames=("states",))
def _batched_insert(states, cols, refs, ref_lens, active, cfg: OnlineConfig):
    """One vmapped insert step; ``active=False`` streams are frozen; stop
    conditions use each stream's TRUE reference length."""

    def one(state, col, ref, ref_len, act):
        new = _insert_body(state, col, ref, cfg, ref_len=ref_len, live_cap=2 * ref_len)
        return jax.tree.map(lambda n, o: jnp.where(act, n, o), new, state)

    return jax.vmap(one)(states, cols, refs, ref_lens, active)


class MultiStreamFollower:
    """Follows ``B`` live streams concurrently with one device dispatch per
    step.  API: :meth:`insert` takes one chroma column per stream (use NaNs
    or the ``active`` mask for streams with no new frame this step)."""

    def __init__(self, refs: Sequence[np.ndarray], params, dtype=np.float32,
                 sentinel: float = 1e10, run_count_init: int = 1,
                 monotone_path: bool = False, euclidean: bool = False,
                 mesh: Optional[Mesh] = None):
        p = OTWParams.from_any(params)
        self.cfg = OnlineConfig(
            c=p.c,
            max_run_count=p.max_run_count,
            sentinel=sentinel,
            run_count_init=run_count_init,
            monotone_path=monotone_path,
            euclidean=euclidean,
        )
        self.dtype = np.dtype(dtype)
        refs = [np.asarray(r, self.dtype) for r in refs]
        self.b = len(refs)
        f = refs[0].shape[0]
        n_max = max(r.shape[1] for r in refs)
        if min(r.shape[1] for r in refs) < self.cfg.c:
            raise ValueError("every reference must be at least one band wide")
        # zero-pad refs to a common length; each stream's TRUE length drives
        # its stop conditions inside the step
        self.ref_lens = np.asarray([r.shape[1] for r in refs], np.int32)
        refs_padded = np.zeros((self.b, f, n_max), self.dtype)
        for i, r in enumerate(refs):
            refs_padded[i, :, : r.shape[1]] = r
        # multi-chip: shard the stream batch axis over the mesh — per-stream
        # DP state is chip-local, so the partitioned step needs no
        # collectives (SURVEY.md §5.8)
        self.mesh = mesh
        if mesh is not None:
            require_batch_divisible(mesh, self.b)
            self._put = batch_axis_sharding_put(mesh)
        else:
            # single device: pass host arrays straight into the jitted call
            # (jit's own argument transfer, no separate device_put dispatch)
            self._put = lambda x: x

        if mesh is None:
            self.refs = jax.device_put(jnp.asarray(refs_padded))
            self._ref_lens_dev = jax.device_put(jnp.asarray(self.ref_lens))
        else:
            self.refs = self._put(refs_padded)
            self._ref_lens_dev = self._put(self.ref_lens)

        one = init_state(jnp.zeros((f, n_max), self.dtype), self.cfg, self.dtype)
        states = jax.tree.map(lambda x: np.broadcast_to(np.asarray(x), (self.b,) + x.shape).copy(), one)
        self.states = jax.tree.map(self._put if mesh is not None else jax.device_put, states)

    def insert(self, cols: np.ndarray, active: Optional[np.ndarray] = None) -> np.ndarray:
        """Insert one column per stream (B, F).  Returns the per-stream
        stopped flags (a stream stops when its true reference is exhausted)."""
        cols = np.ascontiguousarray(cols, self.dtype)
        if cols.shape[0] != self.b:
            raise ValueError(f"expected {self.b} stream columns, got {cols.shape[0]}")
        if active is None:
            active = np.ones(self.b, bool)
        act = np.asarray(active, bool) & ~self.stopped
        self.states = _batched_insert(
            self.states, self._put(cols), self.refs, self._ref_lens_dev,
            self._put(act), self.cfg,
        )
        return self.stopped

    @property
    def stopped(self) -> np.ndarray:
        return np.asarray(self.states.stopped)

    def paths(self) -> List[np.ndarray]:
        lens = np.asarray(self.states.path_len)
        path = np.asarray(self.states.path)
        return [path[i, : lens[i]] for i in range(self.b)]

    def pointers(self) -> Tuple[np.ndarray, np.ndarray]:
        return np.asarray(self.states.t), np.asarray(self.states.j)


# ---------------------------------------------------------------------------
# Fused multi-stream serving: the band kernel, O(c) state per stream
# ---------------------------------------------------------------------------


class FusedMultiStreamFollower(BatchedStatusPolling):
    """Follow ``B`` live performances with the band kernel — ONE launch per
    hop block for the whole batch, one program per stream, O(c) band state
    per stream instead of the XLA engine's dense (2N, N) acc matrix
    (otw_eran.py:23-27; SURVEY.md §7 hard part 5).  The reference stays in
    device memory and each program reads its band by index, so per-stream
    state and per-launch work are flat in the reference length.

    ``ref``: one shared reference (np.ndarray (F, N)) followed by all
    ``n_streams`` streams — the common one-concert-many-listeners case, ref
    storage and H2D stay flat in B — or a sequence of per-stream references
    (zero-padded to a common length; true lengths drive per-stream stops).

    API: :meth:`feed` takes one chroma column per stream (``active`` masks
    streams with no new frame) with the same adaptive dispatch coalescing as
    the solo engine's feed (models/fused_streaming.py): frames dispatch
    immediately while the pipeline has room (free ``is_ready`` probes) and
    coalesce into up-to-``k_block`` launches only under saturation — never
    waiting for audio that has not arrived.  Committed paths are bit-equal
    to solo ``FusedStreamingEngine`` streams (tested).

    Pass ``mesh=`` to shard the stream axis over devices via ``shard_map``
    (each device runs B/n_devices programs; per-stream DP state is
    device-local, zero collectives — SURVEY.md §5.8).
    """

    def __init__(self, ref, params, n_streams: Optional[int] = None,
                 cfg_overrides: Optional[dict] = None, k_block: int = 8,
                 interpret: bool = False, mesh: Optional[Mesh] = None,
                 max_in_flight: int = 4):
        from real_time_audio_sync_tpu.models.online_core import ENGINE_OVERRIDES
        from real_time_audio_sync_tpu.ops import require_kernel_platform
        from real_time_audio_sync_tpu.ops.pallas_otw import (
            S_PLEN,
            feature_width,
            init_state,
            pad_ref,
            path_capacity,
            ref_rows,
        )

        require_kernel_platform(interpret)
        p = OTWParams.from_any(params)
        over = dict(ENGINE_OVERRIDES["otw"])
        over.update(cfg_overrides or {})
        self.cfg = OnlineConfig(c=p.c, max_run_count=p.max_run_count, **over)
        self.k_block = int(k_block)
        self.interpret = bool(interpret)
        self.max_in_flight = int(max_in_flight)

        self.shared_ref = isinstance(ref, np.ndarray) and np.asarray(ref).ndim == 2
        if self.shared_ref:
            if n_streams is None:
                raise ValueError("n_streams is required with a shared reference")
            refs = [np.asarray(ref, np.float32)]
            self.b = int(n_streams)
            self.ref_lens = np.full(self.b, refs[0].shape[1], np.int32)
        else:
            refs = [np.asarray(r, np.float32) for r in ref]
            self.b = len(refs)
            self.ref_lens = np.asarray([r.shape[1] for r in refs], np.int32)
        if n_streams is not None and n_streams != self.b:
            if not self.shared_ref:
                raise ValueError(f"n_streams {n_streams} != {self.b} references")
        f = refs[0].shape[0]
        n_max = max(r.shape[1] for r in refs)
        c = self.cfg.c
        if min(r.shape[1] for r in refs) < c:
            raise ValueError("every reference must be at least one band wide")
        self.f, self.n_max = f, n_max
        self.caps = 2 * self.ref_lens  # per-stream live capacity (otw_eran.py:14)
        self._f_pad = feature_width(f)
        self._s_plen = S_PLEN

        rows = ref_rows(c, n_max)
        ref_t = np.zeros((len(refs), rows, self._f_pad), np.float32)
        for i, r in enumerate(refs):
            padded = pad_ref(r, c)
            ref_t[i, : padded.shape[0]] = padded
        state = init_state(self.cfg, self.b, f, path_capacity(n_max, 2 * n_max))

        self.mesh = mesh
        if mesh is not None:
            require_batch_divisible(mesh, self.b)
            put = batch_axis_sharding_put(mesh)
            rep = lambda x: jax.device_put(
                x, NamedSharding(mesh, P(*(None,) * np.ndim(x))))
        else:
            put = rep = jax.device_put
        self._ref_dev = rep(ref_t) if self.shared_ref else put(ref_t)
        self._state = tuple(put(x) for x in state)
        self._put = put
        self._step = self._build_step()

        # columnar pending queue: per-stream Python lists cost ~20 us per
        # frame per stream in append/stack machinery at serving batch sizes;
        # one (B, cap, F) buffer with per-stream counts makes feed ingest and
        # block building single vectorized ops.  Capacity invariant: _drain
        # dispatches whenever any stream holds 4*k_block, and feed appends
        # one column per stream per call, so counts never exceed 4*k_block.
        self._pend_cap = 4 * self.k_block
        self._pend_buf = np.zeros((self.b, self._pend_cap, f), np.float32)
        self._pend_n = np.zeros(self.b, np.int64)
        self._stopped = np.zeros(self.b, bool)
        self._last_points = np.zeros((self.b, 3), np.int64)  # plen, x, y
        self.dispatched_block_sizes: List[int] = []
        self._init_batched_polling()

    def _build_step(self):
        from real_time_audio_sync_tpu.ops.pallas_otw import band_insert_block

        cfg, interp = self.cfg, self.interpret

        def run(lens, ref_dev, cols, *state):
            return band_insert_block(lens, ref_dev, cols, *state, cfg=cfg,
                                     interpret=interp)

        if self.mesh is None:
            return lambda lens, cols, state: run(lens, self._ref_dev, cols, *state)

        mesh = self.mesh
        batched = P(tuple(mesh.axis_names))
        ref_spec = P(*(None,) * 3) if self.shared_ref else batched
        n_state = len(self._state)
        inner = jax.jit(jax.shard_map(
            run, mesh=mesh,
            in_specs=(batched, ref_spec, batched) + (batched,) * n_state,
            out_specs=(batched,) * (n_state + 1),
            # pallas_call's out_shapes carry no varying-mesh-axes annotation;
            # every output is batch-sharded by construction
            check_vma=False,
        ), donate_argnums=tuple(range(3, 3 + n_state)))
        put = self._put
        return lambda lens, cols, state: inner(put(lens), self._ref_dev, put(cols), *state)

    # -- streaming API -------------------------------------------------------

    def feed(self, cols, active: Optional[np.ndarray] = None) -> np.ndarray:
        """Queue one chroma column per stream (B, F) and dispatch adaptively;
        returns the per-stream stopped mask as of the last completed harvest
        (lazy, like the solo engines)."""
        cols = np.asarray(cols, np.float32)
        if cols.shape != (self.b, self.f):
            raise ValueError(f"expected a ({self.b}, {self.f}) column batch")
        act = np.ones(self.b, bool) if active is None else np.asarray(active, bool)
        rows = np.nonzero(act & ~self._stopped)[0]
        if rows.size:
            # the fancy write COPIES each column into the queue buffer: a
            # caller reusing its cols buffer per hop (the natural serving
            # loop) can't mutate queued frames under saturation
            self._pend_buf[rows, self._pend_n[rows]] = cols[rows]
            self._pend_n[rows] += 1
        self._drain()
        self.poll()
        return self._stopped.copy()

    def _drain(self) -> None:
        while True:
            avail = int(self._pend_n.max()) if self.b else 0
            if avail == 0:
                return
            if self._in_flight() >= self.max_in_flight and avail < 4 * self.k_block:
                return
            self._dispatch()

    def _reset_pending(self) -> None:
        """Drop every queued column (checkpoint restore: queued feed()
        columns predate the restored state)."""
        self._pend_n[:] = 0

    def _dispatch(self) -> None:
        ks = np.minimum(self._pend_n, self.k_block).astype(np.int32)
        block = np.zeros((self.b, self.k_block, self._f_pad), np.float32)
        lens = np.zeros((self.b, 4), np.int32)
        lens[:, 0] = self.caps
        lens[:, 1] = self.ref_lens
        lens[:, 2] = ks
        k_max = int(ks.max())
        if k_max:
            # one masked copy builds every stream's columns (positions past a
            # stream's k hold stale queue rows — shipped as zeros, never read
            # past the per-stream k in-program either way)
            valid = np.arange(k_max)[None, :, None] < ks[:, None, None]
            block[:, :k_max, : self.f] = np.where(
                valid, self._pend_buf[:, :k_max], 0.0)
            # pop each stream's first k rows: vectorized forward shift
            rem = self._pend_n - ks
            rem_max = int(rem.max())
            if rem_max:
                take = np.minimum(ks[:, None] + np.arange(rem_max)[None, :],
                                  self._pend_cap - 1)
                self._pend_buf[:, :rem_max] = np.take_along_axis(
                    self._pend_buf, take[:, :, None], axis=1)
            self._pend_n = rem
        self.dispatched_block_sizes.append(k_max)
        *state, status = self._step(lens, block, self._state)
        self._state = tuple(state)
        self._outstanding.append(status)
        self.poll()

    def poll(self) -> np.ndarray:
        """Non-blocking status refresh (mirrors the solo engines'
        :meth:`StatusPolling.poll`): consume a completed background read,
        retire finished launches with free probes, and kick off a new
        rate-limited background harvest of the newest completed vector.
        Returns the per-stream stopped mask.  Called on every :meth:`feed`
        and on ``stopped``/``last_points`` access, so status progresses even
        while no new columns are being dispatched."""
        self._poll_status()
        return self._stopped.copy()

    def _consume(self, vec: np.ndarray) -> None:
        vec = vec.reshape(self.b, -1)  # (B, 8) status rows
        self._stopped |= (vec[:, 0] & 1).astype(bool)
        if (vec[:, 0] & 2).any():  # pragma: no cover - design invariant
            raise AssertionError("column-phase loop bound violated")
        # Per-row monotone guard: with concurrent pollers a background read
        # can settle AFTER a newer vector was consumed (polling.py thread
        # model).  The status rows are cumulative — (plen, live) never
        # decreases per stream — so only rows at-or-ahead of the current
        # snapshot are applied; the solo engines' stale-vector guard
        # (online_core._consume_status), row-wise.
        pts = vec[:, 1:4].astype(np.int64)
        cur = self._last_points
        newer = (pts[:, 0] > cur[:, 0]) | (
            (pts[:, 0] == cur[:, 0]) & (pts[:, 1] >= cur[:, 1]))
        self._last_points = np.where(newer[:, None], pts, cur)

    def flush(self) -> np.ndarray:
        """Dispatch all queued columns and wait for every in-flight launch;
        returns the final per-stream stopped mask."""
        while self._pend_n.any():
            self._dispatch()
        self._settle_status()
        return self._stopped.copy()

    # -- inspection ----------------------------------------------------------

    @property
    def stopped(self) -> np.ndarray:
        return self.poll()

    @property
    def last_points(self) -> np.ndarray:
        """(B, 3) [path_len, live, ref] per stream from the newest completed
        harvest — score positions without fetching paths."""
        self.poll()
        return self._last_points.copy()

    def paths(self) -> List[np.ndarray]:
        """Per-stream committed paths (synchronizing fetch)."""
        sc, path = jax.device_get((self._state[2], self._state[3]))
        return [np.stack([path[i, 0, : sc[i, self._s_plen]],
                          path[i, 1, : sc[i, self._s_plen]]], axis=1)
                for i in range(self.b)]

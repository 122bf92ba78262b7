"""Fused-kernel streaming engine: K inserts per launch of the band kernel.

The XLA streaming path (models/online_core.BandedOnlineEngine) dispatches
one program per frame/block whose steps each issue ~30 HLO ops; this engine
drives ``ops.pallas_otw.band_insert_block`` instead — K streaming inserts
per launch inside one kernel, with the engine state (band vectors, live
ring, committed path, scalar pointers) carried ACROSS launches as aliased
device buffers — nothing is rebuilt or re-transferred between hops.  The
state is O(c) per stream whatever the reference length.

API mirrors the pipelined subset of ``BandedOnlineEngine``:
``insert_block_nowait`` / ``poll`` / ``flush`` / ``.path`` / ``.last_point``,
with "stop" semantics identical to the reference (otw_eran.py:69-71; frozen
no-op inserts after stop, lazy detection via the status vector).  Committed
paths are exactly those of the XLA engine (tests/test_fused_streaming.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from real_time_audio_sync_tpu.config import OTWParams
from real_time_audio_sync_tpu.models.online_core import ENGINE_OVERRIDES, OnlineConfig, StatusPolling
from real_time_audio_sync_tpu.ops import require_kernel_platform
from real_time_audio_sync_tpu.ops.pallas_otw import (
    S_PLEN,
    band_insert_block,
    feature_width,
    init_state,
    pad_ref,
    path_capacity,
)


class FusedStreamingEngine(StatusPolling):
    """Streams chroma columns through the band kernel (one stream)."""

    dtype = np.dtype(np.float32)  # the kernel is f32-only

    def __init__(self, ref, params, cfg_overrides: Optional[dict] = None, k_block: int = 8, interpret: bool = False):
        # interpret=True: the Pallas interpreter (CPU tests); otherwise the
        # kernel compiles for the GPU and any other platform raises
        require_kernel_platform(interpret)
        self.interpret = bool(interpret)
        p = OTWParams.from_any(params)
        over = dict(ENGINE_OVERRIDES["otw"])
        over.update(cfg_overrides or {})
        self.cfg = OnlineConfig(c=p.c, max_run_count=p.max_run_count, **over)
        self.k_block = int(k_block)

        ref = np.asarray(ref, np.float32)
        f, n = ref.shape
        if n < self.cfg.c:
            raise ValueError(f"reference length {n} shorter than search band {self.cfg.c}")
        self.f, self.n = f, n
        self.cap = 2 * n  # pre-allocated live capacity (otw_eran.py:14)
        self.ref_t = jax.device_put(pad_ref(ref, self.cfg.c)[None])
        self._state = jax.device_put(
            init_state(self.cfg, 1, f, path_capacity(n, self.cap)))
        self._init_status_polling()  # shared lazy status-vector machinery
        # adaptive per-frame coalescing (see feed()): frames held only while
        # the pipeline is saturated, never waiting for future input
        self._pending: list = []
        self.max_in_flight = 4
        self.dispatched_block_sizes: list = []  # diagnostics (coalescing histogram)

    # -- pipelined streaming API (mirrors BandedOnlineEngine) ----------------

    def insert_block_nowait(self, cols):
        """Dispatch up to k_block chroma columns (F, K); returns "stop" once
        a previously polled status showed it (lazy; post-stop inserts are
        frozen no-ops in-kernel, so the committed path is unaffected)."""
        if self._stopped_cached or self.poll() == "stop":
            return "stop"
        # frames queued by feed() must dispatch FIRST — mixing the two APIs
        # under a saturated pipeline must not reorder the stream
        pend = self._pending
        while pend and not self._stopped_cached:
            k = min(len(pend), self.k_block)
            self._dispatch_cols(np.stack(pend[:k], axis=1))
            del pend[:k]
        cols = np.asarray(cols, np.float32)
        if cols.ndim == 1:
            cols = cols[:, None]
        k = cols.shape[1]
        if k > self.k_block:  # oversize blocks split into k_block launches
            for s in range(0, k, self.k_block):
                if self.insert_block_nowait(cols[:, s : s + self.k_block]) == "stop":
                    return "stop"
            return None
        self._dispatch_cols(cols)
        return None

    insert_nowait = insert_block_nowait  # a single column is a K=1 block

    def _dispatch_cols(self, cols) -> None:
        """Launch one kernel over a (F, k<=k_block) column block (padded to
        the compiled k_block shape; the kernel stops at n_valid)."""
        k = cols.shape[1]
        block = np.zeros((1, self.k_block, feature_width(self.f)), np.float32)
        block[0, :k, : self.f] = cols.T
        lens = np.asarray([[self.cap, self.n, k, 0]], np.int32)
        *state, status = band_insert_block(
            lens, self.ref_t, block, *self._state, cfg=self.cfg,
            interpret=self.interpret)
        self._state = tuple(state)
        self._swap_status(status, k)  # (1, 8): read whole, no slicing op

    # -- adaptive per-frame streaming ----------------------------------------

    def feed(self, col):
        """Insert ONE chroma column with adaptive dispatch coalescing — the
        per-frame (hop-by-hop) production entry point.

        The column is dispatched immediately whenever the dispatch pipeline
        has room (fewer than ``max_in_flight`` unfinished launches — probed
        with free local ``is_ready`` checks, never a device read), so at
        real-time pacing every frame launches the moment it arrives, exactly
        like ``insert_nowait``.  Only when the device pipeline is saturated
        do arriving frames coalesce into one multi-column launch (up to the
        compiled ``k_block``), which amortizes the per-dispatch cost across
        frames WITHOUT ever waiting for audio that has not arrived — added
        latency is bounded by the in-flight launches already executing,
        never by input buffering.

        Committed paths are identical to frame-by-frame ``insert`` (a k-
        column block is semantically k successive inserts; tested).  Returns
        ``"stop"`` lazily like :meth:`insert_block_nowait`.
        """
        if self._stopped_cached or self.poll() == "stop":
            return "stop"
        # np.array (not asarray): the column can stay QUEUED past this call
        # under saturation, so a zero-copy view of the caller's buffer would
        # be mutated before dispatch if the caller reuses it per hop
        col = np.array(col, np.float32).reshape(-1)
        self._pending.append(col)
        self._drain_pending()
        return None

    def _drain_pending(self) -> None:
        pend = self._pending
        while pend:
            # liveness safeguard: if completion flags lag (they resolve
            # asynchronously), an over-full pending queue dispatches anyway
            if self.in_flight() >= self.max_in_flight and len(pend) < 4 * self.k_block:
                break
            k = min(len(pend), self.k_block)
            self.dispatched_block_sizes.append(k)
            self._dispatch_cols(np.stack(pend[:k], axis=1))
            del pend[:k]

    def flush(self):
        """Dispatch any coalesce-pending frames, then wait for all in-flight
        launches; returns ``"stop"`` or None."""
        pend = self._pending
        while pend and not self._stopped_cached:
            k = min(len(pend), self.k_block)
            self._dispatch_cols(np.stack(pend[:k], axis=1))
            del pend[:k]
        pend.clear()  # post-stop remainder is semantically a frozen no-op
        return StatusPolling.flush(self)

    @property
    def path_array(self):
        sc, path = jax.device_get((self._state[2], self._state[3]))
        plen = int(sc[0, S_PLEN])
        return np.stack([path[0, 0, :plen], path[0, 1, :plen]], axis=1)

    @property
    def path(self):
        return [tuple(p) for p in self.path_array]

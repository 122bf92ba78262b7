"""Multi-stream WTW service: follow B concurrent raw-audio performances on
one chip (or a mesh) with one device dispatch per hop block.

The WTW counterpart of :class:`~real_time_audio_sync_tpu.parallel.serving.
MultiStreamFollower` (which serves the chroma-column online engines): each
stream is a full device-resident AsyncWTW stepper — live chromagram,
pointers, window DP, subpath commits and stop flag — and the B steppers
advance in ONE vmapped program per block, so per-dispatch overhead and
device occupancy amortize across streams.  References may differ per stream
(zero-padded to a common length; each stream's TRUE length drives its stop
margins in-program).  Reference role: B independent wtw.py:71-130 engines,
one per performance.

Per-block DP state stays stream-local — sharding the batch axis over a
``Mesh`` needs zero collectives (SURVEY.md §5.8).

Feed skew is allowed: each ``insert`` call may give different streams
different amounts of audio; a block dispatches whenever any stream has a
full ``k_block`` of hop columns, with per-stream ``n_valid`` masking (the
chroma matmul batch shape is always ``k_block``-padded, so a stream's
committed path is independent of how the other streams' audio arrives).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from real_time_audio_sync_tpu.config import WTWParams
from real_time_audio_sync_tpu.features.chroma import (
    chroma_from_samples,
    frontend_constants,
    host_chroma_frames,
)
from real_time_audio_sync_tpu.models.wtw import SampleFIFO, _check_ref_window
from real_time_audio_sync_tpu.parallel.polling import BatchedStatusPolling
from real_time_audio_sync_tpu.models.wtw_async import (
    _W_CHROMA,
    _W_LIVE,
    _W_PLEN,
    _W_REF,
    _make_multi_wtw_step,
    build_span,
)
from real_time_audio_sync_tpu.parallel.serving import (
    batch_axis_sharding_put,
    require_batch_divisible,
)
from real_time_audio_sync_tpu.parallel.transfer import resolve_transfer_mode
from real_time_audio_sync_tpu.utils.wavio import load_wav


class MultiStreamWTW(BatchedStatusPolling):
    """Follow ``B`` raw-audio streams concurrently, one dispatch per block.

    ``refs``: per-stream reference recordings (wav paths or 1-D sample
    arrays).  :meth:`insert` takes one raw-sample buffer per stream (``None``
    for streams with no new audio); :meth:`flush` drains ragged tails and
    waits.  ``paths()`` / ``pointers()`` / ``stopped`` read back per-stream
    results (synchronizing).

    Dispatch cadence is driven by the FASTEST stream: a block is dispatched
    whenever any stream has ``k_block`` columns buffered, and every other
    stream contributes whatever it has (zero-padded to ``k_block``).  With
    heavily skewed feeds a slow stream therefore rides many small dispatches
    it would not pay solo — committed paths are unaffected (feed-skew
    invariance is tested), but per-stream dispatch count, and thus dispatch
    overhead, scales with the fastest stream's cadence.  Feed streams at
    comparable rates (the serving regime) for best throughput."""

    def __init__(self, refs: Sequence, params, k_block: int = 8,
                 dtype=np.float32, mesh: Optional[Mesh] = None,
                 transfer_dtype: str = "auto",
                 ref_chromas: Optional[Sequence[np.ndarray]] = None):
        self.params = WTWParams.from_any(params)
        self.k_block = int(k_block)
        # int16 spans halve the H2D bytes that cap multi-stream aggregate
        # throughput (B x span per block); "chroma" ships host-extracted
        # 12-dim columns instead of raw samples (~96x fewer bytes — for
        # bandwidth-limited links); see
        # AsyncWTW.transfer_dtype for the exactness contracts.  "auto"
        # (default) probes link bandwidth + host-FFT throughput once per
        # process and picks per the measured crossover (parallel/transfer.py)
        if transfer_dtype not in ("auto", "float32", "int16", "chroma"):
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
        self.transfer_dtype = resolve_transfer_mode(
            transfer_dtype, len(refs), self.k_block,
            self.params.fft_len, self.params.hop_size)
        self.dtype = np.dtype(dtype)
        if self.dtype == np.float64 and not jax.config.jax_enable_x64:
            raise ValueError("dtype=float64 requires jax_enable_x64")

        self.fft_len = self.params.fft_len
        self.hop_size = self.params.hop_size
        self._w = self.params.dtw_win_size // self.hop_size
        self._hop_frames = self.params.dtw_hop_size // self.hop_size

        # Dedupe identical refs before the (expensive) chroma extraction:
        # the common serving shape is B listeners on ONE concert, where
        # recomputing the reference chromagram per stream turns setup into
        # O(B · ref_minutes) host FFT work.  Keyed by path for file refs and
        # by object identity for array refs (the shared-reference pattern
        # passes the same array B times); distinct-but-equal arrays are
        # simply not deduped.
        if ref_chromas is not None:
            # Precomputed (12, m) chromagrams, one per stream (or one shared
            # entry for all streams): skips the O(ref_minutes) host FFT at
            # construction — the restart path for long-running services and
            # repeated harness runs over one concert.  Must match what
            # chroma_from_samples(ref, dtype=dtype) would produce; identical
            # entries (by object identity) count as a shared reference.
            if len(ref_chromas) == 1 and len(refs) > 1:
                ref_chromas = list(ref_chromas) * len(refs)
            if len(ref_chromas) != len(refs):
                raise ValueError(
                    f"ref_chromas has {len(ref_chromas)} entries for "
                    f"{len(refs)} streams")
            ref_chromas = [np.asarray(c, self.dtype) for c in ref_chromas]
            memo = {id(c): c for c in ref_chromas}
        else:
            ref_chromas = []
            memo = {}
            for r in refs:
                key = r if isinstance(r, (str, bytes)) else id(r)
                if key in memo:
                    ref_chromas.append(memo[key])
                    continue
                if isinstance(r, (str, bytes)):
                    wav, fs = load_wav(r)
                    assert fs == 22050
                else:
                    wav = np.asarray(r)
                memo[key] = chroma_from_samples(wav, dtype=self.dtype)
                ref_chromas.append(memo[key])
        self.b = len(ref_chromas)
        if self.b == 0:
            raise ValueError("need at least one stream")
        f = ref_chromas[0].shape[0]
        self.ms = np.asarray([c.shape[1] for c in ref_chromas], np.int32)
        for i, c in enumerate(ref_chromas):
            try:
                _check_ref_window(c.shape[1], self.params)
            except ValueError as e:
                raise ValueError(f"stream {i}: {e}") from None
        m_max = int(self.ms.max())
        self.n_caps = (2 * self.ms).astype(np.int32)  # per-stream live cap (wtw.py:52)
        n_buf = 2 * m_max

        # Shared-reference mode: when every stream follows the SAME
        # recording (the B-listeners-one-concert serving shape), store the
        # reference chromagram once and let vmap broadcast it (in_axes=None)
        # instead of stacking B copies on device — at hour scale the stack
        # is ~0.5 GB at B=256, the single copy ~2 MB.  Mixed refs keep the
        # (B, f, m_max) stack.
        self._shared_ref = len(memo) == 1
        if self._shared_ref:
            refs_padded = np.ascontiguousarray(ref_chromas[0], self.dtype)
        else:
            refs_padded = np.zeros((self.b, f, m_max), self.dtype)
            for i, c in enumerate(ref_chromas):
                refs_padded[i, :, : c.shape[1]] = c
        p_cap = (n_buf // self._hop_frames + 2) * (2 * self._w - 1) + 64

        # mesh: shard every batched leaf along the stream axis (all mesh
        # axes — a partial spec would silently replicate); single device:
        # let jit's argument-transfer path place per-block args and
        # device_put only the persistent state
        self.mesh = mesh
        if mesh is not None:
            require_batch_divisible(mesh, self.b)
            put_init = batch_axis_sharding_put(mesh)
            self._put_step = put_init
        else:
            put_init = jax.device_put
            self._put_step = lambda x: x

        if self._shared_ref and mesh is not None:
            # the shared ref is consumed unbatched — replicate it across the
            # mesh (the batch-axis put would shard its leading dim, which is
            # the feature axis here)
            self._ref_dev = jax.device_put(
                refs_padded, NamedSharding(mesh, P()))
        else:
            self._ref_dev = put_init(refs_padded)
        self._live_dev = put_init(np.zeros((self.b, f, n_buf), self.dtype))
        self._m_dev = put_init(self.ms)
        self._ncap_dev = put_init(self.n_caps)
        self._state = (
            put_init(np.zeros((self.b, p_cap), np.int32)),
            put_init(np.zeros((self.b, p_cap), np.int32)),
            put_init(np.zeros((self.b, 8), np.int32)),
        )
        # multi-stream uses the scan window DP: under vmap the predicated
        # window executes for the whole batch whenever any stream is due,
        # which the vectorized wavefront absorbs; the Pallas kernel's
        # batching rule does not apply here
        self._step = _make_multi_wtw_step(
            f, self._w, self._hop_frames, self.k_block, "scan",
            self.fft_len, self.hop_size,
            transfer=self.transfer_dtype, shared_ref=self._shared_ref,
        )
        self._frontend_consts = frontend_constants(self.fft_len, 22050, self.dtype)

        self.bufs = [SampleFIFO(self.dtype) for _ in range(self.b)]
        self._stopped = np.zeros(self.b, bool)
        self._span_len = (self.k_block - 1) * self.hop_size + self.fft_len
        self._init_batched_polling()

    # ------------------------------------------------------------------
    def _avail_cols(self, i: int) -> int:
        n = len(self.bufs[i])
        return 0 if n < self.fft_len else (n - self.fft_len) // self.hop_size + 1

    def _spans(self, ks: np.ndarray) -> np.ndarray:
        """The block's H2D payload: (B, span) raw samples, or (B, 12,
        k_block) host-extracted chroma columns for ``transfer_dtype=
        "chroma"`` (one batched rfft over all B·k_block frames)."""
        if self.transfer_dtype == "chroma":
            # FFT only the VALID frames: the host rfft is the serving
            # throughput ceiling, and under skewed feeds streams dispatch
            # with 0 <= k < k_block new columns — transforming their
            # padding would waste up to ~B x k_block 4096-point FFTs per
            # dispatch.  Valid frames pack into one ragged batch (a single
            # pocketfft call); columns past k stay zero, which the device
            # masks by n_valid exactly like the nonzero padding chroma the
            # unpacked path used to ship (the payload past k is dont-care).
            active = [(i, int(k)) for i, k in enumerate(ks) if k > 0]
            out = np.zeros((self.b, 12, self.k_block), self.dtype)
            if not active:
                return out
            frames = np.zeros((sum(k for _, k in active), self.fft_len),
                              self.dtype)
            row = 0
            for i, k in active:
                span = build_span(self.bufs[i], k, self.k_block,
                                  self.hop_size, self.fft_len, self.dtype)
                stride = span.strides[0]
                frames[row:row + k] = np.lib.stride_tricks.as_strided(
                    span, shape=(k, self.fft_len),
                    strides=(self.hop_size * stride, stride))
                row += k
            cols = host_chroma_frames(frames, n_fft=self.fft_len,
                                      overwrite_frames=True)
            row = 0
            for i, k in active:
                out[i, :, :k] = cols[:, row:row + k]
                row += k
            return out
        spans = np.zeros((self.b, self._span_len), self.dtype)
        for i, k in enumerate(ks):
            if k > 0:
                spans[i] = build_span(self.bufs[i], int(k), self.k_block,
                                      self.hop_size, self.fft_len, self.dtype)
        if self.transfer_dtype == "int16":
            return np.clip(np.round(spans * 32768.0), -32768, 32767).astype(np.int16)
        return spans

    def _dispatch(self, ks: np.ndarray) -> None:
        spans = self._spans(ks)
        px, py, sc = self._state
        self._live_dev, px, py, sc, status = self._step(
            self._live_dev, self._ref_dev, px, py, sc,
            self._put_step(spans), self._put_step(ks.astype(np.int32)),
            self._m_dev, self._ncap_dev, *self._frontend_consts,
        )
        self._state = (px, py, sc)
        self._outstanding.append(status)
        self._poll()

    _harvest_thread_name = "rtas-wtw-harvest"

    def insert(self, stream_bufs: Sequence) -> np.ndarray:
        """Append raw samples per stream (``None`` = no new audio) and
        dispatch full blocks; non-blocking.  Returns the stopped mask as of
        the last completed poll (lazy, like the solo engines)."""
        if len(stream_bufs) != self.b:
            raise ValueError(f"expected {self.b} buffers, got {len(stream_bufs)}")
        for i, buf in enumerate(stream_bufs):
            if buf is not None and not self._stopped[i]:
                self.bufs[i].extend(buf)
        while True:
            ks = np.asarray(
                [0 if self._stopped[i] else min(self._avail_cols(i), self.k_block)
                 for i in range(self.b)], np.int32)
            if ks.max(initial=0) < self.k_block:
                break
            self._dispatch(ks)
        self._poll()
        return self._stopped.copy()

    def _poll(self, block: bool = False) -> None:
        if block:
            self._settle_status()
            return
        self._poll_status()

    def _consume(self, vec: np.ndarray) -> None:
        self._stopped |= (vec[:, 0] & 1).astype(bool)
        if (vec[:, 0] & 2).any():  # pragma: no cover - exact capacity bound
            raise AssertionError("MultiStreamWTW path buffer overflow")

    def flush(self) -> np.ndarray:
        """Drain every stream's remaining whole hop columns and wait for all
        in-flight dispatches; returns the final stopped mask."""
        while True:
            ks = np.asarray(
                [0 if self._stopped[i] else min(self._avail_cols(i), self.k_block)
                 for i in range(self.b)], np.int32)
            if ks.max(initial=0) <= 0:
                break
            self._dispatch(ks)
        self._poll(block=True)
        return self._stopped.copy()

    # -- inspection (each synchronizes) ---------------------------------
    @property
    def stopped(self) -> np.ndarray:
        self._poll(block=True)
        return self._stopped.copy()

    def paths(self) -> List[List[tuple]]:
        px, py, sc = jax.device_get(self._state)
        out = []
        for i in range(self.b):
            plen = int(sc[i, _W_PLEN])
            out.append(list(zip(px[i, :plen].tolist(), py[i, :plen].tolist())))
        return out

    def pointers(self) -> List[Tuple[int, int, int]]:
        sc = np.asarray(self._state[2])
        return [tuple(int(sc[i, j]) for j in (_W_CHROMA, _W_LIVE, _W_REF))
                for i in range(self.b)]

"""WTW — windowed time warping over raw audio (reference wtw.py:19-240).

The only engine that consumes **raw samples** rather than chroma columns: it
buffers incoming audio, emits a chroma column per hop, and whenever
``dtw_win_size/hop_size`` fresh live frames exist runs a full DTW on a w×w
window ``[live_ptr:+w, ref_ptr:+w]``, commits the subpath up to
``dtw_hop_size``, then advances both pointers (diagonal fallback when the
subpath never crosses the hop boundary) — wtw.py:71-130.

Device redesign: feature columns are extracted in batch (one fused DFT-matmul
program per insert instead of a per-hop Python rfft loop), and each window
DTW runs the shared anti-diagonal wavefront kernel with WTW's step
convention (unweighted diagonal, up/left/diag tie order, back codes 3/1/2 —
ops/wavefront.py).  The window size is static, so every window alignment is
a single cached XLA program.  Pointer bookkeeping and subpath commits are
per-window host logic (O(windows), not O(frames)).

Python-2 integer-division semantics of ``dtw_win_size/hop_size`` and
``dtw_hop_size/hop_size`` (wtw.py:96-107) are preserved via floor division.
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from real_time_audio_sync_tpu.config import WTWParams
from real_time_audio_sync_tpu.features.chroma import chroma_frames
from real_time_audio_sync_tpu.ops.wavefront import WTW_SPEC, backtrack, wavefront_dp
from real_time_audio_sync_tpu.utils.wavio import load_wav


class WTWLongReferenceWarning(UserWarning):
    """WTW pointed at a reference far beyond its validated regime."""


# The reference only ever field-validated WTW on a ~35 s excerpt
# (wtw_live.py:108-109); warn at ~2x that.  The full-scale corpus measured
# WHY this matters: 45-48% of beats land >3 s off on multi-minute jittered
# pieces (docs/ACCURACY.md) because WTW commits each w-frame window subpath
# irrevocably on a fixed hop (wtw.py:110-128) — a bad early window cannot
# be revised.  The online band engines (OTW/LiveNote/LiveNoteV2) hold
# <=1.11% at that scale and are the right tool there.
_WTW_VALIDATED_REF_S = 70.0


def _check_ref_window(m: int, params: WTWParams, fs: int = 22050) -> None:
    """Reject a reference shorter than one DTW window up front.  The
    reference implementation would silently run a degenerate short-sliced
    window (numpy clamps slices, wtw.py:100-104); the fixed-shape device
    window programs slice exactly ``w`` columns, so a too-short reference
    is a hard error with guidance instead of a deep jit-time crash
    (docs/PARITY.md deviation: graceful-rejection family).

    Also warns loudly (:class:`WTWLongReferenceWarning`, suppressible via
    ``warnings.filterwarnings``) when the reference is far longer than the
    regime WTW was ever validated in — the measured multi-minute failure
    mode above."""
    w = params.dtw_win_size // params.hop_size
    if m < w:
        raise ValueError(
            f"reference too short for WTW: {m} chroma frames < one DTW "
            f"window of {w} frames (dtw_win_size={params.dtw_win_size} "
            f"samples / hop_size={params.hop_size}); use a longer "
            f"reference or a smaller dtw_win_size")
    ref_s = m * params.hop_size / fs
    if ref_s > _WTW_VALIDATED_REF_S:
        import warnings

        warnings.warn(
            f"WTW reference is {ref_s:.0f} s — far beyond the ~35 s regime "
            "the algorithm was validated in.  WTW commits window subpaths "
            "irrevocably and measured 45-48% of beats >3 s off on "
            "multi-minute jittered pieces (docs/ACCURACY.md); prefer the "
            "online band engines (OnlineTimeWarping/LiveNote/LiveNoteV2) "
            "at this scale, or suppress this warning if the tempo is "
            "known-steady.", WTWLongReferenceWarning, stacklevel=3)


class SampleFIFO:
    """Amortized-O(1) numpy sample queue replacing the reference's Python
    list buffer (wtw.py:73,81-83): the reference re-slices the whole list
    every hop (O(len) per hop → O(frames²) per stream); here consumption is
    a pointer bump and compaction copies each sample at most once."""

    def __init__(self, dtype, capacity: int = 1 << 16):
        self._data = np.zeros(capacity, dtype)
        self._start = 0
        self._end = 0

    @classmethod
    def from_array(cls, arr, dtype):
        fifo = cls(dtype, capacity=max(1 << 16, 2 * len(arr)))
        fifo.extend(arr)
        return fifo

    def __len__(self) -> int:
        return self._end - self._start

    def extend(self, samples) -> None:
        samples = np.asarray(samples, self._data.dtype).ravel()
        n = len(samples)
        if self._end + n > len(self._data):
            live = self._end - self._start
            if live + n > len(self._data):  # grow
                new = np.zeros(max(2 * len(self._data), live + n), self._data.dtype)
                new[:live] = self._data[self._start : self._end]
                self._data = new
            else:  # compact
                self._data[:live] = self._data[self._start : self._end]
            self._start, self._end = 0, live
        self._data[self._end : self._end + n] = samples
        self._end += n

    def view(self, n: int) -> np.ndarray:
        """Zero-copy view of the first ``n`` queued samples."""
        return self._data[self._start : self._start + n]

    def consume(self, n: int) -> None:
        self._start += n

    def to_array(self) -> np.ndarray:
        return self.view(len(self)).copy()


@partial(jax.jit, static_argnames=())
def _window_cost(x, y):
    """Explicit cosine cost with norm division (wtw.py:162-171): the columns
    are L2-normalized already, but the reference divides by the norms anyway
    — preserved (silent/zero columns would produce the same non-finite
    values).

    ``Precision.HIGHEST`` keeps the matmul in full f32: a lower precision
    (TF32 on the GPU) moves costs by ~1e-3, which measurably diverges the
    window DP from the f64 reference recurrence (527 vs the oracle-faithful
    509 committed points on a 20-bar piano pair)."""
    dots = jnp.matmul(x.T, y, precision=jax.lax.Precision.HIGHEST)
    nx = jnp.sqrt(jnp.sum(x * x, axis=0))
    ny = jnp.sqrt(jnp.sum(y * y, axis=0))
    return 1.0 - dots / (nx[:, None] * ny[None, :])


@jax.jit
def _window_dtw(x, y):
    """One w×w window alignment: cost → wavefront DP → backtracked subpath.

    Returns (D, points, length); ``points`` is end→origin, padded."""
    cost = _window_cost(x, y)
    acc, back = wavefront_dp(cost, WTW_SPEC)
    points, length = backtrack(back, WTW_SPEC)
    return acc, points, length


@partial(jax.jit, static_argnames=("w",), donate_argnames=())
def _window_dtw_at(live_dev, ref_dev, live_ptr, ref_ptr, w: int):
    """Window alignment sliced on-device: keeps the live chromagram
    device-resident so streaming never synchronizes per hop."""
    f = live_dev.shape[0]
    zero = jnp.zeros((), live_ptr.dtype)
    x = jax.lax.dynamic_slice(live_dev, (zero, live_ptr), (f, w))
    y = jax.lax.dynamic_slice(ref_dev, (zero, ref_ptr), (f, w))
    return _window_dtw(x, y)


@partial(jax.jit, donate_argnames=("live_dev",))
def _append_cols(live_dev, cols, ptr):
    """live_dev[:, ptr:ptr+K] ← cols, in place (donated) — one async
    dispatch per hop batch, no device→host read."""
    zero = jnp.zeros((), ptr.dtype) if hasattr(ptr, "dtype") else 0
    return jax.lax.dynamic_update_slice(live_dev, cols.astype(live_dev.dtype), (zero, ptr))


class WTW:
    def __init__(self, ref_recording, params, debug_params=None, dtype=None, keep_acc_canvas=True):
        self.params = WTWParams.from_any(params)
        self.debug_params = debug_params or {}
        self.dtype = np.dtype(dtype or np.float32)

        if isinstance(ref_recording, (str, bytes)):
            self.ref, self.fs = load_wav(ref_recording)
            assert self.fs == 22050
        else:  # raw 22.05 kHz sample array (same surface as AsyncWTW)
            self.ref = np.asarray(ref_recording)
            self.fs = 22050

        self.fft_len = self.params.fft_len
        self.hop_size = self.params.hop_size
        self.dtw_win_size = self.params.dtw_win_size
        self.dtw_hop_size = self.params.dtw_hop_size

        # reference chromagram via the shared frontend (wtw.py:37-41 uses the
        # identical stft→|·|²→chromafb→L2 chain)
        from real_time_audio_sync_tpu.features.chroma import chroma_from_samples

        self.chroma_ref = chroma_from_samples(self.ref, dtype=self.dtype)

        self.N = self.chroma_ref.shape[1] * 2  # live capacity (rows)
        self.M = self.chroma_ref.shape[1]  # ref length (cols)
        _check_ref_window(self.M, self.params)

        # live chromagram lives ON DEVICE: per-hop column appends are async
        # dispatches and windows slice it in-program, so streaming never
        # pays a device→host read per hop (only per committed window)
        self._live_dev = jax.device_put(jnp.zeros((12, self.N), self.dtype))
        self._ref_dev = jax.device_put(jnp.asarray(self.chroma_ref))
        # dense accumulated-cost canvas for parity/visualization: windows are
        # pasted in as they are computed (wtw.py:105).  Optional — for long
        # streams where the O(N·M) canvas is unwanted, pass
        # ``keep_acc_canvas=False`` (alignment is unaffected; only this
        # debugging/heatmap artifact is skipped).
        self.keep_acc_canvas = bool(keep_acc_canvas)
        self.acc_cost = (
            np.full((self.N, self.M), np.inf, self.dtype) if keep_acc_canvas else None
        )

        self.buf = SampleFIFO(self.dtype)
        self.path: List[tuple] = []

        self.chroma_ptr = 0
        self.live_ptr = 0
        self.ref_ptr = 0

        self._w = self.dtw_win_size // self.hop_size  # window in frames
        self._hop_frames = self.dtw_hop_size // self.hop_size

    # ------------------------------------------------------------------
    def insert(self, live_audio_buf):
        """Insert raw audio samples (list or array) — wtw.py:71-130.

        Arrays are ingested without copies into a numpy FIFO (amortized O(1)
        per hop; the reference's list buffer re-slices O(len) every hop).

        Compile-count caveat: the chroma extraction jit specializes on the
        number of currently available columns, so wildly varying buffer
        sizes each pay a one-time compile.  Steady feeds (fixed-size
        buffers, or the harness's ``np.array_split`` chunks — at most two
        distinct sizes) stay at a handful of shapes.  This host-loop engine
        is the parity oracle; production streaming is ``AsyncWTW``, which
        pads every dispatch to a static ``k_block``."""
        self.buf.extend(live_audio_buf)

        if self.ref_ptr >= self.M - 1 or self.live_ptr >= self.N - 1:
            return "stop"

        w = self._w
        while len(self.buf) >= self.fft_len:
            # batch-extract every currently available column in one device
            # call and append them to the device-resident chromagram
            # asynchronously; buffer consumption then replays the reference's
            # one-col-per-iteration bookkeeping exactly (host counters only)
            n_cols = (len(self.buf) - self.fft_len) // self.hop_size + 1
            avail = self.buf.view((n_cols - 1) * self.hop_size + self.fft_len)
            # .copy(): the windows view aliases the FIFO's ring, which a
            # later extend() may compact IN PLACE while the chroma dispatch
            # below is still in flight — on CPU backends jnp.asarray can
            # ingest a contiguous (1, fft_len) view zero-copy (the same
            # hazard build_span documents in wtw_async.py); the strided
            # multi-row case was getting copied by JAX anyway, so this adds
            # no work there
            frames = np.lib.stride_tricks.sliding_window_view(avail, self.fft_len)[
                :: self.hop_size
            ].copy()
            cols = chroma_frames(jnp.asarray(frames, self.dtype))  # (12, n_cols), device
            room = self.N - self.chroma_ptr
            if room > 0:
                self._live_dev = _append_cols(
                    self._live_dev, cols[:, :room], np.int32(self.chroma_ptr)
                )

            for k in range(n_cols):
                self.buf.consume(self.hop_size)
                if self.chroma_ptr >= self.N:
                    return "stop"  # live buffer capacity exhausted
                self.chroma_ptr += 1

                if self.ref_ptr >= (self.M - 1 - w) or self.live_ptr >= (self.N - 1 - w):
                    return "stop"

                while self.chroma_ptr - self.live_ptr >= w:
                    self._run_window()
        return None

    @property
    def chroma_live(self) -> np.ndarray:
        """Host view of the device-resident live chromagram (synchronizes)."""
        return np.asarray(self._live_dev)

    @chroma_live.setter
    def chroma_live(self, value) -> None:
        self._live_dev = jax.device_put(jnp.asarray(np.asarray(value), self.dtype))

    # ------------------------------------------------------------------
    def _run_window(self):
        """One w×w window DTW + subpath commit (wtw.py:100-128); the window
        slices the device-resident chromagrams in-program."""
        w = self._w
        # Window slices never cross a chromagram end (so the device
        # dynamic_slice never clamps): the committed live advance is exactly
        # hop_frames ≥ 1 per window (WTWParams validates dtw_hop_size ≥
        # hop_size), so at most one window runs per inserted column and the
        # per-column stop margins (insert()) keep ref_ptr ≤ M-2-w and
        # live_ptr ≤ N-2-w at window time.
        assert self.ref_ptr + w <= self.M and self.live_ptr + w <= self.N
        acc, points, length = _window_dtw_at(
            self._live_dev, self._ref_dev,
            np.int32(self.live_ptr), np.int32(self.ref_ptr), w,
        )
        # one batched device→host fetch; the acc window transfers only when
        # the canvas is kept
        if self.keep_acc_canvas:
            acc_np, points_np, length_np = jax.device_get((acc, points, length))
            self.acc_cost[
                self.live_ptr : self.live_ptr + w, self.ref_ptr : self.ref_ptr + w
            ] = acc_np
        else:
            points_np, length_np = jax.device_get((points, length))
        subpath = points_np[: int(length_np)][::-1]  # origin → end

        next_start = self._hop_frames
        change = False
        index = None
        for i in range(len(subpath)):
            l, r = int(subpath[i][0]), int(subpath[i][1])
            if l <= next_start:
                self.path.append((l + self.live_ptr, r + self.ref_ptr))
            else:
                change = True
                index = i - 1
                break
        if change:
            self.live_ptr = int(subpath[index][0]) + self.live_ptr
            self.ref_ptr = int(subpath[index][1]) + self.ref_ptr
        else:
            # subpath never crossed the hop boundary: take the diagonal
            self.live_ptr = self.live_ptr + self._hop_frames
            self.ref_ptr = self.ref_ptr + self._hop_frames

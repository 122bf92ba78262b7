"""AsyncWTW — device-resident windowed time warping with pipelined dispatch.

The host :class:`~real_time_audio_sync_tpu.models.wtw.WTW` replays the
reference's per-window control flow (wtw.py:71-130) on the host and therefore
synchronizes once per committed window (a device→host read of the window
subpath).  This engine moves the WHOLE streaming
step on-device: the live chromagram, the live/ref/chroma pointers, the
committed path and the stop flag are device state carried across launches,
and each dispatch processes a block of hop columns — appends them, runs any
due w×w window DTW (shared wavefront kernel, WTW step convention) and commits
the subpath in-program.  The host never reads anything per hop; "stop" and
the score position are polled lazily from a 16-byte status vector exactly
like the fused OTW streaming engine (models/fused_streaming.py).

Correctness hinges on an invariant of the reference recurrence: the window
subpath's live coordinate is nondecreasing with unit increments from 0 to
w−1, so the last committed point always has ``l == dtw_hop_size/hop_size``
(every value in [0, w−1] is attained) and each window advances ``live_ptr``
by exactly ``hop_frames`` — hence at most ONE window becomes due per inserted
column and the reference's inner ``while`` (wtw.py:100) reduces to a single
predicated window per column (a ``lax.cond``), keeping the step program
fixed-shape.  The diagonal fallback (wtw.py:126-128) also advances by
``hop_frames``, so the invariant holds in both branches.

Committed paths are identical to the host WTW engine and the oracle
(tests/test_wtw.py); only the *timing* of "stop" differs (lazy, like the
fused OTW engine — post-stop inserts are frozen no-ops in-program).
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from real_time_audio_sync_tpu.config import WTWParams
from real_time_audio_sync_tpu.features.chroma import (
    _chroma_frames_impl,
    chroma_from_samples,
    frame_span,
    frontend_constants,
    host_chroma_frames,
)
from real_time_audio_sync_tpu.models.online_core import StatusPolling
from real_time_audio_sync_tpu.models.wtw import (SampleFIFO, _check_ref_window,
                                                 _window_cost)
from real_time_audio_sync_tpu.ops.wavefront import WTW_SPEC, backtrack, wavefront_dp
from real_time_audio_sync_tpu.utils.wavio import load_wav

def build_span(fifo, k: int, k_block: int, hop: int, fft: int, dtype) -> np.ndarray:
    """Extract one block's contiguous sample span from a :class:`SampleFIFO`
    and consume its k·hop samples.

    Always returns the static (k_block−1)·hop+fft length (ragged tails
    zero-padded; padded columns are masked by n_valid in-program) and always
    COPIES: the FIFO's ring storage is mutated in place by ``consume``/
    ``extend`` while jnp.asarray may alias host memory (zero-copy on the CPU
    backend) or defer the transfer past the consume."""
    span_len = (k_block - 1) * hop + fft
    avail = fifo.view((k - 1) * hop + fft)
    if avail.shape[0] < span_len:
        span = np.zeros(span_len, dtype)
        span[: avail.shape[0]] = avail
    else:
        span = np.array(avail, dtype, copy=True)
    fifo.consume(k * hop)
    return span


def host_chroma_block(fifo, k: int, k_block: int, hop: int, fft: int,
                      dtype) -> np.ndarray:
    """Extract one block's (12, k_block) chroma columns ON THE HOST and
    consume the block's k·hop samples (``transfer_dtype="chroma"``).

    Same span/consumption semantics as :func:`build_span`; columns past the
    ``k`` valid ones come from the zero pad and are masked in-program by
    ``n_valid`` anyway.  Numerics: host ``np.fft.rfft`` vs the in-program
    DFT matmuls — see :func:`~real_time_audio_sync_tpu.features.chroma.
    host_chroma_frames`."""
    span = build_span(fifo, k, k_block, hop, fft, dtype)
    stride = span.strides[0]
    frames = np.lib.stride_tricks.as_strided(
        span, shape=(k_block, fft), strides=(hop * stride, stride))
    return host_chroma_frames(frames, n_fft=fft)


# scalar-state vector layout (int32[8])
_W_CHROMA = 0  # columns appended so far
_W_LIVE = 1  # live window origin (frames)
_W_REF = 2  # ref window origin (frames)
_W_PLEN = 3  # committed path length
_W_FLAGS = 4  # bit0 = stopped, bit1 = path-buffer overflow


def _make_block_body(f: int, w: int, hop_frames: int, k_pad: int,
                     backend: str, fft: int, hop: int, hoisted: bool = True,
                     transfer: str = "float32"):
    """Build the (unjitted) block-step body: (live_dev, ref_dev, px, py, sc,
    samples, n_valid, m, n_cap, win, dft_cos, dft_sin, fb_t) →
    (live_dev, px, py, sc, status).  All shapes static; ``m`` (true reference
    length) and ``n_cap`` (semantic live capacity, 2m) are traced scalars so
    the same body serves the solo engine and the vmapped multi-stream
    service (where they differ per stream over a common padded buffer).

    ``samples`` is the raw contiguous sample span covering the block's
    ``k_pad`` analysis frames ((k_pad−1)·hop + fft samples); framing AND
    feature extraction happen inside the program.  Shipping the span instead
    of pre-framed windows halves host→device bytes (the fft/hop=2 overlap
    is materialized on-device by a reshape, not on the host), which is the
    host→device link's bytes per hop.

    ``backend`` selects the in-program window DP: "unroll" traces the
    2w−1 diagonal updates and the backtrack as straight-line code (no XLA
    loops), "scan" uses the ``lax.scan`` wavefront."""
    maxpts = 2 * w - 1  # longest possible window subpath
    unroll = backend == "unroll"

    def _run_window(live_dev, ref_dev, carry):
        """One due w×w window: DP + backtrack + subpath commit
        (wtw.py:100-128), entirely in-program."""
        px, py, live_ptr, ref_ptr, path_len, flags = carry
        p_cap = px.shape[0]
        zero = jnp.int32(0)
        x = jax.lax.dynamic_slice(live_dev, (zero, live_ptr), (f, w))
        y = jax.lax.dynamic_slice(ref_dev, (zero, ref_ptr), (f, w))
        cost = _window_cost(x, y)
        if unroll:
            _, back = wavefront_dp(cost, WTW_SPEC, unroll=True)
        else:
            _, back = wavefront_dp(cost, WTW_SPEC)
        points, length = backtrack(back, WTW_SPEC, unroll=unroll)  # (maxpts, 2), end→origin
        length = length.astype(jnp.int32)

        j = jnp.arange(maxpts, dtype=jnp.int32)
        valid = j < length
        l_vals = points[:, 0].astype(jnp.int32)
        # committed prefix: all points with l ≤ hop_frames (l is nondecreasing
        # origin→end, so the count equals the prefix length) — wtw.py:110-115
        n_c = jnp.sum(jnp.where(valid & (l_vals <= hop_frames), 1, 0)).astype(jnp.int32)
        # origin-order point j is points[length-1-j]
        gidx = jnp.clip(length - 1 - j, 0, maxpts - 1)
        pts_orig = points[gidx].astype(jnp.int32)  # (maxpts, 2)
        commit = j < n_c
        dest = jnp.where(commit, path_len + j, p_cap)  # p_cap → dropped
        px = px.at[dest].set(pts_orig[:, 0] + live_ptr, mode="drop")
        py = py.at[dest].set(pts_orig[:, 1] + ref_ptr, mode="drop")
        flags = flags | jnp.where(path_len + n_c > p_cap, 2, 0)
        path_len = jnp.minimum(path_len + n_c, p_cap)

        change = n_c < length  # some subpath point crossed the hop boundary
        idx_pt = pts_orig[jnp.clip(n_c - 1, 0, maxpts - 1)]  # last committed
        live_ptr = live_ptr + jnp.where(change, idx_pt[0], hop_frames)
        ref_ptr = ref_ptr + jnp.where(change, idx_pt[1], hop_frames)
        return (px, py, live_ptr, ref_ptr, path_len, flags)

    def body_cols(live_dev, ref_dev, px, py, sc, cols, n_valid, m, n_cap):
        """Reference block implementation: one lax.scan step per column with
        the window run predicated by a cond — semantically transparent, used
        as the parity oracle for ``body_hoisted``."""

        def col_step(carry, xs):
            live_dev, px, py, sc = carry
            col, k = xs
            chroma_ptr = sc[_W_CHROMA]
            live_ptr = sc[_W_LIVE]
            ref_ptr = sc[_W_REF]
            path_len = sc[_W_PLEN]
            flags = sc[_W_FLAGS]

            active = (k < n_valid) & ((flags & 1) == 0)
            # append the column (batch append of the host engine, one col at
            # a time here; positions ≥ capacity are dropped as there)
            can_append = active & (chroma_ptr < n_cap)
            ptr_safe = jnp.minimum(chroma_ptr, n_cap - 1)
            old = jax.lax.dynamic_slice(live_dev, (jnp.int32(0), ptr_safe), (f, 1))
            newcol = jnp.where(can_append, col[:, None], old)
            live_dev = jax.lax.dynamic_update_slice(live_dev, newcol, (jnp.int32(0), ptr_safe))

            # capacity stop BEFORE the increment (wtw host engine order)
            cap_stop = active & (chroma_ptr >= n_cap)
            chroma_ptr = chroma_ptr + jnp.where(active & ~cap_stop, 1, 0)
            # per-column stop margins (wtw.py window-feasibility guard)
            margin_stop = (ref_ptr >= m - 1 - w) | (live_ptr >= n_cap - 1 - w)
            stop_now = cap_stop | (active & ~cap_stop & margin_stop)
            flags = flags | jnp.where(stop_now, 1, 0)

            # at most one window becomes due per appended column (see module
            # docstring); run it predicated
            due = active & ~stop_now & (chroma_ptr - live_ptr >= w)
            wcarry = (px, py, live_ptr, ref_ptr, path_len, flags)
            px, py, live_ptr, ref_ptr, path_len, flags = jax.lax.cond(
                due,
                lambda c: _run_window(live_dev, ref_dev, c),
                lambda c: c,
                wcarry,
            )
            sc = jnp.stack([chroma_ptr, live_ptr, ref_ptr, path_len, flags,
                            sc[5], sc[6], sc[7]])
            return (live_dev, px, py, sc), None

        xs = (cols.T, jnp.arange(k_pad, dtype=jnp.int32))
        (live_dev, px, py, sc), _ = jax.lax.scan(col_step, (live_dev, px, py, sc), xs)
        return live_dev, px, py, sc

    def body_hoisted(live_dev, ref_dev, px, py, sc, cols, n_valid, m, n_cap):
        """Same per-column semantics as ``col_step`` but with the window DP
        hoisted out of the column loop.  Within a block the window-due
        columns are DETERMINISTIC: live_ptr/ref_ptr change only when a
        window runs, each window advances live_ptr by exactly hop_frames
        (module-docstring invariant), and chroma_ptr advances by one per
        appended column — so the block reduces to one batched column append
        plus at most 1+⌈(k−1)/hop_frames⌉ predicated window slots, instead
        of k sequential cond-wrapped scan steps (the dominant in-program
        cost at small w, and under vmap the per-column cond becomes a
        both-branches select for the whole batch)."""
        cp = sc[_W_CHROMA]
        lp = sc[_W_LIVE]
        rp = sc[_W_REF]
        pl = sc[_W_PLEN]
        fl = sc[_W_FLAGS]
        kcount = jnp.where((fl & 1) == 0, n_valid, 0).astype(jnp.int32)

        # batched append: column k → position cp+k (capacity overflow and
        # masked columns dropped).  Columns past a mid-block stop are
        # written too — they lie beyond the final chroma_ptr and are never
        # read (stop is permanent); chroma_live beyond chroma_ptr is
        # unspecified, as for the host engine's untouched buffer tail.
        kk = jnp.arange(k_pad, dtype=jnp.int32)
        posv = cp + kk
        can = (kk < kcount) & (posv < n_cap)
        dest = jnp.where(can, posv, jnp.int32(live_dev.shape[1]))
        live_dev = live_dev.at[:, dest].set(cols, mode="drop")

        base = jnp.int32(0)
        done = kcount == 0
        n_slots = 1 + max(0, (k_pad - 1) // max(1, hop_frames)) + 1
        for _ in range(n_slots):
            seg = ~done & (base < kcount)
            # events within the segment, in column order (margin/capacity
            # checks use the CURRENT pointers — constant until a window runs)
            margin = (rp >= m - 1 - w) | (lp >= n_cap - 1 - w)
            k_cap = base + (n_cap - cp)  # capacity-stop column (no append there)
            k_due = jnp.maximum(base + (w + lp - cp) - 1, base)
            last_k = kcount - 1

            m_hit = seg & margin  # first active column: append (if room), stop
            c_hit = seg & ~margin & (k_cap <= jnp.minimum(k_due, last_k))
            w_hit = seg & ~margin & ~c_hit & (k_due <= last_k)
            none_hit = seg & ~margin & ~c_hit & ~w_hit

            cp = jnp.where(m_hit, cp + jnp.where(cp < n_cap, 1, 0),
                  jnp.where(c_hit, n_cap,
                   jnp.where(w_hit, cp + (k_due - base + 1),
                    jnp.where(none_hit, cp + (kcount - base), cp))))
            fl = fl | jnp.where(m_hit | c_hit, 1, 0)

            wcarry = (px, py, lp, rp, pl, fl)
            px, py, lp, rp, pl, fl = jax.lax.cond(
                w_hit,
                lambda c: _run_window(live_dev, ref_dev, c),
                lambda c: c,
                wcarry,
            )
            # after a window the very next column can re-trigger the margin
            # guard; done only on terminal events
            base = jnp.where(w_hit, k_due + 1, kcount)
            done = done | m_hit | c_hit | none_hit

        sc = jnp.stack([cp, lp, rp, pl, fl, sc[5], sc[6], sc[7]])
        return live_dev, px, py, sc

    def body(live_dev, ref_dev, px, py, sc, samples, n_valid, m, n_cap,
             win, dft_cos, dft_sin, fb_t):
        # framing + feature extraction fused into the step program: ONE
        # dispatch per hop block, raw span in
        if transfer == "chroma":
            # host-extracted (f, k_pad) chroma columns shipped instead of a
            # raw sample span — ~96x fewer H2D bytes (the multi-stream
            # serving ceiling on bandwidth-limited links); the in-program
            # frontend is skipped entirely.  See AsyncWTW.transfer_dtype for
            # the numerics contract (host rfft vs device DFT matmul).
            cols = samples
        else:
            if transfer == "int16":
                # int16 span shipped; decode to the engine dtype in-program.
                # 1/32768 is a power of two, so for samples that are exact
                # int16/32768 multiples (mono PCM16 sources) the round trip is
                # bit-exact; otherwise quantization is <= 2^-16 amplitude.
                samples = samples.astype(win.dtype) / np.float32(32768.0).astype(win.dtype)
            frames = frame_span(samples, k_pad, fft, hop)
            cols = _chroma_frames_impl(frames, win, dft_cos, dft_sin, fb_t, True)
        if hoisted:
            live_dev, px, py, sc = body_hoisted(
                live_dev, ref_dev, px, py, sc, cols, n_valid, m, n_cap)
        else:
            live_dev, px, py, sc = body_cols(
                live_dev, ref_dev, px, py, sc, cols, n_valid, m, n_cap)

        path_len = sc[_W_PLEN]
        has = path_len > 0
        last_i = jnp.clip(path_len - 1, 0, px.shape[0] - 1)
        status = jnp.stack([
            sc[_W_FLAGS],
            path_len,
            jnp.where(has, px[last_i], -1),
            jnp.where(has, py[last_i], -1),
        ]).astype(jnp.int32)
        return live_dev, px, py, sc, status

    return body


def _make_async_wtw_step(f: int, w: int, hop_frames: int, k_pad: int,
                         backend: str, fft: int, hop: int, hoisted: bool = True,
                         transfer: str = "float32"):
    """Jitted solo block step over :func:`_make_block_body` (state donated)."""
    body = _make_block_body(f, w, hop_frames, k_pad, backend, fft, hop, hoisted,
                            transfer)
    return partial(jax.jit, donate_argnums=(0, 2, 3, 4))(body)


def _make_multi_wtw_step(f: int, w: int, hop_frames: int, k_pad: int,
                         backend: str, fft: int, hop: int, hoisted: bool = True,
                         transfer: str = "float32", shared_ref: bool = False):
    """Jitted B-stream block step: the body vmapped over the stream axis of
    every per-stream argument (frontend constants are shared).  One device
    dispatch advances all B streams; per-frame DP state stays stream-local,
    so sharding the batch axis over a mesh needs zero collectives
    (SURVEY.md §5.8).  The hoisted body matters most here: under vmap a
    per-column cond becomes a both-branches select for the whole batch, so
    hoisting cuts the window-DP executions per block from k_pad to
    1+⌈(k_pad−1)/hop_frames⌉.

    ``shared_ref=True`` broadcasts ONE (f, m) reference chromagram to every
    stream (vmap in_axes=None) instead of carrying a (B, f, m) stack — the
    B-listeners-one-concert serving shape stores the reference once (at
    hour scale: ~2 MB instead of ~0.5 GB at B=256); the batched window
    starts turn the ref slices into gathers, arithmetic unchanged."""
    body = _make_block_body(f, w, hop_frames, k_pad, backend, fft, hop, hoisted,
                            transfer)
    ref_ax = None if shared_ref else 0
    vbody = jax.vmap(body, in_axes=(0, ref_ax) + (0,) * 7 + (None,) * 4)
    return partial(jax.jit, donate_argnums=(0, 2, 3, 4))(vbody)


class AsyncWTW(StatusPolling):
    """Raw-audio streaming WTW with fully asynchronous device dispatch.

    Same constructor surface as :class:`WTW` (reference wtw.py:21-69) plus
    ``k_block`` — hop columns are buffered until ``k_block`` are available
    and processed in one launch (``flush()`` drains the remainder).  The
    committed path matches the host engine exactly; "stop" surfaces lazily
    via the polled status vector."""

    def __init__(self, ref_recording, params, debug_params=None, k_block: int = 8,
                 window_backend: str = "auto", dtype=np.float32,
                 block_impl: str = "hoisted", transfer_dtype: str = "float32"):
        self.params = WTWParams.from_any(params)
        self.debug_params = debug_params or {}
        self.k_block = int(k_block)
        # transfer_dtype="int16": ship sample spans as int16 (half the H2D
        # bytes — the multi-stream serving ceiling, docs/STATUS.md) and
        # decode to the engine dtype in-program.  Bit-exact for audio whose
        # samples are int16/32768 multiples (mono PCM16 sources); otherwise
        # (e.g. the corpus' stereo-averaged wavs) quantizes at 2^-16
        # amplitude — inaudible, but can flip knife-edge DP ties, so it is
        # opt-in.
        # transfer_dtype="chroma": extract the 12-dim chroma columns on the
        # HOST (np.fft.rfft) and ship those instead of the raw span — ~96x
        # fewer H2D bytes (384 B vs 37 KB per 8-hop block), the decisive
        # win where link bandwidth caps multi-stream aggregate throughput.
        # Host rfft and the device DFT matmuls agree to ~1e-6 — not
        # bit-identical, which can flip
        # knife-edge DP ties — opt-in, path equality on real audio is
        # tested empirically like int16.
        # "auto": probe-based crossover choice (parallel/transfer.py) — the
        # serving layers' default; solo engines keep the exact f32 default
        # but accept it for symmetry.
        if transfer_dtype not in ("auto", "float32", "int16", "chroma"):
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
        if transfer_dtype == "auto":
            from real_time_audio_sync_tpu.parallel.transfer import (
                resolve_transfer_mode,
            )

            transfer_dtype = resolve_transfer_mode(
                "auto", 1, self.k_block, self.params.fft_len,
                self.params.hop_size)
        self.transfer_dtype = transfer_dtype
        # f32 is the production dtype; f64 is for CPU parity tests where the
        # comparison must be immune to batch-shape-dependent f32 accumulation
        # (docs/PARITY.md deviation 8 — different k_block ⇒ different matmul
        # batch shapes ⇒ ~2e-6 chroma differences that can flip knife-edge
        # DP ties).
        self.dtype = np.dtype(dtype)
        if self.dtype == np.float64 and not jax.config.jax_enable_x64:
            # without x64, device_put silently downcasts every f64 array to
            # f32 and the invariance guarantee this dtype exists for is void
            raise ValueError("dtype=float64 requires jax_enable_x64")
        if window_backend not in ("auto", "unroll", "scan"):
            raise ValueError(f"unknown window_backend {window_backend!r}")
        if block_impl not in ("hoisted", "cols"):
            raise ValueError(f"unknown block_impl {block_impl!r}")
        self.block_impl = block_impl

        if isinstance(ref_recording, (str, bytes)):
            self.ref, self.fs = load_wav(ref_recording)
            assert self.fs == 22050
        else:  # raw 22.05 kHz sample array (parity with MultiStreamWTW)
            self.ref = np.asarray(ref_recording)
            self.fs = 22050

        self.fft_len = self.params.fft_len
        self.hop_size = self.params.hop_size
        self._w = self.params.dtw_win_size // self.hop_size
        self._hop_frames = self.params.dtw_hop_size // self.hop_size
        assert self._hop_frames >= 1  # guaranteed by WTWParams validation

        self.chroma_ref = chroma_from_samples(self.ref, dtype=self.dtype)
        self.M = self.chroma_ref.shape[1]
        _check_ref_window(self.M, self.params)
        self.N = 2 * self.M  # live capacity (wtw.py:52)
        f = self.chroma_ref.shape[0]

        self._ref_dev = jax.device_put(jnp.asarray(self.chroma_ref))
        self._live_dev = jax.device_put(jnp.zeros((f, self.N), self.dtype))
        # exact commit bound: ≤ maxpts per window, ≤ N/hop_frames+2 windows
        p_cap = (self.N // self._hop_frames + 2) * (2 * self._w - 1) + 64
        sc = np.zeros(8, np.int32)
        self._state = (
            jax.device_put(jnp.zeros((p_cap,), jnp.int32)),
            jax.device_put(jnp.zeros((p_cap,), jnp.int32)),
            jax.device_put(jnp.asarray(sc)),
        )

        if window_backend == "auto":
            window_backend = "scan"
        self.window_backend = window_backend
        self._step = _make_async_wtw_step(
            f, self._w, self._hop_frames, self.k_block,
            window_backend, self.fft_len, self.hop_size,
            hoisted=block_impl == "hoisted",
            transfer=self.transfer_dtype,
        )
        self._frontend_consts = frontend_constants(self.fft_len, self.fs, self.dtype)

        self.buf = SampleFIFO(self.dtype)
        self._init_status_polling()

    # ------------------------------------------------------------------
    def _avail_cols(self) -> int:
        n = len(self.buf)
        return 0 if n < self.fft_len else (n - self.fft_len) // self.hop_size + 1

    def _dispatch(self, k: int) -> None:
        """Ship the block's payload (raw sample span, or host-extracted
        chroma columns for ``transfer_dtype="chroma"``) and launch one
        step."""
        if self.transfer_dtype == "chroma":
            span = host_chroma_block(self.buf, k, self.k_block, self.hop_size,
                                     self.fft_len, self.dtype)
        else:
            span = build_span(self.buf, k, self.k_block, self.hop_size,
                              self.fft_len, self.dtype)
            if self.transfer_dtype == "int16":
                span = np.clip(np.round(span * 32768.0), -32768, 32767).astype(np.int16)
        px, py, sc = self._state
        self._live_dev, px, py, sc, status = self._step(
            self._live_dev, self._ref_dev, px, py, sc, span, np.int32(k),
            np.int32(self.M), np.int32(self.N), *self._frontend_consts,
        )
        self._state = (px, py, sc)
        self._swap_status(status, k)  # staleness accounted in chroma columns

    def insert(self, live_audio_buf):
        """Insert raw audio samples; non-blocking.  Returns ``"stop"`` once a
        polled status showed it (lazy; post-stop columns are frozen no-ops
        in-program, so the committed path is unaffected)."""
        self.buf.extend(live_audio_buf)
        if self._stopped_cached or self.poll() == "stop":
            return "stop"
        while self._avail_cols() >= self.k_block:
            self._dispatch(self.k_block)
        return None

    insert_nowait = insert

    def flush(self):
        """Drain whole remaining hop columns (a trailing partial window of
        < fft_len samples stays buffered, as in the reference) and wait for
        all in-flight launches; returns ``"stop"`` or None."""
        k = self._avail_cols()
        if k > 0 and not self._stopped_cached:
            self._dispatch(k)
        return self.poll(block=True)

    # capacity is an exact upper bound; the shared StatusPolling machinery
    # raises this on the status overflow flag
    _overflow_msg = "AsyncWTW path buffer overflow"

    # -- inspection (each synchronizes) ---------------------------------
    @property
    def path_array(self) -> np.ndarray:
        px, py, sc = jax.device_get(self._state)
        plen = int(sc[_W_PLEN])
        return np.stack([px[:plen], py[:plen]], axis=1)

    @property
    def path(self) -> List[tuple]:
        return [tuple(p) for p in self.path_array]

    @property
    def pointers(self):
        """(chroma_ptr, live_ptr, ref_ptr) — synchronizing host read."""
        sc = np.asarray(self._state[2])
        return int(sc[_W_CHROMA]), int(sc[_W_LIVE]), int(sc[_W_REF])

    @property
    def chroma_live(self) -> np.ndarray:
        """Device-resident live chromagram (F, cap) — synchronizing read.

        Columns at indices >= ``chroma_ptr`` are unspecified: the hoisted
        block body batch-appends a whole block's columns before evaluating
        stop events, so on a mid-block margin/capacity stop the tail beyond
        ``chroma_ptr`` may hold columns the per-column reference semantics
        would never have written.  Nothing in-program reads past
        ``chroma_ptr``; compare buffers only up to it."""
        return np.asarray(self._live_dev)

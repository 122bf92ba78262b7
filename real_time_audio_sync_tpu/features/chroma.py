"""Chroma feature frontend on the device.

Reference semantics (chroma.py): a hand-rolled hop-loop STFT — Hann window,
centered via an ``fft_len/2`` left zero-pad (chroma.py:49), final partial
frame truncated (chroma.py:54) — then one-sided power spectrum, chroma
filterbank projection and per-frame L2 normalization (chroma.py:67-75).

Device redesign: no per-hop Python loop.  Framing is a reshape (hop =
fft_len/2 → two half-frame blocks per frame), the real DFT is a dense matmul
against precomputed cos/sin factor matrices (one batched matmul over all
frames instead of T sequential rffts; ROADMAP S5 weighs it against
``jnp.fft.rfft``), and the
filterbank projection + normalization fuse into the same XLA program.  The
whole wav→chroma pipeline is a single jitted function; the DFT/filterbank
factors live on-device once and are passed as arguments (not baked into each
compiled program).
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from real_time_audio_sync_tpu.config import FFT_LEN, FS, HOP_SIZE
from real_time_audio_sync_tpu.features.filterbank import chroma_filterbank
from real_time_audio_sync_tpu.utils.wavio import load_wav

# ---------------------------------------------------------------------------
# Cached on-device constants (per fft length / sample rate / dtype)
# ---------------------------------------------------------------------------

_CONST_CACHE: dict = {}


def hann_window(n: int) -> np.ndarray:
    """Symmetric Hann window, ``np.hanning`` parity (chroma.py:39,60)."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))


def frontend_constants(n_fft: int = FFT_LEN, fs: int = FS, dtype=np.float32):
    """(hann, dft_cos, dft_sin, filterbank_T) as device arrays.

    The real DFT is expressed as two (n_fft, n_fft//2+1) matmul factors so the
    transform runs as matmuls; ``rfft(x)[k] = x·cos_k − i·(x·sin_k)``.
    Created eagerly (never inside a trace) and cached.
    """
    key = (n_fft, fs, np.dtype(dtype).name)
    if key not in _CONST_CACHE:
        n = np.arange(n_fft, dtype=np.float64)[:, None]
        k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * n * k / n_fft
        _CONST_CACHE[key] = (
            jax.device_put(hann_window(n_fft).astype(dtype)),
            jax.device_put(np.cos(ang).astype(dtype)),
            jax.device_put(np.sin(ang).astype(dtype)),
            jax.device_put(np.ascontiguousarray(chroma_filterbank(fs, n_fft).T).astype(dtype)),
        )
    return _CONST_CACHE[key]


_HOST_CONST_CACHE: dict = {}


def host_frontend_constants(n_fft: int = FFT_LEN, fs: int = FS, dtype=np.float32):
    """(hann, filterbank_T) as HOST numpy arrays — the host-side twin of
    :func:`frontend_constants` for paths that compute chroma on the CPU and
    ship the 12-dim columns instead of raw samples (e.g. the WTW serving
    layers' ``transfer_dtype="chroma"``, where host→device bandwidth is the
    throughput ceiling).  The DFT runs as ``np.fft.rfft`` on the host, so no
    DFT matmul factors are materialized."""
    key = (n_fft, fs, np.dtype(dtype).name)
    if key not in _HOST_CONST_CACHE:
        _HOST_CONST_CACHE[key] = (
            hann_window(n_fft).astype(dtype),
            np.ascontiguousarray(chroma_filterbank(fs, n_fft).T).astype(dtype),
        )
    return _HOST_CONST_CACHE[key]


_HOST_FB2_CACHE: dict = {}


def _host_fb_interleaved(n_fft: int, fs: int) -> np.ndarray:
    """(2K, 12) float32 filterbank with each row doubled, matching the
    re,im interleaving of a complex64 buffer viewed as float32 — so
    ``v² @ fb2`` computes the power-spectrum projection directly from the
    squared complex components (f32 fast path of
    :func:`host_chroma_frames`)."""
    key = (n_fft, fs)
    if key not in _HOST_FB2_CACHE:
        _, fb_t = host_frontend_constants(n_fft, fs, np.float32)
        _HOST_FB2_CACHE[key] = np.ascontiguousarray(
            np.repeat(fb_t, 2, axis=0))
    return _HOST_FB2_CACHE[key]


#: worker threads for the f32 host-extraction pipeline: None = the
#: RTAS_HOST_FFT_WORKERS env var, else single-threaded.  The per-dispatch
#: host chroma is the serving-capacity floor (round-3 finding: 85% of the
#: B=256 chroma-transfer wall is single-core host FFT), so multi-core hosts
#: should set this to their core count.
_WORKERS_ENV = "RTAS_HOST_FFT_WORKERS"
_POOL = None
_POOL_SIZE = 0

import threading as _threading

_POOL_LOCK = _threading.Lock()


def _host_pool(workers: int):
    """Shared ThreadPoolExecutor, grown (never shrunk) under a lock.

    The old pool is NOT shut down on a resize: a concurrent caller that
    resolved it just before the swap may still submit chunks, and
    ``shutdown`` would make those submissions raise (ADVICE r4 item 4).
    Dropping the reference is safe — executor threads exit on their own
    once the executor is garbage-collected and its queue drains.  Shrink
    requests keep the larger pool (idle threads are harmless)."""
    global _POOL, _POOL_SIZE
    with _POOL_LOCK:
        if _POOL is None or workers > _POOL_SIZE:
            import concurrent.futures

            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="rtas-hostfft")
            _POOL_SIZE = workers
        return _POOL


def resolve_host_workers(workers=None) -> int:
    """Effective worker count: explicit arg > env flag > 1.

    A malformed env value falls back to 1 with a warning instead of
    crashing every host extraction call deep in the serving path
    (ADVICE r4 item 4)."""
    if workers is not None:
        return max(1, int(workers))
    env = os.environ.get(_WORKERS_ENV)
    if not env:
        return 1
    try:
        return max(1, int(env))
    except ValueError:
        import warnings

        warnings.warn(
            f"ignoring malformed {_WORKERS_ENV}={env!r} (expected an "
            "integer); running single-threaded")
        return 1


def host_chroma_frames(frames: np.ndarray, n_fft: int = FFT_LEN, fs: int = FS,
                       normalize: bool = True,
                       overwrite_frames: bool = False,
                       workers=None) -> np.ndarray:
    """(T, n_fft) raw frames → (12, T) chroma, entirely on the host.

    Same pipeline as :func:`_chroma_frames_impl` (window → rDFT → power →
    filterbank → L2 normalize) with the rDFT on the host instead of the
    device's two DFT matmuls.  Host and device differ in low-order float32
    bits (~1e-6 relative) — numerically equivalent, NOT bit-identical;
    callers that need bit-parity with device-extracted features must
    extract on device.

    For float32 frames the rDFT runs through ``scipy.fft`` (native-f32
    pocketfft — ~5x faster than ``np.fft.rfft``'s internally-f64 transform
    at serving batch sizes, where host extraction is the multi-stream
    chroma-transfer throughput ceiling), and the power spectrum never
    materializes: the complex64 buffer is squared in place as a float32
    view and projected through a re/im-interleaved copy of the filterbank
    (``Σ_k (re²+im²)·fb_k = Σ_k re²·fb_k + im²·fb_k``), saving the two
    strided ``.real``/``.imag`` copies and two elementwise passes that
    profiling showed cost as much as the FFT itself.  The f32 stages run
    cache-blocked over ~1 MB chunks of frames (window → rfft → square →
    project per chunk) so intermediates stay in L2 instead of streaming
    the whole batch through DRAM once per stage — measured 1.2-1.5x at
    T=2048.  Bit-identical to the monolithic pass when T fits one chunk;
    beyond that, within f32 rounding (~2e-6: BLAS picks different
    sgemm/gemv kernels per batch shape — the docs/PARITY.md deviation-8
    class this host path always had across dispatch sizes).  Float64
    frames (the CPU parity / debug dtype) keep ``np.fft.rfft`` and the
    explicit power spectrum so parity-test numerics are stable across
    scipy versions.

    ``overwrite_frames=True`` lets the window multiply run in place,
    destroying ``frames`` — only valid when the caller owns the buffer and
    its rows don't alias (NOT for the hop-strided overlapping views
    :func:`~real_time_audio_sync_tpu.models.wtw_async.host_chroma_block`
    builds, where an in-place multiply would corrupt later rows).  The
    cache-blocked f32 path windows into its own scratch buffer, so there
    the flag is accepted but never destroys ``frames``.

    ``workers`` (f32 path only): thread-pool the cache-blocked chunks —
    numpy/scipy release the GIL for the window multiply, the pocketfft
    transform and the sgemv projection, so on an N-core host extraction
    scales with N until memory bandwidth binds.  The chunk partitioning is
    IDENTICAL to the single-threaded sweep (threads pick up the same
    [i, j) chunks), so results are bit-identical for any worker count
    (tests/test_chroma.py).  Default: the RTAS_HOST_FFT_WORKERS env var,
    else single-threaded — this container has one core; serving hosts
    should set it to their core count (round-3 capacity finding: 85% of
    the B=256 chroma-transfer wall was single-core host FFT)."""
    dtype = np.dtype(frames.dtype)
    win, fb_t = host_frontend_constants(n_fft, fs, dtype)
    if dtype == np.float32:
        try:
            from scipy import fft as _sfft
        except ImportError:  # pragma: no cover - scipy is baked in
            _sfft = None
        if _sfft is not None:
            # Cache-blocked: window→rfft→square→project a chunk of frames
            # at a time so every stage's working set stays in L2 instead of
            # streaming the full (T, n_fft) batch through DRAM once per
            # stage — measured 1.2-1.5x at serving batch sizes (T=2048).
            # Numerics contract (pinned by
            # test_host_chroma_chunking_invariant): see the docstring.
            T = frames.shape[0]
            chunk = max(1, min(T or 1, (1 << 20) // (4 * n_fft)))  # ~1 MB
            fbi = _host_fb_interleaved(n_fft, fs)
            raw = np.empty((T, 12), np.float32)
            n_workers = min(resolve_host_workers(workers),
                            max(1, -(-T // chunk)))

            def _sweep(lo: int, hi: int, buf: np.ndarray) -> None:
                for i in range(lo, hi, chunk):
                    j = min(i + chunk, T)
                    b = buf[: j - i]
                    np.multiply(frames[i:j], win, out=b)
                    spec = _sfft.rfft(b, axis=1, overwrite_x=True,
                                      workers=1)
                    v = spec.view(np.float32)  # (chunk, 2K) re,im pairs
                    np.multiply(v, v, out=v)  # spec is dead past this point
                    np.matmul(v, fbi, out=raw[i:j])

            if n_workers <= 1:
                # in-FFT threading only (pocketfft splits the batch rows)
                def _sweep1(lo: int, hi: int, buf: np.ndarray) -> None:
                    for i in range(lo, hi, chunk):
                        j = min(i + chunk, T)
                        b = buf[: j - i]
                        np.multiply(frames[i:j], win, out=b)
                        spec = _sfft.rfft(b, axis=1, overwrite_x=True,
                                          workers=os.cpu_count() or 1)
                        v = spec.view(np.float32)
                        np.multiply(v, v, out=v)
                        np.matmul(v, fbi, out=raw[i:j])

                _sweep1(0, T, np.empty((chunk, n_fft), np.float32))
            else:
                # whole-chunk parallelism: every stage of a chunk runs on
                # one worker (window, fft, square, project all drop the
                # GIL); chunk boundaries are unchanged, so the output is
                # bit-identical to the single-threaded sweep
                n_chunks = -(-T // chunk)
                per = -(-n_chunks // n_workers)
                pool = _host_pool(n_workers)
                futs = [
                    pool.submit(_sweep, w * per * chunk,
                                min((w + 1) * per * chunk, T),
                                np.empty((chunk, n_fft), np.float32))
                    for w in range(n_workers)
                    if w * per * chunk < T
                ]
                for f in futs:
                    f.result()
        else:  # pragma: no cover - scipy is baked in
            wf = frames * win[None, :]
            spec = np.fft.rfft(wf, axis=1)
            v = spec.view(np.float32)
            np.multiply(v, v, out=v)
            raw = v @ _host_fb_interleaved(n_fft, fs)
    else:
        if overwrite_frames and frames.flags.writeable:
            wf = np.multiply(frames, win, out=frames)
        else:
            wf = frames * win[None, :]
        spec = np.fft.rfft(wf, axis=1)
        power = (spec.real.astype(dtype) ** 2 + spec.imag.astype(dtype) ** 2)
        raw = power @ fb_t  # (T, 12)
    if normalize:
        norm = np.sqrt(np.sum(raw * raw, axis=1, keepdims=True))
        tiny = np.finfo(dtype).tiny
        raw = raw / np.where(norm < tiny, np.ones_like(norm), norm)
    return np.ascontiguousarray(raw.T)


def num_frames(n_samples: int, n_fft: int = FFT_LEN, hop: int = HOP_SIZE) -> int:
    """Frame count of the reference STFT (chroma.py:49-54): the wav is
    left-padded with ``n_fft/2`` zeros, then ``int(((N - L)/H) + 1)`` hops
    (Python-2 floor division, preserved)."""
    padded = n_samples + n_fft // 2
    return max(0, (padded - n_fft) // hop + 1)


# ---------------------------------------------------------------------------
# Pure-JAX pipeline (jittable)
# ---------------------------------------------------------------------------


#: Matmul precision of the frontend.  HIGHEST keeps full f32: on the GPU an
#: f32 matmul may otherwise run in TF32 (~3 decimal digits), which moves
#: chroma by ~1e-3 against the f64 reference (docs/PARITY.md).
FRONTEND_PRECISION = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("normalize", "precision"))
def _chroma_frames_impl(frames, win, dft_cos, dft_sin, fb_t, normalize: bool = True,
                        precision=FRONTEND_PRECISION):
    """(T, n_fft) raw frames → (12, T) chroma.  One fused XLA program:
    window → two DFT matmuls → power → filterbank matmul → L2 normalize."""
    wf = frames * win[None, :]
    re = jnp.matmul(wf, dft_cos, precision=precision)
    im = jnp.matmul(wf, dft_sin, precision=precision)
    power = re * re + im * im  # (T, K)
    raw = jnp.matmul(power, fb_t, precision=precision)  # (T, 12)
    if normalize:
        norm = jnp.sqrt(jnp.sum(raw * raw, axis=1, keepdims=True))
        tiny = jnp.asarray(np.finfo(np.dtype(frames.dtype)).tiny, frames.dtype)
        raw = raw / jnp.where(norm < tiny, jnp.ones_like(norm), norm)
    return raw.T  # (12, T)


def chroma_frames(frames: jnp.ndarray, n_fft: int = FFT_LEN, fs: int = FS, normalize: bool = True) -> jnp.ndarray:
    """(T, n_fft) audio frames → (12, T) chroma.  Equivalent to the reference
    per-frame ``hann → rfft → |·|² → chromafb → L2-normalize`` chain
    (chroma.py:35-42, 67-75), batched over frames."""
    win, dft_cos, dft_sin, fb_t = frontend_constants(n_fft, fs, frames.dtype)
    return _chroma_frames_impl(frames, win, dft_cos, dft_sin, fb_t, normalize)


def frame_span(x: jnp.ndarray, t: int, n_fft: int, hop: int) -> jnp.ndarray:
    """Frame a contiguous sample span into (t, n_fft) hop windows — frame i
    is ``x[i·hop : i·hop+n_fft]``.  Trace-safe (static t).  When
    ``n_fft == 2·hop`` each frame is two consecutive half-frame blocks, so
    framing is a reshape + concat (zero gathers); otherwise a gather."""
    if n_fft == 2 * hop:
        blocks = x[: (t + 1) * hop].reshape(t + 1, hop)
        return jnp.concatenate([blocks[:-1], blocks[1:]], axis=1)
    idx = jnp.arange(t)[:, None] * hop + jnp.arange(n_fft)[None, :]
    return x[idx]


@partial(jax.jit, static_argnames=("n_fft", "hop", "normalize", "precision"))
def _chroma_pipeline_impl(wav, win, dft_cos, dft_sin, fb_t, n_fft: int, hop: int, normalize: bool = True,
                          precision=FRONTEND_PRECISION):
    t = num_frames(wav.shape[0], n_fft, hop)
    if t <= 0:
        return jnp.zeros((12, 0), wav.dtype)
    x = jnp.concatenate([jnp.zeros(n_fft // 2, wav.dtype), wav])
    frames = frame_span(x, t, n_fft, hop)
    return _chroma_frames_impl(frames, win, dft_cos, dft_sin, fb_t, normalize, precision)


def chroma_pipeline(wav: jnp.ndarray, n_fft: int = FFT_LEN, hop: int = HOP_SIZE, fs: int = FS, normalize: bool = True,
                    precision=FRONTEND_PRECISION) -> jnp.ndarray:
    """Full wav → (12, T) chroma pipeline as one jitted XLA program
    (``precision``: the DFT and filterbank matmuls', see FRONTEND_PRECISION)."""
    consts = frontend_constants(n_fft, fs, wav.dtype)
    return _chroma_pipeline_impl(wav, *consts, n_fft, hop, normalize, precision)


# ---------------------------------------------------------------------------
# Host API (reference surface: chroma.py:25,35,77)
# ---------------------------------------------------------------------------


_MIN_BUCKET = 1 << 15  # 32768 samples ≈ 1.5 s
_compiled_buckets: set = set()


def _bucket_len(n_samples: int) -> int:
    """Next power-of-two sample count ≥ n_samples (min ~1.5 s)."""
    b = _MIN_BUCKET
    while b < n_samples:
        b <<= 1
    return b


def compiled_bucket_count() -> int:
    """Distinct (bucket_length, dtype) chroma programs compiled so far —
    bench/corpus diagnostics for the one-compile-per-bucket guarantee."""
    return len(_compiled_buckets)


def chroma_from_samples(wav: np.ndarray, dtype=np.float32, normalize: bool = True, bucket: bool = True) -> np.ndarray:
    """22.05 kHz mono samples → (12, T) chroma, as numpy.

    ``bucket=True`` zero-pads the wav to the next power-of-two length before
    the jitted pipeline and slices the result back to the true frame count,
    so a corpus sweep compiles one program per length *bucket* instead of one
    per file (each fresh shape costs a compile).  Exact: every true frame lies entirely within the original
    (left-padded) signal — trailing pad zeros only produce extra frames,
    which are sliced off before return."""
    wav_np = np.asarray(wav)
    if wav_np.ndim != 1:
        raise TypeError(
            f"chroma_from_samples expects 1-D mono samples, got shape "
            f"{wav_np.shape}; average stereo to mono first (load_wav does), "
            f"and note a (12, T) chroma array is features, not samples")
    if bucket and wav_np.shape[0] > 0:
        t_true = num_frames(wav_np.shape[0])
        blen = _bucket_len(wav_np.shape[0])
        padded = np.zeros(blen, np.dtype(dtype))
        padded[: wav_np.shape[0]] = wav_np
        _compiled_buckets.add((blen, np.dtype(dtype).name))
        out = np.asarray(chroma_pipeline(jnp.asarray(padded), normalize=normalize))
        return out[:, :t_true]
    wav = jnp.asarray(wav_np, dtype)
    return np.asarray(chroma_pipeline(wav, normalize=normalize))


def wav_to_chroma(path_to_wav: str, dtype=np.float32) -> np.ndarray:
    """Reference ``wav_to_chroma`` (chroma.py:25-33): load → STFT → chroma."""
    wav, fs = load_wav(path_to_wav)
    assert fs == 22050
    return chroma_from_samples(wav, dtype)


def wav_to_chroma_col(wav_buf: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Reference ``wav_to_chroma_col`` (chroma.py:35-42): one fft_len-sample
    buffer → one 12-dim chroma column."""
    buf = np.asarray(wav_buf)
    assert buf.shape[-1] == FFT_LEN
    frames = jnp.asarray(buf, dtype).reshape(1, FFT_LEN)
    return np.asarray(chroma_frames(frames))[:, 0]


def create_stft(wav: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Reference ``create_stft`` (chroma.py:44-65): complex one-sided STFT,
    (1 + fft_len/2, T).  Same centered-pad/truncation semantics as the
    pipeline; the rfft runs as the two DFT matmuls (re − i·im)."""
    wav_np = np.asarray(wav)
    t = num_frames(wav_np.shape[0])
    if t <= 0:
        return np.zeros((FFT_LEN // 2 + 1, 0), complex)
    win, dft_cos, dft_sin, _ = frontend_constants(FFT_LEN, FS, dtype)
    x = np.concatenate([np.zeros(FFT_LEN // 2, np.dtype(dtype)), wav_np.astype(dtype)])
    idx = np.arange(t)[:, None] * HOP_SIZE + np.arange(FFT_LEN)[None, :]
    frames = jnp.asarray(x[idx])
    wf = frames * win[None, :]
    re = np.asarray(jnp.matmul(wf, dft_cos, precision=FRONTEND_PRECISION))
    im = np.asarray(jnp.matmul(wf, dft_sin, precision=FRONTEND_PRECISION))
    return (re - 1j * im).T  # (K, T)


def create_chroma(ft: np.ndarray, normalize: bool = True, dtype=np.float32) -> np.ndarray:
    """Reference ``create_chroma`` (chroma.py:67-75): one-sided spectrum →
    power → filterbank projection → optional per-frame L2 normalization."""
    spec = jnp.asarray(np.abs(np.asarray(ft)) ** 2, dtype)
    _, _, _, fb_t = frontend_constants(FFT_LEN, FS, dtype)
    raw = jnp.matmul(spec.T, fb_t, precision=FRONTEND_PRECISION).T  # (12, T)
    if not normalize:
        return np.asarray(raw)
    norm = jnp.sqrt(jnp.sum(raw * raw, axis=0, keepdims=True))
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)
    return np.asarray(raw / jnp.where(norm < tiny, jnp.ones_like(norm), norm))


def wav_to_chroma_diff(path_to_wav: str, dtype=np.float32) -> np.ndarray:
    """Reference ``wav_to_chroma_diff`` (chroma.py:77-90): half-wave-rectified
    temporal difference of the normalized chroma."""
    chroma = wav_to_chroma(path_to_wav, dtype)
    return np.clip(np.diff(chroma, axis=1), 0, np.inf)


def chroma_diff_from_samples(wav: np.ndarray, dtype=np.float32) -> np.ndarray:
    chroma = chroma_from_samples(wav, dtype)
    return np.clip(np.diff(chroma, axis=1), 0, np.inf)

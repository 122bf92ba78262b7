import numpy as np
import pytest

from real_time_audio_sync_tpu.features.chroma import wav_to_chroma_col
from real_time_audio_sync_tpu.models.wtw import WTW
from real_time_audio_sync_tpu.utils.wavio import load_wav

from tests.oracle import OracleWTW


def _synthetic_performance(seconds=12.0, fs=22050, seed=0):
    """A chord progression with varying note lengths — enough harmonic
    structure for chroma alignment to be meaningful."""
    rng = np.random.default_rng(seed)
    freqs = 220.0 * 2 ** (np.arange(12) / 12)
    t = np.arange(int(seconds * fs)) / fs
    out = np.zeros_like(t)
    pos = 0
    while pos < len(t):
        dur = int(fs * rng.uniform(0.4, 1.0))
        chord = rng.choice(12, size=3, replace=False)
        seg = slice(pos, min(pos + dur, len(t)))
        for k in chord:
            out[seg] += np.sin(2 * np.pi * freqs[k] * t[seg])
        pos += dur
    return (out / np.abs(out).max() * 0.5).astype(np.float64)


@pytest.fixture(scope="module")
def wtw_pair(tmp_path_factory):
    from real_time_audio_sync_tpu.utils.wavio import write_wav

    ref = _synthetic_performance(seconds=14.0, seed=1)
    # live: same audio, mildly resampled (tempo change) + noise
    idx = np.linspace(0, len(ref) - 1, int(len(ref) * 1.08))
    live = np.interp(idx, np.arange(len(ref)), ref)
    live = live + 0.01 * np.random.default_rng(2).standard_normal(len(live))
    d = tmp_path_factory.mktemp("wtw")
    ref_path = str(d / "ref.wav")
    write_wav(ref_path, ref)
    return ref_path, live.astype(np.float64)


WTW_PARAMS = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 10, "dtw_hop_size": 2048 * 10}


def test_wtw_matches_oracle_on_shared_features(wtw_pair):
    """Algorithm isolation: the oracle consumes our extractor's columns, so
    any path difference would be in the windowed-DTW/commit logic."""
    ref_path, live = wtw_pair
    engine = WTW(ref_path, WTW_PARAMS, dtype=np.float64)
    oracle = OracleWTW(
        engine.chroma_ref, 4096, 2048, 4096 * 10, 2048 * 10,
        col_fn=lambda sec: wav_to_chroma_col(sec, dtype=np.float64),
    )
    buffers = np.array_split(live, 512)  # harness-style chunking (tests.py:186)
    for buf in buffers:
        got = engine.insert(buf.tolist())
        want = oracle.insert(buf.tolist())
        assert got == want
        if got == "stop":
            break
    assert engine.path == [tuple(p) for p in oracle.path]
    assert engine.live_ptr == oracle.live_ptr
    assert engine.ref_ptr == oracle.ref_ptr
    assert engine.chroma_ptr == oracle.chroma_ptr


def test_sample_fifo_semantics():
    from real_time_audio_sync_tpu.models.wtw import SampleFIFO

    fifo = SampleFIFO(np.float32, capacity=16)
    stream = np.arange(1000, dtype=np.float32)
    consumed = 0
    fed = 0
    rng = np.random.default_rng(3)
    out = []
    while consumed < 900:
        if fed < len(stream):
            n = int(rng.integers(1, 50))
            fifo.extend(stream[fed : fed + n])
            fed += n
        take = min(len(fifo), int(rng.integers(1, 30)))
        out.append(fifo.view(take).copy())
        fifo.consume(take)
        consumed += take
    got = np.concatenate(out)
    np.testing.assert_array_equal(got, stream[: len(got)])
    # round-trip for checkpointing
    rest = fifo.to_array()
    np.testing.assert_array_equal(rest, stream[len(got) : len(got) + len(rest)])


def test_wtw_array_ingestion_and_no_canvas_match_list_path(wtw_pair):
    """ndarray ingestion (no .tolist()) and keep_acc_canvas=False produce the
    identical committed path to the list-fed, canvas-keeping engine."""
    ref_path, live = wtw_pair
    a = WTW(ref_path, WTW_PARAMS, dtype=np.float64)
    b = WTW(ref_path, WTW_PARAMS, dtype=np.float64, keep_acc_canvas=False)
    assert b.acc_cost is None
    for buf in np.array_split(live, 256):
        ra = a.insert(buf.tolist())
        rb = b.insert(buf)
        assert ra == rb
        if ra == "stop":
            break
    assert a.path == b.path
    assert a.acc_cost is not None


def test_wtw_path_properties(wtw_pair):
    ref_path, live = wtw_pair
    engine = WTW(ref_path, WTW_PARAMS, dtype=np.float64)
    for buf in np.array_split(live, 512):
        if engine.insert(buf.tolist()) == "stop":
            break
    p = np.array(engine.path)
    assert len(p) > 10
    # windowed commits are monotone in both axes
    assert np.all(np.diff(p[:, 0]) >= 0)
    assert np.all(np.diff(p[:, 1]) >= 0)
    # the tempo ratio is ~1.08: committed path slope should be near that
    slope = (p[-1, 0] - p[0, 0]) / max(1, p[-1, 1] - p[0, 1])
    assert 0.9 < slope < 1.3


def test_wtw_stop_on_short_reference(wtw_pair):
    ref_path, live = wtw_pair
    engine = WTW(ref_path, WTW_PARAMS, dtype=np.float64)
    long_live = np.concatenate([live, live, live])
    stopped = False
    for buf in np.array_split(long_live, 1024):
        if engine.insert(buf.tolist()) == "stop":
            stopped = True
            break
    assert stopped
    # reference semantics: a small insert that doesn't fill fft_len returns
    # None (wtw.py:81 loop never runs); a full frame re-triggers the stop
    assert engine.insert([0.0] * 100) is None
    assert engine.insert([0.0] * 8192) == "stop"


def test_wtw_real_audio_accuracy(chopin_pair):
    """End-to-end on the real Chopin pair with the live-app window size
    (wtw_live.py:106): accuracy should sit in the recorded field-test regime
    (0-4% off by >1 beat, 0% >3 — BASELINE.md)."""
    from real_time_audio_sync_tpu.eval import PathScorer

    ref_wav, live_wav = chopin_pair
    params = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 50, "dtw_hop_size": 2048 * 50}
    engine = WTW(ref_wav, params, dtype=np.float64)
    live, fs = load_wav(live_wav)
    for buf in np.array_split(live, 4096):
        if engine.insert(buf.tolist()) == "stop":
            break
    result = PathScorer.for_pair(ref_wav, live_wav).score(engine.path)
    # Pinned to the recorded field regime (BASELINE.md: 0-4% >1 beat, 0% >3);
    # this offline replay currently scores 0.0% in every bucket.
    assert result.pct_off_beats[1] <= 4.1
    assert result.pct_off_beats[3] == 0.0


def test_wtw_rejects_degenerate_hop():
    """dtw_hop_size < hop_size would make the window loop non-advancing
    (the reference would hang, wtw.py:100-128) — rejected up front."""
    from real_time_audio_sync_tpu.config import WTWParams

    with pytest.raises(ValueError, match="dtw_hop_size"):
        WTWParams(fft_len=4096, hop_size=2048, dtw_win_size=4096 * 5, dtw_hop_size=1024)


# ---------------------------------------------------------------------------
# AsyncWTW — device-resident streaming engine (models/wtw_async.py)


def test_async_wtw_matches_host_path(wtw_pair):
    """The fully on-device stepper commits the identical path and ends at the
    identical pointers as the host engine (which is itself oracle-parity
    tested above), including a ragged flush tail."""
    from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW

    ref_path, live = wtw_pair
    host = WTW(ref_path, WTW_PARAMS, dtype=np.float64)
    for buf in np.array_split(live, 256):
        if host.insert(buf) == "stop":
            break

    eng = AsyncWTW(ref_path, WTW_PARAMS, k_block=8)
    for buf in np.array_split(live, 256):
        if eng.insert(buf) == "stop":
            break
    eng.flush()
    assert eng.path == host.path
    assert eng.pointers == (host.chroma_ptr, host.live_ptr, host.ref_ptr)
    # last_point tracks (path_len, live, ref) of the committed head
    plen, lx, ly = eng.last_point
    assert plen == len(host.path)
    assert (lx, ly) == host.path[-1]


def test_async_wtw_block_size_invariance(wtw_pair):
    """k_block only changes dispatch batching, never the committed path.

    Compared in float64: different k_block means different chroma-matmul
    batch shapes, and f32 accumulation is batch-shape-dependent (PARITY.md
    deviation 8) — the ~2e-6 differences can flip knife-edge DP ties, which
    is a property of f32, not of the dispatch batching under test."""
    from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW

    ref_path, live = wtw_pair
    paths = []
    for k_block in (1, 16):
        eng = AsyncWTW(ref_path, WTW_PARAMS, k_block=k_block, dtype=np.float64)
        for buf in np.array_split(live, 100):
            if eng.insert(buf) == "stop":
                break
        eng.flush()
        paths.append(eng.path)
    assert paths[0] == paths[1]


def test_async_wtw_stop_parity(wtw_pair):
    """Overlong live audio: the stop flag surfaces through the status vector
    (lazily; post-stop columns are frozen in-program) with the same final
    path/pointers as the host engine."""
    from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW

    ref_path, live = wtw_pair
    long_live = np.concatenate([live, live, live])
    host = WTW(ref_path, WTW_PARAMS, dtype=np.float64)
    for buf in np.array_split(long_live, 512):
        if host.insert(buf) == "stop":
            break

    eng = AsyncWTW(ref_path, WTW_PARAMS, k_block=8)
    for buf in np.array_split(long_live, 512):
        if eng.insert(buf) == "stop":
            break
    assert eng.flush() == "stop"
    assert eng.insert(np.zeros(8192)) == "stop"  # sticky, like the reference
    assert eng.path == host.path
    assert eng.pointers[1:] == (host.live_ptr, host.ref_ptr)


def test_async_wtw_backend_invariance(wtw_pair):
    """Every window-DP backend (scan / unroll) commits the identical path —
    the backend only changes how the w x w DP is traced, never its result."""
    from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW

    ref_path, live = wtw_pair
    paths, ptrs = [], []
    for backend in ("scan", "unroll"):
        eng = AsyncWTW(ref_path, WTW_PARAMS, k_block=8, window_backend=backend,
                       dtype=np.float64)
        for buf in np.array_split(live, 100):
            if eng.insert(buf) == "stop":
                break
        eng.flush()
        paths.append(eng.path)
        ptrs.append(eng.pointers)
    assert paths[0] == paths[1]
    assert ptrs[0] == ptrs[1]


@pytest.mark.parametrize("hop_mult", [10, 1])
def test_async_wtw_hoisted_matches_cols_impl(wtw_pair, hop_mult):
    """The hoisted block body (batched append + predicated window slots) is
    bit-identical to the per-column scan body — including hop_frames=1,
    where every appended column triggers a window (maximum slots per block),
    and the overlong-audio stop path."""
    from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW

    params = {"fft_len": 4096, "hop_size": 2048,
              "dtw_win_size": 4096 * 5, "dtw_hop_size": 2048 * hop_mult}
    ref_path, live = wtw_pair
    long_live = np.concatenate([live, live])  # crosses the stop margin
    results = {}
    for impl in ("cols", "hoisted"):
        eng = AsyncWTW(ref_path, params, k_block=8, dtype=np.float64,
                       block_impl=impl)
        for buf in np.array_split(long_live, 173):  # unaligned chunking
            if eng.insert(buf) == "stop":
                break
        eng.flush()
        results[impl] = (eng.path, eng.pointers, eng.last_point)
    assert results["hoisted"] == results["cols"]
    host = WTW(ref_path, params, dtype=np.float64)
    for buf in np.array_split(long_live, 173):
        if host.insert(buf) == "stop":
            break
    assert results["hoisted"][0] == host.path
    assert results["hoisted"][1][1:] == (host.live_ptr, host.ref_ptr)


def test_short_reference_rejected_up_front():
    """A reference shorter than one DTW window must raise a clear ValueError
    at construction (the fixed-shape window kernels slice exactly w columns;
    the reference impl would silently run a degenerate short window), not a
    deep jit-time slice error."""
    from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW
    from real_time_audio_sync_tpu.parallel.wtw_serving import MultiStreamWTW

    short = np.zeros(2048 * 10, np.float32)  # ~10 frames < w=20
    short[::3] = 0.5
    for ctor in (lambda: WTW(short, WTW_PARAMS),
                 lambda: AsyncWTW(short, WTW_PARAMS),
                 lambda: MultiStreamWTW([short], WTW_PARAMS)):
        with pytest.raises(ValueError, match="reference too short for WTW"):
            ctor()


def test_chroma_from_samples_rejects_non_mono():
    """2-D input (stereo, or a chroma array mistaken for samples) must be a
    TypeError, not silently-garbled features."""
    from real_time_audio_sync_tpu.features.chroma import chroma_from_samples

    with pytest.raises(TypeError, match="1-D mono samples"):
        chroma_from_samples(np.zeros((12, 380), np.float32))
    with pytest.raises(TypeError, match="1-D mono samples"):
        chroma_from_samples(np.zeros((22050, 2), np.float32))


def test_wtw_long_reference_warns():
    """r4 verdict #7: WTW pointed far beyond its ~35 s validated regime must
    warn loudly (the measured multi-minute collapse, docs/ACCURACY.md); the
    excerpt-scale regime must stay silent."""
    import warnings

    from real_time_audio_sync_tpu.models.wtw import (
        WTW,
        WTWLongReferenceWarning,
    )

    rng = np.random.default_rng(0)
    params = {"fft_len": 4096, "hop_size": 2048,
              "dtw_win_size": 4096 * 10, "dtw_hop_size": 2048 * 10}
    long_ref = rng.standard_normal(22050 * 120).astype(np.float32) * 0.1
    with pytest.warns(WTWLongReferenceWarning, match="35 s regime"):
        WTW(long_ref, params)

    short_ref = rng.standard_normal(22050 * 35).astype(np.float32) * 0.1
    with warnings.catch_warnings():
        warnings.simplefilter("error", WTWLongReferenceWarning)
        WTW(short_ref, params)

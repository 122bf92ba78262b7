"""Auxiliary subsystems: WTW offline evaluator, checkpoint/resume, audio
config."""

import numpy as np
import pytest

from real_time_audio_sync_tpu.eval.wtw_offline import WTWOfflineEvaluator
from real_time_audio_sync_tpu.models import LiveNote, OnlineTimeWarping
from real_time_audio_sync_tpu.streaming.audio_config import (
    DEFAULTS,
    load_audio_config,
    save_audio_config,
)
from real_time_audio_sync_tpu.utils.checkpoint import load_state, save_state

from tests.test_online import _make_pair


def test_wtw_offline_evaluator_real_pair(chopin_pair):
    ref_wav, live_wav = chopin_pair
    ev = WTWOfflineEvaluator(
        ref_wav, live_wav,
        params={"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 10, "dtw_hop_size": 2048 * 10},
        dtype=np.float64,
    )
    err = ev.evaluate(buf_size=4096)
    assert err.count > 100
    # wtw-style interpolation buckets; field runs recorded 0-4% >1 beat
    assert err.pct_off_beats[1] < 10.0
    assert err.pct_off_beats[3] < 2.0
    assert err.pct_off_beats[10] == 0.0
    assert err.squared_beat_error >= 0


def test_checkpoint_resume_mid_stream(tmp_path):
    rng = np.random.default_rng(17)
    ref, live = _make_pair(rng)
    params = {"c": 10, "max_run_count": 3}

    full = OnlineTimeWarping(ref, params, dtype=np.float64)
    for i in range(live.shape[1]):
        if full.insert(live[:, i]) == "stop":
            break

    # run half, checkpoint, restore into a fresh engine, run the rest
    half = live.shape[1] // 2
    first = OnlineTimeWarping(ref, params, dtype=np.float64)
    for i in range(half):
        first.insert(live[:, i])
    ckpt = str(tmp_path / "state.npz")
    save_state(first, ckpt)

    resumed = OnlineTimeWarping(ref, params, dtype=np.float64)
    load_state(resumed, ckpt)
    for i in range(half, live.shape[1]):
        if resumed.insert(live[:, i]) == "stop":
            break

    assert [tuple(p) for p in resumed.path] == [tuple(p) for p in full.path]
    assert resumed.live_ptr == full.live_ptr


def test_fused_engine_checkpoint_resume(tmp_path):
    """Checkpoint/resume of the fused streaming engine's persistent device
    state (live ring, band vectors, path, scalars)."""
    from real_time_audio_sync_tpu.models.fused_streaming import FusedStreamingEngine
    from real_time_audio_sync_tpu.utils.checkpoint import load_fused_state, save_fused_state

    rng = np.random.default_rng(18)
    ref, live = _make_pair(rng)
    params = {"c": 10, "max_run_count": 3}
    half = (live.shape[1] // 2 // 4) * 4  # block-aligned split

    full = FusedStreamingEngine(ref, params, k_block=4, interpret=True)
    for s in range(0, live.shape[1], 4):
        full.insert_block_nowait(live[:, s : s + 4])
    full.flush()

    first = FusedStreamingEngine(ref, params, k_block=4, interpret=True)
    for s in range(0, half, 4):
        first.insert_block_nowait(live[:, s : s + 4])
    first.flush()
    ckpt = str(tmp_path / "fused.npz")
    save_fused_state(first, ckpt)

    resumed = FusedStreamingEngine(ref, params, k_block=4, interpret=True)
    load_fused_state(resumed, ckpt)
    for s in range(half, live.shape[1], 4):
        resumed.insert_block_nowait(live[:, s : s + 4])
    resumed.flush()
    np.testing.assert_array_equal(resumed.path_array, full.path_array)


def test_checkpoint_wrong_reference_rejected(tmp_path):
    rng = np.random.default_rng(18)
    ref, live = _make_pair(rng)
    other_ref, _ = _make_pair(np.random.default_rng(19))
    params = {"search_band_width": 10, "max_run_count": 3}
    a = LiveNote(ref, params, dtype=np.float64)
    a.insert(live[:, 0])
    ckpt = str(tmp_path / "s.npz")
    save_state(a, ckpt)
    b = LiveNote(other_ref, params, dtype=np.float64)
    with pytest.raises(ValueError):
        load_state(b, ckpt)


def test_audio_config_roundtrip(tmp_path):
    path = str(tmp_path / "audio_config.cfg")
    # missing file → defaults (ims/audio.py:155-166)
    cfg = load_audio_config(path)
    assert cfg == DEFAULTS
    cfg["buffersize"] = 1024
    cfg["outputdevice"] = None
    save_audio_config(cfg, path)
    cfg2 = load_audio_config(path)
    assert cfg2["buffersize"] == 1024
    assert cfg2["outputdevice"] is None  # 'None' string round-trips
    # invalid device index is reset against the (backend-less) device list
    cfg2["inputdevice"] = 99
    save_audio_config(cfg2, path)
    assert load_audio_config(path)["inputdevice"] is None


def test_wtw_checkpoint_resume(tmp_path):
    from real_time_audio_sync_tpu.models.wtw import WTW
    from real_time_audio_sync_tpu.utils.checkpoint import load_wtw_state, save_wtw_state
    from real_time_audio_sync_tpu.utils.wavio import write_wav
    from tests.test_wtw import _synthetic_performance, WTW_PARAMS

    ref = _synthetic_performance(seconds=12.0, seed=3)
    idx = np.linspace(0, len(ref) - 1, int(len(ref) * 1.05))
    live = np.interp(idx, np.arange(len(ref)), ref)
    ref_path = str(tmp_path / "ref.wav")
    write_wav(ref_path, ref)

    chunks = np.array_split(live, 256)
    full = WTW(ref_path, WTW_PARAMS, dtype=np.float64)
    for buf in chunks:
        if full.insert(buf.tolist()) == "stop":
            break

    half = len(chunks) // 2
    first = WTW(ref_path, WTW_PARAMS, dtype=np.float64)
    for buf in chunks[:half]:
        first.insert(buf.tolist())
    ckpt = str(tmp_path / "wtw.npz")
    save_wtw_state(first, ckpt)
    resumed = WTW(ref_path, WTW_PARAMS, dtype=np.float64)
    load_wtw_state(resumed, ckpt)
    for buf in chunks[half:]:
        if resumed.insert(buf.tolist()) == "stop":
            break
    assert resumed.path == full.path
    assert resumed.live_ptr == full.live_ptr and resumed.ref_ptr == full.ref_ptr


def test_async_wtw_checkpoint_resume(tmp_path):
    """AsyncWTW device state round-trips through .npz: resuming in a fresh
    engine continues to the identical committed path and pointers."""
    from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW
    from real_time_audio_sync_tpu.utils.checkpoint import (
        load_async_wtw_state,
        save_async_wtw_state,
    )
    from real_time_audio_sync_tpu.utils.wavio import write_wav
    from tests.test_wtw import _synthetic_performance, WTW_PARAMS

    ref = _synthetic_performance(seconds=12.0, seed=3)
    idx = np.linspace(0, len(ref) - 1, int(len(ref) * 1.05))
    live = np.interp(idx, np.arange(len(ref)), ref)
    ref_path = str(tmp_path / "ref.wav")
    write_wav(ref_path, ref)

    chunks = np.array_split(live, 173)  # unaligned chunking
    full = AsyncWTW(ref_path, WTW_PARAMS, k_block=8, dtype=np.float64)
    for buf in chunks:
        if full.insert(buf) == "stop":
            break
    full.flush()

    half = len(chunks) // 2
    first = AsyncWTW(ref_path, WTW_PARAMS, k_block=8, dtype=np.float64)
    for buf in chunks[:half]:
        first.insert(buf)
    ckpt = str(tmp_path / "awtw.npz")
    save_async_wtw_state(first, ckpt)
    resumed = AsyncWTW(ref_path, WTW_PARAMS, k_block=8, dtype=np.float64)
    load_async_wtw_state(resumed, ckpt)
    for buf in chunks[half:]:
        if resumed.insert(buf) == "stop":
            break
    resumed.flush()
    assert resumed.path == full.path
    assert resumed.pointers == full.pointers

    other = AsyncWTW(ref_path, {**WTW_PARAMS, "dtw_win_size": 4096 * 5},
                     k_block=8, dtype=np.float64)
    with pytest.raises(ValueError):
        load_async_wtw_state(other, ckpt)


def test_fused_multistream_checkpoint_resume(tmp_path):
    """Serving-scale checkpoint: a FusedMultiStreamFollower snapshot (all B
    streams' banded state in one .npz) restores into a fresh follower that
    continues to paths bit-equal to an uninterrupted run."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower
    from real_time_audio_sync_tpu.utils.checkpoint import (
        load_multi_stream_state,
        save_multi_stream_state,
    )
    from tests.test_parallel import FMS_PARAMS, _make_pair, _solo_fused_path

    rng = np.random.default_rng(7)
    pairs = [_make_pair(rng, n_ref=30 + 5 * i, stretch=1.15) for i in range(2)]
    solo = [_solo_fused_path(r, l) for r, l in pairs]
    refs = [r for r, _ in pairs]
    lives = [l for _, l in pairs]
    tmax = max(l.shape[1] for l in lives)

    def feed_range(fms, lo, hi):
        for t in range(lo, hi):
            cols = np.zeros((2, 12), np.float32)
            act = np.zeros(2, bool)
            for i, l in enumerate(lives):
                if t < l.shape[1]:
                    cols[i], act[i] = l[:, t], True
            fms.feed(cols, act)

    first = FusedMultiStreamFollower(refs, FMS_PARAMS, k_block=8, interpret=True)
    feed_range(first, 0, tmax // 2)
    ckpt = str(tmp_path / "fms.npz")
    save_multi_stream_state(first, ckpt)

    resumed = FusedMultiStreamFollower(refs, FMS_PARAMS, k_block=8, interpret=True)
    load_multi_stream_state(resumed, ckpt)
    feed_range(resumed, tmax // 2, tmax)
    resumed.flush()
    for p, s in zip(resumed.paths(), solo):
        np.testing.assert_array_equal(p, s)

    other = FusedMultiStreamFollower(refs, FMS_PARAMS, k_block=4, interpret=True)
    with pytest.raises(ValueError):
        load_multi_stream_state(other, ckpt)


def test_multistream_wtw_checkpoint_resume(tmp_path):
    """MultiStreamWTW snapshot (device state + every stream's sample FIFO)
    restores to paths and pointers equal to an uninterrupted run."""
    from real_time_audio_sync_tpu.parallel import MultiStreamWTW
    from real_time_audio_sync_tpu.utils.checkpoint import (
        load_multi_wtw_state,
        save_multi_wtw_state,
    )
    from real_time_audio_sync_tpu.utils.wavio import write_wav
    from tests.test_wtw import WTW_PARAMS, _synthetic_performance

    ref = _synthetic_performance(seconds=10.0, seed=11)
    idx = np.linspace(0, len(ref) - 1, int(len(ref) * 1.07))
    live = np.interp(idx, np.arange(len(ref)), ref)
    ref_path = str(tmp_path / "ref.wav")
    write_wav(ref_path, ref)

    chunks = np.array_split(live, 131)  # unaligned chunking
    full = MultiStreamWTW([ref_path] * 2, WTW_PARAMS, k_block=8, dtype=np.float64)
    for buf in chunks:
        full.insert([buf, buf])
    full.flush()

    half = len(chunks) // 2
    first = MultiStreamWTW([ref_path] * 2, WTW_PARAMS, k_block=8, dtype=np.float64)
    for buf in chunks[:half]:
        first.insert([buf, buf])
    ckpt = str(tmp_path / "mswtw.npz")
    save_multi_wtw_state(first, ckpt)

    resumed = MultiStreamWTW([ref_path] * 2, WTW_PARAMS, k_block=8, dtype=np.float64)
    load_multi_wtw_state(resumed, ckpt)
    for buf in chunks[half:]:
        resumed.insert([buf, buf])
    resumed.flush()
    assert resumed.paths() == full.paths()
    assert resumed.pointers() == full.pointers()

    # "auto" resolves from host timing probes: compare against a mode that
    # differs from whatever the snapshot resolved to
    mode = "float32" if first.transfer_dtype == "int16" else "int16"
    other = MultiStreamWTW([ref_path] * 2, WTW_PARAMS, k_block=8,
                           dtype=np.float64, transfer_dtype=mode)
    with pytest.raises(ValueError):
        load_multi_wtw_state(other, ckpt)


def test_load_state_resets_polling_and_stop(tmp_path):
    """Regression: restoring a snapshot must clear pre-restore polling state
    (stale in-flight statuses would be consumed against the restored state)
    and carry the sticky stop flag, like the fused/WTW loaders do."""
    rng = np.random.default_rng(23)
    ref, live = _make_pair(rng, n_ref=30)
    params = {"c": 8, "max_run_count": 3}

    done = OnlineTimeWarping(ref, params)
    r = None
    for i in range(4 * live.shape[1]):  # repeat columns until ref exhausts
        r = done.insert(live[:, i % live.shape[1]])
        if r == "stop":
            break
    assert r == "stop" and done._stopped_cached
    ckpt = str(tmp_path / "stopped.npz")
    save_state(done, ckpt)

    # restore into an engine mid-stream with UNPOLLED pipelined dispatches
    used = OnlineTimeWarping(ref, params)
    used.poll_min_interval = 1e9  # keep dispatched statuses un-harvested
    for i in range(5):
        used.insert_nowait(live[:, i])
    assert used._outstanding or used._latest_done is not None
    load_state(used, ckpt)
    assert used._outstanding == [] and used._latest_done is None
    assert used._stopped_cached
    assert used.insert(live[:, 0]) == "stop"  # frozen, reference-exhausted
    assert [tuple(p) for p in used.path] == [tuple(p) for p in done.path]


def test_load_state_restores_batch_mode(tmp_path):
    """.path's return type (array after set_live, list of tuples after
    streaming — otw_eran.py:142) follows the mode the SNAPSHOT was taken
    in, not whatever the target engine last ran."""
    rng = np.random.default_rng(29)
    ref, live = _make_pair(rng, n_ref=24)
    params = {"c": 8, "max_run_count": 3}

    batch = OnlineTimeWarping(ref, params)
    batch.set_live(live)
    ck_batch = str(tmp_path / "batch.npz")
    save_state(batch, ck_batch)

    stream = OnlineTimeWarping(ref, params)
    for i in range(4):
        stream.insert(live[:, i])
    ck_stream = str(tmp_path / "stream.npz")
    save_state(stream, ck_stream)

    target = OnlineTimeWarping(ref, params)
    for i in range(4):
        target.insert(live[:, i])  # streaming mode before the restore
    target.poll_min_interval = 0.123  # tuned setting must survive a restore
    load_state(target, ck_batch)
    assert isinstance(target.path, np.ndarray)
    np.testing.assert_array_equal(target.path, batch.path)
    assert target.poll_min_interval == 0.123

    target2 = OnlineTimeWarping(ref, params)
    target2.set_live(live)  # batch mode before the restore
    load_state(target2, ck_stream)
    assert isinstance(target2.path, list)
    assert target2.path == stream.path


def test_checkpoint_param_mismatch_rejected(tmp_path):
    """c / max_run_count change no validated SHAPE (acc is (2N, N), live is
    (F, 2N)), so without the explicit field check a band-width mismatch
    restores silently and misaligns."""
    rng = np.random.default_rng(31)
    ref, live = _make_pair(rng, n_ref=24)
    a = OnlineTimeWarping(ref, {"c": 10, "max_run_count": 3})
    a.insert(live[:, 0])
    ckpt = str(tmp_path / "c10.npz")
    save_state(a, ckpt)
    with pytest.raises(ValueError, match="checkpoint c 10"):
        load_state(OnlineTimeWarping(ref, {"c": 8, "max_run_count": 3}), ckpt)
    with pytest.raises(ValueError, match="max_run_count"):
        load_state(OnlineTimeWarping(ref, {"c": 10, "max_run_count": 2}), ckpt)


def test_fused_checkpoint_k_block_mismatch_rejected(tmp_path):
    """Fused state shapes are k_block-independent, so the explicit field
    check is what rejects a mismatched engine."""
    from real_time_audio_sync_tpu.models.fused_streaming import FusedStreamingEngine
    from real_time_audio_sync_tpu.utils.checkpoint import load_fused_state, save_fused_state

    rng = np.random.default_rng(33)
    ref, live = _make_pair(rng, n_ref=24)
    params = {"c": 8, "max_run_count": 3}
    a = FusedStreamingEngine(ref, params, k_block=4, interpret=True)
    a.insert_block_nowait(live[:, :4])
    a.flush()
    ckpt = str(tmp_path / "k4.npz")
    save_fused_state(a, ckpt)
    b = FusedStreamingEngine(ref, params, k_block=8, interpret=True)
    with pytest.raises(ValueError, match="k_block"):
        load_fused_state(b, ckpt)


def test_last_point_thread_safe_drain():
    """last_point is documented for UI-thread polling while the audio thread
    dispatches: both paths drain the single-slot harvest future, which must
    be claimed atomically (a lost race used to .result() a None future)."""
    import threading

    rng = np.random.default_rng(37)
    ref, live = _make_pair(rng, n_ref=40)
    eng = OnlineTimeWarping(ref, {"c": 10, "max_run_count": 3})
    eng.poll_min_interval = 0.0  # harvest at every opportunity
    errors = []
    stop = threading.Event()

    def ui_reader():
        try:
            while not stop.is_set():
                _ = eng.last_point, eng.last_point_age_frames
        except Exception as e:  # pragma: no cover - the regression itself
            errors.append(e)

    readers = [threading.Thread(target=ui_reader) for _ in range(2)]
    for t in readers:
        t.start()
    try:
        for i in range(live.shape[1]):
            if eng.insert_nowait(live[:, i]) == "stop":
                break
        eng.flush()
    finally:
        stop.set()
        for t in readers:
            t.join(5)
    assert not errors, errors


def test_async_wtw_f32_checkpoint_resume(tmp_path):
    """float32 AsyncWTW state (the device dtype: live chromagram, path
    buffers, scalars, host FIFO) round-trips through .npz with unaligned
    chunking: resuming in a fresh engine continues to the identical
    committed path and pointers; config mismatches are rejected."""
    from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW
    from real_time_audio_sync_tpu.utils.checkpoint import (
        load_async_wtw_state,
        save_async_wtw_state,
    )
    from real_time_audio_sync_tpu.utils.wavio import write_wav
    from tests.test_wtw import _synthetic_performance, WTW_PARAMS

    ref = _synthetic_performance(seconds=12.0, seed=3)
    idx = np.linspace(0, len(ref) - 1, int(len(ref) * 1.05))
    live = np.interp(idx, np.arange(len(ref)), ref).astype(np.float32)
    ref_path = str(tmp_path / "ref.wav")
    write_wav(ref_path, ref)

    chunks = np.array_split(live, 97)  # unaligned chunking
    full = AsyncWTW(ref_path, WTW_PARAMS, k_block=8)
    for buf in chunks:
        if full.insert(buf) == "stop":
            break
    full.flush()

    half = len(chunks) // 2
    first = AsyncWTW(ref_path, WTW_PARAMS, k_block=8)
    for buf in chunks[:half]:
        first.insert(buf)
    ckpt = str(tmp_path / "awtw32.npz")
    save_async_wtw_state(first, ckpt)
    resumed = AsyncWTW(ref_path, WTW_PARAMS, k_block=8)
    load_async_wtw_state(resumed, ckpt)
    for buf in chunks[half:]:
        if resumed.insert(buf) == "stop":
            break
    resumed.flush()
    assert resumed.path == full.path
    assert resumed.pointers == full.pointers

    # geometry / config mismatches must be rejected, not silently restored
    other = AsyncWTW(ref_path, {**WTW_PARAMS, "dtw_win_size": 4096 * 5}, k_block=8)
    with pytest.raises(ValueError):
        load_async_wtw_state(other, ckpt)
    kb = AsyncWTW(ref_path, WTW_PARAMS, k_block=4)
    with pytest.raises(ValueError, match="k_block"):
        load_async_wtw_state(kb, ckpt)
    f64 = AsyncWTW(ref_path, WTW_PARAMS, k_block=8, dtype=np.float64)
    with pytest.raises(ValueError):
        load_async_wtw_state(f64, ckpt)

import pathlib

import numpy as np
import pytest

from real_time_audio_sync_tpu.eval import (
    GroundTruth,
    PathScorer,
    get_beat,
    parse_field_log,
    path_from_field_log,
    write_field_log,
)
from real_time_audio_sync_tpu.eval.logs import parse_summary_percentages

REF = pathlib.Path("/root/reference")
CHOPIN_REF_CSV = REF / "Songs/chopin/chopin_rubinstein_20b.csv"
CHOPIN_LIVE_CSV = REF / "Songs/chopin/chopin_rachmaninoff_20b.csv"

# The three recorded WTW field runs whose accuracy summaries were committed
# (BASELINE.md): our scorer must reproduce those numbers from the recorded
# paths bit-for-bit.
GOLDEN_LOGS = [
    "tests/wtw_test_live_1523037133.83.txt",
    "tests/wtw_test_live_1523037937.86.txt",
    "tests/wtw_test_live_1523038919.13.txt",
]


def test_ground_truth_csv_loading(reference_root):
    gt = GroundTruth.from_csv(str(CHOPIN_REF_CSV))
    assert len(gt.times) == len(gt.beats) > 0
    assert gt.times == sorted(gt.times)
    two_col = GroundTruth.from_csv(str(REF / "Songs/bach/bach_01.csv"))
    assert two_col.labels is None
    bso = GroundTruth.from_csv(str(REF / "Songs/bso/bso_01.csv"))
    assert bso.labels is not None and len(bso.labels) == len(bso.times)


def test_get_beat_interpolation():
    times = [0.0, 1.0, 2.0]
    beats = [1, 2, 3]
    # frame 0 → time 0 → first annotation exactly
    assert get_beat(0, times, beats) == 1
    # halfway between annotations 1 and 2
    sample = 1.5 / (2048 / 22050.0)
    assert abs(get_beat(sample, times, beats) - 2.5) < 1e-9
    # past the end → None
    assert get_beat(1e9, times, beats) is None


@pytest.mark.parametrize("log_rel", GOLDEN_LOGS)
def test_scorer_reproduces_recorded_field_accuracy(log_rel, reference_root):
    log = parse_field_log(str(REF / log_rel))
    assert log.reference_recording == "Songs/chopin/chopin_rubinstein_20b.wav"
    recorded = parse_summary_percentages(log.summary)
    assert len(recorded) == 4, "log should carry 4 accuracy lines"

    scorer = PathScorer(
        GroundTruth.from_csv(str(CHOPIN_REF_CSV)),
        GroundTruth.from_csv(str(CHOPIN_LIVE_CSV)),
    )
    result = scorer.score(log.path)
    ours = [result.pct_off_beats[t] for t in (1, 3, 5, 10)]
    np.testing.assert_allclose(ours, recorded, atol=1e-9)


def test_field_log_roundtrip(tmp_path):
    path = [(0, 1), (1, 1), (2, 3)]
    out = tmp_path / "log.txt"
    write_field_log(
        str(out),
        "Songs/bso/bso_01.wav",
        [("fft_len", 4096), ("hop_size", 2048), ("search_band_width", 50), ("max_run_count", 3)],
        path,
    )
    log = parse_field_log(str(out))
    assert log.path == path
    assert log.params() == {
        "fft_len": 4096,
        "hop_size": 2048,
        "search_band_width": 50,
        "max_run_count": 3,
    }
    # byte-format parity: \r\n endings, "%d %d" pairs
    raw = out.read_bytes()
    assert b"\r\n" in raw
    assert raw.split(b"\r\n")[5] == b"0 1"


def test_data_from_file_parity_on_bso_log(reference_root):
    path = path_from_field_log(str(REF / "tests/bso_livenote_test_live.txt"))
    assert len(path) == 10896 - 5
    assert path[0] == (0, 1)
    assert all(isinstance(p, tuple) and len(p) == 2 for p in path[:10])


def test_scorer_zero_beat_truthiness_quirk():
    # A point whose interpolated beat is exactly 0.0 is skipped (tests.py:73)
    times = [1.0, 2.0]
    beats = [0, 1]  # beat 0 at t=1 → frame at t=1 interpolates to exactly 0.0
    gt = GroundTruth(times, beats)
    scorer = PathScorer(gt, gt)
    frame_at_1s = 1.0 / (2048 / 22050.0)
    sample = int(round(frame_at_1s))
    # both points at beat 0 → all skipped → no scorable points
    with pytest.raises(ZeroDivisionError):
        scorer.score([(sample, sample)] if get_beat(sample, times, beats) == 0.0 else [])


def test_feat_cache_lru_eviction(monkeypatch):
    """ADVICE r4 item 3: the extraction memo evicts oldest-first instead of
    clearing wholesale, and raw-audio entries have their own (smaller) cap."""
    from real_time_audio_sync_tpu.eval import corpus as C

    monkeypatch.setattr(C, "_FEAT_CACHE", type(C._FEAT_CACHE)())
    monkeypatch.setattr(C, "_FEAT_CACHE_MAX", 4)
    monkeypatch.setattr(C, "_FEAT_CACHE_AUDIO_MAX", 2)

    def key(i, kind="chroma"):
        return (f"/x/{i}.wav", 0.0, kind, "float32")

    for i in range(4):
        C._cache_insert(key(i), np.zeros(1))
    assert len(C._FEAT_CACHE) == 4
    # a hit refreshes recency: key(0) must survive the next eviction
    C._FEAT_CACHE.move_to_end(key(0))
    C._cache_insert(key(9), np.zeros(1))
    assert key(0) in C._FEAT_CACHE and key(1) not in C._FEAT_CACHE

    # raw-audio entries capped separately at 2
    for i in range(3):
        C._cache_insert(key(10 + i, "audio"), np.zeros(1))
    audio = [k for k in C._FEAT_CACHE if k[2] == "audio"]
    assert len(audio) == 2
    assert key(12, "audio") in C._FEAT_CACHE  # newest kept


def test_resolve_host_workers_malformed_env(monkeypatch):
    """ADVICE r4 item 4: a malformed RTAS_HOST_FFT_WORKERS warns and falls
    back to 1 instead of crashing every extraction call."""
    import warnings

    from real_time_audio_sync_tpu.features import chroma as C

    monkeypatch.setenv("RTAS_HOST_FFT_WORKERS", "two")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert C.resolve_host_workers() == 1
    assert any("malformed" in str(x.message) for x in w)
    monkeypatch.setenv("RTAS_HOST_FFT_WORKERS", "3")
    assert C.resolve_host_workers() == 3
    assert C.resolve_host_workers(workers=2) == 2


def test_host_pool_grows_never_shrinks():
    from real_time_audio_sync_tpu.features import chroma as C

    # relative to whatever size earlier tests grew the shared pool to —
    # the pool is process-global and never shrinks, so absolute sizes
    # would make this test order-dependent
    base = max(2, C._POOL_SIZE)
    p_base = C._host_pool(base)
    assert C._POOL_SIZE == base
    p_shrink = C._host_pool(1)  # shrink request keeps the larger pool
    assert p_shrink is p_base
    p_grown = C._host_pool(base + 2)
    assert p_grown is not p_base and C._POOL_SIZE == base + 2
    # the old pool must still accept work (no shutdown on resize)
    assert p_base.submit(lambda: 42).result() == 42

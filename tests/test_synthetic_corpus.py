"""End-to-end corpus evaluation on a generated corpus (the reference corpus
audio is absent from the mount — SURVEY.md §2 C16 — so we synthesize pieces
with known beat structure and exercise the full test_all-style flow)."""

import csv
import os

import numpy as np
import pytest

from real_time_audio_sync_tpu.eval.corpus import CorpusRunner, corpus_pairs
from real_time_audio_sync_tpu.utils.wavio import write_wav

FS = 22050


@pytest.fixture(scope="module")
def synthetic_corpus(tmp_path_factory):
    """Two pieces x two recordings each, with beat CSVs, in corpus layout."""
    root = tmp_path_factory.mktemp("Songs")
    rng = np.random.default_rng(42)
    for piece in ("alpha", "beta"):
        d = root / piece
        d.mkdir()
        # both recordings render the SAME chord chart at different tempi
        chart_rng = np.random.default_rng(hash(piece) % (2 ** 31))
        freqs = 220.0 * 2 ** (np.arange(12) / 12)
        n_beats = 24
        chords = [chart_rng.choice(12, size=3, replace=False) for _ in range(n_beats)]
        for idx in range(2):
            tempo = 95.0 + 12 * idx
            perf_rng = np.random.default_rng(1000 + idx)
            beat_times = [0.0]
            samples = []
            for b in range(n_beats):
                dur = 60.0 / (tempo * (1 + perf_rng.uniform(-0.08, 0.08)))
                t = np.arange(int(dur * FS)) / FS
                seg = sum(np.sin(2 * np.pi * freqs[k] * t) for k in chords[b])
                env = np.minimum(1.0, 10 * t) * np.minimum(1.0, np.maximum(10 * (dur - t), 0))
                samples.append(seg * env * 0.2)
                beat_times.append(beat_times[-1] + dur)
            wav = np.concatenate(samples)
            name = f"{piece}_{idx:02d}"
            write_wav(str(d / f"{name}.wav"), wav)
            with open(d / f"{name}.csv", "w", newline="") as f:
                w = csv.writer(f)
                for beat, t_sec in enumerate(beat_times[:-1], start=1):
                    w.writerow([f"{t_sec:.6f}", beat])
    return str(root)


def test_corpus_pairs_on_synthetic(synthetic_corpus):
    pairs = corpus_pairs(synthetic_corpus)
    assert len(pairs) == 2  # one i<j pair per piece
    assert all(os.path.exists(p) for pair in pairs for p in pair)


@pytest.mark.parametrize("engine,max_err", [
    ("dtw", 5.0),
    ("livenote_v2", 10.0),
    ("wtw", 10.0),
])
def test_corpus_sweep_synthetic(synthetic_corpus, engine, max_err):
    """Full test_all flow: walk, pair, align, score, average."""
    runner = CorpusRunner(synthetic_corpus, engine=engine, dtype=np.float64)
    report = runner.evaluate(verbose=False)
    assert len(report.results) == 2
    assert not report.skipped
    for r in report.results:
        assert r.score.count > 20
        # same chord chart at ~12% tempo offset: alignment should be tight
        assert r.score.pct_off_beats[3] <= max_err, (engine, r.ref_wav, r.score.pct_off_beats)
    assert np.isfinite(report.mean_error)


def test_corpus_sweep_fused_mode(synthetic_corpus):
    """The fused fast path through the full corpus flow: every pair aligns
    via the band kernel's set_live and scores in the same tight regime."""
    runner = CorpusRunner(synthetic_corpus, engine="otw", mode="fused", interpret=True)
    report = runner.evaluate(verbose=False)
    assert len(report.results) == 2 and not report.skipped
    for r in report.results:
        assert r.score.count > 20
        assert r.score.pct_off_beats[3] <= 10.0
    assert np.isfinite(report.mean_error)


def test_corpus_sweep_fused_wtw_batched(synthetic_corpus):
    """engine='wtw' mode='fused' runs the whole sweep as ONE multi-stream
    batch (every pair a stream of the vmapped stepper); committed paths are
    identical to per-pair solo AsyncWTW alignment."""
    from real_time_audio_sync_tpu.eval.corpus import align_pair, corpus_pairs

    runner = CorpusRunner(synthetic_corpus, engine="wtw", mode="fused")
    report = runner.evaluate(verbose=False)
    assert len(report.results) == 2 and not report.skipped
    for r, (ref_wav, live_wav) in zip(report.results, corpus_pairs(synthetic_corpus)):
        solo = align_pair(ref_wav, live_wav, "wtw", mode="fused")
        assert [tuple(p) for p in r.path] == [tuple(p) for p in solo.path]
        assert r.score.pct_off_beats[3] <= 10.0


def test_corpus_sweep_fused_online_batched(synthetic_corpus):
    """Online engines in mode='fused' run the whole sweep as ONE batched
    kernel launch (one program per pair); per-pair paths identical to solo
    pallas_set_live alignment."""
    from real_time_audio_sync_tpu.models.online_core import ENGINE_OVERRIDES
    from real_time_audio_sync_tpu.ops.pallas_otw import pallas_set_live
    from real_time_audio_sync_tpu.features.chroma import wav_to_chroma

    runner = CorpusRunner(synthetic_corpus, engine="livenote_v2", mode="fused",
                          interpret=True)
    report = runner.evaluate(verbose=False)
    assert len(report.results) == 2 and not report.skipped
    for r in report.results:
        ref = np.asarray(wav_to_chroma(r.ref_wav, dtype=np.float32))
        live = np.asarray(wav_to_chroma(r.live_wav, dtype=np.float32))
        solo, _, _, _ = pallas_set_live(
            ref, live, {"c": 50, "max_run_count": 3}, interpret=True,
            **ENGINE_OVERRIDES["livenote_v2"])
        np.testing.assert_array_equal(np.asarray(r.path), solo)
        assert r.score.pct_off_beats[3] <= 10.0


def test_corpus_fused_mode_rejects_f64(synthetic_corpus):
    """mode='fused' runs the float32 device backends in BOTH the batched
    (2+ pairs) and solo paths — an f64 request must raise, not silently
    downcast (round-3 review finding)."""
    runner = CorpusRunner(synthetic_corpus, engine="otw", mode="fused",
                          dtype=np.float64)
    with pytest.raises(ValueError, match="float32"):
        runner.evaluate(verbose=False)


# ---------------------------------------------------------------------------
# full-scale corpus (eval/synthetic.FULL_PIECES) — the reference's test_all
# regime at real corpus scale.  The full 8-piece / ~100-minute sweep runs on
# the GPU via examples/full_corpus_eval.py (table pinned in
# docs/ACCURACY.md); CI pins two multi-minute pieces end-to-end.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def full_scale_pieces(tmp_path_factory):
    from real_time_audio_sync_tpu.eval.synthetic import build_full_corpus

    root = str(tmp_path_factory.mktemp("FullSongs"))
    build_full_corpus(root, pieces=["sym_andante", "nocturne"])
    return root


def test_full_scale_corpus_shape():
    """The registry reproduces the reference corpus shape: 8 pieces, 2-3
    recordings each, ~11.5k exact beat annotations, multi-minute works
    (tests.py:199-262, Songs/** — 11,464 rows in the reference)."""
    from real_time_audio_sync_tpu.eval.synthetic import FULL_PIECES

    assert len(FULL_PIECES) == 8
    total_beats = 0
    for name, (seed, n_beats, rends) in FULL_PIECES.items():
        assert 2 <= len(rends) <= 3, name
        assert n_beats >= 420, name  # ~4+ minutes at the piece tempi
        total_beats += n_beats * len(rends)
    assert 10_000 <= total_beats <= 13_000  # reference scale: 11,464


def test_full_scale_corpus_sweep(full_scale_pieces):
    """CorpusRunner end-to-end over two multi-minute pieces in the fused
    mode, pinned: the realistic-variation renditions must align with 0%
    of path points >3 s off (the reference regime's headline metric)."""
    runner = CorpusRunner(full_scale_pieces, engine="otw", mode="fused", interpret=True)
    report = runner.evaluate(verbose=False)
    assert len(report.results) == 2 and not report.skipped
    for r in report.results:
        assert len(r.path) > 2000  # multi-minute alignment, not a toy
        assert r.score.pct_off_secs[3] == 0.0
    assert report.mean_error == 0.0

import os
import pathlib

import numpy as np
import pytest

from real_time_audio_sync_tpu.eval.corpus import (
    CorpusRunner,
    align_pair,
    corpus_pairs,
    run_simple,
)

REF = pathlib.Path("/root/reference")


def test_corpus_pairing_rules(reference_root):
    pairs = corpus_pairs(str(REF / "Songs"))
    names = [(os.path.basename(a)[:-4], os.path.basename(b)[:-4]) for a, b in pairs]
    # i<j pairs per piece, _20b excerpts skipped (tests.py:216-220)
    assert ("bach_01", "bach_03") in names
    assert ("bso_01", "bso_02") in names
    assert ("chopin_li", "chopin_rachmaninoff") in names
    assert not any("_20b" in a or "_20b" in b for a, b in names)
    # vivaldi m1 has 3 recordings → 3 pairs
    v1 = [p for p in names if p[0].startswith("vivaldi_m1")]
    assert len(v1) == 3
    # all pairs are i<j (no duplicates/reverses)
    assert len(set(names)) == len(names)


def test_corpus_runner_skips_missing_audio(reference_root):
    # only the chopin _20b wavs exist in the mount and those are excluded
    # from pairing — every pair is skipped, mean is nan, nothing crashes
    runner = CorpusRunner(str(REF / "Songs"), engine="livenote_v2_diff")
    report = runner.evaluate(verbose=False)
    assert report.results == []
    assert len(report.skipped) == len(corpus_pairs(str(REF / "Songs")))
    assert np.isnan(report.mean_error)


def test_align_pair_all_engines_chopin(chopin_pair):
    ref_wav, live_wav = chopin_pair
    results = run_simple(ref_wav, live_wav, engines=("dtw", "otw", "livenote", "livenote_v2", "wtw"), dtype=np.float64, verbose=False)
    for name, result in results.items():
        assert result.score.count > 100, name
        assert result.score.pct_off_beats[3] < 3.0, name
    # offline DTW is the accuracy ceiling
    assert results["dtw"].score.pct_off_beats[1] <= min(
        r.score.pct_off_beats[1] for r in results.values()
    ) + 1e-9


def test_align_pair_diff_engine(chopin_pair):
    ref_wav, live_wav = chopin_pair
    result = align_pair(ref_wav, live_wav, "livenote_v2_diff", dtype=np.float64)
    assert result.score.count > 100
    # chroma-diff features are sparser; allow a looser bound
    assert result.score.pct_off_beats[3] < 25.0


def test_cli_score_log(capsys, reference_root):
    from real_time_audio_sync_tpu.eval.__main__ import main

    rc = main([
        "--score-log", str(REF / "tests/wtw_test_live_1523037133.83.txt"),
        "--ref-csv", str(REF / "Songs/chopin/chopin_rubinstein_20b.csv"),
        "--live-csv", str(REF / "Songs/chopin/chopin_rachmaninoff_20b.csv"),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Percent incorrect (within 1 beat): 4.04494382022471" in out


def test_cli_unknown_engine(chopin_pair):
    from real_time_audio_sync_tpu.eval.__main__ import main

    ref_wav, live_wav = chopin_pair
    with pytest.raises(ValueError):
        main(["--ref", ref_wav, "--live", live_wav, "--engine", "nope"])


def test_align_pair_fused_mode(chopin_pair):
    """The fused corpus fast path produces the set_live-regime path and
    scores in the field regime (0-4% >1 beat)."""
    from real_time_audio_sync_tpu.eval.corpus import align_pair
    from real_time_audio_sync_tpu.models import OnlineTimeWarping
    from real_time_audio_sync_tpu.features.chroma import wav_to_chroma

    ref_wav, live_wav = chopin_pair
    res = align_pair(ref_wav, live_wav, "otw", {"c": 50, "max_run_count": 3}, mode="fused",
                     interpret=True)
    assert res.score.pct_off_beats[3] == 0.0
    # matches the XLA engine's set_live path exactly
    eng = OnlineTimeWarping(wav_to_chroma(ref_wav), {"c": 50, "max_run_count": 3})
    eng.set_live(wav_to_chroma(live_wav))
    np.testing.assert_array_equal(res.path, eng.path_array)


def test_live_demo_example_runs(chopin_pair, tmp_path):
    """The livenote_live-equivalent terminal demo (C11) runs end-to-end with
    the fused backend, writing a field log and the click-track wav."""
    import subprocess
    import sys

    ref_wav, live_wav = chopin_pair
    proc = subprocess.run(
        [sys.executable, "examples/live_demo.py", "--ref", ref_wav,
         "--live", live_wav, "--fused", "--interpret", "--quiet",
         "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "path points" in proc.stdout
    logs = list(tmp_path.glob("otw_test_live_*.txt"))
    assert logs, proc.stdout
    assert (tmp_path / "click_track.wav").stat().st_size > 10_000


def test_live_demo_wtw_async_engine_runs(chopin_pair, tmp_path):
    """The demo's raw-audio WTW path (wtw_live role) with the device-resident
    stepper: field log written, path committed."""
    import subprocess
    import sys

    ref_wav, live_wav = chopin_pair
    proc = subprocess.run(
        [sys.executable, "examples/live_demo.py", "--ref", ref_wav,
         "--live", live_wav, "--engine", "wtw_async", "--quiet",
         "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "path points" in proc.stdout
    assert list(tmp_path.glob("wtw_test_live_*.txt")), proc.stdout


def test_heatmap_example_runs(chopin_pair, tmp_path):
    """The notebook-equivalent example renders end-to-end (C18 parity)."""
    import subprocess
    import sys

    ref_wav, live_wav = chopin_pair
    out = tmp_path / "overlay.png"
    proc = subprocess.run(
        [sys.executable, "examples/heatmap_overlay.py", "--ref", ref_wav,
         "--live", live_wav, "--out", str(out)],
        capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert out.exists() and out.stat().st_size > 10_000


def test_align_pair_fused_wtw_matches_insert(chopin_pair):
    """engine='wtw' runs the device-resident AsyncWTW stepper in both
    'insert' and 'fused' modes; mode='oracle' opts into the host WTW loop.
    On CPU (any chunking) all three commit identical paths."""
    from real_time_audio_sync_tpu.eval.corpus import align_pair

    ref_wav, live_wav = chopin_pair
    a = align_pair(ref_wav, live_wav, "wtw", mode="insert")
    b = align_pair(ref_wav, live_wav, "wtw", mode="fused")
    o = align_pair(ref_wav, live_wav, "wtw", mode="oracle")
    np.testing.assert_array_equal(np.asarray(a.path), np.asarray(b.path))
    np.testing.assert_array_equal(np.asarray(a.path), np.asarray(o.path))
    assert a.score.pct_off_beats[1] == b.score.pct_off_beats[1]
    import pytest as _pytest

    with _pytest.raises(ValueError, match="oracle"):
        align_pair(ref_wav, live_wav, "otw", mode="oracle")


def test_serving_demo_example_runs(chopin_pair):
    """The multi-stream serving demo runs end-to-end (interpret mode, tiny
    stream count/length) and reports every stream's position."""
    import os
    import subprocess
    import sys

    ref_wav, live_wav = chopin_pair
    proc = subprocess.run(
        [sys.executable, "examples/serving_demo.py", "--ref", ref_wav,
         "--live", live_wav, "--streams", "2", "--interpret",
         "--max-frames", "32"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "aggregate RTF" in proc.stdout
    assert proc.stdout.count("stream ") >= 2


def test_measure_capacity_harness_runs():
    """The serving-capacity harness (docs/SERVING.md's numbers) runs both
    layers end-to-end at toy scale and self-checks path parity vs the solo
    engines (exit 1 on divergence — that's the assertion)."""
    import os
    import subprocess
    import sys

    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "examples/measure_capacity.py", "otw", "--b", "2",
         "--hops", "40", "--n-ref", "200", "--interpret"],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "paths==solo True" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "examples/measure_capacity.py", "wtw", "--b", "2",
         "--live-s", "15", "--cpu"],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "paths==solo True" in proc.stdout

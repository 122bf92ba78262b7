import numpy as np
import pytest

from real_time_audio_sync_tpu.models.dtw import DTW
from real_time_audio_sync_tpu.ops.wavefront import WTW_SPEC, backtrack, wavefront_dp

from tests.oracle import oracle_dtw


def _random_chroma(rng, t):
    x = rng.random((12, t))
    return x / np.linalg.norm(x, axis=0, keepdims=True)


@pytest.mark.parametrize("m,n", [(1, 1), (1, 7), (7, 1), (5, 5), (23, 31), (64, 48)])
def test_dp_matches_oracle_bitexact_on_same_cost(m, n):
    # Isolate the wavefront DP: identical cost matrix into both
    # implementations ⇒ bit-identical acc matrix and path.
    import jax.numpy as jnp

    from real_time_audio_sync_tpu.ops.wavefront import DTW_SPEC
    from tests.oracle import oracle_dtw_from_cost

    rng = np.random.default_rng(m * 100 + n)
    cost = rng.random((m, n))
    acc, back = wavefront_dp(jnp.asarray(cost, jnp.float64), DTW_SPEC)
    pts, ln = backtrack(back, DTW_SPEC)
    path = np.asarray(pts)[: int(ln)][::-1]
    _, racc, rpath = oracle_dtw_from_cost(cost)
    np.testing.assert_array_equal(np.asarray(acc), racc)
    np.testing.assert_array_equal(path, rpath)


@pytest.mark.parametrize("m,n", [(5, 5), (23, 31), (64, 48)])
def test_dtw_end_to_end_matches_oracle(m, n):
    # Full DTW() including the XLA cost matmul: cost agrees to ~1 ulp
    # (accumulation order), path agrees exactly on generic data.
    rng = np.random.default_rng(m * 100 + n)
    a = _random_chroma(rng, m)
    b = _random_chroma(rng, n)
    cost, acc, path = DTW(a, b, dtype=np.float64)
    rcost, racc, rpath = oracle_dtw(a, b)
    np.testing.assert_allclose(cost, rcost, rtol=0, atol=1e-12)
    np.testing.assert_allclose(acc, racc, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(path, rpath)


@pytest.mark.parametrize("spec_name", ["dtw", "wtw"])
@pytest.mark.parametrize("m,n", [(1, 1), (5, 5), (20, 20), (23, 31)])
def test_unrolled_wavefront_matches_scan(spec_name, m, n):
    # The straight-line (unroll=True) tracing of the DP and backtrack must be
    # bit-identical to the lax.scan wavefront — it is the same step function,
    # only the loop construct differs (used by AsyncWTW's small-window path).
    import jax.numpy as jnp

    from real_time_audio_sync_tpu.ops.wavefront import DTW_SPEC

    spec = DTW_SPEC if spec_name == "dtw" else WTW_SPEC
    rng = np.random.default_rng(m * 100 + n)
    cost = jnp.asarray(rng.random((m, n)), jnp.float64)
    acc_s, back_s = wavefront_dp(cost, spec)
    acc_u, back_u = wavefront_dp(cost, spec, unroll=True)
    np.testing.assert_array_equal(np.asarray(acc_s), np.asarray(acc_u))
    np.testing.assert_array_equal(np.asarray(back_s), np.asarray(back_u))
    pts_s, ln_s = backtrack(back_s, spec)
    pts_u, ln_u = backtrack(back_u, spec, unroll=True)
    assert int(ln_s) == int(ln_u)
    np.testing.assert_array_equal(
        np.asarray(pts_s)[: int(ln_s)], np.asarray(pts_u)[: int(ln_u)]
    )


def test_dtw_with_ties_matches_argmin_order():
    # constant sequences create exact ties everywhere; tie-break must follow
    # np.argmin's first-min (left, up, diag) order (dtw.py:35-38)
    a = np.ones((12, 9)) / np.sqrt(12)
    b = np.ones((12, 6)) / np.sqrt(12)
    _, acc, path = DTW(a, b, dtype=np.float64)
    _, racc, rpath = oracle_dtw(a, b)
    np.testing.assert_array_equal(acc, racc)
    np.testing.assert_array_equal(path, rpath)


def test_dtw_path_endpoints_and_monotonicity():
    rng = np.random.default_rng(7)
    a = _random_chroma(rng, 40)
    b = _random_chroma(rng, 50)
    _, _, path = DTW(a, b, dtype=np.float64)
    assert tuple(path[0]) == (0, 0)
    assert tuple(path[-1]) == (39, 49)
    steps = np.diff(path, axis=0)
    assert np.all((steps >= 0) & (steps <= 1))
    assert np.all(steps.sum(axis=1) >= 1)


def test_wtw_spec_dp_matches_naive():
    # WTW's window DP: unweighted diagonal, tie priority up(3), left(1), diag(2)
    rng = np.random.default_rng(3)
    c = rng.random((12, 15))

    n, m = c.shape
    d = np.empty((n, m))
    b = np.empty((n, m))
    d[0, 0] = c[0, 0]
    b[0, 0] = 0
    for i in range(1, n):
        d[i, 0] = d[i - 1, 0] + c[i, 0]
        b[i, 0] = 3
    for j in range(1, m):
        d[0, j] = d[0, j - 1] + c[0, j]
        b[0, j] = 1
    for i in range(1, n):
        for j in range(1, m):
            cands = [(d[i - 1, j], 3), (d[i, j - 1], 1), (d[i - 1, j - 1], 2)]
            best, code = cands[0]
            for v, cd in cands[1:]:
                if v < best:
                    best, code = v, cd
            d[i, j] = best + c[i, j]
            b[i, j] = code

    import jax.numpy as jnp

    acc, back = wavefront_dp(jnp.asarray(c, jnp.float64), WTW_SPEC)
    np.testing.assert_array_equal(np.asarray(acc), d)
    np.testing.assert_array_equal(np.asarray(back), b)

    pts, ln = backtrack(back, WTW_SPEC)
    path = np.asarray(pts)[: int(ln)][::-1]
    # naive backtrack
    cur = (n - 1, m - 1)
    ref_path = [cur]
    while cur != (0, 0):
        code = b[cur]
        if code == 1:
            cur = (cur[0], cur[1] - 1)
        elif code == 2:
            cur = (cur[0] - 1, cur[1] - 1)
        else:
            cur = (cur[0] - 1, cur[1])
        ref_path.append(cur)
    ref_path.reverse()
    np.testing.assert_array_equal(path, np.array(ref_path))


def test_dtw_real_pair_scores(chopin_pair):
    from real_time_audio_sync_tpu.eval import PathScorer
    from real_time_audio_sync_tpu.features.chroma import wav_to_chroma

    ref_wav, live_wav = chopin_pair
    ref_seq = wav_to_chroma(ref_wav, dtype=np.float64)
    live_seq = wav_to_chroma(live_wav, dtype=np.float64)
    _, _, path = DTW(live_seq, ref_seq, dtype=np.float64)
    result = PathScorer.for_pair(ref_wav, live_wav).score(path)
    # offline DTW is the strongest aligner; the recorded field runs scored
    # 0-4% off-by->1-beat (BASELINE.md) — offline should be comparable
    assert result.pct_off_beats[1] < 10.0
    assert result.pct_off_beats[3] < 1.0


def test_dtw_backend_validation():
    """Offline DTW has one device path, the XLA wavefront: the removed
    ``backend=`` option is rejected, and the one path matches the oracle."""
    import pytest

    from real_time_audio_sync_tpu.models.dtw import DTW
    from tests.oracle import oracle_dtw

    rng = np.random.default_rng(3)
    a, b = rng.random((12, 16)).astype(np.float32), rng.random((12, 20)).astype(np.float32)
    with pytest.raises(TypeError):
        DTW(a, b, backend="scan")
    _, _, path = DTW(a, b)
    np.testing.assert_array_equal(path, oracle_dtw(a.astype(np.float64), b.astype(np.float64))[2])


# ---------------------------------------------------------------------------
# banded offline DTW (ops/banded_dtw.py) — hour-scale O(M·band) memory
# ---------------------------------------------------------------------------


def test_banded_dtw_full_band_matches_dense():
    """With the band covering the whole reference the banded DP computes the
    full matrix: paths must equal the dense wavefront's exactly (codes are
    recomputed with the reference first-min order)."""
    from real_time_audio_sync_tpu.ops.banded_dtw import dtw_banded

    for seed in range(4):
        rng = np.random.default_rng(seed)
        m, n = 110 + seed, 140 - seed
        a = rng.random((12, m)).astype(np.float32)
        a /= np.linalg.norm(a, axis=0)
        b = rng.random((12, n)).astype(np.float32)
        b /= np.linalg.norm(b, axis=0)
        _, acc, dense_path = DTW(a, b)
        path, cost = dtw_banded(a, b, band=n)
        np.testing.assert_array_equal(dense_path, path)
        assert abs(float(acc[-1, -1]) - cost) < 1e-3


def test_banded_dtw_real_pair(chopin_pair):
    """A 256-frame band comfortably contains the real pair's optimal path."""
    from real_time_audio_sync_tpu.features.chroma import wav_to_chroma
    from real_time_audio_sync_tpu.ops.banded_dtw import dtw_banded

    ref_wav, live_wav = chopin_pair
    ref = np.asarray(wav_to_chroma(ref_wav)).astype(np.float32)
    live = np.asarray(wav_to_chroma(live_wav)).astype(np.float32)
    _, _, dense_path = DTW(live, ref)
    path, _ = dtw_banded(live, ref, band=256)
    np.testing.assert_array_equal(dense_path, path)


def test_banded_dtw_edges():
    from real_time_audio_sync_tpu.ops.banded_dtw import dtw_banded

    a = np.ones((12, 1), np.float32) / np.sqrt(12)
    b = np.ones((12, 5), np.float32) / np.sqrt(12)
    _, _, dense_path = DTW(a, b)
    path, _ = dtw_banded(a, b, band=5)
    np.testing.assert_array_equal(dense_path, path)
    # band wider than the reference clamps
    path2, _ = dtw_banded(a, b, band=99)
    np.testing.assert_array_equal(dense_path, path2)


def test_banded_dtw_path_shape_properties():
    """Monotone corner-to-corner path even when the band binds (the banded
    result is then an approximation, but must stay a valid warping path)."""
    from real_time_audio_sync_tpu.ops.banded_dtw import dtw_banded

    rng = np.random.default_rng(9)
    a = rng.random((12, 300)).astype(np.float32)
    a /= np.linalg.norm(a, axis=0)
    b = rng.random((12, 300)).astype(np.float32)
    b /= np.linalg.norm(b, axis=0)
    path, cost = dtw_banded(a, b, band=32)
    assert tuple(path[0]) == (0, 0)
    assert tuple(path[-1]) == (299, 299)
    d = np.diff(path, axis=0)
    assert (d >= 0).all() and (d.sum(axis=1) > 0).all()
    assert np.isfinite(cost)


# ---------------------------------------------------------------------------
# auto-routing: DTW() delegates to the banded engine at scale (r4 verdict #3)
# ---------------------------------------------------------------------------


def _unit_cols(rng, m):
    x = rng.random((12, m)).astype(np.float32)
    return x / np.linalg.norm(x, axis=0)


def test_dtw_auto_edge_touch_widen_and_retry():
    """A band too narrow for an adversarial pair touches the band edge;
    dtw_auto must widen until the dense optimum is recovered.  The live
    sequence dwells 5x on the reference's opening (a smooth monotone warp
    far off the resampled diagonal), with per-column noise so the optimum
    is unique (tie floods would make path equality ill-posed)."""
    from real_time_audio_sync_tpu.models.dtw import dtw_auto

    rng = np.random.default_rng(3)
    ref = _unit_cols(rng, 180)
    warp = np.concatenate([np.repeat(np.arange(30), 5), np.arange(30, 180)])
    live = ref[:, warp] + rng.normal(0, 1e-3, (12, len(warp))).astype(np.float32)
    live /= np.linalg.norm(live, axis=0)
    _, _, dense_path = DTW(live, ref)
    path, _, band_used = dtw_auto(live, ref, band=16)
    assert band_used > 16, "adversarial pair should have forced a widen"
    np.testing.assert_array_equal(dense_path, path)


def test_dtw_auto_no_widen_when_band_suffices(chopin_pair):
    from real_time_audio_sync_tpu.features.chroma import wav_to_chroma
    from real_time_audio_sync_tpu.models.dtw import dtw_auto

    ref_wav, live_wav = chopin_pair
    ref = np.asarray(wav_to_chroma(ref_wav)).astype(np.float32)
    live = np.asarray(wav_to_chroma(live_wav)).astype(np.float32)
    _, _, dense_path = DTW(live, ref)
    path, _, band_used = dtw_auto(live, ref)
    # initial band from the length ratio (clamped to the reference length
    # for the ~35 s excerpt pair), no retry
    assert band_used == min(512, ref.shape[1])
    np.testing.assert_array_equal(dense_path, path)


def test_dtw_public_surface_auto_delegates(monkeypatch):
    """Above the dense-bytes budget the public DTW() routes to the banded
    engine instead of allocating O(M*N): cost/acc come back None, the path
    is the dense optimum (verified against an in-budget dense run)."""
    import warnings

    rng = np.random.default_rng(7)
    a, b = _unit_cols(rng, 200), _unit_cols(rng, 220)
    _, _, dense_path = DTW(a, b)

    monkeypatch.setenv("RTAS_DTW_DENSE_LIMIT_BYTES", "10000")  # ~770 cells
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cost, acc, path = DTW(a, b)
    assert cost is None and acc is None
    assert any("delegating" in str(x.message) for x in w)
    np.testing.assert_array_equal(dense_path, path)

    # explicit kwarg overrides the env
    cost2, acc2, path2 = DTW(a, b, max_dense_bytes=1 << 40)
    assert cost2 is not None and acc2 is not None
    np.testing.assert_array_equal(dense_path, path2)


def test_align_pair_dtw_routes_banded_at_scale(chopin_pair, monkeypatch):
    from real_time_audio_sync_tpu.eval.corpus import align_pair

    ref_wav, live_wav = chopin_pair
    want = align_pair(ref_wav, live_wav, "dtw")
    monkeypatch.setenv("RTAS_DTW_DENSE_LIMIT_BYTES", "10000")
    got = align_pair(ref_wav, live_wav, "dtw")
    np.testing.assert_array_equal(want.path, got.path)
    assert got.score.pct_off_3s == want.score.pct_off_3s


def test_banded_dtw_narrow_band_invalid_path_raises_or_valid():
    """ADVICE r4 item 2: a pathologically narrow band must never return
    negative-coordinate garbage — either a valid monotone path or a loud
    'widen band' ValueError."""
    import pytest

    from real_time_audio_sync_tpu.ops.banded_dtw import dtw_banded

    rng = np.random.default_rng(11)
    ref = _unit_cols(rng, 400)
    live = np.concatenate([np.repeat(ref[:, :1], 200, axis=1),
                           ref[:, :200]], axis=1)
    try:
        path, cost, edge = dtw_banded(live, ref, band=8,
                                      return_edge_touch=True)
    except ValueError as e:
        assert "widen" in str(e)
        return
    assert edge, "a band-8 run on this pair must report an edge touch"
    assert tuple(path[0]) == (0, 0)
    assert tuple(path[-1]) == (live.shape[1] - 1, ref.shape[1] - 1)
    d = np.diff(path, axis=0)
    assert (d >= 0).all() and (path >= 0).all()

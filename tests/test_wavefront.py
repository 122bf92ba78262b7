"""The XLA wavefront DP and backtrack (ops/wavefront.py) against the f64
oracle recurrences: offline DTW (dtw.py:5-53) and the WTW window DP
(wtw.py:176-240), in both the ``lax.scan`` and the unrolled form."""

import numpy as np
import pytest

import jax.numpy as jnp

from real_time_audio_sync_tpu.ops.wavefront import DTW_SPEC, WTW_SPEC, backtrack, wavefront_dp

from tests.oracle import OracleWTW, oracle_dtw_from_cost


def _oracle(cost, spec):
    """(acc, path origin→end) of the f64 oracle for ``spec``."""
    cost = np.asarray(cost, np.float64)
    if spec is DTW_SPEC:
        _, acc, path = oracle_dtw_from_cost(cost)
        return acc, np.asarray(path)
    acc, back = OracleWTW._run_dtw(None, cost)
    return acc, np.asarray(OracleWTW._find_path(None, back))


def _path(back, spec, unroll=False):
    pts, length = backtrack(back, spec, unroll=unroll)
    return np.asarray(pts)[: int(length)][::-1]


@pytest.mark.parametrize("spec", [DTW_SPEC, WTW_SPEC], ids=["dtw", "wtw"])
@pytest.mark.parametrize("shape", [(5, 7), (33, 20), (40, 65)])
def test_wavefront_matches_oracle(spec, shape):
    """Accumulated costs agree with the f64 recurrence to f32 rounding
    (relative 1e-5: sums of up to ~100 f32 terms in [0, 1)), paths exactly."""
    rng = np.random.default_rng(sum(shape))
    cost = rng.random(shape).astype(np.float32)
    acc, back = wavefront_dp(jnp.asarray(cost), spec)
    want_acc, want_path = _oracle(cost, spec)
    np.testing.assert_allclose(np.asarray(acc), want_acc, rtol=1e-5)
    np.testing.assert_array_equal(_path(back, spec), want_path)


@pytest.mark.parametrize("spec", [DTW_SPEC, WTW_SPEC], ids=["dtw", "wtw"])
def test_wavefront_ties_break_like_np_argmin(spec):
    """Constant costs force ties on every cell — the step order must
    reproduce the oracle's first-min choice exactly (same path)."""
    cost = np.ones((12, 9), np.float32)
    _, back = wavefront_dp(jnp.asarray(cost), spec)
    _, want_path = _oracle(cost, spec)
    np.testing.assert_array_equal(_path(back, spec), want_path)
    _, back_u = wavefront_dp(jnp.asarray(cost), spec, unroll=True)
    np.testing.assert_array_equal(np.asarray(back_u), np.asarray(back))


def test_backtracked_path_matches_oracle():
    rng = np.random.default_rng(3)
    cost = rng.random((21, 30)).astype(np.float32)
    _, back = wavefront_dp(jnp.asarray(cost), DTW_SPEC)
    _, want_path = _oracle(cost, DTW_SPEC)
    np.testing.assert_array_equal(_path(back, DTW_SPEC), want_path)


@pytest.mark.parametrize("spec", [DTW_SPEC, WTW_SPEC], ids=["dtw", "wtw"])
@pytest.mark.parametrize("shape", [(5, 7), (21, 30), (40, 65)])
def test_backtrack_unroll_matches_scan(spec, shape):
    """The unrolled DP and backtrack reproduce the scan forms' full output
    contract (identical back codes, path, length and frozen repeats), and
    the path is the oracle's."""
    rng = np.random.default_rng(sum(shape))
    cost = jnp.asarray(rng.random(shape), jnp.float32)
    acc_s, back_s = wavefront_dp(cost, spec)
    acc_u, back_u = wavefront_dp(cost, spec, unroll=True)
    np.testing.assert_array_equal(np.asarray(back_s), np.asarray(back_u))
    np.testing.assert_array_equal(np.asarray(acc_s), np.asarray(acc_u))
    pts_s, len_s = backtrack(back_s, spec)
    pts_u, len_u = backtrack(back_s, spec, unroll=True)
    assert int(len_s) == int(len_u)
    np.testing.assert_array_equal(np.asarray(pts_s), np.asarray(pts_u))
    _, want_path = _oracle(np.asarray(cost), spec)
    np.testing.assert_array_equal(_path(back_s, spec), want_path)

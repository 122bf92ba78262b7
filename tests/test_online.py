"""Parity tests: jitted online engines vs the naive oracle transcription.

Synthetic "performances" are built as time-warped versions of a reference
chroma sequence so the alignment problem is realistic (diagonal-ish paths
with tempo fluctuations), plus pure-random sequences for adversarial cases.
"""

import numpy as np
import pytest

from real_time_audio_sync_tpu.models import LiveNote, LiveNoteV2, OnlineTimeWarping

from tests.oracle import OracleOTW


def _unit_cols(x):
    return x / np.linalg.norm(x, axis=0, keepdims=True)


def _make_pair(rng, n_ref=60, stretch=1.3):
    """Reference sequence + a tempo-warped live rendition of it."""
    ref = _unit_cols(rng.random((12, n_ref)) + 0.05)
    # live = ref resampled at a wandering tempo
    n_live = int(n_ref * stretch)
    pos = np.cumsum(rng.uniform(0.5, 1.5, n_live))
    pos = pos / pos[-1] * (n_ref - 1)
    live = ref[:, np.round(pos).astype(int)]
    # small feature noise so costs are generic (no exact ties)
    live = _unit_cols(live + 0.01 * rng.random((12, n_live)))
    return ref, live


ENGINES = [
    ("otw", OnlineTimeWarping, dict(params={"c": 10, "max_run_count": 3})),
    ("livenote", LiveNote, dict(params={"search_band_width": 10, "max_run_count": 3})),
    ("livenote_v2", LiveNoteV2, dict(params={"search_band_width": 10, "max_run_count": 3})),
]


def _oracle_for(name, ref, c=10, mrc=3, euclidean=False):
    return OracleOTW(ref, c, mrc, variant=name, euclidean=euclidean)


@pytest.mark.parametrize("name,cls,kw", ENGINES)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("exact", [True, False])
def test_insert_path_matches_oracle(name, cls, kw, seed, exact):
    # exact=True: bit-identical band arithmetic; exact=False: the fast
    # associative-scan chain (production path) — paths still match because
    # generic data has no exact ties
    rng = np.random.default_rng(seed)
    ref, live = _make_pair(rng)
    engine = cls(ref, dtype=np.float64, exact_chain=exact, **kw)
    oracle = _oracle_for(name, ref)
    for i in range(live.shape[1]):
        got = engine.insert(live[:, i])
        want = oracle.insert(live[:, i])
        assert got == want, f"insert #{i}: {got} vs {want}"
        if got == "stop":
            break
    assert [tuple(p) for p in engine.path] == [tuple(p) for p in oracle.path]
    assert engine.live_ptr == oracle.t
    assert engine.ref_ptr == oracle.j


@pytest.mark.parametrize("name,cls,kw", ENGINES)
def test_insert_acc_matrix_matches_oracle(name, cls, kw):
    rng = np.random.default_rng(42)
    ref, live = _make_pair(rng, n_ref=40)
    engine = cls(ref, dtype=np.float64, exact_chain=True, **kw)
    oracle = _oracle_for(name, ref)
    for i in range(live.shape[1]):
        if engine.insert(live[:, i]) == "stop":
            oracle.insert(live[:, i])
            break
        oracle.insert(live[:, i])
    ours = engine.acc_cost
    theirs = oracle.acc
    computed = theirs != (1e10 if name == "otw" else np.inf)
    # computed cells agree to the ulp level (the cosine-cost matvec reduces
    # in a different order than numpy's per-cell dot); uncomputed cells keep
    # the exact sentinel
    np.testing.assert_allclose(ours[computed], theirs[computed], rtol=1e-12, atol=1e-12)
    assert np.array_equal(ours == (1e10 if name == "otw" else np.inf), ~computed)


@pytest.mark.parametrize("name,cls,kw", ENGINES)
@pytest.mark.parametrize("seed", [3, 4])
def test_set_live_matches_oracle(name, cls, kw, seed):
    rng = np.random.default_rng(seed)
    ref, live = _make_pair(rng)
    engine = cls(ref, dtype=np.float64, **kw)
    engine.set_live(live)
    oracle = _oracle_for(name, ref)
    opath = oracle.set_live(live)
    np.testing.assert_array_equal(engine.path_array, opath)


@pytest.mark.parametrize("c,mrc", [(3, 3), (10, 1), (25, 5), (10, 2)])
def test_config_sweep_matches_oracle(c, mrc):
    """Band-width / slope-constraint sweep incl. the degenerate edges: c=3
    (heavily clamped bands), max_run_count=1 (direction forced to alternate
    every step, otw_eran.py:168-170)."""
    rng = np.random.default_rng(100 + c + mrc)
    ref, live = _make_pair(rng, n_ref=40, stretch=1.3)
    engine = OnlineTimeWarping(ref, {"c": c, "max_run_count": mrc}, dtype=np.float64)
    oracle = OracleOTW(ref, c, mrc, variant="otw")
    for i in range(live.shape[1]):
        got = engine.insert(live[:, i])
        want = oracle.insert(live[:, i])
        assert got == want
        if got == "stop":
            break
    assert [tuple(p) for p in engine.path] == [tuple(p) for p in oracle.path]

    # the band kernel (Pallas interpreter) under the same config
    from real_time_audio_sync_tpu.ops.pallas_otw import pallas_set_live

    batch = OnlineTimeWarping(ref, {"c": c, "max_run_count": mrc}, dtype=np.float32)
    batch.set_live(live)
    path, t, j, stopped = pallas_set_live(ref, live, {"c": c, "max_run_count": mrc},
                                          interpret=True)
    np.testing.assert_array_equal(path, batch.path_array)


@pytest.mark.parametrize("name,cls,kw", ENGINES)
def test_set_live_after_inserts_matches_oracle(name, cls, kw):
    """set_live after streaming inserts: OnlineTimeWarping resets pointers/
    direction/path but keeps the cost matrices (otw_eran.py:92-97); LiveNote
    and V2 continue from the current frontier (livenote.py:102-108)."""
    rng = np.random.default_rng(17)
    ref, live = _make_pair(rng)
    engine = cls(ref, dtype=np.float64, exact_chain=True, **kw)
    oracle = _oracle_for(name, ref)
    for i in range(12):
        engine.insert(live[:, i])
        oracle.insert(live[:, i])
    engine.set_live(live)
    opath = oracle.set_live(live)
    np.testing.assert_array_equal(engine.path_array, np.asarray(opath))
    assert engine.live_ptr == oracle.t
    assert engine.ref_ptr == oracle.j


@pytest.mark.parametrize("name,cls,kw", ENGINES)
def test_pipelined_inserts_match_sync(name, cls, kw):
    """insert_nowait + poll/flush (the pipelined streaming path) commits the
    exact same path as synchronous insert; "stop" surfaces by flush at the
    latest, and post-stop dispatches freeze (documented lazy-stop deviation)."""
    rng = np.random.default_rng(23)
    ref, live = _make_pair(rng, n_ref=30, stretch=1.0)
    extra = _unit_cols(rng.random((12, 25)) + 0.05)
    live = np.concatenate([live, extra], axis=1)

    sync = cls(ref, dtype=np.float64, **kw)
    for i in range(live.shape[1]):
        if sync.insert(live[:, i]) == "stop":
            break

    pipe = cls(ref, dtype=np.float64, **kw)
    for i in range(live.shape[1]):
        pipe.insert_nowait(live[:, i])
        pipe.poll()  # opportunistic, non-blocking
    assert pipe.flush() == "stop"
    assert pipe.insert_nowait(live[:, 0]) == "stop"  # cached verdict
    assert [tuple(p) for p in pipe.path] == [tuple(p) for p in sync.path]
    # last_point mirrors path tail without fetching the path
    plen, x, y = pipe.last_point
    assert plen == len(pipe.path)
    assert (x, y) == tuple(pipe.path[-1])


def test_v2_path_is_monotone():
    rng = np.random.default_rng(9)
    ref, live = _make_pair(rng)
    engine = LiveNoteV2(ref, {"search_band_width": 10, "max_run_count": 3}, dtype=np.float64)
    for i in range(live.shape[1]):
        if engine.insert(live[:, i]) == "stop":
            break
    p = engine.path_array
    assert np.all(np.diff(p[:, 0]) > 0)
    assert np.all(np.diff(p[:, 1]) >= 0)


def test_v2_euclidean_cost_matches_oracle():
    rng = np.random.default_rng(11)
    ref, live = _make_pair(rng)
    # rectified-diff-style features: nonnegative, not normalized
    ref_d = np.clip(np.diff(ref, axis=1), 0, np.inf)
    live_d = np.clip(np.diff(live, axis=1), 0, np.inf)
    engine = LiveNoteV2(
        ref_d, {"search_band_width": 10, "max_run_count": 3}, chroma_diff=True, dtype=np.float64
    )
    oracle = OracleOTW(ref_d, 10, 3, variant="livenote_v2", euclidean=True)
    for i in range(live_d.shape[1]):
        got = engine.insert(live_d[:, i])
        want = oracle.insert(live_d[:, i])
        assert got == want
        if got == "stop":
            break
    assert [tuple(p) for p in engine.path] == [tuple(p) for p in oracle.path]


def test_stop_is_sticky_and_graceful():
    rng = np.random.default_rng(5)
    ref, live = _make_pair(rng, n_ref=30, stretch=1.0)
    # performance continues past the end of the score → ref side exhausts
    extra = _unit_cols(rng.random((12, 25)) + 0.05)
    live = np.concatenate([live, extra], axis=1)
    engine = OnlineTimeWarping(ref, {"c": 10, "max_run_count": 3}, dtype=np.float64)
    stopped_at = None
    for i in range(live.shape[1]):
        if engine.insert(live[:, i]) == "stop":
            stopped_at = i
            break
    assert stopped_at is not None
    path_at_stop = engine.path
    # further inserts are no-ops returning "stop" (the reference would crash)
    assert engine.insert(live[:, 0]) == "stop"
    assert engine.path == path_at_stop


def test_first_insert_only_evaluates_origin():
    rng = np.random.default_rng(6)
    ref, _ = _make_pair(rng, n_ref=30)
    engine = LiveNote(ref, {"search_band_width": 10, "max_run_count": 3}, dtype=np.float64)
    col = _unit_cols(rng.random((12, 1)))[:, 0]
    assert engine.insert(col) is None
    acc = engine.acc_cost
    assert np.isfinite(acc[0, 0])
    assert np.isinf(acc).sum() == acc.size - 1
    assert engine.path == []


def test_band_too_wide_raises():
    rng = np.random.default_rng(6)
    ref = _unit_cols(rng.random((12, 5)))
    with pytest.raises(ValueError):
        OnlineTimeWarping(ref, {"c": 10, "max_run_count": 3})


@pytest.mark.parametrize("block", [1, 7, 32])
def test_insert_block_equals_sequential_inserts(block):
    rng = np.random.default_rng(21)
    ref, live = _make_pair(rng)
    seq = OnlineTimeWarping(ref, {"c": 10, "max_run_count": 3}, dtype=np.float64)
    blk = OnlineTimeWarping(ref, {"c": 10, "max_run_count": 3}, dtype=np.float64)
    for i in range(live.shape[1]):
        if seq.insert(live[:, i]) == "stop":
            break
    n = live.shape[1]
    for s in range(0, n, block):
        if blk.insert_block(live[:, s : s + block]) == "stop":
            break
    # the block may overshoot past the stop (extra inserts freeze), so the
    # paths agree exactly
    assert [tuple(p) for p in blk.path] == [tuple(p) for p in seq.path]


def test_dense_engine_rejects_hour_scale_reference():
    """The dense (2N, N) accumulator cannot exist at hour scale; the XLA
    engine must say so helpfully instead of OOMing (the band kernel is the
    supported path — FusedStreamingEngine, AsyncWTW)."""
    from real_time_audio_sync_tpu.models import OnlineTimeWarping

    ref = np.zeros((12, 40_000), np.float32)
    with pytest.raises(ValueError, match="FusedStreamingEngine"):
        OnlineTimeWarping(ref, {"c": 50, "max_run_count": 3})


def test_sync_read_drops_stale_inflight_status():
    """A synchronous insert's status read covers everything dispatched so
    far, so it must retire older in-flight vectors: harvesting one of them
    later would regress last_point backwards (round-3 review finding)."""
    import jax

    rng = np.random.default_rng(31)
    ref, live = _make_pair(rng, n_ref=30, stretch=1.0)

    eng = OnlineTimeWarping(ref, {"c": 10, "max_run_count": 3}, dtype=np.float64)
    eng.async_harvest = False       # deterministic: harvests consume inline
    eng.poll_min_interval = 1000.0  # rate limit keeps the stale vector unread
    import time

    eng._last_poll_time = time.monotonic()  # arm the rate limit NOW
    eng.insert_nowait(live[:, 0])
    # make the stale status completed-but-unharvested
    jax.block_until_ready([s for _, s in eng._outstanding])
    eng.insert(live[:, 1])          # synchronous read: covers both frames
    want = eng.last_point
    assert eng.last_point_age_frames == 0
    assert not eng._outstanding and eng._latest_done is None
    eng.poll_min_interval = 0.0
    eng.poll()                      # must have nothing stale to harvest
    assert eng.last_point == want
    assert eng.last_point_age_frames == 0


@pytest.mark.parametrize("name,cls,kw", ENGINES)
@pytest.mark.parametrize("seed", [41, 42])
def test_streaming_api_interleaving_fuzz(name, cls, kw, seed):
    """Seeded fuzz over random interleavings of the whole streaming API
    (insert / insert_nowait / insert_block / insert_block_nowait / poll /
    last_point) under maximum harvest pressure: the committed path must
    equal the pure-synchronous run's, and last_point must mirror the final
    path tail — the regression net for the stale-harvest class of bug."""
    rng = np.random.default_rng(seed)
    ref, live = _make_pair(rng, n_ref=30, stretch=1.1)
    extra = _unit_cols(rng.random((12, 20)) + 0.05)
    live = np.concatenate([live, extra], axis=1)

    sync = cls(ref, dtype=np.float64, **kw)
    for i in range(live.shape[1]):
        if sync.insert(live[:, i]) == "stop":
            break

    eng = cls(ref, dtype=np.float64, **kw)
    eng.poll_min_interval = 0.0  # harvest at every opportunity
    i, r = 0, None
    while i < live.shape[1] and r != "stop":
        op = int(rng.integers(0, 6))
        if op == 0:
            r = eng.insert(live[:, i]); i += 1
        elif op == 1:
            r = eng.insert_nowait(live[:, i]); i += 1
        elif op == 2:
            k = min(int(rng.integers(1, 5)), live.shape[1] - i)
            r = eng.insert_block(live[:, i : i + k]); i += k
        elif op == 3:
            k = min(int(rng.integers(1, 5)), live.shape[1] - i)
            r = eng.insert_block_nowait(live[:, i : i + k]); i += k
        elif op == 4:
            r = eng.poll()
        else:
            _ = eng.last_point, eng.last_point_age_frames
            r = None
    eng.flush()

    assert [tuple(p) for p in eng.path] == [tuple(p) for p in sync.path]
    plen, x, y = eng.last_point
    assert plen == len(eng.path)
    assert (x, y) == tuple(eng.path[-1])


class _GatedStatus:
    """Fake status handle: is_ready() immediately, but the actual READ
    (np.asarray) blocks on an event — models the device→host read that the
    background harvester performs off-thread."""

    def __init__(self, vec, gate=None):
        self._vec = np.asarray(vec, np.int32)
        self._gate = gate

    def is_ready(self):
        return True

    def __array__(self, dtype=None, copy=None):
        if self._gate is not None:
            assert self._gate.wait(10.0), "gate never opened"
        v = self._vec
        return v.astype(dtype) if dtype is not None else v


def test_async_harvest_keeps_final_status_when_read_in_flight():
    """Regression: while a background status read is in flight, a newly
    completed status must be KEPT (not popped-and-dropped) — otherwise the
    FINAL status of a stream is lost forever and stop/last_point never
    surface, even through flush()."""
    import threading

    from real_time_audio_sync_tpu.models.online_core import StatusPolling

    p = StatusPolling()
    p._init_status_polling()
    p.poll_min_interval = 0.0
    gate = threading.Event()
    s1 = _GatedStatus([0, 1, 0, 0], gate)  # read blocks until the gate opens
    s2 = _GatedStatus([1, 2, 1, 1])  # FINAL status: stop flag set
    p._swap_status(s1)  # probe retires it; background read submitted (blocked)
    p._swap_status(s2)  # read in flight: s2 must stay harvestable
    gate.set()
    assert p.flush() == "stop"
    assert p._last_point == (2, 1, 1)

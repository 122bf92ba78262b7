"""Fused streaming engine (band-kernel inserts with state carried across
launches) vs the XLA engine, with the kernel in the Pallas interpreter."""

import numpy as np
import pytest

from real_time_audio_sync_tpu.models import OnlineTimeWarping
from real_time_audio_sync_tpu.models.fused_streaming import FusedStreamingEngine

from tests.test_online import _make_pair, _unit_cols


PARAMS = {"c": 10, "max_run_count": 3}


@pytest.mark.parametrize("seed,block,k_block", [
    (0, 8, 8), (1, 1, 8), (2, 5, 8),
    (3, 1, 1),  # per-frame engine program (bench diagnostic 3)
    (4, 5, 2),  # oversize feeds split across k_block=2 launches
])
def test_fused_streaming_matches_xla_engine(seed, block, k_block):
    rng = np.random.default_rng(seed)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    xla = OnlineTimeWarping(ref, PARAMS, dtype=np.float32)
    for i in range(live.shape[1]):
        if xla.insert(live[:, i]) == "stop":
            break

    fused = FusedStreamingEngine(ref, PARAMS, k_block=k_block, interpret=True)
    for s in range(0, live.shape[1], block):
        fused.insert_block_nowait(live[:, s : s + block])
    fused.flush()
    np.testing.assert_array_equal(fused.path_array, xla.path_array)


def test_fused_streaming_stop_and_freeze():
    rng = np.random.default_rng(4)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.0)
    extra = _unit_cols(rng.random((12, 30)) + 0.05)
    live = np.concatenate([live, extra], axis=1)

    xla = OnlineTimeWarping(ref, PARAMS, dtype=np.float32)
    for i in range(live.shape[1]):
        if xla.insert(live[:, i]) == "stop":
            break

    fused = FusedStreamingEngine(ref, PARAMS, k_block=8, interpret=True)
    for s in range(0, live.shape[1], 8):
        fused.insert_block_nowait(live[:, s : s + 8])
    assert fused.flush() == "stop"
    assert fused.insert_block_nowait(live[:, :8]) == "stop"  # cached verdict
    np.testing.assert_array_equal(fused.path_array, xla.path_array)
    plen, x, y = fused.last_point
    assert plen == len(fused.path)
    assert (x, y) == tuple(fused.path[-1])


@pytest.mark.parametrize("c,mrc", [(3, 3), (10, 1), (25, 5)])
def test_fused_streaming_config_sweep(c, mrc):
    """Band-width / slope-constraint sweep through the persistent-state
    streaming kernel (incl. the forced-alternation edge max_run_count=1)."""
    rng = np.random.default_rng(200 + c + mrc)
    ref, live = _make_pair(rng, n_ref=40, stretch=1.3)
    params = {"c": c, "max_run_count": mrc}
    xla = OnlineTimeWarping(ref, params, dtype=np.float32)
    for i in range(live.shape[1]):
        if xla.insert(live[:, i]) == "stop":
            break
    fused = FusedStreamingEngine(ref, params, k_block=8, interpret=True)
    for s in range(0, live.shape[1], 8):
        fused.insert_block_nowait(live[:, s : s + 8])
    fused.flush()
    np.testing.assert_array_equal(fused.path_array, xla.path_array)


def test_fused_streaming_capacity_freeze():
    """Live-buffer capacity exhaustion (otw_eran.py:50-54 "ran out of room"):
    t keeps incrementing with no further evaluation — fused matches XLA on a
    stream longer than the 2N live capacity."""
    rng = np.random.default_rng(31)
    ref = _unit_cols(rng.random((12, 30)) + 0.05)
    # adversarial live: unrelated content, longer than the 2N capacity
    live = _unit_cols(rng.random((12, 75)) + 0.05)
    params = {"c": 10, "max_run_count": 3}
    xla = OnlineTimeWarping(ref, params, dtype=np.float32)
    stopped = None
    for i in range(live.shape[1]):
        if xla.insert(live[:, i]) == "stop":
            stopped = i
            break
    fused = FusedStreamingEngine(ref, params, k_block=8, interpret=True)
    for s in range(0, live.shape[1], 8):
        fused.insert_block_nowait(live[:, s : s + 8])
    status = fused.flush()
    np.testing.assert_array_equal(fused.path_array, xla.path_array)
    assert (status == "stop") == bool(np.asarray(xla.state.stopped))


def test_fused_streaming_livenote_v2_variant():
    rng = np.random.default_rng(5)
    ref, live = _make_pair(rng, n_ref=40)
    ref_d = np.clip(np.diff(ref, axis=1), 0, np.inf)
    live_d = np.clip(np.diff(live, axis=1), 0, np.inf)
    from real_time_audio_sync_tpu.models import LiveNoteV2

    xla = LiveNoteV2(
        ref_d, {"search_band_width": 10, "max_run_count": 3}, chroma_diff=True, dtype=np.float32
    )
    for i in range(live_d.shape[1]):
        if xla.insert(live_d[:, i]) == "stop":
            break
    fused = FusedStreamingEngine(
        ref_d, PARAMS, interpret=True,
        cfg_overrides=dict(sentinel=float("inf"), run_count_init=0, monotone_path=True, euclidean=True),
    )
    for s in range(0, live_d.shape[1], 8):
        fused.insert_block_nowait(live_d[:, s : s + 8])
    fused.flush()
    np.testing.assert_array_equal(fused.path_array, xla.path_array)


@pytest.mark.parametrize("max_in_flight", [0, 2, 1000])
def test_adaptive_feed_matches_sync_path(max_in_flight):
    """feed() (adaptive dispatch coalescing) commits exactly the synchronous
    per-frame path regardless of how frames coalesce into launches:
    max_in_flight=0 forces maximal coalescing (every dispatch held until the
    4*k_block liveness cap), 1000 forces a dispatch per frame, 2 is the
    production regime."""
    rng = np.random.default_rng(7)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    xla = OnlineTimeWarping(ref, PARAMS, dtype=np.float32)
    for i in range(live.shape[1]):
        if xla.insert(live[:, i]) == "stop":
            break

    fused = FusedStreamingEngine(ref, PARAMS, k_block=8, interpret=True)
    fused.max_in_flight = max_in_flight
    for i in range(live.shape[1]):
        if fused.feed(live[:, i]) == "stop":
            break
    fused.flush()
    np.testing.assert_array_equal(fused.path_array, xla.path_array)
    if max_in_flight == 0:
        # saturated pipeline: multi-frame launches actually happened
        assert max(fused.dispatched_block_sizes, default=1) == 8
    if max_in_flight == 1000:
        # open pipeline: every frame dispatched the moment it arrived
        assert all(k == 1 for k in fused.dispatched_block_sizes)


def test_feed_never_buffers_when_pipeline_open():
    """At real-time pacing (pipeline drained between hops) feed() must
    dispatch every frame immediately — zero added input latency."""
    import jax

    rng = np.random.default_rng(8)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.0)
    fused = FusedStreamingEngine(ref, PARAMS, k_block=8, interpret=True)
    for i in range(min(20, live.shape[1])):
        fused.feed(live[:, i])
        assert len(fused._pending) == 0
        jax.block_until_ready(fused._state)  # device idle before next hop


def test_staleness_accounting():
    """Status harvests record how many frames ran ahead of the harvested
    position; a blocking flush always brings staleness to zero."""
    rng = np.random.default_rng(9)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.0)
    fused = FusedStreamingEngine(ref, PARAMS, k_block=8, interpret=True)
    fused.poll_min_interval = 0.0  # harvest as often as completion allows
    n = live.shape[1]
    for i in range(n):
        if fused.feed(live[:, i]) == "stop":
            break
    fused.flush()
    assert fused.last_point_age_frames == 0
    assert fused.staleness_log, "harvests must be recorded"
    assert all(0 <= s <= fused._frames_dispatched for s in fused.staleness_log)
    # the final (flush) harvest covers every dispatched frame
    assert fused.staleness_log[-1] == 0


def test_in_flight_probes_are_consistent():
    import jax

    rng = np.random.default_rng(10)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.0)
    fused = FusedStreamingEngine(ref, PARAMS, k_block=4, interpret=True)
    for s in range(0, 16, 4):
        fused.insert_block_nowait(live[:, s : s + 4])
    jax.block_until_ready([st for _, st in fused._outstanding])
    assert fused.in_flight() == 0
    assert fused.flush() is None or fused.flush() == "stop"


# ---------------------------------------------------------------------------
# Long references: the reference far longer than the band, the live history
# far longer than the ring (c=3: R=16 frames), so every column update reads
# older frames back from the ring that each launch rewrites
# ---------------------------------------------------------------------------

LONG = {"c": 3, "max_run_count": 3}


def _long_pair(seed, stretch=1.25):
    return _make_pair(np.random.default_rng(seed), n_ref=200, stretch=stretch)


def _xla_path(ref, live, params=LONG, **kw):
    xla = OnlineTimeWarping(ref, params, dtype=np.float32, **kw)
    for i in range(live.shape[1]):
        if xla.insert(live[:, i]) == "stop":
            break
    return xla.path_array


@pytest.mark.parametrize("seed,block,k_block", [
    (0, 8, 8),    # block streaming
    (1, 1, 8),    # per-frame inserts into an 8-frame program
    (2, 1, 1),    # per-frame engine program
    (3, 40, 40),  # launches longer than the ring
])
def test_long_ref_matches_xla_engine(seed, block, k_block):
    ref, live = _long_pair(seed)
    eng = FusedStreamingEngine(ref, LONG, k_block=k_block, interpret=True)
    for s in range(0, live.shape[1], block):
        eng.insert_block_nowait(live[:, s : s + block])
    eng.flush()
    np.testing.assert_array_equal(eng.path_array, _xla_path(ref, live))


def test_long_ref_feed_and_periodic_drains():
    """Adaptive feed with mid-stream path reads, which must not disturb the
    committed points."""
    ref, live = _long_pair(7)
    eng = FusedStreamingEngine(ref, LONG, k_block=8, interpret=True)
    for i in range(live.shape[1]):
        eng.feed(live[:, i])
        if i % 16 == 0:
            eng.flush()
            _ = eng.path_array  # mid-stream read
    eng.flush()
    np.testing.assert_array_equal(eng.path_array, _xla_path(ref, live))


def test_long_ref_stop_and_freeze():
    ref, live = _long_pair(4, stretch=1.0)
    extra = _unit_cols(np.random.default_rng(4).random((12, 60)) + 0.05)
    live = np.concatenate([live, extra], axis=1)
    eng = FusedStreamingEngine(ref, LONG, k_block=8, interpret=True)
    for s in range(0, live.shape[1], 8):
        eng.insert_block_nowait(live[:, s : s + 8])
    status = eng.flush()
    np.testing.assert_array_equal(eng.path_array, _xla_path(ref, live))
    if status == "stop":
        assert eng.insert_block_nowait(live[:, :8]) == "stop"


def test_long_ref_checkpoint_resume():
    """Mid-stream snapshot/restore continues bit-exactly (the live ring,
    band vectors and path travel through the checkpoint); a snapshot of a
    different k_block is rejected."""
    from real_time_audio_sync_tpu.utils.checkpoint import (
        load_fused_state,
        save_fused_state,
    )

    ref, live = _long_pair(9)
    import tempfile, os

    eng = FusedStreamingEngine(ref, LONG, k_block=8, interpret=True)
    cut = (live.shape[1] // 2) // 8 * 8 + 3  # mid-launch frame count
    for s in range(0, cut, 8):
        eng.insert_block_nowait(live[:, s : min(s + 8, cut)])
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "ck.npz")
        save_fused_state(eng, ck)
        res = FusedStreamingEngine(ref, LONG, k_block=8, interpret=True)
        load_fused_state(res, ck)
        for s in range(cut, live.shape[1], 8):
            res.insert_block_nowait(live[:, s : s + 8])
        res.flush()
        other = FusedStreamingEngine(ref, LONG, k_block=4, interpret=True)
        with pytest.raises(ValueError, match="k_block"):
            load_fused_state(other, ck)
    np.testing.assert_array_equal(res.path_array, _xla_path(ref, live))


def test_long_ref_livenote_v2_variant():
    """LiveNoteV2 config (monotone path guard + Euclidean chroma-diff cost)
    on a long reference; skipped appends leave launches with no new points."""
    ref, live = _long_pair(5)
    ref_d = np.clip(np.diff(ref, axis=1), 0, np.inf)
    live_d = np.clip(np.diff(live, axis=1), 0, np.inf)
    from real_time_audio_sync_tpu.models import LiveNoteV2

    xla = LiveNoteV2(
        ref_d, {"search_band_width": 3, "max_run_count": 3}, chroma_diff=True, dtype=np.float32
    )
    for i in range(live_d.shape[1]):
        if xla.insert(live_d[:, i]) == "stop":
            break
    eng = FusedStreamingEngine(
        ref_d, LONG, interpret=True,
        cfg_overrides=dict(sentinel=float("inf"), run_count_init=0, monotone_path=True, euclidean=True),
    )
    for s in range(0, live_d.shape[1], 8):
        eng.insert_block_nowait(live_d[:, s : s + 8])
    eng.flush()
    np.testing.assert_array_equal(eng.path_array, xla.path_array)


@pytest.mark.parametrize("exact", [False, True])
def test_long_ref_exact_chain_variant(exact):
    """Both chain forms of the kernel stream the XLA engine's path of the
    same form."""
    ref, live = _long_pair(12)
    eng = FusedStreamingEngine(ref, LONG, k_block=8, interpret=True,
                               cfg_overrides=dict(exact_chain=exact))
    for s in range(0, live.shape[1], 8):
        eng.insert_block_nowait(live[:, s : s + 8])
    eng.flush()
    np.testing.assert_array_equal(eng.path_array, _xla_path(ref, live, exact_chain=exact))


def test_checkpoint_flushes_pending_feed_frames(tmp_path):
    """save_fused_state must not lose feed()'s coalesce-pending columns
    (round-3 review finding): a saturated engine holds undispatched frames
    in the host-side queue, so the snapshot flushes them first and a
    restore clears the (already-snapshotted) queue."""
    from real_time_audio_sync_tpu.utils.checkpoint import (
        load_fused_state,
        save_fused_state,
    )

    rng = np.random.default_rng(13)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    xla = OnlineTimeWarping(ref, PARAMS, dtype=np.float32)
    for i in range(live.shape[1]):
        if xla.insert(live[:, i]) == "stop":
            break

    eng = FusedStreamingEngine(ref, PARAMS, k_block=8, interpret=True)
    eng.max_in_flight = 0  # saturate the pipeline: feed() only queues
    cut = min(live.shape[1] // 2, 4 * 8 - 1)  # below the liveness backstop
    for i in range(cut):
        eng.feed(live[:, i])
    assert eng._pending  # the hazard: columns still host-side

    ck = str(tmp_path / "pending.npz")
    save_fused_state(eng, ck)
    res = FusedStreamingEngine(ref, PARAMS, k_block=8, interpret=True)
    load_fused_state(res, ck)
    assert not res._pending
    for i in range(cut, live.shape[1]):
        res.feed(live[:, i])
    res.flush()
    np.testing.assert_array_equal(res.path_array, xla.path_array)


@pytest.mark.parametrize("seed,long_ref", [(51, False), (52, True)])
def test_fused_api_interleaving_fuzz(seed, long_ref):
    """Seeded fuzz over random interleavings of the fused engine's API
    (feed / insert_nowait / insert_block_nowait / poll / last_point /
    mid-stream path reads) under maximum harvest pressure: committed paths
    must equal the XLA engine's synchronous run, with a short and a long
    live history (``long_ref``: a ring of 16 frames wraps many times)."""
    rng = np.random.default_rng(seed)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    extra = _unit_cols(rng.random((12, 30)) + 0.05)
    live = np.concatenate([live, extra], axis=1).astype(np.float32)

    params = LONG if long_ref else PARAMS
    sync = OnlineTimeWarping(ref, params, dtype=np.float32)
    for i in range(live.shape[1]):
        if sync.insert(live[:, i]) == "stop":
            break

    eng = FusedStreamingEngine(ref, params, k_block=4, interpret=True)
    eng.poll_min_interval = 0.0
    i, r = 0, None
    while i < live.shape[1] and r != "stop":
        op = int(rng.integers(0, 5))
        if op == 0:
            r = eng.feed(live[:, i]); i += 1
        elif op == 1:
            r = eng.insert_nowait(live[:, i]); i += 1
        elif op == 2:
            k = min(int(rng.integers(1, 6)), live.shape[1] - i)
            r = eng.insert_block_nowait(live[:, i : i + k]); i += k
        elif op == 3:
            r = eng.poll()
        else:
            _ = eng.last_point, eng.last_point_age_frames
            if rng.integers(0, 2):
                _ = eng.path_array  # mid-stream path read
            r = None
    eng.flush()
    np.testing.assert_array_equal(eng.path_array, sync.path_array)
    plen, x, y = eng.last_point
    assert plen == len(eng.path)
    assert (x, y) == tuple(eng.path[-1])


def test_block_api_preserves_feed_queue_order():
    """insert_block_nowait after feed() under a saturated pipeline must
    dispatch the queued feed frames FIRST — mixing the two APIs must not
    reorder the stream."""
    rng = np.random.default_rng(53)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    live = live.astype(np.float32)

    sync = OnlineTimeWarping(ref, PARAMS, dtype=np.float32)
    for i in range(live.shape[1]):
        if sync.insert(live[:, i]) == "stop":
            break

    eng = FusedStreamingEngine(ref, PARAMS, k_block=8, interpret=True)
    eng.max_in_flight = 0  # saturate: feed() only queues
    for i in range(10):
        eng.feed(live[:, i])
    assert eng._pending
    eng.insert_block_nowait(live[:, 10:20])
    assert not eng._pending
    for i in range(20, live.shape[1]):
        eng.insert_nowait(live[:, i])
    eng.flush()
    np.testing.assert_array_equal(eng.path_array, sync.path_array)


def test_feed_copies_queued_columns():
    """Regression: under saturation feed()'s column stays QUEUED past the
    call, so a caller reusing one buffer per hop (the natural streaming
    loop) must not mutate the queued entry — feed copies on ingest."""
    rng = np.random.default_rng(41)
    ref, live = _make_pair(rng, n_ref=40, stretch=1.2)
    cut = min(live.shape[1], 4 * 8 - 1)  # below the liveness backstop

    fresh = FusedStreamingEngine(ref, PARAMS, k_block=8, interpret=True)
    fresh.max_in_flight = 0  # saturate: feed() only queues
    for i in range(cut):
        fresh.feed(live[:, i])
    fresh.flush()

    reused = FusedStreamingEngine(ref, PARAMS, k_block=8, interpret=True)
    reused.max_in_flight = 0
    buf = np.zeros(live.shape[0], np.float32)
    for i in range(cut):
        buf[:] = live[:, i]  # caller reuses ONE buffer per hop
        reused.feed(buf)
    buf[:] = -1.0  # and clobbers it after the last hop
    reused.flush()

    assert [tuple(p) for p in reused.path] == [tuple(p) for p in fresh.path]

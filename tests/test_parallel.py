"""Multi-chip paths on the 8-virtual-device CPU mesh (conftest)."""

import time

import jax
import numpy as np
import pytest

from real_time_audio_sync_tpu.models import OnlineTimeWarping
from real_time_audio_sync_tpu.parallel import (
    batched_set_live,
    corpus_mesh,
    pad_pairs,
    sharded_chroma_frames,
)

from tests.test_online import _make_pair


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_pad_pairs_shapes():
    rng = np.random.default_rng(0)
    refs = [rng.random((12, n)) for n in (30, 45, 37)]
    lives = [rng.random((12, t)) for t in (50, 33, 61)]
    r, l, rl, ll = pad_pairs(refs, lives, pad_multiple=8)
    assert r.shape == (3, 12, 48) and l.shape == (3, 12, 64)
    assert list(rl) == [30, 45, 37] and list(ll) == [50, 33, 61]
    np.testing.assert_array_equal(r[0, :, :30], refs[0])
    assert np.all(r[0, :, 30:] == 0)


def test_batched_matches_single_engine():
    """Padded+vmapped batch alignment reproduces each pair's solo path."""
    rng = np.random.default_rng(3)
    pairs = [_make_pair(rng, n_ref=40 + 7 * i, stretch=1.2 + 0.1 * i) for i in range(4)]
    refs = [p[0] for p in pairs]
    lives = [p[1] for p in pairs]
    params = {"c": 10, "max_run_count": 3}

    solo_paths = []
    for ref, live in pairs:
        eng = OnlineTimeWarping(ref, params, dtype=np.float64)
        eng.set_live(live)
        solo_paths.append(eng.path_array)

    r, l, rl, ll = pad_pairs(refs, lives)
    batch_paths, mean_len = batched_set_live(r, l, rl, ll, params, dtype=np.float64)
    for got, want in zip(batch_paths, solo_paths):
        np.testing.assert_array_equal(got, want)
    assert float(mean_len) == pytest.approx(np.mean([len(p) for p in solo_paths]))


def test_batched_sharded_over_mesh():
    """Same result when the batch is sharded across all 8 devices."""
    rng = np.random.default_rng(4)
    pairs = [_make_pair(rng, n_ref=40, stretch=1.25) for _ in range(8)]
    refs = [p[0] for p in pairs]
    lives = [p[1] for p in pairs]
    params = {"c": 10, "max_run_count": 3}
    r, l, rl, ll = pad_pairs(refs, lives)

    plain, _ = batched_set_live(r, l, rl, ll, params, dtype=np.float64)
    mesh = corpus_mesh()
    sharded, mean_len = batched_set_live(r, l, rl, ll, params, mesh=mesh, dtype=np.float64)
    for got, want in zip(sharded, plain):
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(float(mean_len))


def test_sharded_chroma_matches_single_device():
    from real_time_audio_sync_tpu.features.chroma import chroma_frames

    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    frames = rng.standard_normal((16, 4096))
    mesh = corpus_mesh()
    sharded = np.asarray(sharded_chroma_frames(frames, mesh, dtype=np.float64))
    single = np.asarray(chroma_frames(jnp.asarray(frames, jnp.float64)))
    np.testing.assert_allclose(sharded, single, rtol=1e-12, atol=1e-14)


def test_multistream_matches_solo_engines():
    """B concurrent streams (mixed reference lengths) through one vmapped
    dispatch per frame match each solo engine exactly."""
    from real_time_audio_sync_tpu.parallel.serving import MultiStreamFollower

    rng = np.random.default_rng(7)
    pairs = [_make_pair(rng, n_ref=30 + 9 * i, stretch=1.1 + 0.15 * i) for i in range(4)]
    refs = [p[0] for p in pairs]
    lives = [p[1] for p in pairs]
    params = {"c": 10, "max_run_count": 3}

    solo = []
    for ref, live in pairs:
        eng = OnlineTimeWarping(ref, params, dtype=np.float64)
        for i in range(live.shape[1]):
            if eng.insert(live[:, i]) == "stop":
                break
        solo.append(eng)

    ms = MultiStreamFollower(refs, params, dtype=np.float64)
    max_t = max(l.shape[1] for l in lives)
    for step in range(max_t):
        cols = np.zeros((4, 12))
        active = np.zeros(4, bool)
        for k, live in enumerate(lives):
            if step < live.shape[1]:
                cols[k] = live[:, step]
                active[k] = True
        ms.insert(cols, active)

    for k, eng in enumerate(solo):
        np.testing.assert_array_equal(ms.paths()[k], eng.path_array)
        assert bool(ms.stopped[k]) == bool(eng.state.stopped)


def test_multistream_sharded_over_mesh_matches_solo():
    """Serving sharded over the 8-device mesh (B/n_chips streams per chip,
    zero collectives): per-stream paths match the solo engines exactly."""
    from real_time_audio_sync_tpu.parallel import corpus_mesh
    from real_time_audio_sync_tpu.parallel.serving import MultiStreamFollower

    rng = np.random.default_rng(11)
    pairs = [_make_pair(rng, n_ref=28 + 3 * i, stretch=1.1 + 0.05 * i) for i in range(8)]
    refs = [p[0] for p in pairs]
    lives = [p[1] for p in pairs]
    params = {"c": 10, "max_run_count": 3}

    solo = []
    for ref, live in pairs:
        eng = OnlineTimeWarping(ref, params, dtype=np.float64)
        for i in range(live.shape[1]):
            if eng.insert(live[:, i]) == "stop":
                break
        solo.append(eng)

    mesh = corpus_mesh()
    ms = MultiStreamFollower(refs, params, dtype=np.float64, mesh=mesh)
    # one stream group per device
    assert len(set(d for s in jax.tree.leaves(ms.states) for d in s.sharding.device_set)) == 8
    max_t = max(l.shape[1] for l in lives)
    for step in range(max_t):
        cols = np.zeros((8, 12))
        active = np.zeros(8, bool)
        for k, live in enumerate(lives):
            if step < live.shape[1]:
                cols[k] = live[:, step]
                active[k] = True
        ms.insert(cols, active)

    for k, eng in enumerate(solo):
        np.testing.assert_array_equal(ms.paths()[k], eng.path_array)
        assert bool(ms.stopped[k]) == bool(eng.state.stopped)


def test_multistream_multi_axis_mesh_shards_fully():
    """A 2-D mesh partitions the stream batch by the FULL device count (a
    single-axis spec would silently replicate across the second axis)."""
    from jax.sharding import Mesh
    from real_time_audio_sync_tpu.parallel.serving import MultiStreamFollower

    rng = np.random.default_rng(13)
    refs = [_make_pair(rng, n_ref=24)[0] for _ in range(8)]
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("x", "y"))
    ms = MultiStreamFollower(refs, {"c": 10, "max_run_count": 3}, mesh=mesh)
    shard_shape = ms.states.acc.sharding.shard_shape(ms.states.acc.shape)
    assert shard_shape[0] == 1  # one stream per device, not 4x replication
    lives = [_make_pair(rng, n_ref=24)[1] for _ in range(8)]
    for step in range(10):
        cols = np.stack([lv[:, step] for lv in lives])
        ms.insert(cols)
    t_ptrs, _ = ms.pointers()
    assert (t_ptrs == 9).all()


def test_multistream_mesh_requires_divisible_batch():
    from real_time_audio_sync_tpu.parallel import corpus_mesh
    from real_time_audio_sync_tpu.parallel.serving import MultiStreamFollower

    rng = np.random.default_rng(12)
    refs = [_make_pair(rng, n_ref=30)[0] for _ in range(3)]
    with pytest.raises(ValueError, match="divisible"):
        MultiStreamFollower(refs, {"c": 10, "max_run_count": 3}, mesh=corpus_mesh())


# ---------------------------------------------------------------------------
# Fused multi-stream serving — the band kernel, O(c) state per stream, in the
# Pallas interpreter
# ---------------------------------------------------------------------------

FMS_PARAMS = {"c": 10, "max_run_count": 3}
# long live histories: c=3 gives a 16-frame ring that wraps many times
LONG = {"c": 3, "max_run_count": 3}


def _solo_fused_path(ref, live, params=FMS_PARAMS):
    from real_time_audio_sync_tpu.models.fused_streaming import FusedStreamingEngine

    e = FusedStreamingEngine(ref, params, k_block=8, interpret=True)
    for i in range(live.shape[1]):
        if e.feed(live[:, i]) == "stop":
            break
    e.flush()
    return e.path_array


def test_fused_multistream_matches_solo_mixed_refs():
    """B streams against different (padded) references commit exactly the
    solo fused engine's paths, including per-stream stop divergence."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower

    rng = np.random.default_rng(0)
    pairs = [_make_pair(rng, n_ref=32 + 8 * i, stretch=1.0 + 0.2 * i) for i in range(3)]
    solo = [_solo_fused_path(r, l) for r, l in pairs]

    fms = FusedMultiStreamFollower([r for r, _ in pairs], FMS_PARAMS, k_block=8, interpret=True)
    tmax = max(l.shape[1] for _, l in pairs)
    for t in range(tmax):
        cols = np.zeros((3, 12), np.float32)
        act = np.zeros(3, bool)
        for i, (_, l) in enumerate(pairs):
            if t < l.shape[1]:
                cols[i], act[i] = l[:, t], True
        fms.feed(cols, act)
    fms.flush()
    for i, p in enumerate(fms.paths()):
        np.testing.assert_array_equal(p, solo[i])
    # last_points reflect each stream's committed path tail after flush
    for i, p in enumerate(fms.paths()):
        assert tuple(fms.last_points[i]) == (len(p), *p[-1])


def test_fused_multistream_default_is_windowed_kernel():
    """One kernel, two reference layouts: a shared reference (one padded
    copy read by every program) and per-stream references commit bit-equal
    paths for the same streams."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower

    rng = np.random.default_rng(33)
    ref, live = _make_pair(rng, n_ref=40, stretch=1.1)

    def run(ref_arg, **kw):
        fms = FusedMultiStreamFollower(ref_arg, FMS_PARAMS, k_block=8, interpret=True, **kw)
        for t in range(live.shape[1]):
            fms.feed(np.repeat(live[None, :, t], 2, axis=0))
        fms.flush()
        return fms, fms.paths()

    shared_fms, shared_paths = run(ref, n_streams=2)
    assert shared_fms.shared_ref and shared_fms._ref_dev.shape[0] == 1
    own_fms, own_paths = run([ref, ref])
    assert not own_fms.shared_ref and own_fms._ref_dev.shape[0] == 2
    for pd, pw in zip(shared_paths, own_paths):
        np.testing.assert_array_equal(pd, pw)


def test_fused_multistream_shared_ref_skewed_feeds():
    """Shared-reference mode with a half-rate stream: committed paths are
    feed-skew independent and equal to the solo engine's."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower

    rng = np.random.default_rng(1)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.2)
    solo = _solo_fused_path(ref, live)

    fms = FusedMultiStreamFollower(ref, FMS_PARAMS, n_streams=2, k_block=8, interpret=True)
    t2 = 0
    for t in range(live.shape[1] * 2):
        cols = np.zeros((2, 12), np.float32)
        act = np.zeros(2, bool)
        if t < live.shape[1]:
            cols[0], act[0] = live[:, t], True
        if t % 2 == 0 and t2 < live.shape[1]:
            cols[1], act[1] = live[:, t2], True
            t2 += 1
        fms.feed(cols, act)
    fms.flush()
    for p in fms.paths():
        np.testing.assert_array_equal(p, solo)


def test_fused_multistream_stop_and_freeze():
    """A stream whose reference is exhausted freezes (post-stop feeds are
    no-ops) and surfaces in the stopped mask without a blocking flush."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower

    rng = np.random.default_rng(2)
    ref, live = _make_pair(rng, n_ref=24, stretch=1.0)
    from tests.test_online import _unit_cols

    extra = _unit_cols(rng.random((12, 40)) + 0.05)
    long_live = np.concatenate([live, extra], axis=1)
    solo = _solo_fused_path(ref, long_live)

    fms = FusedMultiStreamFollower(ref, FMS_PARAMS, n_streams=1, k_block=8, interpret=True)
    fms.poll_min_interval = 0.0
    seen_before_flush = False
    for t in range(long_live.shape[1]):
        stopped = fms.feed(long_live[None, :, t])
        if stopped[0]:
            seen_before_flush = True
            break
    else:
        # the live ran out before the async status pipeline surfaced the
        # stop — keep polling (non-blocking, like a UI would) with a
        # generous deadline; the background read completes in microseconds
        # once the worker thread is scheduled
        jax.block_until_ready(fms._outstanding)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if fms.poll()[0]:
                seen_before_flush = True
                break
            time.sleep(0.01)
    assert fms.flush()[0]
    assert seen_before_flush
    np.testing.assert_array_equal(fms.paths()[0], solo)


def test_fused_multistream_sharded_over_mesh_matches_solo():
    """Stream axis sharded over the 8-virtual-device mesh via shard_map
    (each device runs B/8 programs; zero collectives)."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower, corpus_mesh

    rng = np.random.default_rng(3)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.1)
    solo = _solo_fused_path(ref, live)
    mesh = corpus_mesh()
    fms = FusedMultiStreamFollower(
        ref, FMS_PARAMS, n_streams=8, k_block=8, interpret=True, mesh=mesh
    )
    for t in range(live.shape[1]):
        fms.feed(np.repeat(live[None, :, t], 8, axis=0))
    fms.flush()
    for p in fms.paths():
        np.testing.assert_array_equal(p, solo)


def test_batched_set_live_banded_matches_dense():
    """The banded (band kernel) corpus backend commits exactly the dense
    XLA scan's paths; dense stays available as the debug/f64 artifact."""
    from real_time_audio_sync_tpu.parallel import batched_set_live, pad_pairs

    rng = np.random.default_rng(11)
    pairs = [_make_pair(rng, n_ref=24 + 4 * i, stretch=1.0 + 0.1 * i) for i in range(3)]
    r, l, rl, ll = pad_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    params = {"c": 8, "max_run_count": 3}
    banded, mean_b = batched_set_live(r, l, rl, ll, params, backend="banded", interpret=True)
    dense, mean_d = batched_set_live(r, l, rl, ll, params, backend="dense")
    for pb, pd in zip(banded, dense):
        np.testing.assert_array_equal(np.asarray(pb), np.asarray(pd))
    assert abs(float(mean_b) - float(mean_d)) < 1e-6


def test_batched_set_live_banded_sharded_over_mesh():
    from real_time_audio_sync_tpu.parallel import batched_set_live, corpus_mesh, pad_pairs

    rng = np.random.default_rng(12)
    pairs = [_make_pair(rng, n_ref=24, stretch=1.2) for _ in range(8)]
    r, l, rl, ll = pad_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    params = {"c": 8, "max_run_count": 3}
    solo, _ = batched_set_live(r, l, rl, ll, params, backend="banded", interpret=True)
    mesh = corpus_mesh()
    sharded, mean_len = batched_set_live(r, l, rl, ll, params, mesh=mesh, backend="banded",
                                         interpret=True)
    for ps, pm in zip(solo, sharded):
        np.testing.assert_array_equal(np.asarray(ps), np.asarray(pm))
    assert float(mean_len) > 0


# ---------------------------------------------------------------------------
# Long references and live histories: the ring (16 frames at c=3) wraps
# many times per stream
# ---------------------------------------------------------------------------


def test_fused_multistream_long_ref_mixed_refs():
    """B streams against different (padded) references far longer than the
    band commit exactly the solo engine's paths, including per-stream stop
    divergence and a mid-stream path read."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower

    rng = np.random.default_rng(21)
    pairs = [_make_pair(rng, n_ref=96 + 32 * i, stretch=1.0 + 0.2 * i) for i in range(3)]
    solo = [_solo_fused_path(r, l, LONG) for r, l in pairs]

    fms = FusedMultiStreamFollower([r for r, _ in pairs], LONG, k_block=8, interpret=True)
    tmax = max(l.shape[1] for _, l in pairs)
    for t in range(tmax):
        cols = np.zeros((3, 12), np.float32)
        act = np.zeros(3, bool)
        for i, (_, l) in enumerate(pairs):
            if t < l.shape[1]:
                cols[i], act[i] = l[:, t], True
        fms.feed(cols, act)
        if t == tmax // 2:
            _ = fms.paths()  # mid-stream drain must not lose/duplicate points
    fms.flush()
    for i, p in enumerate(fms.paths()):
        np.testing.assert_array_equal(p, solo[i])


def test_fused_multistream_long_ref_skewed_feeds():
    """Shared long reference with a half-rate stream: a stream with fewer
    columns in a launch reads more of its frames back from its ring, and
    committed paths are feed-skew independent and equal to solo."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower

    rng = np.random.default_rng(23)
    ref, live = _make_pair(rng, n_ref=128, stretch=1.2)
    solo = _solo_fused_path(ref, live, LONG)

    fms = FusedMultiStreamFollower(ref, LONG, n_streams=2, k_block=8, interpret=True)
    t2 = 0
    for t in range(live.shape[1] * 2):
        cols = np.zeros((2, 12), np.float32)
        act = np.zeros(2, bool)
        if t < live.shape[1]:
            cols[0], act[0] = live[:, t], True
        if t % 2 == 0 and t2 < live.shape[1]:
            cols[1], act[1] = live[:, t2], True
            t2 += 1
        fms.feed(cols, act)
    fms.flush()
    for p in fms.paths():
        np.testing.assert_array_equal(p, solo)


def test_fused_multistream_long_ref_folding():
    """Frequent mid-stream path reads (every 3 launches' worth of frames)
    leave the committed paths exact."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower

    rng = np.random.default_rng(22)
    ref, live = _make_pair(rng, n_ref=128, stretch=1.2)
    solo = _solo_fused_path(ref, live, LONG)

    fms = FusedMultiStreamFollower(ref, LONG, n_streams=2, k_block=8, interpret=True)
    for t in range(live.shape[1]):
        fms.feed(np.repeat(live[None, :, t], 2, axis=0))
        if t % 24 == 0:
            fms.flush()
            _ = fms.paths()
    fms.flush()
    for p in fms.paths():
        np.testing.assert_array_equal(p, solo)


def test_fused_multistream_long_ref_over_mesh():
    """A long reference served over the 8-virtual-device mesh via
    shard_map."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower, corpus_mesh

    rng = np.random.default_rng(23)
    ref, live = _make_pair(rng, n_ref=96, stretch=1.1)
    solo = _solo_fused_path(ref, live, LONG)
    mesh = corpus_mesh()
    fms = FusedMultiStreamFollower(ref, LONG, n_streams=8, k_block=8,
                                   interpret=True, mesh=mesh)
    for t in range(live.shape[1]):
        fms.feed(np.repeat(live[None, :, t], 8, axis=0))
    fms.flush()
    for p in fms.paths():
        np.testing.assert_array_equal(p, solo)


def test_fused_multistream_long_ref_checkpoint():
    """Mid-stream snapshot/restore of the follower continues bit-exactly
    (rings, band vectors and paths travel through the checkpoint); a
    k_block mismatch on load is rejected."""
    import os
    import tempfile

    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower
    from real_time_audio_sync_tpu.utils.checkpoint import (
        load_multi_stream_state,
        save_multi_stream_state,
    )

    rng = np.random.default_rng(24)
    ref, live = _make_pair(rng, n_ref=96, stretch=1.2)
    solo = _solo_fused_path(ref, live, LONG)

    fms = FusedMultiStreamFollower(ref, LONG, n_streams=2, k_block=8, interpret=True)
    cut = live.shape[1] // 2
    for t in range(cut):
        fms.feed(np.repeat(live[None, :, t], 2, axis=0))
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "fms.npz")
        save_multi_stream_state(fms, ck)
        res = FusedMultiStreamFollower(ref, LONG, n_streams=2, k_block=8, interpret=True)
        load_multi_stream_state(res, ck)
        for t in range(cut, live.shape[1]):
            res.feed(np.repeat(live[None, :, t], 2, axis=0))
        res.flush()
        other = FusedMultiStreamFollower(ref, LONG, n_streams=2, k_block=4, interpret=True)
        with pytest.raises(ValueError, match="k_block"):
            load_multi_stream_state(other, ck)
    for p in res.paths():
        np.testing.assert_array_equal(p, solo)


@pytest.mark.parametrize("seed,long_ref", [(61, False), (62, True)])
def test_fused_multistream_api_interleaving_fuzz(seed, long_ref):
    """Seeded fuzz over the serving API: random per-stream feed skew,
    opportunistic poll/stopped/last_points reads and mid-stream paths()
    drains under maximum harvest pressure — committed paths must equal the
    solo engine's, with short and long (``long_ref``) live histories."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower

    rng = np.random.default_rng(seed)
    params = LONG if long_ref else FMS_PARAMS
    ref, live = _make_pair(rng, n_ref=64 if long_ref else 32, stretch=1.2)
    solo = _solo_fused_path(ref, live, params)

    fms = FusedMultiStreamFollower(ref, params, n_streams=3, k_block=8, interpret=True)
    fms.poll_min_interval = 0.0
    ptrs = [0, 0, 0]
    while min(ptrs) < live.shape[1]:
        cols = np.zeros((3, 12), np.float32)
        act = np.zeros(3, bool)
        for i in range(3):
            if ptrs[i] < live.shape[1] and rng.integers(0, 3):
                cols[i], act[i] = live[:, ptrs[i]], True
                ptrs[i] += 1
        fms.feed(cols, act)
        op = int(rng.integers(0, 4))
        if op == 0:
            fms.poll()
        elif op == 1:
            _ = fms.last_points
        elif op == 2 and rng.integers(0, 4) == 0:
            _ = fms.paths()  # mid-stream path read
    fms.flush()
    for p in fms.paths():
        np.testing.assert_array_equal(p, solo)


def test_batched_harvest_keeps_final_status_when_read_in_flight():
    """Regression (same bug class as the solo StatusPolling): a completed
    status retired while a background read is in flight must be kept — the
    final per-stream stop mask would otherwise be lost irrecoverably."""
    import threading

    from real_time_audio_sync_tpu.parallel.polling import BatchedStatusPolling
    from tests.test_online import _GatedStatus

    class Follower(BatchedStatusPolling):
        def __init__(self):
            self._stopped = np.zeros(2, bool)
            self._init_batched_polling()
            self.poll_min_interval = 0.0

        def _consume(self, vec):
            self._stopped |= (vec[:, 0] & 1).astype(bool)

    f = Follower()
    gate = threading.Event()
    s1 = _GatedStatus(np.zeros((2, 8), np.int32), gate)
    final = np.zeros((2, 8), np.int32)
    final[:, 0] = 1  # every stream stopped
    s2 = _GatedStatus(final)
    f._outstanding.append(s1)
    f._poll_status()  # retires s1; background read submitted (blocked)
    f._outstanding.append(s2)
    f._poll_status()  # read in flight: s2 must stay harvestable
    gate.set()
    f._settle_status()
    assert f._stopped.all()


def test_multistream_consume_is_monotone_per_stream():
    """Regression: with concurrent pollers a background read can settle
    AFTER a newer vector was consumed (polling.py thread model).  The
    cumulative (plen, live) status rows must never move last_points
    BACKWARDS — the batched analog of the solo stale-vector guard
    (online_core._consume_status)."""
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower

    rng = np.random.default_rng(44)
    ref, _ = _make_pair(rng, n_ref=32, stretch=1.0)
    fms = FusedMultiStreamFollower(ref, FMS_PARAMS, n_streams=2, k_block=8,
                                   interpret=True)
    newer = np.zeros((2, 8), np.int32)
    newer[0, 1:4] = (5, 9, 7)  # stream 0: plen 5 at (9, 7)
    newer[1, 1:4] = (3, 4, 4)
    fms._consume(newer)
    older = np.zeros((2, 8), np.int32)
    older[0, 1:4] = (4, 8, 6)  # stale for stream 0 ...
    older[1, 1:4] = (3, 6, 5)  # ... but NEWER for stream 1 (same plen)
    fms._consume(older)
    assert tuple(fms._last_points[0]) == (5, 9, 7)  # kept
    assert tuple(fms._last_points[1]) == (3, 6, 5)  # advanced row-wise


def test_batched_set_live_banded_delegates_long_pairs():
    """Long pairs of ragged lengths run in the same single launch as short
    ones (state is O(c) per pair whatever the length): the banded backend
    commits the dense scan's paths."""
    from real_time_audio_sync_tpu.parallel import batched_set_live, pad_pairs

    rng = np.random.default_rng(21)
    pairs = [_make_pair(rng, n_ref=96 + 40 * i, stretch=1.0 + 0.15 * i) for i in range(2)]
    r, l, rl, ll = pad_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    banded, mean_b = batched_set_live(r, l, rl, ll, LONG, backend="banded", interpret=True)
    dense, mean_d = batched_set_live(r, l, rl, ll, LONG, backend="dense")
    for pd, pg in zip(dense, banded):
        np.testing.assert_array_equal(np.asarray(pd), np.asarray(pg))
    assert abs(float(mean_d) - float(mean_b)) < 1e-6

    with pytest.raises(RuntimeError, match="interpret=True"):
        batched_set_live(r, l, rl, ll, LONG, backend="banded")


def test_multistream_feed_copies_queued_columns():
    """Same hazard as the solo feed: queued (B, F) column rows must be
    copied on ingest, not aliased to the caller's reused batch buffer."""
    from real_time_audio_sync_tpu.parallel.serving import FusedMultiStreamFollower

    rng = np.random.default_rng(43)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.1)
    cut = min(live.shape[1], 4 * 8 - 1)

    fresh = FusedMultiStreamFollower(
        ref, FMS_PARAMS, n_streams=2, k_block=8, interpret=True)
    fresh.max_in_flight = 0  # saturate: feed() only queues
    for t in range(cut):
        fresh.feed(np.repeat(live[None, :, t], 2, axis=0))
    fresh.flush()

    reused = FusedMultiStreamFollower(
        ref, FMS_PARAMS, n_streams=2, k_block=8, interpret=True)
    reused.max_in_flight = 0
    buf = np.zeros((2, live.shape[0]), np.float32)
    for t in range(cut):
        buf[:] = live[:, t]
        reused.feed(buf)
    buf[:] = -1.0
    reused.flush()

    for pf, pr in zip(fresh.paths(), reused.paths()):
        np.testing.assert_array_equal(pf, pr)


def test_multistream_feed_past_queue_capacity():
    """Feeding past 4*k_block queued columns must force a dispatch even with
    the launch pipeline saturated (max_in_flight=0): the columnar queue is a
    fixed (B, 4*k_block, F) buffer, so a broken drain invariant would either
    overflow the append index or drop frames.  Paths must match the solo
    engine's exactly through the forced-dispatch boundary."""
    from real_time_audio_sync_tpu.parallel.serving import FusedMultiStreamFollower

    rng = np.random.default_rng(44)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.0)
    k = 4
    assert live.shape[1] > 5 * k  # crosses the 4*k_block boundary twice

    fms = FusedMultiStreamFollower(
        ref, FMS_PARAMS, n_streams=2, k_block=k, interpret=True)
    fms.max_in_flight = 0  # only the capacity rule may dispatch
    for t in range(live.shape[1]):
        fms.feed(np.repeat(live[None, :, t], 2, axis=0))
        assert int(fms._pend_n.max()) < 4 * k
    fms.flush()

    from real_time_audio_sync_tpu.models.fused_streaming import FusedStreamingEngine

    solo = FusedStreamingEngine(ref, FMS_PARAMS, k_block=k, interpret=True)
    for t in range(live.shape[1]):
        solo.feed(live[:, t])
    solo.flush()
    for p in fms.paths():
        np.testing.assert_array_equal(p, solo.path_array)

"""The band kernel (ops/pallas_otw.py) in the Pallas interpreter: set_live
against the XLA engine and the f64 oracle, batched launches, the wrapper's
padding and state layout."""

import numpy as np
import pytest

from real_time_audio_sync_tpu.models import LiveNote, LiveNoteV2, OnlineTimeWarping
from real_time_audio_sync_tpu.ops import pallas_otw as po
from real_time_audio_sync_tpu.ops.pallas_otw import pallas_batched_set_live, pallas_set_live

from tests.oracle import OracleOTW
from tests.test_online import _make_pair

PARAMS = {"c": 10, "max_run_count": 3}


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_otw_matches_xla_engine(seed):
    rng = np.random.default_rng(seed)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    xla = OnlineTimeWarping(ref, PARAMS, dtype=np.float32)
    xla.set_live(live)

    path, t, j, stopped = pallas_set_live(ref, live, PARAMS, interpret=True)
    np.testing.assert_array_equal(path, xla.path_array)
    assert t == xla.live_ptr
    assert j == xla.ref_ptr


def test_pallas_livenote_variant():
    rng = np.random.default_rng(2)
    ref, live = _make_pair(rng, n_ref=40)
    xla = LiveNote(ref, {"search_band_width": 10, "max_run_count": 3}, dtype=np.float32)
    xla.set_live(live)
    path, t, j, stopped = pallas_set_live(
        ref, live, PARAMS, interpret=True, sentinel=float("inf"), run_count_init=0
    )
    np.testing.assert_array_equal(path, xla.path_array)


def test_pallas_v2_monotone_euclidean():
    rng = np.random.default_rng(3)
    ref, live = _make_pair(rng, n_ref=40)
    ref_d = np.clip(np.diff(ref, axis=1), 0, np.inf)
    live_d = np.clip(np.diff(live, axis=1), 0, np.inf)
    xla = LiveNoteV2(
        ref_d, {"search_band_width": 10, "max_run_count": 3}, chroma_diff=True, dtype=np.float32
    )
    xla.set_live(live_d)
    path, t, j, stopped = pallas_set_live(
        ref_d, live_d, PARAMS, interpret=True,
        sentinel=float("inf"), run_count_init=0, monotone_path=True, euclidean=True,
    )
    np.testing.assert_array_equal(path, xla.path_array)


def test_pallas_wide_band_crosses_lane_tile():
    """c > 127 makes the band vectors 256 wide (R = 256); shifts, chain
    tile and masks must stay exact at that width."""
    rng = np.random.default_rng(6)
    ref, live = _make_pair(rng, n_ref=150, stretch=1.2)
    params = {"c": 130, "max_run_count": 3}
    assert po.band_width(130) == 256
    xla = OnlineTimeWarping(ref, params, dtype=np.float32)
    xla.set_live(live)
    path, t, j, stopped = pallas_set_live(ref, live, params, interpret=True)
    np.testing.assert_array_equal(path, xla.path_array)


def test_pallas_ref_exhaustion_stop():
    rng = np.random.default_rng(4)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.0)
    extra = rng.random((12, 30))
    extra /= np.linalg.norm(extra, axis=0, keepdims=True)
    live = np.concatenate([live, extra], axis=1)
    xla = OnlineTimeWarping(ref, PARAMS, dtype=np.float32)
    xla.set_live(live)
    path, t, j, stopped = pallas_set_live(ref, live, PARAMS, interpret=True)
    np.testing.assert_array_equal(path, xla.path_array)
    assert stopped == (j >= ref.shape[1])


def test_pallas_batched_set_live_matches_solo():
    """One launch over ragged pairs (one program per pair) == per-pair
    pallas_set_live, with early per-pair exits."""
    rng = np.random.default_rng(5)
    pairs = [_make_pair(rng, n_ref=24 + 6 * i, stretch=1.0 + 0.15 * i) for i in range(4)]
    solo = [pallas_set_live(r, l, PARAMS, interpret=True) for r, l in pairs]
    batched = pallas_batched_set_live(
        [r for r, _ in pairs], [l for _, l in pairs], PARAMS, interpret=True
    )
    for (bp, bt, bj, bs), (sp, st, sj, ss) in zip(batched, solo):
        np.testing.assert_array_equal(bp, sp)
        assert (bt, bj, bs) == (st, sj, ss)


def test_pallas_batched_set_live_shared_ref():
    rng = np.random.default_rng(6)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.25)
    sp, st, sj, ss = pallas_set_live(ref, live, PARAMS, interpret=True)
    lens, ref_arr, _, _ = po.batched_set_live_arrays([ref] * 3, [live] * 3, po.online_config(PARAMS))
    assert ref_arr.shape[0] == 1  # one padded reference serves every program
    batched = pallas_batched_set_live([ref] * 3, [live] * 3, PARAMS, interpret=True)
    for bp, bt, bj, bs in batched:
        np.testing.assert_array_equal(bp, sp)
        assert (bt, bj, bs) == (st, sj, ss)


def _set_live_in_launches(ref, live, params, k, **cfg_kw):
    """set_live as K-frame streaming launches of the kernel from the
    origin-seeded state: frames of earlier launches come back from the
    live ring, not the block."""
    cfg = po.online_config(params, **cfg_kw)
    lens, ref_arr, cols, state = po.batched_set_live_arrays([ref], [live], cfg)
    t = live.shape[1]
    for s in range(0, t, k):
        blk = cols[:, s : s + k]
        ln = lens.copy()
        ln[:, 2] = blk.shape[1]
        blk = np.concatenate([blk, np.zeros((1, k - blk.shape[1], blk.shape[2]), np.float32)], axis=1)
        *state, _ = po.band_insert_block(ln, ref_arr, blk, *state, cfg=cfg, interpret=True)
    sc, path = np.asarray(state[2]), np.asarray(state[3])
    return po.set_live_results(sc, path, lens)[0]


@pytest.mark.parametrize("seed,stretch,overrides", [
    (31, 1.25, {}),  # otw, live exhausted without stop
    (33, 2.6, {}),   # otw, early stop (live much longer than ref)
    (32, 1.25, dict(sentinel=float("inf"), run_count_init=0)),  # livenote
    (2, 1.25, dict(sentinel=float("inf"), run_count_init=0,
                   monotone_path=True, euclidean=True)),  # livenote_v2
    # (monotone guard; seed 2 is a case where naive [(0,0)]+insert does NOT
    # equal set_live, so the seeded origin point is what is proven)
])
def test_set_live_long_pair_delegation(seed, stretch, overrides):
    """set_live in one launch (K = the live length) equals the same pair
    streamed through 8-frame launches whose older frames live in the ring
    (the regime of long pairs and of streaming), with the identical path
    and pointer tuple across all engine configs."""
    rng = np.random.default_rng(seed)
    ref, live = _make_pair(rng, n_ref=48, stretch=stretch)
    direct = pallas_set_live(ref, live, PARAMS, interpret=True, **overrides)
    launched = _set_live_in_launches(ref, live, PARAMS, 8, **overrides)
    np.testing.assert_array_equal(launched[0], direct[0])
    assert launched[1:] == direct[1:]


def test_batched_set_live_long_pair_delegation():
    """Per-pair references of different lengths in one launch, sequential
    (exact) chain: each pair equals its own solo set_live and the XLA
    engine's exact-chain set_live."""
    rng = np.random.default_rng(7)
    pairs = [_make_pair(rng, n_ref=32 + 8 * i, stretch=1.0 + 0.2 * i) for i in range(3)]
    got = pallas_batched_set_live(
        [r for r, _ in pairs], [l for _, l in pairs], PARAMS, interpret=True, exact_chain=True)
    for (ref, live), g in zip(pairs, got):
        want = pallas_set_live(ref, live, PARAMS, interpret=True, exact_chain=True)
        np.testing.assert_array_equal(g[0], want[0])
        assert g[1:] == want[1:]
        xla = OnlineTimeWarping(ref, PARAMS, dtype=np.float32, exact_chain=True)
        xla.set_live(live)
        np.testing.assert_array_equal(g[0], xla.path_array)


@pytest.mark.parametrize("variant,euclidean,c,mrc", [
    ("otw", False, 3, 3),
    ("otw", False, 10, 1),
    ("otw", False, 20, 5),
    ("livenote", False, 10, 3),
    ("livenote_v2", False, 10, 3),
    ("livenote_v2", True, 10, 3),
    ("livenote_v2", True, 5, 2),
])
@pytest.mark.parametrize("exact", [False, True])
def test_kernel_set_live_matches_oracle(variant, euclidean, c, mrc, exact):
    """The kernel's set_live against the f64 oracle over band width, slope
    constraint, the monotone guard and the Euclidean cost, in both chain
    forms (generic data has no exact ties)."""
    rng = np.random.default_rng(100 + c + mrc)
    ref, live = _make_pair(rng, n_ref=40, stretch=1.3)
    if euclidean:
        ref = np.clip(np.diff(ref, axis=1), 0, np.inf)
        live = np.clip(np.diff(live, axis=1), 0, np.inf)
    oracle = OracleOTW(ref, c, mrc, variant=variant, euclidean=euclidean)
    want = oracle.set_live(live)
    over = dict(sentinel=1e10 if variant == "otw" else float("inf"),
                run_count_init=1 if variant == "otw" else 0,
                monotone_path=variant == "livenote_v2", euclidean=euclidean)
    path, t, j, _ = pallas_set_live(ref, live, {"c": c, "max_run_count": mrc},
                                    interpret=True, exact_chain=exact, **over)
    np.testing.assert_array_equal(path, want)


def test_wrapper_shapes_and_padding():
    """Padded layouts: powers of two wide enough for the band, the
    reference offset by c rows, the seeded origin state."""
    assert po.band_width(3) == 16 and po.band_width(50) == 64 and po.band_width(63) == 64
    assert po.band_width(64) == 128
    assert po.feature_width(12) == 16
    ref = np.arange(12 * 5, dtype=np.float32).reshape(12, 5) + 1
    padded = po.pad_ref(ref, 4)
    assert padded.shape == (po.ref_rows(4, 5), 16)
    assert padded.shape[0] >= 4 + 5 + po.band_width(4)
    np.testing.assert_array_equal(padded[4:9, :12], ref.T)
    assert not padded[:4].any() and not padded[9:].any() and not padded[:, 12:].any()
    cfg = po.online_config({"c": 4, "max_run_count": 3})
    hist, vec, sc, path = po.init_state(cfg, 2, 12, 64, seed_origin=True)
    assert hist.shape == (2, 16, 16) and vec.shape == (2, 2, 16) and path.shape == (2, 2, 64)
    assert (vec == 1e10).all()
    assert (sc[:, po.S_PLEN] == 1).all() and (sc[:, po.S_FIRST] == 1).all()
    assert (sc[:, po.S_LASTX] == 0).all() and (path[:, :, 0] == 0).all()


def test_kernel_refuses_cpu_without_interpret():
    """No silent fallback: off the GPU the kernel needs interpret=True."""
    rng = np.random.default_rng(0)
    ref, live = _make_pair(rng, n_ref=24)
    with pytest.raises(RuntimeError, match="interpret=True"):
        pallas_set_live(ref, live, PARAMS)

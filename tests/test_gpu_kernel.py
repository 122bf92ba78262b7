"""The band kernel compiled for the GPU (no interpreter) against the XLA
engine — card-only, marked ``gpu``; the same comparisons run on the CPU in
the Pallas interpreter in tests/test_pallas_otw.py."""

import numpy as np
import pytest

from tests.test_online import _make_pair

PARAMS = {"c": 50, "max_run_count": 3}


@pytest.mark.gpu
def test_compiled_set_live_matches_xla(gpu_device):
    from real_time_audio_sync_tpu.models import OnlineTimeWarping
    from real_time_audio_sync_tpu.ops.pallas_otw import pallas_set_live

    ref, live = _make_pair(np.random.default_rng(0), n_ref=600, stretch=1.2)
    xla = OnlineTimeWarping(ref, PARAMS, dtype=np.float32)
    xla.set_live(live)
    path, t, j, _ = pallas_set_live(ref, live, PARAMS)
    np.testing.assert_array_equal(path, xla.path_array)
    assert (t, j) == (xla.live_ptr, xla.ref_ptr)


@pytest.mark.gpu
def test_compiled_serving_matches_solo(gpu_device):
    from real_time_audio_sync_tpu.models import FusedStreamingEngine
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower

    ref, live = _make_pair(np.random.default_rng(1), n_ref=400, stretch=1.1)
    solo = FusedStreamingEngine(ref, PARAMS)
    for i in range(live.shape[1]):
        solo.feed(live[:, i])
    solo.flush()
    fms = FusedMultiStreamFollower(ref, PARAMS, n_streams=4)
    for i in range(live.shape[1]):
        fms.feed(np.repeat(live[None, :, i], 4, axis=0))
    fms.flush()
    for p in fms.paths():
        np.testing.assert_array_equal(p, solo.path_array)

"""Parity tests for the device-resident WTW engines (models/wtw_async.py
``AsyncWTW`` and parallel/wtw_serving.py ``MultiStreamWTW``), float32 as
they run on the GPU.  The parity oracle is the host ``WTW`` engine, itself
bit-parity-tested against the Python-faithful oracle (tests/test_wtw.py) —
reference wtw.py:71-130.
"""

import numpy as np
import pytest

from real_time_audio_sync_tpu.models.wtw import WTW
from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW
from real_time_audio_sync_tpu.parallel.wtw_serving import MultiStreamWTW
from real_time_audio_sync_tpu.utils.wavio import load_wav

WP = {"fft_len": 4096, "hop_size": 2048,
      "dtw_win_size": 4096 * 10, "dtw_hop_size": 2048 * 10}


def _synth(seed=0, ref_s=20, live_s=12, noise=0.02):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal(22050 * ref_s).astype(np.float32) * 0.1
    live = ref[: 22050 * live_s].copy()
    live += rng.standard_normal(live.shape[0]).astype(np.float32) * noise
    return ref, live


def _aligned_chunks(x):
    """8-column-aligned feed: every dispatch sees the same chroma matmul
    batch shape as the host engine's extraction, so f32 features are
    bit-identical across engines (docs/PARITY.md deviation 8)."""
    first = 4096 + 7 * 2048
    rest = 8 * 2048
    n = (len(x) - first) // rest
    return [x[:first]] + [x[first + i * rest : first + (i + 1) * rest]
                          for i in range(n)]


def _run(engine, chunks):
    for ch in chunks:
        if engine.insert(ch) == "stop":
            break
    if hasattr(engine, "flush"):
        engine.flush()
    return engine


def test_async_wtw_matches_host_synthetic():
    ref, live = _synth()
    chunks = _aligned_chunks(live)
    host = _run(WTW(ref, WP), chunks)
    fused = _run(AsyncWTW(ref, WP, k_block=8), chunks)
    assert fused.path == host.path
    assert fused.pointers == (host.chroma_ptr, host.live_ptr, host.ref_ptr)


@pytest.mark.parametrize("k_block", [1, 5])
def test_async_wtw_k_block_invariance(k_block):
    ref, live = _synth(seed=3, ref_s=12, live_s=8)
    chunks = _aligned_chunks(live)
    host = _run(WTW(ref, WP), chunks)
    fused = _run(AsyncWTW(ref, WP, k_block=k_block), chunks)
    assert fused.path == host.path


def test_async_wtw_stop_on_ref_exhaustion():
    ref, _ = _synth(seed=1, ref_s=8)
    rng = np.random.default_rng(2)
    live = np.tile(ref, 3) + rng.standard_normal(ref.shape[0] * 3).astype(np.float32) * 0.02
    chunks = np.array_split(live, 60)
    host = WTW(ref, WP)
    fused = AsyncWTW(ref, WP, k_block=8)
    rh = rf = None
    for ch in chunks:
        if rh != "stop":
            rh = host.insert(ch)
        if rf != "stop":
            rf = fused.insert(ch)
    fused.flush()
    assert fused.poll() == "stop"
    assert fused.path == host.path
    assert fused.pointers == (host.chroma_ptr, host.live_ptr, host.ref_ptr)


def test_async_wtw_live_app_window(chopin_pair):
    """w=100 (wtw_live.py:106) on a shortened real stream."""
    ref_wav, live_wav = chopin_pair
    wp2 = {"fft_len": 4096, "hop_size": 2048,
           "dtw_win_size": 4096 * 50, "dtw_hop_size": 2048 * 50}
    lraw, _ = load_wav(live_wav)
    chunks = _aligned_chunks(lraw)[:31]
    host = _run(WTW(ref_wav, wp2), chunks)
    fused = _run(AsyncWTW(ref_wav, wp2, k_block=8), chunks)
    assert len(host.path) > 0
    assert fused.path == host.path
    assert fused.pointers == (host.chroma_ptr, host.live_ptr, host.ref_ptr)


def test_async_wtw_chopin_pair(chopin_pair):
    ref_wav, live_wav = chopin_pair
    lraw, _ = load_wav(live_wav)
    chunks = _aligned_chunks(lraw)
    host = _run(WTW(ref_wav, WP), chunks)
    fused = _run(AsyncWTW(ref_wav, WP, k_block=8), chunks)
    assert fused.path == host.path


def test_async_wtw_transfer_dtypes(chopin_pair):
    """int16 spans are path-exact on int16-exact audio; chroma transfer is
    empirically path-equal on the real pair (same contracts as AsyncWTW)."""
    ref_wav, live_wav = chopin_pair
    lraw, _ = load_wav(live_wav)
    lq = np.round(lraw * 32768.0).clip(-32768, 32767) / 32768.0
    chunks = _aligned_chunks(lq)
    f32 = _run(AsyncWTW(ref_wav, WP, k_block=8), chunks)
    i16 = _run(AsyncWTW(ref_wav, WP, k_block=8, transfer_dtype="int16"), chunks)
    chm = _run(AsyncWTW(ref_wav, WP, k_block=8, transfer_dtype="chroma"), chunks)
    assert i16.path == f32.path
    ndiff = sum(1 for a, b in zip(chm.path, f32.path) if a != b)
    assert len(chm.path) == len(f32.path)
    assert ndiff <= max(2, len(f32.path) // 100)


def test_async_wtw_wide_window():
    """A wide window (w = 160 frames) runs on the XLA stepper and commits
    the host engine's path."""
    ref, live = _synth(seed=4, ref_s=40, live_s=24)
    wp = dict(WP, dtw_win_size=4096 * 80, dtw_hop_size=2048 * 40)
    chunks = _aligned_chunks(live)
    host = _run(WTW(ref, wp), chunks)
    dev = _run(AsyncWTW(ref, wp, k_block=8), chunks)
    assert len(host.path) > 0
    assert dev.path == host.path


# ---------------------------------------------------------------------------
# multi-stream (grid) driver
# ---------------------------------------------------------------------------


def test_multi_wtw_matches_solo_mixed_refs():
    refA, liveA = _synth(seed=0, ref_s=20, live_s=10)
    refB, _ = _synth(seed=5, ref_s=16)
    rng = np.random.default_rng(6)
    liveB = refB[: 22050 * 10].copy()
    liveB += rng.standard_normal(liveB.shape[0]).astype(np.float32) * 0.03
    ca, cb = _aligned_chunks(liveA), _aligned_chunks(liveB)
    soloA = _run(AsyncWTW(refA, WP, k_block=8), ca)
    soloB = _run(AsyncWTW(refB, WP, k_block=8), cb)
    ms = MultiStreamWTW([refA, refB], WP, k_block=8, transfer_dtype="float32")
    for a, b in zip(ca, cb):
        ms.insert([a, b])
    ms.flush()
    paths = ms.paths()
    assert paths[0] == soloA.path
    assert paths[1] == soloB.path
    assert ms.pointers()[0] == soloA.pointers
    assert ms.pointers()[1] == soloB.pointers


def test_multi_wtw_feed_skew_invariance():
    """A stream's committed path must not depend on how the OTHER streams'
    audio arrives (per-stream n_valid masking)."""
    ref, live = _synth(seed=7, ref_s=20, live_s=10)
    chunks = _aligned_chunks(live)
    solo = _run(AsyncWTW(ref, WP, k_block=8), chunks)
    ms = MultiStreamWTW([ref, ref], WP, k_block=8, transfer_dtype="float32")
    cat = np.concatenate(chunks)
    pos = 0
    for i, ch in enumerate(chunks):
        take = min(len(cat) - pos, 5000 + (i % 3) * 7000)
        ms.insert([ch, cat[pos : pos + take]])
        pos += take
    ms.insert([None, cat[pos:]])
    ms.flush()
    # stream 0 fed 8-aligned: bit-equal to solo.  stream 1's skewed feed
    # changes its own chroma batch shapes (knife-edge diffs allowed) but
    # must not perturb stream 0.
    assert ms.paths()[0] == solo.path


def test_multi_wtw_on_mesh():
    import jax
    from jax.sharding import Mesh

    ref, live = _synth(seed=8, ref_s=16, live_s=8)
    chunks = _aligned_chunks(live)
    solo = _run(AsyncWTW(ref, WP, k_block=8), chunks)
    devs = np.array(jax.devices())
    if devs.size < 8:
        pytest.skip("needs the 8-virtual-device CPU platform")
    mesh = Mesh(devs[:8].reshape(8), ("s",))
    ms = MultiStreamWTW([ref] * 8, WP, k_block=8,
                        mesh=mesh, transfer_dtype="float32")
    for ch in chunks:
        ms.insert([ch] * 8)
    ms.flush()
    for p in ms.paths():
        assert p == solo.path


def test_async_wtw_hop_exceeds_window():
    """dtw_hop_size >= dtw_win_size makes the diagonal fallback advance
    ref_ptr by hop_frames > w-1 per window; the device slices must follow
    that advance.  Paths must stay bit-equal to the host engine."""
    wp = {"fft_len": 4096, "hop_size": 2048,
          "dtw_win_size": 4096 * 4, "dtw_hop_size": 2048 * 10}
    assert wp["dtw_hop_size"] // 2048 > wp["dtw_win_size"] // 2048 - 1
    ref, live = _synth(seed=5, ref_s=24, live_s=16)
    chunks = _aligned_chunks(live)
    host = _run(WTW(ref, wp), chunks)
    fused = _run(AsyncWTW(ref, wp, k_block=8), chunks)
    assert len(host.path) > 0
    assert fused.path == host.path
    assert fused.pointers == (host.chroma_ptr, host.live_ptr, host.ref_ptr)


@pytest.mark.parametrize("backend", ["unroll", "scan"])
def test_wtw_geometry_covers_hop_advance(backend):
    """A hop longer than the window (the diagonal fallback advances the
    reference pointer by more than w-1) under both in-program window DPs:
    the commit buffer bound holds and paths equal the host engine's."""
    wp = {"fft_len": 4096, "hop_size": 2048,
          "dtw_win_size": 4096 * 4, "dtw_hop_size": 2048 * 10}
    ref, live = _synth(seed=6, ref_s=20, live_s=12)
    chunks = _aligned_chunks(live)
    host = _run(WTW(ref, wp), chunks)
    dev = _run(AsyncWTW(ref, wp, k_block=8, window_backend=backend), chunks)
    assert dev.path == host.path
    assert len(dev.path) <= dev._state[0].shape[0]

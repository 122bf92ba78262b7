"""Multi-stream WTW serving (parallel/wtw_serving.py): B raw-audio streams
advanced by one vmapped dispatch per block, each bit-identical to a solo
AsyncWTW engine.  Float64 throughout — the comparisons must be immune to
batch-shape-dependent f32 accumulation (docs/PARITY.md deviation 8)."""

import numpy as np
import pytest

from real_time_audio_sync_tpu.models import AsyncWTW
from real_time_audio_sync_tpu.parallel import MultiStreamWTW
from real_time_audio_sync_tpu.parallel.corpus import corpus_mesh
from real_time_audio_sync_tpu.utils.wavio import load_wav

WTW_PARAMS = {"fft_len": 4096, "hop_size": 2048,
              "dtw_win_size": 4096 * 10, "dtw_hop_size": 2048 * 10}


def test_multistream_wtw_matches_solo_engines(chopin_pair):
    """Mixed references and skewed per-stream feeds: every stream's committed
    path and pointers equal a solo AsyncWTW run on the same audio."""
    ref_wav, live_wav = chopin_pair
    rub, _ = load_wav(ref_wav)
    rach, _ = load_wav(live_wav)
    half = len(rach) // 2
    refs = [ref_wav, live_wav, ref_wav]
    lives = [rach[:half], rub[:half], rach[: half // 2]]
    chunkings = [50, 19, 31]  # deliberately unaligned cadences

    ms = MultiStreamWTW(refs, WTW_PARAMS, k_block=8, dtype=np.float64)
    iters = [iter(np.array_split(lv, ch)) for lv, ch in zip(lives, chunkings)]
    done = [False] * len(refs)
    while not all(done):
        bufs = []
        for i, it in enumerate(iters):
            try:
                bufs.append(next(it))
            except StopIteration:
                done[i] = True
                bufs.append(None)
        ms.insert(bufs)
    ms.flush()

    for i in range(len(refs)):
        solo = AsyncWTW(refs[i], WTW_PARAMS, k_block=8, dtype=np.float64)
        for b in np.array_split(lives[i], chunkings[i]):
            if solo.insert(b) == "stop":
                break
        solo.flush()
        assert ms.paths()[i] == solo.path
        assert ms.pointers()[i] == solo.pointers


def test_multistream_wtw_sharded_over_mesh(chopin_pair):
    """8 MIXED-reference streams sharded over the 8-virtual-device mesh
    commit the same paths as unsharded single streams (zero cross-chip
    communication by construction).  Mixed refs pin the stacked
    batch-sharded reference layout; the shared-reference (replicated)
    layout under a mesh is exercised by __graft_entry__.dryrun_multichip
    and test_shared_ref_mode_matches_stacked."""
    ref_wav, live_wav = chopin_pair
    rach, _ = load_wav(live_wav)
    rach = rach[: len(rach) // 2]
    mesh = corpus_mesh()
    refs = [ref_wav, live_wav] * 4
    ms = MultiStreamWTW(refs, WTW_PARAMS, k_block=8,
                        dtype=np.float64, mesh=mesh)
    assert not ms._shared_ref
    solo = {w: MultiStreamWTW([w], WTW_PARAMS, k_block=8, dtype=np.float64)
            for w in (ref_wav, live_wav)}
    for b in np.array_split(rach, 32):
        ms.insert([b] * 8)
        for one in solo.values():
            one.insert([b])
    ms.flush()
    want = {}
    for w, one in solo.items():
        one.flush()
        want[w] = one.paths()[0]
        assert len(want[w]) > 50
    for i, p in enumerate(ms.paths()):
        assert p == want[refs[i]]


def test_multistream_wtw_validation(chopin_pair):
    ref_wav, _ = chopin_pair
    mesh = corpus_mesh()
    with pytest.raises(ValueError, match="divisible"):
        MultiStreamWTW([ref_wav] * 3, WTW_PARAMS, mesh=mesh)
    ms = MultiStreamWTW([ref_wav], WTW_PARAMS, dtype=np.float64)
    with pytest.raises(ValueError, match="expected 1 buffers"):
        ms.insert([np.zeros(100), np.zeros(100)])


def test_multistream_wtw_stop_surfaces_before_flush(chopin_pair):
    """Per-stream stop flags surface through the dispatch-time status
    harvest — a caller must not need flush() to learn a stream ended (the
    round-trip-free analog of StatusPolling._swap_status).  The device
    queue is drained once mid-stream (state sync, no status read) to stand
    in for a real-time-paced device that keeps up with the feed."""
    import jax

    ref_wav, live_wav = chopin_pair
    rach, _ = load_wav(live_wav)
    long_live = np.concatenate([rach, rach, rach])  # exhausts the reference
    ms = MultiStreamWTW([ref_wav], WTW_PARAMS, k_block=8, dtype=np.float64)
    ms.poll_min_interval = 0.0
    seen_before_flush = False
    chunks = np.array_split(long_live, 64)
    for i, b in enumerate(chunks):
        stopped = ms.insert([b])
        if stopped[0]:
            seen_before_flush = True
            break
        if i == 40:  # past the stop point: let the device catch up.
            # NB: block on the status objects themselves — readiness flags of
            # sibling outputs resolve asynchronously on the CPU backend, so
            # syncing the state alone can leave the status's is_ready False.
            jax.block_until_ready(ms._outstanding)
    assert seen_before_flush
    assert ms.flush()[0]


def test_multistream_wtw_live_app_window_size(chopin_pair):
    """Serving at the live-app window (wtw_live.py:106, w=100, one window
    slot per block): parity vs solo AsyncWTW at the same params."""
    ref_wav, live_wav = chopin_pair
    rach, _ = load_wav(live_wav)
    params = {"fft_len": 4096, "hop_size": 2048,
              "dtw_win_size": 4096 * 50, "dtw_hop_size": 2048 * 50}
    ms = MultiStreamWTW([ref_wav, ref_wav], params, k_block=8, dtype=np.float64)
    for b in np.array_split(rach, 32):
        ms.insert([b, b])
    ms.flush()
    solo = AsyncWTW(ref_wav, params, k_block=8, dtype=np.float64)
    for b in np.array_split(rach, 32):
        solo.insert(b)
    solo.flush()
    assert len(solo.path) > 100
    assert ms.paths()[0] == solo.path and ms.paths()[1] == solo.path
    assert ms.pointers()[0] == solo.pointers


def test_int16_transfer_matches_float32_exact_source():
    """transfer_dtype='int16' is bit-exact when samples are int16/32768
    multiples (mono PCM16 sources): committed paths and pointers match the
    float32-transfer engine on the same audio."""
    rng = np.random.default_rng(13)
    fs = 22050
    ref_i16 = (rng.integers(-20000, 20000, int(3.0 * fs))).astype(np.int16)
    live_i16 = (0.9 * ref_i16[: int(2.5 * fs)]).astype(np.int16)
    ref = ref_i16.astype(np.float64) / 32768.0
    live = live_i16.astype(np.float64) / 32768.0
    params = {"fft_len": 4096, "hop_size": 2048,
              "dtw_win_size": 4096 * 3, "dtw_hop_size": 2048 * 3}

    a = AsyncWTW(ref, params, k_block=4, dtype=np.float64)
    b = AsyncWTW(ref, params, k_block=4, dtype=np.float64, transfer_dtype="int16")
    for chunk in np.array_split(live, 16):
        a.insert(chunk)
        b.insert(chunk)
    a.flush(); b.flush()
    assert len(a.path) > 10
    assert a.path == b.path
    assert a.pointers == b.pointers

    ms_f = MultiStreamWTW([ref, ref], params, k_block=4, dtype=np.float64)
    ms_i = MultiStreamWTW([ref, ref], params, k_block=4, dtype=np.float64,
                          transfer_dtype="int16")
    for chunk in np.array_split(live, 16):
        ms_f.insert([chunk, chunk])
        ms_i.insert([chunk, chunk])
    ms_f.flush(); ms_i.flush()
    assert ms_f.paths() == ms_i.paths() == [a.path, a.path]


def test_chroma_transfer_matches_float32_paths():
    """transfer_dtype='chroma' ships host-extracted columns (~96x fewer H2D
    bytes).  Host rfft vs the in-program DFT matmuls differ in low-order
    bits, so path equality is EMPIRICAL, not guaranteed (docs/PARITY.md
    deviation 10) — on this synthetic audio the committed paths agree;
    mode-internal
    parity (multi == solo, both chroma) is exact by construction."""
    rng = np.random.default_rng(5)
    fs = 22050
    n = int(5.0 * fs)
    t = np.arange(n) / fs
    ref = (0.3 * np.sin(2 * np.pi * 440 * t * (1 + 0.01 * np.sin(t)))
           + 0.05 * rng.standard_normal(n)).astype(np.float32)
    live = (0.3 * np.sin(2 * np.pi * 440 * t * 1.02)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)
    params = {"fft_len": 4096, "hop_size": 2048,
              "dtw_win_size": 4096 * 3, "dtw_hop_size": 2048 * 3}

    a = AsyncWTW(ref, params, k_block=4)
    b = AsyncWTW(ref, params, k_block=4, transfer_dtype="chroma")
    for chunk in np.array_split(live, 16):
        a.insert(chunk)
        b.insert(chunk)
    a.flush(); b.flush()
    assert len(a.path) > 10
    assert a.path == b.path
    assert a.pointers == b.pointers

    # multi-stream chroma mode is bit-consistent with the solo chroma engine
    # (same host rfft, same vmapped window DP)
    ms = MultiStreamWTW([ref, ref], params, k_block=4,
                        transfer_dtype="chroma")
    for chunk in np.array_split(live, 16):
        ms.insert([chunk, chunk])
    ms.flush()
    assert ms.paths() == [b.path, b.path]
    assert ms.pointers() == [b.pointers, b.pointers]


def test_chroma_spans_ragged_packing_contract():
    """The serving span packer FFTs only the valid frames of partial blocks
    (one ragged batch).  Contract: for every stream, columns [:k] equal the
    solo host extractor's on the same samples, and columns [k:] are zero
    (don't-care on device, masked by n_valid in-program)."""
    from real_time_audio_sync_tpu.models.wtw_async import (
        SampleFIFO, host_chroma_block)

    rng = np.random.default_rng(17)
    params = {"fft_len": 4096, "hop_size": 2048,
              "dtw_win_size": 4096 * 3, "dtw_hop_size": 2048 * 3}
    wav = (0.2 * rng.standard_normal(22050 * 3)).astype(np.float32)
    ms = MultiStreamWTW([wav, wav, wav], params, k_block=4,
                        transfer_dtype="chroma")
    # hand-fill the FIFOs to pin per-stream k: 4 (full), 2 (partial), 0
    n_for = lambda k: (k - 1) * 2048 + 4096
    ms.bufs[0].extend(wav[: n_for(4)].copy())
    ms.bufs[1].extend(wav[: n_for(2)].copy())
    ks = np.array([4, 2, 0])

    solo = [SampleFIFO(np.float32) for _ in range(2)]
    solo[0].extend(wav[: n_for(4)].copy())
    solo[1].extend(wav[: n_for(2)].copy())
    want0 = host_chroma_block(solo[0], 4, 4, 2048, 4096, np.float32)
    want1 = host_chroma_block(solo[1], 2, 4, 2048, 4096, np.float32)

    out = ms._spans(ks)
    assert out.shape == (3, 12, 4)
    np.testing.assert_array_equal(out[0], want0)
    np.testing.assert_array_equal(out[1, :, :2], want1[:, :2])
    assert (out[1, :, 2:] == 0).all()  # padding columns ship as zeros
    assert (out[2] == 0).all()  # k=0 stream untouched
    # the packer consumed exactly k*hop samples per stream
    assert len(ms.bufs[0]) == n_for(4) - 4 * 2048
    assert len(ms.bufs[1]) == n_for(2) - 2 * 2048


@pytest.mark.parametrize("seed", [71, 72])
def test_multistream_wtw_api_interleaving_fuzz(seed):
    """Seeded fuzz over the raw-audio serving API: random per-stream buffer
    sizes (including None = no new audio), opportunistic stopped/paths/
    pointers reads under maximum harvest pressure, and one mid-stream
    checkpoint/restore — committed paths and pointers must equal solo
    AsyncWTW engines fed the identical chunk sequences."""
    import os
    import tempfile

    from real_time_audio_sync_tpu.utils.checkpoint import (
        load_multi_wtw_state, save_multi_wtw_state)

    rng = np.random.default_rng(seed)
    params = {"fft_len": 4096, "hop_size": 2048,
              "dtw_win_size": 4096 * 3, "dtw_hop_size": 2048 * 3}
    refs = [(0.2 * rng.standard_normal(22050 * (3 + i))).astype(np.float64)
            for i in range(3)]
    lives = [(r + 0.02 * rng.standard_normal(len(r))).astype(np.float64)[
        : int(len(r) * rng.uniform(0.6, 1.0))] for r in refs]

    ms = MultiStreamWTW(refs, params, k_block=4, dtype=np.float64)
    ms.poll_min_interval = 0.0
    fed: list = [[] for _ in refs]
    ptrs = [0, 0, 0]
    ck_at = int(rng.integers(5, 15))
    step = 0
    while any(p < len(lv) for p, lv in zip(ptrs, lives)):
        bufs = []
        for i, lv in enumerate(lives):
            if ptrs[i] < len(lv) and rng.integers(0, 3):
                n = int(rng.integers(500, 8000))
                bufs.append(lv[ptrs[i] : ptrs[i] + n])
                fed[i].append(bufs[-1])
                ptrs[i] += n
            else:
                bufs.append(None)
        ms.insert(bufs)
        op = int(rng.integers(0, 5))
        if op == 0:
            _ = ms.stopped
        elif op == 1:
            _ = ms.pointers()
        elif op == 2 and rng.integers(0, 4) == 0:
            _ = ms.paths()
        step += 1
        if step == ck_at:
            # save flushes first: every inserted sample is either processed
            # or sitting in the snapshotted host FIFOs
            with tempfile.TemporaryDirectory() as d:
                ck = os.path.join(d, "ck.npz")
                save_multi_wtw_state(ms, ck)
                ms = MultiStreamWTW(refs, params, k_block=4, dtype=np.float64)
                ms.poll_min_interval = 0.0
                load_multi_wtw_state(ms, ck)
    ms.flush()

    for i in range(len(refs)):
        solo = AsyncWTW(refs[i], params, k_block=4, dtype=np.float64)
        for b in fed[i]:
            if solo.insert(b) == "stop":
                break
        solo.flush()
        assert ms.paths()[i] == solo.path
        assert ms.pointers()[i] == solo.pointers


def test_transfer_dtype_validation():
    params = {"fft_len": 4096, "hop_size": 2048,
              "dtw_win_size": 4096 * 3, "dtw_hop_size": 2048 * 3}
    rng = np.random.default_rng(0)
    wav = rng.standard_normal(22050 * 2).astype(np.float32) * 0.1
    with pytest.raises(ValueError, match="transfer_dtype"):
        AsyncWTW(wav, params, transfer_dtype="int8")
    with pytest.raises(ValueError, match="transfer_dtype"):
        MultiStreamWTW([wav], params, transfer_dtype="int8")


def test_shared_ref_mode_matches_stacked(chopin_pair):
    """B streams on ONE recording broadcast a single (f, m) reference
    through vmap (in_axes=None) instead of stacking B copies; committed
    paths, pointers and stop must equal the stacked mode bit-for-bit
    (f64: immune to batch-shape accumulation)."""
    ref_wav, live_wav = chopin_pair
    rub, _ = load_wav(ref_wav)
    rach, _ = load_wav(live_wav)
    live = rach[: len(rach) // 2]

    shared = MultiStreamWTW([rub, rub], WTW_PARAMS, k_block=8,
                            dtype=np.float64)
    assert shared._shared_ref and shared._ref_dev.ndim == 2
    # distinct array objects defeat the identity memo -> stacked mode
    stacked = MultiStreamWTW([rub, rub.copy()], WTW_PARAMS, k_block=8,
                             dtype=np.float64)
    assert not stacked._shared_ref and stacked._ref_dev.ndim == 3
    for ms in (shared, stacked):
        for b in np.array_split(live, 23):
            ms.insert([b, b[: len(b) // 2]])
        ms.flush()
    assert shared.paths() == stacked.paths()
    assert shared.pointers() == stacked.pointers()
    assert (shared.stopped == stacked.stopped).all()
    assert len(shared.paths()[0]) > 10


def test_precomputed_ref_chromas_match_extraction(chopin_pair):
    """``ref_chromas=`` (the serving-restart / harness path) skips the host
    FFT at construction; committed paths must equal the extract-at-init
    constructor bit-for-bit, in both shared and per-stream forms."""
    from real_time_audio_sync_tpu.features.chroma import chroma_from_samples

    ref_wav, live_wav = chopin_pair
    rub, _ = load_wav(ref_wav)
    rach, _ = load_wav(live_wav)
    live = rach[: len(rach) // 2]
    chroma = chroma_from_samples(rub, dtype=np.float64)

    baseline = MultiStreamWTW([rub, rub], WTW_PARAMS, k_block=8,
                              dtype=np.float64)
    pre_shared = MultiStreamWTW([rub, rub], WTW_PARAMS, k_block=8,
                                dtype=np.float64, ref_chromas=[chroma])
    assert pre_shared._shared_ref
    pre_stacked = MultiStreamWTW([rub, rub], WTW_PARAMS, k_block=8,
                                 dtype=np.float64,
                                 ref_chromas=[chroma, chroma.copy()])
    assert not pre_stacked._shared_ref
    for ms in (baseline, pre_shared, pre_stacked):
        for b in np.array_split(live, 17):
            ms.insert([b, b[: len(b) // 2]])
        ms.flush()
    assert pre_shared.paths() == baseline.paths()
    assert pre_stacked.paths() == baseline.paths()
    assert pre_shared.pointers() == baseline.pointers()
    assert len(baseline.paths()[0]) > 10

    with pytest.raises(ValueError, match="entries for"):
        MultiStreamWTW([rub, rub, rub], WTW_PARAMS,
                       ref_chromas=[chroma, chroma])


# ---------------------------------------------------------------------------
# adaptive transfer-mode selection (parallel/transfer.py — r4 verdict #4)
# ---------------------------------------------------------------------------


def test_choose_transfer_mode_crossovers():
    """Mocked probe values must hit all three choices: exact f32 when the
    rtt dominates (fast link), int16 when the link is the constraint but
    host FFT is slower still, chroma when the link is slow."""
    from real_time_audio_sync_tpu.parallel.transfer import (
        LinkProbe,
        choose_transfer_mode,
    )

    kw = dict(k_block=8, fft_len=4096, hop_size=2048)
    # direct-attach link at low stream count: the rtt dominates the span
    # bytes, every mode ties, exactness is free
    fast = LinkProbe(bytes_per_s=10e9, rtt_s=50e-6)
    assert choose_transfer_mode(2, **kw, link=fast, host_fft_us=22.0) == "float32"
    # ... at B=64 the 4.7 MB f32 span dominates even 10 GB/s: halving wins
    assert choose_transfer_mode(64, **kw, link=fast, host_fft_us=22.0) == "int16"

    # mid link (500 MB/s), busy 1-core host (50 us/frame): halving the span
    # bytes beats paying host FFT for 256 streams
    mid = LinkProbe(bytes_per_s=500e6, rtt_s=1e-3)
    assert choose_transfer_mode(256, **kw, link=mid, host_fft_us=50.0) == "int16"

    # slow link (5 MB/s): chroma's ~96x byte reduction wins even with
    # single-core host extraction
    slow = LinkProbe(bytes_per_s=5e6, rtt_s=27e-3)
    assert choose_transfer_mode(256, **kw, link=slow, host_fft_us=22.0) == "chroma"

    # worker scaling shifts the int16/chroma crossover: the same mid link
    # with 16 workers makes chroma cheaper than the halved span
    assert choose_transfer_mode(256, **kw, link=mid, host_fft_us=50.0,
                                workers=16) == "chroma"


def test_resolve_transfer_mode_passthrough_and_env(monkeypatch):
    from real_time_audio_sync_tpu.parallel import transfer as T

    # explicit modes bypass probing entirely
    for m in ("float32", "int16", "chroma"):
        assert T.resolve_transfer_mode(m, 8, 8, 4096, 2048) == m

    # env force short-circuits the probes
    monkeypatch.setenv("RTAS_TRANSFER_MODE", "int16")
    assert T.resolve_transfer_mode("auto", 8, 8, 4096, 2048) == "int16"
    monkeypatch.setenv("RTAS_TRANSFER_MODE", "bogus")
    with pytest.raises(ValueError, match="RTAS_TRANSFER_MODE"):
        T.resolve_transfer_mode("auto", 8, 8, 4096, 2048)


def test_resolve_transfer_mode_auto_uses_cached_probes(monkeypatch):
    from real_time_audio_sync_tpu.parallel import transfer as T

    monkeypatch.delenv("RTAS_TRANSFER_MODE", raising=False)
    monkeypatch.setattr(T, "_PROBE_CACHE", {
        "link": T.LinkProbe(bytes_per_s=5e6, rtt_s=27e-3),
        "host_us": 22.0,
    })
    assert T.resolve_transfer_mode("auto", 256, 8, 4096, 2048) == "chroma"
    monkeypatch.setattr(T, "_PROBE_CACHE", {
        "link": T.LinkProbe(bytes_per_s=10e9, rtt_s=50e-6),
        "host_us": 22.0,
    })
    assert T.resolve_transfer_mode("auto", 2, 8, 4096, 2048) == "float32"


def test_serving_layers_default_auto(monkeypatch):
    """Construction with the default transfer_dtype resolves 'auto' to a
    concrete mode via the (mocked) probes and stores the resolved value."""
    from real_time_audio_sync_tpu.parallel import transfer as T

    monkeypatch.delenv("RTAS_TRANSFER_MODE", raising=False)
    monkeypatch.setattr(T, "_PROBE_CACHE", {
        "link": T.LinkProbe(bytes_per_s=5e6, rtt_s=27e-3),
        "host_us": 22.0,
    })
    rng = np.random.default_rng(0)
    ref = rng.standard_normal(22050 * 10).astype(np.float32) * 0.1
    eng = MultiStreamWTW([ref] * 16, WTW_PARAMS, k_block=8)
    assert eng.transfer_dtype == "chroma"
    monkeypatch.setattr(T, "_PROBE_CACHE", {
        "link": T.LinkProbe(bytes_per_s=10e9, rtt_s=50e-6),
        "host_us": 22.0,
    })
    eng2 = MultiStreamWTW([ref] * 2, WTW_PARAMS, k_block=8)
    assert eng2.transfer_dtype == "float32"


def test_resolve_transfer_mode_host_probe_keyed_by_fft_len(monkeypatch):
    """The host-FFT probe is cached PER fft_len: a non-default transform
    size must be priced with its own probe, not the 4096-point one."""
    from real_time_audio_sync_tpu.parallel import transfer as T

    monkeypatch.delenv("RTAS_TRANSFER_MODE", raising=False)
    probed = []

    def fake_probe(n_frames=256, fft_len=4096, fs=22050):
        probed.append(fft_len)
        return 22.0

    monkeypatch.setattr(T, "probe_host_fft_us", fake_probe)
    monkeypatch.setattr(T, "_PROBE_CACHE", {
        "link": T.LinkProbe(bytes_per_s=5e6, rtt_s=27e-3),
    })
    T.resolve_transfer_mode("auto", 256, 8, 4096, 2048)
    T.resolve_transfer_mode("auto", 256, 8, 4096, 2048)  # cached
    T.resolve_transfer_mode("auto", 256, 8, 8192, 4096)  # new size → re-probe
    assert probed == [4096, 8192]

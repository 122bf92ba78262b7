import numpy as np
import pytest

from real_time_audio_sync_tpu.eval.logs import parse_field_log
from real_time_audio_sync_tpu.streaming.runtime import AudioMeter, HopFramer, ScoreFollower
from real_time_audio_sync_tpu.streaming.sources import SimulatedMic, WavChunkSource
from real_time_audio_sync_tpu.streaming.writer import AudioWriter, combine_buffers
from real_time_audio_sync_tpu.utils.wavio import load_wav


def test_hop_framer_cadence():
    framer = HopFramer(fft_len=8, hop_size=4)
    # push in odd-sized chunks; windows appear exactly at fft boundaries
    windows = []
    stream = np.arange(40, dtype=np.float32)
    for start in range(0, 40, 3):
        windows += framer.push(stream[start : start + 3])
    # expected windows: [0:8], [4:12], [8:16], ... (livenote_live hop loop)
    assert len(windows) >= 8
    for k, w in enumerate(windows):
        np.testing.assert_array_equal(w, stream[k * 4 : k * 4 + 8])


def test_wav_chunk_source_matches_array_split(chopin_pair):
    _, live_wav = chopin_pair
    samples, _ = load_wav(live_wav)
    chunks = list(WavChunkSource(live_wav, 4096))
    expect = np.array_split(samples, 4096)
    assert len(chunks) == 4096
    np.testing.assert_array_equal(chunks[0], expect[0])
    np.testing.assert_array_equal(chunks[-1], expect[-1])


def test_simulated_mic_covers_all_samples(chopin_pair):
    _, live_wav = chopin_pair
    samples, _ = load_wav(live_wav)
    got = np.concatenate(list(SimulatedMic(live_wav, buffer_size=512)))
    np.testing.assert_array_equal(got, samples)


def test_audio_meter_and_writer(tmp_path):
    meter = AudioMeter()
    db = meter.update(np.ones(512, np.float32) * 0.5)
    assert -7 < db < -5  # 20*log10(0.5) ≈ -6.02
    w = AudioWriter(str(tmp_path / "cap_"))
    w.start()
    w.add_audio(np.ones(100, np.float32) * 0.25)
    name = w.stop()
    assert name.endswith("cap_1.wav")
    samples, fs = load_wav(name)
    assert fs == 22050
    assert abs(samples.mean() - 0.25) < 1e-3
    # auto-numbering
    w.start()
    w.add_audio(np.zeros(10, np.float32))
    assert w.stop().endswith("cap_2.wav")


def test_score_follower_end_to_end(chopin_pair, tmp_path):
    """The full live pipeline (stack 3.4) on the real Chopin pair: simulated
    mic → hop framing → chroma → OTW insert → beat lookup → field log."""
    ref_wav, live_wav = chopin_pair
    follower = ScoreFollower(ref_wav, engine="otw", params={"c": 50, "max_run_count": 3}, log_dir=str(tmp_path), dtype=np.float64)
    follower.start()
    events = []
    for buf in SimulatedMic(live_wav, buffer_size=512):
        events += follower.receive_audio(buf)
        if follower.stopped:
            break
    log_path = follower.stop()

    assert len(events) > 300
    # beats advance through the piece
    beats = [e.beat for e in events if e.beat is not None]
    assert beats and beats[-1] > beats[0]
    assert max(e.ref_frame for e in events) > 300

    # log round-trips through the reference format and matches the path
    log = parse_field_log(log_path)
    assert log.params()["search_band_width"] == 50
    assert log.path == [tuple(p) for p in follower.path]

    # accuracy of the streamed path matches the direct-insert regime
    from real_time_audio_sync_tpu.eval import PathScorer

    score = PathScorer.for_pair(ref_wav, live_wav).score(follower.path)
    assert score.pct_off_beats[3] < 2.0


def test_score_follower_blocks_mode(chopin_pair, tmp_path):
    ref_wav, live_wav = chopin_pair
    per_hop = ScoreFollower(ref_wav, engine="livenote", dtype=np.float64)
    blocks = ScoreFollower(ref_wav, engine="livenote", dtype=np.float64, use_blocks=True)
    for f in (per_hop, blocks):
        f.start()
        for buf in SimulatedMic(live_wav, buffer_size=4096):
            f.receive_audio(buf)
            if f.stopped:
                break
        f.stop()
    assert [tuple(p) for p in blocks.path] == [tuple(p) for p in per_hop.path]


def test_score_follower_pipelined_mode(chopin_pair, tmp_path):
    """Pipelined (async-dispatch) following commits the identical path and
    still reports advancing score positions via the status vector."""
    ref_wav, live_wav = chopin_pair
    sync = ScoreFollower(ref_wav, engine="otw", params={"c": 50, "max_run_count": 3}, dtype=np.float64)
    pipe = ScoreFollower(
        ref_wav, engine="otw", params={"c": 50, "max_run_count": 3}, dtype=np.float64, pipelined=True
    )
    events = {id(sync): [], id(pipe): []}
    for f in (sync, pipe):
        f.start()
        for buf in SimulatedMic(live_wav, buffer_size=4096):
            events[id(f)] += f.receive_audio(buf)
            if f.stopped:
                break
        f.stop()
    assert pipe.stopped == sync.stopped  # neither/both exhausted the score
    assert [tuple(p) for p in pipe.path] == [tuple(p) for p in sync.path]
    refs = [e.ref_frame for e in events[id(pipe)]]
    assert refs and max(refs) > 300  # positions advanced without path fetches


def test_duplex_audio_output_pump(chopin_pair, tmp_path):
    """The reference Audio's duplex contract (ims/audio.py:64-103): per
    polled frame, input drains to input_func AND the generator supplies
    exactly get_write_available() frames to the output; a falsy continue
    flag detaches the generator."""
    from real_time_audio_sync_tpu.streaming.audio_io import (
        BufferSink,
        DuplexAudio,
        WavPlayback,
    )

    ref_wav, live_wav = chopin_pair
    got_in, got_listen = [], []
    sink = BufferSink(frames_per_poll=512)
    duplex = DuplexAudio(
        num_channels=1,
        input_func=lambda buf, ch: got_in.append(buf),
        listen_func=lambda buf, ch: got_listen.append(buf),
        input_source=SimulatedMic(live_wav, buffer_size=512),
        sink=sink,
    )
    playback = WavPlayback(ref_wav)
    duplex.set_generator(playback)
    n_polls = 0
    while duplex.generator is not None:
        duplex.on_update()
        n_polls += 1
        assert n_polls < 10_000
    # generated audio == the reference recording, zero-padded to poll size
    out = sink.samples()
    src, _ = load_wav(ref_wav)
    assert len(out) >= len(src)
    np.testing.assert_allclose(out[: len(src)], src.astype(np.float32), atol=2e-7)
    np.testing.assert_array_equal(out[len(src):], 0)
    # input side kept draining and the listen tap saw every output block
    assert len(got_in) > 0
    np.testing.assert_array_equal(np.concatenate(got_listen), out)
    assert duplex.get_cpu_load() > 0.0


def test_click_track_generator():
    from real_time_audio_sync_tpu.streaming.audio_io import ClickTrack

    beats = [0.1, 0.5, 1.0]
    gen = ClickTrack(beats, click_sec=0.02)
    chunks = []
    more = True
    while more:
        data, more = gen.generate(512, 1)
        chunks.append(data)
    out = np.concatenate(chunks)
    # energy present exactly around each beat, silence well away from them
    for b in beats:
        k = int(b * 22050)
        assert np.abs(out[k : k + 440]).max() > 0.1
    assert np.abs(out[int(0.3 * 22050) : int(0.4 * 22050)]).max() == 0.0


def test_status_label():
    from real_time_audio_sync_tpu.streaming.display import topleft_label

    label = topleft_label(width=24)
    label.text = "beat 12.50 [110-1]"
    out = label.render()
    assert out.startswith("beat 12.50 [110-1]") and len(out) == 24


def test_cursor3d_and_cellipse():
    from real_time_audio_sync_tpu.streaming.display import CEllipse, Cursor3D

    e = CEllipse(cpos=(50, 40), csize=(20, 10))
    assert e.pos == (40, 35)
    e.csize = (40, 20)  # resizing keeps the center (ims/gfxutil.py:52-55)
    assert e.cpos == (50, 40)

    cur = Cursor3D(area_size=(200, 100), area_pos=(10, 20), size_range=(10, 50))
    cur.set_pos(np.array([0.25, 0.5, 1.0]))
    # reference mapping (ims/gfxutil.py:132-136)
    assert cur.get_screen_xy() == (10 + 0.25 * 200, 20 + 0.5 * 100)
    assert cur.cursor.csize == (100, 100)  # z=1 → max radius 50
    frame = cur.render(cols=21, rows=7)
    assert "●" in frame


def test_score_follower_fused_backend(chopin_pair):
    """The fused-kernel streaming backend through the full follower pipeline
    (interpret mode on CPU) commits the same path as the XLA engine."""
    ref_wav, live_wav = chopin_pair
    xla = ScoreFollower(ref_wav, engine="otw", params={"c": 50, "max_run_count": 3}, dtype=np.float32)
    fused = ScoreFollower(
        ref_wav, engine="otw", params={"c": 50, "max_run_count": 3},
        fused=True, fused_interpret=True,
    )
    for f in (xla, fused):
        f.start()
        for buf in SimulatedMic(live_wav, buffer_size=8192):
            f.receive_audio(buf)
            if f.stopped:
                break
        f.stop()
    assert [tuple(p) for p in fused.path] == [tuple(p) for p in xla.path]


def test_combine_buffers_empty():
    assert combine_buffers([]).size == 0


def test_wtw_follower_live_pipeline(chopin_pair, tmp_path):
    """wtw_live.py parity: raw buffers → WTW → field log with accuracy
    summary lines."""
    from real_time_audio_sync_tpu.streaming.runtime import WTWFollower
    from real_time_audio_sync_tpu.eval.logs import parse_field_log, parse_summary_percentages

    ref_wav, live_wav = chopin_pair
    f = WTWFollower(ref_wav, live_wav, log_dir=str(tmp_path), dtype=np.float64)
    f.start()
    events = []
    for buf in SimulatedMic(live_wav, buffer_size=2048):
        events += f.receive_audio(buf)
        if f.stopped:
            break
    log_path = f.stop()
    assert len(f.path) > 100
    log = parse_field_log(log_path)
    assert log.params()["dtw_win_size"] == 4096 * 50
    assert log.path == [tuple(p) for p in f.path]
    pct = parse_summary_percentages(log.summary)
    assert len(pct) == 4
    # live-app window size on this pair sits in the recorded 0-4% regime
    assert pct[0] < 8.0 and pct[1] < 1.0


def test_wtw_follower_async_engine_matches_host(chopin_pair, tmp_path):
    """engine="wtw_async" (device-resident stepper) commits the same path as
    the host engine and reports positions from the polled status vector
    without per-buffer device reads.

    An unpaced feed outruns the device queue (statuses are never ready when
    the host looks), so positions are checked on a paced tail — in real-time
    use audio arrives at 1x and the device always keeps up."""
    import time

    from real_time_audio_sync_tpu.streaming.runtime import WTWFollower

    ref_wav, live_wav = chopin_pair
    host = WTWFollower(ref_wav, live_wav, log_dir=str(tmp_path), dtype=np.float64, engine="wtw")
    host.start()
    for buf in SimulatedMic(live_wav, buffer_size=4096):
        host.receive_audio(buf)
        if host.stopped:
            break
    host.stop()

    f = WTWFollower(ref_wav, live_wav, log_dir=str(tmp_path), dtype=np.float64, engine="wtw_async")
    f.dtw.poll_min_interval = 0.02
    f.start()
    bufs = list(SimulatedMic(live_wav, buffer_size=4096))
    cut = int(len(bufs) * 0.8)
    events = []
    for buf in bufs[:cut]:  # unpaced bulk
        events += f.receive_audio(buf)
    f.dtw.flush()  # drain the backlog; subsequent statuses stay fresh
    for buf in bufs[cut:]:  # paced tail: device keeps up between buffers
        events += f.receive_audio(buf)
        time.sleep(0.01)
        if f.stopped:
            break
    f.stop()
    assert [tuple(p) for p in f.path] == [tuple(p) for p in host.path]
    refs = [e.ref_frame for e in events]
    assert refs and max(refs) > 100  # positions surfaced from status polls


def test_wtw_follower_transfer_dtype_plumbing(chopin_pair, tmp_path):
    """transfer_dtype reaches the AsyncWTW engine (chroma-column H2D mode)
    and is rejected for the host engine, which has no transfer path."""
    from real_time_audio_sync_tpu.streaming.runtime import WTWFollower

    ref_wav, live_wav = chopin_pair
    with pytest.raises(ValueError, match="wtw_async"):
        WTWFollower(ref_wav, live_wav, engine="wtw", transfer_dtype="chroma")

    f = WTWFollower(ref_wav, live_wav, log_dir=str(tmp_path),
                    engine="wtw_async", transfer_dtype="chroma")
    assert f.dtw.transfer_dtype == "chroma"
    f.start()
    for buf in SimulatedMic(live_wav, buffer_size=4096):
        f.receive_audio(buf)
        if f.stopped:
            break
    f.dtw.flush()
    f.stop()
    assert len(f.path) > 100  # the chroma-mode engine committed a real path


def test_app_loop_terminate_funcs_run_on_crash():
    from real_time_audio_sync_tpu.streaming.core import AppLoop, register_terminate_func, run

    ran = []

    class Crashy(AppLoop):
        def main(self):
            raise RuntimeError("boom")

    register_terminate_func(lambda: ran.append("cleanup"))
    run(Crashy())  # must not raise; cleanup must run (ims/core.py:95-102)
    assert ran == ["cleanup"]


def test_display_widgets():
    from real_time_audio_sync_tpu.streaming.display import GraphDisplay, KFAnim, MeterDisplay

    m = MeterDisplay((-96, 0), width=10)
    m.set(-48)
    bar = m.render()
    assert bar.count("█") == 5
    g = GraphDisplay(num_pts=5, in_range=(0, 8))
    for v in range(8):
        g.add_point(v)
    assert len(g.render()) == 5
    kf = KFAnim((0, 0.0), (2, 10.0))
    assert kf.eval(1) == 5.0
    assert kf.is_active(1) and not kf.is_active(3)


def test_wtw_follower_fused_engine(chopin_pair, tmp_path):
    """engine='wtw_async' (the device-resident float32 stepper) through the
    live follower: identical committed path to the host engine, positions
    surfaced from the polled status vector."""
    import time

    from real_time_audio_sync_tpu.streaming.runtime import WTWFollower

    ref_wav, live_wav = chopin_pair
    host = WTWFollower(ref_wav, live_wav, engine="wtw")
    host.start()
    for buf in SimulatedMic(live_wav, buffer_size=4096):
        host.receive_audio(buf)
        if host.stopped:
            break
    host.stop()

    f = WTWFollower(ref_wav, live_wav, log_dir=str(tmp_path),
                    engine="wtw_async", dtype=np.float32)
    f.dtw.poll_min_interval = 0.02
    f.start()
    bufs = list(SimulatedMic(live_wav, buffer_size=4096))
    events = []
    for buf in bufs[: int(len(bufs) * 0.8)]:
        events += f.receive_audio(buf)
    f.dtw.flush()
    for buf in bufs[int(len(bufs) * 0.8) :]:
        events += f.receive_audio(buf)
        time.sleep(0.01)
        if f.stopped:
            break
    log = f.stop()
    # f64 host vs f32 device: same chroma batch shapes per buffer (4096 =
    # fft_len chunks), paths equal on the real pair
    assert [tuple(p) for p in f.path] == [tuple(p) for p in host.path]
    refs = [e.ref_frame for e in events]
    assert refs and max(refs) > 100
    assert log is not None

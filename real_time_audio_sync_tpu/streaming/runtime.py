"""Host-side streaming runtime: hop framing + score following.

Mirrors the live apps' audio plumbing (livenote_live.py:161-209): incoming
mic buffers accumulate; every time a full ``fft_len`` window is available a
chroma column is extracted and fed to the engine, then the buffer advances
by ``hop_size``.  The ``ScoreFollower`` adds the beat/rehearsal-label lookup
against the reference's ground-truth CSV (livenote_live.py:198,211-227) and
field-log recording (livenote_live.py:138-154).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np

from real_time_audio_sync_tpu.config import FFT_LEN, FRAME_PERIOD_SEC, HOP_SIZE
from real_time_audio_sync_tpu.eval.ground_truth import GroundTruth, get_beat_and_label
from real_time_audio_sync_tpu.eval.logs import write_field_log
from real_time_audio_sync_tpu.streaming.writer import combine_buffers
from real_time_audio_sync_tpu.utils.profiling import EMACpuLoad, LatencyRecorder


class HopFramer:
    """Accumulates raw sample buffers; emits fft_len windows every hop_size
    samples (livenote_live.py:164-168,185-208 cadence)."""

    def __init__(self, fft_len: int = FFT_LEN, hop_size: int = HOP_SIZE):
        self.fft_len = fft_len
        self.hop_size = hop_size
        self._pending = np.empty(0, np.float32)

    def push(self, frames) -> List[np.ndarray]:
        self._pending = combine_buffers([self._pending, frames])
        out = []
        while len(self._pending) >= self.fft_len:
            out.append(self._pending[: self.fft_len].copy())
            self._pending = self._pending[self.hop_size :]
        return out


@dataclasses.dataclass
class FollowEvent:
    """One engine update: where we are in the score."""

    live_frame: int
    ref_frame: int
    beat: Optional[float]
    label: Optional[str]
    time_sec: float  # position in the reference, seconds
    stopped: bool = False


class ScoreFollower:
    """Follows a live performance against a reference recording.

    Reference surface preserved: feed raw audio via :meth:`receive_audio`
    (returns follow events), read ``.path``, ``"stop"`` handled internally;
    recording start/stop mirrors the 'r' key toggle (on stop a field log in
    the reference's exact format is written, livenote_live.py:150-154).
    """

    def __init__(
        self,
        ref_wav: str,
        engine: str = "otw",
        params: Optional[dict] = None,
        log_dir: Optional[str] = None,
        dtype=np.float32,
        use_blocks: bool = False,
        pipelined: bool = False,
        fused: bool = False,
        fused_interpret: bool = False,
    ):
        from real_time_audio_sync_tpu.eval.corpus import DEFAULT_PARAMS
        from real_time_audio_sync_tpu.features.chroma import wav_to_chroma
        from real_time_audio_sync_tpu.models import LiveNote, LiveNoteV2, OnlineTimeWarping

        self.ref_wav = ref_wav
        self.engine_name = engine
        self.params = dict(params or DEFAULT_PARAMS)
        self.use_blocks = use_blocks
        # pipelined: dispatch inserts without synchronizing on the device and
        # poll the compact status vector instead of fetching the path, so
        # the audio loop never waits on a device→host read
        self.pipelined = pipelined or fused
        # fused: the band kernel (ops/pallas_otw.py)
        # (models/fused_streaming.py) instead of the XLA scan engine —
        # implies pipelined; ``fused_interpret`` runs the kernel in the
        # Pallas interpreter (CPU tests)
        self.fused = fused

        ref_seq = wav_to_chroma(ref_wav, dtype=dtype)
        if engine not in ("otw", "livenote", "livenote_v2"):
            # the follower feeds plain chroma; the diff-feature engine
            # (livenote_v2_diff) belongs to the corpus harness, not the live app
            raise ValueError(f"unknown follower engine {engine!r}")
        if fused:
            from real_time_audio_sync_tpu.models import FusedStreamingEngine
            from real_time_audio_sync_tpu.models.online_core import ENGINE_OVERRIDES

            self.engine = FusedStreamingEngine(
                ref_seq, self.params, cfg_overrides=ENGINE_OVERRIDES[engine],
                interpret=fused_interpret,
            )
            self.engine.dtype = np.float32  # fused kernel is f32-only
        else:
            cls = {"otw": OnlineTimeWarping, "livenote": LiveNote, "livenote_v2": LiveNoteV2}[engine]
            self.engine = cls(ref_seq, self.params, dtype=dtype)

        csv_path = ref_wav[:-4] + ".csv"
        self.ground_truth = GroundTruth.from_csv(csv_path) if os.path.exists(csv_path) else None

        self.framer = HopFramer()
        self.meter = AudioMeter()
        self.latency = LatencyRecorder(audio_seconds_per_event=FRAME_PERIOD_SEC)
        self.cpu_load = EMACpuLoad()

        self.log_dir = log_dir
        self.recording = False
        self.stopped = False
        self._log_path: Optional[str] = None

    # -- 'r' key toggle (livenote_live.py:145-154) --------------------------
    def start(self) -> None:
        self.recording = True

    def stop(self) -> Optional[str]:
        """Stop following; write the path log if a log_dir was configured."""
        self.recording = False
        if self.pipelined and self.engine.flush() == "stop":
            self.stopped = True
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            self._log_path = os.path.join(
                self.log_dir, f"{self.engine_name}_test_live_{time.time()}.txt"
            )
            band = self.params.get("c", self.params.get("search_band_width", 0))
            write_field_log(
                self._log_path,
                self.ref_wav,
                [
                    ("fft_len", FFT_LEN),
                    ("hop_size", HOP_SIZE),
                    ("search_band_width", band),
                    ("max_run_count", self.params.get("max_run_count", 0)),
                ],
                self.path,
            )
        return self._log_path

    # -- audio input (livenote_live.py:161-209) ------------------------------
    def receive_audio(self, frames) -> List[FollowEvent]:
        t0 = time.perf_counter()
        self.meter.update(frames)
        events: List[FollowEvent] = []
        if self.recording and not self.stopped:
            windows = self.framer.push(frames)
            if windows:
                events = self._process(windows)
        self.cpu_load.update(time.perf_counter() - t0)
        return events

    def _process(self, windows: List[np.ndarray]) -> List[FollowEvent]:
        from real_time_audio_sync_tpu.features.chroma import chroma_frames

        import jax.numpy as jnp

        cols = np.asarray(chroma_frames(jnp.asarray(np.stack(windows), self.engine.dtype)))
        events: List[FollowEvent] = []
        if self.pipelined:
            # async dispatch; never block on the device.  The follow event
            # reports the score position from the newest completed status
            # vector (engine.last_point == path[-1]).  Engines with an
            # adaptive feed (models/fused_streaming.py) take columns one at
            # a time — dispatched immediately while the pipeline has room,
            # coalesced into one launch only under saturation.
            self.latency.start()
            if hasattr(self.engine, "feed"):
                status = None
                for k in range(cols.shape[1]):
                    status = self.engine.feed(cols[:, k])
                    if status == "stop":
                        break
            else:
                status = self.engine.insert_block_nowait(cols)
            self.latency.stop()
            if status != "stop":
                status = self.engine.poll()  # non-blocking opportunistic read
            if status == "stop":
                self.stopped = True
            events.append(self._event_from_status())
        elif self.use_blocks:
            self.latency.start()
            status = self.engine.insert_block(cols)
            self.latency.stop()
            if status == "stop":
                self.stopped = True
            events.append(self._event())
        else:
            for k in range(cols.shape[1]):
                self.latency.start()
                status = self.engine.insert(cols[:, k])
                self.latency.stop()
                if status == "stop":
                    self.stopped = True
                    events.append(self._event())
                    break
                events.append(self._event())
        return events

    def _event_from_status(self) -> FollowEvent:
        """Follow event from the engine's last polled status vector — no
        device synchronization (pipelined mode)."""
        lp = self.engine.last_point
        if lp is None or lp[0] == 0:
            return FollowEvent(0, 0, None, None, 0.0, self.stopped)
        _, live_f, ref_f = lp
        return self._lookup_event(live_f, ref_f)

    def _event(self) -> FollowEvent:
        path = self.engine.path
        if not path:
            return FollowEvent(0, 0, None, None, 0.0, self.stopped)
        live_f, ref_f = path[-1]
        return self._lookup_event(live_f, ref_f)

    def _lookup_event(self, live_f, ref_f) -> FollowEvent:
        beat, label = (None, None)
        if self.ground_truth is not None:
            beat, label = get_beat_and_label(ref_f, self.ground_truth)
        return FollowEvent(
            int(live_f), int(ref_f), beat, label, ref_f * FRAME_PERIOD_SEC, self.stopped
        )

    @property
    def path(self):
        return self.engine.path


class AudioMeter:
    """RMS→dB input meter (livenote_live.py:171-177)."""

    def __init__(self):
        self.db = -96.0

    def update(self, frames) -> float:
        mono = np.asarray(frames)
        if mono.size:
            rms = np.sqrt(np.mean(mono ** 2))
            rms = np.clip(rms, 1e-10, 1)
            self.db = float(20 * np.log10(rms))
        return self.db


class WTWFollower:
    """Live follower around the raw-audio WTW engine — the wtw_live.py app
    role (SURVEY.md §2 C12): mic buffers go straight to ``WTW.insert`` (the
    engine does its own framing), the display shows the current reference
    beat, stopping writes a field log in the WTW header format
    (wtw_live.py:169-174) and, when live ground truth exists, appends the
    accuracy-summary lines the 'e' key produced (wtw_live.py:299-307)."""

    def __init__(
        self,
        ref_wav: str,
        live_wav: Optional[str] = None,
        params: Optional[dict] = None,
        log_dir: Optional[str] = None,
        dtype=np.float32,
        engine: str = "wtw",
        transfer_dtype: str = "float32",
    ):
        # live-app window sizes (wtw_live.py:106)
        self.params = dict(
            params
            or {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 50, "dtw_hop_size": 2048 * 50}
        )
        self.ref_wav = ref_wav
        if engine == "wtw":
            if transfer_dtype != "float32":
                raise ValueError(
                    "transfer_dtype applies to the device-resident engine "
                    "('wtw_async') only")
            from real_time_audio_sync_tpu.models.wtw import WTW

            self.dtw = WTW(ref_wav, self.params, dtype=dtype)
        elif engine == "wtw_async":
            # device-resident stepper: inserts dispatch asynchronously and
            # the follow position comes from the polled status vector, so
            # the audio loop never blocks on the device.  transfer_dtype
            # "int16"/"chroma" cut the per-hop H2D bytes (AsyncWTW docs).
            from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW

            self.dtw = AsyncWTW(ref_wav, self.params, dtype=dtype,
                                transfer_dtype=transfer_dtype)
        else:
            raise ValueError(f"unknown WTW follower engine {engine!r}")
        self.engine_name = engine
        self.ref_gt = (
            GroundTruth.from_csv(ref_wav[:-4] + ".csv")
            if os.path.exists(ref_wav[:-4] + ".csv")
            else None
        )
        self.live_gt = (
            GroundTruth.from_csv(live_wav[:-4] + ".csv")
            if live_wav and os.path.exists(live_wav[:-4] + ".csv")
            else None
        )
        self.meter = AudioMeter()
        self.latency = LatencyRecorder(audio_seconds_per_event=FRAME_PERIOD_SEC)
        self.log_dir = log_dir
        self.recording = False
        self.stopped = False

    def start(self) -> None:
        self.recording = True

    def receive_audio(self, frames) -> List[FollowEvent]:
        self.meter.update(frames)
        if not self.recording or self.stopped:
            return []
        self.latency.start()
        status = self.dtw.insert(np.asarray(frames, np.float32))
        self.latency.stop()
        if status == "stop":
            self.stopped = True
        if self.engine_name == "wtw_async":
            # non-blocking: read the score position from the last polled
            # status vector instead of synchronizing on the device path
            lp = self.dtw.last_point
            if lp is None or lp[0] <= 0:
                return []
            live_f, ref_f = lp[1], lp[2]
        elif not self.dtw.path:
            return []
        else:
            live_f, ref_f = self.dtw.path[-1]
        beat = None
        if self.ref_gt is not None:
            from real_time_audio_sync_tpu.eval.ground_truth import get_beat

            beat = get_beat(ref_f, self.ref_gt.times, self.ref_gt.beats)
        return [FollowEvent(int(live_f), int(ref_f), beat, None, ref_f * FRAME_PERIOD_SEC, self.stopped)]

    def compute_error(self):
        """'e'-key behavior (wtw_live.py:212-214,267-309): beat-bucket
        accuracy of the committed path; needs live ground truth."""
        if self.live_gt is None or self.ref_gt is None:
            return None
        from real_time_audio_sync_tpu.eval.scorer import PathScorer

        return PathScorer(self.ref_gt, self.live_gt).score(self.dtw.path)

    def stop(self) -> Optional[str]:
        self.recording = False
        if self.engine_name == "wtw_async":
            if self.dtw.flush() == "stop":  # drain in-flight dispatches
                self.stopped = True
        if not self.log_dir:
            return None
        os.makedirs(self.log_dir, exist_ok=True)
        log_path = os.path.join(self.log_dir, f"wtw_test_live_{time.time()}.txt")
        summary = []
        score = self.compute_error()
        if score is not None:
            for t_, label in ((1, "1 beat"), (3, "3 beats"), (5, "5 beats"), (10, "10 beats")):
                summary.append(
                    f"Percent incorrect (within {label}):{score.pct_off_beats[t_]}%"
                )
        write_field_log(
            log_path,
            self.ref_wav,
            [
                ("fft_len", self.params["fft_len"]),
                ("hop_size", self.params["hop_size"]),
                ("dtw_win_size", self.params["dtw_win_size"]),
                ("dtw_hop_size", self.params["dtw_hop_size"]),
            ],
            self.dtw.path,
            summary=summary,
        )
        return log_path

    @property
    def path(self):
        return self.dtw.path

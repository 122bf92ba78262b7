"""Frame sources: where live audio comes from.

The reference reads a PyAudio duplex stream polled per UI frame
(ims/audio.py:64-74) — unavailable (and unnecessary) on a headless accelerator host.  Three
sources cover its roles:

- :class:`WavChunkSource` — the offline harness's streaming emulation:
  ``np.array_split(recording, n_chunks)`` (NOT fixed-size chunks — a real
  quirk of the harness, tests.py:186, wtw.py:301).
- :class:`SimulatedMic` — buffer-sized chunks on a simulated (or real-time
  paced) clock, shaped like PortAudio delivery (default buffer 512 frames,
  ims/audio.py:162-166).
- :class:`MicSource` — a real microphone via pyaudio or sounddevice when one
  is importable; raises a clear error otherwise.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np

from real_time_audio_sync_tpu.config import FS
from real_time_audio_sync_tpu.utils.wavio import load_wav


class WavChunkSource:
    """``np.array_split`` chunking of a wav file (tests.py:186 semantics)."""

    def __init__(self, path: str, n_chunks: int = 4096):
        self.samples, self.fs = load_wav(path)
        assert self.fs == FS
        self.n_chunks = n_chunks

    def __iter__(self) -> Iterator[np.ndarray]:
        yield from np.array_split(self.samples, self.n_chunks)


class SimulatedMic:
    """Fixed-size buffers from a wav file, optionally paced in real time.

    ``realtime=False`` (default) delivers as fast as the consumer pulls —
    the mic-simulation mode used for offline testing; ``realtime=True``
    sleeps to match the audio clock, for end-to-end latency rehearsals.
    """

    def __init__(self, path: Optional[str] = None, samples: Optional[np.ndarray] = None, buffer_size: int = 512, realtime: bool = False):
        if samples is None:
            if path is None:
                raise ValueError("need a wav path or a samples array")
            samples, fs = load_wav(path)
            assert fs == FS
        self.samples = np.asarray(samples, np.float32)
        self.buffer_size = buffer_size
        self.realtime = realtime

    def __iter__(self) -> Iterator[np.ndarray]:
        t_start = time.perf_counter()
        for pos in range(0, len(self.samples), self.buffer_size):
            buf = self.samples[pos : pos + self.buffer_size]
            if self.realtime:
                due = (pos + len(buf)) / FS
                lag = due - (time.perf_counter() - t_start)
                if lag > 0:
                    time.sleep(lag)
            yield buf


class ThreadedSource:
    """Runs any sample source on a producer thread, handing buffers to the
    consumer through the native lock-free SPSC ring buffer — the same
    decoupling PortAudio's ring gives the reference between the audio driver
    thread and the polled Python side (ims/audio.py:64-74)."""

    def __init__(self, source, ring_capacity: int = 1 << 18, poll_chunk: int = 2048):
        self.source = source
        self.poll_chunk = poll_chunk
        from real_time_audio_sync_tpu.native import NativeRingBuffer

        self.ring = NativeRingBuffer(ring_capacity)

    def __iter__(self):
        import threading
        import time as _time

        done = threading.Event()

        def produce():
            for buf in self.source:
                buf = np.asarray(buf, np.float32)
                off = 0
                while off < buf.size:
                    off += self.ring.push(buf[off:])
                    if off < buf.size:
                        _time.sleep(0.0005)  # ring full — consumer is behind
            done.set()

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while not (done.is_set() and self.ring.readable() == 0):
            chunk = self.ring.pop(self.poll_chunk)
            if chunk.size:
                yield chunk
            else:
                _time.sleep(0.0005)
        t.join()


class MicSource:
    """Real microphone input; requires pyaudio or sounddevice."""

    def __init__(self, buffer_size: int = 512, sample_rate: int = FS):
        self.buffer_size = buffer_size
        self.sample_rate = sample_rate
        self._backend = None
        try:  # pragma: no cover - hardware-dependent
            import pyaudio  # noqa: F401

            self._backend = "pyaudio"
        except ImportError:
            try:
                import sounddevice  # noqa: F401

                self._backend = "sounddevice"
            except ImportError:
                raise RuntimeError(
                    "no microphone backend available (install pyaudio or "
                    "sounddevice); use SimulatedMic or WavChunkSource instead"
                )

    def __iter__(self) -> Iterator[np.ndarray]:  # pragma: no cover - hardware
        if self._backend == "pyaudio":
            import pyaudio

            pa = pyaudio.PyAudio()
            stream = pa.open(
                format=pyaudio.paFloat32,
                channels=1,
                rate=self.sample_rate,
                input=True,
                frames_per_buffer=self.buffer_size,
            )
            try:
                while True:
                    n = stream.get_read_available()
                    if n:
                        data = stream.read(n, False)
                        yield np.frombuffer(data, dtype=np.float32)
            finally:
                stream.stop_stream()
                stream.close()
                pa.terminate()
        else:
            import sounddevice as sd

            with sd.InputStream(samplerate=self.sample_rate, channels=1, dtype="float32", blocksize=self.buffer_size) as stream:
                while True:
                    data, _ = stream.read(self.buffer_size)
                    yield data[:, 0]

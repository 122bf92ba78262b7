"""Adaptive transfer-mode selection for WTW serving (round-4 verdict #4).

The WTW engines accept three host→device payload encodings per dispatch
(models/wtw_async.AsyncWTW.transfer_dtype for the exactness contracts):

- ``"float32"`` — raw sample spans, exact, 4 B/sample;
- ``"int16"``   — quantized sample spans, half the bytes, bit-exact only
  for PCM16-derived mono audio;
- ``"chroma"``  — host-extracted 12-dim chroma columns, ~96× fewer bytes
  than an 8-hop f32 span, but costs host FFT time per frame.

Which one is fastest depends on the host↔device link and the host's FFT
throughput: on a slow link chroma transfer wins, while on a fast link raw
spans win (the link is not the constraint and host FFT is).  Whether the
probes and the host-FFT mode pay on a given host is a measurement (ROADMAP
S7).  The reference
never faces the choice — WTW owns its feature extraction in-process
(wtw.py:81-93); *where* extraction runs is this build's degree of freedom.

``transfer_dtype="auto"`` (the serving-layer default) probes both at
construction and picks per the crossover model below; explicit modes stay
as manual overrides, and RTAS_TRANSFER_MODE forces a mode process-wide
(probes skipped).

Crossover model — estimated wall per dispatch of ``B`` streams × ``k``
hop columns (22.05 kHz, fft_len/hop_size framing):

    t(mode)  = rtt + bytes(mode) / link_bw + host_us(mode) · B·k / workers

with ``host_us("chroma")`` the measured per-frame host-FFT cost and zero
for the span modes.  Exactness is preferred when it is nearly free: f32 is
chosen whenever it is within ``EXACT_MARGIN`` (25%) of the fastest mode —
on fast links the rtt dominates and all modes tie, so auto resolves to the
exact one.  Otherwise the faster of int16/chroma wins.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np

MODES = ("float32", "int16", "chroma")
EXACT_MARGIN = 1.25
_ENV_FORCE = "RTAS_TRANSFER_MODE"


class LinkProbe(NamedTuple):
    bytes_per_s: float
    rtt_s: float


def probe_link_bandwidth(nbytes: int = 1 << 21, repeats: int = 3) -> LinkProbe:
    """Measure effective H2D bandwidth and round-trip latency to the default
    device.  ``rtt`` is the wall of shipping + readback of a tiny array (the
    per-dispatch fixed cost every mode pays); bandwidth comes from the
    marginal cost of a ~2 MB payload over it.  Cheap (~0.1-1 s) and run once
    per process (see :func:`resolve_transfer_mode`)."""
    import jax

    dev = jax.devices()[0]
    tiny = np.zeros(8, np.float32)
    big = np.zeros(nbytes // 4, np.float32)
    # warm the dispatch path once (first put may pay lazy backend setup)
    np.asarray(jax.device_put(tiny, dev))

    rtts, bigs = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        np.asarray(jax.device_put(tiny, dev))
        rtts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        jax.block_until_ready(jax.device_put(big, dev))
        bigs.append(time.perf_counter() - t0)
    rtt = float(np.median(rtts))
    big_wall = max(float(np.median(bigs)) - rtt, 1e-6)
    return LinkProbe(bytes_per_s=nbytes / big_wall, rtt_s=rtt)


def probe_host_fft_us(n_frames: int = 256, fft_len: int = 4096,
                      fs: int = 22050) -> float:
    """Measured host chroma-extraction cost, µs/frame, on THIS host (the
    same `host_chroma_frames` path chroma transfer dispatches through)."""
    from real_time_audio_sync_tpu.features.chroma import host_chroma_frames

    frames = np.random.default_rng(0).standard_normal(
        (n_frames, fft_len)).astype(np.float32) * 0.1
    host_chroma_frames(frames[:8], n_fft=fft_len, fs=fs)  # warm constants
    t0 = time.perf_counter()
    host_chroma_frames(frames, n_fft=fft_len, fs=fs)
    return (time.perf_counter() - t0) / n_frames * 1e6


def choose_transfer_mode(n_streams: int, k_block: int, fft_len: int,
                         hop_size: int, *, link: LinkProbe,
                         host_fft_us: float, workers: int = 1) -> str:
    """Pick the fastest transfer mode under the crossover model, preferring
    the exact f32 spans whenever they are within EXACT_MARGIN of the best.

    Pure function of the probe values — unit-testable with mocked probes
    (tests/test_wtw_serving.py hits all three outcomes)."""
    span_samples = fft_len + (k_block - 1) * hop_size
    bytes_of = {
        "float32": n_streams * span_samples * 4,
        "int16": n_streams * span_samples * 2,
        "chroma": n_streams * 12 * k_block * 4,
    }
    host_s = {
        "float32": 0.0,
        "int16": 0.0,
        "chroma": n_streams * k_block * host_fft_us / max(1, workers) / 1e6,
    }
    t = {m: link.rtt_s + bytes_of[m] / link.bytes_per_s + host_s[m]
         for m in MODES}
    best = min(t.values())
    if t["float32"] <= EXACT_MARGIN * best:
        return "float32"  # exactness is (nearly) free
    return "int16" if t["int16"] <= t["chroma"] else "chroma"


_PROBE_CACHE: dict = {}


def resolve_transfer_mode(transfer_dtype: str, n_streams: int, k_block: int,
                          fft_len: int, hop_size: int,
                          workers: Optional[int] = None) -> str:
    """Resolve ``"auto"`` to a concrete mode (explicit modes pass through).

    Probes run once per process and are cached; RTAS_TRANSFER_MODE forces
    a mode without probing (ops escape hatch for known deployments)."""
    if transfer_dtype != "auto":
        return transfer_dtype
    forced = os.environ.get(_ENV_FORCE)
    if forced:
        if forced not in MODES:
            raise ValueError(
                f"{_ENV_FORCE}={forced!r} is not one of {MODES}")
        return forced
    if "link" not in _PROBE_CACHE:
        _PROBE_CACHE["link"] = probe_link_bandwidth()
    # host-FFT cost scales with the transform size — cache per fft_len so a
    # non-default WTWParams.fft_len is not priced with the 4096-point probe
    host_key = ("host_us", int(fft_len))
    if host_key not in _PROBE_CACHE and "host_us" not in _PROBE_CACHE:
        _PROBE_CACHE[host_key] = probe_host_fft_us(fft_len=fft_len)
    host_us = _PROBE_CACHE.get(host_key, _PROBE_CACHE.get("host_us"))
    if workers is None:
        from real_time_audio_sync_tpu.features.chroma import (
            resolve_host_workers,
        )

        workers = resolve_host_workers()
    return choose_transfer_mode(
        n_streams, k_block, fft_len, hop_size,
        link=_PROBE_CACHE["link"], host_fft_us=host_us,
        workers=workers)

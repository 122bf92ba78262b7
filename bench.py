"""Benchmark: streaming online time warping (the BASELINE.json headline).

Measures, on the reference corpus's Chopin 20-bar pair:

1. **streaming_otw_rtf** (the ONE reported JSON line): wall-clock real-time
   factor of PER-FRAME adaptive streaming — the full Dixon-2005 online
   recurrence (every row/column band update, direction decision and path
   commit of otw_eran.py:38-85), frames delivered ONE AT A TIME exactly as
   the reference's hop-by-hop loop (livenote_live.py:185-208), on the band
   kernel (models/fused_streaming.py feed()).  Frames coalesce into one
   multi-column launch only while the dispatch pipeline is saturated, so
   added latency is bounded by in-flight launches, never by waiting for
   future audio.  The committed path is asserted identical to the XLA
   engine's.
2. diagnostics (stderr): block streaming on the kernel and on the XLA
   engine, set_live on the XLA scan and on the kernel, batched corpus
   alignment, and beat accuracy on the pair.

``vs_baseline`` compares against the reference implementation's measured
throughput IN THE SAME REGIME: the same recurrence run by a faithful
numpy/python transcription (tests/oracle.py) streaming frame-by-frame on
this host — the reference repo publishes no numbers (BASELINE.md), so its
own code IS the baseline.

The kernel compiles for an NVIDIA GPU; on any other platform the run fails
(no fallback engine).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

REF_WAV = "/root/reference/Songs/chopin/chopin_rubinstein_20b.wav"
LIVE_WAV = "/root/reference/Songs/chopin/chopin_rachmaninoff_20b.wav"
PARAMS = {"c": 50, "max_run_count": 3}  # livenote_live.py:94
HOP_SEC = 2048 / 22050.0
HOP_FRAMES = 8  # frames per pipelined dispatch in BLOCK mode
FEED_K = 32  # max coalesced launch size of the adaptive per-frame feed


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _median_wall(fn, reps: int = 3):
    """Median wall over ``reps`` repetitions; returns (wall, last result)."""
    walls, result = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        result = fn()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), result


def main() -> int:
    import jax

    import real_time_audio_sync_tpu as rtas
    from real_time_audio_sync_tpu.models import FusedStreamingEngine, OnlineTimeWarping

    dev = jax.devices()[0]
    log(f"devices: {jax.devices()}")
    if dev.platform != "gpu":
        raise RuntimeError(f"bench.py measures the GPU; the default device is {dev.platform!r}")

    ref = np.asarray(rtas.wav_to_chroma(REF_WAV)).astype(np.float32)
    live = np.asarray(rtas.wav_to_chroma(LIVE_WAV)).astype(np.float32)
    n_frames = live.shape[1]
    audio_sec = n_frames * HOP_SEC
    log(f"pair: ref {ref.shape[1]} frames, live {n_frames} frames ({audio_sec:.1f} s of audio)")

    # --- 1. HEADLINE: adaptive PER-FRAME streaming on the band kernel
    def run_feed_stream():
        eng = FusedStreamingEngine(ref, PARAMS, k_block=FEED_K)
        for i in range(n_frames):
            if eng.feed(live[:, i]) == "stop":
                break
        eng.flush()
        return eng

    run_feed_stream()  # compile
    feed_wall, feed_eng = _median_wall(run_feed_stream)
    rtf = audio_sec / feed_wall
    sizes = feed_eng.dispatched_block_sizes or [1]
    log(f"adaptive per-frame streaming (band kernel, coalesce<=k{FEED_K}): "
        f"{feed_wall/n_frames*1e3:.3f} ms/frame -> RTF {rtf:.0f}x "
        f"({len(sizes)} launches, p50 block {int(np.median(sizes))})")

    def run_block_stream(factory):
        def run():
            eng = factory()
            for s in range(0, n_frames, HOP_FRAMES):
                if eng.insert_block_nowait(live[:, s : s + HOP_FRAMES]) == "stop":
                    break
            eng.flush()
            return eng
        return run

    for name, factory in (("band kernel", lambda: FusedStreamingEngine(ref, PARAMS, k_block=HOP_FRAMES)),
                          ("XLA engine", lambda: OnlineTimeWarping(ref, PARAMS))):
        run = run_block_stream(factory)
        run()  # compile (full + ragged tail block shapes)
        wall, eng = _median_wall(run)
        log(f"pipelined block streaming ({HOP_FRAMES} frames/dispatch, {name}): "
            f"{wall/n_frames*1e3:.3f} ms/frame -> RTF {audio_sec/wall:.0f}x")
        if not np.array_equal(eng.path_array, feed_eng.path_array):
            raise AssertionError(f"{name} block path differs from the per-frame feed path")

    # --- 2. reference-implementation baseline on this host (numpy oracle)
    sys.path.insert(0, ".")
    from tests.oracle import OracleOTW

    live64 = live.astype(np.float64)

    def run_oracle():
        oracle = OracleOTW(ref.astype(np.float64), PARAMS["c"], PARAMS["max_run_count"], "otw")
        for i in range(n_frames):
            if oracle.insert(live64[:, i]) == "stop":
                break

    py_wall, _ = _median_wall(run_oracle, reps=2)
    py_rtf = audio_sec / py_wall
    vs_baseline = rtf / py_rtf
    log(f"reference-equivalent python streaming: {py_wall:.2f} s -> RTF {py_rtf:.0f}x; "
        f"ours/reference = {vs_baseline:.1f}x")

    result = {
        "metric": "streaming_otw_rtf",
        "value": round(rtf, 1),
        "unit": "audio_sec/wall_sec",
        "vs_baseline": round(vs_baseline, 1),
        "wall_median_ms": round(feed_wall * 1e3, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }

    # --- 3. set_live: the XLA scan and the kernel, whole alignment per call
    from real_time_audio_sync_tpu.ops.pallas_otw import pallas_set_live

    def run_scan():
        eng = OnlineTimeWarping(ref, PARAMS)
        eng.set_live(live)
        return eng.path_array

    run_scan()  # compile
    scan_wall, scan_path = _median_wall(run_scan)
    pallas_set_live(ref, live, PARAMS)  # compile
    k_wall, k_out = _median_wall(lambda: pallas_set_live(ref, live, PARAMS))
    log(f"set_live: XLA scan {scan_wall*1e3:.1f} ms, band kernel {k_wall*1e3:.1f} ms "
        f"(paths equal: {np.array_equal(scan_path, k_out[0])})")

    # --- 4. batched corpus alignment (BASELINE.json config 5)
    from real_time_audio_sync_tpu.parallel import batched_set_live, pad_pairs

    B = 16
    r_b, l_b, rl_b, ll_b = pad_pairs([ref] * B, [live] * B)
    batched_set_live(r_b, l_b, rl_b, ll_b, PARAMS)  # compile
    batch_wall, _ = _median_wall(lambda: batched_set_live(r_b, l_b, rl_b, ll_b, PARAMS))
    log(f"batched corpus (B={B}, band kernel): {batch_wall*1e3:.1f} ms total -> "
        f"aggregate RTF {B*audio_sec/batch_wall:.0f}x")

    # --- 5. accuracy on the pair (field-test regime: 0-4% >1 beat, 0% >3;
    # see BASELINE.md)
    from real_time_audio_sync_tpu.eval import PathScorer
    from real_time_audio_sync_tpu.models import DTW, LiveNoteV2

    scorer = PathScorer.for_pair(REF_WAV, LIVE_WAV)
    s = scorer.score(feed_eng.path)
    log(f"accuracy OTW (streamed): >1 beat {s.pct_off_beats[1]:.2f}%, >3 beats {s.pct_off_beats[3]:.2f}%")
    v2 = LiveNoteV2(ref, {"search_band_width": 50, "max_run_count": 3})
    v2.set_live(live)
    s = scorer.score(v2.path)
    log(f"accuracy LiveNoteV2 (set_live): >1 beat {s.pct_off_beats[1]:.2f}%, >3 beats {s.pct_off_beats[3]:.2f}%")
    _, _, dpath = DTW(live, ref)
    s = scorer.score([(int(a), int(b)) for a, b in dpath])
    log(f"accuracy offline DTW: >1 beat {s.pct_off_beats[1]:.2f}%, >3 beats {s.pct_off_beats[3]:.2f}%")

    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

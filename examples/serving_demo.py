"""Multi-stream serving demo: one concert, many listeners.

``B`` simulated listeners follow the SAME reference recording, each with
its own tempo skew and staggered start — the serving configuration
(docs/SERVING.md) where one band-kernel launch per hop block advances
every stream at once (`parallel/serving.FusedMultiStreamFollower`, O(c)
band state per stream).  The demo feeds per-stream chroma columns at each hop
(streams whose skewed clock has no new frame are masked inactive), then
reports per-stream score positions, stop states and the aggregate
real-time factor.

Usage::

    python examples/serving_demo.py [--streams 8] [--ref REF.wav]
        [--live LIVE.wav] [--interpret] [--quiet]

``--interpret`` runs the Pallas interpreter (CPU hosts); the default
expects an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DEFAULT_REF = "/root/reference/Songs/chopin/chopin_rubinstein_20b.wav"
DEFAULT_LIVE = "/root/reference/Songs/chopin/chopin_rachmaninoff_20b.wav"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--ref", default=DEFAULT_REF)
    ap.add_argument("--live", default=DEFAULT_LIVE)
    ap.add_argument("--interpret", action="store_true",
                    help="Pallas interpreter mode (CPU hosts)")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="truncate the live stream (quick interpret smokes)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.interpret:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import real_time_audio_sync_tpu as rtas
    from real_time_audio_sync_tpu.parallel.serving import FusedMultiStreamFollower

    say = (lambda *a: None) if args.quiet else print
    ref = np.asarray(rtas.wav_to_chroma(args.ref), np.float32)
    live = np.asarray(rtas.wav_to_chroma(args.live), np.float32)
    if args.max_frames:
        live = live[:, : args.max_frames]
    b, t_live = args.streams, live.shape[1]
    say(f"reference {ref.shape[1]} frames, live {t_live} frames, {b} streams")

    # per-stream playback clocks: tempo skews around 1.0 plus staggered
    # starts, so streams drift apart and dispatch ragged active masks —
    # the serving regime the adaptive coalescing handles
    rng = np.random.default_rng(0)
    tempo = rng.uniform(0.85, 1.15, b)
    start = rng.integers(0, 8, b)

    fms = FusedMultiStreamFollower(
        ref, {"c": 50, "max_run_count": 3}, n_streams=b,
        interpret=args.interpret,
    )
    sent = np.zeros(b, np.int64)  # frames delivered per stream
    cols = np.zeros((b, ref.shape[0]), np.float32)
    t0 = time.perf_counter()
    # stream i delivers its t_live frames by hop start_i + t_live/tempo_i
    # (feed rate also caps at 1 frame/hop, so cover both bounds)
    n_hops = int(np.ceil((start + t_live / np.minimum(tempo, 1.0)).max())) + 16
    for hop in range(n_hops):
        due = np.minimum(((hop - start) * tempo).astype(np.int64), t_live)
        active = (due > sent) & ~fms.stopped
        if not active.any():
            if fms.stopped.all() or sent.min() >= t_live:
                break
            continue
        for i in np.nonzero(active)[0]:
            cols[i] = live[:, min(int(sent[i]), t_live - 1)]
            sent[i] += 1
        fms.feed(cols, active=active)
    fms.flush()
    wall = time.perf_counter() - t0
    paths = fms.paths()

    audio_sec = float(sent.sum()) * 2048 / 22050.0
    say(f"followed {int(sent.sum())} frames across {b} streams in "
        f"{wall:.2f} s -> aggregate RTF {audio_sec / wall:.0f}x "
        f"({audio_sec / wall / b:.1f}x per stream)")
    for i in range(b):
        pos = paths[i][-1] if len(paths[i]) else (-1, -1)
        say(f"  stream {i}: tempo {tempo[i]:.2f}, {int(sent[i])} frames fed, "
            f"position (live {pos[0]}, ref {pos[1]})"
            f"{'  [stopped]' if fms.stopped[i] else ''}")
    # every stream must have advanced through what it was fed
    min_pts = max(2, min(10, t_live // 4))
    assert all(len(p) >= min_pts for p in paths), [len(p) for p in paths]
    return 0


if __name__ == "__main__":
    sys.exit(main())

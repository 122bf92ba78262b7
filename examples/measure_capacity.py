"""Serving-capacity measurement harness (run on the GPU).

Measures the sustained per-stream real-time factor of the two serving
layers at configurable batch sizes.  One mode per invocation:

    python examples/measure_capacity.py otw      --b 256 512 1024
    python examples/measure_capacity.py otw-long --b 64 256 --ref-min 60
    python examples/measure_capacity.py wtw      --b 64 128 256
    python examples/measure_capacity.py wtw-long --b 64 --ref-min 60

Methodology: synthetic unit-norm chroma / low-amplitude noise audio,
full-rate feed (the engine is the bottleneck, not the source), wall-clock
from first feed to flush(), RT/stream = streamed_audio_seconds / wall.
Every mode checks one stream's committed path against the corresponding
solo engine on the same audio, so a capacity number can never come from a
diverged configuration.  Compare points within one invocation, on one card.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HOP_S = 2048 / 22050.0
OTW_PARAMS = {"c": 50, "max_run_count": 3}
WTW_PARAMS = {"fft_len": 4096, "hop_size": 2048,
              "dtw_win_size": 4096 * 10, "dtw_hop_size": 2048 * 10}


def _unit_chroma(rng, t):
    c = rng.random((12, t), np.float32) + 1e-3
    return c / np.linalg.norm(c, axis=0, keepdims=True)


def measure_otw(b_list, n_ref, hops, interpret=False):
    from real_time_audio_sync_tpu.models.fused_streaming import FusedStreamingEngine
    from real_time_audio_sync_tpu.parallel.serving import FusedMultiStreamFollower

    rng = np.random.default_rng(0)
    ref = _unit_chroma(rng, n_ref)
    live = _unit_chroma(rng, hops)

    solo = FusedStreamingEngine(ref, OTW_PARAMS, interpret=interpret)
    for i in range(hops):
        solo.feed(live[:, i])
    solo.flush()
    solo_path = solo.path

    for b in b_list:
        # compile OUTSIDE the timed window: a throwaway follower's first
        # dispatch compiles the kernel for this B; the timed follower's
        # first dispatch is then an execute, not a compile
        warm = FusedMultiStreamFollower(ref, OTW_PARAMS, n_streams=b,
                                        interpret=interpret)
        warm.feed(np.repeat(live[:, :1].T, b, axis=0))
        warm.flush()
        del warm
        # the step closure's self-reference makes the warm follower's
        # GB-scale donated state cycle-collected, not refcount-freed —
        # reclaim it NOW so it can't double HBM pressure in the timed run
        gc.collect()

        fms = FusedMultiStreamFollower(ref, OTW_PARAMS, n_streams=b,
                                       interpret=interpret)
        # the natural serving loop reuses one cols buffer per hop — feed()
        # copies on ingest (tested), so this is safe under saturation
        cols = np.empty((b, 12), np.float32)
        t0 = time.perf_counter()
        for i in range(hops):
            cols[:] = live[:, i]
            fms.feed(cols)
        fms.flush()
        wall = time.perf_counter() - t0
        p0 = fms.paths()[0]
        ok = [tuple(x) for x in np.asarray(p0)] == [tuple(x) for x in np.asarray(solo_path)]
        rt = hops * HOP_S / wall
        print(f"otw B={b} N={n_ref} hops={hops}: wall {wall:.2f} s -> "
              f"{rt:.1f}x RT/stream, {wall / hops / b * 1e6:.1f} us/frame/stream, "
              f"aggregate RTF {rt * b:.0f}x, paths==solo {ok}", flush=True)
        if not ok:
            return 1
    return 0


def measure_wtw(b_list, ref_min, live_s, shared=True):
    from real_time_audio_sync_tpu.features.chroma import chroma_from_samples
    from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW
    from real_time_audio_sync_tpu.parallel.wtw_serving import MultiStreamWTW

    rng = np.random.default_rng(1)
    ref = (rng.standard_normal(int(22050 * 60 * ref_min)).astype(np.float32) * 0.1)
    live = ref[: int(22050 * live_s)].copy()
    live += rng.standard_normal(live.shape[0]).astype(np.float32) * 0.02
    chunks = max(1, int(live_s / (8 * HOP_S)))

    solo = AsyncWTW(ref, WTW_PARAMS, transfer_dtype="chroma")
    for s in np.array_split(live, chunks):
        solo.insert(s)
    solo.flush()

    # extract the reference chromagram ONCE per mode — at ref_min=60 the
    # host FFT is minutes of setup, and warm + timed constructors would
    # otherwise each redo it (the dedupe memo is per-constructor)
    ref_chroma = chroma_from_samples(ref)

    first_chunk = np.array_split(live, chunks)[0]
    for b in b_list:
        refs = [ref] * b if shared else [ref.copy() for _ in range(b)]
        chromas = [ref_chroma] if shared else [ref_chroma.copy() for _ in range(b)]
        # compile outside the timed window (see measure_otw)
        warm = MultiStreamWTW(refs, WTW_PARAMS, transfer_dtype="chroma",
                              ref_chromas=chromas)
        warm.insert([first_chunk] * b)
        warm.flush()
        del warm
        gc.collect()  # see measure_otw: break-even the donated-state cycle

        ms = MultiStreamWTW(refs, WTW_PARAMS, transfer_dtype="chroma",
                            ref_chromas=chromas)
        t0 = time.perf_counter()
        for s in np.array_split(live, chunks):
            ms.insert([s] * b)
        ms.flush()
        wall = time.perf_counter() - t0
        ok = ms.paths()[0] == solo.path
        rt = live_s / wall
        print(f"wtw B={b} ref={ref_min:.0f}min live={live_s:.0f}s "
              f"shared={shared}: wall {wall:.2f} s -> {rt:.1f}x RT/stream, "
              f"aggregate RTF {rt * b:.0f}x, paths==solo {ok}", flush=True)
        if not ok:
            return 1
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["otw", "otw-long", "wtw", "wtw-long"])
    ap.add_argument("--b", type=int, nargs="+", default=[256])
    ap.add_argument("--hops", type=int, default=400)
    ap.add_argument("--n-ref", type=int, default=1900)
    ap.add_argument("--ref-min", type=float, default=60.0)
    ap.add_argument("--live-s", type=float, default=120.0)
    ap.add_argument("--interpret", action="store_true",
                    help="CPU smoke (Pallas interpret mode) - not a measurement")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (implied by --interpret)")
    ap.add_argument("--workers", type=int, default=None,
                    help="host chroma-extraction threads for the wtw modes' "
                         "transfer_dtype='chroma' payload (the serving "
                         "floor; bit-identical output for any count) — "
                         "record capacity scaling vs this on multi-core "
                         "hosts")
    args = ap.parse_args()

    if args.workers is not None:
        # the env flag reaches every host_chroma_frames call in the stack
        os.environ["RTAS_HOST_FFT_WORKERS"] = str(args.workers)
        print(f"host FFT workers: {args.workers} "
              f"(os.cpu_count()={os.cpu_count()})", flush=True)

    if args.interpret or args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.mode == "otw":
        return measure_otw(args.b, args.n_ref, args.hops, interpret=args.interpret)
    if args.mode == "otw-long":
        n_ref = int(args.ref_min * 60 / HOP_S)
        return measure_otw(args.b, n_ref, args.hops, interpret=args.interpret)
    if args.mode == "wtw":
        return measure_wtw(args.b, ref_min=1.5, live_s=args.live_s)
    return measure_wtw(args.b, ref_min=args.ref_min, live_s=args.live_s)


if __name__ == "__main__":
    sys.exit(main())

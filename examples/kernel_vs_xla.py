"""The band kernel against XLA's plain engines, on an NVIDIA GPU.

Times each entry point that the band kernel (ops/pallas_otw.py) serves
against the XLA engine that does the same job, on the ``sonata_allegro``
pair of eval/synthetic.FULL_PIECES (c=50, max_run_count=3):

- solo streaming: ``FusedStreamingEngine`` vs
  ``OnlineTimeWarping.insert_block_nowait``, both 8 frames per dispatch;
- serving: ``FusedMultiStreamFollower`` vs ``MultiStreamFollower`` at B
  streams on the shared reference;
- batched ``set_live`` over the piece's three i<j pairs: banded (the
  kernel) vs dense (the vmapped XLA scan);
- the kernel's two min-plus chain forms (tile vs sequential) on set_live.

Each line gives the wall per frame (median of ``--reps`` warm runs) and the
device busy time of one traced run (union of GPU stream events from
``jax.profiler``), beside the card's name and power limit.  Paths of the
two sides are compared; a mismatch is printed, not hidden.

    python examples/kernel_vs_xla.py [--streams 256] [--xla-hops 64] [--out DIR]
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PARAMS = {"c": 50, "max_run_count": 3}


def device_busy_s(fn, out_dir):
    """Run ``fn`` under the profiler; return (busy seconds on the GPU
    streams, number of device events)."""
    import jax

    os.makedirs(out_dir, exist_ok=True)
    jax.profiler.start_trace(out_dir)
    try:
        fn()
    finally:
        jax.profiler.stop_trace()
    files = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"), recursive=True),
                   key=os.path.getmtime)
    prof = jax.profiler.ProfileData.from_file(files[-1])
    spans = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy * 1e-9, len(spans)


def median_wall(fn, reps):
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--xla-hops", type=int, default=64,
                    help="hops timed on the dense XLA serving engine")
    ap.add_argument("--hops", type=int, default=600, help="serving hops on the kernel")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, ".smoke", "traces"),
                    help="profiler traces (large; not kept)")
    args = ap.parse_args(argv)

    import jax

    from chip_smoke import render_piece
    from real_time_audio_sync_tpu import wav_to_chroma
    from real_time_audio_sync_tpu.models import FusedStreamingEngine, OnlineTimeWarping
    from real_time_audio_sync_tpu.ops.pallas_otw import pallas_set_live
    from real_time_audio_sync_tpu.parallel import (
        FusedMultiStreamFollower,
        MultiStreamFollower,
        batched_set_live,
        pad_pairs,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs an NVIDIA GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; jax {jax.__version__}", flush=True)
    work = os.path.join(ROOT, ".smoke")
    paths = render_piece(work)
    chromas = [np.asarray(wav_to_chroma(p)) for p in paths]
    ref, live = chromas[0], chromas[1]
    t = live.shape[1]

    def report(name, frames, wall, busy, n_ev, note=""):
        print(f"{name}: wall {wall / frames * 1e6:.1f} us/frame ({wall:.4f} s), device busy "
              f"{busy / frames * 1e6:.1f} us/frame over {n_ev} events{note} [{card}]", flush=True)

    # --- solo streaming, 8 frames per dispatch
    def solo(make):
        def run():
            eng = make()
            for s in range(0, t, 8):
                eng.insert_block_nowait(live[:, s : s + 8])
            eng.flush()
            return eng
        return run

    paths_by = {}
    for name, make in (("solo kernel FusedStreamingEngine K=8", lambda: FusedStreamingEngine(ref, PARAMS)),
                       ("solo XLA OnlineTimeWarping.insert_block_nowait K=8", lambda: OnlineTimeWarping(ref, PARAMS))):
        run = solo(make)
        paths_by[name] = run().path_array  # compile + warm
        wall = median_wall(run, args.reps)
        busy, n_ev = device_busy_s(run, os.path.join(args.out, name.split()[1]))
        report(name, t, wall, busy, n_ev)
    a, b = paths_by.values()
    print(f"solo paths equal: {np.array_equal(a, b)}", flush=True)

    # --- serving at B streams on the shared reference
    bs = args.streams

    def serve(fms, hops):
        cols = np.zeros((bs, ref.shape[0]), np.float32)
        for h in range(hops):
            cols[:] = live[:, h]
            if isinstance(fms, MultiStreamFollower):
                fms.insert(cols)
            else:
                fms.feed(cols)
        if not isinstance(fms, MultiStreamFollower):
            fms.flush()
        else:
            jax.block_until_ready(fms.states)
        return fms

    warm = serve(FusedMultiStreamFollower(ref, PARAMS, n_streams=bs), 16)
    del warm
    wall = median_wall(lambda: serve(FusedMultiStreamFollower(ref, PARAMS, n_streams=bs), args.hops),
                       args.reps)
    busy, n_ev = device_busy_s(
        lambda: serve(FusedMultiStreamFollower(ref, PARAMS, n_streams=bs), args.hops),
        os.path.join(args.out, "serve_kernel"))
    report(f"serving kernel FusedMultiStreamFollower B={bs} (per hop for all streams)",
           args.hops, wall, busy, n_ev)
    kpaths = serve(FusedMultiStreamFollower(ref, PARAMS, n_streams=bs), args.xla_hops).paths()

    xla = MultiStreamFollower([ref] * bs, PARAMS)
    serve(xla, 2)  # compile
    del xla
    xla = MultiStreamFollower([ref] * bs, PARAMS)
    t0 = time.perf_counter()
    serve(xla, args.xla_hops)
    wall = time.perf_counter() - t0
    xpaths = xla.paths()
    busy, n_ev = device_busy_s(lambda: serve(xla, 8), os.path.join(args.out, "serve_xla"))
    report(f"serving XLA MultiStreamFollower B={bs} (per hop for all streams)",
           args.xla_hops, wall, busy * args.xla_hops / 8, n_ev,
           note=f" (busy from 8 traced hops, scaled; dense state {xla.states.acc.nbytes / 2**30:.1f} GiB)")
    same = all(np.array_equal(kp, xp) for kp, xp in zip(kpaths, xpaths))
    print(f"serving paths equal after {args.xla_hops} hops: {same}", flush=True)
    del xla

    # --- batched set_live over the three pairs
    pairs = [(chromas[i], chromas[j]) for i in range(3) for j in range(i + 1, 3)]
    r, l, rl, ll = pad_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    frames = int(ll.sum())
    out = {}
    for backend in ("banded", "dense"):
        run = lambda: batched_set_live(r, l, rl, ll, PARAMS, backend=backend)[0]
        out[backend] = run()
        wall = median_wall(run, args.reps)
        busy, n_ev = device_busy_s(run, os.path.join(args.out, f"corpus_{backend}"))
        report(f"batched_set_live {backend} (3 pairs)", frames, wall, busy, n_ev)
    same = all(np.array_equal(a, b) for a, b in zip(out["banded"], out["dense"]))
    print(f"batched_set_live paths equal: {same}", flush=True)

    # --- the kernel's two chain forms, set_live on one pair
    res = {}
    for exact in (False, True):
        run = lambda: pallas_set_live(ref, live, PARAMS, exact_chain=exact)
        res[exact] = run()[0]
        wall = median_wall(run, args.reps)
        busy, n_ev = device_busy_s(run, os.path.join(args.out, f"chain_{'seq' if exact else 'tile'}"))
        report(f"kernel set_live chain={'sequential' if exact else 'tile'}", t, wall, busy, n_ev)
    print(f"chain forms paths equal: {np.array_equal(res[False], res[True])}", flush=True)
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

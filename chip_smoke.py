"""Smoke run of the score follower on an NVIDIA GPU.

Drives the main path once, through the entry points a user calls, on one
full-length piece rendered in-process from ``FULL_PIECES["sonata_allegro"]``
(eval/synthetic.py): recording ``_00`` (~290 s) is the reference, ``_01`` the
live performance.  Every result is compared with the plain reference
implementation in tests/oracle.py (f64 numpy), or, for serving, with the solo
engine on the same input.  Each phase prints its wall time, the XLA compile
time inside it and its comparison; any failed comparison raises, so the
script exits non-zero and prints no result line.

    python chip_smoke.py             # one card: every phase
    python chip_smoke.py --cards 4   # four cards: sharded serving and
                                     # batched set_live, each against a
                                     # one-card run of the same inputs

The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU (or without the rest of the repository beside it) the script
fails before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PARAMS = {"c": 50, "max_run_count": 3}  # the live app's (livenote_live.py:94)
PIECE = "sonata_allegro"
FS = 22050
WTW_SECONDS = 35.0
SKEW_HOPS = 64  # serving: streams start 0..63 hops apart
MIN_HOPS = 600  # serving: every stream runs at least this many hops

_compile_s = [0.0]


def _on_duration(event, duration, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _compile_s[0] += duration


def phase(name, fn, *args, **kw):
    """Run one phase; print its wall, compile time and comparison."""
    c0 = _compile_s[0]
    t0 = time.perf_counter()
    result, note = fn(*args, **kw)
    wall = time.perf_counter() - t0
    print(f"phase {name}: wall {wall:.3f} s, compile {_compile_s[0] - c0:.3f} s, {note}",
          flush=True)
    return result


def same_path(got, want, what):
    got = np.asarray(got, np.int64).reshape(-1, 2)
    want = np.asarray(want, np.int64).reshape(-1, 2)
    if got.shape != want.shape or not np.array_equal(got, want):
        n = min(len(got), len(want))
        diff = np.nonzero(np.any(got[:n] != want[:n], axis=1))[0]
        first = int(diff[0]) if diff.size else n
        raise AssertionError(
            f"{what}: path differs ({len(got)} vs {len(want)} points, first at "
            f"{first}: {got[first:first + 1].tolist()} vs {want[first:first + 1].tolist()})")
    return len(got)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def render_piece(workdir, seconds=None):
    """Render the piece's recordings to PCM16 wavs under ``workdir`` (the
    frontend's entry point reads files); returns their paths."""
    from real_time_audio_sync_tpu.eval.synthetic import FULL_PIECES, _chart, render
    from real_time_audio_sync_tpu.utils.wavio import write_wav

    seed, n_beats, rends = FULL_PIECES[PIECE]
    chart = _chart(seed, n_beats)
    os.makedirs(workdir, exist_ok=True)
    paths = []
    for i, rend in enumerate(rends):
        wav, _ = render(chart, rend)
        if seconds is not None:
            wav = wav[: int(seconds * FS)]
        path = os.path.join(workdir, f"{PIECE}_{i:02d}.wav")
        write_wav(path, wav)
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def chroma_phase(paths):
    import jax

    from real_time_audio_sync_tpu import wav_to_chroma
    from real_time_audio_sync_tpu.features.chroma import chroma_pipeline
    from real_time_audio_sync_tpu.utils.wavio import load_wav
    from tests.oracle import oracle_chroma

    chromas, errs = [], []
    for p in paths:
        c = np.asarray(wav_to_chroma(p))
        samples, _ = load_wav(p)
        want = oracle_chroma(np.asarray(samples, np.float64))
        errs.append(float(np.abs(c - want).max()))
        chromas.append(c)
    if max(errs) > 1e-5:
        raise AssertionError(f"chroma max abs error {max(errs):.3g} > 1e-5")
    # what the pin on Precision.HIGHEST protects against (FRONTEND_PRECISION)
    samples, _ = load_wav(paths[0])
    low = np.asarray(chroma_pipeline(jax.numpy.asarray(samples),
                                     precision=jax.lax.Precision.DEFAULT))
    low_err = float(np.abs(low[:, : chromas[0].shape[1]] - oracle_chroma(
        np.asarray(samples, np.float64))).max())
    shapes = [c.shape[1] for c in chromas]
    return chromas, (f"frames {shapes}; max abs error vs oracle_chroma {max(errs):.3g} "
                     f"(limit 1e-5); DEFAULT matmul precision would give {low_err:.3g}")


# float32 engines cannot resolve what f64 resolves: where two candidate
# cells' f64 accumulated costs differ by less than the f32 engine's rounding
# (the 12-term cosine 1 − q·r cancels near 1, so each cost carries ~1e-7
# absolute error, and a path sums thousands), an f32 engine may take
# either.  Their paths are checked with the oracle following the engine
# through such ties only (OracleOTW ``follow``): a gap of at most
# 1e-5 + 2**-22·|acc| (on the sonata pairs the largest is ~3e-6).  float64
# runs are compared exactly.
F32_TIE_ATOL, F32_TIE_RTOL = 1e-5, 2.0 ** -22


def _oracle(ref, live, variant, mode, follow=None):
    """OracleOTW path for ``mode`` "insert" or "set_live"; with ``follow``,
    also the number of f32 ties taken and the largest gap."""
    from tests.oracle import OracleOTW

    tol = (F32_TIE_ATOL, F32_TIE_RTOL) if follow is not None else (0.0, 0.0)
    o = OracleOTW(ref.astype(np.float64), PARAMS["c"], PARAMS["max_run_count"], variant,
                  follow=follow, atol=tol[0], rtol=tol[1])
    live = live.astype(np.float64)
    if mode == "set_live":
        path = o.set_live(live)
    else:
        for i in range(live.shape[1]):
            if o.insert(live[:, i]) == "stop":
                break
        path = np.asarray(o.path)
    return path, len(o.tie_gaps), max(o.tie_gaps, default=0.0)


def check_f32(path, ref, live, mode, what):
    want, ties, gap = _oracle(ref, live, "otw", mode, follow=path)
    n = same_path(path, want, what)
    return f"{n} points == OracleOTW {mode} ({ties} f32 ties, max gap {gap:.2e})"


def check_f64(path, ref, live, mode, what, variant):
    n = same_path(path, _oracle(ref, live, variant, mode)[0], what)
    return f"{n} points == OracleOTW {mode} exactly"


def _drive(eng, live, how):
    t0 = time.perf_counter()
    if how == "insert":
        for i in range(live.shape[1]):
            if eng.insert(live[:, i]) == "stop":
                break
    elif how == "insert_block_nowait":
        for s in range(0, live.shape[1], 8):
            if eng.insert_block_nowait(live[:, s : s + 8]) == "stop":
                break
        eng.flush()
    else:
        eng.set_live(live)
    path = eng.path_array
    return path, time.perf_counter() - t0


def online_xla_phase(ref, live):
    """OnlineTimeWarping (float32, the default) and LiveNoteV2 (float64, the
    parity dtype: its monotone guard hides decisions from the path) on the
    XLA engine, through insert, 8-frame insert_block_nowait and set_live."""
    import jax

    from real_time_audio_sync_tpu.models import LiveNoteV2, OnlineTimeWarping

    notes = []
    for how in ("insert", "insert_block_nowait", "set_live"):
        mode = "set_live" if how == "set_live" else "insert"
        path, wall = _drive(OnlineTimeWarping(ref, PARAMS), live, how)
        notes.append(f"otw f32 {how} {wall:.3f} s: "
                     + check_f32(path, ref, live, mode, f"otw {how}"))
    with jax.enable_x64(True):
        ref64, live64 = ref.astype(np.float64), live.astype(np.float64)
        for how in ("insert", "insert_block_nowait", "set_live"):
            mode = "set_live" if how == "set_live" else "insert"
            path, wall = _drive(LiveNoteV2(ref64, PARAMS, dtype=np.float64), live64, how)
            notes.append(f"livenote_v2 f64 {how} {wall:.3f} s: "
                         + check_f64(path, ref, live, mode, f"livenote_v2 {how}", "livenote_v2"))
    return None, "; ".join(notes)


def fused_phase(ref, live, interpret=False):
    """FusedStreamingEngine.feed, frame by frame, on the band kernel."""
    from real_time_audio_sync_tpu.models import FusedStreamingEngine

    eng = FusedStreamingEngine(ref, PARAMS, interpret=interpret)
    t0 = time.perf_counter()
    for i in range(live.shape[1]):
        if eng.feed(live[:, i]) == "stop":
            break
    eng.flush()
    wall = time.perf_counter() - t0
    note = check_f32(eng.path_array, ref, live, "insert", "FusedStreamingEngine.feed")
    return None, (f"{live.shape[1]} frames, {wall / live.shape[1] * 1e6:.1f} us/frame "
                  f"({len(eng.dispatched_block_sizes)} launches); {note}")


def _serving_feed(fms, live, starts, total):
    b = len(starts)
    cols = np.zeros((b, live.shape[0]), np.float32)
    for hop in range(total):
        k = hop - starts
        active = k >= 0
        cols[active] = live[:, k[active]].T
        fms.feed(cols, active)
    fms.flush()
    return fms.paths()


def serving_phase(ref, live, b=256, interpret=False, min_hops=MIN_HOPS):
    """FusedMultiStreamFollower: B streams on the shared reference, stream i
    starting i % 64 hops late, every stream running >= 600 hops; each path
    against the solo engine fed the same frames."""
    from real_time_audio_sync_tpu.models import FusedStreamingEngine
    from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower

    starts = np.arange(b) % SKEW_HOPS
    total = min_hops + SKEW_HOPS - 1
    fms = FusedMultiStreamFollower(ref, PARAMS, n_streams=b, interpret=interpret)
    t0 = time.perf_counter()
    paths = _serving_feed(fms, live, starts, total)
    wall = time.perf_counter() - t0
    checked = 0
    for s in np.unique(starts):
        solo = FusedStreamingEngine(ref, PARAMS, interpret=interpret)
        for i in range(total - s):
            solo.feed(live[:, i])
        solo.flush()
        for i in np.nonzero(starts == s)[0]:
            same_path(paths[i], solo.path_array, f"serving stream {i}")
            checked += 1
    return None, (f"B={b}, {total} hops ({total - SKEW_HOPS + 1}-{total} per stream), "
                  f"{wall / total * 1e3:.2f} ms/hop for all streams; {checked} stream "
                  f"paths == solo engine")


def dtw_phase(ref, live):
    """Offline DTW() on the whole pair (the XLA wavefront scan): float64
    against oracle_dtw exactly, float32 (the default) timed beside it."""
    import jax

    from real_time_audio_sync_tpu.models import DTW
    from tests.oracle import oracle_dtw

    t0 = time.perf_counter()
    _, _, p32 = DTW(live, ref)
    t32 = time.perf_counter() - t0
    with jax.enable_x64(True):
        t0 = time.perf_counter()
        _, _, p64 = DTW(live, ref, dtype=np.float64)
        t64 = time.perf_counter() - t0
    cost, acc, want = oracle_dtw(live.astype(np.float64), ref.astype(np.float64))
    n = same_path(p64, want, "DTW float64")
    ties, gap = _dtw_f32_ties(np.asarray(p32), cost, acc, want)
    return None, (f"{live.shape[1]}x{ref.shape[1]}: float32 {t32:.3f} s, float64 {t64:.3f} s; "
                  f"float64 path == oracle_dtw ({n} points); float32 path optimal up to "
                  f"{ties} f32 ties (max gap {gap:.2e})")


def _dtw_f32_ties(path, cost, acc, want):
    """The float32 DTW path is a warping path from (0, 0) to the end whose
    every step is optimal in f64 up to an f32 tie (F32_TIE_*); returns the
    number of steps off the oracle's choice and the largest gap."""
    if tuple(path[0]) != (0, 0) or tuple(path[-1]) != tuple(want[-1]):
        raise AssertionError("DTW float32 path does not span the pair")
    prev, cur = path[:-1], path[1:]
    step = cur - prev
    if not np.all(np.all((step >= 0) & (step <= 1), axis=1) & (step.sum(axis=1) >= 1)):
        raise AssertionError("DTW float32 path takes an invalid step")
    w = np.where(step.sum(axis=1) == 2, 2.0, 1.0)
    via = acc[prev[:, 0], prev[:, 1]] + w * cost[cur[:, 0], cur[:, 1]]
    best = acc[cur[:, 0], cur[:, 1]]
    gap = via - best
    if np.any(gap > F32_TIE_ATOL + F32_TIE_RTOL * np.abs(best)):
        raise AssertionError(f"DTW float32 path leaves f64 optimality by {gap.max():.3g}")
    return int(np.count_nonzero(gap > 0)), float(gap.max(initial=0.0))


def _pairs(chromas):
    return [(chromas[i], chromas[j]) for i in range(len(chromas))
            for j in range(i + 1, len(chromas))]


def corpus_phase(chromas, interpret=False):
    """batched_set_live (band kernel) over the three i<j pairs of the piece."""
    from real_time_audio_sync_tpu.parallel import batched_set_live, pad_pairs

    pairs = _pairs(chromas)
    r, l, rl, ll = pad_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    t0 = time.perf_counter()
    paths, _ = batched_set_live(r, l, rl, ll, PARAMS, interpret=interpret)
    wall = time.perf_counter() - t0
    notes = [check_f32(paths[k], ref, live, "set_live", f"pair {k}")
             for k, (ref, live) in enumerate(pairs)]
    return None, f"{len(pairs)} pairs in {wall:.3f} s; " + "; ".join(notes)


def wtw_phase(paths):
    """AsyncWTW on the first 35 s of the pair, at the reference's test_all
    WTW settings (tests.py:174: 20-frame window, 10-frame hop): float64
    against OracleWTW exactly, float32 (the default) timed beside it."""
    import jax

    from real_time_audio_sync_tpu.eval.corpus import DEFAULT_WTW_PARAMS
    from real_time_audio_sync_tpu.models import AsyncWTW
    from real_time_audio_sync_tpu.utils.wavio import load_wav
    from tests.oracle import OracleWTW, oracle_chroma, oracle_chroma_from_stft

    n = int(WTW_SECONDS * FS)
    ref = load_wav(paths[0])[0][:n]
    live = load_wav(paths[1])[0][:n]
    chunks = np.array_split(live, len(live) // 4096)  # harness chunking (tests.py:186)
    p = DEFAULT_WTW_PARAMS

    def follow(dtype):
        eng = AsyncWTW(ref, p, dtype=dtype)
        t0 = time.perf_counter()
        for ch in chunks:
            if eng.insert(ch) == "stop":
                break
        eng.flush()
        return eng.path, time.perf_counter() - t0

    p32, t32 = follow(np.float32)
    with jax.enable_x64(True):
        p64, t64 = follow(np.float64)

    win = np.hanning(p["fft_len"])
    oracle = OracleWTW(
        oracle_chroma(np.asarray(ref, np.float64)), p["fft_len"], p["hop_size"],
        p["dtw_win_size"], p["dtw_hop_size"],
        col_fn=lambda sec: oracle_chroma_from_stft(np.fft.rfft(sec * win)[:, None])[:, 0],
    )
    for ch in chunks:
        if oracle.insert(np.asarray(ch, np.float64).tolist()) == "stop":
            break
    m = same_path(p64, oracle.path, "AsyncWTW float64")
    return None, (f"{WTW_SECONDS:.0f} s: float32 {t32:.3f} s, float64 {t64:.3f} s; float64 "
                  f"path == OracleWTW ({m} points); float32 path equal: {p32 == p64}")


def four_card_phase(ref, chromas, b=1024, interpret=False, min_hops=MIN_HOPS):
    """FusedMultiStreamFollower with B streams sharded over four cards and
    batched_set_live over the mesh, each against a one-card run of the same
    inputs in this process."""
    from real_time_audio_sync_tpu.parallel import (
        FusedMultiStreamFollower,
        batched_set_live,
        corpus_mesh,
        pad_pairs,
    )

    live = chromas[1]
    mesh = corpus_mesh(4)
    starts = np.arange(b) % SKEW_HOPS
    total = min_hops + SKEW_HOPS - 1
    t0 = time.perf_counter()
    sharded = _serving_feed(
        FusedMultiStreamFollower(ref, PARAMS, n_streams=b, mesh=mesh, interpret=interpret),
        live, starts, total)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = _serving_feed(
        FusedMultiStreamFollower(ref, PARAMS, n_streams=b, interpret=interpret),
        live, starts, total)
    t_one = time.perf_counter() - t0
    for i in range(b):
        same_path(sharded[i], single[i], f"sharded stream {i}")

    pairs = _pairs(chromas)
    pairs.append(pairs[0][::-1])  # four pairs: one per card
    r, l, rl, ll = pad_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    on_mesh, mean_mesh = batched_set_live(r, l, rl, ll, PARAMS, mesh=mesh, interpret=interpret)
    on_one, mean_one = batched_set_live(r, l, rl, ll, PARAMS, interpret=interpret)
    for k in range(len(pairs)):
        same_path(on_mesh[k], on_one[k], f"mesh pair {k}")
    if float(mean_mesh) != float(mean_one):
        raise AssertionError(f"mean path length {float(mean_mesh)} vs {float(mean_one)}")
    return None, (f"serving B={b} on 4 cards {t_mesh:.2f} s vs 1 card {t_one:.2f} s, "
                  f"{b} paths equal; batched_set_live {len(pairs)} pairs on the mesh == "
                  f"one card (mean path length {float(mean_mesh):.1f})")


# ---------------------------------------------------------------------------


def run(cards=1, workdir=None, seconds=None, b=None, interpret=False):
    """All phases (one card) or the four-card phase.  ``seconds`` shortens
    the piece and ``interpret`` runs the kernel in the Pallas interpreter:
    both only for rehearsals at a small size, never for a result."""
    import jax

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    workdir = workdir or os.path.join(ROOT, ".smoke")
    try:
        paths = phase("render", lambda: (render_piece(workdir, seconds),
                                         f"{PIECE} recordings rendered to PCM16"))
        if cards == 4:
            from real_time_audio_sync_tpu import wav_to_chroma

            chromas = [np.asarray(wav_to_chroma(p)) for p in paths]
            phase("four_cards", four_card_phase, chromas[0], chromas, b=b or 1024,
                  interpret=interpret, min_hops=min(MIN_HOPS, chromas[1].shape[1] - SKEW_HOPS + 1))
            return
        chromas = phase("chroma", chroma_phase, paths)
        ref, live = chromas[0], chromas[1]
        phase("online_xla", online_xla_phase, ref, live)
        phase("fused_streaming", fused_phase, ref, live, interpret=interpret)
        phase("serving", serving_phase, ref, live, b=b or 256, interpret=interpret,
              min_hops=min(MIN_HOPS, live.shape[1] - SKEW_HOPS + 1))
        phase("dtw", dtw_phase, ref, live)
        phase("batched_set_live", corpus_phase, chromas, interpret=interpret)
        phase("async_wtw", wtw_phase, paths)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"--cards {args.cards} needs {args.cards} GPUs; JAX found {len(devices)}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    print(f"jax {jax.__version__}, devices {devices}", flush=True)
    run(cards=args.cards)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

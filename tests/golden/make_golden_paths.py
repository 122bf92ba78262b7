"""Generate the pinned committed-path goldens for the online engines on the
real Chopin pair (round-4 verdict #6).

Replaces the old 10-percentage-point score-agreement tolerance
(test_online_real.py) with exact per-engine path pins: any ulp-level
regression in the band chain, the min-plus composition, or the cost matmul
now fails loudly instead of drifting under a loose bound.

Pins every engine x {insert, set_live} x {float32, float64} on the CPU
platform (the test platform — conftest pins it).  Regenerate ONLY when an
intentional numerics change lands, and say so in the commit:

    JAX_PLATFORMS=cpu python tests/golden/make_golden_paths.py

Mirrors the reference's own insert-vs-set_live equivalence regime
(test_simple.py:101-131) with the harness feature kinds (tests.py:156).
"""

import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))

REF_WAV = "/root/reference/Songs/chopin/chopin_rubinstein_20b.wav"
LIVE_WAV = "/root/reference/Songs/chopin/chopin_rachmaninoff_20b.wav"

ENGINES = ("otw", "livenote", "livenote_v2", "livenote_v2_diff")


def committed_path(engine: str, mode: str, dtype) -> np.ndarray:
    from real_time_audio_sync_tpu.features.chroma import (
        wav_to_chroma,
        wav_to_chroma_diff,
    )
    from real_time_audio_sync_tpu.models import (
        LiveNote,
        LiveNoteV2,
        OnlineTimeWarping,
    )

    extract = wav_to_chroma_diff if engine == "livenote_v2_diff" else wav_to_chroma
    ref_seq = np.asarray(extract(REF_WAV, dtype=dtype))
    live_seq = np.asarray(extract(LIVE_WAV, dtype=dtype))
    params = {"c": 50, "max_run_count": 3}  # livenote_live.py:94
    ctor = {
        "otw": lambda: OnlineTimeWarping(ref_seq, params, dtype=dtype),
        "livenote": lambda: LiveNote(ref_seq, params, dtype=dtype),
        "livenote_v2": lambda: LiveNoteV2(ref_seq, params, dtype=dtype),
        "livenote_v2_diff": lambda: LiveNoteV2(ref_seq, params,
                                               chroma_diff=True, dtype=dtype),
    }[engine]
    eng = ctor()
    if mode == "set_live":
        eng.set_live(live_seq)
    else:
        for i in range(live_seq.shape[1]):
            if eng.insert(live_seq[:, i]) == "stop":
                break
    return np.asarray(eng.path, dtype=np.int64)


def main():
    # jax.config forces CPU here, exactly as tests/conftest.py does for the
    # suite the goldens feed
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    assert jax.default_backend() == "cpu", "goldens are CPU-pinned"
    out = {}
    for engine in ENGINES:
        for mode in ("insert", "set_live"):
            for dtype in (np.float32, np.float64):
                key = f"{engine}_{mode}_{np.dtype(dtype).name}"
                out[key] = committed_path(engine, mode, dtype)
                print(f"{key}: {out[key].shape[0]} pts, "
                      f"end={tuple(out[key][-1])}")
    dest = pathlib.Path(__file__).parent / "chopin_paths.npz"
    np.savez_compressed(dest, **out)
    print(f"wrote {dest} ({dest.stat().st_size} bytes)")


if __name__ == "__main__":
    main()

"""Notebook-equivalent visualization (reference livenote_v2.ipynb /
field_testing.ipynb — SURVEY.md §2 C18): accumulated-cost heatmaps with the
committed path overlaid, LiveNote vs LiveNoteV2 comparison, and a recorded
field-test path replayed over the offline path.

Usage::

    python examples/heatmap_overlay.py --ref ref.wav --live live.wav \
        [--field-log tests/x.txt] [--out overlay.png]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import os as _os

# JAX_PLATFORMS applied through jax.config before first use
if _os.environ.get("JAX_PLATFORMS"):
    import jax as _jax

    try:
        _jax.config.update("jax_platforms", _os.environ["JAX_PLATFORMS"])
    except Exception:
        pass

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", required=True)
    ap.add_argument("--live", required=True)
    ap.add_argument("--field-log", help="recorded field-test path to overlay")
    ap.add_argument("--out", default="overlay.png")
    args = ap.parse_args(argv)

    import real_time_audio_sync_tpu as rtas
    from real_time_audio_sync_tpu.models import LiveNote, LiveNoteV2

    ref_seq = rtas.wav_to_chroma(args.ref)
    live_seq = rtas.wav_to_chroma(args.live)
    params = {"search_band_width": 50, "max_run_count": 3}

    engines = {
        "LiveNote": LiveNote(ref_seq, params),
        "LiveNoteV2": LiveNoteV2(ref_seq, params),
    }
    fig, axes = plt.subplots(1, len(engines), figsize=(14, 6), squeeze=False)
    for ax, (name, engine) in zip(axes[0], engines.items()):
        engine.set_live(live_seq)
        acc = engine.acc_cost.copy()
        acc[~np.isfinite(acc)] = np.nan
        acc[acc >= 1e9] = np.nan  # uncomputed band exterior
        t_max = engine.live_ptr + 1
        ax.imshow(acc[:t_max].T, origin="lower", aspect="auto", cmap="viridis")
        path = engine.path_array
        ax.plot(path[:, 0], path[:, 1], "r-", linewidth=1.0, label=f"{name} path")
        if args.field_log:
            from real_time_audio_sync_tpu.eval import path_from_field_log

            fp = np.asarray(path_from_field_log(args.field_log))
            ax.plot(fp[:, 0], fp[:, 1], "w--", linewidth=0.8, label="recorded field path")
        ax.set_xlabel("live frame")
        ax.set_ylabel("ref frame")
        ax.set_title(f"{name}: accumulated cost + committed path")
        ax.legend(loc="lower right")
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

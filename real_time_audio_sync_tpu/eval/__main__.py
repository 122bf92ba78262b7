"""CLI for the evaluation harness.

Examples::

    # all engines on one pair (test_simple.py driver equivalent)
    python -m real_time_audio_sync_tpu.eval --ref ref.wav --live live.wav

    # one engine
    python -m real_time_audio_sync_tpu.eval --ref r.wav --live l.wav --engine otw

    # corpus sweep (test_all equivalent)
    python -m real_time_audio_sync_tpu.eval --corpus Songs/ --engine livenote_v2_diff

    # score a recorded field log against ground-truth CSVs
    python -m real_time_audio_sync_tpu.eval --score-log tests/x.txt --ref-csv a.csv --live-csv b.csv
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="real_time_audio_sync_tpu.eval", description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ref", help="reference recording (wav)")
    ap.add_argument("--live", help="live recording (wav)")
    ap.add_argument("--engine", default=None, help=(
        "dtw|otw|livenote|livenote_v2|livenote_v2_diff|wtw (default: all "
        "for --ref/--live, livenote_v2_diff for --corpus).  Caveats from "
        "the measured corpus table (docs/ACCURACY.md): livenote_v2_diff "
        "trades noise robustness for tacet robustness — best-in-class "
        "through silence/dropouts but collapses (76-83%% >1 beat) under "
        "heavy noise or detune; wtw commits windows irrevocably and "
        "collapses on multi-minute jittered pieces (45-48%% >3 s)."))
    ap.add_argument("--corpus", help="corpus directory (test_all sweep)")
    ap.add_argument("--field-log", help="recorded field log for the BSO cross-check during --corpus")
    ap.add_argument("--score-log", help="score a recorded field log instead of aligning")
    ap.add_argument("--ref-csv", help="ground-truth CSV for --score-log (reference side)")
    ap.add_argument("--live-csv", help="ground-truth CSV for --score-log (live side)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--mode", default="insert", choices=["insert", "fused", "oracle"],
                    help="insert: stream frame-by-frame (reference harness regime); "
                         "fused: whole alignment through the fused device backends "
                         "(the band kernel's set_live for the online engines; for wtw "
                         "a corpus sweep batches ALL pairs into one multi-stream run)")
    ap.add_argument("--interpret", action="store_true",
                    help="run the band kernel in the Pallas interpreter (CPU hosts)")
    args = ap.parse_args(argv)

    import numpy as np

    dtype = np.dtype(args.dtype)

    if args.score_log:
        if not (args.ref_csv and args.live_csv):
            ap.error("--score-log requires --ref-csv and --live-csv")
        from real_time_audio_sync_tpu.eval.ground_truth import GroundTruth
        from real_time_audio_sync_tpu.eval.logs import path_from_field_log
        from real_time_audio_sync_tpu.eval.scorer import PathScorer

        scorer = PathScorer(GroundTruth.from_csv(args.ref_csv), GroundTruth.from_csv(args.live_csv))
        s = scorer.score(path_from_field_log(args.score_log))
        for t in (1, 3, 5, 10):
            print(f"Percent incorrect (within {t} beat{'s' if t > 1 else ''}): {s.pct_off_beats[t]} %")
        for t in (1, 3, 5, 10):
            print(f"Percent incorrect (within {t} second{'s' if t > 1 else ''}): {s.pct_off_secs[t]} %")
        return 0

    if args.corpus:
        from real_time_audio_sync_tpu.eval.corpus import CorpusRunner

        runner = CorpusRunner(args.corpus, args.engine or "livenote_v2_diff", dtype=dtype,
                              mode=args.mode, interpret=args.interpret)
        runner.evaluate(field_log=args.field_log)
        return 0

    if args.ref and args.live:
        from real_time_audio_sync_tpu.eval.corpus import ENGINES, align_pair, run_simple

        if args.engine:
            result = align_pair(args.ref, args.live, args.engine, dtype=dtype, mode=args.mode,
                                interpret=args.interpret)
            s = result.score
            for t in (1, 3, 5, 10):
                print(f"Percent incorrect (within {t} beat{'s' if t > 1 else ''}): {s.pct_off_beats[t]} %")
            print(f"Percent incorrect (within 3 seconds): {s.pct_off_3s} %")
        else:
            run_simple(args.ref, args.live, ENGINES, dtype=dtype)
        return 0

    ap.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())

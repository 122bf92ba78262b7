"""Pair and corpus evaluation drivers (reference tests.py:143-262,
test_simple.py:94-198).

``align_pair`` mirrors ``test_livenote``/``test_wtw``: extract features, run
the selected engine streaming (insert-per-frame for chroma engines,
``np.array_split(live, 4096)`` raw-audio chunks for WTW — the harness's real
quirk, tests.py:186), then score against beat ground truth.

``CorpusRunner`` mirrors ``test_all``: walk the corpus directory, form all
i<j recording pairs per piece (skipping ``_20b`` excerpts, tests.py:216),
evaluate the engine on each pair, average the headline metric (% of path
points >3 s off), and cross-check the recorded BSO field path when
applicable (tests.py:245-251).  Missing wav files are reported and skipped
(the reference would crash; most corpus audio is absent from this mount —
SURVEY.md §2 C16).
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from real_time_audio_sync_tpu.eval.ground_truth import GroundTruth
from real_time_audio_sync_tpu.eval.logs import path_from_field_log
from real_time_audio_sync_tpu.eval.scorer import PathScorer, ScoreResult

DEFAULT_PARAMS = {"search_band_width": 50, "max_run_count": 3}  # tests.py:140
DEFAULT_WTW_PARAMS = {  # tests.py:174
    "fft_len": 4096,
    "hop_size": 2048,
    "dtw_win_size": 4096 * 10,
    "dtw_hop_size": 2048 * 10,
}

ENGINES = ("dtw", "otw", "livenote", "livenote_v2", "livenote_v2_diff", "wtw")

# Extraction memo for corpus sweeps: each recording appears in up to
# |recs|−1 pairs AND in every engine × mode combination of a sweep, and one
# extraction ships the ~30 MB padded wav host→device.  Keyed by (path,
# mtime, kind, dtype);
# LRU oldest-first eviction (a clear-all at capacity would thrash a sweep
# mid-way through reusing its entries back to full re-extraction — ADVICE
# r4 item 3), with the 8-30 MB raw-audio entries capped separately from the
# ~200 KB chroma entries so worst-case residency stays bounded.
_FEAT_CACHE: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_FEAT_CACHE_MAX = 64
_FEAT_CACHE_AUDIO_MAX = 12  # raw-audio entries only (~30 MB each worst case)


def _cache_insert(key: tuple, value: np.ndarray) -> None:
    kind = key[2]
    if kind == "audio":
        audio_keys = [k for k in _FEAT_CACHE if k[2] == "audio"]
        for k in audio_keys[: max(0, len(audio_keys) + 1 - _FEAT_CACHE_AUDIO_MAX)]:
            del _FEAT_CACHE[k]
    while len(_FEAT_CACHE) >= _FEAT_CACHE_MAX:
        _FEAT_CACHE.popitem(last=False)  # oldest-first
    _FEAT_CACHE[key] = value


def _cached(kind: str, path: str, dtype) -> np.ndarray:
    from real_time_audio_sync_tpu.features.chroma import (
        wav_to_chroma,
        wav_to_chroma_diff,
    )
    from real_time_audio_sync_tpu.utils.wavio import load_wav

    key = (os.path.abspath(path), os.path.getmtime(path), kind,
           np.dtype(dtype).name)
    if key in _FEAT_CACHE:
        _FEAT_CACHE.move_to_end(key)  # refresh recency
        return _FEAT_CACHE[key]
    if kind == "audio":
        wav, fs = load_wav(path)
        assert fs == 22050
        value = np.asarray(wav)
    elif kind == "chroma":
        value = wav_to_chroma(path, dtype=dtype)
    else:
        value = wav_to_chroma_diff(path, dtype=dtype)
    _cache_insert(key, value)
    return value


@dataclasses.dataclass
class PairResult:
    ref_wav: str
    live_wav: str
    engine: str
    path: np.ndarray
    score: ScoreResult


def _streaming_path(engine, live_seq) -> List[Tuple[int, int]]:
    """Frame-by-frame streaming (the reference harness regime,
    tests.py:160-163), through the pipelined surface when the engine has
    one: synchronous ``insert`` costs a device round-trip PER FRAME
    (thousands of frames × pairs for the full-scale corpus), while
    ``insert_nowait`` + lazy stop commits the
    identical path (post-stop inserts are frozen no-ops in-program,
    tested engine-wide)."""
    nowait = getattr(engine, "insert_nowait", None)
    if nowait is not None and hasattr(engine, "flush"):
        for i in range(live_seq.shape[1]):
            if nowait(live_seq[:, i]) == "stop":
                break
        engine.flush()
    else:
        for i in range(live_seq.shape[1]):
            if engine.insert(live_seq[:, i]) == "stop":
                break
    return engine.path


def align_pair(
    ref_wav: str,
    live_wav: str,
    engine: str = "livenote_v2_diff",
    params: Optional[dict] = None,
    dtype=np.float32,
    mode: str = "insert",
    interpret: bool = False,
) -> PairResult:
    """Align one recording pair with the chosen engine and score it.

    ``mode``: "insert" streams frame-by-frame (the reference harness regime,
    tests.py:160-163); "fused" runs the whole alignment through the band
    kernel's set_live in one launch (ops/pallas_otw.py — the fast path for
    large corpus sweeps; set_live's direction-first loop can commit slightly
    different best points than streaming insert, exactly as in the reference
    where test_simple.py scores both regimes).  The kernel compiles for the
    GPU; ``interpret=True`` runs it in the Pallas interpreter.

    For ``engine="wtw"`` both "insert" and "fused" run the device-resident
    :class:`AsyncWTW` stepper (bit-equal paths to the host engine, ~5x the
    corpus sweep throughput); ``mode="oracle"`` opts into the host-side
    reference-shaped WTW loop (models/wtw.py) — the parity oracle."""
    from real_time_audio_sync_tpu.models import (
        LiveNote,
        LiveNoteV2,
        OnlineTimeWarping,
        WTW,
    )

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if mode not in ("insert", "fused", "oracle"):
        raise ValueError(f"unknown mode {mode!r}; choose 'insert', 'fused' or 'oracle'")
    if mode == "oracle" and engine != "wtw":
        raise ValueError("mode='oracle' selects the host-side WTW parity loop; "
                         f"{engine!r} has no separate oracle mode (use 'insert')")
    if mode == "fused":
        from real_time_audio_sync_tpu.models.online_core import ENGINE_OVERRIDES

        if engine not in ENGINE_OVERRIDES and engine != "wtw":
            raise ValueError(f"mode='fused' applies to the online engines and wtw; {engine!r} has no fused backend")
        if np.dtype(dtype) != np.float32:
            raise ValueError("mode='fused' runs the float32 device backends; use dtype=float32 "
                             "(the insert mode supports float64)")

    if engine == "wtw":
        pw = params or DEFAULT_WTW_PARAMS
        if mode == "oracle":
            # host-side reference-shaped loop (models/wtw.py) — the parity
            # oracle; ~5x slower than the device-resident stepper for no
            # accuracy benefit (paths are bit-equal, tested)
            wtw = WTW(ref_wav, pw, dtype=dtype)
        else:
            # device-resident stepper: pointers, window DP and commits all
            # on-device, async dispatch per 8-column block (models/wtw_async)
            from real_time_audio_sync_tpu.models import AsyncWTW

            wtw = AsyncWTW(ref_wav, pw, k_block=8, dtype=dtype)
        live = _cached("audio", live_wav, np.float64)
        for buf in np.array_split(live, 4096):  # tests.py:186
            if wtw.insert(buf) == "stop":
                break
        if mode != "oracle":
            wtw.flush()
        path = wtw.path
    else:
        kind = "chroma_diff" if engine == "livenote_v2_diff" else "chroma"
        ref_seq = _cached(kind, ref_wav, dtype)
        live_seq = _cached(kind, live_wav, dtype)
        p = params or DEFAULT_PARAMS
        if engine == "dtw":
            # fetch ONLY the backtracked path: the scorer never reads the
            # dense cost/acc matrices (~100 MB per full-length pair)
            import jax
            import jax.numpy as jnp

            from real_time_audio_sync_tpu.models.dtw import (
                _DENSE_BYTES_PER_CELL,
                _dense_limit_bytes,
                dtw_auto,
                dtw_device,
            )

            m, n = live_seq.shape[1], ref_seq.shape[1]
            if m * n * _DENSE_BYTES_PER_CELL > _dense_limit_bytes():
                # hour-scale pairs: same auto-delegation as the public DTW()
                # surface — banded engine with widen-and-retry exactness
                path, _, _ = dtw_auto(np.asarray(live_seq, dtype),
                                      np.asarray(ref_seq, dtype))
            else:
                _, _, points, length = dtw_device(
                    jnp.asarray(np.asarray(live_seq, dtype)),
                    jnp.asarray(np.asarray(ref_seq, dtype)))
                pts, ln = jax.device_get((points, length))
                path = np.asarray(pts)[: int(ln)][::-1]
        elif mode == "fused":
            from real_time_audio_sync_tpu.models.online_core import ENGINE_OVERRIDES
            from real_time_audio_sync_tpu.ops.pallas_otw import pallas_set_live

            path, _, _, _ = pallas_set_live(ref_seq, live_seq, p, interpret=interpret,
                                            **ENGINE_OVERRIDES[engine])
        elif engine == "otw":
            path = _streaming_path(OnlineTimeWarping(ref_seq, p, dtype=dtype), live_seq)
        elif engine == "livenote":
            path = _streaming_path(LiveNote(ref_seq, p, dtype=dtype), live_seq)
        elif engine == "livenote_v2":
            path = _streaming_path(LiveNoteV2(ref_seq, p, dtype=dtype), live_seq)
        else:  # livenote_v2_diff: Euclidean cost on chroma-diff (tests.py:156)
            path = _streaming_path(
                LiveNoteV2(ref_seq, p, chroma_diff=True, dtype=dtype), live_seq
            )

    score = PathScorer.for_pair(ref_wav, live_wav).score(path)
    return PairResult(ref_wav, live_wav, engine, np.asarray(path), score)


def corpus_pairs(recordings_dir: str) -> List[Tuple[str, str]]:
    """All i<j recording pairs per piece directory (tests.py:211-227),
    skipping ``_20b`` excerpts."""
    pairs = []
    root = recordings_dir.rstrip("/")
    for d in sorted(os.listdir(root)):
        piece_dir = os.path.join(root, d)
        if not os.path.isdir(piece_dir):
            continue
        recs: List[str] = []
        for f in sorted(os.listdir(piece_dir)):
            stem = f[:-4]
            if f.startswith(d) and stem not in recs and not stem.endswith("_20b"):
                recs.append(stem)
        for i in range(len(recs)):
            for j in range(i + 1, len(recs)):
                pairs.append(
                    (os.path.join(piece_dir, recs[i] + ".wav"), os.path.join(piece_dir, recs[j] + ".wav"))
                )
    return pairs


@dataclasses.dataclass
class CorpusReport:
    results: List[PairResult]
    skipped: List[Tuple[str, str]]  # pairs with missing audio
    field_check: Optional[ScoreResult] = None

    @property
    def mean_error(self) -> float:
        """Mean % of path points >3 s off (tests.py:256-262)."""
        errors = [r.score.pct_off_3s for r in self.results]
        if self.field_check is not None:
            errors.append(self.field_check.pct_off_3s)
        return float(np.mean(errors)) if errors else float("nan")


class CorpusRunner:
    """``test_all`` parity (tests.py:199-262)."""

    def __init__(self, recordings_dir: str, engine: str = "livenote_v2_diff", params: Optional[dict] = None, dtype=np.float32, mode: str = "insert", interpret: bool = False):
        self.recordings_dir = recordings_dir
        self.interpret = interpret  # band kernel in the Pallas interpreter
        self.engine = engine
        self.params = params
        self.dtype = dtype
        self.mode = mode  # "insert" (reference regime) | "fused" (fast sweeps)

    def evaluate(self, field_log: Optional[str] = None, verbose: bool = True) -> CorpusReport:
        results: List[PairResult] = []
        skipped: List[Tuple[str, str]] = []
        present: List[Tuple[str, str]] = []
        for ref_wav, live_wav in corpus_pairs(self.recordings_dir):
            if os.path.exists(ref_wav) and os.path.exists(live_wav):
                present.append((ref_wav, live_wav))
            else:
                skipped.append((ref_wav, live_wav))

        from real_time_audio_sync_tpu.models.online_core import ENGINE_OVERRIDES

        if self.engine == "wtw" and self.mode == "fused" and len(present) > 1:
            # the whole sweep as ONE multi-stream run: every pair is a
            # stream of the vmapped device-resident stepper, one dispatch
            # per block advances all pairs (parallel/wtw_serving.py)
            results = self._evaluate_wtw_batched(present, verbose)
        elif self.engine in ENGINE_OVERRIDES and self.mode == "fused" and len(present) > 1:
            # online engines: the whole sweep in ONE band-kernel launch, one
            # program per pair with O(c) state (pallas_batched_set_live);
            # per-pair paths equal solo pallas_set_live (tested)
            results = self._evaluate_online_batched(present, verbose)
        else:
            for ref_wav, live_wav in present:
                result = align_pair(ref_wav, live_wav, self.engine, self.params, self.dtype,
                                    mode=self.mode, interpret=self.interpret)
                results.append(result)
                if verbose:
                    self._print_result(result)

        # recorded-field-path cross-check (tests.py:245-251)
        field_check = None
        if field_log and os.path.exists(field_log):
            bso_ref = os.path.join(self.recordings_dir, "bso", "bso_01.wav")
            bso_live = os.path.join(self.recordings_dir, "bso", "bso_02.wav")
            if os.path.exists(bso_ref[:-4] + ".csv") and os.path.exists(bso_live[:-4] + ".csv"):
                scorer = PathScorer(
                    GroundTruth.from_csv(bso_ref[:-4] + ".csv"),
                    GroundTruth.from_csv(bso_live[:-4] + ".csv"),
                )
                field_check = scorer.score(path_from_field_log(field_log))
                if verbose:
                    print(f"field-log cross-check: >3s={field_check.pct_off_3s:.2f}%")

        report = CorpusReport(results, skipped, field_check)
        if verbose:
            if skipped:
                print(f"skipped {len(skipped)} pairs with missing audio")
            print(f"mean error (% points >3 s off): {report.mean_error:.3f}")
        return report

    def _print_result(self, result: PairResult) -> None:
        s = result.score
        print(
            f"{os.path.basename(result.ref_wav)} vs {os.path.basename(result.live_wav)} "
            f"[{self.engine}]: >1b={s.pct_off_beats[1]:.2f}% "
            f">3b={s.pct_off_beats[3]:.2f}% >3s={s.pct_off_3s:.2f}%"
        )

    def _evaluate_online_batched(self, pairs: List[Tuple[str, str]], verbose: bool) -> List[PairResult]:
        """All pairs through :func:`pallas_batched_set_live` at once (one
        launch, one program per pair); identical per-pair paths to the solo
        kernel (tests/test_synthetic_corpus.py)."""
        from real_time_audio_sync_tpu.models.online_core import ENGINE_OVERRIDES
        from real_time_audio_sync_tpu.ops.pallas_otw import pallas_batched_set_live

        if np.dtype(self.dtype) != np.float32:
            raise ValueError("mode='fused' runs the float32 device backends")
        kind = "chroma_diff" if self.engine == "livenote_v2_diff" else "chroma"
        refs, lives = [], []
        for ref_wav, live_wav in pairs:
            refs.append(np.asarray(_cached(kind, ref_wav, np.float32)))
            lives.append(np.asarray(_cached(kind, live_wav, np.float32)))
        p = self.params or DEFAULT_PARAMS
        aligned = pallas_batched_set_live(refs, lives, p, interpret=self.interpret,
                                          **ENGINE_OVERRIDES[self.engine])
        results = []
        for (ref_wav, live_wav), (path, _, _, _) in zip(pairs, aligned):
            score = PathScorer.for_pair(ref_wav, live_wav).score([tuple(pt) for pt in path])
            result = PairResult(ref_wav, live_wav, self.engine, np.asarray(path), score)
            results.append(result)
            if verbose:
                self._print_result(result)
        return results

    def _evaluate_wtw_batched(self, pairs: List[Tuple[str, str]], verbose: bool) -> List[PairResult]:
        """All pairs through one multi-stream WTW service, each stream fed
        the harness chunking (``np.array_split(live, 4096)``, tests.py:186),
        through the vmapped XLA stepper (MultiStreamWTW).  Per-stream
        committed paths equal solo AsyncWTW runs up to batch-shape
        accumulation order (PARITY.md deviation 8)."""
        from real_time_audio_sync_tpu.parallel.wtw_serving import MultiStreamWTW

        if np.dtype(self.dtype) != np.float32:
            raise ValueError("mode='fused' runs the float32 device backends")
        p = self.params or DEFAULT_WTW_PARAMS
        ms = MultiStreamWTW([r for r, _ in pairs], p, k_block=8)
        iters = []
        for _, live_wav in pairs:
            live = _cached("audio", live_wav, np.float64)
            iters.append(iter(np.array_split(live, 4096)))
        done = [False] * len(pairs)
        while not all(done):
            bufs: List[Optional[np.ndarray]] = []
            for i, it in enumerate(iters):
                try:
                    bufs.append(next(it))
                except StopIteration:
                    done[i] = True
                    bufs.append(None)
            ms.insert(bufs)
        ms.flush()
        paths = ms.paths()
        results = []
        for i, (ref_wav, live_wav) in enumerate(pairs):
            score = PathScorer.for_pair(ref_wav, live_wav).score(paths[i])
            result = PairResult(ref_wav, live_wav, self.engine, np.asarray(paths[i]), score)
            results.append(result)
            if verbose:
                self._print_result(result)
        return results


def run_simple(ref_wav: str, live_wav: str, engines: Sequence[str] = ENGINES, dtype=np.float32, verbose: bool = True) -> Dict[str, PairResult]:
    """The test_simple.py:94-198 smoke driver: run every engine on one pair
    and report bucket accuracies (incl. the insert-vs-set_live property for
    the online engines, exercised in the test suite)."""
    out = {}
    for engine in engines:
        result = align_pair(ref_wav, live_wav, engine, dtype=dtype)
        out[engine] = result
        if verbose:
            s = result.score
            print(
                f"{engine:>16}: >1b={s.pct_off_beats[1]:6.2f}%  >3b={s.pct_off_beats[3]:5.2f}%  "
                f">5b={s.pct_off_beats[5]:5.2f}%  >10b={s.pct_off_beats[10]:5.2f}%  "
                f"sq_err={s.squared_beat_error:10.1f}  n={s.count}"
            )
    return out

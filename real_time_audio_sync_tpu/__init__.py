"""real_time_audio_sync_tpu — a JAX (XLA + Pallas) streaming
audio-alignment framework with the full capabilities of
smritip/real-time-audio-sync.

Layer map (mirrors SURVEY.md §1):

- ``features``  — chroma feature frontend: batched STFT (DFT as matmul),
  chroma filterbank derived in-repo (no librosa runtime dep),
  L2-normalized 12-bin chroma and rectified chroma-diff variants.
  [reference: chroma.py]
- ``ops``       — core DP kernels: anti-diagonal wavefront DTW (lax.scan),
  banded min-plus row/column updates for online time warping, and the band
  kernel (Pallas through Triton) that runs every online engine on the GPU.
  [reference: dtw.py, otw_eran.py inner loops]
- ``models``    — the alignment engine zoo with the reference API surface:
  DTW, OnlineTimeWarping, LiveNote, LiveNoteV2, WTW.
  [reference: dtw.py, otw_eran.py, livenote.py, livenote_v2.py, wtw.py]
- ``streaming`` — host-side real-time runtime: frame sources (wav chunker,
  simulated mic), ring-buffer hop framing, ScoreFollower, audio writer,
  live app shell. [reference: ims/, livenote_live.py, wtw_live.py]
- ``eval``      — ground-truth beat scorer, corpus runner, field-log
  record/replay. [reference: tests.py, test_simple.py, wtw.py:259-359]
- ``parallel``  — multi-chip corpus alignment: vmapped engines sharded over a
  jax.sharding.Mesh (data parallel over song pairs; sequence-sharded feature
  extraction). [reference has no distributed execution — see SURVEY.md §2]
- ``utils``     — wav IO (librosa.load-parity), profiling, checkpointing.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache: where JAX_COMPILATION_CACHE_DIR is set, JAX
# reads it itself and nothing is set here; otherwise executables are kept in
# a fixed .jax_cache/ at the root of the checkout (listed in .gitignore), so
# a second process on the same checkout reuses them.  Runs pinned to the CPU
# (JAX_PLATFORMS=cpu, the test suite) cache nothing: CPU executables carry
# the compiling host's machine features.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR") and "cpu" not in _os.environ.get("JAX_PLATFORMS", ""):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from real_time_audio_sync_tpu.features.chroma import (  # noqa: F401
    wav_to_chroma,
    wav_to_chroma_col,
    wav_to_chroma_diff,
)

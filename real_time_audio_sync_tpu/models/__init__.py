from real_time_audio_sync_tpu.models.dtw import DTW, dtw_auto  # noqa: F401
from real_time_audio_sync_tpu.models.livenote import LiveNote  # noqa: F401
from real_time_audio_sync_tpu.models.livenote_v2 import LiveNoteV2  # noqa: F401
from real_time_audio_sync_tpu.models.otw import OnlineTimeWarping  # noqa: F401
from real_time_audio_sync_tpu.models.wtw import WTW  # noqa: F401

# FusedStreamingEngine/AsyncWTW import ops.pallas_otw / ops.* at module
# scope, and those kernels import models.online_core — importing an ops
# module FIRST would re-enter this package mid-initialization and hit the
# partially-initialized kernel module.  PEP 562 lazy exports break the
# cycle: the engines resolve on first attribute access, by which point
# every module involved is fully initialized.
_LAZY = {
    "FusedStreamingEngine": "real_time_audio_sync_tpu.models.fused_streaming",
    "AsyncWTW": "real_time_audio_sync_tpu.models.wtw_async",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))

from real_time_audio_sync_tpu.parallel.corpus import (  # noqa: F401
    batched_set_live,
    corpus_mesh,
    pad_pairs,
    sharded_chroma_frames,
)
from real_time_audio_sync_tpu.parallel.serving import (  # noqa: F401
    FusedMultiStreamFollower,
    MultiStreamFollower,
)
from real_time_audio_sync_tpu.parallel.wtw_serving import (  # noqa: F401
    MultiStreamWTW,
)

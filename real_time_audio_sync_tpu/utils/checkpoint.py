"""Engine state checkpoint/resume.

The reference has no checkpointing (SURVEY.md §5.4); its closest analogs are
the keypress path-log dump and wav capture.  Here, the online engines' state
is a flat pytree of fixed-shape arrays (models/online_core.OnlineState), so
a checkpoint is a single ``.npz`` — save mid-performance, restore in a new
process (or on another chip) and keep following from the same frame.
"""

from __future__ import annotations

import numpy as np

from real_time_audio_sync_tpu.models.online_core import BandedOnlineEngine, OnlineState


def _reset_polling(engine) -> None:
    """No in-flight work survives a restore (stale pre-restore status
    vectors must not be consumed against the restored state), but a tuned
    ``poll_min_interval`` is an engine setting, not stream state — keep it
    (mirrors set_live's reset, models/online_core.py)."""
    interval = engine.poll_min_interval
    engine._init_status_polling()
    engine.poll_min_interval = interval


def _check_params(data, *fields) -> None:
    """Engine-parameter compatibility: every validated SHAPE is independent
    of the search band / slope constraint, so a c or max_run_count mismatch
    would otherwise restore silently and misalign (the rationale
    load_multi_stream_state / load_async_wtw_state already apply).  Fields
    absent from older snapshots are skipped."""
    for name, want in fields:
        if name in data.files and int(data[name]) != int(want):
            raise ValueError(
                f"checkpoint {name} {int(data[name])} != engine {name} {int(want)}")


def save_state(engine: BandedOnlineEngine, path: str) -> None:
    """Snapshot a streaming engine's full state to ``path`` (.npz).
    ``np.asarray`` blocks on each device array, so every dispatched
    (including in-flight pipelined) insert is captured."""
    state = engine.state
    arrays = {f: np.asarray(getattr(state, f)) for f in OnlineState._fields}
    np.savez_compressed(
        path, ref=np.asarray(engine.ref),
        batch_mode=np.int32(engine._batch_mode),
        c=np.int32(engine.cfg.c),
        max_run_count=np.int32(engine.cfg.max_run_count), **arrays,
    )


def load_state(engine: BandedOnlineEngine, path: str) -> None:
    """Restore a snapshot into a compatibly-constructed engine (same
    reference sequence, params and dtype)."""
    import jax.numpy as jnp

    data = np.load(path)
    ref = data["ref"]
    if ref.shape != engine.ref.shape or not np.array_equal(ref, np.asarray(engine.ref)):
        raise ValueError("checkpoint was taken against a different reference sequence")
    _check_params(data, ("c", engine.cfg.c), ("max_run_count", engine.cfg.max_run_count))
    fields = {}
    for f in OnlineState._fields:
        arr = data[f]
        cur = getattr(engine.state, f)
        if arr.shape != cur.shape:
            raise ValueError(f"checkpoint field {f!r} has shape {arr.shape}, engine expects {cur.shape}")
        fields[f] = jnp.asarray(arr, cur.dtype)
    engine.state = OnlineState(**fields)
    # the sticky stop flag is part of OnlineState and rides the snapshot
    _reset_polling(engine)
    engine._stopped_cached = bool(np.asarray(data["stopped"]))
    # .path's return type follows the mode the snapshot was taken in
    # (set_live -> array, streaming -> list of tuples; otw.py's surface)
    engine._batch_mode = (
        bool(int(data["batch_mode"])) if "batch_mode" in data.files else False
    )


_FUSED_FIELDS = ("hist", "vec", "scalars", "path")


def save_fused_state(engine, path: str) -> None:
    """Snapshot a FusedStreamingEngine (live ring, band vectors, scalars,
    committed path — models/fused_streaming.py) to ``path`` (.npz).
    Flushes first: feed()'s coalesce queue may hold undispatched columns,
    which a snapshot of the device state alone would silently lose."""
    engine.flush()
    arrays = dict(zip(_FUSED_FIELDS, (np.asarray(x) for x in engine._state)))
    np.savez_compressed(
        path, ref_t=np.asarray(engine.ref_t),
        stopped=np.int32(engine._stopped_cached),
        c=np.int32(engine.cfg.c),
        max_run_count=np.int32(engine.cfg.max_run_count),
        k_block=np.int32(engine.k_block), **arrays,
    )


def _check_fused_fields(data, state) -> None:
    for name, cur in zip(_FUSED_FIELDS, state):
        if name not in data.files:
            raise ValueError(f"checkpoint has no {name!r} field (not a band-kernel snapshot)")
        if data[name].shape != cur.shape:
            raise ValueError(
                f"checkpoint field {name!r} has shape {data[name].shape}, engine expects {cur.shape}")


def load_fused_state(engine, path: str) -> None:
    """Restore a snapshot into a compatibly-constructed fused engine."""
    import jax
    import jax.numpy as jnp

    data = np.load(path)
    if data["ref_t"].shape != engine.ref_t.shape or not np.array_equal(
        data["ref_t"], np.asarray(engine.ref_t)
    ):
        raise ValueError("checkpoint was taken against a different reference sequence")
    _check_params(data, ("c", engine.cfg.c),
                  ("max_run_count", engine.cfg.max_run_count),
                  ("k_block", engine.k_block))
    _check_fused_fields(data, engine._state)
    engine._state = jax.device_put(tuple(jnp.asarray(data[n]) for n in _FUSED_FIELDS))
    _reset_polling(engine)
    engine._pending.clear()  # queued feed() columns predate the restore
    engine._stopped_cached = bool(int(data["stopped"]))


def save_multi_stream_state(fms, path: str) -> None:
    """Snapshot a :class:`~real_time_audio_sync_tpu.parallel.serving.
    FusedMultiStreamFollower` — all ``B`` streams' live rings, band vectors,
    committed paths and scalar state in one ``.npz``.  Flushes first
    (dispatches queued columns, waits for in-flight launches) so the
    snapshot is a consistent frontier across every stream."""
    fms.flush()
    arrays = dict(zip(_FUSED_FIELDS, (np.asarray(x) for x in fms._state)))
    np.savez_compressed(
        path,
        ref_t=np.asarray(fms._ref_dev),
        stopped=fms._stopped.astype(np.int32),
        last_points=np.asarray(fms._last_points, np.int64),
        k_block=np.int32(fms.k_block),
        c=np.int32(fms.cfg.c),
        max_run_count=np.int32(fms.cfg.max_run_count), **arrays,
    )


def load_multi_stream_state(fms, path: str) -> None:
    """Restore a snapshot into a compatibly-constructed follower (same
    references, params, k_block and stream count; any mesh layout — the
    stream axis is re-sharded to the target's mesh on load)."""
    import jax
    import jax.numpy as jnp

    from real_time_audio_sync_tpu.parallel.serving import batch_axis_sharding_put

    data = np.load(path)
    if data["ref_t"].shape != fms._ref_dev.shape or not np.array_equal(
        data["ref_t"], np.asarray(fms._ref_dev)
    ):
        raise ValueError("checkpoint was taken against different reference sequences")
    for field, want in (("k_block", fms.k_block), ("c", fms.cfg.c),
                        ("max_run_count", fms.cfg.max_run_count)):
        if int(data[field]) != want:
            raise ValueError(
                f"checkpoint {field} {int(data[field])} != engine {field} {want}")
    _check_fused_fields(data, fms._state)
    put = batch_axis_sharding_put(fms.mesh) if fms.mesh is not None else jax.device_put
    fms._state = tuple(put(jnp.asarray(data[n])) for n in _FUSED_FIELDS)
    fms._stopped = data["stopped"].astype(bool)
    fms._last_points = data["last_points"].astype(np.int64)
    # no queued columns or in-flight work survives a restore
    fms._reset_pending()
    fms._outstanding = []
    fms._latest_done = None
    fms._harvest_future = None
    fms._last_poll_time = 0.0


def save_multi_wtw_state(ms, path: str) -> None:
    """Snapshot a :class:`~real_time_audio_sync_tpu.parallel.wtw_serving.
    MultiStreamWTW` — device-resident live chromagrams, paths and scalar
    state plus every stream's host sample FIFO.  Flushes first so the
    snapshot is a consistent frontier."""
    ms.flush()
    px, py, sc = (np.asarray(x) for x in ms._state)
    bufs = [b.to_array().astype(np.float64) for b in ms.bufs]
    np.savez_compressed(
        path,
        ref_dev=np.asarray(ms._ref_dev), live_dev=np.asarray(ms._live_dev),
        path_x=px, path_y=py, scalars=sc,
        buf_cat=(np.concatenate(bufs) if bufs else np.zeros(0)),
        buf_lens=np.asarray([len(b) for b in bufs], np.int64),
        stopped=ms._stopped.astype(np.int32),
        dtype=np.str_(ms.dtype.name),
        k_block=np.int32(ms.k_block),
        transfer_dtype=np.str_(ms.transfer_dtype),
        dtw_win_size=np.int32(ms.params.dtw_win_size),
        dtw_hop_size=np.int32(ms.params.dtw_hop_size),
    )


def load_multi_wtw_state(ms, path: str) -> None:
    """Restore a snapshot into a compatibly-constructed MultiStreamWTW
    (same references, params, k_block, dtype and transfer encoding)."""
    import jax
    import jax.numpy as jnp

    from real_time_audio_sync_tpu.models.wtw import SampleFIFO
    from real_time_audio_sync_tpu.parallel.serving import batch_axis_sharding_put

    data = np.load(path)
    if data["ref_dev"].shape != ms._ref_dev.shape or not np.array_equal(
        data["ref_dev"], np.asarray(ms._ref_dev)
    ):
        raise ValueError("checkpoint was taken against different reference recordings")
    if str(data["dtype"]) != ms.dtype.name:
        raise ValueError(f"checkpoint dtype {data['dtype']} != engine dtype {ms.dtype.name}")
    if str(data["transfer_dtype"]) != ms.transfer_dtype:
        raise ValueError(
            f"checkpoint transfer_dtype {data['transfer_dtype']} != engine {ms.transfer_dtype}")
    for field in ("k_block", "dtw_win_size", "dtw_hop_size"):
        want = ms.k_block if field == "k_block" else getattr(ms.params, field)
        if int(data[field]) != want:
            raise ValueError(
                f"checkpoint {field} {int(data[field])} != engine {field} {want}")
    names = ("live_dev", "path_x", "path_y", "scalars")
    for name, cur in zip(names, (ms._live_dev, *ms._state)):
        if data[name].shape != cur.shape:
            raise ValueError(
                f"checkpoint field {name!r} has shape {data[name].shape}, engine expects {cur.shape}")
    put = batch_axis_sharding_put(ms.mesh) if ms.mesh is not None else jax.device_put
    ms._live_dev = put(jnp.asarray(data["live_dev"]))
    ms._state = tuple(put(jnp.asarray(data[n])) for n in names[1:])
    splits = np.cumsum(data["buf_lens"])[:-1]
    ms.bufs = [SampleFIFO.from_array(a, ms.dtype)
               for a in np.split(data["buf_cat"], splits)]
    ms._stopped = data["stopped"].astype(bool)
    ms._outstanding = []
    ms._latest_done = None
    ms._harvest_future = None
    ms._last_poll_time = 0.0


def save_wtw_state(wtw, path: str) -> None:
    """Snapshot a WTW engine mid-stream (host-side state; models/wtw.py)."""
    acc = wtw.acc_cost if wtw.acc_cost is not None else np.empty((0, 0), wtw.dtype)
    np.savez_compressed(
        path,
        chroma_ref=wtw.chroma_ref,
        chroma_live=wtw.chroma_live,
        acc_cost=acc,
        buf=wtw.buf.to_array().astype(np.float64),
        path=np.asarray(wtw.path, np.int64).reshape(-1, 2),
        ptrs=np.asarray([wtw.chroma_ptr, wtw.live_ptr, wtw.ref_ptr], np.int64),
    )


def load_wtw_state(wtw, path: str) -> None:
    from real_time_audio_sync_tpu.models.wtw import SampleFIFO

    data = np.load(path)
    if data["chroma_ref"].shape != wtw.chroma_ref.shape or not np.array_equal(
        data["chroma_ref"], wtw.chroma_ref
    ):
        raise ValueError("checkpoint was taken against a different reference recording")
    wtw.chroma_live = data["chroma_live"]
    acc = data["acc_cost"]
    wtw.acc_cost = acc if acc.size else None
    wtw.keep_acc_canvas = bool(acc.size)
    wtw.buf = SampleFIFO.from_array(data["buf"], wtw.dtype)
    wtw.path = [tuple(p) for p in data["path"]]
    wtw.chroma_ptr, wtw.live_ptr, wtw.ref_ptr = (int(x) for x in data["ptrs"])


def save_async_wtw_state(engine, path: str) -> None:
    """Snapshot an AsyncWTW engine (models/wtw_async.py): device-resident
    live chromagram, path buffers and scalar state, plus the host sample
    FIFO.  Waits for in-flight dispatches (flush) so the snapshot is a
    consistent frontier."""
    engine.flush()
    px, py, sc = (np.asarray(x) for x in engine._state)
    np.savez_compressed(
        path,
        chroma_ref=engine.chroma_ref,
        live_dev=np.asarray(engine._live_dev),
        path_x=px, path_y=py, scalars=sc,
        buf=engine.buf.to_array().astype(np.float64),
        stopped=np.int32(engine._stopped_cached),
        dtype=np.str_(engine.dtype.name),
        k_block=np.int32(engine.k_block),
        dtw_win_size=np.int32(engine.params.dtw_win_size),
        dtw_hop_size=np.int32(engine.params.dtw_hop_size),
    )


def load_async_wtw_state(engine, path: str) -> None:
    """Restore a snapshot into a compatibly-constructed AsyncWTW engine
    (same reference recording, params, k_block and dtype)."""
    import jax
    import jax.numpy as jnp

    from real_time_audio_sync_tpu.models.wtw import SampleFIFO

    data = np.load(path)
    if data["chroma_ref"].shape != engine.chroma_ref.shape or not np.array_equal(
        data["chroma_ref"], engine.chroma_ref
    ):
        raise ValueError("checkpoint was taken against a different reference recording")
    # shapes alone don't catch these: a dtype mismatch would silently mix
    # precisions in the next step, a k_block mismatch would change the
    # dispatch batching the snapshot's FIFO remainder assumes
    if str(data["dtype"]) != engine.dtype.name:
        raise ValueError(
            f"checkpoint dtype {data['dtype']} != engine dtype {engine.dtype.name}")
    if int(data["k_block"]) != engine.k_block:
        raise ValueError(
            f"checkpoint k_block {int(data['k_block'])} != engine k_block {engine.k_block}")
    # window geometry: two engines on the same reference with different
    # window params can share every array shape (p_cap collision), in which
    # case a mismatched snapshot would restore silently and the scalar
    # pointers would be reinterpreted under the wrong window geometry
    for field in ("dtw_win_size", "dtw_hop_size"):
        if field in data and int(data[field]) != getattr(engine.params, field):
            raise ValueError(
                f"checkpoint {field} {int(data[field])} != engine "
                f"{field} {getattr(engine.params, field)}")
    for name, cur in (("live_dev", engine._live_dev), ("path_x", engine._state[0]),
                      ("path_y", engine._state[1]), ("scalars", engine._state[2])):
        if data[name].shape != cur.shape:
            raise ValueError(
                f"checkpoint field {name!r} has shape {data[name].shape}, engine expects {cur.shape}")
    engine._live_dev = jax.device_put(jnp.asarray(data["live_dev"]))
    engine._state = tuple(
        jax.device_put(jnp.asarray(data[n])) for n in ("path_x", "path_y", "scalars")
    )
    engine.buf = SampleFIFO.from_array(data["buf"], engine.dtype)
    _reset_polling(engine)
    engine._stopped_cached = bool(int(data["stopped"]))

"""Multi-device corpus alignment.

The reference is strictly single-process (SURVEY.md §2 disclosure); the
natural device scaling axes for this workload are:

- **data parallelism over song pairs** — alignment of different pairs is
  embarrassingly parallel; pairs are padded to a common shape, vmapped, and
  sharded over a 1-D ``data`` mesh axis.  The per-frame DP recurrence is
  strictly sequential in time and stays chip-local by design — no per-frame
  cross-chip communication exists (SURVEY.md §5.8).
- **sequence parallelism in the feature frontend** — STFT frames are
  independent, so the frames axis shards across chips; XLA inserts the
  gather when a replicated chromagram is requested.

Collectives appear only in metric reductions (a mean over the sharded batch
→ one all-reduce across devices).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from real_time_audio_sync_tpu.models.online_core import (
    OnlineConfig,
    OnlineState,
    init_state,
    set_live_scan_body,
)


def corpus_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """A 1-D device mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def pad_pairs(
    refs: Sequence[np.ndarray],
    lives: Sequence[np.ndarray],
    pad_multiple: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad (F, Nᵢ)/(F, Tᵢ) feature sequences to common shapes.

    Returns ``(refs (B,F,N), lives (B,F,T), ref_lens (B,), live_lens (B,))``.
    True lengths feed the engines' traced stop conditions, so padding never
    changes alignment results.
    """
    def _round(x):
        return -(-x // pad_multiple) * pad_multiple

    f = refs[0].shape[0]
    n = _round(max(r.shape[1] for r in refs))
    t = _round(max(l.shape[1] for l in lives))
    b = len(refs)
    refs_out = np.zeros((b, f, n), refs[0].dtype)
    lives_out = np.zeros((b, f, t), lives[0].dtype)
    for i, (r, l) in enumerate(zip(refs, lives)):
        refs_out[i, :, : r.shape[1]] = r
        lives_out[i, :, : l.shape[1]] = l
    return (
        refs_out,
        lives_out,
        np.asarray([r.shape[1] for r in refs], np.int32),
        np.asarray([l.shape[1] for l in lives], np.int32),
    )


def _init_batched_state(b: int, f: int, n: int, cfg: OnlineConfig, dtype) -> OnlineState:
    """A batch of fresh engine states (leading axis on every pytree leaf)."""
    one = init_state(jnp.zeros((f, n), dtype), cfg, dtype)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), one)


@partial(jax.jit, static_argnames=("cfg",))
def _batched_set_live_impl(states, lives, refs, live_lens, ref_lens, cfg: OnlineConfig):
    run = jax.vmap(
        lambda st, live, ref, ll, rl: set_live_scan_body(st, live, ref, cfg, ll, rl)
    )
    out = run(states, lives, refs, live_lens, ref_lens)
    # one scalar metric reduced across the sharded batch (the all-reduce):
    # mean committed-path length per pair
    mean_path_len = jnp.mean(out.path_len.astype(jnp.float32))
    return out, mean_path_len


def batched_set_live(
    refs: np.ndarray,
    lives: np.ndarray,
    ref_lens: np.ndarray,
    live_lens: np.ndarray,
    params,
    mesh: Optional[Mesh] = None,
    dtype=np.float32,
    sentinel: float = 1e10,
    run_count_init: int = 1,
    monotone_path: bool = False,
    euclidean: bool = False,
    backend: str = "banded",
    interpret: bool = False,
) -> Tuple[List[np.ndarray], jnp.ndarray]:
    """Align a batch of pairs with the online engine, optionally sharded over
    a ``data`` mesh.  Returns (list of per-pair paths, mean path length).

    ``backend="banded"`` (default): the band kernel (ops/pallas_otw.py), one
    program per pair with O(c) state — memory is flat in sequence length,
    so hour-long pairs and large B fit one device (SURVEY.md §7 hard part
    5).  float32 only; it compiles for the GPU, or runs in the Pallas
    interpreter with ``interpret=True``.  ``backend="dense"``: the vmapped
    XLA scan carrying the reference-shaped dense (2N, N) acc per pair — the
    debug artifact whose ``acc_cost`` heatmaps notebooks use, and the
    float64 parity path; O(B·N²) memory caps it at small scale.  Committed
    paths are identical (tested).
    """
    from real_time_audio_sync_tpu.config import OTWParams

    p = OTWParams.from_any(params)
    cfg = OnlineConfig(
        c=p.c,
        max_run_count=p.max_run_count,
        sentinel=sentinel,
        run_count_init=run_count_init,
        monotone_path=monotone_path,
        euclidean=euclidean,
    )
    if backend not in ("banded", "dense"):
        raise ValueError(f"unknown backend {backend!r}; choose 'banded' or 'dense'")
    if backend == "banded" and np.dtype(dtype) == np.float32:
        return _banded_batched_set_live(refs, lives, ref_lens, live_lens, cfg, mesh, interpret)
    # float64 has no kernel path: the dense scan is the declared parity and
    # debug regime for f64
    b, f, n = refs.shape
    states = _init_batched_state(b, f, n, cfg, dtype)

    refs = jnp.asarray(refs, dtype)
    lives = jnp.asarray(lives, dtype)
    ref_lens = jnp.asarray(ref_lens, jnp.int32)
    live_lens = jnp.asarray(live_lens, jnp.int32)

    if mesh is not None:
        shard = NamedSharding(mesh, P("data"))
        dev = lambda x: jax.device_put(x, NamedSharding(mesh, P(*(("data",) + (None,) * (x.ndim - 1)))))
        states = jax.tree.map(dev, states)
        refs, lives = dev(refs), dev(lives)
        ref_lens, live_lens = jax.device_put(ref_lens, shard), jax.device_put(live_lens, shard)

    out, mean_path_len = _batched_set_live_impl(states, lives, refs, live_lens, ref_lens, cfg)
    paths = []
    path_host = np.asarray(out.path)
    len_host = np.asarray(out.path_len)
    for i in range(b):
        paths.append(path_host[i, : len_host[i]])
    return paths, mean_path_len


def _banded_batched_set_live(refs, lives, ref_lens, live_lens, cfg, mesh, interpret):
    """Banded backend of :func:`batched_set_live`: one kernel launch per
    shard, one program per pair.  On a mesh the pair axis is sharded via
    shard_map (zero collectives in the alignment; the mean-path-length
    metric is the one cross-device all-reduce, SURVEY.md §5.8)."""
    from real_time_audio_sync_tpu.ops import require_kernel_platform
    from real_time_audio_sync_tpu.ops.pallas_otw import (
        S_PLEN,
        band_insert_block,
        batched_set_live_arrays,
    )

    require_kernel_platform(interpret)
    refs = np.asarray(refs, np.float32)
    lives = np.asarray(lives, np.float32)
    b = refs.shape[0]
    lens, ref_arr, cols, state = batched_set_live_arrays(
        [refs[i, :, : int(ref_lens[i])] for i in range(b)],
        [lives[i, :, : int(live_lens[i])] for i in range(b)], cfg)

    def run(lens, ref_arr, cols, *state):
        return band_insert_block(lens, ref_arr, cols, *state, cfg=cfg, interpret=interpret)

    if mesh is None:
        _, _, sc, path, _ = run(lens, ref_arr, cols, *state)
        mean_path_len = jnp.mean(sc[:, S_PLEN].astype(jnp.float32))
    else:
        from real_time_audio_sync_tpu.parallel.serving import (
            batch_axis_sharding_put,
            require_batch_divisible,
        )

        require_batch_divisible(mesh, b)
        batched = P(tuple(mesh.axis_names))
        shared = ref_arr.shape[0] == 1
        ref_spec = P(None, None, None) if shared else batched
        inner = jax.jit(jax.shard_map(
            run, mesh=mesh,
            in_specs=(batched, ref_spec, batched) + (batched,) * len(state),
            out_specs=(batched,) * (len(state) + 1), check_vma=False,
        ))
        put = batch_axis_sharding_put(mesh)
        ref_dev = (jax.device_put(ref_arr, NamedSharding(mesh, P(None, None, None)))
                   if shared else put(ref_arr))
        _, _, sc, path, _ = inner(put(lens), ref_dev, put(cols), *map(put, state))
        # the one cross-device collective: mean committed-path length
        mean_path_len = jax.jit(
            lambda s: jnp.mean(s[:, S_PLEN].astype(jnp.float32)),
            out_shardings=NamedSharding(mesh, P()),
        )(sc)

    sc, path = jax.device_get((sc, path))
    paths = [np.stack([path[i, 0, : sc[i, S_PLEN]], path[i, 1, : sc[i, S_PLEN]]], axis=1)
             for i in range(b)]
    return paths, mean_path_len


def sharded_chroma_frames(frames: np.ndarray, mesh: Mesh, dtype=np.float32) -> jnp.ndarray:
    """Feature frontend with the frames (time) axis sharded across the mesh —
    the sequence-parallel analog of the reference's per-hop loop.  Output is
    the replicated (12, T) chromagram (XLA inserts the all-gather)."""
    from real_time_audio_sync_tpu.features.chroma import _chroma_frames_impl, frontend_constants

    consts = frontend_constants(dtype=dtype)
    frames = jax.device_put(
        jnp.asarray(frames, dtype), NamedSharding(mesh, P("data", None))
    )
    fn = jax.jit(
        partial(_chroma_frames_impl, normalize=True),
        out_shardings=NamedSharding(mesh, P(None, None)),
    )
    return fn(frames, *consts)

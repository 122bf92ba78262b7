from real_time_audio_sync_tpu.ops.wavefront import (  # noqa: F401
    DTW_SPEC,
    WTW_SPEC,
    StepSpec,
    backtrack,
    wavefront_dp,
)


def require_kernel_platform(interpret: bool) -> None:
    """The one gate for the repo's hand-written kernels.

    They compile for an NVIDIA GPU (Pallas through Triton), or run in the
    Pallas interpreter when the caller asks for it with ``interpret=True``
    (the CPU tests).  Anything else raises: no path falls back to another
    engine or to the interpreter on its own."""
    if interpret:
        return
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"the band kernel compiles for an NVIDIA GPU; the default device "
            f"is {platform!r}. Pass interpret=True to run it in the Pallas "
            f"interpreter, or use the XLA engines")

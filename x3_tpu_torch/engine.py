"""Engine names and batch sizes for the port's file paths (x3_tpu.engine).

The port has one engine, "torch": the batched PyTorch pipeline on a
`device` (the CUDA kernels on "cuda", their plain versions on "cpu").
"auto" names it too.  With one engine there is nothing to probe or route,
so there is no probe and no probe cache, and the port does not read
X3_ENGINE: the values x3_tpu takes there ("jax", "native", "numpy") name
engines the port does not have.
"""

from __future__ import annotations

from .models.encoder import DEFAULT_BATCH_FRAMES as ENCODE_BATCH_FRAMES

ENGINES = ("torch",)

# Frames per device call on the file paths: encode takes the encoder's
# batch; decode the fastest of 768, 2,048 and 6,144 frames in the
# seek-walking x3a_to_wav (now resync=True's) on an H100 whose peak RSS
# growth stays under half the WAV's size (PERF.md): 768 and 2,048 ran level
# or 768 ahead, and 768 grows the peak RSS by less than half as much.  The
# chunked x3a_to_wav decodes a chunk's frames in slices of at most this
# many.
DECODE_BATCH_FRAMES = 768


def resolve_engine(engine: str = "auto", decode: bool | None = None) -> str:
    """The engine `engine` names: "auto" and "torch" give "torch"; any
    other name raises ValueError.  decode (the conversion direction, which
    x3_tpu's routing weighs) is accepted and ignored: there is one engine
    either way."""
    if engine in ("auto", *ENGINES):
        return "torch"
    raise ValueError(f"unknown engine {engine!r} (want auto|{'|'.join(ENGINES)})")


def resolve_batch_frames(batch_frames: int | None, engine: str, decode: bool) -> int:
    """`batch_frames`, or for None the engine's default for the direction."""
    resolve_engine(engine)
    if batch_frames is not None:
        return batch_frames
    return DECODE_BATCH_FRAMES if decode else ENCODE_BATCH_FRAMES

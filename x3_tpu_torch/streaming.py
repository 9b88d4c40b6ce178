"""Streaming encode with bounded memory (x3_tpu.streaming).

StreamEncoder buffers up to `batch_frames` whole frames, encodes them in
one call of the port's `encode` on `device`, and appends the frame stream
to the output, so memory stays bounded by the batch size whatever the
input's length.  Only the final flush may emit a partial frame, which is
the reference's framing.  The payload-width and block-width rungs a batch
ends at start the next batch's ladders.  encode_channels encodes a
multi-channel capture through multifile.encode_streams."""

from __future__ import annotations

import wave

import numpy as np

from . import archive
from .device import resolve_device
from .engine import resolve_batch_frames, resolve_engine
from .errors import MoreThanOneChannel, X3Error
from .models.encoder import EncodeResult, encode
from .params import Parameters
from .utils.io import AsyncWriter, open_overwrite


def check_mono16(w: wave.Wave_read) -> None:
    """Raise unless the open WAV is 16-bit mono, as the reference does."""
    if w.getsampwidth() != 2:
        raise X3Error(f"only 16-bit WAV supported, got {8 * w.getsampwidth()}-bit")
    if w.getnchannels() != 1:
        raise MoreThanOneChannel(f"only mono WAV supported, got {w.getnchannels()} channels")


class StreamEncoder:
    """Incremental encoder: feed chunks of int16 samples, frames stream out.

        enc = StreamEncoder(out_file, sample_rate=96000)
        for chunk in source:
            enc.write(chunk)
        stats = enc.close()

    batch_frames None takes the engine's encode batch."""

    def __init__(
        self,
        out_file,
        sample_rate: int,
        params: Parameters | None = None,
        engine: str = "auto",
        batch_frames: int | None = None,
        write_archive_header: bool = True,
        *,
        device="cuda",
    ):
        self.params = params or Parameters()
        self.engine = resolve_engine(engine)
        self.batch_frames = resolve_batch_frames(batch_frames, self.engine, decode=False)
        self.device = resolve_device(device)
        self._spf = self.params.samples_per_frame
        self._buffer = np.zeros(0, dtype=np.int16)
        self._stats = np.zeros(6, dtype=np.int64)
        self._nbytes = 0
        self._closed = False
        self._own_file = isinstance(out_file, (str, bytes)) or hasattr(out_file, "__fspath__")
        # An owned file is written by a bounded background thread, so the
        # next batch's encode overlaps the write; a caller's file object is
        # written synchronously.
        if self._own_file:
            self._f = open_overwrite(out_file)  # truncated to size in close()
            self._w = AsyncWriter(self._f)
        else:
            self._f = self._w = out_file
        self._width_hint: int | None = None
        self._block_width_hint: int | None = None
        if write_archive_header:
            self._w.write(archive.build_archive_header(sample_rate, self.params))

    def write(self, samples) -> None:
        if self._closed:
            raise ValueError("StreamEncoder is closed")
        samples = np.ascontiguousarray(samples, dtype=np.int16)
        self._buffer = np.concatenate([self._buffer, samples]) if len(self._buffer) else samples
        batch_samples = self.batch_frames * self._spf
        while len(self._buffer) >= batch_samples:
            head, self._buffer = self._buffer[:batch_samples], self._buffer[batch_samples:]
            self._emit(head)

    def _emit(self, samples: np.ndarray) -> None:
        res = encode(
            samples,
            self.params,
            batch_frames=self.batch_frames,
            width_hint=self._width_hint,
            block_width_hint=self._block_width_hint,
            device=self.device,
        )
        self._width_hint = res.width_used
        self._block_width_hint = res.block_width_used
        self._stats += res.stats
        self._nbytes += len(res.data)
        self._w.write(res.data)

    def close(self) -> EncodeResult:
        """Flush the tail (which may hold one partial frame) and return the
        statistics."""
        if self._closed:
            return EncodeResult(b"", self._stats, nbytes=self._nbytes)
        if len(self._buffer):
            self._emit(self._buffer)
            self._buffer = np.zeros(0, dtype=np.int16)
        self._closed = True
        if self._own_file:
            self._w.close()  # drain; raises any background write error
            self._f.truncate()  # cut any stale tail of a longer earlier file
            self._f.close()
        return EncodeResult(b"", self._stats, nbytes=self._nbytes)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def wav_to_x3a_streaming(
    wav_filename,
    x3a_filename,
    params: Parameters | None = None,
    engine: str = "auto",
    batch_frames: int | None = None,
    *,
    device="cuda",
) -> np.ndarray:
    """Convert a mono 16-bit WAV to an .x3a archive, reading it in
    batch-sized chunks; returns the statistics.  The same bytes, and the
    same errors on another WAV format, as files.wav_to_x3a."""
    params = params or Parameters()
    with wave.open(str(wav_filename), "rb") as w:
        check_mono16(w)
        rate = w.getframerate()
        with StreamEncoder(x3a_filename, rate, params, engine, batch_frames, device=device) as enc:
            chunk_samples = enc.batch_frames * params.samples_per_frame
            while True:
                raw = w.readframes(chunk_samples)
                if not raw:
                    break
                enc.write(np.frombuffer(raw, dtype="<i2"))
            return enc.close().stats


def encode_channels(samples_2d, params: Parameters | None = None, mesh=None, *, device="cuda"):
    """Encode a [C, n] multi-channel capture into C independent frame
    streams, all channels' frames sharing device batches.  Returns a list
    of EncodeResult (one per channel)."""
    from .multifile import encode_streams

    samples_2d = np.atleast_2d(np.asarray(samples_2d, dtype=np.int16))
    return encode_streams(list(samples_2d), params, mesh=mesh, device=device)

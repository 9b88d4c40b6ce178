"""16-bit WAV read and write on the host (x3_tpu.utils.wav): mono reads
and writes through the standard library's `wave` module with bulk numpy
frame reads, and an incremental writer of one or more interleaved
channels whose sample stream goes through a bounded background thread."""

from __future__ import annotations

import struct
import wave

import numpy as np

from ..errors import MoreThanOneChannel, X3Error
from .io import AsyncWriter, open_overwrite


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a WAV file; returns (int16 samples, sample_rate).  Anything but
    16-bit mono raises, as in the reference."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise X3Error(f"only 16-bit WAV supported, got {8 * w.getsampwidth()}-bit")
        if w.getnchannels() != 1:
            raise MoreThanOneChannel(f"only mono WAV supported, got {w.getnchannels()} channels")
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.int16), rate


def write_wav(path, samples: np.ndarray, sample_rate: int) -> None:
    """Write int16 mono samples as a WAV file."""
    samples = np.ascontiguousarray(samples, dtype="<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(samples.tobytes())


class WavWriter:
    """Incremental 16-bit WAV writer of `channels` interleaved channels:
    samples are appended batch by batch, so decode memory stays bounded by
    the batch size.

    The output is byte-identical to the `wave` module's (the standard
    44-byte PCM header, its sizes patched on close).  The samples go
    through a writer thread of its own or, with `writer` (an AsyncWriter
    of no file), through one shared by many WavWriters: close() then
    queues the header's patch and the file's closing on that thread and
    returns, and the writer's owner closes it, which waits for them and
    raises any write error."""

    def __init__(self, path, sample_rate: int, channels: int = 1, writer: AsyncWriter | None = None):
        self._f = open_overwrite(path)
        self._rate = int(sample_rate)
        self._channels = int(channels)
        self._f.write(self._header(0))  # sizes patched on close
        self._shared = writer is not None
        self._aw = writer if self._shared else AsyncWriter(self._f)
        self.samples_written = 0
        self._closed = False

    def _header(self, n_samples: int) -> bytes:
        c = self._channels
        data_bytes = 2 * c * n_samples
        return struct.pack(
            "<4sI4s4sIHHIIHH4sI",
            b"RIFF", 36 + data_bytes, b"WAVE",
            b"fmt ", 16, 1, c, self._rate, self._rate * 2 * c, 2 * c, 16,
            b"data", data_bytes,
        )

    def write(self, samples: np.ndarray) -> None:
        """Append samples: int16 [n], or [n, channels] rows of interleaved
        samples.  The array itself is queued (buffer protocol), not a bytes
        copy: callers hand over arrays they do not modify afterwards."""
        samples = np.ascontiguousarray(samples, dtype="<i2")
        self._aw.write((self._f, samples) if self._shared else samples)
        self.samples_written += len(samples)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._shared:
            self._aw.call(self._finish)
            return
        try:
            self._aw.close()  # drain; raises any background write error
        except BaseException:
            self._f.close()
            raise
        self._finish()

    def _finish(self) -> None:
        try:
            self._f.seek(0)
            self._f.write(self._header(self.samples_written))
            # open_overwrite does not truncate: cut any stale tail of a
            # longer earlier file now that the final size is known.
            self._f.truncate(44 + 2 * self._channels * self.samples_written)
        finally:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

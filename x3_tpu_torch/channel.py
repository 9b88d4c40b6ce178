"""Channel types (x3_tpu.channel): the reference's array-level inputs to
its encoder, over the port's pipeline on `device`.  `Channel.encode()`
encodes a materialized stream in one call; `IterChannel.encode_to()` pulls
from any sample iterable with bounded memory through StreamEncoder."""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np

from .params import Parameters


@dataclasses.dataclass
class Channel:
    """A materialized mono channel."""

    id: int
    wav: np.ndarray  # int16 samples
    sample_rate: int
    params: Parameters = dataclasses.field(default_factory=Parameters)

    def encode(self, engine: str = "auto", *, device="cuda"):
        from .engine import resolve_engine
        from .models.encoder import encode

        resolve_engine(engine)
        return encode(np.asarray(self.wav, dtype=np.int16), self.params, source_id=1, device=device)


@dataclasses.dataclass
class IterChannel:
    """A lazy mono channel over any sample iterable."""

    id: int
    wav: Iterable
    sample_rate: int
    params: Parameters = dataclasses.field(default_factory=Parameters)

    def encode_to(self, out_file, engine: str = "auto", batch_frames: int | None = None,
                  write_archive_header: bool = False, *, device="cuda"):
        """Stream-encode the iterable into out_file with bounded memory;
        returns the statistics array."""
        from .streaming import StreamEncoder

        it: Iterator = iter(self.wav)
        chunk_len = self.params.samples_per_frame
        with StreamEncoder(
            out_file, self.sample_rate, self.params, engine, batch_frames,
            write_archive_header=write_archive_header, device=device,
        ) as enc:
            buf = []
            for s in it:
                buf.append(s)
                if len(buf) >= chunk_len:
                    enc.write(np.asarray(buf, dtype=np.int16))
                    buf.clear()
            if buf:
                enc.write(np.asarray(buf, dtype=np.int16))
            return enc.close().stats


def encode(channels, writer, engine: str = "auto", *, device="cuda"):
    """Encode one channel's frame stream into the file-like `writer` (the
    reference's encoder::encode); more than one channel raises."""
    from .errors import MoreThanOneChannel

    if len(channels) > 1:
        raise MoreThanOneChannel(f"{len(channels)} channels")
    ch = channels[0]
    if isinstance(ch, Channel):
        res = ch.encode(engine=engine, device=device)
        writer.write(res.data)
        return res.stats
    return ch.encode_to(writer, engine=engine, device=device)

"""Archive container (x3_tpu.archive): the frame header writer and reader,
the archive header build and parse, and the frame walk with its optional
sync-word rescue, which skips a corrupt frame instead of stopping; over
bytes in memory and over an open file (headers read with seeks, so memory
stays bounded on any archive size); the in-memory frame index
(index_frames), the walker's errors at the bytes where it stops
(check_tail), and the index of a whole archive file in sequential reads
(index_frames_file): a FrameIndex, which walk_frames' entries also make
(FrameIndex.of_walk)."""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from . import constants
from .errors import (
    ArchiveHeaderXMLInvalidKey,
    FrameDecodeUnexpectedEnd,
    FrameHeaderInvalidHeaderCRC,
    FrameHeaderInvalidKey,
    FrameHeaderInvalidPayloadLen,
    FrameLength,
    MoreThanOneChannel,
)
from .ops.crc import crc16, crc16_many, crc16_pairs
from .params import Parameters, X3aSpec
from .utils.xmlmeta import build_xml, parse_xml


def write_frame_header(num_samples: int, source_id: int, payload_len: int, payload_crc: int) -> bytes:
    """The 20-byte big-endian frame header.  As in the reference, the
    channels byte receives the source id too."""
    header = bytearray(constants.FRAME_HEADER_LENGTH)
    header[0:2] = constants.FRAME_KEY.to_bytes(2, "big")
    header[constants.P_SOURCE_ID] = source_id
    header[constants.P_CHANNELS] = source_id
    header[constants.P_SAMPLES : constants.P_SAMPLES + 2] = (num_samples & 0xFFFF).to_bytes(2, "big")
    header[constants.P_PAYLOAD_SIZE : constants.P_PAYLOAD_SIZE + 2] = (payload_len & 0xFFFF).to_bytes(2, "big")
    header_crc = crc16(header[: constants.P_HEADER_CRC])  # the time field stays zero
    header[constants.P_HEADER_CRC : constants.P_HEADER_CRC + 2] = header_crc.to_bytes(2, "big")
    header[constants.P_PAYLOAD_CRC : constants.P_PAYLOAD_CRC + 2] = (payload_crc & 0xFFFF).to_bytes(2, "big")
    return bytes(header)


@dataclasses.dataclass
class FrameHeader:
    source_id: int
    channels: int
    samples: int
    payload_len: int
    payload_crc: int


def read_frame_header(data: bytes, validate: bool = True) -> FrameHeader:
    """Parse and validate a 20-byte frame header."""
    if len(data) < constants.FRAME_HEADER_LENGTH:
        raise FrameDecodeUnexpectedEnd(f"{len(data)} bytes < header length")
    if validate and crc16(data[0:16]) != int.from_bytes(data[16:18], "big"):
        raise FrameHeaderInvalidHeaderCRC("frame header CRC mismatch")
    if data[0:2] != constants.FRAME_KEY_BYTES:
        raise FrameHeaderInvalidKey(f"bad frame key {data[0:2]!r}")
    channels = data[constants.P_CHANNELS]
    if channels > 1:
        raise MoreThanOneChannel(f"{channels} channels")
    payload_len = int.from_bytes(data[6:8], "big")
    if payload_len >= constants.FRAME_MAX_LENGTH:
        raise FrameLength(f"payload {payload_len} >= {constants.FRAME_MAX_LENGTH}")
    return FrameHeader(
        source_id=data[constants.P_SOURCE_ID],
        channels=channels,
        samples=int.from_bytes(data[4:6], "big"),
        payload_len=payload_len,
        payload_crc=int.from_bytes(data[18:20], "big"),
    )


def build_archive_header(sample_rate: int, params: Parameters) -> bytes:
    """'X3ARCHIV' magic, a pseudo frame header (samples 0, id 0) and the XML
    metadata padded to an even length."""
    xml = build_xml(sample_rate, params)
    payload = xml + (b"\x00" if len(xml) % 2 else b"")
    header = write_frame_header(0, 0, len(payload), crc16(payload))
    return constants.ARCHIVE_ID + header + payload


def parse_archive_header(data: bytes) -> tuple[X3aSpec, int]:
    """Parse the archive header; returns (spec, header size in bytes)."""
    if data[: constants.ARCHIVE_ID_LEN] != constants.ARCHIVE_ID:
        raise ArchiveHeaderXMLInvalidKey(f"bad magic {data[:8]!r}")
    pos = constants.ARCHIVE_ID_LEN
    header = read_frame_header(data[pos : pos + constants.FRAME_HEADER_LENGTH])
    pos += constants.FRAME_HEADER_LENGTH
    sample_rate, params = parse_xml(data[pos : pos + header.payload_len])
    spec = X3aSpec(sample_rate=sample_rate, params=params, channels=header.channels)
    return spec, pos + header.payload_len


def walk_frames(data: bytes, start: int, resync: bool = False):
    """Index frames in order: yields (payload_offset, FrameHeader).

    Stops when at most a header's worth of bytes remain.  Without resync, a
    header error propagates and a payload that runs past the data raises
    FrameHeaderInvalidPayloadLen; with resync, either starts a scan for the
    next plausible frame instead."""
    pos = start
    n = len(data)
    while n - pos > constants.FRAME_HEADER_LENGTH:
        try:
            header = read_frame_header(data[pos : pos + constants.FRAME_HEADER_LENGTH])
        except Exception:
            if not resync:
                raise
            pos = find_sync(data, pos + 1)
            if pos < 0:
                return
            continue
        payload_off = pos + constants.FRAME_HEADER_LENGTH
        if n - payload_off < header.payload_len:
            if not resync:
                raise FrameHeaderInvalidPayloadLen(
                    f"frame at {pos}: payload {header.payload_len} B overruns "
                    f"the remaining {n - payload_off} B"
                )
            pos = find_sync(data, pos + 1)
            if pos < 0:
                return
            continue
        yield payload_off, header
        pos = payload_off + header.payload_len


# key, channels byte, sample count, payload length (the source id skipped)
_HEADER_FIELDS = struct.Struct(">2sxBHH")


def index_frames(blob, start: int = 0, max_frames: int | None = None):
    """The frames of an in-memory frame stream from byte `start`, in order
    (x3_tpu.native.index_frames): three numpy arrays, payload offsets
    int64, sample counts int32 and payload lengths int32.

    No error is raised: the index ends, as x3_index_frames does, at the
    first header with at most a header's worth of bytes left, a key other
    than "x3", a bad header CRC, a channels byte above 1, a payload length
    of FRAME_MAX_LENGTH or more, or a payload that runs past the blob, or
    after max_frames frames.  The offset chain is followed in Python over
    the length fields; then every header's CRC is checked at once
    (ops.crc.crc16_pairs) and the index cut at the first mismatch.

    blob: bytes, bytearray or a contiguous uint8 array."""
    arr = np.frombuffer(blob, dtype=np.uint8)
    n, hl = len(arr), constants.FRAME_HEADER_LENGTH
    unpack = _HEADER_FIELDS.unpack_from
    heads = []
    pos = start
    while n - pos > hl and (max_frames is None or len(heads) < max_frames):
        key, channels, _, plen = unpack(arr, pos)
        if (key != constants.FRAME_KEY_BYTES or channels > 1 or plen >= constants.FRAME_MAX_LENGTH
                or n - pos - hl < plen):
            break
        heads.append(pos)
        pos += hl + plen
    at = np.asarray(heads, dtype=np.int64)
    rows = arr[at[:, None] + np.arange(hl)].astype(np.int64)  # [N, 20]
    stored = (rows[:, constants.P_HEADER_CRC] << 8) | rows[:, constants.P_HEADER_CRC + 1]
    bad = crc16_pairs(rows[:, : constants.P_HEADER_CRC]) != stored
    k = int(np.argmax(bad)) if bad.any() else len(at)
    rows = rows[:k]
    samples = (rows[:, constants.P_SAMPLES] << 8) | rows[:, constants.P_SAMPLES + 1]
    plens = (rows[:, constants.P_PAYLOAD_SIZE] << 8) | rows[:, constants.P_PAYLOAD_SIZE + 1]
    return at[:k] + hl, samples.astype(np.int32), plens.astype(np.int32)


# The most bytes a frame spans: a header and the longest payload.
MAX_FRAME_BYTES = constants.FRAME_HEADER_LENGTH + constants.FRAME_MAX_LENGTH


def check_tail(tail, end: int, eof: bool) -> None:
    """Raise walk_frames' error, if it has one, for `tail`: the bytes from
    the header at which index_frames stopped up to file offset `end`.

    At the end of the stream (eof), at most a header's worth of bytes ends
    the walk silently; more raises what the walker raises there: the
    header's class (read_frame_header: header CRC, key, MoreThanOneChannel,
    FrameLength) or, for a valid header, FrameHeaderInvalidPayloadLen with
    the walker's message.  Before the end, a tail longer than any frame
    (20 + FRAME_MAX_LENGTH bytes) can only start at a bad header, whose
    class is raised; a shorter one may be a frame that the next read
    completes, and nothing is raised."""
    hl = constants.FRAME_HEADER_LENGTH
    if len(tail) <= (hl if eof else MAX_FRAME_BYTES):
        return
    header = read_frame_header(bytes(tail[:hl]))
    if not eof:  # pragma: no cover - a valid header's frame fits the tail
        raise FrameHeaderInvalidPayloadLen(f"frame at {end - len(tail)}: unindexable valid header")
    raise FrameHeaderInvalidPayloadLen(
        f"frame at {end - len(tail)}: payload {header.payload_len} B overruns "
        f"the remaining {len(tail) - hl} B"
    )


# Sequential read size of index_frames_file (x3_tpu's _NATIVE_CHUNK_BYTES
# was 4 MB; files._CHUNK_BYTES, the chunk of x3a_to_wav, is this size).
CHUNK_BYTES = 8 << 20


@dataclasses.dataclass
class FrameIndex:
    """The frames of an archive, in order, as numpy arrays: payload offsets
    int64 (in the archive), sample counts int32, payload lengths int32 and
    stored payload CRC16s int64; about 18 bytes a frame."""

    offsets: np.ndarray
    n_samples: np.ndarray
    payload_lens: np.ndarray
    crcs: np.ndarray

    def __len__(self) -> int:
        return len(self.offsets)

    def __getitem__(self, cut: slice) -> "FrameIndex":
        return FrameIndex(self.offsets[cut], self.n_samples[cut], self.payload_lens[cut], self.crcs[cut])

    @classmethod
    def of_walk(cls, entries) -> "FrameIndex":
        """The index of walk_frames' (payload_offset, FrameHeader) entries."""
        cols = zip(*((off, h.samples, h.payload_len, h.payload_crc) for off, h in entries))
        return cls(*(np.fromiter(c, t) for c, t in zip(cols, (np.int64, np.int32, np.int32, np.int64))))

    @classmethod
    def concat(cls, parts) -> "FrameIndex":
        parts = list(parts)
        return cls(*(np.concatenate([getattr(p, k) for p in parts]) if parts else np.zeros(0, t)
                     for k, t in (("offsets", np.int64), ("n_samples", np.int32),
                                  ("payload_lens", np.int32), ("crcs", np.int64))))


def index_blob(blob, start: int = 0, base: int = 0) -> tuple[FrameIndex, int]:
    """index_frames of an in-memory frame stream with the stored payload
    CRCs: (FrameIndex with offsets plus `base`, the blob offset where the
    index stopped)."""
    arr = np.frombuffer(blob, dtype=np.uint8)
    offs, ns, lens = index_frames(arr, start)
    crcs = (arr[offs - 2].astype(np.int64) << 8) | arr[offs - 1]
    end = int(offs[-1] + lens[-1]) if len(offs) else start
    return FrameIndex(offs + base, ns, lens, crcs), end


def index_frames_in_memory(data, start: int) -> FrameIndex:
    """The frames of an in-memory archive from byte `start`: walk_frames'
    entries without resync, and its errors (check_tail)."""
    index, end = index_blob(data, start)
    check_tail(np.frombuffer(data, dtype=np.uint8)[end:], len(data), eof=True)
    return index


def index_frames_file(f, start: int) -> FrameIndex:
    """The frames of an open archive file from byte `start`, read in
    sequential reads of CHUNK_BYTES into one plain host buffer and indexed
    in memory (index_frames), a frame that straddles two reads carried
    into the next.  Its entries are walk_frames_file's without resync, and
    it raises the walker's class and message at the same frame
    (check_tail); a bad header raises once a frame's worth of bytes past it
    is read, before the rest of the file."""
    f.seek(0, 2)
    n = f.tell()
    front = MAX_FRAME_BYTES  # room for the carry
    buf = np.empty(front + max(1, min(CHUNK_BYTES, n - start)), np.uint8)
    view = memoryview(buf)
    parts, pos, carry = [], start, 0  # pos: the file offset of buf[0]
    f.seek(start)
    while True:
        got = f.readinto(view[carry : carry + len(buf) - front]) if pos + carry < n else 0
        blob = buf[: carry + got]
        eof = not got or pos + len(blob) >= n
        index, end = index_blob(blob, 0, pos)
        parts.append(index)
        check_tail(blob[end:], pos + len(blob), eof)
        if eof:
            return FrameIndex.concat(parts)
        carry = len(blob) - end
        buf[:carry] = blob[end:]  # at most `front` bytes (check_tail)
        pos += end


def find_sync(data: bytes, start: int) -> int:
    """The next byte offset at or after `start` whose bytes look like a
    frame header (the 'x3' key and a valid header CRC), or -1."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    if n - start < constants.FRAME_HEADER_LENGTH:
        return -1
    window = arr[start:]
    cand = np.nonzero((window[:-1] == 0x78) & (window[1:] == 0x33))[0] + start
    cand = cand[cand + constants.FRAME_HEADER_LENGTH <= n]
    if len(cand) == 0:
        return -1
    rows = np.lib.stride_tricks.sliding_window_view(arr, 16)[cand]
    crcs = crc16_many(rows, np.full(len(cand), 16))
    stored = (arr[cand + 16].astype(np.uint16) << 8) | arr[cand + 17]
    ok = np.nonzero(crcs == stored)[0]
    return int(cand[ok[0]]) if len(ok) else -1


def read_archive_header_file(f) -> tuple[X3aSpec, int]:
    """Parse the archive header of an open binary file (bounded reads).
    Returns (spec, header size in bytes)."""
    f.seek(0)
    head = f.read(constants.ARCHIVE_ID_LEN + constants.FRAME_HEADER_LENGTH)
    if head[: constants.ARCHIVE_ID_LEN] != constants.ARCHIVE_ID:
        raise ArchiveHeaderXMLInvalidKey(f"bad magic {head[:8]!r}")
    header = read_frame_header(head[constants.ARCHIVE_ID_LEN :])
    sample_rate, params = parse_xml(f.read(header.payload_len))
    spec = X3aSpec(sample_rate=sample_rate, params=params, channels=header.channels)
    return spec, constants.ARCHIVE_ID_LEN + constants.FRAME_HEADER_LENGTH + header.payload_len


def walk_frames_file(f, start: int, resync: bool = False):
    """walk_frames over an open binary file: yields (payload_offset,
    FrameHeader), reading only the 20-byte headers and seeking past the
    payloads.  The same errors as walk_frames."""
    f.seek(0, 2)
    n = f.tell()
    pos = start
    while n - pos > constants.FRAME_HEADER_LENGTH:
        f.seek(pos)
        try:
            header = read_frame_header(f.read(constants.FRAME_HEADER_LENGTH))
        except Exception:
            if not resync:
                raise
            pos = find_sync_file(f, pos + 1, n)
            if pos < 0:
                return
            continue
        payload_off = pos + constants.FRAME_HEADER_LENGTH
        if n - payload_off < header.payload_len:
            if not resync:
                raise FrameHeaderInvalidPayloadLen(
                    f"frame at {pos}: payload {header.payload_len} B overruns "
                    f"the remaining {n - payload_off} B"
                )
            pos = find_sync_file(f, pos + 1, n)
            if pos < 0:
                return
            continue
        yield payload_off, header
        pos = payload_off + header.payload_len


def find_sync_file(f, start: int, n: int | None = None, chunk: int = 1 << 20) -> int:
    """find_sync over an open file, in windows of `chunk` bytes."""
    if n is None:
        f.seek(0, 2)
        n = f.tell()
    pos = start
    while pos < n:
        f.seek(pos)
        data = f.read(chunk + constants.FRAME_HEADER_LENGTH)
        if len(data) < constants.FRAME_HEADER_LENGTH:
            return -1
        r = find_sync(data, 0)
        if r >= 0:
            return pos + r
        if pos + len(data) >= n:
            return -1
        pos += chunk
    return -1

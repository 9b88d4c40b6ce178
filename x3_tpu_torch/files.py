"""File-level API of the port (x3_tpu.files): wav_to_x3a, x3a_to_wav,
x3a_info, verify_x3a and the random-access X3aReader.

Every conversion runs the port's batched pipeline on `device`: encode
through `encode` (kernels K2 and K1 on "cuda"), decode with the payload
CRCs checked (K3 and K1), with the plain PyTorch versions on "cpu".
Memory is bounded in both directions: encode reads the WAV a batch at a
time; x3a_to_wav reads the archive in sequential chunks on a read-ahead
thread, indexes each chunk's frames in memory and decodes them from the
chunk (_x3a_to_wav_stream), and appends to the WAV.  X3aReader indexes the
archive in sequential reads (archive.index_frames_file); verify_x3a and
x3a_to_wav with resync walk the frame headers with seeks and the sync
scanner.  These three decode a batch of frames from runs of the archive's
bytes, one read a run into one host buffer (_decode_index).

As in the reference, header and payload CRC mismatches raise, and a frame
that fails to decode is counted and stops the decode.  With resync=True
corrupt frames are skipped by the sync scanner instead.  Archives, WAVs,
reports and error classes are those of x3_tpu.files.
"""

from __future__ import annotations

import itertools
import wave

import numpy as np
import torch

from . import archive, constants
from .device import resolve_device
from .engine import resolve_batch_frames, resolve_engine
from .errors import FrameDecodeUnexpectedEnd, FrameHeaderInvalidPayloadCRC, X3Error, decode_error
from .models.decoder import decode_frames_indexed
from .models.encoder import EncodeResult
from .models.staging import BufferPool, host_empty
from .params import Parameters, X3aSpec
from .streaming import StreamEncoder, check_mono16
from .utils.io import prefetch_iter
from .utils.wav import WavWriter


def wav_to_x3a(
    wav_filename,
    x3a_filename,
    params: Parameters | None = None,
    engine: str = "auto",
    verbose: bool = False,
    batch_frames: int | None = None,
    *,
    device="cuda",
) -> EncodeResult:
    """Convert a mono 16-bit .wav file to an .x3a archive.  The WAV is read
    and encoded in batch_frames-frame chunks."""
    engine = resolve_engine(engine)
    batch_frames = resolve_batch_frames(batch_frames, engine, decode=False)
    device = resolve_device(device)
    params = params or Parameters()
    with wave.open(str(wav_filename), "rb") as w:
        check_mono16(w)
        rate = w.getframerate()
        with StreamEncoder(x3a_filename, rate, params, engine, batch_frames, device=device) as enc:
            chunk_samples = batch_frames * params.samples_per_frame

            def _chunks():
                while True:
                    raw = w.readframes(chunk_samples)
                    if not raw:
                        return
                    yield raw

            # The next chunk's read overlaps this chunk's encode; the
            # output side overlaps through StreamEncoder's AsyncWriter.
            for raw in prefetch_iter(_chunks(), depth=1):
                enc.write(np.frombuffer(raw, dtype="<i2"))
            result = enc.close()
    if verbose:
        print(result.format_stats())
    return result


def _decode_index(f, index: archive.FrameIndex, params: Parameters, device, base: int | None = None):
    """Decode the frames of `index` (at least one) from the open archive
    `f` on `device`, their payload CRCs checked.

    The frames are cut into runs whose bytes follow one another (a frame's
    header starts where the previous payload ends), and each run, from its
    first payload to its last payload's end, is read with one seek and one
    readinto into one host buffer (pinned for a CUDA device); bytes that the
    sync scanner skipped are not read.  One decode_frames_indexed call.

    Returns (samples: the frames' samples back to back, bounds int64 [F + 1]
    (frame i is samples[bounds[i]:bounds[i + 1]]), errs int array of
    per-frame decode codes).  `base` is the number of the first frame: a
    payload-CRC mismatch then raises, naming the frame; with base None (the
    resync decodes) it marks the frame with code 4."""
    offs = index.offsets
    ends = offs + index.payload_lens
    cuts = np.r_[0, np.flatnonzero(offs[1:] - constants.FRAME_HEADER_LENGTH != ends[:-1]) + 1, len(offs)]
    lo, size = offs[cuts[:-1]], ends[cuts[1:] - 1] - offs[cuts[:-1]]  # each run in the archive
    at = np.cumsum(size) - size  # and in the buffer
    buf = host_empty(int(size.sum()), torch.uint8, device)
    view = memoryview(buf.numpy())
    for src, dst, n in zip(lo.tolist(), at.tolist(), size.tolist()):
        f.seek(src)
        if f.readinto(view[dst : dst + n]) != n:
            raise FrameDecodeUnexpectedEnd(f"archive ended inside a frame indexed at {src}")
    local = offs + np.repeat(at - lo, np.diff(cuts))
    samples, errs, crc_ok = decode_frames_indexed(buf, local, index.n_samples, index.payload_lens, params,
                                                  check_crcs=index.crcs, device=device)
    if not crc_ok.all():
        if base is not None:
            raise FrameHeaderInvalidPayloadCRC(f"frame {base + int(np.argmin(crc_ok))} payload CRC mismatch")
        errs = np.where(crc_ok, errs, 4)
    return samples, np.concatenate([[0], np.cumsum(index.n_samples, dtype=np.int64)]), errs


def _batches(walker, batch_frames: int):
    """The walker's (payload_offset, FrameHeader) entries as FrameIndexes
    of up to batch_frames frames."""
    while batch := list(itertools.islice(walker, batch_frames)):
        yield archive.FrameIndex.of_walk(batch)


# Sequential read size of x3a_to_wav's chunked decode (x3_tpu's
# _NATIVE_CHUNK_BYTES, 4 MB): a chunk's frames are indexed and decoded
# together, in slices of at most batch_frames frames.  chip_smoke.py's
# phase 7 sweeps 4, 8 and 16 MB on an H100: 8 and 16 MB decode level with
# each other and up to 1.6x faster than 4 MB on music, whose 4 MB chunks
# hold about 270 frames (a K3 launch costs about 1.1 ms whatever the
# lanes); 8 MB grows the peak RSS about half as much as 16 MB.
_CHUNK_BYTES = archive.CHUNK_BYTES
_CHUNK_FRONT = archive.MAX_FRAME_BYTES  # room for the carry


def _x3a_to_wav_stream(f, wout, start: int, params: Parameters, batch_frames: int, device) -> int:
    """The chunked decode of x3a_to_wav without resync (x3_tpu's
    _x3a_to_wav_native_stream): sequential reads of _CHUNK_BYTES on a
    read-ahead thread, an in-memory frame index of each chunk with the
    header CRCs checked (archive.index_frames), and each chunk's frames
    decoded from the chunk's bytes with their payload CRCs checked
    (decode_frames_indexed), a slice of at most batch_frames frames a
    device call.  A frame that straddles two chunks is carried into the
    next.  Returns the frame errors (0, or 1 at the first frame that fails
    to decode, as the reference stops there).

    The walker's errors: archive.check_tail raises them at the bytes the
    index stops at (the header's class, or FrameHeaderInvalidPayloadLen
    with the walker's message for a payload that runs past the end); at
    most a header's worth of trailing bytes ends the decode silently.

    Each chunk is read into the back of one of three host buffers (pinned
    for a CUDA device), whose front holds the carry, so the payload bytes
    are copied once on the host; a buffer goes back to the reader once the
    chunk's last device call has returned, whose read-back waited on an
    event behind the chunk's uploads."""
    f.seek(0, 2)
    n = f.tell()
    front = _CHUNK_FRONT
    size = front + max(1, min(_CHUNK_BYTES, n - start))
    pool = BufferPool(host_empty(size, torch.uint8, device) for _ in range(3))

    def _reads():
        # Only this generator touches `f` once the loop below starts.
        f.seek(start)
        p = start
        while p < n:
            buf = pool.acquire()
            got = f.readinto(memoryview(buf.numpy())[front:])
            if not got:
                pool.release(buf)
                return
            p += got
            yield buf, got

    reads = prefetch_iter(_reads(), depth=1)
    pos = start
    carry = np.zeros(0, np.uint8)
    base = 0  # global frame number of the blob's first frame
    try:
        while True:
            item = next(reads, None)
            if item is None:
                buf, eof, blob_t = None, True, torch.from_numpy(carry)
            else:
                buf, got = item
                pos += got
                eof = pos >= n
                blob_t = buf[front - len(carry) : front + got]
                blob_t.numpy()[: len(carry)] = carry
            blob = blob_t.numpy()
            if not len(blob):
                return 0
            index, end = archive.index_blob(blob)
            offs, ns, lens, want = index.offsets, index.n_samples, index.payload_lens, index.crcs
            for s in range(0, len(offs), batch_frames):
                cut = slice(s, s + batch_frames)
                samples, errs, crc_ok = decode_frames_indexed(blob_t, offs[cut], ns[cut], lens[cut], params,
                                                              check_crcs=want[cut], device=device)
                if not crc_ok.all():
                    bad = int(np.argmin(crc_ok))
                    raise FrameHeaderInvalidPayloadCRC(f"frame {base + s + bad} payload CRC mismatch")
                if errs.any():
                    i = int(np.argmax(errs != 0))
                    wout.write(samples[: int(ns[s : s + i].sum())])
                    print(f"Frame error: frame {base + s + i} failed to decode")
                    return 1
                wout.write(samples)
            base += len(offs)
            carry = blob[end:].copy()
            if buf is not None:
                pool.release(buf)
            # The walker's error where the index stopped, if any; otherwise
            # the carry fits the next buffer's front.
            archive.check_tail(carry, pos, eof)
            if eof:
                return 0
    finally:
        pool.close()  # wakes a reader waiting for a buffer
        reads.close()


def x3a_to_wav(
    x3a_filename,
    wav_filename,
    engine: str = "auto",
    verbose: bool = False,
    resync: bool = False,
    batch_frames: int | None = None,
    *,
    device="cuda",
) -> int:
    """Convert an .x3a archive to a .wav file; returns the number of frame
    errors.  Without resync the archive is read in sequential chunks and
    each chunk's frames decoded from it (_x3a_to_wav_stream); with resync
    the frames are walked with header-only seeks and the sync scanner.
    Either way they are decoded at most batch_frames at a time into an
    incrementally written WAV."""
    engine = resolve_engine(engine)
    batch_frames = resolve_batch_frames(batch_frames, engine, decode=True)
    device = resolve_device(device)
    frame_errors = 0
    with open(x3a_filename, "rb") as f:
        spec, header_size = archive.read_archive_header_file(f)
        if verbose:
            print(f"sample rate: {spec.sample_rate}")
            print(f"block length: {spec.params.block_len}")
            codes = spec.params.codes
            print(f"Rice codes: RICE{codes[0]},RICE{codes[1]},RICE{codes[2]},BFP")
            t = spec.params.thresholds
            print(f"thresholds: {t[0]},{t[1]},{t[2]}")
        with WavWriter(wav_filename, spec.sample_rate) as wout:
            if not resync:
                return _x3a_to_wav_stream(f, wout, header_size, spec.params, batch_frames, device)
            base = 0
            for batch in _batches(archive.walk_frames_file(f, header_size, resync=True), batch_frames):
                samples, bounds, errs = _decode_index(f, batch, spec.params, device)
                if not np.any(errs):
                    wout.write(samples)
                else:
                    for i, err in enumerate(errs):
                        if err:
                            frame_errors += 1
                            print(f"Frame error: frame {base + i} failed to decode")
                            continue
                        wout.write(samples[bounds[i] : bounds[i + 1]])
                base += len(batch)
    return frame_errors


def x3a_info(x3a_filename, *, device="cuda") -> dict:
    """Archive metadata and frame statistics from the header index alone:
    no payload byte is read or decoded, so `device` is only checked.  The
    walk resyncs past damage (the statistics then cover the frames it can
    walk; verify_x3a reports the damage)."""
    resolve_device(device)
    with open(x3a_filename, "rb") as f:
        spec, header_size = archive.read_archive_header_file(f)
        index = list(archive.walk_frames_file(f, header_size, resync=True))
        f.seek(0, 2)
        size = f.tell()
    n_samples = int(sum(h.samples for _, h in index))
    payload_bytes = int(sum(h.payload_len for _, h in index))
    pcm_bytes = 2 * n_samples
    return {
        "sample_rate": spec.sample_rate,
        "block_len": spec.params.block_len,
        "codes": list(spec.params.codes),
        "thresholds": list(spec.params.thresholds),
        "n_frames": len(index),
        "n_samples": n_samples,
        "duration_s": round(n_samples / spec.sample_rate, 3) if spec.sample_rate else None,
        "archive_bytes": size,
        "archive_header_bytes": header_size,
        "frame_header_bytes": len(index) * constants.FRAME_HEADER_LENGTH,
        "payload_bytes": payload_bytes,
        "pcm_bytes": pcm_bytes,
        "compression_ratio": round(pcm_bytes / size, 3) if size else 0.0,
    }


def verify_x3a(
    x3a_filename,
    engine: str = "auto",
    batch_frames: int | None = None,
    verbose: bool = False,
    *,
    device="cuda",
) -> dict:
    """Check an archive without writing output: every frame is walked with
    the resync scanner (so damage past the first bad frame is found too),
    every payload CRC is checked and every frame is decoded on `device`.

    Returns a report; report["ok"] is True when there are no frame errors
    and every byte after the archive header belongs to a valid frame (bytes
    the scanner skipped, or an unwalkable tail, count as skipped_bytes)."""
    engine = resolve_engine(engine)
    batch_frames = resolve_batch_frames(batch_frames, engine, decode=True)
    device = resolve_device(device)
    n_frames = 0
    n_samples_ok = 0
    frame_errors = 0
    skipped = 0
    with open(x3a_filename, "rb") as f:
        try:
            spec, header_size = archive.read_archive_header_file(f)
        except X3Error as e:
            # A damaged archive header still gives a report: inspecting
            # damaged files is what this is for.
            return {
                "ok": False,
                "n_frames": 0,
                "n_samples_ok": 0,
                "frame_errors": 0,
                "skipped_bytes": 0,
                "engine": engine,
                "reason": f"archive header invalid: {e}",
            }
        f.seek(0, 2)
        size = f.tell()
        expect = header_size  # where the next frame header should start
        for batch in _batches(archive.walk_frames_file(f, header_size, resync=True), batch_frames):
            for off, plen in zip(batch.offsets.tolist(), batch.payload_lens.tolist()):
                hstart = off - constants.FRAME_HEADER_LENGTH
                if hstart != expect:
                    skipped += hstart - expect
                    if verbose:
                        print(f"skipped {hstart - expect} bytes at {expect} (sync rescue)")
                expect = off + plen
            _, _, errs = _decode_index(f, batch, spec.params, device)
            for i in np.flatnonzero(errs).tolist():
                frame_errors += 1
                if verbose:
                    print(f"Frame error: frame {n_frames + i} failed to decode")
            n_samples_ok += int(batch.n_samples[errs == 0].sum())
            n_frames += len(batch)
        if size - expect > 0:
            skipped += size - expect  # trailing bytes no valid frame covers
            if verbose:
                print(f"skipped {size - expect} trailing bytes at {expect}")
    return {
        "ok": frame_errors == 0 and skipped == 0,
        "n_frames": n_frames,
        "n_samples_ok": int(n_samples_ok),
        "frame_errors": frame_errors,
        "skipped_bytes": int(skipped),
        "engine": engine,
    }


class X3aReader:
    """Frame-by-frame reader with random access.

    Holds the frame index (archive.index_frames_file, about 18 B a frame)
    and the current decoded batch, read a batch at a time (_decode_index)."""

    def __init__(self, filename, engine: str = "auto", batch_frames: int | None = None, *, device="cuda"):
        self._engine = resolve_engine(engine)
        self._batch_frames = resolve_batch_frames(batch_frames, self._engine, decode=True)
        self._device = resolve_device(device)
        self._f = open(filename, "rb")
        try:
            self._spec, header_size = archive.read_archive_header_file(self._f)
            self._index = archive.index_frames_file(self._f, header_size)
        except BaseException:
            self._f.close()
            raise
        self._cursor = 0
        self._cache: dict[int, np.ndarray | None] = {}
        self.frame_errors = 0
        self._stopped = False

    @classmethod
    def open(cls, filename, **kw) -> "X3aReader":
        return cls(filename, **kw)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def spec(self) -> X3aSpec:
        return self._spec

    def __len__(self) -> int:
        return len(self._index)

    def _decode_batch(self, base: int):
        # A payload-CRC mismatch raises; a decode error becomes a None entry.
        samples, bounds, errs = _decode_index(self._f, self._index[base : base + self._batch_frames],
                                              self._spec.params, self._device, base)
        self._cache = {}  # only the current batch stays resident
        for i, err in enumerate(errs):
            self._cache[base + i] = None if err else samples[bounds[i] : bounds[i + 1]]

    def decode_next_frame(self) -> np.ndarray | None:
        """The next frame's samples, or None at the end and after the first
        frame that fails to decode (the reference's behaviour)."""
        if self._stopped or self._cursor >= len(self._index):
            return None
        i = self._cursor
        if i not in self._cache:
            self._decode_batch((i // self._batch_frames) * self._batch_frames)
        # The entry stays resident until the next batch replaces the cache,
        # so interleaved decode_frame_at calls do not decode the batch again.
        out = self._cache[i]
        if out is None:
            self.frame_errors += 1
            print(f"Frame error: frame {i} failed to decode")
            self._stopped = True
            return None
        self._cursor += 1
        return out

    def tell_frame(self) -> int:
        """Index of the frame the next decode_next_frame() returns."""
        return self._cursor

    def seek_frame(self, i: int) -> None:
        """Put the sequential cursor at frame i; this clears the
        stop-at-the-first-bad-frame latch."""
        if not 0 <= i <= len(self._index):
            raise IndexError(f"frame {i} out of range 0..{len(self._index)}")
        self._cursor = i
        self._stopped = False

    @property
    def sample_offsets(self) -> np.ndarray:
        """int64 [n_frames + 1] cumulative sample offsets, from the header
        index alone."""
        if not hasattr(self, "_offsets"):
            self._offsets = np.concatenate([[0], np.cumsum(self._index.n_samples, dtype=np.int64)])
        return self._offsets

    @property
    def n_samples(self) -> int:
        """Samples in the archive, from the header index alone."""
        return int(self.sample_offsets[-1])

    def decode_frame_at(self, i: int) -> np.ndarray:
        """Frame i's samples, decoded with the batch around it.  Raises the
        frame's own X3Error on damage; damage to another frame of the batch
        does not reach it (frame i is then decoded alone)."""
        if not 0 <= i < len(self._index):
            raise IndexError(f"frame {i} out of range 0..{len(self._index) - 1}")
        if i not in self._cache or self._cache[i] is None:
            try:
                self._decode_batch((i // self._batch_frames) * self._batch_frames)
            except X3Error:
                # Another frame of the batch raised (its payload CRC) before
                # the cache was replaced: drop the previous batch's entries
                # so that a sweep over an archive with a bad frame in every
                # batch keeps one frame resident, not one a good frame.
                self._cache = {}
                self._decode_single(i)
        out = self._cache.get(i)
        if out is None:
            self._decode_single(i)  # raises the frame's own error
            out = self._cache[i]
        return out

    def _decode_single(self, i: int) -> None:
        """Decode frame i alone, raising its own error class: a payload CRC
        mismatch first, then a decode code's class."""
        samples, _, errs = _decode_index(self._f, self._index[i : i + 1], self._spec.params, self._device, i)
        if errs[0]:
            raise decode_error(int(errs[0]), f"frame {i} failed to decode")
        self._cache[i] = samples

    def __getitem__(self, i: int) -> np.ndarray:
        if i < 0:
            i += len(self._index)
        return self.decode_frame_at(i)

    def read_samples(self, start: int, count: int) -> np.ndarray:
        """The samples [start, start + count), decoding only the frames
        that hold them."""
        off = self.sample_offsets
        total = int(off[-1])
        start = max(0, min(start, total))
        stop = max(start, min(start + count, total))
        if start == stop:
            return np.zeros(0, np.int16)
        f0 = int(np.searchsorted(off, start, side="right")) - 1
        f1 = int(np.searchsorted(off, stop, side="left"))  # exclusive
        chunk = np.concatenate([self.decode_frame_at(i) for i in range(f0, f1)])
        base = int(off[f0])
        return chunk[start - base : stop - base]

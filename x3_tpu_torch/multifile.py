"""Batched multi-file / multi-stream encode and decode (x3_tpu.multifile).

Frames are the parallel unit, so frames from different files share device
batches: 256 WAVs encode as one sequence of [F, S] device calls however
the samples are split across files.  Encode runs models.encoder's submit
and finish one batch ahead (K2 + K1 on "cuda", with the encoder's sticky
rung escalation, frames assembled on the device).  Decode indexes whole
archives in sequential reads (archive.index_frames_file, or in memory)
and decodes runs of each archive's consecutive frames from one host
buffer a batch (decode_runs): K3, with the payload CRCs checked by K1, and
the samples read back compacted.  multichannel.x3m_to_wav decodes through
decode_runs too.  device="cpu" runs their plain PyTorch versions.
decode_streams records its call as spans (utils.profiling): the root
x3.decode_streams, x3.decode.index, x3.decode.worklist (the batches and
their host buffers), x3.decode.scatter (the outputs' allocation, with
the bytes of those that come from utils.outpool's recycled pages; then
each batch's copy, on a scatter worker, with x3.scatter_wait on the
caller's thread, where a call has two or more batches), and decode_runs'
x3.decode.stage on the read-ahead thread.

The batch defaults are the port's engine.ENCODE_BATCH_FRAMES and
DECODE_BATCH_FRAMES (768 frames each), in place of x3_tpu's
JAX_ENCODE_BATCH_FRAMES / JAX_DECODE_BATCH_FRAMES, which were measured on
a TPU.  With a `mesh` (parallel.mesh), each batch is rounded up to a
multiple of the mesh's size and sharded over its devices, which must be of
`device`'s type; the bytes do not depend on the mesh."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import wave

import numpy as np
import torch

from . import archive
from .engine import resolve_batch_frames
from .errors import FrameDecodeUnexpectedEnd, FrameHeaderInvalidPayloadCRC, decode_error
from .models.decoder import decode_frames_indexed
from .models.encoder import EncodeResult, finish, submit
from .models.sharding import check_mesh
from .models.staging import BufferPool, StagingPool, host_empty
from .params import Parameters
from .streaming import check_mono16
from .utils import outpool
from .utils.io import AsyncWriter, open_overwrite, prefetch_iter
from .utils.profiling import minor_faults, span
from .utils.wav import WavWriter


def _round_to_mesh(batch_frames: int, mesh) -> int:
    """batch_frames rounded up to a multiple of the mesh's size."""
    return -(-batch_frames // mesh.size) * mesh.size


def _shard(a, b, process_index, process_count):
    """The two parallel file lists cut to this process's shard
    (parallel.multihost.shard_worklist) when either index is given."""
    if process_count is None and process_index is None:
        return a, b
    from .parallel.multihost import shard_worklist

    pairs = shard_worklist(list(zip(a, b)), process_index, process_count)
    return [x for x, _ in pairs], [y for _, y in pairs]


def _runs(chunk):
    """(key, start, stop) of each run of consecutive worklist entries that
    share their first field (a file's frames are consecutive)."""
    a = 0
    for b in range(1, len(chunk) + 1):
        if b == len(chunk) or chunk[b][0] != chunk[a][0]:
            yield chunk[a][0], a, b
            a = b


def encode_streams(
    streams,
    params: Parameters | None = None,
    batch_frames: int | None = None,
    mesh=None,
    source_id: int = 1,
    *,
    device="cuda",
):
    """Encode many independent mono streams, sharing device batches.

    streams: list of int16 arrays.  Returns a list of EncodeResult."""
    mesh = check_mesh(mesh, device)
    params = params or Parameters()
    spf = params.samples_per_frame

    work = []  # (stream_idx, start, n_samples): the frames of every stream
    for si, s in enumerate(streams):
        n = len(s)
        for start in range(0, n, spf):
            work.append((si, start, min(spf, n - start)))

    parts: list[list[bytes]] = [[] for _ in streams]
    stats = [np.zeros(6, dtype=np.int64) for _ in streams]

    def read(si, start, n):
        return streams[si][start : start + n]

    def emit(si, frames, st):
        parts[si].append(frames)
        stats[si] += st

    _run_encode_worklist(work, read, emit, params, batch_frames, source_id, mesh)
    return [EncodeResult(b"".join(p), st) for p, st in zip(parts, stats)]


def _run_encode_worklist(work, read, emit, params: Parameters, batch_frames, source_id: int, mesh):
    """Drive the batched encode over a frame worklist of (key, start, n)
    entries, one batch ahead at the sticky rungs of models.encoder: batch
    i + 1 is submitted before batch i is finished.  Each batch is padded
    with dummy frames to a multiple of the mesh's size and sharded over it,
    all shards at one rung.

    read(key, start, n): the n samples of `key` from `start`, for each run
      of a key's consecutive frames in a batch; a read-ahead thread
      (utils.io.prefetch_iter, depth 1) fills the batches straight into a
      pool of three staging buffers (pinned for a card): one being filled,
      one submitted, one being finished.  It fills host memory only: every
      launch is made from the calling thread.
    emit(key, frames, stats): a run's headers and payloads (a uint8 array),
      and their summed int64 stats [6]."""
    batch_frames = _round_to_mesh(resolve_batch_frames(batch_frames, "torch", decode=False), mesh)
    spf = params.samples_per_frame
    rung = nw_rung = 0
    pool = StagingPool(3, min(batch_frames, _round_to_mesh(len(work), mesh)), spf, mesh.devices[0])

    def _filled():
        for base in range(0, len(work), batch_frames):
            chunk = work[base : base + batch_frames]
            m = _round_to_mesh(len(chunk), mesh)
            buf = pool.acquire()
            batch, n_valid = buf.samples[:m], buf.n_valid[:m]
            b, nv = batch.numpy(), n_valid.numpy()
            nv[: len(chunk)] = [n for _, _, n in chunk]
            nv[len(chunk) :] = 0  # dummy frames past the chunk
            b[len(chunk) :] = 0
            for key, a, c in _runs(chunk):
                # A run's frames are consecutive rows: one read fills them,
                # only its last frame may be partial.
                rows = b[a:c].reshape(-1)
                n = int(nv[a:c].sum())
                rows[:n] = read(key, chunk[a][1], n)
                rows[n:] = 0
            yield chunk, buf, batch, n_valid

    def _finish(chunk, buf, sub):
        try:
            done = finish(sub, rung, nw_rung, source_id)
        finally:
            pool.release(buf)
        for key, a, c in _runs(chunk):
            emit(key, done.frames[done.offsets[a] : done.offsets[c]],
                 done.stats[a:c].sum(axis=0, dtype=np.int64))
        return done.rung, done.nw_rung

    filled = prefetch_iter(_filled(), depth=1)
    pending = None
    try:
        for chunk, buf, batch, n_valid in filled:
            try:
                sub = submit(batch, n_valid, params, rung, nw_rung, mesh)
            except BaseException:
                pool.release(buf)
                raise
            prev, pending = pending, (chunk, buf, sub)
            if prev is not None:
                rung, nw_rung = _finish(*prev)
        if pending is not None:
            prev, pending = pending, None
            rung, nw_rung = _finish(*prev)
    finally:
        pool.close()  # wakes a read-ahead thread waiting for a buffer
        filled.close()


@dataclasses.dataclass
class DecodeBatch:
    """One device call of decode_runs: frames of one Parameters, given as
    runs of consecutive frames of one source (an archive, a channel)."""

    params: Parameters
    keys: np.ndarray  # int64 [F]: each frame's source
    frames: np.ndarray  # int64 [F]: each frame's number in its source
    index: archive.FrameIndex  # the frames' payloads, at offsets in their sources
    tag: object = None  # the caller's

    def runs(self):
        """(key, start, stop) of each run of the batch's frames."""
        cuts = [0, *(np.flatnonzero(self.keys[1:] != self.keys[:-1]) + 1).tolist(), len(self.keys)]
        return [(int(self.keys[a]), a, b) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]

    def spans(self):
        """(key, lo, hi, start, stop) of each run: its bytes are [lo, hi) of
        its source, from its first payload to its last payload's end."""
        ix = self.index
        return [(key, int(ix.offsets[a]), int(ix.offsets[b - 1] + ix.payload_lens[b - 1]), a, b)
                for key, a, b in self.runs()]


def decode_batches(specs, indexes, batch_frames: int) -> list[DecodeBatch]:
    """x3_tpu's decode worklist over indexed archives (an archive.FrameIndex
    each, with its spec; their keys 0, 1, ...): every frame grouped by
    params, in archive and frame order within a group, cut into batches of
    batch_frames frames."""
    groups: dict[Parameters, list] = {}
    for key, (spec, ix) in enumerate(zip(specs, indexes)):
        groups.setdefault(spec.params, []).append((key, ix))
    out = []
    for params, members in groups.items():
        key_of = np.concatenate([np.full(len(ix), key, np.int64) for key, ix in members])
        frames = np.concatenate([np.arange(len(ix), dtype=np.int64) for _, ix in members])
        index = archive.FrameIndex.concat(ix for _, ix in members)
        for base in range(0, len(key_of), batch_frames):
            cut = slice(base, base + batch_frames)
            out.append(DecodeBatch(params, key_of[cut], frames[cut], index[cut]))
    return out


def decode_runs(batches, read_span, mesh, arrange=None):
    """Decode `batches` (DecodeBatch) on the mesh, one device call each, and
    yield (batch, samples, err, crc_ok) in order: decode_frames_indexed's
    results, the payload CRCs checked against the stored ones.

    Each run's bytes are copied once, read_span(key, lo, out) filling the
    uint8 array `out` with bytes [lo, lo + len(out)) of source `key`, into
    one host buffer a batch on a read-ahead thread (utils.io.prefetch_iter,
    depth 1; only it calls read_span).  Three buffers (pinned for a card),
    sized to the largest batch, pass through a models.staging.BufferPool:
    one filled, one waiting, one decoding.  A batch goes up in one copy, is
    walked and CRC-checked on each shard (K3 and K1 on a card) and read
    back in one pinned copy behind an event, after which its buffer goes
    back to the pool; each batch's samples are an array of their own, which
    no later batch reuses.

    arrange(batch, samples): a function of a batch's compacted samples on
    the device whose result is read back in their place (the `arrange` of
    decode_frames_indexed).  Close the generator (contextlib.closing)
    before closing what read_span reads: that stops the read-ahead
    thread."""
    if not batches:
        return
    with span("x3.decode.worklist"):
        spans = [b.spans() for b in batches]
        size = max(sum(hi - lo for _, lo, hi, _, _ in sp) for sp in spans)
        pool = BufferPool(host_empty(max(1, size), torch.uint8, mesh.devices[0])
                          for _ in range(min(3, len(batches))))

    def _filled():
        for batch, sp in zip(batches, spans):
            with span("x3.decode.stage") as stage:
                buf = pool.acquire()
                arr = buf.numpy()
                offsets = np.empty(len(batch.keys), np.int64)
                at = 0
                for key, lo, hi, a, b in sp:
                    read_span(key, lo, arr[at : at + hi - lo])
                    offsets[a:b] = batch.index.offsets[a:b] - lo + at
                    at += hi - lo
                stage.add(bytes=at)
            yield batch, buf, buf[:at], offsets

    filled = prefetch_iter(_filled(), depth=1)
    try:
        for batch, buf, data, offsets in filled:
            ix = batch.index
            try:
                out = decode_frames_indexed(
                    data, offsets, ix.n_samples, ix.payload_lens, batch.params, check_crcs=ix.crcs,
                    device=mesh.device_type, mesh=mesh,
                    arrange=None if arrange is None else (lambda t, b=batch: arrange(b, t)))
            finally:
                pool.release(buf)
            yield (batch, *out)
    finally:
        pool.close()  # wakes a read-ahead thread waiting for a buffer
        filled.close()


def file_span_reader(handles):
    """decode_runs' read_span over a list of open files: one seek and one
    readinto a run."""
    def read(key, lo, out):
        f = handles[key]
        f.seek(lo)
        if f.readinto(memoryview(out)) != len(out):
            raise FrameDecodeUnexpectedEnd(f"archive {key} ended inside a frame indexed before")
    return read


def _index_streams(archives):
    """(specs, indexes, failure): each archive's header and in-memory
    frame index (archive.index_frames_in_memory) up to the first that
    fails, and that failure (None if none did), in one x3.decode.index
    span."""
    specs, indexes, failure = [], [], None
    with span("x3.decode.index", archives=len(archives)):
        for data in archives:
            try:
                spec, header_size = archive.parse_archive_header(data)
                index = archive.index_frames_in_memory(data, header_size)
            except Exception as e:  # noqa: BLE001 - raised by the caller, after earlier archives' CRCs
                failure = e
                break
            specs.append(spec)
            indexes.append(index)
    return specs, indexes, failure


@contextlib.contextmanager
def _scatter_span(nbytes: int):
    """An x3.decode.scatter span of `nbytes` copied into the outputs, with
    the thread's minor page faults over it (minflt); it yields the span."""
    faults = minor_faults()
    with span("x3.decode.scatter", bytes=nbytes) as sp:
        try:
            yield sp
        finally:
            sp.add(minflt=minor_faults() - faults)


def _scatter(outs, dec, runs) -> None:
    """Copy a batch's decoded samples `dec` into the outputs, one
    (archive, at, lo, hi) a run: outs[archive][at:] = dec[lo:hi]."""
    with _scatter_span(dec.nbytes):
        for ai, at, lo, hi in runs:
            outs[ai][at : at + hi - lo] = dec[lo:hi]


def decode_streams(
    archives,
    batch_frames: int | None = None,
    mesh=None,
    *,
    device="cuda",
):
    """Decode many .x3a archive byte strings, sharing device batches.

    Archives may use different Parameters: the frame worklist is grouped by
    params, each group decoded with its own frame geometry.  Returns a list
    of (samples int16 array, sample_rate).  Each archive is indexed in
    memory (archive.index_frames_in_memory) and its frames decoded in runs
    (decode_runs), their payload CRCs checked by the decode calls.  The
    errors are x3_tpu's, which checks every archive's CRCs, in order, before
    it decodes any frame: the first CRC mismatch in (archive, frame) order
    among the archives before the first one whose header or walk fails,
    then that failure, then the first frame in worklist order that fails to
    decode.  The call returns nothing on an error, so every batch is
    decoded before the error is chosen.

    With two or more batches, a scatter worker (a thread of the call's
    own, utils.io.AsyncWriter) copies batch i into the outputs while batch
    i + 1 is launched; the call waits for its last copy (x3.scatter_wait)
    and raises its error, if any, before anything else.  One batch is
    copied on the caller's thread, with no thread started.

    An output of utils.outpool.THRESHOLD_BYTES (32 MiB) or more comes from
    utils.outpool: the warm pages of an earlier output that nothing
    references any more where the pool holds them, else a new mapping.
    Every sample of every output is written before the call returns.
    Once the caller drops a call's outputs, up to that call's bytes of
    such outputs stay mapped (resident) until the next call, which keeps
    only as many as it takes itself."""
    mesh = check_mesh(mesh, device)
    batch_frames = _round_to_mesh(resolve_batch_frames(batch_frames, "torch", decode=True), mesh)
    with span("x3.decode_streams", archives=len(archives)) as call:
        specs, indexes, failure = _index_streams(archives)
        call.add(frames=sum(len(ix) for ix in indexes))
        with _scatter_span(0) as alloc:
            outs, pooled, reused = outpool.POOL.take([int(ix.n_samples.sum(dtype=np.int64)) for ix in indexes])
            alloc.add(pooled_bytes=pooled, reused_bytes=reused)
        done = [0] * len(indexes)
        bad_crc, bad_decode = None, None  # (archive, frame) of the first; (archive, frame, code)

        def read(key, lo, out):
            out[:] = np.frombuffer(archives[key], np.uint8, len(out), lo)

        with span("x3.decode.worklist"):
            batches = decode_batches(specs, indexes, batch_frames)
        worker = AsyncWriter(None, depth=1, wait_span="x3.scatter_wait") if len(batches) > 1 else None
        try:
            with contextlib.closing(decode_runs(batches, read, mesh)) as decoded:
                for batch, dec, err, crc_ok in decoded:
                    if not crc_ok.all():
                        j = int(np.argmin(crc_ok))
                        at = (int(batch.keys[j]), int(batch.frames[j]))
                        bad_crc = at if bad_crc is None else min(bad_crc, at)
                    if bad_decode is None and err.any():
                        j = int(np.argmax(err != 0))
                        bad_decode = (int(batch.keys[j]), int(batch.frames[j]), int(err[j]))
                    bounds = np.concatenate([[0], np.cumsum(batch.index.n_samples, dtype=np.int64)])
                    runs = []
                    for ai, a, b in batch.runs():
                        runs.append((ai, done[ai], int(bounds[a]), int(bounds[b])))
                        done[ai] += int(bounds[b] - bounds[a])
                    # The queued copy holds `dec`, so its pinned read-back is
                    # not reused before the copy is done.
                    copy = functools.partial(_scatter, outs, dec, runs)
                    if worker is None:
                        copy()
                    else:
                        worker.call(copy)
        finally:
            if worker is not None:
                worker.close()  # every queued copy done, the thread joined; its error raised
    if bad_crc is not None:
        raise FrameHeaderInvalidPayloadCRC(f"archive {bad_crc[0]} frame {bad_crc[1]} payload CRC mismatch")
    if failure is not None:
        raise failure
    if bad_decode is not None:
        ai, fi, code = bad_decode
        raise decode_error(code, f"archive {ai} frame {fi} failed to decode")
    return [(out, spec.sample_rate) for out, spec in zip(outs, specs)]


def wav_to_x3a_batch(
    wav_filenames,
    x3a_filenames,
    params: Parameters | None = None,
    batch_frames: int | None = None,
    mesh=None,
    process_index: int | None = None,
    process_count: int | None = None,
    *,
    device="cuda",
):
    """Batch-convert many WAV files to .x3a archives, frames from all files
    sharing device batches.  Returns the list of EncodeResult (data=b"",
    nbytes = the frame-stream size written; archives go straight to disk).

    Streaming: WAVs are read in per-batch sample ranges (seeks) and
    archives written incrementally, so peak memory is O(batch_frames)
    whatever the total input volume, as in files.wav_to_x3a.

    process_index/process_count: multi-process input sharding; this process
    converts only its strided shard of the file list
    (parallel.multihost.shard_worklist).  The codec needs no collectives,
    so processes never communicate."""
    mesh = check_mesh(mesh, device)
    wav_filenames, x3a_filenames = _shard(wav_filenames, x3a_filenames, process_index, process_count)
    params = params or Parameters()
    spf = params.samples_per_frame

    readers, outs = [], []
    try:
        work = []  # (file_idx, start_sample, n_samples)
        for fi, p in enumerate(wav_filenames):
            w = wave.open(str(p), "rb")
            readers.append(w)
            check_mono16(w)
            n = w.getnframes()
            for start in range(0, n, spf):
                work.append((fi, start, min(spf, n - start)))

        for fi, p in enumerate(x3a_filenames):
            f = open_overwrite(p)
            outs.append(f)
            f.write(archive.build_archive_header(readers[fi].getframerate(), params))

        stats = [np.zeros(6, dtype=np.int64) for _ in readers]
        written = [0] * len(readers)

        def read(fi, start, n):
            readers[fi].setpos(start)
            return np.frombuffer(readers[fi].readframes(n), dtype="<i2")

        def emit(fi, frames, st):
            # Each file's frames come in order, so the incremental writes
            # give the bytes of the in-memory concatenation.
            outs[fi].write(frames)
            written[fi] += len(frames)
            stats[fi] += st

        _run_encode_worklist(work, read, emit, params, batch_frames, 1, mesh)
        for f in outs:  # open_overwrite skips O_TRUNC; cut stale tails now
            f.truncate()
        return [EncodeResult(b"", st, nbytes=nb) for st, nb in zip(stats, written)]
    finally:
        for w in readers:
            w.close()
        for f in outs:
            f.close()


def x3a_to_wav_batch(
    x3a_filenames,
    wav_filenames,
    batch_frames: int | None = None,
    mesh=None,
    process_index: int | None = None,
    process_count: int | None = None,
    *,
    device="cuda",
):
    """Batch-convert many .x3a archives back to WAV files, frames from all
    archives sharing device batches.  Returns per-file sample counts.

    Streaming: every archive is indexed first in sequential reads
    (archive.index_frames_file, about 18 bytes a frame); then each batch's
    runs of consecutive frames of one archive are read, one read a run,
    into one host buffer and decoded from it (decode_runs), with WAVs
    written incrementally, so beyond the index peak memory is
    O(batch_frames) whatever the total archive volume.  A batch's payload CRC mismatch (K1
    on "cuda") raises before its decode errors, after every earlier batch
    was written; outputs flushed before a raise may be partial.

    process_index/process_count: multi-process input sharding (strided);
    this process decodes only its shard of the archive list."""
    mesh = check_mesh(mesh, device)
    x3a_filenames, wav_filenames = _shard(x3a_filenames, wav_filenames, process_index, process_count)
    batch_frames = _round_to_mesh(resolve_batch_frames(batch_frames, "torch", decode=True), mesh)

    handles, writers = [], {}
    # One writer thread for every WAV (a thread each cost more than the
    # reads): a WavWriter's close() queues its header's patch there and
    # returns.  Its blocks are runs, a few dozen a batch.
    shared = AsyncWriter(None, depth=64)
    try:
        # Every archive is indexed before any frame is decoded, as in
        # x3_tpu: a bad header anywhere raises before any WAV is written.
        specs, indexes = [], []
        for p in x3a_filenames:
            f = open(p, "rb")
            handles.append(f)
            spec, hs = archive.read_archive_header_file(f)
            specs.append(spec)
            indexes.append(archive.index_frames_file(f, hs))

        def writer_for(ai):
            if ai not in writers:
                writers[ai] = WavWriter(wav_filenames[ai], specs[ai].sample_rate, writer=shared)
            return writers[ai]

        done = [0] * len(handles)
        batches = decode_batches(specs, indexes, batch_frames)
        # Closed before the finally below closes `handles`, so that no
        # handle is closed under a read of the read-ahead thread.
        with contextlib.closing(decode_runs(batches, file_span_reader(handles), mesh)) as decoded:
            for batch, dec, err, crc_ok in decoded:
                if not crc_ok.all():
                    j = int(np.argmin(crc_ok))
                    raise FrameHeaderInvalidPayloadCRC(
                        f"archive {batch.keys[j]} frame {batch.frames[j]} payload CRC mismatch")
                if err.any():
                    j = int(np.argmax(err != 0))
                    raise decode_error(err[j], f"archive {batch.keys[j]} frame {batch.frames[j]} failed to decode")
                bounds = np.concatenate([[0], np.cumsum(batch.index.n_samples, dtype=np.int64)])
                for ai, a, b in batch.runs():
                    writer_for(ai).write(dec[bounds[a] : bounds[b]])  # one write a run
                    done[ai] += b - a
                    if done[ai] == len(indexes[ai]):
                        writers.pop(ai).close()

        # Archives with no frames still give (empty) WAVs.
        for ai, index in enumerate(indexes):
            if not len(index):
                writer_for(ai)
                writers.pop(ai).close()
        return [int(ix.n_samples.sum(dtype=np.int64)) for ix in indexes]
    finally:
        try:
            for wtr in writers.values():
                wtr.close()
            shared.close()  # every WAV written and closed; raises a write error
        finally:
            for f in handles:
                f.close()

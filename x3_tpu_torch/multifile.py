"""Batched multi-file / multi-stream encode and decode (x3_tpu.multifile).

Frames are the parallel unit, so frames from different files share device
batches: 256 WAVs encode as one sequence of [F, S] device calls however
the samples are split across files.  Encode runs models.encoder's submit
and finish one batch ahead (K2 + K1 on "cuda", with the encoder's sticky
rung escalation, frames assembled on the device); decode runs K3, with
the payload CRCs checked by K1, and reads the samples back compacted
(decode_frames_flat).
device="cpu" runs their plain PyTorch versions.

The batch defaults are the port's engine.ENCODE_BATCH_FRAMES and
DECODE_BATCH_FRAMES (768 frames each), in place of x3_tpu's
JAX_ENCODE_BATCH_FRAMES / JAX_DECODE_BATCH_FRAMES, which were measured on
a TPU.  With a `mesh` (parallel.mesh), each batch is rounded up to a
multiple of the mesh's size and sharded over its devices, which must be of
`device`'s type; the bytes do not depend on the mesh."""

from __future__ import annotations

import wave

import numpy as np

from . import archive
from .engine import resolve_batch_frames
from .errors import FrameHeaderInvalidPayloadCRC, decode_error
from .models.decoder import decode_frames_flat, payload_batch
from .models.encoder import EncodeResult, finish, submit
from .models.sharding import check_mesh, shard_map
from .models.staging import StagingPool
from .ops.crc_torch import crc16_words
from .ops.decode_kernel import payload_words
from .params import Parameters
from .streaming import check_mono16
from .utils.io import open_overwrite, prefetch_iter
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


def _payload_crcs_ok(payloads, want_crcs, params: Parameters, mesh) -> np.ndarray:
    """bool [len(payloads)]: each payload's CRC16 equals its expected value,
    computed over a decode batch's buffer sharded over the mesh's devices
    (K1 on a card)."""
    buf, _, plens, _ = payload_batch(payloads, [0] * len(payloads), params, mesh.size)

    def crcs(b, pl):
        words = payload_words(b)
        return crc16_words(words, pl, words.shape[1])

    crc = shard_map(crcs, mesh, buf, plens)
    return crc[: len(payloads)].cpu().numpy() == np.asarray(want_crcs, dtype=np.int64)


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
    of (samples int16 array, sample_rate).  As in x3_tpu, the payload CRCs
    of every archive are checked before any frame is decoded, and a CRC
    mismatch or a frame that fails to decode raises its error class."""
    mesh = check_mesh(mesh, device)
    batch_frames = _round_to_mesh(resolve_batch_frames(batch_frames, "torch", decode=True), mesh)
    specs = []
    groups: dict[Parameters, list] = {}  # params -> [(archive_idx, frame_idx, payload, n_samples)]
    for ai, data in enumerate(archives):
        spec, header_size = archive.parse_archive_header(data)
        specs.append(spec)
        index = list(archive.walk_frames(data, header_size))
        payloads = [data[off : off + h.payload_len] for off, h in index]
        for base in range(0, len(index), batch_frames):
            ok = _payload_crcs_ok(payloads[base : base + batch_frames],
                                  [h.payload_crc for _, h in index[base : base + batch_frames]],
                                  spec.params, mesh)
            if not ok.all():
                bad = base + int(np.nonzero(~ok)[0][0])
                raise FrameHeaderInvalidPayloadCRC(f"archive {ai} frame {bad} payload CRC mismatch")
        work = groups.setdefault(spec.params, [])
        for fi, ((_, h), payload) in enumerate(zip(index, payloads)):
            work.append((ai, fi, payload, h.samples))

    outs: list[list[np.ndarray]] = [[] for _ in archives]  # each archive's runs of frames, in order
    for params, work in groups.items():
        for base in range(0, len(work), batch_frames):
            chunk = work[base : base + batch_frames]
            counts = [n for _, _, _, n in chunk]
            dec, err = decode_frames_flat([p for _, _, p, _ in chunk], counts, params,
                                          device=mesh.device_type, mesh=mesh)
            if err.any():
                bad = int(np.nonzero(err)[0][0])
                ai, fi = chunk[bad][0], chunk[bad][1]
                raise decode_error(err[bad], f"archive {ai} frame {fi} failed to decode")
            bounds = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
            for ai, a, b in _runs(chunk):
                outs[ai].append(dec[bounds[a] : bounds[b]])

    return [(np.concatenate(parts) if parts else np.zeros(0, np.int16), spec.sample_rate)
            for parts, spec in zip(outs, specs)]


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

    Streaming: as in files.x3a_to_wav, archives are indexed with
    header-only seeks and payloads are read one device batch at a time,
    with WAVs written incrementally, so peak memory is O(batch_frames)
    whatever the total archive volume.  A batch's payload CRC mismatch (K1
    on "cuda") raises before its decode errors, after every earlier batch
    was written; outputs flushed before a raise may be partial.

    process_index/process_count: multi-process input sharding (strided);
    this process decodes only its shard of the archive list."""
    mesh = check_mesh(mesh, device)
    x3a_filenames, wav_filenames = _shard(x3a_filenames, wav_filenames, process_index, process_count)
    batch_frames = _round_to_mesh(resolve_batch_frames(batch_frames, "torch", decode=True), mesh)

    handles, writers = [], {}
    try:
        specs, indexes = [], []
        for p in x3a_filenames:
            f = open(p, "rb")
            handles.append(f)
            spec, hs = archive.read_archive_header_file(f)
            specs.append(spec)
            indexes.append(list(archive.walk_frames_file(f, hs)))

        # Frame worklists grouped by params (each archive belongs to exactly
        # one group, so its frames still arrive in order).
        groups: dict[Parameters, list] = {}
        for ai, index in enumerate(indexes):
            g = groups.setdefault(specs[ai].params, [])
            for fi, (off, h) in enumerate(index):
                g.append((ai, fi, off, h))

        def writer_for(ai):
            if ai not in writers:
                writers[ai] = WavWriter(wav_filenames[ai], specs[ai].sample_rate)
            return writers[ai]

        done = [0] * len(handles)

        def _prepared():
            # The next batch's payload reads run on a read-ahead thread
            # while the current batch decodes; only this generator touches
            # `handles`.
            for params, work in groups.items():
                for base in range(0, len(work), batch_frames):
                    chunk = work[base : base + batch_frames]
                    payloads = []
                    for ai, _, off, h in chunk:
                        handles[ai].seek(off)
                        payloads.append(handles[ai].read(h.payload_len))
                    yield params, chunk, payloads

        prepared = prefetch_iter(_prepared(), depth=1)
        try:
            for params, chunk, payloads in prepared:
                heads = [h for _, _, _, h in chunk]
                counts = [h.samples for h in heads]
                dec, err, crc_ok = decode_frames_flat(
                    payloads, counts, params,
                    check_crcs=[h.payload_crc for h in heads], device=mesh.device_type, mesh=mesh,
                )
                if not crc_ok.all():
                    ai, fi = chunk[int(np.nonzero(~crc_ok)[0][0])][:2]
                    raise FrameHeaderInvalidPayloadCRC(f"archive {ai} frame {fi} payload CRC mismatch")
                if err.any():
                    bad = int(np.nonzero(err)[0][0])
                    ai, fi = chunk[bad][:2]
                    raise decode_error(err[bad], f"archive {ai} frame {fi} failed to decode")
                bounds = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
                for ai, a, b in _runs(chunk):
                    writer_for(ai).write(dec[bounds[a] : bounds[b]])  # one write a run
                    done[ai] += b - a
                    if done[ai] == len(indexes[ai]):
                        writers.pop(ai).close()
        finally:
            # Stop the read-ahead thread before the outer finally closes
            # `handles`, so no handle is closed under a read.
            prepared.close()

        # Archives with no frames still give (empty) WAVs.
        for ai, index in enumerate(indexes):
            if not index:
                writer_for(ai)
                writers.pop(ai).close()
        return [int(sum(h.samples for _, h in index)) for index in indexes]
    finally:
        for wtr in writers.values():
            wtr.close()
        for f in handles:
            f.close()

"""The port's batch and multichannel decodes on the CPU (device="cpu")
against x3_tpu's: multifile.x3a_to_wav_batch, multifile.decode_streams and
multichannel.x3m_to_wav, which index whole archives in sequential reads
(archive.index_frames_file, archive.index_frames) and decode runs of
frames from one host buffer a batch.  Outputs, raised classes and
messages, and every WAV written before a raise equal x3_tpu's (JAX on the
CPU); reads are counted.  Small geometries, as in test_torch_multifile
and test_torch_multichannel."""

import numpy as np
import pytest

from tests.test_torch_multichannel import SHORT, capture
from tests.test_torch_multifile import _damage

# ---- x3m_to_wav: errors in window, channel and frame order ----

X3M_SAMPLES = 9 * 600 + 77  # 10 frames of 600 a channel, the last partial


@pytest.fixture(scope="module")
def x3m_clean(tmp_path_factory):
    """A 3-channel capture of 10 frames of 600 samples a channel, encoded
    by x3_tpu.  Its XML has no blocks_per_frame, so the window of
    x3m_to_wav counts frames of 1,000 samples: at batch_frames 1 a window
    covers two frames, its first shared with the window before."""
    from x3_tpu import multichannel as ref

    d = tmp_path_factory.mktemp("x3m_clean")
    chans = capture(7, X3M_SAMPLES)
    mpath = ref.encode_multichannel(chans, 48_000, d / "cap.x3m", SHORT)
    return {p.name: p.read_bytes() for p in d.iterdir()}, chans


def _x3m_copy(x3m_clean, d):
    files, chans = x3m_clean
    d.mkdir(exist_ok=True)
    for name, data in files.items():
        (d / name).write_bytes(data)
    return d / "cap.x3m", chans


def raised(fn):
    """("ok", fn()) or ("raise", (class name, message))."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the class and message are what is compared
        return "raise", (type(e).__name__, str(e))


def x3m_outcomes(mpath, tmp_path, batch):
    """The port's and x3_tpu's (jax engine) outcome of x3m_to_wav, each with
    the bytes of the WAV it leaves (None if none)."""
    from x3_tpu import multichannel as ref

    from x3_tpu_torch import multichannel as port

    out = []
    for who, fn in (("port", lambda o: port.x3m_to_wav(mpath, o, batch_frames=batch, device="cpu")),
                    ("ref", lambda o: ref.x3m_to_wav(mpath, o, engine="jax", batch_frames=batch))):
        o = tmp_path / f"{who}.wav"
        res = raised(lambda: fn(o))
        out.append((res, o.read_bytes() if o.exists() else None))
    return out


# (channel, frame, kind) of each damage.  At batch_frames 1 frame 0 lies in
# window 0 alone and frame 9 in window 4 alone; at 3 and None one or two
# windows cover both, and the channel order decides.
X3M_DAMAGE = {
    "crc-ch2-w0+decode-ch0-later": [(2, 0, "crc"), (0, 9, "decode")],
    "decode-ch2-w0+crc-ch0-later": [(2, 0, "decode"), (0, 9, "crc")],
    "crc+decode-one-window": [(1, 4, "decode"), (2, 4, "crc")],
    "crc-and-decode-one-frame": [(1, 5, "decode"), (1, 5, "crc")],
    "header": [(1, 6, "header")],
}


@pytest.mark.parametrize("batch", [1, 3, None])
@pytest.mark.parametrize("case", list(X3M_DAMAGE))
def test_x3m_to_wav_damage_like_x3_tpu(x3m_clean, tmp_path, case, batch):
    """x3m_to_wav raises x3_tpu's class and message, in window, then
    channel, then frame order, with a frame's CRC before its decode, after
    writing every earlier window into a WAV whose header is patched."""
    mpath, _ = _x3m_copy(x3m_clean, tmp_path / "cap")
    for c, fi, kind in X3M_DAMAGE[case]:
        _damage(mpath.parent / f"cap.ch{c}.x3a", fi, kind)
    got, want = x3m_outcomes(mpath, tmp_path, batch)
    assert got == want
    assert got[0][0] == "raise"


# ---- (a) archive.index_frames_file against x3_tpu's walk_frames_file ----

SMALL_N = 14  # frames of the indexed archive


@pytest.fixture(scope="module")
def small_archive(tmp_path_factory):
    """A 14-frame archive of TINY frames (partial last frame) and its
    frames as x3_tpu's walker gives them."""
    from tests.test_torch_files import TINY, signal
    from x3_tpu import archive as ref_archive
    from x3_tpu.models import oracle

    S = TINY.samples_per_frame
    data = ref_archive.build_archive_header(8000, TINY) + oracle.encode(signal(30, (SMALL_N - 1) * S + 9), TINY)
    _, hdr_end = ref_archive.parse_archive_header(data)
    idx = list(ref_archive.walk_frames(data, hdr_end))
    assert len(idx) == SMALL_N
    return dict(data=data, hdr_end=hdr_end, idx=idx)


def _restamp_header(data: bytearray, hoff: int) -> None:
    from x3_tpu.ops.crc import crc16

    data[hoff + 16 : hoff + 18] = crc16(bytes(data[hoff : hoff + 16])).to_bytes(2, "big")


def _header_damage(arch, field: str) -> bytes:
    """Frame 5's header with a valid CRC but a channels byte of 2, or a
    payload length of FRAME_MAX_LENGTH."""
    data = bytearray(arch["data"])
    hoff = arch["idx"][5][0] - 20
    if field == "channels":
        data[hoff + 3] = 2
    else:
        data[hoff + 6 : hoff + 8] = (0x7FE0).to_bytes(2, "big")
    _restamp_header(data, hoff)
    return bytes(data)


INDEX_CASES = {
    **{k: None for k in ("clean", "payload-byte", "decode-error", "header-byte", "corrupt-key",
                         "truncate-payload", "truncate-header", "delete-frame", "garbage-between",
                         "trailing-junk")},
    **{f"tail{n}": n for n in (0, 1, 19, 20, 21)},
    "channels-byte": "channels",
    "frame-length": "length",
}


def indexed_archive(arch, case: str) -> bytes:
    from tests.test_torch_files import damaged

    extra = INDEX_CASES[case]
    if case.startswith("tail"):
        return arch["data"] + bytes(range(7, 7 + extra))
    if isinstance(extra, str):
        return _header_damage(arch, extra)
    return damaged(arch, case)


def walk_outcome(fn):
    """The walk's entries (payload offset, samples, payload length, stored
    CRC) before any error, and the error's (class, message) or None."""
    entries = []
    try:
        for e in fn():
            entries.append(e)
    except Exception as e:  # noqa: BLE001 - the class and message are what is compared
        return entries, (type(e).__name__, str(e))
    return entries, None


def _port_entries(f, start):
    from x3_tpu_torch import archive

    ix = archive.index_frames_file(f, start)
    assert (ix.offsets.dtype, ix.n_samples.dtype, ix.payload_lens.dtype) == (np.int64, np.int32, np.int32)
    return list(zip(ix.offsets.tolist(), ix.n_samples.tolist(), ix.payload_lens.tolist(), ix.crcs.tolist()))


@pytest.mark.parametrize("chunk", [64, 3000, None], ids=lambda c: f"chunk{c or 'default'}")
@pytest.mark.parametrize("case", list(INDEX_CASES))
def test_index_frames_file_like_the_walker(small_archive, tmp_path, monkeypatch, case, chunk):
    """Entries equal x3_tpu's walk_frames_file without resync; a damage
    raises its class and message, with no entry returned; a tail of at most
    a header's worth ends the index silently.  At 64-byte reads the archive
    spans some 40 reads, each frame split across two."""
    from x3_tpu import archive as ref_archive

    from x3_tpu_torch import archive

    if chunk is not None:
        monkeypatch.setattr(archive, "CHUNK_BYTES", chunk)
    p = tmp_path / "a.x3a"
    p.write_bytes(indexed_archive(small_archive, case))
    start = small_archive["hdr_end"]
    with open(p, "rb") as f:
        want = walk_outcome(lambda: ((off, h.samples, h.payload_len, h.payload_crc)
                                     for off, h in ref_archive.walk_frames_file(f, start)))
    with open(p, "rb") as f:
        got = walk_outcome(lambda: _port_entries(f, start))
    if want[1] is None:
        assert got == want
    else:
        assert got == ([], want[1])
    assert (want[1] is None) == (case in ("clean", "payload-byte", "decode-error", "delete-frame",
                                          "truncate-header", "tail0", "tail1", "tail19", "tail20"))


@pytest.mark.parametrize("start", ["frame 7", "mid-file junk", "last bytes", "past the end"])
def test_index_frames_file_from_a_later_start(small_archive, tmp_path, start):
    from x3_tpu import archive as ref_archive

    data = small_archive["data"]
    at = {"frame 7": small_archive["idx"][7][0] - 20, "mid-file junk": small_archive["idx"][7][0] - 13,
          "last bytes": len(data) - 20, "past the end": len(data) + 5}[start]
    p = tmp_path / "a.x3a"
    p.write_bytes(data)
    with open(p, "rb") as f:
        want = walk_outcome(lambda: ((off, h.samples, h.payload_len, h.payload_crc)
                                     for off, h in ref_archive.walk_frames_file(f, at)))
    with open(p, "rb") as f:
        got = walk_outcome(lambda: _port_entries(f, at))
    assert got == (want if want[1] is None else ([], want[1]))


def test_index_frames_in_memory_like_the_walker(small_archive):
    """The in-memory index of decode_streams: walk_frames' entries and
    errors, over every case of the file index."""
    from x3_tpu import archive as ref_archive

    from x3_tpu_torch import archive

    for case in INDEX_CASES:
        data = indexed_archive(small_archive, case)
        start = small_archive["hdr_end"]
        want = walk_outcome(lambda: ((off, h.samples, h.payload_len, h.payload_crc)
                                     for off, h in ref_archive.walk_frames(data, start)))

        def port():
            ix = archive.index_frames_in_memory(data, start)
            return zip(ix.offsets.tolist(), ix.n_samples.tolist(), ix.payload_lens.tolist(), ix.crcs.tolist())

        got = walk_outcome(port)
        assert got == (want if want[1] is None else ([], want[1])), case


def test_wav_writer_channels_like_wave(tmp_path):
    """WavWriter of 1 and 3 channels, written in parts, gives the wave
    module's bytes, and cuts a longer earlier file to size."""
    import wave

    from x3_tpu_torch.utils.wav import WavWriter

    rng = np.random.default_rng(3)
    for c in (1, 3):
        block = rng.integers(-2**15, 2**15, (1001, c)).astype(np.int16)
        with wave.open(str(tmp_path / "want.wav"), "wb") as w:
            w.setnchannels(c)
            w.setsampwidth(2)
            w.setframerate(44_100)
            w.writeframes(block.tobytes())
        out = tmp_path / "got.wav"
        out.write_bytes(b"\x05" * 20_000)
        with WavWriter(out, 44_100, channels=c) as wout:
            for part in (block[:400], block[400:400], block[400:]):
                wout.write(part if c > 1 else part[:, 0])
        assert out.read_bytes() == (tmp_path / "want.wav").read_bytes()


# ---- (b) the three decodes against x3_tpu: outputs, errors, partial WAVs ----

def _batch_set(tmp_path):
    """Six archives of two Parameters and six rates (one empty, one of one
    sample), written by x3_tpu's oracle: (paths, samples)."""
    from tests.test_torch_files import TINY
    from tests.test_torch_multifile import _signal
    from x3_tpu import archive as ref_archive
    from x3_tpu.models import oracle
    from x3_tpu.params import Parameters

    S = TINY.samples_per_frame
    odd = Parameters(block_len=3, blocks_per_frame=5)
    cases = [(TINY, 8000, 2 * S + 7), (TINY, 44100, 0), (odd, 96000, 1), (TINY, 22050, 5 * S + 31),
             (odd, 16000, 40), (TINY, 48000, S)]
    paths, arrays = [], []
    for i, (p, rate, n) in enumerate(cases):
        arrays.append(_signal(60 + i, n))
        paths.append(tmp_path / f"a{i}.x3a")
        paths[-1].write_bytes(ref_archive.build_archive_header(rate, p) + oracle.encode(arrays[-1], p))
    return paths, arrays


def _truncate(path, n: int) -> None:
    """Cut the last n bytes of a file: its last payload then overruns."""
    data = path.read_bytes()
    path.write_bytes(data[:-n])


# (archive, frame, kind) of each damage: archives 0, 1, 3 and 5 are one
# group (TINY) and 2 and 4 the other, decoded after it; archive 3 has 6
# frames, 0 and 4 have 3.
BATCH_DAMAGE = {
    "clean": [],
    "crc": [(3, 3, "crc")],
    "decode-then-crc": [(0, 1, "decode"), (3, 3, "crc")],
    "decode-then-crc-in-a-later-group": [(0, 2, "decode"), (4, 1, "crc")],
    "crc-then-header": [(0, 2, "crc"), (3, 1, "header")],
    "header": [(4, 0, "header")],
    "truncated-payload": [(3, None, "truncate")],
}


def damaged_batch_set(tmp_path, case):
    paths, arrays = _batch_set(tmp_path)
    for ai, fi, kind in BATCH_DAMAGE[case]:
        if kind == "truncate":
            _truncate(paths[ai], 5)
        else:
            _damage(paths[ai], fi, kind)
    return paths, arrays


def wav_outcomes(fn, outs):
    res = raised(fn)
    return res, [o.read_bytes() if o.exists() else None for o in outs]


@pytest.mark.parametrize("batch", [1, 3, None])
@pytest.mark.parametrize("case", list(BATCH_DAMAGE))
def test_x3a_to_wav_batch_like_x3_tpu(tmp_path, case, batch):
    """Counts and WAVs, or the raised class and message and every WAV
    written before it, equal x3_tpu's."""
    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port

    paths, arrays = damaged_batch_set(tmp_path, case)
    outs = {who: [tmp_path / f"{who}{i}.wav" for i in range(len(paths))] for who in ("port", "ref")}
    for who in outs:
        outs[who][2].write_bytes(b"\x01" * 5000)  # stale, longer than the WAV
    got = wav_outcomes(lambda: port.x3a_to_wav_batch(paths, outs["port"], batch, device="cpu"), outs["port"])
    want = wav_outcomes(lambda: ref.x3a_to_wav_batch(paths, outs["ref"], batch), outs["ref"])
    assert got == want
    assert (got[0][0] == "ok") == (case == "clean")
    if case == "clean":
        assert got[0][1] == [len(a) for a in arrays]


@pytest.mark.parametrize("batch", [1, 3, None])
@pytest.mark.parametrize("case", list(BATCH_DAMAGE))
def test_decode_streams_like_x3_tpu(tmp_path, case, batch):
    """Outputs, or the raised class and message, equal x3_tpu's: a CRC
    mismatch in a later group wins over an earlier group's decode error,
    and over a later archive's bad header."""
    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port

    paths, arrays = damaged_batch_set(tmp_path, case)
    archives = [p.read_bytes() for p in paths]

    def as_bytes(res):
        return [(x.dtype.str, x.tobytes(), rate) for x, rate in res]

    got = raised(lambda: as_bytes(port.decode_streams(archives, batch, device="cpu")))
    want = raised(lambda: as_bytes(ref.decode_streams(archives, batch)))
    assert got == want
    if case == "clean":
        assert [np.frombuffer(x, "<i2").tolist() for _, x, _ in got[1]] == [a.tolist() for a in arrays]
    if case == "decode-then-crc-in-a-later-group":
        assert got[1] == ("FrameHeaderInvalidPayloadCRC", "archive 4 frame 1 payload CRC mismatch")


# (archives of the batch set, batch_frames, damage, the copy that raises,
# batches): archive 3 has 6 TINY frames; the whole set is two groups.
SCATTER_CASES = {
    "one-batch": ([3], None, "clean", None, 1),
    "one-batch-crc": ([3], None, "crc", None, 1),
    "one-archive-batches-of-2": ([3], 2, "clean", None, 3),
    "mixed-archives-batches-of-3": ([0, 1, 2, 3, 4, 5], 3, "clean", None, 6),
    "mixed-decode-then-crc-in-a-later-group": ([0, 1, 2, 3, 4, 5], 3, "decode-then-crc-in-a-later-group", None, 6),
    "mixed-crc-then-header": ([0, 1, 2, 3, 4, 5], 3, "crc-then-header", None, 2),
    "copy-raises-one-batch": ([3], None, "clean", 0, 1),
    "copy-raises-batches-of-2": ([3], 2, "clean", 1, 3),
    "copy-raises-decode-then-crc": ([0, 1, 2, 3, 4, 5], 3, "decode-then-crc", 0, 6),
}


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_decode_streams_scatter_worker(tmp_path, monkeypatch, case):
    """decode_streams copies a batch into the outputs on a scatter worker
    where the call has two or more batches, and on the caller's thread,
    with no worker, where it has one: outputs and errors equal x3_tpu's
    either way; an error of a copy is raised by the call, before any CRC
    or decode error; and no thread outlives the call."""
    import threading

    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port

    select, batch, damage, fail_at, n_batches = SCATTER_CASES[case]
    paths, _ = damaged_batch_set(tmp_path, damage)
    archives = [paths[i].read_bytes() for i in select]
    copies, workers = [], []
    real_scatter, real_writer = port._scatter, port.AsyncWriter

    def scatter(outs, dec, runs):
        copies.append(threading.get_ident())
        if len(copies) - 1 == fail_at:
            raise MemoryError("copy failed")
        real_scatter(outs, dec, runs)

    def writer(*a, **k):
        workers.append(real_writer(*a, **k))
        return workers[-1]

    monkeypatch.setattr(port, "_scatter", scatter)
    monkeypatch.setattr(port, "AsyncWriter", writer)
    threads = threading.active_count()
    got = raised(lambda: [(x.tobytes(), rate) for x, rate in port.decode_streams(archives, batch, device="cpu")])
    assert threading.active_count() == threads
    assert len(copies) == n_batches and len(workers) == (n_batches > 1)
    me = threading.get_ident()
    assert all((t != me) == (n_batches > 1) for t in copies) and len(set(copies)) == 1
    if fail_at is not None:
        assert got == ("raise", ("MemoryError", "copy failed"))
    else:
        assert got == raised(lambda: [(x.tobytes(), rate) for x, rate in ref.decode_streams(archives, batch)])
        assert (got[0] == "ok") == (damage == "clean")


# ---- decode_streams' large outputs on recycled pages (utils.outpool) ----

POOL_MIN = 64  # bytes: the threshold the tests set, so outputs of 32 samples or more are pooled


@pytest.fixture
def pool(monkeypatch):
    """A pool of its own for the test, which takes every output of
    POOL_MIN bytes or more: archives 0, 3, 4 and 5 of the batch set."""
    from x3_tpu_torch.utils import outpool

    monkeypatch.setattr(outpool, "THRESHOLD_BYTES", POOL_MIN)
    monkeypatch.setattr(outpool, "POOL", outpool.OutputPool())
    return outpool.POOL


def _pooled_call(fn):
    """raised(fn) and the (pooled_bytes, reused_bytes) of the allocation
    of the one decode_streams call fn makes on this thread."""
    import threading
    import time

    from x3_tpu_torch.utils import profiling

    t0 = time.perf_counter_ns()
    res = raised(fn)
    me = threading.get_ident()
    alloc, = [s for s in profiling.spans(t0) if s.start_ns >= t0 and s.thread == me and "pooled_bytes" in s.counts]
    return res, (alloc.counts["pooled_bytes"], alloc.counts["reused_bytes"])


def _pooled_bytes(arrays) -> int:
    return sum(2 * len(a) for a in arrays if 2 * len(a) >= POOL_MIN)


@pytest.mark.parametrize("batch", [1, 3, None])
def test_decode_streams_reuses_a_dropped_output(tmp_path, pool, batch):
    """The first call maps a block for each output of 32 samples or more;
    once its outputs are dropped, a second call gets each block back at
    the same address, every byte counted as reused; both calls give
    x3_tpu's outputs."""
    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port

    paths, arrays = _batch_set(tmp_path)
    archives = [p.read_bytes() for p in paths]
    want = [(x.tobytes(), rate) for x, rate in ref.decode_streams(archives, batch)]
    pooled = _pooled_bytes(arrays)
    (_, got), counts = _pooled_call(lambda: port.decode_streams(archives, batch, device="cpu"))
    assert counts == (pooled, 0) and pool.free_bytes == 0
    assert [(x.tobytes(), rate) for x, rate in got] == want
    at = [x.ctypes.data for x, _ in got if x.base is not None]
    assert len(at) == 4
    del got
    assert pool.free_bytes == pooled
    (_, got), counts = _pooled_call(lambda: port.decode_streams(archives, batch, device="cpu"))
    assert counts == (pooled, pooled) and pool.free_bytes == 0
    assert [(x.tobytes(), rate) for x, rate in got] == want
    assert [x.ctypes.data for x, _ in got if x.base is not None] == at
    for x, _ in got:
        assert x.dtype == np.int16 and x.flags.c_contiguous and x.flags.writeable and x.ndim == 1


HELD_VIEWS = {
    "every-other": lambda x: x[::2],
    "reshape": lambda x: x.reshape(-1, 1),
    "memoryview": memoryview,
    "torch": lambda x: __import__("torch").from_numpy(x),
}


@pytest.mark.parametrize("view", list(HELD_VIEWS))
def test_decode_streams_never_reuses_a_held_output(tmp_path, pool, view):
    """A view, reshape or buffer of an output held after the output itself
    is dropped keeps its block out of the pool: the next call maps a new
    one, shares no memory with the view, and the view's values stay as
    they were; once the view goes, its block serves the call after."""
    from x3_tpu_torch import multifile as port

    paths, arrays = _batch_set(tmp_path)
    archives = [paths[3].read_bytes()]  # 191 samples, 6 frames: 3 batches of 2
    (_, [(out, _)]), _ = _pooled_call(lambda: port.decode_streams(archives, 2, device="cpu"))
    held = HELD_VIEWS[view](out)
    kept = np.asarray(held).copy()
    del out
    assert pool.free_bytes == 0
    (_, [(second, _)]), counts = _pooled_call(lambda: port.decode_streams(archives, 2, device="cpu"))
    assert counts == (2 * len(arrays[3]), 0)
    assert not np.shares_memory(np.asarray(held), second)
    assert np.array_equal(np.asarray(held), kept) and np.array_equal(second, arrays[3])
    second[:] = -1  # a write to the new block does not reach the held view
    assert np.array_equal(np.asarray(held), kept)
    del held
    assert pool.free_bytes == 2 * len(arrays[3])
    (_, [(third, _)]), counts = _pooled_call(lambda: port.decode_streams(archives, 2, device="cpu"))
    assert counts == (2 * len(arrays[3]),) * 2
    assert np.array_equal(third, arrays[3]) and not np.shares_memory(third, second)


def test_decode_streams_pool_across_threads_and_its_cap(tmp_path, pool):
    """Outputs whose last reference goes on another thread give their
    blocks back there; the pool keeps free blocks only up to the bytes of
    the most recent call, so of two calls' outputs dropped one after the
    other, the second's blocks are unmapped: a call gets the first's back,
    and the call after it, with that one held, maps new blocks.  A call
    whose outputs are all under the threshold lets go of every free block."""
    import threading

    from x3_tpu_torch import multifile as port

    paths, arrays = _batch_set(tmp_path)
    archives = [p.read_bytes() for p in paths]
    pooled = _pooled_bytes(arrays)
    first = [port.decode_streams(archives, 3, device="cpu")]
    second = port.decode_streams(archives, 3, device="cpu")
    dropper = threading.Thread(target=first.clear)
    dropper.start()
    dropper.join()
    assert pool.free_bytes == pooled
    del second
    assert pool.free_bytes == pooled  # the cap: one call's bytes
    (_, third), counts = _pooled_call(lambda: port.decode_streams(archives, 3, device="cpu"))
    assert counts == (pooled, pooled) and pool.free_bytes == 0
    (_, fourth), counts = _pooled_call(lambda: port.decode_streams(archives, 3, device="cpu"))
    assert counts == (pooled, 0)
    for (x, _), (y, _), a in zip(third, fourth, arrays):
        assert np.array_equal(x, a) and np.array_equal(y, a) and not np.shares_memory(x, y)
    del third, fourth, x, y
    assert pool.free_bytes == pooled
    (_, small), counts = _pooled_call(lambda: port.decode_streams(archives[1:3], 3, device="cpu"))
    assert counts == (0, 0) and pool.free_bytes == 0  # a call with nothing pooled keeps nothing
    assert [x.tobytes() for x, _ in small] == [a.tobytes() for a in arrays[1:3]]


@pytest.mark.parametrize("batch", [1, 3])
def test_decode_streams_small_outputs_skip_the_pool(tmp_path, batch):
    """At the module's threshold (32 MiB) the batch set's outputs are
    np.empty's own arrays, and the allocation counts no pooled bytes."""
    from x3_tpu_torch import multifile as port
    from x3_tpu_torch.utils import outpool

    assert outpool.THRESHOLD_BYTES == 32 << 20
    paths, arrays = _batch_set(tmp_path)
    archives = [p.read_bytes() for p in paths]
    (_, got), counts = _pooled_call(lambda: port.decode_streams(archives, batch, device="cpu"))
    assert counts == (0, 0)
    for (x, _), a in zip(got, arrays):
        assert x.base is None and x.flags.owndata and np.array_equal(x, a)


@pytest.mark.parametrize("view", list(HELD_VIEWS))
def test_pooled_output_is_an_array_over_a_mapping(pool, view):
    """A pooled output is np.frombuffer over an mmap.mmap, a type that
    exports its buffer from C on every Python the package takes: no class
    of the pool's own defines __buffer__.  The output's finalizer returns
    the block, so what the reuse rule rests on is that every view, reshape
    and buffer of the output holds the output itself, not only the mapping."""
    import gc
    import mmap

    from x3_tpu_torch.utils import outpool

    assert not [c for c in vars(outpool).values() if isinstance(c, type) and "__buffer__" in vars(c)]
    [out], pooled, reused = pool.take([100])
    assert (pooled, reused) == (200, 0) and type(out) is np.ndarray
    owner = out.base.obj if isinstance(out.base, memoryview) else out.base
    assert type(owner) is mmap.mmap and not out.flags.owndata
    for v in (out[::2], out.reshape(-1, 1), out[1:][::3], out.view(np.uint16)):
        assert v.base is out
    held = HELD_VIEWS[view](out[3:])
    out[:] = 7
    del out, v
    gc.collect()
    assert pool.free_bytes == 0  # the view holds the block
    del held
    assert pool.free_bytes == 200


def test_output_pool_resident_memory(pool):
    """What stays resident after a call's large outputs are dropped, read
    from /proc/self/statm: eight outputs of 8 MiB, filled as the scatter
    fills them, stay mapped once dropped (64 MiB, one call's bytes); a
    take of one output keeps one free block beside it and lets go of six;
    a take of only small outputs lets go of the rest."""
    import os

    mib = 1 << 20

    def rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def near(grown: int, want_mib: int) -> bool:
        return abs(grown - want_mib * mib) <= 6 * mib

    base = rss()
    outs, pooled, _ = pool.take([4 * mib] * 8)
    for out in outs:
        out[:] = 1
    assert pooled == 64 * mib and near(rss() - base, 64)
    del outs, out
    assert pool.free_bytes == 64 * mib and near(rss() - base, 64)
    [one], _, reused = pool.take([4 * mib])
    assert reused == 8 * mib and (one == 1).all()
    assert pool.free_bytes == 8 * mib and near(rss() - base, 16)
    del one
    assert pool.free_bytes == 8 * mib and near(rss() - base, 8)
    [small], pooled, _ = pool.take([10])
    assert pooled == 0 and pool.free_bytes == 0 and near(rss() - base, 0)


def test_output_pool_under_threads(pool):
    """Thirty-two threads take, fill, check and drop pooled outputs of a few
    sizes at once, with a short switch interval, each holding its last
    three: no live output ever shares a block with another (each keeps
    its fill), and the pool's count of free bytes ends equal to its free
    blocks' bytes, within one take's."""
    import sys
    import threading

    sizes = [40, 56, 64, 100]  # samples: best fits within twice the size and outside it
    errors = []

    def body(k):
        try:
            held = []
            for i in range(200):
                n = sizes[(k + i) % len(sizes)]
                [out], pooled, reused = pool.take([n])
                assert pooled == 2 * n and reused in (0, pooled)
                out[:] = k * 100 + i
                held.append((out, k * 100 + i))
                if len(held) > 3:
                    held.pop(0)
                for x, v in held:
                    assert (x == v).all()
        except BaseException as e:  # noqa: BLE001 - re-raised on the test's thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=body, args=(k,)) for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert pool.free_bytes == sum(len(mm) for mm in pool._free) <= 2 * max(sizes)


@pytest.mark.parametrize("case", [c for c, v in SCATTER_CASES.items() if v[2] != "clean" and v[3] is None])
def test_decode_streams_errors_with_the_pool(tmp_path, pool, case):
    """The damaged cases of test_decode_streams_scatter_worker with every
    output of 32 samples or more pooled: the raised class and message are
    x3_tpu's; the failed call's blocks come back to the pool, and the next
    call on the clean archives, served from them, gives x3_tpu's outputs
    (no sample of the failed call shows)."""
    import gc

    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port

    select, batch, damage, _, _ = SCATTER_CASES[case]
    for d in ("damaged", "clean"):
        (tmp_path / d).mkdir()
    paths, arrays = damaged_batch_set(tmp_path / "damaged", damage)
    archives = [paths[i].read_bytes() for i in select]
    got, (pooled, _) = _pooled_call(lambda: [x.tobytes() for x, _ in port.decode_streams(archives, batch, device="cpu")])
    assert got[0] == "raise" and got == raised(lambda: [x.tobytes() for x, _ in ref.decode_streams(archives, batch)])
    gc.collect()
    assert pooled > 0 and pool.free_bytes == pooled
    clean, _ = _batch_set(tmp_path / "clean")
    archives = [clean[i].read_bytes() for i in select]
    (_, out), counts = _pooled_call(lambda: port.decode_streams(archives, batch, device="cpu"))
    assert counts == (_pooled_bytes([arrays[i] for i in select]), pooled)
    assert [x.tobytes() for x, _ in out] == [arrays[i].tobytes() for i in select]


@pytest.mark.parametrize("case", ["clean", "decode-then-crc", "crc-then-header"])
def test_batch_decodes_on_a_mesh_like_x3_tpu(tmp_path, case):
    """With a 2-entry CPU mesh (batches of 3 rounded to 4) both batch
    decodes give what they give without one at 4 frames a batch, and what
    x3_tpu gives there."""
    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port
    from x3_tpu_torch.parallel.mesh import make_mesh

    paths, _ = damaged_batch_set(tmp_path, case)
    mesh = make_mesh(["cpu"] * 2)
    runs = {"mesh": lambda o: port.x3a_to_wav_batch(paths, o, 3, mesh=mesh, device="cpu"),
            "none": lambda o: port.x3a_to_wav_batch(paths, o, 4, device="cpu"),
            "ref": lambda o: ref.x3a_to_wav_batch(paths, o, 4)}
    results = []
    for who, fn in runs.items():
        outs = [tmp_path / f"{who}{i}.wav" for i in range(len(paths))]
        results.append(wav_outcomes(lambda: fn(outs), outs))
    assert results[0] == results[1] == results[2]
    archives = [p.read_bytes() for p in paths]
    streams = [raised(lambda: [x.tobytes() for x, _ in fn()]) for fn in (
        lambda: port.decode_streams(archives, 3, mesh=mesh, device="cpu"),
        lambda: port.decode_streams(archives, 4, device="cpu"),
        lambda: ref.decode_streams(archives, 4))]
    assert streams[0] == streams[1] == streams[2]


def _x3m_set(tmp_path, n: int, mixed: bool = False):
    """A 3-channel capture of n samples a channel encoded by x3_tpu; with
    `mixed`, channel 1's archive is of other Parameters (block_len 3), so
    that a window decodes in two calls."""
    import json

    from x3_tpu import multichannel as ref
    from x3_tpu.params import Parameters

    if n >= 12:
        chans = capture(11, n)
    else:  # capture's mixed signal needs more samples
        from tests.conftest import make_hydrophone

        rng = np.random.default_rng(11)
        chans = np.stack([make_hydrophone(rng, n) for _ in range(3)])
    d = tmp_path / "x3m"
    d.mkdir()
    mpath = ref.encode_multichannel(chans, 48_000, d / "cap.x3m", SHORT)
    if mixed:
        ref.encode_multichannel(chans, 48_000, d / "odd.x3m", Parameters(block_len=3, blocks_per_frame=200))
        m = json.loads(mpath.read_text())
        m["files"][1] = "odd.ch1.x3a"
        mpath.write_text(json.dumps(m))
    return mpath, chans


@pytest.mark.parametrize("batch", [1, 3, None])
@pytest.mark.parametrize("kind", ["one-sample", "empty", "mixed-params"])
def test_x3m_to_wav_edges_like_x3_tpu(tmp_path, kind, batch):
    """x3m_to_wav of a capture of one sample, of none, and of channels of
    two Parameters (frames of 600 samples in windows of 1,000 a frame of
    the first channel's XML), equal to x3_tpu's WAV and to the capture."""
    from x3_tpu_torch import multichannel as port

    n = {"one-sample": 1, "empty": 0, "mixed-params": 2 * 600 + 345}[kind]
    mpath, chans = _x3m_set(tmp_path, n, mixed=kind == "mixed-params")
    got, want = x3m_outcomes(mpath, tmp_path, batch)
    assert got == want
    assert got[0] == ("ok", 3)
    back, rate = port.read_wav_multichannel(tmp_path / "port.wav")
    assert rate == 48_000 and back.shape == (3, n)
    np.testing.assert_array_equal(back, chans)


@pytest.mark.parametrize("batch", [1, 3, None])
def test_x3m_to_wav_clean_like_x3_tpu(x3m_clean, tmp_path, batch):
    from x3_tpu_torch import multichannel as port

    mpath, chans = _x3m_copy(x3m_clean, tmp_path / "cap")
    got, want = x3m_outcomes(mpath, tmp_path, batch)
    assert got == want and got[0] == ("ok", 3)
    np.testing.assert_array_equal(port.read_wav_multichannel(tmp_path / "port.wav")[0], chans)


# ---- (d) sequential reads: a read a run or chunk, none a frame ----


class CountingFile:
    """A binary file that counts its seeks and reads."""

    counts = {"seek": 0, "read": 0, "readinto": 0}

    def __init__(self, f):
        self._f = f

    def seek(self, *a):
        CountingFile.counts["seek"] += 1
        return self._f.seek(*a)

    def read(self, *a):
        CountingFile.counts["read"] += 1
        return self._f.read(*a)

    def readinto(self, b):
        CountingFile.counts["readinto"] += 1
        return self._f.readinto(b)

    def tell(self):
        return self._f.tell()

    def close(self):
        self._f.close()


@pytest.fixture
def no_frame_walks(monkeypatch):
    """The per-frame walkers and X3aReader raise if any path calls them, and
    every file that multifile and multichannel open counts its reads."""
    from x3_tpu_torch import archive, files, multichannel, multifile

    def refuse(*a, **k):
        raise AssertionError("a per-frame walk on a sequential-read path")

    for mod, name in ((archive, "walk_frames_file"), (archive, "walk_frames"), (files, "X3aReader")):
        monkeypatch.setattr(mod, name, refuse)
    assert not hasattr(multifile, "_payload_crcs_ok")
    CountingFile.counts = dict.fromkeys(CountingFile.counts, 0)
    for mod in (multifile, multichannel):
        monkeypatch.setattr(mod, "open", lambda p, mode="r": CountingFile(open(p, mode)), raising=False)
    return CountingFile.counts


@pytest.mark.parametrize("n_frames", [40, 400])
def test_x3a_to_wav_batch_reads_a_run_at_a_time(tmp_path, no_frame_walks, n_frames):
    """Three archives of n_frames TINY frames each at 64 frames a batch:
    the reads and seeks are O(batches + archives), the same at 40 and 400
    frames an archive per batch, and the WAVs equal the inputs."""
    from tests.test_torch_files import TINY, signal, write_wav
    from x3_tpu import archive as ref_archive
    from x3_tpu.models import oracle

    from x3_tpu_torch import multifile as port

    S = TINY.samples_per_frame
    paths, wavs = [], []
    for i in range(3):
        x = signal(70 + i, n_frames * S - 5)
        wavs.append(write_wav(tmp_path / f"in{i}.wav", x, 8000))
        paths.append(tmp_path / f"a{i}.x3a")
        paths[-1].write_bytes(ref_archive.build_archive_header(8000, TINY) + oracle.encode(x, TINY))
    outs = [tmp_path / f"out{i}.wav" for i in range(3)]
    assert port.x3a_to_wav_batch(paths, outs, 64, device="cpu") == [n_frames * S - 5] * 3
    assert [o.read_bytes() for o in outs] == [w.read_bytes() for w in wavs]
    batches = -(-3 * n_frames // 64)
    runs = batches + 3  # a batch holds at most one run an archive, and 2 where an archive ends
    # Per archive: the header (a seek and two reads), the size, one index
    # read; per run: a seek and a read.
    assert no_frame_walks["read"] + no_frame_walks["readinto"] <= 3 * 3 + runs
    assert no_frame_walks["seek"] <= 3 * 4 + runs
    assert no_frame_walks["read"] + no_frame_walks["readinto"] < n_frames


def test_decode_streams_never_walks_per_frame(tmp_path, no_frame_walks):
    from x3_tpu_torch import multifile as port

    paths, arrays = _batch_set(tmp_path)
    got = port.decode_streams([p.read_bytes() for p in paths], 3, device="cpu")
    assert [x.tolist() for x, _ in got] == [a.tolist() for a in arrays]


@pytest.mark.parametrize("batch", [1, None])
def test_x3m_to_wav_reads_a_run_at_a_time(x3m_clean, tmp_path, no_frame_walks, batch):
    """Each channel is indexed in one read and each window reads one run a
    channel: at batch_frames 1, seven windows of 3 channels."""
    from x3_tpu_torch import multichannel as port

    mpath, chans = _x3m_copy(x3m_clean, tmp_path / "cap")
    assert port.x3m_to_wav(mpath, tmp_path / "out.wav", batch_frames=batch, device="cpu") == 3
    np.testing.assert_array_equal(port.read_wav_multichannel(tmp_path / "out.wav")[0], chans)
    windows = -(-X3M_SAMPLES // (1000 if batch == 1 else 768_000))
    assert no_frame_walks["read"] + no_frame_walks["readinto"] == 3 * 3 + 3 * windows


# ---- the parts under the three paths ----


@pytest.mark.parametrize("width", [0, 2, 16, 30])
def test_crc16_pairs_like_crc16_many(width):
    """The two-bytes-a-gather CRC of the header check equals x3_tpu's host
    crc16_many on rows of one even width."""
    from x3_tpu.ops.crc import crc16_many as ref_many

    from x3_tpu_torch.ops.crc import crc16_pairs

    rows = np.random.default_rng(width).integers(0, 256, (257, width)).astype(np.uint8)
    got = crc16_pairs(rows)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, ref_many(rows, np.full(len(rows), width)))


def test_shared_writer_wavs_like_wave(tmp_path):
    """Three WavWriters on one AsyncWriter, their writes interleaved and
    each closed before the writer drains, give the wave module's bytes;
    a write error of one file is raised by the writer's close, after the
    closers queued behind it ran."""
    import wave

    from x3_tpu_torch.utils.io import AsyncWriter
    from x3_tpu_torch.utils.wav import WavWriter

    rng = np.random.default_rng(4)
    data = [rng.integers(-2**15, 2**15, n).astype(np.int16) for n in (0, 777, 5000)]
    shared = AsyncWriter(None, depth=3)
    writers = [WavWriter(tmp_path / f"got{k}.wav", 8000 * (k + 1), writer=shared) for k in range(3)]
    for part in range(4):
        for w, x in zip(writers, data):
            w.write(np.array_split(x, 4)[part])
    for w in writers:
        w.close()
    shared.close()
    for k, x in enumerate(data):
        with wave.open(str(tmp_path / f"want{k}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(8000 * (k + 1))
            w.writeframes(x.tobytes())
        assert (tmp_path / f"got{k}.wav").read_bytes() == (tmp_path / f"want{k}.wav").read_bytes()

    class Broken:
        def write(self, data):
            raise OSError("disk full")

    ran = []
    shared = AsyncWriter(None)
    shared.write((Broken(), b"x"))
    shared.call(lambda: ran.append("closer"))
    with pytest.raises(OSError, match="disk full"):
        shared.close()
    assert ran == ["closer"]

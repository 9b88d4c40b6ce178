"""The port's file layer on the CPU (device="cpu"): wav_to_x3a, x3a_to_wav,
x3a_info, verify_x3a, X3aReader, StreamEncoder, the channel types, the CLI
and wav_to_str, against x3_tpu's under engine="jax" and engine="numpy".
Archives and WAVs must be byte-identical; damage must raise the same error
class, or give the same frame-error count and the same WAV; reports must
be the same dicts (the engine's name aside).  Small geometry (TINY, 32
samples a frame), since XLA:CPU compile time grows fast with the decode
width."""

import dataclasses
import io
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

import x3_tpu_torch as xt
from tests.conftest import make_hydrophone, make_mixed
from x3_tpu.params import Parameters

REPO = Path(__file__).resolve().parent.parent
TINY = Parameters(block_len=4, blocks_per_frame=8)
S = TINY.samples_per_frame
RATE = 8000
ENGINES = ("jax", "numpy")


def port_params(p: Parameters) -> xt.Parameters:
    return xt.Parameters(**dataclasses.asdict(p))


def outcome(fn):
    """("ok", fn()) or ("raise", the exception's class name)."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return "raise", type(e).__name__


def write_wav(path, samples, rate=RATE):
    from x3_tpu_torch.utils.wav import write_wav as w

    w(path, samples, rate)
    return path


def signal(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([make_mixed(rng, n // 2), make_hydrophone(rng, n - n // 2)])


# ---- encode: archives byte for byte ----


@pytest.mark.parametrize("batch", [1, 3, None])
@pytest.mark.parametrize("tail", [0, 1, S - 1, S, S + 1])
def test_wav_to_x3a_bytes(tmp_path, tail, batch):
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    wav = signal(tail, 5 * S + tail)
    src = write_wav(tmp_path / "in.wav", wav)
    got = port.wav_to_x3a(src, tmp_path / "port.x3a", port_params(TINY), batch_frames=batch, device="cpu")
    data = (tmp_path / "port.x3a").read_bytes()
    for engine in ENGINES:
        want = ref.wav_to_x3a(src, tmp_path / f"{engine}.x3a", TINY, engine=engine, batch_frames=batch)
        assert data == (tmp_path / f"{engine}.x3a").read_bytes(), engine
        np.testing.assert_array_equal(got.stats, want.stats)
        assert got.nbytes == want.nbytes
    assert data.startswith(xt.build_archive_header(RATE, port_params(TINY)))


def test_wav_to_x3a_default_params_and_verbose(tmp_path, capsys):
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    src = write_wav(tmp_path / "in.wav", make_hydrophone(np.random.default_rng(5), 2 * 10000 + 17), 96000)
    port.wav_to_x3a(src, tmp_path / "port.x3a", verbose=True, device="cpu")
    got = capsys.readouterr().out
    ref.wav_to_x3a(src, tmp_path / "ref.x3a", engine="numpy", verbose=True)
    assert got == capsys.readouterr().out and "Rice-0" in got
    assert (tmp_path / "port.x3a").read_bytes() == (tmp_path / "ref.x3a").read_bytes()


@pytest.mark.parametrize("kind", ["x3a", "wav"])
def test_overwriting_a_longer_output_truncates_it(tmp_path, kind):
    from x3_tpu_torch import files as port

    long_src = write_wav(tmp_path / "long.wav", signal(1, 40 * S + 3))
    short = signal(2, 3 * S + 5)
    short_src = write_wav(tmp_path / "short.wav", short)
    p = port_params(TINY)
    if kind == "x3a":
        out = tmp_path / "out.x3a"
        port.wav_to_x3a(long_src, out, p, device="cpu")
        port.wav_to_x3a(short_src, out, p, device="cpu")
        port.wav_to_x3a(short_src, tmp_path / "fresh.x3a", p, device="cpu")
        assert out.read_bytes() == (tmp_path / "fresh.x3a").read_bytes()
    else:
        port.wav_to_x3a(long_src, tmp_path / "long.x3a", p, device="cpu")
        port.wav_to_x3a(short_src, tmp_path / "short.x3a", p, device="cpu")
        out = tmp_path / "back.wav"
        assert port.x3a_to_wav(tmp_path / "long.x3a", out, device="cpu") == 0
        assert port.x3a_to_wav(tmp_path / "short.x3a", out, device="cpu") == 0
        assert out.read_bytes() == short_src.read_bytes()


def _odd_wav(path, kind):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2 if kind == "stereo" else 1)
        w.setsampwidth(1 if kind == "8-bit" else 2)
        w.setframerate(44100)
        w.writeframes(b"\x00" * 400)
    return path


@pytest.mark.parametrize("entry", ["wav_to_x3a", "wav_to_x3a_streaming", "read_wav"])
@pytest.mark.parametrize("kind", ["stereo", "8-bit"])
def test_wav_format_rejections(tmp_path, kind, entry):
    import x3_tpu.files
    import x3_tpu.utils.wav

    import x3_tpu_torch.files
    import x3_tpu_torch.streaming
    import x3_tpu_torch.utils.wav

    src = _odd_wav(tmp_path / "odd.wav", kind)
    calls = {
        "wav_to_x3a": (lambda o: x3_tpu.files.wav_to_x3a(src, o, engine="numpy"),
                       lambda o: x3_tpu_torch.files.wav_to_x3a(src, o, device="cpu")),
        # x3_tpu's streaming path only asserts the format; the port's raises
        # wav_to_x3a's errors (an assert vanishes under python -O).
        "wav_to_x3a_streaming": (lambda o: x3_tpu.files.wav_to_x3a(src, o, engine="numpy"),
                                 lambda o: x3_tpu_torch.streaming.wav_to_x3a_streaming(src, o, device="cpu")),
        "read_wav": (lambda o: x3_tpu.utils.wav.read_wav(src), lambda o: x3_tpu_torch.utils.wav.read_wav(src)),
    }
    ref, port = calls[entry]
    want = outcome(lambda: ref(tmp_path / "ref.x3a"))
    assert want[0] == "raise"
    assert outcome(lambda: port(tmp_path / "port.x3a")) == want


# ---- decode, info and verify on clean and damaged archives ----

N_FRAMES = 9


@pytest.fixture(scope="module")
def arch(tmp_path_factory):
    """A 9-frame TINY archive (partial last frame) and its source."""
    from x3_tpu import archive
    from x3_tpu.files import wav_to_x3a

    td = tmp_path_factory.mktemp("torch_files")
    wav = signal(11, (N_FRAMES - 1) * S + 13)
    src = write_wav(td / "src.wav", wav)
    wav_to_x3a(src, td / "src.x3a", TINY, engine="numpy")
    data = (td / "src.x3a").read_bytes()
    _, hdr_end = archive.parse_archive_header(data)
    idx = list(archive.walk_frames(data, hdr_end))
    assert len(idx) == N_FRAMES
    return dict(data=data, hdr_end=hdr_end, idx=idx, wav=wav, td=td)


def _restamp(data: bytearray, payload_off: int, h) -> None:
    """Rewrite a frame's header with its payload's current CRC."""
    from x3_tpu.models.encoder import build_frame_headers
    from x3_tpu.ops.crc import crc16

    crc = crc16(bytes(data[payload_off : payload_off + h.payload_len]))
    hdr = build_frame_headers(np.asarray([h.samples]), 1, np.asarray([h.payload_len]), np.asarray([crc]))
    data[payload_off - 20 : payload_off] = np.asarray(hdr)[0].tobytes()


DAMAGES = ["clean", "payload-byte", "decode-error", "header-byte", "corrupt-key", "truncate-payload",
           "truncate-header", "archive-header", "delete-frame", "garbage-between", "trailing-junk"]


def damaged(arch, kind: str) -> bytes:
    """The archive with one kind of damage, at frame 2 where it is a frame's."""
    data = bytearray(arch["data"])
    off, h = arch["idx"][2]
    if kind == "payload-byte":
        data[off + 3] ^= 0x10
    elif kind == "decode-error":
        data[off + 2] = 0b00_0010_00  # BFP block of 3 bits; the CRC re-stamped
        _restamp(data, off, h)
    elif kind == "header-byte":
        data[off - 20 + 5] ^= 0x01
    elif kind == "corrupt-key":
        data[off - 20] = 0x00
    elif kind == "truncate-payload":
        data = data[: arch["idx"][-1][0] + 3]
    elif kind == "truncate-header":
        data = data[: arch["idx"][-1][0] - 9]
    elif kind == "archive-header":
        data[0] ^= 0xFF
    elif kind == "delete-frame":
        del data[off - 20 : off + h.payload_len]
    elif kind == "garbage-between":
        data[off - 20 : off - 20] = b"\x78\x33" + bytes(range(40))
    elif kind == "trailing-junk":
        data += bytes(range(1, 31))
    return bytes(data)


def _archive(arch, kind, tmp_path) -> Path:
    p = tmp_path / f"{kind}.x3a"
    p.write_bytes(damaged(arch, kind))
    return p


def _decode_outcome(fn, out: Path):
    res = outcome(fn)
    return res + ((out.read_bytes() if res[0] == "ok" else None),)


@pytest.mark.parametrize("resync", [False, True], ids=["stop", "resync"])
@pytest.mark.parametrize("kind", DAMAGES)
def test_x3a_to_wav_like_x3_tpu(arch, tmp_path, kind, resync):
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    src = _archive(arch, kind, tmp_path)
    got = _decode_outcome(lambda: port.x3a_to_wav(src, tmp_path / "port.wav", resync=resync, batch_frames=4,
                                                  device="cpu"), tmp_path / "port.wav")
    for engine in ENGINES:
        want = _decode_outcome(lambda: ref.x3a_to_wav(src, tmp_path / "ref.wav", engine=engine,
                                                      resync=resync, batch_frames=4), tmp_path / "ref.wav")
        assert got == want, engine
    if kind == "clean":
        assert got[:2] == ("ok", 0)
        assert got[2] == (arch["td"] / "src.wav").read_bytes()
    if kind in ("payload-byte", "decode-error"):
        assert got[0] == "raise" if (kind, resync) == ("payload-byte", False) else got[1] == 1


@pytest.mark.parametrize("batch", [1, 3, None])
def test_x3a_to_wav_batches_and_verbose(arch, tmp_path, capsys, batch):
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    src = _archive(arch, "clean", tmp_path)
    assert port.x3a_to_wav(src, tmp_path / "port.wav", verbose=True, batch_frames=batch, device="cpu") == 0
    got = capsys.readouterr().out
    assert ref.x3a_to_wav(src, tmp_path / "ref.wav", engine="jax", verbose=True, batch_frames=batch) == 0
    assert got == capsys.readouterr().out and "thresholds" in got
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "ref.wav").read_bytes()


@pytest.mark.parametrize("kind", DAMAGES)
def test_info_and_verify_like_x3_tpu(arch, tmp_path, kind):
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    src = _archive(arch, kind, tmp_path)
    assert outcome(lambda: port.x3a_info(src, device="cpu")) == outcome(lambda: ref.x3a_info(src))
    for batch in (2, None):
        got = port.verify_x3a(src, batch_frames=batch, device="cpu")
        assert got.pop("engine") == "torch"
        for engine in ENGINES:
            want = ref.verify_x3a(src, engine=engine, batch_frames=batch)
            assert want.pop("engine") == engine
            assert got == want, (engine, batch)
    assert got["ok"] == (kind in ("clean", "delete-frame"))


def test_verify_verbose_like_x3_tpu(arch, tmp_path, capsys):
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    for kind in ("garbage-between", "decode-error", "trailing-junk"):
        src = _archive(arch, kind, tmp_path)
        port.verify_x3a(src, verbose=True, device="cpu")
        got = capsys.readouterr().out
        ref.verify_x3a(src, engine="jax", verbose=True)
        assert got == capsys.readouterr().out and got, kind


# ---- X3aReader ----


def _sequence(reader_cls, src, **kw):
    """decode_next_frame until None (or a raise): the frames, frame_errors
    and how it ended."""
    frames = []

    def drain(r):
        while (f := r.decode_next_frame()) is not None:
            frames.append(f)

    with reader_cls(src, batch_frames=3, **kw) as r:
        end = outcome(lambda: drain(r))
        after = outcome(r.decode_next_frame)
        return frames, r.frame_errors, end, after if after[0] == "raise" else after[1] is None


@pytest.mark.parametrize("kind", ["clean", "decode-error", "payload-byte", "delete-frame"])
def test_reader_sequence_like_x3_tpu(arch, tmp_path, kind):
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    src = _archive(arch, kind, tmp_path)
    frames, errors, end, stays = _sequence(port.X3aReader, src, device="cpu")
    for engine in ENGINES:
        want = _sequence(ref.X3aReader, src, engine=engine)
        assert len(frames) == len(want[0]), engine
        for g, w in zip(frames, want[0]):
            np.testing.assert_array_equal(g, w)
        assert (errors, end, stays) == want[1:], engine
    if kind == "decode-error":
        assert (len(frames), errors) == (2, 1)  # stops at frame 2 and stays stopped


def _random_access(r):
    """What a sequence of random-access calls on reader r returns: arrays,
    or outcomes for the calls that raise."""
    n = r.n_samples
    out = [np.asarray([len(r), n, r.spec.sample_rate]), r.sample_offsets]
    out += [r.decode_frame_at(i) for i in (5, 0, N_FRAMES - 1, 3, 4)]  # out of order, across batches
    out += [r[-1], outcome(lambda: r.decode_frame_at(N_FRAMES))]
    for start, count in [(S - 7, 20), (0, 3), (4 * S - 1, 2), (3, 6 * S), (n - 5, 999), (n + 10, 4)]:
        out.append(r.read_samples(start, count))
    for i in (7, 2, N_FRAMES):
        r.seek_frame(i)
        out += [r.tell_frame(), outcome(r.decode_next_frame)]
    out.append(outcome(lambda: r.seek_frame(N_FRAMES + 1)))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, tuple) and g[0] == "ok" and g[1] is not None:
            g, w = g[1], w[1]
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_reader_random_access_like_x3_tpu(arch, tmp_path):
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    src = _archive(arch, "clean", tmp_path)
    wav = arch["wav"]
    with port.X3aReader(src, batch_frames=4, device="cpu") as r:
        got = _random_access(r)
    for engine in ENGINES:
        with ref.X3aReader(src, engine, 4) as w:
            _assert_same(got, _random_access(w))
    np.testing.assert_array_equal(got[7], wav[(N_FRAMES - 1) * S :])
    np.testing.assert_array_equal(got[9], wav[S - 7 : S + 13])
    np.testing.assert_array_equal(got[12], wav[3 : 3 + 6 * S])
    np.testing.assert_array_equal(got[16][1], wav[7 * S : 8 * S])
    assert got[-1] == ("raise", "IndexError") and got[-2] == ("ok", None)


def test_reader_isolates_damage_like_x3_tpu(arch, tmp_path):
    """A frame with a bad payload CRC raises for itself alone; its batch
    neighbours decode, and seeking past it clears the latch."""
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    src = _archive(arch, "payload-byte", tmp_path)
    wav = arch["wav"]
    with port.X3aReader(src, batch_frames=4, device="cpu") as r, ref.X3aReader(src, "jax", 4) as w:
        for i in (0, 2, 1, 3):
            got, want = outcome(lambda: r.decode_frame_at(i)), outcome(lambda: w.decode_frame_at(i))
            assert got[0] == want[0]
            if got[0] == "ok":
                np.testing.assert_array_equal(got[1], want[1])
                np.testing.assert_array_equal(got[1], wav[i * S : (i + 1) * S])
            else:
                assert got == want == ("raise", "FrameHeaderInvalidPayloadCRC")
        for rd in (r, w):
            rd.seek_frame(2)
        assert outcome(r.decode_next_frame)[1] == "FrameHeaderInvalidPayloadCRC"
        assert outcome(w.decode_next_frame)[1] == "FrameHeaderInvalidPayloadCRC"
        r.seek_frame(3)
        np.testing.assert_array_equal(r.decode_next_frame(), wav[3 * S : 4 * S])


def test_reader_decode_error_frame_raises_its_class(arch, tmp_path):
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    src = _archive(arch, "decode-error", tmp_path)
    with port.X3aReader(src, batch_frames=4, device="cpu") as r, ref.X3aReader(src, "jax", 4) as w:
        got = outcome(lambda: r.decode_frame_at(2))
        assert got[0] == "raise" and got == outcome(lambda: w.decode_frame_at(2))
        np.testing.assert_array_equal(r.decode_frame_at(3), w.decode_frame_at(3))


def test_reader_cache_stays_bounded_with_damage_in_every_batch(arch, tmp_path):
    """Each batch of two has a frame with a bad payload CRC: a sweep of
    decode_frame_at keeps at most one batch of frames resident."""
    from x3_tpu_torch import files as port

    data = bytearray(arch["data"])
    for off, _ in arch["idx"][1::2]:
        data[off + 3] ^= 0x10
    src = tmp_path / "bad.x3a"
    src.write_bytes(bytes(data))
    with port.X3aReader(src, batch_frames=2, device="cpu") as r:
        for i in range(0, N_FRAMES, 2):
            np.testing.assert_array_equal(r.decode_frame_at(i), arch["wav"][i * S : (i + 1) * S])
            assert len(r._cache) <= 2
        assert outcome(lambda: r.decode_frame_at(1)) == ("raise", "FrameHeaderInvalidPayloadCRC")


class _CountingFile:
    """An open archive that logs each read as (method, file offset, bytes
    asked)."""

    def __init__(self, f, log):
        self._f, self._log = f, log

    def readinto(self, b):
        self._log.append(("readinto", self._f.tell(), len(b)))
        return self._f.readinto(b)

    def read(self, n=-1):
        self._log.append(("read", self._f.tell(), n))
        return self._f.read(n)

    def __getattr__(self, name):
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()


def _runs_of(entries, batch: int):
    """(offset, bytes) of each run of contiguous frames in each batch of a
    walk's entries: from the run's first payload to its last one's end."""
    runs = []
    for b in range(0, len(entries), batch):
        first = len(runs)
        for off, h in entries[b : b + batch]:
            if len(runs) > first and sum(runs[-1]) == off - 20:  # the header follows the last payload
                runs[-1] = (runs[-1][0], off + h.payload_len - runs[-1][0])
            else:
                runs.append((off, h.payload_len))
    return runs


@pytest.mark.parametrize("entry", ["decode_frame_at", "verify_x3a", "resync"])
def test_batches_read_one_readinto_a_run(arch, tmp_path, monkeypatch, entry):
    """X3aReader.decode_frame_at, verify_x3a and x3a_to_wav(resync=True) on
    an archive with garbage between frames 1 and 2 read each batch with one
    readinto a run of contiguous frames (the scanner's skip cuts a run, and
    its bytes are not read), and give x3_tpu's outcome.  X3aReader cannot
    open that archive: it raises x3_tpu's class and message after its
    sequential index pass, with no read a frame; its batches are read on
    the clean archive."""
    import builtins

    from x3_tpu import archive as ref_archive
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    log = []
    monkeypatch.setattr(port, "open", lambda *a, **k: _CountingFile(builtins.open(*a, **k), log), raising=False)
    src = _archive(arch, "garbage-between", tmp_path)
    data = src.read_bytes()
    reads = lambda: [(o, n) for m, o, n in log if m == "readinto"]  # noqa: E731
    if entry == "verify_x3a":
        got = port.verify_x3a(src, batch_frames=4, device="cpu")
        want = ref.verify_x3a(src, engine="numpy", batch_frames=4)
        assert (got.pop("engine"), want.pop("engine")) == ("torch", "numpy") and got == want
        assert got["skipped_bytes"] == 42
    elif entry == "resync":
        got = _decode_outcome(lambda: port.x3a_to_wav(src, tmp_path / "port.wav", resync=True, batch_frames=4,
                                                      device="cpu"), tmp_path / "port.wav")
        assert got == _decode_outcome(lambda: ref.x3a_to_wav(src, tmp_path / "ref.wav", engine="numpy",
                                                             resync=True, batch_frames=4), tmp_path / "ref.wav")
        assert got[:2] == ("ok", 0)
    if entry != "decode_frame_at":
        entries = list(ref_archive.walk_frames(data, arch["hdr_end"], resync=True))
        assert reads() == _runs_of(entries, 4) and len(reads()) == -(-N_FRAMES // 4) + 1
        return
    def raised(fn):
        with pytest.raises(Exception) as e:  # noqa: PT011 - the class and message are compared
            fn()
        return type(e.value).__name__, str(e.value)

    got = raised(lambda: port.X3aReader(src, batch_frames=4, device="cpu"))
    assert got == raised(lambda: ref.X3aReader(src, "numpy", 4))
    assert got[0] == "FrameHeaderInvalidHeaderCRC"
    assert [m for m, _, _ in log].count("read") == 2  # the archive header's
    src = _archive(arch, "clean", tmp_path)
    with port.X3aReader(src, batch_frames=4, device="cpu") as r, ref.X3aReader(src, "numpy", 4) as w:
        del log[:]
        for i in (5, 0, N_FRAMES - 1, 3):
            np.testing.assert_array_equal(r.decode_frame_at(i), w.decode_frame_at(i))
    assert not [m for m, _, _ in log if m != "readinto"]
    runs = _runs_of(arch["idx"], 4)
    assert reads() == [runs[1], runs[0], runs[2], runs[0]]


# ---- StreamEncoder, wav_to_x3a_streaming and the channel types ----


@pytest.mark.parametrize("batch", [1, 2, 5])
def test_stream_encoder_odd_chunks(tmp_path, batch):
    from x3_tpu import streaming as ref

    from x3_tpu_torch import streaming as port

    wav = signal(batch, 13 * S + 9)
    cuts = np.cumsum([0, 1, 31, 33, 7, 100, 3 * S, 64, 5])
    chunks = np.split(wav, cuts[1:])
    with port.StreamEncoder(tmp_path / "port.x3a", RATE, port_params(TINY), batch_frames=batch,
                            device="cpu") as enc:
        for c in chunks:
            enc.write(c)
        got = enc.close()
    for engine in ENGINES:
        with ref.StreamEncoder(tmp_path / "ref.x3a", RATE, TINY, engine, batch) as enc:
            for c in chunks:
                enc.write(c)
            want = enc.close()
        assert (tmp_path / "port.x3a").read_bytes() == (tmp_path / "ref.x3a").read_bytes(), engine
        np.testing.assert_array_equal(got.stats, want.stats)
        assert got.nbytes == want.nbytes
    assert outcome(lambda: enc.write(wav[:3])) == ("raise", "ValueError")


def test_stream_encoder_carries_rung_hints(tmp_path, monkeypatch):
    """The payload-width and block-width rungs a batch ends at start the
    next batch's ladders: a loud batch raises them, and the quiet batches
    after it start there."""
    from x3_tpu_torch import streaming
    from x3_tpu_torch.ops.encode_kernel import block_width_rungs, width_rungs

    calls = []
    encode = streaming.encode

    def spy(samples, params, **kw):
        res = encode(samples, params, **kw)
        calls.append((kw["width_hint"], kw["block_width_hint"], res.width_used, res.block_width_used))
        return res

    monkeypatch.setattr(streaming, "encode", spy)
    p = xt.Parameters()  # TINY has one rung of each
    spf = p.samples_per_frame
    quiet = np.zeros(2 * spf, np.int16)
    loud = np.random.default_rng(3).integers(-32768, 32768, 2 * spf).astype(np.int16)
    with streaming.StreamEncoder(io.BytesIO(), RATE, p, batch_frames=2, device="cpu") as enc:
        for chunk in (quiet, loud, quiet, quiet):
            enc.write(chunk)
    assert [c[:2] for c in calls] == [(None, None)] + [c[2:] for c in calls[:-1]]
    assert calls[0][2:] == (width_rungs(p)[0], block_width_rungs(p)[0])
    assert calls[1][2] > calls[0][2] and calls[1][3] > calls[0][3]
    assert calls[-1][2:] == calls[1][2:]


def test_wav_to_x3a_streaming_bytes(tmp_path):
    from x3_tpu import streaming as ref

    from x3_tpu_torch import streaming as port

    src = write_wav(tmp_path / "in.wav", signal(4, 7 * S + 2))
    got = port.wav_to_x3a_streaming(src, tmp_path / "port.x3a", port_params(TINY), batch_frames=3, device="cpu")
    want = ref.wav_to_x3a_streaming(src, tmp_path / "ref.x3a", TINY, engine="numpy", batch_frames=3)
    assert (tmp_path / "port.x3a").read_bytes() == (tmp_path / "ref.x3a").read_bytes()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["Channel", "IterChannel", "two-channels"])
def test_channel_encode_like_x3_tpu(kind):
    from x3_tpu import channel as ref

    from x3_tpu_torch import channel as port

    wav = signal(9, 4 * S + 5)
    p = port_params(TINY)
    mk = {"Channel": lambda m, q: m.Channel(0, wav, RATE, q),
          "IterChannel": lambda m, q: m.IterChannel(0, iter(wav.tolist()), RATE, q)}
    if kind == "two-channels":
        got = outcome(lambda: port.encode([port.Channel(0, wav, RATE, p)] * 2, io.BytesIO(), device="cpu"))
        assert got == outcome(lambda: ref.encode([ref.Channel(0, wav, RATE, TINY)] * 2, io.BytesIO(), "numpy"))
        assert got == ("raise", "MoreThanOneChannel")
        return
    out_port, out_ref = io.BytesIO(), io.BytesIO()
    got = port.encode([mk[kind](port, p)], out_port, device="cpu")
    want = ref.encode([mk[kind](ref, TINY)], out_ref, engine="numpy")
    assert out_port.getvalue() == out_ref.getvalue() and out_port.getvalue()
    np.testing.assert_array_equal(got, want)
    if kind == "Channel":
        assert port.Channel(0, wav, RATE, p).encode(device="cpu").data == out_ref.getvalue()


# ---- the CLI and wav_to_str ----


def run_cli(*args, module="x3_tpu_torch"):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-m", module, *map(str, args)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_roundtrip_is_exact(tmp_path):
    from x3_tpu import files as ref

    wav = make_hydrophone(np.random.default_rng(8), 3 * 10000 + 77)
    src = write_wav(tmp_path / "in.wav", wav, 96000)
    r = run_cli("-i", src, "-o", tmp_path / "out.x3a", "--device", "cpu", "-q")
    assert r.returncode == 0, r.stderr
    ref.wav_to_x3a(src, tmp_path / "ref.x3a", engine="numpy")
    assert (tmp_path / "out.x3a").read_bytes() == (tmp_path / "ref.x3a").read_bytes()
    r = run_cli("-i", tmp_path / "out.x3a", "-o", tmp_path / "back.wav", "--device", "cpu", "-q")
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "back.wav").read_bytes() == src.read_bytes()


def test_cli_info_prints_x3_tpu_keys(arch, tmp_path, capsys):
    from x3_tpu.cli import main

    src = _archive(arch, "clean", tmp_path)
    r = run_cli("-i", src, "--info", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert main(["-i", str(src), "--info"]) == 0
    assert r.stdout == capsys.readouterr().out
    assert r.stdout.splitlines()[0].startswith("sample_rate: ")


@pytest.mark.parametrize("kind,rc", [("clean", 0), ("payload-byte", 1), ("archive-header", 1)])
def test_cli_verify_exit_code(arch, tmp_path, capsys, kind, rc):
    from x3_tpu.cli import main

    src = _archive(arch, kind, tmp_path)
    r = run_cli("-i", src, "--verify", "--device", "cpu", "-q")
    assert r.returncode == rc, r.stderr
    assert main(["-i", str(src), "--verify", "--engine", "jax", "-q"]) == rc
    assert r.stdout == capsys.readouterr().out.replace("engine=jax", "engine=torch")


@pytest.mark.parametrize("rng_arg", ["40:75", "250", ":10"])
def test_cli_range_extracts_the_samples(arch, tmp_path, rng_arg):
    from x3_tpu_torch.utils.wav import read_wav

    src = _archive(arch, "clean", tmp_path)
    r = run_cli("-i", src, "-o", tmp_path / "part.wav", "--range", rng_arg, "--device", "cpu")
    assert r.returncode == 0, r.stderr
    start, _, count = rng_arg.partition(":")
    start = int(start or 0)
    want = arch["wav"][start : start + int(count)] if count else arch["wav"][start:]
    got, rate = read_wav(tmp_path / "part.wav")
    assert rate == RATE
    np.testing.assert_array_equal(got, want)


def test_cli_refuses_the_jax_engine(tmp_path):
    src = write_wav(tmp_path / "in.wav", np.zeros(10, np.int16))
    r = run_cli("-i", src, "-o", tmp_path / "out.x3a", "--engine", "jax", "--device", "cpu")
    assert r.returncode == 2 and "invalid choice: 'jax'" in r.stderr
    assert not (tmp_path / "out.x3a").exists()


def test_wav_to_str_like_x3_tpu(tmp_path, capsys):
    from x3_tpu import wav_to_str as ref

    from x3_tpu_torch import wav_to_str as port

    src = write_wav(tmp_path / "in.wav", signal(6, 37), 22050)
    assert port.main(["--wav", str(src)]) == 0
    got = capsys.readouterr().out
    ref.main(["--wav", str(src)])
    assert got == capsys.readouterr().out and got.count("\n") == 6


# ---- engine names and the device rule ----


def test_engines():
    from x3_tpu_torch.engine import DECODE_BATCH_FRAMES, resolve_batch_frames, resolve_engine
    from x3_tpu_torch.models.encoder import DEFAULT_BATCH_FRAMES

    assert resolve_engine() == resolve_engine("auto") == resolve_engine("torch") == "torch"
    for bad in ("jax", "native", "numpy", "cuda"):
        with pytest.raises(ValueError, match="auto|torch"):
            resolve_engine(bad)
    assert resolve_batch_frames(None, "auto", decode=False) == DEFAULT_BATCH_FRAMES
    assert resolve_batch_frames(None, "torch", decode=True) == DECODE_BATCH_FRAMES
    assert resolve_batch_frames(5, "auto", decode=True) == 5


ENTRY_POINTS = {
    "wav_to_x3a": lambda m, a, o: m.files.wav_to_x3a(a["wav"], o),
    "x3a_to_wav": lambda m, a, o: m.files.x3a_to_wav(a["x3a"], o),
    "x3a_info": lambda m, a, o: m.files.x3a_info(a["x3a"]),
    "verify_x3a": lambda m, a, o: m.files.verify_x3a(a["x3a"]),
    "X3aReader": lambda m, a, o: m.files.X3aReader(a["x3a"]),
    "StreamEncoder": lambda m, a, o: m.streaming.StreamEncoder(o, RATE),
    "wav_to_x3a_streaming": lambda m, a, o: m.streaming.wav_to_x3a_streaming(a["wav"], o),
    "Channel.encode": lambda m, a, o: m.channel.Channel(0, np.zeros(5, np.int16), RATE).encode(),
    "IterChannel.encode_to": lambda m, a, o: m.channel.IterChannel(0, [1, 2], RATE).encode_to(o),
    "channel.encode": lambda m, a, o: m.channel.encode([m.channel.Channel(0, np.zeros(5, np.int16), RATE)],
                                                       io.BytesIO()),
    "cli": lambda m, a, o: m.cli.main(["-i", str(a["wav"]), "-o", str(o)]),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda(tmp_path, entry):
    """Called without `device`, every entry point of the file layer asks
    for the card; with none here, it raises and writes nothing."""
    import torch

    import x3_tpu_torch.channel
    import x3_tpu_torch.cli
    import x3_tpu_torch.files
    import x3_tpu_torch.streaming

    assert not torch.cuda.is_available()
    src = write_wav(tmp_path / "in.wav", np.arange(40, dtype=np.int16))
    x3a = tmp_path / "in.x3a"
    x3_tpu_torch.files.wav_to_x3a(src, x3a, device="cpu")
    out = tmp_path / ("out.wav" if entry == "x3a_to_wav" else "out.x3a")
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[entry](x3_tpu_torch, {"wav": src, "x3a": x3a}, out)
    assert not out.exists()

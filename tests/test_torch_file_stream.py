"""The port's chunked file decode on the CPU (x3_tpu_torch.files.
_x3a_to_wav_stream, archive.index_frames, models.decoder.
decode_frames_indexed) against x3_tpu: its native frame index and walker,
and x3a_to_wav under the jax, numpy and native engines.

Chunks as small as 64 bytes put every carry case in play: frames split
across chunk boundaries, a header split in two, a blob with no whole
frame.  Small geometry (block_len 2, 16 samples a frame), so the plain
decode walk stays short: the archive's XML does not carry
blocks_per_frame, so every decode walks 500 blocks."""

import dataclasses

import numpy as np
import pytest
import torch

import x3_tpu_torch as xt
from tests.test_torch_files import DAMAGES, damaged, signal, write_wav
from x3_tpu import archive as ref_archive
from x3_tpu import native
from x3_tpu.params import Parameters

SMALL = Parameters(block_len=2, blocks_per_frame=8)
S = SMALL.samples_per_frame
N_FRAMES = 14
CHUNKS = (64, 3000, None)  # None: the default _CHUNK_BYTES
REF_ENGINES = ("jax", "numpy", "native")


def port_params(p: Parameters) -> xt.Parameters:
    return xt.Parameters(**dataclasses.asdict(p))


@pytest.fixture(scope="module")
def arch(tmp_path_factory):
    """A 14-frame archive (partial last frame), its index and its source,
    in test_torch_files' layout so its damages apply."""
    from x3_tpu.files import wav_to_x3a

    td = tmp_path_factory.mktemp("torch_file_stream")
    wav = signal(16, (N_FRAMES - 1) * S + 9)
    src = write_wav(td / "src.wav", wav)
    wav_to_x3a(src, td / "src.x3a", SMALL, engine="numpy")
    data = (td / "src.x3a").read_bytes()
    _, hdr_end = ref_archive.parse_archive_header(data)
    idx = list(ref_archive.walk_frames(data, hdr_end))
    assert len(idx) == N_FRAMES
    return dict(data=data, hdr_end=hdr_end, idx=idx, wav=wav, td=td)


@pytest.fixture()
def chunk(request, monkeypatch):
    from x3_tpu_torch import files

    if request.param is not None:
        monkeypatch.setattr(files, "_CHUNK_BYTES", request.param)
    return request.param


def with_chunks(fn):
    return pytest.mark.parametrize("chunk", CHUNKS, indirect=True, ids=lambda c: f"chunk{c or 'default'}")(fn)


def engines():
    return [e for e in REF_ENGINES if e != "native" or native.available()]


# ---- (a) the in-memory frame index ----


def walker_prefix(data: bytes, start: int):
    """x3_tpu's walk_frames from `start` up to its first error."""
    out = []
    try:
        for off, h in ref_archive.walk_frames(data, start):
            out.append((off, h.samples, h.payload_len))
    except Exception:  # noqa: BLE001 - the prefix before any error is what is compared
        pass
    return out


def assert_index_like_x3_tpu(data: bytes, start: int, max_frames=None):
    from x3_tpu_torch.archive import index_frames

    offs, ns, lens = index_frames(data, start, max_frames)
    assert (offs.dtype, ns.dtype, lens.dtype) == (np.int64, np.int32, np.int32)
    got = list(zip(offs.tolist(), ns.tolist(), lens.tolist()))
    if native.available():
        assert got == native.index_frames(data, start, max_frames)
    if max_frames is None:
        assert got == walker_prefix(data, start)
    return got


@pytest.mark.parametrize("kind", DAMAGES)
def test_index_frames_like_native_and_walker(arch, kind):
    data = damaged(arch, kind)
    got = assert_index_like_x3_tpu(data, arch["hdr_end"])
    if kind in ("clean", "trailing-junk", "archive-header"):
        assert len(got) == N_FRAMES
    elif kind in ("payload-byte", "decode-error", "delete-frame"):
        assert len(got) == N_FRAMES - (kind == "delete-frame")
    else:
        assert len(got) < N_FRAMES


@pytest.mark.parametrize("start", ["frame 7", "mid-frame", "last bytes", "past the end"])
def test_index_frames_from_a_later_start(arch, start):
    data = arch["data"]
    at = {"frame 7": arch["idx"][7][0] - 20, "mid-frame": arch["idx"][7][0] - 13,
          "last bytes": len(data) - 20, "past the end": len(data) + 5}[start]
    got = assert_index_like_x3_tpu(data, at)
    assert len(got) == (N_FRAMES - 7 if start == "frame 7" else 0)
    for cap in (0, 1, 3):
        assert len(assert_index_like_x3_tpu(data, arch["hdr_end"], cap)) == cap


def test_index_frames_on_random_damage(arch):
    """200 seeded byte flips, byte overwrites and truncations."""
    rng = np.random.default_rng(1016)
    hs = arch["hdr_end"]
    for trial in range(200):
        data = bytearray(arch["data"])
        for _ in range(int(rng.integers(1, 4))):
            at = int(rng.integers(hs, len(data)))
            if trial % 3 == 0:
                data[at] ^= 1 << int(rng.integers(0, 8))
            elif trial % 3 == 1:
                data[at] = int(rng.integers(0, 256))
            else:
                del data[at:]
                break
        start = hs if trial % 4 else int(rng.integers(0, len(data) + 1))
        assert_index_like_x3_tpu(bytes(data), start)


# ---- (b) x3a_to_wav without resync against x3_tpu ----


def decode_outcome(fn, out, capsys):
    """(outcome, result or class and message, WAV bytes or None, printed
    lines)."""
    try:
        res = ("ok", fn(), out.read_bytes())
    except Exception as e:  # noqa: BLE001 - the class and message are what is compared
        res = ("raise", (type(e).__name__, str(e)), None)
    return res + (capsys.readouterr().out,)


@pytest.fixture(scope="module")
def ref_outcomes():
    return {}  # (kind, engine) -> x3_tpu's outcome; it does not depend on the port's chunk


@with_chunks
@pytest.mark.parametrize("kind", DAMAGES)
def test_stream_like_x3_tpu(arch, tmp_path, capsys, kind, chunk, ref_outcomes):
    """Outcome, return value, WAV bytes, error class and message, and the
    Frame error lines equal x3_tpu's x3a_to_wav without resync under each
    engine, at chunks of 64 and 3,000 bytes and the default."""
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    src = tmp_path / f"{kind}.x3a"
    src.write_bytes(damaged(arch, kind))
    got = decode_outcome(lambda: port.x3a_to_wav(src, tmp_path / "port.wav", batch_frames=4, device="cpu"),
                         tmp_path / "port.wav", capsys)
    for engine in engines():
        if (kind, engine) not in ref_outcomes:
            ref_outcomes[kind, engine] = decode_outcome(
                lambda: ref.x3a_to_wav(src, tmp_path / "ref.wav", engine=engine, batch_frames=4),
                tmp_path / "ref.wav", capsys)
        assert got == ref_outcomes[kind, engine], engine
    if kind == "clean":
        assert got[:2] == ("ok", 0) and got[2] == (arch["td"] / "src.wav").read_bytes()
    if kind == "decode-error":
        assert got[1] == 1 and got[3] == "Frame error: frame 2 failed to decode\n"


# ---- (c) - (e) errors at chunk boundaries and tails ----


@with_chunks
def test_payload_crc_error_names_the_global_frame(arch, tmp_path, chunk):
    from x3_tpu_torch import files as port
    from x3_tpu_torch.errors import FrameHeaderInvalidPayloadCRC

    k = 11  # many 64-byte chunks in
    off, h = arch["idx"][k]
    data = bytearray(arch["data"])
    data[off + h.payload_len // 2] ^= 0x20
    src = tmp_path / "bad.x3a"
    src.write_bytes(bytes(data))
    with pytest.raises(FrameHeaderInvalidPayloadCRC, match=f"^frame {k} payload CRC mismatch$"):
        port.x3a_to_wav(src, tmp_path / "out.wav", batch_frames=3, device="cpu")


def _restamp_header(data: bytearray, hoff: int) -> None:
    from x3_tpu.ops.crc import crc16

    data[hoff + 16 : hoff + 18] = crc16(bytes(data[hoff : hoff + 16])).to_bytes(2, "big")


@with_chunks
def test_channels_byte_two_raises(arch, tmp_path, chunk):
    """A header with channels byte 2 and a valid CRC raises
    MoreThanOneChannel, as x3_tpu's walker does."""
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port
    from x3_tpu_torch.errors import MoreThanOneChannel

    data = bytearray(arch["data"])
    hoff = arch["idx"][13][0] - 20
    data[hoff + 3] = 2
    _restamp_header(data, hoff)
    src = tmp_path / "chan.x3a"
    src.write_bytes(bytes(data))
    from x3_tpu.errors import MoreThanOneChannel as RefMoreThanOneChannel

    with pytest.raises(MoreThanOneChannel):
        port.x3a_to_wav(src, tmp_path / "out.wav", device="cpu")
    with pytest.raises(RefMoreThanOneChannel):
        ref.x3a_to_wav(src, tmp_path / "ref.wav", engine="numpy")


@with_chunks
@pytest.mark.parametrize("tail", ["no frames", "1 byte", "20 bytes", "21 bytes"])
def test_archive_tails(arch, tmp_path, capsys, tail, chunk):
    """An archive of no frames, and at most a header's worth of trailing
    bytes, decode silently; 21 trailing bytes raise the walker's header
    error.  Each as x3_tpu's x3a_to_wav."""
    from x3_tpu import files as ref

    from x3_tpu_torch import files as port

    data = arch["data"]
    data = {"no frames": data[: arch["hdr_end"]], "1 byte": data + b"\x07",
            "20 bytes": data + bytes(range(20)), "21 bytes": data + bytes(range(21))}[tail]
    src = tmp_path / "tail.x3a"
    src.write_bytes(data)
    got = decode_outcome(lambda: port.x3a_to_wav(src, tmp_path / "port.wav", device="cpu"),
                         tmp_path / "port.wav", capsys)
    for engine in engines():
        want = decode_outcome(lambda: ref.x3a_to_wav(src, tmp_path / "ref.wav", engine=engine),
                              tmp_path / "ref.wav", capsys)
        assert got == want, engine
    assert got[0] == ("raise" if tail == "21 bytes" else "ok")


@pytest.mark.parametrize("where", ["first frame", "frame 9"])
def test_bad_header_before_a_long_rest_raises_early(arch, tmp_path, monkeypatch, where):
    """A bad header followed by more than a frame's worth of bytes
    (20 + FRAME_MAX_LENGTH) raises the walker's error once that much is
    buffered, before the rest of the file is read."""
    from x3_tpu import files as ref

    from x3_tpu_torch import constants, files as port
    from x3_tpu_torch.errors import FrameHeaderInvalidKey

    monkeypatch.setattr(port, "_CHUNK_BYTES", 3000)
    prefetch, reads = port.prefetch_iter, []

    def counting(src, depth=2):
        for item in prefetch(src, depth):
            reads.append(item)
            yield item

    monkeypatch.setattr(port, "prefetch_iter", counting)
    k = 0 if where == "first frame" else 9
    data = bytearray(arch["data"])
    hoff = arch["idx"][k][0] - 20
    data[hoff] = 0x00  # the key
    _restamp_header(data, hoff)
    rest = 200_000
    data += bytes(rest)
    src = tmp_path / "long.x3a"
    src.write_bytes(bytes(data))
    with pytest.raises(FrameHeaderInvalidKey):
        port.x3a_to_wav(src, tmp_path / "port.wav", device="cpu")
    with pytest.raises(Exception, match="bad frame key") as want:
        ref.x3a_to_wav(src, tmp_path / "ref.wav", engine="numpy")
    assert type(want.value).__name__ == "FrameHeaderInvalidKey"
    assert 3000 * len(reads) <= 3000 + 20 + constants.FRAME_MAX_LENGTH + len(arch["data"])
    assert 3000 * len(reads) < rest / 2


# ---- (f) batch sizes ----


@with_chunks
@pytest.mark.parametrize("batch", [1, 3, None])
def test_stream_batches_give_the_same_wav(arch, tmp_path, batch, chunk):
    from x3_tpu_torch import files as port

    src = tmp_path / "a.x3a"
    src.write_bytes(arch["data"])
    assert port.x3a_to_wav(src, tmp_path / "out.wav", batch_frames=batch, device="cpu") == 0
    assert (tmp_path / "out.wav").read_bytes() == (arch["td"] / "src.wav").read_bytes()


# ---- (g) the one-buffer decode ----


@pytest.mark.parametrize("entries", [1, 2])
@pytest.mark.parametrize("form", ["tensor", "array", "bytes"])
@pytest.mark.parametrize("checked", [False, True], ids=["plain", "checked"])
def test_decode_frames_indexed_equals_flat(arch, checked, form, entries):
    """decode_frames_indexed over the archive and its index equals
    decode_frames_flat of the same payloads (samples, err and crc_ok), on
    frames with flipped payload bytes and one claiming more samples than
    the geometry holds, for a buffer given as a tensor, an array or
    bytes, on meshes of 1 and 2 CPU entries."""
    from x3_tpu_torch.archive import index_frames
    from x3_tpu_torch.models.decoder import decode_frames_flat, decode_frames_indexed
    from x3_tpu_torch.models.sharding import Mesh

    data = bytearray(arch["data"])
    for off, h in arch["idx"][1::4]:
        data[off + h.payload_len // 3] ^= 0x5A
    offs, ns, lens = index_frames(bytes(data), arch["hdr_end"])
    assert len(offs) == N_FRAMES
    ns = ns.copy()
    ns[5] = 70  # the n_blocks override
    crcs = [int.from_bytes(data[o - 2 : o], "big") for o in offs.tolist()]
    kw = dict(check_crcs=crcs) if checked else {}
    buf = {"tensor": torch.frombuffer(data, dtype=torch.uint8), "array": np.frombuffer(data, np.uint8),
           "bytes": bytes(data)}[form]
    mesh = Mesh(["cpu"] * entries)
    tiny = port_params(SMALL)
    got = decode_frames_indexed(buf, offs, ns, lens, tiny, device="cpu", mesh=mesh, **kw)
    payloads = [bytes(data[o : o + n]) for o, n in zip(offs.tolist(), lens.tolist())]
    want = decode_frames_flat(payloads, ns, tiny, device="cpu", mesh=mesh, **kw)
    assert len(got) == len(want) == 2 + checked
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].any() and (not checked or not got[2].all())
    empty = decode_frames_indexed(buf, offs[:0], ns[:0], lens[:0], tiny, device="cpu", **kw)
    assert [len(a) for a in empty] == [0] * (2 + checked)

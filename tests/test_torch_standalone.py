"""x3_tpu_torch's own copies of x3_tpu's host modules against the
originals (parameters, constants, errors, the host CRC and the GF(2) CRC
constants, the archive container and its file walkers, the frame headers
and the assembly, the background I/O and the WAV helpers), and a fresh
interpreter in which importing the port and every module of it leaves no
jax and no x3_tpu in sys.modules."""

import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import x3_tpu_torch as xt
from tests.conftest import make_mixed
from x3_tpu.params import Parameters

REPO = Path(__file__).resolve().parent.parent
FIELDS = [
    {},
    dict(block_len=4, blocks_per_frame=8),
    dict(block_len=60, blocks_per_frame=5),
    dict(codes=(1, 2, 3), thresholds=(8, 20, 40)),
    dict(block_len=12, blocks_per_frame=64, codes=(0, 2, 3), thresholds=(2, 12, 30)),
    dict(codes=[3, 3, 3], thresholds=[28, 28, 28]),
]


@pytest.mark.parametrize("fields", FIELDS, ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()) or "default")
def test_parameters_copy(fields):
    ref, port = Parameters(**fields), xt.Parameters(**fields)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.codes, port.thresholds) == (ref.codes, ref.thresholds)
    assert port.samples_per_frame == ref.samples_per_frame
    for rc, want in zip(port.rice_codes, ref.rice_codes):
        assert (rc.nsubs, rc.offset, rc.inv_len) == (want.nsubs, want.offset, want.inv_len)
    assert hash(port) == hash(xt.Parameters(**fields))
    assert xt.X3aSpec(96000, port) == xt.X3aSpec(96000, xt.Parameters(**fields))


@pytest.mark.parametrize("fields", [dict(thresholds=(7, 8, 20)), dict(codes=(1, 0, 3), thresholds=(3, 12, 20))])
def test_parameters_reject_like_the_original(fields):
    from x3_tpu.errors import X3Error

    with pytest.raises(X3Error) as want:
        Parameters(**fields)
    with pytest.raises(xt.errors.X3Error) as got:
        xt.Parameters(**fields)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_constants_copy():
    from x3_tpu import constants as ref

    from x3_tpu_torch import constants as port

    names = [n for n in dir(port) if n.isupper() and n != "RICE_CODES"]
    assert len(names) > 15
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name
    for rc, want in zip(port.RICE_CODES, ref.RICE_CODES):
        assert (rc.nsubs, rc.offset, rc.inv_len) == (want.nsubs, want.offset, want.inv_len)


@pytest.mark.parametrize("code", [0, 1, 2, 3, 4, 5])
def test_decode_error_copy(code):
    from x3_tpu.errors import decode_error as ref

    from x3_tpu_torch.errors import X3Error, decode_error

    got, want = decode_error(code), ref(code)
    assert isinstance(got, X3Error)
    assert (type(got).__name__, str(got)) == (type(want).__name__, str(want))
    got, want = decode_error(code, "frame 7"), ref(code, "frame 7")
    assert (type(got).__name__, str(got)) == (type(want).__name__, str(want))


@pytest.mark.parametrize("n", [1, 4, 13, 96, 2048])
def test_crc_copies(n):
    from x3_tpu.ops import crc as ref
    from x3_tpu.ops.crc_jax import crc_matmul_consts as ref_consts

    from x3_tpu_torch.ops import crc as port
    from x3_tpu_torch.tables import crc_matmul_consts

    np.testing.assert_array_equal(port.CRC_TABLE, ref.CRC_TABLE)
    if n <= 96:  # the GF(2) constants of a 2,048-byte buffer take seconds each
        m, c, inv = crc_matmul_consts(n)
        rm, rc, rinv = ref_consts(n)
        np.testing.assert_array_equal(m, rm)
        assert c == rc
        np.testing.assert_array_equal(inv, rinv)
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 256, (7, n), dtype=np.uint8)
    lens = rng.integers(0, n + 1, 7)
    np.testing.assert_array_equal(port.crc16_many(rows, lens), ref.crc16_many(rows, lens))
    assert port.crc16(rows[0].tobytes()) == ref.crc16(rows[0].tobytes())


@pytest.mark.parametrize("rate,fields", [(96000, {}), (44100, dict(block_len=4, blocks_per_frame=8)),
                                         (8000, dict(codes=(1, 2, 3), thresholds=(8, 20, 40)))])
def test_archive_header_copy(rate, fields):
    from x3_tpu import archive as ref

    from x3_tpu_torch import archive as port

    got = port.build_archive_header(rate, xt.Parameters(**fields))
    assert got == ref.build_archive_header(rate, Parameters(**fields))
    spec, size = port.parse_archive_header(got + b"tail")
    rspec, rsize = ref.parse_archive_header(got + b"tail")
    assert size == rsize == len(got)
    assert (spec.sample_rate, spec.channels) == (rspec.sample_rate, rspec.channels)
    assert dataclasses.asdict(spec.params) == dataclasses.asdict(rspec.params)
    assert port.write_frame_header(1234, 1, 678, 0xBEEF) == ref.write_frame_header(1234, 1, 678, 0xBEEF)


def _walk(mod, data, start, resync):
    try:
        return [(off, dataclasses.astuple(h)) for off, h in mod.walk_frames(data, start, resync)]
    except Exception as e:  # noqa: BLE001 - the class and message are compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("damage", ["header-crc", "key", "payload-len", "truncated"])
def test_walk_frames_copy_on_a_corrupt_archive(damage):
    """Both frame walks over an archive with one damaged frame, with and
    without resync: the same frames, or the same error."""
    import x3_tpu
    from x3_tpu import archive as ref

    from x3_tpu_torch import archive as port

    p = Parameters(block_len=4, blocks_per_frame=8)
    header = ref.build_archive_header(96000, p)
    data = bytearray(header + x3_tpu.encode(make_mixed(np.random.default_rng(3), 32 * 6), p,
                                            engine="numpy").data)
    second = len(header) + 20 + int.from_bytes(data[len(header) + 6 : len(header) + 8], "big")
    if damage == "header-crc":
        data[second + 17] ^= 0xFF
    elif damage == "key":
        data[second] = 0x00
    elif damage == "payload-len":
        data[second + 6 : second + 8] = (0x7000).to_bytes(2, "big")
    else:
        data = data[:-7]
    data = bytes(data)
    for resync in (False, True):
        got = _walk(port, data, len(header), resync)
        assert got == _walk(ref, data, len(header), resync), resync
    assert len(_walk(port, data, len(header), True)) >= 4


def test_frame_headers_and_assemble_copy():
    from x3_tpu.models import encoder as ref

    from x3_tpu_torch.models import encoder as port

    rng = np.random.default_rng(17)
    F, W = 9, 24
    words = rng.integers(0, 2**32, (F, W), dtype=np.uint64).astype(np.uint32)
    payload = words.byteswap().view(np.uint8).reshape(F, 4 * W)
    nbytes = (rng.integers(0, 2 * W, F) * 2).astype(np.int32)
    nbytes[0], nbytes[1], nbytes[-1] = 0, 4 * W, 2  # empty, full-width and tiny frames
    n_samples = rng.integers(0, 10001, F).astype(np.int32)
    crcs = rng.integers(0, 1 << 16, F).astype(np.int32)
    got = port.build_frame_headers(n_samples, 1, nbytes, crcs)
    want = ref.build_frame_headers(n_samples, 1, nbytes, crcs)
    np.testing.assert_array_equal(got, want)
    assert port._assemble(got, payload, nbytes) == ref._assemble(want, payload, nbytes)
    assert port._assemble(got[:0], payload[:0], nbytes[:0]) == b""


def test_golden_frame_encodes_byte_for_byte(golden):
    """The reference's golden frame through the port's CPU path."""
    got = xt.encode(golden["frame_wav"], xt.Parameters(), device="cpu")
    assert got.data == bytes(golden["frame_expected"])


def test_port_and_bench_import_no_jax_and_no_x3_tpu():
    """A fresh interpreter imports x3_tpu_torch, every module of it (the
    CUDA wrappers import without a card) and the port's bench script
    bench_torch; then no key of
    sys.modules is jax or x3_tpu or below them.  JAX_PLATFORMS is set, and
    must not matter."""
    mods = sorted(
        "x3_tpu_torch." + ".".join(p.relative_to(REPO / "x3_tpu_torch").with_suffix("").parts)
        for p in (REPO / "x3_tpu_torch").rglob("*.py")
        if p.name not in ("__init__.py", "__main__.py")  # __main__ runs the CLI
    )
    assert {"x3_tpu_torch.models.encoder", "x3_tpu_torch.ops.pack_walk_cuda",
            "x3_tpu_torch.archive", "x3_tpu_torch.tables", "x3_tpu_torch.engine",
            "x3_tpu_torch.streaming", "x3_tpu_torch.files", "x3_tpu_torch.channel",
            "x3_tpu_torch.cli", "x3_tpu_torch.wav_to_str", "x3_tpu_torch.utils.io",
            "x3_tpu_torch.utils.wav", "x3_tpu_torch.utils.xmlmeta", "x3_tpu_torch.multifile",
            "x3_tpu_torch.multichannel", "x3_tpu_torch.parallel.multihost", "x3_tpu_torch.parallel.mesh", "x3_tpu_torch.models.sharding",
            "x3_tpu_torch.entry", "x3_tpu_torch.utils.profiling", "x3_tpu_torch.tools.decode_parity",
            "x3_tpu_torch.tools.fuzz_soak", "x3_tpu_torch.utils.extbin",
            "x3_tpu_torch.tools.fuzz_differential", "x3_tpu_torch.tools.roundtrip_corpus",
            "x3_tpu_torch.tools.bench_files", "x3_tpu_torch.tools.compile_sweep",
            "x3_tpu_torch.bench"} <= set(mods)
    code = (
        "import importlib, sys\n"
        "import x3_tpu_torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import bench_torch\n"
        "import contextlib, io\n"
        "from x3_tpu_torch.cli import main\n"
        "try:\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m in ('jax', 'x3_tpu') or m.startswith(('jax.', 'x3_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def _extbin_case(tmp_path, monkeypatch, case: str) -> None:
    """The environment and PATH of one detection case of tests/test_extbin.py."""
    for var in ("X3_REFERENCE_BIN", "FLAC_BIN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    fakes = tmp_path / "bin"
    fakes.mkdir()
    for name in ("x3", "flac"):
        fake = fakes / name
        fake.write_text("#!/bin/sh\nexit 0\n")
        fake.chmod(0o755)
    (fakes / "plain").write_text("not executable")
    if case == "env":
        monkeypatch.setenv("X3_REFERENCE_BIN", str(fakes / "x3"))
        monkeypatch.setenv("FLAC_BIN", str(fakes / "flac"))
    elif case == "path":
        monkeypatch.setenv("PATH", str(fakes))
    elif case == "env-beats-path":
        other = tmp_path / "other"
        other.mkdir()
        for name in ("x3", "flac"):
            (other / name).write_text("#!/bin/sh\nexit 1\n")
            (other / name).chmod(0o755)
        monkeypatch.setenv("PATH", str(other))
        monkeypatch.setenv("X3_REFERENCE_BIN", str(fakes / "x3"))
        monkeypatch.setenv("FLAC_BIN", str(fakes / "flac"))
    elif case == "env-missing":
        monkeypatch.setenv("X3_REFERENCE_BIN", str(tmp_path / "missing"))
        monkeypatch.setenv("FLAC_BIN", str(tmp_path / "missing"))
    elif case == "env-not-executable":
        monkeypatch.setenv("X3_REFERENCE_BIN", str(fakes / "plain"))
        monkeypatch.setenv("FLAC_BIN", str(fakes / "plain"))


@pytest.mark.parametrize("case", ["absent", "env", "path", "env-beats-path", "env-missing", "env-not-executable"])
def test_extbin_copy_detects_like_the_original(tmp_path, monkeypatch, case):
    from x3_tpu.utils import extbin as ref

    from x3_tpu_torch.utils import extbin as port

    _extbin_case(tmp_path, monkeypatch, case)
    got = (port.find_reference_x3(), port.find_flac())
    assert got == (ref.find_reference_x3(), ref.find_flac())
    assert (got[0] is None) == (case in ("absent", "env-missing", "env-not-executable"))


def test_extbin_ref_convert_copy(tmp_path):
    """ref_convert passes --input/--output to the binary and raises on a
    non-zero exit, as the original."""
    from x3_tpu.utils import extbin as ref

    from x3_tpu_torch.utils import extbin as port

    tool = tmp_path / "x3"
    tool.write_text('#!/bin/sh\n[ "$1" = --input ] && [ "$3" = --output ] || exit 3\ncp "$2" "$4"\n')
    tool.chmod(0o755)
    (tmp_path / "a.wav").write_bytes(b"abc")
    for mod, out in ((ref, "ref.x3a"), (port, "port.x3a")):
        mod.ref_convert(str(tool), tmp_path / "a.wav", tmp_path / out)
        assert (tmp_path / out).read_bytes() == b"abc"
        with pytest.raises(subprocess.CalledProcessError):
            mod.ref_convert(str(tool), tmp_path / "missing.wav", tmp_path / out)


def test_resolve_engine_takes_decode_and_ignores_x3_engine(monkeypatch):
    """x3_tpu's signature (engine, decode=None); one engine whatever the
    direction; no other name; X3_ENGINE is not read."""
    monkeypatch.delenv("X3_ENGINE", raising=False)
    assert xt.resolve_engine("auto", decode=True) == xt.resolve_engine("torch", decode=False) == "torch"
    assert xt.resolve_engine() == xt.resolve_engine("auto", None) == "torch"
    for name in ("jax", "native", "numpy", "cuda"):
        with pytest.raises(ValueError, match="unknown engine"):
            xt.resolve_engine(name, decode=True)
    monkeypatch.setenv("X3_ENGINE", "numpy")
    assert xt.resolve_engine("auto", decode=True) == xt.resolve_engine("auto") == "torch"


def _walk_file(mod, path, start, resync):
    with open(path, "rb") as f:
        try:
            return [(off, dataclasses.astuple(h)) for off, h in mod.walk_frames_file(f, start, resync)]
        except Exception as e:  # noqa: BLE001 - the class and message are compared
            return (type(e).__name__, str(e))


@pytest.mark.parametrize("damage", ["clean", "header-crc", "key", "payload-len", "truncated", "bad-magic",
                                    "garbage"])
def test_file_walkers_copy_on_a_corrupt_archive(tmp_path, damage):
    """The archive's file walkers (header parse, frame walk with and
    without resync, sync scan in small windows) over the same damaged
    archive: the same results, or the same error class and message; and
    the port's FrameIndex of x3_tpu's resync walk holds its entries."""
    import x3_tpu
    from x3_tpu import archive as ref

    from x3_tpu_torch import archive as port

    p = Parameters(block_len=4, blocks_per_frame=8)
    header = ref.build_archive_header(96000, p)
    data = bytearray(header + x3_tpu.encode(make_mixed(np.random.default_rng(5), 32 * 6 + 3), p,
                                            engine="numpy").data)
    second = len(header) + 20 + int.from_bytes(data[len(header) + 6 : len(header) + 8], "big")
    if damage == "header-crc":
        data[second + 17] ^= 0xFF
    elif damage == "key":
        data[second] = 0x00
    elif damage == "payload-len":
        data[second + 6 : second + 8] = (0x7000).to_bytes(2, "big")
    elif damage == "truncated":
        data = data[:-7]
    elif damage == "bad-magic":
        data[3] ^= 0x01
    elif damage == "garbage":
        data[second:second] = b"\x78\x33" + bytes(range(50))
    path = tmp_path / "a.x3a"
    path.write_bytes(bytes(data))

    def header_of(mod):
        with open(path, "rb") as f:
            try:
                spec, size = mod.read_archive_header_file(f)
                return spec.sample_rate, dataclasses.asdict(spec.params), spec.channels, size
            except Exception as e:  # noqa: BLE001
                return type(e).__name__, str(e)

    assert header_of(port) == header_of(ref)
    for resync in (False, True):
        assert _walk_file(port, path, len(header), resync) == _walk_file(ref, path, len(header), resync)
    with open(path, "rb") as f:
        for start in (0, len(header) + 1, second + 1, len(data) - 19):
            for chunk in (7, 64, 1 << 20):
                assert port.find_sync_file(f, start, chunk=chunk) == ref.find_sync_file(f, start, chunk=chunk)
    entries = list(ref.walk_frames(bytes(data), len(header), resync=True))
    ix = port.FrameIndex.of_walk(entries)
    cols = (ix.offsets, ix.n_samples, ix.payload_lens, ix.crcs)
    assert [c.dtype for c in cols] == [np.int64, np.int32, np.int32, np.int64]
    assert list(zip(*(c.tolist() for c in cols))) == [(off, h.samples, h.payload_len, h.payload_crc)
                                                      for off, h in entries]


class _FailingFile(io.BytesIO):
    def __init__(self, fail_at: int):
        super().__init__()
        self.calls, self.fail_at = 0, fail_at

    def write(self, b):
        self.calls += 1
        if self.calls == self.fail_at:
            raise OSError(28, "No space left on device")
        return super().write(b)


def _io_run(mod, blocks, fail_at):
    f = _FailingFile(fail_at)
    w = mod.AsyncWriter(f, depth=2)
    events = []
    for b in blocks:
        try:
            w.write(b)
        except OSError as e:
            events.append(("write", str(e)))
    for step in (w.drain, w.close, w.close):
        try:
            step()
        except OSError as e:
            events.append((step.__name__, str(e)))
    # Whether a write() call already sees the error depends on the thread's
    # pace; drain() and close() always raise it.
    return f.getvalue(), [e for e in events if e[0] != "write"]


def _prefetch(mod, n, fail_at, depth):
    def src():
        for i in range(n):
            if i == fail_at:
                raise ValueError(f"bad item {i}")
            yield i

    got = []
    try:
        for x in mod.prefetch_iter(src(), depth=depth):
            got.append(x)
    except ValueError as e:
        got.append(str(e))
    return got


@pytest.mark.parametrize("fail_at", [0, 1, 3])
def test_io_copies(tmp_path, fail_at):
    """AsyncWriter writes the same bytes and raises the same write error at
    the same calls; prefetch_iter yields the same items and raises the
    source's error after them; open_overwrite does not truncate."""
    from x3_tpu.utils import io as ref

    from x3_tpu_torch.utils import io as port

    blocks = [bytes([i]) * (i + 1) for i in range(6)]
    assert _io_run(port, blocks, fail_at) == _io_run(ref, blocks, fail_at)
    for depth in (1, 2):
        for n in (0, 5):
            assert _prefetch(port, n, fail_at, depth) == _prefetch(ref, n, fail_at, depth)
    it = port.prefetch_iter(iter(range(100)), depth=1)
    assert next(it) == 0
    it.close()  # abandoning the generator stops its thread
    for mod in (port, ref):
        path = tmp_path / f"{mod.__name__}.bin"
        path.write_bytes(b"0123456789")
        with mod.open_overwrite(path) as f:
            f.write(b"ab")
        assert path.read_bytes() == b"ab23456789"


@pytest.mark.parametrize("n,rate", [(0, 8000), (1, 44100), (12345, 96000)])
def test_wav_copies(tmp_path, n, rate):
    """write_wav and WavWriter (fed in uneven chunks, over a longer earlier
    file) give the original's bytes, and read_wav reads them back."""
    from x3_tpu.utils import wav as ref

    from x3_tpu_torch.utils import wav as port

    samples = np.random.default_rng(n).integers(-32768, 32768, n).astype(np.int16)
    ref.write_wav(tmp_path / "ref.wav", samples, rate)
    port.write_wav(tmp_path / "port.wav", samples, rate)
    want = (tmp_path / "ref.wav").read_bytes()
    assert (tmp_path / "port.wav").read_bytes() == want
    out = tmp_path / "inc.wav"
    out.write_bytes(b"x" * (len(want) + 999))
    with port.WavWriter(out, rate) as w:
        for part in np.array_split(samples, 4):
            w.write(part)
    assert w.samples_written == n
    assert out.read_bytes() == want
    got, got_rate = port.read_wav(out)
    assert got_rate == rate and got.dtype == np.int16
    np.testing.assert_array_equal(got, ref.read_wav(out)[0])
    np.testing.assert_array_equal(got, samples)

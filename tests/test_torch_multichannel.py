"""The port's multi-channel .x3m layer and the CLI's .x3m paths on the CPU
(device="cpu"), against x3_tpu's: per-channel archives and manifests
byte for byte, decoded captures and WAVs sample for sample, x3m_info and
verify_x3m reports as equal dicts (the engine's name aside), errors by
class.  Every comparison is exact."""

import json

import numpy as np
import pytest

from tests.conftest import make_hydrophone, make_mixed
from tests.test_torch_files import outcome, port_params, run_cli
from x3_tpu.params import Parameters

TINY = Parameters(block_len=4, blocks_per_frame=8)
# The archive XML carries no blocks_per_frame, so a decode walks 500 blocks
# whatever the frames hold: block_len 2 keeps that walk short on the CPU.
SHORT = Parameters(block_len=2, blocks_per_frame=300)


def capture(seed: int, n: int, c: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    makers = [make_hydrophone, make_mixed, lambda r, k: make_hydrophone(r, k, amplitude=12.0)]
    return np.stack([makers[k % 3](rng, n) for k in range(c)])


def _dir_bytes(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.fixture
def x3m(tmp_path):
    """A 3-channel capture of 2,345 samples (four frames of 600, the last
    partial), encoded by x3_tpu at 48 kHz."""
    from x3_tpu import multichannel as ref

    chans = capture(1, 2_345)
    d = tmp_path / "ref"
    d.mkdir()
    mpath = ref.encode_multichannel(chans, 48_000, d / "cap.x3m", SHORT)
    return mpath, chans


# ---- encode ----


@pytest.mark.parametrize("params,base", [(SHORT, "cap.x3m"), (TINY, "cap")], ids=["short", "tiny"])
def test_encode_multichannel_like_x3_tpu(tmp_path, params, base):
    """The per-channel archives and the manifest's bytes equal x3_tpu's."""
    from x3_tpu import multichannel as ref

    from x3_tpu_torch import multichannel as port

    chans = capture(2, 2_345 if params is SHORT else 301)
    for d in ("port", "ref"):
        (tmp_path / d).mkdir()
    got = port.encode_multichannel(chans, 96_000, tmp_path / "port" / base, port_params(params), device="cpu")
    want = ref.encode_multichannel(chans, 96_000, tmp_path / "ref" / base, params)
    assert got.name == want.name == "cap.x3m"
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "ref")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["cap.ch0.x3a", "cap.ch1.x3a",
                                                                      "cap.ch2.x3a", "cap.x3m"]


def test_wav_to_x3m_like_x3_tpu(tmp_path):
    from x3_tpu import multichannel as ref

    from x3_tpu_torch import multichannel as port

    chans = capture(3, 1_000, c=4)
    src = tmp_path / "quad.wav"
    port.write_wav_multichannel(src, chans, 44_100)
    ref.write_wav_multichannel(tmp_path / "ref_written.wav", chans, 44_100)
    assert src.read_bytes() == (tmp_path / "ref_written.wav").read_bytes()
    for d in ("port", "ref"):
        (tmp_path / d).mkdir()
    port.wav_to_x3m(src, tmp_path / "port" / "quad", port_params(TINY), device="cpu")
    ref.wav_to_x3m(src, tmp_path / "ref" / "quad", TINY)
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "ref")
    got, rate = port.read_wav_multichannel(src)
    assert rate == 44_100 and got.dtype == np.int16
    np.testing.assert_array_equal(got, chans)


# ---- decode ----


@pytest.mark.parametrize("batch", [3, None])
def test_decode_multichannel_like_x3_tpu(x3m, batch):
    from x3_tpu import multichannel as ref

    from x3_tpu_torch import multichannel as port

    mpath, chans = x3m
    got, rate = port.decode_multichannel(mpath, batch_frames=batch, device="cpu")
    want, want_rate = ref.decode_multichannel(mpath, engine="numpy", batch_frames=batch)
    assert rate == want_rate == 48_000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, chans)


@pytest.mark.parametrize("batch", [3, None])
def test_x3m_to_wav_like_x3_tpu(x3m, tmp_path, batch):
    """With batch_frames 3 the capture spans two windows, the last one
    partial."""
    from x3_tpu import multichannel as ref

    from x3_tpu_torch import multichannel as port

    mpath, chans = x3m
    out = tmp_path / "back.wav"
    out.write_bytes(b"\x07" * 50_000)  # stale, longer than the WAV
    assert port.x3m_to_wav(mpath, out, batch_frames=batch, device="cpu") == 3
    assert ref.x3m_to_wav(mpath, tmp_path / "ref.wav", engine="numpy", batch_frames=batch) == 3
    assert out.read_bytes() == (tmp_path / "ref.wav").read_bytes()
    got, rate = port.read_wav_multichannel(out)
    assert rate == 48_000
    np.testing.assert_array_equal(got, chans)


def _edit_manifest(mpath, **fields) -> None:
    m = json.loads(mpath.read_text())
    m.update(fields)
    mpath.write_text(json.dumps(m))


MISMATCHES = {
    "manifest-samples": lambda mp: _edit_manifest(mp, samples=2_000),
    "sample-rate": lambda mp: _edit_manifest(mp, sample_rate=44_100),
    "channel-lengths": lambda mp: _edit_manifest(mp, files=["cap.ch0.x3a", "short.ch0.x3a", "cap.ch2.x3a"]),
    "missing-channel": lambda mp: _edit_manifest(mp, files=["cap.ch0.x3a", "gone.x3a"]),
    "format": lambda mp: _edit_manifest(mp, format="nope"),
    "version": lambda mp: _edit_manifest(mp, version=99),
    "not-json": lambda mp: mp.write_text("{ not json"),
}


@pytest.fixture
def broken(x3m, request):
    """The x3m fixture with one inconsistency (a 2-frame channel 'short'
    beside it for the channel-lengths case)."""
    from x3_tpu import multichannel as ref

    mpath, chans = x3m
    ref.encode_multichannel(chans[:1, :600], 48_000, mpath.parent / "short", SHORT)
    MISMATCHES[request.param](mpath)
    return mpath


@pytest.mark.parametrize("broken", list(MISMATCHES), indirect=True)
def test_inconsistent_manifests_raise_like_x3_tpu(broken, tmp_path):
    """Every consumer raises x3_tpu's class (the format marker and the
    version gate are checked by all of them); verify_x3m reports instead
    where x3_tpu's does."""
    from x3_tpu import multichannel as ref

    from x3_tpu_torch import multichannel as port

    calls = {
        "decode": (lambda: port.decode_multichannel(broken, device="cpu"),
                   lambda: ref.decode_multichannel(broken, engine="numpy")),
        "to_wav": (lambda: port.x3m_to_wav(broken, tmp_path / "p.wav", device="cpu"),
                   lambda: ref.x3m_to_wav(broken, tmp_path / "r.wav", engine="numpy")),
        "info": (lambda: port.x3m_info(broken, device="cpu"), lambda: ref.x3m_info(broken)),
        "verify": (lambda: _engine_aside(port.verify_x3m(broken, device="cpu")),
                   lambda: _engine_aside(ref.verify_x3m(broken, engine="numpy"))),
    }
    raised = 0
    for name, (got, want) in calls.items():
        w = outcome(want)
        assert outcome(got) == w, name
        raised += w[0] == "raise"
    assert raised >= 1


def _engine_aside(report: dict) -> dict:
    """The report without its engine names (top level and per channel)."""
    assert report["engine"] in ("torch", "numpy")
    out = {k: v for k, v in report.items() if k != "engine"}
    out["per_channel"] = [{k: v for k, v in r.items() if k != "engine"} for r in report["per_channel"]]
    return out


# ---- info and verify ----


def test_x3m_info_like_x3_tpu(x3m):
    from x3_tpu import multichannel as ref

    from x3_tpu_torch import multichannel as port

    mpath, _ = x3m
    got = port.x3m_info(mpath, device="cpu")
    assert got == ref.x3m_info(mpath)
    assert got["channels"] == 3 and got["samples_per_channel"] == 2_345 and len(got["per_channel"]) == 3


def _damage_channel(mpath, k: int, where: int) -> None:
    p = mpath.parent / f"cap.ch{k}.x3a"
    data = bytearray(p.read_bytes())
    data[where] ^= 0xFF
    p.write_bytes(bytes(data))


VERIFY_CASES = {
    "clean": lambda mp: None,
    "damaged-channel": lambda mp: _damage_channel(mp, 1, -10),
    "garbage-archive": lambda mp: (mp.parent / "cap.ch2.x3a").write_bytes(b"\x00\xffnot an archive" * 4),
    "channel-count": lambda mp: _edit_manifest(mp, channels=4),
    "sample-count": lambda mp: _edit_manifest(mp, samples=2_000),
}


@pytest.mark.parametrize("kind", list(VERIFY_CASES))
def test_verify_x3m_like_x3_tpu(x3m, capsys, kind):
    """The same report (the engine aside: "torch" here) and the same
    verbose lines."""
    from x3_tpu import multichannel as ref

    from x3_tpu_torch import multichannel as port

    mpath, _ = x3m
    VERIFY_CASES[kind](mpath)
    got = port.verify_x3m(mpath, verbose=True, device="cpu")
    got_out = capsys.readouterr().out
    want = ref.verify_x3m(mpath, engine="numpy", verbose=True)
    assert got_out == capsys.readouterr().out
    assert got["engine"] == "torch" and all(r["engine"] == "torch" for r in got["per_channel"])
    assert _engine_aside(got) == _engine_aside(want)
    assert got["ok"] == (kind == "clean")
    if kind != "clean":
        assert got["reason"]


# ---- the CLI's .x3m paths (in a subprocess, on --device cpu) ----


def test_cli_wav_to_x3m_and_back(tmp_path):
    """wav -> x3m gives x3_tpu's files; x3m -> wav gives the input WAV
    back, as x3_tpu's CLI does."""
    from x3_tpu.cli import main as ref_main

    from x3_tpu_torch import multichannel as port

    chans = capture(5, 2 * 1_000 + 77)
    src = tmp_path / "quad.wav"
    port.write_wav_multichannel(src, chans, 96_000)
    for d in ("port", "ref"):
        (tmp_path / d).mkdir()
    r = run_cli("-i", src, "-o", tmp_path / "port" / "quad.x3m", "--block-len", "2", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert ref_main(["-i", str(src), "-o", str(tmp_path / "ref" / "quad.x3m"), "--block-len", "2"]) == 0
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "ref")
    r = run_cli("-i", tmp_path / "port" / "quad.x3m", "-o", tmp_path / "back.wav", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "back.wav").read_bytes() == src.read_bytes()
    assert ref_main(["-i", str(tmp_path / "ref" / "quad.x3m"), "-o", str(tmp_path / "ref.wav"),
                     "--engine", "numpy"]) == 0
    assert (tmp_path / "ref.wav").read_bytes() == src.read_bytes()


def test_cli_x3m_info_prints_x3_tpu_lines(x3m, capsys):
    from x3_tpu.cli import main as ref_main

    mpath, _ = x3m
    r = run_cli("-i", mpath, "--info", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert ref_main(["-i", str(mpath), "--info"]) == 0
    assert r.stdout == capsys.readouterr().out
    assert r.stdout.splitlines()[0] == "channels: 3"
    assert not any(line.startswith("per_channel") for line in r.stdout.splitlines())


@pytest.mark.parametrize("kind,rc", [("clean", 0), ("damaged-channel", 1)])
def test_cli_x3m_verify_prints_x3_tpu_lines(x3m, capsys, kind, rc):
    from x3_tpu.cli import main as ref_main

    mpath, _ = x3m
    VERIFY_CASES[kind](mpath)
    r = run_cli("-i", mpath, "--verify", "--device", "cpu")
    assert r.returncode == rc, r.stderr
    assert ref_main(["-i", str(mpath), "--verify", "--engine", "numpy"]) == rc
    assert r.stdout == capsys.readouterr().out.replace("engine=numpy", "engine=torch")
    assert " channels, " in r.stdout.splitlines()[-1 - rc]


def test_cli_x3m_unreadable_manifest_exits_with_a_message(tmp_path):
    from x3_tpu.cli import main as ref_main

    bad = tmp_path / "junk.x3m"
    bad.write_text("{ not json")
    for flag in ("--info", "--verify"):
        r = run_cli("-i", bad, flag, "--device", "cpu")
        assert r.returncode == 1 and r.stderr.startswith("error: "), r.stderr
        with pytest.raises(SystemExit) as e:
            ref_main(["-i", str(bad), flag])
        assert r.stderr.strip() == str(e.value.code)


# ---- the card that is not there ----

ENTRY_POINTS = {
    "encode_multichannel": lambda m, a, o: m.encode_multichannel(np.zeros((2, 40), np.int16), 8000, o),
    "wav_to_x3m": lambda m, a, o: m.wav_to_x3m(a["wav"], o),
    "decode_multichannel": lambda m, a, o: m.decode_multichannel(a["x3m"]),
    "x3m_to_wav": lambda m, a, o: m.x3m_to_wav(a["x3m"], o),
    "x3m_info": lambda m, a, o: m.x3m_info(a["x3m"]),
    "verify_x3m": lambda m, a, o: m.verify_x3m(a["x3m"]),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda(tmp_path, entry):
    """Called without `device`, every entry point asks for the card; with
    none here, it raises and writes nothing."""
    import torch

    from x3_tpu_torch import multichannel as port

    assert not torch.cuda.is_available()
    src = tmp_path / "in.wav"
    port.write_wav_multichannel(src, np.zeros((2, 40), np.int16), 8000)
    x3m = port.encode_multichannel(np.zeros((2, 40), np.int16), 8000, tmp_path / "in", device="cpu")
    out = tmp_path / ("out.wav" if entry == "x3m_to_wav" else "out.x3m")
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[entry](port, {"wav": src, "x3m": x3m}, out)
    assert not out.exists() and not (tmp_path / "out.ch0.x3a").exists()

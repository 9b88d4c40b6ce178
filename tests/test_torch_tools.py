"""The port's host tools and examples on the CPU, against x3_tpu's.

fuzz_differential, roundtrip_corpus, bench_files and compile_sweep run
with --device(s) cpu (the plain versions) at small geometries: their
inputs, bytes and accept/reject decisions equal x3_tpu's tools, oracle and
engines for the same seeds, and a planted divergence makes each exit 1.
The four torch examples run in one fresh interpreter that imports neither
jax nor x3_tpu."""

import os
import re
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import x3_tpu
from x3_tpu.errors import X3Error
from x3_tpu.models import oracle
from x3_tpu.params import Parameters
from x3_tpu_torch.tools import bench_files, compile_sweep, fuzz_differential, roundtrip_corpus

REPO = Path(__file__).resolve().parent.parent
SMALL = {2, 3, 4, 5, 6}  # GEOMETRIES with blocks_per_frame <= 16
TRIALS = 18  # two of each geometry; ten of them in SMALL


def _reference_tool(name: str):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _reference_trials(seed: int, trials: int) -> list[dict]:
    """x3_tpu's fuzz_differential inputs for (seed, trial): its draws, in
    its order, with its make_signal; the oracle's frame stream; the
    corrupted first payload."""
    ref = _reference_tool("fuzz_differential")
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(trials):
        geo = ref.GEOMETRIES[trial % len(ref.GEOMETRIES)]
        params = Parameters(**geo)
        spf = params.samples_per_frame
        kind = int(rng.integers(0, 6))
        n = int(rng.choice([1, 2, spf - 1, spf, spf + 1, int(rng.integers(1, 3 * spf + 2))]))
        wav = ref.make_signal(rng, n, kind)
        data = oracle.encode(wav, params)
        payloads, counts = fuzz_differential.split_frames(data)
        p = None
        if payloads and len(payloads[0]) > 4:
            b = bytearray(payloads[0])
            i = int(rng.integers(0, len(b)))
            b[i] ^= 1 << int(rng.integers(0, 8))
            p = bytes(b)
        out.append(dict(geo=geo, kind=kind, n=n, wav=wav, data=data, corrupt=p, count0=counts[0]))
    return out


@pytest.fixture(scope="module")
def campaign():
    lines = []
    summary = fuzz_differential.run_campaign(TRIALS, 7, ["cpu"], SMALL, log=lines.append)
    return summary, lines


@pytest.mark.parametrize("seed", [1, 7, 2026])
def test_fuzz_inputs_equal_the_reference_tools(seed):
    """GEOMETRIES, make_signal and the draw order equal x3_tpu's tool, so
    `seed=S trial=T` names the same input in both."""
    ref = _reference_tool("fuzz_differential")
    assert fuzz_differential.GEOMETRIES == ref.GEOMETRIES
    for kind in range(6):
        for n in (0, 1, 5, 4097):
            a, b = np.random.default_rng(seed), np.random.default_rng(seed)
            np.testing.assert_array_equal(fuzz_differential.make_signal(a, n, kind), ref.make_signal(b, n, kind))
    rng = np.random.default_rng(seed)
    for trial, want in enumerate(_reference_trials(seed, TRIALS)):
        geo, kind, n, wav = fuzz_differential.draw_trial(rng, trial)
        assert (geo, kind, n) == (want["geo"], want["kind"], want["n"])
        np.testing.assert_array_equal(wav, want["wav"])
        payloads, _ = fuzz_differential.split_frames(want["data"])
        assert fuzz_differential.corrupt(rng, payloads[0]) == want["corrupt"]


def test_fuzz_differential_cpu_finds_no_failure(campaign):
    summary, lines = campaign
    assert summary["failures"] == 0, lines
    assert summary["checked"] == 10
    assert summary["launches"] == (0, 0)  # the plain versions
    # One call a parameter set, the corrupted frames sharing the clean ones'.
    assert summary["plain_calls"] <= 3 * len(SMALL)


def test_fuzz_encode_bytes_equal_oracle_and_jax(campaign):
    """Every trial's frame stream equals the oracle's, and each checked
    trial's equals x3_tpu's jax engine; the corruptions are the same."""
    summary, _ = campaign
    for rec, want in zip(summary["records"], _reference_trials(7, TRIALS)):
        assert rec["data"] == want["data"], rec["ctx"]
        assert rec["corrupt"] == want["corrupt"], rec["ctx"]
        if rec["checked"]:
            assert x3_tpu.encode(want["wav"], Parameters(**want["geo"]), engine="jax").data == want["data"]


def test_fuzz_corrupt_accept_reject_equals_oracle(campaign):
    summary, _ = campaign
    seen = set()
    for rec, want in zip(summary["records"], _reference_trials(7, TRIALS)):
        if not rec["checked"] or want["corrupt"] is None:
            continue
        got, samples = rec["outcomes"]["cpu"]
        try:
            ref = oracle.decode_frame(want["corrupt"], Parameters(**want["geo"]), want["count0"])
        except X3Error:
            ref = None
        assert (got == "ok") == (ref is not None), (rec["ctx"], got)
        if ref is not None:
            np.testing.assert_array_equal(samples, ref)
        seen.add(got == "ok")
    assert seen  # at least one corrupted frame was checked


def test_fuzz_differential_exits_1_on_a_planted_divergence(monkeypatch, capsys):
    """The second device's encode flips a byte: the cross-device check
    fails and main() exits 1."""
    import x3_tpu_torch.models.encoder as enc

    real = enc.encode

    def planted(samples, params=None, *a, device="cuda", **kw):
        res = real(samples, params, *a, device=device, **kw)
        if str(device) == "cpu:0":
            res.data = res.data[:-1] + bytes([res.data[-1] ^ 0x40])
        return res

    monkeypatch.setattr(enc, "encode", planted)
    assert fuzz_differential.main(["--trials", "4", "--devices", "cpu,cpu:0", "--geometries", "2,3"]) == 1
    out = capsys.readouterr().out
    assert "FAIL encode on cpu:0 differs from cpu" in out and "seed=7 trial=2" in out


def _ref_shim(tmp_path: Path) -> Path:
    """A stand-in reference binary: x3_tpu's CLI on its numpy engine behind
    the reference's --input/--output flags (as tests/test_extbin.py)."""
    shim = tmp_path / "x3"
    shim.write_text(
        "#!/bin/sh\n"
        f'export PYTHONPATH="{REPO}"\n'
        "export JAX_PLATFORMS=cpu\n"
        "export X3_ENGINE=numpy\n"
        f'exec "{sys.executable}" -m x3_tpu "$@"\n'
    )
    shim.chmod(shim.stat().st_mode | stat.S_IXUSR)
    return shim


def test_fuzz_ref_gate_passes_with_a_shim(tmp_path, rng):
    wav = np.clip(np.cumsum(rng.integers(-3, 4, 2_500)), -32768, 32767).astype(np.int16)
    lines = []
    assert fuzz_differential.ref_file_differential(str(_ref_shim(tmp_path)), wav, "shim", "cpu", lines.append) == 0
    assert not lines


def test_fuzz_ref_gate_reports_a_garbage_shim(tmp_path, rng):
    shim = tmp_path / "x3"
    shim.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        '  if [ "$1" = "--output" ]; then out="$2"; fi\n'
        "  shift\n"
        "done\n"
        'printf "not an archive" > "$out"\n'
    )
    shim.chmod(shim.stat().st_mode | stat.S_IXUSR)
    wav = rng.integers(-100, 100, 500).astype(np.int16)
    lines = []
    assert fuzz_differential.ref_file_differential(str(shim), wav, "bad-shim", "cpu", lines.append) >= 1
    assert any(line.startswith("FAIL") for line in lines)


CORPUS_ARGS = ["--devices", "cpu", "--block-len", "2", "--blocks-per-frame", "100"]


def test_roundtrip_corpus_synthetic_equals_numpy_engine(monkeypatch, tmp_path, capsys):
    """--synthetic --devices cpu exits 0, and every archive equals x3_tpu's
    numpy engine's of the same WAV byte for byte.  (block_len 2 keeps the
    decode walk short: an archive's XML has no blocks_per_frame, so its
    decode walks 500 blocks.)"""
    from x3_tpu.files import wav_to_x3a

    runs = []
    real = roundtrip_corpus.run

    def keep(paths, devices, params=None, log=print):
        res = real(paths, devices, params, log)
        for p in paths:  # the synthetic WAVs live in the tool's temporary directory
            want = tmp_path / f"{Path(p).stem}.x3a"
            wav_to_x3a(p, want, params=Parameters(block_len=2, blocks_per_frame=100), engine="numpy")
            runs.append((Path(p).name, res["archives"][Path(p).name]["cpu"], want.read_bytes()))
        return res

    monkeypatch.setattr(roundtrip_corpus, "run", keep)
    assert roundtrip_corpus.main(["--synthetic", *CORPUS_ARGS]) == 0
    assert "7 files x 1 devices: ALL BIT-EXACT" in capsys.readouterr().out
    assert [r[0] for r in runs] == [f"{c}.wav" for c in ("hydrophone_44k", "hydrophone_96k", "silence",
                                                          "white_noise", "clicks", "drift", "tiny")]
    for name, got, want in runs:
        assert got == want, name


def test_roundtrip_corpus_exits_1_on_a_planted_divergence(monkeypatch, tmp_path, capsys):
    import x3_tpu_torch.files as files
    from x3_tpu_torch.utils.wav import write_wav

    write_wav(tmp_path / "a.wav", np.arange(-300, 300, dtype=np.int16), 48_000)
    real = files.wav_to_x3a

    def planted(wav, x3a, *a, device="cuda", **kw):
        res = real(wav, x3a, *a, device=device, **kw)
        if str(device) == "cpu:0":
            data = bytearray(Path(x3a).read_bytes())
            data[-1] ^= 0x40
            Path(x3a).write_bytes(bytes(data))
        return res

    monkeypatch.setattr(files, "wav_to_x3a", planted)
    args = [str(tmp_path), *CORPUS_ARGS]
    args[2] = "cpu,cpu:0"
    assert roundtrip_corpus.main(args) == 1
    out = capsys.readouterr().out
    assert "a.wav                    cpu:0  FAIL FrameHeaderInvalidPayloadCRC" in out
    assert "a.wav                    CROSS-DEVICE ARCHIVE MISMATCH" in out


SWEEP_ARGS = ["--device", "cpu", "--block-len", "4", "--blocks-per-frame", "8", "--enc-batch", "16",
              "--dec-batch", "16"]


def test_compile_sweep_cpu(capsys):
    assert compile_sweep.main(SWEEP_ARGS) == 0
    rows = [line for line in capsys.readouterr().out.splitlines() if line.startswith(("ok", "FAIL"))]
    # L=4, B=8: one width rung (24) and one block rung (4).
    assert len(rows) == 1 + 3 + 2 + 1 and all(r.startswith("ok") for r in rows)
    assert any("n_blocks=16" in r for r in rows)


def test_compile_sweep_exits_1_on_a_planted_divergence(monkeypatch, capsys):
    import x3_tpu_torch.ops.encode_kernel as ek

    real = ek._pack_block_buffers

    def planted(*a):
        words, total_bits, blockfit = real(*a)
        words = words.clone()
        words[0, 0] ^= 1
        return words, total_bits, blockfit

    monkeypatch.setattr(ek, "_pack_block_buffers", planted)
    assert compile_sweep.main(SWEEP_ARGS) == 1
    out = capsys.readouterr().out
    assert "FAIL encode block_pallas F=16 w=24 nw=4" in out and "ok   encode fused_pallas" in out


def test_bench_files_cpu(capsys):
    """x3_tpu's CSV header with `device` for `engine`, and an exact roundtrip."""
    src = (REPO / "tools" / "bench_files.py").read_text()
    head = re.search(r'print\("(file,[^"]*)"\s*"([^"]*)"\)', src)
    assert bench_files.HEADER == (head.group(1) + head.group(2)).replace("engine", "device")
    assert bench_files.main(["--synthetic", "1", "--devices", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == bench_files.HEADER
    row = dict(zip(bench_files.HEADER.split(","), lines[1].split(",")))
    assert (row["file"], row["device"], row["roundtrip_ok"], row["flac_ratio"]) == ("synth0.wav", "cpu", "True",
                                                                                   "#N/A")


@pytest.mark.parametrize("argv", [
    ["fuzz_differential", "--trials", "1"],
    ["roundtrip_corpus", "--synthetic"],
    ["bench_files", "--synthetic", "1"],
    ["compile_sweep"],
])
def test_tools_ask_for_the_card_by_default(argv):
    """Without a GPU, the default device is refused, never replaced by the CPU."""
    mod = {"fuzz_differential": fuzz_differential, "roundtrip_corpus": roundtrip_corpus,
           "bench_files": bench_files, "compile_sweep": compile_sweep}[argv[0]]
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(argv[1:])


def test_examples_run_on_the_cpu_without_jax_or_x3_tpu():
    """The four torch examples with device="cpu" in one fresh interpreter,
    which then holds no jax and no x3_tpu module."""
    code = (
        "import importlib.util, sys\n"
        "for name in ['torch_01_file_conversion', 'torch_02_streaming_capture', 'torch_03_batch_and_mesh',\n"
        "             'torch_04_multihost_pipeline']:\n"
        "    spec = importlib.util.spec_from_file_location(name, f'examples/{name}.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    mod.main(device='cpu')\n"
        "bad = [m for m in sys.modules if m in ('jax', 'x3_tpu') or m.startswith(('jax.', 'x3_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "clean"
    assert any(line.startswith("bit-exact roundtrip OK on cpu") for line in lines)
    assert any(line.startswith("encoded 1M samples on cpu") for line in lines)
    assert any("mesh: Mesh(['cpu', 'cpu']" in line for line in lines)
    assert any(line.startswith("2-host sharded pipeline on cpu: 6 files") for line in lines)

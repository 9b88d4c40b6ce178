"""Corpus roundtrip gate of the port (the port's tools/roundtrip_corpus.py,
an analogue of the reference's test/test_wavs.sh).

For every .wav in a corpus directory (or the synthetic corpus classes when
none is given): encode -> decode through the file layer on each device and
compare sample-exactly with the original, at the same sample rate, and
check that every device wrote the same archive.  Exit code 0 only if
everything is bit-exact.

    python -m x3_tpu_torch.tools.roundtrip_corpus /path/to/corpus --devices cuda,cpu
    python -m x3_tpu_torch.tools.roundtrip_corpus --synthetic                 # built-in classes
    python -m x3_tpu_torch.tools.roundtrip_corpus --synthetic --devices cpu --block-len 2 --blocks-per-frame 100

With a reference `x3` binary (utils.extbin) each file also goes through
it: its archive must equal the first device's byte for byte, and each side
must decode the other's archive to the input.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np


def synthetic_corpus(tmp: Path) -> list[Path]:
    """The BASELINE.json workload classes as synthetic WAVs in `tmp`."""
    from ..utils.wav import write_wav

    rng = np.random.default_rng(1234)
    n = 123_456
    t = np.arange(n)
    cases = {
        "hydrophone_44k": (np.clip(np.round(1500 * np.sin(2 * np.pi * t / 9773) + rng.normal(0, 5, n)), -32768, 32767), 44100),
        "hydrophone_96k": (np.clip(np.round(800 * np.sin(2 * np.pi * t / 3001) + rng.normal(0, 12, n)), -32768, 32767), 96000),
        "silence": (np.zeros(n), 44100),
        "white_noise": (rng.integers(-32768, 32768, n), 44100),
        "clicks": (np.where(rng.random(n) < 0.001, rng.integers(-30000, 30000, n), rng.integers(-3, 4, n)), 192000),
        "drift": (np.clip(np.cumsum(rng.integers(-50, 51, n)), -32768, 32767), 22050),
        "tiny": (rng.integers(-100, 100, 7), 8000),
    }
    paths = []
    for name, (wav, rate) in cases.items():
        p = tmp / f"{name}.wav"
        write_wav(p, np.asarray(wav, dtype=np.int16), rate)
        paths.append(p)
    return paths


def ref_checks(ref_bin: str, wav_path: Path, our_x3a: Path, tmp: Path, device, log=print) -> int:
    """The reference binary's archive of `wav_path` against ours, and each
    side's decode of the other's archive; returns the failures."""
    from ..files import x3a_to_wav
    from ..utils.extbin import ref_convert
    from ..utils.wav import read_wav

    orig, rate = read_wav(wav_path)
    ref_x3a = tmp / f"{wav_path.stem}.ref.x3a"
    ref_back = tmp / f"{wav_path.stem}.refback.wav"
    our_back = tmp / f"{wav_path.stem}.oursref.wav"
    failures = 0
    try:
        ref_convert(ref_bin, wav_path, ref_x3a)
        if ref_x3a.read_bytes() != our_x3a.read_bytes():
            log(f"{wav_path.name:24s} REFERENCE ARCHIVE CMP MISMATCH")
            failures += 1
        ref_convert(ref_bin, our_x3a, ref_back)
        got, grate = read_wav(ref_back)
        if grate != rate or not np.array_equal(got, orig):
            log(f"{wav_path.name:24s} REFERENCE DECODE OF OUR ARCHIVE DIFFERS")
            failures += 1
        errors = x3a_to_wav(ref_x3a, our_back, device=device)
        got, grate = read_wav(our_back)
        if errors != 0 or grate != rate or not np.array_equal(got, orig):
            log(f"{wav_path.name:24s} OUR DECODE OF REFERENCE ARCHIVE DIFFERS")
            failures += 1
        log(f"{wav_path.name:24s} refbin OK (cmp + both cross-decodes)")
    except Exception as e:  # noqa: BLE001 - the gate reports, it does not die
        log(f"{wav_path.name:24s} REFBIN FAIL {type(e).__name__}: {e}")
        failures += 1
    return failures


def run(paths, devices, params=None, log=print) -> dict:
    """Roundtrip each WAV of `paths` on each device of `devices` (the
    first is the one the reference binary is held to).  Returns
    {"failures", "archives": {file name: {device: archive bytes}}}."""
    from ..device import resolve_device
    from ..files import wav_to_x3a, x3a_to_wav
    from ..utils.extbin import find_reference_x3
    from ..utils.wav import read_wav

    devs = [resolve_device(d) for d in devices]
    ref_bin = find_reference_x3()
    log(f"reference x3 binary: {ref_bin} (byte-level cmp active)" if ref_bin
        else "reference x3 binary: not found - byte-level cmp skipped (set X3_REFERENCE_BIN or put `x3` on PATH)")
    failures = 0
    archives = {}
    with tempfile.TemporaryDirectory(prefix="x3corpus_") as td:
        tmp = Path(td)
        for wav_path in paths:
            wav_path = Path(wav_path)
            orig, rate = read_wav(wav_path)
            arch = archives[wav_path.name] = {}
            first_x3a = None
            for dev in devs:
                tag = str(dev).replace(":", "")
                x3a = tmp / f"{wav_path.stem}.{tag}.x3a"
                back = tmp / f"{wav_path.stem}.{tag}.wav"
                try:
                    wav_to_x3a(wav_path, x3a, params=params, device=dev)
                    arch[str(dev)] = x3a.read_bytes()
                    first_x3a = first_x3a or x3a
                    errors = x3a_to_wav(x3a, back, device=dev)
                    got, grate = read_wav(back)
                    ok = errors == 0 and grate == rate and np.array_equal(got, orig)
                    log(f"{wav_path.name:24s} {str(dev):6s} {'OK' if ok else 'FAIL'}  "
                        f"ratio={orig.nbytes / len(arch[str(dev)]):5.2f}x")
                except Exception as e:  # noqa: BLE001 - the gate reports, it does not die
                    ok = False
                    log(f"{wav_path.name:24s} {str(dev):6s} FAIL {type(e).__name__}: {e}")
                failures += 0 if ok else 1
            if len(set(arch.values())) > 1:
                log(f"{wav_path.name:24s} CROSS-DEVICE ARCHIVE MISMATCH")
                failures += 1
            if ref_bin and first_x3a is not None:
                failures += ref_checks(ref_bin, wav_path, first_x3a, tmp, devs[0], log)
    return {"failures": failures, "archives": archives}


def main(argv=None) -> int:
    from .fuzz_soak import parse_params

    ap = argparse.ArgumentParser(prog="python -m x3_tpu_torch.tools.roundtrip_corpus",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("corpus", nargs="?", help="directory of .wav files")
    ap.add_argument("--synthetic", action="store_true", help="use the built-in corpus classes")
    ap.add_argument("--devices", default="cuda,cpu", help="comma-separated devices (default cuda,cpu)")
    ap.add_argument("--block-len", type=int, default=None, help="encode geometry (default: Parameters())")
    ap.add_argument("--blocks-per-frame", type=int, default=None)
    args = ap.parse_args(argv)
    devices = args.devices.split(",")
    with tempfile.TemporaryDirectory(prefix="x3synth_") as td:
        paths = sorted(Path(args.corpus).glob("*.wav")) if args.corpus else synthetic_corpus(Path(td))
        if not paths:
            print("no .wav files found")
            return 2
        failures = run(paths, devices, parse_params(args))["failures"]
    print(f"\n{len(paths)} files x {len(devices)} devices: "
          f"{'ALL BIT-EXACT' if failures == 0 else f'{failures} FAILURES'}")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

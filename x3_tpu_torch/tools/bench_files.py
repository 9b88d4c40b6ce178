"""Per-file benchmark of the port (the port's tools/bench_files.py, an
analogue of the reference's test/bench.sh).

Times the file layer's encode and decode of each WAV on each device and
prints, as CSV, wall seconds, MB/s, the compression ratio, the process's
peak RSS and whether the roundtrip was exact.  Each direction is called
once to warm up (the first call on a card builds or loads the kernels),
then once timed; a timed call on a card ends in torch.cuda.synchronize().
With a `flac` binary (utils.extbin) flac is timed too, the reference's
comparison codec; without one its columns read #N/A, as in the
reference's CSV.

    python -m x3_tpu_torch.tools.bench_files file1.wav file2.wav ...
    python -m x3_tpu_torch.tools.bench_files --synthetic 3            # 3 synthetic files
    python -m x3_tpu_torch.tools.bench_files --synthetic 1 --devices cpu
"""

from __future__ import annotations

import argparse
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HEADER = ("file,mb,device,encode_s,encode_mbs,decode_s,decode_mbs,ratio,rss_mb,"
          "roundtrip_ok,flac_enc_s,flac_dec_s,flac_ratio")


def peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def make_corpus(n_frames: int, spf: int, seed: int = 7) -> np.ndarray:
    """Low-entropy hydrophone-like corpus (drift + small noise): a copy of
    bench.make_corpus."""
    rng = np.random.default_rng(seed)
    n = n_frames * spf
    t = np.arange(n, dtype=np.float64)
    slow = 2000.0 * np.sin(2 * np.pi * t / 9773.0)
    noise = rng.normal(0.0, 6.0, n)
    return np.clip(np.round(slow + noise), -32768, 32767).astype(np.int16)


def synth_files(n: int, tmpdir: Path) -> list[Path]:
    from ..utils.wav import write_wav

    paths = []
    for i in range(n):
        wav = make_corpus(64 * (i + 1), 10_000, seed=i)
        p = tmpdir / f"synth{i}.wav"
        write_wav(p, wav, 96_000)
        paths.append(p)
    return paths


def bench_flac(wav_path: Path, tmpdir: Path):
    from ..utils.extbin import find_flac

    flac = find_flac()
    if not flac:
        return "#N/A", "#N/A", "#N/A"
    out = tmpdir / (wav_path.stem + ".flac")
    t0 = time.perf_counter()
    subprocess.run([flac, "--totally-silent", "--compression-level-0", "-f", "-o", str(out), str(wav_path)],
                   check=True)
    enc_s = time.perf_counter() - t0
    back = tmpdir / (wav_path.stem + "_flac.wav")
    t0 = time.perf_counter()
    subprocess.run([flac, "--totally-silent", "-d", "-f", "-o", str(back), str(out)], check=True)
    dec_s = time.perf_counter() - t0
    ratio = wav_path.stat().st_size / out.stat().st_size
    return f"{enc_s:.3f}", f"{dec_s:.3f}", f"{ratio:.2f}"


def timed(fn, dev) -> float:
    """Wall seconds of fn(), synchronised on a card."""
    import torch

    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def bench(paths, devices, tmpdir: Path, log=print) -> list[dict]:
    """Print the header and a CSV row a (file, device); returns the rows."""
    from ..device import resolve_device
    from ..files import wav_to_x3a, x3a_to_wav
    from ..utils.wav import read_wav

    devs = [resolve_device(d) for d in devices]
    log(HEADER)
    rows = []
    for wav_path in paths:
        mb = wav_path.stat().st_size / 1e6
        flac_cols = bench_flac(wav_path, tmpdir)
        orig, _ = read_wav(wav_path)
        for dev in devs:
            tag = str(dev).replace(":", "")
            x3a = tmpdir / f"{wav_path.stem}.{tag}.x3a"
            back = tmpdir / f"{wav_path.stem}.{tag}.back.wav"
            encode = lambda: wav_to_x3a(wav_path, x3a, device=dev)  # noqa: E731
            decode = lambda: x3a_to_wav(x3a, back, device=dev)  # noqa: E731
            encode()  # warm
            enc_s = timed(encode, dev)
            decode()  # warm
            dec_s = timed(decode, dev)
            got, _ = read_wav(back)
            row = dict(file=wav_path.name, mb=mb, device=str(dev), encode_s=enc_s, decode_s=dec_s,
                       ratio=wav_path.stat().st_size / x3a.stat().st_size, rss_mb=peak_rss_mb(),
                       roundtrip_ok=bool(np.array_equal(orig, got)))
            rows.append(row)
            log(f"{row['file']},{mb:.1f},{row['device']},{enc_s:.3f},{mb / enc_s:.1f},"
                f"{dec_s:.3f},{mb / dec_s:.1f},{row['ratio']:.2f},{row['rss_mb']:.0f},"
                f"{row['roundtrip_ok']},{flac_cols[0]},{flac_cols[1]},{flac_cols[2]}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m x3_tpu_torch.tools.bench_files",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="*", help="WAV files to benchmark")
    ap.add_argument("--synthetic", type=int, default=0, help="generate N synthetic hydrophone files")
    ap.add_argument("--devices", default="cuda", help="comma-separated devices (default cuda)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="x3bench_") as td:
        tmpdir = Path(td)
        paths = [Path(p) for p in args.files]
        if args.synthetic:
            paths += synth_files(args.synthetic, tmpdir)
        if not paths:
            ap.error("no input files (pass WAVs or --synthetic N)")
        rows = bench(paths, args.devices.split(","), tmpdir)
    return 0 if all(r["roundtrip_ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

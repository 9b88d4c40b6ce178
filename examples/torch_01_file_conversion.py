"""Convert a WAV to .x3a and back with the PyTorch port, checking the
roundtrip is bit-exact.

    python examples/torch_01_file_conversion.py [in.wav] [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from x3_tpu_torch import wav_to_x3a, x3a_to_wav
from x3_tpu_torch.utils.wav import read_wav, write_wav


def main(wav_path=None, device="cuda"):
    with tempfile.TemporaryDirectory(prefix="x3_example_") as td:  # keep cwd clean
        work = Path(td)
        if wav_path is None:
            # No input given: synthesize a hydrophone-like file.
            rng = np.random.default_rng(0)
            t = np.arange(200_000)
            wav = np.clip(
                np.round(1200 * np.sin(2 * np.pi * t / 9773) + rng.normal(0, 5, t.size)),
                -32768, 32767,
            ).astype(np.int16)
            wav_path = str(work / "example.wav")
            write_wav(wav_path, wav, 96_000)

        result = wav_to_x3a(wav_path, str(work / "example.x3a"), verbose=True, device=device)
        errors = x3a_to_wav(str(work / "example.x3a"), str(work / "example_back.wav"), device=device)
        orig, _ = read_wav(wav_path)
        back, _ = read_wav(str(work / "example_back.wav"))
    assert errors == 0 and np.array_equal(orig, back), "roundtrip mismatch!"
    print(f"bit-exact roundtrip OK on {device}; {orig.nbytes} -> {result.nbytes} bytes")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("wav", nargs="?", help="a mono 16-bit WAV (default: a synthetic one)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.wav, args.device)

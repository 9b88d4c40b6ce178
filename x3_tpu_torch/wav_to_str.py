"""Test helper: a WAV file's spec and samples as text, 16 samples a line
(x3_tpu.wav_to_str, the reference's wav_to_str).

    python -m x3_tpu_torch.wav_to_str --wav FILE
"""

from __future__ import annotations

import argparse
import sys

from .utils.wav import read_wav


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="wav_to_str", description="wav_to_str - output a wav a string.")
    parser.add_argument("-w", "--wav", metavar="FILE", required=True, help="The input file, a .wav file")
    args = parser.parse_args(argv)

    samples, sample_rate = read_wav(args.wav)
    out = sys.stdout
    out.write("bits_per_sample: 16\n")
    out.write("channels: 1\n")
    out.write(f"sample_rate: {sample_rate}\n")
    n = 0
    for s in samples:
        if n == 16:
            out.write("\n")
            n = 0
        n += 1
        out.write(f"{s} ")
    out.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

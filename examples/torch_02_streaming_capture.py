"""Bounded-memory streaming encode of a (simulated) live capture with the
PyTorch port.

    python examples/torch_02_streaming_capture.py [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from x3_tpu_torch import StreamEncoder


def capture_chunks(total, chunk, rng):
    made = 0
    state = 0
    while made < total:
        n = min(chunk, total - made)
        steps = rng.integers(-6, 7, n)
        block = np.clip(state + np.cumsum(steps), -32768, 32767).astype(np.int16)
        state = int(block[-1])
        made += n
        yield block


def main(device="cuda"):
    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory(prefix="x3_example_") as td:
        out = Path(td) / "capture.x3a"
        with StreamEncoder(out, sample_rate=96_000, device=device) as enc:
            for chunk in capture_chunks(total=1_000_000, chunk=48_000, rng=rng):
                enc.write(chunk)  # memory stays bounded by the batch size
            stats = enc.close().stats
    print(f"encoded 1M samples on {device}; code usage:", stats.tolist())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)

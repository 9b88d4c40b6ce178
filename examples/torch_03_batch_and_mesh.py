"""Batch-convert many files with the PyTorch port, optionally sharded over
a mesh: every card, or two CPU entries under --device cpu.

    python examples/torch_03_batch_and_mesh.py [--device cpu] [--no-mesh]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from x3_tpu_torch.multifile import wav_to_x3a_batch, x3a_to_wav_batch
from x3_tpu_torch.parallel.mesh import make_mesh
from x3_tpu_torch.utils.wav import write_wav


def main(use_mesh=True, device="cuda"):
    rng = np.random.default_rng(2)
    with tempfile.TemporaryDirectory(prefix="x3_example_") as td:  # keep cwd clean
        work = Path(td)
        wavs, x3as, backs = [], [], []
        for i in range(8):
            wav = np.clip(np.cumsum(rng.integers(-9, 10, 120_000)), -32768, 32767).astype(np.int16)
            write_wav(str(work / f"batch{i}.wav"), wav, 44_100)
            wavs.append(str(work / f"batch{i}.wav"))
            x3as.append(str(work / f"batch{i}.x3a"))
            backs.append(str(work / f"batch{i}_back.wav"))

        mesh = None
        if use_mesh:  # frames shard across the mesh's entries
            mesh = make_mesh() if device == "cuda" else make_mesh(["cpu"] * 2)
        results = wav_to_x3a_batch(wavs, x3as, mesh=mesh, device=device)
        counts = x3a_to_wav_batch(x3as, backs, mesh=mesh, device=device)
    print("files:", len(results), "samples decoded per file:", counts, "mesh:", mesh)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--no-mesh", action="store_true", help="one device, no mesh")
    args = ap.parse_args()
    main(not args.no_mesh, args.device)

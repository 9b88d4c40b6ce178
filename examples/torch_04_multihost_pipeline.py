"""Multi-process input pipeline with the PyTorch port: every process
converts its shard of the corpus.

The codec needs no collectives (frames are self-contained), so scaling to
many hosts is an input-pipeline concern: shard the file list, convert each
shard on the process's local mesh, done; no process talks to another.

In a real torch.distributed job (one process a host, its rank and world
size given to init_process_group) this is:

    from x3_tpu_torch.parallel.multihost import local_mesh, shard_worklist
    mine = shard_worklist(all_wavs)                   # this process's files
    wav_to_x3a_batch(mine, [out(p) for p in mine], mesh=local_mesh())

This demo simulates two hosts in one process with explicit indices.

    python examples/torch_04_multihost_pipeline.py [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from x3_tpu_torch.multifile import wav_to_x3a_batch, x3a_to_wav_batch
from x3_tpu_torch.utils.wav import read_wav, write_wav


def main(device="cuda"):
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="x3mh_") as td:
        tmp = Path(td)
        wavs, wav_paths, x3a_paths, back_paths = [], [], [], []
        for i in range(6):
            w = np.clip(np.cumsum(rng.integers(-6, 7, 30_000)), -32768, 32767).astype(np.int16)
            p = tmp / f"in{i}.wav"
            write_wav(p, w, 96_000)
            wavs.append(w)
            wav_paths.append(p)
            x3a_paths.append(tmp / f"out{i}.x3a")
            back_paths.append(tmp / f"back{i}.wav")

        # "Host 0" and "host 1" each convert their strided shard.
        for host in range(2):
            wav_to_x3a_batch(wav_paths, x3a_paths, process_index=host, process_count=2, device=device)
            x3a_to_wav_batch(x3a_paths, back_paths, process_index=host, process_count=2, device=device)

        for w, b in zip(wavs, back_paths):
            got, rate = read_wav(b)
            assert rate == 96_000 and np.array_equal(got, w)
    print(f"2-host sharded pipeline on {device}: {len(wavs)} files converted + verified bit-exact")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)

"""x3_tpu_torch — the X3 codec's batched encode/decode path in PyTorch.

A port of x3_tpu's batched path to PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (csrc/*.cu, built with nvcc on first use):

* `encode(samples, device="cuda")` — frame stream + statistics, byte-
  identical to x3_tpu.encode (models/encoder.py);
* `decode_frames_batch(payloads, n_samples, check_crcs=..., device=...)`
  and `decode_frame` — batched, CRC-checked frame decode
  (models/decoder.py);
* `ops.encode_kernel.encode_frames(..., pack_mode=...)` — one encode batch
  by any of the JAX package's pack routes ("block", "block_pallas",
  "fused_pallas", "segment");
* `wav_to_x3a`, `x3a_to_wav`, `x3a_info`, `verify_x3a` and `X3aReader` —
  the file layer (files.py), and `python -m x3_tpu_torch`, its CLI;
* `wav_to_x3a_batch` / `x3a_to_wav_batch` — many files sharing device
  batches (multifile.py), and the multi-channel .x3m manifests
  (multichannel.py);
* `Channel`, `IterChannel`, `StreamEncoder`, `resolve_engine` and the
  error root `X3Error`, as x3_tpu exports them;
* `parallel.mesh` — frame-sharded encode and decode over a mesh of
  devices (the batch APIs' `mesh=`), `entry` — the flagship step and the
  multi-device dry run, `utils.profiling` — the always-on span recorder
  (`span`, `spans`, `counters`), trace and warm-up hooks, and `tools` —
  the decode parity check, the fuzz soak and x3_tpu's host tools
  (differential fuzz, corpus roundtrip, per-file bench, cold-build sweep)
  across devices;
* `bench` — x3_tpu's bench.py on the port (`python3 bench_torch.py`): device
  and file MB/s and exactness of the three corpus classes as one JSON line.

device="cuda" runs the kernels (and raises when there is no GPU);
device="cpu" runs their plain PyTorch versions.  The package shares no
code with x3_tpu and never imports it or jax: the host modules it needs
(parameters, constants, errors, the archive container, the host CRC) are
its own copies, held to the originals by tests/test_torch_standalone.py.
"""

from __future__ import annotations

__all__ = [
    "Parameters",
    "X3aSpec",
    "X3Error",
    "Channel",
    "IterChannel",
    "encode",
    "decode_frame",
    "decode_frames_batch",
    "build_archive_header",
    "walk_frames",
    "wav_to_x3a",
    "x3a_to_wav",
    "x3a_info",
    "verify_x3a",
    "X3aReader",
    "StreamEncoder",
    "wav_to_x3a_batch",
    "x3a_to_wav_batch",
    "resolve_engine",
]

_FILES = ("wav_to_x3a", "x3a_to_wav", "x3a_info", "verify_x3a", "X3aReader")

from .archive import build_archive_header, walk_frames
from .errors import X3Error
from .params import Parameters, X3aSpec


def __getattr__(name):
    # Lazy imports keep `import x3_tpu_torch` light (no torch until needed).
    if name == "encode":
        from .models.encoder import encode

        return encode
    if name in ("decode_frame", "decode_frames_batch"):
        from .models import decoder

        return getattr(decoder, name)
    if name in _FILES:
        from . import files

        return getattr(files, name)
    if name in ("wav_to_x3a_batch", "x3a_to_wav_batch"):
        from . import multifile

        return getattr(multifile, name)
    if name in ("Channel", "IterChannel"):
        from . import channel

        return getattr(channel, name)
    if name == "StreamEncoder":
        from .streaming import StreamEncoder

        return StreamEncoder
    if name == "resolve_engine":
        from .engine import resolve_engine

        return resolve_engine
    raise AttributeError(name)

"""x3_tpu_torch — the X3 codec's batched encode/decode path in PyTorch.

A port of x3_tpu's main path to PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (csrc/*.cu, built with nvcc on first use):

* `encode(samples, device="cuda")` — frame stream + statistics, byte-
  identical to x3_tpu.encode (models/encoder.py);
* `decode_frames_batch(payloads, n_samples, check_crcs=..., device=...)`
  and `decode_frame` — batched, CRC-checked frame decode
  (models/decoder.py).

device="cuda" runs the kernels (and raises when there is no GPU);
device="cpu" runs their plain PyTorch versions.  The framework-free host
modules of x3_tpu (parameters, constants, errors, archive container, the
numpy oracle) are shared, not copied; the names re-exported below come
from there.  This package never imports jax.
"""

from __future__ import annotations

__all__ = [
    "Parameters",
    "X3aSpec",
    "encode",
    "decode_frame",
    "decode_frames_batch",
    "build_archive_header",
    "walk_frames",
    "oracle",
]

_SHARED = {
    "Parameters": "x3_tpu.params",
    "X3aSpec": "x3_tpu.params",
    "build_archive_header": "x3_tpu.archive",
    "walk_frames": "x3_tpu.archive",
}


def __getattr__(name):
    # Lazy imports keep `import x3_tpu_torch` light (no torch until needed).
    import importlib

    if name == "encode":
        from .models.encoder import encode

        return encode
    if name in ("decode_frame", "decode_frames_batch"):
        from .models import decoder

        return getattr(decoder, name)
    if name in _SHARED:
        return getattr(importlib.import_module(_SHARED[name]), name)
    if name == "oracle":
        return importlib.import_module("x3_tpu.models.oracle")
    raise AttributeError(name)

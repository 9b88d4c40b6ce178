"""x3_tpu_torch.multifile.encode_streams over all of a client's streams in
one call (one frame worklist, shared batches), and build_archive_header:
(header, [frames of each stream]), as encode.py returns them."""

from __future__ import annotations

from .. import compare
from ..reduce import ENCODE_BATCH_FRAMES

DIRECTION = "encode"


def prepare(streams, sample_rate, params, device):
    return streams


def call(streams, sample_rate, params, device):
    import x3_tpu_torch
    from x3_tpu_torch import multifile

    head = x3_tpu_torch.build_archive_header(sample_rate, params)
    return head, [r.data for r in multifile.encode_streams(streams, params, device=device)]


def batches(streams, samples_per_frame):
    """The worklist's batches: every stream's frames, BATCH_FRAMES a batch."""
    frames = sum(-(-len(s) // samples_per_frame) for s in streams)
    return -(-frames // ENCODE_BATCH_FRAMES)


def check(streams, outputs, _streams, sample_rate, ref):
    return compare.check_encode(outputs, ref)

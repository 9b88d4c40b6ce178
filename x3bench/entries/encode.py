"""x3_tpu_torch.encode of each stream, and build_archive_header: the .x3a
archive of every stream in memory, as (header, [frames of each stream]),
which a writer writes one after the other."""

from __future__ import annotations

from .. import compare
from ..reduce import ENCODE_BATCH_FRAMES

DIRECTION = "encode"


def prepare(streams, sample_rate, params, device):
    return streams


def call(streams, sample_rate, params, device):
    import x3_tpu_torch

    head = x3_tpu_torch.build_archive_header(sample_rate, params)
    return head, [x3_tpu_torch.encode(s, params, device=device).data for s in streams]


def batches(streams, samples_per_frame):
    """One encode call a stream, each in batches of BATCH_FRAMES frames."""
    frames = [-(-len(s) // samples_per_frame) for s in streams]
    return sum(-(-f // ENCODE_BATCH_FRAMES) for f in frames)


def check(streams, outputs, _streams, sample_rate, ref):
    return compare.check_encode(outputs, ref)

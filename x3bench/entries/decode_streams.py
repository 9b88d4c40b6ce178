"""x3_tpu_torch.multifile.decode_streams over every stream's archive in
one call, the archives in memory; set-up makes them with
x3_tpu_torch.encode and build_archive_header."""

from __future__ import annotations

from .. import compare

DIRECTION = "decode"


def prepare(streams, sample_rate, params, device):
    import x3_tpu_torch

    head = x3_tpu_torch.build_archive_header(sample_rate, params)
    return [head + x3_tpu_torch.encode(s, params, device=device).data for s in streams]


def call(archives, sample_rate, params, device):
    from x3_tpu_torch import multifile

    return multifile.decode_streams(archives, device=device)


def batches(streams, samples_per_frame):
    return None


def check(archives, outputs, streams, sample_rate, ref):
    return compare.check_decode(archives, outputs, streams, sample_rate, ref)

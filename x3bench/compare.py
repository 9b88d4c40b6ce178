"""What decides `correct`: the program's outputs against the plain
reference's, and the control that has to fail that comparison.

Every number compared is exact, so every limit is 0: a byte of an archive
or a sample of a decoded stream that differs from the reference's fails
the run.  The reference (reference/x3codec.py) works out each stream's
archive again from the samples the benchmark made; the right decode of an
archive is the stream it was made from."""

from __future__ import annotations

import numpy as np

from .reference import x3codec

LIMITS = {
    "archive_bytes_differing": 0,  # encode: the calls' archives against the reference's
    "setup_archive_bytes_differing": 0,  # decode: the archives set-up made against the reference's
    "samples_differing": 0,  # decode: the calls' samples against the streams
    "failed_calls": 0,  # calls that raised (a CRC mismatch the program reports raises)
}


def bytes_differing(a: bytes, b: bytes) -> int:
    """Positions at which two byte strings differ, the longer's tail counted."""
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, n)
    y = np.frombuffer(b, np.uint8, n)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def samples_differing(got, want: np.ndarray) -> int:
    got = np.asarray(got)
    n = min(len(got), len(want))
    return int(np.count_nonzero(got[:n] != want[:n])) + abs(len(got) - len(want))


class Reference:
    """The reference's archive header and the frames of each of a
    client's streams, and the payload bytes of those frames (the
    roofline's count of the work)."""

    def __init__(self, streams, sample_rate: int, params: dict):
        self.header = x3codec.archive_header(sample_rate, params)
        made = [x3codec.encode_frames(s, params) for s in streams]
        self.frames = [f.data for f in made]
        self.payload_bytes = sum(int(f.payload_lens.sum()) for f in made)

    @property
    def archives(self) -> list[bytes]:
        return [self.header + f for f in self.frames]


def check_encode(outputs, ref: Reference) -> dict:
    """Each kept call's (header, frames of every stream) against the
    reference's: an archive is its header followed by its frames."""
    bad = 0
    for header, frames in outputs:
        bad += bytes_differing(header, ref.header)
        if len(frames) != len(ref.frames):
            bad += sum(len(f) for f in ref.frames)
            continue
        bad += sum(bytes_differing(a, b) for a, b in zip(frames, ref.frames))
    return {"archive_bytes_differing": bad}


def check_decode(setup_archives, outputs, streams, sample_rate: int, ref: Reference) -> dict:
    """The archives set-up made against the reference's, and each kept
    call's (samples, sample rate) of every stream against the stream."""
    want = ref.archives
    setup_bad = sum(bytes_differing(a, b) for a, b in zip(setup_archives, want))
    setup_bad += sum(len(a) for a in want[len(setup_archives):])
    bad = 0
    for decoded in outputs:
        for i, want in enumerate(streams):
            if i >= len(decoded):
                bad += len(want)
                continue
            got, rate = decoded[i]
            bad += len(want) if rate != sample_rate else samples_differing(got, want)
        bad += sum(len(d[0]) for d in decoded[len(streams):])
    return {"setup_archive_bytes_differing": setup_bad, "samples_differing": bad}


def control_streams(streams):
    """The control: the stream at 15 bits (its lowest bit dropped), the
    step that would buy a lossless codec speed and ratio at the cost of
    the one guarantee it states."""
    return [np.asarray(s) & np.int16(-2) for s in streams]

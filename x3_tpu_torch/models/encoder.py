"""Public encode API of the port (x3_tpu.models.encoder.encode, jax branch).

Takes a mono int16 stream and returns the concatenated frame stream
(20-byte headers + payloads, no archive header) plus code-usage
statistics, byte-identical to x3_tpu.encode with any engine.  Frames are
sliced into [F, S] batches, encoded on `device` at an adaptive payload
width (W) and block-buffer width (NW) rung, escalated sticky when a batch
overflows, and assembled on the device: each frame's payload bytes are
gathered behind a 20-byte hole, read back in one copy, and the headers
written into the holes on the host.

The encode loop runs one batch ahead, as x3_tpu's does: `submit` stages a
batch in pinned memory and enqueues its copy, K2 + K1 and the read-back
of its sizes without blocking the host; `finish` waits on that batch's
event, escalates, and assembles it, while the card already works on the
next batch."""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from .. import constants
from ..device import resolve_device
from ..errors import MoreThanOneChannel
from ..ops.crc import crc16_many
from ..ops.encode_kernel import (
    block_route,
    block_width_rungs,
    encode_frames,
    fits_block_width,
    fits_width,
    width_rungs,
)
from ..params import Parameters
from .sharding import Mesh, shard_map
from .staging import StagingPool, record, to_host, wait


class EncodeResult:
    """Encoded frame stream plus statistics (x3_tpu.models.encoder.EncodeResult)."""

    def __init__(self, data: bytes, stats: np.ndarray, nbytes: int | None = None):
        self.data = data
        self.stats = stats  # int64 [6]
        self.nbytes = len(data) if nbytes is None else nbytes
        self.width_used: int | None = None  # final payload-width rung
        self.block_width_used: int | None = None  # final block-buffer rung

    def format_stats(self) -> str:
        t = max(1, int(self.stats.sum()))
        pct = [100.0 * s / t for s in self.stats]
        return (
            "\nStatistics:\n"
            f"  Rice-0: {pct[0]:.4f}%\n"
            f"  Rice-1: {pct[1]:.4f}%\n"
            f"  Rice-2: {pct[2]:.4f}%\n"
            f"  Rice-3: {pct[3]:.4f}%\n"
            f"  BFP: {pct[4]:.4f}%\n"
            f"  Pass-through {pct[5]:.4f}%\n"
        )


def build_frame_headers(n_samples: np.ndarray, source_id: int, payload_lens: np.ndarray,
                        payload_crcs: np.ndarray) -> np.ndarray:
    """uint8 [F, 20] frame headers for many frames at once (the channels
    byte holds the source id, as the reference writes it)."""
    f = len(n_samples)
    h = np.zeros((f, constants.FRAME_HEADER_LENGTH), dtype=np.uint8)
    h[:, 0] = 0x78
    h[:, 1] = 0x33
    h[:, constants.P_SOURCE_ID] = source_id
    h[:, constants.P_CHANNELS] = source_id
    h[:, constants.P_SAMPLES] = (n_samples >> 8) & 0xFF
    h[:, constants.P_SAMPLES + 1] = n_samples & 0xFF
    h[:, constants.P_PAYLOAD_SIZE] = (payload_lens >> 8) & 0xFF
    h[:, constants.P_PAYLOAD_SIZE + 1] = payload_lens & 0xFF
    hcrc = crc16_many(h[:, : constants.P_HEADER_CRC], np.full(f, constants.P_HEADER_CRC))
    h[:, constants.P_HEADER_CRC] = (hcrc >> 8) & 0xFF
    h[:, constants.P_HEADER_CRC + 1] = hcrc & 0xFF
    h[:, constants.P_PAYLOAD_CRC] = (payload_crcs >> 8) & 0xFF
    h[:, constants.P_PAYLOAD_CRC + 1] = payload_crcs & 0xFF
    return h


def _assemble(headers: np.ndarray, payload: np.ndarray, nbytes: np.ndarray) -> bytes:
    """header || payload[:nbytes] of every frame, concatenated.  One
    bytes.join over memoryview slices: the result is the only copy.  (A
    boolean-mask compaction of [F, 20 + 4W] rows was ten times slower than
    the C memcpy it replaced on the music corpus; see PERF.md.)"""
    hl, pl = headers.shape[1], payload.shape[1]
    h = memoryview(np.ascontiguousarray(headers, dtype=np.uint8).reshape(-1))
    p = memoryview(np.ascontiguousarray(payload, dtype=np.uint8).reshape(-1))
    parts = []
    for i, n in enumerate(np.asarray(nbytes).tolist()):
        parts.append(h[i * hl : (i + 1) * hl])
        parts.append(p[i * pl : i * pl + n])
    return b"".join(parts)


# The JAX bench's batch shape; not yet a measured choice for the card.
DEFAULT_BATCH_FRAMES = 768


def _start_rung(rungs: list[int], hint: int | None) -> int:
    i = 0
    if hint is not None:
        while i < len(rungs) - 1 and rungs[i] < hint:
            i += 1
    return i


def frame_bytes(words: torch.Tensor, nbytes: torch.Tensor, total: int) -> torch.Tensor:
    """uint8 [total] on words' device: for each frame in order, a 20-byte
    hole (zeros) then its first nbytes[f] payload bytes, the big-endian
    bytes of its int32 words [F, W]; total = sum(20 + nbytes).  One gather:
    an exclusive cumsum of 20 + nbytes places the frames, and each byte is
    cut from its word by an arithmetic shift and a mask (no uint32 ops)."""
    F, W = words.shape
    dev = words.device
    hl = constants.FRAME_HEADER_LENGTH
    size = nbytes.to(torch.int64) + hl
    first = torch.cumsum(size, 0) - size + hl  # each frame's first payload byte
    frame = torch.repeat_interleave(torch.arange(F, device=dev), size, output_size=total)
    k = torch.arange(total, device=dev) - first[frame]  # byte of the payload; < 0 in a hole
    kk = k.clamp(min=0)
    word = words.reshape(-1)[frame * W + (kk >> 2)]
    byte = (word >> (24 - 8 * (kk & 3))) & 0xFF
    return torch.where(k >= 0, byte, 0).to(torch.uint8)


def assemble_frames(headers: np.ndarray, words: torch.Tensor, nbytes: torch.Tensor,
                    offsets: np.ndarray) -> np.ndarray:
    """_assemble's bytes as a new uint8 array, the payloads gathered on
    words' device (frame_bytes) and read back in one copy.

    headers: uint8 [F, 20]; words: int32 [F, W] big-endian payload words
    and nbytes int [F], on one device; offsets: int64 [F + 1] on the host,
    the exclusive cumsum of 20 + nbytes (frame f starts at offsets[f])."""
    host = to_host(frame_bytes(words, nbytes, int(offsets[-1])))
    wait(record(words.device))
    if words.is_cuda:  # out of the pinned block, which the next batch reuses
        host = torch.empty(host.shape, dtype=host.dtype).copy_(host)
    out = host.numpy()
    out[offsets[:-1, None] + np.arange(headers.shape[1])] = headers
    return out


class EncodedBatch(NamedTuple):
    """One finished batch: `frames` (uint8, header || payload of every
    frame, frame f at frames[offsets[f]:offsets[f + 1]]), per-frame
    nbytes, crc and stats [F, 6], and the rungs the stream stands at."""

    frames: np.ndarray
    nbytes: np.ndarray
    crc: np.ndarray
    stats: np.ndarray
    rung: int
    nw_rung: int
    offsets: np.ndarray


class Submitted(NamedTuple):
    """A batch in flight (submit): its host inputs, the rungs it runs at,
    its device outputs, and the pinned read-back of nbytes, blockfit_bits,
    crc and stats [F, 9], valid once `event` has completed."""

    batch_t: torch.Tensor
    n_valid_t: torch.Tensor
    params: Parameters
    mesh: Mesh
    rung: int
    nw_rung: int
    res: dict
    sizes: torch.Tensor
    event: torch.cuda.Event | None


def submit(batch_t: torch.Tensor, n_valid_t: torch.Tensor, params: Parameters, rung: int,
           nw_rung: int, mesh: Mesh | None = None) -> Submitted:
    """Enqueue one [F, S] batch at the rungs `rung` / `nw_rung` of
    width_rungs / block_width_rungs without blocking the host: the copy of
    the batch to the mesh's devices (non-blocking from pinned memory), K2 +
    K1 through encode_frames, the copy of its sizes into pinned memory, and
    an event behind them.  batch_t and n_valid_t are host tensors (pinned
    for a CUDA mesh) that must stay unchanged until the batch is finished:
    a re-dispatch reads them again, and finish reads n_valid_t.

    mesh: the models.sharding.Mesh to shard the batch over (F a multiple
    of its size), by default a one-entry mesh of the tensors' device."""
    mesh = mesh or Mesh([batch_t.device])
    w, nw = width_rungs(params)[rung], block_width_rungs(params)[nw_rung]
    res = shard_map(lambda s, n: encode_frames(s, n, params, "block", w, nw), mesh, batch_t, n_valid_t)
    cols = [res["nbytes"][:, None], res["blockfit_bits"][:, None], res["crc"][:, None], res["stats"]]
    sizes = to_host(torch.cat(cols, dim=1))
    return Submitted(batch_t, n_valid_t, params, mesh, rung, nw_rung, res, sizes,
                     record(mesh.devices[0]))


def finish(sub: Submitted, rung: int, nw_rung: int, source_id: int = 1) -> EncodedBatch:
    """Wait for a submitted batch, escalate the sticky rungs, and assemble
    its frames (assemble_frames).

    rung / nw_rung: where the stream stands now, at or above the rungs the
    batch ran at (an earlier batch may have raised them since).  A batch
    that fits the rungs it ran at keeps its result; otherwise the rungs
    move to the first that fit, at or above where the stream stands, and
    the batch is dispatched again there.  So every stream ends at the
    rungs of a serial loop, whatever ran ahead.  K2 and K6 keep no
    NW-sized block buffers and blockfit_bits is exact at any rung, so on
    their routes an NW overflow only moves the rung (reported as
    block_width_used); the torch pack drops pieces past the NW rung and is
    dispatched again."""
    params = sub.params
    rungs, nw_rungs = width_rungs(params), block_width_rungs(params)
    wait(sub.event)
    sizes = sub.sizes.numpy()
    nbytes, blockfit = sizes[:, 0], sizes[:, 1]
    redo = block_route() == "pairs" and not fits_block_width(blockfit, nw_rungs[sub.nw_rung], params)
    while nw_rung < len(nw_rungs) - 1 and not fits_block_width(blockfit, nw_rungs[nw_rung], params):
        nw_rung += 1
    if not fits_width(nbytes, rungs[sub.rung], params):
        redo = True
        while rung < len(rungs) - 1 and not fits_width(nbytes, rungs[rung], params):
            rung += 1
    if redo:
        sub = submit(sub.batch_t, sub.n_valid_t, params, rung, nw_rung, sub.mesh)
        wait(sub.event)
        sizes = sub.sizes.numpy()
        nbytes = sizes[:, 0]
    crc, stats = sizes[:, 2], sizes[:, 3:]
    offsets = np.zeros(len(nbytes) + 1, dtype=np.int64)
    np.cumsum(nbytes.astype(np.int64) + constants.FRAME_HEADER_LENGTH, out=offsets[1:])
    headers = build_frame_headers(sub.n_valid_t.numpy(), source_id, nbytes, crc)
    frames = assemble_frames(headers, sub.res["payload_words"], sub.res["nbytes"], offsets)
    return EncodedBatch(frames, nbytes, crc, stats, rung, nw_rung, offsets)


def encode_batch(batch_t: torch.Tensor, n_valid_t: torch.Tensor, params: Parameters, rung: int,
                 nw_rung: int, mesh: Mesh | None = None) -> EncodedBatch:
    """Encode one [F, S] batch (K2 + K1 on "cuda") at the payload-width and
    block-width rungs `rung` / `nw_rung`, escalated sticky when it
    overflows: finish(submit(...)), source id 1.

    mesh: the models.sharding.Mesh to shard the batch over (F a multiple
    of its size; each shard on its entry's device), by default a one-entry
    mesh of the tensors' device; the rungs escalate once for all shards,
    from the gathered sizes."""
    return finish(submit(batch_t, n_valid_t, params, rung, nw_rung, mesh), rung, nw_rung)


def _stage(buf, samples: np.ndarray, start: int, f: int, spf: int):
    """Frames [start / spf, + f) of `samples` into the staging buffer: the
    whole frames as one copy of a [f, spf] view, only the partial last
    frame padded.  Returns the (samples, n_valid) tensors of the batch."""
    batch, n_valid = buf.samples[:f], buf.n_valid[:f]
    b, nv = batch.numpy(), n_valid.numpy()
    n_full = min(f, (len(samples) - start) // spf)
    with warnings.catch_warnings():  # `samples` may be read-only; it is only read
        warnings.simplefilter("ignore", UserWarning)
        whole = torch.from_numpy(samples[start : start + n_full * spf].reshape(n_full, spf))
    batch[:n_full].copy_(whole)  # torch's copy runs on several threads, numpy's on one
    nv[:n_full] = spf
    if n_full < f:
        tail = samples[start + n_full * spf :]
        b[n_full, : len(tail)] = tail
        b[n_full, len(tail) :] = 0
        nv[n_full] = len(tail)
    return batch, n_valid


def encode(
    samples,
    params: Parameters | None = None,
    batch_frames: int = DEFAULT_BATCH_FRAMES,
    source_id: int = 1,
    width_hint: int | None = None,
    block_width_hint: int | None = None,
    device="cuda",
) -> EncodeResult:
    """Encode a mono int16 stream into a frame stream (no archive header).

    width_hint / block_width_hint: start the W / NW rung ladders at the
    smallest rung covering this many words; the result carries the final
    rungs in `width_used` / `block_width_used`.
    device: "cuda" (kernels K2 + K1) or "cpu" (their plain versions)."""
    dev = resolve_device(device)
    params = params or Parameters()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    if samples.ndim != 1:
        raise MoreThanOneChannel("expected a mono 1-D sample array")

    spf = params.samples_per_frame
    n = len(samples)
    n_frames = -(-n // spf) if n else 0
    rungs = width_rungs(params)
    nw_rungs = block_width_rungs(params)
    rung = _start_rung(rungs, width_hint)
    nw_rung = _start_rung(nw_rungs, block_width_hint)
    stats = np.zeros(6, dtype=np.int64)
    out_parts: list[np.ndarray] = []

    # One batch ahead: batch i + 1 is submitted before batch i is finished,
    # so its staging, copy and kernels overlap batch i's read-back and
    # assembly.  Two staging buffers: batch i + 1 takes the one batch i - 1
    # gave back when it was finished.
    mesh = Mesh([dev])
    bases = range(0, n_frames, batch_frames)
    pool = StagingPool(min(2, len(bases)), min(batch_frames, n_frames), spf, dev)
    pending = None
    for base in [*bases, None]:
        nxt = None
        if base is not None:
            buf = pool.acquire()
            f = min(batch_frames, n_frames - base)
            nxt = buf, submit(*_stage(buf, samples, base * spf, f, spf), params, rung, nw_rung, mesh)
        if pending is not None:
            buf, sub = pending
            done = finish(sub, rung, nw_rung, source_id)
            pool.release(buf)
            rung, nw_rung = done.rung, done.nw_rung
            stats += done.stats.sum(axis=0, dtype=np.int64)
            out_parts.append(done.frames)
        pending = nxt

    result = EncodeResult(b"".join(out_parts), stats)
    result.width_used = rungs[rung]
    result.block_width_used = nw_rungs[nw_rung]
    return result

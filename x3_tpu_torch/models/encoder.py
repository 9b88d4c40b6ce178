"""Public encode API of the port (x3_tpu.models.encoder.encode, jax branch).

Takes a mono int16 stream and returns the concatenated frame stream
(20-byte headers + payloads, no archive header) plus code-usage
statistics, byte-identical to x3_tpu.encode with any engine.  Frames are
sliced into [F, S] batches, encoded on `device` at an adaptive payload
width (W) and block-buffer width (NW) rung, escalated sticky when a batch
overflows, and assembled on the host by numpy."""

from __future__ import annotations

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


def encode_batch(batch_t: torch.Tensor, n_valid_t: torch.Tensor, params: Parameters, rung: int,
                 nw_rung: int, mesh: Mesh | None = None):
    """Encode one [F, S] batch (K2 + K1 on "cuda") at the payload-width and
    block-width rungs `rung` / `nw_rung` of width_rungs / block_width_rungs,
    escalated sticky when it overflows.

    mesh: the models.sharding.Mesh to shard the batch over (F a multiple
    of its size; each shard on its entry's device), by default a one-entry
    mesh of the tensors' device; the rungs escalate once for all shards,
    from the gathered sizes.

    Returns (payload uint8 [F, 4*wcols] of big-endian payload bytes, with
    only the populated word columns copied to the host; nbytes [F]; crc
    [F]; stats int [F, 6]; the rung and nw_rung the batch ended at)."""
    rungs = width_rungs(params)
    nw_rungs = block_width_rungs(params)
    mesh = mesh or Mesh([batch_t.device])

    def run(w, nw):
        return shard_map(lambda s, n: encode_frames(s, n, params, "block", w, nw), mesh, batch_t, n_valid_t)

    w, nw = rungs[rung], nw_rungs[nw_rung]
    res = run(w, nw)
    nbytes = res["nbytes"].cpu().numpy()
    blockfit = res["blockfit_bits"].cpu().numpy()
    # Sticky escalation straight to the first fitting rung.  K2 and K6
    # keep no NW-sized block buffers and blockfit_bits is exact at any
    # rung, so on their routes an NW overflow only moves the rung
    # (reported as block_width_used); the torch pack drops pieces past
    # the NW rung and is dispatched again.
    redo = block_route() == "pairs" and not fits_block_width(blockfit, nw, params)
    while nw_rung < len(nw_rungs) - 1 and not fits_block_width(blockfit, nw, params):
        nw_rung += 1
        nw = nw_rungs[nw_rung]
    if not fits_width(nbytes, w, params):
        redo = True
        while rung < len(rungs) - 1:
            rung += 1
            if fits_width(nbytes, rungs[rung], params):
                break
        w = rungs[rung]
    if redo:
        res = run(w, nw)
        nbytes = res["nbytes"].cpu().numpy()
    # Copy only the populated word columns to the host.
    maxw = max(1, (int(nbytes.max(initial=0)) + 3) // 4)
    wcols = min(w, 1 << (maxw - 1).bit_length())
    words = res["payload_words"][:, :wcols].contiguous().cpu().numpy()
    payload = words.view(np.uint32).byteswap().view(np.uint8)  # big-endian bytes
    return payload, nbytes, res["crc"].cpu().numpy(), res["stats"].cpu().numpy(), rung, nw_rung


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
    out_parts: list[bytes] = []

    # One batch at a time: enqueue, read back the sizes, escalate if needed.
    # (The JAX package enqueues batch i+1 before checking batch i, which
    # over-escalates by one rung when an in-flight batch overflows; on one
    # CUDA stream that order would buy no overlap, so the port escalates
    # from the rung each batch actually ran at.)
    for base in range(0, n_frames, batch_frames):
        f_batch = min(batch_frames, n_frames - base)
        batch = np.zeros((f_batch, spf), dtype=np.int16)
        n_valid = np.zeros(f_batch, dtype=np.int32)
        start = base * spf
        n_full = min(f_batch, (n - start) // spf)
        if n_full:
            batch[:n_full] = samples[start : start + n_full * spf].reshape(n_full, spf)
            n_valid[:n_full] = spf
        if n_full < f_batch:
            tail = samples[start + n_full * spf :]
            batch[n_full, : len(tail)] = tail
            n_valid[n_full] = len(tail)
        payload, nbytes, crc, bstats, rung, nw_rung = encode_batch(
            torch.from_numpy(batch).to(dev), torch.from_numpy(n_valid).to(dev), params, rung, nw_rung
        )
        stats += bstats.sum(axis=0, dtype=np.int64)
        headers = build_frame_headers(n_valid, source_id, nbytes, crc)
        out_parts.append(_assemble(headers, payload, nbytes))

    result = EncodeResult(b"".join(out_parts), stats)
    result.width_used = rungs[rung]
    result.block_width_used = nw_rungs[nw_rung]
    return result

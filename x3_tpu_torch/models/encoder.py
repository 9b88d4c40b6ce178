"""Public encode API of the port (x3_tpu.models.encoder.encode, jax branch).

Takes a mono int16 stream and returns the concatenated frame stream
(20-byte headers + payloads, no archive header) plus code-usage
statistics, byte-identical to x3_tpu.encode with any engine.  Frames are
sliced into [F, S] batches, encoded on `device` at an adaptive payload
width (W) and block-buffer width (NW) rung, escalated sticky when a batch
overflows, and assembled on the host with the JAX package's header and
assembly code."""

from __future__ import annotations

import numpy as np
import torch

from x3_tpu.errors import MoreThanOneChannel
from x3_tpu.models.encoder import EncodeResult, _assemble, build_frame_headers
from x3_tpu.params import Parameters

from ..device import resolve_device
from ..ops.encode_kernel import (
    block_width_rungs,
    encode_frames,
    fits_block_width,
    fits_width,
    width_rungs,
)

# The JAX bench's batch shape; not yet a measured choice for the card.
DEFAULT_BATCH_FRAMES = 768


def _start_rung(rungs: list[int], hint: int | None) -> int:
    i = 0
    if hint is not None:
        while i < len(rungs) - 1 and rungs[i] < hint:
            i += 1
    return i


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
        batch_t = torch.from_numpy(batch).to(dev)
        n_valid_t = torch.from_numpy(n_valid).to(dev)

        w, nw = rungs[rung], nw_rungs[nw_rung]
        res = encode_frames(batch_t, n_valid_t, params, w, nw)
        nbytes = res["nbytes"].cpu().numpy()
        blockfit = res["blockfit_bits"].cpu().numpy()
        # Sticky escalation straight to the first fitting rung.  No kernel
        # truncates by NW and blockfit_bits is exact at any rung, so the NW
        # rung (reported as block_width_used) never needs a second dispatch.
        while nw_rung < len(nw_rungs) - 1 and not fits_block_width(blockfit, nw, params):
            nw_rung += 1
            nw = nw_rungs[nw_rung]
        if not fits_width(nbytes, w, params):
            while rung < len(rungs) - 1:
                rung += 1
                if fits_width(nbytes, rungs[rung], params):
                    break
            w = rungs[rung]
            res = encode_frames(batch_t, n_valid_t, params, w, nw)
            nbytes = res["nbytes"].cpu().numpy()
        # Copy only the populated word columns to the host.
        maxw = max(1, (int(nbytes.max(initial=0)) + 3) // 4)
        wcols = min(w, 1 << (maxw - 1).bit_length())
        words = res["payload_words"][:, :wcols].contiguous().cpu().numpy()
        payload = words.view(np.uint32).byteswap().view(np.uint8)  # big-endian bytes
        crc = res["crc"].cpu().numpy()
        stats += res["stats"].cpu().numpy().sum(axis=0, dtype=np.int64)
        headers = build_frame_headers(n_valid, source_id, nbytes, crc)
        out_parts.append(_assemble(headers, payload, nbytes))

    result = EncodeResult(b"".join(out_parts), stats)
    result.width_used = rungs[rung]
    result.block_width_used = nw_rungs[nw_rung]
    return result

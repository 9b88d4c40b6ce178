"""Public decode API of the port (x3_tpu.models.decoder).

Decodes many frame payloads at once: the payloads are joined into one
buffer and copied to the device with their offsets and lengths (pinned,
non-blocking on a card), where the big-endian payload words [F, W] are
gathered with a width and block count that follow the batch
(decode_geometry) and the lane count padded to a power of two; the
frames are walked there, optionally with the payload CRCs checked too,
and read back in one pinned copy behind an event: as one array a frame
(views of it) or, compacted on the device, as the frames' samples back to
back (decode_frames_flat)."""

from __future__ import annotations

import numpy as np
import torch

from ..errors import decode_error
from ..ops.encode_kernel import frame_geometry, width_rungs
from ..params import Parameters
from .sharding import check_mesh, shard_map
from .staging import host_empty, record, to_host, wait


def decode_geometry(params: Parameters, n_samples, payload_lens):
    """(n_blocks, w_words) decode specialization for a batch
    (x3_tpu.models.decoder.decode_geometry).

    n_blocks: None while every frame fits params' geometry; otherwise the
      smallest power-of-two multiple of blocks_per_frame covering the
      batch's largest sample count (blocks_per_frame is not in the archive
      XML, so foreign frames may be larger).
    w_words: the smallest width rung holding the longest payload, doubling
      past the worst case when needed."""
    S, B, L, _ = frame_geometry(params)
    max_n = max((int(n) for n in n_samples), default=0)
    maxlen = max((int(p) for p in payload_lens), default=0)
    n_blocks = None
    if max_n > S:
        n_blocks = B
        while 1 + n_blocks * L < max_n:
            n_blocks *= 2
    rungs = width_rungs(params)
    w = next((r for r in rungs if maxlen <= r * 4), None)
    if w is None:
        w = rungs[-1]
        while maxlen > w * 4:
            w *= 2
    return n_blocks, w


def _lanes(f: int, shards: int) -> int:
    """Lanes of a decode batch of f frames: `shards` equal shards of a
    power of two lanes each."""
    per_shard = -(-f // shards)
    return shards * (1 << max(0, (per_shard - 1).bit_length()))


def payload_batch(payloads, n_samples, params: Parameters, shards: int = 1):
    """The host arrays of a decode batch: (buf uint8 [Fp, w*4] of
    zero-padded payloads, ns int32 [Fp], plens int32 [Fp], n_blocks), with
    the lane count Fp padded to `shards` equal shards of a power of two
    lanes each (pad lanes hold n = 0 and no bytes).  payload_words(buf)
    holds the words decode_frames_batch gathers on the device."""
    arrs = [np.frombuffer(p, dtype=np.uint8) for p in payloads]
    n_blocks, w = decode_geometry(params, n_samples, [len(a) for a in arrs])
    fp = _lanes(len(arrs), shards)
    buf = np.zeros((fp, w * 4), dtype=np.uint8)
    ns = np.zeros(fp, dtype=np.int32)
    plens = np.zeros(fp, dtype=np.int32)
    for i, (arr, n) in enumerate(zip(arrs, n_samples)):
        buf[i, : len(arr)] = arr
        ns[i] = n
        plens[i] = len(arr)
    return buf, ns, plens, n_blocks


def upload_words(payloads, n_samples, params: Parameters, device, shards: int = 1):
    """One decode batch on `device`: (words int32 [Fp, w], ns int32 [Fp],
    plens int32 [Fp], n_blocks), equal to payload_words of payload_batch's
    buffer and its ns and plens.  The payloads are copied back to back into
    one pinned buffer, their offsets, lengths and sample counts into
    another, and both go to the device without blocking; the words are
    gathered there (ops.decode_kernel.packed_payload_words)."""
    from ..ops.decode_kernel import packed_payload_words

    f = len(payloads)
    lens = [len(p) for p in payloads]
    n_blocks, w = decode_geometry(params, n_samples, lens)
    meta_t = host_empty((3, _lanes(f, shards)), torch.int32, device)
    meta = meta_t.numpy()  # offsets, lengths, sample counts; pad lanes: no bytes
    meta[:] = 0
    meta[1, :f] = lens
    meta[2, :f] = n_samples
    meta[0, 1:f] = np.cumsum(lens[:-1])
    meta[0, f:] = sum(lens)
    data_t = host_empty(sum(lens), torch.uint8, device)
    data, at = memoryview(data_t.numpy()), 0  # the payloads back to back, copied once
    for p, n in zip(payloads, lens):
        data[at : at + n] = p
        at += n
    meta_t, data_t = meta_t.to(device, non_blocking=True), data_t.to(device, non_blocking=True)
    return packed_payload_words(data_t, meta_t[0], meta_t[1], w), meta_t[2], meta_t[1], n_blocks


def _walk(payloads, n_samples, params: Parameters, checked: bool, mesh):
    """Upload and walk one decode batch on the mesh (each shard walked, and
    CRC-checked when `checked`, on its entry's device): (out int16 [Fp,
    S'], err int32 [Fp], crc int32 [Fp] or None, ns int32 [Fp]), gathered on
    the mesh's first device, nothing read back."""
    from ..ops.decode_kernel import decode_words, decode_words_checked

    words, ns, plens, n_blocks = upload_words(payloads, n_samples, params, mesh.devices[0], mesh.size)
    run = decode_words_checked if checked else decode_words
    out, err, crc = shard_map(lambda w, n, pl: run(w, n, pl, params, n_blocks), mesh, words, ns, plens)
    return out, err, (crc if checked else None), ns


def _read_back(f: int, err, crc, check_crcs, *more):
    """Host copies of err[:f], the CRC verdicts and `more`, read after one
    event behind them all."""
    host = [to_host(t) for t in (err[:f], *((crc[:f],) if crc is not None else ()), *more)]
    wait(record(err.device))
    out = [t.numpy() for t in host]
    if crc is not None:
        out[1] = out[1] == np.asarray(check_crcs, dtype=np.int64)
    return out


def decode_frames_batch(payloads, n_samples, params: Parameters | None = None,
                        check_crcs=None, device="cuda", mesh=None):
    """Decode a list of frame payloads (bytes) with their sample counts.

    Returns (list of int16 arrays, err int32 array), or with check_crcs (the
    expected payload CRC16s) also a bool array crc_ok, computed on the
    device over the same words.  err holds the per-frame codes of
    ops.decode_kernel (0 ok, 1 invalid BFP, 2 OOB inverse, 3 overrun).
    The frames' arrays are views of one array that this call allocates and
    no other call shares (x3_tpu returns copies; the values are equal).
    mesh: a models.sharding.Mesh of `device`'s type to shard the batch over
    (each shard walked and CRC-checked on its entry's device)."""
    mesh = check_mesh(mesh, device)
    params = params or Parameters()
    f = len(payloads)
    if f == 0:
        empty = ([], np.zeros(0, np.int32))
        return empty if check_crcs is None else empty + (np.zeros(0, bool),)
    out, err, crc, _ = _walk(payloads, n_samples, params, check_crcs is not None, mesh)
    *head, host = _read_back(f, err, crc, check_crcs, out[:f])
    outs = [host[i, :n] for i, n in enumerate(np.asarray(n_samples).tolist())]
    return (outs, *head)


def compact_frames(out: torch.Tensor, ns: torch.Tensor, total: int) -> torch.Tensor:
    """The first ns[f] samples of each row f of out [F', S'] (f < len(ns)),
    back to back: one gather on out's device, placed by an exclusive
    cumsum of ns; total = sum(ns)."""
    f, width = ns.shape[0], out.shape[1]
    size = ns.to(torch.int64)
    shift = torch.arange(f, device=out.device) * width - (torch.cumsum(size, 0) - size)
    idx = torch.arange(total, device=out.device) + torch.repeat_interleave(shift, size, output_size=total)
    return out.reshape(-1)[idx]


def decode_frames_flat(payloads, n_samples, params: Parameters | None = None,
                       check_crcs=None, device="cuda", mesh=None):
    """decode_frames_batch with the frames' samples back to back: (int16
    [sum(n_samples)], err) or, with check_crcs, (samples, err, crc_ok).
    The samples are compacted on the device (compact_frames) and read back
    in one copy; frame i is samples[c[i]:c[i + 1]] for c the cumsum of
    n_samples from 0, error lanes included, equal to decode_frames_batch's
    arrays."""
    mesh = check_mesh(mesh, device)
    params = params or Parameters()
    f = len(payloads)
    if f == 0:
        empty = (np.zeros(0, np.int16), np.zeros(0, np.int32))
        return empty if check_crcs is None else empty + (np.zeros(0, bool),)
    out, err, crc, ns = _walk(payloads, n_samples, params, check_crcs is not None, mesh)
    flat = compact_frames(out, ns[:f], int(np.sum(n_samples, dtype=np.int64)))
    *head, host = _read_back(f, err, crc, check_crcs, flat)
    return (host, *head)


def decode_frame(payload: bytes, params: Parameters, samples: int, device="cuda") -> np.ndarray:
    """Decode one frame payload; a decode error raises the matching
    reference error class (errors.decode_error)."""
    outs, err = decode_frames_batch([payload], [samples], params, device=device)
    if err[0]:
        raise decode_error(err[0])
    return outs[0]

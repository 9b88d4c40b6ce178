"""Public decode API of the port (x3_tpu.models.decoder).

Every decode goes through decode_frames_indexed, which decodes many frames
at once from one host buffer: the bytes from the first payload to the end
of the last go to the device in one copy, with the payloads' offsets and
lengths (pinned, non-blocking on a card), where the big-endian payload
words [F, W] are gathered with a width and block count that follow the
batch (decode_geometry) and the lane count padded to a power of two; the
frames are walked there, optionally with the payload CRCs checked too, and
their samples compacted on the device (compact_frames) and read back back
to back in one pinned copy behind an event.  The buffer holds runs of an
archive's bytes as read (the file and batch decodes) or the payloads of a
list joined into one (decode_frames_flat; decode_frames_batch splits its
samples into one view a frame).  decode_frames_indexed's host side up to
the read-back's wait is the x3.decode.launch span (utils.profiling), with
the bytes its uploads copy to a card (h2d_bytes)."""

from __future__ import annotations

import numpy as np
import torch

from ..errors import decode_error
from ..ops.encode_kernel import frame_geometry, width_rungs
from ..params import Parameters
from ..utils import profiling
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
    max_n = int(np.max(n_samples, initial=0))
    maxlen = int(np.max(payload_lens, initial=0))
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


def _join(payloads, device):
    """The payloads back to back in one new host buffer (pinned for a CUDA
    device), copied once: (uint8 tensor, offsets int64 [F], lengths int64
    [F])."""
    lens = np.fromiter((len(p) for p in payloads), dtype=np.int64, count=len(payloads))
    offs = np.cumsum(lens) - lens
    data_t = host_empty(int(lens.sum()), torch.uint8, device)
    data, at = memoryview(data_t.numpy()), 0
    for p, n in zip(payloads, lens.tolist()):
        data[at : at + n] = p
        at += n
    return data_t, offs, lens


def _host_bytes(data) -> torch.Tensor:
    """`data` as a host uint8 tensor: a tensor as it is, a buffer viewed
    (copied only when it is read-only, as bytes are)."""
    if isinstance(data, torch.Tensor):
        return data
    arr = np.frombuffer(data, dtype=np.uint8)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def upload_span(data: torch.Tensor, offsets, lengths, n_samples, params: Parameters, device,
                shards: int = 1):
    """One decode batch on `device` from the payloads at `offsets` (of
    `lengths` bytes) in the host uint8 tensor `data`: (words int32 [Fp,
    w], ns int32 [Fp], plens int32 [Fp], n_blocks), equal to payload_words
    of payload_batch's buffer and its ns and plens.  The bytes from the
    first payload's start to the last one's end (what lies between them,
    such as frame headers, with them) go to the device in one non-blocking
    copy, and the offsets, lengths and sample counts in another; the words
    are gathered there (ops.decode_kernel.packed_payload_words).  `data`
    must not change until the copy has completed: pinned memory is read by
    the device after this call returns."""
    from ..ops.decode_kernel import packed_payload_words

    f = len(offsets)
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    n_blocks, w = decode_geometry(params, n_samples, lengths)
    lo, hi = int(offsets.min()), int((offsets + lengths).max())
    meta_t = host_empty((3, _lanes(f, shards)), torch.int32, device)
    meta = meta_t.numpy()  # offsets, lengths, sample counts; pad lanes: no bytes
    meta[:] = 0
    meta[0, :f] = offsets - lo
    meta[0, f:] = hi - lo
    meta[1, :f] = lengths
    meta[2, :f] = n_samples
    meta_t, span = meta_t.to(device, non_blocking=True), data[lo:hi].to(device, non_blocking=True)
    if span.is_cuda:
        profiling.add(h2d_bytes=meta_t.nbytes + span.nbytes)
    return packed_payload_words(span, meta_t[0], meta_t[1], w), meta_t[2], meta_t[1], n_blocks


def decode_frames_batch(payloads, n_samples, params: Parameters | None = None,
                        check_crcs=None, device="cuda", mesh=None):
    """Decode a list of frame payloads (bytes) with their sample counts.

    Returns (list of int16 arrays, err int32 array), or with check_crcs (the
    expected payload CRC16s) also a bool array crc_ok, computed on the
    device over the same words.  err holds the per-frame codes of
    ops.decode_kernel (0 ok, 1 invalid BFP, 2 OOB inverse, 3 overrun).
    The frames' arrays are decode_frames_flat's samples split at the cumsum
    of n_samples: views of one array that this call allocates and no other
    call shares (x3_tpu returns copies; the values are equal).
    mesh: a models.sharding.Mesh of `device`'s type to shard the batch over
    (each shard walked and CRC-checked on its entry's device)."""
    samples, *rest = decode_frames_flat(payloads, n_samples, params, check_crcs, device, mesh)
    cuts = np.cumsum(np.asarray(n_samples, dtype=np.int64))[:-1]
    return (np.split(samples, cuts) if len(payloads) else [], *rest)


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
    """Decode a list of frame payloads (bytes) with their sample counts,
    the frames' samples back to back: (int16 [sum(n_samples)], err) or,
    with check_crcs, (samples, err, crc_ok), as decode_frames_batch gives
    them.  decode_frames_indexed over the payloads joined into one buffer."""
    mesh = check_mesh(mesh, device)
    data, offsets, lengths = _join(payloads, mesh.devices[0])
    return decode_frames_indexed(data, offsets, n_samples, lengths, params, check_crcs, device, mesh)


def decode_frames_indexed(data, offsets, n_samples, payload_lens, params: Parameters | None = None,
                          check_crcs=None, device="cuda", mesh=None, *, arrange=None):
    """Decode the frames whose payloads lie in one host buffer `data` at
    `offsets`, of `payload_lens` bytes, with their sample counts (the
    counterpart of x3_tpu.native.decode_frames_mt over an index_frames
    index): (int16 [sum(n_samples)], err) or, with check_crcs (the
    expected payload CRC16s), (samples, err, crc_ok), as decode_frames_flat
    returns them.  The span from the first payload to the end of the last
    goes to the device in one copy (upload_span); the samples are
    compacted on the device (compact_frames) and read back in one copy;
    frame i is samples[c[i]:c[i + 1]] for c the cumsum of n_samples from 0,
    error lanes included.

    data: a host uint8 tensor (pinned for a CUDA device, to copy without
      blocking), or bytes, bytearray or a uint8 array.
    mesh: a models.sharding.Mesh of `device`'s type to shard the batch
      over.
    arrange: a function of the compacted samples (a tensor on the mesh's
      first device) whose result is read back in their place, such as the
      interleave of multichannel.x3m_to_wav; not called for no frames."""
    mesh = check_mesh(mesh, device)
    params = params or Parameters()
    f = len(offsets)
    if f == 0:
        empty = (np.zeros(0, np.int16), np.zeros(0, np.int32))
        return empty if check_crcs is None else empty + (np.zeros(0, bool),)
    from ..ops.decode_kernel import decode_words, decode_words_checked

    run = decode_words if check_crcs is None else decode_words_checked
    with profiling.span("x3.decode.launch", h2d_bytes=0):
        # Each shard walked (and CRC-checked) on its mesh entry's device,
        # gathered on the first; then the host copies behind one event.
        words, ns, plens, n_blocks = upload_span(_host_bytes(data), offsets, payload_lens, n_samples,
                                                 params, mesh.devices[0], mesh.size)
        out, err, crc = shard_map(lambda w, n, pl: run(w, n, pl, params, n_blocks), mesh, words, ns, plens)
        flat = compact_frames(out, ns[:f], int(np.sum(n_samples, dtype=np.int64)))
        checks = () if check_crcs is None else (crc[:f],)
        host = [to_host(t) for t in (err[:f], *checks, flat if arrange is None else arrange(flat))]
        event = record(err.device)
    wait(event)
    err, *crc, samples = (t.numpy() for t in host)
    return (samples, err, *(c == np.asarray(check_crcs, dtype=np.int64) for c in crc))


def decode_frame(payload: bytes, params: Parameters, samples: int, device="cuda") -> np.ndarray:
    """Decode one frame payload; a decode error raises the matching
    reference error class (errors.decode_error)."""
    outs, err = decode_frames_batch([payload], [samples], params, device=device)
    if err[0]:
        raise decode_error(err[0])
    return outs[0]

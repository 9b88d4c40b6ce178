"""Public decode API of the port (x3_tpu.models.decoder).

Decodes many frame payloads at once: the payloads are zero-padded into a
[F, W*4] buffer whose width and block count follow the batch
(decode_geometry), the lane count is padded to a power of two, and the
frames are walked on `device`, optionally with the payload CRCs checked
there too."""

from __future__ import annotations

import numpy as np
import torch

from x3_tpu.errors import decode_error
from x3_tpu.params import Parameters

from ..device import resolve_device
from ..ops.encode_kernel import frame_geometry, width_rungs


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


def payload_batch(payloads, n_samples, params: Parameters):
    """The host arrays one decode batch walks: (buf uint8 [Fp, w*4] of
    zero-padded payloads, ns int32 [Fp], plens int32 [Fp], n_blocks), with
    the lane count Fp padded to a power of two (pad lanes hold n = 0 and
    no bytes)."""
    arrs = [np.frombuffer(p, dtype=np.uint8) for p in payloads]
    n_blocks, w = decode_geometry(params, n_samples, [len(a) for a in arrs])
    fp = 1 << max(0, (len(arrs) - 1).bit_length())
    buf = np.zeros((fp, w * 4), dtype=np.uint8)
    ns = np.zeros(fp, dtype=np.int32)
    plens = np.zeros(fp, dtype=np.int32)
    for i, (arr, n) in enumerate(zip(arrs, n_samples)):
        buf[i, : len(arr)] = arr
        ns[i] = n
        plens[i] = len(arr)
    return buf, ns, plens, n_blocks


def decode_frames_batch(payloads, n_samples, params: Parameters | None = None,
                        check_crcs=None, device="cuda"):
    """Decode a list of frame payloads (bytes) with their sample counts.

    Returns (list of int16 arrays, err int32 array), or with check_crcs (the
    expected payload CRC16s) also a bool array crc_ok, computed on the
    device over the same buffer.  err holds the per-frame codes of
    ops.decode_kernel (0 ok, 1 invalid BFP, 2 OOB inverse, 3 overrun)."""
    from ..ops.decode_kernel import decode_frames, decode_frames_checked

    dev = resolve_device(device)
    params = params or Parameters()
    f = len(payloads)
    if f == 0:
        empty = ([], np.zeros(0, np.int32))
        return empty if check_crcs is None else empty + (np.zeros(0, bool),)
    buf, ns, plens, n_blocks = payload_batch(payloads, n_samples, params)
    buf_t = torch.from_numpy(buf).to(dev)
    ns_t = torch.from_numpy(ns).to(dev)
    plens_t = torch.from_numpy(plens).to(dev)
    if check_crcs is not None:
        out, err, crc = decode_frames_checked(buf_t, ns_t, plens_t, params, n_blocks)
        crc_ok = crc[:f].cpu().numpy() == np.asarray(check_crcs, dtype=np.int64)
    else:
        out, err = decode_frames(buf_t, ns_t, plens_t, params, n_blocks)
    out = out[:f].cpu().numpy()
    err = err[:f].cpu().numpy()
    outs = [out[i, : ns[i]].copy() for i in range(f)]
    return (outs, err) if check_crcs is None else (outs, err, crc_ok)


def decode_frame(payload: bytes, params: Parameters, samples: int, device="cuda") -> np.ndarray:
    """Decode one frame payload; a decode error raises the matching
    reference error class (x3_tpu.errors.decode_error)."""
    outs, err = decode_frames_batch([payload], [samples], params, device=device)
    if err[0]:
        raise decode_error(err[0])
    return outs[0]

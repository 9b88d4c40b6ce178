"""Frame-parallel decode (port of x3_tpu.ops.decode_kernel).

Frames are self-contained, so the frame axis is the parallel axis; within
a frame every code's start depends on all earlier code lengths, so the
walk is serial.  CUDA tensors run the decode kernel K3 (ops/decode_cuda.py:
one thread per frame, a register bit reader over words staged in shared
memory for blocks that start inside the buffer, the windowed read below for
blocks past it); CPU tensors run the plain version below, which steps all
lanes through their bitstreams together, one sample at a time.

Both reproduce the JAX walk exactly, including on corrupt lanes:

* each block reads a window of WIN words starting at word
  min(off >> 5, W - 1): a lane whose walk runs past the buffer keeps its
  window at the last word;
* a code's two words come from window slots (rel >> 5) & mask and the
  slot after it, where mask keeps only the index bits that the JAX
  kernel's log-depth barrel looks at for that sample; slots at or past WIN
  read zero;
* unary zero counts stop at the payload end, Rice suffixes are 2 or 4
  bits (decoder.rs:180), inverse indices are clipped to 0..59, a code
  consumes at most 16 bits, the first error of a frame wins, and the
  overrun check compares against the worst-case width of the geometry;
* every output slot past a frame's sample count still holds the value the
  walk computes there (the JAX kernels write it too).

Blocks of more than 24 samples are walked with the JAX scan's rolling
two-word register (same values on valid streams, its own on corrupt ones).
"""

from __future__ import annotations

import torch

from .. import constants
from ..params import Parameters
from ..tables import device_tables
from ._bits import MASK32, as_i32, clz32, stage_mask, u32, wrap16
from .encode_kernel import block_buffer_words, frame_geometry, frame_geometry_blocks

# Per-frame decode error codes (errors.decode_error maps them): 0 ok,
# 1 invalid BFP (num_bits <= 5), 2 out-of-bounds inverse, 3 overran the
# payload.
ERR_OK = 0
ERR_INVALID_BPF = 1
ERR_OOB_INVERSE = 2
ERR_OVERRUN = 3

UNROLLED_MAX_L = 24  # the JAX walk unrolls blocks up to this length


def decode_geometry_of(params: Parameters, n_blocks: int | None):
    """(S, B, L, WFULL, WIN) of a decode walk."""
    if n_blocks is None:
        S, B, L, WFULL = frame_geometry(params)
    else:
        S, B, L, WFULL = frame_geometry_blocks(params, n_blocks)
    return S, B, L, WFULL, block_buffer_words(params)


def payload_words(payload: torch.Tensor) -> torch.Tensor:
    """uint8 [F, W*4] payload bytes -> int32 [F, W] big-endian word bit
    patterns."""
    F = payload.shape[0]
    by = payload.reshape(F, -1, 4).to(torch.int64)
    w = (by[:, :, 0] << 24) | (by[:, :, 1] << 16) | (by[:, :, 2] << 8) | by[:, :, 3]
    return as_i32(w)


def packed_payload_words(data: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor,
                         w_words: int) -> torch.Tensor:
    """int32 [F, w_words] big-endian word bit patterns of F payloads packed
    back to back in uint8 `data` (payload f is data[offsets[f] : offsets[f]
    + lengths[f]]), zero past each length: payload_words of the zero-padded
    [F, 4 * w_words] rows, built without them.  The big-endian word that
    starts at every byte of `data` is formed once (int32 shifts of 4-byte
    windows), then one gather takes each row's words and a mask cuts the
    bytes past its length.  offsets, lengths: int [F], lengths in
    0..4 * w_words."""
    dev = data.device
    d = torch.nn.functional.pad(data.to(torch.int32), (0, 4))  # the last windows read zeros
    win = d.unfold(0, 4, 1)  # [len + 1, 4]: the 4 bytes from each position
    be = (win[:, 0] << 24) | (win[:, 1] << 16) | (win[:, 2] << 8) | win[:, 3]
    j4 = 4 * torch.arange(w_words, device=dev, dtype=torch.int32)
    idx = (offsets.to(torch.int64)[:, None] + j4).clamp(max=be.shape[0] - 1)
    keep = (lengths.to(torch.int32)[:, None] - j4).clamp(0, 4)  # payload bytes in each word
    mask = torch.where(keep > 0, -1 << (32 - 8 * keep), 0)
    return be[idx] & mask


def decode_words(words: torch.Tensor, n_samples: torch.Tensor, payload_lens: torch.Tensor,
                 params: Parameters, n_blocks: int | None = None):
    """Walk int32 [F, W] payload words: (samples int16 [F, S], err int32
    [F], final bit offset int32 [F]).  K3 for CUDA tensors, the plain
    version for CPU tensors."""
    if words.is_cuda:
        from .decode_cuda import decode_words_cuda

        return decode_words_cuda(words, n_samples, payload_lens, params, n_blocks)
    return decode_words_plain(words, n_samples, payload_lens, params, n_blocks)


def decode_frames(payload: torch.Tensor, n_samples: torch.Tensor, payload_lens: torch.Tensor,
                  params: Parameters, n_blocks: int | None = None):
    """Decode a batch of zero-padded payloads (x3_tpu.ops.decode_kernel.
    decode_frames).

    payload: uint8 [F, W*4]; W is inferred and may be any compact rung that
      holds every payload.  n_samples, payload_lens: int32 [F].
    n_blocks: block-walk count override (None = params.blocks_per_frame);
      the output then has 1 + n_blocks*block_len columns.
    Returns (samples int16 [F, S], err int32 [F])."""
    out, err, _ = decode_words(payload_words(payload), n_samples, payload_lens, params, n_blocks)
    return out, err


def decode_frames_checked(payload: torch.Tensor, n_samples: torch.Tensor,
                          payload_lens: torch.Tensor, params: Parameters,
                          n_blocks: int | None = None):
    """decode_frames plus the payload CRC16 of each frame over the words the
    decoder built: (samples, err, crc int32 [F])."""
    return decode_words_checked(payload_words(payload), n_samples, payload_lens, params, n_blocks)


def decode_words_checked(words: torch.Tensor, n_samples: torch.Tensor, payload_lens: torch.Tensor,
                         params: Parameters, n_blocks: int | None = None):
    """Walk int32 [F, W] payload words and CRC them: (samples int16 [F, S],
    err int32 [F], crc int32 [F]) (K3 + K1 for CUDA tensors)."""
    from .crc_torch import crc16_words

    out, err, _ = decode_words(words, n_samples, payload_lens, params, n_blocks)
    return out, err, crc16_words(words, payload_lens, words.shape[1])


def decode_words_plain(words: torch.Tensor, n_samples: torch.Tensor, payload_lens: torch.Tensor,
                       params: Parameters, n_blocks: int | None = None):
    """Plain PyTorch version of the decode kernel K3, on any device: all
    lanes step through their bitstreams together (see the module doc for
    the exact semantics).  Returns (samples int16 [F, S], err int32 [F],
    final bit offset int32 [F])."""
    S, B, L, WFULL, WIN = decode_geometry_of(params, n_blocks)
    F, W = words.shape
    dev = words.device
    tabs = device_tables(params, dev)
    nsubs, invlen = tabs.dec_nsubs, tabs.dec_invlen
    i64 = dict(dtype=torch.int64, device=dev)

    w = u32(words)
    # Window slots past the buffer read zero: pad WIN zero words and point
    # out-of-window slots at the first of them.
    wp = torch.cat([w, torch.zeros((F, WIN), **i64)], dim=1)
    n = n_samples.to(torch.int64)
    plen8 = payload_lens.to(torch.int64) * 8
    first = wrap16((w[:, 0] >> 16) & 0xFFFF)

    off = torch.full((F,), 16, **i64)
    last = first
    err = torch.zeros(F, **i64)
    cols = []
    for b in range(B):
        block_first = 1 + b * L
        valid_block = block_first < n
        wb = (off >> 5).clamp(max=W - 1)
        rel = off - (wb << 5)

        def fetch(j, wb=wb):
            idx = torch.where(j < WIN, wb + j, torch.full_like(j, W))
            return wp.gather(1, idx[:, None])[:, 0]

        def extract32(rel, mask, fetch=fetch):
            j = (rel >> 5) & mask
            r = rel & 31
            w0, w1 = fetch(j), fetch(j + 1)
            return ((w0 << r) | ((w1 >> (31 - r)) >> 1)) & MASK32

        hdr = extract32(rel, stage_mask(min(WIN - 1, 1)))
        ftype = hdr >> 30
        dec_nb = ((hdr >> 26) & 0xF) + 1
        is_hdr0 = ftype == 0
        is_pass = is_hdr0 & (dec_nb == 16)
        bpf_err = valid_block & is_hdr0 & (dec_nb <= 5)
        is_rice = ftype >= 1
        # The header advances the walk even on blocks past the sample count.
        rel = rel + torch.where(is_hdr0, constants.BFP_HDR_LEN, constants.RICE_HDR_LEN)

        nsubs_f = torch.where(ftype == 2, nsubs[2], nsubs[3])
        invlen_f = torch.where(ftype == 1, invlen[1], torch.where(ftype == 2, invlen[2], invlen[3]))
        level = 1 << nsubs_f
        nbsuf = torch.where(ftype == 2, 2, 4)  # decoder.rs:180: hardwired
        dec_nb_u = dec_nb.clamp(1, 31)
        neg_thresh = 1 << (dec_nb - 1).clamp(0, 30)
        rel_end = plen8 - (wb << 5)  # payload end in window bits
        oob = torch.zeros(F, dtype=torch.bool, device=dev)

        def decode_math(win32, last, cap, valid, oob):
            zeros = torch.minimum(clz32(win32), cap.clamp(min=0))
            zc = zeros.clamp(0, 31)
            suffix = ((win32 << zc) & MASK32) >> (32 - nbsuf)
            idx = torch.where(ftype == 1, zeros, suffix + level * (zeros - 1))
            oob = oob | (valid & is_rice & ((idx < 0) | (idx >= invlen_f)))
            ic = idx.clamp(0, 59)
            half = (ic + 1) >> 1
            delta_rice = torch.where((ic & 1) == 1, -half, half)
            a = win32 >> (32 - dec_nb_u)
            delta_bfp = a - torch.where(a > neg_thresh, neg_thresh * 2, 0)
            v_pass = wrap16(win32 >> 16)
            delta = torch.where(is_rice, delta_rice, delta_bfp)
            new = torch.where(is_pass, v_pass, wrap16(last + delta))
            consume = torch.where(ftype == 1, zeros + 1, torch.where(is_rice, zeros + nbsuf, dec_nb))
            return new, consume.clamp(max=16), oob

        if L <= UNROLLED_MAX_L:
            for k in range(L):
                valid = valid_block & ((block_first + k) < n)
                win32 = extract32(rel, stage_mask(min(WIN - 1, (37 + 16 * k) >> 5)))
                new, consume, oob = decode_math(win32, last, rel_end - rel, valid, oob)
                rel = rel + torch.where(valid, consume, 0)
                last = torch.where(valid, new, last)
                cols.append(new)
        else:
            m1, m2 = stage_mask(WIN - 1), stage_mask(WIN)
            widx = rel >> 5
            r = rel & 31
            w0, w1 = fetch(widx & m1), fetch((widx + 1) & m1)
            for k in range(L):
                valid = valid_block & ((block_first + k) < n)
                win32 = ((w0 << r) | ((w1 >> (31 - r)) >> 1)) & MASK32
                new, consume, oob = decode_math(win32, last, rel_end - ((widx << 5) + r), valid, oob)
                r = r + torch.where(valid, consume, 0)
                carry = r >= 32
                r = r - torch.where(carry, 32, 0)
                w0 = torch.where(carry, w1, w0)
                w1 = torch.where(carry, fetch(torch.clamp(widx + 2, max=WIN) & m2), w1)
                widx = widx + carry.to(torch.int64)
                last = torch.where(valid, new, last)
                cols.append(new)
            rel = (widx << 5) + r

        off = (wb << 5) + rel
        blk = torch.where(bpf_err, ERR_INVALID_BPF, torch.where(oob, ERR_OOB_INVERSE, ERR_OK))
        err = torch.where(err != ERR_OK, err, blk)

    err = torch.where(err != ERR_OK, err, torch.where(off > WFULL * 32, ERR_OVERRUN, ERR_OK))
    out = torch.stack([first] + cols, dim=1)[:, :S]
    return out.to(torch.int16), err.to(torch.int32), off.to(torch.int32)

"""Batched encode over [F, S] frames (port of x3_tpu.ops.encode_kernel).

The geometry helpers and the width-rung contracts are re-implemented here
with the same values (the JAX module imports jax at its top).

`encode_frames` has the contract of the JAX function with
pack_mode="block": the same output dict, including the compact-rung
overflow contract (frames that overflow `w_words`/`nw_words` get truncated
words; `nbytes`, `total_bits`, `stats` and `blockfit_bits` stay exact for
every frame).  CUDA tensors run the encode kernel K2 (ops/encode_cuda.py)
and then the CRC kernel K1; CPU tensors run the plain version below:

1. first-order diff over the frame;
2. per-block masked max-|diff| classifies Rice / BFP / literal;
3. closed-form per-sample (value, bits) of the Rice codes;
4. an item stream per block ([first sample][header][samples]) whose
   exclusive prefix sums are every item's bit offset;
5. a segment-sum pack (index_add_ on int64: the items' bits are disjoint,
   so + equals |); pieces past the W-word buffer are dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from x3_tpu import constants
from x3_tpu.params import Parameters

from ..tables import device_tables
from ._bits import MASK32, as_i32, bit_length


def _rice_nsubs_np(params: Parameters):
    """nsubs of the three selected Rice codes (statistics slot mapping)."""
    return np.asarray([rc.nsubs for rc in params.rice_codes], dtype=np.int32)


def rice_code_closed_form(d: torch.Tensor, order: int):
    """Closed-form Rice (code value, total bits) for diffs `d` under rice
    order `order` (x3_tpu.ops.encode_kernel.rice_code_closed_form).

    order 0:   code = 1,  bits = 2|d| + [d >= 0]
    order k>0: e = d if d >= 0 else -d-1
               bits = (k+1) + (e >> (k-1))
               code = 2^k | ((d & (2^(k-1)-1)) << 1)          if d >= 0
                      (2^(k+1)-1) - ((d & (2^(k-1)-1)) << 1)  if d <  0
    """
    if order == 0:
        bits = 2 * d.abs() + (d >= 0).to(d.dtype)
        return torch.ones_like(d), bits
    k = order
    e = torch.where(d >= 0, d, -d - 1)
    bits = (k + 1) + (e >> (k - 1))
    low = (d & ((1 << (k - 1)) - 1)) << 1
    code = torch.where(d >= 0, (1 << k) | low, ((1 << (k + 1)) - 1) - low)
    return code, bits


def frame_geometry(params: Parameters):
    """Static sizes (S, B, L, W) of the [F, S] pipeline."""
    B = params.blocks_per_frame
    return params.samples_per_frame, B, params.block_len, _worst_case_words(params, B)


def frame_geometry_blocks(params: Parameters, n_blocks: int):
    """Decode sizes for a walk of `n_blocks` blocks per frame: the output
    width is 1 + n_blocks*block_len (raw first sample + full blocks)."""
    B = n_blocks
    L = params.block_len
    return 1 + B * L, B, L, _worst_case_words(params, B)


def _worst_case_words(params: Parameters, B: int) -> int:
    # 16 bits of first sample + per block a 6-bit header and 16 bits per
    # sample, one slack word, rounded up to a multiple of 8 words.
    max_bits = 16 + B * (constants.BFP_HDR_LEN + 16 * params.block_len)
    n_words = -(-max_bits // 32) + 1
    if n_words % 8:
        n_words += 8 - n_words % 8
    return n_words


def block_buffer_words(params: Parameters) -> int:
    """Words per block buffer: worst-case block bits (first sample + header +
    16 bits/sample) plus up to 31 bits of start-offset skew."""
    max_block_bits = 16 + constants.BFP_HDR_LEN + 16 * params.block_len
    return -(-(max_block_bits + 31) // 32)


def width_rungs(params: Parameters) -> list[int]:
    """Ascending payload-width rungs for adaptive encode: 512, 1024, 2048,
    4096 below the worst-case width, then the worst case.  The ladder is the
    JAX package's contract; which rung is fastest on the card is not yet
    measured."""
    _, _, _, W = frame_geometry(params)
    return [r for r in (512, 1024, 2048, 4096) if W > r] + [W]


def fits_width(nbytes, w_words: int, params: Parameters | None = None) -> bool:
    """True when every frame's payload fits a w_words-word buffer (with the
    end-of-stream spill slack of two words)."""
    if params is not None:
        _, _, _, W = frame_geometry(params)
        if w_words >= W:
            return True
    return int(np.max(np.asarray(nbytes), initial=0)) <= (w_words - 2) * 4


def block_width_rungs(params: Parameters) -> list[int]:
    """Ascending block-buffer width (NW) rungs for adaptive encode."""
    full = block_buffer_words(params)
    ladder = {full}
    if full > 6:
        ladder |= {6, max(6, full // 2)}
    if full > 10:
        ladder.add(10)
    if full > 4:
        ladder.add(4)
    return sorted(ladder)


def fits_block_width(blockfit_bits, nw_words: int, params: Parameters | None = None) -> bool:
    """True when every block's packed bits fit an nw_words block buffer
    (NB4 = nw_words + 7 word slots behind an 8-word-aligned base)."""
    if params is not None and nw_words >= block_buffer_words(params):
        return True
    return int(np.max(np.asarray(blockfit_bits), initial=0)) <= (nw_words + 8 - 1) * 32


def _nbytes(total_bits: torch.Tensor) -> torch.Tensor:
    nb = (total_bits + 7) // 8
    return nb + (nb & 1)  # word-align to 2 bytes (bitpacker.rs:124-132)


def _items(samples: torch.Tensor, n_valid: torch.Tensor, params: Parameters):
    """Per-block item streams [F, B, 2+L] (value, bits) as int64 plus the
    per-frame statistics [F, 6]."""
    S, B, L, _ = frame_geometry(params)
    F = samples.shape[0]
    dev = samples.device
    tabs = device_tables(params, dev)
    t0, t1, t2 = params.thresholds
    orders = torch.tensor(params.codes, dtype=torch.int64, device=dev)
    slots = torch.tensor(tabs.rice_nsubs, dtype=torch.int64, device=dev)

    s = samples.to(torch.int64)
    n = n_valid.to(torch.int64)[:, None]
    snext = torch.cat([s[:, 1:], torch.zeros((F, 1), dtype=torch.int64, device=dev)], dim=1)
    d = snext - s
    valid = (torch.arange(S, device=dev)[None, :] + 1) < n  # diff i belongs to sample i+1
    db = d.reshape(F, B, L)
    vb = valid.reshape(F, B, L)
    sb = snext.reshape(F, B, L)

    # ---- block classification (x3_encode_block, encoder.rs:289-315) ----
    ma = torch.where(vb, db.abs(), 0).amax(dim=2)  # [F, B]
    block_first = 1 + torch.arange(B, device=dev)[None, :] * L
    present = block_first < n
    ftype_r = (ma > t0).to(torch.int64) + (ma > t1) + (ma > t2)
    is_rice = ma <= t2
    nb = bit_length(ma.clamp(min=1))
    is_literal = (~is_rice) & (nb >= 15)
    hdr_val = torch.where(is_rice, ftype_r + 1, torch.where(is_literal, 15, nb))
    hdr_len = torch.where(is_rice, constants.RICE_HDR_LEN, constants.BFP_HDR_LEN)
    hdr_len = torch.where(present, hdr_len, 0)
    hdr_val = torch.where(present, hdr_val, 0)

    # ---- per-sample (value, bits): the closed form with the block's order
    # k as data ----
    rsel = ftype_r.clamp(0, 2)
    k = orders[rsel][:, :, None]  # [F, B, 1]
    kk = k.clamp(min=1)
    e = torch.where(db >= 0, db, -db - 1)
    bits_k = (k + 1) + (e >> (kk - 1))
    low = (db & ((1 << (kk - 1)) - 1)) << 1
    code_k = torch.where(db >= 0, (1 << kk) | low, ((1 << (kk + 1)) - 1) - low)
    bits0 = 2 * db.abs() + (db >= 0).to(torch.int64)
    rice_val = torch.where(k == 0, 1, code_k)
    rice_bits = torch.where(k == 0, bits0, bits_k)
    bfp_bits = (nb + 1)[:, :, None]
    bfp_val = db & ((1 << bfp_bits.clamp(max=31)) - 1)
    lit_val = sb & 0xFFFF
    rice3, lit3 = is_rice[:, :, None], is_literal[:, :, None]
    val = torch.where(rice3, rice_val, torch.where(lit3, lit_val, bfp_val))
    ln = torch.where(rice3, rice_bits, torch.where(lit3, 16, bfp_bits))
    ln = torch.where(vb, ln, 0)
    val = torch.where(vb, val, 0)

    # ---- statistics (encoder.rs:63,266) ----
    slot = torch.where(is_rice, slots[rsel], torch.where(is_literal, 5, 4))
    cnt = vb.sum(dim=2)
    onehot = (slot[:, :, None] == torch.arange(6, device=dev)) & present[:, :, None]
    stats = (onehot * cnt[:, :, None]).sum(dim=1)

    # ---- item stream [F, B, 2+L]: [raw first sample (block 0)][header][samples]
    has_first = (n[:, 0] > 0).to(torch.int64)
    first_val = torch.zeros((F, B, 1), dtype=torch.int64, device=dev)
    first_len = torch.zeros((F, B, 1), dtype=torch.int64, device=dev)
    first_val[:, 0, 0] = (s[:, 0] & 0xFFFF) * has_first
    first_len[:, 0, 0] = 16 * has_first
    item_val = torch.cat([first_val, hdr_val[:, :, None], val], dim=2)
    item_len = torch.cat([first_len, hdr_len[:, :, None], ln], dim=2)
    return item_val & MASK32, item_len, stats


def _pack(item_val: torch.Tensor, item_len: torch.Tensor, W: int):
    """Segment-sum pack of [F, B, I] items into W words (int64 0..2**32-1).

    Returns (words [F, W], total_bits [F], blockfit [F]).  Pieces that land
    at word W or later are dropped; an item longer than 32 bits writes its
    value into its last 32 bits (its leading bits are zeros)."""
    F, B, I = item_val.shape
    dev = item_val.device
    block_bits = item_len.sum(dim=2)
    block_end = block_bits.cumsum(dim=1)
    block_off = block_end - block_bits
    total_bits = block_end[:, -1] if B else torch.zeros(F, dtype=torch.int64, device=dev)
    blockfit = ((block_off & (32 * 8 - 1)) + block_bits).amax(dim=1)

    val = item_val.reshape(F, B * I)
    ln = item_len.reshape(F, B * I)
    ends = ln.cumsum(dim=1)
    off = ends - ln + (ln - 32).clamp(min=0)
    ln = ln.clamp(max=32)
    word = off >> 5
    sh = 32 - (off & 31) - ln  # >= 0: fits in `word`; < 0: straddles into word+1
    hi = torch.where(sh >= 0, val << sh.clamp(min=0), val >> (-sh).clamp(min=0)) & MASK32
    lo = torch.where(sh < 0, (val << (32 + sh).clamp(0, 31)) & MASK32, 0)
    live = ln > 0  # zero-length items write nothing
    hi = torch.where(live, hi, 0)
    lo = torch.where(live, lo, 0)

    stride = W + 1  # column W collects dropped pieces
    base = torch.arange(F, device=dev)[:, None] * stride
    hi_idx = base + word.clamp(max=W)
    lo_idx = base + (word + 1).clamp(max=W)
    flat = torch.zeros(F * stride, dtype=torch.int64, device=dev)
    flat.index_add_(0, hi_idx.reshape(-1), hi.reshape(-1))
    flat.index_add_(0, lo_idx.reshape(-1), lo.reshape(-1))
    words = flat.reshape(F, stride)[:, :W]
    return words, total_bits, blockfit


def encode_words_plain(samples: torch.Tensor, n_valid: torch.Tensor, params: Parameters, W: int):
    """Plain PyTorch version of the encode kernel K2, on any device.

    samples: int16/int32 [F, S]; n_valid: int32 [F] (0 = dummy frame).
    Returns (words int32 [F, W] big-endian word bit patterns, total_bits,
    blockfit_bits, nbytes int32 [F], stats int32 [F, 6]).  Words past a
    frame's W-word buffer are dropped; every other output is exact."""
    item_val, item_len, stats = _items(samples, n_valid, params)
    words, total_bits, blockfit = _pack(item_val, item_len, W)
    i32 = torch.int32
    return as_i32(words), total_bits.to(i32), blockfit.to(i32), _nbytes(total_bits).to(i32), stats.to(i32)


def encode_frames(samples: torch.Tensor, n_valid: torch.Tensor, params: Parameters,
                  w_words: int | None = None, nw_words: int | None = None) -> dict:
    """Encode a batch of frames (x3_tpu.ops.encode_kernel.encode_frames with
    pack_mode="block").

    samples: int16 [F, S] (CUDA) or int16/int32 [F, S] (CPU), zero-padded
      past n_valid; n_valid: int32 [F] valid samples per frame (0 = dummy).
    w_words: payload width rung (None = worst case).  Frames whose payload
      exceeds it get truncated words but exact nbytes/total_bits/stats;
      callers check fits_width and re-dispatch at a wider rung.
    nw_words: block-buffer rung.  Neither path keeps per-block buffers, so
      it truncates nothing; blockfit_bits is exact and callers check
      fits_block_width exactly as with the JAX package.
    Returns dict of payload_words int32 [F, W] (big-endian u32 bit
    patterns), nbytes, crc, total_bits, blockfit_bits (int32 [F]) and
    stats int32 [F, 6]."""
    from .crc_torch import crc16_words

    _, _, _, W = frame_geometry(params)
    if w_words is not None:
        W = min(W, w_words)
    del nw_words  # see docstring: the rung only gates blockfit_bits upstream
    if samples.is_cuda:
        from .encode_cuda import encode_words_cuda

        words, total_bits, blockfit, nbytes, stats = encode_words_cuda(samples, n_valid, params, W)
    else:
        words, total_bits, blockfit, nbytes, stats = encode_words_plain(samples, n_valid, params, W)
    crc = crc16_words(words, nbytes, W)
    return {
        "payload_words": words,
        "nbytes": nbytes,
        "crc": crc,
        "stats": stats,
        "total_bits": total_bits,
        "blockfit_bits": blockfit,
    }

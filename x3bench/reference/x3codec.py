"""The plain X3 reference: the archive an X3 encoder makes of a mono int16
stream, worked out in NumPy, vectorised over frames and blocks.

It follows the X3 format as x3-rust writes it (encoder.rs: frames of
block_len x blocks_per_frame samples, the first sample of a frame raw in
16 bits, then every block of first differences as a Rice block (2-bit
header, one code a sample from the selected table), a BFP block (6-bit
header with the width, then each difference in width + 1 bits) or a
literal block (header 15, then the samples themselves in 16 bits), the
payload padded to an even number of bytes; 20-byte big-endian frame
headers with CRC-16/CCITT of the header and of the payload; the archive
header of 'X3ARCHIV', a pseudo frame header and the XML).

It imports nothing of the program under test: the tables and the XML are
its own copies of the format, and the CPU tests hold its bytes to the
reference's golden frame.  A decoder is not needed here: for a lossless
codec the right decode of this archive is the stream it was made from.
"""

from __future__ import annotations

import numpy as np

FRAME_HEADER_LENGTH = 20
FRAME_KEY = b"x3"
ARCHIVE_ID = b"X3ARCHIV"
RICE_HDR_LEN = 2
BFP_HDR_LEN = 6

# The four Rice code tables (x3.rs): index = difference + offset gives the
# code and its width in bits.
_RICE = (
    dict(offset=6, code=[1] * 14, bits=[12, 10, 8, 6, 4, 2, 1, 3, 5, 7, 9, 11, 13, 15]),
    dict(offset=11, code=[3] * 11 + [2] * 11,
         bits=[12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]),
    dict(offset=20, code=[7, 5] * 10 + [4, 6] * 10,
         bits=[12, 12, 11, 11, 10, 10, 9, 9, 8, 8, 7, 7, 6, 6, 5, 5, 4, 4, 3, 3]
         + [3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12]),
    dict(offset=28, code=[15, 13, 11, 9] * 7 + [8, 10, 12, 14] * 7,
         bits=[10, 10, 10, 10, 9, 9, 9, 9, 8, 8, 8, 8, 7, 7, 7, 7, 6, 6, 6, 6, 5, 5, 5, 5, 4, 4, 4, 4]
         + [4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10]),
)
_LUT_OFF = 64  # differences index the lookup tables at d + 64


def _crc_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.int64)
    for i in range(256):
        crc = i << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else crc << 1
            crc &= 0xFFFF
        table[i] = crc
    return table


CRC_TABLE = _crc_table()


def _pair_table() -> np.ndarray:
    # Two bytes hi, lo into register r give PAIR[r ^ (hi << 8 | lo)].
    v = np.arange(1 << 16)
    t = CRC_TABLE[v >> 8]
    return ((t & 0xFF) << 8) ^ CRC_TABLE[(v & 0xFF) ^ (t >> 8)]


PAIR_TABLE = _pair_table()


def crc16(data: bytes) -> int:
    """CRC-16/CCITT (poly 0x1021, init 0xffff, MSB first) of a byte string."""
    crc = 0xFFFF
    for b in data:
        crc = ((crc << 8) ^ int(CRC_TABLE[(b ^ (crc >> 8)) & 0xFF])) & 0xFFFF
    return crc


def crc16_even_rows(buf: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """CRC-16 of the rows buf[starts[i] : starts[i] + lengths[i]] of a flat
    uint8 buffer, every length even: two bytes a table gather, the rows
    that are still running taken together.  Returns int64 [N]."""
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    crc = np.full(len(starts), 0xFFFF, np.int64)
    order = np.argsort(-lengths, kind="stable")  # longest first: the running rows are a prefix
    s, n = starts[order], lengths[order] // 2
    c = crc[order]
    b = buf.astype(np.int64)
    live = len(order)
    for j in range(int(n.max()) if len(n) else 0):
        while live and n[live - 1] <= j:
            live -= 1
        pos = s[:live] + 2 * j
        c[:live] = PAIR_TABLE[c[:live] ^ ((b[pos] << 8) | b[pos + 1])]
    crc[order] = c
    return crc


def _bit_length(v: np.ndarray) -> np.ndarray:
    out = np.zeros(v.shape, np.int64)
    x = v.astype(np.int64)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        out += np.where(big, shift, 0)
        x = np.where(big, x >> shift, x)
    return out + (x > 0)


def _frame_header_rows(n_samples, payload_lens, payload_crcs, source_id: int, channels: int) -> np.ndarray:
    h = np.zeros((len(n_samples), FRAME_HEADER_LENGTH), np.uint8)
    h[:, 0], h[:, 1] = FRAME_KEY[0], FRAME_KEY[1]
    h[:, 2], h[:, 3] = source_id, channels
    ns, pl = np.asarray(n_samples, np.int64) & 0xFFFF, np.asarray(payload_lens, np.int64) & 0xFFFF
    h[:, 4], h[:, 5] = ns >> 8, ns & 0xFF
    h[:, 6], h[:, 7] = pl >> 8, pl & 0xFF
    flat = h.reshape(-1)
    hcrc = crc16_even_rows(flat, np.arange(len(h)) * FRAME_HEADER_LENGTH, np.full(len(h), 16))
    h[:, 16], h[:, 17] = hcrc >> 8, hcrc & 0xFF
    pc = np.asarray(payload_crcs, np.int64)
    h[:, 18], h[:, 19] = pc >> 8, pc & 0xFF
    return h


def build_xml(sample_rate: int, block_len: int, codes, thresholds) -> bytes:
    return (
        '<X3ARCH PROG="x3new.m" VERSION="2.0" />'
        '<CFG ID="0" FTYPE="XML" />'
        '<CFG ID="1" FTYPE="WAV">'
        f'<FS UNIT="Hz">{sample_rate}</FS>'
        "<SUFFIX>wav</SUFFIX>"
        '<CODEC TYPE="X3" VERS="2">'
        f"<BLKLEN>{block_len}</BLKLEN>"
        f'<CODES N="4">RICE{codes[0]},RICE{codes[1]},RICE{codes[2]},BFP</CODES>'
        "<FILTER>DIFF</FILTER>"
        "<NBITS>16</NBITS>"
        f'<T N="3">{thresholds[0]},{thresholds[1]},{thresholds[2]}</T>'
        "</CODEC>"
        "</CFG>"
    ).encode("ascii")


def archive_header(sample_rate: int, params: dict) -> bytes:
    """'X3ARCHIV', a pseudo frame header (0 samples, source id 0) and the
    XML padded to an even length."""
    xml = build_xml(sample_rate, params["block_len"], params["codes"], params["thresholds"])
    payload = xml + (b"\x00" if len(xml) % 2 else b"")
    head = _frame_header_rows([0], [len(payload)], [crc16(payload)], 0, 0)
    return ARCHIVE_ID + head.tobytes() + payload


def _tables(codes):
    code_lut = np.zeros((3, 2 * _LUT_OFF), np.int64)
    bits_lut = np.zeros((3, 2 * _LUT_OFF), np.int64)
    for t, c in enumerate(codes):
        r = _RICE[c]
        lo = _LUT_OFF - r["offset"]
        code_lut[t, lo : lo + len(r["code"])] = r["code"]
        bits_lut[t, lo : lo + len(r["bits"])] = r["bits"]
    return code_lut, bits_lut


class Frames:
    """The frames of one stream: `data` (frame headers and payloads, no
    archive header) and each frame's sample count and payload length."""

    def __init__(self, data: bytes, n_samples: np.ndarray, payload_lens: np.ndarray):
        self.data, self.n_samples, self.payload_lens = data, n_samples, payload_lens


CHUNK_FRAMES = 128  # frames encoded together: bounds the reference's memory


def encode_frames(samples, params: dict, source_id: int = 1) -> Frames:
    """The X3 frames of a mono int16 stream."""
    x = np.asarray(samples, np.int16)
    spf = params["block_len"] * params["blocks_per_frame"]
    step = CHUNK_FRAMES * spf
    parts = [_encode_chunk(x[a : a + step], params, source_id) for a in range(0, len(x), step)]
    if not parts:
        return Frames(b"", np.zeros(0, np.int64), np.zeros(0, np.int64))
    return Frames(b"".join(p.data for p in parts), np.concatenate([p.n_samples for p in parts]),
                  np.concatenate([p.payload_lens for p in parts]))


def _encode_chunk(samples: np.ndarray, params: dict, source_id: int) -> Frames:
    x = samples.astype(np.int64)
    L, B = params["block_len"], params["blocks_per_frame"]
    t0, t1, t2 = params["thresholds"]
    spf = L * B
    n = len(x)
    F = -(-n // spf)
    nf = np.minimum(spf, n - np.arange(F) * spf)  # samples a frame
    xf = np.zeros(F * spf, np.int64)
    xf[:n] = x
    xf = xf.reshape(F, spf)
    # Differences [F, B, L] (slot k of a frame is x[k + 1] - x[k]; one slot
    # of padding past the last), valid below nf - 1.
    d = np.zeros((F, B * L), np.int64)
    d[:, : spf - 1] = xf[:, 1:] - xf[:, :-1]
    nxt = np.zeros((F, B * L), np.int64)  # the sample each difference leads to
    nxt[:, : spf - 1] = xf[:, 1:]
    valid = np.arange(B * L)[None, :] < (nf - 1)[:, None]
    d = np.where(valid, d, 0).reshape(F, B, L)
    nxt = nxt.reshape(F, B, L)
    valid = valid.reshape(F, B, L)
    has = valid[:, :, 0]  # the block holds at least one difference

    max_abs = np.abs(d).max(axis=2)
    rice = max_abs <= t2
    ftype = (max_abs > t0).astype(np.int64) + (max_abs > t1)
    nb = _bit_length(max_abs)
    literal = ~rice & (nb >= 15)
    bfp = ~rice & ~literal

    code_lut, bits_lut = _tables(params["codes"])
    ft = np.broadcast_to(ftype[:, :, None], d.shape)
    idx = np.clip(d + _LUT_OFF, 0, 2 * _LUT_OFF - 1)
    val = np.where(rice[:, :, None], code_lut[ft, idx], 0)
    wid = np.where(rice[:, :, None], bits_lut[ft, idx], 0)
    w_bfp = (nb + 1)[:, :, None]
    val = np.where(bfp[:, :, None], d & ((1 << w_bfp) - 1), val)
    wid = np.where(bfp[:, :, None], w_bfp, wid)
    val = np.where(literal[:, :, None], nxt & 0xFFFF, val)
    wid = np.where(literal[:, :, None], 16, wid)
    wid = np.where(valid, wid, 0)

    hv = np.where(rice, ftype + 1, np.where(literal, 15, nb))
    hw = np.where(has, np.where(rice, RICE_HDR_LEN, BFP_HDR_LEN), 0)

    # Fields a frame: the first sample, then each block's header and codes.
    fv = np.concatenate([hv[:, :, None], val], axis=2).reshape(F, -1)
    fw = np.concatenate([hw[:, :, None], wid], axis=2).reshape(F, -1)
    fv = np.concatenate([(xf[:, :1] & 0xFFFF), fv], axis=1)
    fw = np.concatenate([np.full((F, 1), 16), fw], axis=1)
    del d, nxt, val, wid, ft, idx

    bits = fw.sum(axis=1)
    plen = (bits + 7) // 8
    plen += plen % 2
    frame_start = np.concatenate([[0], np.cumsum(FRAME_HEADER_LENGTH + plen)[:-1]])
    total = int(frame_start[-1] + FRAME_HEADER_LENGTH + plen[-1])
    pos = np.cumsum(fw, axis=1) - fw + 8 * (frame_start + FRAME_HEADER_LENGTH)[:, None]
    keep = fw.reshape(-1) > 0
    g, w, v = pos.reshape(-1)[keep], fw.reshape(-1)[keep], fv.reshape(-1)[keep].astype(np.uint64)
    del fv, fw, pos, keep

    # Each field lies in the 64-bit window of words g >> 5 and the next; its
    # bits are disjoint from every other field's, so sums are ORs.
    word = g >> 5
    sh = (64 - (g & 31) - w).astype(np.uint64)
    win = v << sh
    words = np.zeros(total // 4 + 2, np.uint64)
    starts = np.flatnonzero(np.r_[True, word[1:] != word[:-1]])
    keys = word[starts]
    words[keys] += np.add.reduceat(win >> np.uint64(32), starts)
    words[keys + 1] += np.add.reduceat(win & np.uint64(0xFFFFFFFF), starts)
    buf = words.astype(">u4").view(np.uint8)[:total].copy()

    pcrc = crc16_even_rows(buf, frame_start + FRAME_HEADER_LENGTH, plen)
    heads = _frame_header_rows(nf, plen, pcrc, source_id, source_id)
    rows = frame_start[:, None] + np.arange(FRAME_HEADER_LENGTH)[None, :]
    buf[rows] = heads
    return Frames(buf.tobytes(), nf.astype(np.int64), plen.astype(np.int64))


def encode_archive(samples, sample_rate: int, params: dict) -> tuple[bytes, int]:
    """The .x3a archive of a stream and the payload bytes of its frames."""
    fr = encode_frames(samples, params)
    return archive_header(sample_rate, params) + fr.data, int(fr.payload_lens.sum())

"""x3_tpu_torch's decode (plain version of kernel K3, plus the CRC) against
x3_tpu's XLA scan decode and its Pallas decode kernel in interpret mode,
on clean and corrupt payloads: every output slot of every lane must match,
error lanes included.  Exact (tolerance 0)."""

import dataclasses

import numpy as np
import pytest
import torch

import x3_tpu_torch as xt
from tests.conftest import make_hydrophone, make_mixed
from x3_tpu.models import oracle
from x3_tpu.params import Parameters

TINY = Parameters(block_len=4, blocks_per_frame=8)  # 32 samples/frame, WIN=4
LONG = Parameters(block_len=30, blocks_per_frame=3)  # blocks > 24: rolling walk


def port_params(p: Parameters) -> xt.Parameters:
    """The port's Parameters with the same fields as the JAX package's."""
    return xt.Parameters(**dataclasses.asdict(p))


def _payloads(blob: bytes):
    payloads, counts, crcs, off = [], [], [], 0
    while off < len(blob):
        h = blob[off : off + 20]
        plen = int.from_bytes(h[6:8], "big")
        counts.append(int.from_bytes(h[4:6], "big"))
        crcs.append(int.from_bytes(h[18:20], "big"))
        payloads.append(blob[off + 20 : off + 20 + plen])
        off += 20 + plen
    return payloads, counts, crcs


def _batch(rng, params, n_frames, W, mutate):
    """(buf uint8 [F, 4W], n int32 [F], lengths int32 [F], wav) from the
    oracle's frames.  mutate adds byte flips, truncated lengths (tails
    zeroed) and lanes of random bytes that claim a full frame."""
    spf = params.samples_per_frame
    wav = np.concatenate([make_mixed(rng, spf * (n_frames - 1)), make_hydrophone(rng, spf - 3)])
    payloads, counts, _ = _payloads(oracle.encode(wav, params))
    F = len(payloads)
    buf = np.zeros((F, 4 * W), np.uint8)
    plens = np.zeros(F, np.int32)
    for i, p in enumerate(payloads):
        plens[i] = min(len(p), 4 * W)
        buf[i, : plens[i]] = np.frombuffer(p, np.uint8)[: plens[i]]
    n = np.asarray(counts, np.int32)
    if mutate:
        for i in range(0, F, 3):
            pos = rng.integers(0, max(1, plens[i]), 3)
            buf[i, pos] ^= rng.integers(1, 256, 3).astype(np.uint8)
        for i in range(1, F, 4):
            plens[i] = rng.integers(0, plens[i] + 1)
            buf[i, plens[i] :] = 0
        junk = slice(2, F, 5)
        buf[junk] = rng.integers(0, 256, buf[junk].shape).astype(np.uint8)
        plens[junk] = 4 * W
        n[junk] = spf
    return buf, n, plens, wav


def _jax_scan(buf, n, plens, params, n_blocks=None):
    import jax.numpy as jnp

    from x3_tpu.ops.decode_kernel import decode_frames_checked

    out = decode_frames_checked(jnp.asarray(buf), jnp.asarray(n), jnp.asarray(plens), params, n_blocks)
    return [np.asarray(x) for x in out]


def _jax_pallas(buf, n, plens, params, n_blocks=None):
    import jax.numpy as jnp

    from x3_tpu.ops.decode_pallas import decode_frames_pallas

    out = decode_frames_pallas(
        jnp.asarray(buf), jnp.asarray(n), jnp.asarray(plens), params, n_blocks, interpret=True
    )
    return [np.asarray(x) for x in out]


def _port(buf, n, plens, params, n_blocks=None):
    from x3_tpu_torch.ops.decode_kernel import decode_frames_checked

    t = torch.from_numpy
    out = decode_frames_checked(t(buf), t(n), t(plens), port_params(params), n_blocks)
    return [x.numpy() for x in out]


def _assert_same(got, want, names=("samples", "err", "crc")):
    for g, w, name in zip(got, want, names):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("W", [64, 16, 8])
@pytest.mark.parametrize("mutate", [False, True], ids=["clean", "mutated"])
def test_decode_matches_jax_scan_and_pallas(W, mutate):
    rng = np.random.default_rng(W + 1000 * mutate)
    buf, n, plens, wav = _batch(rng, TINY, 9, W, mutate)
    got = _port(buf, n, plens, TINY)
    _assert_same(got, _jax_scan(buf, n, plens, TINY))
    if W != 16:  # interpret mode is slow: the Pallas kernel at two widths
        _assert_same(got[:2], _jax_pallas(buf, n, plens, TINY))
    if not mutate and W == 64:
        assert not got[1].any()
        spf = TINY.samples_per_frame
        np.testing.assert_array_equal(got[0].reshape(-1)[: len(wav)], wav[: got[0].size])
        np.testing.assert_array_equal(got[0][-1, : spf - 3], wav[-(spf - 3) :])


@pytest.mark.parametrize("mutate", [False, True], ids=["clean", "mutated"])
def test_decode_n_blocks_override(mutate):
    """Frames larger than the params geometry (n_blocks override), with the
    output width 1 + n_blocks*L."""
    rng = np.random.default_rng(5 + mutate)
    big = Parameters(block_len=4, blocks_per_frame=16)
    buf, n, plens, _ = _batch(rng, big, 5, 64, mutate)
    got = _port(buf, n, plens, TINY, 16)
    assert got[0].shape == (len(n), 1 + 16 * 4)
    _assert_same(got, _jax_scan(buf, n, plens, TINY, 16))
    _assert_same(got[:2], _jax_pallas(buf, n, plens, TINY, 16))


def test_decode_walk_past_buffer_matches():
    """Random lanes whose walk runs past the buffer's W words at a compact
    rung: the JAX walk keeps its window at the last word and masks its
    window index; the port reproduces those samples, not zeros."""
    from x3_tpu_torch.ops.decode_kernel import decode_words_plain, payload_words

    rng = np.random.default_rng(77)
    W, F = 4, 24
    spf = TINY.samples_per_frame
    buf = rng.integers(0, 256, (F, 4 * W)).astype(np.uint8)
    buf[:, 0] = 0x00  # a small first sample
    n = np.full(F, spf, np.int32)
    plens = np.full(F, 4 * W, np.int32)
    _, _, off = decode_words_plain(
        payload_words(torch.from_numpy(buf)), torch.from_numpy(n), torch.from_numpy(plens),
        port_params(TINY),
    )
    assert (off.numpy() > 32 * W).sum() >= F // 2, "most lanes must walk past the buffer"
    got = _port(buf, n, plens, TINY)
    _assert_same(got, _jax_scan(buf, n, plens, TINY))
    _assert_same(got[:2], _jax_pallas(buf, n, plens, TINY))


@pytest.mark.parametrize("W", [64, 8])
@pytest.mark.parametrize("mutate", [False, True], ids=["clean", "mutated"])
def test_decode_long_blocks_rolling_walk(W, mutate):
    rng = np.random.default_rng(31 + W + mutate)
    buf, n, plens, _ = _batch(rng, LONG, 6, W, mutate)
    _assert_same(_port(buf, n, plens, LONG), _jax_scan(buf, n, plens, LONG))


@pytest.mark.parametrize("mutate", [False, True], ids=["clean", "mutated"])
def test_decode_default_geometry(mutate):
    """Parameters() (10,000-sample frames), four frames at the full width."""
    params = Parameters()
    rng = np.random.default_rng(3 + mutate)
    buf, n, plens, wav = _batch(rng, params, 4, 5096, mutate)
    got = _port(buf, n, plens, params)
    _assert_same(got, _jax_scan(buf, n, plens, params))
    if not mutate:
        assert not got[1].any()
        np.testing.assert_array_equal(np.concatenate([got[0][i, : n[i]] for i in range(4)]), wav)


def _reader_walk(words, n, plens, params, n_blocks=None):
    """The walk with a straight bit reader: every code reads the frame's bits
    from the walk's offset, with zero bits past word W, and each block's
    start offset is recorded.  Returns (samples [F, S], err [F], final
    offset [F], block starts [F, B])."""
    from x3_tpu_torch.ops.decode_kernel import decode_geometry_of
    from x3_tpu_torch.tables import device_tables

    S, B, L, WFULL, _ = decode_geometry_of(params, n_blocks)
    tabs = device_tables(params, "cpu")
    nsubs, invlen = tabs.dec_nsubs, tabs.dec_invlen
    F, W = words.shape
    M = 0xFFFFFFFF

    def wrap16(v):
        return ((v + 0x8000) & 0xFFFF) - 0x8000

    out = np.zeros((F, 1 + B * L), np.int64)
    err = np.zeros(F, np.int64)
    off = np.zeros(F, np.int64)
    starts = np.zeros((F, B), np.int64)
    for f in range(F):
        ws = [int(x) & M for x in words[f]] + [0, 0]  # zero words past W

        def view(pos):
            i, r = pos >> 5, pos & 31
            w0, w1 = (ws[i], ws[i + 1]) if i < W else (0, 0)
            return (((w0 << 32) | w1) << r >> 32) & M

        pos = 16
        last = out[f, 0] = wrap16(ws[0] >> 16)
        for b in range(B):
            starts[f, b] = pos
            valid_block = 1 + b * L < n[f]
            hdr = view(pos)
            ftype, dec_nb = hdr >> 30, ((hdr >> 26) & 0xF) + 1
            is_rice, is_pass = ftype >= 1, ftype == 0 and dec_nb == 16
            bpf_err = valid_block and ftype == 0 and dec_nb <= 5
            pos += 6 if ftype == 0 else 2
            level = 1 << (nsubs[2] if ftype == 2 else nsubs[3])
            nbsuf = 2 if ftype == 2 else 4
            inv = invlen[ftype] if ftype else invlen[3]
            neg = 1 << min(max(dec_nb - 1, 0), 30)
            oob = False
            for k in range(L):
                valid = valid_block and 1 + b * L + k < n[f]
                v32 = view(pos)
                zeros = min(32 - v32.bit_length(), max(int(plens[f]) * 8 - pos, 0))
                suffix = ((v32 << min(zeros, 31)) & M) >> (32 - nbsuf)
                idx = zeros if ftype == 1 else suffix + level * (zeros - 1)
                oob |= valid and is_rice and not 0 <= idx < inv
                ic = min(max(idx, 0), 59)
                a = v32 >> (32 - min(dec_nb, 31))
                delta = (-((ic + 1) >> 1) if ic & 1 else (ic + 1) >> 1) if is_rice else \
                    a - (2 * neg if a > neg else 0)
                new = wrap16(v32 >> 16) if is_pass else wrap16(last + delta)
                consume = zeros + 1 if ftype == 1 else (zeros + nbsuf if is_rice else dec_nb)
                if valid:
                    pos += min(consume, 16)
                    last = new
                out[f, 1 + b * L + k] = new
            if not err[f]:
                err[f] = 1 if bpf_err else (2 if oob else 0)
        if not err[f] and pos > WFULL * 32:
            err[f] = 3
        off[f] = pos
    return out[:, :S], err, off, starts


@pytest.mark.parametrize("mutate", [False, True], ids=["clean", "mutated"])
@pytest.mark.parametrize("params,n_frames,W", [
    (TINY, 9, 8), (Parameters(block_len=7, blocks_per_frame=40), 6, 48), (LONG, 6, 16),
    (Parameters(), 4, 1024),
], ids=["tiny", "L7", "long", "default"])
def test_in_buffer_blocks_read_the_plain_bitstream(params, n_frames, W, mutate):
    """The invariant K3's register bit reader rests on: a block that starts
    inside the buffer (offset < 32 W) reads, under the JAX walk's window and
    stage masks (and the rolling register of blocks longer than 24 samples),
    exactly the frame's bits from its offset with zeros past word W.  So on
    every lane whose block starts all lie below 32 W a straight bit-reader
    walk equals decode_words_plain in every output slot."""
    from x3_tpu_torch.ops.decode_kernel import decode_words_plain, payload_words

    rng = np.random.default_rng(41 + 7 * params.block_len + mutate)
    buf, n, plens, _ = _batch(rng, params, n_frames, W, mutate)
    words = payload_words(torch.from_numpy(buf))
    out, err, off, starts = _reader_walk(words.numpy(), n, plens, port_params(params))
    want = decode_words_plain(words, torch.from_numpy(n), torch.from_numpy(plens), port_params(params))
    inside = (starts < 32 * W).all(axis=1)
    if mutate:
        assert inside.any() and not inside.all(), "lanes on both sides of the condition"
    else:
        assert inside.any()
    for got, ref, name in zip((out, err, off), want, ("samples", "err", "offset")):
        np.testing.assert_array_equal(got[inside], ref.numpy()[inside], err_msg=name)


def test_decode_frames_unchecked_matches():
    import jax.numpy as jnp

    from x3_tpu.ops.decode_kernel import decode_frames as ref

    from x3_tpu_torch.ops.decode_kernel import ERR_OVERRUN, decode_frames

    rng = np.random.default_rng(9)
    buf, n, plens, _ = _batch(rng, TINY, 7, 16, True)
    got = decode_frames(torch.from_numpy(buf), torch.from_numpy(n), torch.from_numpy(plens),
                        port_params(TINY))
    want = ref(jnp.asarray(buf), jnp.asarray(n), jnp.asarray(plens), TINY)
    _assert_same([x.numpy() for x in got], [np.asarray(x) for x in want])
    assert ERR_OVERRUN == 3

"""x3_tpu_torch's decode (plain version of kernel K3, plus the CRC) against
x3_tpu's XLA scan decode and its Pallas decode kernel in interpret mode,
on clean and corrupt payloads: every output slot of every lane must match,
error lanes included.  Exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from tests.conftest import make_hydrophone, make_mixed
from x3_tpu.models import oracle
from x3_tpu.params import Parameters

TINY = Parameters(block_len=4, blocks_per_frame=8)  # 32 samples/frame, WIN=4
LONG = Parameters(block_len=30, blocks_per_frame=3)  # blocks > 24: rolling walk


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
    out = decode_frames_checked(t(buf), t(n), t(plens), params, n_blocks)
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
        payload_words(torch.from_numpy(buf)), torch.from_numpy(n), torch.from_numpy(plens), TINY
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


def test_decode_frames_unchecked_matches():
    import jax.numpy as jnp

    from x3_tpu.ops.decode_kernel import decode_frames as ref

    from x3_tpu_torch.ops.decode_kernel import ERR_OVERRUN, decode_frames

    rng = np.random.default_rng(9)
    buf, n, plens, _ = _batch(rng, TINY, 7, 16, True)
    got = decode_frames(torch.from_numpy(buf), torch.from_numpy(n), torch.from_numpy(plens), TINY)
    want = ref(jnp.asarray(buf), jnp.asarray(n), jnp.asarray(plens), TINY)
    _assert_same([x.numpy() for x in got], [np.asarray(x) for x in want])
    assert ERR_OVERRUN == 3

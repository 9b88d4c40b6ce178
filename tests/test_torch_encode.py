"""x3_tpu_torch's encode_frames (plain version of kernel K2 plus the CRC)
against x3_tpu's encode_frames(pack_mode="block") at every width rung,
including overflowing ones, and against the fused Pallas encode kernel in
interpret mode.  Exact (tolerance 0)."""

import itertools

import numpy as np
import pytest
import torch

from tests.conftest import make_hydrophone, make_mixed
from x3_tpu.params import Parameters

TINY = Parameters(block_len=4, blocks_per_frame=8)  # 32 samples/frame, W=24, NW=4


def _frames(rng, params, F):
    spf = params.samples_per_frame
    frames = make_mixed(rng, F * spf).reshape(F, spf).astype(np.int16)
    n_valid = np.full(F, spf, np.int32)
    n_valid[-1] = spf - 2  # partial frame
    n_valid[-2] = 1  # single-sample frame
    n_valid[-3] = 0  # dummy frame
    frames[-3] = 0
    frames[-1, spf - 2 :] = 0
    frames[-2, 1:] = 0
    return frames, n_valid


def _jax(frames, n_valid, params, w, nw):
    import jax.numpy as jnp

    from x3_tpu.ops.encode_kernel import encode_frames

    out = encode_frames(jnp.asarray(frames), jnp.asarray(n_valid), params, "block", w, nw)
    return {k: np.asarray(v) for k, v in out.items()}


def _port(frames, n_valid, params, w, nw):
    from x3_tpu_torch.ops.encode_kernel import encode_frames

    out = encode_frames(torch.from_numpy(frames), torch.from_numpy(n_valid), params, w, nw)
    return {k: v.numpy() for k, v in out.items()}


def _assert_contract(got, want, params, w, nw):
    """Counts exact on every frame; words and CRC exact on frames that fit
    both rungs (the others are truncated, as the contract allows)."""
    from x3_tpu.ops.encode_kernel import block_buffer_words, frame_geometry

    for key in ("nbytes", "total_bits", "stats", "blockfit_bits"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    WF = frame_geometry(params)[3]
    fits = (want["nbytes"] <= (min(w, WF) - 2) * 4) | (w >= WF)
    fits &= (want["blockfit_bits"] <= (nw + 7) * 32) | (nw >= block_buffer_words(params))
    words = got["payload_words"].view(np.uint32)
    np.testing.assert_array_equal(words[fits], want["payload_words"][fits])
    np.testing.assert_array_equal(got["crc"][fits], want["crc"][fits])
    return fits


@pytest.mark.parametrize("w,nw", list(itertools.product([6, 8, 12, 24], [2, 3, 4])))
def test_encode_matches_jax_at_every_rung(w, nw):
    rng = np.random.default_rng(100 + w * 10 + nw)
    frames, n_valid = _frames(rng, TINY, 11)
    got = _port(frames, n_valid, TINY, w, nw)
    want = _jax(frames, n_valid, TINY, w, nw)
    fits = _assert_contract(got, want, TINY, w, nw)
    assert fits.sum() >= 3  # dummy, single-sample and partial frames always fit
    if w < 12:
        assert not fits.all(), "the compact rung must overflow some frames"


def test_encode_words_exact_at_full_width(rng):
    """At the full rungs every frame's words equal JAX's, and int32 samples
    encode like int16 ones."""
    frames, n_valid = _frames(rng, TINY, 23)
    want = _jax(frames, n_valid, TINY, None, None)
    got = _port(frames, n_valid, TINY, None, None)
    assert _assert_contract(got, want, TINY, 24, 4).all()
    got32 = _port(frames.astype(np.int32), n_valid, TINY, None, None)
    for k in got:
        np.testing.assert_array_equal(got32[k], got[k])


@pytest.mark.parametrize("W", [24, 8])
def test_encode_matches_fused_pallas_interpret(rng, W):
    import jax.numpy as jnp

    from x3_tpu.ops.encode_fused_pallas import encode_frames_fused_words

    from x3_tpu_torch.ops.encode_kernel import encode_words_plain

    frames, n_valid = _frames(rng, TINY, 11)
    words, total_bits, blockfit, stats = encode_frames_fused_words(
        jnp.asarray(frames), jnp.asarray(n_valid), TINY, W, True, (3, 256, 2, "dyn")
    )
    pw, ptb, pbf, pnb, pst = encode_words_plain(
        torch.from_numpy(frames), torch.from_numpy(n_valid), TINY, W
    )
    np.testing.assert_array_equal(ptb.numpy(), np.asarray(total_bits))
    np.testing.assert_array_equal(pbf.numpy(), np.asarray(blockfit))
    np.testing.assert_array_equal(pst.numpy(), np.asarray(stats))
    nb = (np.asarray(total_bits) + 7) // 8
    np.testing.assert_array_equal(pnb.numpy(), nb + (nb & 1))
    fits = pnb.numpy() <= (W - 2) * 4
    np.testing.assert_array_equal(pw.numpy().view(np.uint32)[fits], np.asarray(words)[fits])


@pytest.mark.parametrize("w,nw", [(2048, 6), (512, 4), (None, None)])
def test_encode_default_geometry(w, nw):
    """Parameters() (10,000-sample frames) on four frames: a hydrophone-like
    frame, a mixed frame, a partial frame and a single-sample frame."""
    params = Parameters()
    spf = params.samples_per_frame
    rng = np.random.default_rng(7)
    frames = np.stack(
        [make_hydrophone(rng, spf), make_mixed(rng, spf), make_hydrophone(rng, spf), np.zeros(spf)]
    ).astype(np.int16)
    n_valid = np.asarray([spf, spf, 4321, 1], np.int32)
    frames[2, 4321:] = 0
    frames[3, 0] = -1234
    got = _port(frames, n_valid, params, w, nw)
    want = _jax(frames, n_valid, params, w, nw)
    fits = _assert_contract(got, want, params, w or 10**9, nw or 10**9)
    assert fits[3] and fits[0] == (w != 512)  # the 512-word rung overflows full frames

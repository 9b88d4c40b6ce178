"""x3_tpu_torch's geometry helpers and device tables equal x3_tpu's values."""

import dataclasses

import numpy as np
import pytest
import torch

import x3_tpu_torch as xt
from x3_tpu.params import Parameters

PARAMS = [
    Parameters(block_len=4, blocks_per_frame=8),
    Parameters(),
    Parameters(block_len=30, blocks_per_frame=3),
    Parameters(block_len=60, blocks_per_frame=5),
    Parameters(block_len=7, blocks_per_frame=40),
    Parameters(block_len=1, blocks_per_frame=3),
    Parameters(codes=(1, 2, 3), thresholds=(8, 20, 40)),
    Parameters(block_len=12, blocks_per_frame=64, codes=(0, 2, 3), thresholds=(2, 12, 30)),
]
IDS = [f"L{p.block_len}B{p.blocks_per_frame}c{''.join(map(str, p.codes))}" for p in PARAMS]


def port_params(p: Parameters) -> xt.Parameters:
    """The port's Parameters with the same fields as the JAX package's."""
    return xt.Parameters(**dataclasses.asdict(p))


@pytest.mark.parametrize("params", PARAMS, ids=IDS)
def test_geometry_helpers_match(params):
    from x3_tpu.ops import encode_kernel as ref

    from x3_tpu_torch.ops import encode_kernel as port

    pp = port_params(params)
    assert port.frame_geometry(pp) == ref.frame_geometry(params)
    for nb in (1, params.blocks_per_frame, 2 * params.blocks_per_frame, 1000):
        assert port.frame_geometry_blocks(pp, nb) == ref.frame_geometry_blocks(params, nb)
        assert port._worst_case_words(pp, nb) == ref._worst_case_words(params, nb)
    assert port.block_buffer_words(pp) == ref.block_buffer_words(params)
    assert port.width_rungs(pp) == ref.width_rungs(params)
    assert port.block_width_rungs(pp) == ref.block_width_rungs(params)
    np.testing.assert_array_equal(port._rice_nsubs_np(pp), ref._rice_nsubs_np(params))


@pytest.mark.parametrize("params", PARAMS, ids=IDS)
def test_fits_predicates_match(params):
    from x3_tpu.ops import encode_kernel as ref

    from x3_tpu_torch.ops import encode_kernel as port

    rng = np.random.default_rng(1)
    pp = port_params(params)
    W = ref.frame_geometry(params)[3]
    for w in sorted({2, 8, 512, W - 1, W, W + 8}):
        for nb in (np.zeros(0, np.int32), rng.integers(0, 4 * w + 9, 7).astype(np.int32)):
            assert port.fits_width(nb, w, pp) == ref.fits_width(nb, w, params)
            assert port.fits_width(nb, w) == ref.fits_width(nb, w)
    for nw in sorted({1, 2, 4, 6, ref.block_buffer_words(params)}):
        bf = rng.integers(0, 64 * nw, 5).astype(np.int32)
        assert port.fits_block_width(bf, nw, pp) == ref.fits_block_width(bf, nw, params)
        assert port.fits_block_width(bf, nw) == ref.fits_block_width(bf, nw)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_rice_closed_form_matches(order):
    import jax.numpy as jnp

    from x3_tpu.ops.encode_kernel import rice_code_closed_form as ref

    from x3_tpu_torch.ops.encode_kernel import rice_code_closed_form

    d = np.arange(-200, 201, dtype=np.int32)
    code, bits = rice_code_closed_form(torch.from_numpy(d).to(torch.int64), order)
    rcode, rbits = ref(jnp.asarray(d), order)
    np.testing.assert_array_equal(code.numpy(), np.asarray(rcode))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rbits))


@pytest.mark.parametrize("params", PARAMS, ids=IDS)
def test_device_tables_match(params):
    from x3_tpu.ops.decode_kernel import _decode_tables
    from x3_tpu.ops.encode_kernel import _rice_nsubs_np

    from x3_tpu_torch.tables import device_tables

    t = device_tables(port_params(params), "cpu")
    nsubs, invlen = _decode_tables(params)
    np.testing.assert_array_equal(t.dec_consts.numpy(), np.concatenate([nsubs, invlen]))
    assert t.dec_nsubs == tuple(nsubs.tolist()) and t.dec_invlen == tuple(invlen.tolist())
    want = list(params.thresholds) + list(params.codes) + _rice_nsubs_np(params).tolist()
    assert t.enc_consts.tolist() == want
    assert t.enc_consts.dtype == t.dec_consts.dtype == torch.int32


@pytest.mark.parametrize("n_words", [1, 3, 24, 160])
def test_crc_tables_match(n_words):
    from x3_tpu.ops.crc import CRC_TABLE
    from x3_tpu.ops.crc_jax import crc_matmul_consts

    from x3_tpu_torch.tables import FOLD_E, crc_consts, crc_fold_tables

    e3 = crc_fold_tables("cpu")[FOLD_E + 768 : FOLD_E + 1024].numpy().view(np.uint16)
    assert e3.tolist() == CRC_TABLE.tolist()  # E_3, the last byte of a word, is T itself
    m, const_init, inv_pows = crc_consts(n_words, "cpu")
    rm, rc, rinv = crc_matmul_consts(n_words * 4)
    np.testing.assert_array_equal(m.numpy(), rm.astype(np.float32))
    assert const_init == rc
    np.testing.assert_array_equal(inv_pows, rinv)


@pytest.mark.parametrize(
    "n_samples,lens",
    [([], []), ([33, 10, 0], [20, 300, 0]), ([33, 34], [90, 90]), ([200, 5], [2000, 5000]),
     ([10000, 9999], [20000, 40000]), ([70000], [130000])],
)
@pytest.mark.parametrize("params", PARAMS[:3], ids=IDS[:3])
def test_decode_geometry_matches(params, n_samples, lens):
    from x3_tpu.models.decoder import decode_geometry as ref

    from x3_tpu_torch.models.decoder import decode_geometry

    assert decode_geometry(port_params(params), n_samples, lens) == ref(params, n_samples, lens)

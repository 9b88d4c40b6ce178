"""CUDA kernels of x3_tpu_torch against their plain PyTorch versions.

These tests need a CUDA GPU and nvcc; they skip elsewhere.  They import no
jax, so on a GPU host without jax run them without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Every comparison is exact (integer codec: tolerance 0)."""

import numpy as np
import pytest
import torch

from x3_tpu.models import oracle
from x3_tpu.params import Parameters

pytestmark = pytest.mark.gpu

GEOMETRIES = [
    Parameters(block_len=4, blocks_per_frame=8),
    Parameters(),
    Parameters(block_len=30, blocks_per_frame=3),
    Parameters(block_len=7, blocks_per_frame=40),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _mixed(rng, n):
    """Silence, small and medium noise, BFP jumps, full-scale noise and a
    random walk: every block type."""
    seg = max(1, n // 6)
    parts = [
        np.zeros(seg),
        np.round(rng.normal(0, 1.2, seg)),
        np.round(rng.normal(0, 5, seg)),
        np.round(rng.normal(0, 400, seg)),
        rng.integers(-32768, 32768, seg),
        np.cumsum(rng.integers(-40, 41, n - 5 * seg)),
    ]
    return np.clip(np.concatenate(parts), -32768, 32767).astype(np.int16)[:n]


def _frames(rng, params, F):
    S = params.samples_per_frame
    frames = _mixed(rng, F * S).reshape(F, S)
    n_valid = np.full(F, S, np.int32)
    n_valid[-1], n_valid[-2], n_valid[-3], n_valid[0] = S - 2, 1, 0, 5
    frames[-3] = 0
    return frames, n_valid


def _assert_all_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w.cpu()), f"{what}: output {i} differs"


@pytest.mark.parametrize("params", GEOMETRIES, ids=lambda p: f"L{p.block_len}B{p.blocks_per_frame}")
def test_kernels_match_plain(cuda, params):
    from x3_tpu_torch.ops import crc_cuda, decode_cuda, encode_cuda
    from x3_tpu_torch.ops.encode_kernel import frame_geometry

    rng = np.random.default_rng(11)
    S, B, _, WF = frame_geometry(params)
    F = 9 if S > 1000 else 40
    frames, n_valid = _frames(rng, params, F)
    st = torch.from_numpy(frames).to(cuda)
    nv = torch.from_numpy(n_valid).to(cuda)
    for W in sorted({8, 64, max(8, WF // 3), WF}):
        got = encode_cuda.encode_words_cuda(st, nv, params, W)
        _assert_all_equal(got, encode_cuda.plain(st, nv, params, W), f"encode W={W}")
        crc = crc_cuda.crc16_words_cuda(got[0], got[3], W)
        _assert_all_equal([crc], [crc_cuda.plain(got[0], got[3], W)], f"crc W={W}")

    words, _, _, nbytes, _ = encode_cuda.encode_words_cuda(st, nv, params, WF)
    # The plain walk steps through every sample: keep the default geometry's
    # case list short.
    big = S > 1000
    widths = {8, WF} if big else {8, int(nbytes.max()) // 4 + 1, WF}
    for Wd in sorted(widths):
        w = words[:, :Wd].contiguous()
        plens = nbytes.clamp(max=4 * Wd)
        flips = torch.from_numpy(rng.integers(-(2**31), 2**31, w.shape).astype(np.int32)).to(cuda)
        hit = torch.from_numpy(rng.random(w.shape) < 0.05).to(cuda)
        noise = torch.from_numpy(rng.integers(-(2**31), 2**31, w.shape).astype(np.int32)).to(cuda)
        cases = [(w, nv), (torch.where(hit, w ^ flips, w), nv), (noise, torch.full_like(nv, S))]
        for c, (ww, ns) in enumerate(cases):
            for nb in (None,) if big and c < 2 else (None, 2 * B):
                got = decode_cuda.decode_words_cuda(ww, ns, plens, params, nb)
                want = decode_cuda.plain(ww, ns, plens, params, nb)
                _assert_all_equal(got, want, f"decode Wd={Wd} case={c} n_blocks={nb}")
            crc = crc_cuda.crc16_words_cuda(ww, plens, Wd)
            _assert_all_equal([crc], [crc_cuda.plain(ww, plens, Wd)], f"decode crc case={c}")


@pytest.mark.parametrize("params", GEOMETRIES[:2], ids=["tiny", "default"])
def test_slice_on_cuda_matches_cpu_and_oracle(cuda, params):
    import x3_tpu_torch as xt
    from x3_tpu_torch.ops import crc_cuda, decode_cuda, encode_cuda

    rng = np.random.default_rng(3)
    wav = _mixed(rng, params.samples_per_frame * 5 + 17)
    for mod in (crc_cuda, decode_cuda, encode_cuda):
        mod.launch_count = 0
    res = xt.encode(wav, params, batch_frames=4, device=cuda)
    assert res.data == xt.encode(wav, params, batch_frames=4, device="cpu").data
    assert res.data == oracle.encode(wav, params)
    payloads, counts, crcs, off = [], [], [], 0
    while off < len(res.data):
        h = res.data[off : off + 20]
        plen = int.from_bytes(h[6:8], "big")
        counts.append(int.from_bytes(h[4:6], "big"))
        crcs.append(int.from_bytes(h[18:20], "big"))
        payloads.append(res.data[off + 20 : off + 20 + plen])
        off += 20 + plen
    outs, err, ok = xt.decode_frames_batch(payloads, counts, params, check_crcs=crcs, device=cuda)
    assert not err.any() and ok.all()
    np.testing.assert_array_equal(np.concatenate(outs), wav)
    assert min(crc_cuda.launch_count, decode_cuda.launch_count, encode_cuda.launch_count) > 0


def test_wrappers_launch_on_their_tensors_device(cuda):
    """With device 0 current, tensors on every visible device go to their
    own device's kernels (and the slice runs on an explicit index)."""
    import x3_tpu_torch as xt
    from x3_tpu_torch.ops import crc_cuda, decode_cuda, encode_cuda
    from x3_tpu_torch.ops.encode_kernel import frame_geometry

    params = GEOMETRIES[0]
    S, _, _, WF = frame_geometry(params)
    frames, n_valid = _frames(np.random.default_rng(5), params, 40)
    st_cpu, nv_cpu = torch.from_numpy(frames), torch.from_numpy(n_valid)
    want = encode_cuda.plain(st_cpu, nv_cpu, params, WF)
    wav = _mixed(np.random.default_rng(6), S * 7 + 3)
    for idx in range(torch.cuda.device_count()):
        dev = torch.device("cuda", idx)
        with torch.cuda.device(0):
            st, nv = st_cpu.to(dev), nv_cpu.to(dev)
            got = encode_cuda.encode_words_cuda(st, nv, params, WF)
            assert all(g.device == dev for g in got)
            _assert_all_equal(got, want, f"encode on {dev}")
            crc = crc_cuda.crc16_words_cuda(got[0], got[3], WF)
            _assert_all_equal([crc], [crc_cuda.plain(want[0], want[3], WF)], f"crc on {dev}")
            dec = decode_cuda.decode_words_cuda(got[0], nv, got[3], params)
            _assert_all_equal(dec, decode_cuda.plain(want[0], nv_cpu, want[3], params),
                              f"decode on {dev}")
            res = xt.encode(wav, params, batch_frames=3, device=f"cuda:{idx}")
            torch.cuda.synchronize(dev)
        assert res.data == oracle.encode(wav, params)

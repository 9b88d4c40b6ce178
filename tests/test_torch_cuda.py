"""CUDA kernels of x3_tpu_torch against their plain PyTorch versions.

These tests need a CUDA GPU and nvcc; they skip elsewhere.  They import
the port alone (no jax, no x3_tpu), so on a GPU host run them without the
suite's conftest, which imports jax:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Every comparison is exact (integer codec: tolerance 0)."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import K5_EDGES, K6_EDGES
from chip_smoke import mixed_signal as _mixed
from x3_tpu_torch import Parameters

GOLDEN = Path(__file__).resolve().parent / "data" / "golden.npz"

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


@pytest.mark.parametrize("params,F", [
    (GEOMETRIES[0], 1), (GEOMETRIES[0], 33), (GEOMETRIES[2], 33), (GEOMETRIES[3], 70), (GEOMETRIES[1], 33),
    (Parameters(block_len=7, blocks_per_frame=41), 70),
], ids=["L4B8-F1", "L4B8-F33", "L30B3-F33", "L7B40-F70", "default-F33", "L7B41-F70"])
def test_decode_kernel_edges(cuda, params, F):
    """K3 at the edges of its staged tiles and its bit reader: a partial
    warp (F=1) and partial CTAs (F=33, 70); rows of 32, 90 and 280 samples
    (not multiples of the tile); both store paths of a tile: full warps at
    an even row length (every row 4-byte aligned, S=280 and 10,000) and at
    an odd one (every other row aligned: S=287 with odd B and L, and the
    n_blocks=2B override's 1 + 2BL); odd compact widths; and noise lanes
    whose walk crosses, in the middle of a frame, from blocks that start
    inside the buffer (register reader) to blocks that start past it
    (windowed read)."""
    from x3_tpu_torch.ops import decode_cuda, encode_cuda
    from x3_tpu_torch.ops.encode_kernel import frame_geometry

    rng = np.random.default_rng(17 + F + params.block_len)
    S, B, _, WF = frame_geometry(params)
    nv = torch.full((F,), S, dtype=torch.int32, device=cuda)
    st = torch.from_numpy(_mixed(rng, F * S).reshape(F, S)).to(cuda)
    words, _, _, nbytes, _ = encode_cuda.encode_words_cuda(st, nv, params, WF)
    big = S > 1000  # the plain walk steps through every sample
    for Wd in (5, WF) if big else (3, 5, WF):
        noise = torch.from_numpy(rng.integers(-(2**31), 2**31, (F, Wd)).astype(np.int32)).to(cuda)
        is_noise = (torch.arange(F, device=cuda) % 2 == 0)[:, None]
        ww = torch.where(is_noise, noise, words[:, :Wd]).contiguous()
        plens = torch.where(is_noise[:, 0], 4 * Wd, nbytes.clamp(max=4 * Wd)).to(torch.int32)
        for nb in (None,) if big else (None, 2 * B):
            got = decode_cuda.decode_words_cuda(ww, nv, plens, params, nb)
            want = decode_cuda.plain(ww, nv, plens, params, nb)
            _assert_all_equal(got, want, f"decode F={F} Wd={Wd} n_blocks={nb}")
        if Wd < WF:
            # The offset after B - 1 blocks is where the last block starts.
            last_start = decode_cuda.plain(ww, nv, plens, params, B - 1)[2]
            assert (last_start > 32 * Wd).any(), "a lane must cross the buffer's end mid-frame"


@pytest.mark.parametrize("params,F,case", [
    (GEOMETRIES[0], 1, ""), (GEOMETRIES[0], 141, ""), (GEOMETRIES[2], 33, ""),
    (Parameters(block_len=7, blocks_per_frame=41), 141, ""), (GEOMETRIES[1], 33, ""),
    (GEOMETRIES[1], 141, "noise"), (GEOMETRIES[2], 33, "offset"),
    (Parameters(block_len=7, blocks_per_frame=41, thresholds=(3, 8, 2000)), 33, ""),
    (Parameters(block_len=6200, blocks_per_frame=2), 33, "long"),
    (Parameters(block_len=1000, blocks_per_frame=3), 33, "W57000"),
    (GEOMETRIES[2], 33, "Wmax"),
], ids=["L4B8-F1", "L4B8-F141", "L30B3-F33", "L7B41-F141", "default-F33", "default-noise-F141",
        "L30B3-offset-F33", "L7B41-t2000-F33", "L6200B2-F33", "L1000B3-W57000-F33", "L30B3-Wmax-F33"])
def test_encode_kernel_edges(cuda, params, F, case):
    """K2 against its plain version, exactly, at the edges of its design:
    partial waves (F = 1, 33, 141); rows of 32, 90, 287 and 10,000 samples
    (16-, 4- and 2-byte aligned) and a batch that starts 6 bytes past a
    16-byte boundary (the staging's scalar head and tail); the n_valid
    edges; full-scale noise at the full rung (the longest payloads); rungs
    of 1 and 8 words and an overflowing compact rung; Rice items of up to
    504 bits; a block longer than the staging buffer (device-memory reads);
    and words that leave room for two blocks a chunk, or for none."""
    from chip_smoke import k2_edge_batch, k2_edge_widths
    from x3_tpu_torch.ops import encode_cuda
    from x3_tpu_torch.ops.encode_kernel import frame_geometry

    rng = np.random.default_rng(29 + F + params.block_len)
    frames, n_valid = k2_edge_batch(rng, params, F, noise=case == "noise")
    st = torch.from_numpy(frames).to(cuda)
    if case == "offset":
        flat = torch.zeros(st.numel() + 3, dtype=torch.int16, device=cuda)
        flat[3:] = st.reshape(-1)
        st = flat[3:].view(st.shape)
    nv = torch.from_numpy(n_valid).to(cuda)
    WF = frame_geometry(params)[3]
    widths = {"W57000": [57000], "Wmax": [encode_cuda.MAX_WORDS]}.get(case)
    if widths is None:
        widths = k2_edge_widths(params, encode_cuda.plain(st, nv, params, WF)[3].cpu().numpy())
    blocks_a_chunk = {"W57000": 2, "Wmax": 0, "long": 0}  # 0: no staging, device-memory reads
    if case in blocks_a_chunk:
        assert encode_cuda.chunk_blocks(params.blocks_per_frame, params.block_len, widths[-1])[1] == \
            blocks_a_chunk[case]
    for W in widths:
        got = encode_cuda.encode_words_cuda(st, nv, params, W)
        _assert_all_equal(got, encode_cuda.plain(st, nv, params, W), f"encode W={W}")
    with pytest.raises(ValueError):
        encode_cuda.encode_words_cuda(st, nv, params, encode_cuda.MAX_WORDS + 1)


@pytest.mark.parametrize("F", [1, "all"])
@pytest.mark.parametrize("W", [1, 5, 131, 4096])
def test_crc_kernel_edges(cuda, W, F):
    """K1 at the edges of its stripes, masks and CTAs, junk past every
    length (chip_smoke.crc_edge_lengths, the lengths of its phase-3 sweep):
    one frame, and 141 frames (not a multiple of the CTA's four
    frame-warps); rows of 1, 5, 131 and 4,096 words."""
    from chip_smoke import crc_edge_lengths
    from x3_tpu_torch.ops import crc_cuda

    rng = np.random.default_rng(23 + W)
    lens = crc_edge_lengths(rng, W)
    lens = lens[:1] if F == 1 else lens
    assert F == 1 or len(lens) % 4
    words = torch.from_numpy(rng.integers(-(2**31), 2**31, (len(lens), W)).astype(np.int32)).to(cuda)
    lengths = torch.from_numpy(lens).to(cuda)
    got = crc_cuda.crc16_words_cuda(words, lengths, W)
    _assert_all_equal([got], [crc_cuda.plain(words, lengths, W)], f"crc W={W} F={len(lens)}")


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
    golden = np.load(GOLDEN)
    assert xt.encode(golden["frame_wav"], Parameters(), device=cuda).data == golden["frame_expected"].tobytes()
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
        assert res.data == xt.encode(wav, params, batch_frames=3, device="cpu").data


@pytest.mark.parametrize("params", GEOMETRIES, ids=lambda p: f"L{p.block_len}B{p.blocks_per_frame}")
def test_pack_route_kernels_match_plain(cuda, params):
    """K4 (front), K5 (block pack) and K6 (pack walk) against their plain
    versions on the tensors the pack routes give them, at the full rungs
    and at compact rungs that overflow."""
    from x3_tpu_torch.ops import front_cuda, pack_cuda, pack_walk_cuda
    from x3_tpu_torch.ops._bits import as_i32
    from x3_tpu_torch.ops.encode_kernel import (
        _block_layout, _items, _lanes, _pairs, block_buffer_words, frame_geometry, front_lanes)

    rng = np.random.default_rng(13)
    S, B, L, WF = frame_geometry(params)
    F = 9 if S > 1000 else 40
    frames, n_valid = _frames(rng, params, F)
    st = torch.from_numpy(frames).to(cuda)
    nv = torch.from_numpy(n_valid).to(cuda)
    args = (*front_lanes(st, nv, params), params)
    _assert_all_equal(front_cuda.encode_front_cuda(*args), front_cuda.plain(*args), "front")

    iv, il, _ = _items(st, nv, params)
    block_off, _, _ = _block_layout(il.sum(dim=2))
    r2 = (block_off & 255).reshape(1, -1).to(torch.int32)
    vals, lens = _lanes(as_i32(iv)), _lanes(il)
    for nw in sorted({1, 4, block_buffer_words(params)}):
        got = pack_cuda.pack_blocks_cuda(vals, lens, r2, nw + 7)
        _assert_all_equal([got], [pack_cuda.plain(vals, lens, r2, nw + 7)], f"pack_blocks nw={nw}")

    mval, mlen = _pairs(iv, il)
    mval, mlen, boff = as_i32(mval), mlen.to(torch.int32), block_off.to(torch.int32)
    for W in sorted({8, max(8, WF // 3), WF}):
        got = pack_walk_cuda.pack_walk_cuda(mval, mlen, boff, W, L)
        _assert_all_equal([got], [pack_walk_cuda.plain(mval, mlen, boff, W, L)], f"pack_walk W={W}")


@pytest.mark.parametrize("case", [f"k5-nb4{nb4}-I{I}" for nb4, I in K5_EDGES] + [f"k6-{c}" for c in K6_EDGES])
def test_pack_kernel_edges(cuda, case):
    """K5 and K6 against their plain versions, exactly, on chip_smoke's
    edge tensors: K5 lanes with values wider than their length, 32-bit
    items, items ending on a word before zero-length items with non-zero
    values, offsets that skip slots and drop every piece, at nb4 1, 13 and
    40, item counts on and off the unroll factor, 300,001 lanes (more than
    one wave of resident CTAs); K6 frames of the same pairs, packed, with
    gaps and word-aligned starts, or overlapping, at W = 8, a compact W, a
    fitting W, with blocks past NB words, at MAX_WORDS and one word less,
    and inputs off a 16-byte boundary."""
    from chip_smoke import k5_edge_batch, k6_edge_case, on_device
    from x3_tpu_torch.ops import pack_cuda, pack_walk_cuda

    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("k5-"):
        nb4, I = K5_EDGES[[f"k5-nb4{a}-I{b}" for a, b in K5_EDGES].index(case)]
        vals, lens, r2 = (on_device(a) for a in k5_edge_batch(rng, I, 300001))
        got = pack_cuda.pack_blocks_cuda(vals, lens, r2, nb4)
        _assert_all_equal([got], [pack_cuda.plain(vals, lens, r2, nb4)], case)
    else:
        mval, mlen, boff, W, L, shift = k6_edge_case(rng, case[3:])
        args = (on_device(mval, shift), on_device(mlen, shift), on_device(boff), W, L)
        _assert_all_equal([pack_walk_cuda.pack_walk_cuda(*args)], [pack_walk_cuda.plain(*args)], case)


@pytest.mark.parametrize("mode,env", [
    ("block_pallas", {}), ("fused_pallas", {}), ("segment", {}),
    ("block", {"X3_FUSED_ENCODE": "0", "X3_PALLAS_PACK": "1"}),
    ("block", {"X3_FUSED_ENCODE": "0", "X3_PALLAS_PACK": "0"}),
], ids=["block_pallas", "fused_pallas", "segment", "block-K6", "block-pairs"])
def test_pack_routes_on_cuda_match_cpu(cuda, mode, env):
    """encode_frames on the card equals the CPU run of the same route,
    every output, at a fitting rung and at compact rungs that overflow."""
    from x3_tpu_torch.ops.encode_kernel import encode_frames

    params = GEOMETRIES[1]
    frames, n_valid = _frames(np.random.default_rng(14), params, 6)
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for w, nw in ((None, None), (512, 4)):
            got = encode_frames(torch.from_numpy(frames).to(cuda), torch.from_numpy(n_valid).to(cuda),
                                params, mode, w, nw)
            want = encode_frames(torch.from_numpy(frames), torch.from_numpy(n_valid), params, mode, w, nw)
            _assert_all_equal([got[k] for k in sorted(got)], [want[k] for k in sorted(want)],
                              f"{mode} {env} w={w} nw={nw}")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("params,batch", [(GEOMETRIES[0], 3), (GEOMETRIES[1], None)], ids=["tiny-b3", "default"])
def test_file_roundtrip_on_cuda_matches_cpu(cuda, tmp_path, params, batch):
    """wav_to_x3a on the card gives the CPU archive byte for byte, and
    x3a_to_wav, verify_x3a and X3aReader on the card give the input back,
    through K1-K3."""
    from x3_tpu_torch import files
    from x3_tpu_torch.ops import crc_cuda, decode_cuda, encode_cuda
    from x3_tpu_torch.utils.wav import write_wav

    S = params.samples_per_frame
    wav = _mixed(np.random.default_rng(21), S * 7 + 5)
    src = tmp_path / "in.wav"
    write_wav(src, wav, 96000)
    for mod in (crc_cuda, decode_cuda, encode_cuda):
        mod.launch_count = 0
    files.wav_to_x3a(src, tmp_path / "gpu.x3a", params, batch_frames=batch, device=cuda)
    files.wav_to_x3a(src, tmp_path / "cpu.x3a", params, batch_frames=batch, device="cpu")
    assert (tmp_path / "gpu.x3a").read_bytes() == (tmp_path / "cpu.x3a").read_bytes()
    assert files.x3a_to_wav(tmp_path / "gpu.x3a", tmp_path / "back.wav", batch_frames=batch, device=cuda) == 0
    assert (tmp_path / "back.wav").read_bytes() == src.read_bytes()
    report = files.verify_x3a(tmp_path / "gpu.x3a", batch_frames=batch, device=cuda)
    assert report["ok"] and report["n_frames"] == 8 and report["n_samples_ok"] == len(wav)
    with files.X3aReader(tmp_path / "gpu.x3a", batch_frames=batch, device=cuda) as r:
        np.testing.assert_array_equal(r.read_samples(S - 3, 2 * S), wav[S - 3 : 3 * S - 3])
        np.testing.assert_array_equal(r.decode_frame_at(7), wav[7 * S :])
    assert min(crc_cuda.launch_count, decode_cuda.launch_count, encode_cuda.launch_count) > 0


def _stream_archive(tmp_path, params, n_frames: int, seed: int):
    """A WAV of n_frames frames and 5 samples, and its archive from the CPU."""
    from x3_tpu_torch import files
    from x3_tpu_torch.utils.wav import write_wav

    src, x3a = tmp_path / "in.wav", tmp_path / "in.x3a"
    write_wav(src, _mixed(np.random.default_rng(seed), params.samples_per_frame * n_frames + 5), 96000)
    files.wav_to_x3a(src, x3a, params, device="cpu")
    return src, x3a


@pytest.mark.parametrize("params,n_frames,chunk", [(GEOMETRIES[0], 9, 200), (GEOMETRIES[1], 24, 50_000)],
                         ids=["tiny-chunk200", "default-chunk50k"])
def test_file_stream_on_cuda_matches_cpu_and_walker(cuda, tmp_path, monkeypatch, params, n_frames, chunk):
    """x3a_to_wav's chunked stream on the card, through K3 and K1 with
    frames carried across chunks, gives the input, the CPU stream's WAV (at
    the default chunk) and the walker's (resync=True) byte for byte."""
    from x3_tpu_torch import files
    from x3_tpu_torch.ops import crc_cuda, decode_cuda

    src, x3a = _stream_archive(tmp_path, params, n_frames, 23)
    assert files.x3a_to_wav(x3a, tmp_path / "cpu.wav", batch_frames=3, device="cpu") == 0
    monkeypatch.setattr(files, "_CHUNK_BYTES", chunk)
    assert files.x3a_to_wav(x3a, tmp_path / "walk.wav", resync=True, device=cuda) == 0
    for mod in (crc_cuda, decode_cuda):
        mod.launch_count = 0
    assert files.x3a_to_wav(x3a, tmp_path / "gpu.wav", batch_frames=3, device=cuda) == 0
    assert crc_cuda.launch_count > 0 and decode_cuda.launch_count > 0
    want = src.read_bytes()
    for name in ("gpu", "cpu", "walk"):
        assert (tmp_path / f"{name}.wav").read_bytes() == want, name


def test_file_stream_payload_crc_error_on_cuda(cuda, tmp_path, monkeypatch):
    """A flipped payload byte several chunks in raises on the card with the
    CPU's message, which names the frame's global number."""
    from x3_tpu_torch import archive, files
    from x3_tpu_torch.errors import FrameHeaderInvalidPayloadCRC

    params = GEOMETRIES[0]
    _, x3a = _stream_archive(tmp_path, params, 9, 24)
    with open(x3a, "rb") as f:
        _, header_size = archive.read_archive_header_file(f)
    data = bytearray(x3a.read_bytes())
    offs, _, lens = archive.index_frames(bytes(data), header_size)
    data[int(offs[6] + lens[6] // 2)] ^= 0x08
    x3a.write_bytes(bytes(data))
    monkeypatch.setattr(files, "_CHUNK_BYTES", 200)
    msgs = []
    for dev in (cuda, "cpu"):
        with pytest.raises(FrameHeaderInvalidPayloadCRC) as e:
            files.x3a_to_wav(x3a, tmp_path / "out.wav", device=dev)
        msgs.append(str(e.value))
    assert msgs == ["frame 6 payload CRC mismatch"] * 2


def _signal(rng, n: int) -> np.ndarray:
    return _mixed(rng, n) if n >= 6 else rng.integers(-99, 99, n).astype(np.int16)


def test_batch_files_on_cuda_match_cpu(cuda, tmp_path):
    """wav_to_x3a_batch and x3a_to_wav_batch of five WAVs (one empty) on
    the card give the archives and WAVs of the same calls on the CPU, and
    the WAVs equal the inputs, through K1-K3."""
    from x3_tpu_torch import multifile
    from x3_tpu_torch.ops import crc_cuda, decode_cuda, encode_cuda
    from x3_tpu_torch.utils.wav import write_wav

    params = GEOMETRIES[0]
    S = params.samples_per_frame
    rng = np.random.default_rng(23)
    lengths = [7 * S + 5, 0, 1, 3 * S, 12 * S + 17]
    srcs = [tmp_path / f"in{k}.wav" for k in range(len(lengths))]
    for src, n in zip(srcs, lengths):
        write_wav(src, _signal(rng, n), 96000)
    out = {}
    for dev in ("cpu", cuda):
        for mod in (crc_cuda, decode_cuda, encode_cuda):
            mod.launch_count = 0
        tag = str(dev)
        x3as = [tmp_path / f"{tag}{k}.x3a" for k in range(len(srcs))]
        backs = [tmp_path / f"{tag}{k}.wav" for k in range(len(srcs))]
        res = multifile.wav_to_x3a_batch(srcs, x3as, params, 4, device=dev)
        assert multifile.x3a_to_wav_batch(x3as, backs, 4, device=dev) == lengths
        out[tag] = ([x.read_bytes() for x in x3as], [b.read_bytes() for b in backs],
                    [(r.nbytes, r.stats.tolist()) for r in res])
    assert out["cpu"] == out[str(cuda)]
    assert out["cpu"][1] == [s.read_bytes() for s in srcs]
    assert min(crc_cuda.launch_count, decode_cuda.launch_count, encode_cuda.launch_count) > 0


def test_x3m_on_cuda_matches_cpu(cuda, tmp_path):
    """wav_to_x3m and x3m_to_wav of a 3-channel capture on the card give
    the files of the same calls on the CPU and the input back."""
    from x3_tpu_torch import multichannel

    params = GEOMETRIES[0]
    rng = np.random.default_rng(24)
    n = 9 * params.samples_per_frame + 11
    src = tmp_path / "tri.wav"
    multichannel.write_wav_multichannel(src, np.stack([_signal(rng, n) for _ in range(3)]), 48000)
    got = {}
    for dev in ("cpu", cuda):
        d = tmp_path / str(dev).replace(":", "")
        d.mkdir()
        mpath = multichannel.wav_to_x3m(src, d / "tri", params, device=dev)
        assert multichannel.x3m_to_wav(mpath, d / "back.wav", batch_frames=4, device=dev) == 3
        got[str(dev)] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert got["cpu"] == got[str(cuda)]
    assert got["cpu"]["back.wav"] == src.read_bytes()


def _flip_payload_byte(path, frame: int) -> None:
    """A payload byte of `frame` of an archive, flipped: its CRC then fails."""
    from x3_tpu_torch import archive

    data = bytearray(path.read_bytes())
    _, hs = archive.parse_archive_header(bytes(data))
    ix = archive.index_frames_in_memory(bytes(data), hs)
    data[int(ix.offsets[frame]) + 1] ^= 0x10
    path.write_bytes(bytes(data))


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the class and message are what is compared
        return "raise", (type(e).__name__, str(e))


@pytest.mark.parametrize("damage", ["clean", "crc"])
def test_batch_decodes_on_cuda_match_cpu(cuda, tmp_path, damage):
    """x3a_to_wav_batch, decode_streams and x3m_to_wav on the card give
    what they give on the CPU: outputs, or the raised class and message and
    the WAVs written before it (a payload byte of archive 4's frame 9, and
    of channel 2's frame 5).  Each decode call launches K3 and K1 once
    (the CRC check fused into it)."""
    from x3_tpu_torch import multichannel, multifile
    from x3_tpu_torch.ops import crc_cuda, decode_cuda
    from x3_tpu_torch.utils.wav import write_wav

    params = GEOMETRIES[0]
    S = params.samples_per_frame
    rng = np.random.default_rng(25)
    lengths = [7 * S + 5, 0, 1, 3 * S, 12 * S + 17]
    srcs = [tmp_path / f"in{k}.wav" for k in range(len(lengths))]
    for src, n in zip(srcs, lengths):
        write_wav(src, _signal(rng, n), 96000)
    x3as = [tmp_path / f"a{k}.x3a" for k in range(len(srcs))]
    multifile.wav_to_x3a_batch(srcs, x3as, params, device="cpu")
    n = 9 * S + 11
    chans = np.stack([_signal(rng, n) for _ in range(3)])
    mpath = multichannel.encode_multichannel(chans, 48000, tmp_path / "tri", params, device="cpu")
    if damage == "crc":
        _flip_payload_byte(x3as[4], 9)
        _flip_payload_byte(tmp_path / "tri.ch2.x3a", 5)
    got = {}
    for dev in ("cpu", cuda):
        crc_cuda.launch_count = decode_cuda.launch_count = 0
        tag = str(dev).replace(":", "")
        backs = [tmp_path / f"{tag}{k}.wav" for k in range(len(srcs))]
        got[tag] = (
            _outcome(lambda: multifile.x3a_to_wav_batch(x3as, backs, 4, device=dev)),
            [b.read_bytes() if b.exists() else None for b in backs],
            _outcome(lambda: [x.tobytes() for x, _ in multifile.decode_streams(
                [p.read_bytes() for p in x3as], 4, device=dev)]),
            _outcome(lambda: multichannel.x3m_to_wav(mpath, tmp_path / f"{tag}.x3m.wav", batch_frames=4,
                                                     device=dev)),
            (tmp_path / f"{tag}.x3m.wav").read_bytes(),
        )
        if dev != "cpu":
            assert crc_cuda.launch_count == decode_cuda.launch_count > 0
    assert got["cpu"] == got["cuda"]
    if damage == "clean":
        assert got["cpu"][1] == [s.read_bytes() for s in srcs]
        assert got["cpu"][3] == ("ok", 3)
    else:
        assert got["cpu"][0] == ("raise", ("FrameHeaderInvalidPayloadCRC", "archive 4 frame 9 payload CRC mismatch"))
        assert got["cpu"][3] == ("raise", ("FrameHeaderInvalidPayloadCRC", "frame 5 payload CRC mismatch"))


def _cuda_meshes():
    """[cuda:0] * 2, and every visible card where there are two or more."""
    from x3_tpu_torch.parallel.mesh import make_mesh

    meshes = [make_mesh(["cuda:0"] * 2)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh())
    return meshes


@pytest.mark.parametrize("params", GEOMETRIES[:2], ids=["tiny", "default"])
def test_sharded_on_cuda_matches_unsharded(cuda, params):
    """encode_frames_sharded and decode_frames_sharded (K2 + K1, K3 on each
    shard) equal the unsharded calls on the card, key for key, and
    roundtrip_step is exact with the unsharded sizes."""
    from x3_tpu_torch.ops import crc_cuda, decode_cuda, encode_cuda
    from x3_tpu_torch.ops.decode_kernel import decode_frames
    from x3_tpu_torch.ops.encode_kernel import encode_frames
    from x3_tpu_torch.parallel.mesh import decode_frames_sharded, encode_frames_sharded, roundtrip_step

    frames, n_valid = _frames(np.random.default_rng(25), params, 16)
    st, nv = torch.from_numpy(frames).to(cuda), torch.from_numpy(n_valid).to(cuda)
    want = encode_frames(st, nv, params)
    words = want["payload_words"].cpu().numpy().view(np.uint32).byteswap().view(np.uint8).reshape(16, -1)
    buf = torch.from_numpy(words.copy()).to(cuda)
    want_dec = decode_frames(buf, nv, want["nbytes"], params)
    for mesh in _cuda_meshes():
        for mod in (crc_cuda, decode_cuda, encode_cuda):
            mod.launch_count = 0
        got = encode_frames_sharded(frames, n_valid, params, mesh)
        assert got.keys() == want.keys()
        _assert_all_equal(list(got.values()), list(want.values()), f"sharded encode on {mesh}")
        _assert_all_equal(decode_frames_sharded(buf, nv, want["nbytes"], params, mesh), want_dec,
                          f"sharded decode on {mesh}")
        nbytes, exact = roundtrip_step(params, mesh)(frames, n_valid)
        assert bool(exact) and torch.equal(nbytes.cpu(), want["nbytes"].cpu())
        assert min(crc_cuda.launch_count, decode_cuda.launch_count, encode_cuda.launch_count) >= mesh.size


def test_aot_compile_on_cuda(cuda):
    """aot_compile(768) builds the kernels and leaves encode and decode
    functions that run on the card and roundtrip."""
    from x3_tpu_torch.utils.profiling import aot_compile

    params = Parameters()
    S = params.samples_per_frame
    fns = aot_compile(768, params)
    frames = _mixed(np.random.default_rng(26), 768 * S).reshape(768, S)
    n_valid = np.full(768, S, np.int32)
    enc = fns["encode"](frames, n_valid)
    assert enc["nbytes"].is_cuda
    words = enc["payload_words"].cpu().numpy().view(np.uint32).byteswap().view(np.uint8).reshape(768, -1)
    out, err = fns["decode"](words, n_valid, enc["nbytes"].cpu().numpy())
    assert not err.any() and np.array_equal(out.cpu().numpy(), frames)


def test_fuzz_soak_on_cuda(cuda):
    """16 trials of the fuzz soak: K3 equals its plain version on every
    mutated lane, some lanes err, and K3 was launched."""
    from x3_tpu_torch.tools import fuzz_soak

    summary = fuzz_soak.soak(16, 7, device=cuda)
    assert summary["failures"] == 0 and summary["error_lanes"] > 0 and summary["launches"] >= 16
    assert fuzz_soak.verdict(summary, cuda, "fuzz soak") == 0


def test_fuzz_differential_on_cuda(cuda):
    """Nine trials, one a geometry (block_len 1 to 60, blocks_per_frame 5
    to 1,500, the n_blocks override of the reconstructed-params decode):
    the card's encode and decodes equal the CPU's plain versions and the
    input, and K2 and K3 were launched."""
    from x3_tpu_torch.tools import fuzz_differential

    lines = []
    summary = fuzz_differential.run_campaign(9, 7, ["cuda", "cpu"], log=lines.append)
    assert summary["failures"] == 0, lines
    assert summary["checked"] == 9 and min(summary["launches"]) > 0


def test_compile_sweep_on_cuda(cuda):
    """The cold build and every (kernel, rung) launch, in a process of its
    own (a process loads each kernel's library once)."""
    import subprocess
    import sys

    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-m", "x3_tpu_torch.tools.compile_sweep"], cwd=repo,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "all configurations build and launch cold" in out.stdout


def test_bench_on_cuda(cuda):
    """The port's bench on the card at a small geometry: every exactness key
    true, decode_parity_ok true (K3 against its plain version), the card's
    name and power limit, and K1-K3 launched."""
    from x3_tpu_torch import bench
    from x3_tpu_torch.ops import crc_cuda, decode_cuda, encode_cuda

    for mod in (crc_cuda, decode_cuda, encode_cuda):
        mod.launch_count = 0
    res = bench.run(cuda, GEOMETRIES[0], batch_frames=16, decode_batch=32, reps=2, e2e_reps=1, passes=1)
    assert bench.all_exact(res) and res["decode_parity_ok"] is True
    assert res["platform"] == "cuda" and res["device"]["power_limit_w"] > 0
    assert res["device"]["name"] and res["cuda"]
    assert min(mod.launch_count for mod in (crc_cuda, decode_cuda, encode_cuda)) > 0


@pytest.mark.parametrize("n_bytes", [1, 3, 4, 5, 131, 8190])
def test_crc16_padded_on_cuda(cuda, n_bytes):
    from x3_tpu_torch.ops.crc_torch import crc16_padded

    rng = np.random.default_rng(n_bytes)
    lens = rng.integers(0, n_bytes + 1, 37).astype(np.int32)
    lens[:3] = 0, 1, n_bytes
    rows = rng.integers(0, 256, (37, n_bytes), dtype=np.uint8)
    rows[np.arange(n_bytes)[None, :] >= lens[:, None]] = 0
    rows_t, lens_t = torch.from_numpy(rows), torch.from_numpy(lens)
    got = crc16_padded(rows_t.to(cuda), lens_t.to(cuda), n_bytes)
    assert got.is_cuda and torch.equal(got.cpu(), crc16_padded(rows_t, lens_t, n_bytes))


def _noise_frames(amps, spf: int, seed: int, tail: int = 0) -> np.ndarray:
    """Frames of uniform noise of the given amplitudes, the last cut short."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.integers(-a, a, spf).astype(np.int16) for a in amps])
    return x[: len(x) - tail]


# Three width rungs (512, 1024, 1128) and four block-width rungs: noise of
# amplitude 16 fits W=512, 256 needs 1024 and full scale the worst case.
ESC = Parameters(block_len=20, blocks_per_frame=110)
ESC_AMPS = [16, 16, 16, 256, 16, 32767, 256, 16, 16, 16, 16]


def test_pipelined_encode_on_cuda_matches_cpu(cuda):
    """The one-batch-ahead encode and worklist on the card, across
    escalations (batch i + 1 in flight at the old rungs), give the CPU's
    bytes, stats and rungs; the checked decode of them, per frame and
    compacted, gives the input back."""
    import x3_tpu_torch as xt
    from x3_tpu_torch import multifile
    from x3_tpu_torch.models.decoder import decode_frames_flat

    wav = _noise_frames(ESC_AMPS, ESC.samples_per_frame, 5, tail=333)
    for batch in (1, 2, 3):
        got = xt.encode(wav, ESC, batch_frames=batch, device=cuda)
        want = xt.encode(wav, ESC, batch_frames=batch, device="cpu")
        assert got.data == want.data and np.array_equal(got.stats, want.stats)
        assert (got.width_used, got.block_width_used) == (want.width_used, want.block_width_used)
    streams = [wav[:5000], wav[5000:9000], np.zeros(0, np.int16), wav[9000:]]
    got = multifile.encode_streams(streams, ESC, 2, device=cuda)
    want = multifile.encode_streams(streams, ESC, 2, device="cpu")
    assert [(r.data, r.stats.tolist()) for r in got] == [(r.data, r.stats.tolist()) for r in want]
    res = xt.encode(wav, ESC, batch_frames=3, device=cuda)
    payloads, counts, crcs, off = [], [], [], 0
    while off < len(res.data):
        h = res.data[off : off + 20]
        plen = int.from_bytes(h[6:8], "big")
        counts.append(int.from_bytes(h[4:6], "big"))
        crcs.append(int.from_bytes(h[18:20], "big"))
        payloads.append(res.data[off + 20 : off + 20 + plen])
        off += 20 + plen
    outs, err, ok = xt.decode_frames_batch(payloads, counts, ESC, check_crcs=crcs, device=cuda)
    flat, err2, ok2 = decode_frames_flat(payloads, counts, ESC, check_crcs=crcs, device=cuda)
    assert not err.any() and ok.all() and np.array_equal(err, err2) and np.array_equal(ok, ok2)
    np.testing.assert_array_equal(np.concatenate(outs), wav)
    np.testing.assert_array_equal(flat, wav)


def test_submit_and_upload_never_block(cuda):
    """submit (staging copy, K2 + K1, the read-back of the sizes) and the
    decode's upload, walk and compaction enqueue without one host-device
    synchronisation: under set_sync_debug_mode("error") a blocking copy or
    read raises."""
    from x3_tpu_torch.models import decoder, encoder
    from x3_tpu_torch.models.sharding import Mesh, shard_map
    from x3_tpu_torch.models.staging import StagingPool
    from x3_tpu_torch.ops.decode_kernel import decode_words_checked

    params = Parameters()
    S = params.samples_per_frame
    wav = _mixed(np.random.default_rng(9), 16 * S)
    want = encoder.encode(wav, params, batch_frames=16, device="cpu")  # CPU reference
    encoder.encode(wav, params, batch_frames=16, device=cuda)  # builds and tables first
    buf = StagingPool(1, 16, S, cuda).acquire()
    buf.samples.numpy()[:] = wav.reshape(16, S)
    buf.n_valid.numpy()[:] = S
    payloads, counts = [], []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sub = encoder.submit(buf.samples, buf.n_valid, params, 2, 1, Mesh([cuda]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    done = encoder.finish(sub, 2, 1)
    assert done.frames.tobytes() == want.data
    off = 0
    for i in range(16):
        n = int(done.nbytes[i])
        payloads.append(want.data[off + 20 : off + 20 + n])
        counts.append(S)
        off += 20 + n
    decoder.decode_frames_flat(payloads, counts, params, device=cuda)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        words, ns, plens, n_blocks = decoder.upload_span(*decoder._join(payloads, cuda), counts, params, cuda)
        out, err, crc = shard_map(lambda w, n, pl: decode_words_checked(w, n, pl, params, n_blocks),
                                  Mesh([cuda]), words, ns, plens)
        flat = decoder.compact_frames(out, ns[:16], 16 * S)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(flat.cpu().numpy(), wav)


def test_staging_reuse_stress(cuda):
    """Eight full-size batches through two staging buffers (encode) and
    three (the worklist): the host refills a buffer as soon as the encode
    loop gives it back, so a refill before its copy had run would corrupt the
    batch before; every batch's frames must equal the CPU's."""
    import x3_tpu_torch as xt
    from x3_tpu_torch import multifile

    params = Parameters()
    S = params.samples_per_frame
    rng = np.random.default_rng(17)
    # Each batch of 32 frames its own signal, so a batch that read another's
    # staging would show.
    wav = np.concatenate([_mixed(rng, 32 * S) // (1 + b) for b in range(8)]).astype(np.int16)
    got = xt.encode(wav, params, batch_frames=32, device=cuda)
    want = xt.encode(wav, params, batch_frames=32, device="cpu")
    assert got.data == want.data and np.array_equal(got.stats, want.stats)
    streams = [wav[: 100 * S + 7], wav[100 * S + 7 :]]
    got = multifile.encode_streams(streams, params, 32, device=cuda)
    assert b"".join(r.data for r in got) == b"".join(
        r.data for r in multifile.encode_streams(streams, params, 32, device="cpu"))


def test_decode_spans_on_cuda(cuda):
    """decode_streams on the card under torch.profiler: the spans of the
    calling thread, put on the profiler's clock, start beside their
    record_function events (the closest pair within 20 us, half within
    100 us; the rest is the interpreter's lock changing hands between the
    two reads, with the read-ahead thread running); the launches count
    their H2D bytes and the read-back waits their D2H bytes (the decoded
    samples at least)."""
    import threading
    import time

    import x3_tpu_torch as xt
    from x3_tpu_torch import multifile
    from x3_tpu_torch.utils import profiling

    params = Parameters()
    rng = np.random.default_rng(5)
    full = _mixed(rng, 3 * params.samples_per_frame + 11)
    xs = [full, full[:1], full[:0]]
    head = xt.build_archive_header(96000, params)
    arcs = [head + xt.encode(x, params, device=cuda).data for x in xs]
    multifile.decode_streams(arcs, batch_frames=2, device=cuda)  # warm
    t0 = time.perf_counter_ns()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    try:
        out = multifile.decode_streams(arcs, batch_frames=2, device=cuda)
    finally:
        prof.stop()
    for (got, _), x in zip(out, xs):
        np.testing.assert_array_equal(got, x)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("x3."):
            events.setdefault(e.name(), []).append(e.start_ns())
    me = threading.get_ident()
    log = [s for s in profiling.spans(t0) if s.start_ns >= t0]
    mine = [s for s in log if s.thread == me]
    assert {s.name for s in mine} >= {"x3.decode_streams", "x3.decode.launch", "x3.device_wait"}
    gaps = sorted(min(abs(profiling.profiler_ns(s.start_ns) - e) for e in events[s.name]) for s in mine)
    assert gaps[0] < 20_000 and gaps[len(gaps) // 2] < 100_000, gaps
    counts = {}
    for s in log:
        for k, v in s.counts.items():
            counts[k] = counts.get(k, 0) + v
    assert counts["h2d_bytes"] >= sum(len(a) - len(head) for a in arcs) * 0.9
    assert counts["d2h_bytes"] >= 2 * sum(len(x) for x in xs)


def test_scatter_worker_on_cuda(cuda):
    """An EH120-sized decode_streams on the card (36,000,000 samples, 3,600
    frames of the default Parameters, five batches of 768): every sample
    equal to the input, which the CPU path decodes bit for bit, and a
    three-archive call of three batches equal to the CPU path's; the
    batches' copies run on one scatter worker, and the caller's waits on
    it (x3.scatter_wait) total less than the copies (x3.decode.scatter)."""
    import threading
    import time

    import x3_tpu_torch as xt
    from x3_tpu_torch import multifile
    from x3_tpu_torch.utils import profiling

    params = Parameters()
    S = params.samples_per_frame
    head = xt.build_archive_header(96000, params)
    rng = np.random.default_rng(21)
    full = _mixed(rng, 5 * S + 11)
    small = [full[: 3 * S + 11], full[:1], full[3 * S + 11 :]]
    arcs = [head + xt.encode(x, params, device=cuda).data for x in small]
    got = multifile.decode_streams(arcs, batch_frames=2, device=cuda)
    want = multifile.decode_streams(arcs, batch_frames=2, device="cpu")
    assert [(g.tobytes(), r) for g, r in got] == [(w.tobytes(), r) for w, r in want]

    x = _mixed(rng, 3600 * S)
    arc = head + xt.encode(x, params, device=cuda).data
    multifile.decode_streams([arc], device=cuda)  # warm
    threads = threading.active_count()
    t0 = time.perf_counter_ns()
    (out, rate), = multifile.decode_streams([arc], device=cuda)
    assert threading.active_count() == threads
    assert rate == 96000 and np.array_equal(out, x)
    me = threading.get_ident()
    log = [s for s in profiling.spans(t0) if s.start_ns >= t0]
    root, = [s for s in log if s.name == "x3.decode_streams" and s.thread == me]
    mine = [s for s in log if s.call == root.id]
    copies = [s for s in mine if s.name == "x3.decode.scatter" and s.counts["bytes"]]
    waits = [s for s in mine if s.name == "x3.scatter_wait"]
    assert len(copies) == 5 and len({s.thread for s in copies}) == 1 and copies[0].thread != me
    assert sum(s.counts["bytes"] for s in copies) == out.nbytes
    assert waits and all(s.thread == me for s in waits)
    scatter_ns = sum(s.end_ns - s.start_ns for s in mine if s.name == "x3.decode.scatter")
    assert sum(s.end_ns - s.start_ns for s in waits) < scatter_ns


def test_output_pool_on_cuda(cuda, monkeypatch):
    """An EH120-sized decode_streams (3,600 frames, five batches) three
    times on the card, each output dropped before the next call: the first
    maps a 72 MB block, the second and third get it back (reused_bytes
    their bytes), and each equals the input.  A view held across a call
    keeps its values, and that call maps a block of its own."""
    import threading
    import time

    import x3_tpu_torch as xt
    from x3_tpu_torch import multifile
    from x3_tpu_torch.utils import outpool, profiling

    monkeypatch.setattr(outpool, "POOL", outpool.OutputPool())
    params = Parameters()
    x = _mixed(np.random.default_rng(24), 3600 * params.samples_per_frame)
    arc = xt.build_archive_header(96000, params) + xt.encode(x, params, device=cuda).data
    counts, me = [], threading.get_ident()

    def call():
        t0 = time.perf_counter_ns()
        (out, rate), = multifile.decode_streams([arc], device=cuda)
        alloc, = [s for s in profiling.spans(t0) if s.start_ns >= t0 and s.thread == me and "pooled_bytes" in s.counts]
        counts.append((alloc.counts["pooled_bytes"], alloc.counts["reused_bytes"]))
        assert rate == 96000
        return out

    for _ in range(3):
        out = call()
        assert np.array_equal(out, x)
        del out
    assert counts == [(x.nbytes, 0), (x.nbytes, x.nbytes), (x.nbytes, x.nbytes)]
    held = call()[1::2]  # the output itself is dropped here
    kept = held.copy()
    out = call()
    assert counts[3:] == [(x.nbytes, x.nbytes), (x.nbytes, 0)]
    assert not np.shares_memory(out, held) and np.array_equal(held, kept) and np.array_equal(out, x)

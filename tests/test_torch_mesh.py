"""The port's device mesh on the CPU (x3_tpu_torch.parallel.mesh and
multihost.local_mesh): meshes of repeated CPU entries against x3_tpu's
mesh of 8 virtual CPU devices (JAX on the CPU), and against the port's own
unsharded calls.  Every comparison is exact."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT, make_hydrophone, make_mixed
from tests.test_torch_files import port_params, write_wav
from x3_tpu.params import Parameters

TINY = Parameters(block_len=4, blocks_per_frame=8)
P = Parameters()
MID = Parameters(block_len=20, blocks_per_frame=60)  # two width rungs: 512 and the worst case
CPU = torch.device("cpu")


def _mesh(n: int):
    from x3_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([CPU] * n)


def _frames(params, F: int, seed: int, noise_last: bool = False):
    """[F, S] mixed-signal frames, the last one partial (zero past its
    length) or, with noise_last, full-scale white noise."""
    rng = np.random.default_rng(seed)
    S = params.samples_per_frame
    wavs = np.stack([make_mixed(rng, S) for _ in range(F)]).astype(np.int16)
    n = np.full(F, S, np.int32)
    if noise_last:
        wavs[-1] = rng.integers(-32768, 32768, S)
    else:
        n[-1] = S - 7
        wavs[-1, n[-1]:] = 0
    return wavs, n


def _payload_bytes(words) -> np.ndarray:
    """Big-endian bytes of payload words (a port tensor of int32 bit
    patterns or an x3_tpu uint32 array)."""
    w = words.numpy() if isinstance(words, torch.Tensor) else np.asarray(words)
    return np.ascontiguousarray(w).view(np.uint32).byteswap().view(np.uint8).reshape(len(w), -1)


def _mutate(buf: np.ndarray, plens: np.ndarray, n: np.ndarray, seed: int):
    """Copies of a decode batch with byte flips, truncated lengths and a
    lane of random bytes that claims a full frame."""
    rng = np.random.default_rng(seed)
    buf, plens, n = buf.copy(), plens.copy(), n.copy()
    F = len(buf)
    for f in range(0, F, 3):
        buf[f, rng.integers(0, max(1, plens[f]), 2)] ^= rng.integers(1, 256, 2).astype(np.uint8)
    for f in range(1, F, 4):
        plens[f] = rng.integers(0, plens[f] + 1)
    buf[-2] = rng.integers(0, 256, buf.shape[1]).astype(np.uint8)
    plens[-2], n[-2] = buf.shape[1], n.max()
    return buf, plens, n


def _same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        got, want = list(got.values()), list(want.values())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- the mesh itself ----


def test_make_mesh_like_x3_tpu():
    import jax

    from x3_tpu.parallel import mesh as ref

    from x3_tpu_torch.parallel import mesh as port

    want = ref.make_mesh()
    got = port.make_mesh([CPU] * 8)
    assert got.size == want.size == len(jax.devices()) == 8
    assert port.AXIS == ref.AXIS and got.axis_name == want.axis_names[0]
    assert got.devices == (CPU,) * 8 and got.device_type == "cpu"
    assert port.make_mesh(["cpu", "cpu"], "x").axis_name == "x"


def test_local_mesh_and_defaults():
    """A CPU mesh is built only when asked for; a CUDA mesh without a card
    raises; a mesh of no device or of mixed types is refused."""
    from x3_tpu_torch.parallel import mesh as port
    from x3_tpu_torch.parallel.multihost import local_mesh

    assert not torch.cuda.is_available()
    for m in (local_mesh(device="cpu"), port.make_mesh(device="cpu")):
        assert m.devices == (CPU,) and m.axis_name == "frames" and m.size == 1
    assert local_mesh("rows", device="cpu").axis_name == "rows"
    for fn in (local_mesh, port.make_mesh, lambda: port.make_mesh(["cuda:0"]), lambda: port.make_mesh(["cpu", "cuda"])):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()
    with pytest.raises(ValueError, match="at least one"):
        port.make_mesh([])


def _cuda_mesh_unchecked():
    """A mesh object naming cuda:0, built without asking for a card (the
    check a batch call makes on the mesh's type is what is tested)."""
    from x3_tpu_torch.parallel.mesh import Mesh

    m = Mesh.__new__(Mesh)
    m.devices, m.axis_name = (torch.device("cuda", 0),), "frames"
    return m


def test_a_mesh_of_another_device_type_raises(tmp_path):
    from x3_tpu_torch import multifile
    from x3_tpu_torch.parallel.mesh import check_mesh

    m = _cuda_mesh_unchecked()
    with pytest.raises(ValueError, match="device type"):
        check_mesh(m, "cpu")
    src = write_wav(tmp_path / "in.wav", make_hydrophone(np.random.default_rng(1), 100))
    with pytest.raises(ValueError, match="device type"):
        multifile.wav_to_x3a_batch([src], [tmp_path / "out.x3a"], mesh=m, device="cpu")
    assert not (tmp_path / "out.x3a").exists()
    two = _mesh(2)
    assert check_mesh(two, "cpu") is two and check_mesh(None, "cpu").devices == (CPU,)


# ---- sharded encode and decode against x3_tpu's ----


@pytest.mark.parametrize("params,F", [(TINY, 16), (P, 8)], ids=["tiny", "default"])
def test_encode_frames_sharded_like_x3_tpu(params, F):
    """An 8-entry CPU mesh against x3_tpu's 8-device mesh, with a partial
    tail frame: sizes, CRCs, statistics, bit counts and the payload bytes
    up to each frame's size; and every key equal to the port's unsharded
    encode."""
    from x3_tpu.parallel import mesh as ref

    from x3_tpu_torch.ops.encode_kernel import encode_frames
    from x3_tpu_torch.parallel import mesh as port

    wavs, n = _frames(params, F, seed=F)
    want = ref.encode_frames_sharded(wavs, n, params, ref.make_mesh())
    got = port.encode_frames_sharded(wavs, n, port_params(params), _mesh(8))
    for key in ("nbytes", "crc", "stats", "total_bits", "blockfit_bits"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    nbytes = got["nbytes"].numpy()
    gb, wb = _payload_bytes(got["payload_words"]), _payload_bytes(want["payload_words"])
    assert gb.shape == wb.shape
    for i in range(F):
        assert gb[i, : nbytes[i]].tobytes() == wb[i, : nbytes[i]].tobytes(), i
    _same(got, encode_frames(torch.from_numpy(wavs), torch.from_numpy(n), port_params(params)))


@pytest.mark.parametrize("case", ["tiny-clean", "tiny-mutated", "default-clean"])
def test_decode_frames_sharded_like_x3_tpu(case):
    """(samples, err) of the sharded decode equal x3_tpu's on its 8-device
    mesh, clean and on mutated payloads (the garbage on error lanes
    included); at the default geometry on a 2-entry mesh (the plain walk
    costs seconds a shard here)."""
    from x3_tpu.ops.encode_kernel import width_rungs
    from x3_tpu.parallel import mesh as ref

    from x3_tpu_torch.ops.decode_kernel import decode_frames, decode_frames_checked
    from x3_tpu_torch.ops.encode_kernel import encode_frames
    from x3_tpu_torch.parallel import mesh as port
    from x3_tpu_torch.parallel.mesh import shard_map

    params, F, entries = (TINY, 16, 8) if case.startswith("tiny") else (P, 8, 2)
    pp = port_params(params)
    wavs, n = _frames(params, F, seed=3)
    enc = encode_frames(torch.from_numpy(wavs), torch.from_numpy(n), pp)
    plens = enc["nbytes"].numpy()
    W = next(r for r in width_rungs(params) if plens.max() <= r * 4)
    buf = np.ascontiguousarray(_payload_bytes(enc["payload_words"])[:, : 4 * W])
    if case.endswith("mutated"):
        buf, plens, n = _mutate(buf, plens, n, seed=4)
    want = ref.decode_frames_sharded(buf, n, plens, params, ref.make_mesh())
    got = port.decode_frames_sharded(buf, n, plens, pp, _mesh(entries))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if case.endswith("mutated"):
        assert got[1].any()
    else:
        assert not got[1].any()
    if case.startswith("tiny"):
        args = [torch.from_numpy(a) for a in (buf, n, plens)]
        _same(got, decode_frames(*args, pp))
        _same(shard_map(lambda *a: decode_frames_checked(*a, pp), _mesh(entries), buf, n, plens),
              decode_frames_checked(*args, pp))


def test_roundtrip_step_like_x3_tpu():
    from x3_tpu.parallel import mesh as ref

    from x3_tpu_torch.parallel import mesh as port

    wavs, n = _frames(TINY, 16, seed=5)
    want_nbytes, want_exact = ref.roundtrip_step(TINY, ref.make_mesh())(wavs, n)
    nbytes, exact = port.roundtrip_step(port_params(TINY), _mesh(8))(wavs, n)
    assert bool(want_exact) and exact.dtype == torch.bool and exact.dim() == 0 and bool(exact)
    np.testing.assert_array_equal(nbytes.numpy(), np.asarray(want_nbytes))


@pytest.mark.parametrize("fault", ["sample", "error"])
def test_roundtrip_step_verdict_false_when_one_shard_decodes_wrong(monkeypatch, fault):
    """One shard's decode (the third of four) gives a wrong sample, or an
    error code on a lane: the gathered verdict is false, and the sizes
    stay those of the clean step."""
    from x3_tpu_torch.ops import decode_kernel
    from x3_tpu_torch.parallel import mesh as port

    wavs, n = _frames(TINY, 16, seed=6)
    pp = port_params(TINY)
    clean_nbytes, clean = port.roundtrip_step(pp, _mesh(4))(wavs, n)
    assert bool(clean)
    real, calls = decode_kernel.decode_frames, []

    def faulty(*args, **kw):
        out, err = real(*args, **kw)
        calls.append(1)
        if len(calls) == 3:
            if fault == "sample":
                out = out.clone()
                out[0, 1] += 1
            else:
                err = err.clone()
                err[-1] = 2
        return out, err

    monkeypatch.setattr(decode_kernel, "decode_frames", faulty)
    nbytes, exact = port.roundtrip_step(pp, _mesh(4))(wavs, n)
    assert len(calls) == 4 and not bool(exact)
    assert torch.equal(nbytes, clean_nbytes)


@pytest.mark.parametrize("entries", [1, 2, 4, 8])
def test_mesh_sizes_agree(entries):
    """Meshes of 1, 2, 4 and 8 entries give the unsharded results: encode
    and decode at the tiny geometry; and at a geometry of two width rungs,
    a batch whose last shard holds a noise frame escalates every shard to
    the same rung, as the unsharded batch does, with the same bytes."""
    from x3_tpu_torch import multifile
    from x3_tpu_torch.models.encoder import encode_batch
    from x3_tpu_torch.ops.decode_kernel import decode_frames
    from x3_tpu_torch.ops.encode_kernel import encode_frames
    from x3_tpu_torch.parallel import mesh as port

    mesh = _mesh(entries)
    pp = port_params(TINY)
    wavs, n = _frames(TINY, 16, seed=7)
    enc = port.encode_frames_sharded(wavs, n, pp, mesh)
    _same(enc, encode_frames(torch.from_numpy(wavs), torch.from_numpy(n), pp))
    buf = _payload_bytes(enc["payload_words"])
    _same(port.decode_frames_sharded(buf, n, enc["nbytes"], pp, mesh),
          decode_frames(torch.from_numpy(buf), torch.from_numpy(n), enc["nbytes"], pp))

    mid = port_params(MID)
    wavs, n = _frames(MID, 8, seed=8, noise_last=True)
    want = encode_batch(torch.from_numpy(wavs), torch.from_numpy(n), mid, 0, 0)
    got = encode_batch(torch.from_numpy(wavs), torch.from_numpy(n), mid, 0, 0, mesh)
    assert want[4] == got[4] == 1  # escalated from the 512-word rung
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    streams = [wavs[:6].reshape(-1)[: 5 * MID.samples_per_frame + 9], wavs[7], wavs[3], np.zeros(0, np.int16)]
    got = multifile.encode_streams(streams, mid, 3, mesh=mesh, device="cpu")
    want = multifile.encode_streams(streams, mid, 3, device="cpu")
    assert [(r.data, r.stats.tolist()) for r in got] == [(r.data, r.stats.tolist()) for r in want]


def test_frames_not_a_multiple_of_the_mesh_raise():
    from x3_tpu_torch.parallel import mesh as port

    pp = port_params(TINY)
    wavs, n = _frames(TINY, 6, seed=9)
    mesh = _mesh(4)
    with pytest.raises(ValueError, match="mesh of 4"):
        port.encode_frames_sharded(wavs, n, pp, mesh)
    with pytest.raises(ValueError, match="mesh of 4"):
        port.decode_frames_sharded(np.zeros((6, 96), np.uint8), n, n, pp, mesh)
    with pytest.raises(ValueError, match="mesh of 4"):
        port.roundtrip_step(pp, mesh)(wavs, n)


# ---- two processes, each with its own local mesh ----

WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import torch.distributed as dist
    rank, world, port, base, n_files = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}", world_size=world, rank=rank)
    from x3_tpu_torch.multifile import wav_to_x3a_batch
    from x3_tpu_torch.parallel.multihost import local_mesh, shard_worklist
    from x3_tpu_torch.params import Parameters
    pairs = shard_worklist([(f"{{base}}/in{{i}}.wav", f"{{base}}/dist{{i}}.x3a") for i in range(n_files)])
    wav_to_x3a_batch([w for w, _ in pairs], [o for _, o in pairs], Parameters(block_len=4, blocks_per_frame=8),
                     batch_frames=5, mesh=local_mesh(device="cpu"), device="cpu")
    print(f"rank {{dist.get_rank()}}/{{dist.get_world_size()}}: {{len(pairs)}} files", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    """
)


def test_two_process_gloo_batch_conversion(tmp_path):
    """Two torch.distributed (gloo) processes each take their worklist shard
    (shard_worklist from the group's rank and size) and convert it with
    mesh=local_mesh(device="cpu"): the archives equal one process's
    unsharded conversion and x3_tpu's."""
    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile

    rng = np.random.default_rng(10)
    n_files = 5
    srcs = [write_wav(tmp_path / f"in{i}.wav", make_hydrophone(rng, 33 * (3 + 2 * i) + i), 44100)
            for i in range(n_files)]
    multifile.wav_to_x3a_batch(srcs, [tmp_path / f"one{i}.x3a" for i in range(n_files)], port_params(TINY),
                               5, device="cpu")
    ref.wav_to_x3a_batch(srcs, [tmp_path / f"ref{i}.x3a" for i in range(n_files)], TINY, 5)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = WORKER.format(repo=str(REPO_ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(rank), "2", str(port), str(tmp_path),
                               str(n_files)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
    assert sorted(o.strip() for o, _ in outs) == ["rank 0/2: 3 files", "rank 1/2: 2 files"]
    for i in range(n_files):
        got = (tmp_path / f"dist{i}.x3a").read_bytes()
        assert got == (tmp_path / f"one{i}.x3a").read_bytes() == (tmp_path / f"ref{i}.x3a").read_bytes(), i

"""The port's whole slice on the CPU: x3_tpu_torch.encode and
decode_frames_batch against x3_tpu's engines, the no-jax rule, and the
no-GPU behaviour of device="cuda" and chip_smoke.py."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.conftest import make_hydrophone, make_mixed
from x3_tpu.params import Parameters

REPO = Path(__file__).resolve().parent.parent
TINY = Parameters(block_len=4, blocks_per_frame=8)


def _frames_of(blob: bytes):
    payloads, counts, crcs, off = [], [], [], 0
    while off < len(blob):
        h = blob[off : off + 20]
        plen = int.from_bytes(h[6:8], "big")
        counts.append(int.from_bytes(h[4:6], "big"))
        crcs.append(int.from_bytes(h[18:20], "big"))
        payloads.append(blob[off + 20 : off + 20 + plen])
        off += 20 + plen
    return payloads, counts, crcs


CASES = [
    ("tiny-mixed", TINY, lambda rng: make_mixed(rng, 32 * 40 + 7), 8),
    ("tiny-one-sample", TINY, lambda rng: np.asarray([-1234], np.int16), 8),
    ("tiny-exact-frames", TINY, lambda rng: make_mixed(rng, 32 * 9), 4),
    ("default-hydrophone", Parameters(), lambda rng: make_hydrophone(rng, 10000 * 2 + 333), 2),
    ("default-mixed", Parameters(), lambda rng: make_mixed(rng, 10000 * 3), 2),
]


@pytest.mark.parametrize("name,params,make,batch", CASES, ids=[c[0] for c in CASES])
def test_encode_byte_identical_to_x3_tpu(name, params, make, batch):
    import x3_tpu

    import x3_tpu_torch

    wav = make(np.random.default_rng(len(name)))
    got = x3_tpu_torch.encode(wav, params, batch_frames=batch, device="cpu")
    for engine in ("jax", "numpy"):
        want = x3_tpu.encode(wav, params, engine=engine, batch_frames=batch)
        assert got.data == want.data, engine
        np.testing.assert_array_equal(got.stats, want.stats)
    # The port escalates to the first rung that fits every batch; the JAX
    # package may end one rung higher (it checks a batch after enqueueing
    # the next one at the old rung).
    from x3_tpu_torch.ops.encode_kernel import fits_width, width_rungs

    ref = x3_tpu.encode(wav, params, engine="jax", batch_frames=batch)
    lens = [len(p) for p in _frames_of(got.data)[0]]
    assert got.width_used == next(r for r in width_rungs(params) if fits_width(lens, r, params))
    assert got.width_used <= ref.width_used and got.block_width_used <= ref.block_width_used


def test_encode_width_hints_and_empty():
    import x3_tpu

    import x3_tpu_torch

    wav = make_mixed(np.random.default_rng(4), 32 * 12)
    for hint in (None, 1, 16, 10**6):
        got = x3_tpu_torch.encode(wav, TINY, batch_frames=5, width_hint=hint, block_width_hint=hint,
                                  device="cpu")
        want = x3_tpu.encode(wav, TINY, engine="jax", batch_frames=5, width_hint=hint,
                             block_width_hint=hint)
        assert got.data == want.data
        assert (got.width_used, got.block_width_used) == (want.width_used, want.block_width_used)
    empty = x3_tpu_torch.encode(np.zeros(0, np.int16), TINY, device="cpu")
    assert empty.data == b"" and not empty.stats.any()


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupt"])
def test_decode_frames_batch_matches_x3_tpu(corrupt):
    from x3_tpu.models.decoder import decode_frames_batch as ref

    import x3_tpu_torch

    rng = np.random.default_rng(12 + corrupt)
    wav = make_mixed(rng, 32 * 11 + 5)
    payloads, counts, crcs = _frames_of(x3_tpu_torch.encode(wav, TINY, device="cpu").data)
    if corrupt:
        payloads = [
            bytes(b ^ 0x5A if i == 3 else b for i, b in enumerate(p)) if k % 2 else p
            for k, p in enumerate(payloads)
        ]
        counts[2] = 70  # larger than the params geometry: n_blocks override
    got = x3_tpu_torch.decode_frames_batch(payloads, counts, TINY, check_crcs=crcs, device="cpu")
    want = ref(payloads, counts, TINY, check_crcs=crcs)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    if not corrupt:
        assert not got[1].any() and got[2].all()
        np.testing.assert_array_equal(np.concatenate(got[0]), wav)
    else:
        assert not got[2].all()
    plain = x3_tpu_torch.decode_frames_batch(payloads, counts, TINY, device="cpu")
    assert len(plain) == 2
    np.testing.assert_array_equal(plain[1], got[1])


def test_decode_frame_and_errors():
    import x3_tpu
    from x3_tpu.errors import X3Error

    import x3_tpu_torch

    wav = make_mixed(np.random.default_rng(8), 32)
    payloads, counts, _ = _frames_of(x3_tpu_torch.encode(wav, TINY, device="cpu").data)
    out = x3_tpu_torch.decode_frame(payloads[0], TINY, counts[0], device="cpu")
    np.testing.assert_array_equal(out, wav[: counts[0]])
    bad = bytes([0x00, 0x00, 0x03]) + bytes(40)  # BFP header with num_bits 1
    with pytest.raises(X3Error) as got:
        x3_tpu_torch.decode_frame(bad, TINY, 32, device="cpu")
    with pytest.raises(X3Error) as want:
        x3_tpu.decode_frame(bad, TINY, 32)
    assert type(got.value) is type(want.value)
    assert x3_tpu_torch.decode_frames_batch([], [], TINY, device="cpu")[0] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = sorted((REPO / "x3_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    jax_free = {
        "x3_tpu", "x3_tpu.params", "x3_tpu.constants", "x3_tpu.errors", "x3_tpu.archive",
        "x3_tpu.models.oracle", "x3_tpu.models.encoder", "x3_tpu.ops.crc", "x3_tpu.ops.crc_jax",
    }
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib"), f"{path}: imports {mod}"
            if mod.startswith("x3_tpu.") or mod == "x3_tpu":
                assert mod in jax_free, f"{path}: imports {mod}, which may import jax"
    assert not [m for m in _imports(REPO / "chip_smoke.py") if m.split(".")[0] == "x3_tpu"]


def test_cpu_slice_runs_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "import numpy as np, x3_tpu_torch as xt\n"
        "p = xt.Parameters(block_len=4, blocks_per_frame=8)\n"
        "wav = (np.arange(32 * 5 + 3) % 97 - 40).astype(np.int16)\n"
        "res = xt.encode(wav, p, device='cpu')\n"
        "assert res.data == xt.oracle.encode(wav, p)\n"
        "data, pays, cnts, crcs, off = res.data, [], [], [], 0\n"
        "while off < len(data):\n"
        "    h = data[off:off + 20]; n = int.from_bytes(h[6:8], 'big')\n"
        "    cnts.append(int.from_bytes(h[4:6], 'big')); crcs.append(int.from_bytes(h[18:20], 'big'))\n"
        "    pays.append(data[off + 20:off + 20 + n]); off += 20 + n\n"
        "outs, err, ok = xt.decode_frames_batch(pays, cnts, p, check_crcs=crcs, device='cpu')\n"
        "assert not err.any() and ok.all() and (np.concatenate(outs) == wav).all()\n"
        "import chip_smoke\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib') and sys.modules[m]]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")


def test_cuda_device_raises_without_gpu(no_gpu):
    import x3_tpu_torch
    from x3_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        x3_tpu_torch.encode(np.zeros(10, np.int16), TINY)
    with pytest.raises(RuntimeError):
        x3_tpu_torch.decode_frames_batch([b"\x00\x00"], [1], TINY)
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    from x3_tpu_torch.ops.crc_cuda import crc16_words_cuda
    from x3_tpu_torch.ops.decode_cuda import decode_words_cuda
    from x3_tpu_torch.ops.encode_cuda import encode_words_cuda

    z = torch.zeros((2, 32), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        crc16_words_cuda(z, n, 32)
    with pytest.raises(ValueError):
        encode_words_cuda(z.to(torch.int16), n, TINY, 24)
    with pytest.raises(ValueError):
        decode_words_cuda(z, n, n, TINY)


def test_chip_smoke_fails_without_gpu(no_gpu, tmp_path):
    """No GPU: non-zero exit and no result line, in the repository and in a
    directory holding chip_smoke.py alone."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_payload_batch_is_the_decode_batch():
    """decode_frames_batch's host buffer: payloads zero-padded to the
    decode_geometry width, lanes padded to a power of two with n = 0."""
    from x3_tpu_torch.models.decoder import decode_geometry, payload_batch

    payloads = [bytes(range(3 * k, 7 * k)) for k in range(5)]
    counts = [32, 32, 70, 1, 0]
    buf, ns, plens, n_blocks = payload_batch(payloads, counts, TINY)
    lens = [len(p) for p in payloads]
    assert (n_blocks, buf.shape[1] // 4) == decode_geometry(TINY, counts, lens)
    assert n_blocks is not None and buf.shape[0] == len(ns) == len(plens) == 8
    for i, p in enumerate(payloads):
        assert buf[i, : len(p)].tobytes() == p and not buf[i, len(p) :].any()
    np.testing.assert_array_equal(ns, counts + [0] * 3)
    np.testing.assert_array_equal(plens, lens + [0] * 3)
    assert not buf[5:].any()

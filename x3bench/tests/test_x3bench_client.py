"""The client loop at a tiny Parameters on device="cpu" (the kernels'
plain PyTorch versions) against the plain reference; the reference
against the X3 reference's golden frame and the port's CPU encode; the
control and the planted faults that the comparison has to catch."""

from __future__ import annotations

import numpy as np
import pytest

from x3bench import compare, control
from x3bench.reference import x3codec

from .conftest import CELLS, ROOT, TINY_PARAMS, run_tiny, tiny_cell

DEFAULT = dict(block_len=20, blocks_per_frame=500, codes=[0, 1, 3], thresholds=[3, 8, 20])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_is_correct(cell, trace):
    result, checks = run_tiny(cell, trace=trace)
    assert result["correct"] is True, checks
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert all(v == 0 and lim == 0 for v, lim in checks.values())
    assert result["calls"]["compared"] >= 2
    c = tiny_cell(cell)
    if trace:  # on the CPU the readers of the device's trace and launch counters find nothing
        assert set(result["metrics"]) <= set(c.per_layer)
    else:
        assert set(result["metrics"]) == set(c.end_to_end)
    direction = cell.split(".")[1]
    rate = {"decode": "decode_mbs", "encode": "encode_mbs"}[direction]
    if trace:  # a cell reports its rate end to end, or else per layer
        assert rate in c.end_to_end or "mbs." + direction in result["metrics"]
        p95 = "call_p95_ms." + direction
        assert (p95 in result["metrics"]) == (p95 in c.per_layer)
    else:
        assert (rate in result["metrics"]) == (rate in c.end_to_end)


def test_reference_encodes_the_golden_frame():
    g = np.load(ROOT / "tests" / "data" / "golden.npz")
    assert x3codec.encode_frames(g["frame_wav"], DEFAULT).data == g["frame_expected"].tobytes()


def _signal(kind, n, rng):
    if kind == "quiet":
        x = rng.normal(0, 2, n)
    elif kind == "hydrophone":
        x = 2000 * np.sin(np.arange(n) / 1555) + rng.normal(0, 6, n)
    elif kind == "music":
        x = 3000 * np.sin(np.arange(n) / 15.4) + rng.normal(0, 300, n)
    else:
        x = rng.integers(-32768, 32768, n)
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("n", [0, 1, 2, 33, 32 * 3 + 5])
@pytest.mark.parametrize("kind", ["quiet", "hydrophone", "music", "noise"])
def test_reference_archive_equals_the_ports_cpu_encode(kind, n):
    import x3_tpu_torch

    x = _signal(kind, n, np.random.default_rng(n))
    prm = x3_tpu_torch.Parameters(block_len=4, blocks_per_frame=8)
    want = x3_tpu_torch.build_archive_header(96000, prm) + x3_tpu_torch.encode(x, prm, device="cpu").data
    assert x3codec.encode_archive(x, 96000, TINY_PARAMS)[0] == want


def test_reference_at_default_parameters_equals_the_ports_cpu_encode():
    import x3_tpu_torch

    x = _signal("hydrophone", 2 * 10000 + 7, np.random.default_rng(0))
    assert x3codec.encode_frames(x, DEFAULT).data == x3_tpu_torch.encode(x, device="cpu").data


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    found = control.readings(tiny_cell(cell), 12345, "cpu", clients=2, params=TINY_PARAMS)
    assert any(v > compare.LIMITS[k] for k, v in found.items()), found


# Faults planted in the timed path, under the entry the cell drives.

def _zero_second_half(samples):
    out = np.array(samples, copy=True)
    out[len(out) // 2 :] = 0
    return out


def _decode_fault(kind):
    from x3_tpu_torch import multifile

    real = multifile.decode_streams

    def broken(archives, *a, **kw):
        if kind == "crc_verdict":
            from x3_tpu_torch.errors import FrameHeaderInvalidPayloadCRC

            raise FrameHeaderInvalidPayloadCRC("archive 0 frame 0 payload CRC mismatch")
        outs = real(archives, *a, **kw)
        if kind == "unchanged":
            return [(np.zeros_like(s), r) for s, r in outs]
        if kind == "half":
            if len(outs) == 1:
                return [(_zero_second_half(outs[0][0]), outs[0][1])]
            h = len(outs) // 2
            return outs[:h] + [(np.zeros_like(s), r) for s, r in outs[h:]]
        i = max(range(len(outs)), key=lambda j: len(outs[j][0]))
        s = np.array(outs[i][0], copy=True)
        s[len(s) // 2] ^= 1
        return outs[:i] + [(s, outs[i][1])] + outs[i + 1 :]

    return multifile, "decode_streams", broken


def _flip(data: bytes) -> bytes:
    b = bytearray(data)
    if b:
        b[len(b) // 2] ^= 0x10
    return bytes(b)


def _encode_fault(cell, kind):
    import x3_tpu_torch
    from x3_tpu_torch import multifile
    from x3_tpu_torch.models.encoder import EncodeResult

    if cell == "eh120.encode":
        from x3_tpu_torch.models.encoder import encode as real

        def broken(samples, params=None, *a, **kw):
            if kind == "unchanged":
                return EncodeResult(b"", np.zeros(6, np.int64))
            if kind == "half":
                return real(samples[: len(samples) // 2], params, *a, **kw)
            if kind == "altered":
                r = real(samples, params, *a, **kw)
                return EncodeResult(_flip(r.data), r.stats)
            raise RuntimeError("encode failed")

        return x3_tpu_torch, "encode", broken

    real = multifile.encode_streams

    def broken_streams(streams, params=None, *a, **kw):
        if kind == "raises":
            raise RuntimeError("encode failed")
        outs = real(streams, params, *a, **kw)
        if kind == "unchanged":
            return [EncodeResult(b"", r.stats) for r in outs]
        if kind == "half":
            h = len(outs) // 2
            return outs[:h] + [EncodeResult(b"", r.stats) for r in outs[h:]]
        i = max(range(len(outs)), key=lambda j: len(outs[j].data))
        return outs[:i] + [EncodeResult(_flip(outs[i].data), outs[i].stats)] + outs[i + 1 :]

    return multifile, "encode_streams", broken_streams


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "raises"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_the_run_not_correct(cell, kind, monkeypatch):
    """A fault under the entry each cell times: an output left as it was
    made (nothing decoded or encoded), half of the call's work left out,
    one sample or byte altered where it is produced, and a call that
    fails (for a decode, a CRC verdict of mismatch)."""
    if "decode" in cell:
        mod, name, broken = _decode_fault({"raises": "crc_verdict"}.get(kind, kind))
    else:
        mod, name, broken = _encode_fault(cell, kind)
    monkeypatch.setattr(mod, name, broken, raising=False)
    result, checks = run_tiny(cell)
    assert result["correct"] is False, checks
    assert any(v > lim for v, lim in checks.values())

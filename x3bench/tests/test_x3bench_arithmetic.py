"""The yardstick's arithmetic: whole-window rates, the tail, the union of
device intervals and the roofline's count of the work."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from x3bench import compare, harness, reduce
from x3bench.harness import Call, Client, Run

from .conftest import TINY_PARAMS


def _rate(calls, nbytes=1_000_000):
    run = Run(direction="decode", calls=calls, start=0.0, end=max(c.end for c in calls),
              bytes_per_call={0: nbytes, 1: nbytes})
    return harness.load_reader("decode_mbs")(run)


def test_a_stall_inside_the_window_lowers_the_rate():
    steady = [Call(0, 0.1 * k, 0.1 * (k + 1), True) for k in range(10)]
    stalled = [Call(0, 0.1 * k + (0.5 if k >= 5 else 0), 0.1 * (k + 1) + (0.5 if k >= 5 else 0), True)
               for k in range(10)]
    assert _rate(steady) == pytest.approx(10.0)
    assert _rate(stalled) == pytest.approx(10 / 1.5)


def test_failed_calls_add_no_bytes():
    calls = [Call(0, 0.0, 0.5, True), Call(1, 0.0, 1.0, False)]
    assert _rate(calls) == pytest.approx(1.0)


def test_a_call_in_flight_at_the_deadline_is_counted():
    """The client starts no call after the deadline, but the call it
    started before it ends after it and counts, and the window runs to
    its end."""
    c = Client(0, [], None, np.random.default_rng(0), None)
    deadline = [time.perf_counter() + 0.05]

    def slow(_):
        time.sleep(0.12)
        return b"x"

    t = threading.Thread(target=c.loop, args=(slow, deadline, c.calls, True))
    t.start()
    t.join(timeout=5)
    assert not t.is_alive()
    assert len(c.calls) == 1 and c.calls[0].ok
    assert c.calls[0].start < deadline[0] < c.calls[0].end
    assert c.kept == [b"x"] and c.last is None


def test_the_compared_calls_are_a_uniform_sample_and_the_last():
    """Reservoir sampling keeps KEEP_DRAWS calls, each of the window's
    calls with equal chance, and always the last."""
    hits = np.zeros(40)
    for seed in range(400):
        c = Client(0, [], None, np.random.default_rng(seed), None)
        values = iter(range(40))
        deadline = [float("inf")]

        def call(_):
            v = next(values)
            if v == 39:
                deadline[0] = 0.0  # the window closes after this call
            return v

        c.loop(call, deadline, [], True)
        kept = set(c.kept) | ({c.last} if c.last is not None else set())
        assert 39 in kept and len(c.kept) == harness.KEEP_DRAWS
        for v in c.kept:
            hits[v] += 1
    assert hits.sum() == 400 * harness.KEEP_DRAWS
    assert hits.min() > 0.4 * hits.mean() and hits.max() < 1.8 * hits.mean()


def test_p95_is_numpys_linear_percentile_over_every_call():
    v = np.arange(1, 201, dtype=np.float64)
    assert reduce.p95(v) == pytest.approx(np.percentile(v, 95))
    calls = [Call(k % 2, 0.0, k / 1000, True) for k in range(1, 201)]
    run = Run(direction="encode", calls=calls)
    assert harness.load_reader("call_p95_ms.encode")(run) == pytest.approx(np.percentile(np.arange(1, 201), 95))
    assert harness.load_reader("call_p95_ms.decode")(run) is None


def test_union_gaps_and_cover():
    merged = reduce.union([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)])
    assert merged == [(0, 2), (3, 4)]
    assert reduce.covered(merged, 1, 3.5) == pytest.approx(1.5)
    assert reduce.gaps(merged, -1, 5) == [(-1, 0), (2, 3), (4, 5)]


def test_idle_share_uses_the_union_not_the_sum():
    """A copy that overlaps a kernel is not counted twice."""
    from x3bench.trace import Trace

    tr = Trace((0.0, 10.0), reduce.union([(1, 3), (2, 4), (6, 7)]), [], [], [])
    run = Run(direction="decode", trace=tr)
    assert harness.load_reader("device_idle_pct.decode")(run) == pytest.approx(60.0)


@pytest.mark.parametrize("carrier", ["numpy", "torch", "list", "int32"])
def test_the_roofline_work_is_the_inputs_whatever_carries_them(carrier):
    """The work is counted from the samples and the reference's archive,
    not from the program's tensors: the same inputs give the same count
    however they are held, and it equals the payload lengths that the
    port's own archive holds."""
    import x3_tpu_torch

    x = (np.random.default_rng(3).normal(0, 40, 777)).astype(np.int16)
    held = {"numpy": x, "torch": torch.from_numpy(x.copy()).numpy(), "list": x.tolist(),
            "int32": x.astype(np.int32)}[carrier]
    ref = compare.Reference([np.asarray(held, np.int16)], 96000, TINY_PARAMS)
    prm = x3_tpu_torch.Parameters(block_len=4, blocks_per_frame=8)
    data = x3_tpu_torch.encode(x, prm, device="cpu").data
    assert ref.payload_bytes == sum(h.payload_len for _, h, _ in _walk(data))
    run = Run(direction="decode", traced_calls=[Call(0, 0, 1, True)], bytes_per_call={0: 2 * len(x)},
              payload_bytes_per_call={0: ref.payload_bytes},
              trace=type("T", (), {"kernel_s": 1e-6})())
    want = 100 * (2 * len(x) + ref.payload_bytes) / reduce.HBM_BYTES_PER_S / 1e-6
    assert harness.load_reader("decode_kernels_roofline")(run) == pytest.approx(want)


def _walk(data):
    from x3_tpu_torch.archive import read_frame_header

    pos = 0
    while pos < len(data):
        h = read_frame_header(data[pos : pos + 20])
        yield pos, h, data[pos + 20 : pos + 20 + h.payload_len]
        pos += 20 + h.payload_len


def test_launch_ratios():
    run = Run(direction="decode", calls=[Call(0, 0, 1, True)] * 3, frames_per_call={0: 3600},
              launches={"k1": 15, "k2": 0, "k3": 15})
    assert harness.load_reader("k3_frames_per_launch")(run) == pytest.approx(720.0)
    assert harness.load_reader("k2_launches_per_batch")(run) is None
    enc = Run(direction="encode", calls=[Call(0, 0, 1, True)] * 2, batches_per_call={0: 5},
              launches={"k1": 0, "k2": 12, "k3": 0})
    assert harness.load_reader("k2_launches_per_batch")(enc) == pytest.approx(1.2)
    assert harness.load_reader("k3_frames_per_launch")(Run(direction="decode", launches={"k3": 0})) is None

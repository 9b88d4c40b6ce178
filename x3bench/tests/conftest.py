"""Shared helpers of the benchmark's CPU tests: cells shrunk to a tiny
size (block_len 4, 8 blocks a frame, streams of a few thousand samples)
that run on device="cpu", the plain PyTorch versions of the kernels."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_PARAMS = dict(block_len=4, blocks_per_frame=8, codes=[0, 1, 3], thresholds=[3, 8, 20])
CELLS = ("eh120.decode", "clips.decode", "eh120.encode", "clips.encode")
# Entries that BENCHMARK.json gives no cell yet: (a cell of the same configuration, the traffic mix).
UNLISTED = {"eh120.encode": ("eh120.decode", "encode_1c"), "clips.encode": ("clips.decode", "encode_streams_1c")}


def tiny_cell(name: str):
    from x3bench import harness

    if name in UNLISTED:
        base, mix = UNLISTED[name]
        cell = harness.Cell(base)
        cell.name = name
        cell.traffic = harness.load_json(ROOT / "x3bench" / "traffic" / f"{mix}.json")
        cell.end_to_end = ["encode_mbs", "host_peak_mb", "setup_s"]
        cell.per_layer = ["call_p95_ms.encode", "host_cpu_s_per_gb.encode", "k2_launches_per_batch",
                          "encode_kernels_roofline", "device_idle_pct.encode"]
        cell.units = dict(cell.units, encode_mbs="MB/s", **{m: "-" for m in cell.per_layer})
    else:
        cell = harness.Cell(name)
    cell.config = dict(cell.config)
    if cell.config["name"] == "x3rust_eh120":
        cell.config["streams"] = {"lengths": [1000]}
    else:
        cell.config["streams"] = {"uniform": {"count": 5, "low": 1, "high": 300},
                                  "lengths": [0, 1, 32], "shuffle": True}
    cell.traffic = dict(cell.traffic, trace_seconds=0.2)
    return cell


def run_tiny(name: str, seed: int = 2**33 + 17, trace: bool = False, seconds: float = 0.2):
    from x3bench import harness

    return harness.run(tiny_cell(name), seed, seconds, trace, time.time(), device="cpu",
                       clients=2, params=TINY_PARAMS)


@pytest.fixture
def tiny():
    return run_tiny

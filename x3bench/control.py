"""The control of the comparison that decides `correct`: the reference
put in the program's place at 15 bits (compare.control_streams), at the
cell's own sizes and clients, held to the reference exactly as a run's
outputs are.  It has to come out as not correct.

    python3 x3bench/control.py --workload <cell> --seeds 1,2,3

prints one line a seed with the numbers compared and whether the control
was caught.  The benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from x3bench import compare, harness  # noqa: E402
from x3bench import streams as gen  # noqa: E402
from x3bench.reference import x3codec  # noqa: E402


def readings(cell: harness.Cell, seed: int, device, clients: int | None = None, params: dict | None = None) -> dict:
    """The control's numbers for one seed, summed over the clients, with
    as many outputs compared a client as a run keeps."""
    import importlib

    entry = importlib.import_module(f"x3bench.entries.{cell.traffic['entry']}")
    pdict = dict(params or cell.config["params"])
    rate = cell.config["sample_rate"]
    found: dict = {}
    for i in range(clients or cell.traffic["clients"]):
        streams = gen.make_streams(cell.config, seed, i, device)
        ref = compare.Reference(streams, rate, pdict)
        low = compare.control_streams(streams)
        frames = [x3codec.encode_frames(s, pdict).data for s in low]
        if entry.DIRECTION == "decode":
            inputs, out = [ref.header + f for f in frames], [(s, rate) for s in low]
        else:
            inputs, out = streams, (ref.header, frames)
        outs = [out] * (harness.KEEP_DRAWS + 1)
        for k, v in entry.check(inputs, outs, streams, rate, ref).items():
            found[k] = found.get(k, 0) + v
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--device", default="cuda", help="where the streams are made (the run's device)")
    args = ap.parse_args(argv)
    import torch

    cell = harness.Cell(args.workload)
    caught_all = True
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        found = readings(cell, seed, torch.device(args.device))
        caught = any(v > compare.LIMITS[k] for k, v in found.items())
        caught_all &= caught
        print(json.dumps({"workload": cell.name, "seed": seed, "control": found, "caught": caught,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0 if caught_all else 1


if __name__ == "__main__":
    sys.exit(main())

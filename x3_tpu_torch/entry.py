"""Entry points of the port: the flagship step and the multi-device dry run.

    python -m x3_tpu_torch.entry            # on the card(s)
    python -m x3_tpu_torch.entry --device cpu

`entry()` gives the batched frame encode (K2 + K1 on a card) with example
inputs; `dryrun_multichip(n)` runs the sharded roundtrip step
(parallel.mesh.roundtrip_step) over an n-entry mesh at a tiny and at the
default geometry and checks that both are exact.  With fewer cards than
entries the mesh cycles over the visible cards (an entry is a shard, so a
card may hold several)."""

from __future__ import annotations

import sys

import numpy as np
import torch

from .device import resolve_device
from .params import Parameters


def entry(*, device="cuda"):
    """(fn, args): the default-geometry encode_frames of 4 frames, the last
    of them partial, on `device`."""
    from .ops.encode_kernel import encode_frames

    dev = resolve_device(device)
    params = Parameters()

    def fn(samples, n_valid):
        return encode_frames(samples, n_valid, params)

    f, s = 4, params.samples_per_frame
    rng = np.random.default_rng(0)
    samples = np.clip(np.cumsum(rng.integers(-8, 9, (f, s)), axis=1), -32768, 32767).astype(np.int16)
    n_valid = np.full(f, s, np.int32)
    n_valid[-1] = s - 1234
    return fn, (torch.from_numpy(samples).to(dev), torch.from_numpy(n_valid).to(dev))


def dryrun_multichip(n_devices: int, *, device="cuda") -> None:
    """Run the sharded roundtrip step (encode -> bytes -> decode -> verify)
    over an n_devices-entry mesh, at a tiny geometry and at the default one
    (a partial tail frame each), and raise AssertionError unless both are
    exact.  On "cuda" the entries cycle over the visible cards."""
    from .parallel.mesh import make_mesh, roundtrip_step

    dev = resolve_device(device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % n_cards) for i in range(n_devices)]
        where = f"{n_cards} card(s)" + (", cycled" if n_cards < n_devices else "")
    else:
        devices = [dev] * n_devices
        where = "the CPU"
    mesh = make_mesh(devices)
    for params, f, tag in (
        (Parameters(block_len=4, blocks_per_frame=8), 2 * n_devices, "tiny"),
        (Parameters(), n_devices, "default"),
    ):
        s = params.samples_per_frame
        rng = np.random.default_rng(1)
        samples = np.clip(np.cumsum(rng.integers(-6, 7, (f, s)), axis=1), -32768, 32767).astype(np.int16)
        n_valid = np.full(f, s, np.int32)
        n_valid[-1] = s - 7  # partial tail frame
        nbytes, exact = roundtrip_step(params, mesh)(samples, n_valid)
        if not bool(exact):
            raise AssertionError(f"sharded roundtrip ({tag}) was not bit-exact")
        print(f"dryrun_multichip[{tag}]: {n_devices} devices on {where}, {f} frames, "
              f"roundtrip exact, nbytes={nbytes.cpu().tolist()}", flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m x3_tpu_torch.entry", description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fn, inputs = entry(device=args.device)
    out = fn(*inputs)
    print("entry() ran:", {k: tuple(v.shape) for k, v in out.items()}, flush=True)
    # The dry run's mesh: every visible card, or two CPU entries.
    dryrun_multichip(torch.cuda.device_count() if resolve_device(args.device).type == "cuda" else 2,
                     device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

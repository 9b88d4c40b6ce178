"""Decode parity of the kernel K3 against its plain version on mutated
batches at production size (the port's tools/tpu_decode_parity.py).

    python -m x3_tpu_torch.tools.decode_parity             # 768 frames a class
    python -m x3_tpu_torch.tools.decode_parity --frames 2048
    python -m x3_tpu_torch.tools.decode_parity --device cpu --frames 12 --block-len 4 --blocks-per-frame 8

For each of three signal classes (hydrophone-, music- and pi240-like, the
fuzz soak's kinds), a batch is encoded on the device (K2) and its payloads
mutated on the host, a mutation by lane index mod 6: a block-header byte
flipped, a mid-payload byte flipped, the last byte flipped, the payload
length halved, and two clean lanes.  The batch, at the smallest width
rung that holds it, is then decoded by the routed path
(ops.decode_kernel.decode_words: K3 on a card) and by the plain version
(ops.decode_cuda.plain): the error codes, the samples (the garbage on
error lanes included) and the final offsets must be identical.  Exit code
1 on any difference, when no lane erred, or on a card when K3 was never
launched.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .fuzz_soak import KINDS, add_common_args, check_decode, encode_payloads, make_signal, parse_params, verdict

CLASSES = ("hydrophone", "music", "pi240")


def mutate_rotation(buf: np.ndarray, plens: np.ndarray) -> None:
    """The mutation of lane i by i mod 6, in place (lanes 4 and 5 clean)."""
    for i in range(len(buf)):
        ln, m = int(plens[i]), i % 6
        if m == 0:
            buf[i, 2] ^= 0xFF
        elif m == 1:
            buf[i, ln // 2] ^= 0x81
        elif m == 2:
            buf[i, max(ln - 1, 0)] ^= 0x0F
        elif m == 3:
            plens[i] = max(2, ln // 2)


def parity(frames: int = 768, seed: int = 0, params=None, device="cuda", log=print) -> dict:
    """Run the three classes; returns the fuzz soak's summary keys."""
    from ..device import resolve_device
    from ..ops import decode_cuda
    from ..params import Parameters

    dev = resolve_device(device)
    params = params or Parameters()
    spf = params.samples_per_frame
    rng = np.random.default_rng(seed)
    launches0 = decode_cuda.launch_count
    totals = {"trials": len(CLASSES), "failures": 0, "error_lanes": 0, "plain_calls": 0}
    t0 = time.perf_counter()
    for cname in CLASSES:
        wav = make_signal(rng, frames * spf, KINDS.index(cname))
        n_valid = np.full(frames, spf, np.int32)
        buf, nbytes = encode_payloads(wav.reshape(frames, spf), n_valid, params, dev)
        plens = nbytes.astype(np.int32)
        mutate_rotation(buf, plens)
        W = buf.shape[1] // 4
        failures, err_lanes = check_decode([(f"{cname} W={W}", buf, n_valid, plens)], params, None, dev, log)
        totals["failures"] += failures
        totals["error_lanes"] += err_lanes
        totals["plain_calls"] += 1
        log(f"{cname:12s} W={W:5d} errors={err_lanes}/{frames} identical={not failures} "
            f"({time.perf_counter() - t0:.1f} s)")
    return {**totals, "launches": decode_cuda.launch_count - launches0, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m x3_tpu_torch.tools.decode_parity",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=768, help="frames a class")
    add_common_args(ap)
    ap.set_defaults(seed=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    summary = parity(args.frames, args.seed, parse_params(args), dev)
    return verdict(summary, dev, "decode parity")


if __name__ == "__main__":
    sys.exit(main())

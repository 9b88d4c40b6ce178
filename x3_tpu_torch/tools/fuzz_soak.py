"""Fuzz soak of the decode kernel K3 against its plain version, on
production-size mutated batches (the port's tools/tpu_fuzz_soak.py).

    python -m x3_tpu_torch.tools.fuzz_soak --trials 200 --seed 7
    python -m x3_tpu_torch.tools.fuzz_soak --trials 6 --device cpu --block-len 4 --blocks-per-frame 8 --batches 8,12

Each trial takes a batch of 512, 768 or 1,024 frames of one signal kind
(the kinds rotate: silence, a pi240-like walk, hydrophone-like, music-like,
white noise, rails), encodes it with the encode kernel (K2) at the
smallest width rung that holds it, and mutates copies of the payloads on
the host: byte flips, truncated payload lengths and lanes of random bytes.
About one trial in five walks an n_blocks override (1.2x and 2x the
frame's blocks, as for a foreign archive).  The routed decode
(ops.decode_kernel.decode_words: K3 on a card) must then give the plain
version's (ops.decode_cuda.plain) samples, including the garbage on error
lanes, error codes and final offsets, lane for lane.

The plain version steps every lane through its bitstream one sample at a
time, so a call costs about the same for 8 lanes or 8,192; the trials of
one geometry (width, n_blocks) are therefore batched into one plain call
of up to PLAIN_LANES lanes.  Every failure reproduces from the printed
(seed, trial).  Exit code 1 on any difference, when no lane erred, or on a
card when K3 was never launched.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

MAXMUT = 64  # byte flips a trial draws up to
PLAIN_LANES = 16384  # lanes of one geometry gathered into one plain call (about 3 GB on the card)
KINDS = ("silence", "pi240", "hydrophone", "music", "noise", "rails")


def make_signal(rng, n: int, kind: int) -> np.ndarray:
    """n int16 samples of signal kind `kind` (an index into KINDS)."""
    if kind == 0:
        return np.zeros(n, np.int16)
    if kind == 1:  # pi240-like
        return np.clip(np.cumsum(rng.integers(-1, 2, n)), -30000, 30000).astype(np.int16)
    if kind == 2:  # hydrophone-like
        t = np.arange(n)
        slow = 2000.0 * np.sin(2 * np.pi * t / 9773.0)
        return np.clip(np.round(slow + rng.normal(0, 6.0, n)), -32768, 32767).astype(np.int16)
    if kind == 3:  # music-like (BFP-heavy)
        t = np.arange(n)
        tone = 3000.0 * np.sin(2 * np.pi * t / 97.0)
        return np.clip(np.round(tone + rng.normal(0, 300.0, n)), -32768, 32767).astype(np.int16)
    if kind == 4:  # white noise (pass-through blocks)
        return rng.integers(-32768, 32768, n).astype(np.int16)
    return np.tile(np.asarray([-32768, 32767, 0, -1], np.int16), n // 4 + 1)[:n]


def encode_payloads(frames: np.ndarray, n_valid: np.ndarray, params, dev):
    """Encode [F, S] frames on `dev` (K2 + K1 on a card): (payload bytes
    uint8 [F, 4W] at the smallest width rung W that holds every frame,
    nbytes int32 [F])."""
    from ..ops.encode_kernel import encode_frames, width_rungs

    enc = encode_frames(torch.from_numpy(frames).to(dev), torch.from_numpy(n_valid).to(dev), params)
    nbytes = enc["nbytes"].cpu().numpy()
    rungs = width_rungs(params)
    W = next((r for r in rungs if int(nbytes.max()) <= r * 4), rungs[-1])
    words = enc["payload_words"][:, :W].contiguous().cpu().numpy()
    return words.view(np.uint32).byteswap().view(np.uint8).reshape(len(frames), 4 * W), nbytes


def check_decode(cases, params, n_blocks, dev, log):
    """Decode each case (tag, payload bytes [F, 4W], n_samples [F],
    payload_lens [F], all at one W) by the routed decode, and all of them by
    one call of the plain version; log and count the cases that differ.
    Returns (cases that differ, error lanes of the plain version)."""
    from ..ops import decode_cuda
    from ..ops.decode_kernel import decode_words, payload_words

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    words = payload_words(on_dev(np.concatenate([c[1] for c in cases])))
    ns, plens = on_dev(np.concatenate([c[2] for c in cases])), on_dev(np.concatenate([c[3] for c in cases]))
    want = decode_cuda.plain(words, ns, plens, params, n_blocks)
    failures, base = 0, 0
    for tag, buf, n, pl in cases:
        sl = slice(base, base + len(buf))
        base += len(buf)
        got = decode_words(words[sl], ns[sl], plens[sl], params, n_blocks)
        differ = [int((g != w[sl]).reshape(len(buf), -1).any(dim=1).sum()) for g, w in zip(got, want)]
        if any(differ):
            failures += 1
            log(f"FAIL parity: {tag}: lanes differing in samples {differ[0]}, error codes {differ[1]}, "
                f"final offsets {differ[2]} of {len(buf)}")
    return failures, int((want[1] != 0).sum())


def soak(trials: int, seed: int, params=None, batches=(512, 768, 1024), device="cuda", log=print) -> dict:
    """Run `trials` trials; returns {"trials", "failures", "error_lanes",
    "plain_calls", "launches" (of K3), "seconds"}."""
    from ..device import resolve_device
    from ..ops import decode_cuda
    from ..params import Parameters

    dev = resolve_device(device)
    params = params or Parameters()
    spf, bpf = params.samples_per_frame, params.blocks_per_frame
    rng = np.random.default_rng(seed)
    launches0 = decode_cuda.launch_count
    bases: dict = {}  # (kind, F) -> (payload bytes, nbytes, n_valid)
    pending: dict = {}  # (W, n_blocks) -> [case, ...]
    totals = {"failures": 0, "error_lanes": 0, "plain_calls": 0}
    t0 = time.perf_counter()

    def flush(key):
        failures, err_lanes = check_decode(pending.pop(key), params, key[1], dev, log)
        totals["failures"] += failures
        totals["error_lanes"] += err_lanes
        totals["plain_calls"] += 1
        log(f"  W={key[0]} n_blocks={key[1]}: {totals['plain_calls']} plain calls, "
            f"{totals['error_lanes']} error lanes, {totals['failures']} failures, "
            f"{time.perf_counter() - t0:.1f} s")

    for trial in range(trials):
        kind = (seed + trial) % len(KINDS)
        F = int(rng.choice(batches))
        n_blocks = None if rng.random() < 0.8 else int(rng.choice([bpf * 6 // 5, bpf * 2]))
        if (kind, F) not in bases:
            frames = make_signal(rng, F * spf, kind).reshape(F, spf)
            n_valid = np.full(F, spf, np.int32)
            n_valid[-1] = int(rng.integers(0, spf))  # a partial tail lane
            frames[-1, n_valid[-1]:] = 0
            bases[(kind, F)] = (*encode_payloads(frames, n_valid, params, dev), n_valid)
        base, nbytes, n_valid = bases[(kind, F)]
        buf, plens = base.copy(), nbytes.astype(np.int32)
        for _ in range(int(rng.integers(1, MAXMUT))):  # byte flips inside the payloads
            lane = int(rng.integers(0, F))
            pos = int(rng.integers(0, min(max(2, int(plens[lane])), buf.shape[1])))
            buf[lane, pos] ^= int(rng.integers(1, 256))
        for lane in rng.choice(F, size=max(1, F // 16), replace=False):  # truncated lengths
            plens[lane] = int(rng.integers(2, max(2, int(plens[lane])) + 1)) & ~1
        wild = rng.choice(F, size=max(1, F // 32), replace=False)  # lanes of random bytes
        buf[wild] = rng.integers(0, 256, (len(wild), buf.shape[1]), dtype=np.uint8)
        W = buf.shape[1] // 4
        tag = f"seed={seed:#x} trial={trial} kind={KINDS[kind]} F={F} n_blocks={n_blocks} W={W}"
        cases = pending.setdefault((W, n_blocks), [])
        cases.append((tag, buf, n_valid, plens))
        if sum(len(c[1]) for c in cases) >= PLAIN_LANES:
            flush((W, n_blocks))
    for key in list(pending):
        flush(key)
    return {"trials": trials, **totals, "launches": decode_cuda.launch_count - launches0,
            "seconds": time.perf_counter() - t0}


def verdict(summary: dict, dev, what: str, log=print) -> int:
    """Exit code of a decode check: 1 on a difference, when no lane erred,
    or on a card when K3 was never launched."""
    problems = []
    if summary["failures"]:
        problems.append(f"{summary['failures']} divergence(s) between K3 and the plain decode")
    if not summary["error_lanes"]:
        problems.append("no lane erred: the mutations tested nothing")
    if dev.type == "cuda" and not summary["launches"]:
        problems.append("K3 was never launched")
    for p in problems:
        log(f"FAIL: {p}")
    if not problems:
        log(f"{what} holds: K3 {'(on the CPU: its plain version) ' if dev.type != 'cuda' else ''}"
            f"equals the plain decode on errors, samples and offsets")
    return 1 if problems else 0


def parse_params(args):
    from ..params import Parameters

    if args.block_len is None and args.blocks_per_frame is None:
        return Parameters()
    kw = {k: v for k, v in (("block_len", args.block_len), ("blocks_per_frame", args.blocks_per_frame))
          if v is not None}
    return Parameters(**kw)


def add_common_args(ap) -> None:
    ap.add_argument("--seed", type=lambda s: int(s, 0), default=7)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain version on both sides)")
    ap.add_argument("--block-len", type=int, default=None, help="geometry (default: Parameters())")
    ap.add_argument("--blocks-per-frame", type=int, default=None)


def main(argv=None) -> int:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m x3_tpu_torch.tools.fuzz_soak",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--batches", default="512,768,1024", help="batch sizes the trials draw from")
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    summary = soak(args.trials, args.seed, parse_params(args), [int(b) for b in args.batches.split(",")], dev)
    print(f"done: {summary['trials']} trials (seed {args.seed:#x}), {summary['plain_calls']} plain calls, "
          f"{summary['launches']} K3 launches, {summary['error_lanes']} error lanes, "
          f"{summary['failures']} failures, {summary['seconds']:.1f} s", flush=True)
    return verdict(summary, dev, "fuzz soak")


if __name__ == "__main__":
    sys.exit(main())

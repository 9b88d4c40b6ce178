"""Differential fuzz of the port across devices (the port's
tools/fuzz_differential.py): the kernels on a card and their plain
versions on the CPU must agree byte for byte on encode and bit for bit on
decode, across parameter geometries, signal classes, edge lengths and
random corruption.

    python -m x3_tpu_torch.tools.fuzz_differential --trials 90 --seed 7
    python -m x3_tpu_torch.tools.fuzz_differential --trials 10 --devices cpu --geometries 2,3,4,5,6

A trial draws its geometry (trial mod 9), signal kind, length and samples
from the seed in the same order as x3_tpu's tool, so `seed=S trial=T` is
the same input in both.  Each trial checks that

* `encode` gives the same frame stream and statistics on every device as
  on the first;
* `decode_frames_batch` of that stream gives the input back, with no
  errors, on every device;
* so does a decode with the parameters an archive's XML rebuilds: it has
  no blocks_per_frame, so frames of more blocks than the default geometry
  walk the decode kernel's n_blocks override;
* one bit flipped in the first frame's payload gets the same accept or
  reject, error code included, on every device, and the same samples
  when accepted.

The plain decode steps every lane through its bitstream one sample at a
time, so a call costs about the same for one lane or thousands.  The
decodes of one device and parameter set are therefore gathered across
trials and run in as few calls as keep each lane's result what a call of
its own gives: frames that decode cleanly do so at any width and block
count, so they share one call; a corrupted frame may read past its
payload, so it shares a call only at the width and block count its own
call would take.

Rice code selection stays at the default [0, 1, 3], since the reference
decoder hardwires the ftype 2/3 suffix widths to 2/4 bits.  With a
reference `x3` binary (utils.extbin), default-geometry trials also
roundtrip through it at the file layer on the first device.  Every
failure prints its (seed, trial) pair.  Exit code 1 on any failure, and on
a card also when the encode kernel K2 or the decode kernel K3 was never
launched.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# A compact set of geometries, as in x3_tpu's tool.
GEOMETRIES = [
    dict(block_len=20, blocks_per_frame=500),                       # default
    dict(block_len=20, blocks_per_frame=500, thresholds=(2, 5, 15)),
    dict(block_len=4, blocks_per_frame=8),
    dict(block_len=1, blocks_per_frame=16),
    dict(block_len=24, blocks_per_frame=7),
    dict(block_len=25, blocks_per_frame=6),                         # scan path
    dict(block_len=60, blocks_per_frame=5),                         # max block
    dict(block_len=20, blocks_per_frame=700),                       # > default bpf
    dict(block_len=10, blocks_per_frame=1500),                      # >> default bpf
]


def make_signal(rng, n, kind):
    if n == 0:
        return np.zeros(0, np.int16)
    if kind == 0:
        return np.zeros(n, np.int16)
    if kind == 1:
        return np.clip(np.cumsum(rng.integers(-3, 4, n)), -32768, 32767).astype(np.int16)
    if kind == 2:
        return np.clip(np.cumsum(rng.integers(-50, 51, n)), -32768, 32767).astype(np.int16)
    if kind == 3:
        return rng.integers(-32768, 32768, n).astype(np.int16)
    if kind == 4:  # clicks on a quiet floor
        base = rng.integers(-2, 3, n)
        base[rng.random(n) < 0.01] = rng.integers(-32000, 32000)
        return base.astype(np.int16)
    # extremes: rails and alternation
    out = np.tile(np.asarray([-32768, 32767, 0, -1], np.int16), n // 4 + 1)[:n]
    return out


def draw_trial(rng, trial: int):
    """(geometry, kind, n, samples) of `trial`, drawn from `rng` as x3_tpu's
    tool draws them."""
    from ..params import Parameters

    geo = GEOMETRIES[trial % len(GEOMETRIES)]
    spf = Parameters(**geo).samples_per_frame
    kind = int(rng.integers(0, 6))
    # lengths: sub-frame, exact, partial-tail multi-frame, off-by-one
    n = int(rng.choice([1, 2, spf - 1, spf, spf + 1, int(rng.integers(1, 3 * spf + 2))]))
    return geo, kind, n, make_signal(rng, n, kind)


def split_frames(data: bytes):
    """(payloads, sample counts) of a frame stream, its headers checked."""
    from ..archive import walk_frames

    frames = list(walk_frames(data, 0))
    return [data[off : off + h.payload_len] for off, h in frames], [h.samples for _, h in frames]


def corrupt(rng, payload: bytes) -> bytes | None:
    """`payload` with one bit flipped, drawn from `rng` as x3_tpu's tool
    draws it; None (and nothing drawn) for a payload of 4 bytes or less."""
    if len(payload) <= 4:
        return None
    p = bytearray(payload)
    i = int(rng.integers(0, len(p)))
    p[i] ^= 1 << int(rng.integers(0, 8))
    return bytes(p)


class Decodes:
    """The decodes of one device, queued by add() and run by run()."""

    def __init__(self, device):
        self.device = device
        self.jobs: dict = {}  # Parameters -> [(payloads, counts, exact, done)]
        self.calls = 0

    def add(self, params, payloads, counts, done, exact: bool = False) -> None:
        """Queue a decode of `payloads`; run() hands done(outs, errs) their
        results, or done(None, exception) when the call raised.  exact: walk
        them at the width and block count a call of their own would take."""
        self.jobs.setdefault(params, []).append((payloads, counts, exact, done))

    def run(self) -> None:
        from ..models.decoder import decode_frames_batch, decode_geometry

        for params, jobs in self.jobs.items():
            def geometry(js, params=params):
                return decode_geometry(params, [c for j in js for c in j[1]], [len(p) for j in js for p in j[0]])

            shared = [j for j in jobs if not j[2]]
            groups = {geometry(shared): shared} if shared else {}
            for j in jobs:
                if j[2]:
                    groups.setdefault(geometry([j]), []).append(j)
            for group in groups.values():
                payloads = [p for j in group for p in j[0]]
                counts = [c for j in group for c in j[1]]
                self.calls += 1
                try:
                    outs, errs = decode_frames_batch(payloads, counts, params, device=self.device)
                except Exception as e:  # noqa: BLE001 - each job reports it
                    for j in group:
                        j[3](None, e)
                    continue
                base = 0
                for j in group:
                    k = len(j[0])
                    j[3](outs[base : base + k], errs[base : base + k])
                    base += k
        self.jobs = {}


def ref_file_differential(ref_bin: str, wav: np.ndarray, ctx: str, device="cuda", log=print) -> int:
    """Roundtrip `wav` through the reference binary and the port's file
    layer on `device`; the archives must be byte-identical and the
    cross-decodes bit-exact.  Returns the number of failures."""
    from ..files import wav_to_x3a, x3a_to_wav
    from ..utils.extbin import ref_convert
    from ..utils.wav import read_wav, write_wav

    failures = 0
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        wp = tmp / "t.wav"
        write_wav(wp, wav, 96_000)
        ours, refs = tmp / "ours.x3a", tmp / "ref.x3a"
        wav_to_x3a(wp, ours, device=device)
        try:
            ref_convert(ref_bin, wp, refs)
        except Exception as e:  # noqa: BLE001 - the gate reports, it does not die
            log(f"FAIL refbin encode {type(e).__name__}: {e} ({ctx})")
            return 1
        if ours.read_bytes() != refs.read_bytes():
            log(f"FAIL refbin archive cmp mismatch ({ctx})")
            failures += 1
        back = tmp / "back.wav"
        try:
            if x3a_to_wav(refs, back, device=device) != 0:
                raise ValueError("frame errors")
            got, _ = read_wav(back)
            if not np.array_equal(got, wav):
                log(f"FAIL our decode of refbin archive differs ({ctx})")
                failures += 1
        except Exception as e:  # noqa: BLE001
            log(f"FAIL our decode of refbin archive: {type(e).__name__}: {e} ({ctx})")
            failures += 1
        try:
            ref_convert(ref_bin, ours, back)
            got, _ = read_wav(back)
            if not np.array_equal(got, wav):
                log(f"FAIL refbin decode of our archive differs ({ctx})")
                failures += 1
        except Exception as e:  # noqa: BLE001
            log(f"FAIL refbin decode {type(e).__name__}: {e} ({ctx})")
            failures += 1
    return failures


def outcome(outs, errs):
    """A corrupted frame's decode: ("ok", samples), ("err <code>", None) or
    ("raised <class>", None)."""
    if outs is None:
        return f"raised {type(errs).__name__}", None
    return ("ok", outs[0]) if not errs[0] else (f"err {int(errs[0])}", None)


def run_campaign(trials: int, seed: int, devices=("cuda", "cpu"), geometries=None, verbose: bool = False,
                 log=print) -> dict:
    """Run `trials` trials on `devices`, the first of which the others are
    held to.  geometries: the GEOMETRIES indices whose trials are checked
    (default all); the other trials are drawn and encoded on the first
    device only, which keeps every checked trial's input that of its
    (seed, trial).  Returns {"trials", "checked", "failures", "plain_calls",
    "calls", "launches" (K2, K3), "seconds", "records"}: a record a trial
    with its "ctx", "data" (the first device's frame stream), "corrupt"
    (the corrupted payload or None) and, when checked, "outcomes" of the
    corrupted frame by device."""
    from ..device import resolve_device
    from ..models.encoder import encode
    from ..ops import decode_cuda, encode_cuda
    from ..params import Parameters
    from ..utils.extbin import find_reference_x3

    devs = [resolve_device(d) for d in devices]
    ref_bin = find_reference_x3()
    if ref_bin:
        log(f"reference x3 binary: {ref_bin} (file-layer differential active)")
    rng = np.random.default_rng(seed)
    queues = [Decodes(d) for d in devs]
    launches0 = (encode_cuda.launch_count, decode_cuda.launch_count)
    failures = []
    records = []
    t0 = time.perf_counter()

    def fail(msg: str) -> None:
        failures.append(msg)
        log(f"FAIL {msg}")

    def expect_input(what: str, dev, ctx: str, wav: np.ndarray):
        def done(outs, errs):
            if outs is None:
                fail(f"{what} on {dev} raised {type(errs).__name__}: {errs} ({ctx})")
                return
            got = np.concatenate(outs) if outs else np.zeros(0, np.int16)
            if np.asarray(errs).any() or not np.array_equal(got, wav):
                fail(f"{what} on {dev}: {ctx} errs={np.asarray(errs)}")
        return done

    def keep_outcome(dev, rec: dict):
        def done(outs, errs):
            if outs is None:
                fail(f"corrupt-frame decode on {dev} raised {type(errs).__name__}: {errs} ({rec['ctx']})")
            rec["outcomes"][str(dev)] = outcome(outs, errs)
        return done

    for trial in range(trials):
        geo, kind, n, wav = draw_trial(rng, trial)
        ctx = f"seed={seed} trial={trial} geo={geo} kind={kind} n={n}"
        checked = geometries is None or trial % len(GEOMETRIES) in geometries
        rec = {"trial": trial, "ctx": ctx, "checked": checked, "data": None, "corrupt": None}
        records.append(rec)
        try:
            params = Parameters(**geo)
            encs = [encode(wav, params, device=d) for d in (devs if checked else devs[:1])]
            rec["data"] = data = encs[0].data
            for dev, res in zip(devs[1:], encs[1:]):
                if res.data != data:
                    fail(f"encode on {dev} differs from {devs[0]}: {ctx}")
                elif not np.array_equal(res.stats, encs[0].stats):
                    fail(f"encode statistics on {dev} differ from {devs[0]}: {ctx}")
            payloads, counts = split_frames(data)
            rec["corrupt"] = p = corrupt(rng, payloads[0]) if payloads else None
            if not checked:
                continue
            # The archive XML carries block_len and thresholds but not
            # blocks_per_frame, so the file layer decodes with the default
            # blocks_per_frame, and bigger frames take the n_blocks override.
            recon = Parameters(block_len=params.block_len, thresholds=params.thresholds)
            rec["outcomes"] = {}
            for dev, q in zip(devs, queues):
                q.add(params, payloads, counts, expect_input("decode roundtrip", dev, ctx, wav))
                q.add(recon, payloads, counts, expect_input("reconstructed-params decode", dev, ctx, wav))
                if p is not None:
                    q.add(params, [p], counts[:1], keep_outcome(dev, rec), exact=True)
            # The reference CLI has no parameter flags: default geometry only.
            if ref_bin and geo == GEOMETRIES[0] and n > 0:
                failures += [f"refbin ({ctx})"] * ref_file_differential(ref_bin, wav, ctx, devs[0], log)
        except Exception as e:  # noqa: BLE001 - the campaign reports, it does not die
            fail(f"exception {type(e).__name__}: {e} ({ctx})")
        if verbose and trial % 10 == 9:
            log(f"... {trial + 1}/{trials} trials drawn, {len(failures)} failures, "
                f"{time.perf_counter() - t0:.1f} s")

    for q in queues:
        q.run()
    for rec in records:
        got = rec.get("outcomes")
        if not got:
            continue
        oks = {d for d, (o, _) in got.items() if o == "ok"}
        if oks and len(oks) < len(got):
            fail(f"corrupt accept/reject divergence: {rec['ctx']} "
                 f"{ {d: o for d, (o, _) in got.items()} }")
        elif not oks and len({o for o, _ in got.values()}) > 1:
            fail(f"corrupt error code divergence: {rec['ctx']} {[o for o, _ in got.values()]}")
        elif oks:
            vals = [got[d][1] for d in sorted(oks)]
            if any(not np.array_equal(vals[0], v) for v in vals[1:]):
                fail(f"corrupt sample divergence: {rec['ctx']}")

    launches = (encode_cuda.launch_count - launches0[0], decode_cuda.launch_count - launches0[1])
    checked = sum(r["checked"] for r in records)
    if checked and any(d.type == "cuda" for d in devs):
        for name, k in zip(("K2 (encode)", "K3 (decode)"), launches):
            if not k:
                fail(f"{name} was never launched")
    return {"trials": trials, "checked": checked, "failures": len(failures),
            "plain_calls": sum(q.calls for q in queues if q.device.type == "cpu"),
            "calls": sum(q.calls for q in queues), "launches": launches,
            "seconds": time.perf_counter() - t0, "records": records}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m x3_tpu_torch.tools.fuzz_differential",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=70)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--devices", default="cuda,cpu",
                    help="comma-separated devices, the first the reference (default cuda,cpu)")
    ap.add_argument("--geometries", default=None,
                    help="comma-separated GEOMETRIES indices whose trials are checked (default all)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    geos = None if args.geometries is None else {int(g) for g in args.geometries.split(",")}
    s = run_campaign(args.trials, args.seed, args.devices.split(","), geos, args.verbose)
    verdict = "ALL OK" if s["failures"] == 0 else f"{s['failures']} FAILURES"
    print(f"{s['trials']} trials ({s['checked']} checked) on {args.devices}, seed {args.seed}: {verdict}; "
          f"{s['calls']} decode calls ({s['plain_calls']} on the CPU), K2/K3 launches "
          f"{s['launches'][0]}/{s['launches'][1]}, {s['seconds']:.1f} s", flush=True)
    return 1 if s["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())

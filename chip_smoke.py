#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (x3_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs a GPU and nvcc
    python3 chip_smoke.py --profile  # phases 1-2, then where the slice's time goes

Phases (any failure raises and the exit code is non-zero):

1. device — the card's name and power limit (nvidia-smi), torch and CUDA;
2. build  — nvcc builds the three kernels from x3_tpu_torch/csrc/*.cu;
3. kernels against their plain PyTorch versions on the card, exact, for
   each corpus class at 768 frames: encode (K2) and CRC (K1) at the class's
   fitting width rung, the full rung and a compact rung that overflows;
   decode (K3) and CRC of the payloads, clean and mutated (byte flips,
   truncated lengths, random lanes that walk past the buffer);
4. the slice at full size: for each class, 6,144 frames (61.44 M samples)
   through x3_tpu_torch.encode, the archive container and
   decode_frames_batch with CRC checks; the roundtrip must be exact, the
   first frames must equal the numpy oracle's, and every kernel must have
   been launched by this phase;
5. at the main path's shapes (one 768-frame encoder batch at the class's
   rung; the whole 8,192-lane decode batch with its pad lanes), each kernel
   against its plain version, exact, and the device time of both (CUDA
   events).

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Without a usable GPU the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

from bench import make_class_corpus  # numpy only; absent outside the repository

N_FRAMES_CHECK = 768  # frames per kernel-vs-plain batch (the encoder's batch)
N_FRAMES_SLICE = 6144  # frames per class in the full-size slice
CLASSES = ("hydrophone", "music", "pi240")
SAMPLE_RATE = 96000
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    """A failed check (kept under python -O, unlike assert)."""
    if not cond:
        raise AssertionError(msg)


class Errs:
    """Largest |kernel - plain| seen per kernel (every comparison must be 0)."""

    def __init__(self):
        self.max = {}

    def check(self, kernel: str, got, want, what: str) -> None:
        import torch

        for i, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape:
                raise AssertionError(f"{what}: output {i} shape {tuple(g.shape)} != {tuple(w.shape)}")
            err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
            self.max[kernel] = max(self.max.get(kernel, 0), err)
            if err:
                raise AssertionError(f"{what}: output {i} differs from the plain version (max |d| {err})")


def cuda_ms(fn, reps: int = 20, warmup: int = 3):
    """(mean device milliseconds of fn() over `reps` launches, by CUDA
    events; the last call's output)."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def frames_of(corpus: np.ndarray, spf: int):
    """[F, S] frames with a partial, a one-sample and a dummy frame at the end."""
    frames = corpus.reshape(-1, spf).copy()
    n_valid = np.full(len(frames), spf, np.int32)
    n_valid[-1], n_valid[-2], n_valid[-3] = spf - 123, 1, 0
    frames[-1, spf - 123 :] = 0
    frames[-2, 1:] = 0
    frames[-3] = 0
    return frames, n_valid


def mutate(words, plens, n, spf, rng):
    """Corrupt copies of a decode batch: byte flips inside the payloads,
    truncated lengths (tail zeroed), and lanes of random words that claim a
    full frame, so their walk runs past the buffer."""
    import torch

    from x3_tpu_torch.ops._bits import as_i32, u32

    F, W = words.shape
    dev = words.device
    w = u32(words).cpu().numpy()
    plens = plens.cpu().numpy().copy()
    n = n.cpu().numpy().copy()
    by = w.astype(">u4").view(np.uint8).reshape(F, 4 * W).copy()
    lanes = rng.permutation(F)
    flip, trunc, junk = lanes[: F // 3], lanes[F // 3 : F // 2], lanes[F // 2 : F // 2 + F // 8]
    for f in flip:
        if plens[f] > 0:
            pos = rng.integers(0, plens[f], 4)
            by[f, pos] ^= rng.integers(1, 256, 4).astype(np.uint8)
    for f in trunc:
        plens[f] = rng.integers(0, plens[f] + 1)
        by[f, plens[f] :] = 0
    by[junk] = rng.integers(0, 256, (len(junk), 4 * W)).astype(np.uint8)
    plens[junk] = 4 * W
    n[junk] = spf
    w2 = by.view(">u4").astype(np.int64).reshape(F, W)
    return (as_i32(torch.from_numpy(w2)).to(dev), torch.from_numpy(plens).to(dev),
            torch.from_numpy(n).to(dev))


def phase_kernels(params, errs: Errs, rng) -> None:
    """Phase 3."""
    import torch

    from x3_tpu_torch.ops import crc_cuda, decode_cuda, encode_cuda
    from x3_tpu_torch.ops.encode_kernel import fits_width, frame_geometry, width_rungs

    S, _, _, WF = frame_geometry(params)
    for name in CLASSES:
        t0 = time.perf_counter()
        frames, n_valid = frames_of(make_class_corpus(name, N_FRAMES_CHECK, S, seed=11), S)
        st = torch.from_numpy(frames).to(DEV)
        nv = torch.from_numpy(n_valid).to(DEV)
        nbytes = encode_cuda.plain(st, nv, params, WF)[3].cpu().numpy()
        ladder = width_rungs(params)
        w_fit = next(r for r in ladder if fits_width(nbytes, r, params))
        i = ladder.index(w_fit)
        w_small = ladder[i - 1] if i else w_fit // 2
        require(not fits_width(nbytes, w_small, params), "compact rung must overflow")
        for W in (w_fit, WF, w_small):
            got = encode_cuda.encode_words_cuda(st, nv, params, W)
            want = encode_cuda.plain(st, nv, params, W)
            errs.check("encode", got, want, f"{name} encode W={W}")
            errs.check("crc16", [crc_cuda.crc16_words_cuda(got[0], got[3], W)],
                       [crc_cuda.plain(got[0], got[3], W)], f"{name} crc W={W}")
        fits = int((nbytes <= (w_small - 2) * 4).sum())

        words, _, _, nb_t, _ = encode_cuda.encode_words_cuda(st, nv, params, WF)
        words = words[:, :w_fit].contiguous()
        got = decode_cuda.decode_words_cuda(words, nv, nb_t, params)
        errs.check("decode", got, decode_cuda.plain(words, nv, nb_t, params), f"{name} decode")
        require(int(got[1].abs().max()) == 0, f"{name}: clean payloads reported decode errors")
        valid = torch.arange(S, device=DEV)[None, :] < nv[:, None]
        require(torch.equal(torch.where(valid, got[0], 0), st), f"{name}: decode != input")
        errs.check("crc16", [crc_cuda.crc16_words_cuda(words, nb_t, w_fit)],
                   [crc_cuda.plain(words, nb_t, w_fit)], f"{name} decode crc")

        mw, mplens, mn = mutate(words, nb_t, nv, S, rng)
        got = decode_cuda.decode_words_cuda(mw, mn, mplens, params)
        errs.check("decode", got, decode_cuda.plain(mw, mn, mplens, params), f"{name} decode mutated")
        errs.check("crc16", [crc_cuda.crc16_words_cuda(mw, mplens, w_fit)],
                   [crc_cuda.plain(mw, mplens, w_fit)], f"{name} crc mutated")
        n_err = int((got[1] != 0).sum())
        past = int((got[2] > w_fit * 32).sum())
        log(f"# phase 3 {name}: encode+crc exact at W={w_fit} (fits), {WF} (full), {w_small} "
            f"(compact: {fits}/{len(nbytes)} frames fit); decode+crc exact clean and mutated "
            f"({n_err} error lanes, {past} walked past W); {time.perf_counter() - t0:.1f} s")


def decode_batch_tensors(payloads, counts, params):
    """The decode batch decode_frames_batch walks for these payloads
    (models.decoder.payload_batch), as CUDA tensors."""
    import torch

    from x3_tpu_torch.models.decoder import payload_batch

    buf, ns, plens, n_blocks = payload_batch(payloads, counts, params)
    return (torch.from_numpy(buf).to(DEV), torch.from_numpy(ns).to(DEV),
            torch.from_numpy(plens).to(DEV), n_blocks)


def slice_once(params, samples, header):
    """encode -> archive -> frame walk -> checked decode; returns the
    encode result, the archive, the walked (payloads, counts, crcs), the
    decode outputs and the three wall times."""
    import torch

    import x3_tpu_torch as xt

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = xt.encode(samples, params, device=DEV)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    archive = header + res.data
    t0 = time.perf_counter()
    payloads, counts, crcs = [], [], []
    for off, h in xt.walk_frames(archive, len(header)):
        payloads.append(archive[off : off + h.payload_len])
        counts.append(h.samples)
        crcs.append(h.payload_crc)
    t_walk = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = xt.decode_frames_batch(payloads, counts, params, check_crcs=crcs, device=DEV)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    return res, archive, (payloads, counts, crcs), dec, (t_enc, t_walk, t_dec)


def phase_slice(params):
    """Phase 4: the main path at full size.  Returns per-class data for the
    timing phase."""
    import x3_tpu_torch as xt

    S = params.samples_per_frame
    header = xt.build_archive_header(SAMPLE_RATE, params)
    out = {}
    for name in CLASSES:
        samples = make_class_corpus(name, N_FRAMES_SLICE, S)
        mb = samples.nbytes / 1e6
        res, archive, (payloads, counts, _), (outs, err, crc_ok), (t_enc, t_walk, t_dec) = \
            slice_once(params, samples, header)
        require(len(outs) == N_FRAMES_SLICE, f"{name}: {len(outs)} frames")
        require(not err.any(), f"{name}: decode errors on {int((err != 0).sum())} frames")
        require(crc_ok.all(), f"{name}: CRC mismatch on {int((~crc_ok).sum())} frames")
        require(np.array_equal(np.concatenate(outs), samples), f"{name}: roundtrip differs")
        ref = xt.oracle.encode(samples[: 4 * S], params)
        require(res.data[: len(ref)] == ref, f"{name}: first 4 frames differ from the oracle")
        ratio = samples.nbytes / len(archive)
        log(f"# phase 4 {name}: {N_FRAMES_SLICE} frames ({mb:.2f} MB) exact roundtrip, CRCs ok, "
            f"oracle-equal head; ratio {ratio:.4f}; rungs W={res.width_used} "
            f"NW={res.block_width_used}; encode {mb / t_enc:.1f} MB/s ({t_enc:.3f} s), "
            f"decode {mb / t_dec:.1f} MB/s ({t_dec:.3f} s), frame walk {t_walk:.3f} s")
        out[name] = dict(samples=samples, payloads=payloads, counts=counts, w=res.width_used)
    return out


def phase_timing(params, slices, errs: Errs) -> dict:
    """Phase 5, at the main path's shapes (encode and CRC on one 768-frame
    encoder batch at the class's rung; decode and its CRC on the decode
    batch of 6,144 frames, pad lanes included): each kernel against its
    plain version (exact), and the device ms of both (CUDA events)."""
    import torch

    from x3_tpu_torch.ops import crc_cuda, decode_cuda, encode_cuda
    from x3_tpu_torch.ops.decode_kernel import payload_words
    from x3_tpu_torch.ops.encode_kernel import frame_geometry

    S = frame_geometry(params)[0]
    times = {}
    for name in CLASSES:
        d = slices[name]
        W = d["w"]
        st = torch.from_numpy(d["samples"][: N_FRAMES_CHECK * S].reshape(N_FRAMES_CHECK, S)).to(DEV)
        nv = torch.full((N_FRAMES_CHECK,), S, dtype=torch.int32, device=DEV)
        buf, ns, plens, n_blocks = decode_batch_tensors(d["payloads"], d["counts"], params)
        dwords = payload_words(buf)
        t, got, want = {}, {}, {}
        t["encode"], got["encode"] = cuda_ms(lambda: encode_cuda.encode_words_cuda(st, nv, params, W))
        t["encode_plain"], want["encode"] = cuda_ms(
            lambda: encode_cuda.plain(st, nv, params, W), reps=3, warmup=1)
        words, nbytes = got["encode"][0], got["encode"][3]
        t["crc16"], got["crc16"] = cuda_ms(lambda: crc_cuda.crc16_words_cuda(words, nbytes, W))
        t["crc16_plain"], want["crc16"] = cuda_ms(
            lambda: crc_cuda.plain(words, nbytes, W), reps=3, warmup=1)
        t["decode"], got["decode"] = cuda_ms(
            lambda: decode_cuda.decode_words_cuda(dwords, ns, plens, params, n_blocks))
        t["decode_plain"], want["decode"] = cuda_ms(
            lambda: decode_cuda.plain(dwords, ns, plens, params, n_blocks), reps=1, warmup=0)
        Wd = dwords.shape[1]
        t["crc16_dec"], got["crc16_dec"] = cuda_ms(lambda: crc_cuda.crc16_words_cuda(dwords, plens, Wd))
        t["crc16_dec_plain"], want["crc16_dec"] = cuda_ms(
            lambda: crc_cuda.plain(dwords, plens, Wd), reps=3, warmup=1)
        for k in ("encode", "decode"):
            errs.check(k, got[k], want[k], f"{name} {k} at the main path's shapes")
        for k in ("crc16", "crc16_dec"):
            errs.check("crc16", [got[k]], [want[k]], f"{name} {k} at the main path's shapes")
        mb_enc = N_FRAMES_CHECK * S * 2 / 1e6
        mb_dec = len(d["counts"]) * S * 2 / 1e6
        log(f"# phase 5 {name}: kernels equal their plain versions; "
            f"encode K2 {t['encode']:.4f} ms ([{N_FRAMES_CHECK}, {S}] W={W}, "
            f"{mb_enc / t['encode']:.1f} GB/s; plain {t['encode_plain']:.3f} ms), "
            f"crc K1 {t['crc16']:.4f} ms ([{N_FRAMES_CHECK}, {W}]; plain {t['crc16_plain']:.3f} ms), "
            f"decode K3 {t['decode']:.4f} ms ([{dwords.shape[0]}, {Wd}], "
            f"{mb_dec / t['decode']:.1f} GB/s; plain {t['decode_plain']:.1f} ms), "
            f"decode crc K1 {t['crc16_dec']:.4f} ms (plain {t['crc16_dec_plain']:.3f} ms)")
        times[name] = t
    return times


def phase_profile(params, top: int = 8) -> None:
    """--profile: where the slice's time goes, per class at full size.  For
    a warm encode and a warm checked decode: wall ms, then torch.profiler's
    device ops and cProfile's host functions, each by self time."""
    import cProfile
    import os
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import x3_tpu_torch as xt

    S = params.samples_per_frame
    header = xt.build_archive_header(SAMPLE_RATE, params)
    for name in CLASSES:
        samples = make_class_corpus(name, N_FRAMES_SLICE, S)
        mb = samples.nbytes / 1e6
        slice_once(params, samples, header)  # warm-up
        _, _, (payloads, counts, crcs), _, (t_enc, _, t_dec) = slice_once(params, samples, header)
        log(f"# profile {name}: encode {t_enc * 1e3:.3f} ms ({mb / t_enc:.1f} MB/s), "
            f"decode {t_dec * 1e3:.3f} ms ({mb / t_dec:.1f} MB/s), unprofiled wall")
        steps = (("encode", lambda: xt.encode(samples, params, device=DEV)),
                 ("decode", lambda: xt.decode_frames_batch(payloads, counts, params,
                                                           check_crcs=crcs, device=DEV)))
        for label, fn in steps:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            # Device-side rows only (kernels and copies): a CPU op's row
            # repeats its kernels' time, and CUPTI's buffer requests are
            # the profiler's own.
            ka = sorted((e for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and e.self_device_time_total
                         and not e.key.startswith("Activity Buffer")),
                        key=lambda e: e.self_device_time_total, reverse=True)
            dev_ms = sum(e.self_device_time_total for e in ka) / 1e3
            log(f"# profile {name} {label}: device {dev_ms:.3f} ms (kernels and copies)")
            for e in ka[:top]:
                log(f"#   device {e.key[:70]}: {e.self_device_time_total / 1e3:.3f} ms, "
                    f"{e.count} calls")
            pr = cProfile.Profile()
            pr.enable()
            fn()
            torch.cuda.synchronize()
            pr.disable()
            st = pstats.Stats(pr).sort_stats("tottime")
            for func in st.fcn_list[:top]:
                _, ncalls, tottime, _, _ = st.stats[func]
                path, line, fname = func
                log(f"#   host {fname} ({os.path.basename(path)}:{line}): {tottime * 1e3:.3f} ms self, "
                    f"{ncalls} calls")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to run on", file=sys.stderr)
        return 1
    # Phase 1: device.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    log(f"# phase 1 device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s); {'; '.join(smi)}")

    import x3_tpu_torch
    from x3_tpu_torch.ops import _build, crc_cuda, decode_cuda, encode_cuda

    params = x3_tpu_torch.Parameters()
    kernels = {"crc16": crc_cuda, "encode": encode_cuda, "decode": decode_cuda}

    # Phase 2: build.
    log(f"# phase 2 build: {', '.join(_build.KERNELS)} with nvcc for sm_90a in "
        f"{_build.build_all():.1f} s ({_build.build_dir()})")

    if "--profile" in sys.argv[1:]:
        phase_profile(params)
        return 0

    # Phase 3: kernels against their plain versions.
    errs = Errs()
    phase_kernels(params, errs, np.random.default_rng(20261016))

    # Phase 4: the main path; count only its launches.  A 4-frame run first
    # sets up what the first call would otherwise time (the host frame
    # assembler's native library, the CUDA caching allocator).
    slice_once(params, make_class_corpus(CLASSES[0], 4, params.samples_per_frame, seed=3),
               x3_tpu_torch.build_archive_header(SAMPLE_RATE, params))
    for mod in kernels.values():
        mod.launch_count = 0
    slices = phase_slice(params)
    launches = {k: mod.launch_count for k, mod in kernels.items()}
    log(f"# phase 4 launches: {launches}")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched by the main path")

    # Phase 5: kernels against their plain versions at the main path's
    # shapes, and their device times.
    times = phase_timing(params, slices, errs)
    first = times[CLASSES[0]]
    report = {"kernels": [
        {"name": k, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
         "launches": launches[k], "max_abs_err": errs.max.get(k, 0),
         "ms": first[k], "plain_ms": first[f"{k}_plain"]}
        for k, mod in kernels.items()
    ]}
    print(json.dumps(report))
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (x3_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs a GPU and nvcc
    python3 chip_smoke.py --profile  # phases 1-2, then where the time goes: K4-K6
                                     # alone, then the slice and x3a_to_wav
                                     # (wall ms, device rows, the device idle
                                     # share, host rows, the file decode's waits),
                                     # then x3a_to_wav_batch, decode_streams and
                                     # x3m_to_wav on phase 8's files and capture
    python3 chip_smoke.py --profile batch  # phases 1-2 and the last three alone

Phases (any failure raises and the exit code is non-zero):

1. device — the card's name and power limit (nvidia-smi), torch and CUDA;
2. build  — nvcc builds the six kernels from x3_tpu_torch/csrc/*.cu, one
   process per source, all started together;
3. kernels against their plain PyTorch versions on the card, exact, for
   each corpus class at 768 frames: encode (K2) and CRC (K1) at the class's
   fitting width rung, the full rung and a compact rung that overflows;
   decode (K3) and CRC of the payloads, clean and mutated (byte flips,
   truncated lengths, random lanes that walk past the buffer); then a K1
   sweep over junk rows of 1, 5, 131, 2,048 and 4,096 words, one frame and
   141 frames: every length residue mod 128, lengths 0-3, the full row,
   negative lengths and lengths past the row, and crc16_padded (K1 over
   zero-padded byte rows) of 1, 3, 4, 5, 131 and 8,190 bytes against its
   CPU route; then a K2 edge batch of 141
   frames of 287 samples with the n_valid edges 0, 1, 2, L, L+1, S-1 and
   S, at 1 and 8 words and the fitting, full and compact rungs; then a
   K5/K6 edge batch (pack_edges): K5 on 384,001 lanes of every item kind
   at nb4 1, 13 and 40, K6 on packed, gapped and overlapping frames at
   W = 8, compact, fitting and no-staging widths;
4. the slice at full size: for each class, 6,144 frames (61.44 M samples)
   through x3_tpu_torch.encode, the archive container and
   decode_frames_batch with CRC checks; the roundtrip must be exact, the
   first four frames must equal the port's own CPU encode of the same
   samples, the reference's golden frame (tests/data/golden.npz) must
   encode byte for byte, and K1-K3 must have been launched by this phase;
   then, after its launches are counted, the pipeline against a serial
   reference: every class's frames and a stream that escalates in its
   third batch through the one-batch-ahead encode, byte for byte equal to
   a loop of blocking read-backs, host byteswap and _assemble
   (serial_encode), and decode_frames_batch and decode_frames_flat on
   each class's payloads, clean and mutated, sample for sample equal to a
   blocking decode_frames_checked (serial_decode), err and crc_ok
   included;
5. at the main path's shapes (one 768-frame encoder batch at the class's
   rung; the whole 8,192-lane decode batch with its pad lanes), each kernel
   against its plain version, exact, and the device time of both (CUDA
   events);
6. the encoder's pack routes at full size: for each class, all 6,144
   frames in 768-frame batches at the class's rungs from phase 4 through
   encode_frames with pack_mode "block_pallas", "fused_pallas", "segment"
   and "block" by the pack walk K6 (X3_FUSED_ENCODE=0, X3_PALLAS_PACK=1)
   and by the torch pack (X3_PALLAS_PACK=0), each equal to the K2 route
   on every output (blockfit_bits aside under "segment"), K4-K6 launched;
   then on one 768-frame batch K4 (front), K5 (block pack) and K6 against
   their plain versions, exact, at the fitting rungs and at compact rungs
   that overflow, and the device time of each kernel and plain version;
7. the file layer (x3_tpu_torch.files) on the card, in a temporary
   directory (about 1.9 GB of disk): each class's 6,144-frame WAV (written
   by the port's WavWriter) through wav_to_x3a, whose archive must equal
   phase 4's byte for byte, and back through x3a_to_wav (the chunked
   stream), equal to the input and byte for byte to the walker's WAV
   (resync=True); verify_x3a and x3a_info against the walk; the MB/s of
   both directions and of the walker over three warm calls; x3a_to_wav of
   every class at 4, 8 and 16 MB chunks, a fresh process a size, with its
   peak RSS growth; then a one-hour 96 kHz hydrophone recording (34,560
   frames and a partial one, 691 MB, made in 6,144-frame chunks) through
   both directions, each in a fresh process (`--rss-child`) whose peak
   RSS growth (the kernel's peak where it moves, else the largest RSS
   sampled every millisecond) must stay under half the WAV's size; its
   head equal to the port's CPU encode, X3aReader's random access, and
   damage giving the reference's errors and counts (a payload byte of
   frame 1,000: FrameHeaderInvalidPayloadCRC naming frame 1000; a header
   byte of frame 2,000: FrameHeaderInvalidHeaderCRC); K1-K3 must have
   been launched by it;
8. multi-file batching and multichannel .x3m (x3_tpu_torch.multifile,
   multichannel), in a temporary directory (about 2.4 GB of disk): 256
   mono 96 kHz WAVs of the three classes, of lengths uniform in 1-480,000
   samples, and three of 0, 1 and 10,000 samples, through
   wav_to_x3a_batch (each archive equal to files.wav_to_x3a's) and
   x3a_to_wav_batch (each WAV equal to its input), encode_streams and
   decode_streams on the same arrays, the MB/s of three warm batch calls
   each way and of one pass of single-file calls; then a 4-channel
   20-minute hydrophone capture (4 x 11,520 frames and 3,333 samples,
   921.6 MB) through wav_to_x3m (each channel's archive equal to the
   port's encode of that channel) and x3m_to_wav (equal to the input),
   verify_x3m and x3m_info, x3m_to_wav in a fresh process with its peak
   RSS growth under half the WAV, a damaged payload byte in channel 2, a
   CRC mismatch and a decode error in windows 1 and 2 of two channels in
   each order (the window-1 frame's class and message, window 0 written),
   and the CLI's wav -> x3m -> wav on a 2-frame capture; K1-K3 must have
   been launched by it, and K1 no more often than K2 and K3 together (the
   decodes check their CRCs inside each call);
9. the mesh, the profiling hooks and a soak (x3_tpu_torch.parallel.mesh,
   entry, utils.profiling, tools.fuzz_soak): a mesh of every visible card
   and, on a one-card machine, meshes of two and four entries of cuda:0
   (an entry is a shard); each class's 6,144 frames through
   encode_frames_sharded and decode_frames_sharded at phase 4's rungs,
   equal to the unsharded calls key for key, the decode equal to the
   input; roundtrip_step and dryrun_multichip(4) exact; phase 8's 259
   WAVs through wav_to_x3a_batch / x3a_to_wav_batch with each mesh
   (archives equal to phase 8's, WAVs to the inputs; MB/s beside the
   calls without a mesh, not claimed) and encode_streams /
   decode_streams with each mesh equal to the calls without one;
   aot_compile(768) and the time of the next encode and decode, and a
   trace() of one encode and decode that must hold K1-K3 device rows; a
   short fuzz soak of K3 against its plain version (SOAK_TRIALS trials
   from SOAK_SEED); K1-K3 must have been launched by it;
10. the host tools and the examples (x3_tpu_torch.tools, examples/torch_*):
   tools.compile_sweep in a process of its own (a cold build of the six
   kernels into a new directory, then every (kernel, rung) the file
   pipeline dispatches); tools.fuzz_differential with --devices cuda,cpu
   (FUZZ_TRIALS trials from FUZZ_SEED, two at each of its nine
   geometries), a process beside the rest; tools.roundtrip_corpus's
   synthetic WAVs through the file layer on the card, each archive equal
   to the port's CPU encode; each torch example once on the card; then K2
   and K3 at block_len 1, 60 and 1,500 blocks a frame (TOOL_GEOMETRIES),
   K2 against its plain version, the decode equal to the input, with
   their device times; K1-K3 must have been launched by the corpus and
   the examples, and every tool must exit 0;
11. the port's bench (x3_tpu_torch.bench.run, what `python3 bench_torch.py`
   prints) at its defaults: per class the device encode and decode MB/s,
   the file MB/s each way and the exactness keys; every bit_exact,
   decode_exact and e2e_exact must be true, decode_parity_ok true (K3
   against its plain version on a mutated batch), the platform "cuda",
   and K1-K3 must have been launched by it.

The line before the last is a JSON object describing each kernel (with
its least time on the card from the bytes it must move, at 3.35 TB/s);
the last line is {"ok": true, "device": {...}}.  Without a usable GPU the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import wave
from pathlib import Path

import numpy as np

from x3_tpu_torch.bench import make_class_corpus  # absent outside the repository

N_FRAMES_CHECK = 768  # frames per kernel-vs-plain batch (the encoder's batch)
N_FRAMES_SLICE = 6144  # frames per class in the full-size slice
ENCODE_BATCH = 768  # frames per encode batch (x3_tpu_torch.encode's default); phase 4's serial loop's too
CLASSES = ("hydrophone", "music", "pi240")
SAMPLE_RATE = 96000
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM at 700 W (NVIDIA's data sheet)
HOUR_FRAMES = 34560  # phase 7: one hour of 96 kHz mono in 10,000-sample frames
HOUR_TAIL = 7777  # samples of the hour file's partial last frame
CHUNK_FRAMES = 6144  # the hour file is made and written this many frames at a time
CMP_SAMPLES = 4 << 20  # WAVs are compared this many samples at a time
CHUNK_SWEEP = (4 << 20, 8 << 20, 16 << 20)  # x3a_to_wav read sizes timed in phase 7
DAMAGED_FRAMES = (1000, 2000)  # phase 7: a payload byte, then a header byte, of these frames
MF_FILES = 256  # phase 8: WAVs batch-converted at once (BASELINE.json config 4)
MF_MAX_SAMPLES = 480_000  # their lengths are uniform in 1..this (5 s at 96 kHz)
MF_FIXED = (0, 1, 10_000)  # lengths of three more WAVs: empty, one sample, one frame
X3M_CHANNELS = 4  # phase 8: the multichannel capture (BASELINE.json config 5)
X3M_FRAMES = 11_520  # 20 minutes of 96 kHz in 10,000-sample frames
X3M_TAIL = 3_333  # samples of each channel's partial last frame
X3M_DAMAGED_CHANNEL = 2  # phase 8: the channel with a damaged payload byte
SOAK_TRIALS = 3  # phase 9: fuzz soak trials (each one plain decode call here)
SOAK_SEED = 2  # the soak's kinds rotate from the seed: hydrophone, music, noise
FUZZ_TRIALS = 18  # phase 10: fuzz_differential trials, two a geometry
FUZZ_SEED = 11
TOOL_GEOMETRIES = ((1, 16), (60, 5), (10, 1500))  # phase 10: (block_len, blocks_per_frame) K2 and K3 are timed at
TOOL_FRAMES = 768  # frames a batch there (the file layer's encode and decode batch)
PADDED_BYTES = (1, 3, 4, 5, 131, 8190)  # phase 3: row widths of crc16_padded
EXAMPLES = ("torch_01_file_conversion", "torch_02_streaming_capture", "torch_03_batch_and_mesh",
            "torch_04_multihost_pipeline")
ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "golden.npz"
ROUTES = {  # phase 6: route -> (pack_mode, environment); "K2" is the reference
    "K2": ("block", {"X3_FUSED_ENCODE": "1"}),
    "block_pallas": ("block_pallas", {}),
    "fused_pallas": ("fused_pallas", {}),
    "segment": ("segment", {}),
    "block-K6": ("block", {"X3_FUSED_ENCODE": "0", "X3_PALLAS_PACK": "1"}),
    "block-torch": ("block", {"X3_FUSED_ENCODE": "0", "X3_PALLAS_PACK": "0"}),
}


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


def bound_ms(n_bytes: int) -> float:
    """Least device ms to move n_bytes at the card's memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def with_env(env: dict, fn):
    """fn() with the variables of `env` set, restored afterwards."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def crc_edge_lengths(rng, W: int) -> np.ndarray:
    """int32 [141]: K1's edge lengths for rows of W words.  Every length
    residue mod 128 (from 12,800 bytes up where the row holds them:
    music-sized), 0-3, the full row, and negative and too-large lengths; an
    odd count, so the last CTA of four frame-warps is partly empty."""
    top = 4 * W
    hi = max((top - 127) // 128, 0)  # 128 k + 127 stays in the row (clamped in short rows)
    k = rng.integers(100 if top > 16000 else 0, hi + 1, 128)
    edges = [0, 1, 2, 3, top, top - 1, -1, -129, -(2**31), top + 1, top + 128, 2**31 - 1, top // 2]
    return np.concatenate([np.minimum(128 * k + np.arange(128), top), edges]).astype(np.int64).astype(np.int32)


def mixed_signal(rng, n: int) -> np.ndarray:
    """int16 [n]: silence, small and medium noise, BFP jumps, full-scale
    noise and a random walk, a sixth each: every block type."""
    seg = max(1, n // 6)
    parts = [
        np.zeros(seg),
        np.round(rng.normal(0, 1.2, seg)),
        np.round(rng.normal(0, 5, seg)),
        np.round(rng.normal(0, 400, seg)),
        rng.integers(-32768, 32768, seg),
        np.cumsum(rng.integers(-40, 41, n - 5 * seg)),
    ]
    return np.clip(np.concatenate(parts), -32768, 32767).astype(np.int16)[:n]


def k2_edge_batch(rng, params, F: int, noise: bool = False):
    """int16 [F, S] frames each of every block type (or all full-scale
    noise, the longest payloads) with the n_valid edges 0, 1, 2, L, L+1,
    S-1 and S on the last frames (zero past n_valid); int32 [F] n_valid."""
    S, L = params.samples_per_frame, params.block_len
    if noise:
        frames = rng.integers(-32768, 32768, (F, S)).astype(np.int16)
    else:
        frames = np.stack([mixed_signal(rng, S) for _ in range(F)])
    edges = [0, 1, 2, L, L + 1, S - 1, S]
    n_valid = np.full(F, S, np.int32)
    k = min(F, len(edges))
    n_valid[F - k :] = np.minimum(edges[len(edges) - k :], S)
    for f in range(F):
        frames[f, n_valid[f] :] = 0
    return frames, n_valid


def k2_edge_widths(params, nbytes) -> list[int]:
    """K2's edge widths for a batch: 1 and 8 words, the fitting rung, the
    full rung and a compact rung below the fitting one, which overflows."""
    from x3_tpu_torch.ops.encode_kernel import fits_width, frame_geometry, width_rungs

    WF = frame_geometry(params)[3]
    ladder = width_rungs(params)
    w_fit = next(r for r in ladder if fits_width(nbytes, r, params))
    i = ladder.index(w_fit)
    return sorted({1, 8, w_fit, WF, ladder[i - 1] if i else max(1, w_fit // 2)})


def k2_edges(errs: Errs, rng) -> None:
    """Phase 3's K2 edge batch: 141 frames of 287 samples (L=7, B=41: rows
    only 2-byte aligned on odd frames, a partial last wave of CTAs) with
    the n_valid edges, at widths of 1 and 8 words and the fitting, full and
    compact rungs."""
    import torch

    import x3_tpu_torch
    from x3_tpu_torch.ops import encode_cuda
    from x3_tpu_torch.ops.encode_kernel import frame_geometry

    t0 = time.perf_counter()
    params = x3_tpu_torch.Parameters(block_len=7, blocks_per_frame=41)
    frames, n_valid = k2_edge_batch(rng, params, 141)
    st = torch.from_numpy(frames).to(DEV)
    nv = torch.from_numpy(n_valid).to(DEV)
    WF = frame_geometry(params)[3]
    widths = k2_edge_widths(params, encode_cuda.plain(st, nv, params, WF)[3].cpu().numpy())
    for W in widths:
        errs.check("encode", encode_cuda.encode_words_cuda(st, nv, params, W),
                   encode_cuda.plain(st, nv, params, W), f"K2 edges W={W}")
    T, CH = encode_cuda.chunk_blocks(params.blocks_per_frame, params.block_len, WF)
    log(f"# phase 3 K2 edges: encode exact on 141 frames of L=7 B=41 (S=287; {T} threads, "
        f"{CH} blocks a chunk) with n_valid {sorted(set(n_valid.tolist()))} at W={widths}; "
        f"{time.perf_counter() - t0:.1f} s")


def _edge_items(rng, kinds: np.ndarray, n_items: int):
    """uint64 values and int64 lengths [len(kinds), n_items] of items (or
    pairs) of seven kinds: 0 random lengths 0-32 with values wider than
    their length; 1 all 32-bit; 2 lengths that end every second item on a
    word boundary (given a word-aligned start), then a zero-length item
    with a non-zero value; 3 all zero-length with non-zero values; 4
    well-formed (value < 2**length); 5 empty (zero lengths and values);
    6 lengths past the contract's 32 bits (33 to 1,000) among random ones."""
    n = len(kinds)
    lens = rng.integers(0, 33, (n, n_items))
    vals = rng.integers(0, 2**32, (n, n_items), dtype=np.uint64)
    lens[kinds == 1] = 32
    a = rng.integers(1, 32, (n, n_items))
    step = np.arange(n_items) % 3
    aligned = np.where(step == 0, a, np.where(step == 1, 32 - np.roll(a, 1, axis=1), 0))
    lens[kinds == 2] = aligned[kinds == 2]
    lens[kinds == 3] = 0
    vals[kinds == 3] |= 1
    wf = kinds == 4
    vals[wf] &= (np.uint64(1) << lens[wf].astype(np.uint64)) - np.uint64(1)
    lens[kinds == 5] = 0
    vals[kinds == 5] = 0
    wide = (kinds[:, None] == 6) & (rng.random((n, n_items)) < 0.3)
    lens[wide] = rng.choice([33, 40, 64, 254, 255, 256, 1000], int(wide.sum()))
    return vals, lens


def k5_edge_batch(rng, I: int, N: int):
    """K5's edge lanes (numpy int32): item_val and item_len [I, N], r2
    [1, N].  Lanes of every kind of `_edge_items`, shuffled so warps
    diverge (lengths past 32 bits make the window jump); offsets r2 word-aligned, 0, 31 or random below 256, and on a
    sixth of the lanes up to 48 words, so lanes skip slots and pieces drop
    past any nb4 up to 40."""
    kinds = rng.integers(0, 7, N)
    vals, lens = _edge_items(rng, kinds, I)
    r2 = rng.integers(0, 256, N)
    r2 = np.where(rng.random(N) < 0.3, r2 & ~31, r2)
    r2[kinds == 2] &= ~31
    r2[rng.random(N) < 0.05] = 0
    r2[rng.random(N) < 0.05] = 31
    far = rng.random(N) < 1 / 6
    r2[far] = rng.integers(0, 48 * 32, int(far.sum()))
    return (np.ascontiguousarray(vals.T).astype(np.uint32).view(np.int32),
            np.ascontiguousarray(lens.T).astype(np.int32), r2[None, :].astype(np.int32))


def k6_edge_batch(rng, F: int, B: int, P: int, layout: str = "packed"):
    """K6's edge frames (numpy int32): mval and mlen [F, B, P] with blocks
    of the kinds of `_edge_items`, and block_off [F, B].  Layouts:
    "packed", each block at the end of the one before (the encoder's);
    "gaps", random gaps between blocks, some word-aligned starts;
    "overlap", random offsets below the frame's bits (blocks overlap and
    go back); "wide", packed, with blocks of kind 6 (lengths past 32
    bits), which only this layout has."""
    kinds = rng.integers(0, 7 if layout == "wide" else 6, F * B)
    vals, lens = _edge_items(rng, kinds, P)
    mval = vals.astype(np.uint32).view(np.int32).reshape(F, B, P)
    mlen = lens.astype(np.int32).reshape(F, B, P)
    bits = mlen.sum(axis=2).astype(np.int64)
    if layout == "overlap":
        boff = rng.integers(0, max(1, int(bits.sum(axis=1).max())), (F, B))
    else:
        gap = rng.integers(0, 70, (F, B)) if layout == "gaps" else np.zeros((F, B), np.int64)
        align = (rng.random((F, B)) < 0.2) & (layout == "gaps")
        boff = np.zeros((F, B), np.int64)
        end = np.zeros(F, np.int64)
        for b in range(B):
            start = end + gap[:, b]
            boff[:, b] = np.where(align[:, b], (start + 31) & ~31, start)
            end = boff[:, b] + bits[:, b]
    return mval, mlen, boff.astype(np.int32)


K5_EDGES = [(nb4, I) for nb4 in (1, 13, 40) for I in (22, 9)]  # (nb4, items a lane)
K6_EDGES = {  # id -> (F, B, P, L, layout, W, shift): W "fit" or "compact" from the frames' bits
    "route-W8": (96, 500, 11, 20, "packed", 8, 0),
    "route-compact": (96, 500, 11, 20, "packed", "compact", 0),
    "route-fit": (96, 500, 11, 20, "packed", "fit", 0),
    "route-fit-shifted": (96, 500, 11, 20, "packed", "fit", 1),
    "gaps-shifted": (96, 41, 5, 7, "gaps", "fit", 3),
    "overlap": (96, 41, 5, 7, "overlap", "fit", 0),
    "nb-drops": (96, 40, 11, 4, "packed", "fit", 0),
    "wide": (96, 41, 5, 7, "wide", "fit", 0),
    "max": (4, 12, 11, 20, "packed", "max", 0),
    "max-gaps-shifted": (4, 12, 11, 20, "gaps", "max", 2),
    "max-less-one-shifted": (4, 12, 11, 20, "packed", "max-1", 1),
    "one-block": (4, 1, 3, 4, "packed", 8, 0),
}


def k6_edge_case(rng, case: str, frames: int | None = None):
    """(mval, mlen, block_off as numpy, W, L, shift) of K6_EDGES[case]
    (with `frames` frames where given): "fit" is the widest frame's words
    and two more, "compact" half of them (it overflows), "max" the
    wrapper's MAX_WORDS, "max-1" one word less (rows off a 16-byte
    boundary)."""
    from x3_tpu_torch.ops.pack_walk_cuda import MAX_WORDS

    F, B, P, L, layout, W, shift = K6_EDGES[case]
    mval, mlen, boff = k6_edge_batch(rng, frames or F, B, P, layout)
    need = int((boff.astype(np.int64) + mlen.sum(axis=2)).max()) // 32 + 2
    W = {"fit": need, "compact": max(8, need // 2), "max": MAX_WORDS, "max-1": MAX_WORDS - 1}.get(W, W)
    return mval, mlen, boff, W, L, shift


def on_device(a: np.ndarray, shift: int = 0):
    """`a` as a contiguous tensor on the card whose data starts `shift`
    elements past the start of its allocation (so 4*shift bytes off a
    16-byte boundary for int32)."""
    import torch

    flat = torch.zeros(a.size + shift, dtype=torch.from_numpy(a[:0]).dtype, device=DEV)
    flat[shift:] = torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(DEV)
    return flat[shift:].view(a.shape)


def pack_edges(errs: Errs, rng) -> None:
    """Phase 3's K5/K6 edge batch: K5 on 384,001 edge lanes (more than one
    wave of resident CTAs) at nb4 1, 13 and 40 and 22 or 9 items a lane;
    K6 on the edge frames of K6_EDGES."""
    from x3_tpu_torch.ops import pack_cuda, pack_walk_cuda

    t0 = time.perf_counter()
    for nb4, I in K5_EDGES:
        vals, lens, r2 = (on_device(a) for a in k5_edge_batch(rng, I, 384001))
        errs.check("pack_blocks", [pack_cuda.pack_blocks_cuda(vals, lens, r2, nb4)],
                   [pack_cuda.plain(vals, lens, r2, nb4)], f"K5 edges nb4={nb4} I={I}")
    for case in K6_EDGES:
        mval, mlen, boff, W, L, shift = k6_edge_case(rng, case)
        args = (on_device(mval, shift), on_device(mlen, shift), on_device(boff), W, L)
        errs.check("pack_walk", [pack_walk_cuda.pack_walk_cuda(*args)], [pack_walk_cuda.plain(*args)],
                   f"K6 edges {case} W={W}")
    log(f"# phase 3 pack edges: K5 exact on 384001 edge lanes at (nb4, I) {K5_EDGES}; K6 exact on "
        f"{', '.join(K6_EDGES)}; {time.perf_counter() - t0:.1f} s")


def crc_sweep(errs: Errs, rng) -> None:
    """Phase 3's K1 sweep: rows of random words (junk past every length) at
    crc_edge_lengths; all 141 lengths of a width in one batch, then the
    first alone."""
    import torch

    from x3_tpu_torch.ops import crc_cuda
    from x3_tpu_torch.ops.crc_torch import crc16_padded

    t0 = time.perf_counter()
    for W in (1, 5, 131, 2048, 4096):
        lens = crc_edge_lengths(rng, W)
        words = torch.from_numpy(rng.integers(-(2**31), 2**31, (len(lens), W)).astype(np.int32)).to(DEV)
        lengths = torch.from_numpy(lens).to(DEV)
        for F in (len(lens), 1):
            w, n = words[:F].contiguous(), lengths[:F].contiguous()
            errs.check("crc16", [crc_cuda.crc16_words_cuda(w, n, W)], [crc_cuda.plain(w, n, W)],
                       f"crc sweep W={W} F={F}")
    for n_bytes in PADDED_BYTES:
        lens = rng.integers(0, n_bytes + 1, 141).astype(np.int32)
        lens[:4] = 0, 1, n_bytes, n_bytes - 1 + n_bytes % 2  # empty, one byte, full, odd
        rows = rng.integers(0, 256, (len(lens), n_bytes), dtype=np.uint8)
        rows[np.arange(n_bytes)[None, :] >= lens[:, None]] = 0
        rows_t, lens_t = torch.from_numpy(rows), torch.from_numpy(lens)
        errs.check("crc16", [crc16_padded(rows_t.to(DEV), lens_t.to(DEV), n_bytes).cpu()],
                   [crc16_padded(rows_t, lens_t, n_bytes)], f"crc16_padded n_bytes={n_bytes}")
    log(f"# phase 3 crc sweep: K1 exact on junk rows of 1, 5, 131, 2048 and 4096 words, "
        f"F=141 and F=1, every length residue mod 128, 0-3, negative and past the row; "
        f"crc16_padded exact at {', '.join(map(str, PADDED_BYTES))} bytes; "
        f"{time.perf_counter() - t0:.1f} s")


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
        res, archive, (payloads, counts, crcs), (outs, err, crc_ok), (t_enc, t_walk, t_dec) = \
            slice_once(params, samples, header)
        require(len(outs) == N_FRAMES_SLICE, f"{name}: {len(outs)} frames")
        require(not err.any(), f"{name}: decode errors on {int((err != 0).sum())} frames")
        require(crc_ok.all(), f"{name}: CRC mismatch on {int((~crc_ok).sum())} frames")
        require(np.array_equal(np.concatenate(outs), samples), f"{name}: roundtrip differs")
        ref = xt.encode(samples[: 4 * S], params, device="cpu").data
        require(res.data[: len(ref)] == ref, f"{name}: first 4 frames differ from the CPU encode")
        ratio = samples.nbytes / len(archive)
        log(f"# phase 4 {name}: {N_FRAMES_SLICE} frames ({mb:.2f} MB) exact roundtrip, CRCs ok, "
            f"head equal to the CPU encode; ratio {ratio:.4f}; rungs W={res.width_used} "
            f"NW={res.block_width_used}; encode {mb / t_enc:.1f} MB/s ({t_enc:.3f} s), "
            f"decode {mb / t_dec:.1f} MB/s ({t_dec:.3f} s), frame walk {t_walk:.3f} s")
        out[name] = dict(samples=samples, archive=archive, payloads=payloads, counts=counts, crcs=crcs,
                         w=res.width_used, nw=res.block_width_used)
    golden = np.load(GOLDEN)
    got = xt.encode(golden["frame_wav"], xt.Parameters(), device=DEV).data
    require(got == golden["frame_expected"].tobytes(), "the golden frame differs from the reference's")
    log(f"# phase 4 golden: the reference's {len(got)}-byte frame encodes byte for byte")
    return out


def serial_encode(samples: np.ndarray, params, batch_frames: int):
    """Phase 4's reference encode, the port's loop before it ran one batch
    ahead: each batch on the card at the stream's sticky rungs, its sizes
    and words read back by blocking .cpu() calls, escalated and dispatched
    again, byteswapped and assembled on the host (_assemble).  Returns
    (frame stream, summed stats, (W, NW) rungs after each batch)."""
    import torch

    from x3_tpu_torch.models.encoder import _assemble, build_frame_headers
    from x3_tpu_torch.ops.encode_kernel import (
        block_width_rungs, encode_frames, fits_block_width, fits_width, width_rungs)

    S = params.samples_per_frame
    rungs, nw_rungs = width_rungs(params), block_width_rungs(params)
    rung = nw_rung = 0
    parts, stats, path = [], np.zeros(6, np.int64), []
    for start in range(0, len(samples), batch_frames * S):
        seg = samples[start : start + batch_frames * S]
        f = -(-len(seg) // S)
        batch = np.zeros((f, S), np.int16)
        batch.reshape(-1)[: len(seg)] = seg
        n_valid = np.full(f, S, np.int32)
        n_valid[-1] = len(seg) - (f - 1) * S
        st, nv = torch.from_numpy(batch).to(DEV), torch.from_numpy(n_valid).to(DEV)
        res = encode_frames(st, nv, params, "block", rungs[rung], nw_rungs[nw_rung])
        nbytes, blockfit = res["nbytes"].cpu().numpy(), res["blockfit_bits"].cpu().numpy()
        while nw_rung < len(nw_rungs) - 1 and not fits_block_width(blockfit, nw_rungs[nw_rung], params):
            nw_rung += 1
        if not fits_width(nbytes, rungs[rung], params):
            while rung < len(rungs) - 1 and not fits_width(nbytes, rungs[rung], params):
                rung += 1
            res = encode_frames(st, nv, params, "block", rungs[rung], nw_rungs[nw_rung])
            nbytes = res["nbytes"].cpu().numpy()
        payload = res["payload_words"].cpu().numpy().view(np.uint32).byteswap().view(np.uint8).reshape(f, -1)
        headers = build_frame_headers(n_valid, 1, nbytes, res["crc"].cpu().numpy())
        parts.append(_assemble(headers, payload, nbytes))
        stats += res["stats"].cpu().numpy().sum(axis=0, dtype=np.int64)
        path.append((rungs[rung], nw_rungs[nw_rung]))
    return b"".join(parts), stats, path


def serial_decode(payloads, counts, crcs, params):
    """Phase 4's reference decode: decode_frames_checked over payload_batch's
    zero-padded buffer, read back by blocking .cpu() calls.  Returns (per-
    frame samples, err, crc_ok)."""
    import torch

    from x3_tpu_torch.ops.decode_kernel import decode_frames_checked

    buf, ns, plens, n_blocks = decode_batch_tensors(payloads, counts, params)
    out, err, crc = (t.cpu().numpy() for t in decode_frames_checked(buf, ns, plens, params, n_blocks))
    f = len(payloads)
    return ([out[i, : counts[i]] for i in range(f)], err[:f],
            crc[:f] == np.asarray(crcs, dtype=np.int64))


def same_decode(got, want, flat, what: str) -> None:
    """The per-frame decode `got`, and `flat` (decode_frames_flat), equal
    the reference `want` sample for sample, err and crc_ok included."""
    require(len(got[0]) == len(want[0]), f"{what}: {len(got[0])} frames, want {len(want[0])}")
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        require(np.array_equal(g, w), f"{what}: frame {i} differs from the serial decode")
    require(np.array_equal(flat[0], np.concatenate(want[0])), f"{what}: decode_frames_flat differs")
    for k, name in ((1, "err"), (2, "crc_ok")):
        require(np.array_equal(got[k], want[k]) and np.array_equal(flat[k], want[k]),
                f"{what}: {name} differs from the serial decode")


def mixed_stream(params) -> np.ndarray:
    """Phase 4's escalating stream of ENCODE_BATCH-frame batches: two of
    pi240 (the 512-word rung), then hydrophone (2,048), music (4,096) and
    pi240 again, and a partial frame."""
    S = params.samples_per_frame
    parts = [make_class_corpus(name, ENCODE_BATCH, S, seed=40 + i)
             for i, name in enumerate(("pi240", "pi240", "hydrophone", "music", "pi240"))]
    return np.concatenate(parts + [make_class_corpus("music", 1, S, seed=46)[:1234]])


def phase_pipeline(params, slices, rng) -> None:
    """Phase 4, after the main path's launches are counted: the one-batch-
    ahead encode against serial_encode byte for byte (every class and an
    escalating stream), and decode_frames_batch and decode_frames_flat
    against serial_decode on each class's payloads, clean and mutated."""
    import torch

    import x3_tpu_torch as xt
    from x3_tpu_torch.models.decoder import decode_frames_flat
    from x3_tpu_torch.ops._bits import u32
    from x3_tpu_torch.ops.decode_kernel import payload_words

    t0 = time.perf_counter()
    S = params.samples_per_frame
    streams = {name: slices[name]["samples"] for name in CLASSES}
    streams["mixed"] = mixed_stream(params)
    for name, samples in streams.items():
        res = xt.encode(samples, params, ENCODE_BATCH, device=DEV)
        data, stats, path = serial_encode(samples, params, ENCODE_BATCH)
        require(res.data == data, f"{name}: the pipelined encode differs from the serial one")
        require(np.array_equal(res.stats, stats), f"{name}: stats differ from the serial encode")
        require((res.width_used, res.block_width_used) == path[-1],
                f"{name}: rungs {(res.width_used, res.block_width_used)}, serial {path[-1]}")
        if name == "mixed":
            require(path[1] == path[0] != path[2] != path[3],
                    f"the mixed stream does not escalate in its third batch: {path}")
    for name in CLASSES:
        d = slices[name]
        payloads, counts, crcs = d["payloads"], d["counts"], d["crcs"]
        want = serial_decode(payloads, counts, crcs, params)
        same_decode(xt.decode_frames_batch(payloads, counts, params, check_crcs=crcs, device=DEV), want,
                    decode_frames_flat(payloads, counts, params, check_crcs=crcs, device=DEV), f"{name} clean")
        buf, ns, plens, _ = decode_batch_tensors(payloads, counts, params)
        mw, mplens, mn = mutate(payload_words(buf), plens, ns, S, rng)
        f = len(payloads)
        by = u32(mw[:f]).cpu().numpy().astype(">u4").view(np.uint8).reshape(f, -1)
        mplens, mn = mplens[:f].cpu().numpy(), mn[:f].cpu().numpy().tolist()
        mpay = [by[i, : mplens[i]].tobytes() for i in range(f)]
        want = serial_decode(mpay, mn, crcs, params)
        require(want[1].any() and not want[2].all(), f"{name}: the mutated batch has no error lanes")
        same_decode(xt.decode_frames_batch(mpay, mn, params, check_crcs=crcs, device=DEV), want,
                    decode_frames_flat(mpay, mn, params, check_crcs=crcs, device=DEV), f"{name} mutated")
        torch.cuda.synchronize()
    log(f"# phase 4 pipeline: encode equal to the serial loop byte for byte for {', '.join(streams)} "
        f"(mixed: rungs {' -> '.join(f'{w}/{nw}' for w, nw in path)}); decode_frames_batch and "
        f"decode_frames_flat equal to a blocking decode_frames_checked, clean and mutated, every class; "
        f"{time.perf_counter() - t0:.1f} s")


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
        # Least bytes each kernel must move: every input read once, every
        # output written once; the CRC and the walk read only the payload
        # bytes this batch holds (the CRC's own tables are its design's, not
        # the function's, and are not counted).
        t["encode_bound"] = bound_ms(nbytes_of(st, nv, *got["encode"]))
        t["crc16_bound"] = bound_ms(int(nbytes.clamp(0, 4 * W).sum()) + nbytes_of(nbytes, got["crc16"]))
        t["crc16_dec_bound"] = bound_ms(int(plens.clamp(0, 4 * Wd).sum())
                                        + nbytes_of(plens, got["crc16_dec"]))
        t["decode_bound"] = bound_ms(int(plens.sum()) + nbytes_of(ns, plens, *got["decode"]))
        mb_enc = N_FRAMES_CHECK * S * 2 / 1e6
        mb_dec = len(d["counts"]) * S * 2 / 1e6
        log(f"# phase 5 {name}: kernels equal their plain versions; "
            f"encode K2 {t['encode']:.4f} ms ([{N_FRAMES_CHECK}, {S}] W={W}, "
            f"{mb_enc / t['encode']:.1f} GB/s; plain {t['encode_plain']:.3f} ms), "
            f"crc K1 {t['crc16']:.4f} ms ([{N_FRAMES_CHECK}, {W}]; plain {t['crc16_plain']:.3f} ms, "
            f"bound {t['crc16_bound']:.4f} ms), "
            f"decode K3 {t['decode']:.4f} ms ([{dwords.shape[0]}, {Wd}], "
            f"{mb_dec / t['decode']:.1f} GB/s; plain {t['decode_plain']:.1f} ms), "
            f"decode crc K1 {t['crc16_dec']:.4f} ms (plain {t['crc16_dec_plain']:.3f} ms, "
            f"bound {t['crc16_dec_bound']:.4f} ms)")
        times[name] = t
    return times


def route_batch(params, name: str) -> dict:
    """Phase 6's batch of a class, the batch of phase 3 (a partial, a
    one-sample and a dummy frame at the end), in the pack routes' tensors:
    K4's lanes and its outputs (from the kernel), K5's r2, K6's pairs and
    block offsets, and the fitting W and NW rungs and the rungs below
    them, which overflow."""
    import torch

    from x3_tpu_torch.ops import front_cuda
    from x3_tpu_torch.ops._bits import as_i32
    from x3_tpu_torch.ops.encode_kernel import (
        GR, _block_layout, _nbytes, _pairs, block_width_rungs, fits_block_width, fits_width,
        frame_geometry, front_lanes, width_rungs)

    S, B, _, _ = frame_geometry(params)
    frames, n_valid = frames_of(make_class_corpus(name, N_FRAMES_CHECK, S, seed=11), S)
    F = len(frames)
    st = torch.from_numpy(frames).to(DEV)
    nv = torch.from_numpy(n_valid).to(DEV)
    lanes = front_lanes(st, nv, params)
    front = front_cuda.encode_front_cuda(*lanes, params)
    vals, lens, _ = front
    block_off, total_bits, blockfit = _block_layout(lens.to(torch.int64).sum(dim=0).reshape(F, B))
    r2 = (block_off & (32 * GR - 1)).reshape(1, -1).to(torch.int32)
    nbytes, blockfit = _nbytes(total_bits).cpu().numpy(), blockfit.cpu().numpy()
    w_ladder, nw_ladder = width_rungs(params), block_width_rungs(params)
    w_fit = next(r for r in w_ladder if fits_width(nbytes, r, params))
    nw_fit = next(r for r in nw_ladder if fits_block_width(blockfit, r, params))
    w_small = w_ladder[w_ladder.index(w_fit) - 1] if w_fit != w_ladder[0] else w_fit // 2
    nw_small = nw_ladder[nw_ladder.index(nw_fit) - 1] if nw_fit != nw_ladder[0] else 1
    require(not fits_width(nbytes, w_small, params), "compact W rung must overflow")
    require(not fits_block_width(blockfit, nw_small, params), "compact NW rung must overflow")
    iv = vals.to(torch.int64).reshape(-1, F, B).permute(1, 2, 0) & 0xFFFFFFFF
    il = lens.to(torch.int64).reshape(-1, F, B).permute(1, 2, 0)
    mval, mlen = _pairs(iv, il)
    return dict(n_valid=n_valid, lanes=lanes, front=front, r2=r2, mval=as_i32(mval).contiguous(),
                mlen=mlen.to(torch.int32).contiguous(), boff=block_off.to(torch.int32),
                w_fit=w_fit, w_small=w_small, nw_fit=nw_fit, nw_small=nw_small)


def phase_routes(params, slices, errs: Errs, route_mods: dict) -> tuple[dict, dict]:
    """Phase 6: the encoder's pack routes at full size, then K4-K6 against
    their plain versions on one batch per class, and their device times.
    Returns (launches of K4-K6 in the full-size run, times of the first
    class)."""
    import torch

    from x3_tpu_torch.ops import front_cuda, pack_cuda, pack_walk_cuda
    from x3_tpu_torch.ops.encode_kernel import GR, encode_frames, frame_geometry

    S, B, L, _ = frame_geometry(params)
    # (i) every route equals the K2 route on all frames of every class.
    for mod in route_mods.values():
        mod.launch_count = 0
    t0 = time.perf_counter()
    for name in CLASSES:
        d = slices[name]
        frames = d["samples"].reshape(-1, S)
        nv = torch.full((N_FRAMES_CHECK,), S, dtype=torch.int32, device=DEV)
        for base in range(0, len(frames), N_FRAMES_CHECK):
            st = torch.from_numpy(frames[base : base + N_FRAMES_CHECK]).to(DEV)
            outs = {r: with_env(env, lambda: encode_frames(st, nv, params, mode, d["w"], d["nw"]))
                    for r, (mode, env) in ROUTES.items()}
            for r, out in outs.items():
                for k, v in out.items():
                    if k == "blockfit_bits" and r == "segment":
                        continue
                    require(torch.equal(v, outs["K2"][k]),
                            f"{name} frames {base}+: route {r} differs from K2 in {k}")
    torch.cuda.synchronize()
    launches = {k: mod.launch_count for k, mod in route_mods.items()}
    log(f"# phase 6 routes: {', '.join(ROUTES)} equal on all {N_FRAMES_SLICE} frames of each "
        f"class at the phase 4 rungs; launches {launches}; {time.perf_counter() - t0:.1f} s")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched by the pack routes")

    # (ii) K4-K6 against their plain versions; (iii) their device times.
    first = None
    for name in CLASSES:
        b = route_batch(params, name)
        lanes, (vals, lens, _), r2 = b["lanes"], b["front"], b["r2"]
        mval, mlen, boff = b["mval"], b["mlen"], b["boff"]
        w_fit, w_small, nw_fit, nw_small = b["w_fit"], b["w_small"], b["nw_fit"], b["nw_small"]
        F = len(b["n_valid"])
        errs.check("front", b["front"], front_cuda.plain(*lanes, params), f"{name} front")
        for nw in (nw_fit, nw_small):
            args = (vals, lens, r2, nw + GR - 1)
            errs.check("pack_blocks", [pack_cuda.pack_blocks_cuda(*args)], [pack_cuda.plain(*args)],
                       f"{name} pack_blocks NW={nw}")
        for W in (w_fit, w_small):
            args = (mval, mlen, boff, W, L)
            errs.check("pack_walk", [pack_walk_cuda.pack_walk_cuda(*args)],
                       [pack_walk_cuda.plain(*args)], f"{name} pack_walk W={W}")

        t = {}
        nb4 = nw_fit + GR - 1
        t["front"], out = cuda_ms(lambda: front_cuda.encode_front_cuda(*lanes, params))
        t["front_plain"], _ = cuda_ms(lambda: front_cuda.plain(*lanes, params), reps=3, warmup=1)
        t["front_bound"] = bound_ms(nbytes_of(*lanes, *out))
        t["pack_blocks"], out = cuda_ms(lambda: pack_cuda.pack_blocks_cuda(vals, lens, r2, nb4))
        t["pack_blocks_plain"], _ = cuda_ms(lambda: pack_cuda.plain(vals, lens, r2, nb4), reps=3, warmup=1)
        t["pack_blocks_bound"] = bound_ms(nbytes_of(vals, lens, r2, out))
        t["pack_walk"], out = cuda_ms(lambda: pack_walk_cuda.pack_walk_cuda(mval, mlen, boff, w_fit, L))
        t["pack_walk_plain"], _ = cuda_ms(lambda: pack_walk_cuda.plain(mval, mlen, boff, w_fit, L),
                                          reps=3, warmup=1)
        t["pack_walk_bound"] = bound_ms(nbytes_of(mval, mlen, boff, out))
        log(f"# phase 6 {name}: K4-K6 equal their plain versions at the fitting W={w_fit}/NW={nw_fit} "
            f"and the overflowing W={w_small}/NW={nw_small}; device ms (plain, bound): front K4 "
            f"{t['front']:.4f} ({t['front_plain']:.3f}, {t['front_bound']:.4f}) [{L}, {F * B}], "
            f"pack_blocks K5 {t['pack_blocks']:.4f} ({t['pack_blocks_plain']:.3f}, "
            f"{t['pack_blocks_bound']:.4f}) nb4={nb4}, pack_walk K6 {t['pack_walk']:.4f} "
            f"({t['pack_walk_plain']:.3f}, {t['pack_walk_bound']:.4f}) [{F}, {B}, {mval.shape[2]}] "
            f"W={w_fit}")
        first = first or t
    return launches, first


def rss_now() -> int:
    """The process's resident set in bytes (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def rss_peak() -> int:
    """The process's peak resident set in bytes (getrusage; 0 where the
    kernel does not keep it)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class RssSampler:
    """The largest rss_now() seen, every `period` seconds on a thread, while
    the `with` block runs."""

    def __init__(self, period: float = 0.001):
        self.period, self.peak = period, rss_now()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.peak = max(self.peak, rss_now())
            time.sleep(self.period)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, rss_now())


def rss_child(argv) -> int:
    """--rss-child DIRECTION SRCS DSTS BATCH RUNS WARM_SRC WARM_DST CHUNK, in
    a fresh process: one small conversion (WARM_SRC -> WARM_DST) loads the
    kernels and sets up the allocators, then for each of the SRCS in turn
    (paths joined by os.pathsep) RUNS timed conversions to the DSTS entry
    beside it (DIRECTION "encode": wav_to_x3a, "decode": x3a_to_wav, "x3m":
    x3m_to_wav), with x3a_to_wav's read size set to CHUNK bytes unless it
    is "default"; prints the wall times, source by source, the RSS and the
    peak RSS before them, the peak RSS after them and the largest RSS
    sampled during them, as JSON."""
    from x3_tpu_torch import files, multichannel

    direction, srcs, dsts, batch, runs, warm_src, warm_dst, chunk = argv
    fn, want = {"encode": (files.wav_to_x3a, None), "decode": (files.x3a_to_wav, 0),
                "x3m": (multichannel.x3m_to_wav, X3M_CHANNELS)}[direction]
    if chunk != "default":
        files._CHUNK_BYTES = int(chunk)
    kw = dict(batch_frames=None if batch == "default" else int(batch), device=DEV)
    fn(warm_src, warm_dst, **kw)
    rss0, peak0 = rss_now(), rss_peak()
    times = []
    with RssSampler() as sampler:
        for src, dst in zip(srcs.split(os.pathsep), dsts.split(os.pathsep)):
            for _ in range(int(runs)):
                t, out = timed_call(lambda: fn(src, dst, **kw))
                require(want is None or out == want, f"{direction} {src}: returned {out}, want {want}")
                times.append(t)
    print(json.dumps({"times": times, "rss0": rss0, "peak0": peak0, "peak": rss_peak(),
                      "sampled": sampler.peak}))
    return 0


def rss_run(direction: str, src, dst, warm: tuple, batch="default", runs: int = 1, chunk="default") -> dict:
    """rss_child in a fresh interpreter (a process's peak RSS cannot be
    reset in place everywhere); src and dst are a path or a list of paths.
    Adds "growth" in MB over the RSS before the runs: from the kernel's
    peak RSS where the runs set a new peak for the process ("how":
    "peak"), else from the largest RSS sampled every millisecond during
    them ("how": "sampled")."""
    paths = lambda p: os.pathsep.join(map(str, p if isinstance(p, (list, tuple)) else [p]))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--rss-child", direction, paths(src), paths(dst),
           str(batch), str(runs), str(warm[0]), str(warm[1]), str(chunk)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    require(out.returncode == 0, f"rss child {direction} {src}: exit {out.returncode}\n{out.stderr[-3000:]}")
    d = json.loads(out.stdout.strip().splitlines()[-1])
    exact = d["peak"] > d["peak0"]
    d["how"] = "peak" if exact else "sampled"
    d["growth"] = ((d["peak"] if exact else d["sampled"]) - d["rss0"]) / 1e6
    return d


def timed_call(fn):
    """(wall seconds of fn() ending in torch.cuda.synchronize(), its result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def wav_samples(path, start: int, count: int) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        w.setpos(start)
        return np.frombuffer(w.readframes(count), dtype="<i2")


def wav_length(path) -> int:
    with wave.open(str(path), "rb") as w:
        return w.getnframes()


def same_samples(a, a_start: int, b, b_start: int, count: int) -> bool:
    """Samples [a_start, +count) of WAV a equal [b_start, +count) of WAV b,
    compared CMP_SAMPLES at a time."""
    for k in range(0, count, CMP_SAMPLES):
        n = min(CMP_SAMPLES, count - k)
        x, y = wav_samples(a, a_start + k, n), wav_samples(b, b_start + k, n)
        if len(x) != n or not np.array_equal(x, y):
            return False
    return True


def same_wav(a, b) -> bool:
    """Two WAV files with the same header and samples."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read(44) != fb.read(44):
            return False
    return same_samples(a, 0, b, 0, wav_length(a))


def write_class_wav(path, samples: np.ndarray) -> None:
    from x3_tpu_torch.utils.wav import WavWriter

    with WavWriter(path, SAMPLE_RATE) as w:
        w.write(samples)


def check_archive(path, n_frames: int, n_samples: int, what: str) -> list:
    """verify_x3a and x3a_info of a clean archive against its frame walk;
    returns the walk's (payload_offset, FrameHeader) index."""
    from x3_tpu_torch import archive, files

    with open(path, "rb") as f:
        _, header_size = archive.read_archive_header_file(f)
        index = list(archive.walk_frames_file(f, header_size))
    rep = files.verify_x3a(path, device=DEV)
    require(rep["ok"] and rep["frame_errors"] == 0 and rep["skipped_bytes"] == 0
            and rep["n_frames"] == n_frames == len(index) and rep["n_samples_ok"] == n_samples,
            f"{what}: verify_x3a reports {rep}")
    info = files.x3a_info(path, device=DEV)
    walked = (len(index), sum(h.samples for _, h in index), sum(h.payload_len for _, h in index))
    require((info["n_frames"], info["n_samples"], info["payload_bytes"]) == walked,
            f"{what}: x3a_info {info} disagrees with the walk {walked}")
    return index


def phase_files_class(name: str, d: dict, td: Path, smi: str) -> str:
    """Phase 7 for one class's 6,144-frame corpus: the archive equals phase
    4's, the roundtrip is exact, x3a_to_wav's chunked stream gives the
    walker's WAV (resync=True) byte for byte, verify and info agree with
    the walk, and the MB/s of three warm calls of each (the check call is
    the warm one).  Leaves the WAV and the archive in `td` for the chunk
    sweep.  Returns the MB/s, as text."""
    from x3_tpu_torch import files

    samples = d["samples"]
    mb = samples.nbytes / 1e6
    src, x3a, back, walked = (td / f"{name}.wav", td / f"{name}.x3a", td / f"{name}.back.wav",
                              td / f"{name}.walked.wav")
    write_class_wav(src, samples)
    files.wav_to_x3a(src, x3a, device=DEV)
    require(x3a.read_bytes() == d["archive"], f"{name}: wav_to_x3a differs from phase 4's archive")
    require(files.x3a_to_wav(x3a, back, device=DEV) == 0, f"{name}: x3a_to_wav reported frame errors")
    require(same_wav(back, src), f"{name}: x3a_to_wav differs from the input WAV")
    require(files.x3a_to_wav(x3a, walked, resync=True, device=DEV) == 0, f"{name}: the walker reported errors")
    require(same_file(back, walked), f"{name}: x3a_to_wav's stream and the walker's WAV differ")
    check_archive(x3a, len(d["counts"]), len(samples), name)
    enc = [timed_call(lambda: files.wav_to_x3a(src, x3a, device=DEV))[0] for _ in range(3)]
    dec = [timed_call(lambda: files.x3a_to_wav(x3a, back, device=DEV))[0] for _ in range(3)]
    walk = [timed_call(lambda: files.x3a_to_wav(x3a, walked, resync=True, device=DEV))[0] for _ in range(3)]
    require(x3a.read_bytes() == d["archive"] and same_wav(back, src) and same_file(back, walked),
            f"{name}: timed calls differ")
    walked.unlink()
    back.unlink()
    rates = (f"wav_to_x3a {mb / max(enc):.1f}-{mb / min(enc):.1f} MB/s, "
             f"x3a_to_wav {mb / max(dec):.1f}-{mb / min(dec):.1f} MB/s "
             f"(the walker, resync=True: {mb / max(walk):.1f}-{mb / min(walk):.1f})")
    log(f"# phase 7 {name}: {len(d['counts'])} frames ({mb:.2f} MB int16) exact through wav_to_x3a "
        f"(= phase 4's archive) and x3a_to_wav (= the walker's WAV byte for byte); verify_x3a ok; "
        f"x3a_info = walk; {rates} (min-max of 3 warm calls); {smi}")
    return rates


def chunk_sweep(slices, td: Path, smi: str, warm: dict) -> dict:
    """x3a_to_wav at each read size of CHUNK_SWEEP, one fresh process a
    size decoding every class's archive three times: each output equal to
    its input, the wall times a class and the process's peak RSS growth.
    Returns {chunk: (seconds a class, growth in MB)}."""
    names = list(CLASSES)
    srcs = [td / f"{n}.wav" for n in names]
    x3as = [td / f"{n}.x3a" for n in names]
    backs = [td / f"{n}.sweep.wav" for n in names]
    sweep = {}
    for chunk in CHUNK_SWEEP:
        r = rss_run("decode", x3as, backs, warm["decode"], runs=3, chunk=chunk)
        for back, src in zip(backs, srcs):
            require(same_wav(back, src), f"x3a_to_wav at {chunk}-byte chunks differs from {src.name}")
        times = {n: r["times"][3 * i : 3 * i + 3] for i, n in enumerate(names)}
        sweep[chunk] = (times, r["growth"])
        log(f"# phase 7 chunk sweep {chunk >> 20} MB: "
            + "; ".join(f"{n} " + ", ".join(f"{slices[n]['samples'].nbytes / 1e6 / t:.1f}" for t in ts)
                        for n, ts in times.items())
            + f" MB/s (3 calls each); peak RSS growth {r['growth']:.1f} MB ({r['how']}; a fresh process, "
            f"all three classes); {smi}")
    for p in (*srcs, *x3as, *backs):
        p.unlink()
    return sweep


def hour_rss_bound(params) -> float:
    """Phase 7's bound on a conversion's peak RSS growth, in MB: half the
    hour file's int16 samples (HOUR_FRAMES frames; the tail aside)."""
    return HOUR_FRAMES * params.samples_per_frame * 2 / 1e6 / 2


def write_hour_wav(path, params) -> np.ndarray:
    """The hour file: HOUR_FRAMES frames of the hydrophone class in
    CHUNK_FRAMES-frame chunks, each from its own seed, and a partial frame
    of HOUR_TAIL samples; never whole in memory.  Returns the first 768
    frames' samples."""
    from x3_tpu_torch.utils.wav import WavWriter

    S = params.samples_per_frame
    head = None
    with WavWriter(path, SAMPLE_RATE) as w:
        for i, base in enumerate(range(0, HOUR_FRAMES, CHUNK_FRAMES)):
            chunk = make_class_corpus("hydrophone", min(CHUNK_FRAMES, HOUR_FRAMES - base), S, seed=100 + i)
            head = chunk[: N_FRAMES_CHECK * S].copy() if head is None else head
            w.write(chunk)
            del chunk
        w.write(make_class_corpus("hydrophone", 1, S, seed=99)[:HOUR_TAIL])
    return head


def phase_files_hour(params, td: Path, smi: str, warm: dict) -> tuple[float, float]:
    """Phase 7's hour file: both directions with bounded peak RSS, the head
    against the CPU encode, verify/info, X3aReader and the damage tests.
    Returns the peak RSS growths (MB) of the encode and the decode."""
    import x3_tpu_torch as xt
    from x3_tpu_torch import files
    from x3_tpu_torch.engine import DECODE_BATCH_FRAMES
    from x3_tpu_torch.errors import FrameHeaderInvalidHeaderCRC, FrameHeaderInvalidPayloadCRC

    S = params.samples_per_frame
    n_frames, n = HOUR_FRAMES + 1, HOUR_FRAMES * S + HOUR_TAIL
    src, x3a, back = td / "hour.wav", td / "hour.x3a", td / "hour.back.wav"
    head = write_hour_wav(src, params)
    mb = 2 * n / 1e6
    bound = hour_rss_bound(params)

    enc = rss_run("encode", src, x3a, warm["encode"])
    dec = rss_run("decode", x3a, back, warm["decode"])
    (t_enc,), (t_dec,), g_enc, g_dec = enc["times"], dec["times"], enc["growth"], dec["growth"]
    require(same_wav(back, src), "hour: the roundtrip differs from the input")
    back.unlink()
    require(g_enc < bound and g_dec < bound,
            f"hour: peak RSS growth {g_enc:.1f} MB (encode) / {g_dec:.1f} MB (decode), bound {bound:.1f} MB")
    header = xt.build_archive_header(SAMPLE_RATE, params)
    ref = header + xt.encode(head, params, device="cpu").data
    with open(x3a, "rb") as f:
        require(f.read(len(ref)) == ref, "hour: the first 768 frames differ from the CPU encode")
    index = check_archive(x3a, n_frames, n, "hour")
    log(f"# phase 7 hour: {n_frames} frames ({mb:.2f} MB int16, the last {HOUR_TAIL} samples) exact "
        f"through wav_to_x3a {mb / t_enc:.1f} MB/s and x3a_to_wav {mb / t_dec:.1f} MB/s (one call each, "
        f"each in a fresh process); peak RSS growth {g_enc:.1f} MB encode ({enc['how']}), {g_dec:.1f} MB "
        f"decode ({dec['how']}; bound {bound:.1f} MB); "
        f"head = CPU encode; verify_x3a ok; x3a_info = walk; {smi}")

    # X3aReader: a range across a decode-batch boundary, the partial last
    # frame, and a seek followed by a sequential read.
    with files.X3aReader(x3a, device=DEV) as r:
        B = DECODE_BATCH_FRAMES
        start = B * S - 12345
        require(np.array_equal(r.read_samples(start, 30000), wav_samples(src, start, 30000)),
                "hour: X3aReader.read_samples across a batch boundary")
        last = r.decode_frame_at(n_frames - 1)
        require(len(last) == HOUR_TAIL and np.array_equal(last, wav_samples(src, HOUR_FRAMES * S, HOUR_TAIL)),
                "hour: X3aReader.decode_frame_at of the partial last frame")
        r.seek_frame(3 * B + 7)
        for k in (3 * B + 7, 3 * B + 8):
            require(np.array_equal(r.decode_next_frame(), wav_samples(src, k * S, S)),
                    f"hour: X3aReader.decode_next_frame after seek_frame, frame {k}")

    # Damage: one payload byte of a frame, then (that byte restored) one
    # header byte of a later frame.
    fp, fh = DAMAGED_FRAMES
    bad = td / "hour.bad.x3a"
    shutil.copyfile(x3a, bad)
    x3a.unlink()
    off = index[fp][0] + 10

    def flip(pos: int) -> None:
        with open(bad, "r+b") as f:
            f.seek(pos)
            byte = f.read(1)[0]
            f.seek(pos)
            f.write(bytes([byte ^ 0x10]))

    def raised_by(cls, fn):
        try:
            fn()
        except cls as e:
            return e
        return None

    flip(off)
    raised = raised_by(FrameHeaderInvalidPayloadCRC, lambda: files.x3a_to_wav(bad, back, device=DEV))
    require(raised is not None, "hour: a flipped payload byte did not raise FrameHeaderInvalidPayloadCRC")
    require(str(raised) == f"frame {fp} payload CRC mismatch",
            f"hour: the payload CRC error of frame {fp} reads {str(raised)!r}")
    require(files.x3a_to_wav(bad, back, resync=True, device=DEV) == 1, "hour: resync did not count 1 error")
    require(wav_length(back) == n - S and same_samples(back, 0, src, 0, fp * S)
            and same_samples(back, fp * S, src, (fp + 1) * S, n - (fp + 1) * S),
            f"hour: the resync WAV is not the input without frame {fp}")
    back.unlink()
    rep = files.verify_x3a(bad, device=DEV)
    require(rep["frame_errors"] == 1 and rep["ok"] is False and rep["n_frames"] == n_frames,
            f"hour: verify_x3a on a flipped payload byte reports {rep}")
    flip(off)
    flip(index[fh][0] - 20 + 5)
    raised2 = raised_by(FrameHeaderInvalidHeaderCRC, lambda: files.x3a_to_wav(bad, back, device=DEV))
    require(raised2 is not None, "hour: a flipped header byte did not raise FrameHeaderInvalidHeaderCRC")
    rep2 = files.verify_x3a(bad, device=DEV)
    require(rep2["skipped_bytes"] > 0 and rep2["ok"] is False, f"hour: verify_x3a on a flipped header byte {rep2}")
    bad.unlink()
    back.unlink(missing_ok=True)
    log(f"# phase 7 hour damage: a payload byte of frame {fp} raises {type(raised).__name__}: {raised}; "
        f"resync counts 1 error and drops that frame alone, verify_x3a {rep['frame_errors']} frame error; a "
        f"header byte of frame {fh}: x3a_to_wav raises {type(raised2).__name__}, verify_x3a skips "
        f"{rep2['skipped_bytes']} bytes")
    return g_enc, g_dec


def phase_files(params, slices, kernels: dict, smi: str) -> dict:
    """Phase 7: the file layer on the card.  Returns each class's
    single-file MB/s, as text."""
    from x3_tpu_torch import files

    for mod in kernels.values():
        mod.launch_count = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="x3_smoke_") as tmp:
        td = Path(tmp)
        # Two frames for the measuring processes' first, warming conversion.
        warm_wav, warm_x3a = td / "warm.wav", td / "warm.x3a"
        write_class_wav(warm_wav, slices[CLASSES[0]]["samples"][: 2 * params.samples_per_frame])
        files.wav_to_x3a(warm_wav, warm_x3a, device=DEV)
        warm = {"encode": (warm_wav, td / "warm.out.x3a"), "decode": (warm_x3a, td / "warm.out.wav")}
        rates = {name: phase_files_class(name, slices[name], td, smi) for name in CLASSES}
        sweep = chunk_sweep(slices, td, smi, warm)
        phase_files_hour(params, td, smi, warm)
    launches = {k: mod.launch_count for k, mod in kernels.items()}
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched by the file layer")
    bound = hour_rss_bound(params)
    mb = sum(slices[n]["samples"].nbytes for n in CLASSES) / 1e6
    # The median call of each class: a fresh process's first call also
    # sets up its pinned memory.
    fits = {c: mb / sum(float(np.median(ts)) for ts in times.values())
            for c, (times, growth) in sweep.items() if growth < bound}
    best = max(fits, key=fits.get) if fits else None
    log(f"# phase 7 launches: {launches}; chunk sweep: fastest within {bound:.1f} MB of peak RSS growth "
        f"{best} bytes ({fits.get(best, 0):.1f} MB/s over the three classes, the median call of each; "
        + ", ".join(f"{c >> 20} MB {r:.1f}" for c, r in fits.items())
        + f"; the default is {files._CHUNK_BYTES >> 20} MB); {time.perf_counter() - t0:.1f} s")
    return rates


def write_batch_wavs(params, td: Path):
    """Phase 8's WAVs in `td`: MF_FILES files of the three classes in turn,
    each of a length uniform in 1..MF_MAX_SAMPLES and made from its own
    seed, and the MF_FIXED lengths.  Returns (paths, samples, lengths, MB
    of int16)."""
    S = params.samples_per_frame
    rng = np.random.default_rng(20261020)
    lengths = [int(n) for n in rng.integers(1, MF_MAX_SAMPLES + 1, MF_FILES)] + list(MF_FIXED)
    arrays = [make_class_corpus(CLASSES[k % 3], max(1, -(-n // S)), S, seed=1000 + k)[:n]
              for k, n in enumerate(lengths)]
    srcs = [td / f"mf{k}.wav" for k in range(len(arrays))]
    for src, a in zip(srcs, arrays):
        write_class_wav(src, a)
    return srcs, arrays, lengths, sum(a.nbytes for a in arrays) / 1e6


def phase_batch_files(params, td: Path, smi: str, rates7: dict) -> dict:
    """Phase 8's batch of WAVs (BASELINE.json config 4, write_batch_wavs)
    through the batch entry points, each against its single-file or
    in-memory counterpart and the inputs.  Returns the WAVs (left in `td`), their samples, lengths,
    archives and statistics, and their MB of int16."""
    import x3_tpu_torch as xt
    from x3_tpu_torch import files, multifile

    S = params.samples_per_frame
    header = xt.build_archive_header(SAMPLE_RATE, params)
    srcs, arrays, lengths, mb = write_batch_wavs(params, td)
    x3as = [td / f"mf{k}.x3a" for k in range(len(arrays))]
    backs = [td / f"mf{k}.back.wav" for k in range(len(arrays))]
    n_frames = sum(-(-n // S) for n in lengths)

    # The batch against one wav_to_x3a / x3a_to_wav a file (timed too).
    t_enc, res = timed_call(lambda: multifile.wav_to_x3a_batch(srcs, x3as, params, device=DEV))
    archives = [x.read_bytes() for x in x3as]
    one, t_one_enc, t_one_dec = td / "mf.one.x3a", 0.0, 0.0
    for k, (src, data, r) in enumerate(zip(srcs, archives, res)):
        t, single = timed_call(lambda: files.wav_to_x3a(src, one, params, device=DEV))
        t_one_enc += t
        require(data == one.read_bytes(), f"file {k}: wav_to_x3a_batch differs from wav_to_x3a")
        require(r.nbytes == len(data) - len(header) and np.array_equal(r.stats, single.stats),
                f"file {k}: wav_to_x3a_batch's result differs from wav_to_x3a's")
    t_dec, counts = timed_call(lambda: multifile.x3a_to_wav_batch(x3as, backs, device=DEV))
    require(counts == lengths, "x3a_to_wav_batch's sample counts differ from the inputs'")
    for k, (src, back) in enumerate(zip(srcs, backs)):
        require(same_wav(back, src), f"file {k}: x3a_to_wav_batch differs from the input")
        t, errors = timed_call(lambda: files.x3a_to_wav(x3as[k], td / "mf.one.wav", device=DEV))
        t_one_dec += t
        require(errors == 0, f"file {k}: x3a_to_wav reported frame errors")

    # The in-memory entry points on the same arrays.
    t_streams_enc, enc = timed_call(lambda: multifile.encode_streams(arrays, params, device=DEV))
    for k, (e, r, data) in enumerate(zip(enc, res, archives)):
        require(header + e.data == data and np.array_equal(e.stats, r.stats),
                f"stream {k}: encode_streams differs from wav_to_x3a_batch")
    t_streams_dec, dec = timed_call(lambda: multifile.decode_streams(archives, device=DEV))
    for k, ((d, rate), a) in enumerate(zip(dec, arrays)):
        require(rate == SAMPLE_RATE and np.array_equal(d, a), f"stream {k}: decode_streams differs")

    enc_t = [timed_call(lambda: multifile.wav_to_x3a_batch(srcs, x3as, params, device=DEV))[0] for _ in range(3)]
    dec_t = [timed_call(lambda: multifile.x3a_to_wav_batch(x3as, backs, device=DEV))[0] for _ in range(3)]
    require([x.read_bytes() for x in x3as] == archives and all(map(same_wav, backs, srcs)),
            "the timed batch calls differ")
    for p in (*x3as, *backs, one, td / "mf.one.wav"):
        p.unlink()
    log(f"# phase 8 files: {len(lengths)} WAVs ({n_frames} frames, {mb:.2f} MB int16, "
        f"{min(lengths)}-{max(lengths)} samples) exact: wav_to_x3a_batch = wav_to_x3a on every file, "
        f"x3a_to_wav_batch = the inputs, encode_streams = the archives, decode_streams = the inputs; "
        f"wav_to_x3a_batch {mb / max(enc_t):.1f}-{mb / min(enc_t):.1f} MB/s, x3a_to_wav_batch "
        f"{mb / max(dec_t):.1f}-{mb / min(dec_t):.1f} MB/s (min-max of 3 warm calls; first calls "
        f"{mb / t_enc:.1f} / {mb / t_dec:.1f}); one call a file: wav_to_x3a {mb / t_one_enc:.1f} MB/s, "
        f"x3a_to_wav {mb / t_one_dec:.1f} MB/s; encode_streams {mb / t_streams_enc:.1f} MB/s, "
        f"decode_streams {mb / t_streams_dec:.1f} MB/s (one call each); {smi}")
    log("# phase 8 files beside phase 7's single 6,144-frame files: "
        + "; ".join(f"{name} {r}" for name, r in rates7.items()))
    # Phase 9 sends the same WAVs through the batch APIs with a mesh.
    return dict(srcs=srcs, arrays=arrays, lengths=lengths, archives=archives, stats=[r.stats for r in res],
                mb=mb)


def write_capture_wav(path, params, n_frames: int, tail: int, seed: int) -> int:
    """An X3M_CHANNELS-channel 96 kHz hydrophone capture of n_frames frames
    and `tail` samples a channel, interleaved, written CHUNK_FRAMES frames
    at a time (each channel and chunk from its own seed), never whole in
    memory.  Returns the samples a channel."""
    S = params.samples_per_frame
    n = n_frames * S + tail
    with wave.open(str(path), "wb") as w:
        w.setnchannels(X3M_CHANNELS)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        for i, start in enumerate(range(0, n, CHUNK_FRAMES * S)):
            m = min(CHUNK_FRAMES * S, n - start)
            chans = np.stack([make_class_corpus("hydrophone", -(-m // S), S, seed=seed + 100 * c + i)[:m]
                              for c in range(X3M_CHANNELS)], axis=1)
            w.writeframes(chans.tobytes())
            del chans
    return n


def same_file(a, b, chunk: int = 1 << 24) -> bool:
    """Two files with the same bytes, compared a chunk at a time."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def phase_x3m(params, td: Path, smi: str) -> float:
    """Phase 8's multichannel capture (BASELINE.json config 5): 4 channels
    of 20 minutes at 96 kHz through wav_to_x3m and x3m_to_wav, verify and
    info, bounded peak RSS, damage, and the CLI.  Returns x3m_to_wav's peak
    RSS growth in MB."""
    import x3_tpu_torch as xt
    from x3_tpu_torch import archive, multichannel
    from x3_tpu_torch.engine import DECODE_BATCH_FRAMES
    from x3_tpu_torch.errors import FrameHeaderInvalidPayloadCRC

    S = params.samples_per_frame
    header = xt.build_archive_header(SAMPLE_RATE, params)

    # The CLI on a 2-frame capture, on the card; its archives warm the
    # measuring process below.
    small, small_x3m, small_back = td / "quad2.wav", td / "quad2.x3m", td / "quad2.back.wav"
    write_capture_wav(small, params, 2, 0, seed=300)
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    for args in (("-i", small, "-o", small_x3m), ("-i", small_x3m, "-o", small_back)):
        out = subprocess.run([sys.executable, "-m", "x3_tpu_torch", *map(str, args), "-q", "--device", DEV], env=env,
                             cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=300)
        require(out.returncode == 0, f"python -m x3_tpu_torch {args}: exit {out.returncode}\n{out.stderr[-3000:]}")
    require(same_file(small_back, small), "the CLI's wav -> x3m -> wav differs from the input")

    src, back = td / "quad.wav", td / "quad.back.wav"
    n = write_capture_wav(src, params, X3M_FRAMES, X3M_TAIL, seed=400)
    mb = X3M_CHANNELS * n * 2 / 1e6
    t_enc, mpath = timed_call(lambda: multichannel.wav_to_x3m(src, td / "quad", params, device=DEV))
    chans, rate = multichannel.read_wav_multichannel(src)
    require(rate == SAMPLE_RATE and chans.shape == (X3M_CHANNELS, n), f"capture shape {chans.shape}")
    paths = [td / f"quad.ch{c}.x3a" for c in range(X3M_CHANNELS)]
    for c, p in enumerate(paths):
        require(p.read_bytes() == header + xt.encode(chans[c], params, device=DEV).data,
                f"channel {c}: wav_to_x3m's archive differs from encode of the channel")
    del chans
    t_dec, got = timed_call(lambda: multichannel.x3m_to_wav(mpath, back, device=DEV))
    require(got == X3M_CHANNELS and same_file(back, src), "x3m_to_wav differs from the input WAV")
    back.unlink()

    rep = multichannel.verify_x3m(mpath, device=DEV)
    require(rep["ok"] and rep["channels"] == X3M_CHANNELS and rep["frame_errors"] == 0
            and rep["skipped_bytes"] == 0
            and all(r["n_frames"] == X3M_FRAMES + 1 and r["n_samples_ok"] == n for r in rep["per_channel"]),
            f"verify_x3m reports {rep}")
    info = multichannel.x3m_info(mpath, device=DEV)
    indexes = []
    for c, p in enumerate(paths):
        with open(p, "rb") as f:
            _, hs = archive.read_archive_header_file(f)
            indexes.append(list(archive.walk_frames_file(f, hs)))
        walked = (len(indexes[c]), sum(h.samples for _, h in indexes[c]),
                  sum(h.payload_len for _, h in indexes[c]))
        pc = info["per_channel"][c]
        require((pc["n_frames"], pc["n_samples"], pc["payload_bytes"]) == walked,
                f"channel {c}: x3m_info {pc} disagrees with the walk {walked}")
    require(info["channels"] == X3M_CHANNELS and info["samples_per_channel"] == n
            and info["pcm_bytes"] == 2 * X3M_CHANNELS * n
            and info["archive_bytes"] == sum(p.stat().st_size for p in paths),
            f"x3m_info {({k: v for k, v in info.items() if k != 'per_channel'})}")

    bound = mb / 2
    r = rss_run("x3m", mpath, back, (small_x3m, td / "quad2.warm.wav"))
    require(same_file(back, src), "x3m_to_wav in the measuring process differs from the input WAV")
    back.unlink()
    require(r["growth"] < bound, f"x3m_to_wav peak RSS growth {r['growth']:.1f} MB, bound {bound:.1f} MB")
    log(f"# phase 8 x3m: {X3M_CHANNELS} channels x {n} samples ({X3M_FRAMES} frames and {X3M_TAIL} samples, "
        f"{mb:.2f} MB interleaved) exact: each channel's archive = encode of the channel, x3m_to_wav = the "
        f"input; verify_x3m ok; x3m_info = walk; wav_to_x3m {mb / t_enc:.1f} MB/s, x3m_to_wav "
        f"{mb / t_dec:.1f} MB/s (one call each), {mb / r['times'][0]:.1f} MB/s in a fresh process with "
        f"peak RSS growth {r['growth']:.1f} MB ({r['how']}; bound {bound:.1f} MB); the CLI's wav -> x3m "
        f"-> wav exact on a 2-frame capture; {smi}")

    # Damage: one payload byte of the first frame of a decode batch (so
    # x3m_to_wav meets it at once) in one channel.
    c, fi = X3M_DAMAGED_CHANNEL, 6 * DECODE_BATCH_FRAMES
    pos = indexes[c][fi][0] + 10
    with open(paths[c], "r+b") as f:
        f.seek(pos)
        byte = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([byte ^ 0x10]))
    try:
        multichannel.x3m_to_wav(mpath, back, device=DEV)
        raised = None
    except FrameHeaderInvalidPayloadCRC as e:
        raised = e
    require(raised is not None, "x3m_to_wav on a damaged channel did not raise FrameHeaderInvalidPayloadCRC")
    rep = multichannel.verify_x3m(mpath, device=DEV)
    pcs = rep["per_channel"]
    require(not rep["ok"] and rep["frame_errors"] == 1 and not pcs[c]["ok"]
            and all(pc["ok"] for k, pc in enumerate(pcs) if k != c),
            f"verify_x3m on a damaged channel reports {rep}")
    log(f"# phase 8 x3m damage: a payload byte of channel {c} frame {fi}: x3m_to_wav raises "
        f"{type(raised).__name__} ({raised}); verify_x3m FAILED with {rep['frame_errors']} frame error, "
        f"in channel {c} alone (reason: {rep.get('reason')})")
    restore_bytes(paths[c], pos, bytes([byte]))
    x3m_damage_pair(mpath, paths, indexes, src, back, S)
    return r["growth"]


def damage_frame(path, payload_off: int, payload_len: int, kind: str) -> tuple[int, bytes]:
    """Damage one frame of an archive file in place: "crc" flips a payload
    byte (its payload CRC then fails), "decode" makes its first block a BFP
    block of 3 bits and re-stamps the header's payload CRC (it then fails
    to decode).  Returns (offset, bytes) that restore it."""
    from x3_tpu_torch.ops.crc import crc16

    at = payload_off - 20
    with open(path, "r+b") as f:
        f.seek(at)
        old = f.read(20 + payload_len)
        new = bytearray(old)
        if kind == "crc":
            new[20 + 10] ^= 0x10
        else:
            new[20 + 2] = 0b00_0010_00
            new[18:20] = crc16(bytes(new[20:])).to_bytes(2, "big")
        f.seek(at)
        f.write(new)
    return at, old


def restore_bytes(path, at: int, data: bytes) -> None:
    with open(path, "r+b") as f:
        f.seek(at)
        f.write(data)


def x3m_damage_pair(mpath, paths, indexes, src, back, S: int) -> None:
    """Phase 8's x3m damage pair at full size: a payload CRC mismatch in
    channel 2 of window 1 with a decode error in channel 0 of window 2,
    then the reverse.  Each must raise the window-1 frame's error with
    x3_tpu's message, after x3m_to_wav wrote window 0, equal to the input,
    into a WAV with its header patched."""
    from x3_tpu_torch import multichannel
    from x3_tpu_torch.engine import DECODE_BATCH_FRAMES
    from x3_tpu_torch.errors import X3Error

    win = DECODE_BATCH_FRAMES
    first, later = (2, win + win // 2), (0, 2 * win + win // 2)
    for kinds, want in ((("crc", "decode"), ("FrameHeaderInvalidPayloadCRC", f"frame {first[1]} payload CRC mismatch")),
                        (("decode", "crc"), ("FrameDecodeInvalidBPF", f"frame {first[1]} failed to decode"))):
        saved = []
        for (c, fi), kind in zip((first, later), kinds):
            off, h = indexes[c][fi]
            saved.append((paths[c], *damage_frame(paths[c], off, h.payload_len, kind)))
        try:
            multichannel.x3m_to_wav(mpath, back, device=DEV)
            got = None
        except X3Error as e:
            got = (type(e).__name__, str(e))
        finally:
            for p, at, data in saved:
                restore_bytes(p, at, data)
        require(got == want, f"x3m_to_wav with {kinds[0]} in channel {first[0]} frame {first[1]} and {kinds[1]} "
                             f"in channel {later[0]} frame {later[1]}: raised {got}, want {want}")
        with wave.open(str(back), "rb") as w, wave.open(str(src), "rb") as w_src:
            shape = (w.getnchannels(), w.getnframes())
            same = w.readframes(win * S) == w_src.readframes(win * S)
        require(shape == (X3M_CHANNELS, win * S) and same,
                f"x3m_to_wav's partial WAV after {want[0]}: {shape}, want window 0 of the input")
        log(f"# phase 8 x3m damage pair: {kinds[0]} in channel {first[0]} frame {first[1]} (window 1) and "
            f"{kinds[1]} in channel {later[0]} frame {later[1]} (window 2): x3m_to_wav raises {got[0]} "
            f"({got[1]}); the WAV holds window 0 ({win * S} samples a channel), equal to the input")
        back.unlink()


def phase_batch(params, kernels: dict, smi: str, rates7: dict, td: Path) -> dict:
    """Phase 8: multi-file batching and multichannel .x3m on the card, in
    `td`.  Returns phase_batch_files' WAVs for phase 9."""
    for mod in kernels.values():
        mod.launch_count = 0
    t0 = time.perf_counter()
    batch = phase_batch_files(params, td, smi, rates7)
    phase_x3m(params, td, smi)
    launches = {k: mod.launch_count for k, mod in kernels.items()}
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched by phase 8")
    # Every decode call checks its CRCs in it (one K1 beside each K3) and
    # every encode batch one K1 beside its K2: no CRC pass of its own.
    require(launches["crc16"] <= launches["encode"] + launches["decode"],
            f"phase 8 launched K1 {launches['crc16']} times, more than K2 + K3 "
            f"({launches['encode']} + {launches['decode']})")
    log(f"# phase 8 launches: {launches}; {time.perf_counter() - t0:.1f} s")
    return batch


def smoke_meshes():
    """Phase 9's meshes: every visible card, and on a one-card machine also
    two and four entries of cuda:0 (an entry is a shard)."""
    import torch

    from x3_tpu_torch.parallel.mesh import make_mesh

    meshes = [make_mesh()]
    if torch.cuda.device_count() == 1:
        meshes += [make_mesh(["cuda:0"] * 2), make_mesh(["cuda:0"] * 4)]
    return meshes


def mesh_label(mesh) -> str:
    names = [str(d) for d in mesh.devices]
    return f"{names[0]} x{len(names)}" if len(set(names)) == 1 else "+".join(names)


def same_outputs(got, want) -> bool:
    """Two tuples (or dicts) of tensors with equal keys, shapes and values."""
    import torch

    if isinstance(want, dict):
        return got.keys() == want.keys() and all(torch.equal(got[k].cpu(), want[k].cpu()) for k in want)
    return len(got) == len(want) and all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))


def mesh_sharded(params, slices, meshes) -> None:
    """Phase 9, sharded batches: each class's N_FRAMES_SLICE frames through
    encode_frames_sharded and decode_frames_sharded at phase 4's rungs,
    equal to the unsharded calls key for key, the decode equal to the
    input; then roundtrip_step on the first N_FRAMES_CHECK frames (a
    partial tail frame), exact, with the unsharded nbytes."""
    import torch

    from x3_tpu_torch.models.decoder import payload_batch
    from x3_tpu_torch.ops.decode_kernel import decode_frames
    from x3_tpu_torch.ops.encode_kernel import encode_frames
    from x3_tpu_torch.parallel.mesh import decode_frames_sharded, encode_frames_sharded, roundtrip_step

    S = params.samples_per_frame
    for name in CLASSES:
        d = slices[name]
        st = torch.from_numpy(d["samples"].reshape(-1, S)).to(DEV)
        nv = torch.full((st.shape[0],), S, dtype=torch.int32, device=DEV)
        want_enc = encode_frames(st, nv, params, "block", d["w"], d["nw"])
        head = d["samples"][: N_FRAMES_CHECK * S].reshape(N_FRAMES_CHECK, S).copy()
        n_head = np.full(N_FRAMES_CHECK, S, np.int32)
        n_head[-1] = S - 321
        head[-1, S - 321 :] = 0
        want_nbytes = encode_frames(torch.from_numpy(head).to(DEV), torch.from_numpy(n_head).to(DEV),
                                    params)["nbytes"]
        for mesh in meshes:
            got = encode_frames_sharded(st, nv, params, mesh, d["w"], d["nw"])
            require(same_outputs(got, want_enc), f"{name} {mesh}: encode_frames_sharded differs")
            buf, ns, plens, n_blocks = payload_batch(d["payloads"], d["counts"], params, mesh.size)
            tensors = [torch.from_numpy(a).to(DEV) for a in (buf, ns, plens)]
            want = decode_frames(*tensors, params, n_blocks)
            got = decode_frames_sharded(buf, ns, plens, params, mesh, n_blocks)
            require(same_outputs(got, want), f"{name} {mesh}: decode_frames_sharded differs")
            f = len(d["counts"])
            require(not got[1][:f].any() and np.array_equal(got[0][:f].cpu().numpy().reshape(-1), d["samples"]),
                    f"{name} {mesh}: the sharded decode differs from the input")
            nbytes, exact = roundtrip_step(params, mesh)(head, n_head)
            require(bool(exact) and torch.equal(nbytes.cpu(), want_nbytes.cpu()),
                    f"{name} {mesh}: roundtrip_step exact={bool(exact)}")


def mesh_batch_files(params, batch: dict, td: Path, meshes) -> str:
    """Phase 9, the batch APIs: phase 8's WAVs through wav_to_x3a_batch and
    x3a_to_wav_batch with each mesh and without one, twice in turns (none,
    meshes, meshes reversed, none); every archive equal to phase 8's, every
    WAV to its input; then encode_streams and decode_streams with each
    mesh equal to the calls without one.  Returns the MB/s line."""
    import x3_tpu_torch as xt
    from x3_tpu_torch import multifile

    header = xt.build_archive_header(SAMPLE_RATE, params)
    srcs, archives = batch["srcs"], batch["archives"]
    x3as = [td / f"mesh{k}.x3a" for k in range(len(srcs))]
    backs = [td / f"mesh{k}.back.wav" for k in range(len(srcs))]
    times: dict = {}
    order = [None, *meshes, *reversed(meshes), None]
    for mesh in order:
        t_enc, res = timed_call(lambda: multifile.wav_to_x3a_batch(srcs, x3as, params, mesh=mesh, device=DEV))
        require([x.read_bytes() for x in x3as] == archives
                and all(np.array_equal(r.stats, st) for r, st in zip(res, batch["stats"])),
                f"wav_to_x3a_batch with mesh {mesh} differs from phase 8's archives")
        t_dec, counts = timed_call(lambda: multifile.x3a_to_wav_batch(x3as, backs, mesh=mesh, device=DEV))
        require(counts == batch["lengths"] and all(map(same_wav, backs, srcs)),
                f"x3a_to_wav_batch with mesh {mesh} differs from the inputs")
        times.setdefault("none" if mesh is None else mesh_label(mesh), []).append((t_enc, t_dec))
    for mesh in meshes:
        enc = multifile.encode_streams(batch["arrays"], params, mesh=mesh, device=DEV)
        require(all(header + e.data == a and np.array_equal(e.stats, st)
                    for e, a, st in zip(enc, archives, batch["stats"])),
                f"encode_streams with mesh {mesh} differs from the call without one")
        dec = multifile.decode_streams(archives, mesh=mesh, device=DEV)
        require(all(rate == SAMPLE_RATE and np.array_equal(x, a) for (x, rate), a in zip(dec, batch["arrays"])),
                f"decode_streams with mesh {mesh} differs from the call without one")
    for p in (*x3as, *backs):
        p.unlink()
    mb = batch["mb"]
    return "; ".join(f"{label}: wav_to_x3a_batch {mb / max(e for e, _ in t):.1f}-{mb / min(e for e, _ in t):.1f}, "
                     f"x3a_to_wav_batch {mb / max(d for _, d in t):.1f}-{mb / min(d for _, d in t):.1f}"
                     for label, t in times.items())


def mesh_profiling(params, slices, td: Path) -> str:
    """Phase 9, the hooks: aot_compile(N_FRAMES_CHECK) and the wall time of
    the next encode and decode; then trace() of one encode and one decode,
    whose Chrome trace must hold K1, K2 and K3 device rows."""
    import torch

    from x3_tpu_torch.utils.profiling import aot_compile, span, trace

    S = params.samples_per_frame
    d = slices[CLASSES[0]]
    t0 = time.perf_counter()
    fns = aot_compile(N_FRAMES_CHECK, params, device=DEV)
    t_aot = time.perf_counter() - t0
    samples = d["samples"][: N_FRAMES_CHECK * S].reshape(N_FRAMES_CHECK, S)
    n_valid = np.full(N_FRAMES_CHECK, S, np.int32)
    t_enc, enc = timed_call(lambda: fns["encode"](samples, n_valid))
    payload = np.ascontiguousarray(enc["payload_words"].cpu().numpy()).view(np.uint32).byteswap() \
        .view(np.uint8).reshape(N_FRAMES_CHECK, -1)
    nbytes = enc["nbytes"].cpu().numpy()
    t_dec, (out, err) = timed_call(lambda: fns["decode"](payload, n_valid, nbytes))
    require(not err.any() and np.array_equal(out.cpu().numpy().reshape(-1), samples.reshape(-1)),
            "aot_compile's encode and decode do not roundtrip")
    with trace(td / "trace") as prof:
        with span("x3.encode"):
            enc = fns["encode"](samples, n_valid)
        with span("x3.decode"):
            fns["decode"](payload, n_valid, nbytes)
    events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
    kernel_rows = {e["name"] for e in events if e.get("cat") == "kernel"}
    names = {"K1": "crc16_fold_kernel", "K2": "encode_kernel", "K3": "decode_kernel"}
    missing = [k for k, n in names.items() if not any(n in row for row in kernel_rows)]
    require(not missing, f"the trace holds no device row of {missing}: {sorted(kernel_rows)[:20]}")
    require({"x3.encode", "x3.decode"} <= {e["name"] for e in events}, "the trace lacks the spans")
    return (f"aot_compile({N_FRAMES_CHECK}) {t_aot:.2f} s, then encode {t_enc * 1e3:.1f} ms and decode "
            f"{t_dec * 1e3:.1f} ms of {N_FRAMES_CHECK} frames; trace: {len(events)} events, "
            f"{len(kernel_rows)} kernel names, K1-K3 rows present")


def phase_mesh(params, kernels: dict, slices, batch: dict, td: Path, smi: str) -> None:
    """Phase 9: the mesh (frame-sharded encode and decode, roundtrip_step,
    dryrun_multichip, the batch APIs' mesh=), the profiling hooks and a
    short fuzz soak of K3 against its plain version."""
    import torch

    from x3_tpu_torch.entry import dryrun_multichip
    from x3_tpu_torch.tools import fuzz_soak

    for mod in kernels.values():
        mod.launch_count = 0
    t0 = time.perf_counter()
    meshes = smoke_meshes()
    mesh_sharded(params, slices, meshes)
    log(f"# phase 9 sharded: {', '.join(mesh_label(m) for m in meshes)}: encode_frames_sharded and "
        f"decode_frames_sharded equal the unsharded calls on all {N_FRAMES_SLICE} frames of each class at "
        f"phase 4's rungs, decode = input; roundtrip_step exact on {N_FRAMES_CHECK} frames; "
        f"{time.perf_counter() - t0:.1f} s")
    dryrun_multichip(4)
    t1 = time.perf_counter()
    rates = mesh_batch_files(params, batch, td, meshes)
    log(f"# phase 9 batch APIs: {len(batch['srcs'])} WAVs with mesh= equal phase 8's archives and the "
        f"inputs; encode_streams/decode_streams with mesh= equal the calls without one; "
        f"{time.perf_counter() - t1:.1f} s")
    log(f"# phase 9 batch MB/s, min-max of 2 calls each, not claimed: {rates}; {smi}")
    log(f"# phase 9 profiling: {mesh_profiling(params, slices, td)}")
    t1 = time.perf_counter()
    soak = fuzz_soak.soak(SOAK_TRIALS, SOAK_SEED, params, device=DEV, log=lambda m: log(f"# phase 9 soak {m}"))
    require(not soak["failures"] and soak["error_lanes"] > 0 and soak["launches"] > 0,
            f"the fuzz soak failed: {soak}")
    log(f"# phase 9 soak: {SOAK_TRIALS} trials (seed {SOAK_SEED:#x}), {soak['plain_calls']} plain calls, "
        f"{soak['launches']} K3 launches, {soak['error_lanes']} error lanes, 0 failures; "
        f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.synchronize()
    launches = {k: mod.launch_count for k, mod in kernels.items()}
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched by phase 9")
    log(f"# phase 9 launches: {launches}; {time.perf_counter() - t0:.1f} s")


def tool_module(*argv: str) -> list[str]:
    """The command that runs a tool of the port as `python -m`."""
    return [sys.executable, "-m", f"x3_tpu_torch.tools.{argv[0]}", *argv[1:]]


def run_examples() -> None:
    """Phase 10: each torch example once on the card, in this process."""
    import contextlib
    import importlib.util
    import io

    for name in EXAMPLES:
        t0 = time.perf_counter()
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            mod.main(device=DEV)
        last = out.getvalue().strip().splitlines()[-1]
        log(f"# phase 10 example {name}: {last}; {time.perf_counter() - t0:.3f} s")


def corpus_on_card() -> None:
    """Phase 10: roundtrip_corpus --synthetic on the card, each archive
    equal to the port's CPU encode of the same WAV."""
    from x3_tpu_torch.files import wav_to_x3a
    from x3_tpu_torch.tools import roundtrip_corpus

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="x3_corpus_") as td:
        paths = roundtrip_corpus.synthetic_corpus(Path(td))
        res = roundtrip_corpus.run(paths, [DEV], log=lambda m: log(f"# phase 10 corpus {m}"))
        require(res["failures"] == 0, f"roundtrip_corpus on the card: {res['failures']} failures")
        for p in paths:
            cpu = Path(td) / f"{p.stem}.cpu_encode.x3a"
            wav_to_x3a(p, cpu, device="cpu")
            require(list(res["archives"][p.name].values()) == [cpu.read_bytes()],
                    f"{p.name}: the card's archive differs from the CPU encode's")
    log(f"# phase 10 corpus: {len(paths)} synthetic WAVs exact through wav_to_x3a/x3a_to_wav on the card, "
        f"archives equal the CPU encode's; {time.perf_counter() - t0:.1f} s")


def tool_geometry_times(errs: Errs, reps: int = 20) -> None:
    """Phase 10: K2 and K3 at the fuzz's edge geometries, TOOL_FRAMES
    frames of mixed signal each: K2 equal to its plain version, the decode
    equal to the input, walked with the parameters an archive's XML gives
    (the default blocks_per_frame: at 1,500 blocks a frame K3's n_blocks
    override), and each kernel's device ms a launch (torch.profiler)
    beside its bound."""
    import torch

    from x3_tpu_torch import Parameters
    from x3_tpu_torch.models.decoder import decode_geometry
    from x3_tpu_torch.ops import decode_cuda, encode_cuda
    from x3_tpu_torch.ops.encode_kernel import frame_geometry

    rng = np.random.default_rng(20261020)
    for L, B in TOOL_GEOMETRIES:
        params = Parameters(block_len=L, blocks_per_frame=B)
        S, _, _, W = frame_geometry(params)
        frames = mixed_signal(rng, TOOL_FRAMES * S).reshape(TOOL_FRAMES, S)
        st = torch.from_numpy(frames).to(DEV)
        nv = torch.full((TOOL_FRAMES,), S, dtype=torch.int32, device=DEV)
        enc = encode_cuda.encode_words_cuda(st, nv, params, W)
        errs.check("encode", enc, encode_cuda.plain(st, nv, params, W), f"phase 10 K2 at L={L} B={B}")
        words, nbytes = enc[0], enc[3]
        recon = Parameters(block_len=L)
        n_blocks = decode_geometry(recon, [S], [0])[0]
        dec = decode_cuda.decode_words_cuda(words, nv, nbytes, recon, n_blocks)
        require(not bool(dec[1].any()) and torch.equal(dec[0][:, :S], st),
                f"phase 10 K3 at L={L} B={B}: the decode differs from the input")
        ms_enc, _, _ = profiled_ms(lambda: encode_cuda.encode_words_cuda(st, nv, params, W), reps,
                                   f"phase 10 K2 L={L} B={B}")
        ms_dec, _, _ = profiled_ms(lambda: decode_cuda.decode_words_cuda(words, nv, nbytes, recon, n_blocks),
                                   reps, f"phase 10 K3 L={L} B={B}")
        b_enc = bound_ms(nbytes_of(st, nv, *enc))
        b_dec = bound_ms(int(nbytes.sum()) + nbytes_of(nv, nbytes, *dec))
        log(f"# phase 10 kernels at L={L} B={B}: K2 {ms_enc:.4f} ms a launch ([{TOOL_FRAMES}, {S}], W={W}; "
            f"bound {b_enc:.4f} ms), K3 {ms_dec:.4f} ms ({TOOL_FRAMES} frames, "
            f"{recon.blocks_per_frame if n_blocks is None else n_blocks} blocks walked; bound {b_dec:.4f} ms)")


def phase_tools(kernels: dict, errs: Errs) -> None:
    """Phase 10: the host tools and the examples on the card.  The
    differential fuzz runs as its own process beside the rest; the sweep
    builds in a process of its own; the corpus and the examples run here,
    and K1-K3 must have been launched by them."""
    import torch

    for mod in kernels.values():
        mod.launch_count = 0
    t0 = time.perf_counter()
    fuzz = subprocess.Popen(tool_module("fuzz_differential", "--trials", str(FUZZ_TRIALS), "--seed",
                                        str(FUZZ_SEED), "--devices", "cuda,cpu"),
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        sweep = subprocess.run(tool_module("compile_sweep"), cwd=ROOT, capture_output=True, text=True,
                               timeout=900)
        rows = [line for line in sweep.stdout.splitlines() if line.startswith(("ok", "FAIL"))]
        for line in rows:
            if not line.startswith("ok   encode") and not line.startswith("ok   decode"):
                log(f"# phase 10 sweep {line}")
        require(sweep.returncode == 0, f"compile_sweep exited {sweep.returncode}: {sweep.stderr[-3000:]}")
        log(f"# phase 10 sweep: every (kernel, rung) launched and agreed, {len(rows)} rows ok; "
            f"{time.perf_counter() - t0:.1f} s")
        corpus_on_card()
        run_examples()
        torch.cuda.synchronize()
        launches = {k: mod.launch_count for k, mod in kernels.items()}
        tool_geometry_times(errs)
        out, _ = fuzz.communicate(timeout=900)
    finally:
        if fuzz.poll() is None:
            fuzz.kill()
            fuzz.wait()
    for line in out.splitlines():
        if line.strip():
            log(f"# phase 10 fuzz {line}")
    require(fuzz.returncode == 0, f"fuzz_differential exited {fuzz.returncode}")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched by phase 10")
    log(f"# phase 10 launches: {launches}; {time.perf_counter() - t0:.1f} s")


def phase_bench(kernels: dict) -> None:
    """Phase 11: the port's bench at its defaults, in this process; its
    exactness keys must hold and K1-K3 must have been launched by it."""
    from x3_tpu_torch import bench

    for mod in kernels.values():
        mod.launch_count = 0
    t0 = time.perf_counter()
    result = bench.run(DEV)
    launches = {k: mod.launch_count for k, mod in kernels.items()}
    log(f"# phase 11 bench: {json.dumps(result)}")
    log(f"# phase 11 launches: {launches}; {time.perf_counter() - t0:.1f} s")
    require(result["platform"] == "cuda", f"the bench ran on {result['platform']}")
    for key in ("bit_exact", "decode_exact", "e2e_exact", "decode_parity_ok"):
        require(result[key] is True, f"the bench's {key} is {result[key]}")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched by the bench")


def profiled_ms(fn, reps: int, what: str) -> tuple[float, int, str]:
    """(device ms a launch, launches recorded, kernel name) of fn(), which
    launches one kernel, over `reps` calls under torch.profiler: the
    wrapper's host pace does not enter."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # CUPTI may drop a launch's record, or a whole session's (seen on the
    # card): the mean is over the launches recorded, and a session that
    # recorded none is run again, up to three times.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total
                and not e.key.startswith("Activity Buffer")]
        if rows:
            break
    calls = sum(e.count for e in rows)
    require(0 < calls <= reps and len(rows) == 1,
            f"{what}: {calls} device rows for {reps} launches ({[e.key for e in rows]})")
    return rows[0].self_device_time_total / 1e3 / calls, calls, rows[0].key


def profile_route_kernels(params, reps: int = 20) -> None:
    """--profile: K4, K5 and K6 alone on phase 6's batch of each class at
    its fitting rungs, `reps` launches under torch.profiler: each kernel's
    device ms a launch (the wrappers' host pace does not enter), beside
    the bound phase 6 computes from the same tensors."""
    from x3_tpu_torch.ops import front_cuda, pack_cuda, pack_walk_cuda
    from x3_tpu_torch.ops.encode_kernel import GR, frame_geometry

    L = frame_geometry(params)[2]
    for name in CLASSES:
        b = route_batch(params, name)
        vals, lens, _ = b["front"]
        nb4 = b["nw_fit"] + GR - 1
        runs = {  # kernel -> (launch, its inputs)
            "front": (lambda: front_cuda.encode_front_cuda(*b["lanes"], params), b["lanes"]),
            "pack_blocks": (lambda: pack_cuda.pack_blocks_cuda(vals, lens, b["r2"], nb4),
                            (vals, lens, b["r2"])),
            "pack_walk": (lambda: pack_walk_cuda.pack_walk_cuda(b["mval"], b["mlen"], b["boff"],
                                                                b["w_fit"], L),
                          (b["mval"], b["mlen"], b["boff"])),
        }
        for k, (fn, ins) in runs.items():
            out = fn()
            bound = bound_ms(nbytes_of(*ins, *(out if isinstance(out, tuple) else [out])))
            ms, calls, key = profiled_ms(fn, reps, f"profile {name} {k}")
            log(f"# profile {name} {k}: device {ms:.4f} ms a launch over {calls} of {reps} launches "
                f"(nb4={nb4}, W={b['w_fit']}), bound {bound:.4f} ms ({bound / ms:.0%} of it); {key[:60]}")


def profile_call(name: str, label: str, fn, top: int):
    """torch.profiler's device rows of one call of fn (their sum against
    the profiled call's wall gives the device idle share), then cProfile's
    host functions of another, each by self time (Python 3.12's cProfile
    sees every thread, the read-ahead and writer threads too)."""
    import cProfile
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side rows only (kernels and copies): a CPU op's row repeats
    # its kernels' time, and CUPTI's buffer requests are the profiler's own.
    ka = sorted((e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total
                 and not e.key.startswith("Activity Buffer")),
                key=lambda e: e.self_device_time_total, reverse=True)
    dev_ms = sum(e.self_device_time_total for e in ka) / 1e3
    log(f"# profile {name} {label}: device {dev_ms:.3f} ms (kernels and copies) in a profiled "
        f"wall of {wall_ms:.3f} ms: device idle share {1 - dev_ms / wall_ms:.1%}")
    for e in ka[:top]:
        log(f"#   device {e.key[:70]}: {e.self_device_time_total / 1e3:.3f} ms, {e.count} calls")
    pr = cProfile.Profile()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    st = pstats.Stats(pr).sort_stats("tottime")
    for func in st.fcn_list[:top]:
        _, ncalls, tottime, _, _ = st.stats[func]
        path, line, fname = func
        log(f"#   host {fname} ({os.path.basename(path)}:{line}): {tottime * 1e3:.3f} ms self, {ncalls} calls")


def stream_waits(fn) -> dict:
    """Seconds the calling thread spends in fn() (a decode to WAV or to
    memory) waiting on the read-ahead thread of files or multifile for the
    next chunk or batch (reader), on the events behind the read-backs
    (event), and on the WAV writers' queues, their drains and closings
    (writer): the port's x3.prefetch_wait, x3.device_wait and
    x3.writer_wait spans of this thread over the call
    (utils.profiling.spans)."""
    from x3_tpu_torch.utils import profiling

    keys = {"x3.prefetch_wait": "reader", "x3.device_wait": "event", "x3.writer_wait": "writer"}
    waits = dict.fromkeys(keys.values(), 0.0)
    me, t0 = threading.get_ident(), time.perf_counter_ns()
    fn()
    log = profiling.spans(t0)
    require(not log.wrapped, "stream_waits: the span ring wrapped during the call")
    for s in log:
        if s.thread == me and s.start_ns >= t0 and s.name in keys:
            waits[keys[s.name]] += (s.end_ns - s.start_ns) * 1e-9
    return waits


def joined_stream(f, wout, start: int, params, batch_frames: int, device) -> int:
    """--profile's yardstick for x3a_to_wav's chunked stream: the same
    reads, index and decode (clean archives only), but each chunk read into
    new bytes and joined with the carry, and each device batch's span
    copied once into a new pinned buffer, where the stream reads chunks
    straight into a pool of pinned buffers."""
    import torch

    from x3_tpu_torch import archive, files
    from x3_tpu_torch.models.decoder import decode_frames_indexed
    from x3_tpu_torch.models.staging import host_empty
    from x3_tpu_torch.utils.io import prefetch_iter

    f.seek(0, 2)
    n = f.tell()

    def _reads():
        f.seek(start)
        p = start
        while p < n:
            chunk = f.read(files._CHUNK_BYTES)
            if not chunk:
                return
            p += len(chunk)
            yield chunk

    reads = prefetch_iter(_reads(), depth=1)
    pos, carry = start, b""
    try:
        while True:
            chunk = next(reads, None)
            eof, blob = (True, carry) if chunk is None else (pos + len(chunk) >= n, carry + chunk)
            pos += 0 if chunk is None else len(chunk)
            if not blob:
                return 0
            arr = np.frombuffer(blob, np.uint8)
            offs, ns, lens = archive.index_frames(arr)
            want = (arr[offs - 2].astype(np.int64) << 8) | arr[offs - 1]
            for s in range(0, len(offs), batch_frames):
                cut = slice(s, s + batch_frames)
                lo, hi = int(offs[cut][0]), int(offs[cut][-1] + lens[cut][-1])
                span = host_empty(hi - lo, torch.uint8, device)
                span.numpy()[:] = arr[lo:hi]
                samples, errs, crc_ok = decode_frames_indexed(span, offs[cut] - lo, ns[cut], lens[cut], params,
                                                              check_crcs=want[cut], device=device)
                require(crc_ok.all() and not errs.any(), "joined_stream: a damaged frame")
                wout.write(samples)
            carry = blob[int(offs[-1] + lens[-1]) if len(offs) else 0 :]
            if eof:
                require(len(carry) <= 20, "joined_stream: a damaged tail")
                return 0
    finally:
        reads.close()


def stream_designs(x3a, back, mb: float, turns: int = 2, calls: int = 3) -> str:
    """x3a_to_wav as built against joined_stream in its place, in turns
    (built, joined, joined, built) `turns` times, `calls` warm calls a
    turn: the median and min-max MB/s of each, as text."""
    from x3_tpu_torch import files

    built, times = files._x3a_to_wav_stream, {"pinned pool": [], "joined": []}
    try:
        for turn in ["pinned pool", "joined", "joined", "pinned pool"] * turns:
            files._x3a_to_wav_stream = built if turn == "pinned pool" else joined_stream
            files.x3a_to_wav(x3a, back, device=DEV)  # warm
            times[turn] += [timed_call(lambda: files.x3a_to_wav(x3a, back, device=DEV))[0] for _ in range(calls)]
    finally:
        files._x3a_to_wav_stream = built
    return "; ".join(f"{k} median {mb / float(np.median(v)):.1f} MB/s, min-max {mb / max(v):.1f}-{mb / min(v):.1f} "
                     f"over {len(v)} calls" for k, v in times.items())


def phase_profile(params, top: int = 12) -> None:
    """--profile: where the time goes, per class at full size.  For a warm
    encode, a warm checked decode and x3a_to_wav of the class's 6,144-frame
    archive: wall ms, then torch.profiler's device ops (their sum against
    the profiled call's wall gives the device's idle share) and cProfile's
    host functions, each by self time; for x3a_to_wav also the walker's
    (resync=True) wall in the same run, the stream against joined_stream
    (stream_designs), and the ms the main thread waits on the read-ahead
    thread, on the events behind the read-backs and on the WAV writer's
    queue in one more call (stream_waits)."""
    import x3_tpu_torch as xt
    from x3_tpu_torch import files

    S = params.samples_per_frame
    header = xt.build_archive_header(SAMPLE_RATE, params)
    with tempfile.TemporaryDirectory(prefix="x3_profile_") as tmp:
        td = Path(tmp)
        for name in CLASSES:
            samples = make_class_corpus(name, N_FRAMES_SLICE, S)
            mb = samples.nbytes / 1e6
            slice_once(params, samples, header)  # warm-up
            _, _, (payloads, counts, crcs), _, (t_enc, _, t_dec) = slice_once(params, samples, header)
            log(f"# profile {name}: encode {t_enc * 1e3:.3f} ms ({mb / t_enc:.1f} MB/s), "
                f"decode {t_dec * 1e3:.3f} ms ({mb / t_dec:.1f} MB/s), unprofiled wall")
            src, x3a, back = td / f"{name}.wav", td / f"{name}.x3a", td / f"{name}.back.wav"
            write_class_wav(src, samples)
            files.wav_to_x3a(src, x3a, device=DEV)
            stream = lambda: files.x3a_to_wav(x3a, back, device=DEV)
            stream()  # warm-up
            walls = [timed_call(stream)[0] for _ in range(3)]
            walks = [timed_call(lambda: files.x3a_to_wav(x3a, back, resync=True, device=DEV))[0]
                     for _ in range(3)]
            log(f"# profile {name}: x3a_to_wav " + ", ".join(f"{t * 1e3:.3f} ms ({mb / t:.1f} MB/s)" for t in walls)
                + "; the walker (resync=True) " + ", ".join(f"{t * 1e3:.3f} ms ({mb / t:.1f} MB/s)" for t in walks)
                + "; unprofiled walls, 3 warm calls each")
            log(f"# profile {name} x3a_to_wav designs ({files._CHUNK_BYTES >> 20} MB chunks): "
                f"{stream_designs(x3a, back, mb)}")
            steps = (("encode", lambda: xt.encode(samples, params, device=DEV)),
                     ("decode", lambda: xt.decode_frames_batch(payloads, counts, params,
                                                               check_crcs=crcs, device=DEV)),
                     ("x3a_to_wav", stream))
            for label, fn in steps:
                profile_call(name, label, fn, top)
            t0 = time.perf_counter()
            waits = stream_waits(stream)
            wall = time.perf_counter() - t0
            require(same_wav(back, src), f"profile {name}: x3a_to_wav differs from the input")
            log(f"# profile {name} x3a_to_wav waits of the main thread in a wall of {wall * 1e3:.3f} ms: "
                f"on the reader {waits['reader'] * 1e3:.3f} ms, on the read-back events "
                f"{waits['event'] * 1e3:.3f} ms, on the WAV writer's queue {waits['writer'] * 1e3:.3f} ms")
            for p in (src, x3a, back):
                p.unlink()


def profile_batch(params, top: int = 12) -> None:
    """--profile: phase 8's WAVs (write_batch_wavs) through
    x3a_to_wav_batch and decode_streams, and its 4-channel capture through
    x3m_to_wav.  For each path: the wall and MB/s of 3 warm calls
    (unprofiled), K1 and K3 launches of one call, torch.profiler's device
    rows and the device idle share of one call, cProfile's host rows of
    another, and the main thread's waits in one more (stream_waits); then
    x3m_to_wav's peak RSS growth in a fresh process.  Each output is held
    to the input.  It drives the entry points alone, so that it runs on a
    checkout of another commit too."""
    from x3_tpu_torch import multichannel, multifile
    from x3_tpu_torch.ops import crc_cuda, decode_cuda

    with tempfile.TemporaryDirectory(prefix="x3_profile_batch_") as tmp:
        td = Path(tmp)
        srcs, arrays, lengths, mb = write_batch_wavs(params, td)
        x3as = [td / f"mf{k}.x3a" for k in range(len(srcs))]
        backs = [td / f"mf{k}.back.wav" for k in range(len(srcs))]
        multifile.wav_to_x3a_batch(srcs, x3as, params, device=DEV)
        archives = [x.read_bytes() for x in x3as]
        cap, back = td / "quad.wav", td / "quad.back.wav"
        n = write_capture_wav(cap, params, X3M_FRAMES, X3M_TAIL, seed=400)
        mpath = multichannel.wav_to_x3m(cap, td / "quad", params, device=DEV)
        write_capture_wav(td / "quad2.wav", params, 2, 0, seed=300)
        small = multichannel.wav_to_x3m(td / "quad2.wav", td / "quad2", params, device=DEV)
        cap_mb = X3M_CHANNELS * n * 2 / 1e6

        def streams_exact():
            return all(np.array_equal(d, a) for (d, _), a in zip(multifile.decode_streams(archives, device=DEV),
                                                                 arrays))

        runs = (("x3a_to_wav_batch", mb, lambda: multifile.x3a_to_wav_batch(x3as, backs, device=DEV),
                 lambda: all(map(same_wav, backs, srcs))),
                ("decode_streams", mb, lambda: multifile.decode_streams(archives, device=DEV), streams_exact),
                ("x3m_to_wav", cap_mb, lambda: multichannel.x3m_to_wav(mpath, back, device=DEV),
                 lambda: same_file(back, cap)))
        for label, mbs, fn, exact in runs:
            fn()  # warm-up
            walls = [timed_call(fn)[0] for _ in range(3)]
            crc_cuda.launch_count = decode_cuda.launch_count = 0
            fn()
            k1, k3 = crc_cuda.launch_count, decode_cuda.launch_count
            require(exact(), f"profile {label}: the output differs from the input")
            log(f"# profile batch {label}: " + ", ".join(f"{t * 1e3:.3f} ms ({mbs / t:.1f} MB/s)" for t in walls)
                + f" over {mbs:.2f} MB of int16, unprofiled walls of 3 warm calls; one call launches K1 {k1}, "
                  f"K3 {k3} times")
            profile_call("batch", label, fn, top)
            t0 = time.perf_counter()
            waits = stream_waits(fn)
            wall = time.perf_counter() - t0
            log(f"# profile batch {label} waits of the main thread in a wall of {wall * 1e3:.3f} ms: on the "
                f"reader {waits['reader'] * 1e3:.3f} ms, on the read-back events {waits['event'] * 1e3:.3f} ms, "
                f"on the WAV writers' queues {waits['writer'] * 1e3:.3f} ms")
        r = rss_run("x3m", mpath, back, (small, td / "quad2.warm.wav"))
        require(same_file(back, cap), "profile x3m_to_wav in the measuring process differs from the input WAV")
        log(f"# profile batch x3m_to_wav in a fresh process: {cap_mb / r['times'][0]:.1f} MB/s, peak RSS growth "
            f"{r['growth']:.1f} MB ({r['how']}; bound {cap_mb / 2:.1f} MB)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to run on", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rss-child"]:  # phases 7 and 8's measuring process
        return rss_child(sys.argv[2:])
    # Phase 1: device.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    log(f"# phase 1 device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s); {'; '.join(smi)}")

    import x3_tpu_torch
    from x3_tpu_torch.ops import (
        _build, crc_cuda, decode_cuda, encode_cuda, front_cuda, pack_cuda, pack_walk_cuda)

    params = x3_tpu_torch.Parameters()
    kernels = {"crc16": crc_cuda, "encode": encode_cuda, "decode": decode_cuda}
    route_kernels = {"front": front_cuda, "pack_blocks": pack_cuda, "pack_walk": pack_walk_cuda}

    # Phase 2: build.
    log(f"# phase 2 build: {', '.join(_build.KERNELS)} with nvcc for sm_90a in "
        f"{_build.build_all():.1f} s ({_build.build_dir()})")

    if "--profile" in sys.argv[1:]:
        if sys.argv[sys.argv.index("--profile") + 1:][:1] != ["batch"]:
            profile_route_kernels(params)
            phase_profile(params)
        profile_batch(params)
        return 0

    # Phase 3: kernels against their plain versions.
    errs = Errs()
    phase_kernels(params, errs, np.random.default_rng(20261016))
    crc_sweep(errs, np.random.default_rng(20261017))
    k2_edges(errs, np.random.default_rng(20261018))
    pack_edges(errs, np.random.default_rng(20261019))

    # Phase 4: the main path; count only its launches.  A 4-frame run first
    # sets up what the first call would otherwise time (the CUDA caching
    # allocator, the kernels' libraries).
    slice_once(params, make_class_corpus(CLASSES[0], 4, params.samples_per_frame, seed=3),
               x3_tpu_torch.build_archive_header(SAMPLE_RATE, params))
    for mod in kernels.values():
        mod.launch_count = 0
    slices = phase_slice(params)
    launches = {k: mod.launch_count for k, mod in kernels.items()}
    log(f"# phase 4 launches: {launches}")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched by the main path")
    phase_pipeline(params, slices, np.random.default_rng(20261020))

    # Phase 5: kernels against their plain versions at the main path's
    # shapes, and their device times.
    times = phase_timing(params, slices, errs)
    first = times[CLASSES[0]]

    # Phase 6: the pack routes; count only their launches.
    route_launches, route_times = phase_routes(params, slices, errs, route_kernels)
    launches.update(route_launches)
    first.update(route_times)

    # Phase 7: the file layer; its own launch counts.
    rates7 = phase_files(params, slices, kernels, "; ".join(smi))

    # Phases 8 and 9: multi-file batching and multichannel .x3m, then the
    # mesh, the profiling hooks and the soak; each its own launch counts.
    with tempfile.TemporaryDirectory(prefix="x3_smoke_") as tmp:
        batch = phase_batch(params, kernels, "; ".join(smi), rates7, Path(tmp))
        phase_mesh(params, kernels, slices, batch, Path(tmp), "; ".join(smi))

    # Phase 10: the host tools and the examples; its own launch counts.
    phase_tools(kernels, errs)

    # Phase 11: the port's bench; its own launch counts.
    phase_bench(kernels)
    report = {"kernels": [
        {"name": k, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
         "launches": launches[k], "max_abs_err": errs.max.get(k, 0),
         "ms": first[k], "plain_ms": first[f"{k}_plain"], "bound_ms": first[f"{k}_bound"],
         "bound_by": "bytes", "library_ms": None}
        for k, mod in {**kernels, **route_kernels}.items()
    ]}
    print(json.dumps(report))
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-channel container convention: N mono archives and a sidecar
manifest (x3_tpu.multichannel).

The X3 wire format is strictly mono, so a multi-channel capture becomes
one `.x3a` archive per channel plus a small `.x3m` JSON manifest that
names them; the archives stay plain, individually decodable X3 files.
The manifest's bytes are x3_tpu's.

All channels' frames share device batches during encode
(multifile.encode_streams: K2 + K1 on "cuda") and, in x3m_to_wav, during
decode (multifile.decode_runs: K3 + K1, one call a window for every
channel); decode_multichannel reads each channel through files.X3aReader.
device="cpu" runs the plain PyTorch versions."""

from __future__ import annotations

import contextlib
import json
import wave
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .errors import X3Error
from .params import Parameters

MANIFEST_VERSION = 1


def encode_multichannel(
    samples_2d,
    sample_rate: int,
    base_path,
    params: Parameters | None = None,
    mesh=None,
    *,
    device="cuda",
):
    """Encode a [C, n] capture to base.ch<k>.x3a files and a base.x3m
    manifest.  Returns the manifest path."""
    from . import archive
    from .multifile import encode_streams

    samples_2d = np.atleast_2d(np.asarray(samples_2d, dtype=np.int16))
    base = Path(base_path)
    if base.suffix == ".x3m":
        base = base.with_suffix("")
    params = params or Parameters()
    results = encode_streams(list(samples_2d), params, mesh=mesh, device=device)
    files = []
    for k, res in enumerate(results):
        p = base.with_suffix(f".ch{k}.x3a")
        with open(p, "wb") as f:
            f.write(archive.build_archive_header(sample_rate, params))
            f.write(res.data)
        files.append(p.name)
    manifest = {
        "format": "x3m",
        "version": MANIFEST_VERSION,
        "channels": len(files),
        "sample_rate": sample_rate,
        "samples": int(samples_2d.shape[1]),
        "files": files,  # relative to the manifest's directory
    }
    mpath = base.with_suffix(".x3m")
    mpath.write_text(json.dumps(manifest, indent=1))
    return mpath


def decode_multichannel(manifest_path, engine: str = "auto", batch_frames: int | None = None, *,
                        device="cuda"):
    """Decode a .x3m manifest back to ([C, n] int16 samples, sample_rate).

    Channels stream through files.X3aReader (a frame index, then one
    read a batch), so beyond the output array only one decode batch is
    resident: the compressed archives are never held in memory."""
    from .files import X3aReader

    device = resolve_device(device)
    manifest, mpath = _load_manifest(manifest_path)
    rate = manifest["sample_rate"]
    chans = []
    for name in manifest["files"]:
        with X3aReader(mpath.parent / name, engine=engine, batch_frames=batch_frames, device=device) as r:
            if r.spec.sample_rate != rate:
                raise X3Error("manifest/archive sample rate mismatch")
            chans.append(r.read_samples(0, r.n_samples))
    n = manifest.get("samples")
    out = np.stack(chans)
    if n is not None and out.shape[1] != n:
        raise X3Error(f"decoded {out.shape[1]} samples, manifest says {n}")
    return out, rate


def read_wav_multichannel(path):
    """Read a WAV of any channel count; returns ([C, n] int16, rate)."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise X3Error(f"only 16-bit WAV supported, got {8 * w.getsampwidth()}-bit")
        c = w.getnchannels()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    flat = np.frombuffer(raw, dtype="<i2").astype(np.int16)
    return flat.reshape(-1, c).T.copy(), rate


def write_wav_multichannel(path, samples_2d, sample_rate: int) -> None:
    """Write [C, n] int16 samples as an interleaved multi-channel WAV."""
    samples_2d = np.atleast_2d(np.asarray(samples_2d, dtype="<i2"))
    with wave.open(str(path), "wb") as w:
        w.setnchannels(samples_2d.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(np.ascontiguousarray(samples_2d.T).tobytes())


def wav_to_x3m(wav_path, base_path, params: Parameters | None = None, mesh=None, *, device="cuda"):
    """Multi-channel WAV -> per-channel archives and a manifest.  The WAV is
    read whole, as in x3_tpu."""
    device = resolve_device(device)
    chans, rate = read_wav_multichannel(wav_path)
    return encode_multichannel(chans, rate, base_path, params, mesh, device=device)


def x3m_to_wav(manifest_path, wav_path, engine: str = "auto", batch_frames: int | None = None, *,
               device="cuda") -> int:
    """Manifest -> multi-channel WAV.  Returns the channel count.

    Streaming, in x3_tpu's windows of batch_frames x samples_per_frame
    samples a channel (the first channel's Parameters): each channel is
    indexed in sequential reads (archive.index_frames_file), then each
    window's frames that cover it (X3aReader.read_samples' cover, so frames
    of any length work) go, one run a channel and one read a run, through
    one decode call for all channels (multifile.decode_runs; one a
    Parameters where channels differ), are interleaved to [n, C] on the
    device, read back once and written by the WAV's writer thread.  Peak
    memory is O(channels x batch) whatever the capture's length.

    The errors are x3_tpu's, in its order: each channel's header and walk,
    then the sample rates, counts and the manifest's count, before any
    decode; then by window, channel and frame, a frame's payload CRC
    (FrameHeaderInvalidPayloadCRC "frame {i} payload CRC mismatch") before
    its decode ("frame {i} failed to decode"), after every earlier window
    was written and the WAV's header patched."""
    from . import archive
    from .engine import resolve_batch_frames, resolve_engine
    from .models.sharding import check_mesh
    from .multifile import DecodeBatch, decode_runs, file_span_reader
    from .utils.wav import WavWriter

    device = resolve_device(device)
    manifest, mpath = _load_manifest(manifest_path)
    rate = manifest["sample_rate"]
    engine = resolve_engine(engine)
    handles = []
    try:
        specs, indexes = [], []
        for name in manifest["files"]:
            f = open(mpath.parent / name, "rb")
            handles.append(f)
            spec, hs = archive.read_archive_header_file(f)
            specs.append(spec)
            indexes.append(archive.index_frames_file(f, hs))
        for spec in specs:
            if spec.sample_rate != rate:
                raise X3Error("manifest/archive sample rate mismatch")
        sample_offsets = [np.concatenate([[0], np.cumsum(ix.n_samples, dtype=np.int64)]) for ix in indexes]
        total = int(sample_offsets[0][-1])
        for off in sample_offsets[1:]:
            if off[-1] != total:
                raise X3Error("channel archives disagree on sample count")
        want = manifest.get("samples")
        if want is not None and total != want:
            raise X3Error(f"decoded {total} samples, manifest says {want}")
        bf = resolve_batch_frames(batch_frames, engine, decode=True)
        win = max(1, bf) * specs[0].params.samples_per_frame

        # A window's batches: its channels grouped by Parameters (one
        # group as a rule), each channel's frames that cover the window one
        # run.
        batches = []
        for start in range(0, total, win):
            n = min(win, total - start)
            groups: dict = {}
            for c, (spec, off) in enumerate(zip(specs, sample_offsets)):
                f0 = int(np.searchsorted(off, start, side="right")) - 1
                f1 = int(np.searchsorted(off, start + n, side="left"))
                groups.setdefault(spec.params, []).append((c, f0, f1, start - int(off[f0])))
            for g, (params, members) in enumerate(groups.items()):
                batches.append(DecodeBatch(
                    params,
                    np.concatenate([np.full(f1 - f0, c, np.int64) for c, f0, f1, _ in members]),
                    np.concatenate([np.arange(f0, f1, dtype=np.int64) for _, f0, f1, _ in members]),
                    archive.FrameIndex.concat(indexes[c][f0:f1] for c, f0, f1, _ in members),
                    tag=_Window(n, [c for c, *_ in members], [skip for *_, skip in members],
                                g == len(groups) - 1)))

        def interleave(batch, flat):
            # [n, channels] on the device: each channel's n samples from
            # `skip` into its run.
            n, skips = batch.tag.n, batch.tag.skips
            heads = np.concatenate([[0], np.cumsum(batch.index.n_samples, dtype=np.int64)])
            return torch.stack([flat[int(heads[a]) + skip : int(heads[a]) + skip + n]
                                for (_, a, _), skip in zip(batch.runs(), skips)], dim=1)

        mesh = check_mesh(None, device)
        with WavWriter(wav_path, rate, channels=len(specs)) as wout, contextlib.closing(
                decode_runs(batches, file_span_reader(handles), mesh, interleave)) as decoded:
            window = []
            for batch, block, err, crc_ok in decoded:
                window.append((batch, block, err, crc_ok))
                if not batch.tag.last:
                    continue
                _raise_first_bad(window, len(specs))
                if len(window) == 1:
                    wout.write(block)
                else:
                    out = np.empty((batch.tag.n, len(specs)), np.int16)
                    for b, blk, _, _ in window:
                        out[:, b.tag.channels] = blk
                    wout.write(out)
                window = []
        return len(specs)
    finally:
        for f in handles:
            f.close()


class _Window(NamedTuple):
    """A decode batch's part of an x3m_to_wav window."""

    n: int  # the window's samples a channel
    channels: list  # the batch's channels
    skips: list  # where each channel's window starts in its run
    last: bool  # the window's last batch


def _raise_first_bad(window, channels: int) -> None:
    """Raise the error of a window's first bad frame, by channel, then
    frame, a frame's payload CRC before its decode (X3aReader.read_samples'
    order): window holds each of its batches' (batch, samples, err,
    crc_ok)."""
    from .errors import FrameHeaderInvalidPayloadCRC, decode_error

    for c in range(channels):
        for batch, _, err, crc_ok in window:
            rows = np.flatnonzero(batch.keys == c)
            bad = rows[~crc_ok[rows] | (err[rows] != 0)]
            if len(bad):
                j = int(bad[0])
                if not crc_ok[j]:
                    raise FrameHeaderInvalidPayloadCRC(f"frame {batch.frames[j]} payload CRC mismatch")
                raise decode_error(int(err[j]), f"frame {batch.frames[j]} failed to decode")


def _load_manifest(manifest_path) -> tuple[dict, Path]:
    """Parse and check an .x3m manifest: the format marker and the version
    gate, shared by every manifest consumer so that a manifest of a later
    version is never read under the wrong rules."""
    mpath = Path(manifest_path)
    manifest = json.loads(mpath.read_text())
    if manifest.get("format") != "x3m":
        raise X3Error(f"not an x3m manifest: {manifest_path}")
    if manifest.get("version", 0) > MANIFEST_VERSION:
        raise X3Error(f"unsupported x3m version {manifest['version']}")
    return manifest, mpath


def x3m_info(manifest_path, *, device="cuda") -> dict:
    """Manifest metadata and per-channel x3a_info (header index only: no
    payload is read, so `device` is only checked)."""
    from .files import x3a_info

    device = resolve_device(device)
    manifest, mpath = _load_manifest(manifest_path)
    per_channel = [x3a_info(mpath.parent / name, device=device) for name in manifest["files"]]
    total = sum(i["archive_bytes"] for i in per_channel)
    pcm = sum(i["pcm_bytes"] for i in per_channel)
    return {
        "channels": manifest["channels"],
        "sample_rate": manifest["sample_rate"],
        "samples_per_channel": manifest.get("samples"),
        "archive_bytes": total,
        "pcm_bytes": pcm,
        "compression_ratio": round(pcm / total, 3) if total else 0.0,
        "files": list(manifest["files"]),
        "per_channel": per_channel,
    }


def verify_x3m(manifest_path, engine: str = "auto", verbose: bool = False, *, device="cuda") -> dict:
    """Check every channel archive of a manifest (verify_x3a per channel)
    and the manifest's consistency (channel count, sample counts).  A
    failure carries a ``reason`` (printed when verbose), so a FAILED verdict
    with no frame errors is never silent; ``engine`` is the engine used."""
    from .engine import resolve_engine
    from .files import verify_x3a

    device = resolve_device(device)
    manifest, mpath = _load_manifest(manifest_path)
    reports = []
    ok = True
    reason = None
    if len(manifest["files"]) != manifest["channels"]:
        ok = False
        reason = (
            f"manifest lists {len(manifest['files'])} files "
            f"but says channels={manifest['channels']}"
        )
        if verbose:
            print(reason)
    want = manifest.get("samples")
    for name in manifest["files"]:
        rep = verify_x3a(mpath.parent / name, engine=engine, verbose=verbose, device=device)
        rep["file"] = name
        if want is not None and rep["n_samples_ok"] != want:
            rep["ok"] = False
            rep.setdefault("reason", f"sample count {rep['n_samples_ok']} != manifest {want}")
            if verbose:
                print(f"{name}: {rep['reason']}")
        ok = ok and rep["ok"]
        reports.append(rep)
    out = {
        "ok": ok,
        "channels": len(reports),
        "engine": reports[0]["engine"] if reports else resolve_engine(engine),
        "frame_errors": sum(r["frame_errors"] for r in reports),
        "skipped_bytes": sum(r["skipped_bytes"] for r in reports),
        "per_channel": reports,
    }
    if reason is None:
        # The first failed channel's reason, if any, at the top level.
        reason = next((r.get("reason") for r in reports if not r["ok"] and r.get("reason")), None)
    if reason is not None:
        out["reason"] = reason
    return out

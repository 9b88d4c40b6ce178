"""Frame-sharded encode and decode over a mesh of devices
(x3_tpu.parallel.mesh).

Each entry of the mesh takes a contiguous shard of the batch's frames and
runs the one-device pipeline on its own device (K2 + K1 for encode, K3 for
decode on a card; the plain versions on the CPU); the shards' outputs are
gathered on the mesh's first device, and no shard talks to another inside
the codec.  The mesh and the sharding itself live in models.sharding,
under the batch APIs that run every call through it.

A mesh may list a device more than once: each entry is one shard.  That is
how one card, or the CPU, runs a mesh of several shards (the port's
counterpart of XLA's --xla_force_host_platform_device_count)."""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.sharding import AXIS, Mesh, check_mesh, shard_map
from ..params import Parameters

__all__ = ["AXIS", "Mesh", "check_mesh", "decode_frames_sharded", "encode_frames_sharded", "make_mesh",
           "roundtrip_step", "shard_map"]


def make_mesh(devices=None, axis_name: str = AXIS, *, device="cuda") -> Mesh:
    """A mesh over `devices`, or by default over every visible card
    (torch.cuda.device_count() of them).  A CUDA request without a card
    raises RuntimeError (device.resolve_device); device="cpu" gives a
    one-entry CPU mesh."""
    if devices is None:
        dev = resolve_device(device)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] \
            if dev.type == "cuda" else [dev]
    return Mesh(devices, axis_name)


def encode_frames_sharded(samples, n_valid, params: Parameters, mesh: Mesh, w_words: int | None = None,
                          nw_words: int | None = None) -> dict:
    """Encode an [F, S] batch sharded across the mesh's frame axis: the
    keys, shapes and values of ops.encode_kernel.encode_frames on the whole
    batch ("block" route), gathered on mesh.devices[0].  F must be a
    multiple of mesh.size.  w_words/nw_words: the rungs (encode_frames)."""
    from ..ops.encode_kernel import encode_frames

    return shard_map(lambda s, n: encode_frames(s, n, params, "block", w_words, nw_words), mesh, samples, n_valid)


def decode_frames_sharded(payload, n_samples, payload_lens, params: Parameters, mesh: Mesh,
                          n_blocks: int | None = None):
    """Decode an [F, W*4] payload batch sharded across the mesh's frame
    axis: ops.decode_kernel.decode_frames' (samples, err), gathered on
    mesh.devices[0]."""
    from ..ops.decode_kernel import decode_frames

    return shard_map(lambda p, n, pl: decode_frames(p, n, pl, params, n_blocks), mesh, payload, n_samples,
                     payload_lens)


def _words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """uint8 [F, W*4] big-endian bytes of int32 [F, W] payload words, on
    the words' device."""
    f, w = words.shape
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(f, w * 4)


def roundtrip_step(params: Parameters, mesh: Mesh):
    """The sharded pipeline step (encode -> bytes -> decode -> verify) as a
    callable (samples [F, S], n_valid [F]) -> (nbytes int32 [F], exact
    bool scalar), both on mesh.devices[0].  Each shard's verdict is an int
    on its device; the verdicts are gathered and summed on the first
    device (x3_tpu's psum), and nothing is read back to the host."""
    from ..ops.decode_kernel import decode_frames
    from ..ops.encode_kernel import encode_frames

    def local(s, n):
        enc = encode_frames(s, n, params)
        dec, err = decode_frames(_words_to_bytes(enc["payload_words"]), n, enc["nbytes"], params)
        valid = torch.arange(dec.shape[1], device=dec.device)[None, :] < n[:, None]
        exact = torch.where(valid, dec == s.to(torch.int16), True).all()
        return enc["nbytes"], (exact & ~err.any()).to(torch.int32)[None]

    def step(samples, n_valid):
        nbytes, ok = shard_map(local, mesh, samples, n_valid)
        return nbytes, ok.sum() == mesh.size

    return step

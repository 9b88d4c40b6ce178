"""The device mesh and frame sharding under the batch APIs.

Frames are self-contained, so scaling out is data parallelism over a 1-D
mesh on the frame axis: each entry of the mesh takes a contiguous shard of
a batch's frames, runs the one-device pipeline on its own device, and the
shards' outputs are gathered on the mesh's first device.  Every batch call
runs through shard_map; a call without a mesh runs on a one-entry mesh of
its device, which is the unsharded work.

A mesh may list a device more than once: each entry is one shard.  That is
how one card, or the CPU, runs a mesh of several shards (the port's
counterpart of XLA's --xla_force_host_platform_device_count)."""

from __future__ import annotations

import torch

from ..device import resolve_device

AXIS = "frames"


class Mesh:
    """A 1-D mesh: the device of each shard, in order, and the axis name."""

    def __init__(self, devices, axis_name: str = AXIS):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got {[str(d) for d in self.devices]}")
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis_name={self.axis_name!r})"


def check_mesh(mesh: Mesh | None, device) -> Mesh:
    """The mesh a batch call runs on: `mesh`, whose devices must be of
    `device`'s type (the mesh then decides where the work runs), or a
    one-entry mesh of `device` when there is none."""
    dev = resolve_device(device)
    if mesh is None:
        return Mesh([dev])
    if mesh.device_type != dev.type:
        raise ValueError(f"mesh devices {[str(d) for d in mesh.devices]} are not of the "
                         f"requested device type {dev.type!r}")
    return mesh


def _gather(parts: list, mesh: Mesh) -> torch.Tensor:
    """Per-shard tensors concatenated on axis 0 on mesh.devices[0]."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


def _to(a: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`a` on `dev`; a copy from pinned host memory to a card does not
    block the host (a pageable one would, until the stream's queued work
    has run)."""
    return a.to(dev, non_blocking=dev.type == "cuda" and not a.is_cuda and a.is_pinned())


def shard_map(fn, mesh: Mesh, *arrays):
    """fn(*shard) on each mesh entry's device, the arrays (tensors or numpy,
    [F, ...] each) split into mesh.size contiguous shards on axis 0; F must
    be a multiple of mesh.size.  fn returns a tensor, a tuple or a dict of
    [F/size, ...] tensors, and the gathered result has the same structure
    over the whole batch, on mesh.devices[0].  Every shard is enqueued,
    from the calling thread (the kernels' launch counters are plain module
    globals), before any output is gathered, and nothing is read back."""
    arrays = [torch.as_tensor(a) for a in arrays]
    f = arrays[0].shape[0]
    if f % mesh.size:
        raise ValueError(f"{f} frames do not split evenly over a mesh of {mesh.size}")
    k = f // mesh.size
    parts = [fn(*(_to(a[i * k : (i + 1) * k], dev) for a in arrays)) for i, dev in enumerate(mesh.devices)]
    if isinstance(parts[0], dict):
        return {key: _gather([p[key] for p in parts], mesh) for key in parts[0]}
    if isinstance(parts[0], tuple):
        return tuple(_gather(list(outs), mesh) for outs in zip(*parts))
    return _gather(parts, mesh)

"""Multi-process input pipeline: shard file worklists across processes
(x3_tpu.parallel.multihost).

The codec needs no collectives (frames are self-contained), so running it
on many hosts is an input-pipeline concern: each process takes a
deterministic shard of the file list, converts it with its own mesh over
its local devices and never talks to the others.  In a
`torch.distributed` job, call `shard_worklist(paths)` on every rank and
feed the shard to `multifile.wav_to_x3a_batch(..., mesh=local_mesh())`.
"""

from __future__ import annotations


def shard_worklist(items, process_index: int | None = None, process_count: int | None = None):
    """Deterministic per-process shard of a worklist: process i takes
    items[i::n].

    process_index / process_count default to torch.distributed's rank and
    world size inside an initialized process group, else to 0 and 1 (so
    the default is the identity).  Strided sharding balances file sizes
    better than contiguous chunks when lists are sorted."""
    if process_index is None or process_count is None:
        import torch.distributed as dist

        grouped = dist.is_available() and dist.is_initialized()
        if process_index is None:
            process_index = dist.get_rank() if grouped else 0
        if process_count is None:
            process_count = dist.get_world_size() if grouped else 1
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} not in [0, {process_count})")
    return list(items)[process_index::process_count]


def local_mesh(axis_name: str = "frames", *, device="cuda"):
    """A mesh over this process's visible cards (parallel.mesh.make_mesh),
    or a one-entry CPU mesh for device="cpu": per-process data
    parallelism, with no axis across processes since the codec needs no
    collectives."""
    from .mesh import make_mesh

    return make_mesh(None, axis_name, device=device)

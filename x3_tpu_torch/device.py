"""Device selection for the PyTorch port.

Every public entry point takes an explicit `device`.  Asking for CUDA on a
host without a usable GPU is an error: the port never quietly runs a CUDA
request on the CPU (a CPU run of the plain versions is asked for with
device="cpu")."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cuda", "cuda:1", "cpu" or a torch.device).

    Raises RuntimeError for a CUDA device when torch.cuda.is_available() is
    false, and ValueError for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev

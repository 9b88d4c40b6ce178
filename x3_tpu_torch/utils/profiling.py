"""Profiling and observability hooks (x3_tpu.utils.profiling).

* `trace(logdir)` — a torch.profiler recording of the enclosed region
  (CPU and, with a card, CUDA activity), written to `logdir` as a Chrome
  trace (chrome://tracing, Perfetto);
* `annotate(name)` — a named range around a region, seen by torch.profiler
  and, on a card, by NVTX;
* `aot_compile(...)` — builds the kernels and runs one encode and one
  decode at a batch shape, so the first real call pays for neither the
  nvcc build nor the libraries' loading and the allocator's growth (the
  port's counterpart of x3_tpu's ahead-of-time compile);
* module-level `logger` — the library's logging channel.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

logger = logging.getLogger("x3_tpu_torch")


@contextlib.contextmanager
def trace(logdir):
    """Record the enclosed region with torch.profiler and write it to
    `logdir` as a Chrome trace.  One recording with no schedule: no cycle
    boundary drops events.  Yields the profiler; the trace's path is its
    `trace_path` attribute once the region has ended."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities, acc_events=True)  # keep every event of the recording
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()  # the region's kernels end inside the recording
        prof.stop()
        path = os.path.join(str(logdir), f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path
        n_device = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        logger.info("trace: %d device events kept, written to %s", n_device, path)


@contextlib.contextmanager
def annotate(name: str):
    """A named range around the enclosed region: a torch.profiler
    record_function, and on a card an NVTX range too."""
    import torch

    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def aot_compile(batch_frames: int, params=None, decode: bool = True, *, device="cuda") -> dict:
    """Build the kernels (on a card) and run one encode, and with `decode`
    one decode, of `batch_frames` frames on `device`.  Returns
    {"encode": fn(samples, n_valid) -> encode_frames' dict, "decode":
    fn(payload, n_samples, payload_lens) -> (samples, err)}, taking numpy
    arrays or tensors and running on `device` at the default rungs."""
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..ops.decode_kernel import decode_frames
    from ..ops.encode_kernel import encode_frames, frame_geometry
    from ..params import Parameters

    dev = resolve_device(device)
    params = params or Parameters()
    if dev.type == "cuda":
        from ..ops import _build

        _build.build_all()

    def on_dev(a):
        return torch.as_tensor(a).to(dev)

    def enc(samples, n_valid):
        return encode_frames(on_dev(samples), on_dev(n_valid), params)

    def dec(payload, n_samples, payload_lens):
        return decode_frames(on_dev(payload), on_dev(n_samples), on_dev(payload_lens), params)

    S, _, _, W = frame_geometry(params)
    n_valid = np.zeros(batch_frames, np.int32)
    enc(np.zeros((batch_frames, S), np.int16), n_valid)
    out = {"encode": enc}
    if decode:
        dec(np.zeros((batch_frames, W * 4), np.uint8), n_valid, n_valid)
        out["decode"] = dec
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    logger.info("warmed the pipelines for batch_frames=%d on %s", batch_frames, dev)
    return out

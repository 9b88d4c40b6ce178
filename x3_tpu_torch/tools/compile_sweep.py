"""Cold-build sweep of the port (the port's tools/compile_sweep.py): build
every CUDA kernel from csrc/ into a fresh build directory, then launch
each (kernel, rung) the file pipeline can dispatch once, synchronised.

    python -m x3_tpu_torch.tools.compile_sweep          # on the card, in a fresh process
    python -m x3_tpu_torch.tools.compile_sweep --device cpu --block-len 4 --blocks-per-frame 8

Why: the build directory keeps each kernel's library under a hash of its
sources, so a source that no longer compiles can hide behind a library
built before, and a launch that fails only at a rung no test runs hides
until a file needs that rung.  So the sweep points X3_TORCH_BUILD_DIR at
a new temporary directory, builds the six kernels there (one nvcc a
source, all started together; each nvcc's wall seconds are reported),
and then runs, on an all-zero batch:

* encode_frames at every width rung W (K2 + K1, --enc-batch frames);
* the three other pack routes at every (W, NW): "fused_pallas" (K4 + K5),
  "block_pallas" (K5) and "block" with X3_FUSED_ENCODE=0 X3_PALLAS_PACK=1
  (K6), each + K1;
* decode_frames and decode_frames_checked at every W (K3 + K1,
  --dec-batch frames), and the foreign-geometry decode at n_blocks = 2B.

Every encode must give the same words, sizes, CRCs and statistics, and
every decode the same samples and error codes.  One ok/FAIL row a
configuration; exit code 1 if any fails.  The kernels' libraries are
loaded once a process, so the sweep must run in a process of its own.
With --device cpu nothing is built and the plain versions run.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

ROUTE_ENV = {  # the non-default pack routes: name -> (pack_mode, environment)
    "fused_pallas": ("fused_pallas", {}),
    "block_pallas": ("block_pallas", {}),
    "block/walk": ("block", {"X3_FUSED_ENCODE": "0", "X3_PALLAS_PACK": "1"}),
}


def _log(msg: str) -> None:
    print(msg, flush=True)


def cold_build(log=_log) -> int:
    """Build every kernel into $X3_TORCH_BUILD_DIR; one row a kernel.
    Returns the number of kernels that failed to build."""
    from ..ops import _build

    times: dict = {}
    try:
        wall = _build.build_all(times)
        err = None
    except Exception as e:  # noqa: BLE001 - reported as rows
        wall, err = None, e
    for name in _build.KERNELS:
        if name in times:
            log(f"ok   {'build ' + name + '.cu':42s} {times[name]:6.1f}s")
        else:
            log(f"FAIL {'build ' + name + '.cu':42s} {type(err).__name__}: {str(err)[:400]}")
    if wall is not None:
        log(f"ok   {'build all (in parallel)':42s} {wall:6.1f}s")
    return len(_build.KERNELS) - len(times)


def sweep(params, enc_batch: int, dec_batch: int, device, log=_log) -> int:
    """Launch every configuration once on `device`; returns the failures."""
    import torch

    from ..ops.decode_kernel import decode_frames, decode_frames_checked
    from ..ops.encode_kernel import block_width_rungs, encode_frames, frame_geometry, width_rungs

    S, B, L, _ = frame_geometry(params)
    rungs = width_rungs(params)
    failures = []
    ref = {}  # kind -> (name, outputs) of the first configuration of the kind

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def check(name, kind, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            secs = time.perf_counter() - t0
            first, want = ref.setdefault(kind, (name, out))
            if not same(out, want):
                raise AssertionError(f"outputs differ from {first}'s")
            log(f"ok   {name:42s} {secs:6.1f}s")
        except Exception as e:  # noqa: BLE001 - a row, not a crash
            failures.append(name)
            log(f"FAIL {name:42s} {type(e).__name__}: {str(e)[:400]}")

    def enc_out(res):
        return (res["payload_words"][:, : rungs[0]], res["nbytes"], res["crc"], res["stats"],
                res["total_bits"], res["blockfit_bits"])

    def encode(mode, env, w, nw=None):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            return enc_out(encode_frames(samples, nv, params, mode, w, nw))
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    Fe, Fd = enc_batch, dec_batch
    samples = torch.zeros((Fe, S), dtype=torch.int16, device=device)
    nv = torch.full((Fe,), S, dtype=torch.int32, device=device)
    for w in rungs:
        check(f"encode F={Fe} w={w}", "encode", lambda w=w: encode("block", {}, w))
    for route, (mode, env) in ROUTE_ENV.items():
        for w in rungs:
            for nw in block_width_rungs(params):
                check(f"encode {route} F={Fe} w={w} nw={nw}", "encode",
                      lambda mode=mode, env=env, w=w, nw=nw: encode(mode, env, w, nw))

    ns = torch.full((Fd,), S, dtype=torch.int32, device=device)
    plens = torch.full((Fd,), 64, dtype=torch.int32, device=device)
    for w in rungs:
        payload = torch.zeros((Fd, w * 4), dtype=torch.uint8, device=device)
        check(f"decode F={Fd} w={w}", "decode", lambda p=payload: decode_frames(p, ns, plens, params))
        check(f"decode_checked F={Fd} w={w}", "decode_checked",
              lambda p=payload: decode_frames_checked(p, ns, plens, params))
    # Foreign-geometry decode (models.decoder.decode_geometry's n_blocks
    # escalation): the first power-of-two bucket past the default.
    nb = 2 * B
    payload = torch.zeros((Fd, rungs[0] * 4), dtype=torch.uint8, device=device)
    ns2 = torch.full((Fd,), 1 + nb * L, dtype=torch.int32, device=device)
    check(f"decode F={Fd} n_blocks={nb}", "decode",
          lambda: tuple(x[:, :S] if x.dim() == 2 else x
                        for x in decode_frames(payload, ns2, plens, params, nb)))
    return len(failures)


def main(argv=None) -> int:
    from ..device import resolve_device
    from ..ops import _build
    from .fuzz_soak import parse_params

    ap = argparse.ArgumentParser(prog="python -m x3_tpu_torch.tools.compile_sweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--enc-batch", type=int, default=768)
    ap.add_argument("--dec-batch", type=int, default=2048)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions, nothing built)")
    ap.add_argument("--block-len", type=int, default=None, help="geometry (default: Parameters())")
    ap.add_argument("--blocks-per-frame", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = parse_params(args)
    if dev.type != "cuda":
        _log("build: none on the CPU (the plain versions run)")
        failures = sweep(params, args.enc_batch, args.dec_batch, dev)
    else:
        if _build.load.cache_info().currsize:
            raise RuntimeError("compile_sweep needs a fresh process: this one has loaded kernels already")
        old = os.environ.get("X3_TORCH_BUILD_DIR")
        with tempfile.TemporaryDirectory(prefix="x3_cold_build_") as td:
            os.environ["X3_TORCH_BUILD_DIR"] = td
            try:
                failures = cold_build()
                if not failures:
                    failures = sweep(params, args.enc_batch, args.dec_batch, dev)
            finally:
                if old is None:
                    os.environ.pop("X3_TORCH_BUILD_DIR", None)
                else:
                    os.environ["X3_TORCH_BUILD_DIR"] = old
    if failures:
        print(f"\n{failures} configuration(s) FAILED")
        return 1
    print("\nall configurations build and launch cold" if dev.type == "cuda"
          else "\nall configurations run (plain versions)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

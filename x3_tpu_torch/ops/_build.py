"""Build and load the port's CUDA kernels (csrc/*.cu) on first use.

Each source compiles with nvcc for Hopper (sm_90a) into its own shared
library with a plain C interface, which is loaded with ctypes.  Libraries
are named by a hash of their sources and flags, so an edited source is
rebuilt and an unchanged one is reused.  Nothing is built when a module is
imported: the CPU paths never reach this file.

The build directory is `build/x3_tpu_torch/` beside the package (ignored by
git), or $X3_TORCH_BUILD_DIR when set."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..utils.profiling import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("crc16", "encode", "decode", "front", "pack_blocks", "pack_walk")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def build_dir() -> Path:
    env = os.environ.get("X3_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "x3_tpu_torch"


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then PATH, then the toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"libx3_{name}-{_source_hash(name)}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same hash exists.
    Raises RuntimeError carrying nvcc's stderr when the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def build_all(times: dict | None = None) -> float:
    """Build every kernel, one nvcc per source, all started together;
    returns the wall seconds it took, and puts each kernel's own wall
    seconds (its nvcc, or the check for its library) into `times`."""
    def timed(name):
        t = time.perf_counter()
        build(name)
        if times is not None:
            times[name] = time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        list(pool.map(timed, KERNELS))  # re-raises the first failed build
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load(name: str, symbol: str, n_ptr: int, n_int: int):
    """ctypes function `symbol` from csrc/<name>.cu, built on first use.

    Every exported function takes `n_ptr` device pointers, then `n_int`
    ints, then the CUDA stream, and returns the cudaError_t of its launch.
    An x3.kernels.build span covers the build (built: 1 when nvcc ran)
    and the load."""
    with span("x3.kernels.build", loaded=1) as sp:
        sp.add(built=int(not library_path(name).exists()))
        lib = ctypes.CDLL(str(build(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_launch(rc: int, what: str) -> None:
    """Raise when a launch returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def resource_usage(name: str) -> str:
    """ptxas' report (registers, spills, shared memory) for csrc/<name>.cu,
    compiled with the kernels' own flags plus -Xptxas -v."""
    out = build_dir() / f"ptxas-{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-o", str(out),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stderr}")
    return proc.stderr.strip()


if __name__ == "__main__":
    # python -m x3_tpu_torch.ops._build [kernel ...]: print ptxas' resource
    # usage of each kernel source (all six by default).
    import sys

    for kernel in sys.argv[1:] or KERNELS:
        print(f"# {kernel}.cu\n{resource_usage(kernel)}", flush=True)

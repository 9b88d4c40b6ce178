"""The benchmark's run: one cell of BENCHMARK.json, from its data files.

    python3 x3bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (configs/<config>.json: the streams, their
signal, sample rate and codec parameters) and a traffic mix
(traffic/<traffic>.json: the entry point, the number of clients and the
traced seconds).  One process drives the card: each client is a thread
that converts its own streams, call after call, in a closed loop (one
client on the default CUDA stream, as a caller would; several, a stream
each).

Set-up (`setup_s`, from the start of run.py to the window's start): the
imports and the CUDA context, each client's streams made from the seed,
the entry's inputs (for a decode, the archives), and the traffic's
`warmup_calls` a client, in turn.  The window starts when every client has reached a
barrier; clients start no call after `--seconds`, and the window ends
when the last call in flight ends.  A rate is all the bytes of all
completed calls over the whole window.  With `--trace 1` the window runs
just the same and gives the per-layer metrics that are not read from a
trace; then every client goes on converting for the traffic's
`trace_seconds` under torch.profiler, which gives the trace's metrics.

Once the windows have closed, the plain reference (reference/x3codec.py)
works out every client's archives again and compare.py holds the calls'
outputs to them: a uniform sample of each client's calls, drawn from the
seed, and its last call.  The last line of stdout is the result as one JSON object;
the numbers compared, each beside its limit, are the last lines of stderr
and the result's last key."""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import resource
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "x3_tpu"})  # top-level names, compared whole
KEEP_DRAWS = 16  # calls a client keeps for the comparison: a uniform sample of its window's calls, and its last
SAMPLE_S = 0.01  # the host memory sampler's period
STACK_SAMPLE_S = 0.002  # the traced window's sampler of the clients' stacks
BARRIER_S = 900.0  # a client that never reaches a barrier breaks it after this


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, its traffic
    and the names of the metrics it reports."""

    def __init__(self, name: str, root: Path = ROOT):
        bench_path = root / "BENCHMARK.json"
        bench = load_json(bench_path)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {bench_path.name}")
        w = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.name, self.chips = name, w["chips"]
        self.config = load_json(root / conf["file"])
        self.traffic = load_json(root / HERE.name / "traffic" / f"{w['traffic']}.json")
        self.metrics_dir = root / HERE.name / "metrics"
        self.end_to_end = [m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [
            m["name"] for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in self.end_to_end)
        ]
        self.units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}


DIRECTIONS = ("decode", "encode")


def load_reader(name: str, metrics_dir: Path = HERE / "metrics"):
    """metrics/<name>.py, whose read(run) gives the metric or None.  A
    metric of one direction, `<stem>.<direction>` or `<direction>_<stem>`,
    that has no file of its own takes metrics/<stem>.py and reads only the
    runs of that direction."""
    path, direction = metrics_dir / f"{name}.py", None
    if not path.exists():
        for d in DIRECTIONS:
            stem = name[: -len(d) - 1] if name.endswith("." + d) else (
                name[len(d) + 1 :] if name.startswith(d + "_") else None)
            if stem:
                path, direction = metrics_dir / f"{stem}.py", d
                break
    spec = importlib.util.spec_from_file_location(f"x3bench.metrics.{path.stem.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if direction is None:
        return mod.read
    return lambda run: mod.read(run) if run.direction == direction else None


class Call:
    __slots__ = ("client", "start", "end", "ok")

    def __init__(self, client: int, start: float, end: float, ok: bool):
        self.client, self.start, self.end, self.ok = client, start, end, ok


class Client:
    """One client: its streams, the inputs a call takes, its calls and the
    outputs it keeps for the comparison."""

    def __init__(self, index, streams, inputs, rng, stream):
        self.index, self.streams, self.inputs, self.rng = index, streams, inputs, rng
        self.stream = stream
        self.calls, self.traced_calls, self.kept, self.errors = [], [], [], []
        self.last = None
        self.warmup_failed = []
        self.done = threading.Event()

    def context(self):
        import torch

        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def loop(self, call, deadline, calls, keep: bool) -> None:
        k = 0
        while True:
            t = time.perf_counter()
            if t >= deadline[0]:
                return
            try:
                out, ok = call(self.inputs), True
            except Exception:  # noqa: BLE001 - a failed call is counted and reported
                out, ok = None, False
                self.errors.append(traceback.format_exc())
            calls.append(Call(self.index, t, time.perf_counter(), ok))
            if keep and ok:  # reservoir sampling: each call of the window is kept with equal chance
                slot = k if k < KEEP_DRAWS else int(self.rng.integers(0, k + 1))
                if slot >= KEEP_DRAWS:
                    self.last = out
                elif slot < len(self.kept):
                    self.kept[slot], self.last = out, None
                else:
                    self.kept.append(out)
                    self.last = None
                k += 1


class Run:
    """What the metric readers read: the window's calls and clock, the
    host's CPU seconds, the program's launch counters, the trace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def completed_bytes(self) -> int:
        return sum(self.bytes_per_call[c.client] for c in self.calls if c.ok)

    @property
    def completed_frames(self) -> int:
        return sum(self.frames_per_call[c.client] for c in self.calls if c.ok)


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _launches() -> dict:
    from x3_tpu_torch.ops import crc_cuda, decode_cuda, encode_cuda

    return {"k1": crc_cuda.launch_count, "k2": encode_cuda.launch_count, "k3": decode_cuda.launch_count}


def _params(pdict: dict):
    from x3_tpu_torch import Parameters

    return Parameters(block_len=pdict["block_len"], blocks_per_frame=pdict["blocks_per_frame"],
                      codes=tuple(pdict["codes"]), thresholds=tuple(pdict["thresholds"]))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        clients: int | None = None, params: dict | None = None):
    """Set up, warm up, run the window(s) and compare.  Returns (result,
    checks): the result's dict without its checks, and the checks as
    {name: (value, limit)}."""
    import torch

    from . import compare
    from . import streams as gen

    parts = {}  # set-up's parts, in seconds, for the record on stderr
    tick = time.perf_counter()

    def part(name):
        nonlocal tick
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + now - tick
        tick = now

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.empty(1, device=dev)  # the CUDA context
    part("cuda_context")
    import x3_tpu_torch.multifile  # noqa: F401 - the program's modules, before its first call
    import x3_tpu_torch.models.encoder  # noqa: F401

    part("port_import")
    entry = importlib.import_module(f"x3bench.entries.{cell.traffic['entry']}")
    pdict = dict(params or cell.config["params"])
    prm = _params(pdict)
    spf = pdict["block_len"] * pdict["blocks_per_frame"]
    rate = cell.config["sample_rate"]
    n = clients or cell.traffic["clients"]

    def call(inputs):
        return entry.call(inputs, rate, prm, device)

    cl = []
    for i in range(n):  # one client uses the default stream, as a caller would; several, a stream each
        streams = gen.make_streams(cell.config, seed, i, dev)
        _sync(dev)
        part("streams")
        inputs = entry.prepare(streams, rate, prm, device)
        _sync(dev)
        part("inputs")
        cl.append(Client(i, streams, inputs, np.random.default_rng(gen.client_seed(seed, i, 2)),
                         torch.cuda.Stream(dev) if dev.type == "cuda" and n > 1 else None))
    _sync(dev)
    for c in cl:  # warm-up calls a client, in turn: every lazily built table and cache exists before the window
        for _ in range(cell.traffic.get("warmup_calls", 1)):
            with c.context():
                t = time.perf_counter()
                try:
                    call(c.inputs)
                except Exception:  # noqa: BLE001 - counted as a failed call, like the window's
                    c.errors.append(traceback.format_exc())
                    c.warmup_failed.append(Call(c.index, t, time.perf_counter(), False))
            _sync(dev)
    part("warm_up")

    bytes_per_call = {c.index: 2 * sum(len(s) for s in c.streams) for c in cl}
    frames_per_call = {c.index: sum(-(-len(s) // spf) for s in c.streams) for c in cl}
    batches_per_call = {c.index: entry.batches(c.streams, spf) for c in cl}

    mark: dict = {}
    deadline1, deadline2 = [float("inf")], [float("inf")]

    def start1():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        mark["setup_end"] = time.time()
        mark["cpu0"], mark["launch0"] = _cpu_s(), _launches()
        mark["t0"] = time.perf_counter()
        deadline1[0] = mark["t0"] + seconds

    def start2():
        deadline2[0] = time.perf_counter() + cell.traffic["trace_seconds"]

    b1 = threading.Barrier(n + 1, action=start1, timeout=BARRIER_S)
    b2 = threading.Barrier(n + 1, action=start2, timeout=BARRIER_S)

    def body(c: Client):
        try:
            with c.context():
                b1.wait()
                c.loop(call, deadline1, c.calls, keep=True)
                c.done.set()
                if trace:
                    b2.wait()
                    c.loop(call, deadline2, c.traced_calls, keep=False)
        except BaseException:  # a client that cannot go on breaks the barriers: the run ends without a result
            b1.abort()
            b2.abort()
            raise
        finally:
            c.done.set()

    threads = [threading.Thread(target=body, args=(c,), name=f"client{c.index}") for c in cl]
    for t in threads:
        t.start()
    b1.wait()
    peak = _rss_bytes()
    while not all(c.done.is_set() for c in cl):
        time.sleep(SAMPLE_S)
        peak = max(peak, _rss_bytes())
    cpu1, launch1 = _cpu_s(), _launches()
    calls = [k for c in cl for k in c.calls]
    t1 = max([k.end for k in calls], default=mark["t0"])
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    tr, traced_calls = None, []
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from . import trace as tracing

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        b2.wait()
        samples, idents = [], {t.ident for t in threads}
        with record_function(tracing.WINDOW):
            p0 = time.perf_counter()
            while time.perf_counter() < deadline2[0]:  # the clients' stacks, for the idle gaps' labels
                now = time.perf_counter() - p0
                frames = sys._current_frames()
                samples += [(now, tracing.stack_label(f)) for i, f in frames.items() if i in idents]
                time.sleep(STACK_SAMPLE_S)
        for t in threads:
            t.join()
        _sync(dev)
        prof.stop()
        events = prof.profiler.kineto_results.events()
        w0 = next(e.start_ns() for e in events if e.name() == tracing.WINDOW) * 1e-9
        tr = tracing.read(events, [(w0 + t, label) for t, label in samples])
        traced_calls = [k for c in cl for k in c.traced_calls]
    for t in threads:
        t.join()

    # The windows have closed and the device peak is read: the reference.
    t_ref = time.perf_counter()
    with ThreadPoolExecutor(max_workers=n) as pool:
        refs = list(pool.map(lambda c: compare.Reference(c.streams, rate, pdict), cl))
    t_ref = time.perf_counter() - t_ref
    found: dict = {}
    n_compared = 0
    for c, ref in zip(cl, refs):
        outs = c.kept + ([c.last] if c.last is not None else [])
        n_compared += len(outs)
        for k, v in entry.check(c.inputs, outs, c.streams, rate, ref).items():
            found[k] = found.get(k, 0) + v
    all_calls = calls + traced_calls + [k for c in cl for k in c.warmup_failed]
    found["failed_calls"] = sum(not k.ok for k in all_calls)
    checks = {k: (v, compare.LIMITS[k]) for k, v in found.items()}
    correct = n_compared > 0 and all(v <= lim for v, lim in checks.values())

    run_rec = Run(
        direction=entry.DIRECTION, calls=calls, start=mark["t0"], end=t1, cpu_s=cpu1 - mark["cpu0"],
        launches={k: launch1[k] - mark["launch0"][k] for k in launch1},
        bytes_per_call=bytes_per_call, frames_per_call=frames_per_call, batches_per_call=batches_per_call,
        payload_bytes_per_call={c.index: r.payload_bytes for c, r in zip(cl, refs)},
        host_peak_bytes=peak, setup_s=mark["setup_end"] - t_start, trace=tr, traced_calls=traced_calls,
    )
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name in names:
        value = load_reader(name, cell.metrics_dir)(run_rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": cell.units[name]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(mem_peak),
    }
    result = {"correct": bool(correct), "attempted": len(all_calls),
              "failed": sum(not k.ok for k in all_calls), "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["calls"] = {"window": len(calls), "traced": len(traced_calls), "compared": n_compared,
                       "clients": n, "window_s": t1 - mark["t0"]}
    buckets = np.zeros(max(1, int(np.ceil((t1 - mark["t0"]) / 2.0))))
    for k in calls:
        if k.ok:
            buckets[min(len(buckets) - 1, int((k.end - mark["t0"]) / 2.0))] += bytes_per_call[k.client]
    print("# set-up seconds: " + " ".join(f"{k}={v:.3f}" for k, v in parts.items())
          + f" (before run(): {mark['setup_end'] - t_start - sum(parts.values()):.3f});"
          + f" the reference after the windows: {t_ref:.3f}", file=sys.stderr)
    print("# MB/s by 2 s of the window: " + " ".join(f"{b / 2e6:.0f}" for b in buckets), file=sys.stderr)
    for c in cl:
        for err in c.errors[:1]:
            print(f"# client {c.index}: a call raised:\n{err}", file=sys.stderr)
    return result, checks


def _host_notes() -> str:
    """The host's CPUs, the cgroup's CPU limit and the bytes this process
    wrote, for the record on stderr."""
    notes = [f"cpus={os.cpu_count()}", f"affinity={len(os.sched_getaffinity(0))}"]
    for path, key in (("/sys/fs/cgroup/cpu.max", "cpu.max"), ("/proc/self/io", None)):
        try:
            text = Path(path).read_text()
        except OSError:
            continue
        if key:
            notes.append(f"{key}={text.strip()}")
        else:
            notes += [ln.replace(": ", "=") for ln in text.splitlines() if ln.startswith(("write_bytes", "rchar", "wchar"))]
    notes.append(f"ru_maxrss_kb={resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}")
    return " ".join(notes)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.time() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        cell = Cell(args.workload)
    except (KeyError, OSError) as e:
        print(f"x3bench: {e}", file=sys.stderr)
        return 1
    if importlib.util.find_spec("x3_tpu_torch") is None:
        print("x3bench: the program under test (x3_tpu_torch) is not in this checkout", file=sys.stderr)
        return 1
    # The port's kernel cache, at a fixed path inside the checkout.
    os.environ["X3_TORCH_BUILD_DIR"] = str(ROOT / "build" / "x3_tpu_torch")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"x3bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available={torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result, checks = run(cell, args.seed, args.seconds, bool(args.trace), t_start, "cuda")

    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if loaded:
        print(f"x3bench: modules that must not load were loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(f"# host: {_host_notes()}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0

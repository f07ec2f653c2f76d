"""What every cell of the benchmark shares: finding a cell's files by the
names in ``BENCHMARK.json``, the run's environment, the harness's own
spans around calls into the program, reading the profiler's trace, the
per-layer metric readers, and the result line.

A cell's files: ``configs/<config>.json`` (the model), ``traffic/<mix>.json``
(the mix; its ``driver`` names ``drivers/<driver>.py``), and one reader
``metrics/<metric>.py`` for each per-layer metric, each with
``read(record) -> float | None``.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# the program's caches, at fixed paths inside the checkout: the plan store
# here; the kernels' libraries in build/torch_kernels/ (the program's own)
PLAN_CACHE = HERE / ".cache" / "plans"
# top-level module names that may not be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare_environment() -> None:
    """The run's environment, before the program is imported."""
    os.environ["REPRO_PLAN_CACHE"] = str(PLAN_CACHE)
    os.environ["USE_FLAX"] = "0"
    PLAN_CACHE.mkdir(parents=True, exist_ok=True)
    src = str(REPO / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> Dict:
    return load_json(REPO / "BENCHMARK.json")


def find_cell(bench: Dict, name: str) -> Tuple[Dict, Dict, Dict]:
    """(workload entry, config, traffic) of the cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(REPO / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return w, config, traffic


def load_limits(cell: str) -> Dict[str, float]:
    """Each compared number's limit of the cell (``limits/<cell>.json``)."""
    d = load_json(HERE / "limits" / f"{cell}.json")
    return {k: v["limit"] for k, v in d["limits"].items()}


@dataclass
class Context:
    """One run's cell, settings and device.  ``control`` (read the lower
    precision's and the planted faults' numbers too) is for the runs that
    set the limits, never the benchmark's own."""
    bench: Dict
    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    limits: Dict[str, float]
    control: bool = False
    # "module:function" called first in each process a driver starts (a
    # test's way to plant a fault under the ranks of a mesh run)
    hook: str = ""


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - ticks / os.sysconf("SC_CLK_TCK")


def program_config(config: Dict):
    """The program's ``ModelConfig`` of a config file (its known keys)."""
    from dataclasses import fields
    from repro_torch.models.config import ModelConfig
    known = {f.name for f in fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in config.items() if k in known})


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """``drivers/<kind>.py``, imported by name (a driver that starts
    processes hands them its functions by that name)."""
    return importlib.import_module(f"drivers.{kind}")


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({n for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def forbidden_loaded(out: Dict) -> List[str]:
    """:func:`forbidden_modules` of this process and of every process the
    driver started (each reports its own under ``out["forbidden"]``)."""
    return sorted(set(forbidden_modules()) | set(out.get("forbidden", ())))


# ------------------------------------------------------------------ spans


class Spans:
    """Named spans the harness takes around its calls into the program:
    CUDA events on the card (read once the window has closed), the host
    clock elsewhere; ``seconds(name)`` lists each span's length."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.on = False           # spans are taken only while on
        self._open: Dict[str, List] = {}

    def mark(self):
        if self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, name: str, start, end) -> None:
        self._open.setdefault(name, []).append((start, end))

    def wrap(self, name: str, fn: Callable) -> Callable:
        def call(*a, **k):
            if not self.on:
                return fn(*a, **k)
            t0 = self.mark()
            out = fn(*a, **k)
            self.add(name, t0, self.mark())
            return out
        return call

    def seconds(self, name: str) -> List[float]:
        if self.cuda and self._open.get(name):
            import torch
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in self._open[name]]
        return [b - a for a, b in self._open.get(name, [])]


# ------------------------------------------------------------------ trace


@dataclass
class Trace:
    """What a profiled stretch of the run shows: its length, the seconds
    in which a device operation ran (the union of their intervals), and
    each device operation's launches and seconds by name."""
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[int, float]]
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernels(self, *needles: str) -> Tuple[int, float]:
        """(launches, device seconds) of the operations whose name holds
        one of ``needles``."""
        n = s = 0
        for name, (c, t) in self.ops.items():
            if any(x in name for x in needles):
                n, s = n + c, s + t
        return n, s

    def breakdown(self) -> Dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[k[:160], t] for k, (_, t) in top],
                "idle_gaps": [[k[:160], t] for k, t in self.idle_gaps[:10]]}


def read_trace(prof, t0_ns: int, t1_ns: int) -> Trace:
    """A :class:`Trace` of the profiler's events within [t0_ns, t1_ns]
    (the profiler's clock).  Idle gaps between device operations are
    named by the innermost host operation running at the gap's middle."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if s + d < t0_ns or s > t1_ns:
            continue
        if e.device_type() == cuda:
            # kernels, copies and sets; not the device side of a host
            # annotation, which spans whatever ran under it
            if e.name() != "Command Buffer Full" \
                    and not e.is_user_annotation():
                dev.append((max(s, t0_ns), min(s + d, t1_ns), e.name()))
        else:
            host.append((s, s + d, e.name()))
    ops: Dict[str, List] = {}
    for s, e, n in dev:
        c = ops.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += (e - s) / 1e9
    dev.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, None
    prev_end = t0_ns
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > prev_end:
                gaps.append((prev_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if t1_ns > prev_end:
        gaps.append((prev_end, t1_ns))
    host.sort()
    starts = [h[0] for h in host]
    named: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(-1, i - 400), -1):
            if host[j][1] >= mid:
                best = host[j][2]
                break
        key = f"host:{best}" if best else "host:none"
        named[key] = named.get(key, 0.0) + (b - a) / 1e9
    return Trace(window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy / 1e9,
                 ops={k: (c, t) for k, (c, t) in ops.items()},
                 idle_gaps=sorted(named.items(), key=lambda kv: -kv[1]))


def profile_stretch(fn: Callable[[], None], host: bool = False) -> Trace:
    """Run ``fn`` under ``torch.profiler`` and read the stretch from its
    first device operation's start to its last one's end.  The device
    alone is traced unless ``host``: tracing every host operation slows a
    host-paced step by about a second, so a stretch traced with the host
    serves only to name the idle gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda and not e.is_user_annotation()]
    if not spans:
        raise RuntimeError("the profiler recorded no device operation")
    return read_trace(prof, min(s for s, _ in spans),
                      max(e for _, e in spans))


def traced(run: Callable[[], None]) -> Trace:
    """The trace of one stretch of ``run`` (device only), its idle gaps
    named from a second stretch traced with the host."""
    trace = profile_stretch(run)
    trace.idle_gaps = profile_stretch(run, host=True).idle_gaps
    return trace


# ---------------------------------------------------------------- results


@dataclass
class Record:
    """What a run hands the per-layer metric readers."""
    cell: Dict
    config: Dict
    traffic: Dict
    chips: int
    window_s: float
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict = field(default_factory=dict)
    trace: Optional[Trace] = None


def roofline_pct(record: Record, kind: str, needles: Tuple[str, ...],
                 shape_key: str) -> Optional[float]:
    """A kernel's share of its roofline in the traced stretch: its
    launches times the least time one launch could take at the cell's
    shape (:mod:`counts`), over the device time the trace gives them, in
    %; None where the kernel did not run."""
    import counts
    if record.trace is None or shape_key not in record.counters:
        return None
    n, seconds = record.trace.kernels(*needles)
    if n == 0 or seconds <= 0:
        return None
    least_ms = counts.launch_bound_ms(kind, record.counters[shape_key])
    return 100.0 * n * least_ms / 1e3 / seconds


def calls_roofline_pct(record: Record, kind: str, needles: Tuple[str, ...],
                       calls_key: str) -> Optional[float]:
    """A kernel's share of its roofline in the traced stretch, where each
    call into the program there (``record.counters[calls_key]``, one shape
    a call) launched the kernel equally often: the least time of each
    call's launch, times the launches a call, over the device time the
    trace gives them, in %; None where the kernel did not run."""
    import counts
    calls = record.counters.get(calls_key)
    if record.trace is None or not calls:
        return None
    n, seconds = record.trace.kernels(*needles)
    if n == 0 or seconds <= 0:
        return None
    least_ms = sum(counts.launch_bound_ms(kind, c) for c in calls) \
        * n / len(calls)
    return 100.0 * least_ms / 1e3 / seconds


def idle_pct(record: Record) -> Optional[float]:
    """The share of the traced stretch in which no device operation ran,
    in % (on several chips the highest over them)."""
    if record.counters.get("idle_pct") is not None:   # the most of ranks'
        return record.counters["idle_pct"]
    t = record.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(record: Record) -> Optional[float]:
    """Model FLOPs of the window over the window times the chips' bf16
    peak, in %."""
    import counts
    flops = record.counters.get("model_flops")
    if not flops or record.window_s <= 0:
        return None
    return 100.0 * flops / (record.window_s * counts.PEAK_FLOPS["bfloat16"]
                            * record.chips)


def read_per_layer(bench: Dict, record: Record) -> Dict:
    out = {}
    for m in cell_metrics(bench, record.cell["name"], "per_layer"):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             f"portbench_metric_{m['name']}")
        v = reader.read(record)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def percentile(xs: List[float], q: float) -> float:
    """The ``q`` quantile (0..1) of ``xs``, linear between order
    statistics."""
    s = sorted(xs)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def checks_text(checks: List[Tuple[str, float, float]]) -> List[str]:
    return [f"check {name} {value!r} limit {limit!r}"
            for name, value, limit in checks]


def emit(result: Dict, checks: List[Tuple[str, float, float]]) -> None:
    """The compared numbers as the last lines on standard error, and the
    result as the last line on standard output, with the checks last."""
    for line in checks_text(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    print(json.dumps(result), flush=True)

"""The benchmark's harness: runs one cell of BENCHMARK.json once and prints
its result line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is found by name, so a later change adds one by adding
files and entries:
- the cell's entry in BENCHMARK.json names its configuration and its
  traffic mix;
- the configuration's entry names its file (`benchmark/configs/`);
- `benchmark/traffic/<traffic>.json` is the mix: the `kind` of its
  generator, its parameters and the limits of its correctness numbers;
- `benchmark/traffic/<kind>.py` is the generator, whose `run(ctx)` builds
  the system under test, warms it, runs the measured (or traced) window,
  checks the window's work against the plain reference and returns an
  `Outcome`;
- `benchmark/metrics/<metric>.py` reads one per-layer metric from the
  traced window (`Trace`: the profiler's kernels and ranges, and the
  generator's own `values` by name) with `read(trace)`, or returns None
  where that window has nothing to read.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "seal3d_tpu")
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
# named ranges of the program and of the benchmark; the profiler also puts
# them on the device timeline, where they are no device work
RANGE_PREFIXES = ("step.", "render.", "bench.", "tensorf.", "ProfilerStep",
                  "pretrain.", "occupancy.", "edit.", "seal.")


@dataclass
class Check:
    """One compared number, its limit, and whether it holds."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Trace:
    """What a traced window gives the per-layer readers. Times in seconds;
    `kernels` and `ranges` are (name, start_s, end_s) on one clock;
    `values` holds what the cell's generator recorded beside the trace
    (its keys are the generator's, each reader looks up its own)."""
    window: tuple                       # (start_s, end_s)
    kernels: list                       # device activities
    ranges: list                        # host events (ranges, ops, API)
    launches: int                       # kernel launch calls
    values: dict = field(default_factory=dict)


@dataclass
class Outcome:
    """What a traffic generator's run returns."""
    metrics: dict                       # end-to-end metric name -> value
    checks: list                        # [Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[Trace] = None


@dataclass
class Context:
    workload: str
    seed: int
    seconds: float
    trace: bool
    chips: int
    config: dict                        # the configuration file
    mix: dict                           # the traffic mix file
    t_start: float                      # process start, time.perf_counter()
    device: Any = "cuda"
    probe: Optional[str] = None         # proof readings: control / fault


def note(ctx: "Context", msg: str):
    """A progress line on standard error, with the seconds since start."""
    print(f"[bench {time.perf_counter() - ctx.t_start:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


def note_clocks(ctx: "Context", when: str):
    """The card's clocks, power and temperature on standard error (read
    outside the window)."""
    if ctx.device.type == "cuda":
        note(ctx, f"{when}: sm, mem MHz, W, C: {smi(CLOCKS)}")


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(path: str, name: str):
    s = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def cell_parts(bench: dict, workload: str):
    """(cell entry, configuration entry, configuration file, mix file,
    generator module) of a cell of BENCHMARK.json, found by name."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    gen = load_module(os.path.join(HERE, "traffic", mix["kind"] + ".py"),
                      f"bench_traffic_{mix['kind']}")
    return cell, conf, config, mix, gen


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of `workload` reports: with trace the
    per-layer metrics whose `workloads` lists it (or, without that key,
    whose `moves` metric the cell reports), else the end-to-end ones whose
    `workloads` lists it or that have no such key."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def read_per_layer(entries: list, trace: Trace) -> dict:
    """{name: value} of the per-layer readers that find something."""
    out = {}
    for m in entries:
        mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                          "bench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(trace)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def smi(query: str = "name,power.limit") -> str:
    """nvidia-smi's reading of the card (by default its name and power
    limit), or "" where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


# ------------------------------------------------------------ trace reading

def collect(prof, window_name: str = "bench.window") -> tuple:
    """(window, kernels, ranges, launches) of a torch.profiler run whose
    measured part sits in a `window_name` range: device activities and host
    events as (name, start_s, end_s) on the profiler's clock."""
    from torch.autograd import DeviceType

    kernels, ranges, launches = [], [], 0
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith(RANGE_PREFIXES)):
                kernels.append((name, start, end))
            continue
        ranges.append((name, start, end))
        if name in LAUNCH_KEYS:
            launches += 1
        elif name == window_name:
            window = (start, end)
    if window is None:
        raise RuntimeError(f"the trace holds no {window_name!r} range")
    return window, kernels, ranges, launches


def busy_intervals(kernels, window) -> list:
    """Merged [start, end) intervals in which the device ran anything,
    clipped to the window."""
    lo, hi = window
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e in kernels
                if e > lo and s < hi)
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace.kernels, trace.window))


def window_seconds(trace: Trace) -> float:
    return trace.window[1] - trace.window[0]


def device_idle(trace: Trace) -> float:
    """% of the traced window with nothing running on the device."""
    return 100.0 * (1.0 - busy_seconds(trace) / window_seconds(trace))


def kernel_roofline(trace: Trace, kernels: tuple, calls: list
                    ) -> Optional[float]:
    """% of a kernel's profiled device time that its least time takes: the
    sum over its launches of roofline.encode_least_seconds (`calls`: rows,
    levels, F of each), over the device time in the window of the kernels
    whose names hold one of `kernels`. None where it did not run."""
    from benchmark.reference import roofline

    lo, hi = trace.window
    dev = sum(min(e, hi) - max(s, lo) for n, s, e in trace.kernels
              if any(k in n for k in kernels) and e > lo and s < hi)
    if not calls or dev <= 0:
        return None
    least = sum(roofline.encode_least_seconds(rows, levels, f)
                for rows, levels, f in calls)
    return 100.0 * least / dev


def step_mfu(trace: Trace) -> Optional[float]:
    """% of the card's peak that the window's model FLOPs take: the least
    time of the field's MLP products at the bf16 peak and of its encodes
    and SH at the fp32 peak (`values["model_flops"]`), over the traced
    window."""
    from benchmark.reference import roofline

    flops = trace.values.get("model_flops")
    if not flops:
        return None
    least = roofline.least_seconds_mixed(flops["mlp"], flops["fp32"])
    return 100.0 * least / window_seconds(trace)


def _program_range(name: str) -> bool:
    return name.startswith(RANGE_PREFIXES)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by what the host was doing: the innermost program range
    open at the gap's middle, then the innermost host event there."""
    lo, hi = trace.window
    by_op = {}
    for name, s, e in trace.kernels:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            by_op[name] = by_op.get(name, 0.0) + d
    busy = busy_intervals(trace.kernels, trace.window)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    events = sorted(trace.ranges, key=lambda r: r[1])
    starts = [r[1] for r in events]
    progs = [r for r in events if _program_range(r[0])]
    pstarts = [r[1] for r in progs]

    def innermost(evs, st, t, look=256):
        i = bisect.bisect_right(st, t)
        for j in range(i - 1, max(i - 1 - look, -1), -1):
            if evs[j][2] > t and evs[j][0] != "bench.window":
                return evs[j][0]
        return "-"

    by_gap = {}
    for s, e in gaps:
        t = 0.5 * (s + e)
        key = f"{innermost(progs, pstarts, t)} / {innermost(events, starts, t)}"
        by_gap[key] = by_gap.get(key, 0.0) + (e - s)
    def best(d):
        return [[k[:200], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": best(by_op), "idle_gaps": best(by_gap)}


# ------------------------------------------------------------------- main

def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--probe", default=None,
                   help="proof readings instead of a run: 'control' (the "
                        "reference at the precision below the stated one in "
                        "the program's place) or a fault planted in the "
                        "program (see the traffic kind's FAULTS)")
    args = p.parse_args(argv)

    bench = spec()
    cell, conf, config, mix, gen = cell_parts(bench, args.workload)

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found", file=sys.stderr)
        return 2
    ctx = Context(workload=args.workload, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  chips=cell["chips"], config=config, mix=mix,
                  t_start=t_start, device=torch.device("cuda", 0),
                  probe=args.probe)
    return finish(bench, ctx, gen)


def finish(bench: dict, ctx: Context, gen) -> int:
    """Run the cell and print its result line (stdout's last line) and its
    compared numbers (stderr's last lines)."""
    out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        outcome = gen.run(ctx)
        entries = metrics_of(bench, ctx.workload, ctx.trace)
        if ctx.probe:
            metrics = {}
        elif ctx.trace:
            metrics = read_per_layer(entries, outcome.trace)
        else:
            metrics = {m["name"]: {"value": float(outcome.metrics[m["name"]]),
                                   "unit": m["unit"]} for m in entries}
        bad = forbidden_modules()
        if bad:
            print(f"benchmark: loaded {bad}; the run must not load JAX or "
                  f"the JAX package", file=sys.stderr)
            return 3
        import torch

        dev = ctx.device
        device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": ctx.chips,
                  "memory_peak_bytes": int(outcome.memory_peak_bytes)}
        line = {"correct": all(c.ok for c in outcome.checks)
                and bool(outcome.checks),
                "attempted": int(outcome.attempted),
                "failed": int(outcome.failed), "metrics": metrics,
                "device": device}
        if ctx.trace and outcome.trace is not None:
            tr = outcome.trace
            device["busy_s"] = busy_seconds(tr)
            device["window_s"] = tr.window[1] - tr.window[0]
            line["breakdown"] = breakdown(tr)
        line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                          for c in outcome.checks}
        print(f"benchmark: {ctx.workload} seed {ctx.seed} on "
              f"{smi() or device['kind']}", file=sys.stderr)
        for c in outcome.checks:
            print(f"check {c.name} {c.value:.6g} limit {c.limit:.6g} "
                  f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    out.write(json.dumps(line) + "\n")
    out.flush()
    return 0

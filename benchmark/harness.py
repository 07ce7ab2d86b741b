"""One run of one cell: set-up, the measured window, the check, the line.

:func:`main` is ``run.py``'s body: it refuses to run without enough CUDA
cards, runs the cell (:func:`run_cell`) and prints the compared numbers
with their limits as the last lines of standard error and the result as
the last line of standard output. :func:`run_cell` does the rest and takes
any device, so that the tests drive it on the CPU.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from benchmark import check

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dirt_tpu")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    loop: object
    pipeline: object
    reference: object
    end_to_end: list
    per_layer: list


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its configuration,
    mix, loop, pipelines and metrics found by name."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[workload["config"]]["file"])
                        .read_text())
    mix = json.loads((BENCH / "traffic" / f"{workload['traffic']}.json")
                     .read_text())
    return Cell(
        name=name, workload=workload, config=config, mix=mix,
        loop=importlib.import_module(f"benchmark.loops.{mix['loop']}"),
        pipeline=importlib.import_module(
            f"benchmark.pipelines.{config['pipeline']}"),
        reference=importlib.import_module(
            f"benchmark.reference.{config['pipeline']}"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def quantity(metric_name: str) -> str:
    """What a metric measures: its name up to the first dot. A metric
    ``<quantity>.<group>`` is that quantity, reported in the cells it
    lists under a bound of its own (``step_ms.device_bound``)."""
    return metric_name.split(".")[0]


def reader(metric_name: str):
    """The reader module of a per-layer metric, ``layers/<quantity>.py``."""
    return importlib.import_module(
        f"benchmark.layers.{quantity(metric_name)}")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _window(loop, seconds, device):
    """Steps until ``seconds`` have passed: (steps, failed, window seconds,
    per-step ms on the device's clock)."""
    on_card = torch.device(device).type == "cuda"
    marks = []
    steps = failed = 0
    _sync(device)
    start = time.perf_counter()
    while True:
        if on_card:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        failed += not loop.step()
        steps += 1
        if time.perf_counter() - start >= seconds:
            break
    if on_card:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    _sync(device)
    window = time.perf_counter() - start
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return steps, failed, window, step_ms


def _traced(loop, steps, device, chunk):
    """``steps`` steps under the profiler, in sessions of ``chunk`` steps:
    (Window, steps run, failed). The profiler drops records of graph
    replays now and then (more in long sessions): a session in which a
    replay shows fewer operations than the most any replay showed is set
    aside and another is traced, up to three times as many sessions as
    needed."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import Window

    # The card's activity; on the CPU (the tests) the host's, which gives
    # readers nothing to read.
    activity = (ProfilerActivity.CUDA if torch.device(device).type == "cuda"
                else ProfilerActivity.CPU)
    failed = run = 0
    sessions = []
    for _ in range(3 * -(-steps // chunk)):
        with profile(activities=[activity]) as prof:
            _sync(device)
            start = time.perf_counter()
            for _ in range(chunk):
                failed += not loop.step()
            _sync(device)
            seconds = time.perf_counter() - start
        run += chunk
        sessions.append(Window.from_profile(prof, chunk, seconds))
        most = max((n for w in sessions for n in w.replays()), default=0)
        kept = [w for w in sessions
                if w.replays() == [most] * chunk and most > 0]
        if len(kept) * chunk >= steps or most == 0:
            break
    return Window.merge(kept or sessions), run, failed


def card(device) -> dict:
    """The ``device`` entry of the result line."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": torch.cuda.max_memory_reserved()}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             start: float, cell_limits: dict | None = None):
    """Run ``cell`` once; returns the result line's dict (its ``checks``
    last). ``start`` is the host clock at the process's start."""
    imports_s = time.perf_counter() - start
    loop = cell.loop.build(cell, seed, device, trace)
    _sync(device)
    setup_s = time.perf_counter() - start
    phases = {"imports": imports_s, **loop.phases.seconds}
    print("setup phases (s): " + ", ".join(
        f"{name} {value:.3f}" for name, value in phases.items()),
        file=sys.stderr)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        setup_peak = torch.cuda.max_memory_reserved()
        torch.cuda.reset_peak_memory_stats()
    breakdown = None
    if not trace:
        steps, failed, window_s, step_ms = _window(loop, seconds, device)
        values = {"setup_s": setup_s, "step_ms": window_s / steps * 1e3}
        if len(step_ms) >= 2:
            cuts = statistics.quantiles(step_ms, n=20)
            values["step_p95_ms"] = cuts[18]
            print(f"window: {steps} steps in {window_s:.3f} s; device-clock "
                  f"step ms at 5/25/50/75/95%: {cuts[0]:.4f} {cuts[4]:.4f} "
                  f"{cuts[9]:.4f} {cuts[14]:.4f} {cuts[18]:.4f}; max "
                  f"{max(step_ms):.4f}", file=sys.stderr)
        if on_card:
            values["peak_mem_mib"] = torch.cuda.max_memory_reserved() / 2**20
        traced = None
    else:
        traced, steps, failed = _traced(loop, cell.mix["trace_steps"], device,
                                        cell.mix.get("trace_chunk", 5))
        print(f"trace: {len(traced.replays())} replays of "
              f"{sorted(set(traced.replays()))} operations kept, {steps} "
              f"steps run", file=sys.stderr)
        forward = loop.forward_ms(cell.mix.get("forward_replays", 0))
        values = {}
    device_info = card(device)
    if on_card:
        device_info["memory_peak_bytes"] = max(setup_peak,
                                               torch.cuda.max_memory_reserved())
    collected = loop.close()
    del loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, covered = cell.loop.check_run(cell, collected, device)
    if cell_limits is None:
        cell_limits = check.limits(cell.name)
    correct, table = check.judge(numbers, cell_limits)
    if trace:
        data = {"window": traced, "forward_ms": forward, "covered": covered,
                "cell": cell}
        if on_card:
            device_info.update(busy_s=traced.busy_s(),
                               window_s=traced.window_s)
            breakdown = {"device_ops": traced.top_ops(),
                         "idle_gaps": traced.top_gaps()}
        for metric in cell.per_layer:
            value = reader(metric["name"]).read(data)
            if value is not None:
                values[quantity(metric["name"])] = value
    declared = cell.per_layer if trace else cell.end_to_end
    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": {m["name"]: {"value": values[quantity(m["name"])],
                                      "unit": m["unit"]}
                          for m in declared if quantity(m["name"]) in values},
              "device": device_info}
    if breakdown:
        result["breakdown"] = breakdown
    result["checks"] = table
    return result


def main(args, start: float) -> int:
    """Run one cell on the card and print its result; the exit code."""
    cell = load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {chips} CUDA card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", start)
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}, which it must not",
              file=sys.stderr)
        return 3
    for name, entry in result["checks"].items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(plain(result)))
    return 0


def plain(value):
    """``value`` with every float that is not finite written as a string
    (JSON has no infinity)."""
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value

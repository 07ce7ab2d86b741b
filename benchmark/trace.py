"""The profiler's record of a traced window, reduced to what readers need.

``torch.profiler`` (CUDA activity) traces the card over ``trace_steps``
steps. Each device operation (kernel, copy, fill) carries the correlation
id of the host call that launched it: every operation of one graph replay
shares the id of its ``cudaGraphLaunch``. A window counts as complete when
it shows one replay per step and every replay the same number of
operations (the profiler has been seen to drop records of replays); the
per-step metrics are read only from complete windows.

Kernels are the port's own when their symbol names a ``__global__``
function of ``dirt_tpu_torch/csrc`` (or a ``triton.jit`` function of the
package); everything else on the device (PyTorch's, cub's and cuBLAS's
kernels, copies and fills) is glue.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1] / "dirt_tpu_torch"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)")


def program_kernels(package: Path = PACKAGE):
    """Names of the kernels the port's sources define."""
    names = set()
    for path in list(package.rglob("*.cu")) + list(package.rglob("*.cuh")):
        names.update(_GLOBAL.findall(path.read_text()))
    for path in package.rglob("*.py"):
        names.update(_TRITON.findall(path.read_text()))
    return names


def is_program_kernel(name: str, kernels) -> bool:
    words = set(re.findall(r"\w+", name))
    return not words.isdisjoint(kernels)


class Window:
    """Device operations of a traced window of ``steps`` steps, in one or
    more profiler sessions.

    ``sessions``: per session, (name, start_ns, end_ns, correlation) per
    device operation; ``launches``: {correlation: host call name};
    ``window_s``: the host clock over the sessions' steps."""

    def __init__(self, sessions, launches, steps, window_s, kernels):
        self.sessions = [sorted(ops, key=lambda op: op[1])
                         for ops in sessions]
        self.ops = [op for ops in self.sessions for op in ops]
        self.launches = launches
        self.steps = steps
        self.window_s = window_s
        self.kernels = kernels

    @classmethod
    def from_profile(cls, prof, steps, window_s):
        from torch.autograd import DeviceType

        ops, launches = [], {}
        for event in prof.profiler.kineto_results.events():
            if event.device_type() == DeviceType.CUDA:
                ops.append((event.name(), event.start_ns(), event.end_ns(),
                            event.correlation_id()))
            else:
                launches[event.correlation_id()] = event.name()
        return cls([ops], launches, steps, window_s, program_kernels())

    @classmethod
    def merge(cls, windows):
        """One window of several profiler sessions' windows."""
        launches = {}
        for window in windows:
            launches.update(window.launches)
        return cls([ops for w in windows for ops in w.sessions], launches,
                   sum(w.steps for w in windows),
                   sum(w.window_s for w in windows), windows[0].kernels)

    def replays(self):
        """Operation count of each graph replay in the window."""
        per_launch = Counter(op[3] for op in self.ops)
        return [n for corr, n in per_launch.items()
                if self.launches.get(corr) == "cudaGraphLaunch"]

    def complete(self) -> bool:
        counts = self.replays()
        return len(counts) == self.steps and len(set(counts)) == 1

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy = 0
        for ops in self.sessions:
            end = None
            for _, start, stop, _ in ops:
                if end is None or start > end:
                    busy += stop - start
                    end = stop
                elif stop > end:
                    busy += stop - end
                    end = stop
        return busy * 1e-9

    def seconds(self, program: bool) -> float:
        """Device seconds of the port's kernels (``program``) or of the
        rest."""
        return 1e-9 * sum(stop - start for name, start, stop, _ in self.ops
                          if is_program_kernel(name, self.kernels) == program)

    def per_step_ms(self, seconds: float) -> float:
        return seconds / self.steps * 1e3

    def top_ops(self, count=10):
        """[[name, seconds]] of the operations that took most time."""
        total = defaultdict(int)
        for name, start, stop, _ in self.ops:
            total[name[:160]] += stop - start
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:count]
        return [[name, ns * 1e-9] for name, ns in ranked]

    def top_gaps(self, count=10):
        """[[what came next, seconds]] of the idle time between device
        operations: between two host calls (the host syncing, reading back
        and launching the next), or inside a replay before the named
        operation."""
        total = defaultdict(int)
        for ops in self.sessions:
            end, last_corr = None, None
            for name, start, stop, corr in ops:
                if end is not None and start > end:
                    if corr != last_corr:
                        label = "host, then " + self.launches.get(
                            corr, "an unrecorded call")
                    else:
                        label = "inside a replay, before " + name[:120]
                    total[label] += start - end
                if end is None or stop > end:
                    end = stop
                last_corr = corr
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:count]
        return [[label, ns * 1e-9] for label, ns in ranked]

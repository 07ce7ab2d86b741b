"""The numbers that decide ``correct``, and their limits.

Each number compares what the program produced on the timed path with
what the reference computes from the same inputs; ``limits/<cell>.json``
gives its limit, set from sound runs over many seeds and from the control
(``PERF.md`` gives the readings). A run is correct when every number of
its cell is at or under its limit.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import torch

LIMITS = Path(__file__).resolve().parent / "limits"


def fid_mismatch(fid, ref_fid):
    """Share of pixels whose face id differs from the reference's."""
    return float(torch.mean((fid.long() != ref_fid.long()).double()))


def agreeing_gap(values, ref_values, fid, ref_fid):
    """Largest absolute difference of [H, W, C] ``values`` from the
    reference's over the pixels where both show the same face (or both
    the background)."""
    same = fid.long() == ref_fid.long()
    if not bool(same.any()):
        return float("inf")
    diff = torch.abs(values.double() - ref_values.double())
    return float(diff[same].max())


def norm_gap(values: dict, ref_values: dict, names):
    """Worst leaf: | |x| - |x_ref| | over the larger of |x_ref| and the
    median leaf's |x_ref| (``names`` selects the leaves)."""
    if not names:
        return 0.0
    ref_norms = {n: float(torch.linalg.vector_norm(ref_values[n].double()))
                 for n in ref_values}
    median = statistics.median(ref_norms.values())
    gaps = []
    for name in names:
        norm = float(torch.linalg.vector_norm(values[name].double()))
        base = max(ref_norms[name], median)
        gaps.append(abs(norm - ref_norms[name]) / base if base > 0
                    else float(norm != 0.0))
    return max(gaps)


def moving_leaves(ref_grads: dict):
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {n: float(torch.linalg.vector_norm(g.double()))
             for n, g in ref_grads.items()}
    median = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= 1e-3 * median]


def limits(cell_name: str):
    """{number: limit} of a cell, or {} before any were set."""
    path = LIMITS / f"{cell_name}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def judge(numbers: dict, cell_limits: dict):
    """(correct, {name: {"value", "limit"}}): correct when every number
    has a limit and is at or under it."""
    table = {name: {"value": value, "limit": cell_limits.get(name)}
             for name, value in numbers.items()}
    correct = all(entry["limit"] is not None
                  and entry["value"] <= entry["limit"]
                  for entry in table.values())
    return correct, table

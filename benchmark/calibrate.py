"""Readings from which a cell's limits are set, on the card at full size.

    python3 benchmark/calibrate.py --workload <cell> --mode <mode> --seeds 1,2,3 [--seconds 1]

``--mode sound`` runs the cell as ``run.py`` does (a short window) on each
seed and prints the numbers compared; ``control`` puts the reference,
computed in TF32, in the program's place; a fault's name (``faults.py``)
plants it underneath the timed path first; ``detail`` (fits) prints the
program's and the reference's losses and leaf norms side by side, with the
reference in float32 as a second witness. All seeds run in this one
process, so set-up's kernel builds and imports are paid once. One JSON line
per seed: {"seed", "mode", "numbers"}. The benchmark's own runs never run
this.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import faults, harness  # noqa: E402


def _leaves(values):
    return {name: [float(torch.linalg.vector_norm(v.double())),
                   [float(x) for x in v.flatten()[:3]]]
            for name, v in values.items()}


def detail(cell, seed, seconds, device):
    """A fit's readings side by side, per compared window: the program,
    the reference in float64 and in float32 (a second witness), per step
    and per leaf."""
    loop = cell.loop.build(cell, seed, device, False)
    harness._window(loop, seconds, device)
    got = loop.close()
    del loop
    gc.collect()
    ref64 = cell.loop.reference_readings(cell, got, device)
    ref32 = cell.loop.reference_readings(cell, got, device, "float32")
    for window, mine in zip(ref32, got["windows"]):
        window["first"] = mine["first"]
    runs = (("program", got["windows"]), ("float64", ref64),
            ("float32", ref32))
    out = {label: [{"losses": w["losses"], "grads": _leaves(w["grads"]),
                    "change": _leaves(w["change"])} for w in windows]
           for label, windows in runs}
    out["program_vs_float64"] = cell.loop.compare(got["windows"], ref64)
    out["float32_vs_float64"] = cell.loop.compare(ref32, ref64)
    out["program_vs_float32"] = cell.loop.compare(got["windows"], ref32)
    return out


def readings(cell, seed, mode, seconds, device):
    if mode == "detail":
        return detail(cell, seed, seconds, device)
    if mode == "control":
        loop = cell.loop.build(cell, seed, device, False)
        harness._window(loop, seconds, device)
        collected = loop.close()
        del loop
        gc.collect()
        return cell.loop.control(cell, collected, device)
    undo = None
    if mode != "sound":
        undo = faults.FAULTS[mode](cell)
    try:
        result = harness.run_cell(cell, seed, seconds, False, device,
                                  time.perf_counter(), cell_limits={})
    finally:
        if undo:
            undo()
    return {name: entry["value"] for name, entry in result["checks"].items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("calibrate.py runs on a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = readings(cell, seed, args.mode, args.seconds, "cuda:0")
        print(json.dumps(harness.plain({"seed": seed, "mode": args.mode,
                                        "numbers": numbers})), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Which sum makes two eager gradient steps of a demo differ on the card.

    python3 tools/prof_torch_repeat.py [--demo 5] [--size 1024]

Runs one eager fwd+bwd of a demo's loss (``graphstep.value_and_grad`` of
``problem()``'s ``loss_fn`` at its initial parameters; demo 5 by default:
10,224 faces, 1024 x 1024, 9-channel G-buffer, packed engine) twice on the
same inputs under a ``TorchDispatchMode`` that sees every operator, the
backward's too. The first run keeps a copy of every operator's outputs; the
second compares its outputs with them, operator by operator, bit for bit.
An operator whose outputs differ while none of its tensor inputs did is a
source: the same inputs gave other bits (an operator that hands back
uninitialised memory, ``empty`` and its kin, is none: a hand-written kernel
fills such buffers, out of this mode's sight, so the first operator that
reads a kernel's output may show as a source where the kernel's inputs
differed; and a difference in a slot that is cut off afterwards, such as
the binning's dump slot, shows too). For each source the line names the
operator, the autograd node that ran it (in the backward), the port's
frames that called it (in the backward: the forward's, from anomaly mode's
record of the node) and how many of its values differ and by how much.
Prints the card's name and power limit beside the counts; exits non-zero
without a CUDA device.
"""

import argparse
import importlib.util
import sys
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
DEMOS = {3: "torch_demo3_textured", 4: "torch_demo4_lit",
         5: "torch_demo5_deferred"}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64,
         torch.float16: torch.int16, torch.bfloat16: torch.int16}


# Operators whose outputs hold whatever the memory held before.
_UNSET = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}


def _same(got, want):
    """Equal shapes and bits (NaNs with equal bits are equal)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    bits = _BITS.get(got.dtype)
    if bits is None:
        return torch.equal(got, want)
    return torch.equal(got.view(bits), want.view(bits))


def _frames(stack):
    return [f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in stack
            if "dirt_tpu_torch" in f.filename or "demos" in f.filename][-3:]


class _Compare(TorchDispatchMode):
    """Records every operator's outputs (``reference`` None), or compares
    them with a recorded run's and keeps the sources of a difference."""

    def __init__(self, reference=None):
        super().__init__()
        self.reference = reference
        self.outputs = []
        self.index = 0
        # The storages of outputs that differed: an input on one of them
        # (a view too) differs already. A storage freed and reused may hide
        # a later source; the first is always found.
        self.differing = set()
        self.sources = []
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self.ops += 1
        if self.reference is None:
            self.outputs.append([t.detach().clone() for t in outs])
            return out
        want = self.reference[self.index]
        self.index += 1
        differ = [(g, w) for g, w in zip(outs, want) if not _same(g, w)]
        if not differ or func.__name__.split(".")[0] in _UNSET:
            return out
        tainted = any(t.untyped_storage().data_ptr() in self.differing
                      for t in _tensors((args, kwargs)))
        self.differing.update(t.untyped_storage().data_ptr() for t, _ in
                              differ)
        if not tainted:
            node = torch._C._current_autograd_node()
            forward = (node.metadata.get("traceback_", [])
                       if node is not None else [])
            if not isinstance(forward, str):
                forward = "".join(forward)
            where = _frames(traceback.extract_stack())
            if forward:
                where = [line.strip() for line in forward.splitlines()
                         if "dirt_tpu_torch" in line or "demos" in line][-3:]
            got, ref = differ[0]
            diff = (got.double() - ref.double()).abs()
            bits = _BITS.get(got.dtype)
            changed = (got.view(bits) != ref.view(bits) if bits is not None
                       else got != ref)
            self.sources.append(dict(
                op=func.__name__, node=node.name() if node else None,
                where=where, values=int(changed.sum()),
                of=got.numel(), max_abs=float(diff.max()),
                max_ref=float(ref.double().abs().max())))
        return out


def _demo(n):
    spec = importlib.util.spec_from_file_location(
        DEMOS[n], ROOT / "demos" / f"{DEMOS[n]}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(device, n=5, size=None):
    """The sources of two eager first steps' difference (a list of dicts:
    op, node, where, values that differ, of how many, max |diff|, max |x|),
    and the number of operators a step."""
    from dirt_tpu_torch.utils.graphstep import value_and_grad

    demo = _demo(n)
    size = size or demo.SIZE
    problem = demo.problem(size, device=device)
    loss_fn, params = problem[:2]
    step = value_and_grad(loss_fn)
    args = tuple(params.values())
    step(*args)                              # builds kernels, fills caches
    torch.cuda.synchronize(device)
    with torch.autograd.detect_anomaly(check_nan=False):
        with _Compare() as first:
            step(*args)
        torch.cuda.synchronize(device)
        with _Compare(first.outputs) as second:
            step(*args)
        torch.cuda.synchronize(device)
    if second.ops != first.ops:
        raise RuntimeError(f"the two steps ran {first.ops} and {second.ops} "
                           "operators")
    return second.sources, first.ops


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--demo", type=int, default=5, choices=DEMOS)
    parser.add_argument("--size", type=int, default=None)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("prof_torch_repeat: no CUDA device "
                 "(torch.cuda.is_available() is False)")
    sys.path.insert(0, str(ROOT))
    import bench_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    card = bench_torch.card_line()
    sources, ops = run(torch.device("cuda", 0), opts.demo, opts.size)
    print(f"[repeat demo {opts.demo}] {ops} operators a step; "
          f"{len(sources)} source(s) of a difference between two eager "
          f"steps on the same inputs ({card})")
    for s in sources:
        print(f"[repeat demo {opts.demo}]   {s['op']} (node {s['node']}) "
              f"at {' <- '.join(reversed(s['where']))}: {s['values']} of "
              f"{s['of']} values differ, max |diff| {s['max_abs']:.3g} of "
              f"max |x| {s['max_ref']:.3g}")


if __name__ == "__main__":
    main()

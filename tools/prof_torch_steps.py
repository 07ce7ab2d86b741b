#!/usr/bin/env python3
"""Where a dirt_tpu_torch gradient step spends the card's time.

    python3 tools/prof_torch_steps.py

Takes a ``torch.profiler`` window of a few fwd+bwd steps of three paths of
the port on one CUDA card and prints, for each: device kernels per step,
device busy time per step, the span of the window per step, the busy share
(busy / span), the hand-written kernels' device time, and the five largest
items by device time. The paths are the flagship step
(``dirt_tpu_torch.entry.entry()``: 2,208 faces, 256 x 256, dense engine,
9-channel G-buffer), config 5 of ``bench_configs.py`` (10,224 faces,
1024 x 1024, packed engine, 9-channel G-buffer, texture + Phong) and
config 4's lit sphere (2,208 faces, 512 x 512, dense engine, 3 channels).
The profiler's own host cost stretches the span, so the busy shares are
lower bounds of the unprofiled ones. Prints the card's name and power
limit beside the numbers; exits non-zero without a CUDA device.
"""

import sys
from pathlib import Path

import numpy as np
import torch

STEPS = 5
OURS = ("raster_fwd_packed_kernel", "packed_prologue_kernel",
        "packed_bwd_kernel", "raster_fwd_dense_kernel",
        "fused_bwd_partial_kernel", "fused_bwd_reduce_kernel")


def _profile(label, step, card):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy = sum(e.device_time for e in kernels) / 1e3          # ms
    begin = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    span = (end - begin) / 1e3
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.device_time / 1e3, count + 1)
    ours = {o: v for n, v in by_name.items() for o in OURS if o in n}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    print(f"[{label}] device kernels per step {len(kernels) / STEPS:.1f}, "
          f"device busy per step {busy / STEPS:.4f} ms, device span per step "
          f"{span / STEPS:.4f} ms, busy share {busy / span:.3f} "
          f"(window of {STEPS} steps, {card})")
    for name, (total, count) in sorted(ours.items()):
        print(f"[{label}]   kernel {name}: {total / STEPS:.4f} ms per step "
              f"({count // STEPS} launches)")
    for name, (total, count) in top:
        print(f"[{label}]   top: {total / STEPS:.4f} ms per step x"
              f"{count / STEPS:.0f} {name[:70]}")


def main():
    if not torch.cuda.is_available():
        sys.exit("prof_torch_steps: torch.cuda.is_available() is False")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    # The scenes and losses are chip_smoke.py's own, so both scripts time
    # the same steps.
    import chip_smoke
    from dirt_tpu_torch import entry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card)

    def grad_step(loss_fn, leaves):
        def step():
            fresh = [t.detach().clone().requires_grad_() for t in leaves]
            loss_fn(*fresh).backward()
        return step

    _profile("flagship 256^2 dense", grad_step(*entry.entry()), card)

    render, leaves = chip_smoke.config5_render(device)
    w5 = torch.as_tensor(
        np.random.RandomState(1).rand(chip_smoke.SIZE, chip_smoke.SIZE, 3)
        .astype(np.float32), device=device)
    _profile("config5 1024^2 packed", grad_step(
        lambda v, p: (render(v, p) * w5).sum(), leaves), card)

    _profile("config4 512^2 dense",
             grad_step(*chip_smoke.config4_loss(device)), card)


if __name__ == "__main__":
    main()

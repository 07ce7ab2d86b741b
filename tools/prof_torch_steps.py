#!/usr/bin/env python3
"""Where a dirt_tpu_torch gradient step spends the card's time.

    python3 tools/prof_torch_steps.py

Takes a ``torch.profiler`` window of a few fwd+bwd steps of eight paths of
the port on one CUDA card and prints, for each: device kernels per step,
device busy time per step, the span of the window per step, the busy share
(busy / span), the hand-written kernels' device time, the five largest
items by device time and the five largest host operations by their own
host time (without their children's). The paths are the flagship step
(``dirt_tpu_torch.entry.entry()``: 2,208 faces, 256 x 256, dense engine,
9-channel G-buffer), config 5 of ``bench_configs.py`` (10,224 faces,
1024 x 1024, packed engine, 9-channel G-buffer, texture + Phong), config
4's lit sphere (2,208 faces, 512 x 512, dense engine, 3 channels), the
default API on the 99,904-face sphere (1024 x 1024, 3 channels, which runs
the streaming csr engine), the row-sharded renderer on the bench sphere
(10,224 faces, 1024 x 1024, dense engine, four slabs on the one card), the
same sphere through the overlapped backward (packed engine, four slabs)
with one chunk and with four, and through the face-sharded renderer (four
members, dense engine).
The profiler's own host cost stretches the span, so the busy shares are
lower bounds of the unprofiled ones. Prints the card's name and power
limit beside the numbers; exits non-zero without a CUDA device.
"""

import sys
from pathlib import Path

import numpy as np
import torch

STEPS = 5
# Profiler windows to try before giving up, each with twice the calls of
# the last. The tracer now and then hands back no device record for a
# short window of few kernels: on an H100, three windows in a row of 2, 4
# and 8 calls of the prologue kernel alone on the 1,001,112-face scene.
WINDOWS = 6
OURS = ("raster_fwd_packed_kernel", "packed_prologue_kernel",
        "packed_bwd_kernel", "raster_fwd_dense_kernel",
        "fused_bwd_partial_kernel", "fused_bwd_reduce_kernel",
        "raster_fwd_csr_kernel", "fused_bwd_csr_partial_kernel",
        "fused_bwd_csr_reduce_kernel", "scatter_faces_partial_kernel",
        "scatter_faces_reduce_kernel", "scatter_faces_csr_partial_kernel",
        "scatter_faces_csr_reduce_kernel", "subtile_swap_kernel",
        "max_scan_kernel", "setup_vjp_staged", "setup_vjp_general")


def _profile(label, step, card, steps=STEPS, echo=True):
    """A ``torch.profiler`` window of ``steps`` calls of ``step`` (after
    three warm-up calls, synchronised inside the window; a window without
    device records is taken again with twice the calls, up to ``WINDOWS``
    windows). Prints its lines
    when ``echo`` and returns the record: device kernels per step, device
    busy and span per step (ms), busy share, the hand-written kernels'
    {name: (ms per step, launches per step)}, the five largest device items
    and the five largest host operations as (name, ms per step, count per
    step)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
        steps *= 2
    else:
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
    host = sorted(prof.key_averages(),
                  key=lambda op: -op.self_cpu_time_total)[:5]
    record = dict(
        label=label, kernels=len(kernels) / steps, busy_ms=busy / steps,
        span_ms=span / steps, busy_share=busy / span,
        ours={name: (total / steps, count / steps)
              for name, (total, count) in sorted(ours.items())},
        top=[(name, total / steps, count / steps)
             for name, (total, count) in top],
        host=[(op.key, op.self_cpu_time_total / 1e3 / steps,
               op.count / steps) for op in host])
    if echo:
        print(f"[{label}] device kernels per step {record['kernels']:.1f}, "
              f"device busy per step {record['busy_ms']:.4f} ms, device span "
              f"per step {record['span_ms']:.4f} ms, busy share "
              f"{record['busy_share']:.3f} (window of {steps} steps, {card})")
        for name, (ms, count) in record["ours"].items():
            print(f"[{label}]   kernel {name}: {ms:.4f} ms per step "
                  f"({count:.0f} launches)")
        for name, ms, count in record["top"]:
            print(f"[{label}]   top: {ms:.4f} ms per step x{count:.0f} "
                  f"{name[:70]}")
        for key, ms, count in record["host"]:
            print(f"[{label}]   host: {ms:.4f} ms per step x{count:.0f} "
                  f"{key[:70]}")
    return record


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

    big_loss, big_leaves, _ = chip_smoke.big_sphere_step(device)
    _profile("default API 99,904 faces 1024^2 csr",
             grad_step(big_loss, big_leaves), card)

    _profile("sharded 4 slabs 1024^2 dense",
             grad_step(*chip_smoke.sharded_dense_step(device)), card)

    for chunks in (1, 4):
        _profile(f"overlap 4 slabs x {chunks} chunks 1024^2 packed",
                 grad_step(*chip_smoke.overlap_loss(device, 4, chunks)), card)

    _profile("face-sharded 4 members 1024^2 dense",
             grad_step(*chip_smoke.face_sharded_loss(device)), card)


if __name__ == "__main__":
    main()

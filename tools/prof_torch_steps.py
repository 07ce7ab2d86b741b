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

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import card_common  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("prof_torch_steps: torch.cuda.is_available() is False")
    import bench_configs_torch
    from dirt_tpu_torch import entry
    from dirt_tpu_torch.ops import _build
    from dirt_tpu_torch.utils.benchtime import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    _build.build(_build.KERNELS)
    card = card_line()
    print(card)

    def grad_step(loss_fn, leaves):
        def step():
            fresh = [t.detach().clone().requires_grad_() for t in leaves]
            loss_fn(*fresh).backward()
        return step

    profile = card_common.profile
    profile("flagship 256^2 dense", grad_step(*entry.entry()), card)

    config5 = bench_configs_torch.config5(device)
    w5 = card_common.rand(1, card_common.SIZE, card_common.SIZE, 3,
                          device=device)
    profile("config5 1024^2 packed", grad_step(
        lambda v, p: (config5.forward(v, p) * w5).sum(), config5.leaves),
        card)

    config4 = bench_configs_torch.config4(device)
    profile("config4 512^2 dense", grad_step(config4.loss, config4.leaves),
            card)

    big_loss, big_leaves, _ = card_common.big_sphere_step(device)
    profile("default API 99,904 faces 1024^2 csr",
            grad_step(big_loss, big_leaves), card)

    profile("sharded 4 slabs 1024^2 dense",
            grad_step(*card_common.sharded_dense_step(device)), card)

    for chunks in (1, 4):
        profile(f"overlap 4 slabs x {chunks} chunks 1024^2 packed",
                grad_step(*card_common.overlap_loss(device, 4, chunks)), card)

    profile("face-sharded 4 members 1024^2 dense",
            grad_step(*card_common.face_sharded_loss(device)), card)


if __name__ == "__main__":
    main()

"""Host seconds of set-up's phases, each ended on a synchronised device."""

from __future__ import annotations

import time

import torch


class Phases:
    def __init__(self, device):
        self.on_card = torch.device(device).type == "cuda"
        self.last = time.perf_counter()
        self.seconds = {}

    def mark(self, name: str):
        """End the phase ``name`` here."""
        if self.on_card:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now

"""Lightweight scalar metrics logging: stdout lines and optional CSV.

A copy of ``dirt_tpu/utils/metrics.py`` (importing that module runs
``dirt_tpu/__init__.py``, which imports jax). Values may be Python numbers,
numpy scalars or one-element tensors on any device (``float(value)``; a
tensor on the card is read back, which synchronises).
"""

from __future__ import annotations

import sys
import time


class MetricsLogger:
    """Append-only scalar logger: stdout lines + optional CSV file."""

    def __init__(self, csv_path: str | None = None, print_every: int = 1):
        self._csv_path = csv_path
        self._print_every = print_every
        self._fields: list[str] | None = None
        self._file = None
        self._t0 = time.time()
        self._count = 0

    def log(self, step: int, **scalars) -> None:
        scalars = {k: float(v) for k, v in scalars.items()}
        if self._csv_path is not None and self._file is None:
            self._fields = list(scalars)
            self._file = open(self._csv_path, "w")
            self._file.write(",".join(["step", "wall_s"] + self._fields) + "\n")
        if self._fields is not None and set(scalars) - set(self._fields):
            raise ValueError(
                f"new metric keys {sorted(set(scalars) - set(self._fields))} "
                "after the CSV header was written; log them from the first "
                "call or use a separate logger"
            )
        if self._file is not None:
            row = [str(step), f"{time.time() - self._t0:.3f}"]
            row += [repr(scalars.get(k, float("nan"))) for k in self._fields]
            self._file.write(",".join(row) + "\n")
            self._file.flush()
        if self._count % self._print_every == 0:
            parts = " ".join(f"{k}={v:.6g}" for k, v in scalars.items())
            print(f"[metrics] step={step} {parts}", file=sys.stderr)
        self._count += 1

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

"""Build and load the package's CUDA kernels (nvcc + ctypes).

Each ``dirt_tpu_torch/csrc/<name>.cu`` exposes a plain C entry point and is
compiled on first use, on the machine with the card, into
``build/dirt_tpu_torch/lib<name>_<hash>.so`` under the checkout root. The
hash covers the source and the compiler flags, so an edited source
rebuilds and an unchanged one loads the library already built. A missing
``nvcc`` or a failed build raises with the compiler's output; nothing is
downloaded.

Flags: ``sm_90a`` (Hopper), ``-O3``, ``-fmad=false`` (no multiply-add
contraction, so a kernel's rounding matches its plain PyTorch version) and
IEEE division (no ``--use_fast_math``). ``-Xptxas -v`` output (registers,
shared memory, spills) is kept beside the library in ``<lib>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dirt_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in filter(None, (os.environ.get("CUDA_HOME"), "/usr/local/cuda")):
        candidate = Path(root) / "bin" / "nvcc"
        if candidate.is_file():
            return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of dirt_tpu_torch are built on the machine with the card"
    )


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    out = library_path(name)
    if not out.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        Path(f"{out}.log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) for a built kernel."""
    log = Path(f"{library_path(name)}.log")
    return log.read_text() if log.exists() else ""

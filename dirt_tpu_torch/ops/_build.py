"""Build and load the package's CUDA kernels (nvcc + ctypes).

Each ``dirt_tpu_torch/csrc/<name>.cu`` exposes a plain C entry point and is
compiled on first use, on the machine with the card, into
``build/dirt_tpu_torch/lib<name>_<hash>.so`` under the checkout root. The
hash covers the source, every header it includes from ``csrc/`` (such as
``cotangent_core.cuh``, shared by the two backward kernels) and the
compiler flags, so an edited source or header rebuilds what uses it and an
unchanged one loads the library already built;
:func:`build` compiles several sources at once, one nvcc each. A missing
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
import re
import shutil
import subprocess
import time
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


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list:
    """``csrc/<name>.cu`` and every file of ``csrc/`` it includes with
    ``#include "..."``, directly or through another header."""
    files, queue = [], [CSRC_DIR / f"{name}.cu"]
    while queue:
        path = queue.pop()
        if path in files:
            continue
        files.append(path)
        for header in _INCLUDE.findall(path.read_bytes()):
            candidate = CSRC_DIR / header.decode()
            if candidate.is_file():
                queue.append(candidate)
    return files


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    src = b"".join(path.read_bytes() for path in source_files(name))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names) -> dict:
    """Build every library of ``names`` not built yet, one nvcc each, all
    started together; raises with the compiler's output if one fails.

    Returns, for each library built here, the seconds from the start of
    the builds to its nvcc's exit.
    """
    start = time.perf_counter()
    jobs = {}
    for name in dict.fromkeys(names):
        out = library_path(name)
        if out.exists():
            continue
        if not jobs:
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        # The compiler writes to a file, not a pipe, so a long error
        # report cannot block it while the others are polled.
        log = Path(f"{tmp}.log")
        with log.open("w") as sink:
            proc = subprocess.Popen(cmd, stdout=sink,
                                    stderr=subprocess.STDOUT)
        jobs[name] = (out, tmp, log, cmd, proc)
    seconds, failed = {}, []
    while jobs:
        for name, (out, tmp, log, cmd, proc) in list(jobs.items()):
            if proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - start
            del jobs[name]
            text = log.read_text()
            log.unlink()
            if proc.returncode != 0:
                failed.append(f"nvcc failed building {name} (exit "
                              f"{proc.returncode}):\n{' '.join(cmd)}\n{text}")
                continue
            Path(f"{out}.log").write_text(text)
            os.replace(tmp, out)
        time.sleep(0.01)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) for a built kernel."""
    log = Path(f"{library_path(name)}.log")
    return log.read_text() if log.exists() else ""

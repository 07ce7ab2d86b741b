"""Wavefront OBJ mesh loading: native C++ parser with a Python fallback.

A copy of ``dirt_tpu/io/objloader.py`` (importing that module runs
``dirt_tpu/__init__.py``, which imports jax), with two changes: the native
library is built from the repository's ``csrc/objloader.cpp`` with g++
into ``build/dirt_tpu_torch/libobjloader_<hash>.so`` (the hash covers the
source and the flags), not next to the source; and
:meth:`ObjMesh.to_tensors` puts a loaded mesh on a device. ``load_obj``
uses the C++ parser and falls back to the pure-Python parser, with
identical semantics, when no compiler is available; ``native=True`` raises
instead.

Both parsers split vertices per distinct (position, uv, normal) corner
triplet — the form rasterization wants (per-corner attributes exact),
matching ``lighting.split_vertices_by_face`` semantics for meshes whose
faces index positions/uvs/normals independently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "objloader.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dirt_tpu_torch"
_GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_LIB_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False


class ObjMesh:
    """Loaded triangle mesh (numpy arrays)."""

    def __init__(self, vertices, uvs, normals, faces, has_uv, has_normal):
        self.vertices = vertices    # [V, 3] f32
        self.uvs = uvs              # [V, 2] f32 (zeros when has_uv False)
        self.normals = normals      # [V, 3] f32
        self.faces = faces          # [F, 3] i32
        self.has_uv = bool(has_uv)
        self.has_normal = bool(has_normal)

    def to_tensors(self, device="cuda"):
        """(vertices [V, 3] f32, uvs [V, 2] f32, normals [V, 3] f32,
        faces [F, 3] int64) as tensors on ``device``: the card unless the
        caller asks for another device."""
        def put(array, dtype):
            return torch.as_tensor(array, dtype=dtype, device=device)

        return (put(self.vertices, torch.float32),
                put(self.uvs, torch.float32),
                put(self.normals, torch.float32),
                put(self.faces, torch.int64))

    def __repr__(self):
        return (f"ObjMesh(V={len(self.vertices)}, F={len(self.faces)}, "
                f"uv={self.has_uv}, normal={self.has_normal})")


def library_path() -> Path:
    """Where the native parser's library is built."""
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(_GXX_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libobjloader_{digest[:16]}.so"


def _build_library():
    lib_path = library_path()
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        subprocess.run(
            ["g++", *_GXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
            check=True, capture_output=True,
        )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.obj_load.restype = ctypes.c_void_p
    lib.obj_load.argtypes = [ctypes.c_char_p]
    lib.obj_counts.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_int32)] * 4
    lib.obj_copy.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.obj_free.argtypes = [ctypes.c_void_p]
    lib.obj_error.restype = ctypes.c_char_p
    return lib


def _native_lib():
    """The native parser's library, or None when it cannot be built or
    loaded here (the reason is kept for ``native=True``)."""
    global _LIB, _LIB_FAILED
    with _LIB_LOCK:
        if _LIB is None and not _LIB_FAILED:
            try:
                _LIB = _build_library()
            except subprocess.CalledProcessError as err:
                _LIB_FAILED = err.stderr.decode(errors="replace")
            except OSError as err:          # no g++, or the load failed
                _LIB_FAILED = str(err)
        return _LIB


def load_obj(path: str, native: bool | None = None) -> ObjMesh:
    """Load a Wavefront OBJ triangle mesh.

    Args:
        path: .obj file path.
        native: force the C++ (True) or Python (False) parser; None uses
            native when a compiler/library is available.
    """
    lib = _native_lib() if native in (None, True) else None
    if native is True and lib is None:
        raise RuntimeError("native objloader unavailable (g++ build "
                           f"failed): {_LIB_FAILED}")
    if lib is not None:
        return _load_native(lib, path)
    return _load_python(path)


def _load_native(lib, path: str) -> ObjMesh:
    handle = lib.obj_load(path.encode())
    if not handle:
        raise ValueError(lib.obj_error().decode() or f"failed to load {path}")
    try:
        nv = ctypes.c_int32()
        nf = ctypes.c_int32()
        hu = ctypes.c_int32()
        hn = ctypes.c_int32()
        lib.obj_counts(handle, ctypes.byref(nv), ctypes.byref(nf),
                       ctypes.byref(hu), ctypes.byref(hn))
        verts = np.empty((nv.value, 3), np.float32)
        uvs = np.empty((nv.value, 2), np.float32)
        normals = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        lib.obj_copy(
            handle,
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            uvs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            normals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return ObjMesh(verts, uvs, normals, faces, hu.value, hn.value)
    finally:
        lib.obj_free(handle)


def _load_python(path: str) -> ObjMesh:
    """Reference parser, semantics-identical to the C++ one."""
    vs, ts, ns = [], [], []
    out_v, out_t, out_n, faces = [], [], [], []
    dedup = {}
    has_uv = has_normal = False

    def corner(spec):
        nonlocal has_uv, has_normal
        parts = spec.split("/")
        v = int(parts[0])
        t = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        n = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        fix = lambda i, c: (i - 1) if i > 0 else (c + i if i < 0 else -1)
        key = (fix(v, len(vs)), fix(t, len(ts)), fix(n, len(ns)))
        if key[0] < 0 or key[0] >= len(vs):
            raise ValueError(f"bad vertex index in {spec!r}")
        if key not in dedup:
            dedup[key] = len(out_v)
            out_v.append(vs[key[0]])
            out_t.append(ts[key[1]] if key[1] >= 0 else (0.0, 0.0))
            out_n.append(ns[key[2]] if key[2] >= 0 else (0.0, 0.0, 0.0))
            if key[1] >= 0:
                has_uv = True
            if key[2] >= 0:
                has_normal = True
        return dedup[key]

    with open(path) as f:
        for line in f:
            # Strip trailing comments BEFORE tokenizing (the C++ parser
            # breaks at '#'); 'f 1 2 3 # 4' must not grow a 4th corner.
            parts = line.split("#", 1)[0].split()
            if not parts:
                continue
            if parts[0] == "v":
                vs.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "vt":
                ts.append(tuple(float(x) for x in parts[1:3]))
            elif parts[0] == "vn":
                ns.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "f":
                ids = [corner(s) for s in parts[1:]]
                if len(ids) < 3:
                    raise ValueError("face with <3 corners")
                for k in range(1, len(ids) - 1):
                    faces.append((ids[0], ids[k], ids[k + 1]))

    return ObjMesh(
        np.asarray(out_v, np.float32).reshape(-1, 3),
        np.asarray(out_t, np.float32).reshape(-1, 2),
        np.asarray(out_n, np.float32).reshape(-1, 3),
        np.asarray(faces, np.int32).reshape(-1, 3),
        has_uv, has_normal,
    )

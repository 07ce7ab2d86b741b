"""Minimal image IO (binary PPM/PGM) for the port's demos and tools.

A copy of ``dirt_tpu/utils/image.py`` (which imports no jax, but importing
it runs ``dirt_tpu/__init__.py``, which does) that also takes tensors:
:func:`to_uint8` and :func:`save_ppm` accept a torch tensor on any device
as well as an array. :func:`load_ppm` returns a numpy float32 array.
"""

from __future__ import annotations

import numpy as np
import torch


def _numpy(image):
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def to_uint8(image):
    """Clamp a float image [..., C] in [0, 1] to uint8."""
    return (np.clip(_numpy(image), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_ppm(path: str, image) -> None:
    """Save [H, W, 3] (P6) or [H, W]/[H, W, 1] (P5) image, values in [0,1]."""
    img = _numpy(image)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    data = to_uint8(img)
    if data.ndim == 2:
        header = f"P5\n{data.shape[1]} {data.shape[0]}\n255\n"
    elif data.ndim == 3 and data.shape[-1] == 3:
        header = f"P6\n{data.shape[1]} {data.shape[0]}\n255\n"
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(data.tobytes())


def load_ppm(path: str):
    """Load a binary P5/P6 file written by save_ppm; returns float [0,1]."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        dims = f.readline().split()
        maxval = int(f.readline())
        w, h = int(dims[0]), int(dims[1])
        data = np.frombuffer(f.read(), np.uint8)
    if magic == b"P5":
        img = data.reshape(h, w)
    elif magic == b"P6":
        img = data.reshape(h, w, 3)
    else:
        raise ValueError(f"unsupported magic {magic!r}")
    return img.astype(np.float32) / maxval

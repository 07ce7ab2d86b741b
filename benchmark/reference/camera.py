"""Camera and matrix products of the reference (row vectors: ``v @ M``).

``prec`` is ``"float64"``, ``"float32"`` or ``"tf32"``; under ``"tf32"``
every product rounds its two inputs to TF32 (10 mantissa bits) and sums in
float32, as a TF32 matrix unit does.
"""

from __future__ import annotations

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "tf32": torch.float32}


def round_tf32(x):
    """``x`` (float32) rounded to the nearest TF32 value (ties away from
    zero): the low 13 of the 23 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` with TF32 inputs, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = round_tf32(grad)
        return grad @ b.transpose(-1, -2), a.transpose(-1, -2) @ grad


def mm(a, b, prec: str):
    """``a @ b`` in the precision ``prec``."""
    if prec == "tf32":
        return _TF32Product.apply(a.float(), b.float())
    return a @ b


def homogeneous(v):
    """[..., V, 3] -> [..., V, 4] with w = 1."""
    return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def rodrigues(axis_angle, epsilon: float = 1e-12):
    """[3] axis-angle -> [4, 4] rotation for row vectors (the transpose of
    the column-vector matrix ``c I + (1 - c) k k^T + s [k]_x``)."""
    theta = torch.sqrt(torch.sum(axis_angle * axis_angle) + epsilon)
    k = axis_angle / theta
    c, s = torch.cos(theta), torch.sin(theta)
    cross = torch.stack([
        torch.stack([0.0 * k[0], -k[2], k[1]]),
        torch.stack([k[2], 0.0 * k[0], -k[0]]),
        torch.stack([-k[1], k[0], 0.0 * k[0]]),
    ])
    eye = torch.eye(3, dtype=k.dtype, device=k.device)
    column = c * eye + (1.0 - c) * torch.outer(k, k) + s * cross
    out = torch.eye(4, dtype=k.dtype, device=k.device)
    return torch.cat([torch.cat([column.T, out[:3, 3:]], 1), out[3:]], 0)


def translation(offset, dtype, device):
    m = torch.eye(4, dtype=dtype, device=device)
    m[3, :3] = torch.as_tensor(offset, dtype=dtype, device=device)
    return m


def perspective(camera: dict, dtype, device):
    """OpenGL's symmetric frustum, transposed for row vectors: x in
    [-right, right], y in [-right * aspect, ...] at the near plane, depths
    -near .. -far to NDC z -1 .. 1."""
    near, far = camera["near"], camera["far"]
    right = camera["right"]
    top = right * camera["aspect"]
    m = torch.zeros((4, 4), dtype=dtype, device=device)
    m[0, 0] = near / right
    m[1, 1] = near / top
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -1.0
    m[3, 2] = -2.0 * far * near / (far - near)
    return m


def model_matrix(pose, camera: dict, prec: str):
    """Rotation by ``pose`` then the camera's ``offset``."""
    return mm(rodrigues(pose), translation(camera["offset"], pose.dtype,
                                           pose.device), prec)

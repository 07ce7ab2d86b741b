"""Transformation and projection matrices (PyTorch).

Counterpart of ``dirt_tpu/core/matrices.py``, function for function:
``translation``, ``scale``, ``rodrigues``, ``rotation_x/y/z``,
``perspective_projection``, ``orthographic_projection``,
``pad_3x3_to_4x4``, ``compose`` and ``transform_homogeneous``.

Conventions (unchanged from the JAX package):

* **Row-vector convention.** Points are rows, transforms post-multiply:
  ``v_out = v_in @ M``. Matrices here are therefore the transpose of the
  column-vector OpenGL forms.
* Clip space is OpenGL-style: after ``v_clip = v_obj @ M @ V @ P`` a point
  is visible iff ``-w <= x, y, z <= w``; NDC z in [-1, 1].
* All functions broadcast over leading batch dimensions.
* Every input becomes float32 (the JAX package's default precision), on
  the device it already lies on; plain numbers and arrays land on the CPU.
  Matrix products run in full float32: keep
  ``torch.backends.cuda.matmul.allow_tf32`` False on the card.
"""

from __future__ import annotations

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _eye_like(batch_shape, ref):
    eye = torch.eye(4, dtype=ref.dtype, device=ref.device)
    return eye.expand(tuple(batch_shape) + (4, 4)).clone()


def translation(t):
    """4x4 translation matrix for row vectors.

    Args:
        t: [..., 3] translation.
    Returns:
        [..., 4, 4] matrix with the translation in the bottom row.
    """
    t = _f32(t)
    m = _eye_like(t.shape[:-1], t)
    m[..., 3, :3] = t
    return m


def scale(s):
    """4x4 (possibly non-uniform) scale matrix.

    Args:
        s: scalar, [..., 1] or [..., 3] scale factors.
    """
    s = _f32(s)
    if s.ndim == 0:
        s = s[None]
    if s.shape[-1] == 1:
        s = torch.cat([s, s, s], dim=-1)
    m = _eye_like(s.shape[:-1], s)
    m[..., 0, 0] = s[..., 0]
    m[..., 1, 1] = s[..., 1]
    m[..., 2, 2] = s[..., 2]
    return m


def rodrigues(axis_angle, epsilon: float = 1e-12):
    """Axis-angle rotation to a 4x4 matrix (row-vector convention).

    The rotation angle is the norm of ``axis_angle``; the axis its direction.
    Differentiable at zero (guarded normalisation).

    Args:
        axis_angle: [..., 3].
    Returns:
        [..., 4, 4].
    """
    aa = _f32(axis_angle)
    theta = torch.sqrt(torch.sum(aa * aa, dim=-1) + epsilon)
    axis = aa / theta[..., None]
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = torch.cos(theta)
    s = torch.sin(theta)
    one_c = 1.0 - c

    # Column-vector rotation matrix R (v' = R v), then transpose for rows.
    r00 = c + x * x * one_c
    r01 = x * y * one_c - z * s
    r02 = x * z * one_c + y * s
    r10 = y * x * one_c + z * s
    r11 = c + y * y * one_c
    r12 = y * z * one_c - x * s
    r20 = z * x * one_c - y * s
    r21 = z * y * one_c + x * s
    r22 = c + z * z * one_c
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    # Row-vector matrix = R^T.
    return torch.stack(
        [
            torch.stack([r00, r10, r20, zero], dim=-1),
            torch.stack([r01, r11, r21, zero], dim=-1),
            torch.stack([r02, r12, r22, zero], dim=-1),
            torch.stack([zero, zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def _axis_rotation(theta, i, j):
    theta = _f32(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    m = _eye_like(theta.shape, theta)
    # Row-vector convention (transpose of the column form).
    m[..., i, i] = c
    m[..., i, j] = s
    m[..., j, i] = -s
    m[..., j, j] = c
    return m


def rotation_x(theta):
    """Rotation about +x by ``theta`` (radians), row-vector convention."""
    return _axis_rotation(theta, 1, 2)


def rotation_y(theta):
    """Rotation about +y by ``theta`` (radians), row-vector convention."""
    return _axis_rotation(theta, 2, 0)


def rotation_z(theta):
    """Rotation about +z by ``theta`` (radians), row-vector convention."""
    return _axis_rotation(theta, 0, 1)


def _stack_rows(elements):
    return torch.stack(
        [torch.stack(row, dim=-1) for row in elements], dim=-2
    )


def perspective_projection(near, far, right, aspect):
    """OpenGL-style symmetric perspective frustum (row-vector convention).

    The frustum spans x in [-right, right] and y in [-top, top] at the near
    plane, with ``top = right * aspect`` (aspect = height / width). The
    camera looks down -z; depths in [-near, -far] map to NDC z in [-1, 1].

    Returns:
        [4, 4] matrix P such that ``v_clip = v_eye @ P``.
    """
    near, far, right, aspect = (_f32(v) for v in (near, far, right, aspect))
    top = right * aspect
    zero = torch.zeros_like(near)
    # Column-vector GL matrix, written transposed.
    return _stack_rows([
        [near / right, zero, zero, zero],
        [zero, near / top, zero, zero],
        [zero, zero, -(far + near) / (far - near), -torch.ones_like(near)],
        [zero, zero, -2.0 * far * near / (far - near), zero],
    ])


def orthographic_projection(near, far, right, aspect):
    """Symmetric orthographic projection (row-vector convention)."""
    near, far, right, aspect = (_f32(v) for v in (near, far, right, aspect))
    top = right * aspect
    zero = torch.zeros_like(near)
    one = torch.ones_like(near)
    return _stack_rows([
        [1.0 / right, zero, zero, zero],
        [zero, 1.0 / top, zero, zero],
        [zero, zero, -2.0 / (far - near), zero],
        [zero, zero, -(far + near) / (far - near), one],
    ])


def pad_3x3_to_4x4(m):
    """Embed a [..., 3, 3] linear transform into [..., 4, 4] homogeneous."""
    m = _f32(m)
    out = _eye_like(m.shape[:-2], m)
    out[..., :3, :3] = m
    return out


def compose(*matrices):
    """Compose transforms applied left-to-right on row vectors.

    ``compose(A, B, C)`` returns ``A @ B @ C`` so that
    ``v @ compose(A, B, C) == ((v @ A) @ B) @ C``.
    """
    result = _f32(matrices[0])
    for m in matrices[1:]:
        result = torch.matmul(result, _f32(m))
    return result


def transform_homogeneous(vertices, matrix):
    """Append w=1 to [..., V, 3] vertices and post-multiply by ``matrix``."""
    vertices = _f32(vertices)
    ones = torch.ones(
        vertices.shape[:-1] + (1,), dtype=vertices.dtype,
        device=vertices.device,
    )
    homog = torch.cat([vertices, ones], dim=-1)
    return torch.matmul(homog, _f32(matrix))

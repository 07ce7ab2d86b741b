"""Shared inputs for the tests/test_torch_*.py parity tests.

Every scene is made with numpy from a seed and handed to both packages as
numpy arrays: ``dirt_tpu`` (JAX on the CPU, Pallas in interpret mode, as
the root conftest arranges) and ``dirt_tpu_torch`` (CPU tensors, so every
kernel wrapper takes its plain PyTorch version).
"""

import numpy as np

from dirt_tpu_torch.core import matrices, mesh

SIZE = 128


def sphere_scene(n_lat=12, n_lon=16, distance=3.0, seed=0, channels=3):
    """The bench camera (``bench.py``) on a small UV sphere.

    Returns numpy (clip-space vertices [V, 4] f32, colors [V, C] f32,
    faces [F, 3] int32). ``distance`` < ~1.1 puts part of the sphere
    behind the near plane, so clipping has work to do.
    """
    verts, faces, _ = mesh.uv_sphere(n_lat, n_lon)
    mv = matrices.compose(
        matrices.rodrigues([0.4, 0.3, 0.0]),
        matrices.translation([0.0, 0.0, -distance]),
    )
    proj = matrices.perspective_projection(0.1, 20.0, 0.045, 1.0)
    clip = matrices.transform_homogeneous(verts, matrices.compose(mv, proj))
    colors = np.random.RandomState(seed).rand(len(verts), channels)
    return clip.numpy(), colors.astype(np.float32), faces


def screen_soup(num_faces, height, width, seed, channels=3, spread=25.0):
    """Random screen-space faces [F, 3, 4] (x_s, y_s, z_ndc, invw = 1) and
    attributes [F, 3, C], as numpy f32."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform([5, 5], [width - 5, height - 5], (num_faces, 1, 2))
    xy = centers + rng.uniform(-spread, spread, (num_faces, 3, 2))
    z = rng.uniform(-0.9, 0.9, (num_faces, 1, 1)) + np.zeros((1, 3, 1))
    fv = np.concatenate([xy, z, np.ones((num_faces, 3, 1))], axis=-1)
    attrs = rng.rand(num_faces, 3, channels)
    return fv.astype(np.float32), attrs.astype(np.float32)

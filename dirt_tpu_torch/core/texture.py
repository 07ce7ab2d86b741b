"""Differentiable texture sampling (PyTorch).

Counterpart of ``dirt_tpu/core/texture.py``'s ``sample_texture``: bilinear
or nearest lookup at continuous UVs, with ``clamp`` / ``repeat`` wrapping
per axis. Gradients flow to the texture and (bilinear) to the UVs.

The four bilinear corners are row gathers (``index_select`` on the
texture flattened to [Ht * Wt, C]) with their own wrapped indices, so
autograd's backward is an ``index_add_`` that carries the texture gradient
(indexing with two index tensors would go through a sorting
``index_put_`` instead). The JAX package's packed-corner row table and its
sort / cumsum / searchsorted gradient exist because that backend's
scatter-add is slow; they have no counterpart here, and neither has the
``custom_vjp`` keyword.
"""

from __future__ import annotations

import torch


def sample_texture(texture, uv, mode: str = "bilinear", wrap="clamp",
                   channels_first: bool = False):
    """Sample a texture at continuous UV coordinates.

    Args:
        texture: [Ht, Wt, C] float.
        uv: [..., 2] float, u right / v up in [0, 1]; (0, 0) is the
            bottom-left texel corner (OpenGL convention).
        mode: "bilinear" or "nearest".
        wrap: "clamp" or "repeat", or a ``(wrap_u, wrap_v)`` pair for
            per-axis modes (GL_CLAMP_TO_EDGE / GL_REPEAT per axis).
        channels_first: return [C, ...] instead of [..., C].
    Returns:
        [..., C] sampled colors ([C, ...] if ``channels_first``).
    """
    texture = torch.as_tensor(texture, dtype=torch.float32)
    uv = torch.as_tensor(uv, dtype=torch.float32, device=texture.device)
    wrap = _wrap_axes(wrap)
    if mode == "nearest":
        out = _nearest(texture, uv, wrap)
    elif mode == "bilinear":
        out = _bilinear(texture, uv, wrap)
    else:
        raise ValueError(f"unknown sampling mode: {mode!r}")
    if channels_first:
        return out.movedim(-1, 0)
    return out


def _continuous_coords(texture, uv):
    """(u, v) continuous texel coordinates."""
    ht, wt, _ = texture.shape
    u = uv[..., 0] * wt - 0.5
    # v=0 is the bottom row; texture row 0 is the top.
    v = (1.0 - uv[..., 1]) * ht - 0.5
    return u, v


def _wrap_axes(wrap):
    """Normalize ``wrap`` to (wrap_u, wrap_v); accepts one mode or a pair."""
    if isinstance(wrap, (tuple, list)):
        wu, wv = wrap
    else:
        wu = wv = wrap
    for w in (wu, wv):
        if w not in ("clamp", "repeat"):
            raise ValueError(f"unknown wrap mode: {w!r}")
    return wu, wv


def _wrap_index(idx, size: int, wrap: str):
    if wrap == "clamp":
        return torch.clamp(idx, 0, size - 1)
    return torch.remainder(idx, size)


def _clip_split(x, lo: float, hi: float):
    """clip(x, lo, hi) whose gradient at a bound is one half, as
    ``jnp.clip``'s (min of max)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _texels(texture, iv, iu):
    """texture[iv, iu] -> [..., C] as one flat row gather."""
    ht, wt, channels = texture.shape
    rows = texture.reshape(ht * wt, channels).index_select(
        0, (iv * wt + iu).reshape(-1))
    return rows.reshape(*iv.shape, channels)


def _nearest(texture, uv, wrap):
    ht, wt, _ = texture.shape
    wu, wv = wrap
    u, v = _continuous_coords(texture, uv)
    # torch.round rounds half to even, like jnp.round.
    iu = _wrap_index(torch.round(u).to(torch.int64), wt, wu)
    iv = _wrap_index(torch.round(v).to(torch.int64), ht, wv)
    return _texels(texture, iv, iu)


def _bilinear(texture, uv, wrap):
    ht, wt, _ = texture.shape
    wu, wv = wrap
    u, v = _continuous_coords(texture, uv)
    # Clamp the continuous coordinate (per clamped axis): edge samples then
    # get fu/fv = 0 against the (self-neighboring) last texel, matching the
    # corner-wise clamp semantics exactly.
    if wu == "clamp":
        u = _clip_split(u, 0.0, wt - 1.0)
    if wv == "clamp":
        v = _clip_split(v, 0.0, ht - 1.0)
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    fu = (u - u0f)[..., None]
    fv = (v - v0f)[..., None]
    u0 = _wrap_index(u0f.to(torch.int64), wt, wu)
    v0 = _wrap_index(v0f.to(torch.int64), ht, wv)
    # The right / lower neighbor of the wrapped base texel, wrapped again
    # (clamp: the last texel neighbors itself).
    u1 = _wrap_index(u0 + 1, wt, wu)
    v1 = _wrap_index(v0 + 1, ht, wv)
    t00 = _texels(texture, v0, u0)
    t01 = _texels(texture, v0, u1)
    t10 = _texels(texture, v1, u0)
    t11 = _texels(texture, v1, u1)
    top = t00 * (1.0 - fu) + t01 * fu
    bottom = t10 * (1.0 - fu) + t11 * fu
    return top * (1.0 - fv) + bottom * fv

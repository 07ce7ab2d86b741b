"""Differentiable texture sampling (PyTorch).

Counterpart of ``dirt_tpu/core/texture.py``'s ``sample_texture``: bilinear
or nearest lookup at continuous UVs, with ``clamp`` / ``repeat`` wrapping
per axis. Gradients flow to the texture and (bilinear) to the UVs.

The four bilinear corners are row gathers (``index_select`` on the
texture flattened to [Ht * Wt, C]) with their own wrapped indices, made
one after another by one autograd function (:class:`_Rows`) whose
backward carries the texture gradient: every corner's rows
``index_add_``-ed into one zeroed [Ht * Wt, C] buffer (indexing with two
index tensors would go through a sorting ``index_put_`` instead). The UV
gradient (the ``fu`` and ``fv`` terms) stays in autograd. The JAX
package's packed-corner row table and its sort / cumsum / searchsorted
gradient exist because that backend's scatter-add is slow; they have no
counterpart here, and neither has the ``custom_vjp`` keyword.

On the card, ``sample_texture`` runs inside a ``texture`` span
(``utils/trace.py``) where no other span is open, and the texture
gradient's scatter inside a ``texture_grad`` span: two markers each. A
texture that needs no gradient has no backward, so no scatter and no
``texture_grad`` markers.
"""

from __future__ import annotations

import torch

from dirt_tpu_torch.utils import trace


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
    if mode not in ("nearest", "bilinear"):
        raise ValueError(f"unknown sampling mode: {mode!r}")
    with trace.outer_span("texture", texture):
        if mode == "nearest":
            out = _nearest(texture, uv, wrap)
        else:
            out = _bilinear(texture, uv, wrap)
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


class _Rows(torch.autograd.Function):
    """Rows of a flat texture [N, C] at several corners, each a pair of
    integer index tensors ``(iv, iu)`` on a texture ``width`` texels wide:
    one ``index_select`` of ``iv * width + iu`` each, one corner's flat
    index alive at a time unless the backward needs them (``grad``: grad
    mode was on where the lookup was called). The backward adds each
    corner's gradient rows into one zeroed [N, C] buffer with
    ``index_add_``, inside the ``texture_grad`` span. The indices are
    integers, so autograd runs it only where the texture needs a
    gradient."""

    @staticmethod
    def forward(ctx, flat, width, grad, *coords):
        rows, kept = [], []
        for iv, iu in zip(coords[::2], coords[1::2]):
            index = (iv * width + iu).reshape(-1)
            rows.append(flat.index_select(0, index))
            if grad and ctx.needs_input_grad[0]:
                kept.append(index)
            # Let this corner's index go before the next one is formed.
            del index
        ctx.save_for_backward(*kept)
        ctx.rows = flat.shape[0]
        return tuple(rows)

    @staticmethod
    def backward(ctx, *grads):
        indices = ctx.saved_tensors
        with trace.outer_span("texture_grad", grads[0]):
            out = grads[0].new_zeros((ctx.rows, grads[0].shape[1]))
            for index, grad in zip(indices, grads):
                out.index_add_(0, index, grad)
        return (out, None, None, *(None,) * (2 * len(indices)))


def _texels(texture, *corners):
    """texture[iv, iu] -> [..., C] for each ``(iv, iu)`` of ``corners``,
    as row gathers of the flattened texture (:class:`_Rows`)."""
    ht, wt, channels = texture.shape
    rows = _Rows.apply(texture.reshape(ht * wt, channels), wt,
                       torch.is_grad_enabled(),
                       *(t for corner in corners for t in corner))
    return [row.reshape(*iv.shape, channels)
            for row, (iv, _) in zip(rows, corners)]


def _nearest(texture, uv, wrap):
    ht, wt, _ = texture.shape
    wu, wv = wrap
    u, v = _continuous_coords(texture, uv)
    # torch.round rounds half to even, like jnp.round.
    iu = _wrap_index(torch.round(u).to(torch.int64), wt, wu)
    iv = _wrap_index(torch.round(v).to(torch.int64), ht, wv)
    return _texels(texture, (iv, iu))[0]


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
    t00, t01, t10, t11 = _texels(texture, (v0, u0), (v0, u1), (v1, u0),
                                 (v1, u1))
    top = t00 * (1.0 - fu) + t01 * fu
    bottom = t10 * (1.0 - fu) + t11 * fu
    return top * (1.0 - fv) + bottom * fv

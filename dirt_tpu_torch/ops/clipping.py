"""Homogeneous near-plane clipping (GL parity, differentiable, static shapes).

Counterpart of ``dirt_tpu/ops/clipping.py`` (forward): see its docstring
for the geometry. A triangle is clipped against the near-plane half-space
``z + w > W_CLIP_EPS``; with k vertices inside the result is the original
triangle (k = 3), two triangles (k = 2), one smaller triangle (k = 1) or
nothing (k = 0). Slot ``i`` of the clipped array holds face ``i``'s primary
triangle, slot ``F + i`` its secondary one (live only for k = 2);
degenerate slots are zero-area triangles at w = 1 that setup culls.
New vertices interpolate positions and attributes in clip space with one
parameter ``t`` per crossing edge, so gradients flow through the seam.

Every branch is computed for every face with guarded denominators and
then selected, so discarded branches stay finite.

Gradients come from autograd's own backward of these plain torch ops; the
compaction's gathers (``[idx]``) reduce through the ``index`` backward's
scatter-add. The JAX package wraps its compaction in a rank-gather custom
VJP (``dirt_tpu/ops/clipping.py:187-223``) only because scatter-add is slow
on a TPU; it has no counterpart here.
"""

from __future__ import annotations

import torch

from dirt_tpu_torch.ops.triangle_setup import W_EPS

# Vertices with z + w above this are "inside" the near half-space.
W_CLIP_EPS = 1e-4


def _lerp_to_plane_cf(va, vb, aa, ab, w_eps):
    """Clip-space intersection of segment a->b with the z + w = eps plane.

    Channels-first: positions [4, F], attributes [C, F].
    """
    sa = va[2] + va[3]
    sb = vb[2] + vb[3]
    den = sb - sa
    safe = torch.where(torch.abs(den) > 1e-20, den, 1.0)
    t = torch.clamp((w_eps - sa) / safe, 0.0, 1.0)[None]    # [1, F]
    return va + t * (vb - va), aa + t * (ab - aa)


def _clip_faces_cf(v, a, w_eps):
    """Core clip pass on channels-first slabs.

    Args:
        v: [3, 4, F] positions (corner-major).
        a: [3, C, F] attributes.
    Returns:
        (tri1_v [3, 4, F], tri1_a, tri2_v, tri2_a, n_in [F] int64).
    """
    s = v[:, 2] + v[:, 3]                                  # [3, F]
    inside = s > w_eps
    n_in = torch.sum(inside.to(torch.int64), dim=0)        # [F]

    # Canonical rotation r: bring the distinguished vertex to corner 0 —
    # the single inside vertex (k=1) or the single outside vertex (k=2).
    i0, i1 = inside[0], inside[1]
    r1 = torch.where(i0, 0, torch.where(i1, 1, 2))
    r2 = torch.where(~i0, 0, torch.where(~i1, 1, 2))
    r = torch.where(n_in == 1, r1, torch.where(n_in == 2, r2, 0))

    def rot(arr, j):
        # arr [3, K, F] -> rotated corner j = arr[(j + r) % 3]
        return torch.where(
            r == 0, arr[j],
            torch.where(r == 1, arr[(j + 1) % 3], arr[(j + 2) % 3]),
        )

    va, vb, vc = rot(v, 0), rot(v, 1), rot(v, 2)           # [4, F]
    aa, ab, ac = rot(a, 0), rot(a, 1), rot(a, 2)           # [C, F]

    # Seam points on the two edges leaving corner 0.
    p_ab, q_ab = _lerp_to_plane_cf(va, vb, aa, ab, w_eps)
    p_ca, q_ca = _lerp_to_plane_cf(vc, va, ac, aa, w_eps)

    # k = 1 (A inside): (A, AB*, CA*), same winding.
    tri1_k1_v = torch.stack([va, p_ab, p_ca])              # [3, 4, F]
    tri1_k1_a = torch.stack([aa, q_ab, q_ca])
    # k = 2 (A outside): quad (AB*, B, C, CA*) -> (AB*, B, C) + (AB*, C, CA*).
    tri1_k2_v = torch.stack([p_ab, vb, vc])
    tri1_k2_a = torch.stack([q_ab, ab, ac])
    tri2_k2_v = torch.stack([p_ab, vc, p_ca])
    tri2_k2_a = torch.stack([q_ab, ac, q_ca])

    # Degenerate filler: a single point at w=1 (zero area -> culled free).
    degen_v = torch.zeros_like(v)
    degen_v[:, 3].fill_(1.0)        # fill_: no number copied from the host
    degen_a = torch.zeros_like(a)

    sel = n_in[None, None]
    tri1_v = torch.where(
        sel == 3, v,
        torch.where(sel == 2, tri1_k2_v,
                    torch.where(sel == 1, tri1_k1_v, degen_v)),
    )
    tri1_a = torch.where(
        sel == 3, a,
        torch.where(sel == 2, tri1_k2_a,
                    torch.where(sel == 1, tri1_k1_a, degen_a)),
    )
    tri2_v = torch.where(sel == 2, tri2_k2_v, degen_v)
    tri2_a = torch.where(sel == 2, tri2_k2_a, degen_a)
    return tri1_v, tri1_a, tri2_v, tri2_a, n_in


def _channels_first(face_verts_clip, face_attrs):
    v = torch.as_tensor(face_verts_clip, dtype=torch.float32).permute(1, 2, 0)
    a = torch.as_tensor(face_attrs, dtype=torch.float32).permute(1, 2, 0)
    return v, a


def _rows_first(x):
    """[3, K, F] -> [F, 3, K]."""
    return x.permute(2, 0, 1)


def clip_faces(face_verts_clip, face_attrs, w_eps: float = W_CLIP_EPS):
    """Clip faces against the near plane.

    Args:
        face_verts_clip: [F, 3, 4] f32 homogeneous clip-space positions.
        face_attrs: [F, 3, C] f32 per-corner attributes.
    Returns:
        (verts [2F, 3, 4], attrs [2F, 3, C]) — differentiable; degenerate
        slots are zero-area triangles at w = 1.
    """
    v, a = _channels_first(face_verts_clip, face_attrs)
    tri1_v, tri1_a, tri2_v, tri2_a, _ = _clip_faces_cf(v, a, w_eps)
    return (
        _rows_first(torch.cat([tri1_v, tri2_v], dim=2)),
        _rows_first(torch.cat([tri1_a, tri2_a], dim=2)),
    )


def inside_counts(face_verts_clip, w_eps: float = W_CLIP_EPS):
    """Per-face count of vertices inside the near half-space ([F] int64)."""
    v = torch.as_tensor(face_verts_clip)
    inside = (v[..., 2] + v[..., 3]) > w_eps
    return torch.sum(inside.to(torch.int64), dim=1)


def _secondary_order(n_in, cap: int):
    """Slots of the ``cap`` compacted secondaries, and the overflow flag.

    Faces with a live secondary (k = 2) come first in ascending face order
    (so the rasterizer's z-tie rule is unchanged), then non-live faces
    (whose secondary rows are the degenerate filler) in ascending order.
    """
    num_faces = n_in.shape[0]
    sec_live = n_in == 2
    fidx = torch.arange(num_faces, dtype=torch.int64, device=n_in.device)
    key = torch.where(sec_live, num_faces - fidx, 0)
    idx = torch.sort(key, descending=True, stable=True).indices[:cap]
    overflow = torch.sum(sec_live.to(torch.int64)) > cap
    return idx, overflow


def compact_clipped(verts2, attrs2, n_in, cap: int):
    """Compact the [2F] clipped face array down to [F + cap] slots.

    Primary slots stay in place (slot i is face i, valid or degenerate);
    the live secondaries compact into ``cap`` trailing slots in ascending
    face order.

    Returns:
        (verts [F + cap, 3, 4], attrs [F + cap, 3, C],
         orig_id [F + cap] int64 — original face of each slot,
         overflow [] bool — True if > cap secondaries were live; the
         dropped ones are the highest-id crossing faces).
    """
    num_faces = n_in.shape[0]
    idx, overflow = _secondary_order(n_in, cap)
    verts = torch.cat([verts2[:num_faces], verts2[num_faces:][idx]])
    attrs = torch.cat([attrs2[:num_faces], attrs2[num_faces:][idx]])
    fidx = torch.arange(num_faces, dtype=torch.int64, device=n_in.device)
    return verts, attrs, torch.cat([fidx, idx]), overflow


def _screen_cf(v, height, width, w_eps_screen):
    """Clip -> screen transform on a channels-first corner slab [4, F]
    (same semantics as ``triangle_setup.screen_from_clip``)."""
    w = v[3]
    ok = torch.abs(w) > w_eps_screen
    safe_w = torch.where(ok, w, 1.0)
    invw = torch.where(ok, 1.0 / safe_w, 0.0)
    x_s = (v[0] * invw + 1.0) * (0.5 * width)
    y_s = (1.0 - v[1] * invw) * (0.5 * height)
    return torch.stack([x_s, y_s, v[2] * invw, invw])


def clip_compact_screen(face_verts_clip, face_attrs, cap: int,
                        height: int, width: int,
                        w_eps: float = W_CLIP_EPS):
    """Near-plane clip + compaction + clip -> screen transform.

    The ``clip=True`` path of the public API. Returns SCREEN-space faces
    (verts [F + cap, 3, 4] of (x_s, y_s, z_ndc, invw), attrs [F + cap, 3,
    C], orig_id [F + cap] int64, overflow [] bool) ready for
    ``rasterize_screen``.
    """
    v, a = _channels_first(face_verts_clip, face_attrs)
    num_faces = v.shape[2]
    tri1_v, tri1_a, tri2_v, tri2_a, n_in = _clip_faces_cf(v, a, w_eps)

    tri1_s = torch.stack([_screen_cf(tri1_v[i], height, width, W_EPS)
                          for i in range(3)])
    tri2_s = torch.stack([_screen_cf(tri2_v[i], height, width, W_EPS)
                          for i in range(3)])

    idx, overflow = _secondary_order(n_in, cap)
    verts = torch.cat([_rows_first(tri1_s), _rows_first(tri2_s)[idx]])
    attrs = torch.cat([_rows_first(tri1_a), _rows_first(tri2_a)[idx]])
    fidx = torch.arange(num_faces, dtype=torch.int64, device=v.device)
    return verts, attrs, torch.cat([fidx, idx]), overflow


def needs_clipping(face_verts_clip, w_eps: float = W_CLIP_EPS):
    """[] bool tensor — True if any face actually crosses the near plane."""
    v = torch.as_tensor(face_verts_clip)
    s_in = (v[..., 2] + v[..., 3]) > w_eps
    any_in = torch.any(s_in, dim=1)
    all_in = torch.all(s_in, dim=1)
    return torch.any(any_in & ~all_in)

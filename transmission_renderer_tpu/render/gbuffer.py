"""G-buffer attribute interpolation from the visibility buffer.

The reference's vertex-shader outputs (world position, rotated normal, uv,
flat material id, flat model scale — shader/src/lib.rs:336-391) are
recovered per pixel here by gathering the winning triangle's vertices and
blending with the stored perspective-correct barycentrics. Screen-space UV
and position derivatives — the ddx/ddy the fragment shaders rely on
(shader/src/lighting.rs:243-259) — are computed *analytically* from the
homogeneous edge equations, which is exact (quad-difference hardware
derivatives are an approximation of these).

Per-pixel fetches are fused into two wide gathers — one [VV, 8] vertex-attribute table (pos+nrm+uv) at the
3 corner indices, and one [T, 11] per-triangle table (adjugate rows +
material id + scale) — instead of ~10 narrow ones.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from transmission_renderer_tpu.ops.raster import TriangleSetup, VisibilityBuffer


class GBuffer(NamedTuple):
    valid: jnp.ndarray  # [H, W] bool
    depth: jnp.ndarray  # [H, W] f32 (reversed-Z)
    position: jnp.ndarray  # [H, W, 3] world space
    normal: jnp.ndarray  # [H, W, 3] (unnormalised interpolated)
    uv: jnp.ndarray  # [H, W, 2]
    duv_dx: jnp.ndarray  # [H, W, 2] per-pixel uv derivative
    duv_dy: jnp.ndarray  # [H, W, 2]
    dpos_dx: jnp.ndarray  # [H, W, 3] world-position derivative
    dpos_dy: jnp.ndarray  # [H, W, 3]
    material_id: jnp.ndarray  # [H, W] int32
    model_scale: jnp.ndarray  # [H, W] f32 (instance uniform scale)
    tri_id: jnp.ndarray  # [H, W] int32


def interpolate_gbuffer(
    vis: VisibilityBuffer,
    setup: TriangleSetup,
    tri_vertices: jnp.ndarray,  # [T, 3] int32 into the expanded vertex pool
    tri_material: jnp.ndarray,  # [T] int32
    tri_scale: jnp.ndarray,  # [T] f32 (instance scale)
    world_positions: jnp.ndarray,  # [VV, 3]
    world_normals: jnp.ndarray,  # [VV, 3]
    uvs: jnp.ndarray,  # [VV, 2]
    width: int,
    height: int,
    row_offset: jnp.ndarray | int = 0,
) -> GBuffer:
    """``row_offset`` shifts local pixel rows to global framebuffer rows —
    used by the row-band-sharded path (parallel/sharded.py) where each
    device holds a horizontal slice of the frame."""
    valid = vis.tri_id >= 0
    tri = jnp.maximum(vis.tri_id, 0)

    # ---- fused per-triangle gather: adj (9) + material (1) + scale (1) ----
    t = setup.adj.shape[0]
    tri_table = jnp.concatenate(
        [
            setup.adj.reshape(t, 9),
            tri_material.astype(jnp.float32)[:, None],
            tri_scale[:, None],
        ],
        axis=1,
    )
    tri_vals = tri_table[tri]  # [H, W, 11]
    adj = tri_vals[..., :9].reshape(tri.shape + (3, 3))
    material_id = tri_vals[..., 9].astype(jnp.int32)
    model_scale = tri_vals[..., 10]

    # ---- fused per-vertex gather: pos (3) + nrm (3) + uv (2) ---------------
    attr8 = jnp.concatenate([world_positions, world_normals, uvs], axis=1)
    vidx = tri_vertices[tri]  # [H, W, 3]
    vals = attr8[vidx]  # [H, W, 3(corner), 8]

    b1 = vis.bary[..., 0]
    b2 = vis.bary[..., 1]
    b0 = 1.0 - b1 - b2
    b = jnp.stack([b0, b1, b2], axis=-1)  # [H, W, 3]

    blended = jnp.sum(vals * b[..., None], axis=-2)  # [H, W, 8]
    position = blended[..., 0:3]
    normal = blended[..., 3:6]
    uv = blended[..., 6:8]

    # ---- analytic derivatives ----------------------------------------------
    # e_i(nx, ny) = a_i nx + b_i ny + c_i; a rational attribute
    # A(q) = N(q)/D(q) with N = sum(e_i A_i), D = sum(e_i) has
    # dA/dnx = (sum(a_i A_i) D - N sum(a_i)) / D^2, and d(nx)/d(px) = 2/W.
    h_px, w_px = vis.tri_id.shape
    px = jnp.arange(w_px, dtype=jnp.float32)[None, :] + 0.5
    py = jnp.arange(h_px, dtype=jnp.float32)[:, None] + 0.5 + row_offset
    nx = jnp.broadcast_to(px * (2.0 / width) - 1.0, (h_px, w_px))
    ny = jnp.broadcast_to(py * (2.0 / height) - 1.0, (h_px, w_px))
    e = (
        adj[..., 0] * nx[..., None] + adj[..., 1] * ny[..., None] + adj[..., 2]
    )  # [H, W, 3]
    d_sum = jnp.sum(e, axis=-1)
    a_sum = jnp.sum(adj[..., 0], axis=-1)
    b_sum = jnp.sum(adj[..., 1], axis=-1)

    n8 = jnp.sum(e[..., None] * vals, axis=-2)  # [H, W, 8]
    na8 = jnp.sum(adj[..., 0][..., None] * vals, axis=-2)
    nb8 = jnp.sum(adj[..., 1][..., None] * vals, axis=-2)
    inv_d2 = (1.0 / (d_sum * d_sum))[..., None]
    ddnx8 = (na8 * d_sum[..., None] - n8 * a_sum[..., None]) * inv_d2 * (2.0 / width)
    ddny8 = (nb8 * d_sum[..., None] - n8 * b_sum[..., None]) * inv_d2 * (2.0 / height)

    dpos_dx = ddnx8[..., 0:3]
    dpos_dy = ddny8[..., 0:3]
    duv_dx = ddnx8[..., 6:8]
    duv_dy = ddny8[..., 6:8]

    zero2 = jnp.zeros_like(uv)
    zero3 = jnp.zeros_like(position)
    vmask2 = valid[..., None]
    return GBuffer(
        valid=valid,
        depth=vis.depth,
        position=jnp.where(vmask2, position, zero3),
        normal=jnp.where(vmask2, normal, zero3 + jnp.array([0.0, 0.0, 1.0])),
        uv=jnp.where(vmask2, uv, zero2),
        duv_dx=jnp.where(vmask2, duv_dx, zero2),
        duv_dy=jnp.where(vmask2, duv_dy, zero2),
        dpos_dx=jnp.where(vmask2, dpos_dx, zero3),
        dpos_dy=jnp.where(vmask2, dpos_dy, zero3),
        material_id=jnp.where(valid, material_id, 0),
        model_scale=jnp.where(valid, model_scale, 1.0),
        tri_id=vis.tri_id,
    )

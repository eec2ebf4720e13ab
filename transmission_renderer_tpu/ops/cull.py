"""GPU-driven frustum culling + draw demultiplexing, atomics-free.

Reproduces the reference's two compute stages:
  * ``frustum_culling`` (shader/src/lib.rs:412-469): per-instance
    sphere-vs-frustum in view space with the symmetric-plane (niagara)
    trick — here a single vectorised op over all instances.
  * ``demultiplex_draws`` (shader/src/lib.rs:473-517): instead of emitting
    indirect draw commands into 4 atomic-compacted buckets, this path
    produces a per-triangle enable mask per bucket; the rasteriser consumes
    masks directly (draws never touch the host, same as the reference's
    GPU-driven design).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from transmission_renderer_tpu.scene.types import Scene, similarity_apply


def frustum_planes_from_projection(perspective: np.ndarray):
    """Symmetric frustum plane coefficients from the projection matrix
    (src/main.rs:1729-1733, after zeux/niagara): normalize(row3 + row0).xz
    and normalize(row3 + row1).yz.

    NOTE (deliberate deviation): plugged into glam's sign conventions, the
    reference's test ``cz * fx.z - |cx| * fx.x < radius`` is always true —
    its lateral culling is a no-op (the author's comment at
    src/main.rs:1730 hedges exactly this). Since culling is conservative
    (image-identical either way), we return magnitude coefficients and
    apply the mathematically correct sphere-vs-symmetric-plane test in
    ``cull_instances``: visible iff cz/L - |cx| * (f/L) > -radius.
    """
    r0 = perspective[0, :3]
    r1 = perspective[1, :3]
    r3 = perspective[3, :3]
    fx = r3 + r0
    fx = np.abs(fx) / np.linalg.norm(fx)
    fy = r3 + r1
    fy = np.abs(fy) / np.linalg.norm(fy)
    return np.array([fx[0], fx[2]], np.float32), np.array([fy[1], fy[2]], np.float32)


def cull_instances(
    scene: Scene,
    view_matrix: jnp.ndarray,  # [4, 4]
    frustum_x_xz: jnp.ndarray,  # [2]
    frustum_y_yz: jnp.ndarray,  # [2]
    z_near: float,
) -> jnp.ndarray:
    """[I] bool visibility — the vectorised ``cull`` test
    (shader/src/lib.rs:442-469), inverted to 'visible'."""
    spheres = scene.prim_bounding_sphere[scene.inst_primitive_id]  # [I, 4]
    center = similarity_apply(scene.inst_transform, spheres[:, :3])
    center_h = jnp.concatenate([center, jnp.ones_like(center[:, :1])], axis=-1)
    center_view = (center_h @ view_matrix.T)[:, :3]
    # +z = forward distance (shader/src/lib.rs:450-452)
    cz = -center_view[:, 2]
    cx = center_view[:, 0]
    cy = center_view[:, 1]

    radius = spheres[:, 3] * scene.inst_transform.scale

    visible = cz + radius > z_near
    # sphere-vs-symmetric-plane: signed distance to the nearer lateral
    # plane is (cz - f|c|)/L; keep while it exceeds -radius (see
    # frustum_planes_from_projection for why this corrects the reference).
    visible &= cz * frustum_x_xz[1] - jnp.abs(cx) * frustum_x_xz[0] > -radius
    visible &= cz * frustum_y_yz[1] - jnp.abs(cy) * frustum_y_yz[0] > -radius
    return visible


def bucket_triangle_masks(
    tri_instance: jnp.ndarray,  # [TT] int32 — instance of each drawn triangle
    tri_bucket: jnp.ndarray,  # [TT] int32 — draw bucket of each triangle
    instance_visible: jnp.ndarray,  # [I] bool
    buckets: tuple[int, ...],
) -> jnp.ndarray:
    """[TT] bool: triangle enabled iff its instance survived culling and its
    primitive's bucket is in ``buckets`` — the mask-based equivalent of
    draw demultiplexing (shader/src/lib.rs:473-517)."""
    vis = instance_visible[tri_instance]
    in_bucket = jnp.zeros_like(vis)
    for b in buckets:
        in_bucket |= tri_bucket == b
    return vis & in_bucket

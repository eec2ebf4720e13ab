"""Clustered forward lighting math.

Ports the Filament-style log-depth slicing (``LightClusterCoefficients``,
reference shared-structs/src/lib.rs:35-68), the view-space cluster AABB
construction (``write_cluster_data``, shader/src/lib.rs:519-594) and the
cluster/light intersection tests (shared-structs/src/lib.rs:285-320) as
dense JAX ops. The reference's atomic-append cluster lists
(shader/src/lib.rs:596-645) become a sort-based top-K selection with
identical semantics, including the 128-light clamp — no atomics needed
(SURVEY.md section 2.6).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class ClusterCoefficients(NamedTuple):
    """Mirror of shared-structs/src/lib.rs:35-41."""

    z_near: float
    z_far: float
    scale: float
    bias: float
    num_depth_slices: int


def cluster_coefficients(
    z_near: float, z_far: float, num_depth_slices: int
) -> ClusterCoefficients:
    """shared-structs/src/lib.rs:44-52."""
    log_ratio = np.log2(z_far / z_near)
    return ClusterCoefficients(
        z_near=z_near,
        z_far=z_far,
        scale=num_depth_slices / log_ratio,
        bias=-(num_depth_slices * np.log2(z_near) / log_ratio),
        num_depth_slices=num_depth_slices,
    )


def linear_depth(coeffs: ClusterCoefficients, frag_depth: jnp.ndarray) -> jnp.ndarray:
    """Reversed-Z fragment depth -> positive linear view distance
    (shared-structs/src/lib.rs:54-58)."""
    depth_range = 2.0 * (1.0 - frag_depth) - 1.0
    return (
        2.0
        * coeffs.z_near
        * coeffs.z_far
        / (coeffs.z_far + coeffs.z_near - depth_range * (coeffs.z_far - coeffs.z_near))
    )


def get_depth_slice(coeffs: ClusterCoefficients, frag_depth: jnp.ndarray) -> jnp.ndarray:
    """Fragment depth -> cluster z slice (shared-structs/src/lib.rs:61-63)."""
    slice_f = jnp.log2(linear_depth(coeffs, frag_depth)) * coeffs.scale + coeffs.bias
    return jnp.maximum(slice_f, 0.0).astype(jnp.uint32)


def slice_to_depth(coeffs: ClusterCoefficients, slice_idx: jnp.ndarray) -> jnp.ndarray:
    """Slice index -> (negative) view-space z plane
    (shared-structs/src/lib.rs:65-67)."""
    t = slice_idx.astype(jnp.float32) / coeffs.num_depth_slices
    return -coeffs.z_near * (coeffs.z_far / coeffs.z_near) ** t


def _line_intersection_to_z_plane(
    a: jnp.ndarray, b: jnp.ndarray, z_distance: jnp.ndarray
) -> jnp.ndarray:
    """Intersect the eye->point line with a z plane (shader/src/lib.rs:583-594)."""
    a_to_b = b - a
    t = (z_distance - a[..., 2]) / a_to_b[..., 2]
    return a + t[..., None] * a_to_b


def write_cluster_data(
    inverse_perspective: jnp.ndarray,  # [4, 4]
    screen_dimensions: tuple[int, int],  # (width, height)
    num_clusters_xy: tuple[int, int],
    coeffs: ClusterCoefficients,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Compute all view-space cluster AABBs at once
    (shader/src/lib.rs:519-580).

    Returns (min [N,3], max [N,3]) with N = cx*cy*slices, indexed
    ``slice * cy * cx + y * cx + x`` exactly like the shader
    (shader/src/lib.rs:527-529).
    """
    cx, cy = num_clusters_xy
    slices = coeffs.num_depth_slices
    width, height = screen_dimensions
    cluster_size = jnp.array(
        [width / cx, height / cy], dtype=jnp.float32
    )  # src/main.rs:540-542

    ix = jnp.arange(cx, dtype=jnp.float32)
    iy = jnp.arange(cy, dtype=jnp.float32)
    iz = jnp.arange(slices, dtype=jnp.float32)
    gz, gy, gx = jnp.meshgrid(iz, iy, ix, indexing="ij")  # [slices, cy, cx]

    xy = jnp.stack([gx, gy], axis=-1)  # [slices, cy, cx, 2]
    screen_min = xy * cluster_size
    screen_max = (xy + 1.0) * cluster_size

    dims = jnp.array([width, height], dtype=jnp.float32)

    def screen_to_view(pos):  # shader/src/lib.rs:540-550
        clip = pos / dims * 2.0 - 1.0
        clip4 = jnp.concatenate(
            [clip, jnp.zeros_like(clip[..., :1]), jnp.ones_like(clip[..., :1])],
            axis=-1,
        )
        view = clip4 @ inverse_perspective.T
        return view[..., :3] / view[..., 3:4]

    view_min = screen_to_view(screen_min)
    view_max = screen_to_view(screen_max)

    z_near_plane = slice_to_depth(coeffs, gz)[..., None][..., 0]
    z_far_plane = slice_to_depth(coeffs, gz + 1.0)[..., None][..., 0]

    eye = jnp.array([0.0, 0.0, 1.0], dtype=jnp.float32)
    pts = [
        _line_intersection_to_z_plane(eye, view_min, z_near_plane),
        _line_intersection_to_z_plane(eye, view_min, z_far_plane),
        _line_intersection_to_z_plane(eye, view_max, z_near_plane),
        _line_intersection_to_z_plane(eye, view_max, z_far_plane),
    ]
    stacked = jnp.stack(pts, axis=0)
    aabb_min = jnp.min(stacked, axis=0).reshape(-1, 3)
    aabb_max = jnp.max(stacked, axis=0).reshape(-1, 3)
    return aabb_min, aabb_max


def cluster_aabb_distance_sq(
    aabb_min: jnp.ndarray, aabb_max: jnp.ndarray, point: jnp.ndarray
) -> jnp.ndarray:
    """Squared point-AABB distance (shared-structs/src/lib.rs:291-298)."""
    distances = jnp.maximum(jnp.maximum(aabb_min - point, point - aabb_max), 0.0)
    return jnp.sum(distances * distances, axis=-1)


def cull_spotlight(
    aabb_min: jnp.ndarray,
    aabb_max: jnp.ndarray,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    angle: jnp.ndarray,
    range_: jnp.ndarray,
) -> jnp.ndarray:
    """Cone-vs-AABB-bounding-sphere cull (shared-structs/src/lib.rs:301-319).

    Returns True where the spotlight can be culled from the cluster.
    """
    center = (aabb_min + aabb_max) / 2.0
    radius = jnp.linalg.norm(aabb_max - center, axis=-1)

    vector = center - origin
    vector_len_sq = jnp.sum(vector * vector, axis=-1)
    vector_1_len = jnp.sum(vector * direction, axis=-1)
    vector_1_len_sq = vector_1_len * vector_1_len

    distance_closest_point = jnp.cos(angle) * jnp.sqrt(
        jnp.maximum(vector_len_sq - vector_1_len_sq, 0.0)
    ) - vector_1_len * jnp.sin(angle)

    angle_cull = distance_closest_point > radius
    front_cull = vector_1_len > radius + range_
    back_cull = vector_1_len < -radius
    return angle_cull | front_cull | back_cull


def assign_lights_to_clusters(
    aabb_min: jnp.ndarray,  # [C, 3] view-space cluster AABBs
    aabb_max: jnp.ndarray,  # [C, 3]
    light_positions_view: jnp.ndarray,  # [L, 3] (view-space)
    light_falloff_sq: jnp.ndarray,  # [L]
    is_spotlight: jnp.ndarray,  # [L] bool
    spot_direction_view: jnp.ndarray,  # [L, 3] (view-space)
    spot_outer_angle: jnp.ndarray,  # [L]
    max_lights_per_cluster: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Dense replacement for the atomic-append assignment kernel
    (shader/src/lib.rs:596-645).

    Computes the full [C, L] inclusion mask, then compacts each cluster's
    accepted lights into the first ``count`` slots of a fixed
    [C, max_lights_per_cluster] index table via an order-preserving sort —
    semantically the per-cluster list the reference builds (ordered by
    light id; the reference's atomic order is unordered, but consumers only
    iterate the set, so set-equality is what matters).

    Returns (counts [C] uint32, indices [C, K] uint32).
    """
    # sphere-vs-AABB (shader/src/lib.rs:620-626)
    d_sq = cluster_aabb_distance_sq(
        aabb_min[:, None, :], aabb_max[:, None, :], light_positions_view[None, :, :]
    )  # [C, L]
    accept = d_sq <= light_falloff_sq[None, :]

    # spotlight cone cull (shader/src/lib.rs:628-638)
    spot_culled = cull_spotlight(
        aabb_min[:, None, :],
        aabb_max[:, None, :],
        light_positions_view[None, :, :],
        spot_direction_view[None, :, :],
        spot_outer_angle[None, :],
        light_falloff_sq[None, :],
    )
    accept = accept & ~(is_spotlight[None, :] & spot_culled)

    num_lights = light_positions_view.shape[0]
    counts = jnp.minimum(
        jnp.sum(accept, axis=-1), max_lights_per_cluster
    ).astype(jnp.uint32)

    # Order-preserving compaction: accepted light ids first, rest pushed to
    # the end. Stable sort on (not accepted) keeps ascending light order.
    light_ids = jnp.arange(num_lights, dtype=jnp.uint32)
    order = jnp.argsort(~accept, axis=-1, stable=True)  # [C, L]
    gathered = jnp.take_along_axis(
        jnp.broadcast_to(light_ids, accept.shape), order, axis=-1
    )
    k = max_lights_per_cluster
    if num_lights < k:
        pad = jnp.zeros((accept.shape[0], k - num_lights), dtype=jnp.uint32)
        indices = jnp.concatenate([gathered, pad], axis=-1)
    else:
        indices = gathered[:, :k]
    return counts, indices

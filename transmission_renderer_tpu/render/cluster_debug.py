"""Cluster-AABB wireframe overlay — the debug pipeline the reference
ships as ``cluster_debugging_vs/fs`` (shader/src/lib.rs:801-839, a
line-list draw over every cluster's view-space AABB; its call site is
present but commented out at src/main.rs:1948-1967, toggled alongside the
false-colour view).

Rendition: no line rasteriser exists, so each AABB edge is sampled at
``samples`` points, projected with the (reversed-Z) perspective, and
point-scattered over the tonemapped image. Debug-only path: runs as its
own tiny jit outside the frame function.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# corner index bit k selects max (1) or min (0) along axis k
_EDGES = np.array(
    [
        (0, 1), (2, 3), (4, 5), (6, 7),  # x-aligned
        (0, 2), (1, 3), (4, 6), (5, 7),  # y-aligned
        (0, 4), (1, 5), (2, 6), (3, 7),  # z-aligned
    ],
    np.int32,
)


def cluster_wireframe_overlay(
    image: jnp.ndarray,  # [H, W, 3] (any range; LDR expected)
    aabb_min: jnp.ndarray,  # [C, 3] view-space cluster AABBs
    aabb_max: jnp.ndarray,  # [C, 3]
    perspective: jnp.ndarray,  # [4, 4] (reversed-Z projection)
    colour=(0.1, 1.0, 0.2),
    samples: int = 16,
) -> jnp.ndarray:
    """Scatter the 12 edges of every cluster AABB over ``image``."""
    h, w = image.shape[:2]
    c = aabb_min.shape[0]
    # [C, 8, 3] corners: bit k of the corner id picks min/max on axis k
    sel = jnp.asarray(
        [[(i >> k) & 1 for k in range(3)] for i in range(8)], jnp.float32
    )  # [8, 3]
    corners = aabb_min[:, None, :] + sel[None] * (
        aabb_max[:, None, :] - aabb_min[:, None, :]
    )
    a = corners[:, _EDGES[:, 0]]  # [C, 12, 3]
    b = corners[:, _EDGES[:, 1]]
    t = jnp.linspace(0.0, 1.0, samples, dtype=jnp.float32)
    pts = a[..., None, :] + (b - a)[..., None, :] * t[:, None]  # [C,12,S,3]
    pts = pts.reshape(-1, 3)
    pts_h = jnp.concatenate([pts, jnp.ones_like(pts[:, :1])], axis=-1)
    clip = pts_h @ perspective.T
    behind = clip[:, 3] <= 1e-6
    ndc = clip[:, :3] / jnp.where(behind, 1.0, clip[:, 3])[:, None]
    px = ((ndc[:, 0] * 0.5 + 0.5) * w).astype(jnp.int32)
    py = ((ndc[:, 1] * 0.5 + 0.5) * h).astype(jnp.int32)
    ok = (~behind) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    # out-of-frame points land on a discard row (in-bounds, sliced away)
    flat_idx = jnp.where(ok, py * w + px, h * w)
    out = jnp.concatenate(
        [image.reshape(-1, 3), jnp.zeros((1, 3), image.dtype)], axis=0
    )
    out = out.at[flat_idx].set(jnp.asarray(colour, image.dtype))
    return out[: h * w].reshape(h, w, 3)

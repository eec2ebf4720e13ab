"""Ray-traced shadows + the acceleration-structure debug ray caster.

The --ray-tracing feature variant: shadow rays modulate sun/point-light
intensity (shader/src/lighting.rs:97-125, applied at :22-37 and :158-166),
and the full-screen AS-debugging caster (the T-key toggle,
shader/src/lib.rs:699-798) renders alpha-tested diffuse colour at the
closest hit of per-pixel camera rays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from transmission_renderer_tpu.ops.bvh import BVH, trace_rays
from transmission_renderer_tpu.ops.texture import WRAP_REPEAT, sample_texture
from transmission_renderer_tpu.render.gbuffer import GBuffer
from transmission_renderer_tpu.pbr.lights import Lights
from transmission_renderer_tpu.scene.types import Scene
from transmission_renderer_tpu.utils.platform import f32_matmuls


def shadow_factors(
    bvh: BVH,
    tri_vertices: jnp.ndarray,  # [TT, 3] into world positions
    world_positions: jnp.ndarray,  # [VV, 3]
    g: GBuffer,
    sun_dir: jnp.ndarray,  # [3]
    lights: Lights,
    light_active: jnp.ndarray | None = None,  # [*g.valid.shape, L] bool
    nol_gate: bool = False,
):
    """(sun_factor [H, W], light_factors [H, W, L]) — 1.0 lit, 0.0 shadowed.

    Mirrors trace_shadow_ray semantics: any-hit in (t_min=0.001, t_max),
    sun t_max = 10_000 (shader/src/lighting.rs:26-32), per-light t_max =
    light distance (:64-71); every candidate is confirmed, so alpha-clip
    is ignored for shadows exactly like the reference.

    ``light_active`` (shading.cluster_light_mask) kills rays for
    (pixel, light) pairs outside the pixel's cluster list by zeroing
    their t_max: the shading loop never reads those factors (they are
    multiplied by ``active`` = 0), so the image is bit-identical while
    the batched walk only pays for cluster-active pairs.

    ``nol_gate`` additionally kills rays where the G-buffer normal faces
    away from the light (N·L <= 0). There the reference's ε-clamped dot
    (pbr/brdf.py::_dot, glam-pbr's f32::EPSILON floor) pins the radiance
    to intensity × 1.19e-7, so the untraced factor changes the result by
    at most ~1e-7 × intensity — far below f32 accumulation noise. Valid
    ONLY for the opaque pass of scenes without normal maps (the shading
    N·L uses the normal-mapped normal, and the transmission BRDF mirrors
    the light direction, so backfacing lights still contribute there);
    render_frame enables it from SceneFlags.
    """
    # ONE batched walk for sun + all lights: each traversal instance is
    # its own chunked while-loop program (ops/bvh.py), so folding the
    # 1 + L ray kinds into a single [1 + L, H*W] batch compiles one loop
    # instead of L + 1 and lets every chunk mix ray kinds. Invalid
    # pixels get t_max = 0: their (t_min, 0) interval fails every AABB
    # test, so they pop the root and idle while real lanes walk.
    origins = g.position.reshape(-1, 3)
    n = origins.shape[0]
    valid = g.valid.reshape(-1)
    nrm = g.normal.reshape(-1, 3) if nol_gate else None
    if light_active is not None:
        light_active = light_active.reshape(-1, lights.num)
    sun_live = valid
    if nol_gate:
        sun_live = sun_live & (jnp.sum(nrm * sun_dir, axis=-1) > 0.0)
    dirs = [jnp.broadcast_to(sun_dir, (n, 3))]
    tmaxs = [jnp.where(sun_live, 10_000.0, 0.0)]
    for li in range(lights.num):
        to_light = lights.position[li] - origins
        dist = jnp.linalg.norm(to_light, axis=-1)
        ldir = to_light / jnp.maximum(dist[..., None], 1e-12)
        dirs.append(ldir)
        # any-hit with t_max = light distance, exactly the reference's
        # per-light shadow ray (shader/src/lighting.rs:64-71) — the walk
        # early-outs on the first occluder instead of finding the closest.
        live = valid
        if light_active is not None:
            live = live & light_active[..., li].reshape(-1)
        if nol_gate:
            live = live & (jnp.sum(nrm * ldir, axis=-1) > 0.0)
        tmaxs.append(jnp.where(live, dist, 0.0))
    hit, *_ = trace_rays(
        bvh, tri_vertices, world_positions,
        jnp.broadcast_to(origins, (1 + lights.num, n, 3)),
        jnp.stack(dirs), t_max=jnp.stack(tmaxs), any_hit=True,
    )
    hit = hit.reshape((1 + lights.num,) + g.valid.shape)
    factors = jnp.where(g.valid[None] & hit, 0.0, 1.0)
    sun_factor = factors[0]
    light_factors = jnp.moveaxis(factors[1:], 0, -1)
    return sun_factor, light_factors


@f32_matmuls
def render_as_debug_frame(scene, dl, params, lights, config, bvh):
    """CLI entry for the AS-debug view (the reference's T-key toggle):
    transforms vertices, refits the BVH and ray-casts the full frame.
    ``lights`` is accepted for signature parity with render_frame (the
    debug view is unlit, like the reference's diffuse-only caster)."""
    del lights
    from transmission_renderer_tpu.ops.bvh import refit_bvh
    from transmission_renderer_tpu.scene.types import Similarity, similarity_apply

    inst_t = Similarity(
        translation=scene.inst_transform.translation[dl.vtx_inst],
        scale=scene.inst_transform.scale[dl.vtx_inst],
        rotation=scene.inst_transform.rotation[dl.vtx_inst],
    )
    world_pos = similarity_apply(inst_t, scene.positions[dl.vtx_src])
    uvs = scene.uvs[dl.vtx_src]
    bvh = refit_bvh(bvh, dl.tri_vtx, world_pos)
    view_inverse = jnp.linalg.inv(params.view)
    # the host-computed inv(proj) (FrameParams.inverse_perspective) —
    # reconstructing proj via proj_view @ inv(view) and inverting again
    # costs two extra device 4x4 inverses and f32 round-trip error vs
    # the unprojection the raster path uses
    proj_inverse = params.inverse_perspective
    return as_debug_view(
        scene, bvh, dl.tri_vtx, dl.tri_material, world_pos, uvs,
        view_inverse, proj_inverse, config.width, config.height,
    )


def as_debug_view(
    scene: Scene,
    bvh: BVH,
    tri_vertices: jnp.ndarray,  # [TT, 3]
    tri_material: jnp.ndarray,  # [TT]
    world_positions: jnp.ndarray,  # [VV, 3]
    uvs: jnp.ndarray,  # [VV, 2]
    view_inverse: jnp.ndarray,  # [4, 4]
    proj_inverse: jnp.ndarray,  # [4, 4]
    width: int,
    height: int,
) -> jnp.ndarray:
    """Full-screen ray-cast debug view (shader/src/lib.rs:699-798):
    camera rays from the inverse view/proj, closest hit with alpha-clip
    candidate confirmation (only candidates whose LOD-0 diffuse alpha
    >= the material cutoff commit, shader/src/lib.rs:777-784), barycentric
    UV interpolation, LOD-0 diffuse sample.
    """
    px = jnp.arange(width, dtype=jnp.float32)[None, :] + 0.5
    py = jnp.arange(height, dtype=jnp.float32)[:, None] + 0.5
    tex_u = jnp.broadcast_to(px / width, (height, width))
    tex_v = jnp.broadcast_to(py / height, (height, width))
    rc_x = tex_u * 2.0 - 1.0
    rc_y = tex_v * 2.0 - 1.0

    origin = view_inverse[:3, 3]
    target = jnp.stack(
        [rc_x, rc_y, jnp.ones_like(rc_x), jnp.ones_like(rc_x)], axis=-1
    ) @ proj_inverse.T
    local_dir = target[..., :3] / jnp.linalg.norm(
        target[..., :3], axis=-1, keepdims=True
    )
    direction = local_dir @ view_inverse[:3, :3].T

    origins = jnp.broadcast_to(origin, direction.shape)

    m = scene.materials

    def alpha_test(tri_id, u, v):
        # the caster's candidate confirmation (shader/src/lib.rs:770-784):
        # BLAS geometry carries no OPAQUE flag (acceleration_structures.rs
        # :31), so EVERY candidate is alpha-tested — LOD-0 diffuse alpha
        # (times the factor) must reach the material cutoff to commit.
        # The wide-BVH walk tests a [LEAF_TRIS] candidate batch per call
        # (ops/bvh.py), so everything here is broadcast-indexed.
        mid = tri_material[tri_id]
        tid = m.tex_diffuse[mid]
        vidx = tri_vertices[tri_id]  # [..., 3]
        uv = (
            uvs[vidx[..., 0]] * (1.0 - u - v)[..., None]
            + uvs[vidx[..., 1]] * u[..., None]
            + uvs[vidx[..., 2]] * v[..., None]
        )
        sample = sample_texture(
            scene.atlas_texels, scene.atlas_meta, scene.atlas_srgb,
            jnp.maximum(tid, 0), uv, jnp.zeros_like(u), WRAP_REPEAT,
            trilinear=False,
        )
        alpha = m.diffuse_factor[mid, 3] * jnp.where(
            tid >= 0, sample[..., 3], 1.0
        )
        return alpha >= m.alpha_clipping_cutoff[mid]

    hit, t, tri_id, u, v = trace_rays(
        bvh, tri_vertices, world_positions, origins, direction,
        t_min=0.01, t_max=1000.0, alpha_test_fn=alpha_test,
    )

    safe_tri = jnp.maximum(tri_id, 0)
    vidx = tri_vertices[safe_tri]
    uv0 = uvs[vidx[..., 0]]
    uv1 = uvs[vidx[..., 1]]
    uv2 = uvs[vidx[..., 2]]
    w0 = (1.0 - u - v)[..., None]
    uv = uv0 * w0 + uv1 * u[..., None] + uv2 * v[..., None]

    mid = tri_material[safe_tri]
    m = scene.materials
    diffuse = m.diffuse_factor[mid][..., :3]
    tid = m.tex_diffuse[mid]
    sample = sample_texture(
        scene.atlas_texels, scene.atlas_meta, scene.atlas_srgb,
        jnp.maximum(tid, 0), uv, jnp.zeros_like(u), WRAP_REPEAT,
        trilinear=False,
    )
    diffuse = jnp.where((tid >= 0)[..., None], diffuse * sample[..., :3], diffuse)
    return jnp.where(hit[..., None], diffuse, 0.0)

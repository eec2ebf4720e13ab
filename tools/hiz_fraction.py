"""Measure the Hi-Z-skippable fraction of transmission raster records.

For each (tile, class-1 record) pair in the sorted stream, a record is
skippable when its conservative NEAREST interpolated depth
max_i(z_i / w_i) (valid when all clip w > 0) cannot beat the tile's
farthest OPAQUE depth (reversed-Z min over the tile's pixels) — the
record then wins no pixel over the opaque init depth.

This decides whether an XLA-side stream filter (compact the class-1
runs before the kernel) is worth building.

Usage: python tools/hiz_fraction.py [dragon|stress] [width height]
Runs on CPU (forced) — fractions are geometry properties, resolution
only mildly changes them.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def main():
    scene_name = sys.argv[1] if len(sys.argv) > 1 else "dragon"
    w = int(sys.argv[2]) if len(sys.argv) > 2 else 960
    h = int(sys.argv[3]) if len(sys.argv) > 3 else 540

    import jax.numpy as jnp

    from transmission_renderer_tpu.config import (
        BUCKET_ALPHA_CLIP,
        BUCKET_OPAQUE,
        BUCKET_TRANSMISSION,
        BUCKET_TRANSMISSION_ALPHA_CLIP,
        RenderConfig,
    )
    from transmission_renderer_tpu.models import (
        build_dragon_scene,
        build_stress_scene,
    )
    from transmission_renderer_tpu.ops.cull import (
        bucket_triangle_masks,
        cull_instances,
    )
    from transmission_renderer_tpu.ops.raster import (
        bin_triangles,
        rasterize,
        setup_triangles,
        tile_image,
    )
    from transmission_renderer_tpu.render import make_frame_params
    from transmission_renderer_tpu.scene.camera import CameraRig
    from transmission_renderer_tpu.scene.types import (
        Similarity,
        quat_rotate,
        similarity_apply,
    )

    builder = (
        build_dragon_scene(roughness_override=0.25)
        if scene_name == "dragon"
        else build_stress_scene()
    )
    scene, dl, flags = builder.finish_bundle()
    config = RenderConfig(width=w, height=h, tile_w=128, tile_h=8)
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    rig.sun_yaw = 4.8
    params = make_frame_params(
        config, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir()
    )

    # vertex transform + cull (mirrors render_frame's geometry pass)
    inst_t = Similarity(
        translation=scene.inst_transform.translation[dl.vtx_inst],
        scale=scene.inst_transform.scale[dl.vtx_inst],
        rotation=scene.inst_transform.rotation[dl.vtx_inst],
    )
    world_pos = similarity_apply(inst_t, scene.positions[dl.vtx_src])
    pos_h = jnp.concatenate([world_pos, jnp.ones_like(world_pos[:, :1])], -1)
    clip = pos_h @ params.proj_view.T
    visible = cull_instances(
        scene, params.view, params.frustum_x_xz, params.frustum_y_yz,
        config.z_near,
    )
    mask_o = bucket_triangle_masks(
        dl.tri_inst, dl.tri_bucket, visible,
        (BUCKET_OPAQUE, BUCKET_ALPHA_CLIP),
    )
    mask_t = bucket_triangle_masks(
        dl.tri_inst, dl.tri_bucket, visible,
        (BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP),
    )

    # opaque depth from the JAX raster path
    tw, th = 32, 8
    setup_o = setup_triangles(clip, dl.tri_vtx, mask_o, w, h, tw, th)
    bins_o = bin_triangles(
        setup_o, -(-w // tw), -(-h // th), config.max_tiles_per_tri,
        config.max_tris_per_tile, config.max_big_tris,
    )
    vis_o = rasterize(setup_o, bins_o, w, h, tw, th)

    # class-split Pallas-geometry bins at the kernel's 128x8 tile
    is_trans = (dl.tri_bucket == BUCKET_TRANSMISSION) | (
        dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP
    )
    is_clip = (dl.tri_bucket == BUCKET_ALPHA_CLIP) | (
        dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP
    )
    tri_class = is_trans.astype(jnp.int32) + 2 * is_clip.astype(jnp.int32)
    nc = 4 if bool(jnp.any(is_clip)) else 2
    tiles_x, tiles_y = -(-w // 128), -(-h // 8)
    setup_all = setup_triangles(
        clip, dl.tri_vtx, mask_o | mask_t, w, h, 128, 8
    )
    bins = bin_triangles(
        setup_all, tiles_x, tiles_y, config.pallas_tiles_per_tri,
        config.max_tris_per_tile, config.pallas_max_big_tris,
        materialize=False, class_flags=tri_class, num_classes=nc,
        tiers=config.pallas_tiers,
    )

    # per-tile min opaque depth (reversed-Z farthest), tile = 128x8
    tile_min = jnp.min(
        tile_image(vis_o.depth, 128, 8), axis=(1, 2)
    )  # [n_tiles]

    # per-record conservative nearest depth
    zw = setup_all.z_clip / setup_all.w_clip  # [T, 3]
    zw_max = jnp.max(zw, axis=1)
    w_pos = jnp.min(setup_all.w_clip, axis=1) > 0.0

    sorted_bins_start = np.asarray(bins.tile_start)
    sorted_tris = np.asarray(bins.sorted_tri_ids)
    zw_max = np.asarray(zw_max)
    w_pos = np.asarray(w_pos)
    tile_min = np.asarray(tile_min)

    stats = {}
    for cls, label in [(0, "opaque"), (1, "transmission")]:
        visits = 0
        skippable = 0
        for t in range(tiles_x * tiles_y):
            s = sorted_bins_start[t * nc + cls]
            e = sorted_bins_start[t * nc + cls + 1]
            if e <= s:
                continue
            ids = sorted_tris[s:e]
            ids = ids[ids >= 0]
            visits += ids.size
            skippable += int(
                np.sum(w_pos[ids] & (zw_max[ids] <= tile_min[t]))
            )
        stats[label] = (visits, skippable)
        frac = skippable / max(visits, 1)
        print(
            f"{label:>13}: {visits} record-visits, "
            f"{skippable} Hi-Z-skippable ({100 * frac:.1f}%)"
        )
    return stats


if __name__ == "__main__":
    main()

"""render_frame — the whole frame as one jittable function.

The equivalent of ``record()`` (src/main.rs:1551-2263). Pass order
mirrors the reference frame graph:

  1. vertex transform + frustum culling        (compute prefix, :1651-1850)
  2. opaque + alpha-clip raster -> vis buffer  (draw pass subp. 0/1, :1852-2001)
  3. cluster AABBs + light assignment          (:1478-1517, :1792-1797)
  4. opaque PBR shade                          (fragment, shader lib.rs:164)
  5. opaque-framebuffer mip pyramid            (generate_mips, :2054)
  6. transmissive raster against opaque depth  (subpass 2, :2005-2042)
  7. transmission shade                        (transmission pass, :2066-2124)
  8. Lottes tonemap                            (:2197-2232)

XLA supplies all scheduling/synchronisation the reference does with
subpass dependencies and vk-sync barriers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from transmission_renderer_tpu.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    BUCKET_TRANSMISSION_ALPHA_CLIP,
    RenderConfig,
)
from transmission_renderer_tpu.ops.cull import (
    bucket_triangle_masks,
    cull_instances,
    frustum_planes_from_projection,
)
from transmission_renderer_tpu.ops.mipchain import build_pyramid
from transmission_renderer_tpu.ops.raster import (
    bin_triangles,
    rasterize,
    setup_triangles,
)
from transmission_renderer_tpu.ops.texture import WRAP_REPEAT, sample_texture
from transmission_renderer_tpu.scene import textures as _tx
from transmission_renderer_tpu.scene.textures import MAX_MIPS
from transmission_renderer_tpu.pbr import (
    bake_lottes_params,
    cluster_coefficients,
    lottes_tonemap,
    lottes_tonemap_planes,
)
from transmission_renderer_tpu.pbr.clustering import (
    assign_lights_to_clusters,
    write_cluster_data,
)
from transmission_renderer_tpu.pbr.lights import Lights
from transmission_renderer_tpu.render.gbuffer import interpolate_gbuffer
from transmission_renderer_tpu.render.shading import (
    ShadeContext,
    cluster_light_mask,
    shade_opaque,
    shade_opaque_flat,
    shade_transmission,
    shade_transmission_flat,
)
from transmission_renderer_tpu.render.sparse import (
    block_gather,
    block_scatter,
    compact_blocks,
    num_blocks,
    pixel_coords,
)
from transmission_renderer_tpu.scene.camera import perspective_matrix_reversed
from transmission_renderer_tpu.scene.types import (
    Scene,
    Similarity,
    quat_rotate,
    similarity_apply,
)
from transmission_renderer_tpu.utils.ggx_lut import default_ggx_lut
from transmission_renderer_tpu.utils.platform import (
    f32_matmuls,
    use_raster_kernel,
)
from transmission_renderer_tpu.utils.profiling import pass_scope


class DrawList(NamedTuple):
    """Static per-scene instance expansion.

    The reference re-walks instances per frame via instanced indirect
    draws; here the (instance x primitive-geometry) product is flattened
    once at scene freeze so the frame function is pure gathers.
    """

    vtx_src: jnp.ndarray  # [VV] int32 into scene vertex pool
    vtx_inst: jnp.ndarray  # [VV] int32 instance of each expanded vertex
    tri_vtx: jnp.ndarray  # [TT, 3] int32 into expanded pool
    tri_inst: jnp.ndarray  # [TT] int32
    tri_bucket: jnp.ndarray  # [TT] int32
    tri_material: jnp.ndarray  # [TT] int32


def build_draw_list(scene: Scene) -> DrawList:
    """NumPy expansion from a frozen Scene. NOTE: reads device arrays back
    to the host; ``SceneBuilder.finish_bundle()`` stays host-side."""
    return build_draw_list_from_numpy(
        np.asarray(scene.inst_primitive_id),
        np.asarray(scene.inst_material_id),
        np.asarray(scene.prim_first_tri),
        np.asarray(scene.prim_tri_count),
        np.asarray(scene.prim_draw_bucket),
        np.asarray(scene.indices),
    )


def expand_draw_list_numpy(
    inst_prim: np.ndarray,
    inst_mat: np.ndarray,
    prim_first_tri: np.ndarray,
    prim_tri_count: np.ndarray,
    prim_bucket: np.ndarray,
    indices: np.ndarray,
) -> dict:
    """NumPy instance x geometry expansion (shared by DrawList construction
    and host-side BVH builds)."""
    if len(inst_prim) == 0:
        raise ValueError(
            "draw-list expansion requires at least one instance "
            "(camera/light-only scenes have nothing to rasterise)"
        )
    vtx_src, vtx_inst = [], []
    tri_vtx, tri_inst, tri_bucket, tri_material = [], [], [], []
    vtx_offset = 0
    for i, p in enumerate(inst_prim):
        t0 = prim_first_tri[p]
        tc = prim_tri_count[p]
        tris = indices[t0 : t0 + tc]  # [tc, 3] into the shared pool
        v_lo = tris.min() if tc else 0
        v_hi = tris.max() + 1 if tc else 0
        count = v_hi - v_lo
        vtx_src.append(np.arange(v_lo, v_hi, dtype=np.int32))
        vtx_inst.append(np.full(count, i, np.int32))
        tri_vtx.append(tris - v_lo + vtx_offset)
        tri_inst.append(np.full(tc, i, np.int32))
        tri_bucket.append(np.full(tc, prim_bucket[p], np.int32))
        tri_material.append(np.full(tc, inst_mat[i], np.int32))
        vtx_offset += count

    return dict(
        vtx_src=np.concatenate(vtx_src),
        vtx_inst=np.concatenate(vtx_inst),
        tri_vtx=np.concatenate(tri_vtx).astype(np.int32),
        tri_inst=np.concatenate(tri_inst),
        tri_bucket=np.concatenate(tri_bucket),
        tri_material=np.concatenate(tri_material),
    )


def build_draw_list_from_numpy(*args) -> DrawList:
    """NumPy expansion at scene-freeze time -> device DrawList."""
    d = expand_draw_list_numpy(*args)
    return DrawList(**{k: jnp.asarray(v) for k, v in d.items()})


class SceneFlags(NamedTuple):
    """Static (hashable) facts about a scene that gate whole passes.

    The reference gates equivalent work by bucket draw counts at record
    time (src/main.rs:1900-2042) and per-fragment texture-id branches
    (shader/src/lib.rs:67-77 etc.); under jit these must be trace-time
    constants, and per-pixel branching is replaced by *scene-wide* slot
    gating: a texture slot no material uses is skipped entirely (each
    skipped slot saves ~8 gathers/pixel). Compute once per scene with
    ``scene_flags`` (or host-side via ``SceneBuilder.finish_bundle``).
    """

    has_alpha_clip: bool
    has_transmission: bool
    # which of the 9 texture slots any material actually uses
    # (diffuse, metallic_roughness, normal_map, emissive, occlusion,
    #  transmission, thickness, specular, specular_colour)
    tex_slots: tuple = (True,) * 9
    # slot usage restricted to materials referenced by transmissive-bucket
    # instances — the transmission shade pass only ever keeps those pixels,
    # so texture slots other materials use can be skipped there.
    tex_slots_transmission: tuple = (True,) * 9
    # Static f32 values of apply_ior_to_roughness(perceptual_roughness,
    # ior) over the transmissive-bucket materials, or None when any of
    # them modulates roughness with a metallic_roughness texture. When
    # present, the transmission pass's framebuffer-mip fetch lod
    # (log2(fb_width) * this, glam-pbr/src/lib.rs:334-335) is statically
    # bounded, so the pyramid fetch touches only the few needed levels'
    # small quad tables (ops/mipchain.py).
    transmission_ior_roughness: tuple | None = None
    # Groups of sampled texture slots that, for EVERY material, reference
    # one atlas bundle image (layers packed per texture_ref): such groups
    # share one meta block + ONE bundle gather per tap in the material
    # matrix (render/shading.py). Computed by compute_slot_bundles.
    slot_bundles: tuple = ()
    # Every atlas image has power-of-two dimensions -> material taps use
    # the FUSED single-gather trilinear path (the in-block 3x3 parent
    # patch, ops/texture.py); non-POT scenes fall back to the 2-gather
    # two-level blend (exact for any size).
    atlas_pot: bool = False


TEX_SLOT_NAMES = (
    "tex_diffuse", "tex_metallic_roughness", "tex_normal_map",
    "tex_emissive", "tex_occlusion", "tex_transmission", "tex_thickness",
    "tex_specular", "tex_specular_colour",
)


def atlas_all_pot(atlas_meta) -> bool:
    """True when every atlas image is power-of-two sized (gates the fused
    single-gather trilinear path, ops/texture.py)."""
    m = np.asarray(atlas_meta)
    w = m[:, 2].astype(np.int64)
    h = m[:, 3].astype(np.int64)
    return bool(np.all((w & (w - 1)) == 0) and np.all((h & (h - 1)) == 0))


def compute_slot_bundles(tex_columns: dict) -> tuple:
    """Detect the scene-wide bundle group (SceneFlags.slot_bundles).

    Returns one group of ALL sampled slots when every material's used
    sampled slots point at a single atlas image (bundle layers packed via
    scene/textures.py::texture_ref) — then the material tap pays ONE
    gather for the whole slot set. Materials using at most one sampled
    slot are trivially consistent, so single-texture scenes group
    harmlessly. Mixed scenes (one material reading two DIFFERENT images
    through sampled slots) disable grouping entirely (per-slot taps, the
    pre-bundle behaviour)."""
    from transmission_renderer_tpu.scene.textures import IMAGE_MASK

    names = tuple(n for n in TEX_SLOT_NAMES if n != "tex_occlusion")
    stack = np.stack([np.asarray(tex_columns[n]) for n in names])
    imgs = np.where(stack >= 0, stack & IMAGE_MASK, -1)
    mx = imgs.max(axis=0)
    ok = np.all((imgs < 0) | (imgs == mx[None]), axis=0)
    if np.all(ok):
        return (names,)
    return ()


def compute_tex_slot_flags(
    tex_columns: dict, inst_material: np.ndarray | None = None,
    restrict_to: np.ndarray | None = None,
) -> tuple:
    """Per-slot usage flags; optionally restricted to the materials used by
    a subset of instances (``restrict_to`` boolean over instances)."""
    if restrict_to is not None and inst_material is not None:
        mids = np.unique(inst_material[restrict_to])
        if len(mids) == 0:
            return (False,) * len(TEX_SLOT_NAMES)
        return tuple(
            bool(np.any(np.asarray(tex_columns[n])[mids] >= 0))
            for n in TEX_SLOT_NAMES
        )
    return tuple(
        bool(np.any(np.asarray(tex_columns[n]) >= 0)) for n in TEX_SLOT_NAMES
    )


def static_ior_roughness_values(roughs, iors) -> tuple:
    """apply_ior_to_roughness(perceptual_roughness, ior) over parallel
    factor arrays, in f32 exactly as the device computes it
    (glam-pbr/src/lib.rs:144-161), deduplicated and sorted."""
    r = np.asarray(roughs, np.float32)
    ior = np.asarray(iors, np.float32)
    v = r * np.clip(
        ior * np.float32(2.0) - np.float32(2.0), np.float32(0), np.float32(1)
    )
    return tuple(sorted(set(float(x) for x in v.astype(np.float32))))


def scene_flags_from_arrays(
    prim_buckets: np.ndarray,
    inst_prim: np.ndarray,
    inst_mat: np.ndarray,
    cols: dict,  # TEX_SLOT_NAMES -> [n_materials] id columns (numpy-able)
    roughness_factor: np.ndarray,
    index_of_refraction: np.ndarray,
    atlas_meta: np.ndarray,
) -> SceneFlags:
    """The SINGLE SceneFlags derivation, on plain host arrays — shared by
    scene_flags (device Scene) and SceneBuilder.finish_bundle (host
    staging lists, which must not read device arrays back).

    Pass gating keys off INSTANCED primitives (inst_bucket), not the
    primitive pool: a pool entry no node references must not enable the
    clip-peel rounds or disable the fused sparse-transmission path."""
    buckets = np.asarray(prim_buckets)
    inst_bucket = buckets[np.asarray(inst_prim, np.int64)]
    inst_mat = np.asarray(inst_mat)
    cols = {n: np.asarray(c) for n, c in cols.items()}
    trans_inst = (inst_bucket == BUCKET_TRANSMISSION) | (
        inst_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP
    )
    trans_mids = np.unique(inst_mat[trans_inst])
    if len(trans_mids) and not np.any(
        cols["tex_metallic_roughness"][trans_mids] >= 0
    ):
        tir = static_ior_roughness_values(
            np.asarray(roughness_factor, np.float32)[trans_mids],
            np.asarray(index_of_refraction, np.float32)[trans_mids],
        )
    else:
        tir = None
    return SceneFlags(
        has_alpha_clip=bool(
            np.any(inst_bucket == BUCKET_ALPHA_CLIP)
            | np.any(inst_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)
        ),
        has_transmission=bool(
            np.any(inst_bucket == BUCKET_TRANSMISSION)
            | np.any(inst_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)
        ),
        tex_slots=compute_tex_slot_flags(cols),
        tex_slots_transmission=compute_tex_slot_flags(
            cols, inst_mat, trans_inst
        ),
        transmission_ior_roughness=tir,
        slot_bundles=compute_slot_bundles(cols),
        atlas_pot=atlas_all_pot(atlas_meta),
    )


def scene_flags(scene: Scene) -> SceneFlags:
    m = scene.materials
    return scene_flags_from_arrays(
        np.asarray(scene.prim_draw_bucket),
        np.asarray(scene.inst_primitive_id),
        np.asarray(scene.inst_material_id),
        {n: np.asarray(getattr(m, n)) for n in TEX_SLOT_NAMES},
        np.asarray(m.roughness_factor),
        np.asarray(m.index_of_refraction),
        np.asarray(scene.atlas_meta),
    )


def refraction_level_set(
    flags: "SceneFlags", width: int, num_levels: int
) -> tuple | None:
    """Static pyramid level set covering every lod the transmission pass
    can fetch (lod = log2(fb_width) * ior_adjusted_roughness,
    glam-pbr/src/lib.rs:334-335), or None when roughness is per-pixel.

    Mirrors the device's f32 math with a +-1e-3 guard band so f32
    rounding differences can never select a level outside the set; the
    guard may only widen the set by one (cheap, coarse) level."""
    vals = flags.transmission_ior_roughness
    if vals is None:
        return None
    mx = num_levels - 1
    log2w = float(np.log2(np.float32(width)))
    levels = set()
    for v in vals:
        lod = float(np.float32(log2w) * np.float32(v))
        if lod == np.floor(lod):
            # exactly-integer lod (e.g. roughness 0 -> lod 0): the other
            # tent tap has weight exactly 0 — one tap, one level
            levels.add(int(min(max(lod, 0.0), mx)))
            continue
        for guard in (lod - 1e-3, lod + 1e-3):
            g = min(max(guard, 0.0), float(mx))
            l0 = int(np.floor(g))
            levels.add(l0)
            levels.add(min(l0 + 1, mx))
    return tuple(range(min(levels), max(levels) + 1))


def _up2(a, axis, nxt_override=None):
    """2x upsample of a half-res sample grid whose samples sit at
    full-res pixels (2i): even outputs copy their sample exactly, odd
    outputs average the flanking samples (edge-clamped) —
    jax.image.resize's half-pixel-center alignment would shift every
    factor a quarter sample instead. ``nxt_override`` replaces the
    shifted-by-one neighbour array (the sharded path substitutes a
    halo-exchanged band boundary row, parallel/sharded.py)."""
    import jax as _jax

    if nxt_override is None:
        last = _jax.lax.slice_in_dim(
            a, a.shape[axis] - 1, a.shape[axis], axis=axis
        )
        nxt = jnp.concatenate(
            [_jax.lax.slice_in_dim(a, 1, a.shape[axis], axis=axis), last],
            axis=axis,
        )
    else:
        nxt = nxt_override
    pair = jnp.stack([a, 0.5 * (a + nxt)], axis=axis + 1)
    return pair.reshape(
        a.shape[:axis] + (2 * a.shape[axis],) + a.shape[axis + 1 :]
    )


class FrameDiagnostics(NamedTuple):
    """Runtime capacity diagnostics (the analogue of Vulkan's validation
    layer catching undersized indirect buffers). All fields are scalars;
    hosts should check them and warn loudly — see cli.py. A value above
    its capacity means the frame silently lost work."""

    max_bin_count: jnp.ndarray  # busiest tile's unclamped triangle count
    bin_capacity: int  # max_tris_per_tile (JAX raster path only)
    big_tri_count: jnp.ndarray  # unclamped big-triangle list demand
    big_tri_capacity: int  # max_big_tris
    opaque_blocks: jnp.ndarray  # active 128-px blocks in the opaque pass
    opaque_block_capacity: int  # worklist cap (0 = dense, no cap)
    transmission_blocks: jnp.ndarray
    transmission_block_capacity: int
    # alpha-clip pixels whose depth-peeling did not converge within
    # config.alpha_clip_rounds (0 = image exact)
    clip_unresolved: jnp.ndarray | int = 0
    # mid-tier binning demand (Pallas path; ops/raster.py tiered demotion)
    mid_tri_count: jnp.ndarray | int = 0
    mid_tri_capacity: int = 0
    # sparse-tile raster worklists (render_frame Pallas path)
    transmission_tiles: jnp.ndarray | int = 0
    transmission_tile_capacity: int = 0
    clip_tiles: jnp.ndarray | int = 0
    clip_tile_capacity: int = 0
    # worst demotion-tier rung overflow (Pallas tier ladder,
    # config.pallas_tiers): demand minus slots, > 0 = dropped draws
    tier_overflow: jnp.ndarray | int = 0
    # per-PEEL-ROUND failing-tile demand (max across clip classes) and
    # the static per-round re-race caps — convergence visibility for the
    # alpha-clip depth peel (a round whose demand exceeds its cap leaves
    # unresolved pixels no later round can recover)
    clip_round_demand: tuple = ()
    clip_round_caps: tuple = ()
    # binning pair-stream compaction (ops/raster.py pair_cap_frac):
    # valid-pair demand vs the compacted stream's static capacity
    pair_demand: jnp.ndarray | int = 0
    pair_capacity: int = 0

    def overflowed(self) -> bool:
        """Host-side check (call outside jit on fetched values)."""
        checks = [
            (int(self.max_bin_count), self.bin_capacity),
            (int(self.big_tri_count), self.big_tri_capacity),
            (int(self.opaque_blocks), self.opaque_block_capacity),
            (int(self.transmission_blocks), self.transmission_block_capacity),
            (int(self.mid_tri_count), self.mid_tri_capacity),
            (int(self.transmission_tiles), self.transmission_tile_capacity),
            (int(self.clip_tiles), self.clip_tile_capacity),
            (int(self.pair_demand), self.pair_capacity),
        ]
        return (
            any(cap and n > cap for n, cap in checks)
            or int(self.clip_unresolved) > 0
            or int(self.tier_overflow) > 0
        )


class FrameParams(NamedTuple):
    """Per-frame camera/sun uniforms (PushConstants + Uniforms +
    CullingPushConstants, shared-structs/src/lib.rs:11-29, 273-280)."""

    proj_view: jnp.ndarray  # [4, 4]
    view: jnp.ndarray  # [4, 4]
    inverse_perspective: jnp.ndarray  # [4, 4]
    view_position: jnp.ndarray  # [3]
    frustum_x_xz: jnp.ndarray  # [2]
    frustum_y_yz: jnp.ndarray  # [2]
    sun_dir: jnp.ndarray  # [3]
    sun_intensity: jnp.ndarray  # [3]


def make_frame_params(
    config: RenderConfig,
    view_matrix: np.ndarray,
    view_position: np.ndarray,
    sun_dir: np.ndarray,
    sun_intensity=(3.0, 3.0, 3.0),  # Vec3::splat(3.0), src/main.rs:538
) -> FrameParams:
    proj = perspective_matrix_reversed(
        config.width, config.height, config.vertical_fov, config.z_near, config.z_far
    )
    fx, fy = frustum_planes_from_projection(proj)
    return FrameParams(
        proj_view=jnp.asarray(proj @ view_matrix),
        view=jnp.asarray(view_matrix),
        inverse_perspective=jnp.asarray(np.linalg.inv(proj).astype(np.float32)),
        view_position=jnp.asarray(np.asarray(view_position, np.float32)),
        frustum_x_xz=jnp.asarray(fx),
        frustum_y_yz=jnp.asarray(fy),
        sun_dir=jnp.asarray(np.asarray(sun_dir, np.float32)),
        sun_intensity=jnp.asarray(np.asarray(sun_intensity, np.float32)),
    )


@functools.lru_cache(maxsize=8)
def _static_cluster_data(config: RenderConfig):
    """Cluster coefficients + view-space cluster AABBs, computed ONCE per
    config. They depend only on the projection and the cluster grid — the
    reference computes them at startup/resize (src/main.rs:832-840,
    :1478-1517), not per frame. ``make_frame_params`` derives
    ``inverse_perspective`` from the same config, so using the cached
    value inside render_frame is exact. Returned arrays are concrete, so
    under jit they become trace-time constants: the frame HLO no longer
    contains the AABB construction. (ensure_compile_time_eval keeps the
    math eager even when first called inside a trace — without it the
    cache would capture and leak tracers.)"""
    import jax

    proj = perspective_matrix_reversed(
        config.width, config.height, config.vertical_fov,
        config.z_near, config.z_far,
    )
    coeffs = cluster_coefficients(
        config.z_near, config.z_far, config.num_depth_slices
    )
    with jax.ensure_compile_time_eval():
        inv = jnp.asarray(np.linalg.inv(proj).astype(np.float32))
        aabb_min, aabb_max = write_cluster_data(
            inv,
            (config.width, config.height),
            (config.num_clusters_x, config.num_clusters_y),
            coeffs,
        )
    return coeffs, jax.device_get(aabb_min), jax.device_get(aabb_max)


def _gather_gbuffer(wk, g):
    """Gather every G-buffer channel's active blocks -> flat worklist."""
    import jax

    return jax.tree_util.tree_map(lambda a: block_gather(wk, a), g)


def _clip_alpha_ok_tiles(scene: Scene, ch: dict) -> jnp.ndarray:
    with pass_scope("clip_alpha_test"):
        return _clip_alpha_ok_tiles_inner(scene, ch)


def _clip_alpha_ok_tiles_inner(scene: Scene, ch: dict) -> jnp.ndarray:
    """Alpha test of the clip race's current winners (the fragment kill of
    depth_pre_pass_alpha_clip, shader/src/lib.rs:270-295), on the kernel's
    tiled channel dict. Implicit-LOD sampling from the analytic
    derivatives (the reference's ``texture_sampler.sample``). True where
    the winner passes (or there is no winner)."""
    from transmission_renderer_tpu.ops.texture import (
        atlas_classes,
        sample_texture_rows,
    )
    from transmission_renderer_tpu.render.shading import _mip_lod
    from transmission_renderer_tpu.scene.textures import (
        IMAGE_MASK,
        LAYER_SHIFT,
    )

    from transmission_renderer_tpu.render.shading import onehot_rows
    from transmission_renderer_tpu.scene.textures import META_COLS, MAX_MIPS

    m = scene.materials
    valid = ch["tri"] >= 0
    safe = jnp.maximum(ch["material"], 0)
    # ONE fused one-hot matmul fetch for every per-material column the
    # test reads (tid, alpha factor, cutoff, the diffuse image's meta
    # row) instead of one small-table gather each. Offsets split into
    # 12-bit halves for f32 exactness
    # (render/shading.py::build_material_matrix does the same).
    img = jnp.maximum(m.tex_diffuse, 0) & IMAGE_MASK
    meta_i = scene.atlas_meta[img][:, :META_COLS].astype(jnp.int32)
    offs = meta_i[:, 4 : 4 + MAX_MIPS]
    table = jnp.concatenate(
        [
            m.tex_diffuse[:, None].astype(jnp.float32),
            m.diffuse_factor[:, 3:4],
            m.alpha_clipping_cutoff[:, None],
            meta_i[:, :4].astype(jnp.float32),
            (offs >> 12).astype(jnp.float32),
            (offs & 0xFFF).astype(jnp.float32),
            meta_i[:, 4 + MAX_MIPS :].astype(jnp.float32),
        ],
        axis=1,
    )
    mrow = onehot_rows(table, safe.reshape(-1)).reshape(
        safe.shape + (table.shape[1],)
    )
    tid = mrow[..., 0].astype(jnp.int32)
    packed = jnp.maximum(tid, 0)
    head = mrow[..., 3:7].astype(jnp.int32)
    hi = mrow[..., 7 : 7 + MAX_MIPS].astype(jnp.int32)
    lo = mrow[..., 7 + MAX_MIPS : 7 + 2 * MAX_MIPS].astype(jnp.int32)
    layers_c = mrow[..., 7 + 2 * MAX_MIPS :].astype(jnp.int32)
    rows = jnp.concatenate([head, (hi << 12) | lo, layers_c], axis=-1)
    uv = jnp.stack([ch["uv_u"], ch["uv_v"]], -1)
    duvdx = jnp.stack([ch["duvdx_u"], ch["duvdx_v"]], -1)
    duvdy = jnp.stack([ch["duvdy_u"], ch["duvdy_v"]], -1)
    lod = _mip_lod(duvdx, duvdy, rows[..., 2], rows[..., 3])
    classes = atlas_classes(scene.atlas_meta)
    s = sample_texture_rows(
        scene.atlas_texels, rows, uv, lod, WRAP_REPEAT,
        layer=(packed >> LAYER_SHIFT) if max(classes) > 1 else None,
        classes=classes,
    )
    alpha = mrow[..., 1] * jnp.where(tid >= 0, s[..., 3], 1.0)
    return (~valid) | (alpha >= mrow[..., 2])


def _merge_gbuffers(base, top):
    """Depth-pass merge: where the (init-depth-seeded) top layer won a
    pixel, take its G-buffer; else keep base."""
    from transmission_renderer_tpu.render.gbuffer import GBuffer

    pick = top.valid
    fields = {}
    for name in GBuffer._fields:
        a = getattr(top, name)
        b = getattr(base, name)
        m = pick[..., None] if a.ndim == 3 else pick
        fields[name] = jnp.where(m, a, b)
    fields["valid"] = base.valid | top.valid
    return GBuffer(**fields)


def _class_tile_worklist(
    tile_start: jnp.ndarray, n_tiles: int, num_classes: int, cls: int,
    cap: int,
):
    """Compact the ids of tiles holding >= 1 sorted record of draw class
    ``cls`` into a static-size worklist (the raster analogue of
    render/sparse.py's block compaction). Per-tile class counts are free:
    they are the class-split ``tile_start`` runs (ops/raster.py). Returns
    (ids [cap] padded with n_tiles, active_count, pad_tile) —
    ``pad_tile`` is a tile with the FEWEST records of this class: callers
    must aim empty slots at it, NOT clamp to n_tiles - 1 (the last tile
    can hold many records, and every empty slot re-walks its record run
    in the kernel — measured as a real sparse-raster cost)."""
    base = jnp.arange(n_tiles, dtype=jnp.int32) * num_classes + cls
    counts = tile_start[base + 1] - tile_start[base]
    active = counts > 0
    pad_tile = jnp.argmin(counts).astype(jnp.int32)
    pos = jnp.cumsum(active.astype(jnp.int32)) - 1
    count = jnp.sum(active.astype(jnp.int32))
    tgt = jnp.where(active & (pos < cap), pos, cap)
    ids = (
        jnp.full((cap + 1,), n_tiles, jnp.int32)
        .at[tgt]
        .set(jnp.arange(n_tiles, dtype=jnp.int32))[:cap]
    )
    return ids, count, pad_tile


def _default_gbuf_channels(
    n_tiles: int, init_depth_tiles: jnp.ndarray, pos_derivs: bool,
    uv_channels: bool = True,
):
    """Tiled channel dict exactly matching the kernel's cleared-tile
    output (raster_pallas_gbuf.py::_kernel init), so a sparse-tile pass
    scattered over these defaults is bit-identical to the dense run."""
    from transmission_renderer_tpu.ops.raster_pallas_gbuf import (
        TILE_H,
        TILE_W,
        active_channels,
    )

    zero = jnp.zeros((n_tiles, TILE_H, TILE_W), jnp.float32)
    ch = {name: zero for name in active_channels(pos_derivs, uv_channels)}
    ch["tri"] = jnp.full((n_tiles, TILE_H, TILE_W), -1, jnp.int32)
    ch["material"] = jnp.zeros((n_tiles, TILE_H, TILE_W), jnp.int32)
    ch["depth"] = init_depth_tiles
    ch["nrm_z"] = zero + 1.0
    ch["scale"] = zero + 1.0
    return ch


def _scatter_tile_channels(ch: dict, ids: jnp.ndarray, sub: dict, n_tiles):
    """Scatter a tile-worklist's channels back over the dense tiled dict
    (empty slots target the pad row and are dropped)."""
    out = {}
    for name, dense in ch.items():
        padded = jnp.concatenate([dense, jnp.zeros_like(dense[:1])], axis=0)
        out[name] = padded.at[ids].set(sub[name], mode="drop")[:n_tiles]
    return out


def _rasterize_class_sparse(
    payload, tile_start, big_count, pass_class: int, cap: int,
    init_tiles: jnp.ndarray, config, w: int, h: int,
    max_depth_tiles: jnp.ndarray | None = None,
    pos_derivs: bool = True,
    uv_channels: bool = True,
    name: str = "raster_tiles",
):
    """Raster one draw class over ONLY the tiles holding records of that
    class. Exact while the active-tile count fits ``cap`` (overflowing
    tiles keep the cleared/default output — surfaced via
    FrameDiagnostics). Returns (dense tiled channel dict, active_count).
    Requires the big-record list to be empty (Pallas frame path: big
    triangles ride the class-keyed sorted stream)."""
    from transmission_renderer_tpu.ops.raster_pallas_gbuf import (
        TILE_H,
        TILE_W,
        rasterize_gbuffer_tiles,
    )

    tiles_x = -(-w // TILE_W)
    tiles_y = -(-h // TILE_H)
    n_tiles = tiles_x * tiles_y
    num_classes = (tile_start.shape[0] - 1) // n_tiles
    ids, count, pad_tile = _class_tile_worklist(
        tile_start, n_tiles, num_classes, pass_class, cap
    )
    safe_ids = jnp.where(ids >= n_tiles, pad_tile, ids)
    sub = rasterize_gbuffer_tiles(
        payload, safe_ids, tile_start, big_count, w, h,
        init_depth_tiles=init_tiles[safe_ids],
        max_depth_tiles=(
            max_depth_tiles[safe_ids] if max_depth_tiles is not None else None
        ),
        pass_class=pass_class, interpret=config.pallas_interpret,
        pos_derivs=pos_derivs, uv_channels=uv_channels, name=name,
    )
    ch = _scatter_tile_channels(
        _default_gbuf_channels(n_tiles, init_tiles, pos_derivs, uv_channels),
        ids, sub, n_tiles,
    )
    return ch, count, (ids, safe_ids, sub)


def _tile_cap(frac: float | None, n_tiles: int, floor: int) -> int:
    """Static sparse-raster tile cap: fraction of the grid with a floor
    (small frames quantise coverage upward and are cheap anyway). 0 =
    keep the dense path (also when the cap would cover the whole grid —
    sparse would only add scatter overhead)."""
    if frac is None:
        return 0
    cap = max(int(np.ceil(n_tiles * frac)), floor)
    return 0 if cap >= n_tiles else cap


def _rasterize_clip_peeled(
    scene: Scene, payload, bins, big_count, pass_class: int, base, config,
    w: int, h: int, pos_derivs: bool = True,
):
    """Rasterise an alpha-clip draw class through the Pallas kernel by
    depth PEELING: race ignoring alpha (seeded with the base pass's depth,
    preserving draw order, src/main.rs:1900-1944), alpha-test the winners
    densely, then re-race only the failing tiles with ``max_depth``
    excluding the rejected layer. Exact once the number of rejected layers
    above the true winner is under ``config.alpha_clip_rounds``; leftovers
    are invalidated (fall through to base) and counted in the returned
    diagnostic. Returns (merged GBuffer, unresolved-pixel count,
    active-tile count of the sparse first round — 0 when dense)."""
    from transmission_renderer_tpu.ops.raster import tile_image, untile_image
    from transmission_renderer_tpu.ops.raster_pallas_gbuf import (
        TILE_H,
        TILE_W,
        gbuffer_from_channels,
        rasterize_gbuffer_tiles,
    )

    tiles_x = -(-w // TILE_W)
    tiles_y = -(-h // TILE_H)
    n_tiles = tiles_x * tiles_y
    all_ids = jnp.arange(n_tiles, dtype=jnp.int32)
    init_tiles = tile_image(base.depth, TILE_W, TILE_H)
    cap_c = _tile_cap(
        config.clip_tile_cap_frac, n_tiles, config.sparse_raster_tile_floor
    )
    clip_tiles = jnp.int32(0)
    if cap_c:
        # sparse first round: raster + alpha-test only the tiles holding
        # records of this clip class (coverage is usually a small screen
        # fraction; inactive tiles keep the cleared output = base wins)
        ch, clip_tiles, (ids0, _safe0, sub0) = _rasterize_class_sparse(
            payload, bins.tile_start, big_count, pass_class, cap_c,
            init_tiles, config, w, h, pos_derivs=pos_derivs,
            name="raster_clip_peel",
        )
        ok_sub = _clip_alpha_ok_tiles(scene, sub0)
        ones = jnp.ones((n_tiles + 1, TILE_H, TILE_W), bool)
        ok = ones.at[ids0].set(ok_sub, mode="drop")[:n_tiles]
    else:
        ch = rasterize_gbuffer_tiles(
            payload, all_ids, bins.tile_start, big_count, w, h,
            init_depth_tiles=init_tiles, pass_class=pass_class,
            interpret=config.pallas_interpret, pos_derivs=pos_derivs,
            name="raster_clip_peel",
        )
        # ONE dense alpha test; later rounds only change the re-raced tile
        # subset, so the test (an atlas tap per pixel — the expensive part)
        # reruns on [cap] tiles and scatters back into ``ok``.
        ok = _clip_alpha_ok_tiles(scene, ch)
    # per-round re-race caps: a scalar frac applies to every round; a
    # tuple schedules SHRINKING caps (round r uses entry min(r-1, last)) —
    # failing-tile demand collapses after the first peels, so late rounds
    # can be near-free while early ones cover the full active-tile set
    fracs = config.clip_retile_cap_frac
    if not isinstance(fracs, (tuple, list)):
        fracs = (fracs,)
    caps = [
        max(int(np.ceil(n_tiles * f)), 1) for f in fracs
    ]
    nc_peel = (bins.tile_start.shape[0] - 1) // n_tiles
    peel_base = jnp.arange(n_tiles, dtype=jnp.int32) * nc_peel + pass_class
    peel_pad_tile = jnp.argmin(
        bins.tile_start[peel_base + 1] - bins.tile_start[peel_base]
    ).astype(jnp.int32)
    # The per-round channel state lives as ONE padded stacked array
    # [n_tiles + 1, C, TILE_H, TILE_W] (i32 channels bitcast to f32 —
    # pure data movement, exact): the rounds' full-size updates become a
    # single gather + a single scatter per round instead of one
    # concatenate + dynamic-update-slice per CHANNEL per round (the two
    # 1.6 ms `constant_dynamic-update-slice` fusions in the stress pass
    # table). Row n_tiles is the empty-slot write target, sliced off at
    # the end.
    names = sorted(ch)
    dtypes = {n: ch[n].dtype for n in names}
    ci = {n: i for i, n in enumerate(names)}

    def _to_f32(a):
        if a.dtype == jnp.int32:
            return jax.lax.bitcast_convert_type(a, jnp.float32)
        return a

    def _of(a, dtype):
        if dtype == jnp.int32:
            return jax.lax.bitcast_convert_type(a, jnp.int32)
        return a

    stk = jnp.stack([_to_f32(ch[n]) for n in names], axis=1)
    stk = jnp.concatenate([stk, jnp.zeros_like(stk[:1])], axis=0)
    ok_p = jnp.concatenate([ok, jnp.ones_like(ok[:1])], axis=0)
    round_demand, round_caps = [], []
    for rnd in range(1, max(config.alpha_clip_rounds, 1)):
        cap = caps[min(rnd - 1, len(caps) - 1)]
        round_caps.append(cap)
        with pass_scope(f"clip_round_{rnd}"):
            tri_full = _of(stk[:n_tiles, ci["tri"]], jnp.int32)
            failed = (tri_full >= 0) & ~ok_p[:n_tiles]
            ft = jnp.any(failed.reshape(n_tiles, -1), axis=1)
            round_demand.append(jnp.sum(ft.astype(jnp.int32)))
            pos = jnp.cumsum(ft.astype(jnp.int32)) - 1
            tgt = jnp.where(ft & (pos < cap), pos, cap)
            ids = (
                jnp.full((cap,), n_tiles, jnp.int32)
                .at[tgt]
                .set(all_ids, mode="drop")
            )
            # empty slots aim at the class's emptiest tile, not the last
            # one (whose record run every empty slot would re-walk)
            safe_ids = jnp.where(ids >= n_tiles, peel_pad_tile, ids)
            sub_stk = stk[safe_ids]
            sub_prev = {
                n: _of(sub_stk[:, ci[n]], dtypes[n]) for n in names
            }
            failed_sel = failed[safe_ids]
            maxd_sub = jnp.where(failed_sel, sub_prev["depth"], jnp.inf)
            new = rasterize_gbuffer_tiles(
                payload, safe_ids, bins.tile_start, big_count, w, h,
                init_depth_tiles=init_tiles[safe_ids],
                max_depth_tiles=maxd_sub, pass_class=pass_class,
                interpret=config.pallas_interpret, pos_derivs=pos_derivs,
                name=f"clip_round_{rnd}",
            )
            sub = {
                n: jnp.where(failed_sel, new[n], sub_prev[n])
                for n in names
            }
            merged_stk = jnp.stack([_to_f32(sub[n]) for n in names], axis=1)
            stk = stk.at[ids].set(merged_stk, mode="drop")
            ok_sub = _clip_alpha_ok_tiles(scene, sub)
            ok_p = ok_p.at[ids].set(ok_sub, mode="drop")
    ch = {n: _of(stk[:n_tiles, ci[n]], dtypes[n]) for n in names}
    ok = ok_p[:n_tiles]

    failed = (ch["tri"] >= 0) & ~ok
    unresolved = jnp.sum(failed.astype(jnp.int32))
    ch["tri"] = jnp.where(failed, -1, ch["tri"])

    def ut(a):
        return untile_image(a, tiles_x, tiles_y, TILE_W, TILE_H, w, h)

    g_clip = gbuffer_from_channels({k: ut(v) for k, v in ch.items()})
    return (
        _merge_gbuffers(base, g_clip), unresolved, clip_tiles,
        (tuple(round_demand), tuple(round_caps)),
    )


def _make_alpha_fn(
    scene: Scene, dl: DrawList, uvs_expanded: jnp.ndarray,
    width: int, height: int,
):
    """Alpha-clip coverage during rasterisation
    (depth_pre_pass_alpha_clip, shader/src/lib.rs:270-295): sample diffuse
    alpha at the interpolated uv with IMPLICIT LOD (the reference's
    ``texture_sampler.sample``) and kill below the cutoff. The uv
    derivatives come from the triangle's adjugate in the same closed
    forms the G-buffer kernel uses, so this path and the Pallas depth-peel
    path (render/frame.py::_clip_alpha_ok_tiles) test identical
    semantics."""
    from transmission_renderer_tpu.render.shading import _mip_lod
    from transmission_renderer_tpu.scene.textures import IMAGE_MASK

    m = scene.materials
    tri_mat = dl.tri_material
    is_clip_bucket = (dl.tri_bucket == BUCKET_ALPHA_CLIP) | (
        dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP
    )

    def alpha_fn(tri, b1, b2, nx, ny, adj):
        needs = is_clip_bucket[tri]
        mid = tri_mat[tri]
        tid = m.tex_diffuse[mid]
        packed = jnp.maximum(tid, 0)
        vidx = dl.tri_vtx[tri]  # [3]
        uv0 = uvs_expanded[vidx[0]]
        uv1 = uvs_expanded[vidx[1]]
        uv2 = uvs_expanded[vidx[2]]
        del b1, b2  # uv comes from the kernel-identical edge forms below
        # analytic uv derivatives: e_i = adj_i . (nx, ny, 1), D = sum e_i,
        # dA/dx = (sum(a_i A_i) D - sum(e_i A_i) sum(a_i)) / D^2 * 2/w
        e0 = adj[0, 0] * nx + adj[0, 1] * ny + adj[0, 2]
        e1 = adj[1, 0] * nx + adj[1, 1] * ny + adj[1, 2]
        e2 = adj[2, 0] * nx + adj[2, 1] * ny + adj[2, 2]
        d_sum = e0 + e1 + e2
        inv_d = 1.0 / d_sum
        a_sum = adj[0, 0] + adj[1, 0] + adj[2, 0]
        b_sum = adj[0, 1] + adj[1, 1] + adj[2, 1]
        inv_d2x = inv_d * inv_d * (2.0 / width)
        inv_d2y = inv_d * inv_d * (2.0 / height)
        n_uv = (
            e0[..., None] * uv0 + e1[..., None] * uv1 + e2[..., None] * uv2
        )
        uv = n_uv * inv_d[..., None]  # same op order as the G-buffer kernel
        na = adj[0, 0] * uv0 + adj[1, 0] * uv1 + adj[2, 0] * uv2
        nb = adj[0, 1] * uv0 + adj[1, 1] * uv1 + adj[2, 1] * uv2
        duv_dx = (na * d_sum[..., None] - n_uv * a_sum) * inv_d2x[..., None]
        duv_dy = (nb * d_sum[..., None] - n_uv * b_sum) * inv_d2y[..., None]
        rows = scene.atlas_meta[packed & IMAGE_MASK]
        lod = _mip_lod(duv_dx, duv_dy, rows[..., 2], rows[..., 3])
        sample = sample_texture(
            scene.atlas_texels,
            scene.atlas_meta,
            scene.atlas_srgb,
            packed,
            uv,
            lod,
            WRAP_REPEAT,
        )
        alpha = m.diffuse_factor[mid, 3] * jnp.where(
            tid >= 0, sample[..., 3], 1.0
        )
        keep = alpha >= m.alpha_clipping_cutoff[mid]
        return jnp.where(needs, keep, True)

    return alpha_fn


@f32_matmuls
def render_frame(
    scene: Scene,
    dl: DrawList,
    params: FrameParams,
    lights: Lights,
    config: RenderConfig,
    ggx_lut: jnp.ndarray | None = None,
    flags: SceneFlags | None = None,
    return_hdr: bool = False,
    bvh=None,  # ops.bvh.BVH | None — enables ray-traced shadows when
    # config.ray_traced_shadows is set (the --ray-tracing feature variant)
    return_diagnostics: bool = False,
):
    """Render one frame -> tonemapped linear [H, W, 3] in [0, 1].

    With ``return_diagnostics`` the result is (image, FrameDiagnostics);
    hosts should check ``diagnostics.overflowed()`` (see cli.py)."""
    w, h = config.width, config.height
    tw, th = config.tile_w, config.tile_h
    tiles_x, tiles_y = config.tiles_x, config.tiles_y

    if flags is None:
        flags = SceneFlags(has_alpha_clip=True, has_transmission=True)
    if ggx_lut is None:
        ggx_lut = jnp.asarray(default_ggx_lut(config.ggx_lut_size))

    # ---- 1. vertex transform (vertex_instanced, shader lib.rs:336-361) ----
    with pass_scope("geometry"):
        inst_t = Similarity(
            translation=scene.inst_transform.translation[dl.vtx_inst],
            scale=scene.inst_transform.scale[dl.vtx_inst],
            rotation=scene.inst_transform.rotation[dl.vtx_inst],
        )
        world_pos = similarity_apply(inst_t, scene.positions[dl.vtx_src])
        world_nrm = quat_rotate(inst_t.rotation, scene.normals[dl.vtx_src])
        uvs = scene.uvs[dl.vtx_src]
        pos_h = jnp.concatenate(
            [world_pos, jnp.ones_like(world_pos[:, :1])], -1
        )
        clip = pos_h @ params.proj_view.T

        # ---- frustum culling (shader lib.rs:412-469) ----------------------
        visible = cull_instances(
            scene, params.view, params.frustum_x_xz, params.frustum_y_yz,
            config.z_near,
        )
        tri_scale = scene.inst_transform.scale[dl.tri_inst]
    alpha_fn = (
        _make_alpha_fn(scene, dl, uvs, w, h) if flags.has_alpha_clip else None
    )

    # ---- ray-traced shadows setup (--ray-tracing variant) ------------------
    use_rt = config.ray_traced_shadows and bvh is not None
    if use_rt:
        from transmission_renderer_tpu.ops.bvh import refit_bvh
        from transmission_renderer_tpu.render.raytrace import shadow_factors

        # per-frame AABB refit, the TLAS UPDATE analogue
        # (src/acceleration_structures.rs:192-267, src/main.rs:1331-1351)
        bvh = refit_bvh(bvh, dl.tri_vtx, world_pos)

    # Rasteriser backend selection (see RenderConfig.use_pallas_raster)
    use_pallas = use_raster_kernel(config)
    mask_o = bucket_triangle_masks(
        dl.tri_inst, dl.tri_bucket, visible, (BUCKET_OPAQUE, BUCKET_ALPHA_CLIP)
    )
    if flags.has_transmission:
        mask_t = bucket_triangle_masks(
            dl.tri_inst, dl.tri_bucket, visible,
            (BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP),
        )

    # capacity diagnostics accumulated across every binning call this frame
    max_bin_count = jnp.int32(0)
    big_tri_demand = jnp.int32(0)
    mid_tri_demand = jnp.int32(0)
    tier_overflow = jnp.int32(0)
    pair_demand = jnp.int32(0)
    pair_capacity = 0
    clip_tiles = jnp.int32(0)
    transmission_tiles = jnp.int32(0)

    def _track_bins(bins):
        nonlocal max_bin_count, big_tri_demand
        max_bin_count = jnp.maximum(max_bin_count, bins.max_bin_count)
        big_tri_demand = jnp.maximum(
            big_tri_demand, bins.big_tri_count.astype(jnp.int32)
        )
        return bins

    def jax_raster_pass(setup, init_depth=None):
        bins = _track_bins(bin_triangles(
            setup, tiles_x, tiles_y, config.max_tiles_per_tri,
            config.max_tris_per_tile, config.max_big_tris,
        ))
        return rasterize(
            setup, bins, w, h, tw, th,
            alpha_coverage_fn=alpha_fn, init_depth=init_depth,
            static_trip_counts=config.static_raster_trips,
        )

    # Pallas scenes all ride the fused G-buffer kernel: ONE shared setup
    # + class-split binning sort; alpha-clip classes resolve via depth
    # peeling (_rasterize_clip_peeled), so no hybrid JAX raster and no
    # bin caps remain in the hot path.
    use_gbuf_kernel = use_pallas
    clip_unresolved = jnp.int32(0)
    clip_rounds = None  # (per-round failing-tile demand, per-round caps)
    if use_pallas:
        from transmission_renderer_tpu.ops.raster_pallas_gbuf import (
            gather_gbuf_payload,
            pack_gbuf_payload,
            rasterize_gbuffer_pallas,
        )

        is_transmissive_tri = (dl.tri_bucket == BUCKET_TRANSMISSION) | (
            dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP
        )
        is_clip_tri = (dl.tri_bucket == BUCKET_ALPHA_CLIP) | (
            dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP
        )
        # draw classes (reference buckets, model_loading.rs:68-78):
        # 0 opaque, 1 transmission, 2 alpha-clip, 3 transmission-clip
        tri_class = is_transmissive_tri.astype(jnp.int32) + 2 * is_clip_tri.astype(jnp.int32)
        num_classes = 4 if flags.has_alpha_clip else 2
        mask_all = mask_o | mask_t if flags.has_transmission else mask_o
        with pass_scope("binning"):
            setup_all = setup_triangles(
                clip, dl.tri_vtx, mask_all, w, h, tw, th
            )
            bins_all = bin_triangles(
                setup_all, tiles_x, tiles_y, config.pallas_tiles_per_tri,
                config.max_tris_per_tile, config.pallas_max_big_tris,
                materialize=False, class_flags=tri_class,
                num_classes=num_classes,
                mid_tile_cap=config.pallas_mid_tile_cap,
                max_mid_tris=config.pallas_max_mid_tris,
                tiers=config.pallas_tiers,
                pair_cap_frac=config.pallas_pair_cap_frac,
            )
            # the Pallas tile lists are uncapped (they read tile_start),
            # but the demotion tier rungs are static buffers — track the
            # worst rung's demand overflow (> 0 means dropped draws)
            for demand, slots in zip(
                bins_all.tier_demands, bins_all.tier_slots
            ):
                tier_overflow = jnp.maximum(tier_overflow, demand - slots)
            big_tri_demand = jnp.maximum(
                big_tri_demand, bins_all.big_tri_count.astype(jnp.int32)
            )
            mid_tri_demand = jnp.maximum(
                mid_tri_demand, bins_all.mid_tri_count
            )
            pair_demand = bins_all.pair_demand
            pair_capacity = bins_all.pair_capacity
        with pass_scope("payload"):
            records = pack_gbuf_payload(
                setup_all, dl.tri_vtx, dl.tri_material, tri_scale,
                world_pos, world_nrm, uvs, tri_class,
            )
            gpayload = gather_gbuf_payload(records, bins_all)
        # big tris ride the sorted stream on the Pallas path (raster.py)
        big_cnt = jnp.zeros((), jnp.int32)

        # ---- 2. opaque raster + G-buffer in one kernel ---------------------
        # position-derivative channels are only read by normal mapping,
        # uv(+derivative) channels only by texture taps; skip each
        # statically when no material in the pass reads them (the clip
        # peel always keeps uv for its coverage test)
        pos_derivs_o = flags.tex_slots[2]
        pos_derivs_t = flags.tex_slots_transmission[2]

        # slot 4 (occlusion) is loaded but never sampled (the reference
        # also ignores it, shading._MAT_SLOTS) — an occlusion-only scene
        # must not force the uv channels on
        def _sampled(slots):
            return any(s for i, s in enumerate(slots) if i != 4)

        uv_o = _sampled(flags.tex_slots) or flags.has_alpha_clip
        uv_t = _sampled(flags.tex_slots_transmission) or flags.has_alpha_clip
        with pass_scope("raster_opaque"):
            g_o = rasterize_gbuffer_pallas(
                records, bins_all, w, h, pass_class=0, payload=gpayload,
                interpret=config.pallas_interpret, pos_derivs=pos_derivs_o,
                uv_channels=uv_o, name="raster_opaque",
            )
        if flags.has_alpha_clip:
            with pass_scope("raster_clip_peel"):
                g_o, miss, ct, clip_rounds = _rasterize_clip_peeled(
                    scene, gpayload, bins_all, big_cnt, 2, g_o, config, w, h,
                    pos_derivs=pos_derivs_o,
                )
            clip_unresolved = clip_unresolved + miss
            clip_tiles = jnp.maximum(clip_tiles, ct)
    else:
        # ---- 2. opaque + alpha-clip raster (pure-JAX path) ------------------
        # (setup, binning and interpolation included: the pass table
        # compares this scope with the kernel path's binning + payload +
        # raster scopes)
        with pass_scope("raster_opaque"):
            setup_o = setup_triangles(clip, dl.tri_vtx, mask_o, w, h, tw, th)
            vis_o = jax_raster_pass(setup_o)
            g_o = interpolate_gbuffer(
                vis_o, setup_o, dl.tri_vtx, dl.tri_material, tri_scale,
                world_pos, world_nrm, uvs, w, h,
            )

    # ---- 3. clustered lighting -------------------------------------------
    # coefficients + cluster AABBs are projection-static: cached per
    # config and baked into the trace as constants (_static_cluster_data)
    coeffs, aabb_min, aabb_max = _static_cluster_data(config)
    with pass_scope("clustering"):
        lp_h = jnp.concatenate(
            [lights.position, jnp.ones_like(lights.position[:, :1])], -1
        )
        light_pos_view = (lp_h @ params.view.T)[:, :3]
        spot_dir_view = lights.spot_direction @ params.view[:3, :3].T
        counts, indices = assign_lights_to_clusters(
            aabb_min, aabb_max, light_pos_view, lights.falloff_distance_sq,
            lights.is_a_spotlight(), spot_dir_view, lights.spot_outer_angle,
            config.max_lights_per_cluster,
        )

    # scene-static shade precomputations, shared by both shade passes (and
    # constant-folded at trace time when their inputs are concrete)
    from transmission_renderer_tpu.ops.texture import quad_lut_2ch
    from transmission_renderer_tpu.render.shading import build_material_matrix

    mat_matrix_o = build_material_matrix(
        scene, flags.tex_slots, flags.slot_bundles
    )
    lut_quads = quad_lut_2ch(ggx_lut)

    ctx = ShadeContext(
        view_position=params.view_position,
        proj_view=params.proj_view,
        sun_dir=params.sun_dir,
        sun_intensity=params.sun_intensity,
        framebuffer_size=(w, h),
        cluster_size_in_pixels=config.cluster_size_in_pixels,
        num_clusters_xy=(config.num_clusters_x, config.num_clusters_y),
        cluster_coeffs=coeffs,
        cluster_light_counts=counts,
        cluster_light_indices=indices,
        lights=lights,
        ggx_lut=ggx_lut,
        debug_clusters=config.debug_clusters,
        tex_slots=flags.tex_slots,
        half_res_refraction=config.half_res_refraction,
        quad_taps=config.quad_material_taps,
        mat_matrix=mat_matrix_o,
        ggx_lut_quads=lut_quads,
        fused_trilinear=flags.atlas_pot and _tx.ATLAS_FUSED,
        bf16_lights=config.bf16_light_math,
    )

    # ---- 4. opaque shade ---------------------------------------------------
    if use_rt:
        # Cluster-gate the light shadow rays: (pixel, light) pairs
        # outside the pixel's cluster list never have their factor read
        # by the shading loop, so their rays die at t_max = 0 (and the
        # traversal's compaction packs them into all-done chunks). Image
        # bit-identical; ray count drops to sun + cluster-active pairs.
        def _light_mask(c, g, px, py):
            if lights.num == 0:
                return None
            return cluster_light_mask(c, g.depth, px, py)

        if config.half_res_shadow_rays and (h % 2 or w % 2):
            import warnings

            warnings.warn(
                f"half_res_shadow_rays requires even framebuffer dims; "
                f"{w}x{h} traces FULL-res shadow rays",
                stacklevel=2,
            )
        with pass_scope("shadow_rays_opaque"):
            if config.half_res_shadow_rays and h % 2 == 0 and w % 2 == 0:
                # opt-in quality flag (RenderConfig.half_res_shadow_rays):
                # trace on the half-res grid, bilinearly upsample the
                # visibility factors. NO cluster/N·L gating here: the
                # upsample BLENDS factors across pixels, so a factor
                # gated as "never read" at its own pixel IS read by its
                # full-res neighbours (a gated 1.0 would leak light
                # across cluster boundaries).
                import jax as _jax

                g_half = _jax.tree_util.tree_map(
                    lambda a: a[::2, ::2], g_o
                )
                sun_h, light_h = shadow_factors(
                    bvh, dl.tri_vtx, world_pos, g_half, params.sun_dir,
                    lights,
                )
                sun_f = _up2(_up2(sun_h, 0), 1)
                light_f = _up2(_up2(light_h, 0), 1)
            else:
                px_d = jnp.broadcast_to(
                    jnp.arange(w, dtype=jnp.int32)[None, :], (h, w)
                )
                py_d = jnp.broadcast_to(
                    jnp.arange(h, dtype=jnp.int32)[:, None], (h, w)
                )
                sun_f, light_f = shadow_factors(
                    bvh, dl.tri_vtx, world_pos, g_o, params.sun_dir, lights,
                    light_active=_light_mask(ctx, g_o, px_d, py_d),
                    # N·L ray gating is only valid without normal maps
                    # (slot 2): the shade's N·L uses the perturbed normal
                    nol_gate=config.nol_shadow_gate
                    and not flags.tex_slots[2],
                )
        ctx = ctx._replace(sun_shadow_factor=sun_f, light_shadow_factors=light_f)

    nb = num_blocks(h, w)
    cap_o = (
        min(int(np.ceil(nb * config.opaque_block_cap_frac)), nb)
        if config.opaque_block_cap_frac is not None
        else 0
    )
    opaque_blocks = jnp.int32(0)
    with pass_scope("shade_opaque"):
        if cap_o:
            # block-sparse opaque shade: only blocks with coverage pay
            # their gathers (render/sparse.py)
            wk_o = compact_blocks(g_o.valid, cap_o)
            opaque_blocks = wk_o.count
            g_of = _gather_gbuffer(wk_o, g_o)
            ctx_f = ctx
            if ctx.sun_shadow_factor is not None:
                ctx_f = ctx_f._replace(
                    sun_shadow_factor=block_gather(wk_o, ctx.sun_shadow_factor)
                )
            if ctx.light_shadow_factors is not None:
                ctx_f = ctx_f._replace(
                    light_shadow_factors=block_gather(
                        wk_o, ctx.light_shadow_factors
                    )
                )
            px, py = pixel_coords(wk_o)
            hdr_flat = shade_opaque_flat(scene, g_of, ctx_f, px, py,
                                         return_planes=True)
            # HDR stays PLANAR ((r, g, b) [H, W] planes) through the
            # pyramid/merge/tonemap back half
            hdr_planes = tuple(
                block_scatter(wk_o, p, jnp.zeros((h, w), jnp.float32))
                for p in hdr_flat
            )
        else:
            hdr_d = shade_opaque(scene, g_o, ctx)
            hdr_planes = tuple(hdr_d[..., c] for c in range(3))

    transmission_blocks = jnp.int32(0)
    cap_t = 0
    cap_rt = 0
    if flags.has_transmission:
        # ---- 5. opaque mip pyramid ----------------------------------------
        # static level restriction: with untextured transmissive roughness
        # the refraction fetch only ever touches a few levels — restrict
        # the BUILD to them too (the level-0 phase copies alone are
        # ~100 MB of writes, and every skipped level drops 4+ fusions)
        from transmission_renderer_tpu.scene.textures import (
            mip_levels_for_size,
        )

        level_set = refraction_level_set(flags, w, mip_levels_for_size(w, h))
        with pass_scope("mip_pyramid"):
            pyramid = build_pyramid(hdr_planes, level_set=level_set)

        # ---- 6-7. transmissive raster + shade ------------------------------
        fused_sparse = False
        if use_gbuf_kernel:
            from transmission_renderer_tpu.ops.raster import (
                tile_image,
                untile_image,
            )
            from transmission_renderer_tpu.ops.raster_pallas_gbuf import (
                TILE_H,
                TILE_W,
                gbuffer_from_channels,
            )

            n_tiles = tiles_x * tiles_y
            cap_rt = _tile_cap(
                config.transmission_tile_cap_frac, n_tiles,
                config.sparse_raster_tile_floor,
            )
            # FUSED sparse raster -> sparse shade: at w % 128 == 0 every
            # 8-px tile row IS one flat 128-px shading block, so the
            # kernel's [cap, 8, 128] channels feed the block-sparse
            # transmission shade directly — no dense G-buffer
            # materialisation, no compaction scan, no per-channel block
            # gathers (measured ~6 ms of pure overhead at 1080p).
            fused_sparse = bool(
                cap_rt
                and not flags.has_alpha_clip
                and not config.half_res_refraction
                and w % TILE_W == 0
            )
            if fused_sparse:
                from transmission_renderer_tpu.ops.raster_pallas_gbuf import (
                    rasterize_gbuffer_tiles,
                )
                from transmission_renderer_tpu.render.sparse import (
                    BLOCK,
                    BlockWork,
                )
                import jax as _jax

                init_tiles = tile_image(g_o.depth, TILE_W, TILE_H)
                nc = (bins_all.tile_start.shape[0] - 1) // n_tiles
                ids_t, t_count, pad_t = _class_tile_worklist(
                    bins_all.tile_start, n_tiles, nc, 1, cap_rt
                )
                transmission_tiles = t_count
                safe_t = jnp.where(ids_t >= n_tiles, pad_t, ids_t)
                with pass_scope("raster_transmission"):
                    sub_t = rasterize_gbuffer_tiles(
                        gpayload, safe_t, bins_all.tile_start, big_cnt, w, h,
                        init_depth_tiles=init_tiles[safe_t], pass_class=1,
                        interpret=config.pallas_interpret,
                        pos_derivs=pos_derivs_t, uv_channels=uv_t,
                        name="raster_transmission",
                    )
                g_tf = _jax.tree_util.tree_map(
                    lambda a: a.reshape(
                        (cap_rt * TILE_H * TILE_W,) + a.shape[3:]
                    ),
                    gbuffer_from_channels(sub_t),
                )
                # tile rows -> flat block ids (pad row when the slot is
                # empty or the row is past the frame bottom)
                bpr = w // BLOCK
                r8 = jnp.arange(TILE_H, dtype=jnp.int32)
                prow = (ids_t // tiles_x)[:, None] * TILE_H + r8[None, :]
                ok_b = (ids_t[:, None] < n_tiles) & (prow < h)
                bids = jnp.where(
                    ok_b, prow * bpr + (ids_t % tiles_x)[:, None], nb
                ).reshape(-1)
                wk_t = BlockWork(
                    block_ids=bids, count=t_count * TILE_H, n_blocks=nb,
                    cap_b=cap_rt * TILE_H, shape=(h, w),
                )
            elif cap_rt:
                # sparse-tile transmission raster: only tiles holding
                # class-1 records run the kernel (transmissive coverage
                # is a small screen fraction — see config)
                init_tiles = tile_image(g_o.depth, TILE_W, TILE_H)
                with pass_scope("raster_transmission"):
                    ch_t, transmission_tiles, _ = _rasterize_class_sparse(
                        gpayload, bins_all.tile_start, big_cnt, 1, cap_rt,
                        init_tiles, config, w, h, pos_derivs=pos_derivs_t,
                        uv_channels=uv_t, name="raster_transmission",
                    )
                g_t = gbuffer_from_channels({
                    name: untile_image(a, tiles_x, tiles_y, TILE_W, TILE_H,
                                       w, h)
                    for name, a in ch_t.items()
                })
            else:
                g_t = rasterize_gbuffer_pallas(
                    records, bins_all, w, h, pass_class=1, payload=gpayload,
                    init_depth=g_o.depth, interpret=config.pallas_interpret,
                    pos_derivs=pos_derivs_t, uv_channels=uv_t,
                    name="raster_transmission",
                )
            if flags.has_alpha_clip:
                g_t, miss, ct, clip_rounds_t = _rasterize_clip_peeled(
                    scene, gpayload, bins_all, big_cnt, 3, g_t, config, w, h,
                    pos_derivs=pos_derivs_t,
                )
                clip_unresolved = clip_unresolved + miss
                clip_tiles = jnp.maximum(clip_tiles, ct)
                if clip_rounds is not None:
                    clip_rounds = (
                        tuple(
                            jnp.maximum(a, b) for a, b in zip(
                                clip_rounds[0], clip_rounds_t[0]
                            )
                        ),
                        clip_rounds[1],
                    )
                else:
                    clip_rounds = clip_rounds_t
        else:
            with pass_scope("raster_transmission"):
                setup_t = setup_triangles(
                    clip, dl.tri_vtx, mask_t, w, h, tw, th
                )
                vis_t = jax_raster_pass(setup_t, init_depth=vis_o.depth)
                g_t = interpolate_gbuffer(
                    vis_t, setup_t, dl.tri_vtx, dl.tri_material, tri_scale,
                    world_pos, world_nrm, uvs, w, h,
                )
        ctx_t = ctx._replace(
            tex_slots=flags.tex_slots_transmission,
            mat_matrix=build_material_matrix(
                scene, flags.tex_slots_transmission, flags.slot_bundles
            ),
        )
        # fractional cap with a 256-block floor: at small frames the flat
        # 128-px blocks quantise coverage upward (a block spans several
        # rows of a 320-px frame), so a pure fraction overflows on scenes
        # that fit comfortably at 1080p — and small frames are cheap to
        # shade anyway
        cap_t = (
            min(
                max(int(np.ceil(nb * config.transmission_block_cap_frac)),
                    256),
                nb,
            )
            if config.transmission_block_cap_frac is not None
            and not config.half_res_refraction  # half-res needs the 2D grid
            and not fused_sparse  # worklist comes from the raster tiles
            else 0
        )
        with pass_scope("shade_transmission"):
            if fused_sparse:
                transmission_blocks = wk_t.count
                cap_t = wk_t.cap_b
                ctx_tf = ctx_t
                px_t, py_t = pixel_coords(wk_t)
                if use_rt:
                    with pass_scope("shadow_rays_transmission"):
                        sun_f_t, light_f_t = shadow_factors(
                            bvh, dl.tri_vtx, world_pos, g_tf,
                            params.sun_dir, lights,
                            light_active=_light_mask(ctx_t, g_tf, px_t, py_t),
                        )
                    ctx_tf = ctx_tf._replace(
                        sun_shadow_factor=sun_f_t,
                        light_shadow_factors=light_f_t,
                    )
                hdr_t_flat = shade_transmission_flat(
                    scene, g_tf, ctx_tf, pyramid, px_t, py_t,
                    pyramid_level_set=level_set,
                )
                hdr_planes = tuple(
                    block_scatter(
                        wk_t,
                        jnp.where(
                            g_tf.valid, hdr_t_flat[:, c],
                            block_gather(wk_t, hp),
                        ),
                        hp,
                    )
                    for c, hp in enumerate(hdr_planes)
                )
            elif cap_t:
                wk_t = compact_blocks(g_t.valid, cap_t)
                transmission_blocks = wk_t.count
                g_tf = _gather_gbuffer(wk_t, g_t)
                ctx_tf = ctx_t
                px_t, py_t = pixel_coords(wk_t)
                if use_rt:
                    # trace shadow rays for the WORKLIST pixels only
                    # (the flat g-buffer; its valid mask zeroes t_max on
                    # empty lanes) — transmissive coverage is a small
                    # screen fraction, so this cuts the pass's ray count
                    # ~4x vs a dense [H, W] trace with no image change
                    with pass_scope("shadow_rays_transmission"):
                        sun_f_t, light_f_t = shadow_factors(
                            bvh, dl.tri_vtx, world_pos, g_tf,
                            params.sun_dir, lights,
                            light_active=_light_mask(ctx_t, g_tf, px_t, py_t),
                        )
                    ctx_tf = ctx_tf._replace(
                        sun_shadow_factor=sun_f_t,
                        light_shadow_factors=light_f_t,
                    )
                hdr_t_flat = shade_transmission_flat(
                    scene, g_tf, ctx_tf, pyramid, px_t, py_t,
                    pyramid_level_set=level_set,
                )
                # transmission replaces covered pixels (the reference's
                # blend-disabled transmission pipeline)
                hdr_planes = tuple(
                    block_scatter(
                        wk_t,
                        jnp.where(
                            g_tf.valid, hdr_t_flat[:, c],
                            block_gather(wk_t, hp),
                        ),
                        hp,
                    )
                    for c, hp in enumerate(hdr_planes)
                )
            else:
                if use_rt:
                    px_td = jnp.broadcast_to(
                        jnp.arange(w, dtype=jnp.int32)[None, :], (h, w)
                    )
                    py_td = jnp.broadcast_to(
                        jnp.arange(h, dtype=jnp.int32)[:, None], (h, w)
                    )
                    with pass_scope("shadow_rays_transmission"):
                        sun_f_t, light_f_t = shadow_factors(
                            bvh, dl.tri_vtx, world_pos, g_t,
                            params.sun_dir, lights,
                            light_active=_light_mask(ctx_t, g_t, px_td, py_td),
                        )
                    ctx_t = ctx_t._replace(
                        sun_shadow_factor=sun_f_t,
                        light_shadow_factors=light_f_t,
                    )
                hdr_t = shade_transmission(
                    scene, g_t, ctx_t, pyramid, pyramid_level_set=level_set
                )
                hdr_planes = tuple(
                    jnp.where(g_t.valid, hdr_t[..., c], hp)
                    for c, hp in enumerate(hdr_planes)
                )

    # ---- 8. tonemap ---------------------------------------------------------
    with pass_scope("tonemap"):
        ldr = jnp.stack(
            lottes_tonemap_planes(hdr_planes, bake_lottes_params()), axis=-1
        )
    if return_diagnostics:
        cap_clip = (
            _tile_cap(config.clip_tile_cap_frac, tiles_x * tiles_y,
                      config.sparse_raster_tile_floor)
            if (use_pallas and flags.has_alpha_clip)
            else 0
        )
        diags = FrameDiagnostics(
            max_bin_count=max_bin_count,
            bin_capacity=config.max_tris_per_tile,
            big_tri_count=big_tri_demand,
            big_tri_capacity=(
                config.pallas_tiers[-1][1]
                if use_pallas
                else config.max_big_tris
            ),
            opaque_blocks=opaque_blocks,
            opaque_block_capacity=cap_o,
            transmission_blocks=transmission_blocks,
            transmission_block_capacity=cap_t,
            clip_unresolved=clip_unresolved,
            mid_tri_count=mid_tri_demand,
            mid_tri_capacity=config.pallas_max_mid_tris if use_pallas else 0,
            transmission_tiles=transmission_tiles,
            transmission_tile_capacity=cap_rt,
            clip_tiles=clip_tiles,
            clip_tile_capacity=cap_clip,
            tier_overflow=tier_overflow,
            clip_round_demand=clip_rounds[0] if clip_rounds else (),
            clip_round_caps=clip_rounds[1] if clip_rounds else (),
            pair_demand=pair_demand,
            pair_capacity=pair_capacity,
        )
        if return_hdr:
            return ldr, jnp.stack(hdr_planes, axis=-1), diags
        return ldr, diags
    if return_hdr:
        return ldr, jnp.stack(hdr_planes, axis=-1)
    return ldr

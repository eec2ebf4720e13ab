"""Deferred shading passes — the fragment-shader equivalents.

``shade_opaque`` reproduces ``fragment`` (shader/src/lib.rs:164-249);
``shade_transmission`` reproduces ``fragment_transmission``
(shader/src/lib.rs:37-162).

Shading operates on FLAT pixel worklists ([M] arrays + explicit pixel
coords) so the same code serves the dense [H, W] passes and the
block-sparse worklists (render/sparse.py). Per-pixel fetch strategy
(whether the one-hot matmul beats a plain row gather on the GPU is not
measured yet — ROADMAP D2):

  * material factors + texture ids + per-slot texture metadata are fused
    into ONE per-material f32 matrix and fetched with a single one-hot
    matmul (exact: weights are 0/1 and accumulation over disjoint parts
    is lossless at HIGHEST precision),
  * per-slot light columns in the clustered loop are fused the same way,
  * only the texel taps themselves (atlas quad-block rows) and the
    cluster table rows remain true gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from transmission_renderer_tpu.ops.mipchain import MipPyramid, sample_pyramid_lod
from transmission_renderer_tpu.ops.texture import (
    WRAP_REPEAT,
    atlas_classes,
    atlas_layers,
    quad_lut_2ch,
    sample_bundle_rows,
    sample_lut_2ch_quad,
    select_layer,
)
from transmission_renderer_tpu.scene.textures import IMAGE_MASK, LAYER_SHIFT
from transmission_renderer_tpu.pbr import (
    ClusterCoefficients,
    MaterialParams,
    basic_brdf,
    get_depth_slice,
    ibl_volume_refraction,
    light_direction_and_attenuation,
    material_invariants,
    spotlight_factor,
    transmission_btdf,
)
from transmission_renderer_tpu.pbr.lights import Lights
from transmission_renderer_tpu.render.gbuffer import GBuffer
from transmission_renderer_tpu.scene.textures import MAX_MIPS
from transmission_renderer_tpu.scene.types import Scene
from transmission_renderer_tpu.utils.profiling import pass_scope


class ShadeContext(NamedTuple):
    """Per-frame shading uniforms (the reference's PushConstants + Uniforms,
    shared-structs/src/lib.rs:11-29)."""

    view_position: jnp.ndarray  # [3]
    proj_view: jnp.ndarray  # [4, 4]
    sun_dir: jnp.ndarray  # [3]
    sun_intensity: jnp.ndarray  # [3]
    framebuffer_size: tuple[int, int]  # static (W, H)
    cluster_size_in_pixels: tuple[float, float]
    num_clusters_xy: tuple[int, int]
    cluster_coeffs: ClusterCoefficients
    cluster_light_counts: jnp.ndarray  # [C] uint32
    cluster_light_indices: jnp.ndarray  # [C, K] uint32
    lights: Lights
    ggx_lut: jnp.ndarray  # [S, S, 2]
    debug_clusters: bool = False
    # static per-slot texture gating (see SceneFlags.tex_slots); order:
    # diffuse, metallic_roughness, normal_map, emissive, occlusion,
    # transmission, thickness, specular, specular_colour
    tex_slots: tuple = (True,) * 9
    # half-res framebuffer fetch in the transmission pass (see
    # RenderConfig.half_res_refraction) — dense path only
    half_res_refraction: bool = False
    # share one material-texture tap per 2x2 pixel quad (see
    # RenderConfig.quad_material_taps) — dense opaque path only
    quad_taps: bool = False
    # shadow factors per pixel per light come from the ray-traced path
    # (None -> factor 1.0, the non-RayQuery variant); flat [M] / [M, L]
    sun_shadow_factor: jnp.ndarray | None = None
    light_shadow_factors: jnp.ndarray | None = None
    # scene-static precomputations, built once per frame (or trace-time
    # constants when their inputs are concrete) and shared by every pass:
    # the fused material matrix matching ``tex_slots`` and the quad-block
    # GGX LUT (render_frame hoists both; None -> built on demand)
    mat_matrix: "MaterialMatrix | None" = None
    ggx_lut_quads: jnp.ndarray | None = None
    # single-gather fused trilinear material taps (POT atlases only —
    # SceneFlags.atlas_pot; see ops/texture.py::sample_bundle_rows)
    fused_trilinear: bool = False
    # per-light BRDF/BTDF cores in bfloat16, f32 accumulation (see
    # RenderConfig.bf16_light_math)
    bf16_lights: bool = False


def onehot_rows(table: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """[n, C] f32 table, [M] int32 ids -> [M, C] rows via one-hot matmul.

    Exact for finite table values: the one-hot weights are 0/1, so each
    output element is v*1 + 0*... accumulated losslessly (HIGHEST
    precision splits v into disjoint bf16 parts that re-sum exactly).
    Callers must keep inf/NaN out of the table (0 * inf = NaN would
    poison every row).
    """
    n = table.shape[0]
    oh = (ids[:, None] == jnp.arange(n, dtype=ids.dtype)[None, :]).astype(
        jnp.float32
    )
    return jax.lax.dot_general(
        oh, table, (((1,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST
    )


def _mip_lod(duv_dx, duv_dy, tex_w, tex_h):
    """Vulkan-style implicit LOD: log2 of the max screen-space texel
    footprint (the trilinear sampler behaviour the reference gets from
    hardware)."""
    size = jnp.stack([tex_w, tex_h], -1).astype(jnp.float32)
    fx = duv_dx * size
    fy = duv_dy * size
    rho = jnp.maximum(
        jnp.sum(fx * fx, axis=-1), jnp.sum(fy * fy, axis=-1)
    )
    return 0.5 * jnp.log2(jnp.maximum(rho, 1e-12))


# Texture slots that participate in the fused material matrix, in imat
# order (occlusion is loaded but not applied, matching the reference).
_MAT_SLOTS = (
    "tex_diffuse", "tex_metallic_roughness", "tex_normal_map",
    "tex_emissive", "tex_transmission", "tex_thickness",
    "tex_specular", "tex_specular_colour",
)
# tex_slots tuple positions for each _MAT_SLOTS entry
_SLOT_FLAG_POS = (0, 1, 2, 3, 5, 6, 7, 8)
# num_mips, srgb, w0, h0, off_hi*13, off_lo*13, layers
_META_BLOCK = 5 + 2 * MAX_MIPS
_META_W = 5 + MAX_MIPS  # true meta columns (the atlas meta's trailing
# columns are the layer-class tag, ops/texture.py::atlas_classes)


class MaterialMatrix(NamedTuple):
    """The fused per-material fetch table + its column layout."""

    table: jnp.ndarray  # [n_mat, C] f32, inf-free
    meta_col: dict  # slot name -> column start of its meta block (or None)


def build_material_matrix(
    scene: Scene, tex_slots: tuple, slot_bundles: tuple = (),
) -> MaterialMatrix:
    """Fuse material factors, texture ids, and per-slot texture metadata
    into one f32 matrix (trace-time work over [n_materials] arrays).

    Layout: [0:21] factors (the attenuation-infinity flag is col 20,
    see below), [21:29] texture ids, then from col 29 one
    30-col metadata block per *used* sampled slot GROUP.
    attenuation_distance's infinity default (src/model_loading.rs:318) is
    encoded as (finite value, is_inf flag) to keep the table inf-free;
    atlas block offsets are split into 12-bit halves so they survive the
    f32 matmul exactly for atlases beyond 2^24 blocks.

    ``slot_bundles`` (SceneFlags.slot_bundles) lists groups of slot names
    guaranteed to reference one bundle image per material: such groups
    SHARE a metadata block (same column for every member), which makes
    their taps in ``evaluate_pixel_material`` structurally identical —
    ONE bundle gather serves the whole group; each slot extracts its
    layer in registers. Texture-id columns carry packed
    (image | layer << 16) refs (scene/textures.py::texture_ref).
    """
    m = scene.materials
    f32col = lambda x: x[:, None].astype(jnp.float32)
    att = m.attenuation_distance
    att_isinf = jnp.isinf(att)
    att_safe = jnp.where(att_isinf, 0.0, att)
    cols = [
        f32col(m.metallic_factor),          # 0
        f32col(m.roughness_factor),         # 1
        m.diffuse_factor,                   # 2:6
        m.emissive_factor,                  # 6:9
        f32col(m.index_of_refraction),      # 9
        f32col(m.transmission_factor),      # 10
        f32col(m.thickness_factor),         # 11
        f32col(att_safe),                   # 12
        m.attenuation_colour,               # 13:16
        f32col(m.specular_factor),          # 16
        m.specular_colour_factor,           # 17:20
        f32col(att_isinf),                  # 20 (att_distance is +inf flag)
    ]
    tids = [getattr(m, name) for name in _MAT_SLOTS]
    cols.append(jnp.stack(tids, axis=1).astype(jnp.float32))  # 21:29

    group_of = {name: (name,) for name in _MAT_SLOTS}
    for group in slot_bundles:
        for name in group:
            group_of[name] = tuple(group)

    meta_col = {}
    c = 29
    for name, flag_pos in zip(_MAT_SLOTS, _SLOT_FLAG_POS):
        if not tex_slots[flag_pos]:
            meta_col[name] = None
            continue
        if name in meta_col:
            continue  # group-mate already laid this block down
        group = group_of[name]
        # the group's per-material image: every used member references the
        # same bundle (finish_bundle/scene_flags verified this), so the
        # elementwise max over member refs picks it
        tid = getattr(m, name)
        for other in group:
            tid = jnp.maximum(tid, getattr(m, other))
        img = jnp.maximum(tid, 0) & IMAGE_MASK
        rows = scene.atlas_meta[img][:, :_META_W].astype(jnp.int32)
        head = rows[:, :4].astype(jnp.float32)
        offs = rows[:, 4 : 4 + MAX_MIPS]
        off_hi = (offs >> 12).astype(jnp.float32)
        off_lo = (offs & 0xFFF).astype(jnp.float32)
        layers_col = rows[:, 4 + MAX_MIPS :].astype(jnp.float32)
        cols.append(
            jnp.concatenate([head, off_hi, off_lo, layers_col], axis=1)
        )
        for member in group:
            if member in _MAT_SLOTS:
                meta_col[member] = c
        c += _META_BLOCK
    return MaterialMatrix(table=jnp.concatenate(cols, axis=1), meta_col=meta_col)


def _meta_rows_from(mrow: jnp.ndarray, col: int) -> jnp.ndarray:
    """Decode a meta block back to int32 [..., META_COLS] rows in the
    atlas META layout (num_mips, srgb, w0, h0, quad offsets, layers)."""
    head = mrow[..., col : col + 4].astype(jnp.int32)
    hi = mrow[..., col + 4 : col + 4 + MAX_MIPS].astype(jnp.int32)
    lo = mrow[..., col + 4 + MAX_MIPS : col + 4 + 2 * MAX_MIPS].astype(jnp.int32)
    layers = mrow[..., col + 4 + 2 * MAX_MIPS : col + _META_BLOCK].astype(
        jnp.int32
    )
    return jnp.concatenate([head, (hi << 12) | lo, layers], axis=-1)


class PixelMaterial(NamedTuple):
    params: MaterialParams
    diffuse_alpha: jnp.ndarray
    emission: jnp.ndarray
    transmission_factor: jnp.ndarray
    thickness: jnp.ndarray
    attenuation_distance: jnp.ndarray
    attenuation_colour: jnp.ndarray
    normal: jnp.ndarray  # shading normal after normal mapping


def evaluate_pixel_material(*args, **kw):
    """pass_scope'd wrapper — per-pass material-tap time shows up as
    'material_taps' in the in-frame table (tools/pass_timing.py)."""
    with pass_scope("material_taps"):
        return _evaluate_pixel_material(*args, **kw)


def _evaluate_pixel_material(
    scene: Scene,
    g: GBuffer,
    tex_slots: tuple = (True,) * 9,
    mat_matrix: MaterialMatrix | None = None,
    quad_shape: tuple | None = None,
    fused_trilinear: bool = False,
):
    """Per-pixel material evaluation on a FLAT [M] G-buffer: diffuse/
    emission/metallic-roughness/specular/transmission texture fetches +
    normal mapping (get_material_params shader/src/lighting.rs:261-301,
    get_emission :303-313, calculate_normal :222-259, plus the
    transmission/thickness fetches of fragment_transmission
    shader/src/lib.rs:37-162, 120-124).

    ``tex_slots`` statically gates each texture slot: slots no material in
    the scene uses skip their taps entirely — the trace-time analogue of
    the shader's per-fragment ``!= -1`` branches."""
    if mat_matrix is None:
        mat_matrix = build_material_matrix(scene, tex_slots)
    mm = mat_matrix
    mid = g.material_id
    (
        use_diffuse, use_mr, use_normal, use_emissive, _use_occlusion,
        use_transmission, use_thickness, use_specular, use_specular_colour,
    ) = tex_slots

    with pass_scope("mat_row"):
        mrow = onehot_rows(mm.table, mid)  # [M, C] — ONE fused fetch

    # Bundle-sample cache: slots whose meta block is SHARED (one bundle
    # per material, see build_material_matrix) sample once per COLUMN —
    # one gather pair serves every slot in the group; per-slot extraction
    # is a register layer select.
    a_classes = atlas_classes(scene.atlas_meta)
    n_layers = max(a_classes)
    bundle_cache: dict = {}

    def tex4(slot_idx):
        name = _MAT_SLOTS[slot_idx]
        tid = mrow[..., 21 + slot_idx].astype(jnp.int32)
        col = mm.meta_col[name]
        layer = jnp.maximum(tid, 0) >> LAYER_SHIFT

        def extract(bundle):
            if n_layers == 1:
                return bundle[..., 0, :]
            return select_layer(bundle, layer)

        if quad_shape is None:
            if col not in bundle_cache:
                with pass_scope("mat_tap"):
                    rows = _meta_rows_from(mrow, col)
                    lod = _mip_lod(
                        g.duv_dx, g.duv_dy, rows[..., 2], rows[..., 3]
                    )
                    bundle_cache[col] = sample_bundle_rows(
                        scene.atlas_texels, rows, g.uv, lod, WRAP_REPEAT,
                        fused=fused_trilinear, classes=a_classes,
                    )
            return tid, extract(bundle_cache[col])
        # Quality flag (RenderConfig.quad_material_taps): ONE tap per 2x2
        # pixel quad, shared by its 4 pixels — the quad's first VALID
        # pixel supplies uv/lod/meta (a representative, NOT a mean: meta
        # rows hold table offsets, and a mean uv across a silhouette
        # would sample the background's garbage coordinates). Quarters
        # the gather count of every material texture fetch; error is
        # sub-texel except at quad-straddling material boundaries. The
        # flat [M] worklist must be a dense row-major (h, w) frame for
        # the reshape to mean "2x2 quads".
        h, w = quad_shape
        vq = g.valid.reshape(h // 2, 2, w // 2, 2).transpose(0, 2, 1, 3)
        choice = jnp.argmax(vq.reshape(h // 2, w // 2, 4), axis=-1)

        def rep(x):
            x2 = x.reshape(h // 2, 2, w // 2, 2, *x.shape[1:])
            x2 = jnp.transpose(
                x2, (0, 2, 1, 3) + tuple(range(4, x2.ndim))
            ).reshape(h // 2, w // 2, 4, *x.shape[1:])
            idx = choice.reshape(h // 2, w // 2, 1, *(1,) * (x.ndim - 1))
            return jnp.take_along_axis(x2, idx, axis=2)[:, :, 0].reshape(
                -1, *x.shape[1:]
            )

        if col not in bundle_cache:
            rows = _meta_rows_from(mrow, col)
            lod = _mip_lod(g.duv_dx, g.duv_dy, rows[..., 2], rows[..., 3])
            with pass_scope("mat_tap"):
                sample_q = sample_bundle_rows(
                    scene.atlas_texels, rep(rows), rep(g.uv),
                    rep(lod[..., None])[..., 0], WRAP_REPEAT,
                    fused=fused_trilinear, classes=a_classes,
                )  # [M/4, L, 4]
            bundle_cache[col] = jnp.broadcast_to(
                sample_q.reshape(h // 2, 1, w // 2, 1, n_layers, 4),
                (h // 2, 2, w // 2, 2, n_layers, 4),
            ).reshape(-1, n_layers, 4)
        return tid, extract(bundle_cache[col])

    # diffuse (sRGB)
    diffuse = mrow[..., 2:6]
    if use_diffuse:
        tid, s = tex4(0)
        diffuse = jnp.where((tid >= 0)[..., None], diffuse * s, diffuse)

    # metallic/roughness — note the z/y (B/G) channel swap
    # (shader/src/lighting.rs:269-277)
    metallic = mrow[..., 0]
    roughness = mrow[..., 1]
    if use_mr:
        tid, s = tex4(1)
        metallic = jnp.where(tid >= 0, metallic * s[..., 2], metallic)
        roughness = jnp.where(tid >= 0, roughness * s[..., 1], roughness)

    # specular extension
    specular_colour = mrow[..., 17:20]
    if use_specular_colour:
        tid, s = tex4(7)
        specular_colour = jnp.where(
            (tid >= 0)[..., None], specular_colour * s[..., :3], specular_colour
        )
    specular_factor = mrow[..., 16]
    if use_specular:
        tid, s = tex4(6)
        specular_factor = jnp.where(
            tid >= 0, specular_factor * s[..., 3], specular_factor
        )

    # emission (sRGB)
    emission = mrow[..., 6:9]
    if use_emissive:
        tid, s = tex4(3)
        emission = jnp.where((tid >= 0)[..., None], emission * s[..., :3], emission)

    # transmission & thickness
    transmission_factor = mrow[..., 10]
    if use_transmission:
        tid, s = tex4(4)
        transmission_factor = jnp.where(
            tid >= 0, transmission_factor * s[..., 0], transmission_factor
        )
    thickness = mrow[..., 11]
    if use_thickness:
        tid, s = tex4(5)
        thickness = jnp.where(tid >= 0, thickness * s[..., 1], thickness)

    # normal mapping via the screen-space cotangent frame
    # (shader/src/lighting.rs:243-259), using analytic derivatives
    normal = g.normal / jnp.maximum(
        jnp.linalg.norm(g.normal, axis=-1, keepdims=True), 1e-12
    )
    if use_normal:
        with pass_scope("mat_normal"):
            normal = _normal_mapped(g, normal, tex4)
    params = MaterialParams(
        diffuse_colour=diffuse[..., :3],
        metallic=metallic,
        perceptual_roughness=roughness,
        index_of_refraction=mrow[..., 9],
        specular_colour=specular_colour,
        specular_factor=specular_factor,
    )
    att_dist = jnp.where(mrow[..., 20] > 0.5, jnp.inf, mrow[..., 12])
    return PixelMaterial(
        params=params,
        diffuse_alpha=diffuse[..., 3],
        emission=emission,
        transmission_factor=transmission_factor,
        thickness=thickness,
        attenuation_distance=att_dist,
        attenuation_colour=mrow[..., 13:16],
        normal=normal,
    )


def _normal_mapped(g: GBuffer, normal, tex4):
    """Normal mapping via the screen-space cotangent frame
    (shader/src/lighting.rs:243-259), using analytic derivatives."""
    tid, map_sample = tex4(2)
    map_normal = map_sample[..., :3] * (255.0 / 127.0) - (128.0 / 127.0)
    # cotangent frame from dp/dx, dp/dy, duv/dx, duv/dy. The reference
    # uses -view_vector as 'position' for the derivatives; analytic
    # world-pos derivatives are equivalent up to the camera offset.
    dp1 = g.dpos_dx
    dp2 = g.dpos_dy
    duv1 = g.duv_dx
    duv2 = g.duv_dy
    dp2perp = jnp.cross(dp2, normal)
    dp1perp = jnp.cross(normal, dp1)
    t = dp2perp * duv1[..., 0:1] + dp1perp * duv2[..., 0:1]
    bt = dp2perp * duv1[..., 1:2] + dp1perp * duv2[..., 1:2]
    invmax = 1.0 / jnp.sqrt(
        jnp.maximum(
            jnp.maximum(jnp.sum(t * t, axis=-1), jnp.sum(bt * bt, axis=-1)),
            1e-20,
        )
    )
    mapped = (
        t * invmax[..., None] * map_normal[..., 0:1]
        + bt * invmax[..., None] * map_normal[..., 1:2]
        + normal * map_normal[..., 2:3]
    )
    mapped = mapped / jnp.maximum(
        jnp.linalg.norm(mapped, axis=-1, keepdims=True), 1e-12
    )
    return jnp.where((tid >= 0)[..., None], mapped, normal)


def _cluster_index(ctx: ShadeContext, depth, px, py):
    """Fragment -> cluster id (shader/src/lib.rs:205-215); px/py are the
    integer pixel coordinates of each (flat) worklist entry."""
    cx, cy = ctx.num_clusters_xy
    fx = px.astype(jnp.float32) + 0.5
    fy = py.astype(jnp.float32) + 0.5
    cluster_x = jnp.minimum(
        (fx / ctx.cluster_size_in_pixels[0]).astype(jnp.uint32), cx - 1
    )
    cluster_y = jnp.minimum(
        (fy / ctx.cluster_size_in_pixels[1]).astype(jnp.uint32), cy - 1
    )
    cluster_z = get_depth_slice(ctx.cluster_coeffs, depth)
    cluster_z = jnp.minimum(cluster_z, ctx.cluster_coeffs.num_depth_slices - 1)
    return (cluster_z * (cx * cy) + cluster_y * cx + cluster_x).astype(jnp.int32)


def _cluster_rows(ctx: ShadeContext, depth, px, py):
    """Per-pixel fused cluster fetch -> (cluster ids, [..., 1 + S] rows
    [count, idx_0..idx_{S-1}], counts, S).

    ONE row gather per pixel. The SINGLE source of the cluster-list layout: both the light
    loop (_evaluate_lights_common) and the shadow-ray gate
    (cluster_light_mask) read it, which is what makes the gate's "factor
    never read for out-of-cluster lights" invariant hold by
    construction."""
    with pass_scope("cluster_fetch"):
        cluster = _cluster_index(ctx, depth, px, py)
        max_slots = min(ctx.lights.num, ctx.cluster_light_indices.shape[1])
        cluster_table = jnp.concatenate(
            [
                ctx.cluster_light_counts[:, None].astype(jnp.int32),
                ctx.cluster_light_indices[:, :max_slots].astype(jnp.int32),
            ],
            axis=1,
        )
        rows = cluster_table[cluster]  # [..., 1 + S]
        return cluster, rows, rows[..., 0], max_slots


def cluster_light_mask(ctx: ShadeContext, depth, px, py) -> jnp.ndarray:
    """[..., L] bool: light l is in the pixel's cluster light list.

    Ray-gating companion to evaluate_lights_common: a light outside the
    pixel's cluster list is multiplied by ``active = slot < count`` = 0
    there, so its shadow factor is never read — its shadow ray needn't
    be traced. render_frame uses this to zero t_max on (pixel, light)
    pairs before the batched BVH walk; the traversal's phase-1
    compaction then packs the dead lanes into all-done chunks that exit
    immediately (ops/bvh.py), cutting the pass's effective ray count to
    sun + cluster-active pairs with a bit-identical image.
    """
    num_lights = ctx.lights.num
    _, rows, counts, max_slots = _cluster_rows(ctx, depth, px, py)
    lids = jnp.arange(num_lights, dtype=jnp.int32)
    mask = jnp.zeros((*counts.shape, num_lights), dtype=bool)
    # Python loop over the (small, static) slot count: each step is one
    # [..., L] compare — avoids materialising a [..., S, L] one-hot.
    for s in range(max_slots):
        in_slot = rows[..., 1 + s : 2 + s] == lids
        mask = mask | (in_slot & (s < counts)[..., None])
    return mask


def _light_matrix(lights: Lights) -> jnp.ndarray:
    """Fuse the per-light columns the clustered loop reads into one
    [L, 12] table: position(3) colour_emission(3) spot_direction(3)
    spot_outer_angle spot_epsilon is_spot."""
    return jnp.concatenate(
        [
            lights.position,
            lights.colour_emission,
            lights.spot_direction,
            lights.spot_outer_angle[:, None],
            lights.spot_epsilon[:, None],
            lights.is_a_spotlight().astype(jnp.float32)[:, None],
        ],
        axis=1,
    )


# At or below this many cluster slots the light loop unrolls; above it a
# lax.fori_loop keeps the HLO small (128 lights != 128 dense passes).
_UNROLL_MAX_SLOTS = 8


def evaluate_lights_common(*args, **kw):
    """pass_scope'd wrapper — per-pass light-loop time shows up as
    'light_loop' in the in-frame table (tools/pass_timing.py)."""
    with pass_scope("light_loop"):
        return _evaluate_lights_common(*args, **kw)


def _evaluate_lights_common(
    ctx: ShadeContext,
    material: MaterialParams,
    view: jnp.ndarray,
    position: jnp.ndarray,
    normal: jnp.ndarray,
    depth: jnp.ndarray,
    px: jnp.ndarray,
    py: jnp.ndarray,
    with_transmission: bool,
):
    """The clustered light loop shared by both fragment shaders
    (evaluate_lights / evaluate_lights_transmission,
    shader/src/lighting.rs:13-95, 145-220), on flat [M] pixels.

    Returns (BrdfResult sum, transmission accumulation [M, 3] or None,
    cluster ids, per-pixel light counts).
    """
    num_lights = ctx.lights.num
    cluster, cluster_rows, counts, max_slots = _cluster_rows(
        ctx, depth, px, py
    )

    sun_factor = (
        ctx.sun_shadow_factor
        if ctx.sun_shadow_factor is not None
        else jnp.ones(depth.shape, jnp.float32)
    )
    if not with_transmission and ctx.sun_shadow_factor is not None:
        # ambient floor on ray-traced sun shadows (shader/src/lighting.rs:166)
        sun_factor = jnp.maximum(sun_factor, 0.1)

    # bf16 light math (RenderConfig.bf16_light_math): the BRDF/BTDF cores
    # — the loop's arithmetic bulk — run in bfloat16; per-light radiance
    # (emission x 1/d^2 x spot x shadow) and the accumulation stay f32.
    # Casting the *geometry* once here (not per slot) keeps the cast cost
    # out of the loop.
    cdt = jnp.bfloat16 if ctx.bf16_lights else jnp.float32

    def _c(x):
        return x.astype(cdt)

    def _f32(r: "BrdfResult"):
        return r._replace(
            diffuse=r.diffuse.astype(jnp.float32),
            specular=r.specular.astype(jnp.float32),
        )

    material_c = MaterialParams(*(_c(f) for f in material))
    normal_c = _c(normal)
    view_c = _c(view)
    # light-independent terms (roughness^2, c_diff, combined F0/F90)
    # evaluated ONCE per pixel and reused by every light slot —
    # bit-identical to the per-light evaluation (same expressions)
    inv_c = material_invariants(material_c)

    with pass_scope("brdf_sun"):
        sun_intensity = ctx.sun_intensity * sun_factor[..., None]
        result = _f32(
            basic_brdf(normal_c, _c(ctx.sun_dir), _c(sun_intensity), view_c,
                       material_c, inv=inv_c)
        )
        transmission = None
        if with_transmission:
            transmission = sun_intensity * transmission_btdf(
                material_c, normal_c, view_c,
                _c(jnp.broadcast_to(ctx.sun_dir, position.shape)),
                inv=inv_c,
            ).astype(jnp.float32)

    lmat = _light_matrix(ctx.lights)

    # Clustered loop: slot i reads the cluster's i-th accepted light;
    # per-slot light columns come from ONE one-hot fetch instead of ~7
    # gathers. Few-light scenes unroll (fewest ops); many-light scenes use
    # a lax loop so 128 slots don't emit 128 dense HLO passes (the
    # shader's bounded runtime loop, shader/src/lighting.rs:178-208).
    def slot_contrib(slot, light_idx):
        active = slot < counts
        lrow = onehot_rows(lmat, light_idx)  # [M, 12]
        l_pos = lrow[..., 0:3]
        direction, distance, attenuation = light_direction_and_attenuation(
            position, l_pos
        )
        factor = jnp.where(active, 1.0, 0.0)
        if ctx.light_shadow_factors is not None:
            factor = factor * jnp.take_along_axis(
                ctx.light_shadow_factors, light_idx[..., None], axis=-1
            )[..., 0]
        # spotlight factor (guard epsilon=0 point lights)
        is_spot = lrow[..., 11] > 0.5
        eps = jnp.where(lrow[..., 10] == 0.0, 1.0, lrow[..., 10])
        spot = spotlight_factor(
            direction, lrow[..., 6:9], lrow[..., 9], eps
        )
        if not with_transmission:
            # only evaluate_lights applies the spot factor
            # (shader/src/lighting.rs:201-203)
            factor = factor * jnp.where(is_spot, spot, 1.0)

        light_emission = lrow[..., 3:6] * factor[..., None]
        radiance = light_emission * attenuation[..., None]
        contrib = _f32(
            basic_brdf(normal_c, _c(direction), _c(radiance), view_c,
                       material_c, inv=inv_c)
        )
        t_contrib = (
            radiance * transmission_btdf(
                material_c, normal_c, view_c, _c(direction), inv=inv_c
            ).astype(jnp.float32)
            if with_transmission
            else None
        )
        return contrib, t_contrib

    if max_slots <= _UNROLL_MAX_SLOTS:
        with pass_scope("brdf_slots"):
            for slot in range(max_slots):
                contrib, t_contrib = slot_contrib(
                    slot, cluster_rows[..., 1 + slot]
                )
                result = result + contrib
                if with_transmission:
                    transmission = transmission + t_contrib
    else:
        t_init = transmission if with_transmission else jnp.zeros(())

        def body(slot, carry):
            d_acc, s_acc, t_acc = carry
            light_idx = jax.lax.dynamic_slice_in_dim(
                cluster_rows, 1 + slot, 1, axis=-1
            )[..., 0]
            contrib, t_contrib = slot_contrib(slot, light_idx)
            return (
                d_acc + contrib.diffuse,
                s_acc + contrib.specular,
                t_acc + t_contrib if with_transmission else t_acc,
            )

        d_acc, s_acc, t_acc = jax.lax.fori_loop(
            0, max_slots, body,
            (result.diffuse, result.specular, t_init),
        )
        result = result._replace(diffuse=d_acc, specular=s_acc)
        if with_transmission:
            transmission = t_acc

    return result, transmission, cluster, counts


# NumPy on purpose: a module-level jnp.array would force backend init at
# import time; np constants convert lazily inside traced code.
_DEBUG_COLOURS = np.array(
    [  # shader/src/lib.rs:647-664
        [0.0, 0.0, 0.0],
        [0.0, 0.0, 0.1647],
        [0.0, 0.0, 0.3647],
        [0.0, 0.0, 0.6647],
        [0.0, 0.0, 0.9647],
        [0.0, 0.9255, 0.9255],
        [0.0, 0.5647, 0.0],
        [0.0, 0.7843, 0.0],
        [1.0, 1.0, 0.0],
        [0.90588, 0.75294, 0.0],
        [1.0, 0.5647, 0.0],
        [1.0, 0.0, 0.0],
        [0.8392, 0.0, 0.0],
        [1.0, 0.0, 1.0],
        [0.6, 0.3333, 0.7882],
    ],
    np.float32,
)


def flatten_gbuffer(g: GBuffer) -> GBuffer:
    """[H, W(,C)] G-buffer -> flat [M(,C)] G-buffer."""
    h, w = g.depth.shape

    def f(a):
        return a.reshape((h * w,) + a.shape[2:])

    return GBuffer(*[f(x) for x in g])


def _dense_coords(h: int, w: int):
    px = jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32)[None, :], (h, w)).reshape(-1)
    py = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[:, None], (h, w)).reshape(-1)
    return px, py


def shade_opaque_flat(
    scene: Scene, g: GBuffer, ctx: ShadeContext, px, py,
    quad_shape: tuple | None = None,
    return_planes: bool = False,
) -> jnp.ndarray | tuple:
    """The opaque PBR fragment shader (shader/src/lib.rs:164-249) over a
    flat [M] worklist. Returns [M, 3] HDR; invalid pixels are black (the
    draw pass clears to zero).

    ``return_planes`` returns (r, g, b) [M] channel planes instead (the
    frame keeps HDR planar through the pyramid/merge/tonemap back
    half)."""
    view_vector = ctx.view_position - g.position
    view = view_vector / jnp.maximum(
        jnp.linalg.norm(view_vector, axis=-1, keepdims=True), 1e-12
    )
    pm = evaluate_pixel_material(
        scene, g, ctx.tex_slots, mat_matrix=ctx.mat_matrix,
        quad_shape=quad_shape, fused_trilinear=ctx.fused_trilinear,
    )

    result, _, cluster, counts = evaluate_lights_common(
        ctx, pm.params, view, g.position, pm.normal, g.depth, px, py,
        with_transmission=False,
    )
    out = result.diffuse + result.specular + pm.emission

    if ctx.debug_clusters:
        # cluster false-colouring oracle (shader/src/lib.rs:241-245)
        colours = jnp.asarray(_DEBUG_COLOURS)
        c1 = colours[counts.astype(jnp.int32) % 15]
        c2 = colours[cluster % 15]
        out = c1 + (c2 - 0.5) * 0.025

    out = jnp.where(g.valid[..., None], out, 0.0)
    if return_planes:
        return tuple(out[:, c] for c in range(3))
    return out


def shade_opaque(scene: Scene, g: GBuffer, ctx: ShadeContext) -> jnp.ndarray:
    """Dense [H, W] wrapper over shade_opaque_flat."""
    h, w = g.depth.shape
    px, py = _dense_coords(h, w)
    ctx = _flatten_ctx_factors(ctx)
    quad = (h, w) if ctx.quad_taps and h % 2 == 0 and w % 2 == 0 else None
    out = shade_opaque_flat(scene, flatten_gbuffer(g), ctx, px, py,
                            quad_shape=quad)
    return out.reshape(h, w, 3)


def _flatten_ctx_factors(ctx: ShadeContext) -> ShadeContext:
    """Flatten [H, W]-shaped shadow factors for the flat cores."""
    rep = {}
    if ctx.sun_shadow_factor is not None and ctx.sun_shadow_factor.ndim == 2:
        rep["sun_shadow_factor"] = ctx.sun_shadow_factor.reshape(-1)
    if ctx.light_shadow_factors is not None and ctx.light_shadow_factors.ndim == 3:
        f = ctx.light_shadow_factors
        rep["light_shadow_factors"] = f.reshape(-1, f.shape[-1])
    return ctx._replace(**rep) if rep else ctx


def shade_transmission_flat(
    scene: Scene,
    g: GBuffer,
    ctx: ShadeContext,
    opaque_pyramid: MipPyramid,
    px,
    py,
    fb_sampler=None,
    pyramid_level_set: tuple | None = None,
) -> jnp.ndarray:
    """The transmission fragment shader (shader/src/lib.rs:37-162) over a
    flat [M] worklist. Returns [M, 3] HDR for valid pixels."""
    view_vector = ctx.view_position - g.position
    view = view_vector / jnp.maximum(
        jnp.linalg.norm(view_vector, axis=-1, keepdims=True), 1e-12
    )
    pm = evaluate_pixel_material(
        scene, g, ctx.tex_slots, mat_matrix=ctx.mat_matrix,
        fused_trilinear=ctx.fused_trilinear,
    )

    result, transmission, _, _ = evaluate_lights_common(
        ctx, pm.params, view, g.position, pm.normal, g.depth, px, py,
        with_transmission=True,
    )

    if fb_sampler is None:
        fb_sampler = lambda uv, lod: sample_pyramid_lod(
            opaque_pyramid, uv, lod, level_set=pyramid_level_set
        )
    # quad-block the LUT once per frame (render_frame hoists this to a
    # trace-time constant) so each pixel's split-sum fetch is ONE gather
    # instead of four
    lut_quads = (
        ctx.ggx_lut_quads
        if ctx.ggx_lut_quads is not None
        else quad_lut_2ch(ctx.ggx_lut)
    )
    lut_size = ctx.ggx_lut.shape[0]
    lut_sampler = lambda nov, rough: sample_lut_2ch_quad(
        lut_quads, lut_size, nov, rough
    )

    transmission = transmission + ibl_volume_refraction(
        pm.params,
        jnp.float32(ctx.framebuffer_size[0]),
        pm.normal,
        view,
        ctx.proj_view,
        g.position,
        pm.thickness,
        g.model_scale,
        pm.attenuation_distance,
        pm.attenuation_colour,
        fb_sampler,
        lut_sampler,
    )

    real_transmission = pm.transmission_factor[..., None] * transmission
    diffuse = result.diffuse + (
        real_transmission - result.diffuse
    ) * pm.transmission_factor[..., None]
    out = diffuse + result.specular + pm.emission
    return jnp.where(g.valid[..., None], out, 0.0)


def shade_transmission(
    scene: Scene,
    g: GBuffer,
    ctx: ShadeContext,
    opaque_pyramid: MipPyramid,
    pyramid_level_set: tuple | None = None,
) -> jnp.ndarray:
    """Dense [H, W] wrapper over shade_transmission_flat (the only path
    that supports half_res_refraction, which needs the 2D pixel grid)."""
    h, w = g.depth.shape
    px, py = _dense_coords(h, w)
    fb_sampler = None
    if ctx.half_res_refraction:
        def fb_sampler(uv, lod):
            uv2 = uv.reshape(h, w, 2)[::2, ::2]
            lod2 = lod.reshape(h, w)[::2, ::2]
            c = sample_pyramid_lod(
                opaque_pyramid, uv2, lod2, level_set=pyramid_level_set
            )
            return jax.image.resize(c, (h, w, 3), "linear").reshape(-1, 3)

    ctx = _flatten_ctx_factors(ctx)
    out = shade_transmission_flat(
        scene, flatten_gbuffer(g), ctx, opaque_pyramid, px, py,
        fb_sampler=fb_sampler, pyramid_level_set=pyramid_level_set,
    )
    return out.reshape(h, w, 3)

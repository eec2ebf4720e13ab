"""Row-band-sharded render_frame via shard_map — the framework's one real
distributed feature (SURVEY.md §5.7/§5.8).

Each device owns a contiguous band of tile rows:

  * scene + draw list are replicated (scenes are small vs framebuffers);
    vertex transform / culling / binning are recomputed per device (cheap,
    avoids any gather of triangle data),
  * each band rasterises ONLY its tiles with the Pallas G-buffer kernel
    (class-split bins: the per-band tile_start slice is contiguous),
  * shading runs band-locally with GLOBAL pixel coordinates (cluster
    lookups span the whole frame),
  * the opaque mip pyramid is built DISTRIBUTED:
      - fine levels (0..L_local-1, where 2^L_local divides the band
        height) are downsampled band-locally — zero communication,
      - ONE small coarse level is all_gather'd and the remaining levels
        are derived replicated (level L_local at 1080p/8 bands is
        240x136 ~ 390 KB vs 25 MB for the old full-res gather),
      - each fine level exchanges a halo of rows with its two neighbour
        bands via ppermute, so cross-band bilinear footprints and
        refraction fetches within ``sharded_refraction_halo_px`` of the
        band are EXACT; farther fetches clamp to the halo edge
        (documented approximation, tunable),
  * transmissive raster + shade + tonemap stay band-local.

Per-chip communicated bytes drop from O(H*W) to O(W * halo + coarse
levels) — the halo-exchange design of SURVEY.md §5.7. Level sizes are
sampled at the TRUE (unpadded) frame sizes, so in-halo results bit-match
the single-chip renderer.

Alpha-clip draw classes resolve through the SAME in-kernel depth-peeling
scheme as the single-chip path (render/frame.py::_rasterize_clip_peeled),
band-locally: each band races its own tiles, alpha-tests the winners and
re-races only its failing tiles — no cross-band communication (a tile's
winner depends only on its own records). ``return_diagnostics`` yields a
FrameDiagnostics reduced across bands (max for capacities, sum for
unresolved pixels), so capacity overflows are visible exactly like the
single-chip path.

PYRAMID POOL LAYOUT: the distributed pyramid pool stores QUAD-BLOCK
rows (ops/mipchain.py::_quad_level — 4 phase-shifted 2x2 blocks per
level, GROUP blocks per physical row), built PER SLICE in slice-local
coordinates: a band-local level's slice is [halo + band_rows + halo, w]
(its ppermute'd halos included), so block geometry never crosses the
exchange boundary, and replicated levels quad-build their true-height
image exactly like the single-chip pyramid. A trilinear fetch is 2 row
gathers (one 2x2 block per level) instead of the round-4 ROW-form's 8.
Slice-edge semantics match the old per-tap clamps exactly (see
_sample_band_pyramid: the global clamp runs before the slice remap, and
fy is forced 0 wherever the old path double-tapped one row), keeping
the in-halo bit-match contract with the single-chip renderer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from transmission_renderer_tpu.scene import textures as _tx

from transmission_renderer_tpu.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    BUCKET_TRANSMISSION_ALPHA_CLIP,
    RenderConfig,
)
from transmission_renderer_tpu.ops.cull import bucket_triangle_masks, cull_instances
from transmission_renderer_tpu.ops.mipchain import _downsample2x, pyramid_shapes

# quad-blocks per physical pool row — shared with the single-chip quad
# tables (ops/mipchain.py::_quad_level builds both)
from transmission_renderer_tpu.ops.mipchain import (  # noqa: E402
    GROUP as _QGROUP,
    _fetch_quad,
    _grouped_rows,
    _quad_level,
)
from transmission_renderer_tpu.ops.raster import (
    VisibilityBuffer,
    bin_triangles,
    rasterize_tilelist,
    setup_triangles,
    tile_image,
    untile_image,
)
from transmission_renderer_tpu.pbr import (
    bake_lottes_params,
    lottes_tonemap,
)
from transmission_renderer_tpu.pbr.clustering import assign_lights_to_clusters
from transmission_renderer_tpu.pbr.lights import Lights
from transmission_renderer_tpu.render.frame import (
    DrawList,
    FrameDiagnostics,
    FrameParams,
    SceneFlags,
    _clip_alpha_ok_tiles,
    _make_alpha_fn,
    _merge_gbuffers,
    _static_cluster_data,
    _up2 as _frame_up2,
)
from transmission_renderer_tpu.render.gbuffer import interpolate_gbuffer
from transmission_renderer_tpu.render.shading import (
    ShadeContext,
    _dense_coords,
    flatten_gbuffer,
    shade_opaque_flat,
    shade_transmission_flat,
)
from transmission_renderer_tpu.scene.types import Scene, Similarity, quat_rotate, similarity_apply
from transmission_renderer_tpu.utils.ggx_lut import default_ggx_lut
from transmission_renderer_tpu.utils.platform import (
    f32_matmuls,
    use_raster_kernel,
)


def make_band_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("band",))


def _band_tile_rows(config: RenderConfig, n_bands: int) -> int:
    """Tile rows per band; tiles_y padded up to a multiple of n_bands
    (padded rows raster nothing visible and are cropped)."""
    return -(-config.tiles_y // n_bands)


def _trailing_zeros(n: int) -> int:
    return (n & -n).bit_length() - 1


class _BandPyramidSpec:
    """Static layout of the distributed pyramid's flat texel pool.

    A level is kept band-LOCAL (its band slice + a ppermute'd halo of
    ``halo_px >> level`` rows from each neighbour) when the halo fits
    inside one neighbour band AND the band height still halves evenly;
    otherwise the level is REPLICATED (all_gather'd — it is either coarse
    and tiny, or the frame is so small relative to the halo that exact
    fetches need it anyway). At production sizes (1080p, 8 bands of 136
    rows, 64 px halo) levels 0..2 are local and the gather starts at
    240x136 — per-chip bytes O(W*halo + coarse), not O(H*W)."""

    def __init__(self, width: int, height: int, band_h: int, n_bands: int,
                 halo_px: int):
        shapes = pyramid_shapes(width, height)  # TRUE level sizes
        self.num_levels = len(shapes)
        self.widths = [s[0] for s in shapes]
        self.heights = [s[1] for s in shapes]
        # level l is band-local only when 2^l | band_h — and the FIRST
        # replicated level is produced by per-band downsampling of level
        # l_local-1 before the all_gather, which matches the global
        # downsample only when 2^l_local | band_h too. Odd band_h must
        # therefore gather level 0 whole (l_local = 0), not floor-halve
        # each band independently (that drops one row per band boundary
        # and diverges from the single-chip pyramid).
        max_aligned = min(_trailing_zeros(band_h), self.num_levels - 1)
        self.l_local = 0
        for l in range(max_aligned):
            if max(halo_px >> l, 1) >= (band_h >> l):
                break  # halo would span past the neighbour: replicate
            self.l_local = l + 1
        self.band_rows = [band_h >> l for l in range(self.l_local)]
        self.halos = [max(halo_px >> l, 1) for l in range(self.l_local)]
        # replicated levels live at padded heights; floor at 1 row — the
        # downsample chain sticks at max(h // 2, 1), so a wide frame
        # whose deep levels outlive the padded height (num_levels is set
        # by max(w, h)) still stores one row per level
        # per-level quad-table geometry over the STORED slice: local
        # levels quad-build their haloed band slice, replicated levels
        # their true-height image (identical to the single-chip build)
        self.slice_rows = [
            self.band_rows[l] + 2 * self.halos[l]
            if l < self.l_local
            else self.heights[l]
            for l in range(self.num_levels)
        ]
        qoffs, qoff = [], 0
        for l in range(self.num_levels):
            bw = (self.widths[l] + 1) // 2
            bh = (self.slice_rows[l] + 1) // 2
            qoffs.append(qoff)
            qoff += _grouped_rows(4 * bw * bh)
        self.quad_offsets = qoffs
        self.total_qrows = qoff


def _build_band_pyramid(hdr_band: jnp.ndarray, spec: _BandPyramidSpec,
                        n_bands: int):
    """Band-local downsample chain + halo exchange + one coarse gather.
    Returns the band's QUAD-BLOCK pool ([spec.total_qrows, 12 * GROUP]):
    each band-local level's haloed slice and each replicated level's
    true-height image run the single-chip quad build
    (ops/mipchain.py::_quad_level), so a bilinear tap is ONE row gather.
    Edge duplication baked by the quad build happens at SLICE edges,
    which _sample_band_pyramid makes semantically identical to the old
    per-tap clamps (global clamp before slice remap + forced fy)."""
    fine = []
    cur = hdr_band
    for _ in range(spec.l_local):
        fine.append(cur)
        cur = _downsample2x(cur)
    # gather the first replicated level (small) and derive the rest
    gathered = jax.lax.all_gather(cur, "band", axis=0, tiled=True)
    coarse = [gathered]
    for l in range(spec.l_local + 1, spec.num_levels):
        coarse.append(_downsample2x(coarse[-1]))

    fwd = [(i, i + 1) for i in range(n_bands - 1)]
    bwd = [(i + 1, i) for i in range(n_bands - 1)]
    parts = []
    for l in range(spec.l_local):
        lvl = fine[l][:, : spec.widths[l]]
        r = spec.halos[l]
        # halo from the band above = its BOTTOM r rows sent forward.
        # Edge bands receive ppermute ZEROS in the unpaired halo; the
        # sampler's global clamp + forced-fy rules keep every read
        # footprint inside real rows (see _sample_band_pyramid).
        above = jax.lax.ppermute(lvl[-r:], "band", fwd)
        below = jax.lax.ppermute(lvl[:r], "band", bwd)
        parts.append(
            _quad_level(jnp.concatenate([above, lvl, below], axis=0))
        )
    for l, lvl in enumerate(coarse):
        k = spec.l_local + l
        parts.append(_quad_level(lvl[: spec.heights[k], : spec.widths[k]]))
    return jnp.concatenate(parts, axis=0)


def _sample_band_pyramid(pool, spec: _BandPyramidSpec, band, uv, lod):
    """Trilinear clamp fetch against the distributed pyramid — 2 row
    gathers (one quad-block per mip level); exact for fetches within the
    halo, halo-edge-clamped beyond it.

    Exactness at slice edges (the in-halo bit-match contract): the
    global CLAMP_TO_EDGE runs BEFORE the slice remap so edge-band halo
    zeros are never addressed, and fy is forced to 0 wherever the old
    8-gather path double-tapped one row (footprint above the slice, or
    at the true image bottom where the last band's slice continues into
    ppermute zeros) — in both cases the old lerp was between identical
    rows, which equals the fy = 0 single tap."""
    max_level = spec.num_levels - 1
    lod = jnp.clip(lod, 0.0, float(max_level))
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, max_level)

    def level_meta(lvl):
        has_local = spec.l_local > 0
        qoff = jnp.full(lvl.shape, spec.quad_offsets[0], jnp.int32)
        w = jnp.full(lvl.shape, spec.widths[0], jnp.int32)
        h = jnp.full(lvl.shape, spec.heights[0], jnp.int32)
        srows = jnp.full(lvl.shape, spec.slice_rows[0], jnp.int32)
        brows = jnp.full(
            lvl.shape, spec.band_rows[0] if has_local else 1, jnp.int32
        )
        halo = jnp.full(lvl.shape, spec.halos[0] if has_local else 0, jnp.int32)
        local = jnp.full(lvl.shape, has_local)
        for k in range(1, spec.num_levels):
            pick = lvl == k
            qoff = jnp.where(pick, spec.quad_offsets[k], qoff)
            w = jnp.where(pick, spec.widths[k], w)
            h = jnp.where(pick, spec.heights[k], h)
            srows = jnp.where(pick, spec.slice_rows[k], srows)
            if k < spec.l_local:
                brows = jnp.where(pick, spec.band_rows[k], brows)
                halo = jnp.where(pick, spec.halos[k], halo)
            else:
                local = jnp.where(pick, False, local)
        return qoff, w, h, srows, brows, halo, local

    def fetch(lvl):
        qoff, w, h, srows, brows, halo, local = level_meta(lvl)
        x = uv[..., 0] * w.astype(jnp.float32) - 0.5
        y = uv[..., 1] * h.astype(jnp.float32) - 0.5
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0 = x0.astype(jnp.int32)
        y0 = y0.astype(jnp.int32)
        fx = jnp.where((x0 < 0)[..., None], 0.0, fx)
        fy = jnp.where((y0 < 0)[..., None], 0.0, fy)
        x0 = jnp.clip(x0, 0, w - 1)
        # global clamp FIRST (CLAMP_TO_EDGE at true image rows), then
        # the band-local slice remap; forced fy where the footprint's
        # two rows resolved to the same source row in the old path
        y0g = jnp.clip(y0, 0, h - 1)
        y_raw = jnp.where(local, y0g - (band * brows - halo), y0g)
        fy = jnp.where((y_raw < 0)[..., None], 0.0, fy)
        fy = jnp.where((y0g >= h - 1)[..., None], 0.0, fy)
        y0s = jnp.clip(y_raw, 0, srows - 1)
        bw = (w + 1) >> 1
        bh = (srows + 1) >> 1
        phase = (y0s & 1) * 2 + (x0 & 1)
        qidx = phase * (bw * bh) + (y0s >> 1) * bw + (x0 >> 1)
        q = _fetch_quad(pool, qoff, qidx)
        c00, c10 = q[..., 0, :], q[..., 1, :]
        c01, c11 = q[..., 2, :], q[..., 3, :]
        top = c00 + (c10 - c00) * fx
        bot = c01 + (c11 - c01) * fx
        return top + (bot - top) * fy

    c0 = fetch(l0)
    c1 = fetch(l1)
    frac = (lod - l0.astype(jnp.float32))[..., None]
    return c0 + (c1 - c0) * frac


@f32_matmuls
def render_frame_sharded(
    scene: Scene,
    dl: DrawList,
    params: FrameParams,
    lights: Lights,
    config: RenderConfig,
    mesh: Mesh,
    ggx_lut: jnp.ndarray | None = None,
    flags: SceneFlags | None = None,
    return_diagnostics: bool = False,
    bvh=None,  # ops.bvh.BVH | None — enables --ray-tracing shadows
):
    """Sharded equivalent of render_frame. Call under jit with the mesh's
    devices available; returns the tonemapped [H, W, 3] frame (row-sharded
    on the first axis), plus a cross-band-reduced FrameDiagnostics when
    ``return_diagnostics`` is set.

    Ray-traced shadows (``config.ray_traced_shadows`` + ``bvh``) run
    BAND-LOCALLY: scene geometry is already replicated per band, so each
    band refits the (replicated) BVH and traces shadow rays for its own
    pixels only — zero cross-band communication, and per-chip ray count
    scales 1/n_bands. Results are bit-identical to the single-chip path
    (each ray's walk is independent of batch composition). The
    half-res-shadow-rays quality flag traces each band's half grid
    (band_h even keeps the global (2i, 2j) sample set) and upsamples
    with a ONE-row ppermute halo: an odd output row at a band's bottom
    edge averages across the boundary exactly like the single-chip
    upsample; the true image bottom clamps to the last TRUE half row
    even when it sits above band padding (see _band_half_res_factors).
    Requires band_h even as well — odd band_h falls back to full-res
    rays (warned, like the odd-framebuffer single-chip fallback)."""
    use_rt = config.ray_traced_shadows and bvh is not None
    if config.ray_traced_shadows and bvh is None:
        raise ValueError(
            "config.ray_traced_shadows requires a BVH "
            "(SceneBuilder.build_rt_bvh())"
        )
    if flags is None:
        flags = SceneFlags(has_alpha_clip=True, has_transmission=True)
    if ggx_lut is None:
        # honor config.ggx_lut_size exactly like render_frame (parity:
        # the sharding tests diff sharded vs single-chip at 2e-6)
        ggx_lut = jnp.asarray(default_ggx_lut(config.ggx_lut_size))

    n_bands = mesh.devices.size
    w, h = config.width, config.height
    tw, th = config.tile_w, config.tile_h
    tiles_x = config.tiles_x
    rows_per_band = _band_tile_rows(config, n_bands)
    band_h = rows_per_band * th
    tiles_y_padded = rows_per_band * n_bands
    h_padded = band_h * n_bands

    use_kernel = use_raster_kernel(config)

    # projection-static cluster data, cached per config and shared
    # (bitwise) with the single-chip renderer — see render/frame.py
    coeffs, cl_aabb_min, cl_aabb_max = _static_cluster_data(config)
    pyr_spec = _BandPyramidSpec(
        w, h, band_h, n_bands, config.sharded_refraction_halo_px
    )

    def band_body(scene, dl, params, lights, ggx_lut, bvh):
        band = jax.lax.axis_index("band")

        # ---- replicated prefix: vertex transform + cull + clusters --------
        inst_t = Similarity(
            translation=scene.inst_transform.translation[dl.vtx_inst],
            scale=scene.inst_transform.scale[dl.vtx_inst],
            rotation=scene.inst_transform.rotation[dl.vtx_inst],
        )
        world_pos = similarity_apply(inst_t, scene.positions[dl.vtx_src])
        world_nrm = quat_rotate(inst_t.rotation, scene.normals[dl.vtx_src])
        uvs = scene.uvs[dl.vtx_src]
        pos_h = jnp.concatenate([world_pos, jnp.ones_like(world_pos[:, :1])], -1)
        clip = pos_h @ params.proj_view.T

        visible = cull_instances(
            scene, params.view, params.frustum_x_xz, params.frustum_y_yz,
            config.z_near,
        )
        tri_scale = scene.inst_transform.scale[dl.tri_inst]

        from transmission_renderer_tpu.ops.texture import quad_lut_2ch
        from transmission_renderer_tpu.render.shading import (
            build_material_matrix,
        )

        mat_matrix_o = build_material_matrix(
            scene, flags.tex_slots, flags.slot_bundles
        )
        lut_quads = quad_lut_2ch(ggx_lut)

        aabb_min, aabb_max = cl_aabb_min, cl_aabb_max
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
            mat_matrix=mat_matrix_o,
            ggx_lut_quads=lut_quads,
            fused_trilinear=flags.atlas_pot and _tx.ATLAS_FUSED,
            bf16_lights=config.bf16_light_math,
        )

        t0 = band * rows_per_band * tiles_x
        k_tiles = rows_per_band * tiles_x
        band_tiles = t0 + jnp.arange(k_tiles, dtype=jnp.int32)
        row0_px = band * band_h

        # band-local ray-traced shadows: per-frame AABB refit (replicated
        # work, like binning) + shadow rays for THIS band's pixels
        if use_rt:
            from transmission_renderer_tpu.ops.bvh import refit_bvh
            from transmission_renderer_tpu.render.raytrace import (
                shadow_factors,
            )
            from transmission_renderer_tpu.render.shading import (
                cluster_light_mask,
            )

            bvh_f = refit_bvh(bvh, dl.tri_vtx, world_pos)
            use_half_rays = (
                config.half_res_shadow_rays
                and band_h % 2 == 0
                and w % 2 == 0
                and h % 2 == 0
            )
            if config.half_res_shadow_rays and not use_half_rays:
                import warnings

                warnings.warn(
                    f"half_res_shadow_rays requires even band height and "
                    f"framebuffer dims; band_h={band_h} {w}x{h} traces "
                    f"FULL-res shadow rays",
                    stacklevel=2,
                )

            def _band_half_up_y(a):
                """Vertical 2x upsample of a band's half-res factor grid
                with the cross-band neighbour row: odd outputs average
                rows (i, i+1) where row band_h/2 is ppermute'd from the
                band below; rows at/after the TRUE image bottom clamp to
                the last true half row (matching the single-chip
                edge-clamped _up2 on the unpadded frame — the last
                band's padding rows must not bleed upward)."""
                bh2 = band_h // 2
                bwd = [(i + 1, i) for i in range(n_bands - 1)]
                below = jax.lax.ppermute(a[:1], "band", bwd)  # [1, ...]
                nxt = jnp.concatenate([a[1:], below], axis=0)
                # single-chip nxt index = min(global + 1, h//2 - 1)
                glob = band * bh2 + jnp.arange(bh2, dtype=jnp.int32)
                need_clamp = glob + 1 > (h // 2 - 1)
                last_local = jnp.clip((h // 2 - 1) - band * bh2, 0, bh2 - 1)
                clamp_row = jax.lax.dynamic_slice_in_dim(a, last_local, 1, 0)
                shape = (bh2,) + (1,) * (a.ndim - 1)
                nxt = jnp.where(need_clamp.reshape(shape), clamp_row, nxt)
                return _frame_up2(a, 0, nxt_override=nxt)

            def band_shadow_factors(c, g_band):
                if use_half_rays:
                    # no cluster gating at half res (the upsample blends
                    # factors across pixels — render_frame's rule)
                    g_half = jax.tree_util.tree_map(
                        lambda a: a[::2, ::2], g_band
                    )
                    sun_h, light_h = shadow_factors(
                        bvh_f, dl.tri_vtx, world_pos, g_half,
                        params.sun_dir, lights,
                    )
                    sun_f = _frame_up2(_band_half_up_y(sun_h), 1)
                    light_f = _frame_up2(_band_half_up_y(light_h), 1)
                    return sun_f, light_f
                px, py = _dense_coords(band_h, w)
                mask = (
                    cluster_light_mask(
                        c, g_band.depth.reshape(-1), px, py + row0_px
                    ).reshape(band_h, w, lights.num)
                    if lights.num
                    else None
                )
                return shadow_factors(
                    bvh_f, dl.tri_vtx, world_pos, g_band, params.sun_dir,
                    lights, light_active=mask,
                )

        def shade_band(g_band, shade_fn, ctx, *extra):
            px, py = _dense_coords(band_h, w)
            if use_rt:
                sun_f, light_f = band_shadow_factors(ctx, g_band)
                ctx = ctx._replace(
                    sun_shadow_factor=sun_f.reshape(-1),
                    light_shadow_factors=light_f.reshape(-1, lights.num),
                )
            out = shade_fn(
                scene, flatten_gbuffer(g_band), ctx, *extra, px,
                py + row0_px,
            )
            return out.reshape(band_h, w, 3)

        # per-band capacity diagnostics (reduced across bands at the end)
        diag = {
            "big": jnp.int32(0), "mid": jnp.int32(0),
            "clip_unresolved": jnp.int32(0), "bin": jnp.int32(0),
            "tier": jnp.int32(0),
        }

        # ---- band raster -> G-buffers --------------------------------------
        if use_kernel:
            from transmission_renderer_tpu.ops.raster_pallas_gbuf import (
                gather_gbuf_payload,
                gbuffer_from_channels,
                pack_gbuf_payload,
                rasterize_gbuffer_tiles,
            )

            is_trans_tri = (dl.tri_bucket == BUCKET_TRANSMISSION) | (
                dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP
            )
            is_clip_tri = (dl.tri_bucket == BUCKET_ALPHA_CLIP) | (
                dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP
            )
            tri_class = is_trans_tri.astype(jnp.int32) + 2 * is_clip_tri.astype(
                jnp.int32
            )
            num_classes = 4 if flags.has_alpha_clip else 2
            mask_all = bucket_triangle_masks(
                dl.tri_inst, dl.tri_bucket, visible, (0, 1, 2, 3)
            )
            setup = setup_triangles(clip, dl.tri_vtx, mask_all, w, h, tw, th)
            bins = bin_triangles(
                setup, tiles_x, tiles_y_padded, config.pallas_tiles_per_tri,
                config.max_tris_per_tile, config.pallas_max_big_tris,
                materialize=False, class_flags=tri_class,
                num_classes=num_classes,
                mid_tile_cap=config.pallas_mid_tile_cap,
                max_mid_tris=config.pallas_max_mid_tris,
                tiers=config.pallas_tiers,
            )
            diag["big"] = bins.big_tri_count.astype(jnp.int32)
            diag["mid"] = bins.mid_tri_count
            # worst demotion-tier rung overflow (> 0 = dropped draws),
            # as render_frame tracks it
            for demand, slots in zip(bins.tier_demands, bins.tier_slots):
                diag["tier"] = jnp.maximum(diag["tier"], demand - slots)
            records = pack_gbuf_payload(
                setup, dl.tri_vtx, dl.tri_material, tri_scale,
                world_pos, world_nrm, uvs, tri_class,
            )
            payload = gather_gbuf_payload(records, bins)
            # big tris ride the sorted stream (ops/raster.py)
            big_count = jnp.zeros((), jnp.int32)
            # dpos channels only feed normal mapping (union over both
            # passes' materials keeps one payload/kernel shape per band)
            pos_derivs = flags.tex_slots[2] or flags.tex_slots_transmission[2]
            n_tiles_global = tiles_x * tiles_y_padded

            def band_channels(pass_class, tile_ids, init_tiles=None,
                              max_depth_tiles=None):
                return rasterize_gbuffer_tiles(
                    payload, tile_ids, bins.tile_start, big_count, w, h,
                    init_depth_tiles=init_tiles, pass_class=pass_class,
                    max_depth_tiles=max_depth_tiles,
                    interpret=config.pallas_interpret,
                    n_tiles_global=n_tiles_global,
                    pos_derivs=pos_derivs,
                    name=("raster_opaque", "raster_transmission",
                          "raster_clip_peel", "raster_clip_peel")[pass_class],
                )

            def band_untile(ch):
                ch = {
                    name: untile_image(
                        a, tiles_x, rows_per_band, tw, th, tiles_x * tw,
                        band_h,
                    )[:, :w]
                    for name, a in ch.items()
                }
                return gbuffer_from_channels(ch)

            def band_gbuffer(pass_class, init_tiles=None):
                return band_untile(band_channels(
                    pass_class, band_tiles, init_tiles=init_tiles
                ))

            def band_clip_peel(g_base, pass_class):
                """Band-local depth-peeled alpha-clip resolve — the
                sharded twin of _rasterize_clip_peeled's dense branch
                (render/frame.py): race the band's tiles ignoring alpha
                (seeded with the base depth), alpha-test the winners,
                re-race only failing tiles with max_depth excluding the
                rejected layer. Purely band-local: a tile's winner
                depends only on its own records."""
                init_tiles = tile_image(g_base.depth, tw, th)
                ch = band_channels(pass_class, band_tiles,
                                   init_tiles=init_tiles)
                ok = _clip_alpha_ok_tiles(scene, ch)
                # scalar frac or per-round schedule (render/frame.py)
                fracs = config.clip_retile_cap_frac
                if not isinstance(fracs, (tuple, list)):
                    fracs = (fracs,)
                caps = [max(int(np.ceil(k_tiles * f)), 1) for f in fracs]
                local_ids = jnp.arange(k_tiles, dtype=jnp.int32)
                for rnd in range(1, max(config.alpha_clip_rounds, 1)):
                    cap = caps[min(rnd - 1, len(caps) - 1)]
                    failed = (ch["tri"] >= 0) & ~ok
                    ft = jnp.any(failed.reshape(k_tiles, -1), axis=1)
                    pos = jnp.cumsum(ft.astype(jnp.int32)) - 1
                    tgt = jnp.where(ft & (pos < cap), pos, cap)
                    ids = (
                        jnp.full((cap,), k_tiles, jnp.int32)
                        .at[tgt]
                        .set(local_ids, mode="drop")
                    )
                    safe = jnp.minimum(ids, k_tiles - 1)
                    maxd = jnp.where(failed, ch["depth"], jnp.inf)
                    new = band_channels(
                        pass_class, t0 + safe,
                        init_tiles=init_tiles[safe],
                        max_depth_tiles=maxd[safe],
                    )
                    failed_sel = failed[safe]
                    sub = {}
                    for name in ch:
                        merged = jnp.where(
                            failed_sel, new[name], ch[name][safe]
                        )
                        sub[name] = merged
                        padded = jnp.concatenate(
                            [ch[name], jnp.zeros_like(ch[name][:1])], axis=0
                        )
                        ch[name] = padded.at[ids].set(
                            merged, mode="drop"
                        )[:k_tiles]
                    ok_sub = _clip_alpha_ok_tiles(scene, sub)
                    ok = (
                        jnp.concatenate([ok, jnp.ones_like(ok[:1])], axis=0)
                        .at[ids]
                        .set(ok_sub, mode="drop")[:k_tiles]
                    )
                failed = (ch["tri"] >= 0) & ~ok
                unresolved = jnp.sum(failed.astype(jnp.int32))
                ch["tri"] = jnp.where(failed, -1, ch["tri"])
                return _merge_gbuffers(g_base, band_untile(ch)), unresolved

            g_o = band_gbuffer(0)
            if flags.has_alpha_clip:
                g_o, miss = band_clip_peel(g_o, 2)
                diag["clip_unresolved"] = diag["clip_unresolved"] + miss
        else:
            alpha_fn = (
                _make_alpha_fn(scene, dl, uvs, w, h)
                if flags.has_alpha_clip
                else None
            )

            def raster_band(bucket_set, init_depth_tiles=None):
                mask = bucket_triangle_masks(
                    dl.tri_inst, dl.tri_bucket, visible, bucket_set
                )
                setup = setup_triangles(clip, dl.tri_vtx, mask, w, h, tw, th)
                bins = bin_triangles(
                    setup, tiles_x, tiles_y_padded, config.max_tiles_per_tri,
                    config.max_tris_per_tile, config.max_big_tris,
                )
                diag["big"] = jnp.maximum(
                    diag["big"], bins.big_tri_count.astype(jnp.int32)
                )
                diag["bin"] = jnp.maximum(diag["bin"], bins.max_bin_count)
                lst = jax.lax.dynamic_slice_in_dim(
                    bins.tile_tri_ids, t0, k_tiles, 0
                )
                cnt = jax.lax.dynamic_slice_in_dim(
                    bins.tile_tri_count, t0, k_tiles, 0
                )
                tri_ids, depths, barys = rasterize_tilelist(
                    setup, band_tiles, lst, cnt, bins.big_tri_ids,
                    bins.big_tri_count, w, h, tw, th,
                    alpha_coverage_fn=alpha_fn,
                    init_depth_tiles=init_depth_tiles,
                )

                def ut(a):
                    return untile_image(
                        a, tiles_x, rows_per_band, tw, th, tiles_x * tw, band_h
                    )[:, :w]

                vis = VisibilityBuffer(
                    tri_id=ut(tri_ids), depth=ut(depths), bary=ut(barys)
                )
                return setup, vis

            def gbuffer_for(vis, setup):
                return interpolate_gbuffer(
                    vis, setup, dl.tri_vtx, dl.tri_material, tri_scale,
                    world_pos, world_nrm, uvs, w, h, row_offset=row0_px,
                )

            setup_o, vis_o = raster_band((BUCKET_OPAQUE, BUCKET_ALPHA_CLIP))
            g_o = gbuffer_for(vis_o, setup_o)

        hdr_band = shade_band(g_o, shade_opaque_flat, ctx)

        if flags.has_transmission:
            # ---- distributed opaque pyramid (halos + one coarse gather) ----
            pool = _build_band_pyramid(hdr_band, pyr_spec, n_bands)

            def fb_sampler(uv, lod):
                return _sample_band_pyramid(pool, pyr_spec, band, uv, lod)

            init_tiles = tile_image(g_o.depth, tw, th)
            if use_kernel:
                g_t = band_gbuffer(1, init_tiles=init_tiles)
                if flags.has_alpha_clip:
                    g_t, miss_t = band_clip_peel(g_t, 3)
                    diag["clip_unresolved"] = diag["clip_unresolved"] + miss_t
            else:
                setup_t, vis_t = raster_band(
                    (BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP),
                    init_depth_tiles=init_tiles,
                )
                g_t = gbuffer_for(vis_t, setup_t)

            ctx_t = ctx._replace(
                tex_slots=flags.tex_slots_transmission,
                mat_matrix=build_material_matrix(
                    scene, flags.tex_slots_transmission, flags.slot_bundles
                ),
            )
            # Transmission shading stays DENSE per band (unlike the
            # single-chip block-sparse cap, render/frame.py): a band-local
            # cap cannot be bounded by frame-global coverage — one band
            # may legitimately be 100% glass while the frame is 13% — so
            # any cap below 1.0 breaks exactness, and at 1.0 the worklist
            # is the band. Dense per-band cost is also what makes the
            # sharded path load-BALANCED by construction: every chip does
            # identical FLOPs per pass regardless of where the glass sits
            # (the imbalance concern only applies to sparse formulations).
            px, py = _dense_coords(band_h, w)
            if use_rt:
                sun_f_t, light_f_t = band_shadow_factors(ctx_t, g_t)
                ctx_t = ctx_t._replace(
                    sun_shadow_factor=sun_f_t.reshape(-1),
                    light_shadow_factors=light_f_t.reshape(-1, lights.num),
                )
            hdr_t = shade_transmission_flat(
                scene, flatten_gbuffer(g_t), ctx_t, None, px, py + row0_px,
                fb_sampler=fb_sampler,
            ).reshape(band_h, w, 3)
            hdr_band = jnp.where(g_t.valid[..., None], hdr_t, hdr_band)

        ldr_band = lottes_tonemap(hdr_band, bake_lottes_params())
        # cross-band diagnostic reduction: capacities take the worst band
        # (the binning is replicated, so pmax is also a no-op there),
        # unresolved-pixel counts sum
        diag_vec = jnp.stack([
            jax.lax.pmax(diag["big"], "band"),
            jax.lax.pmax(diag["mid"], "band"),
            jax.lax.psum(diag["clip_unresolved"], "band"),
            jax.lax.pmax(diag["bin"], "band"),
            jax.lax.pmax(diag["tier"], "band"),
        ])
        return ldr_band, diag_vec

    shard = jax.shard_map(
        band_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=(P("band"), P()),
        check_vma=False,
    )
    ldr_padded, diag_vec = shard(scene, dl, params, lights, ggx_lut, bvh)
    if return_diagnostics:
        diags = FrameDiagnostics(
            max_bin_count=diag_vec[3],
            bin_capacity=0 if use_kernel else config.max_tris_per_tile,
            big_tri_count=diag_vec[0],
            big_tri_capacity=(
                config.pallas_tiers[-1][1] if use_kernel
                else config.max_big_tris
            ),
            opaque_blocks=jnp.int32(0),
            opaque_block_capacity=0,
            transmission_blocks=jnp.int32(0),
            transmission_block_capacity=0,
            clip_unresolved=diag_vec[2],
            mid_tri_count=diag_vec[1],
            mid_tri_capacity=config.pallas_max_mid_tris if use_kernel else 0,
            tier_overflow=diag_vec[4],
        )
        return ldr_padded[:h], diags
    return ldr_padded[:h]

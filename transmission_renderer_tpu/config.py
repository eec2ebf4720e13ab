"""Renderer configuration.

Mirrors the reference's CLI (``Opt``, reference src/main.rs:65-91) and its
compile-time constants (src/main.rs:56-63, shared-structs/src/lib.rs:322)
as one dataclass so scenes match the reference defaults exactly.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- framebuffer -------------------------------------------------------
    width: int = 1920
    height: int = 1080

    # --- projection (reference src/main.rs:39-57) --------------------------
    z_near: float = 0.01
    z_far: float = 500.0
    vertical_fov: float = math.radians(59.0)

    # --- clustered lighting grid (reference src/main.rs:60-63) -------------
    num_clusters_x: int = 24
    num_clusters_y: int = 16
    num_depth_slices: int = 16
    # reference shared-structs/src/lib.rs:322
    max_lights_per_cluster: int = 128

    # --- CLI-equivalent knobs (reference src/main.rs:65-91) ----------------
    # (--scale and --roughness-override act at ASSET-LOAD time — they are
    # parameters of load_gltf / the procedural builders, not frame state,
    # so they deliberately have no RenderConfig field)
    ray_traced_shadows: bool = False
    spotlights: bool = False
    rotate_model: bool = False
    debug_clusters: bool = False

    # --- raster tiling (no reference equivalent) ----------------------------
    # Tile size for the binned rasteriser: 8 x 128 = 1024 pixels, the
    # raster kernel's tile; every static cap below is sized for it.
    tile_h: int = 8
    tile_w: int = 128
    # Static capacity of the per-tile triangle bins (XLA raster path).
    # Triangles whose screen bounding box covers more tiles than
    # `max_tiles_per_tri` fall back to the (every-tile-visits-it)
    # big-triangle list, which is capped — raise max_big_tris for scenes
    # with many large triangles (overflow drops draws, like an undersized
    # indirect buffer would in the reference).
    max_tris_per_tile: int = 2048
    max_tiles_per_tri: int = 16
    # On the kernel path big triangles join the sorted record stream via
    # bbox-expanded pairs (max_big_tris * n_tiles pair slots feed the
    # binning sort — keep this modest); overflow beyond the cap drops
    # draws and is surfaced via FrameDiagnostics.big_tri_count.
    max_big_tris: int = 256

    # --- kernel-path binning tiers (ops/raster.py::bin_triangles) ----------
    # The sorted-pair stream's length sets the binning sort cost. Small
    # triangles emit K = pallas_tiles_per_tri pairs each; coverage in
    # (K, mid cap] tiles demotes to a mid tier (max_mid x cap pair slots);
    # larger ones to the giant tier (max_big x n_tiles slots). Tier
    # overflow drops draws and is surfaced via FrameDiagnostics
    # (mid_tri_count / big_tri_count).
    pallas_tiles_per_tri: int = 2
    pallas_mid_tile_cap: int = 128
    pallas_max_mid_tris: int = 512
    pallas_max_big_tris: int = 32
    # Demotion TIER LADDER (ops/raster.py::bin_triangles tiers=): each
    # (tile_cap, max_tris) rung holds triangles whose bbox coverage is in
    # (previous cap, tile_cap]; cap 0 = the full-screen catch-all. At the
    # flagship camera 97.9% of dragon triangles cover <= 2 tiles (the
    # true pair count is 0.13 M), so K=2 + this ladder feeds the binning
    # sort ~0.6 M slots instead of 1.7 M (K=8 + one 32 x n_tiles giant
    # tier). Rung overflow drops draws and is surfaced via
    # FrameDiagnostics.tier_overflow.
    pallas_tiers: tuple = ((8, 4096), (128, 512), (2048, 64), (0, 16))
    # Pair-stream compaction (ops/raster.py::bin_triangles): compact the
    # mostly-sentinel slot stream to frac * slots valid pairs before the
    # sort, so the sort scales with TRUE pair count (~25% of the dragon's
    # 529K slots) at the price of a cumsum and two scatters. Off by
    # default (not measured on the GPU). Exact while demand fits;
    # overflow drops pairs (FrameDiagnostics pair_demand vs capacity).
    pallas_pair_cap_frac: float | None = None

    # Rasteriser backend (utils/platform.py::use_raster_kernel): None =
    # the Triton tile kernel (ops/raster_pallas_gbuf.py) on a GPU when the
    # tile shape is the kernel's native 8x128, the XLA vmapped raster
    # otherwise. On the kernel path alpha-clip classes resolve via depth
    # peeling (render/frame.py::_rasterize_clip_peeled); the XLA path
    # tests coverage in-raster. True/False force the backend.
    use_pallas_raster: bool | None = None
    # Run the raster kernel in interpreter mode (CPU testing only).
    pallas_interpret: bool = False
    # Walk the full static bin capacity per tile instead of the dynamic
    # trip count. Exactly equivalent (bin padding is -1 and masked), but
    # avoids the batched while_loop that jax.experimental.checkify cannot
    # instrument — set by the --debug-checks sanitizer mode.
    static_raster_trips: bool = False
    # Sample the transmission pass's framebuffer mip fetch on a half-res
    # grid and bilinearly upsample. Near-lossless when the per-pixel LOD is
    # >= 1 (the fetched signal is already bandlimited below half-res) and
    # ~2.5x cheaper in gather cost; OFF by default for exact reference
    # sampling. Expect 1-px halos at glass silhouettes when enabled.
    half_res_refraction: bool = False
    # Share one material-texture tap per 2x2 pixel quad in the dense
    # opaque shade (quarters its gather count, the pass's dominant cost).
    # OFF by default for exact per-pixel sampling; error is sub-texel
    # except at quad-straddling material silhouettes.
    quad_material_taps: bool = False
    # Trace ray-traced shadow rays (--ray-tracing variant) on a half-res
    # pixel grid and bilinearly upsample the visibility factors: 4x fewer
    # rays through the batched BVH walk, the pass's dominant cost. OFF by
    # default for exact per-pixel rays; expect 1-px soft edges at shadow
    # boundaries and thin-occluder detail loss. Dense opaque pass only
    # (the sparse transmission worklist stays full-res).
    half_res_shadow_rays: bool = False
    # Skip shadow rays for (pixel, light) pairs whose G-buffer N·L <= 0.
    # NOT exact: the reference's ε-clamped dots + height-correlated Smith
    # visibility (V ~ 1/NoL as NoL -> ε) leave a finite specular term at
    # backfacing-light grazing-view pixels — measured max pixel delta
    # 9.6e-4, frame RMSE ~1e-5 on the test scene (tests/test_rt_shadows
    # ::test_nol_gate_error_bound), inside the 1e-3 budget but visible to
    # bit-level goldens, so OFF by default. Applied only to the opaque
    # pass of normal-map-free scenes (the shade's N·L uses the perturbed
    # normal; the transmission BTDF mirrors the light direction).
    nol_shadow_gate: bool = False

    # --- block-sparse shading (render/sparse.py) ----------------------------
    # The reference shades only covered fragments (raster hardware +
    # depth pre-pass, readme.md:74); these caps recover that economics by
    # compacting 128-pixel blocks containing active pixels into a static
    # worklist sized cap_frac * num_blocks. Exact while the active block
    # count fits the cap; overflow leaves blocks unshaded and is reported
    # via FrameDiagnostics (the analogue of an undersized indirect
    # DrawBuffer, src/main.rs:2423-2476). None = dense shading.
    # Transmissive coverage is almost always a small screen fraction, so
    # the transmission pass defaults to sparse; opaque coverage can reach
    # 100%, so it defaults to dense (enable per scene/camera). The 0.25
    # default is ~2x the flagship scenes' worst measured coverage (dragon
    # fills 13.4% of blocks at 1080p); the shade cost scales with the cap,
    # and an overflowing scene says so in FrameDiagnostics — raise it
    # per scene when glass fills the frame.
    opaque_block_cap_frac: float | None = None
    transmission_block_cap_frac: float | None = 0.25

    # --- sparse-tile raster passes (render/frame.py) -------------------------
    # Classes whose coverage is a small screen fraction (transmission,
    # usually alpha-clip) raster a compacted worklist of only the tiles
    # holding >= 1 record of that class (counts are free: they're the
    # class-split ``tile_start`` runs) instead of every tile of the grid.
    # Exact while the active-tile count fits cap_frac * n_tiles (256-tile
    # floor); overflow drops tiles and is surfaced via FrameDiagnostics.
    # None = dense (every tile).
    transmission_tile_cap_frac: float | None = 0.25
    clip_tile_cap_frac: float | None = 0.5
    sparse_raster_tile_floor: int = 256

    # --- alpha-clip depth peeling (render/frame.py) --------------------------
    # Rounds of race -> alpha-test -> re-race for alpha-clip draw classes
    # on the kernel path. Exact while the number of alpha-rejected layers
    # in front of the true winner stays below this; leftovers fall through
    # to the layer below and are counted in FrameDiagnostics.
    alpha_clip_rounds: int = 4
    # Static capacity of the failing-tile re-race list, as a fraction of
    # the tile grid (overflowing tiles keep their previous winner and are
    # caught by the unresolved-pixel diagnostic). A tuple schedules
    # per-round caps (round r uses entry min(r-1, last)): demand
    # collapses after the first peels, so late rounds can run at small
    # caps nearly for free. FrameDiagnostics.clip_round_demand reports
    # the actual per-round failing-tile counts against these caps.
    clip_retile_cap_frac: float | tuple = (0.30, 0.08, 0.02)

    # --- multi-chip (parallel/sharded.py) -----------------------------------
    # Row halo exchanged between neighbour bands for the distributed mip
    # pyramid: cross-band refraction fetches within this many level-0
    # pixels of the band are exact; farther ones clamp to the halo edge.
    sharded_refraction_halo_px: int = 64

    # --- GGX split-sum LUT -------------------------------------------------
    # Sampled size of the reference's 1024^2 ggx_lut.png asset. The default
    # 256 box-reduces it (bilinear-sampled error ~1e-4, below the asset's
    # own 8-bit quantisation — utils/ggx_lut.py); set None for the
    # native-resolution table when a strict-parity run should sample the
    # identical texels the reference does.
    ggx_lut_size: int | None = 256

    # --- precision ---------------------------------------------------------
    # The RMSE-critical shading chain stays float32 (SURVEY.md section 7,
    # hard part 6); bf16 is only used where it cannot affect fidelity.
    dtype: str = "float32"
    # Evaluate the per-light BRDF/BTDF cores (basic_brdf /
    # transmission_btdf, the light loop's arithmetic bulk) in bfloat16,
    # accumulating per-light contributions in f32. Light directions,
    # attenuation and spot factors stay f32 (they are cheap and their
    # error would multiply the whole contribution). Spends the BASELINE
    # RMSE budget (< 1e-3 frame-wide, BASELINE.md) rather than bit
    # precision; the measured bound is pinned by
    # tests/test_goldens.py::test_bf16_light_math_error_bound.
    bf16_light_math: bool = False

    @property
    def num_clusters(self) -> int:
        return self.num_clusters_x * self.num_clusters_y * self.num_depth_slices

    @property
    def framebuffer_size(self) -> tuple[int, int]:
        return (self.width, self.height)

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def cluster_size_in_pixels(self) -> tuple[float, float]:
        # reference src/main.rs:540-542
        return (
            self.width / self.num_clusters_x,
            self.height / self.num_clusters_y,
        )


# Bindless image table capacity (reference src/main.rs:59). This renderer
# uses a flat texel atlas rather than a descriptor table, so this is only a
# default metadata-table size, not a hard limit.
MAX_IMAGES = 193

# Draw-bucket indices (reference src/model_loading.rs:68-78).
BUCKET_OPAQUE = 0
BUCKET_ALPHA_CLIP = 1
BUCKET_TRANSMISSION = 2
BUCKET_TRANSMISSION_ALPHA_CLIP = 3
NUM_DRAW_BUCKETS = 4

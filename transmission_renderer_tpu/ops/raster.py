"""Tile-binned visibility-buffer rasterisation (pure-JAX reference path).

Replaces the fixed-function triangle raster + depth test + indirect-draw
machinery the reference gets from Vulkan (SURVEY.md §2.5): the design
is a clipless homogeneous rasteriser (Olano-Greer style 2D-H edge
functions) producing a *visibility buffer* (triangle id + perspective
barycentrics + depth); shading happens in a separate dense per-pixel pass.

Key properties:
  * No near-plane clipping: edge functions are built from the clip-space
    (x, y, w) adjugate, so triangles crossing w=0 rasterise correctly and
    pixels behind the eye are rejected by the interpolated-w sign test.
  * Reversed-Z GREATER depth test (the reference's pre-pass policy,
    src/pipelines.rs:356-360), ties broken by triangle order (matching
    draw order + EQUAL-depth colour pass semantics).
  * No atomics: binning is sort-based, the depth race is a fori_loop
    max-reduction carried per tile.

Conventions: Vulkan viewport — NDC (-1,-1) maps to the top-left framebuffer
corner, pixel centres at integer+0.5, depth in [0,1] with 1 = near
(reversed-Z projection, src/main.rs:39-54).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class TriangleSetup(NamedTuple):
    """Per-triangle rasterisation constants (all [T, ...])."""

    # Adjugate rows of the clip-space [[x],[y],[w]] matrix: e_i(ndc) =
    # adj[i] . (nx, ny, 1) are the (unnormalised) perspective-correct
    # barycentric weights.
    adj: jnp.ndarray  # [T, 3, 3]
    z_clip: jnp.ndarray  # [T, 3] clip-space z of the 3 vertices
    w_clip: jnp.ndarray  # [T, 3] clip-space w
    valid: jnp.ndarray  # [T] bool (non-degenerate, front-facing, uncensored)
    tile_bbox: jnp.ndarray  # [T, 4] int32 (tx0, ty0, tx1, ty1) inclusive


class VisibilityBuffer(NamedTuple):
    tri_id: jnp.ndarray  # [H, W] int32, -1 = background
    depth: jnp.ndarray  # [H, W] f32 reversed-Z (0 = cleared/far)
    bary: jnp.ndarray  # [H, W, 2] perspective-correct (b1, b2)


def _adjugate3(m: jnp.ndarray) -> jnp.ndarray:
    """Adjugate of [..., 3, 3]: adj @ m = det * I."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return jnp.stack(
        [
            jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        axis=-2,
    )


def setup_triangles(
    clip_positions: jnp.ndarray,  # [V, 4] clip-space vertex positions
    tri_vertices: jnp.ndarray,  # [T, 3] int32 indices
    tri_enabled: jnp.ndarray,  # [T] bool (instance visibility x bucket mask)
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    cull_backfaces: bool = True,
) -> TriangleSetup:
    """Per-triangle setup: adjugate edge matrix, orientation cull, tile bbox.

    Backface orientation: with Vulkan's y-down framebuffer and the
    reference's y-flipping projection (src/main.rs:49), a mesh wound CCW
    when viewed from outside projects with det(M) < 0 for front faces;
    other triangles are culled (cull_mode BACK, src/pipelines.rs:311).
    """
    v = clip_positions[tri_vertices]  # [T, 3, 4]
    x = v[..., 0]
    y = v[..., 1]
    z = v[..., 2]
    w = v[..., 3]

    m = jnp.stack([x, y, w], axis=-2)  # [T, 3(xyw), 3(vertex)]
    det = jnp.linalg.det(m)
    adj = _adjugate3(m)

    # Orientation: glTF front faces are CCW in a right-handed y-up world;
    # under the reference's y-flipping projection (src/main.rs:49) they
    # project with det(M) < 0 (worked example in tests/test_raster.py).
    # Interior perspective weights are s = adj(M) q / det, so we flip the
    # adjugate's sign as needed to make interior edge values positive.
    if cull_backfaces:
        orient_ok = det < 0.0
        adj_signed = -adj
    else:
        orient_ok = det != 0.0
        adj_signed = jnp.where(det[..., None, None] > 0, adj, -adj)

    valid = tri_enabled & orient_ok

    # Conservative screen bbox in tile units. Vertices with w <= 0 make the
    # projected bbox unbounded -> fall back to the full screen.
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    safe_w = jnp.maximum(w, 1e-30)
    sx = (x / safe_w + 1.0) * (0.5 * width)
    sy = (y / safe_w + 1.0) * (0.5 * height)
    any_behind = jnp.any(w <= 1e-6, axis=-1)

    x0 = jnp.where(any_behind, 0.0, jnp.min(sx, axis=-1))
    x1 = jnp.where(any_behind, float(width), jnp.max(sx, axis=-1))
    y0 = jnp.where(any_behind, 0.0, jnp.min(sy, axis=-1))
    y1 = jnp.where(any_behind, float(height), jnp.max(sy, axis=-1))

    tx0 = jnp.clip(jnp.floor(x0 / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    ty0 = jnp.clip(jnp.floor(y0 / tile_h).astype(jnp.int32), 0, tiles_y - 1)
    tx1 = jnp.clip(jnp.floor((x1 - 1e-6) / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    ty1 = jnp.clip(jnp.floor((y1 - 1e-6) / tile_h).astype(jnp.int32), 0, tiles_y - 1)

    # Off-screen cull: bbox entirely outside (only meaningful when all w>0).
    on_screen = (x1 > 0) & (x0 < width) & (y1 > 0) & (y0 < height)
    valid = valid & (any_behind | on_screen)
    # Behind-eye cull (exact): with every w <= 0, interior weights e >= 0
    # give w_interp = sum(e_i w_i) <= 0, and coverage requires
    # w_interp > 0 — such a triangle can never produce a fragment, yet
    # its unbounded bbox would demote it to the big/giant tier.
    valid = valid & ~jnp.all(w <= 0.0, axis=-1)

    return TriangleSetup(
        adj=adj_signed,
        z_clip=z,
        w_clip=w,
        valid=valid,
        tile_bbox=jnp.stack([tx0, ty0, tx1, ty1], axis=-1),
    )


class TileBins(NamedTuple):
    """Sorted-pair triangle bins + an every-tile 'big triangle' list."""

    tile_tri_ids: jnp.ndarray  # [n_tiles, max_tris_per_tile] int32
    tile_tri_count: jnp.ndarray  # [n_tiles] int32
    big_tri_ids: jnp.ndarray  # [max_big_tris] int32 (-1 padded)
    big_tri_count: jnp.ndarray  # [] int32
    # raw sorted pairs, consumed by the Pallas raster path
    sorted_tri_ids: jnp.ndarray  # [T*K] int32
    tile_start: jnp.ndarray  # [n_tiles + 1] int32
    # diagnostics: the busiest tile's UNCLAMPED count. If this exceeds
    # max_tris_per_tile, the materialised JAX-path bins silently dropped
    # triangles (like an undersized indirect buffer would); the Pallas
    # path is unaffected (it reads tile_start directly).
    # (default is a plain int: creating a jnp scalar at import time would
    # initialise the backend before callers can select one)
    max_bin_count: jnp.ndarray | int = 0
    # unclamped demand of the mid-size demotion tier (Pallas path with
    # mid_tile_cap > 0); demand above max_mid_tris means dropped draws
    mid_tri_count: jnp.ndarray | int = 0
    # tier-ladder diagnostics (Pallas path with ``tiers``): unclamped
    # per-tier triangle demand and the static slot counts to compare
    # against (demand > slots = dropped draws)
    tier_demands: tuple = ()
    tier_slots: tuple = ()
    # pair-stream compaction diagnostics (``pair_cap_frac``): unclamped
    # valid-pair demand vs the compacted stream's static capacity
    # (demand > capacity = dropped pairs)
    pair_demand: jnp.ndarray | int = 0
    pair_capacity: int = 0


def bin_triangles(
    setup: TriangleSetup,
    tiles_x: int,
    tiles_y: int,
    max_tiles_per_tri: int,
    max_tris_per_tile: int,
    max_big_tris: int,
    materialize: bool = True,
    class_flags: jnp.ndarray | None = None,
    num_classes: int = 2,
    mid_tile_cap: int = 0,
    max_mid_tris: int = 0,
    tiers: tuple | None = None,
    pair_cap_frac: float | None = None,
) -> TileBins:
    """Sort-based binning (the replacement for the reference's
    atomic-append compaction, SURVEY.md §2.6).

    Each triangle emits up to K = max_tiles_per_tri (tile, tri) pairs from
    its tile bbox; pairs sort by tile; per-tile ranges come from a
    searchsorted. Triangles covering more than K tiles go to the
    big-triangle list that every tile also walks — there are few of these
    (large floors/walls), so the cost is bounded.

    ``class_flags`` ([T] int in [0, num_classes), Pallas path) splits
    every tile's record run by draw class: the sort key becomes
    tile*num_classes + class and ``tile_start`` gets
    num_classes*n_tiles+1 entries, so each raster pass streams ONLY its
    class's records instead of filtering other classes record-by-record
    in the kernel — the depth pre-pass / transmissive pre-pass split (and
    the alpha-clip peeling classes) without rewalking shared bins.
    """
    n_tiles = tiles_x * tiles_y
    num_tris = setup.adj.shape[0]
    k = max_tiles_per_tri

    tx0, ty0, tx1, ty1 = (setup.tile_bbox[:, i] for i in range(4))
    bw = tx1 - tx0 + 1
    bh = ty1 - ty0 + 1
    coverage = bw * bh
    is_big = setup.valid & (coverage > k)
    in_bins = setup.valid & (coverage <= k)

    # Expand: pair slot j of triangle t covers tile (tx0 + j % bw, ty0 + j / bw)
    slot = jnp.arange(k, dtype=jnp.int32)[None, :]  # [1, K]
    jx = slot % bw[:, None]
    jy = slot // bw[:, None]
    tile_id = (ty0[:, None] + jy) * tiles_x + (tx0[:, None] + jx)
    if class_flags is not None:
        n_bins = num_classes * n_tiles
        bin_id = tile_id * num_classes + class_flags.astype(jnp.int32)[:, None]
    else:
        n_bins = n_tiles
        bin_id = tile_id
    pair_valid = in_bins[:, None] & (slot < coverage[:, None])
    bin_id = jnp.where(pair_valid, bin_id, n_bins)  # sentinel sorts last

    tri_ids = jnp.broadcast_to(
        jnp.arange(num_tris, dtype=jnp.int32)[:, None], (num_tris, k)
    )
    # barrier pins the [T, K] -> [T*K] flatten AFTER the 2-D compute:
    # without it XLA hoists the relayout past the where/arithmetic and
    # pays one [T*K] relayout PER upstream op (~10 x 0.09 ms of the
    # dragon's binning scope) instead of one per array
    bin_id = jax.lax.optimization_barrier(bin_id)
    flat_bins = bin_id.reshape(-1)
    flat_tris = tri_ids.reshape(-1)

    mid_demand = jnp.zeros((), jnp.int32)
    tier_demands: list = []
    tier_slots: list = []
    if tiers is not None:
        assert not materialize, "tier ladder is a Pallas-path feature"
        assert tiers[-1][0] == 0, (
            "the final tier must be the full-screen catch-all (cap 0)"
        )
    if not materialize:
        # Demoted triangles join the SAME sorted stream via bbox-expanded
        # pairs. The kernels then walk no per-tile big list at all — the
        # old every-tile-walks-every-big-record loop cost ~1.2 us per tile
        # per record (~19 ms/pass at 1080p with a handful of walls).
        # With ``mid_tile_cap`` > 0 demotion is TIERED: coverage in
        # (k, mid_tile_cap] -> a mid list of max_mid_tris slots at
        # mid_tile_cap pairs each, coverage > mid_tile_cap -> the giant
        # list at n_tiles pairs each. One flat worst-case tier would feed
        # the sort max_big_tris * n_tiles pair slots (0.5M at 1080p —
        # ~40% of the whole sort for a scene with 3 walls); the mid tier
        # keeps K small for the millions of tiny triangles without
        # paying full-screen slots for every mid-size one.
        def expand_pairs(tri, slots):
            """bbox-expanded (bin, tri) pairs for a [cap] compacted
            triangle list (num_tris = empty slot)."""
            cap = tri.shape[0]
            safe = jnp.minimum(tri, num_tris - 1)
            btx0, bty0, btx1, bty1 = (
                setup.tile_bbox[safe, i] for i in range(4)
            )
            bbw = btx1 - btx0 + 1
            slot_b = jnp.arange(slots, dtype=jnp.int32)[None, :]  # [1, S]
            bjx = slot_b % bbw[:, None]
            bjy = slot_b // bbw[:, None]
            tile = (bty0[:, None] + bjy) * tiles_x + (btx0[:, None] + bjx)
            cov_b = bbw * (bty1 - bty0 + 1)
            bvalid = (tri[:, None] < num_tris) & (slot_b < cov_b[:, None])
            if class_flags is not None:
                bcls = class_flags.astype(jnp.int32)[safe]
                bin_b = tile * num_classes + bcls[:, None]
            else:
                bin_b = tile
            bin_b = jnp.where(bvalid, bin_b, n_bins)
            tri_b = jnp.broadcast_to(tri[:, None], (cap, slots)).astype(
                jnp.int32
            )
            # pin the flatten point (same relayout hoist as the main
            # stream's barrier above)
            bin_b = jax.lax.optimization_barrier(bin_b)
            return bin_b.reshape(-1), tri_b.reshape(-1)

        # Demotion ladder as (lo_cap, hi_cap, max_n) spans. The tier
        # ladder comes from ``tiers``; the legacy mid/giant pair and the
        # single giant list are expressed as 2-/1-span ladders so every
        # path shares one compaction below.
        spans: list = []
        prev_cap = k
        if tiers is not None:
            # TIER LADDER: coverage in (prev_cap, cap] demotes to a tier
            # of `cap` pair slots x `max_n` triangles; cap 0 = full
            # screen (the final catch-all). Finer ladders keep the
            # sorted-pair stream near its EXACT pair count: one flat
            # worst-case tier costs max_n * n_tiles slots even when the
            # scene has 3 walls (0.5 M slots at 1080p — ~40% of the old
            # sort), and the dragon's true pair count is 0.13 M.
            for cap_tiles, max_n in tiers:
                cap_tiles = n_tiles if cap_tiles == 0 else min(
                    cap_tiles, n_tiles
                )
                if cap_tiles <= prev_cap:
                    continue
                spans.append((prev_cap, cap_tiles, max_n))
                prev_cap = cap_tiles
        elif 0 < mid_tile_cap < n_tiles and max_mid_tris > 0:
            spans.append((k, mid_tile_cap, max_mid_tris))
            spans.append((mid_tile_cap, n_tiles, max_big_tris))
        else:
            spans.append((k, n_tiles, max_big_tris))

        # ONE compaction scatter shared by every tier: the per-tier
        # selections are disjoint, so each triangle gets at most one
        # destination slot (tier offset + rank within tier) and a single
        # unique-index scatter compacts all tiers at once. (Three
        # per-tier stable_partition_perm scatters measured 0.79 ms EACH
        # on the dragon — the scatter, not the sort, was the binning
        # wall.) Unselected triangles get a unique out-of-bounds slot so
        # mode="drop" discards them.
        total_slots = sum(mn for _, _, mn in spans)
        arange_t = jnp.arange(num_tris, dtype=jnp.int32)
        pos = arange_t + jnp.int32(total_slots)
        demands = []
        off = 0
        for lo, hi, mn in spans:
            sel = is_big & (coverage > lo) & (coverage <= hi)
            csum = jnp.cumsum(sel.astype(jnp.int32))
            rank = csum - 1
            demands.append(csum[-1])
            pos = jnp.where(sel & (rank < mn), off + rank, pos)
            off += mn
        compact = (
            jnp.full((total_slots,), num_tris, jnp.int32)
            .at[pos]
            .set(arange_t, mode="drop", unique_indices=True)
        )

        parts_b, parts_t = [flat_bins], [flat_tris]
        off = 0
        for (lo, hi, mn), demand in zip(spans, demands):
            tb, tt = expand_pairs(compact[off : off + mn], hi)
            off += mn
            parts_b.append(tb)
            parts_t.append(tt)
            if tiers is not None:
                tier_demands.append(demand)
                tier_slots.append(mn)
        giant_demand = (
            demands[-1]
            if spans[-1][1] == n_tiles
            else jnp.zeros((), jnp.int32)
        )
        if tiers is None and len(spans) == 2:
            mid_demand = demands[0]
        flat_bins = jnp.concatenate(parts_b)
        flat_tris = jnp.concatenate(parts_t)
        # demoted pairs carry sentinel tri = num_tris where invalid;
        # map them to the sorted sentinel (-1 handled by payload pad)
        flat_tris = jnp.where(flat_tris >= num_tris, -1, flat_tris)

    pair_demand = jnp.zeros((), jnp.int32)
    pair_capacity = 0
    if not materialize and pair_cap_frac is not None:
        # Pair-stream COMPACTION before the sort: the slot stream is
        # mostly sentinels (K slots per triangle regardless of coverage,
        # plus culled triangles — the dragon's true pair count is ~17%
        # of its 0.76M slots), and the sort + the payload gather both
        # scale with STREAM LENGTH, not valid pairs. One cumsum + two
        # unique-index scatters (~0.8 ms each at 0.76M, cheaper than the
        # ~5 ms sort tail they delete) compact valid pairs into a static
        # [cap] buffer. Exact while demand fits the cap; overflow drops
        # pairs and is surfaced via pair_demand (FrameDiagnostics).
        s_len = int(flat_bins.shape[0])
        pair_capacity = min(s_len, max(int(s_len * pair_cap_frac) + 1, 1 << 16))
        if pair_capacity < s_len:
            valid = flat_bins < n_bins
            pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
            pair_demand = (pos[-1] + 1).astype(jnp.int32)
            # unique out-of-bounds targets for unselected slots so
            # mode="drop" discards them (same trick as the tier
            # compaction above)
            arange_s = jnp.arange(s_len, dtype=jnp.int32)
            tgt = jnp.where(
                valid & (pos < pair_capacity),
                pos,
                pair_capacity + arange_s,
            )
            flat_bins = (
                jnp.full((pair_capacity,), n_bins, jnp.int32)
                .at[tgt]
                .set(flat_bins, mode="drop", unique_indices=True)
            )
            flat_tris = (
                jnp.full((pair_capacity,), -1, jnp.int32)
                .at[tgt]
                .set(flat_tris, mode="drop", unique_indices=True)
            )
        else:
            pair_capacity = 0

    # Two-key sort: (bin, tri) — tri-ascending within a bin IS draw order
    # (free of the 31-bit packing constraint of a packed-key sort).
    sorted_bins, sorted_tris = jax.lax.sort(
        [flat_bins, flat_tris], num_keys=2
    )

    tile_start = jnp.searchsorted(
        sorted_bins, jnp.arange(n_bins + 1, dtype=jnp.int32)
    ).astype(jnp.int32)

    raw_counts = tile_start[1:] - tile_start[:-1]
    counts = jnp.minimum(raw_counts, max_tris_per_tile)

    assert not (materialize and class_flags is not None), (
        "class-split bins are a Pallas-path feature (tile_start indexing)"
    )
    if materialize:
        # Fixed-size per-tile lists for the JAX raster path. NOTE: this
        # caps each tile at max_tris_per_tile (overflow drops triangles);
        # the Pallas path reads tile_start directly and has no cap.
        gather_idx = tile_start[:-1, None] + jnp.arange(max_tris_per_tile)[None, :]
        in_range = jnp.arange(max_tris_per_tile)[None, :] < counts[:, None]
        gather_idx = jnp.clip(gather_idx, 0, sorted_tris.shape[0] - 1)
        tile_tri_ids = jnp.where(in_range, sorted_tris[gather_idx], -1)
    else:
        tile_tri_ids = jnp.zeros((1, 1), jnp.int32)

    if materialize:
        # Big-triangle list: order-preserving compaction of is_big (the
        # JAX raster path walks this per tile).
        big_order = jnp.argsort(~is_big, stable=True)
        big_ids = jnp.where(
            jnp.arange(num_tris) < jnp.sum(is_big), big_order.astype(jnp.int32), -1
        )[:max_big_tris]
        if num_tris < max_big_tris:
            big_ids = jnp.pad(
                big_ids, (0, max_big_tris - num_tris), constant_values=-1
            )
        big_count = jnp.minimum(jnp.sum(is_big), max_big_tris).astype(jnp.int32)
    else:
        # Pallas path: big triangles ride the sorted stream (above); the
        # length-1 all(-1) list tells kernels there is no big walk. The
        # count keeps the UNCLAMPED demand for overflow diagnostics
        # (demand > max_big_tris means dropped draws).
        big_ids = jnp.full((1,), -1, jnp.int32)
        big_count = giant_demand.astype(jnp.int32)

    return TileBins(
        tile_tri_ids=tile_tri_ids,
        tile_tri_count=counts.astype(jnp.int32),
        big_tri_ids=big_ids,
        big_tri_count=big_count,
        sorted_tri_ids=sorted_tris,
        tile_start=tile_start,
        max_bin_count=jnp.max(raw_counts).astype(jnp.int32),
        mid_tri_count=jnp.asarray(mid_demand, jnp.int32),
        tier_demands=tuple(tier_demands) if not materialize else (),
        tier_slots=tuple(tier_slots) if not materialize else (),
        pair_demand=pair_demand,
        pair_capacity=pair_capacity,
    )


def _raster_tile(
    tile_idx: jnp.ndarray,  # [] int32
    tri_list: jnp.ndarray,  # [MTT] int32 (-1 padded)
    tri_count: jnp.ndarray,  # [] int32
    init_depth_tile,  # None or [TH, TW] f32 pre-existing depth
    big_list: jnp.ndarray,  # [B] int32
    big_count: jnp.ndarray,  # [] int32
    setup: TriangleSetup,
    alpha_ref,  # None or (coverage_fn) — see rasterize()
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    tiles_x: int,
    static_trips: bool = False,
):
    """Rasterise one tile_h x tile_w tile; returns (tri_id, depth, bary)."""
    ty = tile_idx // tiles_x
    tx = tile_idx % tiles_x

    px = tx * tile_w + jnp.arange(tile_w, dtype=jnp.float32)[None, :] + 0.5
    py = ty * tile_h + jnp.arange(tile_h, dtype=jnp.float32)[:, None] + 0.5
    # pixel centre -> NDC (Vulkan y-down viewport)
    nx = px * (2.0 / width) - 1.0  # [1, TW] -> broadcast
    ny = py * (2.0 / height) - 1.0  # [TH, 1]
    nx = jnp.broadcast_to(nx, (tile_h, tile_w))
    ny = jnp.broadcast_to(ny, (tile_h, tile_w))

    # Cleared reversed-Z depth = 0 (far); a pre-pass depth buffer may be
    # threaded in so new fragments must beat the existing surface (the
    # transmissive depth pre-pass runs against the opaque depth,
    # src/main.rs:2005-2042).
    init_d = (
        jnp.zeros((tile_h, tile_w), jnp.float32)
        if init_depth_tile is None
        else init_depth_tile
    )
    init = (
        jnp.full((tile_h, tile_w), -1, jnp.int32),
        init_d,
        jnp.zeros((tile_h, tile_w, 2), jnp.float32),
    )

    def body(tri, enabled, carry):
        best_tri, best_depth, best_bary = carry
        safe_tri = jnp.maximum(tri, 0)
        adj = setup.adj[safe_tri]  # [3, 3]
        z = setup.z_clip[safe_tri]
        w = setup.w_clip[safe_tri]

        e0 = adj[0, 0] * nx + adj[0, 1] * ny + adj[0, 2]
        e1 = adj[1, 0] * nx + adj[1, 1] * ny + adj[1, 2]
        e2 = adj[2, 0] * nx + adj[2, 1] * ny + adj[2, 2]

        # Top-left fill rule: e > 0, or e == 0 on a top/left edge. A tie on
        # edge i means the pixel centre lies exactly on the line. With the
        # interior-positive edges and Y-DOWN ndc used here (ny grows with
        # py), a LEFT edge has interior to its right (a > 0) and a TOP
        # edge is horizontal with interior below it (a == 0, b > 0) —
        # matching Vulkan's rule (an earlier version used b < 0, which
        # covered bottom edges instead).
        def covered(e, a, b):
            tl = (a > 0) | ((a == 0) & (b > 0))
            return (e > 0) | ((e == 0) & tl)

        inside = (
            covered(e0, adj[0, 0], adj[0, 1])
            & covered(e1, adj[1, 0], adj[1, 1])
            & covered(e2, adj[2, 0], adj[2, 1])
        )

        w_interp = e0 * w[0] + e1 * w[1] + e2 * w[2]
        z_interp = e0 * z[0] + e1 * z[1] + e2 * z[2]
        depth = z_interp / w_interp
        # reject behind-eye and outside depth range (z clip)
        inside &= (w_interp > 0) & (depth >= 0.0) & (depth <= 1.0)

        esum = e0 + e1 + e2
        b1 = e1 / esum
        b2 = e2 / esum

        if alpha_ref is not None:
            # the callback also receives the NDC pixel coords and this
            # triangle's adjugate so it can derive analytic uv
            # derivatives (implicit-LOD alpha test, matching the
            # reference's `.sample` and the Pallas peel path)
            inside &= alpha_ref(safe_tri, b1, b2, nx, ny, adj)

        # GREATER depth test (reversed-Z), first-wins on ties (draw
        # order = triangle id). Within each list ids ascend, so strict
        # GREATER alone keeps the earlier id — but the big list is
        # walked AFTER the binned list, so an exact cross-list depth tie
        # (coplanar decal vs demoted wall) needs the explicit id
        # tie-break to match the reference's draw order (and the Pallas
        # kernel, whose demoted records ride the id-sorted stream).
        # best_tri = -1 (no incumbent) never tie-breaks: tri < -1 is
        # false, preserving GREATER-vs-cleared semantics.
        win = enabled & inside & (
            (depth > best_depth) | ((depth == best_depth) & (tri < best_tri))
        )
        best_tri = jnp.where(win, tri, best_tri)
        best_depth = jnp.where(win, depth, best_depth)
        new_bary = jnp.stack([b1, b2], axis=-1)
        best_bary = jnp.where(win[..., None], new_bary, best_bary)
        return (best_tri, best_depth, best_bary)

    # Dynamically-bounded loops: under vmap these become a single batched
    # while_loop whose trip count is max(count) over tiles — far cheaper
    # than always walking the full static bin capacity. ``static_trips``
    # walks the full capacity instead (bin padding is -1, so the
    # ``enabled`` mask makes both exactly equivalent); checkify cannot
    # instrument batched while-loops, so the debug-checks mode needs it.
    n_tri = tri_list.shape[0] if static_trips else tri_count
    n_big = big_list.shape[0] if static_trips else big_count
    carry = jax.lax.fori_loop(
        0,
        n_tri,
        lambda j, c: body(tri_list[j], tri_list[j] >= 0, c),
        init,
    )
    carry = jax.lax.fori_loop(
        0,
        n_big,
        lambda j, c: body(big_list[j], big_list[j] >= 0, c),
        carry,
    )
    return carry


def tile_image(img: jnp.ndarray, tile_w: int, tile_h: int) -> jnp.ndarray:
    """[H, W, ...] -> [n_tiles, tile_h, tile_w, ...] (zero-padded)."""
    h, w = img.shape[:2]
    tiles_x = -(-w // tile_w)
    tiles_y = -(-h // tile_h)
    pad = [(0, tiles_y * tile_h - h), (0, tiles_x * tile_w - w)] + [
        (0, 0)
    ] * (img.ndim - 2)
    img = jnp.pad(img, pad)
    img = img.reshape(
        (tiles_y, tile_h, tiles_x, tile_w) + img.shape[2:]
    )
    img = jnp.swapaxes(img, 1, 2)
    return img.reshape((tiles_y * tiles_x, tile_h, tile_w) + img.shape[4:])


def rasterize_tilelist(
    setup: TriangleSetup,
    tile_indices: jnp.ndarray,  # [K] int32 global tile ids (row-major)
    tile_tri_ids: jnp.ndarray,  # [K, MTT]
    tile_tri_count: jnp.ndarray,  # [K]
    big_tri_ids: jnp.ndarray,
    big_tri_count: jnp.ndarray,
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    alpha_coverage_fn=None,
    init_depth_tiles: jnp.ndarray | None = None,  # [K, TH, TW]
    static_trip_counts: bool = False,
):
    """Rasterise an arbitrary list of tiles (the building block shared by
    the single-chip path and the shard_map row-band path). Returns
    (tri_id [K, TH, TW], depth, bary [K, TH, TW, 2])."""
    tiles_x = -(-width // tile_w)
    if init_depth_tiles is not None:
        return jax.vmap(
            lambda i, lst, cnt, dep: _raster_tile(
                i, lst, cnt, dep, big_tri_ids, big_tri_count, setup,
                alpha_coverage_fn, width, height, tile_w, tile_h, tiles_x,
                static_trip_counts,
            )
        )(tile_indices, tile_tri_ids, tile_tri_count, init_depth_tiles)
    return jax.vmap(
        lambda i, lst, cnt: _raster_tile(
            i, lst, cnt, None, big_tri_ids, big_tri_count, setup,
            alpha_coverage_fn, width, height, tile_w, tile_h, tiles_x,
            static_trip_counts,
        )
    )(tile_indices, tile_tri_ids, tile_tri_count)


def untile_image(a: jnp.ndarray, tiles_x: int, tiles_y: int, tile_w: int,
                 tile_h: int, width: int, height: int) -> jnp.ndarray:
    """[n_tiles, th, tw, ...] -> [height, width, ...] (row-major tiles)."""
    extra = a.shape[3:]
    a = a.reshape((tiles_y, tiles_x, tile_h, tile_w) + extra)
    a = jnp.swapaxes(a, 1, 2).reshape((tiles_y * tile_h, tiles_x * tile_w) + extra)
    return a[:height, :width]


def rasterize(
    setup: TriangleSetup,
    bins: TileBins,
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    alpha_coverage_fn=None,
    init_depth: jnp.ndarray | None = None,
    static_trip_counts: bool = False,
) -> VisibilityBuffer:
    """Rasterise all tiles (vmapped) into a visibility buffer.

    ``alpha_coverage_fn(tri_id, b1, b2, nx, ny, adj) -> bool`` implements
    alpha-clip kill during rasterisation (depth_pre_pass_alpha_clip,
    shader/src/lib.rs:270-295); None for fully opaque batches.
    ``init_depth`` ([H, W]) seeds the depth race with an existing surface.
    """
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    n_tiles = tiles_x * tiles_y

    init_tiles = (
        tile_image(init_depth, tile_w, tile_h) if init_depth is not None else None
    )
    tri_ids, depths, barys = rasterize_tilelist(
        setup,
        jnp.arange(n_tiles, dtype=jnp.int32),
        bins.tile_tri_ids,
        bins.tile_tri_count,
        bins.big_tri_ids,
        bins.big_tri_count,
        width, height, tile_w, tile_h,
        alpha_coverage_fn=alpha_coverage_fn,
        init_depth_tiles=init_tiles,
        static_trip_counts=static_trip_counts,
    )

    def untile(a):
        return untile_image(a, tiles_x, tiles_y, tile_w, tile_h, width, height)

    return VisibilityBuffer(
        tri_id=untile(tri_ids), depth=untile(depths), bary=untile(barys)
    )

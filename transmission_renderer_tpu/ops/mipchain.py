"""Opaque-framebuffer mip pyramid + clamp-sampled trilinear LOD fetch.

The reference blits the opaque-sampled HDR framebuffer down a full mip
chain every frame (``generate_mips`` call, src/main.rs:2054-2063) and the
transmission pass samples it at arbitrary UV with an explicit LOD
(``sample_by_lod`` closure, shader/src/lib.rs:135-138).

Layout: like the texture atlas (scene/textures.py), every level is
stored as 2x2 texel blocks in four phase-shifted copies, so a bilinear tap
is ONE [12]-f32 row gather and the trilinear fetch is two (a row-major
layout needs 8 taps). Building the phase copies is dense reshape/pad
work (~130 MB of writes at 1080p). Level sizes/offsets are static Python
ints (select chains, no meta gathers). CLAMP_TO_EDGE is baked into the
edge blocks, matching the reference's clamp framebuffer sampler.
"""

from __future__ import annotations

from typing import NamedTuple

import os

import jax
import jax.numpy as jnp

from transmission_renderer_tpu.scene.textures import mip_levels_for_size


# Levels at or above this many texels store ROW form ([lw*lh, 3] — the
# level image itself) instead of a quad table when built with a static
# level_set: the quad build costs 4 phase copies + transposes of the
# level (~130 MB of layout shuffling at 1080p level 0), while the
# row-form tap is 4 gathers instead of 1, paid only per covered
# TRANSMISSION pixel (a small screen fraction). Bit-exact: same texels,
# same lerp expression, same clamp. The threshold admits only level 0 at
# 1080p (ROADMAP D2: not measured on the GPU).
ROWS_FORM_MIN_TEXELS = int(
    os.environ.get("TRTPU_PYR_ROWS_MIN", str(1_500_000))
)

# Texels per physical row in ROW-form levels ([ceil(wh/G), 3*G] instead
# of [wh, 3]): packing G texels per row cuts the table's row count while
# the build stays a contiguous reshape (no phase-copy shuffles — the
# reason ROW form exists). G=16 puts 1080p level 0 at ~130k rows of
# 192 B; the sub-texel select is G-1 wheres per tap.
ROW_GROUP = int(os.environ.get("TRTPU_PYR_ROW_GROUP", "16"))
assert ROW_GROUP & (ROW_GROUP - 1) == 0 and ROW_GROUP >= 1
_RGSHIFT = ROW_GROUP.bit_length() - 1


class MipPyramid(NamedTuple):
    # Per-LEVEL quad tables, GROUP quad-blocks per physical row
    # ([ceil(4 * bh_k * bw_k / GROUP), 12 * GROUP] f32 each). Split per
    # level so a fetch restricted to a static level set only ever touches
    # small tables. The concatenated view
    # (``quads``) serves per-pixel dynamic levels; levels outside a
    # static ``level_set`` passed to build_pyramid hold None (their quad
    # construction is skipped at trace time — cheaper and more reliable
    # than hoping XLA DCEs a 100 MB level-0 phase-copy chain).
    level_quads: tuple  # tuple of [G_k, 12 * GROUP] float32 (or None)
    # static per-level metadata (Python ints; the pyramid never crosses a
    # jit boundary, it is built and consumed inside the frame function)
    offsets: tuple  # GROUPED-row offset of each level in the concat view
    widths: tuple  # texel sizes
    heights: tuple
    # ROW-form levels ([lw_k * lh_k, 3] f32 — the level image itself) for
    # big levels in a static level_set (see ROWS_FORM_MIN_TEXELS); a
    # level has either its quad table or its row form, never both
    level_rows: tuple = ()

    @property
    def quads(self) -> jnp.ndarray:
        assert all(q is not None for q in self.level_quads), (
            "dynamic-level sampling needs a full pyramid "
            "(build_pyramid(level_set=None))"
        )
        return jnp.concatenate(self.level_quads, axis=0)

    @property
    def num_levels(self) -> int:
        return len(self.offsets)


# Quad-blocks per physical row (12 f32 per block); sweepable via
# TRTPU_PYRAMID_GROUP (pow2).
GROUP = int(os.environ.get("TRTPU_PYRAMID_GROUP", "4"))
assert GROUP & (GROUP - 1) == 0 and GROUP >= 1
_GSHIFT = GROUP.bit_length() - 1


def pyramid_shapes(width: int, height: int) -> list[tuple[int, int]]:
    """(w, h) per level, floor(n/2) per step (Vulkan blit convention)."""
    shapes = [(width, height)]
    for _ in range(mip_levels_for_size(width, height) - 1):
        w, h = shapes[-1]
        shapes.append((max(w // 2, 1), max(h // 2, 1)))
    return shapes


def _downsample2x(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 box downsample of [H, W] or [H, W, C]; odd trailing row/col
    dropped (floor(n/2) sizing, like the reference's LINEAR blit chain).

    The 4-texel average is EXPLICIT elementwise adds (not a reduce op) in
    a pinned order, and one shape-generic body serves both the
    interleaved [H, W, 3] chain and the channel-planar [H, W] variant —
    bit-exactness between them holds by construction (multi-axis
    jnp.mean would lower with shape-dependent reduction order)."""
    h, w = img.shape[:2]
    c = img.shape[2:]  # () for a channel plane, (3,) interleaved
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    if h == 1:
        img2 = img[:, : nw * 2].reshape(1, nw, 2, *c)
        return (img2[:, :, 0] + img2[:, :, 1]) * 0.5
    if w == 1:
        img2 = img[: nh * 2].reshape(nh, 2, 1, *c)
        return (img2[:, 0] + img2[:, 1]) * 0.5
    img2 = img[: nh * 2, : nw * 2].reshape(nh, 2, nw, 2, *c)
    return (
        (img2[:, 0, :, 0] + img2[:, 0, :, 1])
        + (img2[:, 1, :, 0] + img2[:, 1, :, 1])
    ) * 0.25


def _pair_matrix(n: int) -> jnp.ndarray:
    """[n, max(n//2, 1)] 0/1 f32 matrix pairing element 2j, 2j+1 -> j
    (rows beyond 2*(n//2) are zero — the floor(n/2) odd-edge drop)."""
    m = max(n // 2, 1)
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, m), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (n, m), 1)
    return jnp.asarray((rows >> 1) == cols, jnp.float32) * jnp.asarray(
        rows < 2 * m, jnp.float32
    )


def _downsample2x_plane_matmul(plane: jnp.ndarray) -> jnp.ndarray:
    """2x2 box downsample of ONE [H, W] channel plane via two matmuls
    with 0/1 pairing matrices, which keep every tensor in natural
    [rows, columns] layout (the reshape-based ``_downsample2x`` builds
    [nh, 2, nw, 2] intermediates).

    Exactness: horizontal-pair-add first, then vertical — the SAME
    association ``(a+b) + (c+d)`` as ``_downsample2x`` (top-row sum plus
    bottom-row sum, then * 0.25). Each output accumulates exactly two
    nonzero products of exact 1.0 coefficients, so at HIGHEST precision
    the result is BIT-identical to the explicit adds (pinned by
    tests/test_mipchain.py::test_mxu_downsample_bit_exact). The precision
    is explicit: a GPU's default f32 matmul may round the plane to TF32.
    """
    h, w = plane.shape
    if h <= 1 or w <= 1:
        return _downsample2x(plane)
    hi = jax.lax.Precision.HIGHEST
    # [h, w//2]: img[i,2j] + img[i,2j+1]
    t = jnp.matmul(plane, _pair_matrix(w), precision=hi)
    out = jnp.matmul(_pair_matrix(h).T, t, precision=hi)  # top + bottom
    return out * 0.25


def _quad_level(img: jnp.ndarray) -> jnp.ndarray:
    """[H, W, 3] -> [ceil(4 * bh * bw / GROUP), 12 * GROUP] phase-shifted
    2x2 blocks, GROUP per row, CLAMP edges baked (the framebuffer sampler
    is clamp-to-edge)."""
    h, w = img.shape[:2]
    bw, bh = (w + 1) // 2, (h + 1) // 2
    padded = jnp.pad(
        img, ((0, 2 * bh + 1 - h), (0, 2 * bw + 1 - w), (0, 0)), mode="edge"
    )
    phases = []
    for py in (0, 1):
        for px in (0, 1):
            sub = padded[py : py + 2 * bh, px : px + 2 * bw]
            blk = sub.reshape(bh, 2, bw, 2, 3).transpose(0, 2, 1, 3, 4)
            phases.append(blk.reshape(bh * bw, 12))
    q = jnp.concatenate(phases, axis=0)
    pad = (-q.shape[0]) % GROUP
    if pad:
        q = jnp.pad(q, ((0, pad), (0, 0)))
    return q.reshape(-1, 12 * GROUP)


def _grouped_rows(n_quads: int) -> int:
    return -(-n_quads // GROUP)


def _fetch_quad(table: jnp.ndarray, grouped_off, qidx: jnp.ndarray):
    """Gather LEVEL-LOCAL quad-block ``qidx`` from a GROUP-packed table
    whose level starts at grouped row ``grouped_off`` -> [..., 4, 3]."""
    row = table[grouped_off + (qidx >> _GSHIFT)]
    # see ops/texture.py: barrier keeps the wide row gather intact
    row = jax.lax.optimization_barrier(row)
    grp = row.reshape(row.shape[:-1] + (GROUP, 12))
    sub = qidx & (GROUP - 1)
    out = grp[..., 0, :]
    for k in range(1, GROUP):
        out = jnp.where((sub == k)[..., None], grp[..., k, :], out)
    return out.reshape(out.shape[:-1] + (4, 3))


def build_pyramid(
    framebuffer, level_set: tuple | None = None
) -> MipPyramid:
    """[H, W, 3] (or a (r, g, b) tuple of [H, W] planes) -> quad-block
    mip pyramid (level 0 included).

    ``level_set`` (static level indices, see
    render/frame.py::refraction_level_set) restricts the build: the
    downsample chain stops at the coarsest needed level and quad tables
    are only constructed for levels IN the set (others hold None). The
    reference regenerates its full chain every frame
    (src/main.rs:2054-2063); with an untextured transmissive roughness
    the fetch provably touches only the set, so matching its work would
    be pure waste.

    Planes input is the fast path: the downsample chain runs per
    channel plane (``_downsample2x_plane_matmul``) and channels
    interleave only for the (small) per-level quad/ROW tables."""
    if isinstance(framebuffer, (tuple, list)):
        in_planes = tuple(framebuffer)
        h, w = in_planes[0].shape
    else:
        h, w = framebuffer.shape[:2]
        in_planes = tuple(framebuffer[..., c] for c in range(3))
    shapes = pyramid_shapes(w, h)
    n_levels = len(shapes)
    max_needed = n_levels - 1 if level_set is None else min(
        max(level_set), n_levels - 1
    )
    with jax.named_scope("pyr_down"):
        planes = [list(in_planes)]
        for _ in range(max_needed):
            planes.append([_downsample2x_plane_matmul(p) for p in planes[-1]])

    def interleave(k):
        return jnp.stack(planes[k], axis=-1)

    offsets, off = [], 0
    for lw, lh in shapes:
        offsets.append(off)
        off += _grouped_rows(4 * ((lw + 1) // 2) * ((lh + 1) // 2))
    with jax.named_scope("pyr_quads"):
        level_quads, level_rows = [], []
        for k in range(n_levels):
            needed = (
                level_set is None or k in level_set
            ) and k <= max_needed
            lw, lh = shapes[k]
            if not needed:
                level_quads.append(None)
                level_rows.append(None)
            elif level_set is not None and lw * lh >= ROWS_FORM_MIN_TEXELS:
                level_quads.append(None)
                # CHANNEL-BLOCKED row form ([G reds | G greens | G
                # blues] per row), built straight from the planar
                # downsample chain: per plane a contiguous reshape to
                # [wh/G, G], then one concat (no planar -> interleaved
                # relayout of the whole level).
                chans = []
                for p in planes[k]:
                    flat = p.reshape(-1)
                    pad = (-flat.shape[0]) % ROW_GROUP
                    if pad:
                        flat = jnp.pad(flat, (0, pad))
                    chans.append(flat.reshape(-1, ROW_GROUP))
                level_rows.append(jnp.concatenate(chans, axis=1))
            else:
                level_quads.append(_quad_level(interleave(k)))
                level_rows.append(None)
    return MipPyramid(
        level_quads=tuple(level_quads),
        offsets=tuple(offsets),
        widths=tuple(s[0] for s in shapes),
        heights=tuple(s[1] for s in shapes),
        level_rows=tuple(level_rows),
    )


def _select_level_meta(pyr: MipPyramid, level: jnp.ndarray):
    """Static select chain -> per-pixel (offset, w, h) int32."""
    off = jnp.full(level.shape, pyr.offsets[0], jnp.int32)
    w = jnp.full(level.shape, pyr.widths[0], jnp.int32)
    h = jnp.full(level.shape, pyr.heights[0], jnp.int32)
    for k in range(1, pyr.num_levels):
        pick = level == k
        off = jnp.where(pick, pyr.offsets[k], off)
        w = jnp.where(pick, pyr.widths[k], w)
        h = jnp.where(pick, pyr.heights[k], h)
    return off, w, h


def _bilinear_clamp_quad(pyr: MipPyramid, level: jnp.ndarray, uv: jnp.ndarray):
    """Clamp-to-edge bilinear tap at a (per-pixel dynamic) level: ONE
    gather of a 12-float block row."""
    qoff, w, h = _select_level_meta(pyr, level)
    x = uv[..., 0] * w.astype(jnp.float32) - 0.5
    y = uv[..., 1] * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    # clamp: below-zero footprints collapse onto the block's first
    # column/row (both Vulkan taps clamp to texel 0); the upper edge is
    # baked into the boundary blocks.
    fx = jnp.where((x0 < 0)[..., None], 0.0, fx)
    fy = jnp.where((y0 < 0)[..., None], 0.0, fy)
    x0 = jnp.clip(x0, 0, w - 1)
    y0 = jnp.clip(y0, 0, h - 1)
    bw = (w + 1) >> 1
    bh = (h + 1) >> 1
    phase = (y0 & 1) * 2 + (x0 & 1)
    qidx = phase * (bw * bh) + (y0 >> 1) * bw + (x0 >> 1)
    q = _fetch_quad(pyr.quads, qoff, qidx)
    c00, c10, c01, c11 = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def _bilinear_level_static(pyr: MipPyramid, k: int, uv: jnp.ndarray):
    """Clamp-to-edge bilinear tap at STATIC level k: one gather from the
    level's (small) quad table, or four row gathers when the level is in
    ROW form (big level_set levels — same texels, same lerp, bit-exact)."""
    w, h = pyr.widths[k], pyr.heights[k]
    x = uv[..., 0] * float(w) - 0.5
    y = uv[..., 1] * float(h) - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    fx = jnp.where((x0 < 0)[..., None], 0.0, fx)
    fy = jnp.where((y0 < 0)[..., None], 0.0, fy)
    x0 = jnp.clip(x0, 0, w - 1)
    y0 = jnp.clip(y0, 0, h - 1)
    if pyr.level_rows and pyr.level_rows[k] is not None:
        rows = pyr.level_rows[k]  # [ceil(w*h/G), 3*G] grouped texels
        x1 = jnp.minimum(x0 + 1, w - 1)
        y1 = jnp.minimum(y0 + 1, h - 1)

        def tap(idx):
            grp = rows[idx >> _RGSHIFT]
            # keep the wide row gather intact (see _fetch_quad)
            grp = jax.lax.optimization_barrier(grp)
            sub = idx & (ROW_GROUP - 1)
            # channel-blocked rows (see build_pyramid): channel c's
            # texel j sits at c * G + j
            chans = []
            for c in range(3):
                v = grp[..., c * ROW_GROUP]
                for j in range(1, ROW_GROUP):
                    v = jnp.where(
                        sub == j, grp[..., c * ROW_GROUP + j], v
                    )
                chans.append(v)
            return jnp.stack(chans, axis=-1)

        c00 = tap(y0 * w + x0)
        c10 = tap(y0 * w + x1)
        c01 = tap(y1 * w + x0)
        c11 = tap(y1 * w + x1)
    else:
        bw = (w + 1) >> 1
        bh = (h + 1) >> 1
        phase = (y0 & 1) * 2 + (x0 & 1)
        qidx = phase * (bw * bh) + (y0 >> 1) * bw + (x0 >> 1)
        q = _fetch_quad(pyr.level_quads[k], 0, qidx)
        c00, c10, c01, c11 = (
            q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
        )
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def _bilinear_level_set_dynamic(
    pyr: MipPyramid, level: jnp.ndarray, uv: jnp.ndarray, lmin: int, hi: int
):
    """Clamp-to-edge bilinear tap at a PER-PIXEL level inside the static
    range [lmin, hi] (``lmin`` is the smallest level this tap can hit:
    the set's floor for the lod-floor tap, one above it for the lod-ceil
    tap — which spares the ceil tap the floor level's ROW-form gathers):
    one gather from the range's concatenated quad tables (+ the row-form
    taps where a range level stores ROW form, selected per pixel).
    Value-identical to ``_bilinear_level_static`` at the same level:
    identical coordinate math on the per-pixel-selected level size,
    identical fetch expressions."""
    quad_levels = [
        k for k in range(lmin, hi + 1) if pyr.level_quads[k] is not None
    ]
    row_levels = [
        k
        for k in range(lmin, hi + 1)
        if pyr.level_rows and pyr.level_rows[k] is not None
    ]
    # per-pixel level geometry (static select chain over the range)
    w = jnp.full(level.shape, pyr.widths[lmin], jnp.int32)
    h = jnp.full(level.shape, pyr.heights[lmin], jnp.int32)
    for k in range(lmin + 1, hi + 1):
        pick = level == k
        w = jnp.where(pick, pyr.widths[k], w)
        h = jnp.where(pick, pyr.heights[k], h)
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
    y0 = jnp.clip(y0, 0, h - 1)

    out = None
    if quad_levels:
        quads_set = jnp.concatenate(
            [pyr.level_quads[k] for k in quad_levels], axis=0
        )
        goffs, go = {}, 0
        for k in quad_levels:
            goffs[k] = go
            go += pyr.level_quads[k].shape[0]
        goff = jnp.full(level.shape, goffs[quad_levels[0]], jnp.int32)
        for k in quad_levels[1:]:
            goff = jnp.where(level == k, goffs[k], goff)
        bw = (w + 1) >> 1
        bh = (h + 1) >> 1
        phase = (y0 & 1) * 2 + (x0 & 1)
        qidx = phase * (bw * bh) + (y0 >> 1) * bw + (x0 >> 1)
        # pixels on a ROW-form level would compute qidx from that level's
        # LARGE geometry (far past the concatenated quad tables) before
        # the row-level where below overwrites their value — zero their
        # index instead of relying on XLA's clamp-mode gather semantics
        for k in row_levels:
            qidx = jnp.where(level == k, 0, qidx)
        q = _fetch_quad(quads_set, goff, qidx)
        c00, c10, c01, c11 = (
            q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
        )
        top = c00 + (c10 - c00) * fx
        bot = c01 + (c11 - c01) * fx
        out = top + (bot - top) * fy
    for k in row_levels:
        ck = _bilinear_level_static(pyr, k, uv)
        out = ck if out is None else jnp.where((level == k)[..., None], ck, out)
    return out


def sample_pyramid_lod(
    pyr: MipPyramid,
    uv: jnp.ndarray,
    lod: jnp.ndarray,
    level_set: tuple | None = None,
) -> jnp.ndarray:
    """Trilinear clamp sample -> [..., 3]; the framebuffer_sampler closure
    of the transmission shader (shader/src/lib.rs:135-138).

    ``level_set`` (a static, contiguous tuple of level indices) restricts
    the fetch to those levels: the lod is clamped into the set's range.
    Small sets (<= 3 levels) sum one tent-weighted bilinear tap per level
    from that level's own small quad table; wider sets tap only the TWO
    levels bracketing each pixel's lod through a per-pixel dynamic fetch
    (``_bilinear_level_set_dynamic``) — a 9-level set (e.g. a scene
    whose glass spans roughness 0..0.4) costs 2 gathers/px instead of 9+.
    Both forms produce BIT-identical results: the skipped taps carry
    exact tent weight 0.0, and 0.0 * finite-texel terms add exactly
    nothing to the ascending-level sum the small-set form computes.
    Callers must guarantee every lod that survives to the image lies
    inside the set (render_frame derives it from static per-material
    ior-adjusted roughness — see SceneFlags.transmission_ior_roughness);
    out-of-set lods (e.g. on pixels that are masked away afterwards)
    clamp harmlessly. Equals the two-level lerp up to fp reassociation.
    """
    max_level = pyr.num_levels - 1
    if level_set is not None:
        lo, hi = min(level_set), max(level_set)
        assert tuple(level_set) == tuple(range(lo, hi + 1)), (
            "level_set must be contiguous"
        )
        lod = jnp.clip(lod, float(lo), float(hi))
        if hi - lo + 1 <= 3:
            out = None
            for k in range(lo, hi + 1):
                wk = jnp.clip(
                    1.0 - jnp.abs(lod - float(k)), 0.0, 1.0
                )[..., None]
                ck = _bilinear_level_static(pyr, k, uv) * wk
                out = ck if out is None else out + ck
            return out
        l0 = jnp.floor(lod).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, hi)
        c0 = _bilinear_level_set_dynamic(pyr, l0, uv, lo, hi)
        c1 = _bilinear_level_set_dynamic(pyr, l1, uv, min(lo + 1, hi), hi)
        l0f = l0.astype(jnp.float32)
        # the SAME tent expression the per-level loop evaluates, so the
        # two bracketing terms match it bit-for-bit; the l1 == l0 edge
        # (lod exactly at the set's top) would double-count level hi —
        # its tent weight is forced to the exact 0.0 every other level
        # contributes there
        w0 = jnp.clip(1.0 - jnp.abs(lod - l0f), 0.0, 1.0)[..., None]
        w1 = jnp.clip(1.0 - jnp.abs(lod - (l0f + 1.0)), 0.0, 1.0)[..., None]
        w1 = jnp.where((l1 == l0)[..., None], 0.0, w1)
        return c0 * w0 + c1 * w1
    lod = jnp.clip(lod, 0.0, float(max_level))
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, max_level)
    c0 = _bilinear_clamp_quad(pyr, l0, uv)
    c1 = _bilinear_clamp_quad(pyr, l1, uv)
    frac = (lod - l0.astype(jnp.float32))[..., None]
    return c0 + (c1 - c0) * frac

"""Gather-based texture sampling over the quad-block texel atlas.

Replaces Vulkan sampler hardware (SURVEY.md §2.5 "Texture sampling"):
bilinear + trilinear filtering, REPEAT / CLAMP_TO_EDGE wrap, sRGB decode.
All sampling is explicit-LOD; implicit-LOD call sites compute LODs from
analytic UV derivatives in the deferred shading pass (the analogue of
ddx/ddy, SURVEY.md §2.5 "derivative hardware").

The atlas stores each mip level as 2x2 blocks in four phase-shifted copies
(scene/textures.py), so one bilinear tap is ONE row gather and trilinear
is two; QUAD_GROUP consecutive blocks pack into each physical row to cut
the table's row count (the sub-block select is register work).

Conventions match Vulkan: texel centres at integer+0.5, LOD0 = full res.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from transmission_renderer_tpu.scene import textures as _layout
from transmission_renderer_tpu.scene.textures import (  # noqa: F401
    IMAGE_MASK,
    LAYER_SHIFT,
    MAX_MIPS,
    META_COLS,
    META_LAYERS_COL,
    QUAD_GROUP,
    QUAD_GROUP_SHIFT,
)


def _block_texels() -> int:
    # read through the module so tests can monkeypatch the atlas layout
    # (scene/textures.py::ATLAS_FUSED / BLOCK_TEXELS) per-case
    return _layout.BLOCK_TEXELS

WRAP_REPEAT = 0
WRAP_CLAMP = 1


def _wrap_bilinear_coords(x, y, width, height, wrap_mode):
    """Shared footprint-corner math: -> (x0, y0 int32 wrapped, fx, fy)."""
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    if wrap_mode == WRAP_REPEAT:
        x0 = jnp.mod(x0, width)
        y0 = jnp.mod(y0, height)
    else:
        # CLAMP_TO_EDGE: when x0 < 0 both Vulkan taps clamp to texel 0, so
        # the blend must collapse onto the block's first column (fx = 0);
        # the upper edge (x0 >= w-1) is baked into the boundary block.
        fx = jnp.where((x0 < 0)[..., None], 0.0, fx)
        fy = jnp.where((y0 < 0)[..., None], 0.0, fy)
        x0 = jnp.clip(x0, 0, width - 1)
        y0 = jnp.clip(y0, 0, height - 1)
    return x0, y0, fx, fy


def _class_geometry(row_elems: int, layers: int):
    """(group, shift, block_elems) of a layer class in a flat pool."""
    block_elems = _block_texels() * 4 * layers
    g = max(1, row_elems // block_elems)
    g = 1 << max(g.bit_length() - 1, 0)
    return g, g.bit_length() - 1, block_elems


def _tap_footprint(qoff, width, height, uv, wrap_mode):
    """Shared bilinear-footprint math -> (qidx, fx, fy, x0, y0).

    The footprint {x0, x0+1} x {y0, y0+1} lives entirely in the block of
    phase (y0 & 1, x0 & 1) at (y0 >> 1, x0 >> 1); edge wrap behaviour is
    baked into boundary blocks at build time (scene/textures.py), so the
    only in-sampler wrap work is folding x0/y0 into range."""
    wf = width.astype(jnp.float32)
    hf = height.astype(jnp.float32)
    x = uv[..., 0] * wf - 0.5
    y = uv[..., 1] * hf - 0.5
    x0, y0, fx, fy = _wrap_bilinear_coords(x, y, width, height, wrap_mode)
    bw = (width + 1) >> 1
    bh = (height + 1) >> 1
    phase = (y0 & 1) * 2 + (x0 & 1)
    qidx = qoff + phase * (bw * bh) + (y0 >> 1) * bw + (x0 >> 1)
    return qidx, fx, fy, x0, y0


def _flat_row_index(qidx, row_elems, classes, layers_pix):
    """Physical row of a virtual block index in a flat per-image-group
    pool (select over the small static class set)."""
    if len(classes) == 1:
        layer_sets = [(classes[0], None)]
    else:
        assert layers_pix is not None, "multi-class pools need layers_pix"
        layer_sets = [(lc, layers_pix == lc) for lc in classes]
    row_idx = None
    for lc, pick in layer_sets:
        _, shift, _ = _class_geometry(row_elems, lc)
        r = qidx >> shift
        row_idx = r if row_idx is None else jnp.where(pick, r, row_idx)
    return row_idx


def _fetch_block(quads, qoff, width, height, uv, wrap_mode, classes=None,
                 layers_pix=None):
    """ONE row gather + sub-block select -> the whole fused quad-block
    normalised to [..., BLOCK_TEXELS * 4 * Lmax] (absent layers read 0),
    plus the wrapped footprint corner (x0, y0) and blend weights (fx, fy).

    Flat pools use PER-IMAGE row groups (scene/textures.py::finish):
    an image with L layers packs G_L = row_elems // (BLOCK_TEXELS*4*L)
    blocks per row and its meta offsets are virtual block indices, so
    row = qidx >> shift_L and sub-block = qidx & (G_L - 1). ``classes``
    is the pool's STATIC set of distinct layer counts (atlas_classes);
    ``layers_pix`` the per-pixel layer count from the meta rows — with
    one class the select chains collapse to the single-group layout.
    """
    qidx, fx, fy, x0, y0 = _tap_footprint(qoff, width, height, uv, wrap_mode)
    if quads.ndim == 3:
        # legacy [R, G, blkw] pool (LUT pools keep this shape)
        group = quads.shape[1]
        shift = group.bit_length() - 1
        grp = quads[qidx >> shift]  # [..., G, blkw]
        # materialise the WIDE row gather before the sub-block select:
        # fused, XLA re-splits it into G strided gathers (ROADMAP D2:
        # re-check on the GPU)
        grp = jax.lax.optimization_barrier(grp)
        sub = qidx & (group - 1)
        blk = grp[..., 0, :]
        for k in range(1, group):
            blk = jnp.where((sub == k)[..., None], grp[..., k, :], blk)
        return blk.astype(jnp.float32), x0, y0, fx, fy
    # FLAT [R, row_elems] pool with per-image groups.
    assert classes, "flat atlas pools need their class set (atlas_classes)"
    row_elems = quads.shape[-1]
    l_max = max(classes)
    if len(classes) == 1:
        layer_sets = [(classes[0], None)]
    else:
        assert layers_pix is not None, "multi-class pools need layers_pix"
        layer_sets = [(lc, layers_pix == lc) for lc in classes]
    row_idx = _flat_row_index(qidx, row_elems, classes, layers_pix)
    grp = quads[row_idx]  # [..., row_elems]
    grp = jax.lax.optimization_barrier(grp)
    # per-class sub-block extraction, normalised to the max layer width
    # (texel-major layout: texel t's layer l channel c at
    # t*4*L + 4*l + c; absent layers zero-fill — the semantics the old
    # globally-layer-padded pool stored physically)
    bt = _block_texels()
    out = None
    for lc, pick in layer_sets:
        g, _, blkw = _class_geometry(row_elems, lc)
        sub = qidx & (g - 1)
        blk = grp[..., :blkw]
        for k in range(1, g):
            blk = jnp.where(
                (sub == k)[..., None], grp[..., k * blkw : (k + 1) * blkw],
                blk,
            )
        if lc < l_max:
            zeros = jnp.zeros(blk.shape[:-1] + (4 * (l_max - lc),), blk.dtype)
            parts = []
            for t in range(bt):
                parts.append(blk[..., t * 4 * lc : (t + 1) * 4 * lc])
                parts.append(zeros)
            blk = jnp.concatenate(parts, axis=-1)
        out = blk if out is None else jnp.where(pick[..., None], blk, out)
    # texels store half-width (scene/textures.py::ATLAS_DTYPE, bf16) —
    # convert AFTER the narrow sub-block select, lerp in f32
    return out.astype(jnp.float32), x0, y0, fx, fy


def _lerp4(c00, c10, c01, c11, fx, fy):
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def _bilinear_level_quad(
    quads: jnp.ndarray,  # [R, row_elems] flat f32/bf16 pool
    qoff: jnp.ndarray,  # [...] int32 level block offset (virtual index)
    width: jnp.ndarray,  # [...] int32 level size in texels
    height: jnp.ndarray,  # [...] int32
    uv: jnp.ndarray,  # [..., 2]
    wrap_mode: int,
    classes: tuple | None = None,
    layers_pix: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """One bilinear tap (ALL layers) at a single mip level -> [..., 4*L].
    ONE gather; texels are pre-decoded linear float (scene/textures.py),
    so the tap is gather + sub-block select + lerp — no u8 unpack and no
    per-sample sRGB pow chain."""
    blk, _, _, fx, fy = _fetch_block(
        quads, qoff, width, height, uv, wrap_mode, classes=classes,
        layers_pix=layers_pix,
    )
    c = blk.shape[-1] // _block_texels()  # 4L
    q = blk[..., : 4 * c].reshape(blk.shape[:-1] + (4, c))
    return _lerp4(
        q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :], fx, fy
    )


def _level_meta_from_rows(rows: jnp.ndarray, level: jnp.ndarray):
    """(quad offset, width, height) of a clamped mip level from pre-gathered
    meta rows [..., META_COLS].

    Level sizes are the closed form max(size0 >> level, 1); offsets come
    from a static select chain over the (small, static) mip count — both
    arithmetic instead of per-pixel gathers.
    """
    num_mips = rows[..., 0]
    level = jnp.clip(level, 0, num_mips - 1)
    width = jnp.maximum(rows[..., 2] >> level, 1)
    height = jnp.maximum(rows[..., 3] >> level, 1)
    offset = rows[..., 4]
    for k in range(1, MAX_MIPS):
        offset = jnp.where(level == k, rows[..., 4 + k], offset)
    return offset, width, height


def sample_texture(
    quads: jnp.ndarray,  # [B, 4] uint32
    meta: jnp.ndarray,  # [num_images, META_COLS] int32
    srgb_table: jnp.ndarray,  # [num_images] bool (unused: srgb rides in meta)
    texture_id: jnp.ndarray,  # [...] int32 (callers mask id==-1 themselves)
    uv: jnp.ndarray,  # [..., 2]
    lod: jnp.ndarray,  # [...] float32
    wrap_mode: int = WRAP_REPEAT,
    trilinear: bool = True,
) -> jnp.ndarray:
    """Explicit-LOD trilinear (or bilinear at floor(lod)) sample -> [..., 4].

    Matches ``texture.sample_by_lod(sampler, uv, lod)``; the implicit-LOD
    ``texture.sample`` path is this with a derivative-computed lod.
    """
    # texture_id is a PACKED ref (image | layer << 16, scene/textures.py);
    # -1 ("no texture") is handled by caller masks
    texture_id = jnp.maximum(texture_id, 0)
    img = texture_id & IMAGE_MASK
    layer = texture_id >> LAYER_SHIFT
    # ONE meta-row gather per sample (sRGB decode is pre-baked into the
    # float atlas; srgb_table is accepted for API compatibility only).
    classes = atlas_classes(meta) if quads.ndim == 2 else (1,)
    rows = meta[img][..., :META_COLS]
    return sample_texture_rows(
        quads, rows, uv, lod, wrap_mode, trilinear,
        layer=layer if max(classes) > 1 else None,
        classes=classes if quads.ndim == 2 else None,
    )


def atlas_classes(meta: jnp.ndarray) -> tuple:
    """STATIC set of distinct per-image layer counts, decoded from the
    meta WIDTH (scene/textures.py::AtlasBuilder.finish pads the meta by
    a bitmask with bit L-1 set when some image has L layers) — the class
    info travels with the scene through jit without pytree aux plumbing.
    Pass scene.atlas_meta, not row slices."""
    mask = meta.shape[-1] - META_COLS
    assert mask >= 1, "atlas meta missing its layer-class tag"
    return tuple(l + 1 for l in range(mask.bit_length()) if (mask >> l) & 1)


def atlas_layers(meta: jnp.ndarray) -> int:
    """Static MAX layer count of a pool (the bundle-sample width)."""
    return max(atlas_classes(meta))


def sample_bundle_rows(
    quads: jnp.ndarray,
    rows: jnp.ndarray,  # [..., META_COLS] pre-gathered meta rows
    uv: jnp.ndarray,
    lod: jnp.ndarray,
    wrap_mode: int = WRAP_REPEAT,
    trilinear: bool = True,
    fused: bool = False,
    classes: tuple | None = None,
) -> jnp.ndarray:
    """Explicit-LOD sample of ALL bundle layers -> [..., Lmax, 4]. The
    whole bundle costs the same gathers as one texture; every layer of a
    2x2 block shares the physical row (absent layers of smaller-class
    images read 0).

    ``classes`` is the pool's static layer-class set (atlas_classes);
    per-pixel layer counts come from the meta rows' layers column.

    ``fused=True`` (valid only when every atlas image has power-of-two
    dimensions — callers gate on the scene-static flag) makes a
    TRILINEAR tap cost ONE gather: the level-l block's 3x3 level-(l+1)
    patch (scene/textures.py::BLOCK_TEXELS) supplies the coarse bilinear
    footprint, located in registers. With ``fused=False`` trilinear is
    the classic 2-gather two-level blend (exact for any image size)."""
    lod = jnp.maximum(lod, 0.0)
    assert (classes is not None) == (quads.ndim == 2), \
        "flat atlas pools need their class set (ops.texture.atlas_classes)"
    layers_pix = rows[..., META_LAYERS_COL] if quads.ndim == 2 else None
    l_max = max(classes) if classes else 1
    if fused and trilinear:
        # clamp to the real mip range so the last level's self-patch
        # (whose coordinates don't correspond) always has weight 0
        lod = jnp.minimum(lod, (rows[..., 0] - 1).astype(jnp.float32))
        l0 = jnp.floor(lod).astype(jnp.int32)
        o0, w0, h0 = _level_meta_from_rows(rows, l0)
        blk, x0, y0, fx, fy = _fetch_block(
            quads, o0, w0, h0, uv, wrap_mode, classes=classes,
            layers_pix=layers_pix,
        )
        c = blk.shape[-1] // _block_texels()  # 4L
        q = blk[..., : 4 * c].reshape(blk.shape[:-1] + (4, c))
        c0 = _lerp4(
            q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :], fx, fy
        )
        # ---- coarse footprint from the in-block 3x3 parent patch ----
        w1 = jnp.maximum(rows[..., 2] >> (l0 + 1), 1)
        h1 = jnp.maximum(rows[..., 3] >> (l0 + 1), 1)
        x1 = uv[..., 0] * w1.astype(jnp.float32) - 0.5
        y1 = uv[..., 1] * h1.astype(jnp.float32) - 0.5
        x0p, y0p, fx1, fy1 = _wrap_bilinear_coords(
            x1, y1, w1, h1, wrap_mode
        )
        # the parent corner lies in {k-1, k} around k = x0 >> 1 (see
        # scene/textures.py::_quad_blocks); map it to the patch-local
        # window start ix/iy in {0, 1}
        if wrap_mode == WRAP_REPEAT:
            ix = jnp.mod(x0p - (x0 >> 1) + 1, w1)
            iy = jnp.mod(y0p - (y0 >> 1) + 1, h1)
        else:
            ix = x0p - (x0 >> 1) + 1
            iy = y0p - (y0 >> 1) + 1
        ix = jnp.clip(ix, 0, 1)[..., None]
        iy = jnp.clip(iy, 0, 1)[..., None]
        patch = blk[..., 4 * c :].reshape(blk.shape[:-1] + (3, 3, c))
        r0 = jnp.where(iy[..., None] == 0, patch[..., 0, :, :], patch[..., 1, :, :])
        r1 = jnp.where(iy[..., None] == 0, patch[..., 1, :, :], patch[..., 2, :, :])
        p00 = jnp.where(ix == 0, r0[..., 0, :], r0[..., 1, :])
        p10 = jnp.where(ix == 0, r0[..., 1, :], r0[..., 2, :])
        p01 = jnp.where(ix == 0, r1[..., 0, :], r1[..., 1, :])
        p11 = jnp.where(ix == 0, r1[..., 1, :], r1[..., 2, :])
        c1 = _lerp4(p00, p10, p01, p11, fx1, fy1)
        frac = (lod - l0.astype(jnp.float32))[..., None]
        c0 = c0 + (c1 - c0) * frac
        return c0.reshape(c0.shape[:-1] + (l_max, 4))

    l0 = jnp.floor(lod).astype(jnp.int32)
    o0, w0, h0 = _level_meta_from_rows(rows, l0)
    c0 = _bilinear_level_quad(
        quads, o0, w0, h0, uv, wrap_mode, classes=classes,
        layers_pix=layers_pix,
    )
    if trilinear:
        o1, w1, h1 = _level_meta_from_rows(rows, l0 + 1)
        c1 = _bilinear_level_quad(
            quads, o1, w1, h1, uv, wrap_mode, classes=classes,
            layers_pix=layers_pix,
        )
        frac = (lod - l0.astype(jnp.float32))[..., None]
        c0 = c0 + (c1 - c0) * frac
    return c0.reshape(c0.shape[:-1] + (l_max, 4))


def select_layer(samples: jnp.ndarray, layer: jnp.ndarray) -> jnp.ndarray:
    """[..., L, 4] bundle samples + [...] int32 layer -> [..., 4]
    (register select chain over the small static layer count)."""
    num = samples.shape[-2]
    out = samples[..., 0, :]
    for k in range(1, num):
        out = jnp.where((layer == k)[..., None], samples[..., k, :], out)
    return out


def sample_texture_rows(
    quads: jnp.ndarray,
    rows: jnp.ndarray,  # [..., META_COLS] pre-gathered meta rows
    uv: jnp.ndarray,
    lod: jnp.ndarray,
    wrap_mode: int = WRAP_REPEAT,
    trilinear: bool = True,
    layer: jnp.ndarray | None = None,
    classes: tuple | None = None,
) -> jnp.ndarray:
    """Like sample_texture but with the per-pixel meta rows already
    fetched — callers that also need level-0 sizes (for LOD computation)
    can share the fetch (e.g. via the one-hot material matrix,
    render/shading.py). ``layer`` selects a bundle layer per pixel
    (default: layer 0, exact for single-texture entries)."""
    s = sample_bundle_rows(
        quads, rows, uv, lod, wrap_mode, trilinear, classes=classes
    )
    if layer is None:
        return s[..., 0, :]
    return select_layer(s, layer)


def quad_lut_2ch(lut: jnp.ndarray) -> jnp.ndarray:
    """[S, S, 2] float LUT -> [4 * (S/2)^2 / QUAD_GROUP, 8 * QUAD_GROUP]
    phase-shifted 2x2 blocks, QUAD_GROUP per row (CLAMP edges baked), for
    ``sample_lut_2ch_quad``. Build once per frame — pure data movement;
    each *sample* then costs ONE (row-grouped) gather instead of four."""
    s = lut.shape[0]
    b = (s + 1) // 2
    padded = jnp.pad(lut, ((0, 2 * b + 1 - s), (0, 2 * b + 1 - s), (0, 0)),
                     mode="edge")
    phases = []
    for py in (0, 1):
        for px in (0, 1):
            sub = padded[py : py + 2 * b, px : px + 2 * b]
            blk = sub.reshape(b, 2, b, 2, 2).transpose(0, 2, 1, 3, 4)
            phases.append(blk.reshape(b * b, 8))
    q = jnp.concatenate(phases, axis=0)
    pad = (-q.shape[0]) % QUAD_GROUP
    if pad:
        q = jnp.pad(q, ((0, pad), (0, 0)))
    return q.reshape(-1, 8 * QUAD_GROUP)


def sample_lut_2ch_quad(
    quads: jnp.ndarray,  # [4 * (S/2)^2, 8] from quad_lut_2ch
    size: int,  # S (static)
    u: jnp.ndarray,
    v: jnp.ndarray,
) -> jnp.ndarray:
    """One-gather clamp-sampled bilinear LUT fetch -> [..., 2]; same
    semantics as sample_lut_2ch."""
    s = size
    x = jnp.clip(u * s - 0.5, 0.0, s - 1.0)
    y = jnp.clip(v * s - 0.5, 0.0, s - 1.0)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0.astype(jnp.float32))[..., None]
    fy = (y - y0.astype(jnp.float32))[..., None]
    b = (s + 1) >> 1
    phase = (y0 & 1) * 2 + (x0 & 1)
    qidx = phase * (b * b) + (y0 >> 1) * b + (x0 >> 1)
    row = jax.lax.optimization_barrier(quads[qidx >> QUAD_GROUP_SHIFT])
    grp = row.reshape(row.shape[:-1] + (QUAD_GROUP, 8))
    sub = qidx & (QUAD_GROUP - 1)
    q8 = grp[..., 0, :]
    for k in range(1, QUAD_GROUP):
        q8 = jnp.where((sub == k)[..., None], grp[..., k, :], q8)
    q = q8.reshape(qidx.shape + (4, 2))
    c00, c10, c01, c11 = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def sample_lut_2ch(
    lut: jnp.ndarray,  # [S, S, 2] float32 (e.g. the GGX split-sum LUT)
    u: jnp.ndarray,  # [...]
    v: jnp.ndarray,  # [...]
) -> jnp.ndarray:
    """Clamp-sampled bilinear fetch from a small float LUT -> [..., 2].

    Mirrors the shader's clamp-sampler GGX LUT closure
    (shader/src/lib.rs:126-133) with uv = (u, v) = (NoV, roughness).
    """
    s = lut.shape[0]
    x = jnp.clip(u * s - 0.5, 0.0, s - 1.0)
    y = jnp.clip(v * s - 0.5, 0.0, s - 1.0)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, s - 1)
    y1 = jnp.minimum(y0 + 1, s - 1)
    fx = (x - x0.astype(jnp.float32))[..., None]
    fy = (y - y0.astype(jnp.float32))[..., None]
    c00 = lut[y0, x0]
    c10 = lut[y0, x1]
    c01 = lut[y1, x0]
    c11 = lut[y1, x1]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy

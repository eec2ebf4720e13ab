"""Texture atlas: the replacement for bindless sampled images.

The reference binds up to 193 images as a partially-bound descriptor array
(src/main.rs:59, src/descriptor_sets.rs:30-80) and lets sampler hardware do
bilinear/trilinear filtering, wrap modes, and sRGB decode. Here sampling
is gather-based (SURVEY.md §2.5), and the atlas layout is built around
minimising gathers per tap AND rows per table (whether the row grouping
pays on the GPU is not measured yet — ROADMAP D2):

**Quad-block layout.** Each mip level is stored as 2x2 texel blocks in
FOUR phase-shifted copies (block origins at (even,even), (even,odd),
(odd,even), (odd,odd)). Any bilinear footprint {x0,x0+1}x{y0,y0+1} is then
fully contained in exactly one block of the phase (y0&1, x0&1), so one
bilinear tap = ONE row gather (vs 4 scalar gathers for a row-major
layout), and trilinear = 2 gathers; QUAD_GROUP consecutive blocks pack
into each physical row to shrink the row count 4x (the sub-block select
is register work). Wrap behaviour at the edges
(the +1 neighbour of the last row/column) is baked into the edge blocks at
build time per image (``wrap`` arg of ``push_image``); sampling with the
matching mode is exact everywhere, sampling with the other mode is exact
in the interior.

Memory cost: 4x texels — irrelevant next to HBM capacity, and gathers (not
bandwidth) are the texture-path bottleneck.

A small int32 metadata table holds per-image level-0 size + per-mip block
offsets; level sizes are the closed form max(size0 >> level, 1), so no
per-mip size columns are needed. Mip chains are generated here at load
time the way ``generate_mips``'s LINEAR blit chain does (2x2 box). sRGB
decode matches Vulkan's R8G8B8A8_SRGB (src/model_loading.rs:348-352).
"""

from __future__ import annotations

import os

import numpy as np

# Metadata layout per image row:
#   [0] num_mips, [1] srgb flag, [2] level-0 width, [3] level-0 height,
#   [4 + m] quad-block offset of mip m (m < MAX_MIPS),
#   [4 + MAX_MIPS] the image's LAYER count (per-image block width).
# Level-m sizes are max(size0 >> m, 1) (floor(n/2) chain == shift chain).
MAX_MIPS = 13  # up to 4096x4096
META_LAYERS_COL = 4 + MAX_MIPS
META_COLS = 5 + MAX_MIPS

# Quad-blocks packed per physical atlas row: grouping consecutive blocks
# per row cuts the table's row count (the layout's cost model; ROADMAP
# D2). Logical quad indices are unchanged;
# samplers fetch row qidx >> shift and select the sub-block
# qidx & (G - 1) in registers. The GATHERED rows materialise in HBM (the
# optimization_barrier that keeps XLA from re-splitting the wide gather),
# so the group must SHRINK as blocks widen: the atlas array is
# [R, G, BLOCK_TEXELS*4L] with G chosen per layer count by
# quad_group_for_layers (a 5-layer trirow bundle at G=4 would
# materialise 8+ GB per 2M-pixel tap).
QUAD_GROUP = 4  # single-layer default (and the LUT pools' fixed group)
QUAD_GROUP_SHIFT = 2


# Atlas texel storage dtype. Half-width texels halve every gathered
# byte. Precision: decoded u8 sRGB values round to bf16 with relative error
# <= 2^-8 ~= 4e-3 of value, below the SOURCE texels' own 8-bit
# quantisation step (1/255 absolute) and inside the 1e-3 frame-RMSE
# budget (docs/FIDELITY.md; goldens re-verified on this dtype).
ATLAS_DTYPE = np.dtype("bfloat16") if hasattr(np, "bfloat16") else None
if ATLAS_DTYPE is None:  # numpy bfloat16 rides ml_dtypes
    import ml_dtypes

    ATLAS_DTYPE = np.dtype(ml_dtypes.bfloat16)


# Target flat-row width in ELEMENTS of the [R, W] atlas rows.
ATLAS_ROW_ELEMS = int(
    os.environ.get("TRTPU_ATLAS_ROW_ELEMS", "128").replace("auto", "0")
)
# ("auto" parses to 0 and is treated as the 128-element default.)


WRAP_REPEAT = 0
WRAP_CLAMP = 1

# Texture references in material columns pack (image id | layer << SHIFT)
# so bundle layers ride the existing int columns; -1 stays "no texture".
LAYER_SHIFT = 16
IMAGE_MASK = (1 << LAYER_SHIFT) - 1


def texture_ref(image_id: int, layer: int = 0) -> int:
    """Pack an atlas entry + bundle layer into one material texture ref."""
    assert 0 <= image_id <= IMAGE_MASK and layer >= 0
    return image_id | (layer << LAYER_SHIFT)


def mip_levels_for_size(width: int, height: int) -> int:
    """floor(log2(max(w,h))) + 1 (src/main.rs:2590-2592)."""
    return int(np.floor(np.log2(max(width, height)))) + 1


def _box_downsample(img: np.ndarray) -> np.ndarray:
    """2x2 average in linear space of the stored encoding.

    Vulkan's LINEAR blit averages raw (encoded) texel values; we match that
    (byte-space averaging) for fidelity with the reference's mip chains.
    Odd dimensions follow the blit's floor(n/2) convention.
    """
    h, w = img.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    img = img[: nh * 2, : nw * 2].astype(np.float32)
    if h == 1:
        pooled = (img[:, 0::2] + img[:, 1::2]) / 2.0
    elif w == 1:
        pooled = (img[0::2] + img[1::2]) / 2.0
    else:
        pooled = (
            img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2] + img[1::2, 1::2]
        ) / 4.0
    return np.round(pooled).astype(np.uint8)


def _pack_rgba8(img: np.ndarray) -> np.ndarray:
    """[H, W, 4] uint8 -> [H, W] uint32 (r | g<<8 | b<<16 | a<<24)."""
    img = img.astype(np.uint32)
    return img[..., 0] | (img[..., 1] << 8) | (img[..., 2] << 16) | (img[..., 3] << 24)


def _decode_rgba8(img: np.ndarray, srgb: bool) -> np.ndarray:
    """[H, W, 4] uint8 -> [H, W, 4] float32 linear, exactly what sampling
    an R8G8B8A8_SRGB/UNORM texture yields: /255, then the sRGB EOTF on
    RGB when ``srgb`` (alpha always linear). Decoding happens ONCE here at
    atlas-build time — per-texel decode work (u8 unpack + two pow-2.4
    evals per RGB channel) would otherwise run per SAMPLE in the shading
    hot loop, ~48M pow evals per 1080p frame."""
    f = img.astype(np.float32) / np.float32(255.0)
    if srgb:
        f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:]], axis=-1)
    return f.astype(np.float32)


def quad_block_counts(width: int, height: int) -> tuple[int, int]:
    """(bw, bh): per-phase block-grid size for a level of (width, height)."""
    return (width + 1) // 2, (height + 1) // 2


# Texels per quad-block. Two layouts, chosen once per process:
#   fused (13): 4 level-l texels + the 3x3 level-(l+1) patch that
#     contains every bilinear footprint the SAME uv can produce one
#     level coarser (see _quad_blocks) -> a trilinear tap is ONE gather.
#   compact (4): just the bilinear footprint -> trilinear is the classic
#     2-gather two-level blend, but rows are 3.25x narrower AND (at the
#     208 B row target) the table has half the rows.
# The compact layout is the default; TRTPU_ATLAS_FUSED=1 selects the
# fused one (ROADMAP D4: measure it on the GPU or remove it).
ATLAS_FUSED = os.environ.get("TRTPU_ATLAS_FUSED", "0") == "1"
BLOCK_TEXELS = 13 if ATLAS_FUSED else 4


def _quad_blocks(
    texels: np.ndarray, wrap: int, parent: np.ndarray | None = None
) -> np.ndarray:
    """[H, W, C] float32 -> [4 * bh * bw, BLOCK_TEXELS * C] phase-shifted
    fused blocks: 4 level-l texels (t00 t10 t01 t11, texel-major) followed
    by the 3x3 level-(l+1) patch (row-major), each with C channels.

    Block (phase=(py,px), by, bx) holds texels at (y0, x0), (y0, x0+1),
    (y0+1, x0), (y0+1, x0+1) with y0 = 2*by + py, x0 = 2*bx + px, and the
    wrap mode applied to out-of-range coordinates (REPEAT: mod, CLAMP:
    clamp-to-edge) — matching what a Vulkan sampler's per-tap wrap does.

    The parent patch covers parent texels (y0>>1) - 1 .. (y0>>1) + 1 x
    (x0>>1) - 1 .. (x0>>1) + 1 of ``parent`` (the next-coarser mip level;
    pass the level itself at the chain's end). For any uv whose level-l
    bilinear footprint is this block, the level-(l+1) footprint's corner
    x0' lies in {x0>>1 - 1, x0>>1} (exact for even level sizes, and for
    the odd sizes of non-POT chains too: x' = (x+0.5)*w1/w0 - 0.5 with
    w1/w0 <= 1/2 keeps floor(x') within that pair, see
    ops/texture.py::sample_bundle_rows fused path), so the 3x3 patch
    contains the whole 2x2 parent footprint. REPEAT addressing of the
    patch is only coherent for power-of-two chains (odd sizes break the
    halving relation under modular wrap) — the fused sampler is gated on
    POT scenes; the plain 2-gather path ignores the patch entirely.
    """
    h, w, c = texels.shape
    bw, bh = quad_block_counts(w, h)
    if parent is None:
        parent = texels
    ph, pw = parent.shape[:2]

    def wrapc(v, size):
        return v % size if wrap == WRAP_REPEAT else np.clip(v, 0, size - 1)

    out = np.empty((4, bh, bw, BLOCK_TEXELS, c), np.float32)
    for py in (0, 1):
        for px in (0, 1):
            xs0 = wrapc(2 * np.arange(bw) + px, w)
            xs1 = wrapc(2 * np.arange(bw) + px + 1, w)
            ys0 = wrapc(2 * np.arange(bh) + py, h)
            ys1 = wrapc(2 * np.arange(bh) + py + 1, h)
            p = 2 * py + px
            out[p, :, :, 0] = texels[np.ix_(ys0, xs0)]
            out[p, :, :, 1] = texels[np.ix_(ys0, xs1)]
            out[p, :, :, 2] = texels[np.ix_(ys1, xs0)]
            out[p, :, :, 3] = texels[np.ix_(ys1, xs1)]
            if not ATLAS_FUSED:
                continue
            # 3x3 parent patch around (x0 >> 1, y0 >> 1)
            kx = xs0 >> 1
            ky = ys0 >> 1
            for dy in (-1, 0, 1):
                pys = wrapc(ky + dy, ph)
                for dx in (-1, 0, 1):
                    pxs = wrapc(kx + dx, pw)
                    out[p, :, :, 4 + 3 * (dy + 1) + (dx + 1)] = parent[
                        np.ix_(pys, pxs)
                    ]
    return out.reshape(-1, BLOCK_TEXELS * c)


class AtlasBuilder:
    """Accumulates images; ``finish()`` yields (quads, meta, srgb) arrays.

    Plays the role of ``ImageManager`` (src/model_loading.rs:392-436): push
    an image, get back a stable integer id.

    Texels are stored PRE-DECODED to linear float32 (see _decode_rgba8) so
    sampling is pure gather + lerp. ``push_bundle`` stores several
    same-size images as LAYERS of one atlas entry: all layers of a 2x2
    block share one physical row, so a material whose textures are bundled
    pays ONE gather for every texture tap at the same uv (the dominant
    deferred-shading cost — a 5-texture DamagedHelmet-style material
    would otherwise pay 5x). The atlas's layer count is the max bundle
    size pushed (smaller entries zero-pad); the sampler derives it from
    the row width, so single-texture scenes pay nothing.
    """

    def __init__(self):
        # per entry: (per-level [H, W, 4*layers] float32 chains, wrap)
        self._images: list[tuple[list[np.ndarray], int]] = []
        self._meta: list[np.ndarray] = []
        self._srgb: list[bool] = []
        self._offset = 0  # in quad-block rows (layer-count independent)

    def push_bundle(
        self,
        rgbas: list[np.ndarray],
        srgbs: list[bool],
        generate_mips: bool = True,
        wrap: int = WRAP_REPEAT,
    ) -> int:
        """Add same-size RGBA8 images as one multi-layer atlas entry (+
        mip chains); returns its texture id. Layer k of the entry samples
        image k. ``wrap`` chooses the edge behaviour baked into boundary
        blocks; it must match the wrap mode the entry will be sampled
        with (material textures use REPEAT, the reference's sampler)."""
        assert rgbas and len(rgbas) == len(srgbs)
        h, w = rgbas[0].shape[:2]
        for r in rgbas:
            assert r.dtype == np.uint8 and r.shape == (h, w, 4), r.shape
        image_id = len(self._meta)
        levels = mip_levels_for_size(w, h) if generate_mips else 1
        levels = min(levels, MAX_MIPS)
        row = np.zeros(META_COLS, np.int32)
        row[0] = levels
        row[1] = int(srgbs[0])
        row[2] = w
        row[3] = h
        level_imgs = list(rgbas)
        chains = []
        for m in range(levels):
            row[4 + m] = self._offset
            # mips are generated in BYTE space (matching the reference's
            # LINEAR blit chain) and decoded per level
            dec = np.concatenate(
                [_decode_rgba8(im, s) for im, s in zip(level_imgs, srgbs)],
                axis=-1,
            )
            chains.append(dec)
            bw, bh = quad_block_counts(*dec.shape[1::-1])
            self._offset += 4 * bh * bw
            if m + 1 < levels:
                level_imgs = [_box_downsample(im) for im in level_imgs]
        # Unused mip slots alias the last level so out-of-range LOD
        # clamps are just index clamps (re-derived in finish()).
        row[4 + levels : META_LAYERS_COL] = row[4 + levels - 1]
        self._meta.append(row)
        self._srgb.append(bool(srgbs[0]))
        self._images.append((chains, wrap))
        return image_id

    def push_image(
        self,
        rgba: np.ndarray,
        srgb: bool,
        generate_mips: bool = True,
        wrap: int = WRAP_REPEAT,
    ) -> int:
        """Add one RGBA8 image (+ its mip chain); returns its texture id."""
        return self.push_bundle([rgba], [srgb], generate_mips, wrap)

    @property
    def num_images(self) -> int:
        return len(self._meta)

    @property
    def layers(self) -> int:
        """Max bundle width pushed so far (the atlas's static layer count)."""
        return max(
            (c[0].shape[-1] // 4 for c, _ in self._images), default=1
        )

    def finish(self):
        """-> (quads [R, W] flat rows, meta, srgb).

        PER-IMAGE row groups: every image packs its own blocks at its own
        group G_i = the number of its (BLOCK_TEXELS*4*L_i-element) blocks
        that fill a row, so single-layer images never pay a multi-layer
        bundle's block width. (The previous design padded EVERY image to
        the pool max layer count: the helmet scene's checker + occlusion
        carried 3 dead layers each — 2/3 of its 524k-row table was zero
        padding, and gather cost scales with table rows/bytes.) Each
        image starts at a fresh physical row; meta mip offsets are
        VIRTUAL block indices (row_base * G_i + local block), so samplers
        address row = off >> shift_i, sub-block = off & (G_i - 1) with
        the per-image group derived from the meta layers column
        (ops/texture.py::image_groups). Images whose block width exceeds
        the row width get G_i = 1 and set the row width."""
        if not self._meta:
            # 1x1 white dummy so the pools are never empty.
            self.push_image(np.full((1, 1, 4), 255, np.uint8), srgb=False)
        row_elems = max(
            ATLAS_ROW_ELEMS if ATLAS_ROW_ELEMS else 128,
            max(
                BLOCK_TEXELS * 4 * (c[0].shape[-1] // 4)
                for c, _ in self._images
            ),
        )
        rows_out = []
        metas = []
        row_base = 0
        for (chains, wrap), meta_row in zip(self._images, self._meta):
            layers = chains[0].shape[-1] // 4
            block_elems = BLOCK_TEXELS * 4 * layers
            g = max(1, row_elems // block_elems)
            g = 1 << max(g.bit_length() - 1, 0)
            blocks = []
            row = meta_row.copy()
            levels = int(row[0])
            local = 0
            for m, dec in enumerate(chains):
                # rebase mip offsets into this image's virtual block
                # index space (the push-time global offsets are unused)
                row[4 + m] = row_base * g + local
                # level m's blocks carry the 3x3 level-(m+1) patch for
                # the fused single-gather trilinear tap; the chain's last
                # level stores itself (weight-0 at sample time)
                parent = chains[m + 1] if m + 1 < len(chains) else dec
                blk = _quad_blocks(dec, wrap, parent)
                blocks.append(blk)
                local += len(blk)
            # unused mip slots alias the last level (LOD clamp = index
            # clamp), re-derived after the rebase
            row[4 + levels : META_LAYERS_COL] = row[4 + levels - 1]
            row[META_LAYERS_COL] = layers
            q = np.concatenate(blocks)  # [N_i, block_elems]
            pad = (-len(q)) % g
            if pad:
                q = np.concatenate(
                    [q, np.zeros((pad, block_elems), np.float32)]
                )
            q = q.reshape(-1, g * block_elems)
            if q.shape[1] < row_elems:
                q = np.pad(q, ((0, 0), (0, row_elems - q.shape[1])))
            rows_out.append(q)
            metas.append(row)
            row_base += len(q)
            assert row_base * g < (1 << 24), "atlas offsets exceed f32 range"
        quads = np.concatenate(rows_out).astype(ATLAS_DTYPE)
        meta = np.stack(metas)
        # STATIC class tag: the set of distinct layer counts rides the
        # meta WIDTH as a bitmask (bit L-1 set when some image has L
        # layers), so samplers recover it through jit without any pytree
        # aux plumbing (ops/texture.py::atlas_classes). Row width comes
        # from the pool array itself.
        mask = 0
        for row in metas:
            mask |= 1 << (int(row[META_LAYERS_COL]) - 1)
        meta = np.pad(meta, ((0, 0), (0, mask)))
        srgb = np.array(self._srgb, bool)
        return quads, meta, srgb


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """Exact sRGB EOTF (what R8G8B8A8_SRGB sampling applies)."""
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)

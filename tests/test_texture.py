"""Texture atlas + sampling tests vs NumPy oracles."""

import numpy as np
import jax.numpy as jnp

from transmission_renderer_tpu.ops.texture import (
    WRAP_CLAMP,
    WRAP_REPEAT,
    sample_lut_2ch,
    sample_texture,
)
from transmission_renderer_tpu.scene.textures import (
    AtlasBuilder,
    linear_to_srgb,
    mip_levels_for_size,
    srgb_to_linear,
)


def test_mip_levels_for_size():
    assert mip_levels_for_size(1, 1) == 1
    assert mip_levels_for_size(2, 2) == 2
    assert mip_levels_for_size(1024, 1024) == 11
    assert mip_levels_for_size(1920, 1080) == 11


def test_srgb_roundtrip():
    x = np.linspace(0, 1, 64)
    np.testing.assert_allclose(linear_to_srgb(srgb_to_linear(x)), x, atol=1e-5)


def _atlas_with(img, srgb=False):
    ab = AtlasBuilder()
    tid = ab.push_image(img, srgb=srgb)
    texels, meta, srgb_t = ab.finish()
    return tid, jnp.asarray(texels), jnp.asarray(meta), jnp.asarray(srgb_t)


def test_nearest_texel_exact():
    """Sampling at texel centres returns the texel values (linear tex) up
    to the atlas's bf16 storage quantisation (<= 2^-9 relative, i.e.
    <= ~2e-3 absolute for values in [0,1] — below the u8 source's own
    1/255 step, scene/textures.py)."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (8, 16, 4)).astype(np.uint8)
    tid, texels, meta, srgb_t = _atlas_with(img)
    ys, xs = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    uv = jnp.asarray(
        np.stack([(xs + 0.5) / 16.0, (ys + 0.5) / 8.0], -1).astype(np.float32)
    )
    out = sample_texture(
        texels, meta, srgb_t, jnp.int32(tid), uv, jnp.zeros((8, 16)), WRAP_REPEAT,
        trilinear=False,
    )
    np.testing.assert_allclose(
        np.asarray(out), img.astype(np.float32) / 255.0, atol=2.1e-3
    )


def test_bilinear_midpoint():
    img = np.zeros((2, 2, 4), np.uint8)
    img[0, 0] = [0, 0, 0, 255]
    img[0, 1] = [255, 0, 0, 255]
    img[1, 0] = [0, 255, 0, 255]
    img[1, 1] = [255, 255, 0, 255]
    tid, texels, meta, srgb_t = _atlas_with(img)
    out = sample_texture(
        texels, meta, srgb_t, jnp.int32(tid),
        jnp.array([0.5, 0.5], jnp.float32), jnp.float32(0.0), WRAP_CLAMP,
        trilinear=False,
    )
    np.testing.assert_allclose(np.asarray(out), [0.5, 0.5, 0.0, 1.0], atol=1e-6)


def test_srgb_decode_on_sample():
    img = np.full((4, 4, 4), 128, np.uint8)
    tid, texels, meta, srgb_t = _atlas_with(img, srgb=True)
    out = sample_texture(
        texels, meta, srgb_t, jnp.int32(tid),
        jnp.array([0.5, 0.5], jnp.float32), jnp.float32(0.0),
    )
    expected_rgb = srgb_to_linear(128 / 255.0)
    # atol covers the bf16 atlas quantisation (<= 2^-9 relative)
    np.testing.assert_allclose(np.asarray(out[:3]), [expected_rgb] * 3, atol=2.1e-3)
    # alpha stays linear
    np.testing.assert_allclose(float(out[3]), 128 / 255.0, atol=2.1e-3)


def test_wrap_repeat():
    img = np.zeros((1, 4, 4), np.uint8)
    img[0, :, 0] = [0, 64, 128, 192]
    img[..., 3] = 255
    tid, texels, meta, srgb_t = _atlas_with(img)
    # uv.x = 1.125 wraps to 0.125 -> texel 0 centre
    a = sample_texture(
        texels, meta, srgb_t, jnp.int32(tid),
        jnp.array([1.125, 0.5], jnp.float32), jnp.float32(0.0), WRAP_REPEAT,
        trilinear=False,
    )
    b = sample_texture(
        texels, meta, srgb_t, jnp.int32(tid),
        jnp.array([0.125, 0.5], jnp.float32), jnp.float32(0.0), WRAP_REPEAT,
        trilinear=False,
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_trilinear_lod_blend():
    """LOD 1 returns the mip-1 (box-average) value; LOD 0.5 blends."""
    img = np.zeros((4, 4, 4), np.uint8)
    img[0::2, 0::2] = 255  # checker: mip1 averages to ~128
    img[..., 3] = 255
    tid, texels, meta, srgb_t = _atlas_with(img)
    uv = jnp.array([0.25, 0.25], jnp.float32)
    lod1 = sample_texture(texels, meta, srgb_t, jnp.int32(tid), uv, jnp.float32(1.0))
    # mip1 texel = round(mean of 2x2 block [255,0,0,0]-ish) per channel
    block = img[:2, :2].astype(np.float32).mean((0, 1))
    np.testing.assert_allclose(
        np.asarray(lod1), np.round(block) / 255.0, atol=1 / 255 + 1e-6
    )
    lod0 = sample_texture(texels, meta, srgb_t, jnp.int32(tid), uv, jnp.float32(0.0))
    lod05 = sample_texture(texels, meta, srgb_t, jnp.int32(tid), uv, jnp.float32(0.5))
    np.testing.assert_allclose(
        np.asarray(lod05), (np.asarray(lod0) + np.asarray(lod1)) / 2.0, atol=1e-6
    )


def test_lut_sampling():
    lut = jnp.asarray(np.linspace(0, 1, 16 * 16 * 2).reshape(16, 16, 2).astype(np.float32))
    # centre of texel (3, 5): u = (5+0.5)/16, v = (3+0.5)/16
    out = sample_lut_2ch(lut, jnp.float32(5.5 / 16), jnp.float32(3.5 / 16))
    np.testing.assert_allclose(np.asarray(out), np.asarray(lut[3, 5]), atol=1e-6)
    # clamped outside
    out2 = sample_lut_2ch(lut, jnp.float32(-1.0), jnp.float32(2.0))
    np.testing.assert_allclose(np.asarray(out2), np.asarray(lut[15, 0]), atol=1e-6)


def test_quad_lut_matches_reference_sampler():
    from transmission_renderer_tpu.ops.texture import (
        quad_lut_2ch,
        sample_lut_2ch_quad,
    )

    rng = np.random.default_rng(11)
    lut = jnp.asarray(rng.uniform(0, 1, (32, 32, 2)).astype(np.float32))
    u = jnp.asarray(rng.uniform(-0.3, 1.3, 2048).astype(np.float32))
    v = jnp.asarray(rng.uniform(-0.3, 1.3, 2048).astype(np.float32))
    a = np.asarray(sample_lut_2ch(lut, u, v))
    b = np.asarray(sample_lut_2ch_quad(quad_lut_2ch(lut), 32, u, v))
    np.testing.assert_array_equal(a, b)


def _force_fused_layout(monkeypatch):
    """Build + sample with the FUSED atlas layout regardless of the
    process default (scene/textures.py::ATLAS_FUSED env switch)."""
    import transmission_renderer_tpu.scene.textures as tx

    monkeypatch.setattr(tx, "ATLAS_FUSED", True)
    monkeypatch.setattr(tx, "BLOCK_TEXELS", 13)


def test_fused_trilinear_matches_two_gather(monkeypatch):
    """The single-gather fused trilinear path (in-block 3x3 parent patch)
    must reproduce the classic 2-gather two-level blend bitwise on POT
    textures, REPEAT and CLAMP, across uv (incl. out-of-range) and lod
    (incl. beyond the mip chain)."""
    from transmission_renderer_tpu.ops.texture import sample_bundle_rows

    _force_fused_layout(monkeypatch)

    rng = np.random.default_rng(11)
    for size in ((16, 16), (64, 32), (8, 1), (4, 4)):
        img = rng.integers(0, 256, (size[1], size[0], 4)).astype(np.uint8)
        for wrap in (WRAP_REPEAT, WRAP_CLAMP):
            ab = AtlasBuilder()
            ab.push_image(img, srgb=True, wrap=wrap)
            texels, meta, _ = ab.finish()
            from transmission_renderer_tpu.ops.texture import atlas_classes
            from transmission_renderer_tpu.scene.textures import META_COLS
            classes = atlas_classes(meta)
            rows = jnp.asarray(np.broadcast_to(
                meta[0, :META_COLS], (512, META_COLS)
            ))
            uv = jnp.asarray(
                rng.uniform(-1.5, 2.5, (512, 2)).astype(np.float32)
            )
            lod = jnp.asarray(
                rng.uniform(-1.0, 14.0, (512,)).astype(np.float32)
            )
            plain = sample_bundle_rows(
                jnp.asarray(texels), rows, uv, lod, wrap, fused=False,
                classes=classes,
            )
            fused = sample_bundle_rows(
                jnp.asarray(texels), rows, uv, lod, wrap, fused=True,
                classes=classes,
            )
            np.testing.assert_array_equal(
                np.asarray(fused), np.asarray(plain),
                err_msg=f"size={size} wrap={wrap}",
            )


def test_fused_trilinear_matches_bundled(monkeypatch):
    """Fused path with multi-layer bundles."""
    from transmission_renderer_tpu.ops.texture import sample_bundle_rows

    _force_fused_layout(monkeypatch)

    rng = np.random.default_rng(13)
    imgs = [rng.integers(0, 256, (32, 32, 4)).astype(np.uint8) for _ in range(3)]
    ab = AtlasBuilder()
    ab.push_bundle(imgs, [True, False, True])
    texels, meta, _ = ab.finish()
    from transmission_renderer_tpu.ops.texture import atlas_classes
    from transmission_renderer_tpu.scene.textures import META_COLS
    classes = atlas_classes(meta)
    rows = jnp.asarray(np.broadcast_to(
        meta[0, :META_COLS], (256, META_COLS)
    ))
    uv = jnp.asarray(rng.uniform(-1, 2, (256, 2)).astype(np.float32))
    lod = jnp.asarray(rng.uniform(0, 8.0, (256,)).astype(np.float32))
    plain = sample_bundle_rows(
        jnp.asarray(texels), rows, uv, lod, fused=False, classes=classes
    )
    fused = sample_bundle_rows(
        jnp.asarray(texels), rows, uv, lod, fused=True, classes=classes
    )
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(plain))


def test_frame_ab_knobs_change_layout(monkeypatch):
    """The atlas builder reads the layout module globals at build time (a
    frozen import would silently ignore an override)."""
    import transmission_renderer_tpu.scene.textures as tx

    img = np.full((16, 16, 4), 128, np.uint8)

    def build():
        ab = AtlasBuilder()
        ab.push_image(img, srgb=True)
        return ab.finish()

    t128, m128, _ = build()
    monkeypatch.setattr(tx, "ATLAS_ROW_ELEMS", 512)
    t512, m512, _ = build()
    from transmission_renderer_tpu.ops.texture import atlas_classes
    assert atlas_classes(m512) == atlas_classes(m128) == (1,)
    assert t512.shape[-1] == 4 * t128.shape[-1]



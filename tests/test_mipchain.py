"""Mip pyramid tests."""

import numpy as np
import jax.numpy as jnp

from transmission_renderer_tpu.ops.mipchain import (
    build_pyramid,
    pyramid_shapes,
    sample_pyramid_lod,
)


def test_pyramid_shapes_1080p():
    shapes = pyramid_shapes(1920, 1080)
    assert shapes[0] == (1920, 1080)
    assert shapes[1] == (960, 540)
    assert shapes[-1][0] >= 1 and shapes[-1][1] >= 1
    assert len(shapes) == 11


def test_build_pyramid_averages():
    img = np.zeros((4, 8, 3), np.float32)
    img[0::2, 0::2] = 1.0
    pyr = build_pyramid(jnp.asarray(img))
    # level 1 = 2x2 averages = 0.25 everywhere: sample its texel centres
    w1, h1 = 4, 2
    ys, xs = np.meshgrid(np.arange(h1), np.arange(w1), indexing="ij")
    uv = jnp.asarray(
        np.stack([(xs + 0.5) / w1, (ys + 0.5) / h1], -1).astype(np.float32)
    )
    level1 = np.asarray(sample_pyramid_lod(pyr, uv, jnp.full((h1, w1), 1.0)))
    np.testing.assert_allclose(level1, 0.25, atol=1e-6)
    # top level = overall mean
    top = sample_pyramid_lod(
        pyr,
        jnp.array([0.5, 0.5], jnp.float32),
        jnp.float32(pyr.num_levels - 1),
    )
    np.testing.assert_allclose(np.asarray(top), [0.25, 0.25, 0.25], atol=1e-6)


def test_sample_lod0_exact():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    pyr = build_pyramid(jnp.asarray(img))
    ys, xs = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    uv = jnp.asarray(np.stack([(xs + 0.5) / 8, (ys + 0.5) / 8], -1).astype(np.float32))
    out = sample_pyramid_lod(pyr, uv, jnp.zeros((8, 8)))
    np.testing.assert_allclose(np.asarray(out), img, atol=1e-6)


def test_sample_clamps_uv_and_lod():
    img = np.ones((4, 4, 3), np.float32)
    pyr = build_pyramid(jnp.asarray(img))
    out = sample_pyramid_lod(
        pyr,
        jnp.array([[-0.5, 2.0], [0.5, 0.5]], jnp.float32),
        jnp.array([99.0, -1.0], jnp.float32),
    )
    np.testing.assert_allclose(np.asarray(out), 1.0, atol=1e-6)
    assert np.isfinite(np.asarray(out)).all()


def test_level_set_matches_dynamic_fetch():
    """The static level_set fetch equals the dynamic two-level lerp for
    every lod inside the set (up to fp reassociation of the tent sum)."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 4, (64, 36, 3)).astype(np.float32)
    pyr = build_pyramid(jnp.asarray(img))
    uv = jnp.asarray(rng.uniform(-0.2, 1.2, (256, 2)).astype(np.float32))
    lod = jnp.asarray(rng.uniform(1.0, 3.0, (256,)).astype(np.float32))
    ref = np.asarray(sample_pyramid_lod(pyr, uv, lod))
    got = np.asarray(sample_pyramid_lod(pyr, uv, lod, level_set=(1, 2, 3)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_level_set_clamps_out_of_set_lods():
    img = np.full((16, 16, 3), 2.0, np.float32)
    pyr = build_pyramid(jnp.asarray(img))
    uv = jnp.array([[0.5, 0.5], [0.25, 0.75]], jnp.float32)
    out = sample_pyramid_lod(
        pyr, uv, jnp.array([0.0, 99.0], jnp.float32), level_set=(2, 3)
    )
    np.testing.assert_allclose(np.asarray(out), 2.0, atol=1e-6)


def test_refraction_level_set_derivation():
    from transmission_renderer_tpu.render.frame import (
        SceneFlags, refraction_level_set,
    )

    # rough dragon: ior-adjusted roughness 0.25 at 1920 wide -> lod ~2.73
    f = SceneFlags(True, True, transmission_ior_roughness=(0.25,))
    assert refraction_level_set(f, 1920, 12) == (2, 3)
    # roughness 0: exactly-integer lod -> single level, single tap
    f0 = SceneFlags(True, True, transmission_ior_roughness=(0.0,))
    assert refraction_level_set(f0, 1920, 12) == (0,)
    # textured roughness -> dynamic path
    fd = SceneFlags(True, True, transmission_ior_roughness=None)
    assert refraction_level_set(fd, 1920, 12) is None
    # multiple materials span a contiguous range
    fm = SceneFlags(True, True, transmission_ior_roughness=(0.1, 0.4))
    ls = fm and refraction_level_set(fm, 1920, 12)
    assert ls[0] <= 1 and ls[-1] >= 4 and ls == tuple(range(ls[0], ls[-1] + 1))


def test_planar_downsample_chain_bit_exact():
    # the pyramid's downsample chain runs per channel plane; every output
    # element is the same adds in the same order as the interleaved
    # [H, W, 3] chain, so every level must be BIT-identical to it
    import transmission_renderer_tpu.ops.mipchain as mip

    rng = np.random.default_rng(7)
    inter = jnp.asarray(rng.standard_normal((37, 53, 3)).astype(np.float32))
    planes = [inter[..., c] for c in range(3)]
    for _ in range(5):
        inter = mip._downsample2x(inter)
        planes = [mip._downsample2x_plane_matmul(p) for p in planes]
        assert np.array_equal(
            np.asarray(inter), np.stack([np.asarray(p) for p in planes], -1)
        )


def test_rows_form_levels_bit_exact(monkeypatch):
    """Big level_set levels stored in ROW form (the level image + a
    4-gather tap) must sample bit-identically to their quad tables."""
    import transmission_renderer_tpu.ops.mipchain as mc

    rng = np.random.default_rng(5)
    img = rng.uniform(0, 4, (96, 160, 3)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (512, 2)).astype(np.float32)
    lod = rng.uniform(0.0, 2.0, 512).astype(np.float32)
    level_set = (0, 1, 2)

    monkeypatch.setattr(mc, "ROWS_FORM_MIN_TEXELS", 1 << 60)
    pyr_quads = mc.build_pyramid(jnp.asarray(img), level_set=level_set)
    assert all(r is None for r in pyr_quads.level_rows)
    a = np.asarray(mc.sample_pyramid_lod(
        pyr_quads, jnp.asarray(uv), jnp.asarray(lod), level_set=level_set
    ))

    monkeypatch.setattr(mc, "ROWS_FORM_MIN_TEXELS", 1)
    pyr_rows = mc.build_pyramid(jnp.asarray(img), level_set=level_set)
    assert all(
        pyr_rows.level_rows[k] is not None for k in level_set
    )
    b = np.asarray(mc.sample_pyramid_lod(
        pyr_rows, jnp.asarray(uv), jnp.asarray(lod), level_set=level_set
    ))
    np.testing.assert_array_equal(a, b)


def test_wide_level_set_two_tap_bit_exact():
    """Sets wider than 3 levels fetch only the two bracketing levels per
    pixel (_bilinear_level_set_dynamic); the result must be BIT-identical
    to the straight per-level tent sum (the skipped taps carry exact 0.0
    weight), including with a ROW-form level 0 in the set and lods
    pinned exactly on level integers and the set's ends."""
    import transmission_renderer_tpu.ops.mipchain as mc

    rng = np.random.default_rng(13)
    img = rng.uniform(0, 4, (96, 160, 3)).astype(np.float32)
    uv = jnp.asarray(rng.uniform(-0.2, 1.2, (512, 2)).astype(np.float32))
    lod_vals = np.concatenate([
        rng.uniform(0.0, 4.0, 504).astype(np.float32),
        np.array([0.0, 1.0, 2.0, 3.0, 4.0, 3.9999998, 0.0000001, 2.5],
                 np.float32),
    ])
    lod = jnp.asarray(lod_vals)
    level_set = (0, 1, 2, 3, 4)

    orig_min = mc.ROWS_FORM_MIN_TEXELS
    try:
        for rows_min in (1 << 60, 4000):  # all-quad, and level-0 ROW form
            mc.ROWS_FORM_MIN_TEXELS = rows_min
            pyr = mc.build_pyramid(jnp.asarray(img), level_set=level_set)
            got = np.asarray(mc.sample_pyramid_lod(
                pyr, uv, lod, level_set=level_set
            ))
            # reference: the per-level tent sum (the <=3-level form)
            lodc = jnp.clip(lod, 0.0, 4.0)
            ref = None
            for k in level_set:
                wk = jnp.clip(1.0 - jnp.abs(lodc - float(k)), 0.0, 1.0)[
                    ..., None
                ]
                ck = mc._bilinear_level_static(pyr, k, uv) * wk
                ref = ck if ref is None else ref + ck
            np.testing.assert_array_equal(got, np.asarray(ref))
    finally:
        mc.ROWS_FORM_MIN_TEXELS = orig_min


def test_mxu_downsample_bit_exact():
    """The 0/1-matrix matmul downsample == the explicit-adds oracle, bit
    for bit (CPU: two nonzero exact products per output, same
    (a+b)+(c+d) association), including odd-edge drops."""
    import transmission_renderer_tpu.ops.mipchain as mc

    rng = np.random.default_rng(11)
    for h, w in ((96, 160), (97, 161), (2, 2), (3, 5), (1, 8), (8, 1)):
        img = rng.uniform(-4, 4, (h, w)).astype(np.float32)
        a = np.asarray(mc._downsample2x(jnp.asarray(img)))
        b = np.asarray(mc._downsample2x_plane_matmul(jnp.asarray(img)))
        np.testing.assert_array_equal(a, b)


def test_build_pyramid_planes_input():
    """build_pyramid((r, g, b) planes) == build_pyramid([H, W, 3])."""
    import transmission_renderer_tpu.ops.mipchain as mc

    rng = np.random.default_rng(12)
    img = rng.uniform(0, 4, (64, 96, 3)).astype(np.float32)
    a = mc.build_pyramid(jnp.asarray(img), level_set=(1, 2))
    b = mc.build_pyramid(
        tuple(jnp.asarray(img[..., c]) for c in range(3)), level_set=(1, 2)
    )
    for qa, qb in zip(a.level_quads, b.level_quads):
        assert (qa is None) == (qb is None)
        if qa is not None:
            np.testing.assert_array_equal(np.asarray(qa), np.asarray(qb))

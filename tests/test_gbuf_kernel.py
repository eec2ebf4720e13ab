"""G-buffer-emitting Pallas kernel vs the vis-buffer + gather path."""

import numpy as np
import jax.numpy as jnp

from transmission_renderer_tpu.ops.raster import bin_triangles, rasterize, setup_triangles
from transmission_renderer_tpu.ops.raster_pallas_gbuf import (
    TILE_H,
    TILE_W,
    gather_gbuf_payload,
    pack_gbuf_payload,
    rasterize_gbuffer_pallas,
)
from transmission_renderer_tpu.render.gbuffer import interpolate_gbuffer
from transmission_renderer_tpu.scene.camera import look_at_rh, perspective_matrix_reversed

W, H = 256, 64


def test_gbuf_kernel_matches_gather_path():
    rng = np.random.default_rng(5)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0)
    )
    n_v, n_t = 40, 30
    pos = rng.uniform(-2, 2, (n_v, 3)).astype(np.float32)
    nrm = rng.normal(size=(n_v, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rng.uniform(0, 1, (n_v, 2)).astype(np.float32)
    tris = rng.integers(0, n_v, (n_t, 3))
    tris = tris[
        (tris[:, 0] != tris[:, 1])
        & (tris[:, 1] != tris[:, 2])
        & (tris[:, 0] != tris[:, 2])
    ].astype(np.int32)
    mat = rng.integers(0, 5, len(tris)).astype(np.int32)
    scale = rng.uniform(0.5, 2.0, len(tris)).astype(np.float32)

    ph = np.concatenate([pos, np.ones((n_v, 1), np.float32)], -1)
    clip = jnp.asarray((ph @ pv.T).astype(np.float32))
    setup = setup_triangles(
        clip, jnp.asarray(tris), jnp.ones(len(tris), bool), W, H, TILE_W, TILE_H
    )
    bins = bin_triangles(setup, W // TILE_W, H // TILE_H, 16, 64, 16,
                         materialize=True)

    # reference: vis buffer + gather interpolation
    vis = rasterize(setup, bins, W, H, TILE_W, TILE_H)
    g_ref = interpolate_gbuffer(
        vis, setup, jnp.asarray(tris), jnp.asarray(mat), jnp.asarray(scale),
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(uv), W, H,
    )

    records = pack_gbuf_payload(
        setup, jnp.asarray(tris), jnp.asarray(mat), jnp.asarray(scale),
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(uv),
    )
    g_got = rasterize_gbuffer_pallas(records, bins, W, H, interpret=True)

    np.testing.assert_array_equal(np.asarray(g_got.tri_id), np.asarray(g_ref.tri_id))
    np.testing.assert_allclose(np.asarray(g_got.depth), np.asarray(g_ref.depth), atol=1e-7)
    for field in ["position", "normal", "uv", "duv_dx", "duv_dy",
                  "dpos_dx", "dpos_dy", "model_scale"]:
        np.testing.assert_allclose(
            np.asarray(getattr(g_got, field)),
            np.asarray(getattr(g_ref, field)),
            atol=1e-4, rtol=1e-3, err_msg=field,
        )
    np.testing.assert_array_equal(
        np.asarray(g_got.material_id), np.asarray(g_ref.material_id)
    )


def test_gbuf_kernel_pos_derivs_off():
    """pos_derivs=False must match the full kernel on every channel except
    dpos (zeros — unread when no material has a normal map)."""
    rng = np.random.default_rng(7)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0)
    )
    n_v = 40
    pos = rng.uniform(-2, 2, (n_v, 3)).astype(np.float32)
    nrm = rng.normal(size=(n_v, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rng.uniform(0, 1, (n_v, 2)).astype(np.float32)
    tris = rng.integers(0, n_v, (30, 3))
    tris = tris[
        (tris[:, 0] != tris[:, 1])
        & (tris[:, 1] != tris[:, 2])
        & (tris[:, 0] != tris[:, 2])
    ].astype(np.int32)
    mat = rng.integers(0, 5, len(tris)).astype(np.int32)
    scale = rng.uniform(0.5, 2.0, len(tris)).astype(np.float32)

    ph = np.concatenate([pos, np.ones((n_v, 1), np.float32)], -1)
    clip = jnp.asarray((ph @ pv.T).astype(np.float32))
    setup = setup_triangles(
        clip, jnp.asarray(tris), jnp.ones(len(tris), bool), W, H, TILE_W, TILE_H
    )
    bins = bin_triangles(setup, W // TILE_W, H // TILE_H, 16, 64, 16,
                         materialize=True)
    records = pack_gbuf_payload(
        setup, jnp.asarray(tris), jnp.asarray(mat), jnp.asarray(scale),
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(uv),
    )
    g_full = rasterize_gbuffer_pallas(records, bins, W, H, interpret=True)
    g_nd = rasterize_gbuffer_pallas(records, bins, W, H, interpret=True,
                                    pos_derivs=False)
    for field in ["tri_id", "depth", "position", "normal", "uv",
                  "duv_dx", "duv_dy", "material_id", "model_scale"]:
        np.testing.assert_array_equal(
            np.asarray(getattr(g_nd, field)),
            np.asarray(getattr(g_full, field)), err_msg=field,
        )
    assert not np.asarray(g_nd.dpos_dx).any()
    assert not np.asarray(g_nd.dpos_dy).any()


def test_gbuf_kernel_uv_channels_off():
    """uv_channels=False must match the full kernel on every channel
    except uv/duv (zeros — unread when the pass samples no textures)."""
    rng = np.random.default_rng(9)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0)
    )
    n_v = 40
    pos = rng.uniform(-2, 2, (n_v, 3)).astype(np.float32)
    nrm = rng.normal(size=(n_v, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rng.uniform(0, 1, (n_v, 2)).astype(np.float32)
    tris = rng.integers(0, n_v, (30, 3))
    tris = tris[
        (tris[:, 0] != tris[:, 1])
        & (tris[:, 1] != tris[:, 2])
        & (tris[:, 0] != tris[:, 2])
    ].astype(np.int32)
    mat = rng.integers(0, 5, len(tris)).astype(np.int32)
    scale = rng.uniform(0.5, 2.0, len(tris)).astype(np.float32)

    ph = np.concatenate([pos, np.ones((n_v, 1), np.float32)], -1)
    clip = jnp.asarray((ph @ pv.T).astype(np.float32))
    setup = setup_triangles(
        clip, jnp.asarray(tris), jnp.ones(len(tris), bool), W, H, TILE_W, TILE_H
    )
    bins = bin_triangles(setup, W // TILE_W, H // TILE_H, 16, 64, 16,
                         materialize=True)
    records = pack_gbuf_payload(
        setup, jnp.asarray(tris), jnp.asarray(mat), jnp.asarray(scale),
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(uv),
    )
    g_full = rasterize_gbuffer_pallas(records, bins, W, H, interpret=True)
    g_nu = rasterize_gbuffer_pallas(records, bins, W, H, interpret=True,
                                    pos_derivs=False, uv_channels=False)
    for field in ["tri_id", "depth", "position", "normal",
                  "material_id", "model_scale"]:
        np.testing.assert_array_equal(
            np.asarray(getattr(g_nu, field)),
            np.asarray(getattr(g_full, field)), err_msg=field,
        )
    for field in ["uv", "duv_dx", "duv_dy", "dpos_dx", "dpos_dy"]:
        assert not np.asarray(getattr(g_nu, field)).any(), field

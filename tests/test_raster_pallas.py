"""Triton raster kernel (visibility variant) vs the pure-JAX reference
rasteriser (interpret mode on CPU — SURVEY.md §4b kernel-vs-lax
strategy)."""

import numpy as np
import jax.numpy as jnp
import pytest

from transmission_renderer_tpu.ops.raster import (
    bin_triangles,
    rasterize,
    setup_triangles,
)
from transmission_renderer_tpu.ops.raster_pallas_gbuf import (
    TILE_H,
    TILE_W,
    rasterize_visibility_pallas,
)
from transmission_renderer_tpu.scene.camera import look_at_rh, perspective_matrix_reversed

W, H = 256, 64  # 2 x 8 tiles of 128 x 8


def project(positions, pv):
    ph = np.concatenate([positions, np.ones((len(positions), 1), np.float32)], -1)
    return (ph @ pv.T).astype(np.float32)


def _both(clip, tris, init_depth=None):
    setup = setup_triangles(
        jnp.asarray(clip), jnp.asarray(tris, jnp.int32),
        jnp.ones(len(tris), bool), W, H, TILE_W, TILE_H,
    )
    bins = bin_triangles(setup, W // TILE_W, H // TILE_H, 16, 64, 16)
    ref = rasterize(
        setup, bins, W, H, TILE_W, TILE_H, init_depth=init_depth
    )
    got = rasterize_visibility_pallas(
        setup, bins, W, H, init_depth=init_depth, interpret=True
    )
    return ref, got


def _random_scene(seed=0, n_tris=25):
    rng = np.random.default_rng(seed)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0)
    )
    pts = rng.uniform(-2, 2, (30, 3)).astype(np.float32)
    tris = rng.integers(0, 30, (n_tris, 3))
    tris = tris[
        (tris[:, 0] != tris[:, 1])
        & (tris[:, 1] != tris[:, 2])
        & (tris[:, 0] != tris[:, 2])
    ]
    return project(pts, pv), tris


def test_pallas_matches_jax_raster():
    clip, tris = _random_scene()
    ref, got = _both(clip, tris)
    np.testing.assert_array_equal(np.asarray(got.tri_id), np.asarray(ref.tri_id))
    np.testing.assert_allclose(np.asarray(got.depth), np.asarray(ref.depth), atol=1e-7)
    np.testing.assert_allclose(np.asarray(got.bary), np.asarray(ref.bary), atol=1e-6)


def test_pallas_matches_with_init_depth():
    clip, tris = _random_scene(seed=3)
    # seed half the screen with a near depth: those pixels must stay empty
    init = np.zeros((H, W), np.float32)
    init[:, : W // 2] = 0.9
    ref, got = _both(clip, tris, init_depth=jnp.asarray(init))
    np.testing.assert_array_equal(np.asarray(got.tri_id), np.asarray(ref.tri_id))
    np.testing.assert_allclose(np.asarray(got.depth), np.asarray(ref.depth), atol=1e-7)


def test_pallas_big_triangle_list():
    """A fullscreen-bbox triangle (vertex behind camera) exercises the
    big-triangle path."""
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 0.0), (0.0, 0.5, -3.0), (0, 1, 0)
    )
    s = 50.0
    pts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    clip = project(pts, pv)
    tris = [[0, 2, 1], [0, 3, 2]]
    ref, got = _both(clip, tris)
    assert (np.asarray(ref.tri_id) >= 0).sum() > 1000  # plane covers lower half
    np.testing.assert_array_equal(np.asarray(got.tri_id), np.asarray(ref.tri_id))
    np.testing.assert_allclose(np.asarray(got.depth), np.asarray(ref.depth), atol=1e-7)


def test_tiered_binning_matches_single_tier():
    """Tiered demotion (small K + mid tier + giant tier) must produce the
    same per-tile record runs, in the same (draw) order, as a single-tier
    binning whose K covers every triangle."""
    rng = np.random.default_rng(11)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0)
    )
    # small random triangles + mid-size quads + a giant ground plane
    pts = rng.uniform(-2, 2, (30, 3)).astype(np.float32)
    tris = rng.integers(0, 30, (20, 3))
    tris = tris[
        (tris[:, 0] != tris[:, 1])
        & (tris[:, 1] != tris[:, 2])
        & (tris[:, 0] != tris[:, 2])
    ]
    quad = np.array(
        [[-1.5, 0.2, -1], [1.5, 0.2, -1], [1.5, 1.8, -1], [-1.5, 1.8, -1]],
        np.float32,
    )
    s = 50.0
    plane = np.array(
        [[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32
    )
    all_pts = np.concatenate([pts, quad, plane])
    nq, npl = 30, 34
    all_tris = np.concatenate([
        tris,
        [[nq, nq + 2, nq + 1], [nq, nq + 3, nq + 2]],
        [[npl, npl + 2, npl + 1], [npl, npl + 3, npl + 2]],
    ]).astype(np.int32)
    clip = jnp.asarray(project(all_pts, pv))
    setup = setup_triangles(
        clip, jnp.asarray(all_tris), jnp.ones(len(all_tris), bool),
        W, H, TILE_W, TILE_H,
    )
    tx, ty = W // TILE_W, H // TILE_H
    n_tiles = tx * ty
    flat = bin_triangles(setup, tx, ty, n_tiles, 256, 8, materialize=False)
    tier = bin_triangles(
        setup, tx, ty, 2, 256, 8, materialize=False,
        mid_tile_cap=6, max_mid_tris=16,
    )
    assert int(tier.mid_tri_count) > 0  # the quad actually demoted to mid
    assert int(tier.big_tri_count) > 0  # the plane hit the giant tier

    def runs(bins):
        s_ = np.asarray(bins.tile_start)
        ids = np.asarray(bins.sorted_tri_ids)
        return [ids[s_[t]:s_[t + 1]].tolist() for t in range(n_tiles)]

    assert runs(tier) == runs(flat)


def test_tiered_binning_matches_with_classes():
    """Same equivalence with class-split bins (the frame path's layout)."""
    rng = np.random.default_rng(13)
    pv = perspective_matrix_reversed(W, H) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0)
    )
    pts = rng.uniform(-3, 3, (40, 3)).astype(np.float32)
    tris = rng.integers(0, 40, (30, 3))
    tris = tris[
        (tris[:, 0] != tris[:, 1])
        & (tris[:, 1] != tris[:, 2])
        & (tris[:, 0] != tris[:, 2])
    ].astype(np.int32)
    cls = jnp.asarray(rng.integers(0, 2, len(tris)).astype(np.int32))
    clip = jnp.asarray(project(pts, pv))
    setup = setup_triangles(
        clip, jnp.asarray(tris), jnp.ones(len(tris), bool),
        W, H, TILE_W, TILE_H,
    )
    tx, ty = W // TILE_W, H // TILE_H
    n_bins = 2 * tx * ty
    flat = bin_triangles(setup, tx, ty, tx * ty, 256, 16, materialize=False,
                         class_flags=cls, num_classes=2)
    tier = bin_triangles(setup, tx, ty, 2, 256, 16, materialize=False,
                         class_flags=cls, num_classes=2,
                         mid_tile_cap=6, max_mid_tris=32)

    def runs(bins):
        s_ = np.asarray(bins.tile_start)
        ids = np.asarray(bins.sorted_tri_ids)
        return [ids[s_[b]:s_[b + 1]].tolist() for b in range(n_bins)]

    assert runs(tier) == runs(flat)

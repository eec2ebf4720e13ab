"""The Triton raster kernel (interpret mode) against the XLA raster.

Every case runs ops/raster_pallas_gbuf.py::rasterize_gbuffer_tiles in
interpret mode and compares its G-buffer with ops/raster.py::rasterize +
render/gbuffer.py::interpolate_gbuffer on the same triangle setup. The
compiled kernel is the same program; the ``gpu`` case at the end and
chip_smoke.py compare it on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from transmission_renderer_tpu.ops.raster import (
    bin_triangles,
    rasterize,
    setup_triangles,
    tile_image,
    untile_image,
)
from transmission_renderer_tpu.ops.raster_pallas_gbuf import (
    CLASS_BIT,
    TILE_H,
    TILE_W,
    gather_gbuf_payload,
    gbuffer_from_channels,
    pack_gbuf_payload,
    rasterize_gbuffer_pallas,
    rasterize_gbuffer_tiles,
)
from transmission_renderer_tpu.render.gbuffer import interpolate_gbuffer
from transmission_renderer_tpu.scene.camera import (
    look_at_rh,
    perspective_matrix_reversed,
)

W, H = 256, 64
FIELDS = ("position", "normal", "uv", "duv_dx", "duv_dy", "dpos_dx",
          "dpos_dy", "model_scale")


def _scene(seed=5, n_v=40, n_t=40, w=W, h=H, plane=False):
    """Random triangles (+ an optional ground plane that covers many
    tiles) -> dict of numpy inputs."""
    rng = np.random.default_rng(seed)
    pv = perspective_matrix_reversed(w, h) @ look_at_rh(
        (0.0, 1.0, 5.0), (0.0, 1.0, 0.0), (0, 1, 0)
    )
    pos = rng.uniform(-2, 2, (n_v, 3)).astype(np.float32)
    tris = rng.integers(0, n_v, (n_t, 3))
    tris = tris[
        (tris[:, 0] != tris[:, 1])
        & (tris[:, 1] != tris[:, 2])
        & (tris[:, 0] != tris[:, 2])
    ]
    if plane:
        s = 50.0
        quad = np.array(
            [[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32
        )
        tris = np.concatenate(
            [tris, n_v + np.array([[0, 2, 1], [0, 3, 2]])]
        )
        pos = np.concatenate([pos, quad])
    n_v = len(pos)
    nrm = rng.normal(size=(n_v, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ph = np.concatenate([pos, np.ones((n_v, 1), np.float32)], -1)
    return dict(
        clip=(ph @ pv.T).astype(np.float32),
        pos=pos, nrm=nrm,
        uv=rng.uniform(0, 1, (n_v, 2)).astype(np.float32),
        tris=tris.astype(np.int32),
        mat=rng.integers(0, 5, len(tris)).astype(np.int32),
        scale=rng.uniform(0.5, 2.0, len(tris)).astype(np.float32),
        cls=rng.integers(0, 4, len(tris)).astype(np.int32),
        w=w, h=h,
    )


def _setup(s, enabled=None):
    n = len(s["tris"])
    return setup_triangles(
        jnp.asarray(s["clip"]), jnp.asarray(s["tris"]),
        jnp.ones(n, bool) if enabled is None else jnp.asarray(enabled),
        s["w"], s["h"], TILE_W, TILE_H,
    )


def _records(s, setup, cls=None):
    return pack_gbuf_payload(
        setup, jnp.asarray(s["tris"]), jnp.asarray(s["mat"]),
        jnp.asarray(s["scale"]), jnp.asarray(s["pos"]),
        jnp.asarray(s["nrm"]), jnp.asarray(s["uv"]),
        None if cls is None else jnp.asarray(cls),
    )


def _xla_gbuffer(s, enabled=None, init_depth=None, alpha_fn=None):
    """The oracle: XLA raster + gather interpolation."""
    setup = _setup(s, enabled)
    tx, ty = -(-s["w"] // TILE_W), -(-s["h"] // TILE_H)
    bins = bin_triangles(setup, tx, ty, 16, 256, 16)
    vis = rasterize(
        setup, bins, s["w"], s["h"], TILE_W, TILE_H,
        init_depth=init_depth, alpha_coverage_fn=alpha_fn,
    )
    return interpolate_gbuffer(
        vis, setup, jnp.asarray(s["tris"]), jnp.asarray(s["mat"]),
        jnp.asarray(s["scale"]), jnp.asarray(s["pos"]),
        jnp.asarray(s["nrm"]), jnp.asarray(s["uv"]), s["w"], s["h"],
    )


def _assert_same(got, ref, fields=FIELDS):
    np.testing.assert_array_equal(
        np.asarray(got.tri_id), np.asarray(ref.tri_id)
    )
    np.testing.assert_allclose(
        np.asarray(got.depth), np.asarray(ref.depth), atol=1e-7
    )
    for f in fields:
        np.testing.assert_allclose(
            np.asarray(getattr(got, f)), np.asarray(getattr(ref, f)),
            atol=1e-4, rtol=1e-3, err_msg=f,
        )
    np.testing.assert_array_equal(
        np.asarray(got.material_id), np.asarray(ref.material_id)
    )


def _class_bins(s, setup):
    tx, ty = -(-s["w"] // TILE_W), -(-s["h"] // TILE_H)
    return bin_triangles(
        setup, tx, ty, 2, 256, 16, materialize=False,
        class_flags=jnp.asarray(s["cls"]), num_classes=4,
        tiers=((8, 64), (0, 16)),
    )


@pytest.mark.parametrize("pass_class", [0, 1, 2, 3])
def test_pass_class_matches_xla(pass_class):
    """Class-split bins: a pass streams only its class's record runs and
    must equal the XLA raster of that class's triangles alone."""
    s = _scene(seed=21, n_t=60, plane=True)
    setup = _setup(s)
    bins = _class_bins(s, setup)
    got = rasterize_gbuffer_pallas(
        _records(s, setup, s["cls"]), bins, W, H, pass_class=pass_class,
        interpret=True,
    )
    ref = _xla_gbuffer(s, enabled=s["cls"] == pass_class)
    assert (np.asarray(ref.tri_id) >= 0).any()
    _assert_same(got, ref)


def test_all_classes_match_xla():
    """pass_class None walks every class of a tile."""
    s = _scene(seed=22, n_t=60)
    setup = _setup(s)
    got = rasterize_gbuffer_pallas(
        _records(s, setup, s["cls"]), _class_bins(s, setup), W, H,
        interpret=True,
    )
    _assert_same(got, _xla_gbuffer(s))


def test_init_depth_matches_xla():
    s = _scene(seed=23)
    setup = _setup(s)
    tx, ty = W // TILE_W, H // TILE_H
    bins = bin_triangles(setup, tx, ty, 16, 256, 16)
    init = np.zeros((H, W), np.float32)
    init[:, : W // 2] = 0.9
    init[: H // 2, W // 2:] = 0.3
    got = rasterize_gbuffer_pallas(
        _records(s, setup), bins, W, H, init_depth=jnp.asarray(init),
        interpret=True,
    )
    _assert_same(got, _xla_gbuffer(s, init_depth=jnp.asarray(init)))


def test_max_depth_peel_bound_matches_xla():
    """The peel bound keeps only fragments strictly behind max_depth —
    the XLA raster with a coverage test that rejects depth >= bound."""
    s = _scene(seed=24, n_t=60)
    setup = _setup(s)
    tx, ty = W // TILE_W, H // TILE_H
    bins = bin_triangles(setup, tx, ty, 16, 256, 16)
    records = _records(s, setup)
    first = rasterize_gbuffer_pallas(records, bins, W, H, interpret=True)
    bound = jnp.where(first.tri_id >= 0, first.depth, jnp.inf)
    ids = jnp.arange(tx * ty, dtype=jnp.int32)
    n_big = bins.big_tri_ids.shape[0]
    ch = rasterize_gbuffer_tiles(
        gather_gbuf_payload(records, bins), ids, bins.tile_start,
        jnp.minimum(bins.big_tri_count, n_big).astype(jnp.int32), W, H,
        max_depth_tiles=tile_image(bound, TILE_W, TILE_H), interpret=True,
    )
    got = gbuffer_from_channels({
        k: untile_image(v, tx, ty, TILE_W, TILE_H, W, H)
        for k, v in ch.items()
    })

    def below_bound(tri, b1, b2, nx, ny, adj):
        del b1, b2
        e = [adj[i, 0] * nx + adj[i, 1] * ny + adj[i, 2] for i in range(3)]
        w_ = setup.w_clip[tri]
        z_ = setup.z_clip[tri]
        depth = (e[0] * z_[0] + e[1] * z_[1] + e[2] * z_[2]) / (
            e[0] * w_[0] + e[1] * w_[1] + e[2] * w_[2]
        )
        px = jnp.round((nx + 1.0) * (W / 2) - 0.5).astype(jnp.int32)
        py = jnp.round((ny + 1.0) * (H / 2) - 0.5).astype(jnp.int32)
        return depth < bound[py, px]

    ref = _xla_gbuffer(s, alpha_fn=below_bound)
    assert (np.asarray(ref.tri_id) >= 0).any()
    assert (np.asarray(ref.tri_id) != np.asarray(first.tri_id)).any()
    _assert_same(got, ref)


@pytest.mark.parametrize(
    "pos_derivs,uv_channels", [(True, False), (False, True), (False, False)]
)
def test_channel_subsets_match_xla(pos_derivs, uv_channels):
    """Dropped channel groups come back as zeros; the rest match XLA."""
    s = _scene(seed=25)
    setup = _setup(s)
    bins = bin_triangles(setup, W // TILE_W, H // TILE_H, 16, 256, 16)
    got = rasterize_gbuffer_pallas(
        _records(s, setup), bins, W, H, interpret=True,
        pos_derivs=pos_derivs, uv_channels=uv_channels,
    )
    ref = _xla_gbuffer(s)
    kept = ["position", "normal", "model_scale"]
    dropped = []
    (kept if pos_derivs else dropped).extend(["dpos_dx", "dpos_dy"])
    (kept if uv_channels else dropped).extend(["uv", "duv_dx", "duv_dy"])
    _assert_same(got, ref, kept)
    for f in dropped:
        assert not np.asarray(getattr(got, f)).any(), f


@pytest.mark.parametrize(
    "ids", [[13, 2, 2, 7, 0], [7]], ids=["repeats_out_of_order", "one_tile"]
)
def test_sparse_tile_worklist(ids):
    """An arbitrary tile list (repeats, out of order, or a single tile)
    gives exactly the full-frame kernel's tiles."""
    s = _scene(seed=26, n_t=60, plane=True)
    setup = _setup(s)
    bins = _class_bins(s, setup)
    records = _records(s, setup, s["cls"])
    payload = gather_gbuf_payload(records, bins)
    tx, ty = W // TILE_W, H // TILE_H
    full = rasterize_gbuffer_tiles(
        payload, jnp.arange(tx * ty, dtype=jnp.int32), bins.tile_start,
        jnp.zeros((), jnp.int32), W, H, pass_class=0, interpret=True,
    )
    ids = np.array(ids, np.int32)
    sub = rasterize_gbuffer_tiles(
        payload, jnp.asarray(ids), bins.tile_start, jnp.zeros((), jnp.int32),
        W, H, pass_class=0, interpret=True,
    )
    for name, a in sub.items():
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(full[name])[ids], err_msg=name
        )


def test_big_triangle_list_matches_xla():
    """Materialised bins with a non-empty big-triangle list (a ground
    plane wider than max_tiles_per_tri) walk that list in every tile."""
    s = _scene(seed=27, plane=True)
    setup = _setup(s)
    bins = bin_triangles(setup, W // TILE_W, H // TILE_H, 4, 256, 16)
    assert int(bins.big_tri_count) > 0
    got = rasterize_gbuffer_pallas(
        _records(s, setup), bins, W, H, interpret=True
    )
    _assert_same(got, _xla_gbuffer(s))


def test_empty_tiles_cleared():
    """Tiles with no records keep the cleared G-buffer: no triangle, the
    init depth, +z normal, scale 1, every other channel 0."""
    s = _scene(seed=28, n_t=3)
    setup = _setup(s)
    bins = bin_triangles(setup, W // TILE_W, H // TILE_H, 16, 256, 16,
                         materialize=False)
    tx, ty = W // TILE_W, H // TILE_H
    counts = np.diff(np.asarray(bins.tile_start))
    empty = np.flatnonzero(counts == 0)
    assert len(empty) > 0
    init = jnp.full((len(empty), TILE_H, TILE_W), 0.25, jnp.float32)
    ch = rasterize_gbuffer_tiles(
        gather_gbuf_payload(_records(s, setup), bins),
        jnp.asarray(empty, jnp.int32), bins.tile_start,
        jnp.zeros((), jnp.int32), W, H, init_depth_tiles=init,
        interpret=True,
    )
    cleared = {"tri": -1, "depth": 0.25, "nrm_z": 1.0, "scale": 1.0}
    for name, a in ch.items():
        np.testing.assert_array_equal(
            np.asarray(a), cleared.get(name, 0), err_msg=name
        )


def test_frame_not_multiple_of_tile():
    """A frame that is not a whole number of tiles: padded tiles are
    cropped and the visible pixels match XLA."""
    w, h = 200, 60
    s = _scene(seed=29, w=w, h=h)
    setup = _setup(s)
    bins = bin_triangles(setup, -(-w // TILE_W), -(-h // TILE_H), 16, 256, 16)
    got = rasterize_gbuffer_pallas(
        _records(s, setup), bins, w, h, interpret=True
    )
    assert got.depth.shape == (h, w)
    _assert_same(got, _xla_gbuffer(s))


def test_record_ids_encode_class():
    """Record slot 15 carries tri id + CLASS_BIT * class, exact in f32."""
    s = _scene(seed=30)
    setup = _setup(s)
    rec = np.asarray(_records(s, setup, s["cls"]))
    ids = np.arange(len(s["tris"])) + CLASS_BIT * s["cls"]
    np.testing.assert_array_equal(rec[:, 15].astype(np.int64), ids)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(require_gpu):
    """The compiled kernel on the card: same ids and attributes as XLA
    (chip_smoke.py repeats this at 1920x1080)."""
    s = _scene(seed=31, n_t=60, plane=True)
    setup = _setup(s)
    bins = _class_bins(s, setup)
    with jax.default_matmul_precision("highest"):
        got = rasterize_gbuffer_pallas(
            _records(s, setup, s["cls"]), bins, W, H, pass_class=0
        )
        ref = _xla_gbuffer(s, enabled=s["cls"] == 0)
    tk, tx = np.asarray(got.tri_id), np.asarray(ref.tri_id)
    covered = (tk >= 0) | (tx >= 0)
    assert ((tk == tx) & covered).sum() >= 0.999 * covered.sum()

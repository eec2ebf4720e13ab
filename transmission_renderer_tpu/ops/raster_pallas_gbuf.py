"""Tile raster kernel (Pallas through Triton) that emits a G-buffer.

One program per 8x128 pixel tile, in a grid over a worklist of tile ids.
Each program reads its own record run from the class-split bins
(``tile_start`` / ``sorted_tri_ids``, ops/raster.py::bin_triangles) and
races depth per pixel, keeping only the best depth and the winning
triangle id in registers. After the walk each pixel gathers its winner's
record ONCE and computes every output channel from it — the 22 G-buffer
channels (``GBUF_CHANNELS``) or, with ``visibility=True``, the
visibility buffer (tri id, depth, perspective barycentrics) that
ops/raster.py::rasterize produces.

Record layout: one [64] f32 row per triangle, indexed by triangle id
(the degenerate record, which never covers a pixel, sits at index T):
  [0:9]   adjugate rows (a0 b0 c0 a1 b1 c1 a2 b2 c2)
  [9:12]  z_clip,  [12:15] w_clip
  [15]    tri id + CLASS_BIT * draw_class, as float value. Classes map
          the reference's 4 draw buckets (model_loading.rs:68-78):
          0 = opaque, 1 = transmission, 2 = alpha-clip,
          3 = transmission-alpha-clip (tri ids < CLASS_BIT = 2^22 keep
          the encoding exact in f32)
  [16:24] v0: pos.xyz, nrm.xyz, uv.xy
  [24:32] v1, [32:40] v2
  [40]    material id (float value), [41] instance scale
  [42:64] padding (a record's race fields fill one 64-byte sector)

The race is the XLA raster's (ops/raster.py::_raster_tile): top-left
fill rule, reversed-Z GREATER test, exact depth ties broken by the lower
triangle id — a total order, so the result does not depend on the walk
order of the record run or the big-triangle list.

Alpha-clip classes rasterise through the same kernel via depth PEELING
(render/frame.py::_rasterize_clip_peeled): race ignoring alpha, test the
winners' diffuse alpha densely in XLA (implicit-LOD, matching the clip
pre-pass shader/src/lib.rs:270-295), then re-race only the failing tiles
with ``max_depth`` bounding out the rejected fragment — exact once the
number of rejected layers above the true winner is below the round count.

Derivatives are the same closed forms as render/gbuffer.py: for an
attribute with vertex values A_i, N = sum(e_i A_i), D = sum(e_i),
dA/dnx = (sum(a_i A_i) D - N sum(a_i)) / D^2.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from transmission_renderer_tpu.ops.raster import TileBins, TriangleSetup

TILE_H = 8
TILE_W = 128
REC_F32 = 64
# warps per tile program: 1024 pixels over 4 warps is 8 pixels a thread
NUM_WARPS = 4

# Draw-class flag folded into the id slot, so the passes of one frame
# share ONE binning sort and filter per record (ids < 2^24 stay exact in
# f32 either way).
CLASS_SHIFT = 22
CLASS_BIT = 1 << CLASS_SHIFT  # tri ids must stay below 2^22 (f32-exact
# encoding of tri + CLASS_BIT * class for classes 0..3)

# output channel order (each [n_tiles, TILE_H, TILE_W] f32 unless noted)
GBUF_CHANNELS = (
    "tri",  # int32
    "depth",
    "pos_x", "pos_y", "pos_z",
    "nrm_x", "nrm_y", "nrm_z",
    "uv_u", "uv_v",
    "duvdx_u", "duvdx_v", "duvdy_u", "duvdy_v",
    "dposdx_x", "dposdx_y", "dposdx_z",
    "dposdy_x", "dposdy_y", "dposdy_z",
    "material",  # int32
    "scale",
)
# the visibility-buffer variant's channels (``visibility=True``)
VIS_CHANNELS = ("tri", "depth", "b1", "b2")

# position-derivative channels only feed normal mapping's cotangent frame
# (render/shading.py; shader/src/lighting.rs:243-259) — a pass whose
# materials use no normal_map texture skips computing and storing them
# (``pos_derivs=False``)
DPOS_CHANNELS = (
    "dposdx_x", "dposdx_y", "dposdx_z",
    "dposdy_x", "dposdy_y", "dposdy_z",
)
# uv + uv-derivative channels only feed texture taps (and the alpha-clip
# coverage test) — a pass whose materials sample NO texture slot at all
# (e.g. an untextured-glass transmission pass) skips them too
UV_CHANNELS = (
    "uv_u", "uv_v",
    "duvdx_u", "duvdx_v", "duvdy_u", "duvdy_v",
)
_INT_CHANNELS = ("tri", "material")


def active_channels(pos_derivs: bool, uv_channels: bool = True) -> tuple:
    drop = () if pos_derivs else DPOS_CHANNELS
    if not uv_channels:
        drop = drop + UV_CHANNELS
    return tuple(c for c in GBUF_CHANNELS if c not in drop)


def pack_gbuf_payload(
    setup: TriangleSetup,
    tri_vertices: jnp.ndarray,  # [T, 3]
    tri_material: jnp.ndarray,  # [T]
    tri_scale: jnp.ndarray,  # [T]
    world_positions: jnp.ndarray,  # [VV, 3]
    world_normals: jnp.ndarray,  # [VV, 3]
    uvs: jnp.ndarray,  # [VV, 2]
    class_flags: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """[T, 64] records (per-frame; the vertex gathers here are T-sized,
    not pixel-sized)."""
    t = setup.adj.shape[0]
    # the id + CLASS_BIT*class encoding (and its exact-f32 storage)
    # requires ids below the class field
    assert t <= CLASS_BIT, f"{t} records exceed the 2^22 tri-id field"
    ids = jnp.arange(t, dtype=jnp.int32)
    if class_flags is not None:
        ids = ids + CLASS_BIT * class_flags.astype(jnp.int32)
    attr8 = jnp.concatenate([world_positions, world_normals, uvs], axis=1)
    v = attr8[tri_vertices]  # [T, 3, 8]
    return jnp.concatenate(
        [
            setup.adj.reshape(t, 9),
            setup.z_clip,
            setup.w_clip,
            ids.astype(jnp.float32)[:, None],
            v.reshape(t, 24),
            tri_material.astype(jnp.float32)[:, None],
            tri_scale[:, None],
            jnp.zeros((t, REC_F32 - 42), jnp.float32),
        ],
        axis=1,
    )


def pack_vis_payload(
    setup: TriangleSetup, class_flags: jnp.ndarray | None = None
) -> jnp.ndarray:
    """[T, 64] records carrying only the race fields (the visibility
    variant reads nothing past [15])."""
    t = setup.adj.shape[0]
    assert t <= CLASS_BIT, f"{t} records exceed the 2^22 tri-id field"
    ids = jnp.arange(t, dtype=jnp.int32)
    if class_flags is not None:
        ids = ids + CLASS_BIT * class_flags.astype(jnp.int32)
    return jnp.concatenate(
        [
            setup.adj.reshape(t, 9),
            setup.z_clip,
            setup.w_clip,
            ids.astype(jnp.float32)[:, None],
            jnp.zeros((t, REC_F32 - 16), jnp.float32),
        ],
        axis=1,
    )


def gather_gbuf_payload(records: jnp.ndarray, bins: TileBins):
    """The kernel's record inputs: (records + the degenerate record at
    index T, the sorted record stream, the big-triangle list). Record
    scalars are read by triangle id straight from the table, so no
    per-pair payload copy is made."""
    degenerate = jnp.zeros((1, REC_F32), jnp.float32).at[0, 15].set(-1.0)
    return (
        jnp.concatenate([records, degenerate], axis=0),
        bins.sorted_tri_ids.astype(jnp.int32),
        bins.big_tri_ids.astype(jnp.int32),
    )


def _kernel(
    tile_start_ref,  # i32[num_classes * n_tiles_global + 1] (global)
    tile_ids_ref,  # i32[K] global tile ids for this call
    big_count_ref,  # i32[1]
    rec_ref,  # f32[T + 1, 64] record table (degenerate record at T)
    sorted_ref,  # i32[S] tri ids sorted by (bin, tri); -1 = empty slot
    big_ref,  # i32[B] big-triangle ids; -1 = empty slot
    *refs,
    tiles_x: int,
    width: int,
    height: int,
    pass_class: int | None,
    num_classes: int,
    has_init: bool,
    use_max_depth: bool,
    names: tuple,
    visibility: bool,
):
    refs = list(refs)
    init_ref = refs.pop(0) if has_init else None
    maxd_ref = refs.pop(0) if use_max_depth else None
    ch = dict(zip(names, refs))
    degenerate = rec_ref.shape[0] - 1

    t = pl.program_id(0)
    tile_id = tile_ids_ref[t]
    ty = tile_id // tiles_x
    tx = tile_id % tiles_x

    shape = (TILE_H, TILE_W)
    rows_f = jax.lax.broadcasted_iota(jnp.int32, shape, 0).astype(jnp.float32)
    cols_f = jax.lax.broadcasted_iota(jnp.int32, shape, 1).astype(jnp.float32)
    pxc = tx.astype(jnp.float32) * TILE_W + cols_f + 0.5
    pyc = ty.astype(jnp.float32) * TILE_H + rows_f + 0.5
    nx = pxc * (2.0 / width) - 1.0
    ny = pyc * (2.0 / height) - 1.0

    init_depth = (
        init_ref[...] if has_init else jnp.zeros(shape, jnp.float32)
    )
    max_depth = maxd_ref[...] if use_max_depth else None

    # class-split bins: tile T's records live at bins [nc*T, nc*T+nc);
    # a single-class pass streams only its run. Indexed by the GLOBAL
    # tile id so arbitrary tile lists (bands, failing-tile re-races)
    # share one tile_start. (Big records are class-mixed and rely on the
    # per-record class filter below.)
    if num_classes == 1:
        lo = tile_start_ref[tile_id]
        hi = tile_start_ref[tile_id + 1]
    elif pass_class is None:
        lo = tile_start_ref[num_classes * tile_id]
        hi = tile_start_ref[num_classes * tile_id + num_classes]
    else:
        lo = tile_start_ref[num_classes * tile_id + pass_class]
        hi = tile_start_ref[num_classes * tile_id + pass_class + 1]

    def edges(r):
        """The three edge functions of record ``r`` (scalar or per-pixel)
        and its adjugate coefficients."""
        a = [rec_ref[r, 3 * i] for i in range(3)]
        b = [rec_ref[r, 3 * i + 1] for i in range(3)]
        c = [rec_ref[r, 3 * i + 2] for i in range(3)]
        e = [a[i] * nx + b[i] * ny + c[i] for i in range(3)]
        return e, a, b

    def race(tid, carry):
        best_d, best_t = carry
        r = jnp.where(tid >= 0, tid, degenerate)
        e, a, b = edges(r)

        def covered(e_, a_, b_):
            tl = (a_ > 0) | ((a_ == 0) & (b_ > 0))
            return (e_ > 0) | ((e_ == 0) & tl)

        inside = covered(e[0], a[0], b[0])
        inside &= covered(e[1], a[1], b[1])
        inside &= covered(e[2], a[2], b[2])
        w = [rec_ref[r, 12 + i] for i in range(3)]
        z = [rec_ref[r, 9 + i] for i in range(3)]
        w_int = e[0] * w[0] + e[1] * w[1] + e[2] * w[2]
        z_int = e[0] * z[0] + e[1] * z[1] + e[2] * z[2]
        depth = z_int / w_int
        inside &= (w_int > 0) & (depth >= 0.0) & (depth <= 1.0)
        if pass_class is not None:
            tri_enc = rec_ref[r, 15].astype(jnp.int32)
            inside &= (tri_enc >> CLASS_SHIFT) == pass_class
        win = inside & (
            (depth > best_d) | ((depth == best_d) & (r < best_t))
        )
        if use_max_depth:
            # depth-peeling bound: fragments at/above the rejected layer
            # stay excluded (render/frame.py::_rasterize_clip_peeled)
            win &= depth < max_depth
        return jnp.where(win, depth, best_d), jnp.where(win, r, best_t)

    carry = (init_depth, jnp.full(shape, -1, jnp.int32))
    carry = jax.lax.fori_loop(
        0, big_count_ref[0], lambda j, c: race(big_ref[j], c), carry
    )
    best_d, best_t = jax.lax.fori_loop(
        lo, hi, lambda j, c: race(sorted_ref[j], c), carry
    )

    # ---- one record gather per pixel: the winner's channels ------------
    valid = best_t >= 0
    r = jnp.maximum(best_t, 0)
    e, a, b = edges(r)
    d_sum = e[0] + e[1] + e[2]
    out = {"tri": best_t, "depth": best_d}
    if visibility:
        out["b1"] = jnp.where(valid, e[1] / d_sum, 0.0)
        out["b2"] = jnp.where(valid, e[2] / d_sum, 0.0)
    else:
        inv_d = 1.0 / d_sum
        a_sum = a[0] + a[1] + a[2]
        b_sum = b[0] + b[1] + b[2]
        inv_d2x = inv_d * inv_d * (2.0 / width)
        inv_d2y = inv_d * inv_d * (2.0 / height)
        attr = ("pos_x", "pos_y", "pos_z", "nrm_x", "nrm_y", "nrm_z",
                "uv_u", "uv_v")
        dx = ("dposdx_x", "dposdx_y", "dposdx_z", None, None, None,
              "duvdx_u", "duvdx_v")
        dy = ("dposdy_x", "dposdy_y", "dposdy_z", None, None, None,
              "duvdy_u", "duvdy_v")
        for k in range(8):
            if attr[k] not in ch:
                continue
            av = [rec_ref[r, 16 + 8 * i + k] for i in range(3)]
            n_attr = e[0] * av[0] + e[1] * av[1] + e[2] * av[2]
            out[attr[k]] = n_attr * inv_d
            if dx[k] is not None and dx[k] in ch:
                na = a[0] * av[0] + a[1] * av[1] + a[2] * av[2]
                nb = b[0] * av[0] + b[1] * av[1] + b[2] * av[2]
                out[dx[k]] = (na * d_sum - n_attr * a_sum) * inv_d2x
                out[dy[k]] = (nb * d_sum - n_attr * b_sum) * inv_d2y
        out["material"] = rec_ref[r, 40].astype(jnp.int32)
        out["scale"] = rec_ref[r, 41]
        # cleared-pixel values (the G-buffer convention: background
        # normal = +z, scale 1, every other channel 0)
        cleared = {"nrm_z": 1.0, "scale": 1.0}
        for name in names:
            if name not in ("tri", "depth"):
                out[name] = jnp.where(
                    valid, out[name], cleared.get(name, 0)
                ).astype(out[name].dtype)
    for name in names:
        ch[name][...] = out[name]


def rasterize_gbuffer_tiles(
    payload: tuple,  # from gather_gbuf_payload
    tile_ids: jnp.ndarray,  # [K] global tile ids handled by this call
    tile_start: jnp.ndarray,  # [num_classes * n_tiles_global + 1] (GLOBAL)
    big_count: jnp.ndarray,  # [] int32 (already clamped)
    width: int,
    height: int,
    init_depth_tiles: jnp.ndarray | None = None,  # [K, TILE_H, TILE_W]
    max_depth_tiles: jnp.ndarray | None = None,  # [K, TILE_H, TILE_W] peel bound
    pass_class: int | None = None,
    interpret: bool = False,
    n_tiles_global: int | None = None,  # bins' tile-grid size when padded
    # beyond the frame (the sharded path bins over a band-aligned grid)
    pos_derivs: bool = True,
    uv_channels: bool = True,
    visibility: bool = False,
    name: str = "raster_tiles",
) -> dict:
    """Run the kernel over an arbitrary tile list (the building block
    shared by the single-chip frame, the row-band sharded path, and the
    alpha-clip peeling re-races). ``tile_start`` is the GLOBAL bins
    array; the per-tile class count is inferred from its length. Returns
    {channel: [K, TILE_H, TILE_W]} (no dpos channels when
    ``pos_derivs=False`` — see DPOS_CHANNELS; VIS_CHANNELS when
    ``visibility``). ``name`` names the compiled kernel; callers pass
    their pass_scope so profiler traces attribute the kernel to its
    pass (tools/pass_timing.py)."""
    k_tiles = tile_ids.shape[0]
    if interpret and k_tiles == 1:
        # interpreted, a one-program grid loses its loop: XLA fuses the
        # body with its neighbours and contracts other multiply-adds into
        # FMAs, so the tile would round differently than in a longer
        # list. Two programs keep every tile list bit-identical.
        tile_ids, init_depth_tiles, max_depth_tiles = (
            None if a is None else jnp.concatenate([a, a])
            for a in (tile_ids, init_depth_tiles, max_depth_tiles)
        )
    tiles_x = -(-width // TILE_W)
    tiles_y = -(-height // TILE_H)
    if n_tiles_global is None:
        n_tiles_global = tiles_x * tiles_y
    num_classes = (tile_start.shape[0] - 1) // n_tiles_global
    records, sorted_ids, big_ids = payload
    names = (
        VIS_CHANNELS if visibility
        else active_channels(pos_derivs, uv_channels)
    )

    def whole(a):
        return pl.BlockSpec(a.shape, lambda t: (0,) * a.ndim)

    tile_spec = pl.BlockSpec((None, TILE_H, TILE_W), lambda t: (t, 0, 0))
    big_count = jnp.reshape(big_count, (1,)).astype(jnp.int32)
    args = [
        tile_start.astype(jnp.int32), tile_ids.astype(jnp.int32), big_count,
        records, sorted_ids, big_ids,
    ]
    in_specs = [whole(a) for a in args]
    for extra in (init_depth_tiles, max_depth_tiles):
        if extra is not None:
            args.append(extra)
            in_specs.append(tile_spec)
    kernel = functools.partial(
        _kernel, tiles_x=tiles_x, width=width, height=height,
        pass_class=pass_class, num_classes=num_classes,
        has_init=init_depth_tiles is not None,
        use_max_depth=max_depth_tiles is not None, names=names,
        visibility=visibility,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(tile_ids.shape[0],),
        in_specs=in_specs,
        out_specs=[tile_spec] * len(names),
        out_shape=[
            jax.ShapeDtypeStruct(
                (tile_ids.shape[0], TILE_H, TILE_W),
                jnp.int32 if name in _INT_CHANNELS else jnp.float32,
            )
            for name in names
        ],
        interpret=interpret,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        name=name,
    )(*args)
    return {name: a[:k_tiles] for name, a in zip(names, outs)}


def _frame_tiles(bins: TileBins, width, height, init_depth, interpret,
                 pass_class, payload, **kw):
    """Full-frame kernel run -> {channel: [H, W]}."""
    from transmission_renderer_tpu.ops.raster import tile_image, untile_image

    tiles_x = -(-width // TILE_W)
    tiles_y = -(-height // TILE_H)
    init_tiles = (
        tile_image(init_depth, TILE_W, TILE_H) if init_depth is not None
        else None
    )
    n_big = bins.big_tri_ids.shape[0]
    # a length-1 all(-1) big list means big tris ride the sorted stream
    big_count = (
        jnp.zeros((), jnp.int32)
        if n_big <= 1
        else jnp.minimum(bins.big_tri_count, n_big).astype(jnp.int32)
    )
    raw = rasterize_gbuffer_tiles(
        payload, jnp.arange(tiles_x * tiles_y, dtype=jnp.int32),
        bins.tile_start, big_count, width, height,
        init_depth_tiles=init_tiles, pass_class=pass_class,
        interpret=interpret, **kw,
    )
    return {
        name: untile_image(a, tiles_x, tiles_y, TILE_W, TILE_H, width, height)
        for name, a in raw.items()
    }


def rasterize_gbuffer_pallas(
    records: jnp.ndarray,  # [T, 64] from pack_gbuf_payload
    bins: TileBins,
    width: int,
    height: int,
    init_depth: jnp.ndarray | None = None,
    pass_class: int | None = None,
    payload=None,  # optional precomputed gather_gbuf_payload result
    interpret: bool = False,
    pos_derivs: bool = True,
    uv_channels: bool = True,
    name: str = "raster_tiles",
):
    """Full-frame G-buffer raster. Returns a render.gbuffer.GBuffer."""
    payload = (
        payload if payload is not None else gather_gbuf_payload(records, bins)
    )
    ch = _frame_tiles(
        bins, width, height, init_depth, interpret, pass_class, payload,
        pos_derivs=pos_derivs, uv_channels=uv_channels, name=name,
    )
    return gbuffer_from_channels(ch)


def rasterize_visibility_pallas(
    setup: TriangleSetup,
    bins: TileBins,
    width: int,
    height: int,
    init_depth: jnp.ndarray | None = None,
    interpret: bool = False,
    pass_class: int | None = None,
):
    """Full-frame visibility buffer through the same kernel — the
    kernel's counterpart of ops/raster.py::rasterize."""
    from transmission_renderer_tpu.ops.raster import VisibilityBuffer

    payload = gather_gbuf_payload(pack_vis_payload(setup), bins)
    ch = _frame_tiles(
        bins, width, height, init_depth, interpret, pass_class, payload,
        visibility=True,
    )
    return VisibilityBuffer(
        tri_id=ch["tri"], depth=ch["depth"],
        bary=jnp.stack([ch["b1"], ch["b2"]], axis=-1),
    )


def gbuffer_from_channels(ch: dict):
    """Assemble a render.gbuffer.GBuffer from untiled channel images.
    Missing dpos/uv channels (``pos_derivs=False`` / ``uv_channels=False``
    passes) become zeros — exactly the kernel's cleared value, and unread
    by shading when no material uses the corresponding texture slots."""
    from transmission_renderer_tpu.render.gbuffer import GBuffer

    zero = jnp.zeros_like(ch["depth"])
    for grp in (DPOS_CHANNELS, UV_CHANNELS):
        if grp[0] not in ch:
            ch = {**ch, **{name: zero for name in grp}}
    valid = ch["tri"] >= 0
    vmask = valid[..., None]
    stack3 = lambda a, b, c: jnp.stack([ch[a], ch[b], ch[c]], axis=-1)
    stack2 = lambda a, b: jnp.stack([ch[a], ch[b]], axis=-1)
    return GBuffer(
        valid=valid,
        depth=ch["depth"],
        position=jnp.where(vmask, stack3("pos_x", "pos_y", "pos_z"), 0.0),
        normal=jnp.where(
            vmask, stack3("nrm_x", "nrm_y", "nrm_z"),
            jnp.array([0.0, 0.0, 1.0]),
        ),
        uv=jnp.where(vmask, stack2("uv_u", "uv_v"), 0.0),
        duv_dx=jnp.where(vmask, stack2("duvdx_u", "duvdx_v"), 0.0),
        duv_dy=jnp.where(vmask, stack2("duvdy_u", "duvdy_v"), 0.0),
        dpos_dx=jnp.where(vmask, stack3("dposdx_x", "dposdx_y", "dposdx_z"), 0.0),
        dpos_dy=jnp.where(vmask, stack3("dposdy_x", "dposdy_y", "dposdy_z"), 0.0),
        material_id=jnp.where(valid, ch["material"], 0),
        model_scale=jnp.where(valid, ch["scale"], 1.0),
        tri_id=ch["tri"],
    )

"""Wide (8-ary) LBVH build + ray traversal — the replacement for
VK_KHR_acceleration_structure / ray_query (SURVEY.md §2.5).

The reference builds one BLAS per primitive plus a TLAS over instances
(src/acceleration_structures.rs) and traverses with hardware ray queries
(shader/src/lighting.rs:97-125, shader/src/lib.rs:742-797). Here:

  * build: triangles are Morton-sorted by centroid, packed LEAF_TRIS per
    leaf row, and folded bottom-up into 8-ary levels. Because grouping is
    by CONSECUTIVE index (node i's children are ids 8i..8i+7 one level
    down, leaf row i covers sorted triangles LEAF_TRIS*i..), the topology is
    fully implicit: no child pointers, ragged tails are plain count
    arithmetic, and a refit is a chain of dense min/max folds. The fold
    itself runs in C++ when available (native/bvh_native.cc), NumPy
    otherwise.
  * traversal: stack-based batched walk. The wide shape is the point on
    a vector machine: a binary tree walk costs ~log2(T) ≈ 17 levels of
    divergent while-loop iterations where every lane pays the batch's
    worst trip count; the 8-ary walk tests 8 child AABBs per ONE row
    gather and LEAF_TRIS triangles per ONE leaf-row gather, cutting iteration
    counts ~5x. Shadow rays are any-hit and — exactly like the
    reference's ``trace_shadow_ray``, which confirms every candidate
    unconditionally (shader/src/lighting.rs:115-118) — ignore alpha
    clipping. The AS-debug caster's alpha-tested closest-hit walk
    (shader/src/lib.rs:742-797) lives in render/raytrace.py.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

# Triangles per leaf row (one gather = LEAF_TRIS Moller-Trumbore tests).
# Fat leaves shrink the dragon's leaf table (134k tris -> 8.4k rows) and
# drop one tree level (fewer pops) at the price of 16 masked triangle
# tests on every pop — arithmetic traded for gathers. Env-overridable for
# sweeps of that trade; builds and walks in one process share the module
# constant, so a sweep just sets the env.
LEAF_TRIS = int(os.environ.get("TRTPU_LEAF_TRIS", "16"))
WIDE = 8  # children per internal node (one gather = 8 slab tests)
# The stackless bitstack traversal keeps one 8-bit child mask per level in
# two packed uint32 registers -> at most 8 level codes, of which one is
# the root -> 7 internal levels -> LEAF_TRIS * WIDE^7 = 16 * 8^7 ≈ 33.5M
# triangles. Plenty for the target scenes; asserted at build time.
MAX_LEVELS = 7
# rays per sequential lax.map chunk (see trace_rays); env-overridable
# for hardware sweeps (the batched loop pays its chunk's worst lane, so
# the optimum trades tail locality against per-chunk fixed cost)
_RAY_CHUNK = int(os.environ.get("TRTPU_RAY_CHUNK", str(1 << 18)))
_BFS_CHUNK = 1 << 17  # rays per frontier chunk (see trace_shadow_bfs)
# Pops per while-loop iteration: the batched loop pays a fixed
# per-iteration cost (loop bookkeeping + kernel dispatch) on top of the
# per-lane work; unrolling amortises it. Done lanes no-op extra pops
# (every update is masked by `done`), so with mean trip counts ~15 the
# waste is bounded by unroll-1 pops per ray.
_UNROLL = int(os.environ.get("TRTPU_RT_UNROLL", "4"))
# While-loop trips (each _UNROLL pops) per ray before the first
# compaction: a batched walk pays its chunk's WORST lane trip count
# (measured dragon@480p: mean 15 pops, chunk-max ~110), so phase 1 stops
# every lane at budget * unroll pops, sorts unfinished rays to the front,
# and phase 2 finishes only them — all-done chunks exit their loop after
# one condition check. Exact: phase 2 is unbounded.
_PHASE1_TRIPS = int(os.environ.get("TRTPU_PHASE1_TRIPS", "8"))
# phase-2 compaction order: "done" (unfinished first, raster-coherent) or
# "idx" (unfinished grouped by current subtree) — see trace_rays
_PHASE2_SORT = os.environ.get("TRTPU_PHASE2_SORT", "done")


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BVH:
    """Implicit-topology 8-wide BVH over world-space triangles.

    ``node_boxes`` holds every internal level's rows, coarsest level
    LAST; a level-k node's row stores its (up to) 8 children's AABBs as
    [minx miny minz maxx maxy maxz] * 8. Children of level-k node i are
    level-(k-1) nodes 8i..8i+7 (k > 0) or leaf rows 8i..8i+7 (k == 0);
    leaf row g covers Morton-sorted triangles LEAF_TRIS*g... Unused child
    slots hold inverted boxes (+inf/-inf) so they vanish in fold math;
    traversal masks them by count arithmetic, never by box contents.

    Registered as a custom pytree so the layout fields stay STATIC
    (aux data) when a BVH is passed through jit — the traversal's
    select chains and the refit's fold shapes are built from them at
    trace time (a NamedTuple would turn them into tracers).
    """

    node_boxes: jnp.ndarray  # [N_rows, WIDE * 6] f32
    leaf_tri: jnp.ndarray  # [L, LEAF_TRIS] int32 (original ids; tail repeats)
    level_offsets: tuple  # static: row offset of level k in node_boxes
    level_counts: tuple  # static: number of level-k nodes
    num_tris: int  # static T
    num_leaves: int  # static L

    def tree_flatten(self):
        return (
            (self.node_boxes, self.leaf_tri),
            (self.level_offsets, self.level_counts,
             self.num_tris, self.num_leaves),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)

    @property
    def num_levels(self) -> int:
        return len(self.level_counts)

    def children_below(self, k: int) -> int:
        """Number of child ids one level below internal level k."""
        return self.num_leaves if k == 0 else self.level_counts[k - 1]


def _morton3(x: np.ndarray) -> np.ndarray:
    """[N, 3] floats in [0,1] -> 30-bit Morton codes (uint32)."""
    q = np.clip(x * 1024.0, 0, 1023).astype(np.uint32)

    def expand(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])


def wide_layout(num_tris: int) -> tuple[int, tuple, tuple]:
    """(num_leaves, level_counts, level_offsets) for a T-triangle build —
    the static shape contract shared by build, refit and traversal."""
    if num_tris <= 0:
        raise ValueError("wide_layout: BVH build requires at least 1 triangle")
    leaves = -(-num_tris // LEAF_TRIS)
    counts = []
    n = leaves
    while True:
        n = -(-n // WIDE)
        counts.append(n)
        if n == 1:
            break
    if len(counts) > MAX_LEVELS:
        raise ValueError(
            f"{num_tris} triangles need {len(counts)} internal levels; the "
            f"bitstack traversal supports {MAX_LEVELS} "
            f"(LEAF_TRIS * WIDE^{MAX_LEVELS} = {LEAF_TRIS * WIDE**MAX_LEVELS} tris)"
        )
    offsets, off = [], 0
    for c in counts:
        offsets.append(off)
        off += c
    return leaves, tuple(counts), tuple(offsets)


def _fold_wide(child_min: np.ndarray, child_max: np.ndarray):
    """One 8-ary fold: ([n,3],[n,3]) -> (boxes [m, 48], min/max [m,3])."""
    n = child_min.shape[0]
    m = -(-n // WIDE)
    pad = m * WIDE - n
    cmin = np.concatenate(
        [child_min, np.full((pad, 3), np.inf, np.float32)], axis=0
    ).reshape(m, WIDE, 3)
    cmax = np.concatenate(
        [child_max, np.full((pad, 3), -np.inf, np.float32)], axis=0
    ).reshape(m, WIDE, 3)
    boxes = np.concatenate([cmin, cmax], axis=-1).reshape(m, WIDE * 6)
    return boxes, cmin.min(axis=1), cmax.max(axis=1)


def build_bvh(tri_vertices: np.ndarray, positions: np.ndarray) -> BVH:
    """Host-side wide-LBVH build over [T, 3] triangles of [V, 3] positions."""
    tri = np.asarray(tri_vertices, np.int64)
    pos = np.asarray(positions, np.float32)
    v = pos[tri]  # [T, 3, 3]
    t = len(tri)
    assert t >= 2, "BVH needs at least 2 triangles"

    tri_min = v.min(1)
    tri_max = v.max(1)
    centroid = (tri_min + tri_max) * 0.5
    scene_min = tri_min.min(0)
    scene_max = tri_max.max(0)
    extent = np.maximum(scene_max - scene_min, 1e-9)
    norm = (centroid - scene_min) / extent

    from transmission_renderer_tpu import native

    codes = native.morton3(norm)
    if codes is None:
        codes = _morton3(norm)
    order = np.lexsort((np.arange(t), codes)).astype(np.int64)

    leaves, counts, offsets = wide_layout(t)
    padded = np.concatenate(
        [order, np.full(leaves * LEAF_TRIS - t, order[-1], np.int64)]
    )
    leaf_tri = padded.reshape(leaves, LEAF_TRIS)

    # leaf-row AABBs (tail slots repeat the last triangle — duplicates
    # cannot inflate a min/max fold)
    lm = tri_min[leaf_tri.reshape(-1)].reshape(leaves, LEAF_TRIS, 3)
    lx = tri_max[leaf_tri.reshape(-1)].reshape(leaves, LEAF_TRIS, 3)

    boxes = native.wide_fold(lm.min(axis=1), lx.max(axis=1), counts)
    if boxes is None:
        cmin, cmax = lm.min(axis=1), lx.max(axis=1)
        rows = []
        for _ in counts:
            b, cmin, cmax = _fold_wide(cmin, cmax)
            rows.append(b)
        boxes = np.concatenate(rows, axis=0)

    return BVH(
        node_boxes=jnp.asarray(boxes),
        leaf_tri=jnp.asarray(leaf_tri.astype(np.int32)),
        level_offsets=offsets,
        level_counts=counts,
        num_tris=t,
        num_leaves=leaves,
    )


def refit_bvh(
    bvh: BVH, tri_vertices: jnp.ndarray, positions: jnp.ndarray,
    passes: int | None = None,
) -> BVH:
    """Refresh AABBs for moved vertices, keeping the topology — the
    UPDATE-mode TLAS refit analogue (src/acceleration_structures.rs:192-267).
    Jittable: the implicit 8-ary topology makes this a chain of
    ``num_levels`` dense reshape-folds (~log8 T, vs log2 T gather-folds
    for a binary tree). ``passes`` is accepted for API compatibility and
    ignored (the fold count is structural)."""
    del passes
    v = positions[tri_vertices[bvh.leaf_tri.reshape(-1)]]
    v = v.reshape(bvh.num_leaves, LEAF_TRIS, 3, 3)
    cmin = jnp.min(v, axis=(1, 2))
    cmax = jnp.max(v, axis=(1, 2))
    rows = []
    for k in range(bvh.num_levels):
        n = cmin.shape[0]
        m = bvh.level_counts[k]
        pad = m * WIDE - n
        pmin = jnp.pad(cmin, ((0, pad), (0, 0)), constant_values=jnp.inf)
        pmax = jnp.pad(cmax, ((0, pad), (0, 0)), constant_values=-jnp.inf)
        pmin = pmin.reshape(m, WIDE, 3)
        pmax = pmax.reshape(m, WIDE, 3)
        rows.append(jnp.concatenate([pmin, pmax], axis=-1).reshape(m, WIDE * 6))
        cmin = jnp.min(pmin, axis=1)
        cmax = jnp.max(pmax, axis=1)
    return dataclasses.replace(bvh, node_boxes=jnp.concatenate(rows, axis=0))


def _stable_partition_perm(key: jnp.ndarray) -> jnp.ndarray:
    """Permutation that stable-partitions by a bool key (False first) —
    EXACTLY jnp.argsort(key, stable=True), but via cumsum + unique-index
    scatter: an argsort over the ray batch is a full sort, the scatter
    one pass over it."""
    n = key.shape[0]
    kf = (~key).astype(jnp.int32)
    nf = jnp.cumsum(kf)
    total_false = nf[-1]
    nt = jnp.cumsum(key.astype(jnp.int32))
    pos = jnp.where(key, total_false + nt - 1, nf - 1)
    return (
        jnp.zeros((n,), jnp.int32)
        .at[pos]
        .set(jnp.arange(n, dtype=jnp.int32), unique_indices=True)
    )


def _inverse_perm(perm: jnp.ndarray) -> jnp.ndarray:
    """inv[perm[i]] = i via one unique-index scatter (vs an argsort)."""
    n = perm.shape[0]
    return (
        jnp.zeros((n,), jnp.int32)
        .at[perm]
        .set(jnp.arange(n, dtype=jnp.int32), unique_indices=True)
    )


def _ray_aabb(origin, inv_dir, t_max, bmin, bmax):
    """Slab test -> bool (handles inf inv_dir per IEEE); broadcasts over
    leading box axes."""
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    enter = jnp.max(tmin, axis=-1)
    exit_ = jnp.min(tmax, axis=-1)
    return (enter <= exit_) & (exit_ >= 0.0) & (enter <= t_max)


def _ray_tri(origin, direction, t_min, t_max, v0, v1, v2):
    """Moller-Trumbore -> (hit bool, t, u, v); broadcasts over leading
    triangle axes."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, t, u, v


def trace_rays(
    bvh: BVH,
    tri_vertices: jnp.ndarray,  # [T, 3] int32 (into world positions)
    positions: jnp.ndarray,  # [V, 3] world-space
    origins: jnp.ndarray,  # [..., 3]
    directions: jnp.ndarray,  # [..., 3]
    t_min: float = 0.001,
    t_max: float | jnp.ndarray = 10_000.0,
    any_hit: bool = False,
    alpha_test_fn=None,
    return_trips: bool = False,
):
    """Batched wide-BVH walk.

    Returns (hit [...] bool, t [...], tri_id [...] int32 (-1 = miss),
    u [...], v [...]). ``any_hit=True`` terminates on the first accepted
    intersection (shadow rays, shader/src/lighting.rs:97-125); otherwise
    the closest hit wins (the AS-debug caster's committed intersection).
    ``t_max`` may be per-ray (point-light shadow rays use the light
    distance, shader/src/lighting.rs:64-71). ``alpha_test_fn(tri_id, u, v)
    -> bool`` confirms candidates (the caster's alpha-clip re-test,
    shader/src/lib.rs:777-784); None confirms everything. The callback
    receives [LEAF_TRIS]-shaped candidate batches (one leaf row per
    call), so its body must broadcast-index, never scalar-index.
    ``return_trips=True`` appends each ray's pop count to the returned
    tuple (traversal-economics telemetry, tools/rt_bench.py).
    """
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    n = o.shape[0]
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), shape).reshape(-1)

    inv_d = jnp.where(
        jnp.abs(d) > 1e-20, 1.0 / d, jnp.where(d < 0, -1e20, 1e20)
    )  # sign-matched large fallback (sign(d)*1e20+1e20 was 0 for tiny-negative d)

    # Pre-gather each leaf row's triangle geometry ONCE, outside the
    # batched walk ([L, LEAF_TRIS*9] f32, ~5 MB at 134k tris): the leaf test is
    # then a single row gather. (An in-leaf positions[tri_vertices[id]]
    # double gather makes XLA broadcast the whole positions table across
    # the ray batch — hundreds of GB at 1080p.)
    tri_xyz = positions[tri_vertices]  # [T, 3, 3]
    leaf_xyz = tri_xyz[bvh.leaf_tri.reshape(-1)].reshape(
        bvh.num_leaves, LEAF_TRIS * 9
    )
    # Occlusion-only mode (any-hit, no alpha test — the shadow rays):
    # nothing reads tri ids or uv, so the per-pop leaf-id gather and the
    # id/uv bookkeeping are dropped; hit lanes report tri_id 0. When ids
    # ARE needed they ride the SAME leaf row as f32 (exact for ids <
    # 2^24, asserted) — one leaf gather instead of two (in-loop gathers
    # dominate the walk's work).
    occlusion_only = any_hit and alpha_test_fn is None
    if not occlusion_only:
        assert bvh.num_tris < (1 << 24), "tri ids exceed exact-f32 range"
        leaf_rows = jnp.concatenate(
            [leaf_xyz, bvh.leaf_tri.astype(jnp.float32)], axis=1
        )  # [L, LEAF_TRIS * 10]
    else:
        leaf_rows = leaf_xyz
    num_rows = bvh.node_boxes.shape[0]
    # ONE unified row table for both pop halves: the masked leaf and
    # inner halves both execute every pop (SIMD), so separate tables cost
    # TWO in-loop gathers per pop — and in-loop gathers are the
    # traversal's dominant work. Node rows (WIDE*6 wide) pad to the leaf row
    # width and prepend the leaf rows; each pop gathers one row and the
    # two halves slice it. Built once per trace outside the walk
    # (~+0.5 MB of node-row padding).
    node_w = bvh.node_boxes.shape[1]
    leaf_w = leaf_rows.shape[1]
    uni_w = max(node_w, leaf_w)
    unified_rows = jnp.concatenate(
        [
            jnp.pad(bvh.node_boxes, ((0, 0), (0, uni_w - node_w))),
            jnp.pad(leaf_rows, ((0, 0), (0, uni_w - leaf_w))),
        ],
        axis=0,
    )  # [num_rows + num_leaves, uni_w]
    assert bvh.num_levels <= MAX_LEVELS, "scene exceeds bitstack depth"
    lanes_t = jnp.arange(LEAF_TRIS, dtype=jnp.int32)
    lanes_w = jnp.arange(WIDE, dtype=jnp.int32)

    def make_walk(budget: int | None):
        """Build a vmappable walk resuming from a state tuple; stops when
        done or (budget is not None) after budget * _UNROLL pops."""

        # STACKLESS bitstack traversal: every piece of per-ray state is a
        # scalar register — two uint32 "trail" words hold one 8-bit mask
        # of untested children per tree level (codes 0..3 in trail_lo,
        # 4..7 in trail_hi), and the current node's ancestors are implied
        # by its index (ancestor at +k levels = idx >> 3k). A per-lane
        # stack array would need dynamic scatter/gather into [N, 64]
        # inside the batched while-loop, which both moves real memory
        # every iteration. Masked straight-line leaf +
        # inner halves, NO lax.cond (batching a cond broadcasts its
        # unbatched closure operands across the ray batch).
        def pop(o_i, inv_i, d_i, s):
            lvl, idx, tlo, thi, best_t, best_tri, bu, bv, trips, done = s
            # per-lane pop counter (traversal-economics telemetry;
            # tools/rt_bench.py) — costs one masked add per pop
            trips = trips + jnp.where(done, 0, 1)

            # ---- advance: pop the deepest (lowest-code) non-empty mask
            empty = (tlo == 0) & (thi == 0)
            have_lo = tlo != 0
            w = jnp.where(have_lo, tlo, thi)
            b0 = w & 0xFF
            b1 = (w >> 8) & 0xFF
            b2 = (w >> 16) & 0xFF
            b3 = (w >> 24) & 0xFF
            byte = jnp.where(
                b0 != 0, 0, jnp.where(b1 != 0, 1, jnp.where(b2 != 0, 2, 3))
            )
            mask = jnp.where(
                b0 != 0, b0, jnp.where(b1 != 0, b1, jnp.where(b2 != 0, b2, b3))
            )
            bit = mask & -mask
            j = jnp.int32(0)
            for kk in range(1, WIDE):
                j = jnp.where(bit == (1 << kk), kk, j)
            clear = bit << (byte * 8)
            tlo = jnp.where(have_lo, tlo ^ clear, tlo)
            thi = jnp.where(have_lo | empty, thi, thi ^ clear)
            code = byte + jnp.where(have_lo, 0, 4)
            # ancestor of the current node at the popped mask's parent
            # level; shift >= 0 by the deepest-first invariant (max is
            # pure insurance against a garbage code on the empty lane)
            anc = idx >> jnp.maximum(3 * (code + 1 - lvl), 0)
            idx = jnp.where(empty, idx, anc * WIDE + j)
            lvl = jnp.where(empty, lvl, code)
            done = done | empty
            is_leaf = (lvl == 0) & ~done
            is_inner = (lvl > 0) & ~done

            # ---- ONE row gather serves both masked halves ----
            li = jnp.clip(idx, 0, bvh.num_leaves - 1)
            clvl = jnp.maximum(lvl - 1, 0)
            row_off = jnp.int32(bvh.level_offsets[0])
            n_below = jnp.int32(bvh.children_below(0))
            for k in range(1, bvh.num_levels):
                row_off = jnp.where(clvl == k, bvh.level_offsets[k], row_off)
                n_below = jnp.where(clvl == k, bvh.children_below(k), n_below)
            uidx = jnp.where(
                is_leaf,
                num_rows + li,
                jnp.clip(row_off + idx, 0, num_rows - 1),
            )
            row = unified_rows[uidx]

            # ---- leaf half (masked by is_leaf) ----
            tv = row[: LEAF_TRIS * 9].reshape(LEAF_TRIS, 3, 3)
            hit4, t4, u4, v4 = _ray_tri(
                o_i, d_i, t_min, best_t, tv[:, 0], tv[:, 1], tv[:, 2]
            )
            hit4 = hit4 & is_leaf & (lanes_t < bvh.num_tris - li * LEAF_TRIS)
            if occlusion_only:
                take = jnp.any(hit4)
                best_tri = jnp.where(take, 0, best_tri)
                done = done | take
            else:
                ids = row[LEAF_TRIS * 9 : LEAF_TRIS * 10].astype(jnp.int32)
                if alpha_test_fn is not None:
                    hit4 = hit4 & alpha_test_fn(ids, u4, v4)
                t4m = jnp.where(hit4, t4, jnp.inf)
                jt = jnp.argmin(t4m)
                take = hit4[jt]
                best_t = jnp.where(take, t4m[jt], best_t)
                best_tri = jnp.where(take, ids[jt], best_tri)
                bu = jnp.where(take, u4[jt], bu)
                bv = jnp.where(take, v4[jt], bv)
                done = done | (take if any_hit else False)

            # ---- inner half (masked by is_inner) ----
            boxes = row[: WIDE * 6].reshape(WIDE, 6)
            hit8 = (
                _ray_aabb(o_i, inv_i, best_t, boxes[:, :3], boxes[:, 3:])
                & is_inner
                & (lanes_w < n_below - idx * WIDE)
            )
            m8 = jnp.sum(
                jnp.where(hit8, jnp.int32(1) << lanes_w, 0)
            )
            add = m8 << ((clvl & 3) * 8)
            in_lo = clvl < 4
            tlo = jnp.where(is_inner & in_lo, tlo | add, tlo)
            thi = jnp.where(is_inner & ~in_lo, thi | add, thi)
            return lvl, idx, tlo, thi, best_t, best_tri, bu, bv, trips, done

        def walk(o_i, inv_i, d_i, s0):
            def body_state(s):
                for _ in range(_UNROLL):
                    s = pop(o_i, inv_i, d_i, s)
                return s

            if budget is None:
                return jax.lax.while_loop(
                    lambda s: ~s[-1], body_state, s0
                )
            carry0 = (jnp.int32(0), s0)
            final = jax.lax.while_loop(
                lambda c: (c[0] < budget) & ~c[1][-1],
                lambda c: (c[0] + 1, body_state(c[1])),
                carry0,
            )
            return final[1]

        return walk

    def init_state(t_max_i):
        # virtual super-root: the real root (idx 0, code D) is the sole
        # set bit of the trail at code D; the first advance descends
        # into it (anc = 0 >> 0 with lvl = D + 1).
        root_code = bvh.num_levels  # root = level num_levels-1 -> code D
        root_mask = jnp.int32(1) << ((root_code & 3) * 8)
        zeros = jnp.zeros_like(t_max_i, jnp.int32)
        return (
            zeros + (root_code + 1), zeros,
            zeros + (root_mask if root_code < 4 else 0),
            zeros + (root_mask if root_code >= 4 else 0),
            t_max_i, zeros - 1,
            jnp.zeros_like(t_max_i), jnp.zeros_like(t_max_i),
            zeros,  # per-lane pop counter
            # dead-on-arrival rays (t_max <= t_min: padding, gated
            # shadow pairs) start DONE. The empty (t_min, t_max)
            # interval already rejects every triangle, but AABBs
            # containing the ray origin still pass the slab test
            # (enter < 0 <= exit <= t_max holds at t_max = 0), so
            # without this they walk their containment path to the
            # leaves — the liveness pre-sort's all-done chunks only
            # actually exit early because of this flag. Bit-identical:
            # such rays can never accept a hit.
            t_max_i <= t_min,
        )

    def run_chunks(rays, state, budget):
        """Advance every ray's walk (chunked lax.map) until done or
        budget; rays/state are tuples of [M]-leading arrays with M a
        multiple of `chunk` (or M <= chunk)."""
        walk = make_walk(budget)
        m = rays[0].shape[0]
        if m <= chunk:
            return jax.vmap(walk)(*rays, state)
        reshape = lambda a: a.reshape(m // chunk, chunk, *a.shape[1:])
        args = jax.tree.map(reshape, (rays, state))
        out = jax.lax.map(
            lambda x: jax.vmap(walk)(*x[0], x[1]), args
        )
        return jax.tree.map(lambda a: a.reshape(m, *a.shape[2:]), out)

    # Chunk the ray batch: a single flat multi-million-ray batched
    # while-loop balloons live state; lax.map walks fixed-size chunks
    # sequentially — each chunk still fills the device. Large batches run
    # TWO phases: a budgeted sweep (every lane stops at
    # _PHASE1_TRIPS * _UNROLL pops — a p90-ish trip count), then a
    # compaction that packs unfinished rays to the front and an
    # unbounded phase 2 in which all-done chunks exit immediately. The
    # batched loop pays its chunk's WORST lane per iteration, so this
    # bounds the worst-lane waste to the (few) packed heavy chunks.
    # (_RAY_CHUNK is module-level so tests can shrink it to cover the
    # phase path on CPU.)
    #
    # PERMUTATION ECONOMICS: applying a ray permutation to k separate
    # arrays costs k full-batch gathers. Each permutation is therefore applied to
    # ONE packed row per logical group: rays pack to [N, 9] once, and
    # walk state packs to a [N, 10] f32 row around each shuffle (ids and
    # the two trail words are < 2^24, bools are 0/1 — all f32-exact).
    chunk = _RAY_CHUNK

    if n > chunk:
        # State packing for the shuffles: lvl/idx/best_tri/trips are
        # < 2^24 (f32-exact), t/u/v are floats, done is 0/1 — but the
        # two trail words are full 32-bit masks, NOT f32-exact: pack
        # them as two 16-bit halves each.
        def _pack_state(s):
            def split16(w):
                return (
                    (w & 0xFFFF).astype(jnp.float32),
                    ((w >> 16) & 0xFFFF).astype(jnp.float32),
                )

            lo0, lo1 = split16(s[2])
            hi0, hi1 = split16(s[3])
            return jnp.stack(
                [
                    s[0].astype(jnp.float32), s[1].astype(jnp.float32),
                    lo0, lo1, hi0, hi1,
                    s[4], s[5].astype(jnp.float32), s[6], s[7],
                    s[8].astype(jnp.float32), s[9].astype(jnp.float32),
                ],
                axis=1,
            )

        def _unpack_state(p):
            def join16(a, b):
                return a.astype(jnp.int32) | (b.astype(jnp.int32) << 16)

            return (
                p[:, 0].astype(jnp.int32), p[:, 1].astype(jnp.int32),
                join16(p[:, 2], p[:, 3]), join16(p[:, 4], p[:, 5]),
                p[:, 6], p[:, 7].astype(jnp.int32), p[:, 8], p[:, 9],
                p[:, 10].astype(jnp.int32), p[:, 11] > 0.5,
            )

        pad = (-n) % chunk
        o_p = jnp.pad(o, ((0, pad), (0, 0)))
        inv_p = jnp.pad(inv_d, ((0, pad), (0, 0)), constant_values=1e20)
        d_p = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
        # padding rays get t_max=0: the empty (t_min, 0) interval rejects
        # every triangle, and init_state starts them DONE (an AABB
        # containing the origin would otherwise still pass the slab test
        # and walk its containment path).
        t_p = jnp.pad(t_max_arr, (0, pad))
        rays_packed = jnp.concatenate([o_p, inv_p, d_p], axis=1)  # [N, 9]
        # LIVENESS pre-compaction: rays dead before the walk
        # (t_max <= 0: invalid pixels, cluster-gated lights, padding)
        # start done and never pop — but a chunk pays its WORST lane, so
        # dead lanes scattered through live chunks save nothing. A stable
        # pre-partition (live first; raster-coherent within each group)
        # packs them into all-done chunks that exit phase 1 immediately.
        live_perm = _stable_partition_perm(t_p <= 0.0)
        rays_packed = rays_packed[live_perm]
        rays = (
            rays_packed[:, 0:3], rays_packed[:, 3:6], rays_packed[:, 6:9]
        )
        state = run_chunks(rays, init_state(t_p[live_perm]), _PHASE1_TRIPS)
        # compaction: unfinished rays first (stable → raster-coherent
        # within each group), finish them, un-permute.
        # TRTPU_PHASE2_SORT=idx additionally groups unfinished rays by
        # their CURRENT node (same subtree → the phase-2 chunks share
        # gather rows and remaining trip counts); exact — the
        # permutation is undone (hardware A/B knob).
        if _PHASE2_SORT == "idx":
            key = jnp.where(state[-1], jnp.int32(0x7FFFFFFF), state[1])
            perm = jnp.argsort(key, stable=True)
        else:
            perm = _stable_partition_perm(state[-1])
        rays_packed = rays_packed[perm]
        rays_s = (
            rays_packed[:, 0:3], rays_packed[:, 3:6], rays_packed[:, 6:9]
        )
        state_s = _unpack_state(_pack_state(state)[perm])
        final_s = run_chunks(rays_s, state_s, None)
        inv_perm = _inverse_perm(live_perm[perm])
        final = _unpack_state(_pack_state(final_s)[inv_perm][:n])
        best_t, best_tri, bu, bv = final[4], final[5], final[6], final[7]
        trips = final[8]
    else:
        final = run_chunks((o, inv_d, d), init_state(t_max_arr), None)
        best_t, best_tri, bu, bv = final[4], final[5], final[6], final[7]
        trips = final[8]
    hit = best_tri >= 0
    out = (
        hit.reshape(shape),
        best_t.reshape(shape),
        best_tri.reshape(shape),
        bu.reshape(shape),
        bv.reshape(shape),
    )
    if return_trips:
        out = out + (trips.reshape(shape),)
    return out


def trace_shadow_bfs(
    bvh: BVH,
    tri_vertices: jnp.ndarray,  # [T, 3] int32 (into world positions)
    positions: jnp.ndarray,  # [V, 3] world-space
    origins: jnp.ndarray,  # [..., 3]
    directions: jnp.ndarray,  # [..., 3]
    t_min: float = 0.001,
    t_max: float | jnp.ndarray = 10_000.0,
    chunk: int | None = None,
    cap_factor: int = 8,
):
    """Any-hit occlusion via LEVEL-SYNCHRONOUS frontier traversal
    -> (hit [...] bool, overflowed [] int32).

    The breadth-first alternative to the per-ray bitstack walk
    (trace_rays): instead of a batched while loop that executes ~2k
    small masked iterations, the frontier design runs ONE flat
    vectorized round per tree level:
    every live (ray, node) pair tests its 8 children in a single big
    gather + slab test, survivors are compacted with a cumsum +
    unique-index scatter (no sorts), and the next round processes them
    all at once. Tree
    depth (~5 rounds for 134k tris) replaces per-ray trip counts (~17
    mean, ~170 chunk-worst) as the iteration count.

    Semantics match trace_rays(any_hit=True) exactly: hit iff ANY
    triangle intersects in (t_min, t_max[ray]) — same slab test, same
    Moller-Trumbore, same ragged-tail guards; no alpha test (shadow
    rays confirm every candidate, shader/src/lighting.rs:115-118).
    Any-hit's early-out is traded for level synchrony: occluded rays
    do full traversal here, which the flat-round efficiency repays
    ~10x over.

    ``cap_factor``: frontier capacity per ray-chunk. If a round would
    exceed it, the overflow count is returned (> 0 means some items
    were DROPPED and shadows may be missed). NOTE: nothing in the frame
    path calls this function (it lost to the walk where it was last
    measured; not measured on the GPU — ROADMAP D4), so the overflow
    count is not wired into FrameDiagnostics.
    """
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    n = o.shape[0]
    t_max_arr = jnp.broadcast_to(
        jnp.asarray(t_max, jnp.float32), shape
    ).reshape(-1)
    inv_d = jnp.where(
        jnp.abs(d) > 1e-20, 1.0 / d, jnp.where(d < 0, -1e20, 1e20)
    )  # sign-matched large fallback (sign(d)*1e20+1e20 was 0 for tiny-negative d)

    tri_xyz = positions[tri_vertices]  # [T, 3, 3]
    leaf_xyz = tri_xyz[bvh.leaf_tri.reshape(-1)].reshape(
        bvh.num_leaves, LEAF_TRIS * 9
    )
    lanes_t = jnp.arange(LEAF_TRIS, dtype=jnp.int32)
    lanes_w = jnp.arange(WIDE, dtype=jnp.int32)
    D = bvh.num_levels

    chunk = int(chunk or _BFS_CHUNK)
    chunk = min(chunk, max(n, 1))
    cap = cap_factor * chunk

    def run_chunk(o_c, inv_c, d_c, t_c):
        R = o_c.shape[0]
        iota = jnp.arange(cap, dtype=jnp.int32)
        # frontier: compacted (ray, node) pairs; entries >= count dead
        ray_f = jnp.where(iota < R, iota, 0)
        node_f = jnp.zeros((cap,), jnp.int32)
        count = jnp.int32(R)
        overflow = jnp.int32(0)

        for lvl in range(D, 0, -1):
            region_rows = bvh.level_counts[lvl - 1]
            n_below = bvh.children_below(lvl - 1)
            valid = iota < count
            safe_node = jnp.clip(node_f, 0, region_rows - 1)
            rows = bvh.node_boxes[
                jnp.int32(bvh.level_offsets[lvl - 1]) + safe_node
            ]  # [cap, WIDE * 6]
            boxes = rows.reshape(cap, WIDE, 6)
            o_i = o_c[ray_f][:, None, :]
            inv_i = inv_c[ray_f][:, None, :]
            t_i = t_c[ray_f][:, None]
            hit8 = _ray_aabb(o_i, inv_i, t_i, boxes[..., :3], boxes[..., 3:])
            child = node_f[:, None] * WIDE + lanes_w[None, :]
            m = hit8 & (child < n_below) & valid[:, None]
            flat_m = m.reshape(-1)
            flat_child = child.reshape(-1)
            flat_ray = jnp.broadcast_to(
                ray_f[:, None], (cap, WIDE)
            ).reshape(-1)
            pos = jnp.cumsum(flat_m.astype(jnp.int32))
            new_count = pos[-1]
            dst = jnp.where(flat_m, pos - 1, cap)
            # dst is strictly increasing over kept items (unique) and
            # `cap` (out of bounds -> dropped) elsewhere
            node_f = jnp.zeros((cap,), jnp.int32).at[dst].set(
                flat_child, mode="drop", unique_indices=True
            )
            ray_f = jnp.zeros((cap,), jnp.int32).at[dst].set(
                flat_ray, mode="drop", unique_indices=True
            )
            overflow = jnp.maximum(overflow, new_count - cap)
            count = jnp.minimum(new_count, cap)

        # ---- leaf round: LEAF_TRIS-triangle rows ----
        valid = iota < count
        safe_leaf = jnp.clip(node_f, 0, bvh.num_leaves - 1)
        tv = leaf_xyz[safe_leaf].reshape(cap, LEAF_TRIS, 3, 3)
        o_i = o_c[ray_f][:, None, :]
        d_i = d_c[ray_f][:, None, :]
        t_i = t_c[ray_f][:, None]
        hit4, _, _, _ = _ray_tri(
            o_i, d_i, t_min, t_i, tv[:, :, 0], tv[:, :, 1], tv[:, :, 2]
        )
        hit4 = hit4 & (
            lanes_t[None, :] < bvh.num_tris - safe_leaf[:, None] * LEAF_TRIS
        ) & valid[:, None]
        item_hit = jnp.any(hit4, axis=-1)
        ray_hit = jnp.zeros((R,), jnp.int32).at[ray_f].max(
            item_hit.astype(jnp.int32), mode="drop"
        )
        return ray_hit.astype(bool), overflow

    if n <= chunk:
        hit, overflow = run_chunk(o, inv_d, d, t_max_arr)
        return hit[:n].reshape(shape), overflow

    pad = (-n) % chunk
    o_p = jnp.pad(o, ((0, pad), (0, 0)))
    inv_p = jnp.pad(inv_d, ((0, pad), (0, 0)), constant_values=1e20)
    d_p = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    t_p = jnp.pad(t_max_arr, (0, pad))  # padding rays: t_max = 0 -> dead
    reshape = lambda a: a.reshape(-1, chunk, *a.shape[1:])
    hits, overflows = jax.lax.map(
        lambda x: run_chunk(*x),
        (reshape(o_p), reshape(inv_p), reshape(d_p), reshape(t_p)),
    )
    return (
        hits.reshape(-1)[:n].reshape(shape),
        jnp.max(overflows),
    )

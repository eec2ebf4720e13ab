"""Traversal-cost decay of the refit-only BVH under sustained rotation.

The reference builds one BLAS per primitive + an instance TLAS and
refits only the TLAS per frame (src/acceleration_structures.rs:6-267);
this repo refits a single flat world-space BVH whose Morton topology is
never re-sorted. Under model rotation (--rotate-model) the sorted order
decorrelates from space and AABB overlap grows. This script quantifies
it: mean/percentile traversal pop counts for sun shadow rays after
refitting the frame-0 topology to rotated geometry, vs a fresh rebuild
at each angle.

Run (CPU, ~2 min): python tools/bvh_decay.py
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import transmission_renderer_tpu.ops.bvh as B  # noqa: E402
from transmission_renderer_tpu.models import build_dragon_scene  # noqa: E402
from transmission_renderer_tpu.scene.types import (  # noqa: E402
    Similarity,
    quat_from_axis_angle,
    similarity_apply,
)


def trace_mean_pops(bvh, tri_vtx, world_pos, origins, dirs, t_max):
    """Per-ray pop counts via the REAL traversal's telemetry output
    (ops/bvh.py trace_rays(return_trips=True)) — one source of truth
    for the walk instead of a hand-copied inner loop that would drift
    as the traversal evolves (it already had: no chunking, different
    inv guard)."""
    out = B.trace_rays(
        bvh, tri_vtx, world_pos, origins, dirs,
        t_max=t_max, any_hit=True, return_trips=True,
    )
    return np.asarray(out[-1])


def main():
    builder = build_dragon_scene(stacks=90, sectors=180)
    scene, dl, flags = builder.finish_bundle()
    bvh0 = builder.build_rt_bvh()
    obj_pos = scene.positions[dl.vtx_src]

    rng = np.random.default_rng(0)
    n = 50_000
    # shadow-ray proxy workload: origins on a disc above the floor,
    # direction = a fixed sun
    origins = np.stack(
        [
            rng.uniform(-4, 4, n),
            rng.uniform(0.0, 0.5, n),
            rng.uniform(-7, 0, n),
        ],
        -1,
    ).astype(np.float32)
    sun = np.array([0.3, 0.8, 0.52], np.float32)
    sun /= np.linalg.norm(sun)
    dirs = np.broadcast_to(sun, (n, 3)).astype(np.float32)
    t_max = np.full(n, 1e4, np.float32)

    print("angle  refit-mean  refit-p99  rebuild-mean  rebuild-p99")
    for deg in (0, 30, 90, 180):
        rot = quat_from_axis_angle([0.0, 1.0, 0.0], np.radians(deg))
        t = Similarity(
            translation=scene.inst_transform.translation[dl.vtx_inst],
            scale=scene.inst_transform.scale[dl.vtx_inst],
            rotation=jnp.asarray(
                np.broadcast_to(rot, (dl.vtx_inst.shape[0], 4)).astype(
                    np.float32
                )
            ),
        )
        world = similarity_apply(t, obj_pos)
        refit = B.refit_bvh(bvh0, dl.tri_vtx, world)
        c_refit = trace_mean_pops(
            refit, dl.tri_vtx, world, jnp.asarray(origins),
            jnp.asarray(dirs), jnp.asarray(t_max),
        )
        rebuild = B.build_bvh(
            np.asarray(dl.tri_vtx), np.asarray(world)
        )
        c_re = trace_mean_pops(
            rebuild, dl.tri_vtx, world, jnp.asarray(origins),
            jnp.asarray(dirs), jnp.asarray(t_max),
        )
        print(
            f"{deg:5d}  {c_refit.mean():9.1f}  {np.percentile(c_refit, 99):8.0f}"
            f"  {c_re.mean():11.1f}  {np.percentile(c_re, 99):10.0f}"
        )


if __name__ == "__main__":
    main()

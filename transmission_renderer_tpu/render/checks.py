"""checkify-instrumented frame: the debug-mode sanitizer (SURVEY 5.2).

The reference runs under the Vulkan validation layer at all times
(src/main.rs:130-132) — its de-facto race/OOB detector. Here the race
class of bugs is gone by construction (XLA SSA dataflow, no atomics), so
the remaining sanitizer value is **out-of-bounds indexing**: this renderer
is gather-heavy (texture atlas, mip pyramid, cluster tables, material
rows, triangle records), and XLA silently clamps OOB gather indices — a
sizing bug renders wrong pixels instead of crashing. Wrapping the frame
in ``jax.experimental.checkify`` with ``index_checks`` turns every such
clamp into a reported error with source location, which is exactly what
GPU-assisted validation does for descriptor indexing.

NaN checking is intentionally NOT folded in here: masked-out lanes
legitimately compute NaN/Inf before their ``where`` select (background
pixels, empty bin slots, the reference's own IEEE inf handling in Beer's
law, glam-pbr/src/lib.rs:275-290), so ``nan_checks`` would drown real
signals in by-design noise. The user-visible invariant — a finite final
image — is checked post-hoc by ``--check-nan`` (cli.py).
"""

from __future__ import annotations

import dataclasses
import sys
from functools import partial

import jax
from jax.experimental import checkify

from transmission_renderer_tpu.render.frame import render_frame


def checked_frame_fn(*, config, flags, bvh=None, out=sys.stderr):
    """A drop-in replacement for ``jax.jit(partial(render_frame, ...))``
    that runs checkify index checks and prints any error per frame.

    Forces the XLA raster with static per-tile trip counts (exactly
    equivalent — see RenderConfig.static_raster_trips) because checkify
    cannot instrument Mosaic kernels or batched while-loops; the BVH
    traversal is a batched while-loop too, so ray-traced shadows are
    excluded (cli.py rejects the combination)."""
    if bvh is not None or config.ray_traced_shadows:
        raise ValueError("--debug-checks does not support the RT path "
                         "(batched while-loop traversal)")
    config = dataclasses.replace(
        config, use_pallas_raster=False, static_raster_trips=True
    )
    inner = checkify.checkify(
        partial(render_frame, config=config, flags=flags, bvh=bvh),
        errors=checkify.index_checks,
    )
    jitted = jax.jit(inner)

    def render(scene, dl, params, lights):
        err, img = jitted(scene, dl, params, lights)
        msg = err.get()
        if msg:
            print(f"CHECKIFY: {msg}", file=out)
        return img

    return render

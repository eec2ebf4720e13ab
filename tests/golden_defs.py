"""Shared golden-frame definitions (scene table + renderers).

Used by tests/test_goldens.py (comparison) and tools/regen_goldens.py
(intentional regeneration). Goldens are rendered on CPU at 128x72; the
comparison tolerance absorbs backend-to-backend f32 reassociation, so the
same PNGs pin BOTH raster backends (pure-JAX and Pallas-interpret).

Scene choices follow VERDICT round 2 #8: cover the paths perf surgery
touches — the flagship dragon (transmission + attenuation + pyramid
fetch), the helmet analogue (the dense opaque material tap, now with the
full 5-texture slot set), the stress scene (alpha-clip depth peeling +
instancing), and the AS-debug ray caster (BVH traversal + alpha-tested
candidates). Meshes are reduced-density versions of the bench scenes:
the goldens pin sampler/shading/raster semantics, not triangle scale.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import numpy as np

from transmission_renderer_tpu.config import RenderConfig
from transmission_renderer_tpu.models import (
    bindless_lights,
    build_attenuation_scene,
    build_bindless_scene,
    build_dragon_scene,
    build_opaque_scene,
    build_stress_scene,
    build_test_scene,
)
from transmission_renderer_tpu.pbr.lights import pack_lights, point_light
from transmission_renderer_tpu.render import make_frame_params, render_frame
from transmission_renderer_tpu.scene.camera import CameraRig
from transmission_renderer_tpu.scene.textures import linear_to_srgb

CFG = RenderConfig(
    width=128, height=72, tile_w=32, tile_h=8,
    max_tris_per_tile=1024, max_tiles_per_tri=16, max_big_tris=32,
)
# Pallas-kernel variant: the G-buffer kernel's native tile is 8x128.
# Extra peel rounds + full re-race cap: at 128x72 the stress scene's
# leaf-card alpha holes span whole 128-px tiles, so the depth peel needs
# more rounds to converge to the exact image (at convergence the peeled
# result equals the in-raster alpha test of the JAX path).
CFG_PAL = dataclasses.replace(
    CFG, tile_w=128, tile_h=8, use_pallas_raster=True, pallas_interpret=True,
    alpha_clip_rounds=8, clip_retile_cap_frac=1.0,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

# Full-resolution flagship golden: the bench scene at the bench's exact
# 1920x1080 default config and camera — small frames can hide
# tile-boundary and cap-floor bugs (the sparse-worklist block floors and
# the 128-px tile economics only engage at scale). chip_smoke.py renders
# it through the default GPU path (CFG_HD: the raster kernel); the CPU
# test (tests/test_golden_hd.py) and regeneration use the XLA raster at
# 32x8 tiles (CFG_HD_CPU), whose per-tile bins hold the busiest tile of
# the glass dragon (2665 triangles; at 128x8 it is 5456 and every tile
# of the vmapped loop pays that many trips). The raster is exact, so
# the tile shape does not change the image.
CFG_HD = RenderConfig(width=1920, height=1080)
CFG_HD_CPU = dataclasses.replace(CFG_HD, tile_w=32, max_tris_per_tile=4096)


def hd_golden_inputs():
    """(config, scene, dl, flags, params, lights) of the full-resolution
    golden: the bench dragon_attenuation frame (bench.py camera, lights
    and config) at 1920x1080."""
    scene, dl, flags = build_dragon_scene(
        roughness_override=0.25
    ).finish_bundle()
    rig = _rig((0.0, 2.2, 1.5), -0.25)
    rig.sun_yaw = 4.8  # bench.make_rig keeps the CameraRig default sun
    params = make_frame_params(
        CFG_HD, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir()
    )
    lights = pack_lights([
        point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
        point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0),
    ])
    return CFG_HD, scene, dl, flags, params, lights


def render_hd_golden(config: RenderConfig = CFG_HD_CPU) -> np.ndarray:
    """The full-resolution golden frame -> sRGB [1080, 1920, 3] float.
    Fails if the frame lost work to a capacity overflow."""
    import jax

    _, scene, dl, flags, params, lights = hd_golden_inputs()
    ldr, diag = jax.jit(partial(
        render_frame, config=config, flags=flags, return_diagnostics=True
    ))(scene, dl, params, lights)
    host = type(diag)(*[int(v) if hasattr(v, "shape") else v for v in diag])
    assert not host.overflowed(), f"HD golden frame overflowed: {host}"
    return linear_to_srgb(np.asarray(ldr))


def _dragon():
    return build_dragon_scene(stacks=40, sectors=80, roughness_override=0.25)


def _helmet():
    return build_opaque_scene(stacks=32, sectors=64)


def _stress():
    return build_stress_scene(grid=3)


def _bindless():
    return build_bindless_scene(grid=5, n_images=48)


def _bindless_lights():
    return bindless_lights(20)


# name -> (builder_fn, camera position, camera pitch[, lights_fn])
GOLDENS = {
    "test_scene": (build_test_scene, (0.0, 2.0, 2.0), -0.4),
    "attenuation": (build_attenuation_scene, (0.0, 5.0, 3.0), -0.75),
    "dragon": (_dragon, (0.0, 2.2, 1.5), -0.25),
    "helmet": (_helmet, (0.0, 2.2, 1.5), -0.25),
    "stress": (_stress, (0.0, 3.0, 2.5), -0.5),
    # bindless-scale atlas (48 mixed-size images, no bundle fast path)
    # under a 20-light rig — pins the general per-slot tap + many-light
    # cluster path (VERDICT r3 missing #3)
    "bindless": (_bindless, (0.0, 4.0, 3.0), -0.6, _bindless_lights),
}

# goldens also rendered through the Pallas-interpret kernel in
# test_goldens.py (stress exercises the depth-peel clip path)
PALLAS_GOLDENS = ("test_scene", "dragon", "stress")


def _rig(cam, pitch):
    rig = CameraRig()
    rig.camera.position = np.array(cam, np.float32)
    rig.camera.pitch = pitch
    rig.sun_yaw = 0.5
    return rig


def _lights():
    return pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)])


def render_golden(name: str, pallas: bool = False) -> np.ndarray:
    """Render golden ``name`` -> sRGB-encoded [H, W, 3] float in [0, 1]."""
    return render_golden_cfg(name, CFG_PAL if pallas else CFG)


def render_golden_cfg(name: str, cfg: RenderConfig) -> np.ndarray:
    """render_golden with an explicit config (quality-flag A/B bounds)."""
    import jax

    entry = GOLDENS[name]
    builder_fn, cam, pitch = entry[:3]
    lights = pack_lights(entry[3]()) if len(entry) > 3 else _lights()
    scene, dl, flags = builder_fn().finish_bundle()
    rig = _rig(cam, pitch)
    params = make_frame_params(
        cfg, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir()
    )
    ldr = np.asarray(
        jax.jit(partial(render_frame, config=cfg, flags=flags))(
            scene, dl, params, lights
        )
    )
    return linear_to_srgb(ldr)


def render_as_debug_golden() -> np.ndarray:
    """The AS-debug ray-cast view over the stress scene (alpha-tested
    candidate confirmation included) -> sRGB [H, W, 3] float."""
    import jax
    from transmission_renderer_tpu.render.raytrace import render_as_debug_frame

    builder = build_stress_scene(grid=2)
    scene, dl, flags = builder.finish_bundle()
    bvh = builder.build_rt_bvh()
    cfg = dataclasses.replace(CFG, ray_traced_shadows=True)
    rig = _rig((0.0, 3.0, 2.5), -0.5)
    params = make_frame_params(
        cfg, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir()
    )
    img = np.asarray(
        jax.jit(partial(render_as_debug_frame, config=cfg, bvh=bvh))(
            scene, dl, params, None
        )
    )
    return linear_to_srgb(np.clip(img, 0.0, 1.0))

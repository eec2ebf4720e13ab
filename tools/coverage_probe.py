"""Measure per-scene OPAQUE block coverage (fraction of 128-px blocks
holding any covered opaque pixel) at the bench camera — sizes the static
worklist cap for a block-sparse opaque shade (render/sparse.py). Runs on
CPU; block coverage is resolution-stable to a few percent, so a small
frame suffices. Usage: python tools/coverage_probe.py [WxH]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
from functools import partial  # noqa: E402

import jax  # noqa: E402

from transmission_renderer_tpu.config import RenderConfig  # noqa: E402
from transmission_renderer_tpu.models import (  # noqa: E402
    build_attenuation_scene,
    build_bindless_scene,
    build_dragon_scene,
    build_opaque_scene,
    build_stress_scene,
)
from transmission_renderer_tpu.render import (  # noqa: E402
    make_frame_params,
    render_frame,
)
from transmission_renderer_tpu.scene.camera import CameraRig  # noqa: E402
from transmission_renderer_tpu.pbr.lights import (  # noqa: E402
    pack_lights,
    point_light,
)


def main():
    from transmission_renderer_tpu.utils.platform import init_compile_cache

    init_compile_cache()
    size = sys.argv[1] if len(sys.argv) > 1 else "640x360"
    w, h = (int(x) for x in size.split("x"))
    cfg = RenderConfig(width=w, height=h, opaque_block_cap_frac=1.0)
    rig = CameraRig()
    params = make_frame_params(
        cfg, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir()
    )
    lights = pack_lights([
        point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
        point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0),
    ])
    builders = [
        ("dragon", lambda: build_dragon_scene(roughness_override=0.25)),
        ("smooth", lambda: build_dragon_scene(roughness_override=0.0)),
        ("helmet", build_opaque_scene),
        ("attenuation", build_attenuation_scene),
        ("stress", build_stress_scene),
        ("bindless", build_bindless_scene),
    ]
    for name, b in builders:
        scene, dl, flags = b().finish_bundle()
        render = jax.jit(partial(
            render_frame, config=cfg, flags=flags, return_diagnostics=True
        ))
        _, diag = render(scene, dl, params, lights)
        nb = (w * h + 127) // 128
        ob = int(diag.opaque_blocks)
        tb = int(diag.transmission_blocks)
        print(
            f"{name:>12}: opaque {ob}/{nb} = {ob / nb:.3f}  "
            f"transmission {tb}/{nb} = {tb / nb:.3f}",
            flush=True,
        )


if __name__ == "__main__":
    main()

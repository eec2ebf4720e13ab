"""Alpha-clip peel convergence probe (VERDICT r3 #6): for candidate
(alpha_clip_rounds, clip_retile_cap_frac) settings, render the stress
scene once and report clip_unresolved + clip-tile demand — the guard
that must stay 0 before any cap/round reduction ships as a default.

Usage: python tools/clip_probe.py [rounds:frac ...]   (frac as /16)
Default probes: 3:4 (shipped), 3:2, 2:4, 2:2, 1:4
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    specs = sys.argv[1:] or ["3:4", "3:2", "2:4", "2:2", "1:4"]

    import dataclasses
    from functools import partial

    import jax

    from transmission_renderer_tpu.utils.platform import init_compile_cache

    init_compile_cache()
    from transmission_renderer_tpu.config import RenderConfig
    from transmission_renderer_tpu.models import build_stress_scene
    from transmission_renderer_tpu.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu.render import make_frame_params, render_frame
    from transmission_renderer_tpu.scene.camera import CameraRig

    cfg0 = RenderConfig(width=1920, height=1080)
    rig = CameraRig()
    params = make_frame_params(
        cfg0, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir()
    )
    lights = pack_lights([
        point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
        point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0),
    ])
    scene, dl, flags = build_stress_scene().finish_bundle()

    for spec in specs:
        parts = spec.split(":")
        rounds = int(parts[0])
        # "rounds:f1" or a per-round cap schedule "rounds:f1,f2,f3" (/16)
        fr = tuple(int(x) / 16.0 for x in parts[1].split(","))
        cfg = dataclasses.replace(
            cfg0, alpha_clip_rounds=rounds,
            clip_retile_cap_frac=fr if len(fr) > 1 else fr[0],
        )
        render = jax.jit(partial(
            render_frame, config=cfg, flags=flags, return_diagnostics=True
        ))
        img, diag = render(scene, dl, params, lights)
        img.block_until_ready()
        demand = [int(d) for d in diag.clip_round_demand]
        print(
            f"rounds={rounds} retile_frac={parts[1]}/16: "
            f"clip_unresolved={int(diag.clip_unresolved)} "
            f"clip_tiles={int(diag.clip_tiles)}/"
            f"{diag.clip_tile_capacity} "
            f"round_demand={demand} caps={list(diag.clip_round_caps)}",
            flush=True,
        )


if __name__ == "__main__":
    main()

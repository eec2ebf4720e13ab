"""Benchmark: the BASELINE comparison-config list on one GPU.

Prints ONE JSON line on stdout: the flagship headline {"metric",
"value", "unit", "vs_baseline"}, plus a "scenes" field carrying every
comparison config's fps and the device it ran on. Per-scene JSON lines
and diagnostics (platform, device kind, frame-count sensitivity) go to
stderr. Frames are timed on the host clock around ``block_until_ready``.
It fails when JAX finds no GPU.

Scene list mirrors BASELINE.md's comparison configs (no glTF sample
assets exist in this environment, so each is the procedural analogue
from models/procedural.py, matched in triangle count / material
character):
  - helmet_opaque      — DamagedHelmet: opaque PBR, textured (diffuse +
                         MR + normal + emissive + occlusion)
  - transmission_smooth— TransmissionTest: roughness-0 transmission
  - attenuation        — AttenuationTest: KHR_materials_volume thickness
                         refraction + Beer's law, missing-UV path
  - dragon_rt_shadows  — the RT pass: LBVH refit + ray-traced shadows
  - dragon_attenuation — the flagship: DragonAttenuation analogue,
                         --roughness-override 0.25 (BASELINE target:
                         >= 30 fps per GPU at 1080p)
"""

import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from transmission_renderer_tpu.config import RenderConfig  # noqa: E402
from transmission_renderer_tpu.models import (  # noqa: E402
    bindless_lights,
    build_attenuation_scene,
    build_bindless_scene,
    build_dragon_scene,
    build_opaque_scene,
    build_stress_scene,
)
from transmission_renderer_tpu.pbr.lights import pack_lights, point_light  # noqa: E402
from transmission_renderer_tpu.render import (  # noqa: E402
    make_frame_params,
    render_frame,
)
from transmission_renderer_tpu.scene.camera import CameraRig  # noqa: E402
from transmission_renderer_tpu.utils.platform import init_compile_cache  # noqa: E402


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_rig():
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    return rig


def default_lights():
    return pack_lights(
        [
            point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
            point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0),
        ]
    )


def bench_scene(name, builder, config, n_frames=10,
                report_sensitivity=False, pass_timing=False, lights=None):
    """Compile + warm up + time n_frames with per-frame camera updates."""
    scene, dl, flags = builder.finish_bundle()
    bvh = builder.build_rt_bvh() if config.ray_traced_shadows else None
    rig = make_rig()
    if lights is None:
        lights = default_lights()
    params = make_frame_params(
        config, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir()
    )

    def checksum_render(scene, dl, params, lights, bvh):
        return jnp.sum(
            render_frame(scene, dl, params, lights, config=config,
                         flags=flags, bvh=bvh)
        )

    render = jax.jit(checksum_render)

    cache_dir = init_compile_cache()
    n_before = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    t0 = time.perf_counter()
    render(scene, dl, params, lights, bvh).block_until_ready()
    compile_s = time.perf_counter() - t0
    # a cold compile WRITES new cache entries; a warm start adds none
    n_after = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    cache_note = (
        f"cache MISS (+{n_after - n_before} entries)"
        if n_after > n_before
        else f"cache HIT ({n_after} entries)"
    )

    def run(n):
        """(min, mean) seconds per frame over n frames, each at a new
        camera yaw and timed to ``block_until_ready``."""
        times = []
        for i in range(n):
            rig.target_yaw = 0.02 * i
            rig.update()
            p = make_frame_params(
                config, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir()
            )
            t0 = time.perf_counter()
            render(scene, dl, p, lights, bvh).block_until_ready()
            times.append(time.perf_counter() - t0)
        return min(times), sum(times) / len(times)

    dt, dt_mean = run(n_frames)
    dt = max(dt, 1e-6)
    fps = 1.0 / dt
    log(f"  {name}: {dt*1e3:.1f} ms/frame min ({fps:.2f} fps; mean "
        f"{dt_mean*1e3:.1f} ms), first-call {compile_s:.1f}s "
        f"({cache_note}), {dl.tri_vtx.shape[0]} tris")

    if pass_timing:
        # in-frame per-pass device timing (the Tracy-collect analogue,
        # reference src/profiling.rs:101-131): trace ONE fused frame and
        # aggregate device kernel time by pass_scope
        try:
            from tools.pass_timing import format_table, profile_pass_times

            hlo = (
                render.lower(scene, dl, params, lights, bvh)
                .compile()
                .as_text()
            )
            table = profile_pass_times(
                lambda: render(scene, dl, params, lights, bvh).block_until_ready(),
                hlo_text=hlo,
            )
            log(f"  {name} per-pass device ms (one traced frame):")
            log(format_table(table))
        except Exception as e:  # profiling must never sink the bench
            log(f"  pass timing unavailable: {type(e).__name__}: {e}")
    if report_sensitivity:
        # frame-count sensitivity: a pipelined/async dispatch path would
        # show strong n-dependence; honest sync timing should not.
        for n in (3, 20):
            d, _ = run(n)
            d = max(d, 1e-6)
            log(f"    sensitivity n={n}: {d*1e3:.1f} ms/frame ({1.0/d:.2f} fps)")
    if flags.has_alpha_clip or config.opaque_block_cap_frac is not None:
        # exactness guards for the statically-capped paths: the headline
        # fps must not silently carry unresolved clip pixels (VERDICT r3
        # #6) or unshaded blocks dropped by a sparse-worklist overflow
        try:
            rd = jax.jit(functools.partial(
                render_frame, config=config, flags=flags, bvh=bvh,
                return_diagnostics=True,
            ))
            # guard BOTH ends of the timed sweep: the fps frames render
            # at yaws up to 0.02*(n-1), and a cap overflow at a swept
            # angle would silently drop work inside the timed frames
            # (advisor r4) — check the initial camera AND the extreme
            rig.target_yaw = 0.02 * (n_frames - 1)
            rig.update()
            p_ext = make_frame_params(
                config, rig.camera.view_matrix(), rig.camera.position,
                rig.sun_dir(),
            )
            worst = None
            for p_chk in (params, p_ext):
                _, diag = rd(scene, dl, p_chk, lights)
                if worst is None or bool(diag.overflowed()):
                    worst = diag
            diag = worst
            log(
                f"    caps (init+extreme yaw): "
                f"overflowed={bool(diag.overflowed())} "
                f"opaque_blocks={int(diag.opaque_blocks)} "
                f"pairs={int(diag.pair_demand)}/{diag.pair_capacity}"
            )
            if flags.has_alpha_clip:
                log(
                    f"    clip: unresolved={int(diag.clip_unresolved)} "
                    f"round_demand={[int(d) for d in diag.clip_round_demand]} "
                    f"caps={[int(c) for c in diag.clip_round_caps]}"
                )
        except Exception as e:  # diagnostics must never sink the bench
            log(f"    diagnostics unavailable: {type(e).__name__}: {e}")
    return fps


def main():
    init_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"FATAL: no GPU (platform {dev.platform!r})")
        sys.exit(2)
    log(f"platform={dev.platform} device_kind={dev.device_kind} "
        f"count={len(jax.devices())}")

    config = RenderConfig(width=1920, height=1080)
    config_rt = RenderConfig(width=1920, height=1080, ray_traced_shadows=True)

    # Static per-scene opaque shade worklist caps — the reference sizes
    # its buffers per scene at startup (DrawBuffer sizing,
    # src/main.rs:2423-2476); the analogue here is a static block-sparse
    # worklist cap (render/sparse.py) sized from measured coverage
    # (tools/coverage_probe.py: helmet 0.51, stress 0.66, bindless 0.67)
    # plus headroom for the bench camera sweep. The dragon scenes carry a
    # full-frame ground plane (coverage 1.0) and stay dense. Exactness is
    # guarded: bench logs FrameDiagnostics.overflowed() for capped scenes.
    cfg_helmet = dataclasses.replace(config, opaque_block_cap_frac=0.625)
    cfg_stress = dataclasses.replace(config, opaque_block_cap_frac=0.8125)

    scenes = [
        ("helmet_opaque", build_opaque_scene(), cfg_helmet,
         {"pass_timing": True}),
        ("transmission_smooth",
         build_dragon_scene(roughness_override=0.0), config, {}),
        ("attenuation", build_attenuation_scene(), config, {}),
        # Sponza-analogue stress: instancing + alpha-clip depth peeling +
        # mixed buckets (VERDICT r2 #4: the clip path must be IN the bench)
        ("stress", build_stress_scene(), cfg_stress, {"pass_timing": True}),
        # bindless-texture scale (VERDICT r3 missing #3): 72 mixed-size
        # images, 82 materials, 48 lights — the atlas registry + cluster
        # assignment at Sponza-like scale (MAX_IMAGES=193, src/main.rs:59)
        ("bindless_many_lights",
         build_bindless_scene(),
         dataclasses.replace(config, opaque_block_cap_frac=0.8125),
         {"lights": pack_lights(bindless_lights()), "pass_timing": True}),
        ("dragon_attenuation",
         build_dragon_scene(roughness_override=0.25), config,
         {"report_sensitivity": True, "pass_timing": True}),
        # RT last and single-frame: the traversal is the slowest pass,
        # and a failure here must not poison the other measurements (the
        # headline line is emitted either way)
        ("dragon_rt_shadows",
         build_dragon_scene(roughness_override=0.25), config_rt,
         {"n_frames": 1, "pass_timing": True}),
        # the opt-in quality flag's speed, reported alongside exact
        # (docs/FIDELITY.md lists its error bound)
        ("dragon_rt_halfres",
         build_dragon_scene(roughness_override=0.25),
         dataclasses.replace(config_rt, half_res_shadow_rays=True),
         {"n_frames": 1}),
    ]

    # optional argv filter (focused measurement sessions / perf A-Bs):
    # `python bench.py dragon_attenuation` runs just that scene. The
    # driver invokes bench.py with no args and gets the full list.
    if len(sys.argv) > 1:
        wanted = set(sys.argv[1:])
        unknown = wanted - {s[0] for s in scenes}
        if unknown:
            log(f"unknown scene filter(s): {sorted(unknown)}")
        scenes = [s for s in scenes if s[0] in wanted]

    results = {}
    for name, builder, cfg, kw in scenes:
        try:
            fps = bench_scene(name, builder, cfg, **kw)
        except Exception as e:  # a broken scene must not hide the others
            log(f"  {name}: FAILED — {type(e).__name__}: {e}")
            fps = 0.0
        results[name] = round(fps, 3)
        log(json.dumps(
            {
                "metric": f"{name}_1080p_fps_per_chip",
                "value": round(fps, 3),
                "unit": "fps",
                "vs_baseline": round(fps / 30.0, 4),
            }
        ))

    # the driver's contract: exactly ONE JSON line on stdout. Under a
    # manual argv filter that excludes the flagship, label the line by
    # the scene actually measured (never mislabel another scene's fps
    # as the dragon metric).
    if "dragon_attenuation" in results:
        headline, flagship = "dragon_attenuation", results["dragon_attenuation"]
    elif results:
        headline, flagship = next(iter(results.items()))
    else:
        headline, flagship = "dragon_attenuation", 0.0
    print(
        json.dumps(
            {
                "metric": f"{headline}_1080p_fps_per_chip",
                "value": flagship,
                "unit": "fps",
                "vs_baseline": round(flagship / 30.0, 4),
                "device_kind": dev.device_kind,
                "scenes": results,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()

"""CLI — mirrors the reference's ``Opt`` (src/main.rs:65-91) plus
headless-renderer extensions (there is no window system on a headless
accelerator host; the interactive loop renders an animated camera path to PNGs instead of a
swapchain).

Usage examples (mirroring readme.md):
    python -m transmission_renderer_tpu.cli DragonAttenuation --roughness-override 0.25
    python -m transmission_renderer_tpu.cli --procedural dragon -o /tmp/out.png
    python -m transmission_renderer_tpu.cli --procedural attenuation --frames 10
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="transmission-renderer-tpu",
        description="Forward-plus glTF PBR renderer for NVIDIA GPUs "
        "(KHR_materials_transmission / KHR_materials_volume).",
    )
    # reference flags (src/main.rs:65-91)
    p.add_argument(
        "gltf_sample_model_name",
        nargs="?",
        default=None,
        help="Name of the model inside the glTF-Sample-Models directory",
    )
    p.add_argument("--scale", "-s", type=float, default=1.0,
                   help="Scale factor applied to the model")
    p.add_argument("--roughness-override", type=float, default=None,
                   help="Override the model's roughness factor")
    p.add_argument("--external-model", action="store_true",
                   help="Treat the positional arg as a full glTF/GLB path")
    p.add_argument("--ray-tracing", action="store_true",
                   help="Enable ray-traced shadows (BVH path)")
    p.add_argument("--spotlights", action="store_true",
                   help="Add the two animated test spotlights")
    p.add_argument("--rotate-model", action="store_true",
                   help="Rotate the last instance each frame")
    p.add_argument("--log-leaks", action="store_true",
                   help="Accepted for parity; JAX buffers are GC-managed")
    # extensions beyond the reference's options
    p.add_argument("--procedural",
                   choices=["test", "helmet", "dragon", "attenuation",
                            "stress", "bindless"],
                   default=None, help="Render a built-in procedural scene")
    p.add_argument("--detail", type=float, default=1.0,
                   help="Geometry detail multiplier for procedural scenes "
                   "(1.0 = benchmark detail; use ~0.2 for quick CPU runs)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=1,
                   help="Number of frames along the orbit camera path")
    p.add_argument("--output", "-o", default="frame.png",
                   help="Output PNG (multi-frame: suffixed _NNN)")
    p.add_argument("--no-sponza", action="store_true",
                   help="Skip the Sponza base scene the reference always loads")
    p.add_argument("--cluster-wireframe", type=int, nargs="?", const=5,
                   default=None, metavar="SLICE",
                   help="Overlay cluster AABB wireframes (the reference's "
                   "cluster_debugging line-list pipeline, "
                   "shader/src/lib.rs:801-839). Optional depth-slice index "
                   "(default 5); -1 draws all 16 slices (dense!)")
    p.add_argument("--debug-clusters", action="store_true",
                   help="Cluster false-colour debug view (the F-key toggle)")
    p.add_argument("--as-debug", action="store_true",
                   help="Render the ray-cast acceleration-structure debug "
                   "view (the T-key toggle; implies --ray-tracing)")
    p.add_argument("--cam-pos", type=float, nargs=3, default=[0.0, 2.2, 1.5],
                   metavar=("X", "Y", "Z"), help="Camera position")
    p.add_argument("--cam-pitch", type=float, default=-0.25,
                   help="Camera pitch (radians)")
    p.add_argument("--cam-yaw", type=float, default=0.0,
                   help="Camera yaw (radians)")
    p.add_argument("--sun-pitch", type=float, default=1.1,
                   help="Sun pitch (reference default 1.1, src/main.rs:531)")
    p.add_argument("--sun-yaw", type=float, default=4.8,
                   help="Sun yaw (reference default 4.8)")
    p.add_argument("--devices", type=int, default=1,
                   help="Shard the framebuffer over N devices (row bands)")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU backend (same as JAX_PLATFORMS=cpu)")
    p.add_argument("--interactive", action="store_true",
                   help="Headless interactive loop: read WASD/QE (move), "
                   "IJKL (look), arrows (sun, reference src/main.rs:1198), "
                   "<enter> renders a frame, 'x' quits")
    p.add_argument("--half-res-refraction", action="store_true",
                   help="Half-res framebuffer fetch in the transmission "
                   "pass (~2.5x cheaper; near-lossless at LOD >= 1)")
    p.add_argument("--quad-taps", action="store_true",
                   help="Share one material-texture tap per 2x2 pixel "
                   "quad in the opaque pass (quarters its gather cost; "
                   "sub-texel error away from material silhouettes)")
    p.add_argument("--nol-shadow-gate", action="store_true",
                   help="skip shadow rays where N.L <= 0 (near-lossless, "
                        "max delta ~1e-3; normal-map-free scenes only)")
    p.add_argument("--bf16-lights", action="store_true",
                   help="Evaluate the per-light BRDF/BTDF cores in "
                   "bfloat16 (f32 accumulation). Spends the RMSE budget "
                   "(bound pinned in tests/test_goldens.py) for light-loop "
                   "arithmetic throughput")
    p.add_argument("--half-res-shadows", action="store_true",
                   help="Trace --ray-tracing shadow rays on a half-res "
                   "grid and upsample the visibility factors (4x fewer "
                   "rays; 1-px soft shadow edges)")
    p.add_argument("--check-nan", action="store_true",
                   help="Validate each frame: NaN/Inf scan + capacity-"
                   "overflow diagnostics (bins, big-triangle list, block "
                   "worklists, clip peeling) — the debug-mode stand-in "
                   "for the reference's always-on validation layer")
    p.add_argument("--debug-checks", action="store_true",
                   help="Instrument the frame with jax.experimental.checkify "
                   "out-of-bounds index checks (the analogue of the "
                   "Vulkan validation layer's GPU-assisted validation; "
                   "SURVEY 5.2). Slow; forces the XLA raster path, whose "
                   "gathers checkify can instrument")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="Capture a jax.profiler trace of the frame loop "
                   "into DIR (view in Perfetto/TensorBoard; per-pass "
                   "named_scope zones mirror the reference's Tracy zones)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # Import late so --help is instant.
    import jax
    import jax.numpy as jnp
    from functools import partial

    from transmission_renderer_tpu.utils.platform import init_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    init_compile_cache()

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
    from transmission_renderer_tpu.pbr.lights import pack_lights, point_light, spot_light
    from transmission_renderer_tpu.render import make_frame_params, render_frame
    from transmission_renderer_tpu.scene.camera import CameraRig
    from transmission_renderer_tpu.scene.textures import linear_to_srgb
    from transmission_renderer_tpu.utils import save_png

    config = RenderConfig(
        width=args.width,
        height=args.height,
        ray_traced_shadows=args.ray_tracing or args.as_debug,
        spotlights=args.spotlights,
        rotate_model=args.rotate_model,
        debug_clusters=args.debug_clusters,
        half_res_refraction=args.half_res_refraction,
        quad_material_taps=args.quad_taps,
        half_res_shadow_rays=args.half_res_shadows,
        nol_shadow_gate=args.nol_shadow_gate,
        bf16_light_math=args.bf16_lights,
        # checkify cannot see inside a Pallas kernel; the XLA raster is
        # matched to the kernel by tests/test_raster_kernel.py, so
        # instrumenting it validates the same frame logic.
        use_pallas_raster=False if args.debug_checks else None,
    )

    # ---- scene -------------------------------------------------------------
    if args.procedural:
        d = args.detail
        builder = {
            "test": build_test_scene,
            "helmet": lambda: build_opaque_scene(
                stacks=max(int(64 * d), 8), sectors=max(int(128 * d), 16)
            ),
            "dragon": lambda: build_dragon_scene(
                stacks=max(int(180 * d), 8),
                sectors=max(int(360 * d), 16),
                roughness_override=args.roughness_override,
            ),
            "attenuation": build_attenuation_scene,
            "stress": lambda: build_stress_scene(grid=max(int(5 * d), 2)),
            # bindless-texture/many-lights stress (72 images, 82
            # materials, 48 lights — MAX_IMAGES=193 scale, src/main.rs:59)
            "bindless": build_bindless_scene,
        }[args.procedural]()
    elif args.gltf_sample_model_name:
        from transmission_renderer_tpu.scene.gltf import load_gltf, path_for_gltf_model

        builder = None
        path = (
            args.gltf_sample_model_name
            if args.external_model
            else path_for_gltf_model(args.gltf_sample_model_name)
        )
        from transmission_renderer_tpu.scene.builder import SceneBuilder

        builder = SceneBuilder()
        if not args.no_sponza:
            # the reference always loads Sponza first (src/main.rs:342-351)
            try:
                load_gltf(path_for_gltf_model("Sponza"), builder)
            except FileNotFoundError:
                print("note: Sponza not found, skipping base scene", file=sys.stderr)
        try:
            load_gltf(
                path, builder,
                base_scale=args.scale,
                roughness_override=args.roughness_override,
            )
        except FileNotFoundError as e:
            print(f"error: model not found: {e.filename}", file=sys.stderr)
            return 2
    else:
        print("error: give a model name or --procedural <scene>", file=sys.stderr)
        return 2

    scene, dl, flags = builder.finish_bundle()
    print(
        f"scene: {scene.num_triangles} tris, {scene.num_instances} instances, "
        f"{scene.materials.num} materials; flags={flags}"
    )

    # ---- lights (src/main.rs:450-472) ---------------------------------------
    if args.procedural == "bindless":
        # the bindless scene ships its own 48-light rig (the 128-lights-
        # per-cluster scale probe, shared-structs/src/lib.rs:322)
        light_list = bindless_lights()
    else:
        light_list = [
            point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
            point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0),
        ]
    if args.spotlights:
        light_list += [
            spot_light([0.0, 4.0, 0.0], [1.0, 1.0, 0.5], 50.0, [0.0, 0.0, 1.0], 0.7, 0.8),
            spot_light([0.0, 4.0, 0.0], [1.0, 1.0, 0.5], 50.0, [0.0, 0.0, -1.0], 0.7, 0.8),
        ]
    lights = pack_lights(light_list)

    rig = CameraRig()
    rig.target_position = np.array(args.cam_pos, np.float32)
    rig.target_pitch = args.cam_pitch
    rig.target_yaw = args.cam_yaw
    rig.camera.position = rig.target_position.copy()
    rig.camera.pitch = rig.target_pitch
    rig.camera.yaw = rig.target_yaw
    rig.sun_pitch = args.sun_pitch
    rig.sun_yaw = args.sun_yaw

    bvh = None
    if config.ray_traced_shadows:
        print("building BVH...", file=sys.stderr)
        bvh = builder.build_rt_bvh()

    if args.as_debug:
        from transmission_renderer_tpu.render.raytrace import render_as_debug_frame

        render = jax.jit(
            partial(render_as_debug_frame, config=config, bvh=bvh)
        )
    elif args.devices > 1:
        from transmission_renderer_tpu.parallel import (
            make_band_mesh,
            render_frame_sharded,
        )

        if args.ray_tracing:
            print("error: --ray-tracing is unsupported on the sharded "
                  "path (--devices > 1); drop one of the flags",
                  file=sys.stderr)
            return 2
        if len(jax.devices()) < args.devices:
            print(
                f"error: --devices {args.devices} but only "
                f"{len(jax.devices())} available",
                file=sys.stderr,
            )
            return 2
        mesh = make_band_mesh(args.devices)
        render = jax.jit(
            partial(render_frame_sharded, config=config, mesh=mesh, flags=flags)
        )
    elif args.check_nan:
        # validation mode also fetches FrameDiagnostics and warns on any
        # capacity overflow (the analogue of the reference's always-on
        # validation layer flagging an undersized indirect buffer)
        _rd = jax.jit(
            partial(render_frame, config=config, flags=flags, bvh=bvh,
                    return_diagnostics=True)
        )

        def render(s, d, p, l):
            ldr, diag = _rd(s, d, p, l)
            host = type(diag)(*[
                int(np.asarray(v)) if hasattr(v, "shape") else v
                for v in diag
            ])
            if host.overflowed():
                print(f"VALIDATION: capacity overflow! {host}",
                      file=sys.stderr)
            return ldr
    else:
        render = jax.jit(
            partial(render_frame, config=config, flags=flags, bvh=bvh)
        )

    if args.debug_checks:
        if args.devices > 1 or args.as_debug or args.ray_tracing:
            print("error: --debug-checks supports the single-device "
                  "non-RT frame path only", file=sys.stderr)
            return 2
        from transmission_renderer_tpu.render.checks import checked_frame_fn

        render = checked_frame_fn(config=config, flags=flags)

    def check_frame(ldr):
        if args.check_nan:
            bad = int(np.isnan(ldr).sum() + np.isinf(ldr).sum())
            if bad:
                print(f"VALIDATION: {bad} non-finite pixels!", file=sys.stderr)

    if args.cluster_wireframe is not None:
        from transmission_renderer_tpu.pbr import cluster_coefficients
        from transmission_renderer_tpu.pbr.clustering import write_cluster_data
        from transmission_renderer_tpu.render.cluster_debug import (
            cluster_wireframe_overlay,
        )
        from transmission_renderer_tpu.scene.camera import (
            perspective_matrix_reversed,
        )
        from transmission_renderer_tpu.utils.platform import f32_matmuls

        _proj = jnp.asarray(perspective_matrix_reversed(
            config.width, config.height, config.vertical_fov,
            config.z_near, config.z_far,
        ))
        _coeffs = cluster_coefficients(
            config.z_near, config.z_far, config.num_depth_slices
        )

        @jax.jit
        @f32_matmuls
        def apply_overlays(ldr):
            amin, amax = write_cluster_data(
                jnp.linalg.inv(_proj), (config.width, config.height),
                (config.num_clusters_x, config.num_clusters_y), _coeffs,
            )
            if args.cluster_wireframe >= 0:
                # clusters are indexed slice * cy * cx + y * cx + x
                # (shader/src/lib.rs:527-529)
                per = config.num_clusters_x * config.num_clusters_y
                s = args.cluster_wireframe * per
                amin, amax = amin[s:s + per], amax[s:s + per]
            return cluster_wireframe_overlay(ldr, amin, amax, _proj)
    else:
        apply_overlays = lambda ldr: ldr

    profile_cm = None
    if args.profile:
        from transmission_renderer_tpu.utils.profiling import trace

        profile_cm = trace(args.profile)
        profile_cm.__enter__()

    def _end_profile():
        if profile_cm is not None:
            profile_cm.__exit__(None, None, None)
            print(f"profiler trace written to {args.profile}",
                  file=sys.stderr)

    def _frame_path(frame: int, multi: bool) -> str:
        if not multi:
            return args.output
        root, ext = os.path.splitext(args.output)
        return f"{root}_{frame:03d}{ext or '.png'}"

    if args.interactive:
        # Headless analogue of the reference's winit loop
        # (src/main.rs:923-1456): keys move the dolly rig / sun; each
        # <enter> simulates + renders a frame to --output.
        print("interactive: w/a/s/d/q/e move, i/j/k/l look, "
              "u/o/p/; sun, <enter> render, x quit", file=sys.stderr)
        frame = 0
        for line in sys.stdin:
            for ch in line.strip():
                if ch == "x":
                    _end_profile()
                    return 0
                move = {"w": (1, 0, 0), "s": (-1, 0, 0), "a": (0, -1, 0),
                        "d": (0, 1, 0), "q": (0, 0, -1), "e": (0, 0, 1)}
                look = {"i": (0, 0.1), "k": (0, -0.1), "j": (0.1, 0),
                        "l": (-0.1, 0)}
                if ch in move:
                    rig.move_relative(*move[ch], speed=0.5)
                elif ch in look:
                    rig.rotate(*look[ch])
                elif ch in "uop;":
                    rig.update_sun(ch == "u", ch == ";", ch == "o", ch == "p",
                                   1 / 60)
            rig.update()
            params = make_frame_params(
                config, rig.camera.view_matrix(), rig.camera.position,
                rig.sun_dir(),
            )
            t0 = time.time()
            ldr = np.asarray(apply_overlays(render(scene, dl, params, lights)))
            check_frame(ldr)
            out = _frame_path(frame, True)
            save_png(out, linear_to_srgb(ldr))
            print(f"frame {frame}: {(time.time()-t0)*1000:.1f} ms -> {out}",
                  file=sys.stderr)
            frame += 1
        _end_profile()
        return 0

    for frame in range(args.frames):
        rig.update()
        if args.spotlights and frame > 0:
            # rotate the two spots (src/main.rs:1243-1256)
            angle = 0.5 / 60.0 * frame
            base = np.asarray(lights.spot_direction)
            new_dirs = base.copy()
            for k, phase in ((len(light_list) - 2, 0.0), (len(light_list) - 1, np.pi)):
                a = angle + phase
                new_dirs[k] = [np.sin(a), 0.0, np.cos(a)]
            lights = lights._replace(spot_direction=jnp.asarray(new_dirs))
        if args.rotate_model and frame > 0:
            # rotate the last instance (src/main.rs:1258-1283)
            from transmission_renderer_tpu.scene.types import (
                quat_from_rotation_y,
                quat_mul,
            )

            delta = jnp.asarray(quat_from_rotation_y(1.0 / 60.0))
            rot = scene.inst_transform.rotation
            rot = rot.at[-1].set(quat_mul(delta, rot[-1]))
            scene = scene._replace(
                inst_transform=scene.inst_transform._replace(rotation=rot)
            )
        params = make_frame_params(
            config, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir()
        )
        t0 = time.time()
        ldr = np.asarray(apply_overlays(render(scene, dl, params, lights)))
        check_frame(ldr)
        dt = time.time() - t0
        out = _frame_path(frame, args.frames > 1)
        save_png(out, linear_to_srgb(ldr))
        print(f"frame {frame}: {dt*1000:.1f} ms -> {out}")
        # simple orbit for multi-frame renders
        rig.target_yaw += 0.1

    _end_profile()

    return 0


if __name__ == "__main__":
    sys.exit(main())

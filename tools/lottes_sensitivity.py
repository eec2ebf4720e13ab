"""Quantify the open Lottes-constant uncertainty (VERDICT r2 #9 /
FIDELITY.md §2).

The reference bakes colstodian's `LottesTonemapperParams::Default`
(src/main.rs:506-510); this repo's values are a constraint-fit guess
(pbr/tonemap.py). This script bounds the golden shift a plausible
mismatch could cause: render the dragon golden's HDR frame once on CPU,
re-tonemap it under a sweep of plausible parameter deviations, and
report the max per-image RMSE (in sRGB-encoded space, the goldens'
metric) per parameter and for the worst corner.

Run: python tools/lottes_sensitivity.py
"""

import itertools
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import jax  # noqa: E402
from functools import partial  # noqa: E402


def main():
    from transmission_renderer_tpu.utils.platform import init_compile_cache

    init_compile_cache()
    from golden_defs import CFG, GOLDENS, _lights, _rig
    from transmission_renderer_tpu.pbr.tonemap import (
        LottesParams,
        bake_lottes_params,
        lottes_tonemap,
    )
    from transmission_renderer_tpu.render import make_frame_params, render_frame
    from transmission_renderer_tpu.scene.textures import linear_to_srgb

    builder_fn, cam, pitch = GOLDENS["dragon"]
    scene, dl, flags = builder_fn().finish_bundle()
    rig = _rig(cam, pitch)
    params = make_frame_params(
        CFG, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir()
    )
    _, hdr = jax.jit(
        partial(render_frame, config=CFG, flags=flags, return_hdr=True)
    )(scene, dl, params, _lights())
    hdr = np.asarray(hdr)

    base = np.asarray(lottes_tonemap(hdr, bake_lottes_params()))
    base_srgb = linear_to_srgb(base)

    def rmse(p: LottesParams) -> float:
        img = np.asarray(lottes_tonemap(hdr, bake_lottes_params(p)))
        return float(np.sqrt(np.mean((linear_to_srgb(img) - base_srgb) ** 2)))

    # plausible deviation ranges around the assumed colstodian Default
    sweeps = {
        "contrast": (1.25, 1.45),
        "shoulder": (0.97, 1.0),
        "max_luminance": (16.0, 32.0),
        "grey_point_in": (0.15, 0.20),
        "crosstalk": (8.0, 12.0),
        "cross_saturation": (1.25, 1.40),
    }
    print("per-parameter worst RMSE (sRGB) on the dragon golden frame:")
    worst_each = {}
    for name, (lo, hi) in sweeps.items():
        vals = np.linspace(lo, hi, 5)
        worst = max(rmse(LottesParams(**{name: float(v)})) for v in vals)
        worst_each[name] = worst
        print(f"  {name:<18} +-range {lo}..{hi}: max RMSE {worst:.4f}")

    # worst corner over the 3 most sensitive parameters (full product is
    # 5^6; corners of the top-3 capture the bound)
    top3 = sorted(worst_each, key=worst_each.get)[-3:]
    corner_worst = 0.0
    for corner in itertools.product(*[sweeps[n] for n in top3]):
        p = LottesParams(**dict(zip(top3, map(float, corner))))
        corner_worst = max(corner_worst, rmse(p))
    print(f"worst corner over {top3}: RMSE {corner_worst:.4f}")
    print(
        "(goldens' change threshold is 4e-3; per-pixel fidelity target is "
        "RMSE < 1e-3 — a true Default mismatch would exceed both, i.e. it "
        "would be caught, and conversely passing self-goldens cannot "
        "validate the constants.)"
    )


if __name__ == "__main__":
    main()

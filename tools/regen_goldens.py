"""Regenerate the CPU golden frames in tests/goldens/.

Run intentionally after a change that is SUPPOSED to shift the image:

    python tools/regen_goldens.py [name ...]

With no arguments every golden is rewritten; names restrict the set
(e.g. ``python tools/regen_goldens.py dragon as_debug``). Review the
diff visually before committing.
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from golden_defs import (  # noqa: E402
    GOLDEN_DIR,
    GOLDENS,
    render_as_debug_golden,
    render_golden,
    render_hd_golden,
)
from transmission_renderer_tpu.utils import save_png  # noqa: E402


def main():
    from transmission_renderer_tpu.utils.platform import init_compile_cache

    init_compile_cache()
    names = sys.argv[1:] or (sorted(GOLDENS) + ["as_debug", "dragon_hd"])
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in names:
        if name == "as_debug":
            img = render_as_debug_golden()
        elif name == "dragon_hd":
            img = render_hd_golden()  # ~30 s CPU (full 1920x1080 frame)
        else:
            img = render_golden(name)
        path = os.path.join(GOLDEN_DIR, f"{name}.png")
        save_png(path, (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8))
        print(f"wrote {path}")


if __name__ == "__main__":
    main()

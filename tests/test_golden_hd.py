"""Full-resolution flagship golden.

One 1920x1080 render of the bench dragon_attenuation frame against a
stored golden. Small goldens (128x72, tests/test_goldens.py) pin
sampler/shading semantics but run with miniature frames and cap floors;
this one exercises the 128-px block worklists and the static pyramid
level set at their real sizes (chip_smoke.py renders the same golden on
the GPU through the raster kernel, with its sparse-raster tile caps and
binning tier ladder). ~30 s on CPU, kept in its own module so
`-k "not hd"` can skip it in quick loops.

Regenerate intentionally with: python tools/regen_goldens.py dragon_hd
"""

import os

import numpy as np

from golden_defs import GOLDEN_DIR, render_hd_golden
from transmission_renderer_tpu.utils import load_png


def test_golden_dragon_hd():
    golden = (
        load_png(os.path.join(GOLDEN_DIR, "dragon_hd.png"))[..., :3] / 255.0
    )
    got = render_hd_golden()
    rmse = float(np.sqrt(np.mean((got - golden) ** 2)))
    assert rmse < 4e-3, f"dragon_hd: RMSE {rmse} vs golden"

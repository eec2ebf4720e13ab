"""Multi-device (virtual 8-device CPU mesh) tests.

The comparisons run in a subprocess because XLA's virtual CPU device
count is fixed when the backend starts (see conftest.py).
sharding_driver.py does the actual work: the sharded row-band frame must
match the single-device frame bit-for-bit (within f32 reassociation
noise).
"""

import os
import subprocess
import sys

import jax
import pytest


def test_sharded_matches_single_chip():
    n = 8
    if len(jax.devices()) >= n:
        # environment already has enough devices — run in-process
        rc = _run_inproc(n)
        assert rc == 0
        return
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}"
        ).strip()
    driver = os.path.join(os.path.dirname(__file__), "sharding_driver.py")
    result = subprocess.run(
        [sys.executable, driver, str(n)],
        env=env,
        capture_output=True,
        text=True,
        timeout=1800,
    )
    print(result.stdout)
    assert result.returncode == 0, (
        f"sharding driver failed (rc={result.returncode}):\n"
        f"{result.stdout}\n{result.stderr[-4000:]}"
    )


def _run_inproc(n):
    from tests.sharding_driver import main

    return main(n)


def test_band_pyramid_spec_layout_consistency():
    """_BandPyramidSpec's static quad-table offsets must match the rows
    the build chain actually stores, for every level — including deep
    levels of WIDE frames where the padded gathered height underflows
    while the downsample chain sticks at 1 row, and odd band_h where a
    per-band floor-halve would diverge from the global pyramid (must
    replicate from level 0 instead: l_local == 0)."""
    from transmission_renderer_tpu.ops.mipchain import _grouped_rows
    from transmission_renderer_tpu.parallel.sharded import _BandPyramidSpec

    def check(width, height, band_h, n_bands, halo):
        spec = _BandPyramidSpec(width, height, band_h, n_bands, halo)
        # l_local levels must halve the band height exactly, and the
        # FIRST replicated level is per-band downsampled before its
        # all_gather — so 2^l_local must divide band_h
        assert band_h % (1 << spec.l_local) == 0
        # simulate the stored pool: local levels quad-build their haloed
        # slice, replicated levels their true-height image; each level's
        # quad table is independently GROUP-padded (_quad_level)
        off = 0
        g = (band_h >> spec.l_local) * n_bands
        for l in range(spec.num_levels):
            assert spec.quad_offsets[l] == off, (l, width, height, band_h)
            if l < spec.l_local:
                rows = spec.band_rows[l] + 2 * spec.halos[l]
            else:
                rows = spec.heights[l]
                # the gathered padded height must COVER the true height
                # (the build slices [: heights[l]] before the quad pack)
                assert max(g >> (l - spec.l_local), 1) >= rows or rows == 1
            assert rows == spec.slice_rows[l]
            bw = (spec.widths[l] + 1) // 2
            bh = (rows + 1) // 2
            off += _grouped_rows(4 * bw * bh)
        assert spec.total_qrows == off

    check(1920, 1080, 136, 8, 64)   # production shape
    check(1920, 400, 52, 8, 16)     # wide: deep levels outlive the height
    check(1920, 1080, 135, 8, 64)   # ODD band height -> l_local == 0
    check(320, 180, 24, 8, 8)       # small CI shape
    check(256, 1024, 128, 8, 32)    # tall
    spec_odd = _BandPyramidSpec(1920, 1080, 135, 8, 64)
    assert spec_odd.l_local == 0

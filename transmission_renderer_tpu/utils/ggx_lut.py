"""Split-sum GGX environment-BRDF LUT.

The reference ships a pre-baked 1024x1024 ``ggx_lut.png`` (uploaded at
src/main.rs:295-330) and samples it with (NoV, perceptual_roughness) UVs
through a clamp sampler (shader/src/lib.rs:126-133); the two channels are
the split-sum F0 scale and bias used by ``ibl_volume_refraction``
(glam-pbr/src/lib.rs:345-351).

``default_ggx_lut`` loads the reference's own ggx_lut.png when a path to
it is available (TRTPU_GGX_LUT env var or the --ggx-lut CLI flag) — exact
parity, decoded UNORM like the reference's R8G8B8A8_UNORM upload — and
otherwise bakes the LUT with the standard Karis split-sum integration
(GGX importance sampling over the hemisphere with Smith height-correlated
visibility, Hammersley sequence). ``tools/ggx_lut_compare.py`` quantifies
the bake-vs-reference delta.
"""

from __future__ import annotations

import functools
import os

import numpy as np


def _hammersley(n: int) -> np.ndarray:
    """[n, 2] low-discrepancy points (van der Corput base 2 in y)."""
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    y = bits.astype(np.float64) * 2.3283064365386963e-10
    x = i.astype(np.float64) / n
    return np.stack([x, y], -1)


@functools.lru_cache(maxsize=4)
def compute_ggx_lut(size: int = 128, num_samples: int = 512) -> np.ndarray:
    """[size, size, 2] float32; axis 0 = perceptual roughness (v), axis 1 =
    NoV (u), matching the shader's uv = (NoV, roughness) convention with
    the usual image row = v indexing."""
    xi = _hammersley(num_samples)  # [S, 2]

    nov = (np.arange(size, dtype=np.float64) + 0.5) / size  # u axis
    rough = (np.arange(size, dtype=np.float64) + 0.5) / size  # v axis

    nov_g, rough_g = np.meshgrid(nov, rough)  # [size(v), size(u)]
    # perceptual roughness r -> actual roughness a = r^2 (GGX alpha)
    a = rough_g**2

    # view vector in tangent space (x-z plane)
    vx = np.sqrt(1.0 - nov_g**2)
    vz = nov_g

    scale = np.zeros_like(nov_g)
    bias = np.zeros_like(nov_g)

    for s in range(num_samples):
        u1, u2 = xi[s]
        # GGX importance sample (half vector)
        phi = 2.0 * np.pi * u1
        cos_theta = np.sqrt((1.0 - u2) / (1.0 + (a**2 - 1.0) * u2))
        sin_theta = np.sqrt(np.maximum(1.0 - cos_theta**2, 0.0))
        hx = sin_theta * np.cos(phi)
        hy = sin_theta * np.sin(phi)
        hz = cos_theta
        # reflect v about h: l = 2(v.h)h - v
        v_dot_h = vx * hx + vz * hz
        lx = 2 * v_dot_h * hx - vx
        ly = 2 * v_dot_h * hy
        lz = 2 * v_dot_h * hz - vz

        nol = np.maximum(lz, 0.0)
        noh = np.maximum(hz, 0.0)
        voh = np.maximum(v_dot_h, 0.0)
        visible = nol > 0

        # Smith height-correlated visibility (matches
        # v_smith_ggx_correlated, glam-pbr/src/lib.rs:114-133)
        a2 = (a**2)
        ggx_v = nol * np.sqrt(nov_g**2 * (1 - a2) + a2)
        ggx_l = nov_g * np.sqrt(nol**2 * (1 - a2) + a2)
        vis = np.where(ggx_v + ggx_l > 0, 0.5 / np.maximum(ggx_v + ggx_l, 1e-12), 0.0)

        # pdf-weighted contribution: V * 4 * VoH * NoL / NoH
        weight = np.where(visible & (noh > 0), vis * 4.0 * voh * nol / np.maximum(noh, 1e-12), 0.0)
        fc = (1.0 - voh) ** 5
        scale += (1.0 - fc) * weight
        bias += fc * weight

    scale /= num_samples
    bias /= num_samples
    return np.stack([scale, bias], -1).astype(np.float32)


def load_ggx_lut_png(path: str) -> np.ndarray:
    """Load a ggx_lut.png (the reference asset, src/main.rs:295-330) as
    [S, S, 2] float32, rows exactly as uploaded (row 0 = v 0). The
    reference uploads it R8G8B8A8_UNORM (linear, NOT sRGB) and the shader
    reads .xy, so decode is just /255."""
    from transmission_renderer_tpu.utils.image_io import load_png

    return (load_png(path)[..., :2].astype(np.float32)) / 255.0


def _box_downsample(lut: np.ndarray, size: int) -> np.ndarray:
    """Integer-factor box average of an [S, S, 2] LUT down to [size, size,
    2]. The split-sum table is smooth, so the bilinear-sampled error of a
    256^2 box reduction of the 1024^2 asset is ~1e-4 — below the asset's
    own 8-bit quantisation step (1/255), and the smaller table keeps the
    per-pixel LUT fetch in cache."""
    s = lut.shape[0]
    if size >= s:
        return lut
    f = s // size
    assert size * f == s, "LUT size must divide the source size"
    return lut.reshape(size, f, size, f, lut.shape[-1]).mean(axis=(1, 3)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def default_ggx_lut(size: int | None = 256) -> np.ndarray:
    """The LUT the renderer uses: the reference PNG named by TRTPU_GGX_LUT
    when set (exact parity with the reference's split-sum term), else a
    self-bake matched to the asset's conventions. ``size`` (None = native) box-reduces the
    table for fetch speed — see _box_downsample.

    QUIRK (preserved for parity): the reference's ggx_lut.png stores the
    split-sum table with the roughness axis INVERTED relative to a
    textbook Karis bake (verified: flipping it vertically matches our
    bake to |d| mean 0.0016 ~= 8-bit noise), while the shader samples it
    at uv = (NoV, perceptual_roughness) with no flip
    (shader/src/lib.rs:126-133). The reference therefore renders with a
    roughness-inverted specular deweight in ibl_volume_refraction; we
    reproduce that behaviour, so the fallback bake is flipped and
    quantised to UNORM8 to match the asset."""
    path = os.environ.get("TRTPU_GGX_LUT")
    if path and os.path.exists(path):
        try:
            lut = load_ggx_lut_png(path)
            return _box_downsample(lut, size) if size else lut
        except Exception:
            pass
    lut = compute_ggx_lut()[::-1].copy()  # textbook -> asset orientation
    lut = np.round(lut * 255.0).astype(np.float32) / np.float32(255.0)
    return _box_downsample(lut, size) if size else lut

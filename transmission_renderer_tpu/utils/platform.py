"""Backend selection, matmul precision and the compile cache."""

from __future__ import annotations

import os

# the checkout's root (the directory holding the package)
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
# compile-cache directory used when JAX_COMPILATION_CACHE_DIR is unset
# (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def init_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory and
    return it. ``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing
    is set in code (JAX reads the variable itself); otherwise the cache
    lives in ``.jax_cache/`` inside the checkout, so every run of the
    program from this checkout hits the same entries."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def use_raster_kernel(config) -> bool:
    """The rasteriser of render_frame and render_frame_sharded: the Triton
    tile kernel (ops/raster_pallas_gbuf.py) or the XLA raster
    (ops/raster.py). ``config.use_pallas_raster`` None picks the kernel
    on a GPU at its native 8x128 tile and XLA elsewhere. The kernel runs
    on the CPU only in interpret mode (``config.pallas_interpret``, a
    test switch); forcing it there without that switch is an error, and
    a GPU never runs it interpreted."""
    import jax

    from transmission_renderer_tpu.ops.raster_pallas_gbuf import (
        TILE_H,
        TILE_W,
    )

    backend = jax.default_backend()
    if config.pallas_interpret and backend == "gpu":
        raise ValueError(
            "pallas_interpret is a CPU test switch; on a GPU the raster "
            "kernel runs compiled"
        )
    use = config.use_pallas_raster
    if use is None:
        use = backend == "gpu" and (config.tile_w, config.tile_h) == (
            TILE_W, TILE_H
        )
    if use and (config.tile_w, config.tile_h) != (TILE_W, TILE_H):
        raise ValueError(
            f"the raster kernel's tile is {TILE_W}x{TILE_H}; config has "
            f"{config.tile_w}x{config.tile_h}"
        )
    if use and backend != "gpu" and not config.pallas_interpret:
        raise ValueError(
            f"the raster kernel compiles only for a GPU (backend is "
            f"{backend!r}); set pallas_interpret=True to run it interpreted"
        )
    return bool(use)


def f32_matmuls(fn):
    """Run ``fn`` with full-f32 matmul precision.

    On the GPU a float32 ``dot`` at default precision may run in TF32
    (about three decimal digits). The camera/clip transforms are in the
    RMSE-critical chain (SURVEY.md §7 hard part 6) and visibly shift
    geometry at reduced precision. The frame's matmuls are all tiny
    (Nx4 @ 4x4 and the mip downsample's 0/1 pairings), so "highest" costs
    nothing measurable.
    """
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        import jax

        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper

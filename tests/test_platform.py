"""Backend choice, compile cache, PNG IO and the chip smoke's refusal to
run without a GPU."""

import dataclasses
import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from transmission_renderer_tpu.config import RenderConfig
from transmission_renderer_tpu.utils import platform
from transmission_renderer_tpu.utils.image_io import (
    decode_png,
    encode_png,
    load_png,
    save_png,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def backend(monkeypatch):
    """Set the backend use_raster_kernel sees."""
    def set_(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    return set_


def test_kernel_chosen_on_gpu(backend):
    backend("gpu")
    assert platform.use_raster_kernel(RenderConfig())


def test_xla_chosen_on_cpu(backend):
    backend("cpu")
    assert not platform.use_raster_kernel(RenderConfig())


def test_xla_chosen_on_gpu_for_other_tiles(backend):
    backend("gpu")
    assert not platform.use_raster_kernel(RenderConfig(tile_w=32, tile_h=8))


def test_forced_kernel_on_cpu_needs_interpret(backend):
    backend("cpu")
    cfg = RenderConfig(use_pallas_raster=True)
    with pytest.raises(ValueError, match="interpret"):
        platform.use_raster_kernel(cfg)
    assert platform.use_raster_kernel(
        dataclasses.replace(cfg, pallas_interpret=True)
    )


def test_interpret_refused_on_gpu(backend):
    backend("gpu")
    with pytest.raises(ValueError, match="CPU test switch"):
        platform.use_raster_kernel(RenderConfig(pallas_interpret=True))


def test_forced_kernel_needs_native_tile(backend):
    backend("gpu")
    with pytest.raises(ValueError, match="tile"):
        platform.use_raster_kernel(
            RenderConfig(use_pallas_raster=True, tile_w=32, tile_h=8)
        )


def test_forced_xla_on_gpu(backend):
    backend("gpu")
    assert not platform.use_raster_kernel(
        RenderConfig(use_pallas_raster=False)
    )


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = []
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.append((k, v))
    )
    return calls


def test_compile_cache_env_honoured(monkeypatch, config_updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.init_compile_cache() == str(tmp_path)
    assert config_updates == []  # JAX reads the variable itself


def test_compile_cache_default_in_checkout(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = platform.init_compile_cache()
    second = platform.init_compile_cache()
    assert first == second == os.path.join(ROOT, ".jax_cache")
    assert config_updates == [("jax_compilation_cache_dir", first)] * 2
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53, channels)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    save_png(path, img)
    got = load_png(path)
    assert got.shape == (37, 53, 4)
    np.testing.assert_array_equal(got[..., :channels], img)
    if channels == 3:
        assert (got[..., 3] == 255).all()


def test_png_float_input_quantised():
    img = np.linspace(0.0, 1.0, 2 * 3 * 3, dtype=np.float32).reshape(2, 3, 3)
    got = decode_png(encode_png(img))[..., :3]
    np.testing.assert_array_equal(
        got, (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    )


def test_png_io_imports_no_pil():
    code = (
        "import sys, numpy as np\n"
        "from transmission_renderer_tpu.utils import image_io as io\n"
        "a = np.zeros((4, 5, 3), np.uint8); a[1, 2] = (7, 8, 9)\n"
        "assert (io.decode_png(io.encode_png(a))[..., :3] == a).all()\n"
        "assert 'PIL' not in sys.modules, 'PIL imported'\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120,
    )
    assert r.returncode == 0, r.stderr


def test_no_tpu_pallas_imports():
    """Nothing in the program imports the TPU Pallas module."""
    pat = re.compile(r"pallas\.tpu|pallas import tpu|pltpu")
    hits = []
    for top in ("transmission_renderer_tpu", "tests", "tools"):
        for dirpath, _, files in os.walk(os.path.join(ROOT, top)):
            for f in files:
                if f.endswith(".py"):
                    path = os.path.join(dirpath, f)
                    text = open(path).read()
                    if path != os.path.abspath(__file__) and pat.search(text):
                        hits.append(path)
    for f in ("bench.py", "chip_smoke.py", "__graft_entry__.py"):
        if pat.search(open(os.path.join(ROOT, f)).read()):
            hits.append(f)
    assert hits == []


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

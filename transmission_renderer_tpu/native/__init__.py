"""Native (C++) host components, loaded via ctypes.

The reference's host runtime is native Rust; this renderer's hot host
paths (LBVH construction, world-space vertex transforms for BVH builds)
are implemented in C++ (native/bvh_native.cc) and compiled on first use
with the system compiler. Pure-NumPy fallbacks keep everything working if
no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_LIB = None
_TRIED = False


def _build_dir() -> str:
    d = os.path.join(os.path.dirname(__file__), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def load() -> ctypes.CDLL | None:
    """Compile (once) and load the native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(os.path.dirname(__file__), "bvh_native.cc")
    out = os.path.join(_build_dir(), "libtrtpu_native.so")
    try:
        if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
            cxx = os.environ.get("CXX", "g++")
            subprocess.run(
                [cxx, "-O2", "-shared", "-fPIC", "-o", out, src],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(out)
        i64 = ctypes.c_int64
        fp = ctypes.POINTER(ctypes.c_float)
        up = ctypes.POINTER(ctypes.c_uint32)
        lib.trtpu_morton3.argtypes = [i64, fp, up]
        lib.trtpu_wide_fold.argtypes = [i64, fp, fp, fp]
        lib.trtpu_transform_points.argtypes = [i64, fp, fp, fp, fp, fp]
        _LIB = lib
    except Exception as e:  # no compiler / unexpected toolchain
        print(f"trtpu native build unavailable ({e}); using NumPy fallback",
              file=sys.stderr)
        _LIB = None
    return _LIB


def _as_f32(a):
    import numpy as np

    return np.ascontiguousarray(a, np.float32)


def wide_fold(leaf_min, leaf_max, level_counts):
    """8-ary bottom-up fold -> node_boxes [sum(counts), 48] f32, or None
    if no native lib (layout contract: ops/bvh.py wide_layout)."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    boxes = np.zeros((int(sum(level_counts)), 48), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.trtpu_wide_fold(
        len(leaf_min),
        _as_f32(leaf_min).ctypes.data_as(fp),
        _as_f32(leaf_max).ctypes.data_as(fp),
        boxes.ctypes.data_as(fp),
    )
    return boxes


def morton3(xyz):
    """[N, 3] normalised -> uint32 codes, or None if no native lib."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    x = _as_f32(xyz)
    codes = np.zeros(len(x), np.uint32)
    lib.trtpu_morton3(
        len(x),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return codes


def transform_points(pos, trans, scale, quat):
    """Similarity-transform points; None if no native lib."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    n = len(pos)
    out = np.zeros((n, 3), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.trtpu_transform_points(
        n,
        _as_f32(pos).ctypes.data_as(fp),
        _as_f32(trans).ctypes.data_as(fp),
        _as_f32(scale).ctypes.data_as(fp),
        _as_f32(quat).ctypes.data_as(fp),
        out.ctypes.data_as(fp),
    )
    return out

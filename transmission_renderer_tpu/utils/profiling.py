"""Profiling — the analogue of the reference's Tracy instrumentation.

The reference wraps every pass in Tracy GPU timestamp zones
(src/profiling.rs, zones at src/main.rs:1642-2260). Here:

  * ``pass_scope(name)`` emits a ``jax.named_scope`` so XLA/Pallas traces
    viewed in Perfetto (via ``jax.profiler.trace``) show the same per-pass
    breakdown the reference shows in Tracy;
  * ``trace(path)`` wraps ``jax.profiler.trace`` for capturing a
    Perfetto/XPlane trace directory.
"""

from __future__ import annotations

import contextlib

import jax


def pass_scope(name: str):
    """Named scope for one render pass (shows up in profiler traces)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace (open with Perfetto / TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

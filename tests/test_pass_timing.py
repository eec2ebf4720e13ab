"""tools/pass_timing.py: the reduction from a profiler trace to per-pass
device times."""

import jax
import jax.numpy as jnp
import pytest

from tools.pass_timing import (
    build_scope_map,
    busy_and_span_ms,
    profile_pass_times,
)
from transmission_renderer_tpu.utils.profiling import pass_scope


@pytest.mark.parametrize(
    "intervals, busy, span",
    [
        ([], 0.0, 0.0),
        ([(0, 2_000_000)], 2.0, 2.0),
        # a gap: idle time counts in the span only
        ([(0, 1_000_000), (3_000_000, 4_000_000)], 2.0, 4.0),
        # overlapping streams count once; a nested interval adds nothing
        ([(0, 2_000_000), (1_000_000, 3_000_000), (1_500_000, 1_600_000)],
         3.0, 3.0),
    ],
)
def test_busy_and_span(intervals, busy, span):
    assert busy_and_span_ms(intervals) == pytest.approx((busy, span))


def test_scope_map_keys_both_spellings():
    """GPU kernels are named after their HLO instruction with '_' for
    '.'; both spellings resolve, and the innermost listed scope wins."""
    hlo = (
        '%fusion.12 = f32[8]{0} fusion(%p), kind=kLoop, metadata={'
        'op_name="jit(frame)/shade_opaque/light_loop/mul"}\n'
        '%sort.3 = s32[8]{0} sort(%q), metadata={'
        'op_name="jit(frame)/binning/sort"}\n'
        '%add.1 = f32[8]{0} add(%a, %b)\n'
    )
    m = build_scope_map(hlo)
    assert m["fusion.12"] == m["fusion_12"] == "light_loop"
    assert m["sort_3"] == "binning"
    assert "add.1" not in m


def test_cpu_trace_attributes_scopes():
    def f(x):
        with pass_scope("geometry"):
            y = jnp.sin(x) @ x
        with pass_scope("tonemap"):
            return jnp.tanh(y).sum(0)

    fn = jax.jit(f)
    x = jnp.ones((256, 256), jnp.float32)
    jax.block_until_ready(fn(x))
    table = profile_pass_times(
        lambda: jax.block_until_ready(fn(x)),
        hlo_text=fn.lower(x).compile().as_text(),
    )
    assert table["geometry"] > 0 and table["tonemap"] > 0
    assert 0 < table["<busy>"] <= table["<span>"]

"""In-frame per-pass device timing from a profiler trace.

The reference wraps every pass in Tracy GPU timestamp zones and collects
them per frame (src/profiling.rs:101-131); here ONE profiled frame
(jax.profiler trace) is captured and device kernel time is summed by the
`pass_scope` names baked into op metadata (jax.named_scope -> HLO
op_name paths). The numbers come from the REAL fused frame's device
trace and sum to ~the measured frame time when the device is busy.

On a GPU the device plane (``/device:GPU:N``) holds one line per CUDA
stream; each kernel event carries the HLO instruction that launched it
(its name or an ``hlo_op`` stat), which the compiled module's text maps
to its scope.

Usage:
    from tools.pass_timing import profile_pass_times
    table = profile_pass_times(lambda: run_one_frame(), hlo_text=hlo)
    # {'shade_opaque': 4.1, ..., '<unattributed>': 0.2, '<total>': 9.7}

Kernels whose metadata carries no scope (fused across scopes, or outside
any pass_scope) land in '<unattributed>'.
"""

from __future__ import annotations

import glob
import os
import tempfile

# every pass_scope name used by render/frame.py (order = frame order)
PASS_SCOPES = (
    # sub-scopes FIRST: attribution picks the first match, and these
    # appear nested under shade_* in the op_name path
    "mat_row",
    "mat_tap",
    "mat_normal",
    "material_taps",
    "cluster_fetch",
    "brdf_sun",
    "brdf_slots",
    "light_loop",
    "pyr_down",
    "pyr_quads",
    "geometry",
    "binning",
    "payload",
    "raster_opaque",
    "clip_round_1",
    "clip_round_2",
    "clip_round_3",
    "clip_round_4",
    "clip_round_5",
    "clip_alpha_test",
    "raster_clip_peel",
    "clustering",
    "shadow_rays_opaque",
    "shade_opaque",
    "mip_pyramid",
    "raster_transmission",
    "shadow_rays_transmission",
    "shade_transmission",
    "tonemap",
)


def _attribute(text: str, scopes) -> str | None:
    for s in scopes:
        if f"/{s}" in text or text.startswith(s):
            return s
    return None


def build_scope_map(hlo_text: str, scopes=PASS_SCOPES) -> dict:
    """Compiled-HLO text -> {instruction name: scope}.

    Device kernels are named after the HLO instructions that launch them
    (``fusion.123``; on a GPU the kernel is ``fusion_123``), whose
    metadata op_name carries the jax.named_scope path — the only place
    the pass structure survives compilation. Both spellings are keys."""
    import re

    out = {}
    pat = re.compile(r"%?([\w.\-]+) = .*metadata=\{[^}]*op_name=\"([^\"]+)\"")
    for m in pat.finditer(hlo_text):
        name, op_name = m.group(1), m.group(2)
        scope = _attribute(op_name, scopes)
        if scope:
            out[name] = scope
            out.setdefault(name.replace(".", "_"), scope)
    return out


def _is_library_kernel(name: str) -> bool:
    """cuBLAS / CUTLASS kernels, named after the library routine rather
    than the HLO instruction that called them."""
    return "gemm" in name or "cutlass" in name or name.startswith("void ")


def _kernel_lines(data):
    """The trace lines that hold one event per device kernel: on a GPU
    plane the per-stream lines (an ``XLA Ops`` line, where the profiler
    derives one, replaces them — the two would double-count); on the CPU
    the XLA client lines (``tf_...`` under /host:CPU)."""
    out = []
    for plane in data.planes:
        lines = list(plane.lines)
        if plane.name.startswith("/device:"):
            ops = [ln for ln in lines if ln.name == "XLA Ops"]
            out += ops or [
                ln for ln in lines if (ln.name or "").startswith("Stream")
            ]
        else:
            out += [ln for ln in lines if (ln.name or "").startswith("tf_")]
    return out


def busy_and_span_ms(intervals) -> tuple:
    """(union length, first start to last end) in ms of [start, end)
    nanosecond intervals, which may overlap (concurrent streams)."""
    busy, end = 0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    if not intervals:
        return 0.0, 0.0
    span = max(hi for _, hi in intervals) - min(lo for lo, _ in intervals)
    return busy / 1e6, span / 1e6


def collect_pass_times(
    trace_dir: str, scopes=PASS_SCOPES, scope_map: dict | None = None,
) -> dict:
    """Parse the newest xplane in ``trace_dir`` -> {scope: device_ms}.

    ``scope_map`` (from build_scope_map) resolves HLO instruction names;
    string stats / event names are also scanned. Includes
    '<unattributed>' (device ops without a recognised scope),
    '<inherited>' (library kernels given their stream neighbour's scope,
    already inside the per-scope sums), '<total>' (all device op time),
    '<busy>' (the union of the ops' intervals: streams that overlap count
    once) and '<span>' (first op start to last op end; span - busy is
    the device's idle time inside the traced work)."""
    import re

    from jax.profiler import ProfileData

    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no xplane.pb under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    scope_map = scope_map or {}

    # event names may be the FULL instruction text ('%fusion.3 =
    # f32[...] fusion(...)') — parse the instruction NAME out to key
    # into scope_map
    instr_pat = re.compile(r"^%?([\w.\-]+)\s*=")

    sums = {s: 0.0 for s in scopes}
    unattributed = 0.0
    inherited = 0.0
    total = 0.0
    unattr_top = {}
    intervals = []
    for line in _kernel_lines(data):
        prev = None  # scope of the previous kernel on this stream
        for ev in sorted(line.events, key=lambda e: e.start_ns):
            intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
            dur = ev.duration_ns / 1e6
            ev_name = ev.name or ""
            texts = [ev_name.lstrip("%")]
            m = instr_pat.match(ev_name)
            if m:
                texts.insert(0, m.group(1))
            try:
                for k, v in ev.stats:
                    if isinstance(v, str):
                        texts.append(v.lstrip("%"))
            except Exception:
                pass
            scope = None
            for t in texts:
                scope = scope_map.get(t) or _attribute(t, scopes)
                if scope:
                    break
            if scope is None and prev and _is_library_kernel(ev_name):
                # a library kernel carries no HLO name: it takes the pass
                # of the kernel before it on its stream (its operand's
                # producer, as a rule); counted apart in '<inherited>'
                scope = prev
                inherited += dur
            total += dur
            if scope:
                sums[scope] += dur
                prev = scope
            else:
                unattributed += dur
                key = texts[0][:60]
                unattr_top[key] = unattr_top.get(key, 0.0) + dur
    sums["<unattributed>"] = unattributed
    sums["<inherited>"] = inherited
    sums["<total>"] = total
    sums["<busy>"], sums["<span>"] = busy_and_span_ms(intervals)
    sums["<unattributed_top>"] = dict(
        sorted(unattr_top.items(), key=lambda kv: -kv[1])[:8]
    )
    return sums


def profile_pass_times(
    run_frame, scopes=PASS_SCOPES, hlo_text: str | None = None,
) -> dict:
    """Trace one call of ``run_frame`` (should render + sync one frame)
    and return its per-pass device-ms table. ``hlo_text`` (the compiled
    module's as_text) resolves fusion names to scopes — without it, only
    ops whose trace metadata carries the scope string attribute."""
    import jax

    scope_map = build_scope_map(hlo_text, scopes) if hlo_text else None
    with tempfile.TemporaryDirectory(prefix="pass_trace_") as d:
        jax.profiler.start_trace(d)
        try:
            run_frame()
        finally:
            jax.profiler.stop_trace()
        return collect_pass_times(d, scopes, scope_map)


def format_table(sums: dict) -> str:
    lines = []
    for s in PASS_SCOPES:
        if sums.get(s):
            lines.append(f"  {s:<26} {sums[s]:8.2f} ms")
    lines.append(f"  {'<unattributed>':<26} {sums.get('<unattributed>', 0.0):8.2f} ms")
    lines.append(f"  {'<inherited, in the above>':<26} {sums.get('<inherited>', 0.0):8.2f} ms")
    lines.append(f"  {'<total device>':<26} {sums.get('<total>', 0.0):8.2f} ms")
    lines.append(f"  {'<busy (union)>':<26} {sums.get('<busy>', 0.0):8.2f} ms")
    lines.append(f"  {'<span>':<26} {sums.get('<span>', 0.0):8.2f} ms")
    top = sums.get("<unattributed_top>") or {}
    for k, v in top.items():
        if v >= 1.0:  # only name the unattributed ops that matter (>=1 ms)
            lines.append(f"    ? {k:<55} {v:7.2f} ms")
    return "\n".join(lines)

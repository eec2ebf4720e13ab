"""transmission_renderer_tpu — a forward-plus glTF PBR renderer for GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``expenses/transmission-renderer`` (a Rust/Vulkan renderer specialised in
``KHR_materials_transmission`` + ``KHR_materials_volume``): clustered
forward lighting, GPU-driven frustum culling, a dual depth pre-pass,
rough-transmission rendering through an opaque-framebuffer mip chain,
Beer's-law volume attenuation, ray-traced shadows over an LBVH, and Lottes
tonemapping.

Architecture (array-first, not a port):
  * The whole frame is one jitted function built from dense array passes —
    the Vulkan render-graph/barrier machinery is replaced by XLA dataflow.
  * Rasterisation is a tile-binned visibility-buffer kernel; shading is a
    separate dense per-pixel pass (regular, vectorisable — unlike the
    fragment-shader coupling of the reference).
  * GPU atomics (culling compaction, cluster light lists) become
    sorts/prefix-scans with identical semantics.
  * Multi-device scaling shards framebuffer row-bands over a device mesh
    via ``shard_map``; mip-chain sampling uses gathered coarse levels.
"""

__version__ = "0.1.0"

from transmission_renderer_tpu.config import RenderConfig  # noqa: F401

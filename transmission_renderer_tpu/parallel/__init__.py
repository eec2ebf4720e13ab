"""Multi-device scaling over a device mesh.

The reference is single-GPU; its 'communication backend' is the Vulkan
queue + barriers (SURVEY.md §2.6, §5.8). This renderer's one real
distributed feature is a framebuffer sharded row-band-wise across devices
via ``shard_map``, with collectives for the cross-band data the
transmission pass needs.
"""

from transmission_renderer_tpu.parallel.sharded import (  # noqa: F401
    make_band_mesh,
    render_frame_sharded,
)

"""SceneBuilder — host-side accumulation of geometry/instances/materials.

The Python analogue of the reference's staging-vec accumulation
(``ModelStagingBuffers``, src/main.rs:2495-2560, filled by ``load_gltf``,
src/model_loading.rs:59-162): primitives append into shared pools with
index rebasing; instances reference primitives + materials; finish()
freezes everything into the Scene pytree.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from transmission_renderer_tpu.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    BUCKET_TRANSMISSION_ALPHA_CLIP,
)
from transmission_renderer_tpu.scene.textures import AtlasBuilder, texture_ref
from transmission_renderer_tpu.scene.types import (
    Scene,
    Similarity,
    default_material,
    pack_materials,
    quat_identity,
)


def classify_draw_bucket(alpha_mode: str, has_transmission: bool) -> int:
    """(alpha_mode x transmission) -> draw bucket
    (src/model_loading.rs:68-78). BLEND falls back to opaque with a warning
    exactly like the reference's ``dbg!`` arm."""
    table = {
        ("OPAQUE", False): BUCKET_OPAQUE,
        ("MASK", False): BUCKET_ALPHA_CLIP,
        ("OPAQUE", True): BUCKET_TRANSMISSION,
        ("MASK", True): BUCKET_TRANSMISSION_ALPHA_CLIP,
    }
    return table.get((alpha_mode, has_transmission), BUCKET_OPAQUE)


class SceneBuilder:
    def __init__(self):
        self.positions: list[np.ndarray] = []
        self.normals: list[np.ndarray] = []
        self.uvs: list[np.ndarray] = []
        self.indices: list[np.ndarray] = []
        self.prim_sphere: list[np.ndarray] = []
        self.prim_bucket: list[int] = []
        self.prim_first_tri: list[int] = []
        self.prim_tri_count: list[int] = []
        self.inst_translation: list[np.ndarray] = []
        self.inst_scale: list[float] = []
        self.inst_rotation: list[np.ndarray] = []
        self.inst_primitive: list[int] = []
        self.inst_material: list[int] = []
        self.materials: list[dict] = []
        self.atlas = AtlasBuilder()
        self._num_vertices = 0
        self._num_indices = 0

    # -- geometry ----------------------------------------------------------

    def add_primitive(
        self,
        positions: np.ndarray,  # [V, 3]
        normals: np.ndarray,  # [V, 3]
        uvs: np.ndarray | None,  # [V, 2] or None (zero-filled, matching
        # the AttenuationTest handling, src/model_loading.rs:122-134)
        indices: np.ndarray,  # [N] flat or [N/3, 3]
        bucket: int,
        uv_scaling: tuple[float, float] = (1.0, 1.0),
    ) -> int:
        positions = np.asarray(positions, np.float32)
        normals = np.asarray(normals, np.float32)
        if uvs is None:
            uvs = np.zeros((len(positions), 2), np.float32)
        else:
            uvs = np.asarray(uvs, np.float32) * np.asarray(uv_scaling, np.float32)
        indices = np.asarray(indices, np.uint32).reshape(-1, 3)

        prim_id = len(self.prim_bucket)
        # index rebasing into the shared pool (src/model_loading.rs:102-108)
        self.indices.append(indices + self._num_vertices)
        self.positions.append(positions)
        self.normals.append(normals)
        self.uvs.append(uvs)

        # AABB -> bounding sphere (src/model_loading.rs:148-155)
        mn = positions.min(0)
        mx = positions.max(0)
        center = (mn + mx) / 2.0
        radius = np.linalg.norm(mx - mn) / 2.0
        self.prim_sphere.append(np.array([*center, radius], np.float32))
        self.prim_bucket.append(bucket)
        self.prim_first_tri.append(self._num_indices // 3)
        self.prim_tri_count.append(len(indices))

        self._num_vertices += len(positions)
        self._num_indices += indices.size
        return prim_id

    def add_instance(
        self,
        primitive_id: int,
        material_id: int,
        translation=(0.0, 0.0, 0.0),
        scale: float = 1.0,
        rotation: np.ndarray | None = None,
    ) -> int:
        self.inst_translation.append(np.asarray(translation, np.float32))
        self.inst_scale.append(float(scale))
        self.inst_rotation.append(
            quat_identity() if rotation is None else np.asarray(rotation, np.float32)
        )
        self.inst_primitive.append(primitive_id)
        self.inst_material.append(material_id)
        return len(self.inst_primitive) - 1

    def add_material(self, **overrides) -> int:
        self.materials.append(default_material(**overrides))
        return len(self.materials) - 1

    def add_texture(self, rgba: np.ndarray, srgb: bool) -> int:
        return self.atlas.push_image(rgba, srgb)

    def add_texture_bundle(self, images: list[tuple[np.ndarray, bool]]) -> list[int]:
        """Push same-size (rgba, srgb) images as LAYERS of one atlas
        bundle; returns a packed texture ref per image for add_material.
        A material whose sampled textures all come from one bundle pays
        ONE gather for its whole texture set (scene/textures.py)."""
        bid = self.atlas.push_bundle(
            [im for im, _ in images], [bool(s) for _, s in images]
        )
        return [texture_ref(bid, k) for k in range(len(images))]

    # -- ray tracing ---------------------------------------------------------

    def build_rt_bvh(self):
        """Host-side LBVH over the expanded world-space geometry — the
        analogue of the BLAS/TLAS build (src/acceleration_structures.rs).
        Per-frame transform changes are handled by ``refit_bvh`` inside
        render_frame."""
        from transmission_renderer_tpu.ops.bvh import build_bvh
        from transmission_renderer_tpu.render.frame import expand_draw_list_numpy

        d = expand_draw_list_numpy(
            np.array(self.inst_primitive, np.int32),
            np.array(self.inst_material, np.int32),
            np.array(self.prim_first_tri, np.int32),
            np.array(self.prim_tri_count, np.int32),
            np.array(self.prim_bucket, np.int32),
            np.concatenate(self.indices).astype(np.int32).reshape(-1, 3),
        )
        obj = np.concatenate(self.positions)[d["vtx_src"]]
        t = np.stack(self.inst_translation)[d["vtx_inst"]]
        s = np.array(self.inst_scale, np.float32)[d["vtx_inst"]]
        q = np.stack(self.inst_rotation)[d["vtx_inst"]]
        # numpy quaternion rotate (xyzw)
        qv = q[:, :3]
        qw = q[:, 3:4]
        tvec = 2.0 * np.cross(qv, obj)
        world = t + s[:, None] * (obj + qw * tvec + np.cross(qv, tvec))
        return build_bvh(d["tri_vtx"], world.astype(np.float32))

    # -- freeze -------------------------------------------------------------

    def finish_bundle(self):
        """(Scene, DrawList, SceneFlags) with the draw list computed host-
        side. Always prefer this over finish() + build_draw_list(scene):
        the latter reads device arrays back to the host."""
        from transmission_renderer_tpu.render.frame import (
            TEX_SLOT_NAMES,
            build_draw_list_from_numpy,
            scene_flags_from_arrays,
        )

        scene = self.finish()
        dl = build_draw_list_from_numpy(
            np.array(self.inst_primitive, np.int32),
            np.array(self.inst_material, np.int32),
            np.array(self.prim_first_tri, np.int32),
            np.array(self.prim_tri_count, np.int32),
            np.array(self.prim_bucket, np.int32),
            np.concatenate(self.indices).astype(np.int32).reshape(-1, 3),
        )
        mats = self.materials or [default_material()]
        # SAME derivation as render.frame.scene_flags, fed from the host
        # staging lists (finish_bundle must not read back device arrays)
        flags = scene_flags_from_arrays(
            np.array(self.prim_bucket, np.int32),
            np.array(self.inst_primitive, np.int32),
            np.array(self.inst_material, np.int32),
            {n: np.array([m[n] for m in mats], np.int64)
             for n in TEX_SLOT_NAMES},
            np.array([m["roughness_factor"] for m in mats], np.float32),
            np.array([m["index_of_refraction"] for m in mats], np.float32),
            np.stack(self.atlas._meta),
        )
        return scene, dl, flags

    def finish(self) -> Scene:
        assert self.prim_bucket, "empty scene"
        texels, meta, srgb = self.atlas.finish()
        return Scene(
            positions=jnp.asarray(np.concatenate(self.positions)),
            normals=jnp.asarray(np.concatenate(self.normals)),
            uvs=jnp.asarray(np.concatenate(self.uvs)),
            indices=jnp.asarray(
                np.concatenate(self.indices).astype(np.int32)
            ),
            prim_bounding_sphere=jnp.asarray(np.stack(self.prim_sphere)),
            prim_draw_bucket=jnp.asarray(np.array(self.prim_bucket, np.int32)),
            prim_first_tri=jnp.asarray(np.array(self.prim_first_tri, np.int32)),
            prim_tri_count=jnp.asarray(np.array(self.prim_tri_count, np.int32)),
            inst_transform=Similarity(
                translation=jnp.asarray(np.stack(self.inst_translation)),
                scale=jnp.asarray(np.array(self.inst_scale, np.float32)),
                rotation=jnp.asarray(np.stack(self.inst_rotation)),
            ),
            inst_primitive_id=jnp.asarray(np.array(self.inst_primitive, np.int32)),
            inst_material_id=jnp.asarray(np.array(self.inst_material, np.int32)),
            materials=pack_materials(self.materials),
            atlas_texels=jnp.asarray(texels),
            atlas_meta=jnp.asarray(meta),
            atlas_srgb=jnp.asarray(srgb),
        )

"""Scene data model: Similarity transforms (quaternion math) and the
frozen Scene pytree consumed by the frame graph.

``Similarity`` mirrors shared-structs/src/lib.rs:178-241 (translation +
uniform scale + rotation quaternion); the Scene pytree replaces the
reference's device buffers + bindless descriptor tables (SURVEY.md §2.1)
with plain indexed arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


# --------------------------------------------------------------------------
# Quaternion helpers (xyzw layout, matching glam)
# --------------------------------------------------------------------------

def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def quat_mul(a, b):
    """Hamilton product a*b, xyzw layout. Works on [..., 4] arrays."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by quaternions q [..., 4] (xyzw)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def quat_from_rotation_y(angle: float) -> np.ndarray:
    return np.array(
        [0.0, np.sin(angle / 2.0), 0.0, np.cos(angle / 2.0)], np.float32
    )


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2.0)
    return np.array([*(axis * s), np.cos(angle / 2.0)], np.float32)


# --------------------------------------------------------------------------
# Similarity transforms (shared-structs/src/lib.rs:196-241)
# --------------------------------------------------------------------------

class Similarity(NamedTuple):
    """translation + uniform scale + rotation; batchable ([..., ] leading)."""

    translation: jnp.ndarray  # [..., 3]
    scale: jnp.ndarray  # [...]
    rotation: jnp.ndarray  # [..., 4] xyzw


def similarity_identity(batch: tuple[int, ...] = ()) -> Similarity:
    return Similarity(
        translation=jnp.zeros(batch + (3,), jnp.float32),
        scale=jnp.ones(batch, jnp.float32),
        rotation=jnp.broadcast_to(
            jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32), batch + (4,)
        ),
    )


def similarity_apply(s: Similarity, v: jnp.ndarray) -> jnp.ndarray:
    """s * vector = translation + scale * (rotation * v)
    (shared-structs/src/lib.rs:235-241)."""
    return s.translation + s.scale[..., None] * quat_rotate(s.rotation, v)


def similarity_mul(a: Similarity, b: Similarity) -> Similarity:
    """Group product (shared-structs/src/lib.rs:223-233)."""
    return Similarity(
        translation=similarity_apply(a, b.translation),
        scale=a.scale * b.scale,
        rotation=quat_mul(a.rotation, b.rotation),
    )


def similarity_to_mat4(s: Similarity) -> jnp.ndarray:
    """As a 4x4 matrix, M @ [p, 1] convention (shared-structs lib.rs:216-221)."""
    q = s.rotation
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )
    m = jnp.zeros(s.scale.shape + (4, 4), jnp.float32)
    m = m.at[..., :3, :3].set(rot * s.scale[..., None, None])
    m = m.at[..., :3, 3].set(s.translation)
    m = m.at[..., 3, 3].set(1.0)
    return m


# --------------------------------------------------------------------------
# Materials SoA (mirror of MaterialInfo, shared-structs/src/lib.rs:157-173)
# --------------------------------------------------------------------------

class MaterialsSoA(NamedTuple):
    """[M]-batched material table. ``tex_*`` fields are texture ids into the
    atlas metadata table, -1 = absent (shared-structs/src/lib.rs:143-153)."""

    # texture slots
    tex_diffuse: jnp.ndarray  # [M] int32
    tex_metallic_roughness: jnp.ndarray
    tex_normal_map: jnp.ndarray
    tex_emissive: jnp.ndarray
    tex_occlusion: jnp.ndarray
    tex_transmission: jnp.ndarray
    tex_thickness: jnp.ndarray
    tex_specular: jnp.ndarray
    tex_specular_colour: jnp.ndarray
    # factors
    metallic_factor: jnp.ndarray  # [M]
    roughness_factor: jnp.ndarray  # [M]
    alpha_clipping_cutoff: jnp.ndarray  # [M]
    diffuse_factor: jnp.ndarray  # [M, 4]
    emissive_factor: jnp.ndarray  # [M, 3]
    normal_map_scale: jnp.ndarray  # [M]
    occlusion_strength: jnp.ndarray  # [M]
    index_of_refraction: jnp.ndarray  # [M]
    transmission_factor: jnp.ndarray  # [M]
    thickness_factor: jnp.ndarray  # [M]
    attenuation_distance: jnp.ndarray  # [M]
    attenuation_colour: jnp.ndarray  # [M, 3]
    specular_factor: jnp.ndarray  # [M]
    specular_colour_factor: jnp.ndarray  # [M, 3]

    @property
    def num(self) -> int:
        return self.metallic_factor.shape[0]


def default_material(**overrides) -> dict:
    """glTF-default material row (defaults match src/model_loading.rs:293-333)."""
    row = dict(
        tex_diffuse=-1, tex_metallic_roughness=-1, tex_normal_map=-1,
        tex_emissive=-1, tex_occlusion=-1, tex_transmission=-1,
        tex_thickness=-1, tex_specular=-1, tex_specular_colour=-1,
        metallic_factor=1.0, roughness_factor=1.0, alpha_clipping_cutoff=0.5,
        diffuse_factor=(1.0, 1.0, 1.0, 1.0), emissive_factor=(0.0, 0.0, 0.0),
        normal_map_scale=0.0, occlusion_strength=1.0, index_of_refraction=1.5,
        transmission_factor=0.0, thickness_factor=0.0,
        attenuation_distance=np.inf, attenuation_colour=(1.0, 1.0, 1.0),
        specular_factor=1.0, specular_colour_factor=(1.0, 1.0, 1.0),
    )
    row.update(overrides)
    return row


def pack_materials(rows: list[dict]) -> MaterialsSoA:
    if not rows:
        rows = [default_material()]

    def col(key, dtype=np.float32, width=None):
        vals = [np.asarray(r[key], dtype) for r in rows]
        return jnp.asarray(np.stack(vals))

    int_keys = [k for k in rows[0] if k.startswith("tex_")]
    kwargs = {k: col(k, np.int32) for k in int_keys}
    for k in rows[0]:
        if not k.startswith("tex_"):
            kwargs[k] = col(k)
    return MaterialsSoA(**kwargs)


# --------------------------------------------------------------------------
# Scene pytree
# --------------------------------------------------------------------------

class Scene(NamedTuple):
    """Frozen scene arrays — the equivalent of ModelBuffers + descriptor
    tables (src/main.rs:2495-2588).

    Geometry is one shared SoA pool with rebased indices
    (src/model_loading.rs:98-134). Per-instance expansion happens at frame
    time (vertex transform pass), mirroring the reference's instanced draws.
    """

    # vertex pool
    positions: jnp.ndarray  # [V, 3] f32 (object space)
    normals: jnp.ndarray  # [V, 3] f32
    uvs: jnp.ndarray  # [V, 2] f32
    # index pool: [T, 3] int32, rebased into the vertex pool
    indices: jnp.ndarray
    # per-primitive metadata (PrimitiveInfo, shared-structs/src/lib.rs:262-268)
    prim_bounding_sphere: jnp.ndarray  # [P, 4] xyz center + w radius (object space)
    prim_draw_bucket: jnp.ndarray  # [P] int32 in 0..4
    prim_first_tri: jnp.ndarray  # [P] int32 (first_index / 3)
    prim_tri_count: jnp.ndarray  # [P] int32
    # instances (shared-structs/src/lib.rs:253-257)
    inst_transform: Similarity  # [I]-batched
    inst_primitive_id: jnp.ndarray  # [I] int32
    inst_material_id: jnp.ndarray  # [I] int32
    # materials + textures
    materials: MaterialsSoA
    # Texture atlas: flat texel pool (RGBA8, all mips of all textures) plus
    # a metadata table; see scene/textures.py. Kept as uint32-packed RGBA.
    # [R, QUAD_GROUP*16*L] f32: QUAD_GROUP quad-blocks/row, texels
    # pre-decoded to linear (scene/textures.py), L bundle layers
    atlas_texels: jnp.ndarray
    atlas_meta: jnp.ndarray  # [num_images, META_COLS] int32 table
    atlas_srgb: jnp.ndarray  # [num_images] bool (informational; decode is
    # baked into atlas_texels at build time)

    @property
    def num_instances(self) -> int:
        return self.inst_primitive_id.shape[0]

    @property
    def num_primitives(self) -> int:
        return self.prim_draw_bucket.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

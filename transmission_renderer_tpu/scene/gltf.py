"""glTF 2.0 / GLB loader — NumPy reimplementation of the reference's asset
pipeline (src/model_loading.rs:13-339), including the extensions the
reference's gltf fork carries (Cargo.toml:13): ``KHR_materials_ior``,
``KHR_materials_transmission``, ``KHR_materials_volume``,
``KHR_materials_specular``, ``KHR_texture_transform`` (scale only, base
colour only — src/model_loading.rs:87-94).

Semantics mirrored 1:1:
  * node hierarchy flattened through Similarity transforms with the
    uniform-scale assertion (src/model_loading.rs:438-484),
  * draw-bucket classification by (alpha_mode x transmission)
    (src/model_loading.rs:68-78),
  * index rebasing into shared pools, zero-filled missing UVs
    (src/model_loading.rs:98-134),
  * 9-slot texture table with the (image, srgb) dedup cache
    (src/model_loading.rs:166-291),
  * material factor defaults incl. IOR 1.5, attenuation_distance scaled by
    the model scale (src/model_loading.rs:293-333).
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct

import numpy as np

from transmission_renderer_tpu.scene.builder import SceneBuilder, classify_draw_bucket

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def path_for_gltf_model(model: str) -> str:
    """glTF-Sample-Models/2.0/<m>/glTF/<m>.gltf (src/model_loading.rs:381-390)."""
    return os.path.join("glTF-Sample-Models", "2.0", model, "glTF", model + ".gltf")


class GltfDocument:
    """Parsed glTF JSON + binary buffers + decoded images."""

    def __init__(self, json_doc: dict, buffers: list[bytes], base_dir: str):
        self.doc = json_doc
        self.buffers = buffers
        self.base_dir = base_dir
        self._image_cache: dict[int, np.ndarray] = {}

    # -- parsing ------------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "GltfDocument":
        base_dir = os.path.dirname(path)
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"glTF":
            return cls._parse_glb(data, base_dir)
        doc = json.loads(data)
        buffers = [
            cls._load_buffer_uri(b.get("uri"), b["byteLength"], base_dir)
            for b in doc.get("buffers", [])
        ]
        return cls(doc, buffers, base_dir)

    @classmethod
    def _parse_glb(cls, data: bytes, base_dir: str) -> "GltfDocument":
        magic, version, _length = struct.unpack_from("<III", data, 0)
        assert magic == 0x46546C67 and version == 2, "bad GLB header"
        offset = 12
        doc = None
        bin_chunk = b""
        while offset < len(data):
            chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
            chunk = data[offset + 8 : offset + 8 + chunk_len]
            if chunk_type == 0x4E4F534A:  # JSON
                doc = json.loads(chunk)
            elif chunk_type == 0x004E4942:  # BIN
                bin_chunk = chunk
            offset += 8 + chunk_len
        assert doc is not None, "GLB without JSON chunk"
        buffers = []
        for b in doc.get("buffers", []):
            if b.get("uri") is None:
                buffers.append(bin_chunk)
            else:
                buffers.append(cls._load_buffer_uri(b["uri"], b["byteLength"], base_dir))
        return cls(doc, buffers, base_dir)

    @staticmethod
    def _load_buffer_uri(uri: str | None, length: int, base_dir: str) -> bytes:
        assert uri is not None
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])[:length]
        with open(os.path.join(base_dir, uri), "rb") as f:
            return f.read()

    # -- accessors ------------------------------------------------------------

    def read_accessor(self, index: int) -> np.ndarray:
        acc = self.doc["accessors"][index]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize * ncomp

        if "bufferView" not in acc:
            out = np.zeros((count, ncomp), dtype)
        else:
            bv = self.doc["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", itemsize)
            if stride == itemsize:
                out = np.frombuffer(
                    buf, dtype, count=count * ncomp, offset=start
                ).reshape(count, ncomp)
            else:
                raw = np.frombuffer(
                    buf, np.uint8, count=stride * (count - 1) + itemsize, offset=start
                )
                strided = np.lib.stride_tricks.as_strided(
                    raw, shape=(count, itemsize), strides=(stride, 1)
                )
                out = strided.tobytes()
                out = np.frombuffer(out, dtype).reshape(count, ncomp)
        out = np.array(out)  # copy, detach from buffer
        if "sparse" in acc:
            # sparse substitution: scatter `values` rows at `indices`
            # over the base view (or the zero base when bufferView is
            # absent) — glTF 2.0 §3.6.2.4
            sp = acc["sparse"]
            n = sp["count"]
            idx_def, val_def = sp["indices"], sp["values"]
            idx_dtype = _COMPONENT_DTYPES[idx_def["componentType"]]
            ibv = self.doc["bufferViews"][idx_def["bufferView"]]
            istart = ibv.get("byteOffset", 0) + idx_def.get("byteOffset", 0)
            sidx = np.frombuffer(
                self.buffers[ibv["buffer"]], idx_dtype, count=n, offset=istart
            ).astype(np.int64)
            vbv = self.doc["bufferViews"][val_def["bufferView"]]
            vstart = vbv.get("byteOffset", 0) + val_def.get("byteOffset", 0)
            svals = np.frombuffer(
                self.buffers[vbv["buffer"]], dtype, count=n * ncomp,
                offset=vstart,
            ).reshape(n, ncomp)
            out[sidx] = svals
        if acc.get("normalized"):
            info = np.iinfo(dtype)
            if info.min < 0:
                out = np.maximum(out.astype(np.float32) / info.max, -1.0)
            else:
                out = out.astype(np.float32) / info.max
        return out

    def read_image(self, index: int) -> np.ndarray:
        """Decode image -> RGBA8 (RGB expanded, src/model_loading.rs:36-53)."""
        if index in self._image_cache:
            return self._image_cache[index]
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "decoding glTF textures needs Pillow (pip install pillow); "
                "it is the only part of the renderer that does"
            ) from e

        img_def = self.doc["images"][index]
        if "uri" in img_def:
            uri = img_def["uri"]
            if uri.startswith("data:"):
                raw = base64.b64decode(uri.split(",", 1)[1])
                img = Image.open(io.BytesIO(raw))
            else:
                img = Image.open(os.path.join(self.base_dir, uri))
        else:
            bv = self.doc["bufferViews"][img_def["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0)
            img = Image.open(io.BytesIO(buf[start : start + bv["byteLength"]]))
        if img.mode != "RGBA":
            img = img.convert("RGBA")
        rgba = np.asarray(img, np.uint8)
        self._image_cache[index] = rgba
        return rgba


def _node_similarity(node: dict):
    """(translation, rotation xyzw, uniform scale) with the reference's
    uniform-scale assertion (src/model_loading.rs:449-458)."""
    if "matrix" in node:
        m = np.array(node["matrix"], np.float32).reshape(4, 4).T  # column-major
        translation = m[:3, 3]
        sx = np.linalg.norm(m[:3, 0])
        sy = np.linalg.norm(m[:3, 1])
        sz = np.linalg.norm(m[:3, 2])
        assert abs(sx - sy) <= 1e-5 and abs(sx - sz) <= 1e-5, (sx, sy, sz)
        r = m[:3, :3] / sx
        # rotation matrix -> quaternion (xyzw)
        t = np.trace(r)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            quat = np.array(
                [(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                 (r[1, 0] - r[0, 1]) / s, 0.25 * s], np.float32,
            )
        else:
            i = int(np.argmax(np.diag(r)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 0.0)) * 2
            quat = np.zeros(4, np.float32)
            quat[i] = 0.25 * s
            quat[j] = (r[j, i] + r[i, j]) / s
            quat[k] = (r[k, i] + r[i, k]) / s
            quat[3] = (r[k, j] - r[j, k]) / s
        return translation.astype(np.float32), quat, float(sx)
    translation = np.array(node.get("translation", [0, 0, 0]), np.float32)
    quat = np.array(node.get("rotation", [0, 0, 0, 1]), np.float32)
    scale = node.get("scale", [1, 1, 1])
    assert abs(scale[0] - scale[1]) <= 1.2e-6 * 10 and abs(
        scale[0] - scale[2]
    ) <= 1.2e-6 * 10, f"non-uniform scale {scale}"
    return translation, quat, float(scale[0])


def _sim_mul(a, b):
    """Similarity product on (t, q(xyzw), s) triples (host-side NumPy)."""
    ta, qa, sa = a
    tb, qb, sb = b

    def rot(q, v):
        qv = q[:3]
        t = 2.0 * np.cross(qv, v)
        return v + q[3] * t + np.cross(qv, t)

    def qmul(p, q):
        px, py, pz, pw = p
        qx, qy, qz, qw = q
        return np.array(
            [
                pw * qx + px * qw + py * qz - pz * qy,
                pw * qy - px * qz + py * qw + pz * qx,
                pw * qz + px * qy - py * qx + pz * qw,
                pw * qw - px * qx - py * qy - pz * qz,
            ],
            np.float32,
        )

    return (ta + sa * rot(qa, tb), qmul(qa, qb), sa * sb)


_SIM_IDENTITY = (
    np.zeros(3, np.float32),
    np.array([0, 0, 0, 1], np.float32),
    1.0,
)


def _flatten_nodes(doc: dict):
    """NodeTree::transform_of for every node (src/model_loading.rs:438-484)."""
    nodes = doc.get("nodes", [])
    parent = [None] * len(nodes)
    for i, node in enumerate(nodes):
        for child in node.get("children", []):
            parent[child] = i
    world = [None] * len(nodes)

    def compute(i):
        if world[i] is not None:
            return world[i]
        local = _node_similarity(nodes[i])
        if parent[i] is None:
            world[i] = local
        else:
            world[i] = _sim_mul(compute(parent[i]), local)
        return world[i]

    for i in range(len(nodes)):
        compute(i)
    return world


def load_gltf(
    path: str,
    builder: SceneBuilder,
    base_scale: float = 1.0,
    base_translation=(0.0, 0.0, 0.0),
    roughness_override: float | None = None,
) -> None:
    """Append a glTF file's contents to ``builder`` — the Python twin of
    ``load_gltf`` (src/model_loading.rs:13-339)."""
    g = GltfDocument.load(path)
    doc = g.doc
    base_sim = (
        np.asarray(base_translation, np.float32),
        np.array([0, 0, 0, 1], np.float32),
        float(base_scale),
    )

    material_id_base = len(builder.materials)
    node_world = _flatten_nodes(doc)

    # --- meshes/primitives (src/model_loading.rs:59-162) -------------------
    materials = doc.get("materials", [])
    # primitives without a "material" reference map to the MODEL'S
    # material 0 — the reference's unwrap_or(0) quirk
    # (src/model_loading.rs:96), NOT the glTF-spec default material.
    # The one case the reference leaves undefined (a document with zero
    # materials, where base+0 would alias a previous model's material)
    # gets a spec-default material appended instead.
    needs_default_material = False
    for node_idx, node in enumerate(doc.get("nodes", [])):
        if "mesh" not in node:
            continue
        t, q, s = _sim_mul(base_sim, node_world[node_idx])
        mesh = doc["meshes"][node["mesh"]]
        for prim in mesh["primitives"]:
            mode = prim.get("mode", 4)
            if mode != 4:  # TRIANGLES; strips/fans/lines need conversion
                raise ValueError(
                    f"unsupported glTF primitive mode {mode} (only "
                    f"TRIANGLES is supported, like the reference loader)"
                )
            mat_idx = prim.get("material", 0)
            if mat_idx < len(materials):
                mat = materials[mat_idx]
            else:
                mat_idx = len(materials)  # default slot (appended below)
                needs_default_material = True
                mat = {}
            ext = mat.get("extensions", {})
            alpha_mode = mat.get("alphaMode", "OPAQUE")
            has_transmission = "KHR_materials_transmission" in ext
            bucket = classify_draw_bucket(alpha_mode, has_transmission)

            # KHR_texture_transform scale, base colour only
            uv_scaling = (1.0, 1.0)
            bct = mat.get("pbrMetallicRoughness", {}).get("baseColorTexture")
            if bct and "KHR_texture_transform" in bct.get("extensions", {}):
                uv_scaling = tuple(
                    bct["extensions"]["KHR_texture_transform"].get("scale", (1.0, 1.0))
                )

            attrs = prim["attributes"]
            positions = g.read_accessor(attrs["POSITION"]).astype(np.float32)
            if "NORMAL" in attrs:
                normals = g.read_accessor(attrs["NORMAL"]).astype(np.float32)
            else:
                normals = np.zeros_like(positions)
                normals[:, 1] = 1.0
            uvs = (
                g.read_accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs
                else None
            )
            if "indices" in prim:
                indices = g.read_accessor(prim["indices"]).reshape(-1).astype(np.uint32)
            else:
                indices = np.arange(len(positions), dtype=np.uint32)

            prim_id = builder.add_primitive(
                positions, normals, uvs, indices, bucket, uv_scaling
            )
            builder.add_instance(
                prim_id,
                material_id_base + mat_idx,
                translation=t,
                scale=s,
                rotation=q,
            )

    # --- materials (src/model_loading.rs:166-334) ---------------------------
    image_cache: dict[tuple[int, bool], int] = {}
    bundle_cache: dict[tuple, list[int]] = {}
    raw_cache: dict[int, np.ndarray] = {}

    def raw_image(image_index: int) -> np.ndarray:
        if image_index not in raw_cache:
            raw_cache[image_index] = g.read_image(image_index)
        return raw_cache[image_index]

    # images already resolved/loaded as sRGB, in LOAD ORDER — a DontCare
    # slot reuses an sRGB decode of the same image iff one exists at the
    # point it loads, exactly like the reference's sequential
    # image_index_to_id lookup (src/model_loading.rs:179-194; field
    # evaluation order puts specular_colour before specular, :274-291)
    srgb_images: set[int] = set()

    def resolve(tex_info, srgb_requirement):
        """tex_info -> (image_index, srgb) or None; srgb_requirement:
        True / False / None (= DontCare, src/model_loading.rs:179-194)."""
        if tex_info is None:
            return None
        tex = doc["textures"][tex_info["index"]]
        image_index = tex.get("source", 0)
        if srgb_requirement is None:
            if image_index in srgb_images:
                return (image_index, True)
            srgb = False
        else:
            srgb = srgb_requirement
        if srgb:
            srgb_images.add(image_index)
        return (image_index, srgb)

    def load_texture(tex_info, srgb_requirement) -> int:
        key = resolve(tex_info, srgb_requirement)
        if key is None:
            return -1
        if key not in image_cache:
            image_cache[key] = builder.add_texture(
                raw_image(key[0]), srgb=key[1]
            )
        return image_cache[key]

    def load_material_set(slot_infos: list, allow_bundle: bool) -> list[int]:
        """Resolve a material's SAMPLED texture slots, auto-bundling
        same-size images into one atlas entry so the deferred material
        tap pays one gather for the whole set (scene/textures.py).

        ``allow_bundle`` is the SCENE-WIDE viability verdict (see the
        pre-pass below): bundling is all-or-nothing because a single
        material whose sampled slots reference mixed-size/multiple
        images makes compute_slot_bundles return () for the whole
        scene — the atlas rows would then carry L layers that every
        per-slot tap pays for with zero sharing benefit."""
        keys = [resolve(info, srgb) for info, srgb in slot_infos]
        sizes = {}
        for k in keys:
            if k is not None:
                sizes.setdefault(raw_image(k[0]).shape[:2], []).append(k)
        # bundle the largest same-size group when it has >= 2 DISTINCT
        # members (dedup first: a material reusing one image in two
        # slots must go through the per-image cache, not a 1-layer
        # bundle that would duplicate its texels in the atlas)
        bundle_keys: list = []
        if sizes and allow_bundle:
            best = list(dict.fromkeys(max(sizes.values(), key=len)))
            if len(best) >= 2:
                bundle_keys = best
        refs = []
        if bundle_keys:
            bk = tuple(bundle_keys)
            if bk not in bundle_cache:
                bundle_cache[bk] = builder.add_texture_bundle(
                    [(raw_image(i), s) for i, s in bundle_keys]
                )
            layer_of = dict(zip(bundle_keys, bundle_cache[bk]))
        else:
            layer_of = {}
        for k, (info, srgb) in zip(keys, slot_infos):
            if k is None:
                refs.append(-1)
            elif k in layer_of:
                refs.append(layer_of[k])
            else:
                refs.append(load_texture(info, srgb))
        return refs

    def _slot_infos_of(mat):
        pbr = mat.get("pbrMetallicRoughness", {})
        ext = mat.get("extensions", {})
        transmission = ext.get("KHR_materials_transmission")
        volume = ext.get("KHR_materials_volume")
        specular = ext.get("KHR_materials_specular")
        return [
            (pbr.get("baseColorTexture"), True),
            (pbr.get("metallicRoughnessTexture"), False),
            (mat.get("normalTexture"), False),
            (mat.get("emissiveTexture"), True),
            ((transmission or {}).get("transmissionTexture"), False),
            ((volume or {}).get("thicknessTexture"), False),
            ((specular or {}).get("specularColorTexture"), True),
            ((specular or {}).get("specularTexture"), None),
        ]

    # Bundling viability pre-pass (see load_material_set): every
    # material's sampled slots must reference same-size images, or no
    # material bundles. Resolution here is side-effect-light (only the
    # srgb_images ordering set, which the real pass repeats in the same
    # order, so DontCare decisions are identical).
    allow_bundle = True
    for mat in materials:
        ks = [k for k in (
            resolve(info, srgb) for info, srgb in _slot_infos_of(mat)
        ) if k is not None]
        if len({raw_image(k[0]).shape[:2] for k in ks}) > 1:
            allow_bundle = False
    srgb_images.clear()  # the real pass re-derives the same order

    for mat in materials:
        pbr = mat.get("pbrMetallicRoughness", {})
        ext = mat.get("extensions", {})
        transmission = ext.get("KHR_materials_transmission")
        volume = ext.get("KHR_materials_volume")
        specular = ext.get("KHR_materials_specular")
        ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)

        # sampled slots auto-bundle per material (occlusion is loaded but
        # never sampled — matching the reference — so it stays standalone
        # rather than widening every bundle row)
        (
            ref_diffuse, ref_mr, ref_normal, ref_emissive,
            ref_transmission, ref_thickness, ref_spec_col, ref_spec,
        ) = load_material_set(_slot_infos_of(mat), allow_bundle)
        builder.add_material(
            tex_diffuse=ref_diffuse,
            tex_metallic_roughness=ref_mr,
            tex_normal_map=ref_normal,
            tex_emissive=ref_emissive,
            tex_occlusion=load_texture(mat.get("occlusionTexture"), False),
            tex_transmission=ref_transmission,
            tex_thickness=ref_thickness,
            tex_specular_colour=ref_spec_col,
            tex_specular=ref_spec,
            metallic_factor=pbr.get("metallicFactor", 1.0),
            roughness_factor=(
                roughness_override
                if roughness_override is not None
                else pbr.get("roughnessFactor", 1.0)
            ),
            alpha_clipping_cutoff=mat.get("alphaCutoff", 0.5),
            diffuse_factor=tuple(pbr.get("baseColorFactor", (1.0, 1.0, 1.0, 1.0))),
            emissive_factor=tuple(mat.get("emissiveFactor", (0.0, 0.0, 0.0))),
            normal_map_scale=(mat.get("normalTexture") or {}).get("scale", 0.0),
            occlusion_strength=(mat.get("occlusionTexture") or {}).get("strength", 1.0),
            index_of_refraction=ior,
            transmission_factor=(transmission or {}).get("transmissionFactor", 0.0),
            thickness_factor=(volume or {}).get("thicknessFactor", 0.0),
            attenuation_distance=(
                (volume or {}).get("attenuationDistance", np.inf) * base_scale
                if volume is not None
                else np.inf
            ),
            attenuation_colour=tuple(
                (volume or {}).get("attenuationColor", (1.0, 1.0, 1.0))
            ),
            specular_factor=(specular or {}).get("specularFactor", 1.0),
            specular_colour_factor=tuple(
                (specular or {}).get("specularColorFactor", (1.0, 1.0, 1.0))
            ),
        )

    if needs_default_material:
        # the glTF default material, at local index len(materials)
        builder.add_material()

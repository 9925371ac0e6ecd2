"""Scene packing: Scene graph -> static device buffers — the port's copy of
the JAX package's `pipeline/scene_pack.py` (the same pools, bit for bit).

The D3D12 engine re-binds vertex/index buffers, per-object constant buffers
and material descriptor tables per draw call (GBufferPass::DrawModel,
DeferredPipeline.cpp:155-185). Here the whole scene becomes a handful of
padded, device-resident pools:

* one global vertex pool (positions/normals/tangents/uvs + instance id),
* one triangle pool (vertex indices + per-triangle material id),
* per-instance transforms uploaded per frame (a (I, 4, 4) f32 array — the
  analog of the triple-buffered instance constant buffers),
* a material table mirroring ConstantBufferInstance (IPipeline.h:63-90),
* one packed u32 texture atlas with a per-texture mip offset table.

`pack_scene` reads the scene by attribute only (models, materials,
textures, lights), so a scene built with either package's classes packs to
the same arrays.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace

import numpy as np

from ..config import RenderConfig
from ..resource.formats import is_srgb
from ..resource.storage import TextureData
from ..utils import mathlib as ml

MAX_MIPS = 13

# Texture page geometry (ops/texcache.py): every mip is stored as a grid of
# 16x8-texel pages, 128 quad records each (2 KB) — the unit of page staging
# for the software texture cache, and the layout both samplers address.
PAGE_W = 16
PAGE_H = 8
PAGE_RECORDS = PAGE_W * PAGE_H


@dataclass
class MaterialTable:
    """Struct-of-arrays mirror of ConstantBufferInstance + texture bindings."""

    albedo: np.ndarray        # (M, 3) f32
    emission: np.ndarray      # (M,) f32
    roughness: np.ndarray     # (M,) f32
    metallic: np.ndarray      # (M,) f32
    use_map: np.ndarray       # (M, 5) bool: albedo, normal, metallic, roughness, ao
    tex_ids: np.ndarray       # (M, 5) int32 atlas texture ids (-1 none)


@dataclass
class TextureAtlas:
    """All scene textures packed into one u32 RGBA pool (mips inline).

    `data` stores, for every texel, its 2x2 wrap-addressed bilinear
    neighborhood [(y,x), (y,x+1), (y+1,x), (y+1,x+1)] as one 16-byte record —
    the software analog of a texture unit's neighborhood fetch: a bilinear
    tap costs ONE gather instead of four (4x memory, 4x fewer fetches).

    Records are ordered PAGE-MAJOR: each mip is padded to a whole grid of
    16x8-texel pages and stored page by page (row-major pages, row-major
    texels inside a page). A page = 128 contiguous records = one 2 KB
    staging unit for the texture-cache kernel. The record address of texel
    (x, y) of mip m is
        page_base[t, m]*128 + ((y>>3)*pages_x + (x>>4))*128 + (y&7)*16 + (x&15)
    with pages_x = ceil(mip_width/16)."""

    data: np.ndarray          # (N, 4) uint32, R | G<<8 | B<<16 | A<<24
    page_base: np.ndarray     # (T, MAX_MIPS) int32 page offsets (clamped to last mip)
    base_size: np.ndarray     # (T, 2) int32 (w, h)
    n_mips: np.ndarray        # (T,) int32
    srgb: np.ndarray          # (T,) bool

    @classmethod
    def empty(cls) -> "TextureAtlas":
        return cls(
            np.zeros((PAGE_RECORDS, 4), np.uint32),
            np.zeros((1, MAX_MIPS), np.int32),
            np.ones((1, 2), np.int32),
            np.ones(1, np.int32),
            np.zeros(1, bool),
        )


@dataclass
class PackedScene:
    # vertex pool
    positions: np.ndarray     # (V, 3)
    normals: np.ndarray       # (V, 3)
    tangents: np.ndarray      # (V, 3)
    uvs: np.ndarray           # (V, 2)
    vtx_instance: np.ndarray  # (V,) int32
    # triangle pool
    tris: np.ndarray          # (T, 3) int32
    tri_material: np.ndarray  # (T,) int32
    tri_instance: np.ndarray  # (T,) int32
    tri_valid: np.ndarray     # (T,) bool (pool padding mask)
    # instances
    instance_count: int
    model_mats: np.ndarray    # (I, 4, 4)
    inv_model_mats: np.ndarray
    instance_bounds: np.ndarray  # (I, 2, 3) world AABB
    # materials + textures
    materials: MaterialTable
    atlas: TextureAtlas
    # lights (committed per frame like ClusteredPass, here pre-packed)
    light_pos: np.ndarray     # (L, 3)
    light_color: np.ndarray   # (L, 3)
    light_intensity: np.ndarray  # (L,)
    light_attenuation: np.ndarray  # (L, 4) radius, kc, kl, kq
    light_bounds: np.ndarray  # (L, 2, 3) world AABB (culling radius box)
    light_count: int
    # the EFFECTIVE config: equals the caller's config unless the scene
    # outgrew the configured pools (then max_vertices/max_triangles reflect
    # the actual pool sizes — callers should adopt this one)
    config: RenderConfig | None = None

    def instance_visibility(self, planes: np.ndarray) -> np.ndarray:
        """Frustum visibility per instance (Scene::CullModel analog)."""
        n = self.instance_count
        if n == 0:
            return np.zeros(self.model_mats.shape[0], bool)
        mask = ml.frustum_cull_aabbs(
            planes, self.instance_bounds[:n, 0], self.instance_bounds[:n, 1]
        )
        out = np.zeros(self.model_mats.shape[0], bool)
        out[:n] = mask
        return out

    def visible_lights(self, planes: np.ndarray) -> np.ndarray:
        """Frustum mask over lights (ClusteredPass CPU cull analog)."""
        if self.light_count == 0:
            return np.zeros(self.light_pos.shape[0], bool)
        mask = ml.frustum_cull_aabbs(
            planes,
            self.light_bounds[: self.light_count, 0],
            self.light_bounds[: self.light_count, 1],
        )
        out = np.zeros(self.light_pos.shape[0], bool)
        out[: self.light_count] = mask
        return out


_SEMANTICS = ("AlbedoMap", "NormalMap", "MetallicMap", "RoughnessMap", "AmbientOcclusionMap")
_USE_FLAGS = ("UseAlbedoMap", "UseNormalMap", "UseMetallicMap", "UseRoughnessMap",
              "UseAmbientOcclusionMap")


def _texture_to_rgba_u32_mips(tex: TextureData, max_dim: int | None) -> list[np.ndarray]:
    """All mips of a texture as packed u32 RGBA images, optionally skipping
    mips above `max_dim` (atlas memory control; sampling starts lower)."""
    mips = []
    for m in range(tex.mip_levels):
        a = tex.mip_array_rgba(m)
        h, w = a.shape[:2]
        if max_dim is not None and max(h, w) > max_dim:
            continue
        c = a.shape[-1]
        if a.dtype != np.uint8:
            a = np.clip(a.astype(np.float32) * 255 + 0.5, 0, 255).astype(np.uint8)
        rgba = np.zeros((h, w, 4), np.uint8)
        rgba[..., :c] = a
        if c == 1:  # R8: replicate into rgb like a .r swizzle read
            rgba[..., 1] = rgba[..., 2] = rgba[..., 0]
            rgba[..., 3] = 255
        elif c < 4:
            rgba[..., 3] = 255
        packed = (
            rgba[..., 0].astype(np.uint32)
            | (rgba[..., 1].astype(np.uint32) << 8)
            | (rgba[..., 2].astype(np.uint32) << 16)
            | (rgba[..., 3].astype(np.uint32) << 24)
        )
        # quad record: texel + its wrap-addressed right/down/diag neighbors
        right = np.roll(packed, -1, axis=1)
        down = np.roll(packed, -1, axis=0)
        diag = np.roll(right, -1, axis=0)
        mips.append(np.stack([packed, right, down, diag], axis=-1))
    if not mips:  # texture smaller than max_dim filter edge case
        mips.append(np.zeros((1, 1, 4), np.uint32))
    return mips


def _page_major(quads: np.ndarray) -> np.ndarray:
    """(h, w, 4) quad records -> (pages*128, 4) page-major layout.

    Pads the mip to whole 16x8 pages (padding records are never addressed:
    texel coordinates are wrapped to the logical w/h before paging)."""
    h, w = quads.shape[:2]
    ph = (h + PAGE_H - 1) // PAGE_H * PAGE_H
    pw = (w + PAGE_W - 1) // PAGE_W * PAGE_W
    if (ph, pw) != (h, w):
        padded = np.zeros((ph, pw, 4), quads.dtype)
        padded[:h, :w] = quads
        quads = padded
    return (
        quads.reshape(ph // PAGE_H, PAGE_H, pw // PAGE_W, PAGE_W, 4)
        .transpose(0, 2, 1, 3, 4)
        .reshape(-1, 4)
    )


class _AtlasBuilder:
    def __init__(self, max_dim: int | None = None):
        self.chunks: list[np.ndarray] = []
        self.offsets: list[list[int]] = []
        self.sizes: list[tuple[int, int]] = []
        self.mips: list[int] = []
        self.srgb: list[bool] = []
        self.cursor = 0
        # dedup by object identity; the tuple value keeps a strong reference
        # to the texture so a freed object's id can never alias a cached key
        self.cache: dict[int, tuple[int, TextureData]] = {}
        self.max_dim = max_dim

    def add(self, tex: TextureData) -> int:
        key = id(tex)
        if key in self.cache:
            return self.cache[key][0]
        mips = _texture_to_rgba_u32_mips(tex, self.max_dim)
        offs = []
        for m in mips:
            offs.append(self.cursor)
            paged = _page_major(m)
            self.chunks.append(paged)
            self.cursor += paged.shape[0] // PAGE_RECORDS
        n_real = len(mips)
        if mips[-1].shape[:2] != (1, 1):
            # mip chains that stop above 1x1 get a synthetic average-color
            # page appended PAST the sampled chain (page_base[n_mips] points
            # here; sampling clamps to n_mips-1 and never sees it). It is the
            # texture-cache fallback target, which addresses as a 1x1 mip —
            # without it, overflow taps would read texel (0,0) of a large mip
            # with wrong bilinear fracs (ops/texcache.fused_tex_table).
            last = mips[-1][..., 0]
            avg = np.zeros(4, np.uint64)
            for c in range(4):
                avg[c] = ((last >> np.uint32(8 * c)) & np.uint32(0xFF)).mean()
            avg_u32 = np.uint32(
                avg[0] | (avg[1] << 8) | (avg[2] << 16) | (avg[3] << 24)
            )
            offs.append(self.cursor)
            page = np.zeros((PAGE_RECORDS, 4), np.uint32)
            page[0, :] = avg_u32  # all 4 quad entries = avg (1x1 wrap)
            self.chunks.append(page)
            self.cursor += 1
        tid = len(self.sizes)
        self.offsets.append(offs)
        self.sizes.append((mips[0].shape[1], mips[0].shape[0]))
        self.mips.append(n_real)
        self.srgb.append(is_srgb(tex.format))
        self.cache[key] = (tid, tex)
        return tid

    def build(self) -> TextureAtlas:
        if not self.sizes:
            return TextureAtlas.empty()
        n = len(self.sizes)
        off = np.zeros((n, MAX_MIPS), np.int32)
        for i, o in enumerate(self.offsets):
            for m in range(MAX_MIPS):
                off[i, m] = o[min(m, len(o) - 1)]
        return TextureAtlas(
            np.concatenate(self.chunks, axis=0).astype(np.uint32),
            off,
            np.asarray(self.sizes, np.int32),
            np.asarray(self.mips, np.int32),
            np.asarray(self.srgb, bool),
        )


def pack_scene(
    scene, config: RenderConfig, atlas_max_dim: int | None = None
) -> PackedScene:
    atlas = _AtlasBuilder(atlas_max_dim)
    mat_albedo, mat_emission, mat_rough, mat_metal = [], [], [], []
    mat_use, mat_tex = [], []

    positions, normals, tangents, uvs, vtx_inst = [], [], [], [], []
    tris, tri_mat, tri_inst = [], [], []
    model_mats, inv_mats, bounds = [], [], []

    vbase = 0
    instance_id = 0
    models = [m for m in scene.models if m.model is not None]
    for sm in models:
        mesh = sm.model.mesh_resource.mesh
        va = mesh.vertex_array()
        idx = mesh.index_array().astype(np.int64)
        positions.append(va["position"])
        normals.append(va["normal"])
        tangents.append(va["tangent"])
        uvs.append(va["uv"])
        vtx_inst.append(np.full(va.size, instance_id, np.int32))

        for si, sub in enumerate(mesh.sub_meshes):
            mat = (
                sm.model.materials[si]
                if si < len(sm.model.materials)
                else None
            )
            mat_id = len(mat_albedo)
            # ConstantBufferInstance defaults (IPipeline.h:68-73) overridden
            # by the material parameter table (ApplyShaderParameter)
            def param(name, default):
                return (mat.get_parameter(name, default) if mat else default)

            mat_albedo.append(np.asarray(param("Albedo", (1.0, 1.0, 1.0)), np.float32))
            mat_emission.append(float(param("Emission", 0.0)))
            mat_rough.append(float(param("Roughness", 1.0)))
            mat_metal.append(float(param("Metallic", 0.0)))
            use = [bool(param(f, False)) for f in _USE_FLAGS]
            tids = []
            for k, sem in enumerate(_SEMANTICS):
                tex_res = mat.textures.get(sem) if mat else None
                if use[k] and tex_res is not None and tex_res.texture is not None:
                    tids.append(atlas.add(tex_res.texture))
                else:
                    use[k] = False
                    tids.append(-1)
            mat_use.append(use)
            mat_tex.append(tids)

            sub_idx = idx[sub.index : sub.index + sub.indices_count].reshape(-1, 3)
            tris.append(sub_idx + vbase)
            tri_mat.append(np.full(len(sub_idx), mat_id, np.int32))
            tri_inst.append(np.full(len(sub_idx), instance_id, np.int32))

        model_mats.append(sm.world_matrix.astype(np.float32))
        inv_mats.append(np.linalg.inv(sm.world_matrix).astype(np.float32))
        bmin, bmax = sm.world_bound()
        bounds.append(np.stack([bmin, bmax]))
        vbase += va.size
        instance_id += 1

    def cat(parts, empty_shape, dtype):
        if parts:
            return np.ascontiguousarray(np.concatenate(parts)).astype(dtype)
        return np.zeros(empty_shape, dtype)

    pos = cat(positions, (0, 3), np.float32)
    nrm = cat(normals, (0, 3), np.float32)
    tan = cat(tangents, (0, 3), np.float32)
    uv = cat(uvs, (0, 2), np.float32)
    vinst = cat(vtx_inst, (0,), np.int32)
    tri = cat(tris, (0, 3), np.int32)
    tmat = cat(tri_mat, (0,), np.int32)
    tinst = cat(tri_inst, (0,), np.int32)

    v, t = pos.shape[0], tri.shape[0]
    # the configured limits are pool MINIMUMS; bigger scenes (Sponza-class,
    # 260k+ triangles) auto-grow the static pools to the next 8k multiple —
    # a per-scene compile-time constant, exactly like sizing a vertex heap.
    # Growth is surfaced (warning + PackedScene.config) so configured limits
    # never silently stop bounding memory/compile cost.
    if v > config.max_vertices or t > config.max_triangles:
        grown_v = max(config.max_vertices, -(-v // 8192) * 8192)
        grown_t = max(config.max_triangles, -(-t // 8192) * 8192)
        logging.getLogger(__name__).warning(
            "scene exceeds configured pools (vertices %d > %d or triangles "
            "%d > %d); growing pools to %d vertices / %d triangles",
            v, config.max_vertices, t, config.max_triangles, grown_v, grown_t,
        )
        config = replace(config, max_vertices=grown_v, max_triangles=grown_t)

    def pad(a, n, fill=0):
        out = np.full((n, *a.shape[1:]), fill, a.dtype)
        out[: len(a)] = a
        return out

    n_inst = max(instance_id, 1)
    mats = MaterialTable(
        albedo=np.stack(mat_albedo) if mat_albedo else np.ones((1, 3), np.float32),
        emission=np.asarray(mat_emission or [0.0], np.float32),
        roughness=np.asarray(mat_rough or [1.0], np.float32),
        metallic=np.asarray(mat_metal or [0.0], np.float32),
        use_map=np.asarray(mat_use or [[False] * 5], bool),
        tex_ids=np.asarray(mat_tex or [[-1] * 5], np.int32),
    )

    # lights (padded to config.max_lights, like the MaxSceneLights array)
    lights = scene.lights[: config.max_lights]
    lp = np.zeros((config.max_lights, 3), np.float32)
    lc = np.zeros((config.max_lights, 3), np.float32)
    li = np.zeros(config.max_lights, np.float32)
    la = np.ones((config.max_lights, 4), np.float32)
    lb = np.zeros((config.max_lights, 2, 3), np.float32)
    for i, l in enumerate(lights):
        lp[i] = l.translation
        lc[i] = l.color
        li[i] = l.intensity
        la[i] = l.attenuation
        bmin, bmax = l.world_bound()
        lb[i, 0], lb[i, 1] = bmin, bmax

    return PackedScene(
        positions=pad(pos, config.max_vertices),
        normals=pad(nrm, config.max_vertices),
        tangents=pad(tan, config.max_vertices),
        uvs=pad(uv, config.max_vertices),
        vtx_instance=pad(vinst, config.max_vertices),
        tris=pad(tri, config.max_triangles),
        tri_material=pad(tmat, config.max_triangles),
        tri_instance=pad(tinst, config.max_triangles),
        tri_valid=pad(np.ones(t, bool), config.max_triangles, False),
        instance_count=instance_id,
        model_mats=np.stack(model_mats) if model_mats else np.eye(4, dtype=np.float32)[None],
        inv_model_mats=np.stack(inv_mats) if inv_mats else np.eye(4, dtype=np.float32)[None],
        instance_bounds=np.stack(bounds) if bounds else np.zeros((1, 2, 3), np.float32),
        materials=mats,
        atlas=atlas.build(),
        light_pos=lp,
        light_color=lc,
        light_intensity=li,
        light_attenuation=la,
        light_bounds=lb,
        light_count=len(lights),
        config=config,
    )

"""ResourceLoader: cached JSON/binary asset IO + importers — the port's copy
of the JAX package's `resource/loader.py`.

One addition: `missing_file(cls, repo_path)`, the first file that loading a
resource would open and that does not exist. The materials, scene models and
skyboxes that skip a missing asset check with it before they load (the JAX
package catches the load's FileNotFoundError instead).

Equivalent of `Engine/Include/Resource/ResourceLoader.h` +
`Engine/Source/Resource/ResourceLoader.cpp`:

* repo paths are extensionless, resolved against an asset root, with `.json`
  appended for descriptors and `.bin` for blobs (ResourceLoader.h:48,84);
  Windows-style backslashes in shipped assets are normalized.
* `import_model` parses Wavefront .obj (pure-python tinyobj equivalent),
  groups triangles by material, computes per-triangle tangents, recenters and
  scales, and emits Mesh/Material/Model descriptors (ResourceLoader.cpp:18-250).
* `import_texture` loads .png/.jpg via PIL or .hdr via the built-in Radiance
  parser, builds a mip chain, and stores it (BC-compressed on serialize).
* `import_cubemap` loads px/nx/py/ny/pz/nz.hdr faces and bakes SH
  (ResourceLoader.cpp:408-428).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from . import reflection_def  # noqa: F401 — attaches FIELDS/custom hooks
from .formats import ETextureFormat
from .hdr import load_hdr
from .resources import (
    CubeMapResource,
    IResource,
    MaterialResource,
    MeshResource,
    ModelResource,
    TextureResource,
)
from .serialization import (
    Reader,
    binary_deserialize,
    binary_serialize,
    json_deserialize,
    json_serialize,
)
from .storage import (
    CubeMapTextureData,
    EVertexFormat,
    MeshData,
    STANDARD_VERTEX_DTYPE,
    SubMeshData,
    TextureData,
)


class ResourceLoader:
    _instance: "ResourceLoader | None" = None

    def __init__(self, asset_root: str | Path = "."):
        self.asset_root = Path(asset_root)
        self._cache: dict[str, IResource] = {}

    # -- singleton management (ResourceLoader.h:13-16) -----------------------
    @classmethod
    def instance(cls) -> "ResourceLoader":
        if cls._instance is None:
            cls._instance = ResourceLoader()
        return cls._instance

    @classmethod
    def set_instance(cls, loader: "ResourceLoader") -> "ResourceLoader":
        cls._instance = loader
        return loader

    # -- path handling -------------------------------------------------------
    def resolve(self, repo_path: str, ext: str) -> Path:
        rel = repo_path.replace("\\", "/")
        rel = os.path.splitext(rel)[0] + ext
        p = self.asset_root / rel
        if not p.exists():
            # shipped assets mix directory case (Asset/Skybox vs Asset/SkyBox)
            alt = _case_insensitive_lookup(self.asset_root, rel)
            if alt is not None:
                return alt
        return p

    # -- generic IO (ResourceLoader.h:39-136) ---------------------------------
    def load_resource(self, cls, repo_path: str):
        key = repo_path.replace("\\", "/")
        if key in self._cache:
            return self._cache[key]
        with open(self.resolve(repo_path, ".json"), "r") as f:
            data = json.load(f)
        obj = cls.__new__(cls)
        obj.init_defaults()
        obj.repo_path = key
        # cache before post_deserialized so cyclic references resolve
        self._cache[key] = obj
        json_deserialize(cls, data, obj)
        return obj

    def missing_file(self, cls, repo_path: str) -> Path | None:
        """The first file that `load_resource(cls, repo_path)` would open and
        that does not exist, or None. A cached resource opens nothing. A
        mesh, texture or cubemap resource opens its descriptor and its blob;
        a model also its mesh resource and its materials' descriptors (a
        material skips its own missing textures); others their descriptor."""
        if repo_path.replace("\\", "/") in self._cache:
            return None
        path = self.resolve(repo_path, ".json")
        if not path.exists():
            return path
        if issubclass(cls, ModelResource):
            with open(path, "r") as f:
                data = json.load(f)
            subs = [(MeshResource, data.get("mMeshPath", ""))]
            subs += [(MaterialResource, p) for p in data.get("mMaterialPath", [])]
            for sub_cls, sub in subs:
                missing = self.missing_file(sub_cls, sub)
                if missing is not None:
                    return missing
            return None
        blob_key = {MeshResource: "mMeshPath", TextureResource: "mTexturePath",
                    CubeMapResource: "mTexturePath"}.get(cls)
        if blob_key is None:
            return None
        with open(path, "r") as f:
            blob = self.resolve(json.load(f).get(blob_key, ""), ".bin")
        return None if blob.exists() else blob

    def load_binary(self, cls, repo_path: str):
        with open(self.resolve(repo_path, ".bin"), "rb") as f:
            return binary_deserialize(cls, Reader(f.read()))

    def dump_binary(self, obj, repo_path: str) -> None:
        path = self.resolve(repo_path, ".bin")
        path.parent.mkdir(parents=True, exist_ok=True)
        out = bytearray()
        binary_serialize(obj, out)
        path.write_bytes(bytes(out))

    def dump_json(self, obj, repo_path: str) -> None:
        path = self.resolve(repo_path, ".json")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(json_serialize(obj), indent=4, sort_keys=True) + "\n")

    def dump_resource(self, res: IResource) -> None:
        self.dump_json(res, res.repo_path)

    # -- importers ------------------------------------------------------------
    def import_texture(
        self, file_path: str | Path, repo_path: str, fmt: ETextureFormat | None = None
    ) -> TextureResource | None:
        file_path = Path(file_path)
        if not file_path.exists():
            return None
        tex = load_image_file(file_path, fmt)
        if tex is None:
            return None
        data_path = generate_data_path(repo_path)
        self.dump_binary(tex, data_path)
        res = TextureResource(repo_path, data_path)
        res.texture = tex
        self.dump_resource(res)
        self._cache[repo_path] = res
        return res

    def import_cubemap(self, folder: str | Path, repo_path: str) -> CubeMapResource:
        """Folder containing px/nx/py/ny/pz/nz.hdr (ResourceLoader.cpp:408-428)."""
        folder = Path(folder)
        faces = []
        for name in ("px.hdr", "nx.hdr", "py.hdr", "ny.hdr", "pz.hdr", "nz.hdr"):
            tex = load_image_file(folder / name)
            assert tex is not None, f"missing cubemap face {name}"
            faces.append(tex)
        cube = CubeMapTextureData(faces=faces)
        data_path = generate_data_path(repo_path)
        self.dump_binary(cube, data_path)
        res = CubeMapResource(repo_path, data_path)
        res.cubemap = cube
        self.dump_resource(res)
        self._cache[repo_path] = res
        return res

    def import_model(
        self,
        file_path: str | Path,
        repo_path: str,
        scale: float = 1.0,
        flip_uv_y: bool = False,
    ) -> ModelResource | None:
        """Wavefront .obj -> Mesh + Material + Model resources
        (ResourceLoader.cpp:18-250)."""
        file_path = Path(file_path)
        if not file_path.exists():
            return None
        obj = parse_obj(file_path)
        trimmed = os.path.splitext(repo_path)[0]

        meshes: list[list[np.ndarray]] = [[] for _ in range(max(1, len(obj.materials)))]
        center = np.zeros(3, np.float64)
        total = 0
        for shape in obj.shapes:
            for tri, mat_id in zip(shape.triangles, shape.material_ids):
                meshes[max(mat_id, 0)].append(tri)
                center += tri["position"].sum(axis=0)
                total += 3

        vertices_parts = []
        sub_meshes = []
        index_begin = 0
        for group in meshes:
            if group:
                arr = np.concatenate(group)
            else:
                arr = np.empty(0, dtype=STANDARD_VERTEX_DTYPE)
            # per-triangle tangents (ResourceLoader.cpp:100-114, 510-531)
            v = arr.reshape(-1, 3)
            if v.size:
                tangents = calculate_tangents(
                    v["position"][:, 0], v["position"][:, 1], v["position"][:, 2],
                    v["uv"][:, 0], v["uv"][:, 1], v["uv"][:, 2],
                )
                arr["tangent"] = np.repeat(tangents, 3, axis=0)
            sub_meshes.append(SubMeshData(index_begin, arr.size))
            index_begin += arr.size
            vertices_parts.append(arr)

        vertices = np.concatenate(vertices_parts)
        if flip_uv_y:
            vertices["uv"][:, 1] = 1.0 - vertices["uv"][:, 1]
        center = (center / max(total, 1)).astype(np.float32)
        vertices["position"] = (vertices["position"] - center) * scale
        bound_min = vertices["position"].min(axis=0)
        bound_max = vertices["position"].max(axis=0)
        indices = np.arange(vertices.size, dtype=np.uint32)

        mesh_path = trimmed + "_Mesh"
        mesh_data_path = generate_data_path(mesh_path)
        mesh = MeshData.from_arrays(
            EVertexFormat.P3F_N3F_T3F_C3F_T2F, vertices, indices, sub_meshes,
            bound_min, bound_max,
        )
        self.dump_binary(mesh, mesh_data_path)
        mesh_res = MeshResource(mesh_path, mesh_data_path)
        mesh_res.mesh = mesh
        self.dump_resource(mesh_res)

        mats = []
        src_folder = file_path.parent
        for i, m in enumerate(obj.materials):
            mat = MaterialResource(f"{trimmed}_Mat_{i}")
            mat.set_shader("gbuffer.hlsl")
            for semantic, flag, texname in (
                ("AlbedoMap", "UseAlbedoMap", m.get("map_Kd")),
                ("NormalMap", "UseNormalMap", m.get("norm")),
                ("RoughnessMap", "UseRoughnessMap", m.get("map_Pr")),
                ("MetallicMap", "UseMetallicMap", m.get("map_Pm")),
                ("AmbientOcclusionMap", "UseAmbientOcclusionMap", m.get("map_Ka")),
            ):
                if not texname:
                    continue
                tex = self.import_texture(
                    src_folder / texname, f"{trimmed}_{texname}"
                )
                mat.set_parameter(flag, tex is not None)
                if tex is not None:
                    mat.set_texture(semantic, tex)
            mats.append(mat)
            self.dump_resource(mat)

        model = ModelResource(f"{trimmed}_Model", mesh_res, mats)
        self.dump_resource(model)
        return model


def generate_data_path(repo_path: str) -> str:
    """`<dir>/<stem>_data` (ResourceLoader.cpp:459-467)."""
    p = Path(repo_path.replace("\\", "/"))
    return str(p.parent / f"{p.stem}_data")


def _case_insensitive_lookup(root: Path, rel: str) -> Path | None:
    cur = root
    for part in Path(rel).parts:
        if (cur / part).exists():
            cur = cur / part
            continue
        matches = [c for c in cur.iterdir() if c.name.lower() == part.lower()] if cur.is_dir() else []
        if not matches:
            return None
        cur = matches[0]
    return cur


# ---------------------------------------------------------------------------
# Image loading (DirectXTex equivalent)
# ---------------------------------------------------------------------------

def load_image_file(path: str | Path, fmt: ETextureFormat | None = None) -> TextureData | None:
    from .mipmap import generate_mip_chain

    path = Path(path)
    ext = path.suffix.lower()
    if ext in (".png", ".jpg", ".jpeg"):
        from PIL import Image

        img = Image.open(path).convert("RGBA")
        arr = np.asarray(img, dtype=np.uint8)
        if arr.shape[0] % 4 or arr.shape[1] % 4:
            return None  # BC requires multiples of 4 (ResourceLoader.cpp:365)
        return generate_mip_chain(arr, fmt or ETextureFormat.R8G8B8A8_UNORM)
    if ext == ".hdr":
        rgb = load_hdr(path)  # (h, w, 3) float32
        if rgb.shape[0] % 4 or rgb.shape[1] % 4:
            return None
        rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
        return generate_mip_chain(rgba, ETextureFormat.R32G32B32A32_FLOAT)
    raise NotImplementedError(f"unsupported image format {ext}")


# ---------------------------------------------------------------------------
# Wavefront OBJ parsing (tinyobjloader equivalent, trimmed to what the
# reference importer consumes: v/vn/vt + usemtl/mtllib + map_* keys)
# ---------------------------------------------------------------------------

class _ObjShape:
    def __init__(self):
        self.triangles: list[np.ndarray] = []  # each (3,) structured verts
        self.material_ids: list[int] = []


class _ObjFile:
    def __init__(self):
        self.shapes: list[_ObjShape] = []
        self.materials: list[dict] = []


def parse_obj(path: Path) -> _ObjFile:
    positions: list[tuple] = []
    normals: list[tuple] = []
    texcoords: list[tuple] = []
    out = _ObjFile()
    mat_names: dict[str, int] = {}
    shape = _ObjShape()
    out.shapes.append(shape)
    cur_mat = -1

    def parse_index(tok: str, count: int) -> int:
        i = int(tok)
        return i - 1 if i > 0 else count + i

    mtl_files: list[Path] = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            positions.append(tuple(float(x) for x in parts[1:4]))
        elif tag == "vn":
            normals.append(tuple(float(x) for x in parts[1:4]))
        elif tag == "vt":
            texcoords.append(tuple(float(x) for x in parts[1:3]))
        elif tag == "mtllib":
            mtl_files.append(path.parent / " ".join(parts[1:]))
        elif tag == "usemtl":
            name = " ".join(parts[1:])
            if name not in mat_names:
                mat_names[name] = len(mat_names)
                out.materials.append({"name": name})
            cur_mat = mat_names[name]
        elif tag == "f":
            corners = []
            for vert in parts[1:]:
                toks = vert.split("/")
                vi = parse_index(toks[0], len(positions))
                ti = parse_index(toks[1], len(texcoords)) if len(toks) > 1 and toks[1] else -1
                ni = parse_index(toks[2], len(normals)) if len(toks) > 2 and toks[2] else -1
                corners.append((vi, ti, ni))
            # fan-triangulate
            for k in range(1, len(corners) - 1):
                tri = np.zeros(3, dtype=STANDARD_VERTEX_DTYPE)
                for j, (vi, ti, ni) in enumerate((corners[0], corners[k], corners[k + 1])):
                    tri["position"][j] = positions[vi]
                    n = np.asarray(normals[ni] if ni >= 0 else (0, 0, 1), np.float32)
                    tri["normal"][j] = n / max(np.linalg.norm(n), 1e-20)
                    tri["color"][j] = (1, 1, 1)
                    tri["uv"][j] = texcoords[ti] if ti >= 0 else (0, 0)
                shape.triangles.append(tri)
                shape.material_ids.append(cur_mat)

    # parse referenced .mtl files for texture map names
    for mtl in mtl_files:
        if not mtl.exists():
            continue
        cur = None
        for line in mtl.read_text().splitlines():
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                name = " ".join(parts[1:])
                if name not in mat_names:
                    mat_names[name] = len(mat_names)
                    out.materials.append({"name": name})
                cur = out.materials[mat_names[name]]
            elif cur is not None and parts[0] in ("map_Kd", "norm", "map_Pr", "map_Pm", "map_Ka", "map_Bump", "bump"):
                key = {"map_Bump": "norm", "bump": "norm"}.get(parts[0], parts[0])
                cur[key] = parts[-1]
    if not out.materials:
        out.materials.append({"name": "default"})
    return out


def calculate_tangents(p0, p1, p2, t0, t1, t2) -> np.ndarray:
    """Vectorized CalculateTangent (ResourceLoader.cpp:510-531): one tangent
    per triangle, (1,0,0) for degenerate/negative-determinant UVs."""
    e1 = (p1 - p0).astype(np.float64)
    e2 = (p2 - p0).astype(np.float64)
    duv1 = (t1 - t0).astype(np.float64)
    duv2 = (t2 - t0).astype(np.float64)
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    bad = det < 1e-4  # reference: det < 0.0001 -> fallback
    det_safe = np.where(bad, 1.0, det)
    tan = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) / det_safe[:, None]
    norm = np.linalg.norm(tan, axis=1, keepdims=True)
    tan = tan / np.maximum(norm, 1e-20)
    tan[bad] = (1.0, 0.0, 0.0)
    return tan.astype(np.float32)

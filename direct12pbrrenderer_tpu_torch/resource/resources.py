"""The IResource family: mesh / texture / cubemap / material / model resources
— the port's copy of the JAX package's `resource/resources.py`. One
difference: a material skips a texture whose descriptor or blob is missing
after an explicit check (`ResourceLoader.missing_file`), where the JAX
package catches the FileNotFoundError of the load; both disable the map's
Use*Map flag and leave the texture out. A quirk of the JAX loader is not
kept: it caches a texture's descriptor before its blob fails to load, so a
second map that names the same missing texture finds the half-loaded one in
the cache and keeps it (flag on, no payload); the port skips that map too.

Mirrors `Engine/Include/Resource/ResourceDef.h` + `ReflectionDef.h:86-121`:
JSON descriptor files reference sibling `.bin` blobs by repo path; on
deserialize each resource pulls its payload (and referenced sub-resources)
through the `ResourceLoader` cache. Where the reference allocates D3D12
buffers/textures in PostDeserialized, we keep numpy arrays — device placement
happens once, when the scene is packed (`pipeline.scene_pack`).
"""

from __future__ import annotations

import numpy as np

from ..utils.sh import SH2CoefficientsPack
from .serialization import FieldSpec
from .storage import CubeMapTextureData, MeshData, TextureData


class IResource:
    CPP_NAME = "IResource"
    BASE = None
    FIELDS = (FieldSpec("mRepoPath", "repo_path", "str", serializable=False),)

    def init_defaults(self):
        self.repo_path = ""

    def __init__(self, repo_path: str = ""):
        self.init_defaults()
        self.repo_path = repo_path


class MeshResource(IResource):
    """ResourceDef.h MeshResource: path to a MeshData .bin (ResourceDef.cpp:13-46)."""

    CPP_NAME = "MeshResource"
    BASE = IResource
    FIELDS = (FieldSpec("mMeshPath", "mesh_path", "str"),)

    def init_defaults(self):
        super().init_defaults()
        self.mesh_path = ""
        self.mesh: MeshData | None = None

    def __init__(self, repo_path: str = "", mesh_path: str = ""):
        super().__init__(repo_path)
        self.mesh_path = mesh_path

    def post_deserialized(self):
        from .loader import ResourceLoader

        self.mesh = ResourceLoader.instance().load_binary(MeshData, self.mesh_path)

    @property
    def bound(self) -> tuple[np.ndarray, np.ndarray]:
        return self.mesh.bound_min, self.mesh.bound_max

    @property
    def sub_meshes(self):
        return self.mesh.sub_meshes


class TextureResource(IResource):
    CPP_NAME = "TextureResource"
    BASE = IResource
    FIELDS = (FieldSpec("mTexturePath", "texture_path", "str"),)

    def init_defaults(self):
        super().init_defaults()
        self.texture_path = ""
        self.texture: TextureData | None = None

    def __init__(self, repo_path: str = "", texture_path: str = ""):
        super().__init__(repo_path)
        self.texture_path = texture_path

    def post_deserialized(self):
        from .loader import ResourceLoader

        self.texture = ResourceLoader.instance().load_binary(TextureData, self.texture_path)


class CubeMapResource(IResource):
    CPP_NAME = "CubeMapResource"
    BASE = IResource
    FIELDS = (FieldSpec("mTexturePath", "texture_path", "str"),)

    def init_defaults(self):
        super().init_defaults()
        self.texture_path = ""
        self.cubemap: CubeMapTextureData | None = None

    def __init__(self, repo_path: str = "", texture_path: str = ""):
        super().__init__(repo_path)
        self.texture_path = texture_path

    def post_deserialized(self):
        from .loader import ResourceLoader

        self.cubemap = ResourceLoader.instance().load_binary(
            CubeMapTextureData, self.texture_path
        )

    @property
    def sh(self) -> SH2CoefficientsPack:
        return self.cubemap.sh if self.cubemap else SH2CoefficientsPack()


class MaterialResource(IResource):
    """Shader path + texture bindings + ShaderParameter table
    (ResourceDef.h:160-225). Parameters apply onto the instance constant
    block by name, like ApplyShaderParameter's reflection-offset memcpy."""

    CPP_NAME = "MaterialResource"
    BASE = IResource
    FIELDS = (
        FieldSpec("mShaderPath", "shader_path", "str"),
        FieldSpec("mTexturePath", "texture_path", ("map", "str")),
        FieldSpec("mParameterTable", "parameter_table", ("map", "variant")),
    )

    def init_defaults(self):
        super().init_defaults()
        self.shader_path = ""
        self.texture_path: dict[str, str] = {}
        self.parameter_table: dict[str, object] = {}
        self.textures: dict[str, TextureResource] = {}

    def __init__(self, repo_path: str = ""):
        super().__init__(repo_path)

    def post_deserialized(self):
        from .loader import ResourceLoader

        loader = ResourceLoader.instance()
        self.textures = {}
        for semantic, path in self.texture_path.items():
            if loader.missing_file(TextureResource, _strip_ext(path)) is None:
                self.textures[semantic] = loader.load_resource(
                    TextureResource, _strip_ext(path)
                )
            else:
                # missing texture blob: disable the corresponding Use*Map flag
                flag = f"Use{semantic}"
                if self.parameter_table.get(flag):
                    self.parameter_table[flag] = False

    def set_shader(self, filename: str):
        self.shader_path = filename

    def set_parameter(self, name: str, value):
        self.parameter_table[name] = value

    def get_parameter(self, name: str, default=None):
        return self.parameter_table.get(name, default)

    def set_texture(self, semantic: str, tex: TextureResource):
        self.textures[semantic] = tex
        self.texture_path[semantic] = tex.repo_path + ".png"  # reference keeps source name


class ModelResource(IResource):
    CPP_NAME = "ModelResource"
    BASE = IResource
    FIELDS = (
        FieldSpec("mMeshPath", "mesh_path", "str"),
        FieldSpec("mMaterialPath", "material_path", ("list", "str")),
    )

    def init_defaults(self):
        super().init_defaults()
        self.mesh_path = ""
        self.material_path: list[str] = []
        self.mesh_resource: MeshResource | None = None
        self.materials: list[MaterialResource] = []

    def __init__(
        self,
        repo_path: str = "",
        mesh: MeshResource | None = None,
        materials: list[MaterialResource] | None = None,
    ):
        super().__init__(repo_path)
        if mesh is not None:
            self.mesh_resource = mesh
            self.mesh_path = mesh.repo_path
        if materials:
            self.materials = list(materials)
            self.material_path = [m.repo_path for m in materials]

    def post_deserialized(self):
        from .loader import ResourceLoader

        loader = ResourceLoader.instance()
        if self.mesh_resource is None:
            self.mesh_resource = loader.load_resource(MeshResource, self.mesh_path)
        if not self.materials:
            self.materials = [
                loader.load_resource(MaterialResource, p) for p in self.material_path
            ]

    @property
    def bound(self):
        return self.mesh_resource.bound


def _strip_ext(path: str) -> str:
    """Repo paths are extensionless; texture map values keep the source image
    extension (e.g. .png) which LoadResource replaces with .json."""
    for ext in (".png", ".jpg", ".hdr", ".json", ".bin"):
        if path.endswith(ext):
            return path[: -len(ext)]
    return path

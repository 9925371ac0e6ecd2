"""The IResource family: mesh / texture / cubemap / material / model resources
— the port's copy of the JAX package's `resource/resources.py` for scenes
built in memory.

Mirrors `Engine/Include/Resource/ResourceDef.h`: a resource holds its
payload as numpy arrays, and device placement happens once, when the scene
is packed (`pipeline.scene_pack`). Loading resources from an asset tree (the
JSON descriptors, the `.bin` blobs, the loader cache) is not part of the port
yet: ROADMAP module item 9.
"""

from __future__ import annotations

import numpy as np

from ..utils.sh import SH2CoefficientsPack
from .storage import CubeMapTextureData, MeshData, TextureData


class IResource:
    def init_defaults(self):
        self.repo_path = ""

    def __init__(self, repo_path: str = ""):
        self.init_defaults()
        self.repo_path = repo_path


class MeshResource(IResource):
    """ResourceDef.h MeshResource: a MeshData payload (ResourceDef.cpp:13-46)."""

    def init_defaults(self):
        super().init_defaults()
        self.mesh_path = ""
        self.mesh: MeshData | None = None

    def __init__(self, repo_path: str = "", mesh_path: str = ""):
        super().__init__(repo_path)
        self.mesh_path = mesh_path

    @property
    def bound(self) -> tuple[np.ndarray, np.ndarray]:
        return self.mesh.bound_min, self.mesh.bound_max

    @property
    def sub_meshes(self):
        return self.mesh.sub_meshes


class TextureResource(IResource):
    def init_defaults(self):
        super().init_defaults()
        self.texture_path = ""
        self.texture: TextureData | None = None

    def __init__(self, repo_path: str = "", texture_path: str = ""):
        super().__init__(repo_path)
        self.texture_path = texture_path


class CubeMapResource(IResource):
    def init_defaults(self):
        super().init_defaults()
        self.texture_path = ""
        self.cubemap: CubeMapTextureData | None = None

    def __init__(self, repo_path: str = "", texture_path: str = ""):
        super().__init__(repo_path)
        self.texture_path = texture_path

    @property
    def sh(self) -> SH2CoefficientsPack:
        return self.cubemap.sh if self.cubemap else SH2CoefficientsPack()


class MaterialResource(IResource):
    """Shader path + texture bindings + ShaderParameter table
    (ResourceDef.h:160-225). Parameters apply onto the instance constant
    block by name, like ApplyShaderParameter's reflection-offset memcpy."""

    def init_defaults(self):
        super().init_defaults()
        self.shader_path = ""
        self.texture_path: dict[str, str] = {}
        self.parameter_table: dict[str, object] = {}
        self.textures: dict[str, TextureResource] = {}

    def __init__(self, repo_path: str = ""):
        super().__init__(repo_path)

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

    @property
    def bound(self):
        return self.mesh_resource.bound

"""Scene graph: SceneObject / SceneModel / SceneLight / Scene — the port's
copy of the JAX package's `scene/scene.py`. One difference: a scene model
whose model files are missing, and a skybox whose cubemap files are missing,
are found by an explicit check (`ResourceLoader.missing_file`) before the
load, where the JAX package catches the load's FileNotFoundError. As there,
the model is left unloaded with a logged warning (which names the missing
file) and the skybox is left None.

Mirrors `Engine/Include/Renderer/Scene.h` + `Scene.cpp`: TRS objects with a
cached world matrix (built rotation->translation->scale on deserialize,
Scene.cpp:30-35), OGRE-preset point-light attenuation selected by radius
(Scene.cpp:132-165 — the interpolation branch there is dead code, so the
effective behavior is "first preset with Radius > radius", which we
reproduce), and culling AABBs of half-extent 1.814*r*sqrt(I) (Scene.cpp:122-130).

Culling: the reference walks a loose octree (LooseOctree.h); here the default
is a vectorized all-boxes frustum test (O(N) beats tree traversal at this
scene scale on wide hardware); `utils.octree.LooseOctree` provides the
tree-based equivalent for host-side parity."""

from __future__ import annotations

import numpy as np

from ..config import CULLING_RADIUS_COEFFICIENT
from ..resource.resources import CubeMapResource, IResource, ModelResource
from ..resource.serialization import FieldSpec
from ..utils import mathlib as ml

# OGRE attenuation presets (Scene.h:128-142): radius, constant, linear, quadratic
POINT_LIGHT_ATTENUATION_PRESETS = np.array(
    [
        [0.1, 1.0, 45.0, 7500.0],
        [1.0, 1.0, 4.5, 75.0],
        [7.0, 1.0, 0.7, 1.8],
        [13.0, 1.0, 0.35, 0.44],
        [20.0, 1.0, 0.22, 0.2],
        [32.0, 1.0, 0.14, 0.07],
        [50.0, 1.0, 0.09, 0.032],
        [65.0, 1.0, 0.07, 0.017],
        [100.0, 1.0, 0.045, 0.0075],
        [160.0, 1.0, 0.027, 0.0028],
        [200.0, 1.0, 0.022, 0.0019],
        [325.0, 1.0, 0.014, 0.0007],
        [600.0, 1.0, 0.007, 0.0002],
    ],
    dtype=np.float32,
)


def attenuation_coefficients(radius: float) -> np.ndarray:
    """(radius, constant, linear, quadratic) — SceneLight::CaclAttenuationCoefficients.

    The reference's lerp branch can never run (its condition compares a value
    against itself, Scene.cpp:150), so the effective rule is: the first preset
    whose Radius exceeds `radius` supplies the coefficients (radius itself is
    passed through); past the last preset, the last preset is returned whole.
    """
    for i in range(len(POINT_LIGHT_ATTENUATION_PRESETS) - 1):
        preset = POINT_LIGHT_ATTENUATION_PRESETS[i]
        if radius < preset[0]:
            return np.array([radius, preset[1], preset[2], preset[3]], np.float32)
    return POINT_LIGHT_ATTENUATION_PRESETS[-1].copy()


class SceneObject:
    CPP_NAME = "SceneObject"
    BASE = None
    FIELDS = (
        FieldSpec("mName", "name", "str"),
        FieldSpec("mTranslation", "translation", "vec3"),
        FieldSpec("mRotation", "rotation", "vec3"),
        FieldSpec("mScale", "scale", "vec3"),
    )

    def init_defaults(self):
        self.name = ""
        self.translation = np.zeros(3, np.float32)
        self.rotation = np.zeros(3, np.float32)
        self.scale = np.ones(3, np.float32)
        self.world_matrix = ml.identity4()
        self.local_bound_min = np.zeros(3, np.float32)
        self.local_bound_max = np.zeros(3, np.float32)

    def __init__(self, name: str = ""):
        self.init_defaults()
        self.name = name

    def post_deserialized(self):
        self.update_transform()

    def update_transform(self):
        self.world_matrix = ml.compose_trs(self.translation, self.rotation, self.scale)

    def world_bound(self) -> tuple[np.ndarray, np.ndarray]:
        """AABB of the two transformed local corners (GetWorldBound, which
        inherits the reference's 2-corner transform quirk — MathLib.cpp:5-10)."""
        a = ml.transform_point(self.world_matrix, self.local_bound_min)
        b = ml.transform_point(self.world_matrix, self.local_bound_max)
        return np.minimum(a, b), np.maximum(a, b)


class SceneModel(SceneObject):
    CPP_NAME = "SceneModel"
    BASE = SceneObject
    FIELDS = (FieldSpec("mModelFilePath", "model_file_path", "str"),)

    def init_defaults(self):
        super().init_defaults()
        self.model_file_path = ""
        self.model: ModelResource | None = None

    def post_deserialized(self):
        super().post_deserialized()
        if self.model is None and self.model_file_path:
            from ..resource.loader import ResourceLoader

            loader = ResourceLoader.instance()
            missing = loader.missing_file(ModelResource, self.model_file_path)
            if missing is None:
                self.set_model(loader.load_resource(ModelResource, self.model_file_path))
            else:
                # The shipped reference asset tree is missing several blobs
                # (Revolver_*_data.bin, the LightImpostor models, the skybox
                # cubemap); degrade to an unloaded placeholder that the scene
                # packer skips instead of failing the whole scene.
                import logging

                logging.getLogger(__name__).warning(
                    "scene model %s: missing asset %s", self.name, missing
                )
                self.model = None

    def set_model(self, model: ModelResource):
        self.model = model
        self.local_bound_min, self.local_bound_max = model.bound
        self.model_file_path = model.repo_path


class SceneLight(SceneObject):
    CPP_NAME = "SceneLight"
    BASE = SceneObject
    FIELDS = (
        FieldSpec("mRadius", "radius", "f32"),
        FieldSpec("mColor", "color", "vec3"),
        FieldSpec("mIntensity", "intensity", "f32"),
    )

    def init_defaults(self):
        super().init_defaults()
        self.radius = 1.0
        self.color = np.ones(3, np.float32)
        self.intensity = 1.0
        self.attenuation = attenuation_coefficients(1.0)

    def post_deserialized(self):
        super().post_deserialized()
        self.set_radius(self.radius)

    def set_radius(self, radius: float):
        self.radius = float(radius)
        self.attenuation = attenuation_coefficients(self.radius)
        self._recalc_bound()

    def set_intensity(self, intensity: float):
        self.intensity = float(intensity)
        self._recalc_bound()

    def culling_radius(self) -> float:
        return self.radius * CULLING_RADIUS_COEFFICIENT * float(np.sqrt(self.intensity))

    def _recalc_bound(self):
        r = self.culling_radius()
        self.local_bound_min = np.array([-r, -r, -r], np.float32)
        self.local_bound_max = np.array([r, r, r], np.float32)


class Scene(IResource):
    CPP_NAME = "Scene"
    BASE = IResource
    FIELDS = (
        FieldSpec("mSkyBoxPath", "skybox_path", "str"),
        FieldSpec("mSceneModel", "models", ("list", ("obj", SceneModel))),
        FieldSpec("mSceneLight", "lights", ("list", ("obj", SceneLight))),
    )

    def init_defaults(self):
        super().init_defaults()
        self.skybox_path = ""
        self.models: list[SceneModel] = []
        self.lights: list[SceneLight] = []
        self.skybox: CubeMapResource | None = None

    def __init__(self, repo_path: str = ""):
        self.init_defaults()
        self.repo_path = repo_path

    def post_deserialized(self):
        if self.skybox_path:
            from ..resource.loader import ResourceLoader

            loader = ResourceLoader.instance()
            if loader.missing_file(CubeMapResource, self.skybox_path) is None:
                self.skybox = loader.load_resource(CubeMapResource, self.skybox_path)
            else:
                # The shipped asset tree references Asset/Skybox/HDRWild whose
                # .bin blob is absent from the repository; render skyless (or
                # attach a procedural sky via app tooling).
                self.skybox = None

    def set_skybox(self, res: CubeMapResource):
        self.skybox = res
        self.skybox_path = res.repo_path

    def add_model(self, model: SceneModel):
        self.models.append(model)

    def add_light(self, light: SceneLight):
        self.lights.append(light)

    # -- culling (Scene::CullModel / CullLight equivalents) -------------------
    def _cull(self, objects, planes: np.ndarray) -> list:
        if not objects:
            return []
        bounds = [o.world_bound() for o in objects]
        mins = np.stack([b[0] for b in bounds])
        maxs = np.stack([b[1] for b in bounds])
        mask = ml.frustum_cull_aabbs(planes, mins, maxs)
        return [o for o, m in zip(objects, mask) if m]

    def cull_models(self, planes: np.ndarray) -> list[SceneModel]:
        return self._cull(self.models, planes)

    def cull_lights(self, planes: np.ndarray) -> list[SceneLight]:
        return self._cull(self.lights, planes)

    def mesh_count(self) -> int:
        return sum(len(m.model.mesh_resource.sub_meshes) for m in self.models)

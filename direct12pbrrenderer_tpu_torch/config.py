"""Engine-wide constants and configuration — the port's copy of the JAX
package's `config.py` (same names and values).

Mirrors the compile-time constants of the reference renderer
(`Engine/Include/Fundation.h:27-39`, `DeferredPipeline.h:38-44,211,326-330,404-409`,
`Shader/clustered.hlsli:7-12`, `Shader/blur.hlsli:6-17`) as named config fields.
"""

from __future__ import annotations

import dataclasses
import math

PI = math.pi

# ---------------------------------------------------------------------------
# Deferred pipeline constants (reference: DeferredPipeline.h)
# ---------------------------------------------------------------------------

# IBL precompute (DeferredPipeline.h:38-41, 80)
PREFILTER_ENVMAP_SIZE = 512
PREFILTER_ENVMAP_MIP_LEVELS = 5
BRDF_LUT_SIZE = 512
IBL_SAMPLE_COUNT = 1024  # env_map_gen.hlsl / precompute_brdf.hlsl SAMPLE_COUNT

# Clustered shading (clustered.hlsli:7-12, DeferredPipeline.h:326-330)
CLUSTER_X = 24
CLUSTER_Y = 16
CLUSTER_Z = 8
MAX_LIGHTS_PER_CLUSTER = 32
MAX_SCENE_LIGHTS = 1024
CULLING_RADIUS_COEFFICIENT = 1.814  # light falls below 1/256 intensity

# Auto exposure (DeferredPipeline.h:404-408, hdr_*.hlsl)
NUM_HISTOGRAM_BINS = 256
MIN_LOG_LUMINANCE = -10.0
MAX_LOG_LUMINANCE = 2.0
LOG_LUMINANCE_RANGE = MAX_LOG_LUMINANCE - MIN_LOG_LUMINANCE
INV_LOG_LUMINANCE_RANGE = 1.0 / LOG_LUMINANCE_RANGE
EXPOSURE_SMOOTH_TIME = 1.6  # hdr_average_histogram.hlsl SMOOTH_TIME

# Bloom (DeferredPipeline.h:211-212, blur.hlsli)
BLOOM_STEPS = 3
BLOOM_MIP_LEVELS = BLOOM_STEPS + 2
BLOOM_THRESHOLD = 1.0
BLOOM_KNEE = 0.5
BLUR_RADIUS = 4
GAUSS_WEIGHTS = (0.0148, 0.0459, 0.1050, 0.1941, 0.2803, 0.1941, 0.1050, 0.0459, 0.0148)

# Scene (Scene.h:194)
WORLD_BOUND = 500.0

# App defaults (App.h:77-78, App.cpp:99-101)
DEFAULT_WIDTH = 1440
DEFAULT_HEIGHT = 960
DEFAULT_FOV = 0.333 * PI
DEFAULT_NEAR = 0.1
DEFAULT_FAR = 1000.0

NUM_CUBEMAP_FACES = 6


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Per-run renderer configuration (resolution, limits, precision).

    The static shape limits bound the padded device buffers; scenes smaller
    than the limits are zero-padded, larger ones grow the pools at pack time
    (pipeline.scene_pack).
    """

    width: int = DEFAULT_WIDTH
    height: int = DEFAULT_HEIGHT
    fov: float = DEFAULT_FOV
    near: float = DEFAULT_NEAR
    far: float = DEFAULT_FAR

    # Static scene-capacity limits (padded buffers).
    max_triangles: int = 65536
    max_vertices: int = 65536
    max_instances: int = 64
    max_lights: int = MAX_SCENE_LIGHTS

    # Rasterizer tiling: image is processed in strips of `raster_rows` rows;
    # triangles stream through in chunks of `tri_chunk`.
    raster_rows: int = 60
    tri_chunk: int = 256

    # Bloom/IBL toggles (all on by default, matching the reference pipeline).
    enable_bloom: bool = True
    enable_auto_exposure: bool = True

    @property
    def ratio(self) -> float:
        return self.width / self.height


DEFAULT_CONFIG = RenderConfig()

"""raytracercuda_tpu — a differentiable ray-tracing framework in JAX.

A from-scratch JAX/XLA framework with the capabilities of the CUDA
reference ray tracer d1kkop/RaytracerCuda (surveyed in
SURVEY.md): triangle-mesh scenes with 10-slot vertex attributes, OBJ/MTL/BMP
content loading, pinhole cameras, deterministic on-device acceleration
structures (LBVH, hashed grid, Morton clusters), stackless traversal,
full-frame test kernels, normal/Lambert/textured shading — differentiable
end-to-end and sharded over device meshes.

Public API parity map (reference `Raytracer/Beam.h`):
  IRenderTarget -> models.render_target.RenderTarget
  IMesh         -> models.mesh.Mesh
  IScene        -> models.scene.Scene
  ICamera       -> models.camera.Camera
  ERROR_*       -> errors
  VERTEX_DATA_* -> models.mesh
"""

from .config import (
    AccelKind,
    BvhConfig,
    DEFAULT_CONFIG,
    DiffConfig,
    GridConfig,
    RenderConfig,
    TraceConfig,
    WavefrontConfig,
)
from .errors import (
    ERROR_ALL_FINE,
    ERROR_GPU_ALLOC_FAIL,
    ERROR_INVALID_FORMAT,
    ERROR_INVALID_PARAMETER,
    ERROR_LOCK_FIRST,
    ERROR_NO_RENDER_TARGET,
    ERROR_NO_VERTICES,
    ERROR_RT_CAM_MISMATCH,
    ERROR_UNLOCK_FIRST,
    BeamError,
)
from .models.camera import Camera, camera_ray_grid, orient_from_pan_pitch
from .models.mesh import (
    Mesh,
    VERTEX_DATA_BITANGENT,
    VERTEX_DATA_COUNT,
    VERTEX_DATA_EXTRA1,
    VERTEX_DATA_EXTRA2,
    VERTEX_DATA_EXTRA3,
    VERTEX_DATA_EXTRA4,
    VERTEX_DATA_NORMAL,
    VERTEX_DATA_POSITION,
    VERTEX_DATA_TANGENT,
    VERTEX_DATA_UV1,
    VERTEX_DATA_UV2,
)
from .models.render_target import RenderTarget
from .models.scene import Material, Scene, SceneData, flatten_meshes
from .types import FLT_MAX, Hit, Rays

__version__ = "0.1.0"

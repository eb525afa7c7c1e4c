"""Scene container, numpy builders of the procedural scenes and the asset
loaders (TGA, Radiance HDR, DDS, glTF, FBX)."""

from . import procedural, scene  # noqa: F401
from .scene import MaterialDesc, MeshPart, Scene, build_scene  # noqa: F401

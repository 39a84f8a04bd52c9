from .builder import SceneBuilder, look_at  # noqa: F401
from .types import Scene  # noqa: F401

from .config import (  # noqa: F401
    SHAPES,
    ModelConfig,
    SSMConfig,
    ShapeSpec,
)
from .model import Model  # noqa: F401
